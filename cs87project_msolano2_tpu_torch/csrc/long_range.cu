// long_range_sep and long_range_dense: the first log2(R) DIF levels of
// every n = R * C transform in a batch, viewed as (batch, R, C)
// row-major, on an NVIDIA Hopper card (sm_90a).  Two kernels, one loop,
// two twiddle sources: separable factors (pifft_long_range_sep) or dense
// per-level tables (pifft_long_range_dense).
//
// Replaces the TPU kernels cs87project_msolano2_tpu/ops/pallas_fft.py:
// _long_range_kernel_sep (l.519), launched there by
// fft_pi_layout_pallas_rql (l.742, pallas_call l.813) as phase A of the
// rql whole transform, and _long_range_kernel (l.483), launched by
// long_range_grid (l.602, pallas_call l.664) as the first pass of the
// two-kernel whole transform fft_pi_layout_pallas2 (l.678).
//
// Design.  Level l pairs rows (r, r + R/2^(l+1)) within each group of
// R/2^l rows, so every level stays inside one column: a block owns `cb`
// contiguous columns across all R rows of one transform and needs no
// data from any other block.  Both kernels run
// pifft::long_range_levels_deep straight from x to y: the first pass
// reads 8 or 16 points a thread from device memory into registers
// (streaming, evict-first: x is read once), runs 3 or 4 levels there and
// writes the padded planes in shared memory; the last pass writes y
// (plain stores, which stay in L2 for the row pass that reads y next).
// At R = 64 that is two radix-8 passes and one shared-memory round trip,
// where a level at a time would make six, each between __syncthreads(),
// plus a block copy in and one out, all in series.  A log2(R) that is a
// multiple of 3 runs radix-8 passes only (KMAX = 3), so the kernel keeps
// to radix-8 registers and four blocks fit an SM; other R take radix-16
// passes.  The two kernels differ only in where a twiddle comes from.
//
// Separable factors.  The level-l twiddle of row offset j and column c
// is rebuilt in-kernel as A[o + j] * B[l, c] (o = R - (R >> l)), the
// outer product of the per-row factor A (R - 1 floats) and the per-level
// column factor B (levels x C) of _long_range_factors (l.566), exactly
// as the TPU kernel forms it at l.542-558.  So the pass reads R + levels
// * C twiddle floats instead of (R/2) * C per level of dense tables.
//
// Dense tables.  The level-l twiddle of row offset j and column c is
// read from table l at [j, c]: level l's (R >> (l + 1), C) table is the
// n-point level-l table of twiddle_tables(n) reshaped, as the TPU kernel
// reads it, and the levels are stacked into one (R - 1, C) array a plane
// (dense_long_range_tables).  Each entry belongs to one block's columns,
// so the reads stream through L2 evict-first (ld.global.cs).  The tables
// add (R - 1) * C floats a plane, about 8 bytes per element: 24 bytes
// moved per element against the separable source's 16, for 5 flop per
// element per level instead of 11.  The TPU preferred the dense tables
// (its pass was VPU-bound); on Hopper the pass is bound by bytes, so the
// dense source is expected to lose, and the ladder's race measures by
// how much.
//
// Bound.  Device memory: each element is read once and written once
// (and, dense, its tables read once), and log2(R) levels do about 11
// flop per element each with the separable factors (6 of them
// rebuilding the twiddle), 5 with the dense tables: below the card's
// fp32 ridge, so bytes over HBM bandwidth is the floor.
//
// bf16 storage (pifft_long_range_sep_bf16; the reference's
// storage="bfloat16" on the rql path, its planes and factors at st_dt,
// upcast at load).  The separable kernel instantiated on __nv_bfloat16
// planes and factors: every point and factor is upcast once as it is
// read, every point rounded once as it is written (y is rql's
// intermediate, stored in bf16 as the reference's is); the twiddle is
// rebuilt and every level runs in float.  Half the bytes, so half the
// floor.  pifft_long_range_dense_bf16 is the dense kernel instantiated
// the same way (the reference's long_range_grid with storage=
// "bfloat16", l.602: bf16 planes, tables from twiddle_tables(n, dtype=
// storage) at l.654, y at the storage dtype): bf16 dense tables
// (DenseTable<true, __nv_bfloat16>, the source fourstep's and sixstep's
// dense bf16 phases read), each entry upcast once as it streams in, y
// rounded once, the two-kernel path's intermediate in bf16 as the
// reference's is.  12 bytes moved per element against the float32
// kernel's 24.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

// a block of up to kDeepThreads threads per R x cb column block, passes
// of at most KMAX levels
constexpr int kDeepThreads = 256;

// The levels of one R x cb column block of one transform, from x to y
// through the padded planes, twiddles from `tw`; planes stored as T
// (float, or __nv_bfloat16: upcast at load, rounded at store).
template <int KMAX, class T, class Twiddle>
__device__ __forceinline__ void long_range_block(
    const T* __restrict__ xr, const T* __restrict__ xi,
    T* __restrict__ yr, T* __restrict__ yi, const Twiddle& tw,
    int log2_r, int C, int log2_cb) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + pifft::padded_floats(1 << (log2_r + log2_cb));
  const int col_blocks = C >> log2_cb;
  const long long t = blockIdx.x / col_blocks;  // transform in the batch
  const int c0 = (blockIdx.x - t * col_blocks) << log2_cb;
  const size_t off = (static_cast<size_t>(t) << log2_r) * C;
  pifft::long_range_levels_deep<KMAX, pifft::Load::kStreaming,
                                pifft::Store::kCached>(
      sr, si, xr + off, xi + off, yr + off, yi + off, c0, C, log2_r,
      log2_cb, tw);
}

template <int KMAX>
__global__ void __launch_bounds__(kDeepThreads, KMAX == 3 ? 4 : 2)
long_range_sep_kernel(const float* __restrict__ xr,
                      const float* __restrict__ xi, float* __restrict__ yr,
                      float* __restrict__ yi, pifft::SeparableTwiddle tw,
                      int log2_r, int C, int log2_cb) {
  long_range_block<KMAX>(xr, xi, yr, yi, tw, log2_r, C, log2_cb);
}

// the bf16 storage instantiation: planes and factors in bf16
template <int KMAX>
__global__ void __launch_bounds__(kDeepThreads, KMAX == 3 ? 4 : 2)
long_range_sep_kernel(const __nv_bfloat16* __restrict__ xr,
                      const __nv_bfloat16* __restrict__ xi,
                      __nv_bfloat16* __restrict__ yr,
                      __nv_bfloat16* __restrict__ yi,
                      pifft::SeparableFactors<__nv_bfloat16> tw, int log2_r,
                      int C, int log2_cb) {
  long_range_block<KMAX>(xr, xi, yr, yi, tw, log2_r, C, log2_cb);
}

template <int KMAX>
__global__ void __launch_bounds__(kDeepThreads, KMAX == 3 ? 4 : 2)
long_range_dense_kernel(const float* __restrict__ xr,
                        const float* __restrict__ xi,
                        float* __restrict__ yr, float* __restrict__ yi,
                        pifft::DenseTwiddle<true> tw, int log2_r, int C,
                        int log2_cb) {
  long_range_block<KMAX>(xr, xi, yr, yi, tw, log2_r, C, log2_cb);
}

// the bf16 storage instantiation: planes and dense tables in bf16
template <int KMAX>
__global__ void __launch_bounds__(kDeepThreads, KMAX == 3 ? 4 : 2)
long_range_dense_kernel(const __nv_bfloat16* __restrict__ xr,
                        const __nv_bfloat16* __restrict__ xi,
                        __nv_bfloat16* __restrict__ yr,
                        __nv_bfloat16* __restrict__ yi,
                        pifft::DenseTable<true, __nv_bfloat16> tw,
                        int log2_r, int C, int log2_cb) {
  long_range_block<KMAX>(xr, xi, yr, yi, tw, log2_r, C, log2_cb);
}

// One launch of `kernel` (either kernel above, at one KMAX, for planes
// stored as T): a block per transform and column block, (R x cb) / 8
// threads (32 to kDeepThreads), two padded float planes of shared
// memory, opted into once per card (`opted`, one per kernel).
template <class T, class Twiddle>
int launch_deep(void (*kernel)(const T*, const T*, T*, T*, Twiddle, int,
                               int, int),
                pifft::SmemOptIn& opted, const T* xr, const T* xi, T* yr,
                T* yi, Twiddle tw, long long batch, int log2_r, int C,
                int log2_cb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = (1 << log2_r) << log2_cb;
  const int smem = 2 * pifft::padded_floats(total) *
                   static_cast<int>(sizeof(float));
  err = pifft::opt_in_smem(reinterpret_cast<const void*>(kernel), smem,
                           device, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = total >> 3;
  threads = threads < 32 ? 32 : (threads > kDeepThreads ? kDeepThreads
                                                        : threads);
  const long long blocks = batch * (C >> log2_cb);
  kernel<<<static_cast<unsigned int>(blocks), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi, tw, log2_r,
                                                C, log2_cb);
  return static_cast<int>(cudaGetLastError());
}

// The separable launch for planes and factors stored as T.
template <class T, class Twiddle>
int launch_sep(const T* xr, const T* xi, T* yr, T* yi, Twiddle tw,
               long long batch, int log2_r, int C, int log2_cb, int device,
               void* stream) {
  static pifft::SmemOptIn opted3, opted4;
  void (*kernel3)(const T*, const T*, T*, T*, Twiddle, int, int, int) =
      long_range_sep_kernel<3>;
  void (*kernel4)(const T*, const T*, T*, T*, Twiddle, int, int, int) =
      long_range_sep_kernel<4>;
  if (log2_r % 3 == 0) {
    return launch_deep(kernel3, opted3, xr, xi, yr, yi, tw, batch, log2_r,
                       C, log2_cb, device, stream);
  }
  return launch_deep(kernel4, opted4, xr, xi, yr, yi, tw, batch, log2_r, C,
                     log2_cb, device, stream);
}

// The dense launch for planes and tables stored as T.
template <class T, class Twiddle>
int launch_dense(const T* xr, const T* xi, T* yr, T* yi, Twiddle tw,
                 long long batch, int log2_r, int C, int log2_cb, int device,
                 void* stream) {
  static pifft::SmemOptIn opted3, opted4;
  void (*kernel3)(const T*, const T*, T*, T*, Twiddle, int, int, int) =
      long_range_dense_kernel<3>;
  void (*kernel4)(const T*, const T*, T*, T*, Twiddle, int, int, int) =
      long_range_dense_kernel<4>;
  if (log2_r % 3 == 0) {
    return launch_deep(kernel3, opted3, xr, xi, yr, yi, tw, batch, log2_r,
                       C, log2_cb, device, stream);
  }
  return launch_deep(kernel4, opted4, xr, xi, yr, yi, tw, batch, log2_r, C,
                     log2_cb, device, stream);
}

}  // namespace

// Launch the long-range levels over `batch` transforms of (2^log2_r, C)
// in column blocks of 2^log2_cb on `stream` (a cudaStream_t), twiddles
// rebuilt from the factors (ar, ai, br, bi) of long_range_factors(R, C).
// Returns the cudaError_t of the launch: 0 = success.
extern "C" int pifft_long_range_sep(const float* xr, const float* xi,
                                    float* yr, float* yi, const float* ar,
                                    const float* ai, const float* br,
                                    const float* bi, long long batch,
                                    int log2_r, int C, int log2_cb,
                                    int device, void* stream) {
  const pifft::SeparableTwiddle tw{{ar, ai, br, bi, static_cast<size_t>(C)}};
  return launch_sep(xr, xi, yr, yi, tw, batch, log2_r, C, log2_cb, device,
                    stream);
}

// The same launch on bf16 planes and factors (device_factors(R, C,
// storage="bfloat16")): the bf16 storage instantiation.
extern "C" int pifft_long_range_sep_bf16(
    const __nv_bfloat16* xr, const __nv_bfloat16* xi, __nv_bfloat16* yr,
    __nv_bfloat16* yi, const __nv_bfloat16* ar, const __nv_bfloat16* ai,
    const __nv_bfloat16* br, const __nv_bfloat16* bi, long long batch,
    int log2_r, int C, int log2_cb, int device, void* stream) {
  const pifft::SeparableFactors<__nv_bfloat16> tw{
      ar, ai, br, bi, static_cast<size_t>(C)};
  return launch_sep(xr, xi, yr, yi, tw, batch, log2_r, C, log2_cb, device,
                    stream);
}

// The same levels with the twiddles read from the (R - 1, C) dense
// tables (wr, wi) of dense_long_range_tables(R, C).
extern "C" int pifft_long_range_dense(const float* xr, const float* xi,
                                      float* yr, float* yi, const float* wr,
                                      const float* wi, long long batch,
                                      int log2_r, int C, int log2_cb,
                                      int device, void* stream) {
  const pifft::DenseTwiddle<true> tw{{wr, wi, static_cast<size_t>(C)}};
  return launch_dense(xr, xi, yr, yi, tw, batch, log2_r, C, log2_cb, device,
                      stream);
}

// The same launch on bf16 planes and dense tables
// (dense_long_range_tables(R, C, storage="bfloat16")): the bf16 storage
// instantiation, y stored in bf16.
extern "C" int pifft_long_range_dense_bf16(
    const __nv_bfloat16* xr, const __nv_bfloat16* xi, __nv_bfloat16* yr,
    __nv_bfloat16* yi, const __nv_bfloat16* wr, const __nv_bfloat16* wi,
    long long batch, int log2_r, int C, int log2_cb, int device,
    void* stream) {
  const pifft::DenseTable<true, __nv_bfloat16> tw{wr, wi,
                                                  static_cast<size_t>(C)};
  return launch_dense(xr, xi, yr, yi, tw, batch, log2_r, C, log2_cb, device,
                      stream);
}
