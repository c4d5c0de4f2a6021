// long_range_sep and long_range_dense: the first log2(R) DIF levels of
// every n = R * C transform in a batch, viewed as (batch, R, C)
// row-major, on an NVIDIA Hopper card (sm_90a).  Two kernels, two
// twiddle sources: separable factors (pifft_long_range_sep, on the
// register radix loop) or dense per-level tables
// (pifft_long_range_dense, on the first design's level loop).
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
// data from any other block, staged in dynamic shared memory.  The
// level-l twiddle of row offset j and column c is rebuilt in-kernel as
// A[o + j] * B[l, c] (o = R - (R >> l)), the outer product of the
// per-row factor A (R - 1 floats) and the per-level column factor B
// (levels x C) of _long_range_factors (l.566), exactly as the TPU kernel
// forms it at l.542-558.  So the pass reads R + levels * C twiddle
// floats instead of (R/2) * C per level of dense tables.
//
// The separable kernel (the Hopper redesign) runs
// pifft::long_range_levels_deep straight from x to y: the first pass
// reads 8 or 16 points a thread from device memory into registers
// (streaming, evict-first: x is read once), runs 3 or 4 levels there and
// writes the padded planes; the last pass writes y (plain stores, which
// stay in L2 for the row pass that reads y next).  At R = 64 that is two
// radix-8 passes and one shared-memory round trip, where the first
// design made six levels, each between __syncthreads(), plus a block
// copy in and one out, all in series.  A log2(R) that is a multiple of 3
// runs radix-8 passes only (KMAX = 3), so the kernel keeps to radix-8
// registers and four blocks fit an SM; other R take radix-16 passes.
//
// Bound.  Device memory: each element is read once and written once, and
// log2(R) levels do about 11 flop per element each (6 of them rebuilding
// the twiddle), about 66 flop per 16 bytes at R = 64: below the card's
// fp32 ridge, so bytes over HBM bandwidth is the floor.
//
// Dense tables.  The level-l twiddle of row offset j and column c is
// read from table l at [j, c0 + c]: level l's (R >> (l + 1), C) table
// is the n-point level-l table of twiddle_tables(n) reshaped, as the TPU
// kernel reads it, and the levels are stacked into one (R - 1, C) array
// a plane (dense_long_range_tables).  Each entry belongs to one block's
// columns, so the reads stream through L2 evict-first (ld.global.cs).
// The tables add (R - 1) * C floats a plane, about 8 bytes per element:
// 24 bytes moved per element against the separable source's 16, for 5
// flop per element per level instead of 11.  The TPU preferred the dense
// tables (its pass was VPU-bound); on Hopper the pass is bound by bytes,
// so the dense source is expected to lose, and the ladder's race
// measures by how much.  Its kernel stages the whole R x cb block
// (2 * R * cb * 4 bytes) between one coalesced read and one coalesced
// write and runs the log2(R) levels there with __syncthreads() between
// them (pifft::long_range_levels).

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

template <class Twiddle>
__global__ void long_range_kernel(const float* __restrict__ xr,
                                  const float* __restrict__ xi,
                                  float* __restrict__ yr,
                                  float* __restrict__ yi, Twiddle tw,
                                  int log2_r, int C, int log2_cb) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + (1 << (log2_r + log2_cb));
  const int col_blocks = C >> log2_cb;
  const long long t = blockIdx.x / col_blocks;  // transform in the batch
  const int c0 = (blockIdx.x - t * col_blocks) << log2_cb;
  const size_t base = (static_cast<size_t>(t) << log2_r) * C + c0;
  pifft::load_block<pifft::Load::kCached>(sr, si, xr, xi, base, C, log2_r,
                                         log2_cb);
  pifft::long_range_levels(sr, si, log2_r, log2_cb, tw, c0);
  pifft::store_block(yr, yi, sr, si, base, C, log2_r, log2_cb);
}

template <class Twiddle>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           Twiddle tw, long long batch, int log2_r, int C, int log2_cb,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = (1 << log2_r) << log2_cb;
  const int smem = 2 * total * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(long_range_kernel<Twiddle>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (total >> 1) < 256 ? (total >> 1) : 256;
  const long long blocks = batch * (C >> log2_cb);
  long_range_kernel<Twiddle><<<static_cast<unsigned int>(blocks), threads,
                               smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, tw, log2_r, C, log2_cb);
  return static_cast<int>(cudaGetLastError());
}

// the separable kernel: a block of up to kSepThreads threads per R x cb
// column block, passes of at most KMAX levels
constexpr int kSepThreads = 256;

template <int KMAX>
__global__ void __launch_bounds__(kSepThreads, KMAX == 3 ? 4 : 2)
long_range_sep_kernel(const float* __restrict__ xr,
                      const float* __restrict__ xi, float* __restrict__ yr,
                      float* __restrict__ yi, pifft::SeparableTwiddle tw,
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

// One launch of long_range_sep_kernel<KMAX>: a block per transform and
// column block, (R x cb) / 8 threads (32 to kSepThreads), two padded
// planes of shared memory, opted into once per card.
template <int KMAX>
int launch_sep(const float* xr, const float* xi, float* yr, float* yi,
               pifft::SeparableTwiddle tw, long long batch, int log2_r,
               int C, int log2_cb, int device, void* stream) {
  static pifft::SmemOptIn opted;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = (1 << log2_r) << log2_cb;
  const int smem = 2 * pifft::padded_floats(total) *
                   static_cast<int>(sizeof(float));
  err = pifft::opt_in_smem(
      reinterpret_cast<const void*>(long_range_sep_kernel<KMAX>), smem,
      device, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = total >> 3;
  threads = threads < 32 ? 32 : (threads > kSepThreads ? kSepThreads
                                                       : threads);
  const long long blocks = batch * (C >> log2_cb);
  long_range_sep_kernel<KMAX><<<static_cast<unsigned int>(blocks), threads,
                                smem, static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, tw, log2_r, C, log2_cb);
  return static_cast<int>(cudaGetLastError());
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
  const pifft::SeparableTwiddle tw{ar, ai, br, bi, static_cast<size_t>(C)};
  if (log2_r % 3 == 0) {
    return launch_sep<3>(xr, xi, yr, yi, tw, batch, log2_r, C, log2_cb,
                         device, stream);
  }
  return launch_sep<4>(xr, xi, yr, yi, tw, batch, log2_r, C, log2_cb,
                       device, stream);
}

// The same levels with the twiddles read from the (R - 1, C) dense
// tables (wr, wi) of dense_long_range_tables(R, C).
extern "C" int pifft_long_range_dense(const float* xr, const float* xi,
                                      float* yr, float* yi, const float* wr,
                                      const float* wi, long long batch,
                                      int log2_r, int C, int log2_cb,
                                      int device, void* stream) {
  const pifft::DenseTwiddle<true> tw{wr, wi, static_cast<size_t>(C)};
  return launch(xr, xi, yr, yi, tw, batch, log2_r, C, log2_cb, device,
                stream);
}
