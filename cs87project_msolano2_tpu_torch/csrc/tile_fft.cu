// tile_fft: the tile-point DIF FFT of independent rows, in pi layout
// (per-row bit-reversed order), on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel cs87project_msolano2_tpu/ops/pallas_fft.py:
// _tile_fft_kernel (l.299) with its math in _tile_fft_compute (l.173),
// launched there by tile_fft_grid (l.379, pallas_call l.469) and
// _tile_fft_rows (l.710, pallas_call l.729).
//
// What it computes.  All log2(tile) radix-2 DIF levels of each row:
// level l pairs (top, top + half), half = tile >> (l + 1), and multiplies
// the difference by w_l[j], read from the float32 per-level tables of
// twiddle_tables(tile) concatenated into one array (level l at offset
// tile - (tile >> l); pifft::FlatTwiddle), shared by every block and
// kept in L2.  The TPU ran the last log2(tail) levels as a split3 bf16
// matmul on the MXU; here they are fp32 butterflies, which meet every
// fp32-storage error budget.
//
// Bound.  Device memory: each element is read once and written once
// (8 bytes of re+im each way), against 5 flop per element per level; at
// tile 4096 that is 60 flop per 16 bytes, far below the card's fp32
// ridge of about 20 flop per byte, so the floor is bytes over HBM
// bandwidth.  No row leaves the chip between its load and its store.
//
// Design (the Hopper redesign; gpu_rows.cu runs the same loop on its own
// twiddle stack).  fft_common.cuh's register radix loop: the first pass
// reads a row's points from device memory into registers, runs up to four
// levels there and writes them into padded shared-memory planes; radix-16
// passes follow, one __syncthreads() per four levels; the last pass writes
// the row straight back to device memory.  A 4096-point row takes three
// passes where the first design made fourteen (a block copy in, twelve
// levels, a block copy out).  Two launch shapes, picked by the wrapper
// (ops/cuda_fft.py: tile_blocking):
//   - tile_fft_rows: 2^log2_block_rows rows back to back in one block
//     (short rows share a block, so it still holds 16 points a thread),
//     one thread per 16 points, 32 to 512;
//   - tile_fft_cluster: each row on a thread-block cluster of
//     cw = 2^LOG2CW blocks, for the long rows (2^13, 2^14) of a launch
//     that has fewer rows than the card has SMs: the widest cluster that
//     keeps the launch to one wave (rql's 64 rows of 2^14 at n = 2^20
//     take cw = 2 on 132 SMs, 16 rows cw = 8).  pifft::cluster_row_levels
//     runs the row's first log2(cw) levels across the cluster through
//     distributed shared memory and the rest in each block, so each row
//     is spread over cw SMs instead of one.
// Set-up done on the host (opting a kernel into more than 48 KB of
// shared memory) runs once per card and size, not per launch, so a
// captured launch (a CUDA graph) records the launch alone.
//
// bf16 storage (pifft_tile_fft_bf16; the reference's storage="bfloat16",
// its planes and tables at st_dt, upcast by _f32 at load, l.173-186).
// The same kernels instantiated on __nv_bfloat16 planes and tables: each
// point is upcast once as it is read and rounded once (to nearest even)
// as it is written; the planes in shared memory, the registers and every
// level stay float.  It moves half the bytes (8 per element, both
// planes, in and out), so its floor is half the float32 kernel's.  The
// copies keep four points each (8 bytes of bf16 instead of a float4), so
// both instantiations run the same loop.  The reference's last log2(tail)
// levels were one product with a bf16-rounded tail matrix; here they are
// butterflies with bf16-rounded twiddles (the port's bf16 error is
// 1.06-1.09 times the reference's, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

// threads of a block: one per 16 points, at most this many
constexpr int kMaxThreads = 512;

// The bodies of the two launch shapes for planes and tables stored as T
// (float, or __nv_bfloat16 for the bf16 storage mode: each point is
// upcast once at its load and rounded once at its store, every level
// in between runs in float in the same order).
template <class T>
__device__ __forceinline__ void rows_body(float* smem, const T* xr,
                                          const T* xi, T* yr, T* yi,
                                          const T* twr, const T* twi,
                                          int log2_tile,
                                          int log2_block_rows) {
  const int log2_total = log2_tile + log2_block_rows;
  float* sr = smem;
  float* si = smem + pifft::padded_floats(1 << log2_total);
  const size_t base = static_cast<size_t>(blockIdx.x) << log2_total;
  const pifft::FlatTable<T> tw{twr, twi, 1 << log2_tile};
  pifft::row_levels_radix<true, true, pifft::Load::kCached,
                          pifft::Store::kCached>(
      sr, si, xr, xi, yr, yi, base, log2_total, log2_tile, 0, tw);
}

template <int LOG2CW, class T>
__device__ __forceinline__ void cluster_body(float* smem, const T* xr,
                                             const T* xi, T* yr, T* yi,
                                             const T* twr, const T* twi,
                                             int log2_seg) {
  const int log2_tile = log2_seg + LOG2CW;
  float* sr = smem;
  float* si = smem + pifft::padded_floats(1 << log2_seg);
  const size_t row = static_cast<size_t>(blockIdx.x >> LOG2CW) << log2_tile;
  const pifft::FlatTable<T> tw{twr, twi, 1 << log2_tile};
  pifft::cluster_row_levels<LOG2CW, pifft::Load::kCached,
                            pifft::Store::kCached>(sr, si, xr, xi, yr, yi,
                                                   row, log2_seg, tw);
}

// Each kernel has two overloads: float planes and tables, and the bf16
// storage instantiation.
__global__ void __launch_bounds__(kMaxThreads)
tile_fft_rows(const float* __restrict__ xr, const float* __restrict__ xi,
              float* __restrict__ yr, float* __restrict__ yi,
              const float* __restrict__ twr, const float* __restrict__ twi,
              int log2_tile, int log2_block_rows) {
  extern __shared__ float smem[];
  rows_body(smem, xr, xi, yr, yi, twr, twi, log2_tile, log2_block_rows);
}

__global__ void __launch_bounds__(kMaxThreads)
tile_fft_rows(const __nv_bfloat16* __restrict__ xr,
              const __nv_bfloat16* __restrict__ xi,
              __nv_bfloat16* __restrict__ yr, __nv_bfloat16* __restrict__ yi,
              const __nv_bfloat16* __restrict__ twr,
              const __nv_bfloat16* __restrict__ twi, int log2_tile,
              int log2_block_rows) {
  extern __shared__ float smem[];
  rows_body(smem, xr, xi, yr, yi, twr, twi, log2_tile, log2_block_rows);
}

// log2_seg is passed at run time: a compile-time segment lets nvcc
// unroll the whole level loop (2.4 times slower in gpu_rows.cu)
template <int LOG2CW>
__global__ void __launch_bounds__(kMaxThreads)
tile_fft_cluster(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const float* __restrict__ twr,
                 const float* __restrict__ twi, int log2_seg) {
  extern __shared__ float smem[];
  cluster_body<LOG2CW>(smem, xr, xi, yr, yi, twr, twi, log2_seg);
}

template <int LOG2CW>
__global__ void __launch_bounds__(kMaxThreads)
tile_fft_cluster(const __nv_bfloat16* __restrict__ xr,
                 const __nv_bfloat16* __restrict__ xi,
                 __nv_bfloat16* __restrict__ yr,
                 __nv_bfloat16* __restrict__ yi,
                 const __nv_bfloat16* __restrict__ twr,
                 const __nv_bfloat16* __restrict__ twi, int log2_seg) {
  extern __shared__ float smem[];
  cluster_body<LOG2CW>(smem, xr, xi, yr, yi, twr, twi, log2_seg);
}

int threads_for(int log2_points) {
  const int groups = 1 << (log2_points > 4 ? log2_points - 4 : 0);
  return groups < 32 ? 32 : (groups > kMaxThreads ? kMaxThreads : groups);
}

template <int LOG2CW, class T>
cudaError_t launch_cluster(const T* xr, const T* xi, T* yr, T* yi,
                           const T* twr, const T* twi, long long rows,
                           int log2_tile, int device, cudaStream_t stream) {
  static pifft::SmemOptIn opted;
  void (*kernel)(const T*, const T*, T*, T*, const T*, const T*, int) =
      tile_fft_cluster<LOG2CW>;
  const int log2_seg = log2_tile - LOG2CW;
  const int smem = 2 * pifft::padded_floats(1 << log2_seg) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = pifft::opt_in_smem(reinterpret_cast<const void*>(kernel),
                                       smem, device, opted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1u << LOG2CW;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(rows << LOG2CW));
  config.blockDim = dim3(threads_for(log2_seg));
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, xr, xi, yr, yi, twr, twi,
                            log2_seg);
}

template <class T>
int launch(const T* xr, const T* xi, T* yr, T* yi, const T* twr,
           const T* twi, long long rows, int log2_tile, int log2_block_rows,
           int log2_cw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log2_cw == 0) {
    static pifft::SmemOptIn opted;
    void (*kernel)(const T*, const T*, T*, T*, const T*, const T*, int,
                   int) = tile_fft_rows;
    const int log2_total = log2_tile + log2_block_rows;
    const int smem = 2 * pifft::padded_floats(1 << log2_total) *
                     static_cast<int>(sizeof(float));
    err = pifft::opt_in_smem(reinterpret_cast<const void*>(kernel), smem,
                             device, opted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned int blocks =
        static_cast<unsigned int>(rows >> log2_block_rows);
    kernel<<<blocks, threads_for(log2_total), smem, s>>>(
        xr, xi, yr, yi, twr, twi, log2_tile, log2_block_rows);
    return static_cast<int>(cudaGetLastError());
  }
  switch (log2_cw) {
    case 1: err = launch_cluster<1>(xr, xi, yr, yi, twr, twi, rows,
                                    log2_tile, device, s); break;
    case 2: err = launch_cluster<2>(xr, xi, yr, yi, twr, twi, rows,
                                    log2_tile, device, s); break;
    case 3: err = launch_cluster<3>(xr, xi, yr, yi, twr, twi, rows,
                                    log2_tile, device, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the tile DIF over `rows` rows of 2^log2_tile points on `stream`
// (a cudaStream_t): with log2_cw = 0, 2^log2_block_rows rows a block
// (which must divide rows, and hold at most 2^14 points); with log2_cw =
// 1..3, each row on a cluster of 2^log2_cw blocks (block_rows 1).  The
// caller (ops/cuda_fft.py: tile_fft) checks the blocking and that the
// planes are 16-byte aligned.  Returns the cudaError_t of the launch:
// 0 = success.
extern "C" int pifft_tile_fft(const float* xr, const float* xi, float* yr,
                              float* yi, const float* twr, const float* twi,
                              long long rows, int log2_tile,
                              int log2_block_rows, int log2_cw, int device,
                              void* stream) {
  return launch(xr, xi, yr, yi, twr, twi, rows, log2_tile, log2_block_rows,
                log2_cw, device, stream);
}

// The same launch on bf16 planes and tables (flat_tables(tile,
// storage="bfloat16")): the bf16 storage instantiation.
extern "C" int pifft_tile_fft_bf16(const __nv_bfloat16* xr,
                                   const __nv_bfloat16* xi,
                                   __nv_bfloat16* yr, __nv_bfloat16* yi,
                                   const __nv_bfloat16* twr,
                                   const __nv_bfloat16* twi, long long rows,
                                   int log2_tile, int log2_block_rows,
                                   int log2_cw, int device, void* stream) {
  return launch(xr, xi, yr, yi, twr, twi, rows, log2_tile, log2_block_rows,
                log2_cw, device, stream);
}

extern "C" const char* pifft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* pifft_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}
