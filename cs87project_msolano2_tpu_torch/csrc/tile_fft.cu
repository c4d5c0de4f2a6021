// tile_fft: the tile-point DIF FFT of independent rows, in pi layout
// (per-row bit-reversed order), on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel cs87project_msolano2_tpu/ops/pallas_fft.py:
// _tile_fft_kernel (l.299) with its math in _tile_fft_compute (l.173),
// launched there by tile_fft_grid (l.379, pallas_call l.469) and
// _tile_fft_rows (l.710, pallas_call l.729).
//
// Design.  One thread block owns one row of `tile` points.  It loads the
// row's re/im planes into dynamic shared memory (2 * tile * 4 bytes:
// 128 KB at the largest tile, 2^14, inside the 227 KB a block may opt
// into), runs all log2(tile) radix-2 DIF levels there with
// __syncthreads() between levels (pifft::tile_levels in fft_common.cuh,
// shared with the fourstep and sixstep kernels), and writes the row
// back.  Level l
// pairs (top, top + half) with half = tile >> (l + 1) and multiplies the
// difference by w_l[j], read from the float32 per-level tables of
// twiddle_tables(tile) concatenated into one array (level l at offset
// tile - (tile >> l)); the tables are shared by every block and stay in
// L2.  The TPU ran the last log2(tail) levels as a split3 bf16 matmul on
// the MXU; here they are ordinary fp32 butterflies, which meet every
// fp32-storage error budget.
//
// Bound.  Device memory: each element is read once and written once
// (8 bytes of re+im each way), against 5 flop per element per level;
// at tile 4096 that is 60 flop per 16 bytes, far below the fp32 ridge
// of the card (about 20 flop per byte), so the kernel's floor is bytes
// over HBM bandwidth.  Its design keeps every intermediate level in
// shared memory, so HBM sees exactly one read and one write per
// element; the shared-memory passes (one per level) and the barriers
// are what it pays on top of that floor.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

__global__ void tile_fft_kernel(const float* __restrict__ xr,
                                const float* __restrict__ xi,
                                float* __restrict__ yr,
                                float* __restrict__ yi,
                                const float* __restrict__ twr,
                                const float* __restrict__ twi,
                                int log2_tile) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + (1 << log2_tile);
  const size_t base = static_cast<size_t>(blockIdx.x) << log2_tile;
  pifft::load_block<pifft::Load::kCached>(sr, si, xr, xi, base, 0, 0,
                                         log2_tile);
  pifft::tile_levels(sr, si, log2_tile, twr, twi);
  pifft::store_block(yr, yi, sr, si, base, 0, 0, log2_tile);
}

}  // namespace

// Launch the tile DIF over `rows` rows of 2^log2_tile points on `stream`
// (a cudaStream_t).  Returns the cudaError_t of the launch: 0 = success.
extern "C" int pifft_tile_fft(const float* xr, const float* xi, float* yr,
                              float* yi, const float* twr, const float* twi,
                              long long rows, int log2_tile, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile = 1 << log2_tile;
  const int smem = 2 * tile * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(tile_fft_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (tile >> 1) < 1024 ? (tile >> 1) : 1024;
  tile_fft_kernel<<<static_cast<unsigned int>(rows), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, twr, twi, log2_tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pifft_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* pifft_cuda_error_name(int code) {
  return cudaGetErrorName(static_cast<cudaError_t>(code));
}
