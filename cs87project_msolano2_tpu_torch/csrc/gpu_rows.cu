// gpu_rows: the pi-layout radix-2 DIF of every row of (rows, n) float32
// planes, 2 <= n <= 2^18, twiddles from the (stages, n / 2) stack of
// twiddle_stack(n), on an NVIDIA Hopper card (sm_90a).  The gpu plan
// backend's gpu-rows rung.
//
// Replaces the GPU-portable Pallas kernel
// cs87project_msolano2_tpu/hw/lowering.py: _radix2_kernel (l.82),
// launched there by fft_rows_gpu (l.116, pallas_call l.145) with
// block_rows rows per grid step.
//
// Design.  One launch per call.  Rows of up to 2^14 points run whole in
// shared memory: a block stages block_rows rows back to back (re + im,
// 8 * block_rows * n bytes, at most 2^14 points, 128 KB), runs all
// log2(n) levels over them with __syncthreads() between levels
// (pifft::row_levels in fft_common.cuh, the tile kernels' level loop,
// here with the stack as its twiddle source, pifft::StackTwiddle), and
// writes them back.  Block_rows rows per block let tiny rows (n = 2..64)
// share one block instead of idling most of a warp each.
//
// A row of 2^15..2^18 points does not fit one SM's 227 KB.  A block
// then owns block_rows whole rows, one after the other, each in two
// passes over device memory inside the same launch.  Pass A runs the
// row's leading log2(R) levels, R = n / 2^14, on its (R, 2^14) view in
// R x (2^14 / R) column blocks staged in shared memory
// (pifft::long_range_levels, the stack as a long-range source) and
// writes the row into y; pass B reads each 2^14-point segment of y back
// (through L2: __syncthreads() makes the block's own writes visible)
// and runs its remaining 14 levels in shared memory.  So a long row
// moves through device memory twice: one carry round trip
// (utils/roofline.py charges gpu-rows one carry pass from n = 2^15).
// A cluster design that spreads a long row over the distributed shared
// memory of 8 to 16 blocks would keep it on chip; that is a later
// redesign.
//
// Bound.  Device memory: 16 bytes per element each way plus the stack's
// n - 1 distinct complex entries (row s is read only below (n >> s) / 2;
// once per launch from device memory, then from L2 by every row),
// against 5 flop per element
// per level: far below the card's fp32 ridge, so bytes over HBM
// bandwidth is the floor.  Long rows pay the carry round trip on top.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

// log2 of the longest row one block holds in shared memory
constexpr int kLog2Seg = 14;

__global__ void gpu_rows_short(const float* __restrict__ xr,
                               const float* __restrict__ xi,
                               float* __restrict__ yr,
                               float* __restrict__ yi,
                               const float* __restrict__ twr,
                               const float* __restrict__ twi, int log2_n,
                               int log2_block_rows) {
  extern __shared__ float smem[];
  const int log2_total = log2_n + log2_block_rows;
  float* sr = smem;
  float* si = smem + (1 << log2_total);
  const size_t base = static_cast<size_t>(blockIdx.x) << log2_total;
  pifft::load_block<pifft::Load::kCached>(sr, si, xr, xi, base, 0, 0,
                                         log2_total);
  const pifft::StackTwiddle tw{twr, twi, static_cast<size_t>(1)
                                             << (log2_n - 1),
                               0, 0};
  pifft::row_levels(sr, si, log2_total, log2_n, tw);
  pifft::store_block(yr, yi, sr, si, base, 0, 0, log2_total);
}

__global__ void gpu_rows_long(const float* __restrict__ xr,
                              const float* __restrict__ xi, float* yr,
                              float* yi, const float* __restrict__ twr,
                              const float* __restrict__ twi, int log2_n,
                              int log2_block_rows) {
  extern __shared__ float smem[];
  float* sr = smem;
  float* si = smem + (1 << kLog2Seg);
  const int log2_r = log2_n - kLog2Seg;  // the leading levels
  const int log2_cb = kLog2Seg - log2_r;  // R x cb fills the segment
  const size_t C = static_cast<size_t>(1) << kLog2Seg;
  const size_t half_n = static_cast<size_t>(1) << (log2_n - 1);
  const pifft::StackTwiddle lead{twr, twi, half_n, C, 0};
  const pifft::StackTwiddle rest{twr, twi, half_n, 0, log2_r};
  for (int k = 0; k < (1 << log2_block_rows); ++k) {
    const size_t row =
        ((static_cast<size_t>(blockIdx.x) << log2_block_rows) + k) << log2_n;
    // pass A: the leading levels on the (R, 2^14) view, into y
    for (size_t c0 = 0; c0 < C; c0 += static_cast<size_t>(1) << log2_cb) {
      pifft::load_block<pifft::Load::kCached>(sr, si, xr, xi, row + c0, C,
                                             log2_r, log2_cb);
      pifft::long_range_levels(sr, si, log2_r, log2_cb, lead, c0);
      pifft::store_block<pifft::Store::kGlobal>(yr, yi, sr, si, row + c0, C,
                                                log2_r, log2_cb);
    }
    // pass B: the remaining levels of each 2^14-point segment, in place
    for (int s = 0; s < (1 << log2_r); ++s) {
      const size_t base = row + (static_cast<size_t>(s) << kLog2Seg);
      pifft::load_block<pifft::Load::kCoherent>(sr, si, yr, yi, base, 0, 0,
                                               kLog2Seg);
      pifft::row_levels(sr, si, kLog2Seg, kLog2Seg, rest);
      pifft::store_block(yr, yi, sr, si, base, 0, 0, kLog2Seg);
    }
  }
}

}  // namespace

// Launch the DIF of `rows` rows of 2^log2_n points, 2^log2_block_rows
// rows per block, on `stream` (a cudaStream_t); (twr, twi) is the
// (log2_n, n / 2) stack of twiddle_stack(n).  The caller checks that
// block_rows divides rows and that a short block fits shared memory
// (block_rows * n <= 2^14).  Returns the cudaError_t of the launch:
// 0 = success.
extern "C" int pifft_gpu_rows(const float* xr, const float* xi, float* yr,
                              float* yi, const float* twr, const float* twi,
                              long long rows, int log2_n,
                              int log2_block_rows, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks =
      static_cast<unsigned int>(rows >> log2_block_rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log2_n <= kLog2Seg) {
    const int log2_total = log2_n + log2_block_rows;
    const int smem = 2 * (1 << log2_total) * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(gpu_rows_short,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int pairs = 1 << (log2_total - 1);
    const int threads = pairs < 1024 ? pairs : 1024;
    gpu_rows_short<<<blocks, threads, smem, s>>>(xr, xi, yr, yi, twr, twi,
                                                 log2_n, log2_block_rows);
  } else {
    const int smem = 2 * (1 << kLog2Seg) * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(gpu_rows_long,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gpu_rows_long<<<blocks, 1024, smem, s>>>(xr, xi, yr, yi, twr, twi,
                                             log2_n, log2_block_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
