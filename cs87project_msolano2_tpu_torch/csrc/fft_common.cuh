// fft_common.cuh: the radix-2 DIF level loops every FFT kernel of the
// port runs on a block staged in shared memory, and the block copies
// between device memory and shared memory.
//
// tile_fft.cu, long_range.cu, fourstep.cu and sixstep.cu all include
// this header, so the four kernels do the same float32 arithmetic in
// the same order and their compositions agree to float rounding.
//
// Every function is called by all threads of a block and ends with a
// __syncthreads(), so the caller may use the block right after it.

#pragma once

#include <cuda_runtime.h>

namespace pifft {

// Copy a (2^log2_rows) x (2^log2_cb) block whose row r starts at
// src + base + r * stride into shared memory (row-major, cb per row).
// A warp reads neighbouring floats of one row.  kCoherent reads through
// L2 (ld.global.cg): a carry written by other blocks earlier in the
// same launch must never be read through the read-only or L1 path.
template <bool kCoherent>
__device__ __forceinline__ void load_block(float* sr, float* si,
                                           const float* xr, const float* xi,
                                           size_t base, size_t stride,
                                           int log2_rows, int log2_cb) {
  const int total = 1 << (log2_rows + log2_cb);
  const int cmask = (1 << log2_cb) - 1;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const size_t g = base + static_cast<size_t>(idx >> log2_cb) * stride +
                     (idx & cmask);
    if (kCoherent) {
      sr[idx] = __ldcg(xr + g);
      si[idx] = __ldcg(xi + g);
    } else {
      sr[idx] = xr[g];
      si[idx] = xi[g];
    }
  }
  __syncthreads();
}

// The inverse of load_block: write the staged block back to device
// memory at the same (base, stride) geometry.
__device__ __forceinline__ void store_block(float* yr, float* yi,
                                            const float* sr, const float* si,
                                            size_t base, size_t stride,
                                            int log2_rows, int log2_cb) {
  const int total = 1 << (log2_rows + log2_cb);
  const int cmask = (1 << log2_cb) - 1;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const size_t g = base + static_cast<size_t>(idx >> log2_cb) * stride +
                     (idx & cmask);
    yr[g] = sr[idx];
    yi[g] = si[idx];
  }
  __syncthreads();
}

// The first log2_r DIF levels of an n = R * C transform viewed as
// (R, C), on the R x cb column block staged in (sr, si) whose first
// column is c0.  Level l pairs rows (r, r + R/2^(l+1)) inside each group
// of R/2^l rows, and the difference is multiplied by the twiddle
// A[o + j] * B[l, c0 + c] (o = R - (R >> l)): the outer product of the
// per-row factor A (R - 1 floats) and the per-level column factor B
// (levels x C) of long_range_factors(R, C), as the TPU kernel
// _long_range_kernel_sep forms it.
__device__ __forceinline__ void long_range_levels(
    float* sr, float* si, int log2_r, int log2_cb, const float* ar,
    const float* ai, const float* br, const float* bi, size_t C,
    size_t c0) {
  const int R = 1 << log2_r;
  const int cmask = (1 << log2_cb) - 1;
  const int pairs = 1 << (log2_r + log2_cb - 1);
  for (int l = 0; l < log2_r; ++l) {
    const int lh = log2_r - l - 1;  // log2(half)
    const int half = 1 << lh;
    const int o = R - (R >> l);
    const float* blr = br + static_cast<size_t>(l) * C + c0;
    const float* bli = bi + static_cast<size_t>(l) * C + c0;
    for (int idx = threadIdx.x; idx < pairs; idx += blockDim.x) {
      const int q = idx >> log2_cb, c = idx & cmask;
      const int j = q & (half - 1);
      const int top = ((((q >> lh) << (lh + 1)) + j) << log2_cb) | c;
      const int bot = top + (half << log2_cb);
      const float a_r = __ldg(ar + o + j), a_i = __ldg(ai + o + j);
      const float b_r = __ldg(blr + c), b_i = __ldg(bli + c);
      const float wr = a_r * b_r - a_i * b_i;
      const float wi = a_r * b_i + a_i * b_r;
      const float xr_t = sr[top], xi_t = si[top];
      const float xr_b = sr[bot], xi_b = si[bot];
      const float dr = xr_t - xr_b, di = xi_t - xi_b;
      sr[top] = xr_t + xr_b;
      si[top] = xi_t + xi_b;
      sr[bot] = dr * wr - di * wi;
      si[bot] = dr * wi + di * wr;
    }
    __syncthreads();
  }
}

// All log2_tile DIF levels of one tile-point row staged in (sr, si),
// leaving it in pi layout (bit-reversed order).  Level l pairs
// (top, top + half), half = tile >> (l + 1), and multiplies the
// difference by w_l[j] from the concatenated per-level tables of
// twiddle_tables(tile) (level l at offset tile - (tile >> l)).
__device__ __forceinline__ void tile_levels(float* sr, float* si,
                                            int log2_tile, const float* twr,
                                            const float* twi) {
  const int tile = 1 << log2_tile;
  for (int l = 0; l < log2_tile; ++l) {
    const int lh = log2_tile - l - 1;  // log2(half)
    const int half = 1 << lh;
    const int off = tile - (tile >> l);
    for (int i = threadIdx.x; i < (tile >> 1); i += blockDim.x) {
      const int j = i & (half - 1);
      const int top = ((i >> lh) << (lh + 1)) + j;
      const int bot = top + half;
      const float ar = sr[top], ai = si[top];
      const float br = sr[bot], bi = si[bot];
      const float dr = ar - br, di = ai - bi;
      const float wr = __ldg(twr + off + j), wi = __ldg(twi + off + j);
      sr[top] = ar + br;
      si[top] = ai + bi;
      sr[bot] = dr * wr - di * wi;
      si[bot] = dr * wi + di * wr;
    }
    __syncthreads();
  }
}

// Everything a persistent cooperative launch needs: opt the kernel into
// `smem` bytes of dynamic shared memory, size the grid to the blocks
// that can be resident at once (occupancy x SMs, capped at `work`, the
// most work items any phase has), and launch it with
// cudaLaunchCooperativeKernel so that grid.sync() is defined.  Returns
// the cudaError_t: a card without cooperative launch, or a kernel that
// cannot be resident even once per SM, is refused, never run another
// way.
inline cudaError_t launch_cooperative(const void* kernel, int threads,
                                      int smem, long long work, void** args,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long long blocks = static_cast<long long>(per_sm) * sms;
  if (work < blocks) blocks = work;
  if (blocks < 1) blocks = 1;
  err = cudaLaunchCooperativeKernel(kernel,
                                    dim3(static_cast<unsigned int>(blocks)),
                                    dim3(threads), args,
                                    static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace pifft
