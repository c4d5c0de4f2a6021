// long_range_sep: the first log2(R) DIF levels of every n = R * C
// transform in a batch, viewed as (batch, R, C) row-major, with twiddles
// rebuilt from separable factors, on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel cs87project_msolano2_tpu/ops/pallas_fft.py:
// _long_range_kernel_sep (l.519), launched there by
// fft_pi_layout_pallas_rql (l.742, pallas_call l.813) as phase A of the
// rql whole transform.
//
// Design.  Level l pairs rows (r, r + R/2^(l+1)) within each group of
// R/2^l rows, so every level stays inside one column: a block owns `cb`
// contiguous columns across all R rows of one transform and needs no
// data from any other block.  It stages that R x cb block in dynamic
// shared memory (2 * R * cb * 4 bytes: 16 KB at R = 64, cb = 32), loading
// along columns so a warp reads 32 neighbouring floats of one row, runs
// the log2(R) levels there with __syncthreads() between them, and writes
// the block back.  The level-l twiddle of row offset j and column c is
// rebuilt in-kernel as A[o + j] * B[l, c] (o = R - (R >> l)), the outer
// product of the per-row factor A (R - 1 floats) and the per-level
// column factor B (levels x C) of _long_range_factors (l.566), exactly
// as the TPU kernel forms it at l.542-558.  So the pass reads R + levels
// * C twiddle floats instead of (R/2) * C per level of dense tables.
//
// Bound.  Device memory: each element is read once and written once, and
// log2(R) levels do about 11 flop per element each (6 of them rebuilding
// the twiddle), about 66 flop per 16 bytes at R = 64: below the card's
// fp32 ridge, so bytes over HBM bandwidth is the floor.  The design
// keeps all log2(R) levels in shared memory between one coalesced read
// and one coalesced write.

#include <cuda_runtime.h>

namespace {

__global__ void long_range_sep_kernel(const float* __restrict__ xr,
                                      const float* __restrict__ xi,
                                      float* __restrict__ yr,
                                      float* __restrict__ yi,
                                      const float* __restrict__ ar,
                                      const float* __restrict__ ai,
                                      const float* __restrict__ br,
                                      const float* __restrict__ bi,
                                      int log2_r, int C, int log2_cb) {
  extern __shared__ float smem[];
  const int R = 1 << log2_r;
  const int cb = 1 << log2_cb;
  const int total = R << log2_cb;  // R * cb
  float* sr = smem;
  float* si = smem + total;

  const int col_blocks = C >> log2_cb;
  const long long t = blockIdx.x / col_blocks;  // transform in the batch
  const int c0 = (blockIdx.x - t * col_blocks) << log2_cb;
  const size_t base = static_cast<size_t>(t) * R * C + c0;

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx >> log2_cb, c = idx & (cb - 1);
    const size_t g = base + static_cast<size_t>(r) * C + c;
    sr[idx] = xr[g];
    si[idx] = xi[g];
  }
  __syncthreads();

  for (int l = 0; l < log2_r; ++l) {
    const int lh = log2_r - l - 1;  // log2(half)
    const int half = 1 << lh;
    const int o = R - (R >> l);
    const float* blr = br + static_cast<size_t>(l) * C + c0;
    const float* bli = bi + static_cast<size_t>(l) * C + c0;
    for (int idx = threadIdx.x; idx < (total >> 1); idx += blockDim.x) {
      const int q = idx >> log2_cb, c = idx & (cb - 1);
      const int j = q & (half - 1);
      const int top = (((q >> lh) << (lh + 1)) + j) << log2_cb | c;
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

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int r = idx >> log2_cb, c = idx & (cb - 1);
    const size_t g = base + static_cast<size_t>(r) * C + c;
    yr[g] = sr[idx];
    yi[g] = si[idx];
  }
}

}  // namespace

// Launch the long-range levels over `batch` transforms of (2^log2_r, C)
// in column blocks of 2^log2_cb on `stream` (a cudaStream_t).  Returns
// the cudaError_t of the launch: 0 = success.
extern "C" int pifft_long_range_sep(const float* xr, const float* xi,
                                    float* yr, float* yi, const float* ar,
                                    const float* ai, const float* br,
                                    const float* bi, long long batch,
                                    int log2_r, int C, int log2_cb,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int total = (1 << log2_r) << log2_cb;
  const int smem = 2 * total * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(long_range_sep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (total >> 1) < 256 ? (total >> 1) : 256;
  const long long blocks = batch * (C >> log2_cb);
  long_range_sep_kernel<<<static_cast<unsigned int>(blocks), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      xr, xi, yr, yi, ar, ai, br, bi, log2_r, C, log2_cb);
  return static_cast<int>(cudaGetLastError());
}
