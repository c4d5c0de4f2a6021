// fft_common.cuh: the radix-2 DIF level loops every FFT kernel of the
// port runs on a block staged in shared memory, the twiddle sources of
// the long-range levels, and the block copies between device memory and
// shared memory.
//
// tile_fft.cu, long_range.cu, fourstep.cu, sixstep.cu, fused.cu and
// gpu_rows.cu all include this header, so the kernels do the same float32
// arithmetic in the same order and their compositions agree to float
// rounding.
//
// Every function is called by all threads of a block and ends with a
// __syncthreads(), so the caller may use the block right after it.

#pragma once

#include <cuda_runtime.h>

namespace pifft {

// How a block copy reads device memory.
//   kCached    plain loads (L1 and L2);
//   kCoherent  ld.global.cg, through L2 only: a carry written by other
//              blocks earlier in the same launch must never be read
//              through the read-only or L1 path;
//   kStreaming ld.global.cs, evict-first: data read exactly once, kept
//              from pushing longer-lived lines (a carry) out of L2.
enum class Load { kCached, kCoherent, kStreaming };

// How a block copy writes device memory.
//   kCached    plain stores;
//   kGlobal    st.global.cg, cached in L2 (a carry read back in the same
//              launch);
//   kStreaming st.global.cs, evict-first: output nobody in the launch
//              reads again.
enum class Store { kCached, kGlobal, kStreaming };

template <Load kLoad>
__device__ __forceinline__ float load_one(const float* p) {
  if (kLoad == Load::kCoherent) return __ldcg(p);
  if (kLoad == Load::kStreaming) return __ldcs(p);
  return *p;
}

template <Store kStore>
__device__ __forceinline__ void store_one(float* p, float v) {
  if (kStore == Store::kGlobal) {
    __stcg(p, v);
  } else if (kStore == Store::kStreaming) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// Copy a (2^log2_rows) x (2^log2_cb) block whose row r starts at
// src + base + r * stride into shared memory (row-major, cb per row).
// A warp reads neighbouring floats of one row.
template <Load kLoad>
__device__ __forceinline__ void load_block(float* sr, float* si,
                                           const float* xr, const float* xi,
                                           size_t base, size_t stride,
                                           int log2_rows, int log2_cb) {
  const int total = 1 << (log2_rows + log2_cb);
  const int cmask = (1 << log2_cb) - 1;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const size_t g = base + static_cast<size_t>(idx >> log2_cb) * stride +
                     (idx & cmask);
    sr[idx] = load_one<kLoad>(xr + g);
    si[idx] = load_one<kLoad>(xi + g);
  }
  __syncthreads();
}

// The inverse of load_block: write the staged block back to device
// memory at the same (base, stride) geometry.
template <Store kStore = Store::kCached>
__device__ __forceinline__ void store_block(float* yr, float* yi,
                                            const float* sr, const float* si,
                                            size_t base, size_t stride,
                                            int log2_rows, int log2_cb) {
  const int total = 1 << (log2_rows + log2_cb);
  const int cmask = (1 << log2_cb) - 1;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const size_t g = base + static_cast<size_t>(idx >> log2_cb) * stride +
                     (idx & cmask);
    store_one<kStore>(yr + g, sr[idx]);
    store_one<kStore>(yi + g, si[idx]);
  }
  __syncthreads();
}

// The two twiddle sources of the long-range levels of an n = R * C
// transform viewed as (R, C).  at(l, o, j, col) gives the level-l
// twiddle of row offset j (0 <= j < R >> (l + 1)) and column col,
// o = R - (R >> l).

// Separable factors: the outer product A[o + j] * B[l, col] of the
// per-row factor A (R - 1 floats) and the per-level column factor B
// (levels x C) of long_range_factors(R, C), as the TPU kernel
// _long_range_kernel_sep forms it.  Reads R + levels * C floats a plane.
struct SeparableTwiddle {
  const float* ar;
  const float* ai;
  const float* br;
  const float* bi;
  size_t C;

  __device__ __forceinline__ void at(int l, int o, int j, size_t col,
                                     float& wr, float& wi) const {
    const float a_r = __ldg(ar + o + j), a_i = __ldg(ai + o + j);
    const size_t b = static_cast<size_t>(l) * C + col;
    const float b_r = __ldg(br + b), b_i = __ldg(bi + b);
    wr = a_r * b_r - a_i * b_i;
    wi = a_r * b_i + a_i * b_r;
  }
};

// Dense per-level tables: level l's (R >> (l + 1), C) table, the n-point
// level-l table of twiddle_tables(R * C) reshaped (as the TPU kernel
// _long_range_kernel reads it), stacked at rows [o, o + half) of one
// (R - 1, C) array a plane (dense_long_range_tables).  Reads about n
// floats a plane.  kStreaming reads them evict-first, for tables each
// of whose entries one block reads; otherwise through the read-only
// path, for tables many blocks share.
template <bool kStreaming>
struct DenseTwiddle {
  const float* wr;
  const float* wi;
  size_t C;

  __device__ __forceinline__ void at(int, int o, int j, size_t col,
                                     float& w_r, float& w_i) const {
    const size_t g = static_cast<size_t>(o + j) * C + col;
    if (kStreaming) {
      w_r = __ldcs(wr + g);
      w_i = __ldcs(wi + g);
    } else {
      w_r = __ldg(wr + g);
      w_i = __ldg(wi + g);
    }
  }
};

// The (stages, n / 2) twiddle stack of the gpu-rows family
// (twiddle_stack(n)): stack row s holds W_m^j for m = n >> s and
// j < m / 2, zero past it.  The levels run here are the stack rows from
// level0 on.  As a long-range source of the (R, C) view of one n-point
// row, level l's twiddle of row offset j and column col is
// W_{n >> l}^{j * C + col}, entry j * C + col of stack row level0 + l;
// as a row source (row_levels), level l's w[j] is entry j of stack row
// level0 + l.  Read through the read-only path: every block of a
// launch shares the stack.
struct StackTwiddle {
  const float* wr;
  const float* wi;
  size_t half_n;  // n / 2, the length of one stack row
  size_t C;       // columns of the long-range (R, C) view
  int level0;

  __device__ __forceinline__ void at(int l, int, int j, size_t col,
                                     float& w_r, float& w_i) const {
    const size_t g = static_cast<size_t>(level0 + l) * half_n +
                     static_cast<size_t>(j) * C + col;
    w_r = __ldg(wr + g);
    w_i = __ldg(wi + g);
  }

  __device__ __forceinline__ void row(int l, int j, float& w_r,
                                      float& w_i) const {
    const size_t g = static_cast<size_t>(level0 + l) * half_n + j;
    w_r = __ldg(wr + g);
    w_i = __ldg(wi + g);
  }
};

// The per-level tables of twiddle_tables(tile) concatenated into one
// array a plane (flat_tables): level l's w[j] at offset
// tile - (tile >> l) + j.  The tile kernels' row source.
struct FlatTwiddle {
  const float* wr;
  const float* wi;
  int tile;

  __device__ __forceinline__ void row(int l, int j, float& w_r,
                                      float& w_i) const {
    const int g = tile - (tile >> l) + j;
    w_r = __ldg(wr + g);
    w_i = __ldg(wi + g);
  }
};

// The first log2_r DIF levels of an n = R * C transform viewed as
// (R, C), on the R x cb column block staged in (sr, si) whose first
// column is c0.  Level l pairs rows (r, r + R/2^(l+1)) inside each group
// of R/2^l rows, and the difference is multiplied by the twiddle
// tw.at(l, o, j, c0 + c) (o = R - (R >> l)): either source above, picked
// at compile time.
template <class Twiddle>
__device__ __forceinline__ void long_range_levels(float* sr, float* si,
                                                  int log2_r, int log2_cb,
                                                  const Twiddle& tw,
                                                  size_t c0) {
  const int R = 1 << log2_r;
  const int cmask = (1 << log2_cb) - 1;
  const int pairs = 1 << (log2_r + log2_cb - 1);
  for (int l = 0; l < log2_r; ++l) {
    const int lh = log2_r - l - 1;  // log2(half)
    const int half = 1 << lh;
    const int o = R - (R >> l);
    for (int idx = threadIdx.x; idx < pairs; idx += blockDim.x) {
      const int q = idx >> log2_cb, c = idx & cmask;
      const int j = q & (half - 1);
      const int top = ((((q >> lh) << (lh + 1)) + j) << log2_cb) | c;
      const int bot = top + (half << log2_cb);
      float wr, wi;
      tw.at(l, o, j, c0 + c, wr, wi);
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

// The first log2_n DIF levels of every 2^log2_n-point row of the
// 2^log2_total points staged in (sr, si) (rows back to back), leaving
// each row in pi layout (bit-reversed order) once all log2_n levels of
// the row have run.  Level l pairs (top, top + half), half = n >> (l + 1)
// inside each group of 2 * half, and multiplies the difference by w_l[j]
// from the row source tw.row(l, j): either source above, picked at
// compile time.
template <class Twiddle>
__device__ __forceinline__ void row_levels(float* sr, float* si,
                                           int log2_total, int log2_n,
                                           const Twiddle& tw) {
  const int pairs = 1 << (log2_total - 1);
  for (int l = 0; l < log2_n; ++l) {
    const int lh = log2_n - l - 1;  // log2(half)
    const int half = 1 << lh;
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const int j = i & (half - 1);
      const int top = ((i >> lh) << (lh + 1)) + j;
      const int bot = top + half;
      const float ar = sr[top], ai = si[top];
      const float br = sr[bot], bi = si[bot];
      const float dr = ar - br, di = ai - bi;
      float wr, wi;
      tw.row(l, j, wr, wi);
      sr[top] = ar + br;
      si[top] = ai + bi;
      sr[bot] = dr * wr - di * wi;
      si[bot] = dr * wi + di * wr;
    }
    __syncthreads();
  }
}

// All log2_tile DIF levels of one tile-point row staged in (sr, si),
// leaving it in pi layout, twiddles from the concatenated per-level
// tables of twiddle_tables(tile) (level l at offset tile - (tile >> l)).
__device__ __forceinline__ void tile_levels(float* sr, float* si,
                                            int log2_tile, const float* twr,
                                            const float* twi) {
  row_levels(sr, si, log2_tile, log2_tile,
             FlatTwiddle{twr, twi, 1 << log2_tile});
}

// Everything a persistent cooperative launch needs: opt the kernel into
// `smem` bytes of dynamic shared memory, size the grid to the blocks
// that can be resident at once (occupancy x SMs, capped at `work`, the
// most work items any phase has), and launch it cooperatively so that
// grid.sync() is defined.  With a `window`, the launch carries it as its
// own access-policy attribute (cudaLaunchKernelExC), so the policy
// covers this launch only and never stays on the stream.  Returns the
// cudaError_t: a card without cooperative launch, or a kernel that
// cannot be resident even once per SM, is refused, never run another
// way.
inline cudaError_t launch_cooperative(
    const void* kernel, int threads, int smem, long long work, void** args,
    int device, void* stream,
    const cudaAccessPolicyWindow* window = nullptr) {
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
  const dim3 grid(static_cast<unsigned int>(blocks));
  if (window == nullptr) {
    err = cudaLaunchCooperativeKernel(kernel, grid, dim3(threads), args,
                                      static_cast<size_t>(smem),
                                      static_cast<cudaStream_t>(stream));
  } else {
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeCooperative;
    attrs[0].val.cooperative = 1;
    attrs[1].id = cudaLaunchAttributeAccessPolicyWindow;
    attrs[1].val.accessPolicyWindow = *window;
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = static_cast<size_t>(smem);
    config.stream = static_cast<cudaStream_t>(stream);
    config.attrs = attrs;
    config.numAttrs = 2;
    err = cudaLaunchKernelExC(&config, kernel, args);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace pifft
