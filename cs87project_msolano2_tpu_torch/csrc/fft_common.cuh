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
//
// The second half of the file (from "Hopper building blocks") holds the
// redesigned loop of gpu_rows.cu and fused.cu: radix-8/16 butterfly
// groups in registers over a padded shared-memory layout, float4 block
// copies, and a row spread over a thread-block cluster.  The first half
// is left as it is, so tile_fft, long_range, fourstep, sixstep and mf
// compile to the code they always did.

#pragma once

#include <cooperative_groups.h>
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

// --- Hopper building blocks: the register radix loop ------------------
//
// The loops above do one radix-2 level per __syncthreads(), each
// butterfly four shared-memory reads and four writes, between a block
// copy in and a block copy out.  The passes below load the 2^K points
// of one butterfly group (K <= 4: radix 16) into registers, run K DIF
// levels there with the same butterflies and the same table twiddles,
// and write them back: one shared-memory pass and one __syncthreads()
// per K levels.  The first pass of a row reads its points straight from
// device memory and the last writes them straight back, so a 2^12-point
// row is three passes (device -> registers -> shared, shared -> shared,
// shared -> device) where the loops above made fourteen.  A group's
// 2^(K-q-1) distinct level-q twiddles are read once each (through the
// twiddle source) and shared by its 2^q butterfly pairs.
//
// The shared planes are PADDED: point i lives at pad_index(i) = i + i /
// 32, one float of padding after every 32.  A group whose smallest half
// s is under 32 points reads 2^K points a thread at stride s, and the
// padding spreads a warp's accesses over the 32 banks (conflict free
// for s = 1 and s >= 32, at most two-way between).

__host__ __device__ constexpr int pad_index(int i) {
  return i + (i >> 5);
}

// floats one padded plane of m points takes
__host__ __device__ constexpr int padded_floats(int m) {
  return m + (m >> 5);
}

template <Load kLoad>
__device__ __forceinline__ float4 load_four(const float* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  if (kLoad == Load::kCoherent) return __ldcg(q);
  if (kLoad == Load::kStreaming) return __ldcs(q);
  return *q;
}

template <Store kStore>
__device__ __forceinline__ void store_four(float* p, float4 v) {
  float4* q = reinterpret_cast<float4*>(p);
  if (kStore == Store::kGlobal) {
    __stcg(q, v);
  } else if (kStore == Store::kStreaming) {
    __stcs(q, v);
  } else {
    *q = v;
  }
}

// K radix-2 DIF levels on the 2^K points (re, im) held in registers:
// level q pairs (t, t + h), h = 2^(K-q-1), inside each group of 2h
// points and multiplies the difference by the twiddle of its offset
// jj = t mod h, held at slot tw_slot<K>(q, jj) of (wr, wi) — the
// arithmetic of row_levels, butterfly for butterfly.  The twiddles are
// loaded by the caller (all 2^K - 1 of a group before any butterfly, so
// their loads overlap), and every index here is a constant once the
// loops are unrolled: the points stay in registers.
template <int K>
__host__ __device__ constexpr int tw_slot(int q, int jj) {
  return (1 << K) - (2 << (K - q - 1)) + jj;
}

template <int K>
__device__ __forceinline__ void dif_registers(float (&re)[1 << K],
                                              float (&im)[1 << K],
                                              const float (&wr)[1 << K],
                                              const float (&wi)[1 << K]) {
  // both loops have constant trip counts, so they unroll fully and every
  // index below folds to a constant
#pragma unroll
  for (int q = 0; q < K; ++q) {
#pragma unroll
    for (int b = 0; b < (1 << (K - 1)); ++b) {
      const int lh = K - q - 1;  // log2 of the half
      const int jj = b & ((1 << lh) - 1);
      const int t = ((b >> lh) << (lh + 1)) + jj;
      const int u = t + (1 << lh);
      const float w_r = wr[tw_slot<K>(q, jj)], w_i = wi[tw_slot<K>(q, jj)];
      const float ar = re[t], ai = im[t];
      const float br = re[u], bi = im[u];
      const float dr = ar - br, di = ai - bi;
      re[t] = ar + br;
      im[t] = ai + bi;
      re[u] = dr * w_r - di * w_i;
      im[u] = dr * w_i + di * w_r;
    }
  }
}

// One pass of K levels (level .. level + K - 1) over the 2^log2_n-point
// rows of a block's 2^log2_total points, rows back to back, whose
// smallest half is 2^s_log points.  Thread item idx owns the points
// base + t * 2^s_log, t < 2^K; twiddles tw.row(level + q, j).  kIn reads
// them from device memory at x + g0 (else from the padded planes), kOut
// writes them to y + g0 (else back to the planes); 2^K >= 4 points that
// lie side by side move as float4s (g0 is then a multiple of 4 and the
// planes 16-byte aligned: the wrappers check).  Ends in __syncthreads().
template <int K, bool kIn, bool kOut, Load kLoad, Store kStore,
          class Twiddle>
__device__ __forceinline__ void row_pass(float* sr, float* si,
                                         const float* xr, const float* xi,
                                         float* yr, float* yi, size_t g0,
                                         int log2_total, int s_log,
                                         int level, const Twiddle& tw) {
  constexpr int P = 1 << K;
  const int items = 1 << (log2_total - K);
  const int smask = (1 << s_log) - 1;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int j0 = idx & smask;
    const int base = ((idx >> s_log) << (s_log + K)) + j0;
    float re[P], im[P];
    bool done = false;
    if constexpr (kIn && K >= 2) {
      if (s_log == 0) {
#pragma unroll
        for (int v = 0; v < P; v += 4) {
          const float4 a = load_four<kLoad>(xr + g0 + base + v);
          const float4 b = load_four<kLoad>(xi + g0 + base + v);
          re[v] = a.x; re[v + 1] = a.y; re[v + 2] = a.z; re[v + 3] = a.w;
          im[v] = b.x; im[v + 1] = b.y; im[v + 2] = b.z; im[v + 3] = b.w;
        }
        done = true;
      }
    }
    if (!done) {
#pragma unroll
      for (int t = 0; t < P; ++t) {
        const int i = base + (t << s_log);
        if constexpr (kIn) {
          re[t] = load_one<kLoad>(xr + g0 + i);
          im[t] = load_one<kLoad>(xi + g0 + i);
        } else {
          re[t] = sr[pad_index(i)];
          im[t] = si[pad_index(i)];
        }
      }
    }
    // the group's twiddles, all loaded before any butterfly (constant
    // trip counts, as in dif_registers, so the slots stay registers)
    float wr[P], wi[P];
#pragma unroll
    for (int q = 0; q < K; ++q) {
#pragma unroll
      for (int jj = 0; jj < (1 << (K - 1)); ++jj) {
        if (jj < (1 << (K - q - 1))) {
          tw.row(level + q, (jj << s_log) + j0, wr[tw_slot<K>(q, jj)],
                 wi[tw_slot<K>(q, jj)]);
        }
      }
    }
    dif_registers<K>(re, im, wr, wi);
    done = false;
    if constexpr (kOut && K >= 2) {
      if (s_log == 0) {
#pragma unroll
        for (int v = 0; v < P; v += 4) {
          store_four<kStore>(yr + g0 + base + v,
                             make_float4(re[v], re[v + 1], re[v + 2],
                                         re[v + 3]));
          store_four<kStore>(yi + g0 + base + v,
                             make_float4(im[v], im[v + 1], im[v + 2],
                                         im[v + 3]));
        }
        done = true;
      }
    }
    if (!done) {
#pragma unroll
      for (int t = 0; t < P; ++t) {
        const int i = base + (t << s_log);
        if constexpr (kOut) {
          store_one<kStore>(yr + g0 + i, re[t]);
          store_one<kStore>(yi + g0 + i, im[t]);
        } else {
          sr[pad_index(i)] = re[t];
          si[pad_index(i)] = im[t];
        }
      }
    }
  }
  __syncthreads();
}

// The first pass of row_levels_radix: K levels, from device memory
// (kIn) or the planes, into the planes, or straight to device memory
// (kOut) when they are all the row has.
template <int K, bool kIn, bool kOut, Load kLoad, Store kStore,
          class Twiddle>
__device__ __forceinline__ void row_first_pass(
    float* sr, float* si, const float* xr, const float* xi, float* yr,
    float* yi, size_t g0, int log2_total, int log2_n, int level,
    const Twiddle& tw) {
  if (K == log2_n) {
    row_pass<K, kIn, kOut, kLoad, kStore>(sr, si, xr, xi, yr, yi, g0,
                                          log2_total, 0, level, tw);
  } else {
    row_pass<K, kIn, false, kLoad, kStore>(sr, si, xr, xi, yr, yi, g0,
                                           log2_total, log2_n - K, level,
                                           tw);
  }
}

// All log2_n DIF levels of every 2^log2_n-point row of a block's
// 2^log2_total points, rows back to back, leaving each row in pi layout:
// row_levels' arithmetic in passes of 4 levels, the first pass taking
// the 1..4 left over.  The rows come from x + g0 (kIn) or the padded
// planes (sr, si), and go to y + g0 (kOut) or back to the planes.
// Level l's twiddles are tw.row(level + l, j): `level` > 0 runs the
// trailing levels of a longer row whose 2^log2_n-point segment this is.
template <bool kIn, bool kOut, Load kLoad, Store kStore, class Twiddle>
__device__ __forceinline__ void row_levels_radix(
    float* sr, float* si, const float* xr, const float* xi, float* yr,
    float* yi, size_t g0, int log2_total, int log2_n, int level,
    const Twiddle& tw) {
  const int k1 = ((log2_n - 1) & 3) + 1;
  switch (k1) {
    case 1:
      row_first_pass<1, kIn, kOut, kLoad, kStore>(
          sr, si, xr, xi, yr, yi, g0, log2_total, log2_n, level, tw);
      break;
    case 2:
      row_first_pass<2, kIn, kOut, kLoad, kStore>(
          sr, si, xr, xi, yr, yi, g0, log2_total, log2_n, level, tw);
      break;
    case 3:
      row_first_pass<3, kIn, kOut, kLoad, kStore>(
          sr, si, xr, xi, yr, yi, g0, log2_total, log2_n, level, tw);
      break;
    default:
      row_first_pass<4, kIn, kOut, kLoad, kStore>(
          sr, si, xr, xi, yr, yi, g0, log2_total, log2_n, level, tw);
      break;
  }
  for (int l = k1; l < log2_n; l += 4) {
    const int s_log = log2_n - l - 4;
    if (s_log == 0) {
      row_pass<4, false, kOut, kLoad, kStore>(sr, si, xr, xi, yr, yi, g0,
                                              log2_total, 0, level + l, tw);
    } else {
      row_pass<4, false, false, kLoad, kStore>(sr, si, xr, xi, yr, yi, g0,
                                               log2_total, s_log, level + l,
                                               tw);
    }
  }
}

// One pass of K long-range levels (l0 .. l0 + K - 1) on the R x cb
// column block whose row r, column c lies at c0 + r * stride + c in
// device memory and at pad_index(r * cb + c) in the planes: thread item
// idx owns column c and the rows row0 + t * 2^s_log, s_log = log2_r - l0
// - K.  Twiddles tw.at(l, R - (R >> l), j, c0 + c), as long_range_levels
// reads them.  kIn / kOut as in row_pass (scalar copies: a warp reads
// or writes 32 neighbouring columns of one row).  Ends in
// __syncthreads().
template <int K, bool kIn, bool kOut, Load kLoad, Store kStore,
          class Twiddle>
__device__ __forceinline__ void long_range_pass(
    float* sr, float* si, const float* xr, const float* xi, float* yr,
    float* yi, size_t c0, size_t stride, int log2_r, int log2_cb, int l0,
    const Twiddle& tw) {
  const int R = 1 << log2_r;
  const int s_log = log2_r - l0 - K;
  const int items = 1 << (log2_r - K + log2_cb);
  const int cmask = (1 << log2_cb) - 1;
  const int smask = (1 << s_log) - 1;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int c = idx & cmask;
    const int q = idx >> log2_cb;
    const int j0 = q & smask;
    const int row0 = ((q >> s_log) << (s_log + K)) + j0;
    float re[1 << K], im[1 << K];
#pragma unroll
    for (int t = 0; t < (1 << K); ++t) {
      const int r = row0 + (t << s_log);
      if constexpr (kIn) {
        const size_t g = c0 + static_cast<size_t>(r) * stride + c;
        re[t] = load_one<kLoad>(xr + g);
        im[t] = load_one<kLoad>(xi + g);
      } else {
        re[t] = sr[pad_index((r << log2_cb) | c)];
        im[t] = si[pad_index((r << log2_cb) | c)];
      }
    }
    float wr[1 << K], wi[1 << K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
#pragma unroll
      for (int jj = 0; jj < (1 << (K - 1)); ++jj) {
        if (jj < (1 << (K - q - 1))) {
          const int l = l0 + q;
          tw.at(l, R - (R >> l), (jj << s_log) + j0, c0 + c,
                wr[tw_slot<K>(q, jj)], wi[tw_slot<K>(q, jj)]);
        }
      }
    }
    dif_registers<K>(re, im, wr, wi);
#pragma unroll
    for (int t = 0; t < (1 << K); ++t) {
      const int r = row0 + (t << s_log);
      if constexpr (kOut) {
        const size_t g = c0 + static_cast<size_t>(r) * stride + c;
        store_one<kStore>(yr + g, re[t]);
        store_one<kStore>(yi + g, im[t]);
      } else {
        sr[pad_index((r << log2_cb) | c)] = re[t];
        si[pad_index((r << log2_cb) | c)] = im[t];
      }
    }
  }
  __syncthreads();
}

template <int K, Load kLoad, Store kStore, class Twiddle>
__device__ __forceinline__ void long_range_first_pass(
    float* sr, float* si, const float* xr, const float* xi, float* yr,
    float* yi, size_t c0, size_t stride, int log2_r, int log2_cb,
    const Twiddle& tw) {
  if (K == log2_r) {
    long_range_pass<K, true, true, kLoad, kStore>(
        sr, si, xr, xi, yr, yi, c0, stride, log2_r, log2_cb, 0, tw);
  } else {
    long_range_pass<K, true, false, kLoad, kStore>(
        sr, si, xr, xi, yr, yi, c0, stride, log2_r, log2_cb, 0, tw);
  }
}

// The first log2_r DIF levels of an (R, C) view on its R x cb column
// block at column c0 (row stride `stride`), from x to y in device
// memory through the padded planes: long_range_levels' arithmetic in
// passes of 3 levels (radix 8: an R = 64, cb = 32 block gives 256 thread
// items a pass), the first pass taking the 1..3 left over.
template <Load kLoad, Store kStore, class Twiddle>
__device__ __forceinline__ void long_range_levels_radix(
    float* sr, float* si, const float* xr, const float* xi, float* yr,
    float* yi, size_t c0, size_t stride, int log2_r, int log2_cb,
    const Twiddle& tw) {
  const int k1 = (log2_r - 1) % 3 + 1;
  switch (k1) {
    case 1:
      long_range_first_pass<1, kLoad, kStore>(sr, si, xr, xi, yr, yi, c0,
                                              stride, log2_r, log2_cb, tw);
      break;
    case 2:
      long_range_first_pass<2, kLoad, kStore>(sr, si, xr, xi, yr, yi, c0,
                                              stride, log2_r, log2_cb, tw);
      break;
    default:
      long_range_first_pass<3, kLoad, kStore>(sr, si, xr, xi, yr, yi, c0,
                                              stride, log2_r, log2_cb, tw);
      break;
  }
  for (int l = k1; l < log2_r; l += 3) {
    if (l + 3 == log2_r) {
      long_range_pass<3, false, true, kLoad, kStore>(
          sr, si, xr, xi, yr, yi, c0, stride, log2_r, log2_cb, l, tw);
    } else {
      long_range_pass<3, false, false, kLoad, kStore>(
          sr, si, xr, xi, yr, yi, c0, stride, log2_r, log2_cb, l, tw);
    }
  }
}

// --- Hopper building blocks: a row spread over a thread-block cluster --
//
// The 2^LOG2K * S-point row at x + row (S = 2^log2_seg >= 2^LOG2K) on the
// 2^LOG2K blocks of a cluster, block rank r ending up with points
// [r S, (r + 1) S) in its padded planes (sr, si) and writing them, in pi
// layout, to y + row + r S.  The row's first LOG2K levels pair points S
// apart or more, so they run across the cluster: block r takes columns
// [r S / K, (r + 1) S / K) of the (K, S) view, reads each column's K
// points from device memory into registers (16 / K columns at a time,
// so each thread keeps 16 loads in flight), runs the levels there
// (twiddles tw.row(q, j * S + c)) and writes point k of the column into
// block k's planes through distributed shared memory.  The remaining
// log2_seg levels are local to each block (row_levels_radix, twiddles
// from level LOG2K on, the last pass to device memory).  The first
// cluster.sync() comes before any block writes a remote buffer (every
// block of the cluster is running and done with its planes' previous
// row); the second after every remote write and before the local
// levels, so no block touches another's buffer after it and a block may
// go on to its next row or exit.
template <int LOG2K, Load kLoad, Store kStore, class Twiddle>
__device__ __forceinline__ void cluster_row_levels(
    float* sr, float* si, const float* xr, const float* xi, float* yr,
    float* yi, size_t row, int log2_seg, const Twiddle& tw) {
  namespace cg = cooperative_groups;
  constexpr int K = 1 << LOG2K;
  // columns a thread takes at once: 16 points in flight whatever K is
  constexpr int M = K >= 16 ? 1 : 16 / K;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cols = 1 << (log2_seg - LOG2K);
  const int c_begin = rank * cols;
  const int step = static_cast<int>(blockDim.x);
  cluster.sync();
  for (int c0 = c_begin + threadIdx.x; c0 < c_begin + cols; c0 += M * step) {
    float re[M][K], im[M][K];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = c0 + m * step;
      if (c < c_begin + cols) {
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const size_t g = row + (static_cast<size_t>(t) << log2_seg) + c;
          re[m][t] = load_one<kLoad>(xr + g);
          im[m][t] = load_one<kLoad>(xi + g);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = c0 + m * step;
      if (c < c_begin + cols) {
        float wr[K], wi[K];
#pragma unroll
        for (int q = 0; q < LOG2K; ++q) {
#pragma unroll
          for (int jj = 0; jj < K / 2; ++jj) {
            if (jj < (1 << (LOG2K - q - 1))) {
              tw.row(q, (jj << log2_seg) + c, wr[tw_slot<LOG2K>(q, jj)],
                     wi[tw_slot<LOG2K>(q, jj)]);
            }
          }
        }
        dif_registers<LOG2K>(re[m], im[m], wr, wi);
        const int p = pad_index(c);
#pragma unroll
        for (int t = 0; t < K; ++t) {
          cluster.map_shared_rank(sr, t)[p] = re[m][t];
          cluster.map_shared_rank(si, t)[p] = im[m][t];
        }
      }
    }
  }
  cluster.sync();
  row_levels_radix<false, true, kLoad, kStore>(
      sr, si, xr, xi, yr, yi, row + (static_cast<size_t>(rank) << log2_seg),
      log2_seg, log2_seg, LOG2K, tw);
}

}  // namespace pifft
