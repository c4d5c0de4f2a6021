// matmul_funnel: the first log2(R) DIF levels of an n-point transform
// as one R-point DFT matrix product on the tensor cores, then the
// twiddle grid, on an NVIDIA Hopper card (sm_90a).  On the (R, C) view
// of the planes (C = n / R) it computes Y = (B @ X) * T, B the (R, R)
// bit-reversed DFT matrix of dft_funnel_b(R) and T[r, q * 128 + l] =
// A[r, q] * B2[r, l] the twiddle grid rebuilt from the separable factors
// of dft_funnel_factors(R, n).  The ladder's mf variant runs it, then
// the tile kernel on the R rows of C points.
//
// Replaces the TPU kernel cs87project_msolano2_tpu/ops/pallas_fft.py:
// _matmul_funnel_kernel (l.1915), launched there by
// fft_pi_layout_pallas_mf (l.1970, pallas_call l.2048).
//
// Design.  A block owns cb columns of the (R, C) view (cb a multiple of
// 64).  It stages its X block in shared memory as float32, column by
// column with the row index contiguous ((2R + 8) floats a column: Xr's R
// rows, then Xi's, then 8 floats of padding so that the fragment reads
// below hit 16 distinct banks), which is the K-major order the B operand
// of mma.sync wants.  Each of 8 warps then takes work items of 16 rows
// by 64 columns: for every 16-row step k0 of the contraction it reads
// the A fragments of Br and Bi (rows m0..m0+15, columns k0..k0+15) from
// device memory, where the 2 R^2 floats of B stay in L2 for every block,
// and the B fragments of Xr and Xi from shared memory, and issues
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 for the four real
// products of the complex one:
//     Yr += Br Xr + (-Bi) Xi,    Yi += Bi Xr + Br Xi
// each accumulating in float32 registers.  The precision mode is the
// template parameter L, the number of bf16 planes each operand is cut
// into by round-to-nearest-even (__float2bfloat16_rn, as
// ops/precision.bf16_split): the products of plane i of B and plane j
// of X run for i + j < L, so L = 1 is one pass (default), L = 2 three
// (split3: hi*hi + hi*lo + lo*hi), L = 3 six (highest / fp32: XLA's
// 6-pass split).  The hi*hi product and the smaller correction
// products accumulate apart.  The epilogue adds the two, rebuilds T for
// the thread's accumulator elements by one complex multiply of A and B2
// and writes Y = (B @ X) * T, in the TPU body's order of operations.
//
// Bound.  Device memory: the planes once each way (16 bytes an element)
// plus B, A and B2.  The products are 8 R flop per element per pass in
// bf16 on the tensor cores (3.2 GFLOP at R = 128, n = 2^20, split3:
// 3.3 us at the data-sheet peak, under the 5 us of the bytes), so bytes
// over HBM bandwidth is the floor.  This first kernel is simple rather
// than fast: mma.sync rather than wgmma, A fragments from L2 rather than
// TMA-fed shared memory, 8 warps a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// n-tiles of 8 columns per work item: 64 columns
constexpr int kNTiles = 8;
constexpr int kItemCols = 8 * kNTiles;
constexpr int kLane = 128;
// floats of padding per staged column (see the design note)
constexpr int kPad = 8;

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Cut the pair (x0, x1) into L bf16 planes, each packed into one .b32
// register with x0's half low, as mma.sync's fragments hold them.
template <int L>
__device__ __forceinline__ void split_pair(float x0, float x1,
                                           uint32_t* out) {
#pragma unroll
  for (int s = 0; s < L; ++s) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    memcpy(&out[s], &h, sizeof(uint32_t));
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

// The A fragment (16 x 16, row-major) of rows m0.. and columns k0.. of
// the (R, R) float32 matrix b, cut into L planes: frag[s][i] is register
// i of plane s (rows g and g + 8, columns 2t and 2t + 8 of the tile;
// g = lane / 4, t = lane % 4).
template <int L>
__device__ __forceinline__ void load_a(const float* __restrict__ b, int R,
                                       int m0, int k0, int lane,
                                       uint32_t (&frag)[L][4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = b + static_cast<size_t>(m0 + g) * R + k0 + 2 * t;
  const float2 v[4] = {
      __ldg(reinterpret_cast<const float2*>(p)),
      __ldg(reinterpret_cast<const float2*>(p + 8 * R)),
      __ldg(reinterpret_cast<const float2*>(p + 8)),
      __ldg(reinterpret_cast<const float2*>(p + 8 * R + 8))};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t planes[L];
    split_pair<L>(v[i].x, v[i].y, planes);
#pragma unroll
    for (int s = 0; s < L; ++s) frag[s][i] = planes[s];
  }
}

// The B fragment (16 x 8, K-major) of rows k0.. of the staged column
// `col` (xs points at its first float), cut into L planes.
template <int L>
__device__ __forceinline__ void load_b(const float* xs, int k0, int lane,
                                       uint32_t (&frag)[L][2]) {
  const int t = lane & 3;
  const float2 lo = *reinterpret_cast<const float2*>(xs + k0 + 2 * t);
  const float2 hi = *reinterpret_cast<const float2*>(xs + k0 + 2 * t + 8);
  uint32_t p0[L], p1[L];
  split_pair<L>(lo.x, lo.y, p0);
  split_pair<L>(hi.x, hi.y, p1);
#pragma unroll
  for (int s = 0; s < L; ++s) {
    frag[s][0] = p0[s];
    frag[s][1] = p1[s];
  }
}

// acc += a[0] b[0], and corr += the correction products a[i] b[j] for
// 0 < i + j < L, smallest first.  The tensor cores add into their fp32
// accumulator by truncation, so each add into the large main sum costs
// about one unit in its last place; the corrections, 2^-8 of it and
// smaller, keep their own accumulator, and the main sum takes as many
// adds in every mode.
template <int L>
__device__ __forceinline__ void passes(float (&acc)[4], float (&corr)[4],
                                       const uint32_t (&a)[L][4],
                                       const uint32_t (&b)[L][2]) {
#pragma unroll
  for (int s = L - 1; s >= 1; --s) {
#pragma unroll
    for (int i = 0; i <= s; ++i) mma_bf16(corr, a[i], b[s - i]);
  }
  mma_bf16(acc, a[0], b[0]);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    matmul_funnel_kernel(const float* __restrict__ xr,
                         const float* __restrict__ xi,
                         float* __restrict__ yr, float* __restrict__ yi,
                         const float* __restrict__ br,
                         const float* __restrict__ bi,
                         const float* __restrict__ ar,
                         const float* __restrict__ ai,
                         const float* __restrict__ b2r,
                         const float* __restrict__ b2i, int R, int C,
                         int cb) {
  extern __shared__ float xs[];
  const int stride = 2 * R + kPad;  // floats per staged column
  const int c0 = blockIdx.x * cb;
  const int tid = threadIdx.x;

  // Stage the R x cb block of Xr and Xi column-major.  A warp reads
  // rows 2kp and 2kp + 1 for four kp and eight neighbouring columns
  // (whole 32-byte sectors) and writes each (row 2kp, row 2kp + 1) pair
  // of a column as one float2.
  const int col_groups = cb >> 3;
  for (int idx = tid; idx < cb * R; idx += kThreads) {
    const int w = idx >> 5, ln = idx & 31;
    const int c = (w % col_groups) * 8 + (ln & 7);
    const int k = 2 * ((w / col_groups) * 4 + (ln >> 3));  // 0 <= k < 2R
    const float* src = k < R ? xr + static_cast<size_t>(k) * C
                             : xi + static_cast<size_t>(k - R) * C;
    float2 v;
    v.x = __ldg(src + c0 + c);
    v.y = __ldg(src + C + c0 + c);
    *reinterpret_cast<float2*>(xs + c * stride + k) = v;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int items = (R >> 4) * (cb / kItemCols);
  const int Q = C / kLane;
  for (int item = warp; item < items; item += kWarps) {
    const int m0 = (item / (cb / kItemCols)) * 16;
    const int n0 = (item % (cb / kItemCols)) * kItemCols;
    float acc_r[kNTiles][4] = {}, acc_i[kNTiles][4] = {};
    float corr_r[kNTiles][4] = {}, corr_i[kNTiles][4] = {};
    for (int k0 = 0; k0 < R; k0 += 16) {
      uint32_t a_br[L][4], a_bi[L][4], a_nbi[L][4];
      load_a<L>(br, R, m0, k0, lane, a_br);
      load_a<L>(bi, R, m0, k0, lane, a_bi);
#pragma unroll
      for (int s = 0; s < L; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a_nbi[s][i] = a_bi[s][i] ^ 0x80008000u;
      }
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const float* col = xs + (n0 + 8 * nt + g) * stride;
        uint32_t b_xr[L][2], b_xi[L][2];
        load_b<L>(col, k0, lane, b_xr);
        load_b<L>(col + R, k0, lane, b_xi);
        passes<L>(acc_r[nt], corr_r[nt], a_br, b_xr);
        passes<L>(acc_r[nt], corr_r[nt], a_nbi, b_xi);
        passes<L>(acc_i[nt], corr_i[nt], a_bi, b_xr);
        passes<L>(acc_i[nt], corr_i[nt], a_br, b_xi);
      }
    }
    // epilogue: Y = (B @ X) * T, T rebuilt from A (R, Q) and B2 (R, 128)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const int c = c0 + n0 + 8 * nt + 2 * t;  // even: c, c + 1 share q
      const int q = c / kLane, l = c % kLane;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + g + 8 * h;
        const float a_r = __ldg(ar + static_cast<size_t>(r) * Q + q);
        const float a_i = __ldg(ai + static_cast<size_t>(r) * Q + q);
        const float2 w_r =
            __ldg(reinterpret_cast<const float2*>(b2r + r * kLane + l));
        const float2 w_i =
            __ldg(reinterpret_cast<const float2*>(b2i + r * kLane + l));
        const float tr0 = a_r * w_r.x - a_i * w_i.x;
        const float ti0 = a_r * w_i.x + a_i * w_r.x;
        const float tr1 = a_r * w_r.y - a_i * w_i.y;
        const float ti1 = a_r * w_i.y + a_i * w_r.y;
        const float y_r0 = acc_r[nt][2 * h] + corr_r[nt][2 * h];
        const float y_i0 = acc_i[nt][2 * h] + corr_i[nt][2 * h];
        const float y_r1 = acc_r[nt][2 * h + 1] + corr_r[nt][2 * h + 1];
        const float y_i1 = acc_i[nt][2 * h + 1] + corr_i[nt][2 * h + 1];
        float2 zr, zi;
        zr.x = y_r0 * tr0 - y_i0 * ti0;
        zi.x = y_r0 * ti0 + y_i0 * tr0;
        zr.y = y_r1 * tr1 - y_i1 * ti1;
        zi.y = y_r1 * ti1 + y_i1 * tr1;
        const size_t o = static_cast<size_t>(r) * C + c;
        *reinterpret_cast<float2*>(yr + o) = zr;
        *reinterpret_cast<float2*>(yi + o) = zi;
      }
    }
  }
}

template <int L>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           const float* br, const float* bi, const float* ar,
           const float* ai, const float* b2r, const float* b2i, int R, int C,
           int cb, cudaStream_t stream) {
  const int smem = cb * (2 * R + kPad) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      matmul_funnel_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  matmul_funnel_kernel<L><<<C / cb, kThreads, smem, stream>>>(
      xr, xi, yr, yi, br, bi, ar, ai, b2r, b2i, R, C, cb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the funnel on the (2^log2_r, C) planes (xr, xi) in column
// blocks of 2^log2_cb, writing (yr, yi), on `stream` (a cudaStream_t).
// (br, bi): dft_funnel_b(R), (R, R); (ar, ai, b2r, b2i):
// dft_funnel_factors(R, n), A (R, C / 128) and B2 (R, 128); `levels`:
// the bf16 planes per operand (1, 2 or 3).  The caller checks 16 <= R,
// 64 | cb | C, 128 | C and the shared-memory budget.  Returns the
// cudaError_t of the launch: 0 = success.
extern "C" int pifft_matmul_funnel(const float* xr, const float* xi,
                                   float* yr, float* yi, const float* br,
                                   const float* bi, const float* ar,
                                   const float* ai, const float* b2r,
                                   const float* b2i, int log2_r, int C,
                                   int log2_cb, int levels, int device,
                                   void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = 1 << log2_r, cb = 1 << log2_cb;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (levels) {
    case 1:
      return launch<1>(xr, xi, yr, yi, br, bi, ar, ai, b2r, b2i, R, C, cb,
                       s);
    case 2:
      return launch<2>(xr, xi, yr, yi, br, bi, ar, ai, b2r, b2i, R, C, cb,
                       s);
    case 3:
      return launch<3>(xr, xi, yr, yi, br, bi, ar, ai, b2r, b2i, R, C, cb,
                       s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
