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
// Precision.  The mode is the template parameter L, the number of bf16
// planes each operand is cut into by round-to-nearest-even (as
// ops/precision.bf16_split): the products of plane i of B and plane j of
// X run for i + j < L, so L = 1 is one pass (default), L = 2 three
// (split3: hi*hi + hi*lo + lo*hi), L = 3 six (highest / fp32: XLA's
// 6-pass split).  B reaches the kernel already cut: the wrapper passes
// the L bf16 planes of Br and Bi (twiddle.device_funnel_b_planes), laid
// out as the kernel's step tiles (twiddle.device_funnel_b_tiles, made
// once per card: each step's 64 x 16 slices of every plane contiguous),
// and -Bi is the Bi planes with the product's A scale set to -1
// (negating a bf16 value is exact).  The tensor cores add into
// their fp32 accumulator by truncation, so the hi*hi product and the
// smaller correction products accumulate apart, and the epilogue adds
// the two.
//
// Design.  One warpgroup (128 threads) a block, two blocks an SM, in a
// persistent grid of the blocks the card holds at once, each walking
// work units of 64 rows of Y by 64 columns (rows past R, when R < 64,
// are zero rows of B and are not stored).  A unit is R / 16 steps of
// wgmma.mma_async.m64n64k16 with fp32 accumulators in registers: Y's
// 64 x 64 block is M x N, K the 16 rows of X a step takes.  Both
// operands come from shared memory in wgmma's no-swizzle K-major layout
// (8 x 8 core matrices of 128 bytes): A, B's 64 x 16 slice of each plane
// of Br and Bi, as the step's tile of B, which lies contiguous in device
// memory in that layout; the other, X's 16 x 64 slice, cut into its L
// bf16 planes once a step by the block's own threads.  Every step
// issues the four real products of the complex one for each plane pair,
//     Yr += Br Xr + (-Bi) Xi,    Yi += Bi Xr + Br Xi,
// 4 L (L + 1) / 2 wgmma in all, and ends in wgmma.wait_group 0.  The
// inputs stream through a ring of kStages stages in shared memory:
// cp.async copies of the next two steps' X (float32) and B slices are
// in flight while a step is cut and multiplied, the steps running on
// from one unit into the block's next, so the epilogue of one unit
// overlaps the loads of the next.  Nothing of the prefetch sits in
// registers, which the four 64 x 64 accumulators (128 a thread) fill.
// The epilogue adds main and correction sums, rebuilds T for its
// elements (one A value a row, one B2 pair per row and column pair, B2
// laid out by twiddle.device_funnel_b2_tiles so that a warp's pairs are
// 512 contiguous bytes) and writes Y = (B @ X) * T, in the TPU body's
// order of operations.
//
// Bound.  Device memory: the planes once each way (16 bytes an element)
// plus B's planes, A and B2.  The products are 8 R flop per element per
// pass in bf16 on the tensor cores (3.2 GFLOP at R = 128, n = 2^20,
// split3: 3.3 us at the data-sheet peak, under the 5 us of the bytes;
// highest's 6.5 us is over them).  Each unit reads X's R x 64 block, so
// at R = 128 the two row units of a column block read it twice (the
// second read from L2), and every unit reads its 64 rows of B's planes
// and of B2 from L2: at n = 2^20 a step waits on what L2 delivers
// (PERF.md has the per-step trace), which is why B and B2 come as tiles
// whose every warp-wide read is whole 128-byte lines.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

// Build with -DPIFFT_MF_TRACE to have thread 0 of the first kTraceBlocks
// blocks note the card's clock (ns) at each phase of its first
// kTraceSteps steps and first two units (tools/mf_trace.py reads them
// through pifft_matmul_funnel_trace).  Off by default: then the kernel
// has no trace code at all.
#ifndef PIFFT_MF_TRACE
#define PIFFT_MF_TRACE 0
#endif

namespace {

constexpr int kTraceSteps = 16;
// per block: start, each traced step's data-ready and products-done, each
// of two units' epilogue start and end, end
constexpr int kTraceSlots = 2 + 2 * kTraceSteps + 4;
#if PIFFT_MF_TRACE
constexpr int kTraceBlocks = 64;
__device__ unsigned long long g_trace[kTraceBlocks][kTraceSlots];
#endif

__device__ __forceinline__ void trace(int slot) {
#if PIFFT_MF_TRACE
  if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_trace[blockIdx.x][slot] = t;
  }
#endif
}

// one warpgroup
constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 2;
// a work unit: rows of Y (wgmma's M) by columns (wgmma's N)
constexpr int kUnitRows = 64;
constexpr int kUnitCols = 64;
// rows of X one step contracts (wgmma's K)
constexpr int kStepK = 16;
constexpr int kLane = 128;
// uint4s of one 16 x 64 bf16 operand: 2 KB, one per thread
constexpr int kOperandVecs = kStepK * kUnitCols * 2 / 16;
// byte strides of the no-swizzle K-major operand between core matrices:
// along K (leading dimension) and along N (stride dimension)
constexpr uint32_t kLeadBytes = 8 * kUnitCols * 2;  // 1024
constexpr uint32_t kStrideBytes = 128;
constexpr int kMaxCards = 64;
// steps in the ring: the copies of the next kStages - 1 are in flight
constexpr int kStages = 3;

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The wgmma descriptor of an operand at p: start address, leading and
// stride byte offsets (16-byte units), no swizzle.
__device__ __forceinline__ uint64_t operand_desc(const void* p) {
  return static_cast<uint64_t>((smem_address(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLeadBytes >> 4) << 16) |
         (static_cast<uint64_t>(kStrideBytes >> 4) << 32);
}

// d (64 x 64, fp32) += kScaleA * the operand at a (64 x 16, bf16) @ the
// operand at b (16 x 64, bf16), both in shared memory, K-major.
template <int kScaleA>
__device__ __forceinline__ void wgmma_step(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, %35, %36, %37, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(kScaleA), "n"(1), "n"(0), "n"(0));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Make the generic-proxy stores of this thread to shared memory visible
// to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that a
// wgmma in flight owns across this point.
__device__ __forceinline__ void fence_acc(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// --- the copies of one step into its stage of the ring ------------------
//
// A stage holds one step's inputs as they arrive from device memory,
// copied with cp.async (16 bytes a copy, no registers): X's 16 rows of
// 64 columns, both planes, as float32 (xs[p][row][col]), and B's 64 x 16
// slice of every plane of Br and Bi, each already in wgmma's no-swizzle
// K-major layout (bs[m][s][k half][row][8 bf16]: core matrices 128
// bytes apart along M, 1024 along K, as X's operand).

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_address(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// floats of X in one stage; uint4s of B in one stage
constexpr int kStageXFloats = 2 * kStepK * kUnitCols;
template <int L>
__host__ __device__ constexpr int stage_b_vecs() {
  return 2 * L * kUnitRows * 2;
}
template <int L>
__host__ __device__ constexpr int stage_bytes() {
  return kStageXFloats * 4 + stage_b_vecs<L>() * 16;
}

// Issue the copies of the step at rows k0 of X and B's rows m0 .. (the
// unit at m0, c0) into the stage at xs (float32) and bs (uint4).  B's
// slices come from its tiles (bt), where each step's 2 L slices lie
// contiguous in the stage's layout, rows past R zero.
template <int L>
__device__ __forceinline__ void issue_step(float* xs, uint4* bs,
                                           const float* __restrict__ xr,
                                           const float* __restrict__ xi,
                                           const uint4* __restrict__ bt,
                                           int R, int C, int m0, int c0,
                                           int k0, int tid) {
  // X: 2 planes x 16 rows x 16 copies of 4 floats
#pragma unroll
  for (int i = 0; i < kStageXFloats / 4 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int p = c >> 8, row = (c >> 4) & 15, q = c & 15;
    const float* src = (p ? xi : xr) +
                       static_cast<size_t>(k0 + row) * C + c0 + 4 * q;
    cp_async16(xs + (p * kStepK + row) * kUnitCols + 4 * q, src);
  }
  // B: the step's 2 L slices, 64 rows x 2 halves each
  const uint4* src =
      bt + (static_cast<size_t>(m0 / kUnitRows) * (R / kStepK) + k0 / kStepK) *
               stage_b_vecs<L>();
#pragma unroll
  for (int i = 0; i < stage_b_vecs<L>() / kThreads; ++i) {
    const int c = tid + i * kThreads;
    cp_async16(bs + c, src + c);
  }
}

// Cut the thread's 8 rows of column c of each plane of the staged X
// (o = tid / 64, c = tid % 64: rows 8 o .. 8 o + 7) into L bf16 planes
// and store them as its 16-byte row of a core matrix: operand (p, s)
// (p = 0 for Xr, 1 for Xi; s the bf16 plane) at ops + (p * L + s) *
// kOperandVecs, the thread's row at uint4 tid = o * 64 + c (core matrix
// (c / 8, o), row c % 8).  A warp's 32 columns store 512 contiguous
// bytes.
template <int L>
__device__ __forceinline__ void store_planes(uint4* ops, const float* xs,
                                             int tid) {
  const int o = tid >> 6, c = tid & 63;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = xs[(p * kStepK + 8 * o + i) * kUnitCols + c];
    }
#pragma unroll
    for (int s = 0; s < L; ++s) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
        memcpy(&w[e], &h, sizeof(uint32_t));
        x[2 * e] -= __low2float(h);
        x[2 * e + 1] -= __high2float(h);
      }
      ops[(p * L + s) * kOperandVecs + tid] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// One step's products: the correction pairs (i + j = s, s = L - 1 .. 1)
// into corr, then hi * hi into acc; each the four real products.  B's
// slices at bs (Br's planes, then Bi's), X's operand at ops.
template <int L>
__device__ __forceinline__ void step_products(
    float (&acc_r)[32], float (&acc_i)[32], float (&corr_r)[32],
    float (&corr_i)[32], const uint4* bs, const uint4* ops) {
  auto br = [&](int i) { return operand_desc(bs + i * kOperandVecs); };
  auto bi = [&](int i) { return operand_desc(bs + (L + i) * kOperandVecs); };
#pragma unroll
  for (int s = L - 1; s >= 1; --s) {
#pragma unroll
    for (int i = 0; i <= s; ++i) {
      const uint64_t dr = operand_desc(ops + (s - i) * kOperandVecs);
      const uint64_t di = operand_desc(ops + (L + s - i) * kOperandVecs);
      wgmma_step<1>(corr_r, br(i), dr);
      wgmma_step<-1>(corr_r, bi(i), di);
      wgmma_step<1>(corr_i, bi(i), dr);
      wgmma_step<1>(corr_i, br(i), di);
    }
  }
  const uint64_t dr = operand_desc(ops);
  const uint64_t di = operand_desc(ops + L * kOperandVecs);
  wgmma_step<1>(acc_r, br(0), dr);
  wgmma_step<-1>(acc_r, bi(0), di);
  wgmma_step<1>(acc_i, bi(0), dr);
  wgmma_step<1>(acc_i, br(0), di);
}

// Y = (acc + corr) * T for the unit at rows m0.., columns c0..: element
// 4 j + 2 h + e of warp w, lane (g, t) is row 16 w + 8 h + g, column
// 8 j + 2 t + e of the unit.
__device__ __forceinline__ void epilogue(
    const float (&acc_r)[32], const float (&acc_i)[32],
    const float (&corr_r)[32], const float (&corr_i)[32],
    float* __restrict__ yr, float* __restrict__ yi,
    const float* __restrict__ ar, const float* __restrict__ ai,
    const float4* __restrict__ b2t, int R, int C, int m0, int c0, int warp,
    int lane) {
  if (m0 + 16 * warp >= R) return;
  const int g = lane >> 2, t = lane & 3;
  const int Q = C / kLane, q = c0 / kLane, l0 = c0 % kLane;
  // B2's tiles: the warp's (h, j) pairs of 32 lanes, contiguous
  const float4* w4 = b2t + (((m0 / kUnitRows) * 2 + l0 / kUnitCols) * 4 +
                            warp) * 2 * 8 * 32 + lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + 16 * warp + 8 * h + g;
    const float a_r = __ldg(ar + static_cast<size_t>(r) * Q + q);
    const float a_i = __ldg(ai + static_cast<size_t>(r) * Q + q);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // B2 at row r, columns l0 + 8 j + 2 t and the next: re, then im
      const float4 w = __ldg(w4 + (h * 8 + j) * 32);
      const float2 w_r = make_float2(w.x, w.y);
      const float2 w_i = make_float2(w.z, w.w);
      const float tr0 = a_r * w_r.x - a_i * w_i.x;
      const float ti0 = a_r * w_i.x + a_i * w_r.x;
      const float tr1 = a_r * w_r.y - a_i * w_i.y;
      const float ti1 = a_r * w_i.y + a_i * w_r.y;
      const int e = 4 * j + 2 * h;
      const float y_r0 = acc_r[e] + corr_r[e];
      const float y_i0 = acc_i[e] + corr_i[e];
      const float y_r1 = acc_r[e + 1] + corr_r[e + 1];
      const float y_i1 = acc_i[e + 1] + corr_i[e + 1];
      float2 zr, zi;
      zr.x = y_r0 * tr0 - y_i0 * ti0;
      zi.x = y_r0 * ti0 + y_i0 * tr0;
      zr.y = y_r1 * tr1 - y_i1 * ti1;
      zi.y = y_r1 * ti1 + y_i1 * tr1;
      const size_t o = static_cast<size_t>(r) * C + c0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(yr + o) = zr;
      *reinterpret_cast<float2*>(yi + o) = zi;
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    matmul_funnel_kernel(const float* __restrict__ xr,
                         const float* __restrict__ xi,
                         float* __restrict__ yr, float* __restrict__ yi,
                         const uint4* __restrict__ bt,
                         const float* __restrict__ ar,
                         const float* __restrict__ ai,
                         const float4* __restrict__ b2t, int R, int C) {
  // the wgmma operand (Xr planes, then Xi planes), then kStages stages
  extern __shared__ __align__(1024) uint4 smem[];
  uint4* ops = smem;
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(smem + 2 * L * kOperandVecs);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int steps = R / kStepK;
  const int row_units = (R + kUnitRows - 1) / kUnitRows;
  const int units = (C / kUnitCols) * row_units;
  if (static_cast<int>(blockIdx.x) >= units) return;
  trace(0);
  const int grid = static_cast<int>(gridDim.x);
  const int total =
      (units - static_cast<int>(blockIdx.x) + grid - 1) / grid * steps;
  auto stage_x = [&](int i) {
    return reinterpret_cast<float*>(ring + (i % kStages) * stage_bytes<L>());
  };
  auto stage_b = [&](int i) {
    return reinterpret_cast<uint4*>(ring + (i % kStages) * stage_bytes<L>() +
                                    kStageXFloats * 4);
  };
  // step i of this block: unit blockIdx.x + (i / steps) * grid, rows
  // (i % steps) * 16 of X
  auto issue = [&](int i) {
    if (i < total) {
      const int u = static_cast<int>(blockIdx.x) + i / steps * grid;
      issue_step<L>(stage_x(i), stage_b(i), xr, xi, bt, R, C,
                    (u % row_units) * kUnitRows, (u / row_units) * kUnitCols,
                    (i % steps) * kStepK, tid);
    }
    cp_async_commit();
  };
  float acc_r[32], acc_i[32], corr_r[32], corr_i[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc_r[i] = acc_i[i] = corr_r[i] = corr_i[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0; i < total; ++i) {
    // the copies of step i + kStages - 1 go into the stage step i - 1
    // read, which every thread left before the last __syncthreads()
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (i < kTraceSteps) trace(1 + 2 * i);
    // step i's X cut into the operand, whose last reader (step i - 1's
    // wgmma) every warp waited for
    store_planes<L>(ops, stage_x(i), tid);
    fence_async_shared();
    __syncthreads();
    fence_acc(acc_r);
    fence_acc(acc_i);
    if constexpr (L > 1) {
      fence_acc(corr_r);
      fence_acc(corr_i);
    }
    wgmma_fence();
    step_products<L>(acc_r, acc_i, corr_r, corr_i, stage_b(i), ops);
    wgmma_commit();
    wgmma_wait_all();
    if (i < kTraceSteps) trace(2 + 2 * i);
    fence_acc(acc_r);
    fence_acc(acc_i);
    if constexpr (L > 1) {
      fence_acc(corr_r);
      fence_acc(corr_i);
    }
    if (i % steps == steps - 1) {
      // the unit is complete; the next steps' copies are in flight
      const int u = static_cast<int>(blockIdx.x) + i / steps * grid;
      const int unit = i / steps;
      if (unit < 2) trace(1 + 2 * kTraceSteps + 2 * unit);
      epilogue(acc_r, acc_i, corr_r, corr_i, yr, yi, ar, ai, b2t, R, C,
               (u % row_units) * kUnitRows, (u / row_units) * kUnitCols,
               warp, lane);
      if (unit < 2) trace(2 + 2 * kTraceSteps + 2 * unit);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        acc_r[j] = acc_i[j] = corr_r[j] = corr_i[j] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
  trace(kTraceSlots - 1);
}

// dynamic shared memory of matmul_funnel_kernel<L>
template <int L>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * L * kOperandVecs * 16 + kStages * stage_bytes<L>();
}

// The persistent grid of matmul_funnel_kernel<L> on `device`: the blocks
// the card holds at once (occupancy x SMs), asked once per card.
template <int L>
cudaError_t resident_blocks(int device, long long& blocks) {
  static long long known[kMaxCards] = {};
  const bool tracked = device >= 0 && device < kMaxCards;
  if (tracked && known[device] > 0) {
    blocks = known[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(matmul_funnel_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<L>());
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, matmul_funnel_kernel<L>, kThreads, smem_bytes<L>());
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = static_cast<long long>(per_sm) * sms;
  if (tracked) known[device] = blocks;
  return cudaSuccess;
}

cudaError_t resident_blocks_for(int levels, int device, long long& blocks) {
  switch (levels) {
    case 1:
      return resident_blocks<1>(device, blocks);
    case 2:
      return resident_blocks<2>(device, blocks);
    case 3:
      return resident_blocks<3>(device, blocks);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int L>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           const uint4* bt, const float* ar, const float* ai,
           const float4* b2t, int R, int C, int device,
           cudaStream_t stream) {
  long long blocks = 0;
  const cudaError_t err = resident_blocks<L>(device, blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long units = static_cast<long long>(C / kUnitCols) *
                          ((R + kUnitRows - 1) / kUnitRows);
  if (units < blocks) blocks = units;
  matmul_funnel_kernel<L><<<static_cast<unsigned int>(blocks), kThreads,
                            smem_bytes<L>(), stream>>>(
      xr, xi, yr, yi, bt, ar, ai, b2t, R, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the funnel on the (2^log2_r, C) planes (xr, xi), writing
// (yr, yi), on `stream` (a cudaStream_t).  bt: the `levels` bf16 planes
// of dft_funnel_b(R), Br's and Bi's, in the kernel's step tiles
// (twiddle.device_funnel_b_tiles); (ar, ai, b2t): dft_funnel_factors(R,
// n), A (R, C / 128) and B2 (R, 128) in the epilogue's tiles
// (twiddle.device_funnel_b2_tiles); `levels`: the bf16 planes per
// operand (1, 2 or 3).  The caller checks 16 <= R and 128 | C.  Returns
// the cudaError_t of the launch: 0 = success.
extern "C" int pifft_matmul_funnel(const float* xr, const float* xi,
                                   float* yr, float* yi, const void* bt,
                                   const float* ar, const float* ai,
                                   const void* b2t, int log2_r, int C,
                                   int levels, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int R = 1 << log2_r;
  const auto* t = static_cast<const uint4*>(bt);
  const auto* w = static_cast<const float4*>(b2t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (levels) {
    case 1:
      return launch<1>(xr, xi, yr, yi, t, ar, ai, w, R, C, device,
                       s);
    case 2:
      return launch<2>(xr, xi, yr, yi, t, ar, ai, w, R, C, device,
                       s);
    case 3:
      return launch<3>(xr, xi, yr, yi, t, ar, ai, w, R, C, device,
                       s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The persistent grid the funnel launches with `levels` bf16 planes on
// `device`: the blocks the card holds at once; a negative cudaError_t
// if the card cannot be asked.
extern "C" long long pifft_matmul_funnel_resident_blocks(int device,
                                                         int levels) {
  cudaError_t err = cudaSetDevice(device);
  long long blocks = 0;
  if (err == cudaSuccess) err = resident_blocks_for(levels, device, blocks);
  return err == cudaSuccess ? blocks : -static_cast<long long>(err);
}

// Copy the trace of the last launch (kTraceBlocks x kTraceSlots
// unsigned 64-bit clock readings, ns; 0 where nothing was noted) to the
// host buffer `out`.  Returns the cudaError_t: cudaErrorNotSupported
// unless the library was built with -DPIFFT_MF_TRACE=1.
extern "C" int pifft_matmul_funnel_trace(void* out) {
#if PIFFT_MF_TRACE
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace)));
#else
  (void)out;
  return static_cast<int>(cudaErrorNotSupported);
#endif
}
