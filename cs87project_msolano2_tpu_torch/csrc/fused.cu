// fused: a whole n-point pi-layout DIF transform, n = R * tile <= 2^20,
// in ONE launch whose intermediate carry stays in the card's L2, on an
// NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel cs87project_msolano2_tpu/ops/pallas_fft.py:
// _fused_fft_kernel (l.832), launched there by
// fft_pi_layout_pallas_fused (l.902, pallas_call l.966).
//
// What it computes.  Phase A: the first log2(R) DIF levels of the
// (R, tile) view in R x cb column blocks (cb = qb * 128 columns, the
// TPU's (R, qb, 128) block), twiddles rebuilt from the separable factors
// of long_range_factors(R, tile).  Phase B: the tile-point DIF of each of
// the R rows (twiddle_tables(tile)).  The arithmetic is fourstep.cu's,
// level for level (fft_common.cuh).
//
// Design.  The TPU kept the whole 8 MB carry in VMEM scratch across a
// sequential grid, so the transform touched HBM once each way.  On
// Hopper 8 MB fits neither one block's 227 KB of shared memory nor a
// 16-block cluster's distributed shared memory (about 3.6 MB), but it
// fits the 50 MB L2.  So this is one persistent cooperative launch
// (pifft::launch_cooperative: grid = resident blocks, grid.sync()
// between the phases) whose carry is a SEPARATE buffer kept in L2:
//   - the launch carries an access-policy window over the carry with
//     cudaAccessPropertyPersisting hits, as its own launch attribute
//     (cudaLaunchKernelExC), so the policy covers this launch only and
//     never stays on PyTorch's stream;
//   - the L2 set-aside for persisting lines (cudaLimitPersistingL2-
//     CacheSize) is device state, not launch state: the first launch
//     raises it to the carry's size where it is smaller, and it stays
//     so for every later kernel until the wrapper (ops/cuda_fft.py)
//     puts back, at process exit, the value it read before its first
//     launch.  Lines that are not persisting may use the set-aside
//     while no persisting line holds it (CUDA's rule for the L2
//     set-aside), and none does between launches (below).
//     chip_smoke.py reads rql's device time at n = 2^20 with no
//     set-aside and after the first fused launch;
//   - x is read evict-first (ld.global.cs) and y written evict-first
//     (st.global.cs), so neither pushes the carry out;
//   - phase A writes the carry with st.global.cg (cached in L2), phase B
//     reads it back with ld.global.cg: other blocks wrote it earlier in
//     this launch, so it is never read through the read-only or L1 path,
//     and the carry pointers are not __restrict__;
//   - once a block holds its carry row in shared memory it discards the
//     row's 128-byte lines from L2 (discard.global.L2): the carry is dead
//     by then, so its dirty lines are never written back to device
//     memory and no persisting line outlives the launch.  That is the
//     stream-ordered counterpart of cudaCtxResetPersistingL2Cache, which
//     takes effect when it returns and so would race a kernel still
//     running on the stream.
// fourstep.cu's carry is the output buffer itself, which its phase B
// reads back from device memory; this kernel's carry never needs to
// reach it.  With alias_io the wrapper passes y = x: phase A has read all
// of x before grid.sync(), and phase B alone writes y, so the launch
// needs no output buffer; x and y are therefore not __restrict__.
//
// Bound.  Device memory: x read once and y written once, 16 bytes per
// element, plus the factors and tables; about 11 flop per element per
// long-range level and 5 per tile level, some 140 flop per element at
// n = 2^20, under 9 flop per byte: below the card's fp32 ridge of about
// 20.  With the carry in L2 the design reaches for that floor (the
// reference's carry-free roofline ceiling, utils/roofline.py); whether
// the carry stayed in L2 is not observable without a memory-traffic
// counter.  Not done yet: more than one block per SM (R = 64 work items
// per phase at n = 2^20 leave half the 132 SMs idle) and cp.async
// prefetch under compute.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
// floats in one 128-byte L2 line
constexpr int kLineFloats = 32;

__device__ __forceinline__ void discard_l2_line(const float* p) {
  asm volatile("discard.global.L2 [%0], 128;" ::"l"(p) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
fused_kernel(const float* xr, const float* xi,  // may be y itself
             float* yr, float* yi,
             float* cr, float* ci,  // the carry: written and read here
             pifft::SeparableTwiddle tw,
             const float* __restrict__ twr, const float* __restrict__ twi,
             int log2_r, int log2_tile, int log2_cb) {
  extern __shared__ float smem[];
  const int half_smem = max(1 << (log2_r + log2_cb), 1 << log2_tile);
  float* sr = smem;
  float* si = smem + half_smem;
  const size_t tile = static_cast<size_t>(1) << log2_tile;

  // phase A: the long-range levels, one R x cb column block at a time,
  // from x (read once, evict-first) into the L2-resident carry
  const int col_blocks = 1 << (log2_tile - log2_cb);
  for (int b = blockIdx.x; b < col_blocks; b += gridDim.x) {
    const size_t c0 = static_cast<size_t>(b) << log2_cb;
    pifft::load_block<pifft::Load::kStreaming>(sr, si, xr, xi, c0, tile,
                                               log2_r, log2_cb);
    pifft::long_range_levels(sr, si, log2_r, log2_cb, tw, c0);
    pifft::store_block<pifft::Store::kGlobal>(cr, ci, sr, si, c0, tile,
                                              log2_r, log2_cb);
  }

  cg::this_grid().sync();

  // phase B: the tile DIF of every carry row into y
  const int rows = 1 << log2_r;
  const int lines = (1 << log2_tile) / kLineFloats;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const size_t base = static_cast<size_t>(r) << log2_tile;
    pifft::load_block<pifft::Load::kCoherent>(sr, si, cr, ci, base, 0, 0,
                                              log2_tile);
    // the row is staged (load_block ends in __syncthreads): its carry
    // lines are dead, drop them from L2 without a write-back
    for (int i = threadIdx.x; i < lines; i += blockDim.x) {
      discard_l2_line(cr + base + static_cast<size_t>(i) * kLineFloats);
      discard_l2_line(ci + base + static_cast<size_t>(i) * kLineFloats);
    }
    pifft::tile_levels(sr, si, log2_tile, twr, twi);
    pifft::store_block<pifft::Store::kStreaming>(yr, yi, sr, si, base, 0, 0,
                                                 log2_tile);
  }
}

}  // namespace

// The largest carry, in bytes, the card can hold as persisting L2 lines
// (cudaDevAttrMaxPersistingL2CacheSize), capped at the largest
// access-policy window (cudaDevAttrMaxAccessPolicyWindowSize); 0 where
// the card has neither.  A negative value is a cudaError_t, negated.
extern "C" long long pifft_fused_carry_limit(int device) {
  int persist = 0, window = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&persist, cudaDevAttrMaxPersistingL2CacheSize,
                             device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  err = cudaDeviceGetAttribute(&window, cudaDevAttrMaxAccessPolicyWindowSize,
                               device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return persist < window ? persist : window;
}

// The device's current L2 set-aside for persisting lines, in bytes
// (cudaLimitPersistingL2CacheSize).  A negative value is a
// cudaError_t, negated.
extern "C" long long pifft_persisting_l2_set_aside(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  size_t limit = 0;
  err = cudaDeviceGetLimit(&limit, cudaLimitPersistingL2CacheSize);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(limit);
}

// Set the device's L2 set-aside for persisting lines to `bytes` (the
// runtime rounds it up to its granularity); returns its cudaError_t.
extern "C" int pifft_set_persisting_l2_set_aside(int device,
                                                 long long bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceSetLimit(
      cudaLimitPersistingL2CacheSize, static_cast<size_t>(bytes)));
}

// Launch the n = 2^log2_r * 2^log2_tile point transform of (xr, xi) into
// (yr, yi) (which may be (xr, xi) themselves) on `stream` (a
// cudaStream_t), through the carry buffer `carry` of 2 n floats (re then
// im): factors (ar, ai, br, bi) of long_range_factors(R, tile), tables
// (twr, twi) of flat_tables(tile), phase-A column blocks of 2^log2_cb.
// One cooperative launch; returns its cudaError_t (0 = success).  A
// carry larger than pifft_fused_carry_limit is refused
// (cudaErrorInvalidValue), never launched without its window.  Raises
// the device's persisting-L2 set-aside to 2 n floats where it is
// smaller, and leaves it so.
extern "C" int pifft_fused(const float* xr, const float* xi, float* yr,
                           float* yi, float* carry, const float* ar,
                           const float* ai, const float* br, const float* bi,
                           const float* twr, const float* twi, int log2_r,
                           int log2_tile, int log2_cb, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(1) << (log2_r + log2_tile);
  const size_t carry_bytes = 2 * n * sizeof(float);
  const long long cap = pifft_fused_carry_limit(device);
  if (cap < 0) return static_cast<int>(-cap);
  if (static_cast<long long>(carry_bytes) > cap) return cudaErrorInvalidValue;
  size_t limit = 0;
  err = cudaDeviceGetLimit(&limit, cudaLimitPersistingL2CacheSize);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (limit < carry_bytes) {
    err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, carry_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetLimit(&limit, cudaLimitPersistingL2CacheSize);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaAccessPolicyWindow window = {};
  window.base_ptr = carry;
  window.num_bytes = carry_bytes;
  window.hitRatio = limit >= carry_bytes
                        ? 1.0f
                        : static_cast<float>(limit) /
                              static_cast<float>(carry_bytes);
  window.hitProp = cudaAccessPropertyPersisting;
  window.missProp = cudaAccessPropertyStreaming;

  float* cr = carry;
  float* ci = carry + n;
  pifft::SeparableTwiddle tw{ar, ai, br, bi,
                             static_cast<size_t>(1) << log2_tile};
  const int lr = 1 << (log2_r + log2_cb);
  const int tile = 1 << log2_tile;
  const int half = lr > tile ? lr : tile;  // floats per plane
  const int smem = 2 * half * static_cast<int>(sizeof(float));
  const long long col_blocks = 1LL << (log2_tile - log2_cb);
  const long long rows = 1LL << log2_r;
  void* args[] = {&xr, &xi, &yr,  &yi,  &cr,     &ci,        &tw,
                  &twr, &twi, &log2_r, &log2_tile, &log2_cb};
  return static_cast<int>(pifft::launch_cooperative(
      reinterpret_cast<const void*>(fused_kernel), kThreads, smem,
      col_blocks > rows ? col_blocks : rows, args, device, stream, &window));
}
