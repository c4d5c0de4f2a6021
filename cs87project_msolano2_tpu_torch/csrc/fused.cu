// fused: a whole n-point pi-layout DIF transform, n = R * tile <= 2^20,
// in ONE launch whose intermediate carry stays in the card's L2, on an
// NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel cs87project_msolano2_tpu/ops/pallas_fft.py:
// _fused_fft_kernel (l.832), launched there by
// fft_pi_layout_pallas_fused (l.902, pallas_call l.966).
//
// What it computes.  Phase A: the first log2(R) DIF levels of the
// (R, tile) view in R x cb column blocks (cb = qb * 32 columns; the
// TPU's block was (R, qb, 128)), twiddles rebuilt from the separable factors
// of long_range_factors(R, tile).  Phase B: the tile-point DIF of each of
// the R rows (twiddle_tables(tile)).  The arithmetic is fourstep.cu's,
// level for level (fft_common.cuh).
//
// Design.  The TPU kept the whole 8 MB carry in VMEM scratch across a
// sequential grid, so the transform touched HBM once each way.  On
// Hopper 8 MB fits neither one block's 227 KB of shared memory nor a
// 16-block cluster's distributed shared memory (about 3.6 MB), but it
// fits the 50 MB L2.  So this is one persistent cooperative launch
// (launch_fused: grid = resident blocks, grid.sync() between the
// phases) whose carry is a SEPARATE buffer kept in L2:
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
//   - once every read of a carry row is done, each block discards its
//     segment's 128-byte lines from L2 (discard.global.L2): the carry is dead
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
// counter.
//
// Work items (the Hopper redesign).  The first design ran 1024-thread
// blocks, one per SM, over 64 work items a phase at n = 2^20, each item
// a radix-2 level per __syncthreads(): half the SMs idled and the level
// loop set the time.  Now both phases run fft_common.cuh's register
// radix loop (first pass from device memory, last pass to it, padded
// shared-memory planes between), in 256-thread blocks of about 34 KB
// and at most 128 registers a thread, two or more resident per SM:
//   - phase A: R x cb column blocks with cb down to 32 (512 items at
//     n = 2^20, cb = 32), radix-8 groups (an R = 64 block takes two
//     shared-memory passes instead of six);
//   - phase B: each tile row on a cluster of cw = 2^log2_cw blocks
//     (pifft::cluster_row_levels: the row's first log2(cw) levels across
//     the cluster through distributed shared memory, the rest in each
//     block), so 64 rows at cw = 4 are 256 blocks of 4096 points; cw = 1
//     runs a whole tile row in one block.
// The launch is still one cooperative launch (grid = the clusters the
// card holds at once, times cw), now with a cluster dimension beside the
// cooperative and access-policy attributes; a card that refuses the
// combination refuses the launch, which raises.
//
// bf16 storage (pifft_fused_bf16; the reference's storage="bfloat16",
// whose VMEM scratch carry is held at the storage dtype, l.975, phase A
// rounding into it at l.887).  The same kernel instantiated on
// __nv_bfloat16 planes, factors, tables and carry: every point is upcast
// once as it is read (x in phase A, the carry in phase B) and rounded
// once as it is written (the carry, y); levels, twiddles and shared
// memory stay float.  Every byte count follows the element type: the
// carry is 2 n sizeof(T) bytes (4 MB at 2^20 in bf16), and so are the
// carry-limit check, the persisting set-aside the launch asks for, and
// the access-policy window's num_bytes and hitRatio.  A 128-byte L2 line
// holds 128 / sizeof(T) values (64 in bf16), and the discard loop steps
// by that: at 32 values it would step 64 bytes, emit misaligned
// discards and reach past the block's segment into carry lines another
// block has not read yet.  A segment shorter than one line (bf16 at
// tile / cw = 32) discards nothing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// bytes of one L2 line, the unit discard.global.L2 drops
constexpr int kLineBytes = 128;

template <class T>
__device__ __forceinline__ void discard_l2_line(const T* p) {
  asm volatile("discard.global.L2 [%0], 128;" ::"l"(p) : "memory");
}

// floats of one plane of a block's shared memory: the larger of a
// padded R x cb phase-A block and a padded tile segment
__host__ __device__ __forceinline__ int plane_floats(int log2_r, int log2_cb,
                                                     int log2_seg) {
  const int a = pifft::padded_floats(1 << (log2_r + log2_cb));
  const int b = pifft::padded_floats(1 << log2_seg);
  return a > b ? a : b;
}

// The kernel's body for planes, carry, factors and tables stored as T
// (float, or __nv_bfloat16: upcast at load, rounded at store).
template <int LOG2CW, class T, class Twiddle>
__device__ __forceinline__ void fused_body(
    float* smem, const T* xr, const T* xi,  // may be y itself
    T* yr, T* yi,
    T* cr, T* ci,  // the carry: written and read here
    const Twiddle& tw, const T* __restrict__ twr,
    const T* __restrict__ twi, int log2_r, int log2_tile, int log2_cb) {
  // values of T in one L2 line
  constexpr int kLine = kLineBytes / static_cast<int>(sizeof(T));
  const int log2_seg = log2_tile - LOG2CW;
  float* sr = smem;
  float* si = smem + plane_floats(log2_r, log2_cb, log2_seg);
  const size_t tile = static_cast<size_t>(1) << log2_tile;

  // phase A: the long-range levels, one R x cb column block at a time,
  // from x (read once, evict-first) into the L2-resident carry
  const int col_blocks = 1 << (log2_tile - log2_cb);
  for (int b = blockIdx.x; b < col_blocks; b += gridDim.x) {
    const size_t c0 = static_cast<size_t>(b) << log2_cb;
    pifft::long_range_levels_radix<pifft::Load::kStreaming,
                                   pifft::Store::kGlobal>(
        sr, si, xr, xi, cr, ci, c0, tile, log2_r, log2_cb, tw);
  }

  cg::this_grid().sync();

  // phase B: the tile DIF of every carry row into y, each row on one
  // cluster of 2^LOG2CW blocks, block rank r ending with segment r
  const int rows = 1 << log2_r;
  const int clusters = gridDim.x >> LOG2CW;
  const size_t rank = LOG2CW ? cg::this_cluster().block_rank() : 0;
  const int lines = (1 << log2_seg) / kLine;
  const pifft::FlatTable<T> ftw{twr, twi, 1 << log2_tile};
  for (int r = blockIdx.x >> LOG2CW; r < rows; r += clusters) {
    const size_t row = static_cast<size_t>(r) << log2_tile;
    if constexpr (LOG2CW == 0) {
      pifft::row_levels_radix<true, true, pifft::Load::kCoherent,
                              pifft::Store::kStreaming>(
          sr, si, cr, ci, yr, yi, row, log2_tile, log2_tile, 0, ftw);
    } else {
      pifft::cluster_row_levels<LOG2CW, pifft::Load::kCoherent,
                                pifft::Store::kStreaming>(
          sr, si, cr, ci, yr, yi, row, log2_seg, ftw);
    }
    // every read of this row's carry is done (the first pass ended in
    // __syncthreads(), the cross-cluster levels in cluster.sync()): its
    // lines are dead, drop this block's segment from L2 without a
    // write-back
    const size_t seg = row + (rank << log2_seg);
    for (int i = threadIdx.x; i < lines; i += blockDim.x) {
      discard_l2_line(cr + seg + static_cast<size_t>(i) * kLine);
      discard_l2_line(ci + seg + static_cast<size_t>(i) * kLine);
    }
  }
}

// Two overloads: float planes, carry and tables, and the bf16 storage
// instantiation (bf16 planes, carry, factors and tables).
template <int LOG2CW>
__global__ void __launch_bounds__(kThreads, 2)
fused_kernel(const float* xr, const float* xi,  // may be y itself
             float* yr, float* yi,
             float* cr, float* ci,  // the carry: written and read here
             pifft::SeparableTwiddle tw,
             const float* __restrict__ twr, const float* __restrict__ twi,
             int log2_r, int log2_tile, int log2_cb) {
  extern __shared__ float smem[];
  fused_body<LOG2CW>(smem, xr, xi, yr, yi, cr, ci, tw, twr, twi, log2_r,
                     log2_tile, log2_cb);
}

template <int LOG2CW>
__global__ void __launch_bounds__(kThreads, 2)
fused_kernel(const __nv_bfloat16* xr, const __nv_bfloat16* xi,
             __nv_bfloat16* yr, __nv_bfloat16* yi, __nv_bfloat16* cr,
             __nv_bfloat16* ci, pifft::SeparableFactors<__nv_bfloat16> tw,
             const __nv_bfloat16* __restrict__ twr,
             const __nv_bfloat16* __restrict__ twi, int log2_r,
             int log2_tile, int log2_cb) {
  extern __shared__ float smem[];
  fused_body<LOG2CW>(smem, xr, xi, yr, yi, cr, ci, tw, twr, twi, log2_r,
                     log2_tile, log2_cb);
}

// fused_kernel<LOG2CW> for planes stored as T
template <int LOG2CW, class T, class Twiddle>
const void* kernel_for() {
  void (*kernel)(const T*, const T*, T*, T*, T*, T*, Twiddle, const T*,
                 const T*, int, int, int) = fused_kernel<LOG2CW>;
  return reinterpret_cast<const void*>(kernel);
}

// One cooperative launch of fused_kernel<LOG2CW> (for planes stored as
// T) with its access-policy
// window and, for cw > 1, its cluster dimension, all as attributes of
// this launch (cudaLaunchKernelExC).  The grid is what the card holds at
// once — blocks per SM times SMs for cw = 1, the most active clusters
// (cudaOccupancyMaxActiveClusters) times cw otherwise — capped at the
// larger phase's work.  A card that holds none is refused
// (cudaErrorCooperativeLaunchTooLarge), never run another way.
template <int LOG2CW, class T, class Twiddle>
cudaError_t launch_fused(void** args, int smem, long long col_blocks,
                         long long rows, int device, cudaStream_t stream,
                         const cudaAccessPolicyWindow& window) {
  const void* kernel = kernel_for<LOG2CW, T, Twiddle>();
  int coop = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[3];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeAccessPolicyWindow;
  attrs[1].val.accessPolicyWindow = window;
  attrs[2].id = cudaLaunchAttributeClusterDimension;
  attrs[2].val.clusterDim.x = 1u << LOG2CW;
  attrs[2].val.clusterDim.y = 1;
  attrs[2].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  long long work = rows << LOG2CW;
  if (col_blocks > work) work = col_blocks;
  // the resident grid of the last launch of this instantiation, reused
  // while the device and the shared memory stay the same: the occupancy
  // queries cost more host time than the launch itself
  static int cached_device = -1, cached_smem = -1;
  static long long cached_resident = 0;
  long long resident = 0;
  if (device == cached_device && smem == cached_smem) {
    resident = cached_resident;
  } else if constexpr (LOG2CW == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    resident = static_cast<long long>(per_sm) * sms;
  } else {
    int clusters = 0;
    config.gridDim = dim3(1u << LOG2CW);
    config.attrs = attrs + 2;
    config.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return err;
    resident = static_cast<long long>(clusters) << LOG2CW;
  }
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  cached_device = device;
  cached_smem = smem;
  cached_resident = resident;
  const long long blocks = work < resident ? work : resident;
  config.gridDim = dim3(static_cast<unsigned int>(blocks));
  config.attrs = attrs;
  config.numAttrs = LOG2CW ? 3 : 2;
  err = cudaLaunchKernelExC(&config, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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

namespace {

// The fused launch for planes, carry, factors and tables stored as T:
// the carry's 2 n values checked against the card's persisting-L2
// limit, the set-aside raised to them, the window laid over them, all
// in bytes of T.
template <class T, class Twiddle>
int launch(const T* xr, const T* xi, T* yr, T* yi, T* carry, Twiddle tw,
           const T* twr, const T* twi, int log2_r, int log2_tile,
           int log2_cb, int log2_cw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(1) << (log2_r + log2_tile);
  const size_t carry_bytes = 2 * n * sizeof(T);
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

  T* cr = carry;
  T* ci = carry + n;
  const int smem =
      2 * plane_floats(log2_r, log2_cb, log2_tile - log2_cw) *
      static_cast<int>(sizeof(float));
  const long long col_blocks = 1LL << (log2_tile - log2_cb);
  const long long rows = 1LL << log2_r;
  void* args[] = {&xr, &xi, &yr,  &yi,  &cr,     &ci,        &tw,
                  &twr, &twi, &log2_r, &log2_tile, &log2_cb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2_cw) {
    case 0: err = launch_fused<0, T, Twiddle>(args, smem, col_blocks, rows,
                                              device, s, window); break;
    case 1: err = launch_fused<1, T, Twiddle>(args, smem, col_blocks, rows,
                                              device, s, window); break;
    case 2: err = launch_fused<2, T, Twiddle>(args, smem, col_blocks, rows,
                                              device, s, window); break;
    case 3: err = launch_fused<3, T, Twiddle>(args, smem, col_blocks, rows,
                                              device, s, window); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// Launch the n = 2^log2_r * 2^log2_tile point transform of (xr, xi) into
// (yr, yi) (which may be (xr, xi) themselves) on `stream` (a
// cudaStream_t), through the carry buffer `carry` of 2 n floats (re then
// im): factors (ar, ai, br, bi) of long_range_factors(R, tile), tables
// (twr, twi) of flat_tables(tile), phase-A column blocks of 2^log2_cb,
// phase-B rows on clusters of 2^log2_cw blocks (0..3).  One cooperative
// launch; returns its cudaError_t (0 = success).  A carry larger than
// pifft_fused_carry_limit is refused (cudaErrorInvalidValue), never
// launched without its window.  Raises the device's persisting-L2
// set-aside to 2 n floats where it is smaller, and leaves it so.  The
// caller checks the blocking (ops/cuda_fft.py: fused_blocking) and that
// the planes and the carry are 16-byte aligned.
extern "C" int pifft_fused(const float* xr, const float* xi, float* yr,
                           float* yi, float* carry, const float* ar,
                           const float* ai, const float* br, const float* bi,
                           const float* twr, const float* twi, int log2_r,
                           int log2_tile, int log2_cb, int log2_cw,
                           int device, void* stream) {
  const pifft::SeparableTwiddle tw{
      {ar, ai, br, bi, static_cast<size_t>(1) << log2_tile}};
  return launch(xr, xi, yr, yi, carry, tw, twr, twi, log2_r, log2_tile,
                log2_cb, log2_cw, device, stream);
}

// The same transform on bf16 planes, factors (device_factors(R, tile,
// storage="bfloat16")), tables (flat_tables(tile, storage="bfloat16"))
// and carry (2 n bf16 values, 4 MB at n = 2^20): the bf16 storage
// instantiation.  The set-aside it raises, and its window, cover the
// carry's bytes; the planes and the carry are 8-byte aligned.
extern "C" int pifft_fused_bf16(
    const __nv_bfloat16* xr, const __nv_bfloat16* xi, __nv_bfloat16* yr,
    __nv_bfloat16* yi, __nv_bfloat16* carry, const __nv_bfloat16* ar,
    const __nv_bfloat16* ai, const __nv_bfloat16* br,
    const __nv_bfloat16* bi, const __nv_bfloat16* twr,
    const __nv_bfloat16* twi, int log2_r, int log2_tile, int log2_cb,
    int log2_cw, int device, void* stream) {
  const pifft::SeparableFactors<__nv_bfloat16> tw{
      ar, ai, br, bi, static_cast<size_t>(1) << log2_tile};
  return launch(xr, xi, yr, yi, carry, tw, twr, twi, log2_r, log2_tile,
                log2_cb, log2_cw, device, stream);
}
