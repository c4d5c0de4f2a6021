// sixstep: a whole n-point pi-layout DIF transform, n = R1 * R2 * tile,
// in ONE launch on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel cs87project_msolano2_tpu/ops/pallas_fft.py:
// _sixstep_kernel (l.1354), launched there by
// fft_pi_layout_pallas_sixstep (l.1664, pallas_call l.1816).
//
// What it computes.  Three phases of DIF levels, m = R2 * tile:
//   A   the outer log2(R1) levels on the (R1, m) view, in R1 x cb1
//       column blocks, twiddles from long_range_factors(R1, m) (or the
//       dense tables of dense_long_range_tables(R1, m): the
//       reference's separable=False, a twiddle source of
//       fft_common.cuh picked at compile time);
//   B1  for each of the R1 groups (one m-point sub-transform each), the
//       inner log2(R2) levels on its (R2, tile) view, in R2 x cb2 column
//       blocks, twiddles from long_range_factors(R2, tile) (or
//       dense_long_range_tables(R2, tile)): level l of
//       the n-point plan inside a group is level l - log2(R1) of the
//       m-point plan;
//   B2  the tile-point DIF of all R1 * R2 rows (twiddle_tables(tile)).
// The long-range blocks are max(R1, R2) rows tall instead of R = R1 R2,
// so a block keeps whole 32-byte sectors of each row (cb >= 8) at any n
// that fits the card, where fourstep's R x cb block would not.
//
// Design.  The TPU walked A, then group after group of B1 and B2, as
// one sequential grid with two HBM carries and double-buffered DMA.
// Hopper blocks run in no order, so here one persistent cooperative
// launch (grid = the blocks the card holds at once) walks each phase's
// work items in a strided loop, with cg::this_grid().sync() between
// phases.  The carry is the output buffer (2 x 4 n bytes: 1 GB at
// n = 2^27, far past the 50 MB L2): A writes it, B1 updates its own
// R2 x cb2 slice in place, B2 rewrites each row in place.  Carry reads go
// through L2 (ld.global.cg), never the read-only path, because other
// blocks wrote them earlier in this launch; the carry pointers are not
// __restrict__.  Offsets are 64-bit: at n = 2^27 a group index times m
// nears the int32 range.
//
// The Hopper redesign (fused.cu's design carried to three phases).  The
// first design ran 1024-thread blocks of up to 128 KB, one per SM, each
// loading its block, running one radix-2 level per __syncthreads() and
// storing it, in series.  Now every phase runs fft_common.cuh's register
// radix loop in 256-thread blocks of about 34 KB and at most 128
// registers a thread, two or more resident on each SM, so one block's
// device-memory copies overlap another's levels: the Hopper counterpart
// of the TPU kernel's double-buffered DMA.
//   - A and B1: pifft::long_range_levels_radix, radix-8 passes, the
//     first reading device memory and the last writing it (R1 = 128:
//     3 shared-memory passes where the first design made 7 levels plus
//     two copies; R2 = 64: 2 passes);
//   - B2: each tile row on a cluster of cw = 2^LOG2CW blocks
//     (pifft::cluster_row_levels, as fused.cu's phase B), 4096 points a
//     block (cw = 4 at tile 2^14).  The routine reads the whole row from
//     device memory before its second cluster.sync() and writes it only
//     after, so it runs in place on the carry.
// The grid is counted in whole clusters (cudaOccupancyMaxActiveClusters
// times cw), and the launch carries both the cooperative and the cluster
// attribute.  The card's answers (cooperative support, the resident
// grid, the shared-memory opt-in) are kept per card, so a launch
// captured into a CUDA graph records the launch alone.
//
// Bound.  Device memory.  Input read once and output written once (16
// bytes per element), plus two carry round trips; about 8 flop per
// element per long-range level and 5 per tile level, some 160 flop per
// element at n = 2^27 against 48 bytes moved: under the fp32 ridge.  The
// floor is 16 n bytes over HBM bandwidth, and the two carries cap this
// design at a third of it (the reference's two-carry ceiling).
//
// bf16 storage (pifft_sixstep_bf16, pifft_sixstep_dense_bf16; the
// reference's storage="bfloat16": planes, both carries, twiddles and
// tile tables at st_dt, l.1749-1836).  The same kernel instantiated on
// __nv_bfloat16: each point upcast once as it is read and rounded once
// as it is written, so both carries (after A and after B1) are held in
// bf16 and every pass moves half the bytes; shared memory and every
// level stay float.  Half the floor of the float32 kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// The phases a build runs, one bit each (A 1, B1 2, B2 4); the normal
// build runs all three.  tools/phase_ms.py builds this file with
// -DPIFFT_SIXSTEP_PHASES=1, 2 or 4 to time one phase alone.
#ifndef PIFFT_SIXSTEP_PHASES
#define PIFFT_SIXSTEP_PHASES 7
#endif
constexpr bool kPhaseA = (PIFFT_SIXSTEP_PHASES & 1) != 0;
constexpr bool kPhaseB1 = (PIFFT_SIXSTEP_PHASES & 2) != 0;
constexpr bool kPhaseB2 = (PIFFT_SIXSTEP_PHASES & 4) != 0;

// floats of one plane of a block's shared memory: the largest of the
// padded R1 x cb1 and R2 x cb2 blocks and the padded tile/cw segment
__host__ __device__ __forceinline__ int plane_floats(int log2_r1,
                                                     int log2_cb1,
                                                     int log2_r2,
                                                     int log2_cb2,
                                                     int log2_seg) {
  int f = pifft::padded_floats(1 << (log2_r1 + log2_cb1));
  const int b1 = pifft::padded_floats(1 << (log2_r2 + log2_cb2));
  const int b2 = pifft::padded_floats(1 << log2_seg);
  if (b1 > f) f = b1;
  return b2 > f ? b2 : f;
}

// The kernel's body for planes, carries and tables stored as T (float,
// or __nv_bfloat16: each point upcast once at a load and rounded once at
// a store, so both carries are held at the storage dtype, as the
// reference's are at st_dt, l.1490).
template <int LOG2CW, class T, class Outer, class Inner>
__device__ __forceinline__ void sixstep_body(
    float* smem, const T* __restrict__ xr, const T* __restrict__ xi,
    T* yr, T* yi,  // output and carry: not restrict
    const Outer& tw1, const Inner& tw2, const T* __restrict__ twr,
    const T* __restrict__ twi, int log2_r1, int log2_r2, int log2_tile,
    int log2_cb1, int log2_cb2) {
  const int log2_seg = log2_tile - LOG2CW;
  float* sr = smem;
  float* si = smem + plane_floats(log2_r1, log2_cb1, log2_r2, log2_cb2,
                                  log2_seg);
  const int log2_m = log2_r2 + log2_tile;
  const size_t m = static_cast<size_t>(1) << log2_m;
  const size_t tile = static_cast<size_t>(1) << log2_tile;
  cg::grid_group grid = cg::this_grid();

  // phase A: outer levels on the (R1, m) view, x (read once,
  // evict-first) into the carry
  const long long a_items = 1LL << (log2_m - log2_cb1);
  for (long long b = blockIdx.x; kPhaseA && b < a_items;
       b += gridDim.x) {
    const size_t c0 = static_cast<size_t>(b) << log2_cb1;
    pifft::long_range_levels_radix<pifft::Load::kStreaming,
                                   pifft::Store::kGlobal>(
        sr, si, xr, xi, yr, yi, c0, m, log2_r1, log2_cb1, tw1);
  }

  grid.sync();

  // phase B1: inner levels of every group, in place in the carry: the
  // planes are offset to the group, c0 is the column in its (R2, tile)
  // view (the twiddles' column)
  const int log2_q2 = log2_tile - log2_cb2;  // column blocks per group
  const long long b1_items = 1LL << (log2_r1 + log2_q2);
  for (long long it = blockIdx.x; kPhaseB1 && it < b1_items;
       it += gridDim.x) {
    const size_t group = static_cast<size_t>(it >> log2_q2) << log2_m;
    const size_t c0 = static_cast<size_t>(it & ((1LL << log2_q2) - 1))
                      << log2_cb2;
    T* gr = yr + group;
    T* gi = yi + group;
    pifft::long_range_levels_radix<pifft::Load::kCoherent,
                                   pifft::Store::kGlobal>(
        sr, si, gr, gi, gr, gi, c0, tile, log2_r2, log2_cb2, tw2);
  }

  grid.sync();

  // phase B2: the tile DIF of all R1 * R2 rows, in place, each row on one
  // cluster of 2^LOG2CW blocks, block rank r ending with segment r
  const long long rows = 1LL << (log2_r1 + log2_r2);
  const long long clusters = gridDim.x >> LOG2CW;
  const pifft::FlatTable<T> ftw{twr, twi, 1 << log2_tile};
  for (long long r = blockIdx.x >> LOG2CW; kPhaseB2 && r < rows;
       r += clusters) {
    const size_t row = static_cast<size_t>(r) << log2_tile;
    if constexpr (LOG2CW == 0) {
      pifft::row_levels_radix<true, true, pifft::Load::kCoherent,
                              pifft::Store::kStreaming>(
          sr, si, yr, yi, yr, yi, row, log2_tile, log2_tile, 0, ftw);
    } else {
      pifft::cluster_row_levels<LOG2CW, pifft::Load::kCoherent,
                                pifft::Store::kStreaming>(
          sr, si, yr, yi, yr, yi, row, log2_seg, ftw);
    }
  }
}

// Two overloads: float planes and tables, and the bf16 storage
// instantiation (bf16 planes, carries, long-range twiddles and tile
// tables).
template <int LOG2CW, class Outer, class Inner>
__global__ void __launch_bounds__(kThreads, 2)
sixstep_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* yr, float* yi,  // output and carry: not restrict
               Outer tw1, Inner tw2,
               const float* __restrict__ twr, const float* __restrict__ twi,
               int log2_r1, int log2_r2, int log2_tile, int log2_cb1,
               int log2_cb2) {
  extern __shared__ float smem[];
  sixstep_body<LOG2CW>(smem, xr, xi, yr, yi, tw1, tw2, twr, twi, log2_r1,
                       log2_r2, log2_tile, log2_cb1, log2_cb2);
}

template <int LOG2CW, class Outer, class Inner>
__global__ void __launch_bounds__(kThreads, 2)
sixstep_kernel(const __nv_bfloat16* __restrict__ xr,
               const __nv_bfloat16* __restrict__ xi, __nv_bfloat16* yr,
               __nv_bfloat16* yi, Outer tw1, Inner tw2,
               const __nv_bfloat16* __restrict__ twr,
               const __nv_bfloat16* __restrict__ twi, int log2_r1,
               int log2_r2, int log2_tile, int log2_cb1, int log2_cb2) {
  extern __shared__ float smem[];
  sixstep_body<LOG2CW>(smem, xr, xi, yr, yi, tw1, tw2, twr, twi, log2_r1,
                       log2_r2, log2_tile, log2_cb1, log2_cb2);
}

// One cooperative launch of sixstep_kernel<LOG2CW, ...> on clusters of
// 2^LOG2CW blocks, both as attributes of this launch
// (cudaLaunchKernelExC).  The grid is what the card holds at once —
// blocks per SM times SMs for cw = 1, the most active clusters
// (cudaOccupancyMaxActiveClusters) times cw otherwise — capped at the
// largest phase's work and counted in whole clusters.  A card that holds
// none, or has no cooperative launch, is refused, never run another way.
template <int LOG2CW, class T, class Outer, class Inner>
cudaError_t launch_sixstep(void** args, int smem, long long work,
                           int device, cudaStream_t stream) {
  void (*typed)(const T*, const T*, T*, T*, Outer, Inner, const T*,
                const T*, int, int, int, int, int) =
      sixstep_kernel<LOG2CW, Outer, Inner>;
  const void* kernel = reinterpret_cast<const void*>(typed);
  // what the card answered at the last launch of this instantiation,
  // reused while the device and the shared memory stay the same
  static pifft::SmemOptIn opted;
  static int cached_device = -1, cached_smem = -1;
  static long long cached_resident = 0;
  cudaError_t err = pifft::opt_in_smem(kernel, smem, device, opted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1u << LOG2CW;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  long long resident = 0;
  if (device == cached_device && smem == cached_smem) {
    resident = cached_resident;
  } else {
    int coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                 device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    if constexpr (LOG2CW == 0) {
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
      config.attrs = attrs + 1;
      config.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
      if (err != cudaSuccess) return err;
      resident = static_cast<long long>(clusters) << LOG2CW;
    }
    if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached_device = device;
    cached_smem = smem;
    cached_resident = resident;
  }
  long long blocks = work < resident ? work : resident;
  blocks = (blocks >> LOG2CW) << LOG2CW;
  config.gridDim = dim3(static_cast<unsigned int>(blocks));
  config.attrs = attrs;
  config.numAttrs = LOG2CW ? 2 : 1;
  err = cudaLaunchKernelExC(&config, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class T, class Outer, class Inner>
int launch(const T* xr, const T* xi, T* yr, T* yi, Outer tw1, Inner tw2,
           const T* twr, const T* twi, int log2_r1, int log2_r2,
           int log2_tile, int log2_cb1, int log2_cb2, int log2_cw,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 2 *
                   plane_floats(log2_r1, log2_cb1, log2_r2, log2_cb2,
                                log2_tile - log2_cw) *
                   static_cast<int>(sizeof(float));
  long long work = 1LL << (log2_r2 + log2_tile - log2_cb1);
  const long long b1 = 1LL << (log2_r1 + log2_tile - log2_cb2);
  const long long b2 = 1LL << (log2_r1 + log2_r2 + log2_cw);
  if (b1 > work) work = b1;
  if (b2 > work) work = b2;
  void* args[] = {&xr,      &xi,      &yr,        &yi,       &tw1,
                  &tw2,     &twr,     &twi,       &log2_r1,  &log2_r2,
                  &log2_tile, &log2_cb1, &log2_cb2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2_cw) {
    case 0: err = launch_sixstep<0, T, Outer, Inner>(args, smem, work,
                                                     device, s); break;
    case 1: err = launch_sixstep<1, T, Outer, Inner>(args, smem, work,
                                                     device, s); break;
    case 2: err = launch_sixstep<2, T, Outer, Inner>(args, smem, work,
                                                     device, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// Launch the n = 2^log2_r1 * 2^log2_r2 * 2^log2_tile point transform of
// (xr, xi) into (yr, yi) on `stream` (a cudaStream_t): outer factors
// (a1*, b1*) of long_range_factors(R1, R2 * tile), inner factors
// (a2*, b2*) of long_range_factors(R2, tile), tables (twr, twi) of
// flat_tables(tile), column blocks 2^log2_cb1 (outer) and 2^log2_cb2
// (inner), phase-B2 rows on clusters of 2^log2_cw blocks (0..2: tile /
// 4096 at tile 2^13 and 2^14, ops/cuda_fft.py: row_cluster_width).  One
// cooperative launch; returns its cudaError_t.  The caller
// (ops/cuda_fft.py: sixstep_blocking) checks the blocking.
extern "C" int pifft_sixstep(const float* xr, const float* xi, float* yr,
                             float* yi, const float* a1r, const float* a1i,
                             const float* b1r, const float* b1i,
                             const float* a2r, const float* a2i,
                             const float* b2r, const float* b2i,
                             const float* twr, const float* twi, int log2_r1,
                             int log2_r2, int log2_tile, int log2_cb1,
                             int log2_cb2, int log2_cw, int device,
                             void* stream) {
  const size_t tile = static_cast<size_t>(1) << log2_tile;
  const pifft::SeparableTwiddle tw1{{a1r, a1i, b1r, b1i, tile << log2_r2}};
  const pifft::SeparableTwiddle tw2{{a2r, a2i, b2r, b2i, tile}};
  return launch(xr, xi, yr, yi, tw1, tw2, twr, twi, log2_r1, log2_r2,
                log2_tile, log2_cb1, log2_cb2, log2_cw, device, stream);
}

// The same transform on bf16 planes, factors (device_factors(...,
// storage="bfloat16")) and tables (flat_tables(tile,
// storage="bfloat16")), both carries in bf16: the bf16 storage
// instantiation.
extern "C" int pifft_sixstep_bf16(
    const __nv_bfloat16* xr, const __nv_bfloat16* xi, __nv_bfloat16* yr,
    __nv_bfloat16* yi, const __nv_bfloat16* a1r, const __nv_bfloat16* a1i,
    const __nv_bfloat16* b1r, const __nv_bfloat16* b1i,
    const __nv_bfloat16* a2r, const __nv_bfloat16* a2i,
    const __nv_bfloat16* b2r, const __nv_bfloat16* b2i,
    const __nv_bfloat16* twr, const __nv_bfloat16* twi, int log2_r1,
    int log2_r2, int log2_tile, int log2_cb1, int log2_cb2, int log2_cw,
    int device, void* stream) {
  using Factors = pifft::SeparableFactors<__nv_bfloat16>;
  const size_t tile = static_cast<size_t>(1) << log2_tile;
  const Factors tw1{a1r, a1i, b1r, b1i, tile << log2_r2};
  const Factors tw2{a2r, a2i, b2r, b2i, tile};
  return launch(xr, xi, yr, yi, tw1, tw2, twr, twi, log2_r1, log2_r2,
                log2_tile, log2_cb1, log2_cb2, log2_cw, device, stream);
}

// The same transform with dense long-range tables: (w1r, w1i) of
// dense_long_range_tables(R1, R2 * tile) for phase A, each entry read by
// one block, so streamed (evict-first); (w2r, w2i) of
// dense_long_range_tables(R2, tile) for phase B1, shared by all R1
// groups, so read through the read-only path.
extern "C" int pifft_sixstep_dense(const float* xr, const float* xi,
                                   float* yr, float* yi, const float* w1r,
                                   const float* w1i, const float* w2r,
                                   const float* w2i, const float* twr,
                                   const float* twi, int log2_r1,
                                   int log2_r2, int log2_tile, int log2_cb1,
                                   int log2_cb2, int log2_cw, int device,
                                   void* stream) {
  const size_t tile = static_cast<size_t>(1) << log2_tile;
  const pifft::DenseTwiddle<true> tw1{{w1r, w1i, tile << log2_r2}};
  const pifft::DenseTwiddle<false> tw2{{w2r, w2i, tile}};
  return launch(xr, xi, yr, yi, tw1, tw2, twr, twi, log2_r1, log2_r2,
                log2_tile, log2_cb1, log2_cb2, log2_cw, device, stream);
}

// The dense transform on bf16 planes, tables and carries.
extern "C" int pifft_sixstep_dense_bf16(
    const __nv_bfloat16* xr, const __nv_bfloat16* xi, __nv_bfloat16* yr,
    __nv_bfloat16* yi, const __nv_bfloat16* w1r, const __nv_bfloat16* w1i,
    const __nv_bfloat16* w2r, const __nv_bfloat16* w2i,
    const __nv_bfloat16* twr, const __nv_bfloat16* twi, int log2_r1,
    int log2_r2, int log2_tile, int log2_cb1, int log2_cb2, int log2_cw,
    int device, void* stream) {
  const size_t tile = static_cast<size_t>(1) << log2_tile;
  const pifft::DenseTable<true, __nv_bfloat16> tw1{w1r, w1i,
                                                   tile << log2_r2};
  const pifft::DenseTable<false, __nv_bfloat16> tw2{w2r, w2i, tile};
  return launch(xr, xi, yr, yi, tw1, tw2, twr, twi, log2_r1, log2_r2,
                log2_tile, log2_cb1, log2_cb2, log2_cw, device, stream);
}
