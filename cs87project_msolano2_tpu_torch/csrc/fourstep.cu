// fourstep: a whole n-point pi-layout DIF transform, n = R * tile, in
// ONE launch on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel cs87project_msolano2_tpu/ops/pallas_fft.py:
// _fourstep_kernel (l.1046), launched there by
// fft_pi_layout_pallas_fourstep (l.1228, pallas_call l.1325).
//
// What it computes.  The (R, tile) view of the input goes through the
// first log2(R) DIF levels in R x cb column blocks (phase A, the
// long-range levels, twiddles rebuilt from the separable factors of
// long_range_factors(R, tile), or read from the dense per-level tables
// of dense_long_range_tables(R, tile): the reference's separable=False,
// a twiddle source of fft_common.cuh picked at compile time), then
// every one of the R rows through the tile-point DIF (phase B,
// twiddle_tables(tile)).  That is the rql composition of long_range.cu
// (either twiddle source) and tile_fft.cu, in one launch.
//
// Design.  The TPU ran phase A then phase B as one sequential grid,
// with an HBM carry written by double-buffered DMA; it relied on the
// grid's steps running in order.  Hopper blocks run in no order, so
// here one persistent cooperative launch (grid = the blocks the card
// holds at once) walks phase A's tile/cb column blocks in a strided
// loop, meets at cg::this_grid().sync(), then walks phase B's R rows.
// The carry is the output buffer itself: phase A writes column blocks of
// y, phase B rewrites each row of y in place.  Carry reads go through L2
// (ld.global.cg), never the read-only path, because
// other blocks wrote them earlier in this launch; the carry pointers are
// not __restrict__, and offsets are 64-bit.
//
// The Hopper redesign.  The first design ran 1024-thread blocks of up
// to 128 KB, one per SM, each loading its block, running one radix-2
// level per __syncthreads() and storing it, in series.  Now both phases
// run fft_common.cuh's register radix loop in 256-thread blocks of at
// most 128 registers, two resident on each SM wherever the blocking
// allows (every automatic blocking from 2^21 to 2^24), so one block's
// copies overlap the other's levels — the Hopper counterpart of the
// reference's double-buffered DMA:
//   - A: pifft::long_range_levels_deep<4>, x to the carry in passes of
//     3-4 levels, the first reading device memory with 8 or 16 points a
//     thread in flight (R = 1024: 4 + 3 + 3 levels, 2 shared-memory
//     round trips where the first design made 10 levels plus two
//     copies).  x is read through L2 without evict-first: at cb = 8 a
//     block reads 32 bytes of each row, and the neighbouring column
//     block reads the rest of the line soon after;
//   - B: each tile row on a cluster of cw = 2^LOG2CW blocks of 4096
//     points (cw = 4 at tile 2^14), as sixstep's phase B2
//     (pifft::cluster_row_levels, reading the carry through L2).
// The reference's other overlap, read_dma((j + 1) % 2, ...)
// (l.1156-1160), was tried as a TMA bulk copy of each block's next row
// segment into a second shared buffer: it ran phase B alone faster but
// the whole kernel slower on an H100 (its 99 KB blocks shrink the L1
// that phase A reads through), so residency is the one design (PERF.md).
// The grid is counted in whole clusters (cudaOccupancyMaxActiveClusters
// times cw), and the launch carries both the cooperative and the cluster
// attribute.  The card's answers (cooperative support, the resident
// grid, the shared-memory opt-in) are kept per card, so a launch
// captured into a CUDA graph records the launch alone.
//
// Bound.  Device memory.  The input is read once and the output written
// once (16 bytes per element), plus one carry round trip (another 16);
// log2(R) levels at about 8 flop per element and log2(tile) at 5 come
// to about 150 flop per element at n = 2^24, under 5 flop per byte of
// the 32 moved: far below the card's fp32 ridge of about 20.  The floor
// is therefore 16 n bytes over HBM bandwidth, and the carry caps this
// design at half of it (the reference's one-carry roofline ceiling).
//
// bf16 storage (pifft_fourstep_bf16, pifft_fourstep_dense_bf16; the
// reference's storage="bfloat16": planes, carry, factors or dense
// tables and tile tables at st_dt, l.1263-1341).  The same kernel
// instantiated on __nv_bfloat16: each point upcast once as it is read
// and rounded once as it is written, so the carry between phases A and
// B is held in bf16 and every round trip moves half the bytes; shared
// memory and every level stay float.  Half the floor of the float32
// kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// The phases a build runs, one bit each (A 1, B 2); the normal build
// runs both.  tools/phase_ms.py builds this file with
// -DPIFFT_FOURSTEP_PHASES=1 or 2 to time one phase alone.
#ifndef PIFFT_FOURSTEP_PHASES
#define PIFFT_FOURSTEP_PHASES 3
#endif
constexpr bool kPhaseA = (PIFFT_FOURSTEP_PHASES & 1) != 0;
constexpr bool kPhaseB = (PIFFT_FOURSTEP_PHASES & 2) != 0;

// The dynamic shared memory of one block, in floats: phase A's two
// padded R x cb planes or phase B's two padded segments of seg =
// tile / cw points, whichever is larger (the persistent block holds one
// phase at a time), rounded up to 16 bytes.
struct Layout {
  int plane_a;  // floats of one phase-A plane
  int plane_b;  // floats of one phase-B plane
  int total;

  __host__ __device__ Layout(int log2_r, int log2_cb, int log2_seg) {
    plane_a = pifft::padded_floats(1 << (log2_r + log2_cb));
    plane_b = pifft::padded_floats(1 << log2_seg);
    total = ((plane_a > plane_b ? 2 * plane_a : 2 * plane_b) + 3) & ~3;
  }

  __host__ __device__ int bytes() const {
    return total * static_cast<int>(sizeof(float));
  }
};

// The kernel's body for planes, carry and tables stored as T (float, or
// __nv_bfloat16: each point upcast once at a load, rounded once at a
// store, so the carry between the phases is held at the storage dtype,
// as the reference's (R, Q, LANE) carry at st_dt, l.1337).
template <int LOG2CW, class T, class Twiddle>
__device__ __forceinline__ void fourstep_body(
    float* smem, const T* __restrict__ xr, const T* __restrict__ xi,
    T* yr, T* yi,  // output and carry: not restrict
    const Twiddle& tw, const T* __restrict__ twr,
    const T* __restrict__ twi, int log2_r, int log2_tile, int log2_cb) {
  const int log2_seg = log2_tile - LOG2CW;
  const Layout lay(log2_r, log2_cb, log2_seg);
  const size_t tile = static_cast<size_t>(1) << log2_tile;
  cg::grid_group grid = cg::this_grid();

  // phase A: the long-range levels, one R x cb column block at a time,
  // x into the carry
  const long long col_blocks = 1LL << (log2_tile - log2_cb);
  for (long long b = blockIdx.x; kPhaseA && b < col_blocks;
       b += gridDim.x) {
    const size_t c0 = static_cast<size_t>(b) << log2_cb;
    pifft::long_range_levels_deep<4, pifft::Load::kCoherent,
                                  pifft::Store::kGlobal>(
        smem, smem + lay.plane_a, xr, xi, yr, yi, c0, tile, log2_r,
        log2_cb, tw);
  }

  grid.sync();

  // phase B: the tile DIF of every carry row, in place, each row on one
  // cluster of 2^LOG2CW blocks, block rank r ending with segment r
  if constexpr (kPhaseB) {
    const long long rows = 1LL << log2_r;
    const long long clusters = gridDim.x >> LOG2CW;
    const pifft::FlatTable<T> ftw{twr, twi, 1 << log2_tile};
    float* sr = smem;
    float* si = smem + lay.plane_b;
    for (long long r = blockIdx.x >> LOG2CW; r < rows; r += clusters) {
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
}

// Two overloads: float planes and tables, and the bf16 storage
// instantiation (bf16 planes, carry, factors or dense tables, and tile
// tables).
template <int LOG2CW, class Twiddle>
__global__ void __launch_bounds__(kThreads, 2)
fourstep_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* yr, float* yi,  // output and carry: not restrict
                Twiddle tw,
                const float* __restrict__ twr, const float* __restrict__ twi,
                int log2_r, int log2_tile, int log2_cb) {
  extern __shared__ __align__(16) float smem[];
  fourstep_body<LOG2CW>(smem, xr, xi, yr, yi, tw, twr, twi, log2_r,
                        log2_tile, log2_cb);
}

template <int LOG2CW, class Twiddle>
__global__ void __launch_bounds__(kThreads, 2)
fourstep_kernel(const __nv_bfloat16* __restrict__ xr,
                const __nv_bfloat16* __restrict__ xi, __nv_bfloat16* yr,
                __nv_bfloat16* yi, Twiddle tw,
                const __nv_bfloat16* __restrict__ twr,
                const __nv_bfloat16* __restrict__ twi, int log2_r,
                int log2_tile, int log2_cb) {
  extern __shared__ __align__(16) float smem[];
  fourstep_body<LOG2CW>(smem, xr, xi, yr, yi, tw, twr, twi, log2_r,
                        log2_tile, log2_cb);
}

// fourstep_kernel<LOG2CW, Twiddle> for planes stored as T
template <int LOG2CW, class T, class Twiddle>
const void* kernel_for() {
  void (*kernel)(const T*, const T*, T*, T*, Twiddle, const T*, const T*,
                 int, int, int) = fourstep_kernel<LOG2CW, Twiddle>;
  return reinterpret_cast<const void*>(kernel);
}

// The blocks of fourstep_kernel<LOG2CW, ...> the card holds at once
// with `smem` bytes of shared memory each: blocks per SM times SMs for
// cw = 1, the most active clusters (cudaOccupancyMaxActiveClusters)
// times cw otherwise.  Opts the kernel into `smem` first (once per
// card).  A card without cooperative launch is refused.
template <int LOG2CW, class T, class Twiddle>
cudaError_t resident_blocks(int smem, int device, long long* resident) {
  const void* kernel = kernel_for<LOG2CW, T, Twiddle>();
  static pifft::SmemOptIn opted;
  cudaError_t err = pifft::opt_in_smem(kernel, smem, device, opted);
  if (err != cudaSuccess) return err;
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
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
    *resident = static_cast<long long>(per_sm) * sms;
  } else {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 1u << LOG2CW;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(1u << LOG2CW);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = static_cast<size_t>(smem);
    config.attrs = &attr;
    config.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (err != cudaSuccess) return err;
    *resident = static_cast<long long>(clusters) << LOG2CW;
  }
  return cudaSuccess;
}

// One cooperative launch of fourstep_kernel<LOG2CW, ...> on clusters of
// 2^LOG2CW blocks, both as attributes of this launch
// (cudaLaunchKernelExC).  The grid is what the card holds at once
// (resident_blocks, asked once per card and size), capped at the larger
// phase's work and counted in whole clusters.  A card that holds none,
// or has no cooperative launch, is refused, never run another way.
template <int LOG2CW, class T, class Twiddle>
cudaError_t launch_fourstep(void** args, int smem, long long work,
                            int device, cudaStream_t stream) {
  // what the card answered at the last launch of this instantiation,
  // reused while the device and the shared memory stay the same
  static int cached_device = -1, cached_smem = -1;
  static long long cached_resident = 0;
  if (device != cached_device || smem != cached_smem) {
    long long resident = 0;
    const cudaError_t err =
        resident_blocks<LOG2CW, T, Twiddle>(smem, device, &resident);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached_device = device;
    cached_smem = smem;
    cached_resident = resident;
  }
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = 1u << LOG2CW;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  long long blocks = work < cached_resident ? work : cached_resident;
  blocks = (blocks >> LOG2CW) << LOG2CW;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(blocks));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  config.attrs = attrs;
  config.numAttrs = LOG2CW ? 2 : 1;
  const cudaError_t err =
      cudaLaunchKernelExC(&config, kernel_for<LOG2CW, T, Twiddle>(), args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class T, class Twiddle>
int launch(const T* xr, const T* xi, T* yr, T* yi, Twiddle tw,
           const T* twr, const T* twi, int log2_r, int log2_tile,
           int log2_cb, int log2_cw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = Layout(log2_r, log2_cb, log2_tile - log2_cw).bytes();
  const long long col_blocks = 1LL << (log2_tile - log2_cb);
  const long long row_blocks = 1LL << (log2_r + log2_cw);
  const long long work = col_blocks > row_blocks ? col_blocks : row_blocks;
  void* args[] = {&xr, &xi, &yr, &yi, &tw, &twr, &twi,
                  &log2_r, &log2_tile, &log2_cb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2_cw) {
    case 0:
      err = launch_fourstep<0, T, Twiddle>(args, smem, work, device, s);
      break;
    case 1:
      err = launch_fourstep<1, T, Twiddle>(args, smem, work, device, s);
      break;
    case 2:
      err = launch_fourstep<2, T, Twiddle>(args, smem, work, device, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// Launch the n = 2^log2_r * 2^log2_tile point transform of (xr, xi)
// into (yr, yi) on `stream` (a cudaStream_t): factors (ar, ai, br, bi)
// of long_range_factors(R, tile), tables (twr, twi) of
// flat_tables(tile), column blocks of 2^log2_cb, phase-B rows on
// clusters of 2^log2_cw blocks (0..2: ops/cuda_fft.py:
// row_cluster_width).  One cooperative launch; returns its cudaError_t
// (0 = success).  The caller (ops/cuda_fft.py: fourstep_blocking)
// checks the blocking; the planes are 16-byte aligned.
extern "C" int pifft_fourstep(const float* xr, const float* xi, float* yr,
                              float* yi, const float* ar, const float* ai,
                              const float* br, const float* bi,
                              const float* twr, const float* twi, int log2_r,
                              int log2_tile, int log2_cb, int log2_cw,
                              int device, void* stream) {
  const pifft::SeparableTwiddle tw{
      {ar, ai, br, bi, static_cast<size_t>(1) << log2_tile}};
  return launch(xr, xi, yr, yi, tw, twr, twi, log2_r, log2_tile, log2_cb,
                log2_cw, device, stream);
}

// The same transform on bf16 planes, factors (device_factors(R, tile,
// storage="bfloat16")) and tables (flat_tables(tile,
// storage="bfloat16")), its carry in bf16: the bf16 storage
// instantiation.
extern "C" int pifft_fourstep_bf16(
    const __nv_bfloat16* xr, const __nv_bfloat16* xi, __nv_bfloat16* yr,
    __nv_bfloat16* yi, const __nv_bfloat16* ar, const __nv_bfloat16* ai,
    const __nv_bfloat16* br, const __nv_bfloat16* bi,
    const __nv_bfloat16* twr, const __nv_bfloat16* twi, int log2_r,
    int log2_tile, int log2_cb, int log2_cw, int device, void* stream) {
  const pifft::SeparableFactors<__nv_bfloat16> tw{
      ar, ai, br, bi, static_cast<size_t>(1) << log2_tile};
  return launch(xr, xi, yr, yi, tw, twr, twi, log2_r, log2_tile, log2_cb,
                log2_cw, device, stream);
}

// The same transform with phase A's twiddles read from the dense
// (R - 1, tile) tables (wr, wi) of dense_long_range_tables(R, tile):
// each entry is read by the one block that owns its column, so the
// reads stream (evict-first).
extern "C" int pifft_fourstep_dense(const float* xr, const float* xi,
                                    float* yr, float* yi, const float* wr,
                                    const float* wi, const float* twr,
                                    const float* twi, int log2_r,
                                    int log2_tile, int log2_cb, int log2_cw,
                                    int device, void* stream) {
  const pifft::DenseTwiddle<true> tw{
      {wr, wi, static_cast<size_t>(1) << log2_tile}};
  return launch(xr, xi, yr, yi, tw, twr, twi, log2_r, log2_tile, log2_cb,
                log2_cw, device, stream);
}

// The dense transform on bf16 planes, tables (dense_long_range_tables(R,
// tile, storage="bfloat16"), flat_tables(tile, storage="bfloat16")) and
// carry.
extern "C" int pifft_fourstep_dense_bf16(
    const __nv_bfloat16* xr, const __nv_bfloat16* xi, __nv_bfloat16* yr,
    __nv_bfloat16* yi, const __nv_bfloat16* wr, const __nv_bfloat16* wi,
    const __nv_bfloat16* twr, const __nv_bfloat16* twi, int log2_r,
    int log2_tile, int log2_cb, int log2_cw, int device, void* stream) {
  const pifft::DenseTable<true, __nv_bfloat16> tw{
      wr, wi, static_cast<size_t>(1) << log2_tile};
  return launch(xr, xi, yr, yi, tw, twr, twi, log2_r, log2_tile, log2_cb,
                log2_cw, device, stream);
}

// The blocks of the separable kernel the card at `device` holds at once
// for this blocking (the occupancy API's answer, which sizes the
// persistent grid), or minus the cudaError_t of the query.
extern "C" long long pifft_fourstep_resident_blocks(int log2_r,
                                                    int log2_tile,
                                                    int log2_cb, int log2_cw,
                                                    int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const int smem = Layout(log2_r, log2_cb, log2_tile - log2_cw).bytes();
  long long resident = 0;
  switch (log2_cw) {
    case 0: err = resident_blocks<0, float, pifft::SeparableTwiddle>(
                  smem, device, &resident);
      break;
    case 1: err = resident_blocks<1, float, pifft::SeparableTwiddle>(
                  smem, device, &resident);
      break;
    case 2: err = resident_blocks<2, float, pifft::SeparableTwiddle>(
                  smem, device, &resident);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? resident : -static_cast<long long>(err);
}
