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
//   B2  the tile-point DIF of all R1 * R2 rows.
// The long-range blocks are max(R1, R2) rows tall instead of R = R1 R2,
// so a block keeps whole 32-byte sectors of each row (cb >= 8) at any n
// that fits the card, where fourstep's R x cb block would not.
//
// Design.  The TPU walked A, then group after group of B1 and B2, as
// one sequential grid with two HBM carries and double-buffered DMA.
// Hopper blocks run in no order, so here one persistent cooperative
// launch (grid = resident blocks: occupancy x SMs) walks each phase's
// work items in a strided loop, with cg::this_grid().sync() between
// phases.  All groups' B1 blocks are independent work items, and so are
// all B2 rows.  The carry is the output buffer: A writes it, B1 updates
// its own R2 x cb2 slice in place (the same block reads and writes one
// slice, and no two items share one), B2 reads each row whole into
// shared memory before writing it back.  Carry reads go through L2
// (__ldcg), never the read-only path, because other blocks wrote them
// earlier in this launch; the carry pointers are not __restrict__.
// Offsets are 64-bit: at n = 2^27 a group index times m nears the
// int32 range.  The level loops are fft_common.cuh's.
//
// Bound.  Device memory.  Input read once and output written once (16
// bytes per element), plus two carry round trips; about 8 flop per
// element per long-range level and 5 per tile level, some 160 flop per
// element at n = 2^27 against 48 bytes moved: under the fp32 ridge.  The
// floor is 16 n bytes over HBM bandwidth, and the two carries cap this
// design at a third of it (the reference's two-carry ceiling).  Not
// done yet: cp.async/TMA prefetch under compute.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

template <class Outer, class Inner>
__global__ void __launch_bounds__(kThreads, 1)
sixstep_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
               float* yr, float* yi,  // output and carry: not restrict
               Outer tw1, Inner tw2,
               const float* __restrict__ twr, const float* __restrict__ twi,
               int log2_r1, int log2_r2, int log2_tile, int log2_cb1,
               int log2_cb2) {
  extern __shared__ float smem[];
  const int half_smem = max(max(1 << (log2_r1 + log2_cb1),
                                1 << (log2_r2 + log2_cb2)),
                            1 << log2_tile);
  float* sr = smem;
  float* si = smem + half_smem;
  const int log2_m = log2_r2 + log2_tile;
  const size_t m = static_cast<size_t>(1) << log2_m;
  const size_t tile = static_cast<size_t>(1) << log2_tile;
  cg::grid_group grid = cg::this_grid();

  // phase A: outer levels on the (R1, m) view
  const long long a_items = 1LL << (log2_m - log2_cb1);
  for (long long b = blockIdx.x; b < a_items; b += gridDim.x) {
    const size_t c0 = static_cast<size_t>(b) << log2_cb1;
    pifft::load_block<pifft::Load::kCached>(sr, si, xr, xi, c0, m, log2_r1,
                                            log2_cb1);
    pifft::long_range_levels(sr, si, log2_r1, log2_cb1, tw1, c0);
    pifft::store_block(yr, yi, sr, si, c0, m, log2_r1, log2_cb1);
  }

  grid.sync();

  // phase B1: inner levels of every group, in place in the carry
  const int log2_q2 = log2_tile - log2_cb2;  // column blocks per group
  const long long b1_items = 1LL << (log2_r1 + log2_q2);
  for (long long it = blockIdx.x; it < b1_items; it += gridDim.x) {
    const size_t group = static_cast<size_t>(it >> log2_q2);
    const size_t c0 = static_cast<size_t>(it & ((1LL << log2_q2) - 1))
                      << log2_cb2;
    const size_t base = (group << log2_m) + c0;
    pifft::load_block<pifft::Load::kCoherent>(sr, si, yr, yi, base, tile,
                                              log2_r2, log2_cb2);
    pifft::long_range_levels(sr, si, log2_r2, log2_cb2, tw2, c0);
    pifft::store_block(yr, yi, sr, si, base, tile, log2_r2, log2_cb2);
  }

  grid.sync();

  // phase B2: the tile DIF of all R1 * R2 rows, in place
  const long long rows = 1LL << (log2_r1 + log2_r2);
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const size_t base = static_cast<size_t>(r) << log2_tile;
    pifft::load_block<pifft::Load::kCoherent>(sr, si, yr, yi, base, 0, 0,
                                              log2_tile);
    pifft::tile_levels(sr, si, log2_tile, twr, twi);
    pifft::store_block(yr, yi, sr, si, base, 0, 0, log2_tile);
  }
}

template <class Outer, class Inner>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           Outer tw1, Inner tw2, const float* twr, const float* twi,
           int log2_r1, int log2_r2, int log2_tile, int log2_cb1,
           int log2_cb2, int device, void* stream) {
  int half = 1 << log2_tile;
  if ((1 << (log2_r1 + log2_cb1)) > half) half = 1 << (log2_r1 + log2_cb1);
  if ((1 << (log2_r2 + log2_cb2)) > half) half = 1 << (log2_r2 + log2_cb2);
  const int smem = 2 * half * static_cast<int>(sizeof(float));
  long long work = 1LL << (log2_r2 + log2_tile - log2_cb1);
  const long long b1 = 1LL << (log2_r1 + log2_tile - log2_cb2);
  const long long b2 = 1LL << (log2_r1 + log2_r2);
  if (b1 > work) work = b1;
  if (b2 > work) work = b2;
  void* args[] = {&xr,      &xi,      &yr,        &yi,       &tw1,
                  &tw2,     &twr,     &twi,       &log2_r1,  &log2_r2,
                  &log2_tile, &log2_cb1, &log2_cb2};
  return static_cast<int>(pifft::launch_cooperative(
      reinterpret_cast<const void*>(sixstep_kernel<Outer, Inner>), kThreads,
      smem, work, args, device, stream));
}

}  // namespace

// Launch the n = 2^log2_r1 * 2^log2_r2 * 2^log2_tile point transform of
// (xr, xi) into (yr, yi) on `stream` (a cudaStream_t): outer factors
// (a1*, b1*) of long_range_factors(R1, R2 * tile), inner factors
// (a2*, b2*) of long_range_factors(R2, tile), tables (twr, twi) of
// flat_tables(tile), column blocks 2^log2_cb1 (outer) and 2^log2_cb2
// (inner).  One cooperative launch; returns its cudaError_t.
extern "C" int pifft_sixstep(const float* xr, const float* xi, float* yr,
                             float* yi, const float* a1r, const float* a1i,
                             const float* b1r, const float* b1i,
                             const float* a2r, const float* a2i,
                             const float* b2r, const float* b2i,
                             const float* twr, const float* twi, int log2_r1,
                             int log2_r2, int log2_tile, int log2_cb1,
                             int log2_cb2, int device, void* stream) {
  const size_t tile = static_cast<size_t>(1) << log2_tile;
  const pifft::SeparableTwiddle tw1{a1r, a1i, b1r, b1i, tile << log2_r2};
  const pifft::SeparableTwiddle tw2{a2r, a2i, b2r, b2i, tile};
  return launch(xr, xi, yr, yi, tw1, tw2, twr, twi, log2_r1, log2_r2,
                log2_tile, log2_cb1, log2_cb2, device, stream);
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
                                   int log2_cb2, int device, void* stream) {
  const size_t tile = static_cast<size_t>(1) << log2_tile;
  const pifft::DenseTwiddle<true> tw1{w1r, w1i, tile << log2_r2};
  const pifft::DenseTwiddle<false> tw2{w2r, w2i, tile};
  return launch(xr, xi, yr, yi, tw1, tw2, twr, twi, log2_r1, log2_r2,
                log2_tile, log2_cb1, log2_cb2, device, stream);
}
