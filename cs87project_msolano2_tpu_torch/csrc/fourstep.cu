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
// here one persistent cooperative launch (cudaLaunchCooperativeKernel,
// grid = resident blocks: occupancy x SMs) walks phase A's tile/cb
// column blocks in a strided loop, meets at cg::this_grid().sync(),
// then walks phase B's R rows.  Both phases stage their block in the
// same dynamic shared memory, max(2 R cb, 2 tile) floats (128 KB at
// tile 2^14, one block per SM).  The carry is the output buffer itself:
// phase A writes column blocks of y, phase B reads each row of y whole
// into shared memory before it writes that row back.  Carry reads go
// through L2 (__ldcg, fft_common.cuh), never the read-only path, because
// other blocks wrote them earlier in this launch; the carry pointers
// are not __restrict__.  The level loops are fft_common.cuh's, shared
// with long_range.cu and tile_fft.cu, so the kernel agrees with the rql
// composition to float rounding.
//
// Bound.  Device memory.  The input is read once and the output written
// once (16 bytes per element), plus one carry round trip (another 16);
// log2(R) levels at about 8 flop per element and log2(tile) at 5 come
// to about 150 flop per element at n = 2^24, under 5 flop per byte of
// the 32 moved: far below the card's fp32 ridge of about 20.  The floor
// is therefore 16 n bytes over HBM bandwidth, and the carry caps this
// design at half of it (the reference's one-carry roofline ceiling).
// Not done yet: prefetching row j + 1 under row j (cp.async or TMA),
// the Hopper counterpart of the TPU kernel's DMA double-buffering.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

template <class Twiddle>
__global__ void __launch_bounds__(kThreads, 1)
fourstep_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                float* yr, float* yi,  // output and carry: not restrict
                Twiddle tw,
                const float* __restrict__ twr, const float* __restrict__ twi,
                int log2_r, int log2_tile, int log2_cb) {
  extern __shared__ float smem[];
  const int half_smem = max(1 << (log2_r + log2_cb), 1 << log2_tile);
  float* sr = smem;
  float* si = smem + half_smem;
  const size_t tile = static_cast<size_t>(1) << log2_tile;

  // phase A: the long-range levels, one R x cb column block at a time
  const int col_blocks = 1 << (log2_tile - log2_cb);
  for (int b = blockIdx.x; b < col_blocks; b += gridDim.x) {
    const size_t c0 = static_cast<size_t>(b) << log2_cb;
    pifft::load_block<pifft::Load::kCached>(sr, si, xr, xi, c0, tile,
                                            log2_r, log2_cb);
    pifft::long_range_levels(sr, si, log2_r, log2_cb, tw, c0);
    pifft::store_block(yr, yi, sr, si, c0, tile, log2_r, log2_cb);
  }

  cg::this_grid().sync();

  // phase B: the tile DIF of every carry row, in place
  const int rows = 1 << log2_r;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const size_t base = static_cast<size_t>(r) << log2_tile;
    pifft::load_block<pifft::Load::kCoherent>(sr, si, yr, yi, base, 0, 0,
                                              log2_tile);
    pifft::tile_levels(sr, si, log2_tile, twr, twi);
    pifft::store_block(yr, yi, sr, si, base, 0, 0, log2_tile);
  }
}

template <class Twiddle>
int launch(const float* xr, const float* xi, float* yr, float* yi,
           Twiddle tw, const float* twr, const float* twi, int log2_r,
           int log2_tile, int log2_cb, int device, void* stream) {
  const int lr = 1 << (log2_r + log2_cb);
  const int tile = 1 << log2_tile;
  const int half = lr > tile ? lr : tile;  // floats per plane
  const int smem = 2 * half * static_cast<int>(sizeof(float));
  const long long col_blocks = 1LL << (log2_tile - log2_cb);
  const long long rows = 1LL << log2_r;
  void* args[] = {&xr, &xi, &yr, &yi, &tw, &twr, &twi,
                  &log2_r, &log2_tile, &log2_cb};
  return static_cast<int>(pifft::launch_cooperative(
      reinterpret_cast<const void*>(fourstep_kernel<Twiddle>), kThreads,
      smem, col_blocks > rows ? col_blocks : rows, args, device, stream));
}

}  // namespace

// Launch the n = 2^log2_r * 2^log2_tile point transform of (xr, xi)
// into (yr, yi) on `stream` (a cudaStream_t): factors (ar, ai, br, bi)
// of long_range_factors(R, tile), tables (twr, twi) of
// flat_tables(tile), column blocks of 2^log2_cb.  One cooperative
// launch; returns its cudaError_t (0 = success).
extern "C" int pifft_fourstep(const float* xr, const float* xi, float* yr,
                              float* yi, const float* ar, const float* ai,
                              const float* br, const float* bi,
                              const float* twr, const float* twi, int log2_r,
                              int log2_tile, int log2_cb, int device,
                              void* stream) {
  const pifft::SeparableTwiddle tw{ar, ai, br, bi,
                                   static_cast<size_t>(1) << log2_tile};
  return launch(xr, xi, yr, yi, tw, twr, twi, log2_r, log2_tile, log2_cb,
                device, stream);
}

// The same transform with phase A's twiddles read from the dense
// (R - 1, tile) tables (wr, wi) of dense_long_range_tables(R, tile):
// each entry is read by the one block that owns its column, so the
// reads stream (evict-first).
extern "C" int pifft_fourstep_dense(const float* xr, const float* xi,
                                    float* yr, float* yi, const float* wr,
                                    const float* wi, const float* twr,
                                    const float* twi, int log2_r,
                                    int log2_tile, int log2_cb, int device,
                                    void* stream) {
  const pifft::DenseTwiddle<true> tw{wr, wi,
                                     static_cast<size_t>(1) << log2_tile};
  return launch(xr, xi, yr, yi, tw, twr, twi, log2_r, log2_tile, log2_cb,
                device, stream);
}
