// gpu_rows: the pi-layout radix-2 DIF of every row of (rows, n) float32
// planes, 2 <= n <= 2^18, twiddles from the (stages, n / 2) stack of
// twiddle_stack(n), on an NVIDIA Hopper card (sm_90a).  The gpu plan
// backend's gpu-rows rung.
//
// Replaces the GPU-portable Pallas kernel
// cs87project_msolano2_tpu/hw/lowering.py: _radix2_kernel (l.82),
// launched there by fft_rows_gpu (l.116, pallas_call l.145) with
// block_rows rows per grid step.
//
// Bound.  Device memory: 16 bytes per element each way plus the stack's
// n - 1 distinct complex entries (row s is read only below (n >> s) / 2;
// once per launch from device memory, then from L2 by every row),
// against 5 flop per element per level: far below the card's fp32
// ridge, so bytes over HBM bandwidth is the floor, for every n: no row
// leaves the chip between its load and its store.
//
// Design.  One launch per call, built from fft_common.cuh's Hopper
// blocks: the register radix loop (16 points a thread, 4 levels per
// __syncthreads(), padded shared-memory planes), whose first pass reads
// a row from device memory and whose last pass writes it back, so a
// 4096-point row takes three passes where the first design made
// fourteen (a load, 12 levels, a store).
//
// Rows of up to 2^14 points run whole in one block: block_rows rows back
// to back (8 * block_rows * n bytes plus 1/32 padding, at most 2^14
// points), one thread per 16 points up to 512, so a small block leaves
// room for several on each SM.
//
// A row of 2^15..2^18 points does not fit one SM's 227 KB, so it goes on
// a thread-block cluster of K = n / 2^14 blocks (2, 4, 8 or 16; 16 is
// above the portable cluster size and opts into the card's non-portable
// one), each holding one 2^14-point segment (132 KB padded):
// pifft::cluster_row_levels runs the row's first log2(K) levels across
// the cluster (each block reads its share of columns from device memory
// and writes the results into the K blocks' shared memory) and the
// other 14 in each block.  The row touches device memory once each way
// (the old two-pass design wrote it out and read it back between), and
// 64 rows of 2^18 give 1024 blocks, not 64.  A cluster walks block_rows rows one
// after the other.  pifft_gpu_rows_max_clusters tells the wrapper before
// launch whether the card can hold such a cluster at all; where it
// cannot, the wrapper raises, and no other design runs in its place.

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace {

// log2 of the longest row one block holds in shared memory
constexpr int kLog2Seg = 14;
// threads of a block: one per 16 points, at most this many
constexpr int kMaxThreads = 512;

__global__ void __launch_bounds__(kMaxThreads)
gpu_rows_short(const float* __restrict__ xr, const float* __restrict__ xi,
               float* __restrict__ yr, float* __restrict__ yi,
               const float* __restrict__ twr, const float* __restrict__ twi,
               int log2_n, int log2_block_rows) {
  extern __shared__ float smem[];
  const int log2_total = log2_n + log2_block_rows;
  float* sr = smem;
  float* si = smem + pifft::padded_floats(1 << log2_total);
  const size_t base = static_cast<size_t>(blockIdx.x) << log2_total;
  const pifft::StackTwiddle tw{twr, twi,
                               static_cast<size_t>(1) << (log2_n - 1), 0, 0};
  pifft::row_levels_radix<true, true, pifft::Load::kCached,
                          pifft::Store::kCached>(
      sr, si, xr, xi, yr, yi, base, log2_total, log2_n, 0, tw);
}

template <int LOG2K>
__global__ void __launch_bounds__(kMaxThreads, 1)
gpu_rows_cluster(const float* __restrict__ xr, const float* __restrict__ xi,
                 float* __restrict__ yr, float* __restrict__ yi,
                 const float* __restrict__ twr,
                 const float* __restrict__ twi, int log2_seg,
                 int log2_block_rows) {
  // log2_seg is kLog2Seg, passed at run time: a compile-time segment
  // lets the compiler unroll the whole level loop, and that code ran
  // 2.4 times slower on an H100
  extern __shared__ float smem[];
  const int log2_n = log2_seg + LOG2K;
  float* sr = smem;
  float* si = smem + pifft::padded_floats(1 << log2_seg);
  const size_t cluster = blockIdx.x >> LOG2K;
  const pifft::StackTwiddle tw{twr, twi, static_cast<size_t>(1)
                                             << (log2_n - 1),
                               0, 0};
  for (int k = 0; k < (1 << log2_block_rows); ++k) {
    const size_t row = ((cluster << log2_block_rows) + k) << log2_n;
    pifft::cluster_row_levels<LOG2K, pifft::Load::kCached,
                              pifft::Store::kCached>(sr, si, xr, xi, yr, yi,
                                                     row, log2_seg, tw);
  }
}

constexpr int kClusterSmem =
    2 * pifft::padded_floats(1 << kLog2Seg) * static_cast<int>(sizeof(float));

// The launch configuration of `blocks` blocks in clusters of 2^LOG2K,
// with the kernel opted into its shared memory and, for 16, into the
// non-portable cluster size.  `attr` must outlive `config`.
template <int LOG2K>
cudaError_t cluster_config(unsigned int blocks, cudaStream_t stream,
                           cudaLaunchConfig_t* config,
                           cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      gpu_rows_cluster<LOG2K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kClusterSmem);
  if (err != cudaSuccess) return err;
  if ((1 << LOG2K) > 8) {
    err = cudaFuncSetAttribute(gpu_rows_cluster<LOG2K>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << LOG2K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = {};
  config->gridDim = dim3(blocks);
  config->blockDim = dim3(kMaxThreads);
  config->dynamicSmemBytes = kClusterSmem;
  config->stream = stream;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

template <int LOG2K>
cudaError_t launch_cluster(const float* xr, const float* xi, float* yr,
                           float* yi, const float* twr, const float* twi,
                           long long rows, int log2_block_rows,
                           cudaStream_t stream) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const unsigned int blocks =
      static_cast<unsigned int>((rows >> log2_block_rows) << LOG2K);
  cudaError_t err = cluster_config<LOG2K>(blocks, stream, &config, &attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&config, gpu_rows_cluster<LOG2K>, xr, xi, yr, yi,
                            twr, twi, kLog2Seg, log2_block_rows);
}

template <int LOG2K>
cudaError_t max_clusters(int* count) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<LOG2K>(1u << LOG2K, nullptr, &config,
                                          &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, gpu_rows_cluster<LOG2K>,
                                        &config);
}

}  // namespace

// How many clusters of the long-row kernel for 2^log2_n-point rows
// (2^15..2^18: K = 2^(log2_n - 14) blocks of 132 KB each) the card can
// hold at once (cudaOccupancyMaxActiveClusters); 0 = none, and the
// launch would be refused.  A negative value is a cudaError_t, negated.
extern "C" long long pifft_gpu_rows_max_clusters(int log2_n, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  int count = 0;
  switch (log2_n - kLog2Seg) {
    case 1: err = max_clusters<1>(&count); break;
    case 2: err = max_clusters<2>(&count); break;
    case 3: err = max_clusters<3>(&count); break;
    case 4: err = max_clusters<4>(&count); break;
    default: return -static_cast<long long>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return count;
}

// Launch the DIF of `rows` rows of 2^log2_n points on `stream` (a
// cudaStream_t); (twr, twi) is the (log2_n, n / 2) stack of
// twiddle_stack(n).  Rows of up to 2^14 points: 2^log2_block_rows rows a
// block.  Longer rows: one cluster of n / 2^14 blocks per row,
// 2^log2_block_rows rows a cluster, one after the other.  The caller
// checks that block_rows divides rows, that a short block fits shared
// memory (block_rows * n <= 2^14) and that the four planes are 16-byte
// aligned.  Returns the cudaError_t of the launch: 0 = success.
extern "C" int pifft_gpu_rows(const float* xr, const float* xi, float* yr,
                              float* yi, const float* twr, const float* twi,
                              long long rows, int log2_n,
                              int log2_block_rows, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (log2_n <= kLog2Seg) {
    const int log2_total = log2_n + log2_block_rows;
    const int smem = 2 * pifft::padded_floats(1 << log2_total) *
                     static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(gpu_rows_short,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int groups = 1 << (log2_total > 4 ? log2_total - 4 : 0);
    const int threads =
        groups < 32 ? 32 : (groups > kMaxThreads ? kMaxThreads : groups);
    const unsigned int blocks =
        static_cast<unsigned int>(rows >> log2_block_rows);
    gpu_rows_short<<<blocks, threads, smem, s>>>(xr, xi, yr, yi, twr, twi,
                                                 log2_n, log2_block_rows);
    return static_cast<int>(cudaGetLastError());
  }
  switch (log2_n - kLog2Seg) {
    case 1: err = launch_cluster<1>(xr, xi, yr, yi, twr, twi, rows,
                                    log2_block_rows, s); break;
    case 2: err = launch_cluster<2>(xr, xi, yr, yi, twr, twi, rows,
                                    log2_block_rows, s); break;
    case 3: err = launch_cluster<3>(xr, xi, yr, yi, twr, twi, rows,
                                    log2_block_rows, s); break;
    case 4: err = launch_cluster<4>(xr, xi, yr, yi, twr, twi, rows,
                                    log2_block_rows, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
