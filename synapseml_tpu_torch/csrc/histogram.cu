// Deterministic feature histogram for Hopper (sm_90a): for every feature f
// and bin b, out[f, b, :] = the sum of data[r, :] over the rows r with
// binned[r, f] == b, taken in row order.
//
// Replaces synapseml_tpu/gbdt/pallas_kernels.py histogram_tpu (_hist_kernel).
// The TPU kernel keeps an [F, 3, B] accumulator in VMEM across a
// sequential grid over row chunks and turns each chunk into F one-hot MXU
// dots with a bf16 hi/lo split of the data. On the card blocks run in no
// order and a float atomic would add rows in an order that changes from
// run to run, which flips near-tied split gains. So each (feature, bin)
// is owned by one thread, which adds the rows of its bin in row order in
// f32 registers: the result is bitwise the sequential sum that the plain
// PyTorch version (index_add_ on the CPU) and the JAX reference compute,
// and two launches on the same inputs are bitwise equal.
//
// Layout: one block per (feature, tile of 128 bins), one warp per 32 bins
// (lane l owns bin warp_lo + l). The block streams the rows in order
// through shared memory in tiles of kTileRows (the feature's bin column
// and the [rows, 3] data). A warp takes the tile's rows 32 at a time:
// lane j reads the bin of row i + j, one ballot marks the rows whose bin
// is one of the warp's 32, and the warp walks those hits from the lowest
// row up; at each hit the lane that owns the row's bin adds its three
// values. So every lane sees its rows in row order.
//
// What bounds it: the bytes it must move are the bins once, the data once
// and the output once (0.89 MB at N=32,561, F=14, B=256: 0.27 us at
// 3.35 TB/s), but every warp looks at all N rows of its feature and takes
// its hits one after another, so its time is a serial walk of N/32 ballots
// plus one short dependent chain per hit (about N/8 hits a warp at
// B=256): latency, not bytes. That is the price of the row order; a later
// design can sort rows by bin once per fit and walk only a bin's rows.
// Masked rows carry zero data; adding +-0 to a sum leaves it unchanged.
// Bins >= n_bins are ignored. Do not build with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kBinsPerBlock = 32 * kWarps;
constexpr int kTileRows = 2048;

template <typename BinT>
__global__ void __launch_bounds__(kBinsPerBlock) histogram_kernel(
    const BinT* __restrict__ binned, const float* __restrict__ data,
    float* __restrict__ out, int n, int f, int n_bins) {
  __shared__ BinT s_bin[kTileRows];
  __shared__ float s_data[3 * kTileRows];
  const int feat = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp_lo = blockIdx.y * kBinsPerBlock + (threadIdx.x & ~31);
  float g = 0.0f, h = 0.0f, c = 0.0f;
  for (int r0 = 0; r0 < n; r0 += kTileRows) {
    const int rows = min(kTileRows, n - r0);
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      s_bin[i] = binned[static_cast<size_t>(r0 + i) * f + feat];
    }
    const float* src = data + static_cast<size_t>(r0) * 3;
    for (int i = threadIdx.x; i < 3 * rows; i += blockDim.x) {
      s_data[i] = src[i];
    }
    __syncthreads();
    for (int i = 0; i < rows; i += 32) {
      const int row = i + lane;
      const unsigned rel =
          row < rows ? static_cast<unsigned>(
                           static_cast<int>(s_bin[row]) - warp_lo)
                     : 32u;
      unsigned hits = __ballot_sync(0xffffffffu, rel < 32u);
      while (hits != 0u) {  // the same on every lane: lowest row first
        const int j = __ffs(hits) - 1;
        hits &= hits - 1u;
        const int owner = __shfl_sync(0xffffffffu, static_cast<int>(rel), j);
        if (owner == lane) {
          const float* d = s_data + 3 * (i + j);
          g += d[0];
          h += d[1];
          c += d[2];
        }
      }
    }
  }
  const int b = warp_lo + lane;
  if (b < n_bins) {
    float* o = out + (static_cast<size_t>(feat) * n_bins + b) * 3;
    o[0] = g;
    o[1] = h;
    o[2] = c;
  }
}

}  // namespace

// binned: [n, f] uint8 (bin_bytes 1) or uint16 (bin_bytes 2), row-major;
// data: [n, 3] f32; out: [f, n_bins, 3] f32, every entry written.
extern "C" int histogram_launch(const void* binned, int bin_bytes,
                                const void* data, void* out, int n, int f,
                                int n_bins, void* stream) {
  const dim3 grid(f, (n_bins + kBinsPerBlock - 1) / kBinsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(data);
  float* op = static_cast<float*>(out);
  if (bin_bytes == 1) {
    histogram_kernel<uint8_t><<<grid, kBinsPerBlock, 0, s>>>(
        static_cast<const uint8_t*>(binned), dp, op, n, f, n_bins);
  } else if (bin_bytes == 2) {
    histogram_kernel<uint16_t><<<grid, kBinsPerBlock, 0, s>>>(
        static_cast<const uint16_t*>(binned), dp, op, n, f, n_bins);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
