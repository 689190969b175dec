// Deterministic feature histogram for Hopper (sm_90a), bin-sorted: for
// every feature f and bin b, out[f, b, :] = the sum of data[r, :] over the
// rows r with binned[r, f] == b, taken in row order.
//
// Replaces synapseml_tpu/gbdt/pallas_kernels.py histogram_tpu (_hist_kernel).
// The TPU kernel keeps an [F, 3, B] accumulator in VMEM across a
// sequential grid over row chunks and turns each chunk into F one-hot MXU
// dots with a bf16 hi/lo split of the data. On the card blocks run in no
// order and a float atomic would add rows in an order that changes from
// run to run, which flips near-tied split gains. So each (feature, bin)
// is owned by one warp, which adds the rows of its bin in row order in
// f32 registers: the result is bitwise the sequential sum that the plain
// PyTorch version (index_add_ on the CPU) and the JAX reference compute,
// and two launches on the same inputs are bitwise equal.
//
// The bins never change during a fit, so the caller sorts the rows by bin
// once (gbdt/kernels.py bin_index: for each feature the row ids stably
// sorted by bin, and where each bin's segment starts). This kernel reads
// only that index and the data, never the bins, so uint8 and uint16 bins
// reach it alike.
//
// Layout: one warp per (feature, bin) segment of the index. The warp
// takes its segment 32 rows at a time: lane l reads row id i + l (one
// 128-byte read), then gathers that row's three values (data is small and
// stays in L2 across the launches of a fit). One ballot marks the rows
// whose three values are not all == 0, and those are packed in row order
// into the warp's shared buffer, a column after another; lane c < 3 then
// adds column c of the packed rows in order, four values a load. A masked
// row carries zeros, and adding +-0 to a sum that starts at +0 leaves it
// bitwise unchanged, so skipping it is exact (NaN != 0, so a NaN row is
// kept and propagates). The gathers of the next two chunks, and the row
// ids of the two after, are in flight in registers while a chunk's adds
// run.
//
// What bounds it: the bytes the function must move are the bins once, the
// data once and the output once (0.89 MB at N=32,561, F=14, B=256: 0.27 us
// at 3.35 TB/s). This design moves the index (4 bytes a row and feature)
// and gathers 12 bytes a row and feature from L2; with evenly spread bins
// (about N / B rows a segment) the warps are short and many, and the
// launch and the gathers set its time. A segment's adds are one chain, so
// the launch lasts at least as long as the longest segment's walk: where
// one bin holds most rows, that one warp's chunks one after another, each
// many times the 32 adds' own latency (a ring of cp.async copies in shared
// memory did better there in a trial, and worse where bins are spread, so
// the main path keeps the registers). Bins >= n_bins lie past the last
// segment and are ignored. No atomics; do not build with --use_fast_math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kAhead = 2;  // chunks of 32 rows in flight per warp

// acc += col[0], col[1], ... col[count - 1], in that order; col is
// 16-byte aligned, so whole groups of four come in one load each, and
// every load of a full chunk is issued before its adds.
__device__ __forceinline__ void add_column(const float* col, int count,
                                           float& acc) {
  const float4* c4 = reinterpret_cast<const float4*>(col);
  if (count == 32) {
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = c4[u];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc += v[u].x;
      acc += v[u].y;
      acc += v[u].z;
      acc += v[u].w;
    }
    return;
  }
  int j = 0;
  for (; j + 4 <= count; j += 4) {
    const float4 v = c4[j / 4];
    acc += v.x;
    acc += v.y;
    acc += v.z;
    acc += v.w;
  }
  for (; j < count; ++j) acc += col[j];
}

__global__ void __launch_bounds__(32 * kWarps) histogram_kernel(
    const int32_t* __restrict__ order, const int32_t* __restrict__ start,
    const float* __restrict__ data, float* __restrict__ out, int n,
    int n_segments, int n_bins) {
  __shared__ __align__(16) float s_rows[kWarps][32 * 3];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = blockIdx.x * kWarps + warp;
  if (seg >= n_segments) return;  // the whole warp: no block barrier below
  const int feat = seg / n_bins;
  const int bin = seg - feat * n_bins;
  const int32_t* ord = order + static_cast<size_t>(feat) * n;
  const int32_t* st = start + static_cast<size_t>(feat) * (n_bins + 1);
  const int lo = st[bin];
  const int hi = st[bin + 1];
  float* rows = s_rows[warp];
  const unsigned below = (1u << lane) - 1u;

  // slot s holds the values of chunk c (c % kAhead == s) and the row id
  // of chunk c + kAhead, so kAhead chunks of gathers are in flight
  float d[kAhead][3];
  int next[kAhead];
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    const int i = lo + 32 * s + lane;
    d[s][0] = d[s][1] = d[s][2] = 0.0f;
    if (i < hi) {
      const float* p = data + 3 * static_cast<size_t>(ord[i]);
      d[s][0] = __ldg(p);
      d[s][1] = __ldg(p + 1);
      d[s][2] = __ldg(p + 2);
    }
    next[s] = i + 32 * kAhead < hi ? ord[i + 32 * kAhead] : -1;
  }
  float acc = 0.0f;  // lane c < 3: column c
  for (int base = lo; base < hi; base += 32 * kAhead) {
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int b = base + 32 * s;  // the same on every lane
      if (b < hi) {
        const bool keep = b + lane < hi &&
                          !(d[s][0] == 0.0f && d[s][1] == 0.0f &&
                            d[s][2] == 0.0f);
        const unsigned kept = __ballot_sync(0xffffffffu, keep);
        __syncwarp();  // every lane is done reading the previous chunk
        if (keep) {
          float* q = rows + __popc(kept & below);
          q[0] = d[s][0];
          q[32] = d[s][1];
          q[64] = d[s][2];
        }
        if (next[s] >= 0) {  // refill the slot: chunk + kAhead
          const float* p = data + 3 * static_cast<size_t>(next[s]);
          d[s][0] = __ldg(p);
          d[s][1] = __ldg(p + 1);
          d[s][2] = __ldg(p + 2);
        }
        const int i = b + 64 * kAhead + lane;
        next[s] = i < hi ? ord[i] : -1;
        __syncwarp();
        if (lane < 3) add_column(rows + 32 * lane, __popc(kept), acc);
      }
    }
  }
  if (lane < 3) out[static_cast<size_t>(seg) * 3 + lane] = acc;
}

}  // namespace

// order: [f, n] int32, each feature's row ids stably sorted by bin;
// start: [f, n_bins + 1] int32, where bin b's rows begin in its row of
// order (start[f, n_bins] ends the last segment); data: [n, 3] f32;
// out: [f, n_bins, 3] f32, every entry written.
extern "C" int histogram_launch(const void* order, const void* start,
                                const void* data, void* out, int n, int f,
                                int n_bins, void* stream) {
  const long long n_segments = static_cast<long long>(f) * n_bins;
  if (n_segments <= 0 || n_segments > 0x7fffffffLL - kWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>((n_segments + kWarps - 1) / kWarps);
  histogram_kernel<<<blocks, 32 * kWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(start),
      static_cast<const float*>(data), static_cast<float*>(out), n,
      static_cast<int>(n_segments), n_bins);
  return static_cast<int>(cudaGetLastError());
}
