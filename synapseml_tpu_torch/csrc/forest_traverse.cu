// Fused forest traversal for Hopper (sm_90a): walk every row of x [N, F]
// through all T trees of a stacked ensemble and add value[leaf] of tree t
// into output column t % k.
//
// Replaces synapseml_tpu/gbdt/pallas_kernels.py predict_forest_tpu
// (_traverse_kernel). The TPU kernel turns every per-row gather into a
// one-hot select plus a lane reduce over VMEM-resident tree planes,
// because the VPU has no gather. On the card a gather is a plain load, so
// this kernel walks the trees directly, one thread per row.
//
// What bounds it: the bytes it must move are x once (N*F*4), the output
// once (N*k*4) and the tree planes once (T*M*20, ~122 KB for 100 trees of
// 61 nodes), so it is memory-bound in principle. In practice every row
// repeats a walk step (read the node, read x[row, feat], compare, pick the
// child) at every level of every tree, and the step's loads are what
// limit it. The design makes the step cheap:
// - Tree planes live in shared memory, one 8-byte record a node: thr, and
//   one word holding feat (10 bits) and the two children as offsets in
//   their tree (11 bits each). A warp's record loads take half the
//   shared-memory wavefronts of a 16-byte (feat, thr, left, right) record,
//   which was slower in a trial. value sits in a plane of its own, read
//   once a tree. The records are rewritten as they are staged, so the walk
//   checks nothing: feat clamped into range, children clamped into the
//   tree, and a leaf made a node whose feature is 0 and whose two children
//   are itself, so walking on stays there; a step with no walk moving ends
//   the walk early.
// - The block's x rows (one a thread) are staged in shared memory with
//   coalesced loads instead of a strided read per thread.
// - Where the forest fits (the 100 x 61 GBDT model, 73 KB) it is staged
//   once per block, and the block's threads then walk row tile after row
//   tile (blocks are persistent: as many as fit on the card at once).
//   Else (the isolation forest's 100 x 511) trees come in tiles of whole
//   trees: the next tile's raw planes arrive by cp.async while the current
//   tile is walked, and are rewritten into the walk buffer between tiles.
// - Each thread walks four trees of one output column at once and adds
//   their leaf values in increasing t, so the four chains overlap and the
//   sums keep their tree order.
// A forest with trees of more than 2,048 nodes, or rows of more than 1,024
// features or too wide for shared memory, is walked by a direct kernel (one
// thread per row, planes and x read through the read-only cache) with the
// same numerics.
//
// Numerics: each row's sums are taken in tree order t = c, c+k, c+2k, ...
// for column c, by one thread, with no atomics, so the result is bitwise
// equal to the plain PyTorch version and to the JAX reference. Across tree
// tiles the running sum is carried in the output itself, read back and
// written by its owner. A walk stops after `depth` steps wherever it is,
// as the plain version does. The tree weights are folded into `value` by
// the caller, so the kernel only adds; do not build with --use_fast_math
// (NaN must compare false and go right).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxRows = 1024;  // rows of a tile, one thread each
constexpr int kIlp = 4;         // trees walked at once by one thread
constexpr int kFeatBits = 10;   // a record's word: feat | left | right
constexpr int kChildBits = 11;
constexpr int kNodeBytes = 12;  // an 8-byte record and a 4-byte value
constexpr int kRawBytes = 20;   // a node's five raw planes

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

// Node `rel` of its tree as the walk reads it (see the note at the top);
// le, ri: its children, already clamped into the tree.
__device__ __forceinline__ int2 walk_record(int rel, int fe, float th,
                                            int le, int ri, int f) {
  const unsigned links =
      fe < 0 ? (static_cast<unsigned>(rel) << kFeatBits) |
                   (static_cast<unsigned>(rel) << (kFeatBits + kChildBits))
             : static_cast<unsigned>(min(fe, f - 1)) |
                   (static_cast<unsigned>(le) << kFeatBits) |
                   (static_cast<unsigned>(ri) << (kFeatBits + kChildBits));
  return make_int2(__float_as_int(th), static_cast<int>(links));
}

__device__ __forceinline__ int clamp_child(int c, int m) {
  return min(max(c, 0), m - 1);
}

// Walk W trees at once, tree i from node[i] of the tree whose records
// start at root[i], at most `depth` steps; node[i] ends where the plain
// version's `depth` steps leave it (a leaf is its own child, so once no
// walk moves, none will).
template <int W, bool STRICT>
__device__ __forceinline__ void walk(const int2* nodes, const float* xr,
                                     int depth, const int* root, int* node) {
  constexpr unsigned kChildMask = (1u << kChildBits) - 1u;
  for (int s = 0; s < depth; ++s) {
    bool moved = false;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int2 nd = nodes[root[i] + node[i]];
      const unsigned links = static_cast<unsigned>(nd.y);
      const float xv = xr[links & ((1u << kFeatBits) - 1u)];
      const float th = __int_as_float(nd.x);
      const bool go_left = STRICT ? xv < th : xv <= th;
      const int nxt = static_cast<int>(
          (links >> (go_left ? kFeatBits : kFeatBits + kChildBits)) &
          kChildMask);
      moved |= nxt != node[i];
      node[i] = nxt;
    }
    if (!moved) break;
  }
}

template <bool STRICT>
__global__ void __launch_bounds__(kMaxRows) forest_tiled_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ feat,
    const float* __restrict__ thr, const int32_t* __restrict__ left,
    const int32_t* __restrict__ right, const float* __restrict__ value,
    float* __restrict__ out, int n, int f, int t, int m, int k, int depth,
    int tile_trees, int n_tiles, int x_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_per_tile = blockDim.x;
  const int tile_nodes = tile_trees * m;
  int2* s_nodes = reinterpret_cast<int2*>(smem);
  float* s_value = reinterpret_cast<float*>(s_nodes + tile_nodes);
  float* s_x = s_value + tile_nodes;
  // n_tiles > 1: two buffers of raw planes (feat, thr, left, right, value)
  int32_t* s_raw = reinterpret_cast<int32_t*>(s_x + rows_per_tile * x_stride);
  const int tid = threadIdx.x;
  const int row_tiles = (n + rows_per_tile - 1) / rows_per_tile;
  const int my_tiles = (row_tiles - static_cast<int>(blockIdx.x) +
                        static_cast<int>(gridDim.x) - 1) /
                       static_cast<int>(gridDim.x);
  const int steps = my_tiles * n_tiles;  // (row tile, tree tile) pairs

  auto tile_count = [&](int j) {
    return (min(t, (j + 1) * tile_trees) - j * tile_trees) * m;
  };
  auto stage_raw = [&](int j, int buf) {  // tree tile j, by cp.async
    int32_t* dst = s_raw + buf * 5 * tile_nodes;
    const size_t g = static_cast<size_t>(j) * tile_nodes;
    for (int i = tid, count = tile_count(j); i < count; i += rows_per_tile) {
      cp_async4(dst + i, feat + g + i);
      cp_async4(dst + tile_nodes + i, thr + g + i);
      cp_async4(dst + 2 * tile_nodes + i, left + g + i);
      cp_async4(dst + 3 * tile_nodes + i, right + g + i);
      cp_async4(dst + 4 * tile_nodes + i, value + g + i);
    }
    cp_async_commit();
  };

  if (n_tiles == 1) {  // the whole forest, once
    for (int i = tid; i < t * m; i += rows_per_tile) {
      s_nodes[i] = walk_record(i % m, __ldg(feat + i), __ldg(thr + i),
                               clamp_child(__ldg(left + i), m),
                               clamp_child(__ldg(right + i), m), f);
      s_value[i] = __ldg(value + i);
    }
  } else if (steps > 0) {
    stage_raw(0, 0);
  }
  for (int q = 0; q < steps; ++q) {
    const int j = q % n_tiles;
    const int row0 = (static_cast<int>(blockIdx.x) +
                      (q / n_tiles) * static_cast<int>(gridDim.x)) *
                     rows_per_tile;
    if (n_tiles > 1) {
      if (q + 1 < steps) {
        stage_raw((q + 1) % n_tiles, (q + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    if (j == 0) {  // this row tile's x rows, coalesced
      __syncthreads();  // every walk of the previous row tile is done
      const int rows = min(rows_per_tile, n - row0);
      const float* src = x + static_cast<size_t>(row0) * f;
      for (int e = tid; e < rows * f; e += rows_per_tile) {
        const int rr = e / f;
        s_x[rr * x_stride + (e - rr * f)] = __ldg(src + e);
      }
    }
    __syncthreads();  // x, and tile j's raw planes, are in shared memory
    if (n_tiles > 1) {  // rewrite tile j for the walk
      const int32_t* raw = s_raw + (q & 1) * 5 * tile_nodes;
      for (int i = tid, count = tile_count(j); i < count;
           i += rows_per_tile) {
        s_nodes[i] = walk_record(i % m, raw[i],
                                 __int_as_float(raw[tile_nodes + i]),
                                 clamp_child(raw[2 * tile_nodes + i], m),
                                 clamp_child(raw[3 * tile_nodes + i], m), f);
        s_value[i] = __int_as_float(raw[4 * tile_nodes + i]);
      }
      __syncthreads();
    }
    const int row = row0 + tid;
    if (row < n) {
      const float* xr = s_x + tid * x_stride;
      const int t0 = j * tile_trees;
      const int t1 = min(t, t0 + tile_trees);
      float* outr = out + static_cast<size_t>(row) * k;
      for (int c = 0; c < k; ++c) {
        float acc = j == 0 ? 0.0f : outr[c];
        int ti = t0 + ((c - t0 % k) % k + k) % k;  // first tree of column c
        for (; ti + (kIlp - 1) * k < t1; ti += kIlp * k) {
          int root[kIlp], node[kIlp];
#pragma unroll
          for (int i = 0; i < kIlp; ++i) {
            root[i] = (ti + i * k - t0) * m;
            node[i] = 0;
          }
          walk<kIlp, STRICT>(s_nodes, xr, depth, root, node);
#pragma unroll
          for (int i = 0; i < kIlp; ++i) acc += s_value[root[i] + node[i]];
        }
        for (; ti < t1; ti += k) {
          int root = (ti - t0) * m, node = 0;
          walk<1, STRICT>(s_nodes, xr, depth, &root, &node);
          acc += s_value[root + node];
        }
        outr[c] = acc;
      }
    }
    if (n_tiles > 1) __syncthreads();  // tile j's walk buffer is rewritten next
  }
}

template <bool STRICT>
__global__ void forest_direct_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ feat,
    const float* __restrict__ thr, const int32_t* __restrict__ left,
    const int32_t* __restrict__ right, const float* __restrict__ value,
    float* __restrict__ out, int n, int f, int t, int m, int k, int depth) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float* xr = x + static_cast<size_t>(row) * f;
  float* outr = out + static_cast<size_t>(row) * k;
  for (int c = 0; c < k; ++c) {
    float acc = 0.0f;
    for (int ti = c; ti < t; ti += k) {
      const size_t base = static_cast<size_t>(ti) * m;
      int node = 0;
      for (int s = 0; s < depth; ++s) {
        const int fi = __ldg(feat + base + node);
        if (fi < 0) break;  // leaf: the walk stays here
        const float xv = __ldg(xr + min(fi, f - 1));
        const float th = __ldg(thr + base + node);
        const bool go_left = STRICT ? (xv < th) : (xv <= th);
        const int nxt = go_left ? __ldg(left + base + node)
                                : __ldg(right + base + node);
        node = min(max(nxt, 0), m - 1);
      }
      acc += __ldg(value + base + node);
    }
    outr[c] = acc;
  }
}

template <bool STRICT>
int launch(const float* x, const int32_t* feat, const float* thr,
           const int32_t* left, const int32_t* right, const float* value,
           float* out, int n, int f, int t, int m, int k, int depth,
           cudaStream_t s) {
  int dev = 0, smem_max = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int x_stride = f | 1;  // odd: one row's features span all banks
  const long long tree = static_cast<long long>(m) * kNodeBytes;
  // a tree in a tile: its walk records and two buffers of raw planes
  const long long multi = static_cast<long long>(m) *
                          (kNodeBytes + 2 * kRawBytes);
  // Rows a block: the most whose tiles still reach 7/8 of the SMs, else
  // the fewest; with them the whole forest (staged once), else tiles of
  // whole trees.
  int rows = 0, tile_trees = 0, n_tiles = 0;
  long long smem = 0;
  for (int r = kMaxRows; r >= 128; r /= 2) {
    const long long x_bytes = static_cast<long long>(r) * x_stride * 4;
    const long long avail = smem_max - x_bytes;
    if (avail >= tree * t) {
      rows = r;
      tile_trees = t;
      n_tiles = 1;
      smem = x_bytes + tree * t;
    } else if (avail >= multi) {
      rows = r;
      tile_trees = static_cast<int>(avail / multi);
      n_tiles = (t + tile_trees - 1) / tile_trees;
      smem = x_bytes + multi * tile_trees;
    } else {
      continue;
    }
    if ((n + r - 1) / r * 8LL >= 7LL * sms) break;
  }
  if (n_tiles == 0 || m > (1 << kChildBits) || f > (1 << kFeatBits)) {
    const int threads = 256;
    forest_direct_kernel<STRICT><<<(n + threads - 1) / threads, threads, 0,
                                   s>>>(x, feat, thr, left, right, value, out,
                                        n, f, t, m, k, depth);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(
      forest_tiled_kernel<STRICT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, forest_tiled_kernel<STRICT>, rows, static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (n + rows - 1) / rows;
  const int blocks = std::min(row_tiles, std::max(per_sm, 1) * sms);
  forest_tiled_kernel<STRICT><<<blocks, rows, static_cast<size_t>(smem), s>>>(
      x, feat, thr, left, right, value, out, n, f, t, m, k, depth, tile_trees,
      n_tiles, x_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int forest_traverse_launch(
    const void* x, const void* feat, const void* thr, const void* left,
    const void* right, const void* value, void* out, int n, int f, int t,
    int m, int k, int depth, int strict, void* stream) {
  auto* xp = static_cast<const float*>(x);
  auto* fp = static_cast<const int32_t*>(feat);
  auto* tp = static_cast<const float*>(thr);
  auto* lp = static_cast<const int32_t*>(left);
  auto* rp = static_cast<const int32_t*>(right);
  auto* vp = static_cast<const float*>(value);
  auto* op = static_cast<float*>(out);
  auto* s = static_cast<cudaStream_t>(stream);
  return strict ? launch<true>(xp, fp, tp, lp, rp, vp, op, n, f, t, m, k,
                               depth, s)
                : launch<false>(xp, fp, tp, lp, rp, vp, op, n, f, t, m, k,
                                depth, s);
}
