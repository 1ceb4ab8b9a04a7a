// Secretion into the diffusion grid on Hopper, in slot order: for every
// voxel v, out[v] = (((conc[v] + a_i0) + a_i1) + ...) with i0 < i1 < ...
// the rows whose voxel is v, each sum rounded with __fadd_rn.
//
// A port kernel with no TPU counterpart. It replaces what the reference
// computes with an XLA scatter-add (repro/core/diffusion.py::add_sources,
// conc.at[...].add(amount), which XLA:CPU applies in slot order); the
// plain version is torch's index_add on the CPU, which adds in the same
// order. On the card index_add adds by atomics in no fixed order, so two
// runs of one step could differ in the last bits of the grid.
//
// The voxel of a row is core/diffusion.py's voxel_of, computed here:
// floor((p - origin) * float32(1/voxel)) with no FMA, clamped to
// [0, d - 1] per axis; an ensemble's row in lane l = row / lane_rows adds
// into its own grid, key = l * V + (x * dy + y) * dz + z over the (L*V,)
// stack (core/diffusion.py's _flat). Every voxel of `out` is written once,
// untouched ones with conc[v], so the caller needs no copy of the grid.
//
// Bound. Bytes: position and amount read once, the grid read and written
// once. The order costs what the bound does not count: the rows are
// grouped by voxel, stably, before each voxel's chain of adds, and a chain
// is serial (a voxel with 8,192 rows is 8,192 dependent adds).
//
// Design: two paths, chosen here from the shapes alone (no host read).
//
// Local path (n_rows = 0, or at most kLocalRows rows a lane and at most
// kLocalVisits row visits in all): ONE launch. A block owns kLocal
// consecutive voxels of the stack: it walks the rows of the lanes those
// voxels belong to in slot order, kLocal rows at a time, computes each
// row's key, packs the rows that fall in its voxels into shared memory in
// slot order (ballot + popc + the warps' counts), and each thread folds
// the packed amounts of its own voxel from shared memory, then writes its
// voxel. The addends are in shared memory before the chain reads them, and
// the chain of a voxel is the only serial part. A lane's rows are read by
// every block of the lane's voxels (from the L2), hence the limits: the
// clustering run (4,000 rows into 32^3 voxels, 128 blocks) visits 512,000
// rows, 8 lanes of it 4,096,000.
//
// Radix path (otherwise): keys, P stable passes, a fold; P + 2 launches.
//  1. keys_kernel: a tile of kTile rows a block computes each key (int32)
//     and the tile's histogram of the first digit, aggregated per warp
//     with __match_any_sync; it zeroes the later passes' histograms.
//  2. scatter_kernel, once per digit: an LSD radix pass over the B =
//     ceil(log2(L*V)) key bits that L*V needs (15 at 32^3, 3 at 8 voxels;
//     none at one voxel), in P = ceil(B / 8) digits of at most 8 bits. A
//     block reads every tile's digit counts for this pass and sums the
//     tiles before its own (the scan over the tiles); each warp ranks its
//     512 consecutive rows by digit in slot order (__match_any_sync: a
//     row's rank is the warp's earlier count of its digit plus its peers
//     in lower lanes), the warps' counts are scanned in warp order, the
//     tile is laid out by digit in shared memory and leaves in runs of
//     consecutive addresses. Each pass is stable, so the last one leaves
//     the rows grouped by voxel in slot order. The pass also counts the
//     next digit per destination tile (one atomic per peer group).
//  3. fold_kernel: a voxel's rows are the run [lower_bound(v),
//     lower_bound(v + 1)) of the sorted keys. Where rows average below
//     256 a voxel, a warp takes 32 voxels and each lane folds its own
//     (8 loads ahead of its chain); a run longer than kLongRun is folded by
//     the whole warp: 128 addends a round come in by coalesced loads one
//     round ahead, and every lane runs the same chain over __shfl_sync'd
//     values, so the chain waits on the add, not on memory. Where rows
//     average 256 or more a voxel (65,536 rows into 8 voxels), a warp
//     takes one voxel that way.
//
// Layout: position (n_rows, 3) f32; amount (n_rows,) f32; origin (3,)
// f32; conc, out (total_voxels,) f32 = (L, X, Y, Z) grids; scratch:
// none on the local path, else 16 * n_rows + 4 * P * tiles * 256 bytes
// (two key and two amount buffers, the digit counts of each pass), as
// secretion_scratch_bytes reports.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// the local path
constexpr int kLocal = 256;                   // voxels and threads a block
constexpr int kLocalWarps = kLocal / 32;
constexpr int kLocalRows = 8192;              // rows a lane, at most
constexpr long long kLocalVisits = 1LL << 23; // blocks x rows a lane

// the radix path
constexpr int kSortThreads = 512;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kItems = 16;                    // rows a thread
constexpr int kTile = kSortThreads * kItems;  // rows a block
constexpr int kWarpRows = kTile / kSortWarps; // consecutive rows a warp
constexpr int kMaxBits = 8;
constexpr int kMaxBins = 1 << kMaxBits;
constexpr int kFoldThreads = 256;
constexpr int kLongRun = 256;
constexpr int kWarpPerVoxelAt = 256;          // average rows a voxel

static_assert(kWarpRows == 32 * kItems, "a warp ranks kItems rounds");

struct Layout {
  const float* origin;
  float recip;
  int dim_x, dim_y, dim_z;
  int voxels;                                 // one lane's grid
  int lane_rows;
};

// core/diffusion.py: voxel_of, then _flat with the lane's offset
__device__ __forceinline__ int voxel_key(const float* __restrict__ position,
                                         int i, const Layout& g) {
  const float* p = position + 3LL * i;
  const int d[3] = {g.dim_x, g.dim_y, g.dim_z};
  int v[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float rel = __fmul_rn(__fsub_rn(p[a], g.origin[a]), g.recip);
    v[a] = min(max(__float2int_rd(rel), 0), d[a] - 1);
  }
  return (i / g.lane_rows) * g.voxels + (v[0] * g.dim_y + v[1]) * g.dim_z
         + v[2];
}

// digit p of P over B key bits: widths ceil-first, summing to B
__host__ __device__ inline int digit_bits(int key_bits, int passes, int p) {
  return (key_bits + passes - 1 - p) / passes;
}

template <int kWarps>
__device__ int block_exclusive_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int off = incl - v;
  for (int w = 0; w < warp; ++w) off += s_warp[w];
  __syncthreads();
  return off;
}

__global__ void __launch_bounds__(kLocal)
local_kernel(const float* __restrict__ position,
             const float* __restrict__ amount, int n_rows, Layout g,
             int total_voxels, const float* __restrict__ conc,
             float* __restrict__ out) {
  __shared__ int s_vox[kLocal];
  __shared__ float s_amt[kLocal];
  __shared__ int s_count[2][kLocalWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int v0 = blockIdx.x * kLocal;
  const int v1 = min(v0 + kLocal, total_voxels);
  const int v = v0 + t;
  float acc = v < total_voxels ? conc[v] : 0.f;
  // the rows of the lanes of voxels [v0, v1)
  const int r0 = (v0 / g.voxels) * g.lane_rows;
  const int r1 = min(((v1 - 1) / g.voxels + 1) * g.lane_rows, n_rows);
  const unsigned lower = (1u << lane) - 1u;
  int parity = 0;
  for (int base = r0; base < r1; base += kLocal, parity ^= 1) {
    const int i = base + t;
    const int key = i < r1 ? voxel_key(position, i, g) : -1;
    const bool mine = key >= v0 && key < v1;
    const unsigned m = __ballot_sync(kFull, mine);
    // counts double-buffered: a round with nothing to fold skips the
    // second barrier, and the next round writes the other buffer
    if (lane == 0) s_count[parity][warp] = __popc(m);
    __syncthreads();
    int at = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kLocalWarps; ++w) {
      const int c = s_count[parity][w];
      at += w < warp ? c : 0;
      total += c;
    }
    if (total == 0) continue;                  // the whole block
    if (mine) {
      at += __popc(m & lower);
      s_vox[at] = key - v0;
      s_amt[at] = amount[i];
    }
    __syncthreads();
    int j = 0;
    for (; j + 4 <= total; j += 4) {
      int k[4];
      float a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        k[u] = s_vox[j + u];
        a[u] = s_amt[j + u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k[u] == t) acc = __fadd_rn(acc, a[u]);
    }
    for (; j < total; ++j)
      if (s_vox[j] == t) acc = __fadd_rn(acc, s_amt[j]);
  }
  if (v < total_voxels) out[v] = acc;
}

__global__ void __launch_bounds__(kSortThreads)
keys_kernel(const float* __restrict__ position, int n_rows, Layout g,
            int key_bits, int passes, int tiles, int* __restrict__ keys,
            int* __restrict__ hist) {
  __shared__ int s_hist[kMaxBins];
  const int t = threadIdx.x, lane = t & 31, tile = blockIdx.x;
  const int bins = passes > 0 ? 1 << digit_bits(key_bits, passes, 0) : 1;
  if (t < kMaxBins) s_hist[t] = 0;
  __syncthreads();
#pragma unroll 4
  for (int j = 0; j < kItems; ++j) {
    const int i = tile * kTile + j * kSortThreads + t;
    int code = kMaxBins + lane;               // a lane without a row
    if (i < n_rows) {
      const int key = voxel_key(position, i, g);
      keys[i] = key;
      code = key & (bins - 1);
    }
    const unsigned peers = __match_any_sync(kFull, code);
    if (code < kMaxBins && lane == __ffs(peers) - 1)
      atomicAdd(&s_hist[code], __popc(peers));
  }
  __syncthreads();
  if (passes == 0) return;
  if (t < bins) hist[tile * bins + t] = s_hist[t];
  for (int p = 1; p < passes; ++p) {
    const int b = 1 << digit_bits(key_bits, passes, p);
    if (t < b) hist[p * tiles * kMaxBins + tile * b + t] = 0;
  }
}

__global__ void __launch_bounds__(kSortThreads)
scatter_kernel(const int* __restrict__ keys_in,
               const float* __restrict__ amt_in, int n_rows, int tiles,
               const int* __restrict__ hist, int shift, int bits,
               int* __restrict__ hist_next, int next_shift, int next_bits,
               int* __restrict__ keys_out, float* __restrict__ amt_out) {
  extern __shared__ int s_dyn[];
  int* s_key = s_dyn;                         // the tile by digit
  float* s_amt = reinterpret_cast<float*>(s_dyn + kTile);
  __shared__ int s_warp_bins[kSortWarps][kMaxBins];
  __shared__ int s_part_pre[kSortThreads], s_part_tot[kSortThreads];
  __shared__ int s_dst[kMaxBins];             // digit d's place in keys_out
  __shared__ int s_start[kMaxBins];           // digit d's place in the tile
  __shared__ int s_scan[kSortWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, tile = blockIdx.x;
  const int bins = 1 << bits, mask = bins - 1;

  // 1. every tile's count of each digit: the digits' totals, and this
  // tile's place after the earlier tiles (threads split the tiles)
  {
    const int parts = kSortThreads / bins, d = t % bins, part = t / bins;
    int pre = 0, tot = 0;
    for (int u = part; u < tiles; u += parts) {
      const int h = hist[u * bins + d];
      tot += h;
      pre += u < tile ? h : 0;
    }
    s_part_pre[t] = pre;
    s_part_tot[t] = tot;
  }
  for (int k = t; k < kSortWarps * kMaxBins; k += kSortThreads)
    (&s_warp_bins[0][0])[k] = 0;
  __syncthreads();
  int pre = 0, tot = 0;
  if (t < bins) {
    for (int part = 0; part < kSortThreads / bins; ++part) {
      pre += s_part_pre[part * bins + t];
      tot += s_part_tot[part * bins + t];
    }
  }
  const int digit_at = block_exclusive_scan<kSortWarps>(t < bins ? tot : 0,
                                                        s_scan);
  if (t < bins) s_dst[t] = digit_at + pre;

  // 2. each warp ranks its rows by digit, in slot order
  const unsigned lower = (1u << lane) - 1u;
  const int row0 = tile * kTile + warp * kWarpRows;
  int key[kItems], rank[kItems];
  float amt[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = row0 + 32 * j + lane;
    const bool valid = i < n_rows;
    key[j] = valid ? keys_in[i] : 0;
    amt[j] = valid ? amt_in[i] : 0.f;
    const int d = valid ? (key[j] >> shift) & mask : kMaxBins + lane;
    const unsigned peers = __match_any_sync(kFull, d);
    const int before = valid ? s_warp_bins[warp][d] : 0;
    __syncwarp();
    if (valid && lane == __ffs(peers) - 1)
      s_warp_bins[warp][d] = before + __popc(peers);
    __syncwarp();
    rank[j] = before + __popc(peers & lower);
  }
  __syncthreads();

  // 3. a digit's rows in the tile: the warps' in warp order
  int count = 0;
  if (t < bins) {
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = s_warp_bins[w][t];
      s_warp_bins[w][t] = count;
      count += c;
    }
  }
  const int start = block_exclusive_scan<kSortWarps>(t < bins ? count : 0,
                                                     s_scan);
  if (t < bins) s_start[t] = start;
  __syncthreads();

  // 4. the tile in digit order in shared memory
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (row0 + 32 * j + lane < n_rows) {
      const int d = (key[j] >> shift) & mask;
      const int at = s_start[d] + s_warp_bins[warp][d] + rank[j];
      s_key[at] = key[j];
      s_amt[at] = amt[j];
    }
  }
  __syncthreads();

  // 5. each digit's rows to their place, consecutive threads on
  // consecutive addresses; the next digit counted per destination tile
  const int n_tile = min(kTile, n_rows - tile * kTile);
  const int next_mask = (1 << next_bits) - 1;
#pragma unroll 4
  for (int j = 0; j < kItems; ++j) {
    const int at = j * kSortThreads + t;
    int code = -1 - lane;                     // matches no other lane
    if (at < n_tile) {
      const int k = s_key[at];
      const int d = (k >> shift) & mask;
      const int dst = s_dst[d] + at - s_start[d];
      keys_out[dst] = k;
      amt_out[dst] = s_amt[at];
      code = (dst / kTile) * (next_mask + 1) + ((k >> next_shift) & next_mask);
    }
    if (hist_next != nullptr) {
      const unsigned peers = __match_any_sync(kFull, code);
      if (code >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(hist_next + code, __popc(peers));
    }
  }
}

__device__ __forceinline__ int lower_bound(const int* __restrict__ keys,
                                           int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// acc folded with amt[lo, hi) in order by the whole warp: 128 addends a
// round by coalesced loads, the next round's issued before this round's
// chain; every lane runs the chain and returns the same value
__device__ float warp_fold(const float* __restrict__ amt, int lo, int hi,
                           float acc) {
  const int lane = threadIdx.x & 31;
  float x[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = lo + 32 * u + lane;
    x[u] = j < hi ? amt[j] : 0.f;
  }
  for (int base = lo; base < hi; base += 128) {
    float y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + 128 + 32 * u + lane;
      y[u] = j < hi ? amt[j] : 0.f;
    }
    const int m = hi - base;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int mu = m - 32 * u;
      if (mu >= 32) {
#pragma unroll
        for (int k = 0; k < 32; ++k)
          acc = __fadd_rn(acc, __shfl_sync(kFull, x[u], k));
      } else {
        for (int k = 0; k < mu; ++k)
          acc = __fadd_rn(acc, __shfl_sync(kFull, x[u], k));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = y[u];
  }
  return acc;
}

template <bool kWarpPerVoxel>
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const int* __restrict__ keys, const float* __restrict__ amt,
            int n, const float* __restrict__ conc, int total_voxels,
            float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kFoldThreads + threadIdx.x) >> 5;
  if (kWarpPerVoxel) {
    const int v = warp;
    if (v >= total_voxels) return;            // the whole warp
    const int lo = lower_bound(keys, n, v), hi = lower_bound(keys, n, v + 1);
    const float acc = warp_fold(amt, lo, hi, conc[v]);
    if (lane == 0) out[v] = acc;
    return;
  }
  if (warp * 32 >= total_voxels) return;      // the whole warp
  const int v = warp * 32 + lane;
  const bool mine = v < total_voxels;
  int lo = 0, hi = 0;
  float acc = 0.f;
  if (mine) {
    lo = lower_bound(keys, n, v);
    hi = lower_bound(keys, n, v + 1);
    acc = conc[v];
  }
  const bool long_run = hi - lo > kLongRun;
  if (!long_run) {
    int j = lo;
    for (; j + 8 <= hi; j += 8) {
      float a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) a[u] = amt[j + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, a[u]);
    }
    for (; j < hi; ++j) acc = __fadd_rn(acc, amt[j]);
  }
  unsigned todo = __ballot_sync(kFull, long_run);
  while (todo != 0) {
    const int k = __ffs(todo) - 1;
    todo &= todo - 1;
    const float a = warp_fold(amt, __shfl_sync(kFull, lo, k),
                              __shfl_sync(kFull, hi, k),
                              __shfl_sync(kFull, acc, k));
    if (lane == k) acc = a;
  }
  if (mine) out[v] = acc;
}

// the radix path's key bits and 8-bit passes; 0 bytes of scratch on the
// local path
struct Plan {
  int key_bits, passes;
  long long scratch;
};

Plan plan(int n_rows, int lane_rows, int total_voxels) {
  const long long local_blocks = (total_voxels + kLocal - 1) / kLocal;
  if (total_voxels <= 0 || n_rows == 0
      || (lane_rows <= kLocalRows
          && local_blocks * lane_rows <= kLocalVisits))
    return Plan{0, 0, 0};
  int key_bits = 0;
  while ((1LL << key_bits) < total_voxels) ++key_bits;
  const int passes = (key_bits + kMaxBits - 1) / kMaxBits;
  const long long tiles = (n_rows + kTile - 1) / kTile;
  return Plan{key_bits, passes,
              16LL * n_rows + 4LL * passes * tiles * kMaxBins};
}

}  // namespace

// Bytes of scratch secretion_add needs for these shapes: 0 where it takes
// the local path.
extern "C" long long secretion_scratch_bytes(int n_rows, int lane_rows,
                                             int total_voxels) {
  return plan(n_rows, lane_rows, total_voxels).scratch;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when `scratch_bytes` is below what the radix path
// needs. The caller checks shapes: 3 * n_rows < 2^31, total_voxels =
// (n_rows / lane_rows) * dim_x * dim_y * dim_z < 2^31 (any multiple of the
// grid when n_rows is 0), n_rows a multiple of lane_rows.
extern "C" int secretion_add(const float* position, const float* amount,
                             int n_rows, const float* origin, float recip,
                             int dim_x, int dim_y, int dim_z, int lane_rows,
                             const float* conc, int total_voxels, float* out,
                             void* scratch, long long scratch_bytes,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout g{origin, recip, dim_x, dim_y, dim_z, dim_x * dim_y * dim_z,
                 lane_rows};
  if (total_voxels <= 0) return 0;
  const Plan pl = plan(n_rows, lane_rows, total_voxels);
  if (pl.scratch == 0) {
    const int local_blocks = (total_voxels + kLocal - 1) / kLocal;
    local_kernel<<<local_blocks, kLocal, 0, s>>>(position, amount, n_rows, g,
                                                 total_voxels, conc, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int key_bits = pl.key_bits, passes = pl.passes;
  const int tiles = (n_rows + kTile - 1) / kTile;
  if (scratch_bytes < pl.scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  int* keys_a = static_cast<int*>(scratch);
  int* keys_b = keys_a + n_rows;
  float* amt_a = reinterpret_cast<float*>(keys_b + n_rows);
  float* amt_b = amt_a + n_rows;
  int* hist = reinterpret_cast<int*>(amt_b + n_rows);
  keys_kernel<<<tiles, kSortThreads, 0, s>>>(position, n_rows, g, key_bits,
                                             passes, tiles, keys_a, hist);
  const int smem = kTile * (sizeof(int) + sizeof(float));
  cudaFuncSetAttribute(scatter_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int* k_in = keys_a;
  const float* a_in = amount;
  int shift = 0;
  for (int p = 0; p < passes; ++p) {
    const int bits = digit_bits(key_bits, passes, p);
    const bool last = p + 1 == passes;
    int* k_out = p % 2 == 0 ? keys_b : keys_a;
    float* a_out = p % 2 == 0 ? amt_b : amt_a;
    scatter_kernel<<<tiles, kSortThreads, smem, s>>>(
        k_in, a_in, n_rows, tiles, hist + p * tiles * kMaxBins, shift, bits,
        last ? nullptr : hist + (p + 1) * tiles * kMaxBins, shift + bits,
        last ? 0 : digit_bits(key_bits, passes, p + 1), k_out, a_out);
    shift += bits;
    k_in = k_out;
    a_in = a_out;
  }
  if (static_cast<long long>(n_rows)
      >= static_cast<long long>(kWarpPerVoxelAt) * total_voxels) {
    const long long threads = 32LL * total_voxels;
    fold_kernel<true><<<static_cast<unsigned>((threads + kFoldThreads - 1)
                                              / kFoldThreads),
                        kFoldThreads, 0, s>>>(k_in, a_in, n_rows, conc,
                                              total_voxels, out);
  } else {
    const long long threads = 32LL * ((total_voxels + 31) / 32);
    fold_kernel<false><<<static_cast<unsigned>((threads + kFoldThreads - 1)
                                               / kFoldThreads),
                         kFoldThreads, 0, s>>>(k_in, a_in, n_rows, conc,
                                               total_voxels, out);
  }
  return static_cast<int>(cudaGetLastError());
}
