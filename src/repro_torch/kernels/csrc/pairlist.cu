// The Verlet pair-list build on Hopper: for each row of the grid-ordered
// pool, the candidates of its 9 stencil z-runs (truncated at run_capacity,
// self excluded) within the build radius, packed run-major and lane-minor.
//
// A port kernel with no TPU counterpart: the reference builds the list in
// XLA (repro/core/grid.py::build_pairlist); its plain PyTorch version is
// repro_torch/core/grid.py::build_pairlist_plain. Same function, entry for
// entry: idx (zeros past a row's stored count), run_off (cumulative per-run
// counts capped at max_pairs), count (the row's demand, not capped) and
// demand (the largest count, by atomicMax, per lane). A dead row lists
// nothing; only the row's own alive flag is tested. The cell of a row is
// morton.cell_of's (multiply by float32(1/box), floor, clamp); the test is
// d2 <= r2 with d2 rounded as fl(fl(fl(dx*dx) + fl(dy*dy)) + fl(dz*dz)) —
// __fmul_rn/__fadd_rn, never an FMA, which would keep or drop other pairs
// at the radius than the plain version does.
//
// Bound. Bytes: each row's position and alive flag and the box tables read
// once, the table written once (idx, run_off, count: 256 B + 44 B a row at
// max_pairs 64). At 1M agents in a 64^3 grid a row has ~110 candidate
// lanes, 1.15e8 in all, ~9 FP32 operations each: below the bytes. What the
// first design (a warp a row; launch/variants/pairlist_warp_row.cu) paid
// beyond the bound: the 9 runs walked one after another, each a 32-lane
// pass for ~12 candidates (two thirds idle); the candidates' positions
// read at a 12-byte stride for every row, though the rows of a box share
// their runs; stores scattered a lane at a time; one atomicMax a row on
// one address.
//
// Design. A block is one warp and takes kRows = 32 consecutive rows (a
// tile), a lane a row. In a grid-ordered pool a tile's rows lie in one or
// two (x, y) columns, a few consecutive boxes of each, so the union of the
// rows' runs in each of a column's 9 neighbouring columns is one slot
// range. The warp finds the tile's columns (those of its first and its
// last live row), the z span of its live rows in each, and the (up to) 18
// ranges over those spans, and stages them into shared memory with
// cp.async, one 16-byte record (x, y, z, slot id) a candidate: ~360
// records for the 32 rows at 1M agents (at most ~640), read ~10 times
// each. Each lane
// then walks its own row's 9 runs from shared memory, the warp's lanes in
// step run by run, two candidates a round with the next two records loaded
// ahead of the tests: no ballot, no shuffle and no pass with idle lanes
// per candidate; the row's lane packs its kept candidates in run order
// and notes each run's end in the offsets. A row whose runs do not all lie
// inside its column's staged ranges (a pool not in grid order, a third
// column or another lane in the tile, ranges past kStageMax records, tables
// that are not monotone) is walked by the whole warp from global memory
// afterwards: its 9 runs as one candidate sequence in full 32-lane passes,
// a lane finding its run by comparing its index with the 8 run ends, the
// packed slot from a ballot and a popcount of the lower lanes. That branch
// is part of this kernel: it is exact for any row order. A row's lane
// stores its entries; the zeros past them, the tile's offsets (staged in
// shared memory) and its counts leave in 16-byte or coalesced stores; the
// tile's demand is one atomicMax a lane. Shared memory sets the occupancy
// (15 one-warp blocks an SM with 12 KB of records). kStageMax covers the
// largest union at 1M agents at radius 4 (~640 records) and most at the
// every_k radius of 5.5: a tile past it sends all its rows through the
// slow branch, and one such tile holds up the launch's tail. Staging the
// entries in shared memory too and storing whole 16-byte rows (8.7 KB
// more a block at max_pairs 64) measured 18% slower at 1M agents (0.4822
// ms against 0.4088 in the same call).
//
// Lanes. An ensemble's pool holds L lanes of lane_rows rows each, lane l
// at rows [l*lane_rows, (l+1)*lane_rows), and starts/counts are L tables
// of M boxes (lane l's at [l*M, (l+1)*M)) whose slot ids are rows of the
// whole pool. Row r is in lane r / lane_rows: it finds its stencil boxes
// in its lane's coordinates and reads them at lane*M in the tables, so
// its candidates are rows of its own lane, and its count goes into
// demand[lane]. One lane (lane_rows = n_rows) is the solo build.
//
// Layout: position (C, 3) f32; alive (C,) one byte per row (torch.bool);
// origin (3,) f32; starts, counts (L*M,) int32; idx (C, max_pairs) int32;
// run_off (C, 10) int32; count (C,) int32; demand (L,) int32, C = L *
// lane_rows.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 32;                   // rows a block: a warp, a lane a row
constexpr int kStencil = 9;
constexpr int kStageMax = 768;              // staged candidates (12 KB)

struct Params {
  const float* position;
  const unsigned char* alive;
  int n_rows;
  const float* origin;
  float recip;
  const int* starts;
  const int* counts;
  int dim_x, dim_y, dim_z;
  int run_cap;
  float r2;
  int max_pairs;
  int lane_rows;
  int* idx;
  int* run_off;
  int* count;
  int* demand;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// column (nx0, ny0) of the stencil: the slots [x, y) of its boxes
// [z_lo, z_hi], or an empty range where the column lies outside the grid
// (y - x is not clamped: a table need not be monotone)
__device__ __forceinline__ int2 column_run(const Params& p, int table,
                                           int nx0, int ny0, int z_lo,
                                           int z_hi) {
  const bool inside = nx0 >= 0 && nx0 < p.dim_x && ny0 >= 0
                      && ny0 < p.dim_y;
  if (!inside) return make_int2(0, 0);
  const int col = table + (nx0 * p.dim_y + ny0) * p.dim_z;
  return make_int2(p.starts[col + z_lo],
                   p.starts[col + z_hi] + p.counts[col + z_hi]);
}

__device__ __forceinline__ bool within_radius(float x, float y, float z,
                                              float qx, float qy, float qz,
                                              float r2) {
  const float dx = __fsub_rn(x, qx);
  const float dy = __fsub_rn(y, qy);
  const float dz = __fsub_rn(z, qz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return d2 <= r2;
}

// The staged ranges of a tile: for each of its (up to) two columns, the
// slots [start, end) of each neighbouring column's boxes over the column's
// z span, and where they begin among the staged records.
struct Union {
  int start[2 * kStencil], end[2 * kStencil], at[2 * kStencil];
};

// kLanes false: the solo build (one lane), compiled without the lane's
// division and table offset.
template <bool kLanes>
__global__ void __launch_bounds__(kRows)
pairlist_kernel(Params p) {
  extern __shared__ float4 s_cand[];         // kStageMax records
  __shared__ Union s_u;
  __shared__ __align__(16) int s_off[kRows * 10];
  __shared__ int s_count[kRows];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int row = r0 + lane;
  const int nr = min(kRows, p.n_rows - r0);
  const int m_boxes = p.dim_x * p.dim_y * p.dim_z;
  const int mp = p.max_pairs;
  const unsigned lower = (1u << lane) - 1u;

  // 1. the rows' cells; the tile's columns (its first and its last live
  // row's), the z span of the live rows in each, and lane j < 18's range
  // of neighbouring column j % 9 of column j / 9 over that span
  const bool live = row < p.n_rows && p.alive[row] != 0;
  const int row_lane = kLanes && row < p.n_rows ? row / p.lane_rows : 0;
  int c[3] = {0, 0, 0};
  if (live) {
    const int dims[3] = {p.dim_x, p.dim_y, p.dim_z};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float rel = __fmul_rn(__fsub_rn(p.position[3LL * row + a],
                                            p.origin[a]), p.recip);
      c[a] = min(max(__float2int_rd(rel), 0), dims[a] - 1);
    }
  }
  const unsigned live_rows = __ballot_sync(kFull, live);
  int which = -1;                            // the row's column: 0, 1 or none
  int staged = 0, us = 0, len = 0, incl = 0;
  if (live_rows != 0) {
    const int a = __ffs(live_rows) - 1, b = 31 - __clz(live_rows);
    const int ax = __shfl_sync(kFull, c[0], a), bx = __shfl_sync(kFull, c[0], b);
    const int ay = __shfl_sync(kFull, c[1], a), by = __shfl_sync(kFull, c[1], b);
    const int al = __shfl_sync(kFull, row_lane, a);
    const int bl = __shfl_sync(kFull, row_lane, b);
    const bool two = ax != bx || ay != by || al != bl;
    if (live && c[0] == ax && c[1] == ay && row_lane == al) which = 0;
    else if (live && two && c[0] == bx && c[1] == by && row_lane == bl)
      which = 1;
    const int z0a = __reduce_min_sync(kFull, which == 0 ? c[2] : INT_MAX);
    const int z1a = __reduce_max_sync(kFull, which == 0 ? c[2] : INT_MIN);
    const int z0b = __reduce_min_sync(kFull, which == 1 ? c[2] : INT_MAX);
    const int z1b = __reduce_max_sync(kFull, which == 1 ? c[2] : INT_MIN);
    const int k = lane % kStencil;
    if (lane < kStencil || (two && lane < 2 * kStencil)) {
      const bool first = lane < kStencil;
      const int2 r = column_run(p, (first ? al : bl) * m_boxes,
                                (first ? ax : bx) + k / 3 - 1,
                                (first ? ay : by) + k % 3 - 1,
                                max((first ? z0a : z0b) - 1, 0),
                                min((first ? z1a : z1b) + 1, p.dim_z - 1));
      us = r.x;
      len = max(r.y - r.x, 0);
    }
    incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += u;
    }
    const int total = __shfl_sync(kFull, incl, 2 * kStencil - 1);
    staged = total <= kStageMax ? total : 0;
  }
  if (lane < 2 * kStencil) {                 // nothing staged: empty ranges
    s_u.start[lane] = us;
    s_u.end[lane] = staged > 0 ? us + len : us;
    s_u.at[lane] = incl - len;
  }
  __syncwarp();

  // 2. the ranges into shared memory, a range at a time: x, y, z by
  // cp.async, the slot id in w
  if (staged > 0) {
    for (int u = 0; u < 2 * kStencil; ++u) {
      const int start = s_u.start[u], at = s_u.at[u];
      for (int i = lane; i < s_u.end[u] - start; i += kRows) {
        const float* src = p.position + 3LL * (start + i);
        float* rec = reinterpret_cast<float*>(s_cand + at + i);
        cp_async4(rec + 0, src + 0);
        cp_async4(rec + 1, src + 1);
        cp_async4(rec + 2, src + 2);
        rec[3] = __int_as_float(start + i);
      }
    }
  }
  cp_async_commit();

  // 3. meanwhile each lane its own row's 9 runs: a row whose runs all lie
  // in its column's staged ranges reads them from shared memory (their
  // first records in rec0[j]), any other row from global memory (step 5)
  bool inside = which >= 0;
  int rec0[kStencil], count[kStencil];
#pragma unroll
  for (int j = 0; j < kStencil; ++j) {
    int s = 0, n = 0;
    if (live) {
      const int2 r = column_run(p, row_lane * m_boxes, c[0] + j / 3 - 1,
                                c[1] + j % 3 - 1, max(c[2] - 1, 0),
                                min(c[2] + 1, p.dim_z - 1));
      s = r.x;
      n = max(min(r.y - r.x, p.run_cap), 0);
    }
    const int u = (which > 0 ? kStencil : 0) + j;
    inside = inside && (n == 0 || (s >= s_u.start[u] && s + n <= s_u.end[u]));
    rec0[j] = s_u.at[u] + s - s_u.start[u];
    count[j] = n;
  }
  const float qx = live ? p.position[3LL * row + 0] : 0.f;
  const float qy = live ? p.position[3LL * row + 1] : 0.f;
  const float qz = live ? p.position[3LL * row + 2] : 0.f;
  int* out_row = p.idx + static_cast<long long>(row) * mp;
  cp_async_wait_all();
  __syncwarp();

  // 4. a lane a row over the staged records: the warp's lanes walk run j
  // together, each its own row's, two candidates a round with the next two
  // records loaded ahead of the tests; dead rows take this branch with
  // nothing to list
  int kept = 0;
  if (!live || inside) {
#pragma unroll
    for (int j = 0; j < kStencil; ++j) {
      const int n = live ? count[j] : 0;
      const float4* rec = s_cand + rec0[j];
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 a = n > 0 ? rec[0] : zero, b = n > 1 ? rec[1] : zero;
      for (int i = 0; i < n; i += 2) {
        const float4 na = i + 2 < n ? rec[i + 2] : zero;
        const float4 nb = i + 3 < n ? rec[i + 3] : zero;
        const int ca = __float_as_int(a.w), cb = __float_as_int(b.w);
        const bool ka = (ca != row)
                        & within_radius(a.x, a.y, a.z, qx, qy, qz, p.r2);
        const bool kb = (i + 1 < n) & (cb != row)
                        & within_radius(b.x, b.y, b.z, qx, qy, qz, p.r2);
        if (ka && kept < mp) out_row[kept] = ca;
        kept += ka;
        if (kb && kept < mp) out_row[kept] = cb;
        kept += kb;
        a = na;
        b = nb;
      }
      s_off[lane * 10 + j + 1] = min(kept, mp);
    }
    s_count[lane] = kept;
  }

  // 5. a warp a row over global memory for the rows outside the staged
  // ranges: the 9 runs as one candidate sequence in 32-lane passes
  unsigned outside = __ballot_sync(kFull, live && !inside);
  while (outside != 0) {
    const int rl = __ffs(outside) - 1;
    outside &= outside - 1;
    const int orow = r0 + rl;
    const int ox0 = __shfl_sync(kFull, c[0], rl);
    const int oy0 = __shfl_sync(kFull, c[1], rl);
    const int oz0 = __shfl_sync(kFull, c[2], rl);
    const int ol = __shfl_sync(kFull, row_lane, rl);
    const float ox = __shfl_sync(kFull, qx, rl);
    const float oy = __shfl_sync(kFull, qy, rl);
    const float oz = __shfl_sync(kFull, qz, rl);
    int s = 0, n = 0;                      // lane j < 9: run j
    if (lane < kStencil) {
      const int2 r = column_run(p, ol * m_boxes, ox0 + lane / 3 - 1,
                                oy0 + lane % 3 - 1, max(oz0 - 1, 0),
                                min(oz0 + 1, p.dim_z - 1));
      s = r.x;
      n = max(min(r.y - r.x, p.run_cap), 0);
    }
    int end = n;                           // run j's end in the sequence
#pragma unroll
    for (int d = 1; d < 16; d <<= 1) {
      const int u = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end += u;
    }
    const int n_all = __shfl_sync(kFull, end, kStencil - 1);
    const int shift = s - (end - n);       // candidate f: slot f + shift
    int ends[kStencil - 1];
#pragma unroll
    for (int k = 0; k < kStencil - 1; ++k)
      ends[k] = __shfl_sync(kFull, end, k);
    int* oout = p.idx + static_cast<long long>(orow) * mp;
    int okept = 0, off = 0;
    for (int base = 0; base < n_all; base += 32) {
      const int f = base + lane;
      int k = 0;
#pragma unroll
      for (int b = 0; b < kStencil - 1; ++b) k += f >= ends[b] ? 1 : 0;
      const int cand = f + __shfl_sync(kFull, shift, k);
      const bool keep = f < n_all && cand != orow
                        && within_radius(p.position[3LL * cand + 0],
                                         p.position[3LL * cand + 1],
                                         p.position[3LL * cand + 2], ox, oy,
                                         oz, p.r2);
      const unsigned mask = __ballot_sync(kFull, keep);
      const int dst = okept + __popc(mask & lower);
      if (keep && dst < mp) oout[dst] = cand;
      if (lane < kStencil && end > base && end <= base + 32) {
        const int upto = end - base;        // run j ends in this pass
        off = okept + __popc(mask & (upto == 32 ? kFull : (1u << upto) - 1u));
      }
      okept += __popc(mask);
    }
    if (lane < kStencil) s_off[rl * 10 + lane + 1] = min(off, mp);
    if (lane == 0) s_count[rl] = okept;
  }
  s_off[lane * 10] = 0;
  __syncwarp();

  // 6. each row's entries past its stored ones are zeros (16-byte stores
  // where a row's 4-entry chunk lies past them); the offsets leave in
  // 16-byte stores; the tile's demand is one atomicMax a lane
  if (mp % 4 != 0) {
    for (int rl = 0; rl < nr; ++rl) {
      int* o = p.idx + static_cast<long long>(r0 + rl) * mp;
      for (int m = min(s_count[rl], mp) + lane; m < mp; m += kRows) o[m] = 0;
    }
  } else {
    const int per_row = mp / 4;
    int4* out = reinterpret_cast<int4*>(p.idx + static_cast<long long>(r0)
                                        * mp);
    for (int k = lane; k < nr * per_row; k += kRows) {
      const int rl = k / per_row, m = 4 * (k - rl * per_row);
      const int stored = min(s_count[rl], mp);
      if (m >= stored) {
        out[k] = make_int4(0, 0, 0, 0);
      } else {
        int* part = reinterpret_cast<int*>(out + k);
        for (int e = stored; e < m + 4; ++e) part[e - m] = 0;
      }
    }
  }
  __syncwarp();
  int* run_off = p.run_off + 10LL * r0;
  for (int k = lane; k < 10 * nr / 4; k += kRows)
    reinterpret_cast<int4*>(run_off)[k] = reinterpret_cast<int4*>(s_off)[k];
  for (int k = 10 * nr / 4 * 4 + lane; k < 10 * nr; k += kRows)
    run_off[k] = s_off[k];
  if (lane < nr) p.count[row] = s_count[lane];
  const int cnt = lane < nr ? s_count[lane] : 0;
  const int first = kLanes ? r0 / p.lane_rows : 0;
  const int top = __reduce_max_sync(kFull, row_lane == first ? cnt : 0);
  if (lane == 0 && top > 0) atomicMax(p.demand + first, top);
  if (kLanes && row_lane != first && cnt > 0)
    atomicMax(p.demand + row_lane, cnt);
}

template <bool kLanes>
int launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.n_rows + kRows - 1) / kRows;
  const int smem = kStageMax * 16;
  pairlist_kernel<kLanes><<<blocks, kRows, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). `demand`
// (one int per lane) must hold 0 before the launch. The caller checks
// shapes: 3·n_rows < 2^31, lanes·prod(dims) < 2^31, n_rows·max_pairs <
// 2^31, n_rows a multiple of lane_rows.
extern "C" int pairlist_build(const float* position, const unsigned char* alive,
                              int n_rows, const float* origin, float recip,
                              const int* starts, const int* counts, int dim_x,
                              int dim_y, int dim_z, int run_cap, float r2,
                              int max_pairs, int lane_rows, int* idx,
                              int* run_off, int* count, int* demand,
                              void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
  const Params p{position, alive, n_rows, origin, recip, starts, counts,
                 dim_x, dim_y, dim_z, run_cap, r2, max_pairs, lane_rows,
                 idx, run_off, count, demand};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lane_rows != n_rows ? launch<true>(p, s) : launch<false>(p, s);
}
