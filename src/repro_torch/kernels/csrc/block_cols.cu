// K1's column map on Hopper: for each 128-row block of the grid-ordered
// pool, the ascending unique 128-wide column blocks that cover the 9 merged
// stencil z-runs of its active rows, -1 padded to maxb.
//
// Replaces the XLA wrapper repro/kernels/ops.py::build_block_cols (which
// feeds the Pallas TPU kernel collision_force_kernel its scalar-prefetched
// table). Same function, entry for entry: which ids survive when a row
// block needs more than maxb (the first maxb of the ascending unique list)
// and the overflow flag's two causes (more than maxb ids; a run longer than
// span blocks). With `cells` null the same launch also does what precedes
// the map in the resident wrapper (ops.k1_inputs): the cell of each row by
// morton.cell_of's arithmetic (multiply by float32(1/box), floor, clamp),
// the row mask active & alive, and the pack of K1's (8, n_pad) data rows.
//
// Design. One thread block per row block, one thread per row. Each thread
// forms its 9 stencil intervals [b0, min(b_last, b0 + span - 1)] of column
// blocks. Rows that are neighbours in grid order mostly share an interval,
// so a thread keeps an interval only where it differs from the previous
// row's interval of the same stencil column; the few kept ones are
// compacted in row order by a block scan, ranked by (lo, hi, position),
// and one thread sweeps them in that order into the sorted union. There is
// no sort of the 128·9·span candidate ids the XLA version sorts. The
// overflow flag is OR-ed into one int on the device: deterministic.
//
// Bound. Bytes: each row reads its cell (or its pool channels), 18 table
// entries through the L2, and writes maxb ids per block (and 32 B of data
// rows in the fused form); the arithmetic is a few dozen integer ops per
// row. The sweep is serial per block, over the kept intervals only.
//
// Lanes. An ensemble packs L lanes of lane_rows pool rows each at a stride
// of lane_stride rows (a multiple of 128), so that no row block holds two
// lanes; starts/counts are L tables of M boxes holding slot ids of the
// lane-major pool (lane l at [l*lane_rows, (l+1)*lane_rows)). A row block
// reads its own lane's table and moves the slot ids to packed rows
// (+ l*(lane_stride - lane_rows)), so its column ids are global packed
// blocks of its own lane, and its overflow goes to overflow[l]. One lane
// (lane_rows = n_rows, lane_stride = n_pad) is the solo map.
//
// Layout: cells (n_pad, 3) int32; starts, counts (L*M,) int32; row_active,
// alive, active, row_mask: one byte per row (torch.bool); position (C, 3)
// f32; data_t (8, n_pad) f32 rows [x, y, z, diameter, type, alive, 0, 0];
// block_cols (n_pad/128, maxb) int32.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kStencil = 9;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxIntervals = kBlock * kStencil;

__global__ void __launch_bounds__(kBlock)
block_cols_kernel(const int* __restrict__ cells,
                  const unsigned char* __restrict__ row_active,
                  const float* __restrict__ position,
                  const float* __restrict__ diameter,
                  const int* __restrict__ agent_type,
                  const unsigned char* __restrict__ alive,
                  const unsigned char* __restrict__ active, int n_rows,
                  const float* __restrict__ origin, float recip,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts, int n_pad, int dim_x,
                  int dim_y, int dim_z, int maxb, int span, int lane_rows,
                  int lane_stride, int* __restrict__ block_cols,
                  int* __restrict__ overflow, float* __restrict__ data_t,
                  unsigned char* __restrict__ row_mask) {
  __shared__ int s_lo[kStencil][kBlock];
  __shared__ int s_hi[kStencil][kBlock];
  __shared__ int2 s_list[kMaxIntervals];
  __shared__ int2 s_sorted[kMaxIntervals];
  __shared__ int s_warp[kWarps];
  __shared__ int s_written;

  const int rb = blockIdx.x;
  const int t = threadIdx.x;
  const int row = rb * kBlock + t;
  // the row block's lane, the row's place in it, and the table it reads
  const int lane_id = (rb * kBlock) / lane_stride;
  const int local = row - lane_id * lane_stride;
  const int shift = lane_id * (lane_stride - lane_rows);  // slot -> packed row
  const long long table =
      static_cast<long long>(lane_id) * dim_x * dim_y * dim_z;

  int cx, cy, cz;
  bool act;
  if (cells != nullptr) {
    cx = cells[3 * row + 0];
    cy = cells[3 * row + 1];
    cz = cells[3 * row + 2];
    act = row_active[row] != 0;
  } else {
    // ops.k1_inputs: rows past the pool are zero padding, inactive
    float p[3] = {0.f, 0.f, 0.f};
    float dia = 0.f;
    int typ = 0;
    bool al = false, ac = false;
    if (local < lane_rows && row - shift < n_rows) {
      const int src = row - shift;              // the row's pool slot
      p[0] = position[3 * src + 0];
      p[1] = position[3 * src + 1];
      p[2] = position[3 * src + 2];
      dia = diameter[src];
      typ = agent_type[src];
      al = alive[src] != 0;
      ac = active[src] != 0;
    }
    act = al && ac;
    row_mask[row] = act ? 1 : 0;
    data_t[0 * n_pad + row] = p[0];
    data_t[1 * n_pad + row] = p[1];
    data_t[2 * n_pad + row] = p[2];
    data_t[3 * n_pad + row] = dia;
    data_t[4 * n_pad + row] = static_cast<float>(typ);
    data_t[5 * n_pad + row] = al ? 1.f : 0.f;
    data_t[6 * n_pad + row] = 0.f;
    data_t[7 * n_pad + row] = 0.f;
    // morton.cell_of: (p - origin) * float32(1/box), floor, clamp
    const int dims[3] = {dim_x, dim_y, dim_z};
    int c[3];
    for (int a = 0; a < 3; ++a) {
      const float rel = __fmul_rn(__fsub_rn(p[a], origin[a]), recip);
      c[a] = min(max(__float2int_rd(rel), 0), dims[a] - 1);
    }
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }

  // The 9 (dx, dy) stencil columns, each a 3-box z-run, as in
  // ops.build_block_cols: masked unless inside the grid and the row active.
  bool span_ovf = false;
  const int z_lo = max(cz - 1, 0);
  const int z_hi = min(cz + 1, dim_z - 1);
#pragma unroll
  for (int k = 0; k < kStencil; ++k) {
    const int nx0 = cx + k / 3 - 1;
    const int ny0 = cy + k % 3 - 1;
    const bool inside = nx0 >= 0 && nx0 < dim_x && ny0 >= 0 && ny0 < dim_y;
    const int nx = min(max(nx0, 0), dim_x - 1);
    const int ny = min(max(ny0, 0), dim_y - 1);
    const long long col = table + (nx * dim_y + ny) * dim_z;
    const int s = starts[col + z_lo] + shift;
    const int e = starts[col + z_hi] + counts[col + z_hi] + shift;
    const int n = (inside && act) ? e - s : 0;
    const int b0 = s / kBlock;                  // s >= 0
    const int b_last = n > 0 ? (s + n - 1) / kBlock : -1;
    span_ovf |= (b_last - b0 + 1) > span;
    s_lo[k][t] = b0;
    s_hi[k][t] = n > 0 ? min(b_last, b0 + span - 1) : -1;   // -1: empty
  }
  __syncthreads();

  // keep an interval unless it is empty or the previous row's same one
  unsigned keep = 0;
  int n_keep = 0;
#pragma unroll
  for (int k = 0; k < kStencil; ++k) {
    const int lo = s_lo[k][t], hi = s_hi[k][t];
    const bool repeat = t > 0 && s_lo[k][t - 1] == lo && s_hi[k][t - 1] == hi;
    if (hi >= lo && !repeat) {
      keep |= 1u << k;
      ++n_keep;
    }
  }
  // exclusive block scan of n_keep: compaction in row order
  const int lane = t & 31, warp = t >> 5;
  int incl = n_keep;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int off = incl - n_keep, n_list = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) off += s_warp[w];
    n_list += s_warp[w];
  }
#pragma unroll
  for (int k = 0; k < kStencil; ++k) {
    if (keep & (1u << k)) s_list[off++] = make_int2(s_lo[k][t], s_hi[k][t]);
  }
  __syncthreads();

  // rank by (lo, hi, position in the list): a permutation
  for (int i = t; i < n_list; i += kBlock) {
    const int2 a = s_list[i];
    int r = 0;
    for (int j = 0; j < n_list; ++j) {
      const int2 b = s_list[j];
      r += (b.x < a.x || (b.x == a.x && (b.y < a.y || (b.y == a.y && j < i))))
               ? 1 : 0;
    }
    s_sorted[r] = a;
  }
  __syncthreads();

  // sweep: the ascending union; the first maxb ids are written
  int* out = block_cols + static_cast<long long>(rb) * maxb;
  if (t == 0) {
    long long n_uniq = 0;
    int last = -1;                           // highest id emitted
    for (int i = 0; i < n_list; ++i) {
      const int2 iv = s_sorted[i];
      for (int v = max(iv.x, last + 1); v <= iv.y; ++v, ++n_uniq) {
        if (n_uniq < maxb) out[n_uniq] = v;
      }
      last = max(last, iv.y);
    }
    s_written = static_cast<int>(n_uniq < maxb ? n_uniq : maxb);
    span_ovf |= n_uniq > maxb;
  }
  if (__syncthreads_or(span_ovf) && t == 0) atomicOr(overflow + lane_id, 1);
  for (int j = s_written + t; j < maxb; j += kBlock) out[j] = -1;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). With
// `cells` given, reads it and `row_active`; with `cells` null, computes the
// cells from the pool (n_rows rows of position, diameter, agent_type,
// alive, active; origin (3,) f32 on the device) and writes data_t and
// row_mask. `overflow` (one int per lane) must hold 0 before the launch.
// The caller checks shapes: n_pad a multiple of 128, 8·n_pad < 2^31,
// lanes·prod(dims) < 2^31, lane_stride a multiple of 128 dividing n_pad.
extern "C" int k1_block_cols(const int* cells, const unsigned char* row_active,
                             const float* position, const float* diameter,
                             const int* agent_type, const unsigned char* alive,
                             const unsigned char* active, int n_rows,
                             const float* origin, float recip,
                             const int* starts, const int* counts, int n_pad,
                             int dim_x, int dim_y, int dim_z, int maxb,
                             int span, int lane_rows, int lane_stride,
                             int* block_cols, int* overflow, float* data_t,
                             unsigned char* row_mask, void* stream) {
  const int n_rb = n_pad / kBlock;
  if (n_rb > 0) {
    block_cols_kernel<<<n_rb, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        cells, row_active, position, diameter, agent_type, alive, active,
        n_rows, origin, recip, starts, counts, n_pad, dim_x, dim_y, dim_z,
        maxb, span, lane_rows, lane_stride, block_cols, overflow, data_t,
        row_mask);
  }
  return static_cast<int>(cudaGetLastError());
}
