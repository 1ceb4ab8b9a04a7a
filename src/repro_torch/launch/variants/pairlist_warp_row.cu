// The first design of kernels/csrc/pairlist.cu, kept off every path:
// launch/kernel_variants.py builds it to time it beside the kernel
// that replaced it, on the same inputs.
//
// The Verlet pair-list build on Hopper: for each row of the grid-ordered
// pool, the candidates of its 9 stencil z-runs (truncated at run_capacity,
// self excluded) within the build radius, packed run-major and lane-minor.
//
// A port kernel with no TPU counterpart: the reference builds the list in
// XLA (repro/core/grid.py::build_pairlist); its plain PyTorch version is
// repro_torch/core/grid.py::build_pairlist_plain. Same function, entry for
// entry: idx (zeros past a row's stored count), run_off (cumulative per-run
// counts capped at max_pairs), count (the row's demand, not capped) and
// demand (the largest count). A dead row lists nothing. The cell of a row
// is morton.cell_of's (multiply by float32(1/box), floor, clamp); the
// test is d2 <= r2 with d2 rounded as fl(fl(fl(dx*dx) + fl(dy*dy)) +
// fl(dz*dz)) — __fmul_rn/__fadd_rn, never an FMA, which would keep or drop
// other pairs at the radius than the plain version does.
//
// Design. One warp per row. The warp walks the row's 9 runs in order, 32
// candidates at a time; each lane tests one candidate, a ballot and a
// popcount of the lower lanes give each kept candidate its packed slot, so
// the order is the plain version's without a scan in memory. The demand
// is one atomicMax of an integer, whose order does not matter. There is no
// device-side trip count beyond the run lengths the tables give.
//
// Bound. Bytes: each row reads its position and alive flag, 18 table
// entries and the positions of its candidate runs (neighbouring rows share
// runs, so these come mostly from the L2), and writes its max_pairs
// entries, 10 offsets and a count. The table written dominates at the
// engine's widths (max_pairs 64: 256 B a row); the arithmetic is ~10 FP32
// operations per candidate lane.
//
// Lanes. An ensemble's pool holds L lanes of lane_rows rows each, lane l
// at rows [l*lane_rows, (l+1)*lane_rows), and starts/counts are L tables
// of M boxes (lane l's at [l*M, (l+1)*M)) whose slot ids are rows of the
// whole pool. Row r is in lane r / lane_rows: it finds its stencil boxes
// in its lane's coordinates and reads them at lane*M in the tables, so
// its candidates are rows of its own lane, and its count goes into
// demand[lane] by the same atomicMax. One lane (lane_rows = n_rows) is the
// solo build.
//
// Layout: position (C, 3) f32; alive (C,) one byte per row (torch.bool);
// origin (3,) f32; starts, counts (L*M,) int32; idx (C, max_pairs) int32;
// run_off (C, 10) int32; count (C,) int32; demand (L,) int32, C = L *
// lane_rows.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kStencil = 9;

// kLanes false: the solo build (one lane), compiled without the lane's
// division and table offset.
template <bool kLanes>
__global__ void __launch_bounds__(kWarps * 32)
pairlist_kernel(const float* __restrict__ position,
                const unsigned char* __restrict__ alive, int n_rows,
                const float* __restrict__ origin, float recip,
                const int* __restrict__ starts,
                const int* __restrict__ counts, int dim_x, int dim_y,
                int dim_z, int run_cap, float r2, int max_pairs,
                int lane_rows, int* __restrict__ idx,
                int* __restrict__ run_off, int* __restrict__ count,
                int* __restrict__ demand) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;                 // the whole warp
  int* out = idx + static_cast<long long>(row) * max_pairs;
  int* off = run_off + static_cast<long long>(row) * 10;
  const int lane_id = kLanes ? row / lane_rows : 0;
  int kept = 0;
  if (alive[row] != 0) {
    const float q[3] = {position[3 * row + 0], position[3 * row + 1],
                        position[3 * row + 2]};
    const int dims[3] = {dim_x, dim_y, dim_z};
    int c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float rel = __fmul_rn(__fsub_rn(q[a], origin[a]), recip);
      c[a] = min(max(__float2int_rd(rel), 0), dims[a] - 1);
    }
    const int table = lane_id * dim_x * dim_y * dim_z;  // the lane's boxes
    const int z_lo = max(c[2] - 1, 0);
    const int z_hi = min(c[2] + 1, dim_z - 1);
    for (int k = 0; k < kStencil; ++k) {
      const int nx0 = c[0] + k / 3 - 1;
      const int ny0 = c[1] + k % 3 - 1;
      const bool inside = nx0 >= 0 && nx0 < dim_x && ny0 >= 0 && ny0 < dim_y;
      const int nx = min(max(nx0, 0), dim_x - 1);
      const int ny = min(max(ny0, 0), dim_y - 1);
      const int col = table + (nx * dim_y + ny) * dim_z;
      const int s = starts[col + z_lo];
      const int e = starts[col + z_hi] + counts[col + z_hi];
      const int n = inside ? min(e - s, run_cap) : 0;
      for (int base = 0; base < n; base += 32) {
        const int l = base + lane;
        const int cand = s + l;
        bool keep = false;
        if (l < n && cand != row) {
          const float dx = __fsub_rn(position[3 * cand + 0], q[0]);
          const float dy = __fsub_rn(position[3 * cand + 1], q[1]);
          const float dz = __fsub_rn(position[3 * cand + 2], q[2]);
          const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                               __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
          keep = d2 <= r2;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, keep);
        const int dst = kept + __popc(mask & ((1u << lane) - 1u));
        if (keep && dst < max_pairs) out[dst] = cand;
        kept += __popc(mask);
      }
      if (lane == 0) off[k + 1] = min(kept, max_pairs);
    }
  } else if (lane < kStencil) {
    off[lane + 1] = 0;
  }
  if (lane == 0) {
    off[0] = 0;
    count[row] = kept;
    atomicMax(demand + lane_id, kept);
  }
  for (int m = min(kept, max_pairs) + lane; m < max_pairs; m += 32) out[m] = 0;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). `demand`
// (one int per lane) must hold 0 before the launch. The caller checks
// shapes: 3·n_rows < 2^31, lanes·prod(dims) < 2^31, n_rows a multiple of
// lane_rows.
extern "C" int pairlist_build(const float* position, const unsigned char* alive,
                              int n_rows, const float* origin, float recip,
                              const int* starts, const int* counts, int dim_x,
                              int dim_y, int dim_z, int run_cap, float r2,
                              int max_pairs, int lane_rows, int* idx,
                              int* run_off, int* count, int* demand,
                              void* stream) {
  if (n_rows > 0) {
    const int blocks = (n_rows + kWarps - 1) / kWarps;
    const auto kernel = lane_rows == n_rows ? pairlist_kernel<false>
                                            : pairlist_kernel<true>;
    kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        position, alive, n_rows, origin, recip, starts, counts, dim_x, dim_y,
        dim_z, run_cap, r2, max_pairs, lane_rows, idx, run_off, count,
        demand);
  }
  return static_cast<int>(cudaGetLastError());
}
