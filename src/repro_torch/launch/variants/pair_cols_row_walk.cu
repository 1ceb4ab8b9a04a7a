// The first design of kernels/csrc/pair_cols.cu, kept off every path:
// launch/kernel_variants.py builds it to time it beside the kernel that
// replaced it, on the same inputs.
//
// K1's column map from a Verlet pair list on Hopper: for each 128-row
// block of the grid-ordered pool, the ascending unique column blocks
// idx / 128 over every stored pair-list entry of its active rows, -1
// padded to maxb, and an overflow flag when more than maxb are needed.
//
// Replaces the XLA wrapper repro/kernels/ops.py::build_block_cols_from_pairs
// (which feeds the Pallas TPU kernel collision_force_kernel a map pruned to
// the blocks that hold a listed candidate). Same function, entry for entry
// (the first maxb of the ascending unique list are kept). With `position`
// non-null the same launch also does what precedes the map in the resident
// wrapper (ops.k1_inputs): the row mask active & alive and the pack of
// K1's (8, n_pad) data rows, as csrc/block_cols.cu does.
//
// Design. One thread block per row block, one warp per 32 of its rows;
// a warp reads each of its rows' stored entries with its 32 lanes side by
// side (coalesced). A first pass finds the lowest and highest column
// block the row block lists; then, for each window of kWindowBits column
// blocks from the lowest (one window at the engine's sizes: a row block's
// neighbours lie within a few x-planes), the entries set bits of a shared
// bitmap, the bitmap's words are counted per thread, an exclusive block
// scan gives each thread its place, and the set bits are written in
// ascending order. No sort; the flag is OR-ed into one int on the device.
//
// Bound. Bytes: the stored entries of the active rows and their run_off
// rows read (twice here: the bounds pass and the bitmap pass, the second
// mostly from the L2), maxb ids written per row block (and 32 B of data
// rows a row in the fused form). The integer work is a divide and a
// shared-memory OR per entry.
//
// Lanes. An ensemble packs L lanes of lane_rows pool rows each at a stride
// of lane_stride rows (a multiple of 128), as csrc/block_cols.cu does, so
// no row block holds two lanes; its pair list holds the lanes' rows
// lane-major with slot ids of the whole pool (lane l at [l*lane_rows,
// (l+1)*lane_rows)). Row block rb is in lane l = rb*128 / lane_stride: its
// packed rows read pool rows moved back by l*(lane_stride - lane_rows),
// its entries' slot ids move forward by the same shift to packed rows,
// so its column ids are packed blocks of its own lane, and its overflow
// goes to overflow[l]. One lane (lane_rows = n_rows, lane_stride = n_pad)
// is the solo map.
//
// Layout: idx (n_rows, max_pairs) int32; run_off (n_rows, 10) int32;
// row_active (n_pad,), alive, active, row_mask: one byte per row
// (torch.bool); position (n_rows, 3) f32; data_t (8, n_pad) f32 rows
// [x, y, z, diameter, type, alive, 0, 0]; block_cols (n_pad/128, maxb)
// int32.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr int kWindowWords = 1024;
constexpr int kWindowBits = kWindowWords * 32;

__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int off = incl - v, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) off += s_warp[w];
    sum += s_warp[w];
  }
  __syncthreads();
  *total = sum;
  return off;
}

__global__ void __launch_bounds__(kBlock)
pair_cols_kernel(const int* __restrict__ idx, const int* __restrict__ run_off,
                 int max_pairs, const unsigned char* __restrict__ row_active,
                 const float* __restrict__ position,
                 const float* __restrict__ diameter,
                 const int* __restrict__ agent_type,
                 const unsigned char* __restrict__ alive,
                 const unsigned char* __restrict__ active, int n_rows,
                 int n_pad, int maxb, int lane_rows, int lane_stride,
                 int* __restrict__ block_cols,
                 int* __restrict__ overflow, float* __restrict__ data_t,
                 unsigned char* __restrict__ row_mask) {
  __shared__ unsigned s_bits[kWindowWords];
  __shared__ int s_stored[kBlock];
  __shared__ int s_warp[kWarps];
  __shared__ int s_lo[kWarps], s_hi[kWarps];

  const int rb = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int row = rb * kBlock + t;
  // the row block's lane, and the shift from a pool row to its packed row
  const int lane_id = (rb * kBlock) / lane_stride;
  const int shift = lane_id * (lane_stride - lane_rows);
  const int prow = row - shift;               // the row's pool row
  const bool in_pool = row - lane_id * lane_stride < lane_rows &&
                       prow < n_rows;

  bool act;
  if (position == nullptr) {
    act = row_active[row] != 0 && in_pool;
  } else {
    // ops.k1_inputs: rows past the pool are zero padding, inactive
    float p[3] = {0.f, 0.f, 0.f};
    float dia = 0.f;
    int typ = 0;
    bool al = false, ac = false;
    if (in_pool) {
      p[0] = position[3 * prow + 0];
      p[1] = position[3 * prow + 1];
      p[2] = position[3 * prow + 2];
      dia = diameter[prow];
      typ = agent_type[prow];
      al = alive[prow] != 0;
      ac = active[prow] != 0;
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
  }
  s_stored[t] = act ? run_off[static_cast<long long>(prow) * 10 + 9] : 0;
  __syncthreads();

  // pass 1: the lowest and highest listed column block
  int lo = INT_MAX, hi = -1;
  for (int r = warp * 32; r < warp * 32 + 32; ++r) {
    const long long src_row = rb * kBlock + r - shift;
    for (int m = lane; m < s_stored[r]; m += 32) {
      const int b = (idx[src_row * max_pairs + m] + shift) / kBlock;
      lo = min(lo, b);
      hi = max(hi, b);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = INT_MAX;
  hi = -1;
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, s_lo[w]);
    hi = max(hi, s_hi[w]);
  }

  // pass 2, window by window: bitmap, count, scan, ascending write
  int* out = block_cols + static_cast<long long>(rb) * maxb;
  long long n_uniq = 0;
  for (long long base = lo; base <= hi; base += kWindowBits) {
    for (int w = t; w < kWindowWords; w += kBlock) s_bits[w] = 0u;
    __syncthreads();
    for (int r = warp * 32; r < warp * 32 + 32; ++r) {
      const long long src_row = rb * kBlock + r - shift;
      for (int m = lane; m < s_stored[r]; m += 32) {
        const long long b =
            (idx[src_row * max_pairs + m] + shift) / kBlock - base;
        if (b >= 0 && b < kWindowBits) {
          atomicOr(&s_bits[b >> 5], 1u << (b & 31));
        }
      }
    }
    __syncthreads();
    const int n_words = static_cast<int>(
        min(static_cast<long long>(kWindowWords), (hi - base) / 32 + 1));
    const int per = (n_words + kBlock - 1) / kBlock;
    const int w0 = min(t * per, n_words), w1 = min(w0 + per, n_words);
    int mine = 0;
    for (int w = w0; w < w1; ++w) mine += __popc(s_bits[w]);
    int total;
    long long pos = n_uniq + block_exclusive_scan(mine, s_warp, &total);
    for (int w = w0; w < w1; ++w) {
      unsigned bits = s_bits[w];
      while (bits != 0u) {
        const int bit = __ffs(bits) - 1;
        bits &= bits - 1u;
        if (pos < maxb) {
          out[pos] = static_cast<int>(base + 32LL * w + bit);
        }
        ++pos;
      }
    }
    n_uniq += total;
    __syncthreads();
  }
  if (t == 0 && n_uniq > maxb) atomicOr(overflow + lane_id, 1);
  const int written = static_cast<int>(n_uniq < maxb ? n_uniq : maxb);
  for (int j = written + t; j < maxb; j += kBlock) out[j] = -1;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). With
// `position` null, reads `row_active` (n_pad rows); with it given, reads
// the pool (n_rows rows of position, diameter, agent_type, alive, active)
// and writes data_t and row_mask. idx and run_off hold n_rows rows.
// `overflow` (one int per lane) must hold 0 before the launch. The caller
// checks shapes: lane_stride a multiple of 128 dividing n_pad, n_rows =
// lanes·lane_rows with lane_rows <= lane_stride, 8·n_pad < 2^31,
// n_rows·max_pairs < 2^31.
extern "C" int k1_pair_cols(const int* idx, const int* run_off, int max_pairs,
                            const unsigned char* row_active,
                            const float* position, const float* diameter,
                            const int* agent_type, const unsigned char* alive,
                            const unsigned char* active, int n_rows,
                            int n_pad, int maxb, int lane_rows,
                            int lane_stride, int* block_cols,
                            int* overflow, float* data_t,
                            unsigned char* row_mask, void* stream) {
  const int n_rb = n_pad / kBlock;
  if (n_rb > 0) {
    pair_cols_kernel<<<n_rb, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
        idx, run_off, max_pairs, row_active, position, diameter, agent_type,
        alive, active, n_rows, n_pad, maxb, lane_rows, lane_stride,
        block_cols, overflow, data_t, row_mask);
  }
  return static_cast<int>(cudaGetLastError());
}
