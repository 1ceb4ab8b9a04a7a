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
// Design. One thread block per row block, a thread a row for the pack.
// A row block's stored entries are staged in shared memory once, with
// every load in flight before any is used: the rows' stored counts (from
// run_off) are scanned into each row's place in a flat array, and each
// warp issues one 4-byte cp.async per entry of its 32 rows, lane by lane
// along a row (a row's entries are contiguous), without waiting between
// rows (each row's place and count come from its own lane by a shuffle);
// one wait and one barrier then cover them all. At the engine's sizes
// (~18 entries a row at 1M agents, skin 0) a row block stages ~9 KB, and
// the blocks an SM holds keep ~80 KB of loads in flight. One pass over
// the staged copy then finds the lowest and highest listed column block
// and sets the entries' bits in a shared bitmap of kWindowBits column
// blocks centred on the row block's own, a shared-memory atomic an entry.
// When the bounds lie inside that window (always, at the engine's sizes:
// a row block's neighbours lie within a few x-planes), the words between
// them are counted, an exclusive block scan gives each thread its place,
// and the set bits are written in ascending order. Otherwise the bitmap
// is rebuilt window by window from the lowest block. Device memory is
// read once. Measured no faster and left out: fewer atomics (a lane
// leaves its bit to a left neighbour naming the same block), more
// resident blocks (registers capped), other staging sizes, and a
// persistent grid that stages the next row block while mapping this one.
// A row block with more stored entries than the staging holds
// (kStageEntries; 128 rows x 32 entries) takes them in chunks, staging
// each again for every further window: exact, and slower only there. No
// sort; the flag is OR-ed into one int on the device.
//
// What the first design (launch/variants/pair_cols_row_walk.cu) paid:
// each warp walked its 32 rows one at a time, a row's load (at most a
// few 128-byte lines with a variable trip count) finished before the next
// row's was issued, so a warp had about one load in flight and paid the
// DRAM latency ~32 times in the bounds pass and again, from the L2, in
// the bitmap pass; every entry set its bit with its own shared-memory
// atomic; and every window cleared and counted all 1,024 words.
//
// Bound. Bytes: the stored entries of the active rows and their run_off
// rows read once, maxb ids written per row block (and 32 B of data rows a
// row in the fused form). The integer work is a divide and a shared-memory
// OR per entry. What the layouts cost beyond it: device memory is read in
// bursts of 32-64 bytes, so a row's run_off entry (4 of its 40 bytes)
// brings most of its row, and a row's stored entries (a prefix of its
// max_pairs) up to a burst more than they hold. The pack with the stored
// counts and the staging each run near the HBM rate on those bytes; the
// pass over the staged copy adds about a quarter.
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 128;
constexpr int kBlockShift = 7;                // a column block: id >> 7
constexpr int kWarps = kBlock / 32;
constexpr int kWindowWords = 256;
constexpr int kWindowBits = kWindowWords * 32;
constexpr int kStageEntries = kBlock * 32;    // staged entries (16 KB)

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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
                 int* __restrict__ block_cols, int* __restrict__ overflow,
                 float* __restrict__ data_t,
                 unsigned char* __restrict__ row_mask) {
  __shared__ int s_stage[kStageEntries];
  __shared__ unsigned s_bits[kWindowWords];
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

  // the row's stored count, loaded beside the pool (not after its flags)
  const int stored_all =
      in_pool ? run_off[static_cast<long long>(prow) * 10 + 9] : 0;
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
  const int stored = act ? stored_all : 0;
  int total;
  const int first = block_exclusive_scan(stored, s_warp, &total);
  const int n_chunks = (total + kStageEntries - 1) / kStageEntries;

  // Flat entries [f0, f0 + kStageEntries) into s_stage: each warp issues
  // the copies of its 32 rows' entries in that range (row r's place and
  // count from lane r), then one wait. Returns how many were staged.
  auto stage = [&](int f0) {
    __syncthreads();                          // s_stage free
    const int f1 = min(total, f0 + kStageEntries);
    const long long row0 = rb * kBlock + warp * 32 - shift;
#pragma unroll 4
    for (int r = 0; r < 32; ++r) {
      const int a = __shfl_sync(kFull, first, r);
      const int n = __shfl_sync(kFull, stored, r);
      const int lo_f = max(a, f0), hi_f = min(a + n, f1);
      const long long src = (row0 + r) * max_pairs - a;
      for (int f = lo_f + lane; f < hi_f; f += 32)
        cp_async4(&s_stage[f - f0], idx + src + f);
    }
    cp_async_wait_all();
    __syncthreads();
    return f1 - f0;
  };

  // The staged entries' bits in the window of kWindowBits column blocks
  // from `base`, OR-ed into s_bits (a shared-memory atomic an entry), and
  // their lowest and highest block into lo_t, hi_t.
  auto set_bits = [&](long long base, int n, int& lo_t, int& hi_t) {
    for (int j = t; j < n; j += kBlock) {
      const int b = (s_stage[j] + shift) >> kBlockShift;
      lo_t = min(lo_t, b);
      hi_t = max(hi_t, b);
      const long long rel = b - base;
      if (rel >= 0 && rel < kWindowBits)
        atomicOr(&s_bits[rel >> 5], 1u << (rel & 31));
    }
  };

  // The set bits of words [w_begin, w_end) of the window from `base`: each
  // thread counts its words, a block scan gives its place after the
  // n_uniq ids already listed, and it writes its ids in ascending order.
  int* out = block_cols + static_cast<long long>(rb) * maxb;
  long long n_uniq = 0;
  auto emit = [&](long long base, int w_begin, int w_end) {
    __syncthreads();                          // every bit set
    const int n_words = w_end - w_begin;
    const int per = (n_words + kBlock - 1) / kBlock;
    const int w0 = w_begin + min(t * per, n_words);
    const int w1 = min(w0 + per, w_end);
    int mine = 0;
    for (int w = w0; w < w1; ++w) mine += __popc(s_bits[w]);
    int count;
    long long pos = n_uniq + block_exclusive_scan(mine, s_warp, &count);
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
    n_uniq += count;
    __syncthreads();                          // s_bits read
  };

  // One pass over the staged entries: their bounds, and their bits in the
  // window centred on the row block's own column block, which holds every
  // listed block of a grid-ordered pool at the engine's sizes.
  const long long anchor = static_cast<long long>(rb) - kWindowBits / 2;
  for (int w = t; w < kWindowWords; w += kBlock) s_bits[w] = 0u;
  int lo = INT_MAX, hi = -1;
  int held = -1, n_held = 0;                  // the chunk s_stage holds
  for (int c = 0; c < n_chunks; ++c) {
    n_held = stage(c * kStageEntries);
    held = c;
    set_bits(anchor, n_held, lo, hi);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, d));
    hi = max(hi, __shfl_xor_sync(kFull, hi, d));
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
  if (lo <= hi && lo >= anchor && hi < anchor + kWindowBits) {
    emit(anchor, static_cast<int>((lo - anchor) >> 5),
         static_cast<int>((hi - anchor) >> 5) + 1);
  } else if (lo <= hi) {
    // a span past the anchored window: window by window from the lowest
    // block, the entries staged again where they do not fit at once
    for (long long base = lo; base <= hi; base += kWindowBits) {
      const int n_words = static_cast<int>(
          min(static_cast<long long>(kWindowWords), (hi - base) / 32 + 1));
      for (int w = t; w < n_words; w += kBlock) s_bits[w] = 0u;
      __syncthreads();
      int lo_w = INT_MAX, hi_w = -1;
      for (int c = 0; c < n_chunks; ++c) {
        if (c != held) {
          n_held = stage(c * kStageEntries);
          held = c;
        }
        set_bits(base, n_held, lo_w, hi_w);
      }
      emit(base, 0, n_words);
    }
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
