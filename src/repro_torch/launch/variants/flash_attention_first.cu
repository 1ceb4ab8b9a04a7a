// The first designs of K2's kernels in kernels/csrc/flash_attention.cu,
// kept off every path: launch/kernel_variants.py builds this file to time
// them beside the kernels that replaced them, on the same inputs, and
// chip_smoke.py checks that the tensor-core kernel at D 64 and 128, which
// the redesign left as it was, gives the same bits in both libraries.
// Trimmed to what that comparison needs: the tensor-core kernel at D 64,
// 96 (the D 128 kernel on zero columns) and 128, and the scalar kernel in
// f32 at D 96 and 128; any other input returns cudaErrorInvalidValue.
//
// K2 on Hopper: flash attention (online softmax), GQA, causal or not.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_kernel, body _flash_kernel). Same function: for query
// head h of batch b, with KV head h / group,
//     o = softmax(q·kᵀ·scale) · v
// over the keys kpos < sk_actual, and, when causal, kpos <= qpos + kv_offset
// (queries aligned to the end of the keys). Masked scores are -1e30 and
// their p is forced to 0; a row whose normaliser l stays 0 writes 0.
// Accumulation is f32 whatever the input type; the output takes q's type.
//
// Two kernels, chosen statically by type and head dim:
//   * bf16 with D ∈ {64, 96, 128}: `tc::flash_attention_tc`, on the tensor
//     cores (below). This is the serving path (qwen2, qwen3, yi: D 128;
//     phi-3-vision: D 96).
//   * f32 (any D) and bf16 with D ∈ {16, 32}: the scalar kernel
//     `flash_attention_kernel`. TF32 keeps about three decimal digits and
//     would miss the f32 tolerance of 2e-5, so f32 stays on FP32 FMAs; D 16
//     and 32 are narrower than one 128-byte swizzled row.
//
// Bound. 4·D operations per visible (query, key) pair (two products of
// 2·D each) against ~2·D bytes per query and key row: at the prefill shapes
// (S ≥ 256) the function is bound by operations on the bf16 tensor cores.
//
// ---- The tensor-core kernel (bf16, D 64, 96 or 128) ----
// One block per (128 query rows, head, batch), 384 threads: warpgroup 0 is
// the producer, warpgroups 1 and 2 are consumers of 64 query rows each.
// `setmaxnreg` moves registers from the producer (24) to the consumers
// (240; ptxas reports the 168 a block starts with). Blocks are ordered
// heavy-first: under the causal mask the last query tiles see the most
// keys, so they start in the first wave (S 4096, 12 heads: 384 blocks for
// 132 SMs; S 256-2048: 24-192).
//   * Tiles stay bf16 in shared memory. One thread of the producer issues
//     TMA loads (`cp.async.bulk.tensor`, 128-byte swizzle) through tensor
//     maps that the host encodes from the views' strides, so strided q/k/v
//     (a transposed V) need no copy. Q is loaded once; K and V move through
//     a ring of kStages = 3 stages of 64 keys, each with a full barrier per
//     operand and an empty barrier the 8 consumer warps arrive on: while
//     tile t-1 is in P·V and tile t in Q·Kᵀ, tile t+1 loads. The key
//     tensor map ends at sk_actual, so padded keys arrive as zeros.
//     Shared memory: 132 KB at D 128 and 96, 66 KB at D 64.
//   * D 96 runs as D 128 with zeros in columns 96-127: its tiles are two
//     64-column sub-tiles, and the second box of each reads columns 64-127
//     of a map whose inner dim is 96, so TMA fills 96-127 with zeros (and
//     counts the whole box's bytes). Q·Kᵀ takes the 6 k-steps of the real
//     columns; P·V runs m64n128k16 (the MN-major V operand is read in
//     whole 64-column swizzle atoms), whose last 32 output columns are
//     P·0 = 0 and are not stored. Exact; P·V does 4/3 of its work.
//   * S = Q·Kᵀ by `wgmma` m64n64k16 (A and B from shared memory through
//     descriptors, both K-major), f32 accumulator in registers.
//   * Masks and the online softmax run on that accumulator fragment: row
//     max by quad shuffles, p = exp2f(s·scale·log2e − m), l summed per
//     thread from the f32 p and reduced once at the end; alpha rescales
//     the output accumulator in place. Only tiles that cross the diagonal
//     or sk_actual evaluate the mask; tiles wholly above the block's
//     diagonal are never loaded (the loop bound).
//   * O += P·V by `wgmma` m64nDk16 (D 96: n128) with A (P) in registers and V read from
//     shared memory as an MN-major operand (stored keys × D: transpose bit).
//     P is split into P_hi = bf16(p) and P_lo = bf16(p − P_hi), two
//     products per 16 keys. Why: with P rounded once to bf16 (as
//     FlashAttention-2/3 and SDPA do), the output misses the port's bf16
//     check |Δ| ≤ 1e-3 + 1.6e-2·|plain| on rows with few keys, where the
//     rounding errors do not average out. A CPU emulation (bf16 q/k/v from
//     N(0,1), causal, Hq 12, Hkv 2, D 128) gave the largest |Δ| over that
//     bound as 1.89 at S 1781 (31 elements over) and 1.96 at S 4096 (21
//     over) for one bf16 P, against 0.368 and 0.363 (none over) for
//     P_hi + P_lo, whose residual is ≤ 2⁻¹⁸·p. The split costs 1.5× the
//     tensor-core work of one P.
//   * Each consumer keeps two tiles' products in flight: it issues S_t and
//     P_{t-1}·V_{t-1} together and runs tile t's softmax while the P·V
//     (two thirds of the tensor work) is still running.
// Tried and left out (PERF.md §6; launch/k2_variants.py rebuilds
// the first two): ex2.approx for exp2f (faster, but it spills at D 128),
// Q's fragments held in registers for an RS-form Q·Kᵀ (spills, and ptxas
// serializes the wgmmas), and the two consumers taking turns on named
// barriers (spilled at D 128, no faster).
// No tensor-map encode, launch or wait falls back: an encode failure is
// returned as 10000 + its CUresult, and a barrier wait that has not
// completed after ~2³² cycles traps instead of hanging the card.
//
// Layout: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D) with unit stride along
// D, o (B, Hq, Sq, D) contiguous, all f32 or all bf16 (dtype 0 = f32,
// 1 = bf16). Strides are in elements. The tensor-core kernel takes any
// (B, H, S) strides that are multiples of 8 with a 16-byte-aligned base;
// the scalar kernel takes contiguous tensors only.
//
// ---- The scalar kernel (f32; bf16 with D 16 or 32) ----
// One thread block per (query tile of 64 rows, head, batch); 256 threads.
// The TPU's sequential key axis, which carried m, l and acc in VMEM scratch
// from one grid step to the next, becomes a loop inside the block over
// 64-key tiles. Per tile:
//   1. stage K (converted to f32) in shared memory; rows past sk_actual
//      are zero (they are masked anyway);
//   2. S = Q·Kᵀ·scale: each thread computes a 4×4 micro-tile from shared
//      memory with scalar FMAs, applies the masks, writes S to shared;
//   3. online softmax: each warp owns 8 rows, two columns a lane, warp
//      shuffles for the row max and sum; m, l and the rescale factor alpha
//      live in shared memory; p overwrites S. Meanwhile V is staged into
//      the buffer K used, so one K/V buffer serves both;
//   4. acc = acc·alpha + P·V: each thread keeps a 4×(D/16) block of the
//      output in registers.
// Shared memory is 83 KB at D = 128 (two blocks per SM), 50 KB at D = 64.
// Causal key tiles wholly above the diagonal are not visited: the loop
// stops at the last tile that holds a key some row of the block may see
// (skipping such a tile changes nothing: its p are all 0 and alpha is 1).
// Q and K/V rows are padded by one float in shared memory so the strided
// reads of step 2 hit different banks.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q tile and one K/V tile (row stride D+1), S/P tile (row stride
  // kBlockK+1), m, l, alpha.
  return sizeof(float) * (kBlockQ * (D + 1) + kBlockK * (D + 1) +
                          kBlockQ * (kBlockK + 1) + 3 * kBlockQ);
}

// Rows k0 .. k0+63 of one (b, kv head) slab into `dst` as f32, row stride
// D+1; rows at or past sk_actual are zero. Coalesced: consecutive threads
// read consecutive elements.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           float* dst, long long base,
                                           int k0, int sk_actual) {
  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        (k0 + r < sk_actual)
            ? to_f32(src[base + static_cast<long long>(k0 + r) * D + c])
            : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int sq, int sk, int sk_actual, int kv_offset,
                       int causal, float scale) {
  static_assert(kBlockQ == 64 && kBlockK == 64 && kThreads == 256,
                "the thread layout below assumes 64×64 tiles, 256 threads");
  constexpr int kLd = D + 1;                  // Q, K/V row stride (floats)
  constexpr int kLdS = kBlockK + 1;
  constexpr int kCols = D / 16;               // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;                           // [kBlockQ][kLd]
  float* kv = qs + kBlockQ * kLd;             // [kBlockK][kLd]: K, then V
  float* ss = kv + kBlockK * kLd;             // [kBlockQ][kLdS]
  float* m_s = ss + kBlockQ * kLdS;           // [kBlockQ]
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;                    // column lane of micro-tiles
  const int ty = tid / 16;                    // row lane of micro-tiles
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / hkv;
  const long long q_base = ((static_cast<long long>(b) * hq + h) * sq) * D;
  const long long kv_base =
      ((static_cast<long long>(b) * hkv + h / g) * sk) * D;

  // Stage this block's queries; rows past sq are zero and never written.
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * kLd + c] =
        (q0 + r < sq) ? to_f32(q[q_base + static_cast<long long>(q0 + r) * D
                                 + c])
                      : 0.f;
  }
  if (tid < kBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // Key tiles to visit: those holding a key below sk_actual and, when
  // causal, at or below the block's last query position.
  int n_tiles = (sk_actual + kBlockK - 1) / kBlockK;
  if (causal) {
    const int qhi = q0 + kBlockQ - 1 + kv_offset;
    n_tiles = qhi < 0 ? 0 : min(n_tiles, qhi / kBlockK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();                          // previous tile consumed
    stage_tile<T, D>(k, kv, kv_base, k0, sk_actual);
    __syncthreads();

    // 2. scores for rows ty + 16·i, keys tx + 16·j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kv[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + kv_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool keep = kpos < sk_actual && (!causal || kpos <= qpos);
        ss[r * kLdS + c] = keep ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    stage_tile<T, D>(v, kv, kv_base, k0, sk_actual);   // K is consumed

    // 3. online softmax: warp w owns rows 8w .. 8w+7, lane owns keys
    //    lane and lane + 32.
    for (int rr = 0; rr < kBlockQ / 8; ++rr) {
      const int r = warp * (kBlockQ / 8) + rr;
      const int qpos = q0 + r + kv_offset;
      const float s0 = ss[r * kLdS + lane];
      const float s1 = ss[r * kLdS + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const int kp0 = k0 + lane, kp1 = k0 + lane + 32;
      const bool keep0 = kp0 < sk_actual && (!causal || kp0 <= qpos);
      const bool keep1 = kp1 < sk_actual && (!causal || kp1 <= qpos);
      const float p0 = keep0 ? expf(s0 - m_new) : 0.f;
      const float p1 = keep1 ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o_);
      ss[r * kLdS + lane] = p0;
      ss[r * kLdS + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc·alpha + P·V for rows ty + 16·i, columns tx + 16·j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * kLdS + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = kv[kk * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();                            // l_s final for every row

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    const float l = l_s[r];
    const float denom = l > 0.f ? l : 1.f;
    T* out = o + q_base + static_cast<long long>(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      out[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, int sk_actual, int kv_offset,
           int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, hq, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk,
      sk_actual, kv_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int sk, int d, int sk_actual,
               int kv_offset, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 96: return launch<T, 96>(q, k, v, o, b, hq, hkv, sq, sk, sk_actual,
                                  kv_offset, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, sk,
                                    sk_actual, kv_offset, causal, scale,
                                    stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace tc {

constexpr int kRowsWg = 64;                  // query rows per consumer
constexpr int kConsumers = 2;
constexpr int kBlockQ = kRowsWg * kConsumers;
constexpr int kBlockK = 64;                  // keys per tile
constexpr int kStages = 3;                   // K/V ring depth
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 24;            // 24 + 2·240 = 3·168, the
constexpr int kConsumerRegs = 240;           // registers a block starts with
constexpr int kSubCols = 64;                 // bf16 columns per 128-byte row
constexpr int kSubBytes = 64 * 128;          // 64 rows of one such sub-tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr long long kWaitCycles = 1ll << 32;
constexpr int kEncodeError = 10000;          // + CUresult of a failed encode

static_assert(kRowsWg == kBlockK, "Q and K/V tiles share one TMA box");

// Columns a tile holds: D rounded up to whole 64-column sub-tiles (D 96
// holds 128, the last 32 zero).
template <int D>
__host__ __device__ constexpr int padded() {
  return (D + kSubCols - 1) / kSubCols * kSubCols;
}

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return (padded<D>() / kSubCols) * kSubBytes;
}

// Q tiles, the K and V rings, 3·kStages + 1 barriers, and the slack that
// aligns the base to the 1024 bytes of a swizzle atom.
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + static_cast<size_t>(tile_bytes<D>()) *
                    (kConsumers + 2 * kStages) +
         8 * (3 * kStages + 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// One TMA box (64 columns × 64 rows of one head) into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head), "r"(batch)
      : "memory");
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <uint32_t N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma still owns across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory descriptor for a tile in 128-byte swizzled rows (what
// TMA's SWIZZLE_128B writes; atoms of 8 rows = 1024 bytes): start address,
// leading and stride byte offsets in 16-byte units, layout 1 = 128B swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | (1ull << 62);
}

// K-major operand (Q or K: rows × D, D contiguous), k-step kk of 16 columns:
// sub-tile kk / 4, 32 bytes per step inside its 128-byte rows; 8-row atoms
// 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * kSubBytes + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (V: keys × D, D contiguous), k-step kk of 16 keys:
// 16 rows of 128 bytes per step; the D halves (64 columns each) are
// kSubBytes apart (leading offset), 8-key atoms 1024 bytes (stride offset).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * 128, kSubBytes, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x: low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// (p0, p1) → hi = bf16 pair of p, lo = bf16 pair of p − hi.
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(p0, p1);
  lo = pack_bf16(p0 - __uint_as_float(hi << 16),
                 p1 - __uint_as_float(hi & 0xFFFF0000u));
}

// D[64×64] (+)= A·B, A and B bf16 in shared memory (descriptors), both
// K-major; the first k-step of a product passes scale_d = 0 (overwrite).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64×64] += A·B, A bf16 in registers (the fragment a), B bf16 in shared
// memory, MN-major (transposed: stored K rows × N contiguous).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64×128] += A·B, A bf16 in registers (the fragment a), B bf16 in shared
// memory, MN-major (transposed: stored K rows × N contiguous).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, desc_v);
  } else {
    static_assert(D == 128, "wgmma_pv takes n64 or n128 (D 96 runs n128)");
    wgmma_rs_n128(d, a, desc_v);
  }
}

struct Masks {
  int sq, sk_actual, kv_offset, causal;

  __device__ __forceinline__ bool keep(int kpos, int qpos) const {
    return kpos < sk_actual && (!causal || kpos <= qpos);
  }

  // Key tiles that query rows [lo, hi) (cut at sq) may see: those holding
  // a key below sk_actual and, when causal, at or below the last row.
  __device__ __forceinline__ int tiles(int lo, int hi) const {
    const int last = min(hi, sq) - 1;
    if (last < lo) return 0;
    int n = (sk_actual + kBlockK - 1) / kBlockK;
    if (causal) {
      const int kmax = last + kv_offset;
      n = kmax < 0 ? 0 : min(n, kmax / kBlockK + 1);
    }
    return n;
  }
};

// Online softmax on one 64×64 score fragment of a warpgroup. The thread
// holds rows qrow and qrow + 8 (absolute query rows), keys
// k0 + 8j + c0 + {0, 1}, j < 8, at s[4j + 2i + {0, 1}] for row i. On
// return s holds p, m and l are updated and alpha is each row's rescale.
template <bool Masked>
__device__ __forceinline__ void softmax_tile(float (&s)[kBlockK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Masks& mk, int k0,
                                             int qrow, int c0,
                                             float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qrow + 8 * i + mk.kv_offset;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * i + c];
        x *= scale_log2;
        if (Masked && !mk.keep(k0 + 8 * j + c0 + c, qpos)) x = kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    alpha[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * i + c];
        x = (!Masked || mk.keep(k0 + 8 * j + c0 + c, qpos))
                ? exp2f(x - m_new)
                : 0.f;
        sum += x;
      }
    l[i] = l[i] * alpha[i] + sum;
  }
}

struct Smem {
  uint8_t* q;           // [kConsumers] tiles
  uint8_t* k;           // [kStages] tiles
  uint8_t* v;           // [kStages] tiles
  uint64_t* q_full;
  uint64_t* k_full;     // [kStages]
  uint64_t* v_full;     // [kStages]
  uint64_t* empty;      // [kStages]
};

template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        const Smem& sm, int q0, int h,
                                        int kvh, int b, int n_tiles) {
  constexpr int kSubs = padded<D>() / kSubCols;
  constexpr int kTile = tile_bytes<D>();
  mbar_expect_tx(sm.q_full, kConsumers * kTile);
  for (int w = 0; w < kConsumers; ++w)
    for (int sub = 0; sub < kSubs; ++sub)
      tma_load(sm.q + w * kTile + sub * kSubBytes, tm_q, sm.q_full,
               sub * kSubCols, q0 + w * kRowsWg, h, b);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    mbar_wait(&sm.empty[st], ((t / kStages) & 1) ^ 1);   // slot released
    mbar_expect_tx(&sm.k_full[st], kTile);
    for (int sub = 0; sub < kSubs; ++sub)
      tma_load(sm.k + st * kTile + sub * kSubBytes, tm_k, &sm.k_full[st],
               sub * kSubCols, t * kBlockK, kvh, b);
    mbar_expect_tx(&sm.v_full[st], kTile);
    for (int sub = 0; sub < kSubs; ++sub)
      tma_load(sm.v + st * kTile + sub * kSubBytes, tm_v, &sm.v_full[st],
               sub * kSubCols, t * kBlockK, kvh, b);
  }
}

// Consumer warpgroup c (query rows q0 + 64c .. q0 + 64c + 63), with the
// products of two tiles in flight: in iteration t it issues S_t = Q·K_tᵀ
// and O += P_{t-1}·V_{t-1} together, waits for S_t only, and runs tile t's
// softmax while P_{t-1}·V_{t-1} is still on the tensor cores; then it
// rescales O by alpha_t and splits P_t. The first tile's S and the last
// tile's P·V are issued outside the loop, so that every wgmma in the loop
// is issued unconditionally (a conditional one makes ptxas serialize them
// all). Both warpgroups visit every tile the block loads: a tile wholly
// masked for the first warpgroup's rows gives p = 0 there. The accumulator
// holds padded<D>() columns; those past D stay 0 and are not stored.
template <int D>
__device__ __forceinline__ void consume(int c, const Smem& sm,
                                        const Masks& mk, int q0,
                                        int n_tiles,
                                        __nv_bfloat16* __restrict__ o_head,
                                        float scale_log2) {
  constexpr int kTile = tile_bytes<D>();
  constexpr int kDp = padded<D>();
  const int t128 = threadIdx.x % 128;
  const int lane = t128 % 32;
  const int r0 = (t128 / 32) * 16 + lane / 4;   // fragment rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);                // columns c0, c0 + 1 of 8
  const int row_lo = q0 + c * kRowsWg;
  const uint32_t q_tile = smem_u32(sm.q + c * kTile);

  float acc[kDp / 2];
#pragma unroll
  for (int i = 0; i < kDp / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float s[kBlockK / 2];
  float alpha[2];
  uint32_t p_hi[kBlockK / 16][4], p_lo[kBlockK / 16][4];

  auto issue_s = [&](int t) {                   // S_t = Q·K_tᵀ
    const uint32_t k_tile = smem_u32(sm.k + (t % kStages) * kTile);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc(q_tile, kk), kmajor_desc(k_tile, kk),
                   kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int t) {                  // O += P_hi·V_t + P_lo·V_t
    const uint32_t v_tile = smem_u32(sm.v + (t % kStages) * kTile);
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      wgmma_pv<kDp>(acc, p_hi[kk], mnmajor_desc(v_tile, kk));
      wgmma_pv<kDp>(acc, p_lo[kk], mnmajor_desc(v_tile, kk));
    }
    wgmma_commit();
  };
  auto softmax = [&](int t) {
    const int k0 = t * kBlockK;
    if (k0 + kBlockK > mk.sk_actual ||
        (mk.causal && k0 + kBlockK - 1 > row_lo + mk.kv_offset))
      softmax_tile<true>(s, m, l, alpha, mk, k0, row_lo + r0, c0,
                         scale_log2);
    else
      softmax_tile<false>(s, m, l, alpha, mk, k0, row_lo + r0, c0,
                          scale_log2);
  };
  auto rescale_and_split = [&]() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] *= alpha[i];
        acc[4 * j + 2 * i + 1] *= alpha[i];
      }
    // the accumulator's column blocks 2kk and 2kk + 1 are the k halves of
    // P's A fragment for keys 16kk .. 16kk + 15
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * (2 * kk + r / 2) + 2 * (r % 2);
        split_pair(s[e], s[e + 1], p_hi[kk][r], p_lo[kk][r]);
      }
  };
  auto phase = [](int t) { return static_cast<uint32_t>((t / kStages) & 1); };

  mbar_wait(sm.q_full, 0);
  if (n_tiles > 0) {
    mbar_wait(&sm.k_full[0], 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait_all();
    fence_regs(s);
    softmax(0);
    rescale_and_split();
    for (int t = 1; t < n_tiles; ++t) {
      mbar_wait(&sm.k_full[t % kStages], phase(t));
      mbar_wait(&sm.v_full[(t - 1) % kStages], phase(t - 1));
      fence_regs(acc);
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      wgmma_wait_one();                         // S_t done, P·V may run
      fence_regs(s);
      softmax(t);
      wgmma_wait_all();                         // P_{t-1}·V_{t-1} done
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[(t - 1) % kStages]);
      rescale_and_split();
    }
    mbar_wait(&sm.v_full[(n_tiles - 1) % kStages], phase(n_tiles - 1));
    fence_regs(acc);
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = row_lo + r0 + 8 * i;
    if (row >= mk.sq) continue;
    const float denom = li > 0.f ? li : 1.f;
    __nv_bfloat16* out = o_head + static_cast<long long>(row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] / denom,
                                acc[4 * j + 2 * i + 1] / denom);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int hq, int hkv, int sq,
                   int sk_actual, int kv_offset, int causal,
                   float scale_log2) {
  constexpr int kTile = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Smem sm;
  sm.q = base;
  sm.k = sm.q + kConsumers * kTile;
  sm.v = sm.k + kStages * kTile;
  sm.q_full = reinterpret_cast<uint64_t*>(sm.v + kStages * kTile);
  sm.k_full = sm.q_full + 1;
  sm.v_full = sm.k_full + kStages;
  sm.empty = sm.v_full + kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;   // heavy first
  const Masks mk{sq, sk_actual, kv_offset, causal};
  const int n_tiles = mk.tiles(q0, q0 + kBlockQ);

  if (threadIdx.x == 0) {
    mbar_init(sm.q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);    // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0)
      produce<D>(&tm_q, &tm_k, &tm_v, sm, q0, h, h / (hq / hkv), b,
                 n_tiles);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D>(threadIdx.x / 128 - 1, sm, mk, q0, n_tiles,
               o + (static_cast<long long>(b) * hq + h) * sq * D,
               scale_log2);
  }
}

// cuTensorMapEncodeTiled, taken from the driver at run time so that the
// library links nothing beyond the CUDA runtime.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 4-D map of a (B, H, rows, D) bf16 view, innermost first, with its element
// strides; boxes of 64 columns × 64 rows, 128-byte swizzle, zeros outside.
int encode(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
           int batch, long long s_row, long long s_head, long long s_batch) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {kSubCols, kRowsWg, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk_actual, int kv_offset, int causal,
           float scale, const long long* qs, const long long* ks,
           const long long* vs, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  // keys at or past sk_actual are outside the key maps: they load as 0.
  // With no key at all nothing is loaded, and q's base stands in for k's
  // and v's (an empty tensor may have none).
  const int rows_kv = sk_actual > 0 ? sk_actual : 1;
  int err = encode(&tm_q, q, D, sq, hq, b, qs[2], qs[1], qs[0]);
  if (err == 0) err = encode(&tm_k, sk_actual > 0 ? k : q, D, rows_kv, hkv,
                             b, ks[2], ks[1], ks[0]);
  if (err == 0) err = encode(&tm_v, sk_actual > 0 ? v : q, D, rows_kv, hkv,
                             b, vs[2], vs[1], vs[0]);
  if (err != 0) return err;
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attention_tc<D>;
  static unsigned smem_set = 0;               // a bit per device
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (dev >= 32 || !((smem_set >> dev) & 1u)) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (dev < 32) smem_set |= 1u << dev;
  }
  const dim3 grid(hq, b, (sq + kBlockQ - 1) / kBlockQ);
  kern<<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), hq, hkv, sq,
      sk_actual, kv_offset, causal, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

bool contiguous(const long long* s, int h, int rows, int d) {
  return s[2] == d && s[1] == static_cast<long long>(rows) * d &&
         s[0] == static_cast<long long>(h) * rows * d;
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success), or 10000
// + the CUresult of a failed tensor-map encode. The caller checks shapes and
// types: hq % hkv == 0, 0 <= sk_actual <= sk, d ∈ {16, 32, 64, 96, 128},
// dtype 0 (f32) or 1 (bf16), o contiguous. q_s*, k_s*, v_s* are the (B, H,
// S) strides in elements (D's is 1): bf16 with d 64, 96 or 128 takes multiples
// of 8 on a 16-byte-aligned base, every other input must be contiguous.
extern "C" int k2_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int hq, int hkv, int sq, int sk, int d, int sk_actual, int kv_offset,
    int causal, float scale, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long qs[3] = {q_sb, q_sh, q_ss};
  const long long ks[3] = {k_sb, k_sh, k_ss};
  const long long vs[3] = {v_sb, v_sh, v_ss};
  if (dtype == 1 && d == 64)
    return tc::launch<64>(q, k, v, o, b, hq, hkv, sq, sk_actual, kv_offset,
                          causal, scale, qs, ks, vs, s);
  if (dtype == 1 && d == 96)
    return tc::launch<96>(q, k, v, o, b, hq, hkv, sq, sk_actual, kv_offset,
                          causal, scale, qs, ks, vs, s);
  if (dtype == 1 && d == 128)
    return tc::launch<128>(q, k, v, o, b, hq, hkv, sq, sk_actual, kv_offset,
                           causal, scale, qs, ks, vs, s);
  if (!contiguous(qs, hq, sq, d) || !contiguous(ks, hkv, sk, d) ||
      !contiguous(vs, hkv, sk, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, b, hq, hkv, sq, sk, d, sk_actual,
                             kv_offset, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
