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
// Design. One thread block per (query tile of 64 rows, head, batch); 256
// threads. The TPU's sequential key axis, which carried m, l and acc in
// VMEM scratch from one grid step to the next, becomes a loop inside the
// block over 64-key tiles. Per tile:
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
//
// Bound. 4·D operations per unmasked (query, key) pair (two products of
// 2·D each) against ~2·D bytes per query and key row: at the prefill shapes
// (S ≥ 256) the kernel is bound by operations, not bytes. This version
// uses scalar FP32 FMAs from shared memory; it does not reach the bf16
// tensor-core peak the bound is stated against. wgmma, TMA and a pipelined
// producer/consumer layout are later work.
//
// Layout: q (B, Hq, Sq, D), k and v (B, Hkv, Sk, D), o (B, Hq, Sq, D), all
// contiguous, all f32 or all bf16 (dtype 0 = f32, 1 = bf16).
// D ∈ {16, 32, 64, 128}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
    case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, sk, sk_actual,
                                  kv_offset, causal, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, sk, sk_actual,
                                  kv_offset, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, sk, sk_actual,
                                  kv_offset, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, sk,
                                    sk_actual, kv_offset, causal, scale,
                                    stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success). The
// caller checks shapes and types: hq % hkv == 0, 0 <= sk_actual <= sk,
// d ∈ {16, 32, 64, 128}, dtype 0 (f32) or 1 (bf16), contiguous tensors.
extern "C" int k2_flash_attention(const void* q, const void* k,
                                  const void* v, void* o, int dtype, int b,
                                  int hq, int hkv, int sq, int sk, int d,
                                  int sk_actual, int kv_offset, int causal,
                                  float scale, void* stream) {
  if (b == 0 || hq == 0 || sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, b, hq, hkv, sq, sk, d, sk_actual,
                             kv_offset, causal, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, sk, d,
                                     sk_actual, kv_offset, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
