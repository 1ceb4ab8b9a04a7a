// K1 on Hopper: block-sparse tiled collision force.
//
// Replaces the Pallas TPU kernel repro/kernels/collision_force.py
// (collision_force_kernel, body _kernel, tile math _force_tile). Same
// function: for each 128-agent row block i of the grid-ordered pool, sum
// over the column blocks listed in block_cols[i, :] (ascending, -1 padded)
// the Cortex3D pair force
//     f = -(k_rep·√r_eff·max(δ,0)^1.5 − μ(t_i,t_j)·√(r_eff·max(δ+a,0)))
// over pairs that are both alive, not the same global index, and within
// the band δ + a > 0; nnz counts pairs with f² > (1e-7)².
//
// What bounds it. At the Fig-6 density (1 agent per 64 µm³, diameter 3,
// band 0.4) a row block lists ~10 column blocks, ~1,300 candidates a row,
// of which ~2.6 lie within the reach r_q + r_n + a: about 0.2% of the
// pairs. A pair outside the band contributes exactly nothing (valid is
// false, f = 0: ±0 to the sums, 0 to nnz), so skipping it is exact. The
// kernel therefore runs a cheap test on every candidate and the exact
// arithmetic (IEEE sqrtf, powf, divisions) only on the few that pass: it is
// bound by the instruction rate of that test, ~11 instructions a pair, not
// by the SFU. No tensor cores: a 3-wide difference and dot product per
// pair does not map onto an MMA tile.
//
// The cheap reject. Each agent gets an inflated radius, once per tile (a
// candidate) or per kernel (a row): rho = fl(fl(max(r, 0) + a⁺/2)·slack)
// with a⁺ = max(a, 0), or NaN for a dead agent. Per candidate: dx, dy, dz,
// d2t = fma(dx, dx, fma(dy, dy, dz·dz)), R = rho_q + rho_n; accept iff
// d2t <= R·R. The exact path forms its d2 as the plain version does,
// fl(fl(fl(dx²) + fl(dy²)) + fl(dz²)) with no contraction, so that the
// pairs it keeps, their forces and nnz are those of the plain version bit
// for bit. With u = 2^-24, correctly rounded f32 operations, T = dx² + dy²
// + dz² exactly, and S = fl(r_q + r_n):
//   in_band  <=>  fl(fl(S − D) + a) > 0, where D = fl(√max(d2, 1e-18)).
//   Rounding is monotone and −a is a float, so in_band implies S − D > −a,
//   i.e. D < S + a <= S + a⁺ <= X·(1 + u) with X = r_q⁺ + r_n⁺ + a⁺ (all
//   terms >= 0, S <= fl(r_q⁺ + r_n⁺)), and X >= D > 0. Each rounding of
//   the nonnegative sums and products loses at most a factor (1 − u), so
//   R >= X·slack·(1 − u)³ and fl(R·R) >= X²·slack²·(1 − u)^7, while
//   √d2 <= D/(1 − u) gives d2 < X²·(1 + u)²/(1 − u)². Both d2 and d2t
//   round T three times: d2 >= T·(1 − u)³ and d2t <= T·(1 + u)³, so
//   d2t < X²·(1 + u)^5/(1 − u)^5.
//   Any slack >= (1 + u)^2.5/(1 − u)^6 ≈ 1 + 8.5u accepts every in-band
//   pair; the wrapper passes 1 + 2^-16 (~256u).
//   only makes the test looser. A dead row or candidate has rho = NaN, so
//   R·R is NaN and the test is false: dead agents never reach the exact
//   path (valid would be false for them anyway).
// tests/test_torch_kernels.py mirrors this predicate in numpy and holds it
// against the exact float32 in_band test at the band's edge.
//
// Design. Two warps per 128-row block; thread t holds rows t and t+64, so
// one 16-byte broadcast read of a candidate serves 2 pairs. The block walks
// its own column list (the TPU's sequential column grid axis), which stops
// at the first -1. Column tiles are double-buffered: while tile j is
// tested, cp.async brings tile j+1's six data rows into the other raw
// buffer. Each thread copies, and then packs, the same 4 columns of every
// row, so it waits only on its own copies; the packed tile holds float4
// {x, y, z, rho} per candidate (rho: the test's inflated radius, above),
// its radius and its type.
//
// The test runs over chunks of 32 candidates, unrolled, into one pass bit
// per (candidate, row slot). The exact path is deferred, not branched
// into: after a chunk, the passing pairs are pushed (candidate, row slot,
// lane) onto the warp's queue in shared memory, and when the queue holds
// more than 96 pairs, and at the end of every tile, the warp evaluates the
// queued pairs one per lane; then each lane walks its own entries (linked
// as it pushed them) and adds their results in queue order. Branching into
// the exact path instead ran its ~200 instructions once for each accepting
// lane and row slot with the other lanes idle (PERF.md §6 has the times of
// both designs on the H100).
//
// Sums stay in registers; each output is written once by its own thread,
// with no atomics. Each row adds its pairs in candidate order, as the
// one-thread-per-row kernel did, so results are deterministic and every
// counted pair goes through the same f32 operations; skipped pairs would
// have added ±0.
//
// Numerics. IEEE sqrtf, powf and 1.0f/dist (no --use_fast_math) on every
// pair that passes the test. The exact path spells its products and sums
// with __fmul_rn/__fadd_rn/__fsub_rn where nvcc would contract them into
// FMAs, so each pair's force and its nnz bit (f² > 1e-14, a threshold a
// one-ulp change in d2 can cross) equal those of the plain version on the
// card. A row adds its pairs in another order than the plain version, so
// the tests hold forces to atol 1e-4 and nnz exactly.
//
// Layout: data (8, n_pad) f32 rows [x, y, z, diameter, type, alive, -, -];
// out (4, n_pad) f32 rows [fx, fy, fz, nnz].

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kRows = 2;                    // rows per thread
constexpr int kThreads = kBlock / kRows;
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = 6;                // x, y, z, diameter, type, alive
constexpr int kMaxTypes = 16;
constexpr int kChunk = 32;                  // candidates per test round
constexpr int kQueue = 128;                 // queued pairs per warp
constexpr int kFlushAt = kQueue - 32;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Params {
  const float* data;
  const int* block_cols;
  const float* adhesion;
  float* out;
  int n_pad, maxb, n_types;
  float k_rep, adhesion_band, reach_slack;
};

__global__ void __launch_bounds__(kThreads)
collision_force_kernel(const Params p) {
  __shared__ __align__(16) float raw[2][kChannels][kBlock];
  __shared__ float4 cand[kBlock];           // x, y, z, rho (NaN: dead)
  __shared__ float crn[kBlock];             // r_n
  __shared__ int ctype[kBlock];
  __shared__ float4 srow[kBlock];           // x, y, z, r_q
  __shared__ int stype[kBlock];
  __shared__ float smu[kMaxTypes * kMaxTypes];
  __shared__ int queue[kWarps][kQueue];     // k << 8 | slot << 5 | lane
  __shared__ int queue_next[kWarps][kQueue];   // the lane's next entry
  __shared__ float4 contrib[kWarps][kQueue];   // f·dx/d, f·dy/d, f·dz/d, nnz

  const int rb = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const float nan = __int_as_float(0x7fc00000);
  const float band = p.adhesion_band;
  const float half_band = fmaxf(band, 0.f) * 0.5f;
  // the inflated radius of the cheap test (NaN: dead)
  auto rho = [&](float r, bool alive) {
    return alive ? (fmaxf(r, 0.f) + half_band) * p.reach_slack : nan;
  };
  const int n_pad = p.n_pad;

  for (int k = t; k < p.n_types * p.n_types; k += kThreads)
    smu[k] = p.adhesion[k];

  // thread t copies columns 4t..4t+3 of the data rows of a tile (the first
  // 32 threads; the tile is 6 rows of 512 bytes)
  auto load_tile = [&](int buf, int cb) {
    if (t < 32) {
      const long long base = static_cast<long long>(cb) * kBlock + 4 * t;
#pragma unroll
      for (int c = 0; c < kChannels; ++c)
        cp_async16(&raw[buf][c][4 * t],
                   p.data + c * static_cast<long long>(n_pad) + base);
    }
    cp_async_commit();
  };

  const int* cols = p.block_cols + static_cast<long long>(rb) * p.maxb;
  int cb = p.maxb > 0 ? cols[0] : -1;
  if (cb >= 0) load_tile(0, cb);

  float rx[kRows], ry[kRows], rz[kRows], rp[kRows];
  float fx[kRows], fy[kRows], fz[kRows];
  int nnz[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int lr = t + r * kThreads;
    const int row = rb * kBlock + lr;
    rx[r] = p.data[0 * n_pad + row];
    ry[r] = p.data[1 * n_pad + row];
    rz[r] = p.data[2 * n_pad + row];
    const bool alive = p.data[5 * n_pad + row] > 0.5f;
    const float r_q = p.data[3 * n_pad + row] * 0.5f;
    rp[r] = rho(r_q, alive);
    srow[lr] = make_float4(rx[r], ry[r], rz[r], r_q);
    stype[lr] = static_cast<int>(p.data[4 * n_pad + row]);
    fx[r] = fy[r] = fz[r] = 0.f;
    nnz[r] = 0;
  }

  int* q = queue[warp];
  int* q_next = queue_next[warp];
  float4* qc = contrib[warp];
  int n_queued = 0;                         // uniform across the warp
  int head = -1, tail = -1;                 // this lane's entries, linked

  // The exact arithmetic on every queued pair (one per lane), then each
  // lane walks its own entries, in queue order, and adds their results.
  auto flush = [&](int col_base) {
    __syncwarp();
    for (int e = lane; e < n_queued; e += 32) {
      const int ent = q[e];
      const int k = ent >> 8, slot = (ent >> 5) & 7, owner = ent & 31;
      const int lr = warp * 32 + owner + slot * kThreads;
      const float4 a = srow[lr];
      const float4 c = cand[k];
      const float dx = c.x - a.x;
      const float dy = c.y - a.y;
      const float dz = c.z - a.z;
      // the plain version's d2, ((dx² + dy²) + dz²), each step rounded
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      const float r_q = a.w, r_n = crn[k];
      const float s = r_q + r_n;
      const float dist = sqrtf(fmaxf(d2, 1e-18f));
      const float delta = s - dist;
      const float r_eff = fmaxf(r_q * r_n / fmaxf(s, 1e-12f), 1e-12f);
      float f_mag = p.k_rep * sqrtf(r_eff) * powf(fmaxf(delta, 0.f), 1.5f);
      const bool in_band = delta + band > 0.f;
      if (p.n_types > 0) {
        const int ti = stype[lr], tj = ctype[k];
        const float mu = (ti >= 0 && ti < p.n_types && tj >= 0 &&
                          tj < p.n_types) ? smu[ti * p.n_types + tj] : 0.f;
        const float b = fmaxf(delta + band, 0.f);
        f_mag = __fsub_rn(f_mag, in_band ? __fmul_rn(mu, sqrtf(r_eff * b))
                                         : 0.f);
      }
      // both alive: a NaN radius never passes the test
      const bool valid = rb * kBlock + lr != col_base + k && in_band;
      const float f = valid ? -f_mag : 0.f;
      const float inv = 1.0f / dist;
      qc[e] = make_float4(f * dx * inv, f * dy * inv, f * dz * inv,
                          f * f > 1e-14f ? 1.f : 0.f);
    }
    __syncwarp();
    for (int e = head; e >= 0; e = e == tail ? -1 : q_next[e]) {
      const int slot = (q[e] >> 5) & 7;
      const float4 v = qc[e];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (slot == r) {
          fx[r] += v.x;
          fy[r] += v.y;
          fz[r] += v.z;
          nnz[r] += static_cast<int>(v.w);
        }
      }
    }
    __syncwarp();
    n_queued = 0;
    head = tail = -1;
  };

  for (int j = 0; cb >= 0; ++j) {
    const int buf = j & 1;
    const int next = j + 1 < p.maxb ? cols[j + 1] : -1;   // uniform
    if (next >= 0) {
      load_tile(buf ^ 1, next);
      cp_async_wait<1>();                   // this tile's copies are done
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // the previous tile is consumed
    if (t < 32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * t + i;
        const float r_n = raw[buf][3][k] * 0.5f;
        cand[k] = make_float4(raw[buf][0][k], raw[buf][1][k],
                              raw[buf][2][k],
                              rho(r_n, raw[buf][5][k] > 0.5f));
        crn[k] = r_n;
        ctype[k] = static_cast<int>(raw[buf][4][k]);
      }
    }
    __syncthreads();

    const int col_base = cb * kBlock;
    for (int k0 = 0; k0 < kBlock; k0 += kChunk) {
      // the test, unrolled over a chunk of candidates: bit i of pass[r] says
      // candidate k0 + i passed for row slot r
      unsigned pass[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pass[r] = 0;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float4 c = cand[k0 + i];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float dx = c.x - rx[r];
          const float dy = c.y - ry[r];
          const float dz = c.z - rz[r];
          const float d2 = fmaf(dx, dx, fmaf(dy, dy, dz * dz));
          const float reach = rp[r] + c.w;
          if (d2 <= reach * reach) pass[r] |= 1u << i;
        }
      }
      unsigned any = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) any |= pass[r];
      if (!__any_sync(0xffffffffu, any != 0)) continue;
      // queue the passing pairs, each lane's in (slot, candidate) order at
      // its offset from a warp scan; a round that does not fit is cut, the
      // queue flushed and the rest queued in the next round
      while (true) {
        int cnt = 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) cnt += __popc(pass[r]);
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += v;
        }
        const int total = __shfl_sync(0xffffffffu, incl, 31);
        if (total == 0) break;
        int pos = n_queued + incl - cnt;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          while (pass[r] != 0 && pos < kQueue) {
            const int i = __ffs(pass[r]) - 1;
            q[pos] = (k0 + i) << 8 | r << 5 | lane;
            if (tail >= 0) q_next[tail] = pos;
            else head = pos;
            tail = pos++;
            pass[r] &= pass[r] - 1;
          }
        }
        const bool fit = n_queued + total <= kQueue;
        n_queued = fit ? n_queued + total : kQueue;
        if (!fit || n_queued > kFlushAt) flush(col_base);
        if (fit) break;
      }
    }
    if (n_queued > 0) flush(col_base);      // before the tile is replaced
    cb = next;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = rb * kBlock + t + r * kThreads;
    p.out[0 * n_pad + row] = fx[r];
    p.out[1 * n_pad + row] = fy[r];
    p.out[2 * n_pad + row] = fz[r];
    p.out[3 * n_pad + row] = static_cast<float>(nnz[r]);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes: n_pad a multiple of 128, 8·n_pad < 2^31, n_types <= 16,
// data 16-byte aligned; reach_slack >= (1 + 2^-24)^2.5/(1 - 2^-24)^6 (see
// above).
extern "C" int k1_collision_force(const float* data, int n_pad,
                                  const int* block_cols, int maxb,
                                  const float* adhesion, int n_types,
                                  float k_rep, float adhesion_band,
                                  float reach_slack, float* out,
                                  void* stream) {
  const int n_rb = n_pad / kBlock;
  if (n_rb > 0) {
    const Params p{data, block_cols, adhesion, out, n_pad, maxb, n_types,
                   k_rep, adhesion_band, reach_slack};
    collision_force_kernel<<<n_rb, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
