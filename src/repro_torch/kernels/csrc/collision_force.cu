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
// Design. One thread block per row block, one thread per row. The TPU's
// sequential column grid axis becomes the loop over the block's own column
// list, which stops at the first -1 (the list is compacted, so a -1 ends
// it; a fully static row block has an empty list and does no work). Each
// listed column block's 128 agents are staged in shared memory (SoA, one
// coalesced load per channel), then every thread walks the 128 candidates
// and accumulates fx, fy, fz and nnz in registers. No atomics: each output
// is written once by its own thread, so results are deterministic.
//
// Bound. The tile work is ~128² pair evaluations per listed column block,
// with sqrt, pow and a division per pair: the kernel is bound by FP32
// operations (and the SFU), not by bytes — it reads 32 B and writes 16 B
// per agent. Speed work (wider tiles per thread, fewer SFU calls, register
// blocking) comes later; this version is the simple, right one.
//
// Numerics. IEEE sqrtf, powf and 1.0f/dist (no --use_fast_math). nvcc
// contracts a*b+c into FMA by default, so sums differ from the CPU's plain
// version in the last bits; the tests hold forces to atol 1e-4.
//
// Layout: data (8, n_pad) f32 rows [x, y, z, diameter, type, alive, -, -];
// out (4, n_pad) f32 rows [fx, fy, fz, nnz].

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxTypes = 16;

__global__ void __launch_bounds__(kBlock)
collision_force_kernel(const float* __restrict__ data, int n_pad,
                       const int* __restrict__ block_cols, int maxb,
                       const float* __restrict__ adhesion, int n_types,
                       float k_rep, float adhesion_band,
                       float* __restrict__ out) {
  __shared__ float sx[kBlock], sy[kBlock], sz[kBlock];
  __shared__ float sdia[kBlock], stype[kBlock], salive[kBlock];
  __shared__ float smu[kMaxTypes * kMaxTypes];

  const int rb = blockIdx.x;
  const int t = threadIdx.x;
  const int row = rb * kBlock + t;

  for (int k = t; k < n_types * n_types; k += kBlock) smu[k] = adhesion[k];

  const float rx = data[0 * n_pad + row];
  const float ry = data[1 * n_pad + row];
  const float rz = data[2 * n_pad + row];
  const float r_q = data[3 * n_pad + row] * 0.5f;
  const int ti = static_cast<int>(data[4 * n_pad + row]);
  const bool row_alive = data[5 * n_pad + row] > 0.5f;
  const bool ti_ok = ti >= 0 && ti < n_types;

  float fx = 0.f, fy = 0.f, fz = 0.f;
  int nnz = 0;
  const int* cols = block_cols + static_cast<long long>(rb) * maxb;

  for (int j = 0; j < maxb; ++j) {
    const int cb = cols[j];                 // uniform across the block
    if (cb < 0) break;
    __syncthreads();                        // previous tile fully consumed
    const int c = cb * kBlock + t;
    sx[t] = data[0 * n_pad + c];
    sy[t] = data[1 * n_pad + c];
    sz[t] = data[2 * n_pad + c];
    sdia[t] = data[3 * n_pad + c];
    stype[t] = data[4 * n_pad + c];
    salive[t] = data[5 * n_pad + c];
    __syncthreads();

    const int col_base = cb * kBlock;
    for (int k = 0; k < kBlock; ++k) {
      const float dx = sx[k] - rx;
      const float dy = sy[k] - ry;
      const float dz = sz[k] - rz;
      const float dist = sqrtf(fmaxf(dx * dx + dy * dy + dz * dz, 1e-18f));
      const float r_n = sdia[k] * 0.5f;
      const float delta = r_q + r_n - dist;
      const float r_eff = fmaxf(r_q * r_n / fmaxf(r_q + r_n, 1e-12f), 1e-12f);
      float f_mag = k_rep * sqrtf(r_eff) * powf(fmaxf(delta, 0.f), 1.5f);
      const bool in_band = delta + adhesion_band > 0.f;
      if (n_types > 0) {
        const int tj = static_cast<int>(stype[k]);
        const float mu = (ti_ok && tj >= 0 && tj < n_types)
                             ? smu[ti * n_types + tj] : 0.f;
        const float band = fmaxf(delta + adhesion_band, 0.f);
        f_mag -= in_band ? mu * sqrtf(r_eff * band) : 0.f;
      }
      const bool valid = row_alive && salive[k] > 0.5f &&
                         row != col_base + k && in_band;
      const float f = valid ? -f_mag : 0.f;
      const float inv = 1.0f / dist;
      fx += f * dx * inv;
      fy += f * dy * inv;
      fz += f * dz * inv;
      nnz += (f * f > 1e-14f) ? 1 : 0;
    }
  }
  out[0 * n_pad + row] = fx;
  out[1 * n_pad + row] = fy;
  out[2 * n_pad + row] = fz;
  out[3 * n_pad + row] = static_cast<float>(nnz);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The caller
// checks shapes: n_pad a multiple of 128, 8·n_pad < 2^31, n_types ≤ 16.
extern "C" int k1_collision_force(const float* data, int n_pad,
                                  const int* block_cols, int maxb,
                                  const float* adhesion, int n_types,
                                  float k_rep, float adhesion_band,
                                  float* out, void* stream) {
  const int n_rb = n_pad / kBlock;
  if (n_rb > 0) {
    collision_force_kernel<<<n_rb, kBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        data, n_pad, block_cols, maxb, adhesion, n_types, k_rep,
        adhesion_band, out);
  }
  return static_cast<int>(cudaGetLastError());
}
