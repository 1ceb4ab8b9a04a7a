// The first design of kernels/csrc/secretion.cu, kept off every path:
// launch/kernel_variants.py builds it to time it beside the kernel
// that replaced it, on the same inputs.
//
// Secretion into the diffusion grid on Hopper, in slot order: for every
// voxel v, conc[v] <- (((conc[v] + a_i0) + a_i1) + ...) with i0 < i1 < ...
// the agents whose voxel is v.
//
// A port kernel with no TPU counterpart. It replaces what the reference
// computes with an XLA scatter-add (repro/core/diffusion.py::add_sources,
// conc.at[...].add(amount), which XLA:CPU applies in slot order); the
// plain version is torch's index_add on the CPU, which adds in the same
// order. On the card index_add adds by atomics in no fixed order, so two
// runs of one step could differ in the last bits of the grid.
//
// Design. The wrapper sorts the flat voxel indices stably (so a voxel's
// agents stay in slot order) and hands the sorted keys and the permutation
// here. One thread per sorted entry; the thread that starts a voxel's
// segment folds the segment into conc[v] in order with __fadd_rn (no
// contraction, no atomics), starting from conc[v]. Each voxel has one
// writer, so the result is the same on every run. A segment sum added to
// conc[v] at the end would round differently; it is not used.
//
// Bound. Bytes: the sorted keys, the permutation and the amounts read
// once, and each touched voxel read and written once. A voxel with many
// agents is summed serially by one thread, the price of the fixed order.
//
// Lanes. An ensemble's L grids of V voxels are one (L*V,) array, and its
// lane-major rows add into their own lane's grid at voxel + lane*V
// (core/diffusion.py). The lanes' voxel ids are disjoint and each lane's
// rows are contiguous and in slot order, so the stable sort keeps every
// voxel's amounts in its lane's slot order: one launch for every lane
// gives each lane's grid exactly its solo call's. The kernel needs no
// change for it.
//
// Layout: keys (N,) int64, sorted; perm (N,) int64; amount (N,) f32; conc
// (V,) f32, updated in place.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
secretion_kernel(const long long* __restrict__ keys,
                 const long long* __restrict__ perm,
                 const float* __restrict__ amount, long long n,
                 float* __restrict__ conc) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n) return;
  const long long v = keys[i];
  if (i > 0 && keys[i - 1] == v) return;      // not the segment's start
  float acc = conc[v];
  for (long long j = i; j < n && keys[j] == v; ++j) {
    acc = __fadd_rn(acc, amount[perm[j]]);
  }
  conc[v] = acc;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success). The
// caller checks shapes and that every key indexes conc.
extern "C" int secretion_add(const long long* keys, const long long* perm,
                             const float* amount, long long n, float* conc,
                             void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    secretion_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(keys, perm,
                                                             amount, n, conc);
  }
  return static_cast<int>(cudaGetLastError());
}
