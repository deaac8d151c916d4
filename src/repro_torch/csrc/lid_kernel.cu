// Batched Hill / MLE LID estimate for NVIDIA Hopper (sm_90a): (B, k)
// ascending squared k-NN distances -> (B,) estimates
//   r = sqrt(max(d2, 1e-24)),  LID = -1 / min(mean_i ln(r_i / r_k), -1/4096).
//
// Replaces the TPU kernel repro/kernels/lid_kernel.py::lid_estimate (Pallas,
// `_lid_kernel`: one (512, k) tile per grid step, sqrt + log + mean +
// reciprocal fused in VMEM).  Semantics are those of
// repro_torch/kernels/ref.py::lid_ref, with that kernel's own clamp (1e-24 on
// d2); repro_torch/core/lid.py keeps its own clamp (1e-12 on r) elsewhere.
//
// What bounds it on this card: bytes.  It reads B*k floats once and writes B
// (at 1M x 16, 68 MB: about 0.02 ms at 3.35 TB/s) and does a few
// transcendental operations per element.
//
// What the design does about it: one warp per row, lane j taking elements j,
// j+32, ...; the sum of the logs is a warp shuffle reduction, so a row is
// one pass with no shared memory.  sqrtf, logf and the divisions are the
// IEEE-accurate ones: the library is built without --use_fast_math, which
// the 1e-4 tolerance against the plain version needs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
lid_kernel(const float* __restrict__ d2, float* __restrict__ out, int b, int k) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= b) return;   // whole warps leave together
  const float* r = d2 + (size_t)row * k;
  const float rk = sqrtf(fmaxf(r[k - 1], 1e-24f));
  float sum = 0.f;
  for (int j = lane; j < k; j += 32) sum += logf(sqrtf(fmaxf(r[j], 1e-24f)) / rk);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) {
    const float mean = sum / static_cast<float>(k);
    out[row] = -1.f / fminf(mean, -1.f / 4096.f);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  d2 (b, k) float32 row-major, out
// (b,) float32.  Launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so the caller can raise on a
// refused launch.
extern "C" int repro_lid_estimate(int b, int k, const void* d2, void* out, void* stream) {
  if (b <= 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (b + kRowsPerBlock - 1) / kRowsPerBlock;
  lid_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d2), static_cast<float*>(out), b, k);
  return static_cast<int>(cudaGetLastError());
}
