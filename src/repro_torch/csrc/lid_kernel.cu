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
// What bounds it on this card: bytes and latency.  It reads B*k floats once
// and writes B (at 1M x 16, 68 MB: 0.0203 ms at 3.35 TB/s); the IEEE sqrtf,
// division and logf of each element (about 40 instructions, 16M elements at
// 1M x 16) take about as long at the card's instruction rate.  One warp a row, as
// this kernel first was, keeps one 64-byte load a warp in flight and ends in
// a chain of shuffles: latency, not bytes, set its time.
//
// What the design does about it: a grid of the blocks the card holds at
// once (the occupancy calculator's count), each thread taking whole rows,
// 32 consecutive rows a warp, so each warp's 32 results go out as one
// coalesced store.  A thread starts all the 16-byte loads of R rows (k <=
// 16: R = 2, 8 float4 in flight) before the first row's arithmetic; k > 16
// rows go 32 elements at a time.  sqrtf, logf and the divisions are the
// IEEE-accurate ones: the library is built without --use_fast_math, which
// the 1e-4 tolerance against the plain version needs.
//
// The summation order, kept from the one-warp-a-row kernel so that every
// estimate is bit for bit what it gave: the term of element i goes into
// partial i % 32, each partial summed from 0 in i order; then partials
// j and j + 16 are added, then j and j + 8, j + 4, j + 2, j + 1 (the
// butterfly of that kernel's __shfl_xor_sync reduction, as lane 0 saw it);
// the sum is divided by k.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// The log term of one element against r_k.
__device__ __forceinline__ float term(float d2, float rk) {
  return logf(sqrtf(fmaxf(d2, 1e-24f)) / rk);
}

// Elements [i0, i0 + C) of a row (those below k) into v; a whole float4 at a
// time where k % 4 == 0 and the rows are 16-byte aligned.
template <int C>
__device__ __forceinline__ void load(const float* p, int i0, int k, bool vec, bool ok,
                                     float (&v)[C]) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < C; j += 4) {
      float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
      if (ok && i0 + j < k) f = __ldg(reinterpret_cast<const float4*>(p + i0 + j));
      v[j] = f.x;
      v[j + 1] = f.y;
      v[j + 2] = f.z;
      v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = ok && i0 + j < k ? __ldg(p + i0 + j) : 1.f;
  }
}

// Add the terms of elements [i0, i0 + C) below k into partials s.
template <int C>
__device__ __forceinline__ void accumulate(const float (&v)[C], int i0, int k, float rk,
                                           float (&s)[C]) {
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (i0 + j < k) s[j] += term(v[j], rk);
}

// The butterfly over the partials: partials j and j + OFF, then OFF / 2,
// ... 1 (compile-time strides keep the partials in registers).
template <int C, int OFF>
__device__ __forceinline__ void fold(float (&s)[C]) {
  if constexpr (OFF > 0) {
#pragma unroll
    for (int j = 0; j < OFF; ++j) s[j] += s[j + OFF];
    fold<C, OFF / 2>(s);
  }
}

// The butterfly (partials j >= C are 0 and drop out exactly), then the
// estimate.
template <int C>
__device__ __forceinline__ float finish(float (&s)[C], int k) {
  fold<C, C / 2>(s);
  const float mean = s[0] / static_cast<float>(k);
  return -1.f / fminf(mean, -1.f / 4096.f);
}

// C: elements of a row a thread holds at once (16 for k <= 16, else 32);
// R: rows a thread loads before it computes.
template <int C, int R>
__global__ void __launch_bounds__(kThreads)
lid_kernel(const float* __restrict__ d2, float* __restrict__ out, int b, int k) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long warps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  const bool vec = (k & 3) == 0 && (reinterpret_cast<uintptr_t>(d2) & 15) == 0;
  for (long long r0 = warp * 32 * R; r0 < b; r0 += warps * 32 * R) {
    float v[R][C], rk[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = r0 + r * 32 + lane;
      const bool ok = row < b;
      const float* p = d2 + row * k;
      rk[r] = ok ? __ldg(p + k - 1) : 1.f;
      load<C>(p, 0, k, vec, ok, v[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = r0 + r * 32 + lane;
      const float* p = d2 + row * k;
      const float rkr = sqrtf(fmaxf(rk[r], 1e-24f));
      float s[C];
#pragma unroll
      for (int j = 0; j < C; ++j) s[j] = 0.f;
      accumulate<C>(v[r], 0, k, rkr, s);
      for (int i0 = C; i0 < k; i0 += C) {
        load<C>(p, i0, k, vec, row < b, v[r]);
        accumulate<C>(v[r], i0, k, rkr, s);
      }
      if (row < b) out[row] = finish<C>(s, k);
    }
  }
}

// Blocks of lid_kernel<C, R> the card holds at once (cached per device and
// variant), or minus a CUDA error code.
template <int C, int R>
int card_blocks() {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int blocks = dev < kMaxDevices ? cache[dev].load() : 0;
  if (blocks > 0) return blocks;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lid_kernel<C, R>, kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  blocks = (per_sm < 1 ? 1 : per_sm) * sms;
  if (dev < kMaxDevices) cache[dev].store(blocks);
  return blocks;
}

template <int C, int R>
int launch(int b, int k, const float* d2, float* out, cudaStream_t s) {
  const int card = card_blocks<C, R>();
  if (card < 0) return -card;
  const long long need = (static_cast<long long>(b) + kThreads * R - 1) / (kThreads * R);
  const int blocks = need < card ? static_cast<int>(need) : card;
  lid_kernel<C, R><<<blocks, kThreads, 0, s>>>(d2, out, b, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes.  d2 (b, k) float32 row-major, out
// (b,) float32.  Launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so the caller can raise on a
// refused launch.
extern "C" int repro_lid_estimate(int b, int k, const void* d2, void* out, void* stream) {
  if (b <= 0) return 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const float*>(d2);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return k <= 16 ? launch<16, 2>(b, k, d, o, s) : launch<32, 1>(b, k, d, o, s);
}
