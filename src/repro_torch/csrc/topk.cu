// k smallest entries per row for NVIDIA Hopper (sm_90a): (Q, N) float32 ->
// (Q, k) ascending values and int32 column ids, k <= 64.  The order is a
// strict total order on (value, id): ties go to the lower id, +inf entries
// are ranked by id like any other value, and the ids are distinct.  NaN is
// never selected.
//
// Replaces the TPU kernel repro/kernels/topk.py::topk (Pallas,
// `_topk_tile_kernel`: k masked-argmin passes over each 1024-wide tile held
// in VMEM, then a jnp merge of the tiles).  Semantics are those of
// repro_torch/kernels/ref.py::topk_ref (lax.top_k's order), not of that
// tile kernel, which can repeat an id in a tile with fewer than k finite
// entries.
//
// What bounds it on this card: bytes.  Every element of the (Q, N) matrix is
// read once (at the k-NN shape, 4096 x 65536 floats = 1 GiB, about 0.32 ms
// at 3.35 TB/s); the output is tiny.  The TPU design's k passes over each
// tile would read the matrix k times from HBM here.
//
// What the design does about it:
//   * one pass, one block of 256 threads per row segment, each thread
//     loading 8 elements of every 2048-element batch (8 loads in flight);
//   * the work per element is one compare against a bar, the k-th entry of
//     the segment's best k so far.  Elements ahead of it are appended to a
//     candidate buffer in shared memory (a shared atomic counter hands out
//     the slots).  When the buffer could overflow in the next batch it is
//     compacted: a bitonic sort by (value, id), the first k kept, the bar
//     lowered to the k-th.  The first batch fills the buffer and sets the
//     bar; on data in random order about k * N / 2048 elements of a segment
//     pass it after that, so the stream stays bound by memory;
//   * the final compaction sorts what is left (the next power of two above
//     its count) and writes the first k.  The sort makes the result
//     independent of the order in which the atomics handed out slots;
//   * a row too short to fill the card on its own is cut into segments, one
//     block each; a second launch of the same kernel merges the segments'
//     partial lists, reading their ids instead of column positions.
// A kernel fused with the distance computation, which never writes the
// (Q, N) matrix, is the next step for speed.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kBatch = kThreads * kUnroll;   // elements per batch
constexpr int kCap = 2 * kBatch;             // candidate buffer entries
constexpr int kSentinel = INT_MAX;           // id of an empty slot

__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// Sort the first `count` buffer entries by (value, id), padding up to the
// next power of two with (inf, kSentinel); keep the first k.  Returns the
// new count.  Every thread of the block calls it.
__device__ int compact(float* cv, int* ci, int count, int k) {
  int p2 = 1;
  while (p2 < count) p2 <<= 1;
  for (int t = count + threadIdx.x; t < p2; t += kThreads) {
    cv[t] = CUDART_INF_F;
    ci[t] = kSentinel;
  }
  __syncthreads();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p2 / 2; t += kThreads) {
        const int a = 2 * t - (t & (stride - 1));
        const int b = a + stride;
        const bool up = (a & size) == 0;
        if (before(cv[b], ci[b], cv[a], ci[a]) == up) {
          const float v = cv[a];
          const int i = ci[a];
          cv[a] = cv[b];
          ci[a] = ci[b];
          cv[b] = v;
          ci[b] = i;
        }
      }
      __syncthreads();
    }
  }
  return count < k ? count : k;
}

// One block per (row, segment).  ids == nullptr: an element's id is its
// column; else ids[row * ld + col] (the merge of segment partials).
__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ d, const int32_t* __restrict__ ids, int ld,
            int n, int seg, int k, float* __restrict__ out_v,
            int32_t* __restrict__ out_i) {
  __shared__ float cv[kCap];
  __shared__ int ci[kCap];
  __shared__ int count;

  const int row = blockIdx.y;
  const int s = blockIdx.x;
  const int start = s * seg;
  const int end = min(n, start + seg);
  const float* drow = d + (size_t)row * ld;
  const int32_t* irow = ids == nullptr ? nullptr : ids + (size_t)row * ld;

  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  float tv = CUDART_INF_F;   // the bar: an element must be ahead of it
  int ti = kSentinel;
  for (int b0 = start; b0 < end; b0 += kBatch) {
    float v[kUnroll];
    int id[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = b0 + threadIdx.x + u * kThreads;
      v[u] = j < end ? __ldcs(drow + j) : CUDART_NAN_F;
      id[u] = j < end ? (irow == nullptr ? j : __ldcs(irow + j)) : kSentinel;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (before(v[u], id[u], tv, ti)) {
        const int slot = atomicAdd(&count, 1);
        cv[slot] = v[u];
        ci[slot] = id[u];
      }
    }
    __syncthreads();
    int c = count;
    if (c >= kCap - kBatch) {  // the next batch could overflow the buffer
      c = compact(cv, ci, c, k);
      if (c == k) {
        tv = cv[k - 1];
        ti = ci[k - 1];
      }
    }
    __syncthreads();           // every thread has read `count`
    if (threadIdx.x == 0) count = c;
    __syncthreads();
  }
  const int c = compact(cv, ci, count, k);
  const size_t o = ((size_t)row * gridDim.x + s) * k;
  for (int r = threadIdx.x; r < k; r += kThreads) {
    out_v[o + r] = r < c ? cv[r] : CUDART_INF_F;
    out_i[o + r] = r < c ? ci[r] : kSentinel;
  }
}

cudaError_t select_rows(const float* d, const int32_t* ids, int q, int ld, int n, int seg,
                        int k, float* ov, int32_t* oi, cudaStream_t s) {
  const dim3 grid((n + seg - 1) / seg, q);
  topk_kernel<<<grid, kThreads, 0, s>>>(d, ids, ld, n, seg, k, ov, oi);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  d (q, n) float32 row-major;
// out_v/out_i (q, k).  seg < n cuts each row into ceil(n / seg) segments:
// the first launch writes (q, segments, k) partials to part_v/part_i and a
// second launch merges them; seg >= n needs no partials (they may be null).
// Rows go in groups of at most 65535 (the grid's y limit).  Launches on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int repro_topk(int q, int n, int k, int seg, const void* d, void* out_v,
                          void* out_i, void* part_v, void* part_i, void* stream) {
  if (q <= 0) return 0;
  if (k < 1 || k > 64 || k > n || seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int segs = seg >= n ? 1 : (n + seg - 1) / seg;
  const int m = segs * k;
  for (int r0 = 0; r0 < q; r0 += 65535) {
    const int rows = q - r0 < 65535 ? q - r0 : 65535;
    const auto* dd = static_cast<const float*>(d) + (size_t)r0 * n;
    auto* ov = static_cast<float*>(out_v) + (size_t)r0 * k;
    auto* oi = static_cast<int32_t*>(out_i) + (size_t)r0 * k;
    cudaError_t e;
    if (segs == 1) {
      e = select_rows(dd, nullptr, rows, n, n, n, k, ov, oi, s);
    } else {
      auto* pv = static_cast<float*>(part_v) + (size_t)r0 * m;
      auto* pi = static_cast<int32_t*>(part_i) + (size_t)r0 * m;
      e = select_rows(dd, nullptr, rows, n, n, seg, k, pv, pi, s);
      if (e == cudaSuccess) e = select_rows(pv, pi, rows, m, m, m, k, ov, oi, s);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
