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
// What the design does about it: a warp-select with no block barrier.
//   * one warp owns a row, or a segment of one; the warps of a block share
//     nothing but the block.  Each lane streams 16-byte loads (`__ldcs`,
//     two float4 a lane, 256 elements a warp per batch) and keeps the next
//     batch's loads in flight while it tests the current one.  A row whose
//     segment does not start 16-byte aligned (N % 4 != 0) takes its head
//     and tail of at most 3 elements each as scalar loads;
//   * the work per element is one compare against a bar, the k-th of the
//     warp's best so far.  The lanes whose elements pass append them to a
//     warp-private buffer in shared memory, slots handed out by
//     `__ballot_sync` / `__popc` (no atomics, no `__syncthreads`);
//   * when the buffer holds more than 64 entries it is absorbed: 64 at a
//     time, sorted by a bitonic network in registers (2 entries a lane,
//     `__shfl_xor_sync`) on the key (value, id), then merged with the
//     warp's sorted best 64 (a bitonic merge of the two); the bar becomes
//     the new k-th.  The bar starts at (+inf, max id), so the first
//     elements a warp sees set it after one absorb, without a long sort; on
//     data in random order about k * ln(N / k) elements of a row pass it;
//   * the grid is one warp per (row, segment): the wrapper cuts rows into
//     segments only when the rows alone leave the card's resident warps
//     (the occupancy calculator's count, repro_topk_warp_slots) idle, so
//     the k-NN's 4096 rows run as one wave of whole-row warps.  A second
//     launch of the same select merges a row's segment lists, reading
//     their ids instead of column positions, in segment order.
// A kernel fused with the distance computation, which never writes the
// (Q, N) matrix, is the next step for speed.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 2;                  // float4 loads a lane per batch
constexpr int kBatch = 32 * 4 * kVec;    // elements a warp per batch
constexpr int kSlots = 64;               // the best list, 2 slots a lane
constexpr int kCap = kBatch + kSlots;    // a warp's candidate buffer
constexpr int kSentinel = INT_MAX;       // id of an empty slot
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// Compare-exchange with lane ^ stride: keep the earlier key if keep_min.
__device__ __forceinline__ void exchange(float& v, int& i, int stride, bool keep_min) {
  const float pv = __shfl_xor_sync(kFull, v, stride);
  const int pi = __shfl_xor_sync(kFull, i, stride);
  if (keep_min ? before(pv, pi, v, i) : before(v, i, pv, pi)) {
    v = pv;
    i = pi;
  }
}

// Sort a bitonic 64-entry sequence (slot h * 32 + lane) ascending.
__device__ __forceinline__ void merge64(float (&v)[2], int (&i)[2], int lane) {
  if (before(v[1], i[1], v[0], i[0])) {
    const float tv = v[0];
    const int ti = i[0];
    v[0] = v[1];
    i[0] = i[1];
    v[1] = tv;
    i[1] = ti;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const bool lower = (lane & stride) == 0;
    exchange(v[0], i[0], stride, lower);
    exchange(v[1], i[1], stride, lower);
  }
}

// Bitonic sort of 64 entries (slot h * 32 + lane) ascending.
__device__ __forceinline__ void sort64(float (&v)[2], int (&i)[2], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool lower = (lane & stride) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool asc = ((h * 32 + lane) & size) == 0;
        exchange(v[h], i[h], stride, lower == asc);
      }
    }
  }
  merge64(v, i, lane);  // slots 0-31 ascending, 32-63 descending: bitonic
}

// One warp's selection state: its best 64 keys, sorted ascending over slot
// h * 32 + lane (empty slots hold (+inf, kSentinel)), the bar (slot k - 1),
// and its candidate buffer in shared memory.
struct Select {
  float bv[2];
  int bi[2];
  float tv;
  int ti;
  int count;
  float* cv;
  int* ci;
  int lane;
  int k;

  __device__ __forceinline__ void absorb() {
    __syncwarp();
    for (int c0 = 0; c0 < count; c0 += kSlots) {
      float v[2];
      int i[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = c0 + h * 32 + lane;
        v[h] = j < count ? cv[j] : CUDART_INF_F;
        i[h] = j < count ? ci[j] : kSentinel;
      }
      sort64(v, i, lane);
      // min(best[j], cand[63 - j]) holds the 64 smallest, as a bitonic run.
      float rv[2];
      int ri[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rv[h] = __shfl_sync(kFull, v[1 - h], 31 - lane);
        ri[h] = __shfl_sync(kFull, i[1 - h], 31 - lane);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (before(rv[h], ri[h], bv[h], bi[h])) {
          bv[h] = rv[h];
          bi[h] = ri[h];
        }
      }
      merge64(bv, bi, lane);
    }
    count = 0;
    const int last = k - 1;
    tv = __shfl_sync(kFull, (last >> 5) ? bv[1] : bv[0], last & 31);
    ti = __shfl_sync(kFull, (last >> 5) ? bi[1] : bi[0], last & 31);
    __syncwarp();  // every lane has read the buffer before it is refilled
  }

  // Offer E elements of each lane; every lane of the warp calls it.
  template <int E>
  __device__ __forceinline__ void offer(const float (&v)[E], const int (&id)[E]) {
    bool pass[E];
    bool any = false;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      pass[e] = before(v[e], id[e], tv, ti);
      any |= pass[e];
    }
    if (!__any_sync(kFull, any)) return;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned m = __ballot_sync(kFull, pass[e]);
      if (pass[e]) {
        const int slot = count + __popc(m & below);
        cv[slot] = v[e];
        ci[slot] = id[e];
      }
      count += __popc(m);
    }
    if (count > kCap - kBatch) absorb();  // the next offer could overflow
  }
};

// One warp per item = (row, segment): row = item / segs, columns
// [s * seg, min(n, (s + 1) * seg)).  kMerge: an element's id is
// ids[row * ld + col] (the merge of segment lists); else its column.
template <bool kMerge>
__global__ void __launch_bounds__(kThreads, 4)
topk_kernel(const float* __restrict__ d, const int32_t* __restrict__ ids, int ld, int n,
            int seg, int segs, int k, long long items, float* __restrict__ out_v,
            int32_t* __restrict__ out_i) {
  __shared__ float cand_v[kWarps][kCap];
  __shared__ int cand_i[kWarps][kCap];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= items) return;
  const long long row = item / segs;
  const int start = static_cast<int>(item % segs) * seg;
  const int end = min(n, start + seg);
  const float* drow = d + row * ld;

  Select sel;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sel.bv[h] = CUDART_INF_F;
    sel.bi[h] = kSentinel;
  }
  sel.tv = CUDART_INF_F;
  sel.ti = kSentinel;
  sel.count = 0;
  sel.cv = cand_v[warp];
  sel.ci = cand_i[warp];
  sel.lane = lane;
  sel.k = k;

  if constexpr (kMerge) {
    const int32_t* irow = ids + row * ld;
    for (int b = start; b < end; b += 128) {
      float v[4];
      int id[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = b + u * 32 + lane;
        v[u] = j < end ? drow[j] : CUDART_NAN_F;
        id[u] = j < end ? irow[j] : kSentinel;
      }
      sel.offer<4>(v, id);
    }
  } else {
    // Head: up to the first 16-byte boundary.
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(drow + start) >> 2) & 3);
    const int head = min(end - start, (4 - mis) & 3);
    if (head > 0) {
      const float v[1] = {lane < head ? __ldcs(drow + start + lane) : CUDART_NAN_F};
      const int id[1] = {start + lane};
      sel.offer<1>(v, id);
    }
    // Body: float4s in batches of 32 * kVec, the next batch in flight.
    const int a = start + head;
    const int nf = (end - a) >> 2;
    const float4* p = reinterpret_cast<const float4*>(drow + a);
    const float4 none = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
    float4 cur[kVec], nxt[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int f = u * 32 + lane;
      cur[u] = f < nf ? __ldcs(p + f) : none;
    }
    for (int b = 0; b < nf; b += 32 * kVec) {
      const int bn = b + 32 * kVec;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int f = bn + u * 32 + lane;
        nxt[u] = f < nf ? __ldcs(p + f) : none;
      }
      float v[4 * kVec];
      int id[4 * kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int c = a + 4 * (b + u * 32 + lane);
        v[4 * u] = cur[u].x;
        v[4 * u + 1] = cur[u].y;
        v[4 * u + 2] = cur[u].z;
        v[4 * u + 3] = cur[u].w;
#pragma unroll
        for (int e = 0; e < 4; ++e) id[4 * u + e] = c + e;
      }
      sel.offer<4 * kVec>(v, id);
#pragma unroll
      for (int u = 0; u < kVec; ++u) cur[u] = nxt[u];
    }
    // Tail: what is left after the last whole float4.
    const int t0 = a + 4 * nf;
    if (t0 < end) {
      const float v[1] = {t0 + lane < end ? __ldcs(drow + t0 + lane) : CUDART_NAN_F};
      const int id[1] = {t0 + lane};
      sel.offer<1>(v, id);
    }
  }
  if (sel.count > 0) sel.absorb();

  const size_t o = static_cast<size_t>(item) * k;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int slot = h * 32 + lane;
    if (slot < k) {
      out_v[o + slot] = sel.bv[h];
      out_i[o + slot] = sel.bi[h];
    }
  }
}

template <bool kMerge>
cudaError_t select_rows(const float* d, const int32_t* ids, int ld, int n, int seg, int segs,
                        int k, long long items, float* ov, int32_t* oi, cudaStream_t s) {
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  topk_kernel<kMerge><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      d, ids, ld, n, seg, segs, k, items, ov, oi);
  return cudaGetLastError();
}

}  // namespace

// Warps of the streaming select that the current card holds at once, from
// the occupancy calculator (cached per device), or minus a CUDA error code.
extern "C" int repro_topk_warp_slots() {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int slots = dev < kMaxDevices ? cache[dev].load() : 0;
  if (slots > 0) return slots;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_kernel<false>, kThreads, 0);
  if (e != cudaSuccess) return -static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  slots = (per_sm < 1 ? 1 : per_sm) * sms * kWarps;
  if (dev < kMaxDevices) cache[dev].store(slots);
  return slots;
}

// Plain C entry point, loaded with ctypes.  d (q, n) float32 row-major;
// out_v/out_i (q, k).  seg < n cuts each row into ceil(n / seg) segments:
// the first launch writes (q, segments, k) lists to part_v/part_i and a
// second launch merges them; seg >= n needs no lists (they may be null).
// Launches on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int repro_topk(int q, int n, int k, int seg, const void* d, void* out_v,
                          void* out_i, void* part_v, void* part_i, void* stream) {
  if (q <= 0) return 0;
  if (k < 1 || k > 64 || k > n || seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dd = static_cast<const float*>(d);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int32_t*>(out_i);
  const int segs = seg >= n ? 1 : (n + seg - 1) / seg;
  if (segs == 1)
    return static_cast<int>(select_rows<false>(dd, nullptr, n, n, n, 1, k, q, ov, oi, s));
  if (static_cast<long long>(segs) * k > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int m = segs * k;
  auto* pv = static_cast<float*>(part_v);
  auto* pi = static_cast<int32_t*>(part_i);
  cudaError_t e = select_rows<false>(dd, nullptr, n, n, seg, segs, k,
                                     static_cast<long long>(q) * segs, pv, pi, s);
  if (e == cudaSuccess) e = select_rows<true>(pv, pi, m, m, m, 1, k, q, ov, oi, s);
  return static_cast<int>(e);
}
