// k smallest entries per row for NVIDIA Hopper (sm_90a): (Q, N) float32 ->
// (Q, k) ascending values and int32 column ids, any 1 <= k <= N.  The order
// is a strict total order on (value, id): ties go to the lower id, +inf
// entries are ranked by id like any other value, and the ids are distinct.
// NaN is never selected.
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
// What the design does about it, for k <= 256: a warp-select with no block
// barrier.
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
//   * the warp's best list holds W = 32 * P keys, P a lane in registers:
//     P = 2 (W = 64) for k <= 64, P = 4 for k <= 128, P = 8 for k <= 256.
//     When the buffer holds more than W entries it is absorbed: W at a
//     time, sorted by a bitonic network in registers (`__shfl_xor_sync`
//     below a stride of 32, register pairs of one lane above) on the key
//     (value, id), then merged with the sorted best W (a bitonic merge of
//     the two); the bar becomes the new k-th.  The bar starts at (+inf, max
//     id), so the first elements a warp sees set it after one absorb; on
//     data in random order about k * ln(N / k) elements of a row pass it;
//   * the grid is one warp per (row, segment): the wrapper cuts rows into
//     segments only when the rows alone leave the card's resident warps
//     (the occupancy calculator's count for the list size,
//     repro_topk_warp_slots) idle, so the k-NN's 4096 rows run as one wave
//     of whole-row warps.  A second launch of the same select merges a
//     row's segment lists, reading their ids instead of column positions,
//     in segment order.
// For k > 256: a radix select, one block of 512 threads a row, in one
// launch.  Four passes over the row build 256-bin histograms of the
// order-preserving uint32 image of the values (-0.0 and +0.0 share one, NaN
// none), each restricted to the bits found so far, and fix the k-th key a
// byte at a time; a fifth pass takes, in column order (block-wide ballot
// scans), every entry below that key and the lowest ids equal to it.  The
// row is read five times, mostly from L2; the wrapper orders the k taken
// entries with a stable sort on the value, as the reference merges its
// tiles' partials outside its kernel.  That path is right first; it is not
// tuned.
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
constexpr int kMaxList = 256;            // k of the largest warp-select list
constexpr int kSentinel = INT_MAX;       // id of an empty slot
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRadixThreads = 512;
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int kRadixBins = 256;

// Blocks an SM must hold of the select with P slots a lane (registers).
constexpr int min_blocks(int p) { return p == 2 ? 4 : (p == 4 ? 3 : 2); }

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

// Compare-exchange of registers a and b of one lane: a takes the earlier
// key if asc, the later one otherwise.
template <int P>
__device__ __forceinline__ void exchange_regs(float (&v)[P], int (&i)[P], int a, int b, bool asc) {
  if (asc ? before(v[b], i[b], v[a], i[a]) : before(v[a], i[a], v[b], i[b])) {
    const float tv = v[a];
    const int ti = i[a];
    v[a] = v[b];
    i[a] = i[b];
    v[b] = tv;
    i[b] = ti;
  }
}

// The strides HS * 32, HS * 16, ..., 32 of a bitonic stage: registers h
// and h + HS' of one lane, ascending where (h * 32) & SIZE == 0 (SIZE 0:
// everywhere).  Compile-time strides keep every register index constant,
// so the lists stay in registers.
template <int P, int HS, int SIZE>
__device__ __forceinline__ void register_strides(float (&v)[P], int (&i)[P]) {
  if constexpr (HS > 0) {
#pragma unroll
    for (int h = 0; h < P; ++h)
      if ((h & HS) == 0) exchange_regs(v, i, h, h | HS, SIZE == 0 || ((h * 32) & SIZE) == 0);
    register_strides<P, HS / 2, SIZE>(v, i);
  }
}

// Sort a bitonic sequence of 32 * P entries (slot h * 32 + lane) ascending.
template <int P>
__device__ __forceinline__ void merge_list(float (&v)[P], int (&i)[P], int lane) {
  register_strides<P, P / 2, 0>(v, i);
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const bool lower = (lane & stride) == 0;
#pragma unroll
    for (int h = 0; h < P; ++h) exchange(v[h], i[h], stride, lower);
  }
}

// Bitonic stages for runs of SIZE = 64 .. 16 * P (each half of the list
// sorted, the halves opposite ways, for merge_list).
template <int P, int SIZE>
__device__ __forceinline__ void sort_runs(float (&v)[P], int (&i)[P], int lane) {
  if constexpr (SIZE < 32 * P) {
    register_strides<P, SIZE / 64, SIZE>(v, i);
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      const bool lower = (lane & stride) == 0;
#pragma unroll
      for (int h = 0; h < P; ++h) exchange(v[h], i[h], stride, lower == (((h * 32) & SIZE) == 0));
    }
    sort_runs<P, SIZE * 2>(v, i, lane);
  }
}

// Bitonic sort of 32 * P entries (slot h * 32 + lane) ascending.
template <int P>
__device__ __forceinline__ void sort_list(float (&v)[P], int (&i)[P], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const bool lower = (lane & stride) == 0;
#pragma unroll
      for (int h = 0; h < P; ++h) {
        const bool asc = ((h * 32 + lane) & size) == 0;
        exchange(v[h], i[h], stride, lower == asc);
      }
    }
  }
  // Runs of 64 and more: slots h * 32 + lane share a direction per h.
  sort_runs<P, 64>(v, i, lane);
  merge_list<P>(v, i, lane);  // the last run: both halves sorted opposite ways
}

// One warp's selection state: its best 32 * P keys, sorted ascending over
// slot h * 32 + lane (empty slots hold (+inf, kSentinel)), the bar (slot
// k - 1), and its candidate buffer in shared memory.
template <int P>
struct Select {
  static constexpr int kSlots = 32 * P;
  static constexpr int kCap = kBatch + kSlots;   // a warp's candidate buffer

  float bv[P];
  int bi[P];
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
      float v[P];
      int i[P];
#pragma unroll
      for (int h = 0; h < P; ++h) {
        const int j = c0 + h * 32 + lane;
        v[h] = j < count ? cv[j] : CUDART_INF_F;
        i[h] = j < count ? ci[j] : kSentinel;
      }
      sort_list<P>(v, i, lane);
      // min(best[j], cand[W - 1 - j]) holds the W smallest, as a bitonic run.
      float rv[P];
      int ri[P];
#pragma unroll
      for (int h = 0; h < P; ++h) {
        rv[h] = __shfl_sync(kFull, v[P - 1 - h], 31 - lane);
        ri[h] = __shfl_sync(kFull, i[P - 1 - h], 31 - lane);
      }
#pragma unroll
      for (int h = 0; h < P; ++h) {
        if (before(rv[h], ri[h], bv[h], bi[h])) {
          bv[h] = rv[h];
          bi[h] = ri[h];
        }
      }
      merge_list<P>(bv, bi, lane);
    }
    count = 0;
    const int last = k - 1;
    // Shuffle every register, then pick: a select between loads of bv
    // would become a dynamic index and put the whole state in local memory.
    tv = __shfl_sync(kFull, bv[0], last & 31);
    ti = __shfl_sync(kFull, bi[0], last & 31);
#pragma unroll
    for (int h = 1; h < P; ++h) {
      const float x = __shfl_sync(kFull, bv[h], last & 31);
      const int y = __shfl_sync(kFull, bi[h], last & 31);
      if ((last >> 5) == h) {
        tv = x;
        ti = y;
      }
    }
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
template <bool kMerge, int P>
__global__ void __launch_bounds__(kThreads, min_blocks(P))
topk_kernel(const float* __restrict__ d, const int32_t* __restrict__ ids, int ld, int n,
            int seg, int segs, int k, long long items, float* __restrict__ out_v,
            int32_t* __restrict__ out_i) {
  using Sel = Select<P>;
  __shared__ float cand_v[kWarps][Sel::kCap];
  __shared__ int cand_i[kWarps][Sel::kCap];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kWarps + warp;
  if (item >= items) return;
  const long long row = item / segs;
  const int start = static_cast<int>(item % segs) * seg;
  const int end = min(n, start + seg);
  const float* drow = d + row * ld;

  Sel sel;
#pragma unroll
  for (int h = 0; h < P; ++h) {
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
      sel.template offer<4>(v, id);
    }
  } else {
    // Head: up to the first 16-byte boundary.
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(drow + start) >> 2) & 3);
    const int head = min(end - start, (4 - mis) & 3);
    if (head > 0) {
      const float v[1] = {lane < head ? __ldcs(drow + start + lane) : CUDART_NAN_F};
      const int id[1] = {start + lane};
      sel.template offer<1>(v, id);
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
      sel.template offer<4 * kVec>(v, id);
#pragma unroll
      for (int u = 0; u < kVec; ++u) cur[u] = nxt[u];
    }
    // Tail: what is left after the last whole float4.
    const int t0 = a + 4 * nf;
    if (t0 < end) {
      const float v[1] = {t0 + lane < end ? __ldcs(drow + t0 + lane) : CUDART_NAN_F};
      const int id[1] = {t0 + lane};
      sel.template offer<1>(v, id);
    }
  }
  if (sel.count > 0) sel.absorb();

  const size_t o = static_cast<size_t>(item) * k;
#pragma unroll
  for (int h = 0; h < P; ++h) {
    const int slot = h * 32 + lane;
    if (slot < k) {
      out_v[o + slot] = sel.bv[h];
      out_i[o + slot] = sel.bi[h];
    }
  }
}

template <bool kMerge, int P>
cudaError_t select_rows(const float* d, const int32_t* ids, int ld, int n, int seg, int segs,
                        int k, long long items, float* ov, int32_t* oi, cudaStream_t s) {
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  topk_kernel<kMerge, P><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      d, ids, ld, n, seg, segs, k, items, ov, oi);
  return cudaGetLastError();
}

// The warp-select with P slots a lane: one launch, or a launch per segment
// list and a merge (see repro_topk).
template <int P>
cudaError_t warp_select(int q, int n, int k, int seg, const float* d, float* ov, int32_t* oi,
                        float* pv, int32_t* pi, cudaStream_t s) {
  const int segs = seg >= n ? 1 : (n + seg - 1) / seg;
  if (segs == 1) return select_rows<false, P>(d, nullptr, n, n, n, 1, k, q, ov, oi, s);
  if (static_cast<long long>(segs) * k > INT_MAX) return cudaErrorInvalidValue;
  const int m = segs * k;
  cudaError_t e = select_rows<false, P>(d, nullptr, n, n, seg, segs, k,
                                        static_cast<long long>(q) * segs, pv, pi, s);
  if (e == cudaSuccess) e = select_rows<true, P>(pv, pi, m, m, m, 1, k, q, ov, oi, s);
  return e;
}

// The order-preserving uint32 image of a float: a < b iff key(a) < key(b),
// and -0.0 shares +0.0's key (they compare equal).
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  if ((b << 1) == 0) b = 0;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// One block per row: the k smallest of the row, in column order, into
// out_v / out_i row-major (q, k).  A row with fewer than k numbers takes
// them all and pads with (+inf, kSentinel).
__global__ void __launch_bounds__(kRadixThreads)
radix_select_kernel(const float* __restrict__ d, int n, int k, float* __restrict__ out_v,
                    int32_t* __restrict__ out_i) {
  __shared__ unsigned hist[kRadixWarps][kRadixBins];
  __shared__ unsigned counts[2][kRadixWarps];
  __shared__ uint32_t found_key;
  __shared__ unsigned found_rank;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* row = d + static_cast<size_t>(blockIdx.x) * n;
  const size_t o = static_cast<size_t>(blockIdx.x) * k;

  // The k-th key, a byte a pass from the top; `rank` is its rank among the
  // keys that share the bytes found so far.
  uint32_t key_t = 0;
  unsigned rank = static_cast<unsigned>(k);
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t fixed = pass == 0 ? 0u : ~0u << (shift + 8);
    for (int e = threadIdx.x; e < kRadixWarps * kRadixBins; e += kRadixThreads)
      (&hist[0][0])[e] = 0;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kRadixThreads) {
      const float v = row[j];
      const uint32_t key = order_key(v);
      if (v == v && (key & fixed) == key_t) atomicAdd(&hist[warp][(key >> shift) & 0xffu], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      unsigned c[8], sum = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        c[b] = 0;
        for (int w = 0; w < kRadixWarps; ++w) c[b] += hist[w][lane * 8 + b];
        sum += c[b];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      const unsigned excl = incl - sum;
      const unsigned hit = __ballot_sync(kFull, excl < rank && rank <= incl);
      if (hit == 0) {
        // Fewer than k numbers in the row (first pass only): take them all.
        if (lane == 0) {
          found_key = 0xffffffffu;
          found_rank = 0;
        }
      } else if (lane == __ffs(hit) - 1) {
        unsigned r = rank - excl;
        int bin = lane * 8;
#pragma unroll
        for (int b = 0; b < 7; ++b) {
          if (bin == lane * 8 + b && r > c[b]) {
            r -= c[b];
            ++bin;
          }
        }
        found_key = key_t | (static_cast<uint32_t>(bin) << shift);
        found_rank = r;
      }
    }
    __syncthreads();
    key_t = found_key;
    rank = found_rank;
    if (rank == 0) break;
  }

  // Take, in column order, every key below key_t and the first `rank` keys
  // equal to it.  taken and eq_seen are the same in every thread.
  const unsigned below = (1u << lane) - 1u;
  unsigned taken = 0, eq_seen = 0;
  for (int base = 0; base < n && taken < static_cast<unsigned>(k); base += kRadixThreads) {
    const int j = base + threadIdx.x;
    const float v = j < n ? row[j] : CUDART_NAN_F;
    const uint32_t key = order_key(v);
    const bool num = v == v;
    const bool less = num && key < key_t;
    const bool eq = num && key == key_t;
    const unsigned eb = __ballot_sync(kFull, eq);
    if (lane == 0) counts[0][warp] = __popc(eb);
    __syncthreads();
    unsigned eq_before = eq_seen, eq_all = 0;
    for (int w = 0; w < kRadixWarps; ++w) {
      const unsigned c = counts[0][w];
      eq_before += w < warp ? c : 0u;
      eq_all += c;
    }
    const bool take = less || (eq && eq_before + __popc(eb & below) < rank);
    const unsigned tb = __ballot_sync(kFull, take);
    if (lane == 0) counts[1][warp] = __popc(tb);
    __syncthreads();
    unsigned pos = taken, taken_all = 0;
    for (int w = 0; w < kRadixWarps; ++w) {
      const unsigned c = counts[1][w];
      pos += w < warp ? c : 0u;
      taken_all += c;
    }
    if (take) {
      pos += __popc(tb & below);
      out_v[o + pos] = v;
      out_i[o + pos] = j;
    }
    taken += taken_all;
    eq_seen += eq_all;
  }
  for (unsigned p = taken + threadIdx.x; p < static_cast<unsigned>(k); p += kRadixThreads) {
    out_v[o + p] = CUDART_INF_F;
    out_i[o + p] = kSentinel;
  }
}

// Slots a lane of the warp-select that takes k (0 past the warp-select).
int lists_for(int k) { return k <= 64 ? 2 : k <= 128 ? 4 : k <= kMaxList ? 8 : 0; }

template <int P>
cudaError_t occupancy(int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, topk_kernel<false, P>, kThreads, 0);
}

}  // namespace

// Warps of the streaming select for k that the current card holds at once,
// from the occupancy calculator (cached per device and list size), or minus
// a CUDA error code; 0 for k past the warp-select (no segments there).
extern "C" int repro_topk_warp_slots(int k) {
  static std::atomic<int> cache[kMaxDevices][3];
  const int p = lists_for(k);
  if (p == 0) return 0;
  const int slot = p == 2 ? 0 : (p == 4 ? 1 : 2);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int slots = dev < kMaxDevices ? cache[dev][slot].load() : 0;
  if (slots > 0) return slots;
  int per_sm = 0, sms = 0;
  e = p == 2 ? occupancy<2>(&per_sm) : (p == 4 ? occupancy<4>(&per_sm) : occupancy<8>(&per_sm));
  if (e != cudaSuccess) return -static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  slots = (per_sm < 1 ? 1 : per_sm) * sms * kWarps;
  if (dev < kMaxDevices) cache[dev][slot].store(slots);
  return slots;
}

// Plain C entry point, loaded with ctypes.  d (q, n) float32 row-major;
// out_v/out_i (q, k).  For k <= 256 the values come out ascending with
// their ids; seg < n cuts each row into ceil(n / seg) segments: the first
// launch writes (q, segments, k) lists to part_v/part_i and a second launch
// merges them; seg >= n needs no lists (they may be null).  For k > 256
// (seg and the lists unused) one launch writes the k taken entries in
// column order, for the caller to sort by value.  Launches on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// so the caller can raise on a refused launch.
extern "C" int repro_topk(int q, int n, int k, int seg, const void* d, void* out_v,
                          void* out_i, void* part_v, void* part_i, void* stream) {
  if (q <= 0) return 0;
  if (k < 1 || k > n || seg < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* dd = static_cast<const float*>(d);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int32_t*>(out_i);
  auto* pv = static_cast<float*>(part_v);
  auto* pi = static_cast<int32_t*>(part_i);
  switch (lists_for(k)) {
    case 2:
      return static_cast<int>(warp_select<2>(q, n, k, seg, dd, ov, oi, pv, pi, s));
    case 4:
      return static_cast<int>(warp_select<4>(q, n, k, seg, dd, ov, oi, pv, pi, s));
    case 8:
      return static_cast<int>(warp_select<8>(q, n, k, seg, dd, ov, oi, pv, pi, s));
    default:
      radix_select_kernel<<<q, kRadixThreads, 0, s>>>(dd, n, k, ov, oi);
      return static_cast<int>(cudaGetLastError());
  }
}
