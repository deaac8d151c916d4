// Fused beam-walk hop for NVIDIA Hopper (sm_90a): one launch advances every
// query lane of a batched graph walk by one hop.
//
// Replaces the TPU kernel repro/kernels/beam_step.py::beam_step (Pallas,
// `_beam_step_kernel` + `_select_merge`).  Semantics are those of the plain
// oracle repro_torch/kernels/ref.py::beam_step_ref (a literal port of
// repro/kernels/ref.py::beam_step_ref): frontier argmin over the unexpanded,
// valid, in-budget beam slots (ties to the lowest slot), adjacency-row read,
// visited-bit test, neighbour distances (squared L2 for kind "exact", an ADC
// sum over the lane's LUT for kind "pq"), visited-bit set, keep-best-L merge
// equal to a stable argsort, and lane freezing.
//
// What bounds it on this card: bytes, and the latency of dependent reads.
// One lane-hop moves about R*D*4 + R*4 + 3*L*4*2 bytes for "exact" (R rows of
// D floats gathered, the adjacency row, the beam read and written) and
// R*M + R*M*4 for "pq" (R codes plus R*M LUT entries); it does about 3*R*D
// flops, far under the card's float32 rate, and its reads are chains: the
// frontier decides the adjacency row, which decides the rows to gather.
//
// What the design does about it:
//   * one thread block per lane (grid = Q), so Q lanes keep many independent
//     gather chains in flight across the 132 SMs;
//   * the state is updated in place: a frozen lane returns before writing
//     anything, and an active lane writes only its beam, counters and the
//     visited words it sets.  The TPU kernel emits a fresh copy of the
//     visited bitset every hop (ceil(N/32)*4 bytes per lane, 125 KB at
//     N = 1M); here that copy does not exist;
//   * exact rows are read with one warp per neighbour row and 16-byte loads,
//     summed with warp shuffles; PQ lookups read the lane's LUT from global
//     memory (16 KB at M=16, K=256, so it stays in L1/L2);
//   * the merge ranks the L+R candidates in shared memory:
//       rank_i = #{j : d_j < d_i} + #{j < i : d_j == d_i},
//     the position a stable argsort gives entry i, and writes entry i to slot
//     rank_i when rank_i < L.  O((L+R)^2) compares on shared memory, no
//     invariant on inf entries needed;
//   * the block that finished a hop adds one to `active_after` when its lane
//     can still move, so the host polls one counter every few hops instead of
//     synchronising on every hop.
// Persistent blocks, a walk to convergence in one launch, or CUDA graphs are
// the next steps for speed.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInvalid = -1;
constexpr unsigned kFull = 0xffffffffu;

struct ArgMin {
  float v;
  int i;
};

// Smaller value wins; ties go to the lower slot, as argmin takes the first
// minimum.  inf == inf, so an all-inf beam selects slot 0 like the oracle.
__device__ __forceinline__ ArgMin better(ArgMin a, ArgMin b) {
  return (b.v < a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ ArgMin warp_argmin(ArgMin x) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMin o;
    o.v = __shfl_down_sync(kFull, x.v, off);
    o.i = __shfl_down_sync(kFull, x.i, off);
    x = better(x, o);
  }
  return x;
}

__device__ ArgMin block_argmin(ArgMin x, ArgMin* scratch) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  x = warp_argmin(x);
  if (wl == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = wl < kWarps ? scratch[wl] : ArgMin{CUDART_INF_F, INT_MAX};
    x = warp_argmin(x);
    if (wl == 0) scratch[0] = x;
  }
  __syncthreads();
  return scratch[0];
}

// KIND 0: exact (table = (N, width) float32, ctxs = (Q, width) float32).
// KIND 1: pq    (table = (N, width) uint8 codes, ctxs = (Q, width, K) LUTs).
template <int KIND>
__global__ void __launch_bounds__(kThreads) beam_step_kernel(
    int L, int R, int nw, int width, int K, int vec4,
    int32_t* __restrict__ beam_ids, float* __restrict__ beam_d,
    bool* __restrict__ beam_exp, uint32_t* __restrict__ visited,
    int32_t* __restrict__ hops, int32_t* __restrict__ evals,
    const float* __restrict__ ctxs, const int32_t* __restrict__ adj,
    const void* __restrict__ table, const int32_t* __restrict__ budgets,
    const int32_t* __restrict__ hop_limits, int32_t* __restrict__ active_after) {
  extern __shared__ unsigned char smem[];
  const int T = L + R;
  float* cat_d = reinterpret_cast<float*>(smem);
  int32_t* cat_ids = reinterpret_cast<int32_t*>(cat_d + T);
  unsigned char* cat_exp = reinterpret_cast<unsigned char*>(cat_ids + T);
  __shared__ ArgMin red[kWarps];
  __shared__ int s_nvalid;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  int32_t* ids = beam_ids + static_cast<size_t>(lane) * L;
  float* bd = beam_d + static_cast<size_t>(lane) * L;
  bool* bexp = beam_exp + static_cast<size_t>(lane) * L;
  uint32_t* vis = visited + static_cast<size_t>(lane) * nw;
  const int budget = budgets[lane];
  const int hop_limit = hop_limits[lane];
  const int h = hops[lane];

  // 1. Frontier: stage the beam in shared memory, argmin over open slots.
  ArgMin best{CUDART_INF_F, INT_MAX};
  int open = 0;
  for (int i = tid; i < L; i += kThreads) {
    const int id = ids[i];
    const float d = bd[i];
    const bool e = bexp[i];
    cat_ids[i] = id;
    cat_d[i] = d;
    cat_exp[i] = e;
    const bool closed = e || id == kInvalid || i >= budget;
    open |= !closed;
    best = better(best, ArgMin{closed ? CUDART_INF_F : d, i});
  }
  if (tid == 0) s_nvalid = 0;
  const int frontier_open = __syncthreads_or(open);
  // Frozen lane (hop limit reached or frontier closed): write nothing.
  if (!(h < hop_limit && frontier_open)) return;
  best = block_argmin(best, red);
  const int u = cat_ids[best.i];

  // 2. Adjacency row and visited test (every read before any bit is set).
  const int32_t* row = adj + static_cast<size_t>(u < 0 ? 0 : u) * R;
  for (int r = tid; r < R; r += kThreads) {
    const int v = row[r];
    const int safe = v < 0 ? 0 : v;
    const uint32_t bit = 1u << (safe & 31);
    const bool seen = (vis[safe >> 5] & bit) != 0u;
    const bool valid = v != kInvalid && u != kInvalid && !seen;
    cat_ids[L + r] = valid ? v : kInvalid;
    cat_d[L + r] = CUDART_INF_F;
    cat_exp[L + r] = 0;
  }
  __syncthreads();
  if (tid == 0) cat_exp[best.i] = 1;

  // 3. Distances of the valid neighbours; 4. set their visited bits.
  const int warp = tid >> 5, wl = tid & 31;
  if (KIND == 0) {
    const float* q = ctxs + static_cast<size_t>(lane) * width;
    const float* X = static_cast<const float*>(table);
    for (int r = warp; r < R; r += kWarps) {
      const int v = cat_ids[L + r];
      if (v == kInvalid) continue;
      const float* xr = X + static_cast<size_t>(v) * width;
      float acc = 0.f;
      if (vec4) {
        const float4* x4 = reinterpret_cast<const float4*>(xr);
        const float4* q4 = reinterpret_cast<const float4*>(q);
        for (int c = wl; c < (width >> 2); c += 32) {
          const float4 a = __ldg(x4 + c), b = __ldg(q4 + c);
          const float dx = a.x - b.x, dy = a.y - b.y;
          const float dz = a.z - b.z, dw = a.w - b.w;
          acc += dx * dx + dy * dy + dz * dz + dw * dw;
        }
      } else {
        for (int c = wl; c < width; c += 32) {
          const float dx = __ldg(xr + c) - __ldg(q + c);
          acc += dx * dx;
        }
      }
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
      if (wl == 0) cat_d[L + r] = acc;
    }
  } else {
    const float* lut = ctxs + static_cast<size_t>(lane) * width * K;
    const uint8_t* codes = static_cast<const uint8_t*>(table);
    for (int r = tid; r < R; r += kThreads) {
      const int v = cat_ids[L + r];
      if (v == kInvalid) continue;
      const uint8_t* code = codes + static_cast<size_t>(v) * width;
      float acc = 0.f;
      for (int m = 0; m < width; ++m) acc += __ldg(lut + m * K + code[m]);
      cat_d[L + r] = acc;
    }
  }
  for (int r = tid; r < R; r += kThreads) {
    const int v = cat_ids[L + r];
    if (v != kInvalid) {
      atomicOr(vis + (v >> 5), 1u << (v & 31));
      atomicAdd(&s_nvalid, 1);
    }
  }
  __syncthreads();

  // 5. Keep the best L of the L+R candidates, exactly as a stable argsort.
  int open_after = 0;
  for (int i = tid; i < T; i += kThreads) {
    const float di = cat_d[i];
    int rank = 0;
    for (int k = 0; k < T; ++k) {
      const float dk = cat_d[k];
      rank += (dk < di) || (dk == di && k < i);
    }
    if (rank < L) {
      const int id = cat_ids[i];
      const bool e = cat_exp[i] != 0;
      ids[rank] = id;
      bd[rank] = di;
      bexp[rank] = e;
      open_after |= (!e && id != kInvalid && rank < budget);
    }
  }
  const int still_open = __syncthreads_or(open_after);
  if (tid == 0) {
    hops[lane] = h + 1;
    evals[lane] += s_nvalid;
    if (active_after != nullptr && h + 1 < hop_limit && still_open)
      atomicAdd(active_after, 1);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  kind 0 = exact, 1 = pq.  Launches
// on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int repro_beam_step(int kind, int q, int L, int R, int nw, int width,
                               int K, int vec4, void* beam_ids, void* beam_d,
                               void* beam_exp, void* visited, void* hops,
                               void* evals, const void* ctxs, const void* adj,
                               const void* table, const void* budgets,
                               const void* hop_limits, void* active_after,
                               void* stream) {
  if (q <= 0) return 0;
  const size_t smem = static_cast<size_t>(L + R) * (sizeof(float) + sizeof(int32_t) + 1);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* ids = static_cast<int32_t*>(beam_ids);
  auto* bd = static_cast<float*>(beam_d);
  auto* be = static_cast<bool*>(beam_exp);
  auto* vis = static_cast<uint32_t*>(visited);
  auto* hp = static_cast<int32_t*>(hops);
  auto* ev = static_cast<int32_t*>(evals);
  auto* cx = static_cast<const float*>(ctxs);
  auto* ad = static_cast<const int32_t*>(adj);
  auto* bu = static_cast<const int32_t*>(budgets);
  auto* hl = static_cast<const int32_t*>(hop_limits);
  auto* aa = static_cast<int32_t*>(active_after);
  if (kind == 0) {
    beam_step_kernel<0><<<q, kThreads, smem, s>>>(L, R, nw, width, K, vec4, ids, bd, be, vis,
                                                  hp, ev, cx, ad, table, bu, hl, aa);
  } else {
    beam_step_kernel<1><<<q, kThreads, smem, s>>>(L, R, nw, width, K, 0, ids, bd, be, vis,
                                                  hp, ev, cx, ad, table, bu, hl, aa);
  }
  return static_cast<int>(cudaGetLastError());
}
