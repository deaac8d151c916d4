// Batched beam walk for NVIDIA Hopper (sm_90a): one launch walks every query
// lane up to `max_hops` hops, each lane until it freezes, with its beam held
// in shared memory from the first hop to the last.
//
// Replaces the TPU kernel repro/kernels/beam_step.py::beam_step (Pallas,
// `_beam_step_kernel` + `_select_merge`), which advances every lane by one
// hop per call.  Semantics are those of iterating the plain oracle
// repro_torch/kernels/ref.py::beam_step_ref (a literal port of
// repro/kernels/ref.py::beam_step_ref): per hop, the frontier argmin over the
// unexpanded, valid, in-budget beam slots (ties to the lowest slot), the
// adjacency-row read, the visited-bit test, neighbour distances (squared L2
// for kind "exact", an ADC sum over the lane's LUT for kind "pq"), the
// visited-bit set, the keep-best-L merge equal to a stable argsort, and lane
// freezing (hop limit reached or frontier closed, as ref.py::lane_active).
// A launch with max_hops = 1 is one hop of the oracle.
//
// What bounds it on this card: the latency of dependent reads, then bytes.
// One lane-hop moves about R*D*4 + R*4 + R*4 bytes for "exact" (R rows of D
// floats gathered, the adjacency row, the visited words) and R*M for "pq"
// (R code rows; the LUT is read once per launch); it does about 3*R*D
// flops, far under the card's float32 rate.  Its reads are a chain: the
// frontier decides the adjacency row, which decides the visited words and
// the rows to gather.  The first port (one launch per hop) re-read and
// re-wrote the beam every hop, gathered rows one per warp per round (eight
// dependent rounds), ranked the L+R candidates in O((L+R)^2), and left the
// host a launch per hop.
//
// What the design does about it:
//   * one thread block per lane (grid = Q; 8 warps for "exact", 4 for
//     "pq"); lanes are independent (each
//     lane's visited words belong to its block alone), so a block loops
//     hops with block barriers only and no grid-wide synchronisation;
//   * the beam and the candidates live in shared memory, ping-ponged
//     between two buffers, and are written back once at the end with the
//     lane's hop and evaluation counts; the lane's context (the exact query
//     or the PQ LUT, 16 KB at M=16, K=256) is staged once per launch (a
//     LUT too large to sit beside the candidates is read from global);
//   * per hop the chain is three global round trips: the adjacency row, the
//     visited words (read past L1, since this block's own atomics set them
//     in L2), then the valid neighbour rows: "exact" rows go to shared
//     memory by `cp.async`, as many at once as fit in 48 KB (all R = 64
//     rows of D = 128 in one round; D = 960 at R = 96, GIST's shape, in 8
//     rounds of 12), and are reduced one warp per row; "pq" reads each code
//     row and sums LUT entries from shared memory, or from global memory
//     when the LUT does not fit beside the candidates (M * K * 4 bytes);
//     several rounds and a LUT in global memory are their own template
//     instantiations, so the common shapes keep their registers;
//   * the merge: a merged beam is sorted, so from the second hop of a
//     launch on (and from the first where the beam comes in sorted) a beam
//     entry's rank is its slot plus the new candidates below it, and a new
//     candidate's rank a binary search in the beam plus the new candidates
//     ahead of it: O(L*R + R*(R + log L)) compares.  An unsorted beam (a
//     scrubbed filter seed) takes the general rank
//       rank_i = #{j : d_j < d_i} + #{j < i : d_j == d_i}
//     for its first hop.  Both equal a stable argsort;
//   * a lane frozen at entry writes nothing; a lane that took hops writes
//     its beam, counters and the visited bits it set; the block adds one to
//     `active_after` when its lane could still move, so a walk to
//     convergence ends with the counter at 0 and the host reads it once.
//
// The out-of-core walk (repro_torch/index/disk.py::ooc_walk) keeps no
// adjacency on the card: the host reads each hop's rows from the block
// store, so every hop is a launch of its own, `repro_beam_hop_rows` (kind
// "pq").  It runs the same pieces (visited test, ADC sum, merge, block
// argmin) on one hop, with the row read from `rows + lane * R` in place of
// `adj + u * R`, and ends by selecting and marking the next frontier, which
// the host reads to fetch the next rows.  Every launch is the first hop of
// its launch, so the beam's order is tested each time (a filtered probe
// state may come in unsorted).  A hop reads only the R x M LUT entries its
// codes name (1,024 of 4,096 at R = 64, M = 16, K = 256), so it reads them
// from global memory: staging the whole LUT into shared memory each launch
// (by `cp.async`, overlapping the visited test) measured slower at serving
// shape (chip_smoke.py phase 2, when it timed both).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <climits>

namespace {

// Threads of a lane's block: "exact" spreads its 32 KB row gather and the
// merge over 8 warps, held to 64 registers so that 4 lanes share an SM
// (left free, the compiler takes enough to fit only 2); "pq" keeps no rows in
// shared memory, so it runs 4 warps in blocks small enough that 8 lanes
// share an SM.
template <int KIND>
struct Shape {
  static constexpr int kThreads = KIND == 0 ? 256 : 128;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kMinBlocks = KIND == 0 ? 4 : 8;
};
constexpr int kMaxWarps = 8;
constexpr int kInvalid = -1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448 - 1024;   // a block's limit, less static smem
constexpr size_t kRowBytes = 48 * 1024;   // exact rows gathered per round

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

template <int WARPS>
__device__ ArgMin block_argmin(ArgMin x, ArgMin* scratch) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  x = warp_argmin(x);
  if (wl == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = wl < WARPS ? scratch[wl] : ArgMin{CUDART_INF_F, INT_MAX};
    x = warp_argmin(x);
    if (wl == 0) scratch[0] = x;
  }
  __syncthreads();
  return scratch[0];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// n floats from global to shared memory by the whole block (16-byte copies
// when `vec`: both 16-byte aligned and n % 4 == 0); the caller waits.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, bool vec) {
  if (vec) {
    for (int c = threadIdx.x; c < (n >> 2); c += blockDim.x) cp_async16(dst + 4 * c, src + 4 * c);
  } else {
    for (int c = threadIdx.x; c < n; c += blockDim.x) cp_async4(dst + c, src + c);
  }
}

__host__ __device__ inline size_t pad4(size_t n) { return (n + 3) & ~static_cast<size_t>(3); }

// How a lane's block lays out its shared memory: the context (the exact
// query, or the PQ LUT when it fits), `rows_cap` exact rows per gather
// round, and the candidates twice (distance, id, expanded flag).
struct Plan {
  size_t smem;
  int rows_cap;
  int ctx_smem;
};

inline bool plan_walk(int kind, int L, int R, int width, int K, Plan* p) {
  const size_t T = static_cast<size_t>(L) + R;
  const size_t cand = 2 * T * (sizeof(float) + sizeof(int32_t)) + 2 * T;
  const size_t row = static_cast<size_t>(width) * sizeof(float);
  if (kind == 0) {
    const size_t fit = kRowBytes / row;
    p->rows_cap = static_cast<int>(fit < 1 ? 1 : (fit > static_cast<size_t>(R) ? R : fit));
    p->ctx_smem = 1;
    p->smem = (pad4(width) + pad4(static_cast<size_t>(p->rows_cap) * width)) * sizeof(float) +
              cand;
  } else {
    const size_t lut = pad4(static_cast<size_t>(width) * K) * sizeof(float);
    p->rows_cap = 0;
    p->ctx_smem = lut + cand <= static_cast<size_t>(kMaxSmem);
    p->smem = (p->ctx_smem ? lut : 0) + cand;
  }
  return p->smem <= static_cast<size_t>(kMaxSmem);
}

// The pieces of a hop, shared by the resident walk and the row-fed hop.
// Candidates live in shared memory as the L beam slots followed by the R
// neighbours of the hop (distance cd, id ci, expanded flag ce).

// Each thread's part of the frontier: the argmin over the open slots
// (unexpanded, valid, in budget) it visits, and whether it saw one.
template <int THREADS>
__device__ __forceinline__ ArgMin open_argmin(int L, int budget, const float* cd,
                                              const int32_t* ci, const unsigned char* ce,
                                              int* open) {
  ArgMin best{CUDART_INF_F, INT_MAX};
  int o = 0;
  for (int i = threadIdx.x; i < L; i += THREADS) {
    const bool closed = ce[i] || ci[i] == kInvalid || i >= budget;
    o |= !closed;
    best = better(best, ArgMin{closed ? CUDART_INF_F : cd[i], i});
  }
  *open = o;
  return best;
}

// The visited test of frontier u's adjacency row: neighbour r becomes a
// candidate when it is valid, unvisited and u is valid, else INVALID at
// inf.  Every read comes before any bit of the hop is set.
template <int THREADS>
__device__ __forceinline__ void test_row(const int32_t* __restrict__ row, int u, int L,
                                         int R, const uint32_t* vis, float* cd, int32_t* ci,
                                         unsigned char* ce) {
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const int v = __ldg(row + r);
    const int safe = v < 0 ? 0 : v;
    const uint32_t bit = 1u << (safe & 31);
    const bool seen = (__ldcg(vis + (safe >> 5)) & bit) != 0u;
    const bool valid = v != kInvalid && u != kInvalid && !seen;
    ci[L + r] = valid ? v : kInvalid;
    cd[L + r] = CUDART_INF_F;
    ce[L + r] = 0;
  }
}

// Set the visited bits of the valid candidates (reductions nobody waits
// on); returns how many this thread set.
template <int THREADS>
__device__ __forceinline__ int set_visited(int L, int R, const int32_t* ci, uint32_t* vis) {
  int mine = 0;
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const int v = ci[L + r];
    if (v != kInvalid) {
      atomicOr(vis + (v >> 5), 1u << (v & 31));
      ++mine;
    }
  }
  return mine;
}

// ADC distances of the valid candidates: a thread a code row, LUT entries
// summed in m order (shared or global memory).
template <int THREADS>
__device__ __forceinline__ void adc(const float* lut, const uint8_t* __restrict__ codes,
                                    int width, int K, int L, int R, const int32_t* ci,
                                    float* cd) {
  for (int r = threadIdx.x; r < R; r += THREADS) {
    const int v = ci[L + r];
    if (v == kInvalid) continue;
    const uint8_t* code = codes + static_cast<size_t>(v) * width;
    float acc = 0.f;
#pragma unroll 8
    for (int m = 0; m < width; ++m) acc += lut[m * K + __ldg(code + m)];
    cd[L + r] = acc;
  }
}

// Keep the best L of the L + R candidates into (nd, ni, ne), exactly as a
// stable argsort (see the header for the sorted and unsorted ranks).
template <int THREADS>
__device__ __forceinline__ void merge(int L, int R, bool sorted, const float* cd,
                                      const int32_t* ci, const unsigned char* ce, float* nd,
                                      int32_t* ni, unsigned char* ne) {
  const int T = L + R;
  for (int i = threadIdx.x; i < T; i += THREADS) {
    const float di = cd[i];
    int rank;
    if (sorted && i < L) {
      rank = i;
      for (int r = 0; r < R; ++r) rank += cd[L + r] < di;
    } else if (sorted) {
      int lo = 0, hi = L;                    // beam entries <= di
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cd[mid] <= di) lo = mid + 1; else hi = mid;
      }
      rank = lo;
      const int ri = i - L;
      for (int r = 0; r < R; ++r) {
        const float dr = cd[L + r];
        rank += dr < di || (dr == di && r < ri);
      }
    } else {
      rank = 0;
      for (int k = 0; k < T; ++k) {
        const float dk = cd[k];
        rank += (dk < di) || (dk == di && k < i);
      }
    }
    if (rank < L) {
      ni[rank] = ci[i];
      nd[rank] = di;
      ne[rank] = ce[i];
    }
  }
}

// KIND 0: exact (table = (N, width) float32, ctxs = (Q, width) float32).
// KIND 1: pq    (table = (N, width) uint8 codes, ctxs = (Q, width, K) LUTs).
// SPLIT: exact rows gathered in several rounds of `rows_cap`, or a LUT read
// from global memory; its own instantiation, so the common shapes (one
// round, the LUT in shared memory) run the code and registers of their own.
template <int KIND, bool SPLIT>
__global__ void __launch_bounds__(Shape<KIND>::kThreads, Shape<KIND>::kMinBlocks)
beam_walk_kernel(
    int L, int R, int width, int K, int vec4, int max_hops, int rows_cap,
    int32_t* __restrict__ beam_ids, float* __restrict__ beam_d,
    bool* __restrict__ beam_exp, uint32_t* __restrict__ visited,
    int32_t* __restrict__ hops, int32_t* __restrict__ evals,
    const float* __restrict__ ctxs, const int32_t* __restrict__ adj,
    const void* __restrict__ table, const int32_t* __restrict__ budgets,
    const int32_t* __restrict__ hop_limits, int32_t* __restrict__ active_after, int nw) {
  extern __shared__ float4 smem4[];
  constexpr int kThreads = Shape<KIND>::kThreads, kWarps = Shape<KIND>::kWarps;
  __shared__ ArgMin red[kMaxWarps];
  __shared__ int s_nvalid;
  const int T = L + R;
  const int ctx_len = KIND == 0 ? width : width * K;
  float* ctx_s = reinterpret_cast<float*>(smem4);
  constexpr bool ctx_smem = KIND == 0 || !SPLIT;
  float* rows_s = ctx_s + (ctx_smem ? pad4(ctx_len) : 0);
  // Candidate buffer b (0 or 1): distances at cat_d + b*T, ids at
  // cat_ids + b*T, expanded flags at cat_exp + b*T.
  float* cat_d = rows_s + (KIND == 0 ? pad4(static_cast<size_t>(rows_cap) * width) : 0);
  int32_t* cat_ids = reinterpret_cast<int32_t*>(cat_d + 2 * T);
  unsigned char* cat_exp = reinterpret_cast<unsigned char*>(cat_ids + 2 * T);

  const int lane = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;
  int32_t* ids = beam_ids + static_cast<size_t>(lane) * L;
  float* bd = beam_d + static_cast<size_t>(lane) * L;
  bool* bexp = beam_exp + static_cast<size_t>(lane) * L;
  uint32_t* vis = visited + static_cast<size_t>(lane) * nw;
  const int budget = budgets[lane];
  const int hop_limit = hop_limits[lane];
  int h = hops[lane];
  int ev = evals[lane];

  // The beam and the lane's context into shared memory, once.
  const float* ctx_g = ctxs + static_cast<size_t>(lane) * ctx_len;
  if (ctx_smem) stage(ctx_s, ctx_g, ctx_len, vec4 != 0);
  for (int i = tid; i < L; i += kThreads) {
    cat_ids[i] = ids[i];
    cat_d[i] = bd[i];
    cat_exp[i] = bexp[i];
  }
  cp_async_wait_all();
  __syncthreads();
  int in_order = 1;
  for (int i = tid; i + 1 < L; i += kThreads) in_order &= cat_d[i] <= cat_d[i + 1];
  bool sorted = __syncthreads_and(in_order) != 0;

  int p = 0, taken = 0;
  bool can_move;
  for (;;) {
    float* cd = cat_d + p * T;
    int32_t* ci = cat_ids + p * T;
    unsigned char* ce = cat_exp + p * T;

    // 1. Frontier: argmin over open slots; freeze test.
    int open;
    ArgMin best = open_argmin<kThreads>(L, budget, cd, ci, ce, &open);
    if (tid == 0) s_nvalid = 0;
    can_move = __syncthreads_or(open) != 0 && h < hop_limit;
    if (!can_move || taken == max_hops) break;
    best = block_argmin<kWarps>(best, red);
    const int u = ci[best.i];

    // 2. Adjacency row and visited test (every read before any bit is set).
    test_row<kThreads>(adj + static_cast<size_t>(u < 0 ? 0 : u) * R, u, L, R, vis, cd, ci, ce);
    __syncthreads();
    if (tid == 0) ce[best.i] = 1;

    // 3. The valid exact rows in flight by `cp.async` (all at once, or
    // `rows_cap` a round), the visited bits set while they land (reductions
    // the block does not wait on), then one warp per row reduces; "pq" sums
    // LUT entries.
    const float* X = static_cast<const float*>(table);
    const int chunks = vec4 ? width >> 2 : width;
    auto gather = [&](int r0, int rn) {
      for (int e = tid; e < rn * chunks; e += kThreads) {
        const int r = e / chunks, c = e - r * chunks;
        const int v = ci[L + r0 + r];
        if (v == kInvalid) continue;
        if (vec4)
          cp_async16(rows_s + r * width + 4 * c, X + static_cast<size_t>(v) * width + 4 * c);
        else
          cp_async4(rows_s + r * width + c, X + static_cast<size_t>(v) * width + c);
      }
    };
    auto reduce = [&](int r0, int rn) {
      for (int r = warp; r < rn; r += kWarps) {
        if (ci[L + r0 + r] == kInvalid) continue;
        const float* xr = rows_s + r * width;
        float acc = 0.f;
        if (vec4) {
          const float4* x4 = reinterpret_cast<const float4*>(xr);
          const float4* q4 = reinterpret_cast<const float4*>(ctx_s);
          for (int c = wl; c < (width >> 2); c += 32) {
            const float4 a = x4[c], b = q4[c];
            const float dx = a.x - b.x, dy = a.y - b.y;
            const float dz = a.z - b.z, dw = a.w - b.w;
            acc += dx * dx + dy * dy + dz * dz + dw * dw;
          }
        } else {
          for (int c = wl; c < width; c += 32) {
            const float dx = xr[c] - ctx_s[c];
            acc += dx * dx;
          }
        }
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
        if (wl == 0) cd[L + r0 + r] = acc;
      }
    };
    if (KIND == 0 && !SPLIT) gather(0, R);
    const int mine = set_visited<kThreads>(L, R, ci, vis);
    if (mine) atomicAdd(&s_nvalid, mine);
    if (KIND == 0 && !SPLIT) {
      cp_async_wait_all();
      __syncthreads();
      reduce(0, R);
    } else if (KIND == 0) {
      for (int r0 = 0; r0 < R; r0 += rows_cap) {
        const int rn = min(rows_cap, R - r0);
        if (r0 > 0) __syncthreads();  // every warp done with the last round
        gather(r0, rn);
        cp_async_wait_all();
        __syncthreads();
        reduce(r0, rn);
      }
    } else {
      adc<kThreads>(ctx_smem ? ctx_s : ctx_g, static_cast<const uint8_t*>(table), width, K, L,
                    R, ci, cd);
    }
    __syncthreads();
    const int nvalid = s_nvalid;

    // 5. Keep the best L of the L+R candidates, exactly as a stable argsort.
    float* nd = cat_d + (p ^ 1) * T;
    int32_t* ni = cat_ids + (p ^ 1) * T;
    unsigned char* ne = cat_exp + (p ^ 1) * T;
    merge<kThreads>(L, R, sorted, cd, ci, ce, nd, ni, ne);
    __syncthreads();
    sorted = true;
    p ^= 1;
    ++h;
    ++taken;
    ev += nvalid;
  }

  if (taken > 0) {
    for (int i = tid; i < L; i += kThreads) {
      ids[i] = cat_ids[p * T + i];
      bd[i] = cat_d[p * T + i];
      bexp[i] = cat_exp[p * T + i] != 0;
    }
    if (tid == 0) {
      hops[lane] = h;
      evals[lane] = ev;
    }
  }
  if (tid == 0 && active_after != nullptr && can_move) atomicAdd(active_after, 1);
}

template <int KIND, bool SPLIT>
cudaError_t launch(int q, int L, int R, int nw, int width, int K, int vec4, int max_hops,
                   const Plan& pl, int32_t* ids, float* bd, bool* be, uint32_t* vis,
                   int32_t* hp, int32_t* ev, const float* cx, const int32_t* ad,
                   const void* table, const int32_t* bu, const int32_t* hl, int32_t* aa,
                   cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(beam_walk_kernel<KIND, SPLIT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(pl.smem));
  if (e != cudaSuccess) return e;
  beam_walk_kernel<KIND, SPLIT><<<q, Shape<KIND>::kThreads, pl.smem, s>>>(
      L, R, width, K, vec4, max_hops, pl.rows_cap, ids, bd, be, vis, hp, ev, cx,
      ad, table, bu, hl, aa, nw);
  return cudaGetLastError();
}

// One hop of every lane with its adjacency row supplied by the caller (kind
// "pq"): the out-of-core walk's hop, whose rows come from the block store
// on the host.  Semantics are ref.py::beam_hop_rows_ref (the reference's
// repro/core/search.py::ooc_hop_batch): an `active` lane expands its
// already-selected frontier u (marked in beam_exp by the select that chose
// it; this launch does not select it again) with `rows + lane * R`, every
// lane then takes the freeze test, and a lane that can move selects, marks
// and reports its next frontier.  `active == nullptr` is the select alone
// (every lane inactive; rows, LUTs and codes unread).  The ADC reads the
// lane's LUT from global memory.
__global__ void __launch_bounds__(Shape<1>::kThreads, Shape<1>::kMinBlocks)
beam_hop_rows_kernel(
    int L, int R, int width, int K,
    int32_t* __restrict__ beam_ids, float* __restrict__ beam_d,
    bool* __restrict__ beam_exp, uint32_t* __restrict__ visited,
    int32_t* __restrict__ hops, int32_t* __restrict__ evals,
    const int32_t* __restrict__ u_in, const bool* __restrict__ active_in,
    const int32_t* __restrict__ rows, const float* __restrict__ luts,
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ budgets,
    const int32_t* __restrict__ hop_limits, int32_t* __restrict__ u_out,
    bool* __restrict__ active_out, int nw) {
  extern __shared__ float4 smem4[];
  constexpr int kThreads = Shape<1>::kThreads, kWarps = Shape<1>::kWarps;
  __shared__ ArgMin red[kMaxWarps];
  __shared__ int s_nvalid;
  const int T = L + R;
  float* cat_d = reinterpret_cast<float*>(smem4);
  int32_t* cat_ids = reinterpret_cast<int32_t*>(cat_d + 2 * T);
  unsigned char* cat_exp = reinterpret_cast<unsigned char*>(cat_ids + 2 * T);

  const int lane = blockIdx.x, tid = threadIdx.x;
  int32_t* ids = beam_ids + static_cast<size_t>(lane) * L;
  float* bd = beam_d + static_cast<size_t>(lane) * L;
  bool* bexp = beam_exp + static_cast<size_t>(lane) * L;
  uint32_t* vis = visited + static_cast<size_t>(lane) * nw;
  const bool act = active_in != nullptr && active_in[lane];
  int h = hops[lane];
  int ev = evals[lane];

  for (int i = tid; i < L; i += kThreads) {
    cat_ids[i] = ids[i];
    cat_d[i] = bd[i];
    cat_exp[i] = bexp[i];
  }
  int p = 0;
  if (act) {
    if (tid == 0) s_nvalid = 0;
    test_row<kThreads>(rows + static_cast<size_t>(lane) * R, u_in[lane], L, R, vis, cat_d,
                       cat_ids, cat_exp);
    __syncthreads();
    int in_order = 1;
    for (int i = tid; i + 1 < L; i += kThreads) in_order &= cat_d[i] <= cat_d[i + 1];
    const bool sorted = __syncthreads_and(in_order) != 0;
    const int mine = set_visited<kThreads>(L, R, cat_ids, vis);
    if (mine) atomicAdd(&s_nvalid, mine);
    adc<kThreads>(luts + static_cast<size_t>(lane) * width * K, codes, width, K, L, R,
                  cat_ids, cat_d);
    __syncthreads();
    merge<kThreads>(L, R, sorted, cat_d, cat_ids, cat_exp, cat_d + T, cat_ids + T,
                    cat_exp + T);
    ev += s_nvalid;
    ++h;
    p = 1;
  }
  __syncthreads();

  // The freeze test and the next frontier.
  float* cd = cat_d + p * T;
  int32_t* ci = cat_ids + p * T;
  unsigned char* ce = cat_exp + p * T;
  int open;
  ArgMin best = open_argmin<kThreads>(L, budgets[lane], cd, ci, ce, &open);
  const bool can_move = __syncthreads_or(open) != 0 && h < hop_limits[lane];
  int u_next = kInvalid;
  if (can_move) {
    best = block_argmin<kWarps>(best, red);
    u_next = ci[best.i];
    if (act && tid == 0) ce[best.i] = 1;
  }
  if (act) {
    __syncthreads();
    for (int i = tid; i < L; i += kThreads) {
      ids[i] = ci[i];
      bd[i] = cd[i];
      bexp[i] = ce[i] != 0;
    }
    if (tid == 0) {
      hops[lane] = h;
      evals[lane] = ev;
    }
  } else if (can_move && tid == 0) {
    bexp[best.i] = true;
  }
  if (tid == 0) {
    u_out[lane] = u_next;
    active_out[lane] = can_move;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  kind 0 = exact, 1 = pq; `vec4`
// says the rows and context may be copied 16 bytes at a time (exact: width
// % 4 == 0 with table and ctxs 16-byte aligned; pq: width * K % 4 == 0 with
// ctxs 16-byte aligned).  Walks each lane at most `max_hops` hops.
// Launches on `stream`, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the caller can raise on a refused launch;
// returns kTooWide, launching nothing, when the candidates, the exact query
// and one exact row do not fit in a block's shared memory.
constexpr int kTooWide = -2;
extern "C" int repro_beam_walk(int kind, int q, int L, int R, int nw, int width, int K,
                               int vec4, int max_hops, void* beam_ids, void* beam_d,
                               void* beam_exp, void* visited, void* hops, void* evals,
                               const void* ctxs, const void* adj, const void* table,
                               const void* budgets, const void* hop_limits,
                               void* active_after, void* stream) {
  if (q <= 0) return 0;
  if (L <= 0 || R <= 0 || width <= 0 || max_hops < 0 || (kind == 1 && K <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  if (!plan_walk(kind, L, R, width, K, &pl)) return kTooWide;
  auto* s = static_cast<cudaStream_t>(stream);
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
  const bool split = kind == 0 ? pl.rows_cap < R : !pl.ctx_smem;
#define REPRO_WALK_ARGS \
  q, L, R, nw, width, K, vec4, max_hops, pl, ids, bd, be, vis, hp, ev, cx, ad, table, bu, hl, aa, s
  const cudaError_t e =
      kind == 0 ? (split ? launch<0, true>(REPRO_WALK_ARGS) : launch<0, false>(REPRO_WALK_ARGS))
                : (split ? launch<1, true>(REPRO_WALK_ARGS) : launch<1, false>(REPRO_WALK_ARGS));
#undef REPRO_WALK_ARGS
  return static_cast<int>(e);
}

// Plain C entry point of the row-fed hop (kind "pq" only), loaded with
// ctypes: one hop of every lane as beam_hop_rows_kernel says, the state
// updated in place, `u_next` (Q,) int32 and `active_next` (Q,) bool
// written.  `active == nullptr` launches the select alone (R, width and K
// then unused).  Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError(), or kTooWide, launching nothing,
// when the two candidate buffers do not fit in a block's shared memory.
extern "C" int repro_beam_hop_rows(int q, int L, int R, int nw, int width, int K,
                                   void* beam_ids, void* beam_d, void* beam_exp,
                                   void* visited, void* hops, void* evals, const void* u,
                                   const void* active, const void* rows, const void* luts,
                                   const void* codes, const void* budgets,
                                   const void* hop_limits, void* u_next, void* active_next,
                                   void* stream) {
  if (q <= 0) return 0;
  if (active == nullptr) R = width = K = 0;
  if (L <= 0 || R < 0 || (active != nullptr && (R <= 0 || width <= 0 || K <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t T = static_cast<size_t>(L) + R;
  const size_t smem = 2 * T * (sizeof(float) + sizeof(int32_t)) + 2 * T;
  if (smem > static_cast<size_t>(kMaxSmem)) return kTooWide;
  cudaError_t e = cudaFuncSetAttribute(beam_hop_rows_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  beam_hop_rows_kernel<<<q, Shape<1>::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      L, R, width, K, static_cast<int32_t*>(beam_ids), static_cast<float*>(beam_d),
      static_cast<bool*>(beam_exp), static_cast<uint32_t*>(visited),
      static_cast<int32_t*>(hops), static_cast<int32_t*>(evals),
      static_cast<const int32_t*>(u), static_cast<const bool*>(active),
      static_cast<const int32_t*>(rows), static_cast<const float*>(luts),
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(budgets),
      static_cast<const int32_t*>(hop_limits), static_cast<int32_t*>(u_next),
      static_cast<bool*>(active_next), nw);
  return static_cast<int>(cudaGetLastError());
}
