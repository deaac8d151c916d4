// Tiled squared-L2 distance matrix for NVIDIA Hopper (sm_90a) on the tensor
// cores:
//   out[i, j] = max((|q_i|^2 - 2 q_i.x_j) + |x_j|^2, 0),  accumulated in f32.
//
// Replaces the TPU kernel repro/kernels/l2_distance.py::l2_distance (Pallas,
// `_l2_kernel`: one MXU matmul per (128, 128) block with the norms fused).
// Semantics are those of repro_torch/kernels/ref.py::l2_distance_ref.
//
// What bounds it on this card: operations.  A (Q, D) x (N, D) call does
// 2*Q*N*D flops of cross term and moves (Q + N)*D input elements plus
// Q*N*4 output bytes; at the k-NN shape (4096 x 65536 x 128) that is
// 68.7 GFLOP against 1.1 GB (0.33 ms at 3.35 TB/s).  One TF32 pass keeps
// about three decimal digits, which breaks the port's 1e-4 tolerance, so the
// float32 cross term is taken as three TF32 products (3xTF32): 206 GFLOP,
// 0.42 ms at the TF32 tensor-core rate (495 TFLOP/s), against 1.03 ms for
// any kernel at the float32 SIMT rate (67 TFLOP/s).
//
// What the design does about it (float32):
//   * 3xTF32 on `wgmma` (m64n128k8 tf32, f32 accumulation): each f32
//     operand is split into big = rna_tf32(v) and small = rna_tf32(v - big),
//     and each k-step of 8 is taken as small.big + big.small + big.big;
//     the dropped small.small term is about 2^-22 of a product.  On integer
//     operands with |v| <= 2048, big is exact and small is 0, every product
//     is exact and every f32 sum below 2^24 is exact in any order, so such
//     inputs give the plain version's result bit for bit;
//   * a slice of 32 along D goes into a fresh partial (its first product
//     with scale-d 0), small terms of all four k-steps first, then the
//     big.big terms, and an IEEE f32 add puts the partial into the
//     accumulators.  The tensor cores align their addends to the largest
//     and round the sum toward zero, so every sum into a large partial
//     loses a little, always in one direction: 48 sums straight into an
//     accumulator of |q|^2 scale (SIFT: 2.8e6) lost up to 10 of d2 on the
//     card, beyond rtol 1e-4 at a near duplicate's d2; with a partial per
//     slice the loss is below the plain float32 version's;
//   * a 128 x 128 output tile per block of 2 warpgroups, a 64 x 128 half
//     each.  The raw slices (query and base rows) arrive by 16-byte
//     `cp.async` in a 3-slot ring; each warp splits its 16 query rows in
//     registers (the A operand); the block splits the base rows once into
//     TF32 big and small parts in shared memory, in the layout wgmma reads
//     without a swizzle, double-buffered, so the next slice is split while
//     the tensor cores work on this one; elements past D and rows past Q or
//     N are zero-filled, so any D runs (a D whose rows are not 16-byte
//     aligned is staged by plain loads);
//   * persistent blocks, one an SM (the occupancy calculator's count),
//     each walking its share of the output tiles down the query rows first
//     (the blocks at work share a few base tiles in L2), with one ring that
//     runs on across tile boundaries;
//   * the epilogue writes (qn - 2*dot) + xn clamped at 0, the reference's
//     order, straight from the accumulators: neighbouring lanes swap halves
//     (one shuffle pair) so that each lane stores 4 consecutive floats of
//     one row as a 16-byte streaming store where N % 4 == 0;
//   * the norms stay SIMT f32 sums, computed once per call by a first
//     launch (a warp per row, lanes in k order, then a fixed butterfly);
//     each tile's 256 norms ride into shared memory with its first slice.
// bfloat16 operands take one `mma.sync.m16n8k16.bf16` pass (a product of
// two bf16 values is exact in f32, so only the order of the sums differs
// from the plain version), 8 warps of 64 x 32 each, 2 blocks an SM.
//
// On the card (NVIDIA H100 80GB HBM3, 700 W; chip_l2_study.py) the products
// alone take about 0.5 ms at the k-NN shape, and the loads, splits and
// stores alone about 0.8 ms: the 128 x 128 tile reads 2.1 GB of operands
// from L2 besides the 1 GiB it writes, and the registers that 3xTF32's
// partials need leave no room for a wider tile.  Fusing the top-k
// selection into the epilogue, so the (Q, N) matrix is never written, is the
// next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <type_traits>

namespace {

constexpr int kBM = 128;  // query rows per tile
constexpr int kBN = 128;  // base rows per tile
constexpr int kBK = 32;   // elements of D per slice
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// A raw slice in shared memory: kBM query rows, then kBN base rows, each of
// kBK elements padded by 16 bytes so fragment loads hit distinct banks.
template <typename T>
struct Slice {
  static constexpr int kRowWords = kBK * (int)sizeof(T) / 4 + 4;
  static constexpr int kWords = (kBM + kBN) * kRowWords;
  static constexpr int kChunks = kBK * (int)sizeof(T) / 16;  // 16-byte chunks a row
  static constexpr int kPerChunk = 16 / (int)sizeof(T);
  static constexpr int kRowElems = kRowWords * 4 / (int)sizeof(T);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte copy; `bytes` = 0 zero-fills the destination without reading.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}
// 4-byte copy through L1; `bytes` = 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Round a finite f32 to TF32 (10 mantissa bits), to nearest with ties away
// from zero: what cvt.rna.tf32.f32 gives, in two integer instructions
// (ptxas expands the cvt into a longer sequence that checks for inf/NaN).
__device__ __forceinline__ uint32_t rna_tf32(uint32_t u) {
  return (u + 0x1000u) & 0xffffe000u;
}
// v -> (big, small): big = rna_tf32(v), small = rna_tf32(v - big).
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& big, uint32_t& small) {
  big = rna_tf32(v);
  small = rna_tf32(__float_as_uint(__uint_as_float(v) - __uint_as_float(big)));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four 8 x 4-word matrices from shared memory (ldmatrix on b16 pairs): lane
// l gives the address of row l % 8 of matrix l / 8 and receives word l % 4
// of row l / 4 of each, which is the m16n8k8 tf32 (and m16n8k16 bf16)
// fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Stage D elements [k0, k0 + kBK) of the tile's query and base rows into
// the raw slice `st`, with NT threads.  kVec: 16-byte cp.async (rows
// 16-byte aligned, D a multiple of 16 bytes); else plain element loads.
template <typename T, bool kVec, int NT>
__device__ __forceinline__ void load_slice(uint32_t* st, const T* __restrict__ q,
                                           const T* __restrict__ x, int nq, int n, int d,
                                           int row0, int col0, int k0) {
  using S = Slice<T>;
  uint32_t* xs = st + kBM * S::kRowWords;
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kBM * S::kChunks / NT; ++i) {
      const int c = threadIdx.x + i * NT;
      const int r = c / S::kChunks, ch = c % S::kChunks;
      const int gk = k0 + ch * S::kPerChunk;
      const bool kin = gk < d;
      const bool qin = kin && row0 + r < nq, xin = kin && col0 + r < n;
      cp_async16(st + r * S::kRowWords + ch * 4,
                 qin ? q + (size_t)(row0 + r) * d + gk : q, qin ? 16 : 0);
      cp_async16(xs + r * S::kRowWords + ch * 4,
                 xin ? x + (size_t)(col0 + r) * d + gk : x, xin ? 16 : 0);
    }
  } else {
    using Raw = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
    const Raw* qr = reinterpret_cast<const Raw*>(q);
    const Raw* xr = reinterpret_cast<const Raw*>(x);
    Raw* qsr = reinterpret_cast<Raw*>(st);
    Raw* xsr = reinterpret_cast<Raw*>(xs);
#pragma unroll 4
    for (int i = 0; i < kBM * kBK / NT; ++i) {
      const int e = threadIdx.x + i * NT;
      const int r = e / kBK, c = e % kBK, gk = k0 + c;
      qsr[r * S::kRowElems + c] =
          (gk < d && row0 + r < nq) ? qr[(size_t)(row0 + r) * d + gk] : Raw(0);
      xsr[r * S::kRowElems + c] =
          (gk < d && col0 + r < n) ? xr[(size_t)(col0 + r) * d + gk] : Raw(0);
    }
  }
}

// The persistent blocks' walk: tiles b, b + gridDim.x, ..., taken as one
// sequence of (tile, slice) steps; tiles go down the query rows first
// (tile = n_tile * tiles_m + m_tile).  `next` loads the next step's raw
// slice into the next of kSlots ring slots and, at a tile's first slice,
// its 256 norms (one a thread) into the next of kNormSlots norm slots.
template <typename T, bool kVec, int NT, int kSlots, int kNormSlots>
struct Loader {
  const T* q;
  const T* x;
  const float* qn;
  const float* xn;
  int nq, n, d, tiles_m, ktiles;
  int tile, k = 0, slot = 0, nslot = 0, row0, col0;

  __device__ __forceinline__ Loader(const T* q_, const T* x_, const float* qn_, const float* xn_,
                                    int nq_, int n_, int d_, int tiles_m_, int ktiles_)
      : q(q_), x(x_), qn(qn_), xn(xn_), nq(nq_), n(n_), d(d_), tiles_m(tiles_m_),
        ktiles(ktiles_), tile(blockIdx.x) {
    row0 = (tile % tiles_m) * kBM;
    col0 = (tile / tiles_m) * kBN;
  }
  __device__ __forceinline__ void next(uint32_t* ring, float (*norms)[kBM + kBN]) {
    if (k == 0) {
      const int r = threadIdx.x;
      if (r < kBM + kBN) {
        const int gi = r < kBM ? row0 + r : col0 + r - kBM;
        const bool in = r < kBM ? gi < nq : gi < n;
        cp_async4(&norms[nslot][r], in ? (r < kBM ? qn : xn) + gi : qn, in ? 4 : 0);
      }
      if (++nslot == kNormSlots) nslot = 0;
    }
    load_slice<T, kVec, NT>(ring + slot * Slice<T>::kWords, q, x, nq, n, d, row0, col0,
                            k * kBK);
    if (++slot == kSlots) slot = 0;
    if (++k == ktiles) {
      k = 0;
      tile += gridDim.x;
      row0 = (tile % tiles_m) * kBM;
      col0 = (tile / tiles_m) * kBN;
    }
  }
};

// Squared norms of `rows` rows of width d: a warp per row, each lane summing
// its columns in k order, then a butterfly that leaves every lane the sum.
template <typename T>
__global__ void __launch_bounds__(256)
norms_kernel(const T* __restrict__ v, int rows, int d, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* r = v + row * d;
  float s = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float w = widen(r[k]);
    s = fmaf(w, w, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) out[row] = s;
}

// Write rows (r, r + 8) x columns (c, c + 1) of a tile from one accumulator
// fragment, (qn - 2*dot) + xn clamped at 0, and zero the fragment.  Lane
// pairs (t, t ^ 1) swap halves, so an even t stores columns c..c+3 of row r
// and an odd t columns c-2..c+1 of row r + 8, as one 16-byte streaming
// store where N % 4 == 0.  lr, lc: row and column within the tile; ns: the
// tile's 128 query norms, then its 128 base norms.
__device__ __forceinline__ void store_frag(float* f, const float* ns, float* __restrict__ out,
                                           int nq, int n, int row0, int col0, int lr, int lc,
                                           int t) {
  const bool odd = t & 1;
  const float qa = ns[lr], qb = ns[lr + 8];
  const float x0 = ns[kBM + lc], x1 = ns[kBM + lc + 1];
  const float v0 = fmaxf((qa - 2.f * f[0]) + x0, 0.f);
  const float v1 = fmaxf((qa - 2.f * f[1]) + x1, 0.f);
  const float v2 = fmaxf((qb - 2.f * f[2]) + x0, 0.f);
  const float v3 = fmaxf((qb - 2.f * f[3]) + x1, 0.f);
  const float r0 = __shfl_xor_sync(kFull, odd ? v0 : v2, 1);
  const float r1 = __shfl_xor_sync(kFull, odd ? v1 : v3, 1);
  const int orow = row0 + (odd ? lr + 8 : lr), oc = col0 + (odd ? lc - 2 : lc);
  const float w[4] = {odd ? r0 : v0, odd ? r1 : v1, odd ? v2 : r0, odd ? v3 : r1};
  if (orow < nq) {
    float* o = out + (size_t)orow * n + oc;
    if ((n % 4) == 0 && oc + 3 < n) {
      __stcs(reinterpret_cast<float4*>(o), make_float4(w[0], w[1], w[2], w[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (oc + e < n) __stcs(o + e, w[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = 0.f;
}

// ----------------------------------------------------------------- float32

namespace f32 {
constexpr int kThreads = 256;                 // 2 warpgroups
constexpr int kSlots = 3;                     // raw ring
constexpr int kNormSlots = kSlots + 1;        // tiles whose norms are in flight
constexpr int kRW = Slice<float>::kRowWords;
constexpr int kSplitWords = 2 * kBN * kBK;    // base big, then base small
constexpr size_t kSmem = ((size_t)kSlots * Slice<float>::kWords + 2 * kSplitWords) * 4;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory matrix descriptor for the split base rows: no swizzle,
// 8-row x 16-byte core matrices, the two k halves of a k-step 128 bytes
// apart (LBO), 8-row groups 256 bytes apart (SBO).
__device__ __forceinline__ uint64_t core_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffff) >> 4) | (uint64_t(128 >> 4) << 16) |
         (uint64_t(256 >> 4) << 32);
}
// d (+)= A (64 x 8 tf32, registers) * B (8 x 128 tf32, shared memory);
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
// Registers an in-flight wgmma reads or writes: the compiler must neither
// read them early nor reuse them before the wait.
template <int N>
__device__ __forceinline__ void hold(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(v[i])::"memory");
}

// Split the raw slice's base rows into big and small parts at `sp`, in
// core-matrix layout: element (row, k) at word (k / 8) * 1024 + (row / 8) *
// 64 + ((k / 4) % 2) * 32 + (row % 8) * 4 + k % 4; then hand them to the
// tensor cores' (async) proxy.
__device__ __forceinline__ void split_base(const uint32_t* __restrict__ raw,
                                           uint32_t* __restrict__ sp) {
#pragma unroll
  for (int h = 0; h < kBN * kBK / 4 / kThreads; ++h) {
    const int c = threadIdx.x + h * kThreads;  // 16-byte chunk: row c % 128, k chunk c / 128
    const int row = c & (kBN - 1), kc = c >> 7;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + (kBM + row) * kRW + kc * 4);
    uint4 b, sm;
    split_tf32(v.x, b.x, sm.x);
    split_tf32(v.y, b.y, sm.y);
    split_tf32(v.z, b.z, sm.z);
    split_tf32(v.w, b.w, sm.w);
    const int off = (kc >> 1) * 1024 + (row >> 3) * 64 + (kc & 1) * 32 + (row & 7) * 4;
    *reinterpret_cast<uint4*>(sp + off) = b;
    *reinterpret_cast<uint4*>(sp + kBN * kBK + off) = sm;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const float* __restrict__ q, const float* __restrict__ x, const float* __restrict__ qn,
       const float* __restrict__ xn, float* __restrict__ out, int nq, int n, int d, int tiles_m,
       int tiles) {
  extern __shared__ __align__(128) uint32_t smem[];
  __shared__ float norms_s[kNormSlots][kBM + kBN];
  uint32_t* split = smem + kSlots * Slice<float>::kWords;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
  const int ktiles = d > kBK ? (d + kBK - 1) / kBK : 1;
  const int mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = mine * ktiles;
  if (steps == 0) return;
  // This warp's 16 query rows of a raw slice, as ldmatrix addresses.
  const int a_off = (wg * 64 + (warp & 3) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kRW +
                    (lane >> 4) * 4;
  Loader<float, kVec, kThreads, kSlots, kNormSlots> ld(q, x, qn, xn, nq, n, d, tiles_m, ktiles);

  float acc[64], p[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = p[i] = 0.f;

  // Prologue: slices 0..kSlots-1 in flight, slice 0's base rows split.
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i < steps) ld.next(smem, norms_s);
    cp_async_commit();  // an empty group keeps the count uniform
  }
  cp_async_wait<kSlots - 1>();
  __syncthreads();
  split_base(smem, split);
  __syncthreads();

  int tile = blockIdx.x, k = 0, slot = 0, nslot = 0;
  for (int s = 0; s < steps; ++s) {
    const uint32_t* raw = smem + slot * Slice<float>::kWords;
    const uint32_t* sp = split + (s & 1) * kSplitWords;
    uint32_t ab[4][4], asl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, raw + a_off + kk * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[kk][e], asl[kk][e]);
    }
    wgmma_fence();
    // The slice's small terms first, while the partial is small, then its
    // big.big terms: fewer sums truncated at the partial's full magnitude.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_tf32(p, asl[kk], core_desc(sp + kk * 1024), kk > 0);
      wgmma_tf32(p, ab[kk], core_desc(sp + kBN * kBK + kk * 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_tf32(p, ab[kk], core_desc(sp + kk * 1024), 1);
    wgmma_commit();
    if (++slot == kSlots) slot = 0;
    if (s + 1 < steps) {  // the next slice: land, split its base rows into the other buffer
      cp_async_wait<kSlots - 2>();
      __syncthreads();  // also: every warp has read this slice's query rows
      split_base(smem + slot * Slice<float>::kWords, split + ((s + 1) & 1) * kSplitWords);
      if (s + kSlots < steps) ld.next(smem, norms_s);
      cp_async_commit();
      __syncthreads();
    }
    wgmma_wait();
    hold(p);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hold(ab[kk]);
      hold(asl[kk]);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += p[i];
    if (++k == ktiles) {
      const int row0 = (tile % tiles_m) * kBM, col0 = (tile / tiles_m) * kBN;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        store_frag(acc + 4 * j, norms_s[nslot], out, nq, n, row0, col0,
                   wg * 64 + (warp & 3) * 16 + g, j * 8 + 2 * t, t);
      if (++nslot == kNormSlots) nslot = 0;
      k = 0;
      tile += gridDim.x;
    }
  }
  cp_async_wait<0>();
}
}  // namespace f32

// ---------------------------------------------------------------- bfloat16

namespace bf16 {
using T = __nv_bfloat16;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N, 64 x 32 each
constexpr int kSlots = 3;
constexpr int kNormSlots = kSlots;
constexpr int RW = Slice<T>::kRowWords;
constexpr size_t kSmem = (size_t)kSlots * Slice<T>::kWords * 4;

// c += A (16x16 bf16, row) * B (16x8 bf16, col), f32 accumulation.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
kernel(const T* __restrict__ q, const T* __restrict__ x, const float* __restrict__ qn,
       const float* __restrict__ xn, float* __restrict__ out, int nq, int n, int d, int tiles_m,
       int tiles) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ float norms_s[kNormSlots][kBM + kBN];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1, g = lane >> 2, t = lane & 3;
  const int ktiles = d > kBK ? (d + kBK - 1) / kBK : 1;
  const int mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = mine * ktiles;
  // A: matrices (rows 0-7 | 8-15) x (words 0-3 | 4-7) of an m-tile;
  // B: matrices (n-tile j | j + 1) x (words 0-3 | 4-7).
  const int a_off = (wm * 64 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RW + (lane >> 4) * 4;
  const int b_off = (kBM + wn * 32 + (lane >> 4) * 8 + (lane & 7)) * RW + ((lane >> 3) & 1) * 4;
  Loader<T, kVec, kThreads, kSlots, kNormSlots> ld(q, x, qn, xn, nq, n, d, tiles_m, ktiles);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kSlots - 1; ++s) {
    if (s < steps) ld.next(smem, norms_s);
    cp_async_commit();
  }
  int tile = blockIdx.x, k = 0, slot = 0, nslot = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kSlots - 2>();
    __syncthreads();  // step s has landed; the slot of step s - 1 is free
    if (s + kSlots - 1 < steps) ld.next(smem, norms_s);
    cp_async_commit();
    const uint32_t* st = smem + slot * Slice<T>::kWords;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t r[4];
        ldsm_x4(r, st + b_off + j * 8 * RW + kk * 8);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t a[4];
        ldsm_x4(a, st + a_off + i * 16 * RW + kk * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j]);
      }
    }
    if (++slot == kSlots) slot = 0;
    if (++k == ktiles) {
      const int row0 = (tile % tiles_m) * kBM, col0 = (tile / tiles_m) * kBN;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          store_frag(acc[i][j], norms_s[nslot], out, nq, n, row0, col0, wm * 64 + i * 16 + g,
                     wn * 32 + j * 8 + 2 * t, t);
      if (++nslot == kNormSlots) nslot = 0;
      k = 0;
      tile += gridDim.x;
    }
  }
  cp_async_wait<0>();
}
}  // namespace bf16

// Norms first, then the persistent kernel over as many blocks as the card
// holds at once (the occupancy calculator's count, cached per device).
template <typename T, typename Kernel>
cudaError_t launch(Kernel kern, int threads, size_t smem, std::atomic<int>* cache, int nq, int n,
                   int d, const void* q, const void* x, float* norms, float* out,
                   cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* xt = static_cast<const T*>(x);
  norms_kernel<T><<<(nq + 7) / 8, 256, 0, s>>>(qt, nq, d, norms);
  norms_kernel<T><<<(n + 7) / 8, 256, 0, s>>>(xt, n, d, norms + nq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  int dev = 0, slots = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || (slots = cache[dev].load()) == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    slots = (per_sm < 1 ? 1 : per_sm) * sms;
    if (dev < kMaxDevices) cache[dev].store(slots);
  }
  const int tiles_m = (nq + kBM - 1) / kBM;
  const long long tiles = static_cast<long long>(tiles_m) * ((n + kBN - 1) / kBN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < slots ? tiles : slots);
  kern<<<grid, threads, smem, s>>>(qt, xt, norms, norms + nq, out, nq, n, d, tiles_m,
                                   static_cast<int>(tiles));
  return cudaGetLastError();
}

template <typename T>
bool aligned(int d, const void* q, const void* x) {
  return (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(q) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

static_assert(f32::kSmem + f32::kNormSlots * (kBM + kBN) * 4 <= 232448,
              "a float32 block's shared memory on sm_90");
static_assert((bf16::kSmem + bf16::kNormSlots * (kBM + kBN) * 4 + 1024) * 2 <= 233472,
              "two bfloat16 blocks' shared memory on an sm_90 SM");
// Resident blocks per device of each kernel: [aligned][device].
std::atomic<int> f32_slots[2][kMaxDevices];
std::atomic<int> bf16_slots[2][kMaxDevices];

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype 0 = float32, 1 = bfloat16
// (both operands); q (nq, d) and x (n, d) row-major, out (nq, n) float32,
// norms a float32 scratch of nq + n entries (the squared norms of q's rows,
// then x's).  Launches on `stream`, allocates nothing, does not synchronise,
// and returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int repro_l2_distance(int dtype, int nq, int n, int d, const void* q,
                                 const void* x, void* norms, void* out, void* stream) {
  if (nq <= 0 || n <= 0) return 0;
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* nr = static_cast<float*>(norms);
  auto* o = static_cast<float*>(out);
  cudaError_t e;
  if (dtype == 0) {
    e = aligned<float>(d, q, x)
            ? launch<float>(f32::kernel<true>, f32::kThreads, f32::kSmem, f32_slots[1], nq, n,
                            d, q, x, nr, o, s)
            : launch<float>(f32::kernel<false>, f32::kThreads, f32::kSmem, f32_slots[0], nq, n,
                            d, q, x, nr, o, s);
  } else if (dtype == 1) {
    e = aligned<__nv_bfloat16>(d, q, x)
            ? launch<__nv_bfloat16>(bf16::kernel<true>, bf16::kThreads, bf16::kSmem,
                                    bf16_slots[1], nq, n, d, q, x, nr, o, s)
            : launch<__nv_bfloat16>(bf16::kernel<false>, bf16::kThreads, bf16::kSmem,
                                    bf16_slots[0], nq, n, d, q, x, nr, o, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
