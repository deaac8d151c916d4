// Flash-decoding GQA attention for NVIDIA Hopper (sm_90a) on the tensor
// cores: one new token's queries q (B, Hq, d) float32 against a KV cache
// k, v (B, S, Hkv, d) in bfloat16, masked at kv_len (B,) -> (B, Hq, d)
// float32, with Hq = G * Hkv and query head kvh * G + i reading KV head kvh.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (Pallas, `_decode_attn_kernel`: grid (B, Hq, S/512), the online softmax
// (m, l, acc) carried across the sequential S axis in VMEM scratch).  That
// grid re-reads a KV head's cache once for each of its G query heads and
// relies on grid steps running in order; here blocks run in no order.
// Semantics are those of repro_torch/kernels/ref.py::decode_attention_gqa_ref:
//   * softmax(q.k / sqrt(d)) over positions below kv_len, as
//     exp(logit - m) / max(l, 1e-30) with m = 0 where nothing is valid, so
//     kv_len = 0 gives zeros (the TPU kernel's guard);
//   * kv_len is clamped to [0, S].  The TPU kernel pads S to a multiple of
//     512 with zero keys and masks `pos < kv_len`, so for kv_len > S it
//     counts padded zero keys as valid; the port follows the oracle, which
//     masks arange(S) only.
//
// What bounds it on this card: bytes.  It must read K and V up to kv_len
// once: 2 * Hkv * d * 2 bytes per token in bfloat16 (2 KiB at Hkv = 4,
// d = 128), 1 GiB at B = 16, S = 32768 (about 0.32 ms at 3.35 TB/s).  The
// arithmetic, 4 * G * d flops per cached token, is far below the tensor
// cores' rate, but on the CUDA cores in float32 it was not: the first port
// (float32 FMAs, three block-wide barriers per 32-position tile) ran at
// 2.9x the bound, limited by instruction throughput.
//
// What the design does about it:
//   * one block of 4 warps per (batch row, KV head, S split); the split
//     count (repro_decode_attention_splits) fills the card's resident
//     block slots, as the occupancy calculator gives them for this block,
//     in one wave, and every K/V row read serves all G query heads;
//   * QK^T and PV run on the tensor cores, `mma.sync.m16n8k16` in bfloat16
//     with float32 accumulation.  The G query heads are the 16 rows of the
//     A operand (padded with zero rows; `wgmma` would need 64).  q is
//     float32, so it is split once per block into q_hi + q_lo (both bf16)
//     and QK^T is two products; K is exact in bf16.  The logits'
//     accumulator fragment is reused in registers as PV's A operand (the
//     FlashAttention-2 layout), P split the same way into p_hi + p_lo; V
//     comes through `ldmatrix.trans`.  The split keeps the products within
//     about 2^-16 relative, where rounding q or P to bf16 alone would not
//     hold 3e-4 at logits near 30;
//   * no block-wide barrier per tile: each warp owns every 4th 16-position
//     tile of the block's split, with its own (m, l, acc) in registers and
//     its own 3-stage ring in shared memory filled by 16-byte `cp.async`
//     (rows past kv_len are zero-filled, never read); rows are padded by
//     16 bytes so `ldmatrix` hits distinct banks;
//   * the 4 warps combine in shared memory once at the end, in warp order,
//     and each block writes its split's (m, l, acc); a second launch
//     combines the splits in a fixed order, so the result is deterministic;
//   * any head dim d % 8 == 0 up to 256: shared memory holds d rounded up
//     to 16 columns (the mma's k depth), the extra 8 zero-filled in q, K
//     and V, so they add nothing to a logit or an output column;
//   * IEEE expf and float32 division (the library is built without
//     --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 16;          // positions per tile
constexpr int kStages = 3;      // ring depth per warp
constexpr int kRows = 16;       // A-operand rows: query heads, zero padded
constexpr int kMaxSplits = 1024;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxDevices = 64;
constexpr int kPad = 8;         // bf16 elements of padding per smem row
constexpr unsigned kFull = 0xffffffffu;
using KV = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte copy; `bytes` = 0 zero-fills the destination without reading.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += A (16x16 bf16, row) * B (16x8 bf16, col), float32 accumulation.
__device__ __forceinline__ void mma(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> the bf16 pair (hi) and the bf16 pair of what hi left out (lo).
__device__ __forceinline__ void split2(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

template <int D>
__host__ __device__ constexpr int row_elems() { return D + kPad; }
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (static_cast<size_t>(kWarps) * kStages * 2 * kT + 2 * kRows) * row_elems<D>() *
         sizeof(KV);
}

// Grid (splits, Hkv, B).  Writes the split's partial (m, l, acc) of each of
// the G query heads of KV head blockIdx.y.  D is the head dim rounded up
// to 16 (shared memory's columns); d, D - 8 < d <= D, is the tensors'.
template <int D>
__global__ void __launch_bounds__(kThreads)
decode_attn_split(const float* __restrict__ q, const KV* __restrict__ k,
                  const KV* __restrict__ v, const int32_t* __restrict__ kv_len,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, int s_len, int hkv, int g, int d,
                  int tiles_per_split, float scale) {
  constexpr int RE = row_elems<D>();
  constexpr int NB = D / 8;           // 8-wide column blocks of the output
  constexpr int KS = D / 16;          // 16-deep steps of QK^T
  constexpr int CHUNKS = D / 8;       // 16-byte chunks per K/V row
  extern __shared__ float4 smem4[];
  KV* q_hi = reinterpret_cast<KV*>(smem4);                    // [16][RE]
  KV* q_lo = q_hi + kRows * RE;                               // [16][RE]
  KV* rings = q_lo + kRows * RE;                              // [warp][stage][K|V][kT][RE]
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const int hq = hkv * g;

  // q of the group as hi + lo bf16 rows; rows >= g and columns >= d are
  // zero.
  const float* qb = q + ((size_t)b * hq + kvh * g) * d;
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int h = e / D, c = e - h * D;
    const float x = h < g && c < d ? qb[h * d + c] : 0.f;
    const KV hi = __float2bfloat16_rn(x);
    q_hi[h * RE + c] = hi;
    q_lo[h * RE + c] = __float2bfloat16_rn(x - __bfloat162float(hi));
  }

  int len = kv_len[b];
  len = len < 0 ? 0 : (len > s_len ? s_len : len);
  const int n_tiles = (len + kT - 1) / kT;
  const int t0 = sp * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  // This warp's tiles: t0 + warp, t0 + warp + kWarps, ...
  const int mine = t0 + warp < t1 ? (t1 - (t0 + warp) + kWarps - 1) / kWarps : 0;
  KV* ring = rings + (size_t)warp * kStages * 2 * kT * RE;

  auto load_tile = [&](int i) {
    if (i < mine) {
      const int s0 = (t0 + warp + i * kWarps) * kT;
      KV* ks = ring + (i % kStages) * 2 * kT * RE;
      KV* vs = ks + kT * RE;
      for (int e = lane; e < kT * CHUNKS; e += 32) {
        const int r = e / CHUNKS, c = (e - r * CHUNKS) * 8;
        const bool ok = s0 + r < len && c < d;
        const size_t off =
            (((size_t)b * s_len + s0 + (ok ? r : 0)) * hkv + kvh) * d + (ok ? c : 0);
        cp_async16(ks + r * RE + c, k + off, ok ? 16 : 0);
        cp_async16(vs + r * RE + c, v + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();                // an empty group keeps the count uniform
  };

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // rows grp, grp + 8
  float l[2] = {0.f, 0.f};                        // this thread's columns only
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_tile(i);
  __syncthreads();                    // q_hi, q_lo ready

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kStages - 2>();
    __syncwarp();                     // tile i visible to every lane
    load_tile(i + kStages - 1);       // into the stage tile i - 1 used
    const KV* ks = ring + (i % kStages) * 2 * kT * RE;
    const KV* vs = ks + kT * RE;
    const int s0 = (t0 + warp + i * kWarps) * kT;

    // Logits S (16 heads x 16 positions) = q_hi K^T + q_lo K^T, the two
    // products in separate accumulators (four independent mma chains).
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float s_lo[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks16 = 0; ks16 < KS; ++ks16) {
      const int c0 = ks16 * 16;
      unsigned ah[4], al[4], kb[4];
      const int qoff = (lane & 15) * RE + c0 + (lane >> 4) * 8;
      ldmatrix_x4(ah, q_hi + qoff);
      ldmatrix_x4(al, q_lo + qoff);
      ldmatrix_x4(kb, ks + ((lane & 7) + ((lane >> 4) << 3)) * RE + c0 +
                          ((lane >> 3) & 1) * 8);
      mma(s[0], ah, kb[0], kb[1]);
      mma(s_lo[0], al, kb[0], kb[1]);
      mma(s[1], ah, kb[2], kb[3]);
      mma(s_lo[1], al, kb[2], kb[3]);
    }

    // Online softmax on rows grp (s[.][0..1]) and grp + 8 (s[.][2..3]).
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pos = s0 + n * 8 + 2 * tig + (j & 1);
        const float x = pos < len ? (s[n][j] + s_lo[n][j]) * scale : -CUDART_INF_F;
        s[n][j] = x;
        mx[j >> 1] = fmaxf(mx[j >> 1], x);
      }
    float corr[2], safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      safe[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      corr[r] = m[r] == -CUDART_INF_F ? 0.f : expf(m[r] - safe[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[n][j] - safe[j >> 1]);
        s[n][j] = p;
        l[j >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // P as PV's A operand (16 heads x 16 positions), hi and lo halves.
    unsigned ph[4], pl[4];
    split2(s[0][0], s[0][1], ph[0], pl[0]);
    split2(s[0][2], s[0][3], ph[1], pl[1]);
    split2(s[1][0], s[1][1], ph[2], pl[2]);
    split2(s[1][2], s[1][3], ph[3], pl[3]);

    // acc (16 heads x D) += (p_hi + p_lo) V.
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      unsigned vb[4];
      ldmatrix_x4_trans(vb, vs + (lane & 15) * RE + n * 8 + (lane >> 4) * 8);
      mma(acc[n], ph, vb[0], vb[1]);
      mma(acc[n], pl, vb[0], vb[1]);
      mma(acc[n + 1], ph, vb[2], vb[3]);
      mma(acc[n + 1], pl, vb[2], vb[3]);
    }
    __syncwarp();                     // every lane done with this stage
  }
  cp_async_wait<0>();
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  // Combine the 4 warps in warp order, in the rings' space.
  __syncthreads();
  float* w_acc = reinterpret_cast<float*>(rings);             // [warp][16][D]
  float* w_m = w_acc + kWarps * kRows * D;                    // [warp][16]
  float* w_l = w_m + kWarps * kRows;                          // [warp][16]
  float* wa = w_acc + warp * kRows * D;
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int c = n * 8 + 2 * tig;
    wa[grp * D + c] = acc[n][0];
    wa[grp * D + c + 1] = acc[n][1];
    wa[(grp + 8) * D + c] = acc[n][2];
    wa[(grp + 8) * D + c + 1] = acc[n][3];
  }
  if (tig == 0) {
    w_m[warp * kRows + grp] = m[0];
    w_m[warp * kRows + grp + 8] = m[1];
    w_l[warp * kRows + grp] = l[0];
    w_l[warp * kRows + grp + 8] = l[1];
  }
  __syncthreads();
  const size_t base = (size_t)b * hq + kvh * g;
  for (int e = tid; e < g * d; e += kThreads) {
    const int h = e / d, c = e - h * d;
    float big = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, w_m[w * kRows + h]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = w_m[w * kRows + h];
      const float wt = mw == -CUDART_INF_F ? 0.f : expf(mw - big);
      a += wt * w_acc[(w * kRows + h) * D + c];
      lsum += wt * w_l[w * kRows + h];
    }
    part_acc[((base + h) * splits + sp) * d + c] = a;
    if (c == 0) {
      part_m[(base + h) * splits + sp] = big;
      part_l[(base + h) * splits + sp] = lsum;
    }
  }
}

// Grid (B * Hq).  out = sum_s acc_s exp(m_s - M) / max(sum_s l_s exp(m_s - M),
// 1e-30), M = max_s m_s; zeros where every split is empty (M = -inf).
__global__ void __launch_bounds__(kThreads)
decode_attn_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, float* __restrict__ out,
                    int splits, int d) {
  __shared__ float w_s[kMaxSplits];
  __shared__ float red[kWarps];
  __shared__ float big_m, denom;
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pm = part_m + (size_t)row * splits;
  const float* pl = part_l + (size_t)row * splits;

  float mx = -CUDART_INF_F;
  for (int s = tid; s < splits; s += kThreads) mx = fmaxf(mx, pm[s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
    big_m = m;
  }
  __syncthreads();
  const float m = big_m;
  float* o = out + (size_t)row * d;
  if (m == -CUDART_INF_F) {
    for (int c = tid; c < d; c += kThreads) o[c] = 0.f;
    return;
  }
  float lsum = 0.f;
  for (int s = tid; s < splits; s += kThreads) {
    const float w = pm[s] == -CUDART_INF_F ? 0.f : expf(pm[s] - m);
    w_s[s] = w;
    lsum += w * pl[s];
  }
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1) lsum += __shfl_xor_sync(kFull, lsum, o2);
  __syncthreads();                    // every block-wide read of red is done
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  if (tid == 0) {
    float l = 0.f;
    for (int w = 0; w < kWarps; ++w) l += red[w];
    denom = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* pa = part_acc + (size_t)row * splits * d;
  for (int c = tid; c < d; c += kThreads) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a = fmaf(w_s[s], pa[(size_t)s * d + c], a);
    o[c] = a / denom;
  }
}

// Split blocks of head dim D that the current card holds at once, from the
// occupancy calculator (cached per device and D).
template <int D>
cudaError_t resident_blocks(int* out) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (*out = cache[dev].load()) > 0) return cudaSuccess;
  e = cudaFuncSetAttribute(decode_attn_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes<D>()));
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_attn_split<D>, kThreads,
                                                    smem_bytes<D>());
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *out = (per_sm < 1 ? 1 : per_sm) * sms;
  if (dev < kMaxDevices) cache[dev].store(*out);
  return cudaSuccess;
}

template <int D>
cudaError_t launch(int b, int hq, int hkv, int s_len, int d, int splits, const float* q,
                   const KV* k, const KV* v, const int32_t* kv_len, float* part_m,
                   float* part_l, float* part_acc, float* out, cudaStream_t stream) {
  static_assert(kWarps * kRows * D * 4 + 2 * kWarps * kRows * 4 <=
                    kWarps * kStages * 2 * kT * row_elems<D>() * 2,
                "the warps' combine must fit in their rings");
  static_assert(smem_bytes<D>() <= 232448, "a block's shared memory on sm_90");
  const int g = hq / hkv;
  const int tiles = (s_len + kT - 1) / kT;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      decode_attn_split<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  decode_attn_split<D><<<dim3(splits, hkv, b), kThreads, smem, stream>>>(
      q, k, v, kv_len, part_m, part_l, part_acc, s_len, hkv, g, d, tiles_per_split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_attn_combine<<<b * hq, kThreads, 0, stream>>>(part_m, part_l, part_acc, out,
                                                       splits, d);
  return cudaGetLastError();
}

bool valid_dims(int hq, int hkv, int d) {
  return hkv > 0 && hq % hkv == 0 && hq / hkv <= kRows && d >= 8 && d <= kMaxHeadDim &&
         d % 8 == 0;
}

}  // namespace

// One case per head dim rounded up to 16: 16, 32, ..., 256.
#define REPRO_DA_DIMS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// The split count for (b, hkv, s, d) on the current card: as many splits
// per (batch row, KV head) as fill its resident block slots in one wave, at
// least one tile each, at most 1024.  Returns it (>= 1), or minus a CUDA
// error code.
extern "C" int repro_decode_attention_splits(int b, int hkv, int s, int d) {
  if (b <= 0 || hkv <= 0 || s <= 0 || !valid_dims(hkv, hkv, d))
    return -static_cast<int>(cudaErrorInvalidValue);
  int slots = 0;
  cudaError_t e = cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
#define REPRO_DA_CASE(N) \
  case N: e = resident_blocks<16 * N>(&slots); break;
    REPRO_DA_DIMS(REPRO_DA_CASE)
#undef REPRO_DA_CASE
  }
  if (e != cudaSuccess) return -static_cast<int>(e);
  const int tiles = (s + kT - 1) / kT;
  int want = slots / (b * hkv);
  if (want > tiles) want = tiles;
  if (want > kMaxSplits) want = kMaxSplits;
  return want < 1 ? 1 : want;
}

// Plain C entry point, loaded with ctypes.  q (b, hq, d) float32; k, v
// (b, s, hkv, d) bfloat16, 16-byte aligned; kv_len (b,) int32; part_m,
// part_l (b, hq, splits) and part_acc (b, hq, splits, d) float32 scratch;
// out (b, hq, d) float32.  Needs hq % hkv == 0, hq / hkv <= 16, d % 8 == 0
// with 8 <= d <= 256, 1 <= splits <= 1024.  Launches on `stream`,
// allocates nothing, does not synchronise, and returns cudaGetLastError() so
// the caller can raise on a refused launch.
extern "C" int repro_decode_attention(int b, int hq, int hkv, int s, int d, int splits,
                                      const void* q, const void* k,
                                      const void* v, const void* kv_len, void* part_m,
                                      void* part_l, void* part_acc, void* out,
                                      void* stream) {
  if (b <= 0 || hq <= 0) return 0;
  if (!valid_dims(hq, hkv, d) || s <= 0 || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const float*>(q);
  const auto* kk = static_cast<const KV*>(k);
  const auto* vv = static_cast<const KV*>(v);
  const auto* lens = static_cast<const int32_t*>(kv_len);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  auto* o = static_cast<float*>(out);
  cudaError_t e = cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
#define REPRO_DA_CASE(N) \
  case N: e = launch<16 * N>(b, hq, hkv, s, d, splits, qq, kk, vv, lens, pm, pl, pa, o, st); break;
    REPRO_DA_DIMS(REPRO_DA_CASE)
#undef REPRO_DA_CASE
  }
  return static_cast<int>(e);
}
