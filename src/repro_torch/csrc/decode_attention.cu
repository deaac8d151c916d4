// Flash-decoding GQA attention for NVIDIA Hopper (sm_90a): one new token's
// queries q (B, Hq, d) float32 against a KV cache k, v (B, S, Hkv, d) in
// bfloat16, masked at kv_len (B,) -> (B, Hq, d) float32, with
// Hq = G * Hkv and query head kvh * G + i reading KV head kvh.
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
// d = 128), 1 GiB at B = 16, S = 32768 (about 0.32 ms at 3.35 TB/s); q and
// the output are small.  The arithmetic, 4 * G * d flops per cached token,
// runs in float32 on the CUDA cores, well under their rate.
//
// What the design does about it:
//   * one block of 128 threads per (batch row, KV head, S split): the G
//     query vectors are loaded once and every K/V row read serves all G
//     heads, so the cache is read once, not G times;
//   * the split count is chosen by the caller so that B * Hkv * splits
//     fills the card (at B * Hkv = 4, as at long_500k, a head's cache is cut
//     into over a hundred splits);
//   * tiles of 32 positions are copied to shared memory with 16-byte
//     cp.async, double buffered, so the next tile's loads are in flight
//     while the current one is used; rows are padded by 16 bytes so the
//     per-key 16-byte reads hit distinct banks;
//   * tiles at or past kv_len are never read;
//   * warp w computes the logits of heads w, w + 4, ... (lane j = key j),
//     its max and sum by shuffles, and the online-softmax update
//     (m, l, correction) in float32; then thread t accumulates dims t and
//     t + 128 of every head's output from the p row and V in shared memory;
//   * each block writes its split's (m, l, acc); a second launch combines
//     the splits in a fixed order, so the result is deterministic;
//   * IEEE expf and float32 division (the library is built without
//     --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;          // positions per tile (one per lane)
constexpr int kMaxG = 16;       // query heads per KV head
constexpr int kMaxD = 256;      // head dim: at most two dims per thread
constexpr int kMaxSplits = 1024;
constexpr unsigned kFull = 0xffffffffu;
using KV = __nv_bfloat16;       // the cache's element type

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}


// 8 consecutive elements of a shared-memory row as floats (16-byte loads).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Grid (splits, Hkv, B).  Writes the split's partial (m, l, acc) of each of
// the G query heads of KV head blockIdx.y.
__global__ void __launch_bounds__(kThreads)
decode_attn_split(const float* __restrict__ q, const KV* __restrict__ k,
                  const KV* __restrict__ v, const int32_t* __restrict__ kv_len,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, int s_len, int hkv, int g, int d,
                  int tiles_per_split, float scale) {
  extern __shared__ float4 smem4[];
  __shared__ float m_s[kMaxG], l_s[kMaxG], c_s[kMaxG];
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * g;

  const int row_elems = d + 16 / static_cast<int>(sizeof(KV));  // padded row
  KV* tiles = reinterpret_cast<KV*>(smem4);     // [stage][K|V][kT][row_elems]
  const int tile_elems = kT * row_elems;
  float* q_s = reinterpret_cast<float*>(tiles + 4 * tile_elems);  // [g][d]
  float* p_s = q_s + g * d;                                       // [g][kT]

  for (int e = tid; e < g * d; e += kThreads)
    q_s[e] = q[((size_t)b * hq + kvh * g) * d + e];
  if (tid < kMaxG) {
    m_s[tid] = -CUDART_INF_F;
    l_s[tid] = 0.f;
  }

  int len = kv_len[b];
  len = len < 0 ? 0 : (len > s_len ? s_len : len);
  const int n_tiles = (len + kT - 1) / kT;
  const int t0 = sp * tiles_per_split;
  int t1 = t0 + tiles_per_split;
  if (t1 > n_tiles) t1 = n_tiles;

  const int chunks_per_row = d * static_cast<int>(sizeof(KV)) / 16;
  auto load_tile = [&](int t, int stage) {
    const int s0 = t * kT;
    const int nv = len - s0 < kT ? len - s0 : kT;
    KV* ks = tiles + (2 * stage) * tile_elems;
    KV* vs = ks + tile_elems;
    for (int e = tid; e < nv * chunks_per_row; e += kThreads) {
      const int r = e / chunks_per_row, c = e - r * chunks_per_row;
      const size_t off = (((size_t)b * s_len + s0 + r) * hkv + kvh) * d;
      const int ce = c * 16 / static_cast<int>(sizeof(KV));
      cp_async16(ks + r * row_elems + ce, k + off + ce);
      cp_async16(vs + r * row_elems + ce, v + off + ce);
    }
    cp_async_commit();
  };

  float acc[kMaxG][2];
#pragma unroll
  for (int h = 0; h < kMaxG; ++h) acc[h][0] = acc[h][1] = 0.f;

  if (t0 < t1) load_tile(t0, 0);
  __syncthreads();                    // q_s, m_s, l_s ready
  for (int t = t0; t < t1; ++t) {
    const int stage = (t - t0) & 1;
    if (t + 1 < t1) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                  // tile t visible to every thread
    const int nv = len - t * kT < kT ? len - t * kT : kT;
    const KV* ks = tiles + (2 * stage) * tile_elems;
    const KV* vs = ks + tile_elems;

    // Logits and the online-softmax update: warp w owns heads w, w + 4, ...
    // and lane j position j of the tile; a K row is read once per warp.
    float dot[kMaxG / kWarps];
#pragma unroll
    for (int i = 0; i < kMaxG / kWarps; ++i) dot[i] = 0.f;
    if (lane < nv) {
      const KV* kr = ks + lane * row_elems;
      for (int c = 0; c < d; c += 8) {
        float kf[8];
        load8(kr + c, kf);
#pragma unroll
        for (int i = 0; i < kMaxG / kWarps; ++i) {
          const int h = warp + i * kWarps;
          if (h < g) {
            const float4 qa = *reinterpret_cast<const float4*>(q_s + h * d + c);
            const float4 qb = *reinterpret_cast<const float4*>(q_s + h * d + c + 4);
            float a = dot[i];
            a = fmaf(qa.x, kf[0], a);
            a = fmaf(qa.y, kf[1], a);
            a = fmaf(qa.z, kf[2], a);
            a = fmaf(qa.w, kf[3], a);
            a = fmaf(qb.x, kf[4], a);
            a = fmaf(qb.y, kf[5], a);
            a = fmaf(qb.z, kf[6], a);
            a = fmaf(qb.w, kf[7], a);
            dot[i] = a;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxG / kWarps; ++i) {
      const int h = warp + i * kWarps;
      if (h < g) {                    // the same for every lane of the warp
        const float x = lane < nv ? dot[i] * scale : -CUDART_INF_F;
        const float m_prev = m_s[h];
        const float m_new = fmaxf(m_prev, warp_max(x));
        const float safe = m_new == -CUDART_INF_F ? 0.f : m_new;
        const float p = expf(x - safe);
        const float sum = warp_sum(p);
        p_s[h * kT + lane] = p;
        if (lane == 0) {
          const float corr = m_prev == -CUDART_INF_F ? 0.f : expf(m_prev - safe);
          l_s[h] = l_s[h] * corr + sum;
          m_s[h] = m_new;
          c_s[h] = corr;
        }
      }
    }
    __syncthreads();                  // p_s and c_s ready

    // acc[h][dim] = acc * corr + sum_j p[h][j] v[j][dim], j ascending; four
    // positions' p of a head in one 16-byte load.
#pragma unroll
    for (int part = 0; part < 2; ++part) {
      const int c = tid + part * kThreads;
      if (c < d) {
        float a[kMaxG];
#pragma unroll
        for (int h = 0; h < kMaxG; ++h) a[h] = h < g ? acc[h][part] * c_s[h] : 0.f;
        int j = 0;
        for (; j + 4 <= nv; j += 4) {
          float vf[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) vf[u] = __bfloat162float(vs[(j + u) * row_elems + c]);
#pragma unroll
          for (int h = 0; h < kMaxG; ++h) {
            if (h < g) {
              const float4 p4 = *reinterpret_cast<const float4*>(p_s + h * kT + j);
              a[h] = fmaf(p4.x, vf[0], a[h]);
              a[h] = fmaf(p4.y, vf[1], a[h]);
              a[h] = fmaf(p4.z, vf[2], a[h]);
              a[h] = fmaf(p4.w, vf[3], a[h]);
            }
          }
        }
        for (; j < nv; ++j) {
          const float vf = __bfloat162float(vs[j * row_elems + c]);
#pragma unroll
          for (int h = 0; h < kMaxG; ++h)
            if (h < g) a[h] = fmaf(p_s[h * kT + j], vf, a[h]);
        }
#pragma unroll
        for (int h = 0; h < kMaxG; ++h) acc[h][part] = a[h];
      }
    }
    __syncthreads();                  // stage and p_s free for reuse
  }

  const size_t base = (size_t)b * hq + kvh * g;
  if (tid < g) {
    part_m[(base + tid) * splits + sp] = m_s[tid];
    part_l[(base + tid) * splits + sp] = l_s[tid];
  }
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const int c = tid + part * kThreads;
    if (c < d) {
#pragma unroll
      for (int h = 0; h < kMaxG; ++h)
        if (h < g) part_acc[((base + h) * splits + sp) * d + c] = acc[h][part];
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
  mx = warp_max(mx);
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
  lsum = warp_sum(lsum);
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

cudaError_t launch(int b, int hq, int hkv, int s_len, int d, int splits,
                   const float* q, const void* k, const void* v, const int32_t* kv_len,
                   float* part_m, float* part_l, float* part_acc, float* out,
                   cudaStream_t stream) {
  const int g = hq / hkv;
  const int tiles = (s_len + kT - 1) / kT;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  const int row_elems = d + 16 / static_cast<int>(sizeof(KV));
  const size_t smem = 4 * static_cast<size_t>(kT) * row_elems * sizeof(KV) +
                      static_cast<size_t>(g) * d * sizeof(float) +
                      static_cast<size_t>(g) * kT * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_attn_split, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  decode_attn_split<<<dim3(splits, hkv, b), kThreads, smem, stream>>>(
      q, static_cast<const KV*>(k), static_cast<const KV*>(v), kv_len, part_m,
      part_l, part_acc, s_len, hkv, g, d, tiles_per_split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_attn_combine<<<b * hq, kThreads, 0, stream>>>(part_m, part_l, part_acc, out,
                                                       splits, d);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes.  q (b, hq, d) float32; k, v
// (b, s, hkv, d) bfloat16, 16-byte aligned;
// kv_len (b,) int32; part_m, part_l (b, hq, splits) and part_acc
// (b, hq, splits, d) float32 scratch; out (b, hq, d) float32.  Needs
// hq % hkv == 0, hq / hkv <= 16, d % 8 == 0, d <= 256, 1 <= splits <= 1024.
// Launches on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int repro_decode_attention(int b, int hq, int hkv, int s, int d, int splits,
                                      const void* q, const void* k,
                                      const void* v, const void* kv_len, void* part_m,
                                      void* part_l, void* part_acc, void* out,
                                      void* stream) {
  if (b <= 0 || hq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxG || d % 8 != 0 || d <= 0 ||
      d > kMaxD || s <= 0 || splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const float*>(q);
  const auto* lens = static_cast<const int32_t*>(kv_len);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  auto* o = static_cast<float*>(out);
  return static_cast<int>(
      launch(b, hq, hkv, s, d, splits, qq, k, v, lens, pm, pl, pa, o, st));
}
