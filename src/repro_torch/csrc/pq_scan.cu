// Bulk ADC scan for NVIDIA Hopper (sm_90a): (Q, M, K) float32 LUTs x (N, M)
// uint8 codes -> (Q, N) float32, out[q, n] = sum_m LUT[q, m, code[n, m]],
// summed in m order (any M, any K <= 256, codes < K).
//
// Replaces the TPU kernel repro/kernels/pq_scan.py::pq_scan (Pallas,
// `_pq_scan_kernel`: per 128-row code tile a one-hot (128, M*K) matrix built
// from iota compares, multiplied by the flat LUT on the MXU).  The one-hot
// product is a TPU workaround for serial gathers; Hopper gathers from shared
// memory directly, so this kernel does the M byte-indexed lookups.
// Semantics are those of repro_torch/kernels/ref.py::pq_scan_ref, which adds
// in the same m order: the two agree bit for bit.
//
// What bounds it on this card.  Bytes: it must read the codes (N*M bytes)
// and the LUTs and write Q*N floats; at Q = 256, N = 1M, M = 16 that is
// 16 MB + 4 MB + 1.07 GB, 0.3117 ms at 3.35 TB/s.  Shared memory: the Q*N*M
// lookups (4.3e9 there) each read a 4-byte LUT entry; an SM's shared memory
// serves 128 bytes a cycle, so even without a bank conflict they take
// Q*N*M / (32 * 132) = 1.02M cycles an SM, about 0.52 ms at 1.98 GHz.  That
// floor, not the bytes, bounds any design that reads each entry from shared
// memory once per (query, row, m); chip_smoke.py measures it on the card
// (all-zero codes, `[phase2] pq_scan` line).
//
// What the design does about it (M a multiple of 16, the main path):
//   * a block takes kQB = 4 queries and stages the LUTs of 16 m at a time
//     as float4 entries (the 4 queries) at lut_s[c * 16 + j], code c of
//     m = m0 + j: one 16-byte load serves 4 queries, and entry (c, j) lies
//     in bank group j % 8 whatever c is;
//   * a 16-byte shared load is served a quarter-warp (8 lanes) at a time.
//     Lanes that look up the same m at random codes hit random bank groups
//     (2.5 addresses on the fullest of 8 on average: 10 wavefronts a warp
//     load where 4 would do).  So the lanes of a quarter-warp are skewed in
//     time: lane s = lane % 8 runs s steps behind lane 0, each lane still
//     summing its rows' codes in m order, one code a step.  At any step the
//     8 lanes of a quarter-warp look up 8 different m, in 8 different bank
//     groups: no conflict, whatever the codes;
//   * each lane walks a stream of rows (32 consecutive rows a warp per
//     window of 16 steps, windows strided over the grid); a window's steps
//     j < s finish the row begun in the window before (accumulator B), the
//     steps j >= s begin the next (accumulator A).  The 16 code bytes a
//     window needs are bytes [16 - s, 32 - s) of the two rows' 16-byte
//     loads (a funnel shift); the codes are loaded two windows ahead;
//   * with the lookups conflict-free, instructions bound the loop: a step
//     is one byte extraction (PRMT), one multiply-add onto the lane's
//     shared address for that step (16 kept in registers, the wrap of
//     (j - s) mod 16 folded in) and one 16-byte shared load, then the four
//     adds;
//   * at the end of a window every lane's finished row goes out as four
//     coalesced streaming stores (one a query); the LUT staging (64 KB at
//     K = 256) is paid once per block, and the grid is one wave of the
//     blocks the card holds (2 an SM at up to 128 registers a thread),
//     split over query groups and rows;
//   * M > 16: one pass over the rows per 16 m, a row's sum stored after one
//     pass and read back by the same lane for the next, which keeps the m
//     order of the sum.
// M not a multiple of 16 (rows not 16-byte aligned) goes to a plain kernel:
// one row per thread, the LUTs of 4 queries staged [m][c] in chunks of m
// that fit 64 KB, one code byte loaded at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 4;                       // queries per block
constexpr int kGroup = 16;                   // codes a 16-byte load, steps a window
constexpr int kSkewBlocks = 2;               // blocks an SM: 64 KB of LUTs, 128 registers
constexpr int kChunkBytes = 64 * 1024;       // shared LUT chunk, plain kernel
constexpr int kTargetBlocks = 3 * 132 * 2;   // plain kernel: ~3 blocks an SM, two waves
constexpr int kMaxDevices = 64;

// Bytes [16 - s, 32 - s) of the 32 bytes (p, c), as four words.
__device__ __forceinline__ void window(const uint4& p, const uint4& c, int s,
                                       uint32_t (&win)[4]) {
  const uint32_t w[9] = {p.x, p.y, p.z, p.w, c.x, c.y, c.z, c.w, 0u};
  const int o = kGroup - s;                  // 9..16
  const int base = o >> 2;                   // 2..4
  const int sh = (o & 3) * 8;
  uint32_t pick[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) pick[i] = base == 2 ? w[2 + i] : (base == 3 ? w[3 + i] : w[4 + i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) win[i] = __funnelshift_r(pick[i], pick[i + 1], sh);
}

// One 16-byte shared load at a 32-bit shared address.
__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 t;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(t.x), "=f"(t.y), "=f"(t.z), "=f"(t.w) : "r"(addr));
  return t;
}

__global__ void __launch_bounds__(kThreads, kSkewBlocks)
pq_scan_skewed(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
               float* __restrict__ out, int q, int n, int m, int k) {
  extern __shared__ float4 lut_s[];          // (k, 16) entries of 4 queries
  const int q0 = blockIdx.y * kQB;
  const int nq = q - q0 < kQB ? q - q0 : kQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = lane & 7;                    // the lane's skew in steps
  const long long tiles = (static_cast<long long>(n) + 31) / 32;
  const long long wg = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long rstep = static_cast<long long>(gridDim.x) * kWarps * 32;  // rows a window
  const int windows = wg < tiles ? static_cast<int>((tiles * 32 - wg * 32 + rstep - 1) / rstep) : 0;
  const long long row0 = wg * 32 + lane;     // the lane's row in window 0
  // Step j looks up entry (c, (j - s) mod 16): c * 256 bytes past at[j].
  const uint32_t lut_addr = static_cast<uint32_t>(__cvta_generic_to_shared(lut_s));
  uint32_t at[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) at[j] = lut_addr + (((j - s) & (kGroup - 1)) << 4);
  float* orow[kQB];
#pragma unroll
  for (int qi = 0; qi < kQB; ++qi) orow[qi] = out + static_cast<size_t>(q0 + qi) * n;

  for (int m0 = 0; m0 < m; m0 += kGroup) {
    __syncthreads();                         // previous group fully used
    // Entry e = c * 16 + j: consecutive threads write consecutive entries.
    const size_t qstride = static_cast<size_t>(m) * k;
    for (int e = threadIdx.x; e < kGroup * k; e += kThreads) {
      const float* src = luts + q0 * qstride + static_cast<size_t>(m0 + (e & 15)) * k + (e >> 4);
      lut_s[e] = make_float4(__ldg(src), 1 < nq ? __ldg(src + qstride) : 0.f,
                             2 < nq ? __ldg(src + 2 * qstride) : 0.f,
                             3 < nq ? __ldg(src + 3 * qstride) : 0.f);
    }
    __syncthreads();
    if (windows == 0) continue;

    const bool first = m0 == 0, last = m0 + kGroup >= m;
    const uint8_t* crow = codes + row0 * m + m0;
    const long long cstep = rstep * m;
    auto load_codes = [&](int w) {
      return w < windows && row0 + w * rstep < n
                 ? __ldg(reinterpret_cast<const uint4*>(crow + w * cstep))
                 : make_uint4(0u, 0u, 0u, 0u);
    };
    // A row's running sum before this group: 0, or what the last group stored.
    auto start = [&](int w, float (&a)[kQB]) {
      const long long r = row0 + w * rstep;
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi)
        a[qi] = first || w >= windows || r >= n || qi >= nq ? 0.f : orow[qi][r];
    };

    uint4 prev = make_uint4(0u, 0u, 0u, 0u), cur = load_codes(0), nxt = load_codes(1);
    float a[kQB], b[kQB] = {0.f, 0.f, 0.f, 0.f};
    start(0, a);
    // Window `windows` only finishes the last row of lanes s > 0.
    for (int w = 0; w <= windows; ++w) {
      const uint4 nxt2 = load_codes(w + 2);
      uint32_t win[4];
      window(prev, cur, s, win);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const uint32_t c = __byte_perm(win[j >> 2], 0u, 0x4440u | (j & 3));
        const float4 t = lds4(c * (kGroup * 16) + at[j]);
        if (j < 7 && j < s) {                // step j of the row begun last window
          b[0] += t.x;
          b[1] += t.y;
          b[2] += t.z;
          b[3] += t.w;
        } else {
          a[0] += t.x;
          a[1] += t.y;
          a[2] += t.z;
          a[3] += t.w;
        }
      }
      const long long r = row0 + (w - 1) * rstep;
      if (w > 0 && r < n) {
#pragma unroll
        for (int qi = 0; qi < kQB; ++qi) {
          if (qi >= nq) continue;
          if (last) __stcs(orow[qi] + r, b[qi]);
          else orow[qi][r] = b[qi];
        }
      }
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi) b[qi] = a[qi];
      start(w + 1, a);
      prev = cur;
      cur = nxt;
      nxt = nxt2;
    }
  }
}

// m entries of one chunk of the plain kernel.
__host__ __device__ inline int chunk_m(int m, int k) {
  const int mc = kChunkBytes / (k * kQB * 4);  // >= 16 for k <= 256
  return mc < m ? mc : m;
}

__global__ void __launch_bounds__(kThreads)
pq_scan_rows(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
             float* __restrict__ out, int q, int n, int m, int k) {
  extern __shared__ float4 lut_s[];          // (mc * k) entries of 4 queries
  const int q0 = blockIdx.y * kQB;
  const int nq = q - q0 < kQB ? q - q0 : kQB;
  const int mc_max = chunk_m(m, k);
  const int stride = gridDim.x * kThreads;

  for (int m0 = 0; m0 < m; m0 += mc_max) {
    const int mc = m - m0 < mc_max ? m - m0 : mc_max;
    __syncthreads();                         // previous chunk fully used
    float* lf = reinterpret_cast<float*>(lut_s);
    for (int e = threadIdx.x; e < mc * k * kQB; e += kThreads) {
      const int qi = e / (mc * k);           // coalesced reads per query
      const int mk = e - qi * (mc * k);
      lf[mk * kQB + qi] = qi < nq
          ? __ldg(luts + ((size_t)(q0 + qi) * m + m0) * k + mk) : 0.f;
    }
    __syncthreads();

    for (int row = blockIdx.x * kThreads + threadIdx.x; row < n; row += stride) {
      float acc[kQB];
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi)
        acc[qi] = (m0 == 0 || qi >= nq) ? 0.f : out[(size_t)(q0 + qi) * n + row];
      const uint8_t* crow = codes + (size_t)row * m + m0;
      for (int j = 0; j < mc; ++j) {
        const float4 t = lut_s[j * k + __ldg(crow + j)];
        acc[0] += t.x;
        acc[1] += t.y;
        acc[2] += t.z;
        acc[3] += t.w;
      }
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi)
        if (qi < nq) __stcs(out + (size_t)(q0 + qi) * n + row, acc[qi]);
    }
  }
}

// Blocks of the skewed kernel the card holds at once with K = 256's 64 KB
// (cached per device), or minus a CUDA error code.
int skewed_slots() {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int slots = dev < kMaxDevices ? cache[dev].load() : 0;
  if (slots > 0) return slots;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pq_scan_skewed, kThreads,
                                                    kQB * kGroup * 256 * 4);
  if (e != cudaSuccess) return -static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  slots = (per_sm < 1 ? 1 : per_sm) * sms;
  if (dev < kMaxDevices) cache[dev].store(slots);
  return slots;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  luts (q, m, k) float32, codes
// (n, m) uint8 (16-byte aligned), out (q, n) float32, all row-major.  Query
// groups go in launches of at most 65535 (the grid's y limit).  Launches on
// `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int repro_pq_scan(int q, int n, int m, int k, const void* luts,
                             const void* codes, void* out, void* stream) {
  if (q <= 0 || n <= 0) return 0;
  if (m < 1 || k < 1 || k > 256) return static_cast<int>(cudaErrorInvalidValue);
  const bool skewed = m % kGroup == 0;
  const int smem = skewed ? kQB * kGroup * 256 * static_cast<int>(sizeof(float))
                          : chunk_m(m, k) * k * kQB * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(skewed ? (const void*)pq_scan_skewed
                                              : (const void*)pq_scan_rows,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int slots = skewed ? skewed_slots() : kTargetBlocks;
  if (slots < 0) return -slots;
  const int launch_smem = skewed ? kQB * kGroup * k * static_cast<int>(sizeof(float)) : smem;
  const int groups = (q + kQB - 1) / kQB;
  const long long unit = skewed ? 32LL * kWarps : kThreads;   // rows a block needs
  const long long row_blocks = (n + unit - 1) / unit;
  for (int g0 = 0; g0 < groups; g0 += 65535) {
    const int gy = groups - g0 < 65535 ? groups - g0 : 65535;
    long long gx = skewed ? slots / gy : (kTargetBlocks + gy - 1) / gy;
    if (gx < 1) gx = 1;
    if (gx > row_blocks) gx = row_blocks;
    const int qn = q - g0 * kQB < gy * kQB ? q - g0 * kQB : gy * kQB;
    const dim3 grid(static_cast<unsigned>(gx), gy);
    const auto* l = static_cast<const float*>(luts) + (size_t)g0 * kQB * m * k;
    const auto* c = static_cast<const uint8_t*>(codes);
    auto* o = static_cast<float*>(out) + (size_t)g0 * kQB * n;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (skewed)
      pq_scan_skewed<<<grid, kThreads, launch_smem, s>>>(l, c, o, qn, n, m, k);
    else
      pq_scan_rows<<<grid, kThreads, launch_smem, s>>>(l, c, o, qn, n, m, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
