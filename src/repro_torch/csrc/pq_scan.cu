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
// What bounds it on this card: bytes, in principle.  It must read the codes
// (N*M bytes) and the LUTs and write Q*N floats; at Q = 256, N = 1M, M = 16
// that is 16 MB + 4 MB + 1.07 GB, about 0.33 ms at 3.35 TB/s.  The Q*N*M
// lookups (4.3e9 there) go through shared memory, whose random-address
// throughput is the practical limit of this design.
//
// What the design does about it:
//   * a block takes kQB = 4 queries and stages their LUTs interleaved by
//     query, lut_s[(m * K + c) * 4 + qi], so one 16-byte shared load fetches
//     the entry of all four queries: a quarter of the shared-memory
//     instructions of one lookup per query;
//   * each thread takes one code row at a time (16 codes in one 16-byte load
//     where M is a multiple of 16), keeps four sums in registers and writes
//     four coalesced rows of the output with streaming stores;
//   * a block walks a strided range of rows, so the LUT staging (64 KB at
//     M = 16, K = 256) is paid once per block, not per row tile;
//   * where the LUTs of four queries exceed the 64 KB chunk, m is cut into
//     chunks staged one after the other; a row's sum after one chunk is
//     stored and read back by the same thread for the next, which keeps the
//     m order of the sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQB = 4;                       // queries per block
constexpr int kChunkBytes = 64 * 1024;       // shared LUT chunk
constexpr int kTargetBlocks = 3 * 132 * 2;   // ~3 blocks per SM, two waves

// m entries of one chunk: whole 16-code groups that fit the chunk.
__host__ __device__ inline int chunk_m(int m, int k) {
  int mc = (kChunkBytes / (k * kQB * 4)) / 16 * 16;
  if (mc < 16) mc = 16;   // k <= 256 gives mc >= 16
  return mc < m ? mc : m;
}

__global__ void __launch_bounds__(kThreads)
pq_scan_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
               float* __restrict__ out, int q, int n, int m, int k) {
  extern __shared__ float4 lut_s[];          // (mc * k) entries of 4 queries
  const int q0 = blockIdx.y * kQB;
  const int nq = q - q0 < kQB ? q - q0 : kQB;
  const int mc_max = chunk_m(m, k);
  const bool vec = (m % 16) == 0;            // 16-byte code loads
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
      if (vec) {
        for (int j0 = 0; j0 < mc; j0 += 16) {
          const uint4 w = __ldg(reinterpret_cast<const uint4*>(crow + j0));
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int b = 0; b < 16; ++b) {
            const int c = (words[b >> 2] >> (8 * (b & 3))) & 0xff;
            const float4 t = lut_s[(j0 + b) * k + c];
            acc[0] += t.x;
            acc[1] += t.y;
            acc[2] += t.z;
            acc[3] += t.w;
          }
        }
      } else {
        for (int j = 0; j < mc; ++j) {
          const float4 t = lut_s[j * k + __ldg(crow + j)];
          acc[0] += t.x;
          acc[1] += t.y;
          acc[2] += t.z;
          acc[3] += t.w;
        }
      }
#pragma unroll
      for (int qi = 0; qi < kQB; ++qi)
        if (qi < nq) __stcs(out + (size_t)(q0 + qi) * n + row, acc[qi]);
    }
  }
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
  const int smem = chunk_m(m, k) * k * kQB * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      pq_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = (q + kQB - 1) / kQB;
  const int row_blocks = (n + kThreads - 1) / kThreads;
  for (int g0 = 0; g0 < groups; g0 += 65535) {
    const int gy = groups - g0 < 65535 ? groups - g0 : 65535;
    int gx = (kTargetBlocks + gy - 1) / gy;
    if (gx > row_blocks) gx = row_blocks;
    const int qn = q - g0 * kQB < gy * kQB ? q - g0 * kQB : gy * kQB;
    pq_scan_kernel<<<dim3(gx, gy), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(luts) + (size_t)g0 * kQB * m * k,
        static_cast<const uint8_t*>(codes),
        static_cast<float*>(out) + (size_t)g0 * kQB * n, qn, n, m, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
