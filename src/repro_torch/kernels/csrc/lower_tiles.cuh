// Shared pieces of the lower-triangle Gram kernels (gram_syrk.cu, symmul.cu).
//
// Both kernels compute only the tiles (i, j), j <= i, of a symmetric (m, m)
// output, one thread block per tile.  A block has 256 threads (16 x 16); each
// owns a (BM/16) x (BM/16) register micro-tile at rows ty + 16u and columns
// tx + 16v of the tile, so shared-memory reads are broadcasts (rows) or
// conflict-free (columns) and the direct global stores coalesce.  The depth
// loop walks the contraction in BK-wide slices staged in shared memory; the
// products are fp32 FFMA (fmaf), never TF32, whatever the operand type.
//
// The epilogue writes each lower element twice: at (r, c) and mirrored at
// (c, r), the latter transposed through shared memory.  In a diagonal tile
// only the lower half is kept.  The dense output therefore equals the
// reference's ``mirror_lower(raw)``: the kernel's own upper products are
// discarded, as on the TPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace lt {

constexpr int kThreads = 256;
constexpr int kUnsupported = -1;  // returned for a configuration with no instantiation

// dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Dynamic shared memory of one block: two BK x (BM + 1) operand slices, reused
// as the BM x (BM + 1) transpose buffer of the epilogue.
constexpr int smem_floats(int bm, int bk) {
  return (2 * bk * (bm + 1) > bm * (bm + 1)) ? 2 * bk * (bm + 1) : bm * (bm + 1);
}

// Opt KERNEL into ``bytes`` of dynamic shared memory (above the 48 KB
// default), once per device and kernel: the attribute is set on the first
// launch only.  (Templated on the kernel itself, not its type: instantiations
// with equal signatures must not share the flag.)
template <auto KERNEL>
int allow_dynamic_smem(int bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices) done[dev] = true;
  return 0;
}

// Tile coordinates of lower tile l in row-major order: l = i (i + 1) / 2 + j.
__device__ __forceinline__ void tile_of(int l, int& i, int& j) {
  int t = (int)((sqrtf(8.0f * (float)l + 1.0f) - 1.0f) * 0.5f);
  while ((t + 1) * (t + 2) / 2 <= l) ++t;
  while (t * (t + 1) / 2 > l) --t;
  i = t;
  j = l - t * (t + 1) / 2;
}

// s[k][r] = src[(r0 + r) * ld + k0 + k] for a BM x BK slice whose contraction
// index is contiguous in memory (SYRK's X, symmul's A); zero outside
// [0, rows) x [0, cols), which masks the ragged edges.
template <typename T, int BM, int BK>
__device__ __forceinline__ void load_k_contiguous(float* s, const T* __restrict__ src,
                                                  int rows, int cols, int ld, int r0, int k0) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < BM * BK; idx += kThreads) {
    const int r = idx / BK, k = idx % BK;
    const int gr = r0 + r, gk = k0 + k;
    float v = 0.0f;
    if (gr < rows && gk < cols) v = to_f32(src[(size_t)gr * ld + gk]);
    s[k * (BM + 1) + r] = v;
  }
}

// s[k][c] = src[(k0 + k) * m + c0 + c] for a BK x BM slice of symmul's B.
template <typename T, int BM, int BK>
__device__ __forceinline__ void load_n_contiguous(float* s, const T* __restrict__ src,
                                                  int m, int k0, int c0) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < BM * BK; idx += kThreads) {
    const int k = idx / BM, c = idx % BM;
    const int gk = k0 + k, gc = c0 + c;
    float v = 0.0f;
    if (gk < m && gc < m) v = to_f32(src[(size_t)gk * m + gc]);
    s[k * (BM + 1) + c] = v;
  }
}

// acc[u][v] += sum_k As[k][ty + 16u] * Bs[k][tx + 16v]
template <int BM, int BK>
__device__ __forceinline__ void mma_slice(const float* As, const float* Bs,
                                          float (&acc)[BM / 16][BM / 16]) {
  constexpr int T = BM / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[T], b[T];
#pragma unroll
    for (int u = 0; u < T; ++u) {
      a[u] = As[k * (BM + 1) + ty + 16 * u];
      b[u] = Bs[k * (BM + 1) + tx + 16 * u];
    }
#pragma unroll
    for (int u = 0; u < T; ++u)
#pragma unroll
      for (int v = 0; v < T; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
  }
}

// Store lower tile (ti, tj) of the (m, m) output and its mirror (see above).
// ``cs`` is the block's shared memory, free once the depth loop is done.
template <typename O, int BM>
__device__ __forceinline__ void store_lower_and_mirror(O* __restrict__ out, int m, int ti, int tj,
                                                       const float (&val)[BM / 16][BM / 16],
                                                       float* cs) {
  constexpr int T = BM / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = ti * BM, c0 = tj * BM;
  const bool diag = (ti == tj);
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int v = 0; v < T; ++v) {
      const int r = r0 + ty + 16 * u, c = c0 + tx + 16 * v;
      if (r < m && c < m && (!diag || c <= r)) out[(size_t)r * m + c] = from_f32<O>(val[u][v]);
    }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < T; ++u)
#pragma unroll
    for (int v = 0; v < T; ++v) cs[(ty + 16 * u) * (BM + 1) + tx + 16 * v] = val[u][v];
  __syncthreads();
  // Output (c0 + rr, r0 + cc) takes the lower element at (r0 + cc, c0 + rr).
  for (int idx = threadIdx.x; idx < BM * BM; idx += kThreads) {
    const int rr = idx / BM, cc = idx % BM;
    const int gr = c0 + rr, gc = r0 + cc;
    if (gr < m && gc < m && (!diag || cc > rr))
      out[(size_t)gr * m + gc] = from_f32<O>(cs[cc * (BM + 1) + rr]);
  }
}

}  // namespace lt
