// Shared pieces of the lower-triangle Gram kernels (gram_syrk.cu, symmul.cu,
// through tf32_lower.cuh and bf16_lower.cuh).
//
// Both kernels compute only the tiles (i, j), j <= i, of a symmetric (m, m)
// output, one thread block per tile, and write each lower element twice: at
// (r, c) and mirrored at (c, r).  In a diagonal tile only the lower half is
// kept.  The dense output therefore equals the reference's
// ``mirror_lower(raw)``: the kernel's own upper products are discarded, as
// on the TPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace lt {

constexpr int kUnsupported = -1;  // returned for a configuration with no instantiation

// dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

// Tile coordinates of lower tile l of an nb-block grid when the tiles run in
// groups of G block rows: the tiles of rows gG .. gG + G − 1 keep their
// places in tile_of's order as a set, but run column by column, each
// column's rows in order.  Blocks run roughly in launch order, so the ones in
// flight at once read about G row panels and (in flight) / G column panels
// instead of one column panel each: L2 serves the rest.
__device__ __forceinline__ void grouped_tile_of(int l, int nb, int G, int& i, int& j) {
  int t, u;
  tile_of(l, t, u);                    // row-major row t: the group is t / G
  const int r0 = (t / G) * G;
  const int h = min(G, nb - r0);       // rows in the group
  int q = l - r0 * (r0 + 1) / 2;       // place within the group
  const int full = (r0 + 1) * h;       // columns 0 .. r0 hold h tiles each
  if (q < full) {
    j = q / h;
    i = r0 + q % h;
    return;
  }
  q -= full;
  for (int d = 1; d < h; ++d) {        // column r0 + d: rows r0 + d .. r0 + h − 1
    if (q < h - d) {
      j = r0 + d;
      i = r0 + d + q;
      return;
    }
    q -= h - d;
  }
  i = j = 0;                           // not reached for l inside the grid
}

}  // namespace lt
