// Batched symmetric-output product on Hopper: the lower tiles of C = A B for
// A, B of shape (B, m, m), with two epilogues:
//
//   plain      C[i, j] = acc
//   gram_poly  C[i, j] = a·I[i, j] + b·G[i, j] + c·acc   (A = B = G)
//
// Replaces the Pallas TPU kernel src/repro/kernels/symmul.py:symmul_lower
// (bodies _plain_kernel and _gram_poly_kernel): the PQ, PG, PT products and
// the fused polynomial P = aI + bG + cG² of every Gram Newton-Schulz step.
// The dense output is the lower product mirrored up (ref.mirror_lower), for
// any A and B, symmetric or not.
//
// Bound on the card: operations.  The lower half costs m³ FLOPs per matrix
// against 3m² elements moved.  fp32 inputs must keep fp32 accuracy (the
// reference's 1e-4), which one TF32 pass (10-bit mantissa) misses, so the
// fp32 path runs 3xTF32 on the tensor cores: x = big + small, both rounded
// to tf32, and A·B ≈ small_A·big_B + big_A·small_B + big_A·big_B in fp32
// accumulators.  Three wgmma products at 495 TFLOP/s bound an m = 960 batch
// of 32 at 0.17 ms, against 0.42 ms for FFMA at 67 TFLOP/s.
//
// fp32 design (symmul_tf32_kernel): the tensor-core mainloop and epilogue
// of tf32_lower.cuh, shared with the SYRK (gram_syrk.cu): one block per
// lower tile, TMA into an mbarrier ring (A's slice 128-byte swizzled, B's
// row-major), A split in registers for RS wgmma, B split transposed into
// the K-major swizzled layout (never taken as symmetric), 12 wgmmas a
// 32-wide slice folded by FADD, mirror through shared memory.  The wrapper
// pads m to a multiple of 4 (TMA's 16-byte row strides).
//
// bf16 operands (bf16 or fp32 output) are not on the main path and keep the
// FFMA mainloop of lower_tiles.cuh (symmul_ffma_kernel), by an explicit
// dispatch on dtype in symmul_lower below.
#include "tf32_lower.cuh"

namespace {

// ----------------------------------------------------------- fp32 (3xTF32)

template <int BM, bool POLY>
__global__ void __launch_bounds__(tc::Tf32Cfg<BM>::kThreads, tc::Tf32Cfg<BM>::kBlocksPerSM)
symmul_tf32_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const float* __restrict__ g,
                   float* __restrict__ out, int m, float ca, float cb, float cc) {
  tc::lower_tile_tf32<BM, POLY, false>(map_a, map_b, g, out, m, m, ca, cb, cc);
}

template <int BM, bool POLY>
int launch_tf32(const void* a, const void* b, void* out, int batch, int m, float ca, float cb,
                float cc, cudaStream_t stream) {
  using C = tc::Tf32Cfg<BM>;
  if (m % 4 != 0) return hw::kUnaligned;
  CUtensorMap map_a, map_b;
  int err = hw::encode_f32_3d(&map_a, a, batch, m, m, C::kBK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = hw::encode_f32_3d(&map_b, b, batch, m, m, BM, C::kBK, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  err = lt::allow_dynamic_smem<symmul_tf32_kernel<BM, POLY>>(C::kSmem);
  if (err != 0) return err;
  const int nb = (m + BM - 1) / BM;
  const dim3 grid(nb * (nb + 1) / 2, batch);
  symmul_tf32_kernel<BM, POLY><<<grid, C::kThreads, C::kSmem, stream>>>(
      map_a, map_b, static_cast<const float*>(a), static_cast<float*>(out), m, ca, cb, cc);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16 operands (FFMA)

template <typename T, typename O, int BM, int BK, bool POLY>
__global__ void __launch_bounds__(lt::kThreads)
symmul_ffma_kernel(const T* __restrict__ a, const T* __restrict__ b, O* __restrict__ out, int m,
                   float ca, float cb, float cc) {
  extern __shared__ float smem[];
  float* as = smem;
  float* bs = smem + BK * (BM + 1);
  int ti, tj;
  lt::tile_of(blockIdx.x, ti, tj);
  const size_t off = (size_t)blockIdx.y * m * m;
  const T* ab = a + off;
  const T* bb = b + off;
  O* ob = out + off;

  float acc[BM / 16][BM / 16];
#pragma unroll
  for (int u = 0; u < BM / 16; ++u)
#pragma unroll
    for (int v = 0; v < BM / 16; ++v) acc[u][v] = 0.0f;

  for (int k0 = 0; k0 < m; k0 += BK) {
    lt::load_k_contiguous<T, BM, BK>(as, ab, m, m, m, ti * BM, k0);
    lt::load_n_contiguous<T, BM, BK>(bs, bb, m, k0, tj * BM);
    __syncthreads();
    lt::mma_slice<BM, BK>(as, bs, acc);  // A_i,k · B_k,j
    __syncthreads();
  }

  if (POLY) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int u = 0; u < BM / 16; ++u)
#pragma unroll
      for (int v = 0; v < BM / 16; ++v) {
        const int r = ti * BM + ty + 16 * u, c = tj * BM + tx + 16 * v;
        const float g = (r < m && c < m) ? lt::to_f32(ab[(size_t)r * m + c]) : 0.0f;
        const float eye = (r == c) ? 1.0f : 0.0f;
        acc[u][v] = ca * eye + cb * g + cc * acc[u][v];
      }
  }
  lt::store_lower_and_mirror<O, BM>(ob, m, ti, tj, acc, smem);
}

template <typename T, typename O, int BM, int BK, bool POLY>
int launch_ffma(const void* a, const void* b, void* out, int batch, int m, float ca, float cb,
                float cc, cudaStream_t stream) {
  constexpr int smem = lt::smem_floats(BM, BK) * (int)sizeof(float);
  int err = lt::allow_dynamic_smem<symmul_ffma_kernel<T, O, BM, BK, POLY>>(smem);
  if (err != 0) return err;
  const int nb = (m + BM - 1) / BM;
  const dim3 grid(nb * (nb + 1) / 2, batch);
  symmul_ffma_kernel<T, O, BM, BK, POLY><<<grid, lt::kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<O*>(out), m, ca, cb, cc);
  return (int)cudaGetLastError();
}

// fp32 -> fp32 on the tensor cores (3xTF32); bf16 inputs on the FFMA mainloop.
template <int BM, int BK, bool POLY>
int dispatch_dtype(const void* a, const void* b, void* out, int batch, int m, float ca, float cb,
                   float cc, int in_dt, int out_dt, cudaStream_t s) {
  if (in_dt == lt::kF32 && out_dt == lt::kF32)
    return launch_tf32<BM, POLY>(a, b, out, batch, m, ca, cb, cc, s);
  if (in_dt == lt::kBF16 && out_dt == lt::kBF16)
    return launch_ffma<__nv_bfloat16, __nv_bfloat16, BM, BK, POLY>(a, b, out, batch, m, ca, cb,
                                                                   cc, s);
  if (in_dt == lt::kBF16 && out_dt == lt::kF32)
    return launch_ffma<__nv_bfloat16, float, BM, BK, POLY>(a, b, out, batch, m, ca, cb, cc, s);
  return lt::kUnsupported;
}

template <int BM, int BK>
int dispatch_epilogue(const void* a, const void* b, void* out, int batch, int m, int poly,
                      float ca, float cb, float cc, int in_dt, int out_dt, cudaStream_t s) {
  if (poly)
    return dispatch_dtype<BM, BK, true>(a, b, out, batch, m, ca, cb, cc, in_dt, out_dt, s);
  return dispatch_dtype<BM, BK, false>(a, b, out, batch, m, ca, cb, cc, in_dt, out_dt, s);
}

}  // namespace

extern "C" {

// epilogue: 0 = plain, 1 = gram_poly (coefficients ca, cb, cc; a == b == G).
// Returns 0 on a successful launch, a cudaError_t code, -1 for a
// (block_m, block_k, dtype) combination that has no instantiation, -2 if the
// TMA tensor maps cannot be encoded, -3 for fp32 with m % 4 != 0 (the wrapper
// pads such m).
int symmul_lower(const void* a, const void* b, void* out, int batch, int m, int block_m,
                 int block_k, int epilogue, float ca, float cb, float cc, int in_dtype,
                 int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // BLOCKS (keep in step with repro_torch/kernels/autotune.py:INSTANTIATED_BLOCKS)
  if (block_m == 64 && block_k == 32)
    return dispatch_epilogue<64, 32>(a, b, out, batch, m, epilogue, ca, cb, cc, in_dtype,
                                     out_dtype, s);
  if (block_m == 128 && block_k == 32)
    return dispatch_epilogue<128, 32>(a, b, out, batch, m, epilogue, ca, cb, cc, in_dtype,
                                      out_dtype, s);
  return lt::kUnsupported;
}

const char* symmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
