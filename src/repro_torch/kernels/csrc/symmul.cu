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
// bf16 operands (bf16 or fp32 output; the Gram NS of the >= 340 B policy):
// symmul_bf16_kernel, one bf16 wgmma pass a product.  Bound: operations, m³
// FLOPs (half of 2m³) at 989 TFLOP/s, 6.33 ms at nemotron-4-340b's
// m = 18432 against 2 GB moved.  Design (bf16_lower.cuh): square tiles of
// 192 rows (128 where 192 leaves SMs idle) in an L2-friendly order; a
// producer warp keeps a TMA ring of 64-deep slices in flight, A's rows
// K-major and B's columns read as they lie (row-major, MN-major for wgmma:
// the B transpose bit, no transposing copy, never taken as symmetric), and
// the consumer warpgroups run four wgmma m64nBMk16 a slice from shared
// memory with one group in flight.  The wrapper pads m to a multiple of 8.
#include "bf16_lower.cuh"
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

// ------------------------------------------------------------ bf16 (wgmma)

template <int BM, bool POLY, typename O>
__global__ void __launch_bounds__(bf::Bf16Cfg<BM>::kThreads, 1)
symmul_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const __nv_bfloat16* __restrict__ g,
                   O* __restrict__ out, int m, float ca, float cb, float cc) {
  bf::lower_tile_bf16<BM, POLY, false, O>(map_a, map_b, g, out, m, m, ca, cb, cc);
}

template <int BM, bool POLY, typename O>
int launch_bf16(const void* a, const void* b, void* out, int batch, int m, float ca, float cb,
                float cc, cudaStream_t stream) {
  using C = bf::Bf16Cfg<BM>;
  if (m % 8 != 0) return hw::kUnaligned;
  CUtensorMap map_a, map_b;
  int err = hw::encode_bf16_3d(&map_a, a, batch, m, m, C::kBK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = hw::encode_bf16_3d(&map_b, b, batch, m, m, 64, C::kBK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = lt::allow_dynamic_smem<symmul_bf16_kernel<BM, POLY, O>>(C::kSmem);
  if (err != 0) return err;
  const int nb = (m + BM - 1) / BM;
  const dim3 grid(nb * (nb + 1) / 2, batch);
  symmul_bf16_kernel<BM, POLY, O><<<grid, C::kThreads, C::kSmem, stream>>>(
      map_a, map_b, static_cast<const __nv_bfloat16*>(a), static_cast<O*>(out), m, ca, cb, cc);
  return (int)cudaGetLastError();
}

template <bool POLY>
int dispatch_f32(const void* a, const void* b, void* out, int batch, int m, int block_m,
                 int block_k, float ca, float cb, float cc, cudaStream_t s) {
  // fp32 BLOCKS (keep in step with repro_torch/kernels/autotune.py:INSTANTIATED_BLOCKS[4])
  if (block_m == 64 && block_k == 32)
    return launch_tf32<64, POLY>(a, b, out, batch, m, ca, cb, cc, s);
  if (block_m == 128 && block_k == 32)
    return launch_tf32<128, POLY>(a, b, out, batch, m, ca, cb, cc, s);
  return lt::kUnsupported;
}

template <bool POLY, typename O>
int dispatch_bf16(const void* a, const void* b, void* out, int batch, int m, int block_m,
                  int block_k, float ca, float cb, float cc, cudaStream_t s) {
  // bf16 BLOCKS (keep in step with repro_torch/kernels/autotune.py:INSTANTIATED_BLOCKS[2])
  if (block_m == 128 && block_k == 64)
    return launch_bf16<128, POLY, O>(a, b, out, batch, m, ca, cb, cc, s);
  if (block_m == 192 && block_k == 64)
    return launch_bf16<192, POLY, O>(a, b, out, batch, m, ca, cb, cc, s);
  return lt::kUnsupported;
}

// fp32 -> fp32 on the 3xTF32 mainloop; bf16 -> bf16 or fp32 on the bf16 one.
template <bool POLY>
int dispatch_dtype(const void* a, const void* b, void* out, int batch, int m, int block_m,
                   int block_k, float ca, float cb, float cc, int in_dt, int out_dt,
                   cudaStream_t s) {
  if (in_dt == lt::kF32 && out_dt == lt::kF32)
    return dispatch_f32<POLY>(a, b, out, batch, m, block_m, block_k, ca, cb, cc, s);
  if (in_dt == lt::kBF16 && out_dt == lt::kBF16)
    return dispatch_bf16<POLY, __nv_bfloat16>(a, b, out, batch, m, block_m, block_k, ca, cb, cc,
                                              s);
  if (in_dt == lt::kBF16 && out_dt == lt::kF32)
    return dispatch_bf16<POLY, float>(a, b, out, batch, m, block_m, block_k, ca, cb, cc, s);
  return lt::kUnsupported;
}

}  // namespace

extern "C" {

// epilogue: 0 = plain, 1 = gram_poly (coefficients ca, cb, cc; a == b == G).
// Returns 0 on a successful launch, a cudaError_t code, -1 for a
// (block_m, block_k, dtype) combination that has no instantiation, -2 if the
// TMA tensor maps cannot be encoded, -3 for m not a multiple of 16 bytes of
// the input type (the wrapper pads such m).
int symmul_lower(const void* a, const void* b, void* out, int batch, int m, int block_m,
                 int block_k, int epilogue, float ca, float cb, float cc, int in_dtype,
                 int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (epilogue)
    return dispatch_dtype<true>(a, b, out, batch, m, block_m, block_k, ca, cb, cc, in_dtype,
                                out_dtype, s);
  return dispatch_dtype<false>(a, b, out, batch, m, block_m, block_k, ca, cb, cc, in_dtype,
                               out_dtype, s);
}

const char* symmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
