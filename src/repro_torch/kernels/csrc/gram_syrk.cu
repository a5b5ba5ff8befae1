// Batched SYRK on Hopper: the lower tiles of G = X Xᵀ for X of shape (B, m, n).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram_syrk.py:syrk_lower
// (body _syrk_kernel): G₀ of every shape group of the Gram Newton-Schulz
// iteration, once per optimizer step.  The dense output is the lower product
// mirrored up (ref.mirror_lower).
//
// Bound on the card: operations.  The symmetric half costs m²n FLOPs per
// matrix against (mn + m²) elements moved, e.g. 960²·2560 FLOPs for 12.5 MB
// at the slice's (960, 2560) group, far above the H100's ridge.  fp32 must
// keep fp32 accuracy (the reference's 1e-4), so the fp32 path runs 3xTF32
// on the tensor cores: three wgmma products at 495 TFLOP/s bound a
// (32, 960, 2560) batch at 0.46 ms, against 1.13 ms for FFMA at 67 TFLOP/s.
//
// fp32 design (syrk_tf32_kernel): the tensor-core mainloop and epilogue of
// tf32_lower.cuh, shared with symmul.cu, with B = Xᵀ.  Both operands of
// X Xᵀ are rows of X, K-major in memory, which is the only layout a tf32
// wgmma reads, so one 3-D tensor map over X (boxes of BM rows x 32 columns,
// 128-byte swizzle) serves both: rows i·BM (A) and j·BM (B) of the same
// 32-wide slice, one box on a diagonal tile.  A's fragment is split in
// registers for RS wgmma; B's split is elementwise at the slice's own byte
// offsets (no transpose, unlike symmul's).  12 wgmmas a slice, folded by
// FADD; the long contraction (n = 2560: 80 slices) amortises the epilogue.
// TMA needs 16-byte row strides and the epilogue's vector stores m % 4 == 0,
// so the wrapper zero-pads m and n to multiples of 4.
//
// bf16 inputs (bf16 or fp32 output; the Gram NS of the >= 340 B policy,
// GramNSConfig(compute_dtype="bfloat16")): syrk_bf16_kernel, one bf16 wgmma
// pass a product.  Bound: operations, m²n FLOPs (half of 2m²n) at 989
// TFLOP/s, 25.3 ms for nemotron-4-340b's (1, 18432, 73728) against 2.7 GB
// moved.  Design (bf16_lower.cuh): square tiles of 192 rows (128 where 192
// leaves SMs idle) in an L2-friendly order; a producer warp keeps a TMA
// ring of 64-deep slices of X's rows i·BM and j·BM in flight (one box on a
// diagonal tile), both K-major, and the consumer warpgroups run four wgmma
// m64nBMk16 a slice from shared memory with one group in flight.  The
// wrapper zero-pads m and n to multiples of 8 (TMA's 16-byte row strides).
#include "bf16_lower.cuh"
#include "tf32_lower.cuh"

namespace {

// ----------------------------------------------------------- fp32 (3xTF32)

template <int BM>
__global__ void __launch_bounds__(tc::Tf32Cfg<BM>::kThreads, tc::Tf32Cfg<BM>::kBlocksPerSM)
syrk_tf32_kernel(const __grid_constant__ CUtensorMap map_x, float* __restrict__ out, int m,
                 int n) {
  tc::lower_tile_tf32<BM, false, true>(map_x, map_x, nullptr, out, m, n, 0.0f, 0.0f, 0.0f);
}

template <int BM>
int launch_tf32(const void* x, void* out, int batch, int m, int n, cudaStream_t stream) {
  using C = tc::Tf32Cfg<BM>;
  if (m % 4 != 0 || n % 4 != 0) return hw::kUnaligned;
  CUtensorMap map_x;
  int err = hw::encode_f32_3d(&map_x, x, batch, m, n, C::kBK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = lt::allow_dynamic_smem<syrk_tf32_kernel<BM>>(C::kSmem);
  if (err != 0) return err;
  const int nb = (m + BM - 1) / BM;
  const dim3 grid(nb * (nb + 1) / 2, batch);
  syrk_tf32_kernel<BM><<<grid, C::kThreads, C::kSmem, stream>>>(map_x, static_cast<float*>(out),
                                                                 m, n);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 (wgmma)

template <int BM, typename O>
__global__ void __launch_bounds__(bf::Bf16Cfg<BM>::kThreads, 1)
syrk_bf16_kernel(const __grid_constant__ CUtensorMap map_x, O* __restrict__ out, int m, int n) {
  bf::lower_tile_bf16<BM, false, true, O>(map_x, map_x, nullptr, out, m, n, 0.0f, 0.0f, 0.0f);
}

template <int BM, typename O>
int launch_bf16(const void* x, void* out, int batch, int m, int n, cudaStream_t stream) {
  using C = bf::Bf16Cfg<BM>;
  if (m % 8 != 0 || n % 8 != 0) return hw::kUnaligned;
  CUtensorMap map_x;
  int err = hw::encode_bf16_3d(&map_x, x, batch, m, n, C::kBK, BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = lt::allow_dynamic_smem<syrk_bf16_kernel<BM, O>>(C::kSmem);
  if (err != 0) return err;
  const int nb = (m + BM - 1) / BM;
  const dim3 grid(nb * (nb + 1) / 2, batch);
  syrk_bf16_kernel<BM, O><<<grid, C::kThreads, C::kSmem, stream>>>(map_x, static_cast<O*>(out),
                                                                     m, n);
  return (int)cudaGetLastError();
}

// fp32 -> fp32 on the 3xTF32 mainloop.  fp32 BLOCKS (keep in step with
// repro_torch/kernels/autotune.py:INSTANTIATED_BLOCKS[4])
int dispatch_f32(const void* x, void* out, int batch, int m, int n, int block_m, int block_k,
                 cudaStream_t s) {
  if (block_m == 64 && block_k == 32) return launch_tf32<64>(x, out, batch, m, n, s);
  if (block_m == 128 && block_k == 32) return launch_tf32<128>(x, out, batch, m, n, s);
  return lt::kUnsupported;
}

// bf16 -> bf16 or fp32 on the bf16 mainloop.  bf16 BLOCKS (keep in step with
// repro_torch/kernels/autotune.py:INSTANTIATED_BLOCKS[2])
template <typename O>
int dispatch_bf16(const void* x, void* out, int batch, int m, int n, int block_m, int block_k,
                  cudaStream_t s) {
  if (block_m == 128 && block_k == 64) return launch_bf16<128, O>(x, out, batch, m, n, s);
  if (block_m == 192 && block_k == 64) return launch_bf16<192, O>(x, out, batch, m, n, s);
  return lt::kUnsupported;
}

}  // namespace

extern "C" {

// Returns 0 on a successful launch, a cudaError_t code, -1 for a
// (block_m, block_k, dtype) combination that has no instantiation, -2 if the
// TMA tensor map cannot be encoded, -3 for m or n not a multiple of 16
// bytes of the input type (the wrapper pads such shapes).
int gram_syrk_lower(const void* x, void* out, int batch, int m, int n, int block_m, int block_k,
                    int in_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == lt::kF32 && out_dtype == lt::kF32)
    return dispatch_f32(x, out, batch, m, n, block_m, block_k, s);
  if (in_dtype == lt::kBF16 && out_dtype == lt::kBF16)
    return dispatch_bf16<__nv_bfloat16>(x, out, batch, m, n, block_m, block_k, s);
  if (in_dtype == lt::kBF16 && out_dtype == lt::kF32)
    return dispatch_bf16<float>(x, out, batch, m, n, block_m, block_k, s);
  return lt::kUnsupported;
}

const char* gram_syrk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
