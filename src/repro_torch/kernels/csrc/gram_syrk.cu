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
// bf16 inputs (bf16 or fp32 output) are not on the main path and keep the
// FFMA mainloop of lower_tiles.cuh (syrk_ffma_kernel: fp32 FFMA, each
// thread's BM/16 x BM/16 accumulator in registers, ragged m and n masked),
// by an explicit dispatch on dtype in gram_syrk_lower below.
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

// ------------------------------------------------------ bf16 inputs (FFMA)

template <typename T, typename O, int BM, int BK>
__global__ void __launch_bounds__(lt::kThreads)
syrk_ffma_kernel(const T* __restrict__ x, O* __restrict__ out, int m, int n) {
  extern __shared__ float smem[];
  float* xi = smem;
  float* xj = smem + BK * (BM + 1);
  int ti, tj;
  lt::tile_of(blockIdx.x, ti, tj);
  const T* xb = x + (size_t)blockIdx.y * m * n;
  O* ob = out + (size_t)blockIdx.y * m * m;

  float acc[BM / 16][BM / 16];
#pragma unroll
  for (int u = 0; u < BM / 16; ++u)
#pragma unroll
    for (int v = 0; v < BM / 16; ++v) acc[u][v] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    lt::load_k_contiguous<T, BM, BK>(xi, xb, m, n, n, ti * BM, k0);
    lt::load_k_contiguous<T, BM, BK>(xj, xb, m, n, n, tj * BM, k0);
    __syncthreads();
    lt::mma_slice<BM, BK>(xi, xj, acc);  // X_i · X_jᵀ
    __syncthreads();
  }
  lt::store_lower_and_mirror<O, BM>(ob, m, ti, tj, acc, smem);
}

template <typename T, typename O, int BM, int BK>
int launch_ffma(const void* x, void* out, int batch, int m, int n, cudaStream_t stream) {
  constexpr int smem = lt::smem_floats(BM, BK) * (int)sizeof(float);
  int err = lt::allow_dynamic_smem<syrk_ffma_kernel<T, O, BM, BK>>(smem);
  if (err != 0) return err;
  const int nb = (m + BM - 1) / BM;
  const dim3 grid(nb * (nb + 1) / 2, batch);
  syrk_ffma_kernel<T, O, BM, BK><<<grid, lt::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<O*>(out), m, n);
  return (int)cudaGetLastError();
}

// fp32 -> fp32 on the tensor cores (3xTF32); bf16 inputs on the FFMA mainloop.
template <int BM, int BK>
int dispatch_dtype(const void* x, void* out, int batch, int m, int n, int in_dt, int out_dt,
                   cudaStream_t s) {
  if (in_dt == lt::kF32 && out_dt == lt::kF32) return launch_tf32<BM>(x, out, batch, m, n, s);
  if (in_dt == lt::kBF16 && out_dt == lt::kBF16)
    return launch_ffma<__nv_bfloat16, __nv_bfloat16, BM, BK>(x, out, batch, m, n, s);
  if (in_dt == lt::kBF16 && out_dt == lt::kF32)
    return launch_ffma<__nv_bfloat16, float, BM, BK>(x, out, batch, m, n, s);
  return lt::kUnsupported;
}

}  // namespace

extern "C" {

// Returns 0 on a successful launch, a cudaError_t code, -1 for a
// (block_m, block_k, dtype) combination that has no instantiation, -2 if the
// TMA tensor map cannot be encoded, -3 for fp32 with m or n not a multiple
// of 4 (the wrapper pads such shapes).
int gram_syrk_lower(const void* x, void* out, int batch, int m, int n, int block_m, int block_k,
                    int in_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // BLOCKS (keep in step with repro_torch/kernels/autotune.py:INSTANTIATED_BLOCKS)
  if (block_m == 64 && block_k == 32)
    return dispatch_dtype<64, 32>(x, out, batch, m, n, in_dtype, out_dtype, s);
  if (block_m == 128 && block_k == 32)
    return dispatch_dtype<128, 32>(x, out, batch, m, n, in_dtype, out_dtype, s);
  return lt::kUnsupported;
}

const char* gram_syrk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
