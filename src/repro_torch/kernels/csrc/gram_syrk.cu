// Batched SYRK on Hopper: the lower tiles of G = X Xᵀ for X of shape (B, m, n).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram_syrk.py:syrk_lower
// (body _syrk_kernel): G₀ of every shape group of the Gram Newton-Schulz
// iteration, once per optimizer step.
//
// Bound on the card: operations.  The symmetric half costs m²n FLOPs per
// matrix against (mn + m²) elements moved, e.g. 960²·2560 FLOPs for 12.5 MB
// at the slice's (960, 2560) group, far above the H100's fp32 ridge.  The
// kernel runs fp32 FFMA on CUDA cores (never TF32, so it meets the
// reference's 1e-4), does only the lower tiles (half the products of a
// general batched GEMM), and keeps each thread's BM/16 x BM/16 accumulator
// in registers to amortise the shared-memory reads.  Launch: one block per
// lower tile on grid.x (coordinates from a closed form), the batch on
// grid.y; the TPU's sequential k grid axis is the depth loop inside the
// block.  Ragged m and n are masked at load and store.  wgmma / TMA /
// persistent scheduling are not used yet.
#include "lower_tiles.cuh"

namespace {

template <typename T, typename O, int BM, int BK>
__global__ void __launch_bounds__(lt::kThreads)
syrk_lower_kernel(const T* __restrict__ x, O* __restrict__ out, int m, int n) {
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
int launch(const void* x, void* out, int batch, int m, int n, cudaStream_t stream) {
  constexpr int smem = lt::smem_floats(BM, BK) * (int)sizeof(float);
  int err = lt::allow_dynamic_smem<syrk_lower_kernel<T, O, BM, BK>>(smem);
  if (err != 0) return err;
  const int nb = (m + BM - 1) / BM;
  const dim3 grid(nb * (nb + 1) / 2, batch);
  syrk_lower_kernel<T, O, BM, BK><<<grid, lt::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<O*>(out), m, n);
  return (int)cudaGetLastError();
}

template <int BM, int BK>
int dispatch_dtype(const void* x, void* out, int batch, int m, int n, int in_dt, int out_dt,
                   cudaStream_t s) {
  if (in_dt == lt::kF32 && out_dt == lt::kF32)
    return launch<float, float, BM, BK>(x, out, batch, m, n, s);
  if (in_dt == lt::kBF16 && out_dt == lt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, BM, BK>(x, out, batch, m, n, s);
  if (in_dt == lt::kBF16 && out_dt == lt::kF32)
    return launch<__nv_bfloat16, float, BM, BK>(x, out, batch, m, n, s);
  return lt::kUnsupported;
}

}  // namespace

extern "C" {

// Returns 0 on a successful launch, a cudaError_t code, or -1 for a
// (block_m, block_k, dtype) combination that has no instantiation.
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
