// Batched symmetric-output product on Hopper: the lower tiles of C = A B for
// symmetric, commuting A, B of shape (B, m, m), with two epilogues:
//
//   plain      C[i, j] = acc
//   gram_poly  C[i, j] = a·I[i, j] + b·G[i, j] + c·acc   (A = B = G)
//
// Replaces the Pallas TPU kernel src/repro/kernels/symmul.py:symmul_lower
// (bodies _plain_kernel and _gram_poly_kernel): the PQ, PG, PT products and
// the fused polynomial P = aI + bG + cG² of every Gram Newton-Schulz step.
//
// Bound on the card: operations.  The lower half costs m³ FLOPs per matrix
// against 3m² elements moved (e.g. 960³ FLOPs for 11 MB at m = 960), far
// above the H100's fp32 ridge.  The kernel runs fp32 FFMA on CUDA cores
// (never TF32), only over the lower tiles, with register micro-tiles and
// shared-memory staging shared with gram_syrk.cu (lower_tiles.cuh).  The
// gram_poly epilogue is applied in fp32 in registers before the cast, with
// the identity placed where the GLOBAL row equals the GLOBAL column, so P
// never makes a round trip through device memory.  B's slice at (k, j) is
// read for the lower tile (i, j), as on the TPU.
#include "lower_tiles.cuh"

namespace {

template <typename T, typename O, int BM, int BK, bool POLY>
__global__ void __launch_bounds__(lt::kThreads)
symmul_lower_kernel(const T* __restrict__ a, const T* __restrict__ b, O* __restrict__ out, int m,
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
int launch(const void* a, const void* b, void* out, int batch, int m, float ca, float cb,
           float cc, cudaStream_t stream) {
  constexpr int smem = lt::smem_floats(BM, BK) * (int)sizeof(float);
  int err = lt::allow_dynamic_smem<symmul_lower_kernel<T, O, BM, BK, POLY>>(smem);
  if (err != 0) return err;
  const int nb = (m + BM - 1) / BM;
  const dim3 grid(nb * (nb + 1) / 2, batch);
  symmul_lower_kernel<T, O, BM, BK, POLY><<<grid, lt::kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<O*>(out), m, ca, cb, cc);
  return (int)cudaGetLastError();
}

template <int BM, int BK, bool POLY>
int dispatch_dtype(const void* a, const void* b, void* out, int batch, int m, float ca, float cb,
                   float cc, int in_dt, int out_dt, cudaStream_t s) {
  if (in_dt == lt::kF32 && out_dt == lt::kF32)
    return launch<float, float, BM, BK, POLY>(a, b, out, batch, m, ca, cb, cc, s);
  if (in_dt == lt::kBF16 && out_dt == lt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, BM, BK, POLY>(a, b, out, batch, m, ca, cb, cc, s);
  if (in_dt == lt::kBF16 && out_dt == lt::kF32)
    return launch<__nv_bfloat16, float, BM, BK, POLY>(a, b, out, batch, m, ca, cb, cc, s);
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
// Returns 0 on a successful launch, a cudaError_t code, or -1 for a
// (block_m, block_k, dtype) combination that has no instantiation.
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
