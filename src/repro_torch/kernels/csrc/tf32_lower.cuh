// The fp32 lower-tile product on the tensor cores (3xTF32), shared by the
// symmetric product (symmul.cu, C = A B) and the SYRK (gram_syrk.cu,
// G = X Xᵀ): mainloop and epilogue of one block, which computes lower tile
// (i, j) of the (m, m) output over a contraction of length k and writes it
// dense (lower tile, and its mirror above the diagonal).
//
// fp32 inputs must keep fp32 accuracy (the reference's 1e-4), which one TF32
// pass (10-bit mantissa) misses, so the products run as 3xTF32: x = big +
// small, both rounded to tf32, and A·B ≈ small_A·big_B + big_A·small_B +
// big_A·big_B in fp32 accumulators.
//
// Design: one block per lower tile (i, j) on grid.x (closed form,
// lt::tile_of), batch on grid.y, one warpgroup per 64 rows of the tile
// (BM = 64: one, several blocks an SM; BM = 128: two).
//   * Loads: thread 0 keeps a ring of kStages TMA copies in flight,
//     completing on one mbarrier a stage.  A's (BM x 32) slice is 128-byte
//     swizzled (K-major, as wgmma reads it).  B's slice depends on the
//     product (template flag SYRK):
//       - symmul: B (k, m) row-major, a (32 x BM) row-major box of map_b;
//       - SYRK: B = Xᵀ, so B's slice is rows j·BM .. j·BM + BM − 1 of X, a
//         box of the same tensor map as A's, already K-major and swizzled.
//         A diagonal tile (i == j) loads one box, which serves both sides.
//     TMA zero-fills boxes past the tensor's edges, so ragged m and k need
//     no masks in the mainloop; it needs 16-byte row strides, so the
//     wrappers pad m (and SYRK's k) to multiples of 4.
//   * Split, rounding explicitly to nearest tf32: each thread loads its A
//     fragment of wgmma's register operand straight from the swizzled slice
//     and splits it in registers.  All threads split B into the block's
//     split buffer {big, small}, K-major and swizzled (tf32 wgmma reads
//     K-major operands only): symmul transposes B's row-major slice (never
//     assuming B symmetric); the SYRK's slice has that layout already, so its
//     split is elementwise, 16 bytes a thread at the same byte offset.
//   * Products: 3 x 4 wgmma m64nBMk8 a 32-wide slice, A from registers, B
//     from shared memory, retired within the slice's own iteration (ptxas
//     reuses the A operand's registers once a wgmma is issued, and a result
//     crossing the loop's back edge makes it serialise the wgmmas).  Blocks
//     sharing an SM (four at BM = 64) overlap one's split with another's
//     products.  The tensor core rounds its fp32 sums toward zero, a bias
//     that grows with the chain, so each slice chains its 12 products in a
//     fresh accumulator that FADD (round to nearest) folds into the tile's
//     sum.
//   * Epilogue: gram_poly (POLY) adds aI + bG to c·acc in fp32 registers,
//     reading G where the GLOBAL row equals the GLOBAL column for the
//     identity.  The lower tile is stored straight from the accumulator
//     fragments (8-byte stores filling 32-byte sectors); its mirror goes
//     through a transposed copy in shared memory and leaves as coalesced
//     16-byte stores.  A diagonal tile keeps its lower half and mirrors it
//     up.
#pragma once

#include "hopper_tf32.cuh"
#include "lower_tiles.cuh"

namespace tc {

template <int BM>
struct Tf32Cfg {
  static constexpr int kBK = 32;                     // one 128-byte swizzle row of fp32
  static constexpr int kThreads = 128 * (BM / 64);  // a warpgroup per 64 rows
  static constexpr int kBlocksPerSM = BM == 128 ? 1 : 4;  // 128 registers at BM = 64
  static constexpr int kStages = BM == 128 ? 3 : 2;  // raw ring
  static constexpr int kTile = BM * kBK * 4;         // bytes of one operand slice
  static constexpr int kRawBytes = kStages * 2 * kTile;
  static constexpr int kSplitOff = kRawBytes;        // one buffer {B big, B small}
  static constexpr int kBarOff = kSplitOff + 2 * kTile;
  static constexpr int kSmem = kBarOff + kStages * 8 + 1024;  // + alignment slack
  static constexpr int kMirrorStride = BM + 4;       // conflict-free transposed writes
  static_assert(BM * kMirrorStride * 4 <= kRawBytes, "mirror staging must fit the ring");
};

template <int BM>
__device__ __forceinline__ void mma_tf32(float (&d)[BM / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);
template <>
__device__ __forceinline__ void mma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int scale_d) {
  hw::wgmma_m64n128k8_tf32_rs(d, a, db, scale_d);
}
template <>
__device__ __forceinline__ void mma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  hw::wgmma_m64n64k8_tf32_rs(d, a, db, scale_d);
}

// symmul: split B's arrived slice ``rb`` (row-major 32 x BM) into ``sp`` =
// {Bᵀ big, Bᵀ small}: row n of Bᵀ holds k = 0 .. 31, 128-byte swizzled
// (K-major, as a tf32 wgmma reads B).  Thread ``tid`` of NT.
template <int BM, int NT>
__device__ __forceinline__ void split_b(const float* rb, unsigned char* sp, int tid) {
  unsigned char* b_small = sp + Tf32Cfg<BM>::kTile;
#pragma unroll
  for (int i = 0; i < BM * 8 / NT; ++i) {
    const int idx = tid + i * NT;
    const int n = idx % BM, kq = idx / BM;  // row n of Bᵀ, k = 4kq .. 4kq + 3
    const float4 x = make_float4(rb[(4 * kq) * BM + n], rb[(4 * kq + 1) * BM + n],
                                 rb[(4 * kq + 2) * BM + n], rb[(4 * kq + 3) * BM + n]);
    const int off = n * 128 + ((kq ^ (n & 7)) * 16);
    float4 hi, lo;
    hw::split_tf32(x, hi, lo);
    *reinterpret_cast<float4*>(sp + off) = hi;
    *reinterpret_cast<float4*>(b_small + off) = lo;
  }
}

// SYRK: split the K-major swizzled slice ``rb`` (BM rows of X by 32) into
// ``sp`` = {big, small} at the same byte offsets: the layout is already the
// one wgmma reads B in, so the split is elementwise, 16 contiguous bytes a
// thread (coalesced, conflict-free, no transpose).
template <int BM, int NT>
__device__ __forceinline__ void split_b_kmajor(const unsigned char* rb, unsigned char* sp,
                                               int tid) {
  unsigned char* b_small = sp + Tf32Cfg<BM>::kTile;
#pragma unroll
  for (int i = 0; i < BM * 8 / NT; ++i) {
    const int off = (tid + i * NT) * 16;
    float4 hi, lo;
    hw::split_tf32(*reinterpret_cast<const float4*>(rb + off), hi, lo);
    *reinterpret_cast<float4*>(sp + off) = hi;
    *reinterpret_cast<float4*>(b_small + off) = lo;
  }
}

// Lower tile (blockIdx.x) of matrix blockIdx.y of the (m, m) output ``out``,
// contraction length kdim: C = A B (symmul: map_a over A, map_b over B, both
// (batch, m, m)) or G = X Xᵀ (SYRK: map_a over X (batch, m, kdim), map_b
// unused).  POLY: the gram_poly epilogue with G = ``g`` (A = B = G).  The
// caller launches Tf32Cfg<BM>::kThreads threads with Tf32Cfg<BM>::kSmem
// bytes of dynamic shared memory.
template <int BM, bool POLY, bool SYRK>
__device__ __forceinline__ void lower_tile_tf32(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                                const float* __restrict__ g,
                                                float* __restrict__ out, int m, int kdim,
                                                float ca, float cb, float cc) {
  using C = Tf32Cfg<BM>;
  constexpr int kNT = C::kThreads;
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  // 1024-byte alignment by an offset from the shared array itself, so every
  // access below stays a shared-memory instruction (LDS/STS), not generic
  unsigned char* smem = smem_dyn + ((1024 - (hw::smem_addr(smem_dyn) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  auto raw_a = [&](int s) { return smem + s * 2 * C::kTile; };
  auto raw_b = [&](int s) { return smem + s * 2 * C::kTile + C::kTile; };
  unsigned char* sp = smem + C::kSplitOff;

  int ti, tj;
  lt::tile_of(blockIdx.x, ti, tj);
  const int bz = blockIdx.y;
  const int nk = (kdim + C::kBK - 1) / C::kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // TMA of slice t into raw stage t % kStages, by thread 0: symmul A[i, t]
  // and B[t, j]; SYRK rows i and j of X (one box on a diagonal tile)
  auto load = [&](int t) {
    const int s = t % C::kStages;
    if constexpr (SYRK) {
      const bool one_box = ti == tj;
      hw::mbar_arrive_expect_tx(&full[s], (one_box ? 1 : 2) * C::kTile);
      hw::tma_load_3d(raw_a(s), &map_a, &full[s], t * C::kBK, ti * BM, bz);
      if (!one_box) hw::tma_load_3d(raw_b(s), &map_a, &full[s], t * C::kBK, tj * BM, bz);
    } else {
      hw::mbar_arrive_expect_tx(&full[s], 2 * C::kTile);
      hw::tma_load_3d(raw_a(s), &map_a, &full[s], t * C::kBK, ti * BM, bz);
      hw::tma_load_3d(raw_b(s), &map_b, &full[s], tj * BM, t * C::kBK, bz);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) hw::mbar_init(&full[s], 1);
    hw::fence_barrier_init();
    for (int t = 0; t < C::kStages && t < nk; ++t) load(t);
  }
  __syncthreads();

  // Warpgroup wg owns rows 64·wg .. 64·wg + 63 of the tile.  A enters the
  // tensor core from registers: each thread loads its fragment (rows ar and
  // ar + 8, k = 8kk + t4 and + 4, for the slice's 4 k-groups) from the
  // swizzled raw slice and splits it there; B is split into shared memory by
  // all threads together.  A slice is retired within its own iteration, and
  // no register is written while its products run: ptxas reuses the
  // registers of wgmma's A operand once the wgmma is issued, and a wgmma
  // result crossing the loop's back edge makes it serialise the wgmmas.
  // Several blocks on an SM overlap one block's split with another's
  // products.  Each slice's 12 products chain in ``part`` on the tensor
  // core, which rounds its sums toward zero; the slices are summed in
  // ``acc`` by FADD (round to nearest), so that bias spans 12 steps, not
  // 12·kdim/32.
  const int wg = threadIdx.x / 128;
  const int ar = wg * 64 + (warp % 4) * 16 + lane / 4, t4 = lane % 4;
  float acc[BM / 2], part[BM / 2];
  uint32_t a_big[4][4], a_small[4][4];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = part[i] = 0.0f;

  for (int t = 0; t < nk; ++t) {
    const int s = t % C::kStages;
    hw::mbar_wait(&full[s], (t / C::kStages) & 1);
    const unsigned char* ra = raw_a(s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int v = 0; v < 4; ++v) {  // fragment register v: row + 8(v & 1), k + 4(v >> 1)
        const int r = ar + 8 * (v & 1), k = 8 * kk + t4 + 4 * (v >> 1);
        const float x = *reinterpret_cast<const float*>(
            ra + r * 128 + (((k >> 2) ^ (r & 7)) << 4) + (k & 3) * 4);
        const float big = hw::tf32_rna(x);
        a_big[kk][v] = __float_as_uint(big);
        a_small[kk][v] = __float_as_uint(hw::tf32_rna(x - big));
      }
    if constexpr (SYRK)
      split_b_kmajor<BM, kNT>(ti == tj ? ra : raw_b(s), sp, threadIdx.x);
    else
      split_b<BM, kNT>(reinterpret_cast<const float*>(raw_b(s)), sp, threadIdx.x);
    hw::fence_proxy_async();
    // every thread has read raw stage s and written its part of the split
    __syncthreads();
    if (threadIdx.x == 0 && t + C::kStages < nk) load(t + C::kStages);

    const uint64_t b_big = hw::desc_sw128(sp);
    const uint64_t b_small = hw::desc_sw128(sp + C::kTile);
    hw::fence_operands(part);
    hw::fence_operands(a_big);
    hw::fence_operands(a_small);
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kBK / 8; ++kk)  // small terms first; the first overwrites part
      mma_tf32<BM>(part, a_small[kk], b_big + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < C::kBK / 8; ++kk)
      mma_tf32<BM>(part, a_big[kk], b_small + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < C::kBK / 8; ++kk) mma_tf32<BM>(part, a_big[kk], b_big + 2 * kk, 1);
    hw::wgmma_commit();
    hw::wgmma_wait<0>();
    hw::fence_operands(part);
    hw::fence_operands(a_big);
    hw::fence_operands(a_small);
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] += part[i];
    __syncthreads();  // every warpgroup's products have read the split buffer
  }

  // ---- epilogue.  Fragment of m64nBM: acc[4j + 2h + e] is local row
  // ar + 8h, local column lc + 8j + e.
  const int lc = 2 * t4;
  const int r0 = ti * BM, c0 = tj * BM;
  const bool diag = (ti == tj);
  const size_t off = (size_t)bz * m * m;
  float* ob = out + off;
  const float* gb = g + off;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + ar + 8 * h, c = c0 + lc + 8 * j;  // m % 4 == 0: c < m => c + 1 < m
      float& v0 = acc[4 * j + 2 * h];
      float& v1 = acc[4 * j + 2 * h + 1];
      if (POLY) {
        const float2 gv = (r < m && c < m)
                              ? *reinterpret_cast<const float2*>(gb + (size_t)r * m + c)
                              : make_float2(0.0f, 0.0f);
        v0 = ca * (r == c ? 1.0f : 0.0f) + cb * gv.x + cc * v0;
        v1 = ca * (r == c + 1 ? 1.0f : 0.0f) + cb * gv.y + cc * v1;
      }
      if (r < m && c < m) {
        if (!diag || c + 1 <= r)
          *reinterpret_cast<float2*>(ob + (size_t)r * m + c) = make_float2(v0, v1);
        else if (c <= r)
          ob[(size_t)r * m + c] = v0;
      }
    }

  // Mirror: output (c0 + rr, r0 + cc) takes the lower element (r0 + cc, c0 + rr).
  // The raw ring is free: every stage was consumed before the last barrier.
  constexpr int S = C::kMirrorStride;
  float* tt = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tt[(lc + 8 * j) * S + ar + 8 * h] = acc[4 * j + 2 * h];
      tt[(lc + 8 * j + 1) * S + ar + 8 * h] = acc[4 * j + 2 * h + 1];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BM / 4; idx += kNT) {
    const int rr = idx / (BM / 4), q = idx % (BM / 4);
    const int gr = c0 + rr, gc = r0 + 4 * q;
    if (gr >= m || gc >= m) continue;
    const float4 v = *reinterpret_cast<const float4*>(tt + rr * S + 4 * q);
    float* dst = ob + (size_t)gr * m + gc;
    if (!diag) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      if (4 * q > rr) dst[0] = v.x;
      if (4 * q + 1 > rr) dst[1] = v.y;
      if (4 * q + 2 > rr) dst[2] = v.z;
      if (4 * q + 3 > rr) dst[3] = v.w;
    }
  }
}

}  // namespace tc
