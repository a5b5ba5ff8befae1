// The bf16 lower-tile product on the tensor cores, shared by the symmetric
// product (symmul.cu, C = A B) and the SYRK (gram_syrk.cu, G = X Xᵀ): the
// mainloop and epilogue of one block, which computes lower tile (i, j) of
// the (m, m) output over a contraction of length k with fp32 accumulation
// and writes it dense (lower tile, and its mirror above the diagonal), in
// bf16 or fp32.
//
// Bound on the card: operations.  A bf16 product is one wgmma pass (no
// operand split), and a lower tile reads BM·256 bytes of operands per
// 64-deep slice for 2·BM²·64 FLOPs, far above the H100's ridge.  What
// keeps the tensor cores busy is the supply of operands from L2 to shared
// memory: the design takes the largest square tile the registers allow,
// orders the tiles for L2 reuse and keeps several slices in flight.
//
// Design: one block per lower tile (i, j) on grid.x, batch on grid.y; BM / 64
// consumer warpgroups (64 rows of the tile each) and one producer warp, one
// block an SM.
//   * Tile: BM = 192 (three warpgroups, wgmma m64n192k16, 96 accumulators a
//     thread) reads 48 KB of operands per 4.7 MFLOP slice, a third less a
//     product than BM = 128 (32 KB per 2.1 MFLOP), which took 1.35-1.52x
//     its time at nemotron-4-340b's m = 18432 and 2.4x at the 73728-long
//     SYRK (chip_smoke.py's blocks phase on an H100); BM = 128 stays for
//     grids that 192-row tiles leave short of one block an SM (m = 1536:
//     78 tiles against 36).
//   * Tile order: grid.x runs the lower tiles in groups of kGroup block rows,
//     column by column inside a group (lt::grouped_tile_of), so the blocks
//     in flight share their row and column panels through L2.  In row-major
//     order each block in flight streams its own column panel from device
//     memory: 197 GB for nemotron-4-340b's (18432, 73728) SYRK, 59 ms at
//     3.35 TB/s against its 25 ms of products.
//   * Loads: lane 0 of the producer warp keeps a ring of kStages slices in
//     flight by TMA, each completing on its stage's ``full`` mbarrier; it
//     refills a stage once every consumer warp has arrived on its ``empty``
//     mbarrier.  A slice is 64 bf16 of the contraction, one 128-byte swizzle
//     row.  A's slice is rows i·BM .. i·BM + BM − 1, K-major.  B's slice
//     depends on the product (template flag SYRK):
//       - SYRK: B = Xᵀ, so B's slice is rows j·BM .. of X, a box of the same
//         tensor map, K-major.  A diagonal tile (i == j) loads one box,
//         which serves both sides.
//       - symmul: B (k, m) is read as it lies, row-major: its slice is
//         BM / 64 boxes of 64 rows of the contraction by 64 columns, each
//         one MN-major swizzle atom column, 8 KB apart; wgmma reads it
//         with its B transpose bit set.  Nothing assumes B symmetric.
//     TMA zero-fills boxes past the tensor's edges, so ragged m and k need
//     no masks in the mainloop; it needs 16-byte row strides, so the
//     wrappers pad m (and the SYRK's k) to multiples of 8.
//   * Products: per slice, four wgmma m64nBMk16 a warpgroup, both operands
//     from shared memory, committed as one group.  One group stays in
//     flight (wgmma_wait<1>): the products of slice t run while the warps
//     wait for slice t + 1, and slice t − 1's stage is released only after
//     its products have retired.
//   * Accumulation: the tensor core adds each 16-deep product into the fp32
//     accumulator rounding toward zero, so the chain's error grows with
//     its length: at most k/16 · 2⁻²³ of the largest partial sum, 5.5e-4 at
//     nemotron-4-340b's k = 73728.  bf16 products are held to 2⁻⁷ of the
//     output's scale (chip_smoke.py's BF16_GATE), and the output's own
//     rounding to bf16 is up to 2⁻⁹, so the chain runs unfolded in one
//     accumulator.  (The fp32 path folds each slice's chain by FADD,
//     tf32_lower.cuh, because its gate is 5e-6.)
//   * Epilogue: gram_poly (POLY) forms aI + bG + c·acc in fp32 registers
//     from the bf16 G, reading G where the GLOBAL row equals the GLOBAL
//     column for the identity.  The lower tile is stored straight from the
//     accumulator fragments; its mirror goes through a transposed fp32 copy
//     in shared memory (the ring, free by then) and leaves as 4-wide stores.
//     A diagonal tile keeps its lower half and mirrors it up.
#pragma once

#include <cuda_bf16.h>

#include "hopper_tf32.cuh"
#include "lower_tiles.cuh"

namespace bf {

template <int BM>
struct Bf16Cfg {
  static constexpr int kGroup = 8;                        // block rows a tile group
  static constexpr int kBK = 64;                          // one 128-byte swizzle row of bf16
  static constexpr int kConsumers = BM / 64;             // warpgroups, 64 rows each
  static constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp
  static constexpr int kStages = BM == 192 ? 4 : 6;       // a 192 KB ring either way
  static constexpr int kTile = BM * kBK * 2;             // bytes of one operand slice
  static constexpr int kAtom = 64 * kBK * 2;             // one MN-major atom column (8 KB)
  static constexpr int kStage = 2 * kTile;                // A's slice, then B's
  static constexpr int kBarOff = kStages * kStage;        // full[kStages], empty[kStages]
  static constexpr int kSmem = kBarOff + 2 * kStages * 8 + 1024;  // + alignment slack
  static constexpr int kMirrorStride = BM + 4;            // conflict-free transposed writes
  // symmul's B descriptor (MN-major): atom columns kAtom apart, eight rows
  // of the contraction 1024 bytes apart
  static constexpr uint32_t kLboMN = kAtom, kSboMN = 1024;
  static_assert(BM == 128 || BM == 192, "wgmma m64nBMk16 is instantiated for 128 and 192");
  static_assert(BM * kMirrorStride * 4 <= kBarOff, "mirror staging must fit the ring");
  static_assert(kSmem <= 232448, "a block's shared memory");
};

template <int BM, int TRANS_B>
__device__ __forceinline__ void mma_bf16(float (&d)[BM / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void mma_bf16<128, 0>(float (&d)[64], uint64_t da, uint64_t db) {
  hw::wgmma_m64n128k16_bf16_ss<0>(d, da, db, 1);
}
template <>
__device__ __forceinline__ void mma_bf16<128, 1>(float (&d)[64], uint64_t da, uint64_t db) {
  hw::wgmma_m64n128k16_bf16_ss<1>(d, da, db, 1);
}
template <>
__device__ __forceinline__ void mma_bf16<192, 0>(float (&d)[96], uint64_t da, uint64_t db) {
  hw::wgmma_m64n192k16_bf16_ss<0>(d, da, db, 1);
}
template <>
__device__ __forceinline__ void mma_bf16<192, 1>(float (&d)[96], uint64_t da, uint64_t db) {
  hw::wgmma_m64n192k16_bf16_ss<1>(d, da, db, 1);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// Lower tile (blockIdx.x) of matrix blockIdx.y of the (m, m) output ``out``,
// contraction length kdim: C = A B (symmul: map_a over A, map_b over B, both
// (batch, m, m) bf16) or G = X Xᵀ (SYRK: map_a over X (batch, m, kdim),
// map_b unused).  POLY: the gram_poly epilogue with G = ``g`` (A = B = G).
// The caller launches Bf16Cfg<BM>::kThreads threads with Bf16Cfg<BM>::kSmem
// bytes of dynamic shared memory.
template <int BM, bool POLY, bool SYRK, typename O>
__device__ __forceinline__ void lower_tile_bf16(const CUtensorMap& map_a, const CUtensorMap& map_b,
                                                const __nv_bfloat16* __restrict__ g,
                                                O* __restrict__ out, int m, int kdim, float ca,
                                                float cb, float cc) {
  using C = Bf16Cfg<BM>;
  extern __shared__ __align__(1024) unsigned char smem_dyn[];
  // 1024-byte alignment by an offset from the shared array itself, so every
  // access below stays a shared-memory instruction (LDS/STS), not generic
  unsigned char* smem = smem_dyn + ((1024 - (hw::smem_addr(smem_dyn) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  auto stage_a = [&](int s) { return smem + s * C::kStage; };
  auto stage_b = [&](int s) { return smem + s * C::kStage + C::kTile; };

  int ti, tj;
  lt::grouped_tile_of(blockIdx.x, (m + BM - 1) / BM, C::kGroup, ti, tj);
  const int bz = blockIdx.y;
  const bool diag = (ti == tj);
  const int nk = (kdim + C::kBK - 1) / C::kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;  // consumer warpgroup; kConsumers for the producer warp

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 4 * C::kConsumers);  // one arrival a consumer warp
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;

  if (wg == C::kConsumers) {
    // producer: slice t into stage t % kStages once the consumers released
    // slice t − kStages there
    if (lane == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % C::kStages;
        if (t >= C::kStages) hw::mbar_wait(&empty[s], ((t / C::kStages) - 1) & 1);
        const int k0 = t * C::kBK;
        if constexpr (SYRK) {
          hw::mbar_arrive_expect_tx(&full[s], (diag ? 1 : 2) * C::kTile);
          hw::tma_load_3d(stage_a(s), &map_a, &full[s], k0, ti * BM, bz);
          if (!diag) hw::tma_load_3d(stage_b(s), &map_a, &full[s], k0, tj * BM, bz);
        } else {
          hw::mbar_arrive_expect_tx(&full[s], 2 * C::kTile);
          hw::tma_load_3d(stage_a(s), &map_a, &full[s], k0, ti * BM, bz);
#pragma unroll
          for (int h = 0; h < BM / 64; ++h)
            hw::tma_load_3d(stage_b(s) + h * C::kAtom, &map_b, &full[s], tj * BM + 64 * h, k0, bz);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64·wg .. 64·wg + 63 of the tile
    for (int t = 0; t < nk; ++t) {
      const int s = t % C::kStages;
      hw::mbar_wait(&full[s], (t / C::kStages) & 1);
      const uint64_t da = hw::desc_sw128(stage_a(s) + wg * 64 * 128);
      hw::fence_operands(acc);
      hw::wgmma_fence();
      if constexpr (SYRK) {
        const uint64_t db = hw::desc_sw128(diag ? stage_a(s) : stage_b(s));
#pragma unroll
        for (int kk = 0; kk < C::kBK / 16; ++kk) mma_bf16<BM, 0>(acc, da + 2 * kk, db + 2 * kk);
      } else {
        const uint64_t db = hw::desc_sw128_mn(stage_b(s), C::kLboMN, C::kSboMN);
#pragma unroll
        for (int kk = 0; kk < C::kBK / 16; ++kk)  // 16 rows of B's slice: 2048 bytes
          mma_bf16<BM, 1>(acc, da + 2 * kk, db + 128 * kk);
      }
      hw::wgmma_commit();
      hw::wgmma_wait<1>();
      hw::fence_operands(acc);
      // slice t − 1's products have retired: its stage may be refilled
      if (t > 0 && lane == 0) hw::mbar_arrive(&empty[(t - 1) % C::kStages]);
    }
    hw::wgmma_wait<0>();
    hw::fence_operands(acc);
  }
  __syncthreads();  // every product has retired: the ring is free

  // ---- epilogue.  Fragment of m64nBM: acc[4j + 2h + e] is local row
  // ar + 8h, local column lc + 8j + e.
  constexpr int S = C::kMirrorStride;
  float* tt = reinterpret_cast<float*>(smem);
  const int r0 = ti * BM, c0 = tj * BM;
  const size_t off = (size_t)bz * m * m;
  O* ob = out + off;
  if (wg < C::kConsumers) {
    const int ar = wg * 64 + (warp % 4) * 16 + lane / 4, lc = 2 * (lane % 4);
    const __nv_bfloat16* gb = g + off;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + ar + 8 * h, c = c0 + lc + 8 * j;  // m % 8 == 0: c < m => c + 1 < m
        float v0 = acc[4 * j + 2 * h];
        float v1 = acc[4 * j + 2 * h + 1];
        if (POLY) {
          const float2 gv =
              (r < m && c < m)
                  ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gb + (size_t)r * m + c))
                  : make_float2(0.0f, 0.0f);
          v0 = ca * (r == c ? 1.0f : 0.0f) + cb * gv.x + cc * v0;
          v1 = ca * (r == c + 1 ? 1.0f : 0.0f) + cb * gv.y + cc * v1;
        }
        if (r < m && c < m) {
          if (!diag || c + 1 <= r)
            store2(ob + (size_t)r * m + c, v0, v1);
          else if (c <= r)
            ob[(size_t)r * m + c] = lt::from_f32<O>(v0);
        }
        tt[(lc + 8 * j) * S + ar + 8 * h] = v0;
        tt[(lc + 8 * j + 1) * S + ar + 8 * h] = v1;
      }
  }
  __syncthreads();

  // Mirror: output (c0 + rr, r0 + cc) takes the lower element (r0 + cc, c0 + rr).
  for (int idx = threadIdx.x; idx < BM * BM / 4; idx += C::kThreads) {
    const int rr = idx / (BM / 4), q = idx % (BM / 4);
    const int gr = c0 + rr, gc = r0 + 4 * q;
    if (gr >= m || gc >= m) continue;
    const float4 v = *reinterpret_cast<const float4*>(tt + rr * S + 4 * q);
    O* dst = ob + (size_t)gr * m + gc;
    if (!diag) {
      store4(dst, v);
    } else {
      if (4 * q > rr) dst[0] = lt::from_f32<O>(v.x);
      if (4 * q + 1 > rr) dst[1] = lt::from_f32<O>(v.y);
      if (4 * q + 2 > rr) dst[2] = lt::from_f32<O>(v.z);
      if (4 * q + 3 > rr) dst[3] = lt::from_f32<O>(v.w);
    }
  }
}

}  // namespace bf
