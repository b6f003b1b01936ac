// Split-precision fp32 products on the bf16 tensor cores, shared by the fp32
// attention kernels (fp32_attention.cu, fp32_attention_bwd.cu).
//
// Hopper has no fp32 tensor-core product. An fp32 value x splits exactly
// into three bf16 pieces,
//   h = bf16(x),  m = bf16(x - h),  l = bf16(x - h - m),  x = h + m + l,
// each subtraction exact in fp32 (x - h has at most 16 significant bits,
// x - h - m at most 8, which bf16 holds), for every normal x whose pieces
// stay normal (|x| >= 2^-102; the rank mask's p spans 2^-100 .. 2^100). A
// product a.b is then the sum of the nine piece products; the six kept
// here (hh, hm, mh, hl, lh, mm: "bf16x6", the TPU's own route for an fp32
// product at HIGHEST precision) leave out ml, lm and ll, each at most
// 2^-24 |a||b|, the size of fp32's own rounding. Every piece product is
// exact in the tensor core's fp32 accumulator (8 x 8 significant bits).
// The tensor core adds them with its own rounding (not fp32 round to
// nearest), so each kernel sums a tile's products into a fresh
// accumulator, the correction products first and hh last, and adds the
// tile's sum to its running sums in fp32 on the CUDA cores: no chain of
// tensor-core additions grows with the length of a row.
//
// Tiles: an fp32 operand tile arrives by TMA into a staging tile (below),
// and `split_tile_sw` turns it into three bf16 piece tiles in the
// core-matrix layout (attention_common.cuh), which the bf16 kernels'
// descriptors (K-major and MN-major) read as they are. A register operand
// (Q's and dO's A fragments, P, P^T, dS, dS^T) splits in registers.
#pragma once

#include <cuda.h>

#include "attention_common.cuh"

namespace vgt {

// The pieces of a kept product, A's piece and B's piece (0 h, 1 m, 2 l),
// correction products first, hh last.
constexpr int kSplitProducts = 6;
__host__ __device__ constexpr int split_a(int p) {
  return p == 0 ? 2 : p == 1 ? 0 : p == 2 ? 1 : p == 3 ? 1 : 0;
}
__host__ __device__ constexpr int split_b(int p) {
  return p == 0 ? 0 : p == 1 ? 2 : p == 2 ? 1 : p == 3 ? 0 : p == 4 ? 1 : 0;
}

// The three bf16 pieces of (x0, x1), each packed as a b32 (x0 in the low
// half).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& h,
                                           uint32_t& m, uint32_t& l) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(hb);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 mb = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(mb);
  const __nv_bfloat162 lb = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  h = *reinterpret_cast<const uint32_t*>(&hb);
  m = *reinterpret_cast<const uint32_t*>(&mb);
  l = *reinterpret_cast<const uint32_t*>(&lb);
}

// The A fragment over 16 columns of an accumulator (its 8 values at d, as
// acc_to_a reads them), split: a[piece][0..3].
__device__ __forceinline__ void split_frag(uint32_t (&a)[3][4],
                                           const float* d) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split_pair(d[2 * e], d[2 * e + 1], a[0][e], a[1][e], a[2][e]);
}

// ---- fp32 tiles by TMA --------------------------------------------------
//
// A TMA box of 32 floats (128 bytes) x ROWS rows lands in the 128-byte
// swizzle: 16-byte chunk j of box row r at r 128 + 16 (j ^ (r % 8)), the
// box starting on a 1024-byte boundary; a tile of DP head dims is DP / 32
// boxes one after another. Rows past the operand's length and head dims
// past head_dim land as zeros. The swizzle puts the 8 rows that a
// quarter-warp of `split_tile_sw` reads at one chunk in 8 bank quads.

// The float at (row r, head dim c) of such a tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ const float* sw128_at(const float* tile, int r,
                                                 int c) {
  return tile + (c >> 5) * ROWS * 32 + r * 32 +
         ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// Split the swizzled tile `stg` (ROWS x DP) into the three core-matrix
// piece tiles at `pieces` (piece k at pieces + k ROWS DP; 16-byte chunk i
// of a piece at byte 16 i). NT threads.
template <int ROWS, int NT, int DP>
__device__ __forceinline__ void split_tile_sw(const float* stg, bf16* pieces,
                                              int tid) {
  constexpr int kRowChunks = DP / 8;
  constexpr int kGroupChunks = 8 * kRowChunks;
  for (int i = tid; i < ROWS * kRowChunks; i += NT) {
    const int grp = i / kGroupChunks, w = i % kGroupChunks;
    const int r = grp * 8 + (w & 7), c = (w >> 3) * 8;
    const float4 a = *reinterpret_cast<const float4*>(sw128_at<ROWS>(stg, r, c));
    const float4 b =
        *reinterpret_cast<const float4*>(sw128_at<ROWS>(stg, r, c + 4));
    uint4 h, m, l;
    split_pair(a.x, a.y, h.x, m.x, l.x);
    split_pair(a.z, a.w, h.y, m.y, l.y);
    split_pair(b.x, b.y, h.z, m.z, l.z);
    split_pair(b.z, b.w, h.w, m.w, l.w);
    *reinterpret_cast<uint4*>(pieces + 8 * i) = h;
    *reinterpret_cast<uint4*>(pieces + ROWS * DP + 8 * i) = m;
    *reinterpret_cast<uint4*>(pieces + 2 * ROWS * DP + 8 * i) = l;
  }
}

// The DP / 32 boxes of one ROWS x DP tile of `map` at (row, head, batch)
// into `dst`, completing on `bar` (one thread; the caller arms `bar` with
// the tile's ROWS DP 4 bytes).
template <int ROWS, int DP>
__device__ __forceinline__ void tma_tile_f32(float* dst, const void* map,
                                             uint64_t* bar, int row, int head,
                                             int batch) {
#pragma unroll
  for (int at = 0; at < DP / 32; ++at)
    tma_load_4d(dst + at * ROWS * 32, map, bar, 32 * at, row, head, batch);
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links no -lcuda).
using F32EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                    cuuint32_t, void*, const cuuint64_t*,
                                    const cuuint64_t*, const cuuint32_t*,
                                    const cuuint32_t*, CUtensorMapInterleave,
                                    CUtensorMapSwizzle,
                                    CUtensorMapL2promotion,
                                    CUtensorMapFloatOOBfill);

inline F32EncodeTiled f32_encode_tiled() {
  static const F32EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<F32EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of an fp32 operand [B][H][L][head_dim] at `base` (element strides
// sb, sh, sl along batch, head and row): boxes of 32 head dims x `rows`
// rows in the 128-byte swizzle; rows past L and head dims past head_dim
// read as 0.
inline CUresult encode_f32_operand(CUtensorMap* m, const void* base,
                                   int batch, int heads, int len,
                                   int head_dim, long long sb, long long sh,
                                   long long sl, int rows) {
  const F32EncodeTiled encode = f32_encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 4,
                                 static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// d (64 x 32, fp32) += A (64 x 16, K-major, shared) . B (16 x 32, K-major
// shared: the tile's rows are the 32 columns of d).
__device__ __forceinline__ void wgmma_64x32_ss(float (&d)[16], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, registers) . B (16 x 32, K-major shared:
// the tile's rows are the 32 columns of d).
__device__ __forceinline__ void wgmma_64x32_rs(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N, fp32) += A . B^T, both K-major in shared memory, N 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 64)
    wgmma_64x64_ss(d, da, db, 1);
  else
    wgmma_64x32_ss(d, da, db);
}

// d (64 x N) += A . B^T over a head width DP as the six kept piece
// products: A's pieces `a` ([3][64][DP] core-matrix tiles, rows M), B's
// pieces `b` ([3][N][DP], rows N), the reduction over the head dims.
template <int DP, int N>
__device__ __forceinline__ void split_product_ss(float (&d)[N / 2],
                                                 const bf16* a, const bf16* b) {
#pragma unroll
  for (int p = 0; p < kSplitProducts; ++p)
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<N>(d, desc_k_major_dp<DP>(a + split_a(p) * 64 * DP, kk),
                  desc_k_major_dp<DP>(b + split_b(p) * N * DP, kk));
}

// d (64 x 32) += A . B^T over a head width DP as the six kept piece
// products: A's pieces in registers (a[piece][step][4], the A fragments of
// head dims 16 step ..), B's pieces `b` ([3][32][DP] core-matrix tiles,
// K-major: rows the 32 columns of d).
template <int DP>
__device__ __forceinline__ void split_product_rs_k(
    float (&d)[16], const uint32_t (&a)[3][DP / 16][4], const bf16* b) {
#pragma unroll
  for (int p = 0; p < kSplitProducts; ++p)
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_64x32_rs(d, a[split_a(p)][kk],
                     desc_k_major_dp<DP>(b + split_b(p) * 32 * DP, kk));
}

// d (64 x DP) += A . B over a reduction of 16 R rows as the six kept piece
// products: A's pieces in registers (a[piece][step][4]), B's pieces `b`
// ([3][16 R][DP] core-matrix tiles, MN-major: rows the reduction).
template <int DP, int R>
__device__ __forceinline__ void split_product_rs(float (&d)[DP / 2],
                                                 const uint32_t (&a)[3][R][4],
                                                 const bf16* b) {
#pragma unroll
  for (int p = 0; p < kSplitProducts; ++p)
#pragma unroll
    for (int j = 0; j < R; ++j)
      wgmma_pv<DP>(d, a[split_a(p)][j],
                   desc_mn_major_dp<DP>(b + split_b(p) * 16 * R * DP, j));
}

// Keep the compiler from reusing the registers of split A fragments that
// an asynchronous product still reads.
template <int R>
__device__ __forceinline__ void fence_split_frags(uint32_t (&a)[3][R][4]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][j][e])::"memory");
}

}  // namespace vgt
