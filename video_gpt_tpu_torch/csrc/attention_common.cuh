// Shared pieces of the hand-written Hopper attention kernels: tile sizes,
// the bf16 tensor-core product (mma.sync m16n8k16, fp32 accumulate),
// fragment loads from shared memory, wgmma, and the mbarriers and TMA
// tensor maps of the producer / consumer kernels (K1, K6, P1).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16 inputs); g = lane / 4,
// t = lane % 4:
//   A 16x16 row-major, 4 x b32:  a0 (row g,   cols 2t..2t+1)
//                                a1 (row g+8, cols 2t..2t+1)
//                                a2 (row g,   cols 2t+8..2t+9)
//                                a3 (row g+8, cols 2t+8..2t+9)
//   B 16x8 "col", 2 x b32:       b0 (rows 2t..2t+1,   col g)
//                                b1 (rows 2t+8..2t+9, col g)
//   C 16x8 fp32, 4 x f32:        c0,c1 (row g,   cols 2t..2t+1)
//                                c2,c3 (row g+8, cols 2t..2t+1)
// The lower half of each b32 holds the element with the smaller index. Two
// neighbouring C tiles (keys n..n+7, n+8..n+15) are exactly one A fragment
// over those 16 keys, so softmax probabilities feed P.V without leaving
// registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vgt {

using bf16 = __nv_bfloat16;

// Every attention kernel, forward (K1/K2, K3, K6, the fp32 kernel) and
// backward (K7, K9, the fp32 backward), is a template on the padded head
// width DP, one instance per padded_head_dim, the head dims from the true
// head_dim to DP zero-filled on load.
constexpr int kMaxHeadDim = 128;

// The head width a kernel instance is laid out for: the least of 32, 64,
// 96, 128 that holds head_dim (whole 32-dim swizzle atoms); 0 for a
// head_dim the kernels do not take (not a multiple of 8: 16-byte rows).
__host__ __device__ constexpr int padded_head_dim(int d) {
  return d <= 0 || d > kMaxHeadDim || d % 8 ? 0 : (d + 31) / 32 * 32;
}
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kNever = 1 << 30;       // rank/offset sentinel of the masks

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows_valid` rows of D bf16 (row stride `row_stride` elements) into
// a [ROWS][LDS] shared tile, zero-filling the rows past `rows_valid`.
// 16-byte loads: the wrapper checks that pointers and strides allow them.
template <int D, int ROWS, int LDS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride,
                                          int rows_valid) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid)
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

// A fragment of the 16x16 block whose top-left element is s[0].
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int lds,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p0 = s + g * lds + 2 * t;
  const bf16* p1 = p0 + 8 * lds;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment of K^T for S = Q.K^T: s points at K[key n0][dim k0] of a
// row-major [key][dim] tile; B[k][n] = K[n0 + n][k0 + k].
__device__ __forceinline__ void load_b_kt(uint32_t& b0, uint32_t& b1,
                                          const bf16* s, int lds, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + g * lds + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment of V for O += P.V: s points at V[key k0][dim n0] of a
// row-major [key][dim] tile; B[k][n] = V[k0 + k][n0 + n].
__device__ __forceinline__ void load_b_v(uint32_t& b0, uint32_t& b1,
                                         const bf16* s, int lds, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* p = reinterpret_cast<const uint16_t*>(s) + 2 * t * lds + g;
  b0 = uint32_t(p[0]) | (uint32_t(p[lds]) << 16);
  b1 = uint32_t(p[8 * lds]) | (uint32_t(p[9 * lds]) << 16);
}

// Sum or max over the four lanes (one quad) that share an accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// ---- Hopper: asynchronous copies and warpgroup products (wgmma) -----------
//
// One warpgroup (the block's 4 warps) runs each wgmma: a 64-row product
// with B, and A unless it comes from registers, read from shared memory
// through a descriptor. The accumulator of m64nNk16 is, per warp w of the
// group, the mma.m16n8k16 C layout of rows 16w..16w+15 repeated over the N/8
// column tiles: d[4n + e] is the C element e of column tile n. The A
// register fragment is the mma.m16n8k16 A fragment of the warp's 16 rows,
// so two neighbouring column tiles of an accumulator are one A fragment
// over those 16 columns, as with mma.sync.
//
// Operand tiles live in shared memory in the layout wgmma reads without a
// swizzle: 8x8 "core matrices" of 128 contiguous bytes (8 rows of 16 bytes,
// 8 bf16 of the head dim each), the DP / 8 core matrices of an 8-row group
// one after another along the head dim, then the next 8-row group. So
// 16-byte chunk i of a [rows][DP] tile lies at byte 16 i (async_copy_tile),
// and the same tile serves as a K-major operand (its rows are M or N, the
// head dim is the reduction) and as an MN-major one (its rows are the
// reduction, the head dim is N).

constexpr int kCoreBytes = 128;                          // one 8x8 core matrix
// 8 rows of a [rows][DP] tile
template <int DP>
__host__ __device__ constexpr int group_bytes() {
  return kCoreBytes * DP / 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-fills the destination when
// `valid` is false (the source is then not read).
__device__ __forceinline__ void async_copy16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-fills when `valid` is false.
__device__ __forceinline__ void async_copy4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes visible to wgmma (the async
// proxy); a barrier after it publishes them to the whole warpgroup.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy the ROWS x DP bf16 tile at `src` (row stride `row_stride`
// elements, 16-byte aligned rows) into `dst` in the core-matrix layout,
// zero-filling rows from `rows_valid` on; with kPadded also the head dims
// from `cols` (head_dim, a multiple of 8) to DP. Without it the operand's
// head_dim is DP and `cols` is not read. NT threads, this one `tid`.
template <int ROWS, int NT, int DP, bool kPadded>
__device__ __forceinline__ void async_copy_tile_dp(bf16* dst,
                                                 const bf16* src,
                                                 long long row_stride,
                                                 int rows_valid, int cols,
                                                 int tid) {
  constexpr int kRowChunks = DP / 8;
  constexpr int kGroupChunks = 8 * kRowChunks;
  for (int i = tid; i < ROWS * kRowChunks; i += NT) {
    const int grp = i / kGroupChunks, w = i % kGroupChunks;
    const int r = grp * 8 + (w & 7), c = (w >> 3) * 8;
    const bool ok = r < rows_valid && (!kPadded || c < cols);
    async_copy16(dst + i * 8, src + (ok ? r * row_stride + c : 0), ok);
  }
}

// Shared-memory matrix descriptor without swizzle: start address, the byte
// offset between core matrices along the reduction (lbo) and along M or N
// (sbo).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// A core-matrix [rows][DP] tile as a K-major operand (rows M or N, head
// dim the reduction), at reduction step kk (head dims 16 kk .. 16 kk + 15).
template <int DP>
__device__ __forceinline__ uint64_t desc_k_major_dp(const bf16* tile,
                                                    int kk) {
  return wgmma_desc(reinterpret_cast<const char*>(tile) + 2 * kk * kCoreBytes,
                    kCoreBytes, group_bytes<DP>());
}

// A core-matrix [rows][DP] tile as the MN-major B operand (rows the
// reduction, head dim N), at reduction step j (rows 16 j .. 16 j + 15).
template <int DP>
__device__ __forceinline__ uint64_t desc_mn_major_dp(const bf16* tile,
                                                     int j) {
  return wgmma_desc(
      reinterpret_cast<const char*>(tile) + 2 * j * group_bytes<DP>(),
      group_bytes<DP>(), kCoreBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous products that write them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16, K-major, shared) . B (16 x 64, K-major
// shared: the tile's rows are the 64 columns of d); scale_d 0 overwrites.
__device__ __forceinline__ void wgmma_64x64_ss(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 96, fp32) += A (64 x 16, registers) . B (16 x 96, MN-major
// shared: the tile's rows are the reduction, the head dim the columns).
__device__ __forceinline__ void wgmma_64x96_rs(float (&d)[48],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N, fp32) += A (64 x 16, registers) . B (16 x N, MN-major shared:
// the tile's rows are the reduction, the head dim the columns): P.V at a
// padded head width N of 32, 64, 96 or 128.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_64x96_rs(d, a, db);
}

// d (64 x 64, fp32) (+)= A (64 x 16, registers) . B (16 x 64, K-major
// shared: the tile's rows are the 64 columns of d); scale_d 0 overwrites.
__device__ __forceinline__ void wgmma_64x64_rs(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The A fragment over columns 16 j .. 16 j + 15 of a 64-column
// accumulator, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* d) {
  a[0] = pack_bf16(d[0], d[1]);
  a[1] = pack_bf16(d[2], d[3]);
  a[2] = pack_bf16(d[4], d[5]);
  a[3] = pack_bf16(d[6], d[7]);
}

// Keep the compiler from reusing the registers of an A fragment that an
// asynchronous product still reads.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// ---- Hopper: mbarriers, TMA and 64-byte-swizzled tiles ----------------------
//
// A producer fills a ring of shared-memory stages and consumers drain it,
// each stage guarded by two mbarriers: "full" (the stage's data has landed)
// and "empty" (every consumer is done with it). A waiter tracks the phase
// parity of each barrier: the first wait on "full" passes at parity 0 once
// the stage is filled; the producer's first wait on "empty" uses parity 1,
// which a fresh barrier reports complete.
//
// A [64 rows][DP] bf16 tile is kept in wgmma's 64-byte swizzle: DP / 32
// "atoms" of 32 head dims (64 rows x 64 bytes = 4 KB, one after another),
// each row of an atom its four 16-byte chunks in the order c ^ ((row / 2) %
// 4). A TMA box of 32 x 64 with CU_TENSOR_MAP_SWIZZLE_64B writes one atom;
// the same tile serves as a K-major operand (its rows are N, the head dim
// the reduction) and as an MN-major one (its rows the reduction, the head
// dim N). The stage must start on a 512-byte boundary. Head dims past the
// operand's own (a tensor map whose inner dimension is head_dim, narrower
// than the atoms) land as zeros.

constexpr int kSw64Atom = 64 * 64;  // bytes of one 32-dim atom of 64 rows

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make initialised barriers visible to the async proxy (TMA) and the block.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and expect `bytes` more of asynchronous copies on the barrier.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One 4-D TMA box from the tensor map `map` (the address of a
// __grid_constant__ CUtensorMap) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x (MUFU.EX2; denormal results flush to 0).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query (the library links no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// The map of a [B, Hkv, L, head_dim] bf16 operand at `base` (element
// strides sb, sh, sl): boxes of 32 head dims x 64 rows, 64-byte swizzle,
// rows past L and head dims past head_dim read as 0.
inline CUresult encode_operand(CUtensorMap* m, const void* base, int batch,
                               int kv_heads, int len, int head_dim,
                               long long sb, long long sh, long long sl) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(kv_heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {32, kBlockK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A 64-byte-swizzled 64-row tile as the K-major B operand (rows N, head dim
// the reduction), at reduction step kk (head dims 16 kk .. 16 kk + 15):
// within an atom the step moves the start by 32 bytes; 8-row groups lie
// 512 bytes apart.
__device__ __forceinline__ uint64_t desc_sw64_k(const bf16* tile, int kk) {
  return wgmma_desc(reinterpret_cast<const char*>(tile) +
                        (kk >> 1) * kSw64Atom + (kk & 1) * 32,
                    16, 512) |
         (2ull << 62);
}

// ... as the MN-major B operand (rows the reduction, head dim N), at
// reduction step j (rows 16 j .. 16 j + 15): atoms along N lie kSw64Atom
// apart, 8-row groups along the reduction 512 bytes.
__device__ __forceinline__ uint64_t desc_sw64_mn(const bf16* tile, int j) {
  return wgmma_desc(reinterpret_cast<const char*>(tile) + j * 1024,
                    kSw64Atom, 512) |
         (2ull << 62);
}

// ---- Hopper: S = Q.K^T at any key-tile width (the overlap probe) ---------
//
// A 64-byte-swizzled tile of ROWS rows keeps the layout above with its
// 32-dim atoms ROWS * 64 bytes apart (TMA boxes of 32 x ROWS); ROWS 64 is
// the tile of desc_sw64_k / desc_sw64_mn.

// A ROWS-row 64-byte-swizzled tile as the K-major operand (rows M or N,
// head dim the reduction), at reduction step kk.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_sw64_k_rows(const bf16* tile,
                                                     int kk) {
  return wgmma_desc(reinterpret_cast<const char*>(tile) +
                        (kk >> 1) * (ROWS * 64) + (kk & 1) * 32,
                    16, 512) |
         (2ull << 62);
}

// ... as the MN-major B operand (rows the reduction, head dim N), at
// reduction step j (rows 16 j .. 16 j + 15).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_sw64_mn_rows(const bf16* tile,
                                                      int j) {
  return wgmma_desc(reinterpret_cast<const char*>(tile) + j * 1024,
                    ROWS * 64, 512) |
         (2ull << 62);
}

// d (64 x 128, fp32) (+)= A (64 x 16, K-major, shared) . B (16 x 128,
// K-major shared: the tile's rows are the 128 columns of d); scale_d 0
// overwrites.
__device__ __forceinline__ void wgmma_64x128_ss(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, fp32) (+)= A (64 x 16, registers) . B (16 x N, K-major
// shared); scale_d 0 overwrites. S over a key tile of N = 16, 32 or 64
// keys with Q's fragments in registers.
template <int N>
__device__ __forceinline__ void wgmma_s_rs(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s_rs<16>(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s_rs<32>(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  wgmma_64x64_rs(d, a, db, scale_d);
}

}  // namespace vgt
