// The MXU/VPU overlap probe for Hopper (sm_90a): kernel pair P1.
//
// Replaces the two bodies of the TPU probe scripts/overlap_probe.py
// (`_serial_kernel` and `_pipelined_kernel`, one `pallas_call`). The question
// it asks of the card: when one block's key loop is software-pipelined, so
// that the QK^T product of the next key subtile is issued before the exp2
// pass over the current one, do the tensor cores run under the exp2 pass?
//
// Function, per problem p and query row r (q [G, BQ, D], k/v [G, LK, D],
// all contiguous bf16; no mask, scale 1, as the TPU probe):
//   s(r, k) = q_r . k_k                           (fp32 accumulate)
//   p(r, k) = exp2(clamp(s, -100, 100))
//   out(r)  = sum_k bf16(p) v_k / max(sum_k p, 1e-30)
// K1's columnar rank attention (rank_attention.cu) without the mask, at
// D 128. Both kernels compute it with the same products in the same order
// per key, so they agree with each other up to fp32 summation order.
//
// - serial: K1's body. Each block owns 64 query rows (16 per warp); per
//   64-key tile it loads K and V synchronously into one shared buffer, then
//   S = Q.K^T (mma.sync), then exp2, then P.V, strictly in order.
// - pipelined<W>: the key row walks subtiles of W keys. Subtile j+1's QK^T
//   goes into a second score register set before subtile j's exp2 and P.V,
//   and the K and V of the subtiles after that are in flight (cp.async into
//   two shared buffers each) while subtile j is consumed. The TPU probe
//   splits its 8192-key row into nsub subtiles of 4096-512 keys that VMEM
//   holds at once; a Hopper block holds a few hundred keys' scores in
//   registers at most, so nsub here splits each 256-key span: W = 256 / nsub
//   = 128, 64, 32, 16 keys for nsub 2, 4, 8, 16 (nsub 4 has the serial
//   kernel's 64-key tile). Equal math, FLOPs and bytes.
//
// What bounds it on the card: G problems of 4 * BQ * LK * D FLOPs against
// 2 * LK * D * 2 bytes of K/V each; at G 132 (every SM busy) the two
// bounds are within 15% of each other. Neither kernel uses wgmma or TMA.
#include "attention_common.cuh"

namespace vgt {

// Must match _ProbeArgs in video_gpt_tpu_torch/probes/overlap_probe.py.
struct ProbeArgs {
  const void* q;    // [G, bq, D] contiguous
  const void* k;    // [G, lk, D] contiguous
  const void* v;    // [G, lk, D] contiguous
  void* out;        // [G, bq, D] contiguous
  int problems, bq, lk, head_dim, nsub;
};

constexpr int kProbeDim = 128;  // the TPU probe's D
constexpr int kSpan = 256;      // keys split into nsub subtiles (W = 256/nsub)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's most recent groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copy of ROWS full rows of D bf16 (row stride D) into a
// [ROWS][LDS] shared tile, 16 bytes per cp.async.
template <int D, int ROWS, int LDS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    cp_async16(dst + r * LDS + c, src + static_cast<long long>(r) * D + c);
  }
}

// S = Q.K^T over the NS * 8 keys of the shared tile `ks`.
template <int KS, int NS, int LDS>
__device__ __forceinline__ void qk_scores(float (&s)[NS][4],
                                          const uint32_t (&qa)[KS][4],
                                          const bf16* ks, int lane) {
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      uint32_t b0, b1;
      load_b_kt(b0, b1, ks + n * 8 * LDS + kk * 16, LDS, lane);
      mma_16816(s[n], qa[kk], b0, b1);
    }
  }
}

// p = exp2(clamp(s)), the row sums, and O += bf16(p).V over the shared
// tile `vs` of the same NS * 8 keys.
template <int NS, int NO, int LDS>
__device__ __forceinline__ void exp2_pv(float (&s)[NS][4], float (&o)[NO][4],
                                        float& l0, float& l1, const bf16* vs,
                                        int lane) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = exp2f(fminf(fmaxf(s[n][e], -100.f), 100.f));
    l0 += s[n][0] + s[n][1];
    l1 += s[n][2] + s[n][3];
  }
#pragma unroll
  for (int j = 0; j < NS / 2; ++j) {
    const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                            pack_bf16(s[2 * j][2], s[2 * j][3]),
                            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      uint32_t b0, b1;
      load_b_v(b0, b1, vs + j * 16 * LDS + n * 8, LDS, lane);
      mma_16816(o[n], pa, b0, b1);
    }
  }
}

// The block's 64 query rows into shared memory and into A fragments.
template <int D, int LDS>
__device__ __forceinline__ void load_queries(uint32_t (&qa)[D / 16][4],
                                             bf16* qs, const bf16* qp,
                                             int warp, int lane) {
  load_tile<D, kBlockQ, LDS>(qs, qp, D, kBlockQ);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a(qa[kk], qs + warp * 16 * LDS + kk * 16, LDS, lane);
}

template <int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO][4], float l0,
                                           float l1, bf16* out, int row0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  bf16* r0 = out + static_cast<long long>(row0 + g) * (NO * 8);
  bf16* r1 = r0 + 8 * (NO * 8);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(r0 + c) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(r1 + c) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    overlap_serial_kernel(const ProbeArgs a) {
  constexpr int LDS = D + 8, KS = D / 16, NO = D / 8, NS = kBlockK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBlockQ * LDS;
  bf16* vs = ks + kBlockK * LDS;

  const int p = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qrow = static_cast<long long>(p) * a.bq + q0;
  const long long krow = static_cast<long long>(p) * a.lk;
  const bf16* kp = static_cast<const bf16*>(a.k) + krow * D;
  const bf16* vp = static_cast<const bf16*>(a.v) + krow * D;

  uint32_t qa[KS][4];
  load_queries<D, LDS>(qa, qs, static_cast<const bf16*>(a.q) + qrow * D,
                       warp, lane);
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < a.lk; k0 += kBlockK) {
    __syncthreads();  // the previous tile is fully consumed
    load_tile<D, kBlockK, LDS>(ks, kp + static_cast<long long>(k0) * D, D,
                               kBlockK);
    load_tile<D, kBlockK, LDS>(vs, vp + static_cast<long long>(k0) * D, D,
                               kBlockK);
    __syncthreads();
    float s[NS][4];
    qk_scores<KS, NS, LDS>(s, qa, ks, lane);
    exp2_pv<NS, NO, LDS>(s, o, l0, l1, vs, lane);
  }
  store_rows<NO>(o, l0, l1,
                 static_cast<bf16*>(a.out) + static_cast<long long>(p) *
                                                 a.bq * D,
                 q0 + warp * 16, lane);
}

// One step j of the pipelined loop: `prev` holds subtile j's scores; the
// step fills `cur` with subtile j+1's, then consumes `prev`.
template <int D, int W>
__device__ __forceinline__ void pipelined_step(
    int j, int n, float (&prev)[W / 8][4], float (&cur)[W / 8][4],
    float (&o)[D / 8][4], float& l0, float& l1,
    const uint32_t (&qa)[D / 16][4], bf16* kbuf, bf16* vbuf, const bf16* kp,
    const bf16* vp, int lane) {
  constexpr int LDS = D + 8, SLOT = W * LDS;
  // every warp is done with K slot j&1 (subtile j's QK^T, the step before)
  // and V slot (j+1)&1 (subtile j-1's P.V): refill them
  __syncthreads();
  if (j + 2 < n)
    load_tile_async<D, W, LDS>(kbuf + (j & 1) * SLOT,
                               kp + static_cast<long long>(j + 2) * W * D);
  if (j + 1 < n)
    load_tile_async<D, W, LDS>(vbuf + ((j + 1) & 1) * SLOT,
                               vp + static_cast<long long>(j + 1) * W * D);
  cp_async_commit();
  cp_async_wait<1>();  // K of subtile j+1 and V of subtile j have landed
  __syncthreads();
  if (j + 1 < n)
    qk_scores<D / 16, W / 8, LDS>(cur, qa, kbuf + ((j + 1) & 1) * SLOT, lane);
  exp2_pv<W / 8, D / 8, LDS>(prev, o, l0, l1, vbuf + (j & 1) * SLOT, lane);
}

template <int D, int W>
__global__ void __launch_bounds__(kThreads)
    overlap_pipelined_kernel(const ProbeArgs a) {
  constexpr int LDS = D + 8, KS = D / 16, NO = D / 8, NS = W / 8;
  constexpr int SLOT = W * LDS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kbuf = qs + kBlockQ * LDS;   // two slots of W keys
  bf16* vbuf = kbuf + 2 * SLOT;      // two slots of W keys

  const int p = blockIdx.y, q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long qrow = static_cast<long long>(p) * a.bq + q0;
  const long long krow = static_cast<long long>(p) * a.lk;
  const bf16* kp = static_cast<const bf16*>(a.k) + krow * D;
  const bf16* vp = static_cast<const bf16*>(a.v) + krow * D;
  const int n = a.lk / W;  // even: the wrapper takes lk in multiples of 256

  // in flight: {K0}, then {K1, V0}
  load_tile_async<D, W, LDS>(kbuf, kp);
  cp_async_commit();
  load_tile_async<D, W, LDS>(kbuf + SLOT, kp + W * D);
  load_tile_async<D, W, LDS>(vbuf, vp);
  cp_async_commit();

  uint32_t qa[KS][4];
  load_queries<D, LDS>(qa, qs, static_cast<const bf16*>(a.q) + qrow * D,
                       warp, lane);
  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  float sa[NS][4], sb[NS][4];
  cp_async_wait<1>();  // K0
  __syncthreads();
  qk_scores<KS, NS, LDS>(sa, qa, kbuf, lane);
  for (int j = 0; j < n; j += 2) {  // two steps, so the score sets swap
    pipelined_step<D, W>(j, n, sa, sb, o, l0, l1, qa, kbuf, vbuf, kp, vp,
                         lane);
    pipelined_step<D, W>(j + 1, n, sb, sa, o, l0, l1, qa, kbuf, vbuf, kp, vp,
                         lane);
  }
  store_rows<NO>(o, l0, l1,
                 static_cast<bf16*>(a.out) + static_cast<long long>(p) *
                                                 a.bq * D,
                 q0 + warp * 16, lane);
}

template <typename Kernel>
int launch(Kernel kernel, const ProbeArgs* a, int smem, void* stream) {
  // above 48 KB a block's shared memory is dynamic and must be allowed
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a->bq / kBlockQ, a->problems);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

bool takes(const ProbeArgs* a) {
  return a->head_dim == kProbeDim && a->bq % kBlockQ == 0 &&
         a->lk % kSpan == 0 && a->lk > 0 && a->problems > 0;
}

template <int W>
int launch_pipelined(const ProbeArgs* a, void* stream) {
  constexpr int LDS = kProbeDim + 8;
  const int smem = (kBlockQ + 4 * W) * LDS * static_cast<int>(sizeof(bf16));
  return launch(overlap_pipelined_kernel<kProbeDim, W>, a, smem, stream);
}

}  // namespace vgt

// Launch on `stream`; return cudaGetLastError() (0 = launched).
extern "C" int vgt_overlap_serial(const vgt::ProbeArgs* a, void* stream) {
  if (!vgt::takes(a)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int LDS = vgt::kProbeDim + 8;
  const int smem = (vgt::kBlockQ + 2 * vgt::kBlockK) * LDS *
                   static_cast<int>(sizeof(vgt::bf16));
  return vgt::launch(vgt::overlap_serial_kernel<vgt::kProbeDim>, a, smem,
                     stream);
}

extern "C" int vgt_overlap_pipelined(const vgt::ProbeArgs* a, void* stream) {
  if (!vgt::takes(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a->nsub) {
    case 2: return vgt::launch_pipelined<vgt::kSpan / 2>(a, stream);
    case 4: return vgt::launch_pipelined<vgt::kSpan / 4>(a, stream);
    case 8: return vgt::launch_pipelined<vgt::kSpan / 8>(a, stream);
    case 16: return vgt::launch_pipelined<vgt::kSpan / 16>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
