// The MXU/VPU overlap probe for Hopper (sm_90a): kernel pair P1.
//
// Replaces the two bodies of the TPU probe scripts/overlap_probe.py
// (`_serial_kernel` and `_pipelined_kernel`, one `pallas_call`). The question
// it asks of the card: when a warpgroup's key loop is software-pipelined, so
// that the QK^T product of the next key subtile is issued before the exp2
// pass over the current one, do the tensor cores run under the exp2 pass?
//
// Function, per problem p and query row r (q [G, BQ, D], k/v [G, LK, D],
// all contiguous bf16; no mask, scale 1, as the TPU probe):
//   s(r, k) = q_r . k_k                           (fp32 accumulate)
//   p(r, k) = exp2(clamp(s, -100, 100))           (no max shift)
//   out(r)  = sum_k bf16(p) v_k / max(sum_k p, 1e-30)
// the row sum taken in fp32 from the unrounded p. K1's columnar rank
// attention (rank_attention.cu) without the mask, at D 128.
//
// The TPU probe holds q, k and v in VMEM and copies nothing, so its two
// bodies differ only in the order of the products and the exp2 pass. Here
// both bodies share everything but that order, and use the instructions of
// the production kernels:
// - one block shape: a producer warpgroup (its registers lowered with
//   setmaxnreg; one thread works) and kProbeConsumers consumer warpgroups of
//   64 query rows each;
// - the producer loads each consumer's Q tile once and streams the
//   problem's K and V, W keys a subtile, by TMA (64-byte swizzle) into one
//   ring of stages guarded by full / empty mbarriers; the ring holds
//   kRingBytes whatever W, so every instance keeps as many bytes in flight;
// - S = Q.K^T on wgmma m64nWk16, K from shared memory and Q's fragments in
//   registers as in K1 (read once from the Q tile); at W 128 Q from shared
//   memory instead, where its 32 registers do not fit beside two S sets;
//   the exp2 pass and the row sums in registers (ex2.approx, as K1), then
//   O += P.V on wgmma m64n128k16 (P from registers, V MN-major from shared
//   memory).
// The bodies:
// - serial (W 64): per subtile, issue S and wait for it, run the exp2 pass,
//   issue P.V and wait for it. None of a warpgroup's products runs under its
//   own exp2 pass.
// - pipelined<W>: the TPU body's order. Subtile j+1's S is committed before
//   subtile j's exp2 pass (into a second S register set) and runs under
//   that pass, and P.V of j is issued after it; one wait for both ends the
//   step (pipelined_step says why not wgmma_wait<1>). nsub splits
//   each 256-key span into subtiles of W = 256 / nsub keys: 128, 64, 32, 16
//   for nsub 2, 4, 8, 16 (the TPU probe splits its whole 8192-key row, which
//   VMEM holds; a warpgroup holds a few hundred keys' scores in registers at
//   most). At nsub 4 it has the serial body's tile, ring and block shape.
// The consumer warpgroups of a block (and of the blocks an SM holds) still
// overlap one another's products and exp2 passes whatever the order inside
// each: on Hopper "serial" is serial within a warpgroup.
//
// Grid: (BQ / (64 kProbeConsumers), G), query blocks fastest: the blocks of
// one problem each read its whole K/V, at the same time, so the later reads
// are mostly L2 hits. Registers: the consumers' O takes 64 a thread, each S
// set W / 2, P W / 4, Q 32 (up to W 64); at W 128 (two S sets, 224 live)
// the consumers get 240 and the producer 24, one block an SM.
//
// What bounds it on the card: G problems of 4 * BQ * LK * D FLOPs against
// 2 * LK * D * 2 bytes of K/V each; at G 132 the bytes (0.170 ms at 3.35
// TB/s) and the products (0.143 ms at 989 TFLOP/s) are within 20% of each
// other, and beside them each pair's exp2 (277M a launch, ~0.07 ms of the
// SMs' MUFU at 16 a clock). Measured (PERF.md section 6): at G 132 both
// bodies take ~0.25 ms, two thirds of the card's byte rate, and the order
// inside a warpgroup moves them by a few percent; at G 1, where nothing
// contends for bytes, the pipelined body is ~1.2x the serial one.
#include <cstring>

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
constexpr int kProbeConsumers = 2;  // warpgroups of 64 query rows a block
constexpr int kProbeRows = 64 * kProbeConsumers;
constexpr int kProbeThreads = 128 * (1 + kProbeConsumers);
// One block an SM (two with a single consumer: the launch takes half the
// registers). setmaxnreg moves registers within the block, so the
// producer's and the consumers' counts add up to the launch's.
constexpr int kProbeMinBlocks = kProbeConsumers == 1 ? 2 : 1;
constexpr int kProbeLaunchRegs =
    65536 / (kProbeThreads * kProbeMinBlocks) / 8 * 8;
constexpr int kProbeProducerRegs = 24;
constexpr int kProbeConsumerRegs =
    (kProbeLaunchRegs * (1 + kProbeConsumers) - kProbeProducerRegs) /
    kProbeConsumers / 8 * 8;
static_assert(128 * (kProbeProducerRegs + kProbeConsumers *
                           kProbeConsumerRegs) <=
                  kProbeLaunchRegs * kProbeThreads,
              "the warpgroups' registers exceed the launch's");
constexpr int kQTileBytes = 64 * kProbeDim * 2;  // one consumer's Q
constexpr int kRingBytes = 192 * 1024;           // K/V stages, any W

// The shared memory of a block at subtile width W, from a 1024-byte
// boundary: the ring's stages (K then V, W rows each in 64-byte-swizzled
// atoms of 32 head dims), the consumers' Q tiles, then the barriers.
template <int W>
struct ProbeCfg {
  static constexpr bool kQRegs = W <= 64;  // else S reads Q from shared
  static constexpr int kTileBytes = W * kProbeDim * 2;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 3 .. 24
  static constexpr int kQOff = kRingBytes;
  static constexpr int kBarOff = kQOff + kProbeConsumers * kQTileBytes;
  static constexpr int kSmem = 1024 + kBarOff + (2 * kStages + 1) * 8;
  static_assert(kStages >= 3, "the pipelined body holds two stages");
  static_assert(kSmem <= 232448, "a block's shared memory exceeds the SM's");
};

// The tensor maps of a launch: Q (boxes of 32 dims x 64 rows), K and V
// (32 dims x W rows).
struct alignas(64) ProbeMaps {
  CUtensorMap q, k, v;
};

// p = exp2(clamp(s)) of this thread's W / 2 entries of S, in place; their
// row sums (row g: entries 4n, 4n + 1; row g + 8: 4n + 2, 4n + 3) added to
// l0 / l1.
template <int W>
__device__ __forceinline__ void exp2_pass(float (&s)[W / 2], float& l0,
                                          float& l1) {
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * n + e] = ex2_approx(fminf(fmaxf(s[4 * n + e], -100.f), 100.f));
    l0 += s[4 * n] + s[4 * n + 1];
    l1 += s[4 * n + 2] + s[4 * n + 3];
  }
}

// A consumer warpgroup's state and steps over the ring.
template <int W>
struct ProbeConsumer {
  using C = ProbeCfg<W>;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  const bf16* qt;     // this consumer's Q tile
  uint32_t qa[C::kQRegs ? kProbeDim / 16 : 1][4];  // and its A fragments
  int lane;
  int wait_stage = 0;  // the next stage to wait for, and its parity
  uint32_t phase = 0;
  int free_stage = 0;  // the next stage to release

  __device__ __forceinline__ const bf16* kt(int s) const {
    return reinterpret_cast<const bf16*>(ring + s * C::kStageBytes);
  }
  __device__ __forceinline__ const bf16* vt(int s) const {
    return reinterpret_cast<const bf16*>(ring + s * C::kStageBytes +
                                         C::kTileBytes);
  }

  // Wait for the next subtile and issue its S into s; its stage. s is
  // zeroed first, as in K1, so that its old values die at their last use
  // and not at the product's "+f" operands (at W 128 they would hold 64
  // registers beside P and the S in flight).
  __device__ __forceinline__ int issue_s(float (&s)[W / 2]) {
    const int st = wait_stage;
    mbar_wait(&full[st], phase);
    if (++wait_stage == C::kStages) {
      wait_stage = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int i = 0; i < W / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    if constexpr (C::kQRegs) fence_frags(qa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kProbeDim / 16; ++kk) {
      if constexpr (C::kQRegs)
        wgmma_s_rs<W>(s, qa[kk], desc_sw64_k_rows<W>(kt(st), kk), kk > 0);
      else
        wgmma_64x128_ss(s, desc_sw64_k(qt, kk),
                        desc_sw64_k_rows<W>(kt(st), kk), kk > 0);
    }
    wgmma_commit();
    return st;
  }

  // P = bf16(s) into registers and O += P.V over stage st's V.
  __device__ __forceinline__ void issue_pv(float (&o)[64],
                                           uint32_t (&pa)[W / 16][4],
                                           const float (&s)[W / 2], int st) {
#pragma unroll
    for (int j = 0; j < W / 16; ++j) acc_to_a(pa[j], s + 8 * j);
    fence_frags(pa);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < W / 16; ++j)
      wgmma_pv<kProbeDim>(o, pa[j], desc_sw64_mn_rows<W>(vt(st), j));
    wgmma_commit();
  }

  // Q's A fragments of this thread (warp w: rows 16 w ..) from the landed
  // tile: row r's 16-byte chunk ch of an atom at 64 r + 16 (ch ^ (r / 2) % 4).
  __device__ __forceinline__ void load_q(int warp) {
    if constexpr (C::kQRegs) {
      const unsigned char* base = reinterpret_cast<const unsigned char*>(qt);
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int kk = 0; kk < kProbeDim / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + g + (e & 1) * 8;
          const int col = kk * 16 + 2 * t + (e >> 1) * 8;
          const int ch = ((col >> 3) & 3) ^ ((r >> 1) & 3);
          qa[kk][e] = *reinterpret_cast<const uint32_t*>(
              base + (col >> 5) * kSw64Atom + r * 64 + ch * 16 +
              (col & 7) * 2);
        }
    }
  }

  // Every warp signals once it is done with the oldest held stage.
  __device__ __forceinline__ void release() {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[free_stage]);
    if (++free_stage == C::kStages) free_stage = 0;
  }
};

// The serial body: per subtile S, wait, exp2, P.V, wait.
template <int W>
__device__ __forceinline__ void overlap_serial(ProbeConsumer<W>& c, int n,
                                               float (&o)[64], float& l0,
                                               float& l1) {
  float s[W / 2];
  uint32_t pa[W / 16][4];
  for (int i = 0; i < n; ++i) {
    const int st = c.issue_s(s);
    wgmma_wait<0>();
    fence_regs(s);
    exp2_pass<W>(s, l0, l1);  // the serial body's exp2 pass
    c.issue_pv(o, pa, s, st);
    wgmma_wait<0>();
    fence_regs(o);
    fence_frags(pa);
    c.release();
  }
}

// One step j of the pipelined body: `prev` holds subtile j's S (landed),
// from stage `prev_st`. Issue subtile j + 1's S into `cur`, run subtile j's
// exp2 pass under it, then issue its P.V; return subtile j + 1's stage.
// Each step ends with no product in flight (both waited for), so that no
// group stays pending across the loop's back edge: with S(j + 1) and P.V(j)
// left in flight there (a wgmma_wait<1> at the next step's start), ptxas
// serialized every wgmma of the body (C7514).
template <int W>
__device__ __forceinline__ int pipelined_step(ProbeConsumer<W>& c,
                                              float (&prev)[W / 2],
                                              int prev_st,
                                              float (&cur)[W / 2],
                                              float (&o)[64],
                                              uint32_t (&pa)[W / 16][4],
                                              float& l0, float& l1) {
  const int next = c.issue_s(cur);
  exp2_pass<W>(prev, l0, l1);  // under S(j + 1)
  c.issue_pv(o, pa, prev, prev_st);
  wgmma_wait<0>();
  fence_regs(cur);
  fence_regs(o);
  fence_frags(pa);
  c.release();  // subtile j's stage
  return next;
}

// The pipelined body over n (even, >= 2) subtiles.
template <int W>
__device__ __forceinline__ void overlap_pipelined(ProbeConsumer<W>& c, int n,
                                                  float (&o)[64], float& l0,
                                                  float& l1) {
  float sa[W / 2], sb[W / 2];
  uint32_t pa[W / 16][4];
  int st = c.issue_s(sa);
  wgmma_wait<0>();
  fence_regs(sa);
  // steps 0 .. n - 3, two at a time, so that the S sets swap; then n - 2
  for (int j = 0; j < n - 2; j += 2) {
    st = pipelined_step<W>(c, sa, st, sb, o, pa, l0, l1);
    st = pipelined_step<W>(c, sb, st, sa, o, pa, l0, l1);
  }
  st = pipelined_step<W>(c, sa, st, sb, o, pa, l0, l1);
  // step n - 1: no S to issue
  exp2_pass<W>(sb, l0, l1);  // the last subtile's exp2 pass
  c.issue_pv(o, pa, sb, st);
  wgmma_wait<0>();
  fence_regs(o);
  fence_frags(pa);
  c.release();
}

// The producer: each consumer's Q tile, then the problem's K and V subtiles
// in order through the ring. One thread works.
template <int W>
__device__ __forceinline__ void probe_producer(const ProbeMaps& maps,
                                               unsigned char* smem,
                                               uint64_t* full,
                                               uint64_t* empty,
                                               uint64_t* qbar, int p, int q0,
                                               int n) {
  using C = ProbeCfg<W>;
  if (threadIdx.x != 0) return;
  mbar_arrive_tx(qbar, kProbeConsumers * kQTileBytes);
  for (int c = 0; c < kProbeConsumers; ++c)
#pragma unroll
    for (int at = 0; at < kProbeDim / 32; ++at)
      tma_load_4d(smem + C::kQOff + c * kQTileBytes + at * kSw64Atom,
                  &maps.q, qbar, 32 * at, q0 + 64 * c, p, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n; ++i) {
    mbar_wait(&empty[stage], phase ^ 1);
    unsigned char* st = smem + stage * C::kStageBytes;
    mbar_arrive_tx(&full[stage], C::kStageBytes);
#pragma unroll
    for (int at = 0; at < kProbeDim / 32; ++at) {
      tma_load_4d(st + at * (W * 64), &maps.k, &full[stage], 32 * at, i * W,
                  p, 0);
      tma_load_4d(st + C::kTileBytes + at * (W * 64), &maps.v, &full[stage],
                  32 * at, i * W, p, 0);
    }
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <int W, bool kPipelined>
__global__ void __launch_bounds__(kProbeThreads, kProbeMinBlocks)
    overlap_kernel(const __grid_constant__ ProbeArgs a,
                   const __grid_constant__ ProbeMaps maps) {
  using C = ProbeCfg<W>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;
  const int p = blockIdx.y, q0 = blockIdx.x * kProbeRows;
  const int n = a.lk / W;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrival (+ the TMA bytes)
      mbar_init(&empty[s], 4 * kProbeConsumers);  // every consumer warp
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  // warp-uniform in the compiler's view (a shuffle), as wgmma wants
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    setmaxnreg_dec<kProbeProducerRegs>();
    probe_producer<W>(maps, smem, full, empty, qbar, p, q0, n);
    return;
  }
  setmaxnreg_inc<kProbeConsumerRegs>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * (wg - 1);
  ProbeConsumer<W> c;
  c.ring = smem;
  c.full = full;
  c.empty = empty;
  c.qt = reinterpret_cast<const bf16*>(smem + C::kQOff +
                                       (wg - 1) * kQTileBytes);
  c.lane = lane;
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  mbar_wait(qbar, 0);
  c.load_q(warp);
  if constexpr (kPipelined)
    overlap_pipelined<W>(c, n, o, l0, l1);
  else
    overlap_serial<W>(c, n, o, l0, l1);

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  bf16* out = static_cast<bf16*>(a.out) +
              static_cast<long long>(p) * a.bq * kProbeDim;
#pragma unroll
  for (int n8 = 0; n8 < kProbeDim / 8; ++n8) {
    const int col = n8 * 8 + 2 * t;
    if (r0 < a.bq)
      *reinterpret_cast<uint32_t*>(out + r0 * kProbeDim + col) =
          pack_bf16(o[4 * n8] * inv0, o[4 * n8 + 1] * inv0);
    if (r1 < a.bq)
      *reinterpret_cast<uint32_t*>(out + r1 * kProbeDim + col) =
          pack_bf16(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
  }
}

// The map of a contiguous [problems, len, D] bf16 operand: boxes of 32 head
// dims x `rows` rows, 64-byte swizzle; rows past len read as 0.
inline CUresult encode_rows(CUtensorMap* m, const void* base, int problems,
                            int len, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t row = kProbeDim * 2;  // bytes
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kProbeDim),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(problems), 1};
  const cuuint64_t strides[3] = {row, row * len, row * len * problems};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

bool takes(const ProbeArgs* a) {
  return a->head_dim == kProbeDim && a->bq % 64 == 0 && a->bq > 0 &&
         a->lk % kSpan == 0 && a->lk > 0 && a->problems > 0 &&
         a->problems <= 65535;
}

// Returns cudaGetLastError() (0 = launched), or 100000 + the CUresult of a
// tensor map that failed to encode.
template <int W, bool kPipelined>
int launch(const ProbeArgs* a, void* stream) {
  using C = ProbeCfg<W>;
  ProbeMaps maps;
  memset(&maps, 0, sizeof(maps));
  CUresult r = encode_rows(&maps.q, a->q, a->problems, a->bq, 64);
  if (r == CUDA_SUCCESS)
    r = encode_rows(&maps.k, a->k, a->problems, a->lk, W);
  if (r == CUDA_SUCCESS)
    r = encode_rows(&maps.v, a->v, a->problems, a->lk, W);
  if (r != CUDA_SUCCESS) return 100000 + static_cast<int>(r);
  auto kernel = overlap_kernel<W, kPipelined>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a->bq + kProbeRows - 1) / kProbeRows, a->problems);
  kernel<<<grid, kProbeThreads, C::kSmem, static_cast<cudaStream_t>(stream)>>>(
      *a, maps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vgt

// Launch on `stream`; return cudaGetLastError() (0 = launched).
extern "C" int vgt_overlap_serial(const vgt::ProbeArgs* a, void* stream) {
  if (!vgt::takes(a)) return static_cast<int>(cudaErrorInvalidValue);
  return vgt::launch<vgt::kSpan / 4, false>(a, stream);
}

extern "C" int vgt_overlap_pipelined(const vgt::ProbeArgs* a, void* stream) {
  using vgt::kSpan;
  if (!vgt::takes(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (a->nsub) {
    case 2: return vgt::launch<kSpan / 2, true>(a, stream);
    case 4: return vgt::launch<kSpan / 4, true>(a, stream);
    case 8: return vgt::launch<kSpan / 8, true>(a, stream);
    case 16: return vgt::launch<kSpan / 16, true>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
