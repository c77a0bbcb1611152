// B5: fused causal / full GQA flash attention (forward) for Hopper.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_pallas (body _kernel).
// Computes, for q (B, S, H, hd) and k, v (B, S, KV, hd) with H % KV == 0,
//     O[b, s, h] = softmax_t(q[b, s, h] . k[b, t, h / (H / KV)] / sqrt(hd)
//                            + mask(s, t)) . v[b, t, h / (H / KV)]
// with mask(s, t) = -1e30 for t > s when causal and for t >= S always.  The
// scores, the online-softmax statistics (m, l) and the output accumulator
// are fp32 for every input dtype (bf16 / f16 products accumulate in fp32 in
// the tensor cores; fp32 runs FFMA with no TF32); the output is
// acc / max(l, 1e-30) rounded once to the input dtype, as in the reference.
// When the caller passes an `lse` buffer, both bodies also write each row's
// log-sum-exp m + log(l) (fp32, natural log, from the statistics they
// already hold), which the training backward reads
// (kernels/flash_attention.py); a null `lse` leaves the serving launch as
// it was.
//
// What bounds it on the H100: operations.  At the serving shape (B 4, S
// 2048, H 32, KV 8, hd 64) the causal half of QKᵀ and P·V is 68.7 GFLOP
// against 84 MB of Q, K, V and O, about 800 flop per byte, above the
// card's ridge for every unit.  The least time is those flops over the
// bf16 tensor-core peak (0.069 ms).
//
// Design.  The TPU kernel walks (batch*head, q block, k block) on a
// sequential grid and carries m, l and acc in VMEM scratch from one k step
// to the next.  Hopper blocks run in no order, so the k walk becomes a loop
// inside the block.  Two bodies:
//
// bf16 / f16 (flash_wgmma_kernel): one CTA owns one 64-query block of one
// batch row for `hpc` q-heads that read one kv-head (GQA sharing: at most
// kMaxHeads, 2 of the 4 heads of llama3.2-1b that share each of its 8
// kv-heads), one warpgroup per q-head.
//   * Staging: TMA loads through 4-D tensor maps over the (B, S, heads, hd)
//     layouts (a head's rows, heads * hd elements apart, need no copy):
//     each q-head's Q block once, then each K and V tile once for all the
//     CTA's heads, into a ring of kStages stages with full / empty
//     mbarriers.  Thread 0 issues them: the first stages at the start, and
//     during tile kt the tile kt + kStages - 1 into the stage tile
//     kt - 1 has freed, so loads run two tiles ahead of the products.  TMA
//     writes the tiles in the swizzled layout wgmma reads (128-byte rows at
//     hd >= 64, 64 / 32 at hd 32 / 16; hd 128 as two 64-column halves) and
//     zero-fills rows past S.
//   * Products: warpgroup wgmma with fp32 accumulation.  S = Q Kᵀ takes Q
//     and K from shared memory, both K-major along hd; P V takes P from
//     registers (the score accumulators, rounded to T, are exactly the
//     register A operand's fragments) and V from shared memory, marked
//     MN-major in its descriptor, so V is read as stored.
//   * Software pipeline inside a warpgroup: S for tile kt + 1 is issued,
//     then P V for tile kt; the lanes wait for the first only and run the
//     softmax of tile kt + 1 while P V runs on the tensor cores.
//   * Softmax on the accumulators in registers, in the log2 domain (p =
//     exp2(s * log2(e) / sqrt(hd) - m), one FFMA and one MUFU.EX2): a lane
//     holds two rows of its warp's 16, each row's max and sum reduce over
//     the 4 lanes of a quad.  P enters P·V rounded once to T, as
//     scaled_dot_product_attention's kernels round it (PERF.md compares
//     this with a hi + lo split of bf16 P, two products).
//   * Causal: tiles past the frontier are skipped, and only the diagonal
//     and the ragged last tile are masked.  The CTAs with the most tiles
//     are launched first (the query block is the grid's slow dimension).
// Registers: a warpgroup holds 64 x hd fp32 accumulators, a 64 x kKeys
// score tile and P; 113 a thread at hd 64, so two 256-thread CTAs share an
// SM.  kernel_sweep.py measured the choices (PERF.md).
//
// fp32 (flash_fwd_kernel): one CTA of 4 warps per (batch*head, 64-query
// block), FFMA on the CUDA cores, no TF32 (the port's precision contract),
// so its floor is 68.7 GFLOP / 67 TFLOP/s = 1.03 ms at the serving shape.
//   * Staging: the Q block once, then each K and V tile, with coalesced
//     16-byte loads widened to fp32 in shared memory (K transposed, with a
//     padded stride, so the score loop reads it without bank conflicts).
//     At hd 128 that is 113 KB, above the 48 KB default: dynamic shared
//     memory with cudaFuncAttributeMaxDynamicSharedMemorySize.
//   * Scores: lane l of a warp owns keys l and l + 32 of the tile for the
//     warp's 16 rows (32 fp32 registers); Q rows are read as broadcast
//     float4s.  Row max and row sum are warp butterflies, so every lane
//     holds m and l of all 16 rows.
//   * P·V: the warp writes P (16 x 64) to its own shared slice and each lane
//     accumulates a fixed (rows x columns) patch of the (16 x hd) output in
//     registers, reading P as broadcast float4s and V conflict-free.
//   * Both bodies skip the tiles wholly past the causal frontier (the
//     reference's `live` predicate) and write each output element once;
//     rows past a ragged S are computed on zeros and not written.
#include <cuda.h>

#include <type_traits>

#include "panel_common.cuh"
#include "wgmma.cuh"

using namespace loops;

namespace {

constexpr int kBlockQ = 64;             // query rows per CTA
constexpr int kBlockK = 64;             // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * kWarp;
constexpr int kRowsPerWarp = kBlockQ / kWarps;   // 16
constexpr int kKtStride = kBlockK + 1;  // transposed K row stride (floats)
constexpr float kNegInf = -1e30f;       // the reference's mask value

template <int HD>
constexpr int smem_floats() {
  return kBlockQ * HD + HD * kKtStride + kBlockK * HD +
         kWarps * kRowsPerWarp * kBlockK;
}

// 16 bytes of T from global memory, widened to floats.
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  constexpr int n = 16 / sizeof(T);
  alignas(16) T e[n];
  *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < n; ++i) dst[i] = to_acc(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int seq, int heads, int kv_heads,
                 float scale, int causal) {
  // Output patch of a lane: TPR lanes span a row's hd columns, RG row
  // groups interleave the warp's 16 rows.
  constexpr int TPR = HD < kWarp ? HD : kWarp;
  constexpr int RG = kWarp / TPR;
  constexpr int RPL = kRowsPerWarp / RG;   // rows per lane
  constexpr int CPL = HD / TPR;            // columns per lane
  constexpr int VN = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int CHUNKS = HD / VN;          // 16-byte loads per row

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBlockQ][HD]
  float* kt = qs + kBlockQ * HD;                 // [HD][kKtStride]
  float* vs = kt + HD * kKtStride;               // [kBlockK][HD]
  float* ps = vs + kBlockK * HD;                 // [kWarps][16][kBlockK]

  const int nqb = gridDim.x;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int kvh = h / (heads / kv_heads);
  const int q0 = qb * kBlockQ;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int c0 = lane % TPR;
  const int rg = lane / TPR;

  const int64_t q_stride = static_cast<int64_t>(heads) * HD;   // per s
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * HD;
  const T* qbase = q + (static_cast<int64_t>(b) * seq * heads + h) * HD;
  const T* kbase = k + (static_cast<int64_t>(b) * seq * kv_heads + kvh) * HD;
  const T* vbase = v + (static_cast<int64_t>(b) * seq * kv_heads + kvh) * HD;
  T* obase = o + (static_cast<int64_t>(b) * seq * heads + h) * HD;

  for (int c = tid; c < kBlockQ * CHUNKS; c += kThreads) {
    const int r = c / CHUNKS;
    const int d = (c % CHUNKS) * VN;
    float x[VN];
    if (q0 + r < seq) {
      load16(qbase + (q0 + r) * q_stride + d, x);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VN; ++i) qs[r * HD + d + i] = x[i];
  }

  float acc[RPL][CPL];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < RPL; ++i)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  const float* qw = qs + warp * kRowsPerWarp * HD;
  float* pw = ps + warp * kRowsPerWarp * kBlockK;
  const int row0 = q0 + warp * kRowsPerWarp;   // first query row of the warp
  const int nkt = causal ? qb + 1 : nqb;

  for (int t = 0; t < nkt; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();   // every warp is done with the previous tile
    for (int c = tid; c < kBlockK * CHUNKS; c += kThreads) {
      const int r = c / CHUNKS;
      const int d = (c % CHUNKS) * VN;
      float kx[VN];
      float vx[VN];
      if (k0 + r < seq) {
        load16(kbase + (k0 + r) * kv_stride + d, kx);
        load16(vbase + (k0 + r) * kv_stride + d, vx);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) kx[i] = vx[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        kt[(d + i) * kKtStride + r] = kx[i];
        vs[r * HD + d + i] = vx[i];
      }
    }
    __syncthreads();

    // S = Q Kᵀ for the warp's 16 rows x this lane's two keys.
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float kk[4][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kk[e][0] = kt[(d + e) * kKtStride + lane];
        kk[e][1] = kt[(d + e) * kKtStride + lane + kWarp];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * HD + d);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float a = s[r][j];
          a = fmaf(qv.x, kk[0][j], a);
          a = fmaf(qv.y, kk[1][j], a);
          a = fmaf(qv.z, kk[2][j], a);
          a = fmaf(qv.w, kk[3][j], a);
          s[r][j] = a;
        }
      }
    }

    // Online softmax; P goes to the warp's shared slice.
    const bool masked = (causal && t == qb) || (k0 + kBlockK > seq);
    float corr[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[r][j] * scale;
        if (masked) {
          const int kpos = k0 + lane + j * kWarp;
          if (kpos >= seq || (causal && kpos > row0 + r)) x = kNegInf;
        }
        s[r][j] = x;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      pw[r * kBlockK + lane] = p0;
      pw[r * kBlockK + lane + kWarp] = p1;
    }
    __syncwarp();

    // acc = acc * corr + P V on this lane's (rows x columns) patch.
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      float c = corr[i * RG];
#pragma unroll
      for (int g = 1; g < RG; ++g)
        if (rg == g) c = corr[i * RG + g];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[i][j] *= c;
    }
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float vv[4][CPL];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < CPL; ++j) vv[e][j] = vs[(kk + e) * HD + c0 + TPR * j];
#pragma unroll
      for (int i = 0; i < RPL; ++i) {
        const float4 p =
            *reinterpret_cast<const float4*>(pw + (i * RG + rg) * kBlockK + kk);
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          float a = acc[i][j];
          a = fmaf(p.x, vv[0][j], a);
          a = fmaf(p.y, vv[1][j], a);
          a = fmaf(p.z, vv[2][j], a);
          a = fmaf(p.w, vv[3][j], a);
          acc[i][j] = a;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const int qpos = row0 + i * RG + rg;
    float li = l[i * RG];
#pragma unroll
    for (int g = 1; g < RG; ++g)
      if (rg == g) li = l[i * RG + g];
    if (qpos < seq) {
      const float denom = fmaxf(li, 1e-30f);
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        store(obase + qpos * q_stride + c0 + TPR * j, acc[i][j] / denom);
    }
  }
  // Every lane holds m and l of the warp's 16 rows: lane r writes row r's
  // log-sum-exp (natural log of the scaled scores), if asked.
  if (lse != nullptr) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      if (lane == r && row0 + r < seq)
        lse[static_cast<int64_t>(blockIdx.y) * seq + row0 + r] =
            m[r] + logf(fmaxf(l[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 / f16: warpgroup wgmma, TMA staging in a ring, GQA sharing
// ---------------------------------------------------------------------------

// Tile choices, measured with kernel_sweep.py (PERF.md).
constexpr int kKeys = 64;       // keys per staged K / V tile
constexpr int kStages = 3;      // K / V tiles in flight (ring depth)
constexpr int kMaxHeads = 2;    // most q-heads (warpgroups) a CTA serves

// Tile kt + kStages - 1 is loaded during iteration kt, after S_kt+1 has
// been issued: with 2 stages that would be the tile S_kt+1 waits for.
static_assert(kStages >= 3, "the refill order needs 3 stages or more");

constexpr int kWgRows = 64;   // query rows of one consumer warpgroup
constexpr int kWgThreads = 128;

// Shared-memory layout of one head-dim: tiles of `rows` x hd are stored as
// hd / kCols column blocks of rows x kCols, each row kRowBytes, swizzled in
// 8-row atoms (what the TMA box writes and the wgmma descriptor reads).
template <int HD>
struct Tiles {
  static constexpr int kCols = HD < 64 ? HD : 64;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kAtomBytes = 8 * kRowBytes;
  static constexpr int kQTile = kWgRows * HD * 2;
  static constexpr int kKvTile = kKeys * HD * 2;
  static constexpr int bytes(int heads) {
    return 1024 + heads * kQTile + kStages * 2 * kKvTile;
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.  A
// wait that outlasts 2^22 polls (seconds) traps: a lost arrival fails the
// launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 22)) __trap();
  }
}

// One TMA box of the 4-D map (hd, heads, S, B) at (c0, c1, c2, c3) into
// shared memory; completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x (MUFU.EX2, flushing denormals: P below 2^-126 of its row's max is
// 0 either way in the half dtype).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWgThreads * kMaxHeads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   T* __restrict__ o, float* __restrict__ lse, int seq,
                   int heads, int kv_heads, float scale_log2, int causal) {
  using L = Tiles<HD>;
  constexpr int kLayout = wg::layout_code(L::kRowBytes);
  constexpr int KS = HD / 16;       // k-steps of QKᵀ
  constexpr int NB = kKeys / 8;     // 8-key column blocks of the scores
  constexpr int KK = kKeys / 16;    // k-steps of P·V

  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ __align__(8) uint64_t q_bar;
  extern __shared__ uint8_t smem_raw[];
  // Tiles start on a 1024-byte boundary, the 128-byte swizzle's repeat.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int hpc = static_cast<int>(blockDim.x) / kWgThreads;
  const int groups = heads / hpc;
  const int b = static_cast<int>(blockIdx.x) / groups;
  const int head0 = (static_cast<int>(blockIdx.x) % groups) * hpc;
  const int kvh = head0 / (heads / kv_heads);
  const int qb = static_cast<int>(gridDim.y - 1 - blockIdx.y);  // longest first
  const int q0 = qb * kWgRows;
  const int kend = causal ? min(seq, q0 + kWgRows) : seq;
  const int nkt = (kend + kKeys - 1) / kKeys;
  uint8_t* q_smem = smem;
  uint8_t* kv_smem = smem + hpc * L::kQTile;  // stage s: K, then V

  // Thread 0 issues every load: Q for all the CTA's heads and the first
  // kStages K / V tiles now, each later tile into the stage of the tile
  // before the current one (see the loop), so its warpgroup waits for the
  // others only when they lag by a tile.
  const bool issuer = threadIdx.x == 0;
  auto load_tile = [&](int kt) {
    const int s = kt % kStages;
    mbar_expect_tx(&full_bar[s], 2 * L::kKvTile);
    uint8_t* ks = kv_smem + s * 2 * L::kKvTile;
    for (int c = 0; c < HD; c += L::kCols) {
      const int off = (c / L::kCols) * kKeys * L::kRowBytes;
      tma_load(ks + off, &tm_k, c, kvh, kt * kKeys, b, &full_bar[s]);
      tma_load(ks + L::kKvTile + off, &tm_v, c, kvh, kt * kKeys, b,
               &full_bar[s]);
    }
  };
  if (issuer) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_bar[s], 1);
      mbar_init(&empty_bar[s], 4 * hpc);   // every warp
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (issuer) {
    mbar_expect_tx(&q_bar, hpc * L::kQTile);
    for (int hh = 0; hh < hpc; ++hh)
      for (int c = 0; c < HD; c += L::kCols)
        tma_load(q_smem + hh * L::kQTile + (c / L::kCols) * kWgRows *
                                               L::kRowBytes,
                 &tm_q, c, head0 + hh, q0, b, &q_bar);
    for (int kt = 0; kt < kStages && kt < nkt; ++kt) load_tile(kt);
  }
  __syncwarp();

  const int wgi = static_cast<int>(threadIdx.x) / kWgThreads;
  {
    // Consumer warpgroup wgi: q-head head0 + wgi, query rows q0 .. q0 + 63.
    const int tid = static_cast<int>(threadIdx.x) % kWgThreads;
    const int warp = tid / kWarp;
    const int lane = tid % kWarp;
    const int g = lane / 4;
    const int t = lane % 4;
    const int h = head0 + wgi;
    const int qrow[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
    const uint8_t* qs = q_smem + wgi * L::kQTile;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};   // running max, log2 domain
    float l[2] = {0.f, 0.f};
    float corr[2];
    float sc[kKeys / 2] = {};   // scores of the newest tile
    uint32_t pa[KK][4];    // P of the tile whose P·V is in flight

    // Issues S = Q K_kt^T (64 x kKeys) into sc once tile kt has landed:
    // hd / 16 k-steps of 32 bytes along the rows, committed as one group.
    // Descriptors: one base each, advanced by constant byte offsets (k-step
    // and column block) and the stage's offset, so few registers hold them.
    const uint64_t q_desc = wg::desc(qs, 16, L::kAtomBytes, kLayout);
    const uint64_t k_desc = wg::desc(kv_smem, 16, L::kAtomBytes, kLayout);
    const uint64_t v_desc = wg::desc(kv_smem + L::kKvTile,
                                     kKeys * L::kRowBytes, L::kAtomBytes,
                                     kLayout);
    auto issue_scores = [&](int kt) {
      const int s = kt % kStages;
      mbar_wait(&full_bar[s], (kt / kStages) & 1);
      const uint64_t dk = wg::advance(k_desc, s * 2 * L::kKvTile);
      wg::fence();
#pragma unroll
      for (int st = 0; st < KS; ++st) {
        const int blk = st * 16 / L::kCols;
        const int cb = (st * 16 % L::kCols) * 2;
        wg::mma_ss<T, kKeys>(
            sc, wg::advance(q_desc, blk * kWgRows * L::kRowBytes + cb),
            wg::advance(dk, blk * kKeys * L::kRowBytes + cb), st > 0);
      }
      wg::commit();
    };
    // Online softmax of tile kt's scores (in sc) on the lane's two rows:
    // P (fp32) replaces the scores, corr = exp2(m_old - m_new), m and l
    // are updated.  The max is taken on the raw scores (the scale is
    // positive), and p = exp2(s * scale_log2 - m) is one FFMA and one EX2.
    auto softmax = [&](int kt) {
      const int k0 = kt * kKeys;
      const bool masked = (causal && k0 + kKeys - 1 > q0) || (k0 + kKeys > seq);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e];
          if (masked) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            if (kpos >= seq || (causal && kpos > qrow[e >> 1])) x = kNegInf;
          }
          sc[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float neg_m[2];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]) * scale_log2);
        corr[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        neg_m[i] = -m_new;
      }
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = ex2(fmaf(sc[4 * n + e], scale_log2, neg_m[e >> 1]));
          sc[4 * n + e] = x;
          sum[e >> 1] += x;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
    };
    // P, rounded to T, into the register A operand: its fragments for keys
    // 16 kk .. 16 kk + 15 are the score accumulators of column blocks 2 kk
    // and 2 kk + 1.  Done once the previous P·V has retired, so only one
    // packed P is live.
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };

    // acc = acc * corr + P V_kt: P (pa) from registers, V from stage kt's
    // shared memory, committed as one group.  The caller has fenced.
    auto issue_pv = [&](int kt) {
      const uint64_t ds = wg::advance(v_desc, (kt % kStages) * 2 * L::kKvTile);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const uint64_t dv = wg::advance(ds, kk * 16 * L::kRowBytes);
        wg::mma_rs_mn<T, HD>(acc, pa[kk], dv);
      }
      wg::commit();
    };
    auto rescale = [&]() {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
      wg::hold(acc);
    };
    // After P V_kt has completed: P's registers and stage kt are free.
    auto retire_pv = [&](int kt) {
      wg::hold(acc);
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) wg::hold(pa[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty_bar[kt % kStages]);
    };

    // Software pipeline inside the warpgroup: while P_kt V_kt runs on the
    // tensor cores, the lanes run the softmax of tile kt + 1, whose scores
    // were issued just before it (a warpgroup's wgmma groups complete in
    // order, so waiting for all but the newest group waits for S_kt+1).
    // The steady-state body has no branch around a wgmma, commit or wait,
    // so ptxas can tell which group each wait retires.
    mbar_wait(&q_bar, 0);
    issue_scores(0);
    wg::wait<0>();
    wg::hold(sc);
    softmax(0);
    pack();
    for (int kt = 0; kt + 1 < nkt; ++kt) {
      rescale();
      issue_scores(kt + 1);   // its fence also orders acc and pa
      issue_pv(kt);
      if (threadIdx.x < kWarp && kt >= 1 && kt + kStages - 1 < nkt) {
        // The whole of warp 0 waits (no lane may reach an aligned wgmma
        // instruction alone); its first lane issues.
        mbar_wait(&empty_bar[(kt - 1) % kStages], ((kt - 1) / kStages) & 1);
        if (issuer) load_tile(kt + kStages - 1);
        __syncwarp();
      }
      wg::wait<1>();
      wg::hold(sc);
      softmax(kt + 1);
      wg::wait<0>();
      retire_pv(kt);
      pack();
    }
    rescale();
    wg::fence();
    issue_pv(nkt - 1);
    wg::wait<0>();
    retire_pv(nkt - 1);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qrow[i] >= seq) continue;
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = o + ((static_cast<int64_t>(b) * seq + qrow[i]) * heads + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + j * 8 + 2 * t) =
            pack2<T>(acc[4 * j + 2 * i] / denom, acc[4 * j + 2 * i + 1] / denom);
      // The quad's 4 lanes hold the row's m and l (log2 domain, scaled):
      // lane t == 0 writes the natural-log log-sum-exp, if asked.
      if (lse != nullptr && t == 0)
        lse[(static_cast<int64_t>(b) * heads + h) * seq + qrow[i]] =
            (m[i] + log2f(denom)) * 0.6931471805599453f;
    }
  }
}

// The CUDA driver API's cuTensorMapEncodeTiled, through the runtime's
// entry-point query (so the library needs no -lcuda); null if missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The map of a (batch, seq, heads, HD) tensor whose box is `rows` rows of
// one head and one swizzle atom's columns.
template <typename T, int HD>
bool tensor_map(CUtensorMap* map, const void* base, int64_t batch,
                int64_t seq, int64_t heads, int rows) {
  using L = Tiles<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(HD) * 2, static_cast<cuuint64_t>(heads * HD) * 2,
      static_cast<cuuint64_t>(seq * heads * HD) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::kCols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : (L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUtensorMapDataType dtype = std::is_same<T, __nv_bfloat16>::value
                                        ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, dtype, 4, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int64_t batch, int64_t seq, int64_t heads,
                 int64_t kv_heads, float scale, int causal,
                 cudaStream_t stream) {
  const int64_t rep = heads / kv_heads;
  int hpc = 1;   // the largest divisor of rep up to kMaxHeads
  for (int c = kMaxHeads; c > 1; --c) {
    if (rep % c == 0) {
      hpc = c;
      break;
    }
  }
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map<T, HD>(&tm_q, q, batch, seq, heads, kWgRows) ||
      !tensor_map<T, HD>(&tm_k, k, batch, seq, kv_heads, kKeys) ||
      !tensor_map<T, HD>(&tm_v, v, batch, seq, kv_heads, kKeys)) {
    return static_cast<int>(encode_tiled() == nullptr ? cudaErrorNotSupported
                                                      : cudaErrorInvalidValue);
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tiles<HD>::bytes(kMaxHeads));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(batch * heads / hpc),
                  static_cast<unsigned>((seq + kWgRows - 1) / kWgRows));
  flash_wgmma_kernel<T, HD>
      <<<grid, kWgThreads * hpc, Tiles<HD>::bytes(hpc), stream>>>(
          tm_q, tm_k, tm_v, static_cast<T*>(o), lse, static_cast<int>(seq),
          static_cast<int>(heads), static_cast<int>(kv_heads),
          scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

// fp32 runs the FFMA body (dynamic shared memory, above 48 KB at hd 64 and
// 128); bf16 / f16 the wgmma body.
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
           float scale, int causal, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    return launch_wgmma<T, HD>(q, k, v, o, lse, batch, seq, heads, kv_heads,
                               scale, causal, stream);
  } else {
    const dim3 grid(static_cast<unsigned>((seq + kBlockQ - 1) / kBlockQ),
                    static_cast<unsigned>(batch * heads));
    constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = true;
    }
    flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse,
        static_cast<int>(seq),
        static_cast<int>(heads), static_cast<int>(kv_heads), scale, causal);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
              int64_t head_dim, float scale, int causal,
              cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, o, lse, batch, seq, heads, kv_heads, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, batch, seq, heads, kv_heads, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, batch, seq, heads, kv_heads, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, batch, seq, heads, kv_heads, scale, causal, stream);
    default: return kUnsupported;
  }
}

}  // namespace

// q, o: (batch, seq, heads, head_dim); k, v: (batch, seq, kv_heads,
// head_dim); all contiguous, 16-byte aligned, of one dtype; scale is
// 1/sqrt(head_dim) rounded to fp32 by the caller, as the reference does.
// lse: null, or fp32 (batch, heads, seq), which takes each row's
// log-sum-exp of the scaled, masked scores (natural log; the training
// backward recomputes P = exp(s - lse) from it).  It is the last argument,
// so a caller built against the form without it passes nothing there.
// The wrapper checks shapes; heads % kv_heads == 0 and batch * heads <=
// 65535 are its contract.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int64_t batch,
                                   int64_t seq, int64_t heads,
                                   int64_t kv_heads, int64_t head_dim,
                                   float scale, int causal, int dtype,
                                   void* stream, float* lse) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_hd<float>(q, k, v, o, lse, batch, seq, heads, kv_heads, head_dim, scale, causal, s);
    case kF16:
      return launch_hd<__half>(q, k, v, o, lse, batch, seq, heads, kv_heads, head_dim, scale, causal, s);
    case kBF16:
      return launch_hd<__nv_bfloat16>(q, k, v, o, lse, batch, seq, heads, kv_heads, head_dim, scale, causal, s);
    default:
      return kUnsupported;
  }
}
