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
// inside the block: one CTA of 4 warps owns one (batch*head, 64-query
// block), each warp 16 query rows, and it loops over 64-key tiles.  Two
// bodies share that grid:
//
// bf16 / f16 (flash_mma_kernel): QKᵀ and P·V on the tensor cores with
// mma.sync m16n8k16 and fp32 accumulation, the FlashAttention-2 register
// layout.  Q's fragments are loaded once into registers; K and V tiles are
// staged in shared memory with 16-byte loads (rows padded by 8 elements, so
// the fragment loads hit 32 distinct banks); K's B fragments are 32-bit
// loads, V's come through ldmatrix.trans.  A lane holds two rows (g and
// g + 8 of its warp's 16) of the scores, their m and l, and the same rows
// of the output accumulator.  The score accumulators become P·V's A
// fragments in registers.  P must enter that product in the input dtype:
// rounded once to bf16 (8 bits) it moves the output by several bf16 ulps,
// too close to the 1e-2 check against the fp32 plain version, so for bf16
// P is split into hi + lo bf16 parts and multiplied twice (a third more
// tensor-core work, P kept to ~16 bits); f16 keeps one product (11 bits).
// mma.sync reaches a share of the tensor-core peak only: warpgroup wgmma
// with TMA staging is later work.
//
// Both bodies skip the tiles wholly past the causal frontier (the
// reference's `live` predicate; only the diagonal tile and a ragged last
// tile are masked) and launch the CTAs with the most tiles first.  Rows and
// keys past a ragged S load as zeros, keys are masked, rows are not
// written; each output element is written once.
//
// fp32 (flash_fwd_kernel): FFMA on the CUDA cores, no TF32 (the port's
// precision contract), so its floor is 68.7 GFLOP / 67 TFLOP/s = 1.03 ms at
// the serving shape.
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
#include <type_traits>

#include "panel_common.cuh"

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
                 const T* __restrict__ v, T* __restrict__ o, int seq,
                 int heads, int kv_heads, float scale, int causal) {
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
}

// ---------------------------------------------------------------------------
// bf16 / f16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ---------------------------------------------------------------------------

constexpr int kPad = 8;   // elements of padding per staged K/V row

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

// (a, b) as a packed pair of T, and the pair of what that rounding lost,
// also as T: hi + lo carries a and b to ~2^-16 for bf16.
template <typename T>
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2<T>(a, b);
  const T* h = reinterpret_cast<const T*>(&hi);
  lo = pack2<T>(a - to_acc(h[0]), b - to_acc(h[1]));
}

// d += a (16 x 16, row) * b (16 x 8, col), fp32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Four 8x8 b16 matrices from shared memory, transposed; lane l gives the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int seq,
                 int heads, int kv_heads, float scale, int causal) {
  constexpr int KS = HD / 16;            // k-steps of QKᵀ
  constexpr int NB = kBlockK / 8;        // 8-key blocks of a tile
  constexpr int NO = HD / 8;             // 8-column blocks of the output
  constexpr int VN = 8;                  // elements per 16-byte load
  constexpr int CHUNKS = HD / VN;
  constexpr int STRIDE = HD + kPad;      // staged row stride (elements)
  constexpr bool kSplitP = std::is_same<T, __nv_bfloat16>::value;

  __shared__ __align__(16) uint16_t k_smem[kBlockK * STRIDE];
  __shared__ __align__(16) uint16_t v_smem[kBlockK * STRIDE];
  T* ks = reinterpret_cast<T*>(k_smem);
  T* vs = reinterpret_cast<T*>(v_smem);

  const int nqb = gridDim.x;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x);  // longest first
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int kvh = h / (heads / kv_heads);
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int g = lane / 4;                // fragment row (and row + 8)
  const int t = lane % 4;                // fragment column pair
  const int row0 = qb * kBlockQ + warp * kRowsPerWarp;
  const int qrow[2] = {row0 + g, row0 + g + 8};

  const int64_t q_stride = static_cast<int64_t>(heads) * HD;
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * HD;
  const T* qbase = q + (static_cast<int64_t>(b) * seq * heads + h) * HD;
  const T* kbase = k + (static_cast<int64_t>(b) * seq * kv_heads + kvh) * HD;
  const T* vbase = v + (static_cast<int64_t>(b) * seq * kv_heads + kvh) * HD;
  T* obase = o + (static_cast<int64_t>(b) * seq * heads + h) * HD;

  // Q's A fragments, once: rows g / g + 8, columns 16 ks + 2 t (+8).
  uint32_t qf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = qrow[e & 1];
      const int c = s * 16 + (e >> 1) * 8 + 2 * t;
      qf[s][e] = r < seq ? *reinterpret_cast<const uint32_t*>(
                               qbase + r * q_stride + c)
                         : 0u;
    }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const int nkt = causal ? qb + 1 : nqb;

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();   // every warp is done with the previous tile
    for (int c = tid; c < kBlockK * CHUNKS; c += kThreads) {
      const int r = c / CHUNKS;
      const int d = (c % CHUNKS) * VN;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u);
      uint4 vx = kx;
      if (k0 + r < seq) {
        kx = *reinterpret_cast<const uint4*>(kbase + (k0 + r) * kv_stride + d);
        vx = *reinterpret_cast<const uint4*>(vbase + (k0 + r) * kv_stride + d);
      }
      *reinterpret_cast<uint4*>(ks + r * STRIDE + d) = kx;
      *reinterpret_cast<uint4*>(vs + r * STRIDE + d) = vx;
    }
    __syncthreads();

    // S = Q Kᵀ: s[n] holds rows g, g + 8 x keys 8 n + 2 t (+1).
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int st = 0; st < KS; ++st)
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const T* kr = ks + (n * 8 + g) * STRIDE + st * 16 + 2 * t;
        mma16816<T>(s[n], qf[st], *reinterpret_cast<const uint32_t*>(kr),
                    *reinterpret_cast<const uint32_t*>(kr + 8));
      }

    // Online softmax on the lane's two rows.
    const bool masked = (causal && kt == qb) || (k0 + kBlockK > seq);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (masked) {
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          if (kpos >= seq || (causal && kpos > qrow[e >> 1])) x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(sum[i]);
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];

    // acc += P V: P's A fragments come from the score registers.  For bf16
    // P is split into hi + lo bf16 parts (two products), so it enters P·V
    // with ~16 bits instead of 8; f16's 11 bits are used as they are.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
      uint32_t pl[4];
      split2<T>(s[2 * kk][0], s[2 * kk][1], pa[0], pl[0]);
      split2<T>(s[2 * kk][2], s[2 * kk][3], pa[1], pl[1]);
      split2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pl[2]);
      split2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pl[3]);
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t vb[4];
        const int mi = lane / 8;
        ldsm_x4_trans(vb, vs + (kk * 16 + (mi & 1) * 8 + lane % 8) * STRIDE +
                              (j + (mi >> 1)) * 8);
        mma16816<T>(acc[j], pa, vb[0], vb[1]);
        mma16816<T>(acc[j + 1], pa, vb[2], vb[3]);
        if constexpr (kSplitP) {
          mma16816<T>(acc[j], pl, vb[0], vb[1]);
          mma16816<T>(acc[j + 1], pl, vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] >= seq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(obase + qrow[i] * q_stride + j * 8 + 2 * t) =
          pack2<T>(acc[j][2 * i] / denom, acc[j][2 * i + 1] / denom);
  }
}

// fp32 runs the FFMA body (dynamic shared memory, above 48 KB at hd 64 and
// 128); bf16 / f16 the tensor-core body (static shared memory, <= 35 KB).
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
           float scale, int causal, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((seq + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(batch * heads));
  if constexpr (std::is_same<T, float>::value) {
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
        static_cast<const T*>(v), static_cast<T*>(o), static_cast<int>(seq),
        static_cast<int>(heads), static_cast<int>(kv_heads), scale, causal);
  } else {
    flash_mma_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), static_cast<int>(seq),
        static_cast<int>(heads), static_cast<int>(kv_heads), scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              int64_t batch, int64_t seq, int64_t heads, int64_t kv_heads,
              int64_t head_dim, float scale, int causal,
              cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, o, batch, seq, heads, kv_heads, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, batch, seq, heads, kv_heads, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, batch, seq, heads, kv_heads, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, batch, seq, heads, kv_heads, scale, causal, stream);
    default: return kUnsupported;
  }
}

}  // namespace

// q, o: (batch, seq, heads, head_dim); k, v: (batch, seq, kv_heads,
// head_dim); all contiguous, 16-byte aligned, of one dtype; scale is
// 1/sqrt(head_dim) rounded to fp32 by the caller, as the reference does.
// The wrapper checks shapes; heads % kv_heads == 0 and batch * heads <=
// 65535 are its contract.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int64_t batch,
                                   int64_t seq, int64_t heads,
                                   int64_t kv_heads, int64_t head_dim,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_hd<float>(q, k, v, o, batch, seq, heads, kv_heads, head_dim, scale, causal, s);
    case kF16:
      return launch_hd<__half>(q, k, v, o, batch, seq, heads, kv_heads, head_dim, scale, causal, s);
    case kBF16:
      return launch_hd<__nv_bfloat16>(q, k, v, o, batch, seq, heads, kv_heads, head_dim, scale, causal, s);
    default:
      return kUnsupported;
  }
}
