// B4: BCSR-part sampled dense-dense (SDD) product, the value gradient of the
// matrix-pipeline half of LOOPS, for Hopper.
//
// Replaces the TPU kernel repro/kernels/spmm_sdd.py::bcsr_sdd_panels_pallas
// (bodies _bcsr_sdd_kernel and _piped_bcsr_sdd_kernel).  For every panel p
// of the forward (P, Br, G) panel layout it computes the Br x G block
//     out[p, r, i] = sum_z sum_n dY[z, row_offset + rows[p]*Br + r, n]
//                                * B[z, cols[p, i], n]
// (the gradient at every tile slot, summed over the batch), where a row
// rows[p]*Br + r >= nrows reads as zero, and exactly 0 at masked lanes.
//
// What bounds it on the H100.  Counted once, the inputs are small (each dY
// row of the part and each referenced B row) and the operations are
// Br x G x N per panel and batch slice.  But every panel gathers its own G
// B rows, and each gathered element feeds only Br multiply-adds: at the
// FFN's shape (138,316 panels, Br 8, batch 2 x N 1024, fp32) the gathers
// move ~9 GB out of L2 (B stays in the 50 MB L2), which at the L2's few
// TB/s is the floor in practice, above the 0.54 ms operations bound.
//
// Design.  The TPU kernel keeps the panel's (Br, G) accumulator resident in
// VMEM while column and batch blocks stream past a sequential grid.  Here
// one CTA of 8 warps owns one work unit of the forward's B2 unit table
// (kernels/csr_spmm.py::unit_table_of, at most 128 panels of one
// block-row), so all its panels share one dY slab, and no panel has two
// writers: no atomics, no workspace, no second pass, and the batch sum
// runs in a fixed order (two calls give the same bits).
//   * Jobs: a panel's G lanes are cut into jobs of 8 gathered rows; the
//     unit's jobs go in quads of 4 to the warps in turn, and each lane
//     keeps the Br x 8 sums of its quads' jobs in registers (at most 4
//     quads a warp, 128 jobs a CTA; a longer unit is walked in passes).
//   * Reduction in chunks of 128 bytes of B row (32 fp32, 64 half, 16
//     fp64 columns of one batch slice).  Each chunk of the block-row's dY
//     slab (Br rows) is staged in shared memory once per unit, double
//     buffered: the next chunk's loads are issued before this chunk's
//     products and stored after them, behind one CTA barrier.
//   * Gathers: each warp stages its quad's 32 B rows x 128 bytes with
//     16-byte cp.async into its own ring of 2 stages, one step ahead of the
//     products (rows of masked lanes and columns past N are zero-filled),
//     so it synchronises with __syncwarp only.  Rows are padded by 16
//     bytes, so the reads are free of bank conflicts.  A call whose B rows are not
//     16-byte aligned stages with plain loads instead.
//   * fp32 / fp64 (and fp32 dY against f16 B, whose range cannot hold an
//     fp32 cotangent): FFMA, no TF32.  Lane (job j, lane i) multiplies its
//     B row's 16-byte vectors by the Br dY rows (shared-memory broadcasts)
//     into Br sums: no butterfly.
//   * bf16 / f16: mma.sync m16n8k16 with fp32 accumulation.  A job's 16 x 8
//     output (Br rows, padded to 16 with zero rows) is one tile: A is the
//     dY chunk (ldmatrix), B the job's 8 gathered rows ("col", read as
//     stored).  fp32 dY against bf16 B (the FFN's bf16 backward) splits dY
//     into hi + mid + lo bf16 parts at staging, three products a step,
//     which keeps dY's 24 bits (B is exact in bf16).
#include <type_traits>

#include "panel_common.cuh"

using namespace loops;

namespace {

// Shape choices, measured with kernel_sweep.py (PERF.md).
constexpr int kSddWarps = 8;        // warps of a CTA
constexpr int kBStages = 2;         // per-warp ring of gathered tiles
constexpr int kMaxRounds = 4;       // quads a warp keeps sums for
constexpr int kMinBlocks = 2;       // CTAs an SM must hold (caps registers)
constexpr int kSddThreads = kSddWarps * kWarp;
constexpr int kJobRows = 8;         // gathered B rows of one job
constexpr int kJobsPerStep = 4;     // jobs (a quad) a warp stages per step
constexpr int kTileRows = kJobRows * kJobsPerStep;
constexpr int kLineBytes = 128;     // bytes of a B row per chunk
constexpr int kRowStride = kLineBytes + 16;   // padded: conflict-free reads

template <typename TD, typename TB>
struct SddTraits {
  using Acc = typename AccOf<TB>::type;
  // Tensor cores for half B, except fp32 dY against f16 B (see the note).
  static constexpr bool kMma =
      sizeof(TB) == 2 && !(sizeof(TD) == 4 && std::is_same<TB, __half>::value);
  static constexpr int kPieces = kMma && sizeof(TD) == 4 ? 3 : 1;
  static constexpr int kChunk = kLineBytes / static_cast<int>(sizeof(TB));
};

template <typename TD, typename TB, int BR>
struct SddShape {
  using Tr = SddTraits<TD, TB>;
  using Acc = typename Tr::Acc;
  // FFMA keeps R x Br sums a lane: at most 64 registers (fp64 Br 16: 2).
  static constexpr int kFfmaRounds =
      64 / (BR * static_cast<int>(sizeof(Acc) / 4));
  static constexpr int kRounds =
      Tr::kMma || kFfmaRounds > kMaxRounds ? kMaxRounds : kFfmaRounds;
  static constexpr int kCapJobs = kSddWarps * kJobsPerStep * kRounds;
  // Staged dY rows (16 for the tensor-core tile) and their element stride.
  static constexpr int kDyRows = Tr::kMma ? 16 : BR;
  static constexpr int kDyStride =
      Tr::kMma ? Tr::kChunk + 8 : Tr::kChunk + 16 / static_cast<int>(sizeof(Acc));
  static constexpr int kDyBytes =
      Tr::kMma ? Tr::kPieces * kDyRows * kDyStride * 2
               : kDyRows * kDyStride * static_cast<int>(sizeof(Acc));
  static constexpr int kTileBytes = kTileRows * kRowStride;
  static constexpr int kSmemBytes = kSddWarps * kBStages * kTileBytes +
                                    2 * kDyBytes + kCapJobs * kJobRows * 4;
  // dY elements each thread loads per chunk.
  static constexpr int kDyPerThread =
      (kDyRows * Tr::kChunk + kSddThreads - 1) / kSddThreads;
};

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
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

template <typename T>
__device__ __forceinline__ T zero_of() {
  return T(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of() {
  return __float2bfloat16_rn(0.f);
}
template <>
__device__ __forceinline__ __half zero_of() {
  return __float2half_rn(0.f);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float(float x) {
  return __float2half_rn(x);
}

template <typename TD, typename TB, int BR>
__global__ void __launch_bounds__(kSddThreads, kMinBlocks)
bcsr_sdd_unit_kernel(const int64_t* __restrict__ units,
                     const int32_t* __restrict__ cols,
                     const bool* __restrict__ mask, const TD* __restrict__ dy,
                     const TB* __restrict__ b,
                     typename AccOf<TB>::type* __restrict__ out, int64_t g,
                     int64_t m, int64_t k, int64_t n, int64_t batch,
                     int64_t row_offset, int64_t nrows, int vec) {
  using Tr = SddTraits<TD, TB>;
  using Sh = SddShape<TD, TB, BR>;
  using A = typename Tr::Acc;
  constexpr int RC = Tr::kChunk;
  constexpr int R = Sh::kRounds;
  constexpr int VE = 16 / static_cast<int>(sizeof(TB));  // per 16 bytes

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tiles = smem;   // [warp][stage][kTileRows][kRowStride]
  uint8_t* dy_smem = tiles + kSddWarps * kBStages * Sh::kTileBytes;
  int32_t* srow = reinterpret_cast<int32_t*>(dy_smem + 2 * Sh::kDyBytes);

  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int64_t* unit = units + static_cast<int64_t>(blockIdx.x) * 4;
  const int64_t blk = unit[0];
  const int64_t p0 = unit[1];
  const int64_t gjobs = (g + kJobRows - 1) / kJobRows;   // jobs a panel
  const int64_t njobs_all = (unit[2] - p0) * gjobs;
  const int64_t r0 = blk * BR;
  const int64_t left = nrows - r0;
  const int live_rows = left <= 0 ? 0 : (left < BR ? static_cast<int>(left)
                                                   : BR);
  const int64_t nck = (n + RC - 1) / RC;   // column chunks of a slice
  const int64_t nchunks = batch * nck;
  uint8_t* my_tiles = tiles + warp * kBStages * Sh::kTileBytes;

  // Loads this thread's share of dY chunk c into registers (zeros past
  // the part's rows, past Br and past N).
  auto load_dy = [&](int64_t c, A (&v)[Sh::kDyPerThread]) {
    const int64_t z = c / nck;
    const int64_t n0 = (c % nck) * RC;
#pragma unroll
    for (int e = 0; e < Sh::kDyPerThread; ++e) {
      const int idx = tid + e * kSddThreads;
      const int r = idx / RC;
      const int64_t col = n0 + idx % RC;
      v[e] = A(0);
      if (idx < Sh::kDyRows * RC && r < live_rows && col < n)
        v[e] = to_acc(dy[(z * m + row_offset + r0 + r) * n + col]);
    }
  };
  // Stores them into buffer `buf`: as A for FFMA, as kPieces parts of TB
  // (hi, mid, lo) for the tensor cores.
  auto store_dy = [&](int buf, const A (&v)[Sh::kDyPerThread]) {
    uint8_t* base = dy_smem + buf * Sh::kDyBytes;
#pragma unroll
    for (int e = 0; e < Sh::kDyPerThread; ++e) {
      const int idx = tid + e * kSddThreads;
      if (idx >= Sh::kDyRows * RC) continue;
      const int off = (idx / RC) * Sh::kDyStride + idx % RC;
      if constexpr (Tr::kMma) {
        TB* p = reinterpret_cast<TB*>(base);
        float x = static_cast<float>(v[e]);
#pragma unroll
        for (int pc = 0; pc < Tr::kPieces; ++pc) {
          const TB part = from_float<TB>(x);
          p[pc * Sh::kDyRows * Sh::kDyStride + off] = part;
          x -= to_acc(part);
        }
      } else {
        reinterpret_cast<A*>(base)[off] = v[e];
      }
    }
  };
  // Issues the gathers of this warp's step s into its ring.
  auto issue = [&](int64_t s, int64_t rw, int njobs) {
    const int64_t c = s / rw;
    const int quad = warp + static_cast<int>(s % rw) * kSddWarps;
    const int64_t z = c / nck;
    const int64_t n0 = (c % nck) * RC;
    uint8_t* tile = my_tiles + static_cast<int>(s % kBStages) * Sh::kTileBytes;
    const int seg = lane % 8;
    const int64_t col = n0 + seg * VE;
#pragma unroll
    for (int q8 = 0; q8 < kTileRows / 4; ++q8) {
      const int trow = lane / 8 + 4 * q8;
      const int jb = quad * kJobsPerStep + trow / kJobRows;
      const int src = jb < njobs ? srow[jb * kJobRows + trow % kJobRows] : -1;
      uint8_t* dst = tile + trow * kRowStride + seg * 16;
      const bool ok = src >= 0 && col < n;
      const TB* gp = b + (z * k + (ok ? src : 0)) * n + (ok ? col : 0);
      if (vec) {
        cp_async16(dst, gp, ok ? 16 : 0);
      } else {
        Pack<TB, VE> x;
#pragma unroll
        for (int e = 0; e < VE; ++e)
          x.v[e] = ok && col + e < n ? gp[e] : zero_of<TB>();
        *reinterpret_cast<Pack<TB, VE>*>(dst) = x;
      }
    }
  };

  for (int64_t j0 = 0; j0 < njobs_all; j0 += Sh::kCapJobs) {
    const int njobs = static_cast<int>(
        njobs_all - j0 < Sh::kCapJobs ? njobs_all - j0 : Sh::kCapJobs);
    __syncthreads();   // the previous pass is done with srow and dY
    for (int idx = tid; idx < njobs * kJobRows; idx += kSddThreads) {
      const int64_t job = j0 + idx / kJobRows;
      const int64_t p = p0 + job / gjobs;
      const int64_t li = (job % gjobs) * kJobRows + idx % kJobRows;
      srow[idx] = li < g && mask[p * g + li] ? cols[p * g + li] : -1;
    }
    {
      A v[Sh::kDyPerThread];
      load_dy(0, v);
      store_dy(0, v);
    }
    __syncthreads();

    const int nq = (njobs + kJobsPerStep - 1) / kJobsPerStep;
    const int64_t rw = warp < nq ? (nq - warp + kSddWarps - 1) / kSddWarps : 0;
    const int64_t total = nchunks * rw;   // steps of this warp
    float mma_acc[Tr::kMma ? R : 1][kJobsPerStep][4];
    A ffma_acc[Tr::kMma ? 1 : R][BR];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < kJobsPerStep; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mma_acc[Tr::kMma ? r : 0][j][e] = 0.f;
#pragma unroll
      for (int rr = 0; rr < BR; ++rr) ffma_acc[Tr::kMma ? 0 : r][rr] = A(0);
    }
#pragma unroll
    for (int s = 0; s < kBStages - 1; ++s) {
      if (s < total) issue(s, rw, njobs);
      cp_async_commit();
    }

    for (int64_t c = 0; c < nchunks; ++c) {
      A next[Sh::kDyPerThread];
      if (c + 1 < nchunks) load_dy(c + 1, next);
      const uint8_t* dyb = dy_smem + static_cast<int>(c & 1) * Sh::kDyBytes;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rw) {
          const int64_t s = c * rw + r;
          if (s + kBStages - 1 < total) issue(s + kBStages - 1, rw, njobs);
          cp_async_commit();
          cp_async_wait<kBStages - 1>();
          __syncwarp();
          const uint8_t* tile =
              my_tiles + static_cast<int>(s % kBStages) * Sh::kTileBytes;
          if constexpr (Tr::kMma) {
            const int gq = lane / 4;
            const int t = lane % 4;
            const TB* dyp = reinterpret_cast<const TB*>(dyb);
            // One k-step's A parts live at a time (unrolled, all four
            // would spill beside the 64 accumulators).
#pragma unroll 1
            for (int ks = 0; ks < RC / 16; ++ks) {
              uint32_t a[Tr::kPieces][4];
#pragma unroll
              for (int pc = 0; pc < Tr::kPieces; ++pc)
                ldsm_x4(a[pc], dyp + pc * Sh::kDyRows * Sh::kDyStride +
                                   (lane % 16) * Sh::kDyStride + ks * 16 +
                                   (lane / 16) * 8);
#pragma unroll
              for (int j = 0; j < kJobsPerStep; ++j) {
                const uint8_t* br = tile + (j * kJobRows + gq) * kRowStride +
                                    (ks * 16 + 2 * t) * 2;
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br);
                const uint32_t b1 = *reinterpret_cast<const uint32_t*>(br + 16);
#pragma unroll
                for (int pc = 0; pc < Tr::kPieces; ++pc)
                  mma16816<TB>(mma_acc[Tr::kMma ? r : 0][j], a[pc], b0, b1);
              }
            }
          } else {
            const A* dya = reinterpret_cast<const A*>(dyb);
            const uint8_t* br = tile + lane * kRowStride;   // job lane / 8
#pragma unroll
            for (int cc = 0; cc < RC; cc += VE) {
              const Pack<TB, VE> x =
                  *reinterpret_cast<const Pack<TB, VE>*>(br + cc * sizeof(TB));
              A bv[VE];
#pragma unroll
              for (int e = 0; e < VE; ++e) bv[e] = to_acc(x.v[e]);
#pragma unroll
              for (int rr = 0; rr < BR; ++rr) {
                constexpr int PV = 16 / static_cast<int>(sizeof(A));
                A d[VE];
#pragma unroll
                for (int q = 0; q < VE; q += PV) {
                  const Pack<A, PV> pk = *reinterpret_cast<const Pack<A, PV>*>(
                      dya + rr * Sh::kDyStride + cc + q);
#pragma unroll
                  for (int e = 0; e < PV; ++e) d[q + e] = pk.v[e];
                }
                A sum = ffma_acc[Tr::kMma ? 0 : r][rr];
#pragma unroll
                for (int e = 0; e < VE; ++e) sum += d[e] * bv[e];
                ffma_acc[Tr::kMma ? 0 : r][rr] = sum;
              }
            }
          }
          __syncwarp();   // the stage may be refilled
        }
      }
      if (c + 1 < nchunks) store_dy(static_cast<int>((c + 1) & 1), next);
      __syncthreads();
    }
    cp_async_wait<0>();

    // Each lane writes its sums; masked lanes exactly 0.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rw) continue;
      const int quad = warp + r * kSddWarps;
      if constexpr (Tr::kMma) {
        const int gq = lane / 4;
        const int t = lane % 4;
#pragma unroll
        for (int j = 0; j < kJobsPerStep; ++j) {
          const int jb = quad * kJobsPerStep + j;
          if (jb >= njobs) continue;
          const int64_t job = j0 + jb;
          const int64_t p = p0 + job / gjobs;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = gq + 8 * (e >> 1);
            const int li8 = 2 * t + (e & 1);
            const int64_t li = (job % gjobs) * kJobRows + li8;
            if (row < BR && li < g) {
              out[(p * BR + row) * g + li] =
                  srow[jb * kJobRows + li8] >= 0 ? mma_acc[Tr::kMma ? r : 0][j][e]
                                                 : 0.f;
            }
          }
        }
      } else {
        const int jb = quad * kJobsPerStep + lane / kJobRows;
        if (jb >= njobs) continue;
        const int64_t job = j0 + jb;
        const int64_t p = p0 + job / gjobs;
        const int64_t li = (job % gjobs) * kJobRows + lane % kJobRows;
        if (li >= g) continue;
        const bool live = srow[jb * kJobRows + lane % kJobRows] >= 0;
#pragma unroll
        for (int rr = 0; rr < BR; ++rr)
          out[(p * BR + rr) * g + li] =
              live ? static_cast<A>(ffma_acc[Tr::kMma ? 0 : r][rr]) : A(0);
      }
    }
  }
}

template <typename TD, typename TB, int BR>
int launch(const void* units, const void* cols, const void* mask,
           const void* dy, const void* b, void* out, int64_t nunits,
           int64_t g, int64_t m, int64_t k, int64_t n, int64_t batch,
           int64_t row_offset, int64_t nrows, cudaStream_t s) {
  using Sh = SddShape<TD, TB, BR>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        bcsr_sdd_unit_kernel<TD, TB, BR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int vec = (n * static_cast<int64_t>(sizeof(TB))) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(b) % 16 == 0;
  bcsr_sdd_unit_kernel<TD, TB, BR>
      <<<static_cast<unsigned>(nunits), kSddThreads, Sh::kSmemBytes, s>>>(
          static_cast<const int64_t*>(units),
          static_cast<const int32_t*>(cols), static_cast<const bool*>(mask),
          static_cast<const TD*>(dy), static_cast<const TB*>(b),
          static_cast<typename AccOf<TB>::type*>(out), g, m, k, n, batch,
          row_offset, nrows, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point.  Pointers are device pointers of contiguous tensors: units
// (nunits, 4) int64, the block-rows' unit table (group, first panel, end
// panel, slot; the slot is not read), cols (P, G) int32, mask (P, G) bool,
// dy (batch, m, n) TD, b (batch, k, n) TB, out (P, br, G) in TB's
// accumulation type; the part's rows of dy are [row_offset, row_offset +
// nrows).  Every panel must lie in exactly one unit.  Returns 0, the CUDA
// error of the launch, or kUnsupported (dtype pair, or br not in
// {4, 8, 16}).
extern "C" int bcsr_sdd_panels(const void* units, const void* cols,
                               const void* mask, const void* dy,
                               const void* b, void* out, int64_t nunits,
                               int64_t br, int64_t g, int64_t m, int64_t k,
                               int64_t n, int64_t batch, int64_t row_offset,
                               int64_t nrows, int dy_dtype, int b_dtype,
                               void* stream) {
  if (br != 4 && br != 8 && br != 16) return loops::kUnsupported;
  if (nunits == 0 || g == 0) return 0;
  if (nunits > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_BR(TD, TB, BR)                                               \
  return launch<TD, TB, BR>(units, cols, mask, dy, b, out, nunits, g, m, k, \
                            n, batch, row_offset, nrows, s);
#define LAUNCH(TD, TB)      \
  if (br == 4) {            \
    LAUNCH_BR(TD, TB, 4)    \
  } else if (br == 8) {     \
    LAUNCH_BR(TD, TB, 8)    \
  } else {                  \
    LAUNCH_BR(TD, TB, 16)   \
  }
  LOOPS_DISPATCH_SDD(dy_dtype, b_dtype, LAUNCH)
#undef LAUNCH
#undef LAUNCH_BR
  return 0;
}
