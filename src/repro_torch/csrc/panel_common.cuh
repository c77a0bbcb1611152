// Shared pieces of the LOOPS panel kernels (csr_spmm.cu, bcsr_spmm.cu and the
// SDD kernels csr_sdd.cu, bcsr_sdd.cu): dtype codes shared with the Python
// wrappers, the accumulator type of each storage type, conversions, warp
// reduction, 16-byte cp.async copies, the (value dtype, output dtype) and
// (dY dtype, B dtype) dispatches, and the work-unit pieces of the two SpMM
// kernels (vector loads, the column-tile width, the second pass over split
// groups).
//
// Precision contract (the reference's kernels/engine.py::acc_dtype_for):
// fp32 accumulates in fp32 with FFMA (no TF32 anywhere), fp64 in fp64 with
// DFMA, bf16/f16 are converted with __bfloat162float/__half2float and
// accumulate in fp32.  The output is the accumulator type unless the caller
// asks for the storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace loops {

// Must match repro_torch/kernels/_build.py::DTYPE_CODES.
enum DType : int { kF32 = 0, kF64 = 1, kF16 = 2, kBF16 = 3 };

// Returned for a dtype combination or tile height no kernel is built for.
constexpr int kUnsupported = -1;

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }
__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; `bytes` = 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum of v over the 32 lanes of a warp, in every lane (butterfly order, the
// same on every call).
template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Work units of the SpMM kernels B1 and B2.
//
// The host plans a part's panels into units (repro_torch/kernels/
// csr_spmm.py::unit_table_of): row u of the (nunits, 4) int64 table is
// (group, first panel, end panel, slot).  A unit holds at most U panels of
// one group; a group longer than U is split into consecutive units whose
// partial sums go to consecutive workspace slots (slot >= 0), and an unsplit
// group's unit writes its rows straight into the output (slot = -1).  Row s
// of the (nsplit, 3) int64 split table is (group, first slot, end slot).
// ---------------------------------------------------------------------------

// Warps per block of the unit pass (one warp per unit x column tile).
constexpr int kUnitWarps = 4;
// Most warps one split group's team may have in the second pass, and the
// fewest warps of a second-pass block (teams of fewer warps share one).
constexpr int kReduceMaxWarps = 16;
constexpr int kReduceMinWarps = 4;
// Register words of accumulators one lane may hold (Br x V x words).
constexpr int kMaxAccWords = 64;

// V consecutive elements, loaded or stored as one aligned access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// B-row gathers a lane issues before the first multiply-add that consumes
// them: 32 bytes of each lane's loads in flight, 1 KB a warp (eight 128-byte
// lines), between 4 and 16 gathers.
template <typename T, int V>
__host__ __device__ constexpr int gathers_in_flight() {
  constexpr int d = 32 / (V * static_cast<int>(sizeof(T)));
  return d < 4 ? 4 : (d > 16 ? 16 : d);
}

// Columns per lane (1, 2 or 4) of a call: 4 above N = 64, 2 above N = 32,
// halved until N is a multiple of V, both B and the output are aligned to a
// whole Pack, and Br x V accumulators fit kMaxAccWords registers.  A warp
// then covers 32 * V columns and reads a unit's metadata once per 32 * V.
inline int columns_per_lane(int64_t n, int acc_words_per_col, const void* b,
                            int b_elem, const void* out, int out_elem) {
  int v = n > 64 ? 4 : (n > 32 ? 2 : 1);
  while (v > 1 &&
         (n % v != 0 || acc_words_per_col * v > kMaxAccWords ||
          reinterpret_cast<uintptr_t>(b) % (v * b_elem) != 0 ||
          reinterpret_cast<uintptr_t>(out) % (v * out_elem) != 0)) {
    v /= 2;
  }
  return v;
}

inline dim3 unit_grid(int64_t nunits, int64_t n, int v, int64_t batch) {
  const int64_t cols = static_cast<int64_t>(kWarp) * v;
  return dim3(static_cast<unsigned>((nunits + kUnitWarps - 1) / kUnitWarps),
              static_cast<unsigned>((n + cols - 1) / cols),
              static_cast<unsigned>(batch));
}

// acc (V columns of one output row) converted to O and stored at p.
template <typename O, typename A, int V>
__device__ __forceinline__ void store_pack(O* p, const A (&acc)[V]) {
  Pack<O, V> o;
#pragma unroll
  for (int q = 0; q < V; ++q) store(&o.v[q], acc[q]);
  *reinterpret_cast<Pack<O, V>*>(p) = o;
}

// The second pass.  Workspace ws is (slots, batch, BR, n) in the
// accumulation type A.  A team of `team` warps (a power of two, sized on
// the host to the longest split group) owns one split group x one column
// tile of 32 * V columns x one batch slice; a block holds
// blockDim.x / (32 * team) teams.  Warp m of a team adds the group's slots
// first + m, first + m + team, ... in that order, the loads of kUnroll
// slots at a time; then the team's first warp adds the team's sums in warp
// order and stores rows row_offset + group * BR + r.  The order is fixed,
// so two runs give the same bits; each output row is written once.
template <typename A, typename O, int BR, int V>
__global__ void __launch_bounds__(kWarp * kReduceMaxWarps)
reduce_partials_kernel(const int64_t* __restrict__ splits,
                       const A* __restrict__ ws, O* __restrict__ out,
                       int64_t nsplit, int team, int64_t batch, int64_t n,
                       int64_t out_rows, int64_t row_offset) {
  constexpr int kUnroll = BR * V >= 16 ? 1 : 16 / (BR * V);
  __shared__ A part[kReduceMaxWarps][kWarp * V];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int m = w % team;
  const int64_t sg =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp / team) +
      w / team;
  const bool has = sg < nsplit;  // uniform across the team
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * kWarp + lane) * V;
  const int64_t z = blockIdx.z;
  const bool live = has && col < n;  // n % V == 0
  int64_t group = 0, first = 0, end = 0;
  if (has) {
    group = splits[sg * 3];
    first = splits[sg * 3 + 1];
    end = splits[sg * 3 + 2];
  }
  A acc[BR][V];
#pragma unroll
  for (int r = 0; r < BR; ++r) {
#pragma unroll
    for (int q = 0; q < V; ++q) acc[r][q] = A(0);
  }
  if (live) {
    for (int64_t s0 = first + m; s0 < end;
         s0 += static_cast<int64_t>(kUnroll) * team) {
      Pack<A, V> x[kUnroll][BR];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t s = s0 + static_cast<int64_t>(u) * team;
#pragma unroll
        for (int r = 0; r < BR; ++r) x[u][r] = Pack<A, V>{};
        if (s < end) {
          const A* p = ws + ((s * batch + z) * BR) * n + col;
#pragma unroll
          for (int r = 0; r < BR; ++r) {
            x[u][r] = *reinterpret_cast<const Pack<A, V>*>(p + r * n);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int r = 0; r < BR; ++r) {
#pragma unroll
          for (int q = 0; q < V; ++q) acc[r][q] += x[u][r].v[q];
        }
      }
    }
  }
  O* o = out + (z * out_rows + row_offset + group * BR) * n + col;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
#pragma unroll
    for (int q = 0; q < V; ++q) part[w][lane * V + q] = acc[r][q];
    __syncthreads();
    if (m == 0 && live) {
      A t[V];
#pragma unroll
      for (int q = 0; q < V; ++q) t[q] = part[w][lane * V + q];
      for (int j = 1; j < team; ++j) {
#pragma unroll
        for (int q = 0; q < V; ++q) t[q] += part[w + j][lane * V + q];
      }
      store_pack(o + r * n, t);
    }
    __syncthreads();
  }
}

// Warps per team of the second pass: one per 8 slots of the longest split
// group, a power of two up to kReduceMaxWarps.
inline int reduce_team(int64_t max_slots) {
  int team = 1;
  while (team < kReduceMaxWarps && team * 8 < max_slots) team *= 2;
  return team;
}

// Launches the second pass over nsplit split groups (a no-op when there are
// none).
template <typename A, typename O, int BR, int V>
void reduce_partials(const void* splits, const void* ws, void* out,
                     int64_t nsplit, int64_t max_slots, int64_t batch,
                     int64_t n, int64_t out_rows, int64_t row_offset,
                     cudaStream_t s) {
  if (nsplit == 0) return;
  const int team = reduce_team(max_slots);
  const int warps = team > kReduceMinWarps ? team : kReduceMinWarps;
  const int64_t teams = warps / team;
  const int64_t cols = static_cast<int64_t>(kWarp) * V;
  const dim3 grid(static_cast<unsigned>((nsplit + teams - 1) / teams),
                  static_cast<unsigned>((n + cols - 1) / cols),
                  static_cast<unsigned>(batch));
  reduce_partials_kernel<A, O, BR, V><<<grid, kWarp * warps, 0, s>>>(
      static_cast<const int64_t*>(splits), static_cast<const A*>(ws),
      static_cast<O*>(out), nsplit, team, batch, n, out_rows, row_offset);
}

}  // namespace loops

// Expands LAUNCH(T, O) for the supported (value dtype, output dtype) pairs;
// any other pair returns kUnsupported from the enclosing C entry point.
#define LOOPS_DISPATCH_DTYPES(dtype, out_dtype, LAUNCH)                     \
  switch ((dtype) * 4 + (out_dtype)) {                                       \
    case loops::kF32 * 4 + loops::kF32: LAUNCH(float, float); break;         \
    case loops::kF64 * 4 + loops::kF64: LAUNCH(double, double); break;       \
    case loops::kF16 * 4 + loops::kF32: LAUNCH(__half, float); break;        \
    case loops::kF16 * 4 + loops::kF16: LAUNCH(__half, __half); break;      \
    case loops::kBF16 * 4 + loops::kF32:                                     \
      LAUNCH(__nv_bfloat16, float); break;                                   \
    case loops::kBF16 * 4 + loops::kBF16:                                    \
      LAUNCH(__nv_bfloat16, __nv_bfloat16); break;                           \
    default: return loops::kUnsupported;                                     \
  }

// Expands LAUNCH(TD, TB) for the supported (cotangent dtype, operand dtype)
// pairs of the SDD kernels: the operand's own dtype, or fp32 cotangents
// against half operands (the training backward, where dY is the fp32 output
// of a half-precision forward).  Any other pair returns kUnsupported.
#define LOOPS_DISPATCH_SDD(dy_dtype, b_dtype, LAUNCH)                        \
  switch ((dy_dtype) * 4 + (b_dtype)) {                                      \
    case loops::kF32 * 4 + loops::kF32: LAUNCH(float, float); break;         \
    case loops::kF64 * 4 + loops::kF64: LAUNCH(double, double); break;       \
    case loops::kF16 * 4 + loops::kF16: LAUNCH(__half, __half); break;       \
    case loops::kBF16 * 4 + loops::kBF16:                                    \
      LAUNCH(__nv_bfloat16, __nv_bfloat16); break;                           \
    case loops::kF32 * 4 + loops::kF16: LAUNCH(float, __half); break;        \
    case loops::kF32 * 4 + loops::kBF16:                                     \
      LAUNCH(float, __nv_bfloat16); break;                                   \
    default: return loops::kUnsupported;                                     \
  }
