// Shared pieces of the LOOPS panel kernels (csr_spmm.cu, bcsr_spmm.cu and the
// SDD kernels csr_sdd.cu, bcsr_sdd.cu): dtype codes shared with the Python
// wrappers, the accumulator type of each storage type, conversions, warp
// reduction, and the (value dtype, output dtype) and (dY dtype, B dtype)
// dispatches.
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
// One warp owns one output row (CSR part) or block-row (BCSR part) x one
// 32-column tile; four warps per block.
constexpr int kWarpsPerBlock = 4;
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

// Sum of v over the 32 lanes of a warp, in every lane (butterfly order, the
// same on every call).
template <typename A>
__device__ __forceinline__ A warp_sum(A v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

inline dim3 panel_grid(int64_t ngroups, int64_t n, int64_t batch) {
  return dim3(static_cast<unsigned>((ngroups + kWarpsPerBlock - 1) /
                                    kWarpsPerBlock),
              static_cast<unsigned>((n + kWarp - 1) / kWarp),
              static_cast<unsigned>(batch));
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
