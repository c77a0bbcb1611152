// wkv6: the RWKV-6 time-mix recurrence (forward) for Hopper.
//
// Replaces no TPU kernel: the reference runs this recurrence as a
// lax.scan over time, repro/models/rwkv6.py::_wkv_scan, which XLA compiles;
// in eager PyTorch the same scan is a Python loop of ~6 small launches a
// time step (about 400k a 32-layer prefill at 4 x 2048 tokens), so the
// port's ssm family gets a kernel of its own.  For r, k, v, w (B, T, H, N)
// fp32, u (H, N) fp32 and a state S (B, H, N, N) fp32 it computes, per
// (b, h) and step t,
//     y_t[m] = sum_n r_t[n] (S[n, m] + u[n] k_t[n] v_t[m])
//     S[n, m] <- w_t[n] S[n, m] + k_t[n] v_t[m]
// reading S_0 from `state` (or zeros with `zero_init`) and writing S_T back
// into it in place (the serving pool's slot cache), and y (B, T, H, N).
// Everything is fp32, as the reference streams it.  The bonus term is
// written as y_t[m] = sum_n r_t[n] S[n, m] + v_t[m] (sum_n r_t[n] u[n]
// k_t[n]): the second sum is one scalar a step and head, so a state element
// costs one FFMA for y and a multiply and an FFMA for its update.
//
// What bounds it on the H100: bytes.  At (4, 2048, 40, 64) r, k, v, w and y
// are 83.9 MB each and S_0, S_T 2.6 MB each, 424.7 MB in all, 0.127 ms at
// 3.35 TB/s; the 5 flops a state element and step are 6.7 GFLOP, 0.100 ms
// at 67 TFLOP/s fp32.  A scan is sequential in t, so the kernel is bound
// in practice by the latency of a step times T unless enough (b, h, column)
// work runs side by side.
//
// Design.  Column m of S evolves with v_t[m] alone, so the N columns of a
// head split across CTAs freely: one CTA of 128 threads owns kCols = 32
// columns of one (b, h), which at B 4, H 40 gives 320 CTAs for 132 SMs.
// Four threads share a column, each holding kRows = 16 of its rows in
// registers; y[m] is their sum, two xor-shuffles within the quad.  Time is
// staged kChunk = 16 steps at a time: r, k and w rows (N each, padded by 4
// floats after every 16 so the four row groups of a quarter-warp read
// distinct banks) and the CTA's 32 v columns, by 16-byte cp.async into one
// of two stages while the other is consumed.  Once a stage has landed, each
// warp forms the bonus scalars of its steps (u lives in registers), and
// then the threads run the stage's steps with no barrier between them.
// The launch allocates nothing and reads nothing on the host, so it is
// graph-capturable.  Only N = 64 is built (the wrapper raises for others).
#include "panel_common.cuh"

namespace {

using loops::cp_async16;
using loops::cp_async_commit;
using loops::cp_async_wait;
using loops::kFull;
using loops::warp_sum;

constexpr int kN = 64;                     // head size: S is kN x kN
constexpr int kCols = 32;                  // state columns a CTA owns
constexpr int kSplit = 4;                  // threads a column
constexpr int kRows = kN / kSplit;         // rows a thread holds
constexpr int kThreads = kCols * kSplit;   // 128
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;                 // time steps a stage holds
constexpr int kGap = 4;                    // padding floats after kRows
constexpr int kPad = kN + (kN / kRows) * kGap;   // 80
constexpr int kVec = kN / 4;               // float4s of an N row

static_assert(kThreads % 32 == 0 && kRows % 4 == 0, "tile shape");

__device__ __forceinline__ int padded(int n) {
  return n + (n / kRows) * kGap;
}

struct Stage {
  float r[kChunk][kPad];
  float k[kChunk][kPad];
  float w[kChunk][kPad];
  float v[kChunk][kCols];
  float bonus[kChunk];
};

// Stage `steps` time steps from t0 on: the r, k and w rows of (b, h) and v's
// columns [col0, col0 + kCols).  `base` is the offset of (b, t = 0, h, 0).
__device__ __forceinline__ void load_stage(Stage& st, const float* r,
                                           const float* k, const float* w,
                                           const float* v, int64_t base,
                                           int64_t tstride, int t0, int steps,
                                           int col0) {
  constexpr int kRowCopies = kChunk * kVec;
  for (int i = threadIdx.x; i < 3 * kRowCopies; i += kThreads) {
    const int which = i / kRowCopies;
    const int s = (i % kRowCopies) / kVec;
    const int c = i % kVec;
    if (s >= steps) continue;
    const float* src = (which == 0 ? r : which == 1 ? k : w) + base +
                       (t0 + s) * tstride + c * 4;
    float* row = which == 0 ? st.r[s] : which == 1 ? st.k[s] : st.w[s];
    cp_async16(row + padded(c * 4), src, 16);
  }
  constexpr int kColVec = kCols / 4;
  for (int i = threadIdx.x; i < kChunk * kColVec; i += kThreads) {
    const int s = i / kColVec;
    const int c = i % kColVec;
    if (s >= steps) continue;
    cp_async16(st.v[s] + c * 4, v + base + (t0 + s) * tstride + col0 + c * 4,
               16);
  }
}

__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ state,
                float* __restrict__ y, int T, int H, int zero_init) {
  __shared__ __align__(16) Stage stages[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = tid / kSplit;
  const int q = tid % kSplit;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int col0 = blockIdx.x * kCols;
  const int m = col0 + col;
  const int64_t tstride = static_cast<int64_t>(H) * kN;
  const int64_t base = (static_cast<int64_t>(b) * T * H + h) * kN;
  float* sp = state + static_cast<int64_t>(bh) * kN * kN + m;

  float S[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    S[j] = zero_init ? 0.f : sp[(q * kRows + j) * kN];
  const float u0 = u[h * kN + lane];
  const float u1 = u[h * kN + lane + 32];

  const int nchunks = (T + kChunk - 1) / kChunk;
  if (nchunks > 0) {
    load_stage(stages[0], r, k, w, v, base, tstride, 0, min(kChunk, T), col0);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kChunk;
    const int steps = min(kChunk, T - t0);
    Stage& st = stages[c & 1];
    if (c + 1 < nchunks) {
      load_stage(stages[(c + 1) & 1], r, k, w, v, base, tstride, t0 + kChunk,
                 min(kChunk, T - t0 - kChunk), col0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int s = warp; s < steps; s += kWarps) {
      const int n0 = padded(lane), n1 = padded(lane + 32);
      float a = st.r[s][n0] * u0 * st.k[s][n0] + st.r[s][n1] * u1 * st.k[s][n1];
      a = warp_sum(a);
      if (lane == 0) st.bonus[s] = a;
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      const float vm = st.v[s][col];
      const float4* rr = reinterpret_cast<const float4*>(st.r[s] + q * (kRows + kGap));
      const float4* kk = reinterpret_cast<const float4*>(st.k[s] + q * (kRows + kGap));
      const float4* ww = reinterpret_cast<const float4*>(st.w[s] + q * (kRows + kGap));
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) {
        const float4 r4 = rr[i], k4 = kk[i], w4 = ww[i];
        acc0 = fmaf(r4.x, S[4 * i + 0], acc0);
        acc1 = fmaf(r4.y, S[4 * i + 1], acc1);
        acc0 = fmaf(r4.z, S[4 * i + 2], acc0);
        acc1 = fmaf(r4.w, S[4 * i + 3], acc1);
        S[4 * i + 0] = fmaf(w4.x, S[4 * i + 0], k4.x * vm);
        S[4 * i + 1] = fmaf(w4.y, S[4 * i + 1], k4.y * vm);
        S[4 * i + 2] = fmaf(w4.z, S[4 * i + 2], k4.z * vm);
        S[4 * i + 3] = fmaf(w4.w, S[4 * i + 3], k4.w * vm);
      }
      float acc = acc0 + acc1;
      acc += __shfl_xor_sync(kFull, acc, 1);
      acc += __shfl_xor_sync(kFull, acc, 2);
      if (q == 0) y[base + (t0 + s) * tstride + m] = fmaf(st.bonus[s], vm, acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) sp[(q * kRows + j) * kN] = S[j];
}

}  // namespace

// r, k, v, w, y: (batch, T, heads, head_size); u: (heads, head_size);
// state: (batch, heads, head_size, head_size), read (unless zero_init) and
// overwritten with the final state.  All fp32, contiguous, 16-byte aligned.
// Returns cudaGetLastError() after the launch, or loops::kUnsupported for a
// head size other than 64.
extern "C" int wkv6_fwd(const float* r, const float* k, const float* v,
                        const float* w, const float* u, float* state,
                        float* y, int64_t batch, int64_t T, int64_t heads,
                        int64_t head_size, int zero_init, void* stream) {
  if (head_size != kN) return loops::kUnsupported;
  if (batch == 0 || heads == 0) return 0;
  if (batch * heads > 65535 || T > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kN / kCols, static_cast<unsigned>(batch * heads));
  wkv6_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, u, state, y, static_cast<int>(T), static_cast<int>(heads),
      zero_init);
  return static_cast<int>(cudaGetLastError());
}
