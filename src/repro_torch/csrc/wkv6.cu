// wkv6: the RWKV-6 time-mix recurrence, forward and backward, for Hopper.
//
// Replaces no TPU kernel: the reference runs this recurrence as a
// lax.scan over time, repro/models/rwkv6.py::_wkv_scan, which XLA compiles
// and, in training, differentiates; in eager PyTorch the same scan is a
// Python loop of ~6 small launches a time step (about 400k a 32-layer
// prefill at 4 x 2048 tokens), so the port's ssm family gets kernels of
// its own.  For r, k, v, w (B, T, H, N) fp32, u (H, N) fp32 and a state S
// (B, H, N, N) fp32 the forward computes, per (b, h) and step t,
//     y_t[m] = sum_n r_t[n] (S[n, m] + u[n] k_t[n] v_t[m])
//     S[n, m] <- w_t[n] S[n, m] + k_t[n] v_t[m]
// reading S_0 from `state` (or zeros with `zero_init`) and writing S_T back
// into it in place (the serving pool's slot cache), and y (B, T, H, N).
// Everything is fp32, as the reference streams it.  The bonus term is
// written as y_t[m] = sum_n r_t[n] S[n, m] + v_t[m] (sum_n r_t[n] u[n]
// k_t[n]): the second sum is one scalar a step and head, so a state element
// costs one FFMA for y and a multiply and an FFMA for its update.  In
// training the forward also writes the state before every kSnap-th step
// into `snap` (a null `snap`, the serving launch, writes nothing more).
//
// What bounds the forward on the H100: bytes.  At (4, 2048, 40, 64) r, k,
// v, w and y are 83.9 MB each and S_0, S_T 2.6 MB each, 424.7 MB in all,
// 0.127 ms at 3.35 TB/s; the 5 flops a state element and step are 6.7
// GFLOP, 0.100 ms at 67 TFLOP/s fp32.  A scan is sequential in t, so the
// kernel is bound in practice by the latency of a step times T unless
// enough (b, h, column) work runs side by side.
//
// Forward design.  Column m of S evolves with v_t[m] alone, so the N
// columns of a head split across CTAs freely: one CTA of 128 threads owns
// kCols = 32 columns of one (b, h), which at B 4, H 40 gives 320 CTAs for
// 132 SMs.  Four threads share a column, each holding kRows = 16 of its
// rows in registers; y[m] is their sum, two xor-shuffles within the quad.
// Time is staged kChunk = 16 steps at a time: r, k and w rows (N each,
// padded by 4 floats after every 16 so the four row groups of a
// quarter-warp read distinct banks) and the CTA's 32 v columns, by 16-byte
// cp.async into one of two stages while the other is consumed.  Once a
// stage has landed, each warp forms the bonus scalars of its steps (u
// lives in registers), and then the threads run the stage's steps with no
// barrier between them.  The launch allocates nothing and reads nothing on
// the host, so it is graph-capturable.  Only N = 64 is built (the wrapper
// raises for others).
//
// Backward (wkv6_bwd).  With G_t = dL/dS_t (S_t the state after step t,
// G_T = dS_T) and dy the output's gradient, per (b, h):
//     G_{t-1}[n, m] = w_t[n] G_t[n, m] + r_t[n] dy_t[m]
//     dr_t[n] = sum_m dy_t[m] S_{t-1}[n, m] + u[n] k_t[n] (dy_t . v_t)
//     dk_t[n] = sum_m v_t[m] G_t[n, m] + r_t[n] u[n] (dy_t . v_t)
//     dv_t[m] = sum_n k_t[n] G_t[n, m] + dy_t[m] sum_n r_t[n] u[n] k_t[n]
//     dw_t[n] = sum_m S_{t-1}[n, m] G_t[n, m]
//     du[n]   = sum_{b, t} r_t[n] k_t[n] (dy_t . v_t)
// and dS_0 = G_0: the bonus term enters each sum as one scalar a row, as
// in the forward.  dr and dw need S_{t-1} in reverse time; it is never
// recovered by dividing by w (exp(-exp(.)) underflows toward 0).  The
// forward's snapshots hold S before steps 0, kSnap, 2 kSnap, ...; the
// backward walks the windows of kSnap steps from the last: it stages the
// window's r, k, w, v and dy rows, recomputes the window's states from the
// snapshot into shared memory (each thread its own 16 rows of its column,
// kSnap steps), then walks G back through the window.  One CTA of 256
// threads holds a whole (b, h): 4 threads a column, 16 rows each, as the
// forward's, so dv sums over n inside a quad and dr, dk and dw sum over m
// inside the CTA: within a warp by a reduce-scatter over its 8 columns
// (three xor-shuffle rounds halving the rows each lane carries), across
// the 8 warps in shared memory, in a fixed order.  du's sum over the batch
// is the caller's, over each CTA's share.  No atomics: two calls give the
// same bits.
//
// What bounds the backward: operations.  A state element and step costs 14
// flops (the recomputed update 3; dr's, dk's, dw's and dv's products and
// sums 2 each; G's update 3), 19.1 GFLOP at (4, 2048, 40, 64) with the row
// terms, 0.285 ms at 67 TFLOP/s fp32, above the bytes term (r, k, v, w, dy
// read and dr, dk, dv, dw written, 755 MB, 0.225 ms).  Shared memory: 128
// KB of states, 48 KB of warp sums and 17 KB of staged inputs, so one CTA
// an SM.
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
constexpr int kSnap = 8;                   // steps between snapshots

static_assert(kThreads % 32 == 0 && kRows % 4 == 0, "tile shape");
static_assert(kChunk % kSnap == 0, "a stage starts on a snapshot");
static_assert(kRows == 16 && kSplit == 4,
              "the backward's reduce-scatter is written for this split");

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
                float* __restrict__ y, float* __restrict__ snap,
                int64_t snap_stride, int T, int H, int zero_init) {
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
      if (snap != nullptr && s % kSnap == 0) {   // S before step t0 + s
        float* dst = snap + ((t0 + s) / kSnap) * snap_stride +
                     static_cast<int64_t>(bh) * kN * kN + m;
#pragma unroll
        for (int j = 0; j < kRows; ++j) dst[(q * kRows + j) * kN] = S[j];
      }
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

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = kN * kSplit;   // 256: a CTA holds a whole head
constexpr int kBwdWarps = kBwdThreads / 32;

// One window of kSnap steps: the r, k, w rows and r∘u, u∘k (padded as the
// forward's), the v and dy rows, and per step the bonus scalar sum_n r u k
// and dy . v.
struct BwdStage {
  float r[kSnap][kPad];
  float k[kSnap][kPad];
  float w[kSnap][kPad];
  float ru[kSnap][kPad];
  float uk[kSnap][kPad];
  float v[kSnap][kN];
  float dy[kSnap][kN];
  float u[kN];
  float bonus[kSnap];
  float dot[kSnap];
};

constexpr int kHistFloats = kSnap * kRows * kBwdThreads;   // 128 KB
constexpr int kRedFloats = kSnap * 3 * kBwdWarps * kN;     // 48 KB
constexpr int kBwdSmem =
    static_cast<int>(sizeof(BwdStage)) + 4 * (kHistFloats + kRedFloats);
static_assert(sizeof(BwdStage) % 16 == 0, "hist stays 16-byte aligned");
static_assert(kBwdSmem <= 227 * 1024, "one CTA fits an SM's shared memory");

__device__ __forceinline__ void load_bwd_stage(
    BwdStage& st, const float* r, const float* k, const float* w,
    const float* v, const float* dy, int64_t base, int64_t tstride, int t0,
    int steps) {
  constexpr int kRowCopies = kSnap * kVec;
  for (int i = threadIdx.x; i < 5 * kRowCopies; i += kBwdThreads) {
    const int which = i / kRowCopies;
    const int s = (i % kRowCopies) / kVec;
    const int c = i % kVec;
    if (s >= steps) continue;
    const float* src = (which == 0 ? r : which == 1 ? k : which == 2 ? w
                        : which == 3 ? v : dy) +
                       base + (t0 + s) * tstride + c * 4;
    float* dst = which == 0 ? st.r[s] + padded(c * 4)
               : which == 1 ? st.k[s] + padded(c * 4)
               : which == 2 ? st.w[s] + padded(c * 4)
               : which == 3 ? st.v[s] + c * 4
                            : st.dy[s] + c * 4;
    cp_async16(dst, src, 16);
  }
}

// The sums of x over the 8 columns of a warp (lanes 4 c + q, c = 0..7),
// scattered: lane l ends with the sums of rows 8 b4 + 4 b3 + 2 b2 + {0, 1}
// of its 16 (b_i bit i of l).  Each round keeps the half of its rows whose
// bit matches the lane's and adds the partner's copy of that half.
__device__ __forceinline__ void column_sums(const float (&x)[kRows],
                                            float (&out)[2], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float a[8], c[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float keep = b4 ? x[8 + i] : x[i];
    const float send = b4 ? x[i] : x[8 + i];
    a[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b3 ? a[4 + i] : a[i];
    const float send = b3 ? a[i] : a[4 + i];
    c[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b2 ? c[2 + i] : c[i];
    const float send = b2 ? c[i] : c[2 + i];
    out[i] = keep + __shfl_xor_sync(kFull, send, 4);
  }
}

// One CTA a (b, h); dr, dk, dv, dw: (B, T, H, N); du_part: (B, H, N), the
// batch row's share of du; ds0: (B, H, N, N).
__global__ void __launch_bounds__(kBwdThreads, 1)
    wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ dy,
                    const float* __restrict__ snap,
                    const float* __restrict__ dsT, float* __restrict__ dr,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dw, float* __restrict__ du_part,
                    float* __restrict__ ds0, int B, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  BwdStage& st = *reinterpret_cast<BwdStage*>(smem);
  float* hist = smem + sizeof(BwdStage) / sizeof(float);
  float* red = hist + kHistFloats;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int m = tid / kSplit;   // the thread's column
  const int q = tid % kSplit;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int64_t tstride = static_cast<int64_t>(H) * kN;
  const int64_t base = (static_cast<int64_t>(b) * T * H + h) * kN;
  const int64_t nn = static_cast<int64_t>(kN) * kN;
  const int64_t sidx = bh * nn + q * kRows * kN + m;   // + j * kN
  const int64_t snap_stride = static_cast<int64_t>(B) * H * nn;
  const int row_lo = q * kRows + ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                     ((lane >> 2) & 1) * 2;

  float G[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) G[j] = dsT ? dsT[sidx + j * kN] : 0.f;
  if (tid < kN) st.u[tid] = u[h * kN + tid];
  float du_acc = 0.f;   // row tid's share of du (tid < kN)

  for (int c = (T + kSnap - 1) / kSnap - 1; c >= 0; --c) {
    const int t0 = c * kSnap;
    const int L = min(kSnap, T - t0);
    __syncthreads();   // the last window's stage and sums are consumed
    load_bwd_stage(st, r, k, w, v, dy, base, tstride, t0, L);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int i = tid; i < L * kN; i += kBwdThreads) {
      const int s = i / kN, n = i % kN, p = padded(n);
      st.ru[s][p] = st.r[s][p] * st.u[n];
      st.uk[s][p] = st.u[n] * st.k[s][p];
    }
    for (int s = warp; s < L; s += kBwdWarps) {
      const int n0 = padded(lane), n1 = padded(lane + 32);
      const float a = warp_sum(st.r[s][n0] * st.u[lane] * st.k[s][n0] +
                               st.r[s][n1] * st.u[lane + 32] * st.k[s][n1]);
      const float d = warp_sum(st.dy[s][lane] * st.v[s][lane] +
                               st.dy[s][lane + 32] * st.v[s][lane + 32]);
      if (lane == 0) {
        st.bonus[s] = a;
        st.dot[s] = d;
      }
    }
    __syncthreads();
    if (tid < kN) {
      const int p = padded(tid);
      for (int s = 0; s < L; ++s)
        du_acc = fmaf(st.r[s][p] * st.k[s][p], st.dot[s], du_acc);
    }

    // The window's states, S before each of its steps, from the snapshot.
    float S[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) S[j] = snap[c * snap_stride + sidx + j * kN];
    for (int s = 0; s < L; ++s) {
      const float vm = st.v[s][m];
      const float4* kk = reinterpret_cast<const float4*>(st.k[s] + q * (kRows + kGap));
      const float4* ww = reinterpret_cast<const float4*>(st.w[s] + q * (kRows + kGap));
      float* hs = hist + s * kRows * kBwdThreads + tid;
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) {
        const float4 k4 = kk[i], w4 = ww[i];
        hs[(4 * i + 0) * kBwdThreads] = S[4 * i + 0];
        hs[(4 * i + 1) * kBwdThreads] = S[4 * i + 1];
        hs[(4 * i + 2) * kBwdThreads] = S[4 * i + 2];
        hs[(4 * i + 3) * kBwdThreads] = S[4 * i + 3];
        S[4 * i + 0] = fmaf(w4.x, S[4 * i + 0], k4.x * vm);
        S[4 * i + 1] = fmaf(w4.y, S[4 * i + 1], k4.y * vm);
        S[4 * i + 2] = fmaf(w4.z, S[4 * i + 2], k4.z * vm);
        S[4 * i + 3] = fmaf(w4.w, S[4 * i + 3], k4.w * vm);
      }
    }

    // G back through the window; the bonus terms are the row scalars
    // added below.
    for (int s = L - 1; s >= 0; --s) {
      const float vm = st.v[s][m];
      const float dym = st.dy[s][m];
      const int off = q * (kRows + kGap);
      const float* hs = hist + s * kRows * kBwdThreads + tid;
      float pr[kRows], pk[kRows], pw[kRows];
      float dva = 0.f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int p = off + j;
        const float sp = hs[j * kBwdThreads];
        pr[j] = dym * sp;
        pk[j] = vm * G[j];
        pw[j] = sp * G[j];
        dva = fmaf(st.k[s][p], G[j], dva);
        G[j] = fmaf(st.w[s][p], G[j], st.r[s][p] * dym);
      }
      dva += __shfl_xor_sync(kFull, dva, 1);
      dva += __shfl_xor_sync(kFull, dva, 2);
      if (q == 0) dv[base + (t0 + s) * tstride + m] = fmaf(dym, st.bonus[s], dva);
      float o[2];
      float* rs = red + (s * 3 * kBwdWarps + warp) * kN + row_lo;
      column_sums(pr, o, lane);
      rs[0] = o[0];
      rs[1] = o[1];
      column_sums(pk, o, lane);
      rs[kBwdWarps * kN] = o[0];
      rs[kBwdWarps * kN + 1] = o[1];
      column_sums(pw, o, lane);
      rs[2 * kBwdWarps * kN] = o[0];
      rs[2 * kBwdWarps * kN + 1] = o[1];
    }
    __syncthreads();
    // The warps' sums in warp order, then dr's and dk's bonus terms,
    // (u k)[n] (dy . v) and (r u)[n] (dy . v).
    for (int i = tid; i < L * 3 * kN; i += kBwdThreads) {
      const int s = i / (3 * kN), x = (i / kN) % 3, n = i % kN;
      const float* rs = red + (s * 3 + x) * kBwdWarps * kN + n;
      float sum = rs[0];
#pragma unroll
      for (int wp = 1; wp < kBwdWarps; ++wp) sum += rs[wp * kN];
      if (x < 2) {
        const int p = padded(n);
        sum = fmaf(x == 0 ? st.uk[s][p] : st.ru[s][p], st.dot[s], sum);
      }
      (x == 0 ? dr : x == 1 ? dk : dw)[base + (t0 + s) * tstride + n] = sum;
    }
  }
#pragma unroll
  for (int j = 0; j < kRows; ++j) ds0[sidx + j * kN] = G[j];
  if (tid < kN) du_part[static_cast<int64_t>(bh) * kN + tid] = du_acc;
}

}  // namespace

// r, k, v, w, y: (batch, T, heads, head_size); u: (heads, head_size);
// state: (batch, heads, head_size, head_size), read (unless zero_init) and
// overwritten with the final state.  All fp32, contiguous, 16-byte aligned.
// snap: null, or (ceil(T / 8), batch, heads, head_size, head_size), which
// takes the state before steps 0, 8, 16, ... (the backward's input).
// Returns cudaGetLastError() after the launch, or
// loops::kUnsupported for a head size other than 64.
extern "C" int wkv6_fwd(const float* r, const float* k, const float* v,
                        const float* w, const float* u, float* state,
                        float* y, int64_t batch, int64_t T, int64_t heads,
                        int64_t head_size, int zero_init, void* stream,
                        float* snap) {
  if (head_size != kN) return loops::kUnsupported;
  if (batch == 0 || heads == 0) return 0;
  if (batch * heads > 65535 || T > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(kN / kCols, static_cast<unsigned>(batch * heads));
  wkv6_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, u, state, y, snap, batch * heads * kN * kN,
      static_cast<int>(T), static_cast<int>(heads), zero_init);
  return static_cast<int>(cudaGetLastError());
}

// The backward of wkv6_fwd.  r, k, v, w, dy, dr, dk, dv, dw: (batch, T,
// heads, head_size); u: (heads, head_size); snap: the forward's snapshots,
// (ceil(T / 8), batch, heads, head_size, head_size); dsT (nullable: zeros)
// and ds0: (batch, heads, head_size, head_size); du_part: (batch, heads,
// head_size), each batch row's share of du, which the caller sums over the
// batch.  All fp32, contiguous, 16-byte aligned.  Returns
// cudaGetLastError() after the launch, or loops::kUnsupported for a head
// size other than 64.
extern "C" int wkv6_bwd(const float* r, const float* k, const float* v,
                        const float* w, const float* u, const float* dy,
                        const float* snap, const float* dsT, float* dr,
                        float* dk, float* dv, float* dw, float* du_part,
                        float* ds0, int64_t batch, int64_t T, int64_t heads,
                        int64_t head_size, void* stream) {
  if (head_size != kN) return loops::kUnsupported;
  if (batch == 0 || heads == 0) return 0;
  if (batch * heads > 0x7fffffff || T > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  wkv6_bwd_kernel<<<static_cast<unsigned>(batch * heads), kBwdThreads,
                    kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, u, dy, snap, dsT, dr, dk, dv, dw, du_part, ds0,
      static_cast<int>(batch), static_cast<int>(T), static_cast<int>(heads));
  return static_cast<int>(cudaGetLastError());
}
