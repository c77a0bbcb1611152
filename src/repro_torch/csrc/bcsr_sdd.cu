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
// What bounds it on the H100: operations, for the training shapes.  Each
// Br x 1 tile slot costs N multiply-adds per batch slice, while the bytes
// are each dY row of the part and each referenced B row once (a block-row's
// dY slab and the B rows are re-read from L2 by every panel that needs
// them): at Br=8, G=8 and N=1024 the flops over bytes exceed the card's
// 67 TFLOP/s (fp32, CUDA cores) : 3.35 TB/s ratio.  fp32 stays FFMA (no
// TF32); tensor cores (mma.sync for half, DMMA for fp64) are later work.
//
// Design.  The TPU kernel keeps the panel's (Br, G) accumulator resident in
// VMEM while column and batch blocks stream past a sequential grid, and
// feeds it (Br, bn) @ (bn, G) MXU contractions.  Here one warp owns one
// panel's whole output and loops over the batch slices and the N columns
// itself, one column per lane: a lane loads its Br elements of the
// block-row's dY slab once per 32-column chunk and reuses each gathered B
// element Br times from a register, keeping Br x GC accumulators (GC = 8
// lanes of G per pass: 64 for fp32/fp64 at Br=8, 128 for half at Br=16; 4
// lanes for fp64 at Br=16).  A butterfly of __shfl_xor_sync then sums each
// accumulator across the warp.  The batch sum is in-kernel, in a fixed
// order: no atomics, no second pass, no memset.  The kernel takes dY whole
// with the part's row offset and row limit, so the caller makes no padded
// copy of its BCSR rows.  The ragged column edge is masked per lane.
#include "panel_common.cuh"

using namespace loops;

namespace {

template <typename TD, typename TB, int BR, int GC>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
bcsr_sdd_kernel(const int32_t* __restrict__ rows,
                const int32_t* __restrict__ cols,
                const bool* __restrict__ mask, const TD* __restrict__ dy,
                const TB* __restrict__ b,
                typename AccOf<TB>::type* __restrict__ out, int64_t npanels,
                int64_t g, int64_t m, int64_t k, int64_t n, int64_t batch,
                int64_t row_offset, int64_t nrows) {
  using A = typename AccOf<TB>::type;
  const int lane = threadIdx.x % kWarp;
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (p >= npanels) return;  // uniform across the warp
  const int64_t r0 = static_cast<int64_t>(rows[p]) * BR;
  // Rows of this block-row inside the part; the rest read as zero.
  const int64_t left = nrows - r0;
  const int live_rows = left <= 0 ? 0 : (left < BR ? static_cast<int>(left)
                                                   : BR);
  for (int64_t i0 = 0; i0 < g; i0 += GC) {
    int src[GC];
    bool live[GC];
    A acc[BR][GC];
#pragma unroll
    for (int j = 0; j < GC; ++j) {
      const int64_t i = i0 + j;
      live[j] = i < g && mask[p * g + i];
      src[j] = live[j] ? cols[p * g + i] : 0;
#pragma unroll
      for (int r = 0; r < BR; ++r) acc[r][j] = A(0);
    }
    for (int64_t z = 0; z < batch; ++z) {
      const TD* dyb = dy + z * m * n + (row_offset + r0) * n;
      const TB* bz = b + z * k * n;
      for (int64_t c = lane; c < n; c += kWarp) {
        A d[BR];
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          d[r] = r < live_rows ? to_acc(dyb[r * n + c]) : A(0);
        }
#pragma unroll
        for (int j = 0; j < GC; ++j) {
          if (live[j]) {
            const A x = to_acc(bz[static_cast<int64_t>(src[j]) * n + c]);
#pragma unroll
            for (int r = 0; r < BR; ++r) acc[r][j] += d[r] * x;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BR; ++r) {
#pragma unroll
      for (int j = 0; j < GC; ++j) {
        const A s = warp_sum(acc[r][j]);
        if (lane == (r * GC + j) % kWarp && i0 + j < g) {
          out[(p * BR + r) * g + i0 + j] = live[j] ? s : A(0);
        }
      }
    }
  }
}

}  // namespace

// C entry point.  Pointers are device pointers of contiguous tensors: rows
// (P,) int32 block-rows, cols (P, G) int32, mask (P, G) bool, dy (batch, m,
// n) TD, b (batch, k, n) TB, out (P, br, G) in TB's accumulation type; the
// part's rows of dy are [row_offset, row_offset + nrows).  Returns 0, the
// CUDA error of the launch, or kUnsupported (dtype pair, or br not in
// {4, 8, 16}).
extern "C" int bcsr_sdd_panels(const void* rows, const void* cols,
                               const void* mask, const void* dy,
                               const void* b, void* out, int64_t npanels,
                               int64_t br, int64_t g, int64_t m, int64_t k,
                               int64_t n, int64_t batch, int64_t row_offset,
                               int64_t nrows, int dy_dtype, int b_dtype,
                               void* stream) {
  if (br != 4 && br != 8 && br != 16) return loops::kUnsupported;
  if (npanels == 0 || g == 0) return 0;
  const dim3 grid(static_cast<unsigned>((npanels + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  const dim3 block(kWarp * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_BR(TD, TB, BR)                                              \
  {                                                                        \
    using Acc = AccOf<TB>::type;                                           \
    constexpr int kGc = (sizeof(Acc) == 8 && BR == 16) ? 4 : 8;            \
    bcsr_sdd_kernel<TD, TB, BR, kGc><<<grid, block, 0, s>>>(               \
        static_cast<const int32_t*>(rows),                                 \
        static_cast<const int32_t*>(cols), static_cast<const bool*>(mask), \
        static_cast<const TD*>(dy), static_cast<const TB*>(b),             \
        static_cast<Acc*>(out), npanels, g, m, k, n, batch, row_offset,    \
        nrows);                                                            \
  }
#define LAUNCH(TD, TB)                                                     \
  if (br == 4) {                                                           \
    LAUNCH_BR(TD, TB, 4)                                                   \
  } else if (br == 8) {                                                    \
    LAUNCH_BR(TD, TB, 8)                                                   \
  } else {                                                                 \
    LAUNCH_BR(TD, TB, 16)                                                  \
  }
  LOOPS_DISPATCH_SDD(dy_dtype, b_dtype, LAUNCH)
#undef LAUNCH
#undef LAUNCH_BR
  return static_cast<int>(cudaGetLastError());
}
