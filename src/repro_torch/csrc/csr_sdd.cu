// B3: CSR-part sampled dense-dense (SDD) product, the value gradient of the
// vector-pipeline half of LOOPS, for Hopper.
//
// Replaces the TPU kernel repro/kernels/spmm_sdd.py::csr_sdd_panels_pallas
// (bodies _csr_sdd_kernel and _piped_csr_sdd_kernel).  For every panel p of
// the forward (P, G) panel layout and every lane i it computes
//     out[p, i] = sum_z sum_n dY[z, rows[p], n] * B[z, cols[p, i], n]
// (the gradient of Y = A @ B at A's stored value, summed over the batch, as
// the values are shared across it), and exactly 0 at masked lanes.
//
// What bounds it on the H100: memory.  Each stored value reads one B row
// of N elements and does N multiply-adds on it (1/4 flop per byte in fp32),
// far below the card's 67 TFLOP/s : 3.35 TB/s ratio.  The least time is the
// bytes the call must move (the panel arrays, the dY rows and the B rows it
// references, the output) over 3.35 TB/s; the gathered B-row bytes
// (nnz * batch * N * elem) are what it streams, from L2 when B fits in it.
//
// Design.  The TPU kernel keeps each panel's (1, G) accumulator resident in
// VMEM while column blocks and batch blocks stream past on a sequential
// grid.  Hopper blocks run in no order, so ownership replaces that grid: one
// warp owns one panel's whole output and loops over the batch slices and the
// N columns itself, 32 columns (one per lane) at a time.  For each chunk a
// lane loads its element of the panel's dY row once and multiplies it into
// the coalesced gathers of the G lanes' B rows, accumulating in registers
// (G taken 8 lanes at a time).  At the end a butterfly of __shfl_xor_sync
// sums each lane's partials across the warp.  The batch sum is therefore
// in-kernel, in a fixed order: no atomics, no second pass, no memset.  Half
// inputs are converted by intrinsics and accumulate in fp32; fp64 in fp64.
// The ragged column edge (N not a multiple of 32) is masked per lane.
#include "panel_common.cuh"

using namespace loops;

namespace {

// Panel lanes accumulated per pass (registers per thread).
constexpr int kLaneGroup = 8;

template <typename TD, typename TB>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_sdd_kernel(const int32_t* __restrict__ rows,
               const int32_t* __restrict__ cols,
               const bool* __restrict__ mask, const TD* __restrict__ dy,
               const TB* __restrict__ b,
               typename AccOf<TB>::type* __restrict__ out, int64_t npanels,
               int64_t g, int64_t m, int64_t k, int64_t n, int64_t batch) {
  using A = typename AccOf<TB>::type;
  const int lane = threadIdx.x % kWarp;
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (p >= npanels) return;  // uniform across the warp
  const int64_t row = rows[p];
  for (int64_t i0 = 0; i0 < g; i0 += kLaneGroup) {
    int src[kLaneGroup];
    bool live[kLaneGroup];
    A acc[kLaneGroup];
#pragma unroll
    for (int j = 0; j < kLaneGroup; ++j) {
      const int64_t i = i0 + j;
      live[j] = i < g && mask[p * g + i];
      src[j] = live[j] ? cols[p * g + i] : 0;
      acc[j] = A(0);
    }
    for (int64_t z = 0; z < batch; ++z) {
      const TD* dyr = dy + (z * m + row) * n;
      const TB* bz = b + z * k * n;
      for (int64_t c = lane; c < n; c += kWarp) {
        const A d = to_acc(dyr[c]);
#pragma unroll
        for (int j = 0; j < kLaneGroup; ++j) {
          if (live[j]) {
            acc[j] += d * to_acc(bz[static_cast<int64_t>(src[j]) * n + c]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kLaneGroup; ++j) {
      const A s = warp_sum(acc[j]);
      if (lane == j && i0 + j < g) out[p * g + i0 + j] = live[j] ? s : A(0);
    }
  }
}

}  // namespace

// C entry point.  Pointers are device pointers of contiguous tensors: rows
// (P,) int32, cols (P, G) int32, mask (P, G) bool, dy (batch, m, n) TD,
// b (batch, k, n) TB, out (P, G) in TB's accumulation type.  Returns 0, the
// CUDA error of the launch, or kUnsupported for a dtype pair.
extern "C" int csr_sdd_panels(const void* rows, const void* cols,
                              const void* mask, const void* dy, const void* b,
                              void* out, int64_t npanels, int64_t g,
                              int64_t m, int64_t k, int64_t n, int64_t batch,
                              int dy_dtype, int b_dtype, void* stream) {
  if (npanels == 0 || g == 0) return 0;
  const dim3 grid(static_cast<unsigned>((npanels + kWarpsPerBlock - 1) /
                                        kWarpsPerBlock));
  const dim3 block(kWarp * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(TD, TB)                                                     \
  csr_sdd_kernel<TD, TB><<<grid, block, 0, s>>>(                           \
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols), \
      static_cast<const bool*>(mask), static_cast<const TD*>(dy),          \
      static_cast<const TB*>(b), static_cast<AccOf<TB>::type*>(out),       \
      npanels, g, m, k, n, batch)
  LOOPS_DISPATCH_SDD(dy_dtype, b_dtype, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
