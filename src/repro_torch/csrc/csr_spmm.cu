// B1: CSR-part panel SpMM, the vector-pipeline half of LOOPS, for Hopper.
//
// Replaces the TPU kernel repro/kernels/csr_spmm.py::csr_panels_spmm_pallas
// (bodies _panel_kernel and _piped_panel_kernel).  Computes, for every panel
// p of the (P, G) panel layout,
//     C[rows[p], :] += sum_i mask[p,i] * vals[p,i] * B[cols[p,i], :]
// for each batch slice, writing the rows [0, nrows) of an output buffer with
// out_rows rows per slice (the fused LOOPS path passes the whole buffer).
//
// What bounds it on the H100: memory.  Each nonzero gathers one B row of
// N elements and does N multiply-adds on it, about 1/4 flop per byte in fp32
// at N=32, far below the card's 67 TFLOP/s : 3.35 TB/s ratio.  The least
// time is the bytes the call must move (the panel arrays, the B rows it
// references, the output) over 3.35 TB/s; the gathered B-row bytes (nnz * N
// * elem) are what it actually streams, from L2 when B fits in its 50 MB.
//
// Design.  The TPU kernel walks panels on a sequential grid and keeps one
// output block resident across a row's run of panels.  Hopper blocks run in
// no order, so ownership replaces the sequential grid: one warp owns one
// output row x one 32-column tile and loops over that row's panels through
// the host-computed row -> first-panel offsets (panel_ptr).  Lanes span the
// columns, so every B-row gather is one coalesced 128-byte (fp32) access,
// and the sum stays in a register.  The panel metadata of 32 lanes is loaded
// with one coalesced load per array and broadcast with warp shuffles.  Each
// output element is written exactly once, so there are no atomics, no
// memset, and the summation order is fixed (panels in order, lanes in
// order), as in the reference.  A row with no panel is written as zeros.
// The ragged column edge (N not a multiple of 32) is masked per lane.
// Known limit: a hub row with a very large count is walked by one warp
// (long tail); splitting it needs a second pass, left to a later change.
#include "panel_common.cuh"

using namespace loops;

namespace {

template <typename T, typename O>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_panels_kernel(const int64_t* __restrict__ panel_ptr,
                  const int32_t* __restrict__ cols,
                  const T* __restrict__ vals, const bool* __restrict__ mask,
                  const T* __restrict__ b, O* __restrict__ out,
                  int64_t nrows, int64_t g, int64_t k, int64_t n,
                  int64_t out_rows) {
  using A = typename AccOf<T>::type;
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= nrows) return;  // uniform across the warp
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kWarp + lane;
  const bool live = col < n;
  const T* bz = b + static_cast<int64_t>(blockIdx.z) * k * n;

  A acc = A(0);
  const int64_t end = panel_ptr[row + 1] * g;
  for (int64_t base = panel_ptr[row] * g; base < end; base += kWarp) {
    // Lane l holds flat panel lane base + l (panels of one row are
    // contiguous in the (P, G) layout).
    const int64_t e = base + lane;
    int c = 0;
    int m = 0;
    A v = A(0);
    if (e < end) {
      c = cols[e];
      m = mask[e];
      v = to_acc(vals[e]);
    }
    const int cnt = static_cast<int>(end - base < kWarp ? end - base : kWarp);
    for (int j = 0; j < cnt; ++j) {
      const int cj = __shfl_sync(kFull, c, j);
      const int mj = __shfl_sync(kFull, m, j);
      const A vj = __shfl_sync(kFull, v, j);
      if (mj && live) acc += vj * to_acc(bz[static_cast<int64_t>(cj) * n + col]);
    }
  }
  if (live) {
    store(out + (static_cast<int64_t>(blockIdx.z) * out_rows + row) * n + col,
          acc);
  }
}

}  // namespace

// C entry point.  Pointers are device pointers of contiguous tensors:
// panel_ptr (nrows+1,) int64, cols (P, G) int32, vals (P, G) T, mask (P, G)
// bool, b (batch, k, n) T, out (batch, out_rows, n) O.  Returns 0, the CUDA
// error of the launch, or kUnsupported.
extern "C" int csr_panels_spmm(const void* panel_ptr, const void* cols,
                               const void* vals, const void* mask,
                               const void* b, void* out, int64_t nrows,
                               int64_t g, int64_t k, int64_t n, int64_t batch,
                               int64_t out_rows, int dtype, int out_dtype,
                               void* stream) {
  if (nrows == 0 || n == 0 || batch == 0) return 0;
  const dim3 grid = panel_grid(nrows, n, batch);
  const dim3 block(kWarp * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(T, O)                                                       \
  csr_panels_kernel<T, O><<<grid, block, 0, s>>>(                          \
      static_cast<const int64_t*>(panel_ptr),                              \
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),      \
      static_cast<const bool*>(mask), static_cast<const T*>(b),            \
      static_cast<O*>(out), nrows, g, k, n, out_rows)
  LOOPS_DISPATCH_DTYPES(dtype, out_dtype, LAUNCH)
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
