// B2: BCSR-part panel SpMM, the matrix-pipeline half of LOOPS, for Hopper.
//
// Replaces the TPU kernel repro/kernels/bcsr_spmm.py::bcsr_panels_spmm_pallas
// (bodies _panel_kernel and _piped_panel_kernel).  Computes, for every panel
// p of the (P, Br, G) panel layout,
//     C[row_offset + rows[p]*Br : +Br, :] += A_p (Br x G) @ B[cols[p], :]
// with lanes whose mask is 0 dropped, for each batch slice.  The fused LOOPS
// path passes the buffer the CSR-part kernel fills and row_offset =
// r_boundary, so both parts land in one buffer with no concatenation.
//
// What bounds it on the H100: memory.  Each Br x 1 tile gathers one B row
// of N elements and does Br*N multiply-adds on it: 2 flops per byte in fp32
// at Br=8, N=32, still below the card's 67 TFLOP/s : 3.35 TB/s ratio.  The
// least time is the bytes the call must move (the panel arrays, the B rows
// it references, the output) over 3.35 TB/s; the gathered B-row bytes
// (ntiles * N * elem) are what it streams, from L2 when B fits in it.
//
// Design.  As in B1, ownership replaces the TPU's sequential grid: one warp
// owns one block-row x one 32-column tile and loops over the block-row's
// panels through the host-computed block-row -> first-panel offsets.  Each
// lane keeps Br accumulators in registers for its column; a gathered B
// element is reused Br times from a register; the Br tile values of a lane
// are the same address for the whole warp (a broadcast load).  Every output
// row of the block-row is written exactly once: no atomics, no memset, a
// fixed summation order.  The ragged column edge is masked per lane.  This
// first version runs on the CUDA cores (FFMA / DFMA); the tensor-core form
// (mma.sync m16n8k16 for half, DMMA for fp64) is later work.
#include "panel_common.cuh"

using namespace loops;

namespace {

template <typename T, typename O, int BR>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
bcsr_panels_kernel(const int64_t* __restrict__ panel_ptr,
                   const int32_t* __restrict__ cols,
                   const T* __restrict__ vals, const bool* __restrict__ mask,
                   const T* __restrict__ b, O* __restrict__ out,
                   int64_t nblocks, int64_t g, int64_t k, int64_t n,
                   int64_t out_rows, int64_t row_offset) {
  using A = typename AccOf<T>::type;
  const int lane = threadIdx.x % kWarp;
  const int64_t blk =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (blk >= nblocks) return;  // uniform across the warp
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kWarp + lane;
  const bool live = col < n;
  const T* bz = b + static_cast<int64_t>(blockIdx.z) * k * n;

  A acc[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = A(0);

  const int64_t end = panel_ptr[blk + 1] * g;
  for (int64_t base = panel_ptr[blk] * g; base < end; base += kWarp) {
    // Lane l holds flat panel lane e = base + l, i.e. lane i = e % g of
    // panel p = e / g, whose Br values sit at vals[p, :, i].
    const int64_t e = base + lane;
    int c = 0;
    int m = 0;
    long long voff = 0;
    if (e < end) {
      c = cols[e];
      m = mask[e];
      const int64_t p = e / g;
      voff = p * BR * g + (e - p * g);
    }
    const int cnt = static_cast<int>(end - base < kWarp ? end - base : kWarp);
    for (int j = 0; j < cnt; ++j) {
      const int cj = __shfl_sync(kFull, c, j);
      const int mj = __shfl_sync(kFull, m, j);
      const long long oj = __shfl_sync(kFull, voff, j);
      if (mj && live) {
        const A x = to_acc(bz[static_cast<int64_t>(cj) * n + col]);
#pragma unroll
        for (int r = 0; r < BR; ++r) acc[r] += to_acc(vals[oj + r * g]) * x;
      }
    }
  }
  if (live) {
    O* o = out + (static_cast<int64_t>(blockIdx.z) * out_rows + row_offset +
                  blk * BR) * n + col;
#pragma unroll
    for (int r = 0; r < BR; ++r) store(o + r * n, acc[r]);
  }
}

}  // namespace

// C entry point.  Pointers are device pointers of contiguous tensors:
// panel_ptr (nblocks+1,) int64, cols (P, G) int32, vals (P, br, G) T, mask
// (P, G) bool, b (batch, k, n) T, out (batch, out_rows, n) O; the kernel
// writes rows [row_offset, row_offset + nblocks*br) of each slice.  Returns
// 0, the CUDA error of the launch, or kUnsupported (dtype pair, or br not
// in {4, 8, 16}).
extern "C" int bcsr_panels_spmm(const void* panel_ptr, const void* cols,
                                const void* vals, const void* mask,
                                const void* b, void* out, int64_t nblocks,
                                int64_t br, int64_t g, int64_t k, int64_t n,
                                int64_t batch, int64_t out_rows,
                                int64_t row_offset, int dtype, int out_dtype,
                                void* stream) {
  if (br != 4 && br != 8 && br != 16) return loops::kUnsupported;
  if (nblocks == 0 || n == 0 || batch == 0) return 0;
  const dim3 grid = panel_grid(nblocks, n, batch);
  const dim3 block(kWarp * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH_BR(T, O, BR)                                                \
  bcsr_panels_kernel<T, O, BR><<<grid, block, 0, s>>>(                     \
      static_cast<const int64_t*>(panel_ptr),                              \
      static_cast<const int32_t*>(cols), static_cast<const T*>(vals),      \
      static_cast<const bool*>(mask), static_cast<const T*>(b),            \
      static_cast<O*>(out), nblocks, g, k, n, out_rows, row_offset)
#define LAUNCH(T, O)                                                       \
  if (br == 4) {                                                           \
    LAUNCH_BR(T, O, 4);                                                    \
  } else if (br == 8) {                                                    \
    LAUNCH_BR(T, O, 8);                                                    \
  } else {                                                                 \
    LAUNCH_BR(T, O, 16);                                                   \
  }
  LOOPS_DISPATCH_DTYPES(dtype, out_dtype, LAUNCH)
#undef LAUNCH
#undef LAUNCH_BR
  return static_cast<int>(cudaGetLastError());
}
