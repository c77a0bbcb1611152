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
// no order, and what costs time is the latency of each dependent gather, so
// the work is cut into bounded units and every warp keeps several gathers
// in flight:
//  * Units (the host's unit table, see panel_common.cuh): one warp takes one
//    unit of at most U panels of one row x one column tile x one batch
//    slice, so no warp walks a hub row alone (the tail that made one warp
//    walk 8,046 panels of an in-2004-like row).  A row with no panel has one
//    empty unit and is written as zeros.
//  * Second pass: a unit of an unsplit row stores the row straight into the
//    output; a unit of a split row stores its partial sum (accumulation
//    type) into its workspace slot, and reduce_partials_kernel adds a split
//    row's slots in slot order.  Every output element is written exactly
//    once, with no atomics and no memset, and the summation order is fixed,
//    so two calls give the same bits.
//  * Gathers in flight: the unit's panel metadata (cols, mask, vals) is
//    loaded 32 flat lanes at a time with one coalesced load per array, the
//    next 32 lanes' before the current lanes' gathers, and the warp issues
//    the B-row gathers of gathers_in_flight() lanes (8 in fp32 at N=32:
//    8 x 128 bytes) before the multiply-adds that consume them,
//    broadcasting each lane's column and value by shuffle.
//  * Column tiles: each lane carries V = 1, 2 or 4 consecutive columns
//    (columns_per_lane: 4 above N=64, 2 above N=32) with one 4-16 byte load
//    and store, so a warp covers 32 * V columns and reads the metadata once
//    per tile.  The ragged column edge is masked per lane.
#include "panel_common.cuh"

using namespace loops;

namespace {

template <typename T, typename O, int V>
__global__ void __launch_bounds__(kWarp * kUnitWarps)
csr_units_kernel(const int64_t* __restrict__ units,
                 const int32_t* __restrict__ cols,
                 const T* __restrict__ vals, const bool* __restrict__ mask,
                 const T* __restrict__ b, O* __restrict__ out,
                 typename AccOf<T>::type* __restrict__ ws, int64_t nunits,
                 int64_t g, int64_t k, int64_t n, int64_t batch,
                 int64_t out_rows) {
  using A = typename AccOf<T>::type;
  constexpr int D = gathers_in_flight<T, V>();
  const int lane = threadIdx.x % kWarp;
  const int64_t unit =
      static_cast<int64_t>(blockIdx.x) * kUnitWarps + threadIdx.x / kWarp;
  if (unit >= nunits) return;  // uniform across the warp
  const int64_t group = units[unit * 4];
  const int64_t lo = units[unit * 4 + 1] * g;
  const int64_t hi = units[unit * 4 + 2] * g;
  const int64_t slot = units[unit * 4 + 3];
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * kWarp + lane) * V;
  const bool live = col < n;  // n % V == 0, so the whole Pack is in range
  const int64_t z = blockIdx.z;
  const T* bz = b + z * k * n + col;

  // Lane l holds flat panel lane base + l of the current 32 (a unit's
  // panels are contiguous): its column, or -1 where the lane is masked or
  // past the unit, and its value.  The next 32 lanes' metadata is loaded
  // before the current lanes' gathers, so its latency hides behind them.
  int c_next = -1;
  A v_next = A(0);
  auto load_meta = [&](int64_t base) {
    const int64_t e = base + lane;
    c_next = -1;
    v_next = A(0);
    if (e < hi) {
      const bool m = mask[e];
      const int c = cols[e];
      const A v = to_acc(vals[e]);
      if (m) {
        c_next = c;
        v_next = v;
      }
    }
  };
  load_meta(lo);

  A acc[V];
#pragma unroll
  for (int q = 0; q < V; ++q) acc[q] = A(0);
  for (int64_t base = lo; base < hi; base += kWarp) {
    const int c = c_next;
    const A v = v_next;
    load_meta(base + kWarp);
    const int cnt = static_cast<int>(hi - base < kWarp ? hi - base : kWarp);
#pragma unroll
    for (int j0 = 0; j0 < kWarp; j0 += D) {
      if (j0 >= cnt) break;
      Pack<T, V> x[D];
      A vj[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int cj = __shfl_sync(kFull, c, j0 + d);
        vj[d] = __shfl_sync(kFull, v, j0 + d);
        Pack<T, V> xd{};
        if (cj >= 0 && live) {
          xd = *reinterpret_cast<const Pack<T, V>*>(
              bz + static_cast<int64_t>(cj) * n);
        }
        x[d] = xd;
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] += vj[d] * to_acc(x[d].v[q]);
      }
    }
  }
  if (!live) return;
  if (slot < 0) {
    store_pack(out + (z * out_rows + group) * n + col, acc);
  } else {
    store_pack(ws + (slot * batch + z) * n + col, acc);
  }
}

// One call's arguments, as the C entry point takes them.
struct Call {
  const void *units, *splits, *cols, *vals, *mask, *b;
  void *out, *ws;
  int64_t nunits, nsplit, max_slots, g, k, n, batch, out_rows;
  cudaStream_t stream;
};

template <typename T, typename O, int V>
int launch_v(const Call& c) {
  using A = typename AccOf<T>::type;
  csr_units_kernel<T, O, V><<<unit_grid(c.nunits, c.n, V, c.batch),
                              kWarp * kUnitWarps, 0, c.stream>>>(
      static_cast<const int64_t*>(c.units),
      static_cast<const int32_t*>(c.cols), static_cast<const T*>(c.vals),
      static_cast<const bool*>(c.mask), static_cast<const T*>(c.b),
      static_cast<O*>(c.out), static_cast<A*>(c.ws), c.nunits, c.g, c.k,
      c.n, c.batch, c.out_rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<A, O, 1, V>(c.splits, c.ws, c.out, c.nsplit, c.max_slots,
                              c.batch, c.n, c.out_rows, 0, c.stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O>
int launch(const Call& c) {
  using A = typename AccOf<T>::type;
  const int v = columns_per_lane(c.n, sizeof(A) / 4, c.b, sizeof(T), c.out,
                                 sizeof(O));
  if (v == 4) return launch_v<T, O, 4>(c);
  if (v == 2) return launch_v<T, O, 2>(c);
  return launch_v<T, O, 1>(c);
}

}  // namespace

// C entry point.  Pointers are device pointers of contiguous tensors:
// units (nunits, 4) int64 and splits (nsplit, 3) int64 (the unit table,
// whose longest split group has max_slots slots), cols (P, G) int32, vals
// (P, G) T, mask (P, G) bool, b (batch, k, n) T, out (batch, out_rows, n) O,
// ws (slots, batch, 1, n) in the accumulation type (null when nsplit is 0).
// Launches the unit pass and, when a row is split, the second pass.
// Returns 0, the CUDA error of a launch, or kUnsupported.
extern "C" int csr_panels_spmm(const void* units, const void* splits,
                               const void* cols, const void* vals,
                               const void* mask, const void* b, void* out,
                               void* ws, int64_t nunits, int64_t nsplit,
                               int64_t max_slots, int64_t g, int64_t k,
                               int64_t n, int64_t batch, int64_t out_rows,
                               int dtype, int out_dtype, void* stream) {
  if (nunits == 0 || n == 0 || batch == 0) return 0;
  const Call c{units, splits, cols, vals, mask, b, out, ws,
               nunits, nsplit, max_slots, g, k, n, batch, out_rows,
               static_cast<cudaStream_t>(stream)};
  int rc = 0;
#define LAUNCH(T, O) rc = launch<T, O>(c)
  LOOPS_DISPATCH_DTYPES(dtype, out_dtype, LAUNCH)
#undef LAUNCH
  return rc;
}
