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
// at Br=8, N=32, still far below the card's 67 TFLOP/s : 3.35 TB/s ratio
// (~20), so it stays on the CUDA cores (FFMA / DFMA): a tensor-core form
// would not move a bytes-bound kernel.  The least time is the bytes the call
// must move (the panel arrays, the B rows it references, the output) over
// 3.35 TB/s; the gathered B-row bytes (ntiles * N * elem) are what it
// streams, from L2 when B fits in it and from HBM when it does not (the
// 179 MB B of an in-2004-sized matrix).
//
// Design.  As in B1 (csr_spmm.cu), bounded work units replace the TPU's
// sequential grid and each warp keeps several gathers in flight:
//  * One warp takes one unit (at most U panels of one block-row, from the
//    host's unit table) x one column tile x one batch slice; a block-row
//    longer than U is split into several units, whose partial sums go to
//    consecutive workspace slots and are added in slot order by the second
//    pass (reduce_partials_kernel, panel_common.cuh).  Every output row is
//    written exactly once: no atomics, no memset, a fixed summation order.
//  * For each 32 flat panel lanes, lane l loads its lane's column and mask
//    and the Br values of its tile column, coalesced across the warp (a
//    panel's Br x G block is read once), and stages the values in shared
//    memory, [Br][32] per warp.  The warp then issues gathers_in_flight()
//    B-row gathers before the multiply-adds that consume them; each
//    gathered element is reused Br times from a register against the
//    tile's values, read from shared memory as broadcasts.
//  * Column tiles of V = 1, 2 or 4 columns per lane, as in B1, capped so
//    that the Br x V accumulators fit 64 registers (fp64 at Br=16: V <= 2).
//    The ragged column edge is masked per lane.
#include "panel_common.cuh"

using namespace loops;

namespace {

template <typename T, typename O, int BR, int V>
__global__ void __launch_bounds__(kWarp * kUnitWarps)
bcsr_units_kernel(const int64_t* __restrict__ units,
                  const int32_t* __restrict__ cols,
                  const T* __restrict__ vals, const bool* __restrict__ mask,
                  const T* __restrict__ b, O* __restrict__ out,
                  typename AccOf<T>::type* __restrict__ ws, int64_t nunits,
                  int64_t g, int64_t k, int64_t n, int64_t batch,
                  int64_t out_rows, int64_t row_offset) {
  using A = typename AccOf<T>::type;
  constexpr int D = gathers_in_flight<T, V>();
  __shared__ A tile_vals[kUnitWarps][BR][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int wid = threadIdx.x / kWarp;
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kUnitWarps + wid;
  if (unit >= nunits) return;  // uniform across the warp
  const int64_t group = units[unit * 4];
  const int64_t lo = units[unit * 4 + 1] * g;
  const int64_t hi = units[unit * 4 + 2] * g;
  const int64_t slot = units[unit * 4 + 3];
  const int64_t col = (static_cast<int64_t>(blockIdx.y) * kWarp + lane) * V;
  const bool live = col < n;  // n % V == 0, so the whole Pack is in range
  const int64_t z = blockIdx.z;
  const T* bz = b + z * k * n + col;
  A(*sv)[kWarp] = tile_vals[wid];

  A acc[BR][V];
#pragma unroll
  for (int r = 0; r < BR; ++r) {
#pragma unroll
    for (int q = 0; q < V; ++q) acc[r][q] = A(0);
  }
  for (int64_t base = lo; base < hi; base += kWarp) {
    // Lane l holds flat panel lane e = base + l, i.e. lane i = e % g of
    // panel p = e / g, whose Br values sit at vals[p, :, i]; a masked or
    // absent lane gets column -1 and values 0.
    const int64_t e = base + lane;
    int c = -1;
    if (e < hi && mask[e]) {
      c = cols[e];
      const int64_t p = e / g;
      const T* pv = vals + p * BR * g + (e - p * g);
#pragma unroll
      for (int r = 0; r < BR; ++r) sv[r][lane] = to_acc(pv[r * g]);
    } else {
#pragma unroll
      for (int r = 0; r < BR; ++r) sv[r][lane] = A(0);
    }
    __syncwarp();
    const int cnt = static_cast<int>(hi - base < kWarp ? hi - base : kWarp);
#pragma unroll
    for (int j0 = 0; j0 < kWarp; j0 += D) {
      if (j0 >= cnt) break;
      Pack<T, V> x[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int cj = __shfl_sync(kFull, c, j0 + d);
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
        for (int r = 0; r < BR; ++r) {
          const A a = sv[r][j0 + d];
#pragma unroll
          for (int q = 0; q < V; ++q) acc[r][q] += a * to_acc(x[d].v[q]);
        }
      }
    }
    __syncwarp();
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    if (slot < 0) {
      store_pack(out + (z * out_rows + row_offset + group * BR + r) * n + col,
                 acc[r]);
    } else {
      store_pack(ws + ((slot * batch + z) * BR + r) * n + col, acc[r]);
    }
  }
}

// One call's arguments, as the C entry point takes them.
struct Call {
  const void *units, *splits, *cols, *vals, *mask, *b;
  void *out, *ws;
  int64_t nunits, nsplit, max_slots, g, k, n, batch, out_rows, row_offset;
  cudaStream_t stream;
};

template <typename T, typename O, int BR, int V>
int launch_v(const Call& c) {
  using A = typename AccOf<T>::type;
  bcsr_units_kernel<T, O, BR, V><<<unit_grid(c.nunits, c.n, V, c.batch),
                                   kWarp * kUnitWarps, 0, c.stream>>>(
      static_cast<const int64_t*>(c.units),
      static_cast<const int32_t*>(c.cols), static_cast<const T*>(c.vals),
      static_cast<const bool*>(c.mask), static_cast<const T*>(c.b),
      static_cast<O*>(c.out), static_cast<A*>(c.ws), c.nunits, c.g, c.k,
      c.n, c.batch, c.out_rows, c.row_offset);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<A, O, BR, V>(c.splits, c.ws, c.out, c.nsplit, c.max_slots,
                               c.batch, c.n, c.out_rows, c.row_offset,
                               c.stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename O, int BR>
int launch(const Call& c) {
  using A = typename AccOf<T>::type;
  const int v = columns_per_lane(c.n, BR * sizeof(A) / 4, c.b, sizeof(T),
                                 c.out, sizeof(O));
  if (v == 4) return launch_v<T, O, BR, 4>(c);
  if (v == 2) return launch_v<T, O, BR, 2>(c);
  return launch_v<T, O, BR, 1>(c);
}

}  // namespace

// C entry point.  Pointers are device pointers of contiguous tensors:
// units (nunits, 4) int64 and splits (nsplit, 3) int64 (the unit table,
// whose longest split group has max_slots slots), cols (P, G) int32, vals
// (P, br, G) T, mask (P, G) bool, b (batch, k, n) T, out (batch, out_rows,
// n) O, ws (slots, batch, br, n) in the accumulation type (null when nsplit
// is 0); the kernels write rows [row_offset, row_offset + ngroups*br) of
// each slice.  Launches the unit pass and, when a block-row is split, the
// second pass.  Returns 0, the CUDA error of a launch, or kUnsupported
// (dtype pair, or br not in {4, 8, 16}).
extern "C" int bcsr_panels_spmm(const void* units, const void* splits,
                                const void* cols, const void* vals,
                                const void* mask, const void* b, void* out,
                                void* ws, int64_t nunits, int64_t nsplit,
                                int64_t max_slots, int64_t br, int64_t g,
                                int64_t k, int64_t n, int64_t batch,
                                int64_t out_rows, int64_t row_offset,
                                int dtype, int out_dtype, void* stream) {
  if (br != 4 && br != 8 && br != 16) return loops::kUnsupported;
  if (nunits == 0 || n == 0 || batch == 0) return 0;
  const Call c{units, splits, cols, vals, mask, b, out, ws,
               nunits, nsplit, max_slots, g, k, n, batch, out_rows,
               row_offset, static_cast<cudaStream_t>(stream)};
  int rc = 0;
#define LAUNCH(T, O)                                                       \
  if (br == 4) {                                                           \
    rc = launch<T, O, 4>(c);                                               \
  } else if (br == 8) {                                                    \
    rc = launch<T, O, 8>(c);                                               \
  } else {                                                                 \
    rc = launch<T, O, 16>(c);                                              \
  }
  LOOPS_DISPATCH_DTYPES(dtype, out_dtype, LAUNCH)
#undef LAUNCH
  return rc;
}
