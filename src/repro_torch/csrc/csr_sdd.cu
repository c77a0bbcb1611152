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
// What bounds it on the H100.  Counted once, the inputs are small: the
// part's dY rows and the B rows it references.  But every stored value
// needs its whole B row (batch x N elements) against one dY row, so a
// kernel that gathers a B row per stored value moves nnz x batch x N
// elements: at the sparse FFN's CSR part (127,369 values, batch 2, N 1024,
// fp32) 1.04 GB for 0.52 GFLOP, more than the L2 delivers in the 0.0078 ms
// operations bound.  Where rows of the part share columns, a block of rows
// x a band of columns stages each shared B row in shared memory once and
// serves every stored value of the block from there (3-6x fewer bytes out
// of L2); what bounds it then is that staging (measured on the H100 at
// ~3.3 TB/s out of L2, more than half the kernel's time at the FFN) and
// shared memory's 128 bytes a clock per SM (4 bytes of B per fp32
// multiply-add).  Where rows share no columns (in-2004's hub rows),
// staging would move the same bytes twice, and the gathers, from HBM, are
// the floor.
//
// Design.  The TPU kernel keeps each panel's accumulator in VMEM while the
// column and batch blocks stream past a sequential grid.  Here the host cuts
// the part into blocks (kernels/spmm_sdd.py::sdd_block_table), and one CTA
// owns one block's outputs across all of N and the batch: no output has two
// writers, so there are no atomics and no second pass, and the summation
// order is fixed (two calls give the same bits).
//   * Lane groups.  A CTA's threads form groups of 8 lanes that read one
//     128-byte line of a row together, 16 bytes a lane.  A group keeps K
//     outputs, each lane its partial sums over its columns of every line;
//     at the end a reduce-scatter over the 8 lanes (7 shuffles for 8
//     outputs) leaves each lane K / 8 whole sums to write.
//   * Staged blocks (consecutive rows x a band of columns they share; the
//     kernel csr_sdd_staged_kernel): the block's dY rows and its distinct B
//     rows (a sorted column list; each output carries its slot in it) are
//     staged kChunkLines lines at a time with 16-byte cp.async into a ring
//     of kStages buffers, one CTA barrier a chunk.  A group's outputs are
//     consecutive in (row, column) order, so it reads a dY line once per
//     row and one B line per output, and each 8-lane phase of a read is
//     one whole 128-byte line: no bank conflicts.
//   * Direct blocks (no shared columns: a range of panels, a hub row cut at
//     panel boundaries; csr_sdd_direct_kernel, launched after the staged
//     one, small CTAs with few registers so many are in flight): a group
//     loads its panels' metadata at once, then gathers its outputs' B lines
//     straight from global memory, all K before the first multiply-add.
//   * Precision: half B is widened as it is read; fp32 accumulates in fp32
//     (FFMA, no TF32), fp64 in fp64.  fp32 dY against half B is two 16-byte
//     pieces a lane, staged interleaved so that each read is a whole line.
//   * The ragged end of N is zero-filled; rows whose bytes are not 16-byte
//     aligned are staged and read with plain loads instead of cp.async.
#include "panel_common.cuh"

using namespace loops;

namespace {

// Shape choices, measured with kernel_sweep.py b3 (PERF.md).  The block
// table's caps (kernels/spmm_sdd.py) follow them: a staged block holds at
// most kThreads / 8 * kOuts outputs, a direct one kDirectThreads / 8 *
// kDirectOuts; a larger block is walked in passes.
constexpr int kThreads = 512;       // threads of a staged-block CTA
constexpr int kOuts = 16;           // outputs a lane group keeps (staged)
constexpr int kStages = 2;          // ring of staged chunks
constexpr int kChunkLines = 2;      // 128-byte lines of each row a chunk has
constexpr int kMinBlocks = 1;       // staged CTAs an SM must hold
constexpr int kDirectThreads = 128; // threads of a direct-block CTA
constexpr int kDirectOuts = 8;      // outputs a lane group keeps (direct)
constexpr int kDirectMinBlocks = 6; // direct CTAs an SM must hold
constexpr int kLanes = 8;           // lanes of a group: one 128-byte line
constexpr int kLine = 128;
constexpr int kMaxSmem = 232448;    // dynamic shared memory a CTA may have
constexpr int kBlockFields = 8;     // int64 fields of a block row

static_assert(kOuts % kLanes == 0 && kOuts <= 32, "kOuts: 8, 16, 24 or 32");
static_assert(kDirectOuts % kLanes == 0 && kDirectOuts <= 32,
              "kDirectOuts: 8, 16, 24 or 32");
static_assert(kThreads % kWarp == 0 && kDirectThreads % kWarp == 0,
              "whole warps");
static_assert(kStages >= 2, "a ring of at least two chunks");

template <typename TD, typename TB>
struct Sdd {
  using A = typename AccOf<TB>::type;
  static_assert(sizeof(TD) % sizeof(TB) == 0, "dY at least as wide as B");
  // B elements a lane reads of a line (16 bytes), and a line's elements.
  static constexpr int kVE = 16 / static_cast<int>(sizeof(TB));
  static constexpr int kElems = kLanes * kVE;
  static constexpr int kRho = static_cast<int>(sizeof(TD) / sizeof(TB));
  static constexpr int kDyVE = kVE / kRho;      // dY elements of 16 bytes
  static constexpr int kDyLine = kLine * kRho;  // bytes of a dY line
};

// Walks the (batch slice, first element) of consecutive lines.
struct Lines {
  int64_t z = 0, n0 = 0;
  __device__ __forceinline__ void advance(int64_t n, int elems) {
    n0 += elems;
    if (n0 >= n) {
      n0 = 0;
      ++z;
    }
  }
};

// 16 bytes of T from src (global) to dst (shared): the first `left`
// elements, zeros past them (left <= 0: all zeros).  With vec, left is
// either <= 0 or a whole 16 bytes.
template <typename T>
__device__ __forceinline__ void copy16(uint8_t* dst, const T* src,
                                       int64_t left, int vec) {
  if (vec) {
    cp_async16(dst, src, left > 0 ? 16 : 0);
  } else {
    constexpr int V = 16 / static_cast<int>(sizeof(T));
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    T* el = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < left) el[e] = src[e];
    *reinterpret_cast<uint4*>(dst) = raw;
  }
}

// V elements of T at p, widened: one 16-byte load (aligned, or from shared
// memory), else plain loads of the first `left`, zeros past them.
template <typename T, typename A, int V>
__device__ __forceinline__ void load_vec(const T* p, int64_t left, bool whole,
                                         A (&v)[V]) {
  if (whole) {
    const Pack<T, V> x = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_acc(x.v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = e < left ? to_acc(p[e]) : A(0);
  }
}

// A lane's V dY elements: V / (16 / sizeof(TD)) pieces of 16 bytes,
// `stride` bytes apart.
template <typename TD, typename A, int V>
__device__ __forceinline__ void load_dy(const uint8_t* p, int stride,
                                        int64_t left, bool whole,
                                        A (&v)[V]) {
  constexpr int DV = 16 / static_cast<int>(sizeof(TD));
#pragma unroll
  for (int h = 0; h < V / DV; ++h) {
    A part[DV];
    load_vec(reinterpret_cast<const TD*>(p + h * stride), left - h * DV,
             whole, part);
#pragma unroll
    for (int e = 0; e < DV; ++e) v[h * DV + e] = part[e];
  }
}

// One step of group_reduce: lanes with bit m of s keep the upper H sums,
// the others the lower H, each adding its partner's copy (lane s ^ m).
template <int H, typename A, int K>
__device__ __forceinline__ void reduce_step(A (&acc)[K], int s, int m) {
  const bool up = (s & m) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const A send = up ? acc[i] : acc[i + H];
    const A keep = up ? acc[i + H] : acc[i];
    acc[i] = keep + __shfl_xor_sync(kFull, send, m);
  }
}

// acc[o] holds this lane's partial sum of output o of its group; after the
// call acc[i], i < K / 8, is the whole sum (over the group's 8 lanes s) of
// output s * K / 8 + i.  The order of the additions is fixed.
template <int K, typename A>
__device__ __forceinline__ void group_reduce(A (&acc)[K], int s) {
  static_assert(kLanes == 8, "three steps");
  reduce_step<K / 2>(acc, s, 4);
  reduce_step<K / 4>(acc, s, 2);
  reduce_step<K / 8>(acc, s, 1);
}

// Staged blocks: fields (kind, first output, outputs, first column, columns,
// first dY row, dY rows).  outs[first + j] is output j's flat panel slot,
// info[first + j] its (local row << 16 | column slot), -1 at a masked lane.
// Chunks of kChunkLines lines of the block's dY rows and distinct B rows go
// through a ring of kStages shared-memory buffers: chunk j + kStages - 1 is
// issued while chunk j is read, one CTA barrier a chunk.
template <typename TD, typename TB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
csr_sdd_staged_kernel(const int64_t* __restrict__ blocks,
                      const int32_t* __restrict__ outs,
                      const int32_t* __restrict__ info,
                      const int32_t* __restrict__ dcols,
                      const TD* __restrict__ dy, const TB* __restrict__ b,
                      typename AccOf<TB>::type* __restrict__ out, int64_t m,
                      int64_t k, int64_t n, int64_t batch, int vec) {
  using S = Sdd<TD, TB>;
  using A = typename S::A;
  constexpr int kGroups = kThreads / kLanes;
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t* blk =
      blocks + static_cast<int64_t>(blockIdx.x) * kBlockFields;
  const int64_t first = blk[1], count = blk[2], col0 = blk[3];
  const int ncol = static_cast<int>(blk[4]);
  const int64_t row0 = blk[5];
  const int nrow = static_cast<int>(blk[6]);
  int32_t* scol = reinterpret_cast<int32_t*>(smem);
  uint8_t* stages = smem + (ncol * 4 + 15) / 16 * 16;
  constexpr int kDyRow = kChunkLines * S::kDyLine;   // a dY row's chunk
  constexpr int kBRow = kChunkLines * kLine;         // a B row's chunk
  const int dy_bytes = nrow * kDyRow;
  const int stage_bytes = dy_bytes + ncol * kBRow;
  const int tid = static_cast<int>(threadIdx.x);
  const int grp = tid / kLanes;
  const int s = tid % kLanes;
  const int64_t nlines = batch * ((n + S::kElems - 1) / S::kElems);
  const int64_t nchunks = (nlines + kChunkLines - 1) / kChunkLines;

  for (int c = tid; c < ncol; c += kThreads) scol[c] = dcols[col0 + c];
  __syncthreads();

  // Stages the next chunk (pos: its first line) into buffer `buf`; lines
  // past the batch are zeros.  A thread takes 16-byte pieces of rows and
  // copies each for every line of the chunk.
  Lines pos;
  auto stage = [&](int buf) {
    uint8_t* base = stages + buf * stage_bytes;
    int64_t dyl[kChunkLines], bl[kChunkLines], n0[kChunkLines];
#pragma unroll
    for (int l = 0; l < kChunkLines; ++l) {   // each line's element offset
      const bool live = pos.z < batch;
      n0[l] = live ? pos.n0 : n;              // n: a line of zeros
      dyl[l] = (live ? pos.z * m : 0) * n + n0[l];
      bl[l] = (live ? pos.z * k : 0) * n + n0[l];
      pos.advance(n, S::kElems);
    }
    constexpr int dq = 8 * S::kRho;   // 16-byte pieces of a dY line
    for (int q = tid; q < nrow * dq; q += kThreads) {
      const int r = q / dq;
      const int qq = q % dq;
      const TD* src = dy + (row0 + r) * n + qq * S::kDyVE;
      uint8_t* dst = base + r * kDyRow +
                     ((qq % S::kRho) * 8 + qq / S::kRho) * 16;
#pragma unroll
      for (int l = 0; l < kChunkLines; ++l) {
        const int64_t left = n - n0[l] - qq * S::kDyVE;
        copy16(dst + l * S::kDyLine, left > 0 ? src + dyl[l] : dy, left, vec);
      }
    }
    for (int q = tid; q < ncol * 8; q += kThreads) {
      const TB* src = b + static_cast<int64_t>(scol[q / 8]) * n +
                      (q % 8) * S::kVE;
      uint8_t* dst = base + dy_bytes + (q / 8) * kBRow + (q % 8) * 16;
#pragma unroll
      for (int l = 0; l < kChunkLines; ++l) {
        const int64_t left = n - n0[l] - (q % 8) * S::kVE;
        copy16(dst + l * kLine, left > 0 ? src + bl[l] : b, left, vec);
      }
    }
  };

  for (int64_t o0 = 0; o0 < count; o0 += kGroups * kOuts) {
    // This group's outputs: shared-memory offsets of their B and dY rows.
    int boff[kOuts], doff[kOuts];
    uint32_t dead = 0;
    int prev = 0;
#pragma unroll
    for (int o = 0; o < kOuts; ++o) {
      const int64_t j = o0 + grp * kOuts + o;
      const int32_t x = j < count ? info[first + j] : -1;
      if (x < 0) {   // masked lane or past the block: read row 0, write 0
        dead |= 1u << o;
        boff[o] = 0;
        doff[o] = prev;
      } else {
        boff[o] = (x & 0xffff) * kBRow;
        doff[o] = (x >> 16) * kDyRow;
        prev = doff[o];
      }
    }
    A acc[kOuts];
#pragma unroll
    for (int o = 0; o < kOuts; ++o) acc[o] = A(0);
    if (ncol > 0) {
      pos = Lines();
#pragma unroll
      for (int c = 0; c < kStages - 1; ++c) {
        if (c < nchunks) stage(c);
        cp_async_commit();
      }
      for (int64_t j = 0; j < nchunks; ++j) {
        cp_async_wait<kStages - 2>();
        __syncthreads();   // chunk j is in; chunk j - 1's buffer is free
        if (j + kStages - 1 < nchunks)
          stage(static_cast<int>((j + kStages - 1) % kStages));
        cp_async_commit();
        const uint8_t* base =
            stages + static_cast<int>(j % kStages) * stage_bytes + s * 16;
        A dv[kChunkLines][S::kVE];
#pragma unroll
        for (int o = 0; o < kOuts; ++o) {
          if (o == 0 || doff[o] != doff[o - 1]) {
#pragma unroll
            for (int l = 0; l < kChunkLines; ++l)
              load_dy<TD>(base + doff[o] + l * S::kDyLine, kLine, S::kVE,
                          true, dv[l]);
          }
#pragma unroll
          for (int l = 0; l < kChunkLines; ++l) {
            A bv[S::kVE];
            load_vec(reinterpret_cast<const TB*>(base + dy_bytes + boff[o] +
                                                 l * kLine),
                     S::kVE, true, bv);
#pragma unroll
            for (int e = 0; e < S::kVE; ++e) acc[o] += dv[l][e] * bv[e];
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();   // the buffers may be refilled by the next pass
    }
    group_reduce<kOuts>(acc, s);
#pragma unroll
    for (int i = 0; i < kOuts / kLanes; ++i) {
      const int o = s * (kOuts / kLanes) + i;
      const int64_t j = o0 + grp * kOuts + o;
      if (j < count) out[outs[first + j]] = (dead >> o) & 1u ? A(0) : acc[i];
    }
  }
}

// Direct blocks: fields (kind, first flat panel slot, slots); the outputs
// are the slots first .. first + slots - 1 of the (P, G) layout.  A group's
// panel metadata is loaded at once, then its kDirectOuts B lines.
template <typename TD, typename TB>
__global__ void __launch_bounds__(kDirectThreads, kDirectMinBlocks)
csr_sdd_direct_kernel(const int64_t* __restrict__ blocks,
                      const int32_t* __restrict__ rows,
                      const int32_t* __restrict__ cols,
                      const bool* __restrict__ mask,
                      const TD* __restrict__ dy, const TB* __restrict__ b,
                      typename AccOf<TB>::type* __restrict__ out, int64_t g,
                      int64_t m, int64_t k, int64_t n, int64_t batch,
                      int vec) {
  using S = Sdd<TD, TB>;
  using A = typename S::A;
  constexpr int K = kDirectOuts;
  constexpr int kGroups = kDirectThreads / kLanes;
  const int64_t* blk =
      blocks + static_cast<int64_t>(blockIdx.x) * kBlockFields;
  const int64_t first = blk[1], count = blk[2];
  const int tid = static_cast<int>(threadIdx.x);
  const int grp = tid / kLanes;
  const int s = tid % kLanes;
  const int64_t nlines = batch * ((n + S::kElems - 1) / S::kElems);

  for (int64_t o0 = 0; o0 < count; o0 += kGroups * K) {
    const int64_t f0 = first + o0 + grp * K;   // flat slot of output 0
    const int64_t mine = count - (o0 + grp * K);
    // Each output's B row (-1: masked lane or past the block) and dY row.
    int32_t bcol[K], drow[K];
    uint32_t dead = 0;
    int64_t p = f0 / g, lane = f0 - p * g;
#pragma unroll
    for (int o = 0; o < K; ++o) {
      const bool in = o < mine;
      const bool live = in && mask[f0 + o];
      bcol[o] = in ? cols[f0 + o] : 0;
      drow[o] = in ? rows[p] : (o > 0 ? drow[o - 1] : 0);
      if (!live) {
        bcol[o] = -1;
        dead |= 1u << o;
      }
      if (++lane == g) {
        lane = 0;
        ++p;
      }
    }
    A acc[K];
#pragma unroll
    for (int o = 0; o < K; ++o) acc[o] = A(0);
    Lines pos;
    for (int64_t line = 0; line < nlines; ++line) {
      const int64_t e = pos.n0 + s * S::kVE;
      const int64_t left = n - e;
      const bool whole = vec && left > 0;
      uint4 raw[K];   // the K gathers, 16 bytes each (zeros if none)
#pragma unroll
      for (int o = 0; o < K; ++o) {
        raw[o] = make_uint4(0u, 0u, 0u, 0u);
        if (bcol[o] >= 0 && left > 0) {
          const TB* src = b + (pos.z * k + bcol[o]) * n + e;
          if (whole) {
            raw[o] = *reinterpret_cast<const uint4*>(src);
          } else {
            TB* el = reinterpret_cast<TB*>(&raw[o]);
#pragma unroll
            for (int q = 0; q < S::kVE; ++q)
              if (q < left) el[q] = src[q];
          }
        }
      }
      A dv[S::kVE];
#pragma unroll
      for (int o = 0; o < K; ++o) {
        if (o == 0 || drow[o] != drow[o - 1])
          load_dy<TD>(reinterpret_cast<const uint8_t*>(
                          dy + (pos.z * m + drow[o]) * n + (left > 0 ? e : 0)),
                      16, left, whole, dv);
        const TB* el = reinterpret_cast<const TB*>(&raw[o]);
#pragma unroll
        for (int q = 0; q < S::kVE; ++q) acc[o] += dv[q] * to_acc(el[q]);
      }
      pos.advance(n, S::kElems);
    }
    group_reduce<K>(acc, s);
#pragma unroll
    for (int i = 0; i < K / kLanes; ++i) {
      const int o = s * (K / kLanes) + i;
      if (o < mine) out[f0 + o] = (dead >> o) & 1u ? A(0) : acc[i];
    }
  }
}

template <typename TD, typename TB>
int launch(const void* blocks, const void* outs, const void* info,
           const void* dcols, const void* rows, const void* cols,
           const void* mask, const void* dy, const void* b, void* out,
           int64_t nblocks, int64_t nstaged, int64_t max_rows,
           int64_t max_cols, int64_t g, int64_t m, int64_t k, int64_t n,
           int64_t batch, cudaStream_t s) {
  using S = Sdd<TD, TB>;
  const int vec = (n * static_cast<int64_t>(sizeof(TB))) % 16 == 0 &&
                  (n * static_cast<int64_t>(sizeof(TD))) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const auto* blk = static_cast<const int64_t*>(blocks);
  using O = typename AccOf<TB>::type;
  if (nstaged > 0) {
    const int64_t smem =
        (max_cols * 4 + 15) / 16 * 16 +
        static_cast<int64_t>(kStages) * kChunkLines *
            (max_rows * S::kDyLine + max_cols * kLine);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    static int64_t configured = 48 * 1024;
    if (smem > configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          csr_sdd_staged_kernel<TD, TB>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      configured = smem;
    }
    csr_sdd_staged_kernel<TD, TB>
        <<<static_cast<unsigned>(nstaged), kThreads,
           static_cast<size_t>(smem), s>>>(
            blk, static_cast<const int32_t*>(outs),
            static_cast<const int32_t*>(info),
            static_cast<const int32_t*>(dcols), static_cast<const TD*>(dy),
            static_cast<const TB*>(b), static_cast<O*>(out), m, k, n, batch,
            vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nblocks > nstaged) {
    csr_sdd_direct_kernel<TD, TB>
        <<<static_cast<unsigned>(nblocks - nstaged), kDirectThreads, 0, s>>>(
            blk + nstaged * kBlockFields, static_cast<const int32_t*>(rows),
            static_cast<const int32_t*>(cols),
            static_cast<const bool*>(mask), static_cast<const TD*>(dy),
            static_cast<const TB*>(b), static_cast<O*>(out), g, m, k, n,
            batch, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point.  Pointers are device pointers of contiguous tensors: the
// block table of kernels/spmm_sdd.py::sdd_block_table (blocks (nblocks, 8)
// int64, its first nstaged rows the staged blocks; outs and info int32;
// dcols int32; max_rows / max_cols the most dY rows / distinct columns of
// a staged block, which size the shared memory), the panels' rows (P,)
// int32, cols (P, G) int32 and mask (P, G) bool, dy (batch, m, n) TD, b
// (batch, k, n) TB, out (P, G) in TB's accumulation type.  Every panel
// slot must lie in exactly one block.  Returns 0, the CUDA error of a
// launch, or kUnsupported for a dtype pair.
extern "C" int csr_sdd_panels(const void* blocks, const void* outs,
                              const void* info, const void* dcols,
                              const void* rows, const void* cols,
                              const void* mask, const void* dy, const void* b,
                              void* out, int64_t nblocks, int64_t nstaged,
                              int64_t max_rows, int64_t max_cols, int64_t g,
                              int64_t m, int64_t k, int64_t n, int64_t batch,
                              int dy_dtype, int b_dtype, void* stream) {
  if (nblocks == 0) return 0;
  if (nblocks - nstaged > 0x7fffffff || nstaged > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(TD, TB)                                                      \
  return launch<TD, TB>(blocks, outs, info, dcols, rows, cols, mask, dy, b, \
                        out, nblocks, nstaged, max_rows, max_cols, g, m, k, \
                        n, batch, s);
  LOOPS_DISPATCH_SDD(dy_dtype, b_dtype, LAUNCH)
#undef LAUNCH
  return 0;
}
