// The trilinear corners of one row: the device code K1 (deposit.cu), K2
// (the grouped deposit, deposit.cu) and K4 (the window-gain deposit,
// gain_deposit.cu) share.  K4 "tri" samples its gain through the same
// corners and weights it deposits through, so the two cannot drift apart.
//
// Contract, for a row with inc != 0:
//   per axis a:  p = frac_a - 0.5,  d = 1 - |p|,  s = (p < 0 ? -1 : 1)
//                node cell_a + 1 gets weight 1 - d, node cell_a + 1 + s
//                gets weight d
//   edep[x, y, z] += wx * wy * wz * inc   over the 2x2x2 corners,
// the reference's scheme (launch_ray_XZ.cu:319-348).  On a boundary exit
// row |p| > 0.5, so d < 0: the reference's negative extrapolated weight is
// kept exactly.  A row with a corner outside the (nxp, nyp, nzp) grid is not
// written and is counted in *overflow.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cbet {

// Node indices in the ghost-padded (nxp, nyp, nzp) grid and weights of one
// row's eight corners: corner (a, b, c) is (ix[a], iy[b], iz[c]) with weight
// (wx[a] * wy[b]) * wz[c]; index 0 is node cell + 1, index 1 its neighbour.
template <typename T>
struct Corners {
  int ix[2], iy[2], iz[2];
  T wx[2], wy[2], wz[2];
  bool ok;  // every corner inside the grid
};

template <typename T>
__device__ __forceinline__ bool axis_weights(T frac, int cell, int np_,
                                             int* i, T* w) {
  const T p = frac - T(0.5);
  const T d = T(1) - (p < T(0) ? -p : p);
  const int s = p < T(0) ? -1 : 1;
  i[0] = cell + 1;
  i[1] = cell + 1 + s;
  w[0] = T(1) - d;
  w[1] = d;
  return i[0] >= 0 && i[0] < np_ && i[1] >= 0 && i[1] < np_;
}

template <typename T>
__device__ __forceinline__ Corners<T> row_corners(int cx, int cy, int cz,
                                                  T fx, T fy, T fz, int nxp,
                                                  int nyp, int nzp) {
  Corners<T> c;
  const bool okx = axis_weights(fx, cx, nxp, c.ix, c.wx);
  const bool oky = axis_weights(fy, cy, nyp, c.iy, c.wy);
  const bool okz = axis_weights(fz, cz, nzp, c.iz, c.wz);
  c.ok = okx && oky && okz;
  return c;
}

// Eight atomicAdds of u at the corners (which must be in the grid); the
// product order (wx * wy) * wz * u matches the plain version.
template <typename T>
__device__ __forceinline__ void deposit_corners(T* __restrict__ edep,
                                                const Corners<T>& c, T u,
                                                int nyp, int nzp) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T wxy = c.wx[a] * c.wy[b];
      const long long row = ((long long)c.ix[a] * nyp + c.iy[b]) * nzp;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        atomicAdd(edep + row + c.iz[k], wxy * c.wz[k] * u);
      }
    }
  }
}

// The deposit of one row into one (nxp, nyp, nzp) grid; the caller has
// already skipped rows with u == 0.
template <typename T>
__device__ __forceinline__ void deposit_row(T* __restrict__ edep, int cx,
                                            int cy, int cz, T fx, T fy, T fz,
                                            T u, int nxp, int nyp, int nzp,
                                            int* __restrict__ overflow) {
  const Corners<T> c = row_corners(cx, cy, cz, fx, fy, fz, nxp, nyp, nzp);
  if (!c.ok) {
    atomicAdd(overflow, 1);
    return;
  }
  deposit_corners(edep, c, u, nyp, nzp);
}

// ---- The shared-memory tile box: K2 and K4 "cell"/"tri" -------------------
//
// A block of kBoxThreads consecutive rays deposits its window into a box of
// shared memory spanning the nodes its rows touch, then flushes each
// non-zero node of the box with one global atomicAdd, z fastest (the grid's
// contiguous axis).  Neighbouring rays hit the same nodes: an OMEGA launch
// tile (256 rays of one beam's pupil patch, one block) covers a median of
// ~1,300 box nodes over a 5-step window, where its 1,280 rows make 10,240
// corner atomics.  The global atomics fall by that ratio, and a K2 block's
// read-modify-writes of a beam grid that is not in L2 become one flush into
// that grid.  (The TPU kernel's VMEM tile box, cbet_raytracing_3d_tpu/ops/
// pallas_deposit.py::_tile_ebox, with shared-memory atomics in place of its
// one-hot matrix products.)
//
// The box holds 64-bit fixed point, not floats: sm_90 has no shared-memory
// float add, nor a 64-bit integer one (atomicAdd on a shared float, double
// or 64-bit integer compiles to a compare-and-swap loop, ATOMS.CAST.SPIN,
// which lanes hitting one node retry in turn), while 32-bit integer adds
// are native (ATOMS.ADD).  So a node is two 32-bit words, and a value adds
// its low word with one native atomic and its high word, plus the carry
// that atomic's old value shows, with another (add_fixed).  Each block
// scales its values by a power of two chosen from its largest corner value
// (plan_box), so that no node's sum can leave 63 bits: the integer adds are
// exact and in any order the same, a corner's value is rounded once to
// 2^-51 of the block's largest corner value (batch 5), and each node once
// more when it is flushed to the grid's type.
//
// A window kernel first reads its rows' corners once to find the block's
// box (a superset of the rows that deposit is exact), then runs its
// ordinary loop, which deposits each row's corners into the box
// (box_deposit) or, on the direct path, into the grid (deposit_corners).
// Keeping a window's rows (5 steps, 35 values a thread) in registers
// between the two passes instead took 100-128 registers a thread and was
// slower than the direct kernels.  One step's 7 values fit: the one-step
// kernel (deposit.cu) reads its rows once, with a box of its own.
//
// A block whose box exceeds the capacity, or that the caller marks as not
// boxable (a K2 block whose rays fall into two groups' grids), takes the
// direct path: each row's eight corners with global atomics, as the direct
// kernels do.  Sums run in another order than the direct path's, so f32
// grids differ from it at the ulp level.
//
// Pitfalls: every thread of a block reaches the barriers of plan_box and
// box_flush, so the kernels have no early `return` before them (a thread
// past the last ray, or whose rays are all dead, brings an empty box); the
// negative boundary-exit weight (d < 0) lands in the box like any other, as
// a two's-complement integer; offsets into the grids stay int64.

constexpr int kBoxThreads = 256;
// A box node is one 64-bit integer, in f32 and f64 alike.
using BoxNode = unsigned long long;
// The default capacity in nodes (24 KB).  At OMEGA (scripts/box_sweep.py on
// chip_smoke phase 8's window, 3,600 blocks with rows) 66 % of the blocks' boxes hold at most
// 2,048 nodes, 98 % at most 4,096, all at most 5,120; K2 and K4 took least
// time at 3,072 (85 % of the blocks in the box) among 2,048-5,120: a larger
// box costs its zeroing and flush in every block that takes it.
constexpr int kBoxNodes = 3072;
// Within the 48 KB of shared memory a block may use without opting in,
// beside the few hundred static bytes of plan_box.
constexpr int kMaxBoxBytes = 40 * 1024;

// The capacity for a requested one: < 0 the default, 0 none (the direct
// kernels); -1 when it would not fit kMaxBoxBytes.
inline int box_capacity(int requested) {
  const long long nodes = requested < 0 ? kBoxNodes : requested;
  return nodes * (long long)sizeof(BoxNode) <= kMaxBoxBytes ? (int)nodes
                                                           : -1;
}

// Inclusive node bounds of a box (empty when lo > hi) and the largest
// |value| of a corner that may be added to it.
template <typename T>
struct Box {
  int lo[3], hi[3];
  T vmax;
};

template <typename T>
__device__ __forceinline__ Box<T> empty_box() {
  Box<T> b;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    b.lo[a] = INT_MAX;
    b.hi[a] = INT_MIN;
  }
  b.vmax = T(0);
  return b;
}

template <typename T>
__device__ __forceinline__ T abs_max(T a, T b) {
  a = a < T(0) ? -a : a;
  b = b < T(0) ? -b : b;
  return a > b ? a : b;
}

// Adds a row whose deposit value is at most `umax` in magnitude.
template <typename T>
__device__ __forceinline__ void box_add(Box<T>& b, const Corners<T>& c,
                                        T umax) {
  b.lo[0] = min(b.lo[0], min(c.ix[0], c.ix[1]));
  b.hi[0] = max(b.hi[0], max(c.ix[0], c.ix[1]));
  b.lo[1] = min(b.lo[1], min(c.iy[0], c.iy[1]));
  b.hi[1] = max(b.hi[1], max(c.iy[0], c.iy[1]));
  b.lo[2] = min(b.lo[2], min(c.iz[0], c.iz[1]));
  b.hi[2] = max(b.hi[2], max(c.iz[0], c.iz[1]));
  const T m = abs_max(umax, T(0)) * abs_max(c.wx[0], c.wx[1]) *
              abs_max(c.wy[0], c.wy[1]) * abs_max(c.wz[0], c.wz[1]);
  // a NaN or infinite value makes the block's scale infinite: the block
  // takes the direct path, which carries the value into the grid as it is
  b.vmax = isfinite(m) ? (m > b.vmax ? m : b.vmax) : T(INFINITY);
}

// The block's box, whether it deposits through it, and its fixed-point
// scale (box units per value unit) and inverse.
struct BoxPlan {
  int lo[3], dy, dz, vol;
  bool use;
  double scale, inv;
};

// The block's box (the union of the threads' boxes `mine`: warp
// reductions, then the warps' boxes through shared memory) and its plan:
// the box is used when `boxable`, non-empty and within `box_nodes` nodes,
// and is then zeroed.  A node's sum is at most 256 rays x `batch` rows x the
// block's largest corner value in magnitude, below 2^(8 + bits(batch) + E)
// with E the exponent of that value; the scale 2^(62 - 8 - bits(batch) - E)
// keeps it within 62 bits.  When `tally` is not null, tally[0] counts the
// blocks with rows and tally[1] those that took the box.  Every thread of
// the block calls it, once per kernel; the plan is the same in every
// thread.
template <typename T>
__device__ __forceinline__ BoxPlan plan_box(const Box<T>& mine, int batch,
                                            bool boxable, int box_nodes,
                                            BoxNode* __restrict__ box,
                                            int* __restrict__ tally) {
  __shared__ int part[kBoxThreads / 32][7];
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e_mine = !(mine.vmax > T(0))  ? INT_MIN
                     : isfinite(mine.vmax) ? ilogb((double)mine.vmax)
                                           : INT_MAX;
  const int e_warp = __reduce_max_sync(all, e_mine);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int lo = __reduce_min_sync(all, mine.lo[a]);
    const int hi = __reduce_max_sync(all, mine.hi[a]);
    if (lane == 0) {
      part[warp][a] = lo;
      part[warp][3 + a] = hi;
    }
  }
  if (lane == 0) part[warp][6] = e_warp;
  __syncthreads();
  int lo[3] = {INT_MAX, INT_MAX, INT_MAX}, hi[3] = {INT_MIN, INT_MIN, INT_MIN};
  int e_max = INT_MIN;
#pragma unroll
  for (int w = 0; w < kBoxThreads / 32; ++w) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = min(lo[a], part[w][a]);
      hi[a] = max(hi[a], part[w][3 + a]);
    }
    e_max = max(e_max, part[w][6]);
  }
  BoxPlan p;
  const bool empty = lo[0] > hi[0];
  const long long vol = empty ? 0
                              : (long long)(hi[0] - lo[0] + 1) *
                                    (hi[1] - lo[1] + 1) * (hi[2] - lo[2] + 1);
#pragma unroll
  for (int a = 0; a < 3; ++a) p.lo[a] = lo[a];
  p.dy = hi[1] - lo[1] + 1;
  p.dz = hi[2] - lo[2] + 1;
  // rows of value 0 only: nothing to scale, nothing deposits; a scale
  // beyond double's range (a NaN or infinite value, or all values below
  // 2^-900): the direct path
  p.use = boxable && !empty && e_max > -900 && e_max < 900 &&
          vol <= box_nodes;
  p.vol = p.use ? (int)vol : 0;
  const int e = p.use ? 62 - 8 - (32 - __clz(batch)) - (e_max + 1) : 0;
  p.scale = p.use ? ldexp(1.0, e) : 0.0;
  p.inv = p.use ? ldexp(1.0, -e) : 0.0;
  if (tally != nullptr && threadIdx.x == 0 && !empty) {
    atomicAdd(tally, 1);
    if (p.use) atomicAdd(tally + 1, 1);
  }
  if (p.use) {
    for (int k = threadIdx.x; k < p.vol; k += kBoxThreads) box[k] = 0ull;
    __syncthreads();
  }
  return p;
}

// Adds the 64-bit two's-complement `v` to a box node with two native 32-bit
// shared atomics: the low word, then the high word with the low word's
// carry (old + lo wraps).  Exact in any interleaving: each low add sees the
// word it changed, so the carries sum to those of the total.
__device__ __forceinline__ void add_fixed(BoxNode* node, long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(node);     // little-endian
  const unsigned lo = (unsigned)v;
  const unsigned hi = (unsigned)((unsigned long long)v >> 32);
  const unsigned old = atomicAdd(w, lo);
  atomicAdd(w + 1, hi + (old + lo < old ? 1u : 0u));
}

// One row's eight corner adds into the box (its corners inside the box):
// deposit_corners' corner order, weights and product order
// (wx * wy) * wz * u, each value rounded to the block's fixed point.
template <typename T>
__device__ __forceinline__ void box_deposit(const BoxPlan& p,
                                            BoxNode* __restrict__ box,
                                            const Corners<T>& c, T u) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T wxy = c.wx[a] * c.wy[b];
      const int row =
          ((c.ix[a] - p.lo[0]) * p.dy + (c.iy[b] - p.lo[1])) * p.dz - p.lo[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        add_fixed(box + row + c.iz[k],
                  __double2ll_rn((double)(wxy * c.wz[k] * u) * p.scale));
      }
    }
  }
}

// After every thread's deposits: each non-zero node of a used box added to
// `grid` with one global atomicAdd, a warp per (x, y) row of the box, its
// lanes along z.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void box_flush(const BoxPlan& p,
                                          const BoxNode* __restrict__ box,
                                          T* __restrict__ grid, int nyp,
                                          int nzp) {
  if (!p.use) return;                       // the same in every thread
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = p.vol / p.dz;
  for (int row = warp; row < rows; row += kBoxThreads / 32) {
    const int x = row / p.dy, y = row - x * p.dy;
    T* g = grid + ((long long)(x + p.lo[0]) * nyp + (y + p.lo[1])) * nzp +
           p.lo[2];
    const BoxNode* s = box + row * p.dz;
    for (int z = lane; z < p.dz; z += 32) {
      const long long v = (long long)s[z];
      if (v != 0) atomicAdd(g + z, T((double)v * p.inv));
    }
  }
}

// The transpose of the deposit: sum over the corners of weight times the
// value of an UNPADDED (nx, ny, nz) table at the corner's node, in the
// corner order above; ghost nodes (padded index 0 or n + 1) read 0, as the
// zero-ghost padded table of the reference's XLA form gives them.
template <typename T>
__device__ __forceinline__ T sample_corners(const T* __restrict__ table,
                                            const Corners<T>& c, int nx,
                                            int ny, int nz) {
  T g = T(0);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int x = c.ix[a] - 1;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int y = c.iy[b] - 1;
      const T wxy = c.wx[a] * c.wy[b];
      const bool in_xy = x >= 0 && x < nx && y >= 0 && y < ny;
      const long long row = ((long long)x * ny + y) * nz;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int z = c.iz[k] - 1;
        if (in_xy && z >= 0 && z < nz) g += table[row + z] * (wxy * c.wz[k]);
      }
    }
  }
  return g;
}

}  // namespace cbet
