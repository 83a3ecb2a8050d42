// Trilinear energy deposit of ray-step rows into ghost-padded grids: K1 into
// one grid, K2 into one grid per group of rays (the per-beam CBET
// intensity fields).
//
// K1 replaces the TPU kernels cbet_raytracing_3d_tpu/ops/pallas_deposit.py::
// make_tile_deposit (ungrouped; VMEM-resident grid) and
// make_tile_deposit_hbm (the same contract with the grid in HBM, for
// nz+2 > 128).  K2 replaces make_tile_deposit's grouped form (n_groups,
// tiles_per_group: each run of tiles_per_group tiles deposits into its own
// grid).  The TPU has no atomics, so those kernels bin each tile's rows into
// a box with one-hot matrix products on the MXU.  The direct kernel does
// what the reference does (launch_ray_XZ.cu:319-348): one thread per row,
// eight atomicAdds into L2 (deposit_row.cuh has the contract).  No kernel
// here limits the grid's size, so the high-resolution case (K5) needs no
// kernel of its own: its float step is the one-step kernel's at any size.
//
// The rows of K1 and K2 are one step (n_rays,) or one window
// (batch * n_rays,) in step-major order: row i belongs to ray i % n_rays
// and, in K2, to group (i % n_rays) / rays_per_group, whose grid starts
// group * nxp*nyp*nzp elements in (int64).  The wrapper refuses n_rays >
// groups * rays_per_group, so no group index leaves the grids.
//
// What bounds them on the card: the global atomics (8 per live row) and,
// for K2, the HBM traffic they cause.  K1's grid (4 MB f32 at 100^3, 33 MB
// at config 4's 202^3) stays resident in the 50 MB L2, where neighbouring
// rays' atomics queue on the same nodes; K2's 60 beam grids (255 MB) do
// not, and a one-thread-per-row K2 over a step-major window fetches each
// beam's region of its grid again for every step.  So a window runs
// ray-major (thread r walks rows j * n_rays + r, j < batch; the loads stay
// coalesced for each j) with one block per 256 rays, one launch tile of one
// beam at OMEGA in every layout (at config 4 a 900-ray tile spans 3.5
// blocks, which straddle the tiles), and deposits through the shared-memory
// tile box of deposit_row.cuh: one global atomic per touched node of the
// block's box instead of eight per row.  K1's window is that kernel with
// one group that holds every ray (in float64 on its direct path by default,
// see cbet_deposit_f64).  A block whose rays fall into two groups
// (rays_per_group not a multiple of 256) or whose box exceeds the capacity
// takes the direct path, per-row global atomics.
//
// A float step (K5's contract: BASELINE config 4 deposits a step at a time
// into 202^3) takes the one-step kernel below, which also sums each block
// in an exact fixed-point box: with eight f32 atomics per row, a node of a
// dense grid takes hundreds of adds a step, each rounded against a sum that
// has grown far larger, and config 4's trace (64M rays) lost 1.6e-6 of its
// energy that way.  What bounds it on the card is the SM, not the bytes: a
// row's 28 bytes are read once, but its eight corners cost sixteen shared
// adds, a 64-bit conversion each and the block's four barriers, and at
// config 4's first step (50M live rows, 36 box nodes a block) the lanes
// of a warp still collide on the few nodes they share, which the copies of
// the box spread.  The direct kernels (one thread per row) run when the
// capacity is 0, and for a double step.
// Rows with inc == 0 (dead rays) cost their own inc and nothing else.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into the package's
// shared library with a plain C interface; bound with ctypes
// (cbet_raytracing_3d_tpu_torch/ops/deposit.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "deposit_row.cuh"

namespace {

constexpr int kThreads = 256;
static_assert(kThreads == cbet::kBoxThreads, "one block per box");

template <typename T>
__global__ void __launch_bounds__(kThreads)
deposit_kernel(T* __restrict__ edep, const int32_t* __restrict__ cx,
               const int32_t* __restrict__ cy, const int32_t* __restrict__ cz,
               const T* __restrict__ fx, const T* __restrict__ fy,
               const T* __restrict__ fz, const T* __restrict__ inc,
               long long n, int nxp, int nyp, int nzp,
               int* __restrict__ overflow) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T u = inc[i];
  if (u == T(0)) return;
  cbet::deposit_row(edep, cx[i], cy[i], cz[i], fx[i], fy[i], fz[i], u, nxp,
                    nyp, nzp, overflow);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
deposit_grouped_kernel(T* __restrict__ grids, const int32_t* __restrict__ cx,
                       const int32_t* __restrict__ cy,
                       const int32_t* __restrict__ cz,
                       const T* __restrict__ fx, const T* __restrict__ fy,
                       const T* __restrict__ fz, const T* __restrict__ inc,
                       long long n, long long n_rays,
                       long long rays_per_group, int nxp, int nyp, int nzp,
                       int* __restrict__ overflow) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T u = inc[i];
  if (u == T(0)) return;
  const long long group = (i % n_rays) / rays_per_group;
  T* grid = grids + group * ((long long)nxp * nyp * nzp);
  cbet::deposit_row(grid, cx[i], cy[i], cz[i], fx[i], fy[i], fz[i], u, nxp,
                    nyp, nzp, overflow);
}

// A window through the tile box (K2; K1 with rays_per_group >= n_rays, one
// group): one thread per ray over its window of `batch` step-major rows, one
// block per kBoxThreads consecutive rays.
template <typename T>
__global__ void __launch_bounds__(kThreads)
deposit_grouped_box_kernel(T* __restrict__ grids,
                           const int32_t* __restrict__ cx,
                           const int32_t* __restrict__ cy,
                           const int32_t* __restrict__ cz,
                           const T* __restrict__ fx, const T* __restrict__ fy,
                           const T* __restrict__ fz, const T* __restrict__ inc,
                           long long n_rays, long long rays_per_group,
                           int batch, int nxp, int nyp, int nzp,
                           int box_nodes, int* __restrict__ overflow,
                           int* __restrict__ tally) {
  extern __shared__ __align__(16) unsigned char box_smem[];
  cbet::BoxNode* box = reinterpret_cast<cbet::BoxNode*>(box_smem);
  const long long r0 = (long long)blockIdx.x * kThreads;
  const long long r = r0 + threadIdx.x;
  // no early return: every thread reaches the box's barriers
  const bool has = r < n_rays;
  cbet::Box<T> mine = cbet::empty_box<T>();
  for (int j = 0; has && j < batch; ++j) {
    const long long i = (long long)j * n_rays + r;
    const T u = inc[i];
    if (u == T(0)) continue;
    const cbet::Corners<T> c = cbet::row_corners(
        cx[i], cy[i], cz[i], fx[i], fy[i], fz[i], nxp, nyp, nzp);
    if (c.ok) cbet::box_add(mine, c, u);
  }
  const long long last = (r0 + kThreads < n_rays ? r0 + kThreads : n_rays) - 1;
  const bool one_group = r0 / rays_per_group == last / rays_per_group;
  const cbet::BoxPlan plan =
      cbet::plan_box(mine, batch, one_group, box_nodes, box, tally);
  T* grid = grids + ((has ? r : r0) / rays_per_group) *
                        ((long long)nxp * nyp * nzp);
  for (int j = 0; has && j < batch; ++j) {
    const long long i = (long long)j * n_rays + r;
    const T u = inc[i];
    if (u == T(0)) continue;
    const cbet::Corners<T> c = cbet::row_corners(
        cx[i], cy[i], cz[i], fx[i], fy[i], fz[i], nxp, nyp, nzp);
    if (!c.ok) {
      atomicAdd(overflow, 1);
    } else if (plan.use) {
      cbet::box_deposit(plan, box, c, u);
    } else {
      cbet::deposit_corners(grid, c, u, nyp, nzp);
    }
  }
  cbet::box_flush(plan, box, grid, nyp, nzp);
}

// ---- The one-step kernel (K5's contract at BASELINE config 4) ------------
//
// One float step, each row read once: a thread holds its row's corners in
// registers from the load to the deposit.  A block of kThreads consecutive
// rays deposits into a box of shared memory spanning its rows' corners and
// flushes each non-zero node with one global atomic, as the window kernel
// does.  What differs from that kernel (deposit_row.cuh):
// - the fixed point: a corner value is rounded once to an integer v, |v| <
//   2^kStepBits in units of the block's scale, and added as two independent
//   native 32-bit shared adds, its low kStepLoBits bits (unsigned) and the
//   rest (signed), with no carry between them.  A word takes at most
//   kThreads adds (a ray's eight corners are eight nodes), so the low word
//   stays below 2^32 and the high word's sum within 31 bits; the flush
//   recombines them exactly.  Integer sums are the same in any order.
// - copies of the box: lanes that hit one node in one shared add wait on
//   each other, and at config 4 the lanes of a warp hit few nodes (a 900-ray
//   launch tile, 30 x 30 rays of one beam, covers ~3 x 3 cells across the
//   beam: the first step's boxes hold a median of 36 nodes for 256 rays, 57
//   corner adds a node).  So a block keeps C copies of every node, lane l
//   adding to copy l % C, with C the largest power of two not above its live
//   rows per box node (at most kStepCopies, and C x nodes within
//   kStepBoxNodes): each copy costs the zeroing and the flush a pass over
//   the box, which a sparse block (the mid-trace boxes: a median of 245
//   nodes) does not earn back.  The flush sums a node's copies with
//   segmented shuffles.  Merging a warp's equal nodes (__match_any_sync)
//   instead, larger blocks and larger boxes were slower (PERF.md).
constexpr int kStepLoBits = 22;
constexpr int kStepBits = 42;
static_assert(kThreads * (1ll << kStepLoBits) <= (1ll << 32),
              "a low word's sum stays below 2^32");
static_assert(kThreads * (1ll << (kStepBits - kStepLoBits)) <= (1ll << 31),
              "a high word's sum stays within 31 bits");
// the most copies of a node, and the box's words pairs (32 KB, which leaves
// the block's occupancy to its registers)
constexpr int kStepCopies = 4;
constexpr int kStepBoxNodes = 4096;

// The block's box, scale (box units per value unit, a power of two), copies
// of a node and whether it deposits through the box; the same in every
// thread.
struct StepPlan {
  int lo[3], dy, dz, vol, copies;
  bool use;
  float scale;
  double inv;
};

// The block's plan from each thread's corner bounds, largest |corner value|
// and whether its row deposits (warp reductions, then warp 0 over the
// warps); every thread calls it.  The scale 2^(kStepBits - 1 - e), with e
// the exponent of the block's largest corner value, keeps |v| < 2^kStepBits
// and stays a normal float for the exponents it allows; a block outside
// them (a NaN or infinite value, or values below 2^-80) or whose box
// exceeds kStepBoxNodes takes the direct path.  tally as in plan_box.
__device__ __forceinline__ StepPlan plan_step(const int* lo, const int* hi,
                                              float vmax, bool live,
                                              int* __restrict__ tally) {
  __shared__ int part[kThreads / 32][8];
  __shared__ StepPlan plan;
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v[8];
  v[6] = !(vmax > 0.f) ? INT_MIN : isfinite(vmax) ? ilogbf(vmax) : INT_MAX;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[a] = __reduce_min_sync(all, lo[a]);
    v[3 + a] = __reduce_max_sync(all, hi[a]);
  }
  v[6] = __reduce_max_sync(all, v[6]);
  v[7] = __popc(__ballot_sync(all, live));
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 8; ++a) part[warp][a] = v[a];
  }
  __syncthreads();
  if (warp == 0) {
    const bool w = lane < kThreads / 32;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = __reduce_min_sync(all, w ? part[lane][a] : INT_MAX);
      v[3 + a] = __reduce_max_sync(all, w ? part[lane][3 + a] : INT_MIN);
    }
    v[6] = __reduce_max_sync(all, w ? part[lane][6] : INT_MIN);
    v[7] = __reduce_add_sync(all, w ? part[lane][7] : 0);
    if (lane == 0) {
      StepPlan p;
      const bool empty = v[0] > v[3];
      const long long vol =
          empty ? 0
                : (long long)(v[3] - v[0] + 1) * (v[4] - v[1] + 1) *
                      (v[5] - v[2] + 1);
#pragma unroll
      for (int a = 0; a < 3; ++a) p.lo[a] = v[a];
      p.dy = v[4] - v[1] + 1;
      p.dz = v[5] - v[2] + 1;
      const int e = v[6];
      p.use = !empty && e > -80 && e < 120 && vol <= kStepBoxNodes;
      p.vol = p.use ? (int)vol : 0;
      p.copies = kStepCopies;
      while (p.copies > 1 && ((long long)p.vol * p.copies > kStepBoxNodes ||
                              (long long)p.vol * p.copies > v[7])) {
        p.copies >>= 1;
      }
      p.scale = p.use ? ldexpf(1.f, kStepBits - 1 - e) : 0.f;
      p.inv = p.use ? ldexp(1.0, e + 1 - kStepBits) : 0.0;
      plan = p;
      if (tally != nullptr && !empty) {
        atomicAdd(tally, 1);
        if (p.use) atomicAdd(tally + 1, 1);
      }
    }
  }
  __syncthreads();
  return plan;
}

// One float step of `n` rows into `edep` (comment above), a block per
// kThreads rays.  The box is C x vol low words, then as many high words.
__global__ void __launch_bounds__(kThreads)
deposit_step_kernel(float* __restrict__ edep, const int32_t* __restrict__ cx,
                    const int32_t* __restrict__ cy,
                    const int32_t* __restrict__ cz,
                    const float* __restrict__ fx, const float* __restrict__ fy,
                    const float* __restrict__ fz,
                    const float* __restrict__ inc, long long n, int nxp,
                    int nyp, int nzp, int* __restrict__ overflow,
                    int* __restrict__ tally) {
  __shared__ unsigned box_words[2 * kStepBoxNodes];
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  // no early return: every thread reaches the block's barriers and the
  // warp-wide shuffles
  const float u = r < n ? inc[r] : 0.f;
  cbet::Corners<float> c = {};
  if (u != 0.f) {
    c = cbet::row_corners(cx[r], cy[r], cz[r], fx[r], fy[r], fz[r], nxp, nyp,
                          nzp);
    if (!c.ok) atomicAdd(overflow, 1);
  }
  const bool valid = u != 0.f && c.ok;
  const int lo[3] = {valid ? min(c.ix[0], c.ix[1]) : INT_MAX,
                     valid ? min(c.iy[0], c.iy[1]) : INT_MAX,
                     valid ? min(c.iz[0], c.iz[1]) : INT_MAX};
  const int hi[3] = {valid ? max(c.ix[0], c.ix[1]) : INT_MIN,
                     valid ? max(c.iy[0], c.iy[1]) : INT_MIN,
                     valid ? max(c.iz[0], c.iz[1]) : INT_MIN};
  float vmax = 0.f;
  if (valid) {
    const float m = fabsf(u) * cbet::abs_max(c.wx[0], c.wx[1]) *
                    cbet::abs_max(c.wy[0], c.wy[1]) *
                    cbet::abs_max(c.wz[0], c.wz[1]);
    // a NaN or infinite value sends the block down the direct path, which
    // carries it into the grid as it is
    vmax = isfinite(m) ? m : INFINITY;
  }
  const StepPlan p = plan_step(lo, hi, vmax, valid, tally);
  if (!p.use) {
    if (valid) cbet::deposit_corners(edep, c, u, nyp, nzp);
    return;                              // the same in every thread
  }
  const int nc = p.copies, words = p.vol * nc;
  unsigned* lo_w = box_words;
  int* hi_w = reinterpret_cast<int*>(lo_w + words);
  for (int k = threadIdx.x; k < 2 * words; k += kThreads) lo_w[k] = 0u;
  __syncthreads();
  if (valid) {
    // the box offset of each axis's two nodes
    const int ox[2] = {(c.ix[0] - p.lo[0]) * p.dy * p.dz,
                       (c.ix[1] - p.lo[0]) * p.dy * p.dz};
    const int oy[2] = {(c.iy[0] - p.lo[1]) * p.dz,
                       (c.iy[1] - p.lo[1]) * p.dz};
    const int oz[2] = {c.iz[0] - p.lo[2], c.iz[1] - p.lo[2]};
    const int copy = lane & (nc - 1);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const float wxy = c.wx[a] * c.wy[b];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const long long v = __float2ll_rn(wxy * c.wz[k] * u * p.scale);
          const int w = (ox[a] + oy[b] + oz[k]) * nc + copy;
          atomicAdd(lo_w + w, (unsigned)v & ((1u << kStepLoBits) - 1u));
          atomicAdd(hi_w + w, (int)(v >> kStepLoBits));
        }
      }
    }
  }
  __syncthreads();
  // a thread per (node, copy), the copies of a node in aligned groups of nc
  // lanes: summed by shuffles, added by the group's first lane
  const int shift = __ffs(nc) - 1, plane = p.dy * p.dz;
  const int span = (words + 31) & ~31;
  for (int k = threadIdx.x; k < span; k += kThreads) {
    long long t =
        k < words ? (long long)hi_w[k] * (1ll << kStepLoBits) + lo_w[k] : 0ll;
    for (int off = nc >> 1; off > 0; off >>= 1) {
      t += __shfl_down_sync(all, t, off, nc);
    }
    if (k < words && (k & (nc - 1)) == 0 && t != 0) {
      const int node = k >> shift;
      const int x = node / plane, y = (node - x * plane) / p.dz;
      const int z = node - x * plane - y * p.dz;
      atomicAdd(edep + ((long long)(x + p.lo[0]) * nyp + (y + p.lo[1])) *
                           nzp + (z + p.lo[2]),
                (float)((double)t * p.inv));
    }
  }
}

// Enqueues the one-step kernel on a float step of `n` rows.
int launch_step(void* edep, const void* cx, const void* cy, const void* cz,
                const void* fx, const void* fy, const void* fz,
                const void* inc, long long n, int nxp, int nyp, int nzp,
                void* overflow, void* tally, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  deposit_step_kernel<<<(unsigned int)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (float*)edep, (const int32_t*)cx, (const int32_t*)cy,
      (const int32_t*)cz, (const float*)fx, (const float*)fy,
      (const float*)fz, (const float*)inc, n, nxp, nyp, nzp, (int*)overflow,
      (int*)tally);
  return (int)cudaGetLastError();
}

// Enqueues the window kernel: `n_rays` rays x `batch` steps into `grids`.
template <typename T>
int launch_box(void* grids, const void* cx, const void* cy, const void* cz,
               const void* fx, const void* fy, const void* fz,
               const void* inc, long long n_rays, long long rays_per_group,
               long long batch, int nxp, int nyp, int nzp, int nodes,
               void* overflow, void* tally, void* stream) {
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  deposit_grouped_box_kernel<T>
      <<<(unsigned int)blocks, kThreads, (size_t)nodes * sizeof(cbet::BoxNode),
         (cudaStream_t)stream>>>(
          (T*)grids, (const int32_t*)cx, (const int32_t*)cy,
          (const int32_t*)cz, (const T*)fx, (const T*)fy, (const T*)fz,
          (const T*)inc, n_rays, rays_per_group, (int)batch, nxp, nyp, nzp,
          nodes, (int*)overflow, (int*)tally);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(void* edep, const void* cx, const void* cy, const void* cz,
           const void* fx, const void* fy, const void* fz, const void* inc,
           long long n, long long n_rays, int nxp, int nyp, int nzp,
           int box_nodes, int one_step, void* overflow, void* tally,
           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_rays <= 0 || n % n_rays != 0) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == sizeof(float)) {
    if (one_step && n == n_rays && box_nodes < 0) {
      return launch_step(edep, cx, cy, cz, fx, fy, fz, inc, n, nxp, nyp, nzp,
                         overflow, tally, stream);
    }
  }
  // the default otherwise: a float window (or a float step when not
  // one_step) through the window kernel's box, a double step on the direct
  // kernel and a double window on the window kernel's direct path (a box of
  // no nodes fits no block)
  const bool exact = box_nodes < 0 && sizeof(T) == sizeof(double);
  const int nodes = exact ? 0 : cbet::box_capacity(box_nodes);
  if (nodes < 0) return (int)cudaErrorInvalidValue;
  if (nodes == 0 && (!exact || n == n_rays)) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    deposit_kernel<T><<<(unsigned int)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (T*)edep, (const int32_t*)cx, (const int32_t*)cy, (const int32_t*)cz,
        (const T*)fx, (const T*)fy, (const T*)fz, (const T*)inc, n, nxp, nyp,
        nzp, (int*)overflow);
    return (int)cudaGetLastError();
  }
  // one group that holds every ray
  return launch_box<T>(edep, cx, cy, cz, fx, fy, fz, inc, n_rays, n_rays,
                       n / n_rays, nxp, nyp, nzp, nodes, overflow, tally,
                       stream);
}

template <typename T>
int launch_grouped(void* grids, const void* cx, const void* cy,
                   const void* cz, const void* fx, const void* fy,
                   const void* fz, const void* inc, long long n,
                   long long n_rays, long long rays_per_group, int nxp,
                   int nyp, int nzp, int box_nodes, void* overflow,
                   void* tally, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_rays <= 0 || rays_per_group <= 0 || n % n_rays != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nodes = cbet::box_capacity(box_nodes);
  if (nodes < 0) return (int)cudaErrorInvalidValue;
  if (nodes == 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    deposit_grouped_kernel<T><<<(unsigned int)blocks, kThreads, 0,
                                (cudaStream_t)stream>>>(
        (T*)grids, (const int32_t*)cx, (const int32_t*)cy,
        (const int32_t*)cz, (const T*)fx, (const T*)fy, (const T*)fz,
        (const T*)inc, n, n_rays, rays_per_group, nxp, nyp, nzp,
        (int*)overflow);
    return (int)cudaGetLastError();
  }
  return launch_box<T>(grids, cx, cy, cz, fx, fy, fz, inc, n_rays,
                       rays_per_group, n / n_rays, nxp, nyp, nzp, nodes,
                       overflow, tally, stream);
}

}  // namespace

extern "C" {

// Each entry enqueues one launch on `stream` and returns cudaGetLastError():
// nonzero means the launch was refused.  No synchronization, no allocation.
//
// K1's rows are one step of `n_rays` rays (n == n_rays) or a step-major
// window of n / n_rays steps, which takes the window kernel with a tile box
// of `box_nodes` nodes (as K2's, below; 0: the direct kernel, one thread per
// row, over all the rows).  `box_nodes` > 0 is always the window kernel's
// capacity.  With the default (< 0) a float step takes the one-step kernel
// (its box is its own) when `one_step` is nonzero, else the window kernel
// at one step; a float window goes through the box of the default
// capacity, a double step takes
// the direct kernel and a double window the window kernel's direct path:
// the box rounds each corner to 2^-51 of its block's largest, which leaves
// a node with a small sum up to 1.8e-12 (relative) from the direct adds on
// an OMEGA window, more than the exact float64 grid of the golden checks
// affords.  An `n` that is not a whole number of steps is refused.
int cbet_deposit_f32(void* edep, const void* cx, const void* cy,
                     const void* cz, const void* fx, const void* fy,
                     const void* fz, const void* inc, long long n,
                     long long n_rays, int nxp, int nyp, int nzp,
                     int box_nodes, int one_step, void* overflow, void* tally,
                     void* stream) {
  return launch<float>(edep, cx, cy, cz, fx, fy, fz, inc, n, n_rays, nxp, nyp,
                       nzp, box_nodes, one_step, overflow, tally, stream);
}

int cbet_deposit_f64(void* edep, const void* cx, const void* cy,
                     const void* cz, const void* fx, const void* fy,
                     const void* fz, const void* inc, long long n,
                     long long n_rays, int nxp, int nyp, int nzp,
                     int box_nodes, int one_step, void* overflow, void* tally,
                     void* stream) {
  return launch<double>(edep, cx, cy, cz, fx, fy, fz, inc, n, n_rays, nxp,
                        nyp, nzp, box_nodes, one_step, overflow, tally,
                        stream);
}

// K2's `box_nodes` is the tile box's capacity in nodes: < 0 the kernel's
// default (cbet_box_default_nodes), 0 the direct kernel (one thread per
// row); more than 48 KB of nodes is refused, and so is an `n` that is not a
// whole number of steps of `n_rays`.  `tally` (null, or two ints: blocks with
// rows, blocks that took the box) counts the box's use.
int cbet_deposit_grouped_f32(void* grids, const void* cx, const void* cy,
                             const void* cz, const void* fx, const void* fy,
                             const void* fz, const void* inc, long long n,
                             long long n_rays, long long rays_per_group,
                             int nxp, int nyp, int nzp, int box_nodes,
                             void* overflow, void* tally, void* stream) {
  return launch_grouped<float>(grids, cx, cy, cz, fx, fy, fz, inc, n, n_rays,
                               rays_per_group, nxp, nyp, nzp, box_nodes,
                               overflow, tally, stream);
}

int cbet_deposit_grouped_f64(void* grids, const void* cx, const void* cy,
                             const void* cz, const void* fx, const void* fy,
                             const void* fz, const void* inc, long long n,
                             long long n_rays, long long rays_per_group,
                             int nxp, int nyp, int nzp, int box_nodes,
                             void* overflow, void* tally, void* stream) {
  return launch_grouped<double>(grids, cx, cy, cz, fx, fy, fz, inc, n,
                                n_rays, rays_per_group, nxp, nyp, nzp,
                                box_nodes, overflow, tally, stream);
}

// The tile box's default capacity in nodes (K1's and K2's windows, K4
// "cell"/"tri").
int cbet_box_default_nodes(void) { return cbet::kBoxNodes; }

const char* cbet_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
