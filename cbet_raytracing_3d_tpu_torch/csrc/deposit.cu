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
// a box with one-hot matrix products on the MXU.  On one step K1 does what
// the reference does (launch_ray_XZ.cu:319-348): one thread per row, eight
// atomicAdds into L2 (deposit_row.cuh has the contract); the grid size is
// not limited, so the high-resolution case needs no separate kernel.
//
// The rows of K1 and K2 are one step (n_rays,) or one window
// (batch * n_rays,) in step-major order: row i belongs to ray i % n_rays
// and, in K2, to group (i % n_rays) / rays_per_group, whose grid starts
// group * nxp*nyp*nzp elements in (int64).  The wrapper refuses n_rays >
// groups * rays_per_group, so no group index leaves the grids.
//
// What bounds them on the card: the global atomics (8 per live row) and,
// for K2, the HBM traffic they cause.  K1's grid (4 MB f32 at 100^3) stays
// resident in the 50 MB L2, where neighbouring rays' atomics queue on the
// same nodes; K2's 60 beam grids (255 MB) do not, and a one-thread-per-row
// K2 over a step-major window fetches each beam's region of its grid again
// for every step.  So a window runs ray-major (thread r walks rows
// j * n_rays + r, j < batch; the loads stay coalesced for each j) with one
// block per 256 rays, which is one launch tile of one beam at OMEGA in every
// layout, and deposits through the shared-memory tile box of
// deposit_row.cuh: one global atomic per touched node of the block's box
// instead of eight per row.  K1's window is that kernel with one group that
// holds every ray (in float64 on its direct path by default, see
// cbet_deposit_f64).  A block whose rays fall into two groups
// (rays_per_group not a multiple of 256) or whose box exceeds the capacity
// takes the direct path, per-row global atomics.  A float step is a window
// of one step: through the box too.  There the box also keeps the float
// chunk grid's sum: with eight atomics per row, a node of a dense grid takes
// hundreds of adds a step, each rounded against a sum that has grown far
// larger, and BASELINE config 4's trace (200^3, 64M rays, a deposit per
// step) lost 1.6e-6 of its energy that way.  The direct kernels (one thread
// per row) run when the capacity is 0, and for a double step.
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
           int box_nodes, void* overflow, void* tally, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_rays <= 0 || n % n_rays != 0) return (int)cudaErrorInvalidValue;
  // the default: a float window (one step too) through the box, a double
  // step on the direct kernel and a double window on the window kernel's
  // direct path (a box of no nodes fits no block)
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
// row, over all the rows).  With the default (< 0) a float step or window
// goes through the box of the default capacity, a double step takes the
// direct kernel and a double window the window kernel's direct path: the
// box rounds each corner to 2^-51 of its block's largest, which leaves a
// node with a small sum up to 1.8e-12 (relative) from the direct adds on an
// OMEGA window, more than the exact float64 grid of the golden checks
// affords.  An `n` that is not a whole number of steps is refused.
int cbet_deposit_f32(void* edep, const void* cx, const void* cy,
                     const void* cz, const void* fx, const void* fy,
                     const void* fz, const void* inc, long long n,
                     long long n_rays, int nxp, int nyp, int nzp,
                     int box_nodes, void* overflow, void* tally,
                     void* stream) {
  return launch<float>(edep, cx, cy, cz, fx, fy, fz, inc, n, n_rays, nxp, nyp,
                       nzp, box_nodes, overflow, tally, stream);
}

int cbet_deposit_f64(void* edep, const void* cx, const void* cy,
                     const void* cz, const void* fx, const void* fy,
                     const void* fz, const void* inc, long long n,
                     long long n_rays, int nxp, int nyp, int nzp,
                     int box_nodes, void* overflow, void* tally,
                     void* stream) {
  return launch<double>(edep, cx, cy, cz, fx, fy, fz, inc, n, n_rays, nxp,
                        nyp, nzp, box_nodes, overflow, tally, stream);
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
