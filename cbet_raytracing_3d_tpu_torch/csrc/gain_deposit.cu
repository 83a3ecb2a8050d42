// CBET window-gain deposit: a gain model applied over a window of `batch`
// steps, with the exact termination rule and the edep deposit of the gained
// increments.
//
// Replaces the TPU kernel cbet_raytracing_3d_tpu/ops/pallas_deposit.py::
// _make_tile_deposit_gain (the gain branch of _tile_ebox) in its three
// uses:
//   "cell" (cbet_gain_mode="kernel_cell"): the gain at each step's ENTRY
//          cell, the per-step lookup's exact sampling;
//   "tri"  (cbet_gain_mode="kernel"): the gain sampled trilinearly at each
//          step's DEPOSIT position, with the deposit's own eight corners and
//          weights (deposit_row.cuh), ghost nodes reading 0;
//   gain_only (light CBET iterations, either mode): gamma and uout only,
//          edep untouched; deposit-corner overflow is still counted.
// The TPU kernel samples the gain table by matrix products against a VMEM
// window of the beam's table (one-hot rows in "cell" mode with a bf16 hi/lo
// split, the deposit's hat matrices in "tri" mode) and deposits through the
// tile box.  Here one thread owns one ray for the whole window, reads its
// gain with direct loads from the unpadded (B, nx*ny*nz) table (no padded
// copy of it is made) and carries the cumulative product in a register.
// With the edep deposit ("cell", "tri"), a block of 256 consecutive rays (an
// OMEGA launch tile) deposits through the shared-memory tile box of
// deposit_row.cuh: one global atomic per touched node instead of eight per
// row.  The box comes from a first read of the corners of every row with
// inc != 0 (a superset of the rows that deposit, which are known only after
// the gain); then the ray's ordinary loop deposits into it.  All rays
// deposit into the one edep grid, so a block that spans two beams
// (rays_per_group not a multiple of 256) keeps the box; only the capacity
// sends a block to the direct path (per-row atomics).  The direct kernel
// (each row's eight atomics as it goes) runs when the capacity is 0, and for
// gain_only, which deposits nothing.
//
// Contract.  Streams are step-major (batch, n_rays): row j*n_rays + r is
// ray r's step j.  Ray r belongs to beam r / rays_per_group.  For each step
// j of the window:
//   g      = gain[beam, (lcx*ny + lcy)*nz + lcz]           ("cell"), or
//            sum_c w_c * gain[beam, node_c]                 ("tri")
//   gcum  *= exp(clamp(g * ds_j, -clip, clip))
//   u_true = u_nogain_j * gcum
//   died   = u_true <= stop * uinit[r]
//   the edep deposit of inc_j * gcum runs up to and including the first
//   death step (medep); gamma[j, r] = gcum while no death has happened up to
//   and including step j (mint), else 0.
// uout[r] is u_true at the first death step, else at the window's end (the
// frozen true energy).  In "cell" mode a live row (ds != 0) whose entry cell
// lies outside the grid reads gain 0 and is counted in *overflow; in "tri"
// mode a row whose corners leave the padded grid reads gain 0 (the trace
// keeps cells clamped, so neither happens there).  A row whose deposit has a
// corner outside the grid is counted in *overflow, with or without
// gain_only.  This is models/cbet.py:846-916 (the XLA window form) row by
// row.
//
// What bounds it on the card: the edep atomics (8 per live step in the
// direct form, ~0.18 ms of its 0.29 ms at OMEGA: gain_only, the same loads
// without them, takes 0.11 ms) and the gain loads from a 240 MB (f32) table
// whose rows neighbouring rays share: one per step in "cell" mode, eight in
// "tri" mode (mostly L2 hits, the corners of neighbouring rays overlap).
// The box turns the atomics into shared-memory ones and one flush per
// block.  The per-ray arithmetic is a few operations and one exp per step.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into the package's
// shared library with a plain C interface; bound with ctypes
// (cbet_raytracing_3d_tpu_torch/ops/gain_deposit.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "deposit_row.cuh"

namespace {

constexpr int kThreads = 256;
static_assert(kThreads == cbet::kBoxThreads, "one block per box");

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

template <typename T, bool kTri, bool kGainOnly, bool kBoxed>
__global__ void __launch_bounds__(kThreads)
gain_window_kernel(T* __restrict__ edep, const int32_t* __restrict__ cx,
                   const int32_t* __restrict__ cy,
                   const int32_t* __restrict__ cz, const T* __restrict__ fx,
                   const T* __restrict__ fy, const T* __restrict__ fz,
                   const T* __restrict__ inc, const T* __restrict__ ds,
                   const T* __restrict__ u_nogain,
                   const T* __restrict__ uinit,
                   const int32_t* __restrict__ lcx,
                   const int32_t* __restrict__ lcy,
                   const int32_t* __restrict__ lcz,
                   const T* __restrict__ gain, long long n_rays,
                   long long rays_per_group, int batch, int nx, int ny,
                   int nz, T clip, T stop, int box_nodes,
                   int* __restrict__ overflow, T* __restrict__ gamma,
                   T* __restrict__ uout, int* __restrict__ tally) {
  static_assert(!(kBoxed && kGainOnly), "gain_only deposits nothing");
  extern __shared__ __align__(16) unsigned char box_smem[];
  cbet::BoxNode* box = reinterpret_cast<cbet::BoxNode*>(box_smem);
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool has = r < n_rays;
  const int nxp = nx + 2, nyp = ny + 2, nzp = nz + 2;
  if (!kBoxed && !has) return;    // the boxed form has barriers: no return
  const T* g_row =
      gain + (has ? r / rays_per_group : 0) * ((long long)nx * ny * nz);
  const T thr = has ? stop * uinit[r] : T(0);
  T gcum = T(1), u_true = T(0), uo = T(0);
  bool any_prev = false;  // a death at an earlier step of the window

  // Step j of the window: the gain factor, the termination rule and
  // gamma[j, r]; returns the row's deposit value inc * gcum (0 when it
  // deposits nothing, or when its corners leave the grid, which is counted)
  // with its corners in c.
  auto step = [&](int j, cbet::Corners<T>& c) -> T {
    const long long row = (long long)j * n_rays + r;
    const T dsj = ds[row];
    // the deposit corners: read up front in "tri" mode (they are the
    // sampling corners), only for a row that deposits in "cell" mode
    T g = T(0);
    if (kTri) {
      c = cbet::row_corners(cx[row], cy[row], cz[row], fx[row], fy[row],
                            fz[row], nxp, nyp, nzp);
      if (c.ok) g = cbet::sample_corners(g_row, c, nx, ny, nz);
    } else {
      const int x = lcx[row], y = lcy[row], z = lcz[row];
      if (x >= 0 && x < nx && y >= 0 && y < ny && z >= 0 && z < nz) {
        g = g_row[((long long)x * ny + y) * nz + z];
      } else if (dsj != T(0)) {
        atomicAdd(overflow, 1);
      }
    }
    T a = g * dsj;
    a = a < -clip ? -clip : (a > clip ? clip : a);
    gcum *= exp_t(a);
    u_true = u_nogain[row] * gcum;
    const bool died = u_true <= thr;
    if (died && !any_prev) uo = u_true;
    const bool any_now = any_prev || died;
    gamma[row] = any_now ? T(0) : gcum;
    T v = T(0);
    if (!any_prev) {
      v = inc[row] * gcum;
      if (v != T(0)) {
        if (!kTri) {
          c = cbet::row_corners(cx[row], cy[row], cz[row], fx[row], fy[row],
                                fz[row], nxp, nyp, nzp);
        }
        if (!c.ok) {
          atomicAdd(overflow, 1);
          v = T(0);
        }
      }
    }
    any_prev = any_now;
    return v;
  };

  cbet::BoxPlan plan{};
  if constexpr (kBoxed) {
    // the block's box, from every row with inc != 0; a deposit value
    // inc * gcum is at most inc * exp(clip * batch)
    const T gmax = exp_t(clip * T(batch));
    cbet::Box<T> mine = cbet::empty_box<T>();
    for (int j = 0; has && j < batch; ++j) {
      const long long row = (long long)j * n_rays + r;
      const T u = inc[row];
      if (u == T(0)) continue;
      const cbet::Corners<T> c =
          cbet::row_corners(cx[row], cy[row], cz[row], fx[row], fy[row],
                            fz[row], nxp, nyp, nzp);
      if (c.ok) cbet::box_add(mine, c, u * gmax);
    }
    plan = cbet::plan_box(mine, batch, true, box_nodes, box, tally);
  }
  for (int j = 0; has && j < batch; ++j) {
    cbet::Corners<T> c;
    const T v = step(j, c);
    if (kGainOnly || v == T(0)) continue;
    if (kBoxed && plan.use) {
      cbet::box_deposit(plan, box, c, v);
    } else {
      cbet::deposit_corners(edep, c, v, nyp, nzp);
    }
  }
  if (has) uout[r] = any_prev ? uo : u_true;
  if constexpr (kBoxed) cbet::box_flush(plan, box, edep, nyp, nzp);
}

template <typename T, bool kTri, bool kGainOnly, bool kBoxed>
void enqueue(long long blocks, int nodes, cudaStream_t stream, T* edep,
             const int32_t* cx, const int32_t* cy, const int32_t* cz,
             const T* fx, const T* fy, const T* fz, const T* inc, const T* ds,
             const T* u_nogain, const T* uinit, const int32_t* lcx,
             const int32_t* lcy, const int32_t* lcz, const T* gain,
             long long n_rays, long long rays_per_group, int batch, int nx,
             int ny, int nz, T clip, T stop, int* overflow, T* gamma,
             T* uout, int* tally) {
  gain_window_kernel<T, kTri, kGainOnly, kBoxed>
      <<<(unsigned int)blocks, kThreads,
         kBoxed ? (size_t)nodes * sizeof(cbet::BoxNode) : 0, stream>>>(
          edep, cx, cy, cz, fx, fy, fz, inc, ds, u_nogain, uinit, lcx, lcy,
          lcz, gain, n_rays, rays_per_group, batch, nx, ny, nz, clip, stop,
          nodes, overflow, gamma, uout, tally);
}

template <typename T>
int launch(void* edep, const void* cx, const void* cy, const void* cz,
           const void* fx, const void* fy, const void* fz, const void* inc,
           const void* ds, const void* u_nogain, const void* uinit,
           const void* lcx, const void* lcy, const void* lcz,
           const void* gain, long long n_rays, long long rays_per_group,
           int batch, int nx, int ny, int nz, double clip, double stop,
           int tri, int gain_only, int box_nodes, void* overflow,
           void* gamma, void* uout, void* tally, void* stream) {
  if (n_rays <= 0 || batch <= 0) return (int)cudaSuccess;
  if (rays_per_group <= 0) return (int)cudaErrorInvalidValue;
  if (!tri && (lcx == nullptr || lcy == nullptr || lcz == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nodes = cbet::box_capacity(box_nodes);
  if (nodes < 0) return (int)cudaErrorInvalidValue;
  const bool boxed = !gain_only && nodes > 0;
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  decltype(&enqueue<T, true, true, false>) kernel =
      gain_only ? (tri ? &enqueue<T, true, true, false>
                       : &enqueue<T, false, true, false>)
      : boxed   ? (tri ? &enqueue<T, true, false, true>
                       : &enqueue<T, false, false, true>)
                : (tri ? &enqueue<T, true, false, false>
                       : &enqueue<T, false, false, false>);
  kernel(blocks, nodes, (cudaStream_t)stream, (T*)edep, (const int32_t*)cx,
         (const int32_t*)cy, (const int32_t*)cz, (const T*)fx, (const T*)fy,
         (const T*)fz, (const T*)inc, (const T*)ds, (const T*)u_nogain,
         (const T*)uinit, (const int32_t*)lcx, (const int32_t*)lcy,
         (const int32_t*)lcz, (const T*)gain, n_rays, rays_per_group, batch,
         nx, ny, nz, (T)clip, (T)stop, (int*)overflow, (T*)gamma, (T*)uout,
         (int*)tally);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry enqueues one launch on `stream` and returns cudaGetLastError():
// nonzero means the launch was refused.  No synchronization, no allocation.
// `clip` and `stop` arrive as doubles and are rounded to T once.  `tri`
// selects the "tri" sampling (the lag-cell pointers may then be null),
// `gain_only` leaves edep untouched.  `box_nodes` is the tile box's
// capacity in nodes: < 0 the default (cbet_box_default_nodes in
// deposit.cu), 0 the direct kernel; more than 48 KB of nodes is refused.
// `tally` (null, or two ints: blocks with rows, blocks that took the box)
// counts the box's use.
int cbet_gain_window_f32(void* edep, const void* cx, const void* cy,
                         const void* cz, const void* fx, const void* fy,
                         const void* fz, const void* inc, const void* ds,
                         const void* u_nogain, const void* uinit,
                         const void* lcx, const void* lcy, const void* lcz,
                         const void* gain, long long n_rays,
                         long long rays_per_group, int batch, int nx, int ny,
                         int nz, double clip, double stop, int tri,
                         int gain_only, int box_nodes, void* overflow,
                         void* gamma, void* uout, void* tally, void* stream) {
  return launch<float>(edep, cx, cy, cz, fx, fy, fz, inc, ds, u_nogain,
                       uinit, lcx, lcy, lcz, gain, n_rays, rays_per_group,
                       batch, nx, ny, nz, clip, stop, tri, gain_only,
                       box_nodes, overflow, gamma, uout, tally, stream);
}

int cbet_gain_window_f64(void* edep, const void* cx, const void* cy,
                         const void* cz, const void* fx, const void* fy,
                         const void* fz, const void* inc, const void* ds,
                         const void* u_nogain, const void* uinit,
                         const void* lcx, const void* lcy, const void* lcz,
                         const void* gain, long long n_rays,
                         long long rays_per_group, int batch, int nx, int ny,
                         int nz, double clip, double stop, int tri,
                         int gain_only, int box_nodes, void* overflow,
                         void* gamma, void* uout, void* tally, void* stream) {
  return launch<double>(edep, cx, cy, cz, fx, fy, fz, inc, ds, u_nogain,
                        uinit, lcx, lcy, lcz, gain, n_rays, rays_per_group,
                        batch, nx, ny, nz, clip, stop, tri, gain_only,
                        box_nodes, overflow, gamma, uout, tally, stream);
}

}  // extern "C"
