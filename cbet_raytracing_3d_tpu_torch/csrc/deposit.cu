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
// a box with one-hot matrix products on the MXU; Hopper has fast atomics in
// L2, so these kernels do what the reference does (launch_ray_XZ.cu:
// 319-348): one thread per row, eight atomicAdds (deposit_row.cuh has the
// contract).  There is no tile box, so the grid size is not limited and the
// high-resolution case needs no separate kernel.
//
// K2's rows are one step (n_rays,) or one window (batch * n_rays,) in
// step-major order: row i belongs to ray i % n_rays and to group
// (i % n_rays) / rays_per_group, whose grid starts group * nxp*nyp*nzp
// elements in (int64).  The wrapper refuses n_rays > groups *
// rays_per_group, so no group index leaves the grids.
//
// What bounds them on the card: atomic throughput in L2 and the L2 traffic
// of the grid (8 atomics per row).  K1's grid (4 MB f32 at 100^3) stays
// resident in the 50 MB L2; K2's 60 beam grids (255 MB) do not, but the rows
// of one group sit together in the flat axis (beam-contiguous, launch-tile
// order), so at any time the card works on a few beams' grids.  Rows with
// inc == 0 (dead rays) return before any memory traffic beyond their own
// inc.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into the package's
// shared library with a plain C interface; bound with ctypes
// (cbet_raytracing_3d_tpu_torch/ops/deposit.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "deposit_row.cuh"

namespace {

constexpr int kThreads = 256;

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

template <typename T>
int launch(void* edep, const void* cx, const void* cy, const void* cz,
           const void* fx, const void* fy, const void* fz, const void* inc,
           long long n, int nxp, int nyp, int nzp, void* overflow,
           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  deposit_kernel<T><<<(unsigned int)blocks, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (T*)edep, (const int32_t*)cx, (const int32_t*)cy, (const int32_t*)cz,
      (const T*)fx, (const T*)fy, (const T*)fz, (const T*)inc, n, nxp, nyp,
      nzp, (int*)overflow);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grouped(void* grids, const void* cx, const void* cy,
                   const void* cz, const void* fx, const void* fy,
                   const void* fz, const void* inc, long long n,
                   long long n_rays, long long rays_per_group, int nxp,
                   int nyp, int nzp, void* overflow, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_rays <= 0 || rays_per_group <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  deposit_grouped_kernel<T><<<(unsigned int)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (T*)grids, (const int32_t*)cx, (const int32_t*)cy, (const int32_t*)cz,
      (const T*)fx, (const T*)fy, (const T*)fz, (const T*)inc, n, n_rays,
      rays_per_group, nxp, nyp, nzp, (int*)overflow);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry enqueues one launch on `stream` and returns cudaGetLastError():
// nonzero means the launch was refused.  No synchronization, no allocation.
int cbet_deposit_f32(void* edep, const void* cx, const void* cy,
                     const void* cz, const void* fx, const void* fy,
                     const void* fz, const void* inc, long long n, int nxp,
                     int nyp, int nzp, void* overflow, void* stream) {
  return launch<float>(edep, cx, cy, cz, fx, fy, fz, inc, n, nxp, nyp, nzp,
                       overflow, stream);
}

int cbet_deposit_f64(void* edep, const void* cx, const void* cy,
                     const void* cz, const void* fx, const void* fy,
                     const void* fz, const void* inc, long long n, int nxp,
                     int nyp, int nzp, void* overflow, void* stream) {
  return launch<double>(edep, cx, cy, cz, fx, fy, fz, inc, n, nxp, nyp, nzp,
                        overflow, stream);
}

int cbet_deposit_grouped_f32(void* grids, const void* cx, const void* cy,
                             const void* cz, const void* fx, const void* fy,
                             const void* fz, const void* inc, long long n,
                             long long n_rays, long long rays_per_group,
                             int nxp, int nyp, int nzp, void* overflow,
                             void* stream) {
  return launch_grouped<float>(grids, cx, cy, cz, fx, fy, fz, inc, n, n_rays,
                               rays_per_group, nxp, nyp, nzp, overflow,
                               stream);
}

int cbet_deposit_grouped_f64(void* grids, const void* cx, const void* cy,
                             const void* cz, const void* fx, const void* fy,
                             const void* fz, const void* inc, long long n,
                             long long n_rays, long long rays_per_group,
                             int nxp, int nyp, int nzp, void* overflow,
                             void* stream) {
  return launch_grouped<double>(grids, cx, cy, cz, fx, fy, fz, inc, n,
                                n_rays, rays_per_group, nxp, nyp, nzp,
                                overflow, stream);
}

const char* cbet_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
