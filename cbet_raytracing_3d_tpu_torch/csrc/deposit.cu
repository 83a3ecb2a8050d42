// Trilinear energy deposit of ray-step rows into the ghost-padded grid.
//
// Replaces the TPU kernels cbet_raytracing_3d_tpu/ops/pallas_deposit.py::
// make_tile_deposit (ungrouped; VMEM-resident grid) and
// make_tile_deposit_hbm (the same contract with the grid in HBM, for
// nz+2 > 128).  The TPU has no atomics, so those kernels bin each tile's
// rows into a box with one-hot matrix products on the MXU; Hopper has fast
// atomics in L2, so this kernel does what the reference does
// (launch_ray_XZ.cu:319-348): one thread per row, eight atomicAdds.
//
// Contract, per row i with inc[i] != 0:
//   per axis a:  p = frac_a - 0.5,  d = 1 - |p|,  s = (p < 0 ? -1 : 1)
//                node cell_a + 1 gets weight 1 - d, node cell_a + 1 + s
//                gets weight d
//   edep[x, y, z] += wx * wy * wz * inc   over the 2x2x2 corners.
// On a boundary exit row |p| > 0.5, so d < 0: the reference's negative
// extrapolated weight is kept exactly.  A row with a corner outside the
// (nxp, nyp, nzp) grid is not written and is counted in *overflow (0 when
// the cells are clamped to [0, n-1], as the trace keeps them).  There is no
// tile box, so the grid size is not limited and the high-resolution case
// needs no separate kernel.
//
// What bounds it on the card: atomic throughput in L2 and the L2 traffic of
// the grid (8 atomics per row, 4 MB f32 grid at 100^3 that stays resident in
// the 50 MB L2).  The rows arrive in launch-tile order (rays of one tile are
// neighbours in the flat axis and stay spatially close), so the threads of
// a warp mostly hit nearby nodes.  Rows with inc == 0 (dead rays) return
// before any memory traffic beyond their own inc.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface; bound with ctypes
// (cbet_raytracing_3d_tpu_torch/ops/deposit.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void axis_weights(T frac, int cell, int np_,
                                             int* i0, int* i1, T* w0, T* w1,
                                             bool* ok) {
  const T p = frac - T(0.5);
  const T d = T(1) - (p < T(0) ? -p : p);
  const int s = p < T(0) ? -1 : 1;
  *i0 = cell + 1;
  *i1 = cell + 1 + s;
  *w0 = T(1) - d;
  *w1 = d;
  *ok = *i0 >= 0 && *i0 < np_ && *i1 >= 0 && *i1 < np_;
}

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

  int ix[2], iy[2], iz[2];
  T wx[2], wy[2], wz[2];
  bool okx, oky, okz;
  axis_weights(fx[i], cx[i], nxp, &ix[0], &ix[1], &wx[0], &wx[1], &okx);
  axis_weights(fy[i], cy[i], nyp, &iy[0], &iy[1], &wy[0], &wy[1], &oky);
  axis_weights(fz[i], cz[i], nzp, &iz[0], &iz[1], &wz[0], &wz[1], &okz);
  if (!(okx && oky && okz)) {
    atomicAdd(overflow, 1);
    return;
  }
  // the product order (wx * wy) * wz * u matches the plain version
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T wxy = wx[a] * wy[b];
      const long long row = ((long long)ix[a] * nyp + iy[b]) * nzp;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        atomicAdd(edep + row + iz[c], wxy * wz[c] * u);
      }
    }
  }
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

const char* cbet_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
