// The trilinear deposit of one row: the device code K1 (deposit.cu), K2
// (the grouped deposit, deposit.cu) and K4 (the window-gain deposit,
// gain_deposit.cu) share.
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
#include <stdint.h>

namespace cbet {

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

// Eight atomicAdds of one row into `edep` (one (nxp, nyp, nzp) grid); the
// caller has already skipped rows with u == 0.
template <typename T>
__device__ __forceinline__ void deposit_row(T* __restrict__ edep, int cx,
                                            int cy, int cz, T fx, T fy, T fz,
                                            T u, int nxp, int nyp, int nzp,
                                            int* __restrict__ overflow) {
  int ix[2], iy[2], iz[2];
  T wx[2], wy[2], wz[2];
  bool okx, oky, okz;
  axis_weights(fx, cx, nxp, &ix[0], &ix[1], &wx[0], &wx[1], &okx);
  axis_weights(fy, cy, nyp, &iy[0], &iy[1], &wy[0], &wy[1], &oky);
  axis_weights(fz, cz, nzp, &iz[0], &iz[1], &wz[0], &wz[1], &okz);
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

}  // namespace cbet
