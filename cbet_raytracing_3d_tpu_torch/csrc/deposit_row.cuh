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
