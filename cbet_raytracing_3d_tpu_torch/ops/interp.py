"""Vectorized piecewise-linear interpolation on the host.

Counterpart of the NumPy path of ``cbet_raytracing_3d_tpu/ops/interp.py``
(``interp`` and ``uniform_interp``): the float64 host precompute of node
fields and launch energies.  Semantics match the reference device routine
(``launch_ray_XZ.cu:16-63``): segment lookup over an increasing *or*
decreasing abscissa with clamping at both ends, then linear interpolation.
"""

from __future__ import annotations

import numpy as np


def interp(y, x, xp):
    """Piecewise-linear interpolation of table ``(x, y)`` at points ``xp``.

    Handles increasing or decreasing ``x`` (launch_ray_XZ.cu:20,41) and clamps
    to the end values outside the table range (launch_ray_XZ.cu:22-25,43-46).
    """
    x = np.asarray(x)
    y = np.asarray(y)
    increasing = x[0] <= x[-1]
    xs = np.where(increasing, x, x[::-1])
    ys = np.where(increasing, y, y[::-1])
    return np.interp(np.asarray(xp), xs, ys)


def uniform_interp(y, x0, dx_table, xp):
    """Interpolate a table sampled uniformly at ``x0 + i*dx_table``.

    No search: the segment index is direct arithmetic.  Clamps at both ends.
    """
    y = np.asarray(y)
    n = y.shape[0]
    t = (np.asarray(xp) - x0) / dx_table
    i = np.clip(np.floor(t).astype(np.int64), 0, n - 2)
    frac = np.clip(t - i, 0.0, None)
    frac = np.where(t >= n - 1, 1.0, np.where(t <= 0, 0.0, frac))
    return y[i] + (y[i + 1] - y[i]) * frac
