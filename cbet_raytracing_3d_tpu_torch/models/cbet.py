"""Cross-beam energy transfer (CBET): the fixed-point solve in PyTorch.

Counterpart of ``cbet_raytracing_3d_tpu/models/cbet.py`` (its docstring has
the model) on one device, unsegmented: trace -> per-beam intensity fields
-> gain fields -> retrace, with under-relaxation, until the relative field
change drops below ``cbet_tol``.

* The host part (``pair_couplings``, ``gain_prefactor_field``,
  ``_node_rhat``, ``_interp_matrix``, ``live_tile_slots``) is float64 NumPy,
  bit-identical to the JAX functions.
* The gain reduction is ``ops/gain.py`` (kernel K3), the edep deposit
  ``ops/deposit.deposit`` (K1), the per-beam intensity deposit
  ``ops/deposit.deposit_grouped`` (K2), and in the kernel gain modes the
  window-gain deposit ``ops/gain_deposit.py`` (K4, "cell" or "tri", with
  its gain-only form in light iterations).  The step physics, the gain
  lookup and the upsampling of a coarse gain grid are plain torch, as they
  are XLA in the JAX package.
* "lookup" multiplies each step's energy by ``exp(clip(g * ds))`` with
  ``g`` looked up at the step's entry cell (or once per deposit window at
  the window-entry cell: ``cbet_gain_stride``); "kernel_cell" advances a
  window of ``deposit_batch_steps`` steps without gain and applies the same
  factors afterwards (cumulative product, exact termination), equal to the
  lookup to rounding; "kernel" does the same with the gain sampled
  trilinearly at each step's deposit position (another model).
* Where ``deposit_batch_steps`` divides the chunk lengths, the lookup mode
  advances a whole window before one K1 and one K2 call on its step-major
  rows, as the JAX Pallas path does; otherwise it deposits every step.
* Opt-ins: light iterations (the fixed-point iterations skip the edep
  deposit; one full trace with the last gain makes edep) and Anderson(m=1)
  mixing of the intensity iterates.

* ``cbet_segmented``: each trace drops dead tiles at chunk boundaries,
  per beam, to a uniform width (``models/tileplan.py``); the values do not
  change.  ``cbet_plan_headroom`` is accepted and reported as the JAX
  package does, and changes nothing: the compaction reads the trace's own
  ``alive`` mask, exact under any gain, so there is no plan whose liveness
  a headroom could relax and no retry.

* A trace can run a block of the beams (``n_beams`` of
  :func:`make_cbet_trace_fn`): their rows of the beam-contiguous state,
  their gain rows, their intensity grids -- the same code with fewer groups
  (``models/cbet_composed.py`` traces the beams in serial groups).

Not here (ROADMAP): the mesh solve (M11).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from .. import constants as k
from ..config import Config
from ..ops import deposit as dep_ops
from ..ops import gain as gain_ops
from ..ops import gain_deposit as gd_ops
from ..ops.gain import resonance  # noqa: F401  (models/cbet.py:119)
from ..parallel.sharding import pad_rays
from . import raytracer as rt
from .tileplan import DroppedAliveRaysError, TileCompactor  # noqa: F401

# Stability clamp on the per-step gain exponent (models/cbet.py:64): THE one
# value for the lookup step and the window-gain deposit, which must stay
# identical or the two modes compute different models.
GAIN_CLIP = 0.1

GAIN_MODES = ("lookup", "kernel", "kernel_cell")
ACCELS = ("none", "anderson")


@dataclasses.dataclass
class CbetResult:
    """``models/cbet.py:80``."""

    edep: np.ndarray          # ghost-padded deposition with CBET-coupled rays
                              # (always full-resolution)
    intensity: np.ndarray     # (nbeams, *cfg.cbet_grid_shape) final node
                              # intensity fields
    iterations: int
    converged: bool
    history: list             # per-iteration relative field change
    stats: dict[str, Any]


def pair_couplings(beam_norm: np.ndarray, machnum: float) -> np.ndarray:
    """Per-beam-pair unit difference vectors scaled for eta
    (``models/cbet.py:92``): ``eta[b,b',cell] = pair_u[b,b'] . r_hat(cell)``;
    zero on the diagonal."""
    khat = -beam_norm / np.linalg.norm(beam_norm, axis=1, keepdims=True)
    dk = khat[None, :, :] - khat[:, None, :]           # (B, B, 3)
    norm = np.linalg.norm(dk, axis=-1, keepdims=True)
    unit = np.where(norm > 1e-12, dk / np.where(norm == 0, 1, norm), 0.0)
    return -machnum * unit                             # (B, B, 3)


# intensity (W/cm^2) -> squared-field CGS units entering constant1
# (models/cbet.py:106)
I_TO_FIELD_SQ = 8.0 * np.pi * 1.0e7 / k.C_CMS


def gain_prefactor_field(cfg: Config, fields) -> np.ndarray:
    """A(cell) = constant1 * (ne/ncrit)/sqrt(1-ne/ncrit) * (8pi 1e7/c), with
    ne/ncrit capped at 0.95 (``models/cbet.py:109``)."""
    frac = np.clip(fields.eden / k.NCRIT, 0.0, 0.95)
    return k.CONSTANT1 * I_TO_FIELD_SQ * frac / np.sqrt(1.0 - frac)


def _node_rhat(cfg: Config, s: int = 1) -> np.ndarray:
    """Unit radial vectors at the CBET-grid nodes (full-grid indices
    0, s, 2s, ...; ``models/cbet.py:261``)."""
    x = np.arange(0, cfg.nx, s) * cfg.dx + cfg.xmin
    y = np.arange(0, cfg.ny, s) * cfg.dy + cfg.ymin
    z = np.arange(0, cfg.nz, s) * cfg.dz + cfg.zmin
    gx, gy, gz = np.meshgrid(x, y, z, indexing="ij")
    r = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)
    r = np.where(r > 1e-12, r, 1.0)
    return np.stack([(gx / r).reshape(-1), (gy / r).reshape(-1),
                     (gz / r).reshape(-1)])


def _interp_matrix(n_full: int, nh: int, s: int) -> np.ndarray:
    """(n_full, nh) linear-interpolation matrix from coarse nodes, clamped
    at the upper edge (``models/cbet.py:274``)."""
    t = np.arange(n_full) / s
    lo = np.minimum(np.floor(t).astype(int), nh - 1)
    hi = np.minimum(lo + 1, nh - 1)
    w = t - lo
    m = np.zeros((n_full, nh), np.float32)
    m[np.arange(n_full), lo] += 1.0 - w
    m[np.arange(n_full), hi] += w
    return m


def make_gain_fn(cfg: Config, ctx: rt.TraceContext, device="cpu",
                 gain_op: Callable | None = None):
    """``I (B, Ph) f32 -> G (B, Ph) f32`` on the (possibly coarsened) CBET
    node grid (``models/cbet.py:124``).  ``rhat_pre`` (4, Ph) and
    ``pair_u`` (B, B, 3) are built and uploaded once; ``gain_op`` (default
    ``ops/gain.gain``: the kernel for CUDA tensors) does the reduction."""
    s = cfg.cbet_grid_downsample
    rhat = _node_rhat(cfg, s)
    pre = gain_prefactor_field(cfg, ctx.fields)[::s, ::s, ::s].reshape(-1)
    rp = np.concatenate([rhat, pre[None, :]], axis=0).astype(np.float32)
    pu = pair_couplings(ctx.beam_norm, cfg.machnum).astype(np.float32)
    rp_t = torch.from_numpy(rp).to(device)
    pu_t = torch.from_numpy(pu).to(device)
    op = gain_op or gain_ops.gain

    def gain(intensity):
        return op(pu_t, rp_t, intensity)

    return gain


def make_gain_upsampler(cfg: Config, device="cpu"):
    """Trilinear upsample of a coarse (B, Ph) gain field to the full (B, P)
    node grid (``models/cbet.py:288``): three separable interpolation
    products."""
    s = cfg.cbet_grid_downsample
    hx, hy, hz = cfg.cbet_grid_shape
    wx, wy, wz = (torch.from_numpy(_interp_matrix(n, h, s)).to(device)
                  for n, h in ((cfg.nx, hx), (cfg.ny, hy), (cfg.nz, hz)))

    def upsample(gain_h):
        g = gain_h.reshape(-1, hx, hy, hz)
        g = torch.einsum("bxyz,Zz->bxyZ", g, wz)
        g = torch.einsum("bxyZ,Yy->bxYZ", g, wy)
        g = torch.einsum("bxYZ,Xx->bXYZ", g, wx)
        return g.reshape(g.shape[0], cfg.nx * cfg.ny * cfg.nz)

    return upsample


def live_tile_slots(cfg: Config, ctx: rt.TraceContext) -> np.ndarray:
    """Per-beam live-tile slot selection for CBET traces
    (``models/cbet.py:315``): the layout of ``raytracer.live_tile_ids`` —
    the launched tiles of each beam, padded to a ``tiles_per_block``
    multiple with that beam's own dead tiles, so every beam owns
    ``tiles_per_group`` contiguous tiles and the slots equal the JAX
    solver's one for one.  A compact context (``prepare_device``) is born
    in that layout: all its slots.  A host context's state must launch rays
    in exactly the layout's live tiles; the pupil mask is beam-independent,
    so every beam has the same live count."""
    if ctx.compact:
        return np.arange(ctx.state0.n, dtype=np.int64)
    rpt = ctx.layout.rays_per_tile
    tpb = ctx.layout.tiles_per_beam
    mask = ctx.state0.alive.cpu().numpy()
    tile_live = mask.reshape(-1, rpt).any(axis=1)
    counts = tile_live.reshape(cfg.nbeams, tpb).sum(axis=1)
    if not (counts == counts[0]).all():
        raise RuntimeError(
            f"per-beam live-tile counts differ ({counts.tolist()}) — the "
            "beam-independent pupil assumption this layout relies on does "
            "not hold for this scene")
    ids, valid = rt.live_tile_ids(cfg, ctx.layout)
    if not np.array_equal(tile_live[ids], valid):
        raise RuntimeError("the state's launched tiles differ from the "
                           "pupil's live tiles (raytracer.live_tile_ids)")
    if len(np.unique(ids)) != len(ids):
        raise RuntimeError(
            f"a beam has fewer dead tiles than it needs to pad its "
            f"{int(valid.sum()) // cfg.nbeams} live tiles to a multiple of "
            f"tiles_per_block={cfg.tiles_per_block}")
    return rt.tile_slots(ids, rpt)


@dataclasses.dataclass(frozen=True)
class CbetOps:
    """The kernel entry points a CBET solve calls: :func:`kernel_ops` (the
    wrappers: the kernels for CUDA tensors, the plain versions for CPU
    tensors) or :func:`plain_ops` (the plain versions, to time or compare
    the kernels against them)."""

    deposit: Callable         # K1, the edep deposit (lookup mode)
    grouped: Callable         # K2, the per-beam intensity deposit
    window: Callable          # K4 "cell", the window-gain deposit
    tri: Callable             # K4 "tri" (cbet_gain_mode="kernel")
    gain: Callable            # K3, the gain reduction


def kernel_ops() -> CbetOps:
    return CbetOps(dep_ops.deposit, dep_ops.deposit_grouped,
                   gd_ops.deposit_gain_window, gd_ops.deposit_gain_window_tri,
                   gain_ops.gain)


def plain_ops() -> CbetOps:
    return CbetOps(dep_ops.deposit_reference,
                   dep_ops.deposit_grouped_reference,
                   gd_ops.deposit_gain_window_reference,
                   gd_ops.deposit_gain_window_tri_reference,
                   gain_ops.gain_reference)


def resolve_cbet_ops(cfg: Config, device) -> CbetOps:
    """The ops for ``cfg.deposit_backend`` on ``device``, by the rules of
    ``raytracer.resolve_deposit_fn``: "torch" is the plain versions (CPU
    only), "cuda" the kernels (raises off the card), "auto" the wrappers."""
    if rt.resolve_deposit_fn(cfg, device) is dep_ops.deposit_reference:
        return plain_ops()
    return kernel_ops()


#: whether the traces advance whole windows (``raytracer.batched``)
batched = rt.batched


def check_cbet_config(cfg: Config) -> None:
    """The JAX package's rules for the CBET switches
    (``models/cbet.py:498-532``, single device): a switch this configuration
    cannot run raises ``ValueError``, since running another model instead
    would silently compute something else."""
    if cfg.cbet_gain_mode not in GAIN_MODES:
        raise ValueError(f"unknown cbet_gain_mode {cfg.cbet_gain_mode!r} "
                         f"(expected one of {GAIN_MODES})")
    if cfg.cbet_accel not in ACCELS:
        raise ValueError(f"unknown cbet_accel {cfg.cbet_accel!r} (expected "
                         f"one of {ACCELS})")
    win = batched(cfg)
    if cfg.cbet_gain_stride not in (1, cfg.deposit_batch_steps):
        raise ValueError(
            f"cbet_gain_stride must be 1 or deposit_batch_steps "
            f"(={cfg.deposit_batch_steps}), got {cfg.cbet_gain_stride}")
    if cfg.cbet_gain_stride > 1 and not win:
        raise ValueError(
            "cbet_gain_stride > 1 requires the batched deposit path "
            "(deposit_batch_steps dividing the chunk lengths) — this "
            "configuration would silently run the exact per-step model "
            "instead")
    if cfg.cbet_gain_mode != "lookup":
        # the window-gain deposit's window IS the deposit batch
        if cfg.cbet_gain_stride != 1:
            raise ValueError(
                f"cbet_gain_mode={cfg.cbet_gain_mode!r} subsumes gain "
                "striding — set cbet_gain_stride=1")
        if not win:
            chunk, _, last = rt.chunk_lengths(cfg)
            raise ValueError(
                f"cbet_gain_mode={cfg.cbet_gain_mode!r} requires "
                "deposit_batch_steps > 1 dividing the chunk lengths "
                f"({chunk}, {last}); got {cfg.deposit_batch_steps} (the "
                "window model is defined per deposit window)")
    if cfg.cbet_light_iterations and not win:
        raise ValueError(
            "cbet_light_iterations=True (edep_skip) requires a batched "
            "deposit path: deposit_batch_steps > 1 dividing the chunk "
            "lengths")


def _path_element(state: rt.RayState, d) -> torch.Tensor:
    """|v| dt per step in cm: the same quadrature in both gain modes."""
    sq = [(state.vel[a] * d[a]) * (state.vel[a] * d[a]) for a in range(3)]
    return torch.sqrt(sq[0] + sq[1] + sq[2])


def _inv_cdt(cfg: Config) -> float:
    """1 / (c dt s^3): intensity is deposited per CBET-node density (a
    coarse node collects s^3 more ray-step weight)."""
    return 1.0 / (k.C_CMS * cfg.dt * cfg.cbet_grid_downsample ** 3)


def make_window_advance(cfg: Config):
    """``advance(state, field4) -> (state, streams)``: one window of
    ``deposit_batch_steps`` steps of the kernel gain modes WITHOUT gain and
    without the energy stop rule (``mini_nogain``,
    ``models/cbet.py:698-719``).

    ``streams`` holds step-major (batch, N) tensors: the deposit rows
    ``cx cy cz fx fy fz inc``, the path element ``ds`` (0 on dead rays), the
    gain-free intensity contribution ``contrib0`` (post-step alive mask) and
    the gain-free post-step energy ``u_nogain``; and the entry cells
    ``lcx lcy lcz`` of the "cell" sampling — the window-entry cell for step
    0, else the post-step cell of the step before
    (``models/cbet.py:825-827``).  Rays that die by energy mid-window keep
    stepping: the window-gain deposit applies the exact rule, and no output
    reads their window-end positions."""
    step_win = rt.make_deferred_step_fn(cfg.replace(stop_fraction=0.0))
    batch = cfg.deposit_batch_steps
    d = (cfg.dx, cfg.dy, cfg.dz)
    inv_cdt = _inv_cdt(cfg)
    names = ("cx", "cy", "cz", "fx", "fy", "fz", "inc", "ds", "contrib0",
             "u_nogain")

    def advance(state: rt.RayState, field4: torch.Tensor):
        cells0 = state.cell
        rows = []
        for _ in range(batch):
            ds = torch.where(state.alive, _path_element(state, d), 0.0)
            state, (cell, frac, inc) = step_win(state, field4)
            contrib0 = torch.where(state.alive,
                                   state.uray * (ds * inv_cdt), 0.0)
            rows.append((*cell, *frac, inc, ds, contrib0, state.uray))
        streams = {n: torch.stack(a) for n, a in zip(names, zip(*rows))}
        for ax, c0 in zip("xyz", cells0):
            c = streams["c" + ax]
            streams["lc" + ax] = torch.cat([c0[None], c[:-1]])
        return state, streams

    return advance


def make_cbet_trace_fn(cfg: Config, ctx: rt.TraceContext,
                       tiles_per_group: int | None = None,
                       ops: CbetOps | None = None, light: bool = False,
                       n_beams: int | None = None):
    """The gain-coupled trace (``models/cbet.py:364``, single device):
    ``trace(field4, gain (B, P), bid (N,), state0) -> (edep, inodes (B, Ph),
    state, overflow, steps)``.

    ``n_beams`` (default: all ``cfg.nbeams``) traces a block of that many
    beams: ``B`` below is then the block's size, ``gain`` holds the block's
    rows, ``bid`` counts from the block's first beam, and ``inodes`` are
    exact row blocks of the whole trace's; edep is the block's share.

    ``gain`` is full-resolution in the ray dtype; ``bid`` the per-slot beam
    ids (lookup mode); the slots are beam-contiguous, ``tiles_per_group``
    tiles per beam (default: the layout's ``tiles_per_beam``), which both
    the grouped intensity deposit and the window-gain deposit read
    positionally.  Chunks of ``chunk_steps`` deposit into grids of the ray
    dtype; edep promotes into an ``edep_dtype`` master, the intensity into a
    master of the ray dtype, and ``inodes`` is the intensity master's ghost
    crop.  The trace stops at the first chunk boundary where no ray is alive
    (one host sync per chunk); ``steps`` counts the steps executed.
    ``ops`` overrides the kernel entry points (default: resolved from
    ``cfg.deposit_backend`` and the device of ``state0``).

    ``light`` builds the light-iteration trace (``edep_skip``,
    ``models/cbet.py:1441-1459``): the same state and intensity, no edep
    deposit (the returned edep is zeros; the kernel modes call the window
    kernel's gain-only form); it needs the batched path.

    ``cfg.cbet_segmented`` compacts the trace at chunk boundaries (which
    are window boundaries) in the grouped mode of ``models/tileplan.py``:
    the state and the beam ids are gathered down to a uniform per-beam
    width, ``rays_per_group`` follows the width, and the final state is
    written back to ``state0``'s layout, so every output equals the
    uncompacted trace's.  A list passed as ``widths`` receives the
    per-beam tile widths before the trace and after each compaction."""
    check_cbet_config(cfg)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    s = cfg.cbet_grid_downsample
    hx, hy, hz = cfg.cbet_grid_shape
    P = nx * ny * nz                  # gain lookups are full-resolution
    nb = cfg.nbeams if n_beams is None else n_beams
    if not 1 <= nb <= cfg.nbeams:
        raise ValueError(f"n_beams must be in [1, {cfg.nbeams}], got {nb}")
    tpg = (tiles_per_group if tiles_per_group is not None
           else ctx.layout.tiles_per_beam)
    rpt = ctx.layout.rays_per_tile
    chunk, n_chunks, _ = rt.chunk_lengths(cfg)
    kernel_gain = cfg.cbet_gain_mode != "lookup"
    tri = cfg.cbet_gain_mode == "kernel"
    # check_cbet_config made sure the kernel modes and the strided lookup
    # have whole windows; the lookup takes them wherever they fit
    batch = cfg.deposit_batch_steps if batched(cfg) else 1
    if light and batch <= 1:
        raise ValueError(
            "edep_skip (light CBET iterations) requires a batched deposit "
            "path: deposit_batch_steps > 1 dividing the chunk lengths")
    strided = cfg.cbet_gain_stride > 1
    step = rt.make_deferred_step_fn(cfg)
    advance = make_window_advance(cfg)
    stop_frac = cfg.stop_fraction
    d = (cfg.dx, cfg.dy, cfg.dz)
    inv_cdt = _inv_cdt(cfg)
    shape3 = cfg.edep_shape
    ishape = (nb, hx + 2, hy + 2, hz + 2)
    master_dtype = getattr(torch, cfg.edep_dtype)

    def to_coarse(cell, frac):
        """Full-grid (cell, frac) -> CBET-grid (cell, frac)
        (``models/cbet.py:635``)."""
        if s == 1:
            return tuple(cell), tuple(frac)
        ch = tuple(c // s for c in cell)
        fh = tuple(((cell[a] - ch[a] * s).to(frac[a].dtype) + frac[a])
                   * (1.0 / s) for a in range(3))
        return ch, fh

    def lookup_gain(state, gain_flat, bid_off):
        cx, cy, cz = state.cell
        flat = (cx.to(torch.int64) * ny + cy) * nz + cz
        return gain_flat.index_select(0, bid_off + flat)

    def lookup_window(state, edep, ib, field4, gain_flat, bid_off, o,
                      rays_per_group):
        # models/cbet.py:944-983 (the per-step form :918-942 at batch 1):
        # each step's energy gains exp(clip(g * ds)) along its path element,
        # g at its entry cell (or at the window-entry cell for the whole
        # window: cbet_gain_stride); then one edep deposit (none in a light
        # iteration) and one intensity deposit of the step-major rows.  The
        # intensity is uray * |v| / c on the post-step alive mask.
        g_win = lookup_gain(state, gain_flat, bid_off) if strided else None
        rows = []
        for _ in range(batch):
            ds = _path_element(state, d)
            g = g_win if strided else lookup_gain(state, gain_flat, bid_off)
            factor = torch.exp(torch.clamp(g * ds, -GAIN_CLIP, GAIN_CLIP))
            state = dataclasses.replace(
                state, uray=torch.where(state.alive, state.uray * factor,
                                        state.uray))
            state, (cell, frac, inc) = step(state, field4)
            contrib = torch.where(state.alive, state.uray * (ds * inv_cdt),
                                  0.0)
            rows.append((*cell, *frac, inc, contrib))
        cx, cy, cz, fx, fy, fz, inc, contrib = (torch.cat(a)
                                                for a in zip(*rows))
        icell, ifrac = to_coarse((cx, cy, cz), (fx, fy, fz))
        ib, of = o.grouped(ib, *icell, *ifrac, contrib, rays_per_group,
                           state.n)
        if not light:
            edep, of_e = o.deposit(edep, cx, cy, cz, fx, fy, fz, inc,
                                   state.n)
            of = of + of_e
        return state, edep, ib, of

    def window_step(state, edep, ib, field4, gain, o, rays_per_group):
        # models/cbet.py:801-916: `batch` steps without gain, then the
        # window-gain deposit (gain at each step's entry cell or trilinear
        # at its deposit position, exact termination, edep unless light)
        # and the intensity of the whole window
        st, w = advance(state, field4)
        cell, frac = (w["cx"], w["cy"], w["cz"]), (w["fx"], w["fy"], w["fz"])
        rows = (*cell, *frac, w["inc"], w["ds"], w["u_nogain"], st.uray_init)
        if tri:
            edep, of_e, gamma, uout = o.tri(
                edep, *rows, gain, rays_per_group, GAIN_CLIP, stop_frac,
                gain_only=light)
        else:
            edep, of_e, gamma, uout = o.window(
                edep, *rows, w["lcx"], w["lcy"], w["lcz"], gain,
                rays_per_group, GAIN_CLIP, stop_frac, gain_only=light)
        contrib = (w["contrib0"] * gamma).reshape(-1)
        icell, ifrac = to_coarse(cell, frac)
        ib, of_i = o.grouped(ib, *(a.reshape(-1) for a in icell),
                             *(a.reshape(-1) for a in ifrac), contrib,
                             rays_per_group, st.n)
        # restore the frozen true energy and the exact aliveness
        state = dataclasses.replace(
            st, uray=uout, alive=st.alive & (uout > stop_frac * st.uray_init))
        return state, edep, ib, of_e + of_i

    def trace(field4, gain, bid, state0: rt.RayState, widths=None):
        device = state0.uray.device
        dtype = state0.uray.dtype
        o = ops or resolve_cbet_ops(cfg, device)
        if gain.shape != (nb, P) or bid.shape != (state0.n,):
            raise ValueError(f"gain must be ({nb}, {P}) and bid "
                             f"({state0.n},), got {tuple(gain.shape)} and "
                             f"{tuple(bid.shape)}")
        gain_flat = gain.reshape(-1)
        bid_off = bid.to(torch.int64) * P
        master = torch.zeros(shape3, dtype=master_dtype, device=device)
        imaster = torch.zeros(ishape, dtype=dtype, device=device)
        oflow = torch.zeros((), dtype=torch.int32, device=device)
        comp = None
        if cfg.cbet_segmented:
            if state0.n != nb * tpg * rpt:
                raise ValueError(
                    f"a compacted CBET trace needs {nb} beam groups of "
                    f"{tpg} tiles ({nb * tpg * rpt} slots), got {state0.n}")
            comp = TileCompactor(state0, rpt, n_groups=nb)
        rays_per_group = tpg * rpt
        state, steps = state0, 0
        for ci in range(n_chunks):
            if not bool(state.alive.any()):
                break
            if comp is not None:
                state, (bid_off,) = comp.update(state, (bid_off,),
                                                first=ci == 0)
                rays_per_group = comp.width * rpt
            n_steps = min(chunk, cfg.nt - ci * chunk)
            edep = torch.zeros(shape3, dtype=dtype, device=device)
            ib = torch.zeros(ishape, dtype=dtype, device=device)
            for _ in range(n_steps // batch):
                if kernel_gain:
                    state, edep, ib, of = window_step(
                        state, edep, ib, field4, gain, o, rays_per_group)
                else:
                    state, edep, ib, of = lookup_window(
                        state, edep, ib, field4, gain_flat, bid_off, o,
                        rays_per_group)
                oflow += of
            steps += n_steps
            if not light:
                master += edep.to(master_dtype)
            imaster += ib
        if comp is not None:
            state = comp.final(state)
            if widths is not None:
                widths.extend(comp.widths)
        # crop the ghosts -> per-beam node fields on the CBET grid
        inodes = imaster[:, 1:-1, 1:-1, 1:-1].reshape(nb, hx * hy * hz)
        return master, inodes, state, oflow, steps

    return trace


def _step_update(i_new, i_old, relax: float):
    """Max-abs delta and scale, and the relaxed blend
    (``models/cbet.py:1162``): THE one copy of the update arithmetic."""
    delta = (i_new - i_old).abs().max()
    scale = i_old.abs().max()
    blended = relax * i_new + (1.0 - relax) * i_old
    return delta, scale, blended


@dataclasses.dataclass
class _CbetSolver:
    """What a fixed-point solve reuses across ``cbet_solve`` calls
    (``models/cbet.py:1111``): the gain/trace functions and the uploaded
    field table, ray state and beam ids; none of it depends on the
    iteration-control fields, so a warm-up solve and a measured solve share
    one instance."""

    gain_fn: Any
    upsample: Any
    trace: Any                 # gain (B, P) -> (edep, inodes, state, steps)
    # the same without the edep deposit, for the fixed-point iterations
    # (cbet_light_iterations; None when off)
    trace_light: Any
    state0: rt.RayState
    bid: torch.Tensor
    make_zero_gain: Any        # () -> (B, P) zeros; a factory, not a buffer
    # per-beam tile widths of the last trace (cbet_segmented; else empty)
    tile_widths: list = dataclasses.field(default_factory=list)
    # memoized zero-gain (iteration-0) intensity (cbet_seed_zero_gain)
    seed_intensity: Any = None


_SOLVER_CACHE: dict = {}
_SOLVER_CACHE_MAX = 3


def _get_solver(cfg: Config, ctx: rt.TraceContext, device,
                ops: CbetOps) -> _CbetSolver:
    """The cached solver for (cfg minus the iteration-control fields,
    device, ops) and this very ``ctx`` (``models/cbet.py:1173``, without
    the mesh)."""
    key = (cfg.replace(cbet_max_iters=1, cbet_tol=0.0, cbet_relax=0.5,
                       cbet_seed_zero_gain=True, cbet_accel="none"),
           str(device), ops)
    hit = _SOLVER_CACHE.pop(key, None)
    if hit is not None and hit[0] is ctx:
        _SOLVER_CACHE[key] = hit
        return hit[1]
    solver = _build_solver(cfg, ctx, device, ops)
    while len(_SOLVER_CACHE) >= _SOLVER_CACHE_MAX:
        _SOLVER_CACHE.pop(next(iter(_SOLVER_CACHE)))
    _SOLVER_CACHE[key] = (ctx, solver)
    return solver


def solver_state(cfg: Config, ctx: rt.TraceContext, device):
    """``(state0, bid, tiles_per_group)`` of a CBET trace on ``device``
    (``models/cbet.py:1199``): the per-beam block-padded live-tile state,
    its per-slot beam ids and its per-beam tile width."""
    rpt = ctx.layout.rays_per_tile
    slots = live_tile_slots(cfg, ctx)
    tpg = (len(slots) // rpt) // cfg.nbeams
    # a compact context's state0 is already this layout, on its device
    state0 = ctx.state0 if ctx.compact else pad_rays(
        rt.select_rays(ctx.state0, slots), rpt * cfg.tiles_per_block)
    # per-slot beam ids (padding slots get 0 but are permanently dead)
    bid = np.maximum(ctx.beam_id[slots], 0).astype(np.int32)
    bid = np.pad(bid, (0, state0.n - bid.shape[0]))
    return state0.to(device), torch.from_numpy(bid).to(device), tpg


def _build_solver(cfg: Config, ctx: rt.TraceContext, device,
                  ops: CbetOps) -> _CbetSolver:
    """``models/cbet.py:1199``, single device: the per-beam block-padded
    live-tile state and its beam ids, uploaded once."""
    state0, bid_t, tpg = solver_state(cfg, ctx, device)
    field4 = ctx.field4.to(device)

    widths = []            # the last trace's tile widths (cbet_segmented)

    def checked(fn):
        def trace(gain):
            widths.clear()
            edep, inodes, st, of, steps = fn(field4, gain, bid_t, state0,
                                             widths)
            rt.check_overflow(int(of), cfg)
            return edep, inodes, st, steps
        return trace

    trace = checked(make_cbet_trace_fn(cfg, ctx, tiles_per_group=tpg,
                                       ops=ops))
    # light iterations (models/cbet.py:1441-1459): an opt-in because the
    # final full trace costs one more trace than the deposits it skips save
    # where the deposits are a small share of the trace
    trace_light = (checked(make_cbet_trace_fn(cfg, ctx, tiles_per_group=tpg,
                                              ops=ops, light=True))
                   if cfg.cbet_light_iterations else None)

    def make_zero_gain():
        return torch.zeros((cfg.nbeams, cfg.nx * cfg.ny * cfg.nz),
                           dtype=getattr(torch, cfg.dtype), device=device)

    upsample = (make_gain_upsampler(cfg, device)
                if cfg.cbet_grid_downsample > 1 else (lambda g: g))
    return _CbetSolver(gain_fn=make_gain_fn(cfg, ctx, device, ops.gain),
                       upsample=upsample, trace=trace,
                       trace_light=trace_light, state0=state0, bid=bid_t,
                       make_zero_gain=make_zero_gain, tile_widths=widths)


def _accel_next(i_new, i_old, prev_x, prev_f, relax: float):
    """A later Anderson(m=1) update (``models/cbet.py:1501-1516``): the
    relaxed step minus the least-squares secant correction
    ``gamma * (dx + relax * df)``.  The dot products run on the residuals
    divided by the scale (gamma does not change, and squared raw residuals
    overflow float32 at large intensities); gamma is 0 on a degenerate
    secant and clipped to [-2, 2]."""
    f = i_new - i_old
    delta = f.abs().max()
    scale = i_old.abs().max()
    tiny = torch.finfo(f.dtype).tiny
    s = torch.clamp(scale, min=tiny)
    fs = (f / s).reshape(-1)
    dfs = ((f - prev_f) / s).reshape(-1)
    den = torch.dot(dfs, dfs)
    gamma = torch.where(den > 0,
                        torch.dot(fs, dfs) / torch.clamp(den, min=tiny), 0.0)
    gamma = torch.clamp(gamma, -2.0, 2.0)
    x_next = (i_old + relax * f) - gamma * ((i_old - prev_x)
                                            + relax * (f - prev_f))
    return delta, scale, x_next, f


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cbet_solve(cfg: Config, ctx: rt.TraceContext, device=None,
               verbose: bool = False, ops: CbetOps | None = None
               ) -> CbetResult:
    """Fixed-point CBET solve on ``device`` (default: the card,
    ``raytracer.default_device``; ``"cpu"`` for a CPU run);
    ``models/cbet.py:1534``/``:1559``, single
    device, its traces compacted with ``cfg.cbet_segmented``.  ``ops``
    overrides the kernel entry points (default: resolved from
    ``cfg.deposit_backend``).

    The gain is computed in float32 even in a float64 solve and cast back
    to the ray dtype.  Iteration 0 (zero gain) is memoized in the cached
    solver when ``cbet_seed_zero_gain`` allows.  With
    ``cbet_light_iterations`` the iterations run the light trace and one
    full trace with the last gain makes edep and the final state (the same
    values as the full solve).  ``cbet_accel="anderson"`` mixes the
    iterates by Anderson(m=1) instead of the plain relaxed step.  The stats
    carry the JAX solve's keys plus the per-iteration gain/trace/update
    seconds (each ends in a device synchronize), the steps of every trace
    (the final full trace last) and the final trace's seconds."""
    check_cbet_config(cfg)
    device = torch.device(device) if device is not None \
        else rt.default_device()
    ops = ops or resolve_cbet_ops(cfg, device)
    solver = _get_solver(cfg, ctx, device, ops)
    hx, hy, hz = cfg.cbet_grid_shape
    gain_dtype = getattr(torch, cfg.dtype)

    trace_it = solver.trace_light or solver.trace
    gain_last = solver.make_zero_gain()
    seed_ok = cfg.cbet_seed_zero_gain and cfg.cbet_max_iters >= 1
    seeded = seed_ok and solver.seed_intensity is not None
    trace_steps = []
    t0 = time.perf_counter()
    if seeded:
        intensity = solver.seed_intensity
        edep = state = None
    else:
        edep, intensity, state, steps = trace_it(gain_last)
        trace_steps.append(steps)
        if seed_ok:
            solver.seed_intensity = intensity
    _sync(device)
    iter0_seconds = time.perf_counter() - t0
    history = []
    split = {"iter_seconds": [], "iter_gain_seconds": [],
             "iter_trace_seconds": [], "iter_update_seconds": []}
    converged = False
    it = 0
    accel = cfg.cbet_accel == "anderson"
    prev_x = prev_f = None
    relax = float(cfg.cbet_relax)
    for it in range(1, cfg.cbet_max_iters + 1):
        t0 = time.perf_counter()
        gain = solver.upsample(solver.gain_fn(intensity.to(torch.float32))
                               ).to(gain_dtype)
        _sync(device)
        t1 = time.perf_counter()
        gain_last = gain
        edep, i_new, state, steps = trace_it(gain)
        trace_steps.append(steps)
        _sync(device)
        t2 = time.perf_counter()
        if prev_f is None:
            # the plain step, and the first Anderson update bit for bit
            # (models/cbet.py:1494-1499): its residual seeds the history
            d_dev, s_dev, blended = _step_update(i_new, intensity, relax)
            f_cur = i_new - intensity if accel else None
        else:
            d_dev, s_dev, blended, f_cur = _accel_next(
                i_new, intensity, prev_x, prev_f, relax)
        delta = float(d_dev) / max(float(s_dev), 1e-300)
        t3 = time.perf_counter()
        history.append(delta)
        for key, v in zip(split, (t3 - t0, t1 - t0, t2 - t1, t3 - t2)):
            split[key].append(v)
        if verbose:
            print(f"cbet iter {it}: rel delta {delta:.3e} "
                  f"[gain {t1 - t0:.2f}s trace {t2 - t1:.2f}s "
                  f"update {t3 - t2:.2f}s]", flush=True)
        if delta < cfg.cbet_tol:
            intensity = i_new
            converged = True
            break
        if accel:
            # the secant history: the pre-update iterate and its residual
            prev_x, prev_f = intensity, f_cur
        intensity = blended

    final_seconds = None
    if solver.trace_light is not None:
        # the final full trace with the last executed iteration's gain: the
        # edep and state of the full solve (models/cbet.py:1673-1681)
        t0 = time.perf_counter()
        edep, _, state, steps = solver.trace(gain_last)
        trace_steps.append(steps)
        _sync(device)
        final_seconds = time.perf_counter() - t0
        if verbose:
            print(f"cbet final edep trace {final_seconds:.2f}s", flush=True)

    tf = time.perf_counter()
    stats = rt.trace_stats(ctx, state, solver.state0)
    edep_h = edep.to("cpu", torch.float64).numpy()
    inten_h = intensity.to("cpu", torch.float64).numpy().reshape(
        cfg.nbeams, hx, hy, hz)
    stats["result_fetch_seconds"] = time.perf_counter() - tf
    stats["intensity_mode"] = "grouped"      # the per-beam grouped deposit
    stats["segmented"] = bool(cfg.cbet_segmented)
    # the last trace's per-beam tile widths (compacted traces only)
    stats["tile_widths"] = list(solver.tile_widths)
    # the JAX solve's key for what this port does not run (the mesh's
    # sharded gain) is written with the value this solve had, so the
    # outputs keep one schema
    stats["gain_sharded"] = False
    stats["light_iterations"] = solver.trace_light is not None
    stats["gain_mode"] = cfg.cbet_gain_mode
    stats["gain_rows2"] = cfg.cbet_gain_rows2
    stats["relax"] = cfg.cbet_relax
    stats["accel"] = cfg.cbet_accel
    stats["plan_headroom"] = cfg.cbet_plan_headroom
    stats.update(split)
    stats["iter0_seconds"] = iter0_seconds
    stats["seeded_zero_gain"] = bool(seeded)
    stats["trace_steps"] = trace_steps
    stats["final_trace_seconds"] = final_seconds
    stats["device"] = str(device)
    return CbetResult(edep=edep_h, intensity=inten_h, iterations=it,
                      converged=converged, history=history, stats=stats)
