"""Phase timing, mirroring the reference's gettimeofday instrumentation
(main.cu:99-100,154,198,219-231): Init / Tracing / Combining / Total.

Counterpart of ``cbet_raytracing_3d_tpu/utils/timers.py``.  PyTorch returns
from a CUDA call before the card has finished, so when the run is on the card
a phase synchronizes the device before it reads the clock, at both ends: the
device time lands in the phase that queued the work, as
``cudaDeviceSynchronize`` makes it in the reference (main.cu:175)."""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class PhaseTimers:
    """Accumulates named wall-clock phases; prints the reference's format.

    ``device``: the run's device; a CUDA device is synchronized at each
    phase boundary."""

    def __init__(self, device: torch.device | str | None = None):
        self._device = torch.device(device) if device is not None else None
        self._elapsed: dict[str, float] = {}
        self._t0 = time.perf_counter()

    def _fence(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @contextmanager
    def phase(self, name: str):
        self._fence()
        t = time.perf_counter()
        try:
            yield
        finally:
            self._fence()
            self._elapsed[name] = self._elapsed.get(name, 0.0) + (time.perf_counter() - t)

    def elapsed(self, name: str) -> float:
        return self._elapsed.get(name, 0.0)

    @property
    def total(self) -> float:
        return time.perf_counter() - self._t0

    def as_dict(self) -> dict[str, float]:
        d = dict(self._elapsed)
        d["Total"] = self.total
        return d

    def report(self) -> str:
        """Reference-style report (main.cu:225-230): one 'Name seconds' line
        per phase, microsecond resolution."""
        lines = [f"rt: {name} {secs:.6f}" for name, secs in self._elapsed.items()]
        lines.append(f"Total {self.total:.6f}")
        return "\n".join(lines)
