"""``torch.profiler`` around a block, exported as a Chrome trace: the
profiler that ``runner.run(profile_dir=...)`` (``cli run --profile-dir``)
puts around the Tracing phase and that ``scripts/profile_trace.py`` reads
kernel times from."""

from __future__ import annotations

import contextlib
import os

import torch


def activities(cuda: bool = True) -> list:
    """What the profiler records: the host's operators and, on the card,
    the device's kernels and copies."""
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


@contextlib.contextmanager
def trace_to(profile_dir: str, device, name: str = "trace.json"):
    """``torch.profiler`` over the block, the device synchronized before it
    stops, exported as a Chrome trace to ``profile_dir/name``.  A profiler
    that cannot start or export raises."""
    device = torch.device(device)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities(device.type == "cuda")) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(profile_dir, name))


__all__ = ["activities", "trace_to"]
