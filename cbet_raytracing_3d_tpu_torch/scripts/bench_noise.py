"""The bench's spread across runs: the bench (``python -m
cbet_raytracing_3d_tpu_torch.bench``) ``--runs`` times, each in a fresh
process from the repository root (as a user or a harness runs it), then the
min, median and max of its end-to-end metrics over the runs.

    python -m cbet_raytracing_3d_tpu_torch.scripts.bench_noise --runs 5 \\
        --out out/bench_noise.jsonl [-- BENCH FLAGS]

Every run's complete record (the bench's last line) goes into ``--out``, one
per line; the summary lines name the card (``nvidia-smi``'s name and power
limit from the records).  A run that fails stops the script with its exit
code and output.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
METRICS = ("value", "value_window", "trace_seconds", "trace_seconds_median",
           "cbet_wallclock_seconds", "cbet_solve_seconds", "init_seconds",
           "backend_init_seconds")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="the bench N times; min, median, max of its metrics")
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--out", default=None, help="JSONL of every record")
    p.add_argument("bench_args", nargs="*",
                   help="flags for the bench (after --)")
    args = p.parse_args(argv)
    records = []
    for i in range(args.runs):
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cbet_raytracing_3d_tpu_torch.bench",
             *args.bench_args], capture_output=True, text=True, cwd=REPO,
            timeout=900)
        secs = time.perf_counter() - t
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or len(lines) != 2:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode or 1
        rec = json.loads(lines[-1])
        rec["process_seconds"] = secs
        records.append(rec)
        print(f"run {i + 1}: " + ", ".join(
            f"{k} {rec[k]}" for k in METRICS + ("cbet_wallclock_samples",
                                                "process_seconds")),
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    for k in METRICS:
        xs = [r[k] for r in records]
        print(f"{k}: min {min(xs)!r} median {statistics.median(xs)!r} max "
              f"{max(xs)!r} over {len(xs)} runs", flush=True)
    cards = sorted({r["nvidia_smi"] or r["backend"] for r in records})
    print(f"card: {'; '.join(cards)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
