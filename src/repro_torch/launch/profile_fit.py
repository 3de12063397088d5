"""Where a fit's time goes on the card: a profiled run of the first rounds.

    python -m repro_torch.launch.profile_fit [--rounds 2] [--trace out.json]

Builds the full-width configuration (`launch.full_width`: SIFT1M's shape,
1,000,000 x 128, in the paper's size-limited regime), fits it once unprofiled for `--rounds` rounds to warm up, then again under
`torch.profiler` (CPU and CUDA activities). Prints the wall time, the summed
device time of the CUDA kernels, the device's idle share (1 - busy / wall),
and the kernels and host operators that take the most time. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace of the profiled run here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fit needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import fit
    from repro_torch.kernels import ops
    from repro_torch.launch import full_width
    from repro_torch.random import PRNGKey

    spec, lshp = full_width.data()
    cfg = full_width.config(lshp, max_rounds=args.rounds)
    fit(spec.points, cfg, PRNGKey(0))             # warm-up, kernels built
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fit(spec.points, cfg, PRNGKey(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] device {torch.cuda.get_device_name(0)} rounds="
          f"{res.n_rounds} wall_s={wall:.4f} (profiled) device_busy_s="
          f"{busy_us / 1e6:.4f} idle_share={1 - busy_us / 1e6 / wall:.4f} "
          f"launches={ops.launch_counts()}")
    print("[profile] CUDA kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[
            :args.top]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms  "
              f"{e.count:7d} calls  {e.key[:90]}")
    host = [e for e in events if e.device_type.name == "CPU"]
    print("[profile] host operators by self CPU time:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:args.top]:
        print(f"  {e.self_cpu_time_total / 1e3:10.3f} ms  "
              f"{e.count:7d} calls  {e.key[:90]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
