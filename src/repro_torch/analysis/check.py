"""CLI entry point: `python -m repro_torch.analysis.check`.

Runs the port's analysis passes over the repo and exits non-zero if any
unsuppressed violation survives; `run_palid --check` is an alias that
writes `CHECK_report_torch.json`. The twin of `repro.analysis.check`.

Pass selection: all three by default. `--only dispatch,concurrency` (or
`--skip`) narrows for local iteration; `--no-runtime` keeps only the pure
source passes (sub-second, no kernel build). The runtime pass runs on the
card unless `--device cpu` asks for the plain side only; asked for the card
on a host with none, it fails.

The JAX package's `jitboundary` and `retrace` passes have no counterpart:
their rules are about `jax.jit` tracing (host syncs inside a traced
function, Python scalars fed to static arguments, the streamed engine's
jit-cache misses), and the port's main path has no trace cache for them to
guard. Asking for either exits non-zero, saying so.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.pragmas import PragmaCache
from repro_torch.analysis.report import Report

SOURCE_PASSES = ("dispatch", "concurrency")
RUNTIME_PASSES = ("contracts",)
ALL_PASSES = SOURCE_PASSES + RUNTIME_PASSES
# the JAX package's passes with no counterpart in the port, and why
NO_COUNTERPART = ("jitboundary", "retrace")
NO_COUNTERPART_WHY = (
    "its rules are about jax.jit tracing (host syncs inside a traced "
    "function, Python scalars fed to static arguments, the streamed "
    "engine's jit-cache misses), and the port's main path has no trace "
    "cache for them to guard")


def find_repo_root(start: str | None = None) -> str:
    """Walk up from `start` (or cwd) to the directory holding
    src/repro_torch."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(d, "src", "repro_torch")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    # fall back to the package's own checkout
    # (src/repro_torch/analysis/check.py)
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def run_checks(root: str, passes=ALL_PASSES, device="cuda") -> Report:
    report = Report(root)
    pragma_cache = PragmaCache(report)
    if "dispatch" in passes:
        from repro_torch.analysis import dispatch
        dispatch.run(root, report, pragma_cache)
    if "concurrency" in passes:
        from repro_torch.analysis import concurrency
        concurrency.run(root, report, pragma_cache)
    if "contracts" in passes:
        from repro_torch.analysis import contracts
        contracts.run(root, report, device)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check",
        description="Static + runtime contract checker for the port's "
                    "kernel / dispatch / serving stack (CI gate).")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detect from cwd)")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the JSON report here (e.g. "
                         "CHECK_report_torch.json)")
    ap.add_argument("--only", default=None, metavar="PASSES",
                    help=f"comma list out of {','.join(ALL_PASSES)}")
    ap.add_argument("--skip", default=None, metavar="PASSES",
                    help="comma list of passes to skip")
    ap.add_argument("--no-runtime", action="store_true",
                    help="source passes only (no kernel build; fast)")
    ap.add_argument("--device", default="cuda",
                    help="where the runtime pass runs (default: the card; "
                         "'cpu' runs the plain side only and records the "
                         "kernel side as not run)")
    args = ap.parse_args(argv)

    passes = list(ALL_PASSES)
    if args.no_runtime:
        passes = [p for p in passes if p in SOURCE_PASSES]
    if args.only:
        wanted = [p.strip() for p in args.only.split(",") if p.strip()]
        for p in wanted:
            if p in NO_COUNTERPART:
                print(f"analysis: the JAX package's {p!r} pass has no "
                      f"counterpart in the port: {NO_COUNTERPART_WHY}",
                      file=sys.stderr)
                return 2
        bad = sorted(set(wanted) - set(ALL_PASSES))
        if bad:
            ap.error(f"unknown pass(es) {bad}; choose from {ALL_PASSES}")
        passes = [p for p in passes if p in wanted]
    if args.skip:
        dropped = {p.strip() for p in args.skip.split(",")}
        passes = [p for p in passes if p not in dropped]

    root = args.root or find_repo_root()
    report = run_checks(root, passes, device=args.device)
    if args.report:
        report.write(args.report)
    print(report.summary())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
