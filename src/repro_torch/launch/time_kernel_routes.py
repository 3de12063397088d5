"""Device time of `roi_filter`'s routes and of the attention backward's
small route, for choosing `roi_filter`'s crossover and for comparing two
trees of the port on one card.

    python src/repro_torch/launch/time_kernel_routes.py [--src DIR]
        [--runs 25] [--fits] [--out FILE]

Imports `repro_torch` from DIR (default: the tree this file is in), so the
same command times another checkout's kernels: run it on two trees in
turns (A, B, B, A) in one run on one card. Times as chip_smoke.py
takes them (`time_fit_kernels.graph_ms`): `runs` calls captured in a CUDA
graph, the median of 5 replays, per call. Cases:

- `roi_filter` at the main path's 32 x 7,168 x 128, f32 and bf16 rows, on
  the plan's route and on each route forced (where the tree has routes);
- the attention backward at BST's train batch, 65,536 x 8 heads x 21 x 21
  x dh 4, f32 and bf16, q, k and v the (B, 21, 8, 4) projections'
  transposed views as the model makes them;
- with `--fits`: the sharded engine's fits at phase 3b's data (n = 20,000,
  probe 128) and at full width (1,000,000 x 128), 8 shards, each
  recording the (B, C, d) of every `roi_filter` call; then each recorded
  shape timed on both routes (f32), and per fit the sum over its calls of
  each route's time, of the plan's and of the faster one's.

Prints one JSON line (also written to FILE) with each source's compile
seconds where this run built the library, and the card's name and power
limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path


def roi_inputs(bsz: int, per_seed: int, d: int, dtype, seed: int = 2):
    """chip_smoke.py phase 2's roi_filter inputs at (B, C, d), drawn on
    the card: 70 % valid rows, a radius near the rows' typical distance."""
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vc = torch.randn((bsz, per_seed, d), generator=gen, device=dev)
    center = torch.randn((bsz, d), generator=gen, device=dev)
    radius = torch.full((bsz,), 0.98 * (2 * d) ** 0.5, device=dev)
    valid = torch.rand((bsz, per_seed), generator=gen, device=dev) < 0.7
    return vc.to(dtype), center, radius, valid


def roi_routes(fn, args, runs: int) -> dict:
    """{route: ms} on the plan's route ("plan") and, where the tree's
    wrapper takes `route=`, each route forced (a route it cannot take is
    left out)."""
    from repro_torch.launch.time_fit_kernels import graph_ms
    out = {"plan": graph_ms(lambda: fn(*args), runs)}
    for route in getattr(sys.modules[fn.__module__], "ROUTES", ()):
        try:
            fn(*args, route=route)
        except (TypeError, ValueError):
            continue
        out[route] = graph_ms(lambda r=route: fn(*args, route=r), runs)
    return out


def recorded_shapes(fit_fn) -> collections.Counter:
    """The (B, C, d) of every roi_filter call that fit_fn() makes."""
    from repro_torch.kernels import ops
    seen = collections.Counter()
    inner = ops.roi_filter_cuda

    def recording(vc, *args, **kw):
        seen[tuple(vc.shape)] += 1
        return inner(vc, *args, **kw)
    ops.roi_filter_cuda = recording
    try:
        fit_fn()
    finally:
        ops.roi_filter_cuda = inner
    return seen


def sharded_fits() -> dict:
    """{fit: Counter of roi_filter shapes} of the sharded engine (8
    shards) at phase 3b's data and at full width."""
    import torch
    from repro_torch.core.alid import ALIDConfig, EngineSpec
    from repro_torch.core.engine import fit, make_engine
    from repro_torch.data import auto_lsh_params, make_blobs_with_noise
    from repro_torch.launch import full_width
    from repro_torch.random import PRNGKey
    dev = torch.device("cuda", 0)
    spec8 = EngineSpec(engine="sharded", n_shards=8)
    small = make_blobs_with_noise(n_clusters=200, cluster_size=40,
                                  n_noise=12_000, d=128, seed=0)
    lshp = auto_lsh_params(small.points, probe=128, seg_scale=1.0)
    cfg3b = ALIDConfig(a_cap=72, delta=128, lsh=lshp, seeds_per_round=32,
                       max_rounds=64, spec=spec8)
    full, flshp = full_width.data()
    cfg4b = full_width.config(flshp)._replace(spec=spec8)
    out = {}
    for name, pts, cfg in (("3b", small.points, cfg3b),
                           ("4b", full.points, cfg4b)):
        engine = make_engine(cfg.spec, device=dev)
        out[name] = recorded_shapes(
            lambda: fit(pts, cfg, PRNGKey(0), engine=engine))
        engine.close()
        del engine
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--fits", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernel_routes needs a CUDA device")
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.roi_filter import roi_filter_cuda
    from repro_torch.launch.time_fit_kernels import graph_ms
    dev = torch.device("cuda", 0)
    out = {"src": str(Path(args.src).resolve())}

    for dt in (torch.float32, torch.bfloat16):
        a = roi_inputs(32, 7168, 128, dt)
        out[f"roi_filter_{str(dt)[6:]}_ms"] = roi_routes(roi_filter_cuda, a,
                                                         args.runs)
        del a

    # BST's attention backward at the train batch
    b = 65_536
    rng = np.random.default_rng(7)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, 21, 32), dtype=np.float32)).to(dev, dt).view(b, 21, 8, 4)
            .transpose(1, 2) for _ in range(3))
        o = flash_attention_cuda(q, k, v, 0, causal=False)
        do = torch.randn_like(o)
        out[f"bwd_small_bst_{str(dt)[6:]}_ms"] = graph_ms(
            lambda: flash_attention_bwd_cuda(q, k, v, o, do, causal=False),
            min(args.runs, 10))
        del q, k, v, o, do
    torch.cuda.empty_cache()

    if args.fits:
        fits = {}
        for name, shapes in sharded_fits().items():
            per_shape, total = [], collections.Counter()
            for (bsz, per_seed, d), calls in sorted(shapes.items()):
                a = roi_inputs(bsz, per_seed, d, torch.float32)
                t = roi_routes(roi_filter_cuda, a, args.runs)
                del a
                per_shape.append(dict(shape=[bsz, per_seed, d], calls=calls,
                                      rows=bsz * per_seed, ms=t))
                for route, ms in t.items():
                    total[route] += calls * ms
                total["best"] += calls * min(t.values())
            fits[name] = dict(calls=sum(shapes.values()),
                              total_ms=dict(total), shapes=per_shape)
        out["fits"] = fits

    from repro_torch.kernels import _build
    out["compile_seconds"] = dict(_build.COMPILE_SECONDS)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line if len(line) < 4000 else json.dumps(
        {k: v for k, v in out.items() if k != "fits"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
