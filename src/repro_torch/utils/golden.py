"""Golden fixtures made by the JAX package, and the checks that hold the
port to them with numpy and torch alone (no jax): on the CPU through the
plain versions, and on the card, whose host has no JAX, through the
kernels.

The fixtures are `tests/golden_torch/*.npz`, written by
`tests/torch_golden_gen.py` from the JAX package's backend="ref" (see its
docstring; each file records the jax version and the seed):

- "ops": every case of `analysis.contracts.OP_CASES`, inputs and outputs;
- "fit_small": a fit + predict of tests/test_engine.py's fixture (points
  stored);
- "fit_parity": a fit at chip_smoke.py phase 3b's data (200 blobs of 40 and
  12,000 noise points in d = 128; the points are made here from the seed
  and held to the fixture's sha256).

The parity contract (ROADMAP "Parity contract"): integer and bool outputs
equal (LSH keys, labels, ids, masks); f32 outputs within rtol 1e-6 of the
reference (`RTOL`), non-finite entries equal; end to end, canonical labels
and `n_rounds` equal, sorted densities within rtol 1e-6, and k within the
rtol 1e-5 of ROADMAP C ("k differs by ~1e-6 relative"). Two ops are held
to the rules the repo already states for them, since they sum in their own
orders: `flash_attention` to rtol 1e-5 + atol 2e-6 on the plain version
(tests/test_torch_attention.py) and, through the kernel, to the kernel's
rule against its plain version (`kernels.flash_attention.
compare_with_plain`, f32: 1e-5 + 2e-5 |want|); `lsh_hash` through the kernel
to its key-flip rule (`kernels.lsh_hash.key_flips`: a key may differ only
where a projection lies within 1e-4 of a bucket edge). The `affinity` case
has no self pair (q and c are different rows), so no diagonal is compared.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

GOLDEN_DIR = Path(__file__).resolve().parents[3] / "tests" / "golden_torch"
RTOL = 1e-6
K_RTOL = 1e-5
# flash_attention's stated tolerance against the JAX package on the plain
# version (tests/test_torch_attention.py)
ATTN_RTOL, ATTN_ATOL = 1e-5, 2e-6


def load(name: str, directory=None) -> tuple[dict, dict]:
    """(arrays, meta) of fixture `name` ("ops", "fit_small",
    "fit_parity")."""
    path = Path(directory or GOLDEN_DIR) / f"{name}.npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "meta"}
        meta = json.loads(str(z["meta"]))
    return arrays, meta


def points_sha256(points: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(points, np.float32).tobytes()).hexdigest()


# ------------------------------------------------------------------ ops ----
def op_args(arrays: dict, meta: dict, name: str) -> tuple[tuple, dict]:
    """Case `name`'s arguments as the JAX package took them: arrays, and the
    Python scalars the fixture stores as 0-d arrays."""
    case = meta["cases"][name]
    args = []
    for i in range(case["n_args"]):
        a = arrays[f"{name}__arg{i}"]
        args.append(a.item() if i in case["scalars"] else a)
    return tuple(args), dict(case["kwargs"])


def _float_problem(got: np.ndarray, want: np.ndarray, rtol: float,
                   atol: float = 0.0) -> Optional[str]:
    fin = np.isfinite(want)
    if not np.array_equal(np.isfinite(got), fin) or not np.array_equal(
            got[~fin], want[~fin]):
        return "non-finite entries differ"
    diff = np.abs(got[fin].astype(np.float64) - want[fin])
    bound = atol + rtol * np.abs(want[fin].astype(np.float64))
    if (diff > bound).any():
        i = int(np.argmax(diff - bound))
        return (f"{int((diff > bound).sum())} entries outside atol {atol} "
                f"+ rtol {rtol}, the worst {float(diff[i]):.3e} at "
                f"|want| {float(abs(want[fin][i])):.3e}")
    return None


def _compare(name: str, j: int, got: torch.Tensor, want: np.ndarray,
             args: tuple, mode: str) -> Optional[str]:
    g = got.detach().cpu().numpy()
    if g.shape != want.shape:
        return f"shape {g.shape} != {want.shape}"
    if g.dtype.kind != "f":
        if g.dtype.kind != want.dtype.kind and not (
                g.dtype.kind in "iu" and want.dtype.kind in "iu"):
            return f"dtype {g.dtype} against {want.dtype}"
        if name == "lsh_hash" and mode == "kernel":
            from repro_torch.kernels.lsh_hash import key_flips
            x, proj, bias, seg = (torch.as_tensor(a) if isinstance(
                a, np.ndarray) else a for a in args)
            flips, near = key_flips(x, proj, bias, seg,
                                    torch.as_tensor(g.astype(np.int64)),
                                    torch.as_tensor(want.astype(np.int64)))
            return None if near else (f"{flips} key flips, not all within "
                                      "rounding of a bucket edge")
        if not np.array_equal(g.astype(np.int64), want.astype(np.int64)):
            return f"{int((g != want).sum())} of {g.size} entries differ"
        return None
    if name == "flash_attention":
        if mode == "kernel":
            return _float_problem(g, want, 2e-5, 1e-5)
        return _float_problem(g, want, ATTN_RTOL, ATTN_ATOL)
    return _float_problem(g, want, RTOL)


def check_ops(device="cuda", backend: str = "auto",
              directory=None) -> dict[str, list[str]]:
    """Every op of the "ops" fixture on `device` through `backend`, held to
    the JAX package's outputs. Returns {op: problems} (empty lists where
    it holds)."""
    from repro_torch.analysis.contracts import (BATCHED_OPS, operands,
                                                run_op)
    from repro_torch.kernels.ops import resolve_backend
    arrays, meta = load("ops", directory)
    out = {}
    for name in meta["cases"]:
        args, kwargs = op_args(arrays, meta, name)
        targs = operands(name, args, device)
        mode = resolve_backend(backend, targs[0])
        got = run_op(name, targs, kwargs, backend)
        if name in BATCHED_OPS:
            got = tuple(t[0] for t in got)
        problems = []
        n_outs = meta["cases"][name]["n_outs"]
        if len(got) != n_outs:
            problems.append(f"{len(got)} outputs, the reference has {n_outs}")
        for j, g in enumerate(got[:n_outs]):
            why = _compare(name, j, g, arrays[f"{name}__out{j}"], args, mode)
            if why:
                problems.append(f"output {j}: {why}")
        out[name] = problems
    return out


# ----------------------------------------------------------------- fits ----
def fit_problems(res, arrays: dict) -> list[str]:
    """A port Clustering against a fixture's fit: canonical labels and
    n_rounds equal, sorted densities within RTOL, k within K_RTOL."""
    from repro_torch.utils.metrics import canonical_labels
    out = []
    got = canonical_labels(np.asarray(res.labels))
    if not np.array_equal(got, arrays["labels"]):
        out.append(f"canonical labels differ at "
                   f"{int((got != arrays['labels']).sum())} points")
    if int(res.n_rounds) != int(arrays["n_rounds"]):
        out.append(f"n_rounds {res.n_rounds} != {int(arrays['n_rounds'])}")
    dens = np.sort(np.asarray(res.densities, np.float32))
    if dens.shape != arrays["densities"].shape:
        out.append(f"{dens.size} clusters, the reference "
                   f"{arrays['densities'].size}")
    else:
        why = _float_problem(dens, arrays["densities"], RTOL)
        if why:
            out.append(f"densities: {why}")
    k, want_k = float(res.k), float(arrays["k"])
    if abs(k - want_k) > K_RTOL * abs(want_k):
        out.append(f"k {k!r} against {want_k!r}")
    return out


def _config(meta: dict):
    from repro_torch.core.alid import ALIDConfig
    from repro_torch.lsh.pstable import LSHParams
    return ALIDConfig(lsh=LSHParams(*meta["lsh"]), **meta["cfg"])


def fit_data(name: str, directory=None):
    """(points, config, arrays) of a fit fixture: "fit_small" stores its
    points; "fit_parity"'s are made here from the seed and must match the
    fixture's sha256."""
    arrays, meta = load(name, directory)
    if "points" in arrays:
        points = arrays["points"]
    else:
        from repro_torch.data import make_blobs_with_noise
        points = make_blobs_with_noise(**meta["data"]).points
        if points_sha256(points) != meta["points_sha256"]:
            raise ValueError(
                f"{name}: the points made from {meta['data']} do not match "
                "the fixture's sha256: the data generator drifted")
    return points, _config(meta), arrays


def check_fit(name: str, spec=None, device="cuda", engine=None,
              directory=None) -> tuple[list[str], object]:
    """The port's fit of fixture `name` on `device` (engine `spec`, or a
    made `engine` the caller owns) against the JAX package's. For
    "fit_small" also `predict` of the stored queries, in the fit's
    canonical numbering. Returns (problems, the Clustering)."""
    from repro_torch.core.alid import EngineSpec
    from repro_torch.core.engine import fit
    from repro_torch.random import PRNGKey
    from repro_torch.utils.metrics import canonical_labels
    points, cfg, arrays = fit_data(name, directory)
    cfg = cfg._replace(spec=spec or (engine.spec if engine is not None
                                     else EngineSpec()))
    res = fit(points, cfg, PRNGKey(0), engine=engine, device=device)
    problems = fit_problems(res, arrays)
    if "predict" in arrays:
        pred = res.predict(arrays["queries"], backend=cfg.spec.backend,
                           device=device)
        both = canonical_labels(np.concatenate(
            [np.asarray(res.labels), pred]))[len(points):]
        if not np.array_equal(both, arrays["predict"]):
            problems.append(f"predict differs at "
                            f"{int((both != arrays['predict']).sum())} of "
                            f"{both.size} queries")
    return problems, res
