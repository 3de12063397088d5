"""PALID, parallel ALID (paper Sec. 4.6, Alg. 3), over the ranks of a
process group: a deprecation shim, as in the JAX package. The map phase
lives in `core.engine.MeshEngine` and the peel-reduce loop is the one
`engine.fit` loop, so the mesh path shares the segment-max claim reducer
(`engine.resolve_claims`) with every other engine. New code calls, on
every rank:

    from repro_torch.core.engine import fit
    cfg = cfg._replace(spec=EngineSpec(engine="mesh", mesh_ctx=ctx,
                                       n_shards=S))
    fit(points, cfg, rng)

  paper                      | here
  ---------------------------+----------------------------------------------
  mapper = one ALID per seed | MeshEngine: each rank runs its block of the
                             | round's seeds, lanes batched
  MongoDB server holding the | replicated: dataset + LSH tables on every
  data + LSH tables          | rank's device. n_shards > 0: the shards split
                             | over the ranks (`core.store.MeshStore`)
  reducer: point -> max-     | engine.resolve_claims on the all-gathered
  density cluster            | results, on every rank
"""

from __future__ import annotations

import warnings

from repro_torch.core.alid import ALIDConfig, Clustering, EngineSpec
from repro_torch.distributed.context import MeshContext


def detect_clusters_parallel(points, cfg: ALIDConfig, rng, ctx: MeshContext,
                             k: float | None = None, n_shards: int = 0,
                             device="cuda") -> Clustering:
    """Deprecated: use `repro_torch.core.engine.fit` with engine="mesh".

    The `k=` parameter is redundant (shadowed by cfg.k) and deprecated; it
    is still honored when cfg.k is None, with a DeprecationWarning."""
    warnings.warn(
        "detect_clusters_parallel is deprecated; use "
        "repro_torch.core.engine.fit with ALIDConfig(spec=EngineSpec("
        "engine='mesh', mesh_ctx=..., n_shards=...))",
        DeprecationWarning, stacklevel=2)
    if k is not None:
        warnings.warn(
            "the k= parameter of detect_clusters_parallel is deprecated "
            "(redundant with ALIDConfig.k); set cfg.k instead",
            DeprecationWarning, stacklevel=2)
        if cfg.k is None:
            cfg = cfg._replace(k=float(k))
    from repro_torch.core.engine import fit
    spec = cfg.spec._replace(engine="mesh", n_shards=int(n_shards),
                             mesh_ctx=ctx)
    return fit(points, cfg._replace(spec=spec), rng, device=device)
