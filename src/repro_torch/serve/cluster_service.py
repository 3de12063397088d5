"""Synchronous fixed-slot clustering query service: submit/serve assignment
of new points to detected dominant clusters (the port of the JAX package's
`serve/cluster_service.py`).

This is the caller-paced sibling of `serve.batching.ClusterServer` (the
continuous-batching, multi-tenant server): requests queue up, each serve()
call packs up to `batch_slots` queries into one fixed-shape batch and runs
the fused assignment op. Both paths share ONE resident-store implementation
(`serve.batching.Tenant`) and therefore the same padding contract: packed
batches carry a slot-validity mask, so empty slots — zero rows, i.e. what
would otherwise be real points at the origin — can never produce a label,
even where a cluster sits near the origin.

`Clustering.predict` is O(C * cap) per query independent of the original
dataset size, which is exactly what ALID's localized design (paper Sec. 4)
buys at serving time.

Usage:
    clustering = engine.fit(points, cfg, rng)
    svc = ClusterService(clustering, batch_slots=8)   # on the card
    rid = svc.submit(query_vec)
    labels = svc.serve()          # {rid: cluster id, -1 = no cluster}

For async futures, open-loop traffic, or several resident datasets/versions
in one process, use `serve.batching.ClusterServer` instead.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.alid import Clustering
from repro_torch.serve.batching import Tenant


class ClusterService:
    """Fixed-slot batched assignment server over a fitted Clustering.

    Requests queue up; each serve() call packs up to `batch_slots` queries
    into one fixed-shape batch (zero-padded rows + slot-validity mask) and
    runs one batched assignment — the FUSED kernel-layer op
    (`repro_torch.kernels.ops.assign_clusters`: support affinity + weighted
    score + argmax + threshold, the `assign` kernel on the card), on the
    backend `backend` selects ("auto" = the kernel for the card, the plain
    version on the CPU; see `repro_torch.kernels.ops.resolve_backend`).
    The supports are uploaded to `device` once at construction (inside
    `Tenant`), never per batch.
    """

    def __init__(self, clustering: Clustering, batch_slots: int = 8,
                 threshold: float = 0.5, backend: str = "auto",
                 device="cuda"):
        if clustering.support_v is None:
            raise ValueError("ClusterService needs a Clustering with stored "
                             "supports (produced by "
                             "repro_torch.core.engine.fit)")
        self.clustering = clustering
        self.batch_slots = batch_slots
        self.threshold = threshold
        self.backend = backend
        self._tenant = Tenant("default", clustering, threshold=threshold,
                              backend=backend, device=device)
        self.d = self._tenant.d
        self.queue: list[tuple[int, np.ndarray]] = []
        self._next_id = 0

    def submit(self, query: np.ndarray) -> int:
        q = self._tenant.check_query(query)
        rid = self._next_id
        self._next_id += 1
        self.queue.append((rid, q))
        return rid

    def assign_source(self, source, batch_size: int = 0) -> np.ndarray:
        """Bulk assignment over a whole DataSource (or array, auto-wrapped):
        labels for every row, streamed through fixed-shape batches against
        the pre-uploaded support tensors. This is the offline counterpart of
        submit/serve — labeling a 10M-point memmap costs O(batch · C · cap)
        peak memory, never O(n)."""
        return self._tenant.assign_source(
            source, batch_size=int(batch_size) or max(self.batch_slots, 256))

    def serve(self) -> dict[int, int]:
        """Drain the queue in fixed-size batches; {} when nothing is queued.
        Pad slots ride along masked-invalid and never produce a label."""
        results: dict[int, int] = {}
        while self.queue:
            batch = self.queue[:self.batch_slots]
            self.queue = self.queue[self.batch_slots:]
            q, valid = self._tenant.staging(self.batch_slots)
            q[:] = 0.0
            valid[:] = False
            for i, (_, v) in enumerate(batch):
                q[i] = v
                valid[i] = True
            labels = self._tenant.assign_np(q, valid)
            for i, (rid, _) in enumerate(batch):
                results[rid] = int(labels[i])
        return results
