"""Live serving: the glue between `core.online.OnlineClustering` and the
continuous-batching `ClusterServer` (the JAX package's `serve/live.py` on
the port; the server's device holds the resident supports).

The online subsystem owns the MUTABLE working state (inserts, deletes,
epochs); the server owns IMMUTABLE resident snapshots (device-uploaded
supports keyed (name, version)). `LiveServing` is the one-way valve between
them:

    publish()               upload `online.to_clustering()` as the next
                            version of the tenant — new submits cut over,
                            in-flight batches finish on the old version
    commit_and_publish()    verify-gated epoch commit, then publish; the
                            tenant carries the committed epoch id
    rollback_and_publish()  restore a retained snapshot (bit-identical
                            arrays), then publish it as a NEW version —
                            serving versions only move forward even when
                            the data lineage moves back

`submit()` traffic keeps flowing throughout: swap_tenant builds device
buffers outside the server lock and the registry's latest-version default
makes the cutover atomic from the submitter's point of view (a request is
either resolved against the old snapshot or the new one, never a mix).

Typical loop (what `run_palid --online` drives):

    oc = OnlineClustering(fit(points, cfg, key), points, cfg)
    live = LiveServing(server, oc, name="events")
    live.publish()                       # epoch 0 serves
    oc.insert(batch); oc.delete(stale)
    live.commit_and_publish()            # epoch 1 serves
    live.rollback_and_publish(epoch=0)   # epoch 0 serves again (v2)
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core.online import Epoch, OnlineClustering
from repro_torch.serve.batching import ClusterServer, Tenant


class LiveServing:
    """One tenant name on one server, tracking one OnlineClustering.

    Does NOT publish at construction: the caller decides when the first
    snapshot goes live (usually right after building the server, via
    `publish()` or `commit_and_publish()`)."""

    def __init__(self, server: ClusterServer, online: OnlineClustering,
                 name: str = "default", *, threshold: float = 0.5,
                 backend: str = "auto", keep_versions: int = 2):
        self.server = server
        self.online = online
        self.name = name
        self.threshold = float(threshold)
        self.backend = backend
        self.keep_versions = int(keep_versions)

    # ---------------------------------------------------------- publishing
    def publish(self, *, rollback: bool = False) -> Tenant:
        """Snapshot the online working state and hot-swap the tenant to it.
        The tenant is tagged with the last COMMITTED epoch id — publish
        after commit/rollback (the two helpers below) to keep the tag
        honest; publishing uncommitted working state is allowed (e.g. a
        canary mid-transaction) but serves data no epoch can restore."""
        return self.server.swap_tenant(
            self.name, self.online.to_clustering(),
            epoch=self.online.epoch_id, threshold=self.threshold,
            backend=self.backend, rollback=rollback,
            keep_versions=self.keep_versions)

    def commit_and_publish(self, metadata: Optional[dict] = None
                           ) -> tuple[Epoch, Tenant]:
        """Apply → verify → commit, then cut serving over to the new epoch.
        A verify failure rolls the working state back and raises
        EpochVerifyError BEFORE anything reaches the server: the tenant
        never serves a state that failed its invariants."""
        ep = self.online.commit(metadata)
        return ep, self.publish()

    def rollback_and_publish(self, epoch: Optional[int] = None
                             ) -> tuple[int, Tenant]:
        """Restore a retained epoch (default: last committed) and publish
        it as the next serving version. Labels served afterwards are
        bit-identical to what that epoch served when it was first live."""
        eid = self.online.rollback(epoch)
        return eid, self.publish(rollback=True)

    # ------------------------------------------------------------- serving
    def submit(self, query, **kw):
        """Enqueue one query against the active (latest) published version."""
        return self.server.submit(query, tenant=self.name, **kw)

    def info(self) -> list[dict]:
        """This tenant's rows from `server.tenant_info()` (may be empty
        before the first publish)."""
        return self.server.tenant_info().get(self.name, [])
