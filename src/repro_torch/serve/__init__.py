"""Serving: the LM `BatchServer` with `generate` and `ServeConfig`
(`serve.engine`), the synchronous `ClusterService` and the continuous-
batching, multi-tenant `ClusterServer`. The JAX package's `LiveServing`
is not ported yet (ROADMAP A12)."""
from repro_torch.serve.batching import (ClusterServer, DeadlineExceeded,  # noqa: F401
                                        QueueFull, ServingStats,
                                        ShutdownTimeout, Tenant, WorkerDied,
                                        run_open_loop)
from repro_torch.serve.cluster_service import ClusterService  # noqa: F401
from repro_torch.serve.engine import BatchServer, ServeConfig, generate  # noqa: F401
