"""Cluster serving: the synchronous `ClusterService` and the continuous-
batching, multi-tenant `ClusterServer`. The JAX package's LM `BatchServer`
and `LiveServing` are not ported yet (ROADMAP A16, A12)."""
from repro_torch.serve.batching import (ClusterServer, DeadlineExceeded,  # noqa: F401
                                        QueueFull, ServingStats,
                                        ShutdownTimeout, Tenant, WorkerDied,
                                        run_open_loop)
from repro_torch.serve.cluster_service import ClusterService  # noqa: F401
