"""Serving: the LM `BatchServer` with `generate` and `ServeConfig`
(`serve.engine`), the synchronous `ClusterService`, the continuous-
batching, multi-tenant `ClusterServer`, and `LiveServing`, which hot-swaps
an `OnlineClustering`'s committed epochs into a `ClusterServer` tenant."""
from repro_torch.serve.batching import (ClusterServer, DeadlineExceeded,  # noqa: F401
                                        QueueFull, ServingStats,
                                        ShutdownTimeout, Tenant, WorkerDied,
                                        run_open_loop)
from repro_torch.serve.cluster_service import ClusterService  # noqa: F401
from repro_torch.serve.engine import BatchServer, ServeConfig, generate  # noqa: F401
from repro_torch.serve.live import LiveServing  # noqa: F401
