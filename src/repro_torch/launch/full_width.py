"""The full-width configuration: the one workload `chip_smoke.py` times and
`profile_fit` profiles.

SIFT1M's shape (1,000,000 x 128 f32; Jegou et al., "Product quantization
for nearest neighbor search", ANN_SIFT1M base set) in the paper's
size-limited regime (Sec. 5.2, a* << n): 5,000 Gaussian blobs of 80 points
plus 600,000 uniform noise points, LSH parameters from `auto_lsh_params`,
and the CLI's defaults a_cap = max(64, cluster_size + 32), delta = 128,
32 seeds per round, 64 rounds.
"""

from __future__ import annotations

from repro_torch.core.alid import ALIDConfig
from repro_torch.data import (SyntheticSpec, auto_lsh_params,
                              make_blobs_with_noise)
from repro_torch.lsh.pstable import LSHParams

DATA = dict(n_clusters=5000, cluster_size=80, n_noise=600_000, d=128,
            seed=0)
MAX_ROUNDS = 64


def data() -> tuple[SyntheticSpec, LSHParams]:
    """The points, their planted labels, and the LSH parameters."""
    spec = make_blobs_with_noise(**DATA)
    return spec, auto_lsh_params(spec.points)


def config(lsh: LSHParams, max_rounds: int = MAX_ROUNDS) -> ALIDConfig:
    return ALIDConfig(a_cap=max(64, DATA["cluster_size"] + 32), delta=128,
                      lsh=lsh, seeds_per_round=32, max_rounds=max_rounds)
