"""The port's examples run on the CPU: `examples/torch_quickstart.py`, the
twin of `examples/quickstart.py`, with --device cpu --quick finds the
clusters and AVG-F of the JAX package's replicated fit on the same data
and config (what `examples/quickstart.py --quick` prints first), and its
sharded and streamed fits give the replicated fit's labels."""

import importlib.util
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.alid import ALIDConfig, EngineSpec
from repro.core.engine import fit as jfit
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.utils import avg_f1_score

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the data is small, and a pool of one thread a
    core in each of several test workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_torch_quickstart_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", EXAMPLES / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res, agree_shd, agree_stm = mod.main(["--device", "cpu", "--quick"])
    ours = capsys.readouterr().out
    assert "predict(far noise) = [-1, -1, -1, -1, -1, -1, -1, -1]" in ours
    assert agree_shd == agree_stm == 1.0
    # examples/quickstart.py --quick's data and replicated fit
    data = make_blobs_with_noise(n_clusters=4, cluster_size=24, n_noise=100,
                                 d=24, seed=42)
    want = jfit(data.points, ALIDConfig(
        a_cap=48, delta=96, lsh=auto_lsh_params(data.points, probe=128),
        seeds_per_round=16, max_rounds=24,
        spec=EngineSpec(engine="replicated", backend="ref")),
        jax.random.PRNGKey(0))
    assert re.search(r"ALID: (\d+) dominant clusters", ours).group(1) == \
        str(want.n_clusters)
    assert re.search(r"ALID AVG-F = ([0-9.]+)", ours).group(1) == \
        f"{avg_f1_score(data.labels, want.labels):.3f}"
    assert np.isfinite(res.densities).all()
