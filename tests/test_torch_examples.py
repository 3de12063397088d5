"""The port's examples run on the CPU: `examples/torch_quickstart.py`, the
twin of `examples/quickstart.py`, with --device cpu --quick finds the
clusters and AVG-F of the JAX package's replicated fit on the same data
and config (what `examples/quickstart.py --quick` prints first), and its
sharded and streamed fits give the replicated fit's labels;
`examples/torch_gnn_cluster.py`, the twin of `examples/gnn_cluster.py`,
with --device cpu embeds the same graph as the JAX example and finds
clusters; `examples/torch_palid_pipeline.py`, the twin of
`examples/palid_pipeline.py`, fits over two gloo ranks."""

import importlib
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


def test_torch_gnn_cluster_runs_on_the_cpu(capsys):
    """`examples/torch_gnn_cluster.py --device cpu`: an untrained SAGE
    embeds the community graph, within f32 rounding of the JAX example's
    embedding, and the port's fit finds clusters on it. Its cluster count
    is printed beside the JAX example's: the embeddings differ in the last
    bits and the LSH salts fold them (ROADMAP C), so the counts may
    differ."""
    spec = importlib.util.spec_from_file_location(
        "torch_gnn_cluster", EXAMPLES / "torch_gnn_cluster.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res, f = mod.main(["--device", "cpu"])
    ours = capsys.readouterr().out
    assert re.search(r"ALID found (\d+) dominant node clusters", ours) \
        .group(1) == str(res.n_clusters)
    assert res.n_clusters > 0 and 0.0 < f <= 1.0
    assert np.isfinite(res.densities).all()

    from repro.models import gnn as jgnn
    feats, src, dst, comm = mod.community_graph()
    cfg = jgnn.GNNConfig(name="sage-demo", kind="sage", n_layers=2,
                         d_hidden=32, d_in=feats.shape[1], n_out=16,
                         remat=False)
    jemb = np.asarray(jgnn.forward(
        jgnn.init_params(jax.random.PRNGKey(0), cfg), cfg,
        jgnn.GraphBatch(node_feat=feats, edge_src=src, edge_dst=dst)))
    from repro_torch.models import gnn as tgnn
    from repro_torch.random import PRNGKey
    tcfg = tgnn.GNNConfig(name="sage-demo", kind="sage", n_layers=2,
                          d_hidden=32, d_in=feats.shape[1], n_out=16,
                          remat=False)
    temb = tgnn.forward(
        tgnn.init_params(PRNGKey(0), tcfg, device="cpu"), tcfg,
        tgnn.GraphBatch(node_feat=torch.tensor(feats),
                        edge_src=torch.tensor(src),
                        edge_dst=torch.tensor(dst))).numpy()
    assert np.abs(temb - jemb).max() <= 1e-5 * np.abs(jemb).max()
    from repro.data import auto_lsh_params as jax_lsh_params
    want = jfit(jemb, ALIDConfig(a_cap=96, delta=96,
                                 lsh=jax_lsh_params(jemb),
                                 seeds_per_round=16, max_rounds=30),
                jax.random.PRNGKey(1))
    print(f"torch_gnn_cluster: {res.n_clusters} clusters, AVG-F {f:.3f}; "
          f"examples/gnn_cluster.py: {want.n_clusters} clusters, AVG-F "
          f"{avg_f1_score(comm, want.labels):.3f}")
    assert want.n_clusters > 0


def test_torch_palid_pipeline_on_two_gloo_ranks(capsys, monkeypatch):
    """`examples/torch_palid_pipeline.py --device cpu --devices 2` at n =
    600: the mesh fit over two spawned gloo ranks gives the example's own
    one-process fit bit for bit (labels, densities, rounds). The JAX
    example's serial fit on the same data is not held equal: the --quick
    scale's LSH probe of 16 reads other windows of an oversized bucket in
    each package (ROADMAP C)."""
    # the spawned ranks import the example by its module name
    monkeypatch.syspath_prepend(str(EXAMPLES))
    mod = importlib.import_module("torch_palid_pipeline")
    mesh, f_mesh = mod.main(["--device", "cpu", "--n", "600", "--devices",
                             "2"])
    serial, f_serial = mod.main(["--device", "cpu", "--n", "600"])
    out = capsys.readouterr().out
    assert "PALID x2" in out and "ALID serial" in out
    assert mesh.n_clusters > 0 and f_mesh == f_serial
    np.testing.assert_array_equal(mesh.labels, serial.labels)
    np.testing.assert_array_equal(mesh.densities, serial.densities)
    assert mesh.n_rounds == serial.n_rounds
