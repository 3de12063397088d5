"""Guards of the port's boundaries: it never imports the JAX package or
jax, its entry points run on the card unless the caller asks for the CPU,
and a kernel backend never falls back to the plain version."""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import check
from repro_torch.core import alid as talid
from repro_torch.core import baselines
from repro_torch.core.engine import fit, make_engine
from repro_torch.kernels import ops
from repro_torch.configs import get_arch
from repro_torch.convert import bst_params_from_numpy, \
    gnn_params_from_numpy, lid_state_from_numpy, lm_params_from_numpy, \
    lsh_tables_from_numpy
from repro_torch.data import graphs
from repro_torch.data.recsys import bst_batch
from repro_torch.launch import full_matrix, run_palid
from repro_torch.models import bst as bst_m
from repro_torch.models import gnn as gnn_m
from repro_torch.launch import serve as lm_serve
from repro_torch.models.moe import moe_init
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.random import PRNGKey
from repro_torch.serve import BatchServer, ClusterServer, ClusterService, \
    Tenant, generate

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")
MOE_ARCHS = ("llama4-scout-17b-16e", "kimi-k2-1t-a32b")


def _port_files():
    """The port, its chip script, and its on-card tests (which must run
    where only PyTorch is installed)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    ROOT / "tests" / "test_torch_cuda.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


def test_port_never_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in files
             if "repro_torch" in p.parts}
    assert {"kernels/affinity.py", "core/iid.py", "core/rd.py",
            "core/peeling.py", "core/baselines/sea.py",
            "core/baselines/ap.py", "core/baselines/kmeans.py",
            "core/baselines/spectral.py", "core/baselines/meanshift.py",
            "launch/full_matrix.py", "kernels/flash_attention.py",
            "models/layers.py", "models/transformer.py",
            "configs/registry.py", "configs/h2o_danube_1_8b.py",
            "configs/deepseek_7b.py", "configs/gemma2_27b.py",
            "serve/engine.py", "launch/serve.py", "convert.py",
            "kernels/embedding_bag.py", "kernels/segment_matmul.py",
            "models/bst.py", "configs/bst.py", "data/recsys.py",
            "train/steps.py", "checkpoint/manager.py", "core/online.py",
            "serve/live.py", "models/gnn.py", "data/graphs.py",
            "configs/gin_tu.py", "configs/graphsage_reddit.py",
            "configs/meshgraphnet.py", "configs/graphcast.py"} <= names
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad


def _tiny_clustering(d=4, cap=3):
    rng = np.random.default_rng(0)
    return talid.Clustering(
        labels=np.zeros(5, np.int32), densities=np.ones(2, np.float32),
        n_rounds=1, k=0.5, support_idx=np.zeros((2, cap), np.int32),
        support_w=np.full((2, cap), 1.0 / cap, np.float32),
        support_v=rng.normal(size=(2, cap, d)).astype(np.float32))


def _serve_lm_example():
    spec = importlib.util.spec_from_file_location(
        "torch_serve_lm", ROOT / "examples" / "torch_serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_points_default_to_the_card():
    """Without device=, fit, make_engine, predict, the serving layer
    (Tenant, ClusterService, ClusterServer, run_palid), the contract
    checker's runtime pass (`analysis.check`, `run_palid --check`),
    `examples/torch_serve_lm.py`, the full-matrix
    baselines (sea_detect, affinity_propagation, kmeans,
    spectral_clustering, mean_shift, full_matrix), LM serving
    (init_params, init_cache, generate, BatchServer, launch.serve; the
    MoE archs' init_params, moe_init and launch.serve --arch), BST
    (init_params, bst_batch), the GNNs (init_params, synth_graph,
    molecule_batch, synth_full_graph_batch) and the converters of JAX
    state (lm_params_from_numpy, bst_params_from_numpy,
    gnn_params_from_numpy, lsh_tables_from_numpy, lid_state_from_numpy)
    run on CUDA; where there is no card they raise instead of running on
    the CPU (the checker's runtime pass fails its report instead)."""
    pts = np.random.default_rng(0).normal(size=(40, 4)).astype(np.float32)
    serve_lm = _serve_lm_example()
    report = check.run_checks(str(ROOT), passes=("contracts",))
    res = _tiny_clustering()
    lm = get_arch("h2o-danube-1.8b").SMOKE_CONFIG
    moe_lms = [get_arch(a).SMOKE_CONFIG for a in MOE_ARCHS]
    lm_params = init_params(PRNGKey(0), lm, device="cpu")
    bst = get_arch("bst").SMOKE_CONFIG
    gnn = get_arch("gin-tu").SMOKE_CONFIG
    tree = {"w": np.ones((2, 3), np.float32), "blocks": [{"b": np.zeros(2)}]}
    gnn_tree = {"w": np.ones((2, 3), np.float32),
                "layers": {"eps": np.zeros(2, np.float32)}}
    if torch.cuda.is_available():
        assert gnn_m.init_params(PRNGKey(0), gnn)["decoder"]["w0"].is_cuda
        assert graphs.synth_graph(9, 20).indices.is_cuda
        assert graphs.molecule_batch(2, 3, 4, 2, 2, 0, 0)["edge_src"].is_cuda
        assert graphs.synth_full_graph_batch(
            9, 20, 2, "node_ce", 2, 0)["node_feat"].is_cuda
        assert gnn_params_from_numpy(gnn_tree)["layers"][1]["eps"].is_cuda
        assert bst_m.init_params(PRNGKey(0), bst)["mlp"]["w0"].is_cuda
        assert bst_batch(0, batch=2, seq_len=3, item_vocab=9,
                         cat_vocab=4)["seq_items"].is_cuda
        assert lm_params_from_numpy(tree)["w"].is_cuda
        assert bst_params_from_numpy(tree)["blocks"][0]["b"].is_cuda
        assert make_engine(talid.EngineSpec()).device.type == "cuda"
        assert Tenant("t", res).device.type == "cuda"
        with ClusterServer() as server:
            assert server.device.type == "cuda"
        assert init_params(PRNGKey(0), lm)["embed"].device.type == "cuda"
        for cfg in moe_lms:
            moe = init_params(PRNGKey(0), cfg)["blocks"]["layer0"]["moe"]
            assert moe["w_gate"].is_cuda and moe["router"].is_cuda
            assert moe_init(PRNGKey(0), cfg.moe, 8, torch.float32)[
                "w_up"].is_cuda
        assert BatchServer(lm_params, lm).device.type == "cuda"
        with pytest.raises(ValueError, match="params lie on cpu"):
            generate(lm_params, lm, np.zeros((1, 3), np.int32))
        assert report.pass_info["contracts"]["device"].startswith("cuda")
        assert report.pass_info["contracts"]["ops_shape_checked"] == 10
        assert len(serve_lm.main([])) == 10
        return
    assert not report.ok
    assert [v.rule for v in report.violations] == ["no-device"]
    calls = [lambda: make_engine(talid.EngineSpec()),
             lambda: fit(pts, talid.ALIDConfig(max_rounds=1)),
             lambda: res.predict(pts),
             lambda: Tenant("t", res),
             lambda: ClusterService(res),
             lambda: ClusterServer(start=False),
             lambda: run_palid.main(["--quick"]),
             lambda: serve_lm.main([]),
             lambda: baselines.sea_detect(pts, 0.5),
             lambda: baselines.affinity_propagation(pts),
             lambda: baselines.kmeans(pts, 3),
             lambda: baselines.spectral_clustering(pts, 3, 0.5),
             lambda: baselines.mean_shift(pts, 1.0),
             lambda: full_matrix.main(["--n-clusters", "2"]),
             lambda: init_params(PRNGKey(0), lm),
             lambda: init_cache(lm, 1, 4),
             lambda: generate(lm_params, lm, np.zeros((1, 3), np.int32)),
             lambda: BatchServer(lm_params, lm),
             lambda: lm_serve.main([]),
             *[lambda a=a: lm_serve.main(["--arch", a]) for a in MOE_ARCHS],
             *[lambda c=c: init_params(PRNGKey(0), c) for c in moe_lms],
             *[lambda c=c: moe_init(PRNGKey(0), c.moe, 8, torch.float32)
               for c in moe_lms],
             lambda: bst_m.init_params(PRNGKey(0), bst),
             lambda: bst_batch(0, batch=2, seq_len=3, item_vocab=9,
                               cat_vocab=4),
             lambda: gnn_m.init_params(PRNGKey(0), gnn),
             lambda: graphs.synth_graph(9, 20),
             lambda: graphs.molecule_batch(2, 3, 4, 2, 2, 0, 0),
             lambda: graphs.synth_full_graph_batch(9, 20, 2, "node_ce", 2,
                                                   0),
             lambda: gnn_params_from_numpy(gnn_tree),
             lambda: lm_params_from_numpy(tree),
             lambda: bst_params_from_numpy(tree),
             lambda: lsh_tables_from_numpy(np.ones((1, 1, 2)), np.ones((1, 1)),
                                           np.ones((1, 3)), np.ones((1, 3))),
             lambda: lid_state_from_numpy(*[np.ones(3)] * 7)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _cpu_args():
    rng = np.random.default_rng(0)
    v = torch.tensor(rng.normal(size=(2, 8, 4)).astype(np.float32))
    idx = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    mask = torch.ones((2, 8), dtype=torch.bool)
    x = torch.zeros((2, 8))
    x[:, 0] = 1.0
    return dict(
        lsh_hash=lambda b: ops.lsh_hash(v[0], torch.ones(2, 3, 4),
                                        torch.zeros(2, 3), 1.0, backend=b),
        roi_filter=lambda b: ops.roi_filter(v, v[:, 0], torch.ones(2), mask,
                                            backend=b),
        affinity_matvec=lambda b: ops.affinity_matvec(v, idx, v, idx, x, 0.5,
                                                      backend=b),
        lid_sweep=lambda b: ops.lid_sweep(
            v, idx, mask, x, x.clone(), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.bool), 0.5, n_steps=2, max_iters=4,
            tol=1e-5, backend=b),
        pairwise_distance=lambda b: ops.pairwise_distance(v[0], v[1],
                                                          backend=b),
        assign=lambda b: ops.assign_clusters(v[0], v, x, torch.ones(2), 0.5,
                                             0.5, backend=b),
        affinity=lambda b: ops.affinity(v, v[:, :3], 0.5, backend=b),
        flash_attention=lambda b: ops.flash_attention(
            v[:, None], v[:, None], v[:, None], 0, window=3, backend=b),
        embedding_bag=lambda b: ops.embedding_bag(
            v[0], idx[0], idx[1] // 3, 3, backend=b),
        segment_matmul=lambda b: ops.segment_matmul(v[0], idx[0] - 1, 5,
                                                    backend=b),
    )


@pytest.mark.parametrize("op", ["lsh_hash", "roi_filter", "affinity_matvec",
                                "lid_sweep", "pairwise_distance", "assign",
                                "affinity", "flash_attention",
                                "embedding_bag", "segment_matmul"])
def test_kernel_backend_on_cpu_raises(op):
    call = _cpu_args()[op]
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        call("kernel")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        call("pallas")
    call("ref")
    call("auto")                      # the plain version, on the CPU
    assert ops.launch_counts() == before


@pytest.mark.parametrize("op", ["roi_filter", "affinity_matvec",
                                "lid_sweep", "affinity"])
def test_kernel_path_refuses_other_norms(op, monkeypatch):
    """The kernels compute p = 2 only. Where an op would take the kernel
    path (forced here on a CPU tensor, as a CUDA tensor would be), p = 1
    raises before any kernel or plain version runs; on the plain path the
    same call computes the p = 1 result."""
    rng = np.random.default_rng(1)
    v = torch.tensor(rng.normal(size=(2, 8, 4)).astype(np.float32))
    idx = torch.arange(8, dtype=torch.int32).repeat(2, 1)
    mask = torch.ones((2, 8), dtype=torch.bool)
    x = torch.full((2, 8), 1.0 / 8)
    calls = dict(
        roi_filter=lambda b: ops.roi_filter(v, v[:, 0], torch.ones(2), mask,
                                            p=1.0, backend=b),
        affinity_matvec=lambda b: ops.affinity_matvec(
            v, idx, v, idx, x, 0.5, p=1.0, backend=b),
        lid_sweep=lambda b: ops.lid_sweep(
            v, idx, mask, x, x.clone(), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.bool), 0.5, n_steps=2, max_iters=4,
            tol=1e-5, p=1.0, backend=b),
        affinity=lambda b: ops.affinity(v, v, 0.5, p=1.0, backend=b),
    )
    out = calls[op]("ref")
    assert all(torch.isfinite(t.float()).any() for t in
               (out if isinstance(out, tuple) else (out,)))
    before = ops.launch_counts()
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, t: "kernel")
    with pytest.raises(NotImplementedError, match="p=1.0"):
        calls[op]("auto")
    assert ops.launch_counts() == before


def test_affinity_kernel_path_takes_f32_only(monkeypatch):
    """bf16 storage waits for its ROADMAP item: where ops.affinity would
    take the kernel path, a bf16 input raises before anything launches."""
    v = torch.ones((4, 3), dtype=torch.bfloat16)
    assert ops.affinity(v, v, 0.5).dtype == torch.bfloat16    # plain path
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, t: "kernel")
    before = ops.launch_counts()
    with pytest.raises(TypeError, match="float32"):
        ops.affinity(v, v, 0.5)
    assert ops.launch_counts() == before


def test_fit_refuses_other_norms_on_the_kernel_path(monkeypatch):
    """On the plain path (the CPU) p = 1 runs; where fit would take the
    kernel path it raises before it builds the LSH tables."""
    pts = np.random.default_rng(0).normal(size=(40, 4)).astype(np.float32)
    cfg = talid.ALIDConfig(p=1.0, max_rounds=1, a_cap=8, delta=8,
                           seeds_per_round=2)
    res = fit(pts, cfg, device="cpu")
    assert res.labels.shape == (40,)
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, t: "kernel")
    monkeypatch.setattr(
        "repro_torch.core.engine.ReplicatedEngine.build_source",
        lambda *a: pytest.fail("built before refusing p=1"))
    with pytest.raises(NotImplementedError, match="p=1.0"):
        fit(pts, cfg, device="cpu")


@pytest.mark.cuda
def test_fit_on_card_refuses_other_norms():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pts = np.random.default_rng(0).normal(size=(40, 4)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="p=1.0"):
        fit(pts, talid.ALIDConfig(p=1.0, max_rounds=1), device="cuda")
