"""The port's serving slice against the JAX package's, on the CPU:
`Clustering.predict` (single shot, batched, a MemmapSource),
`ClusterService` and `run_palid --serve-bench`, all with backend="ref"
on the JAX side and the plain versions on the port's.

The fixture is tests/test_cluster_service.py's (3 blobs of 30 points, 60
noise points, d = 8, seed 11), fitted once by the JAX package and carried
into the port with `convert.clustering_from_dict`. That fit finds 5
clusters on the 3 blobs, so the port is held to the JAX package's labels,
not to the expectations of `test_submit_serve_batch` and
`test_serve_packs_fixed_slots` (ROADMAP C).
"""

import functools
import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import torch
import pytest

from repro.core import source as jsource
from repro.core.alid import ALIDConfig, Clustering as JClustering, EngineSpec
from repro.core.engine import fit as jfit
from repro.data import auto_lsh_params, make_blobs_with_noise
from repro.launch import run_palid as jrun_palid
from repro.serve.cluster_service import ClusterService as JClusterService
from repro.utils import canonical_labels
from repro_torch import random as trandom
from repro_torch.convert import clustering_from_dict
from repro_torch.core import alid as talid
from repro_torch.core import source as tsource
from repro_torch.core.engine import fit
from repro_torch.data import synthetic as tsynthetic
from repro_torch.launch import run_palid
from repro_torch.serve import ClusterService


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the data is small, and a pool of one thread a
    core in each of several test workers oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fitted():
    spec = make_blobs_with_noise(n_clusters=3, cluster_size=30, n_noise=60,
                                 d=8, seed=11, overlap_pairs=0)
    lshp = auto_lsh_params(spec.points, probe=128)
    cfg = ALIDConfig(a_cap=48, delta=48, lsh=lshp, seeds_per_round=16,
                     max_rounds=16, spec=EngineSpec(backend="ref"))
    want = jfit(spec.points, cfg, jax.random.PRNGKey(0))
    assert want.n_clusters > 0
    return spec, want, clustering_from_dict(want.to_dict())


def _queries(spec, res):
    """Members, members jittered by 0.05, and far noise."""
    rng = np.random.default_rng(4)
    members = spec.points[res.labels >= 0]
    jitter = members + rng.normal(scale=0.05, size=members.shape)
    far = spec.points[:12] + 200.0
    return np.concatenate([members, jitter, far]).astype(np.float32)


def test_clustering_carries_across_packages(fitted, tmp_path):
    spec, want, got = fitted
    for key, value in want.to_dict().items():
        np.testing.assert_array_equal(got.to_dict()[key], value)
    q = _queries(spec, want)
    from_jax_file = talid.Clustering.load(want.save(tmp_path / "jax"))
    np.testing.assert_array_equal(from_jax_file.predict(q, device="cpu"),
                                  got.predict(q, device="cpu"))
    from_port_file = JClustering.load(got.save(tmp_path / "port"))
    np.testing.assert_array_equal(from_port_file.predict(q, backend="ref"),
                                  want.predict(q, backend="ref"))


@pytest.mark.parametrize("branch", ["single", "batched", "memmap"])
def test_predict_matches_jax(fitted, tmp_path, branch):
    """Every branch of predict gives the JAX package's labels on members,
    jittered members and far noise."""
    spec, want, got = fitted
    q = _queries(spec, want)
    expect = want.predict(q, backend="ref")
    if branch == "single":
        labels = got.predict(q, device="cpu")
    elif branch == "batched":
        labels = got.predict(q, batch_size=7, device="cpu")
        np.testing.assert_array_equal(
            want.predict(q, batch_size=7, backend="ref"), expect)
    else:
        path = tmp_path / "queries.npy"
        np.save(path, q)
        labels = got.predict(tsource.MemmapSource(path), batch_size=16,
                             device="cpu")
        np.testing.assert_array_equal(
            want.predict(jsource.MemmapSource(path), batch_size=16,
                         backend="ref"), expect)
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(labels, expect)
    assert (labels[-12:] == -1).all()                # far noise
    assert (labels[:(want.labels >= 0).sum()] >= 0).mean() > 0.9


def test_predict_on_a_single_point_and_without_clusters(fitted):
    spec, want, got = fitted
    member = spec.points[want.labels >= 0][0]
    assert got.predict(member, device="cpu").tolist() == \
        want.predict(member, backend="ref").tolist()
    empty = got._replace(densities=np.zeros(0, np.float32),
                         support_idx=got.support_idx[:0],
                         support_w=got.support_w[:0],
                         support_v=got.support_v[:0])
    assert empty.predict(spec.points[:3], device="cpu").tolist() == [-1] * 3
    bare = got._replace(support_idx=None, support_w=None, support_v=None)
    assert bare.predict(spec.points[:2], device="cpu").tolist() == [-1] * 2


def test_port_fit_then_predict_matches_jax(fitted):
    """The slice as a whole: the port's own fit, then its predict, gives
    the JAX package's fit-then-predict labels."""
    spec, want, _ = fitted
    cfg = talid.ALIDConfig(
        a_cap=48, delta=48,
        lsh=tsynthetic.auto_lsh_params(spec.points, probe=128),
        seeds_per_round=16, max_rounds=16)
    res = fit(spec.points, cfg, trandom.PRNGKey(0), device="cpu")
    np.testing.assert_array_equal(canonical_labels(res.labels),
                                  canonical_labels(want.labels))
    np.testing.assert_allclose(res.densities, want.densities, rtol=1e-5)
    q = _queries(spec, want)
    np.testing.assert_array_equal(res.predict(q, device="cpu"),
                                  want.predict(q, backend="ref"))


def test_cluster_service_matches_jax(fitted):
    """submit/serve over the query mix in 4-slot batches, and the bulk
    assign_source, give the JAX ClusterService's answers."""
    spec, want, got = fitted
    q = _queries(spec, want)
    svc = ClusterService(got, batch_slots=4, device="cpu")
    jsvc = JClusterService(want, batch_slots=4, backend="ref")
    rids = [svc.submit(v) for v in q]
    assert rids == [jsvc.submit(v) for v in q]
    out = svc.serve()
    assert out == jsvc.serve()
    assert svc.queue == []
    np.testing.assert_array_equal(np.asarray([out[r] for r in rids]),
                                  got.predict(q, device="cpu"))
    np.testing.assert_array_equal(svc.assign_source(q),
                                  jsvc.assign_source(q))


def test_service_rejects_wrong_dimension_and_serves_empty_queue(fitted):
    _, _, got = fitted
    svc = ClusterService(got, batch_slots=4, device="cpu")
    with pytest.raises(ValueError, match="point per request"):
        svc.submit(np.zeros(svc.d + 1, np.float32))
    assert svc.queue == []
    assert svc.serve() == {}
    assert svc.serve() == {}


def test_service_requires_supports():
    bare = talid.Clustering(labels=np.zeros(2, np.int32),
                            densities=np.zeros(0, np.float32), n_rounds=0,
                            k=1.0)
    with pytest.raises(ValueError, match="stored supports"):
        ClusterService(bare, device="cpu")


def test_zero_cluster_service():
    d, cap = 6, 8
    empty = talid.Clustering(
        labels=np.full(10, -1, np.int32), densities=np.zeros(0, np.float32),
        n_rounds=3, k=0.7, support_idx=np.zeros((0, cap), np.int32),
        support_w=np.zeros((0, cap), np.float32),
        support_v=np.zeros((0, cap, d), np.float32))
    svc = ClusterService(empty, batch_slots=4, device="cpu")
    rids = [svc.submit(np.ones(d, np.float32)) for _ in range(3)]
    out = svc.serve()
    assert sorted(out) == sorted(rids)
    assert all(v == -1 for v in out.values())
    assert (svc.assign_source(np.ones((7, d), np.float32)) == -1).all()


def test_partial_batch_masks_pad_slots():
    """One real request in a 4-slot batch against clusters that hug the
    origin: the three zero pad slots never leak a label, through serve()
    and through the tenant's batch call, and match the JAX service."""
    rng = np.random.default_rng(5)
    sup_v = rng.normal(scale=0.05, size=(2, 8, 6)).astype(np.float32)
    kw = dict(labels=np.zeros(4, np.int32),
              densities=np.linspace(0.6, 0.5, 2).astype(np.float32),
              n_rounds=1, k=0.5, support_idx=np.zeros((2, 8), np.int32),
              support_w=np.full((2, 8), 1.0 / 8, np.float32), support_v=sup_v)
    svc = ClusterService(talid.Clustering(**kw), batch_slots=4,
                         device="cpu")
    jsvc = JClusterService(JClustering(**kw), batch_slots=4, backend="ref")
    rid = svc.submit(sup_v[0, 0])
    jsvc.submit(sup_v[0, 0])
    out = svc.serve()
    assert set(out) == {rid} and out == jsvc.serve()
    q, valid = svc._tenant.staging(4)
    q[:] = 0.0
    valid[:] = False
    valid[0] = True
    labels = svc._tenant.assign_np(q, valid)
    assert (labels[1:] == -1).all()
    valid[:] = True
    assert (svc._tenant.assign_np(q, valid) >= 0).all()   # the trap


def _palid_line(text: str, tag: str) -> str:
    lines = [ln for ln in text.splitlines() if ln.startswith(tag)]
    assert len(lines) == 1, text
    return lines[0]


def test_run_palid_quick_serve_bench_prints_the_jax_lines(capsys,
                                                         monkeypatch):
    """`run_palid --quick --device cpu --serve-bench` prints the JAX CLI's
    two lines. Their numbers are not held equal: the --quick preset probes
    16 rows of each LSH bucket, and where a bucket holds more the two
    packages may read other windows of it (ROADMAP C), so their fits may
    differ slightly."""
    run_palid.main(["--quick", "--device", "cpu", "--serve-bench"])
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["run_palid", "--quick", "--backend",
                                      "ref", "--serve-bench"])
    jrun_palid.main()
    theirs = capsys.readouterr().out
    fit = re.compile(r"\[palid\] n=600 d=8 engine=replicated backend=\w+ "
                     r"dtype=float32 devices=1 shards=0 time=[0-9.]+s "
                     r"clusters=\d+ members=\d+ AVG-F=[0-9.]+")
    assert fit.fullmatch(_palid_line(ours, "[palid] n="))
    assert fit.fullmatch(_palid_line(theirs, "[palid] n="))
    serve = re.compile(r"\[palid\] serve n=(\d+) rate=2000rps "
                       r"p50=[0-9.]+ms p99=[0-9.]+ms tput=\d+rps "
                       r"occupancy=[0-9.]+")
    assert serve.fullmatch(_palid_line(ours, "[palid] serve"))
    assert serve.fullmatch(_palid_line(theirs, "[palid] serve")).group(1) \
        == serve.fullmatch(_palid_line(ours, "[palid] serve")).group(1)


def test_run_palid_check_writes_the_port_report(tmp_path, monkeypatch):
    """--check runs the port's checker (its runtime pass on --device),
    exits with its code, and writes CHECK_report_torch.json in the working
    directory; the JAX package's CHECK_report.json is never touched."""
    jax_report = Path(__file__).resolve().parents[1] / "CHECK_report.json"
    before = jax_report.read_bytes()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exit_:
        run_palid.main(["--check", "--device", "cpu"])
    assert exit_.value.code == 0
    report = json.loads((tmp_path / "CHECK_report_torch.json").read_text())
    assert report["ok"] is True
    assert set(report["passes"]) == {"dispatch", "concurrency", "contracts"}
    assert report["passes"]["contracts"]["kernel_side"].startswith("not run")
    assert not (tmp_path / "CHECK_report.json").exists()
    assert jax_report.read_bytes() == before


def test_run_palid_check_fails_on_a_bad_tree(tmp_path, monkeypatch):
    """In a tree whose port computes a distance privately, --check exits
    non-zero and its report names the finding."""
    bad = tmp_path / "src" / "repro_torch" / "serve"
    bad.mkdir(parents=True)
    (bad / "bad.py").write_text(
        "import torch\n\ndef f(a, b):\n    return torch.cdist(a, b)\n")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exit_:
        run_palid.main(["--check", "--device", "cpu"])
    assert exit_.value.code == 1
    report = json.loads((tmp_path / "CHECK_report_torch.json").read_text())
    assert report["ok"] is False
    assert [v["rule"] for v in report["violations"]] == ["private-distance"]
    assert report["violations"][0]["path"] == "src/repro_torch/serve/bad.py"


def test_run_palid_devices_past_the_card_count(monkeypatch):
    """--devices D puts one rank on each card: more ranks than cards is
    refused, naming the count, before any rank starts."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="this host has 1"):
        run_palid.main(["--quick", "--devices", "2"])
    with pytest.raises(ValueError, match="does not split"):
        run_palid.main(["--quick", "--device", "cpu", "--devices", "2",
                        "--shards", "3"])


_JAX_CLI: dict = {}


def _cli_full_probe(monkeypatch):
    """Both CLIs with probe 160, which covers every LSH bucket of the
    --quick data: then every engine's retrieval is exact and the two
    packages' fits agree (at the CLI's probe 16 an oversized bucket may be
    read through another window in each package, ROADMAP C)."""
    monkeypatch.setattr(run_palid, "auto_lsh_params", functools.partial(
        tsynthetic.auto_lsh_params, probe=160))
    monkeypatch.setattr(jrun_palid, "auto_lsh_params", functools.partial(
        auto_lsh_params, probe=160))


def _jax_cli_line(monkeypatch, capsys, flags) -> str:
    key = tuple(flags)
    if key not in _JAX_CLI:
        monkeypatch.setattr(sys, "argv", ["run_palid", "--quick",
                                          "--backend", "ref", *flags])
        jrun_palid.main()
        _JAX_CLI[key] = _palid_line(capsys.readouterr().out, "[palid] n=")
    return _JAX_CLI[key]


_FIT_LINE = re.compile(r"\[palid\] n=\d+ d=\d+ engine=(\w+) .* "
                       r"clusters=(\d+) members=(\d+)( AVG-F=[0-9.]+)?")


@pytest.mark.parametrize("case", ["engine-sharded", "engine-streamed",
                                  "shards", "source", "inject-faults",
                                  "checkpoint-dir", "resume",
                                  "dtype-bfloat16", "engine-mesh",
                                  "devices"])
def test_run_palid_runs_ported_flags(case, tmp_path, monkeypatch, capsys):
    """The flags the port refused before the sharded and streamed engines
    (ROADMAP A10, A11), bf16 storage (ROADMAP B P1) and the mesh engine
    (ROADMAP A13) now run, and the fit finds the JAX CLI's clusters,
    members and AVG-F (at bf16 the JAX CLI's own --dtype bfloat16 run;
    the mesh engine's against the JAX CLI's replicated run, since the JAX
    mesh engine raises on jax 0.9.0, ROADMAP C). The mesh cases spawn
    gloo ranks, which get the patched probe through the cfg the CLI
    hands them."""
    _cli_full_probe(monkeypatch)
    npy = tmp_path / "pts.npy"
    np.save(npy, make_blobs_with_noise(4, 60, 360, d=8, seed=0).points)
    ckpt = str(tmp_path / "ckpt")
    flags = {
        "engine-sharded": ["--engine", "sharded"],
        "engine-streamed": ["--engine", "streamed", "--shards", "2",
                            "--scratch-dir", str(tmp_path)],
        "shards": ["--shards", "3"],
        "source": [f"--source=memmap:{npy}"],
        "inject-faults": ["--engine", "streamed", "--shards", "2",
                          "--inject-faults",
                          "transient:0.1,corrupt:0.3,kill-reader:2"],
        "checkpoint-dir": ["--checkpoint-dir", ckpt],
        "resume": ["--checkpoint-dir", ckpt, "--resume"],
        "dtype-bfloat16": ["--dtype", "bfloat16"],
        "engine-mesh": ["--engine", "mesh", "--shards", "4", "--devices",
                        "2"],
        "devices": ["--devices", "4"],
    }[case]
    if case == "resume":          # a finished run's checkpoints to resume
        run_palid.main(["--quick", "--device", "cpu", "--checkpoint-dir",
                        ckpt])
        capsys.readouterr()
    run_palid.main(["--quick", "--device", "cpu", *flags])
    ours = capsys.readouterr().out
    # with every bucket covered every engine finds the replicated fit's
    # clusters, so the JAX CLI runs once on the replicated engine (and once
    # on the source)
    jax_flags = {"source": ["--source", f"memmap:{npy}"],
                 "dtype-bfloat16": ["--dtype", "bfloat16"]}.get(case, [])
    want = _FIT_LINE.fullmatch(_jax_cli_line(monkeypatch, capsys, jax_flags))
    got = _FIT_LINE.fullmatch(_palid_line(ours, "[palid] n="))
    assert got.group(1) == {"engine-sharded": "sharded", "shards": "sharded",
                            "engine-streamed": "streamed",
                            "inject-faults": "streamed",
                            "engine-mesh": "mesh",
                            "devices": "mesh"}.get(case, "replicated")
    assert got.group(2, 3, 4) == want.group(2, 3, 4)
    if case in ("engine-mesh", "devices"):
        # and the port's own replicated CLI's clusters
        run_palid.main(["--quick", "--device", "cpu"])
        rep = _FIT_LINE.fullmatch(_palid_line(capsys.readouterr().out,
                                              "[palid] n="))
        assert got.group(2, 3, 4) == rep.group(2, 3, 4)
    if case == "inject-faults":
        assert _palid_line(ours, "[palid] chaos").endswith(
            "fault-parity=True")
    if case in ("checkpoint-dir", "resume"):
        from repro_torch.checkpoint.manager import list_checkpoints
        assert list_checkpoints(ckpt)


@pytest.mark.parametrize("live", ["prefix", "holes", "full", "none"])
def test_occupied_prefix_serving(fitted, monkeypatch, live):
    """`Tenant.assign_np` computes only up to the last occupied slot of a
    64-slot batch: the device sees that many rows, and the labels equal
    the full masked 64-slot call's and the JAX package's Tenant's (whose
    fixed shapes are a jit concern the port does not have)."""
    from repro.serve.batching import Tenant as JTenant
    from repro_torch.kernels import ops
    from repro_torch.serve.batching import Tenant
    spec, want, got = fitted
    queries = _queries(spec, want)
    q = np.zeros((64, queries.shape[1]), np.float32)
    valid = np.zeros(64, bool)
    n = {"prefix": 5, "holes": 9, "full": 64, "none": 0}[live]
    q[:n] = queries[:n]
    valid[:n] = True
    if live == "holes":
        valid[[1, 4]] = False
    seen = []
    real = ops.assign_clusters

    def counting(qt, *a, **kw):
        seen.append(int(qt.shape[0]))
        return real(qt, *a, **kw)
    monkeypatch.setattr(ops, "assign_clusters", counting)
    labels = Tenant("t", got, device="cpu").assign_np(q, valid)
    assert seen == ([n] if n else [])
    full = talid.assign_labels(q, got.support_v, got.support_w,
                               got.densities, got.k, 0.5, valid=valid,
                               device="cpu")
    np.testing.assert_array_equal(labels, full)
    np.testing.assert_array_equal(
        labels, JTenant("t", want, backend="ref").assign_np(q, valid))
    assert (labels[~valid] == -1).all()
    if n:
        assert (labels[valid] >= 0).any()
