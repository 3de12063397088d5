"""Self-tests for the port's checker, `repro_torch.analysis`: every pass must
flag its deliberately-bad fixture (torch snippets) AND stay clean on the
real tree; the twins of tests/test_analysis.py's dispatch, pragma,
concurrency, repo and CLI tests, plus the shared-memory rule, the runtime
pass on the CPU and the poison scenarios on the plain versions. No jax."""

import ast
import json
import os
import textwrap

import pytest
import torch

from repro_torch.analysis import check, concurrency, contracts, dispatch
from repro_torch.analysis.pragmas import PragmaCache, PragmaIndex
from repro_torch.analysis.report import Report

ROOT = check.find_repo_root(os.path.dirname(__file__))


def _violations(pass_mod, rel, src):
    src = textwrap.dedent(src)
    return pass_mod.check_source(rel, src, ast.parse(src),
                                 PragmaIndex(rel, src))


def _rules(vs, active_only=True):
    return sorted({v.rule for v in vs if not (active_only and v.suppressed)})


# ------------------------------------------------------------- dispatch ----
def test_dispatch_flags_private_matmul():
    vs = _violations(dispatch, "src/repro_torch/core/bad.py", """
        import torch
        def f(a, b):
            return torch.einsum("id,jd->ij", a, b), torch.mm(a, b.T)
        """)
    assert _rules(vs) == ["private-matmul"]
    assert len(vs) == 2


def test_dispatch_matmul_scope_excludes_model_stack():
    vs = _violations(dispatch, "src/repro_torch/models/ok.py", """
        import torch
        def f(a, b):
            return torch.einsum("id,jd->ij", a, b) + a @ b.T
        """)
    assert _rules(vs) == []


def test_dispatch_flags_distance_expansion_and_norm():
    vs = _violations(dispatch, "examples/torch_bad.py", """
        import torch
        import torch.nn.functional as F
        from torch import linalg
        def f(a, b):
            d2 = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, -1)
            n = linalg.norm(a - b)
            return d2, n, torch.cdist(a, b), F.pairwise_distance(a, b)
        """)
    assert _rules(vs) == ["private-distance"]
    assert len(vs) == 4


def test_dispatch_flags_hand_rolled_lsh():
    vs = _violations(dispatch, "src/repro_torch/lsh/bad.py", """
        import torch
        MUL = 0x9E3779B1
        def bucket(x, seg):
            return torch.floor(x / seg)
        """)
    assert _rules(vs) == ["private-lsh"]
    assert len(vs) == 2          # the constant AND the floor(div)


def test_pragma_requires_reason():
    src = textwrap.dedent("""
        import torch
        def f(a, b):
            # analysis: allow(private-matmul)
            return torch.dot(a, b)
        """)
    idx = PragmaIndex("src/repro_torch/core/bad.py", src)
    assert [v.rule for v in idx.errors] == ["pragma-missing-reason"]
    vs = dispatch.check_source("src/repro_torch/core/bad.py", src,
                               ast.parse(src), idx)
    assert _rules(vs) == ["private-matmul"]     # reasonless pragma is inert


def test_pragma_with_reason_suppresses_but_stays_reported():
    vs = _violations(dispatch, "src/repro_torch/core/ok.py", """
        import torch
        def f(a, b):
            # analysis: allow(private-matmul): documented comparison arm
            return torch.dot(a, b)
        """)
    assert _rules(vs) == []
    assert [v.reason for v in vs if v.suppressed] == [
        "documented comparison arm"]


def test_pragma_cache_reports_malformed_once():
    report = Report(ROOT)
    cache = PragmaCache(report)
    src = "x = 1  # analysis: allow(private-matmul)\n"
    cache.get("a.py", src)
    cache.get("a.py", src)
    assert len(report.violations) == 1


# ---------------------------------------------------------- concurrency ----
def test_concurrency_flags_transfer_and_future_under_lock():
    vs = _violations(concurrency, "src/repro_torch/serve/bad.py", """
        import threading
        import torch
        class S:
            def __init__(self):
                self._lock = threading.Lock()
            def convert(self, q):
                return torch.as_tensor(q)
            def submit(self, q, fut):
                with self._lock:
                    vec = self.convert(q)      # heavy helper under lock
                    arr = torch.tensor(q)      # direct transfer under lock
                    fut.set_result(1)          # callback under lock
                return vec, arr
        """)
    assert _rules(vs) == ["future-under-lock", "transfer-under-lock"]
    assert len([v for v in vs if v.rule == "transfer-under-lock"]) == 2


def test_concurrency_flags_tensor_methods_under_lock():
    """The torch transfers the JAX lint has no names for: .cpu(), .cuda(),
    .numpy(), .item(), .tolist(), and .to() given a device or a dtype."""
    vs = _violations(concurrency, "src/repro_torch/serve/bad.py", """
        import torch
        def f(s, t, dev):
            with s._lock:
                a = t.cpu(); b = t.item(); c = t.to(dev)
                d = t.to(dtype=torch.float32); e = t.numpy()
                torch.cuda.synchronize()
            return t.to(dev), t.tolist()     # outside the lock: legal
        """)
    assert _rules(vs) == ["transfer-under-lock"]
    assert len(vs) == 6


def test_concurrency_flags_unlocked_mutation():
    vs = _violations(concurrency, "src/repro_torch/serve/bad.py", """
        import threading
        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0
            def hit(self):
                self.n += 1
            def safe(self):
                with self._lock:
                    self.n += 1
        """)
    assert _rules(vs) == ["unlocked-mutation"]
    assert len(vs) == 1          # __init__ stores and locked += are legal


def test_concurrency_flags_lock_order_inversion():
    vs = _violations(concurrency, "src/repro_torch/core/bad.py", """
        def a(s):
            with s._lock:
                with s._cache_lock:
                    pass
        def b(s):
            with s._cache_lock:
                with s._lock:
                    pass
        """)
    assert "lock-order" in _rules(vs)


def _tree_violations(rel, src):
    src = textwrap.dedent(src)
    return concurrency.check_tree_rules(rel, src, ast.parse(src),
                                        PragmaIndex(rel, src))


def test_concurrency_flags_join_without_timeout():
    vs = _tree_violations("src/repro_torch/core/bad.py", """
        def stop(worker):
            worker.join()
        def ok(worker):
            worker.join(5.0)
            worker.join(timeout=1.0)
        def strings(parts):
            return ",".join(parts)      # has args: not a thread join
        """)
    assert _rules(vs) == ["join-no-timeout"]
    assert len(vs) == 1


def test_concurrency_flags_retry_without_backoff():
    vs = _tree_violations("src/repro_torch/core/bad.py", """
        def spin(fetch):
            while True:
                try:
                    return fetch()
                except OSError:
                    pass                 # hot-spins, no delay
        def bounded(fetch, n):
            for attempt in range(n):
                try:
                    return fetch()
                except OSError:
                    continue             # bounded but still no delay
        """)
    assert _rules(vs) == ["retry-no-backoff"]
    assert len(vs) == 2


def test_concurrency_retry_with_backoff_is_clean():
    vs = _tree_violations("src/repro_torch/core/ok.py", """
        import time
        def retried(fetch, n):
            for attempt in range(n):
                try:
                    return fetch()
                except OSError:
                    if attempt == n - 1:
                        raise
                time.sleep(0.1 * 2 ** attempt)
        def consumer(q, stop):
            while not stop.is_set():
                try:
                    return q.get_nowait()
                except KeyError:
                    stop.wait(0.05)      # cond wait counts as backoff
        def plain_loop(items):
            for item in items:           # not a retry loop: no try at all
                yield item
        """)
    assert _rules(vs) == []


# ------------------------------------------------------- real-tree gate ----
def test_source_passes_clean_on_repo():
    """The gate invariant: zero unsuppressed source-pass violations on the
    tree as committed, every suppression carrying a reason that names its
    JAX twin or its cause."""
    report = check.run_checks(ROOT, passes=check.SOURCE_PASSES)
    assert report.ok, "\n" + report.summary()
    assert report.suppressed
    assert all(v.reason and ("repro/" in v.reason or "not" in v.reason)
               for v in report.suppressed)


def test_contract_shapes_clean_on_repo():
    """On the CPU every op's plain side runs and the kernel side is
    recorded as not run, with the reason; nothing passes silently."""
    report = Report(ROOT)
    contracts.check_shapes(report, "cpu")
    assert report.ok, "\n" + report.summary()
    info = report.pass_info["contracts"]
    assert info["ops_ref_run"] == len(contracts.OP_CASES) == 10
    assert info["ops_shape_checked"] == 0
    assert info["kernel_side"].startswith("not run")


def test_smem_estimator_reads_plans():
    """Each kernel's dynamic shared bytes come from its own plan at the
    contract cases and at the main path's full-width shapes; all fit
    sm_90's 232,448 bytes a block."""
    from repro_torch.kernels import affinity, affinity_matvec, assign, \
        lid_sweep, lsh_hash
    report = Report(ROOT)
    contracts.check_smem(report, "cpu")
    assert report.ok, "\n" + report.summary()
    info = report.pass_info["contracts"]
    usage = info["smem_bytes_by_op"]
    assert set(usage) == {c.name for c in contracts.OP_CASES
                          if c.has_kernel} | {"flash_attention_bwd",
                                              "segment_matmul_bwd",
                                              "embedding_bag_bwd"}
    assert all(0 <= b <= contracts.SMEM_BUDGET for b in usage.values())
    assert info["static_smem_by_source"].startswith("not run")
    assert usage["lid_sweep"] == lid_sweep.plan(32, 240, 128).smem
    assert usage["affinity_matvec"] == affinity_matvec.plan(240, 240,
                                                            128).smem
    assert usage["affinity"] == affinity.plan(40_000, 40_000, 128,
                                              True).smem
    assert usage["assign_clusters"] == assign.plan(64, 2048, 240, 128).smem
    from repro_torch.kernels.flash_attention import bwd_plan
    assert usage["flash_attention_bwd"] == max(
        max(p.dq_smem, p.dkdv_smem) for p in (
            bwd_plan(h, kv, s, s, dh) for h, kv, s, dh in (
                (32, 8, 5120, 80), (32, 16, 4096, 128), (40, 8, 9216, 128),
                (12, 4, 256, 64), (4, 4, 100, 256), (8, 8, 21, 4))))
    assert usage["lsh_hash"] == max(lsh_hash.plan(n, d, L, m).smem for
                                    n, d, L, m in ((32, 8, 4, 3),
                                                   (1_000_000, 128, 4, 8),
                                                   (3584, 128, 4, 8)))
    routes = {(r["op"], r["route"]) for r in info["smem_cases"]}
    assert {("flash_attention", k) for k in
            ("tiles", "wgmma", "split", "small")} <= routes
    assert {("lsh_hash", "stream"), ("lsh_hash", "probe"),
            ("affinity", "symmetric"), ("affinity", "general"),
            ("assign_clusters", "tiles"),
            ("assign_clusters", "lanes")} <= routes


def test_smem_budget_violation_fires():
    report = Report(ROOT)
    contracts.check_smem(report, "cpu", budget=1)  # no plan fits 1 byte
    rules = {v.rule for v in report.violations}
    assert rules == {"smem-budget"}
    over = {v.message.split(" at ")[0] for v in report.violations}
    assert over == {"lsh_hash", "affinity_matvec", "lid_sweep",
                    "assign_clusters", "affinity", "flash_attention",
                    "flash_attention_bwd"}


def test_smem_budget_fires_on_a_plan_past_the_card():
    """A plan past the card's limit is reported, whether its bytes exceed
    the budget or the plan itself finds no block that holds it."""
    from repro_torch.kernels import affinity_matvec
    report = Report(ROOT)
    contracts.check_smem(report, "cpu", cases=(
        ("affinity_matvec", "fake 300,000-byte plan",
         lambda: ("smem", 300_000, "affinity_matvec")),
        ("lid_sweep", "cap 9,000 lanes",
         lambda: contracts._plan("lid_sweep", 1, 9000, 8)),
        ("affinity_matvec", "32 x 240 x 240 x 128",
         lambda: contracts._plan("affinity_matvec", 240, 240, 128))))
    assert [v.rule for v in report.violations] == ["smem-budget"] * 2
    assert report.pass_info["contracts"]["smem_bytes_by_op"] == {
        "affinity_matvec": 300_000}
    assert affinity_matvec.plan(240, 240, 128).smem < 300_000


def test_contracts_pass_on_the_cpu_records_the_kernel_side_not_run():
    report = Report(ROOT)
    contracts.run(ROOT, report, device="cpu")
    assert report.ok, "\n" + report.summary()
    info = report.pass_info["contracts"]
    assert info["device"] == "cpu"
    assert info["poison_runs_by_backend"] == {"ref": 10}
    assert "kernel" not in info["poison_runs_by_backend"]
    assert info["kernel_side"].startswith("not run")


def test_contracts_pass_without_a_card_fails(monkeypatch):
    """Asked for the card on a host with none, the runtime pass fails; it
    does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    report = Report(ROOT)
    contracts.run(ROOT, report)
    assert [v.rule for v in report.violations] == ["no-device"]
    assert "ops_ref_run" not in report.pass_info["contracts"]


@pytest.mark.parametrize("name", sorted(contracts.POISON_CHECKS))
def test_poison_scenarios_on_the_plain_versions(name):
    assert contracts.POISON_CHECKS[name]("ref", "cpu") is None


def test_poison_names_are_the_jax_packages():
    assert list(contracts.POISON_CHECKS) == [
        "affinity_matvec_q_side", "affinity_matvec_c_side", "roi_filter",
        "assign_clusters", "lsh_hash", "flash_attention_kv_start",
        "segment_matmul", "embedding_bag", "lid_sweep_pad_rows",
        "lid_sweep_refresh_pad"]


# ------------------------------------------------------------------ CLI ----
def _bad_tree(tmp_path):
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text(textwrap.dedent("""
        import torch
        def f(a, b):
            return torch.dot(a, b)
        """))
    return tmp_path


def test_cli_exits_nonzero_on_bad_tree_and_writes_report(tmp_path):
    bad = _bad_tree(tmp_path)
    out = tmp_path / "CHECK_report_torch.json"
    rc = check.main(["--root", str(bad), "--no-runtime",
                     "--report", str(out)])
    assert rc == 1
    data = json.loads(out.read_text())
    assert data["ok"] is False
    assert any(v["rule"] == "private-matmul" for v in data["violations"])


def test_cli_exits_zero_on_repo(tmp_path):
    out = tmp_path / "report.json"
    rc = check.main(["--root", ROOT, "--no-runtime", "--report", str(out)])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["ok"] is True
    assert sorted(data) == ["ok", "passes", "root", "suppressed",
                            "violations"]


def test_cli_rejects_unknown_pass():
    with pytest.raises(SystemExit):
        check.main(["--only", "nonsense"])


@pytest.mark.parametrize("name", ["jitboundary", "retrace"])
def test_cli_names_the_passes_with_no_counterpart(name, capsys):
    assert check.main(["--only", name]) != 0
    assert "no counterpart in the port" in capsys.readouterr().err
