"""The golden fixtures of tests/golden_torch/ (made by the JAX package,
tests/torch_golden_gen.py) and the port held to them on the CPU through its
plain versions (`repro_torch.utils.golden`, numpy and torch only): each
committed fixture equals a fresh run of the generator array for array, and
the port passes the ops fixture and the small fit + predict on every
engine. The card holds its kernels and engines to the same files
(chip_smoke.py phase 11)."""

import datetime
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_golden_gen as gen
from repro_torch.core.alid import EngineSpec
from repro_torch.utils import golden

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(gen.GENERATORS))
def test_committed_fixture_equals_a_fresh_run(name):
    fresh = gen.generate(name)
    arrays, meta = golden.load(name)
    assert meta == json.loads(str(fresh.pop("meta")))
    assert meta["jax"] and meta["seed"] == gen.SEED
    assert sorted(arrays) == sorted(fresh)
    for key, want in fresh.items():
        got = arrays[key]
        assert got.dtype == np.asarray(want).dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_fixtures_stay_small():
    sizes = [p.stat().st_size for p in golden.GOLDEN_DIR.glob("*.npz")]
    assert len(sizes) == 4 and sum(sizes) < 1 << 20


@pytest.fixture(scope="module")
def ops_on_the_cpu():
    return golden.check_ops("cpu")


@pytest.mark.parametrize("op", [c.name for c in gen.OP_CASES])
def test_plain_ops_hold_to_the_jax_package(ops_on_the_cpu, op):
    assert ops_on_the_cpu[op] == []


_SPECS = {
    "replicated": EngineSpec(),
    "sharded": EngineSpec(engine="sharded", n_shards=5),
    "streamed": EngineSpec(engine="streamed", n_shards=5, chunk_size=37),
}


@pytest.mark.parametrize("engine", sorted(_SPECS))
def test_small_fit_and_predict_hold_to_the_jax_package(engine):
    problems, res = golden.check_fit("fit_small", _SPECS[engine],
                                     device="cpu")
    assert problems == []
    assert res.n_clusters == 4


def test_small_fit_on_the_mesh_engine_holds_to_the_jax_package(tmp_path):
    """The mesh engine at world size 1 (one gloo process, here)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        problems, _ = golden.check_fit(
            "fit_small", EngineSpec(engine="mesh"), device="cpu")
    finally:
        dist.destroy_process_group()
    assert problems == []


def test_parity_fixture_is_phase_3b_data():
    """The fit_parity fixture's points are made from its seed by the
    port's own generator (held to the JAX run's sha256), at chip_smoke.py
    phase 3b's data and configuration."""
    points, cfg, arrays = golden.fit_data("fit_parity")
    assert points.shape == (20_000, 128)
    _, meta = golden.load("fit_parity")
    assert meta["data"] == gen.PARITY_DATA and meta["cfg"] == gen.PARITY_CFG
    assert (cfg.a_cap, cfg.delta, cfg.seeds_per_round, cfg.max_rounds) == (
        72, 128, 32, 64) and cfg.lsh.probe == 128
    assert arrays["labels"].shape == (20_000,)
    assert int(arrays["n_rounds"]) > 0 and arrays["densities"].size > 0


def test_fit_data_refuses_points_that_drifted(tmp_path):
    arrays, meta = golden.load("fit_parity")
    meta["points_sha256"] = "0" * 64
    np.savez(tmp_path / "fit_parity.npz", **arrays,
             meta=np.asarray(json.dumps(meta)))
    with pytest.raises(ValueError, match="drifted"):
        golden.fit_data("fit_parity", tmp_path)


def test_golden_checker_imports_no_jax():
    code = ("import sys; sys.path.insert(0, 'src'); "
            "import repro_torch.utils.golden as g; g.load('ops'); "
            "import repro_torch.analysis.check; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
