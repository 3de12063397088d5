"""ROADMAP C4's second fixture (tests/golden_torch/fit_converged.npz):
chip_smoke.py phase 3b's shape and configuration (20,000 x 128, a_cap 72,
delta 128, probe 128 over buckets of at most 91) on data where every LID
solve of the JAX package's fit converges within t_lid = 256 (the
generator records each solve's exit and refuses to write the file
otherwise). The port's replicated fit on the CPU, through the plain
versions, is held to it in full: canonical labels and rounds equal, and
densities and k within the gates the fixture's meta states (rtol 8e-6
and k_rtol 1.2e-4). Those come from an f64 witness of the k calibration
(`torch_golden_gen.k_witness`): at these tight blobs one f32 rounding of
a squared norm in the distance expansion moves k by k_scale = 5.968e-5
relative, and the densities move with k by at most 0.05815 times as much.
Measured: the JAX package's k is 3.1e-5 below the f64 k, the port's
6.6e-5 below it, 3.5e-5 apart; the densities 3.2e-6 apart. Both
packages' k are held within k_rtol of the f64 k, so the gap between them
is the f32 expansion's, not a fault of either. The card's four engines
are held to the fixture in chip_smoke.py phase 11b."""

import pytest
import torch

import torch_golden_gen as gen
from repro_torch.core.alid import EngineSpec
from repro_torch.utils import golden


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_fixture_records_every_lid_converged():
    points, cfg, arrays = golden.fit_data("fit_converged")
    _, meta = golden.load("fit_converged")
    assert points.shape == (20_000, 128)
    assert meta["data"] == gen.CONVERGED_DATA
    assert meta["cfg"] == gen.PARITY_CFG and meta["lsh_args"] == \
        gen.PARITY_LSH
    assert meta["lid_cut_short"] == 0 and meta["lid_solves"] > 0
    assert meta["lid_most_iters"] < meta["t_lid"] == cfg.t_lid
    assert meta["max_bucket"] <= cfg.lsh.probe == 128
    assert arrays["densities"].size == 200


def test_fixture_gates_follow_from_the_f64_witness():
    """The gates are the witness's, and the JAX package's k lies within
    k_scale of the f64 k."""
    points, _, arrays = golden.fit_data("fit_converged")
    _, meta = golden.load("fit_converged")
    assert (meta["k_f64"], meta["k_scale"]) == gen.k_witness(points)
    assert meta["k_rtol"] == gen._ceil2(2 * meta["k_scale"])
    assert meta["rtol"] == gen._ceil2(1e-6 + meta["k_rtol"]
                                      * meta["k_sensitivity"])
    k64 = meta["k_f64"]
    assert abs(float(arrays["k"]) - k64) <= meta["k_scale"] * k64


def test_replicated_fit_holds_to_the_converged_fixture():
    problems, res = golden.check_fit("fit_converged", EngineSpec(),
                                     device="cpu")
    assert problems == []
    assert res.n_clusters == 200
    _, meta = golden.load("fit_converged")
    k64 = meta["k_f64"]
    assert abs(float(res.k) - k64) <= meta["k_rtol"] * k64
