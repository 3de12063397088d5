"""The port's mesh engine (`repro_torch.core.engine.MeshEngine`, the
mesh-placed `core.store.MeshStore`, `core.palid.detect_clusters_parallel`)
in spawned gloo ranks at W = 1, 2 and 4, on the blobs / cfg fixtures of
tests/test_engine.py and its tied-data fixture.

The reference: the JAX package's `MeshEngine` raises on jax 0.9.0 (ROADMAP
C), so the mesh fits are held against the JAX package's REPLICATED fit
with backend="ref" under the parity contract (canonical labels equal,
sorted densities within rtol 1e-6, n_rounds equal), and bit for bit
against the port's one-process fits: the replicated engine for the
replicated store, the sharded engine with the same shard count for the
mesh-placed store. A rank runs its block of each round's seeds; every op
on the CPU (the plain versions, the ROI centre's and the salts' einsums)
gives a lane the same bits whatever other lanes share its batch, so the
bitwise bar holds here (ROADMAP C)."""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.core.alid import ALIDConfig as JConfig
from repro.core.engine import fit as jfit
from repro.data import auto_lsh_params
from repro.utils import canonical_labels
from repro_torch import random as trandom
from repro_torch.core import alid as talid
from repro_torch.core.engine import MeshEngine, fit, make_engine
from repro_torch.data import synthetic as tsynthetic
from repro_torch.distributed.spawn import run_ranks
from repro_torch.lsh.pstable import LSHParams

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _blobs():
    blobs = tsynthetic.make_blobs_with_noise(
        n_clusters=4, cluster_size=25, n_noise=80, d=10, seed=7,
        overlap_pairs=0)
    return blobs.points, tsynthetic.auto_lsh_params(blobs.points, probe=128)


def _tied():
    """tests/test_engine.py::test_tied_data_serial_vs_mesh's data:
    duplicated points, so seed instances converge to bit-identical
    densities."""
    rng = np.random.default_rng(1)
    blob = rng.normal(0, 0.5, size=(20, 6)).astype(np.float32)
    far = rng.normal(20, 0.5, size=(20, 6)).astype(np.float32)
    noise = rng.uniform(-40, 40, size=(60, 6)).astype(np.float32)
    pts = np.concatenate([blob, blob, far, noise])
    return pts, tsynthetic.auto_lsh_params(pts, probe=128)


def _cfg(lsh, exhaustive=False, **spec):
    return talid.ALIDConfig(a_cap=48, delta=48, lsh=LSHParams(*lsh),
                            seeds_per_round=16, max_rounds=20,
                            exhaustive=exhaustive,
                            spec=talid.EngineSpec(**spec))


def _tie_cfg(lsh, **spec):
    return talid.ALIDConfig(a_cap=64, delta=48, lsh=LSHParams(*lsh),
                            seeds_per_round=16, max_rounds=16,
                            spec=talid.EngineSpec(**spec))


@pytest.fixture(scope="module")
def reference():
    """The one-process fits: the port's replicated and sharded engines and
    the JAX package's replicated fit (backend="ref")."""
    pts, lsh = _blobs()
    tpts, tlsh = _tied()
    out = {}
    for exh in (False, True):
        out["rep", exh] = fit(pts, _cfg(lsh, exh), trandom.PRNGKey(0),
                              device="cpu")
        jcfg = JConfig(a_cap=48, delta=48, lsh=auto_lsh_params(pts,
                                                               probe=128),
                       seeds_per_round=16, max_rounds=20, exhaustive=exh)
        out["jax", exh] = jfit(pts, jcfg._replace(
            spec=jcfg.spec._replace(backend="ref")), jax.random.PRNGKey(0))
    for s in (4, 8):
        out["sharded", s] = fit(pts, _cfg(lsh, engine="sharded", n_shards=s),
                                trandom.PRNGKey(0), device="cpu")
    out["tied"] = fit(tpts, _tie_cfg(tlsh), trandom.PRNGKey(0),
                      device="cpu")
    return out


def _cases(world):
    pts, lsh = _blobs()
    tpts, tlsh = _tied()
    mesh = dict(engine="mesh")
    cases = [("rep-False", "fit", pts, _cfg(lsh, False, **mesh)),
             ("rep-True", "fit", pts, _cfg(lsh, True, **mesh)),
             ("store-4", "store", pts, _cfg(lsh, n_shards=4, **mesh))]
    if world == 2:
        cases += [("store-8", "store", pts, _cfg(lsh, n_shards=8, **mesh)),
                  ("shim", "shim", pts, _cfg(lsh)),
                  ("resume", "resume", pts, _cfg(lsh, True, **mesh))]
    if world > 1:
        cases.append(("tied", "fit", tpts, _tie_cfg(tlsh, **mesh)))
    return cases


@pytest.fixture(scope="module")
def mesh_fits(tmp_path_factory):
    """world -> every rank's results of `_cases(world)`, one spawn per
    world size, made on first use."""
    runs: dict = {}

    def get(world):
        if world not in runs:
            runs[world] = run_ranks(
                ranks.fit_cases, world, _cases(world),
                str(tmp_path_factory.mktemp(f"ckpt{world}")),
                devices=["cpu"] * world, timeout=600)
        return runs[world]
    return get


def _bitwise(a, b):
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.densities, b.densities)
    assert a.n_rounds == b.n_rounds and a.k == b.k
    for key in ("support_idx", "support_w", "support_v"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))


def _parity(got, want):
    assert want.n_clusters > 0
    np.testing.assert_array_equal(canonical_labels(got.labels),
                                  canonical_labels(want.labels))
    assert got.n_rounds == want.n_rounds
    np.testing.assert_allclose(np.sort(got.densities),
                               np.sort(want.densities), rtol=RTOL)


def _result(outs, name):
    """Rank 0's result of a case; every rank's must be the same."""
    def res_of(x):
        return x if isinstance(x, talid.Clustering) else x[0]
    res = res_of(outs[0][name])
    for out in outs[1:]:
        _bitwise(res_of(out[name]), res)
    return res


@pytest.mark.parametrize("exhaustive", [False, True])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_replicated_store_mesh_fit(mesh_fits, reference, world, exhaustive):
    """The replicated-store mesh fit at W ranks: bit-identical to the port's
    replicated fit, and the JAX replicated fit's clustering."""
    outs = mesh_fits(world)
    got = _result(outs, f"rep-{exhaustive}")
    _bitwise(got, reference["rep", exhaustive])
    _parity(got, reference["jax", exhaustive])


@pytest.mark.parametrize("world,n_shards", [(1, 4), (2, 4), (2, 8),
                                            (4, 4)])
def test_mesh_placed_store_fit(mesh_fits, reference, world, n_shards):
    """The mesh-placed store (S shards over W ranks): bit-identical to the
    port's sharded engine at S, the JAX replicated fit's clustering; each
    rank builds and holds S/W shards plus one in flight, never the whole
    store, with `build_store`'s bits shard for shard."""
    outs = mesh_fits(world)
    name = f"store-{n_shards}"
    got = _result(outs, name)
    _bitwise(got, reference["sharded", n_shards])
    _parity(got, reference["jax", False])
    pts, lsh = _blobs()
    from repro_torch.core.store import build_store, global_bucket_sizes
    full = build_store(torch.tensor(pts), LSHParams(*lsh),
                       trandom.PRNGKey(1), n_shards=n_shards)
    shard = (full.shards[0].nbytes + full.valid[0].nbytes
             + full.global_idx[0].nbytes + full.tables.perm[0].nbytes)
    slot = shard - full.valid[0].nbytes
    want = build_store(torch.tensor(pts), LSHParams(*lsh),
                       trandom.PRNGKey(3), n_shards=n_shards)
    for r, out in enumerate(outs):
        _, held, slot_shape, nbytes, parts = out[name]
        assert held == n_shards // world
        assert tuple(slot_shape) == tuple(full.shards[0].shape)
        assert nbytes == held * shard + slot
        mine = slice(r * held, (r + 1) * held)
        for key, ref in (
                ("shards", want.shards[mine]), ("valid", want.valid[mine]),
                ("global_idx", want.global_idx[mine]),
                ("perm", want.tables.perm[mine]),
                ("sorted_keys", want.tables.sorted_keys),
                ("shard_of", want.shard_of), ("slot_of", want.slot_of),
                ("centers", want.centers), ("radii", want.radii),
                ("bucket_sizes", global_bucket_sizes(want))):
            np.testing.assert_array_equal(parts[key], ref.numpy(), key)


@pytest.mark.parametrize("world", [2, 4])
def test_tied_data_mesh_vs_replicated(mesh_fits, reference, world):
    """Duplicated points tie densities exactly; with the one reducer over
    the all-gathered batch the mesh fit gives the replicated fit's labels,
    label for label."""
    outs = mesh_fits(world)
    np.testing.assert_array_equal(_result(outs, "tied").labels,
                                  reference["tied"].labels)


def test_detect_clusters_parallel_shim(mesh_fits, reference):
    """The shim warns as the JAX one does and returns fit's result; its
    k= is honoured with a warning of its own."""
    for out in mesh_fits(2):
        a, b, texts = out["shim"]
        _bitwise(a, reference["rep", False])
        assert len(texts[0]) == 1 and "detect_clusters_parallel" in texts[0][0]
        assert len(texts[1]) == 2 and "k= parameter" in texts[1][1]
        assert b.k == pytest.approx(a.k)
        np.testing.assert_array_equal(b.labels, a.labels)


def test_fit_checkpoint_resume_on_the_mesh(mesh_fits, reference):
    """A crash at round 2 and a resume at W = 2 (rank 0 writes the
    checkpoints, every rank reads them) are bit-identical to the clean
    run."""
    for out in mesh_fits(2):
        res, steps = out["resume"]
        assert steps == [1]
        _bitwise(res, reference["rep", True])


def test_mesh_engine_is_made():
    """`make_engine` makes the mesh engine (refused before ROADMAP A13);
    it builds only under an initialized process group."""
    eng = make_engine(talid.EngineSpec(engine="mesh"), device="cpu")
    assert type(eng) is MeshEngine and eng.device == torch.device("cpu")
    pts, lsh = _blobs()
    with pytest.raises(RuntimeError, match="init_process_group"):
        fit(pts, _cfg(lsh, engine="mesh"), trandom.PRNGKey(0), device="cpu")
