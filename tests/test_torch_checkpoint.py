"""The port's checkpoint manager (`repro_torch.checkpoint.manager`) against
the JAX package's (`repro.checkpoint.manager`): bitwise round trips for
numpy, torch and bf16 leaves, crc32 corruption detection, `.tmp`
directories ignored, `keep`, `restore_checkpoint` into a template on a
device, jax's key strings, and the on-disk layout shared by both packages:
a snapshot written by either restores bitwise in the other, with equal
manifests."""

import collections
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jman
from repro_torch.checkpoint import manager as tman


class NT(NamedTuple):
    a: object
    b: object


def _nested():
    return {"z": np.float32(1.5), "a": [np.arange(3, dtype=np.int32),
                                        np.ones((2, 2), np.float64)],
            "m": NT(np.zeros(4, bool), np.uint32(7)), "n": None,
            "k": (np.arange(6, dtype=np.int64).reshape(2, 3),)}


def _bf16_bits(seed=0, shape=(5, 3)):
    """bf16 values as uint16 bits: finite, both signs, a subnormal."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x.reshape(-1)[0] = 1e-40
    return (x.view(np.uint32) >> 16).astype(np.uint16)


def _torch_bf16(bits):
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _trees():
    rng = np.random.default_rng(3)
    return {
        "numpy": {"w": rng.normal(size=(7, 5)).astype(np.float32),
                  "i": np.arange(9, dtype=np.int64), "b": np.array(True),
                  "u": np.array([0, 17], np.uint32), "s": np.float64(0.25)},
        "torch": {"w": torch.tensor(rng.normal(size=(4, 6)),
                                    dtype=torch.float32),
                  "i": torch.arange(5, dtype=torch.int32),
                  "m": torch.tensor([True, False])},
        "bf16": {"h": _torch_bf16(_bf16_bits()),
                 "f": np.arange(4, dtype=np.float32)},
    }


def _bits(leaf) -> tuple:
    """(dtype name, bytes, shape) of a leaf: equal iff bitwise equal."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return ("bfloat16", t.view(torch.int16).numpy().tobytes(),
                    tuple(t.shape))
        leaf = t.numpy()
    arr = np.asarray(leaf)
    name = arr.dtype.name
    return (name, np.ascontiguousarray(arr).tobytes(), arr.shape)


@pytest.mark.parametrize("kind", ["numpy", "torch", "bf16"])
def test_roundtrip_is_bitwise(tmp_path, kind):
    tree = _trees()[kind]
    tman.save_checkpoint(str(tmp_path), 3, tree, metadata={"kind": kind})
    assert tman.list_checkpoints(str(tmp_path)) == [3]
    manifest, flat = tman.restore_checkpoint_tree(str(tmp_path), 3)
    assert manifest["step"] == 3 and manifest["metadata"] == {"kind": kind}
    assert set(flat) == set(tree)
    for key, leaf in tree.items():
        assert _bits(flat[key]) == _bits(leaf), key
    if kind == "bf16":
        assert flat["h"].dtype == torch.bfloat16
        assert manifest["leaves"]["h"]["dtype"] == "bfloat16"
    step, back = tman.restore_checkpoint(str(tmp_path), 3, tree,
                                         device="cpu")
    assert step == 3
    for key, leaf in tree.items():
        assert isinstance(back[key], torch.Tensor)
        assert _bits(back[key]) == _bits(leaf), key


def test_restore_into_template_on_a_device(tmp_path):
    """restore_checkpoint keeps `like`'s structure (dict, list, tuple,
    NamedTuple, None), puts every leaf on the device as a tensor, and
    refuses a template whose shape differs."""
    tree = _nested()
    tman.save_checkpoint(str(tmp_path), 1, tree)
    step, back = tman.restore_checkpoint(str(tmp_path), 1, tree,
                                         device="cpu")
    assert step == 1
    assert back["n"] is None and isinstance(back["m"], NT)
    assert isinstance(back["a"], list) and isinstance(back["k"], tuple)
    assert list(tman._flatten(back)) == list(tman._flatten(tree))
    for (k1, a), (k2, b) in zip(tman._flatten(back).items(),
                                tman._flatten(tree).items()):
        assert k1 == k2 and a.device.type == "cpu"
        assert _bits(a) == _bits(b), k1
    bad = dict(tree, z=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="shape"):
        tman.restore_checkpoint(str(tmp_path), 1, bad, device="cpu")


def test_restore_checkpoint_defaults_to_the_card(tmp_path):
    tree = {"w": np.ones(3, np.float32)}
    tman.save_checkpoint(str(tmp_path), 1, tree)
    if torch.cuda.is_available():
        _, back = tman.restore_checkpoint(str(tmp_path), 1, tree)
        assert back["w"].is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tman.restore_checkpoint(str(tmp_path), 1, tree)


@pytest.mark.parametrize("restore", ["tree", "like"])
def test_corrupted_leaf_raises(tmp_path, restore):
    tree = {"w": np.arange(12, dtype=np.float32), "step": np.int64(7)}
    tman.save_checkpoint(str(tmp_path), 1, tree)
    npz = tmp_path / "step_00000001" / "arrays.npz"
    with np.load(str(npz)) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    arrays["w"][3] += 1.0
    np.savez(str(npz), **arrays)
    call = ((lambda **kw: tman.restore_checkpoint_tree(str(tmp_path), 1,
                                                       **kw))
            if restore == "tree" else
            (lambda **kw: tman.restore_checkpoint(str(tmp_path), 1, tree,
                                                  device="cpu", **kw)))
    with pytest.raises(tman.CheckpointCorruption, match="crc32"):
        call()
    # verify=False loads the bytes as they are
    _, loaded = call(verify=False)
    assert float(loaded["w"][3]) == 4.0


def test_tmp_directories_are_ignored(tmp_path):
    tman.save_checkpoint(str(tmp_path), 1, {"x": np.ones(2)})
    os.makedirs(str(tmp_path / "step_00000002.tmp"))
    assert tman.list_checkpoints(str(tmp_path)) == [1]
    assert tman.latest_step(str(tmp_path)) == 1
    # a stale .tmp of the step being saved is replaced, not merged
    os.makedirs(str(tmp_path / "step_00000003.tmp"))
    (tmp_path / "step_00000003.tmp" / "junk").write_text("x")
    tman.save_checkpoint(str(tmp_path), 3, {"x": np.zeros(2)})
    assert sorted(os.listdir(str(tmp_path / "step_00000003"))) == [
        "arrays.npz", "manifest.json"]
    assert tman.list_checkpoints(str(tmp_path)) == [1, 3]
    assert tman.latest_step(str(tmp_path / "absent")) is None


def test_keep_bounds_retained_steps(tmp_path):
    for s in [1, 2, 3, 4, 5]:
        tman.save_checkpoint(str(tmp_path), s, {"p": np.full(2, s)}, keep=2)
    assert tman.list_checkpoints(str(tmp_path)) == [4, 5]
    assert tman.load_manifest(str(tmp_path), 5)["step"] == 5


def test_key_strings_are_jax_keys():
    tree = _nested()
    want = list(jman._flatten(tree))
    assert want == ["a//0", "a//1", "k//0", "m//.a", "m//.b", "z"]
    assert list(tman._flatten(tree)) == want
    od = collections.OrderedDict([("y", np.ones(1)), ("b", [np.ones(1)])])
    deep = {"q": [od, (NT(np.ones(1), {"x": np.ones(1)}),)], "3": np.ones(1)}
    assert list(tman._flatten(deep)) == list(jman._flatten(deep))
    assert list(tman._flatten(np.ones(2))) == list(jman._flatten(np.ones(2)))


def _jax_tree(bits):
    return {"w": np.random.default_rng(1).normal(size=(6, 4)).astype(
                np.float32),
            "rng": np.asarray(jax.random.PRNGKey(17)),
            "k": np.float64(0.125),
            "nested": {"l": [np.arange(3, dtype=np.int64)],
                       "t": NT(np.array([True, False]), None)},
            "h": jnp.asarray(bits.view(jnp.bfloat16))}


def _port_tree(bits):
    tree = _jax_tree(bits)
    tree["h"] = _torch_bf16(bits)
    return tree


def test_jax_written_restores_in_the_port_and_back(tmp_path):
    """A checkpoint written by either package restores bitwise in the
    other (bf16 leaf included), and both write equal manifests for the
    same tree."""
    bits = _bf16_bits(seed=2, shape=(3, 4))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    meta = {"epoch": 4, "note": "x"}
    jman.save_checkpoint(jdir, 4, _jax_tree(bits), metadata=meta)
    tman.save_checkpoint(tdir, 4, _port_tree(bits), metadata=meta)
    assert tman.load_manifest(tdir, 4) == jman.load_manifest(jdir, 4)
    with open(os.path.join(tdir, "step_00000004", "manifest.json")) as f, \
            open(os.path.join(jdir, "step_00000004", "manifest.json")) as g:
        assert f.read() == g.read()

    # JAX-written, port-restored
    _, flat = tman.restore_checkpoint_tree(jdir, 4)
    want = tman._flatten(_port_tree(bits))
    assert list(flat) == list(want)
    for key in want:
        assert _bits(flat[key]) == _bits(want[key]), key
    _, back = tman.restore_checkpoint(jdir, 4, _port_tree(bits),
                                      device="cpu")
    for a, b in zip(tman._flatten(back).values(), want.values()):
        assert _bits(a) == _bits(b)

    # port-written, JAX-restored
    _, jflat = jman.restore_checkpoint_tree(tdir, 4)
    jwant = jman._flatten(_jax_tree(bits))
    assert list(jflat) == list(jwant)
    for key in jwant:
        got, exp = np.asarray(jflat[key]), np.asarray(jwant[key])
        assert got.dtype == exp.dtype and got.shape == exp.shape, key
        assert got.tobytes() == exp.tobytes(), key
    _, jback = jman.restore_checkpoint(tdir, 4, _jax_tree(bits))
    assert jback["h"].dtype == jnp.bfloat16
    # jax restores as jnp arrays: float64 leaves become float32 there
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(
            jax.tree.map(jnp.asarray, _jax_tree(bits)))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
