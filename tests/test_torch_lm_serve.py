"""LM serving on the port (`repro_torch.serve.engine`: generate,
BatchServer; `repro_torch.launch.serve`) on the CPU: the behaviours of
tests/test_serving.py, and token sequences equal to the JAX package's.

Greedy tokens must be equal: the logits agree to ~5e-7
(tests/test_torch_transformer.py) and the smoke models' top-2 gaps are far
wider. Sampled tokens must be equal too: the Gumbel noise is within ulps
of jax's (tests/test_torch_random.py), on logits without near-ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jm
from repro.serve import BatchServer as JaxBatchServer
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import generate as jax_generate
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as lm_m
from repro_torch.serve import BatchServer, ServeConfig, generate
from repro_torch.serve.engine import pack_prompts

ARCHS = ["h2o-danube-1.8b", "deepseek-7b", "gemma2-27b"]


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX config, JAX params, port config, port params drawn by
    the port itself). The port's own init_params rounds to the JAX
    weights within ulps; generation is compared on each package's own
    weights, as a user of either would run it."""
    out = {}
    for arch in ARCHS:
        jc = jax_arch(arch).SMOKE_CONFIG
        tc = get_arch(arch).SMOKE_CONFIG
        out[arch] = (jc, jm.init_params(jax.random.PRNGKey(0), jc), tc,
                     lm_m.init_params(trandom.PRNGKey(0), tc, device="cpu"))
    return out


def _setup(models, arch="h2o-danube-1.8b"):
    _, _, cfg, params = models[arch]
    return cfg, params


def _gen(params, cfg, prompts, scfg, **kw):
    return generate(params, cfg, prompts, scfg, device="cpu", **kw).numpy()


# ---------------------------------------- tests/test_serving.py, on the port
def test_prefill_matches_forward(models):
    cfg, params = _setup(models)
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab,
                                                          (2, 12)))
    logits, _ = lm_m.forward(params, cfg, toks)
    cache = lm_m.init_cache(cfg, 2, 16, device="cpu")
    last, _ = lm_m.prefill_with_cache(params, cfg, cache, toks)
    np.testing.assert_allclose(last.numpy(), logits[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_generate_greedy_deterministic(models):
    cfg, params = _setup(models)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (3, 6))
    scfg = ServeConfig(max_new_tokens=8, temperature=0.0)
    out1 = _gen(params, cfg, prompts, scfg)
    out2 = _gen(params, cfg, prompts, scfg)
    assert out1.shape == (3, 8) and out1.dtype == np.int32
    np.testing.assert_array_equal(out1, out2)
    assert (out1 >= 0).all() and (out1 < cfg.vocab).all()


def test_generate_matches_incremental_decode(models):
    """generate()'s loop == manual prefill + step-by-step decode."""
    cfg, params = _setup(models, "deepseek-7b")
    prompts = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab,
                                                             (2, 5)))
    scfg = ServeConfig(max_new_tokens=4, temperature=0.0)
    fused = _gen(params, cfg, prompts, scfg)
    cache = lm_m.init_cache(cfg, 2, 5 + 5, device="cpu")
    logits, cache = lm_m.prefill_with_cache(params, cfg, cache, prompts)
    toks = []
    for pos in range(5, 9):
        t = torch.argmax(logits, -1)
        toks.append(t.numpy())
        logits, cache = lm_m.decode_step(params, cfg, cache, t[:, None], pos)
    np.testing.assert_array_equal(fused, np.stack(toks, 1))


def test_batch_server_queueing(models):
    cfg, params = _setup(models)
    srv = BatchServer(params, cfg, batch_slots=2,
                      scfg=ServeConfig(max_new_tokens=4), device="cpu")
    rng = np.random.default_rng(0)
    ids = [srv.submit(rng.integers(0, cfg.vocab, size=n).astype(np.int32))
           for n in (3, 5, 4)]
    results = srv.serve()
    assert set(results) == set(ids)
    for r in results.values():
        assert r.shape == (4,)
    assert [s["requests"] for s in srv.batch_stats] == [2, 1]
    assert all(s["prefill_s"] >= 0 and s["decode_steps"] == 3
               for s in srv.batch_stats)


def test_batch_server_packed_matches_solo(models):
    """A short and a long prompt packed into one batch each generate what
    they generate solo, under the smoke config's sliding window."""
    cfg, params = _setup(models)
    rng = np.random.default_rng(7)
    short = rng.integers(1, cfg.vocab, size=3).astype(np.int32)
    long = rng.integers(1, cfg.vocab, size=9).astype(np.int32)
    scfg = ServeConfig(max_new_tokens=6, temperature=0.0)
    solo = {}
    for name, p in (("short", short), ("long", long)):
        srv = BatchServer(params, cfg, batch_slots=1, scfg=scfg,
                          device="cpu")
        rid = srv.submit(p)
        solo[name] = srv.serve()[rid]
    srv = BatchServer(params, cfg, batch_slots=4, scfg=scfg, device="cpu")
    rid_s, rid_l = srv.submit(short), srv.submit(long)
    packed = srv.serve()
    np.testing.assert_array_equal(packed[rid_s], solo["short"])
    np.testing.assert_array_equal(packed[rid_l], solo["long"])


def test_generate_prompt_lens_matches_solo_generate(models):
    cfg, params = _setup(models, "deepseek-7b")
    rng = np.random.default_rng(8)
    scfg = ServeConfig(max_new_tokens=5, temperature=0.0)
    lens = [2, 7, 4]
    p = max(lens)
    prompts = np.zeros((len(lens), p), np.int32)
    rows = []
    for i, n in enumerate(lens):
        row = rng.integers(1, cfg.vocab, size=n).astype(np.int32)
        rows.append(row)
        prompts[i, p - n:] = row
    packed = _gen(params, cfg, prompts, scfg, prompt_lens=lens)
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(packed[i],
                                      _gen(params, cfg, row[None], scfg)[0])


def test_generate_with_temperature_samples(models):
    cfg, params = _setup(models)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (2, 4))
    scfg = ServeConfig(max_new_tokens=6, temperature=1.0)
    a = _gen(params, cfg, prompts, scfg, rng=trandom.PRNGKey(1))
    b = _gen(params, cfg, prompts, scfg, rng=trandom.PRNGKey(2))
    assert a.shape == b.shape == (2, 6)
    assert not np.array_equal(a, b)


# --------------------------------------------- equal to the JAX package ----
@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_jax(models, arch, temperature):
    """A left-padded batch, greedy and sampled, on each package's own
    init_params weights: the same tokens."""
    jc, jp, tc, tp = models[arch]
    rng = np.random.default_rng(11)
    lens = np.array([4, 9, 1])
    prompts = np.zeros((3, 9), np.int32)
    for i, n in enumerate(lens):
        prompts[i, 9 - n:] = rng.integers(1, jc.vocab, n)
    want = np.asarray(jax_generate(
        jp, jc, jnp.asarray(prompts),
        JaxServeConfig(max_new_tokens=8, temperature=temperature),
        rng=jax.random.PRNGKey(5), prompt_lens=jnp.asarray(lens, jnp.int32)))
    got = _gen(tp, tc, prompts,
               ServeConfig(max_new_tokens=8, temperature=temperature),
               rng=trandom.PRNGKey(5), prompt_lens=lens)
    np.testing.assert_array_equal(got, want)


def test_eos_and_batch_server_equal_jax(models):
    """BatchServer with an eos id: rows that emit it emit 0 after, as in
    the JAX package; two batches of three slots, one slot empty."""
    jc, jp, tc, tp = models["h2o-danube-1.8b"]
    greedy = JaxBatchServer(jp, jc, batch_slots=3,
                            scfg=JaxServeConfig(max_new_tokens=6))
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, jc.vocab, size=n).astype(np.int32)
               for n in (5, 2, 8, 3, 6)]
    for p in prompts:
        greedy.submit(p)
    first = greedy.serve()
    eos = int(first[0][2])                    # a token request 0 emits
    jsrv = JaxBatchServer(jp, jc, batch_slots=3,
                          scfg=JaxServeConfig(max_new_tokens=6, eos_id=eos))
    tsrv = BatchServer(tp, tc, batch_slots=3,
                       scfg=ServeConfig(max_new_tokens=6, eos_id=eos),
                       device="cpu")
    for p in prompts:
        jsrv.submit(p)
        tsrv.submit(p)
    want, got = jsrv.serve(), tsrv.serve()
    assert set(got) == set(want) == set(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    assert (got[0][3:] == 0).all()


def test_launch_serve_main_on_the_cpu(models, capsys):
    """The launcher's mix (6 requests of 4-11 tokens, 4 slots, 16 new
    tokens, greedy) gives the JAX launcher's requests and tokens."""
    jc, jp, _, _ = models["h2o-danube-1.8b"]
    res = serve_cli.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("[serve] 6 requests, 96 tokens in ")
    jsrv = JaxBatchServer(jp, jc, batch_slots=4,
                          scfg=JaxServeConfig(max_new_tokens=16))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jc.vocab, size=rng.integers(4, 12))
               .astype(np.int32) for _ in range(6)]
    ids = [jsrv.submit(p) for p in prompts]
    want = jsrv.serve()
    assert res["ids"] == ids and res["tokens"] == 96
    for got, p in zip(res["prompts"], prompts):
        np.testing.assert_array_equal(got, p)
    for rid in ids:
        np.testing.assert_array_equal(res["results"][rid],
                                      np.asarray(want[rid]))
    assert f"  req 0: {np.asarray(want[0]).tolist()}" in out
    kimi = serve_cli.main(["--device", "cpu", "--arch", "kimi-k2-1t-a32b"])
    assert kimi["tokens"] == 96 and len(kimi["results"]) == 6


def test_pack_prompts_left_pads_and_fills_empty_slots():
    """BatchServer's packing: prompts right-aligned over zeros, empty slots
    zero tokens of length maxp."""
    toks, lens = pack_prompts([np.array([5, 6]), np.array([7, 8, 9])], 3)
    np.testing.assert_array_equal(toks, [[0, 5, 6], [7, 8, 9], [0, 0, 0]])
    np.testing.assert_array_equal(lens, [2, 3, 3])
    assert toks.dtype == lens.dtype == np.int32


def test_generate_refuses_params_elsewhere(models):
    cfg, params = _setup(models)
    with pytest.raises(ValueError, match="params lie on cpu"):
        generate(params, cfg, np.zeros((1, 3), np.int32), device="meta")
