"""The port's training path (`repro_torch.data.lm`, `train.steps`,
`train.trainer`, `models.*` under autograd) against the JAX package's,
on the SMOKE_CONFIGs, on the CPU (the plain route: torch differentiates
the plain ops, the token and node gathers sum their gradients through
`ops.segment_matmul`).

Tolerances:
- lm_batch: tokens equal (int32); the emission's exp-and-floor equal to
  JAX's on every one of the 2**23 uniform values at the smoke vocab (512),
  and at 32,000 on all but the 5 counted here.
- lm_loss (f32 models): loss rtol 1e-5; each gradient leaf within 1e-4 of
  its largest |g| (the packages sum products, softmaxes and segments in
  their own orders; measured under 2e-5 on danube and gemma2). llama4's
  MoE routes the same tokens to the same experts here (checked), so its
  loss and aux are held the same way.
- one train step: params within 1e-5 of each leaf's largest magnitude
  plus 1e-2 lr (AdamW's first update is lr g / (|g| + eps), which a
  gradient's last bits swing by a fraction of lr where |g| is near eps;
  measured 1.9e-3 lr on danube); the GNN and BST steps the same way.
- train_loop crash + resume and remat on / off: bit-equal (the port's
  own runs).
The GNN and BST train steps are in tests/test_torch_train_models.py (a
file of their own, so the test workers take the two apart).
- a JAX checkpoint continued in the port: the params after one more step
  within the train step's tolerance of JAX's.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data.lm import lm_batch as jax_lm_batch
from repro.train import steps as jsteps
from repro.train.optimizers import OptConfig as JOpt
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.data.lm import lm_batch
from repro_torch.models.transformer import init_params as tinit_lm
from repro_torch.random import PRNGKey
from repro_torch.train import steps as tsteps
from repro_torch.train.optimizers import OptConfig, init_opt_state, \
    tree_leaves
from repro_torch.train.trainer import TrainerConfig, train_loop

OPT = dict(lr=1e-3, warmup=1, decay_steps=4)
# AdamW's first update is lr g / (|g| + eps): where a gradient is near eps
# its last bits swing the update by a fraction of lr
STEP_ATOL = 1e-2 * OPT["lr"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _leafwise_close(got, want, frac, what="", atol=0.0):
    """Each leaf of `got` (a torch tree) within frac x the largest |leaf|
    of `want` (a JAX tree of the same structure, or numpy), plus atol."""
    gl = tree_leaves(got)
    wl = [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        g = g.detach().float().numpy()
        assert g.shape == w.shape, (what, i)
        scale = float(np.abs(w).max()) if w.size else 0.0
        assert float(np.abs(g - w).max(initial=0.0)) <= frac * scale + atol, \
            (what, i, float(np.abs(g - w).max()), scale)


def _np(tree):
    """A port tree (dicts, lists of tensors) as numpy copies: JAX may read
    a numpy buffer in place, after the port's in-place step has run."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.detach().numpy().copy()


def _lm(arch):
    """(JAX config, JAX params, port config, port params): the port's
    init_params (within 4 f32 ulps of JAX's, tests/test_torch_transformer.
    py) handed to both packages, which skips JAX's slower eager init."""
    jc = jax_arch(arch).SMOKE_CONFIG
    tc = get_arch(arch).SMOKE_CONFIG
    tp = tinit_lm(PRNGKey(0), tc, device="cpu")
    return jc, jax.tree.map(jnp.asarray, _np(tp)), tc, tp


# ------------------------------------------------------------------ data --
@pytest.mark.parametrize("step,batch,seq,vocab,seed", [
    (0, 8, 128, 512, 0), (5, 3, 40, 512, 2), (2, 2, 64, 32_000, 0)])
def test_lm_batch_equals_jax(step, batch, seq, vocab, seed):
    want = np.asarray(jax_lm_batch(jnp.int32(step), batch=batch,
                                   seq_len=seq, vocab=vocab, seed=seed))
    got = lm_batch(step, batch=batch, seq_len=seq, vocab=vocab, seed=seed,
                   device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lm_batch_emission_against_every_uniform_value():
    """floor(exp(u log(vocab / 64))) over all 2**23 values the uniform
    draw can take: equal to JAX's at the smoke vocab, and at 32,000 apart
    on exactly the 5 values lm_batch's docstring counts."""
    k = np.arange(2 ** 23, dtype=np.uint32)
    u = (k | 0x3F800000).view(np.float32) - np.float32(1.0)
    for vocab, apart in ((512, 0), (32_000, 5)):
        per = float(vocab // 64)
        want = np.asarray(jnp.floor(jnp.exp(jnp.asarray(u) * jnp.log(per))))
        lp = torch.log(torch.tensor(per, dtype=torch.float32))
        got = torch.floor(torch.exp(torch.from_numpy(u) * lp)).numpy()
        assert int((got != want).sum()) == apart


# ------------------------------------------------------------ LM losses --
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma2-27b",
                                  "llama4-scout-17b-16e"])
def test_lm_loss_and_grads_match_jax(arch):
    """lm_loss and its gradient, for danube's (sliding window), gemma2's
    (softcaps, post-norms, tied embeddings) and llama4's (MoE with aux,
    chunked and NoPE layers) smoke configs."""
    jc, jp, tc, tp = _lm(arch)
    toks = lm_batch(1, batch=2, seq_len=24, vocab=jc.vocab,
                    device="cpu").numpy()
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jsteps.lm_loss(p, jc, jnp.asarray(toks)), has_aux=True))(jp)
    (tl, tm), tg = tsteps.value_and_grad(
        lambda p: tsteps.lm_loss(p, tc, torch.tensor(toks)), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-8)
    if jc.moe is not None:
        assert float(tm["aux"]) > 0
    _leafwise_close(tg, jg, 1e-4, arch)


# ------------------------------------------------------------ LM steps --
@pytest.fixture(scope="module")
def danube_step():
    """JAX's jitted danube smoke train step, compiled once (at batch 4 x
    16) for the tests that take it."""
    jc = jax_arch("h2o-danube-1.8b").SMOKE_CONFIG
    return jax.jit(jsteps.make_lm_train_step(jc, JOpt(**OPT)))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_lm_train_step_matches_jax(microbatches, danube_step):
    """One step of make_lm_train_step on danube's smoke config: loss,
    metrics and the updated params as the JAX step's. The port's two
    microbatches of 2 are held to JAX's one batch of 4: the tokens weigh
    alike, so the mean of the microbatches' losses and gradients is the
    batch's (up to rounding, within the stated tolerance)."""
    jc, jp, tc, tp = _lm("h2o-danube-1.8b")
    toks = lm_batch(0, batch=4, seq_len=16, vocab=jc.vocab,
                    device="cpu").numpy()
    jopt, topt = JOpt(**OPT), OptConfig(**OPT)
    jp2, _, jm = danube_step(jp, jsteps.init_opt_state(jopt, jp),
                             jnp.asarray(toks))
    tstep = tsteps.make_lm_train_step(tc, topt, microbatches=microbatches)
    tp2, ts2, tm = tstep(tp, init_opt_state(topt, tp), torch.tensor(toks))
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    assert int(ts2["step"]) == 1
    _leafwise_close(tp2, jp2, 1e-5, "params", STEP_ATOL)


def test_train_loop_crash_resume_exact():
    """The port's trainer crashed after step 2 and resumed from its
    checkpoint ends where the uninterrupted run does: params and optimizer
    state bit for bit (tests/test_fault_tolerance.py's contract)."""
    tc = get_arch("h2o-danube-1.8b").SMOKE_CONFIG
    opt = OptConfig(**OPT)
    step_fn = tsteps.make_lm_train_step(tc, opt)

    def batch_fn(step):
        return lm_batch(step, batch=2, seq_len=16, vocab=tc.vocab,
                        device="cpu")

    def fresh():
        p = tinit_lm(PRNGKey(0), tc, device="cpu")
        return p, init_opt_state(opt, p)
    p_a, s_a, hist = train_loop(step_fn, batch_fn, *fresh(),
                                TrainerConfig(total_steps=4, log_every=1))
    assert len(hist) == 4
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="injected crash"):
            train_loop(step_fn, batch_fn, *fresh(), TrainerConfig(
                total_steps=4, ckpt_every=2, ckpt_dir=d, crash_at_step=2))
        p_b, s_b, _ = train_loop(step_fn, batch_fn, *fresh(), TrainerConfig(
            total_steps=4, ckpt_every=2, ckpt_dir=d))
    for a, b in zip(tree_leaves((p_a, s_a)), tree_leaves((p_b, s_b))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_remat_on_and_off_give_the_same_bits():
    """Checkpointing each layer group recomputes the forward's bits, so
    the gradients with remat on and off are equal (the GNNs' in
    tests/test_torch_train_models.py)."""
    tc = dataclasses.replace(get_arch("h2o-danube-1.8b").SMOKE_CONFIG,
                             remat=True)
    tp = tinit_lm(PRNGKey(1), tc, device="cpu")
    toks = lm_batch(3, batch=2, seq_len=16, vocab=tc.vocab, device="cpu")
    grads = [tsteps.value_and_grad(lambda p: tsteps.lm_loss(
        p, dataclasses.replace(tc, remat=r), toks), tp) for r in (True, False)]
    assert torch.equal(grads[0][0][0], grads[1][0][0])
    for a, b in zip(tree_leaves(grads[0][1]), tree_leaves(grads[1][1])):
        assert torch.equal(a, b)


def test_jax_checkpoint_continues_in_the_port(danube_step):
    """Two JAX train steps, the params and optimizer state carried over
    (lm_params_from_numpy, opt_state_from_numpy), then a third step in
    each package: the same params within the step's tolerance."""
    jc, jp, tc, _ = _lm("h2o-danube-1.8b")
    jopt, topt = JOpt(**OPT), OptConfig(**OPT)
    jstep = danube_step
    js = jsteps.init_opt_state(jopt, jp)
    toks = [lm_batch(i, batch=4, seq_len=16, vocab=jc.vocab,
                     device="cpu").numpy() for i in range(3)]
    for t in toks[:2]:
        jp, js, _ = jstep(jp, js, jnp.asarray(t))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    jp, js, _ = jstep(jp, js, jnp.asarray(toks[2]))
    tp, ts, _ = tsteps.make_lm_train_step(tc, topt)(tp, ts,
                                                    torch.tensor(toks[2]))
    assert int(ts["step"]) == int(js["step"]) == 3
    _leafwise_close(tp, jp, 1e-5, "params", STEP_ATOL)
