"""Kernel contract checker: runtime invariants of `repro_torch.kernels.ops`
(the twin of `repro.analysis.contracts`).

Three checks per op, each a rule in the report:

shape-dtype-mismatch  the op under backend="ref" (the plain PyTorch
                      version) and backend="kernel" (the CUDA kernel) on the
                      same operands on the card must produce identical
                      output shapes and dtypes: the counterpart of the JAX
                      package's ref against interpret. All ten ops, as
                      there; `pairwise_distance` has no kernel, and its
                      "kernel" backend validates the card and runs the
                      plain version. The kernel side needs the card; with
                      device "cpu" only the plain side runs, and the report
                      records the kernel side as not run, with the reason.
smem-budget           the shared memory a launch asks of one block must fit
                      sm_90's opt-in limit, 232,448 bytes (the `SMEM_MAX`
                      the plans use; a fact of the card, not a knob): each
                      kernel's dynamic bytes from its own plan, at the
                      contract cases and at the main path's full-width
                      shapes (pure Python), plus, on the card, the static
                      `__shared__` bytes of its source's kernels as the
                      loaded library declares them
                      (`kernels._build.static_smem`, cudaFuncGetAttributes).
padded-tail           the padded-slot contracts, checked by poisoning pad
                      regions and asserting valid-slot outputs BIT-identical
                      to a zero-padded baseline (see POISON_CHECKS). NaN is
                      the poison wherever the contract masks by selection;
                      where the contract folds masks into weights
                      (affinity_matvec's c side, the sweep's refresh) the pad
                      rows get large finite garbage instead, since NaN * 0.0
                      is NaN. They run on "ref" everywhere and on "kernel"
                      on the card.

`OP_CASES` and `POISON_CHECKS` are importable: the tests parametrize over
them, and `utils.golden` holds the ops' outputs on these cases to the JAX
package's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.analysis.report import Report, Violation

PASS = "contracts"
# the dynamic shared memory one sm_90 block may opt into (227 KB)
SMEM_BUDGET = 232_448

_OPS_PATH = "src/repro_torch/kernels/ops.py"


# --------------------------------------------------------------- op corpus --
class OpCase(NamedTuple):
    name: str
    make: Callable[[], tuple[tuple, dict]]   # -> (args, kwargs) in numpy
    has_kernel: bool = True


def _rng():
    return np.random.default_rng(0)


def _f32(a):
    return np.asarray(a, np.float32)


def _case_affinity():
    r = _rng()
    return (_f32(r.normal(size=(32, 8))), _f32(r.normal(size=(48, 8))),
            0.5), {}


def _case_pairwise_distance():
    r = _rng()
    return (_f32(r.normal(size=(16, 8))), _f32(r.normal(size=(24, 8)))), {}


def _case_affinity_matvec():
    r = _rng()
    return (_f32(r.normal(size=(32, 8))),
            np.arange(32, dtype=np.int32),
            _f32(r.normal(size=(64, 8))),
            np.arange(64, dtype=np.int32),
            _f32(r.uniform(0.1, 1.0, size=(64,))),
            0.5), {}


def _case_roi_filter():
    r = _rng()
    return (_f32(r.normal(size=(64, 8))), _f32(r.normal(size=(8,))),
            2.0, np.ones((64,), bool)), {}


def _case_assign():
    r = _rng()
    return (_f32(r.normal(size=(32, 8))),
            _f32(r.normal(size=(4, 8, 8))),
            _f32(r.uniform(0.1, 1.0, size=(4, 8))),
            _f32(r.uniform(0.5, 1.0, size=(4,))),
            0.5, 0.1), {}


def _case_flash_attention():
    r = _rng()
    q = _f32(r.normal(size=(2, 2, 32, 64)))
    k = _f32(r.normal(size=(2, 2, 32, 64)))
    v = _f32(r.normal(size=(2, 2, 32, 64)))
    return (q, k, v), {"causal": False}


def _case_segment_matmul():
    r = _rng()
    seg = np.sort(r.integers(0, 16, size=(64,))).astype(np.int32)
    return (_f32(r.normal(size=(64, 16))), seg, 16), {}


def _case_embedding_bag():
    r = _rng()
    return (_f32(r.normal(size=(128, 16))),
            r.integers(0, 128, size=(64,)).astype(np.int32),
            np.sort(r.integers(0, 16, size=(64,))).astype(np.int32),
            16), {}


def _case_lid_sweep():
    """One seed's (cap, d) block, as the JAX package's case; the port's op
    takes a batch of seeds, so `operands` adds a leading batch of 1."""
    r = _rng()
    x = np.zeros((32,), np.float32)
    x[0] = 1.0
    return (_f32(r.normal(size=(32, 8))),
            np.arange(32, dtype=np.int32),
            np.ones((32,), bool),
            x,
            np.zeros((32,), np.float32),
            np.asarray(0, np.int32),
            np.asarray(False),
            0.5), {"n_steps": 8, "max_iters": 32, "tol": 1e-5}


def _case_lsh_hash():
    r = _rng()
    return (_f32(r.normal(size=(32, 8))),
            _f32(r.normal(size=(4, 3, 8))),
            _f32(r.uniform(0.0, 0.25, size=(4, 3))),
            0.25), {}


OP_CASES = (
    OpCase("affinity", _case_affinity),
    OpCase("pairwise_distance", _case_pairwise_distance, has_kernel=False),
    OpCase("affinity_matvec", _case_affinity_matvec),
    OpCase("roi_filter", _case_roi_filter),
    OpCase("assign_clusters", _case_assign),
    OpCase("flash_attention", _case_flash_attention),
    OpCase("segment_matmul", _case_segment_matmul),
    OpCase("embedding_bag", _case_embedding_bag),
    OpCase("lsh_hash", _case_lsh_hash),
    OpCase("lid_sweep", _case_lid_sweep),
)
# the ops whose cases take one seed where the port's op takes a batch
BATCHED_OPS = ("lid_sweep",)


def operands(name: str, args: tuple, device) -> tuple:
    """A case's numpy arguments as the port's op takes them on `device`:
    arrays become tensors (copied), Python scalars stay; `lid_sweep`'s
    one seed becomes a batch of one."""
    out = []
    for a in args:
        if isinstance(a, np.ndarray):
            if name in BATCHED_OPS:
                a = a[None]
            a = torch.tensor(a, device=device)
        out.append(a)
    return tuple(out)


def run_op(name: str, args: tuple, kwargs: dict, backend: str):
    """The op `name` of `repro_torch.kernels.ops` on tensor operands,
    outputs as a tuple of tensors."""
    from repro_torch.kernels import ops
    out = getattr(ops, name)(*args, backend=backend, **kwargs)
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _sig(outs) -> list:
    return [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in outs]


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _kernel_side_skipped(device) -> str:
    return (f"not run: the pass ran with device {torch.device(device)}; "
            "the CUDA kernels need the card")


# ------------------------------------------------------- shape/dtype check --
def check_shapes(report: Report, device="cuda") -> None:
    checked = ref_run = 0
    for case in OP_CASES:
        args, kwargs = case.make()
        try:
            ref = run_op(case.name, operands(case.name, args, device),
                         kwargs, "ref")
            ref_run += 1
            if not _on_card(device):
                continue
            ker = run_op(case.name, operands(case.name, args, device),
                         kwargs, "kernel")
        except Exception as e:                      # noqa: BLE001 - reported
            report.add(Violation(
                PASS, "contract-error", _OPS_PATH, 0,
                f"{case.name}: raised {type(e).__name__}: {e}"))
            continue
        checked += 1
        if _sig(ref) != _sig(ker):
            report.add(Violation(
                PASS, "shape-dtype-mismatch", _OPS_PATH, 0,
                f"{case.name}: ref {_sig(ref)} != kernel {_sig(ker)}: the "
                "kernel's outputs drifted from the plain version's"))
    report.note(PASS, ops_ref_run=ref_run, ops_shape_checked=checked)
    if not _on_card(device):
        report.note(PASS, kernel_side=_kernel_side_skipped(device))


# ---------------------------------------------------- shared memory check --
def _flash(b, h, hkv, sq, sk, dh, q_offset=0, bf16=False, **mask):
    """(route, dynamic bytes, source) of a flash_attention launch."""
    from repro_torch.kernels import flash_attention as fa
    pl = fa.kernel_plan(b, h, hkv, sq, sk, dh, q_offset, bf16=bf16, **mask)
    rep = h // hkv
    if pl.kernel == "tiles":
        return pl.kernel, fa.smem_plan(dh, rep, sq)[3], "flash_attention"
    if pl.kernel == "wgmma":
        return pl.kernel, fa.wgmma_plan(dh, rep, sq)[2], "flash_wgmma"
    if pl.kernel == "split":
        # the widest load a row allows (aligned tensors): the most bytes
        vec = 8 if bf16 else 4
        while dh % vec:
            vec //= 2
        return (pl.kernel, fa.split_smem_bytes(dh, rep * sq, vec),
                "flash_attention")
    return pl.kernel, fa.small_smem_bytes(dh), "flash_attention"


def _flash_bwd(h, hkv, s, dh, bf16=False):
    """(route, dynamic bytes of its larger kernel, source) of the attention
    backward's launches at one training shape."""
    from repro_torch.kernels import flash_attention as fa
    pl = fa.bwd_plan(h, hkv, s, s, dh, bf16=bf16)
    source = {"wgmma": "flash_bwd_wgmma", "small": "flash_bwd_small"}
    return (pl.kernel, max(pl.dq_smem, pl.dkdv_smem),
            source.get(pl.kernel, "flash_attention_bwd"))


def _plan(module: str, *shape):
    """(route, dynamic bytes, source) of a kernel whose plan names them."""
    import importlib
    pl = importlib.import_module(f"repro_torch.kernels.{module}").plan(*shape)
    return getattr(pl, "route", getattr(pl, "kernel", "")), pl.smem, module


def _none(source: str):
    """A kernel whose launches ask no dynamic shared memory."""
    return lambda: ("-", 0, source)


# (op, shape, thunk -> (route, dynamic bytes, source of its kernels)): the
# contract cases' shapes, then the main path's at full width (chip_smoke.py
# phase 2 and the kernel table of PERF.md)
SMEM_CASES = (
    ("lsh_hash", "case 32 x 8, L 4 x m 3",
     lambda: _plan("lsh_hash", 32, 8, 4, 3)),
    ("lsh_hash", "store build 1,000,000 x 128, L 4 x m 8",
     lambda: _plan("lsh_hash", 1_000_000, 128, 4, 8)),
    ("lsh_hash", "CIVS probe 3,584 x 128, L 4 x m 8",
     lambda: _plan("lsh_hash", 3584, 128, 4, 8)),
    ("roi_filter", "case 64 x 8", lambda: _plan("roi_filter", 64, 8)),
    ("roi_filter", "32 x 7,168 x 128",
     lambda: _plan("roi_filter", 32 * 7168, 128)),
    ("roi_filter", "32 x 7,168 x 128 bf16",
     lambda: _plan("roi_filter", 32 * 7168, 128, torch.bfloat16)),
    ("affinity_matvec", "case 32 x 64 x 8",
     lambda: _plan("affinity_matvec", 32, 64, 8)),
    ("affinity_matvec", "32 x 240 x 240 x 128",
     lambda: _plan("affinity_matvec", 240, 240, 128)),
    ("affinity_matvec", "32 x 240 x 112 x 128",
     lambda: _plan("affinity_matvec", 240, 112, 128)),
    ("lid_sweep", "case 1 x (32, 8)", lambda: _plan("lid_sweep", 1, 32, 8)),
    ("lid_sweep", "32 x (240, 128)", lambda: _plan("lid_sweep", 32, 240, 128)),
    ("assign_clusters", "case 32 x 4 x 8 x 8",
     lambda: _plan("assign", 32, 4, 8, 8)),
    ("assign_clusters", "64 x 2,048 x 240 x 128",
     lambda: _plan("assign", 64, 2048, 240, 128)),
    ("assign_clusters", "4 x 2,048 x 240 x 128",
     lambda: _plan("assign", 4, 2048, 240, 128)),
    ("affinity", "case 32 x 48 x 8",
     lambda: _plan("affinity", 32, 48, 8, False)),
    ("affinity", "40,000 x 40,000 x 128 symmetric",
     lambda: _plan("affinity", 40_000, 40_000, 128, True)),
    ("affinity", "40,000 x 40,000 x 128 general",
     lambda: _plan("affinity", 40_000, 40_000, 128, False)),
    ("flash_attention", "case 2 x 2 x 32 x 32 x 64 f32",
     lambda: _flash(2, 2, 2, 32, 32, 64, causal=False)),
    ("flash_attention", "prefill 4 x 32 / 8 x 5,120 over 5,137 x 80 f32",
     lambda: _flash(4, 32, 8, 5120, 5137, 80, window=4096)),
    ("flash_attention", "prefill 4 x 32 / 8 x 5,120 over 5,137 x 80 bf16",
     lambda: _flash(4, 32, 8, 5120, 5137, 80, bf16=True, window=4096)),
    ("flash_attention", "decode 4 x 32 / 8 x 1 over 5,137 x 80 f32",
     lambda: _flash(4, 32, 8, 1, 5137, 80, 5120, window=4096)),
    ("flash_attention", "decode 4 x 32 / 8 x 1 over 5,137 x 80 bf16",
     lambda: _flash(4, 32, 8, 1, 5137, 80, 5120, bf16=True, window=4096)),
    ("flash_attention", "BST 512 x 8 x 21 x 21 x 4 f32",
     lambda: _flash(512, 8, 8, 21, 21, 4, causal=False)),
    ("embedding_bag", "case 64 ids into 16 bags of 128 x 16",
     _none("embedding_bag")),
    ("embedding_bag", "BST bags of 8 over 131,072 x 32",
     _none("embedding_bag")),
    ("segment_matmul", "case 64 x 16 into 16", _none("segment_matmul")),
    ("segment_matmul", "61,859,328 x 100 into 2,449,029",
     _none("segment_matmul")),
    # the backward kernels at the training paths' shapes (chip_smoke.py
    # phase 13) and the widest head the kernel takes
    ("flash_attention_bwd", "danube 32 / 8 x 5,120 x 80 bf16",
     lambda: _flash_bwd(32, 8, 5120, 80, bf16=True)),
    ("flash_attention_bwd", "gemma2 global 32 / 16 x 4,096 x 128 bf16",
     lambda: _flash_bwd(32, 16, 4096, 128, bf16=True)),
    ("flash_attention_bwd", "llama4 chunked 40 / 8 x 9,216 x 128 bf16",
     lambda: _flash_bwd(40, 8, 9216, 128, bf16=True)),
    ("flash_attention_bwd", "danube 32 / 8 x 5,120 x 80 bf16, tiles",
     lambda: _flash_bwd(32, 8, 5120, 80)),
    ("flash_attention_bwd", "lm-100m 12 / 4 x 256 x 64 f32",
     lambda: _flash_bwd(12, 4, 256, 64)),
    ("flash_attention_bwd", "dh 256, 4 / 4 x 100 bf16",
     lambda: _flash_bwd(4, 4, 100, 256, bf16=True)),
    ("flash_attention_bwd", "BST 8 x 21 x 21 x 4",
     lambda: _flash_bwd(8, 8, 21, 4)),
    ("segment_matmul_bwd", "61,859,328 x 100 from 2,449,029",
     _none("segment_bwd")),
    ("embedding_bag_bwd", "BST train_batch bags into 131,072 x 32",
     _none("segment_bwd")),
)


def check_smem(report: Report, device="cuda", budget: int = SMEM_BUDGET,
               cases=SMEM_CASES) -> None:
    """Each case's dynamic bytes (its plan's) plus, on the card, the most
    static bytes of its source's kernels, against `budget`."""
    static: dict[str, int] = {}
    if _on_card(device):
        from repro_torch.kernels import _build
        static = {s: _build.static_smem(s)
                  for s in _build.STATIC_SMEM_SOURCES}
    by_op: dict[str, int] = {}
    rows = []
    for op, shape, thunk in cases:
        try:
            route, dyn, source = thunk()
        except ValueError as e:     # a plan that fits no block
            report.add(Violation(PASS, "smem-budget", _OPS_PATH, 0,
                                 f"{op} at {shape}: {e}"))
            continue
        total = dyn + static.get(source, 0)
        by_op[op] = max(by_op.get(op, 0), total)
        rows.append({"op": op, "shape": shape, "route": route,
                     "dynamic": int(dyn),
                     "static": static.get(source) if static else None})
        if total > budget:
            report.add(Violation(
                PASS, "smem-budget", _OPS_PATH, 0,
                f"{op} at {shape} ({route}): {total} bytes of shared memory "
                f"a block ({dyn} dynamic + {total - dyn} static) exceed "
                f"the {budget} a block may have"))
    report.note(PASS, smem_bytes_by_op=by_op, smem_budget_bytes=int(budget),
                smem_cases=rows,
                static_smem_by_source=static if static else
                _kernel_side_skipped(device))


# ------------------------------------------------------- padded-tail check --
def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a = a.detach().cpu().contiguous()
    b = b.detach().cpu().contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.bool:
        return bool(torch.equal(a, b))
    return a.view(torch.uint8).numpy().tobytes() == \
        b.view(torch.uint8).numpy().tobytes()


def _t(a, device):
    return torch.tensor(np.asarray(a), device=device)


def _poison_affinity_matvec_q(backend: str, device) -> Optional[str]:
    """q-side contract: out_i depends only on row i; NaN/Inf rows past the
    valid prefix must leave the prefix bit-unchanged."""
    from repro_torch.kernels import ops
    (q, qi, c, ci, w, k), _ = _case_affinity_matvec()
    clean = np.concatenate([q, np.zeros((8, q.shape[1]), np.float32)])
    dirty = clean.copy()
    dirty[32:36] = np.nan
    dirty[36:] = np.inf
    qi_pad = np.concatenate([qi, np.full((8,), -1, np.int32)])
    rest = [_t(a, device) for a in (qi_pad, c, ci, w)]
    base = ops.affinity_matvec(_t(clean, device), *rest, k, backend=backend)
    out = ops.affinity_matvec(_t(dirty, device), *rest, k, backend=backend)
    if not _bits_equal(base[:32], out[:32]):
        return "valid-row outputs changed when pad q rows were poisoned"
    return None


def _poison_affinity_matvec_c(backend: str, device) -> Optional[str]:
    """c-side contract: pad candidate rows with w = 0 contribute exactly 0.0
    whatever (finite) garbage sits in them."""
    from repro_torch.kernels import ops
    (q, qi, c, ci, w, k), _ = _case_affinity_matvec()
    pad = 16
    w_pad = np.concatenate([w, np.zeros((pad,), np.float32)])
    ci_pad = np.concatenate([ci, np.full((pad,), 10_000, np.int32)])
    c_zero = np.concatenate([c, np.zeros((pad, c.shape[1]), np.float32)])
    c_junk = np.concatenate([c, np.full((pad, c.shape[1]), 1e6, np.float32)])
    qs, qis, cis, ws = (_t(a, device) for a in (q, qi, ci_pad, w_pad))
    base = ops.affinity_matvec(qs, qis, _t(c_zero, device), cis, ws, k,
                               backend=backend)
    out = ops.affinity_matvec(qs, qis, _t(c_junk, device), cis, ws, k,
                              backend=backend)
    if not _bits_equal(base, out):
        return "w=0 pad candidate rows leaked into the matvec output"
    return None


def _poison_roi_filter(backend: str, device) -> Optional[str]:
    from repro_torch.kernels import ops
    (vc, center, radius, _valid), _ = _case_roi_filter()
    valid = np.ones((64,), bool)
    valid[48:] = False
    dirty = vc.copy()
    dirty[48:56] = np.nan
    dirty[56:] = np.inf
    clean = vc.copy()
    clean[48:] = 0.0
    cen, val = _t(center, device), _t(valid, device)
    b_d, b_ok, b_neg = ops.roi_filter(_t(clean, device), cen, radius, val,
                                      backend=backend)
    d, ok, neg = ops.roi_filter(_t(dirty, device), cen, radius, val,
                                backend=backend)
    if not (_bits_equal(b_d[:48], d[:48]) and _bits_equal(b_ok[:48], ok[:48])
            and _bits_equal(b_neg[:48], neg[:48])):
        return "valid-slot outputs changed when invalid vc rows were poisoned"
    if bool(ok[48:].any()):
        return "poisoned invalid slots came back valid_out=True"
    if not bool((neg[48:] == float("-inf")).all()):
        return "poisoned invalid slots must rank -inf in neg"
    return None


def _poison_assign(backend: str, device) -> Optional[str]:
    from repro_torch.kernels import ops
    (q, sup_v, sup_w, dens, k, thr), _ = _case_assign()
    valid = np.ones((32,), bool)
    valid[24:] = False
    clean = q.copy()
    clean[24:] = 0.0
    dirty = q.copy()
    dirty[24:28] = np.nan
    dirty[28:] = np.inf
    rest = [_t(a, device) for a in (sup_v, sup_w, dens)]
    val = _t(valid, device)
    bl, bs = ops.assign_clusters(_t(clean, device), *rest, k, thr,
                                 valid=val, backend=backend)
    lab, sc = ops.assign_clusters(_t(dirty, device), *rest, k, thr,
                                  valid=val, backend=backend)
    if not (_bits_equal(bl[:24], lab[:24]) and _bits_equal(bs[:24], sc[:24])):
        return "valid-slot labels/scores changed when pad q rows were poisoned"
    if not bool((lab[24:] == -1).all()):
        return "poisoned pad slots must get label -1 exactly"
    if not bool((sc[24:] == 0.0).all()):
        return "poisoned pad slots must get score 0.0 exactly"
    return None


def _poison_lsh_hash(backend: str, device) -> Optional[str]:
    from repro_torch.kernels import ops
    (x, proj, bias, seg), _ = _case_lsh_hash()
    clean = np.concatenate([x, np.zeros((8, x.shape[1]), np.float32)])
    dirty = clean.copy()
    dirty[32:] = np.nan
    p, b = _t(proj, device), _t(bias, device)
    base = ops.lsh_hash(_t(clean, device), p, b, seg, backend=backend)
    out = ops.lsh_hash(_t(dirty, device), p, b, seg, backend=backend)
    if not _bits_equal(base[:32], out[:32]):
        return "valid-row bucket keys changed when pad rows were poisoned"
    return None


def _poison_flash_attention_kv_start(backend: str, device) -> Optional[str]:
    """Left-pad contract: kv slots < kv_start[b] are never attended. K pads
    get NaN (a masked logit must be killed by selection, not arithmetic); V
    pads get huge-but-finite garbage: the mask zeroes their softmax weight
    EXACTLY, and 0 * 1e30 is 0 while 0 * NaN would be NaN even for a
    correct softmax mask."""
    from repro_torch.kernels import ops
    (q, k, v), kw = _case_flash_attention()
    kv_start = _t(np.asarray([0, 8], np.int32), device)
    k_dirty, v_dirty = k.copy(), v.copy()
    k_dirty[1, :, :8, :] = np.nan
    v_dirty[1, :, :8, :] = 1e30
    k_clean, v_clean = k.copy(), v.copy()
    k_clean[1, :, :8, :] = 0.0
    v_clean[1, :, :8, :] = 0.0
    qs = _t(q, device)
    base = ops.flash_attention(qs, _t(k_clean, device), _t(v_clean, device),
                               kv_start=kv_start, backend=backend, **kw)
    out = ops.flash_attention(qs, _t(k_dirty, device), _t(v_dirty, device),
                              kv_start=kv_start, backend=backend, **kw)
    if not _bits_equal(base, out):
        return "poisoned pre-kv_start slots leaked into attention output"
    return None


def _poison_segment_matmul(backend: str, device) -> Optional[str]:
    from repro_torch.kernels import ops
    (msg, seg, n_seg), _ = _case_segment_matmul()
    pad = 8
    seg_pad = _t(np.concatenate([seg, np.full((pad,), -1, np.int32)]),
                 device)
    m_zero = np.concatenate([msg, np.zeros((pad, msg.shape[1]), np.float32)])
    m_dirty = np.concatenate(
        [msg, np.full((pad, msg.shape[1]), np.nan, np.float32)])
    base = ops.segment_matmul(_t(m_zero, device), seg_pad, n_seg,
                              backend=backend)
    out = ops.segment_matmul(_t(m_dirty, device), seg_pad, n_seg,
                             backend=backend)
    if not _bits_equal(base, out):
        return "seg_id=-1 pad rows with NaN messages leaked into segments"
    return None


def _poison_embedding_bag(backend: str, device) -> Optional[str]:
    """idx < 0 pad contract (no float pad to poison): a padded lookup must
    be bit-identical to the stripped one."""
    from repro_torch.kernels import ops
    (table, idx, bags, n_bags), _ = _case_embedding_bag()
    pad = 8
    idx_pad = np.concatenate([idx, np.full((pad,), -1, np.int32)])
    bags_pad = np.concatenate([bags, np.full((pad,), -1, np.int32)])
    tab = _t(table, device)
    base = ops.embedding_bag(tab, _t(idx, device), _t(bags, device), n_bags,
                             backend=backend)
    out = ops.embedding_bag(tab, _t(idx_pad, device), _t(bags_pad, device),
                            n_bags, backend=backend)
    if not _bits_equal(base, out):
        return "idx=-1 pad entries changed the pooled bags"
    return None


def _poison_lid_sweep(backend: str, device, refresh_every: int,
                      finite: bool) -> Optional[str]:
    """Masked-off v_beta rows must never reach valid-slot outputs. With the
    periodic refresh OFF the per-step column is pure selection (NaN/Inf
    pads); with refresh ON the pad columns fold into the masked matvec as
    weight-0 terms, so that contract is zero-weight-doesn't-matter and its
    poison is large finite garbage."""
    from repro_torch.kernels import ops
    r = np.random.default_rng(3)
    n_valid, pad, d = 24, 8, 8
    cap = n_valid + pad
    v = _f32(r.normal(size=(cap, d)))
    idx = np.arange(cap, dtype=np.int32)
    mask = np.zeros((cap,), bool)
    mask[:n_valid] = True
    clean = v.copy()
    clean[n_valid:] = 0.0
    dirty = v.copy()
    if finite:
        dirty[n_valid:] = 1e6
    else:
        dirty[n_valid:n_valid + 4] = np.nan
        dirty[n_valid + 4:] = np.inf
    k = 0.5
    x = np.zeros((cap,), np.float32)
    x[0] = 1.0
    ax = np.zeros((cap,), np.float32)
    dist = np.sqrt(((clean[:n_valid] - clean[0]) ** 2).sum(-1))
    ax[:n_valid] = np.exp(-k * dist)
    ax[0] = 0.0
    kw = dict(n_steps=16, max_iters=64, tol=1e-5,
              refresh_every=refresh_every, backend=backend)
    rest = [_t(a[None], device) for a in (idx, mask, x, ax)]
    it0 = torch.zeros((1,), dtype=torch.int32, device=device)
    cv0 = torch.zeros((1,), dtype=torch.bool, device=device)
    base = ops.lid_sweep(_t(clean[None], device), *rest, it0, cv0, k, **kw)
    out = ops.lid_sweep(_t(dirty[None], device), *rest, it0, cv0, k, **kw)
    if int(base[2][0]) < 2:
        return "scenario converged immediately: poison never exercised"
    for name, b_, o_ in zip(("x", "ax", "n_iters", "converged"), base, out):
        if not _bits_equal(b_, o_):
            return f"poisoned pad rows changed {name} on valid slots"
    return None


def _poison_lid_sweep_pad(backend: str, device) -> Optional[str]:
    return _poison_lid_sweep(backend, device, refresh_every=0, finite=False)


def _poison_lid_sweep_refresh(backend: str, device) -> Optional[str]:
    return _poison_lid_sweep(backend, device, refresh_every=2, finite=True)


# name -> check(backend, device) -> error string or None; importable by the
# tests; the names are the JAX package's
POISON_CHECKS: dict[str, Callable[[str, object], Optional[str]]] = {
    "affinity_matvec_q_side": _poison_affinity_matvec_q,
    "affinity_matvec_c_side": _poison_affinity_matvec_c,
    "roi_filter": _poison_roi_filter,
    "assign_clusters": _poison_assign,
    "lsh_hash": _poison_lsh_hash,
    "flash_attention_kv_start": _poison_flash_attention_kv_start,
    "segment_matmul": _poison_segment_matmul,
    "embedding_bag": _poison_embedding_bag,
    "lid_sweep_pad_rows": _poison_lid_sweep_pad,
    "lid_sweep_refresh_pad": _poison_lid_sweep_refresh,
}

POISON_BACKENDS = ("ref", "kernel")


def check_padded_tail(report: Report, device="cuda") -> None:
    backends = POISON_BACKENDS if _on_card(device) else ("ref",)
    ran = {b: 0 for b in backends}
    for name, check in POISON_CHECKS.items():
        for backend in backends:
            try:
                problem = check(backend, device)
            except Exception as e:                  # noqa: BLE001 - reported
                problem = f"raised {type(e).__name__}: {e}"
            ran[backend] += 1
            if problem:
                report.add(Violation(
                    PASS, "padded-tail", _OPS_PATH, 0,
                    f"{name} [{backend}]: {problem}"))
    report.note(PASS, poison_scenarios_run=sum(ran.values()),
                poison_runs_by_backend=ran)


def run(root: str, report: Report, device="cuda",
        smem_budget: int = SMEM_BUDGET) -> None:
    """The three checks on `device`: the card unless the caller asks for
    the CPU. Asked for the card on a host with none, the pass fails; it
    does not carry on on the CPU."""
    del root  # runtime pass; operates on the imported package
    report.note(PASS, device=str(torch.device(device)))
    if _on_card(device) and not torch.cuda.is_available():
        report.add(Violation(
            PASS, "no-device", _OPS_PATH, 0,
            f"the runtime pass was asked to run on {device}, and this host "
            "has no CUDA device; pass --device cpu to run the plain side "
            "only"))
        return
    if _on_card(device):
        report.note(PASS, device_name=torch.cuda.get_device_name(
            torch.device(device)))
    check_shapes(report, device)
    check_smem(report, device, smem_budget)
    check_padded_tail(report, device)
