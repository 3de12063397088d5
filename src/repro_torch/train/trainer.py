"""Host-side training loop, ported from the JAX package's
`train/trainer.py`: checkpoint / restart, stateless data skip-ahead,
periodic logging. One loop serves every model family (the step function
and the batch function are injected).

The fault-tolerance contract, the JAX package's:
  * the data pipeline is batch(step), pure in (seed, step);
  * checkpoints are atomic and carry the step counter
    (`checkpoint.manager`, the JAX package's on-disk layout);
  * restore + continue reproduces the uninterrupted run exactly: the port's
    train steps are deterministic (kernels without atomics, segment sums
    in input order), so the resumed run's params and optimizer state are
    the uninterrupted run's bit for bit.
The JAX loop jits the step; here it runs eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.train.optimizers import tree_leaves


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    crash_at_step: Optional[int] = None   # fault injection for tests


def train_loop(step_fn: Callable, batch_fn: Callable, params: Any,
               opt_state: Any, tcfg: TrainerConfig
               ) -> tuple[Any, Any, list[dict]]:
    """Run step_fn(params, opt_state, batch_fn(step)) from the latest
    checkpoint in `tcfg.ckpt_dir` (or step 0) to `tcfg.total_steps`,
    saving every `ckpt_every` steps and at the end; returns (params,
    opt_state, history), history one dict of float metrics (plus "step"
    and "wall_s") every `log_every` steps and at the last. Restored leaves
    land on the device of the params given. `crash_at_step` raises
    RuntimeError once that step is done (and checkpointed, if due)."""
    start = 0
    if tcfg.ckpt_dir:
        last = latest_step(tcfg.ckpt_dir)
        if last is not None:
            dev = tree_leaves(params)[0].device
            _, state = restore_checkpoint(
                tcfg.ckpt_dir, last, {"params": params, "opt": opt_state},
                device=dev)
            params, opt_state = state["params"], state["opt"]
            start = last
            print(f"[trainer] resumed from step {last}")

    history: list[dict] = []
    t0 = time.time()
    for step in range(start, tcfg.total_steps):
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % tcfg.log_every == 0 or step + 1 == tcfg.total_steps:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            m["wall_s"] = round(time.time() - t0, 2)
            history.append(m)
            print(f"[trainer] step {step + 1}: " +
                  " ".join(f"{k}={v:.4g}" for k, v in m.items()
                           if k != "step"), flush=True)
        if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
            save_checkpoint(tcfg.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state},
                            keep=tcfg.keep)
        if tcfg.crash_at_step is not None and step + 1 == tcfg.crash_at_step:
            raise RuntimeError(f"injected crash at step {step + 1}")
    # the last step's checkpoint, unless the loop just wrote it or
    # restored it (the JAX trainer writes it again; the bytes are the same)
    if tcfg.ckpt_dir and start < tcfg.total_steps and \
            tcfg.total_steps % tcfg.ckpt_every:
        save_checkpoint(tcfg.ckpt_dir, tcfg.total_steps,
                        {"params": params, "opt": opt_state}, keep=tcfg.keep)
    return params, opt_state, history
