"""Synthetic LM token pipeline, a port of the JAX package's `data/lm.py`:
a deterministic Zipf-ish token stream with enough local structure (bigram
chains) that a trained model's loss visibly drops below the unigram
entropy. Stateless-indexable: batch(step) is a pure function of (seed,
step), giving exact restart and skip-ahead after failures.

The draws are the JAX function's, made with the port's threefry
(`random.fold_in`, `split`, `randint`, `bernoulli`, `uniform`): every
step's key, jump, jump target and uniform are equal. The emission takes
floor(exp(u log(vocab / 64))) in f32, and torch's f32 exp is not XLA's
bit for bit: at vocab 512 (the smoke configs') the floor agrees with
JAX's on all 2**23 values the uniform can take, so every token is equal;
at vocab 32,000 it disagrees on 5 of them (tests/test_torch_train.py
counts them), so a token may differ, by one, with odds of ~6e-7 a draw.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.alid import resolve_device

N_STATES = 64


def lm_batch(step: int, *, batch: int, seq_len: int, vocab: int,
             seed: int = 0, device="cuda") -> torch.Tensor:
    """(batch, seq_len + 1) int32 tokens on `device`. A hidden 64-state
    Markov chain emits tokens with Zipf marginals: learnable structure, no
    dataset files. The draws are made on the host for all positions at
    once (a stack of keys draws one row per key), the chain's recurrence
    walked in numpy."""
    dev = resolve_device(device)
    rng = trandom.fold_in(trandom.PRNGKey(seed), int(step))
    k_state, k_noise = trandom.split(rng)
    s0 = trandom.randint(k_state, (batch,), 0, N_STATES).numpy()
    keys = trandom.split(k_noise, seq_len + 1)               # (T, 2)
    sub = trandom.split(keys)                                # (T, 2, 2)
    u = trandom.uniform(sub[:, 0], (batch,))                 # (T, B)
    # bernoulli(k1, 0.1) compares the same uniform draw with f32(0.1)
    jump = (u < torch.tensor(0.1, dtype=torch.float32)).numpy()
    target = trandom.randint(sub[:, 1], (batch,), 0, N_STATES).numpy()
    states = np.empty((seq_len + 1, batch), dtype=np.int64)
    s = s0
    for t in range(seq_len + 1):
        s = np.where(jump[t], target[t], (s * 5 + 1) % N_STATES)
        states[t] = s
    per = vocab // N_STATES
    log_per = torch.log(torch.tensor(float(per), dtype=torch.float32))
    zipf = torch.floor(torch.exp(u * log_per)) - 1
    tok = (torch.from_numpy(states) * per + zipf.to(torch.int64)) % vocab
    return tok.T.contiguous().to(device=dev, dtype=torch.int32)
