"""Resilience layer: retry policy and deterministic fault injection (a numpy
copy of the JAX package's `core/resilience.py`; the port imports nothing of
that package).

The paper's headline run is 2.29 hours over 50M points; at that horizon a
single transient I/O error aborting the whole fit is the dominant practical
failure mode. This module supplies the two halves of the failure story:

  * RetryPolicy      — bounded attempts with exponential backoff and
                       DETERMINISTIC seeded jitter. Every I/O tier (source
                       reads, scratch slab reads, the shard-prefetch
                       producer) retries transient `OSError`s through one
                       policy instead of dying on the first EIO;
  * ResilientSource  — transparent DataSource wrapper applying a RetryPolicy
                       to `get_chunk`/`sample`, so every source touch point
                       (store build, seed rows, support gathers, the
                       prefetch reader) is covered from ONE choke point —
                       `engine.fit` wraps its source on the way in;
  * FaultySource     — the fault injector: wraps any DataSource with a
                       seeded schedule of transient `OSError`s. Transient BY
                       CONSTRUCTION: a per-logical-request failure budget
                       (`fail_times` < RetryPolicy.attempts) guarantees a
                       retried request eventually succeeds with the same
                       bytes, so a faulty fit is bit-identical to a clean
                       one under ANY thread interleaving;
  * PipelineFaults   — shard-pipeline hooks: corrupt a scratch slab right
                       before a seeded fraction of fetches (exercising the
                       checksum + tier-fallback chain), or kill the prefetch
                       reader at the k-th produced bundle (exercising the
                       consumer's inline-fallback path).

Error taxonomy: `CorruptionError` marks a checksum mismatch
in a storage tier (cache entry / scratch slab / checkpoint leaf) — never
retried in place, always handled by falling back to the next tier down;
transient `OSError`s are retried with backoff; everything else propagates
(a genuine bug must not be masked by retries).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np

from repro_torch.core.source import DataSource, _SourceBase

__all__ = ["RetryPolicy", "DEFAULT_RETRY", "CorruptionError",
           "ResilientSource", "FaultySource", "PipelineFaults",
           "InjectedFault", "ReaderKilled"]


class CorruptionError(RuntimeError):
    """A storage tier's bytes failed their checksum (scratch slab, cache
    entry, or checkpoint leaf). Unlike a transient read error this is NOT
    retried in place — re-reading corrupt bytes yields corrupt bytes — the
    owner falls back to the next tier down (cache -> scratch -> source) or,
    when no clean tier remains (a mutated shard whose scratch slab is the
    sole owner of the bytes), surfaces the corruption to the caller."""


class InjectedFault(OSError):
    """A FaultySource-injected transient read error (an OSError subclass so
    the production retry path treats it exactly like a real EIO)."""


class ReaderKilled(RuntimeError):
    """PipelineFaults killed the prefetch reader (non-transient by design —
    exercises the consumer's inline-fallback path, not the retry path)."""


class RetryPolicy(NamedTuple):
    """Bounded retries with exponential backoff + deterministic jitter.

    `call(fn, *args)` runs fn, retrying up to `attempts` total tries when it
    raises one of `retryable`. Delay before retry i (0-based) is
    `base_delay * 2**i`, capped at `max_delay`, times a jitter factor drawn
    from [1-jitter, 1+jitter) — the draws come from a PRNG seeded PER CALL
    with `seed`, so the backoff schedule is reproducible (no wall-clock or
    global-RNG dependence; two runs of the same fit sleep the same
    schedule). Non-retryable exceptions propagate immediately: retries mask
    transient I/O, never bugs.
    """

    attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.25
    seed: int = 0
    retryable: tuple = (OSError,)

    def delays(self) -> list:
        """The full backoff schedule (attempts - 1 sleeps), reproducible."""
        rng = np.random.default_rng(self.seed)
        out = []
        for i in range(max(0, self.attempts - 1)):
            d = min(self.base_delay * (2.0 ** i), self.max_delay)
            out.append(d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)))
        return out

    def call(self, fn: Callable, *args,
             on_retry: Optional[Callable] = None,
             sleep: Callable = time.sleep, **kwargs):
        """Run fn(*args, **kwargs) under the policy. `on_retry(attempt, exc)`
        fires before each backoff sleep (stats counters); `sleep` is
        injectable so tests exercise the schedule without waiting it out."""
        delays = self.delays()
        for attempt in range(self.attempts):
            try:
                return fn(*args, **kwargs)
            except self.retryable as exc:
                if attempt >= self.attempts - 1:
                    raise
                if on_retry is not None:
                    on_retry(attempt, exc)
                sleep(delays[attempt])


# the stack-wide default: every `fit` wraps its source with this unless the
# caller passes retry_policy=None (benchmarks measuring the raw path do)
DEFAULT_RETRY = RetryPolicy()


class ResilientSource(_SourceBase):
    """Transparent DataSource wrapper applying a RetryPolicy to reads.

    Bytes pass through untouched (wrapping can never change a clustering);
    only transient errors in `policy.retryable` are absorbed, and only up to
    the attempt budget. `retries` counts absorbed errors (lock-protected —
    the streamed engine reads sources from several threads). `fit` wraps
    its source here so the build pass, seed-row fetches, support gathers and
    the shard-prefetch reader are all covered by one policy."""

    def __init__(self, inner: DataSource, policy: RetryPolicy = DEFAULT_RETRY,
                 sleep: Callable = time.sleep):
        self.inner = inner
        self.policy = policy
        self._sleep = sleep
        self._lock = threading.Lock()
        self.retries = 0
        # extra counters told of each absorbed error (the streamed engine
        # adds its PipelineStats.read_retries here)
        self.retry_hooks: list = []

    @property
    def n(self) -> int:
        return self.inner.n

    @property
    def dim(self) -> int:
        return self.inner.dim

    def _on_retry(self, attempt, exc) -> None:
        with self._lock:
            self.retries += 1
        for hook in self.retry_hooks:
            hook(attempt, exc)

    def get_chunk(self, start: int, size: int) -> np.ndarray:
        return self.policy.call(self.inner.get_chunk, start, size,
                                on_retry=self._on_retry, sleep=self._sleep)

    def sample(self, idx: np.ndarray) -> np.ndarray:
        return self.policy.call(self.inner.sample, idx,
                                on_retry=self._on_retry, sleep=self._sleep)


def resilient(source: DataSource,
              policy: Optional[RetryPolicy]) -> DataSource:
    """Wrap `source` for transient-read retries (idempotent: an already-
    wrapped source or policy=None passes through)."""
    if policy is None or isinstance(source, ResilientSource):
        return source
    return ResilientSource(source, policy)


class FaultySource(_SourceBase):
    """Deterministic transient-fault injector over any DataSource.

    Each `get_chunk`/`sample` call draws from a seeded PRNG under a lock;
    with probability `rate` the call raises `InjectedFault` (an OSError)
    INSTEAD of reading. Transient by construction: per logical request
    (op, start/index fingerprint) at most `fail_times` consecutive failures
    are injected, so any retry loop with attempts > fail_times is guaranteed
    to eventually get the true bytes — which is what makes a faulty fit
    bit-identical to a clean one regardless of how the prefetch / seed /
    fit-loop threads interleave their draws. `injected` counts raised faults.
    """

    def __init__(self, inner: DataSource, rate: float = 0.1, seed: int = 0,
                 fail_times: int = 2, ops: tuple = ("get_chunk", "sample")):
        self.inner = inner
        self.rate = float(rate)
        self.fail_times = int(fail_times)
        self.ops = tuple(ops)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._consecutive: dict = {}
        self.injected = 0
        self.calls = 0

    @property
    def n(self) -> int:
        return self.inner.n

    @property
    def dim(self) -> int:
        return self.inner.dim

    def _maybe_fail(self, op: str, fingerprint) -> None:
        if op not in self.ops or self.rate <= 0.0:
            return
        key = (op, fingerprint)
        with self._lock:
            self.calls += 1
            seen = self._consecutive.get(key, 0)
            if seen < self.fail_times and self._rng.random() < self.rate:
                self._consecutive[key] = seen + 1
                self.injected += 1
                i = self.injected
            else:
                self._consecutive[key] = 0      # success resets the budget
                return
        raise InjectedFault(f"injected transient fault #{i} on "
                            f"{op}({fingerprint})")

    def get_chunk(self, start: int, size: int) -> np.ndarray:
        self._maybe_fail("get_chunk", (int(start), int(size)))
        return self.inner.get_chunk(start, size)

    def sample(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx)
        fingerprint = (int(idx.shape[0]),
                       int(idx[0]) if idx.shape[0] else -1,
                       int(idx[-1]) if idx.shape[0] else -1)
        self._maybe_fail("sample", fingerprint)
        return self.inner.sample(idx)


class PipelineFaults:
    """Shard-pipeline fault hooks (installed via `StreamedEngine.faults` or
    `ShardPipeline(..., faults=...)`).

    * corrupt_rate — before a seeded fraction of shard fetches, flip a byte
      in the shard's scratch slab WITHOUT updating its checksum. The next
      read detects the mismatch and falls back to a source refetch (healing
      the slab), so labels stay bit-identical while the corruption counters
      move — the chaos test for the checksum + tier-fallback contract.
    * kill_reader_at — raise `ReaderKilled` inside the prefetch producer at
      the k-th produced bundle (0-based, -1 = never). Non-transient: it
      exercises the consumer's inline-fallback path, which must finish the
      routed list in order and keep labels bit-identical.
    """

    def __init__(self, corrupt_rate: float = 0.0, kill_reader_at: int = -1,
                 seed: int = 0):
        self.corrupt_rate = float(corrupt_rate)
        self.kill_reader_at = int(kill_reader_at)
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._produced = 0
        self.corrupted = 0
        self.reader_kills = 0

    def on_fetch(self, pipeline, s: int) -> None:
        """Called by fetch_bundle before the tiered read of shard `s`."""
        if self.corrupt_rate <= 0.0:
            return
        scratch = getattr(pipeline.store, "scratch", None)
        if scratch is None:
            return
        with self._lock:
            hit = self._rng.random() < self.corrupt_rate
            if hit:
                self.corrupted += 1
        if hit:
            scratch.corrupt(s)

    def on_produce(self) -> None:
        """Called by the prefetch producer once per bundle it produces."""
        with self._lock:
            pos = self._produced
            self._produced += 1
            if pos == self.kill_reader_at:
                self.reader_kills += 1
                raise ReaderKilled(
                    f"injected reader death at bundle {pos}")
