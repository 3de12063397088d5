"""DataSource: the narrow row-access interface `engine.fit` ingests from
and `Clustering.predict` labels (a numpy copy of the JAX package's
`core/source.py`).

    n                       number of rows
    dim                     row dimensionality
    get_chunk(start, size)  contiguous block [start, start+size) as f32
    sample(idx)             arbitrary row gather (seed rows, shard builds)

Everything a source returns is host numpy float32; the engines decide what
(and how much) goes to the device. Four implementations:

  * InMemorySource  wraps an ndarray (`as_source` wraps raw arrays);
  * MemmapSource    an .npy file opened with numpy memmap: only the touched
                    rows are read, so host memory is O(chunk) whatever the
                    file's size;
  * ChunkedSource   any indexable sequence of row blocks, concatenated
                    logically through prefix sums;
  * CountingSource  a transparent wrapper counting the rows served.

`make_source("memmap:path.npy")` parses the CLI spec strings of
`repro_torch.launch.run_palid --source`.
"""

from __future__ import annotations

import threading
from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class DataSource(Protocol):
    """Narrow row-access interface the engines ingest from. Reads must be
    thread-safe: the streamed engine's shard reader and seed prefetch call
    `sample` concurrently with the fit loop (`core.pipeline`)."""

    @property
    def n(self) -> int: ...

    @property
    def dim(self) -> int: ...

    def get_chunk(self, start: int, size: int) -> np.ndarray: ...

    def sample(self, idx: np.ndarray) -> np.ndarray: ...


class _SourceBase:
    def get_chunk(self, start: int, size: int) -> np.ndarray:
        raise NotImplementedError

    def sample(self, idx: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def iter_chunks(self, chunk_size: int):
        """Yield (start, block) pairs covering [0, n) in order."""
        return iter_source_chunks(self, chunk_size)

    def as_array(self) -> np.ndarray:
        """Every row on the host, O(n d): the device-resident engines
        ingest any source through this; the streamed engine never calls
        it."""
        return self.get_chunk(0, self.n)


class InMemorySource(_SourceBase):
    """A resident ndarray behind the DataSource interface."""

    def __init__(self, points: np.ndarray):
        pts = np.asarray(points, np.float32)
        if pts.ndim != 2:
            raise ValueError(f"expected (n, d) points, got {pts.shape}")
        self._pts = pts

    @property
    def n(self) -> int:
        return self._pts.shape[0]

    @property
    def dim(self) -> int:
        return self._pts.shape[1]

    def get_chunk(self, start: int, size: int) -> np.ndarray:
        return self._pts[start:start + size]

    def sample(self, idx: np.ndarray) -> np.ndarray:
        return self._pts[np.asarray(idx, np.int64)]


class MemmapSource(_SourceBase):
    """An on-disk .npy file read through numpy memmap: only the requested
    rows are paged in, so host memory stays O(chunk) whatever the file's
    size. Non-f32 files are converted per request."""

    def __init__(self, path):
        self.path = str(path)
        self._mm = np.load(self.path, mmap_mode="r")
        if self._mm.ndim != 2:
            raise ValueError("expected a 2-d .npy of shape (n, d), got "
                             f"{self._mm.shape}")

    @property
    def n(self) -> int:
        return self._mm.shape[0]

    @property
    def dim(self) -> int:
        return self._mm.shape[1]

    def get_chunk(self, start: int, size: int) -> np.ndarray:
        # a writable copy: torch does not take read-only buffers
        return np.array(self._mm[start:start + size], np.float32)

    def sample(self, idx: np.ndarray) -> np.ndarray:
        return np.asarray(self._mm[np.asarray(idx, np.int64)], np.float32)


class ChunkedSource(_SourceBase):
    """Any indexable sequence of (m_i, d) row blocks, concatenated
    logically. Blocks are addressed through prefix sums; `get_chunk` and
    `sample` touch only the blocks a request spans."""

    def __init__(self, blocks: Sequence[np.ndarray]):
        if len(blocks) == 0:
            raise ValueError("ChunkedSource needs at least one block")
        self._blocks = blocks
        sizes = [int(np.asarray(b).shape[0]) for b in blocks]
        self._starts = np.concatenate([[0], np.cumsum(sizes)])
        self._dim = int(np.asarray(blocks[0]).shape[1])

    @property
    def n(self) -> int:
        return int(self._starts[-1])

    @property
    def dim(self) -> int:
        return self._dim

    def get_chunk(self, start: int, size: int) -> np.ndarray:
        stop = min(start + size, self.n)
        b0 = int(np.searchsorted(self._starts, start, side="right")) - 1
        out = []
        pos = start
        while pos < stop:
            blk = np.asarray(self._blocks[b0], np.float32)
            lo = pos - int(self._starts[b0])
            take = min(stop - pos, blk.shape[0] - lo)
            out.append(blk[lo:lo + take])
            pos += take
            b0 += 1
        return np.concatenate(out, axis=0) if len(out) != 1 else out[0]

    def sample(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx, np.int64)
        blk_of = np.searchsorted(self._starts, idx, side="right") - 1
        out = np.empty((idx.shape[0], self._dim), np.float32)
        for b in np.unique(blk_of):
            m = blk_of == b
            blk = np.asarray(self._blocks[int(b)], np.float32)
            out[m] = blk[idx[m] - int(self._starts[int(b)])]
        return out


class CountingSource(_SourceBase):
    """Transparent wrapper counting the rows served per entry point (the
    shard pipeline's tests read it: with scratch and the LRU on, the
    steady state reads no shard from the source). Bytes pass through
    untouched; the counters take a lock, since the streamed engine reads
    sources from several threads."""

    def __init__(self, inner: DataSource):
        self.inner = inner
        self._lock = threading.Lock()
        self.chunk_calls = 0
        self.chunk_rows = 0
        self.sample_calls = 0
        self.sample_rows = 0

    @property
    def n(self) -> int:
        return self.inner.n

    @property
    def dim(self) -> int:
        return self.inner.dim

    def get_chunk(self, start: int, size: int) -> np.ndarray:
        out = self.inner.get_chunk(start, size)
        with self._lock:
            self.chunk_calls += 1
            self.chunk_rows += int(out.shape[0])
        return out

    def sample(self, idx: np.ndarray) -> np.ndarray:
        with self._lock:
            self.sample_calls += 1
            self.sample_rows += int(np.asarray(idx).shape[0])
        return self.inner.sample(idx)

    def reset(self) -> None:
        with self._lock:
            self.chunk_calls = self.chunk_rows = 0
            self.sample_calls = self.sample_rows = 0


def iter_source_chunks(source: DataSource, chunk_size: int):
    """Yield (start, block) pairs covering [0, n) in order."""
    for start in range(0, source.n, chunk_size):
        yield start, source.get_chunk(start,
                                      min(chunk_size, source.n - start))


def is_data_source(obj) -> bool:
    """True for DataSource-shaped objects (duck-typed)."""
    return hasattr(obj, "get_chunk") and hasattr(obj, "sample")


def as_source(data) -> DataSource:
    """DataSource pass-through; anything array-like (numpy, lists, CPU
    tensors) is wrapped as an InMemorySource."""
    if is_data_source(data):
        return data
    return InMemorySource(np.asarray(data, np.float32))


def make_source(spec: str) -> DataSource:
    """Parse a CLI source spec: "memmap:path.npy" (out of core) or
    "npy:path.npy" (loaded whole into host memory). A bare path is read
    through memmap."""
    kind, sep, path = spec.partition(":")
    if not sep:
        kind, path = "memmap", spec
    if kind == "memmap":
        return MemmapSource(path)
    if kind == "npy":
        return InMemorySource(np.load(path))
    raise ValueError(f"unknown source spec {spec!r}; expected "
                     "'memmap:<file.npy>' or 'npy:<file.npy>'")


def strided_sample_indices(n: int, sample: int) -> np.ndarray:
    """Evenly-strided row indices covering [0, n): the subsample of k
    estimation. Fractional striding (i*n // m) spans [0, n) for every n."""
    m = min(int(sample), int(n))
    return (np.arange(m, dtype=np.int64) * n) // m
