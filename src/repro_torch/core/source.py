"""DataSource: the narrow row-access interface `engine.fit` ingests from
and `Clustering.predict` labels (a numpy copy of the JAX package's
`core/source.py`: the in-memory and memmap sources).

    n                       number of rows
    dim                     row dimensionality
    get_chunk(start, size)  contiguous block [start, start+size) as f32
    sample(idx)             arbitrary row gather (seed rows, supports)

Everything a source returns is host numpy float32; the engine decides what
goes to the device.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class DataSource(Protocol):
    @property
    def n(self) -> int: ...

    @property
    def dim(self) -> int: ...

    def get_chunk(self, start: int, size: int) -> np.ndarray: ...

    def sample(self, idx: np.ndarray) -> np.ndarray: ...


class InMemorySource:
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


class MemmapSource:
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


def strided_sample_indices(n: int, sample: int) -> np.ndarray:
    """Evenly-strided row indices covering [0, n): the subsample of k
    estimation. Fractional striding (i*n // m) spans [0, n) for every n."""
    m = min(int(sample), int(n))
    return (np.arange(m, dtype=np.int64) * n) // m
