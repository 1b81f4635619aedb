"""The prompt-length bucket ladder of thunder_tpu/compile_service/buckets.py.

Rungs double from ``min_len`` and cap at ``max_len`` (every rung a multiple
of ``page_size``, so serving prefill page write-out stays aligned);
``bucket_for(n)`` is the rounding rule, and per-rung traffic (hits, MRU
order) is tracked here; ``subladder(max_len)`` is the capped child that
rounds chunked prefill's final chunk. ``pad_to_bucket`` is the training
side: ``TrainStep(buckets=...)`` pads each batch to its rung, so every
length in a rung shares one program and one CUDA graph.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch


class BucketLadder:
    """Power-of-two, page-aligned shape buckets shared system-wide.

        ladder = BucketLadder(min_len=16, max_len=2048, page_size=16)
        ladder.bucket_for(100)   # -> 128
        ladder.bucket_id(100)    # -> rung index (stable artifact-key field)
    """

    def __init__(self, min_len: int, max_len: int, *, page_size: int = 1):
        if page_size < 1:
            raise ValueError(f"page_size={page_size} must be >= 1")
        if min_len < 1 or max_len < min_len:
            raise ValueError(
                f"need 1 <= min_len <= max_len (got min_len={min_len}, "
                f"max_len={max_len})")
        if min_len % page_size:
            # rungs double from min_len, so page alignment of every rung
            # reduces to alignment of the first — reject the misconfiguration
            # here instead of surfacing it as an opaque reshape error inside
            # a prefill trace (the old min_bucket check, now shared)
            raise ValueError(f"min_bucket={min_len} must be a multiple of "
                             f"page_size={page_size}")
        if max_len % page_size:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_size={page_size}")
        self.min_len = min_len
        self.max_len = max_len
        self.page_size = page_size
        rungs = []
        b = min_len
        while b < max_len:
            rungs.append(b)
            b *= 2
        rungs.append(max_len)  # cap rung (not necessarily a power of two)
        self._rungs = tuple(rungs)
        self._lock = threading.Lock()
        self._hits: dict[int, int] = {}
        self._mru: list[int] = []  # bucket sizes, most recently served first

    # -- the rounding rule ----------------------------------------------------
    @property
    def rungs(self) -> tuple:
        return self._rungs

    def bucket_for(self, n: int) -> int:
        """Smallest rung >= n (capped at max_len — the old serving
        ``bucket_len`` semantics, now the system-wide rule)."""
        for b in self._rungs:
            if b >= n:
                return b
        return self.max_len

    def bucket_id(self, n: int) -> int:
        """Stable rung index for artifact keys: two lengths in one bucket
        share the id, so they share the stored artifact."""
        return self._rungs.index(self.bucket_for(n))

    def subladder(self, max_len: int) -> "BucketLadder":
        """A ladder with the same min rung and page alignment but a lower
        cap — the serving engine's chunked prefill rounds its FINAL chunk
        with ``subladder(chunk_tokens)`` so chunk programs specialize over
        strictly fewer rungs than whole-prompt prefill. Traffic stats are
        not shared: the child tracks its own hits/MRU."""
        if not (self.min_len <= max_len <= self.max_len):
            raise ValueError(
                f"subladder max_len={max_len} must lie within "
                f"[{self.min_len}, {self.max_len}]")
        return BucketLadder(self.min_len, max_len, page_size=self.page_size)

    def __contains__(self, n: int) -> bool:
        return n in self._rungs

    # -- traffic (the collapsed ShapeKeyedMRU bookkeeping) --------------------
    def touch(self, n: int) -> int:
        """Record one serving/training use of length ``n``; returns the
        bucket. The bucket moves to the front of the MRU order (the probe
        discipline the scheduler used to keep in its own _BucketEntry MRU)."""
        b = self.bucket_for(n)
        with self._lock:
            self._hits[b] = self._hits.get(b, 0) + 1
            if self._mru and self._mru[0] == b:
                return b
            self._mru[:] = [b] + [x for x in self._mru if x != b]
        return b

    def mru(self) -> list[int]:
        """Bucket sizes, most recently served first."""
        with self._lock:
            return list(self._mru)

    def hits(self) -> dict[int, int]:
        with self._lock:
            return dict(self._hits)

    # -- key plumbing ---------------------------------------------------------
    def key_fields(self) -> str:
        """Deterministic identity for artifact keys: a program lowered for
        one ladder must not serve a different ladder's shapes."""
        return f"ladder(min={self.min_len},max={self.max_len},page={self.page_size})"

    def __repr__(self) -> str:
        return f"BucketLadder({self.key_fields()}, rungs={self._rungs})"


def pad_to_bucket(args: tuple, kwargs: dict, ladder: BucketLadder, *,
                  axis: int = 1, pad_values: Optional[dict] = None) -> tuple:
    """Pad every array-like positional/keyword arg along ``axis`` up to the
    ladder rung for its current length (thunder_tpu's pad_to_bucket).
    ``pad_values`` maps positional index (or kwarg name) -> fill value
    (default 0; causal-LM targets use -100 so ``cross_entropy`` masks the
    padding). Non-arrays and arrays too small for ``axis`` pass through
    untouched; lengths already on a rung are returned as they are. NumPy
    arrays stay NumPy, tensors are padded on their own device."""
    pad_values = pad_values or {}

    def one(label: Any, v):
        shape = getattr(v, "shape", None)
        if shape is None or len(shape) <= axis:
            return v
        n = int(shape[axis])
        if n > ladder.max_len:
            raise ValueError(
                f"arg {label!r} has length {n} along axis {axis}, beyond "
                f"the ladder's max_len={ladder.max_len}; raise max_len or "
                f"shorten the batch")
        b = ladder.bucket_for(n)
        if b == n:
            return v
        fill = pad_values.get(label, 0)
        if isinstance(v, np.ndarray):
            widths = [(0, 0)] * len(shape)
            widths[axis] = (0, b - n)
            return np.pad(v, widths, constant_values=fill)
        pad_shape = list(shape)
        pad_shape[axis] = b - n
        return torch.cat([v, torch.full(pad_shape, fill, dtype=v.dtype, device=v.device)], dim=axis)

    new_args = tuple(one(i, a) for i, a in enumerate(args))
    new_kwargs = {k: one(k, v) for k, v in kwargs.items()}
    return new_args, new_kwargs
