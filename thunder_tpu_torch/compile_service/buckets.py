"""The prompt-length bucket ladder of thunder_tpu/compile_service/buckets.py.

Rungs double from ``min_len`` and cap at ``max_len`` (every rung a multiple
of ``page_size``, so serving prefill page write-out stays aligned);
``bucket_for(n)`` is the rounding rule, and per-rung traffic (hits, MRU
order) is tracked here; ``subladder(max_len)`` is the capped child that
rounds chunked prefill's final chunk. The training-side padding waits for
the slice that uses it.
"""
from __future__ import annotations

import threading


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
