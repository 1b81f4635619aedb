"""Data pipeline: native (C++) mmap token loader with threaded prefetch.

thunder_tpu/data/__init__.py for the port. Host-side batch assembly is a
small C++ library (native/loader.cpp, the same source as thunder_tpu's)
that ``g++`` builds at first use into ``build/thunder_tpu_torch/`` beside
the kernels, named by the source's hash; nothing is written into the source
tree. Batches are (B, T+1) int32: inputs = batch[:, :-1], targets =
batch[:, 1:]. For one file and seed the native loader and the numpy
fallback serve thunder_tpu's batches, each its own stream (the native
one's batches are keyed by (seed, batch index), the fallback's drawn from
one ``RandomState(seed)``).

The fallback serves only where it is asked for (``native=False``) or where
the machine has no ``g++``, and then a warning says so. A ``g++`` that
fails raises with the compiler's output: a loader never falls back without
saying so."""
from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

from .prefetch import (DevicePrefetchIterator, _drain_and_join,  # noqa: F401
                       _stop_aware_put, prefetch_to_device)

_CPP_PATH = Path(__file__).resolve().parent / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "thunder_tpu_torch"
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_build_lock = threading.Lock()


def _build_native() -> Optional[str]:
    """The loader's shared library, compiled on first use (a temporary
    name renamed into place, so a concurrent process never opens a
    half-written file). None when the machine has no ``g++``; a failed
    compile raises."""
    with _build_lock:
        h = hashlib.sha256(" ".join(_CXX_FLAGS).encode() + _CPP_PATH.read_bytes()).hexdigest()[:16]
        so = BUILD_DIR / f"libttloader-{h}.so"
        if so.exists():
            return str(so)
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            done = subprocess.run([gxx, *_CXX_FLAGS, str(_CPP_PATH), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=120)
            if done.returncode:
                raise RuntimeError(f"g++ failed to build the native token loader:\n{done.stderr}")
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)
        return str(so)


def _fallback_worker(tokens: np.ndarray, rng, batch_size: int, span: int,
                     q: "queue.Queue", stop: threading.Event) -> None:
    """Numpy-fallback batch assembler: same threaded overlap the native
    loader has, so hosts without g++ still hide batch assembly behind the
    device step. One worker consumes the RandomState sequentially, so the
    batch stream is identical to a synchronous path. Closes over its
    state, NOT the TokenLoader — a bound method would keep the loader alive
    and its close()/__del__ would never run."""
    n = tokens.shape[0]
    try:
        while not stop.is_set():
            offs = rng.randint(0, n - span + 1, batch_size)
            buf = np.empty((batch_size, span), np.int32)
            for i, o in enumerate(offs):
                buf[i] = tokens[o: o + span].astype(np.int32)
            if not _stop_aware_put(q, stop, buf):
                return
    except Exception as e:  # surfaces in the consumer's next next_batch()
        _stop_aware_put(q, stop, e)


_lib = None
_lib_missing = False


def _native_lib():
    """The loaded library, or None on a machine without g++ (warned once)."""
    global _lib, _lib_missing
    if _lib is not None or _lib_missing:
        return _lib
    so = _build_native()
    if so is None:
        _lib_missing = True
        warnings.warn("no g++ on this machine: TokenLoader serves batches from the numpy fallback",
                      stacklevel=3)
        return None
    lib = ctypes.CDLL(so)
    lib.ttl_create.restype = ctypes.c_void_p
    lib.ttl_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.ttl_num_tokens.restype = ctypes.c_int64
    lib.ttl_num_tokens.argtypes = [ctypes.c_void_p]
    lib.ttl_next.restype = ctypes.c_int
    lib.ttl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.ttl_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class TokenLoader:
    """Random-offset (B, T+1) batch sampler over a binary token file.

    next_batch() -> (inputs (B,T) int32, targets (B,T) int32) numpy arrays.
    Uses the native prefetching loader unless ``native=False`` (or the
    machine has no g++); ``is_native`` says which serves."""

    def __init__(self, path: str, batch_size: int, seq_len: int, *, token_bytes: int = 2,
                 seed: int = 0, n_threads: int = 2, queue_depth: int = 4, native: bool = True):
        self.path = path
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.token_bytes = token_bytes
        self.span = seq_len + 1
        self._seed = seed
        self._n_threads = n_threads
        self._queue_depth = queue_depth
        self._served = 0  # batches handed to the consumer (checkpoint cursor)
        # validate the corpus up front, on the caller's thread, for BOTH
        # serving paths: a corpus shorter than span would otherwise blow up
        # inside the native/fallback worker where the error is lost
        try:
            n_file_tokens = os.path.getsize(path) // token_bytes
        except OSError as e:
            raise ValueError(f"cannot read token file {path!r}: {e}") from None
        if n_file_tokens < self.span:
            raise ValueError(
                f"token file {path!r} has {n_file_tokens} tokens, "
                f"need at least seq_len+1={self.span}"
            )
        self._handle = None
        self._lib = _native_lib() if native else None
        if self._lib is not None:
            self._handle = self._open(seed)
        self._fb_queue = None
        self._fb_stop = None
        self._fb_thread = None
        if self._lib is None:
            dtype = {1: np.uint8, 2: np.uint16, 4: np.int32}[token_bytes]
            self._tokens = np.memmap(path, dtype=dtype, mode="r")
            self._rng = np.random.RandomState(seed)
            self._start_fallback_worker()
        else:
            # native output buffer; the fallback path receives
            # worker-allocated buffers through _fb_queue instead
            self._buf = np.empty((batch_size, self.span), np.int32)

    def _open(self, seed: int):
        handle = self._lib.ttl_create(self.path.encode(), self.token_bytes, self.batch_size, self.span,
                                      seed, self._n_threads, self._queue_depth)
        if not handle:
            raise RuntimeError(f"the native token loader could not open or map {self.path!r}")
        return handle

    def _start_fallback_worker(self) -> None:
        self._fb_queue = queue.Queue(maxsize=max(1, self._queue_depth))
        self._fb_stop = threading.Event()
        self._fb_thread = threading.Thread(
            target=_fallback_worker,
            args=(self._tokens, self._rng, self.batch_size, self.span,
                  self._fb_queue, self._fb_stop),
            name="tt-token-fallback", daemon=True)
        self._fb_thread.start()

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    @property
    def num_tokens(self) -> int:
        if self._handle is not None:
            return int(self._lib.ttl_num_tokens(self._handle))
        return int(self._tokens.shape[0])

    def next_batch(self):
        if self._handle is not None:
            rc = self._lib.ttl_next(self._handle, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if rc != 0:
                raise RuntimeError("native loader failed")
            batch = self._buf
        else:
            # offsets are drawn by the prefetch worker with the rng
            # consumption order of a synchronous path (max valid start
            # offset n - span inclusive, matching the native path's
            # uniform_int_distribution(0, n - span))
            while True:
                try:
                    batch = self._fb_queue.get(timeout=0.1)
                    break
                except queue.Empty:
                    if self._fb_thread is None or not self._fb_thread.is_alive():
                        raise RuntimeError("fallback loader worker exited") from None
            if isinstance(batch, Exception):
                raise batch
        self._served += 1
        return batch[:, :-1].copy(), batch[:, 1:].copy()

    # -- checkpointable cursor (robustness.CheckpointManager) ---------------

    def state_dict(self) -> dict:
        """JSON-safe batch-stream cursor. Both serving paths are
        deterministic functions of (seed, batch index), so (seed, batches
        served) pins the exact continuation point of the stream."""
        return {"seed": int(self._seed), "served": int(self._served),
                "batch_size": int(self.batch_size), "span": int(self.span),
                "token_bytes": int(self.token_bytes),
                "native": bool(self.is_native)}

    def load_state_dict(self, sd: dict) -> None:
        """Re-position the stream so the next ``next_batch()`` returns
        exactly the batch a checkpointed run would have drawn next.

        Fallback path: a fresh RandomState(seed) replays ``served`` offset
        draws. Native path: the stream is recreated at ``seed`` and
        ``served`` batches are assembled and discarded (batches are keyed by
        (seed, index)); resuming deep into a native stream pays that
        assembly cost once."""
        if (int(sd["batch_size"]) != self.batch_size
                or int(sd["span"]) != self.span
                or int(sd.get("token_bytes", self.token_bytes)) != self.token_bytes):
            raise ValueError(
                f"loader state mismatch: checkpoint batch_size/span/token_bytes "
                f"{sd['batch_size']}/{sd['span']}/{sd.get('token_bytes')} vs "
                f"loader {self.batch_size}/{self.span}/{self.token_bytes} — "
                f"resuming onto a differently-tokenized corpus would silently "
                f"serve an unrelated batch stream")
        if "native" in sd and bool(sd["native"]) != self.is_native:
            # the two serving paths draw from DIFFERENT rng streams (native:
            # per-batch mt19937_64 keyed by (seed, index); fallback: one
            # sequential numpy RandomState) — a cursor from one cannot
            # reproduce the other's continuation
            raise ValueError(
                f"loader state mismatch: checkpoint cursor is from the "
                f"{'native' if sd['native'] else 'numpy-fallback'} serving "
                f"path but this loader is "
                f"{'native' if self.is_native else 'numpy-fallback'}; the "
                f"paths' batch streams differ, so resuming across them "
                f"would silently diverge from the checkpointed run")
        seed, served = int(sd["seed"]), int(sd["served"])
        if self._handle is not None:
            self._lib.ttl_destroy(self._handle)
            self._handle = self._open(seed)
            scratch = np.empty((self.batch_size, self.span), np.int32)
            for _ in range(served):
                rc = self._lib.ttl_next(
                    self._handle, scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
                if rc != 0:
                    raise RuntimeError("native loader failed during resume replay")
        else:
            _drain_and_join(self._fb_queue, self._fb_stop, self._fb_thread)
            self._rng = np.random.RandomState(seed)
            n = self._tokens.shape[0]
            for _ in range(served):
                self._rng.randint(0, n - self.span + 1, self.batch_size)
            self._start_fallback_worker()
        self._seed = seed
        self._served = served

    def batches(self):
        """Endless (inputs, targets) iterator — feed to prefetch_to_device."""
        while True:
            yield self.next_batch()

    def prefetched(self, size: int = 2, device=None) -> DevicePrefetchIterator:
        """Device-resident batch stream (the card by default): a background
        thread copies upcoming batches so H2D transfer overlaps the device
        step. Its cursor counts the batches the consumer took."""
        return prefetch_to_device(self.batches(), size=size, device=device, cursor=self)

    def close(self):
        if self._handle is not None:
            self._lib.ttl_destroy(self._handle)
            self._handle = None
        if self._fb_stop is not None:
            _drain_and_join(self._fb_queue, self._fb_stop, self._fb_thread)
            self._fb_stop = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_token_file(path: str, tokens: np.ndarray, token_bytes: int = 2) -> None:
    dtype = {1: np.uint8, 2: np.uint16, 4: np.int32}[token_bytes]
    np.asarray(tokens, dtype=dtype).tofile(path)
