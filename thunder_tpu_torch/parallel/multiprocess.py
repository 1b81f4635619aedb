"""Multi-process bring-up over torch.distributed, and a local CPU cluster.

thunder_tpu/parallel/multiprocess.py for the port. thunder_tpu joins a
multi-controller jax cluster; here every rank is one process holding one
card, joined by ``torch.distributed``:

* ``initialize()`` calls ``init_process_group``: NCCL on ``cuda:<local
  rank>`` unless the caller asks for the CPU, which takes Gloo. The
  address, world size and rank come from the arguments or from the
  environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``, as ``torchrun`` sets them). A missing or broken NCCL
  raises; it never falls back to Gloo.
* ``barrier()`` and ``destroy()``; ``process_index()`` and
  ``process_count()``, thunder_tpu's ``jax.process_index()`` and
  ``jax.process_count()``: this rank and the world size of the joined
  group, 0 and 1 outside one.
* ``LocalCluster`` spawns N CPU worker processes on this machine, each one
  Gloo rank with a timeout, and keeps them for many calls: ``call(source,
  fn, *args)`` runs ``fn`` of ``source`` on every rank and returns each
  rank's result. The CPU tests drive the distributed paths through it.

The key-value agreement (``kv_agree``) and the fault paths of thunder_tpu's
module are not ported yet (ROADMAP A3c)."""
from __future__ import annotations

import datetime
import os
import pickle
import selectors
import socket
import struct
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Optional

DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, cpu: bool = False,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group (a no-op when already joined). Arguments fall
    back to the environment; with neither an address nor ``WORLD_SIZE``
    this is a single-process run and returns False. Returns whether the
    group spans more than one rank.

    ``cpu=True`` takes Gloo; otherwise NCCL on ``cuda:<LOCAL_RANK>`` (0 by
    default), which raises when the card or NCCL is missing. ``timeout_s``
    bounds every collective, so a rank that hangs fails instead."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    rank = _env_int("RANK") if rank is None else rank
    if init_method is None and world_size is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError("multiprocess.initialize needs an address (or MASTER_ADDR/MASTER_PORT), "
                         "a world size (WORLD_SIZE) and a rank (RANK)")
    if cpu:
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("multiprocess.initialize: no CUDA device for the NCCL backend "
                               "(pass cpu=True for Gloo)")
        if not dist.is_nccl_available():
            raise RuntimeError("multiprocess.initialize: this PyTorch has no NCCL")
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
        backend = "nccl"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return world_size > 1


def barrier() -> None:
    """Every rank waits for the others; a no-op outside a process group."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def process_index() -> int:
    """This process's rank in the joined group; 0 outside one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The joined group's world size; 1 outside one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def destroy() -> None:
    """Leave the process group (every group of every mesh with it)."""
    import torch.distributed as dist

    from . import mesh

    mesh.set_active_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# local CPU cluster
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_frame(f, obj) -> None:
    data = pickle.dumps(obj)
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def _read_exact(f, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise EOFError("the cluster closed the pipe")
        buf += chunk
    return buf


def _worker_main() -> None:
    """A worker's loop: join the Gloo group, then run each (source, fn,
    args, kwargs) frame from stdin and answer with ("ok", result) or
    ("err", traceback) on the original stdout; prints go to stderr."""
    import torch

    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    torch.set_num_threads(1)
    initialize(cpu=True, timeout_s=float(os.environ["TT_CLUSTER_TIMEOUT_S"]))
    namespaces: dict = {}
    stdin = sys.stdin.buffer
    while True:
        try:
            (n,) = struct.unpack("<Q", _read_exact(stdin, 8))
        except EOFError:
            break
        source, fn, args, kwargs = pickle.loads(_read_exact(stdin, n))
        try:
            ns = namespaces.get(source)
            if ns is None:
                ns = namespaces[source] = {"__name__": "_tt_cluster_worker"}
                exec(compile(source, "<cluster source>", "exec"), ns)
            _write_frame(out, ("ok", ns[fn](*args, **kwargs)))
        except BaseException:  # noqa: BLE001 — every failure goes back to the cluster
            _write_frame(out, ("err", traceback.format_exc()))


class ClusterError(RuntimeError):
    pass


class LocalCluster:
    """N CPU worker processes on this machine, one Gloo rank each, kept
    alive across calls (thunder_tpu/parallel/multiprocess.py:LocalCluster,
    whose workers run one source each).

        with LocalCluster(4) as cluster:
            results = cluster.call(SOURCE, "fn", arg)  # one result per rank

    Each worker gets MASTER_ADDR/MASTER_PORT (a fresh free port), RANK,
    WORLD_SIZE, the repo on PYTHONPATH and one intra-op thread. ``call``
    compiles ``source`` once per worker, runs ``fn(*args, **kwargs)`` on
    every rank and returns the results in rank order. A rank that raises,
    or a call that outlasts ``timeout_s`` (which also bounds every Gloo
    collective inside the workers), raises ClusterError with each rank's
    traceback and stderr; the workers are then restarted, so the next call
    starts clean."""

    def __init__(self, nprocs: int = 2, *, timeout_s: float = 120.0,
                 repo_root: Optional[str] = None):
        if nprocs < 1:
            raise ValueError("nprocs must be >= 1")
        self.nprocs = nprocs
        self.timeout_s = timeout_s
        self.repo_root = repo_root or os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        self._procs: list = []
        self._logs: list = []

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    def _env(self, rank: int, port: int) -> dict:
        env = dict(os.environ)
        env.update({
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
            "LOCAL_RANK": str(rank), "WORLD_SIZE": str(self.nprocs),
            "TT_CLUSTER_TIMEOUT_S": str(self.timeout_s), "OMP_NUM_THREADS": "1",
            "PYTHONPATH": self.repo_root + os.pathsep + env.get("PYTHONPATH", ""),
        })
        return env

    def start(self) -> None:
        if self._procs:
            return
        port = free_port()
        for rank in range(self.nprocs):
            log = tempfile.TemporaryFile()
            self._logs.append(log)
            self._procs.append(subprocess.Popen(
                [sys.executable, "-m", "thunder_tpu_torch.parallel.multiprocess"],
                env=self._env(rank, port), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=log, cwd=self.repo_root))

    def close(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdin, p.stdout):
                if f is not None:
                    f.close()
        for log in self._logs:
            log.close()
        self._procs, self._logs = [], []

    def _stderr(self, rank: int) -> str:
        log = self._logs[rank]
        log.seek(0)
        return log.read().decode(errors="replace")[-4000:]

    def _fail(self, why: str, answers: dict) -> None:
        parts = [why]
        for rank in range(self.nprocs):
            kind, value = answers.get(rank, ("missing", None))
            parts.append(f"--- rank {rank}: {kind}")
            if kind == "err":
                parts.append(value)
            parts.append(self._stderr(rank))
        self.close()
        raise ClusterError("\n".join(parts))

    def call(self, source: str, fn: str, *args, **kwargs) -> list:
        self.start()
        frame = pickle.dumps((source, fn, args, kwargs))
        for p in self._procs:
            try:
                p.stdin.write(struct.pack("<Q", len(frame)) + frame)
                p.stdin.flush()
            except BrokenPipeError:
                self._fail("a worker is gone", {})
        deadline = time.monotonic() + self.timeout_s
        bufs = {rank: b"" for rank in range(self.nprocs)}
        answers: dict = {}
        sel = selectors.DefaultSelector()
        for rank, p in enumerate(self._procs):
            os.set_blocking(p.stdout.fileno(), False)
            sel.register(p.stdout, selectors.EVENT_READ, rank)
        try:
            while len(answers) < self.nprocs:
                left = deadline - time.monotonic()
                if left <= 0:
                    self._fail(f"timed out after {self.timeout_s} s", answers)
                for key, _ in sel.select(timeout=left):
                    rank = key.data
                    chunk = os.read(key.fileobj.fileno(), 1 << 20)
                    if not chunk:
                        sel.unregister(key.fileobj)
                        answers[rank] = ("err", "the worker exited")
                        continue
                    bufs[rank] += chunk
                    buf = bufs[rank]
                    if len(buf) >= 8:
                        (n,) = struct.unpack("<Q", buf[:8])
                        if len(buf) >= 8 + n:
                            answers[rank] = pickle.loads(buf[8:8 + n])
                            sel.unregister(key.fileobj)
                            if answers[rank][0] != "ok":  # the others may wait on it forever
                                self._fail(f"{fn} failed", answers)
        finally:
            sel.close()
        if any(kind != "ok" for kind, _ in answers.values()):
            self._fail(f"{fn} failed", answers)
        return [answers[rank][1] for rank in range(self.nprocs)]


if __name__ == "__main__":
    _worker_main()
