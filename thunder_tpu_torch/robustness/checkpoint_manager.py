"""CheckpointManager: periodic + on-signal full-training-state checkpoints.

thunder_tpu/robustness/checkpoint_manager.py for the port, with the same
directory layout, ``meta.json``, ``manifest.json`` and checksums, so
thunder_tpu's ``tools/ckpt_inspect.py`` validates a directory the port wrote
and each package restores the other's (parallel/checkpoint.py: one flat npz
in thunder_tpu's flatten order). This layer makes the save/load primitives
a *recovery policy* for the training loop:

* the FULL resumable state is captured — params, buffers (which carry fp8
  amax-history scaling state and BatchNorm running stats), optimizer state
  (moments and the device step), the step counter, and the loader cursor
  (``TokenLoader`` or ``DevicePrefetchIterator.state_dict``) — not just a
  weights file;
* every checkpoint is written **atomically**: payload + ``meta.json`` +
  digest ``manifest.json`` land in a hidden tmp directory that is
  ``os.replace``d into place, so a kill mid-write can never leave a
  latest-looking half checkpoint;
* saves are **async by default**. The step loop pays one snapshot: a copy
  of every state tensor on its own device (on the card ~1 ms a GB, queued
  behind the step that produced it, ahead of the next step's in-place
  writes), and a writer thread copies the snapshot to the host on a side
  stream and does the IO. thunder_tpu snapshots to the host on the step
  loop (``np.asarray``) because its arrays are immutable; here the next
  replay of the step's CUDA graph overwrites parameters and moments in
  place, so the snapshot must be tensors of its own before the step loop
  goes on. It costs the state's size in device memory while a write is
  in flight;
* save failures are **non-fatal by default** (warn + ``checkpoint.save_failed``
  bus event + keep training) with ``strict=True`` raising instead;
* retention is keep-last-K;
* a ``PreemptionHandler`` flag checked in ``on_step`` turns SIGTERM into:
  drain the in-flight step, force a final blocking save, raise ``Preempted``.
  ``close()`` uninstalls the handler.

``restore`` writes every tensor **in place** (``copy_``) into the tensors
the step holds — parameters, buffers, moments, the device step — because a
captured CUDA graph reads and writes those addresses; rebinding ``p.data``
would leave the graph replaying stale memory. A restore before the first
step initializes the optimizer's state first, then copies into it.

Hot-path discipline: ``on_step`` at a non-interval step is two attribute
reads, an ``Event.is_set`` and an int modulo.

Distributed (sharded) checkpoints — per-host shards with a merged
manifest, the cross-host preemption watcher — are not ported yet (ROADMAP
A3c): ``distributed=True``, or a joined process group of more than one
rank, raises NotImplementedError.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import warnings
from typing import Optional

import torch

from ..observability import events as _obs
from ..observability import metrics as _obs_metrics
from ..parallel import checkpoint as dist_ckpt
from . import faults as _faults
from .preemption import Preempted, PreemptionHandler

STEP_PREFIX = "step_"
_STATE_SUBDIR = "state"
# a rename-aside/tmp leftover younger than this may belong to another live
# process sharing the directory, so _prune leaves it alone
_LEFTOVER_MIN_AGE_S = 600.0


class CheckpointError(RuntimeError):
    """A checkpoint save failed in strict mode (or a restore found nothing)."""


# -- directory helpers (the layout tools/ckpt_inspect.py reads) --------------

def step_dir_name(step: int) -> str:
    return f"{STEP_PREFIX}{step:08d}"


def list_steps(directory: str) -> list[tuple[int, str]]:
    """[(step, abspath)] of checkpoint step dirs, ascending by step."""
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if not name.startswith(STEP_PREFIX):
            continue
        try:
            step = int(name[len(STEP_PREFIX):])
        except ValueError:
            continue
        out.append((step, os.path.join(os.path.abspath(directory), name)))
    out.sort()
    return out


def _file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _manifest_files(stepdir: str) -> dict[str, dict]:
    files = {}
    for dirpath, dirnames, filenames in sorted(os.walk(stepdir)):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn == "manifest.json":
                continue
            p = os.path.join(dirpath, fn)
            rel = os.path.relpath(p, stepdir)
            files[rel] = {"sha256": _file_digest(p), "bytes": os.path.getsize(p)}
    return files


def validate_step(stepdir: str) -> tuple[bool, list[str]]:
    """Check a step dir's manifest integrity: every listed file present with
    a matching digest, no payload file missing from the manifest."""
    problems: list[str] = []
    mpath = os.path.join(stepdir, "manifest.json")
    if not os.path.isfile(mpath):
        return False, ["manifest.json missing"]
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return False, [f"manifest.json unreadable: {e}"]
    listed = manifest.get("files", {})
    actual = _manifest_files(stepdir)
    for rel, info in listed.items():
        if rel not in actual:
            problems.append(f"missing file: {rel}")
        elif actual[rel]["sha256"] != info.get("sha256"):
            problems.append(f"digest mismatch: {rel}")
    for rel in actual:
        if rel not in listed:
            problems.append(f"unlisted file: {rel}")
    return not problems, problems


def read_meta(stepdir: str) -> dict:
    with open(os.path.join(stepdir, "meta.json")) as f:
        return json.load(f)


def _refuse_distributed() -> None:
    raise NotImplementedError(
        "distributed (sharded) checkpoints are not ported yet (ROADMAP A3c): "
        "CheckpointManager saves and restores a single process's state")


class _Snapshot:
    """A save's state, held by the writer: tensors of its own (device copies
    made on the step loop's stream) and the event after the last copy, which
    the writer's side stream waits on before it copies them to the host."""

    __slots__ = ("state", "event", "note")

    def __init__(self, state: dict, event):
        self.state = state
        self.event = event
        self.note = dist_ckpt.treedef_note(state)

    def host_leaves(self) -> tuple[list, list]:
        """(host arrays, true dtype names) in flatten order."""
        leaves = dist_ckpt.flatten(self.state)
        cuda = [t for t in leaves if isinstance(t, torch.Tensor) and t.is_cuda]
        if not cuda:
            return [dist_ckpt.to_numpy(t) for t in leaves], [dist_ckpt.dtype_name(t) for t in leaves]
        side = torch.cuda.Stream(cuda[0].device)
        side.wait_event(self.event)
        with torch.cuda.stream(side):
            arrays = [dist_ckpt.to_numpy(t) for t in leaves]
        return arrays, [dist_ckpt.dtype_name(t) for t in leaves]


# -- the manager -------------------------------------------------------------

class CheckpointManager:
    """Attach to a ``TrainStep`` (and optionally a loader); periodic and
    preemption-forced saves then ride the step loop.

        mgr = CheckpointManager(dir, every_n_steps=500, keep=3, loader=loader)
        mgr.attach(step)                 # installs the SIGTERM handler too
        for x, y in loader.batches():    # mgr.on_step runs inside step(...)
            step(x, y)

    Resume in a fresh process::

        mgr = CheckpointManager(dir, loader=loader)
        meta = mgr.restore(step)         # params/opt/step-counter/loader back

    ``save_log`` holds a dict a save: its ``step``, ``reason``, ``stall_ms``
    (the time the step loop spent in ``save``) and, once written,
    ``write_s`` and ``bytes`` (the writer's); ``last_save`` is the newest,
    ``last_restore`` the newest restore's ``seconds``."""

    def __init__(self, directory: str, *, every_n_steps: int = 0, keep: int = 3,
                 async_save: bool = True, strict: bool = False,
                 loader=None, preemption: bool = True, signals=None,
                 distributed: Optional[bool] = None):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        if distributed:
            _refuse_distributed()
        self.directory = os.path.abspath(directory)
        self.every_n_steps = int(every_n_steps)
        self.keep = keep
        self.async_save = async_save
        self.strict = strict
        self.loader = loader
        self.distributed = distributed
        self._preempt: Optional[PreemptionHandler] = (
            PreemptionHandler(signals=signals) if (preemption and signals is not None)
            else PreemptionHandler() if preemption else None)
        self._writer: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        # observable outcomes (tests / ckpt_inspect / chip_smoke)
        self.saves = 0
        self.failed_saves = 0
        self.save_log: list[dict] = []
        self.last_restore: dict = {}
        os.makedirs(self.directory, exist_ok=True)

    def _check_single_process(self) -> None:
        """Auto-detection: a joined group of more than one rank would need
        the sharded layout."""
        if self.distributed is None:
            from ..parallel import multiprocess as _mp

            if _mp.process_count() > 1:
                _refuse_distributed()

    # -- wiring -------------------------------------------------------------

    def attach(self, train_step) -> "CheckpointManager":
        self._check_single_process()
        train_step._ckpt_manager = self
        if self._preempt is not None:
            self._preempt.install()
        return self

    @property
    def last_save(self) -> dict:
        return self.save_log[-1] if self.save_log else {}

    @property
    def preempted(self) -> bool:
        return self._preempt is not None and self._preempt.preempted.is_set()

    def on_step(self, train_step) -> None:
        """Per-step hook (called by TrainStep.__call__ after the step counter
        advances). MUST stay zero-work when idle: the non-interval path below
        is an Event read and an int modulo."""
        if self._preempt is not None and self._preempt.preempted.is_set():
            self._finalize_preempt(train_step)
        every = self.every_n_steps
        if every and train_step._step_count % every == 0:
            self.save(train_step)

    # -- state capture ------------------------------------------------------

    def _collect(self, train_step) -> tuple[dict, dict]:
        """(state tree of live tensors, JSON-safe meta)."""
        tmodule = train_step.tmodule
        params = dict(tmodule.get_parameters())
        buffers = dict(tmodule.get_buffers())
        state = {"params": params, "buffers": buffers,
                 "opt_state": train_step.opt_state if train_step.opt_state is not None else {}}
        meta = {
            "step": train_step._step_count,
            "saved_at": time.time(),
            "has_opt_state": train_step.opt_state is not None,
            "n_params": len(params),
            "n_buffers": len(buffers),
            "opt_state_leaves": len(dist_ckpt.flatten(state["opt_state"])),
            "loader": None,
        }
        loader_sd = getattr(self.loader, "state_dict", None)
        if callable(loader_sd):
            meta["loader"] = loader_sd()
        return state, meta

    @staticmethod
    @torch.no_grad()
    def _snapshot(state: dict) -> _Snapshot:
        """Tensors of the writer's own: the step loop goes on to overwrite
        the live ones in place (on the card, the copies are queued on the
        current stream before the next step's writes)."""
        copies = dist_ckpt.unflatten(state, [t.detach().clone() if isinstance(t, torch.Tensor) else t
                                             for t in dist_ckpt.flatten(state)])
        event = None
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in dist_ckpt.flatten(copies)):
            event = torch.cuda.Event()
            event.record()
        return _Snapshot(copies, event)

    # -- save ---------------------------------------------------------------

    def save(self, train_step, *, block: Optional[bool] = None,
             reason: str = "interval", skip_wait: bool = False) -> Optional[str]:
        """Checkpoint the full training state. Returns the final step-dir path
        for blocking saves, None for async ones (poll ``wait()``)."""
        self._check_single_process()
        t0 = time.perf_counter()
        if not skip_wait:
            self.wait()  # one in-flight write at a time; surfaces strict errors
        step = train_step._step_count
        state, meta = self._collect(train_step)
        snap = self._snapshot(state)
        final = os.path.join(self.directory, step_dir_name(step))
        _obs.event("checkpoint_save", phase="start", step=step, reason=reason)
        blocking = (not self.async_save) if block is None else block
        record = {"step": step, "reason": reason, "blocking": blocking}
        self.save_log.append(record)
        if blocking:
            self._write(snap, meta, final, record)
            record["stall_ms"] = (time.perf_counter() - t0) * 1e3
            if self.strict:
                self.wait()  # re-raises the stored write error, if any
            return final if self._last_error is None else None
        t = threading.Thread(target=self._write, args=(snap, meta, final, record),
                             name="tt-ckpt-writer", daemon=True)
        with self._lock:
            self._writer = t
        t.start()
        record["stall_ms"] = (time.perf_counter() - t0) * 1e3
        return None

    def _write(self, snap: _Snapshot, meta: dict, final: str, record: Optional[dict] = None) -> None:
        t0 = time.perf_counter()
        step = meta["step"]
        # thread ident too: an ESCALATED preemption save may legitimately
        # overlap an in-flight async writer from this same pid at this step
        tmp = os.path.join(
            self.directory,
            f".tmp-{step}-{os.getpid()}-{threading.get_ident()}")
        try:
            if _faults.active():
                _faults.maybe_raise("ckpt_fail", step)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            arrays, names = snap.host_leaves()
            note, snap = snap.note, None  # the device copies go back to the allocator
            t_host = time.perf_counter()
            dist_ckpt.write_flat_npz(os.path.join(tmp, _STATE_SUBDIR), arrays, dtype_names=names,
                                     treedef_note=note)
            nbytes = sum(a.nbytes for a in arrays)
            del arrays
            t_npz = time.perf_counter()
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f, indent=1, sort_keys=True)
            manifest = {"step": step, "format": "checkpoint-v1",
                        "files": _manifest_files(tmp)}
            t_digest = time.perf_counter()
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
            # overwrite via rename-aside: rmtree(final) before the replace
            # would open a crash window that destroys a DURABLE checkpoint
            # with its replacement not yet in place (e.g. the re-save that
            # follows a rollback restore). The aside dir fails list_steps's
            # int() parse, so a crash between the two renames leaves the old
            # data on disk without ever being mistaken for a live step.
            aside = None
            if os.path.isdir(final):
                aside = f"{final}.old-{os.getpid()}"
                shutil.rmtree(aside, ignore_errors=True)
                os.replace(final, aside)
            os.replace(tmp, final)
            if aside is not None:
                shutil.rmtree(aside, ignore_errors=True)
        except BaseException as e:
            shutil.rmtree(tmp, ignore_errors=True)
            self.failed_saves += 1
            _obs.event("checkpoint.save_failed", step=step,
                       error=f"{type(e).__name__}: {e}"[:300])
            _obs.inc("checkpoint.save_failed")
            with self._lock:
                self._last_error = e
            if not self.strict:
                warnings.warn(
                    f"checkpoint save at step {step} failed (non-fatal): "
                    f"{type(e).__name__}: {e}", stacklevel=2)
            return
        self.saves += 1
        write_s = time.perf_counter() - t0
        if record is not None:
            # write_s = to_host_s (device to host) + npz_s + digest_s (the manifest's sha256) + the renames
            record.update(write_s=write_s, bytes=nbytes, path=final, to_host_s=t_host - t0,
                          npz_s=t_npz - t_host, digest_s=t_digest - t_npz)
        with self._lock:
            self._last_error = None
        _obs.event("checkpoint_save", phase="done", step=step,
                   ms=round(write_s * 1e3, 3))
        _obs.inc("checkpoint.saved")
        self._prune()

    def wait(self) -> None:
        """Join any in-flight async write; in strict mode re-raise its error
        on the caller's (step-loop) thread."""
        with self._lock:
            t = self._writer
        if t is not None:
            t.join()
            with self._lock:
                self._writer = None
        if self.strict:
            with self._lock:
                err, self._last_error = self._last_error, None
            if err is not None:
                raise CheckpointError("checkpoint save failed") from err

    def close(self) -> None:
        """Join the writer and give SIGTERM (and any other trapped signal)
        back to its previous handler."""
        self.wait()
        if self._preempt is not None:
            self._preempt.uninstall()

    def _prune(self) -> None:
        steps = list_steps(self.directory)
        for _, path in steps[:-self.keep]:
            shutil.rmtree(path, ignore_errors=True)
            _obs.inc("checkpoint.pruned")
        # sweep rename-aside/tmp leftovers from crashed earlier attempts —
        # never this pid's (each _write cleans its own), and never anything
        # recent (another process may share the directory)
        own = f"-{os.getpid()}"
        now = time.time()
        for name in os.listdir(self.directory):
            if not ((".old-" in name or name.startswith(".tmp-")) and own not in name):
                continue
            path = os.path.join(self.directory, name)
            try:
                if now - os.path.getmtime(path) < _LEFTOVER_MIN_AGE_S:
                    continue
            except OSError:
                continue
            shutil.rmtree(path, ignore_errors=True)

    # -- preemption ---------------------------------------------------------

    def _finalize_preempt(self, train_step) -> None:
        step = train_step._step_count
        escalated = (self._preempt is not None
                     and self._preempt.escalated.is_set())
        reason = "preempt-escalated" if escalated else "preempt"
        path = None
        try:
            # escalated (second SIGTERM in the drain window): the grace
            # period is nearly gone — skip the courtesy join of any
            # in-flight async writer and save NOW; the final save's step
            # dir is distinct from any earlier interval save's, so the
            # concurrent writer cannot collide with it
            path = self.save(train_step, block=True, reason=reason,
                             skip_wait=escalated)
        except BaseException as e:
            warnings.warn(f"final preemption checkpoint failed: {e}", stacklevel=2)
        _obs.event("preempt_checkpoint", step=step, path=path,
                   escalated=escalated)
        _obs_metrics.record_intervention(reason, step=step,
                                         saved=path is not None)
        raise Preempted(
            f"preempted at step {step}"
            + (" (escalated: repeat signal during drain)" if escalated else "")
            + (f"; checkpoint saved to {path}" if path else "; final checkpoint FAILED"),
            step=step, checkpoint_path=path)

    # -- restore ------------------------------------------------------------

    def latest(self) -> Optional[tuple[int, str]]:
        """Newest step dir that passes manifest validation (corrupt/partial
        checkpoints are skipped with a warning, falling back to older ones)."""
        for step, path in reversed(list_steps(self.directory)):
            ok, problems = validate_step(path)
            if ok:
                return step, path
            warnings.warn(f"skipping invalid checkpoint {path}: {problems}",
                          stacklevel=2)
        return None

    def restore(self, train_step, *, step: Optional[int] = None,
                loader=None) -> dict:
        """Restore the full training state into ``train_step`` (and the
        loader), every tensor in place. Returns the checkpoint's meta dict.
        Round-trips bit-identically: tensors are saved and restored at their
        exact shapes and dtypes."""
        t0 = time.perf_counter()
        self._check_single_process()
        self.wait()
        if step is None:
            found = self.latest()
            if found is None:
                raise CheckpointError(
                    f"no valid checkpoint found in {self.directory}")
            step, stepdir = found
        else:
            stepdir = os.path.join(self.directory, step_dir_name(step))
            ok, problems = validate_step(stepdir)
            if not ok:
                raise CheckpointError(
                    f"checkpoint {stepdir} failed validation: {problems}")
        t_valid = time.perf_counter()
        meta = read_meta(stepdir)
        live = live_state(train_step, meta.get("has_opt_state", False))
        state = dist_ckpt.load(os.path.join(stepdir, _STATE_SUBDIR), like=live)
        t_load = time.perf_counter()
        copy_state_(live, state)
        train_step._step_count = int(meta["step"])
        _obs.event("checkpoint_restore", step=meta["step"], path=stepdir)
        _obs.inc("checkpoint.restored")
        ldr = loader or self.loader
        if meta.get("loader") is not None and ldr is not None:
            ldr.load_state_dict(meta["loader"])
        t_end = time.perf_counter()
        # seconds = validate_s (the manifest's sha256) + load_s (the npz) + copy_s (into the step's tensors)
        self.last_restore = {"step": meta["step"], "seconds": t_end - t0, "path": stepdir,
                             "validate_s": t_valid - t0, "load_s": t_load - t_valid, "copy_s": t_end - t_load}
        return meta


def live_state(train_step, with_opt_state: bool) -> dict:
    """The state tree ``restore`` writes into: the step's parameters,
    buffers and (when the checkpoint has one) optimizer state, which a step
    that has not run yet initializes first."""
    tmodule = train_step.tmodule
    params = dict(tmodule.get_parameters())
    opt = {}
    if with_opt_state:
        if train_step.opt_state is None:
            train_step.opt_state = train_step.optimizer.init(
                {k: p for k, p in params.items() if p.requires_grad})
        opt = train_step.opt_state
    return {"params": params, "buffers": dict(tmodule.get_buffers()), "opt_state": opt}


@torch.no_grad()
def copy_state_(live: dict, state: dict) -> None:
    """Copy every leaf of ``state`` (host tensors) into the tensor at the
    same place in ``live``, in place; a dtype mismatch raises (nothing is
    cast), as a shape mismatch did in the load."""
    for i, (dst, src) in enumerate(zip(dist_ckpt.flatten(live), dist_ckpt.flatten(state))):
        if dst.dtype != src.dtype:
            raise CheckpointError(f"checkpoint leaf {i}: dtype {src.dtype}, the live tensor's {dst.dtype}")
        dst.copy_(src)
