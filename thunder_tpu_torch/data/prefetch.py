"""Async host-to-device prefetch: overlap H2D transfer with the device step.

thunder_tpu/data/prefetch.py for the port. A training loop that copies
each batch to the card inside the step loop serializes the copy with
compute. ``prefetch_to_device`` moves the transfer onto a background thread
with a small bounded buffer (double-buffered by default): while the card
runs step N, batch N+1 is already on its way.

    loader = TokenLoader(path, B, T)
    for x, y in loader.prefetched(size=2):     # or prefetch_to_device(loader.batches())
        loss = step(x, y)

On the card (thunder_tpu's ``jax.device_put``): each array or tensor leaf
is copied into a pinned host buffer, then to the card with
``non_blocking=True`` on a side stream, and an event is recorded after the
copies. The consumer's stream waits on that event when it takes the item
(``__next__``), so the step that reads the batch is ordered after its copy
without a host sync, and the batch's tensors are marked as used on the
consumer's stream (``record_stream``) so the allocator does not hand their
memory back to the side stream while the step still reads it. A pinned
buffer is reused only after the event of its last copy has completed. On
the CPU the transfer is the identity (numpy arrays become tensors that
share their memory).

Failure-mode contract (tested in tests/test_torch_data.py):

* ordering is preserved exactly;
* iterator exhaustion terminates the consumer loop cleanly;
* a worker exception (from the source iterator OR the transfer) re-raises
  in the consumer at the position it occurred;
* early consumer exit (break / del / close) never deadlocks the worker —
  the producer's queue put is stop-aware, and ``close()`` drains the queue.

A prefetcher made by ``TokenLoader.prefetched`` keeps an exact cursor: its
``state_dict()`` counts the batches the consumer took, not the ones the
worker pulled ahead, so a checkpoint resumes at the next batch the step
would have seen; its ``load_state_dict`` re-positions the loader and
restarts the worker.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..core.pytree import tree_flatten, tree_unflatten


class _End:
    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<end-of-stream>"


_END = _End()


def _stop_aware_put(q: queue.Queue, stop: threading.Event, item) -> bool:
    """Bounded put that never blocks past a stop signal. False = consumer gone."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def _drain_and_join(q: queue.Queue, stop: threading.Event,
                    thread: Optional[threading.Thread], timeout: float = 5.0) -> None:
    """Shared shutdown: signal stop, empty the queue so a producer blocked
    on put() exits promptly, then join the worker."""
    stop.set()
    while True:
        try:
            q.get_nowait()
        except queue.Empty:
            break
    if thread is not None:
        thread.join(timeout=timeout)


def _prefetch_worker(it: Iterator, transfer: Callable, q: queue.Queue,
                     stop: threading.Event) -> None:
    try:
        for item in it:
            if stop.is_set():
                return
            if not _stop_aware_put(q, stop, transfer(item)):
                return
        _stop_aware_put(q, stop, _END)
    except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
        _stop_aware_put(q, stop, e)


def _as_tensor(leaf):
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf).reshape(leaf.shape))
    return leaf


class _CardTransfer:
    """An item's array and tensor leaves to the card: through pinned buffers
    (a ring per leaf shape and dtype, each buffer reused only after its last
    copy's event completed) on a side stream. Returns (item, event)."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.depth = depth
        self._rings: dict = {}

    def _pinned(self, t: torch.Tensor) -> torch.Tensor:
        key = (tuple(t.shape), t.dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = {"bufs": [], "next": 0}
        if len(ring["bufs"]) < self.depth:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            ring["bufs"].append([buf, None])
            slot = ring["bufs"][-1]
        else:
            slot = ring["bufs"][ring["next"]]
            ring["next"] = (ring["next"] + 1) % self.depth
            if slot[1] is not None:
                slot[1].synchronize()  # its last copy has left the buffer
        slot[0].copy_(t)
        return slot

    def __call__(self, item):
        leaves, treedef = tree_flatten(item)
        out, slots = [], []
        with torch.cuda.stream(self.stream):
            for leaf in leaves:
                leaf = _as_tensor(leaf)
                if not isinstance(leaf, torch.Tensor):
                    out.append(leaf)
                elif leaf.is_cuda:
                    out.append(leaf.to(self.device, non_blocking=True))
                else:
                    slot = self._pinned(leaf)
                    out.append(slot[0].to(self.device, non_blocking=True))
                    slots.append(slot)
            event = torch.cuda.Event()
            event.record(self.stream)
        for slot in slots:
            slot[1] = event
        return _Delivery(tree_unflatten(out, treedef), event)


class _Delivery:
    """A transferred item and the event after its copies."""

    __slots__ = ("item", "event")

    def __init__(self, item, event):
        self.item = item
        self.event = event

    def take(self):
        """The item, ordered after its copies on the consumer's stream."""
        stream = torch.cuda.current_stream()
        stream.wait_event(self.event)
        for leaf in tree_flatten(self.item)[0]:
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                leaf.record_stream(stream)
        return self.item


def _host_transfer(item):
    leaves, treedef = tree_flatten(item)
    return tree_unflatten([_as_tensor(x) for x in leaves], treedef)


class DevicePrefetchIterator:
    """Iterator whose background thread copies upcoming items to ``device``.

    ``size`` bounds how many transferred batches may be in flight (buffer
    memory = size x batch bytes). ``device``: the card by default
    (``core.devices.resolve_device``), or ``"cpu"``. ``transfer`` overrides
    the transfer function entirely (tests, custom layouts). ``cursor``: the
    loader behind ``iterable`` (``TokenLoader.prefetched`` passes it), which
    makes ``state_dict``/``load_state_dict`` available.
    """

    def __init__(self, iterable: Iterable, *, size: int = 2, device=None,
                 transfer: Optional[Callable[[Any], Any]] = None, cursor=None):
        if size < 1:
            raise ValueError(f"prefetch size must be >= 1, got {size}")
        if transfer is None:
            from ..core.devices import resolve_device

            dev = resolve_device(device)
            transfer = _CardTransfer(dev, size + 2) if dev.type == "cuda" else _host_transfer
        self._transfer = transfer
        self._size = size
        self._cursor = cursor
        self._start(iterable)

    def _start(self, iterable) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=self._size)
        self._stop = threading.Event()
        self._done = False
        self._base = self._cursor.state_dict()["served"] if self._cursor is not None else 0
        self._delivered = 0
        # the worker closes over the queue/stop-event, NOT self: a bound
        # method would let the running thread keep this iterator alive, so a
        # consumer that just drops the iterator would never reach __del__ and
        # the producer would spin forever
        self._thread = threading.Thread(
            target=_prefetch_worker, args=(iter(iterable), self._transfer, self._q, self._stop),
            name="tt-device-prefetch", daemon=True)
        self._thread.start()

    # -- consumer ----------------------------------------------------------

    def __iter__(self) -> "DevicePrefetchIterator":
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # worker died without a sentinel (interpreter teardown
                    # killed the daemon): drain what's left, then stop
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        self._done = True
                        raise StopIteration from None
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            self._stop.set()
            raise item
        self._delivered += 1
        return item.take() if isinstance(item, _Delivery) else item

    # -- checkpointable cursor ----------------------------------------------

    def state_dict(self) -> dict:
        """The loader's cursor at the batches the consumer took."""
        if self._cursor is None:
            raise TypeError("this prefetcher has no cursor (make it with TokenLoader.prefetched)")
        return dict(self._cursor.state_dict(), served=self._base + self._delivered)

    def load_state_dict(self, sd: dict) -> None:
        """Re-position the loader at ``sd`` and restart the worker there."""
        if self._cursor is None:
            raise TypeError("this prefetcher has no cursor (make it with TokenLoader.prefetched)")
        _drain_and_join(self._q, self._stop, self._thread)
        self._cursor.load_state_dict(sd)
        self._start(self._cursor.batches())

    # -- shutdown ----------------------------------------------------------

    def close(self) -> None:
        """Idempotent shutdown: unblocks and joins the worker."""
        self._done = True
        _drain_and_join(self._q, self._stop, self._thread)

    def __enter__(self) -> "DevicePrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def prefetch_to_device(iterator: Iterable, size: int = 2, device=None,
                       *, transfer: Optional[Callable[[Any], Any]] = None,
                       cursor=None) -> DevicePrefetchIterator:
    """Wrap ``iterator`` so upcoming items are copied to ``device`` (the card
    by default) on a background thread — H2D overlaps the consumer's compute.
    ``size=2`` is classic double buffering; raise it only if batch
    production is bursty."""
    return DevicePrefetchIterator(iterator, size=size, device=device,
                                  transfer=transfer, cursor=cursor)
