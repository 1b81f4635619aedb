"""graphex: whole-program execution as CUDA-graph capture.

The port's counterpart of thunder_tpu/executors/xlaex.py. thunder_tpu hands a
claimed trace to XLA, which compiles it into one program; on a typical trace
the whole computation is one fusion, and the host dispatches it once. Here a
claimed trace runs as its Python callable, one torch call or kernel launch a
bound symbol, so the host issues every launch of every call. A
``CUDAGraphProgram`` takes XLA's place: it captures those launches once with
``torch.cuda.graph`` and then replays them as one launch of the graph.

Capture wraps the program. It does not rewrite the trace: the claimed trace a
caller reads with ``last_traces`` is the one that runs, launch for launch.

What a program does with its inputs and outputs:

* The first ``warmup`` calls run eagerly (they compile, build the kernels,
  make lazily allocated state outside the capture). The next call captures,
  then replays; every later call replays.
* An input marked ``in_place`` is captured as the caller's own tensor and is
  read and written there: parameters, page pools, KV caches, optimizer
  state. A call whose in-place inputs sit at other addresses captures again
  for those addresses (one graph per address set); it never writes into a
  copy the caller does not hold.
* Any other input is copied, each call, into a buffer the graph owns.
* Outputs that are in-place inputs come back as the caller's tensors; every
  other output comes back as a clone, so a replay never overwrites what an
  earlier call returned.
* The kernels' Python launch counters (``cudaex``'s ``<wrapper>.launches``
  and the counters registered with ``register_counter``) are not run by a
  replay: a capture records each counter's change, undoes it (the capture
  launched nothing) and every replay adds it. A captured path counts what it
  launches, as the op-by-op path does.
* While a program captures, ``capturing()`` names it: code that must not
  copy from the host under capture (cudaex's AdamW tables) uses
  ``device_table``, whose copy is made right after the capture ends, and
  ``keep`` ties tensors a graph reads to the graph's life. A jit program
  called during another program's capture runs op by op inside it.

Programs that never run at once (a serving runner's buckets, decode, chunk
and verify) share one ``GraphPool``, so their scratch is one allocation.

A trace that holds a host sync or a host-side effect cannot be captured
(xlaex's ``_fusible`` rule): asking for capture of one raises, naming the
symbol."""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import torch

from ..core.prims import PrimIDs
from ..core.pytree import tree_flatten, tree_unflatten
from ..core.symbol import OpTags

_STRUCTURAL = (PrimIDs.RETURN, PrimIDs.DEL, PrimIDs.COMMENT, PrimIDs.UNPACK_TRIVIAL)
_NOFUSE_IDS = (PrimIDs.ITEM, PrimIDs.PRINT, PrimIDs.DEVICE_PUT,
               PrimIDs.CHECK_TENSOR_SHAPE_AND_METADATA, PrimIDs.CHECK_NUMBER_TYPE_AND_VALUE)


def _fusible(bsym) -> bool:
    """xlaex.XLAFusionExecutor._fusible without its impl test (a claimed
    trace has an implementation on every bound symbol)."""
    if bsym.sym.id in _NOFUSE_IDS:
        return False
    if OpTags.DONT_FUSE in bsym.sym.tags or OpTags.DONT_FUSE in bsym.tags:
        return False
    return OpTags.DEVICE_SYNC_OP not in bsym.sym.tags


def collectives_capture() -> bool:
    """Whether this process's collectives can run inside a CUDA graph: those
    of a one-rank NCCL group do (cp_train's all-reduces, the FSDP gathers
    and reduce-scatters, the expert all-to-alls). A multi-rank NCCL group's
    capture has not been tried (ROADMAP A3c); a Gloo group's run on the
    host."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl"
            and dist.get_world_size() == 1)


def uncapturable(trace):
    """The first bound symbol of ``trace`` (its subsymbols included) that a
    CUDA graph cannot hold, or None. A collective's DONT_FUSE is xlaex's
    fusion boundary, not a host effect (thunder_tpu's one-program step holds
    the collective): a collective is held where ``collectives_capture()``."""

    def walk(bsyms):
        for b in bsyms:
            if b.sym.id in _STRUCTURAL:
                continue
            if OpTags.COLLECTIVE in b.sym.tags:
                if not collectives_capture():
                    return b
                continue
            if not _fusible(b):
                return b
            found = walk(b.subsymbols)
            if found is not None:
                return found
        return None

    return walk(trace.bound_symbols)


def check_capturable(trace, name: str) -> None:
    bad = uncapturable(trace)
    if bad is not None and OpTags.COLLECTIVE in bad.sym.tags:
        raise NotImplementedError(
            f"{name}: CUDA-graph capture was asked for, but the trace holds the collective "
            f"{bad.sym.name} (id={bad.sym.id}) and only a one-rank NCCL group's collectives are "
            f"captured (multi-rank capture: ROADMAP A3c); run it with cuda_graphs=False")
    if bad is not None:
        raise RuntimeError(
            f"{name}: CUDA-graph capture was asked for, but the trace holds {bad.sym.name} "
            f"(id={bad.sym.id}), which syncs with or acts on the host; run it with cuda_graphs=False")


def captures_on(device: torch.device) -> bool:
    """Whether tensors on ``device`` run through captured graphs: CUDA
    tensors do, CPU tensors run op by op (as a kernel's plain version runs
    only on the CPU)."""
    return device.type == "cuda"


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

_COUNTERS: list = []  # (holder, key): a function's attribute or a dict's item


def register_counter(holder, key: str = "launches") -> None:
    """Make a replay add to ``holder.key`` (or ``holder[key]`` for a dict)
    what its capture added."""
    _COUNTERS.append((holder, key))


def _read_counters() -> list:
    return [h[k] if isinstance(h, dict) else getattr(h, k) for h, k in _COUNTERS]


def _add_counters(deltas: Sequence[int]) -> None:
    for (h, k), d in zip(_COUNTERS, deltas):
        if d:
            if isinstance(h, dict):
                h[k] += d
            else:
                setattr(h, k, getattr(h, k) + d)


# ---------------------------------------------------------------------------
# capture state
# ---------------------------------------------------------------------------

_state = threading.local()


_ARENA_BYTES = 1 << 20  # device tables a capture may place (cudaex's AdamW tables: 48 B a tensor)


class _Capture:
    """What one capture collects besides the graph: device tables to fill
    once it ends, and tensors the graph reads that must live as long as it.
    ``arena``: device bytes allocated before the capture began, where its
    tables go (see device_table)."""

    def __init__(self, arena=None):
        self.uploads: list = []
        self.kept: list = [] if arena is None else [arena]
        self.arena = arena
        self.used = 0


def capturing() -> Optional[_Capture]:
    """The capture running on this thread, or None."""
    return getattr(_state, "capture", None)


def keep(*tensors) -> None:
    """Tie tensors that the graph being captured reads to the graph's life."""
    cap = capturing()
    if cap is not None:
        cap.kept.extend(tensors)


def device_table(host: torch.Tensor, device) -> torch.Tensor:
    """``host`` on ``device``: from pinned memory without a stream sync
    outside a capture; under capture a slice of the capture's arena that is
    filled right after the capture ends (no host-to-device copy enters the
    graph) and lives as long as the graph."""
    cap = capturing()
    if cap is None:
        return host.pin_memory().to(device, non_blocking=True)
    # Not a tensor of the graph's pool: a block the capture hands out may be
    # one that an earlier node of the same graph writes as its scratch on
    # every replay; and no allocation outside the pool may happen during a
    # capture (it could call cudaMalloc). So tables go into an arena
    # allocated before the capture began.
    nbytes = host.numel() * host.element_size()
    start = -(-cap.used // 256) * 256
    if cap.arena is None or start + nbytes > cap.arena.numel():
        raise RuntimeError(f"device tables of one capture exceed its {_ARENA_BYTES}-byte arena")
    dev = cap.arena[start:start + nbytes].view(host.dtype).view(host.shape)
    cap.used = start + nbytes
    cap.uploads.append((dev, host))
    return dev


class GraphPool:
    """One CUDA-graph memory pool, shared by programs that never run at the
    same time; the handle is made at the first capture."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


def _torch_capture(fn: Callable, static: list, pool: GraphPool):
    """Capture fn(*static) into a CUDA graph: (replay, outputs)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool.handle(), capture_error_mode="thread_local"):
        out = fn(*static)
    return graph.replay, out


class _Captured:
    __slots__ = ("replay_fn", "static", "copied", "leaves", "treedef", "alias", "deltas", "kept")

    def replay(self, tensors) -> object:
        for i in self.copied:
            self.static[i].copy_(tensors[i])
        self.replay_fn()
        _add_counters(self.deltas)
        leaves = [tensors[j] if j is not None else (x.clone() if isinstance(x, torch.Tensor) else x)
                  for x, j in zip(self.leaves, self.alias)]
        return tree_unflatten(leaves, self.treedef)


class CUDAGraphProgram:
    """fn(*tensors) -> a pytree of outputs, run as a captured CUDA graph (see
    the module docstring). ``in_place``: one flag a tensor input; ``stats``:
    a CompileStats whose graph_captures and graph_replays it counts;
    ``check``: called before each capture (it may raise: a TrainStep's
    traces exist only after its warm-up call)."""

    _capture_fn = staticmethod(_torch_capture)

    def __init__(self, fn: Callable, *, name: str, in_place: Sequence[bool], pool: GraphPool,
                 stats=None, warmup: int = 1, check: Optional[Callable[[], None]] = None):
        self.fn = fn
        self.check = check
        self.name = name
        self.in_place = tuple(bool(x) for x in in_place)
        self.pool = pool
        self.stats = stats
        self.warmup = warmup
        self._eager = 0
        self._graphs: dict = {}

    def __call__(self, *tensors):
        if len(tensors) != len(self.in_place):
            raise ValueError(f"{self.name}: {len(tensors)} inputs, captured with {len(self.in_place)}")
        if self._eager < self.warmup:
            self._eager += 1
            return self._checked_eager(tensors)
        key = tuple((t.data_ptr(), t.stride()) for t, ip in zip(tensors, self.in_place) if ip)
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(tensors)
        if self.stats is not None:
            self.stats.graph_replays.add()
        return cap.replay(tensors)

    def _checked_eager(self, tensors):
        """An eager call that also checks that every input the program
        writes with a torch in-place op is marked in place (a copied input
        written by the graph would leave the caller's tensor stale)."""
        versions = [t._version for t in tensors]
        out = self.fn(*tensors)
        for i, (t, v) in enumerate(zip(tensors, versions)):
            if t._version != v and not self.in_place[i]:
                raise RuntimeError(f"{self.name}: input {i} is written in place but was not marked "
                                   f"in_place; a captured replay would write a copy")
        return out

    def _capture(self, tensors) -> _Captured:
        if self.check is not None:
            self.check()
        static = [t if ip else torch.empty_like(t) for t, ip in zip(tensors, self.in_place)]
        copied = [i for i, ip in enumerate(self.in_place) if not ip]
        for i in copied:
            static[i].copy_(tensors[i])
        if capturing() is not None:
            raise RuntimeError(f"{self.name}: a capture cannot start inside another capture")
        before = _read_counters()
        cuda = [t.device for t in tensors if t.is_cuda]
        cap = _Capture(torch.empty(_ARENA_BYTES, dtype=torch.uint8, device=cuda[0]) if cuda else None)
        _state.capture = cap
        try:
            replay_fn, out = self._capture_fn(self.fn, static, self.pool)
        finally:
            _state.capture = None
            after = _read_counters()
            _add_counters([a - b for a, b in zip(before, after)])  # the capture launched nothing
        for dev, host in cap.uploads:
            dev.copy_(host)
        leaves, treedef = tree_flatten(out)
        where = {(t.data_ptr(), t.shape, t.dtype): i for i, t in enumerate(static) if self.in_place[i]}
        c = _Captured()
        c.replay_fn, c.static, c.copied, c.leaves, c.treedef = replay_fn, static, copied, leaves, treedef
        c.alias = [where.get((x.data_ptr(), x.shape, x.dtype)) if isinstance(x, torch.Tensor) else None
                   for x in leaves]
        c.deltas = [b - a for a, b in zip(before, after)]
        c.kept = cap.kept
        if self.stats is not None:
            self.stats.graph_captures.add()
        return c
