"""Checkpoint save/load of state trees: the flat npz layout.

thunder_tpu/parallel/checkpoint.py for the port, limited to its portable
route: a state tree (nested dicts, lists and tuples of tensors) is written
as one ``state.npz`` of positional arrays in thunder_tpu's flatten order
(``jax.tree_util``: dict keys sorted, ``None`` an empty subtree), with the
true dtype names inside the npz (``__tt_dtypes__``) and a note of the
structure (``__tt_treedef__``: jax's treedef string, which names every
leaf). bf16 and fp8 tensors are stored as raw void
bytes, as numpy stores thunder_tpu's ml_dtypes arrays (``|V2``, ``|V1``):
the port views bf16 as int16 and fp8 as uint8 to get there, so it needs no
ml_dtypes. A directory either package writes, the other reads.

Not ported: the orbax routes (``save``/``load`` through orbax's
PyTreeCheckpointer and ``async_save`` through its AsyncCheckpointer) have no
torch counterpart; robustness.CheckpointManager runs its own writer thread.
Sharded (per-host) checkpoints belong to ROADMAP A3c."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

_META_KEYS = ("__tt_dtypes__", "__tt_treedef__")
# dtypes numpy has no type of its own for: stored as void bytes of their width,
# viewed through the integer type of that width on the way in and out
_VOID = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8, torch.float8_e5m2: torch.uint8}
for _name in ("float8_e4m3fnuz", "float8_e5m2fnuz"):
    if hasattr(torch, _name):
        _VOID[getattr(torch, _name)] = torch.uint8
_BY_NAME = {str(dt).replace("torch.", ""): dt for dt in _VOID}


@dataclass
class StateDictOptions:
    """thunder_tpu/parallel/checkpoint.py StateDictOptions.

    full_state_dict: full tensors (the port's are never sharded).
    cpu_offload: host copies regardless.
    rank0_only: only process 0 materializes/saves (other ranks get {}).
    """

    full_state_dict: bool = False
    cpu_offload: bool = False
    rank0_only: bool = False


def _rank() -> int:
    from . import multiprocess

    return multiprocess.process_index()


def flatten(tree) -> list:
    """The leaves of ``tree`` in thunder_tpu's order: dict keys sorted, lists
    and tuples in order, None no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in flatten(x)]
    return [tree]


def unflatten(like, leaves: list):
    """``like``'s structure with ``leaves`` (in ``flatten`` order) in place
    of its leaves."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def treedef_note(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts, lists,
    tuples, None and leaves: the structure note thunder_tpu writes beside
    its arrays, whose dict keys name every leaf in flatten order."""
    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(x) for x in node) + "]"
        if isinstance(node, tuple):
            return "(" + ", ".join(walk(x) for x in node) + ("," if len(node) == 1 else "") + ")"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def to_numpy(x) -> np.ndarray:
    """A host copy of one leaf as the npz stores it: bf16/fp8 as void bytes.
    A CUDA tensor is copied to the host (a sync)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach()
    if t.dtype in _VOID:
        w = t.element_size()
        return t.view(_VOID[t.dtype]).cpu().numpy().view(np.dtype(f"V{w}"))
    return t.cpu().numpy()


def dtype_name(x) -> str:
    """The dtype name the npz's manifest records for a leaf (numpy's names;
    ml_dtypes' for bf16 and fp8)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def from_numpy(a: np.ndarray, name: str) -> torch.Tensor:
    """The CPU tensor of a stored array whose true dtype is ``name``."""
    if name in _BY_NAME:
        dt = _BY_NAME[name]
        a = np.ascontiguousarray(a).reshape(a.shape).view(str(_VOID[dt]).replace("torch.", ""))
        return torch.from_numpy(a).view(dt)
    if str(a.dtype) != name:
        raise ValueError(f"stored array of dtype {a.dtype} is listed as {name}")
    return torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))


def write_flat_npz(path: str, arrays: list, *, treedef_note: str, dtype_names: list | None = None) -> None:
    """thunder_tpu's ``write_flat_npz``: positional arrays in flatten order
    plus the in-payload dtype manifest and a structure note, written to a
    temporary file and renamed into place (a crash mid-write never leaves a
    partial state.npz that a later load would trust). ``arrays`` are host
    arrays (``to_numpy``); ``dtype_names`` their true dtypes (default: the
    arrays' own)."""
    os.makedirs(path, exist_ok=True)
    names = dtype_names if dtype_names is not None else [str(a.dtype) for a in arrays]
    final = os.path.join(path, "state.npz")
    tmp = f"{final}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, *arrays, __tt_dtypes__=np.array(json.dumps(names)),
                     __tt_treedef__=np.array(treedef_note))
        os.replace(tmp, final)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save(state_dict: dict, path: str, *, options: StateDictOptions | None = None) -> None:
    """Save a state tree (tensors on any device, or host arrays) as the flat
    npz under ``path``."""
    options = options or StateDictOptions()
    if options.rank0_only and _rank() != 0:
        return
    flat = flatten(state_dict)
    write_flat_npz(path, [to_numpy(x) for x in flat], dtype_names=[dtype_name(x) for x in flat],
                   treedef_note=treedef_note(state_dict))


def load(path: str, *, like=None, options: StateDictOptions | None = None):
    """Load the flat npz under ``path`` into ``like``'s structure (a tree of
    tensors or arrays, which gives the order): a tree of CPU tensors of the
    stored dtypes. Each leaf's shape must be ``like``'s."""
    if like is None:
        raise ValueError("load needs `like` for the tree structure (the npz holds positional arrays)")
    path = os.path.abspath(path)
    with np.load(os.path.join(path, "state.npz")) as data:
        n = sum(1 for k in data.files if k not in _META_KEYS)
        arrays = [data[f"arr_{i}"] for i in range(n)]
        if "__tt_dtypes__" in data.files:
            names = json.loads(str(data["__tt_dtypes__"]))
        else:  # written before the dtype manifest: numpy's own dtypes
            names = [str(a.dtype) for a in arrays]
    if len(names) != len(arrays):
        raise ValueError(f"corrupt checkpoint {path!r}: dtype manifest lists {len(names)} arrays, "
                         f"payload has {len(arrays)}")
    want = flatten(like)
    if len(want) != len(arrays):
        raise ValueError(f"checkpoint {path!r} holds {len(arrays)} arrays, the structure {len(want)}")
    out = []
    for i, (a, name, w) in enumerate(zip(arrays, names, want)):
        t = from_numpy(a, name)
        if tuple(t.shape) != tuple(np.shape(w)):
            raise ValueError(f"checkpoint {path!r}: leaf {i} has shape {tuple(t.shape)}, "
                             f"the structure {tuple(np.shape(w))}")
        out.append(t)
    return unflatten(like, out)


def get_model_state_dict(tmodule, options: StateDictOptions | None = None) -> dict:
    """The module's parameters by qualified name: the live tensors, or host
    copies under ``full_state_dict``/``cpu_offload``."""
    options = options or StateDictOptions()
    if options.rank0_only and _rank() != 0:
        return {}
    sd = {k: p.detach() for k, p in tmodule.get_parameters().items()}
    if options.full_state_dict or options.cpu_offload:
        sd = {k: v.cpu().clone() for k, v in sd.items()}
    return sd


@torch.no_grad()
def load_model_state_dict(sd: dict, tmodule, options: StateDictOptions | None = None) -> None:
    """Write ``sd``'s values into the module's parameters in place (so a
    captured CUDA graph that reads them sees the new values). A shape or
    dtype mismatch raises; nothing is cast."""
    params = tmodule.get_parameters()
    for k, v in sd.items():
        p = params.get(k)
        if p is None:
            continue
        v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(p.shape) or v.dtype != p.dtype:
            raise ValueError(f"{k}: {v.dtype} {tuple(v.shape)} vs the parameter's {p.dtype} {tuple(p.shape)}")
        p.copy_(v)


def save_checkpoint(step_or_state, path: str, *, tmodule=None, opt_state=None) -> None:
    """Convenience: save {params, opt_state} for train-resume."""
    state = step_or_state if isinstance(step_or_state, dict) else {
        "params": {k: p.detach() for k, p in tmodule.get_parameters().items()},
        "opt_state": opt_state,
    }
    save(state, path)
