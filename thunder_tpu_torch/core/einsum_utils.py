"""Einsum spec parsing shared by the EINSUM prim meta and the ltorch
decomposition (single source of truth for the spec grammar).

thunder_tpu/core/einsum_utils.py, unchanged: pure Python, copied so the
port imports nothing of thunder_tpu."""
from __future__ import annotations

_EINSUM_POOL = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def expand_ellipsis(spec: str, operand_ndims: list[int]) -> tuple[list[str], str]:
    """Normalize an einsum equation: strip spaces, expand '...' into fresh
    index characters (aligned to the right, so shorter ellipses broadcast
    against the leading dims of longer ones), and infer the implicit output
    spec when '->' is absent.  Returns (per-operand specs, output spec)."""
    spec = spec.replace(" ", "")
    if "->" in spec:
        lhs, rhs = spec.split("->")
    else:
        lhs, rhs = spec, None
    in_specs = lhs.split(",")
    if len(in_specs) != len(operand_ndims):
        raise ValueError(f"einsum '{spec}': {len(operand_ndims)} operands for {len(in_specs)} specs")
    used = set(ch for ch in lhs + (rhs or "") if ch.isalpha())
    pool = [c for c in _EINSUM_POOL if c not in used]
    max_ell = 0
    for sub, nd in zip(in_specs, operand_ndims):
        if "..." in sub:
            max_ell = max(max_ell, nd - len(sub.replace("...", "")))
    ell_chars = "".join(pool[:max_ell])
    new_in = []
    for sub, nd in zip(in_specs, operand_ndims):
        if "..." in sub:
            n_ell = nd - len(sub.replace("...", ""))
            sub = sub.replace("...", ell_chars[max_ell - n_ell :] if n_ell else "")
        new_in.append(sub)
    if rhs is None:
        counts: dict[str, int] = {}
        for sub in new_in:
            for ch in sub:
                counts[ch] = counts.get(ch, 0) + 1
        rhs = ell_chars + "".join(sorted(ch for ch, n in counts.items() if n == 1 and ch not in ell_chars))
    elif "..." in rhs:
        rhs = rhs.replace("...", ell_chars)
    return new_in, rhs


def output_shape(spec: str, operand_shapes: list[tuple]) -> tuple:
    """Static output shape for an einsum equation over the given input shapes
    (broadcasting size-1 dims the way torch/np.einsum broadcast ellipses)."""
    in_specs, out_spec = expand_ellipsis(spec, [len(s) for s in operand_shapes])
    dim_of: dict[str, int] = {}
    for sub, shape in zip(in_specs, operand_shapes):
        if len(sub) != len(shape):
            raise ValueError(f"einsum '{spec}': spec '{sub}' vs rank {len(shape)}")
        for ch, d in zip(sub, shape):
            dim_of[ch] = max(dim_of.get(ch, 1), d)
    return tuple(dim_of[ch] for ch in out_spec)
