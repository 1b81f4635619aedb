"""Position-keyed temperature sampling: the port's counterpart of
thunder_tpu/serving/scheduler.py:_sample_tokens.

thunder_tpu draws the token at position p of a request with seed s from
``fold_in(PRNGKey(s), p)`` (jax's threefry), so a request's stream is the
same alone or batched, cold or after a prefix hit, chunked or whole, with or
without speculation. torch cannot reproduce threefry; the port keeps every
one of those identities with a counter-based generator of its own:

* ``philox_uniform(seeds, positions, rows)`` is Philox4x32-10 (Salmon,
  Moraes, Dror and Shaw, "Parallel random numbers: as easy as 1, 2, 3",
  SC '11) with key (seed mod 2^32, 0) and counter (position, row, 0, 0); its
  first output word x gives u = (x + 0.5) · 2^-32 in f64. It runs on the
  host in numpy: every position is known there before the step runs, so u
  is bit-identical on any device and the card does none of this work.
* ``sample_tokens(logits, u, temps)`` turns one uniform a row into a token
  by the inverse CDF of softmax(logits / T): rows with T = 0 take the argmax.
  It is plain torch and runs on the logits' device.
* ``Sampler`` runs ``draw_tokens`` (``sample_tokens`` without the margins,
  which the engine never reads) as a captured CUDA graph a row count
  (executors/graphex.py) on the card, and op by op on the CPU. On a CUDA
  tensor it runs on the card or raises: there is no other road.

The serving engine draws with row 0; ``GPTInference.generate`` draws row b
of its batch with row b, so a B=1 call (and row 0 of any batch) gives the
engine's stream for the same seed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import CompileStats
from ..executors import graphex

_MASK = np.uint64(0xFFFFFFFF)
# Philox4x32 multipliers and Weyl key increments (Salmon et al., SC '11, §4)
PHILOX_M0 = np.uint64(0xD2511F53)
PHILOX_M1 = np.uint64(0xCD9E8D57)
PHILOX_W0 = np.uint64(0x9E3779B9)
PHILOX_W1 = np.uint64(0xBB67AE85)
PHILOX_ROUNDS = 10


def philox4x32(counter, key, rounds: int = PHILOX_ROUNDS):
    """Philox4x32-``rounds`` over arrays: ``counter`` is 4 arrays of words,
    ``key`` 2; returns the 4 output words as uint64 arrays holding 32-bit
    values. Products are formed in uint64 (32 x 32 bits fit) and split into
    their high and low words."""
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) & _MASK for c in counter)
    k0, k1 = (np.asarray(k, np.uint64) & _MASK for k in key)
    for r in range(rounds):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK
            k1 = (k1 + PHILOX_W1) & _MASK
        p0 = PHILOX_M0 * c0
        p1 = PHILOX_M1 * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & _MASK,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & _MASK)
    return c0, c1, c2, c3


def philox_uniform(seeds, positions, rows) -> np.ndarray:
    """One uniform in (0, 1) for each (seed, position, row), f64: Philox's
    first word x of counter (position, row, 0, 0) under key (seed mod 2^32,
    0), as (x + 0.5) · 2^-32. Arguments broadcast against each other."""
    seeds, positions, rows = np.broadcast_arrays(np.asarray(seeds, np.uint64),
                                                 np.asarray(positions, np.int64).astype(np.uint64),
                                                 np.asarray(rows, np.int64).astype(np.uint64))
    zero = np.zeros(seeds.shape, np.uint64)
    x, _, _, _ = philox4x32((positions, rows, zero, zero), (seeds, zero))
    return (x.astype(np.float64) + 0.5) * 2.0 ** -32


def canonical_seed(seed) -> int:
    """Seeds are taken mod 2^32 (thunder_tpu's packed seed array is uint32)."""
    return int(seed) & 0xFFFFFFFF


def _inverse_cdf(x: torch.Tensor, u: torch.Tensor, temps: torch.Tensor):
    """(sampled rows, cumulative sums c, u · total, drawn tokens) of the
    inverse CDF of softmax(x / T) for f32 logits x (R, V)."""
    sampled = temps > 0
    t = torch.where(sampled, temps, torch.ones_like(temps))
    c = torch.cumsum(torch.softmax(x / t[:, None], -1).double(), -1)
    target = u * c[:, -1]
    tok = (c < target[:, None]).sum(-1).clamp_(max=c.shape[-1] - 1)
    return sampled, c, target, tok


def draw_tokens(logits: torch.Tensor, u: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """The tokens (R,) int64 of ``sample_tokens`` without their margins: the
    serving engine's draw, which reads no margin."""
    x = logits.float()
    sampled, _, _, tok = _inverse_cdf(x, u, temps)
    return torch.where(sampled, tok, torch.argmax(x, -1))


def sample_tokens(logits: torch.Tensor, u: torch.Tensor, temps: torch.Tensor):
    """(tokens (R,) int64, margins (R,) f64) for logits (R, V), u (R,) f64 in
    (0, 1) and temps (R,) f32. A row with temperature 0 takes the argmax of
    its logits (margin +inf). Another row takes the inverse CDF of
    softmax(logits.float() / T): the cumulative sum c in f64, total = c[V-1],
    and the token is the count of c below u · total (at most V - 1). Its
    margin is the distance of u · total from the nearer edge of that token's
    interval [c[tok-1], c[tok]), over the total: a change of the
    probabilities smaller than the margin cannot change the token."""
    x = logits.float()
    sampled, c, target, tok = _inverse_cdf(x, u, temps)
    hi = c.gather(1, tok[:, None])[:, 0]
    lo = c.gather(1, (tok - 1).clamp(min=0)[:, None])[:, 0]
    lo = torch.where(tok > 0, lo, torch.zeros_like(lo))
    margin = torch.minimum(target - lo, hi - target) / c[:, -1]
    return (torch.where(sampled, tok, torch.argmax(x, -1)),
            torch.where(sampled, margin, torch.full_like(margin, float("inf"))))


class Sampler:
    """``draw_tokens`` as one program a (rows, vocab, logits dtype): on the
    card a CUDA graph (its first call runs op by op, its second captures,
    later calls replay; u and temps are copied into the graph's buffers), on
    the CPU (or with ``cuda_graphs=False``) op by op. ``_cs`` counts its
    captures and replays, so ``thunder_tpu_torch.graph_captures(sampler)``
    reads them."""

    def __init__(self, device, pool=None, cuda_graphs: bool = True):
        self.device = torch.device(device)
        self.pool = pool if pool is not None else graphex.GraphPool()
        self.cuda_graphs = cuda_graphs
        self._cs = CompileStats()
        self._programs: dict = {}

    def program(self, rows: int, vocab: int, dtype: torch.dtype):
        key = (rows, vocab, dtype)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = graphex.CUDAGraphProgram(
                draw_tokens, name=f"sampler rows={rows}", in_place=[False] * 3, pool=self.pool,
                stats=self._cs)
        return prog

    def __call__(self, logits: torch.Tensor, u: np.ndarray, temps: np.ndarray):
        """The tokens on the logits' device for host arrays u and temps."""
        R, V = logits.shape
        u_d = torch.from_numpy(np.ascontiguousarray(u, np.float64)).to(logits.device)
        t_d = torch.from_numpy(np.ascontiguousarray(temps, np.float32)).to(logits.device)
        if not (self.cuda_graphs and graphex.captures_on(logits.device)):
            return draw_tokens(logits, u_d, t_d)
        return self.program(R, V, logits.dtype)(logits, u_d, t_d)

    def warmup(self, rows: int, vocab: int, dtype: torch.dtype) -> None:
        """Run and capture the program of this shape (twice: op by op, then
        the capture), so a wave that samples captures nothing."""
        logits = torch.zeros((rows, vocab), dtype=dtype, device=self.device)
        u = np.full((rows,), 0.5)
        temps = np.ones((rows,), np.float32)
        for _ in range(2):
            self(logits, u, temps)
