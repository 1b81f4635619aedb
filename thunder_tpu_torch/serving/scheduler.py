"""Continuous-batching scheduler: admit, prefill, decode, retire — every step.

The port of thunder_tpu/serving/scheduler.py (Orca-style iteration-level
scheduling over the paged KV pool):

* submit() enqueues a request and returns a concurrent.futures.Future.
* Each engine iteration ADMITS pending requests into free decode slots
  (FIFO; a request is admitted only when the page pool can cover its whole
  lifetime — prompt pages plus worst-case growth — so decode can never hit
  a mid-flight out-of-pages), runs one shape-BUCKETED prefill per admission
  (prompt padded to the next rung of the ``BucketLadder``), then packs ALL
  active sequences into ONE compiled decode step over the page pool and
  retires finished sequences, returning their pages immediately.

Four throughput stages compose on top of that loop, each OFF by default so
the base engine behaves exactly as before:

* prefix sharing (``prefix_sharing=True``) — admission consults a
  content-keyed ``PrefixCache`` and maps already-cached prompt pages into
  the new request's table (refcounted, copy-on-write on first divergence);
  prefill then runs only on the unshared suffix, and a fully covered
  prompt skips prefill entirely (one re-decoded token recovers the
  first-token logits).
* chunked prefill (``chunk_tokens=N``) — prompts longer than N are split
  into page-aligned chunks interleaved into decode iterations under a
  ``prefill_budget`` tokens-per-iteration cap.
* speculative decoding (``draft_gpt=...``) — a draft model proposes
  ``spec_k`` tokens per iteration; one packed target verify step scores all
  k+1 positions and the accepted prefix (capped at k — no bonus token,
  which keeps the draft KV valid) commits.
* lanes (``submit(..., lane="batch")``) — interactive requests admit
  first; an interactive request starved of pages preempts the latest
  admitted batch sequence (pages spilled, request requeued at the front of
  the batch lane), which re-prefills on resume — cheap when prefix sharing
  holds its pages in cache.

Sampling is position-keyed (serving/sampling.py): the token at position p
of a request with seed s draws its one uniform from Philox4x32-10 at
counter (p, 0) under key s, computed on the host. So every accept rule on
the path (prefix hit, speculative verify, preemption and resume) is exact,
and a request's stream is the one it produces alone
(inference.GPTInference.generate with the same seed). thunder_tpu keys the
same draws with jax's threefry, which torch cannot reproduce, so sampled
streams are the port's own; greedy ones (temperature 0) are thunder_tpu's.
A batch whose requests are all greedy takes the argmax and runs no sampler.
``quantize="int8"`` serves int8 weights (runner.quantize_for_serving).

``slo=SLOPolicy(...)`` stamps each retired request's ``slo_met``, feeds an
SLOMonitor (observability/slo.py) and, while a target burns and interactive
requests wait, sheds one batch-lane sequence an iteration. With the bus on
(observability.enable) the engine counts its traffic as ``serve.*``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..compile_service.buckets import BucketLadder
from ..core.devices import resolve_device
from ..executors.graphex import GraphPool
from ..observability import events as _obs
from ..observability import metrics as _obs_metrics
from ..observability.slo import SLOMonitor, SLOPolicy
from .kv_pages import PagedKVCache, PrefixCache
from .runner import PagedGPTRunner, quantize_for_serving
from .sampling import Sampler, canonical_seed, philox_uniform


@dataclass
class RequestResult:
    """What a request's Future resolves to."""

    request_id: int
    tokens: np.ndarray          # prompt + generated, (prompt_len + n_new,)
    new_tokens: np.ndarray      # generated only, (n_new,)
    ttft_s: float               # submit -> first token
    tbot_s: float               # mean time between output tokens
    n_new_tokens: int = 0
    finish_reason: str = "length"   # "length" | "eos" | "cancelled"
    # per-request SLO-met flag stamped at retirement when the engine has an
    # SLOPolicy (the goodput numerator); None without a policy
    slo_met: Optional[bool] = None


@dataclass
class _Request:
    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    seed: int
    eos_id: Optional[int]
    future: Future
    t_submit: float
    lane: str = "interactive"
    t_first: float = 0.0
    t_last: float = 0.0
    tokens: List[int] = field(default_factory=list)
    pages: List[int] = field(default_factory=list)
    bucket: int = 0
    # admission-time routing state (set by _reserve_pages each admission —
    # a preempted request is re-routed from scratch on resume)
    admit_seq: int = -1          # monotone admission order (preemption victims)
    admit_mode: str = ""         # "prefill" | "chunk" | "hit"
    prompt_eff: Optional[np.ndarray] = None  # prompt (+ committed tokens on resume)
    covered: int = 0             # prefix-cache token coverage of prompt_eff
    n_shared: int = 0            # leading shared pages in .pages
    chunk_pos: int = -1          # next chunk start (chunk mode only)


class ServingEngine:
    """Continuous-batching inference over a models.litgpt.GPT or a
    models.moe.MoEGPT.

    max_batch   decode slots (sequences packed into one decode step)
    page_size   tokens per KV page
    n_pages     pool size per layer (default: full residency for max_batch
                sequences of max_seq tokens, plus the reserved null page)
    max_seq     per-sequence length cap (prompt + generated)
    device      where the pools live and the programs run: the card unless
                named (raises without one); the models must be there too

    Throughput stages (all off by default; see the module docstring):

    prefix_sharing  consult/populate a content-keyed PrefixCache at admission
    chunk_tokens    split prompts longer than this into page-aligned chunks
                    (default max_seq: whole-prompt prefill, never chunked
                    unless a prefix hit leaves an unshared suffix)
    prefill_budget  chunk-prefill tokens per engine iteration (default
                    chunk_tokens: one chunk per iteration)
    draft_gpt       draft model for speculative decoding (same vocab; its
                    KV pool shares the target allocator page for page)
    spec_k          draft tokens proposed per iteration (default 4 with a
                    draft, 0 without)
    preemption      allow spilling batch-lane sequences for a page-starved
                    interactive admission or while an SLO target burns (on;
                    only bites with lanes in use)
    quantize        weight-only quantization applied to ``gpt`` in place
                    before tracing: None/"none" or "int8"
    cuda_graphs     run every program on the card as a CUDA graph (the
                    default; the counterpart of thunder_tpu's XLA programs),
                    the target's, the draft's and the sampler's in one graph
                    memory pool; ``warmup`` captures them before a wave
    slo             an observability.SLOPolicy: per-request SLO-met flags,
                    goodput, an SLOMonitor and burn-rate preemption
    """

    def __init__(self, gpt, *, max_batch: int = 8, page_size: int = 16,
                 n_pages: Optional[int] = None, max_seq: Optional[int] = None,
                 dtype=torch.bfloat16, min_bucket: Optional[int] = None, device=None,
                 slo: Optional[SLOPolicy] = None, prefix_sharing: bool = False,
                 chunk_tokens: Optional[int] = None, prefill_budget: Optional[int] = None,
                 draft_gpt=None, spec_k: Optional[int] = None, preemption: bool = True,
                 quantize: Optional[str] = None, cuda_graphs: bool = True):
        if slo is not None and not isinstance(slo, SLOPolicy):
            raise TypeError(f"ServingEngine(slo=...) takes an observability.SLOPolicy, "
                            f"got {type(slo).__name__}")
        # weight-only quantization must precede BOTH the program tracing and
        # the named_parameters snapshot below (runner.quantize_for_serving)
        gpt = quantize_for_serving(gpt, quantize)
        cfg = gpt.cfg
        self.device = resolve_device(device)
        if gpt.device != self.device:
            raise ValueError(f"the model is on {gpt.device}, the engine on {self.device}")
        self.gpt = gpt
        self.cfg = cfg
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_seq = max_seq or cfg.block_size
        rope_rows = gpt.cos.shape[0]
        if self.max_seq > rope_rows:
            raise ValueError(
                f"max_seq={self.max_seq} exceeds the model's rope cache "
                f"({rope_rows} positions); build the GPT with a larger block_size")
        if self.max_seq % page_size:
            raise ValueError(f"max_seq={self.max_seq} must be a multiple of "
                             f"page_size={page_size}")
        self.n_pages_max = self.max_seq // page_size  # page-table width
        if n_pages is None:
            n_pages = 1 + max_batch * self.n_pages_max
        self.min_bucket = max(page_size, min_bucket or page_size)
        self.ladder = BucketLadder(self.min_bucket, self.max_seq, page_size=page_size)
        self.dtype = dtype

        if chunk_tokens is None:
            chunk_tokens = self.max_seq
        if chunk_tokens % page_size or not (self.min_bucket <= chunk_tokens <= self.max_seq):
            raise ValueError(
                f"chunk_tokens={chunk_tokens} must be a page-aligned length "
                f"in [{self.min_bucket}, {self.max_seq}]")
        self.chunk_tokens = chunk_tokens
        # final (short) chunks round on a capped child of the SAME ladder,
        # so chunk programs specialize over strictly fewer rungs
        self.chunk_ladder = self.ladder.subladder(chunk_tokens)
        self.prefill_budget = prefill_budget or chunk_tokens
        if self.prefill_budget < page_size:
            raise ValueError(f"prefill_budget={self.prefill_budget} must be "
                             f">= page_size={page_size}")
        self.preemption = preemption

        self.cache = PagedKVCache(cfg.n_layer, n_pages, page_size, cfg.n_query_groups,
                                  cfg.head_size, dtype, self.device)
        pool = GraphPool()
        self.runner = PagedGPTRunner(gpt, page_size=page_size, cuda_graphs=cuda_graphs, graph_pool=pool)
        # position-keyed temperature sampling: one captured program a row
        # count; an all-greedy batch never calls it
        self.sampler = Sampler(self.device, pool, cuda_graphs=cuda_graphs)
        # the Parameters themselves: a CUDA graph reads them in place
        self.params = dict(gpt.named_parameters())
        self.prefix = PrefixCache(self.cache.allocator, page_size) if prefix_sharing else None

        self.draft_gpt = draft_gpt
        self.spec_k = int(spec_k) if spec_k is not None else (4 if draft_gpt is not None else 0)
        if self.spec_k < 0:
            raise ValueError(f"spec_k={self.spec_k} must be >= 0")
        if self.spec_k and draft_gpt is None:
            raise ValueError("spec_k > 0 requires a draft_gpt")
        self.draft_cache = self.draft_runner = self.draft_params = None
        if draft_gpt is not None:
            dcfg = draft_gpt.cfg
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(f"draft vocab_size={dcfg.vocab_size} != target "
                                 f"vocab_size={cfg.vocab_size}")
            if draft_gpt.cos.shape[0] < self.max_seq:
                raise ValueError(f"draft rope cache ({draft_gpt.cos.shape[0]} positions) "
                                 f"shorter than max_seq={self.max_seq}")
            if draft_gpt.device != self.device:
                raise ValueError(f"the draft is on {draft_gpt.device}, the engine on {self.device}")
            # the draft pool SHARES the target allocator: one allocation and
            # one page table cover both models, so sharing/CoW/preemption
            # bookkeeping never runs twice
            self.draft_cache = PagedKVCache(dcfg.n_layer, n_pages, page_size,
                                            dcfg.n_query_groups, dcfg.head_size, dtype,
                                            self.device, allocator=self.cache.allocator)
            self.draft_runner = PagedGPTRunner(draft_gpt, page_size=page_size, cuda_graphs=cuda_graphs,
                                               graph_pool=pool)
            self.draft_params = dict(draft_gpt.named_parameters())

        # host-side packed decode state; pos/toks change every step and are
        # re-uploaded, the page tables only at (un)assignment; seeds and
        # temperatures stay on the host, where the sampler's uniforms are drawn
        self._page_tables = np.zeros((max_batch, self.n_pages_max), np.int32)
        self._pos = np.zeros((max_batch,), np.int32)
        self._toks = np.zeros((max_batch,), np.int32)
        self._seeds = np.zeros((max_batch,), np.uint32)
        self._temps = np.zeros((max_batch,), np.float32)
        self._pt_dev = None
        self._pt_dirty = True
        self._slots: List[Optional[_Request]] = [None] * max_batch

        self._pending: deque = deque()        # interactive lane (admits first)
        self._pending_batch: deque = deque()  # batch lane (preemptible)
        self._chunking: Dict[int, _Request] = {}  # slot -> mid-chunk-prefill
        self._admit_counter = 0
        self._lock = threading.Lock()
        self._next_id = 0
        # submitted-but-unresolved count: drain() keys off this rather than
        # scanning pending+slots, which is momentarily EMPTY between a pop
        # from the queue and the slot assignment
        self._outstanding = 0
        self._stopped = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decode_steps = 0
        self.chunk_calls = 0      # chunk programs run (target model)
        self.verify_calls = 0     # verify programs run
        self.peak_pages_in_use = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.preempted = 0
        self.resumed = 0

        # SLO accounting (observability/slo.py): a policy gets a sliding-window
        # monitor and per-request SLO-met flags at retirement; without one
        # the retirement path pays one `is None` test
        self.slo_policy = slo
        self.slo_monitor = SLOMonitor(slo, source="serving") if slo is not None else None
        self.requests_retired = 0       # non-cancelled retirements
        self.requests_slo_met = 0

    # -- public API -------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32, *, temperature: float = 0.0,
               seed: Optional[int] = None, eos_id: Optional[int] = None,
               lane: str = "interactive") -> Future:
        """Enqueue one generation request; thread-safe. The Future resolves
        to a RequestResult (or a ValueError for an inadmissible request).
        temperature 0 decodes greedily; above 0 the token at position p
        draws from seed's Philox stream at p (``seed`` mod 2^32, the request
        id when None). lane="interactive" admits ahead of lane="batch";
        batch sequences may be preempted (spilled and later resumed, stream
        unchanged) when an interactive request is page-starved or the SLO
        budget is burning."""
        fut: Future = Future()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        if lane not in ("interactive", "batch"):
            fut.set_exception(ValueError(
                f"request {rid}: lane={lane!r} must be 'interactive' or 'batch'"))
            return fut
        L = int(prompt.shape[0])
        worst = self._pages_needed(L, max_new_tokens)
        usable = self.cache.n_pages - 1
        if L < 1 or L + max_new_tokens > self.max_seq or max_new_tokens < 1:
            fut.set_exception(ValueError(
                f"request {rid}: prompt_len={L} + max_new_tokens={max_new_tokens} "
                f"must fit max_seq={self.max_seq} (and both be >= 1)"))
            return fut
        if worst > usable:
            fut.set_exception(ValueError(
                f"request {rid}: needs {worst} pages, pool has {usable}"))
            return fut
        if not temperature >= 0.0:
            fut.set_exception(ValueError(f"request {rid}: temperature={temperature} must be >= 0"))
            return fut
        req = _Request(rid, prompt, max_new_tokens, float(temperature),
                       canonical_seed(seed if seed is not None else rid), eos_id, fut,
                       time.perf_counter(), lane=lane)
        with self._lock:
            if self._stopped:
                fut.set_exception(RuntimeError("serving engine stopped"))
                return fut
            (self._pending if lane == "interactive" else self._pending_batch).append(req)
            self._outstanding += 1
        if _obs.enabled():
            _obs_metrics.record_serve("requests")
        return fut

    def start(self) -> None:
        """Run the scheduling loop on a background thread."""
        if self._thread is not None:
            return
        with self._lock:
            self._stopped = False
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="tt-serving", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = False) -> None:
        """Stop the loop thread. drain=True finishes outstanding requests
        first; otherwise every in-flight, mid-chunk and pending Future (both
        lanes) is FAILED, with its pages returned."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            self._stop.clear()
            self.drain()
            self._stop.set()
        exc = RuntimeError("serving engine stopped")
        for i, req in enumerate(self._slots):
            if req is not None:
                self._fail(req, exc)
                self._clear_slot(i)
        for req in list(self._chunking.values()):
            self._fail(req, exc)
        self._chunking.clear()
        with self._lock:
            self._stopped = True
            pending = list(self._pending) + list(self._pending_batch)
            self._pending = deque()
            self._pending_batch = deque()
        for req in pending:
            self._fail(req, exc)

    def drain(self) -> None:
        """Block until every submitted request resolved. With the background
        thread running this only waits; without it, the loop runs inline."""
        if self._thread is not None:
            while self._outstanding > 0:
                time.sleep(1e-3)
            return
        while self._outstanding > 0:
            self._step_once()

    def warmup(self, prompt_lens, max_new_tokens: int = 2) -> None:
        """Compile, and on the card capture, every program a wave of these
        prompt lengths runs (thunder_tpu's warmup submits one request a
        length; here a program's first call compiles and its second
        captures, which requests alone would not reach for a bucket one
        request uses). Each program is called twice on the null page, whose
        slots no sequence reads: the prefill bucket of each length, with
        chunking or prefix sharing every chunk rung, the decode program
        (with a draft: the draft's decode and the verify program), the
        draft's prefill and chunk programs. Then one request a length runs
        through the scheduler, as in thunder_tpu. A wave after it compiles
        and captures nothing."""
        ps, npm, B = self.page_size, self.n_pages_max, self.max_batch
        # every input its own tensor: inputs that share storage would key
        # another specialization than the wave's
        zeros = lambda *shape: self._tensor(np.zeros(shape, np.int32))  # noqa: E731
        runners = [(self.runner, self.params, self.cache)]
        if self.draft_runner is not None:
            runners.append((self.draft_runner, self.draft_params, self.draft_cache))
        buckets = sorted({self.ladder.bucket_for(int(L)) for L in prompt_lens})
        chunks = self.chunk_ladder.rungs if (self.chunk_tokens < self.max_seq or self.prefix is not None) else ()
        sampled = set()  # (rows, vocab, dtype) of every sampler program a sampled wave runs
        for _ in range(2):
            for i, (runner, params, cache) in enumerate(runners):
                calls = [(runner.prefill_cfn, (zeros(1, b), zeros(b // ps)), (self._scalar(0),)) for b in buckets]
                calls += [(runner.chunk_cfn, (zeros(1, c), zeros(1, npm)), (self._scalar(0), self._scalar(0)))
                          for c in chunks]
                if self.spec_k and i == 0:
                    calls.append((runner.verify_cfn, (zeros(B, self.spec_k + 1),), (zeros(B, npm), zeros(B))))
                elif self.spec_k or i == 0:
                    calls.append((runner.decode_cfn, (zeros(B, 1),), (zeros(B, npm), zeros(B))))
                for cfn, head, tail in calls:
                    logits, kps, vps = cfn(params, *head, cache.k_pages, cache.v_pages, *tail)
                    cache.rebind(kps, vps)
                    if i == 0 or cfn is runner.decode_cfn:
                        # the draft's prefill and chunk logits are never sampled
                        sampled.add((logits.shape[:-1].numel(), logits.shape[-1], logits.dtype))
        for rows, vocab, dtype in sorted(sampled, key=str):
            self.sampler.warmup(rows, vocab, dtype)
        for L in prompt_lens:
            self.submit(np.zeros((int(L),), np.int32), max_new_tokens)
        self.drain()

    def stats(self) -> dict:
        usable = self.cache.n_pages - 1
        out = {
            "pages_in_use": self.cache.allocator.n_used,
            "page_pool_utilization": round(self.cache.utilization(), 4),
            "peak_page_pool_utilization": round(self.peak_pages_in_use / usable, 4)
            if usable else 0.0,
            "page_fragmentation": round(self.page_fragmentation(), 4),
            "active": sum(1 for s in self._slots if s is not None),
            "pending": len(self._pending) + len(self._pending_batch),
            "chunking": len(self._chunking),
            "decode_steps": self.decode_steps,
            "chunk_calls": self.chunk_calls,
            "verify_calls": self.verify_calls,
            "prefill_buckets": self.ladder.mru(),
            "bucket_hits": self.ladder.hits(),
            "prefix_hits": self.prefix_hits,
            "prefix_tokens_saved": self.prefix_tokens_saved,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "preempted": self.preempted,
            "resumed": self.resumed,
        }
        if self.prefix is not None:
            out["prefix_cache_pages"] = len(self.prefix)
        if self.slo_policy is not None:
            out["requests_retired"] = self.requests_retired
            out["requests_slo_met"] = self.requests_slo_met
            out["goodput"] = (round(self.requests_slo_met / self.requests_retired, 4)
                              if self.requests_retired else None)
            out["slo"] = self.slo_monitor.status()
        return out

    def goodput(self) -> Optional[float]:
        """Cumulative fraction of retired (non-cancelled) requests whose
        SLO-met flag was True; None without a policy or before the first
        retirement (the SLOMonitor keeps a sliding-window goodput besides)."""
        if self.slo_policy is None or not self.requests_retired:
            return None
        return self.requests_slo_met / self.requests_retired

    def reset_slo_accounting(self) -> None:
        """Zero the goodput counters and restart the sliding-window monitor
        (same policy): called after warmup so its traffic counts nowhere."""
        self.requests_retired = 0
        self.requests_slo_met = 0
        if self.slo_policy is not None:
            self.slo_monitor = SLOMonitor(self.slo_policy, source="serving")

    def page_fragmentation(self) -> float:
        """Internal fragmentation of the page pool: the fraction of
        allocated page capacity NOT holding resident tokens (worst-case
        lifetime reservation means early in a long generation most of a
        request's pages are air)."""
        n_used = self.cache.allocator.n_used
        if not n_used:
            return 0.0
        resident = 0
        for req in list(self._slots):  # lock-free: a torn read skews one sample
            if req is None:
                continue
            prompt = req.prompt_eff if req.prompt_eff is not None else req.prompt
            resident += len(prompt) + len(req.tokens)
        return max(0.0, min(1.0, 1.0 - resident / (n_used * self.page_size)))

    # -- scheduling loop --------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._outstanding == 0:
                time.sleep(1e-3)
                continue
            try:
                self._step_once()
            except Exception as e:  # pragma: no cover - scheduler-bug net
                # per-request failures are contained in _prefill/_decode;
                # anything reaching here is a scheduler bug — keep the
                # thread alive for other requests rather than hang them
                import warnings

                warnings.warn(f"serving loop error (contained): {e!r}")
                time.sleep(1e-2)

    def _pages_needed(self, L: int, max_new: int) -> int:
        """Worst-case pages over the request lifetime: the bucketed prefill
        writes bucket//page_size pages, growth extends to L+max_new tokens."""
        bucket = self.ladder.bucket_for(L)
        return max(bucket // self.page_size, PagedKVCache.pages_for(L + max_new, self.page_size))

    def _step_once(self) -> None:
        self._maybe_preempt_for_slo()
        self._admit()
        self._advance_prefills()
        self._decode()

    def _admit(self) -> None:
        while True:
            free_slots = [i for i, s in enumerate(self._slots)
                          if s is None and i not in self._chunking]
            if not free_slots:
                return
            req = queue = None
            with self._lock:
                for q in (self._pending, self._pending_batch):
                    while q and q[0].future.cancelled():
                        # cancelled while queued: drop before allocating (a
                        # preempted victim's pages were already spilled)
                        q.popleft()
                        self._outstanding -= 1
                    if req is None and q:
                        req, queue = q[0], q
            if req is None:
                return
            if not self._reserve_pages(req):
                # head of line within the lane pair: interactive starvation
                # may evict batch-lane victims; otherwise wait for retirements
                if req.lane == "interactive" and self.preemption and self._preempt_one():
                    continue
                return
            with self._lock:
                queue.popleft()
            self.peak_pages_in_use = max(self.peak_pages_in_use, self.cache.allocator.n_used)
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            if req.admit_mode == "hit":
                self._admit_hit(req, free_slots[0])
            elif req.admit_mode == "chunk":
                self._start_chunk(req, free_slots[0])
            else:
                self._prefill(req, free_slots[0])

    def _reserve_pages(self, req: _Request) -> bool:
        """Route one request (prefix hit / chunked / whole-prompt prefill)
        and reserve its worst-case pages: shared pages come from the prefix
        cache (already incref'd by match), private ones from the free-list.
        On shortage every side effect is undone and False is returned — the
        request stays at its queue head."""
        ps = self.page_size
        resumed = bool(req.tokens)
        # a resumed victim re-prefills prompt + all-but-the-last committed
        # token: the last one re-enters decode exactly where the spill cut it
        prompt_eff = (req.prompt if not resumed else
                      np.concatenate([req.prompt, np.asarray(req.tokens[:-1], np.int32)]))
        L_eff = len(prompt_eff)
        lifetime = PagedKVCache.pages_for(len(req.prompt) + req.max_new_tokens, ps)
        shared: List[int] = []
        covered = 0
        if self.prefix is not None:
            shared, covered = self.prefix.match(prompt_eff)
        n_shared = len(shared)
        if covered == L_eff and n_shared:
            # full coverage: no prefill at all. The first decode step
            # re-writes position L_eff-1 (the copy-on-write trigger) and
            # recovers the first-token logits; a resumed victim needs no
            # logits, only a CoW fork if its next write lands in the shared
            # tail page.
            fork_n = 0 if (resumed and L_eff % ps == 0) else 1
            priv = lifetime - n_shared
            mode = "hit"
        elif covered > 0 or L_eff > self.chunk_tokens:
            end = self._final_chunk_end(L_eff, covered)
            priv = max(lifetime, end // ps) - n_shared
            fork_n = 0
            mode = "chunk"
        else:
            priv = max(lifetime, self.ladder.bucket_for(L_eff) // ps)
            fork_n = 0
            mode = "prefill"
        need = priv + fork_n
        if not self.cache.allocator.can_alloc(need):
            # cache-only pages are reclaimable: evicting them drops the
            # cache's reference, never a live sequence's (or ours — the
            # matched pages above hold our incref and survive eviction)
            if self.prefix is not None:
                self.prefix.evict_until(need)
            if not self.cache.allocator.can_alloc(need):
                if shared:
                    self.cache.allocator.free(shared)
                return False
        req.prompt_eff = prompt_eff
        req.covered = covered
        req.n_shared = n_shared
        req.admit_mode = mode
        req.pages = shared + (self.cache.allocator.alloc(priv) if priv else [])
        return True

    def _final_chunk_end(self, L_eff: int, covered: int) -> int:
        """Absolute end of the final chunk's page write-out: intermediate
        chunks are exactly chunk_tokens, the final one rounds up on the
        capped chunk ladder — unless that rung would cross max_seq (and so
        the rope table and the page table), in which case it falls back to
        the exact page-aligned remainder."""
        C = self.chunk_tokens
        s = covered + ((L_eff - covered - 1) // C) * C
        rung = self.chunk_ladder.bucket_for(L_eff - s)
        if s + rung > self.max_seq:
            rung = PagedKVCache.pages_for(L_eff - s, self.page_size) * self.page_size
        return s + rung

    def _admit_hit(self, req: _Request, slot: int) -> None:
        """Admit a fully prefix-covered request without running prefill."""
        ps = self.page_size
        resumed = bool(req.tokens)
        L_eff = len(req.prompt_eff)
        if not (resumed and L_eff % ps == 0):
            # the first write (position L_eff-1 fresh, L_eff resumed) lands
            # in the last shared page: detach it now, before the decode step
            # that writes it. fork() only pays the copy when other owners
            # remain; the draft pool shares the page ids, so it copies too.
            old = req.pages[req.n_shared - 1]
            new = self.cache.allocator.fork(old)
            if new != old:
                self.cache.copy_page(old, new)
                if self.draft_cache is not None:
                    self.draft_cache.copy_page(old, new)
                req.pages[req.n_shared - 1] = new
        saved = L_eff if resumed else L_eff - 1
        self.prefix_hits += 1
        self.prefix_tokens_saved += saved
        if _obs.enabled():
            _obs_metrics.record_serve("prefix_hits")
            _obs_metrics.record_serve("prefix_tokens_saved", delta=saved)
        if resumed:
            self._on_resume(req)
            self._activate(req, slot, pos=L_eff, tok=req.tokens[-1])
        else:
            # t_first stays 0.0: TTFT is stamped when the first token
            # commits in decode (the re-decoded prompt token is not output)
            self._activate(req, slot, pos=L_eff - 1, tok=int(req.prompt_eff[-1]))

    def _start_chunk(self, req: _Request, slot: int) -> None:
        """Reserve a slot for chunked prefill; chunks run under the
        per-iteration token budget in _advance_prefills."""
        req.chunk_pos = req.covered
        if req.covered:
            self.prefix_hits += 1
            self.prefix_tokens_saved += req.covered
            if _obs.enabled():
                _obs_metrics.record_serve("prefix_hits")
                _obs_metrics.record_serve("prefix_tokens_saved", delta=req.covered)
        self._chunking[slot] = req

    def _on_resume(self, req: _Request) -> None:
        self.resumed += 1
        if _obs.enabled():
            _obs_metrics.record_serve("resumed", event=True, request=req.request_id,
                                      n_tokens=len(req.tokens))

    def _preempt_one(self) -> bool:
        """Spill the most recently admitted batch-lane sequence: free its
        pages (shared ones just decref — the prefix cache keeps them warm)
        and requeue it at the FRONT of the batch lane for resume."""
        victim = None
        for i, r in enumerate(self._slots):
            if (r is not None and r.lane == "batch"
                    and (victim is None or r.admit_seq > self._slots[victim].admit_seq)):
                victim = i
        if victim is None:
            return False
        req = self._slots[victim]
        self.cache.allocator.free(req.pages)
        req.pages = []
        self._clear_slot(victim)
        with self._lock:
            self._pending_batch.appendleft(req)
        self.preempted += 1
        if _obs.enabled():
            _obs_metrics.record_serve("preempted", event=True, request=req.request_id,
                                      n_tokens=len(req.tokens))
        return True

    def _maybe_preempt_for_slo(self) -> None:
        """Burn-rate preemption: while the SLO monitor reports a breached or
        burning target and interactive requests wait, shed one batch-lane
        sequence an iteration to shorten the interactive path."""
        if not self.preemption or self.slo_monitor is None or not self._pending:
            return
        status = self.slo_monitor.status()
        burning = bool(status.get("breached")) or any(
            t.get("burn_rate") is not None and t["burn_rate"] >= 1.0
            for t in status.get("targets", {}).values())
        if burning:
            self._preempt_one()

    def _fail(self, req: _Request, exc: Exception) -> None:
        """Contain one request's failure: return its pages, fail its Future,
        keep the engine alive."""
        if req.pages:
            self.cache.allocator.free(req.pages)
            req.pages = []
        try:
            req.future.set_exception(exc)
        except InvalidStateError:
            pass  # the caller's cancel() raced the done() window
        with self._lock:
            self._outstanding -= 1
        if _obs.enabled():
            _obs_metrics.record_serve("failed", event=True, request=req.request_id,
                                      error=type(exc).__name__)

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _scalar(self, x: int) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.int32, device=self.device)

    def _first_token(self, req: _Request, logits, pos: int) -> int:
        """The first generated token from a prefill's (1, V) logits: its
        argmax, or with a temperature the sampler's draw at ``pos`` (the
        prompt's length, the position the token takes)."""
        if req.temperature <= 0.0:
            return int(torch.argmax(logits[0]))
        u = philox_uniform([req.seed], [pos], 0)
        return int(self.sampler(logits, u, np.asarray([req.temperature], np.float32))[0])

    def _prefill(self, req: _Request, slot: int) -> None:
        obs_on = _obs.enabled()
        resumed = bool(req.tokens)
        prompt_eff = req.prompt_eff if req.prompt_eff is not None else req.prompt
        L = len(prompt_eff)
        bucket = self.ladder.touch(L)
        req.bucket = bucket
        idx = np.zeros((1, bucket), np.int32)
        idx[0, :L] = prompt_eff
        t0 = time.perf_counter()
        try:
            idx_d = self._tensor(idx)
            page_ids = torch.tensor(req.pages[:bucket // self.page_size], dtype=torch.int32,
                                    device=self.device)
            last = self._scalar(L - 1)
            logits, kps, vps = self.runner.prefill_cfn(
                self.params, idx_d, page_ids, self.cache.k_pages, self.cache.v_pages, last)
            self.cache.rebind(kps, vps)
            if self.draft_cache is not None:
                # the draft pool must hold the prompt too — same pages, same
                # positions, draft weights (logits discarded)
                _, dkps, dvps = self.draft_runner.prefill_cfn(
                    self.draft_params, idx_d, page_ids, self.draft_cache.k_pages,
                    self.draft_cache.v_pages, last)
                self.draft_cache.rebind(dkps, dvps)
            if not resumed:
                tok0 = self._first_token(req, logits, L)
        except Exception as e:
            self._fail(req, e)
            return
        if self.prefix is not None:
            self.prefix.insert(prompt_eff, req.pages)
        t_done = time.perf_counter()
        if obs_on:
            _obs_metrics.record_serve("prefills", event=True, request=req.request_id, bucket=bucket,
                                      prompt_len=L, ms=round((t_done - t0) * 1e3, 3),
                                      pool_utilization=round(self.cache.utilization(), 4))
            _obs_metrics.record_serve("prefill_tokens", delta=L)
        if resumed:
            # the spilled stream already owns its next token (and t_first
            # keeps the first life's stamp — TTFT is end to end)
            self._on_resume(req)
            self._activate(req, slot, pos=L, tok=req.tokens[-1])
            return
        req.t_first = req.t_last = t_done
        req.tokens.append(tok0)
        if self._finished(req, tok0):
            self._retire(req)
            return
        self._activate(req, slot, pos=L, tok=tok0)

    def _advance_prefills(self) -> None:
        """Run queued prefill chunks under the per-iteration token budget.
        At least one chunk always runs when any is pending (progress even
        when a single chunk exceeds the budget); chunks from several
        requests share the budget in slot order."""
        if not self._chunking:
            return
        spent = 0
        for slot in sorted(self._chunking):
            req = self._chunking[slot]
            while spent < self.prefill_budget:
                try:
                    n_toks, logits = self._run_chunk(req)
                except Exception as e:
                    del self._chunking[slot]
                    self._fail(req, e)
                    break
                spent += n_toks
                if req.chunk_pos >= len(req.prompt_eff):
                    del self._chunking[slot]
                    self._finish_chunked(req, slot, logits)
                    break
            if spent >= self.prefill_budget:
                return

    def _run_chunk(self, req: _Request):
        """One page-aligned chunk of req's effective prompt: write its K/V
        pages, attend everything written so far (shared prefix pages
        included). Returns (tokens_spent, logits) — logits only meaningful
        when this was the final chunk."""
        ps = self.page_size
        L_eff = len(req.prompt_eff)
        start = req.chunk_pos
        remaining = L_eff - start
        if remaining > self.chunk_tokens:
            cb = self.chunk_tokens
            last_rel = cb - 1  # logits discarded; any in-range index works
        else:
            cb = self.chunk_ladder.touch(remaining)
            if start + cb > self.max_seq:
                # the rounded rung would cross max_seq (the rope table and
                # the page table, whose slice would clamp and move the write):
                # fall back to the exact page-aligned remainder
                cb = PagedKVCache.pages_for(remaining, ps) * ps
            last_rel = remaining - 1
        idx = np.zeros((1, cb), np.int32)
        n_real = min(cb, remaining)
        idx[0, :n_real] = req.prompt_eff[start:start + n_real]
        idx_d = self._tensor(idx)
        row = self._tensor(self.cache.page_table_row(req.pages, self.n_pages_max)[None, :])
        start_d, last_d = self._scalar(start), self._scalar(last_rel)
        logits, kps, vps = self.runner.chunk_cfn(
            self.params, idx_d, row, self.cache.k_pages, self.cache.v_pages, start_d, last_d)
        self.cache.rebind(kps, vps)
        self.chunk_calls += 1
        if self.draft_cache is not None:
            _, dkps, dvps = self.draft_runner.chunk_cfn(
                self.draft_params, idx_d, row, self.draft_cache.k_pages,
                self.draft_cache.v_pages, start_d, last_d)
            self.draft_cache.rebind(dkps, dvps)
        req.chunk_pos = min(start + cb, L_eff)
        if _obs.enabled():
            _obs_metrics.record_serve("prefill_tokens", delta=n_real)
        return cb, logits

    def _finish_chunked(self, req: _Request, slot: int, logits) -> None:
        """Final chunk done: register the prompt's full pages in the prefix
        cache, take the first token (fresh requests), activate the slot."""
        L_eff = len(req.prompt_eff)
        req.bucket = self.ladder.bucket_for(L_eff)
        if self.prefix is not None:
            self.prefix.insert(req.prompt_eff, req.pages)
        if _obs.enabled():
            _obs_metrics.record_serve("prefills", event=True, request=req.request_id, bucket=req.bucket,
                                      prompt_len=L_eff, chunked=True,
                                      pool_utilization=round(self.cache.utilization(), 4))
        if req.tokens:
            self._on_resume(req)
            self._activate(req, slot, pos=L_eff, tok=req.tokens[-1])
            return
        try:
            tok0 = self._first_token(req, logits, L_eff)
        except Exception as e:
            self._fail(req, e)
            return
        req.t_first = req.t_last = time.perf_counter()
        req.tokens.append(tok0)
        if self._finished(req, tok0):
            self._retire(req)
            return
        self._activate(req, slot, pos=L_eff, tok=tok0)

    def _activate(self, req: _Request, slot: int, *, pos: int, tok: int) -> None:
        self._slots[slot] = req
        self._page_tables[slot] = self.cache.page_table_row(req.pages, self.n_pages_max)
        self._pos[slot] = pos
        self._toks[slot] = tok
        self._seeds[slot] = req.seed
        self._temps[slot] = req.temperature
        self._pt_dirty = True

    def _clear_slot(self, i: int) -> None:
        self._slots[i] = None
        self._page_tables[i] = 0
        self._pos[i] = 0
        self._toks[i] = 0
        self._seeds[i] = 0
        self._temps[i] = 0.0
        self._pt_dirty = True

    def _upload_page_tables(self) -> None:
        # page tables only change at slot (un)assignment; re-upload them
        # then, not per token (pos/toks change every step)
        if self._pt_dirty:
            self._pt_dev = self._tensor(self._page_tables)
            self._pt_dirty = False

    def _commit(self, i: int, req: _Request, tok: int, t_now: float) -> bool:
        """Commit one generated token to slot i; returns False when the
        request finished (retired, slot cleared)."""
        if req.t_first == 0.0:
            # prefix-hit admissions skip prefill: TTFT stamps at the first
            # committed token instead
            req.t_first = t_now
        req.tokens.append(tok)
        req.t_last = t_now
        self._pos[i] += 1
        self._toks[i] = tok
        if self._finished(req, tok):
            self._retire(req)
            self._clear_slot(i)
            return False
        return True

    def _decode(self) -> None:
        if self.draft_cache is not None and self.spec_k > 0:
            self._spec_decode()
            return
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return
        self._upload_page_tables()
        try:
            logits, kps, vps = self.runner.decode_cfn(
                self.params, self._tensor(self._toks[:, None]), self.cache.k_pages,
                self.cache.v_pages, self._pt_dev, self._tensor(self._pos))
            self.cache.rebind(kps, vps)
            if self._temps.any():
                # the NEXT token's position is pos+1 (this step wrote pos)
                nxt = self.sampler(logits, philox_uniform(self._seeds, self._pos + 1, 0),
                                   self._temps).cpu().numpy()
            else:
                nxt = torch.argmax(logits, -1).cpu().numpy()
        except Exception as e:
            # the packed step failed: every active sequence is implicated
            for i in active:
                self._fail(self._slots[i], e)
                self._clear_slot(i)
            return
        t_now = time.perf_counter()
        self.decode_steps += 1
        if _obs.enabled():
            _obs_metrics.record_serve("decode_steps")
            _obs_metrics.record_serve("tokens", delta=len(active))
        for i in active:
            self._commit(i, self._slots[i], int(nxt[i]), t_now)

    def _spec_decode(self) -> None:
        """Speculative decode iteration: k draft decode steps propose, one
        packed target verify step scores all k+1 positions, the accepted
        prefix commits (capped at k — NO bonus token, which is what keeps
        the draft pool valid through the new position without a catch-up
        pass). The draft proposes with the same position-keyed draws (draft
        step j at base_pos + j), and the verify step draws its k+1 positions
        at base_pos + 1 ... base_pos + k + 1, so a proposal is accepted
        while it equals the target's own draw. The proposals stay on the
        card until the verify step's tokens come back (every uniform is
        drawn on the host up front), so an iteration syncs the host once."""
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if not active:
            return
        k = self.spec_k
        K1 = k + 1
        obs_on = _obs.enabled()
        sampled = bool(self._temps.any())
        self._upload_page_tables()
        try:
            base_pos = self._pos.copy()
            cur = self._tensor(self._toks[:, None])
            cand = [cur[:, 0]]
            for j in range(1, k + 1):
                dlog, dkps, dvps = self.draft_runner.decode_cfn(
                    self.draft_params, cur, self.draft_cache.k_pages, self.draft_cache.v_pages,
                    self._pt_dev, self._tensor(base_pos + (j - 1)))
                self.draft_cache.rebind(dkps, dvps)
                if sampled:
                    dj = self.sampler(dlog, philox_uniform(self._seeds, base_pos + j, 0), self._temps)
                else:
                    dj = torch.argmax(dlog, -1)
                dj = dj.to(torch.int32)
                cand.append(dj)
                cur = dj[:, None]
            toks_mat = torch.stack(cand, 1)  # (max_batch, k+1)
            vlog, kps, vps = self.runner.verify_cfn(
                self.params, toks_mat, self.cache.k_pages, self.cache.v_pages, self._pt_dev,
                self._tensor(base_pos))
            self.cache.rebind(kps, vps)
            self.verify_calls += 1
            if sampled:
                B = toks_mat.shape[0]
                pos_flat = (base_pos[:, None] + 1 + np.arange(K1, dtype=np.int32)[None, :]).reshape(-1)
                samples = self.sampler(vlog.reshape(B * K1, -1),
                                          philox_uniform(np.repeat(self._seeds, K1), pos_flat, 0),
                                          np.repeat(self._temps, K1))
                samples = samples.reshape(B, K1).cpu().numpy()
            else:
                samples = torch.argmax(vlog, -1).cpu().numpy()  # (max_batch, k+1)
            toks_mat = toks_mat.cpu().numpy()
        except Exception as e:
            for i in active:
                self._fail(self._slots[i], e)
                self._clear_slot(i)
            return
        t_now = time.perf_counter()
        self.decode_steps += 1
        committed_total = accepted_total = 0
        for i in active:
            req = self._slots[i]
            m = 0
            while m < k and toks_mat[i, m + 1] == samples[i, m]:
                m += 1
            # commit the accepted samples; min(m+1, k) keeps the draft pool
            # valid (a bonus k+1th token would advance the target one
            # position past anything the draft ever wrote)
            self.spec_proposed += k
            self.spec_accepted += m
            accepted_total += m
            for j in range(min(m + 1, k)):
                committed_total += 1
                if not self._commit(i, req, int(samples[i, j]), t_now):
                    break
        if obs_on:
            _obs_metrics.record_serve("decode_steps")
            _obs_metrics.record_serve("tokens", delta=committed_total)
            _obs_metrics.record_serve("spec_proposed", delta=k * len(active))
            _obs_metrics.record_serve("spec_accepted", delta=accepted_total)

    def _finished(self, req: _Request, tok: int) -> bool:
        if req.future.cancelled():
            return True
        if req.eos_id is not None and tok == req.eos_id:
            return True
        return len(req.tokens) >= req.max_new_tokens

    def _retire(self, req: _Request) -> None:
        self.cache.allocator.free(req.pages)
        req.pages = []
        n_new = len(req.tokens)
        # t_first == 0.0 only for a prefix-hit request cancelled before its
        # first committed token — report a zero TTFT rather than a negative
        ttft = (req.t_first - req.t_submit) if req.t_first else 0.0
        tbot = ((req.t_last - req.t_first) / (n_new - 1)) if n_new > 1 else 0.0
        if req.future.cancelled():
            reason = "cancelled"
        elif req.eos_id is not None and req.tokens and req.tokens[-1] == req.eos_id:
            reason = "eos"
        else:
            reason = "length"
        slo_met = None
        if reason != "cancelled" and self.slo_policy is not None:
            ttft_ms = ttft * 1e3
            # a one-token request has no between-token interval: only its
            # TTFT binds
            tbot_ms = tbot * 1e3 if n_new > 1 else None
            slo_met = self.slo_policy.request_met(ttft_ms, tbot_ms)
            self.requests_retired += 1
            self.requests_slo_met += int(slo_met)
            self.slo_monitor.observe_request(ttft_ms=ttft_ms, tbot_ms=tbot_ms, met=bool(slo_met),
                                             tokens=n_new)
        if _obs.enabled():
            _obs_metrics.record_serve(
                "cancelled" if reason == "cancelled" else "retired", event=True,
                request=req.request_id, n_new=n_new, ttft_ms=round(ttft * 1e3, 3),
                tbot_ms=round(tbot * 1e3, 3), finish=reason, lane=req.lane,
                pool_utilization=round(self.cache.utilization(), 4))
        result = RequestResult(
            request_id=req.request_id,
            tokens=np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)]),
            new_tokens=np.asarray(req.tokens, np.int32),
            ttft_s=ttft,
            tbot_s=tbot,
            n_new_tokens=n_new,
            finish_reason=reason,
            slo_met=slo_met,
        )
        try:
            req.future.set_result(result)
        except InvalidStateError:
            pass
        with self._lock:
            self._outstanding -= 1
