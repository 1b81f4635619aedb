"""The training step: forward + backward + optimizer update, one call.

thunder_tpu/training.py:TrainStep, single-device path. thunder_tpu traces the
whole step — prologue-checked forward, backward, optimizer update — into one
``jax.jit`` program that donates the parameters and optimizer state. Here
the step is the forward and backward programs that autodiff builds
(transforms/autodiff.py), then the optimizer's in-place update (optim.py).
The parameters live in the module and are written in place, so
``step(*batch) -> loss`` leaves the module trained. Buffers the forward
writes (fp8 amax histories) are replayed onto the module after the update,
as thunder_tpu replays the step's effect outputs; buffers ride in the frozen
argument, read fresh each step.

On the card the whole step is one CUDA graph (``cuda_graphs=True``, the
default; executors/graphex.py), the counterpart of thunder_tpu's one
``jax.jit``: the first call of a batch signature runs op by op, the second
captures forward, backward, the update and the buffer writes (written into
the module's buffers), later calls replay. Parameters, buffers and the
optimizer state are read and written in place; the batch is copied into
the graph's buffers; the loss comes back as the caller's tensor. CPU
tensors run op by op. ``buckets=`` (a ``BucketLadder``) pads each batch
leaf along ``bucket_axis`` to its rung (``compile_service.pad_to_bucket``,
fill values from ``bucket_pad``, e.g. -100 for targets), so every length in
a rung is one program and one graph.

Distributed plans (parallel/): a module wrapped by ``ddp``, ``fsdp``,
``column_parallel``/``row_parallel`` and/or ``context_parallel`` carries a
``_dist_plan``, and its step is one program per rank, as thunder_tpu's step
is one ``shard_map`` program per device. The caller passes the global batch
on every rank; each rank takes its own block by thunder_tpu's
``_batch_pspec`` rule (dim 0 over the data axes, dim 1 over the sequence
axes, the latter for leaves of rank >= 2; a tensor-parallel axis splits
nothing). The traced step inserts each parameter's collectives
(``synchronize``: the gradient all-reduce; ``all_gather`` and the unpad
slice: FSDP's unshard, whose grad rule reduce-scatters), traces the model
under ``seq_parallel_tracing`` when the plan has a sequence axis, and
returns ``all_reduce(local loss) / loss_world_size`` — the loss every rank
gets back. The optimizer updates each rank's own tensors: under FSDP the
shards and their moments (on the card, one ``cudaex.adamw_update`` over
them). The plan rides on the module, so ``mesh_plan=`` (which thunder_tpu
stores and never reads) raises NotImplementedError.

A distributed step is captured too when its collectives capture on the
rank: a one-rank NCCL group's do. Asking for capture of a step over a
multi-rank group raises NotImplementedError naming ROADMAP A3c (pass
``cuda_graphs=False``); over Gloo (the CPU) it runs op by op. Before a
capture the forward and backward traces are checked as ``jit``'s are
(graphex.check_capturable): a host sync or host-side effect raises, naming
the symbol.

Gradient accumulation (thunder_tpu/training.py:700-1057): ``micro_step``
(or a step inside ``tmodule.no_sync()``) runs forward and backward and adds
the gradients into an accumulator, with no gradient sync and no update;
the next ``step`` adds its own gradients, syncs the sum once and updates.
Under DDP a window costs one all-reduce a parameter; under FSDP the
window's first micro-step gathers every sharded parameter once into whole
buffers, the micro-steps compute on them with no collective, and the fold
reduce-scatters each gradient once. On the card each micro-step and the
fold are CUDA graphs too. Tensor- and context-parallel gradients
synchronize per micro-batch inherently: a window under such a plan, a
guard, or a forward that writes buffers raises.

Resilient training (robustness/, thunder_tpu/training.py:281-335,
:536-700): ``guard=StepGuard(...)`` makes the step compute ``finite =
isfinite(loss) & isfinite(global_norm(grads))`` (the norm under
``check_grad_norm``) as a 0-d tensor on the card, inside the step's graph,
and pass it to the optimizer as its skip flag (optim.py): csrc/adamw.cu
writes nothing on a non-finite step, SGD writes ``where(finite, new, old)``,
the device step advances by ``finite``, and the forward's buffer writes are
gated the same way. The step returns (loss, finite, grad norm) and
``StepGuard.after_step`` reads the flag once (the policy: raise, skip,
rollback). The guard's ``program_key()`` is part of the trace cache key and
of the graph's key: a guarded and an unguarded step never share a trace or
a graph. A ``CheckpointManager`` attaches itself (``manager.attach(step)``)
and runs after each update (periodic saves, the SIGTERM drain); a step that
fails while the manager is preempted finalizes the preemption. The fault
sites of ``robustness.faults`` (TT_FAULT) are where thunder_tpu has them:
``slow`` and ``nan_loss`` before the step, ``die``, ``oom`` and
``transient`` (inside the guard's bounded retry) at dispatch, ``preempt``
after it.

``slo=SLOPolicy(...)`` attaches an SLOMonitor (observability/slo.py) fed
each step's host wall time, as thunder_tpu's.

Not ported yet: guards under a distributed plan (an all-rank verdict:
ROADMAP A3c) and the AOT executable cache. Asking for one of them raises
NotImplementedError naming it."""
from __future__ import annotations

import contextlib
import time

import torch

from .common import apply_effects
from .compile_service.buckets import BucketLadder, pad_to_bucket
from .core.pytree import tree_flatten, tree_unflatten
from .executors import graphex
from .nn.module import ThunderModule
from .optim import global_norm
from .robustness import faults as _faults
from .robustness.guards import StepGuard


class TrainStep:
    """step(*batch) -> loss; updates module parameters in place.

    loss_module: a Module (or the ThunderModule of one) whose forward(*batch)
    returns a scalar loss."""

    def __init__(self, loss_module, optimizer, *, mesh_plan=None, guard=None, slo=None,
                 buckets=None, bucket_pad=None, bucket_axis: int = 1, cuda_graphs: bool = True):
        from . import jit as _jit

        if mesh_plan is not None:
            raise NotImplementedError(
                "TrainStep(mesh_plan=...) is not read: the distributed plan rides on the "
                "module (parallel.ddp / fsdp / column_parallel / row_parallel / context_parallel; "
                "ROADMAP A3c)")
        # an SLOPolicy (observability/slo.py) gets a sliding-window monitor
        # over each step's host wall time (the replay's submission, as
        # thunder_tpu times its dispatch) and tokens/s (through
        # policy.tokens_per_step); without one a step pays one `is None` test
        self.slo_monitor = None
        if slo is not None:
            from .observability.slo import SLOMonitor, SLOPolicy

            if not isinstance(slo, SLOPolicy):
                raise TypeError(f"TrainStep(slo=...) takes an observability.SLOPolicy, got {type(slo).__name__}")
            if slo.min_tokens_per_s is not None and not slo.tokens_per_step:
                # a training step has no per-request token count: without
                # tokens_per_step the throughput target would never be evaluated
                raise ValueError("SLOPolicy(min_tokens_per_s=...) on a TrainStep needs "
                                 "tokens_per_step=<batch tokens per step> to compute throughput")
            self.slo_monitor = SLOMonitor(slo, source="training")
        if buckets is not None and not isinstance(buckets, BucketLadder):
            raise TypeError(f"TrainStep(buckets=...) takes a BucketLadder, got {type(buckets).__name__}")
        if bucket_pad is not None and not isinstance(bucket_pad, dict):
            raise TypeError(f"TrainStep(bucket_pad=...) takes a dict of fill values by argument, "
                            f"got {type(bucket_pad).__name__}")
        if isinstance(loss_module, torch.nn.Module):
            loss_module = _jit(loss_module)
        if not isinstance(loss_module, ThunderModule):
            raise TypeError("TrainStep expects a Module or ThunderModule computing a scalar loss")
        if guard is not None and not isinstance(guard, StepGuard):
            raise TypeError(f"TrainStep(guard=...) takes a robustness.StepGuard, got {type(guard).__name__}")
        if guard is not None and getattr(loss_module, "_dist_plan", None) is not None:
            raise NotImplementedError(
                "TrainStep(guard=...) under a distributed plan (an all-rank finite verdict) is not "
                "ported yet (ROADMAP A3c)")
        self.tmodule = loss_module
        self.guard = guard
        self.optimizer = optimizer
        self.opt_state = None
        self._vag = None
        self._pairs = None
        self._step_count = 0
        self.buckets = buckets
        self.bucket_pad = dict(bucket_pad or {})
        self.bucket_axis = bucket_axis
        self.cuda_graphs = cuda_graphs
        self._programs: dict = {}  # batch signature -> graphex.CUDAGraphProgram
        self._pool = graphex.GraphPool()
        # no_sync windows: the gradient accumulator (zeroed by each fold),
        # whether it holds a window's micro-steps, FSDP's gathered
        # parameters, and the value-and-grad of the window's program
        self._acc = None
        self._acc_open = False
        self._full = None
        self._vag_nosync = None

    @property
    def _cs(self):
        """The compile stats of the step's programs: ``last_traces(step)``
        and ``last_backward_traces(step)`` read them."""
        if self._vag is None:
            raise ValueError("TrainStep has not run yet")
        return self._vag._cs

    # set by CheckpointManager.attach(); None keeps the per-step cost at one
    # attribute read
    _ckpt_manager = None

    @property
    def step_count(self) -> int:
        """Completed optimizer steps; checkpoint/restore round-trips it."""
        return self._step_count

    def _guard_key(self) -> str:
        return self.guard.program_key() if self.guard is not None else "noguard"

    def _split(self):
        """(trainable params, frozen params and buffers) by qualified name;
        the name → Parameter pairs are walked once."""
        if self._pairs is None:
            params = self.tmodule.get_parameters()
            self._pairs = tuple(params.items())
        trainable = {k: p for k, p in self._pairs if p.requires_grad}
        frozen = {k: p for k, p in self._pairs if not p.requires_grad}
        frozen.update(self.tmodule.get_buffers())
        return trainable, frozen

    @property
    def _plan(self):
        return getattr(self.tmodule, "_dist_plan", None)

    def _build(self):
        from .transforms.autodiff import ThunderValueAndGrad

        inner = self.tmodule._cd.fn
        plan = self._plan
        if plan is None:
            traced = inner
        else:
            from .ops import ltorch
            from .parallel import prims as dist_prims
            from .parallel.context_parallel import seq_parallel_tracing
            from .parallel.transforms import apply_param_collectives

            def traced(params: dict, args: tuple, kwargs: dict):
                seq_axes = tuple(plan.seq_axes)
                cp_ctx = (seq_parallel_tracing(seq_axes[0], plan.world_size(seq_axes[0]))
                          if seq_axes else contextlib.nullcontext())
                full_params = apply_param_collectives(params, plan)
                with cp_ctx:
                    local_loss = inner(full_params, args, kwargs)
                if plan.loss_axes:
                    s = dist_prims.all_reduce(local_loss, plan.loss_axes)
                    return ltorch.div(s, float(plan.loss_world_size))
                return local_loss

        # frozen (requires_grad=False) params and buffers ride as a separate,
        # non-differentiated argument
        def traced_split(tparams: dict, frozen: dict, args: tuple, kwargs: dict):
            return traced({**frozen, **tparams}, args, kwargs)

        traced_split.__name__ = getattr(inner, "__name__", "step")
        inner_extra = getattr(inner, "__cache_extra__", None)
        guard_key = self._guard_key()
        traced_split.__cache_extra__ = lambda: (inner_extra() if inner_extra is not None else None, guard_key)
        cd = self.tmodule._cd
        self._vag = ThunderValueAndGrad(traced_split, argnums=0, transforms=cd.transforms,
                                        executors=cd.executors)
        self._vag.defer_effects = True  # replayed by __call__ after the update

    def _bucketize(self, args, kwargs):
        """Pad batch leaves to the ladder's rung (thunder_tpu's _bucketize):
        every length in a rung then has one cache key, one program and one
        graph. The rung's traffic is recorded as the serving engine records
        its prefill buckets."""
        if self.buckets is None:
            return args, kwargs
        for a in args:
            shape = getattr(a, "shape", None)
            if shape is not None and len(shape) > self.bucket_axis:
                self.buckets.touch(int(shape[self.bucket_axis]))
                break
        return pad_to_bucket(args, kwargs, self.buckets, axis=self.bucket_axis, pad_values=self.bucket_pad)

    def _prepare(self, args, kwargs):
        """The step's (trainable, frozen) tensors and this rank's block of the
        batch; the optimizer state and the value-and-grad built on first use."""
        tparams, frozen = self._split()
        plan = self._plan
        if plan is not None:
            from .parallel.mesh import set_active_mesh

            set_active_mesh(plan.mesh)
            args, kwargs = _local_batch(plan, args, kwargs)
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(tparams)
        if self._vag is None:
            self._build()
        return tparams, frozen, args, kwargs

    def _graphs_on(self, tparams) -> bool:
        first = next(iter(tparams.values()), None)
        return self.cuda_graphs and first is not None and graphex.captures_on(first.device)

    def __call__(self, *args, **kwargs):
        if self.tmodule._no_sync_active:
            return self.micro_step(*args, **kwargs)
        slo_mon = self.slo_monitor
        t_host = time.perf_counter_ns() if slo_mon is not None else 0
        args, kwargs = self._bucketize(args, kwargs)
        # fault-injection seam (TT_FAULT): with no plan armed this is one
        # module-global read
        step_idx = self._step_count
        if _faults.active():
            _faults.maybe_sleep(step_idx)
            args, kwargs = _faults.maybe_poison(args, kwargs, step_idx)
        tparams, frozen, args, kwargs = self._prepare(args, kwargs)
        state = dict(enumerate(t for t in tree_flatten(self.opt_state)[0] if isinstance(t, torch.Tensor)))

        def run():
            if self._acc_open:
                # the step that closes a no_sync window
                return self._fold(tparams, frozen, state, args, kwargs)
            return self._launch("step", (tparams, frozen, state), lambda tp, fz, _st, a, kw: self._step(
                tp, fz, a, kw, in_place=self._graphs_on(tparams)), args, kwargs, self._vag)

        try:
            out = self._dispatch(run)
        except BaseException:
            # a step that dies while the manager is draining a preemption is
            # the drain arriving, not a crash: finalize the preemption from
            # the last completed step (raises Preempted)
            mgr = self._ckpt_manager
            if mgr is not None and mgr.preempted:
                mgr._finalize_preempt(self)
            raise
        self._step_count += 1
        if slo_mon is not None:
            slo_mon.observe_step((time.perf_counter_ns() - t_host) / 1e6)
        if self.guard is not None:
            loss, finite, gnorm = out
            # host half of the guard: one device sync, then the policy
            # (raise / skip-with-budget / rollback via the manager)
            self.guard.after_step(self, loss, (finite, gnorm))
        else:
            loss = out
        if _faults.active():
            _faults.maybe_preempt(step_idx)
        mgr = self._ckpt_manager
        if mgr is not None:
            # periodic save / preemption drain; idle cost is an Event read
            # plus an int modulo (CheckpointManager.on_step)
            mgr.on_step(self)
        return loss

    def _dispatch(self, run):
        """Run the step, with bounded retry-with-backoff for transient errors
        when the guard asks for it (thunder_tpu/training.py:_dispatch)."""
        g = self.guard
        step_idx = self._step_count
        if g is None or g.policy.retry_transient <= 0:
            if _faults.active():
                # `die` kills the process mid-step, outside any retry loop (a
                # dead host does not retry); `oom` likewise does not recover
                # on the next attempt
                _faults.maybe_die(step_idx)
                _faults.maybe_oom(step_idx)
                _faults.maybe_raise("transient", step_idx)
            return run()

        def attempt():
            # inside the retry loop: `transient@N*k` fails the first k
            # attempts of step N
            if _faults.active():
                _faults.maybe_raise("transient", step_idx)
            return run()

        if _faults.active():
            _faults.maybe_die(step_idx)
            _faults.maybe_oom(step_idx)
        return g.run_with_retry(attempt, step=step_idx)

    def _step(self, tparams, frozen, args, kwargs, in_place: bool):
        """Forward, backward, the update, then the forward's buffer writes
        (into the module's buffers when ``in_place``: a CUDA graph's). Under
        a guard the update and the buffer writes are gated by the step's
        finite flag, and the step returns (loss, finite, grad norm)."""
        loss, grads = self._vag(tparams, frozen, args, kwargs)
        pending = self._vag.consume_pending_effects()
        if self._plan is not None and pending is not None:
            raise NotImplementedError(
                "buffer mutations (e.g. BatchNorm running stats) inside a "
                "distributed TrainStep are not supported yet — stats would "
                "need a cross-replica mean; freeze the buffers (module.eval()) "
                "or train without a mesh plan")
        param_grads = grads[0][0]
        if self.guard is None:
            self.optimizer.update(tparams, param_grads, self.opt_state)
            if pending is not None:
                apply_effects(*pending, in_place=in_place)
            return loss
        with torch.no_grad():
            ok = torch.isfinite(loss)
            if self.guard.policy.check_grad_norm:
                gnorm = global_norm(param_grads)
                ok = ok & torch.isfinite(gnorm)
            else:
                gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)
            finite = ok.to(torch.int32)
        self.optimizer.update(tparams, param_grads, self.opt_state, finite=finite)
        if pending is not None:
            keys, values = pending
            keep = finite.bool()
            # a non-finite step's buffer writes (running stats, amax
            # histories) came from the NaN forward: the old values stay
            values = [torch.where(keep, v, owner._buffers[name]) for (owner, name), v in zip(keys, values)]
            apply_effects(keys, values, in_place=in_place)
        return loss, finite, gnorm

    def _launch(self, kind: str, groups: tuple, body, args, kwargs, vag):
        """``body(*groups, args, kwargs)``: op by op, or on the card as one
        CUDA graph per (kind, batch signature). ``groups`` are dicts of
        resident tensors (parameters, buffers, optimizer state,
        accumulators), read and written in place; the batch's tensors are
        copied into the graph's buffers."""
        from . import _cache_key

        tparams = groups[0]
        if not self._graphs_on(tparams):
            return body(*groups, args, kwargs)
        leaves, treedef = tree_flatten((args, kwargs))
        is_t = [isinstance(x, torch.Tensor) for x in leaves]
        names = tuple(tuple(g) for g in groups)
        resident = [t for g in groups for t in g.values()]
        key = (names[0], names[1], _cache_key(leaves, is_t, self._vag.fn), self._guard_key())
        if kind != "step":
            key += (kind,)
        prog = self._programs.get(key)
        if prog is None:
            nr = len(resident)

            def program(*flat):
                it = iter(flat[:nr])
                gs = [{k: next(it) for k in g} for g in names]
                batch = iter(flat[nr:])
                a, kw = tree_unflatten([next(batch) if t else x for x, t in zip(leaves, is_t)], treedef)
                return body(*gs, a, kw)

            prog = self._programs[key] = graphex.CUDAGraphProgram(
                program, name="TrainStep" if kind == "step" else f"TrainStep.{kind}",
                in_place=[True] * nr + [False] * sum(is_t), pool=self._pool, stats=self._vag._cs,
                check=lambda: self._check_capturable(vag))
        return prog(*resident, *(x for x, t in zip(leaves, is_t) if t))

    def _check_capturable(self, vag=None):
        """The forward and backward traces of the last compile hold nothing
        a graph cannot (graphex.check_capturable raises, naming it)."""
        if self._plan is not None and not graphex.collectives_capture():
            # the window's gradient syncs run outside its traces
            raise NotImplementedError(
                "TrainStep: CUDA-graph capture of a distributed step was asked for, but only a one-rank "
                "NCCL group's collectives are captured (multi-rank capture: ROADMAP A3c); run it with "
                "cuda_graphs=False")
        cs = (vag or self._vag)._cs
        graphex.check_capturable(cs.last_traces[-1], "TrainStep forward")
        graphex.check_capturable(cs.last_backward_traces[-1], "TrainStep backward")

    # -- no_sync gradient accumulation (thunder_tpu/training.py:700-1057) --

    def _nosync_mode(self):
        """None without a plan; 'ddp' when every parameter is replicated;
        'fsdp' when some are dim-0 sharded (thunder_tpu's _nosync_mode)."""
        plan = self._plan
        if plan is None:
            return None
        kinds = {st.kind for sts in plan.param_strategies.values() for st in sts}
        if kinds <= {"replicate"}:
            return "ddp"
        if kinds <= {"replicate", "shard0"} and not plan.seq_axes:
            return "fsdp"
        raise NotImplementedError(
            "no_sync supports DDP (replicate) and FSDP (shard0) plans; tensor- and context-parallel "
            "gradients synchronize per micro-batch inherently")

    def _window_vag(self):
        """The window's value-and-grad: the model on whole parameters, with
        no parameter collective and no loss sync (without a plan: the
        step's own)."""
        plan = self._plan
        if plan is None:
            return self._vag
        if self._vag_nosync is None:
            from .transforms.autodiff import ThunderValueAndGrad

            inner = self.tmodule._cd.fn

            def traced_nosync(tfull: dict, ffull: dict, args: tuple, kwargs: dict):
                return inner({**ffull, **tfull}, args, kwargs)

            traced_nosync.__name__ = f"nosync_{getattr(inner, '__name__', 'step')}"
            inner_extra = getattr(inner, "__cache_extra__", None)
            traced_nosync.__cache_extra__ = lambda: (inner_extra() if inner_extra is not None else None,
                                                     "nosync")
            cd = self.tmodule._cd
            self._vag_nosync = ThunderValueAndGrad(traced_nosync, argnums=0, transforms=cd.transforms,
                                                   executors=cd.executors)
            self._vag_nosync.defer_effects = True
        return self._vag_nosync

    def _window_params(self, mode, tparams, frozen):
        """The whole parameters a window computes with. Under FSDP: buffers
        allocated once, filled at each window's first micro-step by one
        all_gather (and unpad) a sharded parameter; otherwise the step's own
        tensors."""
        if mode != "fsdp":
            return tparams, frozen
        from .parallel import prims as dist_prims

        plan = self._plan
        shard = {k: st for k, sts in plan.param_strategies.items() for st in sts if st.kind == "shard0"}
        if self._full is None:
            def alloc(d):
                out = {}
                for k, t in d.items():
                    st = shard.get(k)
                    if st is None:
                        out[k] = t
                    else:
                        rows = st.orig_dim0 if st.orig_dim0 is not None else t.shape[0] * plan.world_size(st.axis)
                        out[k] = torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
                return out

            self._full = (alloc(tparams), alloc(frozen))
        if not self._acc_open:
            with torch.no_grad():
                for d, full in zip((tparams, frozen), self._full):
                    for k, t in d.items():
                        st = shard.get(k)
                        if st is not None:
                            g = dist_prims._all_gather_impl(t, st.axis, world_size=plan.world_size(st.axis))
                            full[k].copy_(g[:full[k].shape[0]])
        return self._full

    def _sync_loss(self, loss):
        plan = self._plan
        if plan is None or not plan.loss_axes:
            return loss
        from .parallel import prims as dist_prims

        return dist_prims._all_reduce(loss, plan.loss_axes) / float(plan.loss_world_size)

    def _sync_grad(self, name: str, g):
        """The window's summed local gradient of ``name`` made the plan's
        gradient: all-reduced over the loss axes (DDP), or, for a sharded
        parameter, all-reduced over the loss axes it is not sharded on,
        padded, and reduce-scattered over its shard axis (FSDP); then
        divided by the loss world size (thunder_tpu's _fold_dist / _fold_fsdp)."""
        from .parallel import prims as dist_prims
        from .parallel.transforms import pad_rows

        plan = self._plan
        axes = plan.loss_axes
        st = next((s for s in plan.param_strategies.get(name, ()) if s.kind == "shard0"), None)
        if st is None:
            if axes:
                g = dist_prims._all_reduce(g, axes)
        else:
            other = tuple(a for a in axes if a != st.axis)
            if other:
                g = dist_prims._all_reduce(g, other)
            n = plan.world_size(st.axis)
            g = dist_prims._reduce_scatter_impl(pad_rows(g, st, n), st.axis, world_size=n)
        return g / float(plan.loss_world_size) if plan.loss_world_size > 1 else g

    def micro_step(self, *args, **kwargs):
        """Accumulate gradients without the gradient sync or the optimizer
        update; the next ``step`` folds them in with one sync (thunder_tpu's
        micro_step). Returns the micro-batch's loss, averaged over the ranks
        as a step's is."""
        if self.guard is not None:
            # the window's fold would update without the finite gate
            raise NotImplementedError("TrainStep.micro_step: step guards are not supported inside no_sync "
                                      "gradient-accumulation windows; step without no_sync, or drop the guard")
        mode = self._nosync_mode()
        args, kwargs = self._bucketize(args, kwargs)
        tparams, frozen, args, kwargs = self._prepare(args, kwargs)
        vag = self._window_vag()
        full_t, full_f = self._window_params(mode, tparams, frozen)
        if self._acc is None:
            self._acc = {k: torch.zeros_like(t) for k, t in full_t.items()}

        def micro(ft, ff, acc, a, kw):
            loss, grads = vag(ft, ff, a, kw)
            if vag.consume_pending_effects() is not None:
                raise NotImplementedError("buffer mutations are not supported inside no_sync windows; "
                                          "freeze the buffers (eval()) or step without no_sync")
            g = grads[0][0]
            for k, t in acc.items():
                if g[k] is not None:  # a parameter the loss does not reach
                    t.add_(g[k])
            return self._sync_loss(loss)

        loss = self._launch("micro", (full_t, full_f, self._acc), micro, args, kwargs, vag)
        self._acc_open = True
        return loss

    def _fold(self, tparams, frozen, state, args, kwargs):
        """The step that closes a window: its own gradients plus the
        accumulator, synced once, then the update; the accumulator is zeroed
        for the next window."""
        mode = self._nosync_mode()
        vag = self._window_vag()
        full_t, full_f = self._window_params(mode, tparams, frozen)
        plan = self._plan

        def fold(tp, fz, ft, ff, acc, _state, a, kw):
            loss, grads = vag(ft, ff, a, kw)
            if vag.consume_pending_effects() is not None:
                raise NotImplementedError("buffer mutations are not supported inside no_sync windows")
            g = grads[0][0]
            total = {k: acc[k] if g[k] is None else g[k] + acc[k] for k in g}
            if plan is not None:
                total = {k: self._sync_grad(k, v) for k, v in total.items()}
            for t in acc.values():
                t.zero_()
            self.optimizer.update(tp, total, self.opt_state)
            return self._sync_loss(loss)

        groups = (tparams, frozen, full_t, full_f, self._acc, state)
        if mode != "fsdp":
            # the window computed on the step's own tensors: pass them once
            groups = (tparams, frozen, {}, {}, self._acc, state)
            body = fold

            def fold(tp, fz, _ft, _ff, acc, st, a, kw):
                return body(tp, fz, tp, fz, acc, st, a, kw)

        loss = self._launch("fold", groups, fold, args, kwargs, vag)
        self._acc_open = False
        return loss


def _local_batch(plan, args: tuple, kwargs: dict):
    """This rank's block of the global batch (thunder_tpu's _batch_pspec):
    tensor leaves split along dim 0 over the data axes and, from rank 2 up,
    along dim 1 over the sequence axes; 0-d leaves whole."""
    mesh = plan.mesh
    cuts = []
    if plan.data_axes:
        cuts.append((0, tuple(plan.data_axes), "data-parallel"))
    if plan.seq_axes:
        cuts.append((1, tuple(plan.seq_axes), "sequence-parallel"))
    leaves, treedef = tree_flatten((args, kwargs))
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            for dim, axes, kind in cuts:
                if leaf.ndim <= dim:
                    continue
                n = mesh.size(axes)
                if leaf.shape[dim] % n:
                    raise ValueError(
                        f"batch dim {dim} ({leaf.shape[dim]}) is not divisible by the "
                        f"{kind} world size {n} (axes {axes}); pad or resize the batch")
                b = leaf.shape[dim] // n
                leaf = leaf.narrow(dim, mesh.coordinate(axes) * b, b)
            leaf = leaf.contiguous()
        out.append(leaf)
    return tree_unflatten(out, treedef)
