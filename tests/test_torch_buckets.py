"""Bucketed training: the port's ``pad_to_bucket`` and
``TrainStep(buckets=, bucket_pad=)`` against thunder_tpu's, on the CPU.

* ``pad_to_bucket``: numpy arrays and tensors along axis 1 and 0, with the
  default fill and per-argument fills (-100 for targets), a length already
  on a rung, arrays too small for the axis, a length past the ladder's cap
  (refused): values and shapes equal to thunder_tpu's.
* tiny-llama2 f32 TrainSteps, weights carried across by load_jax_params,
  on a ladder whose rung 64 holds lengths 40 and 56: 3 steps alternating
  the two lengths, targets padded with -100. Losses within 1e-4 relative
  and parameters within 1e-4 absolute (tests/test_torch_training.py's f32
  bars), one specialization (the port compiles once; thunder_tpu's step
  traces once). A planted fault, targets padded with 0 instead of -100,
  moves the losses off thunder_tpu's.
"""
import numpy as np
import pytest
import torch

import thunder_tpu_torch as tt
from thunder_tpu_torch import optim as topt
from thunder_tpu_torch.compile_service.buckets import BucketLadder, pad_to_bucket
from thunder_tpu_torch.models import litgpt as tlg
from thunder_tpu_torch.training import TrainStep


@pytest.fixture(scope="module")
def jax_buckets():
    from thunder_tpu.compile_service import buckets as jb

    return jb


CASES = {
    "axis1_default": (1, None, (3, 37)),
    "axis1_targets": (1, {1: -100, "tgt": -100}, (2, 50)),
    "axis0": (0, {0: 7}, (20, 3)),
    "on_rung": (1, None, (2, 64)),
    "too_small": (2, None, (4, 5)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_pad_to_bucket_matches_thunder_tpu(jax_buckets, case, kind):
    axis, pads, shape = CASES[case]
    rng = np.random.RandomState(0)
    arrs = [rng.randint(0, 50, shape).astype(np.int32), rng.randint(0, 50, shape).astype(np.int64)]
    kw = {"tgt": rng.randint(0, 50, shape).astype(np.int64)}
    jl = jax_buckets.BucketLadder(16, 128)
    want_a, want_kw = jax_buckets.pad_to_bucket(tuple(arrs), kw, jl, axis=axis, pad_values=pads)
    conv = (lambda a: a) if kind == "numpy" else torch.from_numpy
    got_a, got_kw = pad_to_bucket(tuple(conv(a) for a in arrs), {k: conv(v) for k, v in kw.items()},
                                  BucketLadder(16, 128), axis=axis, pad_values=pads)
    for g, w in zip(list(got_a) + [got_kw["tgt"]], list(want_a) + [want_kw["tgt"]]):
        assert isinstance(g, np.ndarray) == (kind == "numpy")
        g = np.asarray(g)
        assert g.shape == np.asarray(w).shape and g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))


def test_pad_to_bucket_refuses_a_length_past_the_cap():
    with pytest.raises(ValueError, match="max_len=128"):
        pad_to_bucket((torch.zeros(2, 130),), {}, BucketLadder(16, 128))


def _bucketed_pair(target_fill: int):
    import jax.numpy as jnp
    import thunder_tpu as tj
    from thunder_tpu import optim as jopt
    from thunder_tpu.compile_service.buckets import BucketLadder as JaxLadder
    from thunder_tpu.models import litgpt as jlg
    from thunder_tpu.training import TrainStep as JaxTrainStep

    jm = jlg.GPTForCausalLM(jlg.Config.from_name("tiny-llama2"))
    cfg = tlg.Config.from_name("tiny-llama2")
    tm = tlg.GPTForCausalLM(cfg, device="cpu")
    tlg.load_jax_params(tm, {k: np.asarray(p.data) for k, p in jm.named_parameters()})
    js = JaxTrainStep(tj.jit(jm), jopt.AdamW(lr=1e-3), buckets=JaxLadder(16, 128), bucket_pad={1: -100})
    ts = TrainStep(tt.jit(tm), topt.AdamW(lr=1e-3), buckets=BucketLadder(16, 128), bucket_pad={1: target_fill})
    rng = np.random.RandomState(6)
    jl, tl_ = [], []
    for T in (40, 56, 40):
        idx = rng.randint(0, cfg.vocab_size, (2, T)).astype(np.int32)
        tgt = rng.randint(0, cfg.vocab_size, (2, T)).astype(np.int32)
        jl.append(float(js(jnp.asarray(idx), jnp.asarray(tgt))))
        tl_.append(float(ts(torch.tensor(idx), torch.tensor(tgt))))
    jp = {k: np.asarray(p.data) for k, p in jm.named_parameters()}
    tp = {k: p.detach().numpy() for k, p in tm.named_parameters()}
    return np.array(jl), np.array(tl_), jp, tp, ts


def test_bucketed_train_step_matches_thunder_tpu_in_one_specialization():
    jl, tl_, jp, tp, ts = _bucketed_pair(-100)
    np.testing.assert_allclose(tl_, jl, rtol=1e-4, atol=0)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], atol=1e-4, rtol=0, err_msg=k)
    assert tt.cache_misses(ts) == 1 and tt.cache_hits(ts) == 2
    assert ts.buckets.hits() == {64: 3}


def test_bucketed_train_step_fault_zero_padded_targets_is_caught():
    jl, tl_, *_ = _bucketed_pair(0)
    assert np.abs(tl_ - jl).max() > 1e-4 * np.abs(jl).max()
