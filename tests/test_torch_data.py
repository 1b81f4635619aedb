"""The port's data pipeline (thunder_tpu_torch/data/) against thunder_tpu's,
on the CPU; on a CUDA card (``-m gpu``) the prefetcher's transfer.

* ``TokenLoader``: for one token file and seed, the port's batches equal
  thunder_tpu's, on the native path (the same loader.cpp, built by g++
  into build/thunder_tpu_torch/, never into the source tree) and on the
  numpy fallback; the cursor round trip (``state_dict`` /
  ``load_state_dict``) continues both packages' streams alike, and a cursor
  from one package's loader positions the other's. A failing g++ raises
  with its output; a machine without g++ falls back with a warning.
* ``prefetch_to_device``: order, clean exhaustion, a source's or a
  transfer's error re-raised in order, early stop without a deadlock, the
  worker reaped with its consumer; on the CPU the transfer is the identity
  (arrays become tensors sharing their memory); a prefetcher made by
  ``TokenLoader.prefetched`` keeps the cursor at the batches the consumer
  took, and re-positions the loader.
* On the card: batches land on the card equal to the source, through
  pinned buffers reused only after their copies' events completed, each
  ordered before the consumer's stream reads it.
"""
import gc
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import thunder_tpu_torch.data as tdata
from thunder_tpu_torch.data import TokenLoader, write_token_file
from thunder_tpu_torch.data.prefetch import prefetch_to_device

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def token_file(tmp_path):
    path = str(tmp_path / "tokens.bin")
    toks = np.random.RandomState(0).randint(0, 50000, 100_000)
    write_token_file(path, toks, token_bytes=2)
    return path, toks


def _jax_loader(path, **kw):
    from thunder_tpu.data import TokenLoader as JLoader

    return JLoader(path, **kw)


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_batches_equal_thunder_tpus(token_file, native):
    path, toks = token_file
    kw = dict(batch_size=4, seq_len=64, seed=7, native=native)
    ours, theirs = TokenLoader(path, n_threads=3, **kw), _jax_loader(path, **kw)
    assert ours.is_native == theirs.is_native == native
    assert ours.num_tokens == theirs.num_tokens == 100_000
    for _ in range(8):
        (x, y), (jx, jy) = ours.next_batch(), theirs.next_batch()
        assert x.dtype == np.int32 and x.shape == (4, 64)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
    ours.close()
    theirs.close()


def test_native_library_builds_into_the_build_directory(token_file):
    loader = TokenLoader(token_file[0], batch_size=2, seq_len=16)
    assert loader.is_native, "g++ is on this machine: the native path must build"
    built = sorted(tdata.BUILD_DIR.glob("libttloader-*.so"))
    assert built and all(p.parent == ROOT / "build" / "thunder_tpu_torch" for p in built)
    assert not list((ROOT / "thunder_tpu_torch" / "data").rglob("*.so"))  # nothing in the source tree
    loader.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_cursor_round_trip_continues_both_packages_streams(token_file, native):
    """A fresh loader restored from ``state_dict()`` serves what the
    original would have served next; a thunder_tpu cursor positions the
    port's loader and the port's thunder_tpu's."""
    path, _ = token_file
    kw = dict(batch_size=4, seq_len=32, seed=11, native=native)
    a, ja = TokenLoader(path, **kw), _jax_loader(path, **kw)
    for _ in range(5):
        a.next_batch()
        ja.next_batch()
    sd, jsd = a.state_dict(), ja.state_dict()
    assert sd == jsd and sd["served"] == 5
    expected = [a.next_batch() for _ in range(4)]
    a.close()
    ja.close()
    b = TokenLoader(path, **dict(kw, seed=999))
    b.next_batch()  # a drifted loader: the resume fully re-positions it
    b.load_state_dict(jsd)
    jb = _jax_loader(path, **dict(kw, seed=999))
    jb.load_state_dict(sd)
    for want_x, want_y in expected:
        (x, y), (jx, jy) = b.next_batch(), jb.next_batch()
        np.testing.assert_array_equal(want_x, x)
        np.testing.assert_array_equal(want_y, y)
        np.testing.assert_array_equal(want_x, jx)
    assert b.state_dict()["served"] == 9
    b.close()
    jb.close()


def test_cursor_refuses_another_path_or_shape(token_file):
    path, _ = token_file
    a = TokenLoader(path, batch_size=4, seq_len=32, seed=1)
    sd = a.state_dict()
    a.close()
    b = TokenLoader(path, batch_size=4, seq_len=32, seed=1, native=False)
    with pytest.raises(ValueError, match="serving"):
        b.load_state_dict(sd)
    c = TokenLoader(path, batch_size=2, seq_len=32, native=False)
    with pytest.raises(ValueError, match="state mismatch"):
        c.load_state_dict(b.state_dict())
    b.close()
    c.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_minimal_and_short_corpora(tmp_path, native):
    path = str(tmp_path / "tiny.bin")
    write_token_file(path, np.arange(17), token_bytes=2)
    loader = TokenLoader(path, batch_size=2, seq_len=16, native=native)
    x, y = loader.next_batch()
    np.testing.assert_array_equal(x[0], np.arange(16))
    np.testing.assert_array_equal(y[0], np.arange(1, 17))
    loader.close()
    with pytest.raises(ValueError, match="need at least seq_len\\+1=18"):
        TokenLoader(path, batch_size=2, seq_len=17, native=native)


def test_failing_gxx_raises_with_its_output(tmp_path, monkeypatch):
    monkeypatch.setattr(tdata, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tdata, "_lib", None)
    monkeypatch.setattr(tdata, "_lib_missing", False)
    monkeypatch.setattr(tdata.subprocess, "run",
                        lambda *a, **k: subprocess.CompletedProcess(a, 1, "", "loader.cpp:1: error: planted"))
    path = str(tmp_path / "t.bin")
    write_token_file(path, np.arange(100), token_bytes=2)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*planted"):
        TokenLoader(path, batch_size=2, seq_len=16)
    assert not list((tmp_path / "build").glob("*"))  # no half-written library left behind


def test_no_gxx_falls_back_with_a_warning(tmp_path, monkeypatch):
    monkeypatch.setattr(tdata, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tdata, "_lib", None)
    monkeypatch.setattr(tdata, "_lib_missing", False)
    monkeypatch.setattr(tdata.shutil, "which", lambda name: None)
    path = str(tmp_path / "t.bin")
    write_token_file(path, np.arange(100), token_bytes=2)
    with pytest.warns(UserWarning, match="no g\\+\\+"):
        loader = TokenLoader(path, batch_size=2, seq_len=16)
    assert not loader.is_native
    loader.close()


def test_fallback_worker_is_threaded_and_closes(token_file):
    loader = TokenLoader(token_file[0], batch_size=2, seq_len=16, native=False)
    t = loader._fb_thread
    assert t is not None and t.is_alive()
    loader.next_batch()
    loader.close()
    assert not t.is_alive(), "fallback prefetch worker survived close()"


# ---------------------------------------------------------------------------
# prefetch_to_device
# ---------------------------------------------------------------------------


def test_ordering_preserved_and_host_transfer_is_the_identity():
    items = [np.full((2, 2), i, np.int32) for i in range(20)]
    out = list(prefetch_to_device(iter(items), size=3, device="cpu"))
    assert len(out) == 20
    for i, (x, src) in enumerate(zip(out, items)):
        assert isinstance(x, torch.Tensor) and int(x[0, 0]) == i
        assert x.data_ptr() == src.ctypes.data  # the same memory: no copy on the CPU
    t = torch.ones(3)
    assert next(prefetch_to_device(iter([(t, 5)]), device="cpu"))[0] is t


def test_exhaustion_terminates_cleanly():
    p = prefetch_to_device(iter([np.zeros(1)]), size=2, device="cpu")
    assert len(list(p)) == 1
    assert list(p) == []
    p.close()


def test_worker_exception_propagates_in_order():
    def gen():
        yield np.zeros(2)
        yield np.ones(2)
        raise ValueError("boom")

    p = prefetch_to_device(gen(), size=2, device="cpu")
    assert float(next(p).sum()) == 0.0
    assert float(next(p).sum()) == 2.0
    with pytest.raises(ValueError, match="boom"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)


def test_transfer_exception_propagates():
    def bad(x):
        raise RuntimeError("transfer failed")

    p = prefetch_to_device(iter([1, 2]), transfer=bad)
    with pytest.raises(RuntimeError, match="transfer failed"):
        next(p)


def test_early_stop_and_dropped_consumer_reap_the_worker():
    def endless():
        i = 0
        while True:
            yield np.full((4,), i, np.int32)
            i += 1

    p = prefetch_to_device(endless(), size=2, device="cpu")
    for _ in range(3):
        next(p)
    t = p._thread
    p.close()
    p.close()  # idempotent
    t.join(timeout=5.0)
    assert not t.is_alive(), "producer thread survived close()"
    p = prefetch_to_device(iter(range(10_000)), size=2, transfer=lambda x: x)
    next(p)
    t = p._thread
    del p
    gc.collect()
    t.join(timeout=5.0)
    assert not t.is_alive(), "worker leaked after the consumer was dropped"


def test_invalid_size_rejected():
    with pytest.raises(ValueError):
        prefetch_to_device(iter(()), size=0, device="cpu")


def test_prefetched_cursor_counts_what_the_consumer_took(token_file):
    """The worker runs ahead of the consumer (the loader has served more),
    but the prefetcher's cursor is the consumer's; loading it restarts the
    stream there."""
    path, _ = token_file
    loader = TokenLoader(path, batch_size=2, seq_len=16, seed=5, native=False)
    stream = loader.prefetched(size=3, device="cpu")
    taken = [next(stream) for _ in range(4)]
    for _ in range(200):
        if loader.state_dict()["served"] > 4:
            break
        __import__("time").sleep(0.01)
    assert loader.state_dict()["served"] > 4  # pulled ahead
    sd = stream.state_dict()
    assert sd["served"] == 4
    following = [next(stream) for _ in range(2)]
    stream.load_state_dict(sd)
    again = [next(stream) for _ in range(2)]
    for (x, y), (x2, y2) in zip(following, again):
        assert torch.equal(x, x2) and torch.equal(y, y2)
    assert stream.state_dict()["served"] == 6
    ref = TokenLoader(path, batch_size=2, seq_len=16, seed=5, native=False)
    for x, _ in taken:
        np.testing.assert_array_equal(x.numpy(), ref.next_batch()[0])
    stream.close()
    loader.close()
    ref.close()
    with pytest.raises(TypeError, match="no cursor"):
        prefetch_to_device(iter([1]), device="cpu").state_dict()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_prefetch_lands_batches_in_order_through_pinned_rings(cuda, token_file):
    path, _ = token_file
    loader = TokenLoader(path, batch_size=4, seq_len=512, seed=2)
    ref = TokenLoader(path, batch_size=4, seq_len=512, seed=2)
    stream = loader.prefetched(size=2)
    transfer = stream._transfer
    for _ in range(12):
        x, y = next(stream)
        rx, ry = ref.next_batch()
        assert x.is_cuda and y.is_cuda
        # a consumer kernel on the current stream reads the batch after its copy
        assert torch.equal(x.cpu(), torch.from_numpy(rx)) and torch.equal((y + 0).cpu(), torch.from_numpy(ry))
    rings = list(transfer._rings.values())
    assert rings and all(len(r["bufs"]) == 4 and all(b[0].is_pinned() for b in r["bufs"]) for r in rings)
    assert os.path.basename(path) == "tokens.bin"
    stream.close()
    loader.close()
    ref.close()
