"""Times this tree's paged decode and ring backward step beside an earlier
checkout's on one card.

    python3 tools/paged_ring_ab.py OTHER_CSRC

OTHER_CSRC is a thunder_tpu_torch/csrc directory from before the paged
decode was split across pages (one block per sequence and kv head, no
scratch) and before the bf16 ring backward moved onto the flash backward's
core (two mma.sync passes), for example the parent commit's, unpacked with
``git archive HEAD thunder_tpu_torch/csrc | tar -x -C build/parent``. Its
csrc/paged_attention.cu and csrc/ring_flash_bwd.cu are built into a library
of their own; this tree's run through executors/cudaex.py. At chip_smoke.py's
paged sets (PAGED_SETS: Llama-3-1B decode heads, bf16) and ring steps
(cp_train's diagonal step at T=8192; the four-shard ring's diagonal, past
and future steps at T_blk=2048; its GQA D=128 diagonal step; bf16) each
version is checked against the plain version (max |err| / max |plain|) and
timed as chip_smoke.py times kernels (CUDA graph, inputs rotated past the
L2), in turns: other, this tree, this tree, other. Prints one JSON line a
case and the card's name and power limit. Needs a CUDA card and nvcc."""
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from thunder_tpu_torch.executors import cudaex  # noqa: E402

RING_CASES = (("cp_train T=8192 diagonal", cs.RING_SHAPES["llama-350m"][0], cs.RING_CTX, "diagonal"),
              ("T_blk=2048 diagonal", cs.RING_SHAPES["llama-350m"][0], cs.RING_CTX // cs.RING_N, "diagonal"),
              ("T_blk=2048 past", cs.RING_SHAPES["llama-350m"][0], cs.RING_CTX // cs.RING_N, "past"),
              ("T_blk=2048 future", cs.RING_SHAPES["llama-350m"][0], cs.RING_CTX // cs.RING_N, "future"),
              ("gqa-d128 T_blk=2048 diagonal", cs.RING_SHAPES["gqa-d128"][0], cs.RING_CTX // cs.RING_N,
               "diagonal"))


def build_other(csrc: Path, out: Path):
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libpaged_ring.so"
    subprocess.run([cudaex._nvcc(), *cudaex.NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(csrc / "paged_attention.cu"), str(csrc / "ring_flash_bwd.cu")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib.resolve()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.tt_paged_attention.argtypes = [p] * 6 + [i] * 6 + [f, i, p]
    so.tt_ring_flash_bwd.argtypes = [p] * 9 + [i] * 8 + [f, f, i, p]
    so.tt_paged_attention.restype = so.tt_ring_flash_bwd.restype = i
    return so


def other_paged(so):
    def fn(q, kp, vp, pt, sl):
        B, H, D = q.shape
        P, ps, Hkv, _ = kp.shape
        out = torch.empty_like(q)
        rc = so.tt_paged_attention(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(), sl.data_ptr(),
                                   out.data_ptr(), B, Hkv, H // Hkv, D, ps, pt.shape[1],
                                   cudaex.LOG2E / math.sqrt(D), cudaex._DTYPE_CODE[q.dtype],
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"paged_attention launch failed: CUDA error {rc}")
        return out
    return fn


def other_ring_bwd(so):
    def fn(q, kb, vb, do, lse, delta, q_off, k_off, causal):
        B, H, T, D = q.shape
        dq = torch.empty(q.shape, device=q.device)
        dk, dv = torch.empty(kb.shape, device=q.device), torch.empty(kb.shape, device=q.device)
        scale = 1.0 / math.sqrt(D)
        rc = so.tt_ring_flash_bwd(*(t.data_ptr() for t in (q, kb, vb, do, lse, delta, dq, dk, dv)),
                                  B, H, kb.shape[1], T, D, q_off, k_off, int(causal), scale,
                                  scale * cudaex.LOG2E, cudaex._DTYPE_CODE[q.dtype],
                                  torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ring_flash_bwd launch failed: CUDA error {rc}")
        return dq, dk, dv
    return fn


def rel(got, want) -> float:
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
    return max(((g.float() - w.float()).abs().max() / w.float().abs().max().clamp(min=1e-30)).item()
               for g, w in zip(got, want))


def in_turns(fns: dict, sets) -> list:
    return [(name, cs.cuda_ms(fns[name], sets, iters=50)[0]) for name in ("other", "tree", "tree", "other")]


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("paged_ring_ab: needs OTHER_CSRC and a CUDA device", file=sys.stderr)
        return 1
    cudaex.build()
    cudaex._library()
    so = build_other(Path(sys.argv[1]), Path("build") / "paged_ring_ab")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {"other": other_paged(so), "tree": cudaex.paged_attention}
    for label, lens in cs.PAGED_SETS.items():
        args = cs.paged_inputs(dev, gen, torch.bfloat16, lens)
        want = cudaex.paged_attention_plain(*args)
        errs = {name: rel(fn(*args), want) for name, fn in fns.items()}
        sets = cs.copies(lambda: cs.paged_inputs(dev, gen, torch.bfloat16, lens), 2 * 1025 * 16 * 8 * 64 * 2)
        print(json.dumps({"kernel": "paged_attention", "case": label, "ms_in_turns": in_turns(fns, sets),
                          "err_over_max_plain": errs}), flush=True)
        del sets
    fns = {"other": other_ring_bwd(so), "tree": cudaex.ring_flash_bwd_step}
    for label, shp, T, kind in RING_CASES:
        B, H, Hkv, D = (shp[x] for x in ("B", "H", "Hkv", "D"))
        q_off, k_off = {"diagonal": (T, T), "past": (T, 0), "future": (0, T)}[kind]

        def make():
            q, k, v, do = cs.ring_inputs(dev, gen, torch.bfloat16, B, H, Hkv, D, T)
            o, m, l = cudaex.ring_flash_step_plain(q, k, v, *cs.ring_state(q), T, T, True)
            lse = ((m + torch.log2(l)) * cudaex.LN2).contiguous()
            delta = (do.float() * (o / l)).sum(-1, keepdim=True)
            return q, k, v, do, lse, delta, q_off, k_off, True

        sets = cs.copies(make, 8 * B * H * T * D + 1)
        want = cudaex.ring_flash_bwd_step_plain(*sets[0])
        errs = {name: rel(fn(*sets[0]), want) if kind != "future" else
                max(t.abs().max().item() for t in fn(*sets[0])) for name, fn in fns.items()}
        print(json.dumps({"kernel": "ring_flash_bwd", "case": label, "ms_in_turns": in_turns(fns, sets),
                          "err_over_max_plain" if kind != "future" else "max_abs": errs}), flush=True)
        del sets, want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
