"""Times this tree's ring forward step and paged chunk attention beside an
earlier checkout's on one card.

    python3 tools/ring_chunk_ab.py OTHER_CSRC

OTHER_CSRC is a thunder_tpu_torch/csrc directory from before the bf16 ring
forward moved onto the flash forward's wgmma/TMA core (one mma.sync block
per 128 query rows) and before chunk attention was split over the keys (one
block per 64 query rows, kv head and sequence, walking every key), for
example the parent commit's, unpacked with ``git archive HEAD
thunder_tpu_torch/csrc | tar -x -C build/parent``. Its
csrc/ring_flash_fwd.cu and csrc/paged_chunk_attention.cu are built into a
library of their own; this tree's run through executors/cudaex.py. At
chip_smoke.py's ring steps (cp_train's diagonal step at T=8192; the
four-shard ring's diagonal, past and future steps at T_blk=2048; its GQA
D=128 diagonal step; bf16) and chunk shapes (CHUNK_POS: chunks of 256 from
0, 1024 and 1792, ragged verify rows; Llama-3-1B heads, bf16) each version
is checked against the plain version and timed as chip_smoke.py times
kernels (CUDA graph, inputs rotated past the L2), in turns: other, this
tree, this tree, other. Prints one JSON line a case and the card's name and
power limit. Needs a CUDA card and nvcc.

    python3 tools/ring_chunk_ab.py --sweep

times this tree's chunk kernels alone at CHUNK_POS on each route
paged_chunk_plan could choose (the split kernel at 16 or 64 rows a block
with splits of 128 to 2,048 keys; the flash forward core in paged mode,
128 rows, no split), each beside the plan's own choice, with each
kernel's device ms (torch.profiler)."""
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
    lib = out / "libring_chunk.so"
    subprocess.run([cudaex._nvcc(), *cudaex.NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(csrc / "ring_flash_fwd.cu"), str(csrc / "paged_chunk_attention.cu")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib.resolve()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.tt_ring_flash_fwd.argtypes = [p] * 6 + [i] * 8 + [f, i, p]
    so.tt_paged_chunk_attention.argtypes = [p] * 6 + [i] * 7 + [f, i, p]
    so.tt_ring_flash_fwd.restype = so.tt_paged_chunk_attention.restype = i
    return so


def other_ring(so):
    def fn(q, kb, vb, o, m, l, q_off, k_off, causal):
        B, H, T, D = q.shape
        rc = so.tt_ring_flash_fwd(*(t.data_ptr() for t in (q, kb, vb, o, m, l)), B, H, kb.shape[1], T, D,
                                  q_off, k_off, int(causal), cudaex.LOG2E / math.sqrt(D),
                                  cudaex._DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ring_flash_fwd launch failed: CUDA error {rc}")
        return o, m, l
    return fn


def other_chunk(so):
    def fn(q, kp, vp, pt, qpos):
        B, H, T, D = q.shape
        P, ps, Hkv, _ = kp.shape
        out = torch.empty_like(q)
        rc = so.tt_paged_chunk_attention(*(t.data_ptr() for t in (q, kp, vp, pt, qpos, out)), B, H, Hkv, T,
                                         D, ps, pt.shape[1], cudaex.LOG2E / math.sqrt(D),
                                         cudaex._DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"paged_chunk_attention launch failed: CUDA error {rc}")
        return out
    return fn


def rel(got, want) -> float:
    """max |err| / max |plain| over the tensors (o/l, m, l for a ring step)."""
    return max(((g.float() - w.float()).abs().max() / w.float().abs().max().clamp(min=1e-30)).item()
               for g, w in zip(got, want))


def in_turns(fns: dict, sets) -> list:
    return [(name, cs.cuda_ms(fns[name], sets, iters=50)[0]) for name in ("other", "tree", "tree", "other")]


def chunk_with(rows: int, split: int):
    """cudaex.paged_chunk_attention's launch with these rows a block and
    split in place of the plan's (128 rows: the core, which takes no
    split)."""
    def fn(q, kp, vp, pt, qpos):
        B, H, T, D = q.shape
        P, ps, Hkv, _ = kp.shape
        n_split = 1 if rows == 128 else -(-pt.shape[1] * ps // split)
        out = torch.empty_like(q)
        part = torch.empty((B, H, T, n_split, D + 2), device=q.device) if n_split > 1 else None
        rc = cudaex._library().tt_paged_chunk_attention(
            *(t.data_ptr() for t in (q, kp, vp, pt, qpos, out)), part.data_ptr() if part is not None else None,
            B, H, Hkv, T, D, P, ps, pt.shape[1], rows, split, cudaex.LOG2E / math.sqrt(D),
            cudaex._DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"paged_chunk_attention launch failed: CUDA error {rc}")
        return out
    return fn


def sweep(dev, gen) -> None:
    for label, qp in cs.CHUNK_POS.items():
        args = cs.chunk_inputs(dev, gen, torch.bfloat16, qp)
        want = cudaex.paged_chunk_attention_plain(*args).float()
        sets = cs.copies(lambda: cs.chunk_inputs(dev, gen, torch.bfloat16, qp), 2 * 1025 * 16 * 8 * 64 * 2)
        plan = cudaex.paged_chunk_plan(qp.shape[0], 32, 8, qp.shape[1], 64, 16, 128, torch.bfloat16)
        rows_set = (16, 64, 128) if plan["route"] == "verify" else (64, 128)
        for rows in rows_set:
            for split in ((2048,) if rows == 128 else (128, 256, 512, 1024, 2048)):
                fn = chunk_with(rows, split)
                err = (fn(*args).float() - want).abs().max().item()
                print(json.dumps({"kernel": "paged_chunk_attention", "case": label, "rows_per_block": rows,
                                  "split_tokens": split, "plan": (plan["rows_per_block"], plan["split_tokens"]),
                                  "ms": cs.cuda_ms(fn, sets, iters=50)[0], "max_abs_err": err,
                                  "device_ms_by_kernel": cs.kernel_ms(fn, sets, cs.PAGED_KERNELS)}), flush=True)
        del sets, args
        torch.cuda.empty_cache()


def main() -> int:
    if sys.argv[1:] == ["--sweep"] and torch.cuda.is_available():
        cudaex._library()
        sweep(torch.device("cuda"), torch.Generator(device="cuda").manual_seed(0))
        return 0
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("ring_chunk_ab: needs OTHER_CSRC and a CUDA device", file=sys.stderr)
        return 1
    cudaex.build()
    cudaex._library()
    so = build_other(Path(sys.argv[1]), Path("build") / "ring_chunk_ab")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {"other": other_ring(so), "tree": cudaex.ring_flash_step}
    for label, shp, T, kind in RING_CASES:
        B, H, Hkv, D = (shp[x] for x in ("B", "H", "Hkv", "D"))
        q_off, k_off = {"diagonal": (T, T), "past": (T, 0), "future": (0, T)}[kind]

        def make():
            q, k, v, _ = cs.ring_inputs(dev, gen, torch.bfloat16, B, H, Hkv, D, T)
            o, m, l = cudaex.ring_flash_step_plain(q, k, v, *cs.ring_state(q), T, T, True)
            return q, k, v, o.contiguous(), m.contiguous(), l.contiguous(), q_off, k_off, True

        sets = cs.copies(make, (6 * B * H + 4 * B * Hkv) * T * D)  # q, k, v, o, as made
        q, k, v, o, m, l = sets[0][:6]
        want = cudaex.ring_flash_step_plain(q, k, v, o.clone(), m.clone(), l.clone(), q_off, k_off)
        errs = {}
        for name, fn in fns.items():
            got = fn(q, k, v, o.clone(), m.clone(), l.clone(), q_off, k_off, True)
            errs[name] = (rel((got[0] / got[2], got[1], got[2]), (want[0] / want[2], want[1], want[2]))
                          if kind != "future" else
                          max((g - w).abs().max().item() for g, w in zip(got, (o, m, l))))
        print(json.dumps({"kernel": "ring_flash_fwd", "case": label, "ms_in_turns": in_turns(fns, sets),
                          "err_over_max_plain" if kind != "future" else "max_abs_change": errs}), flush=True)
        del sets, want
        torch.cuda.empty_cache()
    fns = {"other": other_chunk(so), "tree": cudaex.paged_chunk_attention}
    for label, qp in cs.CHUNK_POS.items():
        args = cs.chunk_inputs(dev, gen, torch.bfloat16, qp)
        want = cudaex.paged_chunk_attention_plain(*args).float()
        errs = {name: (fn(*args).float() - want).abs().max().item() for name, fn in fns.items()}
        sets = cs.copies(lambda: cs.chunk_inputs(dev, gen, torch.bfloat16, qp), 2 * 1025 * 16 * 8 * 64 * 2)
        plan = cudaex.paged_chunk_plan(*qp.shape[:1], 32, 8, qp.shape[1], 64, 16, 128, torch.bfloat16)
        print(json.dumps({"kernel": "paged_chunk_attention", "case": label, "route": plan["route"],
                          "n_split": plan["n_split"], "ms_in_turns": in_turns(fns, sets),
                          "max_abs_err": errs}), flush=True)
        del sets, args
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
