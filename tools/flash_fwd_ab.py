"""Times this tree's flash forward beside another checkout's on one card.

    python3 tools/flash_fwd_ab.py OTHER_CSRC [OTHER_CSRC ...]

Each OTHER_CSRC is a thunder_tpu_torch/csrc directory, for example the
parent commit's, unpacked with
``git archive HEAD thunder_tpu_torch/csrc | tar -x -C build/parent``. Its
flash forward (csrc/flash_fwd_sm90.cu with its f32 kernel where present, else
csrc/flash_rope_fwd.cu, whose tt_flash_rope_fwd takes no scratch) is built
into a library of its own; this tree's runs through executors/cudaex.py. At
chip_smoke.py's five forward shapes (and llama-350m's without RoPE) each
version is checked against the plain version (o on grad_err's measures, lse
max |err|) and timed as chip_smoke.py times kernels (bf16, CUDA graph,
inputs rotated past the L2), in turns: others, this tree, this tree, others
reversed, then SDPA. Prints the HGMMA (wgmma) instructions that
``cuobjdump -sass`` finds in each instance of this tree's forward core, one
JSON line a shape, and the card's name and power limit. Needs a CUDA card
and nvcc."""
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

SHAPES = (("llama-350m", dict(B=4, H=16, Hkv=16, T=2048, D=64), True, True),
          ("llama-350m-norope", dict(B=4, H=16, Hkv=16, T=2048, D=64), True, False),
          ("llama-1b", dict(B=1, H=16, Hkv=4, T=2048, D=128), True, True),
          ("nanogpt-124m", dict(B=8, H=12, Hkv=12, T=1024, D=64), True, False),
          ("llama-1b-causal", dict(B=1, H=16, Hkv=4, T=2048, D=128), True, False),
          ("llama-1b-full", dict(B=1, H=16, Hkv=4, T=2048, D=128), False, False))


def build_other(csrc: Path, out: Path):
    """(library, takes scratch) of csrc's flash forward sources."""
    scratch = (csrc / "flash_fwd_sm90.cu").exists()
    sources = [csrc / "flash_fwd_sm90.cu", csrc / "flash_rope_fwd.cu"] if scratch else [csrc / "flash_rope_fwd.cu"]
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libflash_fwd.so"
    subprocess.run([cudaex._nvcc(), *cudaex.NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, sources)],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib.resolve()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.tt_flash_rope_fwd.argtypes = [p] * (8 if scratch else 7) + [i] * (7 if scratch else 6) + [f, i, p]
    so.tt_flash_fwd.argtypes = [p] * 5 + [i] * 6 + [f, i, p]
    so.tt_flash_rope_fwd.restype = so.tt_flash_fwd.restype = i
    return so, scratch


def other_forward(so, scratch: bool, causal: bool):
    def fwd(q, k, v, cos=None, sin=None):
        B, H, T, D = q.shape
        Hkv = k.shape[1]
        o, lse = torch.empty_like(q), torch.empty(B, H, T, device=q.device)
        args = (B, H, Hkv, T, D, int(causal), cudaex.LOG2E / math.sqrt(D), cudaex._DTYPE_CODE[q.dtype],
                torch.cuda.current_stream().cuda_stream)
        ptrs = [t.data_ptr() for t in (q, k, v)]
        if cos is None:
            rc = so.tt_flash_fwd(*ptrs, o.data_ptr(), lse.data_ptr(), *args)
        elif scratch:
            buf = torch.empty(B * (H + Hkv) * T, D, dtype=q.dtype, device=q.device)
            rc = so.tt_flash_rope_fwd(*ptrs, cos.data_ptr(), sin.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                      buf.data_ptr(), buf.shape[0], *args)
        else:
            rc = so.tt_flash_rope_fwd(*ptrs, cos.data_ptr(), sin.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                      *args)
        if rc:
            raise RuntimeError(f"flash forward launch failed: CUDA error {rc}")
        return o, lse
    return fwd


def main() -> int:
    others = [Path(a) for a in sys.argv[1:]]
    if not torch.cuda.is_available():
        print("flash_fwd_ab: no CUDA device", file=sys.stderr)
        return 1
    lib = cudaex.build()
    cudaex._library()
    sass = subprocess.run([str(Path(cudaex._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    hgmma, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :")[1].strip()
        elif func and "flash_fwd_core" in func and "HGMMA" in line:
            hgmma[func] = hgmma.get(func, 0) + 1
    print(json.dumps({"hgmma_in_flash_fwd_core": hgmma}), flush=True)
    libs = {f"other{j}": build_other(d, Path("build") / f"flash_fwd_ab{j}") for j, d in enumerate(others)}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    order = list(libs) + ["tree", "tree"] + list(libs)[::-1]
    for label, shp, causal, rope in SHAPES:
        fk = cs.FlashKernels(cudaex, rope, causal)
        fns = {"tree": fk.fwd, **{n: other_forward(*lib, causal) for n, lib in libs.items()}}
        a = cs.flash_inputs(dev, gen, torch.bfloat16, **shp)
        ro, rlse = fk.fwd_plain(*fk.fwd_args(a))
        errs = {}
        for name, fn in fns.items():
            o, lse = fn(*fk.fwd_args(a))
            errs[name] = cs.grad_err(o, ro)[1:] + [(lse - rlse).abs().max().item()]
        B, H, Hkv, T, D = (shp[x] for x in ("B", "H", "Hkv", "T", "D"))
        sets = cs.copies(lambda: cs.flash_inputs(dev, gen, torch.bfloat16, **shp), 2 * (B * H + B * Hkv) * T * D * 2)
        ms = [(name, cs.cuda_ms(fns[name], [fk.fwd_args(x) for x in sets], iters=50)[0]) for name in order]
        pre = [fk.library_inputs(x) for x in sets]
        sdpa = cs.cuda_ms(lambda q, k, v, do: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=H != Hkv), pre, iters=50)[0]
        print(json.dumps({"shape": label, "ms_in_turns": ms, "sdpa_ms": sdpa, "errs": errs,
                          "errs_are": "[max/max|ref|, l2/l2 ref, worst row l2/l2 ref, lse max abs]"}), flush=True)
        del sets, pre
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
