"""Times this tree's fp8 linear and grouped expert MLP beside an earlier
checkout's on one card.

    python3 tools/fp8_grouped_ab.py OTHER_CSRC [--only fp8|grouped]

OTHER_CSRC is a thunder_tpu_torch/csrc directory from before the fp8 linear
was split into a quantize pass and a wgmma/TMA product and the grouped MLP
into routes (both mma.sync kernels with cp.async or register stages), for
example the parent commit's, unpacked with
``git archive HEAD thunder_tpu_torch/csrc | tar -x -C build/parent``. Its
csrc/fp8_linear.cu and csrc/grouped_mlp.cu are built into a library of their
own; this tree's run through executors/cudaex.py. At chip_smoke.py's fp8
shapes (FP8_SHAPES, M = FP8_M, x in bf16 and f32, f32 weights) and grouped
shapes (GROUPED_SHAPES) each version is checked against the plain version
(fp8: codes and amaxes equal, y as |err| / max(1, |plain|); grouped: max
|err| / max |plain|) and timed as chip_smoke.py times kernels (CUDA graph,
inputs rotated past the L2), in turns: other, this tree, this tree, other.
This tree's kernels are also timed stage by stage (torch.profiler: the fp8
quantize pass and product, the grouped gate and down stages), and the fp8
product's variants (FP8_VARIANTS: e4m3 or f16 tensor-core products, their
sums promoted into f32 registers every 16, 32 or 128 k, or not at all) are
checked and timed. Prints one JSON line a case,
the registers ptxas gave each kernel, and the card's name and power limit.
Needs a CUDA card and nvcc."""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from thunder_tpu_torch.executors import cudaex  # noqa: E402



def build_other(csrc: Path, out: Path):
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libfp8_grouped.so"
    subprocess.run([cudaex._nvcc(), *cudaex.NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(csrc / "fp8_linear.cu"), str(csrc / "grouped_mlp.cu")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib.resolve()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.tt_fp8_linear.argtypes = [p] * 8 + [i] * 5 + [f, p]
    so.tt_grouped_mlp.argtypes = [p] * 7 + [i] * 5 + [p]
    so.tt_fp8_linear.restype = so.tt_grouped_mlp.restype = i
    return so


def other_fp8(so):
    def fn(x, w, sx, sw):
        M, K = x.shape
        N = w.shape[0]
        y = torch.empty((M, N), dtype=x.dtype, device=x.device)
        amax = torch.zeros(2, device=x.device)
        xq = torch.empty((M, K), dtype=torch.float8_e4m3fn, device=x.device)
        wq = torch.empty((N, K), dtype=torch.float8_e4m3fn, device=x.device)
        rc = so.tt_fp8_linear(x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), y.data_ptr(),
                              xq.data_ptr(), wq.data_ptr(), amax.data_ptr(), M, N, K,
                              cudaex._DTYPE_CODE[x.dtype], cudaex._DTYPE_CODE[w.dtype], 448.0,
                              torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fp8_linear launch failed: CUDA error {rc}")
        return y, xq, wq, amax[0], amax[1]
    return fn


# csrc/fp8_linear.cu's product variants (tt_fp8_linear_variant)
FP8_VARIANTS = {"e4m3_promote32": 0, "e4m3_promote128": 1, "f16_acc": 2, "f16_promote32": 3}


def tree_fp8_variant(variant: int):
    def fn(x, w, sx, sw):
        M, K = x.shape
        N = w.shape[0]
        y = torch.empty((M, N), dtype=x.dtype, device=x.device)
        amax = torch.zeros(2, device=x.device)
        xq = torch.empty((M, K), dtype=torch.float8_e4m3fn, device=x.device)
        wq = torch.empty((N, K), dtype=torch.float8_e4m3fn, device=x.device)
        xh = torch.empty((M, K), dtype=torch.float16, device=x.device)
        wh = torch.empty((N, K), dtype=torch.float16, device=x.device)
        rc = cudaex._library().tt_fp8_linear_variant(
            x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), y.data_ptr(), xq.data_ptr(), wq.data_ptr(),
            xh.data_ptr(), wh.data_ptr(), amax.data_ptr(), M, N, K, cudaex._DTYPE_CODE[x.dtype],
            cudaex._DTYPE_CODE[w.dtype], 448.0, variant, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"fp8_linear variant {variant} launch failed: CUDA error {rc}")
        return y, xq, wq, amax[0], amax[1]
    return fn


def other_grouped(so):
    def fn(bins, wg, wu, wd, gs):
        E, cap, D = bins.shape
        H = wg.shape[-1]
        gs = gs.to(torch.int32)
        y = torch.empty_like(bins)
        h = torch.empty((E, cap, H), dtype=bins.dtype, device=bins.device)
        rc = so.tt_grouped_mlp(bins.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), gs.data_ptr(),
                               h.data_ptr(), y.data_ptr(), E, cap, D, H, cudaex._DTYPE_CODE[bins.dtype],
                               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"grouped_mlp launch failed: CUDA error {rc}")
        return y
    return fn


def fp8_err(got, want) -> dict:
    codes = (torch.equal(got[1].view(torch.uint8), want[1].view(torch.uint8))
             and torch.equal(got[2].view(torch.uint8), want[2].view(torch.uint8)))
    amax = got[3].item() == want[3].item() and got[4].item() == want[4].item()
    return {"codes_and_amaxes_equal": codes and amax, "err_over_max1": cs.flash_err(got[0], want[0])[1]}


def in_turns(fns: dict, sets, iters: int = 50) -> list:
    return [(name, cs.cuda_ms(fns[name], sets, iters=iters)[0]) for name in ("other", "tree", "tree", "other")]


def run_fp8(so, dev, gen):
    fns = {"other": other_fp8(so), "tree": lambda *a: cudaex.fp8_linear(*a, save_quantized=True)}
    for label, (N, K) in cs.FP8_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            M = cs.FP8_M
            args = cs.fp8_inputs(dev, gen, dt, M, N, K)
            want = cudaex.fp8_linear_plain(*args, save_quantized=True)
            errs = {name: fp8_err(fn(*args), want) for name, fn in fns.items()}
            for name, v in FP8_VARIANTS.items():
                errs[name] = fp8_err(tree_fp8_variant(v)(*args), want)
            del args, want
            sets = cs.copies(lambda: cs.fp8_inputs(dev, gen, dt, M, N, K), M * K * dt.itemsize + N * K * 4)
            nbytes, ops = cs.fp8_work(M, N, K, dt.itemsize)
            bound, by = cs.bound_ms(nbytes, ops, "float8")
            print(json.dumps({"kernel": "fp8_linear", "case": label, "M": M, "N": N, "K": K, "x": cs.dname(dt),
                              "ms_in_turns": in_turns(fns, sets), "bound_ms": bound, "bound_by": by,
                              "variants_ms": {name: cs.cuda_ms(tree_fp8_variant(v), sets, iters=50)[0]
                                              for name, v in FP8_VARIANTS.items()},
                              "tree_ms_by_stage": cs.kernel_ms(fns["tree"], sets, cs.FP8_STAGES),
                              "checks": errs}), flush=True)
            del sets
            torch.cuda.empty_cache()


def run_grouped(so, dev, gen):
    fns = {"other": other_grouped(so), "tree": cudaex.grouped_mlp}
    for label, (cap, dt, gs) in cs.GROUPED_SHAPES.items():
        args = cs.grouped_inputs(dev, gen, dt, cap, gs)
        want = cudaex.grouped_mlp_plain(*args)
        scale = want.float().abs().max().item()
        errs = {name: (fn(*args).float() - want.float()).abs().max().item() / scale for name, fn in fns.items()}
        del args, want
        nbytes, ops = cs.grouped_work(cap, gs, dt.itemsize)
        bound, by = cs.bound_ms(nbytes, ops, cs.dname(dt))
        sets = cs.copies(lambda: cs.grouped_inputs(dev, gen, dt, cap, gs), nbytes)
        plan = cudaex.grouped_mlp_plan(cs.GROUPED_E, cap, cs.GROUPED_D, cs.GROUPED_H, dt)
        print(json.dumps({"kernel": "grouped_mlp", "case": label, "cap": cap, "dtype": cs.dname(dt),
                          "route": plan["route"], "ms_in_turns": in_turns(fns, sets), "bound_ms": bound,
                          "bound_by": by,
                          "tree_ms_by_stage": cs.kernel_ms(fns["tree"], sets, cs.grouped_stages(plan["route"])),
                          "bmm_chain_ms": cs.cuda_ms(cs.bmm_chain, sets, iters=50)[0],
                          "err_over_max_plain": errs}), flush=True)
        del sets
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", type=Path)
    ap.add_argument("--only", choices=("fp8", "grouped"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fp8_grouped_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = cudaex.build()
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    cudaex._library().tt_fp8_linear_variant.argtypes = [p] * 10 + [i] * 5 + [f, i, p]
    ptxas, entry = [], None
    for ln in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif ("Used" in ln or "spill" in ln) and entry and ("fp8_linear" in entry or "grouped_mlp" in entry):
            ptxas.append([entry, ln.split(":", 1)[-1].strip()])
    print(json.dumps({"ptxas": ptxas}), flush=True)
    so = build_other(args.other_csrc, Path("build") / "fp8_grouped_ab")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.only in (None, "fp8"):
        run_fp8(so, dev, gen)
    if args.only in (None, "grouped"):
        run_grouped(so, dev, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
