"""Times this tree's weight-only int8 and NF4 linears beside an earlier
checkout's on one card.

    python3 tools/quant_ab.py OTHER_CSRC

OTHER_CSRC is a thunder_tpu_torch/csrc directory from before the linears
took cudaex.weight_only_plan's routes (one mma.sync kernel for every bf16
call: 16 x 16 blocks whose 8 warps split K at decode, 64 x 32 blocks at
prefill), for example the parent commit's, unpacked with ``git archive HEAD
thunder_tpu_torch/csrc | tar -x -C build/parent``. Its csrc/int8_linear.cu
and csrc/nf4_linear.cu (with csrc/weight_only_linear.cuh) are built into a
library of their own; this tree's run through executors/cudaex.py. At
chip_smoke.py's QUANT_CASES (Llama-3-1B's decode linears at the serving
batch, and prefill buckets of 256 and 512 rows; bf16 x) each version is
checked against the plain version (|err| / max(1, |plain|) within
chip_smoke.py's KERNEL_TOL) and timed as chip_smoke.py times kernels (CUDA
graph, inputs rotated past the L2), in turns: other, this tree, this tree,
other. Prints one JSON line a case, with this tree's route, K splits and
blocks, the bound and each version's share of it, and the card's name and
power limit. Needs a CUDA card and nvcc.

    python3 tools/quant_ab.py --sweep

times this tree's decode cases alone on the stream route with 16-row
blocks and 4, 8 or 16 ring stages, and 64-row blocks and 1, 2, 4 or 8, in
place of the plan's.

    python3 tools/quant_ab.py --f32 OTHER_CSRC

times f32 x: OTHER_CSRC's f32 route (a checkout whose entry points take
(x, weights, y, partial, counters, M, N, K, [block_k,] dtype, route, ...)
and run the FMA kernel on route 0, as before the split route: ``git
archive <commit> thunder_tpu_torch/csrc | tar -x -C build/parent``)
against this tree's f32 route and, where that is not the split route's
64-token tiles, those too (int8's 16- and 128-token tiles; NF4's FMA
kernel at M <= 16), at F32_CASES: quant_train's two shapes at 512 rows and
the f32 decode shapes of the agreement phases (int8 at 8 rows, NF4 at 4),
then each kind's f32 decode step (DECODE_STEP) summed. Each is checked
against the plain version (chip_smoke.py's KERNEL_TOL["float32"]) and
timed in turns, other, this tree, its variant, then back; each line
carries the bound (bf16 split operations: passes x 2MNK at 989 TFLOP/s,
against the bytes; and the f32-FMA bound) and the card's
name and power limit."""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from thunder_tpu_torch.executors import cudaex  # noqa: E402
from thunder_tpu_torch.transforms.quantization import nf4_kernel_block_k  # noqa: E402


def build_other(csrc: Path, out: Path):
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libquant_ab.so"
    subprocess.run([cudaex._nvcc(), *cudaex.NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(csrc / "int8_linear.cu"), str(csrc / "nf4_linear.cu")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib.resolve()))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.tt_int8_linear.argtypes = [p] * 4 + [i] * 4 + [p]
    so.tt_nf4_linear.argtypes = [p] * 4 + [i] * 5 + [p]
    so.tt_int8_linear.restype = so.tt_nf4_linear.restype = i
    return so


def other_fn(so, kind: str):
    """The earlier kernel behind the same arguments as cudaex's wrapper."""
    def fn(x, w, s):
        M, K = x.shape
        N = w.shape[0]
        y = torch.empty((M, N), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        code = cudaex._DTYPE_CODE[x.dtype]
        if kind == "int8":
            rc = so.tt_int8_linear(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), M, N, K, code, stream)
        else:
            rc = so.tt_nf4_linear(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), M, N, K,
                                  nf4_kernel_block_k(K), code, stream)
        if rc:
            raise RuntimeError(f"{kind}_linear (other) launch failed: CUDA error {rc}")
        return y
    return fn


def with_plan(kind: str, split: bool = False, **over):
    """cudaex's launch of this tree's kernel with the plan's entries in
    `over` replaced (stream: rows and stages; split: tile_m and stages);
    split: the split route's plan (f32 x) where the plan would take fma."""
    def fn(x, w, s):
        M, K = x.shape
        N = w.shape[0]
        plan = dict(cudaex.weight_only_plan(kind, max(M, 17) if split else M, N, K, x.dtype), **over)
        if split:
            plan["scratch"] = {"pieces": ((3, M, K), torch.bfloat16)}
        if over.get("tile_m"):  # the tiles, K splits and blocks that follow from it
            tiles = -(-M // plan["tile_m"]) * -(-N // plan["rows"])
            units = -(-(K if kind == "int8" else K // 2) // 64)
            plan["splits"], plan["units_per_split"] = cudaex._balanced_splits(
                units, max(1, min(cudaex.H100_SMS // tiles, units // cudaex._WGMMA_MIN_UNITS)))
            plan["grid"] = (min(tiles * plan["splits"], cudaex.H100_SMS),)
            plan["counters"] = tiles if plan["splits"] > 1 else 0
            plan["scratch"] = {k: v for k, v in plan["scratch"].items() if k != "partial"}
            if plan["splits"] > 1:
                plan["scratch"]["partial"] = ((plan["splits"], M, N), torch.float32)
        y = torch.empty((M, N), dtype=x.dtype, device=x.device)
        extra = () if kind == "int8" else (nf4_kernel_block_k(K),)
        entry = cudaex._library().tt_int8_linear if kind == "int8" else cudaex._library().tt_nf4_linear
        scratch = cudaex._wol_scratch(plan, x.device)  # held until the launch is enqueued
        rc = entry(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
                   *cudaex._wol_args(plan, scratch, M, N, K, *extra, cudaex._DTYPE_CODE[x.dtype]),
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{kind}_linear launch failed: CUDA error {rc}")
        return y
    return fn


def sweep(dev, gen) -> None:
    """This tree's decode cases on the stream route with 16- and 64-row
    blocks and several ring depths."""
    for kind in ("int8", "nf4"):
        plain = cudaex.int8_linear_plain if kind == "int8" else cudaex.nf4_linear_plain
        for label, M, N, K in cs.QUANT_CASES[kind]:
            if M > 16:
                continue
            def make(real):
                if kind == "int8":
                    return cs.int8_inputs(dev, gen, torch.bfloat16, M, N, K)
                return cs.nf4_inputs(dev, gen, torch.bfloat16, M, N, K, real)
            nbytes, _ = cs.quant_work(kind, M, N, K)
            sets = cs.copies(lambda: make(False), nbytes)
            args = make(True)
            want = plain(*args)
            res = {}
            for rows, stages in ((16, (4, 8, 16)), (64, (1, 2, 4, 8))):
                for st in stages:  # (16-row blocks take at most 8 stages, or 16)
                    fn = with_plan(kind, rows=rows, stages=st)
                    try:
                        err = cs.flash_err(fn(*args), want)[1]
                        res[f"{rows}x{st}"] = (cs.cuda_ms(fn, sets, iters=100)[0], err)
                    except RuntimeError as e:
                        res[f"{rows}x{st}"] = (None, str(e))
            plan = cudaex.weight_only_plan(kind, M, N, K, torch.bfloat16)
            print(json.dumps({"kernel": f"{kind}_linear", "case": label, "plan": [plan["rows"], plan["stages"]],
                              "ms_by_rows_x_stages": res}), flush=True)
            del sets
            torch.cuda.empty_cache()


# (kind, label, M, N, K) of the f32 A/B: quant_train's fc_1 (int8) and
# mlp_proj (NF4) at 512 rows; the agreement phases' f32 decode (int8 at 8
# rows, NF4 at 4) at every Llama-3-1B decode shape but fc_2 (fc_1's)
F32_CASES = ([("int8", "fc_1_train512", 512, 8192, 2048), ("nf4", "mlp_proj_train512", 512, 2048, 8192)]
             + [(kind, label, M, *cs.QUANT_SHAPES[label]) for kind, M in (("int8", 8), ("nf4", 4))
                for label in ("attn", "attn_proj", "fc_1", "mlp_proj", "lm_head")])
# a decode step's linears: each layer's attn, attn_proj, fc_1, fc_2 (fc_1's
# shape) and mlp_proj, and lm_head once
DECODE_STEP = {"attn": 16, "attn_proj": 16, "fc_1": 32, "mlp_proj": 16, "lm_head": 1}


def build_other_f32(csrc: Path, out: Path):
    """OTHER_CSRC's int8/NF4 linears with the plan arguments (no pieces)."""
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libquant_ab_f32.so"
    subprocess.run([cudaex._nvcc(), *cudaex.NVCC_FLAGS, "-shared", "-o", str(lib),
                    str(csrc / "int8_linear.cu"), str(csrc / "nf4_linear.cu")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib.resolve()))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.tt_int8_linear.argtypes = [p] * 6 + [i] * 11 + [p]
    so.tt_nf4_linear.argtypes = [p] * 6 + [i] * 12 + [p]
    so.tt_int8_linear.restype = so.tt_nf4_linear.restype = i
    return so


def other_f32_fn(so, kind: str):
    """OTHER_CSRC's f32 route (route 0; the plan's other arguments unread)."""
    def fn(x, w, s):
        M, K = x.shape
        N = w.shape[0]
        y = torch.empty((M, N), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        extra = () if kind == "int8" else (nf4_kernel_block_k(K),)
        entry = so.tt_int8_linear if kind == "int8" else so.tt_nf4_linear
        rc = entry(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), None, None, M, N, K, *extra,
                   cudaex._DTYPE_CODE[torch.float32], 0, 0, 0, 1, 1, 1, 0, stream)
        if rc:
            raise RuntimeError(f"{kind}_linear (other, f32) launch failed: CUDA error {rc}")
        return y
    return fn


def f32_ab(csrc: Path, card: str) -> None:
    """Prints a line a case, then a line a kind: the f32 decode step's
    linears (DECODE_STEP) summed, each version's device ms."""
    step = {}
    so = build_other_f32(csrc, Path("build") / "quant_ab")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = cs.KERNEL_TOL["float32"]
    for kind, label, M, N, K in F32_CASES:
        fns = {"other": other_f32_fn(so, kind), "tree": cudaex.int8_linear if kind == "int8" else cudaex.nf4_linear}
        tree_plan = cudaex.weight_only_plan(kind, M, N, K, torch.float32)
        if tree_plan["tile_m"] != 64:
            # the split route's 64-token tiles in place of the plan's 16 or 128
            # tiles, or (NF4 at M <= 16) of its FMA kernel, in the same turns
            fns["tree_split64"] = with_plan(kind, split=tree_plan["route"] == "fma", tile_m=64,
                                            stages=cudaex._WGMMA_STAGES[("split", kind, 64)])
        plain = cudaex.int8_linear_plain if kind == "int8" else cudaex.nf4_linear_plain

        def make(real):
            if kind == "int8":
                return cs.int8_inputs(dev, gen, torch.float32, M, N, K)
            return cs.nf4_inputs(dev, gen, torch.float32, M, N, K, real)

        args = make(True)
        want = plain(*args)
        errs = {name: cs.flash_err(fn(*args), want)[1] for name, fn in fns.items()}
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"{kind}_linear {label} f32: |err| / max(1, |plain|) {errs} above {tol}")
        nbytes, ops = cs.quant_work(kind, M, N, K, itemsize=4)
        bound, by = cs.quant_split_bound(kind, nbytes, ops)
        sets = cs.copies(lambda: make(False), nbytes)
        order = ["other", *[n for n in fns if n != "other"]]
        turns = [(name, cs.cuda_ms(fns[name], sets)[0]) for name in order + order[::-1]]
        mean = {name: sum(ms for n, ms in turns if n == name) / 2 for name in fns}
        plan = cudaex.weight_only_plan(kind, M, N, K, torch.float32)
        print(json.dumps({"kernel": f"{kind}_linear", "case": label, "dtype": "float32", "M": M, "N": N, "K": K,
                          "plan": {k: plan[k] for k in ("route", "tile_m", "splits", "blocks", "stages")},
                          "ms_in_turns": turns, "ms": mean, "bound_ms": bound, "bound_by": by,
                          "f32_fma_bound_ms": cs.bound_ms(nbytes, ops, "float32")[0],
                          "fraction_of_bound": {name: bound / ms for name, ms in mean.items()},
                          "err_over_max1": errs, "card": card}), flush=True)
        if label in DECODE_STEP:
            for name in fns:
                step.setdefault(kind, {}).setdefault(name, 0.0)
                step[kind][name] += DECODE_STEP[label] * mean[name]
        del sets, args, want
        torch.cuda.empty_cache()
    for kind, ms in step.items():
        print(json.dumps({"kernel": f"{kind}_linear", "case": "f32 decode step (DECODE_STEP)", "ms": ms,
                          "card": card}), flush=True)


def main() -> int:
    smi = "" if not torch.cuda.is_available() else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if len(sys.argv) == 3 and sys.argv[1] == "--f32" and torch.cuda.is_available():
        cudaex._library()
        f32_ab(Path(sys.argv[2]), smi)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--sweep"] and torch.cuda.is_available():
        cudaex._library()
        sweep(torch.device("cuda"), torch.Generator(device="cuda").manual_seed(0))
        return 0
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("quant_ab: needs OTHER_CSRC (or --f32 OTHER_CSRC) and a CUDA device", file=sys.stderr)
        return 1
    cudaex._library()
    so = build_other(Path(sys.argv[1]), Path("build") / "quant_ab")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = cs.KERNEL_TOL["bfloat16"]
    for kind in ("int8", "nf4"):
        fns = {"other": other_fn(so, kind), "tree": cudaex.int8_linear if kind == "int8" else cudaex.nf4_linear}
        plain = cudaex.int8_linear_plain if kind == "int8" else cudaex.nf4_linear_plain
        for label, M, N, K in cs.QUANT_CASES[kind]:
            def make(real):
                if kind == "int8":
                    return cs.int8_inputs(dev, gen, torch.bfloat16, M, N, K)
                return cs.nf4_inputs(dev, gen, torch.bfloat16, M, N, K, real)

            args = make(True)
            want = plain(*args)
            errs = {name: cs.flash_err(fn(*args), want)[1] for name, fn in fns.items()}
            if not all(e <= tol for e in errs.values()):
                raise AssertionError(f"{kind}_linear {label}: |err| / max(1, |plain|) {errs} above {tol}")
            nbytes, ops = cs.quant_work(kind, M, N, K)
            bound, by = cs.bound_ms(nbytes, ops, "bfloat16")
            sets = cs.copies(lambda: make(False), nbytes)
            turns = [(name, cs.cuda_ms(fns[name], sets)[0]) for name in ("other", "tree", "tree", "other")]
            mean = {name: sum(ms for n, ms in turns if n == name) / 2 for name in fns}
            print(json.dumps({"kernel": f"{kind}_linear", "case": label, "M": M, "N": N, "K": K,
                              "plan": cs.quant_plan(cudaex, kind, M, N, K), "ms_in_turns": turns,
                              "ms": mean, "bound_ms": bound, "bound_by": by,
                              "fraction_of_bound": {name: bound / ms for name, ms in mean.items()},
                              "err_over_max1": errs}), flush=True)
            del sets, args, want
            torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
