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
place of the plan's."""
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


def with_stages(kind: str, rows: int, stages: int):
    """cudaex's stream launch of this tree's kernel with `rows` weight rows
    a block and `stages` ring stages in place of the plan's."""
    def fn(x, w, s):
        M, K = x.shape
        N = w.shape[0]
        plan = dict(cudaex.weight_only_plan(kind, M, N, K, x.dtype))
        plan["rows"], plan["stages"] = rows, stages
        y = torch.empty((M, N), dtype=x.dtype, device=x.device)
        extra = () if kind == "int8" else (nf4_kernel_block_k(K),)
        entry = cudaex._library().tt_int8_linear if kind == "int8" else cudaex._library().tt_nf4_linear
        rc = entry(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
                   *cudaex._wol_args(plan, None, None, M, N, K, *extra, cudaex._DTYPE_CODE[x.dtype]),
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
                    fn = with_stages(kind, rows, st)
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


def main() -> int:
    if sys.argv[1:] == ["--sweep"] and torch.cuda.is_available():
        cudaex._library()
        sweep(torch.device("cuda"), torch.Generator(device="cuda").manual_seed(0))
        return 0
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("quant_ab: needs OTHER_CSRC and a CUDA device", file=sys.stderr)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
