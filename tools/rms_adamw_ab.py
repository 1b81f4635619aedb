"""Times this tree's rms_norm beside an earlier checkout's, and the one-pass
AdamW kernel beside the torch._foreach_* chain it replaced, on one card.

    python3 tools/rms_adamw_ab.py OTHER_CSRC

OTHER_CSRC is a thunder_tpu_torch/csrc directory from before rms_norm took
cudaex.rms_norm_plan's launches (one block a row, one 16-byte vector a
thread), for example unpacked with ``git archive 2ceb2a9
thunder_tpu_torch/csrc | tar -x -C build/parent``. Its csrc/rms_norm.cu is
built into a library of its own; this tree's runs through
executors/cudaex.py.

At chip_smoke.py's RMS_SHAPES (D=2048: bf16 at 1, 4, 8, 128, 512 and 1,024
rows, f32 at 512) each version is checked against the plain version
(KERNEL_TOL) and timed as chip_smoke.py times kernels (CUDA graph, inputs
rotated past the L2), in turns: other, this tree, this tree, other. Beside
them, this tree's kernel without programmatic dependent launch and with one
warp a row (4 rows a block), and an empty kernel's launch (the floor). Then
AdamW at the parameter shapes of moe_train's MoEGPT, train's llama-350m and
remat_train's llama-1b (f32 p and g): the chain
(cudaex.adamw_plain), the kernel, the kernel, the chain, and
torch._fused_adamw_ with the same hyper-parameters. Prints one JSON line a
case, with each bound, and the card's name and power limit. Needs a CUDA
card and nvcc.

    python3 tools/rms_adamw_ab.py --sweep

times this tree's rms_norm at RMS_SHAPES on every launch csrc/rms_norm.cu
takes (vectors a lane, warps a row, rows a block), with and without
programmatic dependent launch."""
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
    lib = out / "librms_ab.so"
    subprocess.run([cudaex._nvcc(), *cudaex.NVCC_FLAGS, "-shared", "-o", str(lib), str(csrc / "rms_norm.cu")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib.resolve()))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.tt_rms_norm.argtypes = [p, p, p, i, i, ctypes.c_float, i, p]
    so.tt_rms_norm.restype = i
    return so


def other_fn(so, eps):
    """The earlier kernel behind the same arguments as cudaex's wrapper."""
    def fn(x, w):
        y = torch.empty_like(x)
        rc = so.tt_rms_norm(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], eps,
                            cudaex._DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"rms_norm (other) launch failed: CUDA error {rc}")
        return y
    return fn


def variant_fn(eps, **changes):
    """This tree's kernel on rms_norm_plan's launch with `changes` applied."""
    def fn(x, w):
        y = torch.empty_like(x)
        cudaex._rms_launch(x, w, y, eps, dict(cudaex.rms_norm_plan(*x.shape, x.dtype), **changes))
        return y
    return fn


def launches(D: int, dtype) -> list:
    """Every (vpl, wpr, rows_per_block) csrc/rms_norm.cu takes for rows of
    D elements, with at least a vector a lane."""
    nvec = D // cudaex._vec(dtype)
    out = []
    for wpr in (1, 2, 4, 8, 16):
        vpl = next((v for v in (1, 2, 4, 8) if v * 32 * wpr >= nvec), None)
        if vpl is None or 32 * wpr > nvec:
            continue
        for rpb in (1, 2, 4, 8):
            if 32 * wpr * rpb <= 512 and (wpr == 1 or rpb <= 15):
                out.append(dict(vpl=vpl, wpr=wpr, rows_per_block=rpb))
    return out


def variants(N: int, dtype) -> dict:
    """The plan without programmatic dependent launch, and the launch of one
    warp a row, 4 rows a block (8 vectors a lane at D=2048 bf16)."""
    nvec = cs.RMS_D // cudaex._vec(dtype)
    out = {"no_pdl": dict(flags=0)}
    if nvec <= 256:
        out["warp_a_row"] = dict(vpl=next(v for v in (1, 2, 4, 8) if 32 * v >= nvec), wpr=1,
                                 rows_per_block=4 if N > cudaex._RMS_DECODE_ROWS else max(1, N))
    return out


def sweep(dev, gen) -> None:
    """This tree's kernel at RMS_SHAPES on every launch it takes, with and
    without programmatic dependent launch."""
    eps = 1e-5
    for N, dt in cs.RMS_SHAPES:
        D = cs.RMS_D
        nbytes, ops = cs.rms_work(N, D, dt.itemsize)
        sets = cs.copies(lambda: (torch.randn(N, D, device=dev, generator=gen).to(dt),
                                  torch.randn(D, device=dev, generator=gen).to(dt)), nbytes)
        want = cudaex.rms_norm_plain(*sets[0], eps).float()
        res = {}
        for launch in launches(D, dt):
            for flags in (0, cudaex.RMS_PDL):
                fn = variant_fn(eps, flags=flags, **launch)
                err = (fn(*sets[0]).float() - want).abs().max().item()
                if not err <= cs.KERNEL_TOL[cs.dname(dt)]:
                    raise AssertionError(f"rms_norm {launch} N={N} {dt}: max abs err {err}")
                key = f"vpl{launch['vpl']}_wpr{launch['wpr']}_rows{launch['rows_per_block']}_pdl{flags}"
                res[key] = cs.cuda_ms(fn, sets)[0]
        print(json.dumps({"kernel": "rms_norm", "sweep": True, "N": N, "D": D, "dtype": cs.dname(dt),
                          "plan": cudaex.rms_norm_plan(N, D, dt),
                          "ms": dict(sorted(res.items(), key=lambda kv: kv[1]))}), flush=True)


def rms_ab(so, dev, gen) -> None:
    eps = 1e-5
    for N, dt in cs.RMS_SHAPES:
        D = cs.RMS_D
        x = torch.randn(N, D, device=dev, generator=gen).to(dt)
        w = (1 + 0.1 * torch.randn(D, device=dev, generator=gen)).to(dt)
        want = cudaex.rms_norm_plain(x, w, eps).float()
        fns = {"other": other_fn(so, eps), "this": lambda a, b: cudaex.rms_norm(a, b, eps)}
        fns.update({k: variant_fn(eps, **v) for k, v in variants(N, dt).items()})
        errs = {}
        for name, fn in fns.items():
            errs[name] = (fn(x, w).float() - want).abs().max().item()
            if not errs[name] <= cs.KERNEL_TOL[cs.dname(dt)]:
                raise AssertionError(f"rms_norm {name} N={N} {dt}: max abs err {errs[name]}")
        nbytes, ops = cs.rms_work(N, D, dt.itemsize)
        b, by = cs.bound_ms(nbytes, ops, "float32" if dt == torch.float32 else "bfloat16")
        sets = cs.copies(lambda: (torch.randn(N, D, device=dev, generator=gen).to(dt),
                                  torch.randn(D, device=dev, generator=gen).to(dt)), nbytes)
        turns = {}
        for name in ("other", "this", "this", "other"):
            turns.setdefault(name, []).append(cs.cuda_ms(fns[name], sets)[0])
        for name in fns:
            if name not in turns:
                turns[name] = [cs.cuda_ms(fns[name], sets)[0]]
        print(json.dumps({"kernel": "rms_norm", "N": N, "D": D, "dtype": cs.dname(dt),
                          "plan": cudaex.rms_norm_plan(N, D, dt), "bound_ms": b, "bound_by": by,
                          "ms": turns, "share_of_bound": {k: b / (sum(v) / len(v)) for k, v in turns.items()},
                          "max_abs_err": errs}), flush=True)


def adamw_ab(dev, gen) -> None:
    h = cs.ADAMW_HYPER
    for which in ("moe", "llama-350m", "llama-1b"):
        shapes = cs.model_shapes(which)
        args = cs.adamw_inputs(dev, gen, shapes)
        ps, gs = args[0], args[1]
        nbytes = sum(p.numel() * (2 * p.element_size() + g.element_size() + 16) for p, g in zip(ps, gs))
        b, by = cs.bound_ms(nbytes, 15 * sum(p.numel() for p in ps), "float32")
        step = iter(range(1, 10 ** 6))
        step_t = torch.ones((), dtype=torch.int32, device=dev)  # the kernel reads its step on the card
        fns = {"chain": lambda *a: cudaex.adamw_plain(*a, step=next(step), **h),
               "kernel": lambda *a: cudaex.adamw_update(*a, step=step_t, **h)}
        turns = {}
        for name in ("chain", "kernel", "kernel", "chain"):
            turns.setdefault(name, []).append(cs.cuda_ms(fns[name], [args], iters=5)[0])
        steps = [torch.ones((), device=dev) for _ in ps]
        turns["torch._fused_adamw_"] = [cs.cuda_ms(
            lambda *a: torch._fused_adamw_(*a, [], steps, lr=h["lr"], beta1=h["beta1"], beta2=h["beta2"],
                                           weight_decay=h["weight_decay"], eps=h["eps"], amsgrad=False,
                                           maximize=False), [args], iters=5)[0]]
        print(json.dumps({"kernel": "adamw", "model": which, "params": sum(p.numel() for p in ps),
                          "tensors": len(ps), "bound_ms": b, "bound_by": by, "ms": turns,
                          "share_of_bound": {k: b / (sum(v) / len(v)) for k, v in turns.items()}}), flush=True)
        del args, ps, gs, steps
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cudaex._library()
    if sys.argv[1] == "--sweep":
        sweep(dev, torch.Generator(device=dev).manual_seed(0))
        return 0
    so = build_other(Path(sys.argv[1]), cudaex.BUILD_DIR / "ab_other")
    gen = torch.Generator(device=dev).manual_seed(0)
    floor = [cs.cuda_ms(lambda: cudaex.empty_kernel(dev), [()])[0] for _ in range(2)]
    print(json.dumps({"kernel": "empty", "ms": floor}), flush=True)
    rms_ab(so, dev, gen)
    adamw_ab(dev, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
