"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gaplac_tpu_torch/csrc``, holds each
against its plain PyTorch version at the shapes of the main path, times
both, then drives the main path through the CLI entry point
(``gaplac_tpu_torch.cli.main.main``) on the card:

1. ``mcmc "y ~| SqExp(:x)" --infer x``: NUTS on the marginal model, n = 500;
2. ``mcmc --no-marginalize --sampler chees --chains 8``: the whitened model,
   dim 501, 8 chains in lockstep.

Every phase raises on failure; the script exits non-zero on any failure and
when no CUDA device is available.  Its last line is one JSON object
``{"ok": true, "device": {...}}``; the line before it holds the kernels'
checks and times as JSON.  Data is made with numpy from fixed seeds; the
chain tables go to ``chip_smoke_out/``.
"""

from __future__ import annotations

import json
import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chip_smoke_out"
N_OBS = 500
CHAINS = 8
TIMING_REPS = 21

#: error of a float32 kernel against the float64 plain version may be at most
#: this multiple of the float32 plain version's own error (or the floor)
F32_ERR_FACTOR = 4.0
F32_ERR_FLOOR = 1e-5
#: relative error of a float64 kernel against the float64 plain version
F64_TOL = 1e-10


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a.double() - ref.double()).abs().max() / ref.double().abs().max())


def check_accuracy(name: str, kernel_out, plain32_out, ref64) -> float:
    """float32: the kernel's error against the float64 plain version is at
    most F32_ERR_FACTOR times the float32 plain version's (or F32_ERR_FLOOR);
    float64: at most F64_TOL.  Returns the kernel's relative error."""
    ek = rel_err(kernel_out, ref64)
    if kernel_out.dtype == torch.float64:
        ok, tol = ek <= F64_TOL, F64_TOL
    else:
        tol = max(F32_ERR_FACTOR * rel_err(plain32_out, ref64), F32_ERR_FLOOR)
        ok = ek <= tol
    log(f"  {name}: rel err {ek:.3e} (tolerance {tol:.3e})")
    if not ok:
        raise AssertionError(f"{name}: kernel error {ek:.3e} exceeds {tol:.3e}")
    return ek


def sqexp_gram(x: np.ndarray, ls: np.ndarray, jitter: float) -> np.ndarray:
    d2 = (x[:, None] - x[None, :]) ** 2
    return np.exp(-d2[None] / (2.0 * ls[:, None, None] ** 2)) + jitter * np.eye(len(x))


def time_ms(fn) -> float:
    """Median of TIMING_REPS runs, each timed by CUDA events after a warmup."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card_and_build():
    from gaplac_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log("[1] card (nvidia-smi name, power.limit):")
    log(card)
    t0 = time.perf_counter()
    _build.library()
    log(f"[1] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'})")
    return card


def phase_k1(dev):
    from gaplac_tpu_torch.ops.cholesky import (CholeskyBatched, chol_batched_cuda,
                                               chol_batched_plain)

    log("[2] K1 batched Cholesky against torch.linalg.cholesky_ex")
    rng = np.random.default_rng(11)
    main_err = None
    for B, n in ((CHAINS, N_OBS), (3, 37), (1, 257)):
        x = rng.uniform(-5, 5, n)
        A64 = torch.as_tensor(sqexp_gram(x, rng.uniform(1.0, 2.0, B), 0.1), device=dev)
        ref = chol_batched_plain(A64)
        for dtype in (torch.float32, torch.float64):
            A = A64.to(dtype)
            Lk = chol_batched_cuda(A)
            Lp = chol_batched_plain(A)
            torch.cuda.synchronize()
            tag = f"({B},{n},{n}) {str(dtype)[6:]}"
            recon = float(torch.linalg.matrix_norm(Lk.double() @ Lk.double().mT - A64).max()
                          / torch.linalg.matrix_norm(A64).max())
            recon_tol = 1e-4 if dtype == torch.float32 else 1e-12
            log(f"  {tag}: |LL^T - A|/|A| = {recon:.3e} (tolerance {recon_tol:.0e})")
            if not recon <= recon_tol:
                raise AssertionError(f"K1 {tag}: reconstruction error {recon:.3e}")
            if float(Lk.triu(1).abs().max()) != 0.0:
                raise AssertionError(f"K1 {tag}: nonzero upper triangle")
            check_accuracy(f"K1 factor {tag}", Lk, Lp, ref)
            if (B, n) == (CHAINS, N_OBS) and dtype == torch.float32:
                main_err = float((Lk - Lp).abs().max())

            # gradient through CholeskyBatched against autograd of the plain op
            W = torch.as_tensor(rng.normal(size=(B, n, n)), device=dev)
            grads = {}
            for key, fn, dt in (("k", CholeskyBatched.apply, dtype),
                                ("p", torch.linalg.cholesky, dtype),
                                ("ref", torch.linalg.cholesky, torch.float64)):
                Ad = A64.to(dt).clone().requires_grad_(True)
                (g,) = torch.autograd.grad((torch.sin(fn(Ad)) * W.to(dt)).sum(), Ad)
                grads[key] = 0.5 * (g + g.mT)  # both conventions agree on the symmetric part
            check_accuracy(f"K1 gradient {tag}", grads["k"], grads["p"], grads["ref"])

    # a non-positive-definite member comes back as NaN, the others intact
    A = torch.as_tensor(sqexp_gram(rng.uniform(-5, 5, 37), np.full(3, 1.5), 1.1), device=dev)
    A[1] = -torch.eye(37, device=dev, dtype=A.dtype)
    for dtype in (torch.float32, torch.float64):
        L = chol_batched_cuda(A.to(dtype))
        if not (torch.isnan(L[1]).all() and torch.isfinite(L[[0, 2]]).all()):
            raise AssertionError(f"K1 {dtype}: a non-PD member must give NaN, the rest finite")
    log("  non-PD member -> NaN factor, other members finite: ok")
    return main_err


def phase_k2(dev):
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.ops.gram import gram_bwd_cuda, gram_bwd_plain, gram_cuda, gram_plain

    log("[3] K2 gram and K2b gram backward against their plain versions")
    rng = np.random.default_rng(5)

    def data(n, seed):
        X = np.random.default_rng(seed).normal(size=(n, 4))
        X[:, 1] = np.floor(np.abs(X[:, 1]) * 2)
        return torch.as_tensor(X, device=dev)

    composite = compile_formula(parse_formula(
        "y ~| SqExp(:t) * Cat(:g) + Linear(:x) + OU(:t2) + Noise").formula)
    extended = compile_formula(parse_formula(
        "y ~| Matern32(:t) + Matern52(:t2) * Periodic(:s; l=1.2, p=2.5)"
        " + RQ(:x; l=0.8, alpha=1.5)").formula)
    errs = {}
    for name, ck, n1, n2, diag in (("composite sym", composite, N_OBS, None, 0.1),
                                   ("composite cross", composite, 300, 129, 0.0),
                                   ("extended sym", extended, 200, None, 0.1),
                                   ("extended cross", extended, 200, 70, 0.0)):
        X1 = data(n1, 0)
        X2 = None if n2 is None else data(n2, 1)
        p64 = ck.default_params(torch.float64, dev).expand(CHAINS, -1).clone()
        p64 = p64 * torch.as_tensor(rng.uniform(0.7, 1.4, p64.shape), device=dev)
        n2v = n1 if n2 is None else n2
        G = torch.as_tensor(rng.normal(size=(CHAINS, n1, n2v)), device=dev)
        if n2 is None:
            G = 0.5 * (G + G.mT)
        Kref = gram_plain(ck, p64, X1, X2, diag)
        dref = gram_bwd_plain(ck, p64, X1, X2, G)
        for dtype in (torch.float32, torch.float64):
            c = lambda t: None if t is None else t.to(dtype).contiguous()
            tag = f"{name} ({CHAINS},{n1},{n2v}) {str(dtype)[6:]}"
            Kk = gram_cuda(ck, c(p64), c(X1), c(X2), diag)
            Kp = gram_plain(ck, c(p64), c(X1), c(X2), diag)
            e = check_accuracy(f"K2 {tag}", Kk, Kp, Kref)
            dk = gram_bwd_cuda(ck, c(p64), c(X1), c(X2), c(G))
            dp = gram_bwd_plain(ck, c(p64), c(X1), c(X2), c(G))
            eb = check_accuracy(f"K2b {tag}", dk, dp, dref)
            if name == "composite sym" and dtype == torch.float32:
                errs["K2"] = float((Kk - Kp).abs().max())
                errs["K2b"] = float((dk - dp).abs().max())
    return errs


def phase_model_parity(dev):
    """The marginal model's log density and gradient through the kernels on
    the card against the CPU plain path, both in float64."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.inference.hmc import value_and_grad
    from gaplac_tpu_torch.inference.model import build_model
    from gaplac_tpu_torch.kernels.covariance import compile_formula

    log("[4] model log density and gradient: card (kernels) against CPU (plain), float64")
    rng = np.random.default_rng(3)
    x = rng.uniform(-5, 5, 60)
    y = rng.normal(size=60)
    spec = parse_formula("y ~| SqExp(:x)")
    ck = compile_formula(spec.formula)
    u = rng.normal(size=(4, 1))
    v = rng.normal(size=(4, 61)) * 0.3
    for marg, q in ((True, u), (False, v)):
        out = []
        for d in ("cpu", dev):
            X = torch.as_tensor(x[:, None], device=d)
            m = build_model(ck, ["x"], X, torch.as_tensor(y, device=d), spec.likelihood,
                            marginalize=marg)
            lp, g = value_and_grad(m.logdensity)(torch.as_tensor(q, device=d))
            out.append((lp.cpu(), g.cpu()))
        e = max(rel_err(out[1][0], out[0][0]), rel_err(out[1][1], out[0][1]))
        log(f"  {'marginal' if marg else 'whitened'}: rel err {e:.3e} (tolerance 1e-9)")
        if not e <= 1e-9:
            raise AssertionError("model parity between card and CPU failed")


def phase_timings(dev):
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.ops.cholesky import chol_batched_cuda, chol_batched_plain
    from gaplac_tpu_torch.ops.gram import gram_bwd_cuda, gram_bwd_plain, gram_cuda, gram_plain

    log(f"[5] times at the main path's shapes, float32, median of {TIMING_REPS}")
    rng = np.random.default_rng(9)
    x = rng.uniform(-5, 5, N_OBS)
    A = torch.as_tensor(sqexp_gram(x, rng.uniform(1, 2, CHAINS), 0.1), device=dev,
                        dtype=torch.float32)
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    X = torch.as_tensor(x[:, None], device=dev, dtype=torch.float32)
    p = torch.as_tensor(rng.uniform(1, 2, (CHAINS, 1)), device=dev, dtype=torch.float32)
    G = torch.randn((CHAINS, N_OBS, N_OBS), device=dev, dtype=torch.float32)
    rows = {
        "K1": (lambda: chol_batched_cuda(A), lambda: chol_batched_plain(A)),
        "K2": (lambda: gram_cuda(ck, p, X, None, 0.1), lambda: gram_plain(ck, p, X, None, 0.1)),
        "K2b": (lambda: gram_bwd_cuda(ck, p, X, None, G),
                lambda: gram_bwd_plain(ck, p, X, None, G)),
    }
    times = {}
    for k, (kern, plain) in rows.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        tp1, tk1, tk2, tp2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
        times[k] = (float(np.median([tk1, tk2])), float(np.median([tp1, tp2])))
        log(f"  {k}: kernel {tk1:.4f} / {tk2:.4f} ms, plain {tp1:.4f} / {tp2:.4f} ms")
    return times


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_main_path(dev):
    import pandas as pd

    from gaplac_tpu_torch.cli.main import main
    from gaplac_tpu_torch.ops import _build

    log("[6] main path through gaplac_tpu_torch.cli.main on the card")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    x = rng.uniform(-5, 5, N_OBS)
    K = sqexp_gram(x, np.array([1.5]), 0.1)[0]
    y = np.linalg.cholesky(K) @ rng.normal(size=N_OBS)
    data = OUT_DIR / "data.tsv"
    pd.DataFrame({"x": x, "y": y}).to_csv(data, sep="\t", index=False)
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    head = ["iteration", "chain", "ℓ"] + [f"fx[{i + 1}]" for i in range(N_OBS)] + ["lp"]
    runs = (  # (name, flags, chain-table columns, rows)
        ("nuts marginal", ["--samples", "100", "--warmup", "100"],
         head + ["acceptance_rate", "tree_depth", "numerical_error"], 100),
        ("chees whitened", ["--no-marginalize", "--sampler", "chees", "--chains", str(CHAINS),
                            "--samples", "30", "--warmup", "30"],
         head + ["acceptance_rate", "step_size", "traj_length"], 30 * CHAINS),
    )
    rates = {}
    _build.reset_counts()
    for name, extra, columns, rows in runs:
        out = OUT_DIR / f"{name.replace(' ', '_')}.tsv"
        argv = ["-v", "--platform", "cuda", "mcmc", "y ~| SqExp(:x)", "--data", str(data),
                "--infer", "x", "--output", str(out), "--seed", "1", *extra]
        capture.lines.clear()
        t0 = time.perf_counter()
        rc = main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{name}: main returned {rc}")
        df = pd.read_csv(out, sep="\t")
        if list(df.columns) != columns:
            raise AssertionError(f"{name}: chain-table columns {list(df.columns)[:6]}...")
        if len(df) != rows:
            raise AssertionError(f"{name}: {len(df)} rows")
        if not np.isfinite(df.to_numpy(dtype=float)).all():
            raise AssertionError(f"{name}: non-finite values in the chain table")
        rate_line = next(s for s in capture.lines if "transitions/s" in s)
        rate = float(rate_line.split("transitions/s")[0].split("(")[-1])
        rates[name] = {"transitions_per_s": rate, "wall_s": wall,
                       "ell_mean": float(df["ℓ"].mean())}
        log(f"  {name}: {rate:.1f} transitions/s in sampling ({rate_line}); "
            f"command wall {wall:.1f} s; posterior mean ℓ {df['ℓ'].mean():.3f}")
    launches = dict(_build.counts)
    logging.getLogger().removeHandler(capture)
    log(f"  kernel launches on the main path: {launches}")
    ell = rates["nuts marginal"]["ell_mean"]
    if not abs(ell - 1.5) <= 0.6:
        raise AssertionError(f"posterior mean ℓ {ell:.3f} outside 1.5 ± 0.6")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    return launches, rates


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = phase_card_and_build()
    k1_err = phase_k1(dev)
    k2_errs = phase_k2(dev)
    phase_model_parity(dev)
    times = phase_timings(dev)
    launches, rates = phase_main_path(dev)
    kernels = []
    for name, src, replaces, err in (
        ("K1 chol_batched", "gaplac_tpu_torch/csrc/chol_batched.cu",
         "gaplac_tpu/ops/cholesky.py:296", k1_err),
        ("K2 gram", "gaplac_tpu_torch/csrc/gram.cu", "gaplac_tpu/ops/gram.py:154",
         k2_errs["K2"]),
        ("K2b gram backward", "gaplac_tpu_torch/csrc/gram.cu", "gaplac_tpu/ops/gram.py:154",
         k2_errs["K2b"]),
    ):
        key = name.split()[0]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[key], "max_abs_err": err,
                        "ms": times[key][0], "plain_ms": times[key][1]})
    log(f"card: {card}; main path: " + json.dumps(rates))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
