"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gaplac_tpu_torch/csrc`` (one nvcc per
source, all started together), holds each against its plain PyTorch version
at the shapes of the main paths (K1 at both cluster sizes of
``K1_CLUSTERS``, K2 and K2b also at the edge shapes of their 32-tiles with a
cotangent that is not symmetric, K3 on contiguous tiles and on strided
views), checks that a symmetric K2 output equals its transpose and that K2b
repeats bit for bit and is one CUDA kernel a call, times each (CUDA events,
the profiler's device time and, for K2 and K2b, the wrapper's host time)
beside the one PyTorch call that computes the same function where there is
one, then drives seven paths through
the CLI entry point (``gaplac_tpu_torch.cli.main.main``) on the card, the
kernels' launch counts set to 0 just before each and read just after:

1. ``mcmc``, n = 500: NUTS on the marginal model, and 8-chain ChEES on the
   whitened model (dim 501), the latter twice with ``--seed 1``, whose chain
   tables must be identical (kernels K1, K2, K2b);
2. ``sample`` -> ``select --formulae`` -> ``predict --mcmc`` at n = 4096 rows,
   whose factorizations take the blocked route through kernel K3 (and K2).
   K2 is then held against its plain version at this path's shapes, and
   ``select`` and ``predict`` (on the chain's first draws) against the same
   commands on the CPU in float64;
3. the rest of the dense model: ``mcmc --sampler hmc`` whole and with
   ``--segments 10`` (identical tables), ``--sampler advi``, ``--approx
   laplace`` on a Bernoulli set of n = 500 (its log density and gradient
   against the CPU, 16 K1 launches an evaluation), ``select --estimator smc``
   at 512 particles (its evidence against a float64 quadrature; K1 and K2 at
   the particle batch, checked and timed there), and ``fitplot``'s component
   posteriors at n = 4096 against the CPU, with the blocked triangular solve
   timed against ``torch.linalg.solve_triangular`` at the shape it solves;
4. the ``--approx rff`` low-rank path at n = 65536, m = 512: ``sample`` (the
   prior draw, and a posterior draw at 1024 points), ``mcmc`` NUTS and
   8-chain ChEES (one K1 launch a capacitance factorization and no gram;
   the posterior mean of l against a float64 quadrature of the same model;
   its log density and gradient at C = 2 against the CPU; one value+grad at
   C = 8 profiled), ``select --formulae`` against the CPU, ``select
   --estimator smc`` at n = 16384 (its evidence against the quadrature),
   ``predict --mcmc`` over the ChEES chain (its first draws against the
   CPU), and ``fitplot``'s components at m_total = 2048, whose 2-D
   capacitance takes the blocked route through K3, against the CPU.  The
   timing phase adds K1 at the capacitance batch (8, 512, 512) and at
   (8, 2048, 2048) and (1, 4096, 4096), against ``cholesky_ex``;
5. the ``--approx sde`` state-space path, which has no kernel of its own
   (its scans are PyTorch's operations), and ``--approx auto``: ``sample``
   (prior, and a posterior draw) and ``mcmc "y ~| OU(:x)"`` NUTS and 8-chain
   ChEES extending it at n = 2^20 (the mean of l against a float64
   quadrature); the sde OU marginal against the dense one through K2, K1
   and K2b at n = 4096, C = 8; SqExp (d = 6) at n = 2^17 through
   ``sample``, ``mcmc`` (the accuracy guard), ``select --formulae`` and
   ``select --estimator smc`` on its first 16384 rows (against a
   quadrature); the quasi-periodic Periodic * Matern32 block (d = 42):
   ``sample`` and one report at n = 16384, ``predict`` at n = 2^17
   (windowed by default) and at 16384 windowed against monolithic; the
   Bernoulli Laplace marginal and the whitened model at n = 2^16; the
   longitudinal ``OU(:t)*Cat(:PersonID) + Cat(:PersonID) + Noise`` through
   ``sample``, ``mcmc`` and ``fitplot``'s numbers; ``--approx auto`` at
   n = 4096 (dense: K2 and K3's blocked route in ``select``, K1, K2, K2b in
   ``mcmc``) and 2^17 (sde).  Every value+grad and command number is held
   by the float32 rule against float64 on the CPU (the CPU's float32 run is
   the plain run), the Laplace and whitened HMC runs must accept, and the
   OU, SqExp (C = 8) and quasi-periodic
   (C = 1) value+grad are profiled: wall, device time by op, launches and
   peak memory;
6. ``--profile``, ``--profile-dir`` and ``--check-numerics`` on path 1's
   ``mcmc`` (8-chain ChEES, shortened, without flags, with ``--profile``,
   with both profile flags and with the check: identical tables; the
   report's command phase within 10 % of the command's wall where no trace
   is written; CUDA events of K1, K2 and K2b in the trace;
   NUTS's report names ``mcmc.sample+compile`` and ``mcmc.report``;
   ``sample``, ``select`` and ``predict`` with both profile flags; an inf
   response raises FloatingPointError before any table is written); the
   fused gram -> Cholesky (``ops/fused.py``) at n = 16384, float32, panel
   2048, its forward and a value+grad against float64 on the card by the
   float32 rule (K2 at row offsets, K3, K2b), timed beside the two-step
   ``blocked_cholesky`` of K2's gram, and its forward's peak memory at
   n = 32768, at most 1.25 times the factor's bytes; K2 at row offsets
   against its plain version on the panels; the native table IO
   (``data/fastio.py``) on path 5's 2^20-row table and a chain table,
   against pandas and the plain writer, byte for byte;
7. the parallel slice (``parallel/``) at world size 1 under NCCL on cuda:0:
   ``mcmc`` NUTS ``--chains 8`` at n = 500 without and with the ``GAPLAC_*``
   variables (identical tables; the log names NCCL, world size 1 and
   cuda:0); ``sharded_gram``, ``distributed_cholesky``,
   ``distributed_solve_lower`` and their log density at n = 16384, float32,
   each against its counterpart (the symmetric K2 gram, ``ops.linalg.
   cholesky``'s blocked route through K3, ``solve_triangular``,
   ``ops/mvn.py``) by the float32 rule against float64 on the card, timed
   beside it with NCCL's part of the device time; ``sharded_lowrank_logpdf``
   at n = 65536, m = 512 (value and gradient against float64 and against
   ``lowrank_logpdf``; one K1 launch an evaluation; wall, device time, peak
   memory); ``run_chees`` with the one-rank "chains" mesh on path 1's
   whitened model, equal bit for bit to the run without a mesh.

Every phase raises on failure; the script exits non-zero on any failure and
when no CUDA device is available.  Its last line is one JSON object
``{"ok": true, "device": {...}}``; the line before it holds the kernels'
checks, times and bounds as JSON.  Data is made with numpy from fixed seeds;
the tables go to ``chip_smoke_out/``.

    python3 chip_smoke.py --gram-times

times only K2 and K2b at the timed shapes (the wrapper's host time, events,
the profiler's device time); copied into another checkout's root, the
script times that checkout's kernels the same way.

    python3 chip_smoke.py --sde-probes

measures two choices of the sde path on the card: the quasi-periodic
value+grad (d = 42, n = 16384, C = 1) with the combines' ``solve_ex``
against ``torch.linalg.solve`` (which waits for the card to report
singular members), in the order ex, solve, solve, ex; and SqExp
(d = 6) at n = 2^17 from float32 data with its steps in float64 (as
shipped) against float32 steps in the modal basis and in one scaled to unit
variance per mode: the filter's least eigenvalue, the value+grad against
float64, and whether a report's draws are finite.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import logging
import math
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
#: calls traced in each profiler window (a measurement traces three windows,
#: each after a warmup window)
PROFILE_CALLS = 5
N_BIG = 4096      # rows of the sample/select/predict path (the dense model's largest)
N_AT = 1024       # predict's --at points
PREDICT_CHECK_DRAWS = 4  # chain draws of the predict run held against the CPU
K3_TILE = 128     # K3's tile (ops/cholesky.py CHOL_TILE)
K1_CLUSTERS = (8, 16)  # K1's cluster sizes, each checked and timed beside the launcher's choice
N_RFF = 65536     # rows of path 4, the --approx rff path (gaplac_tpu's low-rank width)
M_RFF = 512       # its --rff-features
N_RFF_SMC = 16384  # rows of path 4's select --estimator smc
M_RFF_FITPLOT = 1024  # fitplot's --rff-features: two leaves, m_total 2048, the blocked route
DETERMINISM_LAUNCHES = 20
#: K2/K2b edge shapes of their 32-tiles: rows n of a symmetric gram, and the
#: columns of a cross gram with n rows (n2 % 4 != 0 takes the scalar path)
K2_EDGE_N = {1: 3, 63: 64, 64: 70, 65: 128, N_OBS: 129}

#: published peaks of one H100 SXM (float32 outside the tensor cores; HBM3)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

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
    most F32_ERR_FACTOR times the float32 plain version's (the largest, if
    ``plain32_out`` is a tuple of several) or F32_ERR_FLOOR; float64: at most
    F64_TOL.  Returns the kernel's relative error."""
    ek = rel_err(kernel_out, ref64)
    if kernel_out.dtype == torch.float64:
        ok, tol = ek <= F64_TOL, F64_TOL
    else:
        plains = plain32_out if isinstance(plain32_out, tuple) else (plain32_out,)
        tol = max(F32_ERR_FACTOR * max(rel_err(p, ref64) for p in plains), F32_ERR_FLOOR)
        ok = ek <= tol
    log(f"  {name}: rel err {ek:.3e} (tolerance {tol:.3e})")
    if not ok:
        raise AssertionError(f"{name}: kernel error {ek:.3e} exceeds {tol:.3e}")
    return ek


def sqexp_gram(x: np.ndarray, ls: np.ndarray, jitter: float) -> np.ndarray:
    d2 = (x[:, None] - x[None, :]) ** 2
    return np.exp(-d2[None] / (2.0 * ls[:, None, None] ** 2)) + jitter * np.eye(len(x))


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, what bounds it): the larger of the operations over
    the float32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def spd(n: int, seed: int, dev, jitter: float = 1.1) -> torch.Tensor:
    """A SqExp gram (l = 1.5) of n uniform points plus jitter I, float64."""
    x = np.random.default_rng(seed).uniform(-5, 5, n)
    return torch.as_tensor(sqexp_gram(x, np.array([1.5]), jitter)[0], device=dev)


def capacitance(B: int, m: int, n: int, dev) -> torch.Tensor:
    """B capacitance matrices I + Phi^T Phi / 1.1 of path 4's model: SqExp
    random features (m of them) of n uniform points, lengthscales spread over
    [1, 2], float64."""
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.uniform(-5, 5, n), device=dev)
    w0 = torch.as_tensor(rng.standard_normal(m), device=dev)
    b0 = torch.as_tensor(rng.uniform(0, 2 * math.pi, m), device=dev)
    out = []
    for ls in np.linspace(1.0, 2.0, B):
        phi = math.sqrt(2.0 / m) * torch.cos(x[:, None] * (w0 / ls) + b0)
        out.append(torch.eye(m, dtype=phi.dtype, device=dev) + phi.mT @ phi / 1.1)
    return torch.stack(out)


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


def profiled(fn, calls: int, windows: int = 3, attempts: int = 5):
    """torch.profiler's key averages over ``calls`` calls of ``fn``.  One
    session traces ``windows`` windows, each after a warmup window of as many
    calls (a first window can miss a kernel), and the window whose CUDA
    kernels took the most device time is returned: the profiler on the card
    drops records now and then (a window of the blocked factorization with 31
    of its 32 tiles; K2 at a batch of 512 timed below its bound), and never
    adds any.  A session with no CUDA kernel at all is traced again after a
    pause, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def device_total(averages):
        return sum(e.self_device_time_total for e in averages
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        got = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=windows),
                     on_trace_ready=lambda p: got.append(p.key_averages())) as prof:
            for _ in range(2 * windows):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        best = max(got, key=device_total, default=[])
        if device_total(best) > 0:
            return best
        log("  (the profiler's windows held no CUDA kernel; tracing again)")
        time.sleep(1.0)
    raise RuntimeError(f"the profiler recorded no CUDA kernel in {attempts} sessions")


def device_ms(fn, calls: int = PROFILE_CALLS) -> float:
    """Device time per call of the kernels ``fn`` launches: torch.profiler's
    sum of CUDA kernel (and copy) time over ``calls`` calls after a warmup.
    Unlike time_ms, it leaves out the host's time to reach the launch, which
    is most of a call for a kernel of a few microseconds."""
    return sum(e.self_device_time_total for e in profiled(fn, calls)
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


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
                                               chol_batched_plain, k1_clusters_that_fit)

    fit = {cl: k1_clusters_that_fit(cl, torch.float32, dev) for cl in K1_CLUSTERS}
    log("[2] K1 batched Cholesky, one cluster a matrix, against torch.linalg.cholesky_ex; "
        "clusters the card holds at once, float32: "
        + ", ".join(f"{v} of {cl} blocks" for cl, v in fit.items()))
    rng = np.random.default_rng(11)
    main_err = None
    for B, n in ((CHAINS, N_OBS), (1, N_OBS), (3, 37), (1, 257)):
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
            for cl in K1_CLUSTERS if n == N_OBS else ():  # each size, timed in phase 5
                check_accuracy(f"K1 factor {tag}, clusters of {cl}",
                               chol_batched_cuda(A, cluster=cl), Lp, ref)

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
    return main_err, fit


def phase_k2(dev):
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.ops.gram import (gram_bwd_cluster, gram_bwd_cuda, gram_bwd_plain,
                                           gram_cuda, gram_plain)

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

    # edge shapes of the 32-tiles, one chain and eight, symmetric and cross (n2 % 4
    # == 0 takes the 16-byte path, other n2 the scalar one), and a cotangent that
    # is not symmetric for a symmetric gram; a symmetric K2 must equal its
    # transpose bit for bit
    log("  edge shapes, composite formula, a cotangent that is not symmetric:")
    for (n1, cross), C, sym in itertools.product(K2_EDGE_N.items(), (1, CHAINS), (True, False)):
        n2 = None if sym else cross
        X1 = data(n1, 2)
        X2 = None if n2 is None else data(n2, 3)
        n2v = n1 if n2 is None else n2
        p64 = composite.default_params(torch.float64, dev).expand(C, -1).clone()
        p64 = p64 * torch.as_tensor(rng.uniform(0.7, 1.4, p64.shape), device=dev)
        G = torch.as_tensor(rng.normal(size=(C, n1, n2v)), device=dev)
        Kref = gram_plain(composite, p64, X1, X2, 0.1)
        dref = gram_bwd_plain(composite, p64, X1, X2, G)
        for dtype in (torch.float32, torch.float64):
            c = lambda t: None if t is None else t.to(dtype).contiguous()
            tag = f"{'sym' if n2 is None else 'cross'} ({C},{n1},{n2v}) {str(dtype)[6:]}"
            Kk = gram_cuda(composite, c(p64), c(X1), c(X2), 0.1)
            check_accuracy(f"K2 {tag}", Kk, gram_plain(composite, c(p64), c(X1), c(X2), 0.1),
                           Kref)
            if n2 is None and not torch.equal(Kk, Kk.mT):
                raise AssertionError(f"K2 {tag}: the symmetric gram is not symmetric bit for bit")
            check_accuracy(f"K2b {tag}", gram_bwd_cuda(composite, c(p64), c(X1), c(X2), c(G)),
                           gram_bwd_plain(composite, c(p64), c(X1), c(X2), c(G)), dref)
    log("  every symmetric K2 output above equals its transpose bit for bit")

    # K2b sums in a fixed order: every launch gives the same bits
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    X = torch.as_tensor(rng.uniform(-5, 5, (N_OBS, 1)), device=dev, dtype=torch.float32)
    for C in (CHAINS, 1):
        p = torch.as_tensor(rng.uniform(1, 2, (C, 1)), device=dev, dtype=torch.float32)
        G = torch.as_tensor(rng.normal(size=(C, N_OBS, N_OBS)), device=dev,
                            dtype=torch.float32)
        first = gram_bwd_cuda(ck, p, X, None, G)
        spread = max(float((gram_bwd_cuda(ck, p, X, None, G) - first).abs().max())
                     for _ in range(DETERMINISM_LAUNCHES - 1))
        log(f"  K2b, {DETERMINISM_LAUNCHES} launches at ({C},{N_OBS},{N_OBS}) float32, "
            f"clusters of {gram_bwd_cluster(C, torch.float32, p.device)}: largest difference from "
            f"the first {spread:.3e} (must be 0)")
        if spread != 0.0:
            raise AssertionError(f"K2b is not bitwise repeatable at C = {C}")
    return errs


def phase_k3(dev):
    """K3 against its plain version on single tiles, and the blocked
    factorization through K3 against torch.linalg.cholesky."""
    from gaplac_tpu_torch.ops.cholesky import blocked_cholesky, chol_tile_cuda, chol_tile_plain

    log("[3b] K3 Cholesky tile against chol_tile_plain (torch.linalg.cholesky_ex), on "
        "contiguous tiles and on strided views")
    main_err = None
    for n in (K3_TILE, K3_TILE - 1, 37):
        A64 = spd(n, n, dev)
        ref = chol_tile_plain(A64)
        for dtype in (torch.float32, torch.float64):
            Lp = chol_tile_plain(A64.to(dtype))
            # the tile as a block of a larger matrix (lda > n), its factor into
            # a block of another (ldl > n) whose other entries must not change
            big = torch.full((n + 40, n + 56), -3.0, dtype=dtype, device=dev)
            big[7:7 + n, 13:13 + n] = A64.to(dtype)
            out = torch.full((n + 30, n + 70), 7.0, dtype=dtype, device=dev)
            outside = torch.ones_like(out, dtype=torch.bool)
            outside[5:5 + n, 21:21 + n] = False
            for layout, Lk in (("contiguous", chol_tile_cuda(A64.to(dtype))),
                               ("strided", chol_tile_cuda(big[7:7 + n, 13:13 + n],
                                                          out[5:5 + n, 21:21 + n]))):
                torch.cuda.synchronize()
                tag = f"({n},{n}) {str(dtype)[6:]} {layout}"
                if float(Lk.triu(1).abs().max()) != 0.0:
                    raise AssertionError(f"K3 {tag}: nonzero upper triangle")
                check_accuracy(f"K3 tile {tag}", Lk, Lp, ref)
                if n == K3_TILE and dtype == torch.float32 and layout == "contiguous":
                    main_err = float((Lk - Lp).abs().max())
            if not bool((out[outside] == 7.0).all()):
                raise AssertionError(f"K3 ({n},{n}) {dtype}: wrote outside its output view")
        bad = A64.clone()
        bad[n // 2, n // 2] = -1.0
        for dtype in (torch.float32, torch.float64):
            if not torch.isnan(chol_tile_cuda(bad.to(dtype))).all():
                raise AssertionError(f"K3 ({n},{n}) {dtype}: a non-PD tile must give NaN")
    log("  non-PD tile -> NaN factor: ok; strided output view: nothing written outside it")

    log("[3c] blocked_cholesky through K3 against torch.linalg.cholesky (cuSOLVER)")
    for n in (N_BIG, 2 * N_BIG):
        A64 = spd(n, n, dev)
        ref = torch.linalg.cholesky(A64)
        for dtype in (torch.float32, torch.float64):
            A = A64.to(dtype)
            Lk = blocked_cholesky(A, base=K3_TILE)
            Lp = torch.linalg.cholesky(A)
            torch.cuda.synchronize()
            tag = f"n={n} {str(dtype)[6:]}"
            recon = float(torch.linalg.matrix_norm(Lk.double() @ Lk.double().mT - A64)
                          / torch.linalg.matrix_norm(A64))
            recon_tol = 1e-4 if dtype == torch.float32 else 1e-12
            log(f"  {tag}: |LL^T - A|/|A| = {recon:.3e} (tolerance {recon_tol:.0e})")
            if not recon <= recon_tol:
                raise AssertionError(f"blocked {tag}: reconstruction error {recon:.3e}")
            check_accuracy(f"blocked via K3 {tag}", Lk, Lp, ref)
            del Lk, Lp
        del A64, ref
    return main_err


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
    from gaplac_tpu_torch.ops.cholesky import (K1_CLUSTER, blocked_cholesky,
                                               chol_batched_cuda, chol_batched_plain,
                                               chol_tile_cuda, chol_tile_plain)
    from gaplac_tpu_torch.ops.gram import gram_bwd_cluster

    log(f"[5] times at the main paths' shapes, float32, median of {TIMING_REPS}")
    rng = np.random.default_rng(9)
    x = rng.uniform(-5, 5, N_OBS)
    A = torch.as_tensor(sqexp_gram(x, rng.uniform(1, 2, CHAINS), 0.1), device=dev,
                        dtype=torch.float32)
    A1 = A[:1].contiguous()  # NUTS factors one matrix at a time
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    X = torch.as_tensor(x[:, None], device=dev, dtype=torch.float32)
    p = torch.as_tensor(rng.uniform(1, 2, (CHAINS, 1)), device=dev, dtype=torch.float32)
    G = torch.randn((CHAINS, N_OBS, N_OBS), device=dev, dtype=torch.float32)
    T = spd(K3_TILE, 1, dev).to(torch.float32)
    B = spd(N_BIG, 2, dev).to(torch.float32)
    Xb = torch.as_tensor(rng.uniform(-5, 5, (N_BIG, 1)), device=dev, dtype=torch.float32)
    pb = p[:1].contiguous()
    n = N_OBS

    def chol_bytes(batch, m):
        """a factorization reads the lower triangle and writes the factor"""
        return batch * (m * (m + 1) // 2 + m * m) * 4

    def blocked_plain():
        with plain_kernels():
            return blocked_cholesky(B, base=K3_TILE)

    # (kernel, plain version, the one PyTorch call computing the same function or
    #  None, flops, bytes): bytes count each input read once, each output written once
    rows = {}
    for cl in (K1_CLUSTER,) + K1_CLUSTERS:  # the launcher's choice, then each size
        tag = "" if cl == K1_CLUSTER else f" cluster {cl}"
        rows[f"K1{tag}"] = (lambda cl=cl: chol_batched_cuda(A, cluster=cl),
                            lambda: chol_batched_plain(A), lambda: torch.linalg.cholesky_ex(A),
                            CHAINS * n ** 3 / 3, chol_bytes(CHAINS, n))
        # K1 at NUTS's (1, 500, 500)
        rows[f"K1 C=1{tag}"] = (lambda cl=cl: chol_batched_cuda(A1, cluster=cl),
                                lambda: chol_batched_plain(A1),
                                lambda: torch.linalg.cholesky_ex(A1), n ** 3 / 3,
                                chol_bytes(1, n))
    # K1 at path 4's capacitance batch, and at batched n >= 2048, where the dense
    # model's (C, n, n) factorizations go to K1 (the last on the blocked row's matrix)
    big_k1 = {"K1 (8,512,512)": capacitance(CHAINS, M_RFF, N_RFF, dev),
              "K1 (8,2048,2048)": torch.as_tensor(
                  sqexp_gram(rng.uniform(-5, 5, 2048), rng.uniform(1, 2, CHAINS), 1.1),
                  device=dev),
              "K1 (1,4096,4096)": B[None].double()}
    for k, A64 in big_k1.items():
        A32 = A64.float()
        check_accuracy(f"{k} float32", chol_batched_cuda(A32), chol_batched_plain(A32),
                       chol_batched_plain(A64))
        b, m = A32.shape[:2]
        rows[k] = (lambda A32=A32: chol_batched_cuda(A32), lambda A32=A32: chol_batched_plain(A32),
                   lambda A32=A32: torch.linalg.cholesky_ex(A32), b * m ** 3 / 3, chol_bytes(b, m))
        del A64
    rows.update(gram_rows(ck, p, X, G, pb, Xb))
    rows.update({
        "K3": (lambda: chol_tile_cuda(T), lambda: chol_tile_plain(T),
               lambda: torch.linalg.cholesky(T), K3_TILE ** 3 / 3, chol_bytes(1, K3_TILE)),
        # the blocked factorization at n = 4096 (K3 its base case), against cuSOLVER
        "blocked": (lambda: blocked_cholesky(B, base=K3_TILE), blocked_plain,
                    lambda: torch.linalg.cholesky(B), N_BIG ** 3 / 3, chol_bytes(1, N_BIG)),
    })
    # the K2 wrappers' host time, before the rest
    times = {k: {"host_ms": host_ms(row[0])} for k, row in rows.items() if k.startswith("K2")}
    for k, v in times.items():
        log(f"  {k}: wrapper host time {v['host_ms']:.4f} ms")
    for k, v in time_rows(rows).items():
        times.setdefault(k, {}).update(v)
    times["blocked"]["profile"] = profile_blocked(B)
    for k in ("K2b", "K2b C=1"):  # one kernel a call, and nothing else
        names = kernels_per_call(rows[k][0])
        log(f"  {k} profiled, CUDA kernels a call: {names}")
        if len(names) != 1 or next(iter(names.values())) != 1:
            raise AssertionError(f"{k}: one CUDA kernel a call expected, got {names}")
        times[k]["kernels_per_call"] = names
        times[k]["cluster"] = gram_bwd_cluster(1 if "C=1" in k else CHAINS, torch.float32,
                                               dev)
    return times


def gram_rows(ck, p, X, G, pb, Xb) -> dict:
    """K2 and K2b at the paths' shapes, as phase 5's rows: (kernel, plain
    version, library call, flops, bytes).  ck is SqExp(:x); p (CHAINS, 1), X
    (N_OBS, 1), G (CHAINS, N_OBS, N_OBS); pb (1, 1), Xb (N_BIG, 1)."""
    from gaplac_tpu_torch.ops.gram import gram_bwd_cuda, gram_bwd_plain, gram_cuda, gram_plain

    n = N_OBS
    p1, G1 = p[:1].contiguous(), G[:1].contiguous()  # NUTS: one chain
    Xt = Xb[:N_AT].contiguous()  # predict's at-points against the data
    fwd = lambda C, m: (6 * C * m * m, C * m * m * 4 + 4 * (m + C))
    bwd = lambda C, m: (10 * C * m * m, C * m * m * 4 + 4 * (m + 2 * C))
    return {
        "K2": (lambda: gram_cuda(ck, p, X, None, 0.1), lambda: gram_plain(ck, p, X, None, 0.1),
               None, *fwd(CHAINS, n)),
        "K2 C=1": (lambda: gram_cuda(ck, p1, X, None, 0.1),
                   lambda: gram_plain(ck, p1, X, None, 0.1), None, *fwd(1, n)),
        # K2 at path 2's largest gram, (1, 4096, 4096), and predict's cross gram
        "K2 n=4096": (lambda: gram_cuda(ck, pb, Xb, None, 0.1),
                      lambda: gram_plain(ck, pb, Xb, None, 0.1), None, *fwd(1, N_BIG)),
        "K2 cross": (lambda: gram_cuda(ck, pb, Xt, Xb), lambda: gram_plain(ck, pb, Xt, Xb),
                     None, 6 * N_AT * N_BIG, N_AT * N_BIG * 4 + 4 * (N_AT + N_BIG + 1)),
        "K2b": (lambda: gram_bwd_cuda(ck, p, X, None, G),
                lambda: gram_bwd_plain(ck, p, X, None, G), None, *bwd(CHAINS, n)),
        "K2b C=1": (lambda: gram_bwd_cuda(ck, p1, X, None, G1),
                    lambda: gram_bwd_plain(ck, p1, X, None, G1), None, *bwd(1, n)),
    }


def host_ms(fn, calls: int = TIMING_REPS) -> float:
    """The wrapper's host time: median of perf_counter around calls that do
    not synchronize (the queue drained before each)."""
    fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def kernels_per_call(fn, calls: int = 5) -> dict:
    """CUDA kernel names a call of fn launches (torch.profiler), with counts."""
    return {e.key[:90]: e.count / calls for e in profiled(fn, calls)
            if e.device_type == torch.autograd.DeviceType.CUDA}


def profile_blocked(B, calls: int = 5) -> dict:
    """Where the time of blocked_cholesky at n = 4096 goes: host wall per call
    (synchronized, without the profiler) against the device time of its
    kernels (torch.profiler, over as many calls)."""
    from gaplac_tpu_torch.ops.cholesky import blocked_cholesky

    blocked_cholesky(B, base=K3_TILE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        blocked_cholesky(B, base=K3_TILE)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls * 1e3
    kernels = {}
    for e in profiled(lambda: blocked_cholesky(B, base=K3_TILE), calls):
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = (e.self_device_time_total / 1e3 / calls, e.count // calls)
    device = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    log(f"  blocked n={N_BIG} profiled: wall {wall:.3f} ms/call, device kernels "
        f"{device:.3f} ms/call ({sum(c for _, c in kernels.values())} launches), busy "
        f"{device / wall:.2f}")
    for name, (ms, count) in top:
        log(f"    {ms:.3f} ms in {count} x {name[:90]}")
    return {"wall_ms": wall, "device_ms": device,
            "launches": sum(c for _, c in kernels.values()),
            "top": [[name[:90], ms, count] for name, (ms, count) in top]}


@contextlib.contextmanager
def plain_kernels():
    """Every kernel's wrapper replaced by its plain version, which runs on the
    card through PyTorch's own operations (and counts no launch)."""
    from gaplac_tpu_torch.ops import cholesky as C
    from gaplac_tpu_torch.ops import gram as G

    def tile_plain(A, out=None):
        L = C.chol_tile_plain(A)
        return L if out is None else out.copy_(L)

    swaps = ((C, "chol_batched_cuda", C.chol_batched_plain),
             (C, "chol_tile_cuda", tile_plain),
             (G, "gram_cuda", G.gram_plain), (G, "gram_bwd_cuda", G.gram_bwd_plain))
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    for m, name, plain in swaps:
        setattr(m, name, plain)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_cli(argv, capture=None) -> str:
    """One command through the port's entry point; its standard output."""
    from gaplac_tpu_torch.cli.main import main

    if capture is not None:
        capture.lines.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{' '.join(argv[:4])}...: main returned {rc}")
    return buf.getvalue()


def read_table(path, columns, rows):
    import pandas as pd

    df = pd.read_csv(path, sep="\t")
    if list(df.columns) != columns:
        raise AssertionError(f"{path.name}: columns {list(df.columns)[:6]}...")
    if len(df) != rows:
        raise AssertionError(f"{path.name}: {len(df)} rows, expected {rows}")
    finite = np.isfinite(df.to_numpy(dtype=float))
    if not finite.all():
        bad = {c: int((~finite[:, i]).sum()) for i, c in enumerate(df.columns)
               if not finite[:, i].all()}
        raise AssertionError(f"{path.name}: non-finite values (rows by column: {bad})")
    return df


def write_path1_data(data: Path) -> Path:
    """Path 1's data: N_OBS points of a SqExp (l = 1.5) draw plus 0.1 noise."""
    import pandas as pd

    data.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    x = rng.uniform(-5, 5, N_OBS)
    K = sqexp_gram(x, np.array([1.5]), 0.1)[0]
    y = np.linalg.cholesky(K) @ rng.normal(size=N_OBS)
    pd.DataFrame({"x": x, "y": y}).to_csv(data, sep="\t", index=False)
    return data


def phase_mcmc_path(dev):
    """Path 1: mcmc at n = 500, NUTS marginal and ChEES whitened (twice)."""
    from gaplac_tpu_torch.ops import _build

    log("[6] path 1: mcmc through gaplac_tpu_torch.cli.main on the card, n = 500")
    data = write_path1_data(OUT_DIR / "data.tsv")
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    head = ["iteration", "chain", "ℓ"] + [f"fx[{i + 1}]" for i in range(N_OBS)] + ["lp"]
    chees = ["--no-marginalize", "--sampler", "chees", "--chains", str(CHAINS),
             "--samples", "30", "--warmup", "30"]
    chees_cols = head + ["acceptance_rate", "step_size", "traj_length"]
    runs = (  # (name, flags, chain-table columns, rows)
        ("nuts marginal", ["--samples", "100", "--warmup", "100"],
         head + ["acceptance_rate", "tree_depth", "numerical_error"], 100),
        ("chees whitened", chees, chees_cols, 30 * CHAINS),
        ("chees whitened again", chees, chees_cols, 30 * CHAINS),
    )
    rates, outs = {}, {}
    _build.reset_counts()
    for name, extra, columns, rows in runs:
        out = OUT_DIR / f"{name.replace(' ', '_')}.tsv"
        argv = ["-v", "--platform", "cuda", "mcmc", "y ~| SqExp(:x)", "--data", str(data),
                "--infer", "x", "--output", str(out), "--seed", "1", *extra]
        t0 = time.perf_counter()
        run_cli(argv, capture)
        wall = time.perf_counter() - t0
        df = read_table(out, columns, rows)
        outs[name] = out
        rate_line = next(s for s in capture.lines if "transitions/s" in s)
        rate = float(rate_line.split("transitions/s")[0].split("(")[-1])
        rates[name] = {"transitions_per_s": rate, "wall_s": wall,
                       "ell_mean": float(df["ℓ"].mean())}
        log(f"  {name}: {rate:.1f} transitions/s in sampling ({rate_line}); "
            f"command wall {wall:.1f} s; posterior mean ℓ {df['ℓ'].mean():.3f}")
    launches = dict(_build.counts)
    logging.getLogger().removeHandler(capture)
    log(f"  kernel launches on path 1: {launches}")
    same = outs["chees whitened"].read_bytes() == outs["chees whitened again"].read_bytes()
    log(f"  two ChEES runs with --seed 1 wrote identical chain tables: {same}")
    if not same:
        raise AssertionError("two ChEES runs with --seed 1 wrote different chain tables")
    ell = rates["nuts marginal"]["ell_mean"]
    if not abs(ell - 1.5) <= 0.6:
        raise AssertionError(f"posterior mean ℓ {ell:.3f} outside 1.5 ± 0.6")
    for k in ("K1", "K2", "K2b"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on path 1")
    return launches, rates, outs["nuts marginal"]


def select_lps(report: str):
    lp1 = float(report.split("model 1:")[1].splitlines()[0])
    lp2 = float(report.split("model 2:")[1].splitlines()[0])
    return lp1, lp2


def phase_big_path(dev, chain):
    """Path 2: sample -> select --formulae -> predict --mcmc at n = 4096."""
    from gaplac_tpu_torch.ops import _build

    log(f"[7] path 2: sample -> select --formulae -> predict --mcmc, n = {N_BIG}, on the card")
    data, pred = OUT_DIR / "data_4096.tsv", OUT_DIR / "predict_4096.tsv"
    formulae = ["y ~| SqExp(:x)", "y ~| OU(:x)"]
    select = ["select", "--formulae", *formulae, "--data", str(data)]

    def predict(chain_path, out):
        return ["predict", "y ~| SqExp(:x)", "--data", str(data), "--at",
                f"x = rand(Uniform(-5,5), {N_AT})", "--seed", "2", "--mcmc", str(chain_path),
                "--output", str(out)]

    walls = {}
    _build.reset_counts()
    t0 = time.perf_counter()
    run_cli(["--platform", "cuda", "sample", "y :~| SqExp(:x; l=1.5)", "--at",
             f"x = rand(Uniform(-5,5), {N_BIG})", "--seed", "1", "--output", str(data)])
    walls["sample"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lps = select_lps(run_cli(["--platform", "cuda", *select]))
    walls["select"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(["--platform", "cuda", *predict(chain, pred)])
    walls["predict"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(_build.counts)
    log(f"  kernel launches on path 2: {launches}; command walls (s): "
        + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()))
    sample_df = read_table(data, ["x", "y"], N_BIG)
    df = read_table(pred, ["x", "ymu", "yQ050", "yQ950"], N_AT)
    if not ((df["yQ050"] <= df["ymu"]) & (df["ymu"] <= df["yQ950"])).all():
        raise AssertionError("predict: ymu outside [yQ050, yQ950]")
    if launches["K3"] <= 0:
        raise AssertionError("kernel K3 was not launched on path 2")

    k2_err = check_k2_path2(dev, sample_df, df)

    # select and predict on the card (float32, kernels) against the same
    # command on the CPU in float64.  The tolerance is the check_accuracy rule
    # over two float32 runs of the same algorithm through the plain versions:
    # the command on the CPU, and on the card with every kernel replaced by
    # its plain version
    ref = select_lps(run_cli(["--platform", "cpu", *select]))
    cpu32 = select_lps(run_cli(["--platform", "cpu", "--precision", "f32", *select]))
    with plain_kernels():
        card32 = select_lps(run_cli(["--platform", "cuda", *select]))
    select_check = {}
    for i, name in enumerate(formulae):
        ek = abs(lps[i] - ref[i]) / abs(ref[i])
        e32 = max(abs(cpu32[i] - ref[i]), abs(card32[i] - ref[i])) / abs(ref[i])
        tol = max(F32_ERR_FACTOR * e32, F32_ERR_FLOOR)
        log(f"  select lp {name}: card f32 {lps[i]:.4f}, cpu f64 {ref[i]:.4f}; plain f32: "
            f"cpu {cpu32[i]:.4f}, card {card32[i]:.4f}; rel err {ek:.3e} (tolerance {tol:.3e})")
        if not ek <= tol:
            raise AssertionError(f"select lp of {name} on the card is off by {ek:.3e}")
        select_check[name] = {"card_f32": lps[i], "cpu_f64": ref[i], "plain_f32_cpu": cpu32[i],
                              "plain_f32_card": card32[i], "rel_err": ek, "tol": tol}
    predict_check = check_predict(chain, predict)
    return launches, walls, {"select": select_check, "predict": predict_check,
                             "K2": k2_err}


def check_k2_path2(dev, sample_df, pred_df):
    """K2 against its plain version at path 2's grams: the symmetric
    (1, 4096, 4096) one with the jitter, and predict's cross gram of the
    at-points against the data, (1, 1024, 4096)."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.ops.gram import gram_cuda, gram_plain

    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    X = torch.tensor(sample_df[["x"]].to_numpy(), device=dev)
    Xt = torch.tensor(pred_df[["x"]].to_numpy(), device=dev)
    p64 = ck.default_params(torch.float64, dev)[None]
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
    errs = {}
    for tag, X1, X2, diag in (("sym", X, None, 0.1), ("cross", Xt, X, 0.0)):
        shape = f"(1,{X1.shape[0]},{X.shape[0]})"
        ref = gram_plain(ck, p64, X1, X2, diag)
        Kk = gram_cuda(ck, f32(p64), f32(X1), f32(X2), diag)
        Kp = gram_plain(ck, f32(p64), f32(X1), f32(X2), diag)
        check_accuracy(f"K2 path 2 {tag} {shape} float32", Kk, Kp, ref)
        errs[f"{tag} {shape}"] = float((Kk - Kp).abs().max())
        del ref, Kk, Kp
    return errs


def check_predict(chain, predict, label: str = "predict"):
    """predict over the chain's first draws: the card (float32, kernels)
    against the CPU (float64), column by column, with the check_accuracy rule
    over the CPU in float32 and the card through the plain versions."""
    import pandas as pd

    head = OUT_DIR / f"{label}_chain_head.tsv"
    pd.read_csv(chain, sep="\t").head(PREDICT_CHECK_DRAWS).to_csv(head, sep="\t", index=False)
    runs = {}
    for tag, flags in (("card", ["--platform", "cuda"]), ("cpu64", ["--platform", "cpu"]),
                       ("cpu32", ["--platform", "cpu", "--precision", "f32"]),
                       ("card_plain", ["--platform", "cuda"])):
        out = OUT_DIR / f"{label}_head_{tag}.tsv"
        with plain_kernels() if tag == "card_plain" else contextlib.nullcontext():
            run_cli([*flags, *predict(head, out)])
        runs[tag] = read_table(out, ["x", "ymu", "yQ050", "yQ950"], N_AT)
    if not all(np.array_equal(r["x"], runs["cpu64"]["x"]) for r in runs.values()):
        raise AssertionError(f"{label}: the --at points differ between the runs")
    col = lambda tag, c, dt: torch.tensor(runs[tag][c].to_numpy(), dtype=dt)
    errs = {}
    for c in ("ymu", "yQ050", "yQ950"):
        errs[c] = check_accuracy(
            f"{label} {c}, {PREDICT_CHECK_DRAWS} draws, card f32 against cpu f64",
            col("card", c, torch.float32),
            (col("cpu32", c, torch.float32), col("card_plain", c, torch.float32)),
            col("cpu64", c, torch.float64))
    return errs


# ---------------------------------------------------------------------------
# path 3: the rest of the dense model
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def batch_recorder():
    """The batch of every K1 and K2 launch inside the block: {kernel: [B, ...]}."""
    from gaplac_tpu_torch.ops import cholesky as C
    from gaplac_tpu_torch.ops import gram as G

    seen = {"K1": [], "K2": []}
    k1, k2 = C.chol_batched_cuda, G.gram_cuda

    def rec_k1(A, *a, **kw):
        seen["K1"].append(A.shape[0])
        return k1(A, *a, **kw)

    def rec_k2(ck, params, *a, **kw):
        seen["K2"].append(params.shape[0])
        return k2(ck, params, *a, **kw)

    C.chol_batched_cuda, G.gram_cuda = rec_k1, rec_k2
    try:
        yield seen
    finally:
        C.chol_batched_cuda, G.gram_cuda = k1, k2


def require_launches(tag: str, launches: dict, kernels) -> None:
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on {tag}")


def phase_hmc_advi(data):
    """Path 3a: mcmc --sampler hmc, whole and in segments (identical
    tables), and --sampler advi, on path 1's n = 500 data."""
    from gaplac_tpu_torch.inference import chees
    from gaplac_tpu_torch.ops import _build

    log(f"[8] path 3: mcmc --sampler hmc (whole, then --segments 10) and --sampler advi, "
        f"n = {N_OBS}, on the card")
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    head = ["iteration", "chain", "ℓ"] + [f"fx[{i + 1}]" for i in range(N_OBS)] + ["lp"]
    base = ["-v", "--platform", "cuda", "mcmc", "y ~| SqExp(:x)", "--data", str(data),
            "--infer", "x", "--seed", "1", "--chains", str(CHAINS)]
    hmc = ["--sampler", "hmc", "--leapfrogs", "32", "--samples", "30", "--warmup", "30"]
    out, launches = {}, {}
    # every checkpoint-callback state, and each run's last draws: the
    # segmented run must call the callback once a sampling segment
    ckpts, last_draws = [], []
    run_hmc = chees.run_hmc

    def recording_run_hmc(*args, checkpoint_cb=None, **kwargs):
        def cb(state):
            ckpts.append(state)
            checkpoint_cb(state)

        res = run_hmc(*args, checkpoint_cb=cb if checkpoint_cb else None, **kwargs)
        last_draws.append(res.positions[:, -1].cpu().numpy())
        return res

    chees.run_hmc = recording_run_hmc
    try:
        _build.reset_counts()
        for name, extra in (("hmc", []),
                            ("hmc segmented", ["--segments", "10", "--checkpoint",
                                               str(OUT_DIR / "hmc_segments_ckpt")])):
            path = OUT_DIR / f"{name.replace(' ', '_')}.tsv"
            t0 = time.perf_counter()
            run_cli([*base, *hmc, *extra, "--output", str(path)], capture)
            wall = time.perf_counter() - t0
            df = read_table(path, head + ["acceptance_rate", "step_size"], 30 * CHAINS)
            rate_line = next(s for s in capture.lines if "transitions/s" in s)
            out[name] = {"path": path, "wall_s": wall, "ell_mean": float(df["ℓ"].mean()),
                         "transitions_per_s": float(rate_line.split("transitions/s")[0]
                                                    .split("(")[-1])}
            log(f"  {name}: {rate_line}; command wall {wall:.1f} s; posterior mean ℓ "
                f"{out[name]['ell_mean']:.3f}")
        torch.cuda.synchronize()
        launches["hmc"] = dict(_build.counts)
        same = out["hmc"]["path"].read_bytes() == out["hmc segmented"]["path"].read_bytes()
        log(f"  kernel launches, both hmc runs: {launches['hmc']}; the segmented run wrote the "
            f"whole run's table byte for byte: {same}")
        if not same:
            raise AssertionError("mcmc --sampler hmc --segments 10 wrote another table than the "
                                 "whole run")
        log(f"  checkpoint callbacks in the segmented run: {len(ckpts)} (3 sampling segments)")
        if len(ckpts) != 3:
            raise AssertionError(f"the segmented run called its checkpoint callback "
                                 f"{len(ckpts)} times, not once for each of 3 sampling segments")
        if not np.array_equal(ckpts[-1]["positions"], last_draws[-1]):
            raise AssertionError("the last checkpoint's positions are not the segmented run's "
                                 "last draws")

        _build.reset_counts()
        path = OUT_DIR / "advi.tsv"
        t0 = time.perf_counter()
        stdout = run_cli([*base, "--sampler", "advi", "--samples", "30", "--output", str(path)],
                         capture)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches["advi"] = dict(_build.counts)
        elbo = float(stdout.split("final ELBO")[1].split()[0])
        df = read_table(path, head, 30 * CHAINS)
        out["advi"] = {"wall_s": wall, "elbo": elbo, "ell_mean": float(df["ℓ"].mean()),
                       "fit_line": next(s for s in capture.lines if s.startswith("ADVI:"))}
        log(f"  advi: {out['advi']['fit_line']}; command wall {wall:.1f} s; final ELBO "
            f"{elbo:.3f}; mean ℓ of the draws {out['advi']['ell_mean']:.3f}; kernel launches "
            f"{launches['advi']}")
    finally:
        chees.run_hmc = run_hmc
        logging.getLogger().removeHandler(capture)
    if not math.isfinite(elbo):
        raise AssertionError(f"ADVI's final ELBO is {elbo}")
    for name in ("hmc", "hmc segmented", "advi"):
        ell = out[name]["ell_mean"]
        if not abs(ell - 1.5) <= 0.6:
            raise AssertionError(f"{name}: mean ℓ {ell:.3f} outside 1.5 ± 0.6")
    for tag in ("hmc", "advi"):
        require_launches(f"path 3 ({tag})", launches[tag], ("K1", "K2", "K2b"))
    for v in out.values():
        v.pop("path", None)
    return launches, out


def bernoulli_data(n: int):
    """tests/test_laplace.py's Bernoulli set (rows drawn as there), n rows."""
    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(-3, 3, n))
    f = np.sin(1.5 * x) * 2
    return x, (rng.uniform(size=n) < 1 / (1 + np.exp(-f))).astype(int)


def phase_laplace(dev):
    """Path 3b: mcmc --approx laplace with 8-chain ChEES on a Bernoulli set
    of n = 500; the Laplace marginal's log density and gradient on the card
    against the CPU; 16 K1 launches an evaluation at C = 8."""
    import pandas as pd

    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.inference.hmc import value_and_grad
    from gaplac_tpu_torch.inference.laplace import build_laplace_marginal
    from gaplac_tpu_torch.inference.model import slot_groups_for
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.ops import _build

    log(f"[9] path 3: mcmc --approx laplace, Bernoulli, n = {N_OBS}, 8-chain ChEES, on the card")
    x, yb = bernoulli_data(N_OBS)
    data = OUT_DIR / "bernoulli.tsv"
    pd.DataFrame({"x": x, "y": yb}).to_csv(data, sep="\t", index=False)
    formula = "y : Bernoulli ~| SqExp(:x)"
    path = OUT_DIR / "laplace.tsv"
    _build.reset_counts()
    t0 = time.perf_counter()
    run_cli(["--platform", "cuda", "mcmc", formula, "--data", str(data), "--infer", "x",
             "--approx", "laplace", "--sampler", "chees", "--chains", str(CHAINS), "--samples",
             "20", "--warmup", "20", "--seed", "1", "--output", str(path)])
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(_build.counts)
    read_table(path, ["iteration", "chain", "ℓ"] + [f"fx[{i + 1}]" for i in range(N_OBS)]
               + ["lp", "acceptance_rate", "step_size", "traj_length"], 20 * CHAINS)
    log(f"  command wall {wall:.1f} s; kernel launches {launches}; the table is finite")
    require_launches("path 3 (laplace)", launches, ("K1", "K2", "K2b"))

    spec = parse_formula(formula)
    ck = compile_formula(spec.formula)

    def model(d, dtype):
        X = torch.tensor(x[:, None], dtype=dtype, device=d)
        return build_laplace_marginal(ck, slot_groups_for(ck, ["x"]), X,
                                      torch.as_tensor(yb, dtype=dtype, device=d),
                                      spec.likelihood)

    u = torch.tensor([[-1.2], [-0.9], [-0.4]], dtype=torch.float64)  # ℓ 4.63, 5.77, 8.04
    runs = {}
    for tag, d, dtype in (("card", dev, torch.float32), ("cpu64", "cpu", torch.float64),
                          ("cpu32", "cpu", torch.float32), ("card_plain", dev, torch.float32)):
        with plain_kernels() if tag == "card_plain" else contextlib.nullcontext():
            lp, g = value_and_grad(model(d, dtype).logdensity)(u.to(device=d, dtype=dtype))
        runs[tag] = (lp.cpu(), g.cpu())
    errs = {}
    for i, what in enumerate(("log density", "gradient")):
        errs[what] = check_accuracy(
            f"Laplace {what} at three theta, card f32 against cpu f64", runs["card"][i],
            (runs["cpu32"][i], runs["card_plain"][i]), runs["cpu64"][i])

    m = model(dev, torch.float32)
    vag = value_and_grad(m.logdensity)
    u8 = torch.linspace(-1.5, 0.0, CHAINS, device=dev)[:, None]
    vag(u8)
    torch.cuda.synchronize()
    _build.reset_counts()
    vag(u8)
    torch.cuda.synchronize()
    per_eval = dict(_build.counts)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        vag(u8)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    eval_ms = float(np.median(walls)) * 1e3
    kernels = {e.key[:90]: (e.self_device_time_total / 1e3 / 3, e.count // 3)
               for e in profiled(lambda: vag(u8), 3)
               if e.device_type == torch.autograd.DeviceType.CUDA}
    device = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    log(f"  one value+grad at C = {CHAINS}: kernel launches {per_eval} (K1 must be 16); wall "
        f"{eval_ms:.2f} ms (median of 5); device kernels {device:.2f} ms "
        f"({sum(c for _, c in kernels.values())} CUDA kernels), busy {device / eval_ms:.2f}")
    for name, (ms, count) in top:
        log(f"    {ms:.3f} ms in {count} x {name}")
    if per_eval["K1"] != 16:
        raise AssertionError(f"Laplace: {per_eval['K1']} K1 launches an evaluation, not 16")
    return launches, {"wall_s": wall, "eval_ms": eval_ms, "eval_device_ms": device,
                      "launches_per_eval": per_eval, "rel_err": errs,
                      "top": [[name, ms, count] for name, (ms, count) in top]}


def phase_smc(dev, data):
    """Path 3c: select --estimator smc at 512 particles on path 1's data,
    its SqExp evidence against a float64 quadrature, and K1 and K2 timed at
    the particle batch."""
    import pandas as pd
    from scipy.special import logsumexp

    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.inference.model import build_model
    from gaplac_tpu_torch.inference.smc import particle_chunk, smc_log_evidence_gp
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.ops import _build

    particles = 512
    log(f"[10] path 3: select --estimator smc --particles {particles}, n = {N_OBS}, on the card")
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    try:
        _build.reset_counts()
        t0 = time.perf_counter()
        with batch_recorder() as seen:
            report = run_cli(["-v", "--platform", "cuda", "select", "--estimator", "smc",
                              "--formulae", "y ~| SqExp(:x)", "y ~| OU(:x)", "--data",
                              str(data), "--particles", str(particles)], capture)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(_build.counts)
        lines = list(capture.lines)
    finally:
        logging.getLogger().removeHandler(capture)
    lps = select_lps(report)
    bayes = float(report.split("**Log2 Bayes**:")[1].splitlines()[0])
    stages = [s for s in lines if s.startswith("SMC evidence for")]
    log(f"  command wall {wall:.1f} s; Log2 Bayes {bayes}; {stages}; kernel launches "
        f"{launches}; batches seen: K1 {sorted(set(seen['K1']))}, K2 {sorted(set(seen['K2']))}")
    if any("stopped at inverse temperature" in s for s in lines) or len(stages) != 2:
        raise AssertionError("an SMC run did not reach beta = 1")
    if not bayes > 0:
        raise AssertionError(f"SMC Log2 Bayes {bayes} is not > 0")
    for k in ("K1", "K2"):
        if particles not in seen[k]:
            raise AssertionError(f"{k} never ran at the particle batch {particles}")
    at_batch = {k: seen[k].count(particles) for k in ("K1", "K2")}

    df = pd.read_csv(data, sep="\t")
    x, y = df["x"].to_numpy(), df["y"].to_numpy()
    spec = parse_formula("y ~| SqExp(:x)")
    ck = compile_formula(spec.formula)
    yd = torch.tensor(y, dtype=torch.float32, device=dev)
    model = build_model(ck, ["x"], torch.tensor(x[:, None], dtype=torch.float32, device=dev),
                        yd, spec.likelihood)
    seeded = []
    for seed in range(1, 6):
        res = smc_log_evidence_gp(torch.Generator(device=dev).manual_seed(seed), model, yd,
                                  particle_chunk(N_OBS, N_OBS, 4), n_particles=particles)
        if res.final_beta != 1.0:
            raise AssertionError(f"SMC seed {seed} ended at beta {res.final_beta}")
        seeded.append(res.log_evidence)
    sd = float(np.std(seeded, ddof=1))
    # quadrature over a 400-point grid of l on Uniform(0, 20), float64 on the card
    ls = torch.linspace(1e-3, 20 - 1e-3, 400, dtype=torch.float64, device=dev)
    xd = torch.as_tensor(x, device=dev)
    d2 = (xd[:, None] - xd[None, :]) ** 2
    S = torch.exp(-d2 / (2 * ls[:, None, None] ** 2)) + 1.1 * torch.eye(N_OBS, device=dev,
                                                                          dtype=torch.float64)
    L = torch.linalg.cholesky(S)
    a = torch.linalg.solve_triangular(L, torch.tensor(y, device=dev).expand(400, -1)[..., None],
                                      upper=False)[..., 0]
    quad_lps = (-0.5 * (a * a).sum(-1) - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
                - 0.5 * N_OBS * math.log(2 * math.pi)).cpu().numpy()
    quad = float(logsumexp(quad_lps) + math.log(float(ls[1] - ls[0])) - math.log(20.0))
    del S, L
    tol = max(0.5, 3 * sd)
    log(f"  SqExp evidence {lps[0]:.4f} (CLI, seed 0) against the float64 quadrature {quad:.4f}: "
        f"off by {abs(lps[0] - quad):.4f} (tolerance {tol:.4f} = max(0.5, 3 x sd {sd:.4f} of "
        f"seeds 1-5: {', '.join(f'{v:.4f}' for v in seeded)}))")
    if not abs(lps[0] - quad) <= tol:
        raise AssertionError("SMC SqExp evidence is off the quadrature")
    return launches, {"wall_s": wall, "log2_bayes": bayes, "lps": lps, "quadrature": quad,
                      "seeded": seeded, "sd": sd, "launches_at_512": at_batch,
                      "stages": stages}


def batch_rows(dev) -> tuple:
    """K1 and K2 at SMC's particle batch, (512, 500, 500) float32: their
    error against the plain versions and phase 5's timing rows."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.ops.cholesky import chol_batched_cuda, chol_batched_plain
    from gaplac_tpu_torch.ops.gram import gram_cuda, gram_plain

    B = 512
    log(f"[10b] K1 and K2 at ({B}, {N_OBS}, {N_OBS}) float32 against their plain versions")
    rng = np.random.default_rng(12)
    x = rng.uniform(-5, 5, N_OBS)
    ls = rng.uniform(0.3, 12.0, B)
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    X = torch.as_tensor(x[:, None], device=dev)
    p = torch.as_tensor(ls[:, None], device=dev)
    K64 = gram_plain(ck, p, X, None, 1.1)
    errs = {}
    Kk = gram_cuda(ck, p.float(), X.float(), None, 1.1)
    Kp = gram_plain(ck, p.float(), X.float(), None, 1.1)
    check_accuracy(f"K2 ({B},{N_OBS},{N_OBS}) float32", Kk, Kp, K64)
    errs["K2"] = float((Kk - Kp).abs().max())
    L64 = chol_batched_plain(K64)
    A = K64.float()
    Lk, Lp = chol_batched_cuda(A), chol_batched_plain(A)
    check_accuracy(f"K1 ({B},{N_OBS},{N_OBS}) float32", Lk, Lp, L64)
    errs["K1"] = float((Lk - Lp).abs().max())
    del K64, L64, Kk, Kp, Lk, Lp
    n = N_OBS
    pf, Xf = p.float(), X.float()
    rows = {
        "K1 B=512": (lambda: chol_batched_cuda(A), lambda: chol_batched_plain(A),
                     lambda: torch.linalg.cholesky_ex(A), B * n ** 3 / 3,
                     B * (n * (n + 1) // 2 + n * n) * 4),
        "K2 B=512": (lambda: gram_cuda(ck, pf, Xf, None, 1.1),
                     lambda: gram_plain(ck, pf, Xf, None, 1.1), None, 6 * B * n * n,
                     B * n * n * 4 + 4 * (n + B)),
    }
    return errs, time_rows(rows)


def time_rows(rows: dict) -> dict:
    """Each (kernel, plain version, library call or None, flops, bytes) row
    timed: CUDA events in turns (plain, kernel, kernel, plain, then the
    library twice), the profiler's device time, and the bound with its
    share of the device time."""
    times = {}
    for k, (kern, plain, lib, flops, nbytes) in rows.items():
        tp1, tk1, tk2, tp2 = time_ms(plain), time_ms(kern), time_ms(kern), time_ms(plain)
        tl = float(np.median([time_ms(lib), time_ms(lib)])) if lib is not None else None
        dk = device_ms(kern)
        dl = device_ms(lib) if lib is not None else None
        b, by = bound_ms(flops, nbytes)
        times[k] = {"ms": float(np.median([tk1, tk2])), "plain_ms": float(np.median([tp1, tp2])),
                    "library_ms": tl, "bound_ms": b, "bound_by": by, "device_ms": dk,
                    "library_device_ms": dl, "share": b / dk}
        log(f"  {k}: kernel {tk1:.4f} / {tk2:.4f} ms, plain {tp1:.4f} / {tp2:.4f} ms, library "
            f"{'none' if tl is None else f'{tl:.4f} ms'}, bound {b:.4g} ms ({by}); device "
            f"time: kernel {dk:.4f} ms (share {b / dk:.3f}), library "
            f"{'none' if dl is None else f'{dl:.4f} ms'}")
    return times


def phase_fitplot(dev, data):
    """Path 3d: fitplot's component posteriors (``component_posteriors``, the
    numbers of the command without its drawing) at n = 4096 on path 2's
    data, card (kernels, float32) against the CPU (float64); the blocked
    solve against torch.linalg.solve_triangular at the shape fitplot
    solves."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.cli.common import design_matrix, response_vector
    from gaplac_tpu_torch.cli.fitplot_cmd import component_posteriors
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.ops import _build
    from gaplac_tpu_torch.ops.cholesky import blocked_solve_lower

    log(f"[11] path 3: fitplot's component posteriors, n = {N_BIG}: card f32 against cpu f64")
    formula = "y ~| SqExp(:x; l=1.5) + OU(:x; l=3)"
    df = read_table(data, ["x", "y"], N_BIG)
    spec = parse_formula(formula)
    ck = compile_formula(spec.formula)
    runs, launches = {}, None
    for tag, d, dtype in (("card", dev, torch.float32), ("cpu64", "cpu", torch.float64),
                          ("cpu32", "cpu", torch.float32), ("card_plain", dev, torch.float32)):
        X = torch.tensor(design_matrix(df, ck), dtype=dtype, device=d)
        y = torch.tensor(response_vector(df, spec), dtype=dtype, device=d)
        if tag == "card":
            _build.reset_counts()
            t0 = time.perf_counter()
        with plain_kernels() if tag == "card_plain" else contextlib.nullcontext():
            runs[tag] = component_posteriors(ck, ck.default_params(dtype, d), X, y, 1.1,
                                             range(len(ck.terms)))
        if tag == "card":
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.counts)
    log(f"  card: {wall:.2f} s, kernel launches {launches}")
    require_launches("path 3 (fitplot)", launches, ("K2", "K3"))
    errs = {}
    for i, (t, mu, sd) in enumerate(runs["card"]):
        for j, what in ((1, "mean"), (2, "sd")):
            col = lambda tag, dt: torch.as_tensor(runs[tag][i][j], dtype=dt)
            errs[f"term {t} {what}"] = check_accuracy(
                f"fitplot component {t} {what}", col("card", torch.float32),
                (col("cpu32", torch.float32), col("card_plain", torch.float32)),
                col("cpu64", torch.float64))

    # the card machine has no matplotlib: fitplot's drawing is tested on the CPU
    # (tests/test_torch_fitplot.py), and its numbers here
    log(f"[11b] blocked_solve_lower against torch.linalg.solve_triangular at "
        f"({N_BIG}, {N_BIG} x {N_BIG}) float32")
    X64 = torch.tensor(design_matrix(df, ck), device=dev)
    p64 = ck.default_params(torch.float64, dev)
    L64 = torch.linalg.cholesky(ck.gram(p64, X64, diag=1.1))
    from gaplac_tpu_torch.cli.fitplot_cmd import term_gram

    B64 = term_gram(ck, 0, p64, X64)
    ref = torch.linalg.solve_triangular(L64, B64, upper=False)
    L32, B32 = L64.float(), B64.float()
    solve_err = check_accuracy(
        "blocked solve float32 against float64", blocked_solve_lower(L32, B32),
        torch.linalg.solve_triangular(L32, B32, upper=False), ref)
    del L64, B64, ref
    n = N_BIG
    times = time_rows({"blocked solve": (
        lambda: blocked_solve_lower(L32, B32), lambda: torch.linalg.solve_triangular(L32, B32,
                                                                                     upper=False),
        lambda: torch.linalg.solve_triangular(L32, B32, upper=False), n * n * n,
        (n * (n + 1) // 2 + 2 * n * n) * 4)})
    return launches, {"wall_s": wall, "rel_err": errs,
                      "blocked_solve": {"rel_err": solve_err, **times["blocked solve"]}}


# ---------------------------------------------------------------------------
# path 4: the --approx rff low-rank path
# ---------------------------------------------------------------------------

RFF_FLAGS = ["--approx", "rff", "--rff-features", str(M_RFF)]
#: the four runs of the float32 rule: (tag, device, dtype); card_plain runs
#: with every kernel replaced by its plain version
RULE_RUNS = (("card", "cuda", torch.float32), ("cpu64", "cpu", torch.float64),
             ("cpu32", "cpu", torch.float32), ("card_plain", "cuda", torch.float32))


def float32_rule(what: str, run, runs=RULE_RUNS) -> dict:
    """``run(device, dtype)`` -> {part: numbers}, once for each of ``runs``;
    each part of the card's float32 run held to the float64 run by
    check_accuracy, against the other float32 runs (card_plain runs with
    every kernel replaced by its plain version)."""
    out = {}
    for tag, d, dtype in runs:
        with plain_kernels() if tag == "card_plain" else contextlib.nullcontext():
            out[tag] = {k: torch.as_tensor(np.asarray(v.detach().cpu() if torch.is_tensor(v) else v))
                        for k, v in run(d, dtype).items()}
    ref = next(tag for tag, _, dtype in runs if dtype == torch.float64)
    plains = [tag for tag, _, dtype in runs if dtype == torch.float32 and tag != "card"]
    return {part: check_accuracy(
        f"{what} {part}, card f32 against {ref}", out["card"][part].float(),
        tuple(out[t][part].float() for t in plains), out[ref][part].double())
        for part in out["card"]}


def cli_precision(d: str, dtype) -> list:
    return ["--platform", d, "--precision", "f32" if dtype == torch.float32 else "f64"]


def rff_model(x: np.ndarray, y: np.ndarray, d, dtype, m: int = M_RFF):
    """The mcmc command's rff model of "y ~| SqExp(:x)" (--rff-seed 0)."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.inference.model import build_model
    from gaplac_tpu_torch.kernels.covariance import compile_formula

    spec = parse_formula("y ~| SqExp(:x)")
    return build_model(compile_formula(spec.formula), ["x"],
                       torch.tensor(x[:, None], dtype=dtype, device=d),
                       torch.tensor(y, dtype=dtype, device=d), spec.likelihood,
                       approx="rff", rff_features=m)


def rff_quadrature(dev, x: np.ndarray, y: np.ndarray, m: int = M_RFF) -> dict:
    """The posterior of l for "y ~| SqExp(:x)" with --approx rff (the same
    feature map, --rff-seed 0) under the flat Uniform(0, 20) prior, float64
    on the card: the port's lowrank_logpdf on a grid of 400 over (0, 20), then
    three grids of 241 over the mean +- 12 sd (sd at least the last grid's
    step).  The mean, sd and log evidence from the last grid."""
    from scipy.special import logsumexp

    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.kernels.features import build_feature_map
    from gaplac_tpu_torch.ops.lowrank import lowrank_logpdf

    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    X = torch.tensor(x[:, None], dtype=torch.float64, device=dev)
    yd = torch.tensor(y, dtype=torch.float64, device=dev)
    fm = build_feature_map(ck, [X], num_features=m, seed=0)

    def lps(grid):
        g = torch.as_tensor(grid, device=dev)[:, None]
        return torch.cat([lowrank_logpdf(fm.phi(c, X), 1.1, yd) for c in g.split(8)]).cpu().numpy()

    grid = np.linspace(0.02, 19.98, 400)
    lp = lps(grid)
    for _ in range(3):
        w = np.exp(lp - lp.max())
        mean = float((grid * w).sum() / w.sum())
        sd = max(float(np.sqrt(max((grid ** 2 * w).sum() / w.sum() - mean ** 2, 0.0))),
                 grid[1] - grid[0])
        grid = np.linspace(max(mean - 12 * sd, 1e-3), min(mean + 12 * sd, 20 - 1e-3), 241)
        lp = lps(grid)
    w = np.exp(lp - lp.max())
    mean = float((grid * w).sum() / w.sum())
    sd = float(np.sqrt((grid ** 2 * w).sum() / w.sum() - mean ** 2))
    log_z = float(logsumexp(lp) + math.log(grid[1] - grid[0]) - math.log(20.0))
    peaks = [i for i in range(1, len(lp) - 1) if lp[i - 1] < lp[i] >= lp[i + 1]]
    return {"mean": mean, "sd": sd, "log_evidence": log_z, "step": float(grid[1] - grid[0]),
            "modes": [[float(grid[i]), float(lp[i] - lp.max())] for i in peaks]}


def row_block_errors(dev, x, y) -> dict:
    """What summing the products over the n rows in blocks (ops/lowrank.py
    ROW_BLOCK) does in float32 on the card, against one product of all the
    rows: the largest error of the model's log density against float64 over
    l in [1.2, 2.6], and the least eigenvalue of the capacitance matrix at
    d = 0.1 (the report's), which is 1 or more in exact arithmetic."""
    from gaplac_tpu_torch.ops import lowrank

    ls = np.linspace(1.2, 2.6, 57)
    u = torch.tensor(np.log(ls / 20) - np.log1p(-ls / 20))[:, None]
    m64, m32 = rff_model(x, y, dev, torch.float64), rff_model(x, y, dev, torch.float32)
    fm, X = rff_features(dev, x, torch.float32)
    phi = fm.phi(torch.tensor([[1.5], [2.0], [2.5]], device=dev), X)
    out = {}
    blocked = lowrank.rows_matmul
    with torch.no_grad():
        ref = torch.cat([m64.logdensity(c.to(dev)) for c in u.split(8)])
        for name, product in (("blocks", blocked), ("one product", lambda a, b: a.mT @ b)):
            lowrank.rows_matmul = product
            try:
                lp = torch.cat([m32.logdensity(c.to(dev, torch.float32)) for c in u.split(8)])
                A = torch.eye(M_RFF, device=dev) + lowrank.rows_matmul(phi, phi / 0.1)
            finally:
                lowrank.rows_matmul = blocked
            eig = torch.linalg.eigvalsh(0.5 * (A + A.mT).double())[:, 0]
            out[name] = {"logdensity_max_abs_err": float((lp.double() - ref).abs().max()),
                         "capacitance_min_eig_d0.1": eig.tolist()}
    log(f"  float32 rows in blocks of {lowrank.ROW_BLOCK} against one product, n = {N_RFF}: "
        + json.dumps(out))
    return out


@contextlib.contextmanager
def lowrank_chol_counter():
    """The number of capacitance factorizations (ops/lowrank.py::lowrank_chol
    calls) inside the block: {"calls": N}."""
    from gaplac_tpu_torch.ops import lowrank

    seen = {"calls": 0}
    chol = lowrank.lowrank_chol

    def counted(*a, **kw):
        seen["calls"] += 1
        return chol(*a, **kw)

    lowrank.lowrank_chol = counted
    try:
        yield seen
    finally:
        lowrank.lowrank_chol = chol


def phase_rff_data():
    """Path 4a: the data, sample --approx rff at n = 65536 (a prior draw, no
    factorization), and a posterior draw at 1024 points (one K1 launch)."""
    from gaplac_tpu_torch.ops import _build

    log(f"[12] path 4: sample --approx rff --rff-features {M_RFF}, the prior at n = {N_RFF} "
        f"and a posterior draw at {N_AT} points, on the card")
    data, post = OUT_DIR / f"data_{N_RFF}.tsv", OUT_DIR / "rff_posterior_draw.tsv"
    walls, launches = {}, {}
    for name, argv in (
        ("sample", ["sample", "y :~| SqExp(:x; l=1.5)", "--at",
                    f"x = rand(Uniform(-5,5), {N_RFF})", "--seed", "1", "--output", str(data)]),
        ("sample posterior", ["sample", "y ~| SqExp(:x)", "--data", str(data), "--at",
                              f"x = rand(Uniform(-5,5), {N_AT})", "--seed", "2", "--output",
                              str(post)]),
    ):
        _build.reset_counts()
        t0 = time.perf_counter()
        run_cli(["--platform", "cuda", *argv, *RFF_FLAGS])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = dict(_build.counts)
    df = read_table(data, ["x", "y"], N_RFF)
    read_table(post, ["x", "y"], N_AT)
    log(f"  walls (s): {walls}; kernel launches {launches}; both tables finite, columns x, y")
    if any(launches["sample"].values()):
        raise AssertionError("the rff prior draw launched a kernel; it factors nothing")
    if launches["sample posterior"] != {"K1": 1, "K2": 0, "K2b": 0, "K3": 0}:
        raise AssertionError("the rff posterior draw must launch K1 once and nothing else")
    return launches, walls, df["x"].to_numpy(), df["y"].to_numpy()


def phase_rff_mcmc(dev, data, x, y):
    """Path 4b: mcmc --approx rff at n = 65536, NUTS and 8-chain ChEES: one K1
    launch a capacitance factorization and no gram; the posterior mean of l
    against a quadrature; the log density and gradient at C = 2 by the
    float32 rule; one value+grad at C = 8 profiled."""
    from gaplac_tpu_torch.inference.hmc import value_and_grad
    from gaplac_tpu_torch.ops import _build

    log(f"[13] path 4: mcmc --approx rff, n = {N_RFF}, m = {M_RFF}, on the card")
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    base = ["-v", "--platform", "cuda", "mcmc", "y ~| SqExp(:x)", "--data", str(data), "--infer",
            "x", "--seed", "1", "--no-latents", *RFF_FLAGS]
    cols = ["iteration", "chain", "ℓ", "lp", "acceptance_rate"]
    # ChEES extends the NUTS chain (--resume): its first, cold transitions at
    # n = 65536 shrink the step size to where a trajectory takes 1000
    # leapfrogs.  The posterior of l has two modes here (the random features'),
    # so both runs are long enough to cross between them
    runs = (("nuts", ["--samples", "300", "--warmup", "100"],
             cols + ["tree_depth", "numerical_error"], 300),
            ("chees", ["--sampler", "chees", "--chains", str(CHAINS), "--samples", "60",
                       "--warmup", "30", "--resume", str(OUT_DIR / "rff_nuts.tsv")],
             cols + ["step_size", "traj_length"], 60 * CHAINS))
    out, launches = {}, {}
    try:
        for name, extra, columns, rows in runs:
            path = OUT_DIR / f"rff_{name}.tsv"
            _build.reset_counts()
            t0 = time.perf_counter()
            with lowrank_chol_counter() as chols:
                run_cli([*base, *extra, "--output", str(path)], capture)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[name] = dict(_build.counts)
            df = read_table(path, columns, rows)
            rate_line = next(s for s in capture.lines if "transitions/s" in s)
            summary = next(s for s in capture.lines if s.startswith("ℓ: mean"))
            out[name] = {"path": path, "wall_s": wall, "ell_mean": float(df["ℓ"].mean()),
                         "transitions_per_s": float(rate_line.split("transitions/s")[0]
                                                    .split("(")[-1]),
                         "summary": summary, "capacitance_factorizations": chols["calls"]}
            log(f"  {name}: {rate_line}; command wall {wall:.1f} s; {summary}; kernel launches "
                f"{launches[name]}, capacitance factorizations {chols['calls']}")
            if launches[name]["K1"] != chols["calls"] or chols["calls"] == 0:
                raise AssertionError(f"rff {name}: {launches[name]['K1']} K1 launches for "
                                     f"{chols['calls']} capacitance factorizations")
            if launches[name]["K2"] or launches[name]["K2b"] or launches[name]["K3"]:
                raise AssertionError(f"rff {name} launched a gram or tile kernel")
    finally:
        logging.getLogger().removeHandler(capture)

    quad = rff_quadrature(dev, x, y)
    tol = 4 * quad["sd"] / math.sqrt(50)
    log(f"  quadrature (float64, the same features): mean ℓ {quad['mean']:.5f}, sd "
        f"{quad['sd']:.5f}, modes (ℓ, log density below the top) {quad['modes']}; tolerance "
        f"4 sd / sqrt(50) = {tol:.5f}")
    for name in ("nuts", "chees"):
        off = abs(out[name]["ell_mean"] - quad["mean"])
        log(f"  {name}: mean ℓ off the quadrature by {off:.5f}")
        if not off <= tol:
            raise AssertionError(f"rff {name}: mean ℓ {out[name]['ell_mean']:.5f} is off the "
                                 f"quadrature's {quad['mean']:.5f} by more than {tol:.5f}")

    # the log density and its gradient at C = 2, either side of the posterior mean
    # (2 sd, or half the mean where the posterior is that wide)
    step = min(2 * quad["sd"], 0.5 * quad["mean"])
    ls = np.array([quad["mean"] - step, quad["mean"] + step])
    u2 = np.log(ls / 20) - np.log1p(-ls / 20)

    def density(d, dtype):
        lp, g = value_and_grad(rff_model(x, y, d, dtype).logdensity)(
            torch.as_tensor(u2[:, None], dtype=dtype, device=d))
        return {"log density": lp, "gradient": g}

    errs = float32_rule("rff model at C = 2", density)

    # one value+grad at C = 8: launches, wall, and where the device time goes
    model = rff_model(x, y, dev, torch.float32)
    vag = value_and_grad(model.logdensity)
    u8 = torch.as_tensor(np.linspace(u2[0] - 0.05, u2[1] + 0.05, CHAINS)[:, None],
                         dtype=torch.float32, device=dev)
    vag(u8)
    torch.cuda.synchronize()
    _build.reset_counts()
    with torch.no_grad():
        model.logdensity(u8)
    torch.cuda.synchronize()
    per_forward = dict(_build.counts)
    _build.reset_counts()
    vag(u8)
    torch.cuda.synchronize()
    per_eval = dict(_build.counts)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        vag(u8)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    eval_ms = float(np.median(walls)) * 1e3
    profile = device_split(lambda: vag(u8), 3)
    log(f"  one value+grad at C = {CHAINS}: kernel launches {per_eval} (forward alone "
        f"{per_forward}); wall {eval_ms:.2f} ms (median of 5); device {profile['device_ms']:.2f} "
        f"ms in {profile['kernels']} CUDA kernels, busy {profile['device_ms'] / eval_ms:.2f}")
    for cat, (ms, count) in profile["by_category"].items():
        log(f"    {cat}: {ms:.3f} ms in {count} kernels")
    for name, ms, count in profile["top"]:
        log(f"    {ms:.3f} ms in {count} x {name}")
    if per_forward != {"K1": 1, "K2": 0, "K2b": 0, "K3": 0} or per_eval["K1"] != 1:
        raise AssertionError(f"rff evaluation: {per_forward} in a forward pass, {per_eval} in "
                             f"a value+grad; one K1 launch and no other expected")
    fm, X = rff_features(dev, x, torch.float32)
    phi_ms = device_ms(lambda: fm.phi(20 * torch.sigmoid(u8), X), 5)
    log(f"  the feature map alone (forward, C = {CHAINS}): {phi_ms:.3f} ms of device time")
    k1_err = check_capacitance(dev, x, u8)
    for v in out.values():
        v["path"] = str(v["path"])
    return launches, {**out, "quadrature": quad, "rel_err": errs, "eval_ms": eval_ms,
                      "eval_launches": per_eval, "forward_launches": per_forward,
                      "profile": profile, "feature_map_ms": phi_ms,
                      "k1_capacitance_err": k1_err, "row_blocks": row_block_errors(dev, x, y)}


def rff_features(dev, x: np.ndarray, dtype):
    """Path 4's feature map ("y ~| SqExp(:x)", m = 512, --rff-seed 0) and its
    input matrix."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.kernels.features import build_feature_map

    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    X = torch.tensor(x[:, None], dtype=dtype, device=dev)
    return build_feature_map(ck, [X], num_features=M_RFF, seed=0), X


def check_capacitance(dev, x, u8) -> float:
    """K1 against its plain version on the capacitance matrices of path 4's
    model at u8, (8, 512, 512) float32."""
    from gaplac_tpu_torch.ops.cholesky import chol_batched_cuda, chol_batched_plain

    fm, X = rff_features(dev, x, torch.float64)
    phi = fm.phi(20 * torch.sigmoid(u8.double()), X)
    A64 = torch.eye(M_RFF, dtype=torch.float64, device=dev) + phi.mT @ phi / 1.1
    del phi
    A32 = A64.float()
    Lk, Lp = chol_batched_cuda(A32), chol_batched_plain(A32)
    check_accuracy(f"K1 capacitance ({CHAINS},{M_RFF},{M_RFF}) float32", Lk, Lp,
                   chol_batched_plain(A64))
    return float((Lk - Lp).abs().max())


def device_split(fn, calls: int, windows: int = 3) -> dict:
    """The device time of ``fn``'s CUDA kernels a call (the profiler's
    fullest window), by category: the feature map's trigonometry, cuBLAS's
    GEMMs and triangular solves, batched LU (the sde path's solves and
    their row swaps), K1, and the rest (elementwise and reductions)."""
    kernels = {e.key: (e.self_device_time_total / 1e3 / calls, e.count // calls)
               for e in profiled(fn, calls, windows)
               if e.device_type == torch.autograd.DeviceType.CUDA}

    def category(name):
        low = name.lower()
        if "chol_batched" in low:
            return "K1"
        if "getrf" in low or "getrs" in low or "laswp" in low or "displace_pointers" in low:
            return "batched LU"
        if "trsm" in low or "trsv" in low:
            return "triangular solves"
        if "gemm" in low or "gemv" in low:
            return "matmul"
        if "cos_kernel" in low or "sin_kernel" in low:
            return "feature map cos/sin"
        return "other"

    by_cat = {}
    for name, (ms, count) in kernels.items():
        c = by_cat.setdefault(category(name), [0.0, 0])
        c[0] += ms
        c[1] += count
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_ms": sum(ms for ms, _ in kernels.values()),
            "kernels": sum(c for _, c in kernels.values()),
            "by_category": {k: tuple(v) for k, v in by_cat.items()},
            "top": [[name[:100], ms, count] for name, (ms, count) in top]}


def phase_rff_select(data):
    """Path 4c: select --formulae SqExp vs OU --approx rff at n = 65536, by the
    float32 rule."""
    from gaplac_tpu_torch.ops import _build

    log(f"[14] path 4: select --formulae --approx rff, n = {N_RFF}, on the card")
    formulae = ["y ~| SqExp(:x)", "y ~| OU(:x)"]
    argv = ["select", "--formulae", *formulae, "--data", str(data), *RFF_FLAGS]
    _build.reset_counts()
    t0 = time.perf_counter()
    report = run_cli(["--platform", "cuda", *argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.counts)
    log(f"  command wall {wall:.2f} s; kernel launches {launches}; Log2 Bayes "
        f"{report.split('**Log2 Bayes**:')[1].splitlines()[0].strip()}")
    if launches != {"K1": 2, "K2": 0, "K2b": 0, "K3": 0}:
        raise AssertionError("rff select: one K1 launch a formula and nothing else expected")
    errs = float32_rule("rff select lp", lambda d, dt: dict(zip(
        formulae, select_lps(run_cli([*cli_precision(d, dt), *argv])))))
    return launches, {"wall_s": wall, "rel_err": errs}


def phase_rff_smc(dev, data):
    """Path 4d: select --estimator smc --particles 512 --approx rff at
    n = 16384: beta reaches 1, Log2 Bayes > 0, the SqExp evidence against a
    float64 quadrature within max(0.5, 3 sd of five seeded runs)."""
    import pandas as pd

    from gaplac_tpu_torch.inference.smc import particle_chunk, smc_log_evidence_gp
    from gaplac_tpu_torch.ops import _build

    particles = 512
    log(f"[15] path 4: select --estimator smc --particles {particles} --approx rff, "
        f"n = {N_RFF_SMC}, on the card")
    df = pd.read_csv(data, sep="\t").head(N_RFF_SMC)
    small = OUT_DIR / f"data_{N_RFF_SMC}.tsv"
    df.to_csv(small, sep="\t", index=False)
    x, y = df["x"].to_numpy(), df["y"].to_numpy()
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    try:
        _build.reset_counts()
        t0 = time.perf_counter()
        with batch_recorder() as seen:
            report = run_cli(["-v", "--platform", "cuda", "select", "--estimator", "smc",
                              "--formulae", "y ~| SqExp(:x)", "y ~| OU(:x)", "--data", str(small),
                              "--particles", str(particles), *RFF_FLAGS], capture)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.counts)
        lines = list(capture.lines)
    finally:
        logging.getLogger().removeHandler(capture)
    lps = select_lps(report)
    bayes = float(report.split("**Log2 Bayes**:")[1].splitlines()[0])
    stages = [s for s in lines if s.startswith("SMC evidence for")]
    log(f"  command wall {wall:.1f} s; Log2 Bayes {bayes}; {stages}; kernel launches "
        f"{launches}; K1 batches {sorted(set(seen['K1']))}")
    if any("stopped at inverse temperature" in s for s in lines) or len(stages) != 2:
        raise AssertionError("an rff SMC run did not reach beta = 1")
    if not bayes > 0:
        raise AssertionError(f"rff SMC Log2 Bayes {bayes} is not > 0")
    if launches["K2"] or launches["K2b"] or launches["K3"] or not launches["K1"]:
        raise AssertionError(f"rff SMC: K1 launches only expected, got {launches}")

    model = rff_model(x, y, dev, torch.float32)
    yd = torch.tensor(y, dtype=torch.float32, device=dev)
    chunk = particle_chunk(N_RFF_SMC, M_RFF, 4)
    seeded = []
    for seed in range(1, 6):
        res = smc_log_evidence_gp(torch.Generator(device=dev).manual_seed(seed), model, yd, chunk,
                                  n_particles=particles)
        if res.final_beta != 1.0:
            raise AssertionError(f"rff SMC seed {seed} ended at beta {res.final_beta}")
        seeded.append(res.log_evidence)
    sd = float(np.std(seeded, ddof=1))
    quad = rff_quadrature(dev, x, y)
    tol = max(0.5, 3 * sd)
    log(f"  SqExp evidence {lps[0]:.4f} (CLI, seed 0) against the float64 quadrature "
        f"{quad['log_evidence']:.4f}: off by {abs(lps[0] - quad['log_evidence']):.4f} (tolerance "
        f"{tol:.4f} = max(0.5, 3 x sd {sd:.4f} of seeds 1-5: "
        f"{', '.join(f'{v:.4f}' for v in seeded)})); {chunk} particles a chunk")
    if not abs(lps[0] - quad["log_evidence"]) <= tol:
        raise AssertionError("rff SMC SqExp evidence is off the quadrature")
    return launches, {"wall_s": wall, "log2_bayes": bayes, "lps": lps, "quadrature": quad,
                      "seeded": seeded, "sd": sd, "stages": stages, "chunk": chunk,
                      "k1_batches": sorted(set(seen["K1"]))}


def phase_rff_predict(data, chain):
    """Path 4e: predict --approx rff --mcmc <ChEES chain> at 1024 points, and
    its first draws by the float32 rule."""
    from gaplac_tpu_torch.ops import _build

    log(f"[16] path 4: predict --approx rff --mcmc (the ChEES chain), n = {N_RFF}, "
        f"{N_AT} points, on the card")
    out = OUT_DIR / "rff_predict.tsv"

    def predict(chain_path, out_path):
        return ["predict", "y ~| SqExp(:x)", "--data", str(data), "--at",
                f"x = rand(Uniform(-5,5), {N_AT})", "--seed", "2", "--mcmc", str(chain_path),
                "--output", str(out_path), *RFF_FLAGS]

    _build.reset_counts()
    t0 = time.perf_counter()
    run_cli(["--platform", "cuda", *predict(chain, out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.counts)
    df = read_table(out, ["x", "ymu", "yQ050", "yQ950"], N_AT)
    log(f"  command wall {wall:.2f} s; kernel launches {launches}")
    if not ((df["yQ050"] <= df["ymu"]) & (df["ymu"] <= df["yQ950"])).all():
        raise AssertionError("rff predict: ymu outside [yQ050, yQ950]")
    if launches["K2"] or launches["K2b"] or launches["K3"] or not launches["K1"]:
        raise AssertionError(f"rff predict: K1 launches only expected, got {launches}")
    return launches, {"wall_s": wall, "rel_err": check_predict(chain, predict, "rff_predict")}


def phase_rff_fitplot(x, y):
    """Path 4f: fitplot's component posteriors of SqExp + OU with
    --rff-features 1024 (m_total 2048: the 2-D capacitance takes the blocked
    route through K3) at n = 65536, by the float32 rule."""
    import pandas as pd

    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.cli.common import design_matrix
    from gaplac_tpu_torch.cli.fitplot_cmd import lowrank_component_posteriors
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.kernels.features import build_feature_map
    from gaplac_tpu_torch.ops import _build

    log(f"[17] path 4: fitplot --approx rff --rff-features {M_RFF_FITPLOT}, two leaves, "
        f"n = {N_RFF}")
    ck = compile_formula(parse_formula("y ~| SqExp(:x; l=1.5) + OU(:x; l=3)").formula)
    info = {}

    design = design_matrix(pd.DataFrame({"x": x}), ck)  # a column for each leaf on x

    def components(d, dtype):
        first = not info  # the card's run, first of RULE_RUNS: timed and counted
        X = torch.tensor(design, dtype=dtype, device=d)
        fm = build_feature_map(ck, [X], num_features=M_RFF_FITPLOT, seed=0)
        if first:
            _build.reset_counts()
            t0 = time.perf_counter()
        got = lowrank_component_posteriors(fm, ck.default_params(dtype, d), X,
                                           torch.tensor(y, dtype=dtype, device=d), 1.1,
                                           range(len(ck.terms)))
        if first:
            torch.cuda.synchronize()
            info.update(wall_s=time.perf_counter() - t0, launches=dict(_build.counts),
                        m_total=fm.m_total)
        return {f"term {t} {what}": v for t, mu, sd in got
                for what, v in (("mean", mu), ("sd", sd))}

    errs = float32_rule("rff fitplot component", components)
    log(f"  card: {info['wall_s']:.2f} s, m_total {info['m_total']}, kernel launches "
        f"{info['launches']}")
    if info["launches"]["K3"] <= 0 or info["launches"]["K1"]:
        raise AssertionError("rff fitplot at m_total 2048 must factor through K3's blocked route")
    return info.pop("launches"), {**info, "rel_err": errs}


# ---------------------------------------------------------------------------
# path 5: the --approx sde state-space path and --approx auto
# ---------------------------------------------------------------------------

N_OU = 1 << 20        # rows of the OU path (gaplac_tpu's bench_sde.py width)
N_SQEXP = 1 << 17     # rows of the SqExp (d = 6) path
N_QP = 16384          # rows of the quasi-periodic d = 42 gradient (bench_sde.py)
N_QP_PREDICT = 1 << 17  # rows of the quasi-periodic predict (bench_sde_predict.py)
N_NONGAUSS = 1 << 16  # rows of the Laplace and whitened models
N_SMC_CUT = 16384     # rows of select --estimator smc --approx sde (a cut, below)
PERSONS, VISITS = 4096, 16  # the longitudinal set: 65536 rows
SDE = ["--approx", "sde"]
QP_FORMULA = "y ~| Periodic(:x; p=3.0) * Matern32(:x)"
LONGITUDINAL = "y ~| OU(:t)*Cat(:PersonID) + Cat(:PersonID) + Noise"
#: the float32 rule of path 5: RULE_RUNS without card_plain, since no kernel
#: of the port is on the sde path (the CPU's float32 run is its plain run)
SDE_RULE_RUNS = tuple(r for r in RULE_RUNS if r[0] != "card_plain")


def sde_model(formula: str, x: np.ndarray, y: np.ndarray, d, dtype, infer=("x",), **kw):
    """build_model(..., approx="sde") of a one-variable formula on (x, y);
    every leaf on x reads its own copy of the column."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.inference.model import build_model
    from gaplac_tpu_torch.kernels.covariance import compile_formula

    spec = parse_formula(formula)
    ck = compile_formula(spec.formula)
    X = torch.tensor(np.repeat(np.asarray(x, float)[:, None], len(ck.varnames), 1),
                     dtype=dtype, device=d)
    return build_model(ck, list(infer), X, torch.tensor(y, dtype=dtype, device=d),
                       spec.likelihood, approx=kw.pop("approx", "sde"), **kw)


def logit_l(ls) -> np.ndarray:
    """The sampler's coordinate u of lengthscales l under Uniform(0, 20)."""
    ls = np.asarray(ls, float)
    return np.log(ls / 20) - np.log1p(-ls / 20)


def profile_vg(name: str, model, u: torch.Tensor, reps: int = 5, windows: int = 3) -> dict:
    """One value+grad of ``model`` at u on the card: its wall (median of
    ``reps`` after a warmup), peak memory, CUDA launches and device time by
    op (the profiler's fullest of ``windows``), and the port's kernel launches."""
    from gaplac_tpu_torch.inference.hmc import value_and_grad
    from gaplac_tpu_torch.ops import _build

    vag = value_and_grad(model.logdensity)
    vag(u)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        vag(u)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {k: v // reps for k, v in _build.counts.items()}
    peak = torch.cuda.max_memory_allocated()
    wall = float(np.median(walls)) * 1e3
    prof = device_split(lambda: vag(u), 1, windows)
    log(f"  {name}: wall {wall:.2f} ms (median of {reps}); device {prof['device_ms']:.2f} ms in "
        f"{prof['kernels']} CUDA kernels, busy {prof['device_ms'] / wall:.2f}; peak memory "
        f"{peak / 2**30:.3f} GiB; the port's kernels {launches}")
    for cat, (ms, count) in prof["by_category"].items():
        log(f"    {cat}: {ms:.3f} ms in {count} kernels")
    for kname, ms, count in prof["top"]:
        log(f"    {ms:.3f} ms in {count} x {kname}")
    return {"wall_ms": wall, "peak_bytes": peak, "launches": launches, **prof}


def sde_quadrature(dev, formula: str, x, y, lo: float = 0.02, hi: float = 19.98) -> dict:
    """The posterior of l for ``formula`` (--approx sde, the flat
    Uniform(0, 20) prior) in float64 on the card: the model's log density on
    a grid of 400 over (lo, hi), then three grids of 241 over the mean +- 12
    sd.  The mean, sd and log evidence from the last grid."""
    from scipy.special import logsumexp

    model = sde_model(formula, x, y, dev, torch.float64)

    def lps(grid):
        u = torch.as_tensor(logit_l(grid), device=dev)[:, None]
        with torch.no_grad():
            # less the prior's density in u: the log likelihood at l
            lp = torch.cat([model.logdensity(c) for c in u.split(8)])
            prior = -torch.nn.functional.softplus(u[:, 0]) - torch.nn.functional.softplus(-u[:, 0])
        return (lp - prior).cpu().numpy()

    grid = np.linspace(lo, hi, 400)
    lp = lps(grid)
    for _ in range(3):
        w = np.exp(lp - lp.max())
        mean = float((grid * w).sum() / w.sum())
        sd = max(float(np.sqrt(max((grid ** 2 * w).sum() / w.sum() - mean ** 2, 0.0))),
                 grid[1] - grid[0])
        grid = np.linspace(max(mean - 12 * sd, 1e-3), min(mean + 12 * sd, 20 - 1e-3), 241)
        lp = lps(grid)
    w = np.exp(lp - lp.max())
    mean = float((grid * w).sum() / w.sum())
    sd = float(np.sqrt(max((grid ** 2 * w).sum() / w.sum() - mean ** 2, 0.0)))
    log_z = float(logsumexp(lp) + math.log(grid[1] - grid[0]) - math.log(20.0))
    return {"mean": mean, "sd": sd, "log_evidence": log_z}


def timed_cli(argv, capture=None) -> tuple:
    """run_cli with the launch counts set to 0 just before: (stdout, wall s,
    the port's kernel launches)."""
    from gaplac_tpu_torch.ops import _build

    _build.reset_counts()
    t0 = time.perf_counter()
    out = run_cli(argv, capture)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(_build.counts)


def no_kernels(tag: str, launches: dict) -> None:
    if any(launches.values()):
        raise AssertionError(f"{tag} launched a kernel of the port ({launches}); the sde "
                             "path has none")


def mcmc_runs(name_runs, base, capture) -> dict:
    """mcmc runs through the CLI, each held to its table's columns and rows:
    {name: wall, rate, summary, launches, mean l}."""
    out = {}
    for name, extra, columns, rows, path in name_runs:
        stdout, wall, launches = timed_cli([*base, *extra, "--output", str(path)], capture)
        df = read_table(path, columns, rows)
        rate_line = next(s for s in capture.lines if "transitions/s" in s)
        summary = next((s for s in capture.lines if s.startswith("ℓ: mean")), "")
        out[name] = {"wall_s": wall, "launches": launches, "ell_mean": float(df["ℓ"].mean()),
                     "acceptance_mean": (float(df["acceptance_rate"].mean())
                                         if "acceptance_rate" in df else None),
                     "transitions_per_s": float(rate_line.split("transitions/s")[0].split("(")[-1]),
                     "summary": summary, "stdout": stdout}
        log(f"  {name}: {rate_line}; command wall {wall:.1f} s; {summary}; kernel launches "
            f"{launches}")
    return out


def phase_sde_ou(dev):
    """Path 5a: sample --approx sde at n = 2^20 (the prior, and a posterior
    draw at 1024 points); mcmc "y ~| OU(:x)" NUTS, then 8-chain ChEES
    extending it, the mean of l against a float64 quadrature; the model's
    value+grad at C = 2 by the float32 rule and at C = 8 profiled."""
    import pandas as pd

    from gaplac_tpu_torch.inference.hmc import value_and_grad

    log(f"[18] path 5: sample and mcmc --approx sde, OU, n = {N_OU}, on the card")
    data = OUT_DIR / f"data_ou_{N_OU}.tsv"
    post = OUT_DIR / "sde_posterior_draw.tsv"
    walls, launches = {}, {}
    for name, argv in (
        ("sample", ["sample", "y :~| OU(:x; l=3.0)", "--at",
                    f"x = rand(Uniform(0,2000), {N_OU})", "--seed", "1", "--output", str(data)]),
        ("sample posterior", ["sample", "y ~| OU(:x)", "--data", str(data), "--at",
                              f"x = rand(Uniform(0,2000), {N_AT})", "--seed", "2", "--output",
                              str(post)]),
    ):
        _, walls[name], launches[name] = timed_cli(["--platform", "cuda", *argv, *SDE])
        no_kernels(f"sde {name}", launches[name])
    df = read_table(data, ["x", "y"], N_OU)
    read_table(post, ["x", "y"], N_AT)
    log(f"  walls (s): {walls}; both tables finite, columns x, y")
    x, y = df["x"].to_numpy(), df["y"].to_numpy()

    capture = _Capture()
    logging.getLogger().addHandler(capture)
    base = ["-v", "--platform", "cuda", "mcmc", "y ~| OU(:x)", "--data", str(data), "--infer",
            "x", "--seed", "1", "--no-latents", *SDE]
    cols = ["iteration", "chain", "ℓ", "lp", "acceptance_rate"]
    nuts_path = OUT_DIR / "sde_ou_nuts.tsv"
    try:
        # ChEES extends the NUTS chain (--resume): from a cold start at this n
        # its first transitions diverge (path 4).  The posterior is narrow, so
        # the cold NUTS warmup's trees are capped at depth 6
        runs = mcmc_runs((
            ("nuts", ["--samples", "60", "--warmup", "40", "--max-depth", "6"],
             cols + ["tree_depth", "numerical_error"], 60, nuts_path),
            ("chees", ["--sampler", "chees", "--chains", str(CHAINS), "--samples", "20",
                       "--warmup", "20", "--resume", str(nuts_path)],
             cols + ["step_size", "traj_length"], 20 * CHAINS, OUT_DIR / "sde_ou_chees.tsv"),
        ), base, capture)
    finally:
        logging.getLogger().removeHandler(capture)
    for name, r in runs.items():
        launches[f"mcmc {name}"] = r.pop("launches")
        no_kernels(f"sde mcmc {name}", launches[f"mcmc {name}"])

    quad = sde_quadrature(dev, "y ~| OU(:x)", x, y, 0.5, 19.5)
    log(f"  quadrature (float64): mean ℓ {quad['mean']:.5f}, sd {quad['sd']:.5f}")
    for name, r in runs.items():
        # the tolerance, 4 sd / sqrt(ESS), takes the run's own ESS estimate
        ess = float(r["summary"].split("ESS")[1])
        ess = ess if math.isfinite(ess) and ess >= 1 else 1.0
        r["ell_tol"] = tol = 4 * quad["sd"] / math.sqrt(ess)
        off = abs(r["ell_mean"] - quad["mean"])
        log(f"  {name}: mean ℓ {r['ell_mean']:.5f}, off the quadrature by {off:.5f} (tolerance "
            f"4 sd / sqrt(ESS {ess:.0f}) = {tol:.5f})")
        if not off <= tol:
            raise AssertionError(f"sde OU {name}: mean ℓ {r['ell_mean']:.5f} is off the "
                                 f"quadrature's {quad['mean']:.5f} by more than {tol:.5f}")

    u2 = logit_l([quad["mean"] - 2 * quad["sd"], quad["mean"] + 2 * quad["sd"]])[:, None]

    def density(d, dtype):
        lp, g = value_and_grad(sde_model("y ~| OU(:x)", x, y, d, dtype).logdensity)(
            torch.as_tensor(u2, dtype=dtype, device=d))
        return {"log density": lp, "gradient": g}

    errs = float32_rule("sde OU model at C = 2", density, SDE_RULE_RUNS)
    u8 = torch.as_tensor(np.linspace(u2[0, 0] - 0.05, u2[1, 0] + 0.05, CHAINS)[:, None],
                         dtype=torch.float32, device=dev)
    prof = profile_vg(f"one OU value+grad at C = {CHAINS}, n = {N_OU}",
                      sde_model("y ~| OU(:x)", x, y, dev, torch.float32), u8)
    return launches, {"walls_s": walls, **runs, "quadrature": quad, "rel_err": errs,
                      "value_grad": prof}, x, y


def phase_sde_dense_check(dev, x, y):
    """Path 5b: at n = 4096, C = 8, the sde OU marginal's value and gradient
    on the card against the dense marginal through K2, K1 and K2b on the
    card, both held by the float32 rule against float64 on the CPU (the sde
    model; the dense float64 one on the card equals it to 1e-9)."""
    from gaplac_tpu_torch.inference.hmc import value_and_grad
    from gaplac_tpu_torch.ops import _build

    n = N_BIG
    log(f"[19] path 5: the sde OU marginal against the dense one, n = {n}, C = {CHAINS}")
    xs, ys = x[:n], y[:n]
    u = torch.as_tensor(logit_l(np.linspace(1.5, 6.0, CHAINS))[:, None])

    def vg(approx, d, dtype):
        m = sde_model("y ~| OU(:x)", xs, ys, d, dtype, approx=approx)
        lp, g = value_and_grad(m.logdensity)(u.to(device=d, dtype=dtype))
        return lp.cpu(), g.cpu()

    ref = vg("sde", "cpu", torch.float64)
    cpu32 = vg("sde", "cpu", torch.float32)
    sde32 = vg("sde", dev, torch.float32)
    dense64 = vg("exact", dev, torch.float64)
    _build.reset_counts()
    dense32 = vg("exact", dev, torch.float32)
    torch.cuda.synchronize()
    launches = dict(_build.counts)
    with plain_kernels():
        dense32_plain = vg("exact", dev, torch.float32)
    errs = {}
    for i, what in enumerate(("log density", "gradient")):
        e64 = rel_err(dense64[i], ref[i])
        log(f"  dense float64 on the card against sde float64 on the CPU, {what}: rel err "
            f"{e64:.3e} (tolerance 1e-9)")
        if not e64 <= 1e-9:
            raise AssertionError(f"the dense and sde OU marginals differ in float64 ({what})")
        errs[f"sde {what}"] = check_accuracy(
            f"sde OU {what} at C = {CHAINS}, card f32 against cpu f64", sde32[i], (cpu32[i],),
            ref[i])
        errs[f"dense {what}"] = check_accuracy(
            f"dense OU {what} (K2, K1, K2b) at C = {CHAINS}, card f32 against cpu f64",
            dense32[i], (cpu32[i], dense32_plain[i]), ref[i])
        errs[f"sde - dense {what}"] = rel_err(sde32[i], dense32[i])
    log(f"  the dense value+grad's kernel launches {launches}; sde against dense on the card "
        f"(float32): {errs['sde - dense log density']:.3e} / {errs['sde - dense gradient']:.3e}")
    require_launches("path 5 (dense cross-check)", launches, ("K1", "K2", "K2b"))
    return launches, {"rel_err": errs}


def phase_sde_sqexp(dev):
    """Path 5c: SqExp (d = 6) at n = 2^17: sample --approx sde, mcmc NUTS
    with the accuracy guard, select --formulae SqExp vs OU by the float32
    rule, select --estimator smc on a cut against a quadrature, and the
    value+grad at C = 8 profiled (at C = 1 by the float32 rule)."""
    import pandas as pd

    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.inference.hmc import value_and_grad
    from gaplac_tpu_torch.inference.routing import sde_lengthscale_guard, sde_structure_info
    from gaplac_tpu_torch.kernels.covariance import compile_formula

    log(f"[20] path 5: SqExp (d = 6), --approx sde, n = {N_SQEXP}, on the card")
    data = OUT_DIR / f"data_sqexp_{N_SQEXP}.tsv"
    _, wall_s, launches_s = timed_cli(["--platform", "cuda", "sample", "y :~| SqExp(:x; l=1.5)",
                                       "--at", f"x = rand(Uniform(0,2000), {N_SQEXP})", "--seed",
                                       "3", "--output", str(data), *SDE])
    df = read_table(data, ["x", "y"], N_SQEXP)
    x, y = df["x"].to_numpy(), df["y"].to_numpy()
    launches = {"sample": launches_s}
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    path = OUT_DIR / "sde_sqexp_nuts.tsv"
    try:
        # the posterior is narrow: the cold warmup's trees are capped at depth 5
        runs = mcmc_runs((
            ("nuts", ["--samples", "10", "--warmup", "10", "--max-depth", "5"],
             ["iteration", "chain", "ℓ", "lp", "acceptance_rate", "tree_depth",
              "numerical_error"], 10, path),),
            ["-v", "--platform", "cuda", "mcmc", "y ~| SqExp(:x)", "--data", str(data), "--infer",
             "x", "--seed", "1", "--no-latents", *SDE], capture)
    finally:
        logging.getLogger().removeHandler(capture)
    launches["mcmc nuts"] = runs["nuts"].pop("launches")
    # the guard: silent for this posterior (l near 1.5, span 2000), and firing
    # for the same draws moved past a third of the span
    if "accuracy guard" in runs["nuts"]["stdout"]:
        raise AssertionError("the sde guard fired for l near 1.5 on a span of 2000")
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    thetas = pd.read_csv(path, sep="\t")["ℓ"].to_numpy()[None, :, None]
    st = sde_structure_info(ck, x[:, None])[2]
    span = float(x.max() - x.min())
    fired = sde_lengthscale_guard(ck, st, x[:, None], thetas + span / 3, ((0,),))
    if sde_lengthscale_guard(ck, st, x[:, None], thetas, ((0,),)) is not None or not fired:
        raise AssertionError("the sde guard's decisions on the SqExp chain are wrong")
    log(f"  the guard stays silent on the chain and fires on it moved by span/3: {fired[:60]}...")

    formulae = ["y ~| SqExp(:x)", "y ~| OU(:x)"]
    argv = ["select", "--formulae", *formulae, "--data", str(data), *SDE]
    report, wall_sel, launches["select"] = timed_cli(["--platform", "cuda", *argv])
    sel_errs = float32_rule("sde select lp", lambda d, dt: dict(zip(
        formulae, select_lps(run_cli([*cli_precision(d, dt), *argv])))), SDE_RULE_RUNS)
    log(f"  select: wall {wall_sel:.2f} s; {report.splitlines()[0]}")
    smc = sde_smc(dev, df.head(N_SMC_CUT))
    launches["select smc"] = smc.pop("launches")
    for k in ("sample", "mcmc nuts", "select", "select smc"):
        no_kernels(f"sde SqExp {k}", launches[k])

    u1 = torch.as_tensor(logit_l([1.5])[:, None])

    def density(d, dtype):
        lp, g = value_and_grad(sde_model("y ~| SqExp(:x)", x, y, d, dtype).logdensity)(
            u1.to(device=d, dtype=dtype))
        return {"log density": lp, "gradient": g}

    errs = float32_rule("sde SqExp model at C = 1", density, SDE_RULE_RUNS)
    u8 = torch.as_tensor(logit_l(np.linspace(1.2, 1.9, CHAINS))[:, None], dtype=torch.float32,
                         device=dev)
    prof = profile_vg(f"one SqExp value+grad at C = {CHAINS}, n = {N_SQEXP}",
                      sde_model("y ~| SqExp(:x)", x, y, dev, torch.float32), u8)
    return launches, {"sample_wall_s": wall_s, **runs, "guard": fired,
                      "select": {"wall_s": wall_sel, "rel_err": sel_errs}, "smc": smc,
                      "rel_err": errs, "value_grad": prof}


def sde_smc(dev, df) -> dict:
    """select --estimator smc --approx sde on the first N_SMC_CUT rows (the
    cut: at 2^17 rows one evaluation of 512 particles is 7 chunks of the
    SqExp scan): beta reaches 1, and the SqExp evidence is within 0.5 nats
    of a float64 quadrature."""
    particles = 512
    small = OUT_DIR / f"data_sqexp_{N_SMC_CUT}.tsv"
    df.to_csv(small, sep="\t", index=False)
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    try:
        report, wall, launches = timed_cli(
            ["-v", "--platform", "cuda", "select", "--estimator", "smc", "--formulae",
             "y ~| SqExp(:x)", "y ~| OU(:x)", "--data", str(small), "--particles",
             str(particles), *SDE], capture)
        lines = list(capture.lines)
    finally:
        logging.getLogger().removeHandler(capture)
    lps = select_lps(report)
    stages = [s for s in lines if s.startswith("SMC evidence for")]
    quad = sde_quadrature(dev, "y ~| SqExp(:x)", df["x"].to_numpy(), df["y"].to_numpy())
    off = abs(lps[0] - quad["log_evidence"])
    log(f"  select --estimator smc ({particles} particles, the first {N_SMC_CUT} rows): wall "
        f"{wall:.1f} s; {stages}; SqExp evidence {lps[0]:.4f} against the float64 quadrature "
        f"{quad['log_evidence']:.4f}: off by {off:.4f} (tolerance 0.5)")
    if any("stopped at inverse temperature" in s for s in lines) or len(stages) != 2:
        raise AssertionError("an sde SMC run did not reach beta = 1")
    if not off <= 0.5:
        raise AssertionError("sde SMC SqExp evidence is off the quadrature")
    return {"wall_s": wall, "lps": lps, "quadrature": quad, "stages": stages,
            "launches": launches}


def phase_sde_quasi_periodic(dev):
    """Path 5d: the quasi-periodic Periodic(p=3) * Matern32 block (d = 42):
    sample --approx sde at n = 16384 (its prior draw takes eigh of every
    step noise), one report, the value+grad at C = 1 by the float32 rule and
    profiled; predict at n = 2^17, windowed by default, and at 16384
    monolithic against windowed (float64 on the card, the windowed-smoothing
    test's tolerance) and by the float32 rule."""
    import pandas as pd

    from gaplac_tpu_torch.inference.hmc import value_and_grad

    log(f"[21] path 5: {QP_FORMULA} (d = 42), --approx sde, on the card")
    data = OUT_DIR / f"data_qp_{N_QP}.tsv"
    _, wall_sample, launches = timed_cli(
        ["--platform", "cuda", "sample", "y :~| Periodic(:x; l=1.0, p=3.0) * Matern32(:x)",
         "--at", f"x = rand(Uniform(0,500), {N_QP})", "--seed", "4", "--output", str(data),
         *SDE])
    no_kernels("sde quasi-periodic sample", launches)
    df = read_table(data, ["x", "y"], N_QP)
    x, y = df["x"].to_numpy(), df["y"].to_numpy()
    log(f"  sample at n = {N_QP}: {wall_sample:.2f} s")
    m32 = sde_model(QP_FORMULA, x, y, dev, torch.float32)
    u1 = torch.as_tensor(logit_l([1.0])[:, None])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m32.report(torch.Generator(device=dev).manual_seed(0), u1.to(dev, torch.float32))
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    log(f"  one report (a latent draw) at n = {N_QP}: {report_s:.2f} s")

    def density(d, dtype):
        lp, g = value_and_grad(sde_model(QP_FORMULA, x, y, d, dtype).logdensity)(
            u1.to(device=d, dtype=dtype))
        return {"log density": lp, "gradient": g}

    errs = float32_rule("sde quasi-periodic model at C = 1", density, SDE_RULE_RUNS)
    prof = profile_vg(f"one quasi-periodic value+grad at C = 1, n = {N_QP}", m32,
                      u1.to(dev, torch.float32))

    rng = np.random.default_rng(5)
    xp = np.sort(rng.uniform(0, 500.0, N_QP_PREDICT))
    yp = np.sin(2 * np.pi * xp / 3.0) * np.exp(-0.1 * xp % 1) + rng.normal(0, 0.3, N_QP_PREDICT)
    big = OUT_DIR / f"data_qp_{N_QP_PREDICT}.tsv"
    pd.DataFrame({"x": xp, "y": yp}).to_csv(big, sep="\t", index=False)
    at = ["--at", f"x = rand(Uniform(0,500), {N_AT})", "--seed", "2"]
    out = OUT_DIR / "sde_qp_predict.tsv"
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    try:
        _, wall_big, launches_p = timed_cli(["-v", "--platform", "cuda", "predict", QP_FORMULA,
                                             "--data", str(big), *at, "--output", str(out), *SDE],
                                            capture)
        windowed = any("windowed smoothing on" in s for s in capture.lines)
    finally:
        logging.getLogger().removeHandler(capture)
    no_kernels("sde quasi-periodic predict", launches_p)
    pdf = read_table(out, ["x", "ymu", "yQ050", "yQ950"], N_AT)
    log(f"  predict at n = {N_QP_PREDICT}, {N_AT} points: {wall_big:.2f} s, windowed by default: "
        f"{windowed}")
    if not windowed or not ((pdf["yQ050"] <= pdf["ymu"]) & (pdf["ymu"] <= pdf["yQ950"])).all():
        raise AssertionError("predict at 2^17, d = 42: not windowed, or ymu outside its band")

    def predict(d, dtype, window):
        path = OUT_DIR / f"sde_qp_predict_{d}_{dtype}_{window}.tsv"
        run_cli([*cli_precision(d, dtype), "predict", QP_FORMULA, "--data", str(data), *at,
                 "--sde-window", str(window), "--output", str(path), *SDE])
        return read_table(path, ["x", "ymu", "yQ050", "yQ950"], N_AT)

    t0 = time.perf_counter()
    mono = predict("cuda", torch.float64, 0)
    wall_mono = time.perf_counter() - t0
    win = predict("cuda", torch.float64, 4096)
    win_err = {}
    for c in ("ymu", "yQ050", "yQ950"):
        d = np.abs(win[c].to_numpy() - mono[c].to_numpy())
        ok = d <= 3e-5 + 1e-4 * np.abs(mono[c].to_numpy())
        win_err[c] = float(d.max())
        if not ok.all():
            raise AssertionError(f"windowed predict {c} is off the monolithic one by {d.max():.3e}")
    log(f"  predict at n = {N_QP}, float64: windowed (4096 rows, overlap 512) against monolithic "
        f"({wall_mono:.2f} s): largest differences {win_err} (tolerance 3e-5 + 1e-4 |value|)")
    pred_errs = float32_rule(f"sde quasi-periodic predict at n = {N_QP}", lambda d, dt: {
        c: v.to_numpy() for c, v in predict(d, dt, 0)[["ymu", "yQ050", "yQ950"]].items()},
        SDE_RULE_RUNS)
    return {"sample": launches, "predict": launches_p}, {
        "sample_wall_s": wall_sample, "report_s": report_s, "rel_err": errs, "value_grad": prof,
        "predict_wall_s": wall_big, "predict_monolithic_wall_s": wall_mono,
        "windowed_max_abs_diff": win_err, "predict_rel_err": pred_errs}


def phase_sde_nongaussian(dev):
    """Path 5e: mcmc "y : Bernoulli ~| OU(:x)" --approx sde (the state-space
    Laplace marginal, 15 smoothings an evaluation) and --no-marginalize (the
    whitened model), at n = 2^16, with fixed-trajectory HMC; each model's
    value+grad at C = 1 by the float32 rule, and profiled; each HMC run's
    mean acceptance must reach 0.1."""
    import pandas as pd

    from gaplac_tpu_torch.inference.hmc import value_and_grad

    n = N_NONGAUSS
    log(f"[22] path 5: Bernoulli --approx sde (Laplace) and --no-marginalize, n = {n}")
    rng = np.random.default_rng(6)
    x = np.sort(rng.uniform(0, 500.0, n))
    latent = np.sin(x / 1.5) + rng.normal(0, 0.5, n)
    yb = (rng.uniform(size=n) < 1 / (1 + np.exp(-latent))).astype(int)
    data = OUT_DIR / f"bernoulli_{n}.tsv"
    pd.DataFrame({"x": x, "y": yb}).to_csv(data, sep="\t", index=False)
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    cols = ["iteration", "chain", "ℓ", "lp", "acceptance_rate", "step_size"]
    hmc = ["--sampler", "hmc", "--chains", "2", "--samples", "3"]
    try:
        # Laplace runs without warmup (one adaptation step from the initial
        # step size overshoots); the whitened model's 65537 coordinates need
        # ten warmup steps to find a step size that accepts
        runs = mcmc_runs((
            ("laplace", [*hmc, "--warmup", "0", "--leapfrogs", "2"], cols, 6,
             OUT_DIR / "sde_laplace.tsv"),
            ("whitened", [*hmc, "--warmup", "10", "--leapfrogs", "4", "--no-marginalize"], cols,
             6, OUT_DIR / "sde_whitened.tsv"),
        ), ["-v", "--platform", "cuda", "mcmc", "y : Bernoulli ~| OU(:x)", "--data", str(data),
            "--infer", "x", "--seed", "1", "--no-latents", *SDE], capture)
    finally:
        logging.getLogger().removeHandler(capture)
    launches = {name: r.pop("launches") for name, r in runs.items()}
    for name in launches:
        no_kernels(f"sde {name} mcmc", launches[name])
        acc = runs[name]["acceptance_mean"]
        log(f"  {name}: mean acceptance {acc:.3f} over its table")
        if not acc >= 0.1:
            raise AssertionError(f"sde {name} HMC accepted too little: mean {acc:.3f} < 0.1")
    out = {**runs}
    for name, kw in (("laplace", {}), ("whitened", {"marginalize": False})):
        z = np.random.default_rng(7).normal(size=n) * 0.3

        def position(d, dtype, dim):
            u = np.concatenate([logit_l([2.0]), z])[:dim]
            return torch.as_tensor(u[None], dtype=dtype, device=d)

        def density(d, dtype):
            m = sde_model("y : Bernoulli ~| OU(:x)", x, yb, d, dtype, **kw)
            lp, g = value_and_grad(m.logdensity)(position(d, dtype, m.dim))
            return {"log density": lp, "gradient": g}

        errs = float32_rule(f"sde {name} model at C = 1", density, SDE_RULE_RUNS)
        m = sde_model("y : Bernoulli ~| OU(:x)", x, yb, dev, torch.float32, **kw)
        out[name]["rel_err"] = errs
        out[name]["value_grad"] = profile_vg(f"one {name} value+grad at C = 1, n = {n}", m,
                                             position(dev, torch.float32, m.dim), reps=2,
                                             windows=1)
    return launches, out


def phase_sde_longitudinal(dev):
    """Path 5f: the longitudinal formula through sample, mcmc (NUTS) and
    fitplot's component posteriors (by the float32 rule), PERSONS x VISITS
    rows."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.cli.common import design_matrix
    from gaplac_tpu_torch.cli.fitplot_cmd import markov_component_posteriors
    from gaplac_tpu_torch.kernels.covariance import compile_formula

    n = PERSONS * VISITS
    log(f"[23] path 5: {LONGITUDINAL}, {PERSONS} persons x {VISITS} visits, --approx sde")
    data = OUT_DIR / "longitudinal.tsv"
    _, wall_sample, launches_s = timed_cli([
        "--platform", "cuda", "sample",
        "y :~| OU(:t; l=3.0)*Cat(:PersonID) + Cat(:PersonID) + Noise", "--at",
        f"t/PersonID = rand(Uniform(0,20), {VISITS}); PersonID = 1:{PERSONS}", "--seed", "5",
        "--output", str(data), *SDE])
    df = read_table(data, ["PersonID", "t", "y"], n)
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    try:
        runs = mcmc_runs((("nuts", ["--samples", "20", "--warmup", "20", "--max-depth", "6"],
                           ["iteration", "chain", "ℓ", "lp", "acceptance_rate", "tree_depth",
                            "numerical_error"], 20, OUT_DIR / "sde_longitudinal.tsv"),),
                         ["-v", "--platform", "cuda", "mcmc", LONGITUDINAL, "--data", str(data),
                          "--infer", "t", "--seed", "1", "--no-latents", *SDE], capture)
    finally:
        logging.getLogger().removeHandler(capture)
    launches = {"sample": launches_s, "mcmc nuts": runs["nuts"].pop("launches")}
    ck = compile_formula(parse_formula(LONGITUDINAL).formula)
    design = design_matrix(df, ck)
    info = {}

    def components(d, dtype):
        X = torch.tensor(design, dtype=dtype, device=d)
        p = ck.default_params(dtype, d)
        t0 = time.perf_counter()
        got = markov_component_posteriors(ck, p, X, torch.tensor(df["y"].to_numpy(), dtype=dtype,
                                                                  device=d), 1.1, range(3))
        info.setdefault("wall_s", time.perf_counter() - t0)
        return {f"term {t} {what}": v for t, mu, sd in got
                for what, v in (("mean", mu), ("sd", sd))}

    errs = float32_rule("sde longitudinal fitplot component", components, SDE_RULE_RUNS)
    for k, v in launches.items():
        no_kernels(f"sde longitudinal {k}", v)
    log(f"  sample {wall_sample:.2f} s; fitplot's numbers {info['wall_s']:.3f} s")
    return launches, {"sample_wall_s": wall_sample, **runs, "fitplot_wall_s": info["wall_s"],
                      "fitplot_rel_err": errs}


def phase_auto(dev):
    """Path 5g: --approx auto.  At n = 4096 select and mcmc pick the dense
    path (select's 2-D factorizations take K3's blocked route; mcmc's batch
    K1), at n = 2^17 mcmc picks sde; each choice read from the log."""
    from gaplac_tpu_torch.ops import _build

    log("[24] path 5: --approx auto at n = 4096 and 2^17")
    data4096 = OUT_DIR / "data_4096.tsv"
    big = OUT_DIR / f"data_sqexp_{N_SQEXP}.tsv"
    auto = ["--approx", "auto"]
    hmc = ["--sampler", "hmc", "--chains", "2", "--leapfrogs", "2", "--samples", "2", "--warmup",
           "1", "--no-latents"]
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    out, launches = {}, {}
    try:
        for name, argv, want in (
            ("select n=4096", ["select", "--formulae", "y ~| SqExp(:x)", "y ~| OU(:x)", "--data",
                               str(data4096)], "none"),
            ("mcmc n=4096", ["mcmc", "y ~| SqExp(:x)", "--data", str(data4096), "--infer", "x",
                             *hmc, "--output", str(OUT_DIR / "auto_4096.tsv")], "none"),
            ("mcmc n=2^17", ["mcmc", "y ~| SqExp(:x)", "--data", str(big), "--infer", "x",
                             *hmc, "--output", str(OUT_DIR / "auto_2e17.tsv")], "sde"),
        ):
            _, wall, launches[name] = timed_cli(["-v", "--platform", "cuda", *argv, *auto],
                                                capture)
            chose = [s for s in capture.lines if s.startswith("--approx auto:")]
            log(f"  {name}: {chose}; wall {wall:.2f} s; kernel launches {launches[name]}")
            if len(chose) not in (1, 2) or not all(s.startswith(f"--approx auto: {want} ")
                                                   for s in chose):
                raise AssertionError(f"auto {name} did not choose {want}: {chose}")
            out[name] = {"wall_s": wall, "chose": chose}
    finally:
        logging.getLogger().removeHandler(capture)
    require_launches("path 5 (auto select, n = 4096)", launches["select n=4096"], ("K2", "K3"))
    require_launches("path 5 (auto mcmc, n = 4096)", launches["mcmc n=4096"], ("K1", "K2", "K2b"))
    no_kernels("auto mcmc at 2^17", launches["mcmc n=2^17"])
    return launches, out


# ---------------------------------------------------------------------------
# path 6: --profile, --profile-dir and --check-numerics; the fused gram ->
# Cholesky at bench_ops.py's width; the native table IO
# ---------------------------------------------------------------------------

N_FUSED = 16384       # the fused factorization's n (benchmarks/bench_ops.py's largest)
N_FUSED_MEM = 32768   # its memory check: the factor alone is 4.29 GB in float32
FUSED_PANEL = 2048
FUSED_FORMULA = "y ~| SqExp(:t) * Cat(:g) + Linear(:x) + Noise"  # tests/test_ops.py's
FUSED_DIAG = 1.1
#: the fused forward's peak memory above its inputs, at most this many times
#: the factor's own bytes (the two-step holds K beside L: about twice)
FUSED_PEAK_FACTOR = 1.25
#: the phases of --profile must sum to the command's wall within this share
PROFILE_WALL_TOL = 0.10
#: CUDA kernel names (the trace's "kernel" events) of K1, K2 and K2b
KERNEL_SYMBOLS = {"K1": "chol_batched_kernel", "K2": "gram_fwd_kernel",
                  "K2b": "gram_bwd_kernel", "K3": "chol_tile_kernel"}


def profile_report(stdout: str) -> dict:
    """--profile's report: {phase: seconds}."""
    lines = stdout.split("phase breakdown:\n")[1].splitlines()
    return {s.split()[0]: float(s.split()[1].rstrip("s")) for s in lines if s.startswith("  ")}


def trace_kernels(trace_dir: Path) -> dict:
    """CUDA kernel events of the torch.profiler trace in ``trace_dir``, by
    kernel of the port: {kernel: count}; and the trace's size in bytes."""
    traces = list(trace_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"{trace_dir}: {len(traces)} trace files, expected 1")
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {"events": {k: sum(sym in name for name in kernels)
                       for k, sym in KERNEL_SYMBOLS.items()},
            "cuda_kernel_events": len(kernels), "bytes": traces[0].stat().st_size}


def phase_observability(data: Path) -> tuple:
    """Path 6a and 6b: mcmc on path 1's data (n = 500) without flags, with
    --profile, with --profile --profile-dir and with --check-numerics
    (8-chain ChEES, shortened, --seed 1: the four tables must be identical),
    NUTS with --profile (its report names mcmc.sample+compile and
    mcmc.report), sample, select and predict with both profile flags (the
    command's phase in the report, a trace that json.load reads), and a
    response with an inf cell under --check-numerics,
    which must raise FloatingPointError before writing its table.  The
    report's command phase must be within PROFILE_WALL_TOL of the command's
    wall where no trace is written; a trace is written after the phases
    end, as in gaplac_tpu, so its cost shows in the walls alone."""
    import shutil

    import pandas as pd

    from gaplac_tpu_torch.ops import _build

    log(f"[25] path 6: mcmc --profile --profile-dir and --check-numerics, n = {N_OBS}")
    base = ["--platform", "cuda", "mcmc", "y ~| SqExp(:x)", "--data", str(data), "--infer", "x",
            "--seed", "1"]
    # short: the trace of one run holds every CPU op and kernel (396 MB at 10 + 10)
    chees = ["--no-marginalize", "--sampler", "chees", "--chains", str(CHAINS), "--samples",
             "5", "--warmup", "5"]
    trace_dir = OUT_DIR / "trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    # (flags before the command, flags after it)
    flags = {"plain": ([], []), "profiled": (["--profile"], []),
             "traced": (["--profile", "--profile-dir", str(trace_dir)], []),
             "checked": ([], ["--check-numerics"])}
    out, tables, reports = {"walls_s": {}}, {}, {}
    _build.reset_counts()
    for tag, (pre, post) in flags.items():
        tables[tag] = OUT_DIR / f"chees_{tag}.tsv"
        t0 = time.perf_counter()
        stdout = run_cli([*pre, *base, *post, *chees, "--output", str(tables[tag])])
        out["walls_s"][tag] = time.perf_counter() - t0
        if pre:
            reports[tag] = profile_report(stdout)
    log(f"  ChEES walls (s): {out['walls_s']}; kernel launches {dict(_build.counts)}")
    out["chees_reports"] = reports
    log(f"  ChEES --profile reports: {reports}")
    for tag, report in reports.items():
        if set(report) != {"mcmc", "mcmc.chees+compile"}:
            raise AssertionError(f"ChEES --profile phases {sorted(report)}")
        if report["mcmc.chees+compile"] > report["mcmc"]:
            raise AssertionError("a phase nested in mcmc outlasts it")
    wall = out["walls_s"]["profiled"]
    if abs(reports["profiled"]["mcmc"] - wall) > PROFILE_WALL_TOL * wall:
        raise AssertionError(f"the phase mcmc ({reports['profiled']['mcmc']:.3f} s) is not "
                             f"within {PROFILE_WALL_TOL:.0%} of the command's wall {wall:.3f} s")
    out["trace"] = trace_kernels(trace_dir)
    log(f"  trace: {out['trace']}")
    for k in ("K1", "K2", "K2b"):
        if out["trace"]["events"][k] <= 0:
            raise AssertionError(f"the --profile-dir trace holds no CUDA event of {k}")
    same = {tag: tables[tag].read_bytes() == tables["plain"].read_bytes() for tag in tables}
    log(f"  tables identical to the run without flags: {same}")
    if not all(same.values()):
        raise AssertionError(f"--profile or --check-numerics changed the table: {same}")
    t0 = time.perf_counter()
    stdout = run_cli(["--profile", *base, "--samples", "20", "--warmup", "20",
                      "--output", str(OUT_DIR / "nuts_profiled.tsv")])
    wall = time.perf_counter() - t0
    out["nuts_report"] = report = profile_report(stdout)
    log(f"  NUTS --profile report: {report}; wall {wall:.3f} s")
    if set(report) != {"mcmc", "mcmc.sample+compile", "mcmc.report"}:
        raise AssertionError(f"NUTS --profile phases {sorted(report)}")
    if abs(report["mcmc"] - wall) > PROFILE_WALL_TOL * wall:
        raise AssertionError(f"the phase mcmc ({report['mcmc']:.3f} s) is not within "
                             f"{PROFILE_WALL_TOL:.0%} of the command's wall {wall:.3f} s")
    # both flags on sample, select and predict (fitplot draws with matplotlib,
    # which this script does not require; its flags are tested on the CPU)
    others = {
        "sample": ["sample", "y :~| SqExp(:x; l=1.5)", "--at", "x=-5:0.01:5", "--seed", "1",
                   "--output", str(OUT_DIR / "sample_profiled.tsv")],
        "select": ["select", "--formulae", "y ~| SqExp(:x)", "y ~| OU(:x)", "--data",
                   str(data)],
        "predict": ["predict", "y ~| SqExp(:x)", "--data", str(data), "--at", "x=-5:0.1:5",
                    "--output", str(OUT_DIR / "predict_profiled.tsv")],
    }
    out["other_commands"] = {}
    for name, argv in others.items():
        cmd_dir = OUT_DIR / f"trace_{name}"
        shutil.rmtree(cmd_dir, ignore_errors=True)
        t0 = time.perf_counter()
        stdout = run_cli(["--platform", "cuda", "--profile", "--profile-dir", str(cmd_dir),
                          *argv])
        wall = time.perf_counter() - t0
        report, trace = profile_report(stdout), trace_kernels(cmd_dir)
        out["other_commands"][name] = {"wall_s": wall, "report": report, "trace": trace}
        log(f"  {name} --profile --profile-dir: wall {wall:.3f} s, report {report}, trace "
            f"{trace}")
        # the command's phase and a trace that json.load reads; CUDA events are
        # held on the ChEES trace above: the profiler on the card drops a short
        # session's kernel records now and then
        if name not in report:
            raise AssertionError(f"{name}: no {name} phase in --profile's report {report}")
    # a response with an inf cell: every log density is NaN
    df = pd.read_csv(data, sep="\t")
    df.loc[3, "y"] = np.inf
    bad, bad_out = OUT_DIR / "data_inf.tsv", OUT_DIR / "inf_chain.tsv"
    df.to_csv(bad, sep="\t", index=False)
    argv = ["--platform", "cuda", "mcmc", "y ~| SqExp(:x)", "--data", str(bad), "--infer", "x",
            "--sampler", "hmc", "--leapfrogs", "8", "--samples", "5", "--warmup", "5",
            "--check-numerics", "--output", str(bad_out)]
    try:
        run_cli(argv)
    except FloatingPointError as e:
        out["nan_case"] = str(e)
        log(f"  inf response with --check-numerics: FloatingPointError: {e}")
    else:
        raise AssertionError("--check-numerics did not raise on a NaN log density")
    if bad_out.exists():
        raise AssertionError("--check-numerics wrote a table before raising")
    return dict(_build.counts), out


def fused_inputs(n: int, dev, dtype, seed: int = 3):
    """X (n, 3) as tests/test_ops.py makes it, the formula's default params,
    and a response y, on the card."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula

    ck = compile_formula(parse_formula(FUSED_FORMULA).formula)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    X[:, 1] = np.floor(np.abs(X[:, 1]) * 2)
    y = rng.normal(size=n)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return ck, ck.default_params(dtype, dev), as_t(X), as_t(y)


def peak_above(fn) -> tuple:
    """(fn's result, its peak device memory above what was allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def events_ms(fn, reps: int) -> float:
    """Median of ``reps`` calls, each timed by CUDA events after a warmup."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_split(fn, calls: int) -> dict:
    """Device time a call of fn (the profiler's fullest of two windows): the
    total, the port's kernels' time and launches by kernel, and the five
    kernels that took the most."""
    kernels = {e.key: (e.self_device_time_total / 1e3 / calls, e.count / calls)
               for e in profiled(fn, calls, windows=2)
               if e.device_type == torch.autograd.DeviceType.CUDA}
    ours = {}
    for k, sym in KERNEL_SYMBOLS.items():
        hit = [v for name, v in kernels.items() if sym in name]
        if hit:
            ours[k] = {"device_ms": sum(ms for ms, _ in hit), "launches": sum(c for _, c in hit)}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:5]
    return {"device_ms": sum(ms for ms, _ in kernels.values()),
            "cuda_kernels": sum(c for _, c in kernels.values()), "port_kernels": ours,
            "top": [[name[:90], ms, count] for name, (ms, count) in top]}


def phase_fused(dev) -> tuple:
    """Path 6c: fused_gram_cholesky and mvn_logpdf_fused at n = 16384,
    float32, panel 2048, against float64 on the card (the float32 rule: the
    plain runs put every kernel's plain version in its place), timed beside
    the two-step blocked_cholesky(K2 gram); the forward's peak memory at
    n = 32768 against the factor's bytes; K2 at row offsets against its plain
    version on the panels."""
    from gaplac_tpu_torch.ops import _build
    from gaplac_tpu_torch.ops.cholesky import blocked_cholesky
    from gaplac_tpu_torch.ops.fused import fused_gram_cholesky, mvn_logpdf_fused
    from gaplac_tpu_torch.ops.gram import gram_bwd_cuda, gram_bwd_plain, gram_cuda, gram_plain

    n = N_FUSED
    log(f"[26] path 6: the fused gram -> Cholesky, {FUSED_FORMULA}, n = {n}, panel "
        f"{FUSED_PANEL}, on the card")
    out = {}
    # K2 at row offsets on the fused factorization's panels, against its plain version
    ck, p64, X64, y64 = fused_inputs(n, dev, torch.float64)
    p32, X32 = p64.float(), X64.float()
    for j0 in (0, n // 2, n - FUSED_PANEL):
        j1 = j0 + FUSED_PANEL
        args = lambda p, X: (ck, p[None], X[j0:], X[j0:j1], FUSED_DIAG)
        ref = gram_plain(*args(p64, X64), offsets=(j0, j0))
        err = check_accuracy(f"K2 at row offsets ({j0}, {j0}), (1, {n - j0}, {FUSED_PANEL})",
                             gram_cuda(*args(p32, X32), offsets=(j0, j0)),
                             gram_plain(*args(p32, X32), offsets=(j0, j0)), ref)
        out.setdefault("k2_offsets_err", {})[j0] = err
    # K2 on two of the forward's panels; K2b at the first panel's shape (off the
    # path) and at the backward's symmetric (1, n, n); bytes: inputs once, outputs once
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = {}
    for j0 in (0, n // 2):
        m = n - j0
        rows[f"K2 panel (1, {m}, {FUSED_PANEL})"] = (
            lambda j0=j0: gram_cuda(ck, p32[None], X32[j0:], X32[j0:j0 + FUSED_PANEL],
                                    FUSED_DIAG, offsets=(j0, j0)),
            lambda j0=j0: gram_plain(ck, p32[None], X32[j0:], X32[j0:j0 + FUSED_PANEL],
                                     FUSED_DIAG, offsets=(j0, j0)),
            None, 12 * m * FUSED_PANEL, m * FUSED_PANEL * 4 + 4 * 3 * (m + FUSED_PANEL))
    G_panel = torch.randn((1, n, FUSED_PANEL), generator=gen, device=dev)
    G_full = torch.randn((1, n, n), generator=gen, device=dev)
    rows[f"K2b panel (1, {n}, {FUSED_PANEL})"] = (
        lambda: gram_bwd_cuda(ck, p32[None], X32, X32[:FUSED_PANEL], G_panel, offsets=(0, 0)),
        lambda: gram_bwd_plain(ck, p32[None], X32, X32[:FUSED_PANEL], G_panel,
                               offsets=(0, 0)),
        None, 20 * n * FUSED_PANEL, n * FUSED_PANEL * 4 + 4 * 3 * (n + FUSED_PANEL))
    rows[f"K2b backward (1, {n}, {n})"] = (
        lambda: gram_bwd_cuda(ck, p32[None], X32, None, G_full),
        lambda: gram_bwd_plain(ck, p32[None], X32, None, G_full),
        None, 20 * n * n, n * n * 4 + 4 * 3 * n)
    out["panel_rows"] = time_rows(rows)
    del G_panel, G_full

    # the forward and a value+grad: the card's float32 kernels, the float32
    # plain versions and float64 plain versions (the reference)
    y32 = y64.float()

    def forward(p, X):
        return fused_gram_cholesky(ck, FUSED_DIAG, FUSED_PANEL, p, X)

    def value_grad(p, X, y):
        pr = p.clone().requires_grad_()
        v = mvn_logpdf_fused(ck, pr, X, y, FUSED_DIAG, FUSED_PANEL)
        (g,) = torch.autograd.grad(v, pr)
        return v.detach(), g

    with plain_kernels():
        L_ref = forward(p64, X64)
        v_ref, g_ref = value_grad(p64, X64, y64)
        L_plain = forward(p32, X32)
        v_plain, g_plain = value_grad(p32, X32, y32)
    _build.reset_counts()
    L, fwd_peak = peak_above(lambda: forward(p32, X32))
    fwd_launches = dict(_build.counts)
    _build.reset_counts()
    (v, g), vg_peak = peak_above(lambda: value_grad(p32, X32, y32))
    vg_launches = dict(_build.counts)
    log(f"  launches: forward {fwd_launches}, value+grad {vg_launches}")
    out["errors"] = {
        "factor": check_accuracy("fused factor, card f32 against card f64 plain", L, L_plain,
                                 L_ref),
        "value": check_accuracy("fused log density", v, v_plain, v_ref),
        "grad": check_accuracy("fused dtheta", g, g_plain, g_ref)}
    if float(L.triu(1).abs().max()) != 0.0:
        raise AssertionError("the fused factor has entries above its diagonal")
    del L_ref, L_plain, L
    require_launches("path 6 (fused forward)", fwd_launches, ("K2", "K3"))
    require_launches("path 6 (fused value+grad)", vg_launches, ("K2", "K2b", "K3"))
    two_step = lambda: blocked_cholesky(gram_cuda(ck, p32[None], X32, None, FUSED_DIAG)[0])
    _, two_peak = peak_above(two_step)
    factor_bytes = n * n * 4
    flops = n ** 3 / 3
    b, by = bound_ms(flops, factor_bytes + X32.numel() * 4)
    timed = {}
    for name, fn, reps, calls in (("fused forward", lambda: forward(p32, X32), 5, 2),
                                  ("two-step", two_step, 5, 2),
                                  ("fused forward again", lambda: forward(p32, X32), 5, 2),
                                  ("fused value+grad", lambda: value_grad(p32, X32, y32), 3, 1)):
        timed[name] = {"events_ms": events_ms(fn, reps), **kernel_split(fn, calls)}
        log(f"  {name}: events {timed[name]['events_ms']:.3f} ms (median of {reps}); device "
            f"{timed[name]['device_ms']:.3f} ms in {timed[name]['cuda_kernels']:.0f} CUDA "
            f"kernels; the port's kernels {timed[name]['port_kernels']}")
        for kname, ms, count in timed[name]["top"]:
            log(f"    {ms:.3f} ms in {count:.0f} x {kname}")
    out.update({
        "forward": {"peak_bytes_above_inputs": fwd_peak, "launches": fwd_launches,
                    "bound_ms": b, "bound_by": by, **timed["fused forward"],
                    "again": timed["fused forward again"]},
        "two_step": {"peak_bytes_above_inputs": two_peak, **timed["two-step"]},
        "value_grad": {"peak_bytes_above_inputs": vg_peak, "launches": vg_launches,
                       **timed["fused value+grad"]},
        "factor_bytes": factor_bytes})
    log(f"  peak memory above the inputs (GB): forward {fwd_peak / 1e9:.3f}, two-step "
        f"{two_peak / 1e9:.3f}, value+grad {vg_peak / 1e9:.3f}; the factor "
        f"{factor_bytes / 1e9:.3f}; bound {b:.3f} ms ({by})")

    # the memory check at n = 32768
    del ck, p64, X64, y64, X32, y32
    torch.cuda.empty_cache()
    m = N_FUSED_MEM
    ck, p32, X32, _ = fused_inputs(m, dev, torch.float32)
    L, peak = peak_above(lambda: fused_gram_cholesky(ck, FUSED_DIAG, FUSED_PANEL, p32, X32))
    finite = bool(torch.isfinite(L.diagonal()).all())
    del L
    torch.cuda.empty_cache()
    _, peak2 = peak_above(lambda: blocked_cholesky(
        gram_cuda(ck, p32[None], X32, None, FUSED_DIAG)[0]))
    torch.cuda.empty_cache()
    fb = m * m * 4
    out["n32768"] = {"forward_peak_bytes": peak, "two_step_peak_bytes": peak2,
                     "factor_bytes": fb, "ratio": peak / fb, "two_step_ratio": peak2 / fb}
    log(f"  n = {m}: forward peak above the inputs {peak / 1e9:.3f} GB = {peak / fb:.3f} x the "
        f"factor's {fb / 1e9:.3f} GB; two-step {peak2 / 1e9:.3f} GB = {peak2 / fb:.3f} x")
    if not finite:
        raise AssertionError(f"the fused factor at n = {m} is not finite")
    if peak > FUSED_PEAK_FACTOR * fb:
        raise AssertionError(f"the fused forward's peak at n = {m} is {peak / fb:.3f} x the "
                             f"factor's bytes (at most {FUSED_PEAK_FACTOR})")
    return {"forward": fwd_launches, "value+grad": vg_launches}, out


def phase_fastio() -> dict:
    """Path 6d: the native reader and writer on path 5's 2^20-row data table
    and path 1's ChEES chain table (n_obs + 6 columns): read against pandas,
    write against the plain Python writer, the written files byte for byte."""
    import pandas as pd

    from gaplac_tpu_torch.data import fastio
    from gaplac_tpu_torch.data import io as tio

    log("[27] path 6: the native table IO (data/fastio.py) against pandas and the plain writer")
    out = {}
    for name, path in (("data 2^20 rows", OUT_DIR / f"data_ou_{N_OU}.tsv"),
                       ("chain", OUT_DIR / "chees_whitened.tsv")):
        t0 = time.perf_counter()
        names, arr = fastio.read_numeric(str(path), "\t")
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = pd.read_csv(path, sep="\t", float_precision="round_trip")
        t_pandas = time.perf_counter() - t0
        if names != list(ref.columns) or not np.array_equal(arr, ref.to_numpy(np.float64),
                                                           equal_nan=True):
            raise AssertionError(f"{name}: the native reader differs from pandas")
        native, plain = OUT_DIR / f"fastio_{path.stem}.tsv", OUT_DIR / f"plain_{path.stem}.tsv"
        t0 = time.perf_counter()
        fastio.write_numeric(str(native), "\t", names, arr)
        w_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        tio._write_numeric(str(plain), "\t", ref)
        w_plain = time.perf_counter() - t0
        same = native.read_bytes() == plain.read_bytes() == path.read_bytes()
        out[name] = {"shape": list(arr.shape), "read_native_s": t_native,
                     "read_pandas_s": t_pandas, "write_native_s": w_native,
                     "write_plain_s": w_plain, "bytes": native.stat().st_size,
                     "identical": same}
        log(f"  {name} {arr.shape}: read native {t_native:.3f} s, pandas {t_pandas:.3f} s; "
            f"write native {w_native:.3f} s, plain {w_plain:.3f} s; files identical {same}")
        if not same:
            raise AssertionError(f"{name}: the native and plain writers wrote different bytes")
        native.unlink()
        plain.unlink()
    return out


# ---------------------------------------------------------------------------
# path 7: the parallel slice at world size 1 under NCCL
# ---------------------------------------------------------------------------

GAPLAC_VARS = ("GAPLAC_COORDINATOR", "GAPLAC_NUM_PROCESSES", "GAPLAC_PROCESS_ID")
#: path 7's NUTS run: --chains 8, shortened
PAR_NUTS = ["--chains", str(CHAINS), "--samples", "20", "--warmup", "20"]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_parallel_mcmc(data: Path) -> tuple:
    """Path 7a: mcmc NUTS --chains 8 at n = 500, once without the GAPLAC_*
    variables and once with them at world size 1 (NCCL on cuda:0, the chains
    sharded over the one rank and gathered back): identical tables."""
    import os

    from gaplac_tpu_torch.ops import _build
    from gaplac_tpu_torch.parallel import multihost

    log("[28] path 7: mcmc NUTS --chains 8 without and with GAPLAC_* (world size 1, NCCL)")
    capture = _Capture()
    logging.getLogger().addHandler(capture)
    launches, walls, tables, logs = {}, {}, {}, {}
    try:
        for name, env in (("single", {}),
                          ("world 1", {"GAPLAC_COORDINATOR": f"127.0.0.1:{free_port()}",
                                       "GAPLAC_NUM_PROCESSES": "1", "GAPLAC_PROCESS_ID": "0"})):
            out = OUT_DIR / f"nuts_chains8_{name.replace(' ', '_')}.tsv"
            os.environ.update(env)
            _build.reset_counts()
            t0 = time.perf_counter()
            try:
                run_cli(["-v", "--platform", "cuda", "mcmc", "y ~| SqExp(:x)", "--data",
                         str(data), "--infer", "x", "--output", str(out), "--seed", "1",
                         *PAR_NUTS], capture)
                torch.cuda.synchronize()
            finally:
                multihost.shutdown()
                for k in env:
                    os.environ.pop(k)
            walls[name] = time.perf_counter() - t0
            launches[name] = dict(_build.counts)
            logs[name] = list(capture.lines)
            tables[name] = out.read_bytes()
    finally:
        logging.getLogger().removeHandler(capture)
    init = [s for s in logs["world 1"] if "torch.distributed initialized" in s]
    log(f"  walls (s) {walls}; launches {launches}; {init}")
    if tables["single"] != tables["world 1"]:
        raise AssertionError("NUTS wrote different tables with and without GAPLAC_*")
    if not any("sharded 8 chains over 1 devices" in s for s in logs["world 1"]):
        raise AssertionError("the world-size-1 run did not shard its chains")
    if any("torch.distributed" in s for s in logs["single"]):
        raise AssertionError("the run without GAPLAC_* started a process group")
    if init != ["torch.distributed initialized (nccl): rank 0, world size 1, device cuda:0"]:
        raise AssertionError(f"the world-size-1 run logged {init}")
    read_table(OUT_DIR / "nuts_chains8_world_1.tsv",
               ["iteration", "chain", "ℓ"] + [f"fx[{i + 1}]" for i in range(N_OBS)]
               + ["lp", "acceptance_rate", "tree_depth", "numerical_error"], 20 * CHAINS)
    for name in launches:
        require_launches(f"path 7 mcmc {name}", launches[name], ("K1", "K2", "K2b"))
    log("  the two chain tables are identical")
    return launches["world 1"], {"walls_s": walls, "launches_single": launches["single"]}


def nccl_split(fn, calls: int = 3) -> dict:
    """fn's device time a call (the profiler's fullest of two windows), NCCL's
    kernels' part of it and their count.  A collective of one rank launches
    no NCCL kernel: in place it does nothing, and an all-gather copies."""
    kernels = [(e.key, e.self_device_time_total / 1e3 / calls, e.count / calls)
               for e in profiled(fn, calls, windows=2)
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(ms for _, ms, _ in kernels)
    nccl = [(ms, c) for name, ms, c in kernels if "nccl" in name.lower()]
    return {"device_ms": total, "nccl_ms": sum(ms for ms, _ in nccl),
            "nccl_kernels": sum(c for _, c in nccl),
            "nccl_share": sum(ms for ms, _ in nccl) / total if total else None}


def wall_ms(fn, reps: int = 3) -> float:
    """Median host wall of ``reps`` calls, each ended by a synchronize, after
    a warmup."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(walls))


def phase_parallel_dense(dev, mesh) -> tuple:
    """Path 7b: sharded_gram, distributed_cholesky, distributed_solve_lower and
    the log density they make, at benchmarks/bench_ops.py's width (n = 16384,
    float32) on a "data" mesh (world size 1 here), each against its
    counterpart (the symmetric K2 gram, ops.linalg.cholesky,
    solve_triangular, ops/mvn.py) by the float32 rule against the
    counterpart in float64 on the card, the plain float32 runs being the
    counterpart's and the distributed function's with every kernel's plain
    version, and timed beside it: wall, device time and NCCL's part."""
    from gaplac_tpu_torch.ops import _build, linalg, mvn
    from gaplac_tpu_torch.ops.gram import gram
    from gaplac_tpu_torch.parallel import distributed as D
    from gaplac_tpu_torch.parallel.mesh import gather_chain_axis

    n = N_FUSED
    log(f"[29] path 7: the distributed dense functions, {FUSED_FORMULA}, n = {n}, "
        f"world size {mesh.size}")
    nb = n // mesh.size

    def distributed(ck, p, X, y):
        K = D.sharded_gram(ck, p, X, mesh, jitter=FUSED_DIAG)
        L = D.distributed_cholesky(K, mesh)
        x = D.distributed_solve_lower(L, y, mesh)
        logdet = 2.0 * torch.log(torch.diagonal(L, offset=mesh.rank * nb)).sum()
        torch.distributed.all_reduce(logdet, group=mesh.group)
        return K, L, x, -0.5 * (x @ x + logdet + n * math.log(2 * math.pi))

    def counterpart(ck, p, X, y):
        K = gram(ck, p[None], X, None, FUSED_DIAG)[0]
        L = linalg.cholesky(K)
        return K, L, linalg.solve_triangular(L, y, lower=True), mvn.mvn_logpdf_chol(L, y)

    names = ("sharded_gram", "distributed_cholesky", "distributed_solve_lower",
             "log density")
    def whole(K, L, x, lp):  # the block rows of K and L in rank order
        return gather_chain_axis(K, mesh), gather_chain_axis(L, mesh), x, lp

    ref64 = counterpart(*fused_inputs(n, dev, torch.float64))
    ins = fused_inputs(n, dev, torch.float32)
    plain32 = counterpart(*ins)
    with plain_kernels():
        dist_plain32 = whole(*distributed(*ins))
    _build.reset_counts()
    got = distributed(*ins)
    torch.cuda.synchronize()
    launches = dict(_build.counts)
    K, L = got[0], got[1]
    got = whole(*got)
    K_all, L_all = got[0], got[1]
    out = {"errors": {}, "launches": launches}
    for name, g, p32, d32, r64 in zip(names, got, plain32, dist_plain32, ref64):
        out["errors"][name] = check_accuracy(f"{name} against its counterpart", g, (p32, d32),
                                             r64)
    # the diagonal blocks' factorizations: the blocked route from n = 2048, else K1
    require_launches("path 7 dense", launches,
                     ("K2", "K3" if nb >= linalg.BLOCKED_MIN_N else "K1"))
    del ref64, plain32, dist_plain32, got
    ck, p, X, y = ins
    pairs = {
        "sharded_gram": (lambda: D.sharded_gram(ck, p, X, mesh, jitter=FUSED_DIAG),
                         lambda: gram(ck, p[None], X, None, FUSED_DIAG)),
        "distributed_cholesky": (lambda: D.distributed_cholesky(K, mesh),
                                 lambda: linalg.cholesky(K_all)),
        "distributed_solve_lower": (lambda: D.distributed_solve_lower(L, y, mesh),
                                    lambda: linalg.solve_triangular(L_all, y, lower=True)),
        "log density": (lambda: distributed(*ins), lambda: counterpart(*ins)),
    }
    out["times"] = {}
    for name, (fn, ref) in pairs.items():
        row = {"wall_ms": wall_ms(fn), "counterpart_wall_ms": wall_ms(ref), **nccl_split(fn),
               "counterpart_device_ms": nccl_split(ref)["device_ms"]}
        out["times"][name] = row
        log(f"  {name}: wall {row['wall_ms']:.3f} ms (counterpart "
            f"{row['counterpart_wall_ms']:.3f}), device {row['device_ms']:.3f} ms (counterpart "
            f"{row['counterpart_device_ms']:.3f}), NCCL {row['nccl_ms']:.4f} ms in "
            f"{row['nccl_kernels']:g} kernels, share {row['nccl_share']:.4f}")
    return launches, out


def phase_parallel_lowrank(dev, mesh, x, y) -> tuple:
    """Path 7c: sharded_lowrank_logpdf at path 4's width (n = 65536, m = 512)
    on a "data" mesh (world size 1 here): value and gradient by the float32
    rule against float64 on the card, the same against ops/lowrank.py's
    lowrank_logpdf on the same features in float64 (the plain float32 runs:
    lowrank_logpdf's and the sharded one's with K1's plain version), one K1
    launch an evaluation, wall, device time and peak memory."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.kernels.features import build_feature_map
    from gaplac_tpu_torch.ops import _build, lowrank
    from gaplac_tpu_torch.parallel import distributed as D

    log(f"[30] path 7: sharded_lowrank_logpdf, n = {N_RFF}, m = {M_RFF}, "
        f"world size {mesh.size}")
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    extra = 1.1  # the latent jitter and the observation variance

    def setup(dtype):
        X = torch.tensor(x[:, None], dtype=dtype, device=dev)
        Y = torch.tensor(y, dtype=dtype, device=dev)
        fm = build_feature_map(ck, [X], num_features=M_RFF, seed=0)
        p = ck.set_params(ck.default_params(dtype, dev), [0], 1.5)
        return fm, X, Y, p

    def value_grad(fn, dtype):
        fm, X, Y, p = setup(dtype)
        p = p.clone().requires_grad_(True)
        lp = fn(fm, p, X, Y)
        (g,) = torch.autograd.grad(lp, p)
        return {"value": lp.detach(), "gradient": g}

    sharded = lambda fm, p, X, Y: D.sharded_lowrank_logpdf(fm, p, X, extra, Y, mesh)
    single = lambda fm, p, X, Y: lowrank.lowrank_logpdf(fm.phi(p, X),
                                                        extra + fm.noise_diag(p, X), Y)
    card = (("card", "cuda", torch.float32), ("card64", "cuda", torch.float64),
            ("card_plain", "cuda", torch.float32))
    out = {"float32_rule": float32_rule("sharded_lowrank_logpdf",
                                        lambda d, dt: value_grad(sharded, dt), card)}
    got = value_grad(sharded, torch.float32)
    ref = value_grad(single, torch.float64)
    plain = value_grad(single, torch.float32)
    with plain_kernels():
        sharded_plain = value_grad(sharded, torch.float32)
    out["against_lowrank_logpdf"] = {
        k: check_accuracy(f"sharded_lowrank_logpdf {k} against lowrank_logpdf", got[k],
                          (plain[k], sharded_plain[k]), ref[k]) for k in got}
    fm, X, Y, p = setup(torch.float32)
    p.requires_grad_(True)

    def vg():
        lp = sharded(fm, p, X, Y)
        return torch.autograd.grad(lp, p)

    vg()
    torch.cuda.synchronize()
    _build.reset_counts()
    _, peak = peak_above(vg)
    launches = dict(_build.counts)
    log(f"  one value+grad: launches {launches}, peak {peak / 2**30:.3f} GiB above the inputs")
    if launches != {"K1": 1, "K2": 0, "K2b": 0, "K3": 0}:
        raise AssertionError(f"one K1 launch an evaluation expected, got {launches}")
    out.update(wall_ms=wall_ms(vg, 5), peak_bytes=peak, **nccl_split(vg))
    out["single_wall_ms"] = wall_ms(lambda: torch.autograd.grad(single(fm, p, X, Y), p), 5)
    log(f"  value+grad wall {out['wall_ms']:.3f} ms (lowrank_logpdf "
        f"{out['single_wall_ms']:.3f}),"
        f" device {out['device_ms']:.3f} ms, NCCL {out['nccl_ms']:.4f} ms")
    return launches, out


def phase_parallel_chees(dev, mesh, data: Path) -> tuple:
    """Path 7d: run_chees with the world-size-1 "chains" mesh on path 1's
    whitened model (dim 501), 8 chains, shortened: bit for bit run_chees
    without a mesh."""
    import pandas as pd

    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.inference.chees import run_chees
    from gaplac_tpu_torch.inference.model import build_model
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.ops import _build
    from gaplac_tpu_torch.parallel.mesh import shard_chain_axis

    log(f"[31] path 7: run_chees with and without the world-size-1 mesh, whitened n = {N_OBS}")
    df = pd.read_csv(data, sep="\t")
    spec = parse_formula("y ~| SqExp(:x)")
    model = build_model(compile_formula(spec.formula), ["x"],
                        torch.tensor(df[["x"]].to_numpy(), dtype=torch.float32, device=dev),
                        torch.tensor(df["y"].to_numpy(), dtype=torch.float32, device=dev),
                        spec.likelihood, marginalize=False)
    q0 = model.initial_position(torch.Generator(device=dev).manual_seed(0), CHAINS)
    runs, launches = {}, {}
    for name, m in (("no mesh", None), ("world 1", mesh)):
        _build.reset_counts()
        t0 = time.perf_counter()
        runs[name] = run_chees(torch.Generator(device=dev).manual_seed(1), model.logdensity,
                               shard_chain_axis(q0, mesh=m), 5, num_warmup=10, mesh=m)
        torch.cuda.synchronize()
        launches[name] = (dict(_build.counts), time.perf_counter() - t0)
    a, b = runs["no mesh"], runs["world 1"]
    same = {k: (torch.equal(u, v) if torch.is_tensor(u) else u == v)
            for k, u, v in zip(a._fields, a, b)}
    log(f"  launches and walls (s) {launches}; equal bit for bit: {same}")
    if not all(same.values()):
        raise AssertionError(f"run_chees with the world-size-1 mesh differs: {same}")
    require_launches("path 7 chees", launches["world 1"][0], ("K1", "K2", "K2b"))
    return launches["world 1"][0], {"walls_s": {k: v[1] for k, v in launches.items()},
                                    "step_size": b.step_size, "traj_length": b.traj_length}


def phase_parallel(dev, data: Path, x4, y4) -> tuple:
    """Path 7: the parallel slice at world size 1 under NCCL on cuda:0."""
    from gaplac_tpu_torch.parallel import multihost
    from gaplac_tpu_torch.parallel.distributed import data_mesh
    from gaplac_tpu_torch.parallel.mesh import chain_mesh

    t0 = time.perf_counter()
    launches, out = {}, {}
    launches["mcmc"], out["mcmc"] = phase_parallel_mcmc(data)
    multihost.maybe_initialize(f"127.0.0.1:{free_port()}", 1, 0, dev)
    try:
        launches["dense"], out["dense"] = phase_parallel_dense(dev, data_mesh())
        launches["lowrank"], out["lowrank"] = phase_parallel_lowrank(dev, data_mesh(), x4, y4)
        launches["chees"], out["chees"] = phase_parallel_chees(dev, chain_mesh(), data)
    finally:
        multihost.shutdown()
    out["wall_s"] = time.perf_counter() - t0
    log(f"  path 7 took {out['wall_s']:.1f} s")
    return launches, out


def gram_times(dev) -> dict:
    """Only K2 and K2b at phase 5's shapes (``--gram-times``): the wrapper's
    host time, CUDA-event time, the profiler's device time and the bound.
    This script, copied into another checkout's root, times that checkout's
    kernels the same way."""
    from gaplac_tpu_torch import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula

    rng = np.random.default_rng(9)
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    f32 = dict(device=dev, dtype=torch.float32)
    X = torch.as_tensor(rng.uniform(-5, 5, (N_OBS, 1)), **f32)
    p = torch.as_tensor(rng.uniform(1, 2, (CHAINS, 1)), **f32)
    G = torch.randn((CHAINS, N_OBS, N_OBS), **f32)
    Xb = torch.as_tensor(rng.uniform(-5, 5, (N_BIG, 1)), **f32)
    return {k: {"host_ms": host_ms(kern), "ms": time_ms(kern), "device_ms": device_ms(kern),
                "bound_ms": bound_ms(flops, nbytes)[0]}
            for k, (kern, _, _, flops, nbytes)
            in gram_rows(ck, p, X, G, p[:1].contiguous(), Xb).items()}


def sde_probes(dev) -> dict:
    """``--sde-probes``: the combines' solver on the quasi-periodic
    value+grad, and the SqExp block's float32 steps (module docstring)."""
    from gaplac_tpu_torch.inference.hmc import value_and_grad
    from gaplac_tpu_torch.ops import markov_ss as mss

    out = {}
    log(f"[probe 1] {QP_FORMULA} value+grad at C = 1, n = {N_QP}: solve_ex against solve")
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(0, 500.0, N_QP))
    y = np.sin(2 * np.pi * x / 3.0) + rng.normal(0, 0.3, N_QP)
    model = sde_model(QP_FORMULA, x, y, dev, torch.float32)
    u1 = torch.as_tensor(logit_l([1.0])[:, None], dtype=torch.float32, device=dev)
    shipped = mss._solve
    solvers = {"solve_ex": shipped, "solve": lambda D, B: torch.linalg.solve(D, B)}
    try:
        for i, name in enumerate(("solve_ex", "solve", "solve", "solve_ex")):
            mss._solve = solvers[name]
            out[f"{i} {name}"] = profile_vg(f"{name} ({i})", model, u1, windows=1)
    finally:
        mss._solve = shipped

    log(f"[probe 2] SqExp (d = 6) from float32 data at n = {N_SQEXP}: float64 steps against "
        "float32 steps")
    x = np.sort(np.random.default_rng(3).uniform(0, 2000.0, N_SQEXP))
    t64 = torch.as_tensor(x, device=dev)
    A, Q, H = mss.build_steps([mss.BLOCK_SQEXP], [torch.tensor(1.5, dtype=torch.float64)], t64,
                              [None])
    gen = torch.Generator(device=dev).manual_seed(0)
    f = mss.measure_row(H, mss.ss_prior_sample(gen, A, Q))
    y = (f + torch.randn(f.shape, generator=gen, dtype=f.dtype, device=dev)).cpu().numpy()
    u = torch.as_tensor(logit_l([1.5])[:, None], device=dev)

    def run(dtype):
        m = sde_model("y ~| SqExp(:x)", x, y, dev, dtype)
        lp, g = value_and_grad(m.logdensity)(u.to(dtype))
        _, fr, lpr = m.report(torch.Generator(device=dev).manual_seed(1), u.to(dtype))
        A, Q, H = mss.build_steps([mss.BLOCK_SQEXP], [torch.tensor(1.5, dtype=dtype)],
                                  torch.as_tensor(x, dtype=dtype, device=dev), [None])
        P = mss.ss_filter_cov(A, Q, H, torch.ones(1, dtype=A.dtype, device=dev))
        # cuSOLVER's batched eigh refuses batches past EIGH_BATCH (psd_sqrt)
        least = torch.cat([torch.linalg.eigvalsh(c)[..., 0]
                           for c in P.double().split(mss.EIGH_BATCH)])
        return {"steps": str(A.dtype), "lp": float(lp), "grad": float(g.flatten()[0]),
                "least_eigenvalue": float(least.min()), "indefinite_steps": int((least < 0).sum()),
                "report_finite": bool(torch.isfinite(fr).all() and torch.isfinite(lpr).all())}

    ref = run(torch.float64)
    modal = mss._sqexp_constants_cached()

    def unit_variance_basis(order=mss.SQEXP_ORDER):
        modes, Pz, h = modal
        s, off = np.ones(len(h)), 0
        for _, be in modes:
            w = 1 if be is None else 2
            s[off:off + w] = 1.0 / math.sqrt(Pz.diagonal()[off:off + w].max())
            off += w
        return modes, s[:, None] * Pz * s[None, :], h / s

    variants = {"float64 steps (shipped)": {},
                "float32 steps, modal basis": {"steps_dtype": lambda kinds, dtype: dtype},
                "float32 steps, unit-variance basis": {
                    "steps_dtype": lambda kinds, dtype: dtype,
                    "_sqexp_constants_cached": unit_variance_basis}}
    for name, patch in variants.items():
        saved = {k: getattr(mss, k) for k in patch}
        try:
            for k, v in patch.items():
                setattr(mss, k, v)
            r = run(torch.float32)
        finally:
            for k, v in saved.items():
                setattr(mss, k, v)
        r["lp_rel_err"] = abs(r["lp"] - ref["lp"]) / abs(ref["lp"])
        r["grad_rel_err"] = abs(r["grad"] - ref["grad"]) / abs(ref["grad"])
        out[name] = r
        log(f"  {name}: {r}")
    out["float64"] = ref
    log(f"  float64 data: {ref}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = phase_card_and_build()
    if "--gram-times" in sys.argv[1:]:
        print(json.dumps({"card": card, "gram_times": gram_times(dev)}))
        return 0
    if "--sde-probes" in sys.argv[1:]:
        print(json.dumps({"card": card, "sde_probes": sde_probes(dev)}, default=str))
        return 0
    k1_err, k1_fit = phase_k1(dev)
    k2_errs = phase_k2(dev)
    k3_err = phase_k3(dev)
    phase_model_parity(dev)
    times = phase_timings(dev)
    mcmc_launches, rates, nuts_chain = phase_mcmc_path(dev)
    big_launches, walls, path2_checks = phase_big_path(dev, nuts_chain)
    # path 3, each part with the launch counts set to 0 just before it
    path3_launches, path3 = phase_hmc_advi(OUT_DIR / "data.tsv")
    path3_launches["laplace"], path3["laplace"] = phase_laplace(dev)
    path3_launches["smc"], path3["smc"] = phase_smc(dev, OUT_DIR / "data.tsv")
    path3_launches["fitplot"], path3["fitplot"] = phase_fitplot(dev, OUT_DIR / "data_4096.tsv")
    batch_errs, batch_times = batch_rows(dev)
    # path 4, each step with the launch counts set to 0 just before it
    path4_launches, walls4, x4, y4 = phase_rff_data()
    data4 = OUT_DIR / f"data_{N_RFF}.tsv"
    path4 = {"sample_walls_s": walls4}
    mcmc4_launches, path4["mcmc"] = phase_rff_mcmc(dev, data4, x4, y4)
    path4_launches.update({f"mcmc {k}": v for k, v in mcmc4_launches.items()})
    path4_launches["select"], path4["select"] = phase_rff_select(data4)
    path4_launches["select smc"], path4["smc"] = phase_rff_smc(dev, data4)
    path4_launches["predict"], path4["predict"] = phase_rff_predict(
        data4, path4["mcmc"]["chees"]["path"])
    path4_launches["fitplot"], path4["fitplot"] = phase_rff_fitplot(x4, y4)
    # path 5, each step with the launch counts set to 0 just before it
    path5_launches, path5 = {}, {}
    ou_launches, path5["ou"], x5, y5 = phase_sde_ou(dev)
    path5_launches.update({f"ou {k}": v for k, v in ou_launches.items()})
    path5_launches["dense check"], path5["dense_check"] = phase_sde_dense_check(dev, x5, y5)
    sq_launches, path5["sqexp"] = phase_sde_sqexp(dev)
    path5_launches.update({f"sqexp {k}": v for k, v in sq_launches.items()})
    qp_launches, path5["quasi_periodic"] = phase_sde_quasi_periodic(dev)
    path5_launches.update({f"quasi-periodic {k}": v for k, v in qp_launches.items()})
    ng_launches, path5["nongaussian"] = phase_sde_nongaussian(dev)
    path5_launches.update({f"bernoulli {k}": v for k, v in ng_launches.items()})
    lo_launches, path5["longitudinal"] = phase_sde_longitudinal(dev)
    path5_launches.update({f"longitudinal {k}": v for k, v in lo_launches.items()})
    auto_launches, path5["auto"] = phase_auto(dev)
    path5_launches.update({f"auto {k}": v for k, v in auto_launches.items()})
    # path 7, each part with the launch counts set to 0 just before it; before
    # path 6, whose --profile-dir traces leave the profiler dropping records
    path7_launches, path7 = phase_parallel(dev, OUT_DIR / "data.tsv", x4, y4)
    # path 6, each part with the launch counts set to 0 just before it
    path6_launches, path6 = {}, {}
    path6_launches["observability"], path6["observability"] = phase_observability(
        OUT_DIR / "data.tsv")
    fused_launches, path6["fused"] = phase_fused(dev)
    path6_launches.update({f"fused {k}": v for k, v in fused_launches.items()})
    path6["fastio"] = phase_fastio()
    kernels = []
    for key, name, src, replaces, err in (
        ("K1", "K1 chol_batched", "gaplac_tpu_torch/csrc/chol_batched.cu",
         "gaplac_tpu/ops/cholesky.py:296", k1_err),
        ("K2", "K2 gram", "gaplac_tpu_torch/csrc/gram.cu", "gaplac_tpu/ops/gram.py:154",
         k2_errs["K2"]),
        ("K2b", "K2b gram backward", "gaplac_tpu_torch/csrc/gram.cu",
         "gaplac_tpu/ops/gram.py:154", k2_errs["K2b"]),
        ("K3", "K3 chol_tile", "gaplac_tpu_torch/csrc/chol_tile.cu",
         "gaplac_tpu/ops/cholesky.py:81", k3_err),
    ):
        by_path = {"mcmc": mcmc_launches[key], "sample_select_predict": big_launches[key],
                   **{f"path3 {k}": v[key] for k, v in path3_launches.items()},
                   **{f"path4 {k}": v[key] for k, v in path4_launches.items()},
                   **{f"path5 {k}": v[key] for k, v in path5_launches.items()},
                   **{f"path6 {k}": v[key] for k, v in path6_launches.items()},
                   **{f"path7 {k}": v[key] for k, v in path7_launches.items()}}
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": sum(by_path.values()), "launches_by_path": by_path,
               "max_abs_err": err, **times[key]}
        if key == "K1":
            row["cluster"] = {"rule": "16 where the batch's clusters of 16 fit at once, else 8",
                              "clusters_that_fit": k1_fit}
            row["C1"] = times["K1 C=1"]
            row["other_clusters"] = {k: v for k, v in times.items()
                                     if k.startswith("K1") and "cluster" in k}
            # path 4's capacitance batch, and batched n >= 2048 (the last beside the
            # blocked route on the same matrix: K3's row, blocked_cholesky_n4096)
            row["large_shapes"] = {k: times[k] for k in
                                   ("K1 (8,512,512)", "K1 (8,2048,2048)", "K1 (1,4096,4096)")}
            row["large_shapes"]["capacitance_max_abs_err"] = path4["mcmc"]["k1_capacitance_err"]
        fused = path6["fused"]
        if key == "K2":
            row["C1"] = times["K2 C=1"]
            row["path2"] = {"max_abs_err": path2_checks["K2"], **times["K2 n=4096"]}
            row["cross"] = times["K2 cross"]
            row["fused_panels"] = {"max_abs_err": fused["k2_offsets_err"],
                                   **{k: v for k, v in fused["panel_rows"].items()
                                      if k.startswith("K2 ")}}
        if key == "K2b":
            row["C1"] = times["K2b C=1"]
            row["fused"] = {"in_value_grad": fused["value_grad"]["port_kernels"].get("K2b"),
                            **{k: v for k, v in fused["panel_rows"].items()
                               if k.startswith("K2b ")}}
        if key == "K3":
            row["blocked_cholesky_n4096"] = times["blocked"]
            row["fused_forward"] = fused["forward"]["port_kernels"].get("K3")
        kernels.append(row)
        if key in ("K1", "K2"):  # the same kernel at SMC's particle batch
            kernels.append({
                "name": f"{name} ({512}, {N_OBS}, {N_OBS})", "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": path3["smc"]["launches_at_512"][key],
                "launches_by_path": {"path3 smc, at the particle batch":
                                     path3["smc"]["launches_at_512"][key]},
                "max_abs_err": batch_errs[key], **batch_times[f"{key} B=512"]})
    log(f"card: {card}; path 1: " + json.dumps(rates) + "; path 2 walls (s): "
        + json.dumps(walls) + "; select, predict: "
        + json.dumps({k: path2_checks[k] for k in ("select", "predict")}))
    log("path 3: " + json.dumps(path3, default=str))
    log("path 4: " + json.dumps(path4, default=str))
    log("path 5: " + json.dumps(path5, default=str))
    log("path 6: " + json.dumps(path6, default=str))
    log("path 7: " + json.dumps(path7, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
