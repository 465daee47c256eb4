"""`--approx sde` and `--approx auto` through the port's CLI against
gaplac_tpu's, both on the CPU in float64: select --formulae's numbers and
predict's columns (monolithic and windowed) to 1e-9, fitplot's component
posteriors to 1e-9; the tables of sample and of mcmc with every sampler, the
Bernoulli Laplace marginal and --no-marginalize in gaplac_tpu's schema;
--approx auto's decisions on tests/test_routing.py's cases and the
lengthscale guard; --sde-harmonics taking effect and not leaking into the
next run in the process; and gaplac_tpu's rejections with its messages."""

import argparse

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gaplac_tpu.cli import select_cmd as jselect
from gaplac_tpu.cli.main import build_parser as jax_parser
from gaplac_tpu.cli.main import main as jax_main
from gaplac_tpu.dsl import parse_formula as jax_parse
from gaplac_tpu.inference import routing as jrouting
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu.ops import markov_ss as jss
from gaplac_tpu_torch.cli import fitplot_cmd, sample_cmd, select_cmd
from gaplac_tpu_torch.cli.common import design_matrices, design_matrix
from gaplac_tpu_torch.cli.main import build_parser, main
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.inference import routing
from gaplac_tpu_torch.inference.likelihoods import gaussian_obs_sigma2
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.ops import markov_ss as mss
from gaplac_tpu_torch.runtime import Runtime

RTOL = 1e-9
CPU64 = Runtime(torch.device("cpu"), torch.float64)
SDE = ["--approx", "sde"]


def _close(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * max(np.abs(ref).max(), 1.0))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sde")
    rng = np.random.default_rng(4)
    n = 36
    g = np.repeat([0.0, 1.0, 2.0], n // 3)
    x = np.concatenate([np.sort(rng.uniform(0, 6, n // 3)) for _ in range(3)])
    y = np.sin(x) + 0.5 * g + 0.4 * rng.normal(size=n)
    pd.DataFrame({"x": x, "g": g, "y": y}).to_csv(d / "data.tsv", sep="\t", index=False)
    pd.DataFrame({"x": x, "g": g, "y": (y > 0.5).astype(int)}).to_csv(d / "binary.tsv", sep="\t",
                                                                      index=False)
    pd.DataFrame({"iteration": np.arange(1, 9), "chain": np.ones(8, int),
                  "ℓ": rng.uniform(0.8, 2.0, 8), "lp": rng.normal(-80, 3, 8)}
                 ).to_csv(d / "chain.tsv", sep="\t", index=False)
    return d


def test_select_formulae_sde_matches_jax(files):
    formulae = ["y ~| OU(:x)", "y ~| Matern32(:x) * Cat(:g) + Cat(:g) + Noise"]
    argv = ["--platform", "cpu", "select", "--formulae", *formulae, "--data",
            str(files / "data.tsv"), *SDE]
    _close(select_cmd.run(build_parser().parse_args(argv), CPU64),
           jselect.run(jax_parser().parse_args(argv)))
    df = pd.read_csv(files / "data.tsv", sep="\t")
    args = argparse.Namespace(jitter=0.1)
    for f in formulae:
        jck = jax_compile(jax_parse(f).formula)
        ref = jselect._markov_fixed_lp(args, jck, jnp.asarray(df[list(jck.varnames)].to_numpy()),
                                       jnp.asarray(df["y"].to_numpy()))
        _close(select_cmd.markov_fixed_lp(parse_formula(f), df, 0.1, CPU64), ref)


def _both(tmp, argv, name):
    out = []
    for tag, fn in (("jax", jax_main), ("torch", main)):
        path = tmp / f"{name}_{tag}.tsv"
        assert fn(["--platform", "cpu", *argv, "--output", str(path)]) == 0
        out.append(pd.read_csv(path, sep="\t"))
    return out


@pytest.mark.parametrize("case", ["scalar ou", "grouped chain", "windowed"])
def test_predict_sde_matches_jax(files, case):
    argv = {"scalar ou": ["predict", "y ~| OU(:x)", "--at", "x=-1:0.5:7"],
            "grouped chain": ["predict", "y ~| Matern32(:x) * Cat(:g) + Noise", "--at",
                              "x=0:0.5:6; g=0:1:2", "--mcmc", str(files / "chain.tsv"),
                              "--infer", "x"],
            "windowed": ["predict", "y ~| Matern52(:x) + OU(:x; l=2.0)", "--at", "x=0:0.25:6",
                         "--sde-window", "16", "--sde-overlap", "6"]}[case]
    ref, got = _both(files, [*argv, "--data", str(files / "data.tsv"), *SDE], case)
    assert list(got.columns) == list(ref.columns)
    for col in ref.columns:
        _close(got[col], ref[col])


def test_fitplot_sde_matches_dense(files, tmp_path):
    """Block components and a Noise term of an exact-block formula through
    one smoothing pass equal the dense component posteriors; the command
    writes its PNG."""
    formula = "y ~| Matern32(:x) * Cat(:g) + Cat(:g) + Noise"
    df = pd.read_csv(files / "data.tsv", sep="\t")
    ck = compile_formula(parse_formula(formula).formula)
    X, y = torch.tensor(df[list(ck.varnames)].to_numpy()), torch.tensor(df["y"].to_numpy())
    p = ck.default_params()
    got = fitplot_cmd.markov_component_posteriors(ck, p, X, y, 1.1, range(3))
    ref = fitplot_cmd.component_posteriors(ck, p, X, y, 1.1, range(3))
    for (t, mu, sd), (tr, mu_ref, sd_ref) in zip(got, ref):
        assert t == tr
        _close(mu, mu_ref)
        _close(sd, sd_ref)
    out = tmp_path / "fit.png"
    assert main(["--platform", "cpu", "fitplot", formula, "--data", str(files / "data.tsv"),
                 "--mcmc", str(files / "chain.tsv"), "--infer", "x", "-o", str(out), *SDE]) == 0
    assert out.stat().st_size > 0


@pytest.mark.parametrize("posterior", [False, True])
def test_sample_sde_tables(files, tmp_path, posterior):
    """The prior draw and the posterior draw given --data and a chain row:
    the --at rows and the drawn column (the draws are the port's own RNG's)."""
    argv = ["sample", "y :~| OU(:x; l=1.5) * Cat(:g) + Cat(:g)", "--at",
            "x = rand(Uniform(0,6), 30); g=[0,1]", "--seed", "1", *SDE]
    if posterior:
        argv = ["sample", "y ~| Matern32(:x) * Cat(:g) + Noise", "--data",
                str(files / "data.tsv"), "--mcmc", str(files / "chain.tsv"), "--infer", "x",
                "--at", "x=0:1:6; g=0:1:2", "--seed", "2", *SDE]
    out = tmp_path / "s.tsv"
    assert main(["--platform", "cpu", *argv, "--output", str(out)]) == 0
    got = pd.read_csv(out, sep="\t")
    assert list(got.columns) == ["x", "g", "y"] and len(got) == (30 * 2 if not posterior else 21)
    assert np.isfinite(got["y"]).all()


@pytest.mark.parametrize("posterior", [False, True])
def test_sde_draws_match_dense_moments(files, posterior):
    """20000 state-space draws of sample, in one call with the parameters
    batched: the prior draw of OU * Cat (group resets, rows out of order)
    against the dense gram, and the posterior draw (Matheron's rule through
    the joined rows) against the dense posterior_at; each mean within 5
    standard errors, each covariance entry within 5 standard errors of its
    estimate."""
    B, jitter = 20000, 1e-6
    rng = np.random.default_rng(9)
    tdf = pd.DataFrame({"x": rng.uniform(0, 6, 12), "g": rng.integers(0, 3, 12).astype(float)})
    formula = ("y ~| Matern32(:x) * Cat(:g) + Noise" if posterior
               else "y :~| OU(:x; l=1.5) * Cat(:g) + Cat(:g)")
    spec = parse_formula(formula)
    ck = compile_formula(spec.formula)
    p = ck.default_params()
    gen = torch.Generator().manual_seed(3)
    if posterior:
        df = pd.read_csv(files / "data.tsv", sep="\t")
        X_np, Xt_np = design_matrices(df, tdf, ck)
        X, Xt = torch.tensor(X_np), torch.tensor(Xt_np)
        y = torch.tensor(df["y"].to_numpy())
        sigma2 = gaussian_obs_sigma2(spec.likelihood)
        f = sample_cmd._sde_posterior_draw(ck, X, Xt, y, p.expand(B, -1), gen, jitter, sigma2)
        mu, cov = sample_cmd.posterior_at(ck, p, X, Xt, y, jitter, sigma2)
        cov = cov + jitter * torch.eye(cov.shape[0], dtype=cov.dtype)  # sample_mvn's jitter
    else:
        Xt = torch.tensor(design_matrix(tdf, ck))
        f = sample_cmd._sde_prior_draw(ck, Xt, p.expand(B, -1), gen, jitter)
        mu, cov = torch.zeros(Xt.shape[0], dtype=torch.float64), ck.gram(p, Xt, diag=jitter)
    f, mu, cov = f.numpy(), mu.numpy(), cov.numpy()
    assert f.shape == (B, Xt.shape[0])
    var = np.diag(cov)
    assert np.all(np.abs(f.mean(0) - mu) <= 5 * np.sqrt(var / B))
    se = np.sqrt((np.outer(var, var) + cov ** 2) / B)
    assert np.all(np.abs(np.cov(f.T) - cov) <= 5 * se)


SAMPLERS = {
    "nuts": (["--samples", "4", "--warmup", "4"], ["tree_depth", "numerical_error"], 1),
    "chees": (["--sampler", "chees", "--chains", "4", "--samples", "3", "--warmup", "3"],
              ["step_size", "traj_length"], 4),
    "hmc": (["--sampler", "hmc", "--chains", "2", "--samples", "3", "--warmup", "1",
             "--leapfrogs", "2"], ["step_size"], 2),
    "advi": (["--sampler", "advi", "--samples", "3", "--vi-steps", "20"], [], 1),
}


@pytest.mark.parametrize("sampler, model", [
    *((s, "marginal") for s in sorted(SAMPLERS)), ("hmc", "laplace"), ("nuts", "whitened"),
    ("chees", "whitened")])
def test_mcmc_sde_every_sampler(files, tmp_path, sampler, model):
    """The chain table in gaplac_tpu's schema for each sampler on the
    marginal model, and on the Laplace marginal and the whitened model."""
    flags, stats, chains = SAMPLERS[sampler]
    data = files / ("binary.tsv" if model == "laplace" else "data.tsv")
    formula = "y : Bernoulli ~| OU(:x)" if model == "laplace" else "y ~| Matern32(:x) + Noise"
    out = tmp_path / "c.tsv"
    extra = ["--no-marginalize"] if model == "whitened" else []
    assert main(["--platform", "cpu", "mcmc", formula, "--data", str(data), "--infer", "x",
                 "--seed", "3", "--output", str(out), *flags, *extra, *SDE]) == 0
    df = pd.read_csv(out, sep="\t")
    accept = [] if sampler == "advi" else ["acceptance_rate"]
    assert list(df.columns) == (["iteration", "chain", "ℓ"] + [f"fx[{i + 1}]" for i in range(36)]
                                + ["lp"] + accept + stats)
    assert len(df) == chains * 3 + (1 if sampler == "nuts" else 0) * chains
    assert np.isfinite(df.to_numpy(dtype=float)).all()


def _big_ou(tmp, n=4100):
    rng = np.random.default_rng(8)
    x = np.sort(rng.uniform(0, 400, n))
    y = np.exp(-np.abs(np.diff(x, prepend=x[0])))  # any series
    path = tmp / "big.tsv"
    pd.DataFrame({"x": x, "y": np.sin(x / 7) + 0.3 * rng.normal(size=n) + 0 * y}).to_csv(
        path, sep="\t", index=False)
    return path


def test_auto_on_every_command(files, tmp_path, caplog):
    """At n = 36 auto takes the dense path on every command; at n = 4100 it
    takes sde, and select's numbers equal those of --approx sde."""
    import logging

    caplog.set_level(logging.INFO, logger="gaplac")
    data, chain = str(files / "data.tsv"), str(files / "chain.tsv")
    auto = ["--approx", "auto"]
    argvs = [
        ["sample", "y :~| OU(:x; l=1.5)", "--at", "x=0:1:5", "--output", str(tmp_path / "s.tsv")],
        ["mcmc", "y ~| OU(:x)", "--data", data, "--infer", "x", "--samples", "3", "--warmup",
         "3", "--output", str(tmp_path / "m.tsv")],
        ["select", "--formulae", "y ~| OU(:x)", "y ~| SqExp(:x)", "--data", data],
        ["predict", "y ~| OU(:x)", "--data", data, "--mcmc", chain, "--at", "x=0:1:5",
         "--output", str(tmp_path / "p.tsv")],
        ["fitplot", "y ~| OU(:x) + Noise", "--data", data, "-o", str(tmp_path / "f.png")],
    ]
    for argv in argvs:
        caplog.clear()
        assert main(["--platform", "cpu", *argv, *auto]) == 0
        assert any("--approx auto: none" in r.getMessage() for r in caplog.records), argv[0]
    big = str(_big_ou(tmp_path))
    caplog.clear()
    sel = ["--platform", "cpu", "select", "--formulae", "y ~| OU(:x)", "y ~| Matern32(:x)",
           "--data", big]
    b_auto = select_cmd.run(build_parser().parse_args([*sel, *auto]), CPU64)
    assert sum("--approx auto: sde" in r.getMessage() for r in caplog.records) == 2
    _close(b_auto, select_cmd.run(build_parser().parse_args([*sel, *SDE]), CPU64))
    caplog.clear()
    assert main(["--platform", "cpu", "mcmc", "y ~| OU(:x)", "--data", big, "--infer", "x",
                 "--samples", "2", "--warmup", "2", "--no-latents", "--output",
                 str(tmp_path / "mb.tsv"), *auto]) == 0
    assert any("--approx auto: sde" in r.getMessage() for r in caplog.records)


def _ck_both(formula):
    return (jax_compile(jax_parse(formula).formula), compile_formula(parse_formula(formula).formula))


def _X(n, cols=1, span=10.0, seed=0):
    rng = np.random.default_rng(seed)
    return np.tile(np.sort(rng.uniform(0, span, n))[:, None], (1, cols))


ROUTING_CASES = [  # tests/test_routing.py's cases: (formula, X, command, likelihood formula)
    ("y ~| SqExp(:x)", _X(500), "mcmc", None),
    ("y ~| SqExp(:x)", _X(4096), "mcmc", None),
    ("y ~| OU(:x)", _X(8192), "mcmc", None),
    ("y ~| SqExp(:x)", _X(8192), "select", None),
    ("y ~| Matern32(:x) + Noise", _X(8192), "mcmc", None),
    ("y ~| SqExp(:x) * SqExp(:z)", np.random.default_rng(1).uniform(0, 10, (8192, 2)), "mcmc", None),
    ("y ~| SqExp(:x) * SqExp(:z)", np.random.default_rng(1).uniform(0, 10, (500, 2)), "mcmc", None),
    ("y ~| Periodic(:x; p=3.0) * Matern32(:x)", _X(16384, 2), "mcmc", None),
    ("y ~| Periodic(:x; p=3.0) * Matern32(:x)", _X(16385, 2), "mcmc", None),
    ("y ~| Periodic(:x; p=3.0) * Matern32(:x)", _X(16384, 2), "predict", None),
    ("y ~| Periodic(:x; p=3.0) * Matern32(:x)", _X(1 << 17, 2), "fitplot", None),
    ("y : Bernoulli ~| OU(:x)", _X(8192), "mcmc", "lik"),
    ("y : Bernoulli ~| SqExp(:x) * SqExp(:z)",
     np.random.default_rng(2).uniform(0, 10, (8192, 2)), "mcmc", "lik"),
    ("y : Bernoulli ~| SqExp(:x) * SqExp(:z)",
     np.random.default_rng(2).uniform(0, 10, (300, 2)), "mcmc", "lik"),
    ("y : Bernoulli ~| OU(:x)", _X(1000), "mcmc", "lik"),
]


@pytest.mark.parametrize("case", range(len(ROUTING_CASES)))
def test_choose_approx_matches_jax(case):
    formula, X, command, lik = ROUTING_CASES[case]
    jck, ck = _ck_both(formula)
    jlik = jax_parse(formula).likelihood if lik else None
    tlik = parse_formula(formula).likelihood if lik else None
    got = routing.choose_approx(ck, X, command, likelihood=tlik)
    assert got == jrouting.choose_approx(jck, X, command, likelihood=jlik)
    d, approx, _ = routing.sde_structure_info(ck, X)
    jd, japprox, _ = jrouting.sde_structure_info(jck, X)
    assert (d, approx) == (jd, japprox)


def test_lengthscale_guard_matches_jax():
    X = _X(200, span=10.0)
    bad = np.full((2, 50, 1), 4.0) + np.random.default_rng(0).normal(0, 0.2, (2, 50, 1))
    good = np.full((2, 50, 1), 1.5)
    for formula, thetas in (("y ~| SqExp(:x)", bad), ("y ~| SqExp(:x)", good),
                            ("y ~| OU(:x)", bad), ("y ~| RQ(:x; alpha=2) * Cat(:g)", bad)):
        jck, ck = _ck_both(formula)
        Xf = np.concatenate([X, np.repeat([[0.0], [1.0]], 100, 0)], 1)[:, :len(ck.varnames)]
        groups = (tuple(range(ck.n_leaves)),)
        msg = routing.sde_lengthscale_guard(ck, routing.sde_structure_info(ck, Xf)[2], Xf, thetas,
                                            groups)
        ref = jrouting.sde_lengthscale_guard(jck, jrouting.sde_structure_info(jck, Xf)[2], Xf,
                                             thetas, groups)
        assert msg == ref, formula
    assert routing.sde_lengthscale_guard(*(_ck_both("y ~| SqExp(:x)")[1:]), None, X, bad,
                                         groups) is None


def test_mcmc_prints_the_guard(files, tmp_path, capsys):
    """A SqExp posterior past a third of the span: mcmc prints the guard."""
    rng = np.random.default_rng(6)
    x = np.sort(rng.uniform(0, 1, 30))
    path = tmp_path / "flat.tsv"
    pd.DataFrame({"x": x, "y": 0.05 * rng.normal(size=30)}).to_csv(path, sep="\t", index=False)
    assert main(["--platform", "cpu", "mcmc", "y ~| SqExp(:x)", "--data", str(path), "--infer",
                 "x", "--samples", "20", "--warmup", "20", "--output", str(tmp_path / "c.tsv"),
                 *SDE]) == 0
    assert "--approx sde accuracy guard" in capsys.readouterr().out


def test_sde_harmonics_takes_effect_and_does_not_leak(files, capsys):
    """--sde-harmonics 3 gives the Periodic block 7 states and another lp;
    the next run without the flag is back at 21 states and the default lp;
    at J = 3 the lp equals gaplac_tpu's at J = 3."""
    sel = ["--platform", "cpu", "select", "--formulae", "y ~| Periodic(:x; l=0.5, p=3.0)",
           "y ~| OU(:x)", "--data", str(files / "data.tsv"), *SDE]

    def lp1():
        return float(capsys.readouterr().out.split("model 1:")[1].split()[0])

    assert main([*sel, "--sde-harmonics", "3", "--sde-soa-max-d", "0"]) == 0
    assert mss.block_dim(mss.BLOCK_PERIODIC) == 7
    lp3 = lp1()
    assert main(sel) == 0
    assert mss.block_dim(mss.BLOCK_PERIODIC) == 21
    assert abs(lp1() - lp3) > 1e-3
    try:
        for knob in (jss.set_periodic_harmonics, mss.set_periodic_harmonics):
            knob(3)
        _close(select_cmd.run(build_parser().parse_args(sel), CPU64),
               jselect.run(jax_parser().parse_args(sel)))
    finally:
        for knob in (jss.set_periodic_harmonics, mss.set_periodic_harmonics):
            knob(10)


@pytest.mark.parametrize("argv", [
    ["mcmc", "y ~| OU(:x) * Cat(:g) + Cat(:h)", "--infer", "x"],
    ["mcmc", "y ~| RQ(:x; alpha=2)", "--infer", "x", "--infer-extra", "x"],
    ["select", "--formulae", "y ~| SqExp(:x) * SqExp(:g)", "y ~| OU(:x)"],
    ["predict", "y ~| OU(:x) + Noise * Cat(:g)", "--at", "x=0:1:2; g=0"],
], ids=["crossed", "dynamic alpha", "two axes", "noise x cat"])
def test_sde_rejections_match_jax(files, tmp_path, argv, capsys):
    """gaplac_tpu's ValueErrors: exit code 2 with the same message."""
    data = tmp_path / "crossed.tsv"
    df = pd.read_csv(files / "data.tsv", sep="\t")
    df.assign(h=np.tile([0.0, 1.0], len(df) // 2)).to_csv(data, sep="\t", index=False)
    errors = []
    for fn in (jax_main, main):
        assert fn(["--platform", "cpu", *argv, "--data", str(data), *SDE]) == 2
        errors.append([s for s in capsys.readouterr().err.splitlines() if s.startswith("error:")])
    assert errors[0] == errors[1] and len(errors[1]) == 1
