"""`--approx rff` through the port's CLI against gaplac_tpu's, both on the
CPU in float64: twins of tests/test_lowrank.py's oracles.  select
--formulae's log densities and Bayes factor, predict's columns and
fitplot's component posteriors to 1e-9; sample's tables; and gaplac_tpu's
refusals (mcmc's twins are in test_torch_rff_mcmc.py)."""

import argparse

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gaplac_tpu.cli import fitplot_cmd as jfit
from gaplac_tpu.cli import select_cmd as jselect
from gaplac_tpu.cli.main import build_parser as jax_parser
from gaplac_tpu.cli.main import main as jax_main
from gaplac_tpu.dsl import parse_formula as jax_parse
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu_torch.cli import fitplot_cmd, select_cmd
from gaplac_tpu_torch.cli.main import build_parser, main
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.kernels.features import build_feature_map
from gaplac_tpu_torch.runtime import Runtime

RTOL = 1e-9
CPU64 = Runtime(torch.device("cpu"), torch.float64)
RFF = ["--approx", "rff", "--rff-features", "24", "--rff-seed", "5"]


def _close(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * max(np.abs(ref).max(), 1.0))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rff")
    rng = np.random.default_rng(4)
    n = 40
    x = rng.uniform(-4, 4, n)
    pd.DataFrame({"x": x, "g": rng.integers(0, 3, n).astype(float), "t": rng.normal(size=n),
                  "y": np.sin(x) + 0.5 * rng.normal(size=n)}).to_csv(d / "data.tsv", sep="\t",
                                                                      index=False)
    pd.DataFrame({"iteration": np.arange(1, 31), "chain": np.ones(30, int),
                  "ℓ": rng.uniform(1.0, 2.5, 30), "lp": rng.normal(-80, 3, 30)}
                 ).to_csv(d / "chain.tsv", sep="\t", index=False)
    return d


def test_select_formulae_rff_matches_jax(files):
    formulae = ["y ~| SqExp(:x)", "y ~| OU(:x; l=2.0) + Cat(:g) + Noise"]
    argv = ["--platform", "cpu", "select", "--formulae", *formulae, "--data",
            str(files / "data.tsv"), *RFF]
    jb = jselect.run(jax_parser().parse_args(argv))
    args = build_parser().parse_args(argv)
    _close(select_cmd.run(args, CPU64), jb)
    df = pd.read_csv(files / "data.tsv", sep="\t")
    for f in formulae:
        jck = jax_compile(jax_parse(f).formula)
        ref = jselect._lowrank_fixed_lp(args, jck, jnp.asarray(df[list(jck.varnames)].to_numpy()),
                                        jnp.asarray(df["y"].to_numpy()))
        _close(select_cmd.lowrank_fixed_lp(args, parse_formula(f), df, CPU64), ref)


def _both(tmp, argv, name):
    out = []
    for tag, fn in (("jax", jax_main), ("torch", main)):
        path = tmp / f"{name}_{tag}.tsv"
        assert fn(["--platform", "cpu", *argv, "--output", str(path)]) == 0
        out.append(pd.read_csv(path, sep="\t"))
    return out


def test_predict_rff_matches_jax(files):
    """The weight-space predictive of each chain draw, mixed; a Cat level
    only the --at table has (the vocabulary spans both tables)."""
    ref, got = _both(files, ["predict", "y ~| SqExp(:x) + Cat(:g)", "--data",
                             str(files / "data.tsv"), "--at", "x=-5:0.5:5; g=0:1:3", "--mcmc",
                             str(files / "chain.tsv"), *RFF], "predict")
    assert list(got.columns) == list(ref.columns) == ["x", "g", "ymu", "yQ050", "yQ950"]
    for col in ref.columns:
        _close(got[col], ref[col])


@pytest.mark.parametrize("posterior", [False, True])
def test_sample_rff_tables_match_jax(files, posterior):
    argv = ["sample", "y :~| SqExp(:x; l=1.5) + Cat(:g)", "--at",
            "x = rand(Uniform(-5,5), 30); g=[0,1]", "--seed", "1", *RFF]
    if posterior:
        argv = ["sample", "y ~| SqExp(:x) + Cat(:g)", "--data", str(files / "data.tsv"),
                "--mcmc", str(files / "chain.tsv"), "--at", "x=-5:1:5; g=0", "--seed", "2", *RFF]
    ref, got = _both(files, argv, f"sample{int(posterior)}")
    assert list(got.columns) == list(ref.columns) == ["x", "g", "y"]
    np.testing.assert_array_equal(got[["x", "g"]].to_numpy(), ref[["x", "g"]].to_numpy())
    assert np.isfinite(got["y"]).all()


def test_fitplot_rff_matches_jax(files, tmp_path):
    """Feature-block and bare-Noise components through the Woodbury
    factorization, against gaplac_tpu's _lowrank_component_stats; and the
    command writes its PNG."""
    formula = "y ~| SqExp(:x) * Cat(:g) + Linear(:t; c=0.5) + Noise"
    df = pd.read_csv(files / "data.tsv", sep="\t")
    jck = jax_compile(jax_parse(formula).formula)
    ck = compile_formula(parse_formula(formula).formula)
    X = df[list(ck.varnames)].to_numpy()
    y = df["y"].to_numpy()
    args = argparse.Namespace(rff_features=24, rff_seed=5, approx="rff")
    stats = jfit._lowrank_component_stats(args, jck, jck.default_params(jnp.float64),
                                          jnp.asarray(X), jnp.asarray(y), 1.1)
    fm = build_feature_map(ck, [torch.tensor(X)], num_features=24, seed=5)
    got = fitplot_cmd.lowrank_component_posteriors(fm, ck.default_params(), torch.tensor(X),
                                                   torch.tensor(y), 1.1, range(3))
    assert [t for t, _, _ in got] == [0, 1, 2] and fm.term_slices[2] is None
    for t, mu, sd in got:
        mu_ref, var_ref = map(np.asarray, stats(t))
        _close(mu, mu_ref)
        _close(sd, np.sqrt(np.maximum(var_ref, 0.0)))
    out = tmp_path / "fit.png"
    assert main(["--platform", "cpu", "fitplot", formula, "--data", str(files / "data.tsv"),
                 "--mcmc", str(files / "chain.tsv"), "--infer", "x", "-o", str(out), *RFF]) == 0
    assert out.stat().st_size > 0


@pytest.mark.parametrize("argv", [
    ["mcmc", "y : Bernoulli ~| SqExp(:x)", "--infer", "x"],
    ["mcmc", "y ~| Periodic(:x; l=1.0, p=2.0)", "--infer", "x", "--infer-extra", "x"],
    ["predict", "y ~| Periodic(:x; l=1.0, p=2.0)", "--at", "x=0:1:2", "--mcmc", "CHAIN",
     "--infer-extra", "x"],
], ids=["non-gaussian", "infer-extra", "infer-extra chain"])
def test_rff_refusals_match_jax(files, argv, capsys):
    """gaplac_tpu's ValueErrors, exit code 2 with the same message."""
    data = files / "binary.tsv"
    df = pd.read_csv(files / "data.tsv", sep="\t")
    df.assign(y=(df["y"] > 0).astype(int)).to_csv(data, sep="\t", index=False)
    argv = [a.replace("CHAIN", str(files / "chain.tsv")) for a in argv]
    errors = []
    for fn in (jax_main, main):
        assert fn(["--platform", "cpu", *argv, "--data", str(data), *RFF]) == 2
        errors.append([s for s in capsys.readouterr().err.splitlines() if s.startswith("error:")])
    assert errors[0] == errors[1] and len(errors[1]) == 1
