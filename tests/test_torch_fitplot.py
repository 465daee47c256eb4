"""The port's `fitplot` and plots against gaplac_tpu's, float64 on the CPU:
the component posterior means and sds against gaplac_tpu's formula (its
``term_gram``), ``--component`` and ``--mcmc``, the PNGs written, and the
sample plot's refit line against gaplac_tpu's."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gaplac_tpu.cli import fitplot_cmd as jfit
from gaplac_tpu.dsl import parse_formula as jax_parse
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu_torch.cli import fitplot_cmd
from gaplac_tpu_torch.cli.main import main
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.kernels.covariance import compile_formula

FORMULAE = ["y ~| SqExp(:x; l=1.5) + OU(:x; l=3)",
            "y ~| SqExp(:x) * Cat(:g) + Linear(:t; c=0.5) + Noise"]


def _close(got, ref, rtol=1e-9):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1.0))


def _frame(n=36, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, 5, n)
    return pd.DataFrame({"x": x, "g": rng.integers(0, 3, n).astype(float),
                         "t": rng.normal(size=n), "y": np.sin(x) + 0.3 * rng.normal(size=n)})


def _jax_components(formula, df, noise, overrides=None):
    """gaplac_tpu's component formula: mu_t = K_t S^-1 y and var_t =
    diag(K_t) - diag(K_t S^-1 K_t), S = K + noise I, through its term_gram."""
    jck = jax_compile(jax_parse(formula).formula)
    X = jnp.asarray(df[list(jck.varnames)].to_numpy())
    y = df["y"].to_numpy()
    p = jck.default_params(jnp.float64)
    for slots, value in (overrides or {}).items():
        p = p.at[jnp.asarray(slots)].set(value)
    S = np.asarray(jck.gram(p, X)) + noise * np.eye(len(y))
    alpha = np.linalg.solve(S, y)
    out = []
    for t in range(len(jck.terms)):
        Kt = np.asarray(jfit.term_gram(jck, t, p, X))
        var = np.diag(Kt) - np.sum(Kt * np.linalg.solve(S, Kt), 0)
        out.append((Kt @ alpha, np.sqrt(np.maximum(var, 0))))
    return out, [jfit.term_label(jck, t) for t in range(len(jck.terms))]


@pytest.mark.parametrize("formula", FORMULAE)
def test_component_posteriors_match_jax(formula):
    df = _frame()
    ck = compile_formula(parse_formula(formula).formula)
    X = torch.tensor(df[list(ck.varnames)].to_numpy())
    got = fitplot_cmd.component_posteriors(ck, ck.default_params(), X,
                                           torch.tensor(df["y"].to_numpy()), 1.1,
                                           range(len(ck.terms)))
    ref, labels = _jax_components(formula, df, 1.1)
    assert [t for t, _, _ in got] == list(range(len(ref)))
    for (_, mu, sd), (rmu, rsd) in zip(got, ref):
        _close(mu, rmu)
        _close(sd, rsd)
    assert [fitplot_cmd.term_label(ck, t) for t in range(len(ck.terms))] == labels


def test_fitplot_component_and_mcmc(tmp_path, monkeypatch, capsys):
    """fitplot --component t --mcmc chain: only the terms on t, at the
    chain's posterior-mean lengthscale; the PNG is written, with
    gaplac_tpu's report line."""
    pytest.importorskip("matplotlib")
    formula = FORMULAE[1]
    df = _frame(30, 1)
    data, chain, png = tmp_path / "d.tsv", tmp_path / "c.tsv", tmp_path / "f.png"
    df.to_csv(data, sep="\t", index=False)
    pd.DataFrame({"iteration": [1, 2, 3], "chain": [1, 1, 1], "ℓ": [1.0, 2.0, 4.5],
                  "lp": [-3.0, -2.0, -1.0]}).to_csv(chain, sep="\t", index=False)
    seen = []
    posteriors = fitplot_cmd.component_posteriors
    monkeypatch.setattr(fitplot_cmd, "component_posteriors",
                        lambda *a: seen.append(posteriors(*a)) or seen[-1])
    assert main(["--platform", "cpu", "fitplot", formula, "--data", str(data), "--mcmc",
                 str(chain), "--infer", "x", "--component", "t;nothing", "--output",
                 str(png)]) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert capsys.readouterr().out == f"fitplot written to {png} (1 component(s))\n"
    (panels,) = seen
    assert [t for t, _, _ in panels] == [1]  # Linear(:t) only
    ref, _ = _jax_components(formula, df, 1.1, {(0,): 2.5})  # SqExp's l at the chain mean
    _close(panels[0][1], ref[1][0])
    _close(panels[0][2], ref[1][1])
    assert main(["--platform", "cpu", "fitplot", formula, "--data", str(data), "--component",
                 "nothing", "--output", str(tmp_path / "none.png")]) == 2


def test_sample_plot_refit_line_matches_jax():
    pytest.importorskip("matplotlib")
    from gaplac_tpu.viz import plots as jplots
    from gaplac_tpu_torch.viz import plots

    rng = np.random.default_rng(3)
    x, y = rng.uniform(-4, 4, 25), rng.normal(size=25)
    spec = "y ~| SqExp(:x; l=1.2)"
    ref = jplots.sample_plot(jax_compile(jax_parse(spec).formula), x, y, "x", "y")
    got = plots.sample_plot(compile_formula(parse_formula(spec).formula), x, y, "x", "y")
    _close(got.axes[0].lines[0].get_xdata(), ref.axes[0].lines[0].get_xdata(), 1e-15)
    _close(got.axes[0].lines[0].get_ydata(), ref.axes[0].lines[0].get_ydata())
    assert got.axes[0].get_title() == ref.axes[0].get_title()


def test_plot_flags_write_pngs(tmp_path):
    """--plot on sample (1-D, and grouped with --plotx), mcmc and predict."""
    pytest.importorskip("matplotlib")
    base = ["--platform", "cpu"]
    data, chain = tmp_path / "d.tsv", tmp_path / "c.tsv"
    pngs = {k: tmp_path / f"{k}.png" for k in ("sample", "grouped", "mcmc", "predict")}
    assert main([*base, "sample", "y :~| SqExp(:x; l=1.5)", "--at",
                 "x = rand(Uniform(-5,5), 30)", "--seed", "1", "--output", str(data),
                 "--plot", str(pngs["sample"])]) == 0
    assert main([*base, "sample", "y :~| SqExp(:x; l=1.5) * Cat(:g)", "--at",
                 "x = rand(Uniform(-5,5), 12); g = 1:2", "--seed", "1", "--plotx", "x:g",
                 "--output", str(tmp_path / "g.tsv"), "--plot", str(pngs["grouped"])]) == 0
    assert main([*base, "mcmc", "y ~| SqExp(:x)", "--data", str(data), "--infer", "x",
                 "--samples", "6", "--warmup", "6", "--output", str(chain), "--plot",
                 str(pngs["mcmc"])]) == 0
    assert main([*base, "predict", "y ~| SqExp(:x)", "--data", str(data), "--mcmc", str(chain),
                 "--at", "x=-5:0.5:5", "--output", str(tmp_path / "p.tsv"), "--plot",
                 str(pngs["predict"])]) == 0
    for k, png in pngs.items():
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", k
