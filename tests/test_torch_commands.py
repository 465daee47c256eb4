"""The port's `sample`, `select` and `predict` against gaplac_tpu's, both on
the CPU in float64, on the same files: table columns and order equal, the
select log densities and Bayes factors and the predict columns to 1e-9
relative, and the sample draws as the same function (mean + L z) of the same
normal variates (the two RNGs differ).  One case runs at n >= 2048, where
the port's factorization takes the blocked route (kernel K3's plain
version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gaplac_tpu.cli import select_cmd as jselect
from gaplac_tpu.cli.main import build_parser as jax_parser
from gaplac_tpu.cli.main import main as jax_main
from gaplac_tpu.dsl import parse_formula as jax_parse
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu.ops import mvn as jmvn
from gaplac_tpu_torch.cli import sample_cmd, select_cmd
from gaplac_tpu_torch.cli.main import build_parser, main
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.ops import cholesky as TC
from gaplac_tpu_torch.ops import mvn
from gaplac_tpu_torch.runtime import Runtime

RTOL = 1e-9
CPU64 = Runtime(torch.device("cpu"), torch.float64)


def _close(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def _write_data(path, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, 5, n)
    K = np.exp(-(x[:, None] - x[None, :]) ** 2 / (2 * 1.5 ** 2)) + 0.1 * np.eye(n)
    y = np.linalg.cholesky(K + 1e-9 * np.eye(n)) @ rng.normal(size=n) + rng.normal(size=n)
    pd.DataFrame({"x": x, "y": y}).to_csv(path, sep="\t", index=False)


def _write_chain(path, draws, seed):
    rng = np.random.default_rng(seed)
    pd.DataFrame({"iteration": np.arange(1, draws + 1), "chain": np.ones(draws, int),
                  "ℓ": rng.uniform(1.0, 2.5, draws), "lp": rng.normal(-80, 3, draws)}
                 ).to_csv(path, sep="\t", index=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cmds")
    _write_data(d / "data.tsv", 40, 0)
    _write_chain(d / "chain1.tsv", 250, 1)  # more rows than MAX_CHAIN_DRAWS: thinned
    _write_chain(d / "chain2.tsv", 60, 2)
    return d


def _both(tmp, argv, name):
    """Run argv through both CLIs with --output; the two tables."""
    out = []
    for tag, fn in (("jax", jax_main), ("torch", main)):
        path = tmp / f"{name}_{tag}.tsv"
        assert fn(["--platform", "cpu", *argv, "--output", str(path)]) == 0
        out.append(pd.read_csv(path, sep="\t"))
    return out


@pytest.mark.parametrize("posterior", [False, True])
def test_sample_frame_matches_jax(files, posterior):
    argv = ["sample", "y :~| SqExp(:x; l=1.5)", "--at", "x = rand(Uniform(-5,5), 30)",
            "--seed", "3"]
    if posterior:
        argv = ["sample", "y ~| SqExp(:x)", "--at", "x=-5:0.5:5", "--seed", "3",
                "--data", str(files / "data.tsv"), "--mcmc", str(files / "chain1.tsv")]
    ref, got = _both(files, argv, f"sample{int(posterior)}")
    assert list(got.columns) == list(ref.columns) == ["x", "y"]
    np.testing.assert_array_equal(got["x"].to_numpy(), ref["x"].to_numpy())
    assert np.isfinite(got["y"]).all()


def test_sample_draws_are_mean_plus_L_z():
    """Prior and posterior draws: the port's mean and factor with
    gaplac_tpu's normal variates give gaplac_tpu's draw."""
    rng = np.random.default_rng(4)
    x, xt, y = rng.uniform(-5, 5, 40), np.linspace(-5, 5, 21), rng.normal(size=40)
    spec = "y ~| SqExp(:x; l=1.3)"
    jck, ck = jax_compile(jax_parse(spec).formula), compile_formula(parse_formula(spec).formula)
    jp, p = jck.default_params(jnp.float64), ck.default_params(torch.float64)
    key = jax.random.key(5)

    K = jck.gram(jp, jnp.asarray(x[:, None]))
    z = np.asarray(jax.random.normal(key, (40,), jnp.float64))
    L = mvn.chol(ck.gram(p, torch.as_tensor(x[:, None])), 0.1)
    _close(L.numpy() @ z, jmvn.sample_mvn(key, K, jitter=0.1))

    jX, jXt = jnp.asarray(x[:, None]), jnp.asarray(xt[:, None])
    jpost = jmvn.gp_posterior_cache(jck.gram(jp, jX) + 0.1 * jnp.eye(40), jnp.asarray(y), 1.0)
    jmu = jmvn.gp_predict_mean(jpost, jck.gram(jp, jXt, jX))
    jcov = jmvn.gp_predict_cov(jpost, jck.gram(jp, jXt, jX), jck.gram(jp, jXt))
    mu, cov = sample_cmd.posterior_at(ck, p, torch.as_tensor(x[:, None]),
                                      torch.as_tensor(xt[:, None]), torch.as_tensor(y), 0.1, 1.0)
    _close(mu, jmu)
    _close(cov, jcov)
    zt = np.asarray(jax.random.normal(key, (21,), jnp.float64))
    Lt = mvn.chol(cov, 0.1)
    _close(mu.numpy() + Lt.numpy() @ zt, jmvn.sample_mvn(key, jcov, mean=jmu, jitter=0.1))

    # and the port's own draw is mean + L z of its generator's variates
    zg = torch.randn(21, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    draw = mvn.sample_mvn_chol(torch.Generator().manual_seed(7), Lt, mean=mu)
    _close(draw, mu + Lt @ zg)


def _select_both(argv):
    jb = jselect.run(jax_parser().parse_args(["--platform", "cpu", *argv]))
    tb = select_cmd.run(build_parser().parse_args(["--platform", "cpu", *argv]), CPU64)
    return jb, tb


def test_select_chains_matches_jax(files):
    jb, tb = _select_both(["select", "--chains", str(files / "chain1.tsv"),
                           str(files / "chain2.tsv")])
    _close(tb, jb)
    lp = pd.read_csv(files / "chain1.tsv", sep="\t")["lp"].to_numpy()
    _close(select_cmd.log2_harmonic_mean(lp), jselect.log2_harmonic_mean(lp))


def _fixed_lps(formulae, data):
    """(port, gaplac_tpu) fixed-hyperparameter log densities of each formula."""
    df = pd.read_csv(data, sep="\t")
    out = []
    for f in formulae:
        jck = jax_compile(jax_parse(f).formula)
        K = jck.gram(jck.default_params(jnp.float64), jnp.asarray(df[["x"]].to_numpy()))
        ref = float(jmvn.mvn_logpdf(K, jnp.asarray(df["y"].to_numpy()), jitter=0.1))
        out.append((select_cmd.fixed_lp(parse_formula(f), df, 0.1, CPU64), ref))
    return out


def test_select_formulae_matches_jax(files):
    formulae = ["y ~| SqExp(:x)", "y ~| OU(:x; l=2.0) + Noise"]
    data = files / "data.tsv"
    jb, tb = _select_both(["select", "--formulae", *formulae, "--data", str(data)])
    _close(tb, jb)
    for got, ref in _fixed_lps(formulae, data):
        _close(got, ref)


@pytest.mark.parametrize("with_chain", [False, True])
def test_predict_matches_jax(files, with_chain):
    argv = ["predict", "y ~| SqExp(:x)", "--data", str(files / "data.tsv"), "--at",
            "x=-6:0.25:6"]
    if with_chain:
        argv += ["--mcmc", str(files / "chain1.tsv")]
    ref, got = _both(files, argv, f"predict{int(with_chain)}")
    assert list(got.columns) == list(ref.columns) == ["x", "ymu", "yQ050", "yQ950"]
    for col in ("x", "ymu", "yQ050", "yQ950"):
        _close(got[col], ref[col])


def test_slice_at_the_blocked_route_matches_jax(tmp_path, monkeypatch):
    """select --formulae and predict on 2100 rows: the port factors through
    the blocked route (K3's plain version), gaplac_tpu through LAPACK."""
    tiles = []
    tile = TC.chol_tile
    monkeypatch.setattr(TC, "chol_tile", lambda A, L: tiles.append(A.shape) or tile(A, L))
    data = tmp_path / "big.tsv"
    _write_data(data, 2100, 6)
    _write_chain(tmp_path / "chain.tsv", 2, 7)
    formulae = ["y ~| SqExp(:x)", "y ~| OU(:x)"]
    jb, tb = _select_both(["select", "--formulae", *formulae, "--data", str(data)])
    _close(tb, jb)
    assert len(tiles) == 2 * 17  # 2100 rows pad to 17 tiles of 128, once per formula
    ref, got = _both(tmp_path, ["predict", "y ~| SqExp(:x)", "--data", str(data), "--at",
                                "x=-5:0.5:5", "--mcmc", str(tmp_path / "chain.tsv")], "big")
    for col in ("ymu", "yQ050", "yQ950"):
        _close(got[col], ref[col])
    assert len(tiles) == 4 * 17


def test_guide_select_formulae_oracle_through_the_port(tmp_path, capsys):
    """tests/test_guide_parity.py's select --formulae oracle: the guide's data
    (gaplac_tpu's sample at seed 4), SqExp vs OU at l=1.5; the Bayes factor
    lies in the 5-seed band [4.0, 11.3] and equals gaplac_tpu's."""
    data = tmp_path / "data.tsv"
    assert jax_main(["--platform", "cpu", "sample", "y :~| SqExp(:x; l=1.5)", "--at",
                     "x = rand(Uniform(-5,5), 50)", "--seed", "4", "--output", str(data)]) == 0
    argv = ["select", "--formulae", "y ~| SqExp(:x, l=1.5)", "y ~| OU(:x, l=1.5)", "--data",
            str(data)]
    assert main(["--platform", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert float(out.split("**Log2 Bayes**:")[1].splitlines()[0]) > 0
    jb, tb = _select_both(argv)
    assert 4.0 <= tb <= 11.3, tb
    _close(tb, jb)


# ---------------------------------------------------------------------------
# the samplers and estimators of the dense model: hmc (whole and in
# segments), advi, --approx laplace and select --estimator smc
# ---------------------------------------------------------------------------


def _write_bernoulli(path, n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-3, 3, n))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-2 * np.sin(1.5 * x)))).astype(int)
    pd.DataFrame({"x": x, "y": y}).to_csv(path, sep="\t", index=False)


def _mcmc_table(fn, tmp, name, argv, capsys):
    """One mcmc run through ``fn`` (either CLI): its table and stdout."""
    path = tmp / f"{name}.tsv"
    assert fn(["--platform", "cpu", "mcmc", *argv, "--output", str(path)]) == 0
    return pd.read_csv(path, sep="\t"), capsys.readouterr().out


def test_mcmc_laplace_hmc_schema_matches_jax(tmp_path, capsys):
    """--approx laplace with --sampler hmc, two chains of five draws, through
    both CLIs: the same columns in the same order and the same report
    lines; and the port's --segments run writes the unsegmented table byte
    for byte, with its checkpoint loadable by gaplac_tpu."""
    from gaplac_tpu.cli import mcmc_cmd as jax_mcmc

    data = tmp_path / "bern.tsv"
    _write_bernoulli(data, 14, 3)
    argv = ["y : Bernoulli ~| SqExp(:x)", "--data", str(data), "--infer", "x", "--approx",
            "laplace", "--sampler", "hmc", "--leapfrogs", "3", "--chains", "2", "--samples",
            "5", "--warmup", "4"]
    ref, ref_out = _mcmc_table(jax_main, tmp_path, "jax", argv, capsys)
    got, got_out = _mcmc_table(main, tmp_path, "torch", argv, capsys)
    fx = [f"fx[{i + 1}]" for i in range(14)]
    assert list(got.columns) == list(ref.columns) == (["iteration", "chain", "ℓ"] + fx
                                                      + ["lp", "acceptance_rate", "step_size"])
    assert len(got) == len(ref) == 10 and np.isfinite(got.to_numpy(float)).all()
    assert [s.split(":")[0] for s in got_out.splitlines()] == \
        [s.split(":")[0] for s in ref_out.splitlines()] == ["posterior ℓ"]

    ckpt = tmp_path / "seg_ckpt"
    seg, _ = _mcmc_table(main, tmp_path, "torch_seg", argv + ["--segments", "2", "--checkpoint",
                                                               str(ckpt)], capsys)
    assert (tmp_path / "torch_seg.tsv").read_bytes() == (tmp_path / "torch.tsv").read_bytes()
    back = jax_mcmc._load_checkpoint(str(ckpt), 2, 1)
    assert back["positions"].shape == (2, 1) and "traj_length" not in back


def test_mcmc_advi_schema_and_report(tmp_path, capsys):
    """--sampler advi: gaplac_tpu's columns (no sampler statistics), its
    report line, and the warning that --checkpoint is ignored."""
    from gaplac_tpu.cli import mcmc_cmd as jax_mcmc

    data = tmp_path / "data.tsv"
    _write_data(data, 12, 1)
    ckpt = tmp_path / "never"
    got, out = _mcmc_table(main, tmp_path, "advi", ["y ~| SqExp(:x)", "--data", str(data),
                                                     "--infer", "x", "--sampler", "advi",
                                                     "--vi-steps", "30", "--chains", "2",
                                                     "--samples", "5", "--checkpoint",
                                                     str(ckpt)], capsys)
    rng = np.random.default_rng(0)
    args = type("A", (), {"output": str(tmp_path / "ref.tsv"), "no_latents": False,
                          "plot": None})()
    jax_mcmc._emit_chains(args, type("M", (), {"n_hyper": 1})(), 12,
                          rng.uniform(1, 2, (2, 5, 1)), rng.normal(size=(2, 5, 12)),
                          rng.normal(size=(2, 5)))
    capsys.readouterr()
    assert list(got.columns) == list(pd.read_csv(args.output, sep="\t").columns)
    assert len(got) == 10 and np.isfinite(got.to_numpy(float)).all()
    assert out.splitlines()[0].startswith("ADVI converged: final ELBO ")
    assert not list(tmp_path.glob("never*"))


def test_select_smc_report_matches_jax(tmp_path, capsys):
    """select --estimator smc: the report's lines as gaplac_tpu's, and both
    evidences within Monte-Carlo error of gaplac_tpu's."""
    data = tmp_path / "data.tsv"
    _write_data(data, 30, 2)
    argv = ["--platform", "cpu", "select", "--estimator", "smc", "--formulae", "y ~| SqExp(:x)",
            "y ~| OU(:x)", "--data", str(data), "--particles", "256"]
    outs = []
    for fn in (jax_main, main):
        assert fn(argv) == 0
        outs.append(capsys.readouterr().out)
    ref, got = (select_lps(o) for o in outs)
    assert [s.split(":")[0] for s in outs[1].splitlines()] == \
        [s.split(":")[0] for s in outs[0].splitlines()]
    np.testing.assert_allclose(got, ref, atol=0.3)


def test_mcmc_chees_rff_table_matches_jax(tmp_path):
    """--approx rff: 8 lockstep ChEES chains on the low-rank marginal,
    --no-latents, through both CLIs: the chain table's columns are
    gaplac_tpu's (tests/test_lowrank.py::test_cli_mcmc_chees_rff_composes)."""
    rng = np.random.default_rng(9)
    data = tmp_path / "d.tsv"
    x = rng.uniform(-5, 5, 40)
    pd.DataFrame({"x": x, "y": np.sin(x)}).to_csv(data, sep="\t", index=False)
    tables = []
    for tag, fn in (("jax", jax_main), ("torch", main)):
        path = tmp_path / f"chees_{tag}.tsv"
        assert fn(["--platform", "cpu", "mcmc", "y ~| SqExp(:x)", "--data", str(data), "--infer",
                   "x", "--samples", "5", "--warmup", "10", "--sampler", "chees", "--chains",
                   "8", "--no-latents", "--approx", "rff", "--rff-features", "24",
                   "--output", str(path)]) == 0
        tables.append(pd.read_csv(path, sep="\t"))
    ref, got = tables
    assert list(got.columns) == list(ref.columns) == [
        "iteration", "chain", "ℓ", "lp", "acceptance_rate", "step_size", "traj_length"]
    assert got["chain"].nunique() == 8 and len(got) == len(ref) == 40
    assert np.isfinite(got.to_numpy(float)).all()


def test_mcmc_rff_hmc_segments_and_advi(tmp_path, capsys):
    """--approx rff composes with --sampler hmc (the --segments run writes
    the whole run's table byte for byte) and --sampler advi."""
    rng = np.random.default_rng(10)
    data = tmp_path / "d.tsv"
    x = rng.uniform(-5, 5, 30)
    pd.DataFrame({"x": x, "y": np.sin(x) + 0.3 * rng.normal(size=30)}).to_csv(
        data, sep="\t", index=False)
    argv = ["y ~| SqExp(:x)", "--data", str(data), "--infer", "x", "--no-latents", "--approx",
            "rff", "--rff-features", "16", "--chains", "2", "--samples", "4"]
    hmc = ["--sampler", "hmc", "--leapfrogs", "3", "--warmup", "4"]
    whole, _ = _mcmc_table(main, tmp_path, "hmc", argv + hmc, capsys)
    seg, _ = _mcmc_table(main, tmp_path, "hmc_seg", argv + hmc + ["--segments", "2"], capsys)
    assert (tmp_path / "hmc_seg.tsv").read_bytes() == (tmp_path / "hmc.tsv").read_bytes()
    assert list(whole.columns) == ["iteration", "chain", "ℓ", "lp", "acceptance_rate",
                                   "step_size"]
    advi, out = _mcmc_table(main, tmp_path, "advi", argv + ["--sampler", "advi", "--vi-steps",
                                                             "20"], capsys)
    assert list(advi.columns) == ["iteration", "chain", "ℓ", "lp"] and len(advi) == 8
    assert np.isfinite(advi.to_numpy(float)).all() and out.startswith("ADVI converged")


def select_lps(report):
    return (float(report.split("model 1:")[1].splitlines()[0]),
            float(report.split("model 2:")[1].splitlines()[0]))
