"""mcmc --check-numerics in the port against gaplac_tpu's jax_debug_nans: a
healthy run writes the table it writes without the flag and neither
package raises; a response with an inf cell (which the data path keeps)
makes every log density NaN, and both packages raise FloatingPointError
before any table is written."""

import jax
import numpy as np
import pandas as pd
import pytest

from gaplac_tpu.cli.main import main as jax_main
from gaplac_tpu_torch.cli.main import main

SAMPLERS = {"nuts": ["--max-depth", "3"], "hmc": ["--sampler", "hmc", "--leapfrogs", "8"]}


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("numerics")
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-5, 5, 30), rng.normal(size=30)
    healthy, bad = d / "healthy.tsv", d / "inf.tsv"
    pd.DataFrame({"x": x, "y": y}).to_csv(healthy, sep="\t", index=False)
    y[3] = np.inf
    pd.DataFrame({"x": x, "y": y}).to_csv(bad, sep="\t", index=False)
    return healthy, bad


def _argv(data, out, sampler, *flags):
    return ["--platform", "cpu", "mcmc", "y ~| SqExp(:x)", "--data", str(data), "--infer", "x",
            "--samples", "10", "--warmup", "10", "--seed", "3", "--output", str(out),
            *SAMPLERS[sampler], *flags]


def _jax_main(argv):
    try:
        return jax_main(argv)
    finally:  # gaplac_tpu's CLI sets jax_debug_nans and never clears it
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_healthy_table_is_the_same_with_the_flag(tables, tmp_path, sampler):
    healthy, _ = tables
    outs = [tmp_path / "plain.tsv", tmp_path / "checked.tsv"]
    assert main(_argv(healthy, outs[0], sampler)) == 0
    assert main(_argv(healthy, outs[1], sampler, "--check-numerics")) == 0
    assert outs[0].read_bytes() == outs[1].read_bytes()
    if sampler == "nuts":
        assert _jax_main(_argv(healthy, tmp_path / "jax.tsv", sampler, "--check-numerics")) == 0


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_nan_case_raises_in_both_packages(tables, tmp_path, sampler):
    _, bad = tables
    with pytest.raises(FloatingPointError):
        _jax_main(_argv(bad, tmp_path / "jax.tsv", sampler, "--check-numerics"))
    out = tmp_path / "port.tsv"
    with pytest.raises(FloatingPointError, match="sampler's log densities"):
        main(_argv(bad, out, sampler, "--check-numerics"))
    assert not out.exists()
    assert main(_argv(bad, out, sampler)) == 0  # without the flag the run completes
