"""`mcmc --approx rff` with NUTS through the port's CLI, on the CPU in
float64: the twin of tests/test_lowrank.py::
test_cli_mcmc_rff_recovers_lengthscale (8-chain ChEES's twin is in
test_torch_commands.py)."""

import numpy as np
import pandas as pd
import torch

from gaplac_tpu_torch.cli.main import main
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.kernels.features import build_feature_map
from gaplac_tpu_torch.ops import lowrank


def test_mcmc_rff_nuts_recovers_quadrature(tmp_path):
    """tests/test_lowrank.py::test_cli_mcmc_rff_recovers_lengthscale: the NUTS
    mean of l within 4 sd/sqrt(50) of a quadrature of the same low-rank
    marginal (n = 50, m = 384, flat Uniform(0, 20) prior); 100 warmup
    transitions where the oracle takes 150, to keep the file short."""
    data, chain = tmp_path / "d.tsv", tmp_path / "chain.tsv"
    assert main(["--platform", "cpu", "sample", "y :~| SqExp(:x; l=1.5)", "--at",
                 "x = rand(Uniform(-5,5), 50)", "--seed", "3", "--output", str(data)]) == 0
    assert main(["--platform", "cpu", "mcmc", "y ~| SqExp(:x)", "--data", str(data), "--infer",
                 "x", "--samples", "150", "--warmup", "100", "--approx", "rff",
                 "--rff-features", "384", "--seed", "0", "--output", str(chain)]) == 0
    df = pd.read_csv(chain, sep="\t")
    assert np.isfinite(df["lp"]).all()

    tab = pd.read_csv(data, sep="\t")
    X = torch.tensor(tab[["x"]].to_numpy())
    ck = compile_formula(parse_formula("y ~| SqExp(:x)").formula)
    fm = build_feature_map(ck, [X], num_features=384, seed=0)
    grid = np.linspace(0.02, 19.98, 500)
    lls = lowrank.lowrank_logpdf(fm.phi(torch.as_tensor(grid[:, None]), X), 1.1,
                                 torch.tensor(tab["y"].to_numpy())).numpy()
    w = np.exp(lls - lls.max())
    quad_mean = float((grid * w).sum() / w.sum())
    quad_sd = float(np.sqrt((grid ** 2 * w).sum() / w.sum() - quad_mean ** 2))
    assert abs(df["ℓ"].mean() - quad_mean) < 4 * quad_sd / np.sqrt(50), (
        df["ℓ"].mean(), quad_mean, quad_sd)
