"""`select` command: model comparison by log2 Bayes factors (port of
``gaplac_tpu/cli/select_cmd.py`` for ``--estimator harmonic`` and
``--approx none``).

--chains: each model's marginal likelihood is the harmonic mean of 2^lp over
its chain's ``lp`` (or legacy ``lπ``) column, in log space.
--formulae: the fixed-hyperparameter log density log N(y; 0, K + jitter I)
of each formula on --data (complete cases), through the dense factorization
(kernel K3's blocked route at n >= 2048).  Positive values favour model 1.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from scipy.special import logsumexp

from gaplac_tpu_torch.cli.common import design_matrix, refuse_unported, response_vector
from gaplac_tpu_torch.data import complete_cases, load_tables, read_table
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.ops import mvn
from gaplac_tpu_torch.runtime import Runtime

log = logging.getLogger("gaplac")

LP_COLUMNS = ("lp", "lπ")  # current schema + legacy fixture schema


def _read_lp(path: str) -> np.ndarray:
    df = read_table(path)
    for col in LP_COLUMNS:
        if col in df.columns:
            return df[col].to_numpy(dtype=float)
    raise ValueError(
        f"Chain file {path!r} has no log-posterior column "
        f"(looked for {', '.join(LP_COLUMNS)}; found {list(df.columns)})"
    )


def log2_harmonic_mean(lp: np.ndarray) -> float:
    """log2 of harmmean(2^lp), computed in log space."""
    ln2 = np.log(2.0)
    return float(np.log2(len(lp)) - logsumexp(-lp * ln2) / ln2)


def fixed_lp(spec, df, jitter: float, rt: Runtime) -> float:
    """log N(y; 0, K(default params) + jitter I) of one formula on df."""
    device, dtype = rt
    ck = compile_formula(spec.formula)
    y = torch.tensor(response_vector(df, spec), dtype=dtype, device=device)
    X = torch.tensor(design_matrix(df, ck), dtype=dtype, device=device)
    K = ck.gram(ck.default_params(dtype, device), X, diag=jitter)
    return float(mvn.mvn_logpdf_chol(mvn.chol(K), y))


def run(args, rt: Runtime) -> float:
    log.info("running 'select'")
    chains, formulae = args.chains, args.formulae
    if chains and formulae:
        raise ValueError(
            "'select' can only take one of '--formulae' or '--chains', not both"
        )
    if chains:
        if args.estimator == "smc":
            raise ValueError(
                "--estimator smc works with '--formulae' + '--data' (it "
                "re-estimates the marginal likelihood from the data; chain "
                "files alone are not sufficient)"
            )
        lp1 = log2_harmonic_mean(_read_lp(chains[0]))
        lp2 = log2_harmonic_mean(_read_lp(chains[1]))
    elif formulae:
        refuse_unported([("--estimator smc", args.estimator == "smc"),
                         (f"--approx {args.approx}", args.approx != "none")])
        if not args.data:
            raise ValueError("'select --formulae' requires '--data'")
        spec1, spec2 = parse_formula(formulae[0]), parse_formula(formulae[1])
        df = complete_cases(load_tables(args.data))
        lp1, lp2 = fixed_lp(spec1, df, args.jitter, rt), fixed_lp(spec2, df, args.jitter, rt)
    else:
        raise ValueError(
            "'select' command requires either '--chains' or '--formulae' arguments"
        )
    bayes = lp1 - lp2
    report = (
        f"**Log2 Bayes**: {round(bayes, 3)}\n\n"
        f"- **Log(pdf)** - model 1: {round(lp1, 4)}\n"
        f"- **Log(pdf)** - model 2: {round(lp2, 4)}\n\n"
        f"_Note_ - Positive values indicate more evidence for model 1"
    )
    log.info("\n%s", report)
    print(report)
    return bayes
