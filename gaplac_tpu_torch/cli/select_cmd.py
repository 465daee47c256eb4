"""`select` command: model comparison by log2 Bayes factors (port of
``gaplac_tpu/cli/select_cmd.py``).

--chains: each model's marginal likelihood is the harmonic mean of 2^lp over
its chain's ``lp`` (or legacy ``lπ``) column, in log space.
--formulae: the fixed-hyperparameter log density log N(y; 0, K + jitter I)
of each formula on --data (complete cases), through the dense factorization
(kernel K3's blocked route at n >= 2048); with ``--estimator smc``, a
tempered-SMC marginal likelihood over the Uniform(0, 20) prior of the
formula's hyperparameters (``inference/smc.py``; the particles' log
likelihoods are one batched call through K2 and K1).  With ``--approx rff``
both take the low-rank feature-space density log N(y; 0, Phi Phi^T + D)
(``ops/lowrank.py``: the capacitance matrices through K1, or K3's blocked
route for one of m_total >= 2048); with ``--approx sde`` the state-space
density by parallel Kalman filtering (``ops/markov.py``,
``ops/markov_ss.py``), whose SMC particles go in chunks sized for their
(B, n, d, d) scans.  ``--approx auto`` is resolved for each formula on its
own (``inference/routing.py``).  Positive values favour model 1.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from scipy.special import logsumexp

from gaplac_tpu_torch.cli.common import design_matrix, response_vector
from gaplac_tpu_torch.data import complete_cases, load_tables, read_table
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.kernels.covariance import LENGTHSCALE_KINDS, compile_formula
from gaplac_tpu_torch.inference.model import markov_data
from gaplac_tpu_torch.inference.routing import choose_approx
from gaplac_tpu_torch.kernels.features import build_feature_map
from gaplac_tpu_torch.ops import lowrank, markov, mvn
from gaplac_tpu_torch.ops import markov_ss as mss
from gaplac_tpu_torch.parallel.multihost import is_primary
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


def _formula_data(spec, df, rt: Runtime):
    """The compiled formula, its input matrix and the response on df."""
    device, dtype = rt
    ck = compile_formula(spec.formula)
    y = torch.tensor(response_vector(df, spec), dtype=dtype, device=device)
    X = torch.tensor(design_matrix(df, ck), dtype=dtype, device=device)
    return ck, X, y


def fixed_lp(spec, df, jitter: float, rt: Runtime) -> float:
    """log N(y; 0, K(default params) + jitter I) of one formula on df."""
    ck, X, y = _formula_data(spec, df, rt)
    K = ck.gram(ck.default_params(rt.dtype, rt.device), X, diag=jitter)
    return float(mvn.mvn_logpdf_chol(mvn.chol(K), y))


def lowrank_fixed_lp(args, spec, df, rt: Runtime) -> float:
    """log N(y; 0, Phi Phi^T + (jitter + bare Noise) I) of one formula on df
    at its default parameters, through the feature map (--approx rff)."""
    ck, X, y = _formula_data(spec, df, rt)
    fm = build_feature_map(ck, [X], num_features=args.rff_features, seed=args.rff_seed)
    p = ck.default_params(rt.dtype, rt.device)
    return float(lowrank.lowrank_logpdf(fm.phi(p, X), fm.noise_diag(p, X) + args.jitter, y))


def markov_fixed_lp(spec, df, jitter: float, rt: Runtime) -> float:
    """log N(y; 0, K + (jitter + Noise) I) of one formula on df at its
    default parameters, by Kalman filtering (--approx sde), O(n log n)."""
    ck, X, y = _formula_data(spec, df, rt)
    p = ck.default_params(rt.dtype, rt.device)
    md = markov_data(ck, X)
    ys, j_eff = y[md.idx], md.j_eff(p, jitter)
    if md.st.scalar_ou:
        return float(markov.ou_loglik(md.ts, ys, p[md.st.blocks[0][1]], j_eff))
    A, Q, H = md.steps(ck, p)
    return float(mss.ss_loglik(A, Q, H, ys, j_eff))


def _approx_for(args, spec, df, rt: Runtime) -> str:
    """--approx, with auto resolved for this formula on its own (the two
    compared formulas may take different paths)."""
    if args.approx != "auto":
        return args.approx
    ck, X, _ = _formula_data(spec, df, rt)
    return choose_approx(ck, X.cpu().numpy(), "select", likelihood=spec.likelihood)


def formula_lp(args, spec, df, rt: Runtime) -> float:
    """The fixed-hyperparameter log density of one formula on df by the
    path --approx names."""
    approx = _approx_for(args, spec, df, rt)
    if approx == "rff":
        return lowrank_fixed_lp(args, spec, df, rt)
    if approx == "sde":
        return markov_fixed_lp(spec, df, args.jitter, rt)
    return fixed_lp(spec, df, args.jitter, rt)


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
        if not args.data:
            raise ValueError("'select --formulae' requires '--data'")
        spec1, spec2 = parse_formula(formulae[0]), parse_formula(formulae[1])
        df = complete_cases(load_tables(args.data))
        if args.estimator == "smc":
            lp1, lp2 = smc_evidence(args, spec1, df, rt), smc_evidence(args, spec2, df, rt)
        else:
            lp1, lp2 = formula_lp(args, spec1, df, rt), formula_lp(args, spec2, df, rt)
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
    if is_primary():  # rank 0 of a multi-process run prints
        print(report)
    return bayes


def smc_evidence(args, spec, df, rt: Runtime) -> float:
    """Tempered-SMC log marginal likelihood of one formula, integrating the
    Uniform(0, 20) prior of its --infer (default: every lengthscale-kind
    leaf, shared) and --infer-extra hyperparameters; on the dense model, the
    low-rank one (rff) or the state-space one (sde)."""
    from gaplac_tpu_torch.inference.model import build_model
    from gaplac_tpu_torch.inference.smc import smc_log_evidence_gp

    ck, X, y = _formula_data(spec, df, rt)
    if args.infer:
        inferable = list(args.infer)
    else:
        inferable = [v for v, k in zip(ck.leaf_vars, ck.kinds) if v and k in LENGTHSCALE_KINDS]
    # --infer-extra only where this formula has a shape parameter on the
    # variable (the two compared formulas may differ)
    infer_extras = [v for v in (args.infer_extra or [])
                    if any(lv == v and es for lv, es in zip(ck.leaf_vars, ck.extra_slots))]
    if not inferable and not infer_extras:
        lp = fixed_lp(spec, df, args.jitter, rt)
        log.info("SMC: %s has no inferable hyperparameter; fixed logpdf %.4f", spec.formula, lp)
        return lp
    approx = _approx_for(args, spec, df, rt)
    model = build_model(ck, inferable, X, y, spec.likelihood, jitter=args.jitter,
                        approx=approx if approx in ("rff", "sde") else "exact",
                        rff_features=args.rff_features, rff_seed=args.rff_seed,
                        infer_extras=infer_extras)
    gen = torch.Generator(device=rt.device).manual_seed(args.seed)
    res = smc_log_evidence_gp(gen, model, y, model.report_batch,
                              n_particles=args.particles)
    name = f"{spec.response} ~| {spec.formula}"
    if res.final_beta < 1.0:
        log.warning(
            "SMC for %s stopped at inverse temperature beta=%.4f < 1 "
            "(max stages reached): the reported evidence is for a partially "
            "tempered target and will bias the Bayes factor — rerun with "
            "more particles (--particles) for a tighter tempering schedule",
            name, res.final_beta,
        )
    log.info("SMC evidence for %s: %.4f (%d stages, %d particles)", name, res.log_evidence,
             res.n_stages, args.particles)
    return res.log_evidence
