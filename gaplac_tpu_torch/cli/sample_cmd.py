"""`sample` command: draw from the GP prior, or from the posterior given
``--data``, at the ``--at``/``--atdata`` points (port of
``gaplac_tpu/cli/sample_cmd.py``).

The prior draw factors the gram of the sampled points (kernel K2, then the
blocked factorization through kernel K3 at n >= 2048, else kernel K1); the
posterior draw conditions on ``--data``, with the hyperparameters of one
random ``--mcmc`` chain row.  With ``--approx rff`` no gram is formed: the
prior draw is Phi w + sqrt(d) eta, the posterior draw Matheron's rule through
the feature map, whose Cat vocabularies span both tables (``ops/lowrank.py``,
one m x m factorization).  With ``--approx sde`` neither forms a gram: the
prior draw runs the Gauss-Markov recurrence as an associative scan
(``ops/markov_ss.py``), the posterior draw is Matheron's rule through the
state-space smoother of the joined train and test rows, the test rows
unobserved.  ``--approx auto`` routes by ``inference/routing.py`` on the
rows the draw covers.  torch's generator gives other numbers than
``jax.random`` for the same ``--seed``; the draw is the same function of
its normal variates.  ``--plot`` draws the samples (``viz/plots.py``).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from gaplac_tpu_torch.cli.common import (
    apply_outlier_policy,
    chain_slot_groups,
    design_matrices,
    design_matrix,
    response_vector,
)
from gaplac_tpu_torch.data import complete_cases, df_output, load_tables
from gaplac_tpu_torch.dsl import build_at_frame, parse_formula
from gaplac_tpu_torch.inference.likelihoods import gaussian_obs_sigma2
from gaplac_tpu_torch.inference.model import markov_data
from gaplac_tpu_torch.inference.routing import resolve_auto_approx
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.kernels.features import build_feature_map
from gaplac_tpu_torch.ops import lowrank, mvn
from gaplac_tpu_torch.ops import markov_ss as mss
from gaplac_tpu_torch.parallel.multihost import is_primary
from gaplac_tpu_torch.runtime import Runtime

log = logging.getLogger("gaplac")


def run(args, rt: Runtime) -> None:
    log.info("running 'sample'")
    spec = parse_formula(args.spec)
    ck = compile_formula(spec.formula)
    if args.atdata:
        df = complete_cases(load_tables(args.atdata))
    elif args.at:
        df = build_at_frame(args.at, formula=spec.formula, seed=args.seed)
    else:
        raise ValueError("'sample' requires either '--at' or '--atdata'")

    device, dtype = rt
    seed = args.seed if args.seed is not None else int(np.random.SeedSequence().entropy % (2**63))
    gen = torch.Generator(device=device).manual_seed(seed)
    params = ck.default_params(dtype, device)
    if args.data:
        y = _sample_posterior(args, spec, ck, df, params, gen, rt)
    else:
        X_np = design_matrix(df, ck)
        resolve_auto_approx(args, ck, X_np, "sample", spec)
        X = torch.tensor(X_np, dtype=dtype, device=device)
        if args.approx == "sde":  # the recurrence as a scan, O(n log n)
            y = _sde_prior_draw(ck, X, params, gen, args.jitter)
        elif args.approx == "rff":  # f = Phi w + sqrt(jitter + bare Noise) eta, O(n m)
            fm = _feature_map(args, ck, [X])
            y = lowrank.sample_lowrank(gen, fm.phi(params, X),
                                       fm.noise_diag(params, X) + args.jitter)
        else:
            K = ck.gram(params, X, diag=args.jitter)  # K + jitter I
            y = mvn.sample_mvn_chol(gen, mvn.chol(K))
    df[spec.response] = y.cpu().numpy()
    if not is_primary():  # rank 0 of a multi-process run writes
        return
    df_output(df, args.output)
    if args.plot:
        _plot(args, spec, ck, df, rt)


def posterior_at(ck, params, X, Xt, y, jitter: float, sigma2: float):
    """Mean and covariance of the latent GP at Xt given (X, y): the prior
    K + jitter I, observed with variance sigma2."""
    K_xx = ck.gram(params, X, diag=jitter)
    K_tx = ck.gram(params, Xt, X)
    K_tt = ck.gram(params, Xt)
    post = mvn.gp_posterior_cache(K_xx, y, sigma2)
    return mvn.gp_predict_mean(post, K_tx), mvn.gp_predict_cov(post, K_tx, K_tt)


def _sample_posterior(args, spec, ck, tdf, params, gen, rt: Runtime) -> torch.Tensor:
    """A posterior draw at the test points, conditioned on --data, with the
    hyperparameters of a random --mcmc chain row."""
    from gaplac_tpu_torch.cli.predict_cmd import _hyper_draws

    device, dtype = rt
    df = apply_outlier_policy(complete_cases(load_tables(args.data)), args, spec.response)
    y = torch.tensor(response_vector(df, spec), dtype=dtype, device=device)
    X_np, Xt_np = design_matrices(df, tdf, ck)
    X = torch.tensor(X_np, dtype=dtype, device=device)
    Xt = torch.tensor(Xt_np, dtype=dtype, device=device)
    # routed on the joined rows, which the conditional draw smooths over
    resolve_auto_approx(args, ck, np.vstack([X_np, Xt_np]), "sample", spec)

    dynamic_slots = ()
    if args.mcmc:
        slot_groups = chain_slot_groups(ck, args)
        dynamic_slots = {s for g in slot_groups for s in g}
        draws = _hyper_draws(args.mcmc, n_hyper=len(slot_groups))
        row = int(torch.randint(len(draws), (1,), generator=gen, device=device))
        theta = draws[row]
        log.info("Using hyperparameters from chain row %d: %s", row, theta)
        for g, slots in enumerate(slot_groups):
            params = ck.set_params(params, slots, float(theta[g]))

    sigma2 = gaussian_obs_sigma2(spec.likelihood)
    if sigma2 is None:
        log.warning("non-Gaussian likelihood %s treated as Gaussian(1) for posterior "
                    "sampling", spec.likelihood.name)
        sigma2 = 1.0
    if args.approx == "rff":
        fm = _feature_map(args, ck, [X, Xt])
        return lowrank.lowrank_conditional_sample_at(
            gen, fm.phi(params, X), fm.noise_diag(params, X) + args.jitter, sigma2, y,
            fm.phi(params, Xt), fm.noise_diag(params, Xt) + args.jitter)
    if args.approx == "sde":
        return _sde_posterior_draw(ck, X, Xt, y, params, gen, args.jitter, sigma2, dynamic_slots)
    mu, cov = posterior_at(ck, params, X, Xt, y, args.jitter, sigma2)
    return mvn.sample_mvn(gen, cov, mean=mu, jitter=args.jitter)


def _sde_prior_draw(ck, X, params, gen, jitter: float) -> torch.Tensor:
    """Exact state-space prior draw f = H x* + sqrt(j_eff) z, x* the
    Gauss-Markov recurrence as an associative scan: O(n log n), no gram.
    ``params`` (..., n_params) with leading dimensions gives a draw each."""
    md = markov_data(ck, X)
    A, Q, H = md.steps(ck, params)
    path = mss.measure_row(H, mss.ss_prior_sample(gen, A, Q))
    f = path + torch.sqrt(md.j_eff(params, jitter)) * torch.randn(
        path.shape, generator=gen, dtype=X.dtype, device=X.device)
    return f[..., md.inv_idx].to(X.dtype)


def _sde_posterior_draw(ck, X, Xt, y, params, gen, jitter: float, sigma2: float,
                        dynamic_slots=()) -> torch.Tensor:
    """Matheron's rule through the joined train and test rows:
    f_t = f*_t + K_tx (K + (j_eff + sigma2) I)^-1 (y - f*_x - eps*), f* a
    joint prior path and the solve the smoother with the test rows
    unobserved, O((n + m) log(n + m)), no gram.  ``params`` (...,
    n_params) with leading dimensions gives a draw each."""
    n = X.shape[0]
    md = markov_data(ck, X, dynamic_slots=dynamic_slots, rows=torch.cat([X, Xt]))
    A, Q, H = md.steps(ck, params)
    j_eff = md.j_eff(params, jitter)
    path = mss.measure_row(H, mss.ss_prior_sample(gen, A, Q))
    f_star = path + torch.sqrt(j_eff) * torch.randn(path.shape, generator=gen,
                                                    dtype=X.dtype, device=X.device)
    obs = md.idx < n
    y_sorted = torch.cat([y, y.new_zeros(Xt.shape[0])])[md.idx]
    eps = math.sqrt(sigma2) * torch.randn(path.shape, generator=gen, dtype=X.dtype,
                                          device=X.device)
    r = torch.where(obs, y_sorted - f_star - eps, 0.0)
    m_s, _ = mss.ss_smooth(A, Q, H, r, j_eff + sigma2, obs=obs)
    return (f_star + mss.measure_row(H, m_s))[..., md.inv_idx][..., n:].to(X.dtype)


def _feature_map(args, ck, mats):
    return build_feature_map(ck, mats, num_features=args.rff_features, seed=args.rff_seed)


def _plot(args, spec, ck, df, rt: Runtime) -> None:
    """--plot: the 1-D sample plot with its posterior refit, or with
    ``--plotx x:group`` (or several variables) the grouped scatter."""
    from gaplac_tpu_torch.viz.plots import grouped_sample_plot, pyplot, sample_plot

    group = None
    if args.plotx:
        xvar, _, group = args.plotx.partition(":")
        xvar = xvar.strip()
        group = group.strip() or None
        if xvar not in df.columns or (group and group not in df.columns):
            raise ValueError(f"--plotx names unknown column(s) in {args.plotx!r}")
    elif len(set(ck.varnames)) == 1:
        xvar = ck.varnames[0]
    else:
        log.warning(
            "Auto-generated sample plots not available for multivariable models, "
            "use `--plotx x[:group]` or `--output` to make a table and plot manually"
        )
        return
    log.info("Plotting output")
    if group or len(set(ck.varnames)) > 1:
        # grouped or multivariable: scatter and lines per group, no refit
        fig = grouped_sample_plot(
            df[xvar].values, df[spec.response].values, df[group].values if group else None,
            xlabel=xvar, ylabel=spec.response, grouplabel=group,
        )
    else:
        fig = sample_plot(ck, df[xvar].values, df[spec.response].values, xlabel=xvar,
                          ylabel=spec.response, device=rt.device, dtype=rt.dtype)
    fig.savefig(args.plot, dpi=120)
    pyplot().close(fig)
    log.info("Saved plot to %s", args.plot)
