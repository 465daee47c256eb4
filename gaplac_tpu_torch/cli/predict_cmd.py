"""`predict` command: posterior predictions at --at/--atdata points (port of
``gaplac_tpu/cli/predict_cmd.py``).

Output: the at-variables plus ``ymu`` (posterior mean of the latent GP) and
``yQ050``/``yQ950`` (its 5% and 95% quantiles; with --mcmc, of the
equal-weight Gaussian mixture over the chain's hyperparameter draws, found by
bisection on the mixture CDF).  The draws go through one at a time, so only
one draw's O(n^2) buffers are alive, as ``lax.map`` keeps it in
``gaplac_tpu``.  With ``--approx rff`` each draw is the weight-space
posterior through the feature map (O(n m^2), one m x m factorization),
whose Cat vocabularies span both tables.  With ``--approx sde`` the new
points join the sorted sequence unobserved and one state-space smoothing
pass gives their posterior, O((n + m) log(n + m)): in windows of
``--sde-window`` rows with ``--sde-overlap`` context rows (by default 2^14
rows when the state dimension passes 24 and the joined rows 2^15), whose
buffers bound the memory.  ``--approx auto`` routes by
``inference/routing.py`` on the joined rows.  ``--plot`` draws the
posterior ribbon (``viz/plots.py``).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from scipy.special import ndtr

from gaplac_tpu_torch.cli.common import (
    apply_outlier_policy,
    chain_slot_groups,
    design_matrices,
    resolve_hyper_columns,
    response_vector,
)
from gaplac_tpu_torch.data import complete_cases, df_output, load_tables, read_table
from gaplac_tpu_torch.dsl import build_at_frame, parse_formula
from gaplac_tpu_torch.inference.likelihoods import gaussian_obs_sigma2
from gaplac_tpu_torch.inference.model import markov_block_xs, markov_data, markov_param_vals
from gaplac_tpu_torch.inference.routing import resolve_auto_approx
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.kernels.features import build_feature_map
from gaplac_tpu_torch.ops import lowrank, markov, mvn
from gaplac_tpu_torch.ops import markov_ss as mss
from gaplac_tpu_torch.parallel.multihost import is_primary
from gaplac_tpu_torch.runtime import Runtime

log = logging.getLogger("gaplac")

MAX_CHAIN_DRAWS = 200  # thin chains beyond this for prediction
#: --sde-window's default, taken when the state dimension passes
#: SDE_WINDOW_MIN_D and the joined rows SDE_WINDOW_MIN_ROWS
SDE_WINDOW = 1 << 14
SDE_WINDOW_MIN_D = 24
SDE_WINDOW_MIN_ROWS = 1 << 15


def _hyper_draws(chain_path: str, n_hyper: int) -> np.ndarray:
    """(draws, n_hyper) hyperparameter draws from an mcmc chain table."""
    df = read_table(chain_path)
    names = resolve_hyper_columns(df, n_hyper, chain_path)
    draws = df[names].to_numpy(dtype=float)
    if len(draws) > MAX_CHAIN_DRAWS:
        idx = np.linspace(0, len(draws) - 1, MAX_CHAIN_DRAWS).astype(int)
        draws = draws[idx]
    return draws


def mixture_quantiles(mus: np.ndarray, sds: np.ndarray, qs=(0.05, 0.95)) -> np.ndarray:
    """Quantiles of an equal-weight Gaussian mixture, per column.

    mus/sds: (draws, points).  Returns (len(qs), points).
    """
    lo = (mus - 6 * sds).min(axis=0)
    hi = (mus + 6 * sds).max(axis=0)
    out = np.empty((len(qs), mus.shape[1]))
    for qi, q in enumerate(qs):
        a, b = lo.copy(), hi.copy()
        for _ in range(60):
            mid = 0.5 * (a + b)
            cdf = ndtr((mid[None, :] - mus) / sds).mean(axis=0)
            smaller = cdf < q
            a = np.where(smaller, mid, a)
            b = np.where(smaller, b, mid)
        out[qi] = 0.5 * (a + b)
    return out


def predict_one(ck, params, X, Xt, y, jitter: float, sigma2: float):
    """Latent posterior mean and variance at Xt for one parameter vector."""
    K_xx = ck.gram(params, X, diag=jitter)
    K_tx = ck.gram(params, Xt, X)
    k_tt = ck.gram_diag(params, Xt) + jitter
    post = mvn.gp_posterior_cache(K_xx, y, sigma2)
    mu = mvn.gp_predict_mean(post, K_tx)
    var = mvn.gp_predict_var(post, K_tx, k_tt)
    return mu, torch.clamp(var, min=1e-12)


def lowrank_predict_one(fm, params, X, Xt, y, jitter: float, sigma2: float):
    """predict_one through the feature map ``fm`` (--approx rff)."""
    d0 = fm.noise_diag(params, X) + jitter
    post = lowrank.lowrank_posterior(fm.phi(params, X), d0 + sigma2, y)
    phi_t = fm.phi(params, Xt)
    mu = lowrank.lowrank_predict_mean(post, phi_t)
    var = lowrank.lowrank_predict_var(post, phi_t, fm.noise_diag(params, Xt) + jitter)
    return mu, torch.clamp(var, min=1e-12)


def markov_predictor(args, ck, X, Xt, y, sigma2: float, dynamic_slots=()):
    """params -> (mean, variance) of the latent at Xt through the
    state-space smoother of the joined rows (--approx sde); the variance
    adds the jitter and Noise diagonal."""
    md = markov_data(ck, X, dynamic_slots=dynamic_slots, rows=torch.cat([X, Xt]))
    st = md.st
    n_joined = X.shape[0] + Xt.shape[0]
    window = args.sde_window
    if window is None:
        window = (SDE_WINDOW if md.state_dim > SDE_WINDOW_MIN_D and n_joined > SDE_WINDOW_MIN_ROWS
                  else 0)
        if window:
            log.info("state dim %d > %d at joined n=%d: windowed smoothing on (--sde-window "
                     "%d; 0 forces monolithic)", md.state_dim, SDE_WINDOW_MIN_D, n_joined, window)
    if st.time_col >= 0:
        t_train, t_new = X[:, st.time_col], Xt[:, st.time_col]
    else:  # no Markov leaf: the transitions do not depend on the step
        t_train = torch.arange(X.shape[0], dtype=X.dtype, device=X.device)
        t_new = X.shape[0] + torch.arange(Xt.shape[0], dtype=X.dtype, device=X.device)
    xs_train, xs_new = markov_block_xs(st, X), markov_block_xs(st, Xt)
    if st.scalar_ou:
        idx = torch.as_tensor(st.sort_idx, device=X.device)
        ts = torch.as_tensor(st.t_sorted, dtype=X.dtype, device=X.device)

    def one(p):
        j_eff = md.j_eff(p, args.jitter)
        if st.scalar_ou:
            mu, var_x = markov.ou_posterior_predict(ts, y[idx], p[st.blocks[0][1]],
                                                    j_eff + sigma2, t_new)
        else:
            mu, var_x = mss.ss_predict(md.kinds, markov_param_vals(ck, st, p), t_train, xs_train,
                                       y, j_eff + sigma2, t_new, xs_new, order=md.idx,
                                       resets=md.resets, window=window or None,
                                       overlap=args.sde_overlap)
        return mu.to(X.dtype), torch.clamp(var_x + j_eff, min=1e-12).to(X.dtype)

    return one


def run(args, rt: Runtime) -> None:
    log.info("running 'predict'")
    device, dtype = rt
    spec = parse_formula(args.formula)
    ck = compile_formula(spec.formula)
    df = apply_outlier_policy(complete_cases(load_tables(args.data)), args, spec.response)
    y = torch.tensor(response_vector(df, spec), dtype=dtype, device=device)
    if args.atdata:
        tdf = complete_cases(load_tables(args.atdata))
    elif args.at:
        tdf = build_at_frame(args.at, formula=spec.formula, seed=args.seed)
    else:
        raise ValueError("'predict' requires either '--at' or '--atdata'")
    # categorical codes must be consistent ACROSS the two tables
    X_np, Xt_np = design_matrices(df, tdf, ck)
    X = torch.tensor(X_np, dtype=dtype, device=device)
    Xt = torch.tensor(Xt_np, dtype=dtype, device=device)
    resolve_auto_approx(args, ck, np.vstack([X_np, Xt_np]), "predict", spec)

    sigma2 = gaussian_obs_sigma2(spec.likelihood)
    if sigma2 is None:
        log.warning("predict currently uses the Gaussian predictive equations; "
                    "non-Gaussian likelihood %s treated as Gaussian(1)", spec.likelihood.name)
        sigma2 = 1.0

    if args.mcmc:
        slot_groups = chain_slot_groups(ck, args)
        thetas = _hyper_draws(args.mcmc, n_hyper=len(slot_groups))
    else:
        thetas, slot_groups = np.zeros((1, 0)), ()

    if args.approx == "rff":
        fm = build_feature_map(ck, [X, Xt], num_features=args.rff_features, seed=args.rff_seed)
        one = lambda p: lowrank_predict_one(fm, p, X, Xt, y, args.jitter, sigma2)
    elif args.approx == "sde":
        one = markov_predictor(args, ck, X, Xt, y, sigma2,
                               dynamic_slots={s for g in slot_groups for s in g})
    else:
        one = lambda p: predict_one(ck, p, X, Xt, y, args.jitter, sigma2)
    defaults = ck.default_params(dtype, device)
    mus, variances = [], []
    for theta in thetas:
        p = defaults
        for g, slots in enumerate(slot_groups):
            p = ck.set_params(p, slots, float(theta[g]))
        mu, var = one(p)
        mus.append(mu)
        variances.append(var)
    mus = torch.stack(mus).cpu().numpy()
    sds = np.sqrt(torch.stack(variances).cpu().numpy())

    ymu = mus.mean(axis=0)
    q05, q95 = mixture_quantiles(mus, sds, (0.05, 0.95))
    out = tdf.copy()
    out["ymu"] = ymu
    out["yQ050"] = q05
    out["yQ950"] = q95
    if not is_primary():  # rank 0 of a multi-process run writes
        return
    df_output(out, args.output)

    if args.plot:
        from gaplac_tpu_torch.viz.plots import predict_plot, pyplot

        if not ck.varnames:
            raise ValueError("--plot needs a formula with at least one variable "
                             "(bare Noise/Constant has no x-axis)")
        xvar = ck.varnames[0]
        fig = predict_plot(
            tdf[xvar].values, ymu, q05, q95,
            data_x=df[xvar].values if xvar in df.columns else None,
            data_y=df[spec.response].values if spec.response in df.columns else None,
            xlabel=xvar, ylabel=spec.response,
        )
        fig.savefig(args.plot, dpi=120)
        pyplot().close(fig)
        log.info("Saved plot to %s", args.plot)
