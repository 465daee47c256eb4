"""`fitplot` command: the posterior of each additive component of the GP at
the training inputs (port of ``gaplac_tpu/cli/fitplot_cmd.py``).

For an additive kernel K = sum_t K_t with S = K + noise I, component t has

    mu_t  = K_t S^-1 y,
    var_t = diag(K_t) - diag(K_t S^-1 K_t),

computed through the dense factorization of S (the blocked route, kernel
K3, at n >= 2048) and each term's gram (kernel K2); with ``--approx rff``
through the feature map and the Woodbury factorization of S (one m_total x
m_total capacitance matrix: K1, or K3's blocked route from 2048 on); with
``--approx sde`` from one smoothing pass of the whole model, each block's
rows of the state posterior read off by its part of the measurement row.
``--approx auto`` routes by ``inference/routing.py``.
``component_posteriors``, ``lowrank_component_posteriors`` and
``markov_component_posteriors`` return the numbers and import no matplotlib;
``run`` draws one panel a component against its first variable, mean +- 2
sd.  With --mcmc, the hyperparameters are the chain's posterior means.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gaplac_tpu_torch.cli.common import (
    apply_outlier_policy,
    chain_slot_groups,
    column_values,
    design_matrix,
    response_vector,
)
from gaplac_tpu_torch.data import complete_cases, load_tables
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.inference.likelihoods import gaussian_obs_sigma2
from gaplac_tpu_torch.inference.model import markov_data
from gaplac_tpu_torch.inference.routing import resolve_auto_approx
from gaplac_tpu_torch.kernels.covariance import KIND_NAMES, CompiledKernel, compile_formula
from gaplac_tpu_torch.kernels.features import FeatureMap, build_feature_map
from gaplac_tpu_torch.ops import linalg, lowrank
from gaplac_tpu_torch.ops import markov_ss as mss
from gaplac_tpu_torch.parallel.multihost import is_primary
from gaplac_tpu_torch.runtime import Runtime

log = logging.getLogger("gaplac")


def term_gram(ck: CompiledKernel, term_idx: int, params: torch.Tensor, X1: torch.Tensor,
              X2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gram of a single additive term (the product of its leaves)."""
    sub = CompiledKernel(ck.varnames, ck.kinds, ck.cols, (ck.terms[term_idx],), ck.defaults,
                         ck.leaf_vars, ck.extras)
    return sub.gram(params, X1, X2)


def term_label(ck: CompiledKernel, term_idx: int) -> str:
    parts = []
    for li in ck.terms[term_idx]:
        v = ck.leaf_vars[li]
        parts.append(f"{KIND_NAMES[ck.kinds[li]]}({v})" if v else KIND_NAMES[ck.kinds[li]])
    return " * ".join(parts)


def wanted_terms(ck: CompiledKernel, component: Optional[str]) -> List[int]:
    """The terms ``--component`` keeps: those on any of its ;-separated
    variables (every term without it)."""
    if not component:
        return list(range(len(ck.terms)))
    wanted = {v.strip() for v in component.split(";") if v.strip()}
    return [t for t, term in enumerate(ck.terms)
            if {ck.leaf_vars[li] for li in term if ck.leaf_vars[li]} & wanted]


def component_posteriors(ck: CompiledKernel, params: torch.Tensor, X: torch.Tensor,
                         y: torch.Tensor, noise: float,
                         terms: Sequence[int]) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """(t, posterior mean, posterior sd) at the inputs of each additive
    component t in ``terms``, as numpy arrays."""
    L = linalg.cholesky(ck.gram(params, X, diag=noise))
    alpha = linalg.solve_triangular(L.mT, linalg.solve_triangular(L, y, lower=True),
                                    lower=False)
    out = []
    for t in terms:
        Kt = term_gram(ck, t, params, X)
        mu_t = Kt @ alpha
        V = linalg.solve_triangular(L, Kt, lower=True)
        var_t = torch.diagonal(Kt) - torch.sum(V * V, dim=0)
        out.append((t, mu_t.cpu().numpy(), np.sqrt(np.maximum(var_t.cpu().numpy(), 0.0))))
        del Kt, V
    return out


def lowrank_component_posteriors(fm: FeatureMap, params: torch.Tensor, X: torch.Tensor,
                                 y: torch.Tensor, noise: float,
                                 terms: Sequence[int]) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """component_posteriors through the feature map ``fm`` (--approx rff).

    With K = Phi Phi^T + diag(noise_diag) and S = K + noise I, component t is
    a feature block s (K_t = Phi_s Phi_s^T) or a bare-Noise diagonal term
    (K_t = diag(d_t)); mu_t and var_t reduce to O(n m |s|) products by
    Woodbury, and no n x n matrix is formed."""
    phi = fm.phi(params, X)
    lr = lowrank.lowrank_chol(phi, noise + fm.noise_diag(params, X))
    alpha = lowrank.lowrank_solve(lr, y)  # S^-1 y
    out = []
    for t in terms:
        sl = fm.term_slices[t]
        if sl is None:  # K_t = diag(d_t)
            d_t = fm.term_diag(params, X, fm.ck.terms[t])
            # diag(S^-1) = 1/D - rowsum(U^2), U = (D^-1 Phi) R^-T
            U = linalg.solve_triangular(lr.R, lr.phi_over_d.mT, lower=True).mT
            s_inv_diag = 1.0 / lr.d - torch.sum(U * U, dim=1)
            mu_t, var_t = d_t * alpha, d_t - d_t * d_t * s_inv_diag
        else:
            phi_s = phi[:, sl[0]:sl[1]]
            mu_t = phi_s @ lowrank.rows_matmul(phi_s, alpha[:, None])[:, 0]
            B = lowrank.rows_matmul(phi_s, lowrank.lowrank_solve(lr, phi_s))  # (|s|, |s|)
            var_t = torch.sum(phi_s * phi_s, dim=1) - torch.sum((phi_s @ B) * phi_s, dim=1)
        out.append((t, mu_t.cpu().numpy(), np.sqrt(np.maximum(var_t.cpu().numpy(), 0.0))))
    return out


def markov_component_posteriors(ck: CompiledKernel, params: torch.Tensor, X: torch.Tensor,
                                y: torch.Tensor, noise: float, terms: Sequence[int],
                                dynamic_slots=()) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """component_posteriors through the state-space path (--approx sde).

    One smoothing pass of the whole model gives the joint state posterior;
    component t is its block's part of it, mu_t = H_t m_s and
    var_t = H_t P_s H_tᵀ (the blocks are independent), and a Noise term uses
    S⁻¹ = R⁻¹ I − R⁻² Var(Hx | y).  O(n log n), no n × n matrix."""
    md = markov_data(ck, X, dynamic_slots=dynamic_slots)
    A, Q, H = md.steps(ck, params)
    R = md.j_eff(params, noise)
    ys = y[md.idx]
    m_s, P_s = mss.ss_smooth(A, Q, H, ys, R)
    h_var = mss.measure_var(H, P_s)
    offs = np.cumsum([0] + [mss.block_dim(k) for k in md.kinds])
    out = []
    for t in terms:
        tag, i = md.st.term_map[t]
        if tag == "n":  # K_t = s2 I
            s2 = params[i]
            mu = s2 * (ys - mss.measure_row(H, m_s)) / R
            var = s2 - s2 * s2 * (1.0 / R - h_var / (R * R))
        else:
            mask = torch.zeros(H.shape[-1], dtype=H.dtype, device=H.device)
            mask[int(offs[i]):int(offs[i + 1])] = 1.0
            mu, var = mss.measure_row(H * mask, m_s), mss.measure_var(H * mask, P_s)
        mu, var = mu[md.inv_idx], var[md.inv_idx]
        out.append((t, mu.cpu().numpy(), np.sqrt(np.maximum(var.cpu().numpy(), 0.0))))
    return out


def run(args, rt: Runtime) -> None:
    log.info("running 'fitplot'")
    device, dtype = rt
    spec = parse_formula(args.formula)
    ck = compile_formula(spec.formula)
    df = apply_outlier_policy(complete_cases(load_tables(args.data)), args, spec.response)
    y = torch.tensor(response_vector(df, spec), dtype=dtype, device=device)
    X_np = design_matrix(df, ck)
    X = torch.tensor(X_np, dtype=dtype, device=device)
    n = X.shape[0]
    resolve_auto_approx(args, ck, X_np, "fitplot", spec)

    params = ck.default_params(dtype, device)
    dynamic_slots = ()
    if args.mcmc:
        from gaplac_tpu_torch.cli.predict_cmd import _hyper_draws

        slot_groups = chain_slot_groups(ck, args)
        dynamic_slots = {s for g in slot_groups for s in g}
        means = _hyper_draws(args.mcmc, n_hyper=len(slot_groups)).mean(axis=0)
        for g, slots in enumerate(slot_groups):
            if slots:
                params = ck.set_params(params, slots, float(means[g]))
        log.info("using chain posterior-mean hyperparameters %s",
                 ", ".join(f"{m:.3f}" for m in means))

    sigma2 = gaussian_obs_sigma2(spec.likelihood)
    if sigma2 is None:  # non-Gaussian: unit obs noise for the decomposition
        log.warning("fitplot uses the Gaussian component-posterior equations; "
                    "non-Gaussian likelihood %s treated as Gaussian(1)", spec.likelihood.name)
        sigma2 = 1.0
    terms = wanted_terms(ck, args.component)
    if not terms:
        raise ValueError("No components match --component filter")
    if args.approx == "rff":
        fm = build_feature_map(ck, [X], num_features=args.rff_features, seed=args.rff_seed)
        panels = lowrank_component_posteriors(fm, params, X, y, args.jitter + sigma2, terms)
    elif args.approx == "sde":
        panels = markov_component_posteriors(ck, params, X, y, args.jitter + sigma2, terms,
                                             dynamic_slots)
    else:
        panels = component_posteriors(ck, params, X, y, args.jitter + sigma2, terms)
    if not is_primary():  # rank 0 of a multi-process run draws and writes
        return

    from gaplac_tpu_torch.viz.plots import pyplot

    plt = pyplot()
    fig, axes = plt.subplots(len(panels), 1, figsize=(8, 3.2 * len(panels)), squeeze=False)
    yv = y.cpu().numpy()
    for ax_row, (t, mu_t, sd_t) in zip(axes, panels):
        ax = ax_row[0]
        lead = next((ck.leaf_vars[li] for li in ck.terms[t] if ck.leaf_vars[li]), None)
        xs = column_values(df, lead) if lead in df.columns else np.arange(n, dtype=float)
        order = np.argsort(xs)
        ax.scatter(xs, yv, s=10, color="gray", alpha=0.4, label="data")
        ax.plot(xs[order], mu_t[order], color="dodgerblue", label="component mean")
        ax.fill_between(xs[order], (mu_t - 2 * sd_t)[order], (mu_t + 2 * sd_t)[order],
                        color="dodgerblue", alpha=0.25, label="±2 sd")
        ax.set_title(term_label(ck, t))
        ax.set_xlabel(lead or "index")
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    plt.close(fig)
    log.info("Saved fitplot to %s", args.output)
    print(f"fitplot written to {args.output} ({len(panels)} component(s))")
