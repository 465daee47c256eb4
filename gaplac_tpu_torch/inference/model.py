"""Log-density models for GP hyperparameter inference, dense paths (port of
``gaplac_tpu/inference/model.py``).

Reference model: ℓ ~ Uniform(0, 20); fx ~ GP(kern(ℓ)) at X with jitter 0.1;
y ~ Normal(fx, 1).  The formulations, as in ``gaplac_tpu``:

1. ``build_gaussian_marginal``: Gaussian likelihoods integrate the latents
   out, y ~ N(0, K(θ) + (jitter + σ²) I); the sampler runs over θ only.
2. ``build_latent_whitened``: f = L(θ) z with z ~ N(0, I), sampled over
   v = [u, z]; any likelihood.
3. ``build_gaussian_marginal_lowrank`` (``approx="rff"``): the marginal of 1
   with K(θ) replaced by Φ(θ)Φ(θ)ᵀ, Φ the (n, m) feature matrix of
   ``kernels/features.py``, in O(n m²) (``ops/lowrank.py``).
4. ``build_gaussian_marginal_markov`` and ``build_latent_whitened_markov``
   (``approx="sde"``): 1 and 2 for formulas with a state-space form
   (``_markov_structure``), by parallel Kalman filtering in O(n log n)
   (``ops/markov.py`` for one OU leaf, ``ops/markov_ss.py`` otherwise), with
   no n × n matrix.

Every function here is batched over a leading chain axis: ``logdensity``
maps v (C, dim) to (C,), so one call factors a (C, n, n) batch through
kernels K1 and K2, for 3 a (C, m, m) capacitance batch through K1, and for
4 runs one scan over (C, n, d, d) steps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from gaplac_tpu_torch.dsl.parser import LikelihoodSpec
from gaplac_tpu_torch.inference.likelihoods import gaussian_obs_sigma2, make_loglik
from gaplac_tpu_torch.inference.priors import as_prior
from gaplac_tpu_torch.inference.smc import particle_chunk
from gaplac_tpu_torch.kernels.covariance import (
    K_CAT,
    K_CONST,
    K_LINEAR,
    K_MATERN32,
    K_MATERN52,
    K_NOISE,
    K_OU,
    K_PERIODIC,
    K_RQ,
    K_SQEXP,
    KIND_NAMES,
    CompiledKernel,
)
from gaplac_tpu_torch.ops import linalg, lowrank, markov, mvn
from gaplac_tpu_torch.ops import markov_ss as mss

_LOG_2PI = math.log(2.0 * math.pi)

DEFAULT_PRIOR_BOUNDS = (0.0, 20.0)


def slot_groups_for(
    ck: CompiledKernel,
    inferable: Sequence[str],
    shared: bool = True,
    infer_extras: Sequence[str] = (),
) -> Tuple[Tuple[int, ...], ...]:
    """Map --infer variables to hyperparameter slot groups: one shared
    scalar for all (``shared``) or one per variable, then one entry per
    shape parameter of the --infer-extra variables."""
    groups: list = []
    if inferable:
        if shared:
            groups.append(ck.param_slots_for_vars(inferable))
        else:
            seen = set()
            for v in inferable:
                if v in seen:
                    continue
                seen.add(v)
                groups.append(ck.param_slots_for_vars([v]))
    seen_e = set()
    for v in infer_extras:
        if v in seen_e:
            continue
        seen_e.add(v)
        groups.extend((s,) for s in ck.extra_slots_for_vars([v]))
    if not groups:
        raise ValueError("nothing to infer: give --infer and/or --infer-extra")
    return tuple(groups)


@dataclass(frozen=True)
class GPModel:
    """A compiled inference problem, batched over a leading axis.

    ``logdensity(v)``: (C, dim) -> (C,), the unconstrained-space target.
    ``report(gen, v)``: (B, dim) -> theta (B, n_hyper), f (B, n), lp (B,),
    the chain-row pieces.  ``initial_position(gen, C)`` -> (C, dim).
    ``position_from(theta, f)``: one chain row back to a position (dim,).
    ``report_batch``: the draws one ``report`` call, or the particles one
    SMC evaluation, may take (``smc.particle_chunk`` of the model's buffers).
    """

    dim: int
    n_hyper: int
    logdensity: Callable[[torch.Tensor], torch.Tensor]
    report: Callable
    constrain: Callable[[torch.Tensor], torch.Tensor]
    initial_position: Callable
    marginalized: bool
    position_from: Callable = None
    report_batch: int = 64


def _params_from(ck: CompiledKernel, slot_groups, dtype, device):
    """theta (C, n_groups) -> params (C, n_params): the defaults with each
    group's slots set to its theta, as an out-of-place scatter so autograd
    flows to theta."""
    defaults = ck.default_params(dtype, device)
    idx_groups = [torch.as_tensor(g, dtype=torch.long, device=device) for g in slot_groups]

    def params(theta: torch.Tensor) -> torch.Tensor:
        C = theta.shape[0]
        p = defaults.expand(C, -1)
        for g, idx in enumerate(idx_groups):
            p = p.index_copy(1, idx, theta[:, g:g + 1].expand(C, idx.numel()))
        return p

    return params


def _uniform_init(gen, C, nh, dtype, device):
    """u0 ~ U(-2, 2), as Turing initializes."""
    return torch.rand((C, nh), generator=gen, dtype=dtype, device=device) * 4.0 - 2.0


def build_gaussian_marginal(
    ck: CompiledKernel,
    slot_groups: Tuple[Tuple[int, ...], ...],
    X: torch.Tensor,
    y: torch.Tensor,
    jitter: float = mvn.DEFAULT_JITTER,
    obs_sigma2: float = 1.0,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
) -> GPModel:
    """Collapsed model: θ -> log N(y; 0, K(θ) + (jitter + σ²) I) + prior."""
    tr = as_prior(prior_bounds)
    nh = len(slot_groups)
    n = y.shape[0]
    dtype, device = X.dtype, X.device
    params_from = _params_from(ck, slot_groups, dtype, device)
    dynamic = tuple(sorted({s for g in slot_groups for s in g}))
    gram_bound = ck.bind(X, dynamic, diag=jitter + obs_sigma2)

    def logdensity(u: torch.Tensor) -> torch.Tensor:
        theta = tr.forward(u)
        S = gram_bound(params_from(theta))
        return mvn.mvn_logpdf(S, y) + tr.logprior_u(u).sum(-1)

    @torch.no_grad()
    def report(gen: torch.Generator, u: torch.Tensor):
        """f ~ p(f | θ, y) exactly, and the joint lp = log p(θ) +
        log N(f; 0, K + jitter I) + Σ log N(y; f, σ²)."""
        theta = tr.forward(u)
        Kf = ck.gram(params_from(theta), X, diag=jitter)
        Ls = linalg.cholesky(mvn.add_jitter(Kf, obs_sigma2))
        A = linalg.solve_triangular(Ls, Kf, lower=True)               # L^-1 Kf
        mean_f = (A.mT @ linalg.solve_triangular(Ls, y, lower=True).unsqueeze(-1)).squeeze(-1)
        cond_cov = Kf - A.mT @ A
        tr_c = torch.diagonal(cond_cov, dim1=-2, dim2=-1).sum(-1)
        Lc = linalg.cholesky(mvn.add_jitter(cond_cov, (1e-8 * tr_c / n)[:, None, None]))
        f = mvn.sample_mvn_chol(gen, Lc, mean_f)
        lp = (tr.logprior_x(theta).sum(-1) + mvn.mvn_logpdf(Kf, f)
              + torch.sum(-0.5 * ((y - f) ** 2 / obs_sigma2 + math.log(obs_sigma2) + _LOG_2PI),
                          dim=-1))
        return theta, f, lp

    def initial_position(gen: torch.Generator, C: int) -> torch.Tensor:
        return _uniform_init(gen, C, nh, dtype, device)

    def position_from(theta: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return tr.inverse(torch.as_tensor(theta, dtype=dtype, device=device))

    return GPModel(nh, nh, logdensity, report, tr.forward, initial_position, True,
                   position_from, particle_chunk(n, n, y.element_size()))


def build_gaussian_marginal_lowrank(
    ck: CompiledKernel,
    slot_groups: Tuple[Tuple[int, ...], ...],
    X: torch.Tensor,
    y: torch.Tensor,
    num_features: int = 256,
    feature_seed: int = 0,
    jitter: float = mvn.DEFAULT_JITTER,
    obs_sigma2: float = 1.0,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
) -> GPModel:
    """Low-rank collapsed model: θ -> log N(y; 0, Φ(θ)Φ(θ)ᵀ + D(θ)) + prior,
    D = jitter + bare Noise + σ²; the prior, jitter and σ² of
    ``build_gaussian_marginal``."""
    from gaplac_tpu_torch.kernels.features import build_feature_map

    tr = as_prior(prior_bounds)
    nh = len(slot_groups)
    dtype, device = X.dtype, X.device
    params_from = _params_from(ck, slot_groups, dtype, device)
    fm = build_feature_map(ck, [X], num_features=num_features, seed=feature_seed)

    def _phi_d0(theta):
        """The features and the latent's prior diagonal d0 = jitter + bare Noise."""
        p = params_from(theta)
        return fm.phi(p, X), jitter + fm.noise_diag(p, X)

    def logdensity(u: torch.Tensor) -> torch.Tensor:
        phi, d0 = _phi_d0(tr.forward(u))
        return lowrank.lowrank_logpdf(phi, d0 + obs_sigma2, y) + tr.logprior_u(u).sum(-1)

    @torch.no_grad()
    def report(gen: torch.Generator, u: torch.Tensor):
        """f ~ p(f | θ, y) exactly by Matheron's rule, and the joint lp of
        ``build_gaussian_marginal``'s report, all in O(n m²)."""
        theta = tr.forward(u)
        phi, d0 = _phi_d0(theta)
        f = lowrank.lowrank_conditional_sample(gen, phi, d0, obs_sigma2, y)
        lp = (tr.logprior_x(theta).sum(-1) + lowrank.lowrank_logpdf(phi, d0, f)
              + torch.sum(-0.5 * ((y - f) ** 2 / obs_sigma2 + math.log(obs_sigma2) + _LOG_2PI),
                          dim=-1))
        return theta, f, lp

    def initial_position(gen: torch.Generator, C: int) -> torch.Tensor:
        return _uniform_init(gen, C, nh, dtype, device)

    def position_from(theta: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return tr.inverse(torch.as_tensor(theta, dtype=dtype, device=device))

    return GPModel(nh, nh, logdensity, report, tr.forward, initial_position, True,
                   position_from, particle_chunk(y.shape[0], fm.m_total, y.element_size()))


def build_latent_whitened(
    ck: CompiledKernel,
    slot_groups: Tuple[Tuple[int, ...], ...],
    X: torch.Tensor,
    y: torch.Tensor,
    likelihood: LikelihoodSpec,
    aux: Optional[torch.Tensor] = None,
    jitter: float = mvn.DEFAULT_JITTER,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
) -> GPModel:
    """Whitened latent model over v = [u (nh,), z (n,)]: f = L(θ) z.

    The log density's forward runs in four profiler ranges,
    ``gaplac.latent.gram``, ``.factor``, ``.map`` (f = L z) and ``.loglik``,
    which a trace shows on the host and, with its CUDA activity, on the
    device."""
    tr = as_prior(prior_bounds)
    nh = len(slot_groups)
    n = y.shape[0]
    dtype, device = X.dtype, X.device
    params_from = _params_from(ck, slot_groups, dtype, device)
    loglik = make_loglik(likelihood)
    dynamic = tuple(sorted({s for g in slot_groups for s in g}))
    gram_bound = ck.bind(X, dynamic, diag=jitter)

    def _latent_chol(u):
        theta = tr.forward(u)
        with record_function("gaplac.latent.gram"):
            K = gram_bound(params_from(theta))
        with record_function("gaplac.latent.factor"):
            return theta, linalg.cholesky(K)

    def logdensity(v: torch.Tensor) -> torch.Tensor:
        u, z = v[:, :nh], v[:, nh:]
        _, L = _latent_chol(u)
        with record_function("gaplac.latent.map"):
            f = (L @ z.unsqueeze(-1)).squeeze(-1)
        with record_function("gaplac.latent.loglik"):
            ll = loglik(y, f, aux).sum(-1)
        return (tr.logprior_u(u).sum(-1) - 0.5 * torch.sum(z * z, dim=-1)
                - 0.5 * n * _LOG_2PI + ll)

    @torch.no_grad()
    def report(gen: torch.Generator, v: torch.Tensor):
        u, z = v[:, :nh], v[:, nh:]
        theta, L = _latent_chol(u)
        f = (L @ z.unsqueeze(-1)).squeeze(-1)
        lp = (tr.logprior_x(theta).sum(-1) + mvn.mvn_logpdf_chol(L, f)
              + loglik(y, f, aux).sum(-1))
        return theta, f, lp

    def initial_position(gen: torch.Generator, C: int) -> torch.Tensor:
        u0 = _uniform_init(gen, C, nh, dtype, device)
        z0 = 0.1 * torch.randn((C, n), generator=gen, dtype=dtype, device=device)
        return torch.cat([u0, z0], dim=1)

    @torch.no_grad()
    def position_from(theta: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        u = tr.inverse(torch.as_tensor(theta, dtype=dtype, device=device))
        _, L = _latent_chol(u[None])
        z = linalg.solve_triangular(L[0], torch.as_tensor(f, dtype=dtype, device=device))
        return torch.cat([u, z])

    return GPModel(nh + n, nh, logdensity, report, tr.forward, initial_position, False,
                   position_from, particle_chunk(n, n, y.element_size()))


@dataclass(frozen=True)
class MarkovStructure:
    """State-space decomposition of a formula (``--approx sde``).

    ``blocks``: per additive term, (block_kind, leaf_slot, col): OU /
    Matern32 / Matern52 / Constant / Linear / SqExp / Periodic / RQ
    (``ops/markov_ss.py`` block kinds); ``leaf_slot == -1`` marks a pure-Cat
    term (a unit-variance Constant block).  A product term stores a tuple in
    each field and lowers to the Kronecker-composed SSM.  ``group_cols``: the
    term's Cat design columns; the block restarts from its stationary prior
    at every group change.  ``noise_slots``: Noise leaves folded into the
    observation variance.  ``sort_idx`` orders rows by (Markov group key ...,
    time); ``resets`` are the per-block group-boundary masks in that order.
    ``scalar_ou``: the single ungrouped OU leaf (``ops/markov.py``).
    ``term_map``: per formula term, ("b", block index) or ("n", noise slot)."""

    blocks: Tuple
    group_cols: Tuple[Tuple[int, ...], ...]
    noise_slots: Tuple[int, ...]
    sort_idx: object
    t_sorted: object
    resets: object
    scalar_ou: bool
    time_col: int
    markov_gcols: Tuple[int, ...]
    term_map: Tuple[Tuple[str, int], ...] = ()


def markov_param_vals(ck: CompiledKernel, st: MarkovStructure, p: torch.Tensor):
    """Per-block parameter payloads for ``markov_ss.build_steps`` from params
    (..., n_params): the leaf's natural scalar (1 for pure-Cat blocks);
    Periodic (l, period), the period from the parameter vector; RQ (l, c, w)
    with the static quadrature of its alpha; a tuple per factor for products."""

    def leaf_val(bk, li):
        if li < 0:
            return torch.ones((), dtype=p.dtype, device=p.device)
        if bk == mss.BLOCK_PERIODIC:
            es = ck.extra_slots[li]
            period = (p[..., es[0]] if es and p.shape[-1] == ck.n_params
                      else torch.tensor(ck.extras[li][0], dtype=p.dtype, device=p.device))
            return (p[..., li], period)
        if bk == mss.BLOCK_RQ:
            # alpha is static under sde (the quadrature nodes are polynomial
            # roots); _markov_structure rejects it as --infer-extra
            c, w = mss.rq_mixture_constants(float(ck.extras[li][0]))
            return (p[..., li], c, w)
        return p[..., li]

    return [tuple(leaf_val(b, s) for b, s in zip(bk, li)) if isinstance(bk, tuple)
            else leaf_val(bk, li) for bk, li, _ in st.blocks]


def markov_block_xs(st: MarkovStructure, X: torch.Tensor, idx=None):
    """Per-block data columns for ``markov_ss.build_steps`` (None where
    unused, a tuple per factor for products), rows permuted by ``idx``."""

    def one(col):
        if col < 0:
            return None
        v = X[:, col]
        return v if idx is None else v[idx]

    return [tuple(one(c) for c in col) if isinstance(col, tuple) else one(col)
            for _, _, col in st.blocks]


def markov_order_resets(st: MarkovStructure, X):
    """Sort permutation, sorted time axis and per-block reset masks of a row
    set with ``st``'s design columns: by Markov group key
    lexicographically, then time (stable); by group only, or row order, when
    the formula has no Markov leaf.  Raises if a grouped block's levels are
    not contiguous in that order (crossed groupings have no exact
    reset-based Markov form)."""
    X = np.asarray(X)
    N = X.shape[0]
    if st.time_col >= 0:
        t = np.asarray(X[:, st.time_col], dtype=float)
        order = np.lexsort((t,) + tuple(X[:, c] for c in reversed(st.markov_gcols)))
        t_sorted = t[order]
    else:
        seen: list = []
        for gc in st.group_cols:
            for c in gc:
                if c not in seen:
                    seen.append(c)
        order = (np.lexsort(tuple(X[:, c] for c in reversed(seen))) if seen
                 else np.arange(N))
        # no Markov leaf: every transition is dt-independent (A = 0 or I)
        t_sorted = np.arange(N, dtype=float)
    resets = []
    for gc in st.group_cols:
        if not gc:
            resets.append(None)
            continue
        key = X[:, list(gc)][order]
        change = np.any(key[1:] != key[:-1], axis=1)
        if 1 + int(change.sum()) != len(np.unique(key, axis=0)):
            raise ValueError(
                "--approx sde: a 'kernel * Cat' term's groups are not "
                "contiguous under the state-space sort order (crossed with "
                "the Markov grouping); only shared/nested Cat groupings "
                "have an exact Markov form — use the dense path or "
                "--approx rff"
            )
        resets.append(np.concatenate([[True], change]))
    return order, t_sorted, tuple(resets)


#: formula kinds with a state-space block
_BLOCK_OF = {
    K_OU: mss.BLOCK_OU, K_MATERN32: mss.BLOCK_M32, K_MATERN52: mss.BLOCK_M52,
    K_CONST: mss.BLOCK_CONST, K_LINEAR: mss.BLOCK_LINEAR,
    # the approximate blocks: SqExp's order-6 spectral Taylor SSM, Periodic's
    # J harmonics, RQ's K-node Gamma mixture of SqExp blocks (static alpha)
    K_SQEXP: mss.BLOCK_SQEXP, K_PERIODIC: mss.BLOCK_PERIODIC, K_RQ: mss.BLOCK_RQ,
}
#: kinds whose transition depends on the step (a shared time axis)
_MARKOV_KINDS = (K_OU, K_MATERN32, K_MATERN52, K_SQEXP, K_PERIODIC, K_RQ)


def _markov_structure(ck: CompiledKernel, X, dynamic_slots=()) -> MarkovStructure:
    """Validate and extract the state-space structure for ``--approx sde``.

    Supported terms: products of SqExp / OU / Matern32 / Matern52 / Periodic
    / Constant / Linear leaves (several factors lower to the Kronecker
    product), each optionally times any number of Cat leaves; pure-Cat
    products (unit-variance group intercepts); and Noise.  All Markov leaves
    share one time variable and one Cat grouping.  Raises otherwise."""
    import logging

    X = np.asarray(X)
    blocks, group_cols, noise_slots, term_map = [], [], [], []
    time_vars = set()
    state = {"time_col": -1, "gvars": None, "gcols": ()}
    dynamic_slots = frozenset(dynamic_slots)

    def check_static_extras(kind, li):
        if kind == K_RQ and any(s in dynamic_slots for s in ck.extra_slots[li]):
            raise ValueError(
                "--approx sde: RQ's alpha cannot be inferred "
                "(--infer-extra) — the Gamma-mixture quadrature nodes are "
                "static polynomial roots; drop --infer-extra for this "
                "variable or use the dense path"
            )

    def note_markov(li, cats, gcols):
        time_vars.add(ck.leaf_vars[li])
        gvars = frozenset(ck.leaf_vars[c] for c in cats)
        if state["gvars"] is None:
            state.update(time_col=ck.cols[li], gvars=gvars, gcols=gcols)
        elif gvars != state["gvars"]:
            raise ValueError(
                "--approx sde needs all OU/Matern leaves to share "
                "ONE Cat grouping; got groupings "
                f"{sorted(state['gvars'])} and {sorted(gvars)}"
            )

    for term in ck.terms:
        cats = [li for li in term if ck.kinds[li] == K_CAT]
        others = [li for li in term if ck.kinds[li] != K_CAT]
        gcols = tuple(ck.cols[li] for li in cats)
        if len(others) > 1:
            bks, slots, cols = [], [], []
            for li in others:
                kind = ck.kinds[li]
                if kind not in _BLOCK_OF:
                    raise ValueError(
                        "--approx sde: product factors must be SqExp / OU / "
                        "Matern32 / Matern52 / Periodic / Constant / Linear "
                        f"(each optionally × Cat); got {KIND_NAMES[kind]} "
                        "inside a product (no state-space form; use the "
                        "dense path or --approx rff)"
                    )
                check_static_extras(kind, li)
                bks.append(_BLOCK_OF[kind])
                slots.append(li)
                cols.append(ck.cols[li])
                if kind in _MARKOV_KINDS:
                    note_markov(li, cats, gcols)
            dim = mss.block_dim(tuple(bks))
            if dim > 64:
                logging.getLogger("gaplac").warning(
                    "--approx sde: product term's Kronecker state dimension "
                    "is %d — O(n·d³) filtering will be slow; consider the "
                    "dense path or --approx rff for this formula", dim,
                )
            term_map.append(("b", len(blocks)))
            blocks.append((tuple(bks), tuple(slots), tuple(cols)))
            group_cols.append(gcols)
            continue
        if not others:
            # pure-Cat product: a unit-variance group intercept
            term_map.append(("b", len(blocks)))
            blocks.append((mss.BLOCK_CONST, -1, -1))
            group_cols.append(gcols)
            continue
        li = others[0]
        kind = ck.kinds[li]
        if kind == K_NOISE:
            if cats:
                raise ValueError(
                    "--approx sde does not support Noise * Cat products "
                    "(group-correlated noise is not diagonal); use the "
                    "dense path"
                )
            if ck.cols[li] >= 0:
                col_vals = X[:, ck.cols[li]]
                if len(np.unique(col_vals)) != col_vals.shape[0]:
                    raise ValueError(
                        "--approx sde: Noise(:var) requires distinct values "
                        "(duplicates couple rows off-diagonally); use bare "
                        "Noise for per-row noise"
                    )
            noise_slots.append(li)
            term_map.append(("n", li))
        elif kind in _BLOCK_OF:
            check_static_extras(kind, li)
            term_map.append(("b", len(blocks)))
            blocks.append((_BLOCK_OF[kind], li, ck.cols[li]))
            group_cols.append(gcols)
            if kind in _MARKOV_KINDS:
                note_markov(li, cats, gcols)
        else:
            raise ValueError(
                f"--approx sde supports additive SqExp / OU / Matern32 / "
                f"Matern52 / Periodic / Constant / Linear / Noise terms "
                f"(each optionally × Cat); got {KIND_NAMES[kind]} (no "
                f"finite-dimensional state-space form; use --approx rff)"
            )
    if len(time_vars) > 1:
        raise ValueError(
            "--approx sde needs all OU/Matern leaves on ONE shared column "
            f"(the Markov time axis); got variables {sorted(time_vars)}"
        )
    if not blocks:
        raise ValueError("--approx sde needs at least one kernel leaf")
    st = MarkovStructure(
        tuple(blocks), tuple(group_cols), tuple(noise_slots), None, None, None,
        scalar_ou=(len(blocks) == 1 and blocks[0][0] == mss.BLOCK_OU and not group_cols[0]),
        time_col=state["time_col"], markov_gcols=state["gcols"], term_map=tuple(term_map),
    )
    sort_idx, t_sorted, resets = markov_order_resets(st, X)
    return MarkovStructure(st.blocks, st.group_cols, st.noise_slots, sort_idx, t_sorted,
                           resets, st.scalar_ou, st.time_col, st.markov_gcols, st.term_map)


class MarkovData(NamedTuple):
    """A formula's state-space structure and its rows on the device, in
    the state-space sort order."""

    st: MarkovStructure
    kinds: Tuple
    ts: torch.Tensor          # (n,) sorted time axis
    idx: torch.Tensor         # (n,) the sort permutation
    inv_idx: torch.Tensor     # (n,) its inverse
    xs: list                  # per-block data columns, sorted
    resets: Tuple             # per-block reset masks (or None)
    state_dim: int

    def steps(self, ck: CompiledKernel, p: torch.Tensor):
        """(A, Q, H) of ``markov_ss.build_steps`` at params (..., n_params)."""
        return mss.build_steps(self.kinds, markov_param_vals(ck, self.st, p), self.ts,
                               self.xs, resets=self.resets)

    def j_eff(self, p: torch.Tensor, jitter: float) -> torch.Tensor:
        """jitter plus the Noise leaves, (..., 1): the diagonal of K + j_eff I."""
        j = torch.full(p.shape[:-1] + (1,), float(jitter), dtype=p.dtype, device=p.device)
        for s in self.st.noise_slots:
            j = j + p[..., s:s + 1]
        return j

    def report_batch(self) -> int:
        """Draws or particles one call takes: (B, n, d, d) scans in the
        steps' dtype."""
        itemsize = mss.steps_dtype(self.kinds, self.ts.dtype).itemsize
        return particle_chunk(self.ts.shape[0], self.state_dim ** 2, itemsize,
                              buffers=mss.SCAN_BUFFERS)


def markov_data(ck: CompiledKernel, X: torch.Tensor, dynamic_slots=(),
                rows: Optional[torch.Tensor] = None) -> MarkovData:
    """``_markov_structure`` of X's rows, with the rows ``rows`` (default X;
    the joined training and test rows in predict) sorted in its order, on
    X's device."""
    st = _markov_structure(ck, X.cpu().numpy(), dynamic_slots=dynamic_slots)
    if rows is None:
        rows, order, t_sorted, resets = X, st.sort_idx, st.t_sorted, st.resets
    else:
        order, t_sorted, resets = markov_order_resets(st, rows.cpu().numpy())
    dev = X.device
    idx = torch.as_tensor(order, device=dev)
    kinds = tuple(b[0] for b in st.blocks)
    return MarkovData(
        st, kinds, torch.as_tensor(t_sorted, dtype=X.dtype, device=dev), idx,
        torch.argsort(idx), markov_block_xs(st, rows, idx=idx),
        tuple(None if r is None else torch.as_tensor(r, device=dev) for r in resets),
        sum(mss.block_dim(k) for k in kinds))


def build_gaussian_marginal_markov(
    ck: CompiledKernel,
    slot_groups: Tuple[Tuple[int, ...], ...],
    X: torch.Tensor,
    y: torch.Tensor,
    jitter: float = mvn.DEFAULT_JITTER,
    obs_sigma2: float = 1.0,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
) -> GPModel:
    """State-space marginal (``--approx sde``): θ -> log N(y; 0, K(θ) +
    (j_eff + σ²) I) + prior by parallel Kalman filtering, O(n log n), with
    no n × n gram and no Cholesky; exact for OU / Matern / Constant /
    Linear blocks.  One ungrouped OU leaf takes the scalar path.

    The report draws the latent by Matheron's rule through the same scans:
    f = f* + S T⁻¹ (y − f* − ε*) with S = K + j_eff I, T = S + σ² I, where
    S T⁻¹ r = m_x + j_eff (r − m_x)/(j_eff + σ²) and m_x is the smoothed
    mean of r."""
    tr = as_prior(prior_bounds)
    nh = len(slot_groups)
    n = y.shape[0]
    dtype, device = X.dtype, X.device
    params_from = _params_from(ck, slot_groups, dtype, device)
    md = markov_data(ck, X, dynamic_slots={s for g in slot_groups for s in g})
    ys = y[md.idx]

    if md.st.scalar_ou:
        ou_slot = md.st.blocks[0][1]

        def latent_loglik(p, vals, R):
            return markov.ou_loglik(md.ts, vals, p[..., ou_slot], R)

        def smooth_mean(p, vals, R):
            return markov.ou_smooth(md.ts, vals, p[..., ou_slot], R)[0]

        def prior_path(gen, p):
            return markov.ou_prior_sample(gen, md.ts, p[..., ou_slot])
    else:

        def latent_loglik(p, vals, R):
            A, Q, H = md.steps(ck, p)
            return mss.ss_loglik(A, Q, H, vals, R)

        def smooth_mean(p, vals, R):
            A, Q, H = md.steps(ck, p)
            return mss.measure_row(H, mss.ss_smooth(A, Q, H, vals, R)[0])

        def prior_path(gen, p):
            A, Q, H = md.steps(ck, p)
            return mss.measure_row(H, mss.ss_prior_sample(gen, A, Q))

    def logdensity(u: torch.Tensor) -> torch.Tensor:
        p = params_from(tr.forward(u))
        lp = latent_loglik(p, ys, md.j_eff(p, jitter) + obs_sigma2) + tr.logprior_u(u).sum(-1)
        return lp.to(dtype)  # SqExp/RQ steps run in float64 (markov_ss.steps_dtype)

    @torch.no_grad()
    def report(gen: torch.Generator, u: torch.Tensor):
        theta = tr.forward(u)
        p = params_from(theta)
        j_eff = md.j_eff(p, jitter)
        f_star = prior_path(gen, p) + torch.sqrt(j_eff) * torch.randn(
            (u.shape[0], n), generator=gen, dtype=dtype, device=device)
        eps = math.sqrt(obs_sigma2) * torch.randn((u.shape[0], n), generator=gen, dtype=dtype,
                                                  device=device)
        r = ys - f_star - eps
        m_x = smooth_mean(p, r, j_eff + obs_sigma2)
        f = f_star + m_x + j_eff * (r - m_x) / (j_eff + obs_sigma2)
        lp = (tr.logprior_x(theta).sum(-1) + latent_loglik(p, f, j_eff)
              + torch.sum(-0.5 * ((ys - f) ** 2 / obs_sigma2 + math.log(obs_sigma2) + _LOG_2PI),
                          dim=-1))
        return theta, f[..., md.inv_idx].to(dtype), lp.to(dtype)

    def initial_position(gen: torch.Generator, C: int) -> torch.Tensor:
        return _uniform_init(gen, C, nh, dtype, device)

    def position_from(theta: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        return tr.inverse(torch.as_tensor(theta, dtype=dtype, device=device))

    return GPModel(nh, nh, logdensity, report, tr.forward, initial_position, True,
                   position_from, md.report_batch())


def build_latent_whitened_markov(
    ck: CompiledKernel,
    slot_groups: Tuple[Tuple[int, ...], ...],
    X: torch.Tensor,
    y: torch.Tensor,
    likelihood: LikelihoodSpec,
    aux: Optional[torch.Tensor] = None,
    jitter: float = mvn.DEFAULT_JITTER,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
) -> GPModel:
    """Whitened latent model over v = [u (nh,), z (n,)] with f = L(θ) z
    realized by the state-space innovation recurrence (``--approx sde
    --no-marginalize``; any likelihood).  The innovation factorization of
    K + j I is its Cholesky factorization in the sort order, so for exact
    blocks this is ``build_latent_whitened`` on sorted rows, from two
    O(n log n) scans; z is in the sort order."""
    tr = as_prior(prior_bounds)
    nh = len(slot_groups)
    n = y.shape[0]
    dtype, device = X.dtype, X.device
    params_from = _params_from(ck, slot_groups, dtype, device)
    loglik = make_loglik(likelihood)
    md = markov_data(ck, X, dynamic_slots={s for g in slot_groups for s in g})
    ys = y[md.idx]
    aux_s = None if aux is None else aux[md.idx]

    def _whiten(u, z):
        theta = tr.forward(u)
        p = params_from(theta)
        A, Q, H = md.steps(ck, p)
        Kg, S = mss.ss_innovation_coeffs(A, Q, H, md.j_eff(p, jitter))
        return theta, mss.ss_whiten_apply(A, H, Kg, S, z), S

    def logdensity(v: torch.Tensor) -> torch.Tensor:
        u, z = v[:, :nh], v[:, nh:]
        _, f, _ = _whiten(u, z)
        return (tr.logprior_u(u).sum(-1) - 0.5 * torch.sum(z * z, dim=-1)
                - 0.5 * n * _LOG_2PI + loglik(ys, f, aux_s).sum(-1)).to(dtype)

    @torch.no_grad()
    def report(gen: torch.Generator, v: torch.Tensor):
        u, z = v[:, :nh], v[:, nh:]
        theta, f, S = _whiten(u, z)
        # log N(f; 0, L Lᵀ) = −½(Σz² + Σ log S + n log 2π)
        lp = (tr.logprior_x(theta).sum(-1)
              - 0.5 * (torch.sum(z * z, dim=-1) + torch.sum(torch.log(S), dim=-1)
                       + n * _LOG_2PI)
              + loglik(ys, f, aux_s).sum(-1))
        return theta, f[..., md.inv_idx].to(dtype), lp.to(dtype)

    def initial_position(gen: torch.Generator, C: int) -> torch.Tensor:
        u0 = _uniform_init(gen, C, nh, dtype, device)
        z0 = 0.1 * torch.randn((C, n), generator=gen, dtype=dtype, device=device)
        return torch.cat([u0, z0], dim=1)

    @torch.no_grad()
    def position_from(theta: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        u = tr.inverse(torch.as_tensor(theta, dtype=dtype, device=device))
        p = params_from(tr.forward(u)[None])
        A, Q, H = md.steps(ck, p)
        Kg, S = mss.ss_innovation_coeffs(A, Q, H, md.j_eff(p, jitter))
        f = torch.as_tensor(f, dtype=dtype, device=device)[md.idx]
        return torch.cat([u, mss.ss_unwhiten(A, H, Kg, S, f[None])[0].to(dtype)])

    return GPModel(nh + n, nh, logdensity, report, tr.forward, initial_position, False,
                   position_from, md.report_batch())


def build_model(
    ck: CompiledKernel,
    inferable: Sequence[str],
    X: torch.Tensor,
    y: torch.Tensor,
    likelihood: LikelihoodSpec,
    aux: Optional[torch.Tensor] = None,
    jitter: float = mvn.DEFAULT_JITTER,
    prior_bounds=DEFAULT_PRIOR_BOUNDS,
    shared_hyper: bool = True,
    marginalize: bool = True,
    approx: str = "exact",
    rff_features: int = 256,
    rff_seed: int = 0,
    infer_extras: Sequence[str] = (),
) -> GPModel:
    """The marginal model for Gaussian likelihoods (default), the whitened
    latent model otherwise; ``approx="rff"`` takes the low-rank feature-space
    marginal (Gaussian likelihoods only), ``approx="sde"`` the state-space
    models (the Laplace marginal for non-Gaussian likelihoods)."""
    groups = slot_groups_for(ck, inferable, shared=shared_hyper, infer_extras=infer_extras)
    sigma2 = gaussian_obs_sigma2(likelihood)
    if approx == "sde":
        if not marginalize:
            return build_latent_whitened_markov(ck, groups, X, y, likelihood, aux=aux,
                                                jitter=jitter, prior_bounds=prior_bounds)
        if sigma2 is None:
            from gaplac_tpu_torch.inference.laplace import build_laplace_marginal_markov

            return build_laplace_marginal_markov(ck, groups, X, y, likelihood, aux=aux,
                                                 jitter=jitter, prior_bounds=prior_bounds)
        return build_gaussian_marginal_markov(ck, groups, X, y, jitter=jitter,
                                              obs_sigma2=sigma2, prior_bounds=prior_bounds)
    if approx == "rff":
        if sigma2 is None:
            raise ValueError(
                "--approx rff requires a Gaussian likelihood (the low-rank "
                "path marginalizes the latents analytically)"
            )
        if infer_extras:
            raise ValueError(
                "--infer-extra is not supported with --approx rff: the "
                "feature expansion is drawn from the spectral density at the "
                "STATIC shape parameters (period/alpha), so they cannot vary "
                "per density evaluation"
            )
        return build_gaussian_marginal_lowrank(
            ck, groups, X, y, num_features=rff_features, feature_seed=rff_seed,
            jitter=jitter, obs_sigma2=sigma2, prior_bounds=prior_bounds,
        )
    if marginalize and sigma2 is not None:
        return build_gaussian_marginal(ck, groups, X, y, jitter=jitter, obs_sigma2=sigma2,
                                       prior_bounds=prior_bounds)
    return build_latent_whitened(ck, groups, X, y, likelihood, aux=aux, jitter=jitter,
                                 prior_bounds=prior_bounds)
