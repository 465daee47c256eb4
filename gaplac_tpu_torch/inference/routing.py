"""``--approx auto``: routing between the dense, sde and rff paths, and the
sde accuracy guard (port of ``gaplac_tpu/inference/routing.py``).

The crossovers are ``gaplac_tpu``'s, kept at its values so that ``auto``
chooses what ``gaplac_tpu`` chooses: dense up to n = 4096; the state-space
path beyond it for formulas that have one, up to a total state dimension
of 24 for the gradient-based commands (their cost grows as d³) and at any
dimension for the forward-only ones; rff otherwise.  None of them is
measured on the H100 yet.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from gaplac_tpu_torch.inference.likelihoods import gaussian_obs_sigma2
from gaplac_tpu_torch.inference.model import _markov_structure
from gaplac_tpu_torch.kernels.covariance import K_RQ, K_SQEXP
from gaplac_tpu_torch.ops import markov_ss as mss

log = logging.getLogger("gaplac")

#: the dense path, exact for every formula, up to this n (not measured on the H100)
DENSE_MAX_N = 4096

#: above this total state dimension the sde gradient path (d³ a step) goes
#: to the dense path for sampling (not measured on the H100)
SDE_SAMPLING_MAX_D = 24

#: dense sampling when a high-d product forces it, up to this n; beyond, rff
#: (not measured on the H100)
DENSE_HIGH_D_MAX_N = 16384

#: the commands with no gradient: their smoothing holds no autograd tape
FORWARD_ONLY_COMMANDS = ("sample", "predict", "fitplot")


def sde_structure_info(ck, X, dynamic_slots: Sequence[int] = ()):
    """(total state dim, has-approximate-blocks, structure) when the formula
    has a state-space form on these rows, else (None, None, reason)."""
    try:
        st = _markov_structure(ck, np.asarray(X), dynamic_slots=tuple(dynamic_slots))
    except ValueError as e:
        return None, None, str(e)
    d = sum(mss.block_dim(b[0]) for b in st.blocks)
    approximate = any(
        k in (mss.BLOCK_SQEXP, mss.BLOCK_PERIODIC, mss.BLOCK_RQ)
        for b in st.blocks for k in (b[0] if isinstance(b[0], tuple) else (b[0],))
    )
    return d, approximate, st


def choose_approx(ck, X, command: str, likelihood=None,
                  dynamic_slots: Sequence[int] = ()) -> str:
    """Resolve ``--approx auto`` to 'none' | 'sde' | 'rff' | 'laplace' for
    ``command`` (the forward-only commands route high-d products to sde);
    ``likelihood`` the parsed LikelihoodSpec (non-Gaussian data cannot take
    the rff marginal).  Logs the decision, and warns whenever the path it
    chose is approximate."""
    X = np.asarray(X)
    n = X.shape[0]
    gaussian = likelihood is None or gaussian_obs_sigma2(likelihood) is not None
    d, approximate, st_or_reason = sde_structure_info(ck, X, dynamic_slots)
    has_sde = d is not None
    forward_only = command in FORWARD_ONLY_COMMANDS

    def pick(choice, why):
        log.info("--approx auto: %s (n=%d%s) — %s",
                 choice, n, f", state dim {d}" if has_sde else "", why)
        if choice == "sde" and approximate:
            log.warning(
                "--approx auto chose the state-space path for a formula "
                "with SqExp/Periodic/RQ leaves — those blocks are "
                "APPROXIMATE (SqExp order-6: <= 0.14 nats for l within a "
                "third of the input span; Periodic J-harmonic; RQ K-node "
                "mixture). Pass --approx none to force the exact dense path."
            )
        if choice == "rff":
            log.warning(
                "--approx auto chose the low-rank feature path — "
                "stationary leaves are RFF-APPROXIMATE (error ~ 1/sqrt(m); "
                "raise --rff-features to tighten). Pass --approx none to "
                "force the exact dense path."
            )
        if choice == "laplace":
            log.warning(
                "--approx auto chose the Laplace-marginalized path for the "
                "non-Gaussian likelihood at this n — the latent posterior "
                "is Gaussian-approximated. Pass --approx none for exact "
                "joint (whitened) sampling."
            )
        return choice

    if n <= DENSE_MAX_N:
        if not gaussian and command == "mcmc" and n > 512 and has_sde:
            # dense joint sampling of a non-Gaussian model is dim 1 + n; the
            # whitened state-space form keeps it exact at O(n log n)
            return pick("sde", "non-Gaussian whitened latent at state-space "
                               "cost (dense joint NUTS is dim 1+n)")
        return pick("none", f"dense exact path up to n = {DENSE_MAX_N}")
    if has_sde:
        if d <= SDE_SAMPLING_MAX_D or forward_only:
            why = f"O(n log n) state-space path above n = {DENSE_MAX_N}"
            if forward_only and d > SDE_SAMPLING_MAX_D:
                why = ("forward-only smoothing keeps high-d products "
                       "practical (O(n d^2), no gradient tape)")
            return pick("sde", why)
        # high-d product and a gradient-based command: the sde cost grows as d³
        if n <= DENSE_HIGH_D_MAX_N:
            return pick("none", f"state dim {d} > {SDE_SAMPLING_MAX_D}: "
                                "sde gradients cost d^3 a step — dense for "
                                f"sampling up to n = {DENSE_HIGH_D_MAX_N}")
        if gaussian:
            return pick("rff", f"state dim {d} > {SDE_SAMPLING_MAX_D} and "
                               f"n > {DENSE_HIGH_D_MAX_N}: feature-space "
                               "marginal is the remaining tractable path")
        return pick("none", "non-Gaussian high-d product at large n: no "
                            "fast exact path — expect a slow run")
    if not gaussian:
        if command == "mcmc" and n > DENSE_MAX_N:
            return pick("laplace", f"no state-space form ({st_or_reason}); "
                                   "non-Gaussian rff marginal does not "
                                   "exist — Laplace keeps NUTS dim at "
                                   "#hyperparams")
        return pick("none", "non-Gaussian likelihood: exact whitened path")
    return pick("rff", f"no state-space form for this formula ({st_or_reason})")


def resolve_auto_approx(args, ck, X, command, spec, dynamic_slots: Sequence[int] = ()) -> None:
    """Set ``args.approx`` in place when it is 'auto' (the commands' hook)."""
    if args.approx == "auto":
        args.approx = choose_approx(ck, X, command, likelihood=spec.likelihood,
                                    dynamic_slots=dynamic_slots)


#: the SqExp order-6 block's lp error grows past ~0.5 nats once the
#: lengthscale passes about a third of the input span
SQEXP_GUARD_SPAN_FRACTION = 1.0 / 3.0

#: warn when at least this fraction of posterior draws sits in that band
SQEXP_GUARD_MASS = 0.10


def sde_lengthscale_guard(ck, st, X, thetas, slot_groups) -> Optional[str]:
    """Warn when sampled SqExp/RQ lengthscales wander into the >0.5-nat
    error band of the spectral-Taylor block (l >~ span/3).

    ``thetas``: (chains, draws, n_hyper) constrained draws; ``slot_groups``:
    the leaf-slot group of each theta entry.  Returns the warning (also
    logged) or None."""
    X = np.asarray(X)
    thetas = np.asarray(thetas)
    if st is None or not len(slot_groups):
        return None
    span = None
    if st.time_col >= 0:
        t = X[:, st.time_col].astype(float)
        # per-group span when the Markov axis restarts per Cat group
        if st.markov_gcols:
            key = X[:, list(st.markov_gcols)]
            spans = []
            for lev in np.unique(key, axis=0):
                m = np.all(key == lev, axis=1)
                if m.any():
                    spans.append(t[m].max() - t[m].min())
            span = float(np.median(spans)) if spans else None
        else:
            span = float(t.max() - t.min())
    if not span or span <= 0:
        return None
    bad_leaves = {li for li, k in enumerate(ck.kinds) if k in (K_SQEXP, K_RQ)}
    if not bad_leaves:
        return None
    threshold = SQEXP_GUARD_SPAN_FRACTION * span
    worst = None
    for g, slots in enumerate(slot_groups):
        if g >= thetas.shape[-1] or not any(s in bad_leaves for s in slots):
            continue
        frac = float(np.mean(thetas[..., g] > threshold))
        if frac >= SQEXP_GUARD_MASS and (worst is None or frac > worst[1]):
            worst = (g, frac)
    if worst is None:
        return None
    g, frac = worst
    msg = (
        f"--approx sde accuracy guard: {100 * frac:.0f}% of posterior "
        f"draws for hyperparameter group {g + 1} exceed l = span/3 = "
        f"{threshold:.3g} (input span {span:.3g}), where the SqExp/RQ "
        "spectral-Taylor block's marginal-likelihood error exceeds ~0.5 "
        "nats (measured: +1.36 nats at l ~ span). Bayes factors and lp "
        "values may be biased — re-run with --approx none (dense) or "
        "--approx rff for this formula."
    )
    log.warning("%s", msg)
    return msg
