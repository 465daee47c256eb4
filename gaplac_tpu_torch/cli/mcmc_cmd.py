"""`mcmc` command: posterior over kernel hyperparameters on the dense exact
model, on the low-rank feature-space marginal with ``--approx rff``
(``--rff-features``, ``--rff-seed``), on the Laplace marginal with
``--approx laplace``, or on the state-space models with ``--approx sde``
(the marginal, the Laplace marginal for non-Gaussian likelihoods, the
whitened model with ``--no-marginalize``; the SqExp/RQ lengthscale guard
warns after sampling); ``--approx auto`` routes by ``inference/routing.py``
(port of ``gaplac_tpu/cli/mcmc_cmd.py``).

Same model defaults as the reference (prior Uniform(0,20), latent jitter 0.1,
obs sigma 1, one shared scalar for all --infer vars), the same chain-table
schema, and ``--checkpoint/--resume`` in the same ``.npz`` format, so a
checkpoint written by ``gaplac_tpu`` resumes here and the other way round.
Gaussian likelihoods are marginalized unless ``--no-marginalize``.
NUTS chains run one after another, each on its own generator seeded from
``--seed`` (one seed a chain, as ``gaplac_tpu`` splits one key a chain), so
a chain draws the same numbers whichever rank runs it; ChEES and
fixed-trajectory HMC (``--sampler hmc``, in segments with ``--segments``)
move all chains in lockstep; ``--sampler advi`` fits a mean-field Gaussian
and reports pseudodraws.

In a multi-process run (``GAPLAC_*``, ``parallel/multihost.py``) the NUTS
chains are sharded over the ranks when their count divides the world size
(``parallel/mesh.py``; else every rank runs every chain), and the results
are gathered in chain order on every rank, as ``gaplac_tpu`` shards its
NUTS path; ChEES, HMC and ADVI run whole on every rank.  Only rank 0
writes the table, the checkpoint and the plot, and prints the summary.

``--check-numerics`` checks, for NaN, the arrays that ``gaplac_tpu``'s
``jax_debug_nans`` checks: the outputs of its jitted sampler run and chain
report (positions, log densities, accept probabilities, step sizes, mass,
thetas, latents; ADVI's fit and draws).  A NaN inside a rejected proposal
does not reach them, in either package.  The phases of ``--profile`` carry
``gaplac_tpu``'s names, "+compile" included, though nothing compiles here.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import pandas as pd
import torch

from gaplac_tpu_torch.data import df_output, load_tables, read_table
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.cli.common import (
    apply_outlier_policy,
    column_values,
    design_matrix,
    resolve_hyper_columns,
    response_vector,
)
from gaplac_tpu_torch.inference.diagnostics import summarize
from gaplac_tpu_torch.inference.likelihoods import gaussian_obs_sigma2
from gaplac_tpu_torch.inference.model import build_model, slot_groups_for
from gaplac_tpu_torch.inference.nuts import run_nuts
from gaplac_tpu_torch.inference.priors import parse_prior
from gaplac_tpu_torch.inference.routing import (
    choose_approx,
    sde_lengthscale_guard,
    sde_structure_info,
)
from gaplac_tpu_torch.kernels.covariance import compile_formula
from gaplac_tpu_torch.parallel.mesh import (
    chain_mesh,
    gather_chain_axis,
    shard_chain_axis,
    shards_evenly,
)
from gaplac_tpu_torch.parallel.multihost import is_primary
from gaplac_tpu_torch.runtime import Runtime
from gaplac_tpu_torch.utils import profiling

log = logging.getLogger("gaplac")

HYPER_COL = "ℓ"  # reference chain schema (Turing's ℓ column)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_numerics(args, arrays) -> None:
    """With --check-numerics, raise FloatingPointError naming the first of
    ``arrays`` ((name, tensor, array or number) pairs) that holds a NaN."""
    if not args.check_numerics:
        return
    for name, a in arrays:
        if a is None:
            continue
        t = torch.as_tensor(a)
        if t.is_floating_point():
            bad = torch.isnan(t)
            if bool(bad.any()):
                where = tuple(int(i) for i in bad.nonzero()[0]) if t.dim() else ()
                raise FloatingPointError(
                    f"--check-numerics: invalid value (nan) in the {name}"
                    + (f", first at index {where}" if where else "")
                    + f" ({int(bad.sum())} of {t.numel()})")


def run(args, rt: Runtime) -> None:
    log.info("running 'mcmc'")
    if args.check_numerics:
        log.info("numerics checking enabled (NaN in the sampler's and the report's arrays)")
    spec = parse_formula(args.formula)
    df = apply_outlier_policy(load_tables(args.data), args, spec.response)
    ck = compile_formula(spec.formula)
    inferable = list(args.infer or [])
    infer_extras = list(args.infer_extra or [])
    if not inferable and not infer_extras:
        raise ValueError("mcmc needs --infer and/or --infer-extra")

    device, dtype = rt
    y = torch.tensor(response_vector(df, spec), dtype=dtype, device=device)
    X = torch.tensor(design_matrix(df, ck), dtype=dtype, device=device)
    aux = None
    if spec.likelihood.colref is not None:
        aux = torch.tensor(column_values(df, spec.likelihood.colref), dtype=dtype,
                           device=device)
    prior_bounds = parse_prior(args.prior)
    shared = args.infer_mode == "shared"
    if args.approx in ("auto", "sde"):
        try:
            groups = slot_groups_for(ck, inferable, shared=shared, infer_extras=infer_extras)
        except ValueError:
            groups = ()
        X_np = X.cpu().numpy()
        dynamic = {s for g in groups for s in g}
        if args.approx == "auto":
            args.approx = choose_approx(ck, X_np, "mcmc", likelihood=spec.likelihood,
                                        dynamic_slots=dynamic)
        if args.approx == "sde":
            # what the accuracy guard reads after sampling
            d_g, _, st_g = sde_structure_info(ck, X_np, dynamic)
            args._sde_guard = (ck, X_np, st_g, groups) if d_g is not None and groups else None
    if args.approx == "laplace":
        from gaplac_tpu_torch.inference.laplace import build_laplace_marginal

        if gaussian_obs_sigma2(spec.likelihood) is not None:
            raise ValueError(
                "--approx laplace is for non-Gaussian likelihoods; Gaussian "
                "data already uses the exact marginalized path"
            )
        model = build_laplace_marginal(
            ck, slot_groups_for(ck, inferable, shared=shared, infer_extras=infer_extras), X,
            y, spec.likelihood, aux=aux, jitter=args.jitter, prior_bounds=prior_bounds,
        )
    else:
        model = build_model(
            ck, inferable, X, y, spec.likelihood, aux=aux, jitter=args.jitter,
            prior_bounds=prior_bounds, shared_hyper=shared,
            marginalize=not args.no_marginalize,
            approx=args.approx if args.approx in ("rff", "sde") else "exact",
            rff_features=args.rff_features, rff_seed=args.rff_seed, infer_extras=infer_extras,
        )
    log.info("model: %s, sampler dim %d, n=%d obs",
             "marginalized" if model.marginalized else "whitened latent", model.dim, y.shape[0])

    num_samples = args.samples
    num_warmup = args.warmup if args.warmup is not None else max(num_samples, 200)
    if args.burnin and args.burnin >= num_samples:
        raise ValueError(
            f"--burnin ({args.burnin}) must be smaller than --samples "
            f"({num_samples}); no draws would remain"
        )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.sampler == "advi":
        if args.resume or args.checkpoint:
            log.warning("--resume/--checkpoint are not supported with --sampler advi; "
                        "ignored (starting fresh, no checkpoint written)")
        _run_advi_path(args, model, y, num_samples, gen)
        return
    if args.sampler in ("chees", "hmc"):
        _run_lockstep_path(args, model, y, num_samples, num_warmup, gen, rt)
        return

    n_chains = args.chains
    init_positions = model.initial_position(gen, n_chains)
    # one generator a chain, for its sampler and its report draws
    seeds = torch.randint(0, 2**62, (n_chains,), generator=gen, device=device).tolist()
    resume_state = None
    if args.resume:
        if args.resume.endswith((".tsv", ".csv")):
            init_positions = _resume_from_chain(args.resume, model, n_chains)
            num_warmup = min(num_warmup, 100)
            log.info("extending chain %s (reduced warmup %d)", args.resume, num_warmup)
        else:
            resume_state = _load_checkpoint(args.resume, n_chains, model.dim)
            init_positions = torch.as_tensor(resume_state["positions"], dtype=dtype,
                                             device=device)
            num_warmup = 0
            log.info("resuming from %s (warmup skipped)", args.resume)

    def chain_density(q):
        return model.logdensity(q[None])[0]

    # this rank's chains (all of them without a mesh, or when they do not
    # divide over it), gathered back in chain order after the report
    mesh = chain_mesh() if torch.distributed.is_initialized() else None
    ids = shard_chain_axis(torch.arange(n_chains), mesh=mesh).tolist()
    mesh = mesh if shards_evenly(n_chains, mesh) else None
    gens = {c: torch.Generator(device=device).manual_seed(seeds[c]) for c in ids}
    t0 = time.time()
    results = []
    with profiling.phase("mcmc.sample+compile"):
        for c in ids:
            eps0 = im0 = None
            if resume_state is not None:
                eps0 = float(resume_state["step_size"])
                im = np.asarray(resume_state["inv_mass"])
                im0 = torch.as_tensor(im[c] if im.ndim == 2 else im, dtype=dtype,
                                      device=device)
            results.append(run_nuts(
                gens[c], chain_density, init_positions[c], num_samples,
                num_warmup=num_warmup, max_depth=args.max_depth,
                target_accept=args.target_accept,
                # the chains run in turn, so each prints its own progress lines
                initial_step_size=eps0, initial_inv_mass=im0, progress=args.progress,
            ))
        _sync(device)
    elapsed = time.time() - t0
    total = len(ids) * (num_samples + num_warmup)
    log.info("sampling done in %.2fs (%.1f transitions/s; %d divergences)", elapsed,
             total / elapsed, int(sum(r.diverging.sum() for r in results)))

    def gathered(arrays, dtype=dtype):
        return gather_chain_axis(torch.stack([torch.as_tensor(a, dtype=dtype, device=device)
                                              for a in arrays]), mesh).cpu()

    sl = slice(args.burnin, None, args.thin)
    positions = gathered([r.positions for r in results])
    # per draw: accept probability, tree depth, divergence (exact in float64)
    per_draw = gathered([np.stack([r.accept_prob, r.depths, r.diverging], axis=1)
                         for r in results], torch.float64).numpy()
    step_sizes = gathered([r.step_size for r in results], torch.float64).numpy()
    inv_mass = gathered([r.inv_mass for r in results])
    check_numerics(args, [
        ("sampler's positions", positions),
        ("sampler's log densities", gathered([r.logps for r in results])),
        ("sampler's accept probabilities", per_draw[..., 0]),
        ("sampler's step sizes", step_sizes),
        ("sampler's inverse mass", inv_mass),
    ])

    with profiling.phase("mcmc.report"):
        reports = [_report(model, gens[c], r.positions[sl]) for c, r in zip(ids, results)]
        thetas, fs, lps = (None if k == 1 and args.no_latents
                           else gathered([rep[k] for rep in reports]).numpy() for k in range(3))
    check_report_numerics(args, thetas, fs, lps)
    if args.checkpoint and is_primary():
        _save_checkpoint(args.checkpoint, positions[:, sl], step_size=step_sizes,
                         inv_mass=inv_mass)
        log.info("checkpoint written to %s", args.checkpoint)
    _emit_chains(args, model, y.shape[0], thetas, fs, lps, accepts=per_draw[:, sl, 0],
                 depths=per_draw[:, sl, 1].astype(np.int32), divs=per_draw[:, sl, 2] != 0)


def check_report_numerics(args, thetas, fs, lps) -> None:
    check_numerics(args, [("report's thetas", thetas), ("report's latents", fs),
                          ("report's log densities", lps)])


def _report(model, gen, flat):
    """(draws, dim) positions -> thetas, latents, lps on the device, in
    batches of the model's report_batch draws."""
    B = model.report_batch
    parts = [model.report(gen, flat[i:i + B]) for i in range(0, flat.shape[0], B)]
    if not parts:
        return flat.new_zeros((0, model.n_hyper)), flat.new_zeros((0, 0)), flat.new_zeros((0,))
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


def _chain_report(model, gen, positions, want_latents=True):
    """(chains, draws, dim) positions -> numpy thetas, latents, lps, the
    draws of all chains in one stream from ``gen``."""
    C, kept, dim = positions.shape
    out = [t.cpu().numpy().reshape((C, kept) + tuple(t.shape[1:]))
           for t in _report(model, gen, positions.reshape(C * kept, dim))]
    return out[0], (out[1] if want_latents else None), out[2]


def _emit_chains(args, model, n_obs, thetas, fs, lps, accepts=None, depths=None, divs=None,
                 step_size=None, traj_length=None):
    """Write the reference-schema chain table and print the posterior summary.

    thetas (chains, draws, n_hyper), fs (chains, draws, n), lps (chains,
    draws); NUTS adds per-draw ``depths``/``divs``, ChEES the adapted
    ``step_size`` and ``traj_length`` as scalar-repeat columns.  Only rank 0
    of a multi-process run writes and prints.
    """
    if not is_primary():
        return
    n_chains, kept = lps.shape
    frames = []
    for c in range(n_chains):
        cols = {
            "iteration": np.arange(1, kept + 1),
            "chain": np.full(kept, c + 1),
            HYPER_COL: thetas[c, :, 0],
        }
        for g in range(1, model.n_hyper):
            cols[f"{HYPER_COL}_{g+1}"] = thetas[c, :, g]
        if not getattr(args, "no_latents", False):
            for i in range(n_obs):
                cols[f"fx[{i+1}]"] = fs[c, :, i]
        cols["lp"] = lps[c]
        if accepts is not None:
            cols["acceptance_rate"] = accepts[c]
        if depths is not None:
            cols["tree_depth"] = depths[c]
        if divs is not None:
            cols["numerical_error"] = divs[c].astype(int)
        if step_size is not None:
            cols["step_size"] = np.full(kept, float(step_size))
        if traj_length is not None:
            cols["traj_length"] = np.full(kept, float(traj_length))
        frames.append(pd.DataFrame(cols))
    chain_df = pd.concat(frames, ignore_index=True)
    df_output(chain_df, args.output)

    # sde accuracy guard: SqExp/RQ lengthscale mass in the >0.5-nat error band
    guard_info = getattr(args, "_sde_guard", None)
    if guard_info is not None:
        gck, gX, gst, ggroups = guard_info
        msg = sde_lengthscale_guard(gck, gst, gX, thetas, ggroups)
        if msg:
            print(f"WARNING: {msg}")

    for g in range(model.n_hyper):
        name = HYPER_COL if g == 0 else f"{HYPER_COL}_{g+1}"
        s = summarize(name, thetas[:, :, g])
        log.info("%s: mean %.4f  sd %.4f  5%%..95%% [%.3f, %.3f]  Rhat %.3f  ESS %.0f",
                 name, s["mean"], s["std"], s["q5"], s["q95"], s["rhat"], s["ess"])
        print(
            f"posterior {name}: mean {s['mean']:.4f} sd {s['std']:.4f} "
            f"[{s['q5']:.3f}, {s['q95']:.3f}]"
            + (f" Rhat {s['rhat']:.3f} ESS {s['ess']:.0f}" if n_chains > 1 else "")
        )

    if args.plot:
        from gaplac_tpu_torch.viz.plots import pyplot, trace_plot

        names = [HYPER_COL] + [f"{HYPER_COL}_{g+1}" for g in range(1, model.n_hyper)]
        fig = trace_plot(thetas, names)
        fig.savefig(args.plot, dpi=120)
        pyplot().close(fig)
        log.info("Saved trace plot to %s", args.plot)


def _run_lockstep_path(args, model, y, num_samples, num_warmup, gen, rt: Runtime):
    """The lockstep samplers: --sampler chees (cross-chain step-size and
    trajectory adaptation, inference/chees.py::run_chees) and --sampler hmc
    (fixed --leapfrogs trajectories, run_hmc, in segments with --segments)."""
    from gaplac_tpu_torch.inference.chees import run_chees, run_hmc

    device, dtype = rt
    kind = args.sampler
    n_chains = args.chains
    if kind == "chees" and n_chains < 4:
        log.warning("ChEES adapts its trajectory length from cross-chain statistics; "
                    "--chains %d is small, using 8", n_chains)
        n_chains = max(n_chains, 8)
    q0 = model.initial_position(gen, n_chains)
    eps0, t_len0, im0 = 0.1, 1.0, None
    if args.resume:
        if args.resume.endswith((".tsv", ".csv")):
            q0 = _resume_from_chain(args.resume, model, n_chains)
            num_warmup = min(num_warmup, 100)
            log.info("extending chain %s (reduced warmup %d)", args.resume, num_warmup)
        else:
            state = _load_checkpoint(args.resume, n_chains, model.dim)
            q0 = torch.as_tensor(state["positions"], dtype=dtype, device=device)
            eps0 = float(np.mean(np.asarray(state["step_size"])))
            im = np.asarray(state["inv_mass"])
            im0 = torch.as_tensor(im.mean(0) if im.ndim == 2 else im, dtype=dtype,
                                  device=device)
            t_len0 = float(np.mean(np.asarray(state.get("traj_length", t_len0))))
            num_warmup = 0
            log.info("resuming from %s (warmup skipped)", args.resume)

    segments = args.segments
    if kind == "hmc":
        if segments is None:
            segments = 25 if y.shape[0] >= (1 << 18) else 0
            if segments:
                log.info("n=%d >= 2^18: segmented sampling on (--segments %d; 0 forces one "
                         "run)", y.shape[0], segments)
    elif segments:
        log.warning("--segments only applies to --sampler hmc; ignored")
        segments = 0

    t0 = time.time()
    with profiling.phase("mcmc.hmc-segmented+compile" if kind == "hmc" and segments
                         else f"mcmc.{kind}+compile"):
        if kind == "hmc":
            ckpt_cb = None
            if segments and args.checkpoint and is_primary():
                def ckpt_cb(state):
                    np.savez(args.checkpoint, **state)

            res = run_hmc(gen, model.logdensity, q0, num_samples, num_warmup=num_warmup,
                          num_leapfrogs=args.leapfrogs, target_accept=args.target_accept,
                          init_step_size=eps0, init_inv_mass=im0, progress=args.progress,
                          segment_size=segments or None, checkpoint_cb=ckpt_cb)
        else:
            res = run_chees(gen, model.logdensity, q0, num_samples, num_warmup=num_warmup,
                            target_accept=args.target_accept, init_step_size=eps0,
                            init_traj_length=t_len0, init_inv_mass=im0,
                            progress=args.progress)
        _sync(device)
    elapsed = time.time() - t0
    traj_length = getattr(res, "traj_length", None)
    total = n_chains * (num_samples + num_warmup)
    log.info("%s: %d chains x %d transitions in %.2fs (%.1f transitions/s; eps %.4f, "
             "T %.3f, accept %.2f)", kind, n_chains, num_samples + num_warmup, elapsed,
             total / elapsed, res.step_size,
             traj_length if traj_length is not None else args.leapfrogs * res.step_size,
             float(res.accept_prob.mean()) if res.accept_prob.numel() else float("nan"))

    check_numerics(args, [
        ("sampler's positions", res.positions), ("sampler's log densities", res.logps),
        ("sampler's accept probabilities", res.accept_prob),
        ("sampler's step size", res.step_size), ("sampler's trajectory length", traj_length),
        ("sampler's inverse mass", res.inv_mass),
    ])
    sl = slice(args.burnin, None, args.thin)
    positions = res.positions[:, sl]
    thetas, fs, lps = _chain_report(model, gen, positions, want_latents=not args.no_latents)
    check_report_numerics(args, thetas, fs, lps)
    if args.checkpoint and is_primary():
        _save_checkpoint(args.checkpoint, positions, step_size=np.asarray(res.step_size),
                         inv_mass=res.inv_mass, traj_length=traj_length)
        log.info("checkpoint written to %s", args.checkpoint)
    _emit_chains(args, model, y.shape[0], thetas, fs, lps,
                 accepts=res.accept_prob[:, sl].cpu().numpy(), step_size=res.step_size,
                 traj_length=traj_length)


def _run_advi_path(args, model, y, num_samples, gen):
    """--sampler advi: fit the mean-field q, then --chains x --samples
    pseudodraws from it in the chain schema."""
    from gaplac_tpu_torch.inference.vi import run_advi, sample_posterior

    t0 = time.time()
    result = run_advi(gen, model, num_steps=args.vi_steps)
    elbo = float(result.elbo_trace[-1])
    log.info("ADVI: %d steps in %.2fs, final ELBO %.3f", args.vi_steps, time.time() - t0, elbo)
    if is_primary():
        print(f"ADVI converged: final ELBO {elbo:.3f}")
    draws = sample_posterior(gen, result, args.chains * num_samples)
    draws = draws.reshape(args.chains, num_samples, model.dim)
    check_numerics(args, [("ADVI fit's mean", result.mu), ("ADVI fit's log scale",
                                                             result.log_sigma),
                          ("ADVI fit's ELBO trace", result.elbo_trace),
                          ("ADVI draws", draws)])
    thetas, fs, lps = _chain_report(model, gen, draws, want_latents=not args.no_latents)
    check_report_numerics(args, thetas, fs, lps)
    _emit_chains(args, model, y.shape[0], thetas, fs, lps)


def _resume_from_chain(path: str, model, n_chains: int) -> torch.Tensor:
    """Warm-start positions from a previous chain table's last row(s)."""
    df = read_table(path)
    hyper_cols = resolve_hyper_columns(df, model.n_hyper, path)
    fx_cols = sorted((c for c in df.columns if c.startswith("fx[")), key=lambda c: int(c[3:-1]))
    groups = [g for _, g in df.groupby("chain", sort=True)] if "chain" in df.columns else [df]
    positions = []
    for c in range(n_chains):
        row = groups[c % len(groups)].iloc[-1]
        theta = row[hyper_cols].to_numpy(dtype=float)
        f = row[fx_cols].to_numpy(dtype=float) if fx_cols else np.zeros((0,))
        positions.append(model.position_from(torch.tensor(theta), torch.tensor(f)))
    return torch.stack(positions)


def _save_checkpoint(path: str, positions: torch.Tensor, step_size, inv_mass,
                     traj_length=None) -> None:
    """The ``gaplac_tpu`` checkpoint: the last kept position per chain, the
    adapted step size and mass (per chain for NUTS), and ChEES's T."""
    extra = {} if traj_length is None else {"traj_length": np.asarray(traj_length)}
    np.savez(path, positions=positions[:, -1].cpu().numpy(), step_size=np.asarray(step_size),
             inv_mass=inv_mass.cpu().numpy(), **extra)


def _load_checkpoint(path: str, n_chains: int, dim: int) -> dict:
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    z = np.load(path)
    pos = z["positions"]
    if pos.shape != (n_chains, dim):
        raise ValueError(
            f"Checkpoint shape {pos.shape} does not match --chains {n_chains} "
            f"and model dim {dim}"
        )
    out = {
        "positions": pos,
        "step_size": np.mean(z["step_size"]),
        "inv_mass": z["inv_mass"],
    }
    if "traj_length" in z.files:
        out["traj_length"] = np.asarray(z["traj_length"])
    return out
