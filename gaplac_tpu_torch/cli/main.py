"""gaplac CLI of the PyTorch/CUDA port: argument schema and dispatch (port of
``gaplac_tpu/cli/main.py``).

The five commands (``sample``, ``mcmc``, ``select``, ``predict`` and
``fitplot``) are ported on the dense exact model (``--approx none``, and
``mcmc --approx laplace``), the low-rank feature path (``--approx rff``)
and the state-space path (``--approx sde``, with its ``--sde-*`` knobs), and
``--approx auto`` routes between them, with every sampler and estimator and
the flags and defaults of ``gaplac_tpu``, ``--profile``/``--profile-dir``
(``utils/profiling.py``) and ``mcmc --check-numerics`` among them.  The
commands run on the card; without one they refuse to start unless given
``--platform cpu``.
matplotlib is needed only for ``--plot`` and ``fitplot``.

Run as ``python -m gaplac_tpu_torch.cli.main <command> ...``.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gaplac",
        description="Gaussian-Process inference for longitudinal analysis of "
        "compositional data (GaPLAC-compatible formula DSL), on PyTorch/CUDA.",
        epilog="Kernels: SqExp(:x; l) | OU(:x; l) | Linear(:x; c) | Cat(:x) | "
        "Noise | Constant | 1(c) | Matern32(:x; l) | Matern52(:x; l) | "
        "Periodic(:x; l, p) | RQ(:x; l, alpha).  The lengthscale-class "
        "hyperparameter l (and Linear's c, Noise's s2) is chain-sampled via "
        "--infer; Periodic's period p and RQ's alpha are shape parameters, "
        "static at the formula's value unless listed in --infer-extra.",
    )
    p.add_argument("-v", "--verbose", action="store_true", help="Log level to info")
    p.add_argument("-q", "--quiet", action="store_true", help="Log level to error")
    p.add_argument("--debug", action="store_true", help="Log level to debug")
    p.add_argument("--log", help="Log to a file as well as stderr")
    p.add_argument("--platform", choices=["cpu", "cuda"], default=None,
                   help="Torch device (default: cuda; without a CUDA device the "
                   "commands run only with --platform cpu)")
    p.add_argument("--precision", choices=["f32", "f64"], default=None,
                   help="Compute precision (default: f64 on CPU, f32 on CUDA)")
    p.add_argument("--profile", action="store_true",
                   help="Print a phase wall-clock breakdown")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="Also write a torch.profiler trace (CPU and CUDA) to DIR, as a "
                   "*.pt.trace.json that TensorBoard and Perfetto read")

    sub = p.add_subparsers(dest="command", metavar="{sample,mcmc,select,predict,fitplot}")

    ps = sub.add_parser("sample", help="Sample from the GP prior at given inputs")
    ps.add_argument("spec", help="GP formula specification, e.g. \"y :~| SqExp(:x; l=1)\"")
    ps.add_argument("--at", help="Range to sample at, eg 'x=-5:0.1:5' "
                    "(grouped 'var/group=...' supported)")
    ps.add_argument("--atdata", help="Table of points to sample at (alternative to --at)")
    ps.add_argument("-i", "--data",
                    help="Training data: when given, sample the POSTERIOR GP conditioned "
                    "on it")
    ps.add_argument("-m", "--mcmc",
                    help="MCMC chain of hyperparameter draws (with --data); one chain row "
                    "is drawn per sample")
    ps.add_argument("--infer", nargs="+", default=None,
                    help="Variables the --mcmc chain inferred (as in the mcmc run)")
    ps.add_argument("--infer-mode", choices=["shared", "pervar"], default="shared")
    ps.add_argument("--infer-extra", nargs="+", default=None, metavar="VAR",
                    help="Variables whose shape parameters (Periodic period, RQ alpha) "
                    "the --mcmc chain inferred (match the mcmc run)")
    ps.add_argument("--plot", help="File to plot to")
    ps.add_argument("--plotx", help="Plot x axis: 'x' or 'x:group' (legacy --plotx)")
    ps.add_argument("-o", "--output", help="Table output - '.csv', '.tsv', or 'stdout'")
    ps.add_argument("--seed", type=int, default=None, help="PRNG seed")
    ps.add_argument("--jitter", type=float, default=0.1, help="Latent GP noise floor")
    ps.add_argument("--approx", choices=["none", "rff", "sde", "auto"], default="none",
                    help="none: the dense exact model; rff: random Fourier features, the "
                    "O(n m^2) low-rank path for large n; sde: the O(n log n) state-space "
                    "path for formulas with a state-space form; auto: routed by n, the "
                    "formula and the command")
    ps.add_argument("--rff-features", type=int, default=256, metavar="M",
                    help="Features per stationary kernel leaf with --approx rff")
    ps.add_argument("--rff-seed", type=int, default=0)
    _add_sde_flags(ps)
    _add_outlier_flags(ps)

    pm = sub.add_parser("mcmc", help="Run MCMC (NUTS) over kernel hyperparameters")
    pm.add_argument("formula", help="GP formula specification")
    pm.add_argument("-i", "--data", required=True, help="Table input for inference")
    pm.add_argument("--infer", nargs="+", default=None,
                    help="Variable names whose kernel hyperparameter to infer "
                    "(this and/or --infer-extra is required)")
    pm.add_argument("--samples", type=int, default=200,
                    help="Number of posterior samples (default 200)")
    pm.add_argument("-o", "--output", help="Table to output sampling chain")
    pm.add_argument("--plot", help="File to plot traces to")
    pm.add_argument("--warmup", type=int, default=None,
                    help="Warmup iterations (default: max(samples, 200))")
    pm.add_argument("--chains", type=int, default=1, help="Number of chains")
    pm.add_argument("--seed", type=int, default=0, help="PRNG seed")
    pm.add_argument("--target-accept", type=float, default=0.65)
    pm.add_argument("--max-depth", type=int, default=10)
    pm.add_argument("--no-marginalize", action="store_true",
                    help="Sample latents jointly (reference formulation) even for "
                    "Gaussian likelihoods")
    pm.add_argument("--sampler", choices=["nuts", "chees", "hmc", "advi"], default="nuts",
                    help="nuts (default; chains run one after another), chees "
                    "(cross-chain adaptive HMC, all chains in lockstep; wants "
                    "--chains >= 8), hmc (fixed --leapfrogs trajectories, chains in "
                    "lockstep) or advi (mean-field variational fit; --chains x "
                    "--samples pseudodraws)")
    pm.add_argument("--leapfrogs", type=int, default=32,
                    help="Leapfrog steps per --sampler hmc trajectory")
    pm.add_argument("--segments", type=int, default=None, metavar="S",
                    help="--sampler hmc in segments of S transitions, a checkpoint "
                    "after each sampling segment (default: 25 when n >= 2^18, else "
                    "off; 0 forces one run); the draws equal the unsegmented run's")
    pm.add_argument("--infer-mode", choices=["shared", "pervar"], default="shared",
                    help="shared (reference parity: ONE scalar for all --infer vars) "
                    "or pervar (one hyperparameter per distinct variable)")
    pm.add_argument("--infer-extra", nargs="+", default=None, metavar="VAR",
                    help="Also infer the shape parameters (Periodic's period p, "
                    "RQ's alpha) of kernels on these variables")
    pm.add_argument("--progress", action="store_true",
                    help="Print sampler progress lines to stderr")
    pm.add_argument("--check-numerics", action="store_true",
                    help="Raise FloatingPointError, before any table is written, when the "
                    "sampler's or the chain report's arrays hold a NaN (gaplac_tpu's "
                    "jax_debug_nans checks the same arrays)")
    pm.add_argument("--approx", choices=["none", "laplace", "rff", "sde", "auto"],
                    default="none",
                    help="none: the dense exact model; laplace: the Laplace marginal "
                    "over theta for non-Gaussian likelihoods; rff: random Fourier "
                    "features, the O(n m^2) low-rank marginal for large n (Gaussian "
                    "likelihoods); sde: the O(n log n) state-space models (the Laplace "
                    "marginal for non-Gaussian likelihoods, the whitened model with "
                    "--no-marginalize); auto: routed by n, the formula and the likelihood")
    pm.add_argument("--rff-features", type=int, default=256, metavar="M",
                    help="Features per stationary kernel leaf with --approx rff")
    pm.add_argument("--rff-seed", type=int, default=0,
                    help="Feature-frequency PRNG seed with --approx rff")
    pm.add_argument("--no-latents", action="store_true",
                    help="Omit the fx[i] latent columns from the chain table")
    pm.add_argument("--vi-steps", type=int, default=2000,
                    help="ADVI optimization steps (with --sampler advi)")
    pm.add_argument("--burnin", type=int, default=0,
                    help="Additional draws to discard post-warmup (legacy --burnin)")
    pm.add_argument("--thin", type=int, default=1, help="Keep every k-th draw (legacy --thin)")
    pm.add_argument("--prior", default="Uniform(0,20)",
                    help="Prior for inferred hyperparameters: Uniform(lo,hi) "
                    "[reference default Uniform(0,20)], LogNormal(mu,sigma), "
                    "Gamma(alpha,rate), TruncatedNormal(mu,sigma,lo,hi)")
    pm.add_argument("--jitter", type=float, default=0.1, help="Latent GP noise floor")
    pm.add_argument("--checkpoint", help="Path to write sampler-state checkpoints")
    pm.add_argument("--resume", help="Resume/extend from a checkpoint or previous chain output")
    _add_sde_flags(pm)
    _add_outlier_flags(pm)

    pl = sub.add_parser("select", help="Model selection (log2 Bayes factors)")
    pl.add_argument("--formulae", nargs=2, metavar=("F1", "F2"),
                    help="Compare 2 formulas on --data at fixed hyperparameters")
    pl.add_argument("--chains", nargs=2, metavar=("C1", "C2"),
                    help="Compare 2 mcmc chain outputs (marginal-likelihood estimate)")
    pl.add_argument("-i", "--data", help="Table input (required with --formulae)")
    pl.add_argument("--plot", help="File to plot to")
    pl.add_argument("--estimator", choices=["harmonic", "smc"], default="harmonic",
                    help="harmonic (--chains; reference parity) or smc: a tempered-SMC "
                    "marginal likelihood over the hyperparameter prior (--formulae mode)")
    pl.add_argument("--infer", nargs="+", default=None,
                    help="With --estimator smc: variables whose hyperparameter to "
                    "integrate over (default: all lengthscale-kind leaves)")
    pl.add_argument("--infer-extra", nargs="+", default=None, metavar="VAR",
                    help="With --estimator smc: also integrate over these variables' "
                    "shape parameters")
    pl.add_argument("--particles", type=int, default=512, help="SMC particle count")
    pl.add_argument("--approx", choices=["none", "rff", "sde", "auto"], default="none",
                    help="none: the dense exact model; rff: random Fourier features, the "
                    "O(n m^2) low-rank path for large n; sde: the O(n log n) state-space "
                    "path for formulas with a state-space form; auto: routed by n, the "
                    "formula and the command")
    pl.add_argument("--rff-features", type=int, default=256, metavar="M",
                    help="Features per stationary kernel leaf with --approx rff")
    pl.add_argument("--rff-seed", type=int, default=0)
    pl.add_argument("--seed", type=int, default=0)
    pl.add_argument("--jitter", type=float, default=0.1)
    _add_sde_flags(pl)

    pp = sub.add_parser("predict", help="Posterior predictions at --at/--atdata points")
    pp.add_argument("formula", help="GP formula specification")
    pp.add_argument("-i", "--data", required=True, help="Training data table")
    pp.add_argument("-m", "--mcmc", help="MCMC chain table (hyperparameter draws); "
                    "defaults to the formula's fixed hyperparameters")
    pp.add_argument("--infer", nargs="+", default=None,
                    help="Variables whose hyperparameter the chain inferred "
                    "(same as the mcmc run that produced --mcmc)")
    pp.add_argument("--infer-mode", choices=["shared", "pervar"], default="shared",
                    help="Match the mcmc run's --infer-mode")
    pp.add_argument("--infer-extra", nargs="+", default=None, metavar="VAR",
                    help="Match the mcmc run's --infer-extra")
    pp.add_argument("--at", help="Points to predict at, e.g. 'x=-5:0.1:5;g=0'")
    pp.add_argument("--atdata", help="Table of points to predict at (alternative to --at)")
    pp.add_argument("-o", "--output", help="Output table (.csv/.tsv)")
    pp.add_argument("--plot", help="File to plot to")
    pp.add_argument("--seed", type=int, default=0)
    pp.add_argument("--jitter", type=float, default=0.1)
    pp.add_argument("--approx", choices=["none", "rff", "sde", "auto"], default="none",
                    help="none: the dense exact model; rff: random Fourier features, the "
                    "O(n m^2) low-rank path for large n; sde: the O(n log n) state-space "
                    "path for formulas with a state-space form; auto: routed by n, the "
                    "formula and the command")
    pp.add_argument("--rff-features", type=int, default=256, metavar="M",
                    help="Features per stationary kernel leaf with --approx rff")
    pp.add_argument("--rff-seed", type=int, default=0)
    pp.add_argument("--sde-window", type=int, default=None, metavar="W",
                    help="With --approx sde: smooth in overlapping windows of W rows "
                    "(memory bounded by a window's buffers). Default: 2^14 when the "
                    "state dim > 24 and the joined rows > 2^15, else 0 (one pass)")
    pp.add_argument("--sde-overlap", type=int, default=None, metavar="V",
                    help="Context rows on each side of a --sde-window window "
                    "(default W/8; it should span a few lengthscales)")
    _add_sde_flags(pp)
    _add_outlier_flags(pp)

    pf = sub.add_parser("fitplot", help="Per-component posterior diagnostic plots")
    pf.add_argument("formula", help="GP formula specification")
    pf.add_argument("-i", "--data", required=True, help="Training data table")
    pf.add_argument("-m", "--mcmc", help="MCMC chain table (optional)")
    pf.add_argument("--infer", nargs="+",
                    help="Variables the chain's hyperparameters were inferred for (must "
                    "match the mcmc run; default: one shared lengthscale over all "
                    "lengthscale-kind leaves)")
    pf.add_argument("--infer-mode", choices=["shared", "pervar"], default="shared",
                    help="Hyperparameter grouping used by the mcmc run")
    pf.add_argument("--infer-extra", nargs="+", default=None, metavar="VAR",
                    help="Match the mcmc run's --infer-extra")
    pf.add_argument("--component", "--comp", dest="component",
                    help="Only plot components involving these ;-separated variables")
    pf.add_argument("-o", "--output", default="fitplots.png", help="Output image file")
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--jitter", type=float, default=0.1)
    pf.add_argument("--approx", choices=["none", "rff", "sde", "auto"], default="none",
                    help="none: the dense exact model; rff: random Fourier features, the "
                    "O(n m^2) low-rank path for large n; sde: the O(n log n) state-space "
                    "path for formulas with a state-space form; auto: routed by n, the "
                    "formula and the command")
    pf.add_argument("--rff-features", type=int, default=256, metavar="M",
                    help="Features per stationary kernel leaf with --approx rff")
    pf.add_argument("--rff-seed", type=int, default=0)
    _add_sde_flags(pf)
    _add_outlier_flags(pf)
    return p


def _add_sde_flags(sub) -> None:
    """--approx sde knobs (the static state-space structure)."""
    sub.add_argument("--sde-harmonics", type=int, default=None, metavar="J",
                     help="Periodic block harmonics under --approx sde (state dim 2J+1; "
                     "default 10)")
    sub.add_argument("--sde-rq-nodes", type=int, default=None, metavar="K",
                     help="RQ block Gamma-mixture nodes under --approx sde (state dim 6K; "
                     "default 8)")
    sub.add_argument("--sde-soa-max-d", type=int, default=None, metavar="D",
                     help="Accepted for gaplac_tpu's command lines and does nothing here: "
                     "the struct-of-arrays scan layout it sizes exists against TPU tile "
                     "padding and is not ported")


def _add_outlier_flags(sub) -> None:
    """Legacy outlier-removal flags."""
    sub.add_argument("--rmv-outliers", "--rmv_outliers", dest="rmv_outliers",
                     choices=["none", "fence"], default="none",
                     help="Outlier removal method for training data (none|fence)")
    sub.add_argument("--outlier-fields", "--outlier_fields", dest="outlier_fields",
                     default="", help=";-separated additional fields to fence")
    sub.add_argument("--outlier-ignore", "--outlier_ignore", dest="outlier_ignore",
                     default="", help=";-separated fields to exclude from fencing")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from gaplac_tpu_torch.cli.logs import setup_logs

    log = setup_logs(args.verbose, args.quiet, args.debug, args.log)
    log.info("Getting started!")

    if args.command is None:
        build_parser().print_help()
        return 1

    from gaplac_tpu_torch.utils import profiling

    profile = args.profile or bool(args.profile_dir)
    if profile:
        profiling.enable()
    try:
        # the sde structure knobs, set on every run (to the default when the
        # flag is absent), before any structure is extracted: a process that
        # runs several commands must not carry one run's knobs into the next
        from gaplac_tpu_torch.ops import markov_ss

        markov_ss.set_periodic_harmonics(args.sde_harmonics or markov_ss.DEFAULT_PERIODIC_J)
        markov_ss.set_rq_nodes(args.sde_rq_nodes or markov_ss.DEFAULT_RQ_MIX_K)
        from gaplac_tpu_torch.runtime import configure

        try:
            rt = configure(args.platform, args.precision)
        except RuntimeError as e:  # no card and no --platform cpu
            raise ValueError(str(e)) from e
        # a multi-process run when GAPLAC_COORDINATOR is set: NCCL on the
        # run's card (bound by configure), gloo on the CPU
        from gaplac_tpu_torch.parallel.multihost import maybe_initialize

        maybe_initialize(device=rt.device)
        if args.command == "sample":
            from gaplac_tpu_torch.cli.sample_cmd import run
        elif args.command == "select":
            from gaplac_tpu_torch.cli.select_cmd import run
        elif args.command == "predict":
            from gaplac_tpu_torch.cli.predict_cmd import run
        elif args.command == "fitplot":
            from gaplac_tpu_torch.cli.fitplot_cmd import run
        else:
            from gaplac_tpu_torch.cli.mcmc_cmd import run

        with profiling.trace(args.profile_dir):
            with profiling.phase(args.command):
                run(args, rt)
    except (ValueError, FileNotFoundError) as e:
        log.error("%s", e)
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if profile:
            profiling.print_report()
        profiling.reset()  # a next command in this process starts from no phases
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
