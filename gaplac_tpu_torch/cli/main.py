"""gaplac CLI of the PyTorch/CUDA port: argument schema and dispatch (port of
``gaplac_tpu/cli/main.py``).

``mcmc`` is ported on the dense exact model with the NUTS and ChEES
samplers.  ``sample``, ``select``, ``predict`` and ``fitplot`` are registered
and raise "not yet ported"; so do the flags whose paths wait (see
``UNPORTED`` in ``mcmc_cmd.py``).

Run as ``python -m gaplac_tpu_torch.cli.main mcmc ...``.
"""

from __future__ import annotations

import argparse
import sys

UNPORTED_COMMANDS = ("sample", "select", "predict", "fitplot")


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
                   help="Force the torch device (default: cuda when available)")
    p.add_argument("--precision", choices=["f32", "f64"], default=None,
                   help="Compute precision (default: f64 on CPU, f32 on CUDA)")
    p.add_argument("--profile", action="store_true",
                   help="Print a phase wall-clock breakdown (not yet ported)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="Write a profiler trace to DIR (not yet ported)")

    sub = p.add_subparsers(dest="command", metavar="{sample,mcmc,select,predict,fitplot}")
    for name in UNPORTED_COMMANDS:
        sp = sub.add_parser(name, help=f"{name} (not yet ported)")
        sp.add_argument("rest", nargs=argparse.REMAINDER)

    pm = sub.add_parser("mcmc", help="Run MCMC (NUTS) over kernel hyperparameters")
    pm.add_argument("formula", help="GP formula specification")
    pm.add_argument("-i", "--data", required=True, help="Table input for inference")
    pm.add_argument("--infer", nargs="+", default=None,
                    help="Variable names whose kernel hyperparameter to infer "
                    "(this and/or --infer-extra is required)")
    pm.add_argument("--samples", type=int, default=200,
                    help="Number of posterior samples (default 200)")
    pm.add_argument("-o", "--output", help="Table to output sampling chain")
    pm.add_argument("--plot", help="File to plot traces to (not yet ported)")
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
                    help="nuts (default; chains run one after another) or chees "
                    "(cross-chain adaptive HMC, all chains in lockstep; wants "
                    "--chains >= 8); hmc and advi are not yet ported")
    pm.add_argument("--leapfrogs", type=int, default=32,
                    help="Leapfrog steps per --sampler hmc trajectory (not yet ported)")
    pm.add_argument("--segments", type=int, default=None, metavar="S",
                    help="Segmented --sampler hmc sampling (not yet ported)")
    pm.add_argument("--infer-mode", choices=["shared", "pervar"], default="shared",
                    help="shared (reference parity: ONE scalar for all --infer vars) "
                    "or pervar (one hyperparameter per distinct variable)")
    pm.add_argument("--infer-extra", nargs="+", default=None, metavar="VAR",
                    help="Also infer the shape parameters (Periodic's period p, "
                    "RQ's alpha) of kernels on these variables")
    pm.add_argument("--progress", action="store_true",
                    help="Print sampler progress lines to stderr")
    pm.add_argument("--check-numerics", action="store_true",
                    help="NaN/Inf debugging (not yet ported)")
    pm.add_argument("--approx", choices=["none", "laplace", "rff", "sde", "auto"],
                    default="none",
                    help="none: the dense exact model; laplace, rff, sde and auto "
                    "are not yet ported")
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
    pm.add_argument("--sde-harmonics", type=int, default=None, metavar="J",
                    help="--approx sde knob (not yet ported)")
    pm.add_argument("--sde-rq-nodes", type=int, default=None, metavar="K",
                    help="--approx sde knob (not yet ported)")
    pm.add_argument("--sde-soa-max-d", type=int, default=None, metavar="D",
                    help="--approx sde knob (not yet ported)")
    pm.add_argument("--rmv-outliers", "--rmv_outliers", dest="rmv_outliers",
                    choices=["none", "fence"], default="none",
                    help="Outlier removal method for training data (none|fence)")
    pm.add_argument("--outlier-fields", "--outlier_fields", dest="outlier_fields",
                    default="", help=";-separated additional fields to fence")
    pm.add_argument("--outlier-ignore", "--outlier_ignore", dest="outlier_ignore",
                    default="", help=";-separated fields to exclude from fencing")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from gaplac_tpu_torch.cli.logs import setup_logs

    log = setup_logs(args.verbose, args.quiet, args.debug, args.log)
    log.info("Getting started!")

    if args.command is None:
        build_parser().print_help()
        return 1

    try:
        if args.command in UNPORTED_COMMANDS:
            raise NotImplementedError(
                f"'{args.command}' is not yet ported to gaplac_tpu_torch "
                "(use ./gaplac, the JAX package)")
        if args.profile or args.profile_dir:
            raise NotImplementedError("--profile/--profile-dir are not yet ported")
        from gaplac_tpu_torch.runtime import configure

        rt = configure(args.platform, args.precision)
        from gaplac_tpu_torch.cli.mcmc_cmd import run

        run(args, rt)
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        log.error("%s", e)
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
