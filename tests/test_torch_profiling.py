"""--profile and --profile-dir in the port (gaplac_tpu_torch/utils/profiling.py):
the phase names of gaplac_tpu's report for the same mcmc command, a
torch.profiler trace that json.load reads, and both flags on each of the
five commands."""

import json

import numpy as np
import pandas as pd
import pytest

from gaplac_tpu.cli.main import main as jax_main
from gaplac_tpu.utils import profiling as jax_profiling
from gaplac_tpu_torch.cli.main import main
from gaplac_tpu_torch.utils import profiling


def _phase_names(out: str) -> list:
    lines = out.split("phase breakdown:\n")[1].splitlines()
    return sorted(s.split()[0] for s in lines if s.startswith("  "))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_cli_extended.py::test_profile_flag's table: n = 30."""
    path = tmp_path_factory.mktemp("profiling") / "d.tsv"
    rng = np.random.default_rng(2)
    pd.DataFrame({"x": rng.uniform(-5, 5, 30), "y": rng.normal(size=30)}).to_csv(
        path, sep="\t", index=False)
    return path


def test_mcmc_report_names_the_phases_of_gaplac_tpu(data, tmp_path, capsys):
    argv = ["--platform", "cpu", "--profile", "mcmc", "y ~| SqExp(:x)", "--data", str(data),
            "--infer", "x", "--samples", "20", "--warmup", "40"]
    # gaplac_tpu's timers are process state that its CLI never clears
    jax_profiling._phases.clear()
    jax_profiling._counts.clear()
    try:
        assert jax_main([*argv, "--output", str(tmp_path / "jax.tsv")]) == 0
        jax_names = _phase_names(capsys.readouterr().out)
    finally:
        jax_profiling._enabled = False
        jax_profiling._phases.clear()
        jax_profiling._counts.clear()
    assert main([*argv, "--output", str(tmp_path / "port.tsv")]) == 0
    out = capsys.readouterr().out
    assert _phase_names(out) == jax_names == ["mcmc", "mcmc.report", "mcmc.sample+compile"]
    line = next(s for s in out.splitlines() if s.startswith("  mcmc.sample+compile"))
    assert line.endswith("x1") and "%)" in line
    assert not profiling.enabled() and profiling.report() == ""  # nothing leaks to a next run


def _commands(data, out):
    model = ["--data", str(data), "--infer", "x"]
    return {
        "sample": ["sample", "y :~| SqExp(:x; l=1.5)", "--at", "x=-5:1:5", "--seed", "1",
                   "--output", str(out / "s.tsv")],
        "mcmc": ["mcmc", "y ~| SqExp(:x)", *model, "--samples", "5", "--warmup", "5",
                 "--sampler", "chees", "--no-latents", "--output", str(out / "c.tsv")],
        "mcmc rff": ["mcmc", "y ~| SqExp(:x)", *model, "--samples", "5", "--warmup", "5",
                     "--approx", "rff", "--rff-features", "16", "--no-latents",
                     "--output", str(out / "r.tsv")],
        "select": ["select", "--formulae", "y ~| SqExp(:x)", "y ~| OU(:x)", "--data",
                   str(data)],
        "predict": ["predict", "y ~| SqExp(:x)", "--data", str(data), "--at", "x=-5:1:5",
                    "--output", str(out / "p.tsv")],
        "predict sde": ["predict", "y ~| OU(:x) + Noise", "--data", str(data), "--at",
                        "x=-5:1:5", "--approx", "sde", "--output", str(out / "q.tsv")],
        "fitplot": ["fitplot", "y ~| SqExp(:x)", "--data", str(data), "--output",
                    str(out / "f.png")],
    }


@pytest.mark.parametrize("name", ["sample", "mcmc", "mcmc rff", "select", "predict",
                                  "predict sde", "fitplot"])
def test_every_command_takes_both_flags(data, tmp_path, capsys, name):
    argv = _commands(data, tmp_path)[name]
    trace_dir = tmp_path / "trace"
    assert main(["--platform", "cpu", "--profile", "--profile-dir", str(trace_dir), *argv]) == 0
    assert argv[0] in _phase_names(capsys.readouterr().out)
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
