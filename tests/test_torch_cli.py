"""The port's CLI on the CPU: the chain-table schema against gaplac_tpu's
writer, checkpoints in gaplac_tpu's format, the entry point end to end, the
refusal to start without a card unless given --platform cpu, and an import
of the whole port that pulls in neither JAX nor gaplac_tpu.  --profile and
--check-numerics: tests/test_torch_profiling.py and
tests/test_torch_check_numerics.py."""

import argparse
import ast
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from gaplac_tpu.cli import mcmc_cmd as jax_mcmc
from gaplac_tpu_torch.cli import mcmc_cmd
from gaplac_tpu_torch.cli.main import main

ROOT = Path(__file__).resolve().parent.parent


class _Model(NamedTuple):
    n_hyper: int


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_chain_table_matches_jax_writer(tmp_path, sampler, capsys):
    rng = np.random.default_rng(0)
    C, kept, nh, n = 2, 6, 2, 4
    thetas, fs, lps = (rng.uniform(0.5, 3, (C, kept, nh)), rng.normal(size=(C, kept, n)),
                       rng.normal(size=(C, kept)))
    stats = dict(accepts=rng.uniform(size=(C, kept)))
    if sampler == "nuts":
        stats.update(depths=rng.integers(0, 5, (C, kept)), divs=rng.uniform(size=(C, kept)) > 0.8)
    else:
        stats.update(step_size=0.0713, traj_length=1.25)
    outs = []
    for tag, emit in (("jax", jax_mcmc._emit_chains), ("torch", mcmc_cmd._emit_chains)):
        out = tmp_path / f"{tag}.tsv"
        args = argparse.Namespace(output=str(out), no_latents=False, plot=None)
        emit(args, _Model(nh), n, thetas, fs, lps, **stats)
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    printed = capsys.readouterr().out.splitlines()
    assert printed[:2] == printed[2:]  # the same posterior summary lines


def _write_data(path, n=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, 5, n)
    K = np.exp(-(x[:, None] - x[None, :]) ** 2 / (2 * 1.5 ** 2)) + 0.1 * np.eye(n)
    pd.DataFrame({"x": x, "y": np.linalg.cholesky(K) @ rng.normal(size=n)}).to_csv(
        path, sep="\t", index=False)


def _mcmc(tmp_path, *extra):
    data = tmp_path / "data.tsv"
    if not data.exists():
        _write_data(data)
    out = tmp_path / "chain.tsv"
    rc = main(["--platform", "cpu", "mcmc", "y ~| SqExp(:x)", "--data", str(data), "--infer",
               "x", "--output", str(out), *extra])
    assert rc == 0
    return pd.read_csv(out, sep="\t")


def test_mcmc_nuts_and_chees_end_to_end(tmp_path):
    df = _mcmc(tmp_path, "--samples", "12", "--warmup", "12", "--chains", "2", "--thin", "2")
    fx = [f"fx[{i + 1}]" for i in range(12)]
    assert list(df.columns) == (["iteration", "chain", "ℓ"] + fx
                                + ["lp", "acceptance_rate", "tree_depth", "numerical_error"])
    assert len(df) == 12 and np.isfinite(df.to_numpy(float)).all()
    df = _mcmc(tmp_path, "--samples", "8", "--warmup", "8", "--sampler", "chees",
               "--no-marginalize", "--no-latents")
    assert list(df.columns) == ["iteration", "chain", "ℓ", "lp", "acceptance_rate",
                                "step_size", "traj_length"]
    assert len(df) == 8 * 8 and np.isfinite(df.to_numpy(float)).all()


class _NutsRes(NamedTuple):      # the fields gaplac_tpu's checkpoint writer reads
    step_size: object
    inv_mass: object


class _CheesRes(NamedTuple):
    step_size: object
    inv_mass: object
    traj_length: object


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_jax_checkpoint_resumes_and_port_checkpoint_loads_in_jax(tmp_path, sampler):
    """A checkpoint written by gaplac_tpu resumes in the port (warmup
    skipped), and the port's checkpoint reads back through gaplac_tpu."""
    C = 1 if sampler == "nuts" else 8
    dim = 13  # whitened: 1 + n
    rng = np.random.default_rng(1)
    pos = jnp.asarray(rng.normal(size=(C, 3, dim)) * 0.1)
    res = (_NutsRes(jnp.full((C,), 0.2), jnp.ones((C, dim))) if sampler == "nuts"
           else _CheesRes(jnp.asarray(0.2), jnp.ones((dim,)), jnp.asarray(0.9)))
    ck = tmp_path / "jax_ckpt"
    jax_mcmc._save_checkpoint(str(ck), pos, res)
    flags = ["--no-marginalize", "--samples", "5", "--chains", str(C), "--resume",
             str(ck) + ".npz", "--checkpoint", str(tmp_path / "port_ckpt")]
    if sampler == "chees":
        flags += ["--sampler", "chees"]
    df = _mcmc(tmp_path, *flags)
    assert len(df) == 5 * C
    back = jax_mcmc._load_checkpoint(str(tmp_path / "port_ckpt"), C, dim)
    assert back["positions"].shape == (C, dim)
    assert np.isfinite(np.asarray(back["inv_mass"])).all()
    assert ("traj_length" in back) == (sampler == "chees")


def test_no_card_needs_platform_cpu(tmp_path, capsys, monkeypatch):
    """Without a CUDA device the port refuses to start unless asked for the
    CPU; it never falls back to it."""
    from gaplac_tpu_torch.runtime import configure

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in (None, "cuda"):
        with pytest.raises(RuntimeError, match="--platform cpu"):
            configure(platform)
    assert configure("cpu").device.type == "cpu"
    out = tmp_path / "s.tsv"
    argv = ["sample", "y :~| SqExp(:x; l=1.5)", "--at", "x=0:1:3", "--seed", "1",
            "--output", str(out)]
    assert main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err and not out.exists()
    assert main(["--platform", "cpu", *argv]) == 0 and out.exists()


def test_port_imports_no_jax():
    """No module of the port, and neither chip_smoke.py nor chip_parallel.py,
    imports jax or anything of gaplac_tpu; every module imports without
    matplotlib."""
    code = (
        "import sys, importlib, pkgutil\n"
        # and without matplotlib: only --plot and fitplot's drawing import it
        "sys.modules['matplotlib'] = None\n"
        "import gaplac_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(gaplac_tpu_torch.__path__,\n"
        "                                                  'gaplac_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        # the state-space path's and the parallel slice's modules are among them
        "assert {'gaplac_tpu_torch.ops.scan', 'gaplac_tpu_torch.ops.markov', "
        "'gaplac_tpu_torch.ops.markov_ss', 'gaplac_tpu_torch.inference.routing', "
        "'gaplac_tpu_torch.parallel.mesh', 'gaplac_tpu_torch.parallel.multihost', "
        "'gaplac_tpu_torch.parallel.distributed'} <= set(names)\n"
        "from gaplac_tpu_torch.cli.main import build_parser\n"
        "build_parser().parse_args(['mcmc', 'y ~| SqExp(:x)', '--data', 'd.tsv'])\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "bad = sorted(m for m in sys.modules if m == 'gaplac_tpu' or m.startswith('gaplac_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    imported = set()
    for script in ("chip_smoke.py", "chip_parallel.py"):
        for node in ast.walk(ast.parse((ROOT / script).read_text())):
            if isinstance(node, ast.Import):
                imported.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                imported.add(node.module or "")
    bad = sorted(m for m in imported if re.match(r"(jax|gaplac_tpu)(\.|$)", m))
    assert not bad, bad
