"""The port's parallel slice across CPU processes on gloo: the row-sharded
dense and low-rank functions (``gaplac_tpu_torch/parallel/distributed.py``)
on 4 ranks against ``gaplac_tpu``'s on 4 of the conftest's 8 virtual
devices, and the sharded ChEES/HMC adaptation and the CLI's NUTS chains on
2 ranks against the unsharded runs.

Each group of ranks is spawned once (this file, run as a script, is a
rank); a rank imports only the port, runs every check's computation and
saves its results with numpy, and the tests compare them.  float64
throughout, one thread a rank.
"""

import logging
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
N_DENSE = 256
JITTERS = {"gram": 0.1, "chol": 0.5, "e2e": 1.1}
N_CHAINS = 8
CLI_DATA_N = 24


def _composite_X():
    """tests/test_distributed.py's composite inputs."""
    X = np.random.default_rng(0).normal(size=(N_DENSE, 3))
    X[:, 1] = np.floor(np.abs(X[:, 1]) * 2)
    return X


def _lowrank_data():
    """tests/test_distributed.py's low-rank case."""
    n = N_DENSE
    rng = np.random.default_rng(3)
    X = np.stack([rng.uniform(-4, 4, n), rng.integers(0, 3, n).astype(float)], axis=1)
    return X, rng.standard_normal(n)


COMPOSITE = "y ~| SqExp(:t) * Cat(:g) + Linear(:x) + Noise"
LOWRANK = "y ~| SqExp(:x) + Cat(:g) + Noise(s2=0.3)"
LOWRANK_EXTRA = 1.1
SDE_FORMULA = "y ~| OU(:t)*Cat(:g) + Cat(:g) + Noise"

# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _sde_models():
    """The twins of test_distributed.py's sharded state-space models."""
    from gaplac_tpu_torch.dsl import parse_formula
    from gaplac_tpu_torch.inference.model import build_model
    from gaplac_tpu_torch.kernels.covariance import compile_formula

    rng = np.random.default_rng(44)
    n = 64
    g = rng.integers(0, 4, n).astype(float)
    t = rng.uniform(0, 10, n)
    spec = parse_formula(SDE_FORMULA)
    X = torch.tensor(np.stack([t, g, g], 1))
    y = torch.tensor(np.sin(t) + rng.normal(0, 0.5, n))
    grouped = build_model(compile_formula(spec.formula), ["t"], X, y, spec.likelihood,
                          approx="sde")
    rng = np.random.default_rng(45)
    n = 48
    x = np.sort(rng.uniform(0, 10, n))
    spec = parse_formula("y ~| SqExp(:x)")
    whitened = build_model(compile_formula(spec.formula), ["x"], torch.tensor(x[:, None]),
                           torch.tensor(np.sin(x) + rng.normal(0, 0.5, n)), spec.likelihood,
                           approx="sde", marginalize=False)
    return {"sde": grouped, "whitened_sde": whitened}


def _gaussian_2d(q):
    prec = torch.tensor(np.linalg.inv(np.diag([2.0, 0.5])), dtype=q.dtype)
    return -0.5 * torch.einsum("ci,ij,cj->c", q, prec, q)


def _sampler_runs(mesh):
    """(name, run) pairs: each run takes the mesh and returns the result's
    arrays (this rank's chains with a mesh) and scalars."""
    from gaplac_tpu_torch.inference.chees import run_chees, run_hmc

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    q0 = torch.tensor(np.random.default_rng(7).normal(size=(N_CHAINS, 2)))
    models = _sde_models()
    runs = {
        "chees": lambda m, q: run_chees(gen(1), _gaussian_2d, q, 20, num_warmup=20, mesh=m),
        "hmc": lambda m, q: run_hmc(gen(2), _gaussian_2d, q, 20, num_warmup=20,
                                    num_leapfrogs=8, mesh=m),
    }
    starts = {"chees": q0, "hmc": q0}
    for name, model in models.items():
        starts[name] = model.initial_position(gen(0), N_CHAINS)
        runs[name] = (lambda m, q, model=model: run_chees(gen(1), model.logdensity, q, 3,
                                                          num_warmup=3, max_leapfrogs=32,
                                                          mesh=m))
    return models, runs, starts


def _save_result(res, prefix, out):
    d = res._asdict()
    for k, v in d.items():
        out[f"{prefix}.{k}"] = v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _cli_argv(data, chains):
    return ["--platform", "cpu", "mcmc", "y ~| SqExp(:x)", "--data", str(data), "--infer", "x",
            "--chains", str(chains), "--samples", "8", "--warmup", "8", "--seed", "3",
            "--output", "chain.tsv", "--checkpoint", "ckpt.npz"]


def _run_cli_in(directory: Path, argv):
    from gaplac_tpu_torch.cli.main import main

    directory.mkdir(parents=True, exist_ok=True)
    here = os.getcwd()
    os.chdir(directory)
    try:
        assert main(argv) == 0
    finally:
        os.chdir(here)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def rank_dense(rank: int, out_dir: Path) -> None:
    """4 ranks: the distributed dense and low-rank functions."""
    from gaplac_tpu_torch.dsl import parse_formula
    from gaplac_tpu_torch.kernels.covariance import compile_formula
    from gaplac_tpu_torch.kernels.features import build_feature_map
    from gaplac_tpu_torch.parallel import distributed as D
    from gaplac_tpu_torch.parallel.multihost import maybe_initialize

    assert maybe_initialize(device=torch.device("cpu"))
    mesh = D.data_mesh()
    out = {}
    ck = compile_formula(parse_formula(COMPOSITE).formula)
    X = torch.tensor(_composite_X())
    p = ck.default_params(torch.float64)
    out["gram"] = D.sharded_gram(ck, p, X, mesh, jitter=JITTERS["gram"]).numpy()
    L = D.distributed_cholesky(D.sharded_gram(ck, p, X, mesh, jitter=JITTERS["chol"]), mesh)
    out["chol"] = L.numpy()
    b = torch.tensor(np.random.default_rng(1).normal(size=N_DENSE))
    out["solve"] = D.distributed_solve_lower(L, b, mesh).numpy()
    # the whole dense pipeline: sharded gram -> distributed factor -> solve -> lp
    y = torch.tensor(np.random.default_rng(2).normal(size=N_DENSE))
    L = D.distributed_cholesky(D.sharded_gram(ck, p, X, mesh, jitter=JITTERS["e2e"]), mesh)
    alpha = D.distributed_solve_lower(L, y, mesh)
    nb = N_DENSE // mesh.size
    logdet = 2.0 * torch.log(torch.diagonal(L, offset=rank * nb)).sum()
    torch.distributed.all_reduce(logdet)
    out["e2e"] = (-0.5 * (alpha @ alpha + logdet + N_DENSE * np.log(2 * np.pi))).numpy()

    ck = compile_formula(parse_formula(LOWRANK).formula)
    Xl, yl = (torch.tensor(a) for a in _lowrank_data())
    fm = build_feature_map(ck, [Xl], num_features=64, seed=0)
    params = ck.default_params(torch.float64).requires_grad_(True)
    lp = D.sharded_lowrank_logpdf(fm, params, Xl, LOWRANK_EXTRA, yl, mesh)
    lp.backward()
    out["lowrank"], out["lowrank_grad"] = lp.detach().numpy(), params.grad.numpy()

    errors = []
    for call in (lambda: D.sharded_gram(ck, params.detach(), Xl[:254], mesh),
                 lambda: D.distributed_cholesky(torch.zeros((63, 254), dtype=torch.float64),
                                                mesh),
                 lambda: D.sharded_lowrank_logpdf(fm, params, Xl, torch.ones(N_DENSE), yl,
                                                  mesh)):
        try:
            call()
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = np.asarray(errors)
    np.savez(out_dir / f"dense_{rank}.npz", **out)


def rank_chains(rank: int, out_dir: Path) -> None:
    """2 ranks: sharded ChEES and HMC, then the CLI's NUTS chains; rank 0
    then runs everything again in one process without a process group."""
    from gaplac_tpu_torch.parallel.mesh import chain_mesh, gather_chain_axis, shard_chain_axis
    from gaplac_tpu_torch.parallel.multihost import maybe_initialize, shutdown

    lines = _Lines()
    logging.getLogger().addHandler(lines)
    assert maybe_initialize(device=torch.device("cpu"))
    mesh = chain_mesh()
    models, runs, starts = _sampler_runs(mesh)
    out = {}
    for name, model in models.items():
        u = shard_chain_axis(starts[name], mesh=mesh)
        out[f"{name}.logdensity"] = gather_chain_axis(model.logdensity(u), mesh).numpy()
    for name, run in runs.items():
        res = run(mesh, shard_chain_axis(starts[name], mesh=mesh))
        _save_result(res._replace(**{k: gather_chain_axis(getattr(res, k), mesh) for k in
                                     ("positions", "logps", "accept_prob")}), name, out)
    data = out_dir / "data.tsv"
    if rank == 0:
        rng = np.random.default_rng(5)
        x = rng.uniform(-5, 5, CLI_DATA_N)
        data.write_text("x\ty\n" + "".join(f"{float(a)!r}\t{float(b)!r}\n" for a, b in
                                           zip(x, np.sin(x) + rng.normal(0, 0.3, x.size))))
    torch.distributed.barrier()
    for chains in (4, 3):
        lines.lines.clear()
        _run_cli_in(out_dir / f"chains{chains}" / f"rank{rank}", _cli_argv(data, chains))
        out[f"cli{chains}.log"] = np.asarray("\n".join(lines.lines))
    np.savez(out_dir / f"chains_{rank}.npz", **out)
    shutdown()
    if rank != 0:
        return
    for k in ("GAPLAC_COORDINATOR", "GAPLAC_NUM_PROCESSES", "GAPLAC_PROCESS_ID"):
        os.environ.pop(k)
    out = {}
    for name, model in models.items():
        out[f"{name}.logdensity"] = model.logdensity(starts[name]).numpy()
    for name, run in runs.items():
        _save_result(run(None, starts[name]), name, out)
    for chains in (4, 3):
        _run_cli_in(out_dir / f"chains{chains}" / "single", _cli_argv(data, chains))
    np.savez(out_dir / "chains_single.npz", **out)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _spawn(what: str, world: int, out_dir: Path, timeout: float = 120.0) -> float:
    """Run ``what`` on ``world`` ranks of this file; the wall seconds."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = []
    for rank in range(world):
        env = dict(os.environ, GAPLAC_COORDINATOR=f"127.0.0.1:{port}",
                   GAPLAC_NUM_PROCESSES=str(world), GAPLAC_PROCESS_ID=str(rank),
                   PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, what, str(rank), str(out_dir)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout) + (p.returncode,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (stdout, stderr, rc) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{stdout[-2000:]}\n{stderr[-4000:]}"
    return time.perf_counter() - t0


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dense")
    _spawn("dense", 4, out_dir)
    return [dict(np.load(out_dir / f"dense_{r}.npz")) for r in range(4)]


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("chains")
    _spawn("chains", 2, out_dir)
    ranks = [dict(np.load(out_dir / f"chains_{r}.npz")) for r in range(2)]
    return out_dir, ranks, dict(np.load(out_dir / "chains_single.npz"))


@pytest.fixture(scope="module")
def jax_dense():
    """gaplac_tpu's functions on a 4-device "data" mesh."""
    import jax
    import jax.numpy as jnp

    from gaplac_tpu.dsl import parse_formula
    from gaplac_tpu.kernels.covariance import compile_formula
    from gaplac_tpu.kernels.features import build_feature_map
    from gaplac_tpu.parallel import distributed as D

    mesh = D.data_mesh(4)
    ck = compile_formula(parse_formula(COMPOSITE).formula)
    X = jnp.asarray(_composite_X())
    p = ck.default_params()
    b = jnp.asarray(np.random.default_rng(1).normal(size=N_DENSE))
    y = jnp.asarray(np.random.default_rng(2).normal(size=N_DENSE))

    @jax.jit  # one program each: eager shard_map calls cost seconds
    def dense():
        gram = D.sharded_gram(ck, p, X, mesh, jitter=JITTERS["gram"])
        L = D.distributed_cholesky(D.sharded_gram(ck, p, X, mesh, jitter=JITTERS["chol"]), mesh)
        x = D.distributed_solve_lower(L, b, mesh)
        # the whole dense pipeline: sharded gram -> distributed factor -> solve -> lp
        L2 = D.distributed_cholesky(D.sharded_gram(ck, p, X, mesh, jitter=JITTERS["e2e"]), mesh)
        alpha = D.distributed_solve_lower(L2, y, mesh)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L2)))
        return gram, L, x, -0.5 * (alpha @ alpha + logdet + N_DENSE * np.log(2 * np.pi))

    ref = dict(zip(("gram", "chol", "solve", "e2e"), (np.asarray(a) for a in dense())))

    ck = compile_formula(parse_formula(LOWRANK).formula)
    Xl, yl = _lowrank_data()
    fm = build_feature_map(ck, [Xl], num_features=64, seed=0)
    Xl, yl = jnp.asarray(Xl), jnp.asarray(yl)
    lp = lambda params: D.sharded_lowrank_logpdf(fm, params, Xl, LOWRANK_EXTRA, yl, mesh)
    params = ck.default_params(Xl.dtype)
    value, grad = jax.jit(jax.value_and_grad(lp))(params)
    ref["lowrank"], ref["lowrank_grad"] = float(value), np.asarray(grad)
    errors = []
    for call in (lambda: D.sharded_gram(ck, params, Xl[:254], mesh),
                 lambda: D.distributed_cholesky(jnp.zeros((254, 254)), mesh),
                 lambda: D.sharded_lowrank_logpdf(fm, params, Xl, jnp.ones(N_DENSE), yl, mesh)):
        with pytest.raises(ValueError) as e:
            call()
        errors.append(str(e.value))
    ref["errors"] = errors
    return ref


def test_sharded_gram_matches_jax(dense, jax_dense):
    """Each rank's (64, 256) block row is gaplac_tpu's row shard, bare Noise
    and the jitter on the global diagonal."""
    assert {r["gram"].shape for r in dense} == {(N_DENSE // 4, N_DENSE)}
    np.testing.assert_allclose(np.concatenate([r["gram"] for r in dense]), jax_dense["gram"],
                               rtol=0, atol=1e-12)


def test_distributed_cholesky_matches_jax(dense, jax_dense):
    L = np.concatenate([r["chol"] for r in dense])
    np.testing.assert_allclose(L, jax_dense["chol"], rtol=0, atol=1e-9)
    assert np.array_equal(L, np.tril(L))


def test_distributed_solve_matches_jax(dense, jax_dense):
    for r in dense:  # x is whole on every rank
        np.testing.assert_allclose(r["solve"], jax_dense["solve"], rtol=0, atol=1e-8)


def test_distributed_mvn_logpdf_end_to_end_matches_jax(dense, jax_dense):
    for r in dense:
        np.testing.assert_allclose(float(r["e2e"]), jax_dense["e2e"], rtol=1e-10)


def test_sharded_lowrank_logpdf_value_and_gradient_match_jax(dense, jax_dense):
    """The rows' sums over ranks and their backward: a gradient summed P
    times over the replicated terms would be 4x gaplac_tpu's."""
    for r in dense:
        np.testing.assert_allclose(float(r["lowrank"]), jax_dense["lowrank"], rtol=1e-10)
        np.testing.assert_allclose(r["lowrank_grad"], jax_dense["lowrank_grad"], rtol=1e-8,
                                   atol=1e-12)


def test_distributed_errors_match_jax(dense, jax_dense):
    """n not divisible by the mesh size, and a per-observation extra_diag,
    raise gaplac_tpu's ValueErrors word for word."""
    for r in dense:
        assert list(r["errors"]) == jax_dense["errors"]


@pytest.mark.parametrize("name", ["chees", "hmc", "sde", "whitened_sde"])
def test_sharded_sampler_equals_unsharded(chains, name):
    """run_chees/run_hmc with the 8 chains over 2 ranks: every output within
    1e-12 of the one-process run, with the same accept decisions; the
    state-space models' log densities chain-local."""
    _, ranks, single = chains
    for r in ranks:
        keys = [k for k in single if k.startswith(name + ".")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(r[k], single[k], rtol=1e-12, atol=0, err_msg=k)
        moved = lambda pos: np.any(np.diff(pos, axis=1) != 0, axis=2)
        if f"{name}.positions" in single:
            assert np.array_equal(moved(r[f"{name}.positions"]),
                                  moved(single[f"{name}.positions"]))


@pytest.mark.parametrize("n_chains", [4, 3])
def test_cli_nuts_over_two_ranks_writes_the_single_process_table(chains, n_chains):
    """mcmc NUTS under the GAPLAC_* variables: the chains sharded over two
    ranks (4) or every chain on every rank with gaplac_tpu's warning (3);
    rank 0 writes the single-process table byte for byte and its
    checkpoint's arrays, rank 1 writes nothing."""
    out_dir, ranks, _ = chains
    base = out_dir / f"chains{n_chains}"
    assert (base / "rank0" / "chain.tsv").read_bytes() == (base / "single" /
                                                            "chain.tsv").read_bytes()
    got, want = (np.load(base / d / "ckpt.npz") for d in ("rank0", "single"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert np.array_equal(got[k], want[k]), k
    assert not any((base / "rank1").iterdir())
    for r in ranks:
        log = str(r[f"cli{n_chains}.log"])
        assert "torch.distributed initialized (gloo)" not in log  # the group already stood
        if n_chains == 4:
            assert "sharded 4 chains over 2 devices" in log and "UNSHARDED" not in log
        else:
            assert ("chains (3) not divisible by devices (2); running UNSHARDED on one "
                    "device — pick a chain count that is a multiple of 2") in log


if __name__ == "__main__":
    torch.set_num_threads(1)
    what, rank, out = sys.argv[1], int(sys.argv[2]), Path(sys.argv[3])
    {"dense": rank_dense, "chains": rank_chains}[what](rank, out)
