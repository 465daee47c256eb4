"""The port's multi-process launch (``gaplac_tpu_torch/parallel/multihost.py``),
the twin of tests/test_multihost.py: two CPU processes on gloo from the
``GAPLAC_*`` variables; a run without them builds no process group and
makes no collective; the device a rank binds; and K1's and K2b's occupancy
helpers asked about the card they are given."""

import ast
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parent.parent
GAPLAC_VARS = ("GAPLAC_COORDINATOR", "GAPLAC_NUM_PROCESSES", "GAPLAC_PROCESS_ID")


def rank_main() -> None:
    """One of two ranks: the group, the mesh and a collective."""
    from gaplac_tpu_torch.parallel.mesh import chain_mesh, gather_chain_axis
    from gaplac_tpu_torch.parallel.multihost import (global_chain_mesh, is_multihost,
                                                     maybe_initialize)

    assert maybe_initialize(device=torch.device("cpu")), "GAPLAC_COORDINATOR should initialize"
    assert maybe_initialize(device=torch.device("cpu"))  # a second call does nothing
    assert is_multihost() and dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    mesh = global_chain_mesh()
    assert mesh.size == 2 and mesh.rank == dist.get_rank()
    # a real cross-process collective: all-gather each process's rank
    gathered = gather_chain_axis(torch.tensor([float(dist.get_rank())]), mesh)
    assert gathered.tolist() == [0.0, 1.0] and float(gathered.sum()) == 1.0
    # a mesh over the first rank only: rank 1 is outside it, and rank 0's
    # collectives run on a group of one
    sub = chain_mesh(1)
    if dist.get_rank() == 0:
        assert sub.size == 1 and sub.rank == 0
        assert gather_chain_axis(torch.tensor([5.0]), sub).tolist() == [5.0]
    else:
        assert sub is None
    print("MULTIHOST_OK", dist.get_rank(), dist.get_world_size())


def test_two_process_distributed():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, GAPLAC_COORDINATOR=f"127.0.0.1:{port}",
                   GAPLAC_NUM_PROCESSES="2", GAPLAC_PROCESS_ID=str(pid), PYTHONPATH=str(ROOT))
        procs.append(subprocess.Popen([sys.executable, __file__], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120) + (p.returncode,))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out, err, rc in outs:
        assert rc == 0, f"worker failed:\nstdout={out}\nstderr={err[-2000:]}"
        assert "MULTIHOST_OK" in out


def test_without_coordinator_no_group_and_no_collective(tmp_path, monkeypatch):
    """No GAPLAC_COORDINATOR: maybe_initialize is a no-op, and a whole mcmc
    run (NUTS, sharded when a group stands) and run_chees/run_hmc without a
    mesh make no collective."""
    from gaplac_tpu_torch.cli.main import main
    from gaplac_tpu_torch.inference.chees import run_chees, run_hmc
    from gaplac_tpu_torch.parallel import multihost

    for k in GAPLAC_VARS:
        monkeypatch.delenv(k, raising=False)
    assert multihost.maybe_initialize() is False
    assert not dist.is_initialized() and not multihost.is_multihost()
    assert multihost.is_primary()

    def refuse(*a, **kw):
        raise AssertionError("a collective or a process group in a single-process run")

    for name in ("init_process_group", "all_gather", "all_reduce", "broadcast", "new_group"):
        monkeypatch.setattr(dist, name, refuse)
    rng = np.random.default_rng(0)
    x = rng.uniform(-5, 5, 12)
    data = tmp_path / "d.tsv"
    data.write_text("x\ty\n" + "".join(f"{float(a)!r}\t{float(b)!r}\n"
                                       for a, b in zip(x, np.sin(x))))
    for sampler in ("nuts", "chees"):
        out = tmp_path / f"{sampler}.tsv"
        assert main(["--platform", "cpu", "mcmc", "y ~| SqExp(:x)", "--data", str(data),
                     "--infer", "x", "--chains", "2", "--samples", "3", "--warmup", "3",
                     "--sampler", sampler, "--output", str(out)]) == 0
        assert out.exists()
    q0 = torch.zeros((4, 2), dtype=torch.float64)
    ld = lambda q: -0.5 * (q * q).sum(1)
    run_chees(torch.Generator().manual_seed(0), ld, q0, 3, num_warmup=4)
    run_hmc(torch.Generator().manual_seed(0), ld, q0, 3, num_warmup=4, num_leapfrogs=2)


def test_rank_binds_its_card(monkeypatch):
    """Rank i of a multi-process run takes cuda:(i % device_count), made the
    current device; a run without GAPLAC_COORDINATOR keeps "cuda", and the
    CPU binds nothing."""
    from gaplac_tpu_torch.runtime import configure

    bound = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "a card")
    for k in GAPLAC_VARS:
        monkeypatch.delenv(k, raising=False)
    assert configure("cuda").device == torch.device("cuda") and bound == []
    monkeypatch.setenv("GAPLAC_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("GAPLAC_NUM_PROCESSES", "5")
    for rank, card in ((0, 0), (2, 2), (4, 1)):
        monkeypatch.setenv("GAPLAC_PROCESS_ID", str(rank))
        assert configure(None).device == torch.device("cuda", card)
        assert bound[-1] == torch.device("cuda", card)
    n = len(bound)
    assert configure("cpu").device == torch.device("cpu") and len(bound) == n


def test_occupancy_helpers_ask_the_tensors_card(monkeypatch):
    """K1's and K2b's occupancy helpers pass the library the index of the
    device they are given (a CUDA tensor's .device), not device 0 or the
    current one; chip_smoke.py hands every call its tensor's device."""
    from gaplac_tpu_torch.ops import _build
    from gaplac_tpu_torch.ops.cholesky import k1_clusters_that_fit
    from gaplac_tpu_torch.ops.gram import gram_bwd_cluster

    asked = []

    class FakeLibrary:
        def gaplac_chol_batched_clusters(self, cluster, f64, device):
            asked.append(("K1", device))
            return 7

        def gaplac_gram_bwd_cluster(self, C, f64, device):
            asked.append(("K2b", device))
            return 16

    monkeypatch.setattr(_build, "library", FakeLibrary)
    assert k1_clusters_that_fit(16, torch.float64, torch.device("cuda", 3)) == 7
    assert gram_bwd_cluster(8, torch.float32, torch.device("cuda", 2)) == 16
    assert k1_clusters_that_fit(8, torch.float32, 5) == 7
    assert asked == [("K1", 3), ("K2b", 2), ("K1", 5)]
    for bad in (torch.device("cpu"), torch.device("cuda")):
        with pytest.raises(ValueError, match="CUDA device with an index"):
            gram_bwd_cluster(1, torch.float32, bad)
    with pytest.raises(TypeError):
        k1_clusters_that_fit(8, torch.float32)  # the device is required
    calls = [node for node in ast.walk(ast.parse((ROOT / "chip_smoke.py").read_text()))
             if isinstance(node, ast.Call) and getattr(node.func, "id", None) in
             ("k1_clusters_that_fit", "gram_bwd_cluster")]
    assert len(calls) >= 3
    for call in calls:
        device = call.args[2] if len(call.args) > 2 else next(
            (k.value for k in call.keywords if k.arg == "device"), None)
        assert device is not None and ast.unparse(device) in ("dev", "p.device"), \
            ast.unparse(call)


if __name__ == "__main__":
    torch.set_num_threads(1)
    rank_main()
