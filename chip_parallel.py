"""The port's parallel slice over the cards of one host: one rank a card,
NCCL, launched from the ``GAPLAC_*`` variables as a user launches it.

    python3 chip_parallel.py

Needs two cards or more (every card of the host takes a rank).  It builds
the kernels once, writes ``chip_smoke.py``'s path 1 data (n = 500), and
starts one copy of itself a card with
``GAPLAC_COORDINATOR`` on a free localhost port, ``GAPLAC_NUM_PROCESSES``
and ``GAPLAC_PROCESS_ID``.  Each rank:

1. runs ``mcmc "y ~| SqExp(:x)"`` NUTS ``--chains 8`` (20 + 20) through the
   CLI entry point, which binds ``cuda:(rank % device_count)`` and starts
   the process group; the chains are sharded over the ranks and rank 0
   writes the table.  The rank checks its binding, that its own card
   launched K1, K2 and K2b, and K1's and K2b's occupancy on its card;
2. ``chip_smoke.py``'s path 7b at n = 16384 (n / P rows a rank):
   ``sharded_gram``, ``distributed_cholesky``, ``distributed_solve_lower``
   and their log density, gathered and held against the counterparts on
   one card by the float32 rule against float64, timed with NCCL's part of
   the device time;
3. path 7c: ``sharded_lowrank_logpdf`` at n = 65536, m = 512 on a sine
   plus noise (value and gradient against float64 and against
   ``lowrank_logpdf``; one K1 launch a rank an evaluation).

The parent then runs the same ``mcmc`` command in one process on cuda:0
(no ``GAPLAC_*``), whose table must equal rank 0's byte for byte, kills any
rank still running after ``RANK_TIMEOUT_S``, prints each card's name and
power limit, the ranks' results as JSON, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

OUT = cs.OUT_DIR / "parallel"
RANK_TIMEOUT_S = 600
NUTS_ARGV = ["--platform", "cuda", "mcmc", "y ~| SqExp(:x)", "--infer", "x", "--seed", "1",
             *cs.PAR_NUTS]


def rff_data():
    """n = 65536 points of a sine plus noise (the rows of path 4's width)."""
    rng = np.random.default_rng(21)
    x = rng.uniform(-5, 5, cs.N_RFF)
    return x, np.sin(x) + rng.normal(0, 0.3, cs.N_RFF)


def sampling_line(argv, output: Path) -> tuple:
    """Run the NUTS command; (its wall in s, its "sampling done" log line)."""
    import logging

    capture = cs._Capture()
    logging.getLogger().addHandler(capture)
    try:
        t0 = time.perf_counter()
        cs.run_cli(["-v", *argv, "--data", str(OUT / "data.tsv"), "--output", str(output)],
                   capture)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        logging.getLogger().removeHandler(capture)
    return wall, next(s for s in capture.lines if s.startswith("sampling done"))


def rank_main(rank: int) -> None:
    from gaplac_tpu_torch.ops import _build
    from gaplac_tpu_torch.ops.cholesky import k1_clusters_that_fit
    from gaplac_tpu_torch.ops.gram import gram_bwd_cluster
    from gaplac_tpu_torch.parallel import multihost
    from gaplac_tpu_torch.parallel.distributed import data_mesh

    result = {"rank": rank}
    _build.reset_counts()
    wall, line = sampling_line(NUTS_ARGV, OUT / "nuts_ranks.tsv")
    result["nuts"] = {"wall_s": wall, "sampling": line, "launches": dict(_build.counts)}
    dev = torch.device("cuda", torch.cuda.current_device())
    card = rank % torch.cuda.device_count()
    if dev.index != card or not multihost.is_multihost():
        raise AssertionError(f"rank {rank} bound {dev}, expected cuda:{card} in a group")
    cs.require_launches(f"rank {rank} nuts", result["nuts"]["launches"], ("K1", "K2", "K2b"))
    result["card"] = {"device": str(dev), "name": torch.cuda.get_device_name(dev),
                      "k1_clusters_of_8": k1_clusters_that_fit(8, torch.float32, dev),
                      "k2b_cluster_at_2": gram_bwd_cluster(2, torch.float32, dev)}
    cs.log(f"rank {rank}: {result['card']}; nuts {result['nuts']}")
    result["dense_launches"], result["dense"] = cs.phase_parallel_dense(dev, data_mesh())
    x, y = rff_data()
    result["lowrank_launches"], result["lowrank"] = cs.phase_parallel_lowrank(
        dev, data_mesh(), x, y)
    (OUT / f"rank{rank}.json").write_text(json.dumps(result, default=str))
    multihost.shutdown()


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_parallel: needs two CUDA devices or more", file=sys.stderr)
        return 1
    from gaplac_tpu_torch.ops import _build

    world = torch.cuda.device_count()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip()
    cs.log(f"cards (nvidia-smi name, power.limit):\n{cards}")
    _build.library()  # built once, before the ranks load it
    OUT.mkdir(parents=True, exist_ok=True)
    for f in OUT.glob("rank*.json"):
        f.unlink()
    cs.write_path1_data(OUT / "data.tsv")
    port = cs.free_port()
    t0 = time.perf_counter()
    procs = []
    for rank in range(world):
        env = dict(os.environ, GAPLAC_COORDINATOR=f"127.0.0.1:{port}",
                   GAPLAC_NUM_PROCESSES=str(world), GAPLAC_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, __file__, "--rank", str(rank)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, RANK_TIMEOUT_S
                                                  - (time.perf_counter() - t0)))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        cs.log(f"--- rank {rank} (exit {p.returncode}):\n"
               + "\n".join(s for s in out.splitlines() if not s.startswith("[ INFO"))[-6000:])
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} exited with {p.returncode}")
    ranks = [json.loads((OUT / f"rank{r}.json").read_text()) for r in range(world)]
    # the same command in one process, on cuda:0
    single_wall, single_line = sampling_line(NUTS_ARGV, OUT / "nuts_single.tsv")
    cs.log(f"one process: wall {single_wall:.2f} s, {single_line}")
    same = (OUT / "nuts_ranks.tsv").read_bytes() == (OUT / "nuts_single.tsv").read_bytes()
    cs.log(f"NUTS --chains 8 over {world} ranks wrote the one-process table: {same}")
    if not same:
        raise AssertionError("the sharded NUTS table differs from the one-process table")
    print(json.dumps({"cards": cards.splitlines(), "world": world, "ranks_wall_s": wall,
                      "nuts_single_wall_s": single_wall, "nuts_single_sampling": single_line,
                      "ranks": ranks}, default=str))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": world}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]))
    else:
        sys.exit(main())
