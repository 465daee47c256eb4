"""What a seed's failed chains cost, one traced window a seed:

    python3 -m portbench.diagnose --workload <name> --seeds 1 2 --transitions 9

For each seed: the cell's inputs and program as a run builds them, then
``--transitions`` transitions under ``torch.profiler``, and one JSON line:
the batched leapfrogs, the chain-leapfrogs whose log density came back
non-finite, the mean device interval (ms) of the leapfrogs that hold such a
chain and of those that hold none, and the device milliseconds a batched
leapfrog of the ``--top`` operations that took most time.  A seed with
failures beside one without shows which operations the failures cost.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import cell as cells
from portbench import trace as tracing


def diagnose(cell: cells.Cell, seed: int, transitions: int, top: int, device) -> dict:
    inputs = cells.make_inputs(cell, seed, device)
    prog = cells.build_program(cell, inputs, seed, device)
    prof = tracing.profiler()
    win = cells.drive(prog, 3600.0, device, max_transitions=transitions, profiler=prof)
    summary = tracing.summarize(prof)
    calls = prog.recorder.calls
    bad = [int((~torch.isfinite(c.lp)).sum()) for c in calls]
    mean = lambda xs: sum(xs) / len(xs) if xs else None
    out = {"workload": cell.name, "seed": seed, "leapfrogs": len(calls),
           "failed_chain_leapfrogs": sum(bad),
           "leapfrogs_with_a_failure": sum(b > 0 for b in bad),
           "interval_ms_with_failure": mean([t for t, b in zip(win.intervals_ms, bad) if b]),
           "interval_ms_without": mean([t for t, b in zip(win.intervals_ms, bad) if not b]),
           "ms_per_leapfrog": {name: 1e3 * s / len(calls) for name, s in summary.top_ops(top)}}
    del prog, prof, summary, win, calls
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--transitions", type=int, default=9)
    p.add_argument("--top", type=int, default=25)
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.cfg["tf32"])
    for s in args.seeds:
        print(json.dumps(diagnose(cell, s, args.transitions, args.top, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
