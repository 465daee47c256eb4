"""The readings the check's limits are set from, in one process a cell:

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 ... \
        --control-seeds 7 8 9 --transitions 3

For each of ``--seeds``: the cell's inputs from the seed, the program's
transition from the adapted state for ``--transitions`` transitions (its
sampled ones are then the whole window), and the check's numbers against the
float64 reference.  For each of ``--control-seeds`` the same with the
control in the program's place: the configuration's reference computed in
TF32 (float32 with TF32 products; ``reference.TF32``), the precision below
the configurations' float32 with TF32 off.  One JSON line a run.  The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import cell as cells
from portbench import reference as ref


def reading(cell: cells.Cell, seed: int, transitions: int, device, control: bool) -> dict:
    inputs = cells.make_inputs(cell, seed, device)
    ld = None
    if control:
        ld = cell.model.logdensity(cell.cfg, inputs.columns, inputs.y, ref.TF32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = control or bool(cell.cfg["tf32"])
    try:
        prog = cells.build_program(cell, inputs, seed, device, logdensity=ld)
        win = cells.drive(prog, 3600.0, device, max_transitions=transitions)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    calls = prog.recorder.calls
    del prog, ld
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = cells.check(cell, inputs, win, calls, seed, device)
    return {"workload": cell.name, "seed": seed, "control": control,
            "transitions": win.transitions, "numbers": numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--transitions", type=int, default=3)
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for s in seeds:
            t0 = time.perf_counter()
            r = reading(cell, s, args.transitions, device, control)
            r["seconds"] = time.perf_counter() - t0
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
