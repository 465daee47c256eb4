"""Make a cell's adapted state with the program's own warm-up:

    python3 -m portbench.adapt --workload <name> --warmup 100

On the cell's inputs at seed 0, ``run_hmc`` (``mcmc --sampler hmc``'s
sampler) from the model's initial positions (its generator seeded with 0, as
``mcmc --seed 0``) runs ``--warmup`` adapting transitions of the traffic's
leapfrogs and one sampling transition, and keeps what ``mcmc --checkpoint``
keeps: the last positions of every chain, the adapted step size and the
inverse mass.  The state is written into the cell's traffic file, with how
it was made, and printed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import cell as cells


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--warmup", type=int, default=100)
    args = p.parse_args(argv)
    from gaplac_tpu_torch.inference.chees import run_hmc

    cell = cells.load_cell(args.workload)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.cfg["tf32"])
    inputs = cells.make_inputs(cell, 0, device)
    model = cells.program_model(cell, inputs)
    gen = torch.Generator(device=device).manual_seed(0)
    q0 = model.initial_position(gen, cell.traffic["chains"])
    t0 = time.perf_counter()
    res = run_hmc(gen, model.logdensity, q0, num_samples=1, num_warmup=args.warmup,
                  num_leapfrogs=cell.traffic["leapfrogs"],
                  target_accept=cell.traffic["target_accept"], init_step_size=0.1)
    cells.sync(device)
    name = torch.cuda.get_device_name(device)
    state = {
        "step_size": float(res.step_size),
        "inv_mass": res.inv_mass.double().cpu().tolist(),
        "positions": res.positions[:, -1].double().cpu().tolist(),
        "made_by": (f"python3 -m portbench.adapt --workload {cell.name} --warmup {args.warmup}: "
                    f"gaplac_tpu_torch.inference.chees.run_hmc on the cell's inputs at seed 0, "
                    f"{args.warmup} warmup transitions of {cell.traffic['leapfrogs']} leapfrogs "
                    f"from U(-2, 2) positions (generator seed 0), init step 0.1, then one "
                    f"sampling transition; the last positions, step size and inverse mass, as "
                    f"mcmc --checkpoint keeps them; on {name}, "
                    f"{time.perf_counter() - t0:.1f} s; last accept probabilities "
                    f"{[round(a, 3) for a in res.accept_prob[:, -1].double().cpu().tolist()]}"),
    }
    path = cells.ROOT / "traffic" / f"{cell.traffic_name}.json"
    traffic = json.loads(path.read_text())
    traffic["adapted_state"] = state
    path.write_text(json.dumps(traffic, indent=2) + "\n")
    print(json.dumps({"workload": cell.name, "adapted_state": state}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
