"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``gaplac_tpu_torch``, on a machine
with the cards the cell asks for.  Set-up makes the data on the card from
``--seed``, builds the program's model, its lockstep HMC transition and the
carry of the cell's adapted state, and runs every operation of the window
once; the window then runs transitions back to back for ``--seconds`` and
ends in one synchronize.  With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` (the window under ``torch.profiler``)
its per-layer metrics.  After the window the program's sampled transitions
are compared with the float64 reference (``cell.check``); each number and its
limit are the last lines of standard error and the ``checks`` key, last in
the result, the JSON object on the last line of standard output.

Exits 2 without a result when the cards are missing, 3 when a forbidden
module (JAX, the JAX package) was loaded; any other failure raises.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (the kernel's start time, to its
    10 ms ticks); 0 where /proc cannot tell."""
    try:
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


#: the process's start on the clock of time.perf_counter
T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from portbench import cell as cells  # noqa: E402
from portbench import trace as tracing  # noqa: E402


def gpu_state(index: int) -> str:
    """nvidia-smi's name, identity (UUID and PCI bus), clocks, power and
    temperature of card ``index``, one line; empty when it cannot be read."""
    q = "name,uuid,pci.bus_id,clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader",
                              "-i", str(index)], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()


def end_to_end(cell: cells.Cell, win: cells.Window, setup_s: float) -> dict:
    C = cell.traffic["chains"]
    calls = len(win.intervals_ms)
    p95 = cells.p95(win.intervals_ms)
    return {"leapfrogs_per_s": {"value": C * calls / win.seconds, "unit": "leapfrogs/s"},
            "leapfrog_p95_ms": {"value": p95, "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}


def wanted_metrics(manifest: dict, workload: str, reported: set) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    out = []
    for m in manifest["per_layer"]:
        cells_of = m.get("workloads")
        if (workload in cells_of) if cells_of is not None else (m["moves"] in reported):
            out.append(m)
    return out


def reported_end_to_end(manifest: dict, workload: str) -> set:
    return {m["name"] for m in manifest["end_to_end"]
            if workload in m.get("workloads", [workload])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    t_imported = time.perf_counter()
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # the program's own setting, stated by the configuration
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.cfg["tf32"])

    torch.empty(1, device=device)
    t_cuda = time.perf_counter()
    inputs = cells.make_inputs(cell, args.seed, device)
    cells.sync(device)
    t_data = time.perf_counter()
    prog = cells.build_program(cell, inputs, args.seed, device)
    cells.sync(device)
    setup_s = time.perf_counter() - T_START
    print(f"portbench: setup {setup_s:.3f} s: to imports {t_imported - T_START:.3f}, cuda "
          f"{t_cuda - t_imported:.3f}, data {t_data - t_cuda:.3f}, program "
          f"{time.perf_counter() - t_data:.3f}", file=sys.stderr)

    prof = tracing.profiler() if args.trace else None
    win = cells.drive(prog, args.seconds, device, profiler=prof)
    bad = cells.forbidden_modules(list(sys.modules))
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    memory_peak = torch.cuda.max_memory_allocated(device)
    print(f"gpu: {gpu_state(0)}", file=sys.stderr)
    calls = prog.recorder.calls
    C = cell.traffic["chains"]
    failed = sum(int((~torch.isfinite(c.lp)).sum()) for c in calls)
    attempted = C * len(calls)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                   "memory_peak_bytes": memory_peak}
    reported = reported_end_to_end(cell.manifest, cell.name)
    breakdown = None
    if args.trace:
        t0 = time.perf_counter()
        summary = tracing.summarize(prof)
        del prof
        if summary.busy_s > win.seconds:
            raise RuntimeError(f"the trace's device time {summary.busy_s!r} s exceeds the window's "
                               f"{win.seconds!r} s: the trace and the window disagree")
        ctx = tracing.Context(cell=cell, window=win, trace=summary, calls=len(calls),
                              attempted=attempted, failed=failed)
        metrics = {}
        for m in wanted_metrics(cell.manifest, cell.name, reported):
            value = tracing.read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = win.seconds
        breakdown = {"device_ops": summary.top_ops(10), "idle_gaps": summary.top_gaps(10)}
        print(f"portbench: trace of {len(summary.names)} device and {len(summary.host_names)} "
              f"host events read in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        del summary
    else:
        metrics = {k: v for k, v in end_to_end(cell, win, setup_s).items() if k in reported}

    # the program's state goes before the reference runs
    held = prog.recorder.calls
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = cells.check(cell, inputs, win, held, args.seed, device)
    judged = cells.judge(cell, numbers)
    correct = cells.passed(judged)
    print(f"portbench: {cell.name} seed {args.seed}: {win.transitions} transitions, "
          f"{len(held)} batched leapfrogs in {win.seconds:.3f} s; setup {setup_s:.3f} s; "
          f"check {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    bad = cells.forbidden_modules(list(sys.modules))
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k in cells.CHECKS:
        if k not in judged:
            print(f"not compared {k} {numbers[k]!r}", file=sys.stderr)
    for k, v in judged.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = judged
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
