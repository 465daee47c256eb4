"""One cell of the benchmark: inputs made from the seed, the program's
lockstep HMC transition from the cell's adapted state, the timed window, its
trace, and the comparison with the plain reference that decides ``correct``.

The pieces are separate so that ``run.py`` (one run of a cell),
``calibrate.py`` (the limits' readings) and the tests compose them.  The
program under test is ``gaplac_tpu_torch``; it is imported inside the
functions that build it, so that this module and the reference load without
it.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import statistics
import time
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional

import torch

from portbench import reference as ref

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent

#: top-level module names that no run may load: the JAX package and JAX
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gaplac_tpu")

#: the sampler's generator is seeded apart from the data's
SAMPLER_SEED_OFFSET = 1 << 40


def load_module(path: Path):
    """A Python file under the benchmark's folder, loaded by its path."""
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(NamedTuple):
    name: str
    chips: int
    cfg: dict
    model: object       # the configuration's module: make_data, logdensity
    traffic_name: str
    traffic: dict
    manifest: dict


def load_cell(workload: str, manifest_path: Path = REPO / "BENCHMARK.json",
              cfg_overrides: Optional[dict] = None,
              traffic_overrides: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of the manifest: its configuration (the JSON
    file the manifest names, and the module of the same stem beside it) and
    its traffic (``traffic/<name>.json``).  Overrides replace top-level keys
    (the tests' small sizes)."""
    manifest = json.loads(manifest_path.read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {manifest_path.name}")
    w = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    cfg_path = REPO / entry["file"]
    cfg = {**json.loads(cfg_path.read_text()), **(cfg_overrides or {})}
    traffic = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())
    traffic = {**traffic, **(traffic_overrides or {})}
    return Cell(workload, w["chips"], cfg, load_module(cfg_path.with_suffix(".py")),
                w["traffic"], traffic, manifest)


class Inputs(NamedTuple):
    columns: dict           # name -> (n,) in the working dtype
    y: torch.Tensor
    dtype: torch.dtype


def working_dtype(cfg: dict) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[cfg["precision"]]


def make_inputs(cell: Cell, seed: int, device) -> Inputs:
    """The data from ``seed``, made in float64 on ``device`` and rounded to
    the configuration's precision: both sides get these values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    data = cell.model.make_data(cell.cfg, gen, device)
    dt = working_dtype(cell.cfg)
    return Inputs({k: v.to(dt) for k, v in data["columns"].items()}, data["y"].to(dt), dt)


class Call:
    """One call into the log density: the position, its log density and,
    once autograd reaches it, its gradient."""

    __slots__ = ("q", "lp", "g")

    def __init__(self, q: torch.Tensor):
        self.q, self.lp, self.g = q.detach(), None, None

    def take_grad(self, g: torch.Tensor) -> None:
        self.g = g


class Recorder:
    """The log density handed to the sampler.  While ``on``, each call
    records a CUDA event on the stream (``timing``) and keeps references to
    its position, log density and gradient; nothing here waits for the
    device."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], timing: bool):
        self.fn, self.timing, self.on = fn, timing, False
        self.calls: List[Call] = []
        self.events: List[torch.cuda.Event] = []

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return self.fn(q)
        if self.timing:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        call = Call(q)
        if q.requires_grad:
            q.register_hook(call.take_grad)
        lp = self.fn(q)
        call.lp = lp.detach()
        self.calls.append(call)
        return lp


class State(NamedTuple):
    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor


class Program(NamedTuple):
    recorder: Recorder
    transition: Callable
    carry: object


def adapted_state(cell: Cell, dtype, device):
    """(step size, inverse mass, positions) of the traffic's adapted state,
    the positions cut to the traffic's chain count."""
    st = cell.traffic["adapted_state"]
    C = cell.traffic["chains"]
    q0 = torch.tensor(st["positions"], dtype=dtype, device=device)[:C]
    if q0.shape[0] != C:
        raise ValueError(f"the adapted state holds {q0.shape[0]} chains, the cell runs {C}")
    return float(st["step_size"]), torch.tensor(st["inv_mass"], dtype=dtype, device=device), q0


def program_model(cell: Cell, inputs: Inputs):
    """The program's model of the configuration, built as ``mcmc`` builds
    it."""
    from gaplac_tpu_torch.dsl import parse_formula
    from gaplac_tpu_torch.inference.model import build_model
    from gaplac_tpu_torch.inference.priors import parse_prior
    from gaplac_tpu_torch.kernels.covariance import compile_formula

    cfg = cell.cfg
    spec = parse_formula(cfg["formula"])
    ck = compile_formula(spec.formula)
    X = torch.stack([inputs.columns[v] for v in ck.varnames], dim=1)
    return build_model(
        ck, cfg["infer"], X, inputs.y, spec.likelihood, jitter=cfg["jitter"],
        prior_bounds=parse_prior(cfg["prior"]), shared_hyper=cfg["infer_mode"] == "shared",
        approx=cfg["approx"] if cfg["approx"] in ("rff", "sde") else "exact",
        rff_features=cfg.get("rff_features", 256), rff_seed=cfg.get("rff_seed", 0))


def build_program(cell: Cell, inputs: Inputs, seed: int, device,
                  logdensity: Optional[Callable] = None) -> Program:
    """The sampling transition of ``hmc_transition_factory`` over the
    recorded log density (the program's model, or ``logdensity`` put in its
    place), its carry from the adapted state, and one transition of one
    leapfrog from a copy of that carry on a generator of its own, so that
    every operation of the window has run once."""
    from gaplac_tpu_torch.inference import chees

    if logdensity is None:
        model = program_model(cell, inputs)
        logdensity, dim = model.logdensity, model.dim
    else:
        dim = len(cell.traffic["adapted_state"]["inv_mass"])
    C, L = cell.traffic["chains"], cell.traffic["leapfrogs"]
    rec = Recorder(logdensity, timing=torch.device(device).type == "cuda")
    transition, vag = chees.hmc_transition_factory(rec, C, dim, L,
                                                   cell.traffic["target_accept"])
    eps0, inv_mass, q0 = adapted_state(cell, inputs.dtype, device)
    gen = torch.Generator(device=device).manual_seed(seed + SAMPLER_SEED_OFFSET)
    carry = chees.hmc_init_carry(vag, gen, q0, eps0, inv_mass)
    warm, _ = chees.hmc_transition_factory(rec, C, dim, 1, cell.traffic["target_accept"])
    warm(carry._replace(gen=torch.Generator(device=device).manual_seed(seed)), False)
    return Program(rec, transition, carry)


class Window(NamedTuple):
    seconds: float             # host clock, ended by the synchronize
    transitions: int
    states: List[State]        # the carry before each transition, and after the last
    intervals_ms: List[float]  # one a batched leapfrog, device clock (CUDA only)
    peak_bytes: int            # allocated, over the window (CUDA only)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def drive(prog: Program, seconds: float, device, max_transitions: Optional[int] = None,
          profiler=None) -> Window:
    """Transitions back to back from the adapted carry until the first
    transition boundary past ``seconds`` (or ``max_transitions``), then one
    synchronize.  Under ``profiler`` the window is traced."""
    cuda = torch.device(device).type == "cuda"
    rec = prog.recorder
    rec.calls.clear()
    rec.events.clear()
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    carry = prog.carry
    states = [State(carry.q, carry.logp, carry.grad)]
    if profiler is not None:
        profiler.start()
    rec.on = True
    t0 = time.perf_counter()
    deadline = t0 + seconds
    n = 0
    while True:
        carry, _ = prog.transition(carry, False)
        states.append(State(carry.q, carry.logp, carry.grad))
        n += 1
        if time.perf_counter() >= deadline or (max_transitions and n >= max_transitions):
            break
    end = None
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
    sync(device)
    t1 = time.perf_counter()
    rec.on = False
    if profiler is not None:
        profiler.stop()
    intervals, peak = [], 0
    if cuda:
        evs = rec.events + [end]
        intervals = [a.elapsed_time(b) for a, b in zip(evs[:-1], evs[1:])]
        peak = torch.cuda.max_memory_allocated(device)
    return Window(t1 - t0, n, states, intervals, peak)


def p95(intervals_ms: List[float]) -> float:
    """The 95th percentile of the window's batched leapfrogs (ms)."""
    return statistics.quantiles(intervals_ms, n=100, method="inclusive")[94]


def forbidden_modules(modules) -> List[str]:
    """Names among ``modules`` whose top-level part is a forbidden package,
    compared whole (``gaplac_tpu_torch`` is not ``gaplac_tpu``)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES)


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------

#: the numbers compared, in the order they are printed
CHECKS = ("missing_calls", "nonfinite", "lp_gap", "grad_gap", "step_gap", "accept_mismatch")


def sampled_transitions(n: int, seed: int) -> List[int]:
    """The first transition, the last, and one between drawn from ``seed``."""
    picks = {0, n - 1}
    if n > 2:
        picks.add(random.Random(seed).randrange(1, n - 1))
    return sorted(picks)


def check(cell: Cell, inputs: Inputs, win: Window, calls: List[Call], seed: int,
          device) -> dict:
    """The numbers that decide ``correct``, from the sampled transitions of
    the window, each audited by the float64 reference from the program's own
    positions (``reference.audit_transition``), with the momenta and
    uniforms the reference draws again from the sampler's seed:

    - ``missing_calls``: batched log-density calls short of leapfrogs x
      transitions;
    - ``nonfinite``: compared positions (those whose energy lies at most
      ``reference.ENERGY_LIMIT`` above their trajectory's start) at which the
      program's log density or gradient is not finite;
    - ``lp_gap`` (nats), ``grad_gap`` (over the larger of the reference's
      norm and the median one at the starts) and ``step_gap`` (posterior
      sd): the largest over the other compared positions and chains;
    - ``accept_mismatch``: chains whose move is neither the trajectory's end
      nor its start, or whose Metropolis decision differs from the one the
      reference's log acceptance ratio gives where that lies farther than
      ``accept_margin`` from log u."""
    tr = cell.traffic
    C, L = tr["chains"], tr["leapfrogs"]
    eps0, inv_mass, _ = adapted_state(cell, inputs.dtype, device)
    inv_mass = inv_mass.double()
    columns64 = {k: v.double() for k, v in inputs.columns.items()}
    ld = cell.model.logdensity(cell.cfg, columns64, inputs.y.double(), ref.FLOAT64)
    vag = lambda q: ref.value_and_grad(ld, q.double())
    picks = [k for k in sampled_transitions(win.transitions, seed) if (k + 1) * L <= len(calls)]
    draws = ref.replay_draws(seed + SAMPLER_SEED_OFFSET, win.transitions, C, inv_mass.numel(),
                             inputs.dtype, device)
    missing = max(0, L * win.transitions - len(calls))
    # the gradient scale: the median of the reference's norms at every start
    starts = torch.stack([vag(win.states[k].q)[1].norm(dim=-1) for k in picks])
    scale = starts.median()
    audits, mismatch = [], 0
    for k in picks:
        start, after = win.states[k], win.states[k + 1]
        chunk = calls[k * L:(k + 1) * L]
        missing_grad = torch.full_like(start.grad, math.nan)
        qs = torch.stack([start.q] + [c.q for c in chunk]).double()
        lps = torch.stack([start.logp] + [c.lp for c in chunk])
        grads = torch.stack([start.grad] + [missing_grad if c.g is None else c.g for c in chunk])
        z, u = draws[k]
        a = ref.audit_transition(vag, qs, lps, grads, z.double(), inv_mass,
                                 ref.step_size(eps0, k), scale)
        audits.append(a)
        moved = (after.q == chunk[-1].q).all(-1)
        stayed = (after.q == start.q).all(-1)
        log_u = torch.log(u.double())
        decided = (log_u - a.log_accept).abs() > tr["check"]["accept_margin"]
        ref_acc = log_u < a.log_accept
        bad = ~(moved | stayed) | (decided & ~(moved & stayed) & (moved != ref_acc))
        mismatch += int(bad.sum())
    worst = lambda f: max((float(getattr(a, f).amax()) for a in audits), default=0.0)
    return {"missing_calls": float(missing),
            "nonfinite": float(sum(int(a.nonfinite.sum()) for a in audits)),
            "lp_gap": worst("lp_gap"),
            "grad_gap": worst("grad_gap"), "step_gap": worst("step_gap"),
            "accept_mismatch": float(mismatch)}


def judge(cell: Cell, numbers: dict) -> dict:
    """Each number compared beside its limit: {name: {"value", "limit"}}.
    A number whose limit is null is not compared (``PERF.md`` says why)."""
    limits = cell.traffic["check"]["limits"]
    return {k: {"value": numbers[k], "limit": limits[k]} for k in CHECKS
            if limits.get(k) is not None}


def passed(judged: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in judged.values())
