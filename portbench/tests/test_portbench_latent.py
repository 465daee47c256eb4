"""The whitened latent cell (``longitudinal_poisson``) at a small size on the
CPU: the plain reference against the program in float64, the comparison that
decides ``correct`` on a sound run, on the control and on each planted fault
of ``test_portbench_check.py``, and the adjoint the program's gradient takes.
The cell's own adapted state has the full size's 4097 dimensions, so the
small cell starts from one made here the same way, by ``run_hmc``'s warm-up
on seed 0's data."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import calibrate
from portbench import cell as cells
from portbench import reference as ref
from portbench import trace
from portbench.tests.test_portbench_check import _wrap_transition

WORKLOAD = "longitudinal_poisson.hmc_latent_n4096"
SMALL = {"persons": 8, "visits": 6, "n": 48}
TRAFFIC = {"chains": 4, "leapfrogs": 8}


@pytest.fixture(scope="module")
def small_state():
    """The small cell's adapted state: 60 warm-up transitions and one sampling
    transition from the model's initial positions, as ``portbench.adapt``."""
    from gaplac_tpu_torch.inference.chees import run_hmc

    cell = cells.load_cell(WORKLOAD, cfg_overrides=SMALL, traffic_overrides=TRAFFIC)
    model = cells.program_model(cell, cells.make_inputs(cell, 0, "cpu"))
    gen = torch.Generator().manual_seed(0)
    res = run_hmc(gen, model.logdensity, model.initial_position(gen, TRAFFIC["chains"]),
                  num_samples=1, num_warmup=60, num_leapfrogs=TRAFFIC["leapfrogs"],
                  target_accept=0.65, init_step_size=0.1)
    return {"step_size": float(res.step_size), "inv_mass": res.inv_mass.double().tolist(),
            "positions": res.positions[:, -1].double().tolist()}


def _cell(state, **cfg):
    return cells.load_cell(WORKLOAD, cfg_overrides={**SMALL, **cfg},
                           traffic_overrides={**TRAFFIC, "adapted_state": state})


def _judged(state, seed=21, control=False):
    cell = _cell(state)
    r = calibrate.reading(cell, seed, 3, "cpu", control=control)
    return cells.judge(cell, r["numbers"])


def test_log_density_and_gradient_match_the_program(small_state):
    cell = _cell(small_state, precision="float64")
    inputs = cells.make_inputs(cell, 11, "cpu")
    model = cells.program_model(cell, inputs)
    assert not model.marginalized and model.dim == 1 + SMALL["n"]
    ld = cell.model.logdensity(cell.cfg, inputs.columns, inputs.y, ref.FLOAT64)
    v = torch.tensor(small_state["positions"], dtype=torch.float64)
    v = v + 0.1 * torch.randn(v.shape, generator=torch.Generator().manual_seed(0),
                              dtype=torch.float64)
    lp_p, g_p = ref.value_and_grad(model.logdensity, v)
    lp_r, g_r = ref.value_and_grad(ld, v)
    torch.testing.assert_close(lp_p, lp_r, rtol=1e-10, atol=1e-8)
    torch.testing.assert_close(g_p, g_r, rtol=1e-8, atol=1e-8)


def test_one_transition_takes_murrays_pullback_at_each_leapfrog(small_state):
    from gaplac_tpu_torch.ops import _build

    cell = _cell(small_state)
    prog = cells.build_program(cell, cells.make_inputs(cell, 5, "cpu"), 5, "cpu")
    before = dict(_build.adjoints)
    prog.transition(prog.carry, False)
    moved = {k: _build.adjoints[k] - before[k] for k in before}
    assert moved == {"gaussian": 0, "murray": TRAFFIC["leapfrogs"]}


def test_sound_run_is_correct(small_state):
    judged = _judged(small_state)
    assert cells.passed(judged), judged


def test_control_in_tf32_is_not_correct(small_state):
    assert not cells.passed(_judged(small_state, control=True))


def test_state_returned_unchanged_is_not_correct(small_state, monkeypatch):
    _wrap_transition(monkeypatch, lambda old, new, out: (old, out))
    assert not cells.passed(_judged(small_state))


def test_half_the_batch_is_not_correct(small_state, monkeypatch):
    from gaplac_tpu_torch.inference import model as model_mod

    build = model_mod.build_model

    def half_batch(*a, **k):
        m = build(*a, **k)

        def logdensity(q):
            h = q.shape[0] // 2
            lp = m.logdensity(q[:h])
            return torch.cat([lp, lp.mean().expand(q.shape[0] - h)])

        return dataclasses.replace(m, logdensity=logdensity)

    monkeypatch.setattr(model_mod, "build_model", half_batch)
    assert not cells.passed(_judged(small_state))


def test_position_altered_is_not_correct(small_state, monkeypatch):
    def nudge(old, new, out):
        q = new.q.clone()
        q[0] += 1e-3
        return new._replace(q=q), out

    _wrap_transition(monkeypatch, nudge)
    assert not cells.passed(_judged(small_state))


def test_readers_of_the_latent_ranges_and_the_trsm_kernels():
    names = ["gaplac.latent.gram", "gaplac.latent.factor", "chol_batched_kernel",
             "void kernel_trsm_l_mul32<float>", "void trsm_right_kernel<int, float>",
             "gaplac.latent.map", "gaplac.latent.loglik", "gaplac.latent.other", "sgemm"]
    dur = np.array([1, 30, 29, 8, 6, 2, 1, 50, 20], np.int64) * 10**6
    s = trace.Summary(names, np.cumsum(dur) - dur, dur, np.ones(len(names), bool), [],
                      np.array([], np.int64), np.array([], np.int64), np.array([], bool))
    ctx = trace.Context(cell=None, window=None, trace=s, calls=2, attempted=0, failed=0)
    assert trace.read_metric("latent_fwd_ms_per_step", ctx) == pytest.approx(17.0)
    assert trace.read_metric("pullback_trsm_ms_per_step", ctx) == pytest.approx(7.0)
    none = trace.Summary(["sgemm"], dur[:1], dur[:1], np.ones(1, bool), [], np.array([], np.int64),
                         np.array([], np.int64), np.array([], bool))
    ctx = ctx._replace(trace=none)
    assert trace.read_metric("latent_fwd_ms_per_step", ctx) is None
    assert trace.read_metric("pullback_trsm_ms_per_step", ctx) is None
