"""The comparison that decides ``correct``, driven through the rest of a
run on the CPU at a small size (the look for a card skipped): a sound run
passes; the control (the reference in TF32 in the program's place) fails;
and each fault this sampler can have, planted in the program underneath the
timed path, fails: a transition that returns its state unchanged, a log
density that evaluates half the chains and gives the rest their mean, and a
position altered where the transition produces it.  The cells' limits are
their own, set at full size (``PERF.md``)."""

import dataclasses

import pytest
import torch

from portbench import calibrate
from portbench import cell as cells

SMALL = {
    "longitudinal_dense.hmc_n4096": {"persons": 64, "visits": 16, "n": 1024},
    "trend_rff.hmc_n65536": {"n": 8192, "rff_features": 64, "m_total": 128},
}
#: the control's size: the dense cell's control shows at n = 1024; the rff
#: cell's needs its full widths (n = 65536, m = 512), where TF32's rounding
#: of the sums over the rows moves the log density past its limit, so there
#: on 2 chains
CONTROL = {
    "longitudinal_dense.hmc_n4096": (SMALL["longitudinal_dense.hmc_n4096"],
                                     {"chains": 4, "leapfrogs": 8}, 3),
    "trend_rff.hmc_n65536": ({}, {"chains": 2, "leapfrogs": 4}, 1),
}
WORKLOADS = sorted(SMALL)


def _judged(workload, seed=21):
    cell = cells.load_cell(workload, cfg_overrides=SMALL[workload],
                           traffic_overrides={"chains": 4, "leapfrogs": 8})
    r = calibrate.reading(cell, seed, 3, "cpu", control=False)
    return cells.judge(cell, r["numbers"])


def _wrap_transition(monkeypatch, fault):
    from gaplac_tpu_torch.inference import chees

    factory = chees.hmc_transition_factory

    def broken(*a, **k):
        tr, vag = factory(*a, **k)
        return (lambda c, adapt: fault(c, *tr(c, adapt))), vag

    monkeypatch.setattr(chees, "hmc_transition_factory", broken)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    judged = _judged(workload)
    assert cells.passed(judged), judged


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_in_tf32_is_not_correct(workload):
    cfg, traffic, transitions = CONTROL[workload]
    cell = cells.load_cell(workload, cfg_overrides=cfg, traffic_overrides=traffic)
    r = calibrate.reading(cell, 21, transitions, "cpu", control=True)
    judged = cells.judge(cell, r["numbers"])
    assert not cells.passed(judged), judged


@pytest.mark.parametrize("workload", WORKLOADS)
def test_state_returned_unchanged_is_not_correct(workload, monkeypatch):
    _wrap_transition(monkeypatch, lambda old, new, out: (old, out))
    assert not cells.passed(_judged(workload))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_the_batch_is_not_correct(workload, monkeypatch):
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
    assert not cells.passed(_judged(workload))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_position_altered_is_not_correct(workload, monkeypatch):
    def nudge(old, new, out):
        q = new.q.clone()
        q[0] += 1e-3
        return new._replace(q=q), out

    _wrap_transition(monkeypatch, nudge)
    assert not cells.passed(_judged(workload))
