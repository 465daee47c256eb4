"""The plain reference against the program at a tiny size on the CPU, both
in float64: the log density and its gradient of each configuration, and the
sampler's draws and steps as the reference replays them."""

import math

import pytest
import torch

from portbench import cell as cells
from portbench import reference as ref

SMALL = {
    "longitudinal_dense.hmc_n4096": {"persons": 8, "visits": 6, "n": 48},
    "trend_rff.hmc_n65536": {"n": 300, "rff_features": 16, "m_total": 32},
}


def _cell(workload, **cfg):
    return cells.load_cell(workload, cfg_overrides={**SMALL[workload], **cfg},
                           traffic_overrides={"chains": 3, "leapfrogs": 4})


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_log_density_and_gradient_match_the_program(workload):
    cell = _cell(workload, precision="float64")
    inputs = cells.make_inputs(cell, 11, "cpu")
    model = cells.program_model(cell, inputs)
    ld = cell.model.logdensity(cell.cfg, inputs.columns, inputs.y, ref.FLOAT64)
    u = torch.randn((3, model.dim), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64) * 0.5 - 1.5
    lp_p, g_p = ref.value_and_grad(model.logdensity, u)
    lp_r, g_r = ref.value_and_grad(ld, u)
    torch.testing.assert_close(lp_p, lp_r, rtol=1e-10, atol=1e-8)
    torch.testing.assert_close(g_p, g_r, rtol=1e-8, atol=1e-8)


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2**-12, 1.0 + 2**-11, -1.0 - 3 * 2**-12, 3.14159])
    assert ref.tf32_round(x).tolist() == [1.0, 1.0 + 2**-10, -1.0 - 2**-10, 3.140625]


def test_blocked_cholesky_is_the_factor():
    g = torch.Generator().manual_seed(1)
    a = torch.randn((2, 300, 300), generator=g, dtype=torch.float64)
    A = a @ a.mT + 300 * torch.eye(300, dtype=torch.float64)
    torch.testing.assert_close(ref.cholesky(A, ref.FLOAT64, block=64), torch.linalg.cholesky(A))


def test_halton_jitter_and_draws_follow_the_program():
    from gaplac_tpu_torch.inference.chees import halton, step_jitter

    for i in range(40):
        assert ref.radical_inverse2(i) == pytest.approx(halton(i), abs=1e-7)
        assert ref.step_size(0.5, i) == pytest.approx(0.5 * step_jitter(i), rel=1e-6)
    (z, u), = ref.replay_draws(5, 1, 3, 2, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(z, torch.randn((3, 2), generator=gen))
    assert torch.equal(u, torch.rand((3,), generator=gen))


def test_dense_gradient_is_the_textbook_one():
    g = torch.Generator().manual_seed(2)
    a = torch.randn((40, 40), generator=g, dtype=torch.float64)
    K = (a @ a.T / 40 + torch.eye(40, dtype=torch.float64))[None].requires_grad_(True)
    y = torch.randn((40,), generator=g, dtype=torch.float64)
    lp = ref.dense_gaussian_lp(K, y, ref.FLOAT64)
    (gk,) = torch.autograd.grad(lp.sum(), K)
    Kd = K.detach()[0]
    want = -0.5 * (y @ torch.linalg.solve(Kd, y) + torch.logdet(Kd) + 40 * math.log(2 * math.pi))
    torch.testing.assert_close(lp[0], want)
    alpha = torch.linalg.solve(Kd, y)
    torch.testing.assert_close(gk[0], 0.5 * (torch.outer(alpha, alpha) - torch.linalg.inv(Kd)))
