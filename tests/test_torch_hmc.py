"""The port's fixed-trajectory HMC against gaplac_tpu's, float64 on the CPU:
one transition fed gaplac_tpu's own momentum and uniform, the segmented
sampler against the monolithic one bit for bit, and the MVN calibration
oracle of tests/test_nuts.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaplac_tpu.dsl import parse_formula as jax_parse
from gaplac_tpu.inference import chees as jchees
from gaplac_tpu.inference.model import build_model as jax_build_model
from gaplac_tpu.kernels.covariance import compile_formula as jax_compile
from gaplac_tpu_torch.dsl import parse_formula
from gaplac_tpu_torch.inference import chees
from gaplac_tpu_torch.inference.model import build_model
from gaplac_tpu_torch.inference.segmented import run_hmc_segmented
from gaplac_tpu_torch.kernels.covariance import compile_formula


def _close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("adapt", [True, False])
def test_transition_matches_jax(monkeypatch, adapt):
    """One transition of the whitened GP model (dim 13, 4 chains, 5
    leapfrogs) from the same carry, with gaplac_tpu's momentum and uniform:
    the new positions, densities, gradients, acceptance and adaptation
    state to 1e-12."""
    rng = np.random.default_rng(0)
    n, C, L = 12, 4, 5
    x = rng.uniform(-5, 5, n)
    y = rng.normal(size=n)
    formula = "y ~| SqExp(:x)"
    jm = jax_build_model(jax_compile(jax_parse(formula).formula), ["x"], jnp.asarray(x[:, None]),
                         jnp.asarray(y), jax_parse(formula).likelihood, marginalize=False)
    m = build_model(compile_formula(parse_formula(formula).formula), ["x"],
                    torch.as_tensor(x[:, None]), torch.as_tensor(y),
                    parse_formula(formula).likelihood, marginalize=False)
    q0 = rng.normal(size=(C, n + 1)) * 0.2
    im = rng.uniform(0.5, 1.5, n + 1)

    jtrans, jbvag = jchees.hmc_transition_factory(jm.logdensity, C, n + 1, jnp.float64, L)
    jc = jchees.hmc_init_carry(jbvag, jax.random.key(3), jnp.asarray(q0), 0.15, jnp.asarray(im),
                               n + 1, jnp.float64)
    jc = jc._replace(iter=jnp.asarray(5, jnp.int32))
    jnew, (jq, jlp, jalpha) = jax.jit(lambda c: jtrans(c, adapt))(jc)
    _, k_mom, k_acc = jax.random.split(jc.key, 3)
    z = np.array(jax.random.normal(k_mom, (C, n + 1), jnp.float64))
    u = np.array(jax.random.uniform(k_acc, (C,), jnp.float64))

    monkeypatch.setattr(chees, "sample_momentum",
                        lambda gen, inv_mass, shape: torch.as_tensor(z) * torch.rsqrt(inv_mass))
    monkeypatch.setattr(chees, "accept_uniform", lambda gen, n_chains, like: torch.as_tensor(u))
    trans, vag = chees.hmc_transition_factory(m.logdensity, C, n + 1, L)
    c = chees.hmc_init_carry(vag, torch.Generator(), torch.as_tensor(q0), 0.15,
                             torch.as_tensor(im))._replace(iter=5)
    new, (q, lp, alpha) = trans(c, adapt)
    for got, ref in ((q, jq), (lp, jlp), (alpha, jalpha), (new.grad, jnew.grad)):
        _close(got, ref)
    assert new.iter == 6
    np.testing.assert_array_equal(new.q.numpy(), q.numpy())
    _close(np.asarray(new.da, float), np.asarray([float(v) for v in jnew.da]))
    _close(new.wf.mean, jnew.wf.mean)
    _close(new.wf.m2, jnew.wf.m2)
    assert new.wf.count == float(jnew.wf.count)


def _mvn(cov):
    prec = torch.as_tensor(np.linalg.inv(cov))
    return lambda q: -0.5 * torch.sum((q @ prec) * q, dim=-1)


def test_segmented_equals_monolithic_bit_for_bit():
    """tests/test_nuts.py's segmented contract: for one generator seed, the
    segmented sampler draws what run_hmc draws, warmup adaptation included,
    whatever the segment size; a checkpoint a sampling segment."""
    ld = _mvn(np.array([[2.0, 0.9], [0.9, 1.0]]))
    q0 = torch.randn((4, 2), generator=torch.Generator().manual_seed(3),
                     dtype=torch.float64) * 0.3
    kwargs = dict(num_warmup=21, num_leapfrogs=8, init_step_size=0.2)
    ref = chees.run_hmc(torch.Generator().manual_seed(4), ld, q0, 30, **kwargs)
    for seg in (5, 13, 64):
        states = []
        res = run_hmc_segmented(torch.Generator().manual_seed(4), ld, q0, 30, segment_size=seg,
                                checkpoint_cb=states.append, **kwargs)
        for got, want in zip(res, ref):
            if isinstance(want, torch.Tensor):
                assert torch.equal(got, want)
            else:
                assert got == want
        assert len(states) == -(-30 // seg)
        np.testing.assert_array_equal(states[-1]["positions"], ref.positions[:, -1].numpy())
        np.testing.assert_array_equal(states[-1]["inv_mass"], ref.inv_mass.numpy())
    with pytest.raises(ValueError, match="segment_size"):
        run_hmc_segmented(torch.Generator(), ld, q0, 3, segment_size=0)


def test_hmc_mvn_calibration():
    """tests/test_nuts.py::test_hmc_mvn_calibration: run_hmc recovers a
    correlated MVN's moments."""
    cov = np.array([[2.0, 0.9, 0.0], [0.9, 1.0, 0.3], [0.0, 0.3, 0.5]])
    gen = torch.Generator().manual_seed(1)
    q0 = torch.randn((16, 3), generator=torch.Generator().manual_seed(0),
                     dtype=torch.float64) * 0.1
    res = chees.run_hmc(gen, _mvn(cov), q0, 500, num_warmup=500, num_leapfrogs=16)
    qs = res.positions.reshape(-1, 3).numpy()
    np.testing.assert_allclose(qs.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(qs.T), cov, atol=0.3)
    assert 0.4 < float(res.accept_prob.mean()) < 0.99


def test_hmc_zero_warmup_respects_step_size():
    q0 = torch.randn((4, 3), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    res = chees.run_hmc(torch.Generator().manual_seed(1), lambda q: -0.5 * torch.sum(q * q, -1),
                        q0, 10, num_warmup=0, init_step_size=0.05, num_leapfrogs=4)
    assert res.step_size == 0.05
    np.testing.assert_array_equal(res.inv_mass.numpy(), 1.0)
    assert torch.isfinite(res.positions).all() and res.positions.shape == (4, 10, 3)


def test_step_jitter_matches_jax():
    """0.8 + 0.4 * halton(i), rounded as gaplac_tpu's compiled transition
    rounds it (a float64 step times the float32 jitter)."""
    jitter = jax.jit(lambda i: jnp.exp(jnp.zeros((), jnp.float64))
                     * (0.8 + 0.4 * jchees._halton(i)))
    for i in (0, 1, 5, 77, 4095):
        assert chees.step_jitter(i) == float(jitter(jnp.asarray(i, jnp.int32)))


def test_progress_lines(capsys):
    """The emitter prints [phase] done/total about every 5% and at the end,
    as gaplac_tpu's does; the samplers print a warmup and a sampling line."""
    from gaplac_tpu_torch.inference.progress import progress_emitter

    emit = progress_emitter("warmup", 40, True)
    for i in range(40):
        emit(i)
    err = capsys.readouterr().err
    assert err == "".join(f"\r[warmup] {d}/40" for d in range(2, 41, 2)) + "\n"
    silent = progress_emitter("warmup", 40, False)
    silent(0)
    assert capsys.readouterr().err == ""
    q0 = torch.zeros((2, 1), dtype=torch.float64)
    chees.run_hmc(torch.Generator().manual_seed(0), lambda q: -0.5 * torch.sum(q * q, -1), q0,
                  3, num_warmup=4, num_leapfrogs=2, progress=True)
    assert capsys.readouterr().err.split("\n")[:2] == ["\r[warmup] 1/4\r[warmup] 2/4\r[warmup] 3/4"
                                                      "\r[warmup] 4/4",
                                                      "\r[sampling] 1/3\r[sampling] 2/3"
                                                      "\r[sampling] 3/3"]
