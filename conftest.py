"""Tier-1's `slow` marks and time limit, for the tests under tests/
(tests/conftest.py sets JAX up for them): the frozen JAX package's longest
tests are marked `slow`, and each setup, call and teardown of every other
test has LIMIT seconds."""

import faulthandler
import pathlib
import signal
import sys

import pytest

TESTS = pathlib.Path(__file__).parent / "tests"

# A Tier-1 test whose setup, call or teardown runs past LIMIT seconds fails
# with every thread's stack dumped, and its worker goes on to the next test.
# Twice the longest test left in Tier-1 (test_torch_vi_smc.py's ADVI test,
# 550-680 s under -n 6 on 8 cores), rounded up.
LIMIT = 1200

# The frozen JAX package's longest tests (seconds in CHANGES.md). Tier-1 runs
# `-m 'not slow'`; `python -m pytest tests/ -m slow` runs these.
SLOW = {
    "tests/test_cli.py::test_mcmc_multichain_and_resume",
    "tests/test_cli_extended.py::test_bernoulli_mcmc_cli",
    "tests/test_cli_extended.py::test_cli_mcmc_hmc_sampler",
    "tests/test_cli_extended.py::test_studentt_likelihood_mcmc",
    "tests/test_distributed.py::test_chain_sharded_sde_model",
    "tests/test_distributed.py::test_chain_sharded_whitened_sde_model",
    "tests/test_distributed.py::test_sharded_lowrank_logpdf_matches_single_device",
    "tests/test_guide_parity.py::test_guide_lengthscale_recovery",
    "tests/test_guide_parity.py::test_guide_select_chains_bayes_scale",
    "tests/test_guide_parity.py::test_guide_select_formulae_bayes_scale",
    "tests/test_infer_extras.py::test_nuts_infer_extra_matches_quadrature",
    "tests/test_laplace.py::test_cli_laplace_bernoulli",
    "tests/test_laplace.py::test_cli_mcmc_bernoulli_sde",
    "tests/test_laplace.py::test_markov_laplace_matches_dense",
    "tests/test_lowrank.py::test_cli_mcmc_rff_recovers_lengthscale",
    "tests/test_markov.py::test_build_steps_soa_native_extended_blocks",
    "tests/test_markov.py::test_build_steps_soa_native_parity",
    "tests/test_markov.py::test_cli_sample_fitplot_sde",
    "tests/test_markov.py::test_cli_sde_harmonics_flag",
    "tests/test_markov.py::test_dtf_mid_d_matches_dense_layout",
    "tests/test_markov.py::test_grouped_markov_matches_dense",
    "tests/test_markov.py::test_grouped_markov_report_latents",
    "tests/test_markov.py::test_grouped_product_sde_matches_dense",
    "tests/test_markov.py::test_legacy_composite_sde_matches_dense",
    "tests/test_markov.py::test_model_logdensity_matches_dense",
    "tests/test_markov.py::test_model_logdensity_matches_dense_matrix_state",
    "tests/test_markov.py::test_periodic_sde_accuracy",
    "tests/test_markov.py::test_product_sde_matches_dense",
    "tests/test_markov.py::test_product_ss_predict_matches_dense",
    "tests/test_markov.py::test_quasiperiodic_sde_accuracy",
    "tests/test_markov.py::test_rq_sde_accuracy",
    "tests/test_markov.py::test_sde_fitplot_components_match_dense",
    "tests/test_markov.py::test_sde_harmonics_knob",
    "tests/test_markov.py::test_sde_posterior_draw_moments",
    "tests/test_markov.py::test_soa_tiny_d_matches_dense_layout",
    "tests/test_markov.py::test_sqexp_sde_lp_error_and_grad",
    "tests/test_markov.py::test_sqexp_sde_posterior_parity",
    "tests/test_markov.py::test_ss_block_loglik_matches_dense[0-1.3]",
    "tests/test_markov.py::test_ss_block_loglik_matches_dense[1-0.9]",
    "tests/test_markov.py::test_ss_block_loglik_matches_dense[2-1.7]",
    "tests/test_markov.py::test_ss_filter_cov_matches_full_filter",
    "tests/test_markov.py::test_ss_smooth_and_predict_match_dense",
    "tests/test_markov.py::test_whitened_markov_matches_dense_whitened",
    "tests/test_markov.py::test_windowed_smoothing_matches_monolithic",
    "tests/test_nongaussian_oracle.py::test_laplace_marginal_consistent_with_quadrature",
    "tests/test_nongaussian_oracle.py::test_whitened_nuts_matches_bernoulli_quadrature",
    "tests/test_nuts.py::test_chees_gp_agrees_with_nuts",
    "tests/test_nuts.py::test_latent_whitened_agrees_with_marginal",
    "tests/test_nuts.py::test_lengthscale_recovery_marginal",
    "tests/test_posterior_exact.py::test_chees_matches_quadrature",
    "tests/test_posterior_exact.py::test_nuts_matches_quadrature",
    "tests/test_priors.py::test_gamma_prior_matches_quadrature",
    "tests/test_priors.py::test_lognormal_prior_shifts_nuts_posterior",
    "tests/test_routing.py::test_cli_sde_guard_fires_end_to_end",
    "tests/test_vi_smc.py::test_advi_gp_agrees_with_posterior_shape",
}


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # before `-m` deselects
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


def _out_of_time(signum, frame):
    # sys.__stderr__ has a file descriptor under every --capture mode
    faulthandler.dump_traceback(sys.__stderr__)
    pytest.fail(f"ran past the {LIMIT} s limit of one test", pytrace=False)


def _limited(item):
    # `slow` tests run outside Tier-1's clock, and the longest of them take
    # 900-1900 s under -n 6
    if item.path.parent != TESTS or item.get_closest_marker("slow"):
        return (yield)
    previous = signal.signal(signal.SIGALRM, _out_of_time)
    signal.setitimer(signal.ITIMER_REAL, LIMIT)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


# One phase at a time, so that the timer fires only inside pytest's own
# catch of the phase and never while the worker reports a result
@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _limited(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    return (yield from _limited(item))
