"""The SAC and CQL-online train steps of tests/test_torch_online_rl.py on
the visual layout (the tiny config of tests/test_online_rl.py, the JAX
Pallas tail in interpret mode), in a file of their own so that each file
runs well under a minute: the same checks at the same tolerances."""

import pytest

from tests.test_torch_online_rl import (  # noqa: F401  (collected here with this file's step_case)
    run_step_case,
    test_post_step_params_match_jax,
    test_sac_state_has_lagrange_only_when_configured,
    test_the_metric_keys_match_jax,
    test_the_play_step_matches_jax,
    test_the_step_samples_the_same_batch,
    test_train_step_grads_match_jax,
    test_train_step_metric_matches_jax,
)


@pytest.fixture(scope="module", params=["sac", "cql_online"])
def step_case(request):
    return run_step_case(request.param, "visual")
