"""The port's ``make_scanned_train_step`` against the JAX package's on the
CPU (see test_torch_scanned_step.py) for vector and ``state_based`` CQL,
visual RIL (per-leaf draws) and the D4RL Play-LMP and TACO-RL: one chunk of
K = 3 steps from converted weights with the JAX step's draws at each step;
the last step's metrics at rtol 1e-5, the params after the chunk at atol
2.5 lr per step."""

import pytest

from tests.test_torch_scanned_step import (
    CASES,
    HERE,
    check_chunk_steps,
    check_metrics,
    check_params,
    scanned_pair_of,
)


@pytest.fixture(scope="module", params=[name for name in CASES if name not in HERE])
def scanned_pair(request, tmp_path_factory):
    return scanned_pair_of(request.param, tmp_path_factory.mktemp(request.param))


def test_the_chunk_ends_k_steps_on(scanned_pair):
    check_chunk_steps(scanned_pair)


def test_last_step_metrics_match_jax(scanned_pair):
    check_metrics(scanned_pair)


def test_params_after_the_chunk_match_jax(scanned_pair):
    check_params(scanned_pair)
