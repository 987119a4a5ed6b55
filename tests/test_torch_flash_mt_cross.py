"""The port's multitask train attention (``ops/flash_train.py``) against
the JAX package's, cross half: ``flash_cross_attention_plain`` (forward and
the gradients of q, k, v, wkr, u and v) against JAX's Pallas kernel run in
interpret mode, in float32 with K > L and dropout and in bf16 with K = L
without it; the train attention with no memory (the multitask decoder's
call) on fully padded query rows, where the TPU backward's dS is not zero;
and chip_smoke.py's check against a plain version whose band is not
applied. Inputs, tolerances and the check's runner: tests/
test_torch_flash_mt.py.
"""

import numpy as np
import pytest
import torch

from deepmusicgeneration_tpu_torch.ops import flash_train as ft
from test_torch_flash_mt import (CASES, F32_GRAD_ATOL, F32_RTOL, FAULTS, OUTPUTS, _jax_run,
                                 _torch_run, check_against_jax, check_fault)

MY_CASES = ("cross_k256_dropout", "cross_bf16", "train_m0_blocked_rows")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's interpret-mode kernels on this file's cases (run once)."""
    return {case: _jax_run(case) for case in MY_CASES}


@pytest.mark.parametrize("name", OUTPUTS)
@pytest.mark.parametrize("case", MY_CASES[:2])
def test_cross_plain_matches_jax_interpret_kernel(jax_runs, case, name):
    check_against_jax(_torch_run(case), jax_runs[case], case, name)


@pytest.mark.parametrize("name", OUTPUTS)
def test_fully_blocked_rows_carry_the_tpu_backward(jax_runs, name):
    """At M = 0 the first 40 query rows of batch row 1 see only padded keys:
    their probabilities are uniform and the TPU backward's dS there is not
    zero; the plain version's mask passes the gradient through as it does
    (the k gradient of those keys would be 0 through a plain where)."""
    case = "train_m0_blocked_rows"
    want = jax_runs[case]
    assert CASES[case][2] and np.abs(want[2][1, :40]).max() > 1e-3   # dk of the padded keys
    check_against_jax(_torch_run(case), want, case, name)


def test_cross_check_fails_a_plain_version_without_the_band():
    check_fault("band_not_applied")
