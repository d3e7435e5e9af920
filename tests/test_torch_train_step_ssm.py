"""One train step of the port against repro's ``_train_step`` for the SSM
families, mamba2-130m (ssm) and zamba2-2.7b (hybrid, 4 layers, so two
groups share the attention block): the checks and tolerances of
test_torch_train_step.py, whose helper this file runs."""

import pytest

from test_torch_train_step import check_step


@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-2.7b"])
def test_train_step_matches_repro(name):
    check_step(name)
