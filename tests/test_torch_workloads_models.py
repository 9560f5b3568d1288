"""The model-bound workloads on reduced paper-mlp, the model the plan zoo's
``paper_mlp.json`` was searched on (the tests and their tolerances:
``tests/_torch_workload_models.py``)."""

import pytest

from _torch_workload_models import *  # noqa: F401,F403


@pytest.fixture(scope="module")
def arch():
    return "paper-mlp"
