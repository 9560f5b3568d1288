"""The model-bound workloads on reduced qwen3-0.6b (qk_norm, grouped
attention; the tests and their tolerances: ``tests/_torch_workload_models.py``)."""

import pytest

from _torch_workload_models import *  # noqa: F401,F403


@pytest.fixture(scope="module")
def arch():
    return "qwen3-0.6b"
