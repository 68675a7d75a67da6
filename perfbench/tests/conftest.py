"""Shared fixtures of the benchmark's tests: the toy tree, and the skip of
card tests where there is no card (decided when a test runs, never at
import, so that every pytest worker collects the same tests)."""

from __future__ import annotations

import pytest
import torch

from perfbench.tests.tiny import make_root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
