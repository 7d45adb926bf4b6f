"""Fixtures of the benchmark's own tests: a marker for tests that need
the card, and a small checkout whose cells run on the CPU in seconds."""

import pytest

from small_checkout import make_small_root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run
    time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    import harness
    monkeypatch.setattr(harness, "CACHE", str(tmp_path / "cache"))
    return make_small_root(str(tmp_path / "checkout"))
