"""One torch intra-op pool per core, not per worker, for the port's CPU tests.

The suite runs under pytest-xdist (``-n 6``).  Each worker's torch starts
an OpenMP pool as wide as the box, so six workers put 48 spinning threads
on 8 cores, and a test that takes 15 s alone took 120 s there.  The
port's CPU test modules import the autouse fixture below, which sets
torch's intra-op threads to the cores per worker for the length of the
module (its module-scoped fixtures too) and restores them after it.  Run
alone (no xdist), a test keeps every core.  ``test_torch_flow.py`` keeps
torch's default pool: its check of one pair against the same pair in a
batch (1e-5) holds at eight threads and not at one, where the
convolutions take other paths."""

import os

import pytest
import torch


def threads_per_worker() -> int:
    """Cores over the xdist workers (``PYTEST_XDIST_WORKER_COUNT``), at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, threads_per_worker()))
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("workers,want", [(None, 8), ("1", 8), ("6", 1), ("4", 2), ("16", 1)])
def test_threads_per_worker(monkeypatch, workers, want):
    monkeypatch.setattr(os, "cpu_count", lambda: 8)
    if workers is None:
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    else:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", workers)
    assert threads_per_worker() == want


def test_fixture_caps_the_pool():
    assert torch.get_num_threads() <= threads_per_worker()
