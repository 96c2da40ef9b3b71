"""Fixtures of the benchmark's own tests: the repository root on the path,
small worlds for the CPU, and the look for a card (inside a fixture, so
that every worker collects the same tests)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# sizes of a CPU run: every width of the configuration but the scale cut
SMALL = {
    "year_bank": dict(n_templates=8, n_stations=4, day_sec=2000.0,
                      edge_sec=60.0, template_chunk=4, extraction_chunk=5),
    "bp_lattice": dict(n_sources=500, n_stations=12, day_sec=800.0,
                       edge_sec=40.0,
                       scan_kwargs=dict(num_closest_stations=10,
                                        minimum_interevent_time=10.0,
                                        threshold_window_sec=200.0)),
}


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def small():
    """cell -> the size overrides of its configuration for a CPU run."""
    from benchmark import harness

    def of(cell):
        return SMALL[harness.resolve(ROOT, cell).entry["config"]]
    return of


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
