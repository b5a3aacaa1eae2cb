"""On a card: a run of each cell at a tiny size through the kernels is
correct, with the traced run's device readers reading the profiler."""

import pytest

from bench_port.harness import runner
from bench_port.tests.tiny import TINY


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_run_on_the_card(name, tiny_cell, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU path")
    from fpmash_tpu_torch.utils import trace as port_trace

    monkeypatch.setattr(port_trace, "_ENABLED", True)
    r = runner.run_cell(tiny_cell(name), 2**31 + 41, 0.5, True, device="cuda")
    assert r["correct"] is True, r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert 0 < r["metrics"]["device_idle_pct"]["value"] < 100
