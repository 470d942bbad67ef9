"""Card-only checks of the trace's reduction (`cuda` marker; each test
decides inside itself whether there is a card, and skips without one):
the profiler's device time is found, and a range's kernels are counted
toward it. Run on the card with
`python -m pytest -m cuda benchmark/tests/test_bench_cuda.py`."""
import pytest
import torch

from harness import trace


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_profile_reads_device_time_and_ranges():
    _card()
    a = torch.randn(2048, 2048, device="cuda")

    def body():
        with trace.rng("mm"):
            for _ in range(4):
                a @ a
        a + 1
    ctx = trace.profile(body)
    assert 0 < ctx["busy_s"] <= ctx["window_s"]
    assert ctx["stage_calls"]["mm"] == 1
    assert 0 < ctx["stage_s"]["mm"] < ctx["busy_s"]
    assert ctx["breakdown"]["device_ops"]


def test_reduce_on_a_synthetic_trace():
    """The reduction without a card: two kernels, one launched inside a
    range, with an idle gap between them under a host operation."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.stage",
         "tid": 1, "ts": 0, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 5, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::slow", "tid": 1,
         "ts": 20, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 70, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "tid": 9, "ts": 12,
         "dur": 8, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_b", "tid": 9, "ts": 72,
         "dur": 4, "args": {"correlation": 8}},
    ]
    ctx = trace.reduce(ev)
    assert ctx["busy_s"] == pytest.approx(12e-6)
    assert ctx["stage_s"]["stage"] == pytest.approx(8e-6)
    assert ctx["breakdown"]["idle_gaps"] == [["aten::slow",
                                              pytest.approx(52e-6)]]
    assert trace.kernel_time(ctx, "k_a") == (1, pytest.approx(8e-6))
