"""The frozen trace arithmetic on a small synthetic trace, and the harness's
refusal to measure without a card."""

import json

import pytest
import torch

from benchmark import run
from benchmark.harness import trace


def _events():
    host = [{"ph": "X", "cat": "cpu_op", "name": "block", "ts": 0, "dur": 100},
            {"ph": "X", "cat": "cpu_op", "name": "aten::linalg_lu_factor_ex", "ts": 40, "dur": 30}]
    device = [{"ph": "X", "cat": "kernel", "name": "jet_layernorm_streamed_kernel", "ts": 10, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "jet_gemm_tf32x3_kernel", "ts": 25, "dur": 15},
              {"ph": "X", "cat": "kernel", "name": "cutlass_gemm_relu", "ts": 70, "dur": 10},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 10}]
    return host + device


def test_busy_idle_and_gaps(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    s = trace.summarise(trace.load_events(path), top=3, iters=2)
    # window 0..100 us; busy [10, 40] + [70, 80] + [90, 100] = 50 us
    assert s["window_ms"] == pytest.approx(0.1) and s["device_busy_ms"] == pytest.approx(0.05)
    assert s["idle_share"] == pytest.approx(0.5)
    assert s["kernel_launches"] == 3 and s["ms_by_name"]["jet_gemm_tf32x3_kernel"] == pytest.approx(0.015)
    assert s["categories"]["jet_layernorm"]["launches"] == 1
    assert s["categories"]["library GEMM"]["ms"] == pytest.approx(0.01)
    assert s["categories"]["copy"]["ms"] == pytest.approx(0.01)
    longest = s["gaps"][0]
    assert longest["ms"] == pytest.approx(0.03) and longest["host_op"] == "aten::linalg_lu_factor_ex"
    assert s["per_iteration"]["device_busy_ms"] == pytest.approx(0.025)
    assert run.breakdown(s)["idle_gaps"][0] == ["aten::linalg_lu_factor_ex", pytest.approx(3e-5)]


def test_a_trace_without_device_events_is_refused():
    with pytest.raises(ValueError, match="not measured"):
        trace.summarise([e for e in _events() if e["cat"] == "cpu_op"])


def test_no_card_no_result(monkeypatch, capsys):
    """Without a card the harness exits non-zero and prints no result line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "n6q15.train_l2", "--seed", "3", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "nothing measured" in out.err


def test_forbidden_modules_by_whole_name(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "deephall_tpu_torch_like", types.ModuleType("x"))
    assert "deephall_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("y"))
    assert "jaxlib" in run.forbidden_modules()
