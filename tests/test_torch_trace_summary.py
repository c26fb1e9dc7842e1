"""``scripts/torch_trace_summary.py`` on a synthetic trace and on a CPU profile.

A trace with known host and device intervals gives the exact window, busy
share, launch counts, categories and longest gaps (with the host operation
that spans each).  A two-iteration ``log.profile_dir`` profile of a tiny CPU
run parses and is refused as having no device events.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

from deephall_tpu_torch import train

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "torch_trace_summary.py"


def load_script():
    spec = importlib.util.spec_from_file_location("torch_trace_summary", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def event(name: str, cat: str, ts: float, dur: float) -> dict:
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


# µs.  Device busy: [10, 20], [25, 50], [60, 70], [80, 90] = 55 of the window
# [0, 90]; gaps 10 (0-10), 5 (20-25), 10 (50-60), 10 (70-80).
EVENTS = [
    event("aten::forward", "cpu_op", 0.0, 100.0),
    event("aten::item", "cpu_op", 48.0, 14.0),
    event("cudaLaunchKernel", "cuda_runtime", 70.0, 12.0),
    event("void jet_layernorm_streamed_kernel<256, 15, 3>(float const*)", "kernel", 10.0, 10.0),
    event("void jet_layernorm_streamed_kernel<256, 15, 3>(float const*)", "kernel", 25.0, 10.0),
    event("jet_gemm_tf32x3_kernel", "kernel", 30.0, 20.0),
    event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 60.0, 10.0),
    event("ampere_sgemm_128x64_nn", "kernel", 80.0, 5.0),
    event("void at::native::vectorized_elementwise_kernel<4, add>", "kernel", 85.0, 5.0),
    event("ProfilerStep#1", "gpu_user_annotation", 0.0, 200.0),
    {"ph": "s", "name": "ac2g", "cat": "ac2g", "ts": 5.0, "id": 1},
]


def test_synthetic_trace(tmp_path):
    summary = load_script().summarise(EVENTS, top=3, iters=2)
    assert summary["window_ms"] == pytest.approx(0.090)
    assert summary["device_busy_ms"] == pytest.approx(0.055)
    assert summary["busy_share"] == pytest.approx(55 / 90)
    assert summary["idle_share"] == pytest.approx(35 / 90)
    assert summary["device_events"] == 6
    assert summary["hand_written_launches"] == {
        "jet_layernorm": 2, "jet_gemm": 1, "jet_softmax_values": 0}
    categories = summary["categories"]
    assert categories["jet_layernorm"]["ms"] == pytest.approx(0.020)
    assert categories["jet_gemm"]["ms"] == pytest.approx(0.020)
    assert categories["copy"] == pytest.approx({"ms": 0.010, "launches": 1, "share": 10 / 60})
    assert categories["library GEMM"]["launches"] == categories["elementwise"]["launches"] == 1
    assert [row["launches"] for row in summary["top"]] == [2, 1, 1]
    gaps = summary["gaps"]
    assert [g["ms"] for g in gaps] == pytest.approx([0.010] * 3 + [0.005])
    assert [g["start_ms"] for g in gaps] == pytest.approx([0.0, 0.050, 0.070, 0.020])
    assert [g["host_op"] for g in gaps] == [
        "aten::forward", "aten::item", "cudaLaunchKernel", "aten::forward"]
    per = summary["per_iteration"]
    assert per["window_ms"] == pytest.approx(0.045)
    assert per["launches"]["jet_layernorm"] == 1.0


def test_cli_prints_one_json_line_last(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    assert load_script().main([str(tmp_path), "--iters", "2", "--top", "2"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(last)
    assert out["busy_share"] == pytest.approx(55 / 90)
    assert out["gaps"][0]["ms"] == pytest.approx(0.010)


def test_cpu_profile_is_refused(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    train.cli([
        "seed=1", "batch_size=16", "system.nspins=[3,0]", "system.flux=2",
        "network.psiformer.num_layers=1", "network.psiformer.num_heads=1",
        "network.psiformer.heads_dim=4", "mcmc.burn_in=1", "mcmc.steps=2",
        "optim.iterations=2", "optim.optimizer=none", f"log.save_path={tmp_path / 'run'}",
        f"log.profile_dir={trace_dir}", "log.profile_start=0", "log.profile_steps=2",
        "--device", "cpu"])
    script = load_script()
    events = script.load_events(trace_dir / "trace.json")
    assert any(e.get("cat") == "cpu_op" for e in events)
    with pytest.raises(ValueError, match="no device events"):
        script.summarise(events)
    assert script.main([str(trace_dir)]) == 1
    out = capsys.readouterr()
    assert "not measured" in out.err and out.out == ""
