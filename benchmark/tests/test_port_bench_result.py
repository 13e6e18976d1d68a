"""The result line's schema, and a run without a card: exit 2, no result."""

from __future__ import annotations

import json

import torch

from benchmark import harness, run


def _record():
    return {"window_s": 2.0, "requests": 10, "rows": 81920, "latencies_ms": [0.8] * 10,
            "free_s": 2.0, "free_requests": 10, "free_enqueue_s": 0.002, "segments": []}


def test_schema_and_checks_last():
    c = harness.cell("base-design-8192")
    run_ = {"cfg": c["config"], "traffic": c["traffic"], "record": _record(), "trace": None,
            "setup_s": 9.5, "device": {}}
    metrics = harness.read_metrics(
        harness.metrics_of(c["manifest"], "base-design-8192", "end_to_end"), run_)
    assert set(metrics) == {"design_spectra_per_s", "design_p95_ms", "setup_s"}
    assert metrics["design_spectra_per_s"]["value"] == 81920 / 2.0
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 1 << 28, "power_limit_w": 700.0}
    rows = [["design.params_gap", 1e-6, 3e-5], ["design.spectrum_gap", float("inf"), 3e-4]]
    out = harness.result(False, rows, _record(), metrics, device, None)
    line = json.dumps(out)
    assert list(json.loads(line))[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in out
    assert out["failed"] == 1 and out["attempted"] == 10
    assert out["checks"]["design.spectrum_gap"] == {"value": "inf", "limit": 3e-4}
    assert "Infinity" not in line


def test_per_layer_readers_on_a_trace():
    c = harness.cell("base-design-8192")
    trace = {"window_s": 0.25, "busy_s": 0.2, "kernels": 600,
             "ranges": {"bench.gen_stage": 0.05, "bench.fwd_stage": 0.15},
             "by_kernel": {"k": 0.2}, "gaps": {"x": 0.05}, "segments": {}}
    run_ = {"cfg": c["config"], "traffic": c["traffic"], "record": _record(), "trace": trace,
            "setup_s": 9.5, "device": {}}
    metrics = harness.read_metrics(
        harness.metrics_of(c["manifest"], "base-design-8192", "per_layer"), run_)
    assert metrics["idle_share.design"]["value"] == 100 * (1 - 0.2 / 0.25)
    assert 0 < metrics["roofline.fwd_forward"]["value"] < 100
    assert metrics["enqueue_ms.design"]["value"] == 0.2


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "base-design-8192", "--seed", str(2**40 + 1),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
