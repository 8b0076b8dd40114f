"""The result line: its keys, in order, for a traced and an untraced run,
and no result without a card."""
import argparse

import pytest

from vobench import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(tiny, workload, trace):
    cell = tiny(workload)
    args = argparse.Namespace(workload=workload, seed=2 ** 31 + 11,
                              seconds=0.5, trace=trace)
    return run.run_cell(args, device="cpu", cell=cell,
                        setup_clock=lambda: 1.0), cell


@pytest.mark.parametrize("workload, names", [
    ("kitti00_intensity.online_stereo",
     {"frame_ms_p50", "frame_ms_p95", "setup_s"}),
    ("kitti00_intensity.reprocess", {"frames_per_s", "setup_s"})])
def test_untraced_line_has_the_end_to_end_metrics(tiny, workload, names):
    out, cell = _run(tiny, workload, 0)
    assert list(out) == KEYS + ["checks"]
    assert set(out["metrics"]) == names
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    assert "pose_err" in out["checks"]


def test_traced_line_has_the_per_layer_metrics_it_can_read(tiny):
    out, cell = _run(tiny, "kitti00_intensity.online_stereo", 1)
    assert list(out) == KEYS + ["checks"]
    names = {m["name"] for m in cell.metrics(trace=True)}
    # no device trace on the CPU: only the host's readings are there
    assert set(out["metrics"]) == {"add_frame_ms_p50.online",
                                   "matcher_ms_p50.online"} < names


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "kitti00_intensity.online_stereo", "--seed",
                   "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
