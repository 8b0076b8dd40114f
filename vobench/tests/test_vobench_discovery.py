"""A later change adds a configuration, a traffic mix or a per-layer metric
as new files: the harness finds each by the name BENCHMARK.json gives it,
and no file that exists is edited."""
import argparse
import copy
import json

from vobench import bench, run
from vobench.tests.conftest import tiny_here

BASE = "kitti00_intensity.online_stereo"


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    before = {p: p.read_bytes() for p in bench.HERE.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    here = tiny_here(tmp_path, BASE)
    cfg = json.loads((here / "configs" / "kitti00_intensity.json").read_text())
    cfg["name"] = "new_rig"
    (here / "configs" / "new_rig.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "online_stereo.json").read_text())
    mix["trace_frames"] = 2
    (here / "traffic" / "one_sequence.json").write_text(json.dumps(mix))
    (here / "limits" / "new_rig.one_sequence.json").write_text(
        (here / "limits" / f"{BASE}.json").read_text())
    (here / "metrics" / "frames_seen.one_sequence.py").write_text(
        "def read(ctx):\n    return ctx.frames\n")
    bm = copy.deepcopy(bench.load_json(bench.ROOT / "BENCHMARK.json"))
    bm["workloads"].append({"name": "new_rig.one_sequence",
                            "config": "new_rig", "traffic": "one_sequence",
                            "chips": 1, "why": "a test"})
    bm["per_layer"].append({"name": "frames_seen.one_sequence",
                            "unit": "frames", "better": "higher",
                            "source": "host_clock", "layer": "Public API",
                            "moves": "frame_ms_p50",
                            "workloads": ["new_rig.one_sequence"]})
    for m in bm["end_to_end"]:
        if "workloads" in m and BASE in m["workloads"]:
            m["workloads"].append("new_rig.one_sequence")
    cell = bench.Cell("new_rig.one_sequence", benchmark=bm, here=here)
    assert cell.config["name"] == "new_rig"
    assert cell.mix["trace_frames"] == 2
    assert "frames_seen.one_sequence" in [m["name"]
                                         for m in cell.metrics(trace=True)]
    args = argparse.Namespace(workload=cell.name, seed=7, seconds=0.5,
                              trace=1)
    out = run.run_cell(args, device="cpu", cell=cell,
                       setup_clock=lambda: 0.0)
    assert out["metrics"]["frames_seen.one_sequence"]["value"] > 0
    assert out["correct"]
    after = {p: p.read_bytes() for p in bench.HERE.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after
