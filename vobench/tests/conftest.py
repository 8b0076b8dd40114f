"""The harness's CPU tests: a tiny copy of a cell (48x160 frames, three
levels, short sequences) that the port's plain versions run on the CPU.

Besides ``BENCHMARK.json``'s cells the tests drive the ``reprocess``
driver, whose cells wait outside the benchmark until ``DeviceVO`` tracks
the plane scene's 121-frame sequences (PERF.md, Open questions): its mix,
limits and metrics are the tests' own, here."""
import copy
import json
import shutil
from pathlib import Path

import pytest

from vobench import bench

TINY_CAMERA = {"rows": 48, "cols": 160, "fx": 92.68, "baseline": 0.537,
               "rate_hz": 10}
TINY_PARAMS = {"numPyramidLevels": 3, "pointCapacity": 1024,
               "pointCapacityMin": 64, "minNumPixelsToWork": 16}
TINY_FRAMES = 13
TINY_MIX = {"sequences": 2, "chunk": 4, "check_frames": 4,
            "trace_sequences": 1, "warm_frames": 4, "trace_frames": 4}

# the reprocess cells: name -> configuration
REPROCESS = {"kitti00_intensity.reprocess": "kitti00_intensity",
             "kitti00_bitplanes_stereo.reprocess": "kitti00_bitplanes_stereo"}
REPROCESS_MIX = {"driver": "reprocess", "why": "the tests' reprocessing job",
                 "sequences": 2, "chunk": 4,
                 "trace_sequences": 1, "check_frames": 4}
REPROCESS_LIMITS = {
    "kitti00_intensity": {"pose_err": 0.002, "kf_mismatch": 1,
                          "world_err": 0.0008, "tmpl_mismatch": 0.02,
                          "depth_gap": 0.001, "bands": [0.002, 0.05, 0.02]},
    "kitti00_bitplanes_stereo": {"pose_err": 0.005, "kf_mismatch": 2,
                                 "tmpl_mismatch": 0.02, "depth_gap": 0.001,
                                 "bands": [0.005, 0.05, 0.02]}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


def benchmark() -> dict:
    """``BENCHMARK.json`` with the reprocess cells and their metrics."""
    bm = copy.deepcopy(bench.load_json(bench.ROOT / "BENCHMARK.json"))
    cells = list(REPROCESS)
    bm["workloads"] += [{"name": n, "config": c, "traffic": "reprocess",
                         "chips": 1, "why": "a test"}
                        for n, c in REPROCESS.items()]
    bm["end_to_end"].append({"name": "frames_per_s", "unit": "frames/s",
                             "better": "higher", "bound": 0.25,
                             "source": "host_clock", "workloads": cells})
    for name, unit, better, source, layer in (
            ("host_ms_per_frame", "ms", "lower", "host_clock", "Host step"),
            ("level_gn_roofline_pct", "%", "higher", "device_trace",
             "Kernels"),
            ("device_idle_pct", "%", "lower", "device_trace", "Device")):
        bm["per_layer"].append({"name": f"{name}.reprocess", "unit": unit,
                                "better": better, "source": source,
                                "layer": layer, "moves": "frames_per_s",
                                "workloads": cells})
    return bm


def tiny_here(tmp: Path, workload: str, limits=None) -> Path:
    """A copy of the harness's data files for ``workload`` with the tiny
    sizes, under ``tmp``."""
    w = {x["name"]: x for x in benchmark()["workloads"]}[workload]
    for d in ("configs", "traffic", "limits", "metrics"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    cfg = bench.load_json(bench.HERE / "configs" / f"{w['config']}.json")
    cfg["camera"] = dict(TINY_CAMERA)
    cfg["params"].update(TINY_PARAMS)
    cfg["matcher"]["num_disparities"] = 16
    cfg["sequence_frames"] = TINY_FRAMES
    if workload in REPROCESS:
        mix = dict(REPROCESS_MIX)
        lim = REPROCESS_LIMITS[w["config"]]
    else:
        mix = bench.load_json(bench.HERE / "traffic" /
                              f"{w['traffic']}.json")
        lim = bench.load_json(bench.HERE / "limits" / f"{workload}.json")
    mix.update({k: v for k, v in TINY_MIX.items()
                if k in mix or k == "warm_frames"})
    if mix["driver"] == "online":
        # every step of the short window: a fault then shows on any run
        mix["check_frames"] = 64
    lim = dict(lim) if limits is None else limits
    (tmp / "configs" / f"{w['config']}.json").write_text(json.dumps(cfg))
    (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(mix))
    (tmp / "limits" / f"{workload}.json").write_text(json.dumps(lim))
    for f in (bench.HERE / "metrics").glob("*.py"):
        shutil.copy(f, tmp / "metrics" / f.name)
    return tmp


def tiny_cell(tmp: Path, workload: str, limits=None) -> bench.Cell:
    return bench.Cell(workload, benchmark=benchmark(),
                      here=tiny_here(tmp, workload, limits))


@pytest.fixture
def tiny(tmp_path):
    def make(workload, limits=None):
        return tiny_cell(tmp_path, workload, limits)
    return make
