"""The comparison fails what it must: the control (the reference in the
program's place, in bfloat16) and the faults a cell can have, each planted
under the timed path of a whole run, come out not correct; a sound run
comes out correct.  The same control at a cell's own size runs on the card
(``gpu``)."""
import argparse
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vobench import bench, control, run
from vobench.tests.conftest import REPROCESS

# the benchmark's cells, and the reprocess driver's (the tests' own)
BENCH_CELLS = tuple(w["name"] for w in
                    bench.load_json(bench.ROOT / "BENCHMARK.json")
                    ["workloads"])
CELLS = tuple(REPROCESS) + BENCH_CELLS


def _run(cell, **kw):
    # a window of a few frames at least, however busy the CPU is
    args = argparse.Namespace(workload=cell.name, seed=2 ** 31 + 77,
                              seconds=1.0, trace=0)
    return run.run_cell(args, device="cpu", cell=cell,
                        setup_clock=lambda: 0.0, **kw)


# -- faults of DeviceVO.add_frames (reprocess) ------------------------------

def _stuck_chunk(vo):
    """Every step returns its state unchanged: no motion, no keyframe."""
    def add_frames(images, auxs):
        n = len(images)
        eye = torch.eye(4).expand(n, 4, 4).clone()
        return SimpleNamespace(pose=eye, pose_world=eye.clone(),
                               is_keyframe=torch.zeros(n, dtype=torch.bool),
                               reason=torch.zeros(n, dtype=torch.int32),
                               frac_good=torch.ones(n),
                               iters=torch.zeros(n, 4, dtype=torch.int32))
    vo.add_frames = add_frames


def _half_chunk(vo):
    """Half of each chunk left out: the other half's outputs stand in."""
    orig = vo.add_frames

    def add_frames(images, auxs):
        outs = orig(images[::2], auxs[::2])
        n = len(images)
        return type(outs)(*(t.repeat_interleave(2, 0)[:n] for t in outs))
    vo.add_frames = add_frames


def _altered_chunk(vo):
    """Each pose altered where it is produced (2 cm along x)."""
    orig = vo.add_frames

    def add_frames(images, auxs):
        outs = orig(images, auxs)
        outs.pose[:, 0, 3] += 0.02
        return outs
    vo.add_frames = add_frames


# -- faults of VisualOdometry.add_frame (online) -----------------------------

def _stuck_frame(vo):
    vo.add_frame = lambda image, d: SimpleNamespace(pose=np.eye(4),
                                                    is_keyframe=False)


def _half_frame(vo):
    orig, last, k = vo.add_frame, [None], [0]

    def add_frame(image, d):
        k[0] += 1
        if k[0] % 2 == 0 and last[0] is not None:
            return last[0]
        last[0] = orig(image, d)
        return last[0]
    vo.add_frame = add_frame


def _altered_frame(vo):
    orig = vo.add_frame

    def add_frame(image, d):
        r = orig(image, d)
        pose = np.array(r.pose, np.float64)
        pose[0, 3] += 0.02
        return SimpleNamespace(pose=pose, is_keyframe=r.is_keyframe)
    vo.add_frame = add_frame


FAULTS = {"reprocess": (_stuck_chunk, _half_chunk, _altered_chunk),
          "online": (_stuck_frame, _half_frame, _altered_frame)}


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(tiny, workload):
    assert _run(tiny(workload))["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tiny, workload):
    out = _run(tiny(workload), setup=control.put_in_place)
    assert not out["correct"]
    assert out["checks"]["pose_err"]["value"] > \
        out["checks"]["pose_err"]["limit"]


@pytest.mark.parametrize("fault", range(3))
@pytest.mark.parametrize("workload", CELLS)
def test_each_fault_is_not_correct(tiny, workload, fault):
    cell = tiny(workload)
    plant = FAULTS[cell.mix["driver"]][fault]
    out = _run(cell, fault=lambda drv: plant(drv.vo))
    assert not out["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", BENCH_CELLS)
def test_the_control_fails_at_the_cells_own_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs on the "
                    "card")
    cell = bench.Cell(workload)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        args = argparse.Namespace(workload=workload, seed=seed, seconds=1.0,
                                  trace=0)
        out = run.run_cell(args, cell=cell, setup=control.put_in_place)
        assert not out["correct"], out["checks"]
