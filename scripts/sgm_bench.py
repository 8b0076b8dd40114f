"""Times the stereo matcher and its SGM aggregation on one GPU at the stereo
Bit-Planes path's shape, and sweeps the aggregation's tile shape.

    python3 scripts/sgm_bench.py [--root DIR] [--tiles] [--reps 20]
        [--out build/sgm_bench.json]

On frame 0 of the synthetic 376x1241 stereo sequence with
conf/kitti_bitplanes.cfg's matcher (128 disparities, p1 = 2, p2 = 8):

1. the aggregation through ``ops.sgm.aggregate_4dir``, checked bit for bit
   against its plain version, and each of its passes alone from their C
   entry points where the package has them (``ops.sgm.pass_launches``);
2. the matcher's ms per call, whole and by stage: census of both images,
   cost volume, aggregation, winner-take-all; and where the package has
   it, ``ops.sgm.disparity_4dir`` (the tile pass taking the winner, the
   matcher's route), checked bit for bit against the aggregation followed
   by the plain winner;
3. with ``--tiles``: copies of ``csrc/sgm.cu`` with each tile shape of
   ``TILES`` (the shipped source has no knob: the copies are written under
   ``build/sgm_tile_sweep/`` and built alone with the package's nvcc flags,
   all builds started together), each pass's time and the check per copy.

``--root`` imports ``bpvo_tpu_torch`` from another checkout (for instance a
parent commit unpacked under ``build/``), so two versions are timed by the
same script in one run.  Times are CUDA events over back-to-back calls
(mean ms per call; the 239 MB volume does not fit in L2).  Prints one JSON
object.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
SOURCE = ROOT / "bpvo_tpu_torch" / "csrc" / "sgm.cu"
CONF = ROOT / "conf" / "kitti_bitplanes.cfg"
# (kTileY, kTileX) candidates; each keeps D = 256 within shared memory
TILES = ((8, 8), (8, 12), (12, 8))
_ANCHORS = ("constexpr int kTileY = {};", "constexpr int kTileX = {};")
SHIPPED = (8, 8)


def patched_source(text: str, tile) -> str:
    """``sgm.cu``'s text with the tile shape ``(rows, columns)``."""
    for anchor, old, new in zip(_ANCHORS, SHIPPED, tile):
        a = anchor.format(old)
        if text.count(a) != 1:
            raise ValueError(f"sgm_bench: {a!r} occurs {text.count(a)} "
                             f"times in {SOURCE.name}")
        text = text.replace(a, anchor.format(int(new)))
    return text


def build_copies(tiles) -> list:
    """One shared library per tile shape under build/sgm_tile_sweep/, one
    nvcc each, all started together; a failed build raises."""
    from bpvo_tpu_torch.ops import _build
    out_dir = BUILD / "sgm_tile_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    jobs = []
    for ty, tx in tiles:
        src, lib = out_dir / f"sgm_{ty}x{tx}.cu", out_dir / f"sgm_{ty}x{tx}.so"
        src.write_text(patched_source(text, (ty, tx)))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(src)]
        jobs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    failed = []
    for lib, proc in jobs:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {lib.name}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [lib for lib, _ in jobs]


def pass_times(cost, want, p1, p2, reps, lib=None) -> dict:
    """Each pass of the aggregation alone on ``cost`` (ms per call by CUDA
    events; ``lib``: a build of sgm.cu alone, else the package's library)
    and whether their output equals ``want`` bit for bit."""
    import torch
    from bpvo_tpu_torch.ops import sgm
    from bpvo_tpu_torch.probes import timing
    out, launches = sgm.pass_launches(cost, p1, p2, lib=lib)
    rc = [launch() for launch in launches.values()]
    if any(rc):
        raise RuntimeError(f"sgm_bench: pass launch failed with {rc}")
    torch.cuda.synchronize()
    res = {f"{k}_ms": timing.events_ms(launch, reps)
           for k, launch in launches.items()}
    res["total_ms"] = sum(res.values())
    res["bitwise"] = bool(torch.equal(out, want))
    return res


def run(reps: int = 20, tiles: bool = False) -> dict:
    import torch
    from bpvo_tpu_torch import ConfigFile
    from bpvo_tpu_torch.data import stereo, synthetic
    from bpvo_tpu_torch.ops import _build, census, sgm
    from bpvo_tpu_torch.probes import timing
    if not torch.cuda.is_available():
        raise RuntimeError("sgm_bench: needs a CUDA device")
    dev = torch.device("cuda", 0)
    matcher = stereo.create_stereo_algorithm(ConfigFile(str(CONF)))
    D, p1, p2 = matcher.num_disparities, matcher.p1, matcher.p2
    _, _, frames = synthetic.synthesize_stereo_sequence(1)
    left, right = (torch.as_tensor(a).to(dev) for a in frames[0][:2])
    codes = census.census(torch.stack([left, right]))
    cost = stereo.census_cost_volume(codes[0], codes[1], D)
    got = sgm.aggregate_4dir(cost, p1, p2)
    want = sgm.aggregate_4dir_reference(cost, p1, p2)
    fn = matcher.as_fn()
    res = {"package": str(Path(sgm.__file__).resolve().parents[1]),
           "device": torch.cuda.get_device_name(dev),
           "shape": list(cost.shape),
           "bitwise": bool(torch.equal(got, want)),
           "aggregate_ms": timing.events_ms(
               lambda: sgm.aggregate_4dir(cost, p1, p2), reps),
           "matcher_ms": timing.events_ms(lambda: fn(left, right), reps),
           "matcher_ms_by_stage": {
               "census": timing.events_ms(
                   lambda: census.census(torch.stack([left, right])), reps),
               "cost_volume": timing.events_ms(
                   lambda: stereo.census_cost_volume(codes[0], codes[1], D),
                   reps),
               "aggregation": timing.events_ms(
                   lambda: sgm.aggregate_4dir(cost, p1, p2), reps),
               "wta": timing.events_ms(
                   lambda: stereo._wta_subpixel(got, D), reps)}}
    if hasattr(sgm, "disparity_4dir"):    # the tile pass taking the winner
        res["disparity_bitwise"] = bool(torch.equal(
            sgm.disparity_4dir(cost, p1, p2), stereo._wta_subpixel(got, D)))
        res["disparity_ms"] = timing.events_ms(
            lambda: sgm.disparity_4dir(cost, p1, p2), reps)
    if hasattr(sgm, "pass_launches"):     # the two-pass kernel
        res["passes"] = pass_times(cost, want, p1, p2, reps)
        res["scratch_mb"] = _build.library().bpvo_sgm_scratch_floats(
            *cost.shape) * 4e-6
    if tiles:
        res["tiles"] = {}
        for (ty, tx), path in zip(TILES, build_copies(TILES)):
            lib = _build.bind_sgm(ctypes.CDLL(str(path)))
            res["tiles"][f"{ty}x{tx}"] = dict(
                pass_times(cost, want, p1, p2, reps, lib=lib),
                scratch_mb=lib.bpvo_sgm_scratch_floats(*cost.shape) * 4e-6)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 scripts/sgm_bench.py")
    ap.add_argument("--root", type=Path, default=ROOT,
                    help="checkout whose bpvo_tpu_torch is timed")
    ap.add_argument("--tiles", action="store_true",
                    help="also sweep the tile shapes of TILES")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if args.out is not None and not args.out.resolve().is_relative_to(
            BUILD.resolve()):
        ap.error(f"--out must lie under {BUILD}")
    if args.tiles and args.root.resolve() != ROOT:
        ap.error("--tiles sweeps this checkout's sgm.cu only")
    sys.path.insert(0, str(args.root.resolve()))
    text = json.dumps(run(reps=args.reps, tiles=args.tiles))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
