"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``bpvo_tpu_torch`` is not ``bpvo_tpu``), and
the reference imports nothing of the program."""
import ast
import subprocess
import sys

from vobench import bench

RUN_AND_LIST = r"""
import argparse, sys, tempfile
from pathlib import Path
from vobench import bench, run
from vobench.tests.conftest import tiny_cell
for w in ("kitti00_intensity.online_stereo",
          "kitti00_bitplanes_stereo.reprocess"):
    cell = tiny_cell(Path(tempfile.mkdtemp()), w)
    run.run_cell(argparse.Namespace(workload=w, seed=3, seconds=0.3,
                                    trace=1),
                 device="cpu", cell=cell, setup_clock=lambda: 0.0)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _modules(RUN_AND_LIST)
    assert "bpvo_tpu_torch" in mods
    assert not mods & set(bench.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("import sys, vobench.reference.vo, "
                    "vobench.reference.sgm, vobench.reference.geometry; "
                    "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert not mods & {"bpvo_tpu_torch", "bpvo_tpu", "jax", "jaxlib"}
    allowed = {"__future__", "dataclasses", "math", "typing", "numpy",
               "torch", "vobench"}
    for path in (bench.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                top = n.split(".")[0]
                assert top in allowed, f"{path.name} imports {n}"
                if top == "vobench":
                    assert n.startswith("vobench.reference"), n
