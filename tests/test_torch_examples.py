"""The port's example (examples/synthetic_vo_torch.py) against the JAX
package's (examples/synthetic_vo.py): both run 4 frames on the CPU, and the
translations they print agree per frame within accepted delta (b)."""
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_ATOL = 2e-4        # accepted delta (b), ROADMAP C; prints have 4 places
FRAME = re.compile(r"frame +(\d+) +t = \[([-+.\d]+) ([-+.\d]+) ([-+.\d]+)\]")


def _run(script, *args):
    out = subprocess.run(
        [sys.executable, os.path.join("examples", script), "4", *args],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
                 OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "final position error" in out.stdout
    rows = FRAME.findall(out.stdout)
    assert [int(r[0]) for r in rows] == [0, 1, 2, 3]
    return np.array([[float(v) for v in r[1:]] for r in rows])


def test_examples_print_the_same_translations():
    port = _run("synthetic_vo_torch.py", "--device", "cpu")
    jax_t = _run("synthetic_vo.py")
    assert np.abs(port[1:, 2] - 0.03).max() < 1e-3   # the known z step
    np.testing.assert_allclose(port, jax_t, atol=POSE_ATOL + 1e-9)
