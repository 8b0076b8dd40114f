"""scripts/gn_kernel_bench.py on the CPU: the patched copies its sweep
builds of the per-iteration GN kernels (every anchor it edits is still in
the sources), and its ``--device cpu`` mode, which runs the plain versions
at 120x160.  The kernels themselves run only on the card
(tests/test_torch_kernels_gpu.py)."""
import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location(
        "_gn_kernel_bench", os.path.join(ROOT, "scripts", "gn_kernel_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def texts(bench):
    return {f: (bench.CSRC / f).read_text() for f in bench.SOURCES}


LAUNCHES = [(128, 4, 2), (256, 1, 1), (256, 1, 2), (256, 2, 1), (256, 2, 2),
            (256, 4, 1), (256, 4, 2), (256, 4, 4)]
MODES = {"as shipped": 4, "groups of 2": 2, "groups of 8": 8}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("launch", LAUNCHES)
def test_sweep_patches_a_copy(bench, texts, launch, mode):
    """Each copy: both rules return the fixed shape, the channel group set,
    the copy defines the error string it is built without; the shipped
    sources have no knob."""
    group = MODES[mode]
    assert (launch, group) in bench.SWEEP
    assert list(bench.LAUNCHES) == LAUNCHES
    for text in texts.values():
        assert "#ifdef" not in text
    assert texts["fused_linearize.cu"].count(bench._GROUP) == 1
    out = bench.patched_sources(texts, launch, group)
    fixed = "  return {{{}, {}, {}}};\n".format(*launch)
    for name, anchor, insert in bench._LAUNCH_ANCHORS:
        assert texts[name].count(anchor) == 1
        assert out[name].count(anchor + insert.format(*launch)) == 1
        assert fixed in insert.format(*launch)
    assert f"constexpr int kGroup = {group};" in out["fused_linearize.cu"]
    assert "bpvo_cuda_error_string" in out["irls_reduce.cu"]
    assert "bpvo_cuda_error_string" not in texts["irls_reduce.cu"]
    # every unroll a copy can ask for is instantiated
    assert f"launch<{launch[1]}, 1>" in texts["fused_linearize.cu"]
    assert f"launch<{launch[1]}>" in texts["irls_reduce.cu"]
    assert launch[0] <= 256 and launch[0] % 32 == 0


def test_sweep_variants_are_distinct(bench):
    names = [bench.variant_name(*v) for v in bench.SWEEP]
    assert len(set(names)) == len(names) == 3 * len(bench.LAUNCHES)


@pytest.mark.parametrize("name", ["fused_linearize.cu", "irls_reduce.cu"])
def test_sweep_refuses_a_source_without_its_anchor(bench, texts, name):
    broken = dict(texts)
    broken[name] = broken[name].replace("launch_for(int", "rule(int").replace(
        bench._GROUP, "")
    with pytest.raises(ValueError):
        bench.patched_sources(broken, *bench.SWEEP[0])


def test_cpu_mode_runs_the_plain_versions(bench):
    """120x160, host clock: every shape of the GN-kernel phase, each check
    true (the plain version against itself), no device numbers."""
    res = bench.run(device="cpu", reps=1)
    json.dumps(res)
    assert res["device"] == "cpu" and res["image"] == [120, 160]
    assert "host" in res["clock"]
    shapes = res["shapes"]
    assert len(shapes) == 12
    assert sum(k.startswith("fused_linearize") for k in shapes) == 6
    assert all(r["agrees"] for r in shapes.values())
    assert all("kernels_per_call" not in r for r in shapes.values())
    assert all("no_w_ms" in r for k, r in shapes.items()
               if k.startswith("irls_reduce"))
    assert shapes["irls_reduce bitplanes L0 M=8K"]["terms"] == 8 * shapes[
        "irls_reduce bitplanes L0 M=1K"]["terms"]


def test_sweep_and_timing_need_the_card(bench, tmp_path):
    """The sweep refuses the CPU; without a card the CUDA mode raises;
    --out outside build/ and --sweep of another checkout are refused before
    anything runs."""
    with pytest.raises(ValueError):
        bench.run(device="cpu", sweep=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.run(device="cuda")
    with pytest.raises(SystemExit):
        bench.main(["--out", str(tmp_path / "x.json")])
    with pytest.raises(SystemExit):
        bench.main(["--sweep", "--root", str(tmp_path)])
    assert not (tmp_path / "x.json").exists()
