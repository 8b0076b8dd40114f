"""The probe microbenchmarks' plain versions (``bpvo_tpu_torch.probes``, which
the wrappers take for CPU tensors) against the JAX probe scripts' Pallas
kernels, each built with its script's BlockSpecs and run in interpret mode
on the CPU, on the same seeded numpy inputs.

Tolerances: ``while_loop`` bitwise on the script's input, and on normal
values bitwise to the recurrence with (JAX: XLA-CPU contracts an FMA) and
without (the port) the contraction; ``scalar_chain``'s sqrt and divide are
correctly rounded in both: bitwise.  The gather and v1-v3 select values:
bitwise (v1 and v2 sum an integer-valued image, exact in any order).
``matmul_chain`` sums its 128 products in another order than the TPU
kernel's dot: rtol 1e-5.  ``band_bilinear``, v4 and v5 multiply by a 2-hot matrix whose other
products are exact zeros, so only the TPU kernel's order of the two nonzero
terms (or an FMA) can differ: atol 1e-6.
"""
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bpvo_tpu_torch import VisualOdometry
from bpvo_tpu_torch import probes
from bpvo_tpu_torch.data import stereo
from bpvo_tpu_torch.probes import band, gather, kernel_features as kf
from bpvo_tpu_torch.utils import convert
from bpvo_tpu_torch.vo.device_vo import DeviceVO

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
F32 = jnp.float32


def _script(name):
    """Load scripts/<name>.py as a module (its kernel bodies)."""
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def features():
    return _script("probe_kernel_features")


@pytest.fixture(scope="module")
def variants():
    return _script("probe_gather_variants")


@pytest.fixture(scope="module")
def bisect():
    return _script("probe_band_bisect")


@pytest.fixture(scope="module")
def kprobe():
    return _script("tpu_kernel_probe")


def _call(kernel, out_shape, *args, specs=None):
    """pallas_call with every operand whole in VMEM (or ``specs``)."""
    specs = specs or [VMEM] * len(args)
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, F32),
        in_specs=specs, out_specs=specs[0],
        interpret=True)(*(jnp.asarray(a) for a in args)))


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# probe_kernel_features.py
# ---------------------------------------------------------------------------

def _recurrence(x, fused):
    """7 steps of v <- 1.5 v + 1 in numpy float32, each step rounded once
    (an FMA: exact in float64, then rounded) or twice, then v + 7."""
    v = x.copy()
    for _ in range(7):
        v = ((v.astype(np.float64) * 1.5 + 1.0).astype(np.float32) if fused
             else v * np.float32(1.5) + np.float32(1.0))
    return v + np.float32(7)


@pytest.mark.parametrize("kind", ["ones", "normal"])
def test_while_loop(features, kind):
    """On the script's input (ones) the port equals the TPU kernel bit for
    bit.  On normal values XLA-CPU contracts the kernel's 1.5 v + 1 into an
    FMA: the TPU kernel then equals the fused recurrence bit for bit and the
    port (one rounding per operation, as the CUDA kernel's __fmul_rn /
    __fadd_rn) the unfused one, so the two differ only by that contraction."""
    x = (np.ones((8, 128), np.float32) if kind == "ones" else
         np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32))
    want = _call(features.k_while, (8, 128), x)
    for barrier in kf.BARRIERS:
        got = kf.while_loop(_t(x), barrier=barrier).numpy()
        if kind == "ones":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(want, _recurrence(x, fused=True))
            np.testing.assert_array_equal(got, _recurrence(x, fused=False))
    assert kf.launch_count["while_loop_cta"] == 0      # CPU: plain only


@pytest.mark.parametrize("h", [(4.0, 2.0, 5.0), (2.5, 7.0, 1.0),
                               (0.0, 1.0, 3.0), (1e-3, 3e-2, 2.0)])
def test_scalar_chain_bitwise(features, h):
    """The script's input; c - l1^2 < 0 and a = 0 take the 1e-20 floors."""
    h = np.asarray(h, np.float32)
    want = _call(features.k_scalar_chain, (3,), h,
                 specs=[pl.BlockSpec(memory_space=pltpu.SMEM)])
    np.testing.assert_array_equal(kf.scalar_chain(_t(h)).numpy(), want)


@pytest.mark.parametrize("kind", ["script", "uniform"])
def test_matmul_chain(features, kind):
    if kind == "script":
        a = np.ones((8, 128), np.float32)
        b = np.full((128, 128), 0.1, np.float32)
    else:
        r = np.random.default_rng(1)
        a = r.uniform(0, 1, (8, 128)).astype(np.float32)
        b = r.uniform(0, 1, (128, 128)).astype(np.float32)
    want = _call(features.k_matmul_chain, (8, 128), a, b)
    got = kf.matmul_chain(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=kf.MATMUL_RTOL)


# ---------------------------------------------------------------------------
# the lane gather: probe_gather_variants.pallas_taa, tpu_kernel_probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", gather.LANES)
def test_take_along_lanes_bitwise(variants, lanes):
    rng, *_ = gather.sampling_inputs(0)
    for earlier in gather.LANES[:gather.LANES.index(lanes)]:
        gather.lane_inputs(rng, earlier)          # the script's draw order
    idx, data = gather.lane_inputs(rng, lanes)
    want = _call(variants._taa_kernel, idx.shape, idx, data)
    got = gather.take_along_lanes(_t(idx), _t(data)).numpy()
    np.testing.assert_array_equal(got, want)
    for placement in gather.PLACEMENTS:           # CPU: the plain version
        np.testing.assert_array_equal(
            gather.take_along_lanes(_t(idx), _t(data), placement).numpy(),
            want)


def test_take_along_lanes_kitti_bitwise(kprobe):
    """tpu_kernel_probe._gather_kernel: (8, 376*1241) data, its IDX."""
    rng = np.random.default_rng(0)
    idx = np.asarray(kprobe.IDX).reshape(8, -1)
    data = rng.standard_normal((8, kprobe.HW)).astype(np.float32)
    want = _call(kprobe._gather_kernel, idx.shape, idx, data)
    np.testing.assert_array_equal(
        gather.take_along_lanes(_t(idx), _t(data)).numpy(), want)


def test_take_along_lanes_out_of_range_is_nan():
    data = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    idx = torch.tensor([[0, 5, 6], [-1, 2, 3]], dtype=torch.int32)
    got = gather.take_along_lanes(idx, data)
    np.testing.assert_array_equal(got.numpy(), [[0, 5, np.nan],
                                                [np.nan, 8, 9]])
    assert gather.fits(16384, "smem") and not gather.fits(376 * 1241, "smem")
    assert gather.fits(376 * 1241, "dsmem")


def test_packed_taps_bilinear_matches_unbanded():
    """The yardstick samples what unbanded bilinear samples."""
    _, U, V, IMG = gather.sampling_inputs(0)
    u, v, img = _t(U), _t(V), _t(IMG)
    np.testing.assert_allclose(gather.packed_taps_bilinear(u, v, img),
                               band.bilinear_reference(u, v, img), atol=1e-5)


# ---------------------------------------------------------------------------
# the band kernel and its parts: _band_kernel, probe_band_bisect.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("points,blocks", [("script", (0, 1)),
                                           ("script", (7, 15)),
                                           ("wide", (0, 1))])
def test_band_bilinear(variants, points, blocks):
    """Two blocks of points through the script's BlockSpecs (a (1, 8, BLOCK)
    copy per block, only row 0 written): the script's points, and points
    over the whole image, whose blocks span far more than a band."""
    _, U, V, IMG = gather.sampling_inputs(0)
    if points == "wide":
        U, V = band.wide_points(len(U))
    B = band.BLOCK
    sel = np.concatenate([np.arange(b * B, (b + 1) * B) for b in blocks])
    u, v = U[sel], V[sel]
    nb = len(blocks)
    spec = pl.BlockSpec((1, 8, B), lambda b: (b, 0, 0),
                        memory_space=pltpu.VMEM)
    u8 = np.broadcast_to(u.reshape(nb, 1, B), (nb, 8, B))
    v8 = np.broadcast_to(v.reshape(nb, 1, B), (nb, 8, B))
    want = np.asarray(pl.pallas_call(
        variants._band_kernel, grid=(nb,), in_specs=[spec, spec, VMEM],
        out_specs=spec, out_shape=jax.ShapeDtypeStruct((nb, 8, B), F32),
        interpret=True)(jnp.asarray(u8), jnp.asarray(v8),
                        jnp.asarray(IMG)))[:, 0, :].reshape(-1)
    for staged in (True, False):
        got = band.band_bilinear(_t(u), _t(v), _t(IMG), staged=staged)
        np.testing.assert_allclose(got.numpy(), want, atol=band.BAND_ATOL)
    # the script's points stay inside their block's band, so banded and
    # unbanded sampling agree; over the whole image most points leave it and
    # sample the band's clipped rows instead, in the kernel and the port alike
    full = band.bilinear_reference(_t(u), _t(v), _t(IMG)).numpy()
    same = np.abs(full - want) <= band.BAND_ATOL
    if points == "script":
        assert same.all()
    else:
        assert (~same).mean() > 0.5


def test_band_bilinear_rejects_partial_blocks():
    u = torch.zeros(1000)
    with pytest.raises(ValueError):
        band.band_bilinear(u, u, torch.zeros(64, 64))


def _bisect_args(bisect, name):
    """(JAX kernel, its operands, the port's inputs, exact?) for v1-v5."""
    IMG, U, V = band.bisect_inputs(0)
    np.testing.assert_array_equal(U, np.asarray(bisect.U))
    np.testing.assert_array_equal(V, np.asarray(bisect.V))
    IMG_INT = band.integer_image(0)
    U8, V8 = (np.broadcast_to(a[None, :], (8, band.BLOCK)) for a in (U, V))
    return {"v1_static_slice": (bisect.k_static_slice, (IMG_INT,),
                                (IMG_INT,)),
            "v2_dyn_slice": (bisect.k_dyn_slice, (V8, IMG_INT),
                             (V, IMG_INT)),
            "v3_onehot": (bisect.k_onehot, (U8,), (U,)),
            "v4_onehot_matmul": (bisect.k_onehot_matmul, (U8, IMG), (U, IMG)),
            "v5_rowweight": (bisect.k_rowweight, (V8, IMG), (V, IMG))}[name]


@pytest.mark.parametrize("part", band.PARTS, ids=[p[0] for p in band.PARTS])
def test_band_parts(bisect, part):
    name, kernel, _plain, _keys, exact = part
    jk, jargs, targs = _bisect_args(bisect, name)
    want = _call(jk, band.OUT, *jargs)
    got = kernel(*(_t(a) for a in targs)).numpy()
    assert got.shape == band.OUT
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=band.BAND_ATOL)


def test_dyn_slice_clamps_base():
    """A negative min(floor v) starts the band at row 0 and a late one at
    H - band, as dynamic_slice clamps."""
    img = _t(band.integer_image(1))
    for v, start in ((-5.0, 0), (1000.0, band.H - band.BAND)):
        got = band.dyn_slice_sum(torch.full((band.BLOCK,), v), img)
        assert float(got[0, 0]) == float(img[start:start + band.BAND].sum())


# ---------------------------------------------------------------------------
# the runner, the launch counters, the package's imports
# ---------------------------------------------------------------------------

def _kernel_results(step):
    """The (step, kernel result) pairs of one step's result: the step itself
    or its variants."""
    if "ok" in step:
        return [(step, step)]
    return [(step, v) for v in step.values()
            if isinstance(v, dict) and "ok" in v]


def test_runner_runs_groups_on_cpu(capsys):
    """Every kernel check of the features, gather and band groups holds, and
    each result carries what chip_smoke.py reads from it."""
    from bpvo_tpu_torch.probes.__main__ import main
    probes.reset_launch_counts()
    assert main(["features", "gather", "band", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["device"] == "cpu"
    res = report["results"]
    assert set(res) == {"features", "gather", "band"}
    assert "FAIL" not in json.dumps(res)
    loop = res["features"]["while_loop"]
    for barrier, cluster in kf.WHILE_VARIANTS:
        assert loop[kf.variant_name(barrier, cluster)]["ok"] is True
    checked = [pair for group in res.values() for step in group.values()
               for pair in _kernel_results(step)]
    assert len(checked) == 6 + 2 + 3 * 2 + 2 + 2 * 2 + 5
    for step, kernel in checked:
        assert kernel["ok"] is True, kernel
        for key in ("max_abs_err", "ms", "wrapper_ms"):
            assert isinstance(kernel[key], float), (key, kernel)
        for key in ("plain_ms", "plain_wrapper_ms", "bytes", "ops"):
            assert step[key] >= 0, (key, step)
        assert "library_ms" in step
    # the band's clipping is exercised: on points over the whole image the
    # banded samples differ from unbanded ones
    assert res["gather"]["band"]["maxerr_vs_unbanded"] == 0.0
    assert res["gather"]["band_wide"]["maxerr_vs_unbanded"] > 0.1
    # on the CPU nothing launches a kernel
    assert not any(probes.launch_counts().values())


def test_runner_records_failures_and_goes_on(monkeypatch):
    def broken(device, data):
        raise RuntimeError("no such primitive")
    monkeypatch.setattr(kf, "STEPS", (("boom", broken),) + kf.STEPS[1:])
    res = probes.run(["features"], "cpu")["results"]["features"]
    assert res["boom"].startswith("FAIL RuntimeError: no such primitive")
    assert res["scalar_chain"]["ok"] is True
    with pytest.raises(ValueError):
        probes.run(["nope"], "cpu")


def test_runner_out_must_lie_under_build(tmp_path):
    from bpvo_tpu_torch.probes.__main__ import main
    with pytest.raises(SystemExit):
        main(["features", "--device", "cpu", "--out",
              str(tmp_path / "x.json")])


def test_probes_import_no_jax():
    code = ("import sys, bpvo_tpu_torch, bpvo_tpu_torch.probes, "
            "bpvo_tpu_torch.probes.__main__; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'bpvo_tpu' or m.startswith('bpvo_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})


# ---------------------------------------------------------------------------
# the entry points run on the card unless the caller asks for the CPU
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda():
    for fn in (DeviceVO.__init__, VisualOdometry.__init__,
               convert.template_from_numpy, convert.state_from_numpy,
               stereo.TpuSGM.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]], np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceVO(K, 0.1, (48, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        VisualOdometry(K, 0.1, (48, 64))
    with pytest.raises((RuntimeError, AssertionError)):
        convert.template_from_numpy({
            k: np.zeros(2, np.float32) for k in (
                "points", "pixels", "jacobians", "valid", "num_valid",
                "norm_scale", "norm_center", "rows", "cols")})
    with pytest.raises(RuntimeError):
        probes.run(["features"])
    with pytest.raises(RuntimeError, match="CUDA"):
        stereo.TpuSGM(num_disparities=16).run(np.zeros((8, 16), np.float32),
                                              np.zeros((8, 16), np.float32))
    # asked for, the CPU still works
    assert DeviceVO(K, 0.1, (48, 64), device="cpu").device.type == "cpu"


def test_level_gn_sweep_runs_only_on_the_card():
    """The cluster-size sweep times the kernel: on the CPU it refuses."""
    sweep = _script("level_gn_sweep")
    with pytest.raises(ValueError):
        sweep.run(device="cpu")


def test_level_gn_sweep_writes_only_under_build():
    """--out outside the checkout's build/ is refused before anything runs
    (nothing is written)."""
    sweep = _script("level_gn_sweep")
    outside = sweep.BUILD.parent / "sweep.json"
    with pytest.raises(SystemExit):
        sweep.main(["--out", str(outside)])
    assert not outside.exists()


@pytest.mark.parametrize("n_ctas, phases", [(8, False), (None, True),
                                            (16, True)])
def test_level_gn_sweep_patches_a_copy(n_ctas, phases):
    """The sweep's copies of level_gn.cu: every anchor of the shipped
    source is found once, ctas_for returns the fixed size, and the phase
    copy gains its marks and reader; the shipped source has no knob."""
    sweep = _script("level_gn_sweep")
    text = sweep.SOURCE.read_text()
    assert "clock64" not in text and "#ifdef" not in text
    out = sweep.patched_source(text, n_ctas=n_ctas, phases=phases)
    fixed = f"int ctas_for(int K) {{\n  (void)K;\n  return {n_ctas};\n"
    assert (fixed in out) == (n_ctas is not None)
    # the declaration, 4 marks and the iteration count
    assert out.count("g_phase_cycles[") == (6 if phases else 0)
    assert ("bpvo_level_gn_phases" in out) == phases
    with pytest.raises(ValueError):       # an anchor that is not there
        sweep._insert_after(text, "no such line\n", "")


# ---------------------------------------------------------------------------
# scripts/sgm_bench.py: the matcher's timings and the SGM tile sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [(8, 8), (8, 12), (12, 8)])
def test_sgm_bench_patches_the_tile(tile):
    """The sweep's copies of sgm.cu: the shipped tile constants are found
    once and replaced; the shipped shape leaves the text as it is."""
    bench = _script("sgm_bench")
    text = bench.SOURCE.read_text()
    assert tile in bench.TILES and "#ifdef" not in text
    out = bench.patched_source(text, tile)
    assert f"constexpr int kTileY = {tile[0]};" in out
    assert f"constexpr int kTileX = {tile[1]};" in out
    assert (out == text) == (tile == bench.SHIPPED)
    with pytest.raises(ValueError):       # a source without the anchors
        bench.patched_source("// no tile here\n", tile)


def test_sgm_bench_runs_only_on_the_card(tmp_path):
    """It times kernels: without a CUDA device it refuses, and --out
    outside the checkout's build/ is refused before anything runs."""
    bench = _script("sgm_bench")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.run(reps=1)
    with pytest.raises(SystemExit):
        bench.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
