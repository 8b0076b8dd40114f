"""``ops.gn_step``, the step of a ``gauss_newton.run`` iteration after its
linearization (tests, 6x6 solve, pose update, the loop's exit test and
sigma flag).

On the CPU: ``gauss_newton.run`` takes the plain version
(``gn_step_reference``), launches no kernel, and gives bit for bit the
GNState of the loop as it was before the step moved (its expressions
composed inline below); each step case reaches the branch it is named for.
Marked ``gpu`` (skipped without a CUDA device; the decision is made in a
fixture): the kernel against the plain version on the card, case by case
and over random systems, every field bit for bit but |dp| (within
``gn_step.DP_NORM_RTOL``) and the updated pose (within
``gn_step.T_ATOL``).  On a machine with an NVIDIA GPU (no
JAX needed):

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA device" \\
        -m gpu tests/test_torch_gn_step.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from bpvo_tpu_torch import AlgorithmParameters, DescriptorType
from bpvo_tpu_torch.data import synthetic
from bpvo_tpu_torch.ops import gn_step as gs
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.solver import linear_system
from bpvo_tpu_torch.vo import device_vo
from bpvo_tpu_torch.vo import warp as warp_mod

ROWS, COLS = 96, 320
DENSE = dict(minSaliency=2.0, numPyramidLevels=3, functionTolerance=1e-4,
             parameterTolerance=1e-6, maxIterations=50,
             minNumPixelsForNonMaximaSuppression=20000000,
             pointCapacity=32768)
OPTS = gn.GNOptions(max_iterations=50, function_tolerance=1e-6,
                    parameter_tolerance=1e-7, gradient_tolerance=1e-8,
                    scale_tolerance=1e-6, scale_tolerance_rel=0.01)
# fields compared bit for bit; dp_norm_prev within gn_step.DP_NORM_RTOL
# (the kernel sums |dp|'s squares in index order, torch's reduce kernel in
# its own), T within gn_step.T_ATOL
EXACT = ("T_best", "f_best", "dp", "f_norm", "g_tol", "scale", "delta_scale",
         "H", "g", "w", "status", "conv", "ok", "num_iters", "pred", "flag")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole-level runs of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gn_step kernel runs only on "
                    "the GPU")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# step cases
# ---------------------------------------------------------------------------

def _pose(twist):
    return warp_mod.params_to_pose(torch.tensor(twist, dtype=torch.float32),
                                   torch.tensor(0.5), torch.tensor(
                                       [0.1, -0.2, 8.0]))


def _system(seed, rank=6):
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((200, 6)).astype(np.float32)
    if rank < 6:
        J[:, rank:] = J[:, :1]           # columns repeated: H singular
    r = rng.standard_normal(200).astype(np.float32)
    return torch.as_tensor(J.T @ J), torch.as_tensor(J.T @ r * 1e-2)


def _case(name):
    """(state, H, g, f_new, sigma, delta_scale, s, c, opts, first) of the
    step case ``name`` (CPU tensors)."""
    f32 = torch.float32

    def t(x, dtype=f32):
        return torch.tensor(x, dtype=dtype)

    H, g = _system(1)
    st = gs.LoopState(
        T=_pose([1e-3, -2e-3, 5e-4, 1e-2, -3e-3, 2e-2]),
        T_best=_pose([2e-3, 0.0, -1e-3, 0.0, 1e-2, 0.0]), f_best=t(3.0),
        dp=t([1e-3, -2e-3, 5e-4, 3e-3, 1e-3, -4e-3]), f_norm=t(2.5),
        dp_norm_prev=t(4e-3), g_tol=t(1e-9), scale=t(0.5),
        delta_scale=t(0.2), H=torch.eye(6), g=torch.zeros(6),
        w=torch.zeros(2, 5), status=t(0, torch.int32),
        conv=t(False, torch.bool), ok=t(True, torch.bool),
        num_iters=t(3, torch.int32),
        pred=t(True, torch.bool), flag=t(True, torch.bool))
    f_new, sigma, ds = t(2.0), t(0.7), t(0.1)
    opts, first = OPTS, False
    if name in ("first", "first_gradient"):
        st = st._replace(f_best=t(float("inf")), dp=torch.zeros(6),
                         f_norm=t(0.0), dp_norm_prev=t(0.0), g_tol=t(0.0),
                         num_iters=t(0, torch.int32))
        first = True
        if name == "first_gradient":
            g = torch.zeros(6)
    elif name == "parameter":
        st = st._replace(dp=st.dp * 1e-6)
    elif name == "function":
        f_new = st.f_norm.clone()
    elif name == "gradient":
        g = g * 1e-9
    elif name == "max_iterations":
        st = st._replace(num_iters=t(49, torch.int32))
    elif name == "not_better":
        st = st._replace(f_best=t(1.0))
    elif name == "non_finite":
        H = H.clone()
        H[2, 3] = H[3, 2] = float("nan")
    elif name == "infinite":
        H = H.clone()
        H[4, 4] = float("inf")
    elif name == "near_singular":
        H, g = _system(2, rank=5)
    elif name == "sigma_stable":
        ds = t(0.0)
    elif name != "running":
        raise ValueError(name)
    return (st, H, g, f_new, sigma, ds, torch.tensor(0.5),
            torch.tensor([0.1, -0.2, 8.0]), opts, first)


# name: (status, conv, ok, better, pred, flag) the plain step gives
CASES = {
    "first": (gn.STATUS_MAX_ITERATIONS, False, True, True, True, True),
    "first_gradient": (gn.STATUS_GRADIENT_TOL, True, True, True, False,
                       True),
    "running": (gn.STATUS_MAX_ITERATIONS, False, True, True, True, True),
    "parameter": (gn.STATUS_PARAMETER_TOL, True, True, True, False, True),
    "function": (gn.STATUS_FUNCTION_TOL, True, True, True, False, True),
    "gradient": (gn.STATUS_GRADIENT_TOL, True, True, True, False, True),
    "max_iterations": (gn.STATUS_MAX_ITERATIONS, False, True, True, False,
                       True),
    "not_better": (gn.STATUS_MAX_ITERATIONS, False, True, False, True, True),
    "non_finite": (gn.STATUS_SOLVER_ERROR, False, False, True, False, True),
    "infinite": (gn.STATUS_SOLVER_ERROR, False, False, True, False, True),
    "near_singular": (gn.STATUS_MAX_ITERATIONS, False, True, True, True,
                      True),
    "sigma_stable": (gn.STATUS_MAX_ITERATIONS, False, True, True, True,
                     False),
}


def _to(case, dev):
    st, *rest = case
    return (gs.LoopState(*(x.to(dev) for x in st)),
            *(x.to(dev) if isinstance(x, torch.Tensor) else x for x in rest))


def _step(fn, case, w):
    st, H, g, f_new, sigma, ds, s, c, opts, first = case
    return fn(gs.LoopState(*(x.clone() for x in st)), H, g, f_new, sigma, ds,
              w, s, c, opts, first)


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_case_takes_its_branch(name):
    """The plain step on each case: the status, the tests, the solve's
    verdict, the best-pose choice, the exit test and the sigma flag named
    by the case; the pose moves exactly when the step is taken, dp is
    finite (zeroed when the solve fails), and the inputs land in the state."""
    case = _case(name)
    st = case[0]
    w = torch.ones(2, 5)
    launches = gs.launch_count
    new, dp_new, g_norm = _step(gs.gn_step, case, w)
    status, conv, ok, better, pred, flag = CASES[name]
    assert int(new.status) == status
    assert (bool(new.conv), bool(new.ok), bool(new.pred),
            bool(new.flag)) == (conv, ok, pred, flag)
    assert torch.equal(new.T_best, st.T if better else st.T_best)
    assert float(new.f_best) == float(case[3] if better else st.f_best)
    assert torch.equal(new.T, st.T) == (conv or not ok)
    assert torch.isfinite(dp_new).all() and (ok or not dp_new.any())
    assert int(new.num_iters) == int(st.num_iters) + 1
    assert new.w is w and new.H is case[1]
    assert float(g_norm) == float(case[2].abs().max())
    assert gs.launch_count == launches


# ---------------------------------------------------------------------------
# gauss_newton.run on the CPU: the plain step, bit for bit the old loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_levels():
    """Frame 0's templates and frame 1's channels of dense VO at 96x320 on
    the CPU, intensity and Bit-Planes."""
    K, b, frames = synthetic.synthesize_sequence(2, ROWS, COLS)
    out = {}
    for name, desc in (("C1", DescriptorType.INTENSITY),
                       ("C8", DescriptorType.BITPLANES)):
        vo = device_vo.DeviceVO(K, b, (ROWS, COLS), AlgorithmParameters(
            **dict(DENSE, descriptor=desc)), device="cpu")
        vo.init(*frames[0])
        ch = device_vo._compute_channels_pyr(torch.as_tensor(frames[1][0]),
                                             vo._p, 3)
        out[name] = (vo, ch)
    return out


def _pre_change_run(tdata, channels, cam, T_init, opts):
    """``gauss_newton.run`` as it was before its step moved to
    ``ops.gn_step``: the same linearization, then the old tail's
    expressions composed inline, the loop's test and sigma flag computed
    from the carry, the host loop reading both in one copy."""
    f32, dev = torch.float32, channels.device
    C, K = tdata.pixels.shape
    s, c = tdata.norm_scale, tdata.norm_center
    lin = gn._default_linearize_fn(tdata, channels, cam, opts)

    def scalar(x, dtype=f32):
        return torch.full((), x, dtype=dtype, device=dev)

    T = T_init.to(device=dev, dtype=f32)
    st = dict(T=T, T_best=T, f_best=scalar(float("inf")),
              dp=torch.zeros(6, dtype=f32, device=dev), f_norm=scalar(0.0),
              dp_norm_prev=scalar(0.0), g_tol=scalar(0.0), scale=scalar(1.0),
              delta_scale=scalar(1e10), H=torch.eye(6, dtype=f32, device=dev),
              g=torch.zeros(6, dtype=f32, device=dev),
              w=torch.zeros(C, K, dtype=f32, device=dev),
              status=scalar(gn.STATUS_MAX_ITERATIONS, torch.int32),
              conv=scalar(False, torch.bool), ok=scalar(True, torch.bool),
              num_iters=scalar(0, torch.int32))

    def iteration(st, first, do_est):
        H, g, f_new, sigma, delta_scale, w = lin(st["T"], st["scale"],
                                                 st["delta_scale"], do_est)
        g_norm = torch.max(torch.abs(g))
        dp_norm = torch.linalg.norm(st["dp"])
        if first:
            g_tol = opts.gradient_tolerance * torch.clamp(g_norm,
                                                          min=3.452669831e-4)
            conv = g_norm < g_tol
            status = torch.where(conv, gn.STATUS_GRADIENT_TOL,
                                 gn.STATUS_MAX_ITERATIONS).to(torch.int32)
        else:
            g_tol = st["g_tol"]
            f_prev, eps = st["f_norm"], 3.452669831e-4
            p_tol = (dp_norm < opts.parameter_tolerance) | (
                dp_norm < opts.parameter_tolerance
                * (eps + st["dp_norm_prev"]))
            df = torch.abs(f_new - f_prev)
            f_tol = ((f_new < opts.function_tolerance)
                     | (f_new < opts.function_tolerance * (eps + f_prev))
                     | (df < opts.function_tolerance)
                     | (df < opts.function_tolerance
                        * torch.clamp(f_prev, min=1.0)))
            g_ok = g_norm < g_tol
            status = torch.where(
                p_tol, gn.STATUS_PARAMETER_TOL,
                torch.where(f_tol, gn.STATUS_FUNCTION_TOL,
                            torch.where(g_ok, gn.STATUS_GRADIENT_TOL,
                                        gn.STATUS_MAX_ITERATIONS)))
            conv, status = p_tol | f_tol | g_ok, status.to(torch.int32)
        dp_new, ok = linear_system.solve(H, g)
        do_update = ~conv & ok
        better = f_new < st["f_best"]
        return dict(
            T=torch.where(do_update, st["T"] @ warp_mod.params_to_pose(
                -dp_new, s, c), st["T"]),
            T_best=torch.where(better, st["T"], st["T_best"]),
            f_best=torch.where(better, f_new, st["f_best"]),
            dp=torch.where(do_update, dp_new, st["dp"]), f_norm=f_new,
            dp_norm_prev=dp_norm, g_tol=g_tol, scale=sigma,
            delta_scale=delta_scale, H=H, g=g, w=w,
            status=torch.where(ok, status,
                               gn.STATUS_SOLVER_ERROR).to(torch.int32),
            conv=conv, ok=ok, num_iters=st["num_iters"] + 1)

    st = iteration(st, True, 1e10 > max(opts.scale_tolerance,
                                        opts.scale_tolerance_rel))
    while True:
        go, flag = torch.stack([
            ~st["conv"] & st["ok"] & (st["num_iters"] < opts.max_iterations),
            st["delta_scale"] > torch.clamp(
                opts.scale_tolerance_rel * st["scale"],
                min=opts.scale_tolerance)]).tolist()
        if not go:
            break
        st = iteration(st, False, flag)
    use_best = ~st["conv"] & (st["f_best"] < st["f_norm"])
    return gn.GNState(
        T=torch.where(use_best, st["T_best"], st["T"]), f_norm=st["f_norm"],
        g=st["g"], scale=st["scale"], weights=st["w"], H=st["H"],
        num_iters=st["num_iters"], status=st["status"], converged=st["conv"],
        solver_ok=st["ok"], band_overflow=scalar(0, torch.int32))


@pytest.mark.parametrize("C", ["C1", "C8"])
@pytest.mark.parametrize("level", [0, 1])
def test_run_on_the_cpu_takes_the_plain_step(cpu_levels, C, level,
                                             monkeypatch):
    """``gauss_newton.run`` on CPU tensors: one ``gn_step_reference`` an
    iteration, no kernel launch, and the GNState of the loop before the
    step moved, bit for bit, from two starts (one the level's own options,
    one with tolerances that run to the iteration limit)."""
    vo, ch = cpu_levels[C]
    td, cam, opts = vo.state.templates[level], vo._cams[level], vo._opts[level]
    calls = []
    plain = gs.gn_step_reference

    def counted(*args):
        calls.append(args[-1])
        return plain(*args)
    monkeypatch.setattr(gs, "gn_step_reference", counted)
    starts = (torch.eye(4), _pose([1e-3, -1e-3, 2e-3, 5e-3, 2e-3, -1e-2]))
    limited = dataclasses.replace(opts, function_tolerance=0.0,
                                  parameter_tolerance=0.0,
                                  gradient_tolerance=0.0, max_iterations=4)
    for T0, o in zip(starts, (opts, limited)):
        calls.clear()
        launches = gs.launch_count
        got = gn.run(td, ch[level], cam, T0, o)
        want = _pre_change_run(td, ch[level], cam, T0, o)
        for name, x, y in zip(gn.GNState._fields, got, want):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        n = int(got.num_iters)
        assert n >= 2 and calls == [True] + [False] * (n - 1)
        assert gs.launch_count == launches
    assert int(got.num_iters) == 4 and int(got.status) == (
        gn.STATUS_MAX_ITERATIONS)


def test_run_leaves_its_start_alone():
    """The loop's carry owns its tensors (the kernel overwrites them on the
    card): the start the caller holds is never one of them."""
    T0 = _pose([1e-3, 0.0, 0.0, 1e-2, 0.0, 0.0])
    st = gn._initial_state(T0, 1, 4, torch.device("cpu"))
    held = {t.data_ptr() for t in st}
    assert len(held) == len(st) and T0.data_ptr() not in held
    assert torch.equal(st.T, T0) and torch.equal(st.T_best, T0)


# ---------------------------------------------------------------------------
# on the card: the kernel against the plain version
# ---------------------------------------------------------------------------

def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _compare(kernel, plain):
    """The bitwise fields equal bit for bit (NaNs too), dp_norm_prev within
    DP_NORM_RTOL; returns the largest difference of T."""
    (k, kdp, kg), (p, pdp, pg) = kernel, plain
    for name in EXACT:
        x, y = getattr(k, name), getattr(p, name)
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)), name
    x, y = k.dp_norm_prev, p.dp_norm_prev
    assert torch.equal(_bits(x), _bits(y)) or bool(
        (x - y).abs() <= gs.DP_NORM_RTOL * y), (x.item(), y.item())
    assert torch.equal(_bits(kdp), _bits(pdp))
    assert torch.equal(_bits(kg), _bits(pg))
    return float((k.T - p.T).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain_on_the_card(cuda, name):
    """Each step case: the kernel's new state (written over the state it
    was given, which it returns) against the plain version on the same
    inputs on the card, every field bit for bit but dp_norm_prev, within
    DP_NORM_RTOL, and T, within T_ATOL."""
    case = _to(_case(name), cuda)
    w = torch.ones(2, 5, device=cuda)
    launches = gs.launch_count
    st = gs.LoopState(*(x.clone() for x in case[0]))
    got = gs.gn_step(st, *case[1:6], w, *case[6:])
    torch.cuda.synchronize()
    assert gs.launch_count == launches + 1
    assert got[0].w is w and all(                        # in place
        x is y for x, y in zip(got[0], st) if x is not w)
    assert _compare(got, _step(gs.gn_step_reference, case, w)) <= gs.T_ATOL


@pytest.mark.gpu
def test_kernel_over_random_steps(cuda):
    """300 random systems and states (half of them on iteration 0): the
    same bitwise fields, dp_norm_prev within DP_NORM_RTOL, T within
    T_ATOL; the largest T and |dp| differences are printed."""
    rng = np.random.default_rng(7)
    worst, worst_dp = 0.0, 0.0
    for i in range(300):
        st, H, g, f_new, sigma, ds, s, c, opts, _ = _case("running")
        H, g = _system(100 + i)
        g = g * float(10 ** rng.uniform(-4, 2))
        twist = rng.uniform(-0.05, 0.05, 6).astype(np.float32)
        st = st._replace(T=_pose(twist), dp=torch.as_tensor(
            rng.uniform(-1e-2, 1e-2, 6).astype(np.float32)))
        case = _to((st, H, g, f_new, sigma, ds, torch.tensor(
            float(rng.uniform(0.05, 2.0))), torch.as_tensor(
            rng.uniform(-5, 20, 3).astype(np.float32)), opts, i % 2 == 0),
            cuda)
        w = torch.zeros(1, 3, device=cuda)
        got, want = (_step(fn, case, w)
                     for fn in (gs.gn_step, gs.gn_step_reference))
        worst_dp = max(worst_dp, float(
            (got[0].dp_norm_prev - want[0].dp_norm_prev).abs()
            / want[0].dp_norm_prev))
        worst = max(worst, _compare(got, want))
    print(f"largest |T kernel - T plain|: {worst:.3e}; largest relative "
          f"|dp| difference {worst_dp:.3e} ({worst_dp / 2 ** -24:.2f} u)")
    assert worst <= gs.T_ATOL
