"""``utils/graphs.while_loop`` (JAX's ``lax.while_loop``) and the level
solves on it, on the CPU, where no CUDA graph can run.

- ``while_loop`` outside a cache (a host loop) and through
  ``ReplayStandIn`` (a replay reruns the function): no iteration, an exit
  at the iteration limit, an exit on the predicate; a ``cond`` nested in
  the body; a loop inside a ``cond`` body; the warm-up runs a body the
  loop does not run, uncounted.
- Launch counts through ``RecordingWhile`` (a capture that records each
  conditional body's launches, and replays that rerun the function and add
  each body's runs to its device counter, as a graph's IF and WHILE nodes
  do): once ``graphs.settle``d, the eager loop's counts.
- ``gauss_newton.run`` and ``levenberg_marquardt.run``: a level solve
  through ``GraphCache.jit`` on the stand-in bit for bit the eager loop,
  the counts of their kernels' wrappers settled equal to the eager ones,
  and both held to JAX's ``gn.run`` / ``lm.run`` on the same inputs
  (JAX's CPU route) at the tolerances of tests/test_torch_gauss_newton.py
  (accepted delta (a)) and tests/test_torch_lm.py (delta (i)).
- ``DeviceVO`` with ``run`` levels (intensity and Bit-Planes) and with
  Bit-Planes LM: the one-graph step through the stand-in bit for bit the
  eager step.

The WHILE nodes themselves run in tests/test_torch_graphs_gpu.py on the
card."""
import contextlib
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpvo_tpu.solver import gauss_newton as jgn
from bpvo_tpu.solver import levenberg_marquardt as jlm
from bpvo_tpu.types import LossFunctionType as JLoss
from bpvo_tpu_torch import DescriptorType
from bpvo_tpu_torch.ops import fused_linearize as fused_mod
from bpvo_tpu_torch.ops import irls as irls_mod
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.solver import levenberg_marquardt as lm
from bpvo_tpu_torch.utils import graphs
from bpvo_tpu_torch.utils.convert import (camera_from_numpy,
                                          gn_options_from_jax,
                                          template_from_numpy)
from bpvo_tpu_torch.vo import device_vo as dv
from bpvo_tpu_torch.vo import warp as warp_mod
from test_gn import H_IMG, W_IMG
from test_torch_graphs import (ReplayStandIn, _assert_outputs_equal, _vo_case,
                               jit_solve)
from test_torch_zoo import _gather_problem, _np_template

LIMIT = 5                      # the loops' iteration limit


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole-frame runs of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_op_module():
    mod = types.SimpleNamespace(launch_count=0)

    def op(x):
        mod.launch_count += 1
        return x + 1
    return mod, op


class RecordingWhile(graphs.GraphCache):
    """A capture that runs the function's Python once (so the wrappers
    count and each conditional body's launches are recorded) and notes
    where each body sits; a replay reruns the function with the counts
    held (a graph's replay enters no wrapper) and adds one to a body's
    device counter for each run of it in that rerun: an IF body taken, a
    WHILE body's iteration, as the graph's nodes do."""

    def _warm_up(self, fn):
        return fn()

    def _capture(self, fn):
        root = {"children": []}
        self._tree = [root]
        fn()
        taken = self._taken
        taken.zero_()           # the capture ran the bodies' increments
        modules = self._mods()

        def replay():
            counts = [m.launch_count for m in modules]
            self._cursor, self._runs = [[root, 0]], taken
            with self._running("rerun"):
                out = fn()
            for m, n in zip(modules, counts):
                m.launch_count = n
            return out
        return types.SimpleNamespace(replay=replay)

    def _if_node(self, pred):
        return self._record()

    def _while_node(self, pred):
        return self._record()

    @contextlib.contextmanager
    def _record(self):
        node = {"slot": len(self._records) - 1, "children": []}
        self._tree[-1]["children"].append(node)
        self._tree.append(node)
        try:
            yield
        finally:
            self._tree.pop()

    def _site(self):
        node, i = self._cursor[-1]
        self._cursor[-1][1] += 1
        return node["children"][i]

    @contextlib.contextmanager
    def _inside(self, site):
        self._runs[site["slot"]] += 1
        self._cursor.append([site, 0])
        try:
            yield
        finally:
            self._cursor.pop()

    def _cond(self, pred, body, into):
        if self._phase != "rerun":
            return super()._cond(pred, body, into)
        site = self._site()
        if bool(pred):
            with self._inside(site):
                graphs.copy_into(into, body())
        return into

    def _while(self, pred_fn, body, carry):
        if self._phase != "rerun":
            return super()._while(pred_fn, body, carry)
        site = self._site()
        while bool(pred_fn(carry)):
            with self._inside(site):
                carry = body(carry)
        return carry


def _counted(mods, fn):
    """(fn()'s result, the launches it counted, per module)."""
    before = [m.launch_count for m in mods]
    out = fn()
    graphs.settle()
    return out, [m.launch_count - n for m, n in zip(mods, before)]


def _equal(a, b):
    for x, y in zip(graphs._leaves(a), graphs._leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# graphs.while_loop
# ---------------------------------------------------------------------------

def _loop_fn(op, x, n, flag):
    """``while i < min(n, LIMIT): acc = op(acc)``, and on even i, when
    ``flag``, ``acc = op(op(acc)) / 2`` in a nested ``cond``."""
    def fn():
        carry = (torch.zeros((), dtype=torch.int32), x.clone())

        def body(c):
            i, acc = c
            acc = op(acc)
            acc = graphs.cond(flag & (i % 2 == 0),
                              lambda: op(op(acc)) * 0.5, acc.clone())
            return i + 1, acc
        return graphs.while_loop(lambda c: (c[0] < n) & (c[0] < LIMIT),
                                 body, carry)
    return fn


def _reference(x, n, flag):
    i, acc = 0, x.clone()
    while i < min(n, LIMIT):
        acc = acc + 1
        if flag and i % 2 == 0:
            acc = (acc + 2) * 0.5
        i += 1
    return i, acc


# no iteration, an exit at LIMIT, an exit on the predicate
CASES = {"none": 0, "limit": LIMIT + 3, "predicate": 3}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("flag", [False, True])
def test_while_loop_outside_a_cache(case, flag):
    """A host loop: the body runs while the predicate holds, and the
    carry it returns last comes back (the one given, unread, when no
    iteration runs)."""
    _, op = _fake_op_module()
    x = torch.arange(3.0)
    n = torch.tensor(CASES[case], dtype=torch.int32)
    i, acc = _loop_fn(op, x, n, torch.tensor(flag))()
    want_i, want_acc = _reference(x, CASES[case], flag)
    assert int(i) == want_i and torch.equal(acc, want_acc)
    with pytest.raises(ValueError, match="0-d bool"):
        graphs.while_loop(lambda c: c > 0, lambda c: c - 1, torch.ones(2))


class _Reads:
    """Counts the host reads of tensors (``bool()``, ``.tolist()``,
    ``.item()``) while installed."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("__bool__", "tolist", "item"):
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **k):
                self.n += 1
                return _orig(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, counted)


@pytest.mark.parametrize("case", list(CASES))
def test_while_loop_reads_its_flag_with_the_predicate(case, monkeypatch):
    """With ``flag_fn`` the host loop reads the predicate and the flag in
    one copy an iteration (and one at the end), and the body gets the
    flag as a host bool; through the stand-in it gets the tensor, and
    both give the loop without a flag."""
    _, op = _fake_op_module()
    x = torch.arange(3.0)
    n = torch.tensor(CASES[case], dtype=torch.int32)

    def fn(seen):
        def body(c, flag):
            seen.append(flag)
            i, acc = c
            acc = op(acc)
            acc = graphs.cond(flag, lambda: op(op(acc)) * 0.5, acc.clone()
                              ) if isinstance(flag, torch.Tensor) else (
                op(op(acc)) * 0.5 if flag else acc)
            return i + 1, acc
        return lambda: graphs.while_loop(
            lambda c: (c[0] < n) & (c[0] < LIMIT), body,
            (torch.zeros((), dtype=torch.int32), x.clone()),
            flag_fn=lambda c: c[0] % 2 == 0)
    want_i, want_acc = _reference(x, CASES[case], True)
    seen = []
    reads = _Reads(monkeypatch)
    i, acc = fn(seen)()
    assert reads.n == want_i + 1
    assert [type(f) for f in seen] == [bool] * want_i
    assert int(i) == want_i and torch.equal(acc, want_acc)
    monkeypatch.undo()
    seen = []
    cache = ReplayStandIn("cpu")
    for _ in range(2):
        i, acc = cache("k", fn(seen))
        assert int(i) == want_i and torch.equal(acc, want_acc)
    assert all(isinstance(f, torch.Tensor) for f in seen)


@pytest.mark.parametrize("case", list(CASES))
def test_while_loop_through_the_stand_in(case):
    """Through ``ReplayStandIn``: the first call and each replay give the
    host loop's results as the trip count changes between replays; a
    body the first call's loop does not run is warmed there, uncounted."""
    mod, op = _fake_op_module()
    cache = ReplayStandIn("cpu", modules=(mod,))
    x, flag = torch.arange(3.0), torch.tensor(True)
    n = torch.tensor(CASES[case], dtype=torch.int32)
    calls = []

    def counting(t):
        calls.append(1)
        return op(t)
    fn = _loop_fn(counting, x, n, flag)
    i, acc = cache("k", fn)
    want_i, want_acc = _reference(x, CASES[case], True)
    assert int(i) == want_i and torch.equal(acc, want_acc)
    if case == "none":
        assert calls and mod.launch_count == 0
    for m in (2, 0, 7, 1):
        n.fill_(m)
        x.add_(1.0)
        i, acc = cache("k", fn)
        want_i, want_acc = _reference(x, m, True)
        assert int(i) == want_i and torch.equal(acc, want_acc)
    assert len(cache) == 1


@pytest.mark.parametrize("case", list(CASES))
def test_while_bodies_count_per_run(case):
    """A WHILE body with an IF body nested in it: after ``settle`` each
    replay's launches are the eager loop's under the same inputs (the
    loop body's once per iteration, the nested body's once per take), the
    results the host loop's; settling twice adds nothing."""
    mod, op = _fake_op_module()
    x, flag = torch.arange(3.0), torch.tensor(True)
    n = torch.tensor(CASES[case], dtype=torch.int32)
    fn = _loop_fn(op, x, n, flag)
    cache = RecordingWhile("cpu", modules=(mod,))
    for m in (CASES[case], 4, 0, 9, 3, CASES[case]):
        n.fill_(m)
        flag.fill_(m != 4)
        want, n_eager = _counted([mod], fn)
        got, n_graph = _counted([mod], lambda: cache("k", fn))
        _equal(got, want)
        assert n_graph == n_eager, m
    graphs.settle()
    assert _counted([mod], lambda: None)[1] == [0]


def test_while_inside_an_if_body_counts_per_take():
    """A WHILE node inside an IF body (the keyframe branch's re-estimate):
    its iterations count only on the replays that take the branch, and
    the results are the eager ones."""
    mod, op = _fake_op_module()
    x = torch.zeros(2)
    take, n = torch.tensor(False), torch.tensor(0, dtype=torch.int32)

    def fn():
        y = op(x)

        def branch():
            carry = (torch.zeros((), dtype=torch.int32), y.clone())
            return graphs.while_loop(
                lambda c: c[0] < n,
                lambda c: (c[0] + 1, op(op(c[1]))), carry)[1]
        return graphs.cond(take, branch, y.clone())

    cache = RecordingWhile("cpu", modules=(mod,))
    for t, m in [(0, 2), (1, 3), (1, 0), (0, 5), (1, 6), (1, 1)]:
        take.fill_(bool(t))
        n.fill_(m)
        x.add_(1.0)
        want, n_eager = _counted([mod], fn)
        got, n_graph = _counted([mod], lambda: cache("k", fn))
        assert torch.equal(got, want) and n_graph == n_eager == [
            1 + 2 * m * t], (t, m)
    assert len(graphs._bodies[-1][1]) == 2


def test_while_capture_gives_a_doubled_carry_two_buffers():
    """A carry that holds one tensor twice is written through two buffers
    in a capture (each leaf the body's own result), so the loop gives the
    host loop's values."""
    mod, op = _fake_op_module()
    n = torch.tensor(3, dtype=torch.int32)

    def fn():
        a = torch.ones(2)
        carry = (torch.zeros((), dtype=torch.int32), a, a)
        return graphs.while_loop(
            lambda c: c[0] < n,
            lambda c: (c[0] + 1, op(c[1]), c[2] * 2.0), carry)

    want = fn()
    cache = RecordingWhile("cpu", modules=(mod,))
    for _ in range(3):
        _equal(cache("k", fn), want)
    assert torch.equal(want[1], torch.full((2,), 4.0))
    assert torch.equal(want[2], torch.full((2,), 8.0))


# ---------------------------------------------------------------------------
# the level solves
# ---------------------------------------------------------------------------

def _count_kernels(monkeypatch):
    """Fake op modules counting the calls of the GN kernels' wrappers (on
    the CPU the wrappers run their plain versions, which count nothing)."""
    mods = []
    for owner, name in ((fused_mod, "fused_linearize"),
                        (irls_mod, "irls_reduce_w")):
        mod = types.SimpleNamespace(launch_count=0)
        real = getattr(owner, name)

        def counted(*a, real=real, mod=mod, **k):
            mod.launch_count += 1
            return real(*a, **k)
        monkeypatch.setattr(owner, name, counted)
        mods.append(mod)
    return mods


@functools.lru_cache(maxsize=None)
def _problem(case):
    """JAX's and the port's level problem of ``case`` (interp, warp, C,
    loss), made once a module run (the JAX side is most of this file's
    time); the tests only read it."""
    td, ch, cam, jopts = _gather_problem(case[:3])
    jopts = dataclasses.replace(jopts, loss=JLoss(case[3]))
    return (td, ch, cam, jopts, template_from_numpy(_np_template(td), "cpu"),
            torch.as_tensor(np.array(ch)), camera_from_numpy(cam))


def _starts(ttd):
    return [torch.eye(4), warp_mod.params_to_pose(
        torch.tensor([0.001, 0.0, -0.001, 0.002, 0.001, 0.0]),
        ttd.norm_scale, ttd.norm_center)]


# (interp, warp, C, loss): the fused route at C = 1 (a sigma branch of
# fused_linearize + irls_reduce_w) and C = 8 (a channel-0 pass), and the
# gather route at C = 8 (irls_reduce_w every iteration)
GN_CASES = [("Linear", "RigidBody", 1, "Tukey"),
            ("Linear", "RigidBody", 8, "Tukey"),
            ("CubicHermite", "RigidBody", 8, "Tukey")]


@pytest.mark.parametrize("case", GN_CASES,
                         ids=["-".join(map(str, c)) for c in GN_CASES])
def test_gauss_newton_run_graphs_bitwise_eager_and_jax(case, monkeypatch):
    """A solve through ``GraphCache.jit`` on the stand-in (one graph, each
    solve one replay) and on ``RecordingWhile`` give the eager loop's GNState
    bit for bit from two starts, with the eager launch counts once
    settled; the eager loop follows JAX's ``gn.run`` (CPU route): pose at
    atol 1e-5, the same iterations and status (delta (a))."""
    monkeypatch.setenv("BPVO_IRLS_KERNEL", "0")
    td, ch, cam, jopts, ttd, channels, tcam = _problem(case)
    opts = gn_options_from_jax(jopts)
    st_j = jgn.run(td, ch, cam, jnp.eye(4), jopts)
    mods = _count_kernels(monkeypatch)
    standin = ReplayStandIn("cpu", modules=mods)
    recorded = RecordingWhile("cpu", modules=mods)
    for T0 in _starts(ttd):     # the first call of each cache, a replay
        want, n_eager = _counted(mods, lambda: gn.run(
            ttd, channels, tcam, T0, opts))
        got = jit_solve(standin, gn.run, ttd, channels, tcam, T0, opts)
        assert gn.GNState._fields == type(got)._fields
        _equal(got, want)
        got, n_graph = _counted(mods, lambda: jit_solve(
            recorded, gn.run, ttd, channels, tcam, T0, opts))
        _equal(got, want)
        assert n_graph == n_eager and n_eager[0 if case[0] == "Linear"
                                              else 1] > 0
        if torch.equal(T0, torch.eye(4)):
            st_t = want
    assert len(standin) == len(recorded) == 1
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=1e-5)
    assert int(st_t.num_iters) == int(st_j.num_iters) >= 2
    assert int(st_t.status) == int(st_j.status)
    assert bool(st_t.converged) == bool(st_j.converged)


@pytest.mark.parametrize("solver", ["gn", "lm"])
@pytest.mark.parametrize("case", GN_CASES,
                         ids=["-".join(map(str, c)) for c in GN_CASES])
def test_eager_loops_read_once_an_iteration(case, solver, monkeypatch):
    """The eager ``gauss_newton.run`` and ``levenberg_marquardt.run`` (the
    hooked step's and verbose runs' route on the card) read the device
    once an iteration, the exit test and the sigma test in one copy, and
    once when the loop ends; GN's iteration 0 reads nothing."""
    monkeypatch.setenv("BPVO_IRLS_KERNEL", "0")
    _, _, _, jopts, ttd, channels, tcam = _problem(case)
    opts = gn_options_from_jax(jopts)
    run = gn.run if solver == "gn" else lm.run
    reads = _Reads(monkeypatch)
    st = run(ttd, channels, tcam, torch.eye(4), opts)
    n = reads.n
    monkeypatch.undo()
    iters = int(st.num_iters)
    assert iters >= 2
    assert n == (iters if solver == "gn" else iters + 1)


# both packages stop on a convergence test (tests/test_torch_lm.py)
LM_CASES = [("Linear", "RigidBody", 1, "Huber"),
            ("CubicHermite", "RigidBody", 8, "Tukey")]


@pytest.mark.parametrize("case", LM_CASES,
                         ids=["-".join(map(str, c)) for c in LM_CASES])
def test_levenberg_marquardt_graphs_bitwise_eager_and_jax(case,
                                                          monkeypatch):
    """An LM solve through ``GraphCache.jit`` on the stand-in and on
    ``RecordingWhile``: the eager
    loop's LMState bit for bit from two starts (rejected and accepted
    steps, sigma re-estimated and not), the eager launch counts once
    settled; the eager loop within delta (i) of JAX's ``lm.run``: pose at
    atol 5e-4, iterations within 1, the same status."""
    td, ch, cam, jopts, ttd, channels, tcam = _problem(case)
    jopts = dataclasses.replace(jopts, parameter_tolerance=1e-6,
                                max_iterations=50)
    opts = gn_options_from_jax(jopts)
    st_j = jax.jit(lambda: jlm.run(td, ch, cam, jnp.eye(4), jopts))()
    mods = _count_kernels(monkeypatch)
    standin = ReplayStandIn("cpu", modules=mods)
    recorded = RecordingWhile("cpu", modules=mods)
    for T0 in _starts(ttd):     # the first call of each cache, a replay
        want, n_eager = _counted(mods, lambda: lm.run(
            ttd, channels, tcam, T0, opts))
        _equal(jit_solve(standin, lm.run, ttd, channels, tcam, T0, opts),
               want)
        got, n_graph = _counted(mods, lambda: jit_solve(
            recorded, lm.run, ttd, channels, tcam, T0, opts))
        _equal(got, want)
        assert n_graph == n_eager and int(want.num_iters) >= 2
        if torch.equal(T0, torch.eye(4)):
            st_t = want
    assert len(standin) == len(recorded) == 1
    # another tau is another graph of the cache
    _equal(jit_solve(standin, lm.run, ttd, channels, tcam, torch.eye(4),
                     opts, tau=1e-3),
           lm.run(ttd, channels, tcam, torch.eye(4), opts, tau=1e-3))
    assert len(standin) == 2
    assert bool(st_t.converged) and bool(st_j.converged)
    np.testing.assert_allclose(st_t.T.numpy(), np.asarray(st_j.T), atol=5e-4)
    assert abs(int(st_t.num_iters) - int(st_j.num_iters)) <= 1
    assert int(st_t.status) == int(st_j.status)


# ---------------------------------------------------------------------------
# DeviceVO: the one-graph step with run levels and with LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["run_intensity", "run_bitplanes",
                                  "lm_bitplanes"])
def test_device_vo_step_graph_bitwise_eager(path, monkeypatch):
    """Over 5 steps with keyframes, ``DeviceVO``'s one-graph step through
    the stand-in (each level solve on ``run`` or LM a ``while_loop``
    inside the step function, the keyframe branch a ``cond``) gives the
    eager step's outputs bit for bit: a dense-like route with the finest
    level on ``gauss_newton.run`` (intensity; Bit-Planes with the stereo
    matcher), and Bit-Planes Levenberg-Marquardt with the disparity
    given."""
    if path.startswith("run"):
        monkeypatch.setattr(gn, "MAX_LEVEL_KERNEL_POINTS", 1024)
    K, b, frames, params, stereo_fn = _vo_case(
        "bitplanes" if path == "run_bitplanes" else "intensity")
    if path == "lm_bitplanes":
        params = params.replace(descriptor=DescriptorType.BITPLANES,
                                poseEstimator="LevenbergMarquardt")
    frames = frames[:6]
    eager = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu",
                        stereo_fn=stereo_fn)
    graphed = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu",
                          stereo_fn=stereo_fn)
    graphed._graphs = ReplayStandIn("cpu")
    if path.startswith("run"):
        assert eager._capacities[0] > 1024 >= eager._capacities[1]
    eager.add_frame(*frames[0])
    graphed.add_frame(*frames[0])
    n_kf = 0
    for image, aux in frames[1:]:
        want = eager.add_frame(image, aux)
        _assert_outputs_equal(graphed.add_frame(image, aux), want)
        n_kf += int(want.is_keyframe)
    assert 1 <= n_kf < len(frames) - 1 and len(graphed._graphs) == 1
