"""The distributed layer's graphed routes on the CPU, where no CUDA graph
runs: each entry point driven through a stand-in cache and held bit for bit
to its eager route (``cache=False``), on a world-1 gloo group in this
process and with no reducer.

- ``graphs.RerunCache`` (a "replay" reruns the captured function, the
  branches read on the host; launches and collectives count as the reruns
  make them): the sharded GN, the sharded VO's ``step_fn`` and ``scan_fn``
  (intensity and Bit-Planes), ``ba_solve``, ``ba_solve_with_depth``,
  ``make_sharded_ba``, ``make_sharded_ba_2d``, ``KeyframeWindow.optimize``
  and the pose graph: outputs, iterations, keyframes, ``Reducer.stats()``
  and the kernels' launch counts equal the eager run's, call after call.
- ``RecordingWhile`` (tests/test_torch_while.py: a capture that records
  each conditional body, replays that add each body's runs to its device
  counter, as the graph's IF and WHILE nodes do): the sharded GN's
  all-reduces in its WHILE body and in the sigma IF body inside it, so the
  ``Reducer``'s calls and bytes, once ``graphs.settle``d, equal the eager
  run's.
- ``graphs.route``: the graphed route on CUDA with no reducer or a
  one-rank nccl group, the eager route for gloo on CUDA, for nccl across
  cards, on the CPU, when asked and inside another cache's run.

The graphs themselves, the NCCL all-reduces captured in them, run in
tests/test_torch_parallel_gpu.py on the card; the JAX parity of the eager
routes is in tests/test_torch_parallel.py, test_torch_ba.py and
test_torch_pose_graph.py.  The 2-rank gloo rehearsal is in
tests/test_torch_multiprocess.py (``--rerun``)."""
import types

import numpy as np
import pytest
import torch

from bpvo_tpu_torch import AlgorithmParameters, DescriptorType
from bpvo_tpu_torch.core import se3
from bpvo_tpu_torch.data import synthetic
from bpvo_tpu_torch.ops import fused_linearize as fused_mod
from bpvo_tpu_torch.ops import irls as irls_mod
from bpvo_tpu_torch.parallel import bundle_adjustment as ba
from bpvo_tpu_torch.parallel import dryrun, multihost, pose_graph, sharded
from bpvo_tpu_torch.parallel import sharded_vo
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.types import VerbosityType
from bpvo_tpu_torch.utils import graphs
from bpvo_tpu_torch.vo import device_vo
from test_torch_while import RecordingWhile

ROWS, COLS = 96, 128


@pytest.fixture(scope="module")
def world1():
    """A world-1 gloo group in this process and its Reducer."""
    reducer = multihost.initialize("gloo", 1, 0,
                                   f"tcp://127.0.0.1:{multihost.free_port()}")
    yield reducer
    multihost.shutdown()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole-frame runs of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def counting(monkeypatch):
    """The GN kernels' wrappers count a launch on the CPU too (there they
    run their plain versions and count none), so that the stand-in's
    launch counts are held to the eager run's."""
    for mod, name in ((fused_mod, "fused_linearize"),
                      (irls_mod, "irls_reduce_w")):
        def counted(*a, _mod=mod, _fn=getattr(mod, name), **kw):
            _mod.launch_count += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)


@pytest.fixture(scope="module")
def problem():
    return dryrun.synthetic_problem(ROWS, COLS, 1024, device="cpu")


def _counts(red):
    graphs.settle()
    out = {m.__name__.rsplit(".", 1)[-1]: m.launch_count
           for m in graphs.op_modules()}
    out.update(red.stats() if red is not None else {})
    return out


def _calls(fn, red, n):
    """``n`` calls of ``fn()``: each one's output and its counts (launches,
    collectives)."""
    out = []
    for _ in range(n):
        before = _counts(red)
        got = fn()
        out.append((got, {k: v - before[k] for k, v in _counts(red).items()}))
    return out


def _bitwise(a, b):
    la, lb = graphs._leaves(a), graphs._leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _held_to_eager(make, red, n=3):
    """``make(cache)()`` through a ``RerunCache`` (the first call, then
    replays) equals ``make(False)()`` bit for bit, counts included."""
    (want, n_want), = _calls(make(False), red, 1)
    got = _calls(make(graphs.RerunCache("cpu")), red, n)
    for i, (out, n_got) in enumerate(got):
        assert _bitwise(out, want), i
        assert n_got == n_want, (i, n_got, n_want)
    return want, n_want


@pytest.mark.parametrize("reduced", [True, False])
def test_sharded_gn_through_the_stand_in(problem, world1, reduced):
    tdata, ch, cam, _ = problem
    red = world1 if reduced else None
    opts = gn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6)
    T0 = torch.eye(4)
    want, n = _held_to_eager(lambda c: lambda: sharded.make_sharded_gn(
        red, opts, cache=c)(tdata, ch, cam, T0), world1)
    assert int(want.num_iters) >= 2 and n["fused_linearize"] > 0
    # per iteration a sum of (H, g, f_sq), per sigma estimate a max and a
    # histogram sum
    assert (n["calls"] >= int(want.num_iters)) == reduced


def test_sharded_gn_collectives_settle_per_body_run(problem, world1):
    """Through ``RecordingWhile`` the sharded GN's all-reduces sit in the
    WHILE body (the (H, g, f_sq) sum) and in the sigma IF body inside it
    (the max and the histogram sum): once settled, the replays' calls and
    bytes, and the kernels' launches, equal the eager solve's."""
    tdata, ch, cam, _ = problem
    opts = gn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6)
    T0 = torch.eye(4)
    (want, n_want), = _calls(lambda: sharded.make_sharded_gn(
        world1, opts, cache=False)(tdata, ch, cam, T0), world1, 1)
    cache = RecordingWhile("cpu")
    run = sharded.make_sharded_gn(world1, opts, cache=cache)
    for i, (got, n_got) in enumerate(_calls(
            lambda: run(tdata, ch, cam, T0), world1, 3)):
        assert _bitwise(got, want) and n_got == n_want, (i, n_got, n_want)
    # the WHILE body, the sigma IF body inside it (and iteration 0's)
    def depth(node):
        return 1 + max((depth(c) for c in node["children"]), default=0)
    assert depth(cache._tree[0]) == 3


@pytest.mark.parametrize("descriptor", ["INTENSITY", "BITPLANES"])
def test_sharded_vo_through_the_stand_in(world1, descriptor):
    """``step_fn`` step by step and ``scan_fn`` in chunks of 1, 2 and 2,
    through the stand-in, equal the eager step bit for bit (poses,
    iterations, keyframes, collectives, launches), with a keyframe."""
    K, b, frames = synthetic.synthesize_sequence(6, ROWS, COLS)
    images = np.stack([f[0] for f in frames])
    disps = np.stack([f[1] for f in frames])
    p = AlgorithmParameters(**dict(dryrun.DRYRUN_PARAMS, numPyramidLevels=3),
                            descriptor=DescriptorType[descriptor])

    def run(cache, chunks):
        init_fn, step_fn, scan_fn = sharded_vo.make_sharded_vo(
            world1, K, b, (ROWS, COLS), p, device="cpu", cache=cache)
        state = init_fn(images[0], disps[0])
        before = _counts(world1)
        outs, at = [], 1
        for n in chunks:
            if n == 0:
                state, out = step_fn(state, images[at], disps[at])
                out, n = device_vo.VOStepOutput(*(t[None] for t in out)), 1
            else:
                state, out = scan_fn(state, images[at:at + n],
                                     disps[at:at + n])
            outs.append(out)
            at += n
        return (device_vo.VOStepOutput(*(torch.cat(f) for f in zip(*outs))),
                {k: v - before[k] for k, v in _counts(world1).items()})

    want, n_want = run(False, (0, 0, 0, 0, 0))
    for chunks in ((0, 0, 0, 0, 0), (1, 2, 2)):
        got, n_got = run(graphs.RerunCache("cpu"), chunks)
        assert _bitwise(got, want), chunks
        assert n_got == n_want, (chunks, n_got, n_want)
    assert bool(want.is_keyframe.any()) and n_want["calls"] > 0
    assert n_want["fused_linearize"] > 0


def test_bundle_adjustment_and_pose_graph_through_the_stand_in(problem,
                                                               world1):
    """``ba_solve``, ``ba_solve_with_depth``, ``make_sharded_ba``,
    ``make_sharded_ba_2d`` (a 1 x 1 layout) and the pose graph through the
    stand-in, call after call, equal their eager routes bit for bit with
    the same launches and collectives; ``KeyframeWindow`` likewise."""
    tdata, ch, cam, _ = problem
    M = 3
    window = ba.stack_templates([tdata] * M)
    chans = torch.stack([ch] * M)
    g = torch.Generator().manual_seed(0)
    poses = se3.exp(0.002 * torch.randn(M, 6, generator=g))
    opts = ba.BAOptions(max_iterations=2)
    layout = multihost.RankLayout(1, 1)
    edges = torch.tensor([[0, 1], [1, 2], [0, 2]])
    meas = se3.exp(0.01 * torch.randn(3, 6, generator=g))
    cases = {
        "ba_solve": lambda c: lambda: ba.ba_solve(window, chans, cam, poses,
                                                  opts, cache=c),
        "ba_solve_with_depth": lambda c: lambda: ba.ba_solve_with_depth(
            window, chans, cam, poses, opts._replace(refine_depth=True),
            cache=c),
        "make_sharded_ba": lambda c: lambda: ba.make_sharded_ba(
            world1, opts, M, cache=c)(window, chans, cam, poses),
        "make_sharded_ba_2d": lambda c: lambda: ba.make_sharded_ba_2d(
            world1, opts, M, layout, cache=c)(window, chans, cam, poses),
        "pose_graph": lambda c: lambda: pose_graph.optimize(
            poses, edges, meas, torch.eye(6).expand(3, 6, 6), device="cpu",
            cache=c)}
    for name, make in cases.items():
        _, n = _held_to_eager(make, world1, n=2)
        assert (n["calls"] > 0) == ("sharded" in name), name
        assert (n["irls"] > 0) == (name != "pose_graph"), name
    wins = [ba.KeyframeWindow(M, cam, opts, device="cpu", cache=c)
            for c in (False, graphs.RerunCache("cpu"))]
    for i in range(M):
        for w in wins:
            w.push(ba.TemplateData(*(x[i] for x in window)), chans[i],
                   poses[i].numpy())
    for _ in range(2):
        assert np.array_equal(wins[0].optimize(), wins[1].optimize())


def test_route():
    """The graphed route on CUDA with no reducer or a one-rank nccl group;
    eager for gloo on CUDA, for nccl across cards (NCCL's event nodes), on
    the CPU, when asked, inside another cache's run and when a level's
    options are verbose (ITERATION or DEBUG: a line printed per
    iteration), a given cache included; a given cache is otherwise taken
    as given."""
    cuda = torch.device("cuda", 0)
    nccl, gloo, nccl2 = (types.SimpleNamespace(backend=b, world=n) for b, n
                         in (("nccl", 1), ("gloo", 1), ("nccl", 2)))
    owned = {}
    for red in (None, nccl):
        assert graphs.capturable(red, cuda)
        assert isinstance(graphs.route(None, cuda, red, owned),
                          graphs.GraphCache)
    assert list(owned) == [cuda]
    assert graphs.route(None, cuda, nccl, owned) is owned[cuda]
    assert not graphs.capturable(gloo, cuda) and graphs.capturable(gloo,
                                                                   "cpu")
    assert graphs.route(None, cuda, gloo, owned) is None
    assert not graphs.capturable(nccl2, cuda)
    assert graphs.route(None, cuda, nccl2, owned) is None
    assert graphs.route(None, "cpu", None, owned) is None
    assert graphs.route(False, cuda, None, owned) is None
    stand_in = graphs.RerunCache("cpu")
    assert graphs.route(stand_in, "cpu", gloo) is stand_in
    seen = []
    stand_in("k", lambda: seen.append(graphs.route(None, cuda, None,
                                                   owned)) or torch.ones(1))
    assert seen == [None]
    quiet = gn.GNOptions()
    for verbosity in (VerbosityType.ITERATION, VerbosityType.DEBUG):
        loud = gn.GNOptions.from_params(
            AlgorithmParameters(verbosity=verbosity), coarse=False)
        assert loud.verbose
        for red in (None, nccl):
            assert graphs.route(None, cuda, red, owned,
                                (quiet, loud, quiet)) is None
        assert graphs.route(stand_in, "cpu", None, None, (loud,)) is None
    for verbosity in (VerbosityType.SILENT, VerbosityType.FINAL):
        opts = gn.GNOptions.from_params(
            AlgorithmParameters(verbosity=verbosity), coarse=True)
        assert graphs.route(None, cuda, None, owned,
                            (quiet, opts)) is owned[cuda]
        assert graphs.route(stand_in, "cpu", None, None, (opts,)) is stand_in


@pytest.mark.parametrize("verbosity", ["SILENT", "ITERATION", "DEBUG"])
def test_sharded_vo_verbose_takes_the_eager_step(monkeypatch, verbosity):
    """``make_sharded_vo`` on a CUDA device builds its step graph unless a
    level is verbose (``graphs.route``): with ``verbosity`` ITERATION or
    DEBUG the step is eager, so ``gauss_newton.run``'s per-iteration print
    is never captured.  The route is chosen when the entry point is made,
    so this runs without a card (``resolve_device`` told CUDA exists, the
    step graph's construction recorded)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = []
    monkeypatch.setattr(device_vo, "StepGraph",
                        lambda *a: built.append(a[-1]))
    K, b, _ = synthetic.synthesize_sequence(1, ROWS, COLS)
    p = AlgorithmParameters(**dict(dryrun.DRYRUN_PARAMS, numPyramidLevels=3),
                            verbosity=VerbosityType[verbosity])
    sharded_vo.make_sharded_vo(None, K, b, (ROWS, COLS), p, device="cuda")
    if verbosity == "SILENT":
        (cache,) = built
        assert isinstance(cache, graphs.GraphCache)
        assert cache.device == torch.device("cuda")
    else:
        assert built == []
