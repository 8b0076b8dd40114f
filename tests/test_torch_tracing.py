"""``utils.profiling``'s spans and counters on the CPU: a span costs one
flag read while nothing records, counters always count (``device_read``
of a CPU tensor is the tensor's own memory, no bytes pinned), spans nest under
their root in memory and in a ``profiling.trace`` session's Chrome JSON,
the online path (``TpuSGM.run`` then ``VisualOdometry.add_frame``, eager
and through a stand-in graph cache) opens the documented span tree with
its reads and bytes frame by frame, the keyframe branches and the
level kernel's solves are counted, the benchmark's readers of those
counters (``vobench/metrics/*.online.py``) read them, and
``scripts/online_spans.py`` gives the device's idle time to the innermost
span over it."""
import contextlib
import json
import os
import sys
import threading
import types

import numpy as np
import pytest
import torch

from bpvo_tpu_torch import AlgorithmParameters, VisualOdometry
from bpvo_tpu_torch.data.stereo import TpuSGM
from bpvo_tpu_torch.utils import graphs, profiling
from test_gn import H_IMG, W_IMG, make_cam
from test_odometry import make_sequence
from test_torch_odometry import KW, STEP
from vobench import bench

N_FRAMES = 8    # keyframes at frames 2, 3, 5, 6: with and without candidate
N_DISP = 16


@pytest.fixture(autouse=True)
def _clean_recorder():
    """Each test starts and leaves the recorder empty: the spans and
    counters are the process's."""
    profiling.reset()
    yield
    profiling.reset()


def _raise(*a, **k):
    raise AssertionError("entered while nothing records")


def test_span_off_enters_nothing(monkeypatch):
    """With no session and no ``recording()``, a span records nothing and
    enters neither the profiler's records nor NVTX."""
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", _raise)
    first = profiling.annotate("vo.add_frame")
    assert profiling.annotate("sgm.read", wait=True) is first
    with profiling.annotate("vo.add_frame"):
        with profiling.annotate("vo.read", wait=True):
            pass
    assert profiling.spans() == []


@pytest.mark.parametrize("on", [False, True])
def test_counters_count_whether_spans_record_or_not(on):
    with profiling.recording() if on else contextlib.nullcontext():
        with profiling.annotate("vo.add_frame"):
            profiling.count("device_reads")
            profiling.count("d2h_bytes", 320)
            profiling.count("d2h_bytes", 64)
            x = profiling.upload(torch.zeros(3, 4), "cpu")
            profiling.upload(x.to(torch.float64), "cpu")
            host = profiling.device_read("vo.read", torch.ones(5))
    assert np.array_equal(host, np.ones(5, np.float32))
    assert profiling.counts() == {"device_reads": 2, "d2h_bytes": 404,
                                  "h2d_bytes": 48 + 96}
    assert len(profiling.spans()) == (2 if on else 0)
    profiling.reset()
    assert profiling.counts() == {} and profiling.spans() == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.uint8, torch.int64])
def test_device_read_of_a_cpu_tensor_is_the_tensor_itself(dtype):
    """On the CPU ``device_read`` is ``t.cpu().numpy()``: the tensor's own
    memory, its values, one read and its bytes counted, no pinned bytes."""
    t = torch.arange(24, dtype=torch.float64).reshape(2, 3, 4).to(dtype)
    got = profiling.device_read("sgm.read", t)
    assert got.dtype == t.numpy().dtype and got.shape == (2, 3, 4)
    assert np.array_equal(got, t.numpy())
    assert np.shares_memory(got, t.numpy())
    assert profiling.counts() == {"device_reads": 1,
                                  "d2h_bytes": 24 * t.element_size()}


def test_upload_to_the_cpu_asks_nothing_of_pinning(monkeypatch):
    """``upload`` asks whether host memory is page-locked only for a CUDA
    target, and counts no pinned bytes for the CPU."""
    monkeypatch.setattr(torch.Tensor, "is_pinned", _raise)
    profiling.upload(torch.zeros(5), "cpu")
    profiling.upload(torch.zeros(5), torch.device("cpu"), torch.float64)
    assert profiling.counts() == {"h2d_bytes": 40}


def test_recording_nests_spans_under_their_root():
    """``recording()`` without a session: ids in the order spans begin,
    parents and roots by nesting, a root's counters at its start and end,
    the wait flag, and nothing once the block has closed."""
    profiling.count("device_reads", 7)
    with profiling.recording():
        with profiling.annotate("sgm.run"):
            with profiling.annotate("sgm.read", wait=True):
                profiling.count("device_reads")
        with profiling.annotate("vo.add_frame"):
            with profiling.annotate("vo.estimate"):
                with profiling.annotate("vo.read", wait=True):
                    profiling.count("device_reads")
            with profiling.annotate("vo.keying"):
                pass
    with profiling.annotate("after"):
        pass
    sp = sorted(profiling.spans(), key=lambda s: s.id)
    names = [s.name for s in sp]
    assert names == ["sgm.run", "sgm.read", "vo.add_frame", "vo.estimate",
                     "vo.read", "vo.keying"]
    by = {s.name: s for s in sp}
    assert by["sgm.run"].parent is None and by["vo.add_frame"].parent is None
    assert by["sgm.read"].parent == by["sgm.run"].id
    assert by["vo.read"].parent == by["vo.estimate"].id
    assert by["vo.keying"].parent == by["vo.add_frame"].id
    assert {s.root for s in sp[2:]} == {by["vo.add_frame"].id}
    assert [s.name for s in sp if s.wait] == ["sgm.read", "vo.read"]
    assert all(s.t0_ns <= s.t1_ns for s in sp)
    assert by["vo.estimate"].t0_ns <= by["vo.read"].t0_ns
    assert by["vo.read"].t1_ns <= by["vo.estimate"].t1_ns
    assert by["sgm.run"].counts0 == {"device_reads": 7}
    assert by["sgm.run"].counts1 == {"device_reads": 8}
    assert by["vo.add_frame"].counts1 == {"device_reads": 9}
    assert by["vo.read"].counts0 is None and by["vo.read"].counts1 is None


def test_trace_session_records_spans_into_its_chrome_json(tmp_path):
    """Under ``profiling.trace(device="cpu")`` spans record and sit nested
    in the exported trace with their names."""
    x = torch.randn(32, 32)
    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.annotate("vo.add_frame"):
            with profiling.annotate("vo.frame"):
                (x @ x).sum()
    with profiling.annotate("after"):
        pass
    sp = sorted(profiling.spans(), key=lambda s: s.id)
    assert [(s.name, s.parent) for s in sp] == [
        ("vo.add_frame", None), ("vo.frame", sp[0].id)]
    (path,) = [tmp_path / f for f in os.listdir(tmp_path)]
    with open(path) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"}
    outer, inner = events["vo.add_frame"], events["vo.frame"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_threads_keep_their_own_roots_and_lose_no_count():
    """Spans nest per thread, and counts from many threads all land."""
    n_threads, n = 8, 300
    errors = []

    def work(k):
        try:
            for _ in range(n):
                with profiling.annotate(f"root{k}"):
                    with profiling.annotate(f"child{k}"):
                        profiling.count("device_reads")
        except Exception as e:     # reported by the main thread
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    assert profiling.counts() == {"device_reads": n_threads * n}
    sp = profiling.spans()
    by = {s.id: s for s in sp}
    for s in sp:
        if s.name.startswith("child"):
            root = by[s.parent]
            assert root.name == "root" + s.name[5:] and s.root == root.id


def test_spans_past_capacity_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    with profiling.recording():
        for k in range(5):
            with profiling.annotate(f"vo.frame{k}"):
                pass
    assert [s.name for s in profiling.spans()] == [
        "vo.frame0", "vo.frame1", "vo.frame2"]
    assert profiling.counts() == {"spans_dropped": 2}


def test_a_span_closes_when_its_block_raises():
    """The span is kept with the exception passing through, and the next
    span opens as a root again."""
    with profiling.recording():
        with pytest.raises(ValueError):
            with profiling.annotate("vo.add_frame"):
                with profiling.annotate("vo.read", wait=True):
                    raise ValueError("read failed")
        with profiling.annotate("sgm.run"):
            pass
    sp = sorted(profiling.spans(), key=lambda s: s.id)
    assert [(s.name, s.parent is None) for s in sp] == [
        ("vo.add_frame", True), ("vo.read", False), ("sgm.run", True)]


def test_recording_blocks_nest():
    """Spans record until the outermost ``recording()`` block closes."""
    with profiling.recording():
        with profiling.recording():
            with profiling.annotate("vo.a"):
                pass
        with profiling.annotate("vo.b"):
            pass
    with profiling.annotate("vo.c"):
        pass
    assert [s.name for s in profiling.spans()] == ["vo.a", "vo.b"]


# ---------------------------------------------------------------------------
# the online path's span tree, reads and bytes
# ---------------------------------------------------------------------------

class _StandIn(graphs.RerunCache):
    """A graph cache on the CPU whose "replay" reruns the function."""
    hold_counts = True


@pytest.fixture(scope="module")
def frames():
    return make_sequence(STEP, N_FRAMES)


def _tree(spans, root):
    """(name, wait, children) of ``root``'s subtree, children in order."""
    kids = sorted((s for s in spans if s.parent == root.id),
                  key=lambda s: s.id)
    return (root.name, root.wait, [_tree(spans, k) for k in kids])


def _leaf(name, wait=False):
    return (name, wait, [])


def _graphed(name, graphed, after=()):
    """The span ``name`` over one ``GraphCache.jit`` call (graphed) and
    the spans ``after`` it."""
    jit = [_leaf(n) for n in ("graph.key", "graph.copy_in", "graph.replay",
                              "graph.copy_out")] if graphed else []
    return (name, False, jit + list(after))


def _expected(kind, graphed):
    estimate = _graphed("vo.estimate", graphed, [_leaf("vo.read", True)])
    head = [_leaf("vo.upload"), _graphed("vo.frame", graphed)]
    templates = _graphed("vo.templates", graphed)
    if kind == "first":
        return ("vo.add_frame", False, head + [templates])
    body = head + [estimate, _leaf("vo.keying")]
    if kind == "other":
        return ("vo.add_frame", False, body)
    keyframe = [("vo.cloud", False, [_leaf("vo.cloud_read", True)]),
                templates] + ([estimate] if kind == "candidate" else [])
    return ("vo.add_frame", False, body + [("vo.keyframe", False,
                                            keyframe)])


@pytest.mark.parametrize("graphed", [False, True])
def test_online_frames_give_the_span_tree_reads_and_bytes(frames, graphed):
    """``TpuSGM.run`` then ``VisualOdometry.add_frame`` a frame under
    ``recording()``: each frame's two roots hold the documented tree, and
    the counters between the ``sgm.run`` root's start and the
    ``vo.add_frame`` root's end give 2 reads on other frames, 3 on a
    keyframe without a candidate and 4 with one, and the bytes of what
    the code copies: the images in and the disparity out, the estimate's
    starts and packed result, the point cloud's float64 parts."""
    cam = make_cam()
    p = AlgorithmParameters(**KW)
    vo = VisualOdometry(np.asarray(cam.K()), float(cam.baseline),
                        (H_IMG, W_IMG), p, device="cpu")
    if graphed:
        vo._graphs = _StandIn("cpu")
    sgm = TpuSGM(num_disparities=N_DISP)
    results = []
    with profiling.recording():
        for image, disparity in frames:
            right = np.roll(image, -3, axis=1)
            sgm.run(image, right, device="cpu")
            results.append(vo.add_frame(image, disparity))
    spans = profiling.spans()
    roots = sorted((s for s in spans if s.parent is None),
                   key=lambda s: s.id)
    assert [r.name for r in roots] == ["sgm.run", "vo.add_frame"] * N_FRAMES
    pixels = H_IMG * W_IMG
    packed = 4 * (53 + 9 * p.numPyramidLevels)
    cloud = 8 * 7 * vo._capacities[p.maxTestLevel]
    kinds = []
    for i, (s, a) in enumerate(zip(roots[::2], roots[1::2])):
        r = results[i]
        kind = ("first" if i == 0 else "other" if not r.is_keyframe
                else "candidate" if not results[i - 1].is_keyframe
                else "no_candidate")
        kinds.append(kind)
        assert _tree(spans, s) == ("sgm.run", False, [
            _leaf("sgm.census"), _leaf("sgm.cost_volume"),
            _leaf("sgm.aggregate"), _leaf("sgm.read", True)])
        assert _tree(spans, a) == _expected(kind, graphed), kind
        got = {k: a.counts1.get(k, 0) - s.counts0.get(k, 0)
               for k in ("device_reads", "h2d_bytes", "d2h_bytes")}
        estimates = {"first": 0, "other": 1, "no_candidate": 1,
                     "candidate": 2}[kind]
        clouds = kind in ("candidate", "no_candidate")
        # sgm: left and right (float32 here) in, the disparity out;
        # add_frame: the image and the disparity in
        assert got == {
            "device_reads": 1 + estimates + clouds,
            "h2d_bytes": 4 * 4 * pixels + 128 * estimates,
            "d2h_bytes": 4 * pixels + packed * estimates + cloud * clouds,
        }, (i, kind)
    assert set(kinds) == {"first", "other", "candidate", "no_candidate"}


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans and counters
# ---------------------------------------------------------------------------

class _Recorder:
    """Hand-made spans of online frames, as ``profiling.spans()`` gives
    them (in the order they end), with the program's counts."""

    def __init__(self, pinned=True):
        self.spans, self.counts, self.next_id = [], {}, 1
        self.pinned = pinned

    def span(self, name, parent=None, wait=False):
        s = types.SimpleNamespace(name=name, id=self.next_id,
                                  parent=None if parent is None
                                  else parent.id,
                                  root=self.next_id if parent is None
                                  else parent.root, wait=wait,
                                  t0_ns=self.next_id, t1_ns=self.next_id)
        self.next_id += 1
        return s

    def end(self, s, counts0=None):
        """``s`` ended: a root takes its counters."""
        if s.parent is None:
            s.counts0, s.counts1 = counts0, dict(self.counts)
        self.spans.append(profiling.Span(**vars(s)))

    def add(self, **n):
        for k, v in n.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def copy(self, h2d=0, d2h=0, pinned=True):
        """Bytes up and down, counted pinned too where ``pinned`` and the
        recorder's program counts them (``self.pinned``)."""
        self.add(h2d_bytes=h2d, d2h_bytes=d2h)
        if pinned and self.pinned:
            self.add(h2d_pinned_bytes=h2d, d2h_pinned_bytes=d2h)

    def frame(self, keyframe, extra=None):
        """An online frame: the disparity read and uploaded, an estimate
        (starts up, packed result down) and, on a keyframe, the cloud's
        read (not pinned here) and the re-estimate; ``extra``: further
        counts the frame adds."""
        c0 = dict(self.counts)
        sgm = self.span("sgm.run")
        read = self.span("sgm.read", sgm, True)
        self.add(device_reads=1)
        self.copy(d2h=1_866_464)
        self.end(read)
        self.end(sgm, c0)
        c1 = dict(self.counts)
        a = self.span("vo.add_frame")
        self.end(self.span("vo.upload", a))
        self.copy(h2d=1_866_464 + 128)
        read = self.span("vo.read", a, True)
        self.add(device_reads=1)
        self.copy(d2h=352)
        self.end(read)
        if keyframe:
            kf = self.span("vo.keyframe", a)
            read = self.span("vo.cloud_read", kf, True)
            self.add(device_reads=2)
            self.copy(d2h=1_048_576, pinned=False)
            self.copy(h2d=128, d2h=352)
            self.end(read)
            self.end(kf)
        self.add(**(extra or {}))
        self.end(a, c1)


def _ctx(n):
    logs = []
    return types.SimpleNamespace(traced_frames=n, log=logs.append,
                                 logs=logs)


def _recorded(monkeypatch, frames, extra=True, pinned=True):
    """``profiling.spans()`` reads ``frames`` (keyframe or not, a frame),
    then, with ``extra``, a later session's frame; ``pinned``: the program
    counts pinned bytes."""
    rec = _Recorder(pinned)
    for kf in frames:
        rec.frame(kf)
    if extra:
        rec.frame(True)
    monkeypatch.setattr(profiling, "_spans", rec.spans)


_PINNED = 3 * (2 * 1_866_464 + 128 + 352) + 352 + 128
READINGS = {   # over frames: other, keyframe, other
    "device_reads_per_frame.online": 8 / 3,
    "host_copy_mb_per_frame.online": (_PINNED + 1_048_576) / 3 / 1e6,
    "pinned_copy_pct.online": 100 * _PINNED / (_PINNED + 1_048_576),
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_reads_the_traced_frames(monkeypatch, name):
    """The first ``traced_frames`` frames only, each ``vo.add_frame`` root
    with the ``sgm.run`` root before it."""
    _recorded(monkeypatch, [False, True, False])
    ctx = _ctx(3)
    value = bench.metric_reader(name)(ctx)
    assert value == pytest.approx(READINGS[name], rel=1e-9)


def test_pinned_share_is_zero_where_the_program_counts_no_pinned_bytes(
        monkeypatch):
    """A program with the spans but without the pinned counters (the
    parent commit's) reads 0."""
    _recorded(monkeypatch, [False, True, False], pinned=False)
    assert bench.metric_reader("pinned_copy_pct.online")(_ctx(3)) == 0.0


def _short(monkeypatch):
    _recorded(monkeypatch, [False, True], extra=False)
    return 3, "2 vo.add_frame roots"


def _unpaired(monkeypatch):
    rec = _Recorder()
    rec.frame(True)
    monkeypatch.setattr(profiling, "_spans",
                        [s for s in rec.spans if s.name != "sgm.run"])
    return 1, "no sgm.run root"


def _no_recorder(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    return 1, "records no spans"


@pytest.mark.parametrize("name", sorted(READINGS))
@pytest.mark.parametrize("fault", [_short, _unpaired, _no_recorder],
                         ids=["short", "unpaired", "no_recorder"])
def test_reader_is_silent_without_its_frames(monkeypatch, name, fault):
    """None, with the reason logged: fewer frames recorded than traced, a
    frame without its matcher root, a program with no ``spans()`` (the
    parent commit's)."""
    read = bench.metric_reader(name)
    n, why = fault(monkeypatch)
    ctx = _ctx(n)
    assert read(ctx) is None and why in ctx.logs[-1]


# ---------------------------------------------------------------------------
# the keyframe and level-solve counters, and their readers
# ---------------------------------------------------------------------------

def _online_run(frames, graphed):
    """The 8-frame sequence through ``TpuSGM.run`` and
    ``VisualOdometry.add_frame`` under ``recording()``: the results and
    each frame's ``vo.add_frame`` root."""
    cam = make_cam()
    vo = VisualOdometry(np.asarray(cam.K()), float(cam.baseline),
                        (H_IMG, W_IMG), AlgorithmParameters(**KW),
                        device="cpu")
    if graphed:
        vo._graphs = _StandIn("cpu")
    sgm = TpuSGM(num_disparities=N_DISP)
    results = []
    with profiling.recording():
        for image, disparity in frames:
            sgm.run(image, np.roll(image, -3, axis=1), device="cpu")
            results.append(vo.add_frame(image, disparity))
    roots = sorted((s for s in profiling.spans()
                    if s.name == "vo.add_frame"), key=lambda s: s.id)
    return vo, results, roots


@pytest.mark.parametrize("graphed", [False, True])
def test_keyframe_counters_count_each_branch(frames, graphed):
    """``keyframes`` a keyframe after the first frame, ``keyframes_own``
    those without a candidate; both there, at 0, from construction."""
    _, results, roots = _online_run(frames, graphed)
    kinds = []
    for i, (r, a) in enumerate(zip(results, roots)):
        got = {k: a.counts1[k] - a.counts0.get(k, 0)
               for k in ("keyframes", "keyframes_own")}
        kind = ("first" if i == 0 else "other" if not r.is_keyframe
                else "candidate" if not results[i - 1].is_keyframe
                else "no_candidate")
        kinds.append(kind)
        assert got == {"keyframes": int(kind in ("candidate",
                                                 "no_candidate")),
                       "keyframes_own": int(kind == "no_candidate")}, i
    assert kinds.count("candidate") == kinds.count("no_candidate") == 2
    assert profiling.counts()["keyframes"] == 4
    assert profiling.counts()["keyframes_own"] == 2


def test_solve_counters_count_the_front_and_the_re_estimates(frames,
                                                             monkeypatch):
    """The ``gn_*`` counters over the sequence's estimates, the
    re-estimates against a candidate from their start level, at C = 1."""
    from bpvo_tpu_torch.vo.pose_estimator import PoseEstimator
    from test_torch_fast_motion import _expected_solves
    calls = []
    orig = PoseEstimator.estimate

    def estimate(self, *a, start_level=-1, **kw):
        T, stats = orig(self, *a, start_level=start_level, **kw)
        calls.append((start_level, stats))
        return T, stats
    monkeypatch.setattr(PoseEstimator, "estimate", estimate)
    vo, _, _ = _online_run(frames, False)
    assert sorted({s for s, _ in calls}) == [-1, 1]
    got = {k: v for k, v in profiling.counts().items()
           if k.startswith("gn_")}
    assert got == _expected_solves(vo.params, vo._capacities, 1, calls)


def _metric_module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "test_metric_" + name.replace(".", "_"),
        bench.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# level_gn launches (C, K, iterations) of three traced frames: a C = 1
# front estimate, a C = 8 one (bound by operations at L0, by bytes below),
# and a frame without an estimate
LAUNCHES = [[(1, 16384, 12), (1, 4096, 9), (1, 1024, 14), (1, 512, 30)],
            [(8, 16384, 22), (8, 4096, 3), (8, 1024, 1)], []]


def _solve_counts(launches):
    return {"gn_solves": len(launches),
            "gn_points": sum(K for _, K, _ in launches),
            "gn_channel_points": sum(C * K for C, K, _ in launches),
            "gn_iter_points": sum(it * K for _, K, it in launches),
            "gn_iter_channel_points": sum(it * C * K
                                          for C, K, it in launches)}


def _gn_ctx(monkeypatch, frames_launches=LAUNCHES, counted=True,
            n_events=None, launched=None):
    rec = _Recorder()
    for launches in frames_launches:
        rec.frame(False, _solve_counts(launches) if counted else None)
    rec.frame(True, _solve_counts(LAUNCHES[0]))    # a later session's
    monkeypatch.setattr(profiling, "_spans", rec.spans)
    n = sum(map(len, frames_launches))
    durs = [40.0 + 7 * i for i in range(n if n_events is None
                                        else n_events)]
    events = [{"name": "void level_gn_kernel<true>", "ts": i, "dur": d}
              for i, d in enumerate(durs)]
    ctx = _ctx(len(frames_launches))
    ctx.trace = types.SimpleNamespace(
        named=lambda part: events if part == "level_gn_kernel" else [])
    ctx.launches = {"level_gn": n if launched is None else launched}
    return ctx, sum(durs) * 1e-6


def test_level_gn_reader_bounds_the_summed_launches(monkeypatch):
    """The bound of ``roofline.level_gn`` summed over an explicit launch
    list, from the counters alone, over the events' time; the sum equals
    the sum of each launch's bound where one peak binds them all."""
    from vobench import roofline
    mod = _metric_module("level_gn_roofline_pct.online")
    flat = [x for f in LAUNCHES for x in f]
    total = tuple(map(sum, zip(*(roofline.level_gn(*x) for x in flat))))
    c = _solve_counts(flat)
    assert mod.summed(*(c[k] for k in mod.COUNTERS)) == total
    ctx, seconds = _gn_ctx(monkeypatch)
    assert mod.read(ctx) == pytest.approx(
        100.0 * roofline.bound_s(*total)[0] / seconds, rel=1e-12)
    for side in ([x for x in flat if x[2] <= 12],
                 [x for x in flat if x[2] >= 14]):
        c = _solve_counts(side)
        by = {roofline.bound_s(*roofline.level_gn(*x))[1] for x in side}
        assert len(by) == 1
        assert roofline.bound_s(*mod.summed(
            *(c[k] for k in mod.COUNTERS)))[0] == pytest.approx(
            sum(roofline.bound_s(*roofline.level_gn(*x))[0]
                for x in side), rel=1e-12)


@pytest.mark.parametrize("fault, why", [
    (dict(n_events=6), "6 trace events, 7 solves counted, 7 launches"),
    (dict(launched=8), "7 trace events, 7 solves counted, 8 launches"),
    (dict(counted=False), "7 trace events, 0 solves counted")],
    ids=["events", "launches", "no_counters"])
def test_level_gn_reader_is_silent_where_the_counts_differ(monkeypatch,
                                                           fault, why):
    """None, logged: a trace that lost an event, a launch count that
    differs, a program without the counters (the parent commit's)."""
    ctx, _ = _gn_ctx(monkeypatch, **fault)
    read = bench.metric_reader("level_gn_roofline_pct.online")
    assert read(ctx) is None and why in ctx.logs[-1]


def test_level_gn_reader_needs_a_trace(monkeypatch):
    ctx, _ = _gn_ctx(monkeypatch)
    ctx.trace = None
    assert bench.metric_reader("level_gn_roofline_pct.online")(ctx) is None


CALL = (376, 1241, 128)     # a matcher call's (H, W, D)


def _cost_ctx(n=3, n_events=None, launched=None, n_shapes=None):
    """A traced slice of ``n`` matcher calls: kernel events, the settled
    ``census_cost`` count and the calls' shapes, each ``n`` unless given."""
    durs = [95.0 + 3 * i for i in range(n if n_events is None
                                        else n_events)]
    events = [{"name": "void (anonymous namespace)::census_cost_kernel("
                       "unsigned char const*, unsigned char const*, float*, "
                       "int, int, int)", "ts": i, "dur": d}
              for i, d in enumerate(durs)]
    ctx = _ctx(n)
    ctx.trace = types.SimpleNamespace(
        named=lambda part: events if part == "census_cost_kernel" else [])
    ctx.launches = {} if launched == 0 else {
        "census_cost": n if launched is None else launched}
    ctx.sgm_calls = [CALL] * (n if n_shapes is None else n_shapes)
    return ctx, sum(durs) * 1e-6


def test_cost_volume_reader_reads_bound_over_time():
    """The volume written once and the two code images read once, at 3.35
    TB/s, summed over the calls, over the kernel events' time."""
    from vobench import roofline
    H, W, D = CALL
    ctx, seconds = _cost_ctx()
    value = bench.metric_reader("cost_volume_roofline_pct.online")(ctx)
    bound = 3 * (4 * H * W * D + 2 * H * W) / roofline.PEAK_BYTES_PER_S
    assert value == pytest.approx(100.0 * bound / seconds, rel=1e-12)
    assert 0 < value < 100


@pytest.mark.parametrize("fault, why", [
    (dict(n_events=2), "2 kernel events, 3 launches counted, 3 call"),
    (dict(launched=4), "3 kernel events, 4 launches counted, 3 call"),
    (dict(n_shapes=2), "3 kernel events, 3 launches counted, 2 call"),
    (dict(n_events=0, launched=0), "0 kernel events, 0 launches counted")],
    ids=["events", "launches", "shapes", "no_kernel"])
def test_cost_volume_reader_is_silent_where_the_counts_differ(fault, why):
    """None, logged: a trace that lost an event, a count or a shape list
    that differs, a program without the kernel (the parent commit's)."""
    ctx, _ = _cost_ctx(**fault)
    read = bench.metric_reader("cost_volume_roofline_pct.online")
    assert read(ctx) is None and why in ctx.logs[-1]


def test_cost_volume_reader_needs_a_trace():
    ctx, _ = _cost_ctx()
    ctx.trace = None
    assert bench.metric_reader("cost_volume_roofline_pct.online")(ctx) is None


@pytest.mark.parametrize("counted", [True, False])
def test_keyframes_own_reader(monkeypatch, counted):
    """``keyframes_own`` over the traced frames, a frame; nothing from a
    program that counts no keyframes (the parent commit's)."""
    rec = _Recorder()
    for own in (1, 1, 0):
        rec.frame(True, {"keyframes": 1, "keyframes_own": own}
                  if counted else None)
    rec.frame(True, {"keyframes": 1, "keyframes_own": 1})
    monkeypatch.setattr(profiling, "_spans", rec.spans)
    ctx = _ctx(3)
    value = bench.metric_reader("keyframes_own_per_frame.online")(ctx)
    if counted:
        assert value == pytest.approx(2 / 3, rel=1e-12)
    else:
        assert value is None and "counts no keyframes" in ctx.logs[-1]


# ---------------------------------------------------------------------------
# scripts/online_spans.py: the device's idle time by innermost span
# ---------------------------------------------------------------------------

def _load_online_spans():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "online_spans.py")
    spec = importlib.util.spec_from_file_location("online_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_idle_goes_to_the_innermost_span_over_it():
    """Two frames (us): a kernel at 3-5 under sgm.census, a copy at 12-14
    under sgm.read; device work outside the window is clipped away, and
    the gap between the frames' roots is "between frames"."""
    def x(name, ts, dur, cat="cpu_op"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = []
    for t in (0, 40):
        events += [x("sgm.run", t, 15), x("sgm.census", t + 2, 4),
                   x("sgm.read", t + 11, 4),
                   x("k", t + 3, 2, "kernel"),
                   x("Memcpy DtoH", t + 12, 2, "gpu_memcpy"),
                   x("vo.add_frame", t + 20, 10),
                   x("graph.replay", t + 21, 3),
                   x("lvl", t + 22, 6, "kernel"),
                   x("aten::copy_", t + 28, 1)]
    events += [x("k", -5, 3, "kernel"), x("k", 75, 3, "kernel"),
               x("gpu_user_annotation", 0, 70, "gpu_user_annotation")]
    out = _load_online_spans().idle_by_span(events, 2)
    # a frame's gaps (us): 0-3, 5-12, 14-22, 28-30 and, between the
    # frames, 30-40; the next frame's sgm.run from 40
    assert out["idle_ms_per_frame_by_span"] == pytest.approx({
        "sgm.run": 7e-3, "sgm.census": 2e-3, "sgm.read": 2e-3,
        "vo.add_frame": 3e-3, "graph.replay": 1e-3,
        "between frames": 10e-3}, rel=1e-9)
    assert out["window_ms"] == pytest.approx(70e-3)
    assert out["busy_ms"] == pytest.approx(20e-3)
    assert out["idle_ms"] == pytest.approx(50e-3)
    assert out["idle_under_span_share"] == pytest.approx(0.6)
    assert out["span_events"] == 10 and out["device_events"] == 8
