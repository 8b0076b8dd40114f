"""The keyframe branch as an IF body and the read-free chunk route on the
CPU, where no CUDA graph can run: ``utils/graphs.cond`` outside a cache,
in the stand-in (``ReplayStandIn``: a replay reruns the function, an IF
body only when its predicate is true) and in a recording cache whose IF
bodies count their launches only on the replays that take them (a fake op
module; ``graphs.settle``); ``DeviceVO``'s graphed step through the
stand-in bit for bit against the unsplit step over 12 steps with a
keyframe on the first step and keyframes right after keyframes (the
``has_prev`` false branch); ``add_frames`` in chunks of 1, 3 and 7; the
chunk route against JAX's ``DeviceVO.add_frames`` (``lax.scan``) at the
accepted deltas (b) (1.8e-4, intensity) and (e) (2.3e-3, Bit-Planes);
``has_prev`` as a 0-d bool tensor through ``utils/convert`` and a
checkpoint round trip.  The graphs themselves run in
tests/test_torch_graphs_gpu.py on the card."""
import contextlib
import types

import numpy as np
import pytest
import torch

from bpvo_tpu import AlgorithmParameters as JParams
from bpvo_tpu.data import stereo as jstereo
from bpvo_tpu.types import DescriptorType as JDesc
from bpvo_tpu.types import LossFunctionType as JLoss
from bpvo_tpu.utils import checkpoint as jcheckpoint
from bpvo_tpu.vo.device_vo import DeviceVO as JDeviceVO
from bpvo_tpu_torch import AlgorithmParameters, DescriptorType
from bpvo_tpu_torch import LossFunctionType
from bpvo_tpu_torch.data import stereo, synthetic
from bpvo_tpu_torch.utils import checkpoint, graphs
from bpvo_tpu_torch.utils.convert import state_from_numpy
from bpvo_tpu_torch.vo import device_vo as dv
from test_gn import H_IMG, W_IMG, make_cam
from test_odometry import make_sequence
from test_torch_device_vo import KW, STEP, _jax_state_to_numpy
from test_torch_graphs import (ReplayStandIn, _assert_outputs_equal,
                               _parent_make_vo_step)
from test_torch_stereo import _params as _stereo_params
from test_torch_stereo import stereo_frames  # noqa: F401  (a fixture)

POSE_ATOL_B = 1.8e-4       # accepted delta (b), ROADMAP C
POSE_ATOL_E = 2.3e-3       # accepted delta (e), ROADMAP C
N_STEPS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Whole-frame runs of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# graphs.cond and the launch counts of IF bodies
# ---------------------------------------------------------------------------

def _fake_op_module():
    mod = types.SimpleNamespace(launch_count=0)

    def op(x):
        mod.launch_count += 1
        return x + 1
    return mod, op


def test_cond_outside_a_cache_reads_the_predicate():
    """Without a cache ``cond`` is a host branch: ``body()`` when the
    predicate is true, else ``into`` itself, the body not called."""
    calls = []
    into = (torch.zeros(2),)

    def body():
        calls.append(1)
        return (torch.ones(2),)
    assert graphs.cond(torch.tensor(False), body, into) is into
    assert not calls
    got = graphs.cond(torch.tensor(True), body, into)
    assert torch.equal(got[0], torch.ones(2)) and calls == [1]
    assert torch.equal(into[0], torch.zeros(2))


def test_stand_in_reruns_a_body_only_when_taken():
    """Through ``ReplayStandIn``: the first call (the warm-up) runs the
    body once even when it is not taken, without counting it, and copies
    nothing; each replay reruns the body only when its predicate is true
    and copies its results over ``into``."""
    mod, op = _fake_op_module()
    cache = ReplayStandIn("cpu", modules=(mod,))
    x, flag = torch.zeros(3), torch.zeros((), dtype=torch.bool)
    out = torch.full((3,), -1.0)
    calls = []

    def fn():
        y = op(x)

        def body():
            calls.append(1)
            return op(y) * 10
        return graphs.cond(flag, body, out)

    assert torch.equal(cache("k", fn), torch.full((3,), -1.0))
    assert calls == [1] and mod.launch_count == 1
    for take in (False, True, True, False, True):
        x.add_(1.0)
        flag.fill_(take)
        n = len(calls)
        got = cache("k", fn).clone()
        assert len(calls) == n + take
        if take:
            assert torch.equal(got, (x + 2) * 10)
    assert len(cache) == 1


class RecordingIf(graphs.GraphCache):
    """A capture that runs the function's Python (so the wrappers count)
    and records each IF body's predicates (its own and its enclosing
    bodies'); a replay returns the captured outputs without entering
    Python and adds one to the device counter of every body whose
    predicates are all true, as the graph's IF nodes do.  The predicates
    are static inputs the test sets."""

    def _warm_up(self, fn):
        return fn()

    def _capture(self, fn):
        self._chain, chains = [], []
        self._chains = chains
        out = fn()
        taken = self._taken
        taken.zero_()        # the capture ran the bodies' increments

        def replay():
            for slot, preds in enumerate(chains):
                if all(bool(p) for p in preds):
                    taken[slot] += 1
            return out
        return types.SimpleNamespace(replay=replay)

    @contextlib.contextmanager
    def _if_node(self, pred):
        self._chain.append(pred)
        self._chains.append(tuple(self._chain))
        try:
            yield
        finally:
            self._chain.pop()


def test_if_bodies_count_only_when_taken():
    """Nested IF bodies: after ``settle`` the counts equal those of running
    the function eagerly under the same predicates, every replay's
    unconditional launches added and each body's launches added for the
    replays that took it; the first call counts through the wrappers (a
    body it does not take is warmed, not counted)."""
    mod, op = _fake_op_module()
    idle = types.SimpleNamespace(launch_count=5)
    cache = RecordingIf("cpu", modules=(mod, idle))
    x = torch.zeros(2)
    a, b = torch.zeros((), dtype=torch.bool), torch.zeros((), dtype=torch.bool)

    def fn():
        y = op(x)

        def outer():
            z = op(op(y))
            return graphs.cond(b, lambda: op(op(op(z))), z)
        return graphs.cond(a, outer, y)

    eager = 0
    for fa, fb in [(0, 1), (1, 1), (0, 0), (1, 0), (1, 1), (0, 1), (1, 1)]:
        a.fill_(bool(fa))
        b.fill_(bool(fb))
        cache("k", fn)
        eager += 1 + fa * (2 + 3 * fb)
        graphs.settle()
        assert mod.launch_count == eager, (fa, fb)
    assert idle.launch_count == 5
    graphs.settle()                      # settling twice adds nothing
    assert mod.launch_count == eager


def test_cond_capture_checks_its_predicate():
    """The predicate must be a 0-d bool tensor, and a captured graph holds
    as many IF bodies as it has (the counters are sized by the bodies the
    warm-up ran; once a fixed 16): 40 bodies, each counted for the replays
    that take it."""
    mod, op = _fake_op_module()
    cache = RecordingIf("cpu", modules=(mod,))
    x = torch.zeros(2)
    with pytest.raises(ValueError, match="0-d bool"):
        cache("a", lambda: graphs.cond(torch.ones(2, dtype=torch.bool),
                                       lambda: x + 1, x))
    flags = torch.zeros(40, dtype=torch.bool)

    def many():
        for i in range(40):
            graphs.cond(flags[i], lambda: op(x), x.clone())
        return x
    cache("b", many)
    taken, records = graphs._bodies[-1]
    assert mod.launch_count == 0 and len(records) == 40 <= len(taken)
    flags[::3] = True
    for n in range(1, 4):
        cache("b", many)
        graphs.settle()
        assert mod.launch_count == n * 14


# ---------------------------------------------------------------------------
# DeviceVO: the keyframe branch as an IF body, the chunk route
# ---------------------------------------------------------------------------

def _case(descriptor):
    """(K, baseline, 1 + N_STEPS frames, params, stereo_fn): the frame after
    the first is skipped, so the first step moves two frames' worth and is
    a keyframe with no candidate; with the threshold between one and two
    frames' motion, a keyframe with a candidate (the re-estimate leaves
    one frame's motion in T_kf) is followed by one without."""
    if descriptor == "intensity":
        cam = make_cam()
        frames = make_sequence(STEP, N_STEPS + 2)
        frames = frames[:1] + frames[2:]
        return (np.asarray(cam.K()), float(cam.baseline), frames,
                AlgorithmParameters(**KW), None)
    K, b, sframes = synthetic.synthesize_stereo_sequence(N_STEPS + 2, H_IMG,
                                                         W_IMG)
    sframes = sframes[:1] + sframes[2:]
    lookup = [(torch.as_tensor(left), torch.as_tensor(d))
              for left, _, d in sframes]

    def stereo_fn(left, right):
        # the candidate's disparity: the matcher's input is picked by
        # torch.where, so it is looked up by value
        return next(d for l, d in lookup if torch.equal(l, left))

    params = AlgorithmParameters(**dict(
        KW, descriptor=DescriptorType.BITPLANES,
        minTranslationMagToKeyFrame=0.045))
    return K, b, [(l, r) for l, r, _ in sframes], params, stereo_fn


@pytest.mark.parametrize("descriptor", ["intensity", "bitplanes"])
def test_graphed_step_keyframe_branches_bitwise(descriptor):
    """Over 12 steps the graphed ``DeviceVO`` (stand-in: one step graph,
    the keyframe branch an IF body, ``has_prev`` a tensor) and the eager
    one give the unsplit step's outputs bit for bit, with a keyframe on the
    first step, keyframes right after keyframes (no candidate) and
    keyframes with a candidate; the graphed state's ``has_prev`` and last
    weights follow."""
    K, b, frames, params, stereo_fn = _case(descriptor)
    eager = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu",
                        stereo_fn=stereo_fn)
    graphed = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu",
                          stereo_fn=stereo_fn)
    graphed._graphs = ReplayStandIn("cpu")
    parent = _parent_make_vo_step(eager._p, eager._cams, eager._capacities,
                                  eager._opts, stereo_fn)
    eager.add_frame(*frames[0])
    graphed.add_frame(*frames[0])
    state = eager.state
    kf, with_prev = [], []
    for image, aux in frames[1:]:
        with_prev.append(bool(state.has_prev))
        state, want = parent(state, torch.as_tensor(image),
                             torch.as_tensor(aux))
        _assert_outputs_equal(eager.add_frame(image, aux), want)
        _assert_outputs_equal(graphed.add_frame(image, aux), want)
        assert graphed.state.has_prev.dtype == torch.bool
        assert bool(graphed.state.has_prev) == bool(state.has_prev)
        assert torch.equal(graphed.state.last_weights, state.last_weights)
        kf.append(bool(want.is_keyframe))
    kf, with_prev = np.array(kf), np.array(with_prev)
    assert kf[0] and not with_prev[0]
    assert np.any(kf[1:] & kf[:-1])              # a keyframe after one
    assert np.any(kf & with_prev) and not kf.all()
    assert len(graphed._graphs) == 1


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_add_frames_chunks_bitwise(chunk):
    """``add_frames`` in chunks (stand-in graph) equals an ``add_frame``
    loop bit for bit, every field stacked over the chunk's steps."""
    K, b, frames, params, _ = _case("intensity")
    images = np.stack([f[0] for f in frames])
    disps = np.stack([f[1] for f in frames])
    loop = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    want = [loop.add_frame(i, d) for i, d in zip(images, disps)][1:]
    vo = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    vo._graphs = ReplayStandIn("cpu")
    vo.add_frame(images[0], disps[0])
    got = []
    for lo in range(1, len(frames), chunk):
        out = vo.add_frames(images[lo:lo + chunk], disps[lo:lo + chunk])
        assert out.pose.shape == (min(chunk, len(frames) - lo), 4, 4)
        got += [dv.VOStepOutput(*(f[i] for f in out))
                for i in range(out.pose.shape[0])]
    assert len(got) == len(want) == N_STEPS
    for g, w in zip(got, want):
        _assert_outputs_equal(g, w)


def _chunks_against_jax(jvo, tvo, images, auxs, sizes, atol):
    n_kf = 0
    lo = 0
    for size in sizes:
        oj = jvo.add_frames(images[lo:lo + size], auxs[lo:lo + size])
        ot = tvo.add_frames(images[lo:lo + size], auxs[lo:lo + size])
        lo += size
        assert np.array_equal(ot.is_keyframe.numpy(),
                              np.asarray(oj.is_keyframe))
        np.testing.assert_allclose(ot.pose.numpy(), np.asarray(oj.pose),
                                   atol=atol)
        np.testing.assert_allclose(ot.pose_world.numpy(),
                                   np.asarray(oj.pose_world), atol=atol)
        assert np.abs(ot.iters.numpy() - np.asarray(oj.iters)).max() <= 1
        n_kf += int(np.asarray(oj.is_keyframe).sum())
    assert lo == len(images) and n_kf >= 2


def test_chunks_match_jax_scan_intensity(monkeypatch):
    """The chunk route (stand-in) against JAX's ``lax.scan`` chunks on its
    level-kernel route, chunk for chunk, within delta (b)."""
    monkeypatch.setenv("BPVO_LEVEL_KERNEL", "force")
    K, b, frames, _, _ = _case("intensity")
    images = np.stack([f[0] for f in frames[:9]])
    disps = np.stack([f[1] for f in frames[:9]])
    jvo = JDeviceVO(K, b, (H_IMG, W_IMG), JParams(**KW))
    tvo = dv.DeviceVO(K, b, (H_IMG, W_IMG), AlgorithmParameters(**KW),
                      device="cpu")
    tvo._graphs = ReplayStandIn("cpu")
    _chunks_against_jax(jvo, tvo, images, disps, (4, 5), POSE_ATOL_B)


def test_chunks_match_jax_scan_stereo_bitplanes(monkeypatch, stereo_frames):
    """Stereo Bit-Planes with the SGM matcher in the keyframe branch: the
    chunk route (stand-in) against JAX's ``lax.scan`` chunks on its
    level-kernel route within delta (e)."""
    monkeypatch.setenv("BPVO_LEVEL_KERNEL", "force")
    ds, frames = stereo_frames
    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    jvo = JDeviceVO(ds.calibration.K, ds.calibration.baseline, ds.image_size,
                    _stereo_params(JParams, JDesc, JLoss),
                    stereo_fn=jstereo.TpuSGM(num_disparities=48).as_fn())
    tvo = dv.DeviceVO(ds.calibration.K, ds.calibration.baseline,
                      ds.image_size, _stereo_params(
                          AlgorithmParameters, DescriptorType,
                          LossFunctionType),
                      stereo_fn=stereo.TpuSGM(num_disparities=48).as_fn(),
                      device="cpu")
    tvo._graphs = ReplayStandIn("cpu")
    _chunks_against_jax(jvo, tvo, lefts, rights, (3, 3), POSE_ATOL_E)


# ---------------------------------------------------------------------------
# has_prev across from JAX and through checkpoints
# ---------------------------------------------------------------------------

def test_has_prev_tensor_through_convert_and_checkpoints(tmp_path):
    """JAX's ``has_prev`` (a bool array) becomes a 0-d bool tensor through
    ``state_from_numpy``; a port state written by the port's checkpoint
    comes back equal, and JAX reads it with the same ``has_prev``; the
    graphed route (stand-in) continues it as the eager one does."""
    K, b, frames, params, _ = _case("intensity")
    jvo = JDeviceVO(K, b, (H_IMG, W_IMG), JParams(**KW))
    seen = set()
    for I, D in frames[:4]:
        jvo.add_frame(I, D)
        state = state_from_numpy(_jax_state_to_numpy(jvo.state), "cpu")
        assert state.has_prev.dtype == torch.bool and state.has_prev.dim() == 0
        assert bool(state.has_prev) == bool(jvo.state.has_prev)
        seen.add(bool(state.has_prev))
    assert seen == {False, True}
    tvo = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    for I, D in frames[:3]:
        tvo.add_frame(I, D)
    assert bool(tvo.state.has_prev)
    path = str(tmp_path / "state.npz")
    checkpoint.save_vo_state(path, tvo.state)
    back, _, _ = checkpoint.load_vo_state(path, device="cpu")
    for name, x, y in zip(dv.VOState._fields, back, tvo.state):
        for u, v in zip(graphs._leaves(x), graphs._leaves(y)):
            assert u.dtype == v.dtype and torch.equal(u, v), name
    jstate, _, _ = jcheckpoint.load_vo_state(path, jvo.state)
    assert bool(jstate.has_prev) is True
    assert np.asarray(jstate.has_prev).dtype == np.bool_
    eager = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    graphed = dv.DeviceVO(K, b, (H_IMG, W_IMG), params, device="cpu")
    graphed._graphs = ReplayStandIn("cpu")
    eager.state = back
    graphed.state = checkpoint.load_vo_state(path, device="cpu")[0]
    for I, D in frames[3:7]:
        _assert_outputs_equal(graphed.add_frame(I, D), eager.add_frame(I, D))
