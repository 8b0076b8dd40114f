"""The distributed layer on the card: the gloo ``Reducer``'s host staging
of CUDA tensors, the sharded GN with a world-1 nccl or gloo group bit for
bit the no-reducer route (its kernels launched, ``level_gn`` never), and
two gloo ranks on one card in the dry run, bitwise equal; CUBIC and
CUBIC_HERMITE sampling on the gather route on the card, against the CPU;
the peer all-reduce kernel's loopback launch bit for bit its plain version
and, with two cards, the dry run on the peer route.  Marked ``gpu``:
without a CUDA device they skip (the decision is made in a fixture).  On a
machine with an NVIDIA GPU (no JAX needed):

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA device" \\
        -m gpu tests/test_torch_parallel_gpu.py
"""
import pytest
import torch

from bpvo_tpu_torch.ops import fused_linearize, irls, level_gn
from bpvo_tpu_torch.parallel import dryrun, multihost, sharded
from bpvo_tpu_torch.solver import gauss_newton as gn
from bpvo_tpu_torch.types import InterpolationType
from bpvo_tpu_torch.utils import graphs
from bpvo_tpu_torch.vo import device_vo
from bpvo_tpu_torch.vo.template_data import TemplateData


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the nccl group, the staged gloo "
                    "path and the kernels run only on the GPU")
    return torch.device("cuda", 0)


def _group(backend, dev):
    return multihost.initialize(
        backend, 1, 0, f"tcp://127.0.0.1:{multihost.free_port()}",
        device=dev if backend == "nccl" else None)


@pytest.mark.gpu
def test_gloo_reducer_stages_cuda_tensors(cuda):
    red = _group("gloo", None)
    try:
        H = torch.randn(6, 6, device=cuda)
        n = torch.arange(5, dtype=torch.int32, device=cuda)
        Hs, = red.sum(H)
        ns, = red.sum(n)
        m = red.max(torch.tensor(1.5, device=cuda))
        assert Hs.device == cuda and torch.equal(Hs, H)
        assert torch.equal(ns, n) and float(m) == 1.5
        assert red.stats() == {"calls": 3, "bytes": 36 * 4 + 5 * 4 + 4}
    finally:
        multihost.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_sharded_gn_world_one_equals_no_reducer(cuda, backend):
    tdata, ch, cam, _ = dryrun.synthetic_problem(240, 320, 8192,
                                                 device=cuda)
    opts = gn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6)
    T0 = torch.eye(4, device=cuda)
    want = sharded.make_sharded_gn(None, opts)(tdata, ch, cam, T0)
    red = _group(backend, cuda)
    try:
        counts = (fused_linearize.launch_count, irls.launch_count,
                  level_gn.launch_count)
        got = sharded.make_sharded_gn(red, opts)(tdata, ch, cam, T0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert fused_linearize.launch_count > counts[0]
        assert irls.launch_count > counts[1]
        assert level_gn.launch_count == counts[2]
        assert red.calls >= int(got.num_iters)
    finally:
        multihost.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("interp", [InterpolationType.CUBIC,
                                    InterpolationType.CUBIC_HERMITE])
def test_sharded_gn_gather_route_on_the_card(cuda, interp):
    """CUBIC and CUBIC_HERMITE levels take the gather route on the card
    (``fused_linearize`` never launches): a world-1 gloo group bit for bit
    the no-reducer route, both within 5e-4 of the CPU's plain run."""
    tdata, ch, cam, _ = dryrun.synthetic_problem(240, 320, 8192,
                                                 device=cuda)
    opts = gn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6,
                        interp=interp)
    T0 = torch.eye(4, device=cuda)
    n_fused = fused_linearize.launch_count
    want = sharded.make_sharded_gn(None, opts)(tdata, ch, cam, T0)
    assert fused_linearize.launch_count == n_fused
    cpu = sharded.make_sharded_gn(None, opts)(
        TemplateData(*(t.cpu() for t in tdata)), ch.cpu(), cam, T0.cpu())
    torch.testing.assert_close(want.T.cpu(), cpu.T, rtol=0, atol=5e-4)
    red = _group("gloo", None)
    try:
        got = sharded.make_sharded_gn(red, opts)(tdata, ch, cam, T0)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert red.calls >= int(got.num_iters)
    finally:
        multihost.shutdown()


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card(cuda):
    res = dryrun.run(2, "gloo", "cuda", 96, 128, timeout_s=300)
    assert res["ok"], res
    assert res["ranks_bitwise_equal"] and res["staged"]


# ---------------------------------------------------------------------------
# the graphed routes (one CUDA-graph replay a call, the all-reduces captured)
# ---------------------------------------------------------------------------

def _counts(red=None):
    graphs.settle()
    out = {m.__name__.rsplit(".", 1)[-1]: m.launch_count
           for m in graphs.op_modules()}
    if red is not None:
        out.update(red.stats())
    return out


def _delta(before, red=None):
    return {k: v - before[k] for k, v in _counts(red).items()}


def _same(a, b):
    leaves = [(x, y) for x, y in zip(graphs._leaves(a), graphs._leaves(b))]
    return len(leaves) == len(graphs._leaves(a)) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in leaves)


@pytest.fixture(scope="module")
def nccl1(cuda):
    red = _group("nccl", cuda)
    yield red
    multihost.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("reduced", [True, False])
def test_sharded_gn_graphed_equals_eager(nccl1, reduced):
    """``make_sharded_gn`` on a world-1 nccl group (and with no reducer):
    the first call (warm-up and capture) and two replays, each one replay
    with no device read, equal the eager route bit for bit, with the same
    collective calls and bytes and kernel launches once settled; the
    WHILE and IF bodies hold only node types a body may hold."""
    cuda = torch.device("cuda", 0)
    red = nccl1 if reduced else None
    tdata, ch, cam, _ = dryrun.synthetic_problem(240, 320, 8192,
                                                 device=cuda)
    opts = gn.GNOptions(function_tolerance=1e-4, parameter_tolerance=1e-6)
    T0 = torch.eye(4, device=cuda)
    before = _counts(nccl1)
    want = sharded.make_sharded_gn(red, opts, cache=False)(tdata, ch, cam, T0)
    n_eager = _delta(before, nccl1)
    run = sharded.make_sharded_gn(red, opts)
    first = run(tdata, ch, cam, T0)
    assert _same(first, want)
    for _ in range(2):
        before = _counts(nccl1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run(tdata, ch, cam, T0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert _same(got, want)
        assert _delta(before, nccl1) == n_eager
    assert n_eager["fused_linearize"] > 0 and n_eager["level_gn"] == 0
    assert (n_eager["calls"] >= int(want.num_iters)) == reduced


@pytest.mark.gpu
@pytest.mark.parametrize("descriptor", ["INTENSITY", "BITPLANES"])
def test_sharded_vo_graphed_equals_eager(nccl1, descriptor):
    """``make_sharded_vo`` on a world-1 nccl group at 120x160 over 1+6
    frames: ``step_fn`` (one replay a step) and ``scan_fn`` chunks of 1, 2
    and 3 (one copy in, no device read) equal the eager step bit for bit
    (poses, iterations, keyframes), with the same collectives and launches
    once settled."""
    from bpvo_tpu_torch import AlgorithmParameters, DescriptorType
    from bpvo_tpu_torch.data import synthetic
    from bpvo_tpu_torch.parallel import sharded_vo
    cuda = torch.device("cuda", 0)
    K, b, frames = synthetic.synthesize_sequence(7, 120, 160)
    images = torch.stack([torch.as_tensor(f[0]) for f in frames]).to(cuda)
    disps = torch.stack([torch.as_tensor(f[1]) for f in frames]).to(cuda)
    p = AlgorithmParameters(**dryrun.DRYRUN_PARAMS,
                            descriptor=DescriptorType[descriptor])

    def run(cache, chunks):
        init_fn, step_fn, scan_fn = sharded_vo.make_sharded_vo(
            nccl1, K, b, (120, 160), p, device=cuda, cache=cache)
        state = init_fn(images[0], disps[0])
        before = _counts(nccl1)
        outs, at = [], 1
        for n in chunks:
            if n == 0:
                state, out = step_fn(state, images[at], disps[at])
                out = device_vo.VOStepOutput(*(t[None] for t in out))
                n = 1
            else:
                torch.cuda.set_sync_debug_mode(
                    "error" if cache is None else 0)
                try:
                    state, out = scan_fn(state, images[at:at + n],
                                         disps[at:at + n])
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            outs.append(out)
            at += n
        return (device_vo.VOStepOutput(*(torch.cat(f) for f in zip(*outs))),
                _delta(before, nccl1))

    want, n_eager = run(False, (0, 0, 0, 0, 0, 0))
    for chunks in ((0, 0, 0, 0, 0, 0), (0, 1, 2, 3)):
        got, n_graphed = run(None, chunks)
        assert _same(got, want), chunks
        assert n_graphed == n_eager, (chunks, n_graphed, n_eager)
    assert bool(want.is_keyframe.any()) and n_eager["calls"] > 0


@pytest.mark.gpu
def test_ba_and_pose_graph_graphed_equal_eager(nccl1):
    """``ba_solve``, ``ba_solve_with_depth``, ``make_sharded_ba`` and
    ``make_sharded_ba_2d`` on a world-1 nccl group, ``KeyframeWindow``'s
    optimize and the pose graph: each call one replay with no device read,
    bit for bit the eager route, the same collectives and launches."""
    from bpvo_tpu_torch.core import se3
    from bpvo_tpu_torch.parallel import bundle_adjustment as ba
    from bpvo_tpu_torch.parallel import pose_graph
    cuda = torch.device("cuda", 0)
    tdata, ch, cam, _ = dryrun.synthetic_problem(96, 128, 2048, device=cuda)
    M = 3
    window = ba.stack_templates([tdata] * M)
    chans = torch.stack([ch] * M)
    g = torch.Generator().manual_seed(0)
    poses = se3.exp(0.002 * torch.randn(M, 6, generator=g)).to(cuda)
    opts = ba.BAOptions(max_iterations=3)
    depth = opts._replace(refine_depth=True)
    layout = multihost.RankLayout(1, 1)
    edges = torch.tensor([[0, 1], [1, 2], [0, 2]], device=cuda)
    meas = se3.exp(0.01 * torch.randn(3, 6, generator=g)).to(cuda)
    info = torch.eye(6).expand(3, 6, 6).to(cuda)
    cases = {
        "ba_solve": lambda c: ba.ba_solve(window, chans, cam, poses, opts,
                                          cache=c),
        "ba_solve_with_depth": lambda c: ba.ba_solve_with_depth(
            window, chans, cam, poses, depth, cache=c),
        "make_sharded_ba": lambda c: ba.make_sharded_ba(
            nccl1, opts, M, cache=c)(window, chans, cam, poses),
        "make_sharded_ba_2d": lambda c: ba.make_sharded_ba_2d(
            nccl1, opts, M, layout, cache=c)(window, chans, cam, poses),
        "pose_graph": lambda c: pose_graph.optimize(
            poses, edges, meas, info, device=cuda, cache=c)}
    for name, fn in cases.items():
        before = _counts(nccl1)
        want = fn(False)
        n_eager = _delta(before, nccl1)
        assert _same(fn(None), want), name          # warm-up and capture
        before = _counts(nccl1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(None)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert _same(got, want), name
        assert _delta(before, nccl1) == n_eager, name
    win = ba.KeyframeWindow(M, cam, opts, device=cuda)
    ref = ba.KeyframeWindow(M, cam, opts, device=cuda, cache=False)
    for i in range(M):
        for w in (win, ref):
            w.push(ba.TemplateData(*(x[i] for x in window)), chans[i],
                   poses[i].cpu().numpy())
    for _ in range(2):
        assert (win.optimize() == ref.optimize()).all()


@pytest.mark.gpu
def test_gloo_reduce_in_a_capture_raises(nccl1):
    """A gloo all-reduce of a CUDA tensor cannot be captured: inside a
    capture it raises, naming the backend; the graphed routes keep gloo
    eager (``graphs.route``)."""
    import torch.distributed as dist
    from bpvo_tpu_torch.parallel import collectives
    cuda = torch.device("cuda", 0)
    red = collectives.Reducer(dist.new_group(backend="gloo"))
    assert red.backend == "gloo" and graphs.route(None, cuda, red) is None
    x = torch.ones(4, device=cuda)
    cache = graphs.GraphCache(cuda)
    with pytest.raises(RuntimeError, match="gloo"):
        cache("k", lambda: red.sum(x)[0] * 2)
    assert "k" not in cache


@pytest.mark.gpu
@pytest.mark.parametrize("world", [2, 4, 8])
def test_peer_reduce_loopback_equals_plain(cuda, world):
    """``csrc/peer_reduce.cu`` through its loopback launch (W CTAs, CTA r
    rank r) bit for bit its plain version at every size the layer
    reduces, eagerly and in a replayed CUDA graph on fresh inputs; every
    rank's device epoch counts the launches."""
    from bpvo_tpu_torch.parallel import peer
    arena = peer.Loopback(world, cuda)
    gen = torch.Generator().manual_seed(world)
    made = 0
    for n, dtype, op in dryrun.COLLECTIVE_SIZES.values():
        def fresh():
            if dtype == torch.float32:
                return torch.randn(world, n, generator=gen).to(cuda)
            return torch.randint(-1000, 1000, (world, n), generator=gen,
                                 dtype=dtype).to(cuda)
        x = fresh()
        want = peer.plain_fold(x.unbind(0), op)
        assert torch.equal(peer.loopback_reduce(x, op, arena),
                           want.expand_as(x))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = peer.loopback_reduce(x, op, arena)
        for _ in range(2):
            x.copy_(fresh())
            graph.replay()
            assert torch.equal(out, peer.plain_fold(x.unbind(0), op)
                               .expand_as(x))
        made += 3
    torch.cuda.synchronize()
    epochs = arena.arena.view(world, -1)[:, 128:132].contiguous().view(
        torch.int32)
    assert epochs.view(-1).tolist() == [made] * world


@pytest.mark.gpu
def test_peer_route_across_cards(cuda):
    """Two nccl ranks on two cards reduce through the peer kernel and take
    the graphed route: the dry run's checks at 96x128 (graphed bitwise
    eager on every rank, the ranks bitwise equal, kernel, memcpy and
    memset nodes only in the bodies; every path launching the kernel on
    every rank; the kernel bit for bit its plain version across the
    cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices of one host")
    res = dryrun.run(2, "nccl", "cuda", 96, 128, timeout_s=300,
                     descriptors=("intensity",), rounds=1)
    assert res["ok"], res
    assert res["route"] == "peer" and res["graphed"]
    assert min(min(v) for v in res["peer_launches_by_path"].values()) > 0
    assert res["collectives_bitwise_plain"]
