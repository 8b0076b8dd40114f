"""The peer all-reduce of the distributed layer (``parallel/peer.py``,
``csrc/peer_reduce.cu``) on the CPU, where the kernel cannot run:

- its plain version, the fold of the ranks' tensors in rank order, bit for
  bit numpy's sequential fold for every op, dtype and size the layer
  reduces (``dryrun.COLLECTIVE_SIZES``) at 2 and 4 ranks, a NaN kept by
  the max; ``loopback_reduce`` on a CPU tensor is that fold for every rank;
- the wrapper's refusals: an op or dtype the layer does not reduce, a
  buffer over the slot capacity;
- the static rule (``eligible``, ``attach``) and ``graphs.capturable`` /
  ``route`` for nccl at one rank, nccl over the cards of one host, nccl
  over several hosts and gloo, with stand-in groups as
  tests/test_torch_sharded_graphs.py uses them;
- ``multihost.launch`` of 4 gloo ranks whose reducer folds through the
  plain version (tests/torch_peer_rank.py): the sharded GN, eager and
  through ``graphs.RerunCache``, every rank bitwise equal, within 5e-4 of
  JAX's ``make_sharded_gn`` on a 4-device mesh of conftest's virtual
  devices.

The kernel itself runs on the card: ``chip_smoke.py``'s peer phase (its
loopback launch against this plain version) and, across cards, the dry
run (``python -m bpvo_tpu_torch.parallel.dryrun --backend nccl``)."""
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpvo_tpu.parallel import sharded as jsh
from bpvo_tpu.solver import gauss_newton as jgn
from bpvo_tpu.types import LossFunctionType as JLoss
from bpvo_tpu_torch.parallel import dryrun, multihost, peer
from bpvo_tpu_torch.utils import graphs
from test_gn import build_template, render_pair
from test_torch_multiprocess import _cam, _json, _template_arrays

ATOL = 5e-4
TIMEOUT_S = 300
HERE = os.path.dirname(os.path.abspath(__file__))
SIZES = sorted(dryrun.COLLECTIVE_SIZES.items())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Ranks and folds of small ops: one torch thread keeps the suite's
    workers from waiting on each other's spinning thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(world, n, dtype, seed):
    r = np.random.default_rng(seed)
    if dtype == torch.float32:
        return (r.standard_normal((world, n)) * 100).astype(np.float32)
    return r.integers(-2 ** 20, 2 ** 20, (world, n)).astype(
        np.int32 if dtype == torch.int32 else np.int64)


def _numpy_fold(x, op):
    acc = x[0].copy()
    for v in x[1:]:
        acc = acc + v if op == "sum" else np.where(
            np.isnan(acc) | (acc > v), acc, v)
    return acc


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,spec", SIZES, ids=[n for n, _ in SIZES])
def test_plain_fold_is_numpys_rank_order_fold(world, name, spec):
    n, dtype, op = spec
    x = _inputs(world, n, dtype, seed=world * 100 + n)
    if op == "max":
        x[1, 0] = np.nan
    want = _numpy_fold(x, op)
    got = peer.plain_fold(list(torch.from_numpy(x)), op)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    rows = peer.loopback_reduce(torch.from_numpy(x), op)
    np.testing.assert_array_equal(rows.numpy(), np.broadcast_to(want,
                                                                x.shape))


def test_fold_order_is_rank_order():
    """An f32 sum whose value depends on the order: the fold's is rank
    order's, (1e8 + 1) - 1e8 = 0 where 1e8 - 1e8 + 1 = 1."""
    x = torch.tensor([[1e8], [1.0], [-1e8]], dtype=torch.float32)
    assert peer.plain_fold(list(x), "sum").item() == 0.0
    assert peer.plain_fold(list(x[[0, 2, 1]]), "sum").item() == 1.0


def test_wrapper_refuses():
    with pytest.raises(ValueError, match="slot capacity"):
        peer._codes(torch.zeros(peer.SLOT_BYTES // 4 + 1), "sum", "t")
    with pytest.raises(ValueError, match="not a reduction"):
        peer._codes(torch.zeros(4, dtype=torch.int32), "max", "t")
    with pytest.raises(ValueError, match="not a reduction"):
        peer._codes(torch.zeros(4, dtype=torch.float64), "sum", "t")
    assert peer._codes(torch.zeros(peer.SLOT_BYTES // 8,
                                   dtype=torch.int64), "sum", "t") == (0, 2)
    with pytest.raises(ValueError):
        peer.plain_fold([torch.zeros(1)], "min")


def _infos(world, host=lambda r: "h", device=lambda r: r, access=True):
    return [peer.RankInfo(host(r), device(r), tuple(
        access if q != r else True for q in range(world)))
        for r in range(world)]


def test_eligible():
    assert peer.eligible(_infos(2))[0]
    assert peer.eligible(_infos(4))[0]
    assert peer.eligible(_infos(8))[0]
    for infos, why in (
            (_infos(1), "one rank"),
            (_infos(9), "9 ranks"),
            (_infos(4, host=lambda r: f"h{r // 2}"), "several hosts"),
            (_infos(2, device=lambda r: 0), "not cuda:<rank>"),
            (_infos(2, device=lambda r: 1 - r), "not cuda:<rank>"),
            (_infos(4, access=False), "peer access")):
        ok, reason = peer.eligible(infos)
        assert not ok and why in reason, reason


def _group(backend, world, infos=None):
    return types.SimpleNamespace(backend=backend, world=world, rank=0,
                                 group=None, infos=infos)


def test_attach_applies_the_rule(monkeypatch):
    """``attach``: no gather for gloo or one rank; for nccl the gathered
    infos decide; a qualifying group gets a ``PeerReduce`` (a stand-in
    here: the CPU has no card to allocate on)."""
    made, gathers = [], []

    def gather(out, obj, group=None):
        gathers.append(obj)
        out[:] = infos[:len(out)]
    monkeypatch.setattr(peer.dist, "all_gather_object", gather)
    monkeypatch.setattr(peer.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(peer.torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(peer.torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    monkeypatch.setattr(peer, "PeerReduce",
                        lambda *a: made.append(a) or "peer")
    infos = _infos(4)
    for backend, world in (("gloo", 4), ("nccl", 1)):
        red = _group(backend, world)
        assert peer.attach(red) is None and "not a multi-card" in \
            red.peer_rule
    assert not gathers
    red = _group("nccl", 4)
    assert peer.attach(red) == "peer" and made[-1][1:3] == (0, 4)
    assert gathers[-1] == peer.RankInfo(peer.socket.gethostname(), 0,
                                        (True,) * 4)
    infos = _infos(4, host=lambda r: f"h{r // 2}")
    red = _group("nccl", 4)
    assert peer.attach(red) is None and "several hosts" in red.peer_rule
    assert len(made) == 1


def test_capturable_and_route_by_group():
    """The graphed route on CUDA for nccl at one rank and for nccl over
    the cards of one host (a reducer with ``peer``); eager for nccl over
    several hosts (no ``peer``) and for gloo; any on the CPU."""
    cuda = torch.device("cuda", 0)
    one = types.SimpleNamespace(backend="nccl", world=1, peer=None)
    cards = types.SimpleNamespace(backend="nccl", world=4, peer=object())
    hosts = types.SimpleNamespace(backend="nccl", world=4, peer=None)
    gloo = types.SimpleNamespace(backend="gloo", world=2, peer=None)
    owned = {}
    for red in (one, cards):
        assert graphs.capturable(red, cuda)
        assert isinstance(graphs.route(None, cuda, red, owned),
                          graphs.GraphCache)
    for red in (hosts, gloo):
        assert not graphs.capturable(red, cuda)
        assert graphs.route(None, cuda, red, owned) is None
        assert graphs.capturable(red, "cpu")
    assert graphs.route(False, cuda, cards, owned) is None
    assert peer in graphs.op_modules()


def test_four_rank_sharded_gn_through_the_plain_fold(tmp_path, monkeypatch):
    """4 gloo ranks on the CPU whose reducer takes the peer route through
    the plain version (tests/torch_peer_rank.py): the sharded GN, eager
    and through ``graphs.RerunCache``, bitwise equal on every rank and
    between the routes, within 5e-4 of JAX's ``make_sharded_gn`` on a
    4-device mesh; every all-reduce went through the fold."""
    I0, I1, D, cam, _ = render_pair(
        [0.001, -0.002, 0.001, 0.01, -0.005, 0.015])
    tdata, _ = build_template(I0, D, cam, capacity=2048)
    opts = jgn.GNOptions(loss=JLoss.HUBER, function_tolerance=1e-4,
                         parameter_tolerance=1e-6)
    mesh = jsh.make_mesh(4)
    st = jsh.make_sharded_gn(mesh, opts)(jsh.shard_template(tdata, mesh),
                                         jnp.asarray(I1)[None], cam,
                                         jnp.eye(4))
    inp = str(tmp_path / "in.npz")
    np.savez(inp, **_template_arrays(tdata),
             channels=np.asarray(I1, np.float32)[None], cam=_cam(cam),
             opts=_json(opts), T_init=np.eye(4, dtype=np.float32))
    monkeypatch.setenv("PYTHONPATH", HERE)
    done = multihost.launch("torch_peer_rank", [
        "--mode", "gn", "--inp", inp, "--out", str(tmp_path), "--backend",
        "gloo", "--device", "cpu", "--threads", "1", "--rerun"], 4,
        TIMEOUT_S)
    folds = []
    for r, d in enumerate(done):
        assert d.returncode == 0, f"rank {r}: {d.returncode}\n" \
                                  f"{d.stdout[-3000:]}"
        assert f"WORKER_OK mode=gn rank={r} world=4" in d.stdout
        folds.append(int(d.stdout.split("PLAIN_FOLDS ")[1].split()[0]))
    outs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    calls = int(outs[0]["collective_calls"])
    assert calls > 0 and folds == [folds[0]] * 4
    assert folds[0] >= calls + int(outs[0]["rerun_collective_calls"])
    for o in outs:
        for k in o:
            if not k.endswith("weights"):
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
        for k in ("T", "num_iters", "weights", "collective_calls",
                  "collective_bytes"):
            np.testing.assert_array_equal(o["rerun_" + k], o[k], err_msg=k)
    np.testing.assert_allclose(outs[0]["T"], np.asarray(st.T), atol=ATOL)
    assert abs(int(outs[0]["num_iters"]) - int(st.num_iters)) <= 1
    assert [o["weights"].shape for o in outs] == [(1, 512)] * 4
