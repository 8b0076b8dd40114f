"""The distributed layer on the card: the gloo ``Reducer``'s host staging
of CUDA tensors, the sharded GN with a world-1 nccl or gloo group bit for
bit the no-reducer route (its kernels launched, ``level_gn`` never), and
two gloo ranks on one card in the dry run, bitwise equal; CUBIC and
CUBIC_HERMITE sampling on the gather route on the card, against the CPU.  Marked ``gpu``:
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
