"""The port's pose graph (``bpvo_tpu_torch.parallel.pose_graph``) against
the JAX package's on tests/test_pose_graph.py's three cases, on the CPU:
poses at atol 1e-4, and each case's own check."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpvo_tpu.core import se3 as jse3
from bpvo_tpu.parallel import pose_graph as jpg
from bpvo_tpu_torch.parallel import pose_graph as pg
from bpvo_tpu_torch.utils import convert
from test_pose_graph import make_chain

STEP = [0.01, 0, 0.005, 0.1, 0, 0.2]


def _twist_err(a, b):
    return np.abs(np.asarray(jse3.log(jnp.asarray(
        a @ np.linalg.inv(b), jnp.float32)))).max()


def _perturbed(gt):
    r = np.random.default_rng(1)
    init = [gt[0]]
    for T in gt[1:]:
        tw = (0.05 * r.standard_normal(6)).astype(np.float32)
        init.append((np.asarray(jse3.exp(jnp.asarray(tw))) @ T).astype(
            np.float32))
    return init


def _graphs(graph_cls, opts=None, **kw):
    """The loop-closure case of test_pose_graph.py, built in ``graph_cls``:
    drifted odometry and one exact closure; returns (graph, gt)."""
    n = 8
    gt, meas = make_chain(n, [0, 0, 0, 0.2, 0, 0])
    bias = np.asarray(jse3.exp(jnp.asarray([0, 0, 0.01, 0.005, 0, 0],
                                           jnp.float32)))
    graph = graph_cls(**({} if opts is None else {"opts": opts}), **kw)
    T = np.eye(4, dtype=np.float32)
    graph.add_node(T)
    for k, Z in enumerate(meas):
        Z = (bias @ Z).astype(np.float32)
        T = (np.linalg.inv(Z) @ T).astype(np.float32)
        graph.add_node(T)
        graph.add_edge(k, k + 1, Z)
    graph.add_edge(0, n - 1, (gt[0] @ np.linalg.inv(gt[-1])).astype(
        np.float32), 1e4 * np.eye(6, dtype=np.float32))
    return graph, gt


@pytest.mark.parametrize("case", ["perfect_chain", "perturbed_nodes",
                                  "loop_closure"])
def test_optimize_matches_jax(case):
    if case == "loop_closure":
        jg, gt = _graphs(jpg.PoseGraph)
        tg, _ = _graphs(pg.PoseGraph, device="cpu")
        drift_before = _twist_err(tg._poses[-1], gt[-1])
        pj, pt = jg.optimize(), tg.optimize()
        assert isinstance(pt, np.ndarray)
        # the closure pulls the last node back (test_pose_graph.py's bound)
        assert _twist_err(pt[-1], gt[-1]) < 0.15 * drift_before
    else:
        gt, meas = make_chain(6, STEP)
        init = gt if case == "perfect_chain" else _perturbed(gt)
        args = (np.stack(init), pg.sequential_edges(6), np.stack(meas),
                np.stack([np.eye(6)] * 5))
        pj, cj = jpg.optimize(*args)
        pt, ct = pg.optimize(*args, device="cpu")
        pj, pt = np.asarray(pj), pt.numpy()
        bound = 1e-6 if case == "perfect_chain" else 2e-3
        assert max(_twist_err(a, b) for a, b in zip(pt, gt)) < bound
        if case == "perfect_chain":
            assert float(ct) < 1e-6 and float(cj) < 1e-6
    np.testing.assert_allclose(pt, pj, atol=1e-4)


def test_sequential_edges_and_options():
    np.testing.assert_array_equal(pg.sequential_edges(5),
                                  jpg.sequential_edges(5))
    jopts = jpg.PoseGraphOptions(max_iterations=3, damping=1e-3,
                                 gauge_prior=1e6)
    assert convert.pose_graph_options_from_jax(jopts) == pg.PoseGraphOptions(
        3, 1e-3, 1e6)


def test_max_iterations_from_options_match_jax():
    """A graph optimized with 2 iterations from JAX's options, converted:
    the same poses as JAX's at atol 1e-4 (and not yet at the optimum)."""
    jopts = jpg.PoseGraphOptions(max_iterations=2)
    jg, gt = _graphs(jpg.PoseGraph, jopts)
    tg, _ = _graphs(pg.PoseGraph, convert.pose_graph_options_from_jax(jopts),
                    device="cpu")
    np.testing.assert_allclose(tg.optimize(), jg.optimize(), atol=1e-4)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.PoseGraph()
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.optimize(np.eye(4)[None], np.zeros((0, 2)), np.zeros((0, 4, 4)),
                    np.zeros((0, 6, 6)))
