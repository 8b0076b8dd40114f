"""CUDA graphs for the compiled step: the port's counterpart of ``jax.jit``.

JAX runs a ``DeviceVO`` step, and each ``gn.run`` level, as one compiled
program.  Here a function over tensors that stay at fixed addresses (its
static buffers) is captured once as a CUDA graph and replayed; inputs that
change between calls are copied into those buffers first.  ``GraphCache``
holds the graphs of one owner, keyed by a Python-static key (level, shapes,
branch flags), as ``jax.jit`` keys its compiled programs by the static
arguments.

The first call of a key runs the function once on the cache's own stream
(the warm-up: cuBLAS handles, the kernels' library and ticket counters,
``level_gn``'s launch attributes, cached constants) and returns that run's
result, then captures the function into a graph with a private memory
pool of its own: graphs that shared a pool could place one graph's outputs
where another keeps its intermediates, and a step reads the outputs of the
graph before it.  Every later call of the key replays the graph and
returns the captured outputs, which the next replay of the same key
overwrites.  A
capture or replay that fails raises: nothing falls back to running the
function eagerly.

The kernel wrappers count their launches in Python (``launch_count`` of each
``ops`` module), and a replay never enters them: the cache records how far
each count advanced during the capture, puts the counts back, and adds that
advance on every replay.  A key's first call counts through the wrappers
themselves, so the counts equal those of running the function eagerly.
The capture holds ``ops._build.count_lock``, under which every wrapper
counts, so a launch counted by another thread (a data loader's stereo
matcher) waits until the capture is over and is not taken for the graph's.

Captures run in CUDA's thread-local mode: another thread may go on
allocating, copying and launching on its own streams while this one
captures (a loader thread prefetching frames and running a matcher); only
this thread's calls are held to what a capture allows.
"""
from __future__ import annotations

import torch

from bpvo_tpu_torch.ops import _build

# graph replays made by every GraphCache in this process (read by
# scripts/profile_torch_vo.py, which counts a replay as one host op)
replay_count = 0


def op_modules():
    """The ``ops`` modules whose wrappers count kernel launches."""
    from bpvo_tpu_torch.ops import census, fused_linearize, irls, level_gn, sgm
    return (census, fused_linearize, irls, level_gn, sgm)


class _Captured:
    """A captured CUDA graph and its static outputs."""

    def __init__(self, graph, outputs):
        self.graph, self.outputs = graph, outputs

    def replay(self):
        self.graph.replay()
        return self.outputs


class GraphCache:
    """CUDA graphs keyed by a Python-static key, each in its own memory
    pool, all captured on one stream of ``device``.  ``cache(key, fn)`` runs
    ``fn()`` (a function of no arguments over static buffers, returning
    tensors or tuples of them) through the key's graph."""

    def __init__(self, device, modules=None):
        self.device = torch.device(device)
        self._modules = modules
        self._entries = {}
        self._stream = None

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        return key in self._entries

    def __call__(self, key, fn):
        global replay_count
        entry = self._entries.get(key)
        if entry is None:
            return self._first_call(key, fn)
        captured, launches = entry
        out = captured.replay()
        replay_count += 1
        with _build.count_lock:
            for mod, n in launches:
                mod.launch_count += n
        return out

    def _first_call(self, key, fn):
        mods = self._modules if self._modules is not None else op_modules()
        out = self._warm_up(fn)
        with _build.count_lock:
            before = [mod.launch_count for mod in mods]
            try:
                captured = self._capture(fn)
            finally:
                advanced = [mod.launch_count - n
                            for mod, n in zip(mods, before)]
                for mod, n in zip(mods, before):
                    mod.launch_count = n
        self._entries[key] = (captured, [(mod, n) for mod, n in
                                         zip(mods, advanced) if n])
        return out

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _warm_up(self, fn):
        """One run of ``fn`` on the cache's stream, ordered after the work
        queued so far and before the work queued after it."""
        stream = self._side_stream()
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn()
        current.wait_stream(stream)
        return out

    def _capture(self, fn):
        """``fn`` captured on the cache's stream into a new private pool, as
        an object whose ``replay()`` runs the graph and returns its static
        outputs; raises if the capture fails."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._side_stream(),
                              capture_error_mode="thread_local"):
            outputs = fn()
        return _Captured(graph, outputs)
