"""CUDA graphs for the compiled step: the port's counterpart of ``jax.jit``
and, through IF nodes, of ``jax.lax.cond``.

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

``cond(pred, body, into)`` is the data-dependent branch.  Outside a cache it
reads ``pred`` on the host and returns ``body()`` or ``into``.  In a
function the cache runs, the branch is a CUDA graph IF node
(``CUDAGraph.begin_capture_to_if_node``): the body runs on the device only
on replays whose ``pred`` is true, and copies its results over ``into``, a
structure of tensors at fixed addresses that holds the other branch's
values.  The warm-up runs a body that is not taken too, and throws its
result away, so a body's first-use work never happens inside a capture.  A
torch without IF nodes raises.

The kernel wrappers count their launches in Python (``launch_count`` of each
``ops`` module), and a replay never enters them: the cache records how far
each count advanced during the capture, puts the counts back, and adds that
advance on every replay.  A launch captured inside an IF body counts only
on the replays that took the body: the body adds one to a device counter
of its own, and ``settle()`` reads every such counter in one
device-to-host read and adds the bodies' launches for the replays that
took them.  Read the counts after ``settle()``; so settled, they equal
those of running the function eagerly.  A key's first call counts through
the wrappers themselves (an untaken body's warm-up is not counted).
The capture holds ``ops._build.count_lock``, under which every wrapper
counts, so a launch counted by another thread (a data loader's stereo
matcher) waits until the capture is over and is not taken for the graph's.

Captures run in CUDA's thread-local mode: another thread may go on
allocating, copying and launching on its own streams while this one
captures (a loader thread prefetching frames and running a matcher); only
this thread's calls are held to what a capture allows.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import threading
import warnings

import torch

from bpvo_tpu_torch.ops import _build

# graph replays made by every GraphCache in this process (read by
# scripts/profile_torch_vo.py, which counts a replay as one host op)
replay_count = 0

# IF bodies a graph may hold (the size of its device counters)
MAX_BODIES = 16

# the IF bodies of every graph captured in this process whose launches are
# not all settled: [(taken counters, [(body's launches, settled takes)])]
_bodies = []

# the cache running a function on this thread; its phase is "warm-up",
# "capture", or "rerun" (a CPU stand-in whose replay runs the function
# again: ``cond`` then reads ``pred`` on the host and copies the taken
# body's results)
_running = threading.local()


def op_modules():
    """The ``ops`` modules whose wrappers count kernel launches."""
    from bpvo_tpu_torch.ops import census, fused_linearize, irls, level_gn, sgm
    return (census, fused_linearize, irls, level_gn, sgm)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in _leaves(item)]


def copy_into(dst, src):
    """Copy the tensors of ``src`` over those of ``dst`` (structures of the
    same shape); a leaf that is ``dst``'s own tensor is left alone."""
    for d, s in zip(_leaves(dst), _leaves(src), strict=True):
        if d is not s:
            if d.shape != s.shape or d.dtype != s.dtype:
                raise ValueError(f"copy_into: {s.dtype} {tuple(s.shape)} "
                                 f"over {d.dtype} {tuple(d.shape)}")
            d.copy_(s)


def cond(pred, body, into):
    """``body()`` if the 0-d bool tensor ``pred`` is true, else ``into``
    (``jax.lax.cond`` with the false branch's values given).  ``body`` takes
    no arguments and returns a structure shaped as ``into``.

    Outside a ``GraphCache`` call: one host read of ``pred``.  In a function
    a cache runs: an IF node whose body copies ``body()``'s results over
    ``into``, which is returned (its tensors must be at fixed addresses:
    static buffers, or tensors the captured function computed)."""
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"cond: the predicate must be a 0-d bool tensor, "
                         f"got {pred.dtype} {tuple(pred.shape)}")
    cache = getattr(_running, "cache", None)
    if cache is None:
        return body() if bool(pred) else into
    return cache._cond(pred, body, into)


def settle():
    """Add the launches of the IF bodies taken since the last ``settle``
    to the ``ops`` modules' counts: one device-to-host read of every
    graph's counters.  Call it before reading ``launch_count``."""
    with _build.count_lock:
        taken = {}
        for dev in {c.device for c, _ in _bodies}:   # one read a device
            idx = [i for i, (c, _) in enumerate(_bodies) if c.device == dev]
            rows = torch.stack([_bodies[i][0] for i in idx]).tolist()
            taken.update(zip(idx, rows))
        for i, (_, records) in enumerate(_bodies):
            for j, (launches, settled) in enumerate(records):
                for mod, n in launches:
                    mod.launch_count += n * (taken[i][j] - settled)
                records[j] = (launches, taken[i][j])


class _Joined:
    """The segments of one capture (torch CUDA graphs kept un-instantiated)
    joined into one graph by ``csrc/graph_cond.cu``: each segment a
    child-graph node, each IF body an IF node on its predicate.  ``items``
    is the capture's sequence: ``("graph", CUDAGraph)`` and ``("if",
    predicate, items)``; holding it keeps the segments' memory pool and
    the predicates alive.  ``replay()`` launches the graph on the current
    stream and returns the static outputs."""

    def __init__(self, items, outputs, device):
        self.items, self.outputs, self.device = items, outputs, device
        self._lib = lib = _build.library()
        self._graph, self._exec = ctypes.c_void_p(), ctypes.c_void_p()
        self._check(lib.bpvo_graph_create(ctypes.byref(self._graph)))
        self._append(self._graph, items)
        self._check(lib.bpvo_graph_instantiate(ctypes.byref(self._exec),
                                               self._graph))

    def _check(self, rc):
        _build.launch(self._lib, "CUDA graph", rc)

    def _append(self, graph, items):
        lib, tail = self._lib, ctypes.c_void_p()
        for kind, *rest in items:
            if kind == "graph":
                segment = ctypes.c_void_p(rest[0].raw_cuda_graph())
                n = ctypes.c_longlong()
                self._check(lib.bpvo_graph_num_nodes(segment,
                                                     ctypes.byref(n)))
                if n.value:
                    self._check(lib.bpvo_graph_append_child(
                        graph, ctypes.byref(tail), segment))
            else:
                pred, body_items = rest
                body = ctypes.c_void_p()
                self._check(lib.bpvo_graph_append_if(
                    graph, ctypes.byref(tail), ctypes.c_void_p(
                        pred.data_ptr()), ctypes.byref(body)))
                self._append(body, body_items)

    def replay(self):
        stream = torch.cuda.current_stream(self.device).cuda_stream
        self._check(self._lib.bpvo_graph_launch(self._exec,
                                                ctypes.c_void_p(stream)))
        return self.outputs

    def __del__(self):
        if self._exec:
            self._lib.bpvo_graph_exec_destroy(self._exec)
        if self._graph:
            self._lib.bpvo_graph_destroy(self._graph)


class _Body:
    """An IF body being captured: the counts when it began, and the
    launches of the bodies nested in it."""

    def __init__(self, before):
        self.before, self.nested = before, [0] * len(before)


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
        self._phase = None
        # the capture in progress: its memory pool, the segment being
        # captured, the sequences being filled (``_Joined``'s items; the
        # innermost last), the IF bodies' device counters and launches,
        # and the IF bodies being captured
        self._pool = self._segment = self._items = None
        self._taken = self._records = self._stack = None

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

    def _mods(self):
        return self._modules if self._modules is not None else op_modules()

    @contextlib.contextmanager
    def _running(self, phase):
        outer = getattr(_running, "cache", None), self._phase
        _running.cache, self._phase = self, phase
        try:
            yield
        finally:
            _running.cache, self._phase = outer

    def _first_call(self, key, fn):
        mods = self._mods()
        with self._running("warm-up"):
            out = self._warm_up(fn)
        with _build.count_lock:
            before = [mod.launch_count for mod in mods]
            self._taken = torch.zeros(MAX_BODIES, dtype=torch.int64,
                                      device=self.device)
            self._records, self._stack = [], [_Body(before)]
            try:
                with self._running("capture"):
                    captured = self._capture(fn)
            finally:
                advanced = [mod.launch_count - n - nested for mod, n, nested
                            in zip(mods, before, self._stack[0].nested)]
                for mod, n in zip(mods, before):
                    mod.launch_count = n
                records, taken = self._records, self._taken
                self._taken = self._records = self._stack = None
            if records:
                _bodies.append((taken, [(rec, 0) for rec in records]))
        self._entries[key] = (captured, [(mod, n) for mod, n in
                                         zip(mods, advanced) if n])
        return out

    def _cond(self, pred, body, into):
        """``cond`` in a function this cache runs (see ``cond``)."""
        if self._phase == "capture":
            return self._capture_if(pred, body, into)
        take = bool(pred)
        if take:
            copy_into(into, body())
        elif self._phase == "warm-up":
            # warm the body that is not taken; its result and its launches
            # are thrown away
            with _build.count_lock:
                counts = [mod.launch_count for mod in self._mods()]
                try:
                    body()
                finally:
                    for mod, n in zip(self._mods(), counts):
                        mod.launch_count = n
        return into

    def _capture_if(self, pred, body, into):
        slot = len(self._records)
        if slot == MAX_BODIES:
            raise RuntimeError(f"cond: more than {MAX_BODIES} IF bodies in "
                               f"one graph")
        mods = self._mods()
        frame = _Body([mod.launch_count for mod in mods])
        self._records.append(None)
        self._stack.append(frame)
        with self._if_node(pred):
            copy_into(into, body())
            self._taken[slot].add_(1)
        self._stack.pop()
        advanced = [mod.launch_count - n for mod, n in zip(mods, frame.before)]
        self._records[slot] = [(mod, a - nested) for mod, a, nested in
                               zip(mods, advanced, frame.nested)
                               if a - nested]
        outer = self._stack[-1]
        outer.nested = [x + a for x, a in zip(outer.nested, advanced)]
        return into

    @contextlib.contextmanager
    def _if_node(self, pred):
        """Capture what the block issues into an IF body on ``pred``: the
        segment before it ends, the body is segments of its own, and a new
        segment begins after it."""
        self._end_segment()
        items = []
        self._items[-1].append(("if", pred, items))
        self._items.append(items)
        self._begin_segment()
        try:
            yield
        finally:
            self._end_segment()
            self._items.pop()
            self._begin_segment()

    def _begin_segment(self):
        self._segment = torch.cuda.CUDAGraph(keep_graph=True)
        self._segment.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")

    def _end_segment(self):
        segment, self._segment = self._segment, None
        with warnings.catch_warnings():    # a segment may be empty
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            segment.capture_end()
        self._items[-1].append(("graph", segment))

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
        outputs (``_Joined``); raises if the capture fails, or if this
        torch cannot keep a captured graph un-instantiated."""
        if not hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"):
            raise RuntimeError(
                f"torch {torch.__version__} cannot keep a captured CUDA "
                f"graph (CUDAGraph(keep_graph=True).raw_cuda_graph), which "
                f"the graphed routes join into one graph")
        # as torch.cuda.graph does before a capture
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        self._pool, self._items = torch.cuda.graph_pool_handle(), [[]]
        try:
            with torch.cuda.stream(self._side_stream()):
                self._begin_segment()
                try:
                    outputs = fn()
                finally:
                    self._end_segment()
            return _Joined(self._items[0], outputs, self.device)
        finally:
            self._pool = self._segment = self._items = None
