"""CUDA graphs for the compiled step: the port's counterpart of ``jax.jit``
and, through IF and WHILE nodes, of ``jax.lax.cond`` and
``jax.lax.while_loop``.

JAX runs a ``DeviceVO`` step, ``VisualOdometry``'s pyramid, templates and
estimate, and each ``gn.run`` level, each as one compiled program.  Here a
function over tensors that stay at fixed addresses (its static buffers) is
captured once as a CUDA graph and replayed; inputs that change between
calls are copied into those buffers first.  ``GraphCache``
holds the graphs of one owner, keyed by a Python-static key (level, shapes,
options), as ``jax.jit`` keys its compiled programs by the static
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
function the cache captures, the branch is an IF node: the body runs on
the device only on replays whose ``pred`` is true, and copies its results
over ``into``, a structure of tensors at fixed addresses that holds the
other branch's values.  The warm-up runs a body that is not taken too, and
throws its result away, so a body's first-use work never happens inside a
capture.

``while_loop(pred_fn, body, carry)`` is the data-dependent loop.  Outside a
cache it is a host loop that reads ``pred_fn(carry)`` once per iteration
(with ``flag_fn``, a bool the body branches on, read in the same copy).
In a function the cache captures, it is a WHILE node: the body is captured
once, copies its results over ``carry`` (whose tensors it then owns) and
recomputes the predicate into a fixed bool that re-arms the node, so a
replay runs every iteration on the device with no host read.  A body may
return ``carry``'s own tensors, overwritten (no copy is then made).  The
warm-up runs the body at least once, even when the loop would run none (on
a copy of the carry, then), and warms every ``cond`` body in it.  The body
is captured into a memory pool of its own: a block the body frees (a
tensor from before the loop whose last reference the body drops) could
otherwise be handed to a temporary later in the same body, which the next
iteration would then read for that tensor.

The card's torch has no API for conditional nodes, so the code around a
branch or a loop is captured as separate torch graphs (segments, kept
un-instantiated) and ``csrc/graph_cond.cu`` joins them into one graph
(``_Joined``): each segment a child-graph node, each branch or loop a
one-thread kernel that copies its device predicate into a conditional
handle, then the IF or WHILE node.

The kernel wrappers count their launches in Python (``launch_count`` of each
``ops`` module), and a replay never enters them: the cache records how far
each count advanced during the capture, puts the counts back, and adds that
advance on every replay.  A launch captured inside a conditional body
counts only as often as the body runs: each body adds one to a device
counter of its own on each run (an IF body when taken, a WHILE body on
each iteration), and ``settle()`` reads every such counter in one
device-to-host read and adds each body's launches times its new runs.
The counters are sized by the bodies the warm-up ran, which bound those
the capture holds.  Read the counts after ``settle()``; so settled, they
equal those of running the function eagerly.  A key's first call counts
through the wrappers themselves (an untaken body's warm-up is not counted).
The capture holds ``ops._build.count_lock``, under which every wrapper
counts, so a launch counted by another thread (a data loader's stereo
matcher) waits until the capture is over and is not taken for the graph's.

Other counts advance the same way: a ``Count``, such as a
``parallel.collectives.Reducer``'s ``calls`` and ``bytes``, so a replay
adds a captured all-reduce's call and bytes, and ``settle()`` those of an
all-reduce in a conditional body times its runs.  The all-reduces the
graphed routes capture do no host work: in place on one nccl rank it adds
no node, and across the cards of one host (``parallel.peer``) it is one
kernel node.  A captured ``dist.all_reduce`` across cards would run on
ProcessGroupNCCL's stream of its own, joined to the capturing stream by
events, and NCCL adds an event wait and an event record node beside its
kernel (``scripts/nccl_graph_nodes.py``).  A conditional body holds
only kernel, memcpy, memset, empty, child-graph and conditional nodes;
``_Joined`` counts each body segment's node types (``node_types``) and
raises, naming the type, on any other (a host node, an event record or
wait node).

A ``Timer`` is a loop's own clock, named by its site (``gauss_newton.run``
times each level's solve as ``gn.run.L<level>``): torch.profiler records a
WHILE body's kernels once a replay, not once an iteration.  In a capture on
CUDA a timed WHILE body begins with a one-thread kernel that reads the
device's ``%globaltimer`` and ends with one that adds the elapsed
nanoseconds and one iteration to the timer's device counters (and one run
to the body's counter, in place of its own add); ``timed`` brackets a
block the same way (``run``'s first iteration, outside the loop).
``settle()`` reads those counters with the bodies' and adds them to the
timer's ``ns`` and ``launch_count`` (its iterations) and to the counters
``<name>.ns`` and ``<name>.iterations`` of ``utils.profiling``, which move
only there.  Run eagerly or on the CPU a timed loop counts its iterations
on the host and no time.

``GraphCache.jit(key, inputs, fn)`` is ``jax.jit`` for a function of
tensors: the inputs copied into static buffers of the key (those named by
``held`` only when another object arrives), ``fn`` of the buffers
replayed, copies of its outputs returned.  ``route(cache, device,
reducer, owned, opts)`` is the rule every graphed entry point shares: the
graphed route on CUDA with no reducer, a one-rank nccl group or an nccl
group that reduces over peer memory (``capturable``); the eager route for
a verbose level (a line printed per iteration reads the device), for
gloo (its host staging cannot be captured), for nccl groups over several
hosts, on the CPU unless a cache is given (the tests' stand-ins), when
asked (``cache=False``), and inside another cache's run (whose graph then
captures the call).

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
import weakref

import torch

from bpvo_tpu_torch.ops import _build
from bpvo_tpu_torch.utils import profiling

# graph replays made by every GraphCache in this process (read by
# scripts/profile_torch_vo.py, which counts a replay as one host op)
replay_count = 0

# the conditional bodies of every graph captured in this process:
# [(run counters, [(body's launches, settled runs)])], a body's counter at
# its index in the records
_bodies = []

# the cache running a function on this thread; its phase is "warm-up",
# "capture", or "rerun" (a CPU stand-in whose replay runs the function
# again: ``cond`` then reads ``pred`` on the host and copies the taken
# body's results)
_running = threading.local()


# the counts besides the ops modules' that replays advance (weak
# references: a dropped Reducer's counts leave the list)
_counters = []

# CUDA graph node types (cudaGraphNodeType), and those a conditional body
# may hold
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semaphore_signal",
              "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")
BODY_NODE_TYPES = frozenset(("kernel", "memcpy", "memset", "graph", "empty",
                             "conditional"))


def op_modules():
    """The modules whose wrappers count kernel launches: the ``ops``
    modules and ``parallel.peer``."""
    from bpvo_tpu_torch.ops import (census, census_cost, fused_linearize,
                                    gn_step, irls, level_gn, sgm)
    from bpvo_tpu_torch.parallel import peer
    return (census, census_cost, fused_linearize, gn_step, irls, level_gn,
            sgm, peer)


class Count:
    """A count besides the ``ops`` modules' launch counts, counted as they
    are: a replay adds its captured advance to ``launch_count``, and
    ``settle()`` a conditional body's times its runs (``Reducer``'s calls
    and bytes, ``ops.sgm.winner_count``)."""
    __slots__ = ("launch_count", "__weakref__")

    def __init__(self):
        self.launch_count = 0
        _counters.append(weakref.ref(self))


def counted():
    """The ``ops`` modules and every live registered counter."""
    live = [(r, r()) for r in _counters]
    _counters[:] = [r for r, o in live if o is not None]
    return op_modules() + tuple(o for _, o in live if o is not None)


# the process's timers by name (``timer``)
_timers = {}


class Timer(Count):
    """The iterations (``launch_count``) and device nanoseconds (``ns``)
    of a loop site, counted as a ``Count`` is and settled with the bodies'
    runs (see the module docstring).  ``_clocks``: a zeroed int64 (3,) per
    CUDA device, ``csrc/graph_cond.cu``'s clock (start stamp, ns,
    iterations), made outside any capture; ``_seen`` the clock's ns and
    iterations already settled; ``_pushed`` the ns and iterations already
    added to the profiling counters."""
    __slots__ = ("name", "ns", "_clocks", "_seen", "_pushed")

    def __init__(self, name: str):
        super().__init__()
        self.name, self.ns = name, 0
        self._clocks, self._seen, self._pushed = {}, {}, (0, 0)

    def clock(self, device):
        """The device's clock, made at first use (never in a capture)."""
        clock = self._clocks.get(device)
        if clock is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"graphs: timer {self.name} first used "
                                   f"on {device} inside a capture")
            clock = self._clocks[device] = torch.zeros(
                3, dtype=torch.int64, device=device)
            self._seen[device] = (0, 0)
        return clock

    def _launch(self, entry, device, *tensors):
        lib = _build.library()
        _build.launch(lib, "clock", getattr(lib, entry)(
            *(ctypes.c_void_p(0 if t is None else t.data_ptr())
              for t in (self.clock(device), *tensors)),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)))

    def start(self, device):
        """Launch the start stamp on the current stream of ``device``."""
        self._launch("bpvo_clock_start", device)

    def stop(self, device, runs=None):
        """Launch the stop: the elapsed ns and an iteration onto the
        clock, and a run onto ``runs`` (a one-element int64 view) if
        given."""
        self._launch("bpvo_clock_stop", device, runs)

    def tick(self):
        """One iteration counted on the host (an eager or warm-up run;
        not inside ``uncounted``)."""
        if not getattr(_running, "uncounted", 0):
            with _build.count_lock:
                self.launch_count += 1

    def _settle(self, device, ns: int, iterations: int):
        seen_ns, seen_it = self._seen[device]
        self.ns += ns - seen_ns
        self.launch_count += iterations - seen_it
        self._seen[device] = (ns, iterations)

    def _push(self):
        ns, it = self._pushed
        if self.ns != ns or self.launch_count != it:
            profiling.count(self.name + ".ns", self.ns - ns)
            profiling.count(self.name + ".iterations", self.launch_count - it)
            self._pushed = (self.ns, self.launch_count)


def timer(name: str) -> Timer:
    """The process's ``Timer`` of the site ``name`` (made at first use)."""
    t = _timers.get(name)
    if t is None:
        t = _timers[name] = Timer(name)
    return t


@contextlib.contextmanager
def timed(t, device):
    """The block as one iteration of the timer ``t`` (None: untimed):
    in a capture on CUDA between a start and a stop node; in a capture
    elsewhere (a CPU stand-in's) uncounted; otherwise counted on the
    host after it ran."""
    if t is None:
        yield
        return
    device = torch.device(device)
    capture = in_run() and _running.cache._phase == "capture"
    if device.type == "cuda":
        if capture:
            t.start(device)
            yield
            t.stop(device)
            return
        t.clock(device)       # made before the key's capture
    yield
    if not capture:
        t.tick()


def in_run():
    """Whether this thread is inside a ``GraphCache`` run (a warm-up, a
    capture or a stand-in's rerun)."""
    return getattr(_running, "cache", None) is not None


def capturable(reducer, device) -> bool:
    """Whether ``reducer``'s collectives on ``device`` can be captured in
    the graphed routes: no reducer, an nccl group of one rank, an nccl
    group that reduces over peer memory (``reducer.peer``: the cards of one
    host, ``parallel.peer.eligible``), or any on the CPU (where only a
    stand-in "captures").  Only kernel nodes go into the IF and WHILE
    bodies that hold the collectives: the peer all-reduce is one kernel
    launch, the one-rank nccl all-reduce adds no node.  gloo stages CUDA
    tensors through host memory.  ``dist.all_reduce`` across cards brings
    an event wait and an event record node beside its kernel (NCCL's graph
    mixing; measured at 2 and 4 ranks, scripts/nccl_graph_nodes.py), which
    the bodies cannot hold, so an nccl group over several hosts runs
    eagerly."""
    if reducer is None or torch.device(device).type != "cuda":
        return True
    return reducer.backend == "nccl" and (
        reducer.world == 1 or getattr(reducer, "peer", None) is not None)


def route(cache, device, reducer=None, owned=None, opts=()):
    """The ``GraphCache`` a graphed entry point runs through, or None for
    its eager route.  ``opts``: the level options (``GNOptions``) the
    graphed function runs; a verbose one prints a line per iteration, so
    reads the device, and takes the eager route.  ``cache``: False asks
    for the eager route; a cache is taken as given (a CPU stand-in in the
    tests); None means, on CUDA when ``capturable`` (the reducer's
    all-reduces are kernel launches or no node, which the graph's IF and
    WHILE bodies can hold), a cache of the caller's own (made in
    ``owned``, a dict the caller keeps, one a device) or without ``owned``
    the device's ``default_cache``, and the eager route otherwise.  Inside
    another cache's run the call is eager, and so part of that run's
    graph.  A choice made from the arguments alone: nothing falls back."""
    if cache is False or in_run() or any(o.verbose for o in opts):
        return None
    if cache is not None:
        return cache
    device = torch.device(device)
    if device.type != "cuda" or not capturable(reducer, device):
        return None
    if owned is None:
        return default_cache(device)
    if device not in owned:
        owned[device] = GraphCache(device)
    return owned[device]


# every GraphCache of the process (``release``)
_caches = weakref.WeakSet()


def release():
    """Destroy every CUDA graph the process's caches hold, after the
    device's work is done: NCCL keeps a communicator alive while a graph
    that captured one of its collectives exists, so a group is destroyed
    only after its graphs (``multihost.shutdown`` calls this).  Each
    key's next call captures anew."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for cache in list(_caches):
        cache.clear()
    _default_caches.clear()
    gc.collect()


# the process's caches of the functions graphed without an owner
# (bundle adjustment, the pose graph), one a device, as jax.jit's cache
_default_caches = {}


def default_cache(device):
    """This process's ``GraphCache`` on ``device`` for functions that have
    no owner to hold one: its graphs and buffers live as long as the
    process, as ``jax.jit``'s compiled programs do."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    cache = _default_caches.get(device)
    if cache is None:
        cache = _default_caches[device] = GraphCache(device)
    return cache


def clone(x):
    """A copy of a structure of tensors (tuples, lists, named tuples)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    items = [clone(item) for item in x]
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


@contextlib.contextmanager
def uncounted(mods=None):
    """Launches counted in the block (by the ``ops`` modules and the
    registered counters, or by ``mods``) are taken back after it: work
    that stands in for no real call (a warm-up on placeholder inputs, a
    body the warm-up does not take)."""
    with _build.count_lock:
        mods = counted() if mods is None else mods
        counts = [mod.launch_count for mod in mods]
        _running.uncounted = getattr(_running, "uncounted", 0) + 1
        try:
            yield
        finally:
            _running.uncounted -= 1
            for mod, n in zip(mods, counts):
                mod.launch_count = n


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in _leaves(item)]


def _replace_leaf(x, leaf):
    """``x`` with every occurrence of the tensor ``leaf`` but the first
    replaced by a copy of its own."""
    first = [True]

    def walk(y):
        if isinstance(y, torch.Tensor):
            if y is not leaf:
                return y
            keep, first[0] = first[0], False
            return y if keep else y.clone()
        items = [walk(i) for i in y]
        return type(y)(*items) if hasattr(y, "_fields") else type(y)(items)
    return walk(x)


def copy_into(dst, src):
    """Copy the tensors of ``src`` over those of ``dst`` (structures of the
    same shape); a leaf that is ``dst``'s own tensor is left alone, and one
    that is another of ``dst``'s tensors is copied out first, so that no
    copy reads a tensor an earlier one overwrote."""
    dsts = _leaves(dst)
    held = {id(d) for d in dsts}
    srcs = [s.clone() if id(s) in held and s is not d else s
            for d, s in zip(dsts, _leaves(src), strict=True)]
    for d, s in zip(dsts, srcs):
        if d is not s:
            if d.shape != s.shape or d.dtype != s.dtype:
                raise ValueError(f"copy_into: {s.dtype} {tuple(s.shape)} "
                                 f"over {d.dtype} {tuple(d.shape)}")
            d.copy_(s)


def _predicate(pred, who):
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"{who}: the predicate must be a 0-d bool tensor, "
                         f"got {pred.dtype} {tuple(pred.shape)}")
    return pred


def cond(pred, body, into):
    """``body()`` if the 0-d bool tensor ``pred`` is true, else ``into``
    (``jax.lax.cond`` with the false branch's values given).  ``body`` takes
    no arguments and returns a structure shaped as ``into``.

    Outside a ``GraphCache`` call: one host read of ``pred``.  In a function
    a cache runs: an IF node whose body copies ``body()``'s results over
    ``into``, which is returned (its tensors must be at fixed addresses:
    static buffers, or tensors the captured function computed)."""
    _predicate(pred, "cond")
    cache = getattr(_running, "cache", None)
    if cache is None:
        return body() if bool(pred) else into
    return cache._cond(pred, body, into)


def while_loop(pred_fn, body, carry, flag_fn=None, timer=None):
    """``jax.lax.while_loop``: ``carry = body(carry)`` while
    ``pred_fn(carry)`` (a 0-d bool tensor) is true; returns the last carry.
    ``body`` returns a structure shaped as ``carry``.  With ``flag_fn`` the
    body is ``body(carry, flag_fn(carry))``: ``flag_fn`` gives a 0-d bool
    tensor the body branches on (``cond``).  ``timer``: a ``Timer`` that
    counts the iterations and, in a graph on CUDA, times them.

    Outside a ``GraphCache`` call: a host loop, one read of the predicate
    per iteration (and one at the end); the flag is read in the same copy
    and passed to the body as a host bool.  In a function a cache runs: a
    WHILE node whose body copies ``body(carry)``'s results over ``carry``
    and returns it (the flag passed as the tensor); the loop then owns
    ``carry``'s tensors and overwrites them on every replay, so they must
    be tensors the captured function computed for the loop (not its
    inputs) or static buffers."""
    cache = getattr(_running, "cache", None)
    if cache is None:
        while True:
            go = _predicate(pred_fn(carry), "while_loop")
            if flag_fn is None:
                if not bool(go):
                    return carry
                carry = body(carry)
            else:
                go, flag = torch.stack(
                    [go, _predicate(flag_fn(carry), "while_loop")]).tolist()
                if not go:
                    return carry
                carry = body(carry, flag)
            if timer is not None:
                timer.tick()
    if flag_fn is not None:
        inner = body

        def body(c):
            return inner(c, flag_fn(c))
    return cache._while(pred_fn, body, carry, timer)


def settle():
    """Add the launches of the conditional bodies run since the last
    ``settle`` to the ``ops`` modules' counts, and the timers' device
    nanoseconds and iterations to theirs and to the profiling counters:
    one device-to-host read of every graph's counters and every timer's
    clock a device.  Call it before reading ``launch_count``."""
    with _build.count_lock:
        runs = {}
        clocks = [(t, dev, c) for t in _timers.values()
                  for dev, c in t._clocks.items()]
        devices = {c.device for c, _ in _bodies} | {d for _, d, _ in clocks}
        for dev in devices:                # one read a device
            idx = [i for i, (c, _) in enumerate(_bodies) if c.device == dev]
            mine = [(t, d, c) for t, d, c in clocks if c.device == dev]
            flat = torch.cat([_bodies[i][0][:len(_bodies[i][1])]
                              for i in idx]
                             + [c[1:] for _, _, c in mine]).tolist()
            for i in idx:
                n = len(_bodies[i][1])
                runs[i], flat = flat[:n], flat[n:]
            for k, (t, d, _) in enumerate(mine):
                t._settle(d, *flat[2 * k:2 * k + 2])
        for i, (_, records) in enumerate(_bodies):
            for j, (launches, settled) in enumerate(records):
                for mod, n in launches:
                    mod.launch_count += n * (runs[i][j] - settled)
                records[j] = (launches, runs[i][j])
        for t in _timers.values():
            t._push()


class _Joined:
    """The segments of one capture (torch CUDA graphs kept un-instantiated)
    joined into one graph by ``csrc/graph_cond.cu``: each segment a
    child-graph node, each IF body an IF node on its predicate, each WHILE
    body a WHILE node re-armed at the body's end from its predicate.
    ``items`` is the capture's sequence: ``("graph", CUDAGraph)``, ``("if",
    predicate, items)`` and ``("while", predicate, items)``; holding it
    keeps the segments' memory pools and the predicates alive.
    ``replay()`` launches the graph on the current stream and returns the
    static outputs.  ``node_types`` counts the captured nodes by type:
    ``"top"`` the segments outside any body, ``"if"`` and ``"while"``
    those in bodies (through child graphs); a body segment with a type a
    conditional body cannot hold raises, naming it."""

    def __init__(self, items, outputs, device):
        self.items, self.outputs, self.device = items, outputs, device
        self._lib = lib = _build.library()
        self.node_types = {"top": {}, "if": {}, "while": {}}
        self._graph, self._exec = ctypes.c_void_p(), ctypes.c_void_p()
        self._check(lib.bpvo_graph_create(ctypes.byref(self._graph)))
        self._append(self._graph, items, "top")
        self._check(lib.bpvo_graph_instantiate(ctypes.byref(self._exec),
                                               self._graph))

    def _check(self, rc):
        _build.launch(self._lib, "CUDA graph", rc)

    def _types(self, segment):
        """{type name: count} of a segment's nodes, through child graphs."""
        counts = (ctypes.c_longlong * len(NODE_TYPES))()
        self._check(self._lib.bpvo_graph_node_types(segment, counts,
                                                    len(NODE_TYPES)))
        return {name: n for name, n in zip(NODE_TYPES, counts) if n}

    def _append(self, graph, items, where):
        """Append ``items`` to ``graph`` as a chain (``where``: "top", or
        the kind of the body they fill); returns its last node (null when
        it added none)."""
        lib, tail = self._lib, ctypes.c_void_p()
        for kind, *rest in items:
            if kind == "graph":
                segment = ctypes.c_void_p(rest[0].raw_cuda_graph())
                types = self._types(segment)
                refused = sorted(set(types) - BODY_NODE_TYPES)
                if where != "top" and refused:
                    raise RuntimeError(
                        f"graphs: a segment of a {where.upper()} body holds "
                        f"{', '.join(refused)} node(s), which a conditional "
                        f"body cannot hold (its nodes: {types}); a "
                        f"collective or an op that adds them cannot run "
                        f"inside graphs.cond or graphs.while_loop")
                total = self.node_types[where]
                for name, n in types.items():
                    total[name] = total.get(name, 0) + n
                if types:
                    self._check(lib.bpvo_graph_append_child(
                        graph, ctypes.byref(tail), segment))
                continue
            pred, body_items = rest
            body, ptr = ctypes.c_void_p(), ctypes.c_void_p(pred.data_ptr())
            if kind == "if":
                self._check(lib.bpvo_graph_append_if(
                    graph, ctypes.byref(tail), ptr, ctypes.byref(body)))
                self._append(body, body_items, "if")
            else:
                handle = ctypes.c_ulonglong()
                self._check(lib.bpvo_graph_append_while(
                    graph, ctypes.byref(tail), ptr, ctypes.byref(body),
                    ctypes.byref(handle)))
                body_tail = self._append(body, body_items, "while")
                self._check(lib.bpvo_graph_append_set(
                    body, ctypes.byref(body_tail), handle, ptr))
        return tail

    def replay(self):
        stream = torch.cuda.current_stream(self.device).cuda_stream
        self._check(self._lib.bpvo_graph_launch(self._exec,
                                                ctypes.c_void_p(stream)))
        return self.outputs

    def close(self):
        """Destroy the joined graph and drop the segments (their torch
        graphs are destroyed when collected).  Uses no module global, so
        that it also runs at interpreter exit, after ``ctypes`` is gone
        (a graph a module-level object held)."""
        if self._exec:
            self._lib.bpvo_graph_exec_destroy(self._exec)
            self._exec = None
        if self._graph:
            self._lib.bpvo_graph_destroy(self._graph)
            self._graph = None
        self.items = self.outputs = None

    def __del__(self):
        self.close()


class _Body:
    """A conditional body being captured: the counts when it began, and
    the launches of the bodies nested in it."""

    def __init__(self, before):
        self.before, self.nested = before, [0] * len(before)


class GraphCache:
    """CUDA graphs keyed by a Python-static key, each in its own memory
    pool, all captured on one stream of ``device``.  ``cache(key, fn)`` runs
    ``fn()`` (a function of no arguments over static buffers, returning
    tensors or tuples of them) through the key's graph."""

    def __init__(self, device, modules=None):
        _caches.add(self)
        self.device = torch.device(device)
        self._modules = modules
        # the counts of the call in progress (``counted()`` at its start)
        self._counted = None
        self._entries = {}
        # the static buffers of ``jit``, by key
        self._inputs = {}
        self._stream = None
        self._phase = None
        # conditional bodies the warm-up ran (the size of the counters)
        self._n_bodies = 0
        # the capture in progress: its memory pools (the innermost WHILE
        # body's last), the segment being captured, the sequences being
        # filled (``_Joined``'s items; the innermost last), the bodies'
        # device counters and launches, and the bodies being captured
        self._pools = self._segment = self._items = None
        self._taken = self._records = self._stack = None

    def __len__(self):
        return len(self._entries)

    def clear(self):
        """Destroy every graph of this cache (and its ``jit`` buffers); a
        key's next call captures it again."""
        for captured, _ in self._entries.values():
            if hasattr(captured, "close"):
                captured.close()
        self._entries.clear()
        self._inputs.clear()

    def __contains__(self, key):
        return key in self._entries

    def node_types(self):
        """The node types of every graph of this cache, summed:
        {"top": {type: count}, "if": ..., "while": ...}
        (``_Joined.node_types``)."""
        out = {"top": {}, "if": {}, "while": {}}
        for captured, _ in self._entries.values():
            for where, types in captured.node_types.items():
                for name, n in types.items():
                    out[where][name] = out[where].get(name, 0) + n
        return out

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

    def jit(self, key, inputs, fn, held=()):
        """``fn(buffers)`` through the graph of ``key`` (``jax.jit`` of a
        function of tensors): ``inputs`` (a structure of tensors) copied
        into static buffers of ``key`` and the shapes and dtypes of its
        tensors (made at the key's first call), ``fn`` run or replayed on
        them; returns copies of its outputs, which the next replay would
        overwrite.  ``held``: positions of items of ``inputs`` (a tuple)
        copied in only when the item is another object than the one the
        key's buffers hold (a keyframe's templates, passed again on every
        frame until the next keyframe); the key keeps that object.  Spans
        (``utils.profiling``): ``graph.key``, ``graph.copy_in``,
        ``graph.replay`` (a key's first call: its warm-up and capture) and
        ``graph.copy_out``."""
        with profiling.annotate("graph.key"):
            key = (key, tuple((tuple(t.shape), t.dtype) for t in
                              _leaves(inputs)))
        with profiling.annotate("graph.copy_in"):
            entry = self._inputs.get(key)
            if entry is None:
                bufs = clone(inputs)
            elif not held:
                bufs = entry[0]
                copy_into(bufs, inputs)
            else:
                bufs, srcs = entry
                fresh = [i for i, item in enumerate(inputs)
                         if item is not srcs.get(i)]
                copy_into([bufs[i] for i in fresh],
                          [inputs[i] for i in fresh])
            self._inputs[key] = (bufs, {i: inputs[i] for i in held})
        with profiling.annotate("graph.replay"):
            out = self(key, lambda: fn(bufs))
        with profiling.annotate("graph.copy_out"):
            return clone(out)

    def _mods(self):
        if self._modules is not None:
            return self._modules
        return self._counted if self._counted is not None else counted()

    @contextlib.contextmanager
    def _running(self, phase):
        outer = getattr(_running, "cache", None), self._phase
        _running.cache, self._phase = self, phase
        try:
            yield
        finally:
            _running.cache, self._phase = outer

    def _first_call(self, key, fn):
        self._counted = None
        self._counted = mods = self._mods()
        try:
            return self._warm_up_and_capture(key, fn, mods)
        finally:
            self._counted = None

    def _warm_up_and_capture(self, key, fn, mods):
        self._n_bodies = 0
        with self._running("warm-up"):
            out = self._warm_up(fn)
        with _build.count_lock:
            before = [mod.launch_count for mod in mods]
            self._taken = torch.zeros(max(self._n_bodies, 1),
                                      dtype=torch.int64, device=self.device)
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
            self._capture_body("if", pred, lambda: copy_into(into, body()))
            return into
        if self._phase == "warm-up":
            self._n_bodies += 1
        if bool(pred):
            copy_into(into, body())
        elif self._phase == "warm-up":
            self._discard(body)
        return into

    def _while(self, pred_fn, body, carry, timer=None):
        """``while_loop`` in a function this cache runs (see
        ``while_loop``)."""
        if self._phase == "capture":
            return self._capture_while(pred_fn, body, carry, timer)
        ran = self._phase != "warm-up"
        if not ran:
            self._n_bodies += 1
        if timer is not None and self.device.type == "cuda":
            timer.clock(self.device)     # made before the capture
        while bool(_predicate(pred_fn(carry), "while_loop")):
            carry, ran = body(carry), True
            if timer is not None:
                timer.tick()
        if not ran:
            # warm the body the loop did not run, on a copy of the carry (a
            # body may overwrite its carry: ``ops.gn_step``)
            self._discard(lambda: body(clone(carry)))
        return carry

    def _discard(self, fn):
        """Run ``fn`` (a body the warm-up does not take); its result and
        its launches are thrown away."""
        with uncounted(self._mods()):
            fn()

    def _capture_while(self, pred_fn, body, carry, timer=None):
        seen = set()
        for t in _leaves(carry):    # a tensor held twice: one buffer each
            if id(t) in seen:
                carry = _replace_leaf(carry, t)
            seen.add(id(t))
        pred = _predicate(pred_fn(carry), "while_loop")
        if any(pred is t for t in _leaves(carry)):
            pred = pred.clone()

        def iteration():
            copy_into(carry, body(carry))
            pred.copy_(_predicate(pred_fn(carry), "while_loop"))
        self._capture_body("while", pred, iteration, timer)
        return carry

    def _capture_body(self, kind, pred, fill, timer=None):
        """Capture ``fill()`` as the body of an IF or WHILE node on
        ``pred``, counting its launches per run of the body; on CUDA
        ``timer``'s start and stop nodes around it (the stop counts the
        body's run)."""
        slot = len(self._records)
        if slot == len(self._taken):
            raise RuntimeError(f"graphs: the capture holds more conditional "
                               f"bodies than the warm-up ran ({slot})")
        mods = self._mods()
        frame = _Body([mod.launch_count for mod in mods])
        self._records.append(None)
        self._stack.append(frame)
        node = self._if_node if kind == "if" else self._while_node
        clocked = timer is not None and self.device.type == "cuda"
        with node(pred):
            if clocked:
                timer.start(self.device)
            fill()
            if clocked:
                timer.stop(self.device, self._taken[slot])
            else:
                self._taken[slot].add_(1)
        self._stack.pop()
        advanced = [mod.launch_count - n for mod, n in zip(mods, frame.before)]
        self._records[slot] = [(mod, a - nested) for mod, a, nested in
                               zip(mods, advanced, frame.nested)
                               if a - nested]
        outer = self._stack[-1]
        outer.nested = [x + a for x, a in zip(outer.nested, advanced)]

    def _if_node(self, pred):
        """Capture what the block launches into an IF body on ``pred``."""
        return self._node("if", pred, None)

    def _while_node(self, pred):
        """Capture what the block launches into a WHILE body on ``pred``, in
        a memory pool of its own."""
        return self._node("while", pred, torch.cuda.graph_pool_handle())

    @contextlib.contextmanager
    def _node(self, kind, pred, pool):
        """The segment before the block ends, the block is segments of its
        own (in ``pool``, if given), and a new segment begins after it."""
        self._end_segment()
        items = []
        self._items[-1].append((kind, pred, items))
        self._items.append(items)
        if pool is not None:
            self._pools.append(pool)
        self._begin_segment()
        try:
            yield
        finally:
            self._end_segment()
            self._items.pop()
            if pool is not None:
                self._pools.pop()
            self._begin_segment()

    def _begin_segment(self):
        self._segment = torch.cuda.CUDAGraph(keep_graph=True)
        self._segment.capture_begin(pool=self._pools[-1],
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
        self._pools, self._items = [torch.cuda.graph_pool_handle()], [[]]
        try:
            with torch.cuda.stream(self._side_stream()):
                self._begin_segment()
                try:
                    outputs = fn()
                finally:
                    self._end_segment()
            return _Joined(self._items[0], outputs, self.device)
        finally:
            self._pools = self._segment = self._items = None


class _Rerun:
    """``RerunCache``'s stand-in for a captured graph: each replay runs the
    function again (a ``cond`` body only when its predicate is true) and
    copies its results into the outputs of the first replay."""

    def __init__(self, fn, cache):
        self.fn, self.cache, self.outputs = fn, cache, None
        self.held = ((cache._modules or op_modules()) if cache.hold_counts
                     else ())

    def replay(self):
        counts = [m.launch_count for m in self.held]
        with self.cache._running("rerun"):
            new = self.fn()
        for m, n in zip(self.held, counts):
            m.launch_count = n
        if self.outputs is None:
            self.outputs = new
        else:
            for dst, src in zip(_leaves(self.outputs), _leaves(new)):
                dst.copy_(src)
        return self.outputs


class RerunCache(GraphCache):
    """A ``GraphCache`` that captures nothing, for the CPU: the first call
    runs the function (the warm-up), and each "replay" runs it again
    (``cond`` and ``while_loop`` then read their predicates on the host)
    into the outputs of the first replay, the static outputs a graph
    overwrites.  It rehearses a graphed route's buffers, copies and
    branches where no CUDA graph runs, collectives included (every rank
    must take the same branches).  Launches and collectives count as the
    reruns make them, so the counts equal an eager run's; with
    ``hold_counts`` (a class attribute) a rerun's launches are not counted,
    as a replay that enters no wrapper."""
    hold_counts = False

    def _warm_up(self, fn):
        return fn()

    def _capture(self, fn):
        return _Rerun(fn, self)
