"""Device-side control flow for the captured engine loop (PyTorch port).

JAX compiles the device engine's whole run into one program: a
``lax.while_loop`` whose body selects branches with ``lax.cond`` and
``lax.switch`` on device values.  Eager PyTorch takes a branch only on
the host, after reading the predicate back.  This module gives the port
one spelling for such a branch that three runtimes read differently:

* **the eager loop** (no step context): :func:`when` reads the predicate
  with :func:`host_read` (one counted sync, ``COUNTS["host_syncs"]``),
  as every ``if host_read(...)`` of the queue did;
* **a CUDA graph capture** (:class:`CaptureContext`): :func:`when` opens
  an IF node on the 0-d bool predicate (and :func:`select` a SWITCH node
  on an int32, ``csrc/graph_cond.cu``) and captures each body into the
  node's body graph, so a replay takes the branch on the device and the
  host reads nothing;
* **the captured loop's CPU run** (:class:`EmulateContext`): the same
  step function, with :func:`when` reading the CPU predicate
  (``COUNTS["cond_reads"]``, not ``host_syncs``), each handler call
  refusing a host read (:func:`call_handler`) as a capture would.

Usage::

    with when(pred) as taken:
        if taken:
            ...                        # the body

    q = cond(pred, fn, q)             # lax.cond(pred, fn, identity, q)
    q = if_else(pred, f, g, q)        # lax.cond(pred, f, g, q)
    q = select(i, [f, g, h], q)       # lax.switch(i, [f, g, h], q)

Under capture ``taken`` is always True (the body is recorded) and a
body's results must not escape it: a value made inside runs only when
the node runs.  :func:`cond`, :func:`if_else` and :func:`select`
therefore write a body's results into the carry they were given
(``copy_``, leaf by leaf, skipping leaves the body returned as they
were) and return that carry, where the eager and emulated forms return
the body's new carry; both give the same values.  So a carry's leaves must be distinct tensors that
nothing else reads for their old values afterwards, as the engine's
queue, state and stats are.

Counting under capture: :func:`bump` (a rare path's ``COUNTS`` entry)
adds one to a device counter, and every body adds one to its own
execution counter; :meth:`CaptureContext.fold` adds them to ``COUNTS``
and the kernels' ``LAUNCHES`` (each body's launches, recorded while it
was captured, times the body's executions) at a chunk's end, from the
chunk's one host read.

Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import sys

import torch

# Rare-path firings and device-to-host reads, by name.  Plain counters:
# callers reset them (``COUNTS.clear()``) around the run they measure.
# ``repro_torch.core.queue`` re-exports this object.
COUNTS: collections.Counter = collections.Counter()

# The kernel modules whose ``LAUNCHES`` a capture accounts for (those
# imported when it runs: a module never imported launched nothing).
_KERNEL_MODULES = tuple(f"repro_torch.kernels.{name}" for name in (
    "queue_front", "flash_attention", "decode_attention", "rwkv6_scan",
    "mamba_scan"))

# Device counters a capture can hold (bodies plus bumped names), and the
# nesting depth of conditional nodes it can capture (one body stream a
# level).
MAX_SLOTS = 4096
MAX_DEPTH = 16

# ``torch.cuda.graph``'s capture_error_mode -> cudaStreamCaptureMode, the
# mode a capture's conditional bodies are captured in too.
CAPTURE_MODES = {"global": 0, "thread_local": 1, "relaxed": 2}


class CaptureError(RuntimeError):
    """A step could not be captured (or, on the CPU, would not be)."""


def host_read(t: torch.Tensor):
    """Read a 0-d tensor to the host (one counted device sync)."""
    COUNTS["host_syncs"] += 1
    return t.item()


def host_list(t: torch.Tensor) -> list:
    """Read a small 1-d tensor to the host (one counted device sync)."""
    COUNTS["host_syncs"] += 1
    return t.tolist()


# The step context of the running loop: None (the eager loop), an
# EmulateContext or a CaptureContext.
_STEP = None


def capturing() -> bool:
    """True while a :class:`CaptureContext` records a step."""
    return isinstance(_STEP, CaptureContext)


def in_step() -> bool:
    """True inside a captured-loop step (captured or emulated)."""
    return _STEP is not None


@contextlib.contextmanager
def when(pred: torch.Tensor):
    """Run the body where the 0-d bool ``pred`` holds: yields whether
    the caller should run it (see the module docstring)."""
    ctx = _STEP
    if ctx is None:
        yield bool(host_read(pred))
    elif isinstance(ctx, CaptureContext):
        with ctx.if_node(pred):
            yield True
    else:
        yield ctx.read(pred)


def bump(name: str) -> None:
    """Count one firing of the path ``name`` (``COUNTS[name]``)."""
    ctx = _STEP
    if isinstance(ctx, CaptureContext):
        ctx.bump(name)
    else:
        COUNTS[name] += 1


def write_back(dst, src) -> None:
    """Copy every leaf of ``src`` into the matching leaf of ``dst`` (the
    same structure: dicts by key, sequences by position) that is not the
    very same tensor."""
    if isinstance(dst, dict):
        if not isinstance(src, dict) or dst.keys() != src.keys():
            raise CaptureError("a captured body changed its carry's keys")
        for k in dst:
            write_back(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(dst) != len(src):
            raise CaptureError("a captured body changed its carry's shape")
        for a, b in zip(dst, src):
            write_back(a, b)
    elif dst is not src:
        if not (torch.is_tensor(dst) and torch.is_tensor(src)):
            raise CaptureError(
                f"a captured body returned {type(src).__name__} for a "
                f"{type(dst).__name__} leaf; every carry leaf must be a "
                "tensor")
        dst.copy_(src)


def signature(tree):
    """What a captured graph is specialised to: the tree's structure and
    each leaf's shape and dtype."""
    if isinstance(tree, dict):
        return tuple((k, signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(signature(v) for v in tree)
    if torch.is_tensor(tree):
        return (tuple(tree.shape), tree.dtype)
    return (type(tree).__name__,)


def cond(pred: torch.Tensor, fn, carry):
    """``fn(carry)`` where ``pred`` holds, else ``carry``: JAX's
    ``lax.cond(pred, fn, lambda c: c, carry)``."""
    with when(pred) as taken:
        if taken:
            out = fn(carry)
            if not capturing():
                return out
            write_back(carry, out)
    return carry


def if_else(pred: torch.Tensor, fn_true, fn_false, carry):
    """``fn_true(carry)`` where ``pred`` holds, else ``fn_false(carry)``:
    one read on the host, two IF nodes (``pred``, ``~pred``) in a graph."""
    if not capturing():
        with when(pred) as taken:
            return fn_true(carry) if taken else fn_false(carry)
    other = torch.logical_not(pred)
    carry = cond(pred, fn_true, carry)
    return cond(other, fn_false, carry)


def select(index: torch.Tensor, branches, carry):
    """``branches[index](carry)``, or ``carry`` where the 0-d integer
    ``index`` lies outside ``[0, len(branches))``: JAX's ``lax.switch``
    (which clamps the index instead; callers pass an index in range
    unless they mean "no branch").  One read on the host, one SWITCH
    node in a graph."""
    ctx = _STEP
    n = len(branches)
    if not isinstance(ctx, CaptureContext):
        i = int(host_read(index) if ctx is None else ctx.read(index))
        return branches[i](carry) if 0 <= i < n else carry
    for graph, fn in zip(ctx.node(index, n), branches):
        with ctx.body(graph):
            write_back(carry, fn(carry))
    return carry


# ---------------------------------------------------------------------------
# The CPU form: the captured loop's step, its predicates read on the host
# ---------------------------------------------------------------------------

class _NoHostRead:
    """Refuse the operations a capture refuses, while a step runs in its
    CPU form: a read of a value to the host (``.item()``, ``bool()``, an
    index by a 0-d tensor) and data-dependent output shapes.  The
    context's own predicate reads pass (``allow``)."""

    _REFUSED = ("_local_scalar_dense", "nonzero", "masked_select",
                "repeat_interleave", "unique", "_unique", "_unique2",
                "unique_consecutive", "unique_dim")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        refused = self._REFUSED
        owner = self
        self.allow = False

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.overloadpacket.__name__
                if name in refused and not owner.allow:
                    raise CaptureError(
                        f"aten.{name} reads the device on the host or "
                        "makes a data-dependent shape")
                return func(*args, **(kwargs or {}))

        self.mode = Mode()


class EmulateContext:
    """The captured loop's step run eagerly: predicates read on the host
    (``COUNTS["cond_reads"]``), everything else kept to what a capture
    takes (:class:`_NoHostRead`)."""

    def __init__(self):
        self.guard = _NoHostRead()

    def read(self, t: torch.Tensor):
        COUNTS["cond_reads"] += 1
        self.guard.allow = True
        try:
            return t.item()
        finally:
            self.guard.allow = False


@contextlib.contextmanager
def step_context(ctx):
    """Make ``ctx`` the step context for the duration (not reentrant);
    a CPU-form context also refuses host reads for the duration."""
    global _STEP
    if _STEP is not None:
        raise CaptureError("a captured-loop step is already running")
    _STEP = ctx
    try:
        if isinstance(ctx, EmulateContext):
            with ctx.guard.mode:
                yield ctx
        else:
            yield ctx
    finally:
        _STEP = None


def call_handler(name: str, fn, *args):
    """A handler call inside a step: under capture an error names the
    handler; in the CPU form a host read in the handler raises
    :class:`CaptureError` naming it, as the capture would."""
    ctx = _STEP
    if ctx is None:
        return fn(*args)
    try:
        return fn(*args)
    except CaptureError as err:
        raise CaptureError(
            f"handler {name!r} cannot run in a captured step: {err}"
        ) from err
    except Exception as err:
        if isinstance(ctx, CaptureContext):
            raise CaptureError(
                f"handler {name!r} cannot be captured in a CUDA graph: "
                f"{type(err).__name__}: {err}") from err
        raise


# ---------------------------------------------------------------------------
# The CUDA form: conditional nodes, device counters, launch accounting
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        import ctypes

        from repro_torch.kernels._build import load

        lib = load("graph_cond")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.graph_cond_init.argtypes = [i]
        lib.graph_cond_begin.argtypes = [p, p, i, ctypes.POINTER(p)]
        lib.graph_body_begin.argtypes = [p, p, i]
        lib.graph_body_end.argtypes = [p]
        lib.graph_stream_create.argtypes = [ctypes.POINTER(p)]
        lib.graph_stream_destroy.argtypes = [p]
        for fn in (lib.graph_cond_init, lib.graph_cond_begin,
                   lib.graph_body_begin, lib.graph_body_end,
                   lib.graph_stream_create, lib.graph_stream_destroy):
            fn.restype = i
        _LIB = lib
    return _LIB


def launch_totals() -> dict:
    """Every imported kernel module's ``LAUNCHES``, flat."""
    out = {}
    for mod_name in _KERNEL_MODULES:
        mod = sys.modules.get(mod_name)
        if mod is not None:
            for k, v in mod.LAUNCHES.items():
                out[(mod_name, k)] = v
    return out


def set_launches(totals: dict) -> None:
    """Put back what :func:`launch_totals` returned."""
    for (mod_name, k), v in totals.items():
        sys.modules[mod_name].LAUNCHES[k] = v


class CaptureContext:
    """Records one step into a CUDA graph: conditional nodes, the device
    counters of :func:`bump` and of every body's executions, and the
    kernel launches each body made while it was recorded.

    Slot 0 of ``counters`` is unused: launches outside any body are
    counted once a replay (:meth:`fold` takes the replay count).  Body
    allocations go to a memory pool of their own (``pool``), routed by
    thread, since the graph's own pool takes only its capture stream.
    """

    def __init__(self, device: torch.device, *, mode: str = "global"):
        device = torch.device(device)
        if device.index is None:
            device = torch.device(device.type, torch.cuda.current_device())
        self.device = device
        self.mode = mode
        if not hasattr(torch._C, "_cuda_beginAllocateCurrentThreadToPool"):
            raise CaptureError(
                "this PyTorch cannot route allocations to a memory pool by "
                "thread (torch._C._cuda_beginAllocateCurrentThreadToPool)")
        status = _lib().graph_cond_init(device.index)
        if status != 0:
            raise CaptureError(f"graph_cond_init failed: cudaError {status}")
        self.counters = torch.zeros(MAX_SLOTS, dtype=torch.int64,
                                    device=device)
        self.pool = torch.cuda.MemPool()
        self.streams = []
        self._stream(MAX_DEPTH - 1)
        self.slots: dict[str, int] = {}
        self.next_slot = 1
        # Per body slot: the launches recorded directly inside it.
        self.own_launches: dict[int, dict] = {}
        self.outside_launches: dict = {}
        self._frames: list = []
        self.depth = 0
        self.bodies = 0
        self.nodes = collections.Counter()

    def _stream(self, depth: int):
        """The body stream of nesting level ``depth``, made outside
        PyTorch's stream pool (see ``csrc/graph_cond.cu``)."""
        import ctypes

        while len(self.streams) <= depth:
            raw = ctypes.c_void_p()
            status = _lib().graph_stream_create(ctypes.byref(raw))
            if status != 0:
                raise CaptureError(
                    f"graph_stream_create failed: cudaError {status}")
            self.streams.append(torch.cuda.ExternalStream(
                raw.value, device=self.device))
        return self.streams[depth]

    def __del__(self):
        lib = _LIB
        for stream in getattr(self, "streams", ()):
            if lib is not None:
                lib.graph_stream_destroy(stream.cuda_stream)

    def _slot(self, key: str) -> int:
        slot = self.slots.get(key)
        if slot is None:
            if self.next_slot >= MAX_SLOTS:
                raise CaptureError(
                    f"a captured step needs more than {MAX_SLOTS} counters")
            slot = self.slots[key] = self.next_slot
            self.next_slot += 1
        return slot

    def bump(self, name: str) -> None:
        self.counters[self._slot("count:" + name)].add_(1)

    def node(self, value: torch.Tensor, n: int) -> list:
        """Add a conditional node on the device ``value``: an IF node on
        a 0-d bool (``n == 0``) or a SWITCH node over ``n`` bodies on an
        int32.  Returns its body graphs, each to be captured with
        :meth:`body`."""
        import ctypes

        if value.device != self.device or value.numel() != 1:
            raise CaptureError(
                f"a conditional node needs a 0-d value on {self.device}, "
                f"got {tuple(value.shape)} on {value.device}")
        want = torch.bool if n == 0 else torch.int32
        value = value.to(want).contiguous()
        bodies = (ctypes.c_void_p * max(n, 1))()
        parent = torch.cuda.current_stream(self.device)
        status = _lib().graph_cond_begin(parent.cuda_stream,
                                         value.data_ptr(), n, bodies)
        if status == -2:
            raise CaptureError("SWITCH nodes need a CUDA 12.8 toolkit")
        if status != 0:
            raise CaptureError(f"graph_cond_begin failed: cudaError {status}")
        self.nodes["if" if n == 0 else "switch"] += 1
        return list(bodies)

    @contextlib.contextmanager
    def body(self, graph):
        """Capture the work done inside into the body graph ``graph``."""
        if self.depth >= MAX_DEPTH:
            raise CaptureError(
                f"conditional nodes nested deeper than {MAX_DEPTH}")
        lib = _lib()
        stream = self._stream(self.depth)
        status = lib.graph_body_begin(stream.cuda_stream, graph,
                                      CAPTURE_MODES[self.mode])
        if status != 0:
            raise CaptureError(f"graph_body_begin failed: cudaError {status}")
        self.bodies += 1
        slot = self._slot(f"body:{self.bodies}")
        route = self.depth == 0
        if route:
            torch._C._cuda_beginAllocateCurrentThreadToPool(
                self.device.index, self.pool.id)
        self.depth += 1
        self._frames.append((slot, launch_totals(), {}))
        ok = False
        try:
            with torch.cuda.stream(stream):
                self.counters[slot].add_(1)
                yield
            ok = True
        finally:
            slot, before, children = self._frames.pop()
            now = launch_totals()
            total = {k: now.get(k, 0) - before.get(k, 0) for k in now}
            own = {k: v - children.get(k, 0) for k, v in total.items()}
            self.own_launches[slot] = {k: v for k, v in own.items() if v}
            if self._frames:
                up = self._frames[-1][2]
                for k, v in total.items():
                    up[k] = up.get(k, 0) + v
            self.depth -= 1
            if route:
                torch._C._cuda_endAllocateToPool(self.device.index,
                                                 self.pool.id)
                torch._C._cuda_releasePool(self.device.index, self.pool.id)
            end = lib.graph_body_end(stream.cuda_stream)
            if end != 0 and ok:
                raise CaptureError(f"graph_body_end failed: cudaError {end}")

    @contextlib.contextmanager
    def if_node(self, pred: torch.Tensor):
        with self.body(self.node(pred, 0)[0]):
            yield

    def record(self, fn):
        """Run ``fn`` (which captures), then take every launch it
        recorded off ``LAUNCHES`` (nothing ran) and keep the ones outside
        conditional bodies; returns ``fn()``."""
        before = launch_totals()
        try:
            return fn()
        finally:
            now = launch_totals()
            inside = collections.Counter()
            for own in self.own_launches.values():
                inside.update(own)
            self.outside_launches = {}
            for k in now:
                v = now[k] - before.get(k, 0) - inside.get(k, 0)
                if v:
                    self.outside_launches[k] = v
            set_launches(before)

    @property
    def used(self) -> int:
        """Counter slots in use (slot 0 included)."""
        return self.next_slot

    def fold(self, counts, replays: int) -> None:
        """Add one chunk's counters (``counts``, host ints of
        ``counters[:used]``) to ``COUNTS`` and ``LAUNCHES``; then zero
        the device counters for the next chunk."""
        launches = collections.Counter()
        for key, slot in self.slots.items():
            n = int(counts[slot])
            if not n:
                continue
            if key.startswith("count:"):
                COUNTS[key[6:]] += n
            else:
                for k, v in self.own_launches.get(slot, {}).items():
                    launches[k] += v * n
        for k, v in self.outside_launches.items():
            launches[k] += v * replays
        for (mod_name, k), v in launches.items():
            sys.modules[mod_name].LAUNCHES[k] += v
        self.counters[:self.used].zero_()


def _scalar_copies_mode():
    """A dispatch mode for the capture: a copy of a one-element CPU
    tensor into a CUDA tensor (``x[i] = 0.5`` on a CUDA tensor copies a
    CPU scalar) becomes a ``fill_`` with its value, which a graph takes
    as a kernel argument; a copy from host memory cannot be captured.
    The value is the same: the scalar already has the target's dtype."""
    from torch.utils._python_dispatch import TorchDispatchMode

    copy = torch.ops.aten.copy_.default
    to_copy = torch.ops.aten._to_copy.default

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is copy and all(torch.is_tensor(a) for a in args[:2]):
                dst, src = args[0], args[1]
                if (dst.is_cuda and src.device.type == "cpu"
                        and src.numel() == 1):
                    return dst.fill_(src.reshape(()).item())
            elif func is to_copy and torch.is_tensor(args[0]):
                src, dev = args[0], kwargs.get("device")
                if (src.device.type == "cpu" and src.numel() == 1
                        and dev is not None
                        and torch.device(dev).type == "cuda"):
                    return torch.full(
                        src.shape, src.reshape(()).item(),
                        dtype=kwargs.get("dtype") or src.dtype,
                        device=dev)
            return func(*args, **kwargs)

    return Mode()


class CapturedStep:
    """A captured CUDA graph with the context it was recorded in, which
    owns what its replays touch: the device counters and the memory pool
    of its conditional bodies.  Keep this object while the graph runs."""

    def __init__(self, graph, ctx: CaptureContext):
        self.graph = graph
        self.ctx = ctx

    def replay(self) -> None:
        self.graph.replay()


def capture_graph(device: torch.device, fn, *,
                  mode: str = "global") -> CapturedStep:
    """Capture ``fn()`` (which records through :func:`when`,
    :func:`cond` and :func:`select`) into a new CUDA graph, in the
    capture mode ``mode`` (:data:`CAPTURE_MODES`).  A failed capture
    raises the error that broke it; nothing falls back to the eager
    loop."""
    ctx = CaptureContext(device, mode=mode)
    graph = torch.cuda.CUDAGraph()
    first = []

    def body():
        with step_context(ctx), _scalar_copies_mode():
            try:
                fn()
            except BaseException as err:
                first.append(err)
                raise

    try:
        with torch.cuda.graph(graph, capture_error_mode=mode):
            ctx.record(body)
    except BaseException as err:
        if first and first[0] is not err:
            raise first[0] from err
        raise
    return CapturedStep(graph, ctx)
