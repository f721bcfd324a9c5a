"""Compiled training steps: one CUDA graph per step variant and device.

The port's counterpart of the reference's compiled steps (a `jax.jit`
executable runs a whole step with no Python dispatch per op).  A
`CompiledStep` wraps a step body -- a function of tensor trees (dicts,
lists, tuples, named tuples) whose launches depend only on their shapes and
on the body's static flags, such as `Instant3DTrainer.step` at fixed freeze
flags, budget and bitfield use -- and keeps one `StagedGraph` per CUDA
device it is called on:

* static input buffers, copies of the first call's inputs;
* the `torch.cuda.CUDAGraph` of one call of the body on them, and the
  static outputs that call allocated;
* the graph's launch record (`kernels.record_launches`).

A call copies its inputs into the static buffers, replays the graph and
hands back fresh tensors: a clone of every output, except an output that is
one of the static inputs (a leaf the body passes through, as the optimizer
passes a masked leaf), which comes back as the caller's own input object.
So the body's eager contract holds -- new tensors, the inputs untouched --
and nothing the caller keeps (a step's aux, its overflow count) is
overwritten by the next replay.

Building a graph: the body runs once eagerly on the static buffers (the
warm-up, on the device's capture stream: its launches are real and count
into `kernels.LAUNCHES`, and it reaches every lazy initialisation -- cuBLAS
workspaces, the kernels' `cudaFuncSetAttribute` -- before the capture), then
once under `torch.cuda.graph` on the same stream with
``capture_error_mode="thread_local"``, so other threads (the async serving
thread, the scheduler's slot threads) go on launching on their own streams.
The capture stream comes from torch's high-priority stream pool and the
render service's streams from the default-priority one, so it is never a
render stream.  Captures are serialised process-wide, one at a time, as
torch requires.  All graphs of a device share one memory pool, so a variant
costs its static buffers rather than its own working set; since a replay
reuses the working memory of every other graph of its device, the replays
on one device are serialised by the device's lock and ordered across
streams by an event recorded after each copy-out.  A warm-up and capture
hold the same lock and are ordered by the same event: the warm-up's eager
kernels run on the capture stream, with the cuBLAS workspaces (one per
thread and stream) that the graphs captured there replay with.  Ops with a Python side
effect inside a body (trace spans) act only while the graph is built, as
they act only at trace inside `jax.jit`.

On the CPU -- the caller asked for the CPU -- and inside `eager_steps()` a
call runs the body itself.  On a CUDA device a failed capture or replay
raises; nothing falls back to eager.  `StagedGraph(body, args)` with no
device stages the body on the CPU with a replay that reruns it into the
static outputs in place (`HostReplay`): the tests hold the staging's
copy-in and copy-out to the eager body with it.

Compiled renders: a `CompiledRender` wraps one member's chunk renderer
-- (params, origins (chunk, 3), dirs, ts (chunk, S), *occupancy) -> (rgb,
depth), built by the render caches in `trainer.py` -- and renders every
chunk of a view through one `RenderGraph` per device; a `BatchedRender`
(a batched cache entry) renders each member of a group in turn through
one `CompiledRender` shared by every group size, so a group costs its
real members' renders and one graph's static buffers.  What a render
needs that a step does not:

* bound inputs: the params, ts and occupancy inputs are the same for every
  chunk of a member's view, so a view binds them into the static buffers
  once (one `torch._foreach_copy_`), then copies in each chunk's origins
  and dirs only;
* outputs: each replay's rgb and depth go straight into the caller's
  whole-view buffers, one copy each, with no per-chunk clone;
* a pool, lock and event of their own per device (`device_graphs(device,
  "render")`), so a render replay never waits on a training replay nor
  blocks one, and the two kinds never share working memory.

Render graphs capture on their device's render capture stream, a stream
of torch's high-priority pool like the training capture stream, so never
one of the render service's streams (default priority).  Their warm-up
and capture hold the process-wide capture lock, so they never overlap a
training warm-up or capture, and the render lock and event, so they run
after every render replay enqueued before them and before every one after
them; they are not ordered against training replays, which use another
pool and another stream's cuBLAS workspace (and a render calls no cuBLAS
routine: its MLPs are kernels #2 and #3).  A render replay holds the
render lock for a member's whole view -- bind, every chunk's copy-in,
replay and copy-out -- since the static buffers hold one member's bound
inputs.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

from .. import kernels

_eager_depth = 0
_eager_lock = threading.Lock()
_capture_lock = threading.Lock()         # one capture at a time in the process
_devices_lock = threading.Lock()
_devices: dict[tuple[torch.device, str], "DeviceGraphs"] = {}


@contextlib.contextmanager
def eager_steps():
    """Run every compiled step and fold eagerly, on every thread, until the
    block ends: the counterpart of `jax.disable_jit()`, for tests and
    chip_smoke's captured-against-eager comparison."""
    global _eager_depth
    with _eager_lock:
        _eager_depth += 1
    try:
        yield
    finally:
        with _eager_lock:
            _eager_depth -= 1


def eager() -> bool:
    """Whether compiled steps run eagerly now (`eager_steps`)."""
    return _eager_depth > 0


class DeviceGraphs:
    """What the graphs of one kind (training steps or renders) on one CUDA
    device share: their memory pool, the capture stream, and the lock and
    event that order their replays."""

    def __init__(self, device: torch.device):
        self.device = device
        with torch.cuda.device(device):
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device, priority=-1)
        self.lock = threading.Lock()
        self.done: torch.cuda.Event | None = None


def device_graphs(device: torch.device, kind: str = "step") -> DeviceGraphs:
    """The shared state of `kind` ("step" or "render") graphs on `device`."""
    with _devices_lock:
        dev = _devices.get((device, kind))
        if dev is None:
            dev = _devices[(device, kind)] = DeviceGraphs(device)
        return dev


def release_devices(kind: str = "step") -> None:
    """Forget the devices' pools of `kind`: graphs built later share a new
    pool (one still held keeps its own pool and lock)."""
    with _devices_lock:
        for key in [k for k in _devices if k[1] == kind]:
            del _devices[key]


# ---- trees of tensors ----

def _flatten(tree, path=()) -> list:
    """[(path, leaf)] of a tree of dicts (keys sorted), lists, tuples and
    named tuples; a leaf is a tensor or any other value."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for k, v in enumerate(tree) for item in _flatten(v, path + (k,))]
    return [(path, tree)]


def _map(fn, tree):
    """The tree with `fn` applied to every tensor leaf."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _device_of(tree) -> torch.device | None:
    for _, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def _copy(t: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(t).copy_(t)


def _matched(staged: list, args) -> list:
    """[(static tensor, the caller's tensor)] of a call's `args` against
    the staged leaves; raises where the call's tree, shapes, dtypes, device
    or static values differ from the staged ones."""
    leaves = _flatten(args)
    if [p for p, _ in leaves] != [p for p, _ in staged]:
        raise ValueError("compiled step: the inputs' tree differs from the staged one")
    pairs = []
    for (path, dst), (_, src) in zip(staged, leaves):
        if isinstance(dst, torch.Tensor):
            if not isinstance(src, torch.Tensor) or src.shape != dst.shape \
                    or src.dtype != dst.dtype or src.device != dst.device:
                raise ValueError(f"compiled step: input {path} is not a {dst.dtype} "
                                 f"{tuple(dst.shape)} tensor on {dst.device}")
            pairs.append((dst, src))
        elif src != dst:
            raise ValueError(f"compiled step: static input {path} is {src!r}, "
                             f"staged as {dst!r}")
    return pairs


class HostReplay:
    """The CPU stand-in of a captured graph: a replay reruns the body on
    the static inputs and writes its results into the static outputs in
    place, as a graph replay overwrites its output buffers."""

    def __init__(self, body, static_in):
        self.body, self.static_in = body, static_in
        self.static_out = body(*static_in)

    def replay(self) -> None:
        for (_, dst), (_, src) in zip(_flatten(self.static_out),
                                      _flatten(self.body(*self.static_in))):
            if isinstance(dst, torch.Tensor) and dst is not src:
                dst.copy_(src)


class _Captured:
    """One body staged on one device (`dev`, a `DeviceGraphs`; None stages
    it on the CPU through `HostReplay`): static inputs, the graph of one
    call, its static outputs and launch record, and what building it took
    (`capture_ms`, `warmup_launches`).  How a call uses it is the
    subclass's: `StagedGraph` for a step, `RenderGraph` for a render."""

    def __init__(self, body, args: tuple, dev: DeviceGraphs | None = None):
        t0 = time.perf_counter()
        self.dev = dev
        self.static_in = _map(_copy, args)
        self._in_leaves = _flatten(self.static_in)
        self.record: dict[str, int] = {}
        self.warmup_launches: dict[str, int] = {}
        self.replays = 0
        if dev is None:
            self.graph = HostReplay(body, self.static_in)
            self.static_out = self.graph.static_out
        else:
            self.graph, self.static_out = self._capture(body, dev)
        self._out_leaves = _flatten(self.static_out)
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _capture(self, body, dev: DeviceGraphs):
        # The warm-up runs eagerly on the capture stream, so it uses the
        # cuBLAS workspaces the device's graphs were captured with: under
        # the device's lock, after every replay enqueued before it and
        # before every replay after it (the device's event).
        with dev.lock, torch.cuda.device(dev.device):
            current = torch.cuda.current_stream(dev.device)
            dev.stream.wait_stream(current)
            if dev.done is not None:
                dev.stream.wait_event(dev.done)
            with kernels.record_launches(dev.stream) as warm, torch.cuda.stream(dev.stream):
                body(*self.static_in)
            self.warmup_launches = warm
            kernels.add_launches(warm)          # the warm-up's launches ran
            graph = torch.cuda.CUDAGraph()
            with kernels.record_launches(dev.stream) as self.record:
                with torch.cuda.graph(graph, pool=dev.pool, stream=dev.stream,
                                      capture_error_mode="thread_local"):
                    static_out = body(*self.static_in)
            current.wait_stream(dev.stream)
            dev.done = torch.cuda.Event()
            dev.done.record(dev.stream)
        return graph, static_out

    @property
    def static_bytes(self) -> int:
        """Bytes of the static inputs and of the static outputs that are not
        inputs passed through."""
        ins = [leaf for _, leaf in self._in_leaves if isinstance(leaf, torch.Tensor)]
        passed = {id(t) for t in ins}
        outs = [leaf for _, leaf in self._out_leaves
                if isinstance(leaf, torch.Tensor) and id(leaf) not in passed]
        return sum(t.numel() * t.element_size() for t in ins + outs)


class StagedGraph(_Captured):
    """A step body staged on one device: a call copies every input in,
    replays, and hands back fresh outputs."""

    def _copy_in(self, args) -> dict:
        """Copy `args` into the static inputs -> {id(static leaf): the
        caller's leaf}; raises where the call's tree, shapes, dtypes,
        device or static values differ from the staged ones."""
        caller = {}
        for dst, src in _matched(self._in_leaves, args):
            dst.copy_(src)
            caller[id(dst)] = src
        return caller

    def __call__(self, args: tuple):
        """Copy in, replay, hand back fresh outputs."""
        lock = self.dev.lock if self.dev is not None else contextlib.nullcontext()
        with lock:
            if self.dev is not None and self.dev.done is not None:
                torch.cuda.current_stream(self.dev.device).wait_event(self.dev.done)
            caller = self._copy_in(args)
            self.graph.replay()
            kernels.add_launches(self.record)
            out = _map(lambda t: caller[id(t)] if id(t) in caller else t.clone(),
                       self.static_out)
            if self.dev is not None:
                self.dev.done = torch.cuda.Event()
                self.dev.done.record(torch.cuda.current_stream(self.dev.device))
            self.replays += 1
        return out


class CompiledStep:
    """A step body compiled per device: a CPU call (or one inside
    `eager_steps`) runs the body, a CUDA call replays the device's graph,
    captured on the first call there."""

    def __init__(self, body):
        self.body = body
        self.graphs: dict[torch.device, StagedGraph] = {}

    def __call__(self, *args):
        device = _device_of(args)
        if device is None or device.type != "cuda" or eager():
            return self.body(*args)
        graph = self.graphs.get(device)
        if graph is None:
            with _capture_lock:
                graph = self.graphs.get(device)
                if graph is None:
                    graph = self.graphs[device] = StagedGraph(self.body, args,
                                                              device_graphs(device))
        return graph(args)


class RenderGraph(_Captured):
    """One member's chunk renderer staged on one device (`dev`, the
    device's render `DeviceGraphs`; None stages it on the CPU through
    `HostReplay`), from the arguments of one chunk, (params, origins,
    dirs, ts, *occupancy): a view renders as one `bind` of the params, ts
    and occupancy inputs, then per chunk its origins and dirs copied in, a
    replay, and rgb and depth copied out into the caller's buffers."""

    def __init__(self, body, args: tuple, dev: DeviceGraphs | None = None):
        super().__init__(body, args, dev)
        params, origins, _dirs, *rest = self.static_in
        self._bound_leaves = _flatten((params, *rest))
        self.chunk = origins.shape[-2]
        self.binds = 0

    def bind(self, params, *rest) -> None:
        """Copy the inputs every chunk of a view shares into the static
        buffers: one `torch._foreach_copy_` over their leaves."""
        dst, src = zip(*_matched(self._bound_leaves, (params, *rest)))
        torch._foreach_copy_(list(dst), list(src))
        self.binds += 1

    def copy_in(self, origins: torch.Tensor, dirs: torch.Tensor) -> None:
        """One chunk's rays into the static buffers."""
        self.static_in[1].copy_(origins)
        self.static_in[2].copy_(dirs)

    def copy_out(self, rgb: torch.Tensor, depth: torch.Tensor) -> None:
        """The last replay's rgb and depth into the caller's chunk slices."""
        rgb.copy_(self.static_out[0])
        depth.copy_(self.static_out[1])

    def render(self, args: tuple, rgb: torch.Tensor, depth: torch.Tensor) -> None:
        """Render every chunk of `args`' origins and dirs (k * chunk, 3)
        into `rgb` (k * chunk, 3) and `depth` (k * chunk,)."""
        params, origins, dirs, *rest = args
        c, n = self.chunk, origins.shape[-2]
        lock = self.dev.lock if self.dev is not None else contextlib.nullcontext()
        with lock:
            stream = None
            if self.dev is not None:
                stream = torch.cuda.current_stream(self.dev.device)
                if self.dev.done is not None:
                    stream.wait_event(self.dev.done)
            self.bind(params, *rest)
            for i in range(0, n, c):
                self.copy_in(origins.narrow(-2, i, c), dirs.narrow(-2, i, c))
                self.graph.replay()
                kernels.add_launches(self.record)
                self.replays += 1
                self.copy_out(rgb.narrow(-2, i, c), depth.narrow(-1, i, c))
            if stream is not None:
                self.dev.done = torch.cuda.Event()
                self.dev.done.record(stream)


def _card_stage(body, args: tuple, device: torch.device) -> RenderGraph | None:
    """The default staging of a render: a `RenderGraph` in the render pool
    of a CUDA device, none (the body runs) on the CPU."""
    if device.type != "cuda":
        return None
    return RenderGraph(body, args, device_graphs(device, "render"))


class CompiledRender:
    """One member's chunk renderer compiled per device: (params, origins
    (k * chunk, 3), dirs, ts (chunk, S), *occupancy) -> (rgb (k * chunk,
    3), depth (k * chunk,)), fresh tensors, every chunk of chunk =
    ts.shape[0] rays rendered by the body under `torch.no_grad()`.  A call
    inside `eager_steps`, or on a device `stage` stages nothing for (the
    default `_card_stage`: the CPU), runs the body chunk by chunk;
    otherwise it renders through the device's `RenderGraph`, which
    `stage(body, the first chunk's arguments, device)` builds on the first
    call there (the tests stage on the CPU with ``stage=lambda body, args,
    device: RenderGraph(body, args)``)."""

    def __init__(self, body, stage=_card_stage):
        self.body = torch.no_grad()(body)
        self.stage = stage
        self.graphs: dict[torch.device, RenderGraph] = {}
        self._unstaged: set[torch.device] = set()   # devices the body runs on

    def _graph(self, args: tuple) -> RenderGraph | None:
        """The graph a call with `args` renders through; None: the body."""
        params, origins, dirs, ts, *rest = args
        chunk, n = ts.shape[0], origins.shape[-2]
        if n == 0 or n % chunk:
            raise ValueError(f"compiled render: {n} rays are not whole chunks of {chunk}")
        device = origins.device
        if eager() or device in self._unstaged:
            return None
        graph = self.graphs.get(device)
        if graph is None:
            with _capture_lock:
                graph = self.graphs.get(device)
                if graph is None and device not in self._unstaged:
                    first = (params, origins.narrow(-2, 0, chunk), dirs.narrow(-2, 0, chunk), ts,
                             *rest)
                    graph = self.stage(self.body, first, device)
                    if graph is None:
                        self._unstaged.add(device)
                    else:
                        self.graphs[device] = graph
        return graph

    def _eager(self, params, origins, dirs, ts, *rest):
        chunk, n = ts.shape[0], origins.shape[-2]
        outs = [self.body(params, origins.narrow(-2, i, chunk), dirs.narrow(-2, i, chunk),
                          ts, *rest) for i in range(0, n, chunk)]
        return (torch.cat([o[0] for o in outs], dim=-2),
                torch.cat([o[1] for o in outs], dim=-1))

    def __call__(self, params, origins, dirs, ts, *rest):
        rgb, depth = self.members([params], origins[None], dirs[None], ts,
                                  *([r] for r in rest))
        return rgb[0], depth[0]

    def members(self, params: list, origins, dirs, ts, *rest):
        """A group, one member after another: (params list of g, origins
        (g, k * chunk, 3), dirs, ts, *per-member inputs indexed by member)
        -> (rgb (g, k * chunk, 3), depth (g, k * chunk)); on a graph each
        member is bound in turn and its chunks replayed straight into its
        slice of the outputs."""
        args = [(p, origins[g], dirs[g], ts, *(r[g] for r in rest))
                for g, p in enumerate(params)]
        graph = self._graph(args[0])
        if graph is None:
            outs = [self._eager(*a) for a in args]
            return (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]))
        rgb_s, depth_s = graph.static_out
        rgb = torch.empty(origins.shape[:-1] + rgb_s.shape[-1:], dtype=rgb_s.dtype,
                          device=origins.device)
        depth = torch.empty(origins.shape[:-1], dtype=depth_s.dtype, device=origins.device)
        for g, a in enumerate(args):
            graph.render(a, rgb[g], depth[g])
        return rgb, depth


class BatchedRender:
    """A batched render entry: (params list of g <= `group`, origins (g,
    k * chunk, 3), dirs, ts (chunk, S), *per-member inputs indexed by
    member) -> (rgb (g, k * chunk, 3), depth (g, k * chunk)), each member
    rendered by `member`, the one-member `CompiledRender` that every group
    size of the entry's chunk, budget and path shares.  `group` is the
    reference's padded size; the port renders only the members it is given,
    so the padding costs nothing."""

    def __init__(self, member: CompiledRender, group: int):
        self.member, self.group = member, int(group)

    def __call__(self, params: list, origins, dirs, ts, *rest):
        if not 0 < len(params) <= self.group:
            raise ValueError(f"a render entry of group {self.group} called on {len(params)}")
        return self.member.members(params, origins, dirs, ts, *rest)
