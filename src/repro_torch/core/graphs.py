"""Captured device programs: the port's counterpart of ``jax.jit``'s cache.

The JAX package compiles a program once per operand signature and calls the
compiled program from then on; ``program_cache_sizes()`` counts those
compiles and the driver reports their per-tick growth as
``MigrationStats.jit_cache_misses``.  Here a :class:`Program` keeps one
*variant* per key, the key being what the reference's cache keys on (the
operands' lengths, the static arguments, the shapes and dtypes of the state
it updates), and what a variant is depends on the device:

* on CUDA a variant holds captured CUDA graphs.  A miss captures the
  program's launches into a ``torch.cuda.CUDAGraph`` over static input
  buffers (a capture records launches and runs none of them); every call
  copies its operands into those buffers on the current stream and replays
  the graph, one launch for the whole program;
* on the CPU nothing is captured: a miss registers the key, and every call
  runs the program eagerly over the same operands.

A graph belongs to the tensors the program updates in place (a migration
state's pool, table and flags, its heat plane; a decode step's KV pool): a
call over other tensors captures again, and a graph is dropped, with the
memory its capture reserved, as soon as one of its tensors is freed.  It
never replays over stale addresses.  Only the first capture of a key counts
as a miss, as a new driver over a known shape compiles nothing in the JAX
package.

A program's graphs over one set of bound tensors share one private memory
pool, so that the temporaries of its variants (a bucket each) take the
largest variant's memory, not their sum.  That is safe because (i) every
replay runs on the caller's stream, one after another, so no two graphs
of a pool run at once and a temporary's bytes are dead once its replay
has ended; and (ii) a graph's outputs live as long as the graph, so no
later capture can be handed their memory.

A replay's outputs are the graph's static tensors: the next replay of the
same graph overwrites them, so a caller copies what it keeps, on the same
stream (``VerdictFuture`` does).  A program made with ``fresh=True`` (the
application's reads, TPC-H's partial aggregates) makes that copy itself and
hands out tensors no later replay touches, as the reference returns a
fresh array from every call.  The kernel wrappers count launches on the
host, which a replay does not run: each graph keeps the counts that its
capture added and adds them again at every replay.

A program made with ``eager_first=True`` (a model's prefill, a training
step, a dry-run cell) runs the first call of each graph eagerly, on the
capture stream, as the real call, then frees the cached blocks that run
left and captures: lazy initialisation (cuBLAS, the autograd engine's
device thread) happens outside the capture, and a training step applies
its update once a call.  Later calls replay.

A program over tensors on several cards (a migration state whose region
shards lie on distinct cards) runs from its home device, ``bound[0]``'s.
Its variant is one CUDA graph whose capture spans the cards: the home
device's capture stream forks to a capture stream on every other card
(each waits on an event recorded in the capture, so it joins it), the body
runs with each card's current stream its capture stream (the peer copies'
events stay inside the one capture), and the forked streams join back
before the capture ends.  The temporaries of another card come from a
memory pool of that card which the graph keeps.  A replay waits for the
work queued before it on every card, and every card's current stream waits
for the replay.  Its graph thus holds the launches of each card, joined by
events, with the transfers between them.

A capture that fails raises; nothing falls back to eager launches.  Inside
:func:`disable_capture`, the counterpart of ``jax.disable_jit``, nothing is
captured or registered and every program runs eagerly: the tests and
``chip_smoke.py`` run the eager path beside the captured one with it.

The variant caches are process-wide, as the reference's per-function caches
are.
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import torch

from repro_torch.kernels import _build, heat_scan, leap_copy, lru_scan, paged_attn

_capture = True  # False inside disable_capture()
_doomed: list = []  # graphs dropped during a capture, destroyed after it
_streams: dict[int, torch.cuda.Stream] = {}  # per device: the stream captures run on
# the kernel wrappers whose host-side launch counters a replay must advance
_COUNTED = (
    leap_copy.copy_blocks,
    leap_copy.copy_runs,
    leap_copy.copy_blocks_shards,
    leap_copy.copy_runs_shards,
    leap_copy.zero_blocks_shards,
    leap_copy.gather_blocks,
    leap_copy.scatter_blocks,
    heat_scan.heat_scan,
    paged_attn.paged_decode,
    lru_scan.lru_scan,
    lru_scan.lru_scan_bwd,
)
_COUNTERS = ("launches", "lanes", "launches_by_head_dim", "launches_by_group")


@contextlib.contextmanager
def disable_capture():
    """Run every program eagerly inside the block, capturing and registering
    nothing (``jax.disable_jit``'s counterpart)."""
    global _capture
    was, _capture = _capture, False
    try:
        yield
    finally:
        _capture = was


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every capture on ``device`` runs on."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _streams:
        _streams[index] = torch.cuda.Stream(index)
    return _streams[index]


def _indexed(device) -> torch.device:
    """``device`` with its card's index ("cuda" names the current card), so
    that two names of one card compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _counts() -> dict:
    return {
        (fn, name): dict(getattr(fn, name)) if name.startswith("launches_by") else getattr(fn, name)
        for fn in _COUNTED
        for name in _COUNTERS
        if hasattr(fn, name)
    }


def _advance(delta: dict) -> None:
    for (fn, name), d in delta.items():
        if isinstance(d, dict):
            counts = getattr(fn, name)
            for k, v in d.items():
                counts[k] = counts.get(k, 0) + v
        else:
            setattr(fn, name, getattr(fn, name) + d)


def _restore(before: dict) -> dict:
    """Put the counters back to ``before``; return what they had gained."""
    delta = {}
    for (fn, name), was in before.items():
        now = getattr(fn, name)
        if isinstance(was, dict):
            d = {k: v - was.get(k, 0) for k, v in now.items() if v != was.get(k, 0)}
            now.clear()
            now.update(was)
        else:
            d = now - was
            setattr(fn, name, was)
        if d:
            delta[fn, name] = d
    return delta


def _by_dtype(inputs) -> dict:
    """Operand positions grouped by dtype, in input order."""
    groups: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(inputs):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _views(flats: dict, inputs) -> list[torch.Tensor]:
    """Each operand's view of its dtype's flat buffer, shaped like the operand."""
    out: list = [None] * len(inputs)
    for dtype, idx in _by_dtype(inputs).items():
        lo = 0
        for i in idx:
            n = inputs[i].numel()
            out[i] = flats[dtype][lo : lo + n].view(inputs[i].shape)
            lo += n
    return out


def _packed(inputs, idx) -> torch.Tensor:
    return torch.cat([inputs[i].reshape(-1) for i in idx])


def to_device(inputs, device: torch.device) -> list[torch.Tensor]:
    """``inputs`` on ``device``: those there already as they are, the others
    in one pinned, non-blocking host-to-device copy per dtype."""
    out = list(inputs)
    host = [i for i, t in enumerate(inputs) if t.device != device]
    if not host:
        return out
    moved = [inputs[i].cpu() for i in host]
    flats = {}
    for dtype, idx in _by_dtype(moved).items():
        flat = _packed(moved, idx)
        flats[dtype] = flat.pin_memory().to(device, non_blocking=True) if device.type == "cuda" \
            else flat.to(device)
    for i, view in zip(host, _views(flats, moved)):
        out[i] = view
    return out


def _fields(out) -> dict:
    """The fields of a dataclass instance."""
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)}


def _fresh(out):
    """``out`` with every tensor in it copied (on the current stream)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_fresh(o) for o in out)
    if isinstance(out, dict):
        return {k: _fresh(v) for k, v in out.items()}
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        return dataclasses.replace(out, **{k: _fresh(v) for k, v in _fields(out).items()})
    return out


def tensors(out):
    """The tensors in ``out`` (a tensor, or tuples, lists, dicts and
    dataclasses of them)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from tensors(o)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        yield from tensors(_fields(out))


def _forget(graphs: dict, binding, graph) -> None:
    """Drop ``graphs[binding]`` if it is still ``graph`` (a weak reference
    to a graph, or a pool handle): a tensor it belongs to was freed.  The
    garbage collector may run this while another graph is being captured,
    when destroying a graph would void that capture: then the graph waits
    in ``_doomed`` until the capture ends."""
    g = graphs.get(binding)
    if g is not None and g is (graph() if isinstance(graph, weakref.ref) else graph):
        del graphs[binding]
        if torch.cuda.is_current_stream_capturing():
            _doomed.append(g)


class _Graph:
    """One captured variant over one set of bound tensors; ``peers`` are the
    other cards they lie on."""

    def __init__(self, body, inputs, device: torch.device, pool=None, eager_first=False,
                 peers=()):
        self.groups = _by_dtype(inputs)
        self.flats = {
            dtype: torch.empty(sum(inputs[i].numel() for i in idx), dtype=dtype, device=device)
            for dtype, idx in self.groups.items()
        }
        static = _views(self.flats, inputs)
        _build.load()  # a library load is no call to make while capturing
        self.graph = torch.cuda.CUDAGraph()
        stream, current = capture_stream(device), torch.cuda.current_stream(device)
        stream.wait_stream(current)
        self.first = eager_first  # the eager first call's outputs are yet to be handed out
        self.first_outputs = None
        if eager_first:
            with torch.cuda.device(device), torch.cuda.stream(stream):
                self.first_outputs = body(*to_device(inputs, device))
            for t in tensors(self.first_outputs):
                t.record_stream(current)
            torch.cuda.empty_cache()  # the eager run's temporaries, before the capture
        self.device, self.peers = device, tuple(peers)
        self.peer_pools = {}
        for d in self.peers:
            with torch.cuda.device(d):
                self.peer_pools[d] = torch.cuda.MemPool()
        before = _counts()
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.cuda.device(device))
            stack.enter_context(torch.cuda.stream(stream))
            self.graph.capture_begin(pool=pool)
            try:
                for d in self.peers:  # fork: each card's capture stream joins the capture
                    peer = capture_stream(d)
                    peer.wait_stream(stream)
                    stack.enter_context(torch.cuda.stream(peer))
                    stack.enter_context(torch.cuda.use_mem_pool(self.peer_pools[d], d))
                self.outputs = body(*static)
                for d in self.peers:  # join
                    stream.wait_stream(capture_stream(d))
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()  # the capture is void; the body's error stands
                _doomed.clear()
                _restore(before)
                raise
            self.graph.capture_end()
        _doomed.clear()
        current.wait_stream(stream)
        self.delta = _restore(before)  # the capture launched nothing

    def replay(self, inputs) -> None:
        for dtype, idx in self.groups.items():
            flat = self.flats[dtype]
            if not flat.numel():
                continue
            host = [i for i in idx if not inputs[i].is_cuda]
            if len(host) == len(idx):
                flat.copy_(_packed(inputs, idx).pin_memory(), non_blocking=True)
                continue
            dsts = dict(zip(idx, _views({dtype: flat}, [inputs[i] for i in idx])))
            for i in idx:
                if inputs[i].is_cuda:
                    dsts[i].copy_(inputs[i], non_blocking=True)
            if host:  # one pinned staging buffer for this dtype's host operands
                pinned, lo = _packed(inputs, host).pin_memory(), 0
                for i in host:
                    n = dsts[i].numel()
                    dsts[i].copy_(pinned[lo : lo + n].view(dsts[i].shape), non_blocking=True)
                    lo += n
        home = torch.cuda.current_stream(self.device) if self.peers else None
        for d in self.peers:  # what was queued on the other cards comes first
            home.wait_stream(torch.cuda.current_stream(d))
        self.graph.replay()
        for d in self.peers:  # and what comes after on them waits for the replay
            torch.cuda.current_stream(d).wait_stream(home)
        _advance(self.delta)


class Program:
    """One program's variant cache: the counterpart of one jitted function.
    ``fresh`` and ``eager_first`` are described in the module docstring."""

    def __init__(self, name: str, *, fresh: bool = False, eager_first: bool = False):
        self.name = name
        self.fresh = fresh
        self.eager_first = eager_first
        self._variants: dict = {}  # key -> {binding: _Graph} (empty on the CPU)
        self._pools: dict = {}  # binding -> the memory pool its graphs share
        self.captures = 0  # graphs captured (a miss, or a known key over new tensors)
        self.replays = 0

    def __len__(self) -> int:
        """Variants registered: the reference's ``_cache_size()``."""
        return len(self._variants)

    def clear(self) -> None:
        """Forget every variant and graph (the reference's ``clear_cache()``);
        the graphs' memory goes back to the allocator."""
        for graphs in self._variants.values():
            graphs.clear()  # the bound tensors' finalizers hold these dicts
        self._variants.clear()
        self._pools.clear()

    def __call__(self, key, body, inputs, bound, device=None):
        """``body(*inputs)`` as variant ``key``.

        ``inputs`` are the operands, on the host or on the program's device;
        ``bound`` are the tensors the body reads or updates in place besides
        its operands (a state, a model's parameters), which a captured graph
        belongs to.  ``body`` returns the program's outputs and must not
        return or keep a bound tensor.  The program runs on ``device``, by
        default ``bound[0]``'s (a program with nothing bound names it).
        """
        device = _indexed(bound[0].device if device is None else device)
        if not _capture:
            return body(*to_device(inputs, device))
        if device.type != "cuda":
            self._variants.setdefault(key, {})
            return body(*to_device(inputs, device))
        graph = self._graph(key, body, inputs, bound, device)
        if graph.first:
            out, graph.first, graph.first_outputs = graph.first_outputs, False, None
            return out
        graph.replay(inputs)
        self.replays += 1
        return _fresh(graph.outputs) if self.fresh else graph.outputs

    def warm(self, key, body, inputs, bound) -> None:
        """Compile variant ``key`` ahead of time: capture it on CUDA (nothing
        runs), register it on the CPU.  ``inputs`` give shapes only."""
        device = _indexed(bound[0].device)
        if not _capture:
            return
        if device.type != "cuda":
            self._variants.setdefault(key, {})
            return
        self._graph(key, body, inputs, bound, device)

    def _graph(self, key, body, inputs, bound, device) -> _Graph:
        graphs = self._variants.setdefault(key, {})
        binding = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in bound)
        graph = graphs.get(binding)
        if graph is None:
            pool = self._pools.get(binding)
            peers = list(dict.fromkeys(t.device for t in bound if t.device != device))
            graph = graphs[binding] = _Graph(body, inputs, device, pool, self.eager_first,
                                             peers)
            self.captures += 1
            if pool is None:
                pool = self._pools[binding] = graph.graph.pool()
                for t in bound:
                    weakref.finalize(t, _forget, self._pools, binding, pool)
            for t in bound:
                weakref.finalize(t, _forget, graphs, binding, weakref.ref(graph))
        return graph
