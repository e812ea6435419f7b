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
stream (``VerdictFuture`` does).  The kernel wrappers count launches on the
host, which a replay does not run: each graph keeps the counts that its
capture added and adds them again at every replay.

A capture that fails raises; nothing falls back to eager launches.  Inside
:func:`disable_capture`, the counterpart of ``jax.disable_jit``, nothing is
captured or registered and every program runs eagerly: the tests and
``chip_smoke.py`` run the eager path beside the captured one with it.

The variant caches are process-wide, as the reference's per-function caches
are.
"""

from __future__ import annotations

import contextlib
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
    """``inputs`` on ``device``: as they are when they are there already, else
    in one pinned, non-blocking host-to-device copy per dtype."""
    if all(t.device == device for t in inputs):
        return list(inputs)
    flats = {}
    for dtype, idx in _by_dtype(inputs).items():
        flat = _packed([t.cpu() for t in inputs], idx)
        flats[dtype] = flat.pin_memory().to(device, non_blocking=True) if device.type == "cuda" \
            else flat.to(device)
    return _views(flats, inputs)


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
    """One captured variant over one set of bound tensors."""

    def __init__(self, body, inputs, device: torch.device, pool=None):
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
        before = _counts()
        with torch.cuda.device(device), torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool)
            try:
                self.outputs = body(*static)
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
            if inputs[idx[0]].is_cuda:
                for dst, i in zip(_views({dtype: flat}, [inputs[i] for i in idx]), idx):
                    dst.copy_(inputs[i], non_blocking=True)
            else:
                flat.copy_(_packed(inputs, idx).pin_memory(), non_blocking=True)
        self.graph.replay()
        _advance(self.delta)


class Program:
    """One program's variant cache: the counterpart of one jitted function."""

    def __init__(self, name: str):
        self.name = name
        self._variants: dict = {}  # key -> {binding: _Graph} (empty on the CPU)
        self._pools: dict = {}  # binding -> the memory pool its graphs share
        self.captures = 0  # graphs captured (a miss, or a known key over new tensors)
        self.replays = 0

    def __len__(self) -> int:
        """Variants registered: the reference's ``_cache_size()``."""
        return len(self._variants)

    def clear(self) -> None:
        """Forget every variant and graph (the reference's ``clear_cache()``)."""
        self._variants.clear()
        self._pools.clear()

    def __call__(self, key, body, inputs, bound):
        """``body(*inputs)`` as variant ``key``.

        ``inputs`` are the operands, on the host or on the device of
        ``bound``; ``bound`` are the tensors the body updates in place, which
        a captured graph belongs to.  ``body`` returns the program's outputs
        and must not return or keep a bound tensor.
        """
        device = bound[0].device
        if not _capture:
            return body(*to_device(inputs, device))
        if device.type != "cuda":
            self._variants.setdefault(key, {})
            return body(*to_device(inputs, device))
        graph = self._graph(key, body, inputs, bound, device)
        graph.replay(inputs)
        self.replays += 1
        return graph.outputs

    def warm(self, key, body, inputs, bound) -> None:
        """Compile variant ``key`` ahead of time: capture it on CUDA (nothing
        runs), register it on the CPU.  ``inputs`` give shapes only."""
        device = bound[0].device
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
            graph = graphs[binding] = _Graph(body, inputs, device, pool)
            self.captures += 1
            if pool is None:
                pool = self._pools[binding] = graph.graph.pool()
                for t in bound:
                    weakref.finalize(t, _forget, self._pools, binding, pool)
            for t in bound:
                weakref.finalize(t, _forget, graphs, binding, weakref.ref(graph))
        return graph
