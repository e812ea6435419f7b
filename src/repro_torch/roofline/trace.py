"""Read collective traffic and device time out of a ``torch.profiler`` trace.

The counterpart of the JAX package's ``roofline/hlo.py``.  The reference
lowers each step ahead of time and regexes the compiled HLO for its
collectives.  The port compiles nothing: its artifact is a chrome trace of
one step, as ``torch.profiler`` exports it (``export_chrome_trace``, recorded
with ``record_shapes=True``), and this module reads that.

Collectives come from the profiler's ``record_param_comms`` events, which
carry the collective's name, the message element counts, the group size and
the dtype (the NCCL process group records them).  A backend that records
none (gloo, in PyTorch 2.13) leaves a ``gloo:<op>`` annotation with the
input's dims and dtype; its group is the default process group, whose size
the trace's ``distributedInfo`` gives.  Wire bytes per device use the
reference's ring factors:

  all-gather          result x (g-1)/g
  all-reduce          result x 2(g-1)/g
  reduce-scatter      result x (g-1)
  all-to-all          result x (g-1)/g
  collective-permute  result x 1        (send / recv)

The reference scales each while body's collectives by its trip count,
because the HLO text lists a scanned layer's body once.  An eager trace
lists every launch that ran, so there is nothing to scale, and
``split_computations``, ``computation_multiplicities`` and
``scaled_wire_bytes`` have no counterpart.  On one card there are no
collectives at all: the trace gives 0 wire bytes, never an estimate.

``kernel_classes`` groups the trace's device events (kernels, copies,
memsets) by class: GEMM, each of the port's kernels by its symbol, NCCL,
copy or memset (dtype casts included), reduction, elementwise, other.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import math

import torch

PARAM_COMMS = "record_param_comms"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# (class, lower-case substrings of the symbol); the first match wins.  The
# port's kernels go by their CUDA symbols (kernels/csrc/*.cu): K1, K2 and
# K6b share move_lanes_kernel, and K1 and K2 over region shards
# move_shard_lanes_kernel.
KERNEL_CLASSES = (
    ("NCCL", ("nccl",)),
    ("K1/K2 shards move_shard_lanes", ("move_shard_lanes_kernel",)),
    ("K1/K2/K6b move_lanes", ("move_lanes_kernel",)),
    ("K6a gather_bulk", ("gather_bulk_kernel",)),
    ("K3 heat_scan", ("heat_scan_kernel",)),
    ("K4 paged_decode", ("paged_decode",)),
    ("K5 bwd lru_scan_bwd", ("lru_scan_bwd_kernel",)),
    ("K5 lru_scan", ("lru_scan_kernel",)),
    ("GEMM", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitkreduce")),
    ("copy or memset", ("memcpy", "memset", "copy")),
    ("reduction", ("reduce", "softmax", "norm")),
    ("elementwise", ("elementwise",)),
)
OTHER = "other"

# PyTorch's C++ type names (profiler "Input type", c10 dtype names) to torch's
_DTYPE_ALIASES = {
    "float": "float32", "half": "float16", "double": "float64", "int": "int32",
    "long": "int64", "long int": "int64", "char": "int8", "signed char": "int8",
    "byte": "uint8", "unsigned char": "uint8", "short": "int16",
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    dtype: str
    shape: tuple[int, ...]
    group_size: int
    result_bytes: int
    wire_bytes: int


def _wire_factor(kind: str, g: int) -> float:
    if g <= 1:
        return 0.0 if kind != "collective-permute" else 1.0
    if kind == "all-gather":
        return (g - 1) / g
    if kind == "all-reduce":
        return 2 * (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)
    if kind == "all-to-all":
        return (g - 1) / g
    if kind == "collective-permute":
        return 1.0
    return 1.0


def read(path: str) -> dict:
    """A chrome trace as ``export_chrome_trace`` wrote it (``.json`` or ``.json.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _events(trace) -> list[dict]:
    return trace["traceEvents"] if isinstance(trace, dict) else list(trace)


def _kind(name: str) -> str:
    """A collective's name (``allreduce``, ``_allgather_base``,
    ``reduce_scatter_tensor_coalesced``, ``gloo:all_to_all`` ...) as the
    reference's kind."""
    n = name.rpartition(":")[2].lower().replace("_", "")
    for prefix, kind in (("allreduce", "all-reduce"), ("allgather", "all-gather"),
                         ("reducescatter", "reduce-scatter"), ("alltoall", "all-to-all"),
                         ("send", "collective-permute"), ("recv", "collective-permute")):
        if n.startswith(prefix):
            return kind
    return n


def _dtype(name: str) -> torch.dtype | None:
    n = name.removeprefix("c10::").lower()
    dt = getattr(torch, _DTYPE_ALIASES.get(n, n), None)
    return dt if isinstance(dt, torch.dtype) else None


def _op(kind: str, dtype: torch.dtype, elems: int, g: int) -> CollectiveOp:
    nbytes = elems * dtype.itemsize
    return CollectiveOp(kind=kind, dtype=str(dtype).removeprefix("torch."), shape=(elems,),
                        group_size=g, result_bytes=nbytes,
                        wire_bytes=int(nbytes * _wire_factor(kind, g)))


def _default_group(trace) -> int:
    info = trace.get("distributedInfo") if isinstance(trace, dict) else None
    return int(info.get("world_size", 1)) if info else 1


def parse_collectives(trace) -> list[CollectiveOp]:
    """The collectives of a trace (the loaded dict, or its event list):
    one op per ``record_param_comms`` event, or, where there are none, per
    ``gloo:<op>`` annotation.  Ops of a dtype it cannot name are skipped, as
    the reference skips them."""
    events = _events(trace)
    ops = []
    comms = [e for e in events if e.get("name") == PARAM_COMMS]
    for e in comms:
        a = e.get("args", {})
        dt = _dtype(str(a.get("dtype", "")))
        if dt is None:
            continue
        ops.append(_op(_kind(str(a["Collective name"])), dt, int(a["Out msg nelems"]),
                       int(a["Group size"])))
    if comms:
        return ops
    g = _default_group(trace)
    for e in events:
        if e.get("cat") != "user_annotation" or not e.get("name", "").startswith("gloo:"):
            continue
        a = e.get("args", {})
        types, dims = a.get("Input type") or [""], a.get("Input Dims") or [[]]
        dt = _dtype(str(types[0]))
        if dt is None:
            continue
        kind = _kind(e["name"])
        elems = math.prod(dims[0])
        if kind == "all-gather":
            elems *= g
        elif kind == "reduce-scatter":
            elems //= g
        ops.append(_op(kind, dt, elems, g))
    return ops


def summarize(ops: list[CollectiveOp]) -> dict:
    by_kind: dict[str, dict] = {}
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "result_bytes": 0, "wire_bytes": 0})
        d["count"] += 1
        d["result_bytes"] += op.result_bytes
        d["wire_bytes"] += op.wire_bytes
    total = sum(d["wire_bytes"] for d in by_kind.values())
    return {"by_kind": by_kind, "wire_bytes": total, "n_ops": len(ops)}


def kernel_class(name: str) -> str:
    n = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in n for k in keys):
            return cls
    return OTHER


def kernel_classes(trace) -> dict[str, dict]:
    """``{class: {"device_ms", "launches"}}`` over the trace's device events,
    the largest device time first."""
    out: dict[str, dict] = {}
    for e in _events(trace):
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        d = out.setdefault(kernel_class(e.get("name", "")), {"device_ms": 0.0, "launches": 0})
        d["device_ms"] += float(e.get("dur", 0.0)) / 1e3
        d["launches"] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_ms"]))


def kernels_by_name(trace) -> dict[str, dict]:
    """``{kernel name: {"device_ms", "launches"}}`` over the trace's device
    events, the largest device time first."""
    out: dict[str, dict] = {}
    for e in _events(trace):
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        d = out.setdefault(e.get("name", ""), {"device_ms": 0.0, "launches": 0})
        d["device_ms"] += float(e.get("dur", 0.0)) / 1e3
        d["launches"] += 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_ms"]))
