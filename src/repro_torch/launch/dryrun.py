"""Dry-run of every (architecture x input shape) cell: measured on one H100,
accounted on the production meshes.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell ahead
of time on a forced 512-device host mesh.  The port has no ahead-of-time
compiler and one card, so its dry-run is built from these counterparts:

  ``.lower().compile()``   build the cell on the card and run its step
  ``memory_analysis()``    the allocator's counts around that step
  compiled HLO text        a ``torch.profiler`` trace of one step
  ``roofline/hlo.py``      ``roofline/trace.py`` reading the trace

``--mesh h100`` (the default) needs the card and raises without one.  For
each cell it computes on ``meta`` the argument bytes of the full cell
(parameters, AdamW m and v, inputs, the decode cache) and an estimate of
its peak, and records whether it fits the card.  It sets ``n_micro`` and the
MoE groups by the reference's formulas with dp = 1.  It cuts the batch (to
a divisor of the global batch), then the depth, until the estimate fits
``FIT_BYTES`` and a step holds at most ``STEP_TOKENS`` tokens, and records
the cut under ``reduced``.  It builds the cut cell with random weights from
``--seed``; its step is a ``graphs.Program``, as the reference jits each
cell.  The first step runs eagerly and captures the graph (the warm-up,
``first_step_s``), then ``TIMED_STEPS`` replays are timed with CUDA events
(more of them for a decode cell, whose step the host bounds), then
``PROFILED_STEPS`` more run under ``torch.profiler`` (one on the CPU), the
trace with the most device events kept.  The cell is then built again and
run eagerly (``graphs.disable_capture()``): ``EAGER_STEPS`` timed steps and
``PROFILED_STEPS`` profiled, recorded under ``eager``, and the second
step's outputs of both runs are compared bit for bit
(``graphed_equals_eager``).  It writes the reference's keys (``memory``,
``flops_per_device``, ``bytes_per_device`` and ``model_flops`` of the cut
cell, ``wire_bytes_per_device``, ``roofline``), ``build_s`` and
``first_step_s`` for the reference's ``lower_s`` and ``compile_s``, and
``measured``: the median and every warm step, the profiled step's device
ms, its share of the median step (``busy``; the profiler's host overhead
lengthens the profiled step itself, so ``busy_profiled``, its share of that
step's wall, reads low when the host bounds the step), the peak, and its
kernels by class.

``--mesh pod|multipod`` is accounting only, on ``meta``, with no card:
per-device argument bytes from ``distributed/sharding.py``'s rules (the
parameter rules, the inference layout for decode and its flat 2D layout for
dense weights over 10 GiB a tp shard, the reference's cache and batch
rules).  Status ``ACCOUNTED``, and no ``roofline`` entry: there is no
program to read collectives from.

``--leap``'s two cells are the reference's migration copy program over a
KV-page pool of one region a data-axis row (``LEAP_CELL``): ``copy_chunk``
of one area (the xla backend) or ``copy_chunk_ppermute`` from region 0 to
region 1.  On ``h100`` the pod's 16 regions sit on the one card, the pool
built directly as one tensor a region (23 GiB, never a one-tensor copy
beside it), and the step, one replay of the program's captured graph, is
timed as the other cells' are: ``measured`` holds the median and every
step, the profiled step's device ms and busy share, and its kernels by
name; beside them the step's byte bound (the area read once and written
once at the card's memory rate).  On ``pod`` and ``multipod`` the cell is
accounted: per-device argument bytes, a region's 64 slots and the
replicated table, flags and operands.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod     # CPU, accounting
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite_3_2b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --leap              # card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --leap --mesh pod   # CPU, accounting

Artifacts: ``<DRYRUN_ART_DIR, else artifacts/dryrun>/torch/<mesh>/
<arch>__<shape>.json`` (idempotent; ``--force`` reruns), and beside each
measured cell its trace, ``<arch>__<shape>.trace.json.gz``.
``roofline/report.py`` reads only these files, and holds their location
(``ART_DIR``) and the statuses.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import time
import traceback

import torch

from repro_torch.configs import shapes as shp
from repro_torch.configs.base import ARCH_IDS, ModelConfig, canon, get_config
from repro_torch.core import graphs, migrator
from repro_torch.core.state import LeapState, PoolConfig, _default_device
from repro_torch.distributed.sharding import (
    _EXPERT_LEAVES,
    MeshShape,
    ShardCtx,
    cache_spec,
    make_ctx,
    make_decode_2d_ctx,
    param_shardings,
    sanitize_spec,
    shard_shape,
)
from repro_torch.launch.mesh import make_production_mesh, make_region_mesh
from repro_torch.models import lm
from repro_torch.roofline import flops as fl
from repro_torch.roofline import model as roof
from repro_torch.roofline import trace as tr
from repro_torch.roofline.report import (
    ACCOUNTED,
    ART_DIR,
    LEAP_BACKENDS,
    MESHES,
    OK,
    SKIP_ONE_CARD,
)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import TrainConfig, init_train_state, state_tensors, train_step

# a measured cell's estimated peak leaves 8 GiB of the card's 80 GB free
FIT_BYTES = roof.HBM_BYTES - 8 * 2**30
# tokens a measured step may hold, so that a cell's steps take seconds,
# not many minutes; a decode step holds one token a sequence and is cut by
# memory alone
STEP_TOKENS = {"train": 16_384, "prefill": 32_768}
# warm steps timed after the warm-up, by kind: a decode step takes tens of
# ms and varies with the host, a train step takes seconds; a 32k prefill
# takes up to 27 s on the card, bound by it, and the profiled replay after
# the timed one reads its device time again
TIMED_STEPS = {"train": 3, "prefill": 1, "decode": 25}
# timed steps of the eager run beside the graphed one (a rebuilt cell, no
# warm-up: the graphed run has warmed the process)
EAGER_STEPS = {"train": 1, "prefill": 1, "decode": 25}
# profiled steps of each run on the card, the trace with the most device
# events kept: the profiler loses records, now and then a run of about 20
# consecutive ones (``scripts/trace_loss.py`` counts them).  A replay, or an
# eager step, launches the same kernels every time, so the fuller trace is
# the truer one
PROFILED_STEPS = 2


class DoesNotFit(ValueError):
    """A cell that does not fit one card even at batch 1 and its fewest layers."""


# ---------------------------------------------------------------------------
# Cell construction (the reference's formulas)
# ---------------------------------------------------------------------------


def _mesh(name: str) -> MeshShape:
    if name == "h100":
        return MeshShape((1, 1), ("data", "model"))
    return make_production_mesh(multi_pod=name == "multipod")


def _dp_total(mesh: MeshShape) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def _with_moe_groups(
    cfg: ModelConfig, tokens_per_step: int, dp: int, mode: str = "weights"
) -> ModelConfig:
    if cfg.moe is None:
        return cfg
    groups = max(dp, tokens_per_step // 512)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, groups=groups, dispatch_mode=mode)
    )


@dataclasses.dataclass(frozen=True)
class Cell:
    """One (arch x shape) cell: the config with its MoE groups set as the
    reference's ``build_cell`` sets them, the shape at the cell's batch, and
    the microbatches of a train cell."""

    cfg: ModelConfig
    spec: shp.ShapeSpec
    n_micro: int | None


def plan_cell(cfg: ModelConfig, shape: str, dp: int, batch: int | None = None) -> Cell:
    sp = shp.SHAPES[shape]
    if batch is not None:
        sp = dataclasses.replace(sp, global_batch=batch)
    if sp.kind == "train":
        n_micro = max(1, sp.global_batch // (dp * cfg.microbatch_per_device))
        tokens = (sp.global_batch // n_micro) * sp.seq_len
        return Cell(_with_moe_groups(cfg, tokens, dp), sp, n_micro)
    if sp.kind == "prefill":
        return Cell(_with_moe_groups(cfg, sp.global_batch * sp.seq_len, dp), sp, None)
    return Cell(_with_moe_groups(cfg, sp.global_batch, dp, mode="tokens"), sp, None)


# ---------------------------------------------------------------------------
# Accounting on meta
# ---------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def meta_arguments(cell: Cell) -> dict[str, dict[str, torch.Tensor]]:
    """The step's arguments on ``meta`` by group: ``params``; for train
    ``m``, ``v`` and ``step``; for decode ``cache`` (``"<layer>.<leaf>"``)
    and ``pos``; and ``inputs``."""
    cfg, sp = cell.cfg, cell.spec
    params = dict(lm.CausalLM(cfg, device=shp.META).named_parameters())
    inputs = shp.input_specs(cfg, sp)
    args = {"params": params}
    if sp.kind == "train":
        dt = getattr(torch, cfg.opt_state_dtype)
        for k in ("m", "v"):
            args[k] = {n: torch.empty(p.shape, dtype=dt, device=shp.META) for n, p in params.items()}
        args["step"] = {"step": torch.empty((), dtype=torch.int32, device=shp.META)}
    if sp.kind == "decode":
        cache = shp.cache_specs(cfg, sp)
        args["cache"] = {f"{i}.{k}": t for i, layer in enumerate(cache) for k, t in layer.items()}
        args["pos"] = {"pos": inputs.pop("pos")}
    args["inputs"] = inputs
    return args


def _layout(cell: Cell, params: dict, mesh: MeshShape) -> tuple[ShardCtx, str]:
    """The reference's choice of layout: decode takes the inference layout,
    or the flat 2D one when its dense weights exceed 10 GiB a tp shard."""
    ctx = make_ctx(mesh)
    if cell.spec.kind != "decode":
        return ctx, "fsdp"
    dense = sum(_nbytes(t) for n, t in params.items() if n.rpartition(".")[2] not in _EXPERT_LEAVES)
    if dense / mesh.shape.get("model", 1) > 10 * 2**30:
        return make_decode_2d_ctx(mesh), "decode_2d"
    return ctx, "inference"


def cache_specs(cell: Cell, leaves: dict, ctx: ShardCtx) -> dict:
    """The spec of each ``"<layer>.<leaf>"`` of a decode cell's cache under
    ``ctx``: ``sharding.cache_spec``, the rule the placed decode lays its
    cache out by."""
    return {n: cache_spec(n.rpartition(".")[2], tuple(t.shape), ctx,
                          long=cell.spec.name == "long_500k")
            for n, t in leaves.items()}


def account(cell: Cell, mesh: MeshShape) -> dict:
    """Per-device argument bytes of ``cell`` on ``mesh``, by group, and the
    layout that placed them."""
    args = meta_arguments(cell)
    ctx, layout = _layout(cell, args["params"], mesh)
    specs = {"params": param_shardings(args["params"], mesh, ctx,
                                       inference=cell.spec.kind == "decode")}
    for group, leaves in args.items():
        if group in ("m", "v"):
            specs[group] = specs["params"]
        elif group == "cache":
            specs[group] = cache_specs(cell, leaves, ctx)
        elif group == "inputs":
            specs[group] = {n: sanitize_spec((ctx.dp,) + (None,) * (t.ndim - 1), tuple(t.shape),
                                             mesh)
                            for n, t in leaves.items()}
        elif group != "params":  # step, pos: replicated
            specs[group] = {n: () for n in leaves}
    by_group = {
        g: sum(math.prod(shard_shape(tuple(t.shape), specs[g][n], mesh)) * t.element_size()
               for n, t in leaves.items())
        for g, leaves in args.items()
    }
    return {"argument_bytes": sum(by_group.values()), "arguments": by_group, "layout": layout}


def _temp_bytes(cell: Cell) -> int:
    """An estimate of the largest temporaries of the cell's step on one
    device: the attention scores alive at once (a query chunk in prefill
    and decode, every chunk of a block in its backward), the f32 copies of
    k and v, the recurrent and xLSTM state math in f32, the activations of
    one block, the fp32 logits, and in training the saved block inputs,
    the gradients and their accumulator."""
    cfg, sp = cell.cfg, cell.spec
    f32, esz = 4, cfg.dtype().itemsize
    d, h, kvd, v = cfg.d_model, cfg.n_heads, cfg.kv_dim, cfg.vocab_size
    if sp.kind == "decode":
        b = sp.global_batch
        keys = [min(cfg.window, sp.seq_len) if k == "win" else sp.seq_len
                for k in cfg.layer_kinds if k in ("attn", "win", "moe")]
        return max((4 * b * t * kvd * f32 + 3 * b * h * t * f32 for t in keys), default=0) \
            + 2 * b * v * f32
    b = sp.global_batch // (cell.n_micro or 1)
    s = sp.seq_len
    tok = b * s
    chunk = min(cfg.attn_chunk, s)
    queries = s if sp.kind == "train" else chunk

    def layer(kind: str) -> int:
        if kind in ("attn", "win", "moe"):
            sk = min(cfg.window + chunk, s) if kind == "win" else s
            return 3 * b * h * queries * sk * f32 + 4 * b * sk * kvd * f32
        return 10 * tok * max(cfg.rnn_width, 2 * d) * f32

    ffn = (cfg.moe.top_k * cfg.moe.capacity_factor * (d + 3 * cfg.moe.d_ff) if cfg.moe
           else 3 * cfg.d_ff)
    act = int(tok * (4 * d + ffn + cfg.q_dim + 2 * kvd) * esz)
    temps = max(layer(k) for k in set(cfg.layer_kinds)) + act
    if sp.kind == "prefill":
        return temps + 2 * b * v * f32
    n_params = cfg.param_count()
    grads = n_params * cfg.pdtype().itemsize
    if cell.n_micro > 1:
        grads += n_params * getattr(torch, cfg.grad_accum_dtype).itemsize
    return temps + cfg.n_layers * tok * d * esz + grads + 3 * tok * v * f32


def estimate_peak_bytes(cell: Cell) -> tuple[int, int]:
    """(argument bytes, estimated peak bytes) of ``cell`` on one device: the
    arguments, a prefill's outputs (the cache and the logits) and
    :func:`_temp_bytes`."""
    args = sum(_nbytes(t) for g in meta_arguments(cell).values() for t in g.values())
    out = 0
    if cell.spec.kind == "prefill":
        cache = shp.cache_specs(cell.cfg, cell.spec)
        out = sum(_nbytes(t) for layer in cache for t in layer.values())
    return args, args + out + _temp_bytes(cell)


def _depths(cfg: ModelConfig) -> list[int]:
    """Layer counts the config's pattern admits, fewest first."""
    per, tail = len(cfg.layer_pattern), len(cfg.tail_pattern)
    return [tail + k * per for k in range(0 if tail else 1, cfg.repeats + 1)]


def cut_cell(cfg: ModelConfig, shape: str) -> tuple[Cell, dict, dict | None]:
    """The cell measured on one card: the largest divisor of the global
    batch within ``STEP_TOKENS`` whose estimate fits ``FIT_BYTES``, else
    batch 1 at the most layers that fit.  Returns (cell, the full cell's
    record, the cut or None)."""
    sp = shp.SHAPES[shape]
    full = plan_cell(cfg, shape, dp=1)
    args, peak = estimate_peak_bytes(full)
    record = dict(global_batch=sp.global_batch, n_layers=cfg.n_layers, argument_bytes=args,
                  peak_estimate_bytes=peak, fits=peak <= FIT_BYTES, n_micro=full.n_micro,
                  moe_groups=full.cfg.moe.groups if full.cfg.moe else None)
    batches = [b for b in range(sp.global_batch, 0, -1) if sp.global_batch % b == 0]
    cap = STEP_TOKENS.get(sp.kind)
    by = []
    if cap is not None and batches[0] * sp.seq_len > cap:
        batches = [b for b in batches if b * sp.seq_len <= cap] or [1]
        by.append("step tokens")
    for b in batches:
        cell = plan_cell(cfg, shape, dp=1, batch=b)
        if estimate_peak_bytes(cell)[1] <= FIT_BYTES:
            break
    else:  # batch 1 does not fit: cut the depth, the most layers that fit
        by.append("memory")
        depths = _depths(cfg)
        lo, hi = 0, len(depths) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            c = plan_cell(dataclasses.replace(cfg, n_layers=depths[mid]), shape, dp=1, batch=1)
            lo, hi = (mid, hi) if estimate_peak_bytes(c)[1] <= FIT_BYTES else (lo, mid - 1)
        cell = plan_cell(dataclasses.replace(cfg, n_layers=depths[lo]), shape, dp=1, batch=1)
        if estimate_peak_bytes(cell)[1] > FIT_BYTES:
            raise DoesNotFit(f"{cfg.name} {shape}: {depths[lo]} layers at batch 1 need "
                             f"{estimate_peak_bytes(cell)[1]:.4g} B against {FIT_BYTES:.4g}")
    if cell.spec.global_batch < batches[0] and "memory" not in by:
        by.append("memory")
    reduced = None
    if cell.spec.global_batch < sp.global_batch or cell.cfg.n_layers < cfg.n_layers:
        reduced = dict(batch=cell.spec.global_batch, of_batch=sp.global_batch,
                       layers=cell.cfg.n_layers, of_layers=cfg.n_layers, by=by)
    return cell, record, reduced


# ---------------------------------------------------------------------------
# The measured run
# ---------------------------------------------------------------------------


def _inputs(cfg: ModelConfig, batch: int, seq: int, gen, device) -> torch.Tensor:
    if cfg.embed_inputs:
        return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device,
                             dtype=torch.int32)
    return torch.randn((batch, seq, cfg.d_model), generator=gen, device=device,
                       dtype=torch.bfloat16)


def _decode_in_place(model, cache: list[dict], inputs, pos: int, cfg: ModelConfig):
    """``lm.decode_step`` with the whole cache updated in place (the
    reference donates it): a layer that returns a new state (a recurrent
    layer's) has it copied into its old tensors.  Returns the logits."""
    old = [dict(c) for c in cache]
    logits, new = lm.decode_step(model, cache, inputs, pos, cfg)
    for i, (o, n) in enumerate(zip(old, new)):
        for k, t in n.items():
            if t is not o[k]:
                o[k].copy_(t)
        cache[i] = o
    return logits


def build(cell: Cell, device: torch.device, seed: int):
    """The cell on ``device`` with random weights from ``seed``: (its step,
    the bytes the step updates in place, the reference's donated arguments;
    the step's program).

    The step is compiled as the reference jits each cell: a
    ``graphs.Program`` whose first call runs eagerly and captures, and whose
    later calls replay (eager throughout inside ``graphs.disable_capture()``).
    The reference traces the decode position; here it is part of the
    variant's key (every step of a cell decodes at ``seq_len - 1``)."""
    cfg, sp = cell.cfg, cell.spec
    b, s = sp.global_batch, sp.seq_len
    gen = torch.Generator(device=device).manual_seed(seed)
    prog = graphs.Program(f"dryrun_{sp.kind}", eager_first=True)
    if sp.kind == "train":
        tcfg = TrainConfig(n_micro=cell.n_micro, accum_dtype=cfg.grad_accum_dtype,
                           optimizer=OptimizerConfig(state_dtype=cfg.opt_state_dtype))
        state = init_train_state(gen, cfg, tcfg, device)
        batch = [_inputs(cfg, b, s, gen, device),
                 torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=device,
                               dtype=torch.int32)]
        alias = sum(_nbytes(t) for t in state.params.parameters()) + _nbytes(state.opt["step"]) \
            + sum(_nbytes(t) for k in ("m", "v") for t in state.opt[k].values())

        def body(inputs, labels):
            return train_step(state, {"inputs": inputs, "labels": labels}, cfg, tcfg)[1]

        bound, key = state_tensors(state), "train"
    else:
        model = lm.init_params(gen, cfg, device)
        bound = list(model.parameters()) + list(model.buffers())
        if sp.kind == "prefill":
            batch, alias, key = [_inputs(cfg, b, s, gen, device)], 0, "prefill"

            def body(inputs):
                return lm.prefill(model, inputs, cfg, s)
        else:
            cache = lm.init_cache(cfg, b, s, device)
            batch = [_inputs(cfg, b, 1, gen, device)]
            alias = sum(_nbytes(t) for layer in cache for t in layer.values())
            bound += [t for layer in cache for t in layer.values()]
            key = ("decode", s - 1)

            def body(inputs):
                return _decode_in_place(model, cache, inputs, s - 1, cfg)
    key = (key, tuple((tuple(t.shape), t.dtype) for t in batch))
    return (lambda: prog(key, body, batch, bound, device=device)), alias, prog


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(step, device: torch.device):
    """(the step's result, its ms): CUDA-event time on the card, the host
    clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = step()
    return out, (time.perf_counter() - t0) * 1e3


def _profiled(step, device: torch.device, trace_path: str):
    """(the step's result, the wall ms of the step run under the profiler,
    its trace)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        out = step()
        _sync(device)
        window_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    return out, window_ms, tr.read(trace_path)


def _run(step, n_timed: int, device: torch.device, trace_path: str, first: bool) -> dict:
    """``step`` run ``first`` (the warm-up, untimed), ``n_timed`` times timed,
    then profiled (``PROFILED_STEPS`` times on the card, the trace with the
    most device events kept at ``trace_path``): the figures of ``measure``'s
    ``measured``, and the outputs of the step after the first, copied (the
    step whose graphed and eager results ``measure`` compares)."""
    cuda = device.type == "cuda"
    res, kept, i = {}, None, 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if first:
        t0 = time.perf_counter()
        out = step()
        _sync(device)
        res["first_step_s"] = time.perf_counter() - t0
        res["after_first"] = torch.cuda.memory_allocated(device) if cuda else None
        out, i = None, 1  # a prefill's outputs go before the next step makes its own
    times = []
    for _ in range(n_timed):
        out, ms = _timed(step, device)
        times.append(ms)
        if i == 1:
            kept = [t.detach().cpu() for t in graphs.tensors(out)]
        out, i = None, i + 1
    n = PROFILED_STEPS if cuda else 1
    root = trace_path.removesuffix(".json.gz")
    runs = []
    for path in (f"{root}.{k}.json.gz" for k in range(n)):
        out, window_ms, trace = _profiled(step, device, path)
        if i == 1:
            kept = [t.detach().cpu() for t in graphs.tensors(out)]
        out, i = None, i + 1
        classes = tr.kernel_classes(trace)
        runs.append((sum(c["launches"] for c in classes.values()), window_ms, classes, trace,
                     path))
    events = [r[0] for r in runs]
    kernels, window_ms, classes, trace, path = max(runs, key=lambda r: r[0])
    for r in runs:
        if r[4] != path:
            os.remove(r[4])
    os.replace(path, trace_path)
    step_ms = statistics.median(times)
    # a CPU trace holds no device events: its device figures are not measured
    device_ms = sum(c["device_ms"] for c in classes.values()) if cuda else None
    res.update(
        step_ms=step_ms, steps_ms=times, device_ms=device_ms, window_ms=window_ms,
        busy=device_ms / step_ms if cuda else None,
        busy_profiled=device_ms / window_ms if cuda else None,
        peak_bytes=torch.cuda.max_memory_allocated(device) if cuda else None,
        kernels=kernels, kernel_classes=classes, profiled_events=events,
        trace=os.path.basename(trace_path), kept=kept, collectives=trace)
    return res


def measure(cell: Cell, device: torch.device, seed: int, trace_path: str) -> dict:
    """Build and run ``cell``: the artifact's ``build_s``, ``first_step_s``,
    ``memory``, ``collectives``, ``wire_bytes_per_device`` and ``measured``,
    the cell's graphed step; and ``eager``, the same cell built again and
    run under ``graphs.disable_capture()`` (``EAGER_STEPS`` timed steps and
    the profiled ones), with ``graphed_equals_eager``: the outputs of the step
    after the first, graphed (a replay) against eager, bit for bit.  The
    allocator's counts and device time exist on the card only: on the CPU
    those figures are None."""
    cuda = device.type == "cuda"
    alloc = (lambda: torch.cuda.memory_allocated(device)) if cuda else (lambda: None)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    base = alloc()
    t0 = time.perf_counter()
    step, alias, prog = build(cell, device, seed)
    _sync(device)
    res = {"build_s": time.perf_counter() - t0}
    before = alloc()
    graphed = _run(step, TIMED_STEPS[cell.spec.kind], device, trace_path, first=True)
    graphed.update(captures=prog.captures, replays=prog.replays)
    step = prog = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    eager_step = build(cell, device, seed)[0]
    with graphs.disable_capture():
        eager = _run(eager_step, EAGER_STEPS[cell.spec.kind], device,
                     trace_path.replace(".trace.", ".eager.trace."), first=False)
    eager_step = None
    res["first_step_s"] = graphed.pop("first_step_s")
    after, peak = graphed.pop("after_first"), graphed["peak_bytes"]
    if cuda:
        new = after - before
        res["memory"] = dict(argument_bytes=before - base, output_bytes=new + alias,
                             temp_bytes=max(peak - after, 0), alias_bytes=alias,
                             per_device_total=peak - base)
        for run in (graphed, eager):
            run["peak_bytes"] -= base
    else:
        res["memory"] = dict(argument_bytes=None, output_bytes=None, temp_bytes=None,
                             alias_bytes=alias, per_device_total=None)
    res["collectives"] = coll = tr.summarize(tr.parse_collectives(graphed.pop("collectives")))
    eager.pop("collectives")
    res["wire_bytes_per_device"] = float(coll["wire_bytes"])
    g, e = graphed.pop("kept"), eager.pop("kept")
    res["graphed_equals_eager"] = len(g) == len(e) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(g, e))
    res["measured"] = dict(device=torch.cuda.get_device_name(device) if cuda else str(device),
                           **graphed)
    res["eager"] = eager
    return res


def _record_plan(art: dict, cell: Cell) -> None:
    """``n_micro`` for a train cell (as the reference records it) and the
    MoE groups for a MoE config."""
    if cell.n_micro is not None:
        art["n_micro"] = cell.n_micro
    if cell.cfg.moe is not None:
        art["moe_groups"] = cell.cfg.moe.groups


def _measure_cell(art: dict, cfg: ModelConfig, shape: str, device, seed: int,
                  out_path: str) -> None:
    cell, art["full"], art["reduced"] = cut_cell(cfg, shape)
    ccfg, sp = cell.cfg, cell.spec
    art["config"] = ccfg.name
    _record_plan(art, cell)
    args, peak = estimate_peak_bytes(cell)
    art["accounting"] = dict(argument_bytes=args, peak_estimate_bytes=peak)
    art.update(measure(cell, device, seed, out_path.removesuffix(".json") + ".trace.json.gz"))
    acct = fl.step_cost(ccfg, sp, 1, dp=1)
    art["flops_per_device"] = acct.total_flops
    art["bytes_per_device"] = acct.hbm_bytes
    art["hbm_detail"] = acct.detail
    tokens = sp.global_batch * (1 if sp.kind == "decode" else sp.seq_len)
    art["model_flops"] = roof.model_flops(ccfg.active_param_count(), tokens, sp.kind)
    t = roof.terms_from_artifact(art)
    art["roofline"] = {
        "compute_s": t.compute_s,
        "memory_s": t.memory_s,
        "collective_s": t.collective_s,
        "dominant": t.dominant,
        "step_time_s": t.step_time_s,
        "useful_flops_ratio": t.useful_flops_ratio,
        "roofline_fraction": t.roofline_fraction,
    }
    art["status"] = OK


def _account_cell(art: dict, cfg: ModelConfig, shape: str, mesh: MeshShape) -> None:
    cell = plan_cell(cfg, shape, _dp_total(mesh))
    _record_plan(art, cell)
    acct = account(cell, mesh)
    art["layout"] = acct.pop("layout")
    art["memory"] = acct
    art["status"] = ACCOUNTED


# ---------------------------------------------------------------------------
# The leap cells: the reference's migration copy program on a KV-page pool
# ---------------------------------------------------------------------------

# The reference's build_leap_cell: one region a data-axis row (16 on the
# pod, kept on the one card here), 64 slots a region of a KV page sized like
# gemma2's (46 layers, k and v, 64 tokens, 16 kv heads of 128) in bf16, half
# the slots holding blocks; its step copies one area of 16 blocks.
LEAP_CELL = dict(slots=64, payload=(46, 2, 64, 16, 128), area=16)
LEAP_REGIONS = 16
LEAP_STEPS = 25  # timed steps of a leap cell, as of a decode cell


def leap_cell_state(regions: int, device, seed: int, slots: int, payload,
                    dtype=torch.bfloat16) -> tuple[LeapState, PoolConfig, object]:
    """The leap cell's state on a region mesh of ``regions`` regions on
    ``device``: built directly as one ``[slots + 1, *payload]`` tensor a
    region (random from ``seed``, each sink row zero), so that no one-tensor
    pool is ever made.  Block ``b`` lives in region ``b // h``, slot ``b %
    h``, for ``h = slots // 2``.  Returns ``(state, pool config, mesh)``."""
    device = torch.device(device)
    pc = PoolConfig(regions, slots, tuple(payload), dtype, region_axis="data")
    mesh = make_region_mesh(regions, [device] * regions)
    gen = torch.Generator(device=device).manual_seed(seed)
    shards = []
    for _ in range(regions):
        shard = torch.randn((slots + 1,) + tuple(payload), generator=gen, dtype=dtype,
                            device=device)
        shard[-1].zero_()
        shards.append(shard)
    half = slots // 2
    blocks = torch.arange(regions * half)
    table = torch.stack([blocks // half, blocks % half], 1).to(torch.int32).to(device)
    flags = [torch.zeros(len(blocks), dtype=torch.bool, device=device) for _ in range(2)]
    return LeapState(tuple(shards), table, *flags), pc, mesh


def leap_step(state: LeapState, mesh, backend: str, area: int):
    """The cell's step: the reference's ``copy_chunk`` (xla) or
    ``copy_chunk_ppermute`` (ppermute) of blocks ``[0, area)`` (region 0) to
    the first free slots of region 1; on the card one replay of the
    program's captured graph.  A repeat copies the same bytes again."""
    ids = torch.arange(area)
    dst = ids + state.pool_shape[1] // 2
    if backend == "ppermute":
        return lambda: migrator.copy_chunk_ppermute(state, ids, dst, 0, 1, mesh)
    return lambda: migrator.copy_chunk(state, ids, dst, 1)


def leap_accounting(mesh: MeshShape) -> dict:
    """Per-device argument bytes of the leap cell on a production mesh, as
    the reference shards it: the pool's region dim over ``data`` (a
    device holds its region's 64 slots), the table, the flags and the
    step's two int32 operands replicated."""
    c = LEAP_CELL
    regions = mesh.shape["data"]
    blocks = regions * c["slots"] // 2
    shard = c["slots"] * math.prod(c["payload"]) * torch.bfloat16.itemsize
    replicated = blocks * 2 * 4 + 2 * blocks + 2 * c["area"] * 4
    return dict(argument_bytes=shard + replicated, pool_shard_bytes=shard,
                replicated_bytes=replicated, regions=regions)


def _leap_cell(art: dict, backend: str, device, seed: int, out_path: str) -> None:
    """Build the leap cell on ``device`` and time its step (figures of the
    device are None on the CPU)."""
    c = LEAP_CELL
    cuda = torch.device(device).type == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) if cuda else None
    t0 = time.perf_counter()
    state, pc, mesh = leap_cell_state(LEAP_REGIONS, device, seed, c["slots"], c["payload"])
    _sync(device)
    art["build_s"] = time.perf_counter() - t0
    args = torch.cuda.memory_allocated(device) - base if cuda else None
    area_bytes = c["area"] * pc.block_bytes
    res = _run(leap_step(state, mesh, backend, c["area"]), LEAP_STEPS, device,
               out_path.removesuffix(".json") + ".trace.json.gz", first=True)
    trace = res.pop("collectives")
    for k in ("kept", "after_first"):
        res.pop(k)
    art["first_step_s"] = res.pop("first_step_s")
    art["memory"] = dict(argument_bytes=args, per_device_total=(
        res["peak_bytes"] - base if cuda else None))
    art.update(regions=LEAP_REGIONS, slots=c["slots"], payload=list(c["payload"]),
               area_blocks=c["area"], area_bytes=area_bytes,
               bound_ms=2 * area_bytes / roof.HBM_BW * 1e3, bound_by="bytes",
               pool_bytes=sum(_nbytes(t) for t in state.pool))
    res["kernels_by_name"] = tr.kernels_by_name(trace) if cuda else {}
    art["measured"] = dict(device=torch.cuda.get_device_name(device) if cuda else str(device),
                           **res)
    art["status"] = OK


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape: str, mesh_name: str = "h100", force: bool = False, *,
             device=None, seed: int = 0) -> dict:
    """One cell's artifact, written under ``ART_DIR/<mesh_name>/``.  On the
    h100 mesh the cell runs on ``device`` (the current CUDA device by
    default; raises without one).  A leap cell is ``("leap_migration",
    backend)``."""
    os.makedirs(os.path.join(ART_DIR, mesh_name), exist_ok=True)
    out_path = os.path.join(ART_DIR, mesh_name, f"{arch}__{shape}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    mesh = _mesh(mesh_name)
    art = {"arch": arch, "shape": shape, "mesh": mesh_name, "n_chips": mesh.size}
    leap = arch == "leap_migration"
    cfg = None if leap else get_config(arch)
    art["status"] = None if leap else shp.cell_status(cfg, shape)
    if art["status"] is None:
        if mesh_name == "h100":
            device = _default_device(device)
        try:
            if leap and mesh_name == "h100":
                _leap_cell(art, shape, device, seed, out_path)
            elif leap:
                art["memory"] = leap_accounting(mesh)
                art["status"] = ACCOUNTED
            elif mesh_name == "h100":
                _measure_cell(art, cfg, shape, device, seed, out_path)
            else:
                _account_cell(art, cfg, shape, mesh)
        except DoesNotFit as e:
            art["status"] = SKIP_ONE_CARD
            art["reason"] = str(e)
        except Exception as e:  # record failures; the runner counts them
            art["status"] = f"FAIL: {type(e).__name__}: {e}"
            art["traceback"] = traceback.format_exc()[-4000:]
    with open(out_path, "w") as f:
        json.dump(art, f, indent=2)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--mesh", type=str, default="h100", choices=MESHES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--leap", action="store_true", help="migration-program cells")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--seed", type=int, default=0, help="random weights and inputs")
    args = ap.parse_args(argv)

    if args.leap:
        cells = [("leap_migration", b) for b in LEAP_BACKENDS]
    elif args.all or args.arch is None:
        cells = [(a, s) for a in ARCH_IDS for s in shp.SHAPES]
    else:
        shapes = [args.shape] if args.shape else list(shp.SHAPES)
        cells = [(canon(args.arch), s) for s in shapes]

    failures = 0
    for arch, shape in cells:
        t0 = time.time()
        art = run_cell(arch, shape, args.mesh, force=args.force, seed=args.seed)
        status = art.get("status", "?")
        dom = art.get("roofline", {}).get("dominant", "-")
        print(
            f"[{args.mesh:8s}] {arch:24s} {shape:12s} {status[:60]:60s} "
            f"dom={dom:10s} ({time.time() - t0:.1f}s)",
            flush=True,
        )
        if status.startswith("FAIL"):
            failures += 1
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
