"""Tensor-parallel compute over a device mesh's model axis: which products of
a placed model split over a data-parallel group's positions, and the block
of each weight that each position binds.

The reference leaves this to GSPMD, steered by its parameter rules
(``distributed/sharding.py`` ``_RULES``) and its activation constraints.
Here :func:`plan` makes the same choices, on the shape the reference's
jitted step sees (the global microbatch ``[B, S, D]`` in training, ``[B,
1, D]`` in decode), for a group of ``n`` tensor-parallel positions
(``sharding.tp_peers``; ``n > 1``):

  * attention splits by heads iff ``tp_worthwhile`` holds for its four
    weights (``src/repro/models/attention.py:64-73``) and its q heads split
    ``n`` ways.  Each position takes its q heads and the KV heads they read:
    its share of the KV heads when they split too, else the one KV head
    its q heads share (MQA); q heads that do not split leave the layer
    whole;
  * a dense MLP splits its hidden dim iff ``tp_worthwhile`` holds
    (``src/repro/models/common.py:72-74``) and ``d_ff`` splits;
  * an RG-LRU block splits its channels whenever they split (the
    reference constrains nothing there and leaves the weights' own specs);
  * an mLSTM or sLSTM block's ``cell`` splits by heads whenever ``n``
    divides its 4 heads (``xlstm.N_HEADS``; the reference constrains
    nothing there either): position ``t`` takes heads ``[4 t / n, 4 (t +
    1) / n)`` and their channels of each leaf (``_CUTS``; ``models/xlstm.py``
    computes the split block).  Both kinds' ``up`` holds two branches side
    by side (the mLSTM's ``z | gate``, the sLSTM FFN's ``u | g``), where
    the reference's column rule gives each position a whole branch: a
    position's region of it is a list of two regions, its span of each
    branch, bound concatenated (:func:`bind_leaf`) and its gradient added
    back half by half (:func:`region_blocks`).  The sLSTM's FFN splits its
    hidden units where ``n`` divides them, as a dense MLP does, else runs
    whole on the lead;
  * a MoE layer splits its experts whenever its expert leaves lie over the
    model axis (the training layout, ``src/repro/models/moe.py:104-112``);
    placed in the inference layout (``sharding._EXPERT_INFERENCE``) it is
    expert-stationary (:class:`StationaryLayout`): each data-parallel group's
    positions hold the group's block of the experts, or every expert where
    the layout leaves them whole, and each position its block of their
    hidden dim, and the layer runs across the groups (``models/moe.py``
    ``moe_stationary``), each position reading its own shard alone.  A MoE
    layer whose expert leaves lie in neither layout raises;
  * the embedding and the head split the vocabulary where it divides
    (``src/repro/models/lm.py:104``), the log-softmax then taken over the
    slices (``models/lm.py`` ``vocab_parallel_nll_sum``).

Anything else runs whole on the group's lead, its leaves gathered whole
there (an xLSTM block where ``n`` does not divide its heads, such as
``make_decode_2d_ctx``'s 8 positions).  A split layer's modules are handed
to ``models/attention.py``, ``common.py``, ``recurrent.py``, ``moe.py``
and ``xlstm.py`` as a ``common.Split`` (:func:`block_view`); an
expert-stationary layer's blocks as a ``moe.Stationary``
(:func:`bind_stationary`).

Sequence parallelism (``Plan.seq``): where ``ctx.seq_shard`` holds and the
step's sequence splits over the ``n`` positions (the reference's ``("dp",
"seq", None)`` residual constraint, sanitized), a training step's
residual stream lies by rows over the group (a ``common.Stream``),
position ``t`` holding rows ``[t S / n, (t + 1) S / n)`` of ``[B_g, S,
D]``: the embedding, the
norms, the residual adds and the final norm run on each position's rows,
the split layers all-gather their input over the sequence and
reduce-scatter their output, and the layers that run whole gather the
rows onto the lead and split their output back (``models/blocks.py``).
The norms' weights bind on the lead and are broadcast to the positions.
A decode step's one token does not split, so it never applies there.

The decode cache (:func:`place_caches`) follows the
reference's rule (``sharding.cache_spec``): an attention layer's k and v
over the group's positions by their time axis, each holding its slots of
every KV head (``attention.SeqKV``) where the positions divide the slot
count, an RG-LRU layer's state by its channels where they split, and a
split xLSTM block's states by its positions' heads (``_STATE_CUTS``: the
conv history by their channels of ``z`` or ``x``, the mLSTM's ``c``,
``n`` and ``m`` by heads, the sLSTM's ``c``, ``n``, ``m`` and ``h`` by
the heads' channels).  The rule cuts the mLSTM's ``c`` and ``n`` along
their head dim (``hd``) rather than by heads; both give a position 1/n of
each tensor, so the bytes a position holds are the rule's (ROADMAP D11).
Any other layer's cache, and one the positions do not divide, lies whole
on the group's lead.  A placed prefill lays out each layer's cache as its
block finishes (:func:`place_layer`).
"""

from __future__ import annotations

import dataclasses
import math
import types

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.collectives import Group
from repro_torch.models import attention as attn
from repro_torch.models import moe, xlstm
from repro_torch.models.common import Split

# the dim each split sublayer's leaves are cut along, and the span it takes
# ("q": q heads, "kv": KV heads, both in elements; "c": channels; "f": hidden
# units; "e": experts); a leaf not named (norms, the router) is bound whole
# on every position
_CUTS = {
    "attn": {"wq": (1, "q"), "bq": (0, "q"), "wk": (1, "kv"), "wv": (1, "kv"),
             "bk": (0, "kv"), "bv": (0, "kv"), "wo": (0, "q")},
    "rec": {"w_x": (1, "c"), "w_gate_branch": (1, "c"), "wi": (1, "c"), "wr": (1, "c"),
            "conv_w": (1, "c"), "conv_b": (0, "c"), "lam": (0, "c"), "bi": (0, "c"),
            "br": (0, "c"), "w_rnn_out": (0, "c")},
    "mlp": {"w_gate": (1, "f"), "w_in": (1, "f"), "w_out": (0, "f")},
    "moe": {"e_gate": (0, "e"), "e_in": (0, "e"), "e_out": (0, "e")},
    # an xLSTM block's cell, by kind ("h": heads; "c": their channels of z
    # or of x; "f": the sLSTM FFN's hidden units, where they split)
    "mlstm": {"up": (1, "c"), "conv_w": (1, "c"), "conv_b": (0, "c"), "wq": (1, "c"),
              "wk": (1, "c"), "wv": (1, "c"), "skip": (1, "c"), "wi": (1, "h"),
              "wf": (1, "h"), "bi": (0, "h"), "bf": (0, "h"), "down": (0, "c")},
    "slstm": {"conv_w": (1, "c"), "conv_b": (0, "c"), "wi": (1, "c"), "wf": (1, "c"),
              "wz": (1, "c"), "wo_gate": (1, "c"), "bi": (0, "c"), "bf": (0, "c"),
              "bz": (0, "c"), "bo": (0, "c"), "ri": (0, "h"), "rf": (0, "h"), "rz": (0, "h"),
              "ro": (0, "h"), "out_proj": (0, "c"), "up": (1, "f"), "down": (0, "f")},
}
# leaves that hold two branches side by side along their cut dim (an xLSTM
# block's up projection: z | gate, or the sLSTM FFN's u | g): a position
# binds its span of each, the two concatenated (:func:`bind_leaf`)
_BRANCHED = {"up"}
# the dim of each recurrent state that a split layer's positions cut, and
# the span that cuts it (the decode cache's layout, :func:`place_layer`)
_STATE_CUTS = {
    "rec": {"conv": (2, "c"), "h": (1, "c")},
    "mlstm": {"conv": (2, "c"), "c": (1, "h"), "n": (1, "h"), "m": (1, "h")},
    "slstm": {"conv": (2, "c"), "c": (1, "c"), "n": (1, "c"), "m": (1, "c"), "h": (1, "c")},
}
# the sublayer of a recurrent kind that splits
_STATE_SUB = {"rec": "rec", "mlstm": "cell", "slstm": "cell"}
_VOCAB_CUTS = {"embed": 0, "lm_head": 1}
# an expert-stationary MoE layer's leaves: the dims cut by the group's
# experts ("e") and by the position's hidden units ("f")
_EXPERT_CUTS = {"e_gate": {0: "e", 2: "f"}, "e_in": {0: "e", 2: "f"},
                "e_out": {0: "e", 1: "f"}}


@dataclasses.dataclass
class Plan:
    """A placed model's tensor-parallel layout at one step shape.

    ``regions[name][t]`` is the region (a slice a dim) of leaf ``name`` that
    tensor-parallel position ``t`` binds, or None where it binds nothing;
    ``layers[i]`` maps each split sublayer of block ``i`` (``"attn"``,
    ``"rec"``, ``"mlp"``, ``"moe"``) to the positions' configs and spans;
    ``vocab`` holds each position's vocabulary span, or is None where the
    embedding and the head run whole; ``seq`` whether the residual stream
    splits by sequence over the positions; ``stationary[i]`` block ``i``'s
    expert-stationary MoE layer, whose router and expert leaves bind
    nothing through ``regions``."""

    n: int
    regions: dict
    layers: list
    vocab: list | None
    seq: bool
    stationary: dict


@dataclasses.dataclass(frozen=True)
class StationaryLayout:
    """An expert-stationary MoE layer's layout: ``experts[g]`` the experts
    data-parallel group ``g`` holds (``sharding.dp_leads`` order; every
    expert where the layout leaves them whole), ``hidden[t]`` the ``d_ff``
    span tensor-parallel position ``t`` holds (None: it holds nothing, for
    ``d_ff`` whole on the lead), ``exchanges`` the sets of groups that trade
    tokens, as group indices in the order of their expert blocks (none
    where every group holds every expert)."""

    experts: list
    hidden: list
    exchanges: list

    def region(self, leaf: str, shape: tuple, g: int, t: int):
        """The region of expert leaf ``leaf`` (``e_gate``, ``e_in`` [E, D, F]
        or ``e_out`` [E, F, D]) that group ``g``'s position ``t`` binds, or
        None."""
        if self.hidden[t] is None:
            return None
        spans = {"e": self.experts[g], "f": self.hidden[t]}
        region = list(sh.whole(shape))
        for dim, what in _EXPERT_CUTS[leaf].items():
            region[dim] = slice(*spans[what])
        return tuple(region)


def _even(size: int, n: int, t: int) -> tuple[int, int]:
    return t * size // n, (t + 1) * size // n


def _attn_split(cfg: ModelConfig, n: int):
    """Each position's (config, spans) of a head-split attention, or None
    where its q heads, or the KV heads they read, do not split."""
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if h % n:
        return None
    hn, g = h // n, h // kvh
    if kvh % n and g % hn:
        return None
    out = []
    for t in range(n):
        h0, h1 = _even(h, n, t)
        k0, k1 = _even(kvh, n, t) if kvh % n == 0 else (h0 // g, h0 // g + 1)
        out.append((dataclasses.replace(cfg, n_heads=h1 - h0, n_kv_heads=k1 - k0),
                    {"q": (h0 * hd, h1 * hd), "kv": (k0 * hd, k1 * hd)}))
    return out


def _numel(leaves: dict, names) -> int:
    return sum(math.prod(leaves[n].shape) for n in names)


def plan(placed: sh.PlacedModel, ctx: sh.ShardCtx, x_shape: tuple[int, ...]) -> Plan:
    """The layout of ``placed`` under ``ctx`` for a step whose activations
    are ``x_shape`` (the module docstring); run under ``ctx``, whose
    ``tp_worthwhile`` it reads."""
    cfg, leaves = placed.cfg, placed.leaves
    n = len(sh.tp_peers(ctx, 0))
    layers, stationary = [], {}
    for i, kind in enumerate(cfg.layer_kinds):
        p, split = f"blocks.{i}.", {}
        if n > 1 and kind in ("attn", "win", "moe"):
            w = _numel(leaves, [f"{p}attn.{k}" for k in ("wq", "wk", "wv", "wo")])
            heads = _attn_split(cfg, n) if sh.tp_worthwhile(x_shape, w) else None
            if heads:
                split["attn"] = ([c for c, _ in heads], [s for _, s in heads])
        if n > 1 and kind == "rec" and leaves[f"{p}rec.w_x"].shape[1] % n == 0:
            r = leaves[f"{p}rec.w_x"].shape[1]
            spans = [{"c": _even(r, n, t)} for t in range(n)]
            split["rec"] = ([dataclasses.replace(cfg, lru_width=s["c"][1] - s["c"][0])
                             for s in spans], spans)
        if kind == "moe":
            layout = _moe_layout(leaves, p, ctx)
            if layout == "stationary":
                stationary[i] = _stationary(leaves[f"{p}moe.e_gate"], ctx, n)
            elif n > 1 and leaves[f"{p}moe.e_gate"].spec[0] == ctx.tp:
                e = leaves[f"{p}moe.e_gate"].shape[0]
                split["moe"] = ([cfg] * n, [{"e": _even(e, n, t)} for t in range(n)])
        if n > 1 and kind in ("mlstm", "slstm") and xlstm.N_HEADS % n == 0:
            split["cell"] = ([cfg] * n, _cell_spans(leaves, p, n))
        if n > 1 and kind in ("attn", "win", "rec"):
            mlp = [k for k in (f"{p}mlp.w_gate", f"{p}mlp.w_in", f"{p}mlp.w_out") if k in leaves]
            f = leaves[f"{p}mlp.w_in"].shape[1]
            if sh.tp_worthwhile(x_shape, _numel(leaves, mlp)) and f % n == 0:
                split["mlp"] = ([cfg] * n, [{"f": _even(f, n, t)} for t in range(n)])
        layers.append(split)
    vocab = None
    if n > 1 and cfg.vocab_size % n == 0:
        vocab = [_even(cfg.vocab_size, n, t) for t in range(n)]
    regions = {}
    for name, x in leaves.items():
        lead_only = [sh.whole(x.shape)] + [None] * (n - 1)
        regions[name] = lead_only
        parts = name.split(".")
        if parts[0] == "blocks" and parts[2] == "moe" and int(parts[1]) in stationary:
            regions[name] = [None] * n  # bound by bind_stationary
        elif parts[0] == "blocks" and parts[2] in layers[int(parts[1])]:
            i, sub = int(parts[1]), parts[2]
            spans = layers[i][sub][1]
            cut = _CUTS[cfg.layer_kinds[i] if sub == "cell" else sub].get(parts[3])
            if cut is None:
                regions[name] = [sh.whole(x.shape)] * n
            elif cut[1] in spans[0]:  # else (an sLSTM FFN that does not split) lead only
                branched = parts[3] in _BRANCHED
                regions[name] = [_cut(x.shape, cut[0], spans[t][cut[1]], branched)
                                 for t in range(n)]
        elif name in _VOCAB_CUTS and vocab is not None:
            regions[name] = [_cut(x.shape, _VOCAB_CUTS[name], vocab[t]) for t in range(n)]
    seq = n > 1 and ctx.seq_shard and len(x_shape) == 3 and x_shape[1] % n == 0
    return Plan(n, regions, layers, vocab, seq, stationary)


def _moe_layout(leaves: dict, p: str, ctx: sh.ShardCtx) -> str:
    """``"training"`` where block ``p``'s expert leaves lie as the training
    rules lay them out under ``ctx`` (also where both layouts leave every
    dim whole), ``"stationary"`` where they lie as the inference rules do;
    raises for any other layout."""
    for layout, inference in (("training", False), ("stationary", True)):
        if all(leaves[f"{p}moe.{k}"].spec == sh.rule_spec(k, leaves[f"{p}moe.{k}"].shape, ctx,
                                                          inference=inference)
               for k in _EXPERT_CUTS):
            return layout
    specs = {k: leaves[f"{p}moe.{k}"].spec for k in _EXPERT_CUTS}
    raise ValueError(f"{p}moe: expert leaves laid out {specs}, which is neither the training "
                     "nor the inference layout under this ctx")


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _stationary(e_gate: sh.Sharded, ctx: sh.ShardCtx, n: int) -> StationaryLayout:
    """The layout of an expert-stationary layer from its ``e_gate`` [E, D, F]
    (``e_in`` and ``e_out`` follow the same rules): the experts over the
    axes of dim 0, which must be data-parallel axes, and ``d_ff`` over the
    ctx's tensor-parallel axes, each where the layout splits it."""
    mesh, (e, _, f) = ctx.mesh, e_gate.shape
    e_axes, f_axes = _axes(e_gate.spec[0]), _axes(e_gate.spec[2])
    if not set(e_axes) <= set(ctx.dp):
        raise ValueError(f"experts over {e_axes}: expert-stationary decode trades tokens "
                         f"between data-parallel groups, over {ctx.dp}")
    if f_axes and f_axes != sh.tp_axes(ctx):
        raise ValueError(f"d_ff over {f_axes}, not the tensor-parallel axes {ctx.tp}")
    leads = sh.dp_leads(ctx)
    n_e = sh._axis_prod(mesh, e_gate.spec[0])
    experts = []
    for lead in leads:
        at = dict(zip(mesh.axis_names, sh.coords(mesh, lead)))
        experts.append(_even(e, n_e, sh._entry_index(mesh, at, e_gate.spec[0])))
    hidden = ([_even(f, n, t) for t in range(n)] if f_axes
              else [(0, f)] + [None] * (n - 1))
    exchanges = []
    if n_e > 1:
        for lead in leads:
            idx = [leads.index(q) for q in sh.axis_group(mesh, lead, e_axes)]
            if idx not in exchanges:
                exchanges.append(idx)
    return StationaryLayout(experts, hidden, exchanges)


def _cut(shape, dim: int, span: tuple[int, int], branched: bool = False):
    """The region of a leaf of ``shape`` cut along ``dim`` to ``span``; of a
    leaf of two branches, the list of its two regions, ``span`` of each."""
    if branched:
        half = shape[dim] // 2
        return [_cut(shape, dim, (half * b + span[0], half * b + span[1])) for b in (0, 1)]
    region = list(sh.whole(shape))
    region[dim] = slice(*span)
    return tuple(region)


def _cell_spans(leaves: dict, p: str, n: int) -> list[dict]:
    """Each position's spans of block ``p``'s xLSTM cell: its heads
    (``"h"``), their channels (``"c"``: of ``z`` in an mLSTM, of ``x`` in
    an sLSTM) and, where ``n`` divides the sLSTM FFN's hidden units, its
    share of them (``"f"``)."""
    width = leaves[f"{p}cell.conv_w"].shape[1]
    hd, heads = width // xlstm.N_HEADS, xlstm.N_HEADS
    ffn = leaves[f"{p}cell.down"].shape[0] if f"{p}cell.out_proj" in leaves else 0
    spans = []
    for t in range(n):
        h0, h1 = _even(heads, n, t)
        spans.append({"h": (h0, h1), "c": (h0 * hd, h1 * hd)})
        if ffn and ffn % n == 0:
            spans[-1]["f"] = _even(ffn, n, t)
    return spans


def bind_leaf(x: sh.Sharded, region, pos: int, bind) -> torch.Tensor:
    """Leaf ``x``'s ``region`` on position ``pos`` through ``bind``
    (``sharding.gather_region`` or ``bind_region``); a branched leaf's two
    regions concatenated along their last dim."""
    if isinstance(region, list):
        return torch.cat([bind(x, r, pos) for r in region], dim=-1)
    return bind(x, region, pos)


def region_blocks(region, block: torch.Tensor) -> list[tuple]:
    """``(region, block)`` pairs of a bound leaf's gradient ``block``: one,
    or a branched leaf's two halves, each with its region."""
    if isinstance(region, list):
        return list(zip(region, block.chunk(len(region), dim=-1)))
    return [(region, block)]


def group(placed: sh.PlacedModel, ctx: sh.ShardCtx, lead: int) -> Group:
    """The positions of ``lead``'s data-parallel group, in tp order."""
    return Group.along(placed.mesh, lead, sh.tp_axes(ctx))


def block_view(skels: list, i: int, p: Plan, grp: Group):
    """Block ``i`` as ``models/blocks.py`` reads it: the lead skeleton's
    bound modules, each split sublayer a ``Split`` over every position's
    skeleton.  Built while the block's leaves are bound."""
    lead = skels[0].blocks[i]
    view = types.SimpleNamespace(kind=lead.kind, group=grp)
    for name in ("norm1", "norm2", "attn", "rec", "mlp", "moe", "cell"):
        if hasattr(lead, name):
            setattr(view, name, getattr(lead, name))
    for sub, (cfgs, spans) in p.layers[i].items():
        span = [s["e"] for s in spans] if sub == "moe" else spans
        setattr(view, sub, Split([getattr(s.blocks[i], sub) for s in skels], grp, cfgs, span))
    return view


def bind_stationary(placed: sh.PlacedModel, p: Plan, i: int, groups: list) -> moe.Stationary:
    """Block ``i``'s expert-stationary MoE layer bound for every
    data-parallel group ``groups`` at once: each group's router on its
    lead, and each position's experts and ``d_ff`` block
    (:meth:`StationaryLayout.region`), which is exactly the shard it holds, so
    that nothing is copied (``sharding.bind_region``)."""
    st, pre = p.stationary[i], f"blocks.{i}.moe."
    leaves = {k: placed.leaves[pre + k] for k in _EXPERT_CUTS}
    router = placed.leaves[pre + "router"]
    parts, held = [], []
    for g, grp in enumerate(groups):
        ts = [t for t in range(p.n) if st.hidden[t] is not None]
        parts.append([{k: sh.bind_region(x, st.region(k, x.shape, g, t), grp.positions[t])
                       for k, x in leaves.items()} for t in ts])
        held.append(Group(tuple(grp.positions[t] for t in ts), tuple(grp.devices[t] for t in ts)))
    exchanges = [(idx, Group(tuple(groups[g].positions[0] for g in idx),
                             tuple(groups[g].devices[0] for g in idx)))
                 for idx in st.exchanges]
    routers = [sh.bind_region(router, sh.whole(router.shape), grp.positions[0]) for grp in groups]
    return moe.Stationary(routers, parts, held, exchanges)


def _layer_layout(p: Plan, ctx: sh.ShardCtx, i: int, kind: str, layer: dict,
                  batch: int) -> str:
    """How a group's cache of layer ``i`` lies over its positions by
    ``sharding.cache_spec`` on the global cache (``batch`` rows): ``"seq"``
    (k and v by slots), ``"split"`` (a recurrent state by the spans of the
    positions' channels or heads, ``_STATE_CUTS``) or ``"lead"``.  An
    RG-LRU state splits where the rule splits its channels; an xLSTM state
    wherever its block splits by heads, which cuts each state into the
    same bytes as the rule (D11: the rule cuts the mLSTM's ``c`` and ``n``
    along the head dim, ``hd``, not by heads)."""
    if p.n > 1 and kind in ("attn", "win", "moe"):
        if sh.cache_spec("k", (batch, *layer["k"].shape[1:]), ctx)[1] is not None:
            return "seq"
    if p.n > 1 and kind == "rec":
        if sh.cache_spec("conv", (batch, *layer["conv"].shape[1:]), ctx)[2] is not None:
            if "rec" not in p.layers[i]:
                raise ValueError(f"layer {i}: the cache rule splits the RG-LRU state's channels, "
                                 "the plan does not")
            return "split"
    if kind in ("mlstm", "slstm") and "cell" in p.layers[i]:
        return "split"
    return "lead"


def place_caches(p: Plan, cfg: ModelConfig, ctx: sh.ShardCtx, cache: list, grp: Group,
                 batch: int, make) -> list:
    """One group's decode cache from ``cache``, its rows of each layer's
    whole cache (any device), laid out over its positions ``grp`` (the
    module docstring): a layer an entry, an ``attention.SeqKV`` of the
    positions' slots, a list of the positions' pieces of a recurrent state
    (by ``_STATE_CUTS``), or the layer's dict on the lead.  ``batch`` is the
    global batch the rule reads; ``make(t, device)`` makes each position's
    piece from its slice ``t`` of ``cache`` (a copy, or zeros of a ``meta``
    slice's shape)."""
    return [place_layer(p, ctx, i, kind, layer, grp, batch, make)
            for i, (kind, layer) in enumerate(zip(cfg.layer_kinds, cache))]


def place_layer(p: Plan, ctx: sh.ShardCtx, i: int, kind: str, layer, grp: Group,
                batch: int, make):
    """Layer ``i``'s entry of :func:`place_caches` from ``layer``, the group's
    rows of its whole cache, or of a split recurrent layer a list of the
    positions' pieces of it (a split prefill's state): kept on their
    positions where the layout cuts the state into the same spans, else
    gathered whole first."""
    pieces = layer if isinstance(layer, list) else None
    if pieces is not None:
        cuts = _STATE_CUTS[kind]
        layer = {k: v.new_empty(_joined(k, cuts, pieces), device="meta")
                 for k, v in pieces[0].items()}
    how = _layer_layout(p, ctx, i, kind, layer, batch)
    spans = p.layers[i][_STATE_SUB[kind]][1] if how == "split" else None
    if pieces is not None:
        if how == "split" and all(q[k].shape == _piece(v, kind, k, s).shape
                                  for q, s in zip(pieces, spans) for k, v in layer.items()):
            return [{k: make(v, d) for k, v in q.items()} for q, d in zip(pieces, grp.devices)]
        layer = {k: col.all_gather([q[k] for q in pieces], grp, dim=cuts[k][0])
                 for k in pieces[0]}
    if how == "seq":
        tn = layer["k"].shape[1] // p.n
        return attn.SeqKV([{k: make(v.narrow(1, t * tn, tn), d) for k, v in layer.items()}
                           for t, d in enumerate(grp.devices)], grp)
    if how == "split":
        return [{k: make(_piece(v, kind, k, s), d) for k, v in layer.items()}
                for s, d in zip(spans, grp.devices)]
    return {k: make(v, grp.devices[0]) for k, v in layer.items()}


def _piece(v: torch.Tensor, kind: str, k: str, spans: dict) -> torch.Tensor:
    """A position's piece of state ``k`` of a ``kind`` layer, by its spans."""
    dim, what = _STATE_CUTS[kind][k]
    return v.narrow(dim, spans[what][0], spans[what][1] - spans[what][0])


def _joined(k: str, cuts: dict, pieces: list) -> tuple:
    """The shape of state ``k`` whole from the positions' ``pieces``."""
    d = cuts[k][0]
    shape = list(pieces[0][k].shape)
    shape[d] = sum(q[k].shape[d] for q in pieces)
    return tuple(shape)
