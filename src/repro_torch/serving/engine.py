"""Paged-KV serving engine on a leap pool: decode reads through the block
table, appends mark in-flight blocks dirty, and KV blocks leap-migrate
between regions *while decoding continues* — the serving-side integration
of the paper's technique (DESIGN.md §4).

One page = one token-range across ALL layers: payload
``[L, 2, BLK, kv_heads, head_dim]`` (so migrating a sequence is one area).
The decode hot loop goes through ``repro_torch.kernels.ops.paged_decode_partial``:
the hand-written CUDA kernel on the card, its plain version on the CPU.  Each
layer hands the kernel a strided view of its own slice of every slot, and
the new token's K/V is written into the pool in place through that view.
A decode step is one program per batch size, as the JAX package compiles
one per batch size: on the card one captured CUDA graph, replayed every
step after its block tables, lengths and tokens are copied into its static
inputs (see :mod:`repro_torch.core.graphs`); on the CPU it runs eagerly.
Supported stacks: uniform global-attention patterns, each layer's FFN dense
(``attn``) or a mixture of experts (``moe``).

Regions are logical rows of one pool on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import LeapHandle, Move
from repro_torch.configs.base import ModelConfig
from repro_torch.core import LeapConfig, MigrationDriver, PoolConfig, graphs, init_state
from repro_torch.core.state import REGION, SLOT, _default_device, state_tensors
from repro_torch.kernels import ops, paged_attn
from repro_torch.models.attention import _project_qkv
from repro_torch.models.blocks import ffn_forward
from repro_torch.models.common import rms_norm, rope_cos_sin
from repro_torch.models.lm import CausalLM
from repro_torch.obs.metrics import LATENCY_TICK_BUCKETS, Histogram


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    block_tokens: int = 16
    max_blocks_per_seq: int = 64
    n_regions: int = 2
    slots_per_region: int = 256
    leap: LeapConfig = dataclasses.field(default_factory=LeapConfig)
    # Optional NumaTopology over the KV regions: admission fallback prefers
    # regions near the sequence's home and the driver schedules migrations
    # link-aware (§7).
    topology: object = None
    # Two-tier KV pool: G small pages per huge block (1 = small only).  With
    # G > 1 logical page ids are handed to sequences in aligned groups of G,
    # so a long sequence's KV forms promotable runs; decode auto-promotes
    # every complete group behind the append frontier.
    huge_factor: int = 1
    auto_promote: bool = True
    # Eager mode also promotes the group holding the append frontier once all
    # its ids belong to the sequence (appends then dirty an in-flight huge
    # block, which the driver's §4.2 demotion rule handles).
    promote_eager: bool = False
    # Migration scheduler policy for the KV pool's driver: "leap" (default),
    # "sync", or a SchedulerPolicy instance.
    scheduler: object = "leap"


@dataclasses.dataclass
class Sequence:
    sid: int
    region: int
    length: int
    block_ids: list[int]  # logical leap block ids, in order
    tokens: list[int]
    tenant: str = "default"  # serving class (SLO/metrics attribution)
    promoted: set = dataclasses.field(default_factory=set)  # huge group ids


class PagedEngine:
    """Batched decode over a migration-managed paged KV cache.

    ``model`` is a :class:`~repro_torch.models.lm.CausalLM` on ``device``
    (the current CUDA device by default; raises without one).
    """

    def __init__(self, cfg: ModelConfig, model: CausalLM, pcfg: PagedConfig, device=None):
        for kind in cfg.layer_pattern + cfg.tail_pattern:
            if kind not in ("attn", "moe"):
                raise ValueError(
                    f"PagedEngine supports uniform global-attention stacks; "
                    f"{cfg.name} has kind {kind!r} (serve via contiguous path)"
                )
        if cfg.tail_pattern:
            raise ValueError("PagedEngine expects a pure periodic stack")
        self.device = _default_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the engine on {self.device}")
        self.cfg = cfg
        self.model = model
        self.pcfg = pcfg
        payload = (cfg.n_layers, 2, pcfg.block_tokens, cfg.n_kv_heads, cfg.head_dim)
        G = pcfg.huge_factor
        self.pool_cfg = PoolConfig(
            pcfg.n_regions,
            pcfg.slots_per_region,
            payload,
            cfg.dtype(),
            huge_factor=G,
            topology=pcfg.topology,
        )
        # Pages occupy half the physical slots; the other half is the pooled
        # migration headroom.  With a huge tier, the per-region page count
        # rounds down to whole groups so no aligned logical group straddles a
        # region.
        pages_per_region = (pcfg.slots_per_region // 2 // G) * G
        n_blocks = pcfg.n_regions * pages_per_region
        placement = np.repeat(np.arange(pcfg.n_regions), pages_per_region)
        state = init_state(self.pool_cfg, n_blocks, placement.astype(np.int32), self.device)
        self.driver = MigrationDriver(state, self.pool_cfg, pcfg.leap, scheduler=pcfg.scheduler)
        # The engine drives migration exclusively through the handle-based
        # session API; the sealed facade is its only placement view.
        self.session = self.driver.default_session()
        self.facade = self.session.facade
        if G > 1:
            n_groups = n_blocks // G
            groups_per_region = pages_per_region // G
            self._group_free: list[list[int]] = [
                list(range(g * G, (g + 1) * G)) for g in range(n_groups)
            ]
            self._free_groups: list[list[int]] = [
                list(range(r * groups_per_region, (r + 1) * groups_per_region))
                for r in range(pcfg.n_regions)
            ]
            self._partial: set[int] = set()  # groups with some (not all) ids free
            self._seq_spare: dict[int, list[int]] = {}  # sid -> reserved unused ids
        else:
            self._free_blocks: list[list[int]] = [
                list(range(r * pages_per_region, (r + 1) * pages_per_region))
                for r in range(pcfg.n_regions)
            ]
        self.n_pages = n_blocks
        self.seqs: dict[int, Sequence] = {}
        self._next_sid = 0
        self.last_logits: torch.Tensor | None = None  # the latest decode step's [B, V]
        # The decode step: one variant per decode batch size (on the card one
        # captured graph; the prefill has set cuBLAS up by then).  Callers
        # that vary the batch size should chunk it to powers of two
        # (repro_torch.load does) to bound the variant count.
        self._decode_step = graphs.Program("decode_step")
        self._decode_shapes: set[int] = set()  # observed decode batch sizes
        # The prefill: one variant per prompt length, as the JAX engine jits
        # one per length (its ``_prefill_fns``), each bound to the model's
        # parameters; the first call of a length runs eagerly, then captures.
        self._prefill = graphs.Program("prefill", eager_first=True)
        self._weights = list(model.parameters()) + list(model.buffers())
        if self.device.type == "cuda":
            # the paged-decode kernel's tickets for every batch this pool can
            # hold (a sequence holds at least one page), outside any graph
            paged_attn.reserve_tickets(self.device,
                                       graphs.capture_stream(self.device).cuda_stream,
                                       n_blocks * cfg.n_kv_heads)
        # sid -> the handle of its latest rebalance (latency attribution)
        self._rebalance_handles: dict[int, LeapHandle] = {}
        # Per-tenant serving metrics (see telemetry()).
        self._tenant_lat: dict[str, Histogram] = {}
        self._tenant_mig_bytes: dict[str, int] = {}
        self._tenant_tokens: dict[str, int] = {}

    # -- admission ---------------------------------------------------------------

    def _alloc_order(self, region: int) -> list[int]:
        """Allocation fallback order: the home region first, then — with a
        topology — the others nearest-first, else index order."""
        topo = self.pool_cfg.topology
        if topo is not None:
            return [region] + topo.nearest(region)
        return [region] + [x for x in range(self.pcfg.n_regions) if x != region]

    def _alloc_block(self, region: int, sid: int | None = None) -> int:
        if self.pcfg.huge_factor == 1:
            for r in self._alloc_order(region):
                if self._free_blocks[r]:
                    return self._free_blocks[r].pop()
            raise RuntimeError("KV pool exhausted")
        # Tiered pool: spend the sequence's reserved group first, then break a
        # fresh aligned group, then scavenge loose ids from partial groups.
        spare = self._seq_spare.get(sid)
        if spare:
            return spare.pop(0)
        for r in self._alloc_order(region):
            if self._free_groups[r]:
                g = self._free_groups[r].pop()
                ids = sorted(self._group_free[g])
                self._group_free[g] = []
                if sid is not None:
                    self._seq_spare.setdefault(sid, []).extend(ids[1:])
                else:
                    self._partial.add(g)
                    self._group_free[g] = ids[1:]
                return ids[0]
        for g in sorted(self._partial):
            ids = self._group_free[g]
            if ids:
                b = ids.pop()
                if not ids:
                    self._partial.discard(g)
                return b
        raise RuntimeError("KV pool exhausted")

    def _return_block(self, b: int) -> None:
        """Release one logical id back to the group-aligned pool."""
        G = self.pcfg.huge_factor
        g = b // G
        ids = self._group_free[g]
        ids.append(b)
        if len(ids) == G:
            self._partial.discard(g)
            region = int(self.facade.region_of(g * G))
            self._free_groups[region].append(g)
        else:
            self._partial.add(g)

    @torch.no_grad()
    def admit(self, prompt, region: int = 0, tenant: str = "default") -> int:
        """Prefill a prompt, install its pages, and emit the first generated
        token from the prefill logits (``seqs[sid].tokens[-1]``).  Subsequent
        tokens come from ``decode()``, which processes the latest generated
        token at position ``length``."""
        cfg, blk = self.cfg, self.pcfg.block_tokens
        prompt = np.asarray(prompt)
        s, model = len(prompt), self.model
        # the logits and the cache are the graph's own: used here, before the
        # next prefill of this length replays over them
        logits, k, v = self._prefill(
            s, lambda t: _prefill_pages(model, t, s),
            [torch.from_numpy(prompt.astype(np.int64))[None]], self._weights, device=self.device)
        first_tok = int(torch.argmax(logits, -1)[0])
        sid = self._next_sid
        self._next_sid += 1
        seq = Sequence(sid, region, s, [], list(map(int, prompt)) + [first_tok], tenant=tenant)
        n_blocks = (s + blk - 1) // blk
        for j in range(n_blocks):
            b = self._alloc_block(region, sid)
            seq.block_ids.append(b)
            lo, hi = j * blk, min((j + 1) * blk, s)
            page = torch.zeros(self.pool_cfg.block_shape, dtype=cfg.dtype(), device=self.device)
            page[:, 0, : hi - lo] = k[:, lo:hi]
            page[:, 1, : hi - lo] = v[:, lo:hi]
            self.driver.write(np.asarray([b]), page[None])
        self.seqs[sid] = seq
        return sid

    def release(self, sid: int) -> None:
        seq = self.seqs.pop(sid)
        if self.pcfg.huge_factor == 1:
            regions = self.facade.region_of(np.asarray(seq.block_ids, np.int64))
            for b, r in zip(seq.block_ids, regions):
                self._free_blocks[int(r)].append(b)
            return
        for b in seq.block_ids + self._seq_spare.pop(sid, []):
            self._return_block(b)

    # -- decode -------------------------------------------------------------------

    def _tables(self, sids):
        """Block tables ``[B, MAXB]`` and lengths ``[B]``, int32 on the host."""
        maxb = self.pcfg.max_blocks_per_seq
        tab = np.zeros((len(sids), maxb), np.int32)
        lens = np.zeros((len(sids),), np.int32)
        for i, sid in enumerate(sids):
            seq = self.seqs[sid]
            tab[i, : len(seq.block_ids)] = seq.block_ids
            lens[i] = seq.length
        return tab, lens

    @torch.no_grad()
    def decode(self, sids: list[int], greedy: bool = True) -> list[int]:
        """One token for each sequence in ``sids``; appends in place.  The
        argmax that brings the tokens to the host is the step's one sync."""
        blk = self.pcfg.block_tokens
        # allocate next block where needed, BEFORE the step
        for sid in sids:
            seq = self.seqs[sid]
            if seq.length % blk == 0 and seq.length // blk >= len(seq.block_ids):
                seq.block_ids.append(self._alloc_block(seq.region, sid))
            self._maybe_promote(seq)
        tables, lens = self._tables(sids)
        if self.driver.ctx.heat is not None:
            # attention reads every page behind the frontier: feed the whole
            # working set into the heat plane (folds into the next tick's
            # megastep, no extra dispatch, DESIGN.md §13)
            self.driver.note_reads(
                np.concatenate([np.asarray(self.seqs[s].block_ids, np.int32) for s in sids])
            )
        toks = np.asarray([[self.seqs[s].tokens[-1]] for s in sids], np.int64)
        self._decode_shapes.add(len(sids))
        state, model, cfg = self.driver.state, self.model, self.cfg
        logits = self._decode_step(
            len(sids),
            lambda t, le, k: _paged_step(model, state, t, le, k, cfg, blk),
            [torch.from_numpy(a) for a in (tables, lens, toks)],
            state_tensors(state),
        )
        self.last_logits = logits.clone()  # a replay's logits are the graph's own
        out = torch.argmax(self.last_logits, -1).cpu().tolist()
        for i, sid in enumerate(sids):
            seq = self.seqs[sid]
            seq.tokens.append(int(out[i]))
            seq.length += 1
        return [int(t) for t in out]

    # -- tier promotion -----------------------------------------------------------

    def _maybe_promote(self, seq: Sequence) -> None:
        """Promote the sequence's complete aligned groups to huge blocks.

        A group is promotable once every member belongs to this sequence and
        sits strictly behind the append frontier (decode only ever writes the
        last block, so promoted KV is cold by construction); the driver
        re-checks residency/coldness and allocates the contiguous run.
        """
        G = self.pcfg.huge_factor
        if G == 1 or not self.pcfg.auto_promote:
            return
        pool = seq.block_ids if self.pcfg.promote_eager else seq.block_ids[:-1]
        if len(pool) < G:
            return
        ids = np.asarray(pool, np.int64)
        groups, counts = np.unique(ids // G, return_counts=True)
        for g, c in zip(groups, counts):
            g = int(g)
            if c != G or g in seq.promoted:
                continue
            if self.driver.tiers.tier[g] or self.driver.promote_group(g):
                seq.promoted.add(g)

    # -- migration ------------------------------------------------------------------

    def decide(self, facade) -> list[Move]:
        """:class:`repro_torch.api.PlacementPolicy`: sequence affinity as moves.

        Every live sequence's KV pages should sit on its declared home
        region; any page observed elsewhere yields one move tagged with the
        sequence id.  Policy only — the session owns the mechanism.
        """
        moves = []
        for sid, seq in self.seqs.items():
            if not seq.block_ids:
                continue
            ids = np.asarray(seq.block_ids, np.int32)
            if (facade.region_of(ids) != seq.region).any():
                moves.append(Move(ids, seq.region, tag=sid))
        return moves

    def rebalance(self, sid: int, dst_region: int) -> LeapHandle:
        """Leap-migrate a live sequence's pages to another region.

        Declares the sequence's new home and lets the engine's own placement
        policy (:meth:`decide`) drive the session; returns the
        :class:`LeapHandle` tracking this sequence's move.
        """
        seq = self.seqs[sid]
        seq.region = dst_region
        # Strict-home policy: reroute=False so the session never spills the
        # pages to neighbouring regions.
        handle = None
        for h in self.session.apply(self, reroute=False):
            if h.tag == sid:
                handle = h
                break
        if handle is None:
            # Every page already home: a vacuous (instantly complete) handle.
            handle = self.session.leap(np.asarray(seq.block_ids, np.int32), dst_region, tag=sid)
        self._rebalance_handles[sid] = handle
        tenant = seq.tenant
        handle.on_done(lambda h: self._account_migration(tenant, h))
        return handle

    def _account_migration(self, tenant: str, handle: LeapHandle) -> None:
        """Attribute a resolved rebalance's moved bytes to its tenant."""
        p = handle.progress()
        moved = (p.committed + p.forced) * self.pool_cfg.block_bytes
        self._tenant_mig_bytes[tenant] = self._tenant_mig_bytes.get(tenant, 0) + moved

    def rebalance_handles(self) -> list:
        """The latest rebalance handle per sequence (live and resolved)."""
        return list(self._rebalance_handles.values())

    def rebalance_latency(self, sid: int):
        """Latency breakdown of ``sid``'s latest :meth:`rebalance`, or None when
        the sequence was never rebalanced or telemetry is off."""
        handle = self._rebalance_handles.get(sid)
        return handle.latency() if handle is not None else None

    # -- tenants / capacity ---------------------------------------------------------

    def observe_tokens(self, tenant: str, latencies) -> None:
        """Record per-token latencies (caller-chosen units) into the tenant's
        histogram."""
        hist = self._tenant_lat.get(tenant)
        if hist is None:
            hist = self._tenant_lat[tenant] = Histogram(LATENCY_TICK_BUCKETS)
        vals = np.atleast_1d(np.asarray(latencies, np.float64))
        for v in vals:
            hist.observe(v)
        self._tenant_tokens[tenant] = self._tenant_tokens.get(tenant, 0) + len(vals)

    def tenant_stats(self) -> dict:
        """Per-tenant snapshot: tokens observed, migration bytes, latency
        histogram dict (empty entries omitted)."""
        out: dict[str, dict] = {}
        tenants = set(self._tenant_tokens) | set(self._tenant_mig_bytes)
        tenants.update(s.tenant for s in self.seqs.values())
        for t in sorted(tenants):
            hist = self._tenant_lat.get(t)
            out[t] = {
                "tokens": self._tenant_tokens.get(t, 0),
                "migration_bytes": self._tenant_mig_bytes.get(t, 0),
                "latency": hist.to_dict() if hist is not None else None,
            }
        return out

    def free_pages(self) -> int:
        """Logical pages a NEW sequence could allocate right now (per-sequence
        reserved spares excluded)."""
        if self.pcfg.huge_factor == 1:
            return sum(len(f) for f in self._free_blocks)
        G = self.pcfg.huge_factor
        n = sum(len(g) for g in self._free_groups) * G
        n += sum(len(self._group_free[g]) for g in self._partial)
        return n

    def page_accounting(self) -> dict:
        """Page-closure snapshot: ``used + spare + free == total``, with
        per-tenant held pages."""
        used = sum(len(s.block_ids) for s in self.seqs.values())
        spare = (
            0 if self.pcfg.huge_factor == 1 else sum(len(v) for v in self._seq_spare.values())
        )
        per_tenant: dict[str, int] = {}
        for s in self.seqs.values():
            per_tenant[s.tenant] = per_tenant.get(s.tenant, 0) + len(s.block_ids)
        return {
            "total": self.n_pages,
            "used": used,
            "spare": spare,
            "free": self.free_pages(),
            "per_tenant": per_tenant,
        }

    def _tenant_series(self, reg) -> None:
        """Extra-series hook: co-expose the tenant store in driver scrapes."""
        for t, hist in sorted(self._tenant_lat.items()):
            reg.histogram("leap_tenant_token_latency", hist, labels={"tenant": t})
        for t, nbytes in sorted(self._tenant_mig_bytes.items()):
            reg.counter("leap_tenant_migration_bytes_total", nbytes, labels={"tenant": t})
        for t, n in sorted(self._tenant_tokens.items()):
            reg.counter("leap_tenant_tokens_total", n, labels={"tenant": t})

    def telemetry(self):
        """The KV pool's :class:`repro_torch.obs.TelemetryView`, extended with
        the engine's per-tenant series."""
        return self.session.telemetry().with_extra(self._tenant_series)

    def tick(self) -> None:
        self.session.tick()

    def drain(self) -> bool:
        return self.session.drain()


def _prefill_pages(model: CausalLM, toks: torch.Tensor, s: int):
    """The prefill program: a prompt ``[1, S]`` -> (last-token logits [1, V],
    k, v each ``[L, S, KVH, hd]``)."""
    logits, cache = model.prefill(toks, s)
    k = torch.stack([c["k"][0] for c in cache])
    v = torch.stack([c["v"][0] for c in cache])
    return logits, k, v


def _paged_step(model: CausalLM, state, tables, lens, toks, cfg: ModelConfig, blk: int):
    """One decode token through paged attention for every layer.

    Layer ``li`` reads ``pool[:, :, li]`` as a strided ``[R*S, 2, BLK, KVH, hd]``
    view; the new token's K/V lands in the pool through that view before the
    layer attends, so nothing copies the pool.  The table does not change
    inside a step, so every layer's append hits the same ``(region, slot)``.
    The step ends with the write trap, ``dirty |= in_flight`` on the appended
    pages, exactly once.
    """
    b = toks.shape[0]
    x = model.embed_tokens(toks)
    pos = lens.long()  # per-sequence position (tokens cached so far)
    s_per = state.pool.shape[1]
    loc = state.table[tables.reshape(-1).long()].long()  # [(B*MAXB), 2]
    flat = (loc[:, REGION] * s_per + loc[:, SLOT]).to(torch.int32).reshape(tables.shape)
    pool_flat = state.pool.view((-1,) + tuple(state.pool.shape[2:]))  # [R*S, L, 2, BLK, KVH, hd]
    rows = torch.arange(b, device=toks.device)
    append_block = tables.long()[rows, pos // blk]
    append_loc = state.table[append_block].long()
    append_slot = append_loc[:, REGION] * s_per + append_loc[:, SLOT]
    offset = pos % blk
    attend_lens = lens + 1
    rope = rope_cos_sin(pos[:, None], cfg.head_dim, cfg.rope_theta)  # the same for every layer
    for li, blk_mod in enumerate(model.blocks):
        h = rms_norm(x, blk_mod.norm1, cfg.norm_eps)
        q, k, v = _project_qkv(h, blk_mod.attn, cfg, pos[:, None], rope)
        kv_l = pool_flat[:, li]  # strided view [R*S, 2, BLK, KVH, hd]
        kv_l[append_slot, :, offset] = torch.stack([k[:, 0], v[:, 0]], dim=1).to(kv_l.dtype)
        out, _, _ = ops.paged_decode_partial(
            q[:, 0], kv_l, flat, attend_lens, kv_heads=cfg.n_kv_heads, softcap=cfg.attn_softcap
        )
        x = x + out.reshape(b, 1, -1) @ blk_mod.attn.wo
        h2 = rms_norm(x, blk_mod.norm2, cfg.norm_eps)
        x = x + ffn_forward(h2, blk_mod, cfg)
    logits = model.lm_logits(x)[:, 0]
    state.dirty[append_block] = state.dirty[append_block] | state.in_flight[append_block]
    return logits
