#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises, and no result line is
printed):

1. Device and build: the card's name and power limit, then the port's CUDA
   kernels built from ``src/repro_torch/kernels/csrc`` with ``nvcc``.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the drains give it, with timings (median of CUDA-event times) of the
   kernel, the plain version and a PyTorch library call for the same
   function (timed here only; the port never calls it).  The heat scan
   takes two sample sets at K = 128 and 1,024: uniform over the blocks,
   drawn as a drain tick draws them, and skewed into two of its tiles.
3. A small-page drain through ``LeapSession``: 131,072 blocks of 64 KiB
   (8 GiB) from region 0 to region 1 under 64 random writes and 64 reads per
   tick, with tiering on and ``warm_dispatch`` (its steady-state megastep
   variants captured as CUDA graphs when the driver is built; the misses
   are printed); every write is mirrored into a device-side shadow.  Every
   megastep is one graph replay, and no tick may make the host wait for the
   card (sync debug mode raises), a capturing one included.  The captured
   graphs' memory pools, while the driver lives, stay within 1 GiB
   (printed; so after phases 4, 13, 16 and 35's drains).
4. The same drain on a two-tier pool (2 MiB huge blocks).
5. A small drain run twice, on the card (kernels) and on the CPU (plain
   versions), which must agree bit for bit (heat within 1e-6); the CPU
   path is the one the test suite holds against the JAX package.
6. The paged-decode kernel against its plain version on the card, on the
   layer-20 strided view of a 40-layer bf16 pool at granite_3_2b's decode
   shapes (bf16 within rtol 2e-2 and atol 2e-3, an f32 case with softcap 20
   within 2e-5, bit-identical run to run, and unchanged when the pad table
   entries point out of range), at mixed lens and at lens on the kernel's
   split boundaries, timed beside a gather plus
   ``scaled_dot_product_attention`` (timed here only; the port never calls it).
7. Serving at full width: granite_3_2b (40 layers, bf16, random weights from
   a seeded generator) through ``PagedEngine``: 8 prompts of 512 tokens,
   then 64 decode steps, once undisturbed and once while two sequences
   leap-migrate to the other region from step 1 on (``tick()`` before every
   step), their append frontier pages among the pages in flight.  Tokens
   and the last step's logits must be bit-identical between the two runs.
   Every decode step is one replay of the batch size's captured graph (so
   in phases 22, 23 and 31; phase 24, which copies every routing call to
   the host, runs with capture off).
8. The LRU-scan kernel against its plain version on the card at the
   recurrent prefill's shapes ([8, 2048, 4096] f32: bit-identical, and
   bit-identical run to run), a bf16 case within 2e-2 and an odd shape
   (T = 17, R = 96), timed beside its bound and the plain version (no single
   PyTorch call computes a linear recurrence, so there is no library time).
   Then at batch 1 ([1, 32768, 4096], recurrentgemma_9b's 32k prefill) in
   f32 (bit for bit) and bf16 (within 2e-2), and at phase 28's [4, 2048,
   4096] f32 (bit for bit): each timed beside its bound, with the plan the
   wrapper launched (CTAs, channels a CTA, stages, shared bytes, bytes in
   flight an SM).
9. recurrentgemma_9b at full width (38 layers, bf16, random weights from a
   seeded generator) through ``lm.prefill`` and ``lm.decode_step``: 8
   prompts of 2048 tokens, then 64 greedy decode steps, twice.  Finite
   logits, exactly one LRU-scan launch per ``rec`` layer in each prefill
   and none in decode, and the same tokens in both runs.
10. The reduced two-layer granite (f32, TF32 off) served on the card
   (kernels) and on the CPU (plain versions) under a live rebalance with
   blocking harvest: equal tokens, pools and logits within 1e-5.
11. The reduced recurrentgemma (f32, TF32 off, ``lru_width`` 128): prefill
   and 4 decode steps on the card (kernels) and on the CPU (plain
   versions): equal tokens, logits and every layer's cache within 1e-5.
12. The gather and scatter kernels (the ppermute backend's pack and unpack)
   against their plain versions on the card, bit for bit: on region 1's
   shard of a 2-region pool of 40,960 slots of 64 KiB f32 (a view at a
   storage offset) at 256 and 1,024 lanes, on the odd shape (5, 4, 64) in
   f32, bf16 and int32, and a scatter with duplicate ids (the last lane must
   win in each of 20 runs); timed beside their bound, their plain versions
   and ``index_select`` / ``index_copy_`` (timed here only).  The gather at
   256 and at 1,024 lanes is timed against ``index_select`` again in 7
   rounds, the order swapped every round.  The gather's bulk-copy pipeline
   is also held bit for bit, twice in a row, at 1, 3, 131, 132, 133, 256,
   257 and 1,024 lanes with a duplicate id on the shard, and at 256 and
   1,024 lanes on slots of 65,552 B f32 (a ragged last tile), 240 B bf16
   and 512 B int32, each at a 16-byte-aligned storage offset and one element
   off; a profiler trace names the kernel each path launches
   (``gather_bulk_kernel`` aligned, ``move_lanes_kernel``'s byte instance
   not).
13. A ppermute drain: 4 regions (a four-socket server) on ``make_region_mesh(4)``
   over the one card, 131,072 blocks of 64 KiB (8 GiB) in 40,960 slots a
   region (a 10 GiB pool), 32,768 starting in each region and all leaping to
   the next region at once, through the batched generation (one
   ``fused_copy_ppermute`` per region pair a tick, each program one graph
   replay), under 64 writes and 64 reads a tick; the checks of phase 3,
   gather and scatter launches equal,
   and the gather's launches, mean lanes a launch and their lane counts in
   bins.
14. A small ppermute drain on the card and on the CPU: bit for bit as in
   phase 5.
15. Megastep against batched on the card, same seed, blocking harvest: on a
   small-block pool with tiering, bit-identical pools and tables; on a
   two-tier pool, every block reads back, and the batched drain launches
   the run copy.  The two batched drains launch K1, K2 and K3.  Then
   megastep against legacy, on a small and on a two-tier pool: pools,
   tables and flags bit-identical, heat within 1e-6.  (Phase 5 also holds a
   legacy drain on the card against the same drain on the CPU.)
16. The contest (fig5's setup at the drains' size): the 8 GiB pool of phase
   3 leaves region 0 for region 1 under 64 writes and 64 reads a tick, four
   ways: ``page_leap`` through the megastep; through the legacy generation
   (``chunk_blocks`` 16); ``SyncResharder.migrate_driver`` (one blocking
   call while a live leap holds the first 4,096 blocks; its ``failed`` set
   must be exactly the busy set); and 64 ``AutoBalancer.scan_driver`` scans.
   No lost write in any arm; each records blocks moved, bytes copied and
   touched, programs a tick (each one graph replay) and wall time.  The
   resharder's captured force phases launch K1 (from the launch counts
   their captures recorded), and its graphs' pools stay within 1 GiB.
17. The tiering loop (fig11's shape): ``cxl_pooled(2, 1)``, 2 MiB huge
   blocks, 131,072 blocks of 64 KiB, half far; a working set of 512 far
   blocks read every tick rotates to 512 others at tick 80 of 160, with 64
   writes a tick; ``TieringPolicy.maybe_apply`` every tick.  Promotions and
   demotions happen, most of the rotated set ends near, no write is lost,
   and the ``tier_resident_bytes`` gauges cover the pool.
18. A failed-region drain: ``quad_socket``, 32,768 blocks of 64 KiB in each
   of 4 regions of 45,056 slots (an 11 GiB pool); ``drain_region`` empties
   region 3 by ``drain_plan`` under 64 writes and 64 reads a tick.
19. TPC-H Q1 and Q6 over a morsel store (fig8 at 1 GB): 33,554,432 rows of
   ``gen_lineitem`` in 16,384 morsels of 64 KiB, queried at rest (against
   the float64 numpy references within rtol 1e-3, and bit-identical when
   repeated), then every tick while all morsels leap from region 0 to 1
   under 16 ``L_ORDERKEY`` field writes a tick (bit-identical to the result
   at rest: the writer touches no column the queries read).
20. The chaos sweep: ``sample_spec`` seeds 0-7 (megastep, as sampled) and
   seed 2 under batched and legacy through ``ChaosDriver`` on the card and
   on the CPU (the same ``ChaosReport``, ``MigrationStats``,
   host table, pool, flags and shadow, bit for bit); the
   ``skip_quarantine`` sabotage caught on the card as a payload violation,
   and its serialized spec replayed to the same violation; a chaos
   ``serving`` scenario (the tiny two-layer model, through K4).
21. A chaos scenario at the failed-region drain's size: ``quad_socket``, 4
   regions of 45,056 slots of 64 KiB (11 GiB), 2 GiB of payload spread over
   them, every region's blocks leaping to the next under 64 writes a tick,
   with a congested link, a 512-block write burst, region 3's loss, a
   cancel storm and the topology restored; every standing invariant after
   every tick and event (payload every 8th tick, compared on the card), and
   ``check_final`` after the drain.  Prints the report, the wall seconds
   and the seconds in the checker.
22. granite_3_2b at full width (phase 7's deployment, ``scheduler="slo"``)
   served by ``LoadGenerator`` for 48 ticks: two tenants (512-token
   prompts; gold at 0.9 requests a tick, 32 tokens, SLO 2.5; batch at 0.6,
   64 tokens, SLO 10), two sequences churned to the other region every
   second tick, the structural invariants and the page accounting after
   every tick.  Twice: ``gen.report()`` and every sequence's tokens must be
   identical.  Then the reduced load run (``benchmarks/serving_slo.py``'s
   setting, f32, TF32 off) on the card and on the CPU: the same report,
   tick log, tokens and host table.

23. The MoE stacks at their published widths through ``PagedEngine`` on
   phase 7's pool (bf16, random weights from a seeded generator, the depth
   cut): qwen3_moe_235b_a22b with 8 of its 94 layers (128 experts top-8,
   expert d_ff 1536, QK-norm; 8 prompts of 512 tokens, 64 decode steps) and
   dbrx_132b with 4 of its 40 layers (16 experts top-4, expert d_ff 10752;
   16 steps), each once undisturbed and once while two sequences leap from
   step 1 on.  Tokens and the last step's logits bit-identical between the
   runs, one paged-decode launch per layer and step, peak under 60 GB; the
   picks that capacity drops at prefill and at decode are counted (at batch
   8 qwen3's decode capacity is 1).  Phase 6 also times the paged-decode
   kernel at both stacks' decode shapes.
24. The reduced qwen3_moe (f32, TF32 off) served on the card and on the CPU
   under a live rebalance with blocking harvest, at the smoke capacity
   factor 8.0 and at the published 1.25 (where decode drops picks): every
   routing call's slots equal (a mismatch prints the token's gate gap),
   equal tokens, tables and flags, pools and logits within 1e-5.
25. xlstm_125m in full (12 layers, d 768, sLSTM at layers 3, 7 and 11, bf16)
   through ``lm.prefill`` and ``lm.decode_step``: 8 prompts of 2048 tokens
   (the chunked mLSTM), then 64 greedy decode steps, twice, with the sLSTM
   layers' per-token prefill loops timed; finite logits and the same tokens.
   Then the reduced config on the card and on the CPU in lockstep (f32, TF32
   off): prefills of 192 (chunked) and 64 tokens (sequential), each followed
   by 4 decode steps; equal tokens, logits and every cache within 1e-5.

26. K5's backward kernel against its plain version on the card, at the
   timed forward shape ([8, 2048, 4096] f32) and at phase 28's training
   shape ([4, 2048, 4096]): da, db and dh0 bit-identical (the same order of
   operations) and run to run, timed against its byte bound (g, a and h
   read, da and db written: 5 B·T·R·4 bytes); and at a tiny f32 shape the
   autograd Function's gradient (both kernels) against float64 central
   differences, within 1e-4 relative.
27. granite_3_2b trained at full width and all 40 layers (bf16 weights, fp32
   Adam moments and accumulator): ``Trainer`` on ``SyntheticLM`` (seed 0),
   batch 8 × 1,024 in 2 microbatches, lr 3e-3 with warmup 2, 20 steps, no
   checkpoint; finite losses and the last below the first; the loss curve,
   median step ms, tokens/s and peak GiB; model FLOPs a step (6 N D) against
   ``roofline.model.PEAK_FLOPS``, the MFU; one more step profiled (kernels,
   device time, busy share).
28. recurrentgemma_9b at full width, one period plus the tail (4 ``rec``, 1
   ``win``), batch 4 × 2,048, 6 steps: K5's forward launched twice (the
   block recompute) and its backward once per rec layer and step, and
   nonzero, finite gradients on every rec layer's ``wr``, ``wi`` and ``lam``.
29. The reduced config of each of the ten archs (f32, TF32 off; nemotron
   with its bf16 moments and accumulator; llava and musicgen fed embeddings)
   takes 2 train steps on the card and on the CPU from one state: losses
   within 1e-5 at step 1 and 1e-4 at step 2 (after an Adam step).  The
   reduced granite checkpoints at step 1, fails at step 2 and restarts: the
   step-2 loss within 1e-5 of the uninterrupted run's (bit-identical or not
   is printed); a checkpoint written on the card restores on the CPU and on
   the card bit for bit.  Then the four archs added last, reduced, served on
   the card and on the CPU: nemotron through ``PagedEngine`` under a live
   rebalance (as phase 10), gemma2, llava and musicgen through ``lm.prefill``
   and 4 decode steps in lockstep (as phase 11); logits and caches within
   1e-5.

30. The paged-decode kernel's hd-192 instance against its plain version on
   the card: bf16 and f32, G 12 (nemotron: 96 query heads over 8 kv heads)
   and G 1, at mixed lens and at lens on the split boundaries, bit-identical
   run to run; timed at nemotron's decode shape (q [8, 96, 192] bf16, layer
   3 of a [1024, 7, 2, 16, 8, 192] pool, lens 544 each) beside its byte
   bound, the plain version and a page gather plus SDPA.
31. nemotron_4_340b at full width with 7 of its 96 layers (62.6 GiB of bf16
   weights, random from a seeded generator) through ``PagedEngine`` on phase
   7's pool: 8 prompts of 512 tokens, 32 greedy steps, twice undisturbed and
   once while two sequences leap from step 1 on.  The same tokens and
   bit-identical last logits in all three runs, one hd-192 paged-decode
   launch per layer and step, at least 8 GiB of the card left free.
32. gemma2_27b at full width and all 46 layers (window and global layers,
   both softcaps) through ``lm.prefill`` and ``lm.decode_step``: 4 prompts
   of 4,096 tokens (its window, ROADMAP R4), 32 greedy steps, twice; finite
   logits, the same tokens, bit-identical last logits.
33. llava_next_34b (all 60 layers) and musicgen_large (all 48) the same way,
   fed seeded bf16 embeddings [8, 512, d_model] and one more [8, 1,
   d_model] a step (their frontends are stubs in both packages).

34. Five dry-run cells at full width through ``launch.dryrun.run_cell`` on
   the card (the dry-run cuts the batch to fit and holds at most
   ``STEP_TOKENS`` tokens a step, and keeps every layer here):
   granite_3_2b ``decode_32k``, ``prefill_32k`` and ``train_4k``, and
   recurrentgemma_9b ``prefill_32k`` (which launches K5) and ``long_500k``
   (decode at position 524,287).  Each cell ends ``OK`` with its cut
   recorded; the meta accounting's argument bytes equal the allocator's
   count before the step within 1%; the peak stays under the card's
   memory; the trace holds no NCCL kernel and 0 wire bytes; its device ms
   are no more than the profiled step's wall, nor than the median
   unprofiled step by more than ``DRYRUN_TRACE_TOL``; recurrentgemma's
   profiled prefill launches K5 once per ``rec`` layer, named from the
   trace.  Then ``roofline.report.measured_table("h100")`` of these five
   artifacts, and the LRU-scan kernel against its plain version, bit for
   bit and run to run, at the shape that prefill gives it (a, b, out [1,
   32768, 4096] f32), timed against its byte bound, with the plan it
   launched: a second K5 row in the kernels line, whose launches are phase
   34's (the first row's are phases 1-33's).
35. Captured programs against eager launches (``graphs.disable_capture``):
   phases 3 and 4's drains, phase 3's pool under the batched generation and
   under the contest's legacy arm (``chunk_blocks`` 16), and phase 13's
   ppermute drain, each with blocking harvest, once eager and once graphed
   (pools, tables, flags and heat bit-identical, the same stats and kernel
   launch counts, one replay a program; ticks, programs a tick, replays,
   captures, misses, host ms a tick, drain seconds and graph-pool GiB
   printed), and phase 7's deployment undisturbed eager, undisturbed
   graphed and live graphed (tokens and last logits bit-identical; decode
   step ms printed).
36. The four torch examples (``examples/*_torch.py``), each once on the
   card at its own defaults (each asserts its own result; train_e2e's loss
   must fall), then qwen2_7b at full width and depth (28 layers, bf16,
   random weights from seed 0) through ``repro_torch.launch.serve.main``
   with ``--rebalance``: 8 requests of 512 tokens, 32 decode steps (one
   graph replay each, K4 at G = 7 once per layer and step), the decode
   step's median ms printed; then K4 at that decode shape against its plain
   version, timed beside its bound and the library call: the
   ``paged_decode_g7`` row of the kernels line.

Output: human-readable lines, then the ``{"kernels": [...]}`` line, the
``{"drains": ...}`` line, the ``{"serving": ...}`` line, the
``{"recurrent": ...}`` line, the ``{"contenders": ...}`` line (phases
16-19), the ``{"chaos": ...}`` line (phases 20-22), the ``{"moe": ...}``
line (phases 23-25 and the wall seconds of phases 23-36), the
``{"training": ...}`` line (phases 27-29), the ``{"models": ...}`` line
(phases 31-33), the ``{"dryrun": ...}`` line (phase 34), the
``{"graphs_against_eager": ...}`` line (phase 35), the ``{"examples": ...}``
line (phase 36), and last ``{"ok": true, "device": {...}}``.  Every time
and size of phases 12 (the rounds), 16, 27 (the MFU) and 30-36 is printed
with the card's name and power limit beside it.
Without a CUDA device, or without the rest of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import importlib.util
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import (  # noqa: E402
    AutoBalanceConfig,
    AutoBalancer,
    LeapConfig,
    MigrationDriver,
    PoolConfig,
    SyncResharder,
    init_state,
    leap_write,
    make_region_mesh,
    state_sharding,
)
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.chaos import (  # noqa: E402
    ChaosDriver,
    FaultEvent,
    InvariantChecker,
    InvariantViolation,
    ScenarioSpec,
    run_scenario,
    run_with_repro,
    sample_spec,
)
from repro_torch.configs.base import PORTED_ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.core import graphs, migrator  # noqa: E402
from repro_torch.core.pipeline import busy_mask  # noqa: E402
from repro_torch.data import tpch  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.data.morsels import MorselStore  # noqa: E402
from repro_torch.distributed.fault import drain_region  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    heat_scan,
    leap_copy,
    lru_scan,
    ops,
    paged_attn,
    ref,
)
from repro_torch.load import LoadGenerator, TenantSpec, WorkloadSpec  # noqa: E402
from repro_torch.models import lm, moe, xlstm  # noqa: E402
from repro_torch.roofline import model as roofline  # noqa: E402
from repro_torch.serving.engine import PagedConfig, PagedEngine  # noqa: E402
from repro_torch.tiering import TieringConfig, TieringPolicy  # noqa: E402
from repro_torch.topology import NumaTopology  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig,
    TrainState,
    grad_accum,
    init_train_state,
    train_step,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
HEAT_TOL = dict(rtol=1e-6, atol=1e-6)  # sums over duplicate ids may associate differently
N_BLOCKS = 131072
SLOTS = 131104  # a little headroom over N_BLOCKS; 4097 runs of 32
BLOCK = (1, 16384)  # 64 KiB fp32 blocks
HUGE = 32  # 2 MiB huge blocks
IO_PER_TICK = 64  # writes and reads per tick
SEED = 0
# paged decode at granite_3_2b's widths: 8 sequences, 32 query heads over
# 8 kv heads of 64, pages of 16 tokens, up to 64 pages a sequence
PAGED = dict(b=8, h=32, kvh=8, hd=64, blk=16, maxb=64, layers=40, layer=20, slots=1024)
# bf16: rtol covers the rounding of large m and l; atol sits about 8 times
# over the error measured on an H100 (2.44e-4) and well under |out| (~0.05)
PAGED_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-3)}
SERVE = dict(prompts=8, prompt_len=512, steps=64)
# recurrentgemma_9b: 8 prompts of 2048 tokens (its attention window), 64 steps
RECUR = dict(prompts=8, prompt_len=2048, steps=64)
LRU_BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # the JAX package's (tests/test_kernels_lru_scan.py)
# the ppermute drain: a four-socket server, 40,960 slots of 64 KiB a region
PP_REGIONS, PP_SLOTS = 4, 40960
PP_CFG = dict(backend="ppermute", axis_name="data", initial_area_blocks=256,
              budget_blocks_per_tick=1024, tiering=True)
DRAIN_CFG = dict(initial_area_blocks=256, budget_blocks_per_tick=1024, tiering=True)
# the contest: SyncResharder's busy set is a live leap of this many blocks;
# AutoBalancer runs this many scans (each reading IO_PER_TICK blocks from region 1)
CONTEST = dict(busy_blocks=4096, scans=64)
# the tiering loop (cxl_pooled(2, 1): regions 0, 1 near, 2 far): slots a region
# (2,560 runs of 32), ticks, the tick the working set rotates at, its size
TIER = dict(slots=81920, ticks=160, rotate=80, working_set=512)
# the failed-region drain: quad_socket, 32,768 blocks a region in 45,056 slots
FAILED = dict(regions=4, slots=45056, region=3)
# TPC-H: 33,554,432 lineitem rows of 32 B (1 GiB, about SF 5.6) in morsels of
# 2,048 rows (64 KiB): 16,384 morsels; fig8's writer does 16 field writes a tick
TPCH = dict(rows=33_554_432, rows_per_morsel=2048, q1_cutoff=2400.0, q6_year=730.0, writes=16)
# the chaos sweep: tests/test_chaos.py's seeds; the sabotage spec of that file
CHAOS_SEEDS = range(8)
SABOTAGE_SPEC = ScenarioSpec(seed=0, ticks=4, n_regions=2, slots_per_region=16, n_blocks=8,
                             placement="spread", scheduler="sync", workload="exchange")
# tests/test_load.py's chaos serving scenario (the tiny two-layer model, K4)
SERVING_CHAOS = ScenarioSpec(
    seed=5, ticks=10, n_regions=2, slots_per_region=32, workload="serving", scheduler="slo",
    serving_rate=0.5, serving_churn_every=2,
    faults=(FaultEvent("cancel_storm", tick=5, args={"frac": 0.5}),))
# the failed-region drain's pool under the chaos harness: quad_socket, 2 GiB of
# 64 KiB blocks spread over 4 regions of 45,056 slots (an 11 GiB pool)
CHAOS_AT_SCALE = ScenarioSpec(
    seed=0, ticks=40, n_regions=4, topology="quad_socket", slots_per_region=45056,
    n_blocks=32768, block_elems=16384, placement="spread", workload="exchange",
    initial_area_blocks=256, budget_blocks_per_tick=1024, writes_per_tick=64, tiering=True,
    payload_every=8,
    faults=(FaultEvent("congest_link", 4, {"src": 0, "dst": 1, "factor": 4.0}),
            FaultEvent("write_burst", 8, {"blocks": 512}),
            FaultEvent("drain_region", 12, {"region": 3}),
            FaultEvent("cancel_storm", 20, {"frac": 0.25}),
            FaultEvent("restore_topology", 28)))
# open-loop load (benchmarks/serving_slo.py's two tenants at load 2.0) against
# full-width granite: 512-token prompts, 48 ticks, 2 sequences churned a 2nd tick
LOAD = dict(ticks=48, seed=11, churn_every=2, churn_count=2)
LOAD_WARMUP = 16  # serving_slo's: the pacing loop needs a latency window first
# phase 23: the MoE stacks at their published widths, depth cut to fit one card
# (8 of qwen3's 94 layers: 38.7 GB of experts; 4 of dbrx's 40: 25.4 GB)
MOE_SERVE = (
    dict(config="qwen3_moe_235b_a22b", layers=8, prompts=8, prompt_len=512, steps=64),
    dict(config="dbrx_132b", layers=4, prompts=8, prompt_len=512, steps=16),
)
MOE_PEAK_BYTES = 60e9  # qwen3's 8 layers hold about 42.4 GB of weights
# paged decode at those stacks' decode shapes (phase 6): phase 23's pools
PAGED_MOE = {
    "qwen3_moe_235b_a22b": dict(b=8, h=64, kvh=4, hd=128, blk=16, maxb=64, layers=8, layer=4,
                                slots=1024),
    "dbrx_132b": dict(b=8, h=48, kvh=8, hd=128, blk=16, maxb=64, layers=4, layer=2, slots=1024),
}
# phase 25: xlstm_125m in full, prompts long enough for the chunked mLSTM; the
# reduced config's prefills on either side of the chunked cell's threshold
XLSTM = dict(prompts=8, prompt_len=2048, steps=64)
# phase 27: granite_3_2b trained at full width and depth
TRAIN_GRANITE = dict(batch=8, seq=1024, n_micro=2, lr=3e-3, warmup=2, steps=20)
# phase 28: recurrentgemma_9b at full width, one period plus the tail (4 rec, 1 win)
TRAIN_RECUR = dict(batch=4, seq=2048, n_micro=1, lr=1e-3, warmup=2, steps=6)
TRAIN_RECUR_LAYERS = 5
# phase 29: the reduced configs on the card and on the CPU
TRAIN_REDUCED = dict(batch=4, seq=32, n_micro=2, lr=1e-3, warmup=1, steps=2)
# step 1's loss comes before any update; step 2's follows an Adam step, whose
# update g / (sqrt(v) + eps) turns a last-bit gradient difference into a
# larger one where |g| is near eps
TRAIN_LOSS_TOL = (dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-4, atol=1e-4))
LRU_FD_TOL = 1e-4  # the Function's gradient against float64 central differences
XLSTM_REDUCED_LENS = (192, 64)
# phase 30: K4's hd-192 instance at nemotron_4_340b's decode shape: 8
# sequences, 96 query heads over 8 kv heads of 192 (G 12), one layer of
# phase 31's 7-layer pool, lens of its last decode step (512 + 32)
PAGED_NEMO = dict(b=8, h=96, kvh=8, hd=192, blk=16, maxb=64, layers=7, layer=3, slots=1024)
# phase 31: nemotron at full width, 7 of its 96 layers (3.45 B parameters a
# layer, 18.9 GB of untied embedding and head: 62.6 GiB of weights)
NEMO_SERVE = dict(config="nemotron_4_340b", layers=7, prompts=8, prompt_len=512, steps=32)
# phase 32: gemma2_27b at full width and depth on the contiguous path, with
# prompts as long as its window (ROADMAP R4)
GEMMA_SERVE = dict(config="gemma2_27b", layers=46, prompts=4, prompt_len=4096, steps=32)
# phase 33: the stub-frontend backbones fed seeded bf16 embeddings
STUB_SERVE = (
    dict(config="llava_next_34b", layers=60, prompts=8, prompt_len=512, steps=32),
    dict(config="musicgen_large", layers=48, prompts=8, prompt_len=512, steps=32),
)
# phases 31-33 leave at least this much of the card free
HEADROOM_BYTES = 8 * 2**30
# phase 34: dry-run cells at full width and depth on the card
DRYRUN_CELLS = (("granite_3_2b", "decode_32k"), ("granite_3_2b", "prefill_32k"),
                ("granite_3_2b", "train_4k"), ("recurrentgemma_9b", "prefill_32k"),
                ("recurrentgemma_9b", "long_500k"))
DRYRUN_ARG_TOL = 0.01  # argument bytes, meta against the allocator (which rounds each tensor up)
# the profiled step's device ms over the median unprofiled step: tracing
# lengthens each kernel a little (granite's 32k prefill read 1.0% over)
DRYRUN_TRACE_TOL = 0.05
# captured graphs' private memory pools a drain may leave reserved while its
# driver lives (phases 3, 4, 13, 16 and 35)
GRAPH_POOL_LIMIT_GIB = 1.0
# phase 36: qwen2_7b at full width and depth through repro_torch.launch.serve
# (28 layers, about 7.6 B bf16 parameters), 8 requests of 512 tokens, 32
# decode steps while request 0's KV pages leap to the other region
QWEN_SERVE = dict(arch="qwen2_7b", requests=8, prompt_len=512, tokens=32)
# K4 at qwen2_7b's decode shape (G 7): launch.serve's pool (pages of 4
# tokens, 138 a sequence, 1,380 slots a region over 2 regions), the lens of
# the middle decode step
PAGED_QWEN = dict(b=8, h=28, kvh=4, hd=128, blk=4, maxb=138, layers=28, layer=14, slots=2760)
K6A_ROUNDS = 7  # phase 12: K6a at 256 and 1,024 lanes against index_select, in turns
# phase 12: K6a's lane counts (either side of the H100's 132 SMs, one drain
# area and a tick's budget) and its slots: a ragged last tile, 240 and 512 B
K6A_LANES = (1, 3, 131, 132, 133, 256, 257, 1024)
K6A_SLOTS = ((torch.float32, (1, 16388)), (torch.bfloat16, (3, 40)), (torch.int32, (2, 64)))
LOAD_TENANTS = (
    TenantSpec("gold", rate=0.9, prompt_tokens=512, decode_tokens=32, slo_latency=2.5,
               priority=2, region=0),
    TenantSpec("batch", rate=0.6, prompt_tokens=512, decode_tokens=64, slo_latency=10.0,
               priority=0, region=1),
)


@functools.cache
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them; printed
    beside every time and size that phases 12 (the rounds), 27 (the MFU)
    and 30-33 report."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int = 50, repeats: int = 5) -> float:
    """Device time of one call: the median over ``repeats`` of CUDA-event time
    around ``iters`` back-to-back calls, divided by ``iters``.

    A sleep kernel holds the stream while the host queues the calls, so the
    calls run back to back and the host's launch overhead (tens of
    microseconds of Python per call) stays out of the device time.
    """
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):  # warm-up, and how long the host takes to queue
        fn()
    queue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(4 * queue_s * 2e9))  # ~4x the queueing time, in cycles
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def bound_ms(n_bytes: float, n_flops: float = 0.0) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def launch_counts() -> dict[str, int]:
    return {
        "copy_blocks": leap_copy.copy_blocks.launches,
        "copy_runs": leap_copy.copy_runs.launches,
        "heat_scan": heat_scan.heat_scan.launches,
        "paged_decode": paged_attn.paged_decode.launches,
        "paged_decode_hd192": paged_attn.paged_decode.launches_by_head_dim.get(192, 0),
        "paged_decode_g7": paged_attn.paged_decode.launches_by_group.get(7, 0),
        "lru_scan": lru_scan.lru_scan.launches,
        "lru_scan_bwd": lru_scan.lru_scan_bwd.launches,
        "gather_blocks": leap_copy.gather_blocks.launches,
        "scatter_blocks": leap_copy.scatter_blocks.launches,
    }


@contextlib.contextmanager
def no_host_sync(dev: torch.device):
    """Inside, any PyTorch call that makes the host wait for the card raises
    (PyTorch's sync debug mode, which sees most but not all such calls)."""
    if dev.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def distinct_ids(n: int, k: int, gen: torch.Generator) -> torch.Tensor:
    """``k`` distinct uniformly random ids below ``n`` (redraws on a repeat,
    which at k = 64 of n = 131072 happens about once in 60 draws)."""
    while True:
        ids = torch.randint(0, n, (k,), generator=gen)
        if len(torch.unique(ids)) == k:
            return ids


def release() -> None:
    """Free the card's memory that earlier phases left: a driver sits in
    reference cycles, which only the garbage collector frees (and with its
    state go its captured graphs and their private memory pools)."""
    gc.collect()
    torch.cuda.empty_cache()
    pools, gib = graph_memory()
    print(f"released: {pools} captured graphs' memory pools left, {gib:.3f} GiB")


def program_counts() -> tuple[int, int]:
    """Graphs captured and replayed so far over every migration program."""
    progs = migrator.PROGRAMS.values()
    return sum(p.captures for p in progs), sum(p.replays for p in progs)


def check_graph_memory(what: str) -> float:
    """The GiB the live captured graphs' pools reserve, checked against the
    limit and printed."""
    pools, gib = graph_memory()
    print(f"{what}: {pools} captured graphs' memory pools, {gib:.3f} GiB [{card()}]")
    check(gib <= GRAPH_POOL_LIMIT_GIB, f"{what}: graph pools within {GRAPH_POOL_LIMIT_GIB} GiB")
    return gib


def graph_memory() -> tuple[int, float]:
    """The private memory pools of the live captured graphs, and the GiB
    they reserve."""
    pools, total = set(), 0
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        if pool != (0, 0):
            pools.add(pool)
            total += seg["total_size"]
    return len(pools), total / 2**30


def reset_launch_counts() -> None:
    leap_copy.copy_blocks.launches = 0
    leap_copy.copy_runs.launches = 0
    heat_scan.heat_scan.launches = 0
    paged_attn.paged_decode.launches = 0
    paged_attn.paged_decode.launches_by_head_dim.clear()
    paged_attn.paged_decode.launches_by_group.clear()
    lru_scan.lru_scan.launches = 0
    lru_scan.lru_scan_bwd.launches = 0
    leap_copy.gather_blocks.launches = 0
    leap_copy.gather_blocks.lanes = 0
    leap_copy.scatter_blocks.launches = 0


# -- phase 2: kernels against their plain versions ----------------------------


def kernel_checks(dev) -> list[dict]:
    g = torch.Generator(device=dev).manual_seed(SEED)
    host = torch.Generator().manual_seed(SEED)
    pool = torch.randn((2 * SLOTS,) + BLOCK, generator=g, device=dev)  # 16 GiB flat pool
    slot_bytes = pool[0].numel() * pool.element_size()
    rows = []

    def copy_row(name, src, dst, run, kernel, plain, library, replaces):
        want = plain(pool.clone())
        got = kernel(pool)  # in place; copying the same lanes again is idempotent
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{name} kernel == plain version, bit for bit")
        lanes = src.shape[0]
        ends = torch.arange(run, device=dev)
        touched = (dst[:, None] + ends[None, :]).view(-1)
        err = float((got[touched] - want[touched]).abs().max())
        del want
        b, by = bound_ms(2 * lanes * run * slot_bytes + 2 * lanes * 8)
        row = dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/leap_copy.cu",
            replaces=replaces, launches=0, max_abs_err=err,
            ms=time_ms(lambda: kernel(pool)), plain_ms=time_ms(lambda: plain(pool)),
            bound_ms=b, bound_by=by, library_ms=time_ms(lambda: library(pool)),
            shape=f"pool [{2 * SLOTS}, 1, 16384] fp32, {lanes} lanes x {run * slot_bytes} B",
        )
        print(f"{name}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, library "
              f"{row['library_ms']:.4f}, bound {b:.4f}), bit-exact")
        return row

    perm = torch.randperm(SLOTS, generator=host)
    src, dst = perm[:1024].to(dev), (SLOTS + perm[1024:2048]).to(dev)
    rows.append(copy_row(
        "copy_blocks", src, dst, 1,
        lambda p: leap_copy.copy_blocks(p, src, dst),
        lambda p: ref.copy_blocks_ref(p, src, dst),
        lambda p: p.index_copy_(0, dst, p.index_select(0, src)),
        "src/repro/kernels/leap_copy.py:105",
    ))
    runs = torch.randperm(SLOTS // HUGE, generator=host)
    rsrc, rdst = (runs[:32] * HUGE).to(dev), (SLOTS + runs[32:64] * HUGE).to(dev)
    grouped = lambda p: p.view(-1, HUGE, *BLOCK)  # noqa: E731
    rows.append(copy_row(
        "copy_runs", rsrc, rdst, HUGE,
        lambda p: leap_copy.copy_runs(p, rsrc, rdst, HUGE),
        lambda p: ref.copy_runs_ref(p, rsrc, rdst, HUGE),
        lambda p: grouped(p).index_copy_(0, rdst // HUGE,
                                          grouped(p).index_select(0, rsrc // HUGE)),
        "src/repro/kernels/leap_copy.py:139",
    ))
    del pool
    torch.cuda.empty_cache()

    rows.append(heat_scan_checks(dev, g, host))
    return rows


def heat_scan_checks(dev, g, host) -> dict:
    """The heat scan on the drains' plane, at K = 128 and 1,024, on two
    sample sets each; ``g`` and ``host`` are the phase's generators."""
    L = heat_scan.padded_heat_len(N_BLOCKS)
    heat0 = torch.rand(L, generator=g, device=dev) * 10
    cases, results = {}, {}
    for k in (2 * IO_PER_TICK, 1024):
        # skewed: every sample in the plane's first 2,048 entries (two of the
        # kernel's tiles), with duplicates and inert lanes
        ids = torch.randint(0, N_BLOCKS // 64, (k,), generator=g, device=dev)
        ids[::9] = L + torch.arange(len(ids[::9]), device=dev)  # inert lanes
        w = torch.rand(k, generator=g, device=dev) + 0.5
        # uniform: drawn as a drain tick draws them, k / 2 distinct writes and
        # k / 2 distinct reads over the blocks, each weighing 1.0
        uids = torch.cat([distinct_ids(N_BLOCKS, k // 2, host) for _ in range(2)]).to(dev)
        cases[f"uniform_k{k}"] = (uids, torch.ones(k, device=dev))
        cases[f"skewed_k{k}"] = (ids, w)
    for name, (ids, w) in cases.items():
        k = ids.shape[0]
        want = ref.heat_scan_ref(heat0.clone(), ids, w, 0.9)
        got = heat_scan.heat_scan(heat0.clone(), ids, w, 0.9)
        again = heat_scan.heat_scan(heat0.clone(), ids, w, 0.9)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **HEAT_TOL)
        check(torch.equal(got, again), f"heat_scan {name} is bit-identical run to run")
        h = heat0.clone()
        padded = torch.zeros(L + 1, device=dev)
        clamped = ids.clamp(max=L)
        b, by = bound_ms(2 * L * 4 + k * 12, 2 * L + k)
        results[name] = r = dict(
            max_abs_err=float((got - want).abs().max()),
            ms=time_ms(lambda: heat_scan.heat_scan(h, ids, w, 0.9)),
            plain_ms=time_ms(lambda: ref.heat_scan_ref(h, ids, w, 0.9)),
            library_ms=time_ms(lambda: padded.mul_(0.9).index_add_(0, clamped, w)),
            bound_ms=b, bound_by=by,
        )
        print(f"heat_scan {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound {b:.6f}), max err {r['max_abs_err']:.3g}")
    return dict(
        name="heat_scan", route="cuda", source="src/repro_torch/kernels/csrc/heat_scan.cu",
        replaces="src/repro/kernels/heat_scan.py:58", launches=0,
        **results[f"uniform_k{2 * IO_PER_TICK}"],
        shape=f"heat [{L}] f32, K={2 * IO_PER_TICK} uniform (a drain tick's samples)",
        cases=results,
    )


# -- phase 12: the gather and scatter kernels against their plain versions -----


def gather_scatter_checks(dev) -> list[dict]:
    """K6a and K6b on region 1's shard of a 2-region pool, the shape the
    ppermute drain hands them (a flat view at a storage offset)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    host = torch.Generator().manual_seed(SEED)
    pool = torch.randn((2, PP_SLOTS) + BLOCK, generator=g, device=dev)  # 5 GiB
    shard = pool[1:2].view((PP_SLOTS,) + BLOCK)
    check(shard.storage_offset() > 0, "the kernels see a region shard at an offset")
    slot_bytes = shard[0].numel() * shard.element_size()
    per_k = {"gather_blocks": {}, "scatter_blocks": {}}
    for k in (256, 1024):  # one drain area; a tick's budget
        # 8 disjoint id sets (and block sets) in turn, so that what one call
        # moves is out of the 50 MB L2 by the time the same set comes back
        sets = torch.randperm(PP_SLOTS, generator=host)[: 8 * k].view(8, k).to(dev)
        block_sets = torch.randn((8, k) + BLOCK, generator=g, device=dev)
        idx, blocks = sets[0], block_sets[0]
        want = ref.gather_blocks_ref(shard, idx)
        got = leap_copy.gather_blocks(shard, idx)
        want_pool = ref.scatter_blocks_ref(shard.clone(), idx, blocks)
        leap_copy.scatter_blocks(shard, idx, blocks)  # in place; scattering again is idempotent
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"gather_blocks at {k} lanes == plain version, bit for bit")
        check(torch.equal(shard, want_pool), f"scatter_blocks at {k} lanes == plain version")
        del want_pool
        # each lane read once and written once, and the ids read once
        b, by = bound_ms(2 * k * slot_bytes + k * 8)
        turn = itertools.cycle(range(8))
        cases = {
            "gather_blocks": (lambda i: leap_copy.gather_blocks(shard, sets[i]),
                              lambda i: ref.gather_blocks_ref(shard, sets[i]),
                              lambda i: torch.index_select(shard, 0, sets[i]),
                              float((got - want).abs().max())),
            "scatter_blocks": (lambda i: leap_copy.scatter_blocks(shard, sets[i], block_sets[i]),
                               lambda i: ref.scatter_blocks_ref(shard, sets[i], block_sets[i]),
                               lambda i: shard.index_copy_(0, sets[i], block_sets[i]),
                               float((shard[idx] - blocks).abs().max())),
        }
        for name, fns in cases.items():
            kernel, plain, library = (lambda f=f: f(next(turn)) for f in fns[:3])
            per_k[name][k] = dict(max_abs_err=fns[3], ms=time_ms(kernel),
                                  plain_ms=time_ms(plain), library_ms=time_ms(library),
                                  bound_ms=b, bound_by=by)
            r = per_k[name][k]
            print(f"{name} {k} lanes: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']:.4f}, bound {b:.4f}), bit-exact")
        gather, _, select, _ = cases["gather_blocks"]
        per_k["gather_blocks"][k]["against_index_select"] = gather_in_turns(
            k, lambda: gather(next(turn)), lambda: select(next(turn)))
        del got, want, blocks, block_sets
    gather_cases(dev, shard)
    lanes = torch.arange(256, device=dev)
    names = {aligned: device_kernels(lambda v=view: leap_copy.gather_blocks(v, lanes))
             for aligned, view in ((True, shard), (False, unaligned_shard(pool, 1, 256)))}
    check(any("gather_bulk_kernel" in n for n in names[True])
          and not any("move_lanes_kernel" in n for n in names[True]),
          "gather_blocks launches the bulk-copy pipeline on 16-byte-aligned operands")
    check(any("move_lanes_kernel" in n and "unsigned char" in n for n in names[False]),
          "gather_blocks launches the lane copy's byte instance one element off")
    print(f"gather_blocks launches {names[True]} on the aligned shard, {names[False]} one "
          "element off")

    # duplicate ids: about 16 lanes an id; the last lane must win every run
    idx = torch.randint(0, 64, (1024,), generator=host).to(dev)
    blocks = torch.randn((1024,) + BLOCK, generator=g, device=dev)
    want = ref.scatter_blocks_ref(shard[:64].clone(), idx, blocks)
    lanes = {int(i): lane for lane, i in enumerate(idx.tolist())}  # the last lane of each id
    check(all(torch.equal(want[i], blocks[lane]) for i, lane in lanes.items()),
          "the plain scatter keeps the last duplicate")
    for run in range(20):
        leap_copy.scatter_blocks(shard[:64], idx, blocks)
        check(torch.equal(shard[:64], want), f"scatter_blocks: the last duplicate wins (run {run})")
    del pool, shard, blocks, want
    torch.cuda.empty_cache()

    # the JAX sweep's odd shape, in each of its dtypes (byte path: 256-byte slots)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        small = torch.randint(-100, 100, (5, 4, 64), generator=host).to(dtype).to(dev)
        idx = torch.tensor([4, 0, 4, 2], device=dev)
        blocks = torch.randint(-100, 100, (4, 4, 64), generator=host).to(dtype).to(dev)
        check(torch.equal(leap_copy.gather_blocks(small, idx), ref.gather_blocks_ref(small, idx)),
              f"gather_blocks (5, 4, 64) {dtype} == plain version")
        want = ref.scatter_blocks_ref(small.clone(), idx, blocks)
        check(torch.equal(leap_copy.scatter_blocks(small, idx, blocks), want),
              f"scatter_blocks (5, 4, 64) {dtype} == plain version")
    print("gather_blocks and scatter_blocks: bit-exact on (5, 4, 64) in f32, bf16 and int32; "
          "the last of duplicate ids wins in 20 runs")

    rows = []
    for name, line in (("gather_blocks", 40), ("scatter_blocks", 68)):
        main = per_k[name][1024]
        rows.append(dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/leap_copy.cu",
            replaces=f"src/repro/kernels/leap_copy.py:{line}", launches=0, **main,
            shape=f"region 1 of a [2, {PP_SLOTS}, 1, 16384] fp32 pool, 1024 lanes x "
                  f"{slot_bytes} B",
            at_256_lanes=per_k[name][256],
        ))
    rows[0]["kernel"] = names[True]
    return rows


def unaligned_shard(pool, offset: int, slots: int = PP_SLOTS):
    """A view of ``slots`` slots ``offset`` elements past region 1's start."""
    flat = pool.view(-1)
    n = slots * pool[0, 0].numel()
    start = pool[0].numel() + offset
    return flat[start : start + n].view((slots,) + tuple(pool.shape[2:]))


def device_kernels(fn) -> list[str]:
    """The names of the kernels that one call of ``fn`` runs on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def gather_twice(shard, idx, what: str) -> None:
    got = leap_copy.gather_blocks(shard, idx)
    again = leap_copy.gather_blocks(shard, idx)
    want = ref.gather_blocks_ref(shard, idx)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"gather_blocks {what} == plain version, bit for bit")
    check(torch.equal(again, got), f"gather_blocks {what}: the same output twice")


def gather_cases(dev, shard) -> None:
    """K6a at K6A_LANES on the drain's shard, each with a duplicate id, and at
    256 and 1,024 lanes on K6A_SLOTS, at a 16-byte-aligned storage offset and
    one element off."""
    host = torch.Generator().manual_seed(SEED + 1)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    for k in K6A_LANES:
        idx = torch.randint(0, shard.shape[0], (k,), generator=host)
        idx[k // 2] = idx[0]
        gather_twice(shard, idx.to(dev), f"at {k} lanes")
    for dtype, slot in K6A_SLOTS:
        n = 4096 if slot[1] > 1024 else PP_SLOTS
        base = torch.randint(-1000, 1000, (3, n) + slot, generator=g, device=dev).to(dtype)
        for offset in (0, 1):
            view = unaligned_shard(base, offset, n)
            check((view.data_ptr() % 16 == 0) == (offset == 0), "the view's alignment")
            for k in (256, 1024):
                idx = torch.randint(0, n, (k,), generator=host).to(dev)
                gather_twice(view, idx, f"{k} lanes of {list(slot)} {dtype}, offset {offset}")
        del base
    print(f"gather_blocks: bit-exact and repeated at {list(K6A_LANES)} lanes with duplicate ids, "
          f"and on {[(str(d), list(s)) for d, s in K6A_SLOTS]} slots on and off 16-byte alignment")


def gather_in_turns(k: int, kernel, library) -> dict:
    """K6a against ``index_select`` in K6A_ROUNDS rounds, the order swapped
    every round (kernel, library; library, kernel; ...), so that drift in the
    card's clocks falls on both alike."""
    rounds = []
    for r in range(K6A_ROUNDS):
        order = ("kernel", "library") if r % 2 == 0 else ("library", "kernel")
        rounds.append({n: time_ms(kernel if n == "kernel" else library) for n in order})
    ms = {n: statistics.median(r[n] for r in rounds) for n in ("kernel", "library")}
    res = dict(rounds=rounds, kernel_ms_median=ms["kernel"], library_ms_median=ms["library"],
               kernel_over_library=ms["kernel"] / ms["library"],
               rounds_kernel_slower=sum(r["kernel"] > r["library"] for r in rounds))
    print(f"gather_blocks {k} lanes against index_select in {K6A_ROUNDS} rounds, in turns: "
          f"kernel {ms['kernel']:.4f} ms, index_select {ms['library']:.4f} ms (medians; "
          f"kernel/library {res['kernel_over_library']:.3f}, kernel slower in "
          f"{res['rounds_kernel_slower']} of {K6A_ROUNDS} rounds) [{card()}]")
    return res


# -- phases 3-5: drains through LeapSession -----------------------------------


def start_regions(n_blocks: int, n_regions: int) -> np.ndarray:
    """Where each block starts: all in region 0 on two regions, else evenly
    spread (block b in region b * n_regions // n_blocks)."""
    if n_regions == 2:
        return np.zeros(n_blocks, np.int32)
    return (np.arange(n_blocks) * n_regions // n_blocks).astype(np.int32)


class AppIO:
    """The application beside the migration: a device-side shadow of every
    block's latest value, distinct random writes mirrored into it, and random
    reads checked against it.  A stale read sets a device flag, so the check
    never makes the host wait.  Ids come from a seeded CPU generator, values
    from a seeded generator on ``values_on`` (default ``dev``; the CPU where
    two devices must see the same values)."""

    def __init__(self, dev, n_blocks: int, block, seed: int, k: int = IO_PER_TICK,
                 values_on=None):
        self.dev, self.n, self.block, self.k = dev, n_blocks, tuple(block), k
        self.values_on = torch.device(values_on or dev)
        self.g = torch.Generator(device=self.values_on).manual_seed(seed)
        self.ids_gen = torch.Generator().manual_seed(seed)
        self.shadow = torch.empty((n_blocks,) + self.block, device=dev)
        self.stale = torch.zeros((), dtype=torch.bool, device=dev)

    def randn(self, k: int) -> torch.Tensor:
        return torch.randn((k,) + self.block, generator=self.g, device=self.values_on).to(self.dev)

    def fill(self, state) -> None:
        """Write every block once, 16,384 at a time."""
        for lo in range(0, self.n, 16384):
            ids = np.arange(lo, min(lo + 16384, self.n))
            self.shadow[lo : lo + len(ids)] = self.randn(len(ids))
            leap_write(state, ids, self.shadow[lo : lo + len(ids)])

    def write(self, drv) -> None:
        wids = distinct_ids(self.n, self.k, self.ids_gen)
        vals = self.randn(self.k)
        drv.write(wids, vals)
        self.shadow[wids.to(self.dev)] = vals

    def read(self, drv, rids=None) -> torch.Tensor:
        """Read ``rids`` (default: ``k`` random ids) and check them."""
        rids = distinct_ids(self.n, self.k, self.ids_gen) if rids is None else rids
        self.stale |= (drv.read(rids) != self.shadow[torch.as_tensor(rids).to(self.dev)]).any()
        return rids

    def step(self, drv) -> torch.Tensor:
        """One application step: the writes, then the reads."""
        self.write(drv)
        return self.read(drv)

    def check(self, drv) -> None:
        """No stale read, and every block reads back its latest write."""
        check(not bool(self.stale), "every read during the run saw the latest write")
        check_payload(drv, self.shadow)


def check_payload(drv, shadow) -> None:
    n = drv.state.n_blocks
    for lo in range(0, n, 8192):
        ids = np.arange(lo, min(lo + 8192, n))
        check(torch.equal(drv.read(ids, note=False), shadow[lo : lo + len(ids)]),
              f"blocks {lo}.. read back equal to the shadow")


def drain(dev, n_blocks: int, slots: int, block, huge_factor: int, seed: int,
          io_per_tick: int = IO_PER_TICK, cfg_kw=None, blocking: bool = False,
          values_on=None, n_regions: int = 2, mesh=None, window=None):
    """Leap every block from its region r to region (r + 1) % n_regions under
    concurrent writes and reads; return the driver, the shadow of what was
    written, the handles and the host seconds of the drain: all of it, inside
    ``session.tick()``, and in the application's writes and reads.  With two
    regions every block starts in region 0; with more, they start spread
    evenly, and each region's blocks are one request.  Writes and reads draw
    their ids from a seeded CPU generator and their values from a seeded
    generator on ``values_on`` (default ``dev``; the CPU where two devices
    must see the same values).  ``mesh`` places the state for the ppermute
    backend; ``window``, a context manager, encloses the timed drain (e.g. a
    profiler)."""
    pc = PoolConfig(n_regions, slots, block, torch.float32, huge_factor=huge_factor,
                    region_axis=mesh.axis_name if mesh else None)
    place = start_regions(n_blocks, n_regions)
    state = init_state(pc, n_blocks, place, device=dev)
    if mesh is not None:
        state = state.to(state_sharding(pc, mesh))
    io = AppIO(dev, n_blocks, block, seed, io_per_tick, values_on)
    io.fill(state)
    cfg = LeapConfig(**(cfg_kw or dict(initial_area_blocks=256, budget_blocks_per_tick=1024,
                                       tiering=True)))
    drv = MigrationDriver(state, pc, cfg, mesh=mesh)
    if huge_factor > 1:
        groups = n_blocks // huge_factor
        check(drv.adopt_huge(np.arange(groups)) == groups, "adopt_huge adopts every group")
    session = drv.default_session()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    with window or contextlib.nullcontext():
        t0 = time.perf_counter()
        handles = [session.leap(np.nonzero(place == r)[0], (r + 1) % n_regions)
                   for r in np.unique(place)]
        ticks, tick_s, io_s = 0, 0.0, 0.0
        while not drv.done and ticks < 20 * n_blocks:
            t1 = time.perf_counter()
            with no_host_sync(dev):
                session.tick()
            if blocking:
                session.poll(block=True)
            t2 = time.perf_counter()
            io.step(drv)
            ticks += 1
            tick_s += t2 - t1
            io_s += time.perf_counter() - t2
        check(session.drain(), "the drain completes")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = dict(seconds=time.perf_counter() - t0, tick_s=tick_s, io_s=io_s)
    check(not bool(io.stale), "every read during the drain saw the latest write")
    return drv, io.shadow, handles, seconds


def check_drain(drv, shadow, handles, huge: bool) -> dict:
    n, regions = drv.state.n_blocks, drv.pool_cfg.n_regions
    check_payload(drv, shadow)
    check(drv.verify_mirror(), "host table mirror == device table")
    check(drv.verify_tiers(), "two-tier table and allocators consistent")
    check((drv.host_placement() == (start_regions(n, regions) + 1) % regions).all(),
          "every block lives in its destination region")
    p = [h.progress() for h in handles]
    check(sum(x.committed + x.forced + x.cancelled for x in p) == sum(x.requested for x in p) == n,
          "request accounting closes")
    s = drv.stats
    check(s.blocks_migrated + s.blocks_forced + s.blocks_cancelled == s.blocks_requested,
          "engine accounting closes")
    if drv.cfg.dispatch_mode == "megastep":
        check(0.0 < s.dispatches_per_tick <= 1.0, "at most one megastep per tick")
    else:
        check(s.dispatches_per_tick > 1.0, "batched: one program per phase")
    check(s.dirty_rejections > 0, "concurrent writes dirtied some copies")
    if huge:
        check(s.huge_areas_committed > 0, "huge blocks committed as whole runs")
    heat = drv.heat_snapshot()
    check(np.isfinite(heat).all() and (heat > 0).any(), "heat plane finite and warm")
    return dict(
        ticks=s.ticks, dispatches=s.dispatches, dispatches_per_tick=s.dispatches_per_tick,
        dirty_rejections=s.dirty_rejections, blocks_forced=s.blocks_forced, splits=s.splits,
        demotions=s.demotions, huge_areas_committed=s.huge_areas_committed,
        bytes_copied=s.bytes_copied,
    )


def main_path_drain(dev, huge_factor: int, ppermute: bool = False) -> dict:
    """A deployment-size drain: 2 regions through the megastep, or with
    ``ppermute`` 4 regions on a one-card region mesh through the batched
    generation's point-to-point copies."""
    release()
    torch.cuda.reset_peak_memory_stats()
    slots, seed, kw = SLOTS, SEED + huge_factor, dict(cfg_kw=dict(DRAIN_CFG, warm_dispatch=True))
    if ppermute:
        slots, seed = PP_SLOTS, SEED + 2
        kw = dict(cfg_kw=PP_CFG, n_regions=PP_REGIONS, mesh=make_region_mesh(PP_REGIONS))
    tap = LaneTap()
    reset_launch_counts()
    prog = program_counts()
    with tap if ppermute else contextlib.nullcontext():
        drv, shadow, handles, times = drain(dev, N_BLOCKS, slots, BLOCK, huge_factor, seed, **kw)
    launches = launch_counts()
    lanes = leap_copy.gather_blocks.lanes
    out = check_drain(drv, shadow, handles, huge=huge_factor > 1)
    now = program_counts()
    out.update(captures=now[0] - prog[0], replays=now[1] - prog[1],
               jit_cache_misses=drv.stats.jit_cache_misses,
               graph_pool_gib=check_graph_memory(
                   f"drain huge_factor={huge_factor} backend={drv.cfg.backend}"))
    check(out["replays"] == drv.stats.dispatches,
          "every program of the drain was one graph replay")
    if ppermute:
        check(launches["gather_blocks"] == launches["scatter_blocks"] > 0,
              "every point-to-point copy gathered and scattered once")
        check(launches["copy_blocks"] == 0, "the ppermute drain copies only point to point")
        check(sum(tap.lanes) == lanes and len(tap.lanes) == launches["gather_blocks"],
              "gather_blocks.lanes sums the lanes of every launch")
        out["gather_lanes"] = dict(total=lanes, mean=lanes / len(tap.lanes), bins=tap.bins())
        print(f"ppermute drain: {len(tap.lanes)} gather launches, {lanes} lanes, "
              f"{out['gather_lanes']['mean']:.1f} a launch; launches by lanes "
              f"{out['gather_lanes']['bins']}")
    moved = N_BLOCKS * drv.pool_cfg.block_bytes
    out.update(times, gib_per_s=moved / times["seconds"] / 2**30, launches=launches,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               regions=drv.pool_cfg.n_regions, dispatch=drv.cfg.dispatch_mode,
               backend=drv.cfg.backend)
    print(f"drain huge_factor={huge_factor} backend={drv.cfg.backend}: {times['seconds']:.3f} s "
          f"(ticks {times['tick_s']:.3f} s, app I/O {times['io_s']:.3f} s), "
          f"{out['gib_per_s']:.3f} GiB/s, {out['ticks']} ticks, "
          f"{out['dispatches_per_tick']:.2f} dispatches a tick, "
          f"{out['dirty_rejections']} rejections, peak {out['peak_gib']:.2f} GiB, "
          f"{out['replays']} replays, {out['captures']} captures, "
          f"{out['jit_cache_misses']} jit misses (warm_dispatch={drv.cfg.warm_dispatch}), "
          f"launches {launches}")
    return out


class LaneTap:
    """While active, wraps ``migrator.fused_copy_ppermute`` (one gather and
    one scatter launch a call, captured or not) to keep each call's lane
    count, pad lanes included, read on the host from the ids' shape."""

    BINS = ((1, 128), (129, 255), (256, 256), (257, 511), (512, 1023), (1024, None))

    def __init__(self):
        self.lanes: list[int] = []
        self._copy = migrator.fused_copy_ppermute

    def __enter__(self):
        migrator.fused_copy_ppermute = self._tap
        return self

    def __exit__(self, *exc):
        migrator.fused_copy_ppermute = self._copy

    def _tap(self, state, src_slots, *args, **kw):
        self.lanes.append(src_slots.shape[0])
        return self._copy(state, src_slots, *args, **kw)

    def bins(self) -> dict[str, int]:
        label = {(lo, hi): str(lo) if hi == lo else f"{lo}+" if hi is None else f"{lo}-{hi}"
                 for lo, hi in self.BINS}
        return {label[lo, hi]: sum(lo <= n and (hi is None or n <= hi) for n in self.lanes)
                for lo, hi in self.BINS}


SMALL_KW = dict(initial_area_blocks=16, budget_blocks_per_tick=64, max_attempts_before_force=2,
                tiering=True)


def small_drain(d, huge: int, cfg_kw=SMALL_KW, n_regions: int = 2):
    """A small drain with blocking harvest and values drawn on the CPU, so
    that two devices, or two dispatch generations, see the same schedule."""
    mesh = make_region_mesh(n_regions, [d] * n_regions) if n_regions > 2 else None
    slots = 544 if n_regions == 2 else 160
    return drain(d, 512, slots, (2, 64), huge, SEED, io_per_tick=24, cfg_kw=cfg_kw,
                 blocking=True, values_on="cpu", n_regions=n_regions, mesh=mesh)


def card_matches_cpu(dev, ppermute: bool = False) -> None:
    """Small drains on the card and on the CPU: megastep on small and on
    two-tier pools and legacy on a small pool (phase 5), or a 4-region
    ppermute drain (phase 14)."""
    cases = ((1, SMALL_KW, 2), (4, SMALL_KW, 2), (1, dict(SMALL_KW, fused_dispatch="legacy"), 2))
    if ppermute:
        cases = ((1, dict(SMALL_KW, backend="ppermute", axis_name="data"), PP_REGIONS),)
    for huge, kw, regions in cases:
        before = launch_counts()
        (gpu, _, hg, _), (cpu, _, hc, _) = [small_drain(d, huge, kw, regions)
                                            for d in (dev, torch.device("cpu"))]
        check(np.array_equal(gpu.host_table(), cpu.host_table()), "host tables agree")
        for a, b in zip(gpu.state.to_numpy(), cpu.state.to_numpy()):
            check(np.array_equal(a, b), "card and CPU states agree bit for bit")
        np.testing.assert_allclose(gpu.heat_snapshot(), cpu.heat_snapshot(), **HEAT_TOL)
        check(gpu.stats == cpu.stats, "card and CPU MigrationStats agree")
        check([h.progress() for h in hg] == [h.progress() for h in hc],
              "card and CPU request progress agree")
        if regions > 2:
            after = launch_counts()
            check(after["scatter_blocks"] > before["scatter_blocks"],
                  "the card's ppermute drain ran the scatter kernel")
            check(gpu.stats.dirty_rejections > 0, "writes dirtied some ppermute copies")
    print(f"small {'ppermute' if ppermute else 'megastep and legacy'} drains on the card and on "
          "the CPU agree")


def same_state(a, b, what: str) -> None:
    """Two small drains that must end bit-identical: pools, tables, flags,
    host tables and rejections; heat within 1e-6."""
    for x, y in zip(a.state.to_numpy(), b.state.to_numpy()):
        check(np.array_equal(x, y), f"{what}: bit-identical pools, tables and flags")
    check(np.array_equal(a.host_table(), b.host_table()), f"{what}: host tables agree")
    np.testing.assert_allclose(b.heat_snapshot(), a.heat_snapshot(), **HEAT_TOL)
    check(a.stats.dirty_rejections == b.stats.dirty_rejections > 0, f"{what}: the same rejections")


def megastep_matches_batched(dev) -> dict:
    """The reference's differential oracle on the card: the same seeded drain
    under the megastep and under the batched generation (xla backend); then
    megastep against legacy on a small and on a two-tier pool."""
    replays = migrator.MEGASTEP.replays
    m, _, hm, _ = small_drain(dev, 1, dict(SMALL_KW, fused_dispatch="megastep"))
    check(migrator.MEGASTEP.replays - replays == m.stats.dispatches > 0,
          "every megastep of the small drain was one graph replay")
    reset_launch_counts()
    b, _, hb, _ = small_drain(dev, 1, dict(SMALL_KW, fused_dispatch="batched"))
    same_state(m, b, "megastep and batched")
    check([h.progress() for h in hm] == [h.progress() for h in hb], "and the same progress")
    small = launch_counts()
    huge, shadow, handles, _ = small_drain(dev, 4, dict(SMALL_KW, fused_dispatch="batched"))
    check_drain(huge, shadow, handles, huge=True)
    launches = launch_counts()
    check(launches["copy_runs"] > small["copy_runs"], "the two-tier batched drain copied runs")
    for name in ("copy_blocks", "copy_runs", "heat_scan"):
        check(launches[name] > 0, f"the batched drains launched {name}")
    legacy_kw = dict(SMALL_KW, fused_dispatch="legacy")
    legacy, _, hl, _ = small_drain(dev, 1, legacy_kw)
    same_state(m, legacy, "megastep and legacy")
    check([h.progress() for h in hm] == [h.progress() for h in hl], "and the same progress")
    replays = migrator.MEGASTEP.replays
    huge_m = small_drain(dev, 4, SMALL_KW)[0]
    check(migrator.MEGASTEP.replays - replays == huge_m.stats.dispatches > 0,
          "every megastep of the two-tier drain was one graph replay")
    same_state(huge_m, small_drain(dev, 4, legacy_kw)[0], "megastep and legacy on a two-tier pool")
    print(f"megastep and batched agree bit for bit (batched launches {launches}); so do "
          f"megastep and legacy, on small and two-tier pools")
    return dict(megastep_dispatches=m.stats.dispatches, batched_dispatches=b.stats.dispatches,
                legacy_dispatches=legacy.stats.dispatches, ticks=b.stats.ticks,
                batched_launches=launches)


# -- phases 16-19: the contenders, the tiering loop, a failed-region drain ------


def contest_pool(dev, seed: int, cfg_kw=DRAIN_CFG):
    """The drains' 8 GiB pool (131,072 blocks of 64 KiB, all in region 0 of
    2), every block written once, and a driver over it."""
    pc = PoolConfig(2, SLOTS, BLOCK, torch.float32)
    state = init_state(pc, N_BLOCKS, np.zeros(N_BLOCKS, np.int32), device=dev)
    io = AppIO(dev, N_BLOCKS, BLOCK, seed)
    io.fill(state)
    drv = MigrationDriver(state, pc, LeapConfig(**cfg_kw))
    torch.cuda.synchronize()
    return pc, drv, io


def arm_record(drv, seconds: float, moved: int, zeroed: int, launches) -> dict:
    """One contest arm's numbers; ``zeroed`` is the bytes of its
    fresh-destination zero pass, which ``bytes_touched`` adds to the copies."""
    s = drv.stats
    return dict(blocks_moved=moved, bytes_copied=s.bytes_copied,
                bytes_touched=s.bytes_copied + zeroed, ticks=s.ticks,
                dispatches=s.dispatches, dispatches_per_tick=s.dispatches / max(s.ticks, 1),
                dirty_rejections=s.dirty_rejections, blocks_forced=s.blocks_forced,
                seconds=seconds, launches=launches)


def contest(dev) -> dict:
    """fig5's setup at the drains' size: 131,072 blocks of 64 KiB leave region
    0 for region 1 under 64 writes and 64 reads a tick, four ways."""
    arms = {}
    for name, kw in (("page_leap_megastep", DRAIN_CFG),
                     ("page_leap_legacy", dict(DRAIN_CFG, fused_dispatch="legacy",
                                               chunk_blocks=16))):
        release()
        reset_launch_counts()
        prog = program_counts()
        drv, shadow, handles, times = drain(dev, N_BLOCKS, SLOTS, BLOCK, 1, SEED + 3, cfg_kw=kw)
        launches = launch_counts()
        check_drain(drv, shadow, handles, huge=False)
        replays = program_counts()[1] - prog[1]
        check(replays == drv.stats.dispatches, f"contest {name}: one graph replay a program")
        arms[name] = dict(arm_record(drv, times["seconds"], N_BLOCKS, 0, launches),
                          replays=replays, graph_pool_gib=check_graph_memory(f"contest {name}"))
        del drv, shadow

    # move_pages(): one blocking call; the application's writes stop while it
    # runs.  A live leap of the first blocks makes the busy set it must skip.
    release()
    pc, drv, io = contest_pool(dev, SEED + 3)
    session = drv.default_session()
    reset_launch_counts()
    t0 = time.perf_counter()
    session.leap(np.arange(CONTEST["busy_blocks"]), 1)
    for _ in range(2):
        with no_host_sync(dev):
            session.tick()
        io.step(drv)
    ids = np.arange(N_BLOCKS)
    busy = np.nonzero(busy_mask(drv.state, ids).cpu().numpy() | drv.in_migration(ids))[0]
    k1 = leap_copy.copy_blocks.launches
    t1 = time.perf_counter()
    res = SyncResharder(pc).migrate_driver(drv, ids, 1)
    call_s = time.perf_counter() - t1
    k1 = leap_copy.copy_blocks.launches - k1
    check(force_launches_k1(drv.state), "SyncResharder's force phase moved its payload through K1")
    check(np.array_equal(res.failed, busy) and len(busy) > 0,
          "SyncResharder failed exactly the busy set it saw")
    check(len(res.migrated) + len(res.failed) == N_BLOCKS, "and moved every other block")
    while not drv.done:  # the live leap finishes under writes
        with no_host_sync(dev):
            session.tick()
        io.step(drv)
    check(session.drain(), "the live leap drains")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    io.check(drv)
    check(drv.verify_mirror() and (drv.host_placement() == 1).all(), "every block in region 1")
    arms["sync_resharder"] = dict(
        arm_record(drv, seconds, len(res.migrated), res.bytes_touched - res.bytes_copied,
                   launches), call_s=call_s,
        failed=len(res.failed), bytes_copied_call=res.bytes_copied,
        bytes_touched_call=res.bytes_touched, call_k1_launches=k1,
        graph_pool_gib=check_graph_memory("contest sync_resharder"))
    del drv, io

    # auto-NUMA: a fixed number of scans; each sees one tick's writes and
    # reads (from region 1) and forces its hot picks into fresh slots
    release()
    pc, drv, io = contest_pool(dev, SEED + 3)
    ab = AutoBalancer(pc, N_BLOCKS, AutoBalanceConfig(hot_threshold=1))
    reset_launch_counts()
    t0 = time.perf_counter()
    moved = 0
    for _ in range(CONTEST["scans"]):
        io.write(drv)
        rids = io.read(drv)
        ab.observe_driver(drv, rids.numpy(), reader_region=1)
        ab.observe_writes(IO_PER_TICK)
        moved += ab.scan_driver(drv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    io.check(drv)
    check(drv.verify_mirror() and int((drv.host_placement() == 1).sum()) == moved,
          "the balancer's moves, and only they, live in region 1")
    arms["autobalancer"] = dict(arm_record(drv, seconds, moved, moved * pc.block_bytes, launches),
                                scans=CONTEST["scans"])
    del drv, io
    for name, a in arms.items():
        print(f"contest {name}: {a['blocks_moved']} blocks moved in {a['seconds']:.3f} s, "
              f"{a['bytes_copied']} B copied, {a['bytes_touched']} B touched, "
              f"{a['dispatches_per_tick']:.2f} programs a tick over {a['ticks']} ticks "
              f"(graphed), {a['dirty_rejections']} rejections, launches {a['launches']} "
              f"[{card()}]")
    sync = arms["sync_resharder"]
    print(f"contest sync_resharder call: {sync['call_s']:.3f} s, K1 {sync['call_k1_launches']} "
          f"launches for {sync['blocks_moved']} forced blocks, graph pools "
          f"{sync['graph_pool_gib']:.3f} GiB [{card()}]")
    return arms


def force_launches_k1(state) -> bool:
    """Whether every captured megastep over ``state`` with a force phase
    launches K1 once for it (and once more for its copy phase), from the
    launch counts its capture recorded; and at least one such graph exists."""
    n = 0
    for key, graphs_ in migrator.MEGASTEP._variants.items():
        lengths = key[0]  # the operands' lengths: force_ids at index 8, copy_src at 11
        for binding, graph in graphs_.items():
            if lengths[8] and binding[0][0] == state.pool.data_ptr():
                n += 1
                want = 1 + bool(lengths[11])
                if graph.delta.get((leap_copy.copy_blocks, "launches"), 0) != want:
                    return False
    return n > 0


def tiering_loop(dev) -> dict:
    """fig11's shape at full size: 131,072 blocks of 64 KiB on a cxl_pooled
    (2, 1) pool with 2 MiB huge blocks, half of them far; a working set of
    far blocks read every tick rotates onto other far blocks mid-run, with
    writes; ``TieringPolicy.maybe_apply`` every tick."""
    release()
    topo = NumaTopology.cxl_pooled(2, 1)
    pc = PoolConfig(3, TIER["slots"], BLOCK, torch.float32, huge_factor=HUGE, topology=topo)
    half = N_BLOCKS // 2
    place = np.concatenate([np.repeat([0, 1], half // 2), np.full(half, 2)]).astype(np.int32)
    state = init_state(pc, N_BLOCKS, place, device=dev)
    io = AppIO(dev, N_BLOCKS, BLOCK, SEED + 4)
    io.fill(state)
    drv = MigrationDriver(state, pc, LeapConfig(**DRAIN_CFG))
    near_groups = half // HUGE
    check(drv.adopt_huge(np.arange(near_groups)) == near_groups, "the near groups are huge")
    policy = TieringPolicy(drv, TieringConfig(max_promotions=TIER["working_set"]))
    far = np.random.default_rng(SEED).permutation(np.arange(half, N_BLOCKS))
    sets = [far[: TIER["working_set"]], far[TIER["working_set"] : 2 * TIER["working_set"]]]
    session = drv.default_session()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    tick_s = epoch_s = 0.0
    for t in range(TIER["ticks"]):
        io.write(drv)
        io.read(drv, torch.from_numpy(sets[t >= TIER["rotate"]]))
        t1 = time.perf_counter()
        policy.maybe_apply(session)  # an epoch's heat read is a host sync by design
        t2 = time.perf_counter()
        with no_host_sync(dev):
            session.tick()
        tick_s += time.perf_counter() - t2
        epoch_s += t2 - t1
    check(session.drain(), "the policy's moves drain")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    io.check(drv)
    check(drv.verify_mirror() and drv.verify_tiers(), "mirror and two-tier table consistent")
    s = drv.stats
    check(s.tier_promotions > 0 and s.tier_demotions > 0, "hot blocks promoted, cold runs demoted")
    placement = drv.host_placement()
    hot_near = float(np.isin(placement[sets[1]], (0, 1)).mean())
    check(hot_near > 0.5, "most of the rotated working set now lives near")
    text = session.telemetry().metrics_text()
    gauges = {line.split()[0]: int(float(line.split()[1])) for line in text.splitlines()
              if line.startswith("tier_resident_bytes")}
    check(sum(gauges.values()) == N_BLOCKS * pc.block_bytes, "the residency gauges cover the pool")
    check(launches["copy_blocks"] > 0 and launches["copy_runs"] > 0 and launches["heat_scan"] > 0,
          "promotions copied blocks, demotions copied runs, and every tick scanned heat")
    out = dict(ticks=s.ticks, seconds=seconds, tick_s=tick_s, epoch_s=epoch_s,
               tier_promotions=s.tier_promotions, tier_demotions=s.tier_demotions,
               ping_pong_migrations=s.ping_pong_migrations, blocks_migrated=s.blocks_migrated,
               dirty_rejections=s.dirty_rejections, bytes_copied=s.bytes_copied,
               bytes_copied_huge=s.bytes_copied_huge, rotated_set_near=hot_near,
               per_region=np.bincount(placement, minlength=3).tolist(), gauges=gauges,
               launches=launches)
    print(f"tiering loop: {s.ticks} ticks in {seconds:.3f} s (ticks {tick_s:.3f} s, epochs "
          f"{epoch_s:.3f} s), {s.tier_promotions} promoted, {s.tier_demotions} demoted, "
          f"{s.ping_pong_migrations} ping-pongs, rotated set {hot_near:.3f} near, blocks a "
          f"region {out['per_region']}, {gauges}, launches {launches}")
    del drv, io
    return out


def failed_region_drain(dev) -> dict:
    """A four-socket server loses region 3: ``drain_region`` evacuates its
    32,768 blocks of 64 KiB by ``drain_plan`` while the application writes
    and reads."""
    release()
    pc = PoolConfig(FAILED["regions"], FAILED["slots"], BLOCK, torch.float32,
                    topology=NumaTopology.quad_socket())
    place = start_regions(N_BLOCKS, FAILED["regions"])
    state = init_state(pc, N_BLOCKS, place, device=dev)
    io = AppIO(dev, N_BLOCKS, BLOCK, SEED + 5)
    io.fill(state)
    drv = MigrationDriver(state, pc, LeapConfig(**DRAIN_CFG))
    session = drv.default_session()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    n = drain_region(drv, FAILED["region"])
    while not drv.done:
        with no_host_sync(dev):
            session.tick()
        io.step(drv)
    check(session.drain(), "the evacuation drains")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    io.check(drv)
    placement = drv.host_placement()
    check(n == N_BLOCKS // FAILED["regions"] and not (placement == FAILED["region"]).any(),
          "every block left the failed region")
    check(drv.verify_mirror(), "host table mirror == device table")
    s = drv.stats
    check(s.blocks_migrated + s.blocks_forced == n == s.blocks_requested, "accounting closes")
    out = dict(blocks=n, seconds=seconds, ticks=s.ticks, dirty_rejections=s.dirty_rejections,
               blocks_forced=s.blocks_forced, bytes_copied=s.bytes_copied,
               gib_per_s=n * pc.block_bytes / seconds / 2**30,
               per_region=np.bincount(placement, minlength=4).tolist(),
               bytes_per_link={f"{a}->{b}": v for (a, b), v in sorted(s.bytes_per_link.items())},
               launches=launches)
    print(f"failed-region drain: {n} blocks off region {FAILED['region']} in {seconds:.3f} s "
          f"({out['gib_per_s']:.3f} GiB/s), {s.ticks} ticks, {s.dirty_rejections} rejections, "
          f"blocks a region {out['per_region']}, links {out['bytes_per_link']}, "
          f"launches {launches}")
    del drv, io
    return out


def timed_query(store, which: str, param: float):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tpch.run_query(store, which, param)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tpch_over_a_leap(dev) -> dict:
    """fig8 at its 1 GB size: Q1 and Q6 over a morsel store at rest, then
    while every morsel leaps from region 0 to 1 under the L_ORDERKEY writer."""
    release()
    t0 = time.perf_counter()
    data = tpch.gen_lineitem(TPCH["rows"], seed=SEED)
    params = {"q1": TPCH["q1_cutoff"], "q6": TPCH["q6_year"]}
    want = {"q1": tpch.q1_reference(data, params["q1"]),
            "q6": tpch.q6_reference(data, params["q6"])}
    # Q1's count column is exact in fp32 below 2**24 rows a group
    check(want["q1"][:, 5].max() < 2**24, "each Q1 group stays under 2**24 rows")
    store = MorselStore.create(data, TPCH["rows_per_morsel"], 2,
                               leap=LeapConfig(initial_area_blocks=256, budget_blocks_per_tick=1024))
    check(store.driver.state.device.type == "cuda", "the store lives on the card")
    del data
    setup_s = time.perf_counter() - t0

    def agrees(which, got) -> None:
        torch.testing.assert_close(got.double().cpu(),
                                   torch.tensor(want[which], dtype=torch.float64),
                                   rtol=1e-3, atol=0)

    rest, rest_ms = {}, {}
    for which, p in params.items():
        got, sec = timed_query(store, which, p)
        again, sec2 = timed_query(store, which, p)
        agrees(which, got)
        check(torch.equal(got, again), f"{which} repeats bit for bit on the card")
        if which == "q1":
            check(torch.equal(got[:, 5].double().cpu(), torch.from_numpy(want["q1"][:, 5])),
                  "Q1's counts are exact")
        rest[which], rest_ms[which] = got, [sec * 1e3, sec2 * 1e3]
    reset_launch_counts()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    store.steal(np.arange(store.n_morsels), 1)
    during_ms = {"q1": [], "q6": []}
    tick_s = 0.0
    while not store.driver.done:
        t1 = time.perf_counter()
        with no_host_sync(dev):
            store.tick()
        tick_s += time.perf_counter() - t1
        store.write_random_fields(rng, TPCH["writes"], tpch.ORDERKEY, -1.0)
        for which, p in params.items():
            got, sec = timed_query(store, which, p)
            # the writer touches no column Q1 or Q6 reads: the same bits as at rest
            check(torch.equal(got, rest[which]), f"{which} during the leap equals {which} at rest")
            during_ms[which].append(sec * 1e3)
    check(store.drain(), "the leap drains")
    torch.cuda.synchronize()
    leap_s = time.perf_counter() - t0
    launches = launch_counts()
    drv = store.driver
    check(drv.verify_mirror() and (store.placement() == 1).all(), "every morsel in region 1")
    written = drv.read(np.arange(store.n_morsels), note=False)[..., tpch.ORDERKEY]
    check(bool((written == -1.0).any()), "the writer's field writes landed")
    s = drv.stats
    out = dict(rows=TPCH["rows"], morsels=store.n_morsels, setup_s=setup_s,
               rest_ms=rest_ms, during_leap_ms=during_ms,
               during_leap_ms_median={k: statistics.median(v) for k, v in during_ms.items()},
               leap_s=leap_s, tick_s=tick_s, ticks=s.ticks, dirty_rejections=s.dirty_rejections,
               q1_max_rel_err=float(np.max(np.abs(rest["q1"].double().cpu().numpy() - want["q1"])
                                           / np.abs(want["q1"]))),
               q6_rel_err=abs(float(rest["q6"]) - want["q6"]) / abs(want["q6"]),
               launches=launches)
    print(f"TPC-H over {store.n_morsels} morsels: Q1 {rest_ms['q1'][0]:.1f} ms and Q6 "
          f"{rest_ms['q6'][0]:.1f} ms at rest; during the leap (median of {len(during_ms['q1'])}) "
          f"Q1 {out['during_leap_ms_median']['q1']:.1f} ms, Q6 "
          f"{out['during_leap_ms_median']['q6']:.1f} ms; leap {leap_s:.3f} s over {s.ticks} "
          f"ticks, {s.dirty_rejections} rejections; Q1 max rel err {out['q1_max_rel_err']:.3g}, "
          f"Q6 {out['q6_rel_err']:.3g}; launches {launches}")
    del store, drv
    return out


# -- phases 20-22: the chaos harness and the load generator ----------------------


def run_chaos(spec, dev):
    """Run ``spec`` on ``dev``: the driver, its report and the wall seconds."""
    chaos = ChaosDriver(spec, device=dev)
    t0 = time.perf_counter()
    report = chaos.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return chaos, report, time.perf_counter() - t0


def chaos_state(chaos, report) -> tuple:
    """What a chaos run must agree on across devices: its report, stats, host
    table, state leaves and (without serving) the shadow, on the host."""
    drv = chaos.driver
    shadow = () if chaos.shadow is None else (chaos.shadow.cpu().numpy(),)
    return (dataclasses.asdict(report), dataclasses.asdict(drv.stats),
            (drv.host_table(),) + drv.state.to_numpy() + shadow)


def chaos_card_matches_cpu(dev, spec) -> dict:
    """One scenario on the card and on the CPU: the same report, stats, host
    table, pool, flags and shadow, bit for bit."""
    *card, card_s = run_chaos(spec, dev)
    *host, cpu_s = run_chaos(spec, torch.device("cpu"))
    (rep, stats, leaves), (rep_c, stats_c, leaves_c) = chaos_state(*card), chaos_state(*host)
    what = f"seed {spec.seed} ({spec.dispatch})"
    check(rep == rep_c, f"{what}: the same ChaosReport on the card and on the CPU")
    check(stats == stats_c, f"{what}: the same MigrationStats")
    check(all(np.array_equal(a, b) for a, b in zip(leaves, leaves_c)),
          f"{what}: host table, pool, flags and shadow bit for bit")
    check(rep["completed"], f"{what}: the final drain completes")
    print(f"chaos seed {spec.seed} ({spec.workload}/{spec.scheduler}, {spec.dispatch}): "
          f"{rep['ticks_run']} ticks, {rep['checks_run']} checks, events "
          f"{rep['events_fired']}, card {card_s:.3f} s, CPU {cpu_s:.3f} s, the same")
    return dict(seed=spec.seed, workload=spec.workload, dispatch=spec.dispatch,
                scheduler=spec.scheduler, regions=spec.n_regions, ticks=rep["ticks_run"],
                checks=rep["checks_run"], events=rep["events_fired"],
                migrated=rep["blocks_migrated"], forced=rep["blocks_forced"],
                cancelled=rep["blocks_cancelled"], card_s=card_s, cpu_s=cpu_s)


def chaos_sweep(dev) -> dict:
    """Phase 20: ``sample_spec`` seeds 0-7 (megastep, as sampled), and seed 2
    under batched and legacy, on the card and on the CPU; the
    ``skip_quarantine`` sabotage caught and replayed on the card; and a
    chaos serving scenario on the card."""
    reset_launch_counts()
    specs = [sample_spec(seed) for seed in CHAOS_SEEDS]
    specs += [dataclasses.replace(sample_spec(2), dispatch=m) for m in ("batched", "legacy")]
    seeds = [chaos_card_matches_cpu(dev, spec) for spec in specs]
    with tempfile.TemporaryDirectory() as repro_dir:
        try:
            run_with_repro(SABOTAGE_SPEC, repro_dir, sabotage="skip_quarantine", device=dev)
            raise RuntimeError("check failed: the sabotage went unnoticed on the card")
        except InvariantViolation as e:
            caught = e
        replay = ScenarioSpec.from_json((Path(repro_dir) / "last_failure.json").read_text())
    check(caught.invariant == "payload" and replay == SABOTAGE_SPEC,
          "the sabotage is caught as a payload violation and its spec serialized")
    try:
        run_scenario(replay, sabotage="skip_quarantine", device=dev)
        raise RuntimeError("check failed: the replayed sabotage went unnoticed")
    except InvariantViolation as e:
        check(str(e) == str(caught.__cause__), "the replay reproduces the same violation")
    check(run_scenario(replay, device=dev).completed, "the clean replay passes")
    before = launch_counts()["paged_decode"]
    serving, rep, serving_s = run_chaos(SERVING_CHAOS, dev)
    served = launch_counts()["paged_decode"] - before
    check(rep.completed and rep.checks_run > SERVING_CHAOS.ticks and rep.blocks_requested > 0,
          "the chaos serving scenario drains, checked every tick, under churn")
    check(served > 0 and served % 2 == 0, "the serving scenario decoded through K4")
    launches = launch_counts()
    print(f"chaos sabotage caught on the card: {caught.invariant}; serving scenario "
          f"{serving_s:.3f} s, {rep.ticks_run} ticks, {rep.checks_run} checks, "
          f"{rep.blocks_migrated} migrated, launches {launches}")
    return dict(seeds=seeds, sabotage=caught.invariant,
                serving=dict(seconds=serving_s, ticks=rep.ticks_run, checks=rep.checks_run,
                             blocks_requested=rep.blocks_requested,
                             blocks_migrated=rep.blocks_migrated,
                             load=serving.generator.report()),
                launches=launches)


def chaos_at_scale(dev) -> dict:
    """Phase 21: the failed-region drain's pool under the chaos harness: a
    four-region exchange of 2 GiB under writes, a congested link, a write
    burst, region 3's loss, a cancel storm and the topology restored."""
    release()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chaos = ChaosDriver(CHAOS_AT_SCALE, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    checker_s = [0.0]
    for name in ("check_all", "check_final"):
        inner = getattr(chaos.checker, name)

        def timed(*args, _inner=inner, **kw):
            t = time.perf_counter()
            try:
                return _inner(*args, **kw)
            finally:
                checker_s[0] += time.perf_counter() - t

        setattr(chaos.checker, name, timed)
    reset_launch_counts()
    t0 = time.perf_counter()
    rep = chaos.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    check(rep.completed, "the scenario drains and check_final holds")
    s = chaos.driver.stats
    check(rep.blocks_migrated + rep.blocks_forced + rep.blocks_cancelled == rep.blocks_requested,
          "accounting closes")
    check(len(rep.events_fired) == len(CHAOS_AT_SCALE.faults), "every fault fired")
    check(launches["copy_blocks"] > 0 and launches["heat_scan"] > 0,
          "the scenario copied through K1 and scanned heat through K3")
    out = dict(setup_s=setup_s, seconds=seconds, checker_s=checker_s[0],
               tick_s=seconds / rep.ticks_run, checks=rep.checks_run, ticks=rep.ticks_run,
               events=rep.events_fired, drain_refusals=rep.drain_refusals,
               handles=rep.handles_issued, blocks_requested=rep.blocks_requested,
               blocks_migrated=rep.blocks_migrated, blocks_forced=rep.blocks_forced,
               blocks_cancelled=rep.blocks_cancelled, dirty_rejections=s.dirty_rejections,
               payload_gib=CHAOS_AT_SCALE.n_blocks * chaos.driver.pool_cfg.block_bytes / 2**30,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches)
    print(f"chaos at scale: {dataclasses.asdict(rep) | {'spec': 'CHAOS_AT_SCALE'}}")
    print(f"chaos at scale: {seconds:.3f} s over {rep.ticks_run} ticks "
          f"({out['tick_s'] * 1e3:.1f} ms a tick), checker {checker_s[0]:.3f} s in "
          f"{rep.checks_run} checks, setup {setup_s:.3f} s, peak {out['peak_gib']:.2f} GiB, "
          f"launches {launches}")
    del chaos
    return out


def load_run(dev, cfg, model, pcfg, spec):
    """Drive ``spec`` through a ``LoadGenerator`` over a fresh engine, with
    blocking harvest, the chaos harness's structural invariants and the
    generator's page accounting after every tick.  Returns the generator,
    every sequence's tokens and the timings."""
    eng = PagedEngine(cfg, model, pcfg, device=dev)
    gen = LoadGenerator(eng, spec, scheduler=eng.driver.scheduler)
    checker = InvariantChecker(eng.driver)
    tokens, release_seq = {}, eng.release

    def keep_tokens(sid):
        tokens[sid] = list(eng.seqs[sid].tokens)
        release_seq(sid)

    eng.release = keep_tokens
    decode, calls = eng.decode, []

    def counted_decode(sids, **kw):
        calls.append(len(sids))
        return decode(sids, **kw)

    eng.decode = counted_decode
    tick_s, check_s = [], 0.0
    for _ in range(spec.ticks):
        t0 = time.perf_counter()
        gen.step()
        eng.session.poll(block=True)
        tick_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        checker.check_all(payload=False)
        gen.verify_accounting()
        check_s += time.perf_counter() - t0
    tokens.update({sid: list(seq.tokens) for sid, seq in eng.seqs.items()})
    prog = eng._decode_step
    if dev.type == "cuda":
        check(prog.replays == len(calls) > 0 and prog.captures == len(prog) == len(set(calls)),
              "every decode call was one replay, one captured graph per batch size")
    return gen, tokens, dict(tick_s=tick_s, check_s=check_s, decode_calls=len(calls),
                             batch_sizes=sorted(set(calls)), replays=prog.replays,
                             captures=prog.captures)


def load_full_width(dev) -> dict:
    """Phase 22: granite_3_2b at full width served by the open-loop load
    generator under the SLO scheduler, with live KV churn, twice."""
    release()
    cfg, model, pcfg, _ = serving_deployment(dev)
    pcfg = dataclasses.replace(pcfg, scheduler="slo")
    spec = WorkloadSpec(tenants=LOAD_TENANTS, **LOAD)
    runs, out = [], {}
    for i in range(2):
        reset_launch_counts()
        t0 = time.perf_counter()
        gen, tokens, times = load_run(dev, cfg, model, pcfg, spec)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        rep = gen.report(warmup=LOAD_WARMUP)
        runs.append((rep, tokens))
        s = gen.engine.driver.stats
        check(launches["paged_decode"] > 0 and launches["paged_decode"] % cfg.n_layers == 0,
              "paged decode launched once per layer and decode call")
        check(rep["blocks_copied"] > 0 and s.blocks_requested > 0, "churn migrated KV pages")
        out[f"run{i}"] = dict(
            seconds=seconds, tick_ms_median=statistics.median(times["tick_s"]) * 1e3,
            tick_ms_max=max(times["tick_s"]) * 1e3, check_s=times["check_s"],
            admitted=len(gen.done) + len(gen.live), completed=rep["completed"],
            dropped=rep["dropped"], queued=rep["queued"], p50=rep["p50"], p99=rep["p99"],
            gold_p99=rep["tenants"]["gold"]["p99"], gold_slo_met=rep["tenants"]["gold"]["slo_met"],
            mig_rate=rep["mig_rate"], blocks_copied=rep["blocks_copied"],
            max_running=max(e["n_running"] for e in gen.tick_log),
            dirty_rejections=s.dirty_rejections, decode_calls=times["decode_calls"],
            batch_sizes=times["batch_sizes"], replays=times["replays"],
            captures=times["captures"], launches=launches)
        o = out[f"run{i}"]
        print(f"load run {i}: modeled p50 {rep['p50']:.4f} p99 {rep['p99']:.4f} (gold p99 "
              f"{o['gold_p99']:.4f}, SLO met {o['gold_slo_met']}), mig_rate "
              f"{rep['mig_rate']:.4f}, admitted {o['admitted']}, dropped {rep['dropped']}, "
              f"at most {o['max_running']} running; wall {seconds:.3f} s, tick "
              f"{o['tick_ms_median']:.1f} ms median ({o['tick_ms_max']:.1f} max), checks "
              f"{times['check_s']:.3f} s; {o['replays']} decode replays over batch sizes "
              f"{o['batch_sizes']}; launches {launches}")
        del gen
    check(runs[0][0] == runs[1][0], "gen.report() is bit-identical run to run")
    check(runs[0][1] == runs[1][1], "every sequence's tokens are identical run to run")
    del model
    release()
    return dict(config="granite_3_2b", layers=cfg.n_layers,
                dtype=str(cfg.dtype()).removeprefix("torch."), spec=json.loads(spec.to_json()),
                warmup=LOAD_WARMUP, report=runs[0][0], runs=out)


def load_card_matches_cpu(dev) -> dict:
    """The reduced load run (benchmarks/serving_slo.py's setting: two-layer
    granite, f32, TF32 off, the same weights) on the card and on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduce(get_config("granite_3_2b")), n_layers=2)
    cpu_model = lm.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    models = {"cuda": copy.deepcopy(cpu_model).to(dev), "cpu": cpu_model}
    pcfg = PagedConfig(block_tokens=4, max_blocks_per_seq=16, n_regions=2, slots_per_region=96,
                       leap=LeapConfig(initial_area_blocks=2, chunk_blocks=1,
                                       budget_blocks_per_tick=8, max_attempts_before_force=4),
                       scheduler="slo")
    spec = WorkloadSpec(**LOAD, tenants=(
        TenantSpec("gold", rate=0.45, prompt_tokens=6, decode_tokens=10, slo_latency=2.5,
                   priority=2, region=0),
        TenantSpec("batch", rate=0.3, prompt_tokens=8, decode_tokens=14, slo_latency=10.0,
                   priority=0, region=1)))
    res = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        if name == "cuda":
            reset_launch_counts()
        gen, tokens, _ = load_run(d, cfg, models[name], pcfg, spec)
        res[name] = (gen, tokens, launch_counts() if name == "cuda" else None)
    (gpu, gtok, launches), (cpu, ctok, _) = res["cuda"], res["cpu"]
    rep = gpu.report(warmup=LOAD_WARMUP)
    check(rep == cpu.report(warmup=LOAD_WARMUP), "card and CPU give the same gen.report()")
    check(gpu.tick_log == cpu.tick_log, "and the same tick log")
    check(gtok == ctok, "card and CPU decode the same tokens")
    check(np.array_equal(gpu.engine.driver.host_table(), cpu.engine.driver.host_table()),
          "host tables agree")
    check(launches["paged_decode"] > 0, "the card's run decoded through K4")
    print(f"reduced load run on the card and on the CPU agrees: p99 {rep['p99']:.4f}, "
          f"mig_rate {rep['mig_rate']:.4f}, {len(gtok)} sequences, launches {launches}")
    return dict(report=rep, sequences=len(gtok), launches=launches)


# -- phase 6: the paged-decode kernel against its plain version ----------------


def paged_inputs(dev, dtype, lens: torch.Tensor, seed: int, p=PAGED):
    """q, the strided view of layer ``p["layer"]`` of a ``p["layers"]``-layer
    pool, tables of distinct slots, and ``lens``; everything from seeded
    generators."""
    g = torch.Generator(device=dev).manual_seed(seed)
    host = torch.Generator().manual_seed(seed)
    pool = torch.randn((p["slots"], p["layers"], 2, p["blk"], p["kvh"], p["hd"]),
                       generator=g, device=dev, dtype=dtype)
    q = torch.randn((p["b"], p["h"], p["hd"]), generator=g, device=dev, dtype=dtype)
    tables = torch.randperm(p["slots"], generator=host)[: p["b"] * p["maxb"]]
    tables = tables.view(p["b"], p["maxb"]).int().to(dev)
    return q, pool[:, p["layer"]], tables, lens.int().to(dev)


def paged_bound(q, view, lens_host, p=PAGED) -> tuple[float, str]:
    """Each input byte read once and each output written once: the K and V
    rows of every token below len, q, the valid table entries and lens; out,
    m and l.  Operations: 4 flops per token, query head and head element."""
    toks = int(lens_host.sum())
    kv_bytes = toks * p["kvh"] * p["hd"] * 2 * view.element_size()
    pages = int(((lens_host + p["blk"] - 1) // p["blk"]).sum())
    n_bytes = (kv_bytes + 2 * q.numel() * q.element_size() + pages * 4 + p["b"] * 4
               + 2 * p["b"] * p["h"] * 4)
    return bound_ms(n_bytes, 4.0 * toks * p["h"] * p["hd"])


def paged_timings(q, view, tables, lens, lens_host, p=PAGED) -> dict:
    qg = q.view(p["b"], p["kvh"], p["h"] // p["kvh"], p["hd"])
    tok = torch.arange(p["maxb"] * p["blk"], device=q.device)
    mask = (tok[None, :] < lens[:, None].long())[:, None, None, :]  # [B, 1, 1, T]

    def library():  # gather the pages, then one fused attention call
        kv = view[tables.long()].transpose(1, 2)  # [B, 2, MAXB, BLK, KVH, hd]
        k = kv[:, 0].reshape(p["b"], -1, p["kvh"], p["hd"]).transpose(1, 2)
        v = kv[:, 1].reshape(p["b"], -1, p["kvh"], p["hd"]).transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]

    want = ref.paged_decode_ref(q, view, tables, lens)[0]
    b, by = paged_bound(q, view, lens_host, p)
    return dict(
        ms=time_ms(lambda: paged_attn.paged_decode(qg, view, tables, lens)),
        plain_ms=time_ms(lambda: ref.paged_decode_ref(q, view, tables, lens)),
        library_ms=time_ms(library), bound_ms=b, bound_by=by,
        library_max_abs_err=float((library().float() - want.float()).abs().max()),
        tokens=int(lens_host.sum()),
    )


def paged_grid(lens_host, p=PAGED) -> str:
    """The grid the wrapper launches and, by the kernel's exit rule, the CTAs
    in it that do work: derived from the shapes, not measured."""
    split = paged_attn.SPLIT_TOKENS
    live = p["kvh"] * sum(max(1, -(-int(n) // split)) for n in lens_host)
    return (f"{live} of {p['b'] * p['kvh'] * paged_attn.decode_splits(p['maxb'], p['blk'])} "
            f"CTAs live by the {split}-token split rule")


def paged_decode_checks(dev) -> dict:
    p = PAGED
    host = torch.Generator().manual_seed(SEED)
    lens = torch.randint(2, p["maxb"] * p["blk"], (p["b"],), generator=host)
    lens[0], lens[-1] = 1, p["maxb"] * p["blk"]  # one sequence of 1 token, one of 1024
    split = paged_attn.SPLIT_TOKENS  # lens on and around the kernel's split boundaries
    split_lens = torch.tensor([1, split - 1, split, split + 1, 2 * split, 3 * split + 1,
                               9 * split, p["maxb"] * p["blk"]])
    errs = {}
    for dtype, softcap in ((torch.bfloat16, 0.0), (torch.float32, 20.0)):
        q, view, tables, lens_d = paged_inputs(dev, dtype, lens, SEED)
        check(not view.is_contiguous(), "the kernel reads a strided per-layer view")
        for name, lh in (("mixed", lens), ("split boundaries", split_lens)):
            ld = lh.int().to(dev)
            got = ops.paged_decode_partial(q, view, tables, ld, kv_heads=p["kvh"], softcap=softcap)
            again = ops.paged_decode_partial(q, view, tables, ld, kv_heads=p["kvh"],
                                             softcap=softcap)
            want = ops.paged_decode_partial(q, view, tables, ld, kv_heads=p["kvh"],
                                            softcap=softcap, impl="ref")
            torch.cuda.synchronize()
            for a, b, w in zip(got, again, want):
                check(torch.equal(a, b), f"paged_decode {dtype} {name} is bit-identical run to run")
                torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[dtype])
            check(torch.equal(got[2][0], torch.ones_like(got[2][0])),
                  "a 1-token sequence has l == 1")
            pad = (torch.arange(p["maxb"], device=dev)[None, :]
                   >= (ld[:, None] + p["blk"] - 1) // p["blk"])
            garbage = tables.masked_fill(pad, 2**31 - 1)  # out of range: any read would fault
            unread = ops.paged_decode_partial(q, view, garbage, ld, kv_heads=p["kvh"],
                                              softcap=softcap)
            check(all(torch.equal(a, b) for a, b in zip(unread, got)),
                  f"paged_decode {dtype} {name} reads no pad table entry")
            errs[(str(dtype), name)] = max(float((a.float() - w.float()).abs().max())
                                           for a, w in zip(got, want))
            del got, again, want, unread
        if dtype == torch.bfloat16:
            row_t = paged_timings(q, view, tables, lens_d, lens)
            serve_lens = torch.full((p["b"],), SERVE["prompt_len"] + SERVE["steps"] // 2)
            at_serving = paged_timings(q, view, tables, serve_lens.int().to(dev), serve_lens)
        del q, view, tables
        torch.cuda.empty_cache()
    bf16, f32 = str(torch.bfloat16), str(torch.float32)
    row = dict(
        name="paged_decode", route="cuda", source="src/repro_torch/kernels/csrc/paged_attn.cu",
        replaces="src/repro/kernels/paged_attn.py:101", launches=0,
        max_abs_err=errs[(bf16, "mixed")], **row_t,
        f32_softcap_max_abs_err=errs[(f32, "mixed")],
        split_boundaries=dict(lens=split_lens.tolist(),
                              bf16_max_abs_err=errs[(bf16, "split boundaries")],
                              f32_softcap_max_abs_err=errs[(f32, "split boundaries")]),
        shape=(f"q [{p['b']}, {p['h']}, {p['hd']}] bf16, layer {p['layer']} of a "
               f"[{p['slots']}, {p['layers']}, 2, {p['blk']}, {p['kvh']}, {p['hd']}] pool, "
               f"MAXB {p['maxb']}, lens {lens.tolist()}"),
        at_serving_lens=at_serving,
        at_moe_decode_shapes=paged_moe_rows(dev),
    )
    print(f"paged_decode: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, library "
          f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f}, {paged_grid(lens)}), max err "
          f"bf16 {errs[(bf16, 'mixed')]:.3g}, f32 softcap "
          f"{errs[(f32, 'mixed')]:.3g}; at serving lens {at_serving['ms']:.4f} ms (library "
          f"{at_serving['library_ms']:.4f}, bound {at_serving['bound_ms']:.4f}, "
          f"{paged_grid(serve_lens)}); at split boundaries {split_lens.tolist()} max "
          f"err bf16 {errs[(bf16, 'split boundaries')]:.3g}, f32 softcap "
          f"{errs[(f32, 'split boundaries')]:.3g}")
    return row


def paged_moe_rows(dev) -> dict:
    """Phase 6 at the MoE stacks' decode shapes (phase 23's pools, the lens of
    its middle decode step): bf16 against the plain version, then timed."""
    out = {}
    for spec in MOE_SERVE:
        p = PAGED_MOE[spec["config"]]
        lens = torch.full((p["b"],), spec["prompt_len"] + spec["steps"] // 2)
        q, view, tables, lens_d = paged_inputs(dev, torch.bfloat16, lens, SEED, p)
        got = ops.paged_decode_partial(q, view, tables, lens_d, kv_heads=p["kvh"])
        want = ops.paged_decode_partial(q, view, tables, lens_d, kv_heads=p["kvh"], impl="ref")
        for a, w in zip(got, want):
            torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[torch.bfloat16])
        row = dict(
            shape=(f"q [{p['b']}, {p['h']}, {p['hd']}] bf16 (G {p['h'] // p['kvh']}), layer "
                   f"{p['layer']} of a [{p['slots']}, {p['layers']}, 2, {p['blk']}, {p['kvh']}, "
                   f"{p['hd']}] pool, lens {int(lens[0])} each"),
            max_abs_err=max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)),
            **paged_timings(q, view, tables, lens_d, lens, p))
        print(f"paged_decode at {spec['config']}'s decode shape: {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f}, {paged_grid(lens, p)}), max err {row['max_abs_err']:.3g}")
        out[spec["config"]] = row
        del q, view, tables, got, want
        torch.cuda.empty_cache()
    return out


# -- phases 7 and 10: serving through PagedEngine ------------------------------


def serve_run(dev, cfg, model, pcfg, prompts, steps: int, live: bool, blocking: bool = False):
    """Admit the prompts (alternating regions), then decode ``steps`` tokens;
    with ``live``, sequences 0 and 1 leap to the other region after the first
    step and the session ticks before every later step.  Returns the engine,
    the sequence ids, the rebalance handles and the timings."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    eng = PagedEngine(cfg, model, pcfg, device=dev)
    t0 = time.perf_counter()
    sids = [eng.admit(pr, region=i % pcfg.n_regions) for i, pr in enumerate(prompts)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    handles = []
    step_s, tick_s = [], 0.0
    for step in range(steps):
        if live and step == 1:
            # after the first step, so that the page holding the append
            # frontier is among the pages in flight
            handles = [eng.rebalance(s, 1 - eng.seqs[s].region) for s in sids[:2]]
        if handles:
            t1 = time.perf_counter()
            eng.tick()
            if blocking:
                eng.session.poll(block=True)
            tick_s += time.perf_counter() - t1
        t1 = time.perf_counter()
        eng.decode(sids)  # ends in the step's one device-to-host copy
        step_s.append(time.perf_counter() - t1)
    if live:
        check(eng.drain(), "the rebalances drain")
    times = dict(
        prefill_s=prefill_s, decode_s=sum(step_s),
        decode_step_ms_median=statistics.median(step_s) * 1e3,
        tokens_per_s=len(sids) * steps / sum(step_s), tick_s=tick_s,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None,
        replays=eng._decode_step.replays, captures=eng._decode_step.captures,
    )
    return eng, sids, handles, times


def check_serving(eng, sids, handles) -> dict:
    drv = eng.driver
    check(drv.verify_mirror(), "KV pool host table mirror == device table")
    for s, h in zip(sids, handles):
        ids = np.asarray(eng.seqs[s].block_ids)
        check((eng.facade.region_of(ids) == eng.seqs[s].region).all(),
              f"every page of sequence {s} lives in its new region")
        p = h.progress()
        check(p.committed + p.forced + p.cancelled == p.requested, "handle accounting closes")
    st = drv.stats
    check(st.blocks_migrated + st.blocks_forced + st.blocks_cancelled == st.blocks_requested,
          "engine accounting closes")
    acc = eng.page_accounting()
    check(acc["used"] + acc["spare"] + acc["free"] == acc["total"], "page accounting closes")
    return dict(blocks_requested=st.blocks_requested, blocks_migrated=st.blocks_migrated,
                blocks_forced=st.blocks_forced, dirty_rejections=st.dirty_rejections,
                ticks=st.ticks, pages=acc)


def serving_deployment(dev):
    """The full-width serving deployment: granite_3_2b with random bf16
    weights from seed 0 on ``dev``, its paged KV pool's config, and the
    prompts.  ``scripts/profile_serving.py`` profiles this same deployment."""
    cfg = get_config("granite_3_2b")
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(SERVE["prompts"], SERVE["prompt_len"]))
    return cfg, model, serving_pool(), prompts


def serving_pool() -> PagedConfig:
    """Phase 7's paged KV pool: pages of 16 tokens, 64 a sequence, 2 regions
    of 512 slots, tiering on (phase 23 serves the MoE stacks on it too)."""
    return PagedConfig(block_tokens=16, max_blocks_per_seq=64, n_regions=2, slots_per_region=512,
                       leap=LeapConfig(initial_area_blocks=4, budget_blocks_per_tick=8,
                                       tiering=True))


def serving_full_width(dev) -> dict:
    t0 = time.perf_counter()
    cfg, model, pcfg, prompts = serving_deployment(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    runs, out = {}, {}
    for name in ("undisturbed", "live"):
        reset_launch_counts()
        eng, sids, handles, times = serve_run(dev, cfg, model, pcfg, prompts, SERVE["steps"],
                                              live=name == "live")
        launches = launch_counts()
        runs[name] = ([eng.seqs[s].tokens for s in sids], eng.last_logits.clone())
        out[name] = dict(times, launches=launches)
        if name == "live":
            out[name].update(check_serving(eng, sids, handles))
            check(out[name]["dirty_rejections"] > 0, "decode appends dirtied in-flight pages")
            check(launches["copy_blocks"] > 0 and launches["heat_scan"] > 0,
                  "the live run launched copy_blocks and heat_scan")
        check(launches["paged_decode"] == SERVE["steps"] * cfg.n_layers,
              f"{name}: one paged-decode launch per layer and step")
        check(times["replays"] == SERVE["steps"] and times["captures"] == 1,
              f"{name}: every decode step was one replay of one captured graph")
        print(f"serving {name}: prefill {times['prefill_s']:.3f} s, decode step "
              f"{times['decode_step_ms_median']:.3f} ms (median), {times['tokens_per_s']:.1f} "
              f"tok/s, decode {times['decode_s']:.3f} s, ticks {times['tick_s']:.3f} s, peak "
              f"{times['peak_gib']:.2f} GiB, {times['replays']} replays, launches {launches}")
        del eng
        torch.cuda.empty_cache()
    check(runs["live"][0] == runs["undisturbed"][0],
          "tokens are identical with and without live migration")
    check(torch.equal(runs["live"][1], runs["undisturbed"][1]),
          "the last step's logits are bit-identical with and without live migration")
    del model
    torch.cuda.empty_cache()
    return dict(config="granite_3_2b", layers=cfg.n_layers, dtype="bfloat16", init_s=init_s,
                **SERVE, runs=out)


def serving_card_matches_cpu(dev, arch: str = "granite_3_2b") -> dict:
    """A reduced two-layer arch, f32 with TF32 off, served on the card and on
    the CPU (phase 10: granite; phase 29: nemotron)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduce(get_config(arch)), n_layers=2)
    cpu_model = lm.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    models = {"cuda": copy.deepcopy(cpu_model).to(dev), "cpu": cpu_model}
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (5, 9, 12, 16)]
    pcfg = PagedConfig(block_tokens=4, max_blocks_per_seq=16, n_regions=2, slots_per_region=64,
                       leap=LeapConfig(initial_area_blocks=2, chunk_blocks=1,
                                       budget_blocks_per_tick=1, max_attempts_before_force=3,
                                       tiering=True))
    res = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        eng, sids, _, _ = serve_run(d, cfg, models[name], pcfg, prompts, 10, live=True,
                                    blocking=True)
        res[name] = (eng, [eng.seqs[s].tokens for s in sids])
    (gpu, gtok), (cpu, ctok) = res["cuda"], res["cpu"]
    check(gtok == ctok, "card and CPU decode the same tokens")
    check(np.array_equal(gpu.driver.host_table(), cpu.driver.host_table()), "host tables agree")
    g_state, c_state = gpu.driver.state.to_numpy(), cpu.driver.state.to_numpy()
    np.testing.assert_allclose(g_state[0], c_state[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(g_state[1:], c_state[1:]):
        check(np.array_equal(a, b), "card and CPU tables and dirty/in-flight bits agree")
    torch.testing.assert_close(gpu.last_logits.cpu(), cpu.last_logits, rtol=1e-5, atol=1e-5)
    check(gpu.driver.stats == cpu.driver.stats, "card and CPU MigrationStats agree")
    diff = float((gpu.last_logits.cpu() - cpu.last_logits).abs().max())
    print(f"reduced {arch} served on the card and on the CPU agrees (logits within {diff:.3g})")
    return dict(path="PagedEngine", logits_max_abs_diff=diff)


# -- phase 8: the LRU-scan kernel against its plain version --------------------


def lru_inputs(dev, b: int, t: int, r: int, seed: int):
    """Decays in (0, 1) as the RG-LRU gates make them, normal inputs and h0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, t, r), generator=g, device=dev) + 2.0)
    x = torch.randn((b, t, r), generator=g, device=dev)
    return a, x, torch.randn((b, r), generator=g, device=dev)


def lru_scan_checks(dev) -> dict:
    b, t, r = RECUR["prompts"], RECUR["prompt_len"], get_config("recurrentgemma_9b").rnn_width
    a, x, h0 = lru_inputs(dev, b, t, r, SEED)
    got = ops.lru_scan(a, x, h0)
    again = ops.lru_scan(a, x, h0)
    want = ops.lru_scan(a, x, h0, impl="ref")
    torch.cuda.synchronize()
    check(torch.equal(got, want), "lru_scan f32 == plain version, bit for bit")
    check(torch.equal(got, again), "lru_scan is bit-identical run to run")
    a16, x16, h16 = a.bfloat16(), x.bfloat16(), h0.bfloat16()
    got16 = lru_scan.lru_scan(a16, x16, h16)
    want16 = ref.lru_scan_ref(a16, x16, h16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got16.float(), want16.float(), **LRU_BF16_TOL)
    bf16_err = float((got16.float() - want16.float()).abs().max())
    odd = lru_inputs(dev, 3, 17, 96, SEED + 1)
    check(torch.equal(lru_scan.lru_scan(*odd), ref.lru_scan_ref(*odd)),
          "lru_scan at T = 17, R = 96 == plain version, bit for bit")
    bound, by = lru_bound(a, h0)
    bound16, by16 = lru_bound(a16, h0)
    row = dict(
        name="lru_scan", route="cuda", source="src/repro_torch/kernels/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan.py:56", launches=0,
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(lambda: lru_scan.lru_scan(a, x, h0)),
        plain_ms=time_ms(lambda: ref.lru_scan_ref(a, x, h0), iters=2, repeats=3),
        bound_ms=bound, bound_by=by, library_ms=None,
        library="none (no single PyTorch call computes a linear recurrence)",
        shape=f"a, b, out [{b}, {t}, {r}] f32, h0 [{b}, {r}] f32",
        plan=lru_scan.lru_scan.last_plan.describe(),  # of the launches just timed
        bf16=dict(ms=time_ms(lambda: lru_scan.lru_scan(a16, x16, h16)), bound_ms=bound16,
                  bound_by=by16, max_abs_err=bf16_err,
                  plan=lru_scan.lru_scan.last_plan.describe()),
    )
    print(f"lru_scan: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound {bound:.4f}), "
          f"bit-exact f32; bf16 {row['bf16']['ms']:.4f} ms (bound {bound16:.4f}), max err "
          f"{bf16_err:.3g} [{card()}]")
    del a, x, h0, got, again, want, a16, x16, h16, got16, want16
    release()
    row["more"] = [lru_scan_timing(dev, 1, 32768, r, torch.float32),
                   lru_scan_timing(dev, 1, 32768, r, torch.bfloat16),
                   lru_scan_timing(dev, TRAIN_RECUR["batch"], TRAIN_RECUR["seq"], r,
                                   torch.float32)]
    return row


def lru_bound(a: torch.Tensor, h0: torch.Tensor) -> tuple[float, str]:
    """a and b read once, out written once, h0 read once; 2 flops an element."""
    return bound_ms(3 * a.numel() * a.element_size() + h0.numel() * 4, 2.0 * a.numel())


def lru_scan_timing(dev, b: int, t: int, r: int, dtype) -> dict:
    """K5 at [b, t, r] in ``dtype`` against its plain version (f32 bit for
    bit, and run to run; bf16 within ``LRU_BF16_TOL``), timed beside its
    bound, with the plan launched."""
    a, x, h0 = lru_inputs(dev, b, t, r, SEED + b)
    a, x = a.to(dtype), x.to(dtype)
    got, again = lru_scan.lru_scan(a, x, h0), lru_scan.lru_scan(a, x, h0)
    want = ref.lru_scan_ref(a, x, h0)
    torch.cuda.synchronize()
    what = f"lru_scan at [{b}, {t}, {r}] {str(dtype).removeprefix('torch.')}"
    check(torch.equal(got, again), f"{what} is bit-identical run to run")
    if dtype == torch.float32:
        check(torch.equal(got, want), f"{what} == plain version, bit for bit")
    else:
        torch.testing.assert_close(got.float(), want.float(), **LRU_BF16_TOL)
    bound, by = lru_bound(a, h0)
    res = dict(shape=f"a, b, out [{b}, {t}, {r}], h0 [{b}, {r}] f32",
               dtype=str(dtype).removeprefix("torch."),
               max_abs_err=float((got.float() - want.float()).abs().max()),
               ms=time_ms(lambda: lru_scan.lru_scan(a, x, h0), iters=10, repeats=5),
               bound_ms=bound, bound_by=by, plan=lru_scan.lru_scan.last_plan.describe())
    plan = res["plan"]
    print(f"{what}: {res['ms']:.4f} ms (bound {bound:.4f}, {bound / res['ms']:.0%} of it), max "
          f"err {res['max_abs_err']:.3g}; plan: {plan['ctas']} CTAs of {plan['channels_per_cta']} "
          f"channels, {plan['rows']} rows x {plan['stages']} stages, {plan['smem_bytes']} B "
          f"shared, {plan['in_flight_per_sm']} B in flight an SM, route {plan['route']} "
          f"[{card()}]")
    del a, x, h0, got, again, want
    release()
    return res


# -- phases 9 and 11: recurrentgemma_9b through lm.prefill and lm.decode_step ----


def recurrent_run(model, cfg, prompts: torch.Tensor, steps: int, feeds=None) -> dict:
    """Prefill the prompts, then ``steps`` greedy decode steps; returns the
    tokens, the last step's logits, the timings and the launch counts of each
    part.  A stub-frontend arch takes embeddings: ``prompts`` is [B, S, D]
    and ``feeds[i]`` ([B, 1, D]) is decode step i's input, where the others
    feed back the argmax token."""
    dev = prompts.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(model, prompts, cfg, prompts.shape[1] + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = launch_counts()
    finite = torch.isfinite(logits).all()
    reset_launch_counts()
    tok = logits.argmax(-1)[:, None]
    tokens, step_s = [tok.cpu()], []
    for i in range(steps):
        t1 = time.perf_counter()
        x = tok if feeds is None else feeds[i]
        logits, cache = lm.decode_step(model, cache, x, prompts.shape[1] + i, cfg)
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)[:, None]
        tokens.append(tok.cpu())  # the step's one device-to-host copy
        step_s.append(time.perf_counter() - t1)
    check(bool(finite), f"{cfg.name} logits are finite")
    return dict(
        tokens=torch.cat(tokens, dim=1), logits=logits, prefill_s=prefill_s,
        decode_s=sum(step_s), decode_step_ms_median=statistics.median(step_s) * 1e3,
        tokens_per_s=prompts.shape[0] * steps / sum(step_s),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        prefill_launches=prefill_launches, decode_launches=launch_counts(),
    )


def recurrent_deployment(dev):
    """recurrentgemma_9b at full width with random bf16 weights from seed 0 on
    ``dev``, and its prompts.  ``scripts/profile_recurrent.py`` profiles this
    same run."""
    cfg = get_config("recurrentgemma_9b")
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(RECUR["prompts"], RECUR["prompt_len"]))).to(dev)
    return cfg, model, prompts


def recurrent_full_width(dev) -> dict:
    """recurrentgemma_9b at full width and depth, twice over the same prompts."""
    t0 = time.perf_counter()
    cfg, model, prompts = recurrent_deployment(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_rec = cfg.layer_kinds.count("rec")
    runs, tokens = {}, []
    for name in ("first", "second"):
        res = recurrent_run(model, cfg, prompts, RECUR["steps"])
        check(res["prefill_launches"]["lru_scan"] == n_rec,
              f"{name}: one lru_scan launch per rec layer ({n_rec}) in the prefill")
        check(res["decode_launches"]["lru_scan"] == 0, f"{name}: decode launches no lru_scan")
        tokens.append(res.pop("tokens"))
        del res["logits"]
        # the path's counts: the prefill's and the decode's, each set to 0 before it
        res["launches"] = {k: v + res["decode_launches"][k]
                           for k, v in res["prefill_launches"].items()}
        runs[name] = res
        print(f"recurrentgemma_9b {name}: prefill {res['prefill_s']:.3f} s, decode step "
              f"{res['decode_step_ms_median']:.3f} ms (median), {res['tokens_per_s']:.1f} tok/s, "
              f"decode {res['decode_s']:.3f} s, peak {res['peak_gib']:.2f} GiB, launches "
              f"{res['launches']}")
        torch.cuda.empty_cache()
    check(torch.equal(tokens[0], tokens[1]), "a second identical run decodes the same tokens")
    del model
    torch.cuda.empty_cache()
    return dict(config="recurrentgemma_9b", layers=cfg.n_layers, rec_layers=n_rec,
                dtype="bfloat16", params=cfg.param_count(), init_s=init_s, **RECUR, runs=runs)


def caches_agree(g, c) -> None:
    """Card and CPU (logits, per-layer cache) within 1e-5."""
    (glog, gcache), (clog, ccache) = g, c
    torch.testing.assert_close(glog.cpu(), clog, rtol=1e-5, atol=1e-5)
    for gl, cl in zip(gcache, ccache):
        check(set(gl) == set(cl), "card and CPU caches hold the same entries")
        for k in gl:
            torch.testing.assert_close(gl[k].cpu(), cl[k], rtol=1e-5, atol=1e-5)


def recurrent_card_matches_cpu(dev) -> None:
    """Reduced recurrentgemma, f32 with TF32 off, on the card and on the CPU,
    in lockstep: prefill, then 4 decode steps, compared after each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduce(get_config("recurrentgemma_9b")), lru_width=128)
    cpu_model = lm.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 16)))
    before = lru_scan.lru_scan.launches
    g = lm.prefill(gpu_model, prompt.to(dev), cfg, 20)
    check(lru_scan.lru_scan.launches - before == cfg.layer_kinds.count("rec"),
          "the card's prefill ran the lru_scan kernel once per rec layer")
    c = lm.prefill(cpu_model, prompt, cfg, 20)
    caches_agree(g, c)
    for pos in range(16, 20):
        tok = c[0].argmax(-1)[:, None]
        check(torch.equal(g[0].argmax(-1).cpu(), tok[:, 0]), "card and CPU pick the same tokens")
        g = lm.decode_step(gpu_model, g[1], tok.to(dev), pos, cfg)
        c = lm.decode_step(cpu_model, c[1], tok, pos, cfg)
        caches_agree(g, c)
    print("reduced recurrentgemma on the card and on the CPU agrees")


# -- phases 23 and 24: MoE stacks through PagedEngine ---------------------------


class RouteTap:
    """While active, wraps ``moe.route_slots`` to count the (token, expert)
    picks that capacity drops, keyed by the tokens a routing group holds (a
    prompt's length at prefill, the batch at decode), on the device and with
    no host sync; with ``record`` it also keeps every call's gates and slots
    on the host (a host copy: run it with capture off).  The counts add in
    place into device counters, so that a captured decode step's replays
    count too: ``tokens`` names the groups routed inside a capture, whose
    counters must exist before it."""

    def __init__(self, record: bool = False, tokens=(), device=None):
        self.record = record
        self.calls: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._dropped = {t: torch.zeros((), dtype=torch.int64, device=device) for t in tokens}
        self._route = moe.route_slots

    def __enter__(self):
        moe.route_slots = self._tap
        return self

    def __exit__(self, *exc):
        moe.route_slots = self._route

    def _tap(self, gates, mc, cap):
        out = self._route(gates, mc, cap)
        t = gates.shape[1]
        if t not in self._dropped:
            check(not torch.cuda.is_current_stream_capturing(),
                  f"RouteTap has a counter for {t}-token groups before a capture routes them")
            self._dropped[t] = torch.zeros((), dtype=torch.int64, device=gates.device)
        self._dropped[t].add_((out[0] == mc.n_experts * cap).sum())
        if self.record:
            self.calls.append((gates.cpu(), out[0].cpu()))
        return out

    def dropped(self, tokens: int) -> int:
        return int(self._dropped[tokens]) if tokens in self._dropped else 0


def paged_deployment(dev, spec):
    """An arch served through ``PagedEngine`` at its published widths with
    the depth of ``spec`` (phase 23's MoE stacks, phase 31's nemotron),
    random bf16 weights from seed 0 on ``dev``, phase 7's pool and the
    prompts.  ``scripts/profile_serving.py --deployment`` profiles these."""
    cfg = dataclasses.replace(get_config(spec["config"]), n_layers=spec["layers"])
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(spec["prompts"], spec["prompt_len"]))
    return cfg, model, serving_pool(), prompts


def moe_full_width(dev) -> dict:
    """Phase 23: each MoE stack served undisturbed and under live migration."""
    out = {}
    for spec in MOE_SERVE:
        t0 = time.perf_counter()
        cfg, model, pcfg, prompts = paged_deployment(dev, spec)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        full = get_config(spec["config"])
        name_of = spec["config"]
        decode_picks = spec["steps"] * spec["prompts"] * cfg.moe.top_k * cfg.n_layers
        runs, res = {}, {}
        for name in ("undisturbed", "live"):
            reset_launch_counts()
            with RouteTap(tokens=(spec["prompts"],), device=dev) as tap:
                eng, sids, handles, times = serve_run(dev, cfg, model, pcfg, prompts,
                                                      spec["steps"], live=name == "live")
            launches = launch_counts()
            runs[name] = ([eng.seqs[s].tokens for s in sids], eng.last_logits.clone())
            res[name] = dict(times, launches=launches,
                             dropped_picks_prefill=tap.dropped(spec["prompt_len"]),
                             dropped_picks_decode=tap.dropped(spec["prompts"]),
                             decode_picks=decode_picks)
            if name == "live":
                res[name].update(check_serving(eng, sids, handles))
                check(res[name]["dirty_rejections"] > 0, "decode appends dirtied in-flight pages")
                check(launches["copy_blocks"] > 0 and launches["heat_scan"] > 0,
                      f"{name_of} live run launched copy_blocks and heat_scan")
            check(launches["paged_decode"] == spec["steps"] * cfg.n_layers,
                  f"{name_of} {name}: one paged-decode launch per layer and step")
            check(times["replays"] == spec["steps"] and times["captures"] == 1,
                  f"{name_of} {name}: every decode step was one replay of one captured graph")
            check(bool(torch.isfinite(eng.last_logits).all()), f"{name_of} logits are finite")
            print(f"{name_of} ({cfg.n_layers} of {full.n_layers} layers) {name}: prefill "
                  f"{times['prefill_s']:.3f} s, decode step "
                  f"{times['decode_step_ms_median']:.3f} ms (median), "
                  f"{times['tokens_per_s']:.1f} tok/s, decode {times['decode_s']:.3f} s, "
                  f"ticks {times['tick_s']:.3f} s, peak {times['peak_gib']:.2f} GiB, dropped "
                  f"picks {res[name]['dropped_picks_decode']} of {decode_picks} at decode and "
                  f"{res[name]['dropped_picks_prefill']} at prefill, launches {launches}")
            del eng
            torch.cuda.empty_cache()
        check(runs["live"][0] == runs["undisturbed"][0],
              f"{name_of}: tokens are identical with and without live migration")
        check(torch.equal(runs["live"][1], runs["undisturbed"][1]),
              f"{name_of}: the last step's logits are bit-identical with and without live "
              f"migration")
        check(res["live"]["dropped_picks_decode"] == res["undisturbed"]["dropped_picks_decode"],
              f"{name_of}: both runs drop the same picks")
        check(res["live"]["peak_gib"] * 2**30 < MOE_PEAK_BYTES, f"{name_of}: peak under 60 GB")
        del model
        release()
        out[name_of] = dict(
            config=name_of, layers=cfg.n_layers,
            reduced=f"layers {cfg.n_layers} of {full.n_layers}",
            dtype="bfloat16", params=cfg.param_count(), active_params=cfg.active_param_count(),
            decode_capacity=moe.capacity(cfg.moe, spec["prompts"]),
            prefill_capacity=moe.capacity(cfg.moe, spec["prompt_len"]), init_s=init_s,
            **{k: v for k, v in spec.items() if k not in ("config", "layers")}, runs=res)
    return out


def route_gap(gates: torch.Tensor, k: int) -> float:
    """The smallest gap between a token's adjacent gates among its top k + 1:
    how near a tie came to reordering its picks."""
    top = torch.sort(gates, dim=-1, descending=True).values[..., : k + 1]
    return float((top[..., :-1] - top[..., 1:]).min())


def moe_card_matches_cpu(dev) -> dict:
    """Phase 24: the reduced qwen3_moe (f32, TF32 off) served on the card and
    on the CPU under a live rebalance with blocking harvest, at the smoke
    capacity factor and at the published one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = reduce(get_config("qwen3_moe_235b_a22b"))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, base.vocab_size, size=n) for n in (5, 9, 12, 16)]
    pcfg = PagedConfig(block_tokens=4, max_blocks_per_seq=16, n_regions=2, slots_per_region=64,
                       leap=LeapConfig(initial_area_blocks=2, chunk_blocks=1,
                                       budget_blocks_per_tick=1, max_attempts_before_force=3,
                                       tiering=True))
    out = {}
    for factor in (base.moe.capacity_factor, get_config("qwen3_moe_235b_a22b").moe.capacity_factor):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, capacity_factor=factor))
        cpu_model = lm.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
        models = {"cuda": copy.deepcopy(cpu_model).to(dev), "cpu": cpu_model}
        res = {}
        for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            reset_launch_counts()
            # the tap copies every call's slots to the host: no capture
            with RouteTap(record=True) as tap, graphs.disable_capture():
                eng, sids, _, _ = serve_run(d, cfg, models[name], pcfg, prompts, 10, live=True,
                                            blocking=True)
            res[name] = (eng, [eng.seqs[s].tokens for s in sids], tap, launch_counts())
        (gpu, gtok, gtap, launches), (cpu, ctok, ctap, _) = res["cuda"], res["cpu"]
        check(len(gtap.calls) == len(ctap.calls), "card and CPU route as often")
        for i, ((gg, gs), (cg, cs)) in enumerate(zip(gtap.calls, ctap.calls)):
            if not torch.equal(gs, cs):
                t = int((gs != cs).any(-1).nonzero()[0, 0])
                k = cfg.moe.top_k
                print(f"routing call {i} differs at token {t}: gate gap "
                      f"{route_gap(gg[0, t], k):.3g} on the card, {route_gap(cg[0, t], k):.3g} "
                      f"on the CPU")
            check(torch.equal(gs, cs), f"card and CPU route call {i} alike (capacity factor "
                                       f"{factor})")
        check(gtok == ctok, "card and CPU decode the same tokens")
        check(np.array_equal(gpu.driver.host_table(), cpu.driver.host_table()), "host tables agree")
        g_state, c_state = gpu.driver.state.to_numpy(), cpu.driver.state.to_numpy()
        np.testing.assert_allclose(g_state[0], c_state[0], rtol=1e-5, atol=1e-5)
        for a, b in zip(g_state[1:], c_state[1:]):
            check(np.array_equal(a, b), "card and CPU tables and dirty/in-flight bits agree")
        torch.testing.assert_close(gpu.last_logits.cpu(), cpu.last_logits, rtol=1e-5, atol=1e-5)
        check(gpu.driver.stats == cpu.driver.stats, "card and CPU MigrationStats agree")
        drops = gtap.dropped(len(prompts))
        check((drops > 0) == (factor < base.moe.capacity_factor),
              f"decode drops picks exactly at the published factor ({drops} at {factor})")
        check(launches["paged_decode"] == 10 * cfg.n_layers, "the card's run launched K4")
        gaps = [route_gap(g, cfg.moe.top_k) for g, _ in gtap.calls]
        out[f"capacity_factor_{factor}"] = dict(
            route_calls=len(gtap.calls), dropped_picks_decode=drops,
            dropped_picks_prefill=sum(gtap.dropped(len(p)) for p in prompts),
            smallest_gate_gap=min(gaps),
            pool_bit_identical=bool(np.array_equal(g_state[0], c_state[0])),
            pool_max_abs_diff=float(np.abs(g_state[0] - c_state[0]).max()),
            logits_max_abs_diff=float((gpu.last_logits.cpu() - cpu.last_logits).abs().max()),
            launches=launches)
        print(f"reduced qwen3_moe at capacity factor {factor} on the card and on the CPU agrees: "
              f"{len(gtap.calls)} routing calls equal, {drops} picks dropped at decode, smallest "
              f"gate gap {min(gaps):.3g}, pools bit-identical "
              f"{out[f'capacity_factor_{factor}']['pool_bit_identical']}")
        del gpu, cpu, res, models
    return out


# -- phase 25: xlstm_125m through lm.prefill and lm.decode_step -------------------


class SlstmTimer:
    """While active, times every sLSTM prefill (its per-token loop) with a
    synchronise on each side; the arithmetic is untouched."""

    def __init__(self):
        self.prefill_s = 0.0
        self._block = xlstm.slstm_block

    def __enter__(self):
        xlstm.slstm_block = self._timed
        return self

    def __exit__(self, *exc):
        xlstm.slstm_block = self._block

    def _timed(self, x, params, cfg, cache=None, *, mode):
        if mode != "prefill":
            return self._block(x, params, cfg, cache, mode=mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self._block(x, params, cfg, cache, mode=mode)
        torch.cuda.synchronize()
        self.prefill_s += time.perf_counter() - t0
        return out


def xlstm_deployment(dev):
    """xlstm_125m in full with random bf16 weights from seed 0 on ``dev``, and
    its prompts.  ``scripts/profile_recurrent.py`` profiles this same run."""
    cfg = get_config("xlstm_125m")
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, size=(XLSTM["prompts"], XLSTM["prompt_len"]))).to(dev)
    return cfg, model, prompts


def xlstm_full_width(dev) -> dict:
    """xlstm_125m in full, twice over the same prompts."""
    t0 = time.perf_counter()
    cfg, model, prompts = xlstm_deployment(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    runs, tokens = {}, []
    for name in ("first", "second"):
        with SlstmTimer() as timer:
            res = recurrent_run(model, cfg, prompts, XLSTM["steps"])
        res["slstm_prefill_s"] = timer.prefill_s
        tokens.append(res.pop("tokens"))
        del res["logits"]
        res["launches"] = {k: v + res["decode_launches"][k]
                           for k, v in res["prefill_launches"].items()}
        check(not any(res["launches"].values()), "the xLSTM path runs none of the port's kernels")
        runs[name] = res
        print(f"xlstm_125m {name}: prefill {res['prefill_s']:.3f} s (sLSTM layers "
              f"{timer.prefill_s:.3f} s), decode step {res['decode_step_ms_median']:.3f} ms "
              f"(median), {res['tokens_per_s']:.1f} tok/s, decode {res['decode_s']:.3f} s, peak "
              f"{res['peak_gib']:.2f} GiB")
        torch.cuda.empty_cache()
    check(torch.equal(tokens[0], tokens[1]), "a second identical xLSTM run decodes the same tokens")
    del model
    torch.cuda.empty_cache()
    return dict(config="xlstm_125m", layers=cfg.n_layers, kinds=list(cfg.layer_kinds),
                dtype="bfloat16", params=cfg.param_count(), init_s=init_s, **XLSTM, runs=runs)


def xlstm_card_matches_cpu(dev) -> dict:
    """The reduced xlstm_125m (f32, TF32 off) on the card and on the CPU in
    lockstep: a chunked (192-token) and a sequential (64-token) prefill, each
    followed by 4 decode steps, compared after every call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduce(get_config("xlstm_125m"))
    cpu_model = lm.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for s in XLSTM_REDUCED_LENS:
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, s)))
        g = lm.prefill(gpu_model, prompt.to(dev), cfg, s + 4)
        c = lm.prefill(cpu_model, prompt, cfg, s + 4)
        for pos in range(s, s + 5):
            caches_agree(g, c)
            worst = max(worst, float((g[0].cpu() - c[0]).abs().max()))
            if pos == s + 4:
                break
            tok = c[0].argmax(-1)[:, None]
            check(torch.equal(g[0].argmax(-1).cpu(), tok[:, 0]),
                  "card and CPU pick the same tokens")
            g = lm.decode_step(gpu_model, g[1], tok.to(dev), pos, cfg)
            c = lm.decode_step(cpu_model, c[1], tok, pos, cfg)
    print(f"reduced xlstm_125m on the card and on the CPU agrees (prefills of "
          f"{list(XLSTM_REDUCED_LENS)}, logits within {worst:.3g})")
    return dict(prefill_lens=list(XLSTM_REDUCED_LENS), decode_steps=4, logits_max_abs_diff=worst)


# -- phase 26: K5's backward against its plain version ---------------------------


def lru_fd_rel_err(dev) -> float:
    """The LRU-scan Function's gradient (both kernels) at a tiny f32 shape
    against float64 central differences of the same loss along a random
    direction; returns the relative error."""
    a, x, h0 = lru_inputs(dev, 2, 33, 40, SEED + 7)
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    w = torch.randn(a.shape, generator=g, device=dev)
    dirs = [torch.randn(v.shape, generator=g, device=dev, dtype=torch.float64)
            for v in (a, x, h0)]
    leaves = [v.clone().requires_grad_() for v in (a, x, h0)]
    grads = torch.autograd.grad((ops.lru_scan(*leaves) * w).sum(), leaves)
    analytic = sum(float((gr.double() * d).sum()) for gr, d in zip(grads, dirs))

    def loss64(a, x, h0):
        h, total = h0, 0.0
        for t in range(a.shape[1]):
            h = a[:, t] * h + x[:, t]
            total = total + (h * w[:, t].double()).sum()
        return float(total)

    eps = 1e-3
    base = [v.double() for v in (a, x, h0)]
    fd = (loss64(*(v + eps * d for v, d in zip(base, dirs)))
          - loss64(*(v - eps * d for v, d in zip(base, dirs)))) / (2 * eps)
    return abs(fd - analytic) / abs(fd)


def lru_scan_bwd_checks(dev) -> dict:
    """The backward kernel at the timed forward shape and at phase 28's
    training shape, bit for bit against its plain version, timed against its
    byte bound; and the Function's gradient against finite differences."""
    r = get_config("recurrentgemma_9b").rnn_width
    shapes = {"timed": (RECUR["prompts"], RECUR["prompt_len"], r),
              "training": (TRAIN_RECUR["batch"], TRAIN_RECUR["seq"], r)}
    out = {}
    for name, (b, t, rr) in shapes.items():
        a, x, h0 = lru_inputs(dev, b, t, rr, SEED + b)
        gy = torch.randn(a.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
        h = lru_scan.lru_scan(a, x, h0)
        got = lru_scan.lru_scan_bwd(gy, a, h, h0)
        again = lru_scan.lru_scan_bwd(gy, a, h, h0)
        want = ref.lru_scan_bwd_ref(gy, a, h, h0)
        torch.cuda.synchronize()
        for what, k, z, p in zip(("da", "db", "dh0"), got, again, want):
            check(torch.equal(k, p), f"lru_scan_bwd {what} at {name} == plain version, bit for bit")
            check(torch.equal(k, z), f"lru_scan_bwd {what} is bit-identical run to run")
        n = a.numel()
        # g, a and h read once, da and db written once; h0 read, dh0 written
        bound, by = bound_ms(5 * n * 4 + 2 * b * rr * 4, 3.0 * n)
        out[name] = dict(
            shape=f"g, a, h, da, db [{b}, {t}, {rr}] f32, h0, dh0 [{b}, {rr}] f32",
            max_abs_err=max(float((k - p).abs().max()) for k, p in zip(got, want)),
            ms=time_ms(lambda: lru_scan.lru_scan_bwd(gy, a, h, h0)),
            plain_ms=time_ms(lambda: ref.lru_scan_bwd_ref(gy, a, h, h0), iters=2, repeats=3),
            bound_ms=bound, bound_by=by,
        )
        del a, x, h0, gy, h, got, again, want
        torch.cuda.empty_cache()
    fd_err = lru_fd_rel_err(dev)
    check(fd_err < LRU_FD_TOL, f"LRU-scan gradient within {LRU_FD_TOL} of finite differences "
          f"(got {fd_err:.3g})")
    main = out["timed"]
    row = dict(
        name="lru_scan_bwd", route="cuda", source="src/repro_torch/kernels/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan.py:56", launches=0,
        max_abs_err=main["max_abs_err"], ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=None,
        library="none (no single PyTorch call computes a linear recurrence's adjoint)",
        note="K5's backward: the TPU side differentiates lru_scan_pallas's oracle by autodiff",
        shape=main["shape"], training_shape=out["training"], finite_difference_rel_err=fd_err,
    )
    print(f"lru_scan_bwd: {main['ms']:.4f} ms (plain {main['plain_ms']:.4f}, bound "
          f"{main['bound_ms']:.4f}), bit-exact; at the training shape "
          f"{out['training']['ms']:.4f} ms (bound {out['training']['bound_ms']:.4f}); "
          f"gradient against finite differences {fd_err:.3g}")
    return row


# -- phases 27 to 29: training -------------------------------------------------------


def profile_step(tr: Trainer) -> dict:
    """One more training step under ``torch.profiler``: kernels launched,
    their device time and the busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(until=tr.step + 1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    return dict(wall_ms=wall_s * 1e3, device_ms=device_ms, busy_share=device_ms / (wall_s * 1e3),
                kernels=sum(e.count for e in kernels),
                top=[dict(name=e.key[:80], launches=e.count, device_ms=dev_us(e) / 1e3)
                     for e in top])


def train_run(dev, cfg, spec: dict, data_seed: int = SEED) -> tuple[Trainer, dict]:
    """``spec["steps"]`` steps of ``Trainer`` on ``SyntheticLM`` at full width
    on the card, logging (one host sync) every step; no checkpoint."""
    data = SyntheticLM(DataConfig(cfg.vocab_size, spec["seq"], spec["batch"], seed=data_seed))
    tcfg = TrainConfig(n_micro=spec["n_micro"], accum_dtype=cfg.grad_accum_dtype,
                       optimizer=OptimizerConfig(peak_lr=spec["lr"], warmup_steps=spec["warmup"],
                                                 total_steps=spec["steps"],
                                                 state_dtype=cfg.opt_state_dtype))
    with tempfile.TemporaryDirectory() as d:  # empty: restore_or_init initialises
        tr = Trainer(cfg, tcfg, TrainerConfig(total_steps=spec["steps"], ckpt_every=10**9,
                                              ckpt_dir=d, log_every=1),
                     data, seed=SEED, device=dev)
        t0 = time.perf_counter()
        tr.restore_or_init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    stamps = [time.perf_counter()]
    tr.run(on_step=lambda s, m: stamps.append(time.perf_counter()))
    launches = launch_counts()
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    losses = [m["loss"] for m in tr.history]
    check(len(losses) == spec["steps"] and all(np.isfinite(losses)),
          f"{cfg.name}: {spec['steps']} finite losses")
    tokens = spec["batch"] * spec["seq"]
    res = dict(
        config=cfg.name, layers=cfg.n_layers, params=cfg.param_count(), dtype=cfg.param_dtype,
        **spec, init_s=init_s, losses=losses, grad_norms=[m["grad_norm"] for m in tr.history],
        step_ms=[x * 1e3 for x in step_s], step_ms_median=statistics.median(step_s) * 1e3,
        first_step_ms=step_s[0] * 1e3,
        tokens_per_s=tokens / statistics.median(step_s),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
    )
    print(f"{cfg.name} training ({cfg.n_layers} layers, {res['params']:,} params): losses "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"  step {res['step_ms_median']:.1f} ms (median; first {res['first_step_ms']:.1f}), "
          f"{res['tokens_per_s']:.0f} tokens/s, peak {res['peak_gib']:.2f} GiB, init "
          f"{init_s:.1f} s, launches {launches}")
    return tr, res


def granite_training(dev) -> dict:
    """Phase 27: granite_3_2b at full width and all 40 layers, 20 steps."""
    cfg = get_config("granite_3_2b")
    tr, res = train_run(dev, cfg, TRAIN_GRANITE)
    check(res["losses"][-1] < res["losses"][0], "granite_3_2b's loss falls over 20 steps")
    active = cfg.active_param_count()
    res["model_flops"] = mf = roofline.model_flops(
        active, TRAIN_GRANITE["batch"] * TRAIN_GRANITE["seq"], "train")
    res["mfu"] = mf / (res["step_ms_median"] / 1e3 * roofline.PEAK_FLOPS)
    print(f"  model FLOPs a step {mf:.4g} (6 N D, N = {active:,} active parameters) against "
          f"PEAK_FLOPS {roofline.PEAK_FLOPS:.4g} (H100 SXM, dense bf16, 700 W): MFU "
          f"{res['mfu']:.4f} at {res['step_ms_median']:.1f} ms a step [{card()}]")
    res["profiled_step"] = prof = profile_step(tr)
    print(f"  one more step profiled: {prof['kernels']} kernels, {prof['device_ms']:.1f} ms of "
          f"device time in {prof['wall_ms']:.1f} ms (busy {prof['busy_share']:.3f}); top: "
          + "; ".join(f"{k['name'][:40]} {k['device_ms']:.1f} ms" for k in prof["top"][:4]))
    del tr
    release()
    return res


def recurrent_training(dev) -> dict:
    """Phase 28: recurrentgemma_9b at full width, one period plus the tail
    (4 rec, 1 win): K5 forward and backward launches as the block recompute
    implies, and nonzero, finite gradients on the RG-LRU gates."""
    cfg = dataclasses.replace(get_config("recurrentgemma_9b"), n_layers=TRAIN_RECUR_LAYERS)
    tr, res = train_run(dev, cfg, TRAIN_RECUR)
    n_rec = cfg.layer_kinds.count("rec")
    micro = TRAIN_RECUR["steps"] * TRAIN_RECUR["n_micro"]
    # each rec layer runs forward, again in the backward's recompute, then back
    check(res["launches"]["lru_scan"] == 2 * n_rec * micro,
          f"lru_scan launched twice per rec layer and microbatch ({2 * n_rec * micro})")
    check(res["launches"]["lru_scan_bwd"] == n_rec * micro,
          f"lru_scan_bwd launched once per rec layer and microbatch ({n_rec * micro})")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in tr.data.batch(tr.step).items()}
    grads, _ = grad_accum(tr.state.params, batch, cfg, tr.tcfg)
    gate_norms = {}
    for i, kind in enumerate(cfg.layer_kinds):
        if kind != "rec":
            continue
        for name in ("wr", "wi", "lam"):
            g = grads[f"blocks.{i}.rec.{name}"].float()
            check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
                  f"layer {i} {name} gets a nonzero, finite gradient")
            gate_norms[f"{i}.{name}"] = float(g.norm())
    res["gate_grad_norms"] = gate_norms
    res["rec_layers"] = n_rec
    print("  rec gate gradient norms: " + ", ".join(f"{k} {v:.3g}" for k, v in gate_norms.items()))
    del grads
    res["profiled_step"] = prof = profile_step(tr)
    print(f"  one more step profiled: {prof['kernels']} kernels, {prof['device_ms']:.1f} ms of "
          f"device time in {prof['wall_ms']:.1f} ms (busy {prof['busy_share']:.3f})")
    del tr
    release()
    return res


def _to_card(state: TrainState, dev) -> TrainState:
    """A copy of a CPU train state on ``dev``."""
    state = copy.deepcopy(state)
    state.params.to(dev)
    state.opt = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
                 for k, v in state.opt.items()}
    return state


def _reduced_tcfg(cfg=None) -> TrainConfig:
    """Phase 29's train config; with ``cfg``, its accumulator and moment
    dtypes (nemotron: bf16)."""
    spec = TRAIN_REDUCED
    accum, state = (cfg.grad_accum_dtype, cfg.opt_state_dtype) if cfg else ("float32", "float32")
    return TrainConfig(n_micro=spec["n_micro"], accum_dtype=accum, optimizer=OptimizerConfig(
        peak_lr=spec["lr"], warmup_steps=spec["warmup"], total_steps=spec["steps"],
        state_dtype=state))


def restart_on_the_card(dev) -> dict:
    """The reduced granite on the card: checkpoint at step 1, a failure at
    step 2, a restart from the checkpoint; then the card's checkpoint
    restored on the CPU and back."""
    cfg, tcfg = reduce(get_config("granite_3_2b")), _reduced_tcfg()
    data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_REDUCED["seq"], TRAIN_REDUCED["batch"],
                                  seed=SEED))
    with tempfile.TemporaryDirectory() as d:
        mk = lambda sub, asynchronous=True: Trainer(  # noqa: E731
            cfg, tcfg, TrainerConfig(total_steps=2, ckpt_every=1, ckpt_dir=f"{d}/{sub}",
                                     log_every=1, async_ckpt=asynchronous),
            data, seed=SEED, device=dev)
        a = mk("a")
        a.run()
        # synchronous, so that step 1's checkpoint is committed before the
        # failure at step 2; an asynchronous save still being written when
        # the failure is raised leaves no restore point, and a restart then
        # begins at step 0
        b = mk("b", asynchronous=False)
        try:
            b.run(fail_at=2)
        except RuntimeError as e:
            check("simulated node failure" in str(e), "the failure is the simulated one")
        else:
            check(False, "run(fail_at=2) raises")
        c = mk("b")
        check(c.restore_or_init() == 1, "the restart resumes from step 1")
        c.run()
        want, got = a.history[-1]["loss"], c.history[-1]["loss"]
        torch.testing.assert_close(torch.tensor(got), torch.tensor(want), rtol=1e-5, atol=1e-5)
        ckpt.save(f"{d}/card", 2, a.state).wait()
        model = lm.CausalLM(cfg, device="meta")
        template = TrainState(params=model, opt=init_opt_state(model, tcfg.optimizer))
        on_cpu, _ = ckpt.restore(f"{d}/card", template, device="cpu")
        model = lm.CausalLM(cfg, device="meta")
        template = TrainState(params=model, opt=init_opt_state(model, tcfg.optimizer))
        back, _ = ckpt.restore(f"{d}/card", template, device=dev)
    for (name, x), (_, y), (_, z) in zip(ckpt._flatten(a.state), ckpt._flatten(on_cpu),
                                         ckpt._flatten(back)):
        check(y.device.type == "cpu" and torch.equal(x.cpu(), y), f"{name} restores on the CPU "
              "bit for bit")
        check(z.device == x.device and torch.equal(x, z), f"{name} restores on the card bit for bit")
    res = dict(loss_uninterrupted=want, loss_restarted=got, bit_identical=got == want)
    print(f"reduced granite restart on the card: step-2 loss {got!r} against {want!r} "
          f"({'bit-identical' if got == want else 'not bit-identical'}); the card's "
          f"checkpoint restores on the CPU and on the card bit for bit")
    return res


def training_card_matches_cpu(dev) -> dict:
    """Phase 29: the reduced config of every ported arch (f32, TF32 off) takes
    2 train steps on the card and on the CPU from one state; losses within
    TRAIN_LOSS_TOL.  Then the restart and the checkpoint on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_launch_counts()
    out = {}
    for arch in PORTED_ARCH_IDS:
        cfg = reduce(get_config(arch))
        tcfg = _reduced_tcfg(cfg)
        cpu = init_train_state(torch.Generator().manual_seed(SEED), cfg, tcfg, "cpu")
        gpu = _to_card(cpu, dev)
        data = SyntheticLM(DataConfig(cfg.vocab_size, TRAIN_REDUCED["seq"],
                                      TRAIN_REDUCED["batch"], seed=SEED,
                                      embed_dim=None if cfg.embed_inputs else cfg.d_model))
        diffs = []
        for step in range(TRAIN_REDUCED["steps"]):
            batch = data.batch(step)
            _, mc = train_step(cpu, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, tcfg)
            _, mg = train_step(gpu, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                               cfg, tcfg)
            torch.testing.assert_close(mg["loss"].cpu(), mc["loss"], **TRAIN_LOSS_TOL[step])
            diffs.append(abs(float(mg["loss"]) - float(mc["loss"])))
        out[arch] = dict(loss_abs_diff=diffs, loss=float(mc["loss"]),
                         accum_dtype=tcfg.accum_dtype, state_dtype=tcfg.optimizer.state_dtype)
    res = dict(archs=out, launches=launch_counts())
    n_rec = reduce(get_config("recurrentgemma_9b")).layer_kinds.count("rec")
    micro = TRAIN_REDUCED["steps"] * TRAIN_REDUCED["n_micro"]
    check(res["launches"]["lru_scan_bwd"] == n_rec * micro,
          "the reduced recurrentgemma's card steps launched lru_scan_bwd once per rec layer "
          "and microbatch")
    print("reduced archs train on the card like the CPU: " + ", ".join(
        f"{a} {max(v['loss_abs_diff']):.2g}" for a, v in out.items()))
    res["restart"] = restart_on_the_card(dev)
    res["serving"] = {"nemotron_4_340b": serving_card_matches_cpu(dev, "nemotron_4_340b")}
    for arch in ("gemma2_27b", "llava_next_34b", "musicgen_large"):
        res["serving"][arch] = contiguous_card_matches_cpu(dev, arch)
    return res


def contiguous_card_matches_cpu(dev, arch: str) -> dict:
    """A reduced arch (f32, TF32 off) through ``lm.prefill`` and 4
    ``lm.decode_step`` s on the card and on the CPU in lockstep: logits and
    every layer's cache within 1e-5 after each call.  gemma2's window (8 in
    the reduced config) rolls over a 16-token prompt; the stub frontends
    take seeded embeddings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduce(get_config(arch))
    cpu_model = lm.init_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    rng = np.random.default_rng(SEED)

    def inputs(s):
        if cfg.embed_inputs:
            return torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, s)))
        return torch.from_numpy(rng.normal(size=(2, s, cfg.d_model)).astype(np.float32))

    prompt = inputs(16)
    g = lm.prefill(gpu_model, prompt.to(dev), cfg, 20)
    c = lm.prefill(cpu_model, prompt, cfg, 20)
    caches_agree(g, c)
    worst = float((g[0].cpu() - c[0]).abs().max())
    for pos in range(16, 20):
        check(torch.equal(g[0].argmax(-1).cpu(), c[0].argmax(-1)), "card and CPU pick the same "
              "tokens")
        x = c[0].argmax(-1)[:, None] if cfg.embed_inputs else inputs(1)
        g = lm.decode_step(gpu_model, g[1], x.to(dev), pos, cfg)
        c = lm.decode_step(cpu_model, c[1], x, pos, cfg)
        caches_agree(g, c)
        worst = max(worst, float((g[0].cpu() - c[0]).abs().max()))
    print(f"reduced {arch} through lm.prefill and lm.decode_step on the card and on the CPU "
          f"agrees (logits within {worst:.3g})")
    return dict(path="lm.prefill/decode_step", logits_max_abs_diff=worst)


# -- phase 30: K4's hd-192 instance against its plain version ------------------------


def paged_hd192_checks(dev) -> dict:
    """The hd-192 instance in bf16 and f32, at G 12 (nemotron; the GM 16
    instance) and G 1 (GM 4), at mixed lens and at lens on the split
    boundaries: against the plain version and bit-identical run to run.
    Then timed at nemotron's decode shape beside a page gather plus SDPA."""
    base = PAGED_NEMO
    host = torch.Generator().manual_seed(SEED)
    full, split = base["maxb"] * base["blk"], paged_attn.SPLIT_TOKENS
    mixed = torch.randint(2, full, (base["b"],), generator=host)
    mixed[0], mixed[-1] = 1, full
    bounds = torch.tensor([1, split - 1, split, split + 1, 2 * split, 3 * split + 1, 9 * split,
                           full])
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for g in (12, 1):
            p = dict(base, h=base["kvh"] * g, layers=2, layer=1)
            for lname, lh in (("mixed", mixed), ("split boundaries", bounds)):
                q, view, tables, ld = paged_inputs(dev, dtype, lh, SEED + g, p)
                got = ops.paged_decode_partial(q, view, tables, ld, kv_heads=p["kvh"])
                again = ops.paged_decode_partial(q, view, tables, ld, kv_heads=p["kvh"])
                want = ops.paged_decode_partial(q, view, tables, ld, kv_heads=p["kvh"],
                                                impl="ref")
                torch.cuda.synchronize()
                for a, b, w in zip(got, again, want):
                    check(torch.equal(a, b), f"hd 192 {dtype} G {g} {lname}: bit-identical run "
                                             "to run")
                    torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[dtype])
                errs[f"{str(dtype).removeprefix('torch.')} G{g} {lname}"] = max(
                    float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
                del q, view, tables, got, again, want
    torch.cuda.empty_cache()
    p = PAGED_NEMO
    lens = torch.full((p["b"],), NEMO_SERVE["prompt_len"] + NEMO_SERVE["steps"])
    q, view, tables, lens_d = paged_inputs(dev, torch.bfloat16, lens, SEED, p)
    timed = paged_timings(q, view, tables, lens_d, lens, p)
    del q, view, tables
    torch.cuda.empty_cache()
    row = dict(
        name="paged_decode_hd192", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attn.cu",
        replaces="src/repro/kernels/paged_attn.py:101", launches=0,
        max_abs_err=errs["bfloat16 G12 mixed"], **timed,
        shape=(f"q [{p['b']}, {p['h']}, {p['hd']}] bf16 (G 12, KVH {p['kvh']}), layer "
               f"{p['layer']} of a [{p['slots']}, {p['layers']}, 2, {p['blk']}, {p['kvh']}, "
               f"{p['hd']}] pool, lens {int(lens[0])} each"),
        errors=errs, check_lens=dict(mixed=mixed.tolist(), split_boundaries=bounds.tolist()))
    print(f"paged_decode hd 192 at nemotron's decode shape: {row['ms']:.4f} ms (plain "
          f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f}, "
          f"{paged_grid(lens, p)}) [{card()}]; max err " + ", ".join(
              f"{k} {v:.3g}" for k, v in errs.items()))
    return row


# -- phases 31-33: nemotron, gemma2, llava and musicgen at full width ----------------


def fits(peak_bytes: int, what: str) -> None:
    total = torch.cuda.get_device_properties(0).total_memory
    check(total - peak_bytes >= HEADROOM_BYTES,
          f"{what}: peak {peak_bytes / 2**30:.2f} GiB leaves {HEADROOM_BYTES / 2**30:.0f} GiB of "
          f"the card's {total / 2**30:.2f} GiB")


def nemotron_full_width(dev) -> dict:
    """Phase 31: nemotron_4_340b at full width (7 of 96 layers) through
    ``PagedEngine``, twice undisturbed and once while two sequences leap."""
    spec = NEMO_SERVE
    full = get_config(spec["config"])
    t0 = time.perf_counter()
    cfg, model, pcfg, prompts = paged_deployment(dev, spec)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2**30
    n = spec["steps"] * cfg.n_layers
    runs, res = {}, {}
    for name in ("undisturbed", "again", "live"):
        reset_launch_counts()
        eng, sids, handles, times = serve_run(dev, cfg, model, pcfg, prompts, spec["steps"],
                                              live=name == "live")
        launches = launch_counts()
        runs[name] = ([eng.seqs[s].tokens for s in sids], eng.last_logits.clone())
        res[name] = dict(times, launches=launches)
        if name == "live":
            res[name].update(check_serving(eng, sids, handles))
            check(res[name]["dirty_rejections"] > 0, "decode appends dirtied in-flight pages")
            check(launches["copy_blocks"] > 0, "the live run launched copy_blocks")
        check(launches["paged_decode"] == launches["paged_decode_hd192"] == n,
              f"nemotron {name}: one hd-192 paged-decode launch per layer and step ({n})")
        check(times["replays"] == spec["steps"] and times["captures"] == 1,
              f"nemotron {name}: every decode step was one replay of one captured graph")
        check(bool(torch.isfinite(eng.last_logits).all()), "nemotron's logits are finite")
        fits(torch.cuda.max_memory_allocated(), f"nemotron {name}")
        print(f"nemotron_4_340b ({cfg.n_layers} of {full.n_layers} layers) {name}: prefill "
              f"{times['prefill_s']:.3f} s, decode step {times['decode_step_ms_median']:.3f} ms "
              f"(median), {times['tokens_per_s']:.1f} tok/s, peak {times['peak_gib']:.2f} GiB, "
              f"launches {launches} [{card()}]")
        del eng
        torch.cuda.empty_cache()
    for name in ("again", "live"):
        check(runs[name][0] == runs["undisturbed"][0], f"nemotron {name}: the same tokens")
        check(torch.equal(runs[name][1], runs["undisturbed"][1]),
              f"nemotron {name}: the last step's logits are bit-identical")
    del model, runs
    release()
    return dict(config=spec["config"], layers=cfg.n_layers,
                reduced=f"layers {cfg.n_layers} of {full.n_layers}", dtype="bfloat16",
                params=cfg.param_count(), weights_gib=weights_gib, init_s=init_s,
                **{k: v for k, v in spec.items() if k not in ("config", "layers")}, runs=res)


def contiguous_deployment(dev, spec):
    """An arch at its published widths with the depth of ``spec`` (phases 32
    and 33), random bf16 weights from seed 0 on ``dev``, and its inputs:
    token prompts, or for a stub frontend seeded bf16 embeddings [B, S, D]
    and one more [B, 1, D] a decode step (``feeds``, else None).
    ``scripts/profile_recurrent.py --deployment`` profiles these."""
    cfg = dataclasses.replace(get_config(spec["config"]), n_layers=spec["layers"])
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
    b, s, steps = spec["prompts"], spec["prompt_len"], spec["steps"]
    if cfg.embed_inputs:
        prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, size=(b, s))).to(dev)
        return cfg, model, prompts, None
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randn((b, s, cfg.d_model), generator=gen, device=dev, dtype=torch.bfloat16)
    feeds = torch.randn((steps, b, 1, cfg.d_model), generator=gen, device=dev,
                        dtype=torch.bfloat16)
    return cfg, model, prompts, feeds


def contiguous_full_width(dev, spec) -> dict:
    """Phases 32 and 33: an arch at full width with ``spec`` 's depth through
    ``lm.prefill`` and ``lm.decode_step``, twice over the same inputs: the
    same tokens and bit-identical last logits."""
    full = get_config(spec["config"])
    t0 = time.perf_counter()
    cfg, model, prompts, feeds = contiguous_deployment(dev, spec)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2**30
    b, s, steps = spec["prompts"], spec["prompt_len"], spec["steps"]
    runs, outs = {}, []
    for name in ("first", "second"):
        res = recurrent_run(model, cfg, prompts, steps, feeds)
        outs.append((res.pop("tokens"), res.pop("logits")))
        res["launches"] = {k: v + res["decode_launches"][k]
                           for k, v in res["prefill_launches"].items()}
        check(not any(res["launches"].values()),
              f"{cfg.name}'s contiguous path runs none of the port's kernels")
        fits(torch.cuda.max_memory_allocated(), f"{cfg.name} {name}")
        runs[name] = res
        print(f"{cfg.name} ({cfg.n_layers} of {full.n_layers} layers, {b} x {s}) {name}: "
              f"prefill {res['prefill_s']:.3f} s, decode step "
              f"{res['decode_step_ms_median']:.3f} ms (median), {res['tokens_per_s']:.1f} tok/s, "
              f"peak {res['peak_gib']:.2f} GiB [{card()}]")
        torch.cuda.empty_cache()
    check(torch.equal(outs[0][0], outs[1][0]), f"{cfg.name}: the same tokens in both runs")
    check(torch.equal(outs[0][1], outs[1][1]), f"{cfg.name}: bit-identical last logits")
    del model, prompts, feeds, outs
    release()
    return dict(config=spec["config"], layers=cfg.n_layers,
                reduced=(f"layers {cfg.n_layers} of {full.n_layers}"
                         if cfg.n_layers < full.n_layers else None),
                inputs="token ids" if cfg.embed_inputs else "seeded bf16 embeddings",
                dtype="bfloat16", params=cfg.param_count(), weights_gib=weights_gib,
                init_s=init_s, **{k: v for k, v in spec.items() if k not in ("config", "layers")},
                runs=runs)


def dryrun_cells(dev) -> dict:
    """Phase 34: the five ``DRYRUN_CELLS`` through ``launch.dryrun.run_cell``
    on the card, each path's launch counts set to 0 just before it."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report

    total = torch.cuda.get_device_properties(dev).total_memory
    res, arts = {}, {}
    for arch, shape in DRYRUN_CELLS:
        release()
        reset_launch_counts()
        t0 = time.perf_counter()
        art = dryrun.run_cell(arch, shape, "h100", force=True, device=dev, seed=SEED)
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        what = f"dry-run {arch} {shape}"
        check(art["status"] == "OK", f"{what}: {art['status']} {art.get('traceback', '')}")
        full = get_config(arch)
        check(art["config"] == full.name and art["full"]["n_layers"] == full.n_layers
              and (art["reduced"] is None or art["reduced"]["layers"] == full.n_layers),
              f"{what}: full width and all {full.n_layers} layers")
        mem, m = art["memory"], art["measured"]
        want = art["accounting"]["argument_bytes"]
        check(abs(mem["argument_bytes"] - want) <= DRYRUN_ARG_TOL * want,
              f"{what}: argument bytes {mem['argument_bytes']} on the card against {want} on meta")
        check(m["peak_bytes"] < total, f"{what}: peak {m['peak_bytes']} under the card's {total}")
        check("NCCL" not in m["kernel_classes"] and art["wire_bytes_per_device"] == 0,
              f"{what}: no NCCL kernel, 0 wire bytes")
        check(m["device_ms"] <= m["window_ms"],
              f"{what}: device {m['device_ms']:.2f} ms within the profiled step's "
              f"{m['window_ms']:.2f} ms")
        check(m["device_ms"] <= (1 + DRYRUN_TRACE_TOL) * m["step_ms"],
              f"{what}: device {m['device_ms']:.2f} ms within the median unprofiled step's "
              f"{m['step_ms']:.2f} ms (+{DRYRUN_TRACE_TOL:.0%})")
        if arch == "recurrentgemma_9b" and shape == "prefill_32k":
            n_rec = full.layer_kinds.count("rec")
            k5 = m["kernel_classes"].get("K5 lru_scan", {}).get("launches", 0)
            check(k5 == n_rec, f"{what}: the trace names K5 {k5} times, once per rec layer "
                               f"({n_rec})")
            steps = 1 + dryrun.TIMED_STEPS["prefill"] + 1  # warm-up, timed, profiled
            check(launches["lru_scan"] == steps * n_rec,
                  f"{what}: lru_scan launched once per rec layer and step")
        bound_ms = art["roofline"]["step_time_s"] * 1e3
        print(f"dry-run {arch} {shape} ({art['reduced'] or 'not cut'}): step "
              f"{m['step_ms']:.2f} ms (median of {m['steps_ms']}), first step "
              f"{art['first_step_s']:.2f} s, device {m['device_ms']:.2f} ms (busy "
              f"{m['busy']:.3f} of the median step; {m['busy_profiled']:.3f} of the profiled "
              f"step's {m['window_ms']:.2f} ms), peak {m['peak_bytes'] / 2**30:.2f} "
              f"GiB, arguments {mem['argument_bytes']} B (meta {want}), bound {bound_ms:.3f} ms "
              f"({art['roofline']['dominant']}), step / bound {m['step_ms'] / bound_ms:.2f}, "
              f"{m['kernels']} device events, wall {wall_s:.1f} s [{card()}]")
        arts[(arch, shape)] = art
        res[f"{arch}__{shape}"] = dict(
            status=art["status"], reduced=art["reduced"], full=art["full"], memory=mem,
            measured={k: v for k, v in m.items() if k != "trace"}, roofline=art["roofline"],
            build_s=art["build_s"], first_step_s=art["first_step_s"], wall_s=wall_s,
            launches=launches)
    release()
    print(report.measured_table("h100", arts) + f"\n[{card()}]")
    return res


def lru_scan_dryrun_check(dev) -> dict:
    """Phase 34's K5 row: the kernel against its plain version, bit for bit
    and run to run, at the shape recurrentgemma_9b's ``prefill_32k`` cell
    gives it (batch 1, 32,768 steps, rnn_width 4,096: a serial chain of
    32,768 steps a channel), timed against its byte bound, with the plan it
    launched."""
    from repro_torch.configs.shapes import SHAPES

    b, t, r = 1, SHAPES["prefill_32k"].seq_len, get_config("recurrentgemma_9b").rnn_width
    a, x, h0 = lru_inputs(dev, b, t, r, SEED + 34)
    got = ops.lru_scan(a, x, h0)
    again = ops.lru_scan(a, x, h0)
    plan = lru_scan.lru_scan.last_plan.describe()
    want = ops.lru_scan(a, x, h0, impl="ref")
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"lru_scan at [{b}, {t}, {r}] f32 == plain version, bit for bit")
    check(torch.equal(got, again), f"lru_scan at [{b}, {t}, {r}] f32 is bit-identical run to run")
    bound, by = lru_bound(a, h0)
    row = dict(
        name="lru_scan", route="cuda", source="src/repro_torch/kernels/csrc/lru_scan.cu",
        replaces="src/repro/kernels/lru_scan.py:56", launches=0, phase=34,
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(lambda: lru_scan.lru_scan(a, x, h0), iters=5, repeats=5),
        # the plain version queues 98,304 small kernels a call: one call behind a sleep
        plain_ms=time_ms(lambda: ref.lru_scan_ref(a, x, h0), iters=1, repeats=1),
        bound_ms=bound, bound_by=by, library_ms=None,
        library="none (no single PyTorch call computes a linear recurrence)",
        shape=f"a, b, out [{b}, {t}, {r}] f32, h0 [{b}, {r}] f32 (recurrentgemma_9b prefill_32k)",
        plan=plan,
    )
    print(f"lru_scan at [{b}, {t}, {r}]: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound "
          f"{bound:.4f}, {row['ms'] / bound:.2f} times), bit-exact; plan: {plan['ctas']} CTAs of "
          f"{plan['channels_per_cta']} channels on {plan['sms']} SMs, {plan['rows']} rows x "
          f"{plan['stages']} stages, {plan['smem_bytes']} B shared, {plan['in_flight_per_sm']} B "
          f"in flight an SM, route {plan['route']} [{card()}]")
    del a, x, h0, got, again, want
    release()
    return row


# -- phase 35: captured programs against eager launches -------------------------------


# phase 35's drains: phases 3 and 4 (megastep), phase 3's pool under the
# batched generation and under the contest's legacy arm, and phase 13's
# ppermute drain: (huge_factor, LeapConfig, ppermute)
GRAPHED_DRAINS = {
    "small": (1, dict(DRAIN_CFG, warm_dispatch=True), False),
    "huge": (HUGE, dict(DRAIN_CFG, warm_dispatch=True), False),
    "batched": (1, dict(DRAIN_CFG, fused_dispatch="batched"), False),
    "legacy": (1, dict(DRAIN_CFG, fused_dispatch="legacy", chunk_blocks=16), False),
    "ppermute": (1, PP_CFG, True),
}


def graphed_drain_run(dev, name: str, capture: bool) -> tuple:
    """One of phase 35's drains with blocking harvest, so that the schedule
    does not depend on timing, captured or eager; returns the driver and
    its record."""
    release()
    reset_launch_counts()
    huge_factor, cfg_kw, ppermute = GRAPHED_DRAINS[name]
    kw = dict(cfg_kw=cfg_kw)
    slots, seed = SLOTS, SEED + huge_factor
    if ppermute:
        slots, seed = PP_SLOTS, SEED + 2
        kw.update(n_regions=PP_REGIONS, mesh=make_region_mesh(PP_REGIONS))
    prog = program_counts()
    with contextlib.nullcontext() if capture else graphs.disable_capture():
        drv, shadow, handles, times = drain(dev, N_BLOCKS, slots, BLOCK, huge_factor, seed,
                                            blocking=True, **kw)
    launches = launch_counts()
    out = check_drain(drv, shadow, handles, huge=huge_factor > 1)
    del shadow
    now = program_counts()
    out.update(times, launches=launches, jit_cache_misses=drv.stats.jit_cache_misses,
               captures=now[0] - prog[0], replays=now[1] - prog[1],
               tick_ms=times["tick_s"] / drv.stats.ticks * 1e3,
               graph_pool_gib=check_graph_memory(f"phase 35 {name} drain "
                                                 f"{'graphed' if capture else 'eager'}"))
    return drv, out


def graphs_against_eager(dev) -> dict:
    """Phase 35: every drain of ``GRAPHED_DRAINS`` and phase 7's deployment
    through captured programs and through eager launches, bit for bit."""
    out = {"card": card()}
    for name in GRAPHED_DRAINS:
        runs, res = {}, {}
        for mode in ("eager", "graphed"):
            runs[mode], res[mode] = graphed_drain_run(dev, name, capture=mode == "graphed")
        g, e = runs["graphed"].state, runs["eager"].state
        for a, b, what in ((g.pool, e.pool, "pools"), (g.table, e.table, "tables"),
                           (g.dirty, e.dirty, "dirty flags"), (g.in_flight, e.in_flight, "flags")):
            check(torch.equal(a, b), f"{name} drain: graphed and eager {what} bit-identical")
        check(np.array_equal(runs["graphed"].heat_snapshot(), runs["eager"].heat_snapshot()),
              f"{name} drain: graphed and eager heat planes bit-identical")
        check(res["graphed"]["launches"] == res["eager"]["launches"],
              f"{name} drain: replays count the kernels' launches as eager launches do")
        check(res["graphed"]["replays"] == runs["graphed"].stats.dispatches
              and res["eager"]["replays"] == res["eager"]["captures"] == 0,
              f"{name} drain: one replay a program graphed, none eager")
        check(dataclasses.replace(runs["graphed"].stats, jit_cache_misses=0)
              == dataclasses.replace(runs["eager"].stats, jit_cache_misses=0),
              f"{name} drain: the same MigrationStats")
        for mode in ("eager", "graphed"):
            r = res[mode]
            print(f"phase 35 {name} drain {mode}: {r['ticks']} ticks, "
                  f"{r['dispatches_per_tick']:.2f} programs a tick, {r['replays']} replays, "
                  f"{r['captures']} captures, {r['jit_cache_misses']} jit misses, tick() "
                  f"{r['tick_ms']:.3f} ms a tick, drain {r['seconds']:.3f} s, graph pools "
                  f"{r['graph_pool_gib']:.3f} GiB [{card()}]")
        out[f"{name}_drain"] = res
        del runs, g, e
        release()
    cfg, model, pcfg, prompts = serving_deployment(dev)
    runs, res = {}, {}
    for name, live, capture in (("eager_undisturbed", False, False),
                                ("graphed_undisturbed", False, True), ("graphed_live", True, True)):
        reset_launch_counts()
        with contextlib.nullcontext() if capture else graphs.disable_capture():
            eng, sids, handles, times = serve_run(dev, cfg, model, pcfg, prompts, SERVE["steps"],
                                                  live=live)
        launches = launch_counts()
        runs[name] = ([eng.seqs[s].tokens for s in sids], eng.last_logits.clone())
        res[name] = dict(times, launches=launches)
        check(launches["paged_decode"] == SERVE["steps"] * cfg.n_layers,
              f"phase 35 {name}: one paged-decode launch per layer and step")
        check(times["replays"] == (SERVE["steps"] if capture else 0),
              f"phase 35 {name}: one replay a step graphed, none eager")
        print(f"phase 35 serving {name}: decode step {times['decode_step_ms_median']:.3f} ms "
              f"(median), {times['tokens_per_s']:.1f} tok/s, {times['replays']} replays, "
              f"{times['captures']} captures [{card()}]")
        del eng
        torch.cuda.empty_cache()
    for name in ("graphed_undisturbed", "graphed_live"):
        check(runs[name][0] == runs["eager_undisturbed"][0],
              f"phase 35 {name}: the eager run's tokens")
        check(torch.equal(runs[name][1], runs["eager_undisturbed"][1]),
              f"phase 35 {name}: the eager run's last logits, bit for bit")
    out["serving"] = res
    del model, runs
    release()
    return out


# -- phase 36: the examples, and qwen2_7b through launch.serve ----------------------

EXAMPLES = ("quickstart_torch", "serve_paged_torch", "tpch_morsels_torch", "train_e2e_torch")


def example_module(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_on_the_card(dev) -> dict:
    """Each torch example once, on the card, at its own defaults; each
    asserts its own result."""
    out = {}
    for name in EXAMPLES:
        release()
        reset_launch_counts()
        mod = example_module(name)
        t0 = time.perf_counter()
        res = mod.run()
        torch.cuda.synchronize()
        rec = dict(seconds=time.perf_counter() - t0, launches=launch_counts())
        if name == "quickstart_torch":
            rec.update(ticks=res["ticks"], dirty_rejections=res["stats"].dirty_rejections)
            check(rec["launches"]["copy_blocks"] > 0, f"{name} copied through K1")
        elif name == "serve_paged_torch":
            rec.update(steps=len(res["base"]), dirty_rejections=res["stats"].dirty_rejections)
            check(rec["launches"]["paged_decode"] > 0, f"{name} decoded through K4")
        elif name == "tpch_morsels_torch":
            rec.update(migration_s=res["migration_s"], query_ms={
                q: [t * 1e3 for t in ts] for q, ts in res["query_s"].items()})
            check(rec["launches"]["copy_blocks"] > 0, f"{name} copied through K1")
        else:
            losses = [m["loss"] for m in res]
            check(np.isfinite(losses).all() and losses[-1] < losses[0],
                  f"{name}: the loss is finite and falls")
            rec.update(steps=res[-1]["step"], first_loss=losses[0], last_loss=losses[-1])
        print(f"phase 36 {name}: {rec['seconds']:.3f} s, "
              f"{ {k: v for k, v in rec.items() if k not in ('seconds', 'launches')} } "
              f"[{card()}]")
        out[name] = rec
    return out


def qwen_served(dev) -> dict:
    """qwen2_7b at full width and depth through ``launch.serve.main``, the
    port's serving entry point, with request 0's pages leaping mid-decode."""
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    q = QWEN_SERVE
    t0 = time.perf_counter()
    res = serve.main(["--arch", q["arch"], "--rebalance", "--requests", str(q["requests"]),
                      "--prompt-len", str(q["prompt_len"]), "--tokens", str(q["tokens"])])
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    cfg = get_config(q["arch"])
    check(res["layers"] == cfg.n_layers == 28, "qwen2_7b served at full depth")
    check(all(len(t) == q["requests"] and all(0 <= x < cfg.vocab_size for x in t)
              for t in res["tokens"]) and len(res["tokens"]) == q["tokens"],
          "qwen2_7b: a token in the vocabulary per request and step")
    check(launches["paged_decode_g7"] == launches["paged_decode"] == q["tokens"] * res["layers"],
          "qwen2_7b: K4 at G 7 once per layer and decode step")
    check(res["replays"] == q["tokens"], "qwen2_7b: one graph replay a decode step")
    check(res["stats"].blocks_migrated + res["stats"].blocks_forced > 0,
          "qwen2_7b: request 0's pages moved")
    warm = res["step_ms"][1:]  # the first step captures the batch size's graph
    out = dict(seconds=seconds, decode_step_ms_median=statistics.median(warm),
               decode_step_ms=res["step_ms"], first_step_ms=res["step_ms"][0],
               tokens_per_s=q["requests"] * len(warm) / (sum(warm) / 1e3),
               params=lm.count_params(cfg), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, replays=res["replays"],
               blocks_migrated=res["stats"].blocks_migrated,
               dirty_rejections=res["stats"].dirty_rejections)
    print(f"phase 36 qwen2_7b ({out['params']} parameters, 28 layers, bf16) through "
          f"launch.serve: decode step {out['decode_step_ms_median']:.3f} ms (median of "
          f"{len(warm)}; first {out['first_step_ms']:.1f} ms), {out['tokens_per_s']:.1f} tok/s, "
          f"peak {out['peak_gib']:.2f} GiB, {seconds:.1f} s in all [{card()}]")
    return out


def paged_qwen_check(dev) -> dict:
    """K4 at qwen2_7b's decode shape (G 7) against its plain version, timed
    beside its bound and a gather plus ``scaled_dot_product_attention``."""
    p = PAGED_QWEN
    lens = torch.full((p["b"],), QWEN_SERVE["prompt_len"] + QWEN_SERVE["tokens"] // 2)
    q, view, tables, lens_d = paged_inputs(dev, torch.bfloat16, lens, SEED, p)
    got = ops.paged_decode_partial(q, view, tables, lens_d, kv_heads=p["kvh"])
    want = ops.paged_decode_partial(q, view, tables, lens_d, kv_heads=p["kvh"], impl="ref")
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), **PAGED_TOL[torch.bfloat16])
    row = dict(
        name="paged_decode_g7", route="cuda", source="src/repro_torch/kernels/csrc/paged_attn.cu",
        replaces="src/repro/kernels/paged_attn.py:101", launches=0,
        max_abs_err=max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)),
        shape=(f"q [{p['b']}, {p['h']}, {p['hd']}] bf16 (G {p['h'] // p['kvh']}), layer "
               f"{p['layer']} of a [{p['slots']}, {p['layers']}, 2, {p['blk']}, {p['kvh']}, "
               f"{p['hd']}] pool, lens {int(lens[0])} each"),
        **paged_timings(q, view, tables, lens_d, lens, p))
    print(f"paged_decode at qwen2_7b's decode shape (G 7): {row['ms']:.4f} ms (plain "
          f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, bound {row['bound_ms']:.4f}, "
          f"{paged_grid(lens, p)}), max err {row['max_abs_err']:.3g} [{card()}]")
    del q, view, tables, got, want
    torch.cuda.empty_cache()
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = card()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    _build.load()
    print(f"kernels built in {_build.build_info['seconds']:.2f} s: {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    rows = kernel_checks(dev)
    drains = {"small": main_path_drain(dev, 1)}
    drains["huge"] = main_path_drain(dev, HUGE)
    card_matches_cpu(dev)
    release()  # before the peaks of the serving runs
    rows.append(paged_decode_checks(dev))
    serving = serving_full_width(dev)
    rows.append(lru_scan_checks(dev))
    torch.cuda.empty_cache()
    recurrent = recurrent_full_width(dev)
    serving_card_matches_cpu(dev)
    recurrent_card_matches_cpu(dev)
    rows += gather_scatter_checks(dev)
    drains["ppermute"] = main_path_drain(dev, 1, ppermute=True)
    release()
    card_matches_cpu(dev, ppermute=True)
    oracle = megastep_matches_batched(dev)
    contenders = contest(dev)
    tiering = tiering_loop(dev)
    failed = failed_region_drain(dev)
    queries = tpch_over_a_leap(dev)
    chaos = chaos_sweep(dev)
    at_scale = chaos_at_scale(dev)
    load = load_full_width(dev)
    load_cpu = load_card_matches_cpu(dev)
    release()
    wall = {}
    t0 = time.perf_counter()
    moe_res = moe_full_width(dev)
    wall["phase_23_moe_full_width"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_cpu = moe_card_matches_cpu(dev)
    wall["phase_24_moe_card_matches_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xl = xlstm_full_width(dev)
    xl_cpu = xlstm_card_matches_cpu(dev)
    wall["phase_25_xlstm"] = time.perf_counter() - t0
    release()
    t0 = time.perf_counter()
    rows.append(lru_scan_bwd_checks(dev))
    wall["phase_26_lru_scan_bwd"] = time.perf_counter() - t0
    training = {}
    for phase, name, fn in (("phase_27_granite_training", "granite", granite_training),
                            ("phase_28_recurrent_training", "recurrent", recurrent_training),
                            ("phase_29_training_card_matches_cpu", "card_matches_cpu",
                             training_card_matches_cpu)):
        t0 = time.perf_counter()
        training[name] = fn(dev)
        wall[phase] = time.perf_counter() - t0
    release()
    t0 = time.perf_counter()
    rows.append(paged_hd192_checks(dev))
    wall["phase_30_paged_decode_hd192"] = time.perf_counter() - t0
    models = {}
    for phase, name, fn in (
            ("phase_31_nemotron", "nemotron_4_340b", nemotron_full_width),
            ("phase_32_gemma2", "gemma2_27b", lambda d: contiguous_full_width(d, GEMMA_SERVE)),
            ("phase_33_llava", "llava_next_34b",
             lambda d: contiguous_full_width(d, STUB_SERVE[0])),
            ("phase_33_musicgen", "musicgen_large",
             lambda d: contiguous_full_width(d, STUB_SERVE[1]))):
        t0 = time.perf_counter()
        models[name] = fn(dev)
        wall[phase] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = dryrun_cells(dev)
    rows.append(lru_scan_dryrun_check(dev))
    wall["phase_34_dryrun"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graphed = graphs_against_eager(dev)
    wall["phase_35_graphs_against_eager"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    examples = examples_on_the_card(dev)
    examples["qwen2_7b"] = qwen_served(dev)
    rows.append(paged_qwen_check(dev))
    wall["phase_36_examples_and_qwen2_7b"] = time.perf_counter() - t0
    for phase, sec in wall.items():
        print(f"{phase}: {sec:.1f} s wall")

    # each path's counts were set to 0 just before it ran and read just after
    paths = (list(drains.values()) + list(serving["runs"].values())
             + list(recurrent["runs"].values()) + list(contenders.values())
             + [tiering, failed, queries, chaos, at_scale] + list(load["runs"].values())
             + [load_cpu] + [r for m in moe_res.values() for r in m["runs"].values()]
             + [r for r in moe_cpu.values()] + list(xl["runs"].values())
             + list(training.values()) + [r for m in models.values() for r in m["runs"].values()]
             + list(examples.values()))
    # a kernel with a phase-34 row (timed at that phase's shape) counts phase
    # 34's launches there and the earlier phases' in its first row
    phase34 = {row["name"] for row in rows if row.get("phase") == 34}
    for row in rows:
        if row.get("phase") == 34:
            ps = list(dry.values())
        else:
            ps = paths + ([] if row["name"] in phase34 else list(dry.values()))
        row["launches"] = sum(d["launches"][row["name"]] for d in ps)
        check(row["launches"] > 0, f"the main path launched {row['name']}")
    check(sum(r["launches"]["paged_decode"] for r in serving["runs"].values())
          == 2 * SERVE["steps"] * serving["layers"],
          "paged decode launched once per layer and step in both serving runs")
    check(sum(r["launches"]["lru_scan"] for r in recurrent["runs"].values())
          == 2 * recurrent["rec_layers"],
          "lru_scan launched once per rec layer in both recurrent prefills")
    nemo = models["nemotron_4_340b"]
    check(sum(r["launches"]["paged_decode_hd192"] for r in nemo["runs"].values())
          == 3 * nemo["steps"] * nemo["layers"],
          "the hd-192 paged decode launched once per layer and step in the three nemotron runs")

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"drains": drains, "megastep_vs_batched": oracle, "card": smi}))
    print(json.dumps({"serving": serving, "card": smi}))
    print(json.dumps({"recurrent": recurrent, "card": smi}))
    print(json.dumps({"contenders": contenders, "tiering": tiering,
                      "failed_region_drain": failed, "tpch": queries, "card": smi}))
    print(json.dumps({"chaos": chaos, "chaos_at_scale": at_scale, "load": load,
                      "load_card_matches_cpu": load_cpu, "card": smi}))
    print(json.dumps({"moe": moe_res, "moe_card_matches_cpu": moe_cpu, "xlstm": xl,
                      "xlstm_card_matches_cpu": xl_cpu, "wall_s": wall, "card": smi}))
    print(json.dumps({"training": training, "card": smi}))
    print(json.dumps({"models": models, "card": smi}))
    print(json.dumps({"dryrun": dry, "card": smi}))
    print(json.dumps({"graphs_against_eager": graphed, "card": smi}))
    print(json.dumps({"examples": examples, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
