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
   card (sync debug mode raises), a capturing one included.  Every
   application write and read (``leap_write``, ``leap_read``) is one replay
   of its captured I/O program (the replays and the host microseconds a
   tick's I/O are printed).  The captured graphs' memory pools, while the
   driver lives, stay within 1 GiB (printed; so after phases 4, 13, 16 and
   35's drains, and after phase 20; phase 21 adds its payload read's
   output).
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
   Every decode step is one replay of the batch size's captured graph, and
   the prefill is one graph a prompt length (the first prompt of a length
   runs eagerly, then captures; the prefill graph pool is printed); so in
   phases 22, 23, 31 and 36 (phase 24, which copies every routing call to
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
   replay), under 64 writes and 64 reads a tick; the state is placed on the
   mesh, one pool tensor a region in its own allocation (checked); the
   checks of phase 3, gather and scatter launches equal, no ``copy_blocks``,
   the host ms a tick, and the gather's launches, mean lanes a launch and
   their lane counts in bins.
14. A small ppermute drain on the card and on the CPU, both over region
   shards: bit for bit as in phase 5.
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
   at rest: the writer touches no column the queries read).  Q1 and Q6 are
   captured programs (a variant a morsel-batch shape, the parameter an
   operand), as are the store's reads and writes.
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
   batch 8 × 1,024 in 2 microbatches, lr 3e-3 with warmup 2, 10 steps, no
   checkpoint; finite losses and the last below the first; the loss curve,
   median step ms, tokens/s and peak GiB; model FLOPs a step (6 N D) against
   ``roofline.model.PEAK_FLOPS``, the MFU; one more step profiled (kernels,
   device time, busy share).  The trainer's step is a captured program: the
   first step runs eagerly, then one capture, every later step a replay
   (so in phases 28 and 36).
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
   (decode at position 524,287).  Each cell's step is a captured program:
   the first step eager, then one capture and replays, each cell then built
   again and run eagerly; the graphed step is printed beside the eager one
   with the peak and busy share of both, and the second step's outputs
   must agree bit for bit.  Each cell ends ``OK`` with its cut
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
   ppermute drain (over region shards), each with blocking harvest, once
   eager and once graphed (pools region by region, tables, flags and heat
   bit-identical, the same stats and kernel
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
37. The rest of the compile model against eager launches, each run graphed
   and under ``graphs.disable_capture()``: phase 3's drain with its 64
   writes and 64 reads a tick (phase 35's runs: state bit for bit; the
   application I/O seconds of both); the host microseconds a call of each
   application I/O program; each I/O program and a 256-lane force on a
   4-region state over region shards against the one-tensor state (results
   and states bit for bit, host microseconds a call, the force's device ms
   and its launches: one of the shard-table instance over shards, one of K1
   on one tensor); TPC-H Q1 and Q6 over phase 19's store during a
   leap, two parameters each through one variant (bit for bit, ms);
   granite_3_2b's prefill of phase 7's prompts at full width (logits and
   first tokens bit for bit, seconds); three trainer steps of granite_3_2b
   at full width and 4 of its 40 layers (losses, parameters, m, v and step
   bit for bit, step ms); and phase 34's five dry-run cells (outputs bit
   for bit there, step ms and busy shares).  Then every new program's
   variants, captures and replays, and the graph pools' GiB.
38. Regions on several cards: with two or more cards, phase 14's ppermute
   drain with region r on card ``r % cards`` (every copy a peer copy; each
   program one captured graph spanning the cards), then the same drain
   through the xla backend's megastep (one shard-table kernel on the home
   card reaching the other cards' shards over peer access), each bit for
   bit against the same drain on one card, with the bytes that crossed
   between cards by link.  With one card it prints ``regions on several
   cards: not run (1 card)``.
39. The xla backend over region shards, on one card: (a) phase 13's mesh
   and pool (4 regions, 40,960 slots of 64 KiB a region, 131,072 blocks
   leaping to the next region) through the megastep with tiering on and
   ``warm_dispatch``, under 64 writes and 64 reads a tick, every program one
   graph replay: the checks of phase 3, the placement, and one launch of
   the copy kernels' shard-table instance per zero, force, copy and run
   phase of every captured megastep (from the counts its capture
   recorded), no one-tensor K1 or K2 and no K6a or K6b; host ms a tick,
   ticks and graph-pool GiB, then the same drain in turns with the pool one
   tensor and over shards (host ms a tick) and over shards under
   ``torch.profiler`` for the device's busy share; (b) the same on phase 4's two-tier pool
   (``HUGE`` 32), its runs through K2's instance; (c) a small drain over 4
   shards under the megastep, batched, legacy and the sync scheduler (zero
   phases), on the card and on the CPU, blocking harvest: pools region by
   region, tables, flags and stats bit for bit, heat within 1e-6, and the
   card's megastep against the same drain on one pool tensor, bit for bit;
   (d) phase 18's failed-region drain over 4 shards; (e) the shard-table
   instance against its plain version over 4 shards of 16,384 slots, bit
   for bit twice in a row, at 1, 3, 131 and 1,024 lanes of 64 KiB f32, 131
   lanes of an odd bf16 slot, 32 runs of 2 MiB and the zero instance at
   1,024 lanes; K1's instance at 1,024 lanes and K2's at 32 runs timed in
   turns against one-tensor K1 and K2 over the same slots, beside their
   bound and the plain version: the ``copy_blocks_shards`` and
   ``copy_runs_shards`` rows of the kernels line (the 256-lane force over
   4 shards is phase 37's); (f) the dry-run's two leap cells on the card
   through ``python -m repro_torch.launch.dryrun --leap`` in a process of
   its own (16 region shards of 64 KV pages, 23 GiB), each step one replay,
   timed beside its byte bound, the kernels each launched named from its
   trace.
40. The model's sharding over a 4 x 2 ``("data", "model")`` ``DeviceMesh``
   with every position on the card (parameters, m and v placed by the
   reference's rules; the sharded step one graph replay a call), its
   products tensor-parallel over the model axis, against the same state on
   a 4 x 1 mesh (every product whole on a group's one position): (a)
   granite_3_2b at full width, 4 of its 40 layers, batch 8 x 1,024 with
   labels at -100 in one row, ``n_micro`` 2, AdamW at lr 1e-3 from step
   1: two unsharded steps, two 4 x 2 steps graphed and two eager, and two
   4 x 1 steps graphed, from the same seed: step 1's loss within 2e-4 of
   the unsharded step's (1e-4 of it where the products split: 4 x 2 adds
   a row-parallel product's partial sums in another order, and bf16
   rounds some elements the other way), step 2's within rtol 1e-3 (after
   an update), at
   most 1% of the parameters outside rtol 3e-3 / atol 3e-4 and the
   update's error at most 0.2 of its size, each limit short of what a step
   without update reads (also checked), graphed equal to eager bit for
   bit, the eager step without a host sync; for the unsharded, 4 x 1 and
   4 x 2 runs the step ms, peak GiB, the bytes gathered onto each position
   and the all-reduces of a step (4 x 2: all-reduces, and no position
   gathering three quarters of what the 4 x 1 lead gathers), and the bytes
   each position holds equal to ``launch.dryrun.account``; (b)
   recurrentgemma_9b at full width, the first three layers of its pattern
   (rec, rec, win), batch 4 x 1,024: the unsharded steps, then (their
   moments freed) the 4 x 2 and the 4 x 1 ones, the same tolerances and
   readings, K5 and its backward launched under the executor, on 4 x 2 on
   a position's 2,048 channels; (c) ``quantized_mean`` over the data axis
   of a gradient of granite's ``w_in`` shape, on the card against the CPU:
   payloads and scales bit for bit, means within 1 ulp; (d) a granite state
   at full width and one layer saved under 4 x 2, restored onto 2 x 4 bit
   for bit, then one finite step; (e) with two or more cards, a step with
   one position a card against every position on one card; with one card
   it prints ``model sharding over several cards: not run (1 card)``; (f)
   qwen3_moe_235b_a22b at full width, 1 of its 94 layers, batch 8 x 1,024,
   ``n_micro`` 2, ``moe.groups`` 4: its 128 experts over the model axis on
   4 x 2 against 4 x 1, the two states in turn, each placed without a whole
   copy of its moments: step 1's loss within 1e-4 of 4 x 1's, step 2's
   within 1e-2 (one step takes the loss from about 12.4 to 0.19), the
   parameters by a sample of each leaf within (a)'s limits; (g) (a)'s 4 x
   2 run with its residual stream split by sequence (``make_ctx``'s
   default ``seq_shard=True``) against a 4 x 2 run with it whole on each
   group's lead (``seq_shard=False``): step 1's loss bit for bit or within
   1e-4 of it with the op that differs named (a probe of ``rms_norm`` on a
   position's rows), step 2 and the parameters within (a)'s limits, each
   run's graphed step ms and the peak a step allocates over the states it
   finds; (b) the same pair, K5 and its backward launched in both; (h)
   gemma2_27b at full width, 4 layers, in f32: a 4,608-token prompt of 4
   rows prefilled unsharded, the cache (5,120 slots; the window's 4,096)
   placed with ``lm.place_group_caches`` under ``make_ctx`` on 4 x 2 and
   ``make_decode_2d_ctx`` on 8 positions, 8 decode steps against the
   unsharded decode: the logits within rel L2 2e-6 and a control (the
   first step with its newest token not written) beyond it, each
   position's cache bytes equal to the dry-run's, ms a step; (i)
   qwen3_moe_235b_a22b at full width, 1 layer, in f32, 8 rows: a 16-token
   prompt prefilled unsharded, the model placed with ``inference=True``
   (experts stationary over the data axis, their hidden dim over the model
   axis) under ``make_ctx`` on 4 x 2 and ``make_decode_2d_ctx`` on 8
   positions, one at a time, 4 decode steps against the unsharded decode:
   the logits within rel L2 ``SHARD_EXPERT_TOL`` and a control beyond it
   (4 x 2: the return all-to-all's blocks rotated by one group; 8
   positions: a position's hidden block left out), two all-to-alls a step
   on 4 x 2 and none on 8 positions, the picks the unsharded decode drops
   (these three read on the eager run), each position's expert bytes equal
   to the dry-run's; ms a step, bytes gathered, peak GiB; (j) the
   reference's sharded inference programs: ``lm.prefill`` over the placed
   model (``lm.PLACED_PREFILL``) and the placed decode step captured once
   a loop (``lm.PLACED_DECODE``, the position a device operand), for (h)'s
   gemma2, (i)'s qwen3_moe and recurrentgemma_9b at full width, 3 layers
   (rec, rec, win), f32, 4 rows, a 2,048-token prompt, max_len 2,560
   (K5 at [1, 2048, 2048] a position), under both contexts: the placed
   prefill's logits and caches within rel L2 ``PLACED_PREFILL_TOL`` and
   ``PLACED_CACHE_TOL`` of the unsharded prefill's (laid out by
   ``place_group_caches``) and a control beyond each (the prompt with its
   middle token changed), its replay equal to an eager prefill bit for bit
   and the graphs' pools within ``PLACED_PREFILL_POOL_GIB`` beside it; the captured
   decode (from (h)'s and (i)'s placed caches, and from recurrentgemma's
   placed prefill) equal to the eager decode under
   ``graphs.disable_capture()`` bit for bit, logits and caches, with one
   variant, one capture and a replay each later step, and the limits
   against the unsharded decode; seconds of each prefill, ms a step graphed
   and eager; then K5 and its backward at 40(b)'s per-position shape [1,
   1,024, 2,048] f32 against their plain versions, bit for bit, timed: the
   ``phase`` 40 rows of the kernels line, whose launches are 40(b)'s 4 x 2
   run's; and K5 at 40(j)'s [1, 2048, 2048], whose launches are 40(j)'s
   4 x 2 prefills'.

Output: human-readable lines, then the ``{"kernels": [...]}`` line, the
``{"drains": ...}`` line, the ``{"serving": ...}`` line, the
``{"recurrent": ...}`` line, the ``{"contenders": ...}`` line (phases
16-19), the ``{"chaos": ...}`` line (phases 20-22), the ``{"moe": ...}``
line (phases 23-25 and the wall seconds of phases 23-36), the
``{"training": ...}`` line (phases 27-29), the ``{"models": ...}`` line
(phases 31-33), the ``{"dryrun": ...}`` line (phase 34), the
``{"graphs_against_eager": ...}`` line (phase 35), the ``{"examples": ...}``
line (phase 36), the ``{"compile_model_against_eager": ...}`` line (phase
37), the ``{"regions_on_several_cards": ...}`` line (phase 38), the
``{"xla_over_shards": ...}`` line (phase 39), the ``{"model_sharding":
...}`` line (phase 40), and last ``{"ok": true, "device": {...}}``.  Every
time and size of phases 3, 7, 12 (the rounds), 16, 18, 22, 23, 27 (the
MFU) and 30-40 is
printed with the card's name and power limit beside it.
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
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import unittest.mock
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
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.configs.smoke import reduce  # noqa: E402
from repro_torch.core import graphs, migrator  # noqa: E402
from repro_torch.core import state as state_mod  # noqa: E402
from repro_torch.core.pipeline import admission, busy_mask  # noqa: E402
from repro_torch.data import tpch  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.data.morsels import MorselStore  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.fault import drain_region  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402
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
from repro_torch.models import attention, lm, moe, xlstm  # noqa: E402
from repro_torch.models import tensor_parallel  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.roofline import model as roofline  # noqa: E402
from repro_torch.serving.engine import PagedConfig, PagedEngine  # noqa: E402
from repro_torch.tiering import TieringConfig, TieringPolicy  # noqa: E402
from repro_torch.topology import NumaTopology  # noqa: E402
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state  # noqa: E402
from repro_torch.train import train_step as train_step_mod  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainConfig,
    TrainState,
    grad_accum,
    init_train_state,
    state_tensors,
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
TRAIN_GRANITE = dict(batch=8, seq=1024, n_micro=2, lr=3e-3, warmup=2, steps=10)
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
# phase 40: the model's sharding over a 4 x 2 mesh on the card (the
# reference's tests/test_multidevice.py:73 shape and tolerances)
SHARD_MESH = ((4, 2), ("data", "model"))
# the same four data-parallel groups without a model axis to split over:
# every product whole on a group's one position
SHARD_MESH_4X1 = ((4, 1), ("data", "model"))
SHARD_GRANITE = dict(config="granite_3_2b", layers=4, batch=8, seq=1024, n_micro=2, steps=2)
SHARD_RECUR = dict(config="recurrentgemma_9b", layers=3, batch=4, seq=1024, n_micro=1, steps=2)
# 40(f): qwen3_moe_235b_a22b at full width, 1 of its 94 layers (about 3.7e9
# parameters: 7.5 GB of bf16 weights, 29.8 GB of f32 moments, 14.9 GB of f32
# accumulator a state), 8 x 1,024 in two microbatches; moe.groups 4, one
# routing group a data-parallel group's row (the reference's 1 does not
# split over 4 groups)
SHARD_MOE = dict(config="qwen3_moe_235b_a22b", layers=1, batch=8, seq=1024, n_micro=2, steps=2,
                 moe_groups=4)
# K5 and its backward where 40(b) runs them: recurrentgemma_9b's 4,096
# channels over the model axis's 2 positions, a data-parallel group's row
LRU_TP_SHAPE = (1, SHARD_RECUR["seq"], 4096 // SHARD_MESH[0][1])
SHARD_CKPT_LAYERS = 1  # 40(d): granite at full width, one layer
# 40(h): gemma2_27b at full width, 4 of its 46 layers (win, attn, win, attn:
# about 3.45e9 parameters, in f32), 4 rows prefilled
# unsharded with 4,608 tokens (past the 4,096-slot window, so the rolling
# buffer wraps: ROADMAP R4), decoded from a cache of 5,120 slots (both slot
# counts split 2 and 8 ways) placed under make_ctx on 4 x 2 and
# make_decode_2d_ctx on 8 positions
SHARD_DECODE = dict(config="gemma2_27b", layers=4, batch=4, prompt=4608, max_len=5120, steps=8)
# the optimizer of 40(a), (b) and (d): the full rate from step 1, so that
# an update moves a parameter by about 1e-3, past SHARD_PARAM_TOL
SHARD_OPT = dict(peak_lr=1e-3, warmup_steps=1)
# step 1's loss comes before any update: the reference test's 2e-4 (at
# full width the loss is about 1,310, whose f32 ulp is 1.2e-4, so this is
# one or two ulps); later steps follow an update from gradients summed by
# data-parallel group, whose bf16 rounding differs from the whole batch's.
# Their limit, a share of the unsharded loss, and the parameters' (the
# share of elements outside the reference's rtol 3e-3 / atol 3e-4, and the
# error of the update against its size) sit between the sound runs'
# readings and those of a step that applied no update, which every run
# reads too and checks beyond them.  Read on an H100 (PERF.md, PR 31):
# step-2 loss 4.7e-5 and 4.1e-6 of it off, without update 3.25 and 1.4e-2;
# 1.4e-3 and 5.9e-5 of the elements outside, without update 0.71 and
# 0.38; update error 0.037 and 0.0082, without update 1 (granite, then
# recurrentgemma)
SHARD_LOSS_ATOL = 2e-4
SHARD_STEP_LOSS_RTOL = 1e-3
# step 1 of a tensor-parallel run: its row-parallel products add two partial
# sums where one product adds one, and bf16 rounds some of their elements
# the other way, which moves granite's step-1 loss of about 1,312 by about
# 1e-5 of it (0.0104 on an H100 80GB HBM3 at 700 W), where 2e-4 holds only a
# bit-identical forward; a limit of 1e-4 of the loss, ten times that
SHARD_TP_LOSS_RTOL = 1e-4
# 40(f)'s later steps: one full-rate step takes qwen3_moe's one layer from a
# loss of about 12.4 to about 0.19, so a share of the later loss is no
# measure; 1e-2 of it absolute, between the 4 x 2 run's 2.9e-4 from 4 x 1
# and the 12.2 of a step without update (on an H100 80GB HBM3 at 700 W)
SHARD_MOE_LOSS_ATOL = 1e-2
SHARD_PARAM_TOL = dict(rtol=3e-3, atol=3e-4)
# 40(h): the L2 norm of a sharded decode step's logits less the unsharded
# step's, over the unsharded step's.  Read on an H100 80GB HBM3 at 700 W:
# in f32 1.8e-7 to 2.2e-7, and 1.33e-5 for a step whose newest token is
# not written (random weights spread attention over the 4,608 keys): a
# limit of 2e-6 between them.  The decode runs in f32 alone: in bf16 the
# split products' rounding moves the logits by 6.6e-4 to 8.4e-4, the
# control by 9.2e-4 to 9.4e-4 (its own 1.3e-5 lost in the rounding), so no
# limit there tells a sound step from one that lost its newest token
SHARD_DECODE_TOL = 2e-6
# 40(i): qwen3_moe_235b_a22b at full width, 1 of its 94 layers, in f32 (about
# 3.73e9 parameters, 14.9 GB), 8 rows: a 16-token prompt prefilled
# unsharded, then 4 decode steps; moe.groups max(dp, B // 512) = 4 and
# dispatch "tokens", as the dry-run sets a decode cell
SHARD_EXPERT = dict(config="qwen3_moe_235b_a22b", layers=1, batch=8, prompt=16, max_len=32,
                    steps=4, moe_groups=4)
SHARD_EXPERT_TOL = 1e-5
# 40(j): the reference's sharded inference programs ported (lm.prefill over
# the placed model, PLACED_PREFILL; the placed decode step, PLACED_DECODE,
# one capture a loop): 40(h)'s gemma2 and 40(i)'s qwen3_moe, and
# recurrentgemma_9b at full width, its first 3 layers (rec, rec, win 2,048),
# in f32, 4 rows, a prompt as long as its window (ROADMAP R4), so K5 runs at
# [1, 2048, 2048] a position on 4 x 2
PLACED_RECUR = dict(config="recurrentgemma_9b", layers=3, batch=4, prompt=2048, max_len=2560,
                    steps=8)
# 40(j): the placed prefill against the unsharded one, rel L2 of the last
# position's logits and of every cache tensor taken together (against
# place_group_caches of the unsharded cache); each control is the unsharded
# prefill of the prompt with its middle token changed.  Read on an H100
# 80GB HBM3 at 700 W (gemma2, qwen3_moe, recurrentgemma; 4 x 2 and 8
# positions): logits 1.5e-7 to 9.6e-7, controls 1.41e-5, 0.49 and 1.84e-5;
# caches 2.1e-7 to 1.29e-6, controls 0.0215, 0.353 and 0.0311
PLACED_PREFILL_TOL = 4e-6
PLACED_CACHE_TOL = 1e-5
# 40(j): recurrentgemma's decode against its unsharded decode, rel L2 of
# the logits: read 1.6e-7 and 1.9e-7, its control (the first step with its
# newest token unwritten) 1.45e-5
PLACED_RECUR_TOL = 2e-6
# the live graphs' pools while the placed prefill's graph lives (its
# temporaries and outputs): read 0.07 to 7.67 GiB (gemma2 on 8 positions)
PLACED_PREFILL_POOL_GIB = 12.0
SHARD_PARAM_OUTSIDE = 1e-2
SHARD_UPDATE_ERROR = 0.2
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
        "copy_blocks_shards": leap_copy.copy_blocks_shards.launches,
        "copy_runs_shards": leap_copy.copy_runs_shards.launches,
        "zero_blocks_shards": leap_copy.zero_blocks_shards.launches,
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


def io_program_counts() -> tuple[int, int]:
    """Graphs captured and replayed so far over the application's I/O
    programs (``state.IO_PROGRAMS`` and ``busy_mask``)."""
    progs = list(state_mod.IO_PROGRAMS.values()) + [admission.BUSY_MASK]
    return sum(p.captures for p in progs), sum(p.replays for p in progs)


def check_graph_memory(what: str, limit: float = GRAPH_POOL_LIMIT_GIB) -> float:
    """The GiB the live captured graphs' pools reserve, checked against
    ``limit`` and printed."""
    pools, gib = graph_memory()
    print(f"{what}: {pools} captured graphs' memory pools, {gib:.3f} GiB [{card()}]")
    check(gib <= limit, f"{what}: graph pools within {limit:.3f} GiB")
    return gib


def program_pool_gib(*progs) -> float:
    """The GiB the memory pools of ``progs``' live graphs reserve."""
    ids = {tuple(pool) for prog in progs for pool in prog._pools.values()}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) in ids) / 2**30


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
    leap_copy.copy_blocks_shards.launches = 0
    leap_copy.copy_runs_shards.launches = 0
    leap_copy.zero_blocks_shards.launches = 0


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
          values_on=None, n_regions: int = 2, mesh=None, window=None, scheduler=None):
    """Leap every block from its region r to region (r + 1) % n_regions under
    concurrent writes and reads; return the driver, the shadow of what was
    written, the handles and the host seconds of the drain: all of it, inside
    ``session.tick()``, and in the application's writes and reads.  With two
    regions every block starts in region 0; with more, they start spread
    evenly, and each region's blocks are one request.  Writes and reads draw
    their ids from a seeded CPU generator and their values from a seeded
    generator on ``values_on`` (default ``dev``; the CPU where two devices
    must see the same values).  ``mesh`` places the state on a region mesh
    (one pool tensor a region); ``window``, a context manager, encloses the
    timed drain (e.g. a profiler); ``scheduler`` is the driver's."""
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
    drv = MigrationDriver(state, pc, cfg, mesh=mesh, scheduler=scheduler)
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
        seconds = dict(seconds=time.perf_counter() - t0, tick_s=tick_s, io_s=io_s,
                       io_steps=ticks)
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


def check_sharded(drv) -> None:
    """The driver's state is placed on its region mesh: one pool tensor a
    region, each in its own allocation, on the region's device."""
    state, mesh = drv.state, drv.mesh
    check(state.sharded and len(state.pool) == mesh.size, "the pool is one tensor a region")
    check([t.device for t in state.pool] == list(mesh.devices),
          "each region's tensor lies on its mesh device")
    check(len({t.untyped_storage().data_ptr() for t in state.pool}) == mesh.size,
          "each region's tensor has its own allocation")


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
    prog, io = program_counts(), io_program_counts()
    with tap if ppermute else contextlib.nullcontext():
        drv, shadow, handles, times = drain(dev, N_BLOCKS, slots, BLOCK, huge_factor, seed, **kw)
    launches = launch_counts()
    lanes = leap_copy.gather_blocks.lanes
    io_now = io_program_counts()
    out = check_drain(drv, shadow, handles, huge=huge_factor > 1)
    now = program_counts()
    # the payload check reads 8,192 blocks (512 MiB) a call: that variant's
    # output lives in its graph's pool as long as the state does
    out.update(captures=now[0] - prog[0], replays=now[1] - prog[1],
               io_captures=io_now[0] - io[0], io_replays=io_now[1] - io[1],
               jit_cache_misses=drv.stats.jit_cache_misses,
               graph_pool_gib=check_graph_memory(
                   f"drain huge_factor={huge_factor} backend={drv.cfg.backend}"))
    check(out["replays"] == drv.stats.dispatches,
          "every program of the drain was one graph replay")
    # the fill's writes, then a tick's writes and reads: one replay each
    fills = -(-N_BLOCKS // 16384)
    check(out["io_replays"] == fills + 2 * times["io_steps"],
          "every application write and read of the drain was one graph replay")
    if ppermute:
        check_sharded(drv)
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
               backend=drv.cfg.backend, sharded=drv.state.sharded,
               tick_ms=times["tick_s"] / out["ticks"] * 1e3)
    print(f"drain huge_factor={huge_factor} backend={drv.cfg.backend}"
          f"{' over region shards' if drv.state.sharded else ''}: {times['seconds']:.3f} s "
          f"(ticks {times['tick_s']:.3f} s, {out['tick_ms']:.3f} ms a tick; "
          f"app I/O {times['io_s']:.3f} s), "
          f"{out['gib_per_s']:.3f} GiB/s, {out['ticks']} ticks, "
          f"{out['dispatches_per_tick']:.2f} dispatches a tick, "
          f"{out['dirty_rejections']} rejections, peak {out['peak_gib']:.2f} GiB, "
          f"{out['replays']} replays, {out['captures']} captures, "
          f"{out['jit_cache_misses']} jit misses (warm_dispatch={drv.cfg.warm_dispatch}); "
          f"application I/O {out['io_replays']} replays "
          f"({times['io_s'] / times['io_steps'] * 1e6:.1f} us a tick's {IO_PER_TICK} writes "
          f"and {IO_PER_TICK} reads), "
          f"{out['io_captures']} captures; "
          f"launches {launches} [{card()}]")
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


def small_drain(d, huge: int, cfg_kw=SMALL_KW, n_regions: int = 2, devices=None,
                sharded=None, scheduler=None):
    """A small drain with blocking harvest and values drawn on the CPU, so
    that two devices, or two dispatch generations, see the same schedule.
    With ``sharded`` (by default: more than two regions) the state lies on
    a region mesh, region r on ``devices[r]`` (default: every region on
    ``d``)."""
    sharded = n_regions > 2 if sharded is None else sharded
    mesh = make_region_mesh(n_regions, devices or [d] * n_regions) if sharded else None
    slots = 544 if n_regions == 2 else 160
    return drain(d, 512, slots, (2, 64), huge, SEED, io_per_tick=24, cfg_kw=cfg_kw,
                 blocking=True, values_on="cpu", n_regions=n_regions, mesh=mesh,
                 scheduler=scheduler)


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
            check_sharded(gpu)
            check_sharded(cpu)
            after = launch_counts()
            check(after["scatter_blocks"] > before["scatter_blocks"],
                  "the card's ppermute drain ran the scatter kernel")
            check(gpu.stats.dirty_rejections > 0, "writes dirtied some ppermute copies")
    print(f"small {'ppermute' if ppermute else 'megastep and legacy'} drains on the card and on "
          "the CPU agree")


def same_state(a, b, what: str, rejections: bool = True) -> None:
    """Two small drains that must end bit-identical: pools, tables, flags,
    host tables and rejections (some, unless ``rejections`` is False: a
    sync drain forces every move); heat within 1e-6."""
    for x, y in zip(a.state.to_numpy(), b.state.to_numpy()):
        check(np.array_equal(x, y), f"{what}: bit-identical pools, tables and flags")
    check(np.array_equal(a.host_table(), b.host_table()), f"{what}: host tables agree")
    np.testing.assert_allclose(b.heat_snapshot(), a.heat_snapshot(), **HEAT_TOL)
    check(a.stats.dirty_rejections == b.stats.dirty_rejections
          and (a.stats.dirty_rejections > 0 or not rejections), f"{what}: the same rejections")


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
        del drv, shadow, handles  # a handle holds its session, and so the driver

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


def failed_region_drain(dev, mesh=None) -> dict:
    """A four-socket server loses region 3: ``drain_region`` evacuates its
    32,768 blocks of 64 KiB by ``drain_plan`` while the application writes
    and reads.  ``mesh`` places the pool on a region mesh (phase 39)."""
    release()
    pc = PoolConfig(FAILED["regions"], FAILED["slots"], BLOCK, torch.float32,
                    topology=NumaTopology.quad_socket(),
                    region_axis=mesh.axis_name if mesh else None)
    place = start_regions(N_BLOCKS, FAILED["regions"])
    state = init_state(pc, N_BLOCKS, place, device=dev)
    if mesh is not None:
        state = state.to(state_sharding(pc, mesh))
    io = AppIO(dev, N_BLOCKS, BLOCK, SEED + 5)
    io.fill(state)
    drv = MigrationDriver(state, pc, LeapConfig(**DRAIN_CFG), mesh=mesh)
    del state
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
               launches=launches, sharded=drv.state.sharded)
    if mesh is not None:
        check_sharded(drv)
    print(f"failed-region drain{' over region shards' if mesh else ''}: {n} blocks off region "
          f"{FAILED['region']} in {seconds:.3f} s "
          f"({out['gib_per_s']:.3f} GiB/s), {s.ticks} ticks, {s.dirty_rejections} rejections, "
          f"blocks a region {out['per_region']}, links {out['bytes_per_link']}, "
          f"launches {launches} [{card()}]")
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
    gc.collect()  # the earlier scenarios' drivers, which sit in reference cycles
    pools = check_graph_memory("phase 20, the serving scenario's driver alive")
    return dict(seeds=seeds, sabotage=caught.invariant, graph_pool_gib=pools,
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
    # the payload checker reads every block at once (leap_read over
    # n_blocks): that variant's output, 2 GiB, lives in its graph's pool
    # beside the 11 GiB pool as long as the state does
    payload_gib = CHAOS_AT_SCALE.n_blocks * chaos.driver.pool_cfg.block_bytes / 2**30
    pools = check_graph_memory("phase 21, the chaos driver alive",
                               GRAPH_POOL_LIMIT_GIB + payload_gib)
    out = dict(setup_s=setup_s, seconds=seconds, checker_s=checker_s[0], graph_pool_gib=pools,
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
    prog, pre = eng._decode_step, eng._prefill
    if dev.type == "cuda":
        check(prog.replays == len(calls) > 0 and prog.captures == len(prog) == len(set(calls)),
              "every decode call was one replay, one captured graph per batch size")
        check(pre.captures == len(pre) > 0 and pre.replays > 0,
              "one prefill graph a prompt length, replayed for later prompts")
    return gen, tokens, dict(tick_s=tick_s, check_s=check_s, decode_calls=len(calls),
                             batch_sizes=sorted(set(calls)), replays=prog.replays,
                             captures=prog.captures, prefill_variants=len(pre),
                             prefill_replays=pre.replays,
                             prefill_pool_gib=program_pool_gib(pre) if dev.type == "cuda"
                             else None)


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
            captures=times["captures"], prefill_variants=times["prefill_variants"],
            prefill_replays=times["prefill_replays"],
            prefill_pool_gib=times["prefill_pool_gib"], launches=launches)
        o = out[f"run{i}"]
        print(f"load run {i}: modeled p50 {rep['p50']:.4f} p99 {rep['p99']:.4f} (gold p99 "
              f"{o['gold_p99']:.4f}, SLO met {o['gold_slo_met']}), mig_rate "
              f"{rep['mig_rate']:.4f}, admitted {o['admitted']}, dropped {rep['dropped']}, "
              f"at most {o['max_running']} running; wall {seconds:.3f} s, tick "
              f"{o['tick_ms_median']:.1f} ms median ({o['tick_ms_max']:.1f} max), checks "
              f"{times['check_s']:.3f} s; {o['replays']} decode replays over batch sizes "
              f"{o['batch_sizes']}; prefill {o['prefill_variants']} lengths, "
              f"{o['prefill_replays']} replays, graph pool {o['prefill_pool_gib']:.3f} GiB; "
              f"launches {launches} [{card()}]")
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
        prefill_variants=len(eng._prefill), prefill_captures=eng._prefill.captures,
        prefill_replays=eng._prefill.replays,
        prefill_pool_gib=program_pool_gib(eng._prefill) if dev.type == "cuda" else None,
    )
    if dev.type == "cuda" and graphs._capture:
        lengths = len({len(p) for p in prompts})
        check(times["prefill_variants"] == times["prefill_captures"] == lengths
              and times["prefill_replays"] == len(prompts) - lengths,
              "one prefill graph a prompt length, its first prompt eager, the rest replays")
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
        print(f"serving {name}: prefill {times['prefill_s']:.3f} s ({times['prefill_replays']} "
              f"replays, prefill graph pool {times['prefill_pool_gib']:.3f} GiB), decode step "
              f"{times['decode_step_ms_median']:.3f} ms (median), {times['tokens_per_s']:.1f} "
              f"tok/s, decode {times['decode_s']:.3f} s, ticks {times['tick_s']:.3f} s, peak "
              f"{times['peak_gib']:.2f} GiB, {times['replays']} replays, launches {launches} "
              f"[{card()}]")
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


def lru_bwd_bound(a: torch.Tensor, h0: torch.Tensor) -> tuple[float, str]:
    """The backward: g, a and h read once, da and db written once, h0 read
    and dh0 written (f32); 3 flops an element."""
    return bound_ms(5 * a.numel() * a.element_size() + 2 * h0.numel() * 4, 3.0 * a.numel())


def lru_bwd_plan_text(plan: dict) -> str:
    return (f"{plan['ctas']} CTAs of {plan['channels_per_cta']} channels on {plan['sms']} SMs, "
            f"{plan['rows']} rows x {plan['stages']} stages, {plan['smem_bytes']} B shared, "
            f"{plan['in_flight_per_sm']} B in flight an SM, route {plan['route']}")


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
                  f"{res[name]['dropped_picks_prefill']} at prefill, prefill graph pool "
                  f"{times['prefill_pool_gib']:.3f} GiB, launches {launches} [{card()}]")
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
    """The backward kernel at the timed forward shape, at phase 28's training
    shape and at phase 40(b)'s 4 x 1 group shape, bit for bit against its
    plain version and run to run, timed against its byte bound with the
    plan it launched; and the Function's gradient against finite
    differences."""
    r = get_config("recurrentgemma_9b").rnn_width
    shapes = {"timed": (RECUR["prompts"], RECUR["prompt_len"], r),
              "training": (TRAIN_RECUR["batch"], TRAIN_RECUR["seq"], r),
              "tp_group": (1, LRU_TP_SHAPE[1], r)}
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
        bound, by = lru_bwd_bound(a, h0)
        out[name] = dict(
            shape=f"g, a, h, da, db [{b}, {t}, {rr}] f32, h0, dh0 [{b}, {rr}] f32",
            max_abs_err=max(float((k - p).abs().max()) for k, p in zip(got, want)),
            ms=time_ms(lambda: lru_scan.lru_scan_bwd(gy, a, h, h0)),
            plain_ms=time_ms(lambda: ref.lru_scan_bwd_ref(gy, a, h, h0), iters=2, repeats=3),
            bound_ms=bound, bound_by=by, plan=lru_scan.lru_scan_bwd.last_plan.describe(),
        )
        o = out[name]
        print(f"lru_scan_bwd at [{b}, {t}, {rr}] f32: {o['ms']:.4f} ms (plain "
              f"{o['plain_ms']:.4f}, bound {bound:.4f}, {bound / o['ms']:.0%} of it), "
              f"bit-exact; plan: {lru_bwd_plan_text(o['plan'])} [{card()}]")
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
        shape=main["shape"], plan=main["plan"], training_shape=out["training"],
        tp_group_shape=out["tp_group"], finite_difference_rel_err=fd_err,
    )
    print(f"lru_scan_bwd: {main['ms']:.4f} ms (plain {main['plain_ms']:.4f}, bound "
          f"{main['bound_ms']:.4f}), bit-exact; at the training shape "
          f"{out['training']['ms']:.4f} ms (bound {out['training']['bound_ms']:.4f}); at the "
          f"4 x 1 group's {out['tp_group']['ms']:.4f} ms (bound "
          f"{out['tp_group']['bound_ms']:.4f}); gradient against finite differences "
          f"{fd_err:.3g} [{card()}]")
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
        captures=tr._step_fn.captures, replays=tr._step_fn.replays,
        graph_pool_gib=program_pool_gib(tr._step_fn),
    )
    if graphs._capture:
        check(res["captures"] == 1 and res["replays"] == spec["steps"] - 1,
              f"{cfg.name}: the first step eager, one capture, every later step a replay")
    print(f"{cfg.name} training ({cfg.n_layers} layers, {res['params']:,} params): losses "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"  step {res['step_ms_median']:.1f} ms (median; first {res['first_step_ms']:.1f}), "
          f"{res['tokens_per_s']:.0f} tokens/s, peak {res['peak_gib']:.2f} GiB, init "
          f"{init_s:.1f} s, {res['replays']} replays, graph pool {res['graph_pool_gib']:.3f} "
          f"GiB, launches {launches} [{card()}]")
    return tr, res


def granite_training(dev) -> dict:
    """Phase 27: granite_3_2b at full width and all 40 layers, 10 steps."""
    cfg = get_config("granite_3_2b")
    tr, res = train_run(dev, cfg, TRAIN_GRANITE)
    check(res["losses"][-1] < res["losses"][0], "granite_3_2b's loss falls over 10 steps")
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
    res["profiled_step"] = prof = profile_step(tr)
    print(f"  one more step profiled: {prof['kernels']} kernels, {prof['device_ms']:.1f} ms of "
          f"device time in {prof['wall_ms']:.1f} ms (busy {prof['busy_share']:.3f})")
    # the step's graph keeps its temporaries (the eager step's peak less the
    # state): let it go before the eager gradients below
    tr._step_fn.clear()
    release()
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
    del grads, tr
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
            # graphed: the eager first step, timed replays, a profiled one;
            # then eager: timed steps and a profiled one
            steps = (1 + dryrun.TIMED_STEPS["prefill"] + 1) + (dryrun.EAGER_STEPS["prefill"] + 1)
            check(launches["lru_scan"] == steps * n_rec,
                  f"{what}: lru_scan launched once per rec layer and step, graphed or eager")
        e = art["eager"]
        check(art["graphed_equals_eager"],
              f"{what}: the second step's outputs graphed and eager, bit for bit")
        check(m["captures"] == 1 and m["replays"] == dryrun.TIMED_STEPS[SHAPES[shape].kind] + 1,
              f"{what}: one capture, then every graphed step a replay")
        bound_ms = art["roofline"]["step_time_s"] * 1e3
        print(f"dry-run {arch} {shape} ({art['reduced'] or 'not cut'}): step "
              f"{m['step_ms']:.2f} ms (median of {m['steps_ms']}), first step "
              f"{art['first_step_s']:.2f} s, device {m['device_ms']:.2f} ms (busy "
              f"{m['busy']:.3f} of the median step; {m['busy_profiled']:.3f} of the profiled "
              f"step's {m['window_ms']:.2f} ms), peak {m['peak_bytes'] / 2**30:.2f} "
              f"GiB, arguments {mem['argument_bytes']} B (meta {want}), bound {bound_ms:.3f} ms "
              f"({art['roofline']['dominant']}), step / bound {m['step_ms'] / bound_ms:.2f}, "
              f"{m['kernels']} device events, wall {wall_s:.1f} s [{card()}]")
        print(f"dry-run {arch} {shape} graphed against eager: step {m['step_ms']:.2f} against "
              f"{e['step_ms']:.2f} ms (eager {e['steps_ms']}), busy {m['busy']:.3f} against "
              f"{e['busy']:.3f}, peak {m['peak_bytes'] / 2**30:.2f} against "
              f"{e['peak_bytes'] / 2**30:.2f} GiB, device {m['device_ms']:.2f} against "
              f"{e['device_ms']:.2f} ms, {m['kernels']} against {e['kernels']} device events; "
              f"outputs bit for bit: {art['graphed_equals_eager']} [{card()}]")
        arts[(arch, shape)] = art
        res[f"{arch}__{shape}"] = dict(
            status=art["status"], reduced=art["reduced"], full=art["full"], memory=mem,
            measured={k: v for k, v in m.items() if k != "trace"}, roofline=art["roofline"],
            build_s=art["build_s"], first_step_s=art["first_step_s"], wall_s=wall_s,
            launches=launches, eager={k: v for k, v in e.items() if k != "trace"},
            graphed_equals_eager=art["graphed_equals_eager"])
    release()
    print(report.measured_table("h100", arts) + f"\n[{card()}]")
    return res


def lru_scan_dryrun_check(dev) -> dict:
    """Phase 34's K5 row: the kernel against its plain version, bit for bit
    and run to run, at the shape recurrentgemma_9b's ``prefill_32k`` cell
    gives it (batch 1, 32,768 steps, rnn_width 4,096: a serial chain of
    32,768 steps a channel), timed against its byte bound, with the plan it
    launched."""
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
    prog, io = program_counts(), io_program_counts()
    with contextlib.nullcontext() if capture else graphs.disable_capture():
        drv, shadow, handles, times = drain(dev, N_BLOCKS, slots, BLOCK, huge_factor, seed,
                                            blocking=True, **kw)
        launches = launch_counts()
        io_now = io_program_counts()
        out = check_drain(drv, shadow, handles, huge=huge_factor > 1)  # its reads too
    del shadow
    now = program_counts()
    out.update(times, launches=launches, jit_cache_misses=drv.stats.jit_cache_misses,
               captures=now[0] - prog[0], replays=now[1] - prog[1],
               io_captures=io_now[0] - io[0], io_replays=io_now[1] - io[1],
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
        if GRAPHED_DRAINS[name][2]:
            for drv in runs.values():
                check_sharded(drv)
        check(all(torch.equal(a, b) for a, b in zip(g.regions, e.regions)),
              f"{name} drain: graphed and eager pools bit-identical, region by region")
        for a, b, what in ((g.table, e.table, "tables"), (g.dirty, e.dirty, "dirty flags"),
                           (g.in_flight, e.in_flight, "flags")):
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


# -- phase 37: the rest of the compile model against eager launches ------------------

IO_CALLS = 200  # calls of each I/O program timed on the host, after 10 warm ones
# phase 37's trainer: granite_3_2b at full width, 4 of its 40 layers, phase
# 27's batch, 3 steps
TRAIN_37 = dict(TRAIN_GRANITE, steps=3)
TRAIN_37_LAYERS = 4
TPCH_37 = dict(ticks=4, q1=(TPCH["q1_cutoff"], 1200.0), q6=(TPCH["q6_year"], 1095.0))


def modes():
    """(name, context) for the graphed run and the eager one."""
    return (("graphed", contextlib.nullcontext), ("eager", graphs.disable_capture))


def io_call_us(dev) -> dict:
    """Host microseconds a call of each application I/O program, graphed and
    eager: 64 ids a call over a two-tier pool of 4,096 blocks of 64 KiB (two
    huge blocks a group call), the loop queued without a sync."""
    n = 4096
    pc = PoolConfig(2, n + 64, BLOCK, torch.float32, huge_factor=HUGE)
    state = init_state(pc, n, np.zeros(n, np.int32), device=dev)
    g = torch.Generator().manual_seed(SEED)
    ids, groups = torch.randperm(n, generator=g)[:IO_PER_TICK], torch.arange(2)
    offs = torch.zeros(IO_PER_TICK, dtype=torch.int64)
    vals = torch.randn((IO_PER_TICK,) + BLOCK, device=dev)
    calls = {
        "leap_read": lambda: state_mod.leap_read(state, ids),
        "leap_write": lambda: state_mod.leap_write(state, ids, vals),
        "leap_write_rows": lambda: state_mod.leap_write_rows(state, ids, offs, vals[:, 0]),
        "block_regions": lambda: state_mod.block_regions(state, ids),
        "huge_read": lambda: state_mod.huge_read(state, groups, HUGE),
        "group_dirty": lambda: state_mod.group_dirty(state, groups, HUGE),
        "group_in_flight": lambda: state_mod.group_in_flight(state, groups, HUGE),
        "busy_mask": lambda: busy_mask(state, ids),
    }
    out = {}
    for mode, ctx in modes():
        with ctx():
            for name, call in calls.items():
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(IO_CALLS):
                    call()
                host = time.perf_counter() - t0
                torch.cuda.synchronize()
                out.setdefault(name, {})[mode] = host / IO_CALLS * 1e6
    print("phase 37 host us a call (graphed / eager): " + ", ".join(
        f"{k} {v['graphed']:.1f} / {v['eager']:.1f}" for k, v in out.items()) + f" [{card()}]")
    del state
    return out


# phase 37: the I/O and the force on a 4-region state placed on a one-card
# region mesh against the one-tensor state: 4,096 blocks of 64 KiB spread
# over the regions (groups of HUGE blocks on aligned runs), 320 free slots a
# region, and a force of one drain area (256 lanes) to the next region
SHARDED_37 = dict(blocks=4096, free=320, force=256)


def sharded_pair(dev) -> tuple:
    """Two equal states of ``SHARDED_37``: one pool tensor, and one placed on
    a one-card mesh of ``PP_REGIONS`` regions; every block written once."""
    n, regions = SHARDED_37["blocks"], PP_REGIONS
    pc = PoolConfig(regions, n // regions + SHARDED_37["free"], BLOCK, torch.float32,
                    region_axis="data", huge_factor=HUGE)
    place = start_regions(n, regions)
    vals = torch.randn((n,) + BLOCK, generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev)
    states = []
    for placed in (False, True):
        state = init_state(pc, n, place, device=dev)
        if placed:
            state = state.to(state_sharding(pc, make_region_mesh(regions, [dev] * regions)))
        leap_write(state, np.arange(n), vals)
        states.append(state)
    return states, place


def same_states(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a.regions, b.regions))
            and torch.equal(a.table, b.table) and torch.equal(a.dirty, b.dirty)
            and torch.equal(a.in_flight, b.in_flight))


def sharded_against_one_tensor(dev) -> dict:
    """Phase 37: each application I/O program and the force on a 4-region
    sharded state against the one-tensor state, graphed: results and states
    bit for bit, the host microseconds a call (queued without a sync) and
    the force's device ms a call (CUDA events), with its launches (one of
    the shard-table instance over shards, one of K1 on one tensor)."""
    (one, shards), place = sharded_pair(dev)
    check(shards.sharded and not one.sharded, "phase 37: a sharded and a one-tensor state")
    n, k = SHARDED_37["blocks"], SHARDED_37["force"]
    g = torch.Generator().manual_seed(SEED)
    ids, groups = torch.randperm(n, generator=g)[:IO_PER_TICK], torch.arange(2)
    offs = torch.zeros(IO_PER_TICK, dtype=torch.int64)
    vals = torch.randn((IO_PER_TICK,) + BLOCK, device=dev)
    # the force: the first k blocks of region 0 to region 1's free slots and back
    fids = torch.arange(k)
    homes = torch.from_numpy(place[:k].astype(np.int64))
    free = torch.arange(SHARDED_37["free"])[:k] + n // PP_REGIONS
    plans = [(fids, homes + 1, free), (fids, homes, free)]  # out, then in again
    calls = {
        "leap_read": lambda s: state_mod.leap_read(s, ids),
        "leap_write": lambda s: state_mod.leap_write(s, ids, vals),
        "leap_write_rows": lambda s: state_mod.leap_write_rows(s, ids, offs, vals[:, 0]),
        "block_regions": lambda s: state_mod.block_regions(s, ids),
        "huge_read": lambda s: state_mod.huge_read(s, groups, HUGE),
        "group_dirty": lambda s: state_mod.group_dirty(s, groups, HUGE),
        "group_in_flight": lambda s: state_mod.group_in_flight(s, groups, HUGE),
    }
    for name, call in calls.items():
        a, b = call(one), call(shards)
        check(torch.equal(a, b) if isinstance(a, torch.Tensor) else same_states(a, b),
              f"phase 37 {name}: sharded and one-tensor bit for bit")
    states = dict(one_tensor=one, sharded=shards)
    turns = ("one_tensor", "sharded", "sharded", "one_tensor")
    out = {name: {layout: [] for layout in states} for name in calls}
    for layout in turns:  # in turns, so that neither layout has the warmer host
        for name, call in calls.items():
            for _ in range(10):
                call(states[layout])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(IO_CALLS):
                call(states[layout])
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            out[name][layout].append(host / IO_CALLS * 1e6)
    force = {layout: dict(host_us=[], device_ms=[]) for layout in states}
    for state in states.values():
        for plan in plans:  # capture the variant; the blocks end where they started
            migrator.force_areas(state, *plan)
    for layout in turns:
        turn = itertools.count()

        def call(state=states[layout]):
            migrator.force_areas(state, *plans[next(turn) % 2])

        force[layout]["device_ms"].append(time_ms(call))  # 300 calls, behind a sleep kernel
        before = launch_counts()
        t0 = time.perf_counter()
        for _ in range(IO_CALLS):
            call()
        force[layout]["host_us"].append((time.perf_counter() - t0) / IO_CALLS * 1e6)
        torch.cuda.synchronize()
        after = launch_counts()
        force[layout].update({kn: (after[kn] - before[kn]) / IO_CALLS
                              for kn in ("copy_blocks", "copy_blocks_shards", "gather_blocks",
                                         "scatter_blocks")})
    check(same_states(one, shards), "phase 37 the force: sharded and one-tensor bit for bit")
    check(force["sharded"]["copy_blocks_shards"] == 1 and force["sharded"]["copy_blocks"]
          == force["sharded"]["gather_blocks"] == force["sharded"]["scatter_blocks"] == 0,
          "phase 37 the sharded force: one shard-table launch, no K1, K6a or K6b")
    check(force["one_tensor"]["copy_blocks"] == 1 and force["one_tensor"]["copy_blocks_shards"]
          == 0, "phase 37 the one-tensor force: one K1 launch")
    out["force_areas"] = force

    def pair(v) -> str:
        return "; ".join(f"{x:.1f}" for x in v)

    print("phase 37 host us a call over 4 regions, two turns each (one tensor / sharded): "
          + ", ".join(f"{name} {pair(v['one_tensor'])} / {pair(v['sharded'])}"
                      for name, v in out.items() if name != "force_areas") + f" [{card()}]")
    f1, fs = force["one_tensor"], force["sharded"]
    print(f"phase 37 force of {k} lanes of 64 KiB (one tensor / sharded): host "
          f"{pair(f1['host_us'])} / {pair(fs['host_us'])} us a call, device "
          f"{'; '.join(f'{x:.4f}' for x in f1['device_ms'])} / "
          f"{'; '.join(f'{x:.4f}' for x in fs['device_ms'])} ms a call; a sharded force "
          f"launches the shard-table instance {fs['copy_blocks_shards']:.0f} time(s) "
          f"[{card()}]")
    del one, shards
    return out


def tpch_against_eager(dev) -> dict:
    """Phase 19's store during a leap: Q1 and Q6 at two parameters each,
    through one variant a query and length, graphed and eager: bit for bit,
    with their ms."""
    release()
    store = MorselStore.create(
        tpch.gen_lineitem(TPCH["rows"], seed=SEED), TPCH["rows_per_morsel"], 2,
        leap=LeapConfig(initial_area_blocks=256, budget_blocks_per_tick=1024))
    store.steal(np.arange(store.n_morsels), 1)
    before = {q: (len(p), p.captures, p.replays) for q, p in (("q1", tpch.Q1), ("q6", tpch.Q6))}
    ms = {q: {m: [] for m, _ in modes()} for q in ("q1", "q6")}
    for _ in range(TPCH_37["ticks"]):
        store.tick()
        got = {}
        for mode, ctx in modes():
            with ctx():
                for q in ("q1", "q6"):
                    for p in TPCH_37[q]:
                        got[mode, q, p], sec = timed_query(store, q, p)
                        ms[q][mode].append(sec * 1e3)
        for q in ("q1", "q6"):
            a, b = (got["graphed", q, p] for p in TPCH_37[q])
            check(not torch.equal(a, b), f"{q}: two parameters through one variant, two results")
            for p in TPCH_37[q]:
                check(torch.equal(got["graphed", q, p], got["eager", q, p]),
                      f"{q} at {p} during the leap: graphed and eager bit for bit")
    check(not store.driver.done, "the queries ran while the leap was in flight")
    out = {}
    for q, prog in (("q1", tpch.Q1), ("q6", tpch.Q6)):
        v, c, r = before[q]
        # a full batch of 64 morsels and no shorter last one (16,384 morsels)
        check(len(prog) - v <= 1 and prog.captures - c <= 1,
              f"{q}: both parameters through one variant")
        out[q] = dict(graphed_ms=statistics.median(ms[q]["graphed"]),
                      eager_ms=statistics.median(ms[q]["eager"]), variants=len(prog),
                      captures=prog.captures, replays=prog.replays,
                      pool_gib=program_pool_gib(prog))
    print(f"phase 37 TPC-H during a leap (median of {2 * TPCH_37['ticks']}): Q1 "
          f"{out['q1']['graphed_ms']:.2f} ms graphed, {out['q1']['eager_ms']:.2f} eager; Q6 "
          f"{out['q6']['graphed_ms']:.2f} graphed, {out['q6']['eager_ms']:.2f} eager; "
          f"Q1 {out['q1']['captures']} captures, {out['q1']['replays']} replays, Q6 "
          f"{out['q6']['captures']} captures, {out['q6']['replays']} replays; graph pools "
          f"{out['q1']['pool_gib'] + out['q6']['pool_gib']:.3f} GiB [{card()}]")
    store.drain()
    del store
    return out


def prefill_against_eager(dev) -> dict:
    """Phase 7's prompts through the engine's prefill at full width,
    graphed and eager: logits and first tokens bit for bit."""
    release()
    cfg, model, pcfg, prompts = serving_deployment(dev)
    res, logits, tokens = {}, {}, {}
    for mode, ctx in modes():
        eng = PagedEngine(cfg, model, pcfg, device=dev)
        prog, kept = eng._prefill, []

        def tap(*args, _prog=prog, **kw):
            out = _prog(*args, **kw)
            kept.append(out[0].clone())
            return out

        eng._prefill = tap
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx():
            sids = [eng.admit(p) for p in prompts]
        torch.cuda.synchronize()
        res[mode] = dict(prefill_s=time.perf_counter() - t0, variants=len(prog),
                         captures=prog.captures, replays=prog.replays,
                         pool_gib=program_pool_gib(prog))
        logits[mode], tokens[mode] = kept, [eng.seqs[s].tokens for s in sids]
        del eng, prog, tap
        torch.cuda.empty_cache()
    check(tokens["graphed"] == tokens["eager"], "the prefill's first tokens, graphed and eager")
    check(all(torch.equal(a, b) for a, b in zip(logits["graphed"], logits["eager"])),
          "the prefill's logits, graphed and eager, bit for bit")
    g = res["graphed"]
    check(g["captures"] == 1 and g["replays"] == len(prompts) - 1,
          "one prefill graph, replayed for every later prompt")
    print(f"phase 37 granite_3_2b prefill of {len(prompts)} prompts of {prompts.shape[1]} tokens "
          f"(admit, pages included): {g['prefill_s']:.3f} s graphed, "
          f"{res['eager']['prefill_s']:.3f} s eager; {g['captures']} capture, {g['replays']} "
          f"replays, graph pool {g['pool_gib']:.3f} GiB [{card()}]")
    del model
    release()
    return res


def trainer_against_eager(dev) -> dict:
    """``TRAIN_37`` steps of granite_3_2b at full width and reduced depth,
    graphed and eager from one seed: losses, parameters, m, v and step bit
    for bit."""
    release()
    cfg = dataclasses.replace(get_config("granite_3_2b"), n_layers=TRAIN_37_LAYERS)
    runs, res = {}, {}
    for mode, ctx in modes():
        with ctx():
            tr, r = train_run(dev, cfg, TRAIN_37)
        prog = tr._step_fn
        res[mode] = dict(step_ms=r["step_ms"], step_ms_median=r["step_ms_median"],
                         peak_gib=r["peak_gib"], losses=r["losses"], captures=prog.captures,
                         replays=prog.replays, pool_gib=program_pool_gib(prog))
        runs[mode] = tr
    g, e = runs["graphed"], runs["eager"]
    check(res["graphed"]["captures"] == 1 and res["graphed"]["replays"] == TRAIN_37["steps"] - 1,
          "the first step eager, one capture, every later step a replay")
    check(g.history == e.history, "losses, gradient norms and learning rates bit for bit")
    check(all(torch.equal(a, b) for a, b in zip(state_tensors(g.state), state_tensors(e.state))),
          "parameters, m, v and step bit for bit after the steps")
    check(int(g.state.opt["step"]) == TRAIN_37["steps"], "one update a call")
    print(f"phase 37 granite_3_2b training ({TRAIN_37_LAYERS} of 40 layers, batch "
          f"{TRAIN_37['batch']} x {TRAIN_37['seq']}): step ms graphed "
          f"{[round(x, 2) for x in res['graphed']['step_ms']]}, eager "
          f"{[round(x, 2) for x in res['eager']['step_ms']]}; peak "
          f"{res['graphed']['peak_gib']:.2f} GiB graphed, {res['eager']['peak_gib']:.2f} eager; "
          f"graph pool {res['graphed']['pool_gib']:.3f} GiB [{card()}]")
    del runs, g, e
    release()
    return res


def compile_model_against_eager(dev, drains: dict, dry: dict) -> dict:
    """Phase 37: the programs this slice compiles, each graphed and under
    ``graphs.disable_capture()``: the I/O programs' host cost a call, TPC-H
    during a leap, the full-width prefill, three trainer steps; and, from
    the runs of phases 35 and 34, phase 3's drain with its application
    writes and reads (phase 35 compared its state bit for bit) and the five
    dry-run cells (phase 34 compared their outputs)."""
    out = {"card": card()}
    r, e = drains["graphed"], drains["eager"]
    fills = -(-N_BLOCKS // 16384)
    check(r["io_replays"] == fills + 2 * r["io_steps"] and e["io_replays"] == 0,
          "phase 3's drain: every application write and read a replay graphed, none eager")
    print(f"phase 37 phase 3's drain (phase 35's runs): app I/O {r['io_s']:.3f} s graphed "
          f"({r['io_s'] / r['io_steps'] * 1e6:.1f} us a tick), {e['io_s']:.3f} s eager "
          f"({e['io_s'] / e['io_steps'] * 1e6:.1f} us); {r['io_replays']} I/O replays, "
          f"{r['io_captures']} captures; graph pools {r['graph_pool_gib']:.3f} GiB with the "
          f"driver alive [{card()}]")
    out["drain"] = dict(graphed={k: r[k] for k in ("io_s", "io_steps", "io_replays",
                                                    "io_captures", "graph_pool_gib")},
                        eager={k: e[k] for k in ("io_s", "io_steps", "io_replays")})
    out["io_call_us"] = io_call_us(dev)
    out["sharded_against_one_tensor"] = sharded_against_one_tensor(dev)
    out["tpch"] = tpch_against_eager(dev)
    out["prefill"] = prefill_against_eager(dev)
    out["training"] = trainer_against_eager(dev)
    out["dryrun"] = {}
    for cell, d in dry.items():
        check(d["graphed_equals_eager"], f"phase 37 dry-run {cell}: graphed equals eager")
        m, ea = d["measured"], d["eager"]
        out["dryrun"][cell] = dict(graphed_ms=m["step_ms"], eager_ms=ea["step_ms"],
                                   graphed_busy=m["busy"], eager_busy=ea["busy"],
                                   captures=m["captures"], replays=m["replays"])
        print(f"phase 37 dry-run {cell} (phase 34's runs): step {m['step_ms']:.2f} ms graphed, "
              f"{ea['step_ms']:.2f} eager; busy {m['busy']:.3f} graphed, {ea['busy']:.3f} "
              f"eager; {m['captures']} capture, {m['replays']} replays; outputs bit for bit "
              f"[{card()}]")
    progs = list(state_mod.IO_PROGRAMS.values()) + [admission.BUSY_MASK, tpch.Q1, tpch.Q6]
    out["programs"] = {p.name: dict(variants=len(p), captures=p.captures, replays=p.replays)
                       for p in progs}
    print("phase 37 programs (variants, captures, replays): " + ", ".join(
        f"{k} {v['variants']}/{v['captures']}/{v['replays']}" for k, v in out["programs"].items()))
    out["graph_pool_gib"] = check_graph_memory("phase 37, at its end")
    return out


# -- phase 38: regions on several cards -----------------------------------------------


def regions_on_several_cards(dev) -> dict:
    """Phase 38: with two or more cards, phase 14's small ppermute drain,
    then the same drain through the xla backend's megastep (one shard-table
    kernel on ``dev`` reaching the other cards' shards), with region r on
    card ``r % cards`` (graphed: one capture spanning the cards a variant),
    each held bit for bit against the same drain with every region on
    ``dev``, and the bytes that crossed between cards, by link.  With one
    card it reports that it did not run."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"regions on several cards: not run ({cards} card)")
        return dict(ran=False, cards=cards, launches={})
    devices = [torch.device("cuda", r % cards) for r in range(PP_REGIONS)]
    out = dict(ran=True, cards=cards, devices=[str(d) for d in devices], launches={})
    for name, kw in (("ppermute", dict(SMALL_KW, backend="ppermute", axis_name="data")),
                     ("xla_megastep", SMALL_KW)):
        reset_launch_counts()
        t0 = time.perf_counter()
        spread, _, hs, _ = small_drain(dev, 1, kw, PP_REGIONS, devices)
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        one, _, ho, _ = small_drain(dev, 1, kw, PP_REGIONS)
        check_sharded(spread)
        same_state(spread, one, f"{name}: regions on several cards against one card")
        check([h.progress() for h in hs] == [h.progress() for h in ho],
              f"{name}: and the same progress")
        if name == "xla_megastep":
            check(launches["copy_blocks_shards"] > 0,
                  "xla_megastep: one shard-table kernel reached the other cards' shards")
        links = {f"{s}->{d}": b for (s, d), b in sorted(spread.stats.bytes_per_link.items())}
        across = sum(b for (s, d), b in spread.stats.bytes_per_link.items()
                     if devices[s] != devices[d])
        check(across > 0, f"{name}: bytes crossed between cards")
        print(f"regions on {cards} cards ({[str(d) for d in devices]}), {name}: the drain "
              f"equals the one-card drain bit for bit; {across} bytes across cards; by link "
              f"{links}; {seconds:.3f} s [{card()}]")
        out[name] = dict(seconds=seconds, bytes_per_link=links, bytes_across_cards=across)
        out["launches"] = {k: out["launches"].get(k, 0) + v for k, v in launches.items()}
    return out


# -- phase 39: the xla backend over region shards --------------------------------------

# phase 39(a): phase 13's 4-region mesh and pool through the megastep, as phase 3
SHARD_DRAIN_CFG = dict(DRAIN_CFG, warm_dispatch=True)
# phase 39(e): the shard-table instance on PP_REGIONS shards of 16,384 slots of
# 64 KiB (a 4 GiB pool), at 1, 3, 131 and 1,024 lanes (the last timed), 32 runs
# of HUGE slots (timed), and 131 lanes on an odd bf16 slot
SHARD_KERNEL = dict(slots=16384, lanes=(1, 3, 131, 1024), runs=32, odd=(5, 7))
# the shard-table counters, and the kernels a sharded xla path must not launch
SHARD_COUNTERS = ("copy_blocks_shards", "copy_runs_shards", "zero_blocks_shards")
ONE_TENSOR_COPIES = ("copy_blocks", "copy_runs", "gather_blocks", "scatter_blocks")


def shard_phase_launches(state) -> tuple[int, int]:
    """Over the captured megasteps bound to ``state``'s shards: how many
    there are, and how many break the rule that each zero, force, copy and
    run phase present launches the shard-table instance once (from the
    launch counts their captures recorded) and nothing launches a
    one-tensor copy kernel."""
    fns = {name: getattr(leap_copy, name) for name in SHARD_COUNTERS + ONE_TENSOR_COPIES}
    checked = broken = 0
    for key, graphs_ in migrator.MEGASTEP._variants.items():
        n = key[0]  # the operands' lengths: zero at 7, force at 8, copy at 11, runs at 13
        want = dict(copy_blocks_shards=bool(n[8]) + bool(n[11]), copy_runs_shards=bool(n[13]),
                    zero_blocks_shards=bool(n[7]))
        for binding, graph in graphs_.items():
            if binding[0][0] != state.pool[0].data_ptr():
                continue
            checked += 1
            got = {name: graph.delta.get((fn, "launches"), 0) for name, fn in fns.items()}
            broken += got != dict(want, **{name: 0 for name in ONE_TENSOR_COPIES})
    return checked, broken


def device_busy(prof, wall_s: float) -> tuple[float, float]:
    """(device ms summed over a profile's kernels, their share of ``wall_s``)."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    device_ms = sum(dev_us(e) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    return device_ms, device_ms / (wall_s * 1e3)


def xla_shards_drain(dev, huge_factor: int, profiled: bool = False) -> dict:
    """Phase 39(a) and (b): phase 13's pool (4 regions on a one-card mesh,
    131,072 blocks of 64 KiB, each region's blocks leaping to the next)
    through the megastep of the xla backend with tiering on, every program
    one graph replay, under 64 writes and 64 reads a tick; with
    ``huge_factor`` HUGE, phase 4's two-tier pool.  ``profiled`` drains
    again in turns, twice with the pool one tensor and once over shards
    (the host ms a tick of each), then over shards under ``torch.profiler``
    for the device's busy share."""
    release()
    torch.cuda.reset_peak_memory_stats()
    seed = SEED + 6 + huge_factor
    kw = dict(cfg_kw=SHARD_DRAIN_CFG, n_regions=PP_REGIONS, mesh=make_region_mesh(PP_REGIONS))
    reset_launch_counts()
    prog, io = program_counts(), io_program_counts()
    drv, shadow, handles, times = drain(dev, N_BLOCKS, PP_SLOTS, BLOCK, huge_factor, seed, **kw)
    launches = launch_counts()
    io_now = io_program_counts()
    what = f"phase 39 xla drain over shards huge_factor={huge_factor}"
    check(drv.cfg.backend == "xla" and drv.cfg.dispatch_mode == "megastep", f"{what}: xla megastep")
    check_sharded(drv)
    out = check_drain(drv, shadow, handles, huge=huge_factor > 1)
    now = program_counts()
    out.update(captures=now[0] - prog[0], replays=now[1] - prog[1],
               io_captures=io_now[0] - io[0], io_replays=io_now[1] - io[1],
               jit_cache_misses=drv.stats.jit_cache_misses,
               graph_pool_gib=check_graph_memory(what))
    check(out["replays"] == drv.stats.dispatches, f"{what}: every program one graph replay")
    check(out["io_replays"] == -(-N_BLOCKS // 16384) + 2 * times["io_steps"],
          f"{what}: every application write and read one graph replay")
    checked, broken = shard_phase_launches(drv.state)
    check(checked > 0 and broken == 0,
          f"{what}: each copy phase of each of the {checked} megastep graphs launches the "
          f"shard-table instance once ({broken} do not)")
    check(all(launches[k] == 0 for k in ONE_TENSOR_COPIES),
          f"{what}: no one-tensor K1 or K2, no K6a or K6b launch")
    if huge_factor > 1:
        check(launches["copy_runs_shards"] > 0, f"{what}: the huge runs went through K2's instance")
    else:
        check(launches["copy_blocks_shards"] > 0, f"{what}: the copies went through K1's instance")
    out.update(times, launches=launches, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               tick_ms=times["tick_s"] / out["ticks"] * 1e3, megastep_graphs=checked,
               gib_per_s=N_BLOCKS * drv.pool_cfg.block_bytes / times["seconds"] / 2**30)
    del drv, shadow, handles
    busy = ""
    if profiled:
        from torch.profiler import ProfilerActivity, profile

        # what the shards cost the host: the same drain with the pool one
        # tensor, in turns (shards above, one tensor, one tensor, shards)
        turns = dict(shards=[out["tick_ms"]], one_tensor=[])
        for layout in ("one_tensor", "one_tensor", "shards"):
            release()
            d = drain(dev, N_BLOCKS, PP_SLOTS, BLOCK, huge_factor, seed,
                      **(kw if layout == "shards" else dict(kw, mesh=None)))
            check(d[0].state.sharded == (layout == "shards"), f"{what}: {layout} in turn")
            turns[layout].append(d[3]["tick_s"] / d[0].stats.ticks * 1e3)
            del d
        out["tick_ms_turns"] = turns
        release()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        again = drain(dev, N_BLOCKS, PP_SLOTS, BLOCK, huge_factor, seed, window=prof, **kw)[3]
        out["profiled_seconds"] = again["seconds"]
        out["device_ms"], out["busy"] = device_busy(prof, again["seconds"])
        out["profiled_tick_ms"] = again["tick_s"] / again["io_steps"] * 1e3
        busy = (f"busy {out['busy']:.3f} ({out['device_ms']:.2f} device ms over a profiled "
                f"drain's {out['profiled_seconds']:.3f} s), host ms a tick in turns over "
                f"shards {'; '.join(f'{x:.3f}' for x in turns['shards'])} and on one pool "
                f"tensor {'; '.join(f'{x:.3f}' for x in turns['one_tensor'])}, ")
    print(f"{what}: {out['ticks']} ticks, {out['tick_ms']:.3f} host ms a tick "
          f"({times['seconds']:.3f} s, {out['gib_per_s']:.3f} GiB/s), {busy}"
          f"{out['dirty_rejections']} rejections, {out['replays']} replays, "
          f"{out['captures']} captures, {out['jit_cache_misses']} jit misses, "
          f"{checked} megastep graphs, graph pools {out['graph_pool_gib']:.3f} GiB, peak "
          f"{out['peak_gib']:.2f} GiB; launches "
          f"{ {k: launches[k] for k in SHARD_COUNTERS + ONE_TENSOR_COPIES} } [{card()}]")
    return out


def xla_shards_card_matches_cpu(dev) -> dict:
    """Phase 39(c): a small 4-region drain over region shards under the
    megastep, batched and legacy, and under the sync scheduler (forces into
    zero-filled slots), on the card and on the CPU, blocking harvest: pools
    region by region, tables, flags and stats bit for bit, heat within
    1e-6; the card's megastep also against the same drain on one pool
    tensor, bit for bit."""
    cases = {"megastep": (dict(SMALL_KW), None), "batched": (dict(SMALL_KW, fused_dispatch=
                                                                   "batched"), None),
             "legacy": (dict(SMALL_KW, fused_dispatch="legacy", chunk_blocks=4), None),
             "megastep_sync": (dict(SMALL_KW), "sync")}
    out = {}
    for name, (kw, scheduler) in cases.items():
        reset_launch_counts()
        gpu, _, hg, _ = small_drain(dev, 1, kw, PP_REGIONS, scheduler=scheduler)
        launches = launch_counts()
        cpu, _, hc, _ = small_drain(torch.device("cpu"), 1, kw, PP_REGIONS, scheduler=scheduler)
        check_sharded(gpu)
        check_sharded(cpu)
        same_state(gpu, cpu, f"phase 39 {name}: card and CPU over shards",
                   rejections=scheduler is None)
        check(gpu.stats == cpu.stats, f"phase 39 {name}: card and CPU MigrationStats agree")
        check([h.progress() for h in hg] == [h.progress() for h in hc],
              f"phase 39 {name}: card and CPU request progress agree")
        check(launches["copy_blocks_shards"] > 0
              and all(launches[k] == 0 for k in ONE_TENSOR_COPIES),
              f"phase 39 {name}: the card's copies went through the shard table only")
        if scheduler == "sync":
            check(launches["zero_blocks_shards"] > 0, "phase 39 sync: zero phases launched")
        if name == "megastep":
            one = small_drain(dev, 1, kw, PP_REGIONS, sharded=False)[0]
            check(not one.state.sharded, "phase 39: a one-tensor drain beside it")
            same_state(gpu, one, "phase 39 megastep: over shards and on one tensor")
        out[name] = dict(ticks=gpu.stats.ticks, dispatches=gpu.stats.dispatches,
                         dirty_rejections=gpu.stats.dirty_rejections,
                         blocks_forced=gpu.stats.blocks_forced, launches=launches)
    print(f"phase 39 small xla drains over shards (megastep, batched, legacy, sync) on the card "
          f"and on the CPU agree; megastep over shards equals one tensor; "
          f"{ {k: v['launches']['copy_blocks_shards'] for k, v in out.items()} } shard-table "
          f"copy launches [{card()}]")
    return out


def shard_kernel_rows(dev) -> tuple[list[dict], dict]:
    """Phase 39(e): the shard-table instance against its plain version over
    PP_REGIONS shards, bit for bit: K1 at 1, 3, 131 and 1,024 lanes of 64
    KiB f32 and at 131 lanes of an odd bf16 slot, K2 at 32 runs of 2 MiB,
    the zero instance at 1,024 lanes; K1 at 1,024 lanes and K2 at 32 runs
    timed beside their bound, the plain version and one-tensor K1 and K2
    over the same slots of one pool tensor (no single PyTorch call copies
    between several tensors, so there is no library time)."""
    regions, slots = PP_REGIONS, SHARD_KERNEL["slots"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    host = torch.Generator().manual_seed(SEED)
    shards = [torch.randn((slots + 1,) + BLOCK, generator=g, device=dev) for _ in range(regions)]
    one = torch.cat([t[:slots] for t in shards])  # the same slots as one tensor
    slot_bytes = one[0].numel() * one.element_size()

    def plan(lanes: int, run: int = 1):
        starts = torch.randperm(regions * slots // run, generator=host)[: 2 * lanes] * run
        return starts[:lanes].to(dev), starts[lanes:].to(dev)

    def same(a, b) -> bool:
        return all(torch.equal(x[:slots], y[:slots]) for x, y in zip(a, b))

    def held(name: str, kernel, plain, pool) -> None:
        want = [t.clone() for t in pool]
        plain(want)
        for _ in range(2):  # in place: a second launch must leave the same bytes
            kernel(pool)
            torch.cuda.synchronize()
            check(same(pool, want), f"phase 39 {name}: the kernel equals its plain version")

    for lanes in SHARD_KERNEL["lanes"]:
        src, dst = plan(lanes)
        held(f"K1 over shards, {lanes} lanes",
             lambda p: leap_copy.copy_blocks_shards(p, src, dst, slots),
             lambda p: ref.copy_shards_ref(p, src, dst, slots), shards)
    odd = [torch.randn((slots + 1,) + SHARD_KERNEL["odd"], generator=g, device=dev).bfloat16()
           for _ in range(regions)]
    src, dst = plan(131)
    held("K1 over shards, an odd bf16 slot",
         lambda p: leap_copy.copy_blocks_shards(p, src, dst, slots),
         lambda p: ref.copy_shards_ref(p, src, dst, slots), odd)
    del odd
    zero = plan(1024)[1]
    held("the zero instance, 1,024 lanes",
         lambda p: leap_copy.zero_blocks_shards(p, zero, slots),
         lambda p: ref.zero_shards_ref(p, zero, slots), [t.clone() for t in shards])
    rows, zero_row = [], dict(lanes=1024, ms=time_ms(
        lambda: leap_copy.zero_blocks_shards(shards, zero, slots)),
        bound_ms=bound_ms(1024 * slot_bytes + 1024 * 8)[0])
    for name, run, lanes, tpu, one_fn in (
            ("copy_blocks_shards", 1, 1024, "src/repro/kernels/leap_copy.py:105",
             lambda s, d: leap_copy.copy_blocks(one, s, d)),
            ("copy_runs_shards", HUGE, SHARD_KERNEL["runs"], "src/repro/kernels/leap_copy.py:139",
             lambda s, d: leap_copy.copy_runs(one, s, d, HUGE))):
        src, dst = plan(lanes, run)
        if run == 1:
            kernel = lambda: leap_copy.copy_blocks_shards(shards, src, dst, slots)  # noqa: E731
        else:
            kernel = lambda: leap_copy.copy_runs_shards(shards, src, dst, slots, run)  # noqa: E731
        plain = lambda: ref.copy_shards_ref(shards, src, dst, slots, run)  # noqa: E731
        want = [t.clone() for t in shards]
        ref.copy_shards_ref(want, src, dst, slots, run)
        kernel()
        torch.cuda.synchronize()
        check(same(shards, want), f"phase 39 {name}: the kernel equals its plain version")
        err = max(float((a[:slots] - b[:slots]).abs().max()) for a, b in zip(shards, want))
        del want
        b, by = bound_ms(2 * lanes * run * slot_bytes + 2 * lanes * 8)
        # in turns: shards, one tensor, one tensor, shards
        ms = [time_ms(kernel)]
        one_ms = [time_ms(lambda: one_fn(src, dst)), time_ms(lambda: one_fn(src, dst))]
        ms.append(time_ms(kernel))
        row = dict(name=name, route="cuda", source="src/repro_torch/kernels/csrc/leap_copy.cu",
                   replaces=tpu, launches=0, max_abs_err=err, ms=statistics.median(ms),
                   ms_turns=ms, plain_ms=time_ms(plain, iters=10), bound_ms=b, bound_by=by,
                   library_ms=None, one_tensor_ms=statistics.median(one_ms),
                   one_tensor_ms_turns=one_ms,
                   shape=(f"{regions} shards [{slots + 1}, 1, 16384] fp32, {lanes} lanes x "
                          f"{run * slot_bytes} B"))
        print(f"{name}: {row['ms']:.4f} ms ({'; '.join(f'{x:.4f}' for x in ms)}; plain "
              f"{row['plain_ms']:.4f}, one tensor {'; '.join(f'{x:.4f}' for x in one_ms)}, "
              f"bound {b:.4f}; no library call over several tensors), bit-exact [{card()}]")
        rows.append(row)
    print(f"zero instance over shards, 1,024 lanes: {zero_row['ms']:.4f} ms (bound "
          f"{zero_row['bound_ms']:.4f}), bit-exact [{card()}]")
    del shards, one
    torch.cuda.empty_cache()
    return rows, zero_row


def failed_region_drain_over_shards(dev) -> dict:
    """Phase 39(d): phase 18's failed-region drain with its 4 regions on a
    one-card mesh, through the xla backend's megastep."""
    out = failed_region_drain(dev, mesh=make_region_mesh(FAILED["regions"]))
    check(out["sharded"] and all(out["launches"][k] == 0 for k in ONE_TENSOR_COPIES)
          and out["launches"]["copy_blocks_shards"] > 0,
          "phase 39 failed-region drain: over shards, through the shard table only")
    return out


def kernel_label(name: str) -> str:
    """A trace's kernel name cut to its function, with the functor that
    tells PyTorch's indexing and elementwise kernels apart."""
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    base = base.split("<")[0].split("(")[0]
    tag = re.search(r"index_put_kernel_impl|index_kernel_impl|direct_copy_kernel_cuda|"
                    r"\w*Functor\w*", name)
    return f"{base} [{tag.group(0)}]" if tag else base


def leap_cells_on_the_card(dev) -> dict:
    """Phase 39(f): the dry-run's two leap cells on the card through the
    dry-run's entry point, ``python -m repro_torch.launch.dryrun --leap``,
    in a process of its own: 16 region shards of 64 KV pages (23 GiB) on
    the one card, each step one replay, and the kernels of its profiled
    step named from its trace.  A process of its own: late in this long
    one the profiler was seen to record only some of a replay's kernels."""
    release()
    src = Path(__file__).resolve().parent / "src"
    out = {}
    # within this script's process tree the profiler once recorded no device
    # event at all in the cells' profiled step, where four runs of the same
    # command alone traced every launch (PERF.md §7 Q5): a run whose cells
    # are both OK and measured but whose trace is empty runs once more, and
    # the checks below hold the second run; any other fault fails at once
    for attempt in (1, 2):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--leap", "--force",
                 "--seed", str(SEED)], capture_output=True, text=True, timeout=900,
                env=dict(os.environ, DRYRUN_ART_DIR=tmp, PYTHONPATH=str(src)))
            wall_s = time.perf_counter() - t0
            check(proc.returncode == 0, f"phase 39 leap cells: the dry-run exits 0\n"
                                        f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
            arts = {b: json.loads((Path(tmp) / "torch" / "h100" /
                                   f"leap_migration__{b}.json").read_text())
                    for b in ("xla", "ppermute")}
        measured = all(a["status"] == "OK" and "measured" in a for a in arts.values())
        untraced = [b for b, a in arts.items()
                    if measured and not a["measured"]["kernels_by_name"]]
        if not untraced or attempt == 2:
            break
        print(f"phase 39 leap cells: the profiler recorded no device event in the profiled step "
              f"of {untraced}; the cells run once more")
    out["attempts"] = attempt
    for backend in ("xla", "ppermute"):
        art = arts[backend]
        what = f"phase 39 leap cell {backend}"
        check(art["status"] == "OK", f"{what}: {art['status']} {art.get('traceback', '')}")
        m = art["measured"]
        check(m["device"] == torch.cuda.get_device_name(0), f"{what}: measured on this card")
        labels = {kernel_label(k): v for k, v in m["kernels_by_name"].items()}
        shard_k = sum(v["launches"] for k, v in m["kernels_by_name"].items()
                      if "move_shard_lanes_kernel" in k)
        others = [k for k in labels if k in ("move_lanes_kernel", "gather_bulk_kernel")]
        check(shard_k == (1 if backend == "xla" else 0) and not others,
              f"{what}: the profiled step's trace names {shard_k} shard-table launches "
              f"and no one-tensor K1, K6a or K6b ({labels})")
        check(0 < m["device_ms"] <= m["window_ms"],
              f"{what}: device time within the profiled step")
        pool_gib = art["pool_bytes"] / 2**30
        print(f"{what}: step {m['step_ms']:.4f} ms (median of {len(m['steps_ms'])}; "
              f"{min(m['steps_ms']):.4f}-{max(m['steps_ms']):.4f}), device "
              f"{m['device_ms']:.4f} ms (busy {m['busy']:.3f}), bound {art['bound_ms']:.4f} "
              f"ms ({art['bound_by']}; 2 x {art['area_bytes']} B), step / bound "
              f"{m['step_ms'] / art['bound_ms']:.2f}, pool {pool_gib:.2f} GiB over "
              f"{art['regions']} shards, peak {m['peak_bytes'] / 2**30:.2f} GiB; the "
              f"profiled step's kernels (device ms, launches) "
              f"{ {k: (round(v['device_ms'], 4), v['launches']) for k, v in labels.items()} } "
              f"(run {attempt} of 2) [{card()}]")
        out[backend] = dict(status=art["status"], bound_ms=art["bound_ms"],
                            area_bytes=art["area_bytes"], pool_gib=pool_gib,
                            memory=art["memory"], build_s=art["build_s"],
                            first_step_s=art["first_step_s"], kernels=labels,
                            measured={k: v for k, v in m.items()
                                      if k not in ("trace", "kernels_by_name")})
    out["wall_s"] = wall_s
    return out


def xla_over_shards(dev, compiled: dict) -> tuple[dict, list[dict]]:
    """Phase 39: (a)-(f) above; returns the phase's record and its kernels
    line rows.  The 256-lane force over 4 shards against one tensor is
    phase 37's (``compiled``)."""
    res = {"drain": xla_shards_drain(dev, 1, profiled=True)}
    res["drain_huge"] = xla_shards_drain(dev, HUGE)
    release()
    res["card_matches_cpu"] = xla_shards_card_matches_cpu(dev)
    release()
    res["failed_region_drain"] = failed_region_drain_over_shards(dev)
    release()
    rows, res["zero_instance"] = shard_kernel_rows(dev)
    force = compiled["sharded_against_one_tensor"]["force_areas"]
    res["force_256_lanes_device_ms"] = {k: v["device_ms"] for k, v in force.items()}
    res["leap_cells"] = leap_cells_on_the_card(dev)
    return res, rows


# -- phase 36: the examples, and qwen2_7b through launch.serve ----------------------

EXAMPLES = ("quickstart_torch", "serve_paged_torch", "tpch_morsels_torch", "train_e2e_torch")


def example_module(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class EngineTap:
    """While active, keeps every ``PagedEngine`` built (an entry point's
    engines outlive its call until the tap is read), so that their prefill
    programs' graphs and pools can be counted after the call."""

    def __init__(self):
        self.engines: list[PagedEngine] = []
        self._init = PagedEngine.__init__

    def __enter__(self):
        def init(eng, *args, **kw):
            self._init(eng, *args, **kw)
            self.engines.append(eng)

        PagedEngine.__init__ = init
        return self

    def __exit__(self, *exc):
        PagedEngine.__init__ = self._init

    def prefill(self) -> dict:
        """The engines' prefill variants, captures, replays and pool GiB;
        then lets the engines go."""
        progs = [e._prefill for e in self.engines]
        out = dict(prefill_variants=sum(len(p) for p in progs),
                   prefill_captures=sum(p.captures for p in progs),
                   prefill_replays=sum(p.replays for p in progs),
                   prefill_pool_gib=program_pool_gib(*progs))
        self.engines.clear()
        return out


def examples_on_the_card(dev) -> dict:
    """Each torch example once, on the card, at its own defaults; each
    asserts its own result."""
    out = {}
    for name in EXAMPLES:
        release()
        reset_launch_counts()
        mod = example_module(name)
        t0 = time.perf_counter()
        with EngineTap() as engines:
            res = mod.run()
        torch.cuda.synchronize()
        rec = dict(seconds=time.perf_counter() - t0, launches=launch_counts())
        if engines.engines:
            rec.update(engines.prefill())
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
    with EngineTap() as engines:
        res = serve.main(["--arch", q["arch"], "--rebalance", "--requests", str(q["requests"]),
                          "--prompt-len", str(q["prompt_len"]), "--tokens", str(q["tokens"])])
    seconds = time.perf_counter() - t0
    prefill = engines.prefill()
    check(prefill["prefill_variants"] == prefill["prefill_captures"] == 1
          and prefill["prefill_replays"] == q["requests"] - 1,
          "qwen2_7b: one prefill graph for the one prompt length, replayed")
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
               dirty_rejections=res["stats"].dirty_rejections, **prefill)
    print(f"phase 36 qwen2_7b ({out['params']} parameters, 28 layers, bf16) through "
          f"launch.serve: decode step {out['decode_step_ms_median']:.3f} ms (median of "
          f"{len(warm)}; first {out['first_step_ms']:.1f} ms), {out['tokens_per_s']:.1f} tok/s, "
          f"peak {out['peak_gib']:.2f} GiB, prefill graph pool {prefill['prefill_pool_gib']:.3f} "
          f"GiB ({prefill['prefill_replays']} replays), {seconds:.1f} s in all [{card()}]")
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


# -- phase 40: the model's sharding over a device mesh ------------------------------


def shard_config(spec: dict):
    """``spec``'s config at full width and ``spec["layers"]`` layers (for
    recurrentgemma the first layers of its pattern, no tail; for the MoE
    stack ``spec["moe_groups"]`` routing groups)."""
    cfg = get_config(spec["config"])
    if cfg.tail_pattern:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"], tail_pattern=())
    else:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    if "moe_groups" in spec:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, groups=spec["moe_groups"]))
    return cfg


def shard_tcfg(cfg, spec: dict) -> TrainConfig:
    return TrainConfig(n_micro=spec["n_micro"], accum_dtype=cfg.grad_accum_dtype,
                       optimizer=OptimizerConfig(**SHARD_OPT, state_dtype=cfg.opt_state_dtype))


def shard_batch(cfg, spec: dict, dev) -> dict:
    """Seeded ids and labels on the card; row 0's labels at -100 past its
    first 100 tokens, so that the data-parallel groups count different
    labels (the loss is the global masked mean)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    ids = torch.randint(0, cfg.vocab_size, (2, spec["batch"], spec["seq"]), generator=gen,
                        device=dev, dtype=torch.int32)
    ids[1, 0, 100:] = -100
    return {"inputs": ids[0], "labels": ids[1]}


def placed_train_state(dev, cfg, tcfg, mesh) -> TrainState:
    """``init_train_state``'s state from seed ``SEED``, placed over ``mesh``
    without ever holding the whole moments: the model drawn on the card,
    placed, then freed; m and v zeros in each placed leaf's layout."""
    model = lm.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                           dev).requires_grad_(True)
    params = sh.place(model, mesh, sh.make_ctx(mesh))
    del model
    dt = getattr(torch, tcfg.optimizer.state_dtype)
    opt = {k: {n: x.zeros(dt) for n, x in params.leaves.items()} for k in ("m", "v")}
    opt["step"] = sh.shard(torch.zeros((), dtype=torch.int32, device=dev), (), mesh)
    return TrainState(params=params, opt=opt)


def sharded_steps(dev, cfg, spec: dict, mesh, capture: bool = True,
                  init: dict | None = None, state: TrainState | None = None,
                  seq_shard: bool = True) -> tuple:
    """``spec["steps"]`` training steps from seed ``SEED``: on one card
    (``mesh`` None, eager) or placed over ``mesh`` (graphed unless
    ``capture`` is off; ``state``, where given, already placed there),
    under ``make_ctx(mesh, seq_shard=seq_shard)``.
    Returns (state, record); the record's launches are this run's, its
    counts set to 0 just before it.  ``init``, where given, receives the
    parameters before the first step.  Over a mesh the record holds the
    bytes ``gather_region`` copied onto each position and the collectives
    run in one step, counted over the first call (the body runs once
    eagerly, and graphed once more while it is captured; a replay runs no
    Python)."""
    tcfg = shard_tcfg(cfg, spec)
    place_s = 0.0
    if state is None:
        state = init_train_state(torch.Generator(device=dev).manual_seed(SEED), cfg, tcfg, dev)
        if init is not None:
            init.update({n: p.clone() for n, p in params_of(state).items()})
        if mesh is not None:
            t0 = time.perf_counter()
            state = sh.place(state, mesh, sh.make_ctx(mesh))
            torch.cuda.synchronize()
            place_s = time.perf_counter() - t0
    ctx = sh.make_ctx(mesh, seq_shard=seq_shard) if mesh is not None else None
    batch = shard_batch(cfg, spec, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the states, this one's and any other's
    reset_launch_counts()
    before = (train_step_mod.SHARDED_STEP.captures, train_step_mod.SHARDED_STEP.replays)
    losses, step_ms, per_step = [], [], {}
    eager = mesh is not None and not capture
    body_runs = 2 if mesh is not None and capture else 1
    with (sh.use_ctx(ctx) if ctx else contextlib.nullcontext()), \
            (graphs.disable_capture() if eager else contextlib.nullcontext()):
        for i in range(spec["steps"]):
            sh.gathered_bytes.clear()
            collectives.counts.clear()
            t0 = time.perf_counter()
            # the eager sharded step must not make the host wait for the card
            with no_host_sync(dev) if eager else contextlib.nullcontext():
                metrics = train_step(state, batch, cfg, tcfg)[1]
            losses.append(float(metrics["loss"]))  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                per_step = dict(
                    gathered_bytes=[sh.gathered_bytes[p] // body_runs
                                    for p in range(mesh.size)] if mesh is not None else [0],
                    collectives={k: v // body_runs for k, v in collectives.counts.items()})
    rec = dict(config=cfg.name, layers=cfg.n_layers, batch=spec["batch"], seq=spec["seq"],
               n_micro=spec["n_micro"], losses=losses, step_ms=step_ms,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               step_peak_gib=(torch.cuda.max_memory_allocated() - held) / 2**30,
               launches=launch_counts(),
               **per_step)
    c = rec["collectives"]
    rec["all_reduces"] = c.get("all_reduce", 0) + c.get("all_reduce_grad", 0) + c.get(
        "all_reduce_max", 0)
    check(all(np.isfinite(losses)), f"{cfg.name}: finite losses")
    if mesh is not None:
        rec.update(mesh=dict(mesh.shape), graphed=capture, place_s=place_s, seq_shard=seq_shard,
                   captures=train_step_mod.SHARDED_STEP.captures - before[0],
                   replays=train_step_mod.SHARDED_STEP.replays - before[1])
    return state, rec


def losses_agree(got: list, want: list, what: str, split: bool = False,
                 later_atol: float | None = None) -> dict:
    """The sharded run's losses against the unsharded run's: step 1 within
    ``SHARD_LOSS_ATOL`` (a run whose products ``split`` over the model axis:
    ``SHARD_TP_LOSS_RTOL`` of it), later steps within
    ``SHARD_STEP_LOSS_RTOL`` of it (or ``later_atol``).  A step that
    applied no update would show the unsharded step 1's loss again (the
    batch is the same each step): its distance, the control, must lie
    beyond each later limit.  Returns both readings."""
    for i, (a, b) in enumerate(zip(got, want)):
        first = SHARD_TP_LOSS_RTOL * abs(b) if split else SHARD_LOSS_ATOL
        later = SHARD_STEP_LOSS_RTOL * abs(b) if later_atol is None else later_atol
        limit = first if i == 0 else later
        check(abs(a - b) <= limit, f"{what} step {i + 1}: loss {a} against the unsharded {b}")
        check(i == 0 or abs(want[0] - b) > limit,
              f"{what} step {i + 1}: a step without update ({want[0]}) lies beyond the limit")
    return dict(loss_diff=[a - b for a, b in zip(got, want)],
                loss_control=[want[0] - b for b in want])


def params_of(state) -> dict:
    """``{name: parameter}`` of an unplaced state."""
    return {n: p.detach() for n, p in state.params.named_parameters()}


def whole_leaf(t: torch.Tensor) -> torch.Tensor:
    return t


def leaf_sample(t: torch.Tensor) -> torch.Tensor:
    """Every element of a leaf up to 2**20 of them, else an even stride of it
    (40(f)'s states are compared by sample: two do not fit the card)."""
    flat = t.reshape(-1)
    return flat[::max(1, flat.numel() >> 20)].clone()


def sharded_matches(state, want: dict, init: dict, dev, what: str, pick=whole_leaf) -> dict:
    """Each placed parameter, gathered on the card, against ``want``'s: the
    share of elements outside ``SHARD_PARAM_TOL`` at most
    ``SHARD_PARAM_OUTSIDE`` and the update's error, ``|got - want| /
    |want - init|`` over every element, at most ``SHARD_UPDATE_ERROR``.
    The control, ``init`` (a step that applied no update), reads an error
    of 1 and must have more elements outside.  ``pick`` takes the elements
    compared from a gathered leaf (``want`` and ``init`` hold them already).
    Returns both readings."""
    n = outside = control_outside = 0
    worst = err2 = upd2 = 0.0
    for name, x in state.params.leaves.items():
        got, ref_, ini = pick(sh.gather(x, dev)).float(), want[name].float(), init[name].float()
        outside += int((~torch.isclose(got, ref_, **SHARD_PARAM_TOL)).sum())
        control_outside += int((~torch.isclose(ini, ref_, **SHARD_PARAM_TOL)).sum())
        worst = max(worst, float((got - ref_).abs().max()))
        err2 += float(torch.sum(torch.square(got - ref_), dtype=torch.float64))
        upd2 += float(torch.sum(torch.square(ref_ - ini), dtype=torch.float64))
        n += got.numel()
        del got, ref_, ini
    out = dict(param_max_abs_diff=worst, param_outside=outside / n,
               param_control_outside=control_outside / n, update_error=math.sqrt(err2 / upd2))
    check(out["param_outside"] <= SHARD_PARAM_OUTSIDE,
          f"{what}: {outside} of {n} parameters outside rtol 3e-3 / atol 3e-4")
    check(out["update_error"] <= SHARD_UPDATE_ERROR,
          f"{what}: the update's error {out['update_error']:.4g} of its size")
    check(out["param_control_outside"] > SHARD_PARAM_OUTSIDE,
          f"{what}: a step without update lies beyond the parameters' limit")
    return out


def readings(r: dict) -> str:
    """The printed readings of a sharded run against the unsharded one."""
    return (f"loss sharded - unsharded {r['loss_diff']}, without update {r['loss_control']}; "
            f"parameters outside rtol 3e-3 / atol 3e-4 {r['param_outside']:.4g} (without "
            f"update {r['param_control_outside']:.4g}), update error {r['update_error']:.4g} "
            f"(without update 1), max abs {r['param_max_abs_diff']:.4g}")


def accounted(cfg, spec: dict, mesh, state) -> dict:
    """The bytes each position holds against ``launch.dryrun.account`` of a
    train cell of ``cfg`` on the same mesh (parameters, m, v and step)."""
    from repro_torch.launch import dryrun

    args = dryrun.account(dryrun.plan_cell(cfg, "train_4k", mesh.shape["data"]),
                          mesh)["arguments"]
    want = sum(args[k] for k in ("params", "m", "v", "step"))
    got = sh.position_bytes(state)
    check(got == [want] * mesh.size, f"{cfg.name}: the bytes a position holds equal account's")
    return dict(position_bytes=got[0], account_bytes=want)


def tensor_parallel_ran(runs: dict, what: str) -> None:
    """The 4 x 2 run split its products over the model axis: all-reduces ran,
    and no position gathered as much as the 4 x 1 run's lead (which gathers
    every leaf whole); the 4 x 1 run ran none."""
    g42, g41 = max(runs["4x2"]["gathered_bytes"]), max(runs["4x1"]["gathered_bytes"])
    check(runs["4x2"]["all_reduces"] > 0 and runs["4x1"]["all_reduces"] == 0,
          f"{what}: all-reduces over the model axis on 4 x 2 only")
    check(g42 < 0.75 * g41, f"{what}: a 4 x 2 position gathers {g42:,} B a step, short of the "
          f"4 x 1 lead's {g41:,}")


def run_table(runs: dict) -> str:
    """Step ms, peak GiB, bytes gathered onto the busiest position and
    all-reduces, a step, of each run."""
    return "; ".join(
        f"{k}: step ms {[round(x, 2) for x in r['step_ms']]}, peak {r['peak_gib']:.2f} GiB, "
        f"{max(r['gathered_bytes']):,} B gathered a position, {r['all_reduces']} all-reduces"
        for k, r in runs.items())


def sharded_granite(dev, mesh, mesh41) -> dict:
    """40(a)."""
    spec = SHARD_GRANITE
    cfg = shard_config(spec)
    init = {}
    ref_state, base = sharded_steps(dev, cfg, spec, None, init=init)
    want = params_of(ref_state)
    unsharded_bytes = sum(t.numel() * t.element_size() for t in state_tensors(ref_state))
    del ref_state  # the moments go; the parameters stay for the comparison
    runs = {"unsharded": base}
    states = {}
    for mode, m, capture, seq in (("4x1", mesh41, True, True), ("4x2", mesh, True, True),
                                  ("eager", mesh, False, True), (WHOLE, mesh, True, False)):
        states[mode], runs[mode] = sharded_steps(dev, cfg, spec, m, capture, seq_shard=seq)
        r = runs[mode]
        r.update(losses_agree(r["losses"], base["losses"], f"40(a) {mode}", m is mesh),
                 **sharded_matches(states[mode], want, init, dev, f"40(a) {mode}"))
        if mode == "4x1":
            del states[mode]
            train_step_mod.SHARDED_STEP.clear()
    g, e = runs["4x2"], runs["eager"]
    check(g["captures"] == 1 and g["replays"] == spec["steps"] - 1,
          "40(a): the first sharded step eager, one capture, then replays")
    check(g["losses"] == e["losses"], "40(a): graphed losses equal eager bit for bit")
    check(all(torch.equal(a, b) for a, b in zip(state_tensors(states["4x2"]),
                                                state_tensors(states["eager"]))),
          "40(a): parameters, m, v and step graphed equal eager bit for bit")
    tensor_parallel_ran(runs, "40(a)")
    out = dict(runs=runs, unsharded_state_bytes=unsharded_bytes,
               **accounted(cfg, spec, mesh, states["4x2"]))
    out["seq_parallel"] = seq_parallel_readings(
        dev, cfg, spec, runs, states["4x2"],
        {n: sh.gather(x, dev) for n, x in states[WHOLE].params.leaves.items()}, init, "40(g)")
    print(f"phase 40(a) granite_3_2b ({cfg.n_layers} of 40 layers, batch {spec['batch']} x "
          f"{spec['seq']}, n_micro {spec['n_micro']}) tensor-parallel on a 4 x 2 mesh on one "
          f"card against 4 x 1: losses unsharded {base['losses']}, 4 x 2 graphed {g['losses']}, "
          f"eager {e['losses']}, 4 x 1 {runs['4x1']['losses']}; "
          f"{run_table({k: runs[k] for k in ('unsharded', '4x1', '4x2')})}; 4 x 2 eager step ms "
          f"{[round(x, 2) for x in e['step_ms']]}, peak {e['peak_gib']:.2f} GiB; {readings(g)}; "
          f"4 x 1: {readings(runs['4x1'])}; {out['position_bytes']:,} B a position (account "
          f"{out['account_bytes']:,}; unsharded {unsharded_bytes:,}) [{card()}]")
    train_step_mod.SHARDED_STEP.clear()
    return out


WHOLE = "4x2 whole stream"  # a 4 x 2 run under make_ctx(seq_shard=False)


def seq_probe(dev, cfg, spec: dict) -> bool:
    """Whether ``rms_norm`` of a position's rows of a group's stream, the one
    op a sequence-parallel forward runs on other shapes than the whole
    stream's (its products read the stream gathered), equals the whole
    stream's rows bit for bit on the card, at a group's microbatch of
    ``spec``'s shape."""
    rows = spec["batch"] // spec["n_micro"] // SHARD_MESH[0][0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 44)
    x = torch.randn((rows, spec["seq"], cfg.d_model), generator=gen, device=dev).mul_(8)
    x, w = x.to(cfg.dtype()), torch.randn(cfg.d_model, generator=gen, device=dev).to(cfg.pdtype())
    whole = rms_norm(x, w, cfg.norm_eps)
    parts = [rms_norm(xi, w, cfg.norm_eps) for xi in x.chunk(SHARD_MESH[0][1], dim=1)]
    return torch.equal(whole, torch.cat(parts, dim=1))


def seq_parallel_readings(dev, cfg, spec: dict, runs: dict, state, other: dict, init: dict,
                          what: str) -> dict:
    """A 4 x 2 run under sequence parallelism against the same run with the
    residual stream whole on each group's lead (``WHOLE``): step 1's loss
    bit for bit or within ``SHARD_TP_LOSS_RTOL`` (naming the op that
    differs when it is not bit for bit), step 2 and the parameters within
    the ``SHARD_*`` limits (``state``, one run's placed state, against
    ``other``, the other's parameters gathered); both runs' graphed step ms
    and the peak a step allocates over the states it finds."""
    sp, wh = runs["4x2"], runs[WHOLE]
    bitwise = sp["losses"][0] == wh["losses"][0]
    norm_equal = seq_probe(dev, cfg, spec)
    op = None if bitwise else ("rms_norm over a position's rows" if not norm_equal else
                               "not found: rms_norm over a position's rows is bit for bit")
    out = dict(step1_bitwise=bitwise, differing_op=op, rms_norm_rows_bitwise=norm_equal,
               **losses_agree(sp["losses"], wh["losses"], f"{what} against the whole stream",
                              True),
               **sharded_matches(state, other, init, dev, f"{what} against the whole stream"),
               step_ms={k: runs[k]["step_ms"] for k in ("4x2", WHOLE)},
               step_peak_gib={k: runs[k]["step_peak_gib"] for k in ("4x2", WHOLE)},
               collectives={k: runs[k]["collectives"] for k in ("4x2", WHOLE)})
    check(sp["collectives"].get("reduce_scatter", 0) > 0
          and wh["collectives"].get("reduce_scatter", 0) == 0,
          f"{what}: reduce-scatters under sequence parallelism only")
    print(f"phase {what} {cfg.name} ({cfg.n_layers} layers, batch {spec['batch']} x "
          f"{spec['seq']}) on 4 x 2, the residual stream split by sequence against whole: "
          f"losses {sp['losses']} against {wh['losses']} (step 1 "
          f"{'bit for bit' if bitwise else 'differs: ' + op}; rms_norm of a position's rows "
          f"bit for bit: {norm_equal}); graphed step ms {[round(x, 2) for x in sp['step_ms']]} "
          f"against {[round(x, 2) for x in wh['step_ms']]}, a step's peak over the states "
          f"{sp['step_peak_gib']:.3f} against {wh['step_peak_gib']:.3f} GiB "
          f"(max_memory_allocated); collectives a step "
          f"{sp['collectives']} against {wh['collectives']}; {readings(out)} [{card()}]")
    return out


def sharded_recurrent(dev, mesh, mesh41) -> dict:
    """40(b): K5 and its backward under the executor, on each position's
    channels."""
    spec = SHARD_RECUR
    cfg = shard_config(spec)
    init = {}
    ref_state, base = sharded_steps(dev, cfg, spec, None, init=init)
    want = params_of(ref_state)
    del ref_state  # the moments go; the parameters stay for the comparison
    release()
    runs, acc, seq_params = {"unsharded": base}, None, None
    for mode, m, seq in (("4x2", mesh, True), (WHOLE, mesh, False), ("4x1", mesh41, True)):
        state, r = sharded_steps(dev, cfg, spec, m, seq_shard=seq)
        runs[mode] = r
        if mode == "4x2":
            r["lru_scan_plan"] = lru_scan.lru_scan.last_plan.describe()  # of the capture
            acc = accounted(cfg, spec, mesh, state)
        r.update(losses_agree(r["losses"], base["losses"], f"40(b) {mode}", m is mesh),
                 **sharded_matches(state, want, init, dev, f"40(b) {mode}"))
        check(r["launches"]["lru_scan"] > 0 and r["launches"]["lru_scan_bwd"] > 0,
              f"40(b) {mode}: K5 and K5's backward launched under the executor")
        if mode == "4x2":  # its parameters stay for the whole-stream run's comparison
            seq_params = {n: sh.gather(x, dev) for n, x in state.params.leaves.items()}
        if mode == WHOLE:
            seq_out = seq_parallel_readings(dev, cfg, spec, runs, state, seq_params, init,
                                            "40(b) under sequence parallelism")
            seq_params = None
        del state
        train_step_mod.SHARDED_STEP.clear()
        release()
    plan, r42 = runs["4x2"]["lru_scan_plan"], runs["4x2"]
    check(plan["tiles"] * plan["channels_per_cta"] == LRU_TP_SHAPE[2],
          f"40(b): K5 ran on a position's {LRU_TP_SHAPE[2]} channels")
    tensor_parallel_ran(runs, "40(b)")
    out = dict(runs=runs, seq_parallel=seq_out, **acc)
    print(f"phase 40(b) recurrentgemma_9b ({cfg.layer_kinds}, batch {spec['batch']} x "
          f"{spec['seq']}) tensor-parallel on a 4 x 2 mesh against 4 x 1: losses unsharded "
          f"{base['losses']}, 4 x 2 {r42['losses']}, 4 x 1 {runs['4x1']['losses']}; "
          f"{run_table(runs)}; K5 {r42['launches']['lru_scan']} and K5 bwd "
          f"{r42['launches']['lru_scan_bwd']} launches on 4 x 2 ({plan['ctas']} CTAs of "
          f"{plan['channels_per_cta']} channels); {readings(r42)}; 4 x 1: "
          f"{readings(runs['4x1'])}; {out['position_bytes']:,} B a position [{card()}]")
    del want, init
    release()
    return out


def sharded_moe(dev, mesh, mesh41) -> dict:
    """40(f): qwen3_moe_235b_a22b at full width, one layer, its experts over
    the model axis on 4 x 2 against 4 x 1, the two states in turn (the
    first freed), compared by ``leaf_sample``."""
    spec = SHARD_MOE
    cfg = shard_config(spec)
    tcfg = shard_tcfg(cfg, spec)
    runs, want, init = {}, None, None
    for mode, m in (("4x1", mesh41), ("4x2", mesh)):
        t0 = time.perf_counter()
        state = placed_train_state(dev, cfg, tcfg, m)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        if init is None:
            init = {n: leaf_sample(sh.gather(x, dev)) for n, x in state.params.leaves.items()}
        state, r = sharded_steps(dev, cfg, spec, m, state=state)
        r["place_s"] = place_s
        check(r["captures"] == 1 and r["replays"] == spec["steps"] - 1,
              f"40(f) {mode}: the first step eager, one capture, then a replay")
        runs[mode] = r
        if want is None:
            want = {n: leaf_sample(sh.gather(x, dev)) for n, x in state.params.leaves.items()}
        else:
            r.update(losses_agree(r["losses"], runs["4x1"]["losses"], "40(f) 4x2", True,
                                  SHARD_MOE_LOSS_ATOL),
                     **sharded_matches(state, want, init, dev, "40(f) 4x2", pick=leaf_sample))
        del state
        train_step_mod.SHARDED_STEP.clear()
        release()
    tensor_parallel_ran(runs, "40(f)")
    print(f"phase 40(f) qwen3_moe_235b_a22b (1 of 94 layers, full width, {cfg.moe.n_experts} "
          f"experts over the model axis, batch {spec['batch']} x {spec['seq']}, n_micro "
          f"{spec['n_micro']}, moe.groups {cfg.moe.groups}): losses 4 x 1 "
          f"{runs['4x1']['losses']}, 4 x 2 {runs['4x2']['losses']}; {run_table(runs)}; "
          f"against 4 x 1 by sample: {readings(runs['4x2'])} [{card()}]")
    return dict(runs=runs, params=lm.count_params(cfg))


def cache_account(cfg, spec: dict, mesh, ctx) -> int:
    """The dry-run's per-device cache bytes of a decode cell of ``spec``'s
    batch and slots under ``ctx`` (``launch.dryrun.cache_specs``, the rule
    ``account`` applies; under ``make_ctx`` also ``account``'s own group)."""
    from repro_torch.launch import dryrun

    cell = dryrun.Cell(cfg, dataclasses.replace(SHAPES["decode_32k"], seq_len=spec["max_len"],
                                                global_batch=spec["batch"]), None)
    leaves = dryrun.meta_arguments(cell)["cache"]
    specs = dryrun.cache_specs(cell, leaves, ctx)
    got = sum(math.prod(sh.shard_shape(tuple(t.shape), specs[n], mesh)) * t.element_size()
              for n, t in leaves.items())
    if ctx.dp:  # account lays a model this size out under make_ctx
        check(dryrun.account(cell, mesh)["arguments"]["cache"] == got,
              "40(h): cache_specs is account's cache rule")
    return got


def decode_logits_diff(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs difference, L2 norm of the difference over the reference's)
    of two steps' fp32 logits."""
    d = got.float() - want
    return float(d.abs().max()), float(d.norm() / want.norm())


def rel_l2(got, want) -> float:
    """The L2 norm of ``got - want`` over ``want``'s, over every tensor of two
    outputs of one layout (``graphs.tensors``) taken together."""
    num = den = 0.0
    for g, w in zip(graphs.tensors(got), graphs.tensors(want), strict=True):
        w = w.float().to(g.device)
        num += float((g.float() - w).square().sum())
        den += float(w.square().sum())
    return math.sqrt(num / den)


def same(a, b) -> bool:
    """Two outputs of one layout bit for bit."""
    return all(torch.equal(x, y) for x, y in zip(graphs.tensors(a), graphs.tensors(b),
                                                 strict=True))


def middle_changed(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """40(j)'s control prompt: ``ids`` with each row's middle token changed."""
    out = ids.clone()
    m = ids.shape[1] // 2
    out[:, m] = (out[:, m] + 1) % vocab
    return out


def unsharded_prefill(model, cfg, prompt: torch.Tensor, max_len: int) -> dict:
    """The unsharded prefill (timed) and 40(j)'s control: the prefill of the
    prompt with its middle token changed, its logits' and its cache's rel
    L2 against the prompt's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompt, max_len)
    torch.cuda.synchronize()
    out = dict(prefill_s=time.perf_counter() - t0, logits=logits, cache=cache)
    c_logits, c_cache = model.prefill(middle_changed(prompt, cfg.vocab_size), max_len)
    out.update(control_logits_rel_l2=rel_l2(c_logits, logits),
               control_cache_rel_l2=rel_l2(c_cache, cache))
    return out


def placed_prefill(dev, placed, cfg, prompt: torch.Tensor, max_len: int, want: dict,
                   want_caches: list) -> tuple[dict, list]:
    """40(j): ``lm.prefill`` over ``placed`` under the current ctx, as a
    :data:`lm.PLACED_PREFILL` variant (cleared first): its first call runs
    eagerly and captures, its second replays; then once eagerly under
    ``graphs.disable_capture()`` and without a host sync.  The replay's
    logits and caches against the eager call's bit for bit, against the
    unsharded prefill ``want`` (the caches against ``want_caches``, its
    cache laid out by ``lm.place_group_caches``) by rel L2; seconds of each
    call, the graph pool's GiB, variants, captures and replays, and the
    launches of the two graphed calls (counts set to 0 just before them).
    Returns (the record, the replay's caches)."""
    prog = lm.PLACED_PREFILL
    prog.clear()
    before = (prog.captures, prog.replays)
    reset_launch_counts()
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = lm.prefill(placed, prompt, cfg, max_len)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = launch_counts()
    rec = dict(first_s=secs[0], graphed_s=secs[1], variants=len(prog),
               captures=prog.captures - before[0], replays=prog.replays - before[1],
               pool_gib=program_pool_gib(prog), launches=launches,
               graph_pools_gib=check_graph_memory("40(j): the graphs' pools beside the placed "
                                                  "prefill's", PLACED_PREFILL_POOL_GIB),
               logits_rel_l2=rel_l2(logits, want["logits"]),
               cache_rel_l2=rel_l2(caches, want_caches))
    with graphs.disable_capture(), no_host_sync(dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e_logits, e_caches = lm.prefill(placed, prompt, cfg, max_len)
        torch.cuda.synchronize()
    rec.update(eager_s=time.perf_counter() - t0,
               graphed_equals_eager=torch.equal(logits, e_logits) and same(caches, e_caches))
    del e_logits, e_caches
    prog.clear()
    return rec, caches


def placed_decode(dev, placed, cfg, caches: list, toks: list, p0: int, want: list,
                  eager_patch=contextlib.nullcontext, before_step=None, after_step=None,
                  sync_free: bool = True) -> dict:
    """40(h)-(j): decode steps from ``caches`` through ``lm.decode_step``
    over ``placed`` under the current ctx: graphed (one
    :data:`lm.PLACED_DECODE` variant, cleared first: the first step runs
    eagerly and captures, the later ones replay), then from a copy taken
    before them eagerly under ``graphs.disable_capture()`` (without a host
    sync where ``sync_free``; inside ``eager_patch()``, with
    ``before_step()`` and ``after_step()`` around each step, whose readings
    come back): every step's logits against ``want`` (rel L2 and max abs),
    the graphed logits and caches against the eager ones bit for bit, ms a
    step of each, variants, captures and replays, and the graphed run's
    launches (counts set to 0 just before it)."""
    spare = copy.deepcopy(caches)
    prog = lm.PLACED_DECODE
    prog.clear()
    before = (prog.captures, prog.replays)
    reset_launch_counts()
    got, ms, diffs = [], [], []
    for i, tok in enumerate(toks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = lm.decode_step(placed, caches, tok, p0 + i, cfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        got.append(logits)
        diffs.append(decode_logits_diff(logits, want[i]))
    rec = dict(max_abs=[d[0] for d in diffs], rel_l2=[d[1] for d in diffs], step_ms=ms,
               launches=launch_counts(), variants=len(prog),
               captures=prog.captures - before[0], replays=prog.replays - before[1],
               pool_gib=program_pool_gib(prog))
    eager_ms, reads, equal = [], [], True
    with graphs.disable_capture(), eager_patch():
        for i, tok in enumerate(toks):
            if before_step is not None:
                before_step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with no_host_sync(dev) if sync_free else contextlib.nullcontext():
                logits, spare = lm.decode_step(placed, spare, tok, p0 + i, cfg)
            torch.cuda.synchronize()
            eager_ms.append((time.perf_counter() - t0) * 1e3)
            equal &= torch.equal(logits, got[i])
            if after_step is not None:
                reads.append(after_step())
    rec.update(eager_step_ms=eager_ms, graphed_equals_eager=equal and same(caches, spare),
               eager_reads=reads)
    prog.clear()
    return rec


def check_placed(what: str, pre: dict, dec: dict, steps: int, tol: float) -> None:
    """40(j)'s checks of a placed prefill's record and of a decode loop's."""
    check(pre["graphed_equals_eager"], f"{what}: the placed prefill replayed equals the eager "
          "one, bit for bit")
    check((pre["variants"], pre["captures"], pre["replays"]) == (1, 1, 1),
          f"{what}: one prefill variant, captured once and replayed once "
          f"({pre['variants']}, {pre['captures']}, {pre['replays']})")
    check(pre["logits_rel_l2"] <= PLACED_PREFILL_TOL, f"{what}: prefill logits within rel L2 "
          f"{PLACED_PREFILL_TOL} of the unsharded prefill ({pre['logits_rel_l2']:.3g})")
    check(pre["cache_rel_l2"] <= PLACED_CACHE_TOL, f"{what}: prefill caches within rel L2 "
          f"{PLACED_CACHE_TOL} of the unsharded prefill's ({pre['cache_rel_l2']:.3g})")
    check(dec["graphed_equals_eager"], f"{what}: the captured decode equals the eager decode, "
          "logits and caches bit for bit")
    check((dec["variants"], dec["captures"], dec["replays"]) == (1, 1, steps - 1),
          f"{what}: one decode variant and one capture for the loop of {steps} steps "
          f"({dec['variants']}, {dec['captures']}, {dec['replays']})")
    worst = max(dec["rel_l2"])
    check(worst <= tol, f"{what}: decode logits within rel L2 {tol} of the unsharded decode "
          f"({worst:.3g})")


def check_prefill_controls(what: str, ref: dict) -> None:
    check(ref["control_logits_rel_l2"] > PLACED_PREFILL_TOL, f"{what}: the control prefill's "
          f"logits ({ref['control_logits_rel_l2']:.3g}) lie beyond the limit")
    check(ref["control_cache_rel_l2"] > PLACED_CACHE_TOL, f"{what}: the control prefill's cache "
          f"({ref['control_cache_rel_l2']:.3g}) lies beyond the limit")


def placed_text(pre: dict, dec: dict) -> str:
    return (f"prefill {pre['graphed_s']:.3f} s replayed, {pre['eager_s']:.3f} eager, "
            f"{pre['first_s']:.3f} first (eager and capture), pool {pre['pool_gib']:.2f} GiB, "
            f"logits rel L2 {pre['logits_rel_l2']:.3g}, cache {pre['cache_rel_l2']:.3g}; decode "
            f"ms a step graphed {statistics.median(dec['step_ms'][1:]):.2f} (first "
            f"{dec['step_ms'][0]:.2f}), eager {statistics.median(dec['eager_step_ms']):.2f}, "
            f"rel L2 {max(dec['rel_l2']):.3g}, {dec['captures']} capture, {dec['replays']} "
            f"replays")


def decode_run(dev, spec: dict, cfg, mesh) -> dict:
    """40(h) and 40(j)'s gemma2: the prompt prefilled (and its control) and
    decoded unsharded; then under each context the placed prefill
    (:func:`placed_prefill`, against the unsharded cache placed) and the
    placed decode from the unsharded cache placed (:func:`placed_decode`),
    with 40(h)'s control; every reading, no check."""
    b, p0, steps = spec["batch"], spec["prompt"], spec["steps"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 45)
    model = lm.init_params(gen, cfg, dev)
    ids = torch.randint(0, cfg.vocab_size, (b, p0 + steps), generator=gen, device=dev,
                        dtype=torch.int32)
    toks = [ids[:, p0 + i:p0 + i + 1] for i in range(steps)]
    ref_out = unsharded_prefill(model, cfg, ids[:, :p0], spec["max_len"])
    cache = ref_out["cache"]
    ref_cache = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    want, ms = [], []
    for i, tok in enumerate(toks):
        t0 = time.perf_counter()
        logits, ref_cache = model.decode_step(ref_cache, tok, p0 + i)
        want.append(logits.float())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    del ref_cache
    model = model.cpu()  # placed from the host: the card holds the shards alone
    release()
    out = dict(dtype=cfg.compute_dtype, prefill_s=ref_out["prefill_s"], unsharded_step_ms=ms,
               control_logits_rel_l2=ref_out["control_logits_rel_l2"],
               control_cache_rel_l2=ref_out["control_cache_rel_l2"], runs={})
    for name, make in (("4x2", sh.make_ctx), ("decode_2d", sh.make_decode_2d_ctx)):
        ctx = make(mesh)
        placed = sh.place(model, mesh, ctx, inference=True)
        with sh.use_ctx(ctx):
            caches = lm.place_group_caches(placed, cache)
            pre, _ = placed_prefill(dev, placed, cfg, ids[:, :p0], spec["max_len"], ref_out,
                                    caches)
            release()
            got_bytes = lm.cache_position_bytes(placed, caches)
            spare = copy.deepcopy(caches)
            with graphs.disable_capture(), unittest.mock.patch.object(attention, "_write_kv",
                                                                      lambda *a: None):
                control = lm.decode_step(placed, spare, toks[0], p0, cfg)[0]
            del spare
            dec = placed_decode(dev, placed, cfg, caches, toks, p0, want)
        ctrl = decode_logits_diff(control, want[0])
        out["runs"][name] = dict(
            ctx=name, positions=len(sh.tp_peers(ctx, 0)), **dec, control_max_abs=ctrl[0],
            control_rel_l2=ctrl[1], position_cache_bytes=got_bytes,
            account_cache_bytes=cache_account(cfg, spec, mesh, ctx), prefill=pre)
        del placed, caches
        release()
    del model, cache, want, ref_out
    release()
    return out


def sharded_decode(dev) -> dict:
    """40(h): gemma2_27b in f32 decoded from a cache placed over the mesh by
    the reference's rule (each position its slots of every KV head,
    combined from flash-decode partials) against the unsharded decode on
    the card.  The logits of every step lie within ``SHARD_DECODE_TOL`` of
    the unsharded step's and a control, the first step with its newest
    token's k and v not written (``attention._write_kv`` a no-op), beyond
    it.  Each position's cache bytes equal the dry-run's.  40(j): the
    placed prefill and the captured decode (:func:`check_placed`)."""
    spec = SHARD_DECODE
    mesh = make_device_mesh(*SHARD_MESH)
    cfg = dataclasses.replace(shard_config(spec), param_dtype="float32",
                              compute_dtype="float32")
    r = decode_run(dev, spec, cfg, mesh)
    r2, rd = r["runs"]["4x2"], r["runs"]["decode_2d"]
    print(f"phase 40(h) gemma2_27b ({spec['layers']} of 46 layers, win and attn, full width, "
          f"{lm.count_params(cfg):,} parameters, f32) decoded {spec['steps']} steps "
          f"from a {spec['prompt']}-token prompt of {spec['batch']} rows prefilled unsharded, "
          f"the cache of {spec['max_len']} slots (window 4096) placed by the reference's rule; "
          f"rel L2 of the logits against the unsharded decode, 4 x 2 make_ctx "
          f"{max(r2['rel_l2']):.4g} (max abs {max(r2['max_abs']):.4g}; control, newest token "
          f"unwritten, {r2['control_rel_l2']:.4g}), make_decode_2d_ctx on 8 positions "
          f"{max(rd['rel_l2']):.4g} ({max(rd['max_abs']):.4g}; control "
          f"{rd['control_rel_l2']:.4g}), limit {SHARD_DECODE_TOL}; ms a step unsharded "
          f"{statistics.median(r['unsharded_step_ms']):.2f}, 4 x 2 graphed "
          f"{statistics.median(r2['step_ms'][1:]):.2f} (eager "
          f"{statistics.median(r2['eager_step_ms']):.2f}), 8 positions graphed "
          f"{statistics.median(rd['step_ms'][1:]):.2f} (eager "
          f"{statistics.median(rd['eager_step_ms']):.2f}); prefill {r['prefill_s']:.2f} s; "
          f"cache bytes a position {r2['position_cache_bytes'][0]:,} and "
          f"{rd['position_cache_bytes'][0]:,} (dry-run {r2['account_cache_bytes']:,} and "
          f"{rd['account_cache_bytes']:,}) [{card()}]")
    print(f"phase 40(j) gemma2_27b placed prefill and captured decode, unsharded prefill "
          f"{r['prefill_s']:.3f} s (control, middle token changed: logits rel L2 "
          f"{r['control_logits_rel_l2']:.3g}, cache {r['control_cache_rel_l2']:.3g}); 4 x 2: "
          f"{placed_text(r2['prefill'], r2)}; 8 positions: {placed_text(rd['prefill'], rd)}; "
          f"limits {PLACED_PREFILL_TOL}, {PLACED_CACHE_TOL} [{card()}]")
    check_prefill_controls("40(j) gemma2", r)
    for name, run in r["runs"].items():
        check_placed(f"40(j) gemma2 {name}", run["prefill"], run, spec["steps"],
                     SHARD_DECODE_TOL)
        what = f"40(h) {name}"
        worst = max(run["rel_l2"])
        check(worst <= SHARD_DECODE_TOL, f"{what}: logits within rel L2 {SHARD_DECODE_TOL} of "
              f"the unsharded decode ({worst:.3g})")
        check(run["control_rel_l2"] > SHARD_DECODE_TOL, f"{what}: a step whose newest token "
              f"is not written ({run['control_rel_l2']:.3g}) lies beyond the limit")
        check(run["position_cache_bytes"] == [run["account_cache_bytes"]] * mesh.size,
              f"{what}: each position's cache bytes equal the dry-run's")
    return dict(config=spec["config"], layers=spec["layers"], batch=spec["batch"],
                prompt=spec["prompt"], max_len=spec["max_len"], steps=spec["steps"], **r)


def expert_bytes(placed, ctx, batch: int) -> list[int]:
    """The expert bytes each position binds in a decode step of ``batch``
    rows: its regions of the plan's expert-stationary layers."""
    plan = tensor_parallel.plan(placed, ctx, (batch, 1, placed.cfg.d_model))
    out = [0] * placed.mesh.size
    for i, st in plan.stationary.items():
        for leaf in ("e_gate", "e_in", "e_out"):
            x = placed.leaves[f"blocks.{i}.moe.{leaf}"]
            for g, lead in enumerate(sh.dp_leads(ctx)):
                for t, pos in enumerate(sh.tp_peers(ctx, lead)):
                    region = st.region(leaf, x.shape, g, t)
                    check(region == x.slices[pos], f"40(i): position {pos} binds its own {leaf}")
                    out[pos] += math.prod(sh.region_shape(region)) * x.dtype.itemsize
    return out


def expert_account(cfg, spec: dict, mesh, ctx) -> int:
    """The dry-run's per-device bytes of the expert leaves of a decode cell
    of ``spec``'s batch (``account``'s ``param_shardings(...,
    inference=True)`` under ``ctx``)."""
    from repro_torch.launch import dryrun

    cell = dryrun.plan_cell(cfg, "decode_32k", SHARD_MESH[0][0], batch=spec["batch"])
    params = dryrun.meta_arguments(cell)["params"]
    specs = sh.param_shardings(params, mesh, ctx, inference=True)
    return sum(math.prod(sh.shard_shape(tuple(t.shape), specs[n], mesh)) * t.element_size()
               for n, t in params.items() if n.rsplit(".", 1)[-1] in ("e_gate", "e_in", "e_out"))


def dropped_picks(counter: list):
    """``moe.route_slots`` that adds its dropped picks to ``counter[0]``."""
    real = moe.route_slots

    def counting(gates, mc, cap):
        slot, weight, aux = real(gates, mc, cap)
        counter[0] += int((slot == mc.n_experts * cap).sum())
        return slot, weight, aux

    return counting


def broken_expert_step(name: str):
    """40(i)'s control: the mechanism broken, as a patch: under make_ctx the
    return all-to-all's blocks rotated by one group (each group combines
    another group's rows), on 8 flat positions the last position's hidden
    block left out of the ``e_out`` sums."""
    if name == "4x2":
        real = collectives.all_to_all

        def rotated(parts, group, split_dim, cat_dim):
            out = real(parts, group, split_dim, cat_dim)
            if split_dim == 0:  # the return trade
                out = [o.to(d) for o, d in zip(out[1:] + out[:1], group.devices)]
            return out

        return unittest.mock.patch.object(collectives, "all_to_all", rotated)

    def short(parts, group, dtype):
        return collectives.all_reduce(parts[:-1], collectives.Group(group.positions[:-1],
                                                                    group.devices[:-1]), dtype)

    return unittest.mock.patch.object(moe, "_sum_partials", short)


def expert_decode(dev) -> dict:
    """40(i): qwen3_moe_235b_a22b at full width, one layer, in f32, decoded
    placed in the inference layout (the experts stationary over the data
    axis, their hidden dim over the model axis) under ``make_ctx`` on 4 x 2
    (two token all-to-alls a MoE layer a step) and ``make_decode_2d_ctx`` on
    8 positions (the experts whole, ``d_ff`` over 8), one context at a time,
    against the unsharded decode on the card: every step's logits within
    rel L2 ``SHARD_EXPERT_TOL`` and a control (:func:`broken_expert_step`)
    beyond it, the picks dropped as the unsharded decode drops them, each
    position's expert bytes equal to the dry-run's, ms a step and the peak.
    The decode is captured (:func:`placed_decode`); the all-to-alls, the
    bytes gathered and the dropped picks are read on its eager run, whose
    host counters a replay does not advance.  40(j): the placed prefill
    (:func:`placed_prefill`), whose MoE layer runs expert-stationary."""
    spec = SHARD_EXPERT
    mesh = make_device_mesh(*SHARD_MESH)
    cfg = dataclasses.replace(shard_config(spec), param_dtype="float32", compute_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch_mode="tokens"))
    b, p0, steps = spec["batch"], spec["prompt"], spec["steps"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 46)
    model = lm.init_params(gen, cfg, dev)
    ids = torch.randint(0, cfg.vocab_size, (b, p0 + steps), generator=gen, device=dev,
                        dtype=torch.int32)
    toks = [ids[:, p0 + i:p0 + i + 1] for i in range(steps)]
    ref_out = unsharded_prefill(model, cfg, ids[:, :p0], spec["max_len"])
    cache = ref_out["cache"]
    ref_cache = [{k: v.clone() for k, v in layer.items()} for layer in cache]
    want, ms, dropped = [], [], [0]
    with unittest.mock.patch.object(moe, "route_slots", dropped_picks(dropped)):
        for i, tok in enumerate(toks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, ref_cache = model.decode_step(ref_cache, tok, p0 + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            want.append(logits.float())
    del ref_cache
    out = dict(params=lm.count_params(cfg), unsharded_step_ms=ms, unsharded_dropped=dropped[0],
               prefill_s=ref_out["prefill_s"],
               control_logits_rel_l2=ref_out["control_logits_rel_l2"],
               control_cache_rel_l2=ref_out["control_cache_rel_l2"], runs={})

    def before_step():
        collectives.counts.clear()
        sh.gathered_bytes.clear()

    def after_step():
        return (collectives.counts["all_to_all"], max(sh.gathered_bytes.values(), default=0))

    for name, make in (("4x2", sh.make_ctx), ("decode_2d", sh.make_decode_2d_ctx)):
        ctx = make(mesh)
        release()
        torch.cuda.reset_peak_memory_stats(dev)
        placed = sh.place(model, mesh, ctx, inference=True)
        with sh.use_ctx(ctx):
            bound = expert_bytes(placed, ctx, b)
            caches = lm.place_group_caches(placed, cache)
            pre, _ = placed_prefill(dev, placed, cfg, ids[:, :p0], spec["max_len"], ref_out,
                                    caches)
            spare = copy.deepcopy(caches)
            with graphs.disable_capture(), broken_expert_step(name):
                control = lm.decode_step(placed, spare, toks[0], p0, cfg)[0]
            del spare
            got_dropped = [0]
            dec = placed_decode(dev, placed, cfg, caches, toks, p0, want,
                                eager_patch=lambda: unittest.mock.patch.object(
                                    moe, "route_slots", dropped_picks(got_dropped)),
                                before_step=before_step, after_step=after_step, sync_free=False)
        ctrl = decode_logits_diff(control, want[0])
        reads = dec.pop("eager_reads")
        out["runs"][name] = dict(
            ctx=name, positions=len(sh.tp_peers(ctx, 0)), **dec, control_max_abs=ctrl[0],
            control_rel_l2=ctrl[1], all_to_all_a_step=[r[0] for r in reads],
            gathered_bytes_a_step=[r[1] for r in reads],
            dropped=got_dropped[0], position_expert_bytes=bound,
            account_expert_bytes=expert_account(cfg, spec, mesh, ctx),
            placed_bytes=sum(sh.position_bytes(placed)),
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, prefill=pre)
        del placed, caches, control
        release()
    del model, cache, want, ref_out
    release()
    r2, rd = out["runs"]["4x2"], out["runs"]["decode_2d"]
    print(f"phase 40(i) qwen3_moe_235b_a22b (1 of 94 layers, full width, {out['params']:,} "
          f"parameters, f32, {cfg.moe.n_experts} experts top {cfg.moe.top_k}, moe.groups "
          f"{cfg.moe.groups}, dispatch tokens) decoded {steps} steps from a {p0}-token prompt of "
          f"{b} rows prefilled unsharded, placed with inference=True; rel L2 of the logits "
          f"against the unsharded decode, 4 x 2 make_ctx {max(r2['rel_l2']):.4g} (max abs "
          f"{max(r2['max_abs']):.4g}; control, the return all-to-all rotated by one group, "
          f"{r2['control_rel_l2']:.4g}), make_decode_2d_ctx on 8 positions "
          f"{max(rd['rel_l2']):.4g} ({max(rd['max_abs']):.4g}; control, a position's hidden "
          f"block left out, {rd['control_rel_l2']:.4g}), limit {SHARD_EXPERT_TOL}; ms a step "
          f"unsharded {statistics.median(ms):.2f}, 4 x 2 "
          f"{statistics.median(r2['step_ms'][1:]):.2f},"
          f" 8 positions {statistics.median(rd['step_ms'][1:]):.2f} (graphed; eager "
          f"{statistics.median(r2['eager_step_ms']):.2f} and "
          f"{statistics.median(rd['eager_step_ms']):.2f}); all-to-alls a step (eager run) "
          f"{r2['all_to_all_a_step']} and {rd['all_to_all_a_step']}; expert bytes a position "
          f"{r2['position_expert_bytes'][0]:,} and {rd['position_expert_bytes'][0]:,} (dry-run "
          f"{r2['account_expert_bytes']:,} and {rd['account_expert_bytes']:,}); bytes gathered a "
          f"position a step at most {max(r2['gathered_bytes_a_step']):,} and "
          f"{max(rd['gathered_bytes_a_step']):,}; picks dropped over {steps} steps unsharded "
          f"{out['unsharded_dropped']}, placed {r2['dropped']} and {rd['dropped']}; peak "
          f"{r2['peak_gib']:.2f} and {rd['peak_gib']:.2f} GiB (the unsharded model's "
          f"{out['params'] * 4 / 2**30:.2f} GiB held beside) [{card()}]")
    print(f"phase 40(j) qwen3_moe_235b_a22b placed prefill (expert-stationary) and captured "
          f"decode, unsharded prefill {out['prefill_s']:.3f} s (control, middle token changed: "
          f"logits rel L2 {out['control_logits_rel_l2']:.3g}, cache "
          f"{out['control_cache_rel_l2']:.3g}); 4 x 2: {placed_text(r2['prefill'], r2)}; 8 "
          f"positions: {placed_text(rd['prefill'], rd)} [{card()}]")
    check_prefill_controls("40(j) qwen3_moe", out)
    for name, run in out["runs"].items():
        check_placed(f"40(j) qwen3_moe {name}", run["prefill"], run, steps, SHARD_EXPERT_TOL)
        what = f"40(i) {name}"
        worst = max(run["rel_l2"])
        check(worst <= SHARD_EXPERT_TOL, f"{what}: logits within rel L2 {SHARD_EXPERT_TOL} of "
              f"the unsharded decode ({worst:.3g})")
        check(run["control_rel_l2"] > SHARD_EXPERT_TOL, f"{what}: the control step "
              f"({run['control_rel_l2']:.3g}) lies beyond the limit")
        check(run["all_to_all_a_step"] == [2 if name == "4x2" else 0] * steps,
              f"{what}: {run['all_to_all_a_step']} all-to-alls a step")
        check(run["dropped"] == out["unsharded_dropped"],
              f"{what}: the picks the unsharded decode drops")
        check(run["position_expert_bytes"] == [run["account_expert_bytes"]] * mesh.size,
              f"{what}: each position's expert bytes equal the dry-run's")
    return dict(config=spec["config"], layers=spec["layers"], batch=b, prompt=p0,
                max_len=spec["max_len"], steps=steps, **out)


def placed_recurrent(dev) -> dict:
    """40(j): recurrentgemma_9b at full width, its first 3 layers, in f32, 4
    rows: a 2,048-token prompt prefilled (and its control) and decoded
    unsharded; then under ``make_ctx`` on 4 x 2 and ``make_decode_2d_ctx``
    on 8 positions the placed prefill (:func:`placed_prefill`: K5 on each
    position's channels) and the captured decode from its caches
    (:func:`placed_decode`), with a control (the first step with its
    newest token unwritten) beyond ``PLACED_RECUR_TOL``."""
    spec = PLACED_RECUR
    mesh = make_device_mesh(*SHARD_MESH)
    cfg = dataclasses.replace(shard_config(spec), param_dtype="float32", compute_dtype="float32")
    b, p0, steps = spec["batch"], spec["prompt"], spec["steps"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 47)
    model = lm.init_params(gen, cfg, dev)
    ids = torch.randint(0, cfg.vocab_size, (b, p0 + steps), generator=gen, device=dev,
                        dtype=torch.int32)
    toks = [ids[:, p0 + i:p0 + i + 1] for i in range(steps)]
    ref_out = unsharded_prefill(model, cfg, ids[:, :p0], spec["max_len"])
    cache = [{k: v.clone() for k, v in layer.items()} for layer in ref_out["cache"]]
    want, ms = [], []
    for i, tok in enumerate(toks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, tok, p0 + i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        want.append(logits.float())
    del cache
    model = model.cpu()
    release()
    out = dict(params=lm.count_params(cfg), prefill_s=ref_out["prefill_s"],
               unsharded_step_ms=ms, control_logits_rel_l2=ref_out["control_logits_rel_l2"],
               control_cache_rel_l2=ref_out["control_cache_rel_l2"], runs={})
    for name, make in (("4x2", sh.make_ctx), ("decode_2d", sh.make_decode_2d_ctx)):
        ctx = make(mesh)
        placed = sh.place(model, mesh, ctx, inference=True)
        with sh.use_ctx(ctx):
            whole = lm.place_group_caches(placed, ref_out["cache"])
            pre, caches = placed_prefill(dev, placed, cfg, ids[:, :p0], spec["max_len"], ref_out,
                                         whole)
            pre["lru_scan_plan"] = lru_scan.lru_scan.last_plan.describe()
            del whole
            release()
            spare = copy.deepcopy(caches)
            with graphs.disable_capture(), unittest.mock.patch.object(attention, "_write_kv",
                                                                      lambda *a: None):
                control = lm.decode_step(placed, spare, toks[0], p0, cfg)[0]
            del spare
            dec = placed_decode(dev, placed, cfg, caches, toks, p0, want)
        ctrl = decode_logits_diff(control, want[0])
        out["runs"][name] = dict(ctx=name, positions=len(sh.tp_peers(ctx, 0)), **dec,
                                 control_max_abs=ctrl[0], control_rel_l2=ctrl[1], prefill=pre)
        del placed, caches, control
        release()
    del model, want, ref_out
    release()
    r2, rd = out["runs"]["4x2"], out["runs"]["decode_2d"]
    plan = r2["prefill"]["lru_scan_plan"]
    print(f"phase 40(j) recurrentgemma_9b ({spec['layers']} layers: rec, rec, win; full width, "
          f"{out['params']:,} parameters, f32) prefilled placed from a {p0}-token prompt of {b} "
          f"rows, then decoded {steps} steps captured; unsharded prefill "
          f"{out['prefill_s']:.3f} s, decode {statistics.median(ms):.2f} ms a step (control, "
          f"middle token changed: logits rel L2 {out['control_logits_rel_l2']:.3g}, cache "
          f"{out['control_cache_rel_l2']:.3g}); 4 x 2: {placed_text(r2['prefill'], r2)}, "
          f"control (newest token unwritten) {r2['control_rel_l2']:.3g}; 8 positions: "
          f"{placed_text(rd['prefill'], rd)}, control {rd['control_rel_l2']:.3g}; limit "
          f"{PLACED_RECUR_TOL}; K5 launches {r2['prefill']['launches']['lru_scan']} and "
          f"{rd['prefill']['launches']['lru_scan']} over two prefills, 4 x 2 plan "
          f"{plan['ctas']} CTAs of {plan['channels_per_cta']} channels [{card()}]")
    check_prefill_controls("40(j) recurrentgemma", out)
    for name, run in out["runs"].items():
        what = f"40(j) recurrentgemma {name}"
        check_placed(what, run["prefill"], run, steps, PLACED_RECUR_TOL)
        check(run["control_rel_l2"] > PLACED_RECUR_TOL, f"{what}: a step whose newest token "
              f"is not written ({run['control_rel_l2']:.3g}) lies beyond the limit")
        # two graphed prefills: 2 rec layers, each position's channels a group
        check(run["prefill"]["launches"]["lru_scan"] == 2 * 2 * mesh.size,
              f"{what}: K5 launched on every position's channels of both rec layers")
    return dict(config=spec["config"], layers=spec["layers"], batch=b, prompt=p0,
                max_len=spec["max_len"], steps=steps, **out)


def lru_scan_placed_row(dev, launches: int) -> dict:
    """K5 at 40(j)'s per-position prefill shape [1, 2048, 2048] (a
    data-parallel group's row, a position's channels of recurrentgemma's
    4,096 on 4 x 2) against its plain version, bit for bit and run to run,
    timed as :func:`lru_scan_tp_rows` times it; ``launches`` are 40(j)'s
    4 x 2 prefill's."""
    b, t, r = 1, PLACED_RECUR["prompt"], 4096 // SHARD_MESH[0][1]
    a, x, h0 = lru_inputs(dev, b, t, r, SEED + 41)
    got, again = lru_scan.lru_scan(a, x, h0), lru_scan.lru_scan(a, x, h0)
    plan = lru_scan.lru_scan.last_plan.describe()
    want = ref.lru_scan_ref(a, x, h0)
    torch.cuda.synchronize()
    what = f"at [{b}, {t}, {r}] f32"
    check(torch.equal(got, want) and torch.equal(got, again),
          f"lru_scan {what} == plain version and run to run, bit for bit")
    bound, by = lru_bound(a, h0)
    row = dict(name="lru_scan", route="cuda", source="src/repro_torch/kernels/csrc/lru_scan.cu",
               replaces="src/repro/kernels/lru_scan.py:56", launches=launches, phase="40j",
               library_ms=None, max_abs_err=float((got - want).abs().max()),
               ms=time_ms(lambda: lru_scan.lru_scan(a, x, h0), iters=10),
               plain_ms=time_ms(lambda: ref.lru_scan_ref(a, x, h0), iters=2, repeats=3),
               bound_ms=bound, bound_by=by,
               library="none (no single PyTorch call computes a linear recurrence)",
               shape=f"a, b, out [{b}, {t}, {r}] f32, h0 [{b}, {r}] f32 (40(j), a position's "
                     "channels in the placed prefill)", plan=plan)
    print(f"lru_scan {what}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound "
          f"{bound:.4f}, {bound / row['ms']:.0%} of it), bit-exact; plan {plan['ctas']} CTAs of "
          f"{plan['channels_per_cta']} channels on {plan['sms']} SMs, {plan['rows']} rows x "
          f"{plan['stages']} stages [{card()}]")
    del a, x, h0, got, again, want
    release()
    return row


def sharded_quantized_mean(dev, mesh) -> dict:
    """40(c): each position's gradient a block of granite's w_in [2048, 8192]
    bf16, averaged over the data axis on the card and on the CPU."""
    cfg = get_config("granite_3_2b")
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    g = torch.randn((cfg.d_model, cfg.d_ff), generator=gen, device=dev).to(cfg.pdtype())
    cpu_mesh = make_device_mesh(*SHARD_MESH, ["cpu"] * mesh.size)
    res = {}
    for where, m, t in (("card", mesh, g), ("cpu", cpu_mesh, g.cpu())):
        x = sh.shard(t, ("data", "model"), m)
        with sh.use_ctx(sh.make_ctx(m)):
            res[where] = (collectives.all_gather_int8(x, "data"),
                          collectives.quantized_mean({"g": x}, "data")["g"])
            if where == "card":
                ms = time_ms(lambda: collectives.quantized_mean({"g": x}, "data"), iters=10)
    ulps = 0
    for (qc, sc), (qh, shh) in zip(res["card"][0], res["cpu"][0]):
        check(torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), shh),
              "40(c): the int8 payload and scales on the card equal the CPU's bit for bit")
    for a, b in zip(res["card"][1].shards, res["cpu"][1].shards):
        a32, b32 = a.float().cpu().view(torch.int32), b.float().view(torch.int32)
        ulps = max(ulps, int((a32.long() - b32.long()).abs().max()))
    check(ulps <= 1, "40(c): the means within 1 ulp of the CPU's")
    print(f"phase 40(c) quantized_mean over the data axis of a [{cfg.d_model}, {cfg.d_ff}] bf16 "
          f"gradient on the 4 x 2 mesh: payload bit for bit against the CPU, means within "
          f"{ulps} ulp, {ms:.3f} ms a call [{card()}]")
    return dict(shape=[cfg.d_model, cfg.d_ff], mean_ulps=ulps, ms=ms)


def sharded_checkpoint(dev, mesh) -> dict:
    """40(d): saved under 4 x 2, restored onto 2 x 4, bit for bit, then a step."""
    spec = dict(SHARD_GRANITE, layers=SHARD_CKPT_LAYERS, steps=1)
    cfg = shard_config(spec)
    tcfg = shard_tcfg(cfg, spec)
    state = sh.place(init_train_state(torch.Generator(device=dev).manual_seed(SEED), cfg, tcfg,
                                      dev), mesh, sh.make_ctx(mesh))
    other = make_device_mesh((2, 4), SHARD_MESH[1])
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save(d, 3, state)
        save_s = time.perf_counter() - t0
        model = lm.CausalLM(cfg, device="meta")
        template = TrainState(params=model, opt=init_opt_state(model, tcfg.optimizer))
        t0 = time.perf_counter()
        host, step = ckpt.restore(d, template, device="cpu")
        ctx = sh.make_ctx(other)
        placed = sh.place(host, other, ctx)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    check(step == 3, "40(d): the step restored")
    for a, b in zip(sh.sharded_leaves(state), sh.sharded_leaves(placed)):
        check(torch.equal(sh.gather(a, dev), sh.gather(b, dev)),
              "40(d): restored onto 2 x 4 bit for bit")
    with sh.use_ctx(ctx):
        loss = float(train_step(placed, shard_batch(cfg, spec, dev), cfg, tcfg)[1]["loss"])
    check(np.isfinite(loss), "40(d): a finite step on the 2 x 4 mesh")
    n_bytes = sum(t.numel() * t.element_size() for _, t in ckpt._flatten(host))
    print(f"phase 40(d) granite_3_2b ({cfg.n_layers} layer, full width) saved under 4 x 2 in "
          f"{save_s:.2f} s, restored onto 2 x 4 in {restore_s:.2f} s ({n_bytes:,} B), bit for "
          f"bit; a step there: loss {loss:.4f} [{card()}]")
    del state, placed, host
    train_step_mod.SHARDED_STEP.clear()
    release()
    return dict(bytes=n_bytes, save_s=save_s, restore_s=restore_s, loss=loss)


def sharded_over_cards(dev) -> dict:
    """40(e): one position a card against every position on ``dev``."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"model sharding over several cards: not run ({cards} card)")
        return dict(ran=False, cards=cards)
    spec = dict(SHARD_GRANITE, steps=2)
    cfg = shard_config(spec)
    names = SHARD_MESH[1]
    spread, rs = sharded_steps(dev, cfg, spec, make_device_mesh(
        (cards, 1), names, [torch.device("cuda", c) for c in range(cards)]))
    one, ro = sharded_steps(dev, cfg, spec, make_device_mesh((cards, 1), names))
    rs.update(losses_agree(rs["losses"], ro["losses"], "40(e) several cards"))
    for a, b in zip(sh.sharded_leaves(spread), sh.sharded_leaves(one)):
        check(torch.allclose(sh.gather(a, dev).float(), sh.gather(b, dev).float(),
                             **SHARD_PARAM_TOL), "40(e): several cards against one, the state")
    print(f"phase 40(e) granite_3_2b on {cards} cards, one position each: losses {rs['losses']} "
          f"against one card's {ro['losses']}, step ms {[round(x, 2) for x in rs['step_ms']]} "
          f"[{card()}]")
    del spread, one
    train_step_mod.SHARDED_STEP.clear()
    release()
    return dict(ran=True, cards=cards, runs={"several_cards": rs, "one_card": ro})


def model_sharding(dev) -> dict:
    """Phase 40: (a)-(f) of the module docstring."""
    release()
    mesh, mesh41 = make_device_mesh(*SHARD_MESH), make_device_mesh(*SHARD_MESH_4X1)
    check(set(mesh.devices) == {dev}, "40: every position of the mesh on the card")
    out = dict(mesh=dict(mesh.shape), card=card())
    out["granite"] = sharded_granite(dev, mesh, mesh41)
    release()
    out["recurrentgemma"] = sharded_recurrent(dev, mesh, mesh41)
    out["quantized_mean"] = sharded_quantized_mean(dev, mesh)
    out["checkpoint"] = sharded_checkpoint(dev, mesh)
    out["several_cards"] = sharded_over_cards(dev)
    release()
    out["moe"] = sharded_moe(dev, mesh, mesh41)
    release()
    out["decode"] = sharded_decode(dev)
    release()
    t0 = time.perf_counter()
    out["expert_decode"] = expert_decode(dev)
    out["expert_decode"]["wall_s"] = time.perf_counter() - t0
    release()
    t0 = time.perf_counter()
    out["placed_recurrent"] = placed_recurrent(dev)
    out["placed_recurrent"]["wall_s"] = time.perf_counter() - t0
    return out


def lru_scan_tp_rows(dev) -> list[dict]:
    """K5 and its backward at 40(b)'s per-position shape (``LRU_TP_SHAPE``):
    each against its plain version, bit for bit and run to run, timed as
    phase 8 times K5 at batch 1 (median of five CUDA-event timings behind a
    sleep kernel) beside its byte bound, with the plans both launched.
    Their ``launches`` are 40(b)'s 4 x 2 run's."""
    b, t, r = LRU_TP_SHAPE
    a, x, h0 = lru_inputs(dev, b, t, r, SEED + 40)
    got, again = ops.lru_scan(a, x, h0), ops.lru_scan(a, x, h0)
    plan = lru_scan.lru_scan.last_plan.describe()
    want = ops.lru_scan(a, x, h0, impl="ref")
    gy = torch.randn(a.shape, generator=torch.Generator(device=dev).manual_seed(SEED + 40),
                     device=dev)
    bwd, bwd_again = lru_scan.lru_scan_bwd(gy, a, got, h0), lru_scan.lru_scan_bwd(gy, a, got, h0)
    bwd_want = ref.lru_scan_bwd_ref(gy, a, got, h0)
    torch.cuda.synchronize()
    what = f"at [{b}, {t}, {r}] f32"
    check(torch.equal(got, want) and torch.equal(got, again),
          f"lru_scan {what} == plain version and run to run, bit for bit")
    for name, k, z, p in zip(("da", "db", "dh0"), bwd, bwd_again, bwd_want):
        check(torch.equal(k, p) and torch.equal(k, z),
              f"lru_scan_bwd {name} {what} == plain version and run to run, bit for bit")
    bwd_plan = lru_scan.lru_scan_bwd.last_plan.describe()
    bound, by = lru_bound(a, h0)
    bbound, bby = lru_bwd_bound(a, h0)
    common = dict(route="cuda", source="src/repro_torch/kernels/csrc/lru_scan.cu",
                  replaces="src/repro/kernels/lru_scan.py:56", launches=0, phase=40,
                  library_ms=None)
    rows = [
        dict(name="lru_scan", **common, max_abs_err=float((got - want).abs().max()),
             ms=time_ms(lambda: lru_scan.lru_scan(a, x, h0), iters=10),
             plain_ms=time_ms(lambda: ref.lru_scan_ref(a, x, h0), iters=2, repeats=3),
             bound_ms=bound, bound_by=by,
             library="none (no single PyTorch call computes a linear recurrence)",
             shape=f"a, b, out [{b}, {t}, {r}] f32, h0 [{b}, {r}] f32 (40(b), a position's "
                   "channels)", plan=plan),
        dict(name="lru_scan_bwd", **common,
             max_abs_err=max(float((k - p).abs().max()) for k, p in zip(bwd, bwd_want)),
             ms=time_ms(lambda: lru_scan.lru_scan_bwd(gy, a, got, h0), iters=10),
             plain_ms=time_ms(lambda: ref.lru_scan_bwd_ref(gy, a, got, h0), iters=2, repeats=3),
             bound_ms=bbound, bound_by=bby,
             library="none (no single PyTorch call computes a linear recurrence's adjoint)",
             shape=f"g, a, h, da, db [{b}, {t}, {r}] f32, h0, dh0 [{b}, {r}] f32 (40(b))",
             plan=bwd_plan),
    ]
    for row in rows:
        print(f"{row['name']} {what}: {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f}, {row['bound_ms'] / row['ms']:.0%} of it), bit-exact "
              f"[{card()}]")
    print(f"  lru_scan plan {what}: {plan['ctas']} CTAs of {plan['channels_per_cta']} channels "
          f"on {plan['sms']} SMs, {plan['rows']} rows x {plan['stages']} stages, route "
          f"{plan['route']}; lru_scan_bwd plan: {lru_bwd_plan_text(bwd_plan)}")
    del a, x, h0, got, again, want, gy, bwd, bwd_again, bwd_want
    release()
    return rows


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
    t0 = time.perf_counter()
    compiled = compile_model_against_eager(dev, graphed["small_drain"], dry)
    wall["phase_37_compile_model_against_eager"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    several = regions_on_several_cards(dev)
    wall["phase_38_regions_on_several_cards"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards, shard_rows = xla_over_shards(dev, compiled)
    rows += shard_rows
    wall["phase_39_xla_over_shards"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharding = model_sharding(dev)
    rows += lru_scan_tp_rows(dev)
    rows.append(lru_scan_placed_row(
        dev, sharding["placed_recurrent"]["runs"]["4x2"]["prefill"]["launches"]["lru_scan"]))
    wall["phase_40_model_sharding"] = time.perf_counter() - t0
    for phase, sec in wall.items():
        print(f"{phase}: {sec:.1f} s wall")

    # each path's counts were set to 0 just before it ran and read just after
    paths = (list(drains.values()) + list(serving["runs"].values())
             + list(recurrent["runs"].values()) + list(contenders.values())
             + [tiering, failed, queries, chaos, at_scale] + list(load["runs"].values())
             + [load_cpu] + [r for m in moe_res.values() for r in m["runs"].values()]
             + [r for r in moe_cpu.values()] + list(xl["runs"].values())
             + list(training.values()) + [r for m in models.values() for r in m["runs"].values()]
             + list(examples.values()) + ([several] if several["ran"] else [])
             + [shards[k] for k in ("drain", "drain_huge", "failed_region_drain")]
             + list(shards["card_matches_cpu"].values())
             + [r for k in ("granite", "recurrentgemma", "moe", "decode", "expert_decode",
                            "placed_recurrent") for r in sharding[k]["runs"].values()]
             + [r["prefill"] for k in ("decode", "expert_decode", "placed_recurrent")
                for r in sharding[k]["runs"].values()]
             + list(sharding["several_cards"].get("runs", {}).values()))
    # a kernel with a phase-34 row (timed at that phase's shape) counts phase
    # 34's launches there and the earlier phases' in its first row
    phase34 = {row["name"] for row in rows if row.get("phase") == 34}
    for row in rows:
        if row.get("phase") == 34:
            ps = list(dry.values())
        elif row.get("phase") == 40:
            ps = [sharding["recurrentgemma"]["runs"]["4x2"]]
        elif row.get("phase") == "40j":
            ps = [sharding["placed_recurrent"]["runs"]["4x2"]["prefill"]]
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
    print(json.dumps({"compile_model_against_eager": compiled, "card": smi}))
    print(json.dumps({"regions_on_several_cards": several, "card": smi}))
    print(json.dumps({"xla_over_shards": shards, "card": smi}))
    print(json.dumps({"model_sharding": sharding, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
