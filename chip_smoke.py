#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards 4      # phases 35 (b)-41 and 39 (f), 4 cards
    python3 chip_smoke.py --cards 4 --only 40    # some of them

Phases (any failure ends the run with a non-zero exit and no result line):
  0. build: compile every kernel under src/repro_torch/kernels/csrc with
     nvcc for sm_90a, all sources at once, and beside them the first
     designs of launch/kernel_variants.py; print each K2 template's
     registers and spills (from the ptxas log) and dynamic shared memory,
     and fail if any K2 template (tensor-core or scalar) spills;
  1. kernel vs plain, at the Fig-6 proliferation shapes (65,536 and
     1,048,576 agents, on the pool of the port's own resident build): the
     column-map kernel against its plain version, entry for entry (fused
     with the pack as the main path runs it, and from the cells at three
     maxb/span settings); K1 against its plain version, force atol 1e-4,
     nnz exact (K1's exact arithmetic rounds as the plain version's does);
     kernel and plain times (CUDA events) and each kernel's lower bound on
     this card (K1's counts the listed pairs through the cheap reject and
     the pairs in reach through the exact arithmetic; the all-pairs bound
     of earlier runs is printed beside it);
  2. the engine on the card ≡ the engine on the CPU, one step at 8,192
     agents (integers exact, floats atol/rtol 1e-4);
  3. main path: ``Simulation`` with the Fig-6 configuration at 1,048,576
     live agents, ``run(check_overflow=True)`` for 10 steps; every kernel's
     launch count is reset just before and read just after: K1 and the
     column map launch once a step;
  4. births: examples/quickstart.py's configuration (128 agents, capacity
     32,768) for 60 steps must grow the population;
  5. K2 vs plain: flash attention at the qwen2-1.5b prefill shape (B 1,
     Hq 12, Hkv 2, D 128, S 4096, bf16, causal), the same heads in bf16 at
     the first and the shortest prompt lengths phase 7 serves (not
     block-aligned) and as a chunk (Sq 64 < Sk 1088), f32 S 1000 (not
     block-aligned), an f32 chunk and an f32 non-causal case, and
     seamless-m4t-large-v2's two shapes (Hq = Hkv 16, D 64, bf16: the
     encoder's non-causal S 512, the decoder's causal S 1,024) and
     phi-3-vision-4.2b's (Hq = Hkv 32, D 96 on the tensor cores: bf16
     causal at the first prompt phase 7 serves and at S 4,096; f32 causal
     S 1,000 on the scalar kernel): bf16 atol
     2e-2 and, scaled to the output, within 1e-3 + 1.6e-2·|plain| (two
     bf16 ulps) everywhere; f32 atol 2e-5; each case names the kernel it
     ran (tensor-core bf16 or scalar); the kernel, its first design
     (launch/kernel_variants.py: the tensor-core kernel at D 64, 96 and
     128 with D 96 on zero columns, and the scalar kernel before its
     redesign at D 96 and 128) and the library call
     (``F.scaled_dot_product_attention``, timed for the record only) timed
     in turns, the plain version's time and the kernel's lower bound on
     this card; at D 64 and 128 in bf16, whose kernel the redesign left as
     it was, the output must be bit-equal to the first design's (so also
     in 31 (b), 32 (b) and 38 (b), which hold K2 on a serve's inputs);
  6. the LM on the card ≡ the LM on the CPU: a 2-layer f32 qwen2-family
     model (d_model 128, vocab 1000), prefill logits and 8 greedy decode
     steps to atol/rtol 1e-4, argmax tokens equal; every kernel's launch
     count is reset just before the card's run and read just after: the
     f32 K2 (the scalar kernel) launches once per layer of the prefill;
  7. the serving path: ``launch/serve_lm.serve`` with qwen2-1.5b at full
     width and depth (28 layers, bf16, random weights from a seed), 8
     requests of 256-2048 prompt tokens, 32 new tokens each, 4 slots, s_max
     4096, 1,024 pages of 16 tokens; every kernel's launch count is reset
     just before and read just after; K2 must launch 28 times per prefill;
  8. K1 with static rows: the 'front' workload of
     benchmarks/optimizations.py grown to 1,000,000 agents (a lattice of
     spacing 5, 100 per axis, the first 5% random-walking) after two steps
     with ``detect_static``, so at least half the row blocks are wholly
     static: the column map and K1 against their plain versions on that
     query mask (map and empty lists equal, force atol 1e-4, nnz exact,
     static rows zero), K1's time beside its all-active time;
  9. the five scenarios of ``launch/simulate.py`` (the reference CLI's
     set-ups at 1,000 agents), one step on the card ≡ on the CPU after two
     on the card: integers and stats equal, floats atol/rtol 1e-4, the
     diffusion grid within 1e-5 of its largest value;
 10. the engine's main path: the forces + SIR workload of
     benchmarks/breakdown.py at 1,048,576 agents (``--config breakdown``).
     First the column map and K1 against their plain versions on the first
     step's inputs (as phase 1: map equal, force atol 1e-4, nnz exact),
     timed: the times of the kernels line. Then K1 for the forces and
     Infection in the streamed sweep over the same tables,
     ``run(check_overflow=True)`` for 10 steps; every kernel's
     launch count is reset just before and read just after (K1 and the
     column map once a step); the infected count must rise; then two
     profiled steps give device operations per step, the sweep's share and
     the idle share (launch/profile_step.py's: 1 − busy / profiled wall);
 11. the same configuration with ``force_impl="streamed"``: its sweep
     against K1's at full width (force atol 1e-4, exposed equal, force_nnz
     equal but in rows where a pair's force lies within float32 rounding
     of ``force_eps``, at most 16 and each such a row: the sweep counts a
     pair by its force vector, K1 by the force's magnitude, two float32
     forms of one threshold), and one engine
     step each (floats 1e-4, other integers and stats equal);
 12. the pair-list build kernel ≡ its plain version, entry for entry (idx,
     run_off, count, demand), on the forces + SIR step's pool at 1,048,576
     agents, max_pairs 64 at skin 0 (benchmarks/breakdown.py's) and 16
     (below the demand: overflow rows), and on that pool with its rows
     permuted and its tables kept (the kernel's global branch); kernel and
     plain times and the kernel's bound, and the kernel's first design
     (launch/kernel_variants.py, also ≡ plain) timed in turns with it;
 13. on the same inputs, the column map from the pair list ≡ its plain
     version (fused with the pack, entry for entry), and K1 on that map ≡
     K1 on the stencil map, bit for bit (force and nnz); K1's time on each
     map, the map kernel's time and bound, the map kernel timed in turns
     with its first design (launch/kernel_variants.py, also ≡);
 14. the slice's main path at full width: ``Simulation.run(
     check_overflow=True)`` for 10 steps of the forces + SIR configuration
     at 1,048,576 agents (a) with ``PairListConfig(skin=0, max_pairs=64)``
     and every-step rebuilds, first held against the streamed path after
     one step (integers and force_nnz equal, positions 1e-4), and (b) with
     ``RebuildPolicy("every_k", k=8, displacement_bound=0.75)`` and
     ``PairListConfig(skin=1.5)``, max_pairs from a probe build; every
     kernel's launch count is reset just before and read just after each
     run; (b) must skip builds; ms/step, rebuilds and skips, pair demand,
     and from four profiled steps device ops, idle share and the device
     ms of ``step/pairlist_build``, ``k1/inputs``, ``grid/sweep`` and
     ``k1/kernel``,
     printed beside phase 10's;
 15. reproducible secretion: the secretion kernel ≡ the plain CPU version
     (``index_add`` in slot order), bit for bit, with 4,000 agents in 32³
     voxels (the clustering run's shape), 65,536 agents in 8 voxels,
     1,048,576 agents in 32³ voxels and 8 lanes of 4,000 agents, two card
     runs bit-equal, timed in turns with the kernel's first design
     (launch/kernel_variants.py, also ≡ the CPU; ``index_add_`` on the
     card timed for the record, the bound the bytes of position, amount
     and the grid read and the grid written); then the clustering
     ``--pairlist`` configuration of examples/cell_clustering.py (4,000
     agents, secretion, chemotaxis, forces from a pair list under
     every_k) for 10 steps: card ≡ CPU (integers, rebuilds and skips
     equal; floats 1e-4, the grid 1e-5 of its largest value) and two card
     runs bit-equal, pools and grids; four profiled steps give the device
     ms of ``step/secretion`` and ``step/pairlist_build``;
 16. paper-scale growth through the capacity ladder: benchmarks/capacity.py's
     scenario unchanged (1,000 seeds in 512³, bf16 diameters and int16
     ints, GrowDivide + RandomWalk, no forces, capacity 1,024) stepped by
     ``CapacityLadder.step`` until 10,500,000 live agents (at most 80
     steps): the rung schedule, the restages, the bytes per agent, and per
     rung its steps, largest population, median warm ms/step (host clock
     after a synchronising read; a rung's first step, which also ran the
     rung before and the restage, counts only where it is the rung's
     only step), restage ms and peak device memory, and two more timed
     steps of the last rung's Simulation; the live prefix compact at the
     end. The same scenario to 100,000 on the
     card ≡ on the CPU: rung schedules and per-step n_live, births and
     deaths equal, the live agents equal as sets (integer and bf16
     channels as multisets, positions within 1e-4 of a partner);
 17. the reference CLI's ``--supervised`` run: ``--scenario proliferation
     --agents 65536 --checkpoint-every 50`` set up as the CLI does (its
     ``build``, then ``SupervisedRunner(CapacityLadder)``), forces in K1,
     for 55 iterations: at iteration 55, just after the second division
     wave, K1's column map needs more than its 64 column blocks (the
     reference's limit, which no rung clears), so the run stops at the last
     iteration before it. (a) the uninterrupted run — the rung schedule,
     the run report, ms/step, K1's and the column map's launches (counts
     reset just before, read just after: one per executed step, re-runs
     after a grow included), the most column blocks a row block of K1's
     map lists at each rung and at the end, 4 × 65,536 live agents; then
     one more ladder step must raise "still overflowing", and the map it
     would need is printed; (b) a child process SIGKILLed at iteration 53,
     after the checkpoint at 50, and a second child resuming through the
     CLI (``--resume --iterations 5``): its final live state equal to
     (a)'s bit for bit (a digest of the lexsorted live positions,
     diameters and types, and the count); (c) a ``Simulation`` pre-sized
     at (a)'s final rungs equal to (a) bit for bit; (d) the same set-up at
     2,048 agents for 80 steps under the ladder, card ≡ CPU: rung
     schedules (a capacity rung among them) and each step's n_live,
     births and deaths equal, diameters and birth steps equal as
     multisets; one step from the card's state before steps 20, 40, 60
     and 79 ≡ the same step on the CPU (integers exact, floats 1e-4). The
     free-running position residue is printed every 10 steps, not bound:
     K1's kernel and its plain version sum a row in different orders, and
     this over-packed cluster is chaotic (a one-ulp change of one
     coordinate grows about 3× in 5 steps), so the runs part by ~1e-3
     within 20 steps;
 18. K1 on a narrowed pool: the Fig-6 pool of phase 1 at 1,048,576 agents
     with diameters drawn in [2, 4) and stored as bf16 and as f16, types
     in {0, 1, 2} as int16: the column map and pack ≡ their plain versions
     and ≡ the pack of the same values in float32; K1 ≡ its plain version
     (force atol 1e-4, nnz exact); then tests/test_ladder.py's lean
     scenario (200 agents, 6 steps) with K1 and with the streamed sweep,
     card ≡ CPU (integers and bf16 bits equal, floats 1e-4).

 19. Fig 11 on the card: benchmarks/neighbor.py's set-up scaled to
     1,048,576 agents at its density (side 425.0, radius 4, dims 107³,
     max_per_box and max_per_run 32, query_chunk 4096, seed 3): the build
     and the force search of the resident, sorted (``neighbor_apply``),
     scatter, hash (streamed probes) and wide hash environments, each by
     CUDA events and the host clock; max_run_count and max_bucket_count
     against their caps; then at 65,536 agents (side 168.7, dims 43³: the
     O(N²) oracle cuts the size) each environment ≡ brute force (force
     atol 1e-4, nnz exact), each error printed beside
     benchmarks/neighbor.py's 2e-6;
 20. the Fig-9 'cluster' workload per environment: benchmarks/
     optimizations.py's set-up scaled to 1,048,576 agents (side 449.1,
     radius 4, dt 0.05, max_per_box 32, query_chunk 4096,
     max_displacement 0.5, seed 1, forces only) under ``CapacityLadder``
     (a bucket overflow grows a rung, printed): scatter and hash with
     sort_frequency 0 and 10, the uniform grid streamed and with K1; a
     warm-up step, then 10 timed steps (ms/step median and mean, kernel
     launches per step, peak memory) and one profiled step (device
     operations, idle share); each scatter and hash run repeated and equal
     to itself bit for bit; brute force at 65,536 agents (side 178.2) for
     3 steps, its first step ≡ the uniform grid's (1e-4, integers equal);
 21. the five CLI scenarios at 1,000 agents under scatter_grid, hash_grid
     and brute_force (sort_frequency 10 where the scenario sets none), 2
     steps, card ≡ CPU (integers and stats equal, floats 1e-4);
 22. K1 in slot order: phase 1's 1,048,576-agent Fig-6 pool shuffled;
     ``ops.collision_force`` ≡ its plain version (force 1e-4, nnz exact),
     and mapped back ≡ ``collision_force_resident`` on the grid-ordered
     pool bit for bit; the wrapper's time against the resident call's.

23. lanes ≡ solo on the card: (a) tests/test_ensemble.py's SIR
     (RandomWalk + Infection, per-lane β) in 8 lanes of 96 agents in
     capacity 192 for 20 ticks, (b) the Fig-6 scaling set-up with K1 in
     16 lanes of 4,096 agents (capacity 5,324: lanes packed at 5,376 rows)
     for 10 ticks. Every lane ≡ its solo port run on the card bit for bit,
     RNG keys included; one lane of each ≡ the CPU (integers exact, floats
     1e-4; (b) over its last tick from the card's state before it). On
     (b)'s first tick the lane-aware column map ≡ its plain version entry
     for entry (per-lane flags too) and K1 ≡ its plain version (force
     1e-4, nnz exact), timed beside their plain versions and bounds; K1
     and the column map launch once a tick for all 16 lanes (counts reset
     just before the 10 ticks, read just after); (c) (a)'s lanes with
     diameter 2.5 and forces in the streamed sweep, 10 ticks: each lane ≡
     its solo card run, integers and keys exact, floats within 1e-4, and
     whether they are bit-equal is printed (torch may sum a row's
     candidates in another order at L·C rows than at C);
 24. ensemble throughput: benchmarks/ensemble.py's set-up (side 12,
     max_per_box 4, argsort) at 64 agents a lane for 8 and 64 lanes, and
     the service CLI's (launch/sim_serve.py, 256 agents a lane) at 256
     lanes: ms per serving tick (the step and the per-lane infected count
     read back, as that benchmark times it), agent-steps/s, device ops per
     tick and idle share (launch/profile_step.py's profiler), host syncs
     per tick (``torch.cuda.set_sync_debug_mode("warn")``'s warnings),
     beside the sequential baseline (a one-lane engine serving each member
     back to back);
 25. the service CLI: ``python -m repro_torch.launch.sim_serve`` at the
     reference's defaults (8 lanes, 32 requests, 256 agents, 100 steps, β
     0.1-0.5); a run with ``--ckpt-dir --checkpoint-every 25`` SIGKILLed
     after its checkpoint at tick 125 and run again with ``--resume``:
     every simulation it retires has the uninterrupted run's steps, reason
     and final infected count, and with the checkpoint's finished uids
     they are all 32; the median µs of ``admit`` and ``retire``.

 26. tissue lanes: (a) examples/cell_clustering.py ``--pairlist`` as a
     sweep through ``EnsembleEngine``: 8 lanes of its 4,000 agents (not
     cut), each with its own seed, Secretion rate and Chemotaxis speed
     (``ScenarioParams`` rates), every_k k 8, skin 1.5, max_pairs 64, a
     32³ field per lane, K1 over the lanes' pair lists, 30 ticks with the
     last lane admitted at tick 11 (the others rebuild together on even
     ticks): the ticks with mixed rebuild flags are printed (one at
     least); every lane ≡ its solo card run bit for bit
     (pool, key, field and cache); a mixed tick and the last ≡ the same
     tick on the CPU from the card's state (integers and the cache's
     tables exact, floats 1e-4, grids 1e-5 of their largest value); the
     pair-list build once a tick with a rebuild, the pairs map, K1 and
     secretion once a tick, for every lane; one host read a tick (the
     rebuild flags); (b) 16 Fig-6 lanes of 4,096 agents with K1 and a
     skin-0 pair list every step, 10 ticks: lanes ≡ solo bit for bit,
     the build, the pairs map and K1 at 10 launches each; the lane-aware
     ``pairlist.cu`` and ``pair_cols.cu`` ≡ their plain versions entry
     for entry on the first tick's inputs, timed against their bounds
     (bytes summed over lanes) and against the solo call on one Fig-6
     pool of 65,536 agents, each also in turns with its first
     design (also ≡ plain); (c) 2 Fig-6 lanes with per-lane ``k_rep``
     (2.0, 6.0) in the streamed sweep (integers and keys exact, floats
     1e-4, bit-equality printed, as 23 (c)) and 4 lanes of the 'front'
     (16³) with ``detect_static`` and K1 (bit for bit), 5 ticks, each ≡
     its solo card run; (d) (a)'s set-up at 8 and 64 lanes beside the
     one-lane baseline, as phase 24 measures it (each tick reads the live
     count back).
 27. every environment over lanes, and the examples: (a) phase 23's SIR
     lanes (8 × 96 in capacity 192) under scatter_grid, hash_grid and
     brute_force, 20 ticks, sort_frequency 4, the last lane admitted
     after tick 3 (so lanes Morton-sort on different ticks): every lane ≡
     its solo card run bit for bit (keys and stats included), ticks 0 and
     19 ≡ the same tick on the CPU from the card's state (integers, keys,
     stats and the build's tables exact, floats 1e-4), per-lane
     box_demand printed; (b) phase 26 (c)'s 4 'front' lanes under brute
     force with ``detect_static`` and streamed forces, 5 ticks: each lane
     ≡ its solo card run (integers, keys and static flags exact, floats
     1e-4, bit-equality printed); (c) the SIR lanes crowded into side 12
     under the hash with max_per_box 1: ``EnsembleCapacityLadder`` grows
     max_per_box and ≡ an ensemble pre-sized at the final rung, bit for
     bit; (d) phase 24's set-ups under each environment, ms, device ops
     and idle share per serving tick beside phase 24's uniform grid; (e)
     the six examples of ``repro_torch.examples`` on the card at CI's
     smoke sizes (``serve_lm`` at its own), each passing its own
     assertions, with every kernel's launches over its run (counts reset
     just before, read just after; K1 and the map on the uniform-grid
     examples, secretion on the clustering runs and the pair-list
     kernels under ``--pairlist`` must launch).
 28. the distributed engine, its 4 shards stacked as lanes of the card:
     (a) benchmarks/distributed.py's weak-scaling case at 4 shards
     (524,288 agents, side 256, radius 4, diameter 3, max_per_box 32;
     local 163,904, halo 20,736, migrate 8,192, rebalance every 4) with
     ``force_impl`` streamed and K1, 10 steps, against the solo
     ``Simulation`` of the same config and seed: live counts equal, no
     flag set, positions within 1e-3 agent by agent (a no-op behavior
     carries each agent's index); ms/step (median of 10) of both, device
     ops, busy ms and idle share of 4 profiled steps; K1 and its column
     map once a step for all shards; (b) tests/test_distributed.py's SIR
     case (births, deaths, migration, rebalance) with K1 on the card ≡
     the same run on the CPU: every step's stats equal, each shard's
     integers equal, positions 1e-4; (c) its sharded diffusion with
     secretion: the grid within 1e-4 of its scale of the solo card run,
     secretion once a step for all shards; (d) tests/test_ladder.py's
     distributed ladder ≡ pre-sized bit for bit (the rungs printed),
     tests/test_pairlist.py's 4-shard case with K1: a skin-0 list's run ≡
     the stencil map's, its build and pairs map once a step, the
     max_pairs rung ≡ pre-sized bit for bit; ``epidemiology
     --distributed`` at CI's smoke size prints its OK.
 29. LM training: (a) qwen2-1.5b at full width and depth (28 layers,
     bf16 parameters, f32 moments, remat full, random weights from a
     seed) for 5 AdamW steps (lr 3e-4, warm-up 2, total 5) of 2 × 4,096
     tokens from ``batch_at`` through ``make_train_step``: every step's
     loss, grad_norm and lr finite and the loss lower at step 5 than at
     step 1; ms/step (median of steps 2-5 by CUDA events and by the host
     clock), tokens/s, peak memory, the model-FLOPs share of the bf16
     peak with its formula and with ``launch/cells.analytic_step_flops``,
     and one more step profiled (device ops, busy
     ms, idle share, device ms by range and by kind of kernel); (b) the
     reduced qwen2-1.5b in f32 with remat full, 3 steps on the card and
     on the CPU from the same weights and batches: loss, grad_norm and lr
     within rtol 1e-4 each step, and after step 1 at most 1e-3 of the
     parameters beyond 1e-6 of the CPU's, each within 2·lr (AdamW's
     first step moves an element whose |g| is near eps by up to lr on
     rounding alone); (c) K2 under autograd raises, and so does
     ``train_loss`` with ``attn_impl="k2"``; (d) ``train_lm smoke
     --steps 5`` (CI's size) prints OK, and its 60-step run SIGKILLed
     after the step-20 checkpoint and resumed ends bit for bit where the
     uninterrupted run ends (both children under
     ``torch.use_deterministic_algorithms`` with
     ``CUBLAS_WORKSPACE_CONFIG`` set: the embedding's backward
     accumulates with atomics otherwise). No kernel launches in the
     phase (counts reset before (a), read after (d)); each kernel
     entry's ``training_launches`` is that count.
 30. the MoE + MLA family: (a) deepseek-v2-lite-16b at full width and
     depth (27 layers, MLA, 64 experts top-6 + 2 shared, 15.7 B
     parameters, random bf16 weights from a seed) served through
     ``serve_lm.serve`` with phase 7's traffic: every request finishes
     with its 32 tokens, the pool leaks no page, the logits are finite,
     and no kernel launches (MLA's prefill runs the plain ``_sdpa``, as
     the reference's does; counts reset just before the serve, read just
     after: each kernel entry's ``moe_serving_launches``); prints TTFT,
     prefill and generated tokens/s, decode ms/iteration, the parameter
     count, and the peak memory of the weights' draw and of the serve;
     (d) one prefill and one decode iteration profiled (device ops, busy
     ms, idle share, device ms by range: ``full/attn``, ``full/moe``,
     ``decode/attn``, ``decode/moe`` ...); (b) the reduced deepseek-v2-lite
     and kimi-k2 in f32, prefill + 4 decode steps on the card ≡ on the
     CPU from the same weights (phase 6's 1e-4), greedy tokens equal; (c)
     top-k ties on the card in ``jax.lax.top_k``'s order (lower expert
     index first).
 31. the SSM family and the hybrid, phase 7's traffic, random bf16 weights
     from a seed: (a) mamba2-370m at full width and depth (48 SSM layers,
     d_model 1,024, state 128, 368 M parameters; no attention, so no
     kernel launches); (b) jamba-v0.1-52b at full width, 16 of its 32
     layers (two 8-layer blocks: 14 SSM layers, 2 GQA layers at Hq 32,
     Hkv 8, D 128, 8 MoE layers of 16 experts top-2; 26.0 B parameters,
     52.0 GB: the 32-layer model's 103 GB do not fit the card). Each
     served as phase 30 (a) (counts reset just before, read just after;
     every request finishes, no page leaks, finite logits; the same
     prints); K2 must launch once per attention layer per prefill (2 a
     prompt, 16 in the serve) and nothing else launch, and K2 ≡ its plain
     version (phase 5's bf16 tolerances) on the q, k, v the serve's first
     prefill gave its first attention layer, timed beside the plain
     version, SDPA and its bound; (c) the reduced mamba2 and jamba in f32
     card ≡ CPU as phase 30 (b), and on the card prefill(48) + 12 decode
     steps ≡ prefill(60) within 5e-4; (d) one profiled prefill and decode
     iteration of each full-width model (``full/ssm``, ``decode/ssm``,
     ``full/attn``, ``full/moe`` ... ranges). Every kernel entry adds
     ``mamba2_serving_launches`` and ``jamba_serving_launches``; K2's adds
     ``jamba_check``.
 32. the encoder-decoder: (a) seamless-m4t-large-v2 at full width and
     depth (24 encoder + 24 decoder layers, d_model 1,024, 16 heads of
     64, vocab 256,206 padded to 256,256; 2,034,886,656 parameters,
     random bf16 weights from a seed) served through ``serve_lm.serve``
     with phase 7's traffic and one block of 512 frames (f32 standard
     normal from the seed) a request: every request finishes, no page
     leaks, finite logits; K2 launches once per encoder and decoder
     layer per prefill (48 × 8 = 384) and nothing else launches (counts
     reset just before the serve, read just after: each kernel entry's
     ``seamless_serving_launches``); the prints of phase 30 (a) and one
     profiled prefill, decode iteration and encoder pass (``encode``,
     ``full/attn``, ``attn/k2``, ``full/xattn``, ``full/mlp``,
     ``decode/*`` ranges); (b) K2 ≡ its plain version (phase 5's bf16
     tolerances) on the q, k, v the serve's first prefill gave encoder
     layer 0 (non-causal, S 512) and decoder layer 0 (causal, the first
     prompt's length), each timed beside the plain version, SDPA and its
     bound (K2's ``seamless_check``); (c) the reduced seamless in f32
     card ≡ CPU as phase 30 (b) (frames on both); (d) three steps of
     ``launch/train.run`` at full width and depth, 1 × 1,024 tokens with
     1,024 frames (``launch/train.run``'s frames of ``seq_len``), AdamW,
     remat full: every loss finite; ms/step, tokens/s, peak memory; then one
     more step profiled (device ops, busy ms, idle share, ms by range).
 33. training the MoE, MLA, SSM and hybrid configs, as phase 29 (a) trains
     qwen2 (bf16 parameters, f32 moments, remat full, 5 AdamW steps of 2 ×
     4,096 tokens from ``batch_at`` through ``make_train_step``, timed by
     CUDA events and the host clock, then one more profiled): (a)
     mamba2-370m at full width and depth (48 SSM layers at chunk 128,
     368,363,008 parameters); (b) deepseek-v2-lite-16b at full width, depth
     cut to 4 of its 27 layers (the dense first layer and 3 MoE layers,
     2,254,983,168 parameters; 5 peak past ~72 GB), in the reference's
     2 microbatches. Each: every loss, aux and grad_norm finite and the loss
     lower after step 5 than after step 1; ms/step, tokens/s, peak memory,
     the model-FLOPs share of ``launch/cells.analytic_step_flops`` (phase
     29 prints its own formula beside it), device ops, busy ms, idle share,
     device ms by range (``full/ssm``, ``full/attn``, ``full/moe``,
     ``train/backward``, ``train/adamw``, ``train/logits_ce``) and the top
     device ops; (b) also each step's aux loss and, read after the
     profiled step, the share of expert assignments dropped at capacity
     factor 1.25 in it; (c) the reduced deepseek-v2-lite (2 microbatches),
     kimi-k2 (bf16 moments), mamba2 and jamba in f32 with remat full, 3
     steps on the card (twice, under ``torch.use_deterministic_algorithms``,
     the two bit for bit equal) ≡ on the CPU (the CPU worker of 16-18 runs
     that half) within phase 29 (b)'s bounds; (d) no kernel launches in the
     phase (counts reset before (a), read after (c); each kernel entry's
     ``family_training_launches``).
 34. the dry run held against the card, on the training cells of phases
     29 and 33 (qwen2-1.5b and mamba2-370m at 2 × 4,096 tokens,
     deepseek-v2-lite-16b at 4 of 27 layers in 2 microbatches), each built
     by ``launch/cells.build_cell`` on the host mesh at ``TRAIN_4K`` with
     the global batch cut to 2: (a) the step traced under fake tensors on
     the card's device (``roofline/analysis.trace_step``): FLOPs, bytes
     moved, predicted peak, the compute, memory and collective terms
     (the last not recorded: "-") and the bound; (b) one real step on the
     card under the same tracer, from ``torch.cuda.reset_peak_memory_stats``:
     its FLOPs must equal (a)'s, and ``torch.cuda.max_memory_allocated``
     prints beside the predicted peak with their ratio; (c) the roofline
     fraction, bound / the measured ms/step of phase 29 or 33 in this run
     (3 steps timed after a warm-up where that phase did not run), which
     must not exceed 1.05; (d) no kernel launches in the phase
     (``dryrun_check_launches``). Also prints the card's ``total_memory``
     beside ``roofline/analysis.HBM_BYTES``.
 35. the distributed engine over a torch.distributed group, one block of
     shards a rank (``launch/distributed.py``, ``core/transport.py``):
     (a) phase 28 (a)'s K1 case (524,288 agents, 4 shards) on an NCCL
     group of one rank holding all 4 shards, spawned through the
     launcher, ≡ the lanes run (``ShardAxis``) of this process byte for
     byte: the whole run's final state, every step's stats of every shard
     and every step's slab boundaries; K1 and its column map once a step
     in the rank (counted in the rank's process, reset just before its
     steps and read just after); ms/step of the rank and of the lanes
     beside phase 28 (a)'s. (b) only with ``--cards N`` (a host with N
     cards; it builds the kernels and runs nothing else): (a)'s case,
     SIR with migration and a rebalance (K1), sharded diffusion with
     secretion and every_k on a skin-0 pair list (K1), each on N ranks
     one card each ≡ the one-card lanes run of card 0 byte for byte; weak
     scaling at 131,072 agents a shard and 8 shards (1,048,576 agents) a
     card on 1, 2 and N cards: median ms/step, peak memory, idle share
     and device ms in NCCL kernels a step, for each card (3 profiled
     steps); ``epidemiology --distributed --ranks N`` prints its OK.
     Writes chiprun_out/chip_smoke_cards.json and ends in the same last
     line, with the real card count.
 36. the LM's sharded runtime (FSDP over a ``DeviceMesh``:
     ``launch/mesh.make_device_mesh``, ``models/sharding.py``,
     ``launch/train.run(job, mesh)``): phase 29's qwen2-1.5b at full width
     and depth, 3 steps of 2 × 4,096 tokens, on an NCCL group of one rank
     over a (1, 1) mesh, against the unsharded step in the same rank, both
     under deterministic algorithms: loss, grad_norm, lr and every
     parameter bit for bit, ``train.run(job, mesh)`` ≡ ``train.run(job)``
     loss for loss; ms/step (CUDA events) of both beside phase 29's, peak
     memory (``max_memory_allocated``), and the collectives of one more
     step (``CommDebugMode`` counts by op, payload, 0 wire bytes at one
     rank); no kernel launches in the rank's sharded steps (each kernel
     entry's ``fsdp_launches``). With ``--cards N``, after 35 (b): (a)
     qwen2-1.5b at full width, a global batch of 4 × 4,096, 3 steps on 1
     rank (2 microbatches), 2 and N ranks: loss and grad_norm within rtol
     2e-3 of the one rank's, params within 3·lr + 2^-8·|param|, the gaps
     printed; (b) qwen3-14b at full width and depth (40 layers, 14.77 B
     parameters, bf16, f32 moments, remat full) on N ranks, 4 × 4,096
     tokens a step (one sequence a card), 5 steps: a finite loss that
     falls, ms/step (the slowest card's median of steps 2-5), tokens/s,
     the model-FLOPs share of N cards' bf16 peak, peak memory of every
     card (under 80 GB), one more step under ``CommDebugMode`` (counts,
     payload and ring-model wire bytes a card, the collective term at
     NVLink's 450 GB/s) and one profiled (idle share and device ms in
     NCCL kernels, each card); (c) qwen2-1.5b at full width, 2 of 28
     layers, ``launch/train.run`` checkpointing at step 2 on N ranks:
     step 3 resumed on N ranks ≡ the uninterrupted run bit for bit (loss
     and every array of the step-3 checkpoint), on 2 ranks within (a)'s
     tolerances.
 37. tensor parallelism over the mesh's "model" axis (FSDP × TP:
     ``models/sharding.py``, ``launch/train.run(job, mesh)`` on a ("data",
     "model") mesh of (D, T)), only with ``--cards 4``, after 36 and
     against its runs in the same call: (a) 36 (a)'s qwen2-1.5b job (tied
     embeddings, qkv bias, 12 heads and 2 kv heads) on a (1, 2) mesh of 2
     cards: loss and grad_norm within rtol 2e-3 of 36 (a)'s one rank,
     params within 3·lr + 2^-8·|param|, the gaps and the element that
     sets the largest printed; (b) 36 (b)'s
     qwen3-14b job at full width and depth (the same init, batches and
     seed) on a (2, 2) mesh, 2 microbatches of one sequence a data rank:
     each step's loss within rtol 2e-3 of 36 (b)'s (4, 1) losses; ms/step
     (the slowest card's median of steps 2-5), tokens/s, the model-FLOPs
     share, peak memory of every card (under 80 GB), one more step under
     ``CommDebugMode`` (counts by op and by group, payload, wire bytes a
     card and the collective term, each group's too) and one profiled
     (idle share and device ms in NCCL kernels by kind, each card), each
     beside 36 (b)'s; (c) 36 (c)'s 2-layer qwen2-1.5b: a checkpoint at step
     2 on (2, 2), step 3 resumed on (2, 2) ≡ the uninterrupted (2, 2) run
     bit for bit, on (4, 1) within (a)'s bounds; (d) no kernel launches
     over (b)'s steps on any card (printed as a ``tp_launches`` JSON line,
     one entry a kernel).
 38. phi-3-vision-4.2b through K2 at head dim 96: (a) at full width and
     depth (32 layers, d_model 3,072, MHA over 32 heads of 96, random
     bf16 weights from a seed) served through ``serve_lm.serve`` with
     phase 7's traffic, text-only prompts (no patch embeddings, as the
     reference's ``LM.prefill`` takes them): every request finishes, no
     page leaks, finite logits; K2 launches once per layer per prefill
     (32 × 8 = 256) and nothing else launches (counts reset just before
     the serve, read just after: each kernel entry's
     ``phi3_serving_launches``); the prints of phase 30 (a); (b) K2 ≡ its
     plain version (phase 5's bf16 tolerances) on the q, k, v the serve's
     first prefill gave its first layer, timed beside the plain version,
     SDPA and its bound (K2's ``phi3_check``); (c) one profiled prefill
     and decode iteration (``full/attn``, ``attn/k2``, ``full/mlp``,
     ``decode/*`` ranges).
 39. tensor parallelism of the encoder-decoder and the SSM family
     (``models/encdec.py``, ``models/ssm.ssm_full`` on the rank's heads,
     ``launch/train.run(job, mesh)``'s step on a ("data", "model") mesh),
     only with ``--cards 4``, after 37 in the same call: (a)
     seamless-m4t-large-v2 at full width and depth (24 + 24 layers,
     d_model 1,024, 16 heads, d_ff 8,192, vocab 256,206, bf16, remat
     full): phase 32 (d)'s job (1 × 1,024 tokens and frames, 3 steps) on
     one device (rank 0, no mesh) against a (1, 2) mesh, and 4 × 1,024
     for 5 steps on (4, 1) against (2, 2), 2 microbatches a data rank
     there; (b) mamba2-370m at full width and depth (48 layers, 32 SSM
     heads, chunk 128): phase 33's 2 × 4,096 tokens for 3 steps on one
     device against (1, 2), 4 × 4,096 for 5 steps on (4, 1) against (2,
     2). Each pair in one spawn, the first run's params and Adam moments
     kept on its ranks and read against the second's leaf by leaf on
     rank 0 (nothing written to disk): loss and grad_norm within rtol
     2e-3; each leaf's gradient norm on the first batch within rel 2^-5;
     at most 1e-3 of each leaf's elements beyond 37 (a)'s 3·lr +
     2^-8·|param|, every element within AdamW's reach (2·Σ c_t·lr_t and a
     bf16 rounding an update); printed: the counts beyond by leaf, how
     many have first moments of opposite sign, and the worst elements
     with both runs' params, moments and normalised steps (TPF_PARAMS_SHARE
     says why not 37 (a)'s bound); (c) for each (2, 2) run beside its (4,
     1) run: ms/step (the slowest card's median of steps 2-5), tokens/s,
     the model-FLOPs share (``launch/cells.analytic_step_flops``), the
     peak memory of every card (under 80 GB; (2, 2)'s includes the (4,
     1) run's kept params and moments), one more step under
     ``CommDebugMode`` (counts by op and by group, wire bytes a card, the
     collective term; (2, 2)'s by
     group ≡ ``roofline/analysis.reckon_collectives``) and one profiled
     (idle share, NCCL device ms by kind, each card); (d) no kernel
     launches on any card over (a)-(c) (printed as a
     ``tp_families_launches`` JSON line, one entry a kernel).
 40. tensor parallelism of MLA and the expert FFN (``attention.mla_full``
     on the rank's heads, ``moe.moe_layer``'s expert FFN over "model"),
     only with ``--cards 4``, after 39 in the same call: (a)
     deepseek-v2-lite-16b at full width (MLA at rank 512, 64 experts top-6
     + 2 shared, bf16, remat full), 4 of 27 layers, 2 × 4,096 tokens in 2
     microbatches, 5 steps at lr 3e-4 after a warm-up of 100 under
     deterministic algorithms on one device (rank 0, no mesh) against a
     (1, 2) mesh, and again against (1, 4),
     each pair in one spawn and held by phase 39's checks (loss and
     grad_norm within rtol 2e-3, each leaf's step-1 gradient norm within
     rel 2^-5, at most 1e-3 of a leaf beyond 3·lr + 2^-8·|param|, every
     element within AdamW's reach); step 1's routing (the sha256 of every
     ``moe.positions`` call's expert indices) equal on every model rank of
     a run; each run's dropped share at capacity factor 1.25 printed
     beside the one device's, not gated; (b) the same job on (1, 4) at 26
     layers (the deepest under ~72 GB a card by PERF.md §6 PR 36's
     reckoning), in a spawn of its own after (a) and (c) print: every
     loss and aux finite, the loss lower after step 5 than after step 1,
     ms/step (the slowest card's median of steps 2-5), tokens/s, the
     model-FLOPs share (``launch/cells.analytic_step_flops``), the peak of
     every card (under 80 GB) beside the reckoned one, one more step under
     ``CommDebugMode`` (by group ≡ ``roofline/analysis.reckon_collectives``,
     the collective term) and one profiled (idle share, device ms by
     range ``full/attn``, ``full/moe``, ``train/backward``,
     ``train/adamw``, NCCL device ms by kind, each card); (c) the reduced
     deepseek (32 experts: the FFN dim over "model"), jamba and kimi-k2
     (8 experts: the experts over "model") in f32, 3 steps of 4 × 64 on
     one device against (1, 2): loss and grad_norm within phase 33 (c)'s
     rtol 1e-4, the params after step 1 within 1e-6 but for at most 1e-3
     of them, each within 2·lr; (d) no kernel launches on any card over
     (a)-(c) (printed as a ``tp_moe_launches`` JSON line).
 41. serving over a tensor-parallel mesh (``sharding.for_serve``, every
     layer on the rank's heads, columns or experts, K2 on the rank's
     heads), only with ``--cards 4``, after 40 in the same call; every
     pair fed the same prompts (2 × 1,024 tokens; an encoder-decoder's
     frames too) and 8 teacher-forced decode steps, the last-position
     logits of each compared, the same bytes on every rank, K2 launched
     once per attention layer in the prefill on every rank and given the
     rank's heads, and K2 ≡ its plain version on each rank's first-prefill
     q, k, v, timed beside SDPA and its bound (phase 5's check, no first
     design): (a) qwen3-14b at full width and depth, one card against (1,
     2) and against (1, 4): the greedy token the same wherever the
     one-card top-2 margin exceeds the logits' max|Δ|, and that max|Δ|
     within 2^-2 of the one card's largest |logit| (a config with
     experts: max|Δ| and mean|Δ| within twice those of its base run again
     with one bf16 ulp more on 2^-10 of its weights); (b) jamba-v0.1-52b
     at full width and all 32 layers on (1, 2) against (1, 4) by (a)'s
     checks, each serving phase 7's traffic (every request finished, the
     pool whole, the ranks' token streams equal, K2 alone launched, once
     per attention layer per prefill on every rank; peak GB a card beside
     the reckoned weights and init peak, under 80; ms a prefill and a
     decode iteration), at 16 layers one card against (1, 2), a negative
     control (the last rank's experts rolled) outside (a)'s bound, and
     ``serve_lm --model-ranks 2`` run as a command; (c)
     deepseek-v2-lite-16b (MLA decode), mamba2-370m, phi-3-vision-4.2b and
     seamless-m4t-large-v2 at full width and depth, one card against (1,
     2) by (a)'s checks; (d) in f32 the reduced config of every family,
     qwen3-14b, deepseek and jamba at full width and cut depth, one card
     against (1, 2) (deepseek and jamba also (1, 4)) within atol 1e-4 +
     rtol 1e-4·|one card| (phase 31 (c)'s). Two decode steps of (a), (b)
     and mamba2 are traced on every rank: no wait for the device within a
     step, copies no more than one card's. Prints a ``tp_serve_kernels``
     JSON line (K2's launches by rank in every run and its checks).
 39 (f). Phase 39's four pairs in f32 (ROADMAP Queue 3's open check), only
     with ``--cards 4``, after 41: 2 steps each under deterministic
     algorithms, loss and grad_norm within 37 (a)'s rtol 2e-3, step 1's
     grad_norm gap, leaf gradient norms and params printed beside 39's
     bf16 readings; no kernel launched.

The kernels line's K1 and column-map entries add their launches per tick
on phase 23 (b) (``ensemble_launches_per_tick``); the pair-list build's
and the pairs map's theirs on phase 26 (b), secretion's on 26 (a); every
entry adds its launches on phase 28's distributed runs
(``distributed_launches`` in ``distributed_steps``: K1 and the map from
(a)'s K1 run, the pair-list kernels from (d), secretion from (c)), and
its launches in phase 35 (a)'s rank (``ranks_launches`` in
``ranks_steps``).

Each phase prints its seconds. The CPU halves of phases 16-18 and 33 (c)
run in a child process (``chip_smoke.py --cpu-worker OUT``, one torch
thread, no CUDA) and phase 21's in a second (``--cpu-worker-envs OUT``),
both started before phase 0, so they overlap the card phases; the script
waits for them, and kills them on a failure.

Prints the card's name and power limit, a JSON line of per-kernel numbers,
and last ``{"ok": true, "device": {...}}``. Writes the same numbers to
chiprun_out/chip_smoke.json. Needs the repository around it (src/) and a
CUDA device; exits non-zero otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
FORCE_ATOL = 1e-4
K1_SIZES = (65_536, 1_048_576)       # agents for the kernel-vs-plain phase
MAIN_AGENTS, MAIN_STEPS = 1_048_576, 10
PARITY_AGENTS = 8192
SCENARIO_AGENTS = 1000               # phase 9, per scenario
FRONT_SIDE = 100                     # phase 8: 100³ lattice agents
CONC_RTOL = 1e-5
CLUSTER_AGENTS, CLUSTER_STEPS = 4000, 10       # phase 15
PROFILED_STEPS = 4                             # phase 14, per set-up
# phase 16: benchmarks/capacity.py's growth scenario and its smoke override
GROWTH_SIDE, GROWTH_TARGET, GROWTH_MAX_STEPS = 512.0, 10_500_000, 80
GROWTH_SMOKE_TARGET = 100_000
# phase 17: the CLI's --supervised proliferation run, its SIGKILL and the
# card ≡ CPU run. At 65,536 agents K1's column map overflows at iteration
# 55, just after the second division wave: more column blocks than maxb =
# 64 or a run longer than span = 8 blocks, the reference's own limits,
# which no ladder rung clears. The run stops at the last iteration before
# it (55 steps) and a probe shows the overflow.
PROLIF_AGENTS, PROLIF_STEPS, PROLIF_EVERY, PROLIF_KILL_AT = 65_536, 55, 50, 53
PROLIF_CPU_AGENTS, PROLIF_CPU_STEPS = 2048, 80
# (d)'s one-step card ≡ CPU checks, before these steps: the free-running
# runs part by chaos (a one-ulp change of one coordinate grows about 3× in
# 5 steps in this over-packed cluster), so positions are held from a
# shared state and the free-running residue is printed
PROLIF_RESYNC = (20, 40, 60, 79)
CPU_WORKER_TIMEOUT_S = 900
# phase 23: tests/test_ensemble.py's SIR lanes (8 of 96 agents in capacity
# 192, not a multiple of 128) and Fig-6 lanes with K1 (16 of 4,096)
ENS_SIR_LANES, ENS_SIR_AGENTS, ENS_SIR_CAP, ENS_SIR_TICKS = 8, 96, 192, 20
ENS_K1_LANES, ENS_K1_AGENTS, ENS_K1_TICKS = 16, 4096, 10
ENS_STREAMED_TICKS = 10           # (c): the SIR lanes with streamed forces
# phase 24: benchmarks/ensemble.py's set-up (SIDE 12, max_per_box 4,
# argsort) at 64 agents a lane, and the service CLI's at 256
ENS_BENCH_SIDE = 12.0
ENS_BENCH = ((8, 64, "benchmark"), (64, 64, "benchmark"), (256, 256, "cli"))
ENS_BENCH_TICKS = 50
# phase 25: the CLI checkpoints every 25 ticks; killed after the one at 125
SERVE_CKPT_EVERY, SERVE_KILL_AFTER = 25, 125
# phase 26: the clustering --pairlist set-up as a sweep (8 lanes of the
# example's 4,000 agents, the last admitted at tick 11), Fig-6 lanes with
# K1 and a skin-0 pair list (16 of 4,096), per-lane k_rep and statics
# lanes (the 'front' cut to 16³), and the sweep at 8 and 64 lanes
# (the example's lanes exhaust the 0.75 displacement bound in two ticks
# and rebuild together on even ticks, so the last lane is admitted on an
# odd one, 11, where it alone rebuilds)
TISSUE_LANES, TISSUE_TICKS, TISSUE_ADMIT_AT = 8, 30, 11
ENS_PL_LANES, ENS_PL_AGENTS, ENS_PL_TICKS = 16, 4096, 10
TISSUE_SMALL_TICKS, TISSUE_STATIC_LANES, TISSUE_FRONT_SIDE = 5, 4, 16
TISSUE_BENCH_LANES, TISSUE_BENCH_TICKS = (8, 64), 20
# phase 27: phase 23's SIR lanes under scatter, hash and brute force, the
# Morton sort every 4 iterations and the last lane admitted after tick 3
# (so lanes sort on different ticks); the hash rung's ladder run
ENV_LANES_SORT, ENV_LANES_ADMIT_AT, ENV_RUNG_TICKS = 4, 3, 10
# K2 cases: (name, B, Hq, Hkv, Sq, Sk, D, causal, dtype); the first is the
# qwen2-1.5b prefill shape and the one the kernels line reports. Sq = Sk =
# "first" or "shortest" is the length of that prompt of phase 7.
K2_CASES = (("qwen2-prefill", 1, 12, 2, 4096, 4096, 128, True, "bfloat16"),
            ("served-prompt", 1, 12, 2, "first", None, 128, True,
             "bfloat16"),
            ("served-shortest", 1, 12, 2, "shortest", None, 128, True,
             "bfloat16"),
            ("chunk-bf16", 1, 12, 2, 64, 1088, 128, True, "bfloat16"),
            ("f32-ragged", 1, 12, 2, 1000, 1000, 128, True, "float32"),
            ("chunk", 1, 12, 2, 64, 1088, 128, True, "float32"),
            ("non-causal", 1, 12, 2, 512, 512, 128, False, "float32"),
            ("seamless-encoder", 1, 16, 16, 512, 512, 64, False,
             "bfloat16"),
            ("seamless-decoder", 1, 16, 16, 1024, 1024, 64, True,
             "bfloat16"),
            ("phi3-served-prompt", 1, 32, 32, "first", None, 96, True,
             "bfloat16"),
            ("phi3-prefill", 1, 32, 32, 4096, 4096, 96, True, "bfloat16"),
            ("phi3-f32", 1, 32, 32, 1000, 1000, 96, True, "float32"))
K2_TOL = {"bfloat16": 2e-2, "float32": 2e-5}       # tests/test_kernels.py
# bf16 also elementwise |Δ| <= atol + rtol·|plain|: the kernel and its plain
# version both accumulate in f32, so they may differ by one rounding of
# the output (one bf16 ulp, at most 2^-7 relative); rtol is two ulps
K2_BF16_SCALED = (1e-3, 1.6e-2)
LM_TOL = 1e-4
SERVE = dict(arch="qwen2-1.5b", requests=8, prompt_min=256, prompt_max=2048,
             new_tokens=32, slots=4, s_max=4096, page_size=16, n_pages=1024,
             seed=0)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs (CUDA events)."""
    return _both_clocks(fn, iters, warmup)[0]


def _both_clocks(fn, iters: int, warmup: int = 1) -> tuple[float, float]:
    """(CUDA-event ms, host-clock ms) per call of ``fn``, the host clock
    over the same calls ending in a synchronise."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / iters
    return start.elapsed_time(stop) / iters, host


def k1_bound(data_t, block_cols, adhesion, adhesion_band: float
             ) -> tuple[float, str, dict]:
    """Least time this card could take for one K1 call on these inputs:
    every listed pair through the cheap reject, the pairs in reach (both
    alive, inside the exact band test) through the exact arithmetic, against
    the inputs read and the output written once. Also the all-pairs bound
    that earlier versions of this script reported (every listed pair
    through the exact arithmetic)."""
    from repro_torch.kernels import collision_force as k1
    tiles = int((block_cols >= 0).sum())
    pairs = tiles * k1.BLOCK * k1.BLOCK
    in_reach = k1.pairs_in_reach(data_t, block_cols,
                                 adhesion_band=adhesion_band)
    ops_per_pair = k1.OPS_PER_PAIR + (k1.OPS_PER_PAIR_ADHESION
                                      if adhesion is not None else 0)
    n_pad = data_t.shape[1]
    moved = (data_t.numel() * 4 + block_cols.numel() * 4 + 4 * n_pad * 4
             + (0 if adhesion is None else adhesion.numel() * 4))
    ops = pairs * k1.OPS_TEST + in_reach * ops_per_pair
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = moved / PEAK_HBM_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    all_pairs = max(pairs * ops_per_pair / PEAK_FP32_FLOPS * 1e3, t_bytes)
    return max(t_ops, t_bytes), by, {"tiles": tiles, "pairs": pairs,
                                     "pairs_in_reach": in_reach,
                                     "ops_test": k1.OPS_TEST,
                                     "ops_per_pair": ops_per_pair,
                                     "operations": ops, "bytes": moved,
                                     "bound_all_pairs_ms": all_pairs}


def column_map_bound(position, starts, data_t, cols) -> tuple[float, str,
                                                              dict]:
    """Least time for one fused column-map launch (``ops.k1_inputs``): the
    pool channels (position, diameter, type, alive, active), the box tables
    and the origin read once; data_t, the row mask, block_cols and the flag
    written once; against the kernel's per-row integer operations."""
    from repro_torch.kernels import block_cols as colmap
    c, m, n_pad = position.shape[0], starts.shape[0], data_t.shape[1]
    moved = (c * (12 + 4 + 4 + 1 + 1) + 8 * m + 12
             + data_t.numel() * 4 + n_pad + cols.numel() * 4 + 4)
    ops = n_pad * colmap.OPS_PER_ROW
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = moved / PEAK_HBM_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, {"bytes": moved, "operations": ops}


def _column_map_vs_plain(label: str, cfg, spec, pool, grid, origin, active
                         ) -> tuple[dict, tuple]:
    """The fused column map (``ops.k1_inputs``) ≡ its plain version, entry
    for entry, on a resident pool with the query mask ``active``; timed
    (CUDA events) beside its plain version and its bound. Returns the
    record and the kernel's outputs."""
    import torch
    from repro_torch.kernels import ops
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            active, grid.starts, grid.counts, origin, cfg.cell_size,
            spec.dims)
    got = ops.k1_inputs(*args)
    torch.cuda.synchronize()
    want = ops.k1_inputs_plain(*args)
    torch.cuda.synchronize()
    for gt, w, what in zip(got, want, ("data_t", "block_cols", "overflow",
                                       "row mask")):
        check(gt.dtype == w.dtype and torch.equal(gt, w),
              f"column map (fused) differs from plain in {what} ({label})")
    check(not bool(got[2]), f"column map overflow ({label})")
    ms = cuda_ms(lambda: ops.k1_inputs(*args), iters=20, warmup=3)
    plain_ms = cuda_ms(lambda: ops.k1_inputs_plain(*args), iters=2,
                       warmup=0)
    bound_ms, bound_by, work = column_map_bound(pool.position, grid.starts,
                                                got[0], got[1])
    rec = {"n_pad": got[0].shape[1], "equal": True, "max_abs_err": 0.0,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, **work}
    print(f"{label} column map: kernel (fused with the pack) {ms:.4f} ms, "
          f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"block_cols, flag, data_t and row mask equal", flush=True)
    return rec, got


def _k1_vs_plain(label: str, data_t, cols, cfg) -> dict:
    """K1 ≡ its plain version on the card (force atol FORCE_ATOL, nnz
    exact, finite), timed beside its plain version and its bound."""
    import torch
    from repro_torch.kernels import collision_force as k1
    kw = dict(k_rep=cfg.force.k_rep, adhesion=None,
              adhesion_band=cfg.force.adhesion_band)
    check(cfg.adhesion is None, "the K1 phases run without adhesion")
    out = k1.collision_force(data_t, cols, **kw)
    torch.cuda.synchronize()
    plain = k1.collision_force_plain(data_t, cols, **kw)
    torch.cuda.synchronize()
    err = float((out[:3] - plain[:3]).abs().max())
    nnz_rows = int((out[3] != plain[3]).sum())
    check(err <= FORCE_ATOL, f"K1 force differs from plain by {err} "
                             f"({label})")
    check(nnz_rows == 0, f"K1 nnz differs from plain in {nnz_rows} rows "
                         f"({label})")
    check(bool(torch.isfinite(out).all()), f"K1 output not finite ({label})")
    ms = cuda_ms(lambda: k1.collision_force(data_t, cols, **kw), iters=20,
                 warmup=3)
    plain_ms = cuda_ms(lambda: k1.collision_force_plain(data_t, cols, **kw),
                       iters=2, warmup=0)
    bound_ms, bound_by, work = k1_bound(data_t, cols, None,
                                        cfg.force.adhesion_band)
    listed = (cols >= 0).sum(1)
    rec = {"n_pad": data_t.shape[1], "max_abs_err": err, "nnz_equal": True,
           "nnz_counted": int(plain[3].sum()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "cols_per_row_block_mean": float(listed[listed > 0].float().mean())
           if bool((listed > 0).any()) else 0.0,
           "cols_per_row_block_max": int(listed.max()),
           "active_row_blocks": int((listed > 0).sum()),
           "row_blocks": int(cols.shape[0]), **work}
    print(f"{label} K1: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; all pairs "
          f"{work['bound_all_pairs_ms']:.4f} ms); max|Δf| {err:.3g}, nnz "
          f"equal ({rec['nnz_counted']} pairs counted); column blocks per "
          f"active row block {rec['cols_per_row_block_mean']:.2f} (max "
          f"{rec['cols_per_row_block_max']}), {rec['tiles']} tiles, "
          f"{rec['pairs']} listed pairs, pairs_in_reach "
          f"{work['pairs_in_reach']}", flush=True)
    return rec


def phase_kernel_vs_plain(n: int, report: dict) -> tuple[dict, dict]:
    import torch
    from repro_torch.core import engine as eng, morton
    from repro_torch.kernels import ops
    from repro_torch.launch import simulate

    sim, st = simulate.build("proliferation", n, "fig6", device="cuda")
    cfg, spec = sim.config, sim.spec
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32, device="cuda")
    res = eng.build_env(cfg, spec, st.pool, origin, cfg.cell_size)
    pool, g = res.pool, res.grid
    label = f"[1] {n} agents:"
    cm_rec, (data_t, cols, _, mask) = _column_map_vs_plain(
        label, cfg, spec, pool, g, origin, pool.alive)
    # the column map from the cells, at three maxb/span settings
    cells = morton.cell_of(torch.nn.functional.pad(
        pool.position, (0, 0, 0, data_t.shape[1] - pool.position.shape[0])),
        origin, cfg.cell_size, spec.dims)
    for maxb, span in ((64, 8), (8, 8), (64, 1)):
        kc, ko = ops.build_block_cols(cells, g.starts, g.counts, mask,
                                      spec.dims, maxb, span)
        pc, po = ops.build_block_cols_plain(cells, g.starts, g.counts, mask,
                                            spec.dims, maxb, span)
        check(torch.equal(kc, pc) and bool(ko) == bool(po),
              f"column map differs from plain at {n} agents, maxb {maxb}, "
              f"span {span}")
    print(f"{label} column map from the cells equal at maxb/span 64/8, "
          f"8/8, 64/1", flush=True)
    cm_rec["agents"] = n
    report.setdefault("column_map_vs_plain", []).append(cm_rec)
    rec = {"agents": n, "capacity": cfg.capacity, "dims": list(spec.dims),
           **_k1_vs_plain(label, data_t, cols, cfg)}
    report.setdefault("k1_vs_plain", []).append(rec)
    return rec, cm_rec


def _card_vs_cpu(want: dict, got: dict, what: str) -> dict:
    """Integers and stats equal, floats atol/rtol 1e-4, conc within
    CONC_RTOL of its largest value; returns the largest float residues."""
    import numpy as np
    worst = {}
    for k, w in want["pool"].items():
        g = got["pool"][k]
        check(g.dtype == w.dtype, f"{what}: dtype of {k} differs")
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{what}: {k}")
            worst[k] = float(np.abs(g - w).max())
        else:
            check(np.array_equal(g, w), f"{what}: integer channel {k} "
                                        f"differs")
    for f, w in want["stats"].items():
        check(np.array_equal(got["stats"][f], w), f"{what}: stat {f} "
                                                  f"differs")
    cw, cg = want["conc"], got["conc"]
    scale = max(float(np.abs(cw).max()), 1e-30)
    worst["conc_rel"] = float(np.abs(cg - cw).max()) / scale
    check(worst["conc_rel"] <= CONC_RTOL, f"{what}: conc differs by "
                                         f"{worst['conc_rel']:.3g}")
    return worst


def _cpu_step(sim_c, state):
    """One step on the CPU with one torch thread (as phase 2)."""
    import torch
    from repro_torch import convert
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return convert.state_to_numpy(sim_c.step(
            convert.state_from_numpy(convert.state_to_numpy(state), "cpu")))
    finally:
        torch.set_num_threads(threads)


def phase_engine_cpu_parity(n: int, report: dict) -> None:
    from repro_torch import convert
    from repro_torch.launch import simulate

    sim_g, st_g = simulate.build("proliferation", n, "fig6", device="cuda")
    sim_c, _ = simulate.build("proliferation", n, "fig6", device="cpu")
    st_g = sim_g.run(st_g, 3)              # leave the initial layout
    want = _cpu_step(sim_c, st_g)
    got = convert.state_to_numpy(sim_g.step(st_g))
    worst = _card_vs_cpu(want, got, "engine step")
    report["engine_gpu_vs_cpu"] = {"agents": n, "max_abs_diff": worst,
                                   "integers_equal": True}
    print(f"[2] engine step on the card ≡ on the CPU at {n} agents: "
          f"max|Δ| {worst}, integer channels and stats equal", flush=True)


def _reset_counts() -> None:
    from repro_torch.kernels import launch_counters
    for fn in launch_counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    from repro_torch.kernels import launch_counters
    return {name: fn.launches for name, fn in launch_counters().items()}


def _timed_run(sim, st, steps: int, expect: dict | None = None):
    """``sim.run(check_overflow=True)`` for ``steps`` steps with a sync at
    each step's end. Every kernel's launch count is reset just before and
    read just after; each named in ``expect`` must equal its value there
    (default: K1 and the column map once a step), and no health or
    overflow flag may be set. Returns the state, each step's ms, the mean
    ms per step, the launches and the summed rebuilds and skips."""
    import torch
    torch.cuda.synchronize()
    stamps, rebuilds = [], []
    expect = expect or {"k1_collision_force": steps,
                        "k1_column_map": steps}

    def tick(i, state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        rebuilds.append((int(state.stats["rebuilds"]),
                         int(state.stats["rebuild_skips"])))

    _reset_counts()
    t0 = time.perf_counter()
    st = sim.run(st, steps, callback=tick, check_overflow=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    for name, count in expect.items():
        check(launches[name] == count, f"{name} launched {launches[name]} "
                                       f"times in {steps} steps, not {count}")
    check(st.stats.health_bits() == 0, "health flags set")
    check(not st.stats.flags(), f"overflow flags {st.stats.flags()}")
    steps_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
    counts = {"rebuilds": sum(r for r, _ in rebuilds),
              "rebuild_skips": sum(k for _, k in rebuilds)}
    return st, steps_ms, wall * 1e3 / steps, launches, counts


def phase_main_path(n: int, steps: int, report: dict) -> dict:
    import torch
    from repro_torch.launch import simulate

    sim, st = simulate.build("proliferation", n, "fig6", device="cuda")
    st, steps_ms, ms, launches, _ = _timed_run(sim, st, steps)
    n_live = int(st.stats["n_live"])
    check(n_live >= n, f"population shrank to {n_live}")
    live = st.pool.position[:n_live]
    check(bool(torch.isfinite(live).all()), "non-finite positions")
    rec = {"agents": n, "capacity": sim.config.capacity, "steps": steps,
           "launches": launches, "ms_per_step": ms,
           "ms_per_step_median": statistics.median(steps_ms),
           "ms_first_step": steps_ms[0],
           "agent_steps_per_s": n * 1e3 / ms, "n_live_end": n_live}
    report["main_path"] = rec
    print(f"[3] main path: {n} agents x {steps} steps, "
          f"{rec['ms_per_step']:.2f} ms/step (median "
          f"{rec['ms_per_step_median']:.2f}, first {steps_ms[0]:.2f}), "
          f"{rec['agent_steps_per_s']:.4g} agent-steps/s, K1 launches "
          f"{launches['k1_collision_force']}, column-map launches "
          f"{launches['k1_column_map']}", flush=True)
    return rec


def phase_births(report: dict) -> None:
    import numpy as np
    from repro_torch.core import (EngineConfig, ForceParams, GrowDivide,
                                  Simulation)
    cfg = EngineConfig(capacity=32768, domain_lo=(0, 0, 0),
                       domain_hi=(120, 120, 120), interaction_radius=14.0,
                       dt=0.2, sort_frequency=10, max_per_box=64,
                       force=ForceParams(max_displacement=1.0))
    sim = Simulation(cfg, [GrowDivide(rate=1.0, threshold_diameter=12.0)],
                     device="cuda")
    pos = np.random.default_rng(0).uniform(50, 70, (128, 3)).astype(
        np.float32)
    st = sim.init_state(pos, diameter=np.full(128, 8.0, np.float32))
    births = []
    st = sim.run(st, 60, check_overflow=True,
                 callback=lambda i, s: births.append(s.stats["births"]))
    total = int(sum(int(b) for b in births))
    n_live = int(st.stats["n_live"])
    check(n_live > 128 and total > 0,
          f"population did not grow: n_live {n_live}, births {total}")
    check(n_live == 128 + total, "n_live != 128 + births")
    report["births"] = {"steps": 60, "n_live": n_live, "births": total}
    print(f"[4] births: n_live {n_live} after 60 steps ({total} births)",
          flush=True)


def k2_bound(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
             causal: bool, dtype: str) -> tuple[float, str, dict]:
    """Least time this card could take for one K2 call: 4·D operations per
    visible (query, key) pair at the peak for the input type (bf16 tensor
    cores, or FP32), against q, k, v read once and o written once."""
    import numpy as np
    from repro_torch.kernels import flash_attention as k2
    off = sk - sq                          # ops.flash_attention's alignment
    if causal:
        rows = np.clip(np.minimum(np.arange(sq) + off + 1, sk), 0, None)
        pairs = int(rows.sum()) * b * hq
    else:
        pairs = sq * sk * b * hq
    ops = k2.OPS_PER_PAIR_PER_D * d * pairs
    width = 2 if dtype == "bfloat16" else 4
    moved = width * d * b * (2 * hq * sq + 2 * hkv * sk)
    peak = PEAK_BF16_TENSOR_FLOPS if dtype == "bfloat16" else PEAK_FP32_FLOPS
    t_ops = ops / peak * 1e3
    t_bytes = moved / PEAK_HBM_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, {"pairs": pairs, "operations": ops,
                                     "bytes": moved}


def k2_templates(log: str) -> list:
    """Each K2 kernel template in the ptxas log (``-Xptxas=-v``): path,
    type, head dim, registers, spill bytes, and the dynamic shared memory
    the launch asks for. Fails if any template spills."""
    import re
    import torch
    from repro_torch.kernels import flash_attention as k2
    recs, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            tc = re.search(r"flash_attention_tcILi(\d+)E", m.group(1))
            sc = re.search(r"flash_attention_kernelI(13__nv_bfloat16|f)"
                           r"Li(\d+)E", m.group(1))
            cur = None
            if tc:
                cur = {"path": "tensor_core", "dtype": "bfloat16",
                       "d": int(tc.group(1))}
            elif sc:
                cur = {"path": "scalar", "d": int(sc.group(2)),
                       "dtype": "float32" if sc.group(1) == "f"
                       else "bfloat16"}
            if cur:
                cur["smem_bytes"] = k2.smem_bytes(
                    getattr(torch, cur["dtype"]), cur["d"])
                recs.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    for r in recs:
        # the tensor-core kernel's count is the one a block starts with;
        # setmaxnreg moves its consumers to 240
        print(f"    flash_attention: {r['path']} {r['dtype']} D{r['d']}: "
              f"{r.get('registers')} registers, {r.get('spill_bytes')} "
              f"spill bytes, {r['smem_bytes']:,} B dynamic shared memory",
              flush=True)
        check(r.get("spill_bytes") == 0,
              f"K2 {r['path']} {r['dtype']} D{r['d']} spills: {r}")
    for path in ("tensor_core", "scalar"):
        check(any(r["path"] == path for r in recs),
              f"no {path} K2 template in the build log")
    return recs


def _k2_first_takes(dtype: str, d: int) -> bool:
    """Whether K2's first designs (launch/kernel_variants.py) take this
    input: bf16 at D 64, 96, 128 and f32 at D 96, 128."""
    return d in ((64, 96, 128) if dtype == "bfloat16" else (96, 128))


def _k2_case(tag: str, name: str, q, k, v, causal: bool,
             first: bool = True) -> dict:
    """K2 (``ops.flash_attention``) against its plain version on q, k, v:
    output type, shape and finiteness, max|Δ| within K2_TOL and, for bf16,
    within atol + rtol·|plain| everywhere; where its first design takes the
    input (and ``first``: a ``--cards`` run builds no first design), that
    design ≡ plain too, and at D 64 and 128 in bf16 (a kernel
    the redesign left as it was) bit-equal to K2. The kernel, its first
    design and SDPA (where Sq = Sk: the library's causal mask is top-left
    aligned) timed in turns, the plain version's time and the bound.
    Prints one line under ``tag``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ops
    from repro_torch.launch import kernel_variants

    torch.backends.cuda.matmul.allow_tf32 = False     # plain f32 stays f32
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dtype = str(q.dtype).removeprefix("torch.")
    path = k2.kernel_path(q.dtype, d)
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    plain = k2.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(out.dtype == q.dtype and out.shape == q.shape,
          f"{tag} K2 output {out.dtype} {tuple(out.shape)} at {name}")
    check(bool(torch.isfinite(out).all()), f"{tag} K2 output not finite at "
                                           f"{name}")
    diff = (out.float() - plain.float()).abs()
    err = float(diff.max())
    check(err <= K2_TOL[dtype], f"{tag} K2 differs from plain by {err} at "
                                f"{name} (tolerance {K2_TOL[dtype]})")
    scaled_err = None
    if dtype == "bfloat16":
        atol, rtol = K2_BF16_SCALED
        scaled_err = float((diff / (atol + rtol * plain.float().abs()))
                           .max())
        check(scaled_err <= 1.0, f"{tag} K2 differs from plain by "
              f"{scaled_err:.3g}× atol {atol} + rtol {rtol}·|plain| "
              f"at {name}")
    fns = {"kernel": lambda: ops.flash_attention(q, k, v, causal=causal)}
    first_err = None
    if first and _k2_first_takes(dtype, d):
        first = kernel_variants.flash_attention_first(q, k, v,
                                                      causal=causal)
        torch.cuda.synchronize()
        first_err = float((first.float() - plain.float()).abs().max())
        check(first_err <= K2_TOL[dtype], f"{tag} K2's first design "
              f"differs from plain by {first_err} at {name}")
        if path == "tensor_core" and d != 96:
            check(torch.equal(out, first), f"{tag} K2 bf16 D{d} is not "
                  f"bit-equal to its first design at {name}")
        fns["first_design"] = lambda: kernel_variants.flash_attention_first(
            q, k, v, causal=causal)
        del first
    lib_err = None
    if sq == sk:
        lib = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                             enable_gqa=True)
        lib_err = float((lib.float() - plain.float()).abs().max())
        fns["library"] = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
        del lib
    turns = _in_turns(fns)
    mean = {n: sum(t) / len(t) for n, t in turns.items()}
    ms, first_ms, lib_ms = (mean.get(n) for n in ("kernel", "first_design",
                                                  "library"))
    plain_ms = cuda_ms(lambda: k2.flash_attention_plain(
        q, k, v, causal=causal), iters=3, warmup=1)
    bound_ms, bound_by, work = k2_bound(b, hq, hkv, sq, sk, d, causal,
                                         dtype)
    rec = {"case": name, "shape": [b, hq, hkv, sq, sk, d],
           "causal": causal, "dtype": dtype, "path": path,
           "max_abs_err": err,
           "max_err_over_scaled_tol": scaled_err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_max_abs_err": lib_err, "bound_ms": bound_ms,
           "bound_by": bound_by, "first_design_ms": first_ms,
           "first_design_max_abs_err": first_err,
           "bit_equal_to_first_design": (path == "tensor_core" and d != 96
                                         and first_err is not None),
           "turns_ms": turns, **work}
    lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
    first_txt = "n/a" if first_ms is None else f"{first_ms:.4f} ms"
    print(f"{tag} K2 {name} (B{b} Hq{hq} Hkv{hkv} Sq{sq} Sk{sk} D{d} "
          f"{dtype}{' causal' if causal else ''}, {path} kernel): "
          f"kernel {ms:.4f} ms, first design {first_txt}, "
          f"plain {plain_ms:.3f} ms, SDPA {lib_txt}, bound "
          f"{bound_ms:.4f} ms ({bound_by}); max|Δ| {err:.3g}"
          + ("" if scaled_err is None else
             f", max |Δ|/(atol + rtol·|plain|) {scaled_err:.3g}")
          + (", bit-equal to the first design"
             if rec["bit_equal_to_first_design"] else ""),
          flush=True)
    return rec


def phase_k2_vs_plain(report: dict) -> list:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(12)
    recs = []
    served = [len(r.prompt) for r in _served_requests()]
    for name, b, hq, hkv, sq, sk, d, causal, dtype in K2_CASES:
        if sq == "first":
            sq = sk = served[0]
        elif sq == "shortest":
            sq = sk = min(served)
        dt = getattr(torch, dtype)
        q = torch.randn((b, hq, sq, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, hkv, sk, d), generator=gen, device="cuda").to(dt)
        recs.append(_k2_case("[5]", name, q, k, v, causal))
        del q, k, v
    report["k2_vs_plain"] = recs
    return recs


def _small_lm_config():
    from repro_torch.configs import ARCHS
    return dataclasses.replace(
        ARCHS["qwen2-1.5b"], name="qwen2-small", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_head=32, d_ff=512, vocab_size=1000,
        param_dtype="float32", activation_dtype="float32", remat="none")


def _greedy_run(cfg, leaves, toks, dev: str, steps: int, s_max: int,
                feed=None, frames=None):
    """Prefill ``toks`` (with an encoder-decoder's ``frames``) then
    ``steps`` decode steps on ``dev``; the decode inputs are ``feed`` or,
    without it, this run's own argmax. Returns the logits of every step
    (numpy) and the tokens fed."""
    import torch
    from repro_torch import convert
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model

    m = build_model(cfg, device=dev)
    params = convert.params_from_numpy(leaves, dev)
    b, t0 = toks.shape
    fe, s_enc = ((), ()) if frames is None else (
        (torch.from_numpy(frames).to(dev),), (frames.shape[1],))
    logits, pre = m.prefill(params, torch.from_numpy(toks).to(dev), *fe)
    caches = m.init_decode_caches(b, s_max, *s_enc)
    serve_lm.write_caches(caches, pre, t0)
    out, fed = [logits.cpu().numpy()], []
    for i in range(steps):
        nxt = torch.argmax(logits, -1).cpu() if feed is None else feed[i]
        fed.append(nxt)
        logits, caches = m.decode_step(params, nxt.to(dev), caches, t0 + i)
        out.append(logits.cpu().numpy())
    return out, fed


def phase_lm_cpu_parity(report: dict) -> None:
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.models import build_model

    cfg = _small_lm_config()
    b, t0, steps, s_max = 2, 48, 8, 64
    threads = torch.get_num_threads()
    torch.set_num_threads(1)               # as phase 2
    try:
        leaves = convert.params_to_numpy(build_model(
            cfg, device="cpu").init_params(torch.Generator().manual_seed(5)))
        toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (b, t0))
        _reset_counts()
        got, fed = _greedy_run(cfg, leaves, toks, "cuda", steps, s_max)
        torch.cuda.synchronize()
        launches = _read_counts()
        # the card's greedy tokens drive the CPU run too
        want, _ = _greedy_run(cfg, leaves, toks, "cpu", steps, s_max, fed)
    finally:
        torch.set_num_threads(threads)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=LM_TOL, rtol=LM_TOL,
                                   err_msg=f"LM logits, step {i}")
        check(np.array_equal(g.argmax(-1), w.argmax(-1)),
              f"LM argmax differs at step {i}")
        worst = max(worst, float(np.abs(g - w).max()))
    # the prefill runs the f32 K2 (the scalar kernel) once per layer
    check(launches["k2_flash_attention"] == cfg.n_layers
          and not any(n for k, n in launches.items()
                      if k != "k2_flash_attention"),
          f"[6] launches {launches}, want K2 {cfg.n_layers} and no other")
    report["lm_gpu_vs_cpu"] = {"config": dataclasses.asdict(cfg),
                               "prefill_tokens": [b, t0],
                               "decode_steps": steps, "max_abs_diff": worst,
                               "argmax_equal": True, "launches": launches}
    print(f"[6] LM on the card ≡ on the CPU ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, f32): prefill + {steps} "
          f"decode steps, max|Δlogit| {worst:.3g}, argmax equal; f32 K2 "
          f"launches {launches['k2_flash_attention']}", flush=True)


def _served_requests() -> list:
    """Phase 7's requests."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve_lm
    return serve_lm.make_requests(
        SERVE["requests"], ARCHS[SERVE["arch"]].vocab_size,
        prompt_min=SERVE["prompt_min"], prompt_max=SERVE["prompt_max"],
        new_tokens=SERVE["new_tokens"], seed=SERVE["seed"])


def phase_serve(report: dict) -> dict:
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model

    cfg = ARCHS[SERVE["arch"]]
    model = build_model(cfg, device="cuda")
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SERVE["seed"]))
    reqs = _served_requests()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rep = serve_lm.serve(model, params, reqs, slots=SERVE["slots"],
                         s_max=SERVE["s_max"], page_size=SERVE["page_size"],
                         n_pages=SERVE["n_pages"])
    launches = _read_counts()
    summ = rep.summary()
    check(sorted(f.uid for f in rep.finished) == list(range(len(reqs))),
          f"finished {sorted(f.uid for f in rep.finished)}")
    check(all(len(f.tokens) == SERVE["new_tokens"] for f in rep.finished),
          "a request stopped short of its new tokens")
    check(rep.n_free == SERVE["n_pages"],
          f"pool leaked: {rep.n_free} of {SERVE['n_pages']} pages free")
    check(rep.logits_finite, "non-finite logits")
    check(launches["k2_flash_attention"] == cfg.n_layers * summ["prefills"],
          f"K2 launched {launches['k2_flash_attention']} times in "
          f"{summ['prefills']} prefills of {cfg.n_layers} layers")
    rec = {"config": SERVE, "n_layers": cfg.n_layers,
           "n_params": model.n_params(), "launches": launches,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           **summ}
    report["serve"] = rec
    print(f"[7] serve {cfg.name} ({cfg.n_layers} layers, "
          f"{model.n_params():,} params, bf16): {summ['requests']} requests,"
          f" {summ['prompt_tokens']} prompt tokens, "
          f"{summ['generated_tokens']} generated; prefill "
          f"{summ['prefill_tokens_per_s']:.0f} tokens/s (mean "
          f"{summ['prefill_ms_mean']:.2f} ms per prompt); time to first "
          f"token median {summ['ttft_ms_median']:.2f} ms, max "
          f"{summ['ttft_ms_max']:.2f} ms; decode "
          f"{summ['decode_ms_per_iter_median']:.2f} ms/iteration (median of "
          f"{summ['decode_iterations']}); {summ['generated_tokens_per_s']:.1f}"
          f" generated tokens/s; K2 launches "
          f"{launches['k2_flash_attention']} (= {cfg.n_layers} x "
          f"{summ['prefills']}); peak memory {rec['peak_memory_gb']:.2f} GB",
          flush=True)
    return rec


def phase_k1_static(report: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import (EngineConfig, ForceParams, RandomWalk,
                                  Simulation, engine as eng, statics)
    from repro_torch.kernels import collision_force as k1, ops

    g = FRONT_SIDE
    n = g ** 3
    side = 5.0 * g + 10
    cfg = EngineConfig(capacity=n, domain_lo=(0, 0, 0),
                       domain_hi=(side,) * 3, interaction_radius=4.0,
                       dt=0.05, detect_static=True, max_per_box=32,
                       query_chunk=4096,
                       force=ForceParams(max_displacement=0.5))
    sim = Simulation(cfg, [RandomWalk(sigma=0.4, applies_to=1)],
                     device="cuda")
    pos = np.stack(np.meshgrid(*[np.arange(g) * 5.0 + 5] * 3), -1
                   ).reshape(-1, 3).astype(np.float32)
    types = np.zeros(n, np.int32)
    types[:n // 20] = 1                                 # 5% active front
    st = sim.run(sim.init_state(pos, diameter=np.full(n, 3.0, np.float32),
                                agent_type=types), 2, check_overflow=True)
    spec = sim.spec
    origin = torch.zeros(3, device="cuda")
    res = eng.build_env(cfg, spec, st.pool, origin, cfg.cell_size)
    pool, grid = res.pool, res.grid
    static = statics.update_static_flags(pool, spec, grid, st.iteration)
    active = pool.alive & ~static
    label = f"[8] front, {n} agents:"
    _, (data_t, cols, _, _) = _column_map_vs_plain(label, cfg, spec, pool,
                                                   grid, origin, active)
    empty = (cols < 0).all(1)
    frac_static = float(empty.float().mean())
    check(frac_static >= 0.5, f"only {frac_static:.3f} of the row blocks "
                              f"are wholly static")
    k1_rec = _k1_vs_plain(label, data_t, cols, cfg)
    f, nnz, _ = ops.collision_force_resident(
        pool.position, pool.diameter, pool.agent_type, pool.alive, active,
        grid.starts, grid.counts, origin, cfg.cell_size, dims=spec.dims,
        k_rep=cfg.force.k_rep, adhesion_band=cfg.force.adhesion_band)
    check(not bool(f[static].any()) and not bool(nnz[static].any()),
          "a static row got a force")
    data_a, cols_a, _, _ = ops.k1_inputs(
        pool.position, pool.diameter, pool.agent_type, pool.alive,
        pool.alive, grid.starts, grid.counts, origin, cfg.cell_size,
        spec.dims)
    kw = dict(k_rep=cfg.force.k_rep, adhesion=None,
              adhesion_band=cfg.force.adhesion_band)
    ms_all = cuda_ms(lambda: k1.collision_force(data_a, cols_a, **kw),
                     iters=20, warmup=3)
    rec = {"agents": n, "static_rows": int(static.sum()),
           "empty_row_blocks": int(empty.sum()), **k1_rec,
           "ms_all_active": ms_all}
    report["k1_static"] = rec
    print(f"[8] K1 with static rows ({n} agents, {rec['static_rows']} "
          f"static, {rec['empty_row_blocks']} of {rec['row_blocks']} row "
          f"blocks empty, the same lists as the plain map's): kernel "
          f"{rec['ms']:.4f} ms (all active {ms_all:.4f} ms); static rows "
          f"zero", flush=True)
    return rec


def phase_scenarios_cpu_parity(n: int, report: dict) -> None:
    from repro_torch import convert
    from repro_torch.launch import simulate

    recs = {}
    for sc in simulate.SCENARIOS:
        sim_g, st = simulate.build(sc, n, device="cuda")
        sim_c, _ = simulate.build(sc, n, device="cpu")
        st = sim_g.run(st, 2)              # leave the initial layout
        want = _cpu_step(sim_c, st)
        got = convert.state_to_numpy(sim_g.step(st))
        worst = _card_vs_cpu(want, got, f"scenario {sc}")
        recs[sc] = {"max_abs_diff": worst,
                    "births": int(want["stats"]["births"]),
                    "deaths": int(want["stats"]["deaths"]),
                    "n_active": int(want["stats"]["n_active"])}
        print(f"[9] {sc}: one step on the card ≡ on the CPU at {n} agents "
              f"(births {recs[sc]['births']}, deaths {recs[sc]['deaths']}, "
              f"n_active {recs[sc]['n_active']}); max|Δ| "
              f"{ {k: float(f'{v:.3g}') for k, v in worst.items() if v} }",
              flush=True)
    report["scenarios_gpu_vs_cpu"] = {"agents": n, "scenarios": recs}


def phase_sir_main_path(n: int, steps: int, report: dict
                        ) -> tuple[dict, dict, dict]:
    import torch
    from repro_torch.core import engine as eng
    from repro_torch.core.behaviors import INFECTED
    from repro_torch.launch import simulate
    from repro_torch.launch.profile_step import profile_steps

    sim, st = simulate.build("epidemiology", n, "breakdown", device="cuda")
    cfg, spec = sim.config, sim.spec
    # the kernels on the first step's inputs, against their plain versions
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32, device="cuda")
    res = eng.build_env(cfg, spec, st.pool, origin, cfg.cell_size)
    label = f"[10] breakdown, {n} agents:"
    cm_rec, (data_t, cols, _, _) = _column_map_vs_plain(
        label, cfg, spec, res.pool, res.grid, origin, res.pool.alive)
    k1_rec = _k1_vs_plain(label, data_t, cols, cfg)
    del res, data_t, cols
    report["k1_breakdown"] = {"agents": n, "column_map": cm_rec,
                              "k1": k1_rec}

    infected0 = int((st.pool.agent_type == INFECTED).sum())
    torch.cuda.reset_peak_memory_stats()
    st, steps_ms, ms, launches, _ = _timed_run(sim, st, steps)
    n_live = int(st.stats["n_live"])
    check(n_live == n, f"population changed to {n_live}")
    alive = st.pool.alive
    check(bool(torch.isfinite(st.pool.position[alive]).all()),
          "non-finite positions")
    infected = int((st.pool.agent_type[alive] == INFECTED).sum())
    check(infected > infected0, f"infected {infected0} -> {infected}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, prof = profile_steps(sim, st, 2)
    sweep = prof["ranges"].get("grid/sweep", {"device_ms": 0.0,
                                              "launches": 0})
    rec = {"config": "breakdown", "agents": n, "capacity": cfg.capacity,
           "steps": steps, "launches": launches, "ms_per_step": ms,
           "ms_per_step_median": statistics.median(steps_ms),
           "ms_first_step": steps_ms[0],
           "agent_steps_per_s": n * 1e3 / ms, "n_live_end": n_live,
           "infected_start": infected0, "infected_end": infected,
           "peak_memory_gb": peak_gb,
           "device_ops_per_step": prof["launches"],
           "device_busy_ms_per_step": prof["device_busy_ms"],
           "device_idle_share": prof["device_idle_share"],
           "sweep_device_ms_per_step": sweep["device_ms"],
           "sweep_ops_per_step": sweep["launches"], "profile": prof}
    report["sir_main_path"] = rec
    print(f"[10] main path (forces in K1 + Infection in the streamed sweep): "
          f"{n} agents x {steps} steps, {ms:.2f} ms/step "
          f"(median {rec['ms_per_step_median']:.2f}, first "
          f"{steps_ms[0]:.2f}), {rec['agent_steps_per_s']:.4g} "
          f"agent-steps/s; K1 launches {launches['k1_collision_force']}, "
          f"column-map launches {launches['k1_column_map']}; n_live "
          f"{n_live}, infected {infected0} -> {infected}; peak memory "
          f"{peak_gb:.2f} GB", flush=True)
    print(f"[10] profiled: {prof['launches']:.0f} device ops/step, busy "
          f"{prof['device_busy_ms']:.3f} ms of "
          f"{prof['ms_per_step_profiled']:.2f} ms/step, idle share "
          f"{prof['device_idle_share']:.3f} (launch/profile_step.py's); "
          f"grid/sweep {sweep['device_ms']:.3f} ms in "
          f"{sweep['launches']:.0f} ops; "
          + ", ".join(f"{k} {v['device_ms']:.3f} ms/{v['launches']:.0f}"
                      for k, v in list(prof["ranges"].items())[:8]),
          flush=True)
    return rec, cm_rec, k1_rec


def _threshold_pairs(pool, rows, cfg) -> list:
    """For each row, its pair whose force lies nearest ``force_eps``, in
    float64: the partner's slot, the overlap δ, |f|/force_eps with |f| =
    k_rep·√r_eff·δ^1.5, and whether that pair is at the threshold: |f| at
    δ ± 2e-6 (about 8 ulps of a distance near 3, more than the float32
    arithmetic of either path can move it) straddles force_eps. Such a
    pair may count in one path's force_nnz and not in the other's."""
    import numpy as np
    check(cfg.adhesion is None, "the threshold test assumes no adhesion")
    pos = pool.position.double().cpu().numpy()
    dia = pool.diameter.double().cpu().numpy()
    alive = pool.alive.cpu().numpy()
    fp = cfg.force

    def force(dl):
        return fp.k_rep * np.sqrt(r_eff) * np.maximum(dl, 0.0) ** 1.5
    out = []
    for r in rows:
        d = np.linalg.norm(pos - pos[r], axis=1)
        near = np.nonzero(alive & (d < cfg.interaction_radius))[0]
        near = near[near != r]
        rq, rn = dia[r] / 2, dia[near] / 2
        delta = rq + rn - d[near]
        r_eff = rq * rn / (rq + rn)
        lo, hi = force(delta - 2e-6), force(delta + 2e-6)
        k = int(np.argmin(np.abs(np.log(np.maximum(force(delta), 1e-300)
                                         / fp.force_eps))))
        out.append({"row": int(r), "partner": int(near[k]),
                    "overlap": float(delta[k]),
                    "force_over_eps": float(force(delta)[k] / fp.force_eps),
                    "at_threshold": bool(((lo <= fp.force_eps)
                                          & (hi >= fp.force_eps)).any())})
    return out


def _same_nnz(a, b, pool, cfg, what: str) -> list:
    """force_nnz equal, but for rows whose count a pair at the threshold
    makes ambiguous (``_threshold_pairs``); returns those rows' pairs."""
    import torch
    rows = torch.nonzero(a != b).flatten().tolist()
    check(len(rows) <= 16, f"{what}: force_nnz differs in {len(rows)} rows")
    pairs = _threshold_pairs(pool, rows, cfg)
    for p, r in zip(pairs, rows):
        p["counts"] = [int(a[r]), int(b[r])]
    check(all(p["at_threshold"] for p in pairs),
          f"{what}: force_nnz differs in rows with no pair at the force_eps "
          f"threshold: {pairs}")
    return pairs


def phase_streamed_vs_k1(n: int, report: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.core import engine as eng, grid as grid_mod
    from repro_torch.kernels import ops
    from repro_torch.launch import simulate

    sim_k, st = simulate.build("epidemiology", n, "breakdown", device="cuda")
    sim_s, _ = simulate.build("epidemiology", n, "breakdown", device="cuda",
                              force_impl="streamed")
    cfg, spec = sim_k.config, sim_k.spec
    origin = torch.zeros(3, device="cuda")
    res = eng.build_env(cfg, spec, st.pool, origin, cfg.cell_size)
    ch = res.pool.channels()
    kernels = eng.registered_kernels(cfg, sim_k.behaviors, device="cuda")
    alive = res.pool.alive

    def via_k1():
        return ops.fused_resident_sweep(
            spec, res.grid, ch, kernels, alive, origin=origin,
            box_size=cfg.cell_size, k_rep=cfg.force.k_rep,
            adhesion_band=cfg.force.adhesion_band, chunk=cfg.query_chunk)[0]

    def via_sweep():
        return grid_mod.resident_apply_fused(spec, res.grid, ch, kernels,
                                             alive, cfg.query_chunk)
    a, b = via_k1(), via_sweep()
    torch.cuda.synchronize()
    err = float((a["force"]["force"] - b["force"]["force"]).abs().max())
    check(err <= FORCE_ATOL, f"streamed force differs from K1's by {err}")
    threshold = _same_nnz(a["force"]["force_nnz"], b["force"]["force_nnz"],
                          res.pool, cfg, "streamed sweep vs K1")
    check(torch.equal(a["infection"]["exposed"], b["infection"]["exposed"]),
          "exposed differs between the two paths")
    torch.cuda.reset_peak_memory_stats()
    ms_k1 = cuda_ms(via_k1, iters=3, warmup=1)
    ms_sweep = cuda_ms(via_sweep, iters=3, warmup=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    st_k, st_s = sim_k.step(st), sim_s.step(st)
    # no births or deaths: the step's pool keeps the build's slot order, so
    # the ambiguity is judged at the positions the forces were taken at
    step_threshold = _same_nnz(st_k.pool.force_nnz, st_s.pool.force_nnz,
                               res.pool, cfg, "streamed vs K1 step")
    want, got = convert.state_to_numpy(st_k), convert.state_to_numpy(st_s)
    worst = {}
    for k, w in want["pool"].items():
        g = got["pool"][k]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"streamed vs K1 step: {k}")
            worst[k] = float(np.abs(g - w).max())
        elif k != "force_nnz":
            check(np.array_equal(g, w), f"streamed vs K1 step: {k} differs")
    for f, w in want["stats"].items():
        check(np.array_equal(got["stats"][f], w),
              f"streamed vs K1 step: stat {f} differs")
    rec = {"agents": n, "force_max_abs_err": err,
           "nnz_rows_at_threshold": threshold,
           "step_nnz_rows_at_threshold": step_threshold,
           "exposed_equal": True,
           "exposed": int((a["infection"]["exposed"] > 0).sum()),
           "fused_ms_k1": ms_k1, "fused_ms_streamed": ms_sweep,
           "peak_memory_gb": peak_gb, "step_max_abs_diff": worst}
    report["streamed_vs_k1"] = rec
    print(f"[11] streamed sweep ≡ K1 at {n} agents: max|Δf| {err:.3g}, "
          f"exposed equal ({rec['exposed']} exposed), force_nnz equal but "
          f"in {len(threshold)} rows (step: {len(step_threshold)}) whose "
          f"pair sits at the force_eps threshold; the "
          f"fused sweep {ms_k1:.2f} ms with K1, {ms_sweep:.2f} ms streamed "
          f"(peak {peak_gb:.2f} GB); one engine step each: max|Δ| "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items() if v} }, "
          f"integers and stats equal", flush=True)
    for p in threshold:
        print(f"[11]   row {p['row']}: K1 counts {p['counts'][0]}, the "
              f"sweep {p['counts'][1]}; its pair with slot {p['partner']} "
              f"overlaps by {p['overlap']:.4g}, |f|/force_eps "
              f"{p['force_over_eps']:.6f}", flush=True)
    return rec


def _breakdown_build(n: int, pairlist: str = "off"):
    """The forces + SIR workload's simulation, initial state and first
    resident build on the card."""
    import torch
    from repro_torch.core import engine as eng
    from repro_torch.launch import simulate
    sim, st = simulate.build("epidemiology", n, "breakdown", device="cuda",
                             pairlist=pairlist)
    origin = torch.zeros(3, device="cuda")
    res = eng.build_env(sim.config, sim.spec, st.pool, origin,
                        sim.config.cell_size)
    return sim, st, res, origin


def pairlist_bound(spec, grid, pool, pairs) -> tuple[float, str, dict]:
    """Least time for one pair-list build: the pool's positions and alive
    flags and the box tables read once, the table (idx, run_off, count,
    demand) written once; against ~9 FP32 operations per candidate lane
    these inputs give (each row's 9 runs, truncated at run_capacity)."""
    import torch
    from repro_torch.core import grid as grid_mod
    from repro_torch.kernels import pairlist
    c, p = pairs.idx.shape
    m = grid.starts.shape[0]
    _, n = grid_mod.run_bounds(spec, grid, pool.position, torch.arange(
        c, device=pool.position.device))
    lanes = int(n.clamp(max=spec.run_capacity)[pool.alive].sum())
    moved = c * (12 + 1) + 8 * m + 12 + 4 * c * p + 40 * c + 4 * c + 4
    ops = lanes * pairlist.OPS_PER_LANE
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = moved / PEAK_HBM_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, {"bytes": moved, "operations": ops,
                                     "candidate_lanes": lanes}


def _in_turns(fns: dict, iters: int = 20) -> dict:
    """CUDA-event ms of each ``fns[name]()``, timed in turns (a, b, b, a):
    {name: [first, second]}."""
    order = list(fns) + list(reversed(list(fns)))
    out = {k: [] for k in fns}
    for k in order:
        out[k].append(cuda_ms(fns[k], iters=iters, warmup=3))
    return out


def _pairlist_vs_previous(tag: str, build, previous, want) -> dict:
    """The pair-list kernel and its first design (launch/kernel_variants)
    on one set of inputs: both ≡ ``want`` (the plain list) entry for
    entry; times in turns."""
    import torch
    got, prev = build(), previous()
    torch.cuda.synchronize()
    for f in ("idx", "run_off", "count", "demand"):
        w = getattr(want, f)
        check(torch.equal(getattr(got, f), w),
              f"{tag} pair list differs from plain in {f}")
        check(torch.equal(prev[("idx", "run_off", "count",
                                "demand").index(f)], w),
              f"{tag} the first design differs from plain in {f}")
    t = _in_turns({"kernel": build, "previous": previous})
    return {"ms": statistics.fmean(t["kernel"]), "ms_turns": t["kernel"],
            "previous_design_ms": statistics.fmean(t["previous"]),
            "previous_design_ms_turns": t["previous"]}


def phase_pairlist_build(n: int, report: dict):
    """[12] the pair-list kernel ≡ its plain version at full width, on the
    grid-ordered pool and on the same pool with its rows permuted; timed
    beside its first design in the same call."""
    import torch
    from repro_torch.core import grid as grid_mod
    from repro_torch.launch import kernel_variants
    sim, _, res, _ = _breakdown_build(n)
    cfg, spec, pool, g = sim.config, sim.spec, res.pool, res.grid
    r = cfg.interaction_radius
    perm = torch.randperm(pool.position.shape[0],
                          generator=torch.Generator().manual_seed(12)
                          ).to(pool.position.device)
    shuffled = (pool.position[perm].contiguous(),
                pool.alive[perm].contiguous())
    recs = {}
    for key, mp, (pos, alive) in ((64, 64, (pool.position, pool.alive)),
                                  (16, 16, (pool.position, pool.alive)),
                                  ("permuted", 64, shuffled)):
        kw = dict(radius=r, max_pairs=mp, chunk=cfg.query_chunk)
        want = grid_mod.build_pairlist_plain(spec, g, pos, alive, **kw)
        torch.cuda.synchronize()
        timed = _pairlist_vs_previous(
            f"[12] ({key})",
            lambda: grid_mod.build_pairlist(spec, g, pos, alive, **kw),
            lambda: kernel_variants.pairlist_build(
                pos, alive, g.origin, g.box_size, g.starts, g.counts,
                spec.dims, spec.run_capacity, grid_mod.pair_radius_sq(r),
                mp), want)
        demand = int(want.demand)
        over = int((want.count > mp).sum())
        if key != "permuted":
            check((demand > mp) == (mp == 16), f"max_pairs {mp}: demand "
                                               f"{demand}")
        plain_ms = cuda_ms(lambda: grid_mod.build_pairlist_plain(
            spec, g, pos, alive, **kw), iters=2, warmup=0)
        bound_ms, bound_by, work = pairlist_bound(
            spec, g, types.SimpleNamespace(position=pos, alive=alive), want)
        recs[key] = {"max_pairs": mp, "demand": demand, "rows_over": over,
                     "pairs_listed": int(want.run_off[:, 9].sum()),
                     "equal": True, "max_abs_err": 0.0, **timed,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None, **work}
        print(f"[12] pair-list build, {n} agents"
              f"{' (rows permuted, tables kept)' if key == 'permuted' else ''}"
              f", radius {r}, max_pairs {mp}: kernel {timed['ms']:.4f} ms "
              f"(turns {timed['ms_turns'][0]:.4f}, "
              f"{timed['ms_turns'][1]:.4f}), first design "
              f"{timed['previous_design_ms']:.4f} ms in the same call, plain "
              f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
              f"idx, run_off, count and demand equal, both designs (demand "
              f"{demand}, {over} rows over max_pairs, "
              f"{recs[key]['pairs_listed']} pairs listed, "
              f"{work['candidate_lanes']} candidate lanes)", flush=True)
    report["pairlist_build"] = recs
    return recs[64]


def pairs_map_bound(pool, pairs, data_t, cols) -> tuple[float, str, dict]:
    """Least time for one fused pairs column-map launch: the pool channels
    and each active row's run_off entry and stored pair entries read once,
    data_t, the row mask, block_cols and the flag written once."""
    c, n_pad = pool.position.shape[0], data_t.shape[1]
    act = pool.alive
    stored = int(pairs.run_off[:, 9][act].sum())
    moved = (c * (12 + 4 + 4 + 1 + 1) + 4 * int(act.sum()) + 4 * stored
             + data_t.numel() * 4 + n_pad + cols.numel() * 4 + 4)
    return moved / PEAK_HBM_BYTES * 1e3, "bytes", {"bytes": moved,
                                                   "stored_entries": stored}


def _pairs_map_vs_previous(tag: str, args) -> dict:
    """The pairs column map (``ops.k1_inputs(*args)``, ``args`` ending in a
    pair list and the lanes: one launch, fused with the pack) and its
    first design (launch/kernel_variants, the same pool form) on one set of
    inputs: the first design's outputs ≡ the kernel's, which the caller
    holds against the plain version; times in turns."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import kernel_variants
    pool, maxb, pairs, lanes = args[:5], args[10], args[11], args[12]
    n_lanes = lanes.n if lanes is not None else 1
    n_pad = n_lanes * ops.lane_stride(lanes, pool[0].shape[0])
    kw = dict(pool=pool, lanes=n_lanes)
    fns = {"kernel": lambda: ops.k1_inputs(*args),
           "previous": lambda: kernel_variants.pair_cols_map(
               pairs.idx, pairs.run_off, n_pad, maxb, **kw)}
    want = fns["kernel"]()
    cols, ovf, data_t, mask = fns["previous"]()
    torch.cuda.synchronize()
    for a, b, what in zip((data_t, cols, ovf, mask), want,
                          ("data_t", "block_cols", "overflow", "row mask")):
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"{tag} pairs map: the first design differs from the kernel "
              f"in {what}")
    t = _in_turns(fns)
    return {"ms": statistics.fmean(t["kernel"]), "ms_turns": t["kernel"],
            "previous_design_ms": statistics.fmean(t["previous"]),
            "previous_design_ms_turns": t["previous"]}


def phase_pairs_map(n: int, report: dict):
    """[13] the pairs column map ≡ plain; K1 on it ≡ K1 on the stencil
    map, bit for bit."""
    import torch
    from repro_torch.core import grid as grid_mod
    from repro_torch.kernels import collision_force as k1, ops
    sim, _, res, origin = _breakdown_build(n)
    cfg, spec, pool, g = sim.config, sim.spec, res.pool, res.grid
    pairs = grid_mod.build_pairlist(spec, g, pool.position, pool.alive,
                                    radius=cfg.interaction_radius,
                                    max_pairs=64, chunk=cfg.query_chunk)
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            pool.alive, g.starts, g.counts, origin, cfg.cell_size,
            spec.dims, 64)
    got = ops.k1_inputs(*args, pairs)
    torch.cuda.synchronize()
    want = ops.k1_inputs_plain(*args, pairs)
    torch.cuda.synchronize()
    for gt, w, what in zip(got, want, ("data_t", "block_cols", "overflow",
                                       "row mask")):
        check(gt.dtype == w.dtype and torch.equal(gt, w),
              f"pairs column map differs from plain in {what}")
    check(not bool(got[2]), "pairs column map overflow")
    data_t, cols_p = got[0], got[1]
    cols_s = ops.k1_inputs(*args)[1]
    kw = dict(k_rep=cfg.force.k_rep, adhesion=None,
              adhesion_band=cfg.force.adhesion_band)
    out_p = k1.collision_force(data_t, cols_p, **kw)
    out_s = k1.collision_force(data_t, cols_s, **kw)
    torch.cuda.synchronize()
    check(torch.equal(out_p, out_s),
          f"K1 on the pairs map differs from K1 on the stencil map: force "
          f"{float((out_p[:3] - out_s[:3]).abs().max())}, nnz rows "
          f"{int((out_p[3] != out_s[3]).sum())}")
    timed = _pairs_map_vs_previous("[13]", (*args, pairs, None))
    ms = timed["ms"]
    plain_ms = cuda_ms(lambda: ops.k1_inputs_plain(*args, pairs), iters=2,
                       warmup=0)
    k1_pairs_ms = cuda_ms(lambda: k1.collision_force(data_t, cols_p, **kw),
                          iters=20, warmup=3)
    k1_stencil_ms = cuda_ms(lambda: k1.collision_force(data_t, cols_s,
                                                       **kw),
                            iters=20, warmup=3)
    bound_ms, bound_by, work = pairs_map_bound(pool, pairs, data_t, cols_p)
    k1_bound_ms, k1_by, k1_work = k1_bound(data_t, cols_p, None,
                                           cfg.force.adhesion_band)
    tiles_s = int((cols_s >= 0).sum())
    rec = {"agents": n, "equal": True, "max_abs_err": 0.0, **timed,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "k1_equal_bitwise": True,
           "k1_pairs_map_ms": k1_pairs_ms, "k1_stencil_map_ms": k1_stencil_ms,
           "k1_pairs_map_bound_ms": k1_bound_ms,
           "k1_pairs_map_bound_by": k1_by,
           "tiles_pairs_map": k1_work["tiles"], "tiles_stencil_map": tiles_s,
           **work}
    report["pairs_map"] = rec
    print(f"[13] pairs column map, {n} agents: kernel (fused with the pack) "
          f"{ms:.4f} ms (turns {timed['ms_turns'][0]:.4f}, "
          f"{timed['ms_turns'][1]:.4f}), first design "
          f"{timed['previous_design_ms']:.4f} ms in the same call; plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); block_cols, flag, data_t and row mask equal, both "
          f"designs; {work['stored_entries']} stored entries; K1 on "
          f"the pairs map ≡ K1 on the stencil map bit for bit (force and "
          f"nnz): {k1_pairs_ms:.4f} ms on {k1_work['tiles']} tiles against "
          f"{k1_stencil_ms:.4f} ms on {tiles_s} (bound on the pairs map "
          f"{k1_bound_ms:.4f} ms, {k1_by})", flush=True)
    return rec


def _profiled(sim, st, steps: int) -> dict:
    from repro_torch.launch.profile_step import profile_steps
    _, prof = profile_steps(sim, st, steps)
    rng = prof["ranges"]

    def dev_ms(name):
        return rng.get(name, {"device_ms": 0.0})["device_ms"]
    return {"device_ops_per_step": prof["launches"],
            "device_busy_ms_per_step": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "ms_per_step_profiled": prof["ms_per_step_profiled"],
            "profiled_rebuilds": prof["rebuilds"],
            "profiled_skips": prof["rebuild_skips"],
            "pairlist_build_device_ms": dev_ms("step/pairlist_build"),
            "k1_inputs_device_ms": dev_ms("k1/inputs"),
            "sweep_device_ms": dev_ms("grid/sweep"),
            "k1_device_ms": dev_ms("k1/kernel"), "profile": prof}


def phase_pairlist_main_path(n: int, steps: int, report: dict,
                             streamed: dict) -> dict:
    """[14] the slice's main path at full width, (a) and (b)."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.launch import simulate

    # (a) against the streamed path after one step
    sim_a, st0 = simulate.build("epidemiology", n, "breakdown",
                                device="cuda", pairlist="skin0")
    sim_s, _ = simulate.build("epidemiology", n, "breakdown", device="cuda")
    want = convert.state_to_numpy(sim_s.step(st0))
    got = convert.state_to_numpy(sim_a.step(st0))
    worst = 0.0
    for k, w in want["pool"].items():
        g = got["pool"][k]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"[14a] vs streamed: {k}")
            worst = max(worst, float(np.abs(g - w).max()))
        else:
            check(np.array_equal(g, w), f"[14a] vs streamed: {k} differs")
    for f in ("n_live", "births", "deaths", "box_overflow", "box_demand"):
        check(np.array_equal(got["stats"][f], want["stats"][f]),
              f"[14a] vs streamed: stat {f} differs")
    print(f"[14a] one step with the skin-0 pair list ≡ the streamed path: "
          f"integer channels (Infection's, force_nnz) equal, max|Δ| of "
          f"floats {worst:.3g}", flush=True)
    del want, got
    recs = {}
    for key, mode in (("a", "skin0"), ("b", "reuse")):
        sim, st = simulate.build("epidemiology", n, "breakdown",
                                 device="cuda", pairlist=mode)
        torch.cuda.reset_peak_memory_stats()
        st, steps_ms, ms, launches, counts = _timed_run(
            sim, st, steps, {"k1_collision_force": steps,
                             "k1_pair_cols": steps, "k1_column_map": 0})
        check(launches["pairlist_build"] == counts["rebuilds"],
              f"[14{key}] {launches['pairlist_build']} pair-list builds in "
              f"{counts['rebuilds']} rebuilds")
        if key == "a":
            check(counts["rebuilds"] == steps, "[14a] skipped a build")
        else:
            check(counts["rebuild_skips"] > 0, "[14b] no build was skipped")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(int(st.stats["n_live"]) == n and bool(torch.isfinite(
            st.pool.position[st.pool.alive]).all()), f"[14{key}] pool")
        prof = _profiled(sim, st, PROFILED_STEPS)
        rec = {"pairlist": mode, "config": dataclasses.asdict(
                   sim.config.pairlist) | {"rebuild": dataclasses.asdict(
                       sim.config.rebuild)},
               "agents": n, "steps": steps, "ms_per_step": ms,
               "ms_per_step_median": statistics.median(steps_ms),
               "agent_steps_per_s": n * 1e3 / ms, "launches": launches,
               "pair_demand": int(st.stats["pair_demand"]),
               "peak_memory_gb": peak_gb, **counts, **prof}
        recs[key] = rec
        print(f"[14{key}] pair list {mode} (max_pairs "
              f"{sim.config.pairlist.max_pairs}, skin "
              f"{sim.config.pairlist.skin}, rebuild "
              f"{sim.config.rebuild.mode} k {sim.config.rebuild.k}): {n} "
              f"agents x {steps} steps, {ms:.2f} ms/step (median "
              f"{rec['ms_per_step_median']:.2f}), "
              f"{rec['agent_steps_per_s']:.4g} agent-steps/s; rebuilds "
              f"{counts['rebuilds']}, skips {counts['rebuild_skips']}; "
              f"pair_demand {rec['pair_demand']}; launches: pair-list build "
              f"{launches['pairlist_build']}, pairs map "
              f"{launches['k1_pair_cols']}, K1 "
              f"{launches['k1_collision_force']}; peak memory "
              f"{peak_gb:.2f} GB", flush=True)
        print(f"[14{key}] profiled ({PROFILED_STEPS} steps, "
              f"{prof['profiled_rebuilds']} rebuilds): "
              f"{prof['device_ops_per_step']:.0f} device ops/step, busy "
              f"{prof['device_busy_ms_per_step']:.3f} ms of "
              f"{prof['ms_per_step_profiled']:.2f}, idle share "
              f"{prof['device_idle_share']:.3f}; step/pairlist_build "
              f"{prof['pairlist_build_device_ms']:.3f} ms, k1/inputs "
              f"{prof['k1_inputs_device_ms']:.4f} ms, grid/sweep "
              f"{prof['sweep_device_ms']:.3f} ms, k1/kernel "
              f"{prof['k1_device_ms']:.3f} ms per step", flush=True)
    print(f"[14] beside phase 10's streamed path: "
          f"{streamed['ms_per_step']:.2f} ms/step, idle {streamed['device_idle_share']:.3f}, grid/sweep "
          f"{streamed['sweep_device_ms_per_step']:.3f} ms, peak "
          f"{streamed['peak_memory_gb']:.2f} GB", flush=True)
    report["pairlist_main_path"] = recs
    return recs


def _secretion_inputs(n: int, dims, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, dims[0], (n, 3)).astype(np.float32)
    amount = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-5, 5, n)
              * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    conc = rng.uniform(0.0, 1.0, dims).astype(np.float32)
    return pos, amount, conc


def secretion_bound(n: int, voxels: int) -> tuple[float, int]:
    """Least time for one secretion call (ms, bytes): position and amount
    read once, the grid read and written once."""
    moved = 12 * n + 4 * n + 8 * voxels
    return moved / PEAK_HBM_BYTES * 1e3, moved


SECRETION_SHAPES = ((1, CLUSTER_AGENTS, (32, 32, 32)), (1, 65_536, (2, 2, 2)),
                    (1, 1_048_576, (32, 32, 32)),
                    (8, CLUSTER_AGENTS, (32, 32, 32)))


def phase_secretion(report: dict) -> dict:
    """[15] secretion reproducible on the card, ≡ the CPU, timed beside its
    first design; then the clustering --pairlist configuration card ≡ CPU
    and card ≡ card, and its profiled steps."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.core import diffusion
    from repro_torch.core.lanes import Lanes
    from repro_torch.launch import kernel_variants
    from repro_torch.launch.profile_step import profile_steps
    recs = []
    # the clustering run's shape (the kernels line's), many agents per
    # voxel, a million agents, and 8 lanes of the clustering shape
    for n_lanes, n, dims in SECRETION_SHAPES:
        spec = diffusion.DiffusionSpec(dims=dims, voxel=1.0)
        parts = [_secretion_inputs(n, dims, 3 + lane)
                 for lane in range(n_lanes)]
        conc = np.stack([c for _, _, c in parts])
        cpu = [torch.from_numpy(conc if n_lanes > 1 else conc[0]),
               torch.from_numpy(np.concatenate([p for p, _, _ in parts])),
               torch.from_numpy(np.concatenate([a for _, a, _ in parts]))]
        gpu = [x.cuda() for x in cpu]
        lanes = Lanes(n_lanes, n) if n_lanes > 1 else None
        o_c, o_g = torch.zeros(3), torch.zeros(3, device="cuda")
        want = diffusion.add_sources(spec, *cpu, o_c, lanes)
        runs = [diffusion.add_sources(spec, *gpu, o_g, lanes)
                for _ in range(2)]
        prev = kernel_variants.secretion_add(spec, *gpu, o_g, lanes)
        torch.cuda.synchronize()
        check(torch.equal(runs[0], runs[1]), "secretion: two card runs "
                                             "differ")
        check(torch.equal(runs[0].cpu(), want), "secretion: card differs "
                                                "from the CPU's slot order")
        check(torch.equal(prev.cpu(), want), "secretion: the first design "
                                             "differs from the CPU")
        flat = diffusion._flat(spec, diffusion.voxel_of(spec, gpu[1], o_g),
                               lanes)
        lib = gpu[0].reshape(-1).clone()
        t = _in_turns({
            "kernel": lambda: diffusion.add_sources(spec, *gpu, o_g, lanes),
            "previous": lambda: kernel_variants.secretion_add(
                spec, *gpu, o_g, lanes)})
        lib_ms = cuda_ms(lambda: lib.index_add_(0, flat, gpu[2]), iters=20,
                         warmup=3)
        t0 = time.perf_counter()
        for _ in range(3):
            diffusion.add_sources(spec, *cpu, o_c, lanes)
        plain_ms = (time.perf_counter() - t0) * 1e3 / 3
        v = int(np.prod(conc.shape)) if n_lanes > 1 else int(np.prod(dims))
        bound_ms, moved = secretion_bound(n_lanes * n, v)
        rec = {"lanes": n_lanes, "agents": n_lanes * n, "voxels": v,
               "equal": True, "max_abs_err": 0.0,
               "ms": statistics.fmean(t["kernel"]), "ms_turns": t["kernel"],
               "previous_design_ms": statistics.fmean(t["previous"]),
               "previous_design_ms_turns": t["previous"],
               "plain_ms": plain_ms, "plain_device": "cpu",
               "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": "bytes", "bytes": moved}
        recs.append(rec)
        print(f"[15] secretion, {n_lanes} x {n} agents into {v} voxels: "
              f"kernel {rec['ms']:.4f} ms (turns {t['kernel'][0]:.4f}, "
              f"{t['kernel'][1]:.4f}), first design (sort in the wrapper) "
              f"{rec['previous_design_ms']:.4f} ms in the same call, plain "
              f"(index_add on the CPU, host clock) {plain_ms:.2f} ms, "
              f"index_add_ on the card {lib_ms:.4f} ms, bound "
              f"{bound_ms:.5f} ms (bytes); two card runs, the first design "
              f"and the CPU bit-equal", flush=True)

    # the clustering --pairlist configuration, card ≡ CPU, card ≡ card
    def run(dev):
        sim, st = _clustering_pairlist(dev)
        _reset_counts()
        out, counts = [], []
        for _ in range(CLUSTER_STEPS):
            st = sim.run(st, 1, check_overflow=True)
            counts.append((int(st.stats["rebuilds"]),
                           int(st.stats["rebuild_skips"])))
        return convert.state_to_numpy(st), counts, _read_counts()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)               # as phase 2
    try:
        want, want_counts, _ = run("cpu")
    finally:
        torch.set_num_threads(threads)
    got, got_counts, launches = run("cuda")
    again, again_counts, _ = run("cuda")
    check(got_counts == want_counts, f"[15] rebuild schedule differs: card "
                                     f"{got_counts}, CPU {want_counts}")
    check(launches["secretion"] == CLUSTER_STEPS,
          f"[15] secretion launched {launches['secretion']} times")
    worst = _card_vs_cpu(want, got, "[15] clustering --pairlist")
    for k, w in got["pool"].items():
        check(np.array_equal(again["pool"][k], w), f"[15] two card runs "
                                                   f"differ in {k}")
    check(np.array_equal(again["conc"], got["conc"]), "[15] two card runs "
                                                      "differ in the grid")
    check(again_counts == got_counts, "[15] two card runs rebuild apart")
    rebuilds = sum(r for r, _ in got_counts)
    check(0 < rebuilds < CLUSTER_STEPS, f"[15] rebuilds {rebuilds}")
    sim, st = _clustering_pairlist("cuda")
    st = sim.run(st, 2)
    _, prof = profile_steps(sim, st, PROFILED_STEPS)
    ranges = {k: prof["ranges"].get(k, {"device_ms": 0.0, "launches": 0.0})
              for k in ("step/secretion", "step/pairlist_build")}
    rec = {"kernel": recs, "clustering": {
        "agents": CLUSTER_AGENTS, "steps": CLUSTER_STEPS,
        "rebuilds": rebuilds, "rebuild_skips": CLUSTER_STEPS - rebuilds,
        "launches": launches, "max_abs_diff_vs_cpu": worst,
        "card_runs_bit_equal": True,
        "profiled": {"steps": PROFILED_STEPS,
                     "ms_per_step": prof["ms_per_step_profiled"],
                     "device_busy_ms": prof["device_busy_ms"],
                     "device_idle_share": prof["device_idle_share"],
                     "device_ops_per_step": prof["launches"],
                     "rebuilds": prof["rebuilds"], "ranges": ranges}}}
    print(f"[15] clustering --pairlist profiled ({PROFILED_STEPS} steps, "
          f"{prof['rebuilds']} rebuilds): {prof['ms_per_step_profiled']:.3f} "
          f"ms/step, busy {prof['device_busy_ms']:.3f} ms, idle share "
          f"{prof['device_idle_share']:.3f}; step/secretion "
          f"{ranges['step/secretion']['device_ms']:.4f} ms in "
          f"{ranges['step/secretion']['launches']:.0f} device ops, "
          f"step/pairlist_build "
          f"{ranges['step/pairlist_build']['device_ms']:.4f} ms per step",
          flush=True)
    report["secretion"] = rec
    print(f"[15] clustering --pairlist, {CLUSTER_AGENTS} agents x "
          f"{CLUSTER_STEPS} steps: card ≡ CPU (rebuilds {rebuilds}, skips "
          f"{CLUSTER_STEPS - rebuilds}, equal; integers and stats equal; "
          f"max|Δ| {worst}); two card runs bit-equal, pools and grids; "
          f"secretion launches {launches['secretion']}", flush=True)
    return rec


def _clustering_pairlist(device):
    """examples/cell_clustering.py --pairlist: 4,000 agents secreting and
    climbing a 32³ diffusion grid, with contact forces from a skin-1.5 pair
    list reused under every_k (k 8, displacement bound 0.75), seed 4."""
    import numpy as np
    from repro_torch.core import (Chemotaxis, DiffusionSpec, EngineConfig,
                                  ForceParams, PairListConfig, RebuildPolicy,
                                  Secretion, Simulation)
    skin, n, side = 1.5, CLUSTER_AGENTS, 64.0
    cfg = EngineConfig(
        capacity=n, domain_lo=(0, 0, 0), domain_hi=(side,) * 3,
        interaction_radius=3.0, query_chunk=4096,
        diffusion=DiffusionSpec(dims=(32, 32, 32), coefficient=0.5,
                                decay=0.01, voxel=2.0),
        use_forces=True, force=ForceParams(max_displacement=0.25),
        rebuild=RebuildPolicy(mode="every_k", k=8,
                              displacement_bound=skin / 2),
        pairlist=PairListConfig(skin=skin, max_pairs=64))
    sim = Simulation(cfg, [Secretion(rate=2.0), Chemotaxis(speed=0.35)],
                     device=device)
    pos = np.random.default_rng(4).uniform(4, side - 4, (n, 3)).astype(
        np.float32)
    return sim, sim.init_state(pos, diameter=np.full(n, 2.0, np.float32))


# ---------------------------------------------------------------------------
# Phases 16-18: the capacity ladder, narrowed dtypes, the supervised CLI
# ---------------------------------------------------------------------------

def _growth_ladder(device, cls=None):
    """benchmarks/capacity.py's growth scenario, unchanged: 1,000 seeds in
    a 512³ domain (radius 4, no forces, max_per_box 8), lean dtypes,
    GrowDivide + RandomWalk, the ladder from capacity 1,024."""
    import numpy as np
    from repro_torch.core import (CapacityLadder, DtypePolicy, EngineConfig,
                                  GrowDivide, LadderConfig, RandomWalk)
    n_seed = 1000
    cfg = EngineConfig(
        capacity=max(1024, n_seed), domain_lo=(0.0, 0.0, 0.0),
        domain_hi=(GROWTH_SIDE,) * 3, interaction_radius=4.0, dt=1.0,
        use_forces=False, max_per_box=8, query_chunk=8192,
        dtypes=DtypePolicy(aux_float="bfloat16", compact_ints=True))
    behaviors = [GrowDivide(rate=0.55, threshold_diameter=6.0),
                 RandomWalk(sigma=0.6)]
    lad = (cls or CapacityLadder)(cfg, behaviors,
                                  LadderConfig(growth_factor=2.0),
                                  device=device)
    rng = np.random.default_rng(0)
    pos = rng.uniform(4.0, GROWTH_SIDE - 4.0, (n_seed, 3)).astype(np.float32)
    return lad, lad.init_state(pos, diameter=np.full(n_seed, 5.0,
                                                     np.float32))


def _rung_schedule(rungs) -> list:
    return [(r["iteration"], r["field"], r["old"], r["new"]) for r in rungs]


def _step_ints(stats) -> list:
    """n_live, births and deaths of a step, in one host read."""
    import torch
    return torch.stack([stats[f] for f in ("n_live", "births",
                                           "deaths")]).tolist()


def _growth_to(device, target: int, max_steps: int):
    """The growth scenario stepped until ``target`` live agents: per-step
    integers, the rung schedule and the final live state on the host."""
    lad, st = _growth_ladder(device)
    ints = []
    for _ in range(max_steps):
        st = lad.step(st)
        ints.append(_step_ints(st.stats))
        if ints[-1][0] >= target:
            break
    return {"ints": ints, "rungs": _rung_schedule(lad.rungs),
            "live": _live_host(st.pool)}


def _live_host(pool) -> dict:
    """The live agents' channels on the host (bf16 as float32: exact)."""
    a = pool.alive
    return {k: v[a].float().cpu().numpy() if v.dtype.is_floating_point
            else v[a].cpu().numpy()
            for k, v in pool.channels().items() if k != "alive"}


def _max_nearest(a, b, device: str = "cuda") -> float:
    """The larger of the two one-sided nearest-neighbour distances between
    two point sets (their Hausdorff distance), on the card in chunks: a
    comparison that needs no agent order, which an ulp's difference in a
    position can change through the grid sort."""
    import torch
    a = torch.as_tensor(a, device=device)
    b = torch.as_tensor(b, device=device)

    def one_sided(p, q):
        worst = 0.0
        for i in range(0, p.shape[0], 2048):
            d = torch.cdist(p[i:i + 2048].double(), q.double())
            worst = max(worst, float(d.min(1).values.max()))
        return worst
    return max(one_sided(a, b), one_sided(b, a))


def _same_live_sets(want: dict, got: dict, atol: float, what: str,
                    exact=("diameter", "agent_type", "born_iter")) -> float:
    """Live populations equal as sets: equal counts, the ``exact``
    channels equal as multisets, positions within ``atol`` of a partner
    (both ways). Returns the position residue."""
    import numpy as np
    check(len(want["position"]) == len(got["position"]),
          f"{what}: live counts differ")
    for k in exact:
        check(np.array_equal(np.sort(want[k]), np.sort(got[k])),
              f"{what}: {k} differs")
    err = _max_nearest(want["position"], got["position"])
    check(err <= atol, f"{what}: positions differ by {err:.3g} > {atol}")
    return err


def _cpu_worker(out: str) -> int:
    """The CPU halves of phases 16-18, run beside the card phases in a child
    process (one torch thread, no CUDA): the growth scenario to its smoke
    target, the CLI's proliferation set-up at PROLIF_CPU_AGENTS under the
    ladder, and the reference's lean scenario."""
    import pickle
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    res = {"growth": _growth_to("cpu", GROWTH_SMOKE_TARGET,
                                GROWTH_MAX_STEPS),
           "prolif": _prolif_lockstep("cpu"),
           "lean": {impl: _lean_run("cpu", impl) for impl in ("k1",
                                                              "streamed")},
           "train_families": _family_parity_runs("cpu")}
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(res, f)
    Path(tmp).rename(out)
    return 0


def _cpu_worker_envs(out: str) -> int:
    """The CPU half of phase 21, in a second child process (one torch
    thread, no CUDA)."""
    import pickle
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_env_scenarios("cpu"), f)
    Path(tmp).rename(out)
    return 0


def _start_cpu_worker(tmpdir: str, flag: str = "--cpu-worker"):
    import os
    out = str(Path(tmpdir) / f"{flag.strip('-')}.pkl")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                             flag, out],
                            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    return proc, out


def _cpu_results(worker) -> dict:
    import pickle
    proc, out = worker
    check(proc.wait(timeout=CPU_WORKER_TIMEOUT_S) == 0,
          f"the CPU worker exited {proc.returncode}")
    with open(out, "rb") as f:
        return pickle.load(f)


def _timed_ladder_cls():
    """A CapacityLadder that times each restage on the card and splits the
    peak device memory by rung (the peak is reset at each restage, so a
    rung's peak covers its restage, its re-run step and its later steps)."""
    import torch
    from repro_torch.core import CapacityLadder

    class TimedLadder(CapacityLadder):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.restages = []

        def _grow(self, new_cfg, prev, iteration):
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            old = (self.config.capacity, self.config.max_per_run)
            t0 = time.perf_counter()
            out = super()._grow(new_cfg, prev, iteration)
            torch.cuda.synchronize()
            self.restages.append({
                "iteration": iteration, "old": old,
                "new": (new_cfg.capacity, new_cfg.max_per_run),
                "ms": (time.perf_counter() - t0) * 1e3,
                "old_rung_peak_bytes": peak})
            return out
    return TimedLadder


def _bytes_per_agent(policy) -> float:
    """benchmarks/capacity.py's measure: a pool's bytes over its slots."""
    from repro_torch.core import make_pool
    pool = make_pool(8, policy=policy, device="cuda")
    return sum(v.numel() * v.element_size()
               for v in pool.channels().values()) / 8.0


def phase_growth(report: dict, cpu) -> dict:
    """Phase 16: the paper-scale growth scenario through the ladder."""
    import torch
    from repro_torch.core import DtypePolicy

    lad, st = _growth_ladder("cuda", _timed_ladder_cls())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(GROWTH_MAX_STEPS):
        t0 = time.perf_counter()
        st = lad.step(st)
        n_live = int(st.stats["n_live"])        # a host read: the step ended
        steps.append({"iteration": i, "n_live": n_live,
                      "rung": (lad.config.capacity, lad.config.max_per_run),
                      "ms": (time.perf_counter() - t0) * 1e3})
        if n_live >= GROWTH_TARGET:
            break
    final_peak = torch.cuda.max_memory_allocated()
    # the last rung's own step time: its only step also ran the rung before
    # and the restage, so two more steps of its Simulation are timed
    # (their results dropped)
    probe_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        int(lad.sim.step(st).stats["n_live"])
        probe_ms.append((time.perf_counter() - t0) * 1e3)
    n_live = steps[-1]["n_live"]
    check(n_live >= GROWTH_TARGET, f"growth reached {n_live} live agents in "
                                   f"{len(steps)} steps, not "
                                   f"{GROWTH_TARGET}")
    check(lad.config.capacity > 1024 and any(
        r["field"] == "capacity" for r in lad.rungs),
        "the capacity did not grow through the ladder")
    alive = st.pool.alive
    check(bool(alive[:n_live].all()) and not bool(alive[n_live:].any()),
          "the live prefix is not compact")
    check(bool(torch.isfinite(st.pool.position[:n_live]).all()),
          "non-finite positions")
    peaks = {}
    for r in lad.restages:
        peaks[r["old"]] = max(peaks.get(r["old"], 0),
                              r["old_rung_peak_bytes"])
    peaks[steps[-1]["rung"]] = final_peak
    rungs = []
    for rung in dict.fromkeys(s["rung"] for s in steps):
        at = [s for s in steps if s["rung"] == rung]
        warm = [s["ms"] for s in at[1:]] or [at[0]["ms"]]
        grown = [r for r in lad.restages if r["new"] == rung]
        rungs.append({"capacity": rung[0], "max_per_run": rung[1],
                      "steps": len(at), "max_live": max(s["n_live"]
                                                        for s in at),
                      "ms_per_step_median_warm": statistics.median(warm),
                      "restage_ms": sum(r["ms"] for r in grown),
                      "peak_bytes": peaks.get(rung)})
    rec = {"target": GROWTH_TARGET, "steps": len(steps), "n_live": n_live,
           "schedule": _rung_schedule(lad.rungs),
           "restages": lad.recompiles,
           "bytes_per_agent": {"float32": _bytes_per_agent(DtypePolicy()),
                               "lean": _bytes_per_agent(DtypePolicy(
                                   aux_float="bfloat16",
                                   compact_ints=True))},
           "rungs": rungs, "last_rung_probe_ms": probe_ms,
           "ms_total": sum(s["ms"] for s in steps)}
    print(f"[16] growth: {n_live} live agents after {len(steps)} steps "
          f"(target {GROWTH_TARGET}), {lad.recompiles} restages, capacity "
          f"1024 -> {lad.config.capacity}, bytes/agent "
          f"{rec['bytes_per_agent']}", flush=True)
    print(f"[16] rung schedule {rec['schedule']}", flush=True)
    print(f"[16] the last rung's Simulation alone: {probe_ms[0]:.2f}, "
          f"{probe_ms[1]:.2f} ms/step (two steps timed after the run)",
          flush=True)
    for r in rungs:
        peak = r["peak_bytes"]
        print(f"[16] rung capacity {r['capacity']} max_per_run "
              f"{r['max_per_run']}: {r['steps']} steps, max live "
              f"{r['max_live']}, median warm "
              f"{r['ms_per_step_median_warm']:.2f} ms/step, restage "
              f"{r['restage_ms']:.2f} ms, peak "
              f"{'-' if peak is None else f'{peak / 2**30:.3f} GiB'}",
              flush=True)
    # the smoke override: the same scenario to GROWTH_SMOKE_TARGET, card
    # ≡ CPU (the CPU run is the worker's)
    got = _growth_to("cuda", GROWTH_SMOKE_TARGET, GROWTH_MAX_STEPS)
    want = cpu["growth"]
    check(got["rungs"] == want["rungs"], f"growth to "
          f"{GROWTH_SMOKE_TARGET}: rung schedule on the card "
          f"{got['rungs']} != on the CPU {want['rungs']}")
    check(got["ints"] == want["ints"], "growth: per-step n_live, births or "
                                       "deaths differ")
    err = _same_live_sets(want["live"], got["live"], 1e-4,
                          f"growth to {GROWTH_SMOKE_TARGET}")
    rec["smoke"] = {"target": GROWTH_SMOKE_TARGET, "steps": len(got["ints"]),
                    "schedule": got["rungs"], "position_residue": err}
    print(f"[16] growth to {GROWTH_SMOKE_TARGET} on the card ≡ on the CPU: "
          f"{len(got['ints'])} steps, rung schedule equal, per-step "
          f"integers equal, live sets equal (positions within {err:.3g})",
          flush=True)
    report["growth"] = rec
    return rec


def _digest(pool) -> str:
    """sha256 of the lexsorted live positions, diameters and types, and
    the live count."""
    import hashlib
    import numpy as np
    live = _live_host(pool)
    p = live["position"]
    o = np.lexsort(p.T)
    h = hashlib.sha256()
    for a in (p[o], live["diameter"][o], live["agent_type"][o],
              np.int64(len(p))):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _map_load(cfg, spec, pool) -> dict:
    """K1's column map for ``pool``, from the plain version (no counted
    launch): the most column blocks any row block lists at the engine's
    maxb 64 and span 8, and unbounded (maxb 1024, span 64: the need); the
    densest box and 3-box run."""
    import torch
    from repro_torch.core import engine as eng, morton
    from repro_torch.kernels import ops
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32,
                          device=pool.device)
    res = eng.build_env(cfg, spec, pool, origin, cfg.cell_size)
    p, g = res.pool, res.grid
    _, cols, ovf, mask = ops.k1_inputs_plain(
        p.position, p.diameter, p.agent_type, p.alive, p.alive, g.starts,
        g.counts, origin, cfg.cell_size, spec.dims)
    cells = morton.cell_of(torch.nn.functional.pad(
        p.position, (0, 0, 0, mask.shape[0] - p.position.shape[0])),
        origin, cfg.cell_size, spec.dims)
    need, _ = ops.build_block_cols_plain(cells, g.starts, g.counts, mask,
                                         spec.dims, 1024, 64)
    _, span_ovf = ops.build_block_cols_plain(cells, g.starts, g.counts,
                                             mask, spec.dims, 1024)
    return {"max_cols": int((cols >= 0).sum(1).max()),
            "maxb": int(cols.shape[1]), "overflow": bool(ovf),
            "need_cols": int((need >= 0).sum(1).max()),
            "span_overflow": bool(span_ovf), "box_max": int(g.max_count),
            "run_max": int(g.max_run_count)}


_KILL_CHILD = """
import os, signal, sys, time
sys.path.insert(0, os.path.join(sys.argv[1], "src"))
from repro_torch.core import CapacityLadder, SupervisedRunner
from repro_torch.launch import simulate
from repro_torch.train import checkpoint
ckpt, n, steps, every, kill_at = sys.argv[2], *map(int, sys.argv[3:7])
sim, st = simulate.build("proliferation", n, device="cuda")

def hook(it, state):
    if it == kill_at:
        # the kill comes after the checkpoint before it is on disk
        t0 = time.time()
        while checkpoint.latest_step(ckpt) != kill_at // every * every:
            if time.time() - t0 > 120:
                sys.exit("the checkpoint never landed")
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGKILL)
    return None

runner = SupervisedRunner(CapacityLadder(sim.config, sim.behaviors,
                                         device="cuda"),
                          ckpt, checkpoint_every=every, fault_hook=hook)
runner.run(st, steps)
print("survived")
"""


def _print_load(tag: str, ld: dict) -> None:
    print(f"{tag} column map at iteration {ld['iteration']} (capacity "
          f"{ld['capacity']}, max_per_run {ld['max_per_run']}): at most "
          f"{ld['max_cols']} of maxb {ld['maxb']} column blocks a row block "
          f"(unbounded: {ld['need_cols']}; a run beyond span 8 blocks: "
          f"{ld['span_overflow']}), densest box {ld['box_max']}, densest "
          f"run {ld['run_max']}", flush=True)


def _child(args: list, timeout: float = 600):
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable] + args, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _prolif_lockstep(device, before_step=None) -> dict:
    """The CLI's proliferation set-up at PROLIF_CPU_AGENTS under the
    ladder for PROLIF_CPU_STEPS steps: per-step integers, live sets every
    10 steps and at the end, the rung schedule. ``before_step(i, ladder,
    state)`` sees each step's input."""
    from repro_torch.core import CapacityLadder
    from repro_torch.launch import simulate
    sim, st = simulate.build("proliferation", PROLIF_CPU_AGENTS,
                             device=device)
    lad = CapacityLadder(sim.config, sim.behaviors, device=device)
    ints, snaps = [], {}
    for i in range(PROLIF_CPU_STEPS):
        if before_step is not None:
            before_step(i, lad, st)
        st = lad.step(st)
        ints.append(_step_ints(st.stats))
        if (i + 1) % 10 == 0 or i + 1 == PROLIF_CPU_STEPS:
            snaps[i + 1] = _live_host(st.pool)
    return {"ints": ints, "snaps": snaps, "rungs": _rung_schedule(lad.rungs)}


def phase_supervised_cli(report: dict, cpu, tmpdir: str) -> dict:
    """Phase 17: the CLI's --supervised proliferation run with K1."""
    import torch
    from repro_torch import convert
    from repro_torch.core import (CapacityLadder, Simulation,
                                  SupervisedRunner, restore_state)
    from repro_torch.launch import simulate

    n, steps, every = PROLIF_AGENTS, PROLIF_STEPS, PROLIF_EVERY
    # (a) the uninterrupted run, as the CLI sets it up
    sim, st0 = simulate.build("proliferation", n, device="cuda")
    pos0 = st0.pool.position[:n].cpu().numpy()
    dia0 = st0.pool.diameter[:n].cpu().numpy()
    lad = CapacityLadder(sim.config, sim.behaviors, device="cuda")
    loads, seen = [], [None]

    def observe(it, state):                  # the column map at each rung
        rung = (lad.config.capacity, lad.config.max_per_run)
        if rung != seen[0]:
            seen[0] = rung
            loads.append({"iteration": it, "capacity": rung[0],
                          "max_per_run": rung[1],
                          **_map_load(lad.config, lad.sim.spec, state.pool)})
        return None

    ck_a = str(Path(tmpdir) / "supervised_a")
    runner = SupervisedRunner(lad, ck_a, checkpoint_every=every,
                              fault_hook=observe)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    st, run_report = runner.run(st0, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    last = {"iteration": steps, "capacity": lad.config.capacity,
            "max_per_run": lad.config.max_per_run,
            **_map_load(lad.config, lad.sim.spec, st.pool)}
    n_live = int(st.stats["n_live"])
    executed = steps + lad.recompiles
    print(f"[17a] supervised proliferation, {n} agents x {steps} steps: "
          f"n_live {n_live}, {wall * 1e3 / steps:.2f} ms/step (checkpoints "
          f"and restages included), rung schedule "
          f"{_rung_schedule(lad.rungs)}", flush=True)
    print("[17a] run report: " + json.dumps(run_report.to_dict()),
          flush=True)
    print(f"[17a] steps executed {executed} ({steps} + {lad.recompiles} "
          f"re-run after a grow); K1 launches "
          f"{launches['k1_collision_force']}, column-map launches "
          f"{launches['k1_column_map']}", flush=True)
    for ld in loads + [last]:
        _print_load("[17a]", ld)
    check(run_report.completed and run_report.retries == 0,
          f"the supervised run did not complete cleanly: "
          f"{run_report.to_dict()}")
    check(n_live == n * 4, f"two division waves should give {n * 4} live "
                           f"agents, not {n_live}")
    for name in ("k1_collision_force", "k1_column_map"):
        check(launches[name] == executed, f"{name} launched "
                                          f"{launches[name]} times in "
                                          f"{executed} executed steps")
    digest = _digest(st.pool)
    # the next iteration overflows K1's column map, which the ladder's
    # max_per_run rungs cannot clear: the reference's limit, mirrored
    final_cfg = lad.config
    overflow = None
    try:
        lad.step(st)
    except RuntimeError as e:               # checked just below
        overflow = str(e)
    check(overflow is not None and "still overflowing" in overflow,
          f"iteration {steps} did not overflow K1's column map: {overflow}")
    check(last["need_cols"] > last["maxb"] or last["span_overflow"],
          "the overflow at the next iteration is not K1's column map")
    print(f"[17a] iteration {steps} overflows K1's column map ({overflow}): "
          f"it needs {last['need_cols']} column blocks a row block against "
          f"maxb {last['maxb']} (a run beyond span 8 blocks: "
          f"{last['span_overflow']}); densest box {last['box_max']}, densest "
          f"run {last['run_max']} agents", flush=True)

    # (b) SIGKILL at iteration PROLIF_KILL_AT, then --resume through the CLI
    ck_b = str(Path(tmpdir) / "supervised_b")
    killed = _child(["-c", _KILL_CHILD, str(ROOT), ck_b, str(n), str(steps),
                     str(every), str(PROLIF_KILL_AT)])
    check(killed.returncode == -9 and "survived" not in killed.stdout,
          f"the killed run exited {killed.returncode}: "
          f"{killed.stderr[-2000:]}")
    resumed = _child(["-m", "repro_torch.launch.simulate", "--scenario",
                      "proliferation", "--agents", str(n), "--iterations",
                      str(steps - every), "--supervised", "--resume",
                      "--ckpt-dir", ck_b, "--checkpoint-every", str(every)])
    check(resumed.returncode == 0, f"the resumed run exited "
                                   f"{resumed.returncode}: "
                                   f"{resumed.stderr[-2000:]}")
    check(f"at iteration {every}" in resumed.stdout,
          f"the resume did not start at iteration {every}: "
          f"{resumed.stdout[-2000:]}")
    line = [ln for ln in resumed.stdout.splitlines()
            if ln.startswith("run report: ")][-1]
    st_b, _ = restore_state(ck_b, sim.config, sim.behaviors, device="cuda")
    check(int(st_b.iteration) == steps, "the resumed run's last checkpoint "
                                        "is not its last step")
    check(_digest(st_b.pool) == digest, "the SIGKILL-resumed run differs "
                                        "from the uninterrupted run")
    print(f"[17b] killed at iteration {PROLIF_KILL_AT} (exit "
          f"{killed.returncode}), resumed through the CLI from iteration "
          f"{every}: final live state equal bit for bit ({digest[:16]}); "
          f"resumed {line}", flush=True)

    # (c) ladder ≡ a Simulation pre-sized at the final rungs
    pre = Simulation(final_cfg, sim.behaviors, device="cuda")
    st_c = pre.run(pre.init_state(pos0, diameter=dia0), steps,
                   check_overflow=True)
    check(_digest(st_c.pool) == digest, "the pre-sized run differs from "
                                        "the ladder run")
    print(f"[17c] pre-sized at capacity {final_cfg.capacity}, max_per_run "
          f"{final_cfg.max_per_run}: final live state equal bit for bit",
          flush=True)

    # (d) card ≡ CPU at PROLIF_CPU_AGENTS (the free-running CPU run is the
    # worker's); one-step checks from the card's state at PROLIF_RESYNC
    one_step = {}

    def resync(i, ladder, state):
        if i in PROLIF_RESYNC:
            sim_c = Simulation(ladder.config, ladder.behaviors, device="cpu")
            want = _cpu_step(sim_c, state)
            got = convert.state_to_numpy(ladder.sim.step(state))
            one_step[i] = max(_card_vs_cpu(want, got, f"step {i}").values())

    got, want = _prolif_lockstep("cuda", resync), cpu["prolif"]
    check(got["rungs"] == want["rungs"], f"rung schedule on the card "
                                         f"{got['rungs']} != on the CPU "
                                         f"{want['rungs']}")
    for i, (g, w) in enumerate(zip(got["ints"], want["ints"])):
        check(g == w, f"step {i}: n_live, births or deaths differ (card "
                      f"{g}, CPU {w})")
    check(any(r[1] == "capacity" for r in got["rungs"]),
          "no capacity rung in the card ≡ CPU run")
    resid = {}
    for k in sorted(want["snaps"]):
        resid[k] = _same_live_sets(want["snaps"][k], got["snaps"][k],
                                   float("inf"), f"step {k}",
                                   exact=("diameter", "born_iter"))
    print(f"[17d] {PROLIF_CPU_AGENTS} agents x {PROLIF_CPU_STEPS} steps "
          f"card ≡ CPU: rung schedule {got['rungs']} equal, n_live/births/"
          f"deaths equal each step (n_live {got['ints'][-1][0]}), diameters "
          f"and birth steps equal as multisets; one step from the card's "
          f"state ≡ the CPU's (integers equal, floats 1e-4) before steps "
          f"{ {k: float(f'{v:.3g}') for k, v in one_step.items()} } (max|Δ|); "
          f"free-running position residue by step "
          f"{ {k: float(f'{v:.3g}') for k, v in resid.items()} }",
          flush=True)
    rec = {"agents": n, "steps": steps, "n_live": n_live,
           "overflow_at": steps, "overflow": overflow,
           "ms_per_step": wall * 1e3 / steps, "executed_steps": executed,
           "launches": launches, "schedule": _rung_schedule(lad.rungs),
           "report": run_report.to_dict(), "column_map": loads + [last],
           "digest": digest, "resumed_equal": True, "presized_equal": True,
           "cpu": {"agents": PROLIF_CPU_AGENTS, "steps": PROLIF_CPU_STEPS,
                   "schedule": got["rungs"], "one_step_max_abs": one_step,
                   "free_running_position_residue": resid}}
    report["supervised_cli"] = rec
    return rec


def _lean_run(device, force_impl: str):
    """tests/test_ladder.py's lean scenario: 200 agents, 6 steps, bf16
    diameters and int16 types; the final state on the host."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.core import (DtypePolicy, EngineConfig, ForceParams,
                                  GrowDivide, Simulation)
    rng = np.random.default_rng(7)
    pos = rng.uniform(4, 60, (200, 3)).astype(np.float32)
    cfg = EngineConfig(capacity=512, domain_lo=(0, 0, 0),
                       domain_hi=(64.0,) * 3, interaction_radius=4.0,
                       dt=0.5, max_per_box=16, query_chunk=256,
                       force=ForceParams(max_displacement=0.5),
                       force_impl=force_impl,
                       dtypes=DtypePolicy(aux_float="bfloat16",
                                          compact_ints=True))
    sim = Simulation(cfg, [GrowDivide(rate=0.25, threshold_diameter=4.5)],
                     device=device)
    st = sim.run(sim.init_state(pos, diameter=np.full(200, 3.0, np.float32)),
                 6, check_overflow=True)
    return convert.state_to_numpy(st)


def phase_narrowed_k1(report: dict, cpu) -> dict:
    """Phase 18: K1 on a narrowed pool, and the lean scenario card ≡ CPU."""
    import numpy as np
    import torch
    from repro_torch.core import DtypePolicy, Simulation
    from repro_torch.core import engine as eng
    from repro_torch.kernels import ops
    from repro_torch.launch import simulate

    n = MAIN_AGENTS
    recs = {}
    for aux in ("bfloat16", "float16"):
        sim, _ = simulate.build("proliferation", n, "fig6", device="cuda")
        cfg = dataclasses.replace(sim.config, dtypes=DtypePolicy(
            aux_float=aux, compact_ints=True))
        sim = Simulation(cfg, sim.behaviors, device="cuda")
        rng = np.random.default_rng(0)
        side = cfg.domain_hi[0]
        pos = rng.uniform(2.0, side - 2.0, (n, 3)).astype(np.float32)
        st = sim.init_state(pos, diameter=rng.uniform(2.0, 4.0, n).astype(
            np.float32), agent_type=rng.integers(0, 3, n).astype(np.int32))
        origin = torch.tensor(cfg.domain_lo, dtype=torch.float32,
                              device="cuda")
        res = eng.build_env(cfg, sim.spec, st.pool, origin, cfg.cell_size)
        p, g = res.pool, res.grid
        check(p.diameter.dtype == getattr(torch, aux)
              and p.agent_type.dtype == torch.int16, "pool not narrowed")
        label = f"[18] {aux} diameters, int16 types, {n} agents:"
        cm_rec, (data_t, cols, _, _) = _column_map_vs_plain(
            label, cfg, sim.spec, p, g, origin, p.alive)
        wide = dataclasses.replace(p, diameter=p.diameter.float(),
                                   agent_type=p.agent_type.int())
        ref = ops.k1_inputs(wide.position, wide.diameter, wide.agent_type,
                            wide.alive, wide.alive, g.starts, g.counts,
                            origin, cfg.cell_size, sim.spec.dims)
        check(torch.equal(ref[0], data_t) and torch.equal(ref[1], cols),
              f"{aux}: the pack of the narrowed pool differs from the "
              f"float32 pool's")
        recs[aux] = {"column_map": cm_rec,
                     "k1": _k1_vs_plain(label, data_t, cols, cfg)}
    lean = {}
    for impl in ("k1", "streamed"):
        got = _lean_run("cuda", impl)
        worst = _card_vs_cpu(cpu["lean"][impl], got, f"lean {impl}")
        lean[impl] = {"max_abs_diff": worst,
                      "n_live": int(got["stats"]["n_live"])}
        print(f"[18] lean scenario (200 agents, 6 steps, bf16/int16), "
              f"force_impl {impl}: card ≡ CPU, n_live "
              f"{lean[impl]['n_live']}, max|Δ| "
              f"{ {k: float(f'{v:.3g}') for k, v in worst.items() if v} }",
              flush=True)
    rec = {"agents": n, "pools": recs, "lean": lean}
    report["narrowed_k1"] = rec
    return rec


# ---------------------------------------------------------------------------
# Phases 19-22: the non-resident environments, the Morton sort and K1's
# slot-order wrapper
# ---------------------------------------------------------------------------

# benchmarks/neighbor.py:35-60 scaled to 1,048,576 agents at its density
# (30,000 in 130³): side 425.0, dims 107³; the oracle at 65,536 (side
# 168.7, dims 43³: the O(N²) brute force is cut there)
FIG11 = dict(agents=1_048_576, side=425.0, dims=(107,) * 3)
FIG11_ORACLE = dict(agents=65_536, side=168.7, dims=(43,) * 3)
FIG11_REF_ERR = 2e-6               # benchmarks/neighbor.py's oracle bound
# benchmarks/optimizations.py:36-58 'cluster' scaled to 1,048,576 agents
# (20,000 in 120³): side 449.1; brute force at 65,536 (side 178.2)
FIG9_AGENTS, FIG9_SIDE, FIG9_STEPS = 1_048_576, 449.1, 10
FIG9_BRUTE_AGENTS, FIG9_BRUTE_SIDE, FIG9_BRUTE_STEPS = 65_536, 178.2, 3
ENV_SCENARIO_AGENTS, ENV_SCENARIO_STEPS = 1000, 2       # phase 21
NON_RESIDENT_ENVS = ("scatter_grid", "hash_grid", "brute_force")


def _fig11_envs(n: int, side: float, dims, device: str = "cuda"):
    """benchmarks/neighbor.py's set-up at ``n`` agents: the pool, the spec
    and, per environment, its build and its force search as closures."""
    import numpy as np
    import torch
    from repro_torch.core import agents
    from repro_torch.core import grid as G
    from repro_torch.core.forces import ForceParams, make_force_pair_fn

    rng = np.random.default_rng(3)
    pos = rng.uniform(2.0, side - 2.0, (n, 3)).astype(np.float32)
    pool = agents.make_pool(n, position=pos, diameter=np.full(n, 3.0,
                                                              np.float32),
                            device=device)
    spec = G.GridSpec(dims=dims, max_per_box=32, max_per_run=32,
                      query_chunk=4096)
    origin = torch.zeros(3, device=device)
    box = 4.0
    ch = {k: v for k, v in pool.channels().items()
          if not k.startswith("extra.")}
    pair = make_force_pair_fn(ForceParams())
    out = {"force": ((3,), torch.float32), "force_nnz": ((), torch.int32)}
    all_idx = torch.arange(n, dtype=torch.int32, device=device)
    builders = {name: G.make_builder(spec, method=m) for name, m in (
        ("resident", "resident"), ("sorted", "sorted"),
        ("scatter", "scatter"), ("hash", "hash"))}

    def build(name):
        return builders[name](pool, origin, box)

    def unsort(res, order):
        o = order.to(torch.int64)
        return {k: torch.zeros_like(v).index_copy_(0, o, v)
                for k, v in res.items()}

    def search(name, b):
        if name == "resident":
            rch = {k: v for k, v in b.pool.channels().items()
                   if not k.startswith("extra.")}
            return unsort(G.resident_apply(spec, b.grid, rch, b.pool.alive,
                                           pair, out), b.order)
        if name == "sorted":
            return G.neighbor_apply(spec, b.grid, ch, all_idx, n, pair, out)
        if name == "scatter":
            def cand(q_pos, q_slot):
                ids, valid = G.scatter_grid_candidates(spec, b.grid, q_pos)
                return ids, valid & (ids != q_slot[:, None])
            return G.chunk_apply(ch, ch, all_idx, n, cand, pair, out,
                                 spec.query_chunk, 27 * spec.max_per_box)
        if name == "hash":
            def phase(q_pos, q_slot, j):
                ids, valid = G.hash_grid_probe(spec, b.grid, q_pos, j)
                return ids, valid & (ids != q_slot[:, None])
            return G.phased_chunk_apply(
                ch, ch, all_idx, n, phase, 27, pair, out, spec.query_chunk,
                G.HASH_K_MULT * spec.max_per_box)

        def wide(q_pos, q_slot):                           # "hash_wide"
            ids, valid = G.hash_grid_candidates(spec, b.grid, q_pos)
            return ids, valid & (ids != q_slot[:, None])
        return G.chunk_apply(ch, ch, all_idx, n, wide, pair, out,
                             spec.query_chunk,
                             27 * G.HASH_K_MULT * spec.max_per_box)

    def oracle():
        return G.brute_force_apply(ch, pool.alive, pair, out, chunk=4096)
    return spec, build, search, oracle


def phase_fig11(report: dict) -> dict:
    """[19] Fig 11 on the card: build and search of each environment at
    1,048,576 agents; exactness against brute force at 65,536."""
    import torch
    from repro_torch.core import grid as G
    from repro_torch.device import card_description
    card = card_description()
    envs = ("resident", "sorted", "scatter", "hash", "hash_wide")
    f = FIG11
    spec, build, search, _ = _fig11_envs(f["agents"], f["side"],
                                         f["dims"])
    rec = {"agents": f["agents"], "side": f["side"], "dims": f["dims"],
           "card": card, "build": {}, "search": {}}
    builds = {}
    for name in envs:
        bname = "hash" if name == "hash_wide" else name
        if bname not in builds:
            ev, host = _both_clocks(lambda: build(bname), 5)
            rec["build"][bname] = {"ms": ev, "host_ms": host}
            builds[bname] = build(bname)
        b = builds[bname]
        iters = 3 if name in ("resident", "sorted") else 1
        ev, host = _both_clocks(lambda: search(name, b), iters)
        rec["search"][name] = {"ms": ev, "host_ms": host}
        bt = rec["build"][bname]
        print(f"[19] Fig 11, {f['agents']} agents, {name}: build "
              f"{bt['ms']:.3f} ms (host {bt['host_ms']:.3f}), search "
              f"{ev:.3f} ms (host {host:.3f}), total "
              f"{bt['ms'] + ev:.3f} ms; {card}", flush=True)
    u, h, s = builds["resident"], builds["hash"], builds["scatter"]
    rec["max_run_count"] = int(u.grid.max_run_count)
    rec["run_capacity"] = spec.run_capacity
    rec["max_bucket_count"] = int(h.grid.max_bucket_count)
    rec["bucket_cap"] = G.HASH_K_MULT * spec.max_per_box
    rec["max_box_count"] = int(s.demand)
    print(f"[19] max_run_count {rec['max_run_count']} (cap "
          f"{rec['run_capacity']}), max_bucket_count "
          f"{rec['max_bucket_count']} (cap {rec['bucket_cap']}), fullest "
          f"box {rec['max_box_count']} (scatter table {spec.max_per_box})",
          flush=True)
    check(rec["max_run_count"] <= rec["run_capacity"],
          "Fig-11 uniform grid overflows its runs")
    del builds, u, h, s

    o = FIG11_ORACLE
    spec, build, search, oracle = _fig11_envs(o["agents"], o["side"],
                                              o["dims"])
    want = oracle()
    errs = {}
    for name in envs:
        b = build("hash" if name == "hash_wide" else name)
        check(int(b.overflow) == 0, f"Fig-11 oracle set-up: {name} "
                                    f"overflows ({int(b.demand)})")
        got = search(name, b)
        err = float((got["force"] - want["force"]).abs().max())
        nnz_eq = bool(torch.equal(got["force_nnz"], want["force_nnz"]))
        check(err <= FORCE_ATOL and nnz_eq,
              f"Fig-11 {name} vs brute force: max|Δf| {err:.3g}, nnz equal "
              f"{nnz_eq}")
        errs[name] = err
        print(f"[19] {name} ≡ brute force at {o['agents']} agents: max|Δf| "
              f"{err:.3g} (bound {FORCE_ATOL:g}; benchmarks/neighbor.py "
              f"holds its resident grid to {FIG11_REF_ERR:g}), nnz equal",
              flush=True)
    ev, host = _both_clocks(oracle, 1, warmup=0)
    rec["oracle"] = {**o, "max_abs_err": errs, "brute_force_ms": ev,
                     "brute_force_host_ms": host,
                     "nnz_pairs": int(want["force_nnz"].sum())}
    print(f"[19] brute force at {o['agents']} agents: {ev:.1f} ms", flush=True)
    report["fig11"] = rec
    return rec


def _fig9_sim(env: str, sort_freq: int, n: int, side: float, device: str,
              force_impl=None):
    """benchmarks/optimizations.py's 'cluster' workload at ``n`` agents."""
    import numpy as np
    from repro_torch.core import EngineConfig, ForceParams
    rng = np.random.default_rng(1)
    cfg = EngineConfig(capacity=n, domain_lo=(0, 0, 0), domain_hi=(side,) * 3,
                       interaction_radius=4.0, dt=0.05, environment=env,
                       sort_frequency=sort_freq, max_per_box=32,
                       query_chunk=4096, force_impl=force_impl,
                       force=ForceParams(max_displacement=0.5))
    pos = rng.uniform(2.0, side - 2.0, (n, 3)).astype(np.float32)
    return cfg, pos, np.full(n, 3.0, np.float32)


def _fig9_run(cfg, pos, dia, steps: int, device: str = "cuda"):
    """A warm-up step, then ``steps`` timed ladder steps (host clock, a
    sync at each step's end); the rungs, launches, peak memory and the
    final pool."""
    import torch
    from repro_torch.core.engine import CapacityLadder
    lad = CapacityLadder(cfg, [], device=device)
    st = lad.step(lad.init_state(pos, diameter=dia))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    stamps = []
    t0 = time.perf_counter()
    for _ in range(steps):
        st = lad.step(st)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    launches = _read_counts()
    ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
    check(st.stats.health_bits() == 0, f"{cfg.environment}: health flags")
    return lad, st, {"ms_per_step": statistics.mean(ms),
                     "ms_per_step_median": statistics.median(ms),
                     "launches_per_step": {k: v / steps for k, v in
                                           launches.items() if v},
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "rungs": list(lad.rungs),
                     "max_per_box": lad.config.max_per_box,
                     "box_demand": int(st.stats["box_demand"])}


def phase_fig9(report: dict) -> dict:
    """[20] the Fig-9 'cluster' workload per environment at 1,048,576
    agents; brute force at 65,536 against the uniform grid."""
    import torch
    from repro_torch.core import Simulation
    from repro_torch.device import card_description
    card = card_description()
    runs = [("scatter_grid", 0, None), ("scatter_grid", 10, None),
            ("hash_grid", 0, None), ("hash_grid", 10, None),
            ("uniform_grid", 0, "streamed"), ("uniform_grid", 0, "k1")]
    rec = {"agents": FIG9_AGENTS, "side": FIG9_SIDE, "steps": FIG9_STEPS,
           "card": card, "runs": {}}
    for env, sf, impl in runs:
        cfg, pos, dia = _fig9_sim(env, sf, FIG9_AGENTS, FIG9_SIDE, "cuda",
                                  impl)
        lad, st, r = _fig9_run(cfg, pos, dia, FIG9_STEPS)
        key = f"{env}/sort{sf}/{cfg.force_impl}"
        k1_calls = r["launches_per_step"].get("k1_collision_force", 0)
        check((k1_calls == 1) == (cfg.force_impl == "k1"),
              f"{key}: K1 launched {k1_calls} times a step")
        prof = _profiled(lad.sim, st, 1)
        r.update({k: prof[k] for k in ("device_ops_per_step",
                                       "device_busy_ms_per_step",
                                       "device_idle_share",
                                       "sweep_device_ms")})
        if env != "uniform_grid":
            # the same run again on the card: equal bit for bit
            _, st2, _ = _fig9_run(cfg, pos, dia, FIG9_STEPS)
            for name, v in st.pool.channels().items():
                check(torch.equal(v, st2.pool.channels()[name]),
                      f"{key}: two card runs differ in {name}")
            r["repeat_bit_equal"] = True
        rec["runs"][key] = r
        print(f"[20] Fig 9 cluster, {FIG9_AGENTS} agents, {key}: "
              f"{r['ms_per_step']:.2f} ms/step (median "
              f"{r['ms_per_step_median']:.2f}), {r['device_ops_per_step']} "
              f"device ops/step, idle {r['device_idle_share']:.3f}, kernel "
              f"launches/step {r['launches_per_step']}, peak "
              f"{r['peak_gb']:.2f} GB, rungs {r['rungs']} (max_per_box "
              f"{r['max_per_box']}, box demand {r['box_demand']})"
              f"{', repeat bit-equal' if env != 'uniform_grid' else ''}; "
              f"{card}", flush=True)
        del lad, st
    # brute force: 3 steps at 65,536, its first step ≡ the uniform grid's
    cfg_b, pos, dia = _fig9_sim("brute_force", 0, FIG9_BRUTE_AGENTS,
                                FIG9_BRUTE_SIDE, "cuda")
    cfg_u = dataclasses.replace(cfg_b, environment="uniform_grid",
                                force_impl="streamed")
    sim_b = Simulation(cfg_b, [], device="cuda")
    sim_u = Simulation(cfg_u, [], device="cuda")
    st0 = sim_b.init_state(pos, diameter=dia)
    one_b, one_u = sim_b.step(st0), sim_u.step(st0)
    worst = 0.0
    for name, v in one_b.pool.channels().items():
        w = one_u.pool.channels()[name]
        if v.dtype.is_floating_point:
            worst = max(worst, float((v - w).abs().max()))
        else:
            check(torch.equal(v, w), f"brute force vs uniform grid: {name}")
    for f in one_b.stats.FIELDS:
        if f not in ("box_overflow", "box_demand"):
            check(int(one_b.stats[f]) == int(one_u.stats[f]),
                  f"brute force vs uniform grid: stats {f}")
    check(worst <= FORCE_ATOL, f"brute force vs uniform grid: {worst:.3g}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sim_b.run(one_b, FIG9_BRUTE_STEPS - 1, check_overflow=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (FIG9_BRUTE_STEPS - 1)
    rec["brute_force"] = {"agents": FIG9_BRUTE_AGENTS,
                          "side": FIG9_BRUTE_SIDE,
                          "steps": FIG9_BRUTE_STEPS, "ms_per_step": ms,
                          "first_step_vs_uniform_max_abs": worst}
    print(f"[20] brute force, {FIG9_BRUTE_AGENTS} agents: first step ≡ the "
          f"uniform grid's (max|Δ| {worst:.3g}, integers and stats equal), "
          f"{ms:.1f} ms/step over {FIG9_BRUTE_STEPS - 1} more steps; {card}",
          flush=True)
    report["fig9"] = rec
    return rec


def _env_scenarios(device: str) -> dict:
    """The five CLI scenarios at ENV_SCENARIO_AGENTS under each
    non-resident environment (sort_frequency 10 where a scenario sets
    none), ENV_SCENARIO_STEPS steps from the initial state; the final
    states on the host."""
    from repro_torch import convert
    from repro_torch.core import Simulation
    from repro_torch.launch import simulate
    out = {}
    for sc in simulate.SCENARIOS:
        sim, st = simulate.build(sc, ENV_SCENARIO_AGENTS, device=device)
        for env in NON_RESIDENT_ENVS:
            sf = sim.config.sort_frequency or 10
            cfg = dataclasses.replace(
                sim.config, environment=env, force_impl="streamed",
                sort_frequency=sf if env != "brute_force" else 0)
            s2 = Simulation(cfg, sim.behaviors, device=device)
            out[(sc, env)] = convert.state_to_numpy(
                s2.run(st, ENV_SCENARIO_STEPS))
    return out


def phase_env_scenarios(report: dict, cpu: dict) -> dict:
    """[21] the five scenarios under scatter, hash and brute force: card ≡
    CPU."""
    got = _env_scenarios("cuda")
    recs = {}
    for (sc, env), g in got.items():
        worst = _card_vs_cpu(cpu[(sc, env)], g, f"{sc} under {env}")
        recs[f"{sc}/{env}"] = {"max_abs_diff": worst,
                               "n_live": int(g["stats"]["n_live"])}
        print(f"[21] {sc} under {env}: {ENV_SCENARIO_STEPS} steps card ≡ "
              f"CPU (n_live {recs[f'{sc}/{env}']['n_live']}); max|Δ| "
              f"{ {k: float(f'{v:.3g}') for k, v in worst.items() if v} }",
              flush=True)
    report["env_scenarios"] = {"agents": ENV_SCENARIO_AGENTS,
                               "steps": ENV_SCENARIO_STEPS, "runs": recs}
    return recs


def phase_k1_slot_order(report: dict) -> dict:
    """[22] K1 in slot order on phase 1's 1,048,576-agent Fig-6 pool,
    shuffled."""
    import torch
    from repro_torch.core import engine as eng
    from repro_torch.device import card_description
    from repro_torch.kernels import collision_force as k1
    from repro_torch.kernels import ops
    from repro_torch.launch import simulate

    n = MAIN_AGENTS
    sim, st = simulate.build("proliferation", n, "fig6", device="cuda")
    cfg, spec = sim.config, sim.spec
    gen = torch.Generator(device="cuda").manual_seed(5)
    perm = torch.randperm(st.pool.capacity, device="cuda", generator=gen)
    pool = st.pool.with_channels({k: v.index_select(0, perm)
                                  for k, v in st.pool.channels().items()})
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32, device="cuda")
    box = cfg.cell_size
    kw = dict(dims=spec.dims, k_rep=cfg.force.k_rep,
              adhesion_band=cfg.force.adhesion_band)
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            pool.alive, origin, box)
    before = k1.collision_force.launches
    f, nnz, ovf = ops.collision_force(*args, **kw)
    check(k1.collision_force.launches == before + 1,
          "the slot-order wrapper did not launch K1")
    pf, pnnz, povf = ops.collision_force_plain(*args, **kw)
    err = float((f - pf).abs().max())
    check(err <= FORCE_ATOL and torch.equal(nnz, pnnz)
          and bool(ovf) == bool(povf) is False,
          f"slot-order K1 vs plain: max|Δf| {err:.3g}")
    res = eng.build_env(cfg, spec, pool, origin, box)
    p, g = res.pool, res.grid

    def resident():
        return ops.collision_force_resident(
            p.position, p.diameter, p.agent_type, p.alive, p.alive,
            g.starts, g.counts, origin, box, **kw)
    rf, rnnz, _ = resident()
    o = res.order.to(torch.int64)
    back_f = torch.zeros_like(rf).index_copy_(0, o, rf)
    back_n = torch.zeros_like(rnnz).index_copy_(0, o, rnnz)
    check(torch.equal(back_f, f) and torch.equal(back_n, nnz),
          "slot-order K1 mapped back differs from the resident call")
    ms_w = cuda_ms(lambda: ops.collision_force(*args, **kw), 10, 2)
    ms_r = cuda_ms(resident, 10, 2)
    card = card_description()
    rec = {"agents": n, "max_abs_err": err, "nnz_equal": True,
           "resident_bit_equal": True, "wrapper_ms": ms_w,
           "resident_ms": ms_r, "nnz_pairs": int(nnz.sum()), "card": card}
    report["k1_slot_order"] = rec
    print(f"[22] K1 in slot order, {n} shuffled Fig-6 agents: kernel ≡ "
          f"plain (max|Δf| {err:.3g}, nnz equal), mapped back ≡ the "
          f"resident call bit for bit; wrapper {ms_w:.4f} ms against the "
          f"resident call's {ms_r:.4f} ms; {card}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# phases 23-25: the ensemble engine and the simulation service
# ---------------------------------------------------------------------------

def _sir_lane_parts():
    """tests/test_ensemble.py's SIR lanes (per-lane β) at capacity
    ENS_SIR_CAP: (config, behaviors)."""
    from repro_torch.core import EngineConfig
    from repro_torch.core.behaviors import Infection, RandomWalk
    cfg = EngineConfig(capacity=ENS_SIR_CAP, domain_lo=(0.0,) * 3,
                       domain_hi=(48.0,) * 3, interaction_radius=3.0,
                       use_forces=False, detect_static=False,
                       query_chunk=1024, max_per_box=32)
    return cfg, [RandomWalk(sigma=0.8),
                 Infection(radius=3.0, beta=lambda ctx: ctx.params["beta"],
                           recovery_time=40)]


def _sir_lane_inputs(seed: int, n: int = ENS_SIR_AGENTS):
    import numpy as np
    r = np.random.RandomState(seed)
    pos = r.uniform(0, 48, (n, 3)).astype(np.float32)
    at = np.zeros((n,), np.int32)
    at[:8] = 1                                          # INFECTED
    timer = np.zeros((n,), np.int32)
    timer[:8] = 40
    return (pos, np.full((n,), 1.0, np.float32), at,
            {"infect_timer": timer})


def _fig6_lane_inputs(n: int, lane: int):
    """The Fig-6 scaling set-up's agents (launch/simulate.py ``--config
    fig6``), drawn from seed ``lane``."""
    import numpy as np
    side = max(40.0, (n ** (1 / 3)) * 4.0)
    pos = np.random.default_rng(lane).uniform(2.0, side - 2.0, (n, 3))
    return pos.astype(np.float32), np.full(n, 3.0, np.float32)


def _solo_core_run(cfg, behaviors, st, params, steps: int, device: str):
    """A lane's solo oracle: the port's iteration core with ``params``."""
    import torch
    from repro_torch.core import make_iteration_core
    core = make_iteration_core(cfg, behaviors, torch.device(device))
    pool, conc, rng, it = st.pool, st.conc, st.rng, st.iteration
    for _ in range(steps):
        pool, conc, rng, _, _ = core(pool, conc, rng, it, None, params)
        it = it + 1
    return pool, rng


def _same_lane(pool, rng, lane, what: str) -> None:
    import torch
    for k, v in pool.channels().items():
        check(torch.equal(v, lane.pool.channels()[k]),
              f"{what}: channel {k} differs from the solo run")
    check(torch.equal(rng, lane.rng), f"{what}: RNG key differs")


def _host_pool(pool):
    """A pool's channels copied to the CPU."""
    return pool.with_channels({k: v.cpu()
                               for k, v in pool.channels().items()})


def _pools_close(card_pool, cpu_pool, what: str) -> float:
    """Integers exact, floats atol/rtol 1e-4 (``cpu_pool`` on the host);
    returns the largest float residue."""
    import numpy as np
    worst = 0.0
    for k, w in cpu_pool.channels().items():
        g = card_pool.channels()[k].cpu().numpy()
        w = w.numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{what}: {k}")
            worst = max(worst, float(np.abs(g - w).max()))
        else:
            check(np.array_equal(g, w), f"{what}: integer channel {k} "
                                        f"differs")
    return worst


def phase_lanes_vs_solo(report: dict) -> dict:
    """[23] (a) the SIR lanes and (b) Fig-6 lanes with K1: every lane ≡
    its solo run on the card bit for bit, one lane ≡ the CPU, K1 and the
    column map once per tick, and both kernels ≡ their plain versions on
    the lanes' inputs."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.core import (EnsembleEngine, ScenarioParams,
                                  Simulation, build_env)
    from repro_torch.core.lanes import Lanes
    from repro_torch.device import card_description
    from repro_torch.kernels import ops
    from repro_torch.launch import simulate

    card = card_description()
    rec = {"card": card}
    # (a) SIR: 8 lanes of 96 agents in capacity 192, per-lane β
    cfg, bs = _sir_lane_parts()
    betas = np.linspace(0.1, 0.5, ENS_SIR_LANES)
    eng = EnsembleEngine(cfg, bs, ENS_SIR_LANES,
                         ScenarioParams.of(beta=0.0), device="cuda")
    st = eng.init_state()
    for lane in range(ENS_SIR_LANES):
        st = eng.admit(st, lane, eng.stage_lane(*_sir_lane_inputs(lane),
                                                seed=lane),
                       ScenarioParams.of(beta=float(betas[lane])))
    _reset_counts()
    for _ in range(ENS_SIR_TICKS):
        st = eng.step(st)
    torch.cuda.synchronize()
    sim = Simulation(cfg, bs, device="cuda")
    for lane in range(ENS_SIR_LANES):
        solo = sim.init_state(*_sir_lane_inputs(lane), seed=lane)
        pool, rng = _solo_core_run(cfg, bs, solo, ScenarioParams.of(
            beta=float(betas[lane])), ENS_SIR_TICKS, "cuda")
        _same_lane(pool, rng, eng.read_lane(st, lane), f"[23a] lane {lane}")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu_lane = 3
        cpu = Simulation(cfg, bs, device="cpu").init_state(
            *_sir_lane_inputs(cpu_lane), seed=cpu_lane)
        cpool, crng = _solo_core_run(cfg, bs, cpu, ScenarioParams.of(
            beta=float(betas[cpu_lane])), ENS_SIR_TICKS, "cpu")
    finally:
        torch.set_num_threads(threads)
    got = eng.read_lane(st, cpu_lane)
    worst_a = _pools_close(got.pool, cpool, "[23a] card lane vs CPU")
    check(torch.equal(got.rng.cpu(), crng), "[23a] card lane RNG vs CPU")
    infected = [int(v) for v in ((st.pool.agent_type == 1)
                                 & st.pool.alive).reshape(
                                     ENS_SIR_LANES, -1).sum(1)]
    rec["sir"] = {"lanes": ENS_SIR_LANES, "agents": ENS_SIR_AGENTS,
                  "capacity": ENS_SIR_CAP, "ticks": ENS_SIR_TICKS,
                  "lanes_equal_solo": True, "cpu_lane": cpu_lane,
                  "cpu_max_abs_diff": worst_a, "infected": infected}
    print(f"[23a] SIR {ENS_SIR_LANES} lanes x {ENS_SIR_AGENTS} agents in "
          f"capacity {ENS_SIR_CAP}, {ENS_SIR_TICKS} ticks: every lane ≡ its "
          f"solo card run bit for bit (keys included); lane {cpu_lane} ≡ "
          f"the CPU (max|Δ| {worst_a:.3g}, integers and key equal); "
          f"infected per lane {infected}; {card}", flush=True)

    # (c) the SIR lanes with forces in the streamed sweep: torch may sum a
    # row's candidates in another order at L·C rows than at C, so floats
    # are held to 1e-4 (integers exact) and bit-equality is reported
    scfg = dataclasses.replace(cfg, use_forces=True, force_impl="streamed")
    seng = EnsembleEngine(scfg, bs, ENS_SIR_LANES,
                          ScenarioParams.of(beta=0.0), device="cuda")
    sst = seng.init_state()
    for lane in range(ENS_SIR_LANES):
        args = _sir_lane_inputs(lane)
        sst = seng.admit(sst, lane, seng.stage_lane(
            args[0], args[1] * 2.5, *args[2:], seed=lane),
            ScenarioParams.of(beta=float(betas[lane])))
    for _ in range(ENS_STREAMED_TICKS):
        sst = seng.step(sst)
    worst_c, bit_equal = 0.0, True
    for lane in range(ENS_SIR_LANES):
        args = _sir_lane_inputs(lane)
        solo = Simulation(scfg, bs, device="cuda").init_state(
            args[0], args[1] * 2.5, *args[2:], seed=lane)
        pool, rng = _solo_core_run(scfg, bs, solo, ScenarioParams.of(
            beta=float(betas[lane])), ENS_STREAMED_TICKS, "cuda")
        got = seng.read_lane(sst, lane)
        check(torch.equal(rng, got.rng), f"[23c] lane {lane} RNG key")
        bit_equal &= all(torch.equal(v, got.pool.channels()[k])
                         for k, v in pool.channels().items())
        worst_c = max(worst_c, _pools_close(got.pool, _host_pool(pool),
                                            f"[23c] lane {lane}"))
    forces = int(sst.pool.force_nnz.sum())
    check(forces > 0, "[23c] no force was computed")
    rec["streamed"] = {"lanes": ENS_SIR_LANES, "ticks": ENS_STREAMED_TICKS,
                       "bit_equal": bit_equal, "max_abs_diff": worst_c,
                       "force_nnz_total": forces}
    print(f"[23c] SIR lanes with forces in the streamed sweep, "
          f"{ENS_STREAMED_TICKS} ticks: every lane ≡ its solo card run "
          f"{'bit for bit' if bit_equal else f'within {worst_c:.3g}'} "
          f"(integers and keys equal; {forces} nonzero pair forces); "
          f"{card}", flush=True)

    # (b) Fig-6 with K1: 16 lanes of 4,096 agents
    n = ENS_K1_AGENTS
    sim, _ = simulate.build("proliferation", n, "fig6", device="cuda")
    cfg, bs, spec = sim.config, sim.behaviors, sim.spec
    ln = Lanes(ENS_K1_LANES, cfg.capacity)
    eng = EnsembleEngine(cfg, bs, ENS_K1_LANES, device="cuda")
    st = eng.init_state()
    for lane in range(ENS_K1_LANES):
        st = eng.admit(st, lane, eng.stage_lane(*_fig6_lane_inputs(n, lane),
                                                seed=lane))
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32, device="cuda")
    res = build_env(cfg, spec, st.pool, origin, cfg.cell_size, ln)
    pool, g = res.pool, res.grid
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            pool.alive, g.starts, g.counts, origin, cfg.cell_size, spec.dims,
            64, None, ln)
    got = ops.k1_inputs(*args)
    torch.cuda.synchronize()
    want = ops.k1_inputs_plain(*args)
    torch.cuda.synchronize()
    for gt, w, what in zip(got, want, ("data_t", "block_cols", "overflow",
                                       "row mask")):
        check(gt.dtype == w.dtype and torch.equal(gt, w),
              f"[23b] lane-aware column map differs from plain in {what}")
    check(tuple(got[2].shape) == (ENS_K1_LANES,) and not bool(got[2].any()),
          "[23b] per-lane column-map overflow")
    label = f"[23b] {ENS_K1_LANES} lanes x {n} agents:"
    ms = cuda_ms(lambda: ops.k1_inputs(*args), iters=20, warmup=3)
    plain_ms = cuda_ms(lambda: ops.k1_inputs_plain(*args), iters=2,
                       warmup=0)
    bound_ms, bound_by, work = column_map_bound(pool.position, g.starts,
                                                got[0], got[1])
    cm = {"n_pad": got[0].shape[1], "equal": True, "max_abs_err": 0.0,
          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, "library_ms": None, **work}
    print(f"{label} lane-aware column map ({ENS_K1_LANES} lanes packed at "
          f"{got[0].shape[1] // ENS_K1_LANES} rows each): kernel {ms:.4f} "
          f"ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); block_cols, per-lane flags, data_t and row mask "
          f"equal", flush=True)
    k1_rec = _k1_vs_plain(label, got[0], got[1], cfg)
    k1_rec["library_ms"] = None

    states = []
    _reset_counts()
    for _ in range(ENS_K1_TICKS):
        states = states[-1:] + [st]
        st = eng.step(st)
    torch.cuda.synchronize()
    launches = _read_counts()
    for name in ("k1_collision_force", "k1_column_map"):
        check(launches[name] == ENS_K1_TICKS,
              f"[23b] {name} launched {launches[name]} times in "
              f"{ENS_K1_TICKS} ticks of {ENS_K1_LANES} lanes, not once a "
              f"tick")
    check(not st.stats.flags(), f"[23b] overflow flags {st.stats.flags()}")
    for lane in range(ENS_K1_LANES):
        solo = sim.init_state(*_fig6_lane_inputs(n, lane), seed=lane)
        for _ in range(ENS_K1_TICKS):
            solo = sim.step(solo)
        _same_lane(solo.pool, solo.rng, eng.read_lane(st, lane),
                   f"[23b] lane {lane}")
    # one lane's last tick on the CPU, from the card's state before it
    cpu_lane = 5
    before = eng.read_lane(states[-1], cpu_lane)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sim_c = Simulation(cfg, bs, device="cpu")
        after = sim_c.step(convert.state_from_numpy(
            convert.state_to_numpy(before), "cpu"))
    finally:
        torch.set_num_threads(threads)
    worst_b = _pools_close(eng.read_lane(st, cpu_lane).pool, after.pool,
                           "[23b] card lane vs CPU")
    n_live = [int(v) for v in st.stats.n_live]
    rec["k1"] = {"lanes": ENS_K1_LANES, "agents": n,
                 "capacity": cfg.capacity, "ticks": ENS_K1_TICKS,
                 "lanes_equal_solo": True, "launches": launches,
                 "launches_per_tick": {
                     k: launches[k] / ENS_K1_TICKS
                     for k in ("k1_collision_force", "k1_column_map")},
                 "cpu_lane": cpu_lane, "cpu_max_abs_diff": worst_b,
                 "n_live": n_live, "column_map": cm, "k1_vs_plain": k1_rec}
    print(f"{label} {ENS_K1_TICKS} ticks: K1 {launches['k1_collision_force']}"
          f" and column map {launches['k1_column_map']} launches (once a "
          f"tick for all lanes); every lane ≡ its solo card run bit for "
          f"bit; lane {cpu_lane}'s last tick ≡ the CPU (max|Δ| "
          f"{worst_b:.3g}, integers equal); live per lane {n_live}; {card}",
          flush=True)
    report["ensemble_lanes"] = rec
    return rec


def _bench_parts(agents: int, kind: str, lanes: int):
    """(config, behaviors, params template, lane inputs(lane)) of
    benchmarks/ensemble.py's set-up (``kind="benchmark"``) or of the
    service CLI's (``"cli"``, launch/sim_serve.py's make_service)."""
    import numpy as np
    from repro_torch.core import EngineConfig, ScenarioParams
    from repro_torch.core.behaviors import Infection, RandomWalk
    from repro_torch.launch import sim_serve
    if kind == "cli":
        side = max(40.0, (agents ** (1 / 3)) * 5)
        svc = sim_serve.make_service(lanes, agents, side, device="cuda")
        betas = np.linspace(0.1, 0.5, lanes)

        def lane_inputs(lane):
            req = sim_serve.make_request(lane, agents, side,
                                         float(betas[lane]), 40, 100)
            return ((req.position, req.diameter, req.agent_type,
                     req.extra_init), req.seed, req.params)
        return (svc.driver.config, svc.driver.behaviors,
                svc.driver.params_template, lane_inputs)
    side = ENS_BENCH_SIDE
    cfg = EngineConfig(capacity=max(64, -(-agents // 64) * 64),
                       domain_lo=(0.0,) * 3, domain_hi=(side,) * 3,
                       interaction_radius=3.0, use_forces=False,
                       detect_static=False, query_chunk=2048, max_per_box=4,
                       sort_impl="argsort")
    bs = [RandomWalk(sigma=0.8),
          Infection(radius=3.0, beta=lambda ctx: ctx.params["beta"],
                    recovery_time=30)]
    betas = np.linspace(0.1, 0.5, lanes)

    def lane_inputs(lane):
        r = np.random.RandomState(100 + lane)
        pos = r.uniform(0, side, (agents, 3)).astype(np.float32)
        types = np.zeros(agents, np.int32)
        n0 = max(agents // 50, 2)
        types[:n0] = 1
        timer = np.zeros(agents, np.int32)
        timer[:n0] = 30
        return ((pos, np.full(agents, 1.0, np.float32), types,
                 {"infect_timer": timer}), 100 + lane,
                ScenarioParams.of(beta=float(betas[lane])))
    return cfg, bs, ScenarioParams.of(beta=0.0), lane_inputs


class _ServingTick:
    """One serving-loop tick, as benchmarks/ensemble.py times it: the
    ensemble step, then a per-lane metric read back (the convergence check
    every real sweep pays; by default the infected count)."""

    def __init__(self, engine, metric=None):
        self.engine = engine
        if metric is not None:
            self.metric = metric

    @staticmethod
    def metric(pool, params):
        return ((pool.agent_type == 1) & pool.alive).sum()

    def step(self, st):
        from repro_torch.serve.sim_service import lane_metrics
        st = self.engine.step(st)
        lane_metrics(self.metric, st).cpu()
        return st


def _host_syncs(fn, calls: int) -> float:
    """Host synchronisations per call of ``fn``: the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")`` (each synchronising copy or
    read it sees), counted over ``calls`` calls."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(calls):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen) / calls


def _serving_ticks(engine, st, ticks: int, metric=None) -> dict:
    """ms per serving tick (host clock, each tick ends in its read-back),
    host syncs per tick, and from profiled ticks the device ops per tick
    and the idle share (launch/profile_step.py's)."""
    import torch
    from repro_torch.launch.profile_step import profile_steps
    runner = _ServingTick(engine, metric)
    for _ in range(3):
        st = runner.step(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        st = runner.step(st)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / ticks
    box = [st]

    def one():
        box[0] = runner.step(box[0])
    syncs = _host_syncs(one, 5)
    st, prof = profile_steps(runner, box[0], 5)
    return {"ms_per_tick": ms, "host_syncs_per_tick": syncs,
            "device_ops_per_tick": prof["launches"],
            "device_busy_ms_per_tick": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "ms_per_tick_profiled": prof["ms_per_step_profiled"]}


def phase_ensemble_throughput(report: dict) -> list:
    """[24] benchmarks/ensemble.py's set-up at 64 agents a lane for 8 and
    64 lanes, and the service CLI's 256 agents a lane at 256 lanes, beside
    the sequential baseline: one lane's step serving each member back to
    back."""
    from repro_torch.core import EnsembleEngine
    from repro_torch.device import card_description
    card = card_description()
    recs = []
    for lanes, agents, kind in ENS_BENCH:
        cfg, bs, tmpl, lane_inputs = _bench_parts(agents, kind, lanes)

        def filled(n_lanes):
            eng = EnsembleEngine(cfg, bs, n_lanes, tmpl, device="cuda")
            st = eng.init_state()
            for lane in range(n_lanes):
                args, seed, params = lane_inputs(lane)
                st = eng.admit(st, lane, eng.stage_lane(*args, seed=seed),
                               params)
            return eng, st
        ens = _serving_ticks(*filled(lanes), ENS_BENCH_TICKS)
        seq = _serving_ticks(*filled(1), ENS_BENCH_TICKS)
        ens_rate = lanes * agents / (ens["ms_per_tick"] * 1e-3)
        seq_rate = agents / (seq["ms_per_tick"] * 1e-3)
        rec = {"set_up": kind, "lanes": lanes, "agents_per_lane": agents,
               "capacity": cfg.capacity, "ticks": ENS_BENCH_TICKS,
               "ensemble": {**ens, "agent_steps_per_s": ens_rate},
               "sequential": {**seq, "agent_steps_per_s": seq_rate},
               "speedup_vs_sequential": ens_rate / seq_rate, "card": card}
        recs.append(rec)
        print(f"[24] {kind} set-up, {lanes} lanes x {agents} agents: "
              f"{ens['ms_per_tick']:.3f} ms/tick, {ens_rate:.4g} "
              f"agent-steps/s, {ens['device_ops_per_tick']:.0f} device "
              f"ops/tick, idle {ens['device_idle_share']:.3f}, "
              f"{ens['host_syncs_per_tick']:.1f} host syncs/tick | "
              f"sequential: {seq['ms_per_tick']:.3f} ms/tick per member, "
              f"{seq_rate:.4g} agent-steps/s, "
              f"{seq['device_ops_per_tick']:.0f} ops, idle "
              f"{seq['device_idle_share']:.3f}, "
              f"{seq['host_syncs_per_tick']:.1f} syncs | speedup "
              f"{rec['speedup_vs_sequential']:.2f}x; {card}", flush=True)
    report["ensemble_throughput"] = recs
    return recs


def _admit_retire_us(lanes: int, agents: int) -> dict:
    """Median µs of ``admit`` and ``retire`` (each ending in a
    synchronise) on the service CLI's engine."""
    import statistics as stats_mod
    import torch
    from repro_torch.core import EnsembleEngine
    cfg, bs, tmpl, lane_inputs = _bench_parts(agents, "cli", lanes)
    eng = EnsembleEngine(cfg, bs, lanes, tmpl, device="cuda")
    st = eng.init_state()
    args, seed, params = lane_inputs(0)
    staged = eng.stage_lane(*args, seed=seed)
    eng.retire(eng.admit(st, 0, staged, params), 0)
    torch.cuda.synchronize()
    admit, retire = [], []
    for lane in range(lanes):
        t0 = time.perf_counter()
        eng.admit(st, lane, staged, params)
        torch.cuda.synchronize()
        admit.append((time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        eng.retire(st, lane)
        torch.cuda.synchronize()
        retire.append((time.perf_counter() - t0) * 1e6)
    return {"admit_us_median": stats_mod.median(admit),
            "retire_us_median": stats_mod.median(retire), "lanes": lanes,
            "agents": agents}


def phase_service_cli(report: dict, tmpdir: str) -> dict:
    """[25] ``python -m repro_torch.launch.sim_serve`` at the reference's
    defaults; a run checkpointing every SERVE_CKPT_EVERY ticks SIGKILLed
    mid-churn and resumed must retire the simulations it serves as the
    uninterrupted run does (steps, reason, final infected count)."""
    import json as json_mod
    import os
    import signal
    from repro_torch.device import card_description
    card = card_description()
    mod = ["-m", "repro_torch.launch.sim_serve"]
    full_json = str(Path(tmpdir) / "serve_full.json")
    t0 = time.perf_counter()
    full = _child(mod + ["--report", full_json])
    full_s = time.perf_counter() - t0
    check(full.returncode == 0, f"[25] sim_serve exited {full.returncode}: "
                                f"{full.stderr[-2000:]}")
    drained = [ln for ln in full.stdout.splitlines()
               if ln.startswith("drained")]
    print(f"[25] sim_serve (8 lanes, 32 requests, 256 agents, 100 steps): "
          f"{drained[0] if drained else '?'}; process {full_s:.1f} s; "
          f"{card}", flush=True)
    want = {r["uid"]: r for r in json_mod.loads(Path(full_json).read_text())}
    check(sorted(want) == list(range(32)), "[25] not every request retired")

    ck = Path(tmpdir) / "serve_ckpt"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    args = mod + ["--ckpt-dir", str(ck), "--checkpoint-every",
                  str(SERVE_CKPT_EVERY)]
    proc = subprocess.Popen([sys.executable] + args, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    latest = ck / "LATEST"
    deadline = time.time() + 600
    try:
        while time.time() < deadline and proc.poll() is None:
            if latest.exists() and int(latest.read_text() or 0) \
                    >= SERVE_KILL_AFTER:
                break
            time.sleep(0.005)
        check(proc.poll() is None, f"[25] the service ended before its "
                                   f"checkpoint at {SERVE_KILL_AFTER}")
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    killed_at = int(latest.read_text())
    res_json = str(Path(tmpdir) / "serve_resumed.json")
    res = _child(args + ["--resume", "--report", res_json])
    check(res.returncode == 0, f"[25] resumed sim_serve exited "
                               f"{res.returncode}: {res.stderr[-2000:]}")
    resumed_line = [ln for ln in res.stdout.splitlines()
                    if ln.startswith("resumed")]
    meta = json_mod.loads((ck / f"step_{killed_at:09d}" /
                           "manifest.json").read_text())["extras"]
    done = set(meta["finished_uids"])
    busy = {e["uid"] for e in meta["lanes"] if e is not None}
    got = {r["uid"]: r for r in json_mod.loads(Path(res_json).read_text())}
    check(done and busy, f"[25] the kill at tick {killed_at} was not "
                         f"mid-churn (finished {sorted(done)}, busy "
                         f"{sorted(busy)})")
    check(set(got) | done == set(want) and not set(got) & done,
          "[25] the resumed service did not retire the rest")
    for uid, r in got.items():
        check(r == want[uid], f"[25] uid {uid} resumed {r}, uninterrupted "
                              f"{want[uid]}")
    ar = _admit_retire_us(8, 256)
    rec = {"card": card, "uninterrupted": drained[0] if drained else None,
           "process_s": full_s, "killed_at_tick": killed_at,
           "finished_at_kill": sorted(done), "busy_at_kill": sorted(busy),
           "resumed": resumed_line[0] if resumed_line else None,
           "resumed_equal": True, **ar}
    print(f"[25] SIGKILL after the checkpoint at tick {killed_at} "
          f"({len(done)} finished, lanes busy with {sorted(busy)}); "
          f"resumed: {len(got)} simulations retired, steps, reasons and "
          f"final infected counts equal to the uninterrupted run's; admit "
          f"{ar['admit_us_median']:.1f} µs, retire "
          f"{ar['retire_us_median']:.1f} µs (median, 8 lanes x 256 "
          f"agents); {card}", flush=True)
    report["service_cli"] = rec
    return rec


# ---------------------------------------------------------------------------
# phase 26: tissue lanes — every_k, pair lists, diffusion, statics and force
# overrides in the ensemble
# ---------------------------------------------------------------------------

def _tissue_parts(n_lanes: int):
    """(config, behaviors, params template, lane inputs(lane)) of
    examples/cell_clustering.py --pairlist as a sweep: the example's
    configuration (phase 15's), Secretion and Chemotaxis reading per-lane
    rates up to the example's 2.0 and 0.35, lane l's agents from seed
    4 + l (faster lanes overflow max_pairs 64 or the run capacity within
    30 ticks as their clusters form)."""
    import numpy as np
    from repro_torch.core import Chemotaxis, ScenarioParams, Secretion
    cfg = _clustering_pairlist("cpu")[0].config
    bs = [Secretion(rate=lambda ctx: ctx.params["secretion"]),
          Chemotaxis(speed=lambda ctx: ctx.params["speed"])]
    rates = np.linspace(1.5, 2.0, n_lanes)
    speeds = np.linspace(0.25, 0.35, n_lanes)
    n, side = cfg.capacity, cfg.domain_hi[0]

    def lane_inputs(lane):
        pos = np.random.default_rng(4 + lane).uniform(
            4, side - 4, (n, 3)).astype(np.float32)
        return ((pos, np.full(n, 2.0, np.float32)), lane,
                ScenarioParams.of(secretion=float(rates[lane]),
                                  speed=float(speeds[lane])))
    return cfg, bs, ScenarioParams.of(secretion=0.0, speed=0.0), lane_inputs


def _env_tensors(env) -> dict:
    """name → tensor of a cache's array leaves."""
    from repro_torch.core import grid as grid_mod
    out = {f"grid.{f}": getattr(env.grid, f) for f in grid_mod._GRID_LEAVES}
    out.update(steps_since=env.steps_since, disp_accum=env.disp_accum,
               dirty=env.dirty)
    if env.pairs is not None:
        out.update({f"pairs.{f}": getattr(env.pairs, f)
                    for f in grid_mod._PAIR_LEAVES}, pair_disp=env.pair_disp)
    return out


def _same_tissue_lane(got, pool, conc, rng, env, what: str) -> None:
    """A lane ≡ its solo run bit for bit: pool, grid, key and cache."""
    import torch
    _same_lane(pool, rng, got, what)
    check(torch.equal(conc, got.conc), f"{what}: diffusion grid differs")
    if env is not None:
        mine = _env_tensors(got.env)
        for k, v in _env_tensors(env).items():
            check(torch.equal(v, mine[k]), f"{what}: cache {k} differs")


def _tissue_solo(cfg, bs, lane_inputs, lane: int, steps: int):
    """Lane ``lane``'s solo card run: (pool, conc, rng, env)."""
    import torch
    from repro_torch.core import Simulation, make_iteration_core
    args, seed, params = lane_inputs(lane)
    st = Simulation(cfg, bs, device="cuda").init_state(*args, seed=seed)
    core = make_iteration_core(cfg, bs, torch.device("cuda"))
    pool, conc, rng, it, env = st.pool, st.conc, st.rng, st.iteration, st.env
    for _ in range(steps):
        pool, conc, rng, _, env = core(pool, conc, rng, it, env, params)
        it = it + 1
    return pool, conc, rng, env


def _ensemble_vs_cpu(card_next, cpu_next, what: str) -> float:
    """A card tick ≡ the same tick on the CPU from the same state: the
    pool, keys, stats and every cache leaf (integers exact, floats 1e-4)
    and the grids within 1e-5 of their largest value; the largest float
    residue."""
    import numpy as np
    worst = _pools_close(card_next.pool, cpu_next.pool, f"{what} pool")
    check(np.array_equal(card_next.rng.cpu().numpy(), cpu_next.rng.numpy()),
          f"{what}: keys differ")
    for f in card_next.stats.keys():
        check(np.array_equal(card_next.stats[f].cpu().numpy(),
                             cpu_next.stats[f].numpy()),
              f"{what}: stats {f} differ")
    g, w = card_next.conc.cpu().numpy(), cpu_next.conc.numpy()
    scale = max(float(np.abs(w).max()), 1e-30)
    check(float(np.abs(g - w).max()) <= CONC_RTOL * scale,
          f"{what}: grids differ by {float(np.abs(g - w).max())}")
    mine = _env_tensors(cpu_next.env)
    for k, v in _env_tensors(card_next.env).items():
        gv, wv = v.cpu().numpy(), mine[k].numpy()
        if wv.dtype.kind == "f":
            np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{what}: cache {k}")
            worst = max(worst, float(np.abs(gv - wv).max(initial=0.0)))
        else:
            check(np.array_equal(gv, wv), f"{what}: cache {k} differs")
    return worst


def _front_lane_inputs(lane: int):
    """Phase 8's 'front' cut to a 16³ lattice: 4,096 agents at spacing 5,
    the first 5% random-walking, drawn from seed ``lane``."""
    import numpy as np
    g = TISSUE_FRONT_SIDE
    pos = np.stack(np.meshgrid(*[np.arange(g) * 5.0 + 5] * 3), -1
                   ).reshape(-1, 3).astype(np.float32)
    pos += np.random.default_rng(lane).uniform(-0.2, 0.2, pos.shape).astype(
        np.float32)
    types = np.zeros(g ** 3, np.int32)
    types[:g ** 3 // 20] = 1
    return pos, np.full(g ** 3, 3.0, np.float32), types


def phase_tissue_lanes(report: dict, tmpdir: str) -> dict:
    """[26] (a) the clustering --pairlist sweep, (b) Fig-6 lanes with K1
    and a skin-0 pair list, (c) per-lane k_rep and statics lanes: lanes ≡
    solo on the card, the kernels once a tick for every lane, the
    lane-aware kernels ≡ plain; (d) the sweep's throughput."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.core import (EngineConfig, EnsembleEngine, ForceParams,
                                  PairListConfig, RandomWalk, ScenarioParams,
                                  Simulation, build_env)
    from repro_torch.core import grid as grid_mod
    from repro_torch.core.lanes import Lanes
    from repro_torch.device import card_description
    from repro_torch.kernels import ops
    from repro_torch.launch import kernel_variants, simulate

    card = card_description()
    rec = {"card": card}
    # (a) the clustering sweep: 7 lanes, the 8th admitted mid-run
    n_l = TISSUE_LANES
    cfg, bs, tmpl, lane_inputs = _tissue_parts(n_l)
    eng = EnsembleEngine(cfg, bs, n_l, tmpl, device="cuda")
    st = eng.init_state()

    def admit(state, lane):
        args, seed, params = lane_inputs(lane)
        return eng.admit(state, lane, eng.stage_lane(*args, seed=seed),
                         params)
    for lane in range(n_l - 1):
        st = admit(st, lane)
    _reset_counts()
    flags, states = [], []
    for tick in range(TISSUE_TICKS):
        if tick == TISSUE_ADMIT_AT:
            st = admit(st, n_l - 1)
        states.append(st)
        st = eng.step(st)
        flags.append(st.stats.rebuilds.tolist())
    states.append(st)
    torch.cuda.synchronize()
    launches = _read_counts()
    n_active = [n_l - 1 if t < TISSUE_ADMIT_AT else n_l
                for t in range(TISSUE_TICKS)]
    mixed = [t for t, f in enumerate(flags)
             if len(set(f[:n_active[t]])) > 1]
    check(mixed, f"[26a] no tick had mixed rebuild flags: {flags}")
    rebuild_ticks = sum(any(f) for f in flags)
    want = {"pairlist_build": rebuild_ticks, "k1_pair_cols": TISSUE_TICKS,
            "k1_collision_force": TISSUE_TICKS, "secretion": TISSUE_TICKS,
            "k1_column_map": 0}
    for name, count in want.items():
        check(launches[name] == count,
              f"[26a] {name} launched {launches[name]} times in "
              f"{TISSUE_TICKS} ticks ({rebuild_ticks} with a rebuild), "
              f"expected {count}")
    check(not st.stats.flags(), f"[26a] overflow flags {st.stats.flags()}")
    for lane in range(n_l):
        steps = TISSUE_TICKS - (TISSUE_ADMIT_AT if lane == n_l - 1 else 0)
        _same_tissue_lane(eng.read_lane(st, lane),
                          *_tissue_solo(cfg, bs, lane_inputs, lane, steps),
                          f"[26a] lane {lane}")
    # a mixed tick and the last, on the CPU from the card's state (the
    # admission writes the state of tick ADMIT_AT - 1 in place, so that
    # tick's output is not kept)
    t_mixed = next(t for t in mixed if t != TISSUE_ADMIT_AT - 1)
    cpu_ticks = sorted({t_mixed, TISSUE_TICKS - 1})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu_eng = EnsembleEngine(cfg, bs, n_l, tmpl, device="cpu")
        worst = 0.0
        for t in cpu_ticks:
            before = convert.ensemble_state_from_numpy(
                convert.ensemble_state_to_numpy(states[t]), "cpu")
            worst = max(worst, _ensemble_vs_cpu(
                states[t + 1], cpu_eng.step(before), f"[26a] tick {t}"))
    finally:
        torch.set_num_threads(threads)
    box = [st]

    def one():
        box[0] = eng.step(box[0])
    syncs = _host_syncs(one, 5)
    check(syncs == 1.0, f"[26a] {syncs} host reads a tick, not the one "
                        f"read of the rebuild flags")
    rec["clustering"] = {
        "lanes": n_l, "agents": cfg.capacity, "ticks": TISSUE_TICKS,
        "admitted_at": TISSUE_ADMIT_AT, "rebuild_flags": flags,
        "mixed_ticks": mixed, "launches": launches,
        "launches_per_tick": {k: launches[k] / TISSUE_TICKS
                              for k in ("pairlist_build", "k1_pair_cols",
                                        "k1_collision_force", "secretion")},
        "lanes_equal_solo": True, "cpu_ticks": cpu_ticks,
        "cpu_max_abs_diff": worst, "host_reads_per_tick": syncs,
        "pair_demand": [int(v) for v in st.stats.pair_demand],
        "conc_max": [float(v) for v in st.conc.reshape(n_l, -1).amax(1)]}
    print(f"[26a] clustering --pairlist sweep, {n_l} lanes x {cfg.capacity} "
          f"agents (lane {n_l - 1} admitted at tick {TISSUE_ADMIT_AT}), "
          f"{TISSUE_TICKS} ticks: mixed rebuild flags at ticks {mixed} "
          f"(tick {t_mixed}: {flags[t_mixed]}); every lane ≡ its solo "
          f"card run bit for bit (grid, key and cache); ticks "
          f"{cpu_ticks} ≡ the CPU (max|Δ| "
          f"{worst:.3g}, integers equal); launches {launches} "
          f"({rebuild_ticks} ticks rebuilt); {syncs:.1f} host read a tick; "
          f"{card}", flush=True)

    # (b) Fig-6 lanes with K1 and a skin-0 pair list every step
    n = ENS_PL_AGENTS
    sim6, _ = simulate.build("proliferation", n, "fig6", device="cuda")
    cfg6 = dataclasses.replace(sim6.config, pairlist=PairListConfig(
        skin=0.0, max_pairs=64))
    bs6, spec = sim6.behaviors, cfg6.grid_spec
    ln = Lanes(ENS_PL_LANES, cfg6.capacity)
    eng6 = EnsembleEngine(cfg6, bs6, ENS_PL_LANES, device="cuda")
    st6 = eng6.init_state()
    for lane in range(ENS_PL_LANES):
        st6 = eng6.admit(st6, lane, eng6.stage_lane(
            *_fig6_lane_inputs(n, lane), seed=lane))
    origin = torch.tensor(cfg6.domain_lo, dtype=torch.float32, device="cuda")
    res = build_env(cfg6, spec, st6.pool, origin, cfg6.cell_size, ln)
    pool, g = res.pool, res.grid
    kw = dict(radius=cfg6.interaction_radius, max_pairs=64,
              chunk=cfg6.query_chunk)
    got = grid_mod.build_pairlist(spec, g, pool.position, pool.alive, **kw)
    torch.cuda.synchronize()
    want_pl = grid_mod.build_pairlist_plain(spec, g, pool.position,
                                            pool.alive, **kw)
    for f in ("idx", "run_off", "count", "demand"):
        check(torch.equal(getattr(got, f), getattr(want_pl, f)),
              f"[26b] lane-aware pair list differs from plain in {f}")
    check(tuple(got.demand.shape) == (ENS_PL_LANES,)
          and int(got.demand.max()) <= 64, f"[26b] demand {got.demand}")
    pl_t = _pairlist_vs_previous(
        "[26b] lane-aware",
        lambda: grid_mod.build_pairlist(spec, g, pool.position, pool.alive,
                                        **kw),
        lambda: kernel_variants.pairlist_build(
            pool.position, pool.alive, g.origin, g.box_size, g.starts,
            g.counts, spec.dims, spec.run_capacity,
            grid_mod.pair_radius_sq(kw["radius"]), kw["max_pairs"],
            lanes=ENS_PL_LANES), want_pl)
    pl_ms = pl_t["ms"]
    pl_plain = cuda_ms(lambda: grid_mod.build_pairlist_plain(
        spec, g, pool.position, pool.alive, **kw), iters=2, warmup=0)
    pl_bound, pl_by, pl_work = pairlist_bound(spec, g, pool, got)
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            pool.alive, g.starts, g.counts, origin, cfg6.cell_size,
            spec.dims, 64)
    pm = ops.k1_inputs(*args, got, ln)
    torch.cuda.synchronize()
    pm_want = ops.k1_inputs_plain(*args, got, ln)
    for gt, w, what in zip(pm, pm_want, ("data_t", "block_cols", "overflow",
                                         "row mask")):
        check(gt.dtype == w.dtype and torch.equal(gt, w),
              f"[26b] lane-aware pairs map differs from plain in {what}")
    check(tuple(pm[2].shape) == (ENS_PL_LANES,) and not bool(pm[2].any()),
          "[26b] per-lane pairs-map overflow")
    pm_t = _pairs_map_vs_previous("[26b] lane-aware", (*args, got, ln))
    pm_ms = pm_t["ms"]
    pm_plain = cuda_ms(lambda: ops.k1_inputs_plain(*args, got, ln), iters=2,
                       warmup=0)
    pm_bound, pm_by, pm_work = pairs_map_bound(pool, got, pm[0], pm[1])
    # the solo calls at the same total rows: one Fig-6 pool of L·n agents
    ssim, sst = simulate.build("proliferation", ENS_PL_LANES * n, "fig6",
                               device="cuda")
    sres = build_env(ssim.config, ssim.spec, sst.pool, origin,
                     ssim.config.cell_size)
    sp, sg = sres.pool, sres.grid
    spairs = grid_mod.build_pairlist(ssim.spec, sg, sp.position, sp.alive,
                                     **kw)
    solo_pl_ms = cuda_ms(lambda: grid_mod.build_pairlist(
        ssim.spec, sg, sp.position, sp.alive, **kw), iters=20, warmup=3)
    sargs = (sp.position, sp.diameter, sp.agent_type, sp.alive, sp.alive,
             sg.starts, sg.counts, origin, ssim.config.cell_size,
             ssim.spec.dims, 64)
    solo_pm_ms = cuda_ms(lambda: ops.k1_inputs(*sargs, spairs), iters=20,
                         warmup=3)
    kernels = {
        "pairlist_build": {
            "equal": True, "max_abs_err": 0.0, **pl_t,
            "plain_ms": pl_plain, "bound_ms": pl_bound, "bound_by": pl_by,
            "library_ms": None, "solo_ms": solo_pl_ms,
            "rows": pool.position.shape[0],
            "solo_rows": sp.position.shape[0], **pl_work},
        "k1_pair_cols": {
            "equal": True, "max_abs_err": 0.0, **pm_t,
            "plain_ms": pm_plain, "bound_ms": pm_bound, "bound_by": pm_by,
            "library_ms": None, "solo_ms": solo_pm_ms,
            "n_pad": pm[0].shape[1], **pm_work}}
    _reset_counts()
    for _ in range(ENS_PL_TICKS):
        st6 = eng6.step(st6)
    torch.cuda.synchronize()
    launches6 = _read_counts()
    for name in ("pairlist_build", "k1_pair_cols", "k1_collision_force"):
        check(launches6[name] == ENS_PL_TICKS,
              f"[26b] {name} launched {launches6[name]} times in "
              f"{ENS_PL_TICKS} ticks of {ENS_PL_LANES} lanes, not once a "
              f"tick")
    check(launches6["k1_column_map"] == 0, "[26b] the stencil map ran")
    check(not st6.stats.flags(), f"[26b] overflow flags {st6.stats.flags()}")
    sim_pl = Simulation(cfg6, bs6, device="cuda")
    for lane in range(ENS_PL_LANES):
        solo = sim_pl.init_state(*_fig6_lane_inputs(n, lane), seed=lane)
        for _ in range(ENS_PL_TICKS):
            solo = sim_pl.step(solo)
        _same_lane(solo.pool, solo.rng, eng6.read_lane(st6, lane),
                   f"[26b] lane {lane}")
    rec["fig6_pairs"] = {
        "lanes": ENS_PL_LANES, "agents": n, "capacity": cfg6.capacity,
        "ticks": ENS_PL_TICKS, "lanes_equal_solo": True,
        "launches": launches6,
        "launches_per_tick": {k: launches6[k] / ENS_PL_TICKS for k in (
            "pairlist_build", "k1_pair_cols", "k1_collision_force")},
        "kernels": kernels,
        "demand": [int(v) for v in got.demand]}
    print(f"[26b] Fig-6 {ENS_PL_LANES} lanes x {n} agents, K1 from a skin-0 "
          f"pair list every step, {ENS_PL_TICKS} ticks: pair-list build, "
          f"pairs map and K1 {launches6['pairlist_build']}, "
          f"{launches6['k1_pair_cols']}, {launches6['k1_collision_force']} "
          f"launches (once a tick for all lanes); every lane ≡ its solo card "
          f"run bit for bit; lane-aware pair list ≡ plain (idx, run_off, "
          f"count, per-lane demand {rec['fig6_pairs']['demand']}): kernel "
          f"{pl_ms:.4f} ms (first design "
          f"{pl_t['previous_design_ms']:.4f} ms in the same call), plain "
          f"{pl_plain:.2f} ms, bound {pl_bound:.4f} ms "
          f"({pl_by}), the solo call on {sp.position.shape[0]} rows "
          f"{solo_pl_ms:.4f} ms; lane-aware pairs map ≡ plain: kernel "
          f"{pm_ms:.4f} ms (first design {pm_t['previous_design_ms']:.4f} "
          f"ms in the same call), plain {pm_plain:.2f} ms, bound "
          f"{pm_bound:.4f} ms "
          f"({pm_by}), the solo call {solo_pm_ms:.4f} ms; {card}",
          flush=True)

    # (c) per-lane k_rep in the streamed sweep; statics lanes with K1
    kcfg = dataclasses.replace(sim6.config, force_impl="streamed")
    kt = ScenarioParams.of(force={"k_rep": 0.0})
    k_reps = (2.0, 6.0)
    keng = EnsembleEngine(kcfg, bs6, 2, kt, device="cuda")
    kst = keng.init_state()
    for lane in range(2):
        kst = keng.admit(kst, lane, keng.stage_lane(
            *_fig6_lane_inputs(n, lane), seed=lane),
            ScenarioParams.of(force={"k_rep": k_reps[lane]}))
    for _ in range(TISSUE_SMALL_TICKS):
        kst = keng.step(kst)
    k_equal, k_worst = True, 0.0
    for lane in range(2):
        solo = Simulation(kcfg, bs6, device="cuda").init_state(
            *_fig6_lane_inputs(n, lane), seed=lane)
        pool_s, rng_s = _solo_core_run(
            kcfg, bs6, solo, ScenarioParams.of(force={"k_rep": k_reps[lane]}),
            TISSUE_SMALL_TICKS, "cuda")
        got_l = keng.read_lane(kst, lane)
        check(torch.equal(rng_s, got_l.rng), f"[26c] k_rep lane {lane} key")
        k_equal &= all(torch.equal(v, got_l.pool.channels()[k])
                       for k, v in pool_s.channels().items())
        k_worst = max(k_worst, _pools_close(got_l.pool, _host_pool(pool_s),
                                            f"[26c] k_rep lane {lane}"))
    a_pos, b_pos = (keng.read_lane(kst, lane).pool.position
                    for lane in range(2))
    check(not torch.equal(a_pos, b_pos), "[26c] k_rep made no difference")
    side = 5.0 * TISSUE_FRONT_SIDE + 10
    scfg = EngineConfig(capacity=TISSUE_FRONT_SIDE ** 3,
                        domain_lo=(0, 0, 0), domain_hi=(side,) * 3,
                        interaction_radius=4.0, dt=0.05, detect_static=True,
                        max_per_box=32, query_chunk=4096,
                        force=ForceParams(max_displacement=0.5))
    sbs = [RandomWalk(sigma=0.4, applies_to=1)]
    seng = EnsembleEngine(scfg, sbs, TISSUE_STATIC_LANES, device="cuda")
    sst2 = seng.init_state()
    for lane in range(TISSUE_STATIC_LANES):
        pos, dia, types = _front_lane_inputs(lane)
        sst2 = seng.admit(sst2, lane, seng.stage_lane(pos, dia, types,
                                                      seed=lane))
    for _ in range(TISSUE_SMALL_TICKS):
        sst2 = seng.step(sst2)
    ssim2 = Simulation(scfg, sbs, device="cuda")
    for lane in range(TISSUE_STATIC_LANES):
        pos, dia, types = _front_lane_inputs(lane)
        solo = ssim2.init_state(pos, dia, types, seed=lane)
        for _ in range(TISSUE_SMALL_TICKS):
            solo = ssim2.step(solo)
        _same_lane(solo.pool, solo.rng, seng.read_lane(sst2, lane),
                   f"[26c] statics lane {lane}")
    n_static = [int(v) for v in sst2.pool.static.reshape(
        TISSUE_STATIC_LANES, -1).sum(1)]
    check(min(n_static) > 0, f"[26c] static rows per lane {n_static}")
    rec["k_rep"] = {"lanes": 2, "agents": n, "k_rep": list(k_reps),
                    "ticks": TISSUE_SMALL_TICKS, "bit_equal": k_equal,
                    "max_abs_diff": k_worst}
    rec["statics"] = {"lanes": TISSUE_STATIC_LANES,
                      "agents": TISSUE_FRONT_SIDE ** 3,
                      "ticks": TISSUE_SMALL_TICKS,
                      "lanes_equal_solo": True, "static_rows": n_static}
    print(f"[26c] per-lane k_rep {list(k_reps)} in the streamed sweep, 2 "
          f"lanes x {n} Fig-6 agents, {TISSUE_SMALL_TICKS} ticks: each lane "
          f"≡ its solo card run "
          f"{'bit for bit' if k_equal else f'within {k_worst:.3g}'} "
          f"(integers and keys equal); statics: {TISSUE_STATIC_LANES} lanes "
          f"of the {TISSUE_FRONT_SIDE ** 3}-agent front with K1 ≡ their solo "
          f"card runs bit for bit, static rows per lane {n_static}; {card}",
          flush=True)

    # (d) the sweep's serving ticks at 8 and 64 lanes beside one lane
    recs = []
    for lanes in TISSUE_BENCH_LANES:
        cfg_d, bs_d, tmpl_d, inputs_d = _tissue_parts(lanes)

        def filled(n_lanes):
            e = EnsembleEngine(cfg_d, bs_d, n_lanes, tmpl_d, device="cuda")
            s = e.init_state()
            for lane in range(n_lanes):
                a, seed, params = inputs_d(lane)
                s = e.admit(s, lane, e.stage_lane(*a, seed=seed), params)
            return e, s
        ens = _serving_ticks(*filled(lanes), TISSUE_BENCH_TICKS,
                             metric=_live_count)
        seq = _serving_ticks(*filled(1), TISSUE_BENCH_TICKS,
                             metric=_live_count)
        agents = cfg_d.capacity
        ens_rate = lanes * agents / (ens["ms_per_tick"] * 1e-3)
        seq_rate = agents / (seq["ms_per_tick"] * 1e-3)
        r = {"lanes": lanes, "agents_per_lane": agents,
             "ticks": TISSUE_BENCH_TICKS,
             "ensemble": {**ens, "agent_steps_per_s": ens_rate},
             "sequential": {**seq, "agent_steps_per_s": seq_rate},
             "speedup_vs_sequential": ens_rate / seq_rate, "card": card}
        recs.append(r)
        print(f"[26d] clustering sweep, {lanes} lanes x {agents} agents: "
              f"{ens['ms_per_tick']:.3f} ms/tick, {ens_rate:.4g} "
              f"agent-steps/s, {ens['device_ops_per_tick']:.0f} device "
              f"ops/tick, idle {ens['device_idle_share']:.3f}, "
              f"{ens['host_syncs_per_tick']:.1f} host syncs/tick | one lane: "
              f"{seq['ms_per_tick']:.3f} ms/tick, {seq_rate:.4g} "
              f"agent-steps/s, {seq['device_ops_per_tick']:.0f} ops, idle "
              f"{seq['device_idle_share']:.3f}, "
              f"{seq['host_syncs_per_tick']:.1f} syncs | speedup "
              f"{r['speedup_vs_sequential']:.2f}x; {card}", flush=True)
    rec["throughput"] = recs
    report["tissue_lanes"] = rec
    return rec


def _live_count(pool, params):
    """The serving tick's read-back for the tissue sweep: live agents."""
    return pool.alive.sum()


# ---------------------------------------------------------------------------
# phase 27: the non-resident environments over ensemble lanes, and the
# reference's examples as the port's entry points
# ---------------------------------------------------------------------------

def _ens_to(st, device: str):
    """An ensemble state with every tensor copied to ``device``."""
    from repro_torch.core import StepStats
    return dataclasses.replace(
        st, pool=st.pool.with_channels({k: v.to(device) for k, v in
                                        st.pool.channels().items()}),
        conc=st.conc.to(device), rng=st.rng.to(device),
        iteration=st.iteration.to(device),
        stats=StepStats(**{f: v.to(device) for f, v in st.stats.items()}),
        active=st.active.to(device),
        params=None if st.params is None else st.params.to(device),
        tick=st.tick.to(device))


def _env_sir_parts(env: str):
    """Phase 23's SIR lanes under ``env``, with the periodic Morton sort
    every 4 iterations where the environment runs it."""
    cfg, bs = _sir_lane_parts()
    return dataclasses.replace(cfg, environment=env, force_impl="streamed",
                               sort_frequency=ENV_LANES_SORT), bs


def _env_tables(cfg, pool, n_lanes: int, device: str) -> dict:
    """The lane build's tables over ``pool`` on ``device``, by name."""
    import torch
    from repro_torch.core import build_env
    from repro_torch.core.lanes import Lanes
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32, device=device)
    res = build_env(cfg, cfg.grid_spec, pool, origin, cfg.cell_size,
                    Lanes(n_lanes, cfg.capacity))
    g = res.grid
    return {f: getattr(g, f).cpu() for f in
            ("table", "counts", "keys", "cell_keys", "order", "starts",
             "max_bucket_count", "max_run_count") if hasattr(g, f)}


def _ens_tick_vs_cpu(cfg, bs, before, after, what: str) -> float:
    """One tick of the lanes on the CPU from the card's state ``before``
    ≡ the card's ``after``: integers, keys, stats and the build's tables
    exact, floats 1e-4. Returns the largest float residue."""
    import numpy as np
    import torch
    from repro_torch.core import EnsembleEngine, ScenarioParams
    n = before.n_lanes
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = EnsembleEngine(cfg, bs, n, ScenarioParams.of(beta=0.0),
                             device="cpu")
        host = _ens_to(before, "cpu")
        cpu_tables = _env_tables(cfg, host.pool, n, "cpu")
        cpu_after = eng.step(host)
    finally:
        torch.set_num_threads(threads)
    for k, v in _env_tables(cfg, before.pool, n, "cuda").items():
        check(torch.equal(v, cpu_tables[k]), f"{what}: table {k} differs "
                                             f"from the CPU's")
    worst = _pools_close(after.pool, cpu_after.pool, what)
    check(np.array_equal(after.rng.cpu().numpy(), cpu_after.rng.numpy()),
          f"{what}: keys differ from the CPU's")
    for f in after.stats.keys():
        check(torch.equal(after.stats[f].cpu(), cpu_after.stats[f]),
              f"{what}: stats {f} differ from the CPU's")
    return worst


def _env_lanes_parity(env: str) -> dict:
    """[27a] phase 23's 8 SIR lanes under ``env`` for 20 ticks, the last
    lane admitted after tick 3: every lane ≡ its solo card run bit for
    bit; ticks 0 and 19 ≡ the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import EnsembleEngine, ScenarioParams, Simulation
    cfg, bs = _env_sir_parts(env)
    n = ENS_SIR_LANES
    late = n - 1
    betas = np.linspace(0.1, 0.5, n)
    eng = EnsembleEngine(cfg, bs, n, ScenarioParams.of(beta=0.0),
                         device="cuda")

    def admit(st, lane):
        return eng.admit(st, lane, eng.stage_lane(*_sir_lane_inputs(lane),
                                                  seed=lane),
                         ScenarioParams.of(beta=float(betas[lane])))
    st = eng.init_state()
    for lane in range(n):
        if lane != late:
            st = admit(st, lane)
    cpu_ticks, worst = (0, ENS_SIR_TICKS - 1), 0.0
    for t in range(ENS_SIR_TICKS):
        if t == ENV_LANES_ADMIT_AT:
            st = admit(st, late)
        before = st                 # a step leaves its input as it was
        st = eng.step(st)
        if t in cpu_ticks:
            worst = max(worst, _ens_tick_vs_cpu(
                cfg, bs, before, st, f"[27a] {env} tick {t}"))
    torch.cuda.synchronize()
    check(st.iteration.tolist() == [ENS_SIR_TICKS] * late
          + [ENS_SIR_TICKS - ENV_LANES_ADMIT_AT],
          f"[27a] {env}: lane iterations {st.iteration.tolist()}")
    sim = Simulation(cfg, bs, device="cuda")
    for lane in range(n):
        solo = sim.init_state(*_sir_lane_inputs(lane), seed=lane)
        steps = int(st.iteration[lane])
        pool, rng = _solo_core_run(cfg, bs, solo, ScenarioParams.of(
            beta=float(betas[lane])), steps, "cuda")
        got = eng.read_lane(st, lane)
        _same_lane(pool, rng, got, f"[27a] {env} lane {lane}")
    demand = [int(v) for v in st.stats.box_demand]
    if env == "hash_grid":
        check(min(demand) > 0, f"[27a] hash demand per lane {demand}")
    return {"lanes": n, "agents": ENS_SIR_AGENTS, "capacity": cfg.capacity,
            "ticks": ENS_SIR_TICKS, "admitted_at": ENV_LANES_ADMIT_AT,
            "sort_frequency": cfg.sort_frequency, "lanes_equal_solo": True,
            "cpu_ticks": list(cpu_ticks), "cpu_max_abs_diff": worst,
            "box_demand": demand}


def _env_statics() -> dict:
    """[27b] phase 26 (c)'s 4 'front' lanes under brute force with
    ``detect_static`` and forces in the streamed sweep: each lane ≡ its
    solo card run (integers and keys exact, floats 1e-4, bit-equality
    reported)."""
    import torch
    from repro_torch.core import (EngineConfig, EnsembleEngine, ForceParams,
                                  RandomWalk, Simulation)
    side = 5.0 * TISSUE_FRONT_SIDE + 10
    cfg = EngineConfig(capacity=TISSUE_FRONT_SIDE ** 3, domain_lo=(0, 0, 0),
                       domain_hi=(side,) * 3, interaction_radius=4.0,
                       dt=0.05, detect_static=True, max_per_box=32,
                       query_chunk=4096, environment="brute_force",
                       force=ForceParams(max_displacement=0.5))
    bs = [RandomWalk(sigma=0.4, applies_to=1)]
    n = TISSUE_STATIC_LANES
    eng = EnsembleEngine(cfg, bs, n, device="cuda")
    st = eng.init_state()
    for lane in range(n):
        pos, dia, types = _front_lane_inputs(lane)
        st = eng.admit(st, lane, eng.stage_lane(pos, dia, types, seed=lane))
    for _ in range(TISSUE_SMALL_TICKS):
        st = eng.step(st)
    sim = Simulation(cfg, bs, device="cuda")
    bit_equal, worst = True, 0.0
    for lane in range(n):
        pos, dia, types = _front_lane_inputs(lane)
        solo = sim.init_state(pos, dia, types, seed=lane)
        for _ in range(TISSUE_SMALL_TICKS):
            solo = sim.step(solo)
        got = eng.read_lane(st, lane)
        check(torch.equal(solo.rng, got.rng), f"[27b] lane {lane} key")
        check(torch.equal(solo.pool.static, got.pool.static),
              f"[27b] lane {lane} static flags differ from the solo run")
        bit_equal &= all(torch.equal(v, got.pool.channels()[k])
                         for k, v in solo.pool.channels().items())
        worst = max(worst, _pools_close(got.pool, _host_pool(solo.pool),
                                        f"[27b] lane {lane}"))
    n_static = [int(v) for v in st.pool.static.reshape(n, -1).sum(1)]
    forces = int(st.pool.force_nnz.sum())
    check(min(n_static) > 0, f"[27b] static rows per lane {n_static}")
    return {"lanes": n, "agents": TISSUE_FRONT_SIDE ** 3,
            "ticks": TISSUE_SMALL_TICKS, "bit_equal": bit_equal,
            "max_abs_diff": worst, "static_rows": n_static,
            "force_nnz_total": forces}


def _env_hash_rung() -> dict:
    """[27c] the SIR lanes crowded into side 12 under the hash with
    max_per_box 1 (a probe width of 4), below the densest lane's bucket
    demand: ``EnsembleCapacityLadder`` grows max_per_box, and the result
    ≡ an ensemble pre-sized at the final rung bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core import (EnsembleCapacityLadder, EnsembleEngine,
                                  LadderConfig, ScenarioParams)
    cfg, bs = _env_sir_parts("hash_grid")
    cfg = dataclasses.replace(cfg, domain_hi=(ENS_BENCH_SIDE,) * 3,
                              max_per_box=1)
    n = ENS_SIR_LANES
    betas = np.linspace(0.1, 0.5, n)

    def fill(eng):
        st = eng.init_state()
        for lane in range(n):
            pos, dia, at, extra = _sir_lane_inputs(lane)
            st = eng.admit(st, lane, eng.stage_lane(
                pos * (ENS_BENCH_SIDE / 48.0), dia, at, extra, seed=lane),
                ScenarioParams.of(beta=float(betas[lane])))
        return st
    ladder = EnsembleCapacityLadder(cfg, bs, n, ScenarioParams.of(beta=0.0),
                                    LadderConfig(growth_factor=2.0),
                                    device="cuda")
    st = ladder.run(fill(ladder.engine), ENV_RUNG_TICKS)
    rungs = [r for r in ladder.rungs if r["field"] == "max_per_box"]
    check(bool(rungs), f"[27c] the hash rung did not grow: {ladder.rungs}")
    check(int(st.stats.box_overflow.sum()) == 0, "[27c] still overflowing")
    pre = EnsembleEngine(ladder.config, bs, n, ScenarioParams.of(beta=0.0),
                         device="cuda")
    st2 = fill(pre)
    for _ in range(ENV_RUNG_TICKS):
        st2 = pre.step(st2)
    for lane in range(n):
        want = pre.read_lane(st2, lane)
        _same_lane(want.pool, want.rng, ladder.engine.read_lane(st, lane),
                   f"[27c] lane {lane}")
    torch.cuda.synchronize()
    return {"lanes": n, "ticks": ENV_RUNG_TICKS,
            "max_per_box": ladder.config.max_per_box, "rungs": ladder.rungs,
            "box_demand": [int(v) for v in st.stats.box_demand],
            "equal_presized": True}


def _env_tick_times(uniform: dict) -> list:
    """[27d] phase 24's set-ups under each environment: ms, device ops
    and idle share per serving tick, beside phase 24's uniform grid."""
    from repro_torch.core import EnsembleEngine
    recs = []
    for lanes, agents, kind in ENS_BENCH:
        cfg, bs, tmpl, lane_inputs = _bench_parts(agents, kind, lanes)
        row = {"set_up": kind, "lanes": lanes, "agents_per_lane": agents,
               "ticks": ENS_BENCH_TICKS}
        base = uniform.get((lanes, agents, kind))
        if base is not None:
            row["uniform_grid"] = base
        for env in (["uniform_grid"] if base is None else []) \
                + list(NON_RESIDENT_ENVS):
            ecfg = dataclasses.replace(cfg, environment=env,
                                       force_impl="streamed")
            eng = EnsembleEngine(ecfg, bs, lanes, tmpl, device="cuda")
            st = eng.init_state()
            for lane in range(lanes):
                args, seed, params = lane_inputs(lane)
                st = eng.admit(st, lane, eng.stage_lane(*args, seed=seed),
                               params)
            row[env] = _serving_ticks(eng, st, ENS_BENCH_TICKS)
        recs.append(row)
        print(f"[27d] {kind} set-up, {lanes} lanes x {agents} agents: "
              + " | ".join(
                  f"{env} {row[env]['ms_per_tick']:.3f} ms/tick, "
                  f"{row[env]['device_ops_per_tick']:.0f} ops, idle "
                  f"{row[env]['device_idle_share']:.3f}"
                  for env in ("uniform_grid",) + NON_RESIDENT_ENVS),
              flush=True)
    return recs


# (name, environment knobs, arguments, the kernels its path must launch):
# CI's smoke sizes (.github/workflows/ci.yml), serve_lm at its own
EXAMPLES = (
    ("quickstart", {"EXAMPLE_EPOCHS": "4"}, [],
     ("k1_collision_force", "k1_column_map")),
    ("oncology", {"EXAMPLE_EPOCHS": "4"}, [],
     ("k1_collision_force", "k1_column_map")),
    ("cell_clustering", {"EXAMPLE_N": "2000", "EXAMPLE_EPOCHS": "4"}, [],
     ("secretion",)),
    ("cell_clustering", {"EXAMPLE_N": "2000", "EXAMPLE_EPOCHS": "4"},
     ["--pairlist"], ("secretion", "pairlist_build", "k1_pair_cols",
                      "k1_collision_force")),
    ("neuroscience", {"EXAMPLE_EPOCHS": "6"}, [],
     ("k1_collision_force", "k1_column_map")),
    ("ensemble_sweep", {"EXAMPLE_N": "200", "EXAMPLE_LANES": "4",
                        "EXAMPLE_POINTS": "8", "EXAMPLE_STEPS": "60"}, [],
     ()),
    ("serve_lm", {}, [], ()),
)


def _example_on_the_card(name: str, env: dict, argv: list, must,
                         tmpdir: str, tag: str) -> dict:
    """One example's ``main`` on the card: it must print its OK line, and
    each kernel in ``must`` must launch over its run (counts reset just
    before, read just after). Temporary files (oncology's checkpoint) go
    under ``tmpdir``."""
    import contextlib
    import importlib
    import io
    import os
    import tempfile
    import torch
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = io.StringIO()
    tempfile.tempdir = tmpdir
    try:
        _reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        tempfile.tempdir = None
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    text = out.getvalue()
    ok = [ln for ln in text.splitlines() if ln.startswith("OK:")]
    check(bool(ok), f"[{tag}] {name} {argv} printed no OK line")
    for k in must:
        check(launches[k] > 0, f"[{tag}] {name} {argv}: {k} never launched")
    label = " ".join([name, *argv])
    knobs = " ".join(f"{k}={v}" for k, v in env.items())
    used = {k: v for k, v in launches.items() if v} or "none"
    print(f"[{tag}] {label} ({knobs}) on the card in {seconds:.1f} s: "
          f"{ok[-1]}; launches {used}", flush=True)
    return {"example": label, "env": env, "seconds": seconds,
            "launches": launches, "ok": ok, "output": text}


def _examples_on_the_card(tmpdir: str) -> list:
    """[27e] each example's ``main`` on the card at CI's smoke size."""
    return [_example_on_the_card(name, env, argv, must, tmpdir, "27e")
            for name, env, argv, must in EXAMPLES]


def phase_ensemble_envs(report: dict, tmpdir: str) -> dict:
    """[27] (a) the SIR lanes under scatter, hash and brute force ≡ solo
    and ≡ the CPU, (b) brute-force statics lanes ≡ solo, (c) the hash rung
    ≡ pre-sized, (d) tick times per environment, (e) the six examples on
    the card."""
    from repro_torch.device import card_description
    card = card_description()
    rec = {"card": card, "parity": {}}
    for env in NON_RESIDENT_ENVS:
        r = rec["parity"][env] = _env_lanes_parity(env)
        print(f"[27a] {env}: SIR {r['lanes']} lanes x {r['agents']} agents "
              f"in capacity {r['capacity']}, {r['ticks']} ticks, lane "
              f"{r['lanes'] - 1} admitted after tick {r['admitted_at']}, "
              f"sort every {r['sort_frequency']}: every lane ≡ its solo card "
              f"run bit for bit (keys and stats included); ticks "
              f"{r['cpu_ticks']} ≡ the CPU (max|Δ| "
              f"{r['cpu_max_abs_diff']:.3g}, integers, keys and tables "
              f"equal); box_demand per lane {r['box_demand']}; {card}",
              flush=True)
    r = rec["statics"] = _env_statics()
    same = ("bit for bit" if r["bit_equal"]
            else f"within {r['max_abs_diff']:.3g}")
    print(f"[27b] brute force, {r['lanes']} 'front' lanes x {r['agents']} "
          f"agents, detect_static, streamed forces, {r['ticks']} ticks: "
          f"each lane ≡ its solo card run {same} (integers, keys and "
          f"static flags equal); static rows per lane "
          f"{r['static_rows']}, nonzero pair forces {r['force_nnz_total']}; "
          f"{card}", flush=True)
    r = rec["hash_rung"] = _env_hash_rung()
    print(f"[27c] hash rung: {r['lanes']} SIR lanes in side "
          f"{ENS_BENCH_SIDE}, max_per_box 1 -> {r['max_per_box']} "
          f"(rungs {r['rungs']}), {r['ticks']} ticks ≡ an ensemble "
          f"pre-sized at the final rung bit for bit; box_demand per lane "
          f"{r['box_demand']}; {card}", flush=True)
    uniform = {(x["lanes"], x["agents_per_lane"], x["set_up"]):
               x["ensemble"] for x in report.get("ensemble_throughput", [])}
    rec["tick_times"] = _env_tick_times(uniform)
    rec["examples"] = _examples_on_the_card(tmpdir)
    report["ensemble_envs"] = rec
    return rec


# ---------------------------------------------------------------------------
# phase 28: the distributed engine, its shards stacked as lanes on the card
# ---------------------------------------------------------------------------

# benchmarks/distributed.py's weak-scaling case at 4 shards (its per-shard
# population, density, capacities and rebalance frequency)
DIST_SHARDS, DIST_PER_SHARD, DIST_STEPS, DIST_PROFILED = 4, 131_072, 10, 4
DIST_POS_TOL = 1e-3                  # tests/test_distributed.py:243
DIST_SIR_STEPS, DIST_DIFF_STEPS, DIST_PL_STEPS = 20, 8, 8
DIST_EXAMPLE = ("epidemiology", {"EXAMPLE_N": "6000", "EXAMPLE_EPOCHS": "5"},
                ["--distributed"], ())       # .github/workflows/ci.yml:188


def _dist_tag_behavior():
    """A behavior that does nothing but carry each agent's index (an int32
    extra channel), so two runs are matched agent by agent: at 524,288
    agents a lexsort of positions pairs up different agents wherever an
    ulp reorders two nearly equal coordinates."""
    from repro_torch.core.behaviors import Behavior, BehaviorEffects
    import torch

    class Tag(Behavior):
        name = "tag"

        def extra_specs(self):
            return {"tag": ((), torch.int32, -1)}

        def __call__(self, ctx, pool, rng):
            return BehaviorEffects()
    return Tag()


def _synced_steps(sim, st, steps: int):
    """``steps`` steps, each timed on the host clock to a synchronise;
    every never-silent flag read after each step (outside its time) must
    be clear. Returns the state and each step's ms."""
    import torch
    ms = []
    torch.cuda.synchronize()
    for i in range(steps):
        t0 = time.perf_counter()
        st = sim.step(st)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        check(not st.stats.flags(), f"step {i}: flags {st.stats.flags()}")
    return st, ms


def _by_tag(channels: dict, alive) -> dict:
    """The live agents' channels on the host, ordered by their tag."""
    a = alive.cpu().numpy()
    tag = channels["extra.tag"].cpu().numpy()[a]
    order = tag.argsort()
    return {k: v.cpu().numpy()[a][order] for k, v in channels.items()}


@contextlib.contextmanager
def _first_call(module, name: str, when=None):
    """While the block runs, ``module.name`` records the arguments of its
    first call (tensors cloned, as the call received them) and then runs
    the call unchanged: a kernel's inputs as the distributed step gives
    them. With ``when``, the first call for which ``when(*args, **kw)``
    holds."""
    import torch
    real = getattr(module, name)
    seen = {}

    def keep(a):
        return a.clone() if isinstance(a, torch.Tensor) else a

    def spy(*args, **kw):
        if not seen and (when is None or when(*args, **kw)):
            seen["args"] = tuple(keep(a) for a in args)
            seen["kw"] = {k: keep(v) for k, v in kw.items()}
        return real(*args, **kw)
    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _dist_k1_vs_plain(label: str, cfg, args) -> dict:
    """On the inputs the distributed step handed ``ops.k1_inputs`` (every
    shard's in-step pool, ghost rows in it but not queried): the lane-aware
    column map (the stencil map, or the pairs map when ``args`` carry a
    pair list) ≡ its plain version entry for entry, and K1 on that map ≡
    plain K1; each timed beside its plain version and its bound."""
    import torch
    from repro_torch.kernels import ops
    got = ops.k1_inputs(*args)
    torch.cuda.synchronize()
    want = ops.k1_inputs_plain(*args)
    torch.cuda.synchronize()
    for gt, w, what in zip(got, want, ("data_t", "block_cols", "overflow",
                                       "row mask")):
        check(gt.dtype == w.dtype and torch.equal(gt, w),
              f"{label} the column map differs from plain in {what}")
    lanes = args[12]
    check(tuple(got[2].shape) == (lanes.n,) and not bool(got[2].any()),
          f"{label} per-shard column-map overflow")
    position, alive, active, starts, pairs = (args[0], args[3], args[4],
                                              args[5], args[11])
    timed = ({"ms": cuda_ms(lambda: ops.k1_inputs(*args), iters=20,
                            warmup=3)} if pairs is None
             else _pairs_map_vs_previous(label, args))
    ms = timed["ms"]
    plain_ms = cuda_ms(lambda: ops.k1_inputs_plain(*args), iters=2,
                       warmup=0)
    if pairs is None:
        bound_ms, bound_by, work = column_map_bound(position, starts,
                                                    got[0], got[1])
    else:
        bound_ms, bound_by, work = pairs_map_bound(types.SimpleNamespace(
            position=position, alive=alive), pairs, got[0], got[1])
    rows = {"rows": position.shape[0], "lanes": lanes.n,
            "queried_rows": int((active & alive).sum()),
            "ghost_rows": int((alive & ~active).sum())}
    cmap = {"equal": True, "max_abs_err": 0.0, **timed,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "n_pad": got[0].shape[1], **rows, **work}
    name = "pairs map" if pairs is not None else "column map"
    print(f"{label} {name} on the step's own {lanes.n} x "
          f"{lanes.capacity} rows ({rows['queried_rows']} queried, "
          f"{rows['ghost_rows']} live ghosts not): kernel {ms:.4f} ms"
          + ("" if pairs is None else
             f" (first design {timed['previous_design_ms']:.4f} ms in the "
             f"same call)")
          + f", plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); "
          f"block_cols, per-shard flags, data_t and row mask equal",
          flush=True)
    k1_rec = _k1_vs_plain(label, got[0], got[1], cfg)
    k1_rec["library_ms"] = None
    return {"map": cmap, "k1": k1_rec}


def _dist_weak(force_impl: str) -> dict:
    """[28a] the 4-shard step against the solo step at 524,288 agents."""
    import numpy as np
    import torch
    from repro_torch.core import DistributedSimulation, Simulation
    from repro_torch.launch import distributed as launcher
    sc = launcher.scenario(dict(scenario="weak", force_impl=force_impl,
                                agents_per_shard=DIST_PER_SHARD,
                                n_shards=DIST_SHARDS))
    dcfg, pos = sc.dcfg, sc.position
    n = pos.shape[0]
    init = dict(diameter=sc.init["diameter"],
                extra_init={"tag": np.arange(n, dtype=np.int32)})
    beh = [_dist_tag_behavior()]
    solo = Simulation(dcfg.engine, beh, device="cuda")
    s_st, s_ms = _synced_steps(solo, solo.init_state(pos, **init),
                               DIST_STEPS)
    dsim = DistributedSimulation(dcfg, beh, device="cuda")
    t0 = time.perf_counter()
    d_st = dsim.init_state(pos, **init)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    _reset_counts()
    d_st, d_ms = _synced_steps(dsim, d_st, DIST_STEPS)
    launches = _read_counts()
    if force_impl == "k1":
        for k in ("k1_collision_force", "k1_column_map"):
            check(launches[k] == DIST_STEPS,
                  f"[28a] {k} launched {launches[k]} times in {DIST_STEPS} "
                  f"steps of {DIST_SHARDS} shards, not once a step")
    checks = None
    if force_impl == "k1":
        # one more step, its K1 inputs kept: the kernels ≡ plain on them
        from repro_torch.kernels import ops
        with _first_call(ops, "k1_inputs") as cap:
            dsim.step(d_st)
        checks = _dist_k1_vs_plain("[28a]", dcfg.engine, cap["args"])
    want = _by_tag(s_st.pool.channels(), s_st.pool.alive)
    got = _by_tag(d_st.channels, d_st.channels["alive"])
    check(len(want["extra.tag"]) == len(got["extra.tag"]) == n,
          f"[28a] live counts {len(want['extra.tag'])} (solo), "
          f"{len(got['extra.tag'])} (4 shards), not {n}")
    check(np.array_equal(want["extra.tag"], got["extra.tag"]),
          "[28a] the live agents differ")
    err = float(np.abs(want["position"] - got["position"]).max())
    check(err < DIST_POS_TOL, f"[28a] positions differ by {err:.3g}")
    nnz_rows = int((want["force_nnz"] != got["force_nnz"]).sum())
    d_prof = _profiled(dsim, d_st, DIST_PROFILED)
    s_prof = _profiled(solo, s_st, DIST_PROFILED)
    return {"force_impl": force_impl, "agents": n,
            "side": dcfg.engine.domain_hi[0],
            "local_capacity": dcfg.local_capacity,
            "halo_capacity": dcfg.halo_capacity,
            "migrate_capacity": dcfg.migrate_capacity,
            "total_capacity": dcfg.total_capacity, "steps": DIST_STEPS,
            "dist_ms_steps": d_ms, "solo_ms_steps": s_ms,
            "dist_ms_median": statistics.median(d_ms),
            "solo_ms_median": statistics.median(s_ms),
            "dist_init_ms": init_ms, "launches": launches,
            "per_shard_live": d_st.stats.n_live.tolist(),
            "boundaries": d_st.boundaries.tolist(),
            "max_abs_pos_diff": err, "force_nnz_rows_differ": nnz_rows,
            "kernel_checks": checks,
            "dist_profiled": {k: v for k, v in d_prof.items()
                              if k != "profile"},
            "solo_profiled": {k: v for k, v in s_prof.items()
                              if k != "profile"},
            "dist_top_ops": d_prof["profile"]["top_device_ops"],
            "dist_ranges": d_prof["profile"]["ranges"]}


def _dist_sir_parts():
    """tests/test_distributed.py's SIR case (its drift, deterministic
    infection, births and deaths, migration and rebalance) with K1, as the
    launcher builds it: (DistConfig, behaviors factory, positions,
    init)."""
    from repro_torch.launch import distributed as launcher
    sc = launcher.scenario({"scenario": "sir", "force_impl": "k1"})
    return sc.dcfg, sc.behaviors, sc.position, sc.init


def _dist_run(dcfg, behaviors, pos, init, steps: int, device: str):
    """(final state, every step's stats as host lists)."""
    from repro_torch.core import DistributedSimulation
    dsim = DistributedSimulation(dcfg, behaviors, device=device)
    st = dsim.init_state(pos, **init)
    stats = []
    for _ in range(steps):
        st = dsim.step(st)
        stats.append({f: v.tolist() for f, v in st.stats.items()})
    return st, stats


def _per_shard_live(st, c: int, names) -> list:
    """Each shard's live agents (position first, then ``names``), sorted
    by position."""
    import numpy as np
    ch = {k: v.cpu().numpy() for k, v in st.channels.items()}
    out = []
    for s in range(len(ch["alive"]) // c):
        sl = slice(s * c, (s + 1) * c)
        a = ch["alive"][sl]
        p = ch["position"][sl][a]
        o = np.lexsort(p.T)
        out.append([p[o]] + [ch[k][sl][a][o] for k in names])
    return out


def _dist_sir_vs_cpu() -> dict:
    """[28b] the SIR case on the card ≡ the port's CPU run of it."""
    import numpy as np
    import torch
    dcfg, beh, pos, init = _dist_sir_parts()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)                 # as phase 2
    try:
        cpu, cpu_stats = _dist_run(dcfg, beh(), pos, init, DIST_SIR_STEPS,
                                   "cpu")
    finally:
        torch.set_num_threads(threads)
    _reset_counts()
    card, card_stats = _dist_run(dcfg, beh(), pos, init, DIST_SIR_STEPS,
                                 "cuda")
    launches = _read_counts()
    for i, (w, g) in enumerate(zip(cpu_stats, card_stats)):
        check(w == g, f"[28b] stats after step {i} differ: {w} vs {g}")
    names = ("agent_type", "extra.post", "extra.infect_timer", "born_iter")
    worst = 0.0
    for s, (w, g) in enumerate(zip(_per_shard_live(cpu, 512, names),
                                   _per_shard_live(card, 512, names))):
        check(w[0].shape == g[0].shape, f"[28b] shard {s} live counts")
        worst = max(worst, float(np.abs(w[0] - g[0]).max(initial=0.0)))
        for k, a, b in zip(names, w[1:], g[1:]):
            check(np.array_equal(a, b), f"[28b] shard {s} {k} differs")
    check(worst <= 1e-4, f"[28b] positions differ by {worst:.3g}")
    np.testing.assert_allclose(card.boundaries.cpu().numpy(),
                               cpu.boundaries.numpy(), rtol=0, atol=1e-4)
    tot = lambda f: sum(sum(st[f]) for st in card_stats)  # noqa: E731
    check(tot("births") > 0 and tot("deaths") > 0, "[28b] no births/deaths")
    types = card.channels["agent_type"][card.channels["alive"]]
    return {"steps": DIST_SIR_STEPS, "max_abs_pos_diff": worst,
            "births": tot("births"), "deaths": tot("deaths"),
            "infected_or_recovered": int((types != 0).sum()),
            "per_shard_live": card.stats.n_live.tolist(),
            "launches": launches}


def _dist_diffusion() -> dict:
    """[28c] tests/test_distributed.py's sharded-diffusion case on the
    card against the solo card run; secretion once a step for all shards,
    and ≡ its plain version on the first step's own inputs."""
    import numpy as np
    from repro_torch.core import Simulation, diffusion
    from repro_torch.launch import distributed as launcher
    sc = launcher.scenario({"scenario": "diffusion"})
    dcfg, beh, pos, init = sc.dcfg, sc.behaviors, sc.position, sc.init
    cfg = dcfg.engine
    sim = Simulation(cfg, beh(), device="cuda")
    st = sim.run(sim.init_state(pos, **init), DIST_DIFF_STEPS,
                 check_overflow=True)
    _reset_counts()
    with _first_call(diffusion, "add_sources") as cap:
        dst, _ = _dist_run(dcfg, beh(), pos, init, DIST_DIFF_STEPS, "cuda")
    launches = _read_counts()
    kernel = _dist_secretion_vs_plain(cap["args"])
    check(launches["secretion"] == DIST_DIFF_STEPS,
          f"[28c] secretion launched {launches['secretion']} times in "
          f"{DIST_DIFF_STEPS} steps of 4 shards, not once a step")
    ref = st.conc.cpu().numpy()
    scale = float(ref.max())
    err = float(np.abs(ref - dst.conc.cpu().numpy()).max())
    check(scale > 0 and err <= 1e-4 * max(1.0, scale),
          f"[28c] conc differs by {err:.3g} (scale {scale:.3g})")
    a, da = st.pool.alive.cpu().numpy(), dst.channels["alive"].cpu().numpy()
    p = st.pool.position.cpu().numpy()[a]
    q = dst.channels["position"].cpu().numpy()[da]
    check(p.shape == q.shape, "[28c] live counts differ")
    perr = float(np.abs(p[np.lexsort(p.T)] - q[np.lexsort(q.T)]).max())
    check(perr < DIST_POS_TOL, f"[28c] positions differ by {perr:.3g}")
    return {"steps": DIST_DIFF_STEPS, "conc_max_abs_diff": err,
            "conc_scale": scale, "max_abs_pos_diff": perr,
            "launches": launches, "kernel_check": kernel}


def _dist_secretion_vs_plain(args) -> dict:
    """[28c] on the inputs the distributed step handed
    ``diffusion.add_sources`` (every shard's rows into its own zeroed
    full-size grid of the (n_shards, X, Y, Z) stack): the secretion kernel
    ≡ its plain version, ``index_add`` on the CPU in slot order, bit for
    bit; timed beside it, the card's ``index_add_`` and the bound."""
    import numpy as np
    import torch
    from repro_torch.core import diffusion
    spec, grids, position, amount, origin, lanes = args
    got = diffusion.add_sources(*args)
    torch.cuda.synchronize()
    cpu = (spec, grids.cpu(), position.cpu(), amount.cpu(), origin.cpu(),
           lanes)
    want = diffusion.add_sources(*cpu)
    err = float((got.cpu() - want).abs().max())
    check(torch.equal(got.cpu(), want),
          f"[28c] secretion into the shards' grids differs from plain by "
          f"{err:.3g}")
    check(tuple(got.shape) == (lanes.n, *spec.dims),
          f"[28c] secretion grids {tuple(got.shape)}")
    flat = diffusion._flat(spec, diffusion.voxel_of(spec, position, origin),
                           lanes)
    lib = grids.reshape(-1).clone()
    ms = cuda_ms(lambda: diffusion.add_sources(*args), iters=20, warmup=3)
    lib_ms = cuda_ms(lambda: lib.index_add_(0, flat, amount), iters=20,
                     warmup=3)
    t0 = time.perf_counter()
    for _ in range(3):
        diffusion.add_sources(*cpu)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 3
    n, v = position.shape[0], int(np.prod(grids.shape))
    bound_ms, moved = secretion_bound(n, v)
    rec = {"agents": n, "voxels": v, "equal": True, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "plain_device": "cpu",
           "library_ms": lib_ms, "bound_ms": bound_ms,
           "bound_by": "bytes", "bytes": moved}
    print(f"[28c] secretion on the step's own {n} rows into {lanes.n} "
          f"grids of {spec.dims}: kernel {ms:.4f} ms, "
          f"plain (index_add on the CPU, host clock) {plain_ms:.2f} ms, "
          f"index_add_ on the card {lib_ms:.4f} ms, bound "
          f"{rec['bound_ms']:.5f} ms (bytes); bit-equal to plain",
          flush=True)
    return rec


def _dist_ladder() -> dict:
    """[28d] tests/test_ladder.py:309's distributed ladder on the card ≡ a
    run pre-sized at its final rungs, bit for bit."""
    import torch
    from repro_torch.core import (DistributedCapacityLadder,
                                  DistributedSimulation)
    from repro_torch.launch import distributed as launcher
    sc = launcher.scenario({"scenario": "ladder"})
    beh, pos, dia = sc.behaviors, sc.position, sc.init["diameter"]
    n0 = pos.shape[0]
    dl = DistributedCapacityLadder(sc.dcfg, beh(), device="cuda")
    _reset_counts()
    st = dl.run(dl.init_state(pos, diameter=dia), 7)
    launches = _read_counts()
    ds = DistributedSimulation(dl.dcfg, beh(), device="cuda")
    st2 = ds.run(ds.init_state(pos, diameter=dia), 7, check_overflow=True)
    for k, v in st.channels.items():
        check(torch.equal(v, st2.channels[k]),
              f"[28d] the ladder's {k} differs from the pre-sized run's")
    n_live = int(st.channels["alive"].sum())
    check(n_live > n0, "[28d] the population did not grow")
    return {"rungs": _rung_schedule(dl.rungs), "recompiles": dl.recompiles,
            "n_live": n_live, "per_shard_live": st.stats.n_live.tolist(),
            "final": {f: getattr(dl.dcfg, f) for f in (
                "local_capacity", "halo_capacity", "migrate_capacity")},
            "launches": launches}


def _dist_pairlist_vs_plain(cap) -> dict:
    """[28d] on the inputs the distributed step handed
    ``grid.build_pairlist`` (every shard's in-step pool and its lane
    tables): the lane-aware build ≡ its plain version, every field; timed
    beside it and its bound."""
    import torch
    from repro_torch.core import grid as grid_mod
    spec, g, position, alive = cap["args"]
    kw = cap["kw"]
    got = grid_mod.build_pairlist(spec, g, position, alive, **kw)
    torch.cuda.synchronize()
    want = grid_mod.build_pairlist_plain(spec, g, position, alive, **kw)
    for f in ("idx", "run_off", "count", "demand"):
        check(torch.equal(getattr(got, f), getattr(want, f)),
              f"[28d] the pair-list build differs from plain in {f}")
    lanes = g.starts.shape[0] // spec.table_size
    check(tuple(got.demand.shape) == (lanes,)
          and int(got.demand.max()) <= kw["max_pairs"],
          f"[28d] pair demand {got.demand.tolist()}")
    ms = cuda_ms(lambda: grid_mod.build_pairlist(
        spec, g, position, alive, **kw), iters=20, warmup=3)
    plain_ms = cuda_ms(lambda: grid_mod.build_pairlist_plain(
        spec, g, position, alive, **kw), iters=2, warmup=0)
    bound_ms, bound_by, work = pairlist_bound(spec, g, types.SimpleNamespace(
        position=position, alive=alive), got)
    print(f"[28d] pair-list build on the step's own {lanes} x "
          f"{position.shape[0] // lanes} rows: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}); idx, "
          f"run_off, count and per-shard demand equal", flush=True)
    return {"equal": True, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "rows": position.shape[0], "lanes": lanes,
            **work}


def _dist_pairlist() -> dict:
    """[28d] tests/test_pairlist.py:410's 4-shard case with K1 on the
    card: the stencil map ≡ a skin-0 pair list's map (the pair-list build
    and the pairs map once a step for all shards), and the max_pairs rung
    ≡ the pre-sized run, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core import (DistConfig, DistributedCapacityLadder,
                                  DistributedSimulation, EngineConfig,
                                  PairListConfig, grid as grid_mod)
    from repro_torch.core.behaviors import INFECTED, Infection, RandomWalk
    from repro_torch.kernels import ops
    side, n = 48.0, 1024
    rng = np.random.default_rng(7)
    pos = rng.uniform(2, side - 2, (n, 3)).astype(np.float32)
    types = np.zeros(n, np.int32)
    types[:32] = INFECTED

    def dcfg(pl):
        return DistConfig(engine=EngineConfig(
            capacity=n, domain_lo=(0., 0., 0.), domain_hi=(side,) * 3,
            interaction_radius=3.0, max_per_box=32, query_chunk=256,
            force_impl="k1", pairlist=pl), n_shards=4,
            local_capacity=2 * n // 4, halo_capacity=256,
            migrate_capacity=256)

    def beh():
        return [RandomWalk(sigma=0.35),
                Infection(radius=3.0, beta=0.4, recovery_time=8)]

    def init(sim):
        return sim.init_state(pos, np.full(n, 2.5, np.float32), types,
                              extra_init={"infect_timer":
                                          np.full(n, 8, np.int32)})
    out, launches, checks = {}, None, None
    for pl in (None, PairListConfig(skin=0.0, max_pairs=96)):
        sim = DistributedSimulation(dcfg(pl), beh(), device="cuda")
        st = init(sim)
        _reset_counts()
        st = sim.run(st, DIST_PL_STEPS, check_overflow=True)
        if pl is not None:
            launches = _read_counts()
            # one more step, its list and map inputs kept: ≡ plain on them
            with _first_call(grid_mod, "build_pairlist") as cap_pl, \
                    _first_call(ops, "k1_inputs") as cap_map:
                sim.step(st)
            checks = {"pairlist_build": _dist_pairlist_vs_plain(cap_pl),
                      **_dist_k1_vs_plain("[28d]", sim.dcfg.engine,
                                          cap_map["args"])}
        out[pl is None] = st.channels
    for k in ("pairlist_build", "k1_pair_cols", "k1_collision_force"):
        check(launches[k] == DIST_PL_STEPS,
              f"[28d] {k} launched {launches[k]} times in {DIST_PL_STEPS} "
              f"steps of 4 shards, not once a step")
    same = all(torch.equal(out[True][k], out[False][k]) for k in out[True])
    a = out[True]["alive"].cpu().numpy()
    p = out[True]["position"].cpu().numpy()[a]
    q = out[False]["position"].cpu().numpy()[out[False]["alive"].cpu(
    ).numpy()]
    check(p.shape == q.shape, "[28d] live counts differ")
    err = float(np.abs(p[np.lexsort(p.T)] - q[np.lexsort(q.T)]).max())
    check(err <= 1e-5, f"[28d] list vs stencil map: positions {err:.3g}")
    lad = DistributedCapacityLadder(
        dcfg(PairListConfig(skin=0.0, max_pairs=2)), beh(), device="cuda")
    st = init(lad)
    for _ in range(4):
        st = lad.step(st)
    grown = lad.dcfg.engine.pairlist.max_pairs
    pre = DistributedSimulation(dcfg(PairListConfig(skin=0.0,
                                                    max_pairs=grown)),
                                beh(), device="cuda")
    sp = init(pre)
    for _ in range(4):
        sp = pre.step(sp)
    for k, v in st.channels.items():
        check(torch.equal(v, sp.channels[k]),
              f"[28d] the max_pairs rung's {k} differs from pre-sized")
    return {"steps": DIST_PL_STEPS, "launches": launches,
            "kernel_checks": checks, "list_vs_stencil_bit_equal": same,
            "list_vs_stencil_max_abs_diff": err,
            "max_pairs_rungs": _rung_schedule(lad.rungs)}


def phase_distributed(report: dict, tmpdir: str) -> dict:
    """[28] the distributed engine on the card: (a) the weak-scaling case
    against the solo step, streamed and K1; (b) SIR card ≡ CPU; (c)
    sharded diffusion ≡ solo; (d) the ladder and the pair-list rung ≡
    pre-sized, and the epidemiology example distributed. Every kernel of
    the path is also held against its plain version on the inputs a
    distributed step gave it: K1 and its map in (a), secretion in (c),
    the list build, the pairs map and K1 in (d)."""
    from repro_torch.device import card_description
    card = card_description()
    rec = {"card": card, "weak": {}}
    for impl in ("streamed", "k1"):
        r = rec["weak"][impl] = _dist_weak(impl)
        dp, sp = r["dist_profiled"], r["solo_profiled"]
        print(f"[28a] {impl}: {r['agents']} agents over {DIST_SHARDS} "
              f"shards (local {r['local_capacity']}, halo "
              f"{r['halo_capacity']}, migrate {r['migrate_capacity']}; "
              f"lanes of {r['total_capacity']}), {r['steps']} steps: "
              f"{r['dist_ms_median']:.3f} ms/step (median) against "
              f"{r['solo_ms_median']:.3f} solo; device ops/step "
              f"{dp['device_ops_per_step']:.0f} vs "
              f"{sp['device_ops_per_step']:.0f}, idle share "
              f"{dp['device_idle_share']:.3f} vs "
              f"{sp['device_idle_share']:.3f}, busy ms/step "
              f"{dp['device_busy_ms_per_step']:.3f} vs "
              f"{sp['device_busy_ms_per_step']:.3f} ({DIST_PROFILED} "
              f"profiled steps); ≡ solo agent by agent, max|Δpos| "
              f"{r['max_abs_pos_diff']:.3g}, force_nnz differs in "
              f"{r['force_nnz_rows_differ']} rows; per-shard live "
              f"{r['per_shard_live']}; K1 "
              f"{r['launches']['k1_collision_force']}, map "
              f"{r['launches']['k1_column_map']} launches; {card}",
              flush=True)
    r = rec["sir"] = _dist_sir_vs_cpu()
    print(f"[28b] SIR on 4 shards (K1), {r['steps']} steps: card ≡ CPU, "
          f"every step's stats equal, per shard integers equal, max|Δpos| "
          f"{r['max_abs_pos_diff']:.3g}; births {r['births']}, deaths "
          f"{r['deaths']}, per-shard live {r['per_shard_live']}; K1 "
          f"{r['launches']['k1_collision_force']} launches", flush=True)
    r = rec["diffusion"] = _dist_diffusion()
    print(f"[28c] sharded diffusion, {r['steps']} steps: conc within "
          f"{r['conc_max_abs_diff']:.3g} of the solo card run (scale "
          f"{r['conc_scale']:.3g}), positions {r['max_abs_pos_diff']:.3g}; "
          f"secretion {r['launches']['secretion']} launches", flush=True)
    r = rec["ladder"] = _dist_ladder()
    print(f"[28d] distributed ladder ≡ pre-sized bit for bit: rungs "
          f"{r['rungs']}, final {r['final']}, {r['n_live']} live "
          f"{r['per_shard_live']}; K1 {r['launches']['k1_collision_force']} "
          f"launches (re-runs included)", flush=True)
    r = rec["pairlist"] = _dist_pairlist()
    same = ("bit for bit" if r["list_vs_stencil_bit_equal"] else
            f"max|Δ| {r['list_vs_stencil_max_abs_diff']:.3g}")
    print(f"[28d] pair list over 4 shards, {r['steps']} steps: ≡ the "
          f"stencil map ({same}); "
          f"build {r['launches']['pairlist_build']}, pairs map "
          f"{r['launches']['k1_pair_cols']}, K1 "
          f"{r['launches']['k1_collision_force']} launches; max_pairs "
          f"rungs {r['max_pairs_rungs']} ≡ pre-sized bit for bit",
          flush=True)
    name, env, argv, must = DIST_EXAMPLE
    rec["example"] = _example_on_the_card(name, env, argv, must, tmpdir,
                                          "28d")
    report["distributed"] = rec
    return rec


# ---------------------------------------------------------------------------
# phase 29: LM training
# ---------------------------------------------------------------------------

# (a) qwen2-1.5b at full width and depth (bf16 params, f32 moments, remat
# full), 2 × 4,096 tokens a step (qwen2's pretraining context,
# arXiv:2407.10671 §3); steps 2-5 are timed, then one more is profiled
TRAIN = dict(arch="qwen2-1.5b", batch=2, seq_len=4096, steps=5, lr=3e-4,
             warmup=2, seed=0)
# (b) reduced_config(qwen2-1.5b) in f32 with the full-width run's remat,
# 3 steps card ≡ CPU from the same weights and batches
TRAIN_PARITY = dict(steps=3, seq_len=64, batch=4, rtol=1e-4, param_atol=1e-6,
                    seed=3)
# (d) the example at CI's size (.github/workflows/ci.yml:194), then its
# default 60 steps uninterrupted and SIGKILLed after the step-20 checkpoint
# and resumed, both deterministic (torch.use_deterministic_algorithms,
# CUBLAS_WORKSPACE_CONFIG set before CUDA starts): the two must end bit for
# bit equal
TRAIN_EXAMPLE_STEPS, TRAIN_KILL_AFTER = 5, 20
DETERMINISTIC_MAIN = ("import sys, torch; "
                      "torch.use_deterministic_algorithms(True); "
                      "from repro_torch.examples.train_lm import main; "
                      "main(sys.argv[1:])")


def train_flops(cfg, n_params: int, tokens: int, seq_len: int) -> float:
    """Model FLOPs of one training step (no recomputation counted):
    6·N·T for the weights plus 12·L·H·d_head·S·T for the attention
    scores and their use (the PaLM paper's count, causal mask ignored)."""
    return tokens * (6 * n_params + 12 * cfg.n_layers * cfg.n_heads
                     * cfg.d_head * seq_len)


def _kernel_classes(events: list) -> dict:
    """Device ms of one profiled step by kind of kernel: the f32 GEMMs
    (the plain ``_sdpa``'s einsums, on the CUDA cores), the bf16 GEMMs
    (projections, MLP, logits), softmax, and everything else."""
    out = {"f32 GEMM": 0.0, "bf16 GEMM": 0.0, "softmax": 0.0, "other": 0.0}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name = e["name"]
        if "gemm" in name.lower() or name.startswith("nvjet"):
            kind = ("f32 GEMM" if "f32f32" in name or "sgemm" in name
                    else "bf16 GEMM")
        else:
            kind = "softmax" if "SoftMax" in name else "other"
        out[kind] += e["dur"] / 1e3
    return out


@contextlib.contextmanager
def _recording(module, name: str, pick):
    """While the block runs, ``module.name`` appends ``pick(output)`` of
    every call to the yielded list (device tensors: no host read)."""
    real = getattr(module, name)
    seen = []

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(pick(out))
        return out
    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _train_full_width(spec: dict, tag: str) -> dict:
    """[29a, 33a-b] ``spec``'s config at full width on the card (its depth
    cut to ``spec["n_layers"]`` where set): the steps through
    ``make_train_step`` with the cell's microbatches, each timed by CUDA
    events and the host clock; every loss (with its aux) and grad_norm
    finite, the loss lower after the last step than after the first; then
    one more step profiled, the MoE layers' kept masks recorded in it and
    read after it."""
    import torch
    from repro_torch.configs import ARCHS, ShapeSpec
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.launch import cells
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    cfg = ARCHS[spec["arch"]]
    if spec.get("n_layers") is not None:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    check(cfg.param_dtype == "bfloat16" and cfg.remat == "full"
          and cfg.opt_moment_dtype == "float32", f"{tag} {cfg}")
    n_micro = cells.microbatches(spec["arch"], "train_4k")
    torch.cuda.empty_cache()
    model = build_model(cfg, attn_impl="sdpa", device="cuda")
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(spec["seed"]))
    ocfg = AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup"],
                       total_steps=spec["steps"],
                       moment_dtype=cfg.opt_moment_dtype)
    state = init_state(ocfg, params)
    step_fn = make_train_step(model, ocfg, n_microbatches=n_micro)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq_len"],
                      global_batch=spec["batch"], seed=spec["seed"])
    tokens = spec["batch"] * spec["seq_len"]
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    metrics, ev_ms, host_ms = [], [], []
    with _recording(model, "train_loss",
                    lambda out: out[1]["aux"].detach()) as auxes:
        for i in range(spec["steps"]):
            batch = batch_at(dcfg, i, device="cuda")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            params, state, met = step_fn(params, state, batch)
            stop.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            ev_ms.append(start.elapsed_time(stop))
            metrics.append(met)
    peak = torch.cuda.max_memory_allocated()
    rows = [{k: float(v) for k, v in m.items()} for m in metrics]
    for i, r in enumerate(rows):
        r["aux"] = sum(float(a) for a in
                       auxes[i * n_micro:(i + 1) * n_micro]) / n_micro
        check(all(math.isfinite(v) for v in r.values()),
              f"{tag} step {i + 1} metrics {r}")
    check(rows[-1]["loss"] < rows[0]["loss"],
          f"{tag} the loss did not fall: {[r['loss'] for r in rows]}")
    check(int(state["step"]) == spec["steps"], f"{tag} {state['step']}")
    check((rows[0]["aux"] > 0) == bool(cfg.n_experts),
          f"{tag} aux {rows[0]['aux']}")
    batch = batch_at(dcfg, spec["steps"], device="cuda")
    with _recording(moe_mod, "positions", lambda out: out[2]) as kept:
        prof = _profiled_call(lambda: step_fn(params, state, batch))
    dropped = sum(int((~k).sum()) for k in kept)
    assignments = sum(k.numel() for k in kept)
    ms = statistics.median(ev_ms[1:])
    host = statistics.median(host_ms[1:])
    flops = cells.analytic_step_flops(cfg, ShapeSpec(
        "train", spec["seq_len"], spec["batch"], "train"))
    rec = {"config": spec, "n_layers": cfg.n_layers,
           "n_params": model.n_params(),
           "n_active_params": cells._count_active_params(model, cfg),
           "microbatches": n_micro, "tokens_per_step": tokens,
           "steps": rows, "ms_per_step_events": ev_ms,
           "ms_per_step_host": host_ms, "ms_per_step_median": ms,
           "ms_per_step_host_median": host,
           "tokens_per_s": tokens / (host / 1e3),
           "weights_bytes": weights, "peak_memory_bytes": peak,
           "analytic_flops_per_step": flops,
           "mfu_bf16": flops / (ms / 1e3) / PEAK_BF16_TENSOR_FLOPS,
           "profiled": prof}
    if cfg.n_experts:
        rec.update(capacity_factor=cfg.capacity_factor,
                   assignments=assignments, dropped=dropped,
                   dropped_share=dropped / assignments,
                   positions_calls=len(kept))
    del params, state, metrics, batch, kept, auxes
    torch.cuda.empty_cache()
    return rec


def _print_train_full(tag: str, r: dict, card: str) -> None:
    spec = r["config"]
    print(f"{tag} train {spec['arch']} at full width ({r['n_layers']} "
          f"layers, {r['n_params']:,} params, {r['n_active_params']:,} "
          f"active; bf16, f32 moments, remat full), {spec['batch']} x "
          f"{spec['seq_len']} tokens a step in {r['microbatches']} "
          f"microbatch(es), {spec['steps']} AdamW steps: loss "
          + " ".join(f"{s['loss']:.5g}" for s in r["steps"])
          + "; aux " + " ".join(f"{s['aux']:.5g}" for s in r["steps"])
          + "; grad_norm " + " ".join(f"{s['grad_norm']:.4g}"
                                       for s in r["steps"]), flush=True)
    print(f"{tag} {r['ms_per_step_median']:.1f} ms/step by CUDA events, "
          f"{r['ms_per_step_host_median']:.1f} by the host clock (median of "
          f"steps 2-{spec['steps']}; step 1 {r['ms_per_step_events'][0]:.1f})"
          f"; {r['tokens_per_s']:.0f} tokens/s; weights and moments "
          f"{r['weights_bytes'] / 1e9:.2f} GB, peak memory of the steps "
          f"{r['peak_memory_bytes'] / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated); model-FLOPs share of the "
          f"bf16 peak {r['mfu_bf16']:.4f} = launch/cells.analytic_step_flops "
          f"{r['analytic_flops_per_step']:.4g} FLOPs (the recompute "
          f"included) / (ms/step · {PEAK_BF16_TENSOR_FLOPS:.4g} FLOP/s); "
          f"{card}", flush=True)
    if "dropped_share" in r:
        print(f"{tag} expert assignments dropped at capacity factor "
              f"{r['capacity_factor']} in the profiled step: "
              f"{r['dropped']:,} of {r['assignments']:,} = "
              f"{r['dropped_share']:.5f} ({r['positions_calls']} routings: "
              f"forward and recompute of each MoE layer and microbatch)",
              flush=True)
    d = r["profiled"]
    print(f"{tag} one profiled step: {d['wall_ms']:.1f} ms, "
          f"{d['launches']:.0f} device ops, busy {d['device_busy_ms']:.1f} "
          f"ms, idle share {d['device_idle_share']:.3f}; device ms by range "
          f"{ {k: round(v['device_ms'], 1) for k, v in d['ranges'].items()} }",
          flush=True)
    for op in d["top_device_ops"][:8]:
        print(f"    {op['device_ms']:9.2f} ms {op['calls']:6.0f} x "
              f"{op['name'][:100]}", flush=True)


def _train_steps(cfg, leaves, batches, ocfg, dev: str,
                 n_micro: int = 1) -> tuple:
    """``len(batches)`` train steps on ``dev`` from the numpy weights
    ``leaves``; returns each step's metrics and the params after each."""
    from repro_torch import convert
    from repro_torch.models import build_model
    from repro_torch.train import init_state, make_train_step

    model = build_model(cfg, attn_impl="sdpa", device=dev)
    params = convert.params_from_numpy(leaves, dev)
    state = init_state(ocfg, params)
    step_fn = make_train_step(model, ocfg, n_microbatches=n_micro)
    rows, after = [], []
    for b in batches:
        params, state, met = step_fn(params, state,
                                     {k: v.to(dev) for k, v in b.items()})
        rows.append({k: float(v) for k, v in met.items()})
        after.append(convert.params_to_numpy(params))
    return rows, after


def _train_card_vs_cpu() -> dict:
    import torch
    from repro_torch import convert
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import build_model, reduced_config
    from repro_torch.train import AdamWConfig

    p = TRAIN_PARITY
    cfg = dataclasses.replace(reduced_config(ARCHS[TRAIN["arch"]]),
                              remat="full")
    ocfg = AdamWConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                       total_steps=TRAIN["steps"])
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=p["seq_len"],
                      global_batch=p["batch"], seed=p["seed"])
    batches = [batch_at(dcfg, i, device="cpu") for i in range(p["steps"])]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)               # as phase 2
    try:
        leaves = convert.params_to_numpy(build_model(
            cfg, device="cpu").init_params(
                torch.Generator().manual_seed(p["seed"])))
        got, got_p = _train_steps(cfg, leaves, batches, ocfg, "cuda")
        want, want_p = _train_steps(cfg, leaves, batches, ocfg, "cpu")
    finally:
        torch.set_num_threads(threads)
    return {"config": dataclasses.asdict(cfg), "steps": p["steps"],
            **_train_runs_agree("[29b]", got, want, got_p[0], want_p[0],
                                ocfg, p)}


def _train_runs_agree(tag: str, got, want, got_p1, want_p1, ocfg,
                      p: dict) -> dict:
    """Card ≡ CPU over train steps: every metric of every step within
    ``p["rtol"]``; the params after step 1 within ``p["param_atol"]`` but
    for at most 1e-3 of the elements, each within 2·lr."""
    import numpy as np
    worst = {k: 0.0 for k in got[0]}
    for i, (g, w) in enumerate(zip(got, want)):
        for k in g:
            rel = abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
            check(rel <= p["rtol"], f"{tag} step {i + 1} {k}: card {g[k]}, "
                                    f"CPU {w[k]}")
            worst[k] = max(worst[k], rel)
    # after step 1 every element moved by lr·m̂/(√v̂ + eps) + lr·wd·p:
    # where |g| >> eps that is lr·sign(g) on both devices, so the card
    # and the CPU agree to param_atol; an element whose |g| is near eps (or
    # whose g changes sign between the two) may differ by up to 2·lr·(1 +
    # wd·|p|) on rounding alone: those are counted and bounded by that
    lr1 = got[0]["lr"]
    n_all = n_loose = 0
    max_diff = 0.0
    want_flat = _flat_np(want_p1)
    for key, a in _flat_np(got_p1).items():
        b = want_flat[key]
        d = np.abs(a.astype(np.float64) - b)
        loose = d > p["param_atol"]
        bound = 2 * lr1 * (1 + ocfg.weight_decay * np.abs(b)) + 1e-7
        check(bool(np.all(d <= bound)), f"{tag} {key}: max|Δp| "
                                        f"{d.max()} beyond 2·lr")
        n_all += d.size
        n_loose += int(loose.sum())
        max_diff = max(max_diff, float(d.max()))
    check(n_loose <= 1e-3 * n_all, f"{tag} {n_loose} of {n_all} elements "
                                   f"differ by more than {p['param_atol']}")
    return {"card": got, "cpu": want, "max_rel_diff": worst,
            "params_after_step1_max_abs_diff": max_diff,
            "params_beyond_atol": n_loose, "params": n_all}


def _flat_np(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_np(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def _k2_refuses_grad() -> dict:
    """K2 under autograd raises on the card, and so does train_loss with
    attn_impl="k2"; neither launches K2."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.models import build_model, reduced_config

    q = torch.randn((1, 12, 256, 128), device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    kv = torch.randn((1, 2, 256, 128), device="cuda", dtype=torch.bfloat16)
    raised = {}
    try:
        k2.flash_attention(q, kv, kv)
    except RuntimeError as e:
        raised["k2"] = str(e)
    cfg = reduced_config(ARCHS[TRAIN["arch"]])
    m = build_model(cfg, attn_impl="k2", device="cuda")
    params = m.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=1), 0, device="cuda")
    try:
        m.train_loss(params, batch)
    except ValueError as e:
        raised["train_loss"] = str(e)
    check(set(raised) == {"k2", "train_loss"},
          f"[29c] K2 under autograd did not raise: {raised}")
    return raised


def _train_lm_child(args: list, env: dict, **kw):
    return subprocess.Popen(
        [sys.executable, "-c", DETERMINISTIC_MAIN, "smoke", *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        **kw)


def _train_example(tmpdir: str) -> dict:
    import contextlib
    import io
    import os
    import signal
    import numpy as np
    from repro_torch.examples import train_lm

    rec = {}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train_lm.main(["smoke", "--steps", str(TRAIN_EXAMPLE_STEPS),
                       "--ckpt", str(Path(tmpdir) / "train_lm_ci")])
    lines = out.getvalue().splitlines()
    check(lines[-1] == "OK", f"[29d] train_lm printed {lines[-3:]}")
    rec["ci"] = {"seconds": time.perf_counter() - t0, "output": lines}

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    full, part = Path(tmpdir) / "train_full", Path(tmpdir) / "train_kill"
    t0 = time.perf_counter()
    proc = _train_lm_child(["--ckpt", str(full)], env)
    stdout, stderr = proc.communicate(timeout=600)
    check(proc.returncode == 0 and stdout.splitlines()[-1] == "OK",
          f"[29d] uninterrupted train_lm exited {proc.returncode}: "
          f"{stderr[-2000:]}")
    rec["uninterrupted"] = {"seconds": time.perf_counter() - t0,
                            "output": stdout.splitlines()}
    proc = _train_lm_child(["--ckpt", str(part)], env)
    mark = part / f"step_{TRAIN_KILL_AFTER:09d}"
    deadline = time.time() + 600
    try:
        while time.time() < deadline and proc.poll() is None \
                and not mark.exists():
            time.sleep(0.005)
        check(proc.poll() is None, "[29d] train_lm ended before its "
                                   f"checkpoint at {TRAIN_KILL_AFTER}")
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()
    from repro_torch.train import checkpoint
    killed_at = checkpoint.latest_step(str(part))
    proc = _train_lm_child(["--ckpt", str(part)], env)
    stdout, stderr = proc.communicate(timeout=600)
    lines = stdout.splitlines()
    check(proc.returncode == 0 and lines[-1] == "OK",
          f"[29d] resumed train_lm exited {proc.returncode}: "
          f"{stderr[-2000:]}")
    check(f"[train] resuming from checkpoint step {killed_at}" in lines,
          f"[29d] the resumed run did not resume at {killed_at}: {lines}")
    last = checkpoint.latest_step(str(full))
    check(checkpoint.latest_step(str(part)) == last == 60,
          f"[29d] final steps {last}")
    with np.load(full / f"step_{last:09d}" / "arrays.npz") as a, \
            np.load(part / f"step_{last:09d}" / "arrays.npz") as b:
        n_leaves = len(a.files)
        differ = [k for k in a.files if not np.array_equal(a[k], b[k])]
        check(sorted(a.files) == sorted(b.files) and not differ,
              f"[29d] the resumed run's final checkpoint differs in "
              f"{differ}")
    def final_line(out):                # the line less its tok/s
        return [ln.split(" tok/s")[0] for ln in out
                if ln.startswith(f"[train] step {last}/")][-1]
    final = final_line(rec["uninterrupted"]["output"])
    check(final == final_line(lines), f"[29d] the final log lines differ: "
                                      f"{final}, {final_line(lines)}")
    rec["killed"] = {"killed_at": killed_at, "output": lines,
                     "final": final, "leaves": n_leaves}
    return rec


def phase_training(report: dict, tmpdir: str) -> dict:
    """[29] LM training on the card: (a) qwen2-1.5b at full width and
    depth, 5 AdamW steps of 2 × 4,096 tokens, timed and one more
    profiled; (b) the reduced model card ≡ CPU for 3 steps; (c) K2 refuses
    autograd; (d) the train_lm example, killed and resumed. K2 launches
    nowhere in the phase (counts reset before (a), read after (d))."""
    from repro_torch.configs import ARCHS
    from repro_torch.device import card_description
    card = card_description()
    _reset_counts()
    rec = {"card": card}
    r = rec["full_width"] = _train_full_width(TRAIN, "[29a]")
    _print_train_full("[29a]", r, card)
    formula = train_flops(ARCHS[TRAIN["arch"]], r["n_params"],
                          r["tokens_per_step"], TRAIN["seq_len"])
    r.update(model_flops_formula="T·(6·N + 12·L·H·d_head·S)",
             model_flops_per_step=formula,
             mfu_bf16_formula=formula / (r["ms_per_step_median"] / 1e3)
             / PEAK_BF16_TENSOR_FLOPS)
    kinds = {k: round(v, 1)
             for k, v in r["profiled"]["device_ms_by_kind"].items()}
    print(f"[29a] model-FLOPs share by {r['model_flops_formula']} (no "
          f"recompute): {r['mfu_bf16_formula']:.4f} ({formula:.4g} "
          f"FLOPs); the profiled step's device ms by kind {kinds}",
          flush=True)
    r = rec["card_vs_cpu"] = _train_card_vs_cpu()
    print(f"[29b] reduced {TRAIN['arch']} (f32, remat full), "
          f"{r['steps']} steps card ≡ CPU: loss, grad_norm, lr within rel "
          f"{ {k: float(f'{v:.3g}') for k, v in r['max_rel_diff'].items()} } "
          f"(bound {TRAIN_PARITY['rtol']}); params after step 1 max|Δ| "
          f"{r['params_after_step1_max_abs_diff']:.3g}, "
          f"{r['params_beyond_atol']} of {r['params']} beyond "
          f"{TRAIN_PARITY['param_atol']} (each within 2·lr)", flush=True)
    rec["k2_refuses_grad"] = _k2_refuses_grad()
    print("[29c] K2 under autograd raises on the card; train_loss with "
          "attn_impl='k2' raises ValueError", flush=True)
    r = rec["example"] = _train_example(tmpdir)
    print(f"[29d] train_lm smoke --steps {TRAIN_EXAMPLE_STEPS}: "
          f"{r['ci']['output'][-2]}, OK in {r['ci']['seconds']:.1f} s; the "
          f"60-step run SIGKILLed after its step-{TRAIN_KILL_AFTER} "
          f"checkpoint (latest on disk: {r['killed']['killed_at']}) and "
          f"resumed ≡ the uninterrupted run bit for bit "
          f"({r['killed']['leaves']} leaves; deterministic algorithms): "
          f"{r['killed']['final']}", flush=True)
    launches = rec["launches"] = _read_counts()
    check(launches["k2_flash_attention"] == 0,
          f"[29] K2 launched {launches['k2_flash_attention']} times in "
          f"training")
    print(f"[29] kernel launches over the phase: {launches}", flush=True)
    report["training"] = rec
    return rec


# ---------------------------------------------------------------------------
# phase 30: the MoE + MLA family served
# ---------------------------------------------------------------------------

# (a) deepseek-v2-lite-16b at full width and depth (configs/
# deepseek_v2_lite_16b.py, arXiv:2405.04434), random bf16 weights, phase 7's
# traffic
SERVE_MOE = dict(SERVE, arch="deepseek-v2-lite-16b")
# (b) the reduced configs in f32, prefill + 4 decode steps card ≡ CPU
MOE_PARITY = dict(archs=("deepseek-v2-lite-16b", "kimi-k2-1t-a32b"),
                  batch=2, prompt=48, steps=4, s_max=64, seed=6)
# phase 31, phase 7's traffic: (a) mamba2-370m at full width and depth
# (configs/mamba2_370m.py, arXiv:2405.21060); (b) jamba-v0.1-52b at full
# width, 16 of its 32 layers (configs/jamba_v0_1_52b.py, arXiv:2403.19887):
# 32 layers are 103 GB of bf16 weights, more than the card's 80 GB; 16
# (two of its 8-layer blocks) run every layer kind at full width
SERVE_SSM = dict(SERVE, arch="mamba2-370m")
SERVE_HYBRID = dict(SERVE, arch="jamba-v0.1-52b", n_layers=16)
# (c) the reduced configs in f32 card ≡ CPU as phase 30 (b); then on the
# card prefill(prompt) + teacher-forced decode ≡ prefill(prompt + extend)
SSM_PARITY = dict(archs=("mamba2-370m", "jamba-v0.1-52b"), batch=2,
                  prompt=48, steps=4, s_max=64, seed=7, extend=12)
DECODE_VS_PREFILL_TOL = 5e-4            # tests/test_arch_smoke.py


def _serve_config(spec: dict):
    from repro_torch.configs import ARCHS
    cfg = ARCHS[spec["arch"]]
    if spec.get("n_layers") is not None:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    return cfg


def _init_and_serve(spec: dict, tag: str) -> dict:
    """Build ``spec``'s model on the card, draw its weights (peak memory of
    the draw) and serve ``spec``'s traffic (peak memory of the serve);
    kernel counts reset just before the serve, read just after. Every
    request must finish with its tokens, the pool leak no page and the
    logits stay finite."""
    import torch
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model

    cfg = _serve_config(spec)
    model = build_model(cfg, device="cuda")
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(spec["seed"]))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    params_bytes = torch.cuda.memory_allocated() - left
    reqs = serve_lm.make_requests(
        spec["requests"], cfg.vocab_size, prompt_min=spec["prompt_min"],
        prompt_max=spec["prompt_max"], new_tokens=spec["new_tokens"],
        seed=spec["seed"])
    frames = serve_lm.make_frames(cfg, reqs, spec["seed"])
    pool = dict(slots=spec["slots"], s_max=spec["s_max"],
                page_size=spec["page_size"], n_pages=spec["n_pages"],
                frames=frames)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rep = serve_lm.serve(model, params, reqs, **pool)
    launches = _read_counts()
    serve_peak = torch.cuda.max_memory_allocated()
    summ = rep.summary()
    check(sorted(f.uid for f in rep.finished) == list(range(len(reqs))),
          f"{tag} finished {sorted(f.uid for f in rep.finished)}")
    check(all(len(f.tokens) == spec["new_tokens"] for f in rep.finished),
          f"{tag} a request stopped short of its new tokens")
    check(rep.n_free == spec["n_pages"],
          f"{tag} pool leaked: {rep.n_free} of {spec['n_pages']} free")
    check(rep.logits_finite, f"{tag} non-finite logits")
    return {"model": model, "params": params, "reqs": reqs,
            "frames": frames, "rec": {
        "config": spec, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_params": model.n_params(), "launches": launches,
        "prompt_lens": [len(r.prompt) for r in reqs],
        "memory_left_before_init_bytes": left, "init_s": init_s,
        "params_bytes": params_bytes, "init_peak_bytes": init_peak,
        "serve_peak_bytes": serve_peak,
        "prefill_ms": [1e3 * t for t in rep.prefill_s], **summ}}


def _print_serve(tag: str, what: str, r: dict, card: str) -> None:
    print(f"{tag} serve {r['config']['arch']} ({r['n_layers']} layers, "
          f"d_model {r['d_model']}, {r['n_params']:,} params, bf16, "
          f"{what}): {r['requests']} requests, {r['prompt_tokens']} prompt "
          f"tokens, {r['generated_tokens']} generated; prefill "
          f"{r['prefill_tokens_per_s']:.0f} tokens/s (mean "
          f"{r['prefill_ms_mean']:.2f} ms per prompt); time to first token "
          f"median {r['ttft_ms_median']:.2f} ms, max {r['ttft_ms_max']:.2f} "
          f"ms; decode {r['decode_ms_per_iter_median']:.2f} ms/iteration "
          f"(median of {r['decode_iterations']}); "
          f"{r['generated_tokens_per_s']:.1f} generated tokens/s; kernel "
          f"launches {r['launches']}", flush=True)
    print(f"{tag} prefill ms by prompt: "
          f"{[f'{n}: {t:.1f}' for n, t in zip(r['prompt_lens'], r['prefill_ms'])]}"
          f" (in order of admission)", flush=True)
    print(f"{tag} memory: {r['memory_left_before_init_bytes'] / 1e9:.2f} GB "
          f"held before the build, weights {r['params_bytes'] / 1e9:.2f} GB "
          f"drawn in {r['init_s']:.1f} s, init peak "
          f"{r['init_peak_bytes'] / 1e9:.2f} GB, serve peak "
          f"{r['serve_peak_bytes'] / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated); {card}", flush=True)


def _moe_init_and_serve() -> dict:
    """[30a] deepseek-v2-lite-16b: MLA + MoE, no kernel launched."""
    cfg = _serve_config(SERVE_MOE)
    check(cfg.mla and cfg.n_experts == 64 and cfg.top_k == 6
          and cfg.n_layers == 27 and cfg.param_dtype == "bfloat16",
          f"[30a] {cfg}")
    run = _init_and_serve(SERVE_MOE, "[30a]")
    launches = run["rec"]["launches"]
    check(not any(launches.values()),
          f"[30a] a kernel launched on the MLA + MoE serve: {launches}")
    return run


def _reduced_card_vs_cpu(tag: str, p: dict) -> dict:
    """The reduced configs of ``p["archs"]`` (f32): prefill + decode steps
    on the card and on the CPU from the same weights, the card's greedy
    tokens fed to both (as phase 6)."""
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model, reduced_config

    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)               # as phase 2
    try:
        for arch in p["archs"]:
            cfg = reduced_config(ARCHS[arch])
            leaves = convert.params_to_numpy(build_model(
                cfg, device="cpu").init_params(
                    torch.Generator().manual_seed(p["seed"])))
            rng = np.random.default_rng(p["seed"])
            toks = rng.integers(0, cfg.vocab_size, (p["batch"], p["prompt"]))
            frames = rng.standard_normal(
                (p["batch"], cfg.frontend_tokens, cfg.d_model)).astype(
                    np.float32) if cfg.encoder_layers else None
            got, fed = _greedy_run(cfg, leaves, toks, "cuda", p["steps"],
                                   p["s_max"], frames=frames)
            want, _ = _greedy_run(cfg, leaves, toks, "cpu", p["steps"],
                                  p["s_max"], fed, frames=frames)
            worst = 0.0
            for i, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_allclose(g, w, atol=LM_TOL, rtol=LM_TOL,
                                           err_msg=f"{tag} {arch} step {i}")
                check(np.array_equal(g.argmax(-1), w.argmax(-1)),
                      f"{tag} {arch}: greedy tokens differ at step {i}")
                worst = max(worst, float(np.abs(g - w).max()))
            out[arch] = {"config": dataclasses.asdict(cfg),
                         "max_abs_diff": worst, "argmax_equal": True}
    finally:
        torch.set_num_threads(threads)
    return out


def _moe_ties_on_the_card() -> dict:
    """[30c] Ties among the top-k probabilities go to the lower expert
    index on the card, as ``jax.lax.top_k`` orders them: the crafted row
    gives [1, 2, 4], and 4,096 rows of coarse values (ties everywhere)
    give the CPU's order, which the CPU tests hold to the reference's."""
    import numpy as np
    import torch
    from repro_torch.models import moe

    row = torch.tensor([[.1, .3, .3, .2, .3, .05]], device="cuda")
    got = moe.top_k(row, 3)[1].tolist()
    check(got == [[1, 2, 4]], f"[30c] top_k of the tied row: {got}")
    probs = torch.from_numpy((np.random.default_rng(7).integers(
        0, 4, (4096, 64)) / 4).astype(np.float32))
    card = moe.top_k(probs.cuda(), 6)
    cpu = moe.top_k(probs, 6)
    check(torch.equal(card[1].cpu(), cpu[1])
          and torch.equal(card[0].cpu(), cpu[0]),
          "[30c] the card's top-k order differs from the CPU's on ties")
    return {"tied_row": got[0], "coarse_rows": probs.shape[0],
            "rows_with_ties_in_top6": int(
                (cpu[0][:, :-1] == cpu[0][:, 1:]).any(-1).sum())}


def _profiled_call(fn) -> dict:
    """One call of ``fn`` under the profiler, ending in a synchronise:
    wall ms, device ops, busy ms, idle share and device ms by range."""
    import torch
    from repro_torch.launch.profile_step import analyze_trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    stats = analyze_trace(events, 1)
    nccl = [e for e in events if e.get("cat") == "kernel"
            and "nccl" in e.get("name", "").lower()]
    by_kind: dict = {}
    for e in nccl:
        kind = next((k for k in ("AllGather", "ReduceScatter", "AllReduce")
                     if k in e["name"]), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e["dur"] / 1e3
    return {"wall_ms": wall,
            "device_idle_share": 1.0 - stats["device_busy_ms"] / wall,
            "device_ms_by_kind": _kernel_classes(events),
            "nccl_ms": sum(e["dur"] for e in nccl) / 1e3,
            "nccl_ms_by_kind": by_kind, **stats}


def _serve_profiled(model, params, reqs, spec: dict, frames=None) -> dict:
    """One prefill of the first request's prompt and one decode iteration
    of the slots filled with the first prompts, at the longest one's
    position, each profiled after a warm-up call. An encoder-decoder's
    prompts go in with their ``frames``, and its encoder pass over the
    first request's frames is profiled alone too."""
    import torch
    from repro_torch.launch import serve_lm

    def fe(i):
        return () if frames is None else (
            torch.from_numpy(frames[i]).cuda()[None],)

    slots = spec["slots"]
    prompt = torch.as_tensor(reqs[0].prompt, dtype=torch.int64,
                             device="cuda")[None]
    caches = model.init_decode_caches(slots, spec["s_max"], *(
        () if frames is None else (frames[0].shape[0],)))
    for slot, r in enumerate(reqs[:slots]):
        toks = torch.as_tensor(r.prompt, dtype=torch.int64,
                               device="cuda")[None]
        _, pre = model.prefill(params, toks, *fe(slot))
        serve_lm._write_prompt(caches, pre, slot, len(r.prompt))
    del pre
    cur = max(len(r.prompt) for r in reqs[:slots])
    tokens = torch.arange(slots, device="cuda") + 2
    out = {"prefill_tokens": prompt.shape[1], "decode_position": cur,
           "slots": slots}
    out["prefill"] = _profiled_call(
        lambda: model.prefill(params, prompt, *fe(0)))
    if frames is not None:
        out["frames"] = frames[0].shape[0]
        with torch.no_grad():
            out["encode"] = _profiled_call(
                lambda: model.encode(params, fe(0)[0]))
    model.decode_step(params, tokens, caches, cur)            # warm-up
    out["decode"] = _profiled_call(
        lambda: model.decode_step(params, tokens, caches, cur + 1))
    return out


def _print_profiled(tag: str, prof: dict) -> None:
    for kind in ("prefill", "decode", "encode"):
        if kind not in prof:
            continue
        d = prof[kind]
        what = {"prefill": f"{prof['prefill_tokens']} tokens"
                + (f" and {prof['frames']} frames" if "frames" in prof
                   else ""),
                "decode": f"{prof['slots']} slots at position "
                          f"{prof['decode_position'] + 1}",
                "encode": f"encoder alone, {prof.get('frames')} frames"}
        print(f"{tag} one profiled {kind} (" + what[kind]
              + f"): {d['wall_ms']:.2f} ms, {d['launches']:.0f} device ops, "
              f"busy {d['device_busy_ms']:.2f} ms, idle share "
              f"{d['device_idle_share']:.3f}; device ms by range "
              f"{ {k: round(v['device_ms'], 3) for k, v in d['ranges'].items()} }",
              flush=True)
        for op in d["top_device_ops"][:6]:
            print(f"    {op['device_ms']:9.3f} ms {op['calls']:6.0f} x "
                  f"{op['name'][:100]}", flush=True)


def phase_moe_serve(report: dict) -> dict:
    """[30] The MoE + MLA family on the card: (a) deepseek-v2-lite-16b at
    full width and depth served with phase 7's traffic, no kernel launched
    (MLA runs the plain ``_sdpa`` as in the reference); (b) the reduced
    deepseek-v2-lite and kimi-k2 card ≡ CPU; (c) top-k ties as
    ``jax.lax.top_k``; (d) one profiled prefill and decode iteration."""
    import torch
    from repro_torch.device import card_description
    torch.cuda.empty_cache()
    card = card_description()
    run = _moe_init_and_serve()
    rec = {"card": card, "serve": run["rec"]}
    _print_serve("[30a]", "MLA + 64 experts top-6 + 2 shared", rec["serve"],
                 card)
    prof = rec["profiled"] = _serve_profiled(run["model"], run["params"],
                                             run["reqs"], SERVE_MOE)
    _print_profiled("[30d]", prof)
    del run
    torch.cuda.empty_cache()
    par = rec["card_vs_cpu"] = _reduced_card_vs_cpu("[30b]", MOE_PARITY)
    worst = ", ".join(f"{k} {v['max_abs_diff']:.3g}" for k, v in par.items())
    print(f"[30b] reduced configs (f32): prefill of {MOE_PARITY['batch']} x "
          f"{MOE_PARITY['prompt']} tokens + {MOE_PARITY['steps']} decode "
          f"steps card ≡ CPU, max|Δlogit| {worst} (bound {LM_TOL}), greedy "
          f"tokens equal", flush=True)
    ties = rec["ties"] = _moe_ties_on_the_card()
    print(f"[30c] top-k ties on the card: the tied row gives "
          f"{ties['tied_row']} (jax.lax.top_k's order); "
          f"{ties['coarse_rows']} coarse rows ({ties['rows_with_ties_in_top6']}"
          f" with ties in their top 6) ≡ the CPU's order", flush=True)
    report["moe_serve"] = rec
    return rec


def _decode_vs_prefill_on_the_card(p: dict) -> dict:
    """[31c] On the card, each reduced config (f32): prefill of the prompt,
    then the next ``extend`` tokens by teacher-forced decode steps, gives
    the last logits of one prefill of prompt + extend."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model, reduced_config

    out = {}
    for arch in p["archs"]:
        cfg = reduced_config(ARCHS[arch])
        m = build_model(cfg, device="cuda")
        params = m.init_params(
            torch.Generator(device="cuda").manual_seed(p["seed"]))
        b, t0 = p["batch"], p["prompt"]
        s = t0 + p["extend"]
        toks = torch.from_numpy(np.random.default_rng(p["seed"]).integers(
            0, cfg.vocab_size, (b, s))).cuda()
        full, _ = m.prefill(params, toks)
        _, pre = m.prefill(params, toks[:, :t0])
        caches = m.init_decode_caches(b, s)
        serve_lm.write_caches(caches, pre, t0)
        for t in range(t0, s):
            lg, caches = m.decode_step(params, toks[:, t], caches, t)
        err = float((lg - full).abs().max())
        check(err <= DECODE_VS_PREFILL_TOL,
              f"[31c] {arch}: decode after prefill({t0}) differs from "
              f"prefill({s}) by {err}")
        out[arch] = {"prompt": t0, "extend": p["extend"],
                     "max_abs_diff": err}
    return out


def phase_ssm_serve(report: dict) -> dict:
    """[31] The SSM family and the jamba hybrid on the card: (a)
    mamba2-370m at full width and depth served with phase 7's traffic (no
    kernel: no attention); (b) jamba-v0.1-52b at full width, 16 of 32
    layers, with the same traffic: K2 launches once per attention layer
    per prefill, and K2 ≡ its plain version on the q, k, v the serve's
    first prefill gave its first attention layer; (c) the reduced configs
    card ≡ CPU, and on the card decode after prefill ≡ a longer prefill;
    (d) one profiled prefill and decode iteration of each model."""
    import torch
    from repro_torch.device import card_description
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    card = card_description()
    rec = {"card": card}

    cfg = _serve_config(SERVE_SSM)
    check(cfg.n_layers == 48 and cfg.d_model == 1024 and not cfg.n_heads
          and cfg.param_dtype == "bfloat16", f"[31a] {cfg}")
    run = _init_and_serve(SERVE_SSM, "[31a]")
    r = rec["mamba2"] = run["rec"]
    check(not any(r["launches"].values()),
          f"[31a] a kernel launched on the mamba2 serve: {r['launches']}")
    _print_serve("[31a]", "48 SSM layers, state 128, no attention", r, card)
    prof = rec["mamba2_profiled"] = _serve_profiled(
        run["model"], run["params"], run["reqs"], SERVE_SSM)
    _print_profiled("[31d] mamba2-370m:", prof)
    del run
    torch.cuda.empty_cache()

    cfg = _serve_config(SERVE_HYBRID)
    check(cfg.n_layers == 16 and cfg.d_model == 4096 and cfg.n_experts == 16
          and cfg.top_k == 2 and cfg.n_heads == 32 and cfg.n_kv_heads == 8
          and cfg.d_head == 128 and cfg.param_dtype == "bfloat16",
          f"[31b] {cfg}")
    n_attn = sum(ld.kind == "attn" for ld in cfg.layer_pattern()) * (
        cfg.n_layers // len(cfg.layer_pattern()))
    with _first_call(ops, "flash_attention") as seen:
        run = _init_and_serve(SERVE_HYBRID, "[31b]")
    r = rec["jamba"] = run["rec"]
    k2_n = r["launches"]["k2_flash_attention"]
    check(k2_n == n_attn * r["prefills"],
          f"[31b] K2 launched {k2_n} times in {r['prefills']} prefills of "
          f"{n_attn} attention layers")
    check(not any(v for k, v in r["launches"].items()
                  if k != "k2_flash_attention"),
          f"[31b] another kernel launched: {r['launches']}")
    _print_serve("[31b]", f"16 of 32 layers: 14 SSM + {n_attn} GQA, 8 MoE "
                 f"of 16 experts top-2", r, card)
    q, k, v = seen["args"]
    check(tuple(q.shape) == (1, 32, r["prompt_lens"][0], 128)
          and tuple(k.shape) == (1, 8, r["prompt_lens"][0], 128)
          and q.dtype == torch.bfloat16,
          f"[31b] K2's first inputs {tuple(q.shape)} {tuple(k.shape)}")
    rec["k2_check"] = _k2_case("[31b]", "jamba-first-prefill", q, k, v,
                               seen["kw"].get("causal", True))
    del q, k, v, seen
    prof = rec["jamba_profiled"] = _serve_profiled(
        run["model"], run["params"], run["reqs"], SERVE_HYBRID)
    _print_profiled("[31d] jamba-v0.1-52b:", prof)
    del run
    torch.cuda.empty_cache()

    par = rec["card_vs_cpu"] = _reduced_card_vs_cpu("[31c]", SSM_PARITY)
    worst = ", ".join(f"{k} {v['max_abs_diff']:.3g}" for k, v in par.items())
    print(f"[31c] reduced configs (f32): prefill of {SSM_PARITY['batch']} x "
          f"{SSM_PARITY['prompt']} tokens + {SSM_PARITY['steps']} decode "
          f"steps card ≡ CPU, max|Δlogit| {worst} (bound {LM_TOL}), greedy "
          f"tokens equal", flush=True)
    dvp = rec["decode_vs_prefill"] = _decode_vs_prefill_on_the_card(
        SSM_PARITY)
    worst = ", ".join(f"{k} {v['max_abs_diff']:.3g}" for k, v in dvp.items())
    print(f"[31c] on the card, prefill({SSM_PARITY['prompt']}) + "
          f"{SSM_PARITY['extend']} decode steps ≡ prefill("
          f"{SSM_PARITY['prompt'] + SSM_PARITY['extend']}): max|Δlogit| "
          f"{worst} (bound {DECODE_VS_PREFILL_TOL})", flush=True)
    report["ssm_serve"] = rec
    return rec

# phase 32: seamless-m4t-large-v2 (configs/seamless_m4t_large_v2.py,
# arXiv:2308.11596) at full width and depth, 24 encoder + 24 decoder
# layers: (a) phase 7's traffic with one block of frontend_tokens = 512
# frames a request; (c) the reduced config in f32 card ≡ CPU; (d) three
# steps of launch/train.run at 1 x 1,024 tokens, with its frames of
# seq_len on the encoder
SERVE_ENCDEC = dict(SERVE, arch="seamless-m4t-large-v2")
ENCDEC_PARITY = dict(archs=("seamless-m4t-large-v2",), batch=2, prompt=48,
                     steps=4, s_max=64, seed=8)
TRAIN_ENCDEC = dict(arch="seamless-m4t-large-v2", batch=1, seq_len=1024,
                    steps=3, lr=3e-4, warmup=1, seed=0)


def _k2_by_causal(causal: bool):
    """``_first_call``'s test for K2's first call with ``causal``."""
    return lambda *args, **kw: kw.get("causal", True) == causal


def _encdec_train_profiled(cfg) -> dict:
    """[32d] One more train step of seamless under the profiler, after a
    warm-up step, from a fresh draw (``train.run`` keeps its weights to
    itself): wall ms, device ops, busy ms, idle share, ms by range."""
    import torch
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, init_state, make_train_step

    t = TRAIN_ENCDEC
    model = build_model(cfg, attn_impl="sdpa", device="cuda")
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(t["seed"]))
    ocfg = AdamWConfig(lr=t["lr"], warmup_steps=t["warmup"],
                       total_steps=t["steps"],
                       moment_dtype=cfg.opt_moment_dtype)
    state = init_state(ocfg, params)
    step_fn = make_train_step(model, ocfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq_len"],
                      global_batch=t["batch"], seed=t["seed"],
                      frontend_tokens=t["seq_len"], d_model=cfg.d_model)
    params, state, _ = step_fn(params, state, batch_at(dcfg, 0,
                                                       device="cuda"))
    batch = batch_at(dcfg, 1, device="cuda")
    return _profiled_call(lambda: step_fn(params, state, batch))


def _encdec_train() -> dict:
    """[32d] ``launch/train.run`` on seamless at full width and depth: the
    loss of every step finite; ms per step by the host clock between the
    logged steps (each log reads the loss back, so it synchronises; the
    first step also builds, draws and compiles, and is kept apart); then
    one profiled step."""
    import re
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train

    cfg = ARCHS[TRAIN_ENCDEC["arch"]]
    check(cfg.remat == "full" and cfg.param_dtype == "bfloat16"
          and cfg.opt_moment_dtype == "float32", f"[32d] {cfg}")
    job = train.TrainJob(arch=cfg, steps=TRAIN_ENCDEC["steps"],
                         seq_len=TRAIN_ENCDEC["seq_len"],
                         global_batch=TRAIN_ENCDEC["batch"],
                         lr=TRAIN_ENCDEC["lr"], warmup=TRAIN_ENCDEC["warmup"],
                         log_every=1, seed=TRAIN_ENCDEC["seed"])
    stamps, lines = [], []

    def log(line):
        stamps.append(time.perf_counter())
        lines.append(line)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train.run(job, device="cuda", log=log)
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    check(len(losses) == TRAIN_ENCDEC["steps"]
          and all(math.isfinite(v) for v in losses),
          f"[32d] losses {losses}")
    gnorms = [float(re.search(r"gnorm=(\S+)", ln).group(1)) for ln in lines]
    check(all(math.isfinite(g) for g in gnorms), f"[32d] gnorms {gnorms}")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    tokens = TRAIN_ENCDEC["batch"] * TRAIN_ENCDEC["seq_len"]
    ms = statistics.median(step_ms)
    del out
    return {"config": TRAIN_ENCDEC, "n_layers": cfg.n_layers,
            "encoder_layers": cfg.encoder_layers,
            "tokens_per_step": tokens, "frames_per_step": tokens,
            "losses": losses, "grad_norms": gnorms,
            "first_step_s": stamps[0] - t0, "ms_per_step": step_ms,
            "ms_per_step_median": ms, "tokens_per_s": tokens / (ms / 1e3),
            "peak_memory_bytes": peak,
            "profiled": _encdec_train_profiled(cfg)}


def phase_encdec(report: dict) -> dict:
    """[32] The encoder-decoder on the card: (a) seamless-m4t-large-v2 at
    full width and depth served with phase 7's traffic and 512 frames a
    request, K2 once per encoder and decoder layer per prefill and nothing
    else; (b) K2 ≡ its plain version on the q, k, v the serve's first
    prefill gave encoder layer 0 and decoder layer 0; (c) the reduced
    config card ≡ CPU; (d) three training steps at full width."""
    import torch
    from repro_torch.device import card_description
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    card = card_description()
    rec = {"card": card}

    cfg = _serve_config(SERVE_ENCDEC)
    check(cfg.encoder_layers == 24 and cfg.n_layers == 24
          and cfg.d_model == 1024 and cfg.n_heads == cfg.n_kv_heads == 16
          and cfg.d_head == 64 and cfg.frontend_tokens == 512
          and cfg.param_dtype == "bfloat16", f"[32a] {cfg}")
    with _first_call(ops, "flash_attention",
                     when=_k2_by_causal(False)) as enc_seen, \
            _first_call(ops, "flash_attention",
                        when=_k2_by_causal(True)) as dec_seen:
        run = _init_and_serve(SERVE_ENCDEC, "[32a]")
    r = rec["serve"] = run["rec"]
    check(r["n_params"] == 2_034_886_656, f"[32a] {r['n_params']} params")
    per_prefill = cfg.encoder_layers + cfg.n_layers
    k2_n = r["launches"]["k2_flash_attention"]
    check(k2_n == per_prefill * r["prefills"] == 384,
          f"[32a] K2 launched {k2_n} times in {r['prefills']} prefills of "
          f"{per_prefill} self-attention layers")
    check(not any(v for k, v in r["launches"].items()
                  if k != "k2_flash_attention"),
          f"[32a] another kernel launched: {r['launches']}")
    check(r["frame_tokens"] == 512 * len(run["reqs"]),
          f"[32a] {r['frame_tokens']} frame tokens")
    _print_serve("[32a]", f"{cfg.encoder_layers} encoder + {cfg.n_layers} "
                 f"decoder layers, {r['frame_tokens']} frames", r, card)
    first = r["prompt_lens"][0]
    checks = {}
    for part, seen, shape, causal in (
            ("encoder", enc_seen, (1, 16, 512, 64), False),
            ("decoder", dec_seen, (1, 16, first, 64), True)):
        q, k, v = seen["args"]
        check(tuple(q.shape) == shape and tuple(k.shape) == shape
              and q.dtype == torch.bfloat16
              and seen["kw"].get("causal", True) == causal,
              f"[32b] K2's first {part} inputs {tuple(q.shape)} "
              f"{tuple(k.shape)} {q.dtype}")
        checks[part] = _k2_case("[32b]", f"seamless-{part}-first-prefill",
                                q, k, v, causal)
        del q, k, v
    rec["k2_checks"] = checks
    del enc_seen, dec_seen
    prof = rec["profiled"] = _serve_profiled(
        run["model"], run["params"], run["reqs"], SERVE_ENCDEC,
        run["frames"])
    _print_profiled("[32a]", prof)
    del run
    torch.cuda.empty_cache()

    par = rec["card_vs_cpu"] = _reduced_card_vs_cpu("[32c]", ENCDEC_PARITY)
    worst = ", ".join(f"{k} {v['max_abs_diff']:.3g}" for k, v in par.items())
    print(f"[32c] reduced config (f32): prefill of {ENCDEC_PARITY['batch']} "
          f"x {ENCDEC_PARITY['prompt']} tokens with 8 frames + "
          f"{ENCDEC_PARITY['steps']} decode steps card ≡ CPU, max|Δlogit| "
          f"{worst} (bound {LM_TOL}), greedy tokens equal", flush=True)

    _reset_counts()
    t = rec["train"] = _encdec_train()
    t["launches"] = _read_counts()
    print(f"[32d] train {cfg.name} ({cfg.encoder_layers} + {cfg.n_layers} "
          f"layers, bf16, remat full, AdamW f32 moments) through "
          f"launch/train.run: {TRAIN_ENCDEC['steps']} steps of "
          f"{TRAIN_ENCDEC['batch']} x {TRAIN_ENCDEC['seq_len']} tokens with "
          f"{TRAIN_ENCDEC['seq_len']} frames; losses {t['losses']}, grad "
          f"norms {t['grad_norms']}; first step (build, draw, first calls) "
          f"{t['first_step_s']:.2f} s, then {t['ms_per_step']} ms/step "
          f"(host clock), {t['tokens_per_s']:.0f} tokens/s; peak memory "
          f"{t['peak_memory_bytes'] / 1e9:.2f} GB; kernel launches "
          f"{t['launches']}; {card}", flush=True)
    d = t["profiled"]
    print(f"[32d] one profiled train step: {d['wall_ms']:.2f} ms, "
          f"{d['launches']:.0f} device ops, busy {d['device_busy_ms']:.2f} "
          f"ms, idle share {d['device_idle_share']:.3f}; device ms by range "
          f"{ {k: round(v['device_ms'], 3) for k, v in d['ranges'].items()} }",
          flush=True)
    for op in d["top_device_ops"][:8]:
        print(f"    {op['device_ms']:9.3f} ms {op['calls']:6.0f} x "
              f"{op['name'][:100]}", flush=True)
    report["encdec"] = rec
    return rec


# ---------------------------------------------------------------------------
# phase 33: training the MoE, MLA, SSM and hybrid configs
# ---------------------------------------------------------------------------

# (a) mamba2-370m at full width and depth (configs/mamba2_370m.py,
# arXiv:2405.21060: 48 SSM layers, state 128, chunk 128), bf16 params, f32
# moments, remat full, 2 × 4,096 tokens a step as phase 29 cuts TRAIN_4K to
# one card; steps 2-5 timed, then one more profiled
TRAIN_SSM = dict(arch="mamba2-370m", batch=2, seq_len=4096, steps=5,
                 lr=3e-4, warmup=2, seed=0, n_layers=None)
# (b) deepseek-v2-lite-16b at full width (configs/deepseek_v2_lite_16b.py,
# arXiv:2405.04434: MLA at rank 512, 64 experts top-6 + 2 shared, d_ff
# 1,408 an expert, capacity factor 1.25) in the reference's 2 microbatches
# at train_4k (launch/cells.MICROBATCHES); depth cut from 27 to 4 layers
# (the dense first layer + 3 MoE layers), the deepest whose step stays
# under ~72 GB of the card's 80: 4 layers peak at 56.56 GB, 5 (2.84 B
# params) at 73.00 GB (PERF.md §4)
TRAIN_MOE = dict(arch="deepseek-v2-lite-16b", batch=2, seq_len=4096,
                 steps=5, lr=3e-4, warmup=2, seed=0, n_layers=4)
# (c) the reduced configs in f32 with remat full, 3 steps card ≡ CPU
# (phase 29 (b)'s bounds), each with its microbatches: deepseek its 2;
# kimi-k2 keeps its bf16 moments. The card runs them twice under
# deterministic algorithms
FAMILY_PARITY = dict(archs=(("deepseek-v2-lite-16b", 2),
                            ("kimi-k2-1t-a32b", 1), ("mamba2-370m", 1),
                            ("jamba-v0.1-52b", 1)),
                     steps=3, seq_len=64, batch=4, rtol=1e-4,
                     param_atol=1e-6, seed=11)


def _family_parity_runs(dev: str) -> dict:
    """[33c] The reduced configs of FAMILY_PARITY (f32, remat full), 3
    steps on ``dev`` from weights and batches drawn on the CPU; returns
    each config's metrics and its params after step 1."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import build_model, reduced_config
    from repro_torch.train import AdamWConfig

    p = FAMILY_PARITY
    out = {}
    for arch, n_micro in p["archs"]:
        cfg = dataclasses.replace(reduced_config(ARCHS[arch]), remat="full")
        ocfg = AdamWConfig(lr=TRAIN_MOE["lr"],
                           warmup_steps=TRAIN_MOE["warmup"],
                           total_steps=TRAIN_MOE["steps"],
                           moment_dtype=cfg.opt_moment_dtype)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=p["seq_len"],
                          global_batch=p["batch"], seed=p["seed"])
        batches = [batch_at(dcfg, i, device="cpu")
                   for i in range(p["steps"])]
        leaves = convert.params_to_numpy(build_model(
            cfg, device="cpu").init_params(
                torch.Generator().manual_seed(p["seed"])))
        rows, after = _train_steps(cfg, leaves, batches, ocfg, dev, n_micro)
        out[arch] = {"config": cfg, "ocfg": ocfg, "microbatches": n_micro,
                     "rows": rows, "params_1": after[0],
                     "params_last": after[-1]}
    return out


def _family_card_vs_cpu(cpu: dict | None) -> dict:
    """[33c] The card's runs of the reduced configs, twice under
    ``torch.use_deterministic_algorithms`` (the two bit for bit equal), ≡
    the CPU's (from the CPU worker, or run here when there is none)."""
    import numpy as np
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)               # as phase 2
    try:
        if cpu is None:
            cpu = _family_parity_runs("cpu")
        torch.use_deterministic_algorithms(True)
        try:
            runs = [_family_parity_runs("cuda") for _ in range(2)]
        finally:
            torch.use_deterministic_algorithms(False)
    finally:
        torch.set_num_threads(threads)
    out = {}
    for arch, want in cpu.items():
        got, again = runs[0][arch], runs[1][arch]
        last = _flat_np(again["params_last"])
        check(got["rows"] == again["rows"] and all(
            np.array_equal(a, last[k])
            for k, a in _flat_np(got["params_last"]).items()),
              f"[33c] {arch}: two deterministic card runs differ")
        out[arch] = {"config": dataclasses.asdict(got["config"]),
                     "microbatches": got["microbatches"],
                     "moment_dtype": got["ocfg"].moment_dtype,
                     **_train_runs_agree(f"[33c] {arch}", got["rows"],
                                         want["rows"], got["params_1"],
                                         want["params_1"], got["ocfg"],
                                         FAMILY_PARITY)}
    return out


def phase_family_training(report: dict, cpu: dict | None = None) -> dict:
    """[33] Training the MoE, MLA, SSM and hybrid configs on the card: (a)
    mamba2-370m at full width and depth; (b) deepseek-v2-lite-16b at full
    width, 4 of its 27 layers, in 2 microbatches; (c) four reduced configs
    card ≡ CPU; (d) K2 launches nowhere in the phase (counts reset before
    (a), read after (c)). ``cpu``: the CPU worker's results, which hold
    (c)'s CPU half."""
    import os
    import torch
    from repro_torch.device import card_description
    # deterministic cuBLAS for (c); H100's default workspace size anyway,
    # and read at the process's first GEMM (main sets it before phase 0)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.cuda.empty_cache()
    card = card_description()
    _reset_counts()
    rec = {"card": card}
    for tag, spec in (("[33a]", TRAIN_SSM), ("[33b]", TRAIN_MOE)):
        r = rec[spec["arch"]] = _train_full_width(spec, tag)
        _print_train_full(tag, r, card)
    par = rec["card_vs_cpu"] = _family_card_vs_cpu(
        None if cpu is None else cpu["train_families"])
    for arch, r in par.items():
        rel = {k: float(f"{v:.3g}") for k, v in r["max_rel_diff"].items()}
        print(f"[33c] reduced {arch} (f32, remat full, "
              f"{r['microbatches']} microbatch(es), {r['moment_dtype']} "
              f"moments), {FAMILY_PARITY['steps']} steps card ≡ CPU: loss, "
              f"grad_norm, lr within rel {rel}"
              f" (bound {FAMILY_PARITY['rtol']}); params after step 1 "
              f"max|Δ| {r['params_after_step1_max_abs_diff']:.3g}, "
              f"{r['params_beyond_atol']} of {r['params']} beyond "
              f"{FAMILY_PARITY['param_atol']}; two card runs under "
              f"deterministic algorithms bit for bit equal", flush=True)
    launches = rec["launches"] = _read_counts()
    check(not any(launches.values()),
          f"[33d] a kernel launched in training: {launches}")
    print(f"[33d] kernel launches over the phase: {launches}", flush=True)
    report["family_training"] = rec
    return rec


# ---------------------------------------------------------------------------
# phase 34: the dry run held against the card
# ---------------------------------------------------------------------------

# the training cells of phases 29 (a) and 33 (a-b): (arch, n_layers, the
# phase whose ms/step the bound is held against); TRAIN_4K's global batch
# cut to 2 sequences, as those phases cut it
DRYRUN_CELLS = (("qwen2-1.5b", None, "29"), ("mamba2-370m", None, "33"),
                ("deepseek-v2-lite-16b", 4, "33"))
DRYRUN_BATCH, DRYRUN_SEED = 2, 0
# a bound longer than the measured step means the trace over-counts
DRYRUN_MAX_FRACTION = 1.05


def _timed_steps(fn, args, steps: int = 3) -> float:
    """Median ms of ``steps`` calls of ``fn(*args)`` after one warm-up
    (CUDA events), for a cell whose phase did not run."""
    import torch
    fn(*args)
    times = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(*args)
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _dryrun_vs_card(arch: str, n_layers, ms_measured) -> dict:
    """[34a-c] for one cell; ``ms_measured``: its ms/step from phase 29 or
    33, or None to time it here."""
    import torch
    from repro_torch.configs import ARCHS, TRAIN_4K
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_host_mesh, mesh_axes
    from repro_torch.roofline import analysis as A
    from repro_torch.train import AdamWConfig, init_state

    cfg = ARCHS[arch]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = dataclasses.replace(TRAIN_4K, global_batch=DRYRUN_BATCH)
    cell = cells.build_cell(cfg, shape, make_host_mesh(), mesh_axes(False))
    t0 = time.perf_counter()
    pred = A.trace_step(cell.fn, *cell.args, device="cuda")
    trace_s = time.perf_counter() - t0
    analytic = cells.analytic_step_flops(cfg, shape)
    rl = A.analyze({"flops": analytic, "bytes accessed": pred.bytes_moved})
    bound = rl.step_time_bound_s

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    params = cell.model.ps.init_params(
        torch.Generator(device="cuda").manual_seed(DRYRUN_SEED))
    state = init_state(AdamWConfig(moment_dtype=cfg.opt_moment_dtype), params)
    data = batch_at(DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=shape.seq_len,
                               global_batch=shape.global_batch,
                               seed=DRYRUN_SEED), 0, device="cuda")
    # the cell's tokens and labels are two inputs; batch_at shares one
    batch = {"tokens": data["tokens"], "labels": data["labels"].clone()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    real = A.trace_step(cell.fn, params, state, batch, fake=False)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(real.flops == pred.flops,
          f"[34b] {arch}: the card's step counted {real.flops} FLOPs, the "
          f"trace {pred.flops}")
    timed_here = ms_measured is None
    if timed_here:
        ms_measured = _timed_steps(cell.fn, (params, state, batch))
    fraction = bound / (ms_measured / 1e3)
    del params, state, batch, data
    torch.cuda.empty_cache()
    return {"arch": arch, "n_layers": cfg.n_layers,
            "microbatches": cells.microbatches(arch, shape.name),
            "tokens_per_step": shape.global_batch * shape.seq_len,
            "trace_s": trace_s, "traced": dataclasses.asdict(pred),
            "analytic_flops": analytic, "roofline": rl.as_dict(),
            "bound_s": bound, "real_step_s": real_s,
            "card_step": dataclasses.asdict(real),
            "baseline_bytes": baseline, "max_memory_allocated": peak,
            "peak_ratio": pred.peak_bytes / peak,
            "peak_ratio_above_baseline": pred.peak_bytes / (peak - baseline),
            "ms_per_step": ms_measured, "ms_timed_here": timed_here,
            "roofline_fraction": fraction}


def _print_dryrun_vs_card(r: dict, phase: str, card: str) -> None:
    rl, t = r["roofline"], r["traced"]
    gb = 1e9
    print(f"[34a] {r['arch']} ({r['n_layers']} layers, {r['microbatches']} "
          f"microbatch(es), {r['tokens_per_step']:,} tokens a step) traced "
          f"under fake tensors in {r['trace_s']:.1f} s: {t['flops']:.6g} "
          f"FLOPs (FlopCounterMode; analytic {r['analytic_flops']:.6g}), "
          f"{t['bytes_moved']:.6g} bytes moved in {t['n_ops']:,} ops, "
          f"arguments {t['argument_bytes'] / gb:.2f} GB, predicted peak "
          f"{t['peak_bytes'] / gb:.2f} GB; terms: compute "
          f"{rl['compute_s']:.4f} s, memory {rl['memory_s']:.4f} s, "
          f"collective -; bound {r['bound_s']:.4f} s ({rl['dominant']})",
          flush=True)
    c = r["card_step"]
    print(f"[34b] {r['arch']} one step on the card under the same tracer "
          f"({r['real_step_s']:.1f} s): {c['flops']:.6g} FLOPs (= the "
          f"trace's), {c['bytes_moved']:.6g} bytes moved, the tracer's peak "
          f"{c['peak_bytes'] / gb:.2f} GB; max_memory_allocated "
          f"{r['max_memory_allocated'] / gb:.2f} GB (of which "
          f"{r['baseline_bytes'] / gb:.3f} GB allocated before the step's "
          f"inputs) against the predicted {t['peak_bytes'] / gb:.2f} GB: "
          f"ratio {r['peak_ratio']:.4f} ({r['peak_ratio_above_baseline']:.4f}"
          f" above the baseline)", flush=True)
    where = ("timed here, 3 steps after a warm-up" if r["ms_timed_here"]
             else f"phase {phase} of this run")
    print(f"[34c] {r['arch']} roofline fraction {r['roofline_fraction']:.4f}"
          f" = bound {r['bound_s'] * 1e3:.1f} ms / measured "
          f"{r['ms_per_step']:.1f} ms/step ({where}); {card}", flush=True)


def phase_dryrun_vs_card(report: dict, ms_measured: dict) -> dict:
    """[34] The dry run held against the card on the training cells of
    phases 29 and 33; ``ms_measured``: arch → ms/step those phases
    measured in this run (an arch missing is timed here)."""
    import torch
    from repro_torch.device import card_description
    from repro_torch.roofline import analysis as A
    check(A.PEAK_FLOPS == PEAK_BF16_TENSOR_FLOPS
          and A.HBM_BW == PEAK_HBM_BYTES,
          "[34] roofline/analysis.py's peaks differ from this script's")
    card = card_description()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[34] the card's total_memory {total:,} bytes "
          f"(torch.cuda.get_device_properties(0)); roofline/analysis."
          f"HBM_BYTES {A.HBM_BYTES:,}; peaks {A.PEAK_FLOPS:.4g} FLOP/s "
          f"(bf16), {A.HBM_BW:.4g} B/s; {card}", flush=True)
    _reset_counts()
    rec = {"card": card, "total_memory": total, "cells": {}}
    for arch, n_layers, phase in DRYRUN_CELLS:
        r = rec["cells"][arch] = _dryrun_vs_card(arch, n_layers,
                                                 ms_measured.get(arch))
        _print_dryrun_vs_card(r, phase, card)
        check(r["roofline_fraction"] <= DRYRUN_MAX_FRACTION,
              f"[34c] {arch}: the bound is {r['roofline_fraction']:.4f} of "
              f"the measured step (at most {DRYRUN_MAX_FRACTION}): the "
              f"trace over-counts")
    launches = rec["launches"] = _read_counts()
    check(not any(launches.values()),
          f"[34d] a kernel launched in the dry-run check: {launches}")
    print(f"[34d] kernel launches over the phase: {launches}", flush=True)
    report["dryrun_check"] = rec
    return rec


# ---------------------------------------------------------------------------
# phase 35: the distributed engine over a torch.distributed group, one
# block of shards a rank (launch/distributed.py)
# ---------------------------------------------------------------------------

# (a) phase 28 (a)'s K1 case (benchmarks/distributed.py's weak-scaling
# set-up at 4 shards, 524,288 agents) on one NCCL rank holding all 4
RANKS_WEAK = dict(scenario="weak", agents_per_shard=DIST_PER_SHARD,
                  n_shards=DIST_SHARDS, force_impl="k1", steps=DIST_STEPS)
# (b) on N cards: (a)'s case, SIR with migration and a rebalance (K1),
# sharded diffusion with secretion, every_k from a skin-0 pair list (K1),
# each against the one-card lanes run of card 0; then weak scaling at the
# reference benchmark's 131,072 agents a shard, 8 shards (1,048,576 agents)
# a card, on 1, 2 and N cards
RANKS_PARITY = (dict(RANKS_WEAK, name="weak_k1"),
                dict(scenario="sir", force_impl="k1", steps=DIST_SIR_STEPS,
                     name="sir_k1"),
                dict(scenario="diffusion", steps=DIST_DIFF_STEPS,
                     name="diffusion"),
                dict(scenario="every_k", skin=0.0, steps=DIST_PL_STEPS,
                     name="every_k_skin0"))
SCALE_SHARDS_PER_CARD, SCALE_STEPS, SCALE_PROFILED = 8, 10, 3
RANKS_EXAMPLE_ENV = {"EXAMPLE_N": "6000", "EXAMPLE_EPOCHS": "5"}


def _ranks_run(jobs: list, ranks: int, out: Path) -> tuple[dict, float]:
    """``jobs`` on ``ranks`` spawned ranks through the launcher, one card
    each over NCCL: {name: (arrays, meta)} and the launch's seconds."""
    import numpy as np
    from repro_torch.launch import distributed as launcher
    t0 = time.perf_counter()
    launcher.launch(jobs, ranks, str(out), device="cuda")
    seconds = time.perf_counter() - t0
    got = {}
    for job in jobs:
        name = job["name"]
        got[name] = (dict(np.load(out / f"{name}.npz")),
                     json.loads((out / f"{name}.json").read_text()))
    return got, seconds


def _same_run(got: dict, want: dict, what: str) -> None:
    """Every array of two runs of one job equal byte for byte: the whole
    final state, every step's stats of every shard, every boundary."""
    check(sorted(got) == sorted(want), f"{what}: arrays {sorted(got)}")
    for k, w in want.items():
        g = got[k]
        check(g.dtype == w.dtype and g.shape == w.shape
              and g.tobytes() == w.tobytes(),
              f"{what}: {k} differs from the one-card lanes run "
              f"({g.dtype}{g.shape} vs {w.dtype}{w.shape})")


def _lanes_run(job: dict) -> dict:
    """The job as lanes of card 0 in this process (``ShardAxis``)."""
    import gc
    import torch
    from repro_torch.launch import distributed as launcher
    res = launcher.run_job(job, None, "cuda")
    del res["state"]                  # the card's memory back for the next
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_ranks_one_card(report: dict, tmpdir: str) -> dict:
    """[35a] an NCCL group of one rank, through the launcher, holding all
    4 shards of phase 28 (a)'s K1 case ≡ the lanes run of this process,
    bit for bit, every step's stats included; K1 and its map launch once
    a step in the rank."""
    import gc
    import torch
    from repro_torch.device import card_description
    gc.collect()
    torch.cuda.empty_cache()          # room for the rank's own context
    job = dict(RANKS_WEAK, name="weak_k1")
    got, spawn_s = _ranks_run([job], 1, Path(tmpdir) / "ranks1")
    arrays, meta = got["weak_k1"]
    lanes = _lanes_run(job)
    _same_run(arrays, lanes["arrays"], "[35a]")
    rank = meta["ranks"][0]
    for k in ("k1_collision_force", "k1_column_map"):
        check(rank["launches"][k] == DIST_STEPS,
              f"[35a] {k} launched {rank['launches'][k]} times in the rank's "
              f"{DIST_STEPS} steps, not once a step")
    flags = arrays["stats"][:, [list(arrays["fields"]).index(f) for f in (
        "halo_overflow", "migrate_overflow", "in_flight", "thin_slab",
        "birth_overflow", "box_overflow")]]
    check(not flags.any(), "[35a] an overflow flag is set")
    weak28 = report.get("distributed", {}).get("weak", {}).get("k1", {})
    rec = {"card": card_description(), "agents": DIST_PER_SHARD * DIST_SHARDS,
           "shards": DIST_SHARDS, "steps": DIST_STEPS,
           "rank_ms_steps": rank["ms"],
           "rank_ms_median": statistics.median(rank["ms"]),
           "lanes_ms_steps": lanes["own"]["ms"],
           "lanes_ms_median": statistics.median(lanes["own"]["ms"]),
           "phase28a_lanes_ms_median": weak28.get("dist_ms_median"),
           "launches": rank["launches"], "peak_bytes": rank["peak_bytes"],
           "launch_s": spawn_s,
           "per_shard_live": arrays["stats"][-1][
               list(arrays["fields"]).index("n_live")].tolist()}
    print(f"[35a] one NCCL rank holding {DIST_SHARDS} shards of "
          f"{rec['agents']} agents (K1), {DIST_STEPS} steps: ≡ the lanes run "
          f"of this process byte for byte (final state, every step's stats "
          f"and boundaries); {rec['rank_ms_median']:.3f} ms/step (median, "
          f"host clock) against {rec['lanes_ms_median']:.3f} for the lanes "
          f"here and {_ms(rec['phase28a_lanes_ms_median'])} in phase 28 "
          f"(a); K1 "
          f"{rank['launches']['k1_collision_force']}, map "
          f"{rank['launches']['k1_column_map']} launches in the rank; peak "
          f"{rank['peak_bytes'] / 1e9:.2f} GB; launch {spawn_s:.1f} s; "
          f"{rec['card']}", flush=True)
    report["ranks_one_card"] = rec
    return rec


def _ms(v) -> str:
    """A time to three places, or "not run" where its phase did not."""
    return "not run" if v is None else f"{v:.3f} ms"


def _scale_job(cards: int) -> dict:
    return dict(scenario="weak", agents_per_shard=DIST_PER_SHARD,
                n_shards=SCALE_SHARDS_PER_CARD * cards, force_impl="k1",
                steps=SCALE_STEPS, profile=SCALE_PROFILED,
                name=f"scale_{cards}")


def _scale_record(cards: int, arrays: dict, meta: dict) -> dict:
    fields = list(arrays["fields"])
    flags = arrays["stats"][:, [fields.index(f) for f in (
        "halo_overflow", "migrate_overflow", "in_flight", "thin_slab",
        "birth_overflow", "box_overflow")]]
    check(not flags.any(), f"[35b] weak scaling on {cards} cards: an "
                           f"overflow flag is set")
    ranks = meta["ranks"]
    return {"cards": cards,
            "agents": DIST_PER_SHARD * SCALE_SHARDS_PER_CARD * cards,
            "shards": SCALE_SHARDS_PER_CARD * cards,
            "ms_median_by_card": [statistics.median(r["ms"]) for r in ranks],
            "peak_gb_by_card": [r["peak_bytes"] / 1e9 for r in ranks],
            # the profiled steps' own readings: the profiler slows each
            # host, and a rank waiting for a slower one spins in NCCL
            # kernels, so only the least NCCL time over the cards (the
            # rank the others wait for) stands for the transfers
            "profiled_idle_share_by_card": [
                r["profile"]["device_idle_share"] for r in ranks],
            "profiled_busy_ms_by_card": [r["profile"]["device_busy_ms"]
                                         for r in ranks],
            "profiled_nccl_ms_by_card": [r["profile"]["nccl_ms_per_step"]
                                         for r in ranks],
            "nccl_ms_min": min(r["profile"]["nccl_ms_per_step"]
                               for r in ranks),
            "k1_launches_by_card": [r["launches"]["k1_collision_force"]
                                    for r in ranks]}


def phase_ranks_cards(n_cards: int, tmpdir: str) -> dict:
    """[35b] the distributed engine on ``n_cards`` ranks, one card each:
    the parity jobs ≡ the one-card lanes runs of card 0, weak scaling on
    1, 2 and n_cards cards, the epidemiology example with --ranks."""
    import os
    import subprocess as sp
    from repro_torch.device import card_description
    check(DIST_SHARDS % n_cards == 0,
          f"[35b] {DIST_SHARDS} shards do not split over {n_cards} cards")
    cards = sp.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], capture_output=True,
                   text=True, timeout=60, check=True).stdout.split("\n")
    rec = {"cards": [c for c in cards if c.strip()], "parity": {},
           "scaling": []}
    jobs = list(RANKS_PARITY) + [_scale_job(n_cards)]
    got, spawn_s = _ranks_run(jobs, n_cards, Path(tmpdir) / "ranksN")
    rec["launch_s"] = spawn_s
    for job in RANKS_PARITY:
        arrays, meta = got[job["name"]]
        lanes = _lanes_run(job)
        _same_run(arrays, lanes["arrays"], f"[35b] {job['name']}")
        ranks = meta["ranks"]
        r = rec["parity"][job["name"]] = {
            "steps": job["steps"],
            "rank_ms_median": [statistics.median(x["ms"]) for x in ranks],
            "lanes_ms_median": statistics.median(lanes["own"]["ms"]),
            "launches_by_card": [x["launches"] for x in ranks]}
        print(f"[35b] {job['name']} on {n_cards} cards ({DIST_SHARDS // n_cards}"
              f" shard(s) a card), {job['steps']} steps: ≡ the one-card lanes "
              f"run byte for byte, every step's stats included; ms/step by "
              f"card {[round(x, 3) for x in r['rank_ms_median']]} against "
              f"{r['lanes_ms_median']:.3f} on one card", flush=True)
    scale = {n_cards: got[f"scale_{n_cards}"]}
    for w in (1, 2):
        if w < n_cards:
            g, _ = _ranks_run([_scale_job(w)], w, Path(tmpdir) / f"scale{w}")
            scale[w] = g[f"scale_{w}"]
    for w in sorted(scale):
        s = _scale_record(w, *scale[w])
        rec["scaling"].append(s)
        print(f"[35b] weak scaling, {w} card(s), {s['shards']} shards of "
              f"{DIST_PER_SHARD} ({s['agents']} agents): ms/step by card "
              f"{[round(x, 3) for x in s['ms_median_by_card']]}, peak GB "
              f"{[round(x, 2) for x in s['peak_gb_by_card']]}; in "
              f"{SCALE_PROFILED} profiled steps (the profiler's own, not the "
              f"timed steps'): NCCL kernels {s['nccl_ms_min']:.4f} ms/step on "
              f"the card the others wait for (by card "
              f"{[round(x, 4) for x in s['profiled_nccl_ms_by_card']]}, the "
              f"rest spin-waiting), idle share by card "
              f"{[round(x, 3) for x in s['profiled_idle_share_by_card']]}; "
              f"{card_description()}", flush=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **RANKS_EXAMPLE_ENV)
    t0 = time.perf_counter()
    proc = sp.run([sys.executable, "-m", "repro_torch.examples.epidemiology",
                   "--distributed", "--ranks", str(n_cards)], env=env,
                  capture_output=True, text=True, timeout=600)
    ok = [ln for ln in proc.stdout.splitlines() if ln.startswith("OK:")]
    check(proc.returncode == 0 and bool(ok),
          f"[35b] epidemiology --distributed --ranks {n_cards}: "
          f"rc {proc.returncode}\n{proc.stderr[-3000:]}")
    rec["example"] = {"seconds": time.perf_counter() - t0, "ok": ok,
                      "output": proc.stdout}
    print(f"[35b] epidemiology --distributed --ranks {n_cards} "
          f"({RANKS_EXAMPLE_ENV}): {ok[-1]} in "
          f"{rec['example']['seconds']:.1f} s; {card_description()}",
          flush=True)
    return rec


# ---------------------------------------------------------------------------
# 36. the LM's sharded runtime: FSDP over a DeviceMesh (launch/mesh.py,
# models/sharding.py, launch/train.run(job, mesh, axes))
# ---------------------------------------------------------------------------

# one NCCL rank on a (1, 1) mesh: phase 29's qwen2-1.5b at full width and
# depth, 2 × 4,096 tokens, 3 steps, sharded and unsharded in the rank
FSDP_ONE = dict(TRAIN, steps=3)
# (a) the same model, a global batch of 4 × 4,096, 3 steps on W = 1 (in 2
# microbatches), 2 and 4 ranks: loss and grad_norm within rtol 2e-3 (bf16
# GEMMs tile a 1-row and a 4-row batch apart), params within 3·lr +
# 2^-8·|param| (AdamW's sign steps and one bf16 rounding)
FSDP_PARITY = dict(TRAIN, batch=4, steps=3)
FSDP_RTOL = 2e-3
# (b) qwen3-14b at full width and depth (40 layers, 14.77 B params),
# TRAIN_4K's 256 sequences of 4,096 cut to one a card, 5 steps at lr 3e-4
# on AdamWConfig's default warm-up of 100 steps (with phase 29's warm-up of
# 2 the random-init model's loss rises over the first steps: PERF.md §4)
FSDP_CELL = dict(arch="qwen3-14b", batch=4, seq_len=4096, steps=5,
                 lr=3e-4, warmup=100, seed=0)
# (c) qwen2-1.5b at full width, 2 of its 28 layers: a checkpoint at step 2
# on 4 ranks resumed on 4 (bit for bit) and on 2 ranks (the tolerances)
FSDP_ELASTIC = dict(arch="qwen2-1.5b", n_layers=2, batch=4, seq_len=4096,
                    steps=3, lr=3e-4, warmup=2, seed=0)


def _fsdp_cfg(spec: dict):
    """``spec``'s config: its depth cut to ``n_layers`` where set; with
    ``reduced``, ``reduced_config``'s (remat full) with the fields of
    ``over``; its params and activations in ``dtype`` where set."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import reduced_config
    cfg = ARCHS[spec["arch"]]
    if spec.get("reduced"):
        cfg = dataclasses.replace(reduced_config(cfg), remat="full",
                                  **spec.get("over", {}))
    if spec.get("n_layers") is not None:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    if spec.get("dtype"):
        cfg = dataclasses.replace(cfg, param_dtype=spec["dtype"],
                                  activation_dtype=spec["dtype"])
    return cfg


def _param_hashes(params) -> dict:
    """sha256 of every leaf's bytes (this rank's block)."""
    import hashlib
    import torch
    from repro_torch.models import sharding
    from repro_torch.train.optimizer import _leaves
    return [hashlib.sha256(sharding.local(p).contiguous().view(
        torch.uint8).cpu().numpy()).hexdigest() for p in _leaves(params)]


def _fsdp_steps(spec: dict, mesh, dev, micro: int = 1, extra=(),
                hold: dict | None = None, grad_norms: bool = False,
                routing: bool = False, first_params: bool = False
                ) -> tuple:
    """``spec``'s steps through ``make_train_step`` (in place on a mesh),
    each timed by CUDA events and the host clock after a synchronise;
    ``extra`` adds one more step each: ``"count"`` under
    ``roofline/analysis.collectives_of``, ``"profile"`` profiled. Returns
    (record, params, the hashes of the params after the timed steps);
    the record's ``lrs`` are the learning rates of every update made,
    extra steps included. ``hold`` gets the optimizer state after them
    (``"state"``) and, with ``first_params``, the params after step 1
    made whole on rank 0 (``"first"``, {name: f32 tensor}); ``grad_norms``
    records, before the steps, each leaf's gradient norm on the first
    step's batch (``leaf_grad_norms``, rank 0's, :func:`_leaf_grad_norms`).
    A config with experts records each step's mean aux loss, and with
    ``routing`` the first step's routing (:func:`_routing_of`). On a mesh
    the batch is the rank's block of each of the ``micro`` global
    microbatches (``rank_batch_at``)."""
    import torch
    from repro_torch.data import DataConfig, batch_at, rank_batch_at
    from repro_torch.models import build_model, sharding
    from repro_torch.models import moe as moe_mod
    from repro_torch.roofline import analysis
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.optimizer import schedule
    cfg = _fsdp_cfg(spec)
    torch.cuda.empty_cache()
    model = build_model(cfg, attn_impl="sdpa", device=dev)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(spec["seed"]), mesh)
    ocfg = AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup"],
                       total_steps=spec["steps"],
                       moment_dtype=cfg.opt_moment_dtype)
    state = init_state(ocfg, params)
    step_fn = make_train_step(model, ocfg, n_microbatches=micro)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq_len"],
                      global_batch=spec["batch"], seed=spec["seed"],
                      frontend_tokens=(spec["seq_len"] if cfg.encoder_layers
                                       else cfg.frontend_tokens),
                      d_model=cfg.d_model)
    _, rank, world = sharding.world_of(params)

    def batch(i):
        if mesh is None:
            return batch_at(dcfg, i, device=dev)
        return rank_batch_at(dcfg, i, rank, world, device=dev,
                             n_microbatches=step_fn.n_microbatches)

    norms = (_leaf_grad_norms(model, params, batch(0), world,
                              step_fn.n_microbatches)
             if grad_norms else None)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows, ev_ms, host_ms, routed = [], [], [], None
    auxes = contextlib.ExitStack()
    if cfg.n_experts:
        aux = auxes.enter_context(_recording(
            model, "train_loss", lambda out: out[1]["aux"].detach()))
    for i in range(spec["steps"]):
        b = batch(i)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with (_recording(moe_mod, "positions", lambda out: (out[0], out[2]))
              if routing and i == 0 else contextlib.nullcontext()) as seen:
            params, state, met = step_fn(params, state, b)
        stop.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev_ms.append(start.elapsed_time(stop))
        rows.append({k: float(v) for k, v in met.items()})
        if seen is not None:
            routed = _routing_of(seen, cfg.n_experts)
            del seen
        if first_params and i == 0:
            # a copy: the one-device run's leaf is its live parameter
            hold["first"] = {n: w.detach().to(torch.float32, copy=True)
                             for n, w in ((n, _whole(x))
                                          for n, x in _named(params))
                             if w is not None}
    auxes.close()
    if cfg.n_experts:
        for i, r in enumerate(rows):
            r["aux"] = sum(float(a) for a in
                           aux[i * micro:(i + 1) * micro]) / micro
    peak = torch.cuda.max_memory_allocated()
    for i, r in enumerate(rows):
        check(all(math.isfinite(v) for v in r.values()),
              f"[36] {spec['arch']} step {i + 1} metrics {r}")
    hashes = _param_hashes(params)
    rec = {"arch": spec["arch"], "n_layers": cfg.n_layers,
           "n_params": model.n_params(), "world": world, "rank": rank,
           "microbatches": micro, "tokens_per_step":
               spec["batch"] * spec["seq_len"], "steps": rows,
           "ms_per_step_events": ev_ms, "ms_per_step_host": host_ms,
           "ms_per_step_median": statistics.median(ev_ms[1:]),
           "ms_per_step_host_median": statistics.median(host_ms[1:]),
           "state_bytes": weights, "peak_memory_bytes": peak}
    n = spec["steps"]
    if "count" in extra:
        (params, state, _), col = analysis.collectives_of(
            step_fn, mesh.size(), params, state, batch(n),
            groups=sharding.groups_of(params))
        torch.cuda.synchronize()
        rec["collectives"] = col.as_dict()
        rec["collective_s"] = analysis.analyze(
            {"flops": 0.0}, col.wire_bytes).collective_s
        n += 1
    if "profile" in extra:
        b = batch(n)
        rec["profiled"] = _profiled_call(lambda: step_fn(params, state, b))
        n += 1
    rec["lrs"] = [float(schedule(ocfg, torch.tensor(i)))
                  for i in range(1, n + 1)]
    if grad_norms:
        rec["leaf_grad_norms"] = norms
    if routing:
        rec["routing"] = routed
    if hold is not None:
        hold["state"] = state
    del state
    return rec, params, hashes


def _routing_of(seen: list, n_experts: int) -> dict:
    """[40, 42] One step's routing from ``moe.positions``' calls (each MoE
    layer's forward and recompute, every microbatch): the sha256 of each
    call's expert indices, the assignments and dropped ones over all
    calls, and each call's kept assignments by expert (a data rank's
    share of them over data ranks)."""
    import hashlib
    import torch
    kept = []
    for e, k in seen:
        experts = torch.arange(n_experts, device=e.device)[:, None]
        kept.append((e[k][None, :] == experts).sum(1).tolist())
    return {"hashes": [hashlib.sha256(e.cpu().numpy().tobytes()).hexdigest()
                       for e, _ in seen],
            "assignments": sum(k.numel() for _, k in seen),
            "dropped": sum(int((~k).sum()) for _, k in seen),
            "kept_by_expert": kept}


def _first_gap(base: dict | None, other: dict | None, lr: float,
               weight_decay: float, atol: float) -> dict | None:
    """[40c] Two runs' params after step 1 (rank 0's whole leaves; None
    elsewhere), as phase 33 (c) reads a card against the CPU: the largest
    |Δ|, the elements beyond ``atol``, and those beyond 2·lr·(1 +
    wd·|p|) + 1e-7, the most rounding alone can part them by."""
    if base is None or other is None:
        return None
    out = {"elements": 0, "beyond_atol": 0, "beyond_2lr": 0, "max_abs": 0.0}
    for name, a in base.items():
        d = (other[name] - a).abs()
        out["elements"] += d.numel()
        out["beyond_atol"] += int((d > atol).sum())
        out["beyond_2lr"] += int((d > 2 * lr * (1 + weight_decay * a.abs())
                                  + 1e-7).sum())
        out["max_abs"] = max(out["max_abs"], float(d.max()))
    return out


def _named(tree, path=()) -> list:
    """(name, leaf) of a tree in ``train/optimizer._leaves``' order (dict
    keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], path + (k,))]
    return [("/".join(path), tree)]


def _whole(x):
    """A leaf made whole on global rank 0, None on the other ranks: a
    DTensor gathered there (``sharding.gather_to_rank0``), a plain tensor
    (the one-device run's, rank 0's) as it is."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.models import sharding
    if isinstance(x, DTensor):
        return sharding.gather_to_rank0(x)
    return x if dist.get_rank() == 0 else None


def _leaf_grad_norms(model, params, batch, data_ranks: int,
                     micro: int = 1) -> dict | None:
    """[39] The norm of each leaf's gradient of the loss on ``batch`` (the
    step's own computation: the mean over ``micro`` microbatches, the data
    ranks' gradients summed by the gather's backward, then divided by
    their count), each leaf made whole on rank 0: {name: norm} there, None
    on the other ranks."""
    import torch
    import torch.distributed as dist
    from repro_torch.train import microbatch
    from repro_torch.train.optimizer import _leaves, _unflatten
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    grads = None
    for i in range(micro):
        part = microbatch(batch, micro, i)
        with torch.enable_grad():
            loss, _ = model.train_loss(_unflatten(params, iter(leaves)),
                                       part)
            g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        grads = (list(g) if grads is None
                 else [a + b for a, b in zip(grads, g)])
        del loss, g
    grads = [g / micro for g in grads]
    del leaves
    out = {}
    for (name, _), g in zip(_named(params), grads):
        w = _whole(g)
        if w is not None:
            out[name] = float(torch.linalg.vector_norm(w.float())
                              / data_ranks)
        del w
    del grads
    return out if dist.get_rank() == 0 else None


def _adam_reach(lrs: list, b1: float, b2: float) -> float:
    """The farthest two AdamW runs from the same weights can part in
    updates at ``lrs``, whatever their gradients: 2·Σ_t c_t·lr_t, c_t the
    largest |m̂_t|/√v̂_t any gradients give at step t (Cauchy-Schwarz over
    the moments' weights: 1 at t = 1, 1.0029 at t = 5)."""
    total = 0.0
    for t, lr in enumerate(lrs, 1):
        a = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
        b = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
        total += lr * math.sqrt(sum(x * x / y for x, y in zip(a, b)))
    return 2 * total


def _pair_readings(base, other, lr: float, lrs: list, top: int = 4
                   ) -> dict | None:
    """[39] Two runs of one job from the same weights, ``base`` and
    ``other`` each (params, optimizer state) after the same updates at
    ``lrs`` (``base`` None off rank 0 when it is the one-device run):
    every leaf and its moments made whole on rank 0, leaf by leaf. For
    each leaf its elements, how many lie beyond 37 (a)'s bound 3·lr +
    2^-8·|p| and how many of those have first moments of opposite sign
    in the two runs, its largest ratio to that bound and to AdamW's
    reach (:func:`_adam_reach` plus a bf16 rounding an update of each
    run, half an ulp ≤ 2^-8 of the value: 2·Σ c_t·lr_t + T·2^-7·(max |p|
    + that reach), the last term 5% wider for the T roundings); the ``top``
    elements of the largest ratio to the bound over all leaves, with
    both runs' params, moments and normalised step m̂/(√v̂ + eps). On
    rank 0; None on the other ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.train import AdamWConfig
    ocfg = AdamWConfig()
    t = len(lrs)
    reach = _adam_reach(lrs, ocfg.b1, ocfg.b2)
    bc1, bc2 = 1 - ocfg.b1 ** t, 1 - ocfg.b2 ** t
    runs = {}
    for run, pair in (("base", base), ("other", other)):
        p, st = pair if pair is not None else (None, None)
        runs[run] = {part: dict(_named(tree)) if tree is not None else {}
                     for part, tree in (("p", p),
                                        ("mu", st and st["mu"]),
                                        ("nu", st and st["nu"]))}
    root = dist.get_rank() == 0
    leaves, worst = {}, []
    for name, _ in _named(other[0]):
        w = {(run, part): _whole(runs[run][part].get(name))
             for run in runs for part in ("p", "mu", "nu")}
        if not root:
            continue
        pa, pb = w["base", "p"].float(), w["other", "p"].float()
        d = (pb - pa).abs()
        ratio = d / (3 * lr + 2.0 ** -8 * pa.abs())
        env = d / (reach + t * 2.0 ** -7 * 1.05
                   * (torch.maximum(pa.abs(), pb.abs()) + reach))
        over = ratio > 1
        opposite = over & (w["base", "mu"].float()
                           * w["other", "mu"].float() < 0)
        leaves[name] = {"numel": ratio.numel(), "over": int(over.sum()),
                        "over_opposite_mu": int(opposite.sum()),
                        "max_ratio": float(ratio.max()),
                        "max_reach_ratio": float(env.max())}
        vals, idx = torch.topk(ratio.flatten(), min(top, ratio.numel()))
        for v, i in zip(vals.tolist(), idx.tolist()):
            at = tuple(int(j) for j in np.unravel_index(i, ratio.shape))

            def read(run):
                p, mu, nu = (float(w[run, part].flatten()[i].float())
                             for part in ("p", "mu", "nu"))
                return {"p": p, "mu": mu, "nu": nu, "step": (mu / bc1) / (
                    math.sqrt(max(nu, 0.0) / bc2) + ocfg.eps)}
            worst.append({"ratio": v, "leaf": name, "index": list(at),
                          "base": read("base"), "other": read("other")})
        del w, pa, pb, d, ratio, env, over, opposite
    if not root:
        return None
    n = sum(x["numel"] for x in leaves.values())
    over = sum(x["over"] for x in leaves.values())
    return {"lrs": lrs, "reach": reach, "elements": n, "over": over,
            "over_share": over / n,
            "over_opposite_mu": sum(x["over_opposite_mu"]
                                    for x in leaves.values()),
            "max_ratio": max(x["max_ratio"] for x in leaves.values()),
            "max_reach_ratio": max(x["max_reach_ratio"]
                                   for x in leaves.values()),
            "leaves": leaves,
            "worst": sorted(worst, key=lambda x: -x["ratio"])[:top]}


def _save_params(params, path: str, step: int) -> None:
    """The params in the reference's checkpoint layout (rank 0 writes)."""
    from repro_torch.train import checkpoint
    checkpoint.save(path, step, {"params": params})


def _fsdp_rank(group, device, jobs: list, out: str) -> None:
    """[36, 37, 39] ``jobs`` on this rank of ``group``, each on a (W, 1)
    ("data", "model") mesh or the job's ``mesh`` shape: ``one`` (the
    one-rank phase), ``steps`` (a spec's steps, ``save`` writing the params
    after them, ``extra`` steps, ``micro`` microbatches, ``launches``: every
    kernel's launches counted over the steps), ``run`` (``launch/train.run``
    with a checkpoint directory, copied from ``from`` first). A ``steps``
    job may also be ``alone`` (the one-device step on rank 0, no mesh;
    the other ranks wait), ``grad_norms`` (each leaf's gradient norm on
    the first batch), ``routing`` (the first step's, :func:`_routing_of`),
    ``keep`` its params and optimizer state (with ``first_params`` also
    its params after step 1) under that key, or ``compare`` them with
    those kept under that key (:func:`_pair_readings`, ``params_gap``;
    :func:`_first_gap`, ``first_gap``), which are then dropped unless the
    job says ``keep_base``; ``local_routing``: the steps with each data
    rank routing alone (:func:`_local_routing`). Rank 0 writes
    ``out/<tag>.json`` with every rank's record."""
    import gc
    import shutil

    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as ltrain
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    kept: dict = {}
    for job in jobs:
        torch.use_deterministic_algorithms(bool(job.get("deterministic")))
        spec = job["spec"]
        mesh = lmesh.make_device_mesh(
            lmesh.Mesh(tuple(job.get("mesh", (world, 1))),
                       ("data", "model")), device, cfg=_fsdp_cfg(spec))
        t0 = time.perf_counter()
        if job["kind"] == "one":
            plain, p, want = _fsdp_steps(spec, None, device)
            del p
            gc.collect()
            _reset_counts()
            rec, p, got = _fsdp_steps(spec, mesh, device, extra=("count",))
            rec["launches"] = _read_counts()
            del p
            gc.collect()
            rec["unsharded"] = plain
            rec["params_bit_equal"] = got == want
            rec["leaves"] = len(want)
            run_job = ltrain.TrainJob(
                arch=_fsdp_cfg(spec), steps=spec["steps"],
                seq_len=spec["seq_len"], global_batch=spec["batch"],
                lr=spec["lr"], warmup=spec["warmup"], log_every=1,
                seed=spec["seed"])
            quiet = lambda *a, **k: None   # noqa: E731
            rec["run_losses"] = ltrain.run(run_job, device=device,
                                           log=quiet)["losses"]
            rec["run_mesh_losses"] = ltrain.run(run_job, mesh=mesh,
                                                log=quiet)["losses"]
        elif job["kind"] == "steps" and job.get("alone") and rank:
            rec = {"alone": True}          # rank 0's one-device run
        elif job["kind"] == "steps":
            if job.get("launches"):
                _reset_counts()
            # the optimizer state outlives the steps only for a pair
            hold = ({} if job.get("keep") or job.get("compare")
                    else None)
            with (_local_routing() if job.get("local_routing")
                  else contextlib.nullcontext()):
                rec, p, _ = _fsdp_steps(
                    spec, None if job.get("alone") else mesh, device,
                    micro=job.get("micro", 1),
                    extra=tuple(job.get("extra", ())), hold=hold,
                    grad_norms=bool(job.get("grad_norms")),
                    routing=bool(job.get("routing")),
                    first_params=bool(job.get("first_params")))
            if job.get("launches"):
                rec["launches"] = _read_counts()
            if job.get("save"):
                _save_params(p, job["save"], spec["steps"])
            if job.get("keep"):
                kept[job["keep"]] = (p, hold["state"], hold.get("first"))
            if job.get("compare"):
                base = (kept.get if job.get("keep_base")
                        else kept.pop)(job["compare"], None)
                rec["params_gap"] = _pair_readings(
                    base and base[:2], (p, hold["state"]), spec["lr"],
                    rec["lrs"])
                if job.get("first_params"):
                    from repro_torch.train import AdamWConfig
                    rec["first_gap"] = _first_gap(
                        base and base[2], hold.get("first"), rec["lrs"][0],
                        AdamWConfig().weight_decay,
                        FAMILY_PARITY["param_atol"])
                del base
            del p, hold
        else:
            if job.get("from") and rank == 0:
                shutil.copytree(job["from"], job["ckpt"])
            dist.barrier(group, device_ids=[device.index])
            run_job = ltrain.TrainJob(
                arch=_fsdp_cfg(spec), steps=job["steps"],
                seq_len=spec["seq_len"], global_batch=spec["batch"],
                lr=spec["lr"], warmup=spec["warmup"], log_every=1,
                seed=spec["seed"], ckpt_dir=job["ckpt"])
            rec = {"losses": ltrain.run(run_job, mesh=mesh,
                                        log=lambda *a, **k: None)["losses"]}
        rec["seconds"] = time.perf_counter() - t0
        _gather_job(group, job, rec, out)
        del mesh
        gc.collect()
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def _local_routing():
    """[42 (b)] The negative control: each data rank routes its tokens
    alone, its capacity from its own token count and no slot offsets (the
    aux loss stays global), where ``moe.global_slots`` gives the global
    microbatch's."""
    import torch
    from repro_torch.models import moe
    real = moe.global_slots

    def alone(expert_idx, tokens, cfg, dp):
        _, offset, fe = real(expert_idx, tokens, cfg, dp)
        return moe.capacity(tokens, cfg), torch.zeros_like(offset), fe
    moe.global_slots = alone
    try:
        yield
    finally:
        moe.global_slots = real


def _gather_job(group, job: dict, rec: dict, out: str) -> None:
    """Every rank's record of ``job`` gathered; rank 0 writes them to
    ``out/<tag>.json``."""
    import torch.distributed as dist
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, rec, group=group)
    if dist.get_rank(group) == 0:
        (Path(out) / f"{job['tag']}.json").write_text(json.dumps(every))


def _fsdp_spawn(jobs: list, ranks: int, out: Path, rank_fn=None,
                device: str = "cuda", timeout_s: float = 900) -> dict:
    """``jobs`` on ``ranks`` ranks through ``rank_fn`` (default
    :func:`_fsdp_rank`; NCCL, one card each, or gloo ranks with
    ``device="cpu"``): {tag: [the ranks' records]}."""
    from repro_torch.launch import distributed as launcher
    out.mkdir(parents=True, exist_ok=True)
    launcher.spawn_ranks(rank_fn or _fsdp_rank, (jobs, str(out)), ranks,
                         device, timeout_s=timeout_s)
    return {j["tag"]: json.loads((out / f"{j['tag']}.json").read_text())
            for j in jobs}


def phase_fsdp_one_rank(report: dict, tmpdir: str) -> dict:
    """[36] qwen2-1.5b at full width and depth on an NCCL group of one rank
    over a (1, 1) mesh, 3 steps of 2 × 4,096 tokens, against the
    unsharded step in the same rank (both under deterministic algorithms):
    loss, grad_norm, lr and every param bit for bit; ``launch/train.run``
    with and without the mesh, the same losses; ms/step, peak memory and
    the collectives of one more step (count by op, 0 wire bytes)."""
    import gc
    import torch
    from repro_torch.device import card_description
    gc.collect()
    torch.cuda.empty_cache()          # room for the rank's own context
    t0 = time.perf_counter()
    got = _fsdp_spawn([dict(tag="one", kind="one", spec=FSDP_ONE,
                            deterministic=True)], 1,
                      Path(tmpdir) / "fsdp1")
    rec = got["one"][0]
    spawn_s = time.perf_counter() - t0
    plain = rec["unsharded"]
    check(rec["steps"] == plain["steps"],
          f"[36] sharded steps {rec['steps']} != unsharded {plain['steps']}")
    check(rec["params_bit_equal"], "[36] the params after 3 sharded steps "
          "differ from the unsharded step's")
    check(rec["run_mesh_losses"] == rec["run_losses"],
          f"[36] train.run(job, mesh) losses {rec['run_mesh_losses']} != "
          f"train.run(job) {rec['run_losses']}")
    check(rec["steps"][-1]["loss"] < rec["steps"][0]["loss"],
          f"[36] the loss did not fall: {rec['steps']}")
    col = rec["collectives"]
    check(set(col["wire_bytes"].values()) == {0.0},
          f"[36] wire bytes at one rank: {col['wire_bytes']}")
    phase29 = report.get("training", {}).get("full_width", {}).get(
        "ms_per_step_median")
    rec.update(card=card_description(), launch_s=spawn_s,
               phase29_ms_per_step=phase29)
    print(f"[36] one NCCL rank, mesh (1, 1), qwen2-1.5b at full width and "
          f"depth, {FSDP_ONE['batch']} x {FSDP_ONE['seq_len']} tokens, "
          f"{FSDP_ONE['steps']} steps (deterministic algorithms): loss, "
          f"grad_norm, lr and all {rec['leaves']} param leaves bit-equal to "
          f"the unsharded step; train.run(job, mesh) losses ≡ "
          f"train.run(job) {rec['run_losses']}", flush=True)
    print(f"[36] ms/step (CUDA events, median of steps 2-3): sharded "
          f"{rec['ms_per_step_median']:.1f}, unsharded "
          f"{plain['ms_per_step_median']:.1f} in the rank, phase 29 "
          f"{_ms(phase29)}; peak {rec['peak_memory_bytes'] / 1e9:.2f} GB "
          f"sharded, {plain['peak_memory_bytes'] / 1e9:.2f} unsharded "
          f"(max_memory_allocated); collectives of one step "
          f"{col['counts']}, payload {col['payload_bytes']}, wire bytes "
          f"{col['wire_bytes']}; launch {spawn_s:.1f} s; {rec['card']}",
          flush=True)
    report["fsdp_one_rank"] = rec
    return rec


def _param_gap(want_dir: str, got_dir: str, step: int, lr: float) -> dict:
    """Largest |Δ| of the params of two saved runs (their ``params/``
    leaves), its largest ratio to 3·lr + 2^-8·|param| (must be ≤ 1), and
    the element that sets that ratio (``worst``: leaf, index, both
    values)."""
    import numpy as np
    from repro_torch.train import checkpoint

    def load(d):
        man = checkpoint.load_manifest(d, step)["leaves"]
        with np.load(Path(d) / f"step_{step:09d}" / "arrays.npz") as z:
            for k in z.files:
                if not k.startswith("params/"):
                    continue
                v = z[k]
                if man[k]["dtype"] == "bfloat16":
                    v = (v.astype(np.uint32) << 16).view(np.float32)
                yield k, v
    got = dict(load(got_dir))
    gap = ratio = 0.0
    worst = None
    for k, w in load(want_dir):
        g = got.pop(k)
        d = np.abs(g - w)
        gap = max(gap, float(d.max()))
        r = d / (3 * lr + 2.0 ** -8 * np.abs(w))
        at = np.unravel_index(int(r.argmax()), r.shape)
        if float(r[at]) > ratio:
            ratio = float(r[at])
            worst = {"leaf": k, "index": [int(i) for i in at],
                     "want": float(w[at]), "got": float(g[at])}
    check(not got, f"[36] leaves only in {got_dir}: {sorted(got)}")
    return {"max_abs_gap": gap, "max_gap_over_bound": ratio, "worst": worst}


def _close_steps(got: list, want: list, rtol: float, what: str,
                 soft) -> float:
    """Largest relative gap of loss and grad_norm over the steps."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm"):
            rel = abs(g[k] - w[k]) / abs(w[k])
            soft(rel <= rtol, f"{what} step {i + 1} {k} {g[k]} vs {w[k]}")
            worst = max(worst, rel)
    return worst


def phase_fsdp_cards(n_cards: int, tmpdir: str) -> dict:
    """[36 (a)-(c)] FSDP on ``n_cards`` cards: qwen2-1.5b parity over 1, 2
    and n_cards ranks, qwen3-14b at full width and depth, the elastic
    resume. Every part is run and printed before a failed check ends the
    phase: ``failures`` lists them (the caller writes the record, then
    fails)."""
    import shutil
    from repro_torch.configs import ShapeSpec
    from repro_torch.device import card_description
    from repro_torch.launch import cells
    d = Path(tmpdir) / "fsdp"
    d.mkdir()
    rec = {"disk_free_gb": shutil.disk_usage(tmpdir).free / 1e9,
           "failures": []}

    def soft(cond: bool, msg: str) -> None:
        if not cond:
            rec["failures"].append(msg)
            print(f"FAILED: chip_smoke: {msg}", flush=True)
    el = {k: str(d / k) for k in ("el4", "el4r", "el4f", "el2r")}
    par = {w: str(d / f"parity{w}") for w in (1, 2, n_cards)}
    det = dict(deterministic=True)
    el_jobs = [dict(tag="el4", kind="run", spec=FSDP_ELASTIC, steps=2,
                    ckpt=el["el4"], **det),
               dict(tag="el4r", kind="run", spec=FSDP_ELASTIC, steps=3,
                    ckpt=el["el4r"], **{"from": el["el4"]}, **det),
               dict(tag="el4f", kind="run", spec=FSDP_ELASTIC, steps=3,
                    ckpt=el["el4f"], **det)]
    t0 = time.perf_counter()
    got = _fsdp_spawn(
        [dict(tag=f"parity{n_cards}", kind="steps", spec=FSDP_PARITY,
              save=par[n_cards], **det), *el_jobs,
         dict(tag="cell", kind="steps", spec=FSDP_CELL,
              extra=("count", "profile"))], n_cards, d / "wN")
    got.update(_fsdp_spawn(
        [dict(tag="parity2", kind="steps", spec=FSDP_PARITY, save=par[2],
              **det),
         dict(tag="el2r", kind="run", spec=FSDP_ELASTIC, steps=3,
              ckpt=el["el2r"], **{"from": el["el4"]}, **det)], 2, d / "w2"))
    got.update(_fsdp_spawn(
        [dict(tag="parity1", kind="steps", spec=FSDP_PARITY, micro=2,
              save=par[1], **det)], 1, d / "w1"))
    rec["spawn_s"] = time.perf_counter() - t0
    # (a) parity
    ref = got["parity1"][0]
    rec["parity"] = {"1": ref}
    for w in (2, n_cards):
        r = got[f"parity{w}"][0]
        rel = _close_steps(r["steps"], ref["steps"], FSDP_RTOL,
                           f"[36a] W={w}", soft)
        gap = _param_gap(par[1], par[w], FSDP_PARITY["steps"],
                         FSDP_PARITY["lr"])
        soft(gap["max_gap_over_bound"] <= 1.0, f"[36a] W={w} params {gap}")
        rec["parity"][str(w)] = dict(r, max_rel_gap=rel, **gap,
                                     ms_by_card=[x["ms_per_step_median"]
                                                 for x in got[f"parity{w}"]])
        print(f"[36a] qwen2-1.5b at full width, {FSDP_PARITY['batch']} x "
              f"{FSDP_PARITY['seq_len']} tokens, {FSDP_PARITY['steps']} "
              f"steps on {w} ranks against 1 rank in 2 microbatches "
              f"(deterministic algorithms): loss "
              + " ".join(f"{x['loss']:.6g}" for x in r["steps"])
              + " against " + " ".join(f"{x['loss']:.6g}"
                                       for x in ref["steps"])
              + ", grad_norm " + " ".join(f"{x['grad_norm']:.6g}"
                                          for x in r["steps"])
              + " against " + " ".join(f"{x['grad_norm']:.6g}"
                                       for x in ref["steps"])
              + f": within rel {rel:.3g} (bound {FSDP_RTOL}); "
              f"params max |Δ| {gap['max_abs_gap']:.3g}, "
              f"{gap['max_gap_over_bound']:.3g} of 3·lr + 2^-8·|p| (at "
              f"{gap['worst']}); ms/step by card {[round(x, 1) for x in rec['parity'][str(w)]['ms_by_card']]}"
              f" against {ref['ms_per_step_median']:.1f} on one",
              flush=True)
    # (b) the cell
    cell = got["cell"]
    c0 = cell[0]
    losses = [s["loss"] for s in c0["steps"]]
    soft(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
         f"[36b] qwen3-14b losses {losses}")
    ms = max(x["ms_per_step_median"] for x in cell)
    flops = cells.analytic_step_flops(_fsdp_cfg(FSDP_CELL), ShapeSpec(
        "train", FSDP_CELL["seq_len"], FSDP_CELL["batch"], "train"))
    peaks = [x["peak_memory_bytes"] / 1e9 for x in cell]
    soft(max(peaks) < 80.0, f"[36b] peak GB by card {peaks}")
    tokens = FSDP_CELL["batch"] * FSDP_CELL["seq_len"]
    rec["cell"] = {
        "ranks": cell, "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
        "analytic_flops_per_step": flops,
        "model_flops_share": flops / (ms / 1e3) / n_cards
        / PEAK_BF16_TENSOR_FLOPS,
        "peak_gb_by_card": peaks,
        "idle_share_by_card": [x["profiled"]["device_idle_share"]
                               for x in cell],
        "nccl_ms_by_card": [x["profiled"]["nccl_ms"] for x in cell],
        "profiled_ms_by_card": [x["profiled"]["wall_ms"] for x in cell],
        "collectives": c0["collectives"], "collective_s": c0["collective_s"]}
    cr = rec["cell"]
    print(f"[36b] qwen3-14b at full width and depth ({c0['n_layers']} "
          f"layers, {c0['n_params']:,} params, bf16, f32 moments, remat "
          f"full) on {n_cards} cards, {FSDP_CELL['batch']} x "
          f"{FSDP_CELL['seq_len']} tokens a step: loss "
          + " ".join(f"{x:.5g}" for x in losses)
          + f"; {ms:.1f} ms/step (slowest card's median of steps 2-"
          f"{FSDP_CELL['steps']}, CUDA events; by card "
          f"{[round(x['ms_per_step_median'], 1) for x in cell]}); "
          f"{cr['tokens_per_s']:.0f} tokens/s; model-FLOPs share "
          f"{cr['model_flops_share']:.4f} (analytic_step_flops {flops:.4g} / "
          f"(ms · {n_cards} · {PEAK_BF16_TENSOR_FLOPS:.4g})); peak GB by "
          f"card {[round(x, 2) for x in peaks]}", flush=True)
    print(f"[36b] one profiled step: wall ms by card "
          f"{[round(x, 1) for x in cr['profiled_ms_by_card']]}, idle share "
          f"{[round(x, 3) for x in cr['idle_share_by_card']]}, device ms in "
          f"NCCL kernels {[round(x, 1) for x in cr['nccl_ms_by_card']]}; "
          f"collectives of one step (CommDebugMode) {c0['collectives']['counts']}"
          f", payload {c0['collectives']['payload_bytes']}, wire bytes a "
          f"card {c0['collectives']['wire_bytes']} → collective term "
          f"{c0['collective_s']:.4f} s at NVLink {450e9:.3g} B/s; "
          f"{card_description()}", flush=True)
    # (c) the elastic resume
    full = got["el4f"][0]["losses"]
    same, other = got["el4r"][0]["losses"], got["el2r"][0]["losses"]
    soft(same == full[-1:], f"[36c] W=4 resumed {same} != {full}")
    arrays = {k: _arrays_of(el[k], FSDP_ELASTIC["steps"])
              for k in ("el4r", "el4f")}
    soft(arrays["el4r"].keys() == arrays["el4f"].keys() and all(
        arrays["el4r"][k].tobytes() == v.tobytes()
        for k, v in arrays["el4f"].items()),
        "[36c] the W=4 resumed checkpoint differs from the uninterrupted")
    del arrays
    rel = abs(other[0] - full[-1]) / abs(full[-1])
    soft(rel <= FSDP_RTOL, f"[36c] W=2 resumed loss {other} vs {full}")
    gap = _param_gap(el["el4f"], el["el2r"], FSDP_ELASTIC["steps"],
                     FSDP_ELASTIC["lr"])
    soft(gap["max_gap_over_bound"] <= 1.0, f"[36c] W=2 params {gap}")
    rec["elastic"] = {"w4_losses": full, "w4_resumed": same,
                      "w2_resumed": other, "w2_rel": rel, **gap}
    print(f"[36c] qwen2-1.5b at full width, {FSDP_ELASTIC['n_layers']} "
          f"layers: a checkpoint at step 2 on {n_cards} ranks, step 3 "
          f"resumed on {n_cards} bit for bit (loss {same[0]:.6g}, every "
          f"array of the step-3 checkpoint), on 2 ranks loss {other[0]:.6g} "
          f"(rel {rel:.3g}), params max |Δ| {gap['max_abs_gap']:.3g}, "
          f"{gap['max_gap_over_bound']:.3g} of the bound", flush=True)
    # (a)'s one-rank run stays for phase 37 (a), which removes it
    for p in list(el.values()) + [par[w] for w in (2, n_cards)]:
        shutil.rmtree(p, ignore_errors=True)
    rec["parity1_dir"] = par[1]
    return rec


# ---------------------------------------------------------------------------
# [37] tensor parallelism over the mesh's "model" axis (--cards N only)
# ---------------------------------------------------------------------------

# (a) phase 36 (a)'s qwen2-1.5b run (4 × 4,096 tokens, 3 steps) on a (1, 2)
# mesh: tied embeddings, qkv bias, 12 heads and 2 kv heads over 2 ranks
TP_PARITY_MESH = (1, 2)
# (b) phase 36 (b)'s qwen3-14b job on a (2, 2) mesh: the same init, batches
# and seed, 2 microbatches of one sequence on each data rank
TP_CELL_MESH = (2, 2)
TP_CELL_MICRO = 2
# (c) phase 36 (c)'s 2-layer qwen2-1.5b: a checkpoint at step 2 on (2, 2),
# step 3 resumed on (2, 2) (bit for bit) and on (4, 1) ((a)'s bounds)


def phase_tp_cards(n_cards: int, tmpdir: str, fsdp: dict) -> dict:
    """[37 (a)-(d)] FSDP × tensor parallelism on ``n_cards`` = 4 cards,
    against phase 36's runs in the same call (``fsdp``: its record). Every
    part is run and printed before a failed check ends the phase:
    ``failures`` lists them (the caller writes the record, then fails)."""
    import shutil
    from repro_torch.configs import ShapeSpec
    from repro_torch.device import card_description
    from repro_torch.launch import cells
    from repro_torch.roofline import analysis
    d = Path(tmpdir) / "tp"
    d.mkdir()
    rec = {"failures": []}

    def soft(cond: bool, msg: str) -> None:
        if not cond:
            rec["failures"].append(msg)
            print(f"FAILED: chip_smoke: {msg}", flush=True)
    if n_cards != math.prod(TP_CELL_MESH):
        soft(False, f"[37] needs {math.prod(TP_CELL_MESH)} cards, got "
                    f"{n_cards}")
        return rec
    det = dict(deterministic=True)
    el = {k: str(d / k) for k in ("el22", "el22r", "el22f", "el41r")}
    par = str(d / "parity12")
    t0 = time.perf_counter()
    got = _fsdp_spawn([dict(tag="parity12", kind="steps", spec=FSDP_PARITY,
                            mesh=TP_PARITY_MESH, save=par, **det)],
                      math.prod(TP_PARITY_MESH), d / "w2")
    got.update(_fsdp_spawn(
        [dict(tag="cell", kind="steps", spec=FSDP_CELL, mesh=TP_CELL_MESH,
              micro=TP_CELL_MICRO, launches=True,
              extra=("count", "profile")),
         dict(tag="el22", kind="run", spec=FSDP_ELASTIC, steps=2,
              mesh=TP_CELL_MESH, ckpt=el["el22"], **det),
         dict(tag="el22r", kind="run", spec=FSDP_ELASTIC, steps=3,
              mesh=TP_CELL_MESH, ckpt=el["el22r"], **{"from": el["el22"]},
              **det),
         dict(tag="el22f", kind="run", spec=FSDP_ELASTIC, steps=3,
              mesh=TP_CELL_MESH, ckpt=el["el22f"], **det),
         dict(tag="el41r", kind="run", spec=FSDP_ELASTIC, steps=3,
              ckpt=el["el41r"], **{"from": el["el22"]}, **det)],
        n_cards, d / "w4"))
    rec["spawn_s"] = time.perf_counter() - t0
    # (a) qwen2-1.5b on (1, 2) against 36 (a)'s one rank
    one = fsdp["parity"]["1"]
    r = got["parity12"][0]
    rel = _close_steps(r["steps"], one["steps"], FSDP_RTOL, "[37a] (1, 2)",
                       soft)
    gap = _param_gap(fsdp["parity1_dir"], par, FSDP_PARITY["steps"],
                     FSDP_PARITY["lr"])
    soft(gap["max_gap_over_bound"] <= 1.0, f"[37a] (1, 2) params {gap}")
    rec["parity"] = dict(r, max_rel_gap=rel, **gap, ms_by_card=[
        x["ms_per_step_median"] for x in got["parity12"]],
        peak_gb_by_card=[x["peak_memory_bytes"] / 1e9
                         for x in got["parity12"]])
    print(f"[37a] qwen2-1.5b at full width and depth on a {TP_PARITY_MESH} "
          f"mesh (tensor-parallel: 6 of 12 heads, 1 of 2 kv heads, half "
          f"the vocab a card), {FSDP_PARITY['batch']} x "
          f"{FSDP_PARITY['seq_len']} tokens, {FSDP_PARITY['steps']} steps "
          f"against 36 (a)'s one rank (deterministic algorithms): loss "
          + " ".join(f"{x['loss']:.6g}" for x in r["steps"])
          + " against " + " ".join(f"{x['loss']:.6g}" for x in one["steps"])
          + ", grad_norm " + " ".join(f"{x['grad_norm']:.6g}"
                                      for x in r["steps"])
          + " against " + " ".join(f"{x['grad_norm']:.6g}"
                                   for x in one["steps"])
          + f": within rel {rel:.3g} (bound {FSDP_RTOL}); params max |Δ| "
          f"{gap['max_abs_gap']:.3g}, {gap['max_gap_over_bound']:.3g} of "
          f"3·lr + 2^-8·|p| (at {gap['worst']}); ms/step by card "
          f"{[round(x, 1) for x in rec['parity']['ms_by_card']]} against "
          f"{one['ms_per_step_median']:.1f} on one and "
          f"{fsdp['parity']['2']['ms_by_card'][0]:.1f} on (2, 1); peak GB "
          f"by card {[round(x, 2) for x in rec['parity']['peak_gb_by_card']]}"
          f" against {one['peak_memory_bytes'] / 1e9:.2f} on one",
          flush=True)
    # (b) qwen3-14b on (2, 2) against 36 (b)'s (4, 1) run
    cell, base = got["cell"], fsdp["cell"]
    c0 = cell[0]
    losses = [x["loss"] for x in c0["steps"]]
    want = [x["loss"] for x in base["ranks"][0]["steps"]]
    worst = 0.0
    for i, (g, w) in enumerate(zip(losses, want)):
        worst = max(worst, abs(g - w) / abs(w))
        soft(abs(g - w) <= FSDP_RTOL * abs(w),
             f"[37b] step {i + 1} loss {g} vs (4, 1) {w}")
    soft(len(losses) == len(want), f"[37b] {losses} vs {want}")
    ms = max(x["ms_per_step_median"] for x in cell)
    flops = cells.analytic_step_flops(_fsdp_cfg(FSDP_CELL), ShapeSpec(
        "train", FSDP_CELL["seq_len"], FSDP_CELL["batch"], "train"))
    peaks = [x["peak_memory_bytes"] / 1e9 for x in cell]
    soft(max(peaks) < 80.0, f"[37b] peak GB by card {peaks}")
    tokens = FSDP_CELL["batch"] * FSDP_CELL["seq_len"]
    col = c0["collectives"]
    from repro_torch.models import build_model
    reckoned = analysis.reckon_collectives(
        build_model(_fsdp_cfg(FSDP_CELL), attn_impl="sdpa", device="meta"),
        TP_CELL_MESH[0], TP_CELL_MESH[1], TP_CELL_MICRO,
        FSDP_CELL["batch"] // TP_CELL_MESH[0] // TP_CELL_MICRO,
        FSDP_CELL["seq_len"])
    soft(col["by_group"] == reckoned,
         f"[37b] collectives by group {col['by_group']} != the spec tree's "
         f"{reckoned}")
    by_group_s = {g: analysis.analyze({"flops": 0.0},
                                      v["wire_bytes"]).collective_s
                  for g, v in col["by_group"].items()}
    rec["cell"] = {
        "ranks": cell, "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
        "analytic_flops_per_step": flops,
        "model_flops_share": flops / (ms / 1e3) / n_cards
        / PEAK_BF16_TENSOR_FLOPS,
        "losses": losses, "fsdp41_losses": want, "max_rel_loss_gap": worst,
        "peak_gb_by_card": peaks,
        "idle_share_by_card": [x["profiled"]["device_idle_share"]
                               for x in cell],
        "nccl_ms_by_card": [x["profiled"]["nccl_ms"] for x in cell],
        "nccl_ms_by_kind_by_card": [x["profiled"]["nccl_ms_by_kind"]
                                    for x in cell],
        "profiled_ms_by_card": [x["profiled"]["wall_ms"] for x in cell],
        "collectives": col, "collective_s": c0["collective_s"],
        "collective_s_by_group": by_group_s}
    cr, br = rec["cell"], base
    kinds = cr["nccl_ms_by_kind_by_card"]
    print(f"[37b] qwen3-14b at full width and depth ({c0['n_layers']} "
          f"layers, {c0['n_params']:,} params, bf16, f32 moments, remat "
          f"full) on a {TP_CELL_MESH} mesh of {n_cards} cards, "
          f"{FSDP_CELL['batch']} x {FSDP_CELL['seq_len']} tokens a step in "
          f"{TP_CELL_MICRO} microbatches a data rank: loss "
          + " ".join(f"{x:.5g}" for x in losses) + " against (4, 1) "
          + " ".join(f"{x:.5g}" for x in want)
          + f" (within rel {worst:.3g}, bound {FSDP_RTOL}); {ms:.1f} "
          f"ms/step (slowest card's median of steps 2-{FSDP_CELL['steps']},"
          f" CUDA events; by card "
          f"{[round(x['ms_per_step_median'], 1) for x in cell]}) against "
          f"{br['ms_per_step']:.1f} on (4, 1); "
          f"{cr['tokens_per_s']:.0f} tokens/s against "
          f"{br['tokens_per_s']:.0f}; model-FLOPs share "
          f"{cr['model_flops_share']:.4f} against "
          f"{br['model_flops_share']:.4f}; peak GB by card "
          f"{[round(x, 2) for x in peaks]} against "
          f"{[round(x, 2) for x in br['peak_gb_by_card']]}", flush=True)
    print(f"[37b] one step under CommDebugMode: counts {col['counts']}; by "
          f"group " + "; ".join(
              f"{g} ({v['ranks']} ranks) counts {v['counts']}, payload "
              f"{v['payload_bytes']}, wire bytes a card {v['wire_bytes']}"
              for g, v in col["by_group"].items())
          + f" (≡ roofline/analysis.reckon_collectives: "
          f"{col['by_group'] == reckoned})"
          + f" → collective term {c0['collective_s']:.4f} s at NVLink "
          f"{450e9:.3g} B/s (by group "
          f"{ {g: round(v, 4) for g, v in by_group_s.items()} }) against "
          f"{br['collective_s']:.4f} s on (4, 1) (wire "
          f"{ {k: v for k, v in br['collectives']['wire_bytes'].items()} })",
          flush=True)
    print(f"[37b] one profiled step: wall ms by card "
          f"{[round(x, 1) for x in cr['profiled_ms_by_card']]}, idle share "
          f"{[round(x, 3) for x in cr['idle_share_by_card']]}, device ms in "
          f"NCCL kernels {[round(x, 1) for x in cr['nccl_ms_by_card']]} by "
          f"kind {[{k: round(v, 1) for k, v in x.items()} for x in kinds]}"
          f"; on (4, 1): idle "
          f"{[round(x, 3) for x in br['idle_share_by_card']]}, NCCL ms "
          f"{[round(x, 1) for x in br['nccl_ms_by_card']]}; "
          f"{card_description()}", flush=True)
    # (c) the checkpoint of (2, 2) resumed on (2, 2) and on (4, 1)
    full = got["el22f"][0]["losses"]
    same, other = got["el22r"][0]["losses"], got["el41r"][0]["losses"]
    soft(same == full[-1:], f"[37c] (2, 2) resumed {same} != {full}")
    arrays = {k: _arrays_of(el[k], FSDP_ELASTIC["steps"])
              for k in ("el22r", "el22f")}
    soft(arrays["el22r"].keys() == arrays["el22f"].keys() and all(
        arrays["el22r"][k].tobytes() == v.tobytes()
        for k, v in arrays["el22f"].items()),
        "[37c] the (2, 2) resumed checkpoint differs from the uninterrupted")
    del arrays
    rel = abs(other[0] - full[-1]) / abs(full[-1])
    soft(rel <= FSDP_RTOL, f"[37c] (4, 1) resumed loss {other} vs {full}")
    gap = _param_gap(el["el22f"], el["el41r"], FSDP_ELASTIC["steps"],
                     FSDP_ELASTIC["lr"])
    soft(gap["max_gap_over_bound"] <= 1.0, f"[37c] (4, 1) params {gap}")
    rec["elastic"] = {"tp22_losses": full, "tp22_resumed": same,
                      "fsdp41_resumed": other, "fsdp41_rel": rel, **gap}
    print(f"[37c] qwen2-1.5b at full width, {FSDP_ELASTIC['n_layers']} "
          f"layers: a checkpoint at step 2 on (2, 2), step 3 resumed on "
          f"(2, 2) bit for bit (loss {same[0]:.6g}, every array of the "
          f"step-3 checkpoint), on (4, 1) loss {other[0]:.6g} (rel "
          f"{rel:.3g}), params max |Δ| {gap['max_abs_gap']:.3g}, "
          f"{gap['max_gap_over_bound']:.3g} of the bound", flush=True)
    # (d) no kernel on the path: counted in every rank over (b)'s steps
    launches = {}
    for x in cell:
        for k, v in x["launches"].items():
            launches[k] = launches.get(k, 0) + v
    soft(not any(launches.values()), f"[37d] kernel launches {launches}")
    rec["tp_launches"] = launches
    print(f"[37d] kernel launches over (b)'s steps on the {n_cards} cards: "
          f"{launches}", flush=True)
    for p in list(el.values()) + [par, fsdp["parity1_dir"]]:
        shutil.rmtree(p, ignore_errors=True)
    return rec


# ---------------------------------------------------------------------------
# [39] tensor parallelism of the encoder-decoder and the SSM family
# (--cards N only)
# ---------------------------------------------------------------------------

# (a) seamless-m4t-large-v2 at full width and depth: phase 32 (d)'s job (1 ×
# 1,024 tokens and frames, 3 steps) on one rank and on (1, 2); 4 × 1,024 on
# (4, 1) and (2, 2) for 5 steps, 2 microbatches of one sequence a data rank
# on (2, 2) (one pass of one sequence a card, as on (4, 1))
TPF_SEAMLESS_ONE = dict(TRAIN_ENCDEC)
TPF_SEAMLESS_CELL = dict(TRAIN_ENCDEC, batch=4, steps=5, warmup=2)
# (b) mamba2-370m at full width and depth: phase 33's 2 × 4,096 tokens on
# one rank and on (1, 2), 3 steps; 4 × 4,096 on (4, 1) and (2, 2), 5 steps,
# one pass of two sequences a data rank on (2, 2) (the step is host-bound,
# phase 33: a microbatch would add a pass's operations)
TPF_MAMBA_ONE = dict(TRAIN_SSM, steps=3)
TPF_MAMBA_CELL = dict(TRAIN_SSM, batch=4)
# each pair beyond its loss and grad_norm: AdamW moves an element whose
# gradient is at the level of bf16's rounding by about ±lr a step
# whatever its size, so where the two runs round such a gradient to
# opposite signs they part by up to 2·lr a step, past 37 (a)'s 3·lr +
# 2^-8·|p|; at full width on the CPU (tests/test_torch_tp_full_width.py)
# a few elements in 10^6 do so in bf16, under TP and under FSDP alike,
# and none in f32. A fault of the TP path moves a block of a leaf (a
# rank's heads, columns or vocab rows) instead, and one that scales or
# drops a leaf's gradient, which AdamW's normalised step hides from the
# params, shows in that leaf's gradient norm. So: at most this share of
# each leaf's elements beyond 3·lr + 2^-8·|p| (one in a leaf of 1,024),
# every element within AdamW's reach (_pair_readings), and each leaf's
# step-1 gradient norm within TPF_LEAF_GRAD_RTOL (8 of bf16's 2^-8)
TPF_PARAMS_SHARE = 1e-3
TPF_LEAF_GRAD_RTOL = 2.0 ** -5


def phase_tp_families_cards(n_cards: int, tmpdir: str) -> dict:
    """[39 (a)-(d)] FSDP × tensor parallelism of seamless-m4t-large-v2 and
    mamba2-370m at full width and depth on ``n_cards`` = 4 cards: each on
    one device against (1, 2), and on (4, 1) against (2, 2), with each
    pair's step-1 gradient norms by leaf, its params and moments read
    leaf by leaf, (2, 2)'s step figures beside (4, 1)'s and no kernel
    launched. Every part is run and printed before a failed check ends
    the phase: ``failures`` lists them (the caller writes the record,
    then fails)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.device import card_description
    from repro_torch.launch import cells
    from repro_torch.models import build_model
    from repro_torch.roofline import analysis
    d = Path(tmpdir) / "tpf"
    d.mkdir()
    rec = {"failures": [], "card": card_description()}

    def soft(cond: bool, msg: str) -> None:
        if not cond:
            rec["failures"].append(msg)
            print(f"FAILED: chip_smoke: {msg}", flush=True)
    if n_cards != math.prod(TP_CELL_MESH):
        soft(False, f"[39] needs {math.prod(TP_CELL_MESH)} cards, got "
                    f"{n_cards}")
        return rec
    # (part, key, the one-device spec, the four-card spec, microbatches a
    # data rank on (2, 2))
    models = (("a", "seamless", TPF_SEAMLESS_ONE, TPF_SEAMLESS_CELL, 2),
              ("b", "mamba2", TPF_MAMBA_ONE, TPF_MAMBA_CELL, 1))
    det = dict(deterministic=True, launches=True, grad_norms=True)
    cell = dict(launches=True, grad_norms=True, extra=("count", "profile"))
    t0 = time.perf_counter()
    # each pair in one spawn: the first run's params and moments kept on
    # its ranks, compared with the second's leaf by leaf on rank 0
    got = _fsdp_spawn(
        [job for _, k, one, _, _ in models for job in (
            dict(tag=f"{k}_one", kind="steps", spec=one, alone=True,
                 keep=k, **det),
            dict(tag=f"{k}_tp12", kind="steps", spec=one,
                 mesh=TP_PARITY_MESH, compare=k, **det))],
        math.prod(TP_PARITY_MESH), d / "w2")
    got.update(_fsdp_spawn(
        [job for _, k, _, c, micro in models for job in (
            dict(tag=f"{k}_fsdp41", kind="steps", spec=c, keep=k, **cell),
            dict(tag=f"{k}_tp22", kind="steps", spec=c, mesh=TP_CELL_MESH,
                 micro=micro, compare=k, **cell))],
        n_cards, d / "w4"))
    rec["spawn_s"] = time.perf_counter() - t0
    launches: dict = {}
    for part, k, one, c, micro in models:
        tag = f"[39{part}]"
        cfg = _fsdp_cfg(c)
        depth = (f"{cfg.encoder_layers} + {cfg.n_layers}"
                 if cfg.encoder_layers else f"{cfg.n_layers}")
        # one device against (1, 2), (4, 1) against (2, 2): loss and
        # grad_norm within 37 (a)'s rtol; the params by TPF_PARAMS' rule
        pairs = {}
        for base, tp, spec in (("one", "tp12", one), ("fsdp41", "tp22", c)):
            want, r = got[f"{k}_{base}"][0], got[f"{k}_{tp}"][0]
            rel = _close_steps(r["steps"], want["steps"], FSDP_RTOL,
                               f"{tag} {tp}", soft)
            gap = r["params_gap"]
            crowded = {n: x for n, x in gap["leaves"].items()
                       if x["over"] > TPF_PARAMS_SHARE * x["numel"]}
            soft(not crowded and gap["max_reach_ratio"] <= 1.0,
                 f"{tag} {tp} params: leaves with more than "
                 f"{TPF_PARAMS_SHARE:g} of their elements beyond 3·lr + "
                 f"2^-8·|p| {crowded}; largest ratio to AdamW's reach "
                 f"{gap['max_reach_ratio']}")
            norms = {n: (r["leaf_grad_norms"][n], g)
                     for n, g in want["leaf_grad_norms"].items()}
            norm_gaps = sorted(((abs(a - b) / b if b else abs(a), n)
                                for n, (a, b) in norms.items()),
                               reverse=True)
            soft(norm_gaps[0][0] <= TPF_LEAF_GRAD_RTOL,
                 f"{tag} {tp} step-1 gradient norms beyond rel "
                 f"{TPF_LEAF_GRAD_RTOL:g}: "
                 f"{[x for x in norm_gaps if x[0] > TPF_LEAF_GRAD_RTOL]}")
            pairs[tp] = dict(max_rel_gap=rel, params_gap=gap,
                             leaf_grad_norms=norms,
                             max_leaf_grad_norm_gap=norm_gaps[0])
            print(f"{tag} {r['arch']} at full width and depth ({depth} "
                  f"layers, {r['n_params']:,} params, "
                  f"bf16, f32 moments, remat full), {spec['batch']} x "
                  f"{spec['seq_len']} tokens, {spec['steps']} steps: "
                  f"{'(1, 2)' if tp == 'tp12' else '(2, 2)'} against "
                  f"{'one device' if base == 'one' else '(4, 1)'}: loss "
                  + " ".join(f"{x['loss']:.6g}" for x in r["steps"])
                  + " against " + " ".join(f"{x['loss']:.6g}"
                                           for x in want["steps"])
                  + ", grad_norm " + " ".join(f"{x['grad_norm']:.6g}"
                                              for x in r["steps"])
                  + " against " + " ".join(f"{x['grad_norm']:.6g}"
                                           for x in want["steps"])
                  + f": within rel {rel:.3g} (bound {FSDP_RTOL})",
                  flush=True)
            print(f"{tag} {tp} step-1 gradient norm by leaf: largest gaps "
                  + "; ".join(f"{n} {norms[n][0]:.6g} against "
                              f"{norms[n][1]:.6g} (rel {x:.3g})"
                              for x, n in norm_gaps[:4])
                  + f"; {len(norms)} leaves (bound {TPF_LEAF_GRAD_RTOL:g})",
                  flush=True)
            print(f"{tag} {tp} params after {len(gap['lrs'])} updates (lr "
                  f"sum {sum(gap['lrs']):.4g}): {gap['over']} of "
                  f"{gap['elements']:,} elements (share "
                  f"{gap['over_share']:.3g}) beyond 3·lr + 2^-8·|p|, "
                  f"{gap['over_opposite_mu']} of them with first moments "
                  f"of opposite sign; largest ratio {gap['max_ratio']:.4g}; "
                  f"largest ratio to AdamW's reach ({gap['reach']:.4g} + "
                  f"a bf16 rounding an update) {gap['max_reach_ratio']:.4g} "
                  f"(bound 1); leaves beyond: "
                  + (", ".join(f"{n} {x['over']}/{x['numel']:,}"
                               for n, x in gap["leaves"].items()
                               if x["over"]) or "none")
                  + f" (bound {TPF_PARAMS_SHARE:g} of each leaf)",
                  flush=True)
            for x in gap["worst"]:
                a, b = x["base"], x["other"]
                print(f"{tag} {tp}   {x['ratio']:.4g} at {x['leaf']}"
                      f"{x['index']}: p {a['p']:.6g} / {b['p']:.6g}, mu "
                      f"{a['mu']:.3g} / {b['mu']:.3g}, nu {a['nu']:.3g} / "
                      f"{b['nu']:.3g}, m̂/(√v̂+eps) {a['step']:.3g} / "
                      f"{b['step']:.3g}", flush=True)
        # (c) the (2, 2) step beside the (4, 1) step
        flops = cells.analytic_step_flops(cfg, ShapeSpec(
            "train", c["seq_len"], c["batch"], "train"))
        tokens = c["batch"] * c["seq_len"]
        reckoned = analysis.reckon_collectives(
            build_model(cfg, attn_impl="sdpa", device="meta"),
            TP_CELL_MESH[0], TP_CELL_MESH[1], micro,
            c["batch"] // TP_CELL_MESH[0] // micro, c["seq_len"],
            enc_len=c["seq_len"] if cfg.encoder_layers else 0)
        steps = {}
        for mesh in ("fsdp41", "tp22"):
            ranks = got[f"{k}_{mesh}"]
            r0 = ranks[0]
            ms = max(x["ms_per_step_median"] for x in ranks)
            peaks = [x["peak_memory_bytes"] / 1e9 for x in ranks]
            soft(max(peaks) < 80.0, f"{tag} {mesh} peak GB by card {peaks}")
            col = r0["collectives"]
            steps[mesh] = {
                "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
                "ms_by_card": [x["ms_per_step_median"] for x in ranks],
                "analytic_flops_per_step": flops,
                "model_flops_share": flops / (ms / 1e3) / n_cards
                / PEAK_BF16_TENSOR_FLOPS,
                "peak_gb_by_card": peaks,
                "idle_share_by_card": [x["profiled"]["device_idle_share"]
                                       for x in ranks],
                "nccl_ms_by_kind_by_card": [x["profiled"]["nccl_ms_by_kind"]
                                            for x in ranks],
                "profiled_ms_by_card": [x["profiled"]["wall_ms"]
                                        for x in ranks],
                "collectives": col, "collective_s": r0["collective_s"],
                "collective_s_by_group": {
                    g: analysis.analyze({"flops": 0.0},
                                        v["wire_bytes"]).collective_s
                    for g, v in col["by_group"].items()}}
            for x in ranks:
                for name, n in x["launches"].items():
                    launches[name] = launches.get(name, 0) + n
        for x in (got[f"{k}_one"] + got[f"{k}_tp12"]):
            for name, n in x.get("launches", {}).items():
                launches[name] = launches.get(name, 0) + n
        tp22 = steps["tp22"]["collectives"]
        soft(tp22["by_group"] == reckoned,
             f"{tag} (2, 2) collectives by group {tp22['by_group']} != the "
             f"spec tree's {reckoned}")
        rec[k] = {"parity": pairs, "steps": steps,
                  "reckoned_equal": tp22["by_group"] == reckoned,
                  "runs": {m: got[f"{k}_{m}"] for m in (
                      "one", "tp12", "fsdp41", "tp22")}}
        a, b = steps["tp22"], steps["fsdp41"]
        print(f"{tag} (c) {r['arch']}: (2, 2) in {micro} microbatch(es) a "
              f"data rank "
              f"against (4, 1), {tokens} tokens a step: {a['ms_per_step']:.1f}"
              f" against {b['ms_per_step']:.1f} ms/step (slowest card's "
              f"median of steps 2-{c['steps']}, CUDA events; by card "
              f"{[round(x, 1) for x in a['ms_by_card']]}, "
              f"{[round(x, 1) for x in b['ms_by_card']]}); "
              f"{a['tokens_per_s']:.0f} against {b['tokens_per_s']:.0f} "
              f"tokens/s; model-FLOPs share {a['model_flops_share']:.4f} "
              f"against {b['model_flops_share']:.4f} (analytic_step_flops "
              f"{flops:.4g}); peak GB by card "
              f"{[round(x, 2) for x in a['peak_gb_by_card']]} against "
              f"{[round(x, 2) for x in b['peak_gb_by_card']]}", flush=True)
        for mesh, v in (("(2, 2)", a), ("(4, 1)", b)):
            col = v["collectives"]
            print(f"{tag} (c) {mesh} one step under CommDebugMode: counts "
                  f"{col['counts']}; by group " + "; ".join(
                      f"{g} ({x['ranks']} ranks) counts {x['counts']}, "
                      f"payload {x['payload_bytes']}, wire bytes a card "
                      f"{x['wire_bytes']}" for g, x in col["by_group"].items())
                  + f" → collective term {v['collective_s']:.4f} s at NVLink "
                  f"{450e9:.3g} B/s (by group "
                  f"{ {g: round(x, 4) for g, x in v['collective_s_by_group'].items()} })"
                  + (f" (≡ reckon_collectives: {rec[k]['reckoned_equal']})"
                     if mesh == "(2, 2)" else ""), flush=True)
            print(f"{tag} (c) {mesh} one profiled step: wall ms by card "
                  f"{[round(x, 1) for x in v['profiled_ms_by_card']]}, idle "
                  f"share {[round(x, 3) for x in v['idle_share_by_card']]}, "
                  f"NCCL device ms by kind "
                  f"{[{kk: round(x, 1) for kk, x in y.items()} for y in v['nccl_ms_by_kind_by_card']]}"
                  f"; {rec['card']}", flush=True)
    # (d) no kernel on these paths: counted in every rank over every run
    soft(not any(launches.values()), f"[39d] kernel launches {launches}")
    rec["tp_families_launches"] = launches
    print(f"[39d] kernel launches over (a)-(c)'s steps on every card: "
          f"{launches}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# [40] tensor parallelism of MLA and the expert FFN (--cards N only)
# ---------------------------------------------------------------------------

# (a) phase 33 (b)'s deepseek-v2-lite-16b at full width, 4 of 27 layers
# (the deepest one card holds), 2 × 4,096 tokens in 2 microbatches, 5
# steps: one device against (1, 2), and against (1, 4), under
# deterministic algorithms, by phase 39's checks; each run's routing of
# step 1 equal on its model ranks. At lr 3e-4 after AdamWConfig's warm-up
# of 100 steps, as FSDP_CELL: after phase 33's warm-up of 2 the job's
# routing over near-ties and its drops amplify any rounding, and one bf16
# ulp on 2^-10 of the weights moves its one-device grad_norm by 1e-2 at
# step 4, past the rtol 2e-3; at 100, by 3.6e-4 at most
# (scripts/probe_moe_noise.py, PERF.md §6 PR 36)
TPM_PAIR = dict(TRAIN_MOE, warmup=100)
TPM_MICRO = 2
TPM_MESHES = ((1, 2), (1, 4))
# (b) the same job on (1, 4) at the deepest depth whose step stays under
# ~72 GB a card: 26 layers (PERF.md §4's reckoning: one card's 16.44 GB
# a MoE layer is 27.5 bytes a parameter, 10 of them the unsharded
# AdamW's new params and moments beside the old; the sharded step updates
# in place, so a card holds ~18 bytes a parameter of its 1/4: ~68.4 GB at
# 26 layers, ~71.2 at 27)
TPM_DEEP = dict(TRAIN_MOE, n_layers=26)
TPM_DEEP_MESH = (1, 4)
# (c) the reduced configs in f32 (remat full), FAMILY_PARITY's 3 steps of
# 4 × 64 tokens, one device against (1, 2) within phase 33 (c)'s bounds:
# deepseek at 32 experts (the FFN dim over "tp", as at full width), jamba
# and kimi-k2 (8 experts: the experts over "tp")
TPM_REDUCED = (("deepseek", "deepseek-v2-lite-16b", dict(n_experts=32)),
               ("jamba", "jamba-v0.1-52b", {}),
               ("kimi", "kimi-k2-1t-a32b", {}))


def _card_params(cfg, mesh) -> int:
    """[40b, 41, 42c] The parameters one card of a (D, T) mesh holds:
    each leaf's elements over T where its spec has "tp" and over D where
    it has "fsdp"."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import MeshAxes, resolve_spec
    infos = build_model(cfg, attn_impl="sdpa", device="meta").ps.infos
    total = 0
    for i in infos.values():
        spec = resolve_spec(i.spec, MeshAxes(fsdp=("data",)))
        total += math.prod(i.shape) // (mesh[1] if "model" in spec else 1) \
            // (mesh[0] if "data" in spec else 1)
    return total


def _tpm_reduced_spec(arch: str, over: dict) -> dict:
    p = FAMILY_PARITY
    return dict(arch=arch, reduced=True, over=over, batch=p["batch"],
                seq_len=p["seq_len"], steps=p["steps"], lr=TRAIN_MOE["lr"],
                warmup=TRAIN_MOE["warmup"], seed=p["seed"])


def _pair_gates(phase: str, tag: str, mesh, ranks: list, want: dict,
                cfg, spec: dict, micro: int, soft) -> dict:
    """[40a, 42a] One full-width bf16 pair, a mesh's ``ranks`` records
    against the one-device run ``want``, by phase 39's checks: loss and
    grad_norm within ``FSDP_RTOL``, each leaf's share of elements beyond
    3·lr + 2^-8·|p| and AdamW's reach, step-1 gradient norms by leaf;
    each printed. Returns the readings."""
    r = ranks[0]
    rel = _close_steps(r["steps"], want["steps"], FSDP_RTOL,
                       f"[{phase}] {tag}", soft)
    gap = r["params_gap"]
    crowded = {n: x for n, x in gap["leaves"].items()
               if x["over"] > TPF_PARAMS_SHARE * x["numel"]}
    soft(not crowded and gap["max_reach_ratio"] <= 1.0,
         f"[{phase}] {tag} params: leaves with more than "
         f"{TPF_PARAMS_SHARE:g} of their elements beyond 3·lr + 2^-8·|p| "
         f"{crowded}; largest ratio to AdamW's reach "
         f"{gap['max_reach_ratio']}")
    norms = {n: (r["leaf_grad_norms"][n], g)
             for n, g in want["leaf_grad_norms"].items()}
    norm_gaps = sorted(((abs(a - b) / b if b else abs(a), n)
                        for n, (a, b) in norms.items()), reverse=True)
    soft(norm_gaps[0][0] <= TPF_LEAF_GRAD_RTOL,
         f"[{phase}] {tag} step-1 gradient norms beyond rel "
         f"{TPF_LEAF_GRAD_RTOL:g}: "
         f"{[x for x in norm_gaps if x[0] > TPF_LEAF_GRAD_RTOL]}")
    out = dict(max_rel_gap=rel, params_gap=gap, leaf_grad_norms=norms,
               max_leaf_grad_norm_gap=norm_gaps[0],
               ms_per_step=max(y["ms_per_step_median"] for y in ranks),
               one_device_ms_per_step=want["ms_per_step_median"],
               peak_gb_by_card=[y["peak_memory_bytes"] / 1e9
                                for y in ranks],
               one_device_peak_gb=want["peak_memory_bytes"] / 1e9)
    print(f"[{phase}] {r['arch']} at full width ({cfg.n_layers} of 27 "
          f"layers, {r['n_params']:,} params, bf16, f32 moments, remat "
          f"full), {spec['batch']} x {spec['seq_len']} tokens in {micro} "
          f"microbatches, {spec['steps']} steps: {mesh} against one "
          f"device: loss " + " ".join(f"{s['loss']:.6g}" for s in r["steps"])
          + " against " + " ".join(f"{s['loss']:.6g}" for s in want["steps"])
          + ", grad_norm " + " ".join(f"{s['grad_norm']:.6g}"
                                      for s in r["steps"])
          + " against " + " ".join(f"{s['grad_norm']:.6g}"
                                   for s in want["steps"])
          + f", aux {r['steps'][0]['aux']:.6g} against "
          f"{want['steps'][0]['aux']:.6g} at step 1: within rel {rel:.3g} "
          f"(bound {FSDP_RTOL}); ms/step {out['ms_per_step']:.1f} against "
          f"{out['one_device_ms_per_step']:.1f}, peak GB by card "
          f"{[round(y, 2) for y in out['peak_gb_by_card']]} against "
          f"{out['one_device_peak_gb']:.2f}", flush=True)
    print(f"[{phase}] {tag} step-1 gradient norm by leaf: largest gaps "
          + "; ".join(f"{n} {norms[n][0]:.6g} against {norms[n][1]:.6g} "
                      f"(rel {v:.3g})" for v, n in norm_gaps[:4])
          + f"; {len(norms)} leaves (bound {TPF_LEAF_GRAD_RTOL:g})",
          flush=True)
    print(f"[{phase}] {tag} params after {len(gap['lrs'])} updates: "
          f"{gap['over']} of {gap['elements']:,} elements (share "
          f"{gap['over_share']:.3g}) beyond 3·lr + 2^-8·|p|, "
          f"{gap['over_opposite_mu']} of them with first moments of "
          f"opposite sign; largest ratio {gap['max_ratio']:.4g}; largest "
          f"ratio to AdamW's reach {gap['max_reach_ratio']:.4g} (bound 1); "
          f"leaves beyond: "
          + (", ".join(f"{n} {v['over']}/{v['numel']:,}"
                       for n, v in gap["leaves"].items() if v["over"])
             or "none")
          + f" (bound {TPF_PARAMS_SHARE:g} of each leaf)", flush=True)
    return out


def phase_tp_moe_cards(n_cards: int, tmpdir: str) -> dict:
    """[40 (a)-(d)] tensor parallelism of MLA and the expert FFN on
    ``n_cards`` = 4 cards: deepseek-v2-lite-16b at full width, 4 layers,
    on one device against (1, 2) and against (1, 4) (phase 39's checks
    and equal routing on every model rank); at 26 layers on (1, 4) with
    its step figures; the reduced deepseek, jamba and kimi-k2 in f32 on
    one device against (1, 2); no kernel launched. Every part is run and
    printed before a failed check ends the phase: ``failures`` lists them
    (the caller writes the record, then fails)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.device import card_description
    from repro_torch.launch import cells
    from repro_torch.models import build_model
    from repro_torch.roofline import analysis
    d = Path(tmpdir) / "tpm"
    d.mkdir()
    rec = {"failures": [], "card": card_description()}

    def soft(cond: bool, msg: str) -> None:
        if not cond:
            rec["failures"].append(msg)
            print(f"FAILED: chip_smoke: {msg}", flush=True)
    if n_cards != math.prod(TPM_DEEP_MESH):
        soft(False, f"[40] needs {math.prod(TPM_DEEP_MESH)} cards, got "
                    f"{n_cards}")
        return rec
    det = dict(deterministic=True, launches=True, grad_norms=True,
               routing=True, micro=TPM_MICRO)
    red = dict(deterministic=True, launches=True, first_params=True)
    t0 = time.perf_counter()
    # each pair in one spawn, the one-device run first (rank 0 alone,
    # kept there), so it runs in both; (c) in the 2-card one; (b) in a
    # spawn of its own after (a) and (c) are printed
    got = {}
    for mesh in TPM_MESHES:
        tp = f"tp{mesh[0]}{mesh[1]}"
        jobs = [dict(tag=f"one_{tp}", kind="steps", spec=TPM_PAIR,
                     alone=True, keep="one", **det),
                dict(tag=tp, kind="steps", spec=TPM_PAIR, mesh=mesh,
                     compare="one", **det)]
        if mesh == (1, 2):
            for k, arch, over in TPM_REDUCED:
                spec = _tpm_reduced_spec(arch, over)
                jobs += [dict(tag=f"{k}_one", kind="steps", spec=spec,
                              alone=True, keep=k, **red),
                         dict(tag=f"{k}_tp12", kind="steps", spec=spec,
                              mesh=mesh, compare=k, **red)]
        got.update(_fsdp_spawn(jobs, math.prod(mesh), d / tp))
    rec["pairs_spawn_s"] = time.perf_counter() - t0
    launches: dict = {}

    def count_launches(tags) -> None:
        for tag in tags:
            for x in got[tag]:
                for name, n in x.get("launches", {}).items():
                    launches[name] = launches.get(name, 0) + n
    count_launches(list(got))

    def routing_equal(tag: str) -> bool:
        hashes = [x["routing"]["hashes"] for x in got[tag]]
        return all(h == hashes[0] for h in hashes)

    def dropped(x: dict) -> float:
        return x["routing"]["dropped"] / x["routing"]["assignments"]
    # (a) the pairs at 4 layers
    cfg = _fsdp_cfg(TPM_PAIR)
    pairs = {}
    for mesh in TPM_MESHES:
        tp = f"tp{mesh[0]}{mesh[1]}"
        want, r = got[f"one_{tp}"][0], got[tp][0]
        x = _pair_gates("40a", tp, mesh, got[tp], want, cfg, TPM_PAIR,
                        TPM_MICRO, soft)
        same = routing_equal(tp)
        soft(same, f"[40a] {tp}: the model ranks routed step 1 apart")
        x.update(routing_equal_on_ranks=same,
                 routing_equal_to_one_device=(
                     r["routing"]["hashes"] == want["routing"]["hashes"]),
                 dropped_share=dropped(r),
                 one_device_dropped_share=dropped(want),
                 one_device_bit_equal=(
                     want["steps"] == got["one_tp12"][0]["steps"]))
        pairs[tp] = x
        print(f"[40a] {tp} step 1's routing ({len(r['routing']['hashes'])}"
              f" positions calls): equal on the {mesh[1]} model ranks: "
              f"{same}; equal to one device's: "
              f"{x['routing_equal_to_one_device']}; dropped share at "
              f"capacity factor {cfg.capacity_factor} "
              f"{x['dropped_share']:.5f} against one device's "
              f"{x['one_device_dropped_share']:.5f} (not gated: near-ties "
              f"may flip); the one-device runs of the two spawns bit for "
              f"bit equal: {x['one_device_bit_equal']}", flush=True)
    rec["pairs"] = pairs
    # (c) the reduced configs in f32
    reduced = {}
    p = FAMILY_PARITY
    for k, arch, over in TPM_REDUCED:
        want, r = got[f"{k}_one"][0], got[f"{k}_tp12"][0]
        rel = _close_steps(r["steps"], want["steps"], p["rtol"],
                           f"[40c] {k}", soft)
        fg = r["first_gap"]
        soft(fg["beyond_2lr"] == 0
             and fg["beyond_atol"] <= 1e-3 * fg["elements"],
             f"[40c] {k} params after step 1: {fg}")
        reduced[k] = dict(max_rel_gap=rel, first_gap=fg,
                          params_gap=r["params_gap"])
        print(f"[40c] reduced {arch} {over or ''} (f32, remat full), "
              f"{p['steps']} steps of {p['batch']} x {p['seq_len']}: (1, 2) "
              f"against one device: loss and grad_norm within rel "
              f"{rel:.3g} (bound {p['rtol']}); params after step 1 max|Δ| "
              f"{fg['max_abs']:.3g}, {fg['beyond_atol']} of "
              f"{fg['elements']} beyond {p['param_atol']}, "
              f"{fg['beyond_2lr']} beyond 2·lr", flush=True)
    rec["reduced"] = reduced
    # (b) deepseek at TPM_DEEP's depth on (1, 4)
    t0 = time.perf_counter()
    got.update(_fsdp_spawn([dict(
        tag="deep", kind="steps", spec=TPM_DEEP, mesh=TPM_DEEP_MESH,
        micro=TPM_MICRO, launches=True, routing=True,
        extra=("count", "profile"))], math.prod(TPM_DEEP_MESH), d / "deep"))
    rec["deep_spawn_s"] = time.perf_counter() - t0
    count_launches(["deep"])
    dcfg = _fsdp_cfg(TPM_DEEP)
    ranks = got["deep"]
    r0 = ranks[0]
    tokens = TPM_DEEP["batch"] * TPM_DEEP["seq_len"]
    ms = max(x["ms_per_step_median"] for x in ranks)
    flops = cells.analytic_step_flops(dcfg, ShapeSpec(
        "train", TPM_DEEP["seq_len"], TPM_DEEP["batch"], "train"))
    peaks = [x["peak_memory_bytes"] / 1e9 for x in ranks]
    soft(max(peaks) < 80.0, f"[40b] peak GB by card {peaks}")
    losses = [x["loss"] for x in r0["steps"]]
    soft(all(math.isfinite(x["loss"]) and math.isfinite(x["aux"])
             for x in r0["steps"]) and losses[-1] < losses[0],
         f"[40b] losses {losses}, aux {[x['aux'] for x in r0['steps']]}")
    same = routing_equal("deep")
    soft(same, "[40b] the model ranks routed step 1 apart")
    col = r0["collectives"]
    reckoned = analysis.reckon_collectives(
        build_model(dcfg, attn_impl="sdpa", device="meta"),
        TPM_DEEP_MESH[0], TPM_DEEP_MESH[1], TPM_MICRO,
        TPM_DEEP["batch"] // TPM_DEEP_MESH[0] // TPM_MICRO,
        TPM_DEEP["seq_len"])
    soft(col["by_group"] == reckoned,
         f"[40b] collectives by group {col['by_group']} != the spec "
         f"tree's {reckoned}")
    ranges = ("full/attn", "full/moe", "train/backward", "train/adamw")
    # PERF.md §6 PR 36's reckoning: a card's parameters at ~18 bytes each
    # (params, moments, the f32 microbatch sum, the bf16 gradients and
    # their stack) under the sharded step's in-place AdamW
    card_params = _card_params(dcfg, TPM_DEEP_MESH)
    deep = {
        "n_layers": dcfg.n_layers, "n_params": r0["n_params"],
        "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
        "ms_by_card": [x["ms_per_step_median"] for x in ranks],
        "steps": r0["steps"], "analytic_flops_per_step": flops,
        "model_flops_share": flops / (ms / 1e3) / n_cards
        / PEAK_BF16_TENSOR_FLOPS,
        "peak_gb_by_card": peaks, "card_params": card_params,
        "reckoned_peak_gb": 18 * card_params / 1e9,
        "state_gb_by_card": [x["state_bytes"] / 1e9 for x in ranks],
        "idle_share_by_card": [x["profiled"]["device_idle_share"]
                               for x in ranks],
        "device_ms_by_range_by_card": [
            {k: x["profiled"]["ranges"].get(k, {}).get("device_ms", 0.0)
             for k in ranges} for x in ranks],
        "nccl_ms_by_kind_by_card": [x["profiled"]["nccl_ms_by_kind"]
                                    for x in ranks],
        "profiled_ms_by_card": [x["profiled"]["wall_ms"] for x in ranks],
        "collectives": col, "collective_s": r0["collective_s"],
        "reckoned_equal": col["by_group"] == reckoned,
        "routing_equal_on_ranks": same, "dropped_share": dropped(r0)}
    rec["deep"] = deep
    print(f"[40b] {r0['arch']} at full width, {dcfg.n_layers} of 27 layers "
          f"({r0['n_params']:,} params) on {TPM_DEEP_MESH}, {tokens} tokens "
          f"a step in {TPM_MICRO} microbatches: {ms:.1f} ms/step (slowest "
          f"card's median of steps 2-{TPM_DEEP['steps']}, CUDA events; by "
          f"card {[round(x, 1) for x in deep['ms_by_card']]}); "
          f"{deep['tokens_per_s']:.0f} tokens/s; model-FLOPs share "
          f"{deep['model_flops_share']:.4f} (analytic_step_flops "
          f"{flops:.4g}); peak GB by card {[round(x, 2) for x in peaks]} "
          f"(reckoned {deep['reckoned_peak_gb']:.1f}: 18 bytes each of a "
          f"card's {card_params:,} parameters; weights and moments "
          f"{[round(x, 2) for x in deep['state_gb_by_card']]}); "
          f"loss " + " ".join(f"{x:.6g}" for x in losses) + ", aux "
          + " ".join(f"{x['aux']:.4g}" for x in r0["steps"])
          + f"; routing equal on the ranks: {same}, dropped share "
          f"{deep['dropped_share']:.5f}", flush=True)
    print(f"[40b] one step under CommDebugMode: counts {col['counts']}; by "
          f"group " + "; ".join(
              f"{g} ({x['ranks']} ranks) counts {x['counts']}, payload "
              f"{x['payload_bytes']}, wire bytes a card {x['wire_bytes']}"
              for g, x in col["by_group"].items())
          + f" → collective term {deep['collective_s']:.4f} s at NVLink "
          f"{450e9:.3g} B/s (≡ reckon_collectives: "
          f"{deep['reckoned_equal']})", flush=True)
    print(f"[40b] one profiled step: wall ms by card "
          f"{[round(x, 1) for x in deep['profiled_ms_by_card']]}, idle share "
          f"{[round(x, 3) for x in deep['idle_share_by_card']]} (the last "
          f"card's {deep['idle_share_by_card'][-1]:.3f}), device ms by "
          f"range {[{k: round(v, 1) for k, v in y.items()} for y in deep['device_ms_by_range_by_card']]}"
          f", NCCL device ms by kind "
          f"{[{k: round(v, 1) for k, v in y.items()} for y in deep['nccl_ms_by_kind_by_card']]}"
          f"; {rec['card']}", flush=True)
    # (d) no kernel on these paths: counted in every rank over every run
    soft(not any(launches.values()), f"[40d] kernel launches {launches}")
    rec["tp_moe_launches"] = launches
    print(f"[40d] kernel launches over (a)-(c)'s steps on every card: "
          f"{launches}", flush=True)
    return rec


# Queue 3's open check (ROADMAP): phase 39's four pairs in f32, 2 steps
# each (the question is step 1's readings), under deterministic
# algorithms, held by 39's loss and grad_norm rtol; each pair's step-1
# grad_norm gap set beside the dense pairs' ~1.4e-4 (37 (a), bf16) and
# 39's bf16 gaps of 6e-4 to 1e-3
TPF_F32 = (("seamless", dict(TPF_SEAMLESS_ONE, dtype="float32", steps=2),
            dict(TPF_SEAMLESS_CELL, dtype="float32", steps=2), 2),
           ("mamba2", dict(TPF_MAMBA_ONE, dtype="float32", steps=2),
            dict(TPF_MAMBA_CELL, dtype="float32", steps=2), 1))


def phase_tp_families_f32(n_cards: int, tmpdir: str) -> dict:
    """[39f] phase 39's pairs in f32 on ``n_cards`` = 4 cards: seamless and
    mamba2 at full width and depth, one device against (1, 2) and (4, 1)
    against (2, 2), 2 steps each: loss and grad_norm within 37 (a)'s rtol,
    step 1's grad_norm gap, each leaf's step-1 gradient norm gap and the
    params after the steps read as 39 reads them (printed, not gated: f32
    moves no element by AdamW's sign flips). ``failures`` lists the
    failed checks."""
    from repro_torch.device import card_description
    d = Path(tmpdir) / "tpf32"
    d.mkdir()
    rec = {"failures": [], "card": card_description()}

    def soft(cond: bool, msg: str) -> None:
        if not cond:
            rec["failures"].append(msg)
            print(f"FAILED: chip_smoke: {msg}", flush=True)
    if n_cards != math.prod(TP_CELL_MESH):
        soft(False, f"[39f] needs {math.prod(TP_CELL_MESH)} cards, got "
                    f"{n_cards}")
        return rec
    det = dict(deterministic=True, launches=True, grad_norms=True)
    t0 = time.perf_counter()
    got = _fsdp_spawn(
        [job for k, one, _, _ in TPF_F32 for job in (
            dict(tag=f"{k}_one", kind="steps", spec=one, alone=True,
                 keep=k, **det),
            dict(tag=f"{k}_tp12", kind="steps", spec=one,
                 mesh=TP_PARITY_MESH, compare=k, **det))],
        math.prod(TP_PARITY_MESH), d / "w2")
    got.update(_fsdp_spawn(
        [job for k, _, c, micro in TPF_F32 for job in (
            dict(tag=f"{k}_fsdp41", kind="steps", spec=c, keep=k, **det),
            dict(tag=f"{k}_tp22", kind="steps", spec=c, mesh=TP_CELL_MESH,
                 micro=micro, compare=k, **det))],
        n_cards, d / "w4"))
    rec["spawn_s"] = time.perf_counter() - t0
    launches: dict = {}
    pairs = {}
    for k, one, c, _ in TPF_F32:
        for base, tp, spec in (("one", "tp12", one), ("fsdp41", "tp22", c)):
            want, r = got[f"{k}_{base}"][0], got[f"{k}_{tp}"][0]
            tag = f"[39f] {k} {tp}"
            rel = _close_steps(r["steps"], want["steps"], FSDP_RTOL, tag,
                               soft)
            gaps = {m: abs(r["steps"][0][m] - want["steps"][0][m])
                    / abs(want["steps"][0][m]) for m in ("loss", "grad_norm")}
            norms = {n: (r["leaf_grad_norms"][n], g)
                     for n, g in want["leaf_grad_norms"].items()}
            norm_gaps = sorted(((abs(a - b) / b if b else abs(a), n)
                                for n, (a, b) in norms.items()),
                               reverse=True)
            gap = r["params_gap"]
            pairs[f"{k}_{tp}"] = dict(
                max_rel_gap=rel, step1_rel_gaps=gaps,
                max_leaf_grad_norm_gap=norm_gaps[0],
                params_over=gap["over"], params_elements=gap["elements"],
                params_max_ratio=gap["max_ratio"],
                params_max_reach_ratio=gap["max_reach_ratio"],
                ms_per_step=max(x["ms_per_step_median"]
                                for x in got[f"{k}_{tp}"]),
                peak_gb_by_card=[x["peak_memory_bytes"] / 1e9
                                 for x in got[f"{k}_{tp}"]])
            print(f"{tag}: {r['arch']} at full width and depth in f32, "
                  f"{spec['batch']} x {spec['seq_len']} tokens, "
                  f"{spec['steps']} steps, against "
                  f"{'one device' if base == 'one' else '(4, 1)'}: step-1 "
                  f"grad_norm {r['steps'][0]['grad_norm']:.8g} against "
                  f"{want['steps'][0]['grad_norm']:.8g} (rel gap "
                  f"{gaps['grad_norm']:.3g}; the dense bf16 pairs ~1.4e-4, "
                  f"39's bf16 6e-4-1e-3), loss rel gap {gaps['loss']:.3g}; "
                  f"every step within rel {rel:.3g} (bound {FSDP_RTOL}); "
                  f"largest step-1 leaf gradient-norm gap "
                  f"{norm_gaps[0][0]:.3g} at {norm_gaps[0][1]}; params "
                  f"after the steps: {gap['over']} of {gap['elements']:,} "
                  f"elements beyond 3·lr + 2^-8·|p|, largest ratio "
                  f"{gap['max_ratio']:.4g}, to AdamW's reach "
                  f"{gap['max_reach_ratio']:.4g}; peak GB by card "
                  f"{[round(x, 2) for x in pairs[f'{k}_{tp}']['peak_gb_by_card']]}"
                  f"; {rec['card']}", flush=True)
        for tagged in (f"{k}_one", f"{k}_tp12", f"{k}_fsdp41", f"{k}_tp22"):
            for x in got[tagged]:
                for name, n in x.get("launches", {}).items():
                    launches[name] = launches.get(name, 0) + n
    rec["pairs"] = pairs
    soft(not any(launches.values()), f"[39f] kernel launches {launches}")
    rec["tp_families_f32_launches"] = launches
    return rec


# ---------------------------------------------------------------------------
# [42] MoE routing over the data axis (--cards N only)
# ---------------------------------------------------------------------------

# (a) phase 40 (a)'s deepseek-v2-lite-16b at full width, 4 layers, bf16,
# at a warm-up of 100 (TPM_PAIR's reason), one device carrying 4,096
# tokens a microbatch as there: 8 × 1,024 tokens in 2 microbatches, so
# 8 divides over 2 microbatches × 4 data ranks. One device against (2,
# 1), (4, 1) and (2, 2) by phase 40's checks, with step 1's dropped
# share and kept assignments by expert beside one device's
TDM_PAIR = dict(TRAIN_MOE, batch=8, seq_len=1024, warmup=100)
TDM_MICRO = 2
TDM_MESHES = ((2, 1), (4, 1), (2, 2))
# (b) the reduced configs in f32 (remat full), FAMILY_PARITY's 3 steps of
# 64-token sequences in 2 microbatches, at a batch of 8 (4 does not split
# over 2 microbatches × 4 data ranks), one device against each mesh
# within phase 33 (c)'s bounds: deepseek at 32 experts (experts over
# "fsdp"), and at capacity factor 1.0 (assignments dropped across rank
# boundaries), jamba (experts over "tp", their FFN dim over "fsdp"),
# kimi-k2. The negative control: the capacity-1.0 job on (2, 1) with each
# rank routing alone (:func:`_local_routing`), which must fall outside
TDM_REDUCED = (("deepseek", "deepseek-v2-lite-16b", dict(n_experts=32)),
               ("drops", "deepseek-v2-lite-16b",
                dict(n_experts=32, capacity_factor=1.0)),
               ("jamba", "jamba-v0.1-52b", {}),
               ("kimi", "kimi-k2-1t-a32b", {}))
TDM_CONTROL = "drops"
# (c) deepseek-v2-lite-16b at all 27 layers on (2, 2): 4 × 4,096 tokens in
# 2 microbatches (one sequence a data rank a microbatch), 5 steps
TDM_DEEP = dict(TRAIN_MOE, n_layers=27, batch=4, seq_len=4096)
TDM_DEEP_MESH = (2, 2)


def _tdm_reduced_spec(arch: str, over: dict) -> dict:
    p = FAMILY_PARITY
    return dict(arch=arch, reduced=True, over=over, batch=8,
                seq_len=p["seq_len"], steps=p["steps"], lr=TRAIN_MOE["lr"],
                warmup=TRAIN_MOE["warmup"], seed=p["seed"])


def _tdm_tag(mesh) -> str:
    return f"dp{mesh[0]}{mesh[1]}"


def _tdm_global_kept(ranks: list, mesh) -> list:
    """Each ``positions`` call's kept assignments by expert over the
    global microbatch: the data ranks' shares summed (model rank 0 of
    each data row)."""
    rows = [ranks[d * mesh[1]]["routing"]["kept_by_expert"]
            for d in range(mesh[0])]
    return [[sum(r[c][e] for r in rows) for e in range(len(rows[0][c]))]
            for c in range(len(rows[0]))]


def _tdm_dropped(ranks: list, mesh) -> float:
    rows = [ranks[d * mesh[1]]["routing"] for d in range(mesh[0])]
    return (sum(r["dropped"] for r in rows)
            / sum(r["assignments"] for r in rows))


def phase_dp_moe_cards(n_cards: int, tmpdir: str,
                       device: str = "cuda") -> dict:
    """[42 (a)-(d)] MoE routing over the data axis on ``n_cards`` = 4
    cards: deepseek-v2-lite-16b at full width, 4 layers, one device
    against (2, 1), (4, 1) and (2, 2); the reduced deepseek (and at
    capacity factor 1.0), jamba and kimi-k2 in f32 against the same
    meshes, with a negative control that routes each rank alone; all 27
    layers on (2, 2) with its step figures; no kernel launched. Every
    part is run and printed before a failed check ends the phase:
    ``failures`` lists them (the caller writes the record, then fails).
    ``device="cpu"`` runs it on gloo ranks (a rehearsal)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.device import card_description
    from repro_torch.launch import cells
    from repro_torch.models import build_model
    from repro_torch.roofline import analysis
    d = Path(tmpdir) / "tdm"
    d.mkdir()
    rec = {"failures": [], "card": card_description()}

    def soft(cond: bool, msg: str) -> None:
        if not cond:
            rec["failures"].append(msg)
            print(f"FAILED: chip_smoke: {msg}", flush=True)
    if n_cards != math.prod(TDM_DEEP_MESH):
        soft(False, f"[42] needs {math.prod(TDM_DEEP_MESH)} cards, got "
                    f"{n_cards}")
        return rec
    det = dict(deterministic=True, launches=True, grad_norms=True,
               routing=True, micro=TDM_MICRO)
    red = dict(deterministic=True, launches=True, first_params=True,
               micro=TDM_MICRO)
    t0 = time.perf_counter()
    # one spawn of 2 ranks for (2, 1), one of 4 for (4, 1) and (2, 2); in
    # each the one-device runs first (rank 0 alone, kept there)
    got = {}
    for ranks, meshes in ((2, TDM_MESHES[:1]), (4, TDM_MESHES[1:])):
        jobs = [dict(tag=f"one_{ranks}", kind="steps", spec=TDM_PAIR,
                     alone=True, keep="one", **det)]
        for i, mesh in enumerate(meshes):
            jobs.append(dict(tag=_tdm_tag(mesh), kind="steps", spec=TDM_PAIR,
                             mesh=mesh, compare="one",
                             keep_base=i < len(meshes) - 1, **det))
        for k, arch, over in TDM_REDUCED:
            spec = _tdm_reduced_spec(arch, over)
            jobs.append(dict(tag=f"{k}_one_{ranks}", kind="steps", spec=spec,
                             alone=True, keep=k, **red))
            if k == TDM_CONTROL and ranks == 2:
                jobs.append(dict(tag=f"{k}_alone_dp21", kind="steps",
                                 spec=spec, mesh=(2, 1), compare=k,
                                 keep_base=True, local_routing=True, **red))
            for i, mesh in enumerate(meshes):
                jobs.append(dict(tag=f"{k}_{_tdm_tag(mesh)}", kind="steps",
                                 spec=spec, mesh=mesh, compare=k,
                                 keep_base=i < len(meshes) - 1, **red))
        got.update(_fsdp_spawn(jobs, ranks, d / f"w{ranks}", device=device))
    rec["pairs_spawn_s"] = time.perf_counter() - t0
    launches: dict = {}

    def count_launches(tags) -> None:
        for tag in tags:
            for x in got[tag]:
                for name, n in x.get("launches", {}).items():
                    launches[name] = launches.get(name, 0) + n
    count_launches(list(got))

    def routing_equal(tag: str, mesh) -> bool:
        """Every model rank of each data row routed its row's tokens
        alike."""
        h = [x["routing"]["hashes"] for x in got[tag]]
        return all(h[r] == h[r - r % mesh[1]] for r in range(len(h)))
    # (a) the full-width pairs
    cfg = _fsdp_cfg(TDM_PAIR)
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    pairs = {}
    for mesh in TDM_MESHES:
        tag = _tdm_tag(mesh)
        want = got[f"one_{2 if mesh == (2, 1) else 4}"][0]
        x = _pair_gates("42a", tag, mesh, got[tag], want, cfg, TDM_PAIR,
                        TDM_MICRO, soft)
        same = routing_equal(tag, mesh)
        soft(same, f"[42a] {tag}: the model ranks of a data row routed "
                   f"step 1 apart")
        kept = _tdm_global_kept(got[tag], mesh)
        kept_one = want["routing"]["kept_by_expert"]
        soft(len(kept) == len(kept_one),
             f"[42a] {tag}: {len(kept)} positions calls against one "
             f"device's {len(kept_one)}")
        # microbatch 0's forward: one call a MoE layer, in layer order
        layers = [dict(kept=kept[i], one_device=kept_one[i],
                       l1=sum(abs(a - b) for a, b in zip(kept[i],
                                                         kept_one[i])))
                  for i in range(min(moe_layers, len(kept)))]
        x.update(routing_equal_on_model_ranks=same,
                 kept_by_expert_by_layer=layers,
                 dropped_share=_tdm_dropped(got[tag], mesh),
                 one_device_dropped_share=want["routing"]["dropped"]
                 / want["routing"]["assignments"])
        pairs[tag] = x
        print(f"[42a] {tag} step 1's routing: the model ranks of each data "
              f"row equal: {same}; dropped share at capacity factor "
              f"{cfg.capacity_factor} {x['dropped_share']:.5f} against one "
              f"device's {x['one_device_dropped_share']:.5f} (not gated: "
              f"near-ties may flip); the first microbatch's kept "
              f"assignments by expert, summed over the data ranks, against "
              f"one device's, by MoE layer: "
              + "; ".join(f"layer {i + 2} L1 gap {y['l1']} of "
                          f"{sum(y['one_device'])}: {y['kept']} against "
                          f"{y['one_device']}" for i, y in enumerate(layers)),
              flush=True)
    rec["pairs"] = pairs
    # (b) the reduced configs in f32, and the negative control
    reduced = {}
    p = FAMILY_PARITY
    ignore = lambda cond, msg: None   # noqa: E731

    def held(tag: str, base: str, gate) -> dict:
        want, r = got[base][0], got[tag][0]
        rel = _close_steps(r["steps"], want["steps"], p["rtol"],
                           f"[42b] {tag}", gate)
        fg = r["first_gap"]
        inside = (rel <= p["rtol"] and fg["beyond_2lr"] == 0
                  and fg["beyond_atol"] <= 1e-3 * fg["elements"])
        gate(inside, f"[42b] {tag} params after step 1: {fg}")
        return dict(max_rel_gap=rel, first_gap=fg, inside=inside,
                    params_gap=r["params_gap"],
                    aux=[s["aux"] for s in r["steps"]],
                    one_device_aux=[s["aux"] for s in want["steps"]])

    def line(tag: str, x: dict, what: str) -> None:
        fg = x["first_gap"]
        print(f"[42b] {tag} ({what}): loss and grad_norm within rel "
              f"{x['max_rel_gap']:.3g} (bound {p['rtol']}); aux by step "
              + " ".join(f"{a:.8g}" for a in x["aux"]) + " against "
              + " ".join(f"{a:.8g}" for a in x["one_device_aux"])
              + f"; params after step 1 max|Δ| {fg['max_abs']:.3g}, "
              f"{fg['beyond_atol']} of {fg['elements']} beyond "
              f"{p['param_atol']}, {fg['beyond_2lr']} beyond 2·lr: "
              f"{'inside' if x['inside'] else 'outside'} the bounds",
              flush=True)
    for k, arch, over in TDM_REDUCED:
        for mesh in TDM_MESHES:
            tag = f"{k}_{_tdm_tag(mesh)}"
            base = f"{k}_one_{2 if mesh == (2, 1) else 4}"
            reduced[tag] = held(tag, base, soft)
            line(tag, reduced[tag], f"reduced {arch} {over or ''}, f32, "
                 f"remat full, {p['steps']} steps of 8 x {p['seq_len']} "
                 f"in {TDM_MICRO} microbatches, {mesh} against one device")
    rec["reduced"] = reduced
    tag = f"{TDM_CONTROL}_alone_dp21"
    control = held(tag, f"{TDM_CONTROL}_one_2", ignore)
    soft(not control["inside"],
         f"[42b] the negative control {tag} (each data rank routing alone) "
         f"fell inside the bounds: the gate cannot fail")
    rec["control"] = control
    line(tag, control, "the negative control: each data rank routing "
         "alone, its capacity from its own tokens, no offsets; must be "
         "outside")
    # (c) deepseek at all 27 layers on (2, 2)
    t0 = time.perf_counter()
    got.update(_fsdp_spawn([dict(
        tag="deep", kind="steps", spec=TDM_DEEP, mesh=TDM_DEEP_MESH,
        micro=TDM_MICRO, launches=True, routing=True,
        extra=("count", "profile"))], math.prod(TDM_DEEP_MESH), d / "deep",
        device=device))
    rec["deep_spawn_s"] = time.perf_counter() - t0
    count_launches(["deep"])
    dcfg = _fsdp_cfg(TDM_DEEP)
    ranks = got["deep"]
    r0 = ranks[0]
    tokens = TDM_DEEP["batch"] * TDM_DEEP["seq_len"]
    ms = max(x["ms_per_step_median"] for x in ranks)
    flops = cells.analytic_step_flops(dcfg, ShapeSpec(
        "train", TDM_DEEP["seq_len"], TDM_DEEP["batch"], "train"))
    peaks = [x["peak_memory_bytes"] / 1e9 for x in ranks]
    soft(max(peaks) < 80.0, f"[42c] peak GB by card {peaks}")
    soft(all(math.isfinite(x[k]) for x in r0["steps"]
             for k in ("loss", "aux", "grad_norm")),
         f"[42c] steps {r0['steps']}")
    same = routing_equal("deep", TDM_DEEP_MESH)
    soft(same, "[42c] the model ranks of a data row routed step 1 apart")
    col = r0["collectives"]
    reckoned = analysis.reckon_collectives(
        build_model(dcfg, attn_impl="sdpa", device="meta"),
        TDM_DEEP_MESH[0], TDM_DEEP_MESH[1], TDM_MICRO,
        TDM_DEEP["batch"] // TDM_DEEP_MESH[0] // TDM_MICRO,
        TDM_DEEP["seq_len"])
    soft(col["by_group"] == reckoned,
         f"[42c] collectives by group {col['by_group']} != the spec "
         f"tree's {reckoned}")
    ranges = ("full/attn", "full/moe", "train/backward", "train/adamw")
    card_params = _card_params(dcfg, TDM_DEEP_MESH)
    losses = [x["loss"] for x in r0["steps"]]
    deep = {
        "n_layers": dcfg.n_layers, "n_params": r0["n_params"],
        "ms_per_step": ms, "tokens_per_s": tokens / (ms / 1e3),
        "ms_by_card": [x["ms_per_step_median"] for x in ranks],
        "steps": r0["steps"], "analytic_flops_per_step": flops,
        "model_flops_share": flops / (ms / 1e3) / n_cards
        / PEAK_BF16_TENSOR_FLOPS,
        "peak_gb_by_card": peaks, "card_params": card_params,
        "reckoned_peak_gb": 18 * card_params / 1e9,
        "state_gb_by_card": [x["state_bytes"] / 1e9 for x in ranks],
        "idle_share_by_card": [x["profiled"]["device_idle_share"]
                               for x in ranks],
        "device_ms_by_range_by_card": [
            {k: x["profiled"]["ranges"].get(k, {}).get("device_ms", 0.0)
             for k in ranges} for x in ranks],
        "nccl_ms_by_kind_by_card": [x["profiled"]["nccl_ms_by_kind"]
                                    for x in ranks],
        "profiled_ms_by_card": [x["profiled"]["wall_ms"] for x in ranks],
        "collectives": col, "collective_s": r0["collective_s"],
        "reckoned_equal": col["by_group"] == reckoned,
        "routing_equal_on_model_ranks": same,
        "dropped_share": _tdm_dropped(ranks, TDM_DEEP_MESH)}
    rec["deep"] = deep
    print(f"[42c] {r0['arch']} at full width, {dcfg.n_layers} of 27 layers "
          f"({r0['n_params']:,} params) on {TDM_DEEP_MESH}, {tokens} tokens "
          f"a step in {TDM_MICRO} microbatches: {ms:.1f} ms/step (slowest "
          f"card's median of steps 2-{TDM_DEEP['steps']}, CUDA events; by "
          f"card {[round(x, 1) for x in deep['ms_by_card']]}); "
          f"{deep['tokens_per_s']:.0f} tokens/s; model-FLOPs share "
          f"{deep['model_flops_share']:.4f} (analytic_step_flops "
          f"{flops:.4g}); peak GB by card {[round(x, 2) for x in peaks]} "
          f"(reckoned {deep['reckoned_peak_gb']:.1f}: 18 bytes each of a "
          f"card's {card_params:,} parameters; weights and moments "
          f"{[round(x, 2) for x in deep['state_gb_by_card']]}); "
          f"loss " + " ".join(f"{x:.6g}" for x in losses) + ", grad_norm "
          + " ".join(f"{x['grad_norm']:.4g}" for x in r0["steps"])
          + ", aux " + " ".join(f"{x['aux']:.4g}" for x in r0["steps"])
          + f"; routing equal on the model ranks: {same}, dropped share "
          f"{deep['dropped_share']:.5f}", flush=True)
    print(f"[42c] one step under CommDebugMode: counts {col['counts']}; by "
          f"group " + "; ".join(
              f"{g} ({x['ranks']} ranks) counts {x['counts']}, payload "
              f"{x['payload_bytes']}, wire bytes a card {x['wire_bytes']}"
              for g, x in col["by_group"].items())
          + f" → collective term {deep['collective_s']:.4f} s at NVLink "
          f"{450e9:.3g} B/s (≡ reckon_collectives: "
          f"{deep['reckoned_equal']})", flush=True)
    print(f"[42c] one profiled step: wall ms by card "
          f"{[round(x, 1) for x in deep['profiled_ms_by_card']]}, idle share "
          f"{[round(x, 3) for x in deep['idle_share_by_card']]}, device ms "
          f"by range "
          f"{[{k: round(v, 1) for k, v in y.items()} for y in deep['device_ms_by_range_by_card']]}"
          f", NCCL device ms by kind "
          f"{[{k: round(v, 1) for k, v in y.items()} for y in deep['nccl_ms_by_kind_by_card']]}"
          f"; {rec['card']}", flush=True)
    # (d) no kernel on these paths: counted in every rank over every run
    soft(not any(launches.values()), f"[42d] kernel launches {launches}")
    rec["dp_moe_launches"] = launches
    print(f"[42d] kernel launches over (a)-(c)'s steps on every card: "
          f"{launches}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# [41] serving over a tensor-parallel mesh (--cards N only)
# ---------------------------------------------------------------------------

# the teacher-forced check of every serve pair: TPS's prompts prefilled,
# then its decode steps fed tokens drawn from its seed; the last-position
# logits of the prefill and of each step compared
TPS = dict(batch=2, prompt=1024, steps=8, s_max=1040, seed=0)
# (a) qwen3-14b at full width and depth (40 layers, 14.77 B params), one
# card against (1, 2) and (1, 4)
TPS_QWEN = dict(SERVE, arch="qwen3-14b")
# (b) jamba-v0.1-52b at full width and all 32 layers (103 GB of bf16: no
# card holds it) on (1, 2) against (1, 4), phase 7's traffic served on
# each; at 16 layers (phase 31 (b)'s one-card serve) one card against
# (1, 2)
TPS_JAMBA = dict(SERVE, arch="jamba-v0.1-52b")
TPS_JAMBA16 = dict(SERVE_HYBRID)
# (c) the other families at full width and depth, one card against (1, 2):
# MLA decode, the SSM, head dim 96, the encoder-decoder
TPS_OTHERS = (("deepseek", dict(SERVE, arch="deepseek-v2-lite-16b")),
              ("mamba2", dict(SERVE, arch="mamba2-370m")),
              ("phi3", dict(SERVE, arch="phi-3-vision-4.2b")),
              ("seamless", dict(SERVE, arch="seamless-m4t-large-v2")))
# (d) in f32, one card against (1, 2) within phase 31 (c)'s LM_TOL: the
# reduced config of every family (TPS at 48 tokens); at full width
# qwen3-14b at 2 layers, deepseek-v2-lite at 2 (its dense first layer and
# an MoE layer: 64 experts over "data", the FFN dim over "model") and
# jamba at 8 (one block: 7 SSM layers, GQA, 4 MoE layers of 16 experts
# over "model"), 2 × 256 tokens: f32 leaves the routing's near-ties
# where bf16 settles them apart (below)
TPS_WIDE = dict(TPS, prompt=256, steps=4, s_max=272)
TPS_F32 = tuple(
    (f"{k}_f32", dict(arch=a, reduced=True, dtype="float32", seed=7,
                      tf=dict(TPS, prompt=48, steps=4, s_max=64)))
    for k, a in (("qwen3", "qwen3-14b"), ("phi3", "phi-3-vision-4.2b"),
                 ("mamba2", "mamba2-370m"), ("jamba", "jamba-v0.1-52b"),
                 ("deepseek", "deepseek-v2-lite-16b"),
                 ("seamless", "seamless-m4t-large-v2"))) + tuple(
    (f"{k}_wide_f32", dict(arch=a, n_layers=n, dtype="float32", seed=7,
                           tf=TPS_WIDE))
    for k, a, n in (("qwen3", "qwen3-14b", 2),
                    ("deepseek", "deepseek-v2-lite-16b", 2),
                    ("jamba", "jamba-v0.1-52b", 8)))
# (d) on (1, 4) against one card as well: the experts over "model" at
# T = 4 (jamba) and MLA with the expert FFN dim over "model" (deepseek)
TPS_F32_14 = ("jamba_wide_f32", "deepseek_wide_f32")
# the bf16 pairs: the greedy token the same wherever the one-card top-2
# margin exceeds the logits' max|Δ|; without experts also that max|Δ|
# within this share of the one-card logits' largest magnitude over the
# vocab (a rank's block wrong moves them by about their own size)
TPS_REL = 2.0 ** -2
# An MoE router's near-ties, which two roundings settle apart, shift the
# slot positions of every later token at that expert and with them which
# tokens its capacity drops, so an MoE pair is held to the base's own
# spread under one bf16 ulp more on 2^-10 of its weights
# (scripts/probe_moe_noise.py's perturbation; the base run again with its
# weights bumped): max|Δ| and mean|Δ| each within TPS_NOISE times the
# spread's. (b)'s negative control, jamba at 16 layers on (1, 2) with the
# last rank's experts rolled by one, must fall outside that bound.
TPS_BUMP_SHARE = 2.0 ** -10
TPS_NOISE = 2.0
# (b)'s command line: jamba's 32 layers served through serve_lm's
# --model-ranks (spawned NCCL ranks, rank 0 reporting)
TPS_CLI = ("--arch", "jamba-v0.1-52b", "--model-ranks", "2", "--requests",
           "4", "--new-tokens", "8", "--prompt-max", "1024")


def _dev_sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tps_run(model, params, tp, tf: dict, trace: bool = False) -> dict:
    """[41] ``tf``'s prompts prefilled (an encoder-decoder's with frames of
    its ``frontend_tokens``), then its decode steps teacher-forced from its
    seed, on a serve tree and its ``tp`` (or one device's params, no
    ``tp``): the last-position logits of each (f32, numpy), the prefill's
    ms and each step's, host clock after a synchronise. With ``trace``
    two more steps under ``torch.profiler`` (:func:`_tps_trace`)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve_lm
    cfg, dev = model.cfg, model.device
    b, s = tf["batch"], tf["prompt"]
    rng = np.random.default_rng(tf["seed"])
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, (b, s)),
                           device=dev)
    fed = torch.as_tensor(rng.integers(2, cfg.vocab_size, (tf["steps"], b)),
                          device=dev)
    fe, enc = None, ()
    if cfg.encoder_layers:
        fe = torch.as_tensor(rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32),
            device=dev)
        enc = (cfg.frontend_tokens,)
    t = 1 if tp is None else tp.size
    _dev_sync(dev)
    t0 = time.perf_counter()
    logits, pre = model.prefill(params, toks, fe, tp=tp)
    _dev_sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    caches = model.init_decode_caches(b, tf["s_max"], *enc, model_ranks=t)
    serve_lm.write_caches(caches, pre, s)
    del pre
    out, step_ms = [logits.float().cpu()], []
    for i in range(tf["steps"]):
        _dev_sync(dev)
        t0 = time.perf_counter()
        logits, caches = model.decode_step(params, fed[i], caches, s + i,
                                           tp=tp)
        _dev_sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits.float().cpu())
    rec = {"logits": torch.stack(out).numpy(), "prefill_ms": prefill_ms,
           "decode_ms": step_ms}
    if trace:
        rec["trace"] = _tps_trace(model, params, tp, caches, fed,
                                  s + tf["steps"])
    del caches
    return rec


# the runtime calls that make the host wait for the device
TPS_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
                  "cuCtxSynchronize")


def _tps_trace(model, params, tp, caches, fed, pos: int,
               steps: int = 2) -> dict:
    """[41] ``steps`` teacher-forced decode steps from position ``pos``
    under ``torch.profiler`` (the device's kernels and copies on the card),
    per step: the host's wall ms (profiled), the device's busy ms and ops
    (``launch/profile_step.analyze_trace``), its ms in NCCL kernels (on a
    rank ahead of the others, mostly waiting in them) and in the other
    kernels (``compute_ms``), in copies (memcpy and memset, and kernels
    named for copying: the decode's casts), the copies' bytes where the
    trace gives them, the runtime calls within a step that wait for the
    device (:data:`TPS_SYNC_CALLS`; those outside the steps by name), the
    runtime and driver calls' count and host ms, the host ms in each range
    (``decode/ssm``, ``decode/moe``, …) and the largest device ops."""
    import collections
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.launch.profile_step import analyze_trace
    dev = model.device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    _dev_sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            with record_function("tps/step"):
                model.decode_step(params, fed[i], caches, pos + i, tp=tp)
        _dev_sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    stats = analyze_trace(events, steps)
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    copies = [e for e in device if e["cat"] != "kernel"
              or "copy" in e["name"].lower()]
    api = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver")]
    host = collections.defaultdict(float)
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] != "tps/step":
            host[e["name"]] += e.get("dur", 0) / 1e3 / steps
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("name") == "tps/step"
               and e.get("cat") == "user_annotation"]
    waits = [e for e in api if e["name"] in TPS_SYNC_CALLS]
    inside = [e for e in waits
              if any(a <= e["ts"] <= b for a, b in windows)]
    nccl = [e for e in device if "nccl" in e["name"].lower()]
    per = lambda x: x / steps             # noqa: E731
    return {
        "steps": steps, "wall_ms": wall_ms,
        "device_busy_ms": stats["device_busy_ms"],
        "device_ops": stats["launches"],
        "nccl_ms": per(sum(e["dur"] for e in nccl) / 1e3),
        "compute_ms": per(sum(e["dur"] for e in device
                              if e not in nccl) / 1e3),
        "copy_ms": per(sum(e["dur"] for e in copies) / 1e3),
        "copy_ops": per(len(copies)),
        "copy_bytes": per(sum(e.get("args", {}).get("bytes", 0) or 0
                              for e in copies)),
        "sync_calls": per(len(inside)),
        "sync_calls_outside_steps": sorted(
            e["name"] for e in waits if e not in inside),
        "api_calls": per(len(api)),
        "api_host_ms": per(sum(e.get("dur", 0) for e in api) / 1e3),
        "host_ms_by_range": dict(sorted(host.items(),
                                        key=lambda kv: -kv[1])),
        "device_ms_by_range": {k: v["device_ms"]
                               for k, v in stats["ranges"].items()},
        "top_device_ops": stats["top_device_ops"][:6]}


def _bump_ulps(params, seed: int) -> None:
    """One unit in the last place more magnitude on a random
    ``TPS_BUMP_SHARE`` of each leaf's elements, in place (the integer
    view of the float adds 1; leaves in sorted path order, one generator
    from ``seed``)."""
    import torch
    from repro_torch.train.optimizer import _leaves
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for leaf in _leaves(params):
        gen = torch.Generator(device=leaf.device).manual_seed(seed)
        seed += 1
        mask = torch.rand(leaf.shape, generator=gen,
                          device=leaf.device) < TPS_BUMP_SHARE
        bits = leaf.view(ints[leaf.dtype])
        bits += mask.to(bits.dtype)


def _roll_experts(params) -> None:
    """The negative control of (b): each MoE layer's expert FFN leaves
    (``w_gate``, ``w_up``, ``w_down``: the rank's experts on a serve tree)
    rolled by one along their expert axis, in place, so a token sent to one
    of these experts meets its neighbour's weights."""
    import torch
    if not isinstance(params, dict):
        return
    for k, v in params.items():
        if k == "moe":
            for w in (v["w_gate"], v["w_up"], v["w_down"]):
                w.copy_(torch.roll(w, 1, dims=w.dim() - 3))
        else:
            _roll_experts(v)


def _tps_memory(dev) -> dict:
    import torch
    if dev.type != "cuda":
        return {}
    return {"allocated_bytes": torch.cuda.memory_allocated(dev),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def _tps_job(job: dict, group, device, out: str) -> dict:
    """[41] One job on this rank: ``kind`` "one" (rank 0 alone, one
    device's params) or "tp" (every rank, the serve tree of the job's
    (1, T) ``mesh``), with ``bump`` one ulp more on 2^-10 of the weights
    (:func:`_bump_ulps`), with ``wrong`` the last rank's experts rolled
    (:func:`_roll_experts`); the teacher-forced run (:func:`_tps_run`,
    every kernel's launches counted over it, with ``trace`` two more
    steps profiled), its logits written by rank 0 to
    ``out/<tag>.npy`` and their sha256 recorded on every rank; with
    ``k2`` K2 ≡ its plain version on the q, k, v of this rank's first K2
    call (on the card); with ``serve`` the spec's traffic through
    ``serve_lm.serve`` on the serve tree, launches counted over it; the
    weights' bytes, the init's and the runs' peaks a card."""
    import gc
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model, sharding
    rank = dist.get_rank(group)
    spec = job["spec"]
    cfg = _fsdp_cfg(spec)
    model = build_model(cfg, device=device)
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "n_params": model.n_params(), "dtype": cfg.param_dtype}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    held = _tps_memory(device).get("allocated_bytes", 0)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    t0 = time.perf_counter()
    if job["kind"] == "one":
        params, tp = model.init_params(gen), None
    else:
        mesh = lmesh.make_device_mesh(
            lmesh.Mesh(tuple(job["mesh"]), ("data", "model")), device)
        lmesh.check_divides(cfg, mesh, attn_impl=model.attn_impl)
        params, tp = sharding.for_serve(model.init_params(gen, mesh))
    if job.get("bump"):
        _bump_ulps(params, spec["seed"] + 1)
    if job.get("wrong") and rank == dist.get_world_size(group) - 1:
        _roll_experts(params)
    _dev_sync(device)
    rec["init_s"] = time.perf_counter() - t0
    mem = _tps_memory(device)
    if mem:
        rec["weights_bytes"] = mem["allocated_bytes"] - held
        rec["init_peak_bytes"] = mem["peak_bytes"]
        torch.cuda.reset_peak_memory_stats(device)
    tf = spec.get("tf", TPS)
    _reset_counts()
    with _first_call(ops, "flash_attention") as seen:
        run = _tps_run(model, params, tp, tf, bool(job.get("trace")))
    rec["launches"] = _read_counts()
    logits = run.pop("logits")
    rec.update(run, logits_shape=list(logits.shape),
               logits_sha256=hashlib.sha256(logits.tobytes()).hexdigest())
    if rank == 0:
        np.save(Path(out) / f"{job['tag']}.npy", logits)
    del logits
    if seen:
        q, k, _ = seen["args"]
        rec["k2_shapes"] = [list(q.shape), list(k.shape)]
    if job.get("k2") and device.type == "cuda":
        check(bool(seen), f"[41] {job['tag']}: no K2 call in the prefill")
        q, k, v = seen["args"]
        rec["k2_check"] = _k2_case(
            f"[41] rank {rank}", f"{job['tag']}-first-prefill", q, k, v,
            seen["kw"].get("causal", True), first=False)
        del q, k, v
    seen.clear()
    if job.get("serve"):
        reqs = serve_lm.make_requests(
            spec["requests"], cfg.vocab_size, prompt_min=spec["prompt_min"],
            prompt_max=spec["prompt_max"], new_tokens=spec["new_tokens"],
            seed=spec["seed"])
        _reset_counts()
        rep = serve_lm.serve(
            model, params, reqs, tp=tp,
            frames=serve_lm.make_frames(cfg, reqs, spec["seed"]),
            slots=spec["slots"], s_max=spec["s_max"],
            page_size=spec["page_size"], n_pages=spec["n_pages"])
        rec["serve"] = dict(rep.summary(), launches=_read_counts(),
                            prompt_lens=[len(r.prompt) for r in reqs],
                            streams=[list(map(int, f.tokens))
                                     for f in rep.finished])
    mem = _tps_memory(device)
    if mem:
        rec["run_peak_bytes"] = mem["peak_bytes"]
    del params, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _tps_rank(group, device, jobs: list, out: str) -> None:
    """[41] ``jobs`` on this rank of ``group`` in order (:func:`_tps_job`;
    a "one" job runs on rank 0 while the others wait); rank 0 writes
    ``out/<tag>.json`` with every rank's record."""
    import torch.distributed as dist
    rank = dist.get_rank(group)
    for job in jobs:
        t0 = time.perf_counter()
        rec = ({"alone": True} if job["kind"] == "one" and rank
               else _tps_job(job, group, device, out))
        rec["seconds"] = time.perf_counter() - t0
        _gather_job(group, job, rec, out)


def _tps_jobs() -> tuple[list, list]:
    """[41] The two spawns' jobs: on 2 ranks every one-card run (rank 0)
    and every (1, 2) run, each MoE pair's base also with its weights
    bumped (:data:`TPS_NOISE`), (b)'s negative control, jamba's 32 layers
    last; on 4 ranks (1, 4). The decode steps of (a) and (b) and of
    mamba2 are traced (:func:`_tps_trace`)."""
    traced = ("qwen3", "jamba16", "mamba2")
    two: list = []
    for key, spec in (("qwen3", TPS_QWEN),) + TPS_OTHERS + (
            ("jamba16", TPS_JAMBA16),):
        two += [dict(tag=f"{key}_one", kind="one", spec=spec,
                     trace=key in traced),
                dict(tag=f"{key}_tp12", kind="tp", spec=spec, mesh=(1, 2),
                     k2=key not in ("deepseek", "mamba2"),
                     trace=key in traced)]
        if _fsdp_cfg(spec).n_experts:
            two.append(dict(tag=f"{key}_bump", kind="one", spec=spec,
                            bump=True))
    two.append(dict(tag="jamba16_wrong", kind="tp", spec=TPS_JAMBA16,
                    mesh=(1, 2), wrong=True))
    for key, spec in TPS_F32:
        two += [dict(tag=f"{key}_one", kind="one", spec=spec),
                dict(tag=f"{key}_tp12", kind="tp", spec=spec, mesh=(1, 2))]
    two += [dict(tag="jamba_bump", kind="tp", spec=TPS_JAMBA, mesh=(1, 2),
                 bump=True),
            dict(tag="jamba_tp12", kind="tp", spec=TPS_JAMBA, mesh=(1, 2),
                 k2=True, serve=True, trace=True)]
    four = [dict(tag=f"{key}_tp14", kind="tp", spec=dict(TPS_F32)[key],
                 mesh=(1, 4)) for key in TPS_F32_14]
    four += [dict(tag="qwen3_tp14", kind="tp", spec=TPS_QWEN, mesh=(1, 4),
                  k2=True, trace=True),
             dict(tag="jamba_tp14", kind="tp", spec=TPS_JAMBA, mesh=(1, 4),
                  k2=True, serve=True, trace=True)]
    return two, four


def _tps_compare(want, got, vocab: int) -> dict:
    """Two runs' logits (steps + 1, B, V_pad) over the first ``vocab``
    columns (the padded ones are -1e30 in both): max|Δ| and mean|Δ|, the
    one-card logits' largest magnitude, and the greedy tokens where the
    one-card top-2 margin exceeds max|Δ| (``checked``) and how many of
    them agree."""
    import numpy as np
    want, got = want[..., :vocab], got[..., :vocab]
    diff = np.abs(got - want)
    err = float(diff.max())
    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    sure = margin > err
    same = want.argmax(-1) == got.argmax(-1)
    over = float((diff / (LM_TOL + LM_TOL * np.abs(want))).max())
    return {"max_abs_err": err, "mean_abs_err": float(diff.mean()),
            "max_abs_logit": float(np.abs(want).max()),
            "max_err_over_lm_tol": over, "positions": int(same.size),
            "checked": int(sure.sum()), "agree_where_checked":
            int((same & sure).sum()), "agree_all": int(same.sum()),
            "by_step_max_abs_err": [float(x) for x in
                                    diff.reshape(len(diff), -1).max(-1)]}


def _tps_traces(got: dict, soft, card: str) -> dict:
    """[41] The traced decode steps (:func:`_tps_trace`) of each run, by
    rank, printed; no runtime call within a step that waits for the
    device, and a (1, T) run's copies a step no more than 1.1× its
    one-card base's where that is traced (the copies are the decode's
    casts, the same on one card: a weight copied each step would add its
    bytes; ``tests/test_torch_tp_serve.py`` finds no op that copies one)."""
    out = {}
    for tag, ranks in got.items():
        if "trace" not in ranks[0]:
            continue
        ranks = [x for x in ranks if "trace" in x]   # a "one" job's rank 0
        out[tag] = [x["trace"] for x in ranks]
        base = got.get(f"{tag.rsplit('_', 1)[0]}_one", [{}])[0].get("trace")
        for i, (x, tr) in enumerate(zip(ranks, out[tag])):
            stream_ms = x.get("weights_bytes", 0) / PEAK_HBM_BYTES * 1e3
            if base is not None and "_one" not in tag:
                soft(tr["copy_ms"] <= 1.1 * base["copy_ms"],
                     f"[41] {tag} rank {i}: copies {tr['copy_ms']:.3f} ms a "
                     f"decode step, one card's {base['copy_ms']:.3f}")
            soft(tr["sync_calls"] == 0,
                 f"[41] {tag} rank {i}: {tr['sync_calls']} runtime calls a "
                 f"decode step wait for the device")
            rng = ", ".join(f"{k} {v:.2f}" for k, v in list(
                tr["host_ms_by_range"].items())[:6])
            ops = "; ".join(f"{o['name'][:60]} {o['device_ms']:.3f} ms "
                            f"×{o['calls']:.0f}" for o in
                            tr["top_device_ops"][:4])
            print(f"[41] trace {tag} rank {i}: a decode step {tr['wall_ms']:.2f} "
                  f"ms on the host (profiled), device busy "
                  f"{tr['device_busy_ms']:.3f} ms in {tr['device_ops']:.0f} ops: "
                  f"NCCL {tr['nccl_ms']:.3f} ms, the rest {tr['compute_ms']:.3f}"
                  f" (copies {tr['copy_ms']:.3f} ms in {tr['copy_ops']:.0f} "
                  f"ops, {tr['copy_bytes']:,.0f} bytes where traced; the "
                  f"weights stream in {stream_ms:.2f} ms); "
                  f"{tr['api_calls']:.0f} runtime calls taking "
                  f"{tr['api_host_ms']:.2f} ms of the host, "
                  f"{tr['sync_calls']:g} a step waiting for the device "
                  f"(outside the steps: {tr['sync_calls_outside_steps']}); "
                  f"host ms by range: {rng}; largest device ops: {ops}; "
                  f"{card}", flush=True)
    return out


def _tps_cli(d: Path, device: str, soft, card: str) -> dict:
    """[41b] ``python -m repro_torch.launch.serve_lm`` with
    :data:`TPS_CLI` in a child process: it exits 0 and prints one report
    (rank 0's) of every request finished with finite logits on the ranks
    asked for, K2 launched on every rank once an attention layer a
    prefill (its plain version on CPU tensors)."""
    import os
    out = d / "cli.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_lm", *TPS_CLI,
           "--out", str(out)] + (["--device", "cpu"] if device == "cpu"
                                 else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=900)
    secs = time.perf_counter() - t0
    args = dict(zip(TPS_CLI[::2], TPS_CLI[1::2]))
    said = f"[41b] serve_lm {' '.join(TPS_CLI)}"
    soft(run.returncode == 0,
         f"{said}: exit {run.returncode}: {run.stderr[-1500:]}")
    if run.returncode:
        return {"rc": run.returncode}
    reports = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
    rep = json.loads(out.read_text())
    from repro_torch.configs import ARCHS
    cfg = ARCHS[args["--arch"]]
    attn = sum(1 for ld in _layer_kinds(cfg) if ld == "attn")
    t = int(args["--model-ranks"])
    want_k2 = [0 if device == "cpu" else attn * rep["prefills"]] * t
    soft(len(reports) == 1 and json.loads(reports[0]) == rep
         and rep["model_ranks"] == t
         and rep["requests"] == int(args["--requests"])
         and rep["logits_finite"] and rep["k2_launches_by_rank"] == want_k2,
         f"{said}: {len(reports)} reports, {rep}; K2 launches by rank "
         f"wanted {want_k2}")
    print(f"{said}: {rep['requests']} requests, {rep['prompt_tokens']} "
          f"prompt tokens, {rep['generated_tokens']} generated over "
          f"{rep['model_ranks']} ranks; prefill {rep['prefill_ms_mean']:.2f} "
          f"ms a prompt (mean), decode {rep['decode_ms_per_iter_median']:.2f} "
          f"ms an iteration (median of {rep['decode_iterations']}); K2 "
          f"launches by rank {rep['k2_launches_by_rank']}; {secs:.1f} s "
          f"with its start and the weights' draw; {card}", flush=True)
    return dict(rep, seconds=secs)


def phase_tp_serve_cards(n_cards: int, tmpdir: str,
                         device: str = "cuda") -> dict:
    """[41 (a)-(d)] serving over a tensor-parallel mesh on ``n_cards`` = 4
    cards: every pair's teacher-forced logits compared (:func:`_tps_run`,
    :func:`_tps_compare`), K2 ≡ its plain version on each rank's first
    prefill q, k, v (the rank's heads) with its launches counted per
    rank, jamba's 32 layers served on (1, 2) and (1, 4) with their peaks
    and times. Every part is run and printed before a failed check ends
    the phase: ``failures`` lists them. ``device="cpu"`` rehearses the
    phase on gloo ranks (with the specs cut to reduced configs by the
    caller: K2 then runs its plain version, and nothing of the card is
    read)."""
    import numpy as np
    from repro_torch.device import card_description
    d = Path(tmpdir) / "tps"
    d.mkdir()
    cpu = device == "cpu"
    rec = {"failures": [], "card": "cpu" if cpu else card_description()}

    def soft(cond: bool, msg: str) -> None:
        if not cond:
            rec["failures"].append(msg)
            print(f"FAILED: chip_smoke: {msg}", flush=True)
    if n_cards != 4 and not cpu:
        soft(False, f"[41] needs 4 cards, got {n_cards}")
        return rec
    two, four = _tps_jobs()
    t0 = time.perf_counter()
    got = _fsdp_spawn(two, 2, d / "w2", _tps_rank, device, 600)
    rec["spawn2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got.update(_fsdp_spawn(four, 4, d / "w4", _tps_rank, device, 600))
    rec["spawn4_s"] = time.perf_counter() - t0
    logits = {tag: np.load(d / ("w4" if "tp14" in tag else "w2")
                           / f"{tag}.npy") for tag in got}
    pairs = {}

    def pair(part: str, base: str, other: str, f32: bool = False,
             control: bool = False) -> dict:
        ranks = got[other]
        r = ranks[0]
        cfg = _fsdp_cfg(_tps_spec(other))
        cmp = _tps_compare(logits[base], logits[other], cfg.vocab_size)
        same_bytes = len({x["logits_sha256"] for x in ranks}) == 1
        soft(same_bytes, f"[41{part}] {other}: the ranks' logits differ")
        if f32:
            soft(cmp["max_err_over_lm_tol"] <= 1.0,
                 f"[41{part}] {other} against {base}: max|Δ| "
                 f"{cmp['max_abs_err']:.3g}, {cmp['max_err_over_lm_tol']:.3g}"
                 f"× atol {LM_TOL} + rtol {LM_TOL}·|one card|")
        noise = None
        if f"{base.rsplit('_', 1)[0]}_bump" in got:
            noise = _tps_compare(logits[base], logits[
                f"{base.rsplit('_', 1)[0]}_bump"], cfg.vocab_size)
        if not f32 and cfg.n_experts:
            within = (cmp["max_abs_err"] <= TPS_NOISE * noise["max_abs_err"]
                      and cmp["mean_abs_err"]
                      <= TPS_NOISE * noise["mean_abs_err"])
            said = (f"[41{part}] {other} against {base}: max|Δ| "
                    f"{cmp['max_abs_err']:.4g}, mean|Δ| "
                    f"{cmp['mean_abs_err']:.4g}; bound {TPS_NOISE:g}× the "
                    f"bumped base's {noise['max_abs_err']:.4g}, "
                    f"{noise['mean_abs_err']:.4g}")
            if control:
                soft(not within, f"{said}: the negative control is inside "
                     f"the bound")
            else:
                soft(within and cmp["agree_where_checked"] == cmp["checked"],
                     f"{said}; top-1 agrees at "
                     f"{cmp['agree_where_checked']} of {cmp['checked']} "
                     f"positions whose margin exceeds max|Δ|")
        elif not f32:
            soft(cmp["max_abs_err"] <= TPS_REL * cmp["max_abs_logit"]
                 and cmp["agree_where_checked"] == cmp["checked"],
                 f"[41{part}] {other} against {base}: max|Δ| "
                 f"{cmp['max_abs_err']:.4g} (bound {TPS_REL:g} of "
                 f"{cmp['max_abs_logit']:.4g}), top-1 "
                 f"agrees at {cmp['agree_where_checked']} of "
                 f"{cmp['checked']} positions whose margin exceeds it")
        k2 = [x.get("launches", {}).get("k2_flash_attention", 0)
              for x in ranks]
        attn = sum(1 for ld in _layer_kinds(cfg) if ld == "attn") \
            if not cfg.mla else 0
        # K2 runs on the card only (its plain version on CPU tensors)
        soft(all(n == (0 if cpu else attn) for n in k2),
             f"[41{part}] {other}: K2 launches by rank {k2}, not one per "
             f"attention layer ({attn}) in the one prefill")
        heads = [x.get("k2_shapes") for x in ranks]
        t = len(ranks)
        if attn:
            soft(all(h and h[0][1] == cfg.n_heads // t
                     and h[1][1] == cfg.n_kv_heads // t for h in heads),
                 f"[41{part}] {other}: K2's q, k shapes by rank {heads}")
        out = dict(cmp, bumped_base_spread=noise,
                   k2_launches_by_rank=k2, k2_shapes_by_rank=heads,
                   logits_equal_on_ranks=same_bytes,
                   prefill_ms=max(x["prefill_ms"] for x in ranks),
                   decode_ms_median=max(statistics.median(x["decode_ms"])
                                        for x in ranks),
                   base_prefill_ms=got[base][0]["prefill_ms"],
                   base_decode_ms_median=statistics.median(
                       got[base][0]["decode_ms"]),
                   peak_gb_by_card=[x.get("run_peak_bytes", 0) / 1e9
                                    for x in ranks],
                   init_peak_gb_by_card=[x.get("init_peak_bytes", 0) / 1e9
                                         for x in ranks],
                   weights_gb_by_card=[x.get("weights_bytes", 0) / 1e9
                                       for x in ranks],
                   base_peak_gb=got[base][0].get("run_peak_bytes", 0) / 1e9,
                   base_weights_gb=got[base][0].get("weights_bytes", 0)
                   / 1e9)
        pairs[other] = out
        print(f"[41{part}] {r['arch']} ({r['n_layers']} layers, "
              f"{r['n_params']:,} params, {r['dtype']}) {other} against "
              f"{base}: {out['positions']} last-position logits of 1 "
              f"prefill + {len(r['decode_ms'])} teacher-forced steps, "
              f"max|Δ| {cmp['max_abs_err']:.4g}, mean|Δ| "
              f"{cmp['mean_abs_err']:.4g} (largest |logit| "
              f"{cmp['max_abs_logit']:.4g}; by step "
              f"{[float(f'{x:.3g}') for x in cmp['by_step_max_abs_err']]}); "
              f"top-1 "
              f"agrees at {cmp['agree_where_checked']} of {cmp['checked']} "
              f"positions whose one-card margin exceeds it, "
              f"{cmp['agree_all']} of {cmp['positions']} in all"
              + ("" if noise is None else
                 f" ({base}'s own spread under one ulp on "
                 f"{TPS_BUMP_SHARE:g} of its weights: max|Δ| "
                 f"{noise['max_abs_err']:.4g}, mean|Δ| "
                 f"{noise['mean_abs_err']:.4g}, top-1 {noise['agree_all']} "
                 f"of {noise['positions']})")
              + f"; logits equal on the ranks: {same_bytes}; first "
              f"(cold) prefill "
              f"{out['prefill_ms']:.1f} ms against {out['base_prefill_ms']:.1f}"
              f", decode {out['decode_ms_median']:.2f} ms/step against "
              f"{out['base_decode_ms_median']:.2f} (median, slowest rank); "
              f"K2 launches by rank {k2}, q/k heads {[h[0][1] if h else None for h in heads]}"
              f"/{[h[1][1] if h else None for h in heads]}; weights GB by "
              f"card {[round(x, 2) for x in out['weights_gb_by_card']]}, "
              f"init peak {[round(x, 2) for x in out['init_peak_gb_by_card']]}"
              f", run peak {[round(x, 2) for x in out['peak_gb_by_card']]} "
              f"({base}: weights {out['base_weights_gb']:.2f}, peak "
              f"{out['base_peak_gb']:.2f} on its first card); {rec['card']}",
              flush=True)
        return out

    def _tps_spec(tag: str) -> dict:
        key = tag.rsplit("_", 1)[0]
        return dict(dict((("qwen3", TPS_QWEN), ("jamba16", TPS_JAMBA16),
                          ("jamba", TPS_JAMBA)) + TPS_OTHERS
                         + TPS_F32)[key])
    pair("a", "qwen3_one", "qwen3_tp12")
    pair("a", "qwen3_one", "qwen3_tp14")
    pair("b", "jamba16_one", "jamba16_tp12")
    pair("b", "jamba16_one", "jamba16_wrong", control=True)
    pair("b", "jamba_tp12", "jamba_tp14")
    for key, _ in TPS_OTHERS:
        pair("c", f"{key}_one", f"{key}_tp12")
    for key, _ in TPS_F32:
        pair("d", f"{key}_one", f"{key}_tp12", f32=True)
    for key in TPS_F32_14:
        pair("d", f"{key}_one", f"{key}_tp14", f32=True)
    rec["pairs"] = pairs
    rec["traces"] = _tps_traces(got, soft, rec["card"])
    # (b)'s serves: jamba's 32 layers, phase 7's traffic
    cfg = _fsdp_cfg(TPS_JAMBA)
    one_params = _card_params(cfg, (1, 1))
    serves = {}
    for tag in ("jamba_tp12", "jamba_tp14"):
        ranks = got[tag]
        t = len(ranks)
        s = [x["serve"] for x in ranks]
        k2 = [x["launches"]["k2_flash_attention"] for x in s]
        attn = sum(1 for ld in _layer_kinds(cfg) if ld == "attn")
        soft(all(x["requests"] == TPS_JAMBA["requests"]
                 and x["logits_finite"]
                 and x["n_free"] == TPS_JAMBA["n_pages"] for x in s),
             f"[41b] {tag} serve: {[{k: x[k] for k in ('requests', 'logits_finite', 'n_free')} for x in s]}")
        soft(all(x["streams"] == s[0]["streams"] for x in s),
             f"[41b] {tag}: the ranks' token streams differ")
        soft(all(n == (0 if cpu else attn) * x["prefills"]
                 for n, x in zip(k2, s)),
             f"[41b] {tag}: K2 launches by rank {k2}, not {attn} a "
             f"prefill")
        others = {k: v for x in s for k, v in x["launches"].items()
                  if k != "k2_flash_attention" and v}
        soft(not others, f"[41b] {tag}: other kernels launched {others}")
        peaks = [x.get("run_peak_bytes", 0) / 1e9 for x in ranks]
        inits = [x.get("init_peak_bytes", 0) / 1e9 for x in ranks]
        card = _card_params(cfg, (1, t))
        # the reckoning (PERF.md §6): a card's bf16 blocks, and
        # at init the f32 draw and bf16 cast of the largest whole leaf
        big = max(math.prod(i.shape) for i in _infos(cfg).values())
        serves[tag] = dict(
            s[0], k2_launches_by_rank=k2, peak_gb_by_card=peaks,
            init_peak_gb_by_card=inits,
            weights_gb_by_card=[x.get("weights_bytes", 0) / 1e9
                                for x in ranks],
            reckoned_weights_gb=2 * card / 1e9,
            reckoned_init_peak_gb=(2 * card + 6 * big) / 1e9,
            prefill_ms_by_card=[x["prefill_ms_mean"] for x in s],
            decode_ms_by_card=[x["decode_ms_per_iter_median"]
                               for x in s])
        soft(max(peaks + inits) < 80.0,
             f"[41b] {tag} peak GB by card {peaks}, init {inits}")
        v = serves[tag]
        print(f"[41b] serve {cfg.name} at full width, all "
              f"{cfg.n_layers} layers ({one_params:,} params, bf16) on "
              f"(1, {t}): {v['requests']} requests, "
              f"{v['prompt_tokens']} prompt tokens, "
              f"{v['generated_tokens']} generated; prefill "
              f"{v['prefill_tokens_per_s']:.0f} tokens/s (mean "
              f"{v['prefill_ms_mean']:.2f} ms per prompt, by card "
              f"{[round(x, 2) for x in v['prefill_ms_by_card']]}); time "
              f"to first token median {v['ttft_ms_median']:.2f} ms; "
              f"decode {v['decode_ms_per_iter_median']:.2f} "
              f"ms/iteration (median of {v['decode_iterations']}; by "
              f"card {[round(x, 2) for x in v['decode_ms_by_card']]}); "
              f"{v['generated_tokens_per_s']:.1f} generated tokens/s; "
              f"K2 launches by rank {k2} ({attn} a prefill); weights "
              f"GB by card {[round(x, 2) for x in v['weights_gb_by_card']]}"
              f" (reckoned {v['reckoned_weights_gb']:.2f}: 2 bytes each "
              f"of a card's {card:,} parameters), init peak "
              f"{[round(x, 2) for x in inits]} (reckoned "
              f"{v['reckoned_init_peak_gb']:.2f}: those and the largest "
              f"leaf's {big:,} elements drawn in f32 and cast to bf16), "
              f"serve peak {[round(x, 2) for x in peaks]} "
              f"(torch.cuda.max_memory_allocated); {rec['card']}",
              flush=True)
    rec["serves"] = serves
    rec["cli"] = _tps_cli(d, device, soft, rec["card"])
    # K2 on each rank's first prefill q, k, v: (a) and (b)'s pairs
    checks = {tag: [x["k2_check"] for x in got[tag]]
              for tag in got if "k2_check" in got[tag][0]}
    rec["k2_checks"] = checks
    launches: dict = {}
    for tag, ranks in got.items():
        for x in ranks:
            for src in (x.get("launches", {}),
                        x.get("serve", {}).get("launches", {})):
                for name, n in src.items():
                    launches[name] = launches.get(name, 0) + n
    rec["tp_serve_launches"] = launches
    print(f"[41] kernel launches over every run of the phase, all cards: "
          f"{launches}", flush=True)
    return rec


def _infos(cfg) -> dict:
    from repro_torch.models import build_model
    return build_model(cfg, attn_impl="sdpa", device="meta").ps.infos


def _layer_kinds(cfg) -> list:
    """The kind of every layer of a config, prefix and encoder layers
    included (an encoder-decoder's self-attention layers of both
    stacks)."""
    if cfg.encoder_layers:
        return ["attn"] * (cfg.encoder_layers + cfg.n_layers)
    pat = cfg.layer_pattern()
    n = (cfg.n_layers - cfg.first_dense_layers) // len(pat)
    return ["attn"] * cfg.first_dense_layers + [ld.kind for ld in pat] * n


# phase 38: phi-3-vision-4.2b (configs/phi_3_vision_4_2b.py,
# hf:microsoft/Phi-3-vision-128k-instruct) at full width and depth, 32
# layers of MHA over 32 heads of 96, with phase 7's traffic: text-only
# prompts, no patch embeddings (the reference's LM.prefill without them)
SERVE_PHI3 = dict(SERVE, arch="phi-3-vision-4.2b")


def phase_phi3_serve(report: dict) -> dict:
    """[38] phi-3-vision-4.2b on the card through K2 at head dim 96: (a)
    served at full width and depth with phase 7's traffic, K2 once per
    layer per prefill and no other kernel; (b) K2 ≡ its plain version on
    the q, k, v the serve's first prefill gave its first layer; (c) one
    profiled prefill and decode iteration."""
    import torch
    from repro_torch.device import card_description
    from repro_torch.kernels import flash_attention as k2
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    card = card_description()
    cfg = _serve_config(SERVE_PHI3)
    check(cfg.family == "vlm" and cfg.n_layers == 32 and cfg.d_model == 3072
          and cfg.n_heads == cfg.n_kv_heads == 32 and cfg.d_head == 96
          and cfg.param_dtype == "bfloat16", f"[38a] {cfg}")
    with _first_call(ops, "flash_attention") as seen:
        run = _init_and_serve(SERVE_PHI3, "[38a]")
    r = run["rec"]
    k2_n = r["launches"]["k2_flash_attention"]
    check(k2_n == cfg.n_layers * r["prefills"],
          f"[38a] K2 launched {k2_n} times in {r['prefills']} prefills of "
          f"{cfg.n_layers} layers")
    check(not any(v for k, v in r["launches"].items()
                  if k != "k2_flash_attention"),
          f"[38a] another kernel launched: {r['launches']}")
    _print_serve("[38a]", f"{cfg.n_layers} layers, MHA over 32 heads of 96,"
                 f" text-only prompts; K2 {k2_n} launches = "
                 f"{cfg.n_layers} x {r['prefills']} prefills", r, card)
    q, k, v = seen["args"]
    check(tuple(q.shape) == (1, 32, r["prompt_lens"][0], 96)
          and tuple(k.shape) == tuple(q.shape) and q.dtype == torch.bfloat16
          and k2.kernel_path(q.dtype, 96) == "tensor_core",
          f"[38b] K2's first inputs {tuple(q.shape)} {tuple(k.shape)}")
    rec = {"card": card, "serve": r}
    rec["k2_check"] = _k2_case("[38b]", "phi3-first-prefill", q, k, v,
                               seen["kw"].get("causal", True))
    del q, k, v, seen
    prof = rec["profiled"] = _serve_profiled(
        run["model"], run["params"], run["reqs"], SERVE_PHI3)
    _print_profiled("[38c] phi-3-vision-4.2b:", prof)
    del run
    torch.cuda.empty_cache()
    report["phi3_serve"] = rec
    return rec


def _arrays_of(ckpt_dir: str, step: int) -> dict:
    import numpy as np
    with np.load(Path(ckpt_dir) / f"step_{step:09d}" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


T_START = time.perf_counter()


def main() -> int:
    import tempfile
    import torch
    if sys.argv[1:2] == ["--cpu-worker"]:
        return _cpu_worker(sys.argv[2])
    if sys.argv[1:2] == ["--cpu-worker-envs"]:
        return _cpu_worker_envs(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--cards"]:
        only = (sys.argv[4].split(",") if sys.argv[3:4] == ["--only"]
                else CARDS_PHASES)
        return _cards_main(int(sys.argv[2]), only)
    # phase 33 (c) steps under deterministic algorithms, which need
    # deterministic cuBLAS workspaces from the first GEMM on: ":4096:8" is
    # the H100's default size anyway
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        workers = (_start_cpu_worker(tmpdir),
                   _start_cpu_worker(tmpdir, "--cpu-worker-envs"))
        try:
            return _run(workers, tmpdir)
        finally:
            for proc, _ in workers:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


# the phases of ``--cards N``; ``--only`` names some of them (37 reads
# 36's runs, so it needs 36)
CARDS_PHASES = ("35b", "36", "37", "39", "40", "41", "39f", "42")


def _cards_main(n_cards: int, only=CARDS_PHASES) -> int:
    """``--cards N``: build the kernels and run phases 35 (b), 36 (a)-(c),
    37, 39, 40, 41, 39 (f) and 42 only; with ``--only``, those of them it
    names (the kernels built only for 35 (b) and 41, the phases that
    launch them)."""
    import tempfile
    import torch
    bad = set(only) - set(CARDS_PHASES)
    if bad or ("37" in only and "36" not in only):
        print(f"chip_smoke: --only takes phases of {CARDS_PHASES} (37 with "
              f"36), not {list(only)}", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < n_cards:
        print(f"chip_smoke: --cards {n_cards} needs {n_cards} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 1
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import card_description
    from repro_torch.kernels import build
    rec: dict = {}
    if "35b" in only or "41" in only:
        t0 = time.perf_counter()
        libs = build.build_all()
        print(f"[0] built {sorted(libs)} in {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        if "35b" in only:
            t0 = time.perf_counter()
            rec = phase_ranks_cards(n_cards, tmpdir)
            print(f"[35b] phase time {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "36" in only:
            t0 = time.perf_counter()
            rec["fsdp"] = phase_fsdp_cards(n_cards, tmpdir)
            print(f"[36] (a)-(c) phase time {time.perf_counter() - t0:.1f} "
                  f"s", flush=True)
        if "37" in only:
            t0 = time.perf_counter()
            rec["tp"] = phase_tp_cards(n_cards, tmpdir, rec["fsdp"])
            print(f"[37] phase time {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "39" in only:
            t0 = time.perf_counter()
            rec["tp_families"] = phase_tp_families_cards(n_cards, tmpdir)
            print(f"[39] phase time {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "40" in only:
            t0 = time.perf_counter()
            rec["tp_moe"] = phase_tp_moe_cards(n_cards, tmpdir)
            print(f"[40] phase time {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "41" in only:
            t0 = time.perf_counter()
            rec["tp_serve"] = phase_tp_serve_cards(n_cards, tmpdir)
            print(f"[41] phase time {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "39f" in only:
            t0 = time.perf_counter()
            rec["tp_families_f32"] = phase_tp_families_f32(n_cards, tmpdir)
            print(f"[39f] phase time {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if "42" in only:
            t0 = time.perf_counter()
            rec["dp_moe"] = phase_dp_moe_cards(n_cards, tmpdir)
            print(f"[42] phase time {time.perf_counter() - t0:.1f} s",
                  flush=True)
    rec["device"] = torch.cuda.get_device_name(0)
    rec["phases"] = list(only)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_cards.json").write_text(json.dumps(rec, indent=1))
    for key, phase in (("fsdp", "36"), ("tp", "37"),
                       ("tp_families", "39"), ("tp_moe", "40"),
                       ("tp_serve", "41"), ("tp_families_f32", "39f"),
                       ("dp_moe", "42")):
        if key in rec:
            check(not rec[key]["failures"],
                  f"[{phase}] {len(rec[key]['failures'])} check(s) "
                  f"failed: {rec[key]['failures']}")
    # no kernel launches on the tensor-parallel path (37 (d)): each
    # kernel's count over 37 (b)'s steps, summed over the cards
    if "tp" in rec:
        print(json.dumps({"tp_launches": [
            {"name": k, "tp_launches": v}
            for k, v in sorted(rec["tp"]["tp_launches"].items())]}),
            flush=True)
    # nor on the encoder-decoder's and the SSM's (39 (d)): each kernel's
    # count over every run of the phase, summed over the cards
    if "tp_families" in rec:
        print(json.dumps({"tp_families_launches": [
            {"name": k, "tp_families_launches": v} for k, v in sorted(
                rec["tp_families"]["tp_families_launches"].items())]}),
            flush=True)
    # nor on MLA's and the expert FFN's (40 (d)), likewise
    if "tp_moe" in rec:
        print(json.dumps({"tp_moe_launches": [
            {"name": k, "tp_moe_launches": v} for k, v in sorted(
                rec["tp_moe"]["tp_moe_launches"].items())]}), flush=True)
    # nor on MoE routing over the data axis (42 (d)), likewise
    if "dp_moe" in rec:
        print(json.dumps({"dp_moe_launches": [
            {"name": k, "dp_moe_launches": v} for k, v in sorted(
                rec["dp_moe"]["dp_moe_launches"].items())]}), flush=True)
    # K2 on the tensor-parallel serving path (41): its launches in each
    # run, by rank, and its check against the plain version on each rank's
    # first-prefill q, k, v (the rank's heads)
    if "tp_serve" in rec:
        ts = rec["tp_serve"]
        fields = ("shape", "dtype", "path", "max_abs_err", "ms", "plain_ms",
                  "bound_ms", "bound_by", "library_ms")
        print(json.dumps({"tp_serve_kernels": [{
            "name": "k2_flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:84",
            "launches_by_rank": {
                **{t: p["k2_launches_by_rank"]
                   for t, p in ts["pairs"].items()},
                **{f"{t}_serve": v["k2_launches_by_rank"]
                   for t, v in ts["serves"].items()}},
            "max_abs_err": max(c["max_abs_err"] for cs in
                               ts["k2_checks"].values() for c in cs),
            "checks": {t: [{f: c[f] for f in fields} for c in cs]
                       for t, cs in ts["k2_checks"].items()}}]}),
            flush=True)
    for line in rec.get("cards", []):
        print(line, flush=True)
    print(card_description(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _run(workers, tmpdir: str) -> int:
    import torch
    from repro_torch.device import card_description
    from repro_torch.kernels import build

    card = card_description()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc}", flush=True)
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "nvcc": nvcc}

    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.launch import kernel_variants
    with ThreadPoolExecutor(1) as pool:     # both builds' nvcc at once
        firsts = pool.submit(build.build_all, list(kernel_variants.FIRST),
                             kernel_variants._DIR)
        libs = build.build_all()
        firsts = firsts.result()
    report["build_s"] = time.perf_counter() - t0
    print(f"[0] built {sorted(libs)} and the first designs "
          f"{sorted(firsts)} in {report['build_s']:.1f} s", flush=True)
    report["build_logs"] = dict(build.BUILD_LOGS)
    for name in ("collision_force", "block_cols", "pairlist", "pair_cols",
                 "secretion"):
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}", flush=True)
    report["k2_templates"] = k2_templates(
        build.BUILD_LOGS.get("flash_attention", ""))

    seconds = report["phase_s"] = {"0": report["build_s"]}

    def timed(label: str, fn, *args):
        """Run one phase and print its seconds."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t
        print(f"[{label}] phase time {seconds[label]:.1f} s", flush=True)
        return out

    for n in K1_SIZES:
        timed(f"1 ({n})", phase_kernel_vs_plain, n, report)
    timed("2", phase_engine_cpu_parity, PARITY_AGENTS, report)
    timed("3", phase_main_path, MAIN_AGENTS, MAIN_STEPS, report)
    timed("4", phase_births, report)
    k2_recs = timed("5", phase_k2_vs_plain, report)
    timed("6", phase_lm_cpu_parity, report)
    serve_rec = timed("7", phase_serve, report)
    timed("8", phase_k1_static, report)
    timed("9", phase_scenarios_cpu_parity, SCENARIO_AGENTS, report)
    sir_rec, cm_big, big = timed("10", phase_sir_main_path, MAIN_AGENTS,
                                 MAIN_STEPS, report)
    timed("11", phase_streamed_vs_k1, MAIN_AGENTS, report)
    pl_rec = timed("12", phase_pairlist_build, MAIN_AGENTS, report)
    pm_rec = timed("13", phase_pairs_map, MAIN_AGENTS, report)
    main_b = timed("14", phase_pairlist_main_path, MAIN_AGENTS, MAIN_STEPS,
                   report, sir_rec)["b"]
    sec = timed("15", phase_secretion, report)
    cpu = timed("wait for the CPU worker of 16-18", _cpu_results,
                workers[0])
    timed("16", phase_growth, report, cpu)
    timed("17", phase_supervised_cli, report, cpu, tmpdir)
    timed("18", phase_narrowed_k1, report, cpu)
    timed("19", phase_fig11, report)
    timed("20", phase_fig9, report)
    cpu_envs = timed("wait for the CPU worker of 21", _cpu_results,
                     workers[1])
    timed("21", phase_env_scenarios, report, cpu_envs)
    timed("22", phase_k1_slot_order, report)
    lanes_rec = timed("23", phase_lanes_vs_solo, report)
    timed("24", phase_ensemble_throughput, report)
    timed("25", phase_service_cli, report, tmpdir)
    tissue = timed("26", phase_tissue_lanes, report, tmpdir)
    timed("27", phase_ensemble_envs, report, tmpdir)
    dist = timed("28", phase_distributed, report, tmpdir)
    training = timed("29", phase_training, report, tmpdir)
    moe = timed("30", phase_moe_serve, report)
    ssm = timed("31", phase_ssm_serve, report)
    encdec = timed("32", phase_encdec, report)
    families = timed("33", phase_family_training, report, cpu)
    measured = {"qwen2-1.5b": training["full_width"]["ms_per_step_median"],
                **{arch: families[arch]["ms_per_step_median"]
                   for arch in ("mamba2-370m", "deepseek-v2-lite-16b")}}
    dry = timed("34", phase_dryrun_vs_card, report, measured)
    ranks = timed("35", phase_ranks_one_card, report, tmpdir)
    fsdp = timed("36", phase_fsdp_one_rank, report, tmpdir)
    phi3 = timed("38", phase_phi3_serve, report)
    report["total_s"] = time.perf_counter() - T_START
    print(f"phases took {sum(seconds.values()):.1f} s, the script "
          f"{report['total_s']:.1f} s", flush=True)

    # K1 and the column map: the main path's launches beside their check
    # and times on that path's first-step inputs (phase 10)
    kernels = [{
        "name": "k1_collision_force", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/collision_force.cu",
        "replaces": "src/repro/kernels/collision_force.py:118",
        "launches": sir_rec["launches"]["k1_collision_force"],
        "max_abs_err": big["max_abs_err"],
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None,
        "ensemble_launches_per_tick":
            lanes_rec["k1"]["launches_per_tick"]["k1_collision_force"]}, {
        "name": "k1_column_map", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_cols.cu",
        "replaces": "src/repro/kernels/ops.py:22",
        "launches": sir_rec["launches"]["k1_column_map"],
        "max_abs_err": 0.0,
        "ms": cm_big["ms"], "plain_ms": cm_big["plain_ms"],
        "bound_ms": cm_big["bound_ms"], "bound_by": cm_big["bound_by"],
        "library_ms": None,
        "ensemble_launches_per_tick":
            lanes_rec["k1"]["launches_per_tick"]["k1_column_map"]}, {
        "name": "k2_flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "launches": serve_rec["launches"]["k2_flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in k2_recs),
        "ms": k2_recs[0]["ms"], "plain_ms": k2_recs[0]["plain_ms"],
        "bound_ms": k2_recs[0]["bound_ms"],
        "bound_by": k2_recs[0]["bound_by"],
        "library_ms": k2_recs[0]["library_ms"]}]
    # this slice's kernels: launches from phase 14 (b) and the clustering
    # run of phase 15, times from phases 12, 13 and 15 (at the clustering
    # run's shape)
    for name, src, ref, count, rec in (
            ("pairlist_build", "pairlist.cu", "src/repro/core/grid.py:602",
             main_b["launches"]["pairlist_build"], pl_rec),
            ("k1_pair_cols", "pair_cols.cu", "src/repro/kernels/ops.py:98",
             main_b["launches"]["k1_pair_cols"], pm_rec),
            ("secretion", "secretion.cu",
             "src/repro/core/diffusion.py:68",
             sec["clustering"]["launches"]["secretion"], sec["kernel"][0])):
        per_tick = (tissue["fig6_pairs"]["launches_per_tick"]
                    if name != "secretion"
                    else tissue["clustering"]["launches_per_tick"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": ref, "launches": count,
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            **{k: rec[k] for k in ("previous_design_ms",) if k in rec},
            "ensemble_launches_per_tick": per_tick[name]})
    # the distributed path (phase 28): launches over its runs, all shards
    # stepped together — K1 and its map in (a)'s K1 run, the pair-list
    # kernels in (d)'s list run, secretion in (c); K2 is not on it
    dist_runs = {"k1_collision_force": dist["weak"]["k1"],
                 "k1_column_map": dist["weak"]["k1"],
                 "k2_flash_attention": dist["weak"]["k1"],
                 "pairlist_build": dist["pairlist"],
                 "k1_pair_cols": dist["pairlist"],
                 "secretion": dist["diffusion"]}
    # and each kernel ≡ its plain version on the inputs a distributed step
    # gave it: K1 and its map at 4 x 205,376 rows (a), K1 again on the
    # pairs map (d), the list build (d), secretion into 4 grids (c)
    wk, pk = dist["weak"]["k1"]["kernel_checks"], dist["pairlist"][
        "kernel_checks"]
    dist_checks = {"k1_collision_force": {"28a": wk["k1"], "28d": pk["k1"]},
                   "k1_column_map": {"28a": wk["map"]},
                   "pairlist_build": {"28d": pk["pairlist_build"]},
                   "k1_pair_cols": {"28d": pk["map"]},
                   "secretion": {"28c": dist["diffusion"]["kernel_check"]}}
    for k in kernels:
        run = dist_runs[k["name"]]
        k["distributed_launches"] = run["launches"][k["name"]]
        k["distributed_steps"] = run["steps"]
        checks = dist_checks.get(k["name"], {})
        k["distributed_checks"] = {where: {f: rec[f] for f in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for where, rec in checks.items()}
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            rec["max_abs_err"] for rec in checks.values()])
    # the training path (phase 29) runs no kernel: K2 has no backward
    for k in kernels:
        k["training_launches"] = training["launches"][k["name"]]
    # the MoE + MLA serving path (phase 30 (a)) runs no kernel: MLA
    # attention is the plain _sdpa in both packages
    for k in kernels:
        k["moe_serving_launches"] = moe["serve"]["launches"][k["name"]]
    # the SSM serve (phase 31 (a)) runs no kernel; the hybrid's (b) runs K2
    # once per attention layer per prefill, held against its plain version
    # on the inputs of the serve's first prefill
    for k in kernels:
        k["mamba2_serving_launches"] = ssm["mamba2"]["launches"][k["name"]]
        k["jamba_serving_launches"] = ssm["jamba"]["launches"][k["name"]]
        if k["name"] == "k2_flash_attention":
            k["jamba_check"] = {f: ssm["k2_check"][f] for f in (
                "shape", "dtype", "path", "max_abs_err",
                "max_err_over_scaled_tol", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by")}
            k["max_abs_err"] = max(k["max_abs_err"],
                                   ssm["k2_check"]["max_abs_err"])
    # the encoder-decoder serve (phase 32 (a)) runs K2 once per encoder
    # and decoder layer per prefill, held against its plain version on
    # the inputs of the serve's first prefill at both shapes
    for k in kernels:
        k["seamless_serving_launches"] = \
            encdec["serve"]["launches"][k["name"]]
        if k["name"] == "k2_flash_attention":
            k["seamless_check"] = {part: {f: rec[f] for f in (
                "shape", "causal", "dtype", "path", "max_abs_err",
                "max_err_over_scaled_tol", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by")}
                for part, rec in encdec["k2_checks"].items()}
            k["max_abs_err"] = max([k["max_abs_err"]] + [
                rec["max_abs_err"] for rec in encdec["k2_checks"].values()])
    # training the MoE, MLA, SSM and hybrid configs (phase 33) runs no
    # kernel either
    for k in kernels:
        k["family_training_launches"] = families["launches"][k["name"]]
    # nor does holding the dry run against the card (phase 34)
    for k in kernels:
        k["dryrun_check_launches"] = dry["launches"][k["name"]]
    # the distributed engine on one NCCL rank (phase 35 (a)): counted in
    # the rank's process over its steps
    for k in kernels:
        k["ranks_launches"] = ranks["launches"].get(k["name"], 0)
        k["ranks_steps"] = ranks["steps"]
    # the sharded training on one NCCL rank (phase 36) runs no kernel
    # either: counted in the rank over its sharded steps
    for k in kernels:
        k["fsdp_launches"] = fsdp["launches"][k["name"]]
    # the phi-3-vision serve (phase 38 (a)) runs K2 at head dim 96 once per
    # layer per prefill, held against its plain version on the inputs of
    # the serve's first prefill
    for k in kernels:
        k["phi3_serving_launches"] = phi3["serve"]["launches"][k["name"]]
        if k["name"] == "k2_flash_attention":
            k["phi3_check"] = {f: phi3["k2_check"][f] for f in (
                "shape", "dtype", "path", "max_abs_err",
                "max_err_over_scaled_tol", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by")}
            k["max_abs_err"] = max(k["max_abs_err"],
                                   phi3["k2_check"]["max_abs_err"])
    # K2's two redesigned kernels as entries of their own (one wrapper and
    # counter, k2_flash_attention): bf16 at D 96 with the launches of the
    # phi-3-vision serve (38 (a), all at D 96) and the times on its own
    # first-prefill q, k, v (38 (b)); f32 (the scalar kernel) with the
    # launches of phase 6's f32 LM and the times of phase 5's f32 case at
    # qwen2's heads, phi-3-vision's f32 case beside it
    by_case = {r["case"]: r for r in k2_recs}
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms", "first_design_ms")
    d96 = [r for r in k2_recs if r["shape"][5] == 96
           and r["dtype"] == "bfloat16"] + [phi3["k2_check"]]
    f32 = [r for r in k2_recs if r["dtype"] == "float32"]
    kernels += [{
        "name": "k2_flash_attention_d96", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "counter": "k2_flash_attention",
        "launches": phi3["serve"]["launches"]["k2_flash_attention"],
        **{f: phi3["k2_check"][f] for f in fields},
        "max_abs_err": max(r["max_abs_err"] for r in d96),
        "cases": {r["case"]: {f: r[f] for f in ("shape",) + fields}
                  for r in d96}}, {
        "name": "k2_flash_attention_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "counter": "k2_flash_attention",
        "launches": report["lm_gpu_vs_cpu"]["launches"][
            "k2_flash_attention"],
        **{f: by_case["f32-ragged"][f] for f in fields},
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "cases": {r["case"]: {f: r[f] for f in ("shape",) + fields}
                  for r in f32}}]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_description(), flush=True)      # as nvidia-smi prints it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
