#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --segment-repeats N  # phase 6a's times, N times
    python3 chip_smoke.py --sweep-profile  # kernels 1/1m/1l/1lm's shapes alone
    python3 chip_smoke.py --ssd-profile  # kernel 5 at the two models' shapes
    python3 chip_smoke.py --ooc-phase  # phase 3o alone
    python3 chip_smoke.py --contracts-phase  # phase 3c alone
    python3 chip_smoke.py --train-phase  # phase 9 alone
    python3 chip_smoke.py --mesh-phase  # phase 10 alone

Phases (any failed check exits non-zero; nothing is caught and passed over):

1. Device: the card's name and power limit, torch/CUDA versions, and the
   build of the kernels from csrc/ (block_sweep.cu, segment_combine.cu,
   flash_attention.cu, ssd_scan.cu, one nvcc each, in parallel; seconds,
   ptxas report).
2. Kernels vs plain version: the kernel on the card and ``block_sweep_ref``
   on CPU copies of the same inputs, for the hub block plus 64 seeded random
   blocks, as one slate at depth 1 and as one-slot chains at depth 8.
   Min/max programs must agree bitwise; the sum program bitwise or within
   rtol=1e-6 (the bitwise share is printed).
   a. Kernel 1 (unmasked) on the full-size graphs of phase 3.
   b. Kernel 1m (masked) on the same graphs with S = 8 sub-blocks and
      seeded random sub_act patterns.
   c. Kernels 1 and 1m on a mutated layout: a StreamingEngine's tiles after
      one synthetic_stream batch of 10,000 edits with deletes. The engine
      runs CC (symmetric), so every delete rebuilds its blocks' runs in
      bucket order; the batch must rebuild at least one block. The
      PageRank, SSSP and CC arithmetic all run over these tiles. It runs
      on powerlaw_graph(n = 2^18): the engine bootstraps with a cold run,
      and a CC run at n = 2^21 would not fit the time limit beside phases
      3-4.
   d. Kernels 1l and 1lm (the lane sweep of query serving) at L = 8 lanes
      on the phase-3 graphs: the k_sssp and k_bfs arithmetic on the SSSP
      graph, held against the plain version on the card (min is exact in
      any order),
      and the k_ppr arithmetic on the PageRank graph, held against the
      plain version on CPU copies (its sum order is the CPU's index_add_).
      1lm runs over S = 8 coverage with seeded (P, S, L) psd and two lanes
      done. Both are held as one slate and as one-slot chains of
      LANE_CHAIN passes (cut from 8 to 4 for the time limit when phase 3t
      came). A one-lane k_sssp sweep must equal kernel 1's sssp sweep
      bitwise. Then the lane shapes of the serving path, from a generator
      of their own (LANE_SEED): for k_sssp on the SSSP graph and k_ppr on
      the PageRank graph at L = 8, a one-slot pass of the hub block and a
      WIDTH-slot cold slate through 1l, and through 1lm with a 1/S-live
      mask (the tiles it needs printed): CUDA events and the device time by
      kernel.
   e. Kernels 1 and 1m at the main path's shapes on both graphs, from a
      generator of its own (SWEEP_SEED): the tiles' statistics (runs per
      tile, the longest run per tile and the share of slots in runs longer
      than 32, partials per destination; over all tiles and the hub
      block's; for a 1/S-live mask the tiles needed), then kernel 1's time
      and device time by kernel (torch.profiler) on a one-slot pass of the
      hub block and on a cold slate of WIDTH blocks, and on the SSSP graph
      the full cold sweeps of kernel 1 and of 1m all live and 1/S live
      beside the library yardstick (no plain version).
   Then the times of one full cold sweep of every block of the PageRank
   graph (kernel, plain
   version on the card, and a library yardstick that the port never calls)
   beside the least time the card could take for it: kernel 1, kernel 1m
   with every sub-block live and with about 1/S live, kernel 1 on the
   mutated layout of 2c against the same engine's build-time layout
   (timed before the batch), and kernels 1l/1lm at L = 8 (k_sssp on the
   SSSP graph, 1lm with every sub-block live and about 1/S live). The
   bound counts w, aux and vconst only for the programs that read them.
3. The main path at n = 2^21 vertices, avg_deg 16 (~33.5M edges):
   PageRank on core_periphery_graph(seed=1, chords=1) and SSSP on a
   weighted powerlaw_graph, each through StructureAwareEngine.run() and
   BaselineEngine.run() with block_size=512 (P=4096), width=128, t2=1e-9
   (PageRank: scaled to 1/n, see T2_PAGERANK).
   SSSP fixpoints must be bitwise equal, PageRank must agree at rtol=1e-4,
   atol=2e-3/n, and the sweep kernel must have launched on the main path.
   Then each SA engine runs WINDOW supersteps from the start WINDOWS times
   by the host clock and PROFILED_WINDOWS times under torch.profiler: wall
   and device busy time per superstep (median and spread), sweep calls per
   superstep, and the device time by kernel.
3t. The traced main path, on phase 3's engines, its launches counted apart
   from phase 3's: the PageRank SA run again, whole, with trace=True under
   an installed repro_torch.obs recorder, bitwise equal to phase 3's
   untraced run (values, iterations, counters, host syncs, launches), its
   timeline one row per superstep summing to the counters, its export
   valid Chrome-trace JSON that ``python -m repro_torch.obs render`` reads;
   the traced and untraced wall per superstep. The SSSP SA run capped at
   TRACE_CAP supersteps, traced and not, bitwise, and the host loop at
   TRACE_HOST_CAP, whose integer columns equal the fused rows. A recorded
   S = 8 SSSP stream on weighted powerlaw_graph(2^17, seed=TRACE_SEED), two
   200-edit batches with deletes, then a QueryService batch of LANES SSSP
   queries on it: the spans nest as ingest > reconverge > run > chunk,
   ingest and query_batch carry their runs' supersteps, kernels 1m and 1lm
   launch, the answers equal Bellman-Ford's. Betweenness from BC_SOURCES on
   powerlaw_graph(2^17, seed=TRACE_SEED + 1) through both engines, bitwise.
3c. The contract checker on phase 3's engines (``--contracts-phase``: this
   phase alone, after phase 3's graphs and engines; ~20 s):
   a. ``python -m repro_torch.analysis --check`` on the card in a
      subprocess, started first and run beside (b): the lint over
      src/repro_torch, the contracts enforced on the card (the device
      select against its host twin, a tiny engine and lane engine run
      twice through kernels 1 and 1l), the golden op file (recorded on the
      CPU, so skipped here). It must exit 0; its findings line, the number
      of contracts and the golden status are printed.
   b. One ``_get_chunk`` call, from a cold run's first boundary over the
      run's first chunk, of phase 3's PageRank engine (kernel 1), of the
      same engine traced (trace cap 16), of phase 3's SSSP engine
      (kernel 1), of an L = LANES k_sssp lane batch on the SSSP engine
      (kernel 1l), and of an S = 8 SSSP engine on weighted
      powerlaw_graph(CONTRACT_N, seed=2) and a lane batch on it (kernels
      1m and 1lm; sources from CONTRACT_SEED), each under
      torch.cuda.set_sync_debug_mode("error"): no call may synchronize,
      each must launch its kernel, and every tensor of its state must
      equal, bitwise, a twin call from the same start without the mode.
3o. The out-of-core tier and epoch persistence (``--ooc-phase``: this
   phase alone, after phase 3's PageRank graph, engine and run), its
   launches counted apart from phase 3's, its draws from its own seed
   (OOC_SEED).
   a. Phase 3's PageRank engine rebuilt with ``from_plan`` on phase 3's
      plan, values, aux and coupling under resident_blocks = P / 4 = 1024
      of 4096 blocks (payloads in a host cache), and run through run()
      capped at OOC_CAP = 400 of its 3368 supersteps (whole, it took
      79.1 s, 3.9x the resident run, and the phase would pass ~90 s; at
      1000 the script took 1017 s on a slow host, at 600 1069 s; None runs
      it whole against phase 3's run): values and every
      counter but the spill tier's bitwise a resident run at the same cap,
      the budget held and evictions made.
      Paged chunks are one superstep each, so host syncs and kernel 1
      launches differ (a resident chunk also enqueues its supersteps past
      convergence, as no-ops); it prints the wall and its slowdown against
      phase 3's, the host syncs, evictions, MB spilled and fetched and the
      prefetch hit rate beside the card's name and power limit. Then the
      host loop under the budget at TRACE_HOST_CAP supersteps, bitwise the
      resident host loop; then a budget run at OOC_TRACE_CAP supersteps
      traced under a recorder: its rows those of the resident traced run
      and summing to its counters, its ``spill_evict`` and ``prefetch``
      spans (cat ooc) present, the prefetch bytes summing to
      bytes_fetched. Then the disk tier: a second engine under the same
      budget with npz segments in a temporary directory (no host cache, no
      row source: every fetch reads its blocks back from disk), capped at
      OOC_DISK_CAP supersteps (the tier pages ~5 ms a block), bitwise a
      resident run at that cap; its writer closed before the directory
      goes.
   b. An S = 8 SSSP StreamingEngine on weighted powerlaw_graph(2^17,
      seed=OOC_SEED) (P = 256) under the floor budget width + 2 = 130
      with npz segments in a temporary directory (no host cache; the
      stream's host tile mirror is the store's row source, so its segments
      are written and never read; the batches' latencies include those
      writes), beside a resident twin: the bootstrap and two 200-edit
      batches with 20% deletes bitwise the twin's (values and report
      columns), kernel 1m launched. Then 8 SSSP queries (QueryService(max_lanes=8)) pinned
      while blocks are spilled, a third batch ingested, the answers
      bitwise Bellman-Ford's on the pinned graph through kernel 1lm. Then
      save_epoch, restore(verify=False) bitwise, and restore(verify=True)
      under the budget: bitwise the live values in fewer than half the
      cold bootstrap's supersteps (both counts printed).
4. Streaming with hierarchical partitions: a StreamingEngine (S = 8,
   StreamConfig() defaults) over PageRank on core_periphery_graph(seed=1,
   chords=1) at n = 2^19 (PR_STREAM_N, cut from phase 3's 2^21 for the
   time limit, last from 2^20 when phases 8f-8i came: a run took 1134 s
   on a slow host; t2 scaled to its 1/n), bootstrapped by a
   cold run, then two synthetic_stream batches (10 edits, 200 edits with
   deletes; a third, of 200 edits without deletes, went for the time
   limit). After each batch the warm values must agree with
   BaselineEngine on the mutated graph (rtol=1e-4, atol=2e-3/n). Then
   SSSP with deletes (three batches of 200 edits) on a
   weighted powerlaw_graph, bitwise equal to the baseline after each
   batch; it runs at n = 2^19 (SSSP_STREAM_N): its cold bootstrap at
   n = 2^21 alone takes about as long as phase 3's SSSP run. Each batch
   prints its iterations, dirty fractions, upload fraction, bytes and
   latency, and the launches of kernels 1 and 1m; the masked kernel must
   have launched.
5. Query serving through the lane kernels (QueryService, LaneEngine). In
   each phase the first wave of queries is submitted, one synthetic_stream
   batch of 200 edits with 20% deletes is ingested while they pend, and
   run_pending() must answer every query on its pinned (pre-ingest) epoch;
   every lane must converge.
   a. Kernel 1l: the reference demo's configuration (a PageRank
      StreamingEngine, S = 1, block 512, t2 = 1e-8) at the smoke's width
      128 on a weighted powerlaw_graph(seed=2) at n = 2^19 (SERVE_N, cut
      from phase 3's 2^21 for the time limit, last from 2^20 with phase
      4's stream), served by
      QueryService(max_lanes=8): 8 PPR queries (seeded 2-vertex reset
      sets), held within rtol=1e-3, atol=1e-6 of a power iteration on the
      card over the unmutated graph. The demo's SSSP queries run in 5b:
      an SSSP lane batch at n = 2^21 takes ~9,400 supersteps (200-260 s
      on the card), more than the time limit leaves.
   b. Kernel 1lm: QueryService(max_lanes=8) over phase 4's SSSP stream
      (n = 2^19, S = 8, after its batches): an SSSP batch on the pinned
      epoch, then an SSSP wave on the epoch after the ingest, each bitwise
      equal to Bellman-Ford on the card over its epoch's graph (float path
      sums are order-fixed, so the fixpoint is unique). Its BFS batch
      moved to 5c: on this stream it takes 11,194 supersteps (~124 s).
   c. Kernel 1lm on BFS lanes: QueryService(max_lanes=8) over a new SSSP
      stream (S = 8) on weighted powerlaw_graph(2^17) (BFS_STREAM_N, cut
      from 5b's 2^19 for the time limit; 1,776 supersteps, ~31 s, at
      2^18): 8 BFS queries
      pinned across an ingest, bitwise equal to Bellman-Ford with unit
      weights on the card over the pinned epoch's graph.
   Each batch prints its family, lanes, supersteps (batch and per lane),
   run and wait seconds, host syncs, lane-kernel launches and counters;
   each phase its pin's host copy time, snapshots_preserved,
   stale_answers and queries/s. The lane kernels must have launched.
6. The distributed engine (DistributedEngine over the group-padded
   storage) at block_size 4096 (DIST_BLOCK, the repo's own block for this
   engine at pod scale: at 512 the PageRank graph's hot group alone would
   take ~99 GB of padding).
   a. Kernels 2 and 3 (segmented min/max and sum) called as the block
      processor calls them: on a row's valid prefix (its true edges),
      through the group's layout of those prefixes (every row sorted by
      destination: short rows one launch, the hub row the long path). The
      rows' runs per destination and paths first, from the layouts. On the
      hot group's hub row and 16 seeded random rows of each storage group
      of the PageRank graph, with the PageRank (sum), SSSP (min) and CC
      (max) arithmetic on mid-run states: bit for bit against the plain
      version on CPU copies; then a synthetic unsorted row of 2^20 slots
      (many short runs: the long path) the same way. Then the times of one
      call on the hub row and of one pass over every cold row (kernel by
      CUDA events, the cold pass as the median of 7 passes timed one by
      one, with their least and greatest, and beside it the mean of 3
      passes back to back; plain version on the card, for the cold pass
      the sum's alone; library yardstick, timed as the kernel) beside both
      bounds (a sorted row's bytes: msg, the destination offsets and the
      output; and 8 B per slot with dst read), and for the cold pass the
      host enqueue time of its calls, the wrappers' own Python, and the
      device time by kernel (torch.profiler; for the hub row too).
   b. Runs through DistributedEngine.run() on an NCCL process group of one
      rank on cuda:0 (FileStore): PageRank on core_periphery_graph(2^20,
      seed=1, chords=1) (width 128, t2 scaled to its 1/n as T2_PAGERANK
      is), within rtol=1e-4, atol=2e-3/n of BaselineEngine on the same
      graph; SSSP on weighted powerlaw_graph(2^20) and CC on
      powerlaw_graph(2^18), bitwise equal to BaselineEngine on the same
      graph (each cut from phase 3's 2^21 for the time limit). Before its
      run, each engine's storage goes through 6a's check for its combine
      on its hub row and seeded rows. Each run prints supersteps, wall seconds, host syncs,
      combine-kernel launches, counters and the padded storage bytes on
      the card; each run's combine kernel must have launched.
8. LM serving, after phase 6 (whose engines and caches are freed first).
   Each model phase draws from its own seed, so it shifts no earlier
   phase's draws.
   a. Kernel 4 (csrc/flash_attention.cu: bf16 on the tensor cores, f32 on
      the CUDA cores) against its plain version on the card, the plain
      version's f32 matmuls without TF32: seeded q, k, v at the four dense
      archs' head shapes (llama3p2_1b, yi_6b, qwen3_14b, mistral_nemo_12b),
      B = 2, S in (128, 2048), causal and full, f32 at 2e-5 and bf16 at
      2e-2. Then bf16 calls at three prefill shapes (B = 4, S = 2048,
      causal), on q, k, v drawn as the model's (B, S, H, D) projections and
      transposed to (B, H, S, D) views, which the bf16 route reads in place:
      llama3p2_1b's heads (32/8 x 64), yi_6b's (32/4 x 128) and
      hymba_1p5b's (25/5 x 64), each held against the plain version at
      2e-2, then timed beside scaled_dot_product_attention
      as the library yardstick (timed only, never on the path) and the
      bound (the larger of the flops at the bf16 rate and the bytes), with
      TFLOP/s; the plain version timed at llama3p2_1b's shape, and the f32
      route once there beside scaled_dot_product_attention on the same f32
      inputs. Then hymba_1p5b's heads (an odd GQA group) at the
      same S, masks and tolerances, from a generator of their own; then,
      from another, the new families' heads the same way: phi3_vision_4p2b's
      32/32 x 96 (the D = 96 instantiation of both routes),
      granite_moe_3b_a800m's 24/8 x 64 and deepseek_moe_16b's 16/16 x 128
      at S in (128, 2048), whisper_base's 8/8 x 64 at its prompt, S = 384;
      and the bf16 route at phi3's prefill shape (4 x 32 x 2048 x 96, 1024
      patches and 1024 text tokens) on transposed views, held at 2e-2 and
      timed beside SDPA, the plain version and the bound, the f32 route
      once there beside SDPA on the same f32 inputs.
   b. llama3p2_1b at its published width and depth (16 layers, d = 2048,
      1.24B parameters) from the port's init_params on the card, every
      layer's wo redrawn as seeded normals (the reference's init leaves it
      at zero, and attention would then not reach the logits), served
      through repro_torch.launch.serve.generate with --use-kernel: batch
      4, prompts of 2048 tokens, then 16 greedy decode steps. Its
      parameter count must equal the reference tree's (counted from the
      config: ArchConfig.param_count() is analytic and misses the SSM's
      vectors). Kernel 4 must launch once per layer in the prefill. The
      same masters with f32 activations: the prefill's logits within 1e-4
      of the plain route's (chunked attention) and each decode step's of
      its position in one plain forward over the prompt and the fed
      tokens; the bf16 run no less accurate against f32 than the plain
      bf16 routes (at 16 layers two bf16 sum orders already differ by more
      than 5e-2). It prints the prefill and decode times, tokens per
      second, the peak memory, and a torch.profiler breakdown of one
      prefill and four decode steps.
   c. Kernel 5 (csrc/ssd_scan.cu) against its plain version on the card,
      TF32 off: the heads form at mamba2_2p7b's and hymba_1p5b's prefill
      shapes ((cells, Q, N, H, P) = (32, 256, 128, 80, 64) and (32, 256,
      16, 25, 64)), with ld drawn as the model draws it (dt = softplus of
      a normal plus the dt bias, A in [1, 16]) so that exp(l_q - l_s)
      overflows above the diagonal (checked), f32 at rtol=1e-5,
      atol=1e-4 * max|y| and bf16 at 2e-2; then the reference test's three
      shapes in f32. Then timed in f32 at both models' shapes (CUDA
      events over 20 calls, and torch.profiler's device time; the same
      readings alone: --ssd-profile), beside the bound (the larger of the
      bytes and the causal flops at the TF32 rate, the Gram c.b counted
      once per cell since the heads share c and b; the f32 CUDA-core floor
      is printed beside it, and the TF32 flops the kernel executes: three
      per f32 product, the Gram once per head group), and the plain
      version at mamba2's shape. No single
      PyTorch call computes the function, so there is no library time.
   d. mamba2_2p7b at its published width (d = 2560, 80 SSM heads of 64,
      N = 128) and SERVE_LAYERS of its 64 layers, served and
      checked as 8b, after 8b's model is freed: kernel 5 must launch once
      per layer in the prefill, kernel 4 never. The forward that the
      decode steps are held against takes the largest SSD chunk that
      divides its 2064 tokens (the chunked algorithm is the same function
      at any chunk). The profile prints kernel 5's share of the prefill.
   e. hymba_1p5b at its published width (d = 1600, 25/5 attention heads
      and 25 SSM heads of 64, N = 16; wo redrawn) and SERVE_LAYERS of its
      32 layers: kernels 4 and 5 in every layer, each
      launched once per layer in the prefill; checked and profiled as 8d.
   f. granite_moe_3b_a800m at its published width (d = 1536, 24/8 heads
      of 64, 40 experts top-8 of width 512; wo redrawn) and SERVE_LAYERS
      of its 32 layers, served as 8b (prompts of 2048
      tokens at capacity factor 1.25: 512 rows per expert and group):
      kernel 4 once per layer in the prefill. One prefill and one decode
      step run under torch.cuda.set_sync_debug_mode("error"): the MoE path
      makes no host sync. The f32 checks record each run's top-k experts
      per layer (models.moe.route wrapped: RouteLog), print the rows that
      route differently (a near tie of the k-th and (k+1)-th probability
      flips under a 1e-5 change, and in a prefill moves other tokens'
      capacity slots), fail if more than one of the four rows does, and
      hold the others at 1e-4: the kernel route against the plain route at
      1.25; the decode steps against a forward at capacity factor E / k,
      where nothing drops (a forward over 2064 tokens has another capacity
      than the prefill and the decode steps), on a served run at the same
      factor. The bf16 checks hold the rms within 1.25x of the plain
      route's and print the largest error. The profile prints the MoE
      layers' device time and their routing, dispatch and combine's share
      (profiler ranges around models.moe's functions).
   g. deepseek_moe_16b at its published width (16/16 heads of 128, 64
      routed experts top-6 and 2 shared, width 1408) and 4 of its 28
      layers (full depth holds 67.5 GB of f32 masters), checked as 8f.
   h. phi3_vision_4p2b at its published width (d = 3072, 32/32 heads of
      96) and SERVE_LAYERS of its 32 layers: 1024 seeded
      patch embeddings ahead of 1024 text tokens (S = 2048), kernel 4 at
      D = 96 once per layer; checked as 8b.
   i. whisper_base at its published width and depth (6 + 6 layers,
      d = 512, 8/8 heads of 64, 111,165,440 parameters; every wo, the
      encoder's and the cross-attention's too, redrawn): 1500 seeded frame
      embeddings (30 s of audio) through the encoder, a 384-token decoder
      prompt; kernel 4 once per decoder layer (the encoder and the
      cross-attention take the plain routes, as the reference's); checked
      as 8b.
9. LM training (``--train-phase``: this phase alone), after phase 8, its
   draws from its own seed (TRAIN_SEED). The training path runs none of
   the eight kernels (the reference never differentiates through a Pallas
   kernel): their counts are set to 0 before it and must read 0 after.
   a. llama3p2_1b at its published width and depth (16 layers, d = 2048,
      1,237,387,264 parameters; every wo redrawn as in phase 8), f32
      masters, bf16 activations, remat_policy "full", B = 4 x S = 2048
      from the port's SyntheticLM, AdamW at launch/train.py's defaults:
      TRAIN_STEPS steps (repro_torch.train.step.make_train_step), every
      loss and grad norm finite; it prints the step time (median and
      spread after the first), tokens per second, peak memory and 6 N
      tokens / step time against the card's dense bf16 peak, beside the
      card's name and power limit. Before them, on copies of the same
      masters and batch, one step with f32 activations: the bf16 step's
      loss within 1% and grad norm within 5% of it (PERF.md §6).
   b. micro=2 against (a)'s first step (micro=1) on a copy of the same
      masters and batch: ce within rtol 1e-4, grad norm within 1e-3.
   c. llama3p2_1b at its published width, depth cut to TRAIN_REMAT_LAYERS
      (the 16-layer model does not fit under "none"): one forward and
      backward under each remat policy, the gradients bitwise equal
      across the four, the peak memory above the step's start printed and
      ordered none >= save_all_dots >= save_dots >= full; then one train
      step under each on copies of one state, the new state bitwise equal.
   d. ``python -m repro_torch.launch.train`` at the example's size
      (``--reduced --scale 4``) with ``--ckpt-dir`` and ``--fail-at`` in a
      subprocess: it exits 42; the next run (in this process, main())
      resumes from its checkpoint, and its losses equal, bitwise, those of
      an uninterrupted run.
   e. granite_moe_3b_a800m at its published width, depth cut to
      TRAIN_MOE_LAYERS: TRAIN_MOE_STEPS steps with the aux losses, then
      ExpertRebalancer(num_shards=4) fed their expert loads, its
      permutation applied to the params and to m/v; the next step's loss
      within 1e-5 of an unpermuted twin's (not bitwise: the combine adds a
      token's experts in ascending id, which the relabel reorders).
   f. ``ef_compress_psum`` on an NCCL group of one: the output equals the
      dequantised input and the residual what quantization lost, bitwise.
10. The device mesh and the sharding rules (``--mesh-phase``: this phase
   alone), after phase 9, its draws from its own seed (MESH_SEED; 10a's
   batches are phase 9a's, TRAIN_SEED). An NCCL group of one and
   ``make_host_mesh(model=1)``, a (1, 1) mesh: every placement is trivial,
   so the sharded program (DTensor parameters, moments, batches and
   caches, launch/sharding.py) must give the unsharded program's bits.
   The sharded program takes the plain routes (none of the eight kernels):
   kernels 4 and 5's counts are set to 0 before it and must read 0 after.
   a. llama3p2_1b at its published width and depth (every wo redrawn),
      laid out by ``state_specs``, remat "full", 4 x 2048: MESH_STEPS
      train steps beside an unsharded twin's on copies of the same
      masters and batches, in this process; every loss and grad norm
      bitwise the twin's, and the new states bitwise equal. Both step
      times are printed (the gap is DTensor's host overhead), beside the
      card's name and power limit.
   b. The same trained model served: a 4 x 2048 prefill and MESH_DECODE
      decode steps through ``param_specs``, ``cache_sharding`` and
      ``logits_spec`` with ``shard_attn`` and ``cast_weights_once`` on,
      against the twin's plain tensors with both off: logits and tokens
      bitwise equal; prefill and decode step times of both printed.
   c. llama3p2_1b at its published width, depth cut to MESH_CKPT_LAYERS
      (10a's 16-layer state took 25.3 s to save and 32.8 s to restore
      through the npz files on the H100's host), laid out by
      ``state_specs``,
      one step, then saved (gathered, ``interop.train_state_to_arrays``)
      and restored onto the mesh (``restore(shardings=checkpoint_specs(
      state_specs(...)))``): bitwise the saved state, and one more step on
      each bitwise equal (loss, grad norm, new state).
   d. ``python -m repro_torch.launch.dryrun --arch llama3p2_1b --mesh
      single --graph`` in a subprocess (the fake group needs a process of
      its own; fake CUDA tensors, the card's route), started beside the
      set-up (beside 10a with ``--mesh-phase``) and awaited here (it
      launches nothing on the card), then the roofline
      (``launch.roofline.main``, in this process): its rows printed,
      projections under the H100 data sheet's rates.
7. One JSON line of kernel rows, the card line, and the final ok line.

It needs the repository's src/ beside it, and a CUDA card: without either it
exits non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import gc
import io
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N = 1 << 21
AVG_DEG = 16
BLOCK = 512
WIDTH = 128
T2 = 1e-9
# PageRank's PSD is in value units, which shrink as 1/n: the quickstart's
# t2 (at n = 20000) scaled to 1/n, like its atol. At t2 = 1e-9 the slow
# core ring keeps a residual over the rtol in the reference engine too.
T2_PAGERANK = T2 * 20000 / N
SA_CAP = 20000  # superstep cap: keeps the script inside its time limit
BASE_CAP = 2000  # baseline iteration cap
SUB = 8  # sub-blocks per block on the masked paths
MUTATE_N = 1 << 18  # the mutated-layout check's graph (phase 2c)
MUTATE_EDITS = 10000
PR_STREAM_N = 1 << 19  # phase 4's PageRank stream
SSSP_STREAM_N = 1 << 19  # phase 4's SSSP stream
SERVE_N = 1 << 19  # phase 5a's PPR stream
BFS_STREAM_N = 1 << 17  # phase 5c's stream
STREAM_CAP = 8000  # superstep cap of one streaming run
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
LANES = 8  # query lanes per batch (phase 2d and the serving phases)
LANE_CHAIN = 4  # phase 2d's one-slot chains: passes (cut from 8 for 3t)
SERVE_T2 = 1e-8  # the reference demo's (examples/graph_service.py)
SERVE_CAP = 20000  # superstep cap of one lane batch
SOURCES = ("block_sweep", "segment_combine", "flash_attention",
           "ssd_scan")  # csrc/*.cu
DIST_BLOCK = 4096  # the distributed engine's block (launch/dryrun.py)
DIST_N = 1 << 20  # phase 6b's PageRank and SSSP graphs
DIST_CC_N = 1 << 18  # phase 6b's CC graph (symmetrized: twice the edges)
DIST_ROWS = 16  # phase 6a's seeded rows per storage group
SEG_UNSORTED_E = 1 << 20  # phase 6a's synthetic unsorted row
COLD_PASSES = 7  # phase 6a: cold passes timed, kernel and library each
SEED = 0
SWEEP_SEED = 90  # phase 2e's own generator: its draws shift no earlier one's
LANE_SEED = 91  # phase 2d's lane shapes: their own generator, likewise
WINDOW = 100  # phase 3's windows: supersteps from the start of a run
WINDOWS = 3  # windows timed
PROFILED_WINDOWS = 1  # windows profiled (cut from 3 for the time limit)
TRACE_CAP = 300  # phase 3t: the SSSP run's superstep cap, traced and not
TRACE_HOST_CAP = 40  # phase 3t: the host loop's cap beside it
TRACE_SEED = 120  # phase 3t's graphs and query sources: their own seed
BC_SOURCES = [0, 3]  # phase 3t: betweenness's sources
CONTRACT_SEED = 140  # phase 3c's lane sources: their own seed
CONTRACT_N = 1 << 17  # phase 3c's S = 8 engine (5c's size)
CONTRACT_TIMEOUT = 300  # phase 3c: the checker subprocess's limit, in s
OOC_SEED = 130  # phase 3o's graph, batches and query sources: its own seed
OOC_CAP = 400  # phase 3o: the budget run's superstep cap (None: whole run;
# whole, it took 79.1 s, 3.94x the resident run; at 1000, 24.6 s; at 600,
# 16.9 s)
OOC_TRACE_CAP = 100  # phase 3o: the traced budget run's cap
OOC_DISK_CAP = 20  # phase 3o: the disk-tier run's cap (on the H100's host
# it pages ~5 ms a block)
DEV = "cuda"
BF16_FLOPS_PER_S = 989.4e12  # H100 SXM data sheet, dense bf16
TF32_FLOPS_PER_S = 495e12  # the same, dense TF32
F32_FLOPS_PER_S = 67e12  # the same, f32 outside the tensor cores
# phase 8a: the dense decoders, whose head shapes kernel 4 is held at
LM_DENSE = ("llama3p2_1b", "yi_6b", "qwen3_14b", "mistral_nemo_12b")
LM_ARCH = "llama3p2_1b"  # phase 8b's model, at its published size
LM_BATCH = 4
LM_PROMPT = 2048
LM_GEN = 17  # the prefill's token, then 16 greedy decode steps
LM_SEED = 8  # phase 8's own seed: its draws shift no earlier phase's
LM_TOL = 5e-2  # the reference's bf16 logits bar (tests/test_models.py)
LM_TOL32 = 1e-4  # the f32 bar of the port's model tests
SSM_ARCH = "mamba2_2p7b"  # phase 8d's model, at its published width
HYBRID_ARCH = "hymba_1p5b"  # phase 8e's model, at its published width
SSD_SEED = 30  # phase 8c's own seed
SSM_SEED = 40  # phase 8d's (and + 1)
HYBRID_SEED = 50  # phase 8e's (and + 1)
# phases 8f-8i: the moe, vlm and audio families
MOE_ARCH = "granite_moe_3b_a800m"  # phase 8f's, at its published width
SHARED_MOE_ARCH = "deepseek_moe_16b"  # phase 8g's, at its published width
SHARED_MOE_LAYERS = 4  # 8g's depth, cut from 28 (67.5 GB of f32 masters)
SERVE_LAYERS = 4  # 8d, 8e, 8f and 8h's depth, cut for the time limit when
# phase 10 came (from 64, 32, 32 and 32: every layer runs the same checks)
VLM_ARCH = "phi3_vision_4p2b"  # phase 8h's, at its published width
VLM_TEXT = 1024  # 8h's text tokens, behind its 1024 patch embeddings
AUDIO_ARCH = "whisper_base"  # phase 8i's, at its published size
AUDIO_FRAMES = 1500  # 8i's frames: 30 s of audio at 50 encoder positions/s
AUDIO_PROMPT = 384  # 8i's decoder prompt (+ 16 steps within 448 positions)
MOE_SEED = 60  # phase 8f's (and + 1)
SHARED_MOE_SEED = 70  # phase 8g's (and + 1)
VLM_SEED = 80  # phase 8h's (and + 1)
AUDIO_SEED = 110  # phase 8i's (and + 1)
TRAIN_ARCH = "llama3p2_1b"  # phase 9a's model, at its published size
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_STEPS = 4  # cut from 6 for the time limit when phase 10 came
TRAIN_SEED = 150  # phase 9's own seed
TRAIN_REMAT_LAYERS = 2  # 9c's depth, cut from 16: "none" keeps every tile
TRAIN_MOE_LAYERS = 4  # 9e's depth, cut from granite's 32
TRAIN_MOE_STEPS = 3
TRAIN_LOSS_BAR, TRAIN_NORM_BAR = 1e-2, 5e-2  # 9a: bf16 against f32
MESH_SEED = 160  # phase 10's own seed
MESH_STEPS = 2  # 10a's steps on each side
MESH_DECODE = 4  # 10b's decode steps
MESH_CKPT_LAYERS = 2  # 10c's depth, cut from 16 for the phase's budget
DRYRUN_TIMEOUT = 300  # 10d: the dry run's subprocess limit, in s
DENSE_BF16_FLOPS = 989.4e12  # H100 SXM data sheet, dense bf16


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs, after one
    warm-up run (unless ``warmup`` is off: the plain versions, seconds
    long, run once), by CUDA events."""
    import torch
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_passes(fn, passes: int) -> list:
    """Milliseconds of ``fn`` on the card in each of ``passes`` runs, each
    timed alone by CUDA events from an idle card, after one warm-up run: a
    loop of host-bound calls is timed by the host, whose stalls (a garbage
    collection, another tenant) land in single runs."""
    import torch
    fn()
    times = []
    for _ in range(passes):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def mid_run_state(name, n_pad, rng):
    """A value vector with every kind of entry a sweep meets mid-run."""
    import numpy as np
    if name == "pagerank":
        return rng.uniform(0.0, 2.0 / n_pad, n_pad).astype(np.float32)
    return np.where(rng.random(n_pad) < 0.4, np.float32(1e18),
                    rng.uniform(0.0, 30.0, n_pad)).astype(np.float32)


def w_bytes(program) -> int:
    """The bytes of an edge's weight that ``program``'s edge_map reads:
    4 for the weighted shortest paths (sssp, k_sssp), 0 for the families
    that ignore the weight."""
    return 4 if program.name in ("sssp", "k_sssp") else 0


def sweep(program, n_total, ed, values, rows, ok, psd, dmax, sc, *, floor,
          plain=False, **kw):
    """One pass of kernel 1 (floor None) or 1m, or of their plain version."""
    from repro_torch.kernels import block_sweep as kb
    if plain:
        kb.block_sweep_ref(program, n_total, ed, values, rows, ok, psd, dmax,
                           sc, floor=floor, **kw)
    elif floor is None:
        kb.block_sweep(program, n_total, ed, values, rows, ok, psd, dmax, sc,
                       **kw)
    else:
        kb.masked_block_sweep(program, n_total, ed, values, rows, ok, psd,
                              dmax, sc, floor=floor, **kw)


def check_against_plain(label, program, ed, c, n_live, n_total, values,
                        rng, floor=None, psd0=None):
    """Phase 2: the kernel on the card against the plain version on CPU
    copies of the same inputs, for the hub block plus 64 seeded random
    blocks, as one slate at depth 1 and as one-slot chains at depth 8.
    Returns the largest absolute difference of the new values."""
    import numpy as np
    import torch
    from repro_torch.kernels import block_sweep as kb
    tile_cnt = ed.tile_cnt.cpu().numpy()
    P = tile_cnt.size
    nsub = 1 if floor is None else int(ed.cov.shape[1])
    if psd0 is None:
        psd0 = np.zeros((P, nsub), np.float32)
    hub = int(np.argmax(tile_cnt))
    others = rng.choice(np.setdiff1d(np.arange(P), [hub]), size=64,
                        replace=False)
    blocks = np.concatenate([[hub], others]).astype(np.int32)
    ed_cpu = type(ed)(*(t.cpu() for t in ed))
    sc = {DEV: kb.make_scratch(ed, c), "cpu": kb.make_scratch(ed_cpu, c)}
    eds = {DEV: ed, "cpu": ed_cpu}
    args = dict(block_size=c, n_live=n_live, floor=floor)
    worst = 0.0
    same = total = 0

    def compare(what, g, h):
        nonlocal worst, same, total
        for a, b, part in zip(g, h, ("values", "psd", "dmax")):
            a = a.cpu().numpy()
            b = b.numpy()
            if part == "values":
                worst = max(worst, float(np.max(np.abs(a - b))))
                same += int((a == b).sum())
                total += a.size
            if program.combine == "sum":
                if not np.allclose(a, b, rtol=1e-6, atol=0):
                    fail(f"{label} {what}: kernel {part} off plain by more "
                         "than rtol=1e-6")
            elif not np.array_equal(a, b):
                fail(f"{label} {what}: kernel {part} not bitwise plain")

    def fresh(dev):
        return (torch.from_numpy(values.copy()).to(dev),
                torch.from_numpy(psd0.copy()).to(dev),
                torch.zeros(P, nsub, device=dev))

    out = {}
    for dev in (DEV, "cpu"):  # depth 1: one slate
        v, p, d = fresh(dev)
        sweep(program, n_total, eds[dev], v,
              torch.from_numpy(blocks).to(dev),
              torch.ones(blocks.size, dtype=torch.bool, device=dev), p, d,
              sc[dev], plain=dev == "cpu", **args)
        out[dev] = (v, p, d)
    torch.cuda.synchronize()
    compare("depth 1", out[DEV], out["cpu"])
    for dev in (DEV, "cpu"):  # depth 8: one-slot chains
        v, p, d = fresh(dev)
        k = torch.ones(1, dtype=torch.bool, device=dev)
        for b in blocks:
            r = torch.tensor([b], dtype=torch.int32, device=dev)
            for i in range(8):
                sweep(program, n_total, eds[dev], v, r, k, p, d, sc[dev],
                      plain=dev == "cpu", first=i == 0, last=i == 7, **args)
        out[dev] = (v, p, d)
    torch.cuda.synchronize()
    compare("depth 8", out[DEV], out["cpu"])
    log(f"[kernel] {label}: kernel vs plain on hub block {hub} "
        f"({int(tile_cnt[hub])} tiles) + 64 blocks, depth 1 and 8: bitwise "
        f"share {same}/{total}, max_abs_err {worst!r}")
    return worst


def time_full_sweep(label, program, ed, c, n_live, n_total, values0,
                    floor=None, psd0=None, plain=True):
    """Phase 2 timings: one cold sweep of every block from one snapshot,
    by the kernel, the plain version on the card (unless ``plain`` is off)
    and a library yardstick, beside the least time the card could take for
    the same work."""
    import numpy as np
    import torch
    from repro_torch.kernels import block_sweep as kb
    P = ed.tile_cnt.numel()
    masked = floor is not None
    nsub = int(ed.cov.shape[1]) if masked else 1
    v0 = torch.as_tensor(values0).to(DEV)
    values = v0.clone()
    out = torch.empty_like(values)
    p0 = torch.as_tensor(psd0 if masked else np.zeros((P, 1), np.float32))
    p0 = p0.to(DEV)
    psd = p0.clone()
    dmax = torch.zeros(P, nsub, device=DEV)
    rows = torch.arange(P, dtype=torch.int32, device=DEV)
    ok = torch.ones(P, dtype=torch.bool, device=DEV)
    sc = kb.make_scratch(ed, c)
    args = dict(block_size=c, n_live=n_live, floor=floor)
    if masked:
        # the masked sweep is in place and rewrites its psd: each run
        # starts from the same values and mask (two copies of 16 MB and
        # 128 KB, a few microseconds)
        def run(plain=False):
            values.copy_(v0)
            psd.copy_(p0)
            sweep(program, n_total, ed, values, rows, ok, psd, dmax, sc,
                  plain=plain, **args)
    else:
        def run(plain=False):
            sweep(program, n_total, ed, values, rows, ok, psd, dmax, sc,
                  plain=plain, out=out, **args)
    ms = cuda_ms(run, 20)
    plain_ms = cuda_ms(lambda: run(plain=True), 1, warmup=False) \
        if plain else None
    # the work this mask needs: tiles that feed an active sub-range, and
    # the vertices of the active sub-ranges
    valid = ed.valid
    if masked:
        act = (p0 >= floor)  # (P, S)
        block_of_tile = torch.repeat_interleave(
            torch.arange(P, device=DEV), ed.tile_cnt.long())
        keep_tile = (ed.cov & act[block_of_tile]).any(dim=1)
        valid = valid & keep_tile[:, None]
        sub = c // nsub
        vert_act = act.repeat_interleave(sub, dim=1).reshape(-1)
    else:
        vert_act = torch.ones(P * c, dtype=torch.bool, device=DEV)
    m = int(valid.sum())
    n_pad = values.numel()
    n_out = int(vert_act.sum())
    # each input read once, each output written once: the needed tile slots
    # (4 B src + 1 B valid + 4 B destination, and 4 B w where the program's
    # edge_map reads it), values in, aux in where edge_map reads it, the
    # active values out, psd and dmax out
    aux_bytes = n_total * 4 if program.aux_fn is not None else 0
    nbytes = (m * (9 + w_bytes(program)) + n_pad * 4 + aux_bytes + n_out * 4
              + P * nsub * 8)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # library yardstick (timed here only): gather + map + scatter-reduce
    # over the edges the mask needs
    flat = valid.view(-1)
    idx = torch.nonzero(flat).view(-1)
    src = ed.src.view(-1)[idx].long()
    block_of_tile = torch.repeat_interleave(
        torch.arange(P, device=DEV), ed.tile_cnt.long())
    dst = (block_of_tile[:, None] * c + ed.dstl.long()).view(-1)[idx]
    w = ed.w.view(-1)[idx]
    reduce = {"sum": "sum", "min": "amin", "max": "amax"}[program.combine]
    ident = float(program.identity)

    def library():
        msg = program.edge_map(values.index_select(0, src),
                               ed.aux.index_select(0, src), w)
        agg = torch.full_like(values, ident).scatter_reduce_(
            0, dst, msg, reduce=reduce)
        return program.apply(values, agg, n_total)

    library_ms = cuda_ms(library, 20)
    log(f"[kernel] {label}: full cold sweep of {P} blocks, {m} needed "
        f"edges, {int(ed.tile_cnt.sum())} tiles, {n_out} active vertex "
        f"slots: kernel {ms!r} ms, plain "
        f"{'not timed' if plain_ms is None else repr(plain_ms) + ' ms'}, "
        f"library {library_ms!r} ms, bound {bound_ms!r} ms ({nbytes} B at "
        f"{HBM_BYTES_PER_S:.3g} B/s)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms)


def sweep_row_stats(label, ed, c, hub, live=None):
    """Phase 2e: what the sweep's tiles hold, from the tiles themselves
    (any kernel's metadata aside). A destination's run in a tile is its
    valid slots there; each run is one partial of its destination. Over
    all tiles and over the hub block's: runs per tile, the longest run per
    tile and the share of slots in runs longer than 32, and the partials
    per destination (largest, and the distribution). With ``live`` ((P,
    S) bool, a masked slate's sub-ranges), the tiles the masked sweep
    needs (coverage meets a live sub-range) against every tile."""
    import torch
    P = ed.tile_cnt.numel()
    cnt = ed.tile_cnt.long()
    every, block_of_tile = slate_tiles(ed, torch.arange(P, device=DEV))
    first = int(ed.tile_start[hub])
    for what, t0, t1 in (("all tiles", 0, ed.valid.shape[0]),
                         (f"hub block {hub}", first,
                          first + int(cnt[hub]))):
        valid = ed.valid[t0:t1]
        tile, slot = torch.nonzero(valid, as_tuple=True)
        dst = block_of_tile[t0:t1][tile] * c + ed.dstl[t0:t1][tile, slot]
        key = (tile.long() + t0) * (P * c) + dst
        runs, length = torch.unique_consecutive(torch.sort(key).values,
                                                return_counts=True)
        run_tile = runs // (P * c) - t0
        longest = torch.zeros(t1 - t0, dtype=torch.long, device=DEV)
        longest.scatter_reduce_(0, run_tile, length, reduce="amax")
        per_tile = torch.bincount(run_tile, minlength=t1 - t0)
        parts = torch.unique(runs % (P * c), return_counts=True)[1]
        q = torch.quantile(parts.double(), torch.tensor(
            [0.5, 0.9, 0.99, 0.999], dtype=torch.double, device=DEV))
        log(f"[kernel] {label} tile statistics, {what} ({t1 - t0} tiles, "
            f"{int(length.sum())} valid slots, {runs.numel()} runs): runs "
            f"per tile median {float(per_tile.double().median())} max "
            f"{int(per_tile.max())}; longest run per tile median "
            f"{float(longest.double().median())} max {int(longest.max())}, "
            f"tiles whose longest run is 512: "
            f"{int((longest == 512).sum())}; share of slots in runs "
            f"longer than 32: "
            f"{float(length[length > 32].sum()) / float(length.sum())!r}; "
            f"partials per destination ({parts.numel()} destinations): max "
            f"{int(parts.max())}, quantiles 0.5/0.9/0.99/0.999 "
            f"{[float(x) for x in q]}, destinations of more than 64/256/"
            f"1024/4096 partials "
            f"{[int((parts > t).sum()) for t in (64, 256, 1024, 4096)]}")
    if live is not None:
        live = torch.as_tensor(live).to(DEV)
        need = needed_tiles(ed, every, live[block_of_tile])
        log(f"[kernel] {label} masked slate of every block, "
            f"{float(live.double().mean())!r} of the sub-ranges live: "
            f"{int(need.sum())} tiles needed of {need.numel()} (a masked "
            f"sweep tests every tile's coverage), "
            f"{int(ed.valid[need].sum())} needed slots")


def slate_tiles(ed, rows):
    """The tiles of blocks ``rows`` (a long tensor on the card) in slate
    order, and the index in ``rows`` of each one's block."""
    import torch
    cnt = ed.tile_cnt[rows].long()
    slot = torch.repeat_interleave(torch.arange(rows.numel(), device=DEV),
                                   cnt)
    first = torch.cumsum(cnt, 0) - cnt
    tiles = ed.tile_start[rows].long()[slot] + (
        torch.arange(int(cnt.sum()), device=DEV) - first[slot])
    return tiles, slot


def needed_tiles(ed, tiles, live):
    """Which of ``tiles`` a masked sweep needs: the tile's coverage meets a
    live sub-range of its block (``live``: (len(tiles), S) bool)."""
    return (ed.cov[tiles] & live).any(dim=1)


def hub_and_slate(sa, rng):
    """The block of ``sa``'s graph with the most tiles, and WIDTH other
    blocks drawn from ``rng`` (sorted): the one-slot pass and the cold slate
    that the shape timings take."""
    import numpy as np
    P = sa.plan.num_blocks
    hub = int(np.argmax(sa.plan.unified.tile_cnt))
    slate = sorted(int(b) for b in rng.choice(
        np.setdiff1d(np.arange(P), [hub]), WIDTH, replace=False))
    return hub, slate


def time_shapes(label, ed, hub, slate, call, live=None):
    """Phases 2d and 2e: a kernel at the shapes its path launches, a
    one-slot pass of the hub block (a hot slot's pass) and the cold slate
    ``slate``; ``call(rows, ok)`` gives the function that makes one call
    (rows and ok on the card). CUDA events over 20 calls, the device time by
    kernel of three calls, and with ``live`` ((P, S) bool on the card: the
    mask of a masked form) the tiles that the mask needs. Returns
    {"hub": ms, "slate": ms}."""
    import torch
    out = {}
    for what, rows in (("hub", [hub]), ("slate", slate)):
        r = torch.tensor(rows, dtype=torch.int32, device=DEV)
        run = call(r, torch.ones(r.numel(), dtype=torch.bool, device=DEV))
        ms = cuda_ms(run, 20)
        tiles, slot = slate_tiles(ed, r.long())
        need = ""
        if live is not None:
            keep = needed_tiles(ed, tiles, live[r.long()][slot])
            need = (f", {int(keep.sum())} tiles needed "
                    f"({int(ed.valid[tiles[keep]].sum())} slots)")
        # three calls: a window's first kernel is sometimes missing from
        # the profiler's key_averages()
        prof = profile_kernels(lambda: [run() for _ in range(3)])
        shape = ("one-slot pass of hub block" if what == "hub"
                 else f"{len(rows)}-slot cold slate")
        log(f"[kernel] {label}, {shape} ({tiles.numel()} tiles, "
            f"{int(ed.valid[tiles].sum())} slots{need}): {ms!r} ms; device "
            f"time by kernel (torch.profiler, three calls): "
            f"{describe_profile(prof)}")
        out[what] = ms
    return out


def time_sweep_shapes(label, program, ed, c, n_live, n_total, values0, hub,
                      slate):
    """Phase 2e: kernel 1 at the shapes the main path launches
    (``time_shapes``), each call into a second buffer so that every run
    reads the same values."""
    import torch
    from repro_torch.kernels import block_sweep as kb
    P = ed.tile_cnt.numel()
    values = torch.as_tensor(values0).to(DEV)
    out = torch.empty_like(values)
    psd = torch.zeros(P, 1, device=DEV)
    dmax = torch.zeros(P, 1, device=DEV)
    sc = kb.make_scratch(ed, c)

    def call(r, ok):
        return lambda: kb.block_sweep(program, n_total, ed, values, r, ok,
                                      psd, dmax, sc, block_size=c,
                                      n_live=n_live, out=out)

    return time_shapes(f"{label} kernel 1", ed, hub, slate, call)


def sweep_shapes_phase(engines, times, srng, pagerank_full=False):
    """Phase 2e: kernels 1 and 1m on both graphs at the main path's shapes,
    with the statistics that explain their times (``sweep_row_stats``,
    ``time_sweep_shapes``); on the SSSP graph (and on the PageRank graph
    with ``pagerank_full``) the full cold sweeps of kernel 1 and of 1m all
    live and about 1/S live, with the library yardstick and no plain
    version. Its draws come from ``srng`` alone."""
    import numpy as np
    for name, (sa, _) in engines.items():
        c, n_live, n_total = BLOCK, sa.plan.n_live, sa.plan.graph.n
        P = sa.plan.num_blocks
        floor = np.float32(sa._psd_floor())
        hub, slate = hub_and_slate(sa, srng)
        psd8 = sub_mask_psd(srng, P, SUB, floor, 1.0 / SUB)
        ed8 = masked_tiles(sa, SUB)
        sweep_row_stats(name, ed8, c, hub, live=psd8 >= floor)
        times[("1 shapes", name)] = time_sweep_shapes(
            name, sa.program, sa.edge_state, c, n_live, n_total, sa.values0,
            hub, slate)
        if name == "sssp" or pagerank_full:
            key = "full" if name == "pagerank" else name
            times[key] = time_full_sweep(
                f"{name} kernel 1", sa.program, sa.edge_state, c, n_live,
                n_total, sa.values0, plain=False)
            for frac, psd0 in ((1.0, sub_mask_psd(srng, P, SUB, floor, 1.0)),
                               (1.0 / SUB, psd8)):
                times[(key, frac)] = time_full_sweep(
                    f"{name} kernel 1m S={SUB}, live fraction {frac!r}",
                    sa.program, ed8, c, n_live, n_total, sa.values0,
                    floor=floor, psd0=psd0, plain=False)
        del ed8


def superstep_windows(label, eng):
    """Phase 3: WINDOW supersteps from the start of ``eng``'s run, WINDOWS
    times by the host clock (ending in a synchronize) and PROFILED_WINDOWS
    times under torch.profiler: wall and device busy time per superstep (median
    and spread), sweep calls per superstep, and the device time by kernel
    of the last profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    walls, busy, prof_walls = [], [], []
    steps = calls = 0
    kernels = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(max_iterations=WINDOW)
        torch.cuda.synchronize()
        steps = res.metrics.iterations
        walls.append((time.perf_counter() - t0) * 1e3 / steps)
    for _ in range(PROFILED_WINDOWS):
        zero_counts()
        torch.cuda.synchronize()
        # the card's activity alone: a window is ~30,000 kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run(max_iterations=WINDOW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        calls = sum(launch_counts())
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and e.self_device_time_total > 0]
        kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
        busy.append(sum(e.self_device_time_total for e in kernels)
                    / 1e3 / steps)
        prof_walls.append(wall * 1e3 / steps)

    def spread(xs):
        xs = sorted(xs)
        return f"median {xs[len(xs) // 2]!r} [{xs[0]!r}, {xs[-1]!r}]"

    log(f"[run] {label} window of {steps} supersteps from the start, "
        f"{WINDOWS} times timed, {PROFILED_WINDOWS} profiled: wall ms per "
        f"superstep {spread(walls)}; "
        f"profiled: device busy ms per superstep {spread(busy)}, wall ms "
        f"per superstep {spread(prof_walls)} (inflated by the profiler); "
        f"{calls / steps!r} sweep calls per superstep")
    log(f"[run] {label} window device time by kernel (last profiled "
        f"window): " + "; ".join(
            f"{e.key[:50]} {e.self_device_time_total / 1e3:.3f} ms "
            f"{e.count}x" for e in kernels[:8]))
    return dict(wall=walls, busy=busy, steps=steps, calls=calls)


def masked_tiles(eng, nsub):
    """The engine's build-time tiles with S = ``nsub`` sub-block coverage
    (the masked kernel's view of an S = 1 engine's graph)."""
    import torch
    from repro_torch.core.engine import tile_coverage
    u = eng.plan.unified
    cov = tile_coverage(u.dst_local, u.valid, nsub, eng.plan.block_size)
    return eng.edge_state._replace(cov=torch.as_tensor(cov).to(DEV))


def sub_mask_psd(rng, P, nsub, floor, live_frac):
    """A (P, S) psd whose entries clear the floor with ``live_frac``."""
    import numpy as np
    return np.where(rng.random((P, nsub)) < live_frac, np.float32(1.0),
                    np.float32(floor) / 2).astype(np.float32)


def lane_sweep(program, n_total, ed, values, vconst, rows, ok, psd, dmax,
               lane_done, sc, *, floor, plain=False, **kw):
    """One pass of kernel 1l (floor None) or 1lm, or of their plain
    version."""
    from repro_torch.kernels import block_sweep as kb
    args = (program, n_total, ed, values, vconst, rows, ok, psd, dmax,
            lane_done, sc)
    if plain:
        kb.lane_block_sweep_ref(*args, floor=floor, **kw)
    elif floor is None:
        kb.lane_block_sweep(*args, **kw)
    else:
        kb.masked_lane_block_sweep(*args, floor=floor, **kw)


def lane_state(program, n_pad, rng):
    """(values, vconst) of LANES lanes with every kind of entry a lane sweep
    meets mid-run: distances and unreached vertices, or personalized ranks
    with sparse restart vectors."""
    import numpy as np
    if program.uses_vconst:
        v = rng.uniform(0.0, 2e-6, (n_pad, LANES)).astype(np.float32)
        vc = np.where(rng.random((n_pad, LANES)) < 1e-5,
                      rng.uniform(0.0, 1.0, (n_pad, LANES)), 0.0)
        return v, vc.astype(np.float32)
    v = np.where(rng.random((n_pad, LANES)) < 0.4, np.float32(1e18),
                 rng.uniform(0.0, 30.0, (n_pad, LANES))).astype(np.float32)
    return v, np.zeros_like(v)


def check_lanes_against_plain(label, program, ed, c, n_live, n_total,
                              values, vconst, rng, plain_dev, floor=None,
                              psd0=None, lane_done=None):
    """Phase 2d: the lane kernel on the card against its plain version on
    ``plain_dev`` (the card for min arithmetic, exact in any order; CPU
    copies for sums, whose plain order is the CPU's index_add_), for the
    hub block plus 64 seeded random blocks, as one slate at depth 1 and as
    one-slot chains of LANE_CHAIN passes. Returns the largest absolute
    difference of the new values."""
    import numpy as np
    import torch
    from repro_torch.kernels import block_sweep as kb
    tile_cnt = ed.tile_cnt.cpu().numpy()
    P, L = tile_cnt.size, values.shape[1]
    nsub = 1 if floor is None else int(ed.cov.shape[1])
    if psd0 is None:
        psd0 = np.zeros((P, nsub, L), np.float32)
    if lane_done is None:
        lane_done = np.zeros(L, bool)
    t0 = time.perf_counter()
    hub = int(np.argmax(tile_cnt))
    others = rng.choice(np.setdiff1d(np.arange(P), [hub]), size=64,
                        replace=False)
    blocks = np.concatenate([[hub], others]).astype(np.int32)
    eds = {DEV: ed}
    if plain_dev == "cpu":
        eds["cpu"] = type(ed)(*(t.cpu() for t in ed))
    runs = [(DEV, False), (plain_dev, True)]
    args = dict(block_size=c, n_live=n_live, floor=floor)
    worst = 0.0
    same = total = 0

    def compare(what, g, h):
        nonlocal worst, same, total
        for a, b, part in zip(g, h, ("values", "psd", "dmax")):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            if part == "values":
                worst = max(worst, float(np.max(np.abs(a - b))))
                same += int((a == b).sum())
                total += a.size
            if program.combine == "sum":
                if not np.allclose(a, b, rtol=1e-6, atol=0):
                    fail(f"{label} {what}: kernel {part} off plain by more "
                         "than rtol=1e-6")
            elif not np.array_equal(a, b):
                fail(f"{label} {what}: kernel {part} not bitwise plain")

    def fresh(dev):
        return (torch.from_numpy(values.copy()).to(dev),
                torch.from_numpy(vconst).to(dev),
                torch.from_numpy(psd0.copy()).to(dev),
                torch.zeros(P, nsub, L, device=dev),
                torch.from_numpy(lane_done).to(dev),
                kb.make_lane_scratch(eds[dev], c, L))

    out = []
    for dev, plain in runs:  # depth 1: one slate
        v, vc, p, d, ld, sc = fresh(dev)
        lane_sweep(program, n_total, eds[dev], v, vc,
                   torch.from_numpy(blocks).to(dev),
                   torch.ones(blocks.size, dtype=torch.bool, device=dev), p,
                   d, ld, sc, plain=plain, **args)
        out.append((v, p, d))
    torch.cuda.synchronize()
    compare("depth 1", *out)
    out = []
    for dev, plain in runs:  # one-slot chains
        v, vc, p, d, ld, sc = fresh(dev)
        k = torch.ones(1, dtype=torch.bool, device=dev)
        for b in blocks:
            r = torch.tensor([b], dtype=torch.int32, device=dev)
            for i in range(LANE_CHAIN):
                lane_sweep(program, n_total, eds[dev], v, vc, r, k, p, d, ld,
                           sc, plain=plain, first=i == 0,
                           last=i == LANE_CHAIN - 1, **args)
        out.append((v, p, d))
    torch.cuda.synchronize()
    compare(f"depth {LANE_CHAIN}", *out)
    log(f"[kernel] {label}: kernel vs plain ({plain_dev}) on hub block {hub} "
        f"({int(tile_cnt[hub])} tiles) + 64 blocks, L={L}, depth 1 and "
        f"{LANE_CHAIN}: "
        f"bitwise share {same}/{total}, max_abs_err {worst!r} (in "
        f"{time.perf_counter() - t0:.1f} s)")
    return worst


def time_lane_sweep(label, program, ed, c, n_live, n_total, values0,
                    vconst, floor=None, psd0=None, lane_done=None,
                    plain=True):
    """Phase 2d timings: one cold lane sweep of every block from one
    snapshot, by the kernel, the plain version on the card (unless
    ``plain`` is off) and a library yardstick, beside the least time the
    card could take for the work."""
    import numpy as np
    import torch
    from repro_torch.kernels import block_sweep as kb
    P = ed.tile_cnt.numel()
    L = values0.shape[1]
    masked = floor is not None
    nsub = int(ed.cov.shape[1]) if masked else 1
    values = torch.as_tensor(values0).to(DEV)
    vc = torch.as_tensor(vconst).to(DEV)
    p0 = torch.as_tensor(psd0 if masked else
                         np.zeros((P, 1, L), np.float32)).to(DEV)
    psd = p0.clone()
    dmax = torch.zeros_like(p0)
    ld = torch.as_tensor(lane_done if lane_done is not None
                         else np.zeros(L, bool)).to(DEV)
    rows = torch.arange(P, dtype=torch.int32, device=DEV)
    ok = torch.ones(P, dtype=torch.bool, device=DEV)
    sc = kb.make_lane_scratch(ed, c, L)
    args = dict(block_size=c, n_live=n_live, floor=floor)

    # the sweep is in place; its work does not depend on the values, only
    # on the mask, so each run restores the psd (P*S*L*4 B) and no values
    def run(plain=False):
        psd.copy_(p0)
        lane_sweep(program, n_total, ed, values, vc, rows, ok, psd, dmax, ld,
                   sc, plain=plain, **args)
    ms = cuda_ms(run, 20)
    plain_ms = cuda_ms(lambda: run(plain=True), 1, warmup=False) \
        if plain else None
    valid = ed.valid
    if masked:
        act = (torch.where(ld, 0.0, p0).amax(dim=-1) >= floor)  # (P, S)
        block_of_tile = torch.repeat_interleave(
            torch.arange(P, device=DEV), ed.tile_cnt.long())
        valid = valid & (ed.cov & act[block_of_tile]).any(dim=1)[:, None]
        vert_act = act.repeat_interleave(c // nsub, dim=1).reshape(-1)
    else:
        vert_act = torch.ones(P * c, dtype=torch.bool, device=DEV)
    m = int(valid.sum())
    n_pad = values.shape[0]
    n_out = int(vert_act.sum())
    # each input read once, each output written once: the needed tile slots
    # (9 B, and 4 B w where edge_map reads it), the values in, the active
    # vertices' values out, psd and dmax out; aux in and the active
    # vertices' vconst in only for a family whose edge_map reads aux and
    # whose apply reads vconst (k_ppr)
    aux_b = 4 if program.aux_fn is not None else 0
    vc_b = 4 * L if program.uses_vconst else 0
    slot_b = 9 + w_bytes(program)
    nbytes = (m * slot_b + n_pad * 4 * L + n_total * aux_b
              + n_out * (4 * L + vc_b) + P * nsub * L * 8)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # the same counted with one value gather (and aux gather) per edge slot
    # (what a kernel that caches nothing across slots must read)
    gather_ms = (m * (slot_b + 4 * L + aux_b) + n_out * (4 * L + vc_b)) \
        / HBM_BYTES_PER_S * 1e3
    # library yardstick (timed here only): a gather of the (E, L) rows, the
    # map, and one scatter-reduce over the edges the mask needs
    idx = torch.nonzero(valid.view(-1)).view(-1)
    src = ed.src.view(-1)[idx].long()
    block_of_tile = torch.repeat_interleave(
        torch.arange(P, device=DEV), ed.tile_cnt.long())
    dst = (block_of_tile[:, None] * c + ed.dstl.long()).view(-1)[idx]
    w = ed.w.view(-1)[idx]
    ident = float(program.identity)

    def library():
        msg = program.edge_map(values.index_select(0, src),
                               ed.aux.index_select(0, src), w)
        if program.combine == "sum":
            agg = torch.zeros_like(values).index_add_(0, dst, msg)
        else:
            agg = torch.full_like(values, ident).scatter_reduce_(
                0, dst[:, None].expand(-1, L), msg, reduce="amin")
        return program.apply(values, agg, vc, n_total)

    library_ms = cuda_ms(library, 10)
    log(f"[kernel] {label}: full cold lane sweep of {P} blocks at L={L}, "
        f"{m} needed edges, {n_out} active vertex slots: kernel {ms!r} ms, "
        f"plain {'not timed' if plain_ms is None else repr(plain_ms) + ' ms'}"
        f", library {library_ms!r} ms, bound "
        f"{bound_ms!r} ms ({nbytes} B at {HBM_BYTES_PER_S:.3g} B/s; with a "
        f"gather per edge slot {gather_ms!r} ms)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms)


def time_lane_shapes(label, program, ed, c, n_live, n_total, values0,
                     vconst, hub, slate, floor=None, psd0=None):
    """Phase 2d: a lane kernel at the shapes the serving path launches, at
    L = LANES (``time_shapes``), unmasked (1l), or with ``psd0``'s mask
    (1lm, no lane done; each call starts from it)."""
    import numpy as np
    import torch
    from repro_torch.kernels import block_sweep as kb
    P = ed.tile_cnt.numel()
    L = values0.shape[1]
    masked = floor is not None
    values = torch.as_tensor(values0).to(DEV)
    vc = torch.as_tensor(vconst).to(DEV)
    p0 = torch.as_tensor(psd0 if masked else np.zeros((P, 1, L), np.float32)
                         ).to(DEV)
    psd = p0.clone()
    dmax = torch.zeros_like(p0)
    ld = torch.zeros(L, dtype=torch.bool, device=DEV)
    sc = kb.make_lane_scratch(ed, c, L)

    def call(r, ok):
        def run():
            psd.copy_(p0)
            lane_sweep(program, n_total, ed, values, vc, r, ok, psd, dmax,
                       ld, sc, floor=floor, block_size=c, n_live=n_live)
        return run

    return time_shapes(label, ed, hub, slate, call,
                       live=p0.amax(dim=-1) >= floor if masked else None)


def lane_shapes_phase(engines, times, lrng, full=False):
    """Phase 2d's lane shapes: kernels 1l and 1lm at L = LANES where the
    serving path launches them, k_sssp on the SSSP graph and k_ppr on the
    PageRank graph (``time_lane_shapes``: a one-slot pass of the hub block
    and a WIDTH-slot cold slate; 1lm at S = SUB with a 1/S-live mask); with
    ``full`` also the full cold lane sweeps of 1l and of 1lm all live and
    1/S live, with the library yardstick and no plain version. Its draws
    come from ``lrng`` alone."""
    import numpy as np
    from repro_torch.core import algorithms as A
    for name, prog in (("sssp", A.k_source_sssp()),
                       ("pagerank", A.k_personalized_pagerank())):
        sa = engines[name][0]
        c, n_live, n_total = BLOCK, sa.plan.n_live, sa.plan.graph.n
        P = sa.plan.num_blocks
        floor = np.float32(sa._psd_floor())
        hub, slate = hub_and_slate(sa, lrng)
        values, vconst = lane_state(prog, sa._values_len, lrng)
        ed8 = masked_tiles(sa, SUB)
        label = f"{prog.name} on the {name} graph"

        def lane_psd(frac):
            return np.repeat(sub_mask_psd(lrng, P, SUB, floor, frac)
                             [:, :, None], LANES, axis=2)

        # both masks drawn with or without ``full``, so that the smoke and
        # --sweep-profile time the same shapes
        eighth, live = lane_psd(1.0 / SUB), lane_psd(1.0)
        times[("1l shapes", name)] = time_lane_shapes(
            f"{label} kernel 1l", prog, sa.edge_state, c, n_live, n_total,
            values, vconst, hub, slate)
        times[("1lm shapes", name)] = time_lane_shapes(
            f"{label} kernel 1lm S={SUB}, live fraction 1/{SUB}", prog, ed8,
            c, n_live, n_total, values, vconst, hub, slate, floor=floor,
            psd0=eighth)
        if full:
            times[("1l full", name)] = time_lane_sweep(
                f"{label} kernel 1l", prog, sa.edge_state, c, n_live,
                n_total, values, vconst, plain=False)
            for frac, psd0 in ((1.0, live), (1.0 / SUB, eighth)):
                times[("1lm full", name, frac)] = time_lane_sweep(
                    f"{label} kernel 1lm S={SUB}, live fraction {frac!r}",
                    prog, ed8, c, n_live, n_total, values, vconst,
                    floor=floor, lane_done=np.zeros(LANES, bool), psd0=psd0,
                    plain=False)
        del ed8


def bellman_ford(g, sources, unit=False):
    """(n, L) min-plus fixpoint from ``sources`` over ``g``'s COO, on the
    card. Each candidate is dist[src] + w, the engine's own float sum, so
    the least fixpoint is unique and the engine's must equal it bitwise."""
    import numpy as np
    import torch
    from repro_torch.core.graph import edges_of
    s, d, w = edges_of(g)
    s = torch.as_tensor(s).to(DEV)
    d = torch.as_tensor(d).to(DEV)
    w = (torch.ones(s.numel(), device=DEV) if unit
         else torch.as_tensor(np.asarray(w, np.float32)).to(DEV))
    L = len(sources)
    dist = torch.full((g.n, L), 1e18, dtype=torch.float32, device=DEV)
    dist[torch.as_tensor(np.asarray(sources)).to(DEV),
         torch.arange(L, device=DEV)] = 0.0
    dl = d[:, None].expand(-1, L).contiguous()
    for _ in range(g.n):
        cand = dist.index_select(0, s) + w[:, None]
        new = dist.scatter_reduce(0, dl, cand, reduce="amin")
        if torch.equal(new, dist):
            break
        dist = new
    return dist.cpu().numpy()


def ppr_power(g, resets, d=0.85, iters=500):
    """(n, L) personalized PageRank by power iteration in float64 on the
    card (the reference test's oracle): x = (1-d) r + d A x, r uniform over
    each reset set, dangling mass vanishing (aux = max(out_deg, 1))."""
    import numpy as np
    import torch
    from repro_torch.core.graph import edges_of
    s, dst, _ = edges_of(g)
    s = torch.as_tensor(s).to(DEV)
    dst = torch.as_tensor(dst).to(DEV)
    L = len(resets)
    r = torch.zeros(g.n, L, dtype=torch.float64, device=DEV)
    for lane, rs in enumerate(resets):
        r[:, lane].index_add_(0, torch.as_tensor(np.asarray(rs)).to(DEV),
                              torch.full((len(rs),), 1.0 / len(rs),
                                         dtype=torch.float64, device=DEV))
    inv_deg = 1.0 / torch.as_tensor(np.maximum(g.out_deg, 1)).to(
        device=DEV, dtype=torch.float64)
    x = r.clone()
    for _ in range(iters):
        msg = x.index_select(0, s) * inv_deg.index_select(0, s)[:, None]
        nx = (1 - d) * r + d * torch.zeros_like(x).index_add_(0, dst, msg)
        if float((nx - x).abs().max()) < 1e-15:
            x = nx
            break
        x = nx
    return x.cpu().numpy()


def lane_counts():
    from repro_torch.kernels import block_sweep as kb
    return kb.lane_block_sweep.launches, kb.masked_lane_block_sweep.launches


def serve_pending(label, svc, se):
    """run_pending, with one line per lane batch: its family, lanes,
    supersteps, times, host syncs, lane-kernel launches and counters.
    Returns the results and the batches' lane-kernel launches."""
    import numpy as np
    import torch
    recs = []
    run_batch = svc._run_batch

    def recorded(pend):
        n0 = lane_counts()
        out = run_batch(pend)
        n1 = lane_counts()
        recs.append((out, svc.last_batch, n1[0] - n0[0], n1[1] - n0[1]))
        return out

    svc._run_batch = recorded
    torch.cuda.synchronize()
    results = svc.run_pending()
    torch.cuda.synchronize()
    del svc._run_batch
    for out, lr, n1l, n1lm in recs:
        r0, m = out[0], lr.metrics
        log(f"[serve] {label}: {r0.kind} batch on epoch {r0.epoch}: "
            f"lanes={r0.lanes} supersteps={r0.batch_iterations} per-lane "
            f"{[r.iterations for r in out]} converged "
            f"{[r.converged for r in out]} run_s={r0.run_s!r} wait_s "
            f"{[r.wait_s for r in out]!r} host_syncs={lr.host_syncs} "
            f"launches 1l={n1l} 1lm={n1lm} updates={m.updates} "
            f"loads={m.block_loads} bytes={m.bytes_loaded} "
            f"queries_per_s={r0.lanes / r0.run_s!r}")
    sm = svc.metrics
    log(f"[serve] {label}: {sm.queries} queries in {sm.lane_batches} "
        f"batches, snapshots_preserved={se.metrics.snapshots_preserved} "
        f"stale_answers={sm.stale_answers} "
        f"queries_per_s={sm.queries_per_s!r}")
    if not all(r.converged for r in results):
        fail(f"{label}: a query lane did not converge")
    launches = np.array([[n1l, n1lm] for _, _, n1l, n1lm in recs]).sum(0)
    return results, launches


def check_answers(label, results, sources, g, kind, epoch):
    """Every answer of ``kind`` is its pinned epoch's: SSSP/BFS bitwise
    against Bellman-Ford on ``g``, PPR against power iteration at the
    reference test's tolerance (rtol=1e-3, atol=1e-6)."""
    import numpy as np
    got = [r for r in results if r.kind == kind]
    if len(got) != len(sources) or any(r.epoch != epoch for r in got):
        fail(f"{label}: {kind} answers not all on epoch {epoch}")
    got.sort(key=lambda r: r.query_id)
    vals = np.stack([r.values for r in got], axis=1)
    if not np.all(np.isfinite(vals)) or vals.shape != (g.n, len(sources)):
        fail(f"{label}: {kind} answers not finite of shape "
             f"({g.n}, {len(sources)})")
    if kind == "ppr":
        want = ppr_power(g, sources)
        if not np.allclose(vals, want, rtol=1e-3, atol=1e-6):
            fail(f"{label}: ppr answers off the power iteration")
        err = float(np.max(np.abs(vals - want)))
        log(f"[check] {label}: {len(sources)} ppr answers on epoch {epoch} "
            f"within rtol=1e-3, atol=1e-6 of the power iteration (max abs "
            f"difference {err!r})")
        return
    want = bellman_ford(g, sources, unit=kind == "bfs")
    if not np.array_equal(vals, want):
        fail(f"{label}: {kind} answers not bitwise Bellman-Ford's")
    log(f"[check] {label}: {len(sources)} {kind} answers on epoch {epoch} "
        f"bitwise equal to Bellman-Ford on the card")


def serve_phase(label, se, waves0, waves1, batch):
    """One serving phase: a QueryService(max_lanes=LANES) over the stream
    ``se``. The queries of ``waves0`` ((kind, params) pairs: sources, or
    ppr reset sets) are submitted on the current epoch, ``batch`` is
    ingested while they pend, and run_pending() must answer every one on
    the pinned epoch; then the queries of ``waves1`` run on the new epoch.
    Returns the launches of kernels 1l and 1lm on the serving path."""
    import numpy as np
    from repro_torch.serve import Query, QueryService

    def query(kind, p):
        return (Query(kind=kind, reset=p) if kind == "ppr"
                else Query(kind=kind, source=p))

    svc = QueryService(se, max_lanes=LANES)
    g0, e0 = se.current_graph(), se.epoch
    preserved = se.metrics.snapshots_preserved
    t0 = time.perf_counter()
    svc.submit(query(waves0[0][0], waves0[0][1][0]))
    pin_s = time.perf_counter() - t0
    for i, (kind, params) in enumerate(waves0):
        for p in params[1 if i == 0 else 0:]:
            svc.submit(query(kind, p))
    r = svc.ingest(batch)
    log(f"[serve] {label}: first submit (pins epoch {e0}, copies the "
        f"coupling counts {se.W.shape} and degrees on the host) {pin_s!r} "
        f"s; ingest of +{r.inserts} -{r.deletes} while {svc.pending} "
        f"queries pend: ingest_s={r.ingest_time_s!r} reconverge_s="
        f"{r.reconverge_time_s!r} plan_rebuild={r.plan_rebuild} "
        f"snapshots_preserved={se.metrics.snapshots_preserved}")
    if se.metrics.snapshots_preserved != preserved + 1:
        fail(f"{label}: the ingest must preserve the pinned epoch once")
    zero_counts()
    results, launches = serve_pending(f"{label} epoch {e0}", svc, se)
    for kind, params in waves0:
        check_answers(label, results, params, g0, kind, e0)
    if waves1:
        g1, e1 = se.current_graph(), se.epoch
        for kind, params in waves1:
            for p in params:
                svc.submit(query(kind, p))
        results, n1 = serve_pending(f"{label} epoch {e1}", svc, se)
        for kind, params in waves1:
            check_answers(label, results, params, g1, kind, e1)
        launches = launches + n1
    return [int(n) for n in np.asarray(launches)]


def launch_counts():
    from repro_torch.kernels import block_sweep as kb
    return kb.block_sweep.launches, kb.masked_block_sweep.launches


def zero_counts():
    from repro_torch.kernels import block_sweep as kb
    from repro_torch.kernels import segment as ks
    kb.block_sweep.launches = 0
    kb.masked_block_sweep.launches = 0
    kb.lane_block_sweep.launches = 0
    kb.masked_lane_block_sweep.launches = 0
    for op in ("sum", "min", "max"):
        getattr(ks, f"edge_block_{op}").launches = 0


def segment_counts() -> dict:
    from repro_torch.kernels import segment as ks
    return {op: getattr(ks, f"edge_block_{op}").launches
            for op in ("sum", "min", "max")}


SEGMENT_PROGRAMS = ("sum", "pagerank"), ("min", "sssp"), ("max", "cc")


def segment_layouts(eng):
    """The kernels' layout of every storage group of ``eng``, built as
    make_block_processor builds it: over each row's valid prefix."""
    from repro_torch.kernels import segment as ks
    c = eng.plan.block_size
    return {k: ks.segment_layout(st.dst_local, c, st.edges)
            for k, st in eng._stores.items()}


def segment_msg(program, st, r, values, aux):
    """Row r's messages over its valid prefix (its true edges): edge_map of
    the gathered values, as the block processor computes them."""
    e = int(st.edges[r])
    src = st.src[r, :e]
    return program.edge_map(values.index_select(0, src),
                            aux.index_select(0, src), st.w[r, :e])


def segment_check(label, eng, layouts, ops, rng):
    """Phase 6a's check: each combine of ``ops`` ((combine, program name)
    pairs) on the hub row and DIST_ROWS seeded random rows of each storage
    group of ``eng``, called as the block processor calls it (the row's
    valid prefix through the group's layout of those prefixes), on a
    mid-run state, against the plain version on CPU copies: bit for bit.
    Returns the largest absolute difference by combine."""
    import numpy as np
    import torch
    from repro_torch.core import algorithms as A
    from repro_torch.kernels import segment as ks
    c, stores = eng.plan.block_size, eng._stores
    aux = torch.as_tensor(eng.aux).to(DEV)
    hot, cold = stores["hot"], stores["cold"]
    hub = int(np.argmax(hot.edges))
    picks = {"hot": [hub] + sorted(rng.choice(
                 np.setdiff1d(np.arange(hot.num_blocks), [hub]),
                 min(DIST_ROWS, hot.num_blocks - 1), replace=False)),
             "cold": sorted(rng.choice(cold.num_blocks,
                                       min(DIST_ROWS, cold.num_blocks),
                                       replace=False))}
    paths = {key: {name: int((lay.path == getattr(ks, name)).sum())
                   for name in ("SHORT", "LONG")}
             for key, lay in layouts.items()}
    errs = {}
    for op, name in ops:
        prog = A.REGISTRY[name]()
        kernel = getattr(ks, f"edge_block_{op}")
        plain = getattr(ks, f"edge_block_{op}_ref")
        extra = () if op == "sum" else (float(prog.identity),)
        values = torch.as_tensor(mid_run_state(name, eng._values_len,
                                               rng)).to(DEV)
        errs[op], checked = 0.0, 0
        for key, rows in picks.items():
            st = stores[key]
            for r in rows:
                e = int(st.edges[r])
                m = segment_msg(prog, st, r, values, aux)
                d = st.dst_local[r, :e]
                got = kernel(m, d, c, *extra, layout=layouts[key],
                             row=r).cpu()
                want = plain(m.cpu(), d.cpu(), c, *extra)
                errs[op] = max(errs[op], float((got - want).abs().max()))
                if not same_bits(got, want):
                    fail(f"6a {label} {op} {key} row {r}: kernel not "
                         "bitwise plain")
                checked += e
        log(f"[kernel] 6a edge_block_{op} ({name} arithmetic on the {label} "
            f"storage): kernel vs plain (cpu) bitwise on hub row {hub} "
            f"({int(hot.edges[hub])} edges) + {len(picks['hot']) - 1} hot "
            f"and {len(picks['cold'])} cold rows, each row's valid prefix "
            f"through the group's layout ({checked} slots; rows by path "
            f"{paths})")
    return errs


def same_bits(a, b) -> bool:
    """Equal f32 bit patterns (-0.0 is not +0.0)."""
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def segment_unsorted_check(c, rng):
    """Phase 6a's check of the kernels on a row not sorted by destination:
    a synthetic row of SEG_UNSORTED_E slots into ``c`` destinations, sorted
    for its first third, then unsorted, then a padded tail of dst 0 and
    identity messages, through a one-row layout, against the plain version
    on CPU copies, bit for bit, for each combine. Returns the largest
    absolute difference by combine."""
    import numpy as np
    import torch
    from repro_torch.kernels import segment as ks
    e = SEG_UNSORTED_E
    d = rng.integers(0, c, e).astype(np.int32)
    d[:e // 3] = np.sort(d[:e // 3])
    d[e - e // 8:] = 0
    dst = torch.from_numpy(d).to(DEV)
    layout = ks.segment_layout(dst, c)
    errs = {}
    for op, ident in (("sum", 0.0), ("min", 1e18), ("max", -1e18)):
        msg = rng.uniform(0.0, 30.0, e).astype(np.float32)
        msg[e - e // 8:] = ident
        m = torch.from_numpy(msg).to(DEV)
        extra = () if op == "sum" else (ident,)
        got = getattr(ks, f"edge_block_{op}")(m, dst, c, *extra,
                                              layout=layout).cpu()
        want = getattr(ks, f"edge_block_{op}_ref")(m.cpu(), dst.cpu(), c,
                                                   *extra)
        errs[op] = float((got - want).abs().max())
        if not same_bits(got, want):
            fail(f"6a: edge_block_{op} not bitwise plain on the synthetic "
                 "unsorted row")
    path = "long" if layout.path[0] == ks.LONG else "short"
    log(f"[kernel] 6a edge_block_sum/min/max on a synthetic unsorted row "
        f"({e} slots, C={c}, sorted for a third, a padded tail of an "
        f"eighth; {int(layout.npieces[0])} runs, the {path} path): kernel "
        f"vs plain (cpu) bitwise")
    return errs


def segment_row_stats(eng, layouts):
    """Phase 6a's look at the rows the kernels get, from the layouts: how
    many rows are sorted by destination over their valid prefix, the runs
    per destination of each group (on a sorted row, its slot range cut at
    the multiples of 512), each row's path, and how many rows have a
    destination of more than t runs at several thresholds."""
    import numpy as np
    import torch
    from repro_torch.kernels import segment as ks
    for key, st in eng._stores.items():
        lay = layouts[key]
        runs = np.diff(lay.lptr.cpu().numpy(), axis=1)
        top = runs.max(axis=1)
        sorted_ = int(torch.stack([
            (st.dst_local[r, 1:e] >= st.dst_local[r, :max(e - 1, 0)]).all()
            for r, e in enumerate(int(x) for x in st.edges)]).sum())
        over = {t: int((top > t).sum()) for t in (1, 2, 4, 8, 16, 32)}
        log(f"[kernel] 6a {key} group: {st.num_blocks} rows, {sorted_} "
            f"sorted by destination over their valid prefix, "
            f"{int((lay.path == ks.LONG).sum())} on the long path; runs per "
            f"destination: total {int(runs.sum())}, largest per row max "
            f"{int(top.max())} median {float(np.median(top))}; rows with a "
            f"destination of more than t runs {over}; destinations of more "
            f"than t runs "
            f"{ {t: int((runs > t).sum()) for t in (1, 2, 4, 8, 16)} }")


def profile_kernels(fn) -> dict:
    """Device microseconds and launches by kernel name over one call of
    ``fn``, by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0}


def host_ms(fn, reps: int = 3) -> float:
    """Mean host milliseconds to enqueue ``fn`` (no synchronize inside),
    each run started on an idle card, after one warm-up run."""
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e3


class _NoLaunch:
    """A stand-in for a kernel library whose every entry point returns 0
    and launches nothing: times a wrapper's own Python."""
    _typed = True

    def __getattr__(self, name):
        return lambda *args: 0


def wrapper_python_ms(fn, reps: int = 3) -> float:
    """Mean host milliseconds of ``fn`` with the segment kernels' library
    stubbed out: the wrappers' checks and argument handling alone."""
    from repro_torch.kernels import segment as ks
    real = ks._lib
    ks._lib = lambda: _NoLaunch()
    try:
        return host_ms(fn, reps)
    finally:
        ks._lib = real


def describe_profile(prof: dict) -> str:
    return "; ".join(f"{k[:60]} {us:.1f} us {n}x"
                     for k, (us, n) in sorted(prof.items(),
                                              key=lambda kv: -kv[1][0]))


def segment_times(eng, layouts, rng):
    """Phase 6a's times on the PageRank graph's storage: each combine once
    on the hub row and once over every cold row (each row's valid prefix,
    as the path calls it): kernel (CUDA events; for the cold pass, as for
    its library call, the median of COLD_PASSES passes timed one by one,
    their least and greatest, and the mean of 3 passes back to back, the
    statistic of the earlier runs), plain version on
    the card (for the cold pass the sum's alone, whose order it defines:
    ~10 s), library yardstick and both bounds: the bytes a call on a
    sorted row needs (msg, the destination offsets, the output) and those
    of the function with dst read (8 B per slot). For the cold pass also
    the host enqueue time of its calls, the wrappers' own Python, and the
    device time by kernel (torch.profiler), and for the hub row the
    latter. Returns (hub times, cold times) by combine."""
    import numpy as np
    import torch
    from repro_torch.core import algorithms as A
    from repro_torch.kernels import segment as ks
    c, stores = eng.plan.block_size, eng._stores
    aux = torch.as_tensor(eng.aux).to(DEV)
    hot, cold = stores["hot"], stores["cold"]
    hub = int(np.argmax(hot.edges))
    cold_e = [int(e) for e in cold.edges]
    hub_t, cold_t = {}, {}

    def bounds(slots, rows):
        return dict(
            bound_ms=(slots * 4 + rows * ((c + 1) * 4 + c * 4))
            / HBM_BYTES_PER_S * 1e3,
            bound_dst_ms=(slots * 8 + rows * c * 4) / HBM_BYTES_PER_S * 1e3)

    for op, name in SEGMENT_PROGRAMS:
        prog = A.REGISTRY[name]()
        kernel = getattr(ks, f"edge_block_{op}")
        plain = getattr(ks, f"edge_block_{op}_ref")
        extra = () if op == "sum" else (float(prog.identity),)
        ident = float(prog.identity)
        reduce = {"min": "amin", "max": "amax"}.get(op)
        values = torch.as_tensor(mid_run_state(name, eng._values_len,
                                               rng)).to(DEV)

        def library(m, dl):
            if op == "sum":
                return torch.zeros(c, device=DEV).index_add_(0, dl, m)
            return torch.full((c,), ident, device=DEV).scatter_reduce_(
                0, dl, m, reduce=reduce)

        e = int(hot.edges[hub])
        m = segment_msg(prog, hot, hub, values, aux)
        d = hot.dst_local[hub, :e]
        dl = d.long()

        def hub_call():
            return kernel(m, d, c, *extra, layout=layouts["hot"], row=hub)

        hub_t[op] = dict(
            ms=cuda_ms(hub_call, 20),
            plain_ms=cuda_ms(lambda: plain(m, d, c, *extra), 1,
                             warmup=False),
            library_ms=cuda_ms(lambda: library(m, dl), 20),
            device=profile_kernels(hub_call), **bounds(e, 1))
        del m, d, dl
        ms = [segment_msg(prog, cold, r, values, aux)
              for r in range(cold.num_blocks)]
        ds = [cold.dst_local[r, :e] for r, e in enumerate(cold_e)]
        dls = [d.long() for d in ds]

        def cold_pass():
            for r, (m, d) in enumerate(zip(ms, ds)):
                kernel(m, d, c, *extra, layout=layouts["cold"], row=r)

        def library_pass():
            for m, dl in zip(ms, dls):
                library(m, dl)

        passes = cuda_ms_passes(cold_pass, COLD_PASSES)
        library_passes = cuda_ms_passes(library_pass, COLD_PASSES)
        cold_t[op] = dict(
            ms=float(np.median(passes)), passes=passes,
            mean3_ms=cuda_ms(cold_pass, 3),
            plain_ms=cuda_ms(lambda: [plain(m, d, c, *extra)
                                      for m, d in zip(ms, ds)], 1,
                             warmup=False) if op == "sum" else None,
            library_ms=float(np.median(library_passes)),
            library_passes=library_passes,
            library_mean3_ms=cuda_ms(library_pass, 3),
            host_ms=host_ms(cold_pass), python_ms=wrapper_python_ms(cold_pass),
            device=profile_kernels(cold_pass),
            **bounds(sum(cold_e), cold.num_blocks))
        del ms, ds, dls
        for label, t, slots in (("hub row", hub_t[op], e),
                                (f"{cold.num_blocks} cold rows", cold_t[op],
                                 sum(cold_e))):
            plain_ms = ("not measured" if t["plain_ms"] is None
                        else f"{t['plain_ms']!r} ms")
            log(f"[kernel] 6a edge_block_{op} on the {label} ({slots} "
                f"edges, C={c}): kernel {t['ms']!r} ms, plain {plain_ms}, "
                f"library {t['library_ms']!r} ms, bound {t['bound_ms']!r} "
                f"ms (4 B per edge + 8 B per destination, dst not read on "
                f"a sorted row) and {t['bound_dst_ms']!r} ms (8 B per edge "
                f"+ 4 B per destination), at {HBM_BYTES_PER_S:.3g} B/s")
            if "host_ms" in t:
                log(f"[kernel] 6a edge_block_{op} on the {label}: "
                    f"{COLD_PASSES} passes timed one by one, kernel "
                    f"{t['passes']!r} ms (median {t['ms']!r}, least "
                    f"{min(t['passes'])!r}, greatest {max(t['passes'])!r}), "
                    f"library {t['library_passes']!r} ms (median "
                    f"{t['library_ms']!r}, least "
                    f"{min(t['library_passes'])!r}, greatest "
                    f"{max(t['library_passes'])!r}); mean of 3 back to "
                    f"back: kernel {t['mean3_ms']!r} ms, library "
                    f"{t['library_mean3_ms']!r} ms")
                log(f"[kernel] 6a edge_block_{op} on the {label}: host "
                    f"enqueue {t['host_ms']!r} ms for {len(cold_e)} calls "
                    f"(no synchronize inside), of which the wrappers' own "
                    f"Python {t['python_ms']!r} ms (library stubbed)")
            log(f"[kernel] 6a edge_block_{op} on the {label}: device time "
                f"by kernel (torch.profiler, one call or pass): "
                f"{describe_profile(t['device'])}")
    return hub_t, cold_t


def dist_run(label, eng, build_s, op, want, exact):
    """Phase 6b: run a built DistributedEngine with the counts zeroed just
    before, check that its combine kernel launched and its values against
    the baseline's. Returns the launches."""
    import numpy as np
    import torch
    zero_counts()
    torch.cuda.synchronize()
    res = eng.run()
    torch.cuda.synchronize()
    n = segment_counts()
    m = res.metrics
    log(f"[dist] {label}: world={eng.world} bpd={eng.bpd} P="
        f"{eng.plan.num_blocks} hot-born={eng.plan.barrier_block} padded "
        f"storage {eng.storage_bytes()} B on the card (built in {build_s:.1f} "
        f"s): supersteps={m.iterations} converged={m.converged} "
        f"wall_s={m.wall_time_s!r} host_syncs={res.host_syncs} "
        f"launches={n} updates={m.updates} loads={m.block_loads} "
        f"bytes={m.bytes_loaded}")
    if n[op] == 0:
        fail(f"{label}: edge_block_{op} never launched")
    if not m.converged:
        fail(f"{label}: did not converge")
    if not np.all(np.isfinite(res.values)) or res.values.shape != want.shape:
        fail(f"{label}: values not finite of shape {want.shape}")
    agree(label, res.values, want, exact)
    return n[op]


def agree(name, got, want, exact):
    import numpy as np
    if exact:
        if not np.array_equal(got, want):
            fail(f"{name}: values not bitwise equal to the baseline's")
        return
    if not np.allclose(got, want, rtol=1e-4, atol=2e-3 / got.size):
        excess = np.abs(got - want) / (1e-4 * np.abs(want)
                                       + 2e-3 / got.size)
        i = int(np.argmax(excess))
        fail(f"{name}: disagree with the baseline at "
             f"{int((excess > 1).sum())} vertices; worst {i}: {got[i]!r} "
             f"vs {want[i]!r}")


def stream_phase(label, g, program, cfg, batches, exact):
    """Phase 4 for one program: bootstrap a StreamingEngine, ingest the
    batches, and hold the warm values against the baseline on the mutated
    graph after each. Returns the masked launches of the streaming runs."""
    import numpy as np
    import torch
    from repro_torch.core.baseline import BaselineEngine
    from repro_torch.stream import StreamingEngine
    masked = 0
    t0 = time.perf_counter()
    zero_counts()
    torch.cuda.synchronize()
    se = StreamingEngine(g, program, cfg, device=DEV)
    torch.cuda.synchronize()
    n1, n1m = launch_counts()
    masked += n1m
    init = se.initial_result.metrics
    log(f"[stream] {label}: P={se.engine.plan.num_blocks} S="
        f"{cfg.subblocks} built and bootstrapped in "
        f"{time.perf_counter() - t0:.1f} s: iterations={init.iterations} "
        f"converged={init.converged} wall_s={init.wall_time_s!r} launches "
        f"kernel1={n1} kernel1m={n1m}")
    if not init.converged:
        fail(f"{label}: the bootstrap run did not converge")
    for i, b in enumerate(batches):
        zero_counts()
        torch.cuda.synchronize()
        r = se.ingest(b)
        torch.cuda.synchronize()
        n1, n1m = launch_counts()
        masked += n1m
        log(f"[stream] {label} batch {i}: +{r.inserts} -{r.deletes} "
            f"iterations={r.iterations} converged={r.converged} "
            f"dirty_frac={r.dirty_frac!r} "
            f"subblock_dirty_frac={r.subblock_dirty_frac!r} "
            f"upload_frac={r.upload_frac!r} bytes_uploaded="
            f"{r.bytes_uploaded} bytes_full={r.bytes_full} latency_s="
            f"{r.latency_s!r} (ingest {r.ingest_time_s!r}, reconverge "
            f"{r.reconverge_time_s!r}) appended={r.appended_blocks} "
            f"killed={r.killed_blocks} rebuilt={r.rebuilt_blocks} "
            f"plan_rebuild={r.plan_rebuild} launches kernel1={n1} "
            f"kernel1m={n1m}")
        base = BaselineEngine(se.current_graph(), program, cfg,
                              frontier=False, device=DEV).run(
                                  max_iterations=BASE_CAP)
        if not base.metrics.converged:
            fail(f"{label} batch {i}: the baseline did not converge")
        if not np.all(np.isfinite(se.values)) or se.values.shape != (g.n,):
            fail(f"{label} batch {i}: values not finite of shape ({g.n},)")
        agree(f"{label} batch {i}", se.values, base.values, exact)
    log(f"[check] {label}: warm values agree with the baseline after every "
        f"batch ({'bitwise' if exact else 'rtol=1e-4, atol=2e-3/n'})")
    return masked, se


def nested_spans(rec, outer, chain):
    """Every ``outer`` span of the recorder holds the ``chain`` of span
    names, each inside the one before it by time and one level deeper."""
    spans = [e for e in rec.events if e["type"] == "span"]

    def inside(e, name):
        return [c for c in spans if c["name"] == name
                and c["depth"] == e["depth"] + 1 and c["ts"] >= e["ts"]
                and c["ts"] + c["dur"] <= e["ts"] + e["dur"]]

    tops = [e for e in spans if e["name"] == outer]
    for e in tops:
        level = [e]
        for name in chain:
            level = [c for p in level for c in inside(p, name)]
            if not level:
                return False
    return bool(tops)


def run_key(res):
    """What a traced run must reproduce of its untraced twin: iterations,
    every counter, convergence and host syncs (the wall clock aside)."""
    import dataclasses
    m = dataclasses.asdict(res.metrics)
    del m["wall_time_s"]
    return m, res.host_syncs


def trace_phase(engines, results, sa_launches, t_start):
    """Phase 3t: the traced main path, after phase 3's checks, on phase 3's
    engines. Its launches are counted apart from phase 3's."""
    import json as json_mod
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import algorithms as A
    from repro_torch.core import graph as G
    from repro_torch.core.engine import (TIMELINE_INT_COLS, EngineConfig,
                                         betweenness)
    from repro_torch.core.metrics import COUNTER_FIELDS
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import Query, QueryService
    from repro_torch.stream import StreamingEngine, synthetic_stream
    # -- the PageRank run at n = 2^21, whole, traced -------------------------
    sa = engines["pagerank"][0]
    plain = results[("pagerank", "structure-aware")]
    zero_counts()
    torch.cuda.synchronize()
    with obs_trace.recording() as rec:
        res = sa.run(max_iterations=SA_CAP, trace=True)
    torch.cuda.synchronize()
    n1 = launch_counts()[0]
    m, tl = res.metrics, res.timeline
    if not np.array_equal(res.values, plain.values) \
            or run_key(res) != run_key(plain):
        fail("3t: the traced PageRank run differs from phase 3's untraced "
             "run")
    if n1 != sa_launches["pagerank"]:
        fail(f"3t: the traced PageRank run launched kernel 1 {n1} times, "
             f"phase 3's untraced run {sa_launches['pagerank']}")
    if len(tl) != m.iterations \
            or [r["superstep"] for r in tl] != list(range(m.iterations)):
        fail("3t: the PageRank timeline is not one row per superstep")
    for f in COUNTER_FIELDS:
        if sum(r[f] for r in tl) != getattr(m, f):
            fail(f"3t: the timeline's {f} does not sum to the run's")
    if rec.dropped:
        fail(f"3t: the recorder dropped {rec.dropped} events")
    per = m.wall_time_s * 1e3 / m.iterations
    per0 = plain.metrics.wall_time_s * 1e3 / m.iterations
    run_span = next(e for e in rec.events if e["name"] == "run")
    log(f"[trace] 3t pagerank SA traced: iterations={m.iterations} "
        f"converged={m.converged} host_syncs={res.host_syncs} "
        f"sweep_launches={n1}, bitwise equal to phase 3's untraced run; "
        f"timeline {len(tl)} rows summing to the counters; wall_s "
        f"{m.wall_time_s!r} against {plain.metrics.wall_time_s!r}: "
        f"{per!r} ms per superstep traced, {per0!r} untraced "
        f"({per / per0!r}x); run span {run_span['dur']!r} s; "
        f"{len(rec.events)} events")
    with tempfile.TemporaryDirectory() as tmp:
        path = obs_export.write(rec, os.path.join(tmp, "trace_pagerank.json"),
                                meta={"phase": "3t"})
        with open(path) as f:
            errors = obs_export.validate(json_mod.load(f))
        if errors:
            fail(f"3t: the export is not valid Chrome-trace JSON: "
                 f"{errors[:3]}")
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs", "render", path,
             "--limit", "12"], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        if out.returncode:
            fail(f"3t: python -m repro_torch.obs render exited "
                 f"{out.returncode}: {out.stderr[-500:]}")
        log(f"[trace] 3t export {os.path.getsize(path)} B valid; render:\n"
            + "\n".join(out.stdout.splitlines()[-14:]))
    del rec, res, tl

    # -- the SSSP run, capped: fused traced and untraced, then the host loop
    sa = engines["sssp"][0]
    zero_counts()
    torch.cuda.synchronize()
    traced = sa.run(max_iterations=TRACE_CAP, trace=True)
    torch.cuda.synchronize()
    untraced = sa.run(max_iterations=TRACE_CAP)
    torch.cuda.synchronize()
    host = sa.run(max_iterations=TRACE_HOST_CAP, fused=False, trace=True)
    torch.cuda.synchronize()
    if not np.array_equal(traced.values, untraced.values) \
            or run_key(traced) != run_key(untraced) \
            or traced.metrics.iterations != TRACE_CAP:
        fail("3t: the traced SSSP run differs from its untraced twin")
    cols = TIMELINE_INT_COLS + ("width", "superstep")
    if [[r[c] for c in cols] for r in host.timeline] != \
            [[r[c] for c in cols] for r in traced.timeline[:TRACE_HOST_CAP]]:
        fail("3t: the host loop's timeline differs from the fused loop's")
    for f in COUNTER_FIELDS:
        if sum(r[f] for r in traced.timeline) != getattr(traced.metrics, f):
            fail(f"3t: the SSSP timeline's {f} does not sum to the run's")
    t_ms = traced.metrics.wall_time_s * 1e3 / TRACE_CAP
    u_ms = untraced.metrics.wall_time_s * 1e3 / TRACE_CAP
    log(f"[trace] 3t sssp SA capped at {TRACE_CAP} supersteps: traced "
        f"bitwise equal to untraced (host_syncs {traced.host_syncs}); "
        f"{t_ms!r} ms per superstep traced, {u_ms!r} untraced "
        f"({t_ms / u_ms!r}x); host loop at {TRACE_HOST_CAP}: integer "
        f"columns equal to the fused rows, {host.metrics.wall_time_s!r} s; "
        f"sweep launches {launch_counts()[0]}")
    del traced, untraced, host

    # -- a recorded S = 8 SSSP stream and a query batch on it ----------------
    t0 = time.perf_counter()
    g = G.powerlaw_graph(BFS_STREAM_N, avg_deg=AVG_DEG, seed=TRACE_SEED,
                         weighted=True)
    batches = synthetic_stream(g, 2, 200, seed=TRACE_SEED, delete_frac=0.2,
                               weighted=True)
    zero_counts()
    torch.cuda.synchronize()
    with obs_trace.recording() as rec:
        se = StreamingEngine(g, A.sssp(0), EngineConfig(
            block_size=BLOCK, width=WIDTH, t2=T2, subblocks=SUB,
            max_iterations=SA_CAP), device=DEV)
        reps = [se.ingest(b) for b in batches]
        svc = QueryService(se, max_lanes=LANES)
        srcs = [int(v) for v in np.random.default_rng(TRACE_SEED).choice(
            g.n, LANES, replace=False)]
        for v in srcs:
            svc.submit(Query(kind="sssp", source=v))
        answers = svc.run_pending()
        torch.cuda.synchronize()
    n1m = launch_counts()[1]
    n1lm = lane_counts()[1]
    spans = [e for e in rec.events if e["type"] == "span"]
    ing = [e for e in spans if e["name"] == "ingest"]
    qb = [e for e in spans if e["name"] == "query_batch"]
    if not all(r.converged for r in reps) or len(ing) != len(reps) \
            or [e["args"]["iterations"] for e in ing] != \
            [r.iterations for r in reps]:
        fail("3t: the ingest spans do not carry their reports' iterations")
    if len(qb) != 1 or qb[0]["args"]["iterations"] != \
            svc.last_batch.metrics.iterations \
            or qb[0]["args"]["lanes"] != LANES:
        fail("3t: the query_batch span does not carry the batch's "
             "iterations")
    if not nested_spans(rec, "ingest", ("reconverge", "run", "chunk")):
        fail("3t: the spans do not nest as ingest > reconverge > run > "
             "chunk")
    if n1m == 0 or n1lm == 0 or rec.dropped:
        fail(f"3t: the recorded stream launched 1m {n1m} and 1lm {n1lm} "
             f"times, {rec.dropped} events dropped")
    check_answers("3t", answers, srcs, se.current_graph(), "sssp", se.epoch)
    names = sorted({e["name"] for e in spans})
    batch_cols = [(r.inserts, r.deletes, r.iterations) for r in reps]
    log(f"[trace] 3t recorded S={SUB} sssp stream on powerlaw_graph("
        f"n={g.n}): batches {batch_cols} (+, -, supersteps), spans "
        f"{names} nest as ingest > reconverge > "
        f"run > chunk; query batch of {LANES} lanes, "
        f"{svc.last_batch.metrics.iterations} supersteps, span "
        f"{qb[0]['dur']!r} s; launches 1m={n1m} 1lm={n1lm}; "
        f"{len(rec.events)} events, in {time.perf_counter() - t0:.1f} s")
    del rec, se, svc, answers

    # -- betweenness through both engines on the card ------------------------
    t0 = time.perf_counter()
    g = G.powerlaw_graph(BFS_STREAM_N, avg_deg=AVG_DEG, seed=TRACE_SEED + 1)
    cfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=T2,
                       max_iterations=SA_CAP)
    zero_counts()
    bc_sa, m_sa = betweenness(g, BC_SOURCES, cfg, structure_aware=True,
                              device=DEV)
    n1 = launch_counts()[0]
    bc_b, m_b = betweenness(g, BC_SOURCES, cfg, structure_aware=False,
                            device=DEV)
    if not (np.array_equal(bc_sa, bc_b) and np.all(np.isfinite(bc_sa))
            and bc_sa.shape == (g.n,) and np.all(bc_sa >= 0)
            and bc_sa.any()):
        fail("3t: betweenness through the two engines is not bitwise "
             "equal, finite and non-negative")
    if n1 == 0:
        fail("3t: betweenness's BFS waves never launched kernel 1")
    log(f"[trace] 3t betweenness on powerlaw_graph(n={g.n}), sources "
        f"{BC_SOURCES}: both engines bitwise equal, max bc "
        f"{float(bc_sa.max())!r}; SA {m_sa.iterations} supersteps "
        f"{m_sa.updates} updates, baseline {m_b.iterations} iterations "
        f"{m_b.updates} updates; kernel 1 launches (SA) {n1}; in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"[time] phase 3t ends at {time.perf_counter() - t_start:.1f} s")


def bitwise_state(a: dict, b: dict) -> list:
    """The names of the tensors of two states that differ in any bit."""
    import torch

    def same(x, y):
        if x.dtype.is_floating_point:
            return x.shape == y.shape and same_bits(x, y)
        return torch.equal(x, y)

    return [k for k in a if not same(a[k], b[k])]


def chunk_without_sync(label, make_state, call, counts):
    """One chunk from ``make_state()`` under
    torch.cuda.set_sync_debug_mode("error"), then its twin from a second
    ``make_state()`` without the mode: fails if the first call synchronizes
    or if any tensor of the two states (in place and returned) differs in a
    bit. ``call(state)`` enqueues the chunk and returns its new tensors by
    name; ``counts()`` reads the launch counts that show its kernel ran.
    Returns the first call's launches."""
    import torch
    first, twin = make_state(), make_state()
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first.update(call(first))
    except RuntimeError as err:
        fail(f"3c: {label}: a host sync inside the chunk: {err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    launches = counts()
    torch.cuda.synchronize()
    twin.update(call(twin))
    torch.cuda.synchronize()
    differ = bitwise_state(first, twin)
    if differ:
        fail(f"3c: {label}: the chunk under the debug mode differs from "
             f"its twin in {differ}")
    if not launches:
        fail(f"3c: {label}: the chunk launched no kernel")
    log(f"[contracts] 3c {label}: the run's first chunk "
        f"({int(first['it'])} supersteps), {launches} kernel launches, under "
        f"torch.cuda.set_sync_debug_mode('error'): no host sync; "
        f"{', '.join(first)} bitwise the twin's without the mode")
    return launches


def engine_chunk(sa, trace_cap=None):
    """(make_state, call) of the structure-aware engine's chunk from a cold
    run's first boundary (superstep 0), over the run's first chunk at the
    width the run picks."""
    import torch
    from repro_torch.core import state as state_lib
    from repro_torch.core.engine import (TIMELINE_FLOAT_COLS,
                                         TIMELINE_INT_COLS)
    p, dev = sa.plan, sa.device
    _, _, psd_host, rep, calm_host, i2 = sa._start_state(None)
    span = rep.chunk_end(SA_CAP)
    wb = sa._pick_width(sa._active_count(calm_host),
                        state_lib.fold_subblock_psd(psd_host))
    is_hot = torch.as_tensor(rep.is_hot).to(dev)
    acct = torch.as_tensor(sa._acct_table()).to(dev)
    chunk = sa._get_chunk(wb, trace_cap)

    def make_state():
        values, psd, _, _, calm, _ = sa._start_state(None)
        st = dict(values=values, psd=psd, dmax=torch.zeros_like(psd),
                  calm=torch.as_tensor(calm).to(dev),
                  counts=torch.zeros(p.num_blocks, dtype=torch.int32,
                                     device=dev),
                  hslots=torch.zeros(wb, dtype=torch.int32, device=dev),
                  sbacc=torch.zeros((), dtype=torch.int64, device=dev),
                  it=torch.zeros((), dtype=torch.int64, device=dev))
        if trace_cap is not None:
            st["hist_i"] = torch.zeros((trace_cap, len(TIMELINE_INT_COLS)),
                                       dtype=torch.int64, device=dev)
            st["hist_f"] = torch.zeros(
                (trace_cap, len(TIMELINE_FLOAT_COLS)), device=dev)
        return st

    def call(st):
        hist = (() if trace_cap is None
                else (acct, st["hist_i"], st["hist_f"]))
        psd, dmax, calm = chunk(
            sa._ed, sa._coupling_dev, st["values"], st["psd"], st["dmax"],
            st["calm"], st["counts"], st["hslots"], st["sbacc"], st["it"],
            is_hot, 0, span, i2, *hist)
        return dict(psd=psd, dmax=dmax, calm=calm)

    return make_state, call


def lane_chunk(sa, sources):
    """(make_state, call) of a k_sssp lane batch's chunk on ``sa``'s
    epoch, from the batch's first boundary, as ``LaneEngine.run`` starts
    it."""
    import numpy as np
    import torch
    from repro_torch.core import algorithms as A
    from repro_torch.core import state as state_lib
    from repro_torch.core.engine import dispatch_width
    from repro_torch.kernels import block_sweep as kb
    from repro_torch.serve.lanes import LaneEngine
    p, cfg, dev = sa.plan, sa.config, sa.device
    lane = LaneEngine(sa, A.k_source_sssp())
    nl = len(sources)
    values0, _ = lane.program.lane_init(p.graph.n, sources)
    start = lane._start_state(values0, None, np.ones(nl, bool))
    rep = start[5]
    span = rep.chunk_end(SERVE_CAP)
    wb = dispatch_width(cfg, sa._ladder, sa._active_count(start[4]),
                        state_lib.fold_lane_psd(start[2], start[3]))
    is_hot = torch.as_tensor(rep.is_hot).to(dev)
    scratch = kb.make_lane_scratch(sa.edge_state, p.block_size, nl)
    chunk = lane._get_chunk(wb)

    def make_state():
        vals, vc, psd, done, calm, _ = lane._start_state(
            values0, None, np.ones(nl, bool))
        psd = torch.tensor(psd, device=dev)
        return dict(values=torch.tensor(vals, device=dev),
                    vconst=torch.tensor(vc, device=dev), psd=psd,
                    dmax=torch.zeros_like(psd),
                    calm=torch.tensor(calm, device=dev),
                    lane_done=torch.tensor(done, device=dev),
                    lane_it=torch.zeros(nl, dtype=torch.int64, device=dev),
                    counts=torch.zeros(p.num_blocks, dtype=torch.int32,
                                       device=dev),
                    hslots=torch.zeros(wb, dtype=torch.int32, device=dev),
                    sbacc=torch.zeros((), dtype=torch.int64, device=dev),
                    it=torch.zeros((), dtype=torch.int64, device=dev))

    def call(st):
        out = chunk(sa.edge_state, sa._coupling_dev, st["vconst"],
                    st["values"], st["psd"], st["dmax"], st["calm"],
                    st["counts"], st["hslots"], st["sbacc"], st["lane_done"],
                    st["lane_it"], st["it"], is_hot, 0, span, cfg.i2,
                    scratch)
        return dict(zip(("psd", "dmax", "calm", "lane_done", "lane_it"),
                        out))

    return make_state, call


def contracts_phase(engines, t_start):
    """Phase 3c: the port's contract checker on the card, in a subprocess,
    beside the chunks of phase 3's engines (and of an S = 8 engine at
    CONTRACT_N) run under torch.cuda.set_sync_debug_mode("error")."""
    import os
    import numpy as np
    from repro_torch.core import algorithms as A
    from repro_torch.core import graph as G
    from repro_torch.core.engine import EngineConfig, StructureAwareEngine
    t0 = time.perf_counter()

    def checker():
        # (a) python -m repro_torch.analysis --check on the card
        t = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--check",
             "--device", DEV], cwd=ROOT, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            timeout=CONTRACT_TIMEOUT)
        return out, time.perf_counter() - t

    # started first, so that it runs beside (b); subprocess.run kills it
    # at its time limit
    with ThreadPoolExecutor(1) as pool:
        sub = pool.submit(checker)
        # (b) the chunks, each from a run's first boundary
        launches = {}
        pr, sssp = engines["pagerank"][0], engines["sssp"][0]
        crng = np.random.default_rng(CONTRACT_SEED)
        sources = [int(v) for v in crng.choice(sssp.plan.graph.n, LANES,
                                               replace=False)]

        def kernel_1():
            return launch_counts()[0]

        def kernel_1m():
            return launch_counts()[1]

        def kernel_1l():
            return lane_counts()[0]

        def kernel_1lm():
            return lane_counts()[1]

        launches["1"] = chunk_without_sync(
            "pagerank chunk (kernel 1)", *engine_chunk(pr), kernel_1)
        launches["1"] += chunk_without_sync(
            "pagerank traced chunk, trace cap 16 (kernel 1)",
            *engine_chunk(pr, 16), kernel_1)
        launches["1"] += chunk_without_sync(
            "sssp chunk (kernel 1)", *engine_chunk(sssp), kernel_1)
        launches["1l"] = chunk_without_sync(
            f"sssp lane chunk, L = {LANES} (kernel 1l)",
            *lane_chunk(sssp, sources), kernel_1l)
        g8 = G.powerlaw_graph(CONTRACT_N, avg_deg=AVG_DEG, seed=2,
                              weighted=True)
        e8 = StructureAwareEngine(g8, A.sssp(0), EngineConfig(
            block_size=BLOCK, width=WIDTH, t2=T2, subblocks=SUB),
            device=DEV)
        launches["1m"] = chunk_without_sync(
            f"sssp S={SUB} chunk on powerlaw_graph(n={g8.n}) (kernel 1m)",
            *engine_chunk(e8), kernel_1m)
        launches["1lm"] = chunk_without_sync(
            f"sssp S={SUB} lane chunk, L = {LANES}, on powerlaw_graph("
            f"n={g8.n}) (kernel 1lm)",
            *lane_chunk(e8, [int(v) for v in crng.choice(
                g8.n, LANES, replace=False)]), kernel_1lm)
        del e8, g8
        b_s = time.perf_counter() - t0
        proc, sub_s = sub.result()
    out, err = proc.stdout, proc.stderr
    lines = out.strip().splitlines()
    summary = [x for x in lines if x.startswith("repro_torch.analysis:")]
    golden = [x for x in lines if x.startswith("golden ops:")]
    if proc.returncode != 0 or not summary:
        fail(f"3c: python -m repro_torch.analysis --check exited "
             f"{proc.returncode}:\n{out}\n{err}")
    log(f"[contracts] 3c python -m repro_torch.analysis --check on "
        f"{DEV}: exit {proc.returncode}; {summary[-1]}; "
        f"{golden[-1] if golden else 'golden ops: not reported'}")
    log(f"[contracts] 3c launches under the debug mode: {launches}; phase "
        f"3c took {time.perf_counter() - t0:.1f} s (the chunks {b_s:.1f} s, "
        f"the checker's subprocess {sub_s:.1f} s beside them)")
    log(f"[time] phase 3c ends at {time.perf_counter() - t_start:.1f} s")


def contracts_alone() -> int:
    """``--contracts-phase``: phase 3c alone, in one process: it builds the
    sweep kernel and phase 3's graphs and engines (no runs: the chunks
    start from a run's first boundary), then ``contracts_phase``. No
    result line."""
    import torch
    from repro_torch.kernels import _build
    t_start = time.perf_counter()
    log(f"[device] {card_line()}; torch {torch.__version__}")
    _build.build("block_sweep")
    engines, _ = main_path_engines(baseline=False)
    contracts_phase(engines, t_start)
    return 0


def spill_line(m) -> str:
    """A run's (or a batch report's) spill counters, as printed."""
    asked = m.prefetch_hits + m.prefetch_misses
    return (f"evictions={m.spill_evictions} spilled_MB="
            f"{m.bytes_spilled / 1e6!r} fetched_MB={m.bytes_fetched / 1e6!r} "
            f"hits={m.prefetch_hits} misses={m.prefetch_misses} "
            f"hit_rate={m.prefetch_hits / asked if asked else 1.0!r}")


def algo_key(res):
    """What a run under a budget must reproduce of the resident run: the
    values aside, every counter but the spill tier's and the wall clock
    (paged chunks are one superstep each, so host syncs differ too)."""
    import dataclasses
    m = dataclasses.asdict(res.metrics)
    for k in ("wall_time_s", "spill_evictions", "bytes_spilled",
              "prefetch_hits", "prefetch_misses", "bytes_fetched"):
        del m[k]
    return m


def ooc_phase(engines, results, sa_launches, t_start):
    """Phase 3o: the out-of-core tier and epoch persistence, after phase 3t,
    on phase 3's PageRank engine and plan; its launches are counted apart
    from phase 3's. Returns the launches of kernels 1, 1m and 1lm."""
    import dataclasses
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import algorithms as A
    from repro_torch.core import graph as G
    from repro_torch.core.engine import (TIMELINE_INT_COLS, EngineConfig,
                                         StructureAwareEngine)
    from repro_torch.core.metrics import COUNTER_FIELDS
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import Query, QueryService
    from repro_torch.stream import StreamingEngine, synthetic_stream
    t_phase = time.perf_counter()
    card = card_line()
    counts = {"1": 0, "1m": 0, "1lm": 0}
    # -- a. the main path under a budget of P / 4 resident blocks ----------
    sa = engines["pagerank"][0]
    P = sa.plan.num_blocks
    budget = P // 4
    t0 = time.perf_counter()
    eng = StructureAwareEngine.from_plan(
        sa.plan, sa.program, dataclasses.replace(sa.config,
                                                 resident_blocks=budget),
        sa.values0, sa.aux, sa._coupling, sa.barrier_block, device=DEV)
    log(f"[ooc] 3o pagerank engine under a budget of {budget} of {P} blocks "
        f"built from phase 3's plan in {time.perf_counter() - t0:.1f} s")
    if OOC_CAP is None:
        plain, cap, n_plain = (results[("pagerank", "structure-aware")],
                               SA_CAP, sa_launches["pagerank"])
    else:
        cap = OOC_CAP
        zero_counts()
        torch.cuda.synchronize()
        plain = sa.run(max_iterations=cap)
        torch.cuda.synchronize()
        n_plain = launch_counts()[0]
    zero_counts()
    torch.cuda.synchronize()
    res = eng.run(max_iterations=cap)
    torch.cuda.synchronize()
    n1 = launch_counts()[0]
    counts["1"] += n1
    m = res.metrics
    if not np.array_equal(res.values, plain.values) \
            or algo_key(res) != algo_key(plain) or n1 == 0:
        fail("3o: the pagerank run under a budget differs from the "
             f"resident run (kernel 1 launches {n1})")
    if m.spill_evictions == 0 or int(eng.spill.resident.sum()) > budget:
        fail("3o: the budget did not bind or was exceeded")
    slow = m.wall_time_s / plain.metrics.wall_time_s
    log(f"[ooc] 3o pagerank SA under a budget of {budget}/{P} blocks"
        f"{'' if OOC_CAP is None else f', capped at {cap} supersteps'}: "
        f"iterations={m.iterations} converged={m.converged}, values and "
        f"counters bitwise equal to the resident run's; kernel 1 launches "
        f"{n1} against {n_plain} (a resident chunk also enqueues its "
        f"supersteps past convergence, as no-ops); wall_s="
        f"{m.wall_time_s!r} against "
        f"{plain.metrics.wall_time_s!r} ({slow!r}x); host_syncs="
        f"{res.host_syncs} against {plain.host_syncs}; {spill_line(m)}; "
        f"{card}")
    del res, plain
    # the host loop under the same budget, against the resident host loop
    host_plain = sa.run(max_iterations=TRACE_HOST_CAP, fused=False)
    torch.cuda.synchronize()
    zero_counts()
    host = eng.run(max_iterations=TRACE_HOST_CAP, fused=False)
    torch.cuda.synchronize()
    counts["1"] += launch_counts()[0]
    if not np.array_equal(host.values, host_plain.values) \
            or algo_key(host) != algo_key(host_plain):
        fail("3o: the host loop under a budget differs from the resident "
             "host loop")
    log(f"[ooc] 3o host loop at {TRACE_HOST_CAP} supersteps under the "
        f"budget bitwise equal to the resident host loop; wall_s="
        f"{host.metrics.wall_time_s!r} against "
        f"{host_plain.metrics.wall_time_s!r}; {spill_line(host.metrics)}")
    del host, host_plain
    # one capped budget run, traced under a recorder
    traced_plain = sa.run(max_iterations=OOC_TRACE_CAP, trace=True)
    zero_counts()
    torch.cuda.synchronize()
    with obs_trace.recording() as rec:
        traced = eng.run(max_iterations=OOC_TRACE_CAP, trace=True)
    torch.cuda.synchronize()
    counts["1"] += launch_counts()[0]
    cols = TIMELINE_INT_COLS + ("width", "superstep")
    if [[r[c] for c in cols] for r in traced.timeline] != \
            [[r[c] for c in cols] for r in traced_plain.timeline]:
        fail("3o: the traced budget run's timeline differs from the "
             "resident traced run's")
    for f in COUNTER_FIELDS:
        if sum(r[f] for r in traced.timeline) != getattr(traced.metrics, f):
            fail(f"3o: the traced budget run's {f} does not sum to the "
                 "run's")
    ooc = [e for e in rec.events if e["type"] == "span"
           and e["cat"] == "ooc"]
    names = {e["name"] for e in ooc}
    if names != {"spill_evict", "prefetch"} or rec.dropped:
        fail(f"3o: the traced budget run's ooc spans are {sorted(names)}, "
             f"{rec.dropped} events dropped")
    fetched = sum(e["args"]["bytes"] for e in ooc if e["name"] == "prefetch")
    if fetched != traced.metrics.bytes_fetched:
        fail("3o: the prefetch spans' bytes do not sum to bytes_fetched")
    log(f"[ooc] 3o traced budget run at {OOC_TRACE_CAP} supersteps: "
        f"{len(traced.timeline)} rows equal to the resident traced run's "
        f"and summing to its counters; "
        f"{sum(e['name'] == 'spill_evict' for e in ooc)} spill_evict and "
        f"{sum(e['name'] == 'prefetch' for e in ooc)} prefetch spans, "
        f"{sum(e['dur'] for e in ooc)!r} s in them of "
        f"{traced.metrics.wall_time_s!r} s")
    del traced, traced_plain, rec, eng
    gc.collect()
    # the same budget on the disk tier: npz segments, no host cache and no
    # row source, so every fetch reads its blocks back from disk
    with tempfile.TemporaryDirectory() as seg_dir:
        disk = StructureAwareEngine.from_plan(
            sa.plan, sa.program, dataclasses.replace(
                sa.config, resident_blocks=budget, spill_dir=seg_dir),
            sa.values0, sa.aux, sa._coupling, sa.barrier_block, device=DEV)
        if disk.spill is None or disk.spill.keep_host \
                or disk.spill.row_source is not None:
            fail("3o: the disk-tier engine's payloads are not on disk")
        plain = sa.run(max_iterations=OOC_DISK_CAP)
        torch.cuda.synchronize()
        zero_counts()
        res = disk.run(max_iterations=OOC_DISK_CAP)
        torch.cuda.synchronize()
        n1 = launch_counts()[0]
        counts["1"] += n1
        # every segment written and the writer stopped before the
        # directory goes
        disk.spill.close()
        segments = sum(f.endswith(".npz") for f in os.listdir(seg_dir))
    m = res.metrics
    if not np.array_equal(res.values, plain.values) \
            or algo_key(res) != algo_key(plain) or n1 == 0 \
            or m.bytes_fetched == 0 or segments == 0:
        fail("3o: the disk-tier run differs from the resident run, or "
             f"fetched nothing from disk (kernel 1 launches {n1}, "
             f"{segments} segments)")
    log(f"[ooc] 3o disk tier (npz segments, no host cache) at "
        f"{OOC_DISK_CAP} supersteps under the budget bitwise equal to the "
        f"resident run; wall_s={m.wall_time_s!r} against "
        f"{plain.metrics.wall_time_s!r} "
        f"({m.wall_time_s / plain.metrics.wall_time_s!r}x); {segments} "
        f"segments on disk; {spill_line(m)}; {card}")
    del res, plain, disk
    gc.collect()
    torch.cuda.empty_cache()

    # -- b. streaming, persistence and pins under a budget -----------------
    t0 = time.perf_counter()
    g = G.powerlaw_graph(BFS_STREAM_N, avg_deg=AVG_DEG, seed=OOC_SEED,
                         weighted=True)
    cfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=T2, subblocks=SUB,
                       max_iterations=SA_CAP)
    orng = np.random.default_rng(OOC_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        bcfg = dataclasses.replace(cfg, resident_blocks=WIDTH + 2,
                                   spill_dir=str(Path(tmp) / "spill"))
        zero_counts()
        torch.cuda.synchronize()
        se = StreamingEngine(g, A.sssp(0), bcfg, device=DEV)
        twin = StreamingEngine(g, A.sssp(0), cfg, device=DEV)
        torch.cuda.synchronize()
        counts["1m"] += launch_counts()[1]
        spill = se.engine.spill
        init = se.initial_result.metrics
        if spill is None or spill.keep_host or not init.converged \
                or not np.array_equal(se.values, twin.values):
            fail("3o: the budget stream's bootstrap is not its resident "
                 "twin's, or its tier is not on disk")
        log(f"[ooc] 3o sssp stream S={SUB} on powerlaw_graph(n={g.n}), "
            f"P={se.engine.plan.num_blocks}, budget {spill.budget} with npz "
            f"segments: bootstrap {init.iterations} supersteps bitwise equal "
            f"to the resident twin's; {spill_line(init)}; built in "
            f"{time.perf_counter() - t0:.1f} s")
        batches = synthetic_stream(g, 3, 200, seed=OOC_SEED, delete_frac=0.2,
                                   weighted=True)
        fields = ("iterations", "edges_processed", "dirty_blocks",
                  "dirty_subblocks", "vertices_reset", "converged",
                  "blocks_retired", "bytes_uploaded")
        for i, b in enumerate(batches[:2]):
            zero_counts()
            torch.cuda.synchronize()
            r = se.ingest(b)
            torch.cuda.synchronize()
            n1m = launch_counts()[1]
            counts["1m"] += n1m
            rt = twin.ingest(b)
            if not np.array_equal(se.values, twin.values) or [
                    getattr(r, f) for f in fields] != [
                    getattr(rt, f) for f in fields] or n1m == 0:
                fail(f"3o: budget stream batch {i} differs from its resident "
                     f"twin (kernel 1m launches {n1m})")
            log(f"[ooc] 3o batch {i}: +{r.inserts} -{r.deletes} "
                f"iterations={r.iterations} latency_s={r.latency_s!r} "
                f"(resident twin {rt.latency_s!r}), bitwise equal to the "
                f"twin; 1m launches {n1m}; {spill_line(r)}")
        # queries pinned while blocks are spilled, answered after an ingest
        svc = QueryService(se, max_lanes=LANES)
        g0, e0 = se.current_graph(), se.epoch
        srcs = [int(v) for v in orng.choice(g.n, LANES, replace=False)]
        if spill.spilled_blocks.size == 0:
            fail("3o: no block is spilled when the queries pin the epoch")
        for v in srcs:
            svc.submit(Query(kind="sssp", source=v))
        svc.ingest(batches[2])
        zero_counts()
        answers, lane_launches = serve_pending("3o", svc, se)
        counts["1lm"] += int(lane_launches[1])
        if lane_launches[1] == 0:
            fail("3o: kernel 1lm never launched on the pinned epoch")
        check_answers("3o", answers, srcs, g0, "sssp", e0)
        del svc, answers
        # save, then restore without and with the verification pass
        ck = str(Path(tmp) / "epoch")
        t0 = time.perf_counter()
        se.save_epoch(ck).wait()
        save_s = time.perf_counter() - t0
        raw = StreamingEngine.restore(
            ck, A.sssp(0), dataclasses.replace(
                bcfg, spill_dir=str(Path(tmp) / "spill2")), verify=False,
            device=DEV)
        if not np.array_equal(raw.values, se.values) \
                or raw.epoch != se.epoch:
            fail("3o: restore(verify=False) is not the saved epoch")
        raw.engine.spill.close()
        del raw
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = StreamingEngine.restore(
            ck, A.sssp(0), dataclasses.replace(
                bcfg, spill_dir=str(Path(tmp) / "spill3")), device=DEV)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        counts["1m"] += launch_counts()[1]
        warm = back.initial_result.metrics
        if not (warm.converged and np.array_equal(back.values, se.values)
                and warm.iterations < init.iterations / 2):
            fail(f"3o: restore(verify=True) took {warm.iterations} "
                 f"supersteps against the cold bootstrap's "
                 f"{init.iterations}, or its values are not the live ones")
        log(f"[ooc] 3o epoch {se.epoch} saved in {save_s:.2f} s; "
            f"restore(verify=False) bitwise; restore(verify=True) under the "
            f"budget in {restore_s:.2f} s: {warm.iterations} supersteps "
            f"against the cold bootstrap's {init.iterations}, bitwise equal "
            f"to the live values; {spill_line(warm)}")
        # drain and stop the segment writers before the directory goes
        se.engine.spill.close()
        back.engine.spill.close()
        del se, twin, back
    log(f"[ooc] 3o launches: kernel 1 {counts['1']}, 1m {counts['1m']}, "
        f"1lm {counts['1lm']}; phase 3o took "
        f"{time.perf_counter() - t_phase:.1f} s")
    log(f"[time] phase 3o ends at {time.perf_counter() - t_start:.1f} s")
    return counts


def ooc_alone() -> int:
    """``--ooc-phase``: phase 3o alone, in one process: it builds the sweep
    kernel and phase 3's PageRank graph and engine, runs it resident
    (phase 3's run), then ``ooc_phase``. No result line."""
    import torch
    from repro_torch.kernels import _build
    t_start = time.perf_counter()
    log(f"[device] {card_line()}; torch {torch.__version__}")
    _build.build("block_sweep")
    engines, _ = main_path_engines(baseline=False, names=("pagerank",))
    sa = engines["pagerank"][0]
    zero_counts()
    torch.cuda.synchronize()
    res = sa.run(max_iterations=SA_CAP)
    torch.cuda.synchronize()
    launches = {"pagerank": launch_counts()[0]}
    log(f"[run] pagerank structure-aware: iterations="
        f"{res.metrics.iterations} wall_s={res.metrics.wall_time_s!r} "
        f"host_syncs={res.host_syncs} sweep_launches={launches['pagerank']}")
    ooc_phase(engines, {("pagerank", "structure-aware"): res}, launches,
              t_start)
    return 0


@contextlib.contextmanager
def group_of_one():
    """A process group of one rank (NCCL on the card) over a FileStore in a
    temporary directory, destroyed on the way out."""
    import tempfile
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if DEV == "cuda" else "gloo", rank=0, world_size=1,
            store=dist.FileStore(str(Path(tmp) / "store"), 1))
        try:
            yield
        finally:
            dist.destroy_process_group()


def distributed_phase(g, rng, t_start):
    """Phase 6 on a process group of one rank (NCCL on the card) over a
    FileStore: 6a on the PageRank engine's storage, then 6b's runs, each
    engine's storage checked by 6a's check before its run. Returns the
    runs' combine launches, 6a's errors, hub-row and cold-pass times."""
    import torch
    from repro_torch.core import algorithms as A
    from repro_torch.core import graph as G
    from repro_torch.core.baseline import BaselineEngine
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.core.engine import EngineConfig
    if DEV == "cuda":
        torch.cuda.set_device(0)
    dcfg = dict(block_size=DIST_BLOCK, width=WIDTH, max_iterations=SA_CAP)
    launches = {}

    def build(gd, prog, t2):
        t0 = time.perf_counter()
        eng = DistributedEngine(gd, prog, EngineConfig(t2=t2, **dcfg),
                                device=DEV)
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    with group_of_one():
        t0 = time.perf_counter()
        eng, build_s = build(g, A.pagerank(), T2_PAGERANK)
        hot, cold = eng._stores["hot"], eng._stores["cold"]
        log(f"[dist] pagerank engine on n={g.n} built in {build_s:.1f} "
            f"s: hot group {hot.num_blocks} x {hot.capacity} slots "
            f"({int(hot.edges.sum())} true edges, {int(hot.edges.max())} "
            f"in the hub row), cold group {cold.num_blocks} x "
            f"{cold.capacity} ({int(cold.edges.sum())} true edges), "
            f"padded storage {eng.storage_bytes()} B")
        layouts = segment_layouts(eng)
        segment_row_stats(eng, layouts)
        errs = segment_check("pagerank graph", eng, layouts,
                             SEGMENT_PROGRAMS, rng)
        for op, err in segment_unsorted_check(DIST_BLOCK, rng).items():
            errs[op] = max(errs[op], err)
        hub_t, cold_t = segment_times(eng, layouts, rng)
        del layouts, hot, cold
        log(f"[kernel] 6a done in {time.perf_counter() - t0:.1f} s")
        log(f"[time] phase 6b starts at "
            f"{time.perf_counter() - t_start:.1f} s")
        del eng
        for op, prog, n in (("sum", A.pagerank(), DIST_N),
                            ("min", A.sssp(0), DIST_N),
                            ("max", A.cc(), DIST_CC_N)):
            if op == "sum":
                gd = G.core_periphery_graph(n, avg_deg=AVG_DEG, seed=1,
                                            chords=1)
                t2, kind = T2 * 20000 / n, "core_periphery_graph"
            else:
                gd = G.powerlaw_graph(n, avg_deg=AVG_DEG, seed=2,
                                      weighted=True)
                t2, kind = T2, "powerlaw_graph"
            cfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=t2)
            base = BaselineEngine(gd, prog, cfg, frontier=False,
                                  device=DEV).run(max_iterations=BASE_CAP)
            if not base.metrics.converged:
                fail(f"{prog.name} baseline on n={gd.n} did not converge")
            eng, build_s = build(gd, prog, t2)
            label = f"{prog.name} graph (n={gd.n})"
            got = segment_check(label, eng, segment_layouts(eng),
                                [(op, prog.name)], rng)
            errs[op] = max(errs[op], got[op])
            launches[op] = dist_run(
                f"{prog.name} distributed on {kind}(n={gd.n})", eng,
                build_s, op, base.values, exact=op != "sum")
            del eng
    log("[check] distributed runs: pagerank within rtol=1e-4, atol=2e-3/n of "
        "the baseline; sssp and cc bitwise equal to the baseline")
    return launches, errs, hub_t, cold_t


def segment_repeats(repeats: int) -> int:
    """``--segment-repeats N``: phase 6a alone, its times taken ``repeats``
    times in this one process. It builds the segment kernels, phase 6's
    PageRank engine on phase 3's graph, runs 6a's checks once and its
    times ``repeats`` times, and prints each repetition's cold-pass and
    hub-row readings as one JSON line. No result line: the smoke run is
    the one without arguments."""
    import numpy as np
    import torch
    from repro_torch.core import algorithms as A
    from repro_torch.core import graph as G
    from repro_torch.core.distributed import DistributedEngine
    from repro_torch.core.engine import EngineConfig
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    log(f"[device] {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    _build.build("segment_combine")
    rng = np.random.default_rng(SEED)
    g = G.core_periphery_graph(N, avg_deg=AVG_DEG, seed=1, chords=1)
    torch.cuda.set_device(0)
    readings = []
    with group_of_one():
        eng = DistributedEngine(g, A.pagerank(), EngineConfig(
            t2=T2_PAGERANK, block_size=DIST_BLOCK, width=WIDTH,
            max_iterations=SA_CAP), device=DEV)
        layouts = segment_layouts(eng)
        segment_row_stats(eng, layouts)
        segment_check("pagerank graph", eng, layouts, SEGMENT_PROGRAMS, rng)
        segment_unsorted_check(DIST_BLOCK, rng)
        for i in range(repeats):
            log(f"[kernel] 6a times, repetition {i + 1} of {repeats}")
            hub_t, cold_t = segment_times(eng, layouts, rng)
            readings.append({op: dict(
                hub_ms=hub_t[op]["ms"], hub_library_ms=hub_t[op]["library_ms"],
                **{k: cold_t[op][k] for k in (
                    "passes", "library_passes", "mean3_ms",
                    "library_mean3_ms", "host_ms", "python_ms")})
                for op in cold_t})
        del eng, layouts
    log(f"[done] in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"segment_repeats": readings}))
    return 0


def main_path_engines(baseline: bool, names=("pagerank", "sssp")):
    """Phase 3's graphs and engines (the structure-aware engine, and with
    ``baseline`` the baseline beside it), with their set-up lines, for the
    cases in ``names``. Returns ``({name: (sa, baseline or None)},
    {name: graph})``."""
    from repro_torch.core import algorithms as A
    from repro_torch.core import graph as G
    from repro_torch.core.baseline import BaselineEngine
    from repro_torch.core.engine import EngineConfig, StructureAwareEngine
    t0 = time.perf_counter()
    cases = {
        "pagerank": lambda: (A.pagerank(), G.core_periphery_graph(
            N, avg_deg=AVG_DEG, seed=1, chords=1), T2_PAGERANK),
        "sssp": lambda: (A.sssp(0), G.powerlaw_graph(
            N, avg_deg=AVG_DEG, seed=2, weighted=True), T2),
    }
    engines, graphs = {}, {}
    # the graphs made side by side (numpy's bulk work releases the GIL),
    # each engine built as soon as its graph is there
    with ThreadPoolExecutor(len(names)) as pool:
        made = {name: pool.submit(cases[name]) for name in names}
        for name in names:
            prog, g, t2 = made[name].result()
            graphs[name] = g
            cfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=t2)
            sa = StructureAwareEngine(g, prog, cfg, device=DEV)
            engines[name] = (sa, BaselineEngine(
                g, prog, cfg, frontier=False, device=DEV)
                if baseline else None)
            log(f"[setup] {name}: n={g.n} m={g.m} P={sa.plan.num_blocks} "
                f"tiles={int(sa.plan.unified.tile_cnt.sum())} hub block "
                f"tiles={int(sa.plan.unified.tile_cnt.max())} "
                f"hot-born={sa.barrier_block}")
    log(f"[setup] graphs and engines built in "
        f"{time.perf_counter() - t0:.1f} s")
    return engines, graphs


def sweep_profile() -> int:
    """``--sweep-profile``: kernels 1, 1m, 1l and 1lm alone, in one
    process: it builds the sweep kernel and phase 3's graphs and engines,
    runs phase 2e on both graphs (the PageRank graph's full sweeps too),
    phase 2d's lane shapes with the full lane sweeps (``lane_shapes_phase``)
    and phase 3's superstep windows, and prints the readings as one JSON
    line. It uses the wrappers' public calls alone, so a copy of it times a
    parent tree's kernels too. No checks against the plain version and no
    result line: the smoke run is the one without arguments."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    log(f"[device] {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    _build.build("block_sweep")
    engines, _ = main_path_engines(baseline=False)
    times = {}
    sweep_shapes_phase(engines, times, np.random.default_rng(SWEEP_SEED),
                       pagerank_full=True)
    lane_shapes_phase(engines, times, np.random.default_rng(LANE_SEED),
                      full=True)
    windows = {name: superstep_windows(f"{name} structure-aware", sa)
               for name, (sa, _) in engines.items()}
    log(f"[done] in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"sweep_profile": {
        "times": {str(k): v for k, v in times.items()},
        "windows": windows}}))
    return 0


def attention_phase():
    """Phase 8a: kernel 4 against its plain version on the card at the
    dense archs' and hymba_1p5b's head shapes, and at three prefill shapes
    on transposed views, where it is also timed. Returns the largest error
    per dtype and the times at llama3p2_1b's prefill shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA

    def heads(arch):
        c = configs.get(arch)
        return c.num_heads, c.num_kv_heads, c.resolved_head_dim

    # the plain version's f32 matmuls in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device=DEV).manual_seed(LM_SEED)
    errs = {}
    for arch in LM_DENSE:
        hq, hkv, d = heads(arch)
        for s in (128, 2048):
            for causal in (True, False):
                for dtype, tol in ((torch.float32, 2e-5),
                                   (torch.bfloat16, 2e-2)):
                    q, k, v = (torch.randn(2, h, s, d, generator=gen,
                                           device=DEV).to(dtype)
                               for h in (hq, hkv, hkv))
                    got = FA.flash_attention(q, k, v, causal=causal)
                    want = FA.flash_attention_ref(q, k, v, causal=causal)
                    torch.cuda.synchronize()
                    got, want = got.float(), want.float()
                    if got.shape != q.shape or not bool(
                            torch.isfinite(got).all()):
                        fail(f"kernel 4 {arch} S={s}: output not finite "
                             f"of shape {tuple(q.shape)}")
                    err = float((got - want).abs().max())
                    if not torch.allclose(got, want, rtol=tol, atol=tol):
                        fail(f"kernel 4 {arch} S={s} causal={causal} "
                             f"{dtype}: off its plain version by {err!r} "
                             f"(tolerance {tol})")
                    errs[dtype] = max(errs.get(dtype, 0.0), err)
    log(f"[kernel] 8a: kernel 4 against its plain version at the heads of "
        f"{', '.join(LM_DENSE)}, B=2, S in (128, 2048), causal and full: max "
        f"abs error f32 {errs[torch.float32]!r} (tolerance 2e-5), bf16 "
        f"{errs[torch.bfloat16]!r} (tolerance 2e-2)")
    # kernel 4 at three prefill shapes (B = 4, S = 2048, bf16, causal) on
    # the model's transposed (B, S, H, D) projections, which the bf16 route
    # reads in place: held against its plain version, then timed beside SDPA
    # and the bound; the plain version timed at llama3p2_1b's alone
    b, s = LM_BATCH, LM_PROMPT
    timed = {}
    for arch in (LM_ARCH, "yi_6b", HYBRID_ARCH):
        hq, hkv, d = heads(arch)
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=DEV).to(
            torch.bfloat16).transpose(1, 2) for h in (hq, hkv, hkv))
        got = FA.flash_attention(q, k, v).float()
        want = FA.flash_attention_ref(q, k, v).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if got.shape != q.shape or not bool(torch.isfinite(got).all()) \
                or not torch.allclose(got, want, rtol=2e-2, atol=2e-2):
            fail(f"kernel 4 {arch} B={b} S={s} on transposed bf16 views: off "
                 f"its plain version by {err!r} (tolerance 2e-2)")
        errs[torch.bfloat16] = max(errs[torch.bfloat16], err)
        del got, want
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v), 20)
        plain_ms = cuda_ms(lambda: FA.flash_attention_ref(q, k, v), 3) \
            if arch == LM_ARCH else None
        # library yardstick (timed here only, never on the path)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20)
        flops = 2 * b * hq * s * s * d
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # o out
        bound_ms = max(flops / BF16_FLOPS_PER_S,
                       nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / BF16_FLOPS_PER_S \
            >= nbytes / HBM_BYTES_PER_S else "bytes"
        timed[arch] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernel] 8a: kernel 4 at {arch}'s prefill shape, B={b} Hq={hq} "
            f"Hkv={hkv} S={s} D={d} bf16 causal, transposed views: max abs "
            f"error {err!r} against its plain version (tolerance 2e-2); "
            f"kernel {ms!r} ms at "
            f"{flops / ms / 1e9:.4g} TFLOP/s, scaled_dot_product_attention "
            f"{library_ms!r} ms at {flops / library_ms / 1e9:.4g} TFLOP/s, "
            f"bound {bound_ms!r} ms ({bound_by}: {flops} flops at "
            f"{BF16_FLOPS_PER_S:.4g}/s, {nbytes} B at "
            f"{HBM_BYTES_PER_S:.3g} B/s)"
            + (f", plain {plain_ms!r} ms" if plain_ms is not None else ""))
    # the f32 route (CUDA cores) once at llama3p2_1b's shape
    hq, hkv, d = heads(LM_ARCH)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=DEV)
               for h in (hq, hkv, hkv))
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v), 5)
    # the library yardstick on the same f32 inputs (timed only)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 5)
    flops = 2 * b * hq * s * s * d
    timed[LM_ARCH].update(f32_ms=ms, f32_library_ms=library_ms)
    log(f"[kernel] 8a: kernel 4's f32 route at {LM_ARCH}'s prefill shape: "
        f"{ms!r} ms at {flops / ms / 1e9:.4g} TFLOP/s (the f32 CUDA-core "
        f"rate {F32_FLOPS_PER_S / 1e12:.4g} TFLOP/s: "
        f"{flops / F32_FLOPS_PER_S * 1e3!r} ms), scaled_dot_product_attention "
        f"on the same f32 inputs {library_ms!r} ms")
    del q, k, v
    # hymba_1p5b's heads (25 q heads over 5 kv heads: an odd GQA group),
    # from a generator of their own so that the draws above stay as they
    # were
    gen = torch.Generator(device=DEV).manual_seed(LM_SEED + 20)
    hq, hkv, d = heads(HYBRID_ARCH)
    hy = {}
    for s in (128, 2048):
        for causal in (True, False):
            for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
                q, k, v = (torch.randn(2, h, s, d, generator=gen,
                                       device=DEV).to(dtype)
                           for h in (hq, hkv, hkv))
                got = FA.flash_attention(q, k, v, causal=causal).float()
                want = FA.flash_attention_ref(q, k, v, causal=causal).float()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not bool(torch.isfinite(got).all()) or not torch.allclose(
                        got, want, rtol=tol, atol=tol):
                    fail(f"kernel 4 {HYBRID_ARCH} S={s} causal={causal} "
                         f"{dtype}: off its plain version by {err!r} "
                         f"(tolerance {tol})")
                hy[dtype] = max(hy.get(dtype, 0.0), err)
                errs[dtype] = max(errs[dtype], err)
    log(f"[kernel] 8a: kernel 4 against its plain version at "
        f"{HYBRID_ARCH}'s heads (Hq={hq}, Hkv={hkv}, D={d}), B=2, S in (128, "
        f"2048), causal and full: max abs error f32 {hy[torch.float32]!r}, "
        f"bf16 {hy[torch.bfloat16]!r}")
    # the moe, vlm and audio families' heads (phi3_vision_4p2b's 32/32 x 96:
    # the D = 96 instantiation of both routes; granite's, deepseek's, and
    # whisper's at its decoder prompt), from a generator of their own
    gen = torch.Generator(device=DEV).manual_seed(LM_SEED + 30)
    for arch, lengths in ((VLM_ARCH, (128, 2048)), (MOE_ARCH, (128, 2048)),
                          (SHARED_MOE_ARCH, (128, 2048)),
                          (AUDIO_ARCH, (AUDIO_PROMPT,))):
        hq, hkv, d = heads(arch)
        fam = {}
        for s in lengths:
            for causal in (True, False):
                for dtype, tol in ((torch.float32, 2e-5),
                                   (torch.bfloat16, 2e-2)):
                    q, k, v = (torch.randn(2, h, s, d, generator=gen,
                                           device=DEV).to(dtype)
                               for h in (hq, hkv, hkv))
                    got = FA.flash_attention(q, k, v, causal=causal).float()
                    want = FA.flash_attention_ref(q, k, v,
                                                  causal=causal).float()
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    if got.shape != q.shape or not bool(
                            torch.isfinite(got).all()) or not torch.allclose(
                            got, want, rtol=tol, atol=tol):
                        fail(f"kernel 4 {arch} S={s} causal={causal} "
                             f"{dtype}: off its plain version by {err!r} "
                             f"(tolerance {tol})")
                    fam[dtype] = max(fam.get(dtype, 0.0), err)
                    errs[dtype] = max(errs[dtype], err)
        log(f"[kernel] 8a: kernel 4 against its plain version at {arch}'s "
            f"heads (Hq={hq}, Hkv={hkv}, D={d}), B=2, S in {lengths}, causal "
            f"and full: max abs error f32 {fam[torch.float32]!r} (tolerance "
            f"2e-5), bf16 {fam[torch.bfloat16]!r} (tolerance 2e-2)")
    # D = 96 at phi3_vision_4p2b's prefill shape (1024 patches and 1024
    # text tokens): the bf16 route on transposed views against its plain
    # version, then timed beside SDPA, the plain version and the bound; the
    # f32 route timed once on contiguous inputs
    b, s = LM_BATCH, LM_PROMPT
    hq, hkv, d = heads(VLM_ARCH)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=DEV).to(
        torch.bfloat16).transpose(1, 2) for h in (hq, hkv, hkv))
    got = FA.flash_attention(q, k, v).float()
    want = FA.flash_attention_ref(q, k, v).float()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if got.shape != q.shape or not bool(torch.isfinite(got).all()) \
            or not torch.allclose(got, want, rtol=2e-2, atol=2e-2):
        fail(f"kernel 4 {VLM_ARCH} B={b} S={s} D={d} on transposed bf16 "
             f"views: off its plain version by {err!r} (tolerance 2e-2)")
    errs[torch.bfloat16] = max(errs[torch.bfloat16], err)
    del got, want
    ms = cuda_ms(lambda: FA.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: FA.flash_attention_ref(q, k, v), 3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    flops = 2 * b * hq * s * s * d
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound_ms = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / BF16_FLOPS_PER_S \
        >= nbytes / HBM_BYTES_PER_S else "bytes"
    q, k, v = (t.float().contiguous() for t in (q, k, v))
    f32_ms = cuda_ms(lambda: FA.flash_attention(q, k, v), 5)
    f32_library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 5)
    del q, k, v
    timed[VLM_ARCH] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           f32_ms=f32_ms, f32_library_ms=f32_library_ms)
    log(f"[kernel] 8a: kernel 4 at {VLM_ARCH}'s prefill shape, B={b} Hq={hq} "
        f"Hkv={hkv} S={s} D={d} bf16 causal, transposed views: max abs error "
        f"{err!r} against its plain version (tolerance 2e-2); kernel {ms!r} "
        f"ms at {flops / ms / 1e9:.4g} TFLOP/s, scaled_dot_product_attention "
        f"{library_ms!r} ms at {flops / library_ms / 1e9:.4g} TFLOP/s, bound "
        f"{bound_ms!r} ms ({bound_by}: {flops} flops at "
        f"{BF16_FLOPS_PER_S:.4g}/s, {nbytes} B at {HBM_BYTES_PER_S:.3g} "
        f"B/s), plain {plain_ms!r} ms; the f32 route {f32_ms!r} ms at "
        f"{flops / f32_ms / 1e9:.4g} TFLOP/s, scaled_dot_product_attention "
        f"on the same f32 inputs {f32_library_ms!r} ms")
    return errs, timed[LM_ARCH], timed[VLM_ARCH]


def lm_close(label, got, want):
    """f32 logits ``got`` within LM_TOL32 of ``want`` (rtol = atol,
    elementwise); returns the largest absolute difference."""
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{label}: not finite of shape {tuple(want.shape)}")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=LM_TOL32, atol=LM_TOL32):
        fail(f"{label}: off by {err!r} (rtol = atol = {LM_TOL32})")
    return err


def lm_as_accurate(label, got, plain, truth, hold_max=True):
    """bf16 logits ``got`` (a route through kernel 4, or the decode path)
    no less accurate than ``plain`` (the reference's plain route in bf16),
    both measured against ``truth`` (the same logits computed in f32): the
    rms error within 1.25x and, with ``hold_max``, the largest within 1.5x
    of the plain route's (an MoE's largest errors are routing flips, which
    hit both routes alike: printed, not held). Returns (max, rms) of
    got - truth, (max, rms) of plain - truth and how many entries of got
    miss the elementwise 5e-2 bar against plain."""
    import torch
    got, plain, truth = got.float(), plain.float(), truth.float()
    if got.shape != truth.shape or not bool(torch.isfinite(got).all()):
        fail(f"{label}: not finite of shape {tuple(truth.shape)}")
    dg, dp = (got - truth).abs(), (plain - truth).abs()
    e = (float(dg.max()), float(dg.pow(2).mean().sqrt()))
    ep = (float(dp.max()), float(dp.pow(2).mean().sqrt()))
    over = int(((got - plain).abs() > LM_TOL + LM_TOL * plain.abs()).sum())
    if e[1] > 1.25 * ep[1] or (hold_max and e[0] > 1.5 * ep[0]):
        fail(f"{label}: error against f32 (max, rms) {e!r}, the plain bf16 "
             f"route's {ep!r}: less accurate than the plain route")
    return e, ep, over


class RouteLog:
    """While active, records the top-k expert ids of every MoE layer call
    (``models.moe.route`` wrapped). With ``pinned`` (another run's
    ``routes``, (L, B, S, k)), each call takes the pinned experts of its
    layer and sequence span instead of its own, with gates from its own
    probabilities (normalized as the router's), and records its own
    choice: two runs then route alike, and what differs is the rest of
    their arithmetic."""

    def __init__(self, pinned=None):
        self.pinned = pinned

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.calls, self._moe, self._route = [], moe, moe.route
        spans = {}  # layer -> next sequence position of the pinned routes

        def route(*args, **kw):
            logits, probs, gates, eidx = self._route(*args, **kw)
            self.calls.append(eidx)
            if self.pinned is None:
                return logits, probs, gates, eidx
            layer = (len(self.calls) - 1) % self.pinned.shape[0]
            s0 = spans.get(layer, 0)
            spans[layer] = s0 + eidx.shape[1]
            eidx = self.pinned[layer][:, s0:s0 + eidx.shape[1]]
            gates = torch.gather(probs, -1, eidx)
            if kw.get("norm_topk", True):
                gates = gates / torch.clamp_min(
                    gates.sum(-1, keepdim=True), 1e-9)
            return logits, probs, gates, eidx
        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def routes(self, num_layers):
        """(L, B, S, k): each layer's calls joined along the sequence (a
        prefill, then one call per decode step), or None without MoE."""
        import torch
        if not self.calls:
            return None
        return torch.stack([torch.cat(self.calls[i::num_layers], dim=1)
                            for i in range(num_layers)])


def routing_flips(label, pinned, own):
    """Prints where a run pinned to another's routes (``RouteLog``) would
    have routed otherwise: its rows, (row, token) pairs and (layer, row,
    token) decisions with another top-k. Returns the decisions' count."""
    if pinned is None:
        return 0
    if pinned.shape != own.shape:
        fail(f"{label}: routes of shapes {tuple(pinned.shape)} and "
             f"{tuple(own.shape)}")
    flip = (pinned != own).any(-1)  # (L, B, S)
    n = int(flip.sum())
    log(f"[check] {label}: routing flips in {int(flip.any(-1).any(0).sum())} "
        f"of {flip.shape[1]} rows, {int(flip.any(0).sum())} of "
        f"{flip.shape[1] * flip.shape[2]} (row, token) pairs, {n} of "
        f"{flip.numel()} (layer, row, token) decisions (the pinned run's "
        f"own top-k against the routes it was given)")
    return n


def ssd_inputs(gen, cells, q, n, h, p, dtype):
    """Kernel 5's heads-form inputs drawn as the model draws them: c, b, x
    normal; dt = softplus(normal + dt_bias) with the bias the inverse
    softplus of a log-uniform dt in [1e-3, 1e-1] per head, A = exp(a_log)
    uniform in [1, 16]; u = x dt and ld the within-chunk cumsum of dt * -A
    (f32). Over a 256-step chunk l_q - l_s then overflows exp above the
    diagonal for the fast heads."""
    import math

    import torch
    import torch.nn.functional as F
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = torch.exp(lo + (hi - lo) * torch.rand(h, generator=gen, device=DEV))
    a = 1.0 + 15.0 * torch.rand(h, generator=gen, device=DEV)
    dt = F.softplus(torch.randn(cells, q, h, generator=gen, device=DEV)
                    + torch.log(torch.expm1(dt0)))
    ld = torch.cumsum(dt * -a, dim=1)
    u = torch.randn(cells, q, h, p, generator=gen, device=DEV) * dt[..., None]
    c, b = (torch.randn(cells, q, n, generator=gen, device=DEV)
            for _ in range(2))
    return c.to(dtype), b.to(dtype), u.to(dtype), ld


def ssd_phase():
    """Phase 8c: kernel 5 against its plain version on the card, then timed
    at mamba2_2p7b's and hymba_1p5b's prefill shapes. Returns the largest
    error and mamba2's times."""
    import torch
    from repro_torch.kernels import ssd_scan as SSD
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device=DEV).manual_seed(SSD_SEED)

    def check(what, c, b, u, ld, rtol, afac):
        got = SSD.ssd_intra_chunk(c, b, u, ld)
        want = SSD.ssd_intra_chunk_ref(c, b, u, ld)
        torch.cuda.synchronize()
        if got.shape != u.shape or got.dtype != u.dtype or not bool(
                torch.isfinite(got.float()).all()):
            fail(f"kernel 5 {what}: output not finite of shape "
                 f"{tuple(u.shape)} {u.dtype}")
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not torch.allclose(got, want, rtol=rtol, atol=afac * scale):
            fail(f"kernel 5 {what}: off its plain version by {err!r} "
                 f"(max |want| {scale!r})")
        return err, scale

    errs, lines = {}, []
    for arch in (SSM_ARCH, HYBRID_ARCH):
        shape = ssd_shape(arch)
        for dtype, tol in ((torch.float32, (1e-5, 1e-4)),
                           (torch.bfloat16, (2e-2, 2e-2))):
            c, b, u, ld = ssd_inputs(gen, *shape, dtype)
            over = int((-ld[:, -1]).gt(88.7).sum())
            if over == 0:
                fail(f"kernel 5 {arch}: no head's decay overflows exp "
                     f"above the diagonal; the inputs miss the case")
            err, scale = check(f"{arch} {dtype}", c, b, u, ld, *tol)
            errs[dtype] = max(errs.get(dtype, 0.0), err)
            lines.append(f"{arch} (cells, Q, N, H, P) = {shape} {dtype}: "
                         f"{err!r} (max |y| {scale!r}; {over} (cell, head) "
                         f"pairs overflow exp above the diagonal)")
    # the reference test's shapes (tests/test_kernels.py:128-129), one head
    for g, q, n, p in ((4, 64, 32, 16), (2, 128, 128, 64), (6, 128, 64, 128)):
        c, b, u = (torch.randn(g, q, k, generator=gen, device=DEV)
                   for k in (n, n, p))
        ld = torch.cumsum(-0.1 * torch.rand(g, q, generator=gen, device=DEV),
                          dim=1)
        err, scale = check(f"(G, Q, N, P) = {(g, q, n, p)}", c, b, u, ld,
                           1e-5, 1e-4)
        errs[torch.float32] = max(errs[torch.float32], err)
        lines.append(f"(G, Q, N, P) = {(g, q, n, p)} f32: {err!r}")
    log("[kernel] 8c: kernel 5 against its plain version (f32 at rtol=1e-5, "
        "atol=1e-4 * max|y|; bf16 at 2e-2 * max|y|): " + "; ".join(lines))
    # kernel 5 alone at both models' prefill shapes, f32 (the model's route)
    times = ssd_times(gen)
    parts = []
    for arch, t in times.items():
        cells, q, n, h, p = t["shape"]
        # the causal term: the Gram c.b once per cell (the heads share c
        # and b), its decayed tile times u once per (cell, head)
        flops = cells * q * (q + 1) * (n + h * p)
        nbytes = 4 * cells * q * (2 * n + (2 * p + 1) * h)
        t_ops, t_bytes = flops / TF32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        t["bound_ms"] = max(t_ops, t_bytes) * 1e3
        t["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        run = ssd_run_flops(cells, q, n, h, p, SSD.head_group(h, n, p))
        profiled = (f"{t['profiled_ms']!r} ms" if t["profiled_ms"] else
                    "not measured, no kernel 5 in its listing")
        parts.append(
            f"{arch} (cells, Q, N, H, P) = {t['shape']}: kernel {t['ms']!r} "
            f"ms (CUDA events over 20 calls; a call on the card by "
            f"torch.profiler: {profiled}), bound {t['bound_ms']!r} ms "
            f"({t['bound_by']}: {nbytes} B at {HBM_BYTES_PER_S:.3g} B/s, "
            f"{flops} causal flops at the TF32 rate {TF32_FLOPS_PER_S:.4g}/s"
            f" = {t_ops * 1e3!r} ms; the f32 CUDA-core floor of the same "
            f"flops at {F32_FLOPS_PER_S:.3g}/s is "
            f"{flops / F32_FLOPS_PER_S * 1e3!r} ms); kernel at "
            f"{flops / t['ms'] / 1e9:.4g} TFLOP/s of the function's flops; "
            f"head group {SSD.head_group(h, n, p)}; it executes {run} TF32 "
            f"flops (3 per f32 product, the Gram once per head group, "
            f"whole 64 x 64 tiles but the diagonal's k-steps above each "
            f"warp's rows), {run / t['ms'] / 1e9:.4g} TFLOP/s, "
            f"{run / TF32_FLOPS_PER_S * 1e3!r} ms at the TF32 peak")
    c, b, u, ld = times[SSM_ARCH]["inputs"]
    plain_ms = cuda_ms(lambda: SSD.ssd_intra_chunk_ref(c, b, u, ld), 3)
    t = times[SSM_ARCH]
    log(f"[kernel] 8c: kernel 5 in f32: " + "; ".join(parts)
        + f"; the plain version at {SSM_ARCH}'s shape {plain_ms!r} ms; no "
        f"single PyTorch call computes this function, so there is no "
        f"library time")
    return errs, dict(ms=t["ms"], plain_ms=plain_ms, library_ms=None,
                      bound_ms=t["bound_ms"], bound_by=t["bound_by"])


def ssd_shape(arch):
    """Kernel 5's heads-form shape (cells, Q, N, H, P) in ``arch``'s prefill
    of LM_BATCH x LM_PROMPT tokens."""
    from repro_torch import configs
    cfg = configs.get(arch)
    return (LM_BATCH * LM_PROMPT // cfg.ssm_chunk, cfg.ssm_chunk,
            cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim)


def ssd_run_flops(cells, q, n, h, p, hg) -> int:
    """The TF32 flops kernel 5 executes (csrc/ssd_scan.cu): three products
    per f32 product; the Gram of every 64 x 64 (query tile, key tile) pair
    up to the diagonal once per head group of ``hg`` heads, N rounded up to
    the kernel's 32-column chunks; the decayed tile times u per head, whole
    off the diagonal and, on it, the k-steps up to each warp's last row
    (warp w of 4 runs 2 w + 2 of 8: 20 of 32)."""
    tiles = -(-q // 64)
    pairs = tiles * (tiles + 1) // 2
    gram = cells * -(-h // hg) * pairs * 64 * 64 * (-(-n // 32) * 32)
    # warp k-steps of a 16-row, 8-key fragment times u: 32 per whole tile
    wu = cells * h * (tiles * (tiles - 1) // 2 * 32 + tiles * 20) * 16 * 8 * p
    return 2 * 3 * (gram + wu)


def ssd_times(gen, reps: int = 20) -> dict:
    """Kernel 5 alone, f32, at mamba2_2p7b's and hymba_1p5b's prefill
    shapes (``ssd_inputs``): the mean of ``reps`` calls by CUDA events, and
    its device time a call by torch.profiler over ``reps`` calls. Through
    the wrapper's public call alone, so a copy of this script times a
    parent tree's kernel too. Returns {arch: {shape, ms, profiled_ms,
    inputs}}."""
    import torch
    from repro_torch.kernels import ssd_scan as SSD
    out = {}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        shape = ssd_shape(arch)
        c, b, u, ld = ssd_inputs(gen, *shape, torch.float32)

        def call():
            SSD.ssd_intra_chunk(c, b, u, ld)

        ms = cuda_ms(call, reps)
        prof = profile_kernels(lambda: [call() for _ in range(reps)])
        us = sum(t for key, (t, _) in prof.items() if "ssd_intra" in key)
        # None: the profiler listed no kernel 5 (seen inside the whole
        # smoke run, after phase 8b's profiles); not a time of 0
        out[arch] = dict(shape=shape, ms=ms,
                         profiled_ms=us / 1e3 / reps if us else None,
                         inputs=(c, b, u, ld))
    return out


def ssd_profile() -> int:
    """``--ssd-profile``: kernel 5 alone at both models' prefill shapes
    (``ssd_times``), printed as one JSON line. No checks against the plain
    version and no result line: the smoke run is the one without
    arguments."""
    import torch
    from repro_torch.kernels import _build
    log(f"[device] {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    _build.build("ssd_scan")
    torch.backends.cuda.matmul.allow_tf32 = False
    times = ssd_times(torch.Generator(device=DEV).manual_seed(SSD_SEED))
    print(json.dumps({"ssd_profile": {
        arch: {k: v for k, v in t.items() if k != "inputs"}
        for arch, t in times.items()}}))
    return 0


def largest_chunk(cfg, s: int) -> int:
    """The largest SSD chunk up to ``cfg.ssm_chunk`` that divides ``s``:
    a forward over the prompt and the fed decode tokens (2048 + 16) is no
    multiple of the model's chunk (256), and the chunked algorithm is the
    same function at any chunk."""
    return max(q for q in range(1, min(cfg.ssm_chunk, s) + 1) if s % q == 0)


def lm_phase(label, arch, seed, prompt_len=LM_PROMPT, layers=None):
    """Phases 8b and 8d-8i: ``arch`` at its published width (and depth,
    unless ``layers`` cuts it) through the serving path with
    ``--use-kernel`` (repro_torch.launch.serve.generate), held against the
    plain routes on the card; a vlm's seeded patch embeddings go ahead of
    the prompt, whisper's encoder takes AUDIO_FRAMES seeded frame
    embeddings. An MoE's checks are held on the rows that route alike
    (RouteLog) and its decode against a forward at the capacity factor
    E / k, where nothing drops. Returns the launches of kernels 4 and 5 in
    the served run."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = configs.get(arch)
    what = [f"{layers or cfg.num_layers} layers"
            + (f" (depth cut from {cfg.num_layers})" if layers else "")
            + f", d={cfg.d_model}"]
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    gen = torch.Generator(device=DEV).manual_seed(seed + 1)
    t0 = time.perf_counter()
    params = M.init_params(cfg, gen)
    n_params = sum(p.numel() for p in params.parameters())
    if cfg.has_attention:
        # the reference's skip-init leaves every wo at zero, and then no
        # attention sublayer reaches the logits: the checks below would
        # hold whatever kernel 4 computed. Redraw wo as seeded normals
        # (whisper's cross-attention and encoder too).
        scale = (cfg.q_heads_eff * cfg.resolved_head_dim) ** -0.5
        blocks = [layer.attn for layer in params.layers]
        if cfg.is_encdec:
            blocks += [layer.cross for layer in params.layers]
            blocks += [layer.attn for layer in params.enc_layers]
        with torch.no_grad():
            for block in blocks:
                block.wo.normal_(0.0, scale, generator=gen)
        what.append(f"{cfg.num_heads}/{cfg.num_kv_heads} attention heads of "
                    f"{cfg.resolved_head_dim}, every wo redrawn as seeded "
                    f"normals at scale {scale!r} (the reference's init "
                    f"leaves it at zero, so attention would not reach the "
                    f"logits)")
    if cfg.has_ssm:
        what.append(f"{cfg.ssm_heads} SSM heads of {cfg.ssm_head_dim}, "
                    f"state {cfg.ssm_state}, chunk {cfg.ssm_chunk}")
    if cfg.num_experts:
        what.append(f"{cfg.num_experts} experts top-{cfg.experts_per_token} "
                    f"of width {cfg.moe_d_ff or cfg.d_ff}, "
                    f"{cfg.num_shared_experts} shared, capacity factor "
                    f"{cfg.capacity_factor}")
    if cfg.num_patches:
        what.append(f"{cfg.num_patches} seeded patch embeddings ahead of "
                    f"{prompt_len} text tokens")
    if cfg.is_encdec:
        what.append(f"an encoder of {cfg.encoder_layers} layers over "
                    f"{AUDIO_FRAMES} seeded frame embeddings, a "
                    f"cross-attention in every decoder layer")
    torch.cuda.synchronize()
    log(f"[lm] {label} {cfg.name}: {'; '.join(what)}; vocab "
        f"{cfg.vocab_padded} (padded), {n_params} parameters (f32 masters, "
        f"{n_params * 4} B) initialized on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    if n_params != M.tree_param_count(cfg):
        fail(f"{cfg.name}: {n_params} parameters, the reference's tree "
             f"holds {M.tree_param_count(cfg)}")
    rng = np.random.default_rng(seed)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, prompt_len), dtype=np.int32),
        device=DEV)

    def embeddings(n):  # f32; each run casts them to its compute dtype
        return torch.as_tensor(rng.normal(size=(
            LM_BATCH, n, cfg.d_model)).astype(np.float32), device=DEV)
    extras = {}
    if cfg.num_patches:
        extras["patches"] = embeddings(cfg.num_patches)
    if cfg.is_encdec:
        extras["frames"] = embeddings(AUDIO_FRAMES)
    p0 = cfg.num_patches  # the positions ahead of the prompt
    n_enc = AUDIO_FRAMES if cfg.is_encdec else 0
    serve.generate(params, cfg, prompt[:, :128], 2, use_kernel=True,
                   **extras)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention.launches = 0
    SSD.ssd_intra_chunk.launches = 0
    with RouteLog() as log_r:  # an MoE's routes, for the bf16 checks
        r = serve.generate(params, cfg, prompt, LM_GEN, use_kernel=True,
                           **extras)
    launches = {"flash_attention": FA.flash_attention.launches,
                "ssd_intra_chunk": SSD.ssd_intra_chunk.launches}
    peak = torch.cuda.max_memory_allocated()
    steps = LM_GEN - 1
    log(f"[lm] {label} serve --use-kernel: prefill {LM_BATCH}x"
        f"{p0 + prompt_len} in {r.prefill_s * 1e3!r} ms "
        f"({LM_BATCH * (p0 + prompt_len) / r.prefill_s!r} tokens/s), {steps} "
        f"decode steps in {r.decode_s * 1e3!r} ms ({r.decode_s * 1e3 / steps!r} "
        f"ms per step, {steps * LM_BATCH / r.decode_s!r} tokens/s), peak "
        f"memory {peak} B; kernel 4 launches {launches['flash_attention']}, "
        f"kernel 5 launches {launches['ssd_intra_chunk']}; sample tokens "
        f"{r.tokens[0, :8].tolist()}")
    for name, on_path in (("flash_attention", cfg.has_attention),
                          ("ssd_intra_chunk", cfg.has_ssm)):
        want = cfg.num_layers if on_path else 0
        if launches[name] != want:
            fail(f"{label}: {name} launched {launches[name]} times in the "
                 f"prefill, not {want} (once per layer where the layer "
                 f"runs it)")
    if r.tokens.shape != (LM_BATCH, LM_GEN) or not bool(
            ((r.tokens >= 0) & (r.tokens < cfg.vocab_padded)).all()):
        fail(f"{label}: generated tokens out of shape or range")
    if cfg.num_experts:
        # the MoE path makes no host sync: one prefill and one decode step
        # with any synchronizing call an error
        cache = M.init_cache(cfg, LM_BATCH, prompt_len + 1, device=DEV)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            M.prefill(params, cfg, {"tokens": prompt}, cache,
                      use_kernel=True)
            M.decode_step(params, cfg, prompt[:, -1:], cache)
        except RuntimeError as err:
            fail(f"{label}: a host sync in the served prefill or decode "
                 f"step: {err}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        del cache
        log(f"[check] {label}: one prefill and one decode step under "
            f"torch.cuda.set_sync_debug_mode('error'): no host sync")
    routes = " and ".join(
        x for x, on in (("kernel 4", cfg.has_attention),
                        ("kernel 5", cfg.has_ssm)) if on)
    plain = " and ".join(
        x for x, on in (("chunked attention", cfg.has_attention),
                        ("the SSD einsum", cfg.has_ssm)) if on)
    # an MoE's decode is held against a forward where nothing drops: the
    # forward's groups (2064 tokens) get another capacity than the
    # prefill's (2048) and the decode steps' (k)
    nodrop = ({"capacity_factor": cfg.num_experts / cfg.experts_per_token}
              if cfg.num_experts else {})

    def prefill(c, use_kernel=False):
        cache = M.init_cache(c, LM_BATCH, p0 + prompt_len, enc_seq=n_enc,
                             device=DEV)
        return M.prefill(params, c, {"tokens": prompt, **extras}, cache,
                         use_kernel=use_kernel)[0]

    @torch.no_grad()
    def forward_tail(c, res):
        """The logits at the prompt's last position and at each decode
        step's of one plain forward over the prompt and the tokens the
        decode steps of ``res`` were fed."""
        fed = torch.cat([prompt, res.tokens[:, :-1]], dim=1)
        if c.has_ssm:
            c = dataclasses.replace(c, ssm_chunk=largest_chunk(
                c, fed.shape[1]))
        return M.forward(params, c, {"tokens": fed, **extras})[0][
            :, p0 + prompt_len - 1:]

    def served(c):
        return serve.generate(params, c, prompt, LM_GEN, use_kernel=True,
                              **extras)

    # The parity checks run at f32 on the same masters: in bf16 many
    # layers amplify the roundoff of a changed sum order past 5e-2 on the
    # logits (ROADMAP fact 5), while in f32 the routes differ by ~1e-5.
    # An MoE's router turns such a difference into another expert where a
    # token's k-th and (k+1)-th probabilities are that close (11 of 262,144
    # decisions at granite's full 32 layers), and in a prefill moves other
    # tokens' capacity slots. So the plain run is pinned to the served
    # run's routes, its own choices printed beside them, and every row is
    # held at 1e-4.
    n_layers = cfg.num_layers
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cfg32n = dataclasses.replace(cfg32, **nodrop)
    with RouteLog() as log_k:
        r32 = served(cfg32)
    kr = log_k.routes(n_layers)
    with RouteLog(None if kr is None else kr[:, :, :p0 + prompt_len]) \
            as log_p:
        plain32 = prefill(cfg32)
    flips = routing_flips(f"{label} f32 prefill, {plain} pinned to "
                          f"{routes}'s routes", log_p.pinned,
                          log_p.routes(n_layers))
    err_pre = lm_close(f"{label} f32 prefill logits, {routes} against "
                       f"{plain}", r32.prefill_logits, plain32)
    if nodrop:
        del r32
        with RouteLog() as log_k:
            r32 = served(cfg32n)
    with RouteLog(log_k.routes(n_layers)) as log_f:
        tail32 = forward_tail(cfg32n, r32)
    flips_fwd = routing_flips(f"{label} f32 forward pinned to the served "
                              f"run's routes", log_f.pinned,
                              log_f.routes(n_layers))
    err_fwd = lm_close(f"{label} f32 prefill logits against the forward",
                       r32.prefill_logits, tail32[:, 0])
    err_dec = max(lm_close(f"{label} f32 decode step {t} against the "
                           f"forward", lg, tail32[:, t + 1])
                  for t, lg in enumerate(r32.decode_logits))
    del tail32, r32
    where = (f" at capacity factor {nodrop['capacity_factor']!r}, where "
             f"nothing drops" if nodrop else "")
    pinned = (f"; the plain runs pinned to the served runs' routes, which "
              f"they would have left in {flips} and {flips_fwd} decisions"
              if nodrop else "")
    log(f"[check] {label} f32 (the same masters, activations in f32, "
        f"{routes} in f32): prefill logits within {LM_TOL32} of the plain "
        f"route ({plain}; max abs {err_pre!r}) and of the forward{where} "
        f"(max abs {err_fwd!r}); all {steps} decode steps within {LM_TOL32} "
        f"of one forward over the prompt and the fed tokens (max abs "
        f"{err_dec!r}){pinned}")
    # bf16, the served run: its prefill through the kernels and its decode
    # steps no less accurate than the plain bf16 routes, against f32 (an
    # MoE's decode from a served run where nothing drops). An MoE's plain
    # bf16 and f32 runs are pinned to the served run's routes: at bf16's
    # roundoff hundreds of decisions flip, and one at a row's last token,
    # or a capacity slot it moves, swings that row's logits.
    rr = log_r.routes(n_layers)
    pre = None if rr is None else rr[:, :, :p0 + prompt_len]
    with RouteLog(pre) as log_16:
        plain16 = prefill(cfg)
    if nodrop:
        with RouteLog(pre) as log_32:
            plain32 = prefill(cfg32)
        flips16 = [routing_flips(f"{label} {what} prefill pinned to the "
                                 f"served bf16 run's routes", pre,
                                 lg.routes(n_layers))
                   for what, lg in (("plain bf16", log_16),
                                    ("plain f32", log_32))]
    (e_pre, p_pre, o_pre) = lm_as_accurate(
        f"{label} bf16 prefill logits through {routes}", r.prefill_logits,
        plain16, plain32, hold_max=not nodrop)
    cfgn = dataclasses.replace(cfg, **nodrop)
    if nodrop:
        with RouteLog() as log_rn:
            rn = served(cfgn)
        rnr = log_rn.routes(n_layers)
    else:
        rn, rnr = r, None
    with RouteLog(rnr) as log_16:
        tail16 = forward_tail(cfgn, rn)
    with RouteLog(rnr) as log_32:
        tail32 = forward_tail(cfg32n, rn)
    if nodrop:
        flips16 += [routing_flips(f"{label} {what} forward pinned to the "
                                  f"served bf16 run's routes", rnr,
                                  lg.routes(n_layers))
                    for what, lg in (("bf16", log_16), ("f32", log_32))]
    dec = [lm_as_accurate(f"{label} bf16 decode step {t}", lg,
                          tail16[:, t + 1], tail32[:, t + 1],
                          hold_max=not nodrop)
           for t, lg in enumerate(rn.decode_logits)]
    # the spread of two plain routes in bf16 (the prefill and the forward,
    # other sum orders) at the prompt's last position
    if nodrop:
        with RouteLog(rnr[:, :, :p0 + prompt_len]):
            plain16n = prefill(cfgn)
    else:
        plain16n = plain16
    spread = (plain16n.float() - tail16[:, 0].float()).abs()
    over = int((spread > LM_TOL + LM_TOL * tail16[:, 0].float().abs()).sum())
    log(f"[lm] {label} bf16: two plain routes (the prefill, the forward "
        f"over the prompt and the fed tokens) give prefill logits up to "
        f"{float(spread.max())!r} apart ({over} of {spread.numel()} over "
        f"the elementwise {LM_TOL} bar); in f32 the kernel route is "
        f"{err_pre!r} off the plain route")
    del tail16, tail32, plain32, plain16, plain16n, spread, rn
    held = ("max and rms held" if not nodrop else
            f"rms held, max printed; the plain runs pinned to the served "
            f"runs' routes, which they would have left in {flips16} "
            f"decisions")
    log(f"[check] {label} bf16 against f32 (max abs, rms; {held}): prefill "
        f"through {routes} {e_pre!r}, the plain route {p_pre!r} ({o_pre} "
        f"logits of {r.prefill_logits.numel()} off the plain route's by "
        f"more than the elementwise {LM_TOL} bar); decode steps worst "
        f"{max(d[0][0] for d in dec)!r} max, "
        f"{max(d[0][1] for d in dec)!r} rms, the forward's "
        f"{max(d[1][0] for d in dec)!r}, {max(d[1][1] for d in dec)!r} "
        f"({sum(d[2] for d in dec)} of {steps * r.prefill_logits.numel()} "
        f"off the bf16 forward's by more than {LM_TOL}); all finite")
    lm_profile(label, params, cfg, prompt, extras)
    return launches


# the kernels' names in a profile: kernel 4's and kernel 5's
PROFILED = (("kernel 4", "flash_fwd"), ("kernel 5", "ssd_intra"))
# the MoE layer's parts, as profiler ranges: (models.moe function, label)
MOE_SPANS = (("route", "moe.route"), ("_group_dispatch", "moe.dispatch"),
             ("_group_combine", "moe.combine"), ("moe_ffn", "moe.ffn"))


@contextlib.contextmanager
def moe_spans():
    """The MoE layer's functions wrapped in torch.profiler ranges named by
    MOE_SPANS while the block runs (the model code is untouched)."""
    from torch.profiler import record_function
    from repro_torch.models import moe
    saved = {name: getattr(moe, name) for name, _ in MOE_SPANS}

    def ranged(fn, label):
        def call(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return call
    for name, label in MOE_SPANS:
        setattr(moe, name, ranged(saved[name], label))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(moe, name, fn)


def lm_profile(label, params, cfg, prompt, extras):
    """Where a served model's time goes: one prefill through the kernels
    and then four decode steps under torch.profiler, each printed as the
    device time by kernel (the largest first), kernels 4 and 5's shares,
    an MoE layer's parts (the routing, dispatch and combine against the
    whole layer), the device's busy share of the host wall clock, and the
    wall clock itself (profiled: inflated)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    p0 = cfg.num_patches
    cache = M.init_cache(
        cfg, LM_BATCH, p0 + prompt.shape[1] + 4,
        enc_seq=extras["frames"].shape[1] if "frames" in extras else 0,
        device=DEV)
    tok = prompt[:, -1:]

    def run_prefill():
        M.prefill(params, cfg, {"tokens": prompt, **extras}, cache,
                  use_kernel=True)

    def run_decode():
        for _ in range(4):
            M.decode_step(params, cfg, tok, cache)

    for window, fn in (("prefill", run_prefill), ("4 decode steps",
                                                  run_decode)):
        torch.cuda.synchronize()
        with moe_spans(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        # a range also leaves an annotation of its span on the device's
        # timeline (device type CUDA, the range's name): not a kernel
        spans = {lab for _, lab in MOE_SPANS}
        kernels = [e for e in events if e.device_type.name == "CUDA"
                   and e.self_device_time_total > 0 and e.key not in spans]
        kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
        busy = sum(e.self_device_time_total for e in kernels)
        shares = []
        for name, key in PROFILED:
            us = sum(e.self_device_time_total for e in kernels
                     if key in e.key)
            if us:
                shares.append(f"{name} {us:.1f} us ({us / busy!r} of the "
                              f"device time)")
        if cfg.num_experts:  # the ranges' device time: their kernels'
            span = {lab: sum(e.device_time_total for e in events
                             if e.key == lab and e.device_type.name == "CPU")
                    for lab in spans}
            moved = span["moe.route"] + span["moe.dispatch"] \
                + span["moe.combine"]
            if span["moe.ffn"]:
                shares.append(
                    f"MoE layers {span['moe.ffn']:.1f} us "
                    f"({span['moe.ffn'] / busy!r}), of which routing "
                    f"{span['moe.route']:.1f}, dispatch "
                    f"{span['moe.dispatch']:.1f} and combine "
                    f"{span['moe.combine']:.1f} us ({moved / busy!r} of the "
                    f"device time, {moved / span['moe.ffn']!r} of the MoE "
                    f"layers')")
            else:
                shares.append("MoE layers' device time not measured (the "
                              "profiler gave its ranges none)")
        log(f"[lm] {label} profile, {window}: device busy {busy:.1f} us of "
            f"{wall_us:.1f} us wall ({busy / wall_us!r} busy share), "
            f"{sum(e.count for e in kernels)} kernel launches"
            + (f"; {', '.join(shares)}" if shares else ""))
        for e in kernels[:10]:
            log(f"[lm]   {e.self_device_time_total:12.1f} us "
                f"{e.count:5d}x  {e.key[:100]}")


def redraw_wo(params, cfg, gen) -> float:
    """Every self-attention wo redrawn as seeded normals at (Hq * Dh)^-0.5,
    as phase 8 does: the reference's zero wo hides attention from the loss.
    Returns the scale."""
    import torch
    scale = (cfg.q_heads_eff * cfg.resolved_head_dim) ** -0.5
    with torch.no_grad():
        for layer in params.layers:
            layer.attn.wo.normal_(0.0, scale, generator=gen)
    return scale


def state_copy(state: dict) -> dict:
    """A copy of a train state on the card (the step updates in place)."""
    import copy
    return {"params": copy.deepcopy(state["params"]),
            "opt": {"m": {k: v.clone() for k, v in state["opt"]["m"].items()},
                    "v": {k: v.clone() for k, v in state["opt"]["v"].items()},
                    "step": state["opt"]["step"].clone()}}


def train_batch(cfg, seed, step=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    import torch
    from repro_torch.data import SyntheticLM
    b = SyntheticLM(cfg.vocab_size, seq, batch, seed=seed).batch(step)
    return {k: torch.from_numpy(v).to(DEV) for k, v in b.items()}


def timed_step(step, state, batch):
    """(state, metrics, seconds): one train step on the host clock, ending
    in a device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    return state, metrics, time.perf_counter() - t0


def states_equal(a: dict, b: dict) -> bool:
    import torch
    pa, pb = dict(a["params"].named_parameters()), dict(
        b["params"].named_parameters())
    return (all(torch.equal(pa[k], pb[k]) for k in pa)
            and all(torch.equal(a["opt"][m][k], b["opt"][m][k])
                    for m in ("m", "v") for k in a["opt"][m])
            and torch.equal(a["opt"]["step"], b["opt"]["step"]))


def train_phase(t_start) -> dict:
    """Phase 9: the LM's training path (repro_torch.train, .optim, .data,
    .launch.train) on the card. Returns its numbers for the log."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.optim import (AdamWConfig, ef_compress_psum,
                                   int8_decode, int8_encode)
    from repro_torch.train.expert_balance import (ExpertRebalancer,
                                                  permute_expert_axis)
    from repro_torch.train.step import (init_state, loss_fn,
                                        make_train_step)
    card = card_line()
    out = {}
    FA.flash_attention.launches = 0
    SSD.ssd_intra_chunk.launches = 0
    # launch/train.py's defaults at --steps 100
    opt = AdamWConfig(peak_lr=3e-4, total_steps=100, warmup_steps=20)

    # -- 9a: llama3p2_1b at full width and depth, remat "full" ---------------
    cfg = configs.get(TRAIN_ARCH)
    if cfg.remat_policy != "full":
        fail(f"{cfg.name}: remat_policy {cfg.remat_policy!r}, expected full")
    gen = torch.Generator(device=DEV).manual_seed(TRAIN_SEED)
    t0 = time.perf_counter()
    state = init_state(cfg, gen, opt)
    scale = redraw_wo(state["params"], cfg, gen)
    n_params = sum(p.numel() for p in state["params"].parameters())
    if n_params != M.tree_param_count(cfg):
        fail(f"9a: {n_params} parameters, the reference's tree holds "
             f"{M.tree_param_count(cfg)}")
    batch = train_batch(cfg, TRAIN_SEED)
    torch.cuda.synchronize()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"[train] 9a {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"{n_params} parameters (f32 masters; m and v f32), every wo redrawn "
        f"at scale {scale!r}, remat {cfg.remat_policy}, bf16 activations, "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ} from SyntheticLM(seed="
        f"{TRAIN_SEED}), AdamW {opt}; state and batch made in "
        f"{time.perf_counter() - t0:.1f} s")
    # the yardsticks first, on copies of the same masters and batch
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    twin = state_copy(state)
    twin, m32, s32 = timed_step(make_train_step(cfg32, opt), twin, batch)
    del twin
    twin = state_copy(state)
    twin, mm2, s2 = timed_step(make_train_step(cfg, opt, num_microbatches=2),
                               twin, batch)
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] 9a yardsticks: f32 activations loss "
        f"{float(m32['loss'])!r} grad_norm {float(m32['grad_norm'])!r} "
        f"({s32:.2f} s); micro=2 ce {float(mm2['ce'])!r} grad_norm "
        f"{float(mm2['grad_norm'])!r} ({s2:.2f} s)")
    step = make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times, losses, norms = [], [], []
    metrics0 = None
    for i in range(TRAIN_STEPS):
        b = batch if i == 0 else train_batch(cfg, TRAIN_SEED, step=i)
        state, m, dt = timed_step(step, state, b)
        metrics0 = metrics0 or m
        times.append(dt)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(norms))):
        fail(f"9a: a loss or grad norm is not finite: {losses} {norms}")
    med = float(np.median(times[1:]))
    flops = 6 * n_params * tokens
    log(f"[train] 9a {TRAIN_STEPS} steps: losses {losses}, grad norms "
        f"{norms}; step s {times} (median after the first {med!r}, spread "
        f"{min(times[1:])!r}-{max(times[1:])!r}); {tokens / med:.1f} "
        f"tokens/s; peak memory {peak} B ({peak - base} B above the state's "
        f"{base} B); 6 N tokens / step time = {flops / med / 1e12:.1f} "
        f"TFLOP/s, {flops / med / DENSE_BF16_FLOPS:.4f} of the "
        f"{DENSE_BF16_FLOPS / 1e12:.1f} TFLOP/s dense bf16 peak; {card}")
    dl = abs(losses[0] - float(m32["loss"])) / float(m32["loss"])
    dn = abs(norms[0] - float(m32["grad_norm"])) / float(m32["grad_norm"])
    log(f"[train] 9a the bf16 step against the f32 step: loss {dl!r} "
        f"(bar {TRAIN_LOSS_BAR}), grad norm {dn!r} (bar {TRAIN_NORM_BAR}) "
        f"relative")
    if dl > TRAIN_LOSS_BAR or dn > TRAIN_NORM_BAR:
        fail("9a: the bf16 step is off the f32 step's bar")
    # -- 9b: micro=1 against micro=2 -----------------------------------------
    dce = abs(float(metrics0["ce"]) - float(mm2["ce"]))
    dgn = abs(float(metrics0["grad_norm"]) - float(mm2["grad_norm"]))
    log(f"[train] 9b micro=1 against micro=2: ce {float(metrics0['ce'])!r} "
        f"and {float(mm2['ce'])!r} (rel {dce / float(mm2['ce'])!r}, bar "
        f"1e-4), grad_norm rel {dgn / float(mm2['grad_norm'])!r} (bar 1e-3)")
    if dce > 1e-4 * abs(float(mm2["ce"])) or \
            dgn > 1e-3 * abs(float(mm2["grad_norm"])):
        fail("9b: micro=2 is off micro=1")
    out.update(step_s=med, tokens_s=tokens / med, peak=peak,
               mfu=flops / med / DENSE_BF16_FLOPS)
    del state, step, batch, metrics0, m32, mm2
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9c: the remat policies at full width, depth cut ---------------------
    log(f"[time] phase 9c starts at {time.perf_counter() - t_start:.1f} s")
    cfg2 = dataclasses.replace(cfg, num_layers=TRAIN_REMAT_LAYERS)
    gen = torch.Generator(device=DEV).manual_seed(TRAIN_SEED + 1)
    state = init_state(cfg2, gen, opt)
    redraw_wo(state["params"], cfg2, gen)
    batch = train_batch(cfg2, TRAIN_SEED + 1)
    params = list(state["params"].parameters())
    grads, peaks = {}, {}
    for policy in M.REMAT_POLICIES:
        cp = dataclasses.replace(cfg2, remat_policy=policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        loss, _ = loss_fn(state["params"], cp, batch)
        grads[policy] = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        peaks[policy] = torch.cuda.max_memory_allocated() - start
        del loss
    names = [n for n, _ in state["params"].named_parameters()]
    for policy, gs in grads.items():
        diff = [n for n, a, b in zip(names, grads["none"], gs)
                if not torch.equal(a, b)]
        if diff:
            fail(f"9c: the gradients under {policy} differ from none's in "
                 f"{diff}")
    del grads
    log(f"[train] 9c {cfg2.name} at {TRAIN_REMAT_LAYERS} layers (depth cut "
        f"from {cfg.num_layers}), batch {TRAIN_BATCH} x {TRAIN_SEQ}: the "
        f"gradients bitwise equal under {list(M.REMAT_POLICIES)}; peak "
        f"memory above the step's start, B: {peaks}; {card}")
    p = peaks
    if not p["none"] >= p["save_all_dots"] >= p["save_dots"] >= p["full"]:
        fail("9c: the peaks are not ordered none >= save_all_dots >= "
             "save_dots >= full")
    first = None
    for policy in M.REMAT_POLICIES:
        cp = dataclasses.replace(cfg2, remat_policy=policy)
        st = make_train_step(cp, opt)(state_copy(state), batch)[0]
        if first is None:
            first = st
        elif not states_equal(first, st):
            fail(f"9c: a train step under {policy} differs from none's")
        del st
    log("[train] 9c one train step under each policy: the new params, m, v "
        "and step bitwise equal")
    out["remat_peaks"] = peaks
    del first, state, params, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9d: the training launcher, a crash and the resume ------------------
    log(f"[time] phase 9d starts at {time.perf_counter() - t_start:.1f} s")
    args = ["--arch", "llama3p2_1b", "--reduced", "--scale", "4",
            "--steps", "8", "--batch", "16", "--seq", "128",
            "--log-every", "1", "--seed", str(TRAIN_SEED), "--device", DEV]
    with tempfile.TemporaryDirectory() as tmp:
        crash = args + ["--ckpt-dir", os.path.join(tmp, "crash")]
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *crash,
             "--fail-at", "4"], capture_output=True, text=True, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
        log(r.stdout.strip())
        if r.returncode != 42:
            fail(f"9d: --fail-at exited {r.returncode}, not 42: {r.stderr}")
        log(f"[train] 9d the crashed run exited 42 in "
            f"{time.perf_counter() - t0:.1f} s")
        resumed = launch_train.main(crash)
        straight = launch_train.main(
            args + ["--ckpt-dir", os.path.join(tmp, "straight")])
    if len(straight) != 8 or resumed != straight[4:]:
        fail(f"9d: the resumed losses {resumed} are not the uninterrupted "
             f"run's {straight[4:]}")
    log(f"[train] 9d resumed at step 4: losses {resumed} bitwise the "
        f"uninterrupted run's")

    # -- 9e: the MoE, its aux losses and the expert rebalancer ---------------
    log(f"[time] phase 9e starts at {time.perf_counter() - t_start:.1f} s")
    cfgm = configs.get(MOE_ARCH)
    cfgm = dataclasses.replace(cfgm, num_layers=TRAIN_MOE_LAYERS)
    gen = torch.Generator(device=DEV).manual_seed(TRAIN_SEED + 2)
    state = init_state(cfgm, gen, opt)
    redraw_wo(state["params"], cfgm, gen)
    step = make_train_step(cfgm, opt)
    reb = ExpertRebalancer(num_experts=cfgm.experts_eff, num_shards=4,
                           interval=1, min_gain=0.0)
    perm, moe_losses = None, []
    for i in range(TRAIN_MOE_STEPS):
        state, m = step(state, train_batch(cfgm, TRAIN_SEED + 2, step=i))
        moe_losses.append(float(m["loss"]))
        perm = reb.observe(m["expert_load"].cpu().numpy().astype(np.float64),
                           i + 1)
    if perm is None or not np.all(np.isfinite(moe_losses)):
        fail(f"9e: no rebalance plan, or losses not finite: {moe_losses}")
    activity = reb.load_ema
    log(f"[train] 9e {cfgm.name} at {TRAIN_MOE_LAYERS} layers (depth cut "
        f"from 32), d={cfgm.d_model}, {cfgm.num_experts} experts "
        f"top-{cfgm.experts_per_token}: losses {moe_losses}; shard "
        f"imbalance of the load EMA {reb.shard_imbalance(activity)!r} -> "
        f"{reb.shard_imbalance(activity[np.argsort(perm)])!r} under the "
        f"rebalancer's plan (num_shards=4), {int(np.sum(perm != np.arange(perm.size)))} "
        f"experts moved")
    twin = state_copy(state)
    permute_expert_axis(state["params"], perm)
    for mom in ("m", "v"):
        state["opt"][mom] = permute_expert_axis(state["opt"][mom], perm)
    b = train_batch(cfgm, TRAIN_SEED + 2, step=TRAIN_MOE_STEPS)
    state, mp = step(state, b)
    twin, mt = step(twin, b)
    lp, lt = float(mp["loss"]), float(mt["loss"])
    log(f"[train] 9e the next step: loss {lp!r} permuted, {lt!r} unpermuted "
        f"twin (rel {abs(lp - lt) / abs(lt)!r}, bar 1e-5)")
    if abs(lp - lt) > 1e-5 * abs(lt):
        fail("9e: the permuted model's loss is off its twin's")
    del state, twin, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- 9f: int8 error-feedback compression on an NCCL group of one ---------
    rng = np.random.default_rng(TRAIN_SEED + 3)
    g = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32),
                            device=DEV) for k, s in
         (("a", (2048, 2048)), ("b", (8192,)))}
    r = {k: torch.as_tensor((rng.normal(size=v.shape) * 1e-3).astype(
        np.float32), device=DEV) for k, v in g.items()}
    with group_of_one():
        red, res = ef_compress_psum(g, r)
    for k in g:
        q, sc = int8_encode(g[k] + r[k])
        deq = int8_decode(q, sc)
        if not (torch.equal(red[k], deq)
                and torch.equal(res[k], (g[k] + r[k]) - deq)):
            fail(f"9f: ef_compress_psum's {k} is not its dequantised input")
    log("[train] 9f ef_compress_psum on an NCCL group of one: outputs "
        "bitwise the dequantised inputs, residuals what quantization lost")
    if FA.flash_attention.launches or SSD.ssd_intra_chunk.launches:
        fail("phase 9: the training path launched kernel 4 or 5")
    return out


def full_state(state: dict) -> dict:
    """A state's tensors whole (DTensors gathered), for bitwise checks."""
    from repro_torch.launch.sharding import full
    return {"params": {k: full(v) for k, v in
                       state["params"].named_parameters()},
            "opt": {"m": {k: full(v) for k, v in state["opt"]["m"].items()},
                    "v": {k: full(v) for k, v in state["opt"]["v"].items()},
                    "step": full(state["opt"]["step"])}}


def same_state(a: dict, b: dict) -> bool:
    import torch
    fa, fb = full_state(a), full_state(b)
    return (all(torch.equal(fa["params"][k], fb["params"][k])
                for k in fa["params"])
            and all(torch.equal(fa["opt"][m][k], fb["opt"][m][k])
                    for m in ("m", "v") for k in fa["opt"][m])
            and torch.equal(fa["opt"]["step"], fb["opt"]["step"]))


def start_dryrun() -> dict:
    """Phase 10d's dry run, started in the background: ``python -m
    repro_torch.launch.dryrun --arch TRAIN_ARCH --mesh single --graph`` in
    a process of its own (its fake group needs one; its cells run on fake
    CUDA tensors and launch nothing on the card), its output and results
    in a temporary directory. It is stopped, and the directory removed,
    when this process exits. Returns what :func:`mesh_phase` reads."""
    import atexit
    import os
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="dryrun-")
    out = open(os.path.join(tmp, "stdout"), "w")
    err = open(os.path.join(tmp, "stderr"), "w")
    res = os.path.join(tmp, "dryrun_torch.json")
    t_wall = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         TRAIN_ARCH, "--mesh", "single", "--graph", "--out", res],
        stdout=out, stderr=err, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()
        err.close()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return dict(proc=proc, dir=tmp, res=res, t0=time.perf_counter(),
                t_wall=t_wall)


def mesh_phase(t_start, dry=None) -> dict:
    """Phase 10: the device mesh, the sharding rules, the sharded train
    step, serving and checkpoint, and the dry run, on an NCCL group of one.
    ``dry``: the dry run :func:`start_dryrun` started (else it starts
    here, beside 10a-10c). Returns its times for the log."""
    import dataclasses
    import os
    import tempfile

    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.interop import (checkpoint_specs,
                                     train_state_from_arrays,
                                     train_state_to_arrays)
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import batch_axes, make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_state, make_train_step
    card = card_line()
    out = {}
    FA.flash_attention.launches = 0
    SSD.ssd_intra_chunk.launches = 0
    opt = AdamWConfig(peak_lr=3e-4, total_steps=100, warmup_steps=20)
    cfg = configs.get(TRAIN_ARCH)
    if dry is None:
        dry = start_dryrun()
    with group_of_one():
        mesh = make_host_mesh(model=1, device_type=DEV)
        # -- 10a: the sharded train step against its unsharded twin ---------
        gen = torch.Generator(device=DEV).manual_seed(MESH_SEED)
        state = init_state(cfg, gen, opt)
        redraw_wo(state["params"], cfg, gen)
        twin = state_copy(state)
        sspecs = SH.state_specs(state, mesh)
        t0 = time.perf_counter()
        state = SH.distribute_state(state, mesh, sspecs)
        torch.cuda.synchronize()
        lay_s = time.perf_counter() - t0
        bspec = SH.to_placements(("data", None), mesh)
        step = make_train_step(cfg, opt)
        metrics, times = {"sharded": [], "twin": []}, {"sharded": [],
                                                     "twin": []}
        for i in range(MESH_STEPS):
            batch = train_batch(cfg, TRAIN_SEED, step=i)
            twin, m, dt = timed_step(step, twin, batch)
            metrics["twin"].append((float(m["loss"]),
                                    float(m["grad_norm"])))
            times["twin"].append(dt)
            sbatch = {k: SH.distribute(v, mesh, bspec)
                      for k, v in batch.items()}
            state, m, dt = timed_step(step, state, sbatch)
            metrics["sharded"].append((float(SH.full(m["loss"])),
                                       float(SH.full(m["grad_norm"]))))
            times["sharded"].append(dt)
        log(f"[mesh] 10a {cfg.name} ({cfg.num_layers} layers, d="
            f"{cfg.d_model}) on a {tuple(mesh.shape)} mesh "
            f"{mesh.mesh_dim_names} of an NCCL group of one, laid out by "
            f"state_specs in {lay_s:.2f} s; (loss, grad norm) sharded "
            f"{metrics['sharded']}, twin {metrics['twin']}; step s sharded "
            f"{times['sharded']}, unsharded twin {times['twin']}; {card}")
        if metrics["sharded"] != metrics["twin"]:
            fail("10a: the sharded steps' losses or grad norms differ from "
                 "the unsharded twin's")
        if not same_state(state, twin):
            fail("10a: the sharded state differs from the twin's")
        log("[mesh] 10a losses, grad norms and the new states bitwise the "
            "twin's")
        out["train_s"] = (times["sharded"][-1], times["twin"][-1])

        # -- 10b: serving through the sharding rules ---------------------------
        log(f"[time] phase 10b starts at {time.perf_counter() - t_start:.1f} "
            f"s")
        scfg = dataclasses.replace(cfg, shard_attn=True,
                                   cast_weights_once=True)
        shape = dataclasses.replace(configs.SHAPES["prefill_32k"],
                                    global_batch=LM_BATCH)
        M.set_attention_sharding(batch_axes(mesh), "model")
        prompt = torch.as_tensor(np.random.default_rng(MESH_SEED).integers(
            0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32),
            device=DEV)
        bs = SH.batch_specs(scfg, shape, mesh)
        lspec = SH.logits_spec(scfg, shape, mesh)

        def serve(params, c, sharded):
            cache = M.init_cache(c, LM_BATCH, LM_PROMPT + MESH_DECODE,
                                 device=DEV)
            wrap = (lambda t: SH.distribute(t, mesh, bs["tokens"])) \
                if sharded else (lambda t: t)
            if sharded:
                cache = SH.distribute_tree(
                    cache, mesh, SH.cache_sharding(c, shape, mesh, cache))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = M.prefill(params, c, {"tokens": wrap(prompt)}, cache)
            if sharded:
                lg = lg.redistribute(mesh, lspec)
            lg = SH.full(lg)
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
            logits, toks, dec = [lg], [], []
            for _ in range(MESH_DECODE):
                nxt = lg.argmax(-1).to(torch.int32)[:, None]
                toks.append(nxt)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = M.decode_step(params, c, wrap(nxt), cache)
                if sharded:
                    lg = lg.redistribute(mesh, lspec)
                lg = SH.full(lg)
                torch.cuda.synchronize()
                dec.append(time.perf_counter() - t0)
                logits.append(lg)
            return logits, toks, pre_s, dec
        got = serve(state["params"], scfg, True)
        want = serve(twin["params"], cfg, False)
        same = (all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
                and all(torch.equal(a, b) for a, b in zip(got[1], want[1])))
        log(f"[mesh] 10b prefill {LM_BATCH} x {LM_PROMPT} and {MESH_DECODE} "
            f"decode steps, shard_attn and cast_weights_once on, logits laid "
            f"out by logits_spec {lspec}: prefill s sharded {got[2]!r}, "
            f"plain {want[2]!r}; decode step s sharded {got[3]}, plain "
            f"{want[3]}; logits and tokens bitwise equal: {same}; {card}")
        if not same:
            fail("10b: the sharded serve differs from the plain route")
        out["prefill_s"] = (got[2], want[2])
        out["decode_s"] = (float(np.median(got[3])),
                           float(np.median(want[3])))
        M.set_attention_sharding((), None)
        del got, want, twin, state
        gc.collect()
        torch.cuda.empty_cache()

        # -- 10c: save and restore onto the mesh -------------------------------
        log(f"[time] phase 10c starts at {time.perf_counter() - t_start:.1f} "
            f"s")
        cfg = dataclasses.replace(cfg, num_layers=MESH_CKPT_LAYERS)
        step = make_train_step(cfg, opt)
        gen = torch.Generator(device=DEV).manual_seed(MESH_SEED + 1)
        state = init_state(cfg, gen, opt)
        redraw_wo(state["params"], cfg, gen)
        sspecs = SH.state_specs(state, mesh)
        state = SH.distribute_state(state, mesh, sspecs)
        batch = train_batch(cfg, TRAIN_SEED, step=0)
        state, _ = step(state, {k: SH.distribute(v, mesh, bspec)
                                for k, v in batch.items()})
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(os.path.join(tmp, "ckpt"),
                                    async_write=False)
            t0 = time.perf_counter()
            mgr.save(1, train_state_to_arrays(cfg, state))
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tree, meta = mgr.restore(shardings=checkpoint_specs(sspecs),
                                     mesh=mesh)
            restored = train_state_from_arrays(cfg, tree, DEV)
            del tree
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        if meta["step"] != 1 or not same_state(restored, state):
            fail("10c: the restored state differs from the saved one")
        batch = train_batch(cfg, TRAIN_SEED, step=1)
        sbatch = {k: SH.distribute(v, mesh, bspec) for k, v in batch.items()}
        state, m1 = step(state, sbatch)
        restored, m2 = step(restored, sbatch)
        pair = [(float(SH.full(m["loss"])), float(SH.full(m["grad_norm"])))
                for m in (m1, m2)]
        log(f"[mesh] 10c {cfg.name} at {cfg.num_layers} layers, one step: "
            f"saved in {save_s:.2f} s, restored onto the mesh in "
            f"{restore_s:.2f} s, bitwise the saved state; the next step "
            f"(loss, grad norm) uninterrupted {pair[0]}, resumed {pair[1]}")
        if pair[0] != pair[1] or not same_state(state, restored):
            fail("10c: the step after the restore differs from the "
                 "uninterrupted one")
        del state, restored, step
        gc.collect()
        torch.cuda.empty_cache()
    if FA.flash_attention.launches or SSD.ssd_intra_chunk.launches:
        fail("phase 10: the sharded program launched kernel 4 or 5")

    # -- 10d: the dry run and the roofline, on a fake group ----------------------
    log(f"[time] phase 10d starts at {time.perf_counter() - t_start:.1f} s")
    proc, t0 = dry["proc"], time.perf_counter()
    try:
        rc = proc.wait(timeout=max(DRYRUN_TIMEOUT - (t0 - dry["t0"]), 1.0))
    except subprocess.TimeoutExpired:
        fail(f"10d: the dry run still ran {DRYRUN_TIMEOUT} s after it "
             f"started")
    waited = time.perf_counter() - t0
    text = {name: Path(dry["dir"], name).read_text()
            for name in ("stdout", "stderr")}
    log("\n".join(line for line in text["stdout"].splitlines()
                  if line.startswith("[dryrun]")))
    if rc:
        fail(f"10d: the dry run exited {rc}: {text['stderr'][-3000:]}")
    res = Path(dry["res"])
    cells = json.loads(res.read_text())
    for key, cell in sorted(cells.items()):
        log(f"[dryrun] {key}: " + json.dumps(
            {k: v for k, v in cell.items() if k != "trace"}))
    # python -m repro_torch.launch.roofline --in res, in this process
    from repro_torch.launch import roofline
    with contextlib.redirect_stdout(io.StringIO()) as table:
        roofline.main(["--in", str(res)])
    log(table.getvalue().strip())
    dry_s = res.stat().st_mtime - dry["t_wall"]
    log(f"[mesh] 10d the dry run (its cells on fake devices, fake group of "
        f"512) wrote its results {dry_s:.1f} s after it started, in the "
        f"background; this phase waited {waited:.1f} s for it")
    out["dryrun_s"] = dry_s
    return out


def mesh_alone() -> int:
    """``--mesh-phase``: phase 10 alone, in one process (it builds no
    kernel: the sharded program runs none). No result line."""
    import torch
    t_start = time.perf_counter()
    log(f"[device] {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    mesh_phase(t_start)
    log(f"[done] phase 10 in {time.perf_counter() - t_start:.1f} s")
    return 0


def train_alone() -> int:
    """``--train-phase``: phase 9 alone, in one process (it builds no
    kernel: the training path runs none). No result line."""
    import torch
    t_start = time.perf_counter()
    log(f"[device] {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    train_phase(t_start)
    log(f"[done] phase 9 in {time.perf_counter() - t_start:.1f} s")
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--segment-repeats"]:
        return segment_repeats(int(sys.argv[2]))
    if sys.argv[1:2] == ["--sweep-profile"]:
        return sweep_profile()
    if sys.argv[1:2] == ["--ssd-profile"]:
        return ssd_profile()
    if sys.argv[1:2] == ["--ooc-phase"]:
        return ooc_alone()
    if sys.argv[1:2] == ["--contracts-phase"]:
        return contracts_alone()
    if sys.argv[1:2] == ["--train-phase"]:
        return train_alone()
    if sys.argv[1:2] == ["--mesh-phase"]:
        return mesh_alone()
    import numpy as np
    from repro_torch.core import algorithms as A
    from repro_torch.core import graph as G
    from repro_torch.core.engine import EngineConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_sweep as kb
    from repro_torch.stream import StreamingEngine, synthetic_stream

    t_start = time.perf_counter()
    card = card_line()
    # -- phase 1: device and build -----------------------------------------
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()

    def build(name):
        return _build.build(name), time.perf_counter() - t0

    # one nvcc per source, all started together, and phase 10d's dry run
    # (a process on fake devices), while the main path's graphs and
    # engines are built here: neither needs a kernel
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = [pool.submit(build, name) for name in SOURCES]
        dry = start_dryrun()
        # -- the graphs and engines of the main path -------------------------
        engines, graphs = main_path_engines(baseline=True)
        libs = [f.result() for f in builds]
    build_s = max(s for _, s in libs)
    for name, (lib_path, _) in zip(SOURCES, libs):
        log(f"[build] {name}.cu -> {lib_path.name} (all built in "
            f"{build_s:.1f} s, beside the set-up)")
        log(Path(str(lib_path) + ".log").read_text().strip())

    # -- phase 2: kernels vs plain, and the sweeps' times --------------------
    log(f"[time] phase 2 starts at {time.perf_counter() - t_start:.1f} s")
    rng = np.random.default_rng(SEED)
    errs = {"1": [], "1m": []}
    times = {}
    for name, (sa, _) in engines.items():
        c, n_live, n_total = BLOCK, sa.plan.n_live, sa.plan.graph.n
        floor = np.float32(sa._psd_floor())
        ed8 = masked_tiles(sa, SUB)
        values = mid_run_state(name, sa._values_len, rng)
        errs["1"].append(check_against_plain(
            f"{name} kernel 1", sa.program, sa.edge_state, c, n_live,
            n_total, values, rng))
        errs["1m"].append(check_against_plain(
            f"{name} kernel 1m S={SUB}", sa.program, ed8, c, n_live, n_total,
            values, rng, floor=floor,
            psd0=sub_mask_psd(rng, sa.plan.num_blocks, SUB, floor, 0.5)))
        if name == "pagerank":  # the graph the kernels line times
            times[name] = time_full_sweep(f"{name} kernel 1", sa.program,
                                          sa.edge_state, c, n_live, n_total,
                                          sa.values0)
            for frac in (1.0, 1.0 / SUB):
                times[(name, frac)] = time_full_sweep(
                    f"{name} kernel 1m S={SUB}, live fraction {frac!r}",
                    sa.program, ed8, c, n_live, n_total, sa.values0,
                    floor=floor, psd0=sub_mask_psd(rng, sa.plan.num_blocks,
                                                   SUB, floor, frac),
                    plain=frac == 1.0)
        del ed8
    # 2e: kernels 1 and 1m at the main path's shapes, from a generator of
    # its own
    log(f"[time] phase 2e starts at {time.perf_counter() - t_start:.1f} s")
    sweep_shapes_phase(engines, times, np.random.default_rng(SWEEP_SEED))
    # 2c: a mutated layout (appends, kill holes and rebuilt runs)
    t0 = time.perf_counter()
    gm = G.powerlaw_graph(MUTATE_N, avg_deg=AVG_DEG, seed=3)
    mcfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=T2, subblocks=SUB,
                        max_iterations=SA_CAP)
    se = StreamingEngine(gm, A.cc(), mcfg, device=DEV)
    # kernel 1 on the build-time layout, before the batch mutates it
    times["unmutated"] = time_full_sweep(
        "cc kernel 1, build-time layout", A.cc(), se.engine.edge_state,
        BLOCK, se.engine.plan.n_live, se.engine.plan.graph.n,
        se.engine.values0)
    # no hotspot burst: one vertex gaining thousands of edges would
    # outgrow its block's slack and rebuild the whole plan instead
    r = se.ingest(synthetic_stream(gm, 1, MUTATE_EDITS, seed=SEED,
                                   hotspot_prob=0.0)[0])
    log(f"[kernel] mutated layout: CC stream on powerlaw_graph(n={gm.n}), "
        f"one batch of {MUTATE_EDITS} edits: +{r.inserts} -{r.deletes}, "
        f"{r.appended_blocks} appended, {r.rebuilt_blocks} rebuilt, "
        f"plan_rebuild={r.plan_rebuild}, in "
        f"{time.perf_counter() - t0:.1f} s")
    if r.rebuilt_blocks < 1 or r.plan_rebuild or not r.converged:
        fail("mutated layout: the batch must rebuild a block in place")
    em = se.engine
    ed = em.edge_state
    # the PageRank arithmetic needs a positive aux; the same tiles serve
    # all three combines
    ed = ed._replace(aux=torch.as_tensor(
        rng.uniform(1.0, 9.0, ed.aux.numel()).astype(np.float32)).to(DEV))
    n_live, n_total = em.plan.n_live, em.plan.graph.n
    floor = np.float32(em._psd_floor())
    for name, prog in (("pagerank", A.pagerank()), ("sssp", A.sssp(0)),
                       ("cc", A.cc())):
        values = mid_run_state(name, em._values_len, rng)
        errs["1"].append(check_against_plain(
            f"mutated {name} kernel 1", prog, ed, BLOCK, n_live, n_total,
            values, rng))
        errs["1m"].append(check_against_plain(
            f"mutated {name} kernel 1m S={SUB}", prog, ed, BLOCK, n_live,
            n_total, values, rng, floor=floor,
            psd0=sub_mask_psd(rng, em.plan.num_blocks, SUB, floor, 0.5)))
    times["mutated"] = time_full_sweep(
        "cc kernel 1, mutated layout (same engine, after the batch)",
        A.cc(), em.edge_state, BLOCK, n_live, n_total, em.values0)
    del se, em, ed

    # 2d: the lane sweeps (kernels 1l and 1lm) at L = LANES
    log(f"[time] phase 2d starts at {time.perf_counter() - t_start:.1f} s")
    errs.update({"1l": [], "1lm": []})
    done = np.zeros(LANES, bool)
    done[[1, 5]] = True
    for name, prog, plain_dev in (("sssp", A.k_source_sssp(), DEV),
                                  ("sssp", A.k_source_bfs(), DEV),
                                  ("pagerank", A.k_personalized_pagerank(),
                                   "cpu")):
        sa = engines[name][0]
        c, n_live, n_total = BLOCK, sa.plan.n_live, sa.plan.graph.n
        P = sa.plan.num_blocks
        floor = np.float32(sa._psd_floor())
        ed8 = masked_tiles(sa, SUB)
        values, vconst = lane_state(prog, sa._values_len, rng)
        label = f"{prog.name} on the {name} graph"
        errs["1l"].append(check_lanes_against_plain(
            f"{label} kernel 1l", prog, sa.edge_state, c, n_live, n_total,
            values, vconst, rng, plain_dev))
        psd8 = np.where(rng.random((P, SUB, LANES)) < 0.3, np.float32(1.0),
                        floor / 2).astype(np.float32)
        errs["1lm"].append(check_lanes_against_plain(
            f"{label} kernel 1lm S={SUB}", prog, ed8, c, n_live, n_total,
            values, vconst, rng, plain_dev, floor=floor, psd0=psd8,
            lane_done=done))
        if prog.name == "k_sssp":  # the kernels line times these sweeps
            times["1l"] = time_lane_sweep(
                f"{label} kernel 1l", prog, sa.edge_state, c, n_live,
                n_total, values, vconst)
            for frac in (1.0, 1.0 / SUB):
                times[("1lm", frac)] = time_lane_sweep(
                    f"{label} kernel 1lm S={SUB}, live fraction {frac!r}",
                    prog, ed8, c, n_live, n_total, values, vconst,
                    floor=floor, lane_done=np.zeros(LANES, bool),
                    psd0=np.repeat(sub_mask_psd(rng, P, SUB, floor, frac)
                                   [:, :, None], LANES, axis=2),
                    plain=frac == 1.0)
            # a one-lane k_sssp sweep is kernel 1's sssp sweep, bitwise
            rows = torch.arange(P, dtype=torch.int32, device=DEV)
            ok = torch.ones(P, dtype=torch.bool, device=DEV)
            kw = dict(block_size=c, n_live=n_live)
            lv = torch.from_numpy(values[:, :1].copy()).to(DEV)
            lp, ld = (torch.zeros(P, 1, 1, device=DEV) for _ in range(2))
            kb.lane_block_sweep(prog, n_total, sa.edge_state, lv,
                                torch.zeros_like(lv), rows, ok, lp, ld,
                                torch.zeros(1, dtype=torch.bool, device=DEV),
                                kb.make_lane_scratch(sa.edge_state, c, 1),
                                **kw)
            sv = torch.from_numpy(values[:, 0].copy()).to(DEV)
            sp, sd = (torch.zeros(P, 1, device=DEV) for _ in range(2))
            kb.block_sweep(sa.program, n_total, sa.edge_state, sv, rows, ok,
                           sp, sd, kb.make_scratch(sa.edge_state, c), **kw)
            torch.cuda.synchronize()
            if not (torch.equal(lv[:, 0], sv) and torch.equal(
                    lp.view(P, 1), sp) and torch.equal(ld.view(P, 1), sd)):
                fail("a one-lane k_sssp sweep differs from kernel 1's")
            log("[kernel] one-lane k_sssp sweep of every block bitwise equal "
                "to kernel 1's sssp sweep (values, psd, dmax)")
            del lv, lp, ld, sv, sp, sd, rows, ok
        del ed8
    # the lane shapes of the serving path, from a generator of their own
    lane_shapes_phase(engines, times, np.random.default_rng(LANE_SEED))

    # -- phase 3: the main path ----------------------------------------------
    log(f"[time] phase 3 starts at {time.perf_counter() - t_start:.1f} s")
    launches = 0
    results = {}
    sa_launches = {}
    for name, (sa, base) in engines.items():
        for label, eng, cap in (("structure-aware", sa, SA_CAP),
                                ("baseline", base, BASE_CAP)):
            zero_counts()
            torch.cuda.synchronize()
            res = eng.run(max_iterations=cap)
            torch.cuda.synchronize()
            n_launch = launch_counts()[0]
            launches += n_launch
            m = res.metrics
            if n_launch == 0:
                fail(f"{name} {label}: the sweep kernel never launched")
            if not np.all(np.isfinite(res.values)) \
                    or res.values.shape != (N,):
                fail(f"{name} {label}: values not finite of shape ({N},)")
            log(f"[run] {name} {label}: iterations={m.iterations} "
                f"converged={m.converged} updates={m.updates} "
                f"loads={m.block_loads} bytes={m.bytes_loaded} "
                f"wall_s={m.wall_time_s!r} host_syncs={res.host_syncs} "
                f"sweep_launches={n_launch}")
            results[(name, label)] = res
            if label == "structure-aware":
                sa_launches[name] = n_launch
    sa_r = results[("sssp", "structure-aware")]
    base_r = results[("sssp", "baseline")]
    if not (sa_r.metrics.converged and base_r.metrics.converged):
        fail("sssp did not converge within the caps")
    agree("sssp", sa_r.values, base_r.values, exact=True)
    sa_r = results[("pagerank", "structure-aware")]
    base_r = results[("pagerank", "baseline")]
    agree("pagerank", sa_r.values, base_r.values, exact=False)
    for name, (sa, _) in engines.items():
        superstep_windows(f"{name} structure-aware", sa)
    log("[check] sssp fixpoints bitwise equal; pagerank within rtol=1e-4, "
        f"atol=2e-3/n; gain: pagerank "
        f"{base_r.metrics.updates / max(sa_r.metrics.updates, 1):.2f}x "
        f"fewer updates, sssp "
        f"{results[('sssp', 'baseline')].metrics.updates / max(results[('sssp', 'structure-aware')].metrics.updates, 1):.2f}x")
    # -- phase 3t: the traced main path, its launches apart from phase 3's --
    log(f"[time] phase 3t starts at {time.perf_counter() - t_start:.1f} s")
    trace_phase(engines, results, sa_launches, t_start)
    # -- phase 3c: the contract checker, and the chunks without host syncs --
    log(f"[time] phase 3c starts at {time.perf_counter() - t_start:.1f} s")
    contracts_phase(engines, t_start)
    # -- phase 3o: the out-of-core tier and epoch persistence ---------------
    log(f"[time] phase 3o starts at {time.perf_counter() - t_start:.1f} s")
    ooc_phase(engines, results, sa_launches, t_start)
    # the loop names still hold the last engines and results: free them
    del engines, results, sa, base, eng, res, sa_r, base_r

    # -- phase 4: streaming with hierarchical partitions ---------------------
    log(f"[time] phase 4 starts at {time.perf_counter() - t_start:.1f} s")
    g = graphs["pagerank"]  # phase 6's graph
    del graphs
    gp = G.core_periphery_graph(PR_STREAM_N, avg_deg=AVG_DEG, seed=1,
                                chords=1)
    scfg = EngineConfig(block_size=BLOCK, width=WIDTH,
                        t2=T2 * 20000 / PR_STREAM_N, subblocks=SUB,
                        max_iterations=STREAM_CAP)
    batches = [synthetic_stream(gp, 1, 10, seed=11, delete_frac=0.0)[0],
               synthetic_stream(gp, 1, 200, seed=13, delete_frac=0.2)[0]]
    masked_launches, se = stream_phase("pagerank stream", gp, A.pagerank(),
                                       scfg, batches, exact=False)
    del se, gp
    gs = G.powerlaw_graph(SSSP_STREAM_N, avg_deg=AVG_DEG, seed=2,
                          weighted=True)
    scfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=T2, subblocks=SUB,
                        max_iterations=SA_CAP)
    n1m, se = stream_phase(
        "sssp stream", gs, A.sssp(0), scfg,
        synthetic_stream(gs, 3, 200, seed=14, delete_frac=0.2,
                         weighted=True), exact=True)
    masked_launches += n1m
    if masked_launches == 0:
        fail("the masked kernel never launched on the streaming path")
    se_sssp = se

    # -- phase 5a: query serving at n = 2^19 through kernel 1l ---------------
    log(f"[time] phase 5a starts at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    gq = G.powerlaw_graph(SERVE_N, avg_deg=AVG_DEG, seed=2, weighted=True)
    qcfg = EngineConfig(block_size=BLOCK, width=WIDTH, t2=SERVE_T2,
                        max_iterations=SERVE_CAP)
    se = StreamingEngine(gq, A.pagerank(), qcfg, device=DEV)
    init = se.initial_result.metrics
    log(f"[serve] 5a: PageRank stream on powerlaw_graph(n={gq.n}) built and "
        f"bootstrapped in {time.perf_counter() - t0:.1f} s: "
        f"iterations={init.iterations} converged={init.converged}")
    if not init.converged:
        fail("5a: the host program's bootstrap did not converge")
    qrng = np.random.default_rng(SEED + 5)
    resets = [[int(v) for v in qrng.choice(gq.n, 2, replace=False)]
              for _ in range(LANES)]
    lane_launches = serve_phase(
        "5a", se, [("ppr", resets)], [],
        synthetic_stream(gq, 1, 200, seed=21, delete_frac=0.2,
                         weighted=True)[0])[0]
    if lane_launches == 0:
        fail("5a: the lane kernel never launched on the serving path")
    del se, gq

    # -- phase 5b: query serving at S = 8 through kernel 1lm -----------------
    log(f"[time] phase 5b starts at {time.perf_counter() - t_start:.1f} s")
    se = se_sssp
    gb = se.current_graph()
    waves = [("sssp", [int(v) for v in qrng.choice(gb.n, LANES,
                                                   replace=False)])]
    wave1 = [("sssp", [int(v) for v in qrng.choice(gb.n, LANES,
                                                   replace=False)])]
    masked_lane_launches = serve_phase(
        "5b", se, waves, wave1,
        synthetic_stream(gb, 1, 200, seed=22, delete_frac=0.2,
                         weighted=True)[0])[1]
    if masked_lane_launches == 0:
        fail("5b: the masked lane kernel never launched on the serving path")
    del se, se_sssp

    # -- phase 5c: BFS lanes at S = 8 through kernel 1lm ---------------------
    log(f"[time] phase 5c starts at {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    gb = G.powerlaw_graph(BFS_STREAM_N, avg_deg=AVG_DEG, seed=2,
                          weighted=True)
    se = StreamingEngine(gb, A.sssp(0), EngineConfig(
        block_size=BLOCK, width=WIDTH, t2=T2, subblocks=SUB,
        max_iterations=SA_CAP), device=DEV)
    init = se.initial_result.metrics
    log(f"[serve] 5c: SSSP stream S={SUB} on powerlaw_graph(n={gb.n}) built "
        f"and bootstrapped in {time.perf_counter() - t0:.1f} s: "
        f"P={se.engine.plan.num_blocks} iterations={init.iterations} "
        f"converged={init.converged}")
    if not init.converged:
        fail("5c: the stream's bootstrap did not converge")
    n1lm = serve_phase(
        "5c", se, [("bfs", [int(v) for v in qrng.choice(gb.n, LANES,
                                                        replace=False)])],
        [], synthetic_stream(gb, 1, 200, seed=23, delete_frac=0.2,
                             weighted=True)[0])[1]
    if n1lm == 0:
        fail("5c: the masked lane kernel never launched on the serving path")
    masked_lane_launches += n1lm
    del se

    # -- phase 6: the distributed engine at block 4096 ------------------------
    log(f"[time] phase 6 starts at {time.perf_counter() - t_start:.1f} s")
    dist_launches, seg_errs, hub_t, cold_t = distributed_phase(
        g, rng, t_start)

    # -- phase 8: LM serving, the dense decoder through kernel 4 ------------
    log(f"[time] phase 8 starts at {time.perf_counter() - t_start:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[lm] device memory before phase 8: "
        f"{torch.cuda.memory_allocated()} B allocated, "
        f"{torch.cuda.memory_reserved()} B reserved")
    fa_errs, fa_t, fa96_t = attention_phase()
    log(f"[time] phase 8b starts at {time.perf_counter() - t_start:.1f} s")
    lm_launches = {"8b": lm_phase("8b", LM_ARCH, LM_SEED)}
    # -- phase 8c-e: kernel 5, and the SSM and hybrid families -------------
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] phase 8c starts at {time.perf_counter() - t_start:.1f} s")
    ssd_errs, ssd_t = ssd_phase()
    log(f"[time] phase 8d starts at {time.perf_counter() - t_start:.1f} s")
    lm_launches["8d"] = lm_phase("8d", SSM_ARCH, SSM_SEED,
                                 layers=SERVE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] phase 8e starts at {time.perf_counter() - t_start:.1f} s")
    lm_launches["8e"] = lm_phase("8e", HYBRID_ARCH, HYBRID_SEED,
                                 layers=SERVE_LAYERS)
    # -- phase 8f-i: the moe, vlm and audio families -----------------------
    for phase, arch, seed, kw in (
            ("8f", MOE_ARCH, MOE_SEED, {"layers": SERVE_LAYERS}),
            ("8g", SHARED_MOE_ARCH, SHARED_MOE_SEED,
             {"layers": SHARED_MOE_LAYERS}),
            ("8h", VLM_ARCH, VLM_SEED,
             {"prompt_len": VLM_TEXT, "layers": SERVE_LAYERS}),
            ("8i", AUDIO_ARCH, AUDIO_SEED, {"prompt_len": AUDIO_PROMPT})):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[time] phase {phase} starts at "
            f"{time.perf_counter() - t_start:.1f} s")
        lm_launches[phase] = lm_phase(phase, arch, seed, **kw)
    log(f"[lm] kernel launches on the served prefills: {lm_launches}")
    fa_launches, ssd_launches = (
        sum(n[key] for n in lm_launches.values())
        for key in ("flash_attention", "ssd_intra_chunk"))

    # -- phase 9: LM training -------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] phase 9 starts at {time.perf_counter() - t_start:.1f} s")
    train_phase(t_start)

    # -- phase 10: the device mesh, the sharding rules and the dry run -------
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[time] phase 10 starts at {time.perf_counter() - t_start:.1f} s")
    mesh_phase(t_start, dry)

    # -- phase 7: the kernels line, the card, and the result -----------------
    t, tm = times["pagerank"], times[("pagerank", 1.0)]
    tl, tlm = times["1l"], times[("1lm", 1.0)]
    shl, shlm = times[("1l shapes", "sssp")], times[("1lm shapes", "sssp")]
    rows = [
        dict(name="block_sweep", route="cuda",
             source="src/repro_torch/csrc/block_sweep.cu",
             replaces="src/repro/kernels/block_sweep.py:122",
             launches=launches, max_abs_err=max(errs["1"]), ms=t["ms"],
             plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
             bound_by="bytes", library_ms=t["library_ms"]),
        dict(name="masked_block_sweep", route="cuda",
             source="src/repro_torch/csrc/block_sweep.cu",
             replaces="src/repro/kernels/block_sweep.py:131",
             launches=masked_launches, max_abs_err=max(errs["1m"]),
             ms=tm["ms"], plain_ms=tm["plain_ms"], bound_ms=tm["bound_ms"],
             bound_by="bytes", library_ms=tm["library_ms"],
             **{f"sssp_eighth_{k}": v for k, v in
                times[("sssp", 1.0 / SUB)].items() if k != "plain_ms"}),
        dict(name="lane_block_sweep", route="cuda",
             source="src/repro_torch/csrc/block_sweep.cu",
             replaces="src/repro/kernels/block_sweep.py:136",
             launches=lane_launches, max_abs_err=max(errs["1l"]),
             ms=tl["ms"], plain_ms=tl["plain_ms"], bound_ms=tl["bound_ms"],
             bound_by="bytes", library_ms=tl["library_ms"],
             hub_ms=shl["hub"], slate_ms=shl["slate"]),
        dict(name="masked_lane_block_sweep", route="cuda",
             source="src/repro_torch/csrc/block_sweep.cu",
             replaces="src/repro/kernels/block_sweep.py:150",
             launches=masked_lane_launches, max_abs_err=max(errs["1lm"]),
             ms=tlm["ms"], plain_ms=tlm["plain_ms"],
             bound_ms=tlm["bound_ms"], bound_by="bytes",
             library_ms=tlm["library_ms"],
             **{f"eighth_{k}": v for k, v in
                times[("1lm", 1.0 / SUB)].items() if k != "plain_ms"},
             eighth_hub_ms=shlm["hub"], eighth_slate_ms=shlm["slate"]),
    ] + [dict(name=f"edge_block_{op}", route="cuda",
              source="src/repro_torch/csrc/segment_combine.cu",
              replaces=("src/repro/kernels/spmv.py:25" if op == "sum" else
                        "src/repro/kernels/block_sweep.py:56"),
              launches=dist_launches[op], max_abs_err=seg_errs[op],
              ms=hub_t[op]["ms"], plain_ms=hub_t[op]["plain_ms"],
              bound_ms=hub_t[op]["bound_ms"], bound_by="bytes",
              library_ms=hub_t[op]["library_ms"],
              bound_dst_ms=hub_t[op]["bound_dst_ms"],
              cold_ms=cold_t[op]["ms"],
              cold_library_ms=cold_t[op]["library_ms"],
              cold_bound_ms=cold_t[op]["bound_ms"],
              cold_bound_dst_ms=cold_t[op]["bound_dst_ms"])
         for op in ("sum", "min", "max")] + [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:24",
             launches=fa_launches, max_abs_err=max(fa_errs.values()),
             ms=fa_t["ms"], plain_ms=fa_t["plain_ms"],
             bound_ms=fa_t["bound_ms"], bound_by=fa_t["bound_by"],
             library_ms=fa_t["library_ms"], f32_ms=fa_t["f32_ms"],
             f32_library_ms=fa_t["f32_library_ms"],
             **{f"d96_{k}": v for k, v in fa96_t.items()}),
        dict(name="ssd_intra_chunk", route="cuda",
             source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan.py:26",
             launches=ssd_launches, max_abs_err=max(ssd_errs.values()),
             ms=ssd_t["ms"], plain_ms=ssd_t["plain_ms"],
             bound_ms=ssd_t["bound_ms"], bound_by=ssd_t["bound_by"],
             library_ms=ssd_t["library_ms"])]
    log(f"[done] in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
