#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, on a GPU host

Phases, each printed on its own line:

1. build — compile the CUDA sources of ``src/repro_torch/csrc`` for
   ``sm_90a``, one ``nvcc`` per source, all started together; print the
   build time, the compiler's register and shared-memory report and the
   card (``nvidia-smi`` name and power limit).  The engine's phases wait
   for ``queue_front.cu`` and ``graph_cond.cu`` only; the other sources
   finish building while phases 2 (``kernels``), 4 and 4b run, and
   phases 3-3c come after 4b.
2. kernels — each queue kernel against its plain PyTorch version on the
   same CUDA inputs, bit for bit (``torch.equal`` on every output), over
   random fronts, time ties, all-tie fronts, partial and empty fronts,
   empty and full row masks, a finite ``t_cap`` and 40 lookahead types,
   at the shapes of ``WINDOW_SHAPES`` and ``MERGE_SHAPES``; then the
   spill and stream modes at PHOLD's shapes: ``window_extract`` with its
   lex fence at each of the k candidates, tied to a candidate's time
   with the fence's seq below and above its seq, and at (inf, 2**31-1);
   ``front_merge`` in lex mode at R 4 and R 256, the rows tying front
   times with older and newer seqs.
3. attn_kernels — ``flash_attention`` and ``decode_attention`` against
   their plain versions on the same N(0,1) CUDA inputs, in float32
   (max abs error at most 1e-4) and bfloat16 (at most 2e-2, and each
   element one bf16 rounding from the plain version's at most:
   ``BF16_ROUNDING``), every output finite, at the serving paths' head
   layouts (stablelm-12b: H 32, KV 8, head_dim 160; jamba: H 64, KV 8,
   head_dim 128, flash at its exact prompt lengths, and qwen2-vl's, the
   same heads, at phase vlm's T 256; hubert-xlarge: H 16, KV 16,
   head_dim 80, bidirectional, T = S = 499 and 32; deepseek's MLA
   prefill: H = KV = 16, qk head dim 192 with v zero past its 128
   columns, causal, T 4, 16, 32 and 2048, the padded output columns 0),
   every head dim from 16 to 256 in steps of 16 on the route each dtype
   takes, and
   the designs' edges (``FLASH_SHAPES``, ``DECODE_SHAPES``: T off the
   query tile, G 1 to 16, S != T, decode lengths at split boundaries and
   0 beside long ones); a sequence of length 0 must come out 0.  The
   worst bf16 errors are printed beside those of the kernels these
   replaced.
3b. rwkv_kernel — ``rwkv6_scan`` against its plain version (the
   sequential recurrence in f32) on the same CUDA inputs, f32 and bf16:
   the serving prefill's shapes (B 1, H 32, K 64, T 4, 13, 16), T 2048 at
   B 1 and B 4, K 16 and 32, strided views of the model's ``[B,T,H,K]``
   streams and contiguous inputs, the model's decay range and a strong
   decay (log w near -20); and the kernel's edges (``RWKV_CASES``): T at
   its 16-token tile - 1 and + 1, B 3, one, two and four column groups a
   head (K 16, 32, 64), rows at odd strides (narrow copies) and log w at
   the model's clamp floor, -e^4.  y and the final state must agree
   within 1e-4 of the reference's largest magnitude: both sum the same
   f32 products, in another order, and a state error decays with w <= 1.
3c. mamba_kernel — ``mamba_scan`` against its plain version (the
   sequential recurrence in f32) on the same CUDA inputs, f32 and bf16:
   the serving prefill's shapes (B 1, I 16384, N 16, T 4, 13, 16) with
   B_t/C_t as column slices of the model's ``x_proj`` output, T 2048,
   N 4 and 8, contiguous inputs, and a strong decay (dt near 15); and the
   kernel's edges (``MAMBA_CASES``): T at its 32-token tile - 1, the tile
   and + 1, B 3, I off the block's 32 channels, one, two and four states
   a lane (N 4, 8, 16) and ``x_proj`` slices at an odd column.  y and
   the final state must agree within 1e-5 of the reference's largest
   magnitude (both printed).
4. phold — PHOLD at a GPU PDES deployment's size (917,504 LPs, one
   message each, a 1,048,576-event queue) through
   ``SimProgram.build(backend="device")`` on the card, then the same
   program on the CPU for the same super-steps: state, counters,
   word histogram and every final queue field must be bit-identical,
   and each kernel's launch count must equal the super-step count.
4b. phold_fused — the same PHOLD under ``fused`` dispatch, its hot set
   the switch run's most frequent word (``hot_words_from_counts``),
   held bit for bit to phase 4's CPU run; its host syncs must equal the
   switch run's.
5. poc — the paper's model (16 iterations, 256 events) under
   ``switch``, ``masked`` and ``fused`` (the switch run's top 4 words):
   each card run bit for bit equal to one CPU ``switch`` run, the final
   ``sum`` equal to the oracle, and fused's hot and fallback windows
   both fired.
5b. mmc — the M/M/c network (``examples/mmc_network.py``) under the
   three modes (fused: the switch run's top 8 words), each card run held
   bit for bit to one CPU ``switch`` run: (a) the example's own size, 4
   stations, ``t_open`` 30, run until the queue drains; (b) 65,536
   stations, windows of 4, a 1,048,576-event queue holding the TALLY
   grid's 524,288 events, ``MMC_BATCHES`` super-steps.  The run path
   must have fired, ``served`` and ``samples`` be non-zero and every
   arrival be served, queued or in service.
5c. serving_admission — the closed admission scenario
   (``repro/serving/scenarios.py``: 64 slots, 65,536 requests, decode
   budgets up to 6, windows of 4, a 65,536-event queue) for
   ``ADMIT_BATCHES`` super-steps under the three modes, each held bit
   for bit to one CPU ``switch`` run (the card's int32 wraparound in the
   request hash included).
   Every run of 4b-5c launches ``window_extract`` and ``front_merge``
   once a super-step and no other kernel, and prints its setup seconds,
   card seconds (the initial queue's build included), super-steps per
   second, host syncs per super-step and the windows that took the run
   path, a hot slot and the fallback.
5c2. captured — the device engine's captured loop
   (``build(loop="captured")``: one super-step captured as a CUDA graph
   with conditional nodes, replayed ``chunk`` steps a host read): (a)
   phase 4's PHOLD (917,504 LPs, 4,096 super-steps, ``switch``) held bit
   for bit to phase 4's card run, its rare-path counts equal, each queue
   kernel launched once a super-step (counted from the graph's bodies),
   one loop read a chunk; steps/s at chunks of 32, 64
   and 128 (``MODES_BATCHES`` steps each), capture seconds and peak
   memory beside phase 4's numbers; (b) the same PHOLD under ``masked``
   and under ``fused`` (phase 4b's hot set) for ``MODES_BATCHES``
   steps, each held to the
   eager card run of the same configuration; (c) phase 5's PoC and
   phase 5b's M/M/c runs (both sizes) in the three modes, each held to
   that phase's card run with equal ``run_path`` and fused counts; (d)
   a cheap-validation fault (a hop emitting at -inf) and
   ``overflow="error"``'s storm stop at the same super-step with the
   same fault word as the eager loop.  Last in the script, after every
   timed phase (``captured_profile``): (a)'s graph replayed for 64 steps
   under ``torch.profiler``, which must count each queue kernel 64
   times, as the launch counts do.
5d. overflow — (a) the overflow storm of ``repro_torch.testing.faults``
   on the card: ``overflow="error"`` raises ``FAULT_OVERFLOW`` and
   ``overflow="spill"`` matches the oversized queue with nothing dropped
   or left in the pool; (b) PHOLD at phase 4's width under
   ``overflow="spill"`` in a 786,432-event queue: the 131,072 lex-latest
   seeds start in the host pool (a rebalance at the first boundary), the
   fence (393216.0, 786432) is live in every extract, and the run is
   held bit for bit to phase 4's card run (state, checksum, events,
   batches, final_time); then the same spilling run in the captured
   loop, held to (b) (:func:`_captured_run`).
5e. resume — the same PHOLD with ``validate="cheap"`` and a checkpoint
   every 1,024 super-steps into a temporary directory; a crash after
   segment 2, then ``resume_from="latest"``, held bit for bit to phase
   4's card run; prints a checkpoint's bytes, the seconds of one
   synchronous save of the carry, and the steps/s beside phase 4's.
5f. faults — ``run_all_scenarios(validate="full")`` on the card: the
   five corruptions detected and recovered, the crash resumed, the
   storm.
5g. stream — the open admission scenario (64 slots, 65,536 requests of
   a Poisson stream on the 0.25 grid, blocks of 4,096, ``until`` t = 580,
   about 1,050 super-steps): (a) streamed into a 65,536-event queue and
   (b) into a 512-event queue under ``overflow="spill"``, each held bit
   for bit to the port's CPU run of the same case and equal (state,
   events, dropped, final_time) to the trace pre-seeded on the card.
   The segmented runs of 5d-5g launch ``window_extract`` once a
   super-step and ``front_merge`` once a super-step and once an absorbed
   chunk; each prints its host syncs per super-step inside the engine's
   loop (``loop_syncs``) beside the total.  5d (b), 5g (a) and (b) and
   each of 5h's other queues also run in the captured loop
   (``loop="captured"``), each held bit for bit to its eager card run:
   every field of (a)'s check, spilled, ingested, shed, the fault word,
   the final fence, the engine's counts, the kernels' launches, one
   capture for the whole run and one loop read a chunk of each segment;
   each prints its replayed steps/s beside the eager loop's, loop reads
   a step, captures, capture seconds, steps a segment and peak memory.
5g2. host — the host backend (``build(backend="host")``): (a) phase 4's
   PHOLD (917,504 LPs, the whole pending set in the host heap) to
   ``until`` ``HOST_UNTIL`` under ``conservative``, ``speculative`` and
   ``unbatched`` with ``jit_handlers=True`` (``torch.compile`` of each
   batch word, or each handler) and ``conservative`` eager, each held
   bit for bit to a device-backend card run with the same horizon
   (state, checksum, events, final_time, 0 dropped; the conservative
   runs also its batch count); (b) phase 5's PoC workload on
   ``conservative``, compiled, under ``codec="dense"`` and ``"paper"``,
   held to the oracle and to phase 5's card ``switch`` run, with the
   time of a call of the compiled words ``[Increment, Set]`` and ``[Set,
   Increment]`` beside the eager route's; (c) 5g (a)'s open admission
   stream into ``conservative``, eager, held to 5g (a)'s card run
   (state, events, dropped, final_time; the host pushes the whole
   source, so ``ingested`` differs by design); (d) the saturating
   f32-to-int32 cast on the card against XLA's values (``CAST_XLA``)
   and its CPU result.  No kernel launches.  Each run prints its setup
   seconds (the heap's build), run seconds, batches/s, events/s, host
   reads a batch, words composed and compile seconds (total, largest).
5g3. analysis — the static analyzer (``repro_torch.analysis``): (a) its
   six targets (``ANALYSIS_TARGETS``) analyzed with their example
   states on the card and on the CPU, the two reports equal
   (``to_json``) and clean, with no kernel launched and no engine count
   moved, each with its seconds; (b) ``build(dispatch_mode="fused",
   hot_words="static")`` for phase 5's PoC and phase 5c's closed
   admission scenario, each bit for bit equal to that phase's
   ``switch`` card run (state, events, batches, word histogram, final
   queue), with the static hot set's size and the windows that took a
   hot slot; (c) ``check="error"`` on a program whose lookahead (5.0)
   exceeds its emission delay (1.0) raises ``AnalysisError`` at build
   (example state declared, on the card) and at the first run (none
   declared), before any launch or handler call on a real tensor, and
   passes PHOLD at phase 4's width, with its analysis seconds; (d) the
   run handlers (``make_run_handler``, ``make_masked_run_handler``) on
   out-of-range entity ids (``C3_CASES``) on the card, equal to the CPU
   and to JAX's values, with no device-side assert.
5h. queue_modes — phase 4's PHOLD (917,504 LPs, a 1,048,576-event
   queue) for ``MODES_BATCHES`` super-steps on the card under
   ``queue_mode="tiered3"`` (the yardstick), then ``"flat"`` and
   ``"reference"`` (``MODES_REF_BATCHES``), and ``"tiered"`` for
   ``TIERED_BATCHES`` (phase 4's 4,096, so that its staging flush and
   refills run; held to phase 4's card run), each held bit for bit to a
   tiered3 card run of as many super-steps: state, checksum,
   events, batches, dropped, emitted, final_time, word histogram and the
   live ``(time, seq, type, args)`` rows of the final queue, lex-sorted.
   The two-tier queue launches each queue kernel once a super-step, the
   flat and reference queues none.
5i. sharded — (a) the same PHOLD at ``SHARDS`` shards under ``switch``
   and ``validate="cheap"``, held bit for bit to 5h's tiered3 run with
   the flat view of the final queue: ``front_merge`` launches
   ``SHARDS`` times a super-step, ``window_extract`` never, and a common
   super-step reads the host as often as the single queue's; (b)
   ``FUSED_SHARDS`` shards under ``fused`` (phase 4b's hot set) on small
   tiers (``FUSED_SHARD_TIERS``), so every shard's refills and flushes
   run, held to (a)'s tiered3 run; (c) the closed admission scenario of 5c at
   ``SHARDS`` shards, held to 5c's ``switch`` card run; (d) 5g (a)'s
   open admission stream into ``STREAM_SHARDS`` shards, held to 5g (a)'s
   card run (``front_merge`` once a shard and super-step plus once an
   absorbed chunk and shard).  Every run of 5h and 5i prints its setup
   seconds, card seconds, super-steps per second, host syncs a
   super-step (loop and total) beside the single queue's and its
   launches.  Each case of 5i also runs in the captured loop
   (``loop="captured"``, ``_captured_run``): the sharded super-step,
   every shard's refill and pre-flush a conditional node of its own,
   captured once and replayed, held bit for bit to the case's eager
   run with equal rare-path counts and ``front_merge`` launches (N a
   super-step inside the graph, plus (d)'s absorbed chunks), one
   capture a run and one loop read a chunk of each segment; it prints
   its replayed super-steps/s beside the eager loop's, its capture
   seconds, the graph's conditional nodes, bodies and counter slots,
   and its peak memory.
5j. stacked — 5i (a)'s PHOLD at ``SHARDS`` shards run
   ``STACKED_BATCHES`` super-steps, then stacked
   (``stack_sharded_queue``): the eight ``tiered3_stacked_*`` helpers,
   ``stacked_sharded_fault_bits`` (0) and the engine's stacked occupancy
   and absorb, each bit for bit equal to the tuple-of-shards op on the
   same CUDA tensors; the stacked fill launches ``front_merge`` once a
   shard.
5j2. devices — the sharded engine's ``placement="devices"``, one shard
   queue a rank over ``torch.distributed``, PHOLD at 5h's size for
   ``MODES_BATCHES`` super-steps: (a) ``shards=1`` over an NCCL group of
   one rank in this process, held bit for bit to 5h's tiered3 run
   (``rows_problems``), beside the serial engine at one shard; (b)
   ``DEVICES_RANKS`` ranks on the one card over gloo, each a child
   process (``devices_rank``, the kernels loaded from the build
   directory), ``validate="cheap"``, rank 0's gathered outcome held to
   5i (a)'s serial run; (c) ``DEVICES_FUSED_RANKS`` ranks under ``fused``
   on ``FUSED_SHARD_TIERS``, held to 5i (b)'s serial run, then a run
   checkpointed every ``MODES_BATCHES // 2`` crashed after its first
   segment and resumed (the restore through ``place_queue``), held to
   the uninterrupted run.  (b) and (c)'s ranks start with the phase and
   set up during (a); each case runs alone on the card.  Every rank
   launches ``front_merge`` once a super-step and ``window_extract``
   never, makes 2 collectives a super-step (3 validated) and at least 4
   host reads, no more than the serial run's; each case prints its
   backend, ranks and cards, each rank's super-steps/s, seconds, set-up
   seconds, host reads and collectives a super-step, launches and peak
   memory, and the ratio to the serial run at as many shards.  (a) also
   runs in the captured loop on its NCCL rank, the heads', guards'
   gathers inside the CUDA graph at its top level: held bit for bit to
   the eager rank's run and to 5h's tiered3 run, ``front_merge`` once a
   super-step, 2 collectives a super-step (counted from the replays),
   one loop read a chunk, its replayed super-steps/s beside the eager
   rank's.  The ranks of (b) and (c) each also build ``loop=
   "captured"`` and get the NCCL-only refusal, with no launch: gloo
   stages CUDA collectives through the host, which a graph cannot
   capture.  NCCL at more than one rank needs as many cards and is not
   run.
5k. wireless — the paper's §IV.A example
   (``repro_torch.examples.wireless_des``): the host run with its batch
   words compiled by Inductor (in a child process started with the
   script, one compile thread, so that its compiles overlap the earlier
   phases) and eager, and the device runs in the two-tier queue
   (capacity 4096) and the flat queue (64) on the card, each inbox,
   batch, event and drop count equal to a CPU eager run; its analysis
   from the card template equal to the CPU one, no launch; then the
   cross-event check, reported and not gated: whether the message's
   work (the LCG multiplier) appears in the generated code of the dead
   word ``[SleepAll, Broadcast, WakeAll]`` and of the live word
   ``[WakeAll, Broadcast, SleepAll]``, each word's warm ms a call (CUDA
   events) and their ratio; the compiled words must deliver nothing and
   the message.
6. serve — stablelm-12b at full width (40 layers, d_model 5120, 12.1 B
   parameters in bf16) through ``repro_torch.launch.serve`` with its
   defaults: 6 requests, 12 new tokens each, 4 slots, ``max_len`` 256.
   Every request must finish, with ``flash_attention`` launched
   2 * layers * prefills times and ``decode_attention`` layers * decode
   events times.  Then one prompt is teacher-forced through ``prefill``
   and 8 ``decode_step``s with the kernels and with the reference
   attention: the logits must agree to a cosine similarity of 0.999.
6b. serve_rwkv — rwkv6-1.6b at full width and depth (24 layers of
   ``(rwkv, rwkv_cm)``, d_model 2048, 1.58 B parameters in bf16) through
   the same launcher with the same defaults.  Every request must finish,
   with ``rwkv6_scan`` launched 2 * layers * prefills times (``prefill``
   and the second ``forward`` of each prompt) and the attention kernels
   not at all; then the teacher-forced check against
   ``attn_impl="blockwise"`` (the chunked plain scan).
6c. serve_jamba — jamba-1.5-large-398b cut to its first two layers,
   ``[(gqa, mlp), (mamba, moe)]``, at full width (d_model 8192, 64 heads,
   16 experts top-2, mamba d_inner 16384: 11.9 B parameters in bf16),
   through the same launcher with the same defaults.  Every request must
   finish, with ``mamba_scan`` launched 2 * mamba layers * prefills times,
   ``flash_attention`` 2 * gqa layers * prefills and ``decode_attention``
   gqa layers * decode events, the other kernels not at all.  Then the
   teacher-forced check against ``attn_impl="blockwise"`` in bf16, with
   the routing teacher-forced too: one MoE router sits between the scan
   and the logits, so the kernel route takes ``blockwise``'s expert
   choices (its own choices are compared and each difference printed
   with its margins), every logit row must reach a cosine of 0.999, and
   the mamba layer's output, kernel against plain, 0.9999.
6c2. serve_deepseek — deepseek-v2-lite-16b at full width and depth (27
   layers: ``(mla, mlp)``, then 26 ``(mla, moe)`` with 64 experts top-6
   and 2 shared; MLA kv_lora_rank 512, qk head dim 128 + 64, v 128:
   15.7 B parameters in bf16) through the same launcher with the same
   defaults.  Every request must finish, with ``flash_attention``
   launched 2 * layers * prefills times (MLA prefill at qk head dim 192)
   and no other kernel (the absorbed decode over the 512 + 64 latent
   cache is plain torch, as in JAX); the cache must hold ``ckv`` and
   ``kr`` only, 31,104 bytes a token.  Then the teacher-forced check
   against ``blockwise`` with the routing teacher-forced, as 6c's.
6c3. vlm — qwen2-vl-72b cut to its first 2 of 80 layers at full width
   (d_model 8192, 64 heads, 8 KV heads, head_dim 128, M-RoPE sections
   (16, 24, 24), d_ff 29568: 4.2 B parameters): (a) ``prefill`` from
   seeded patch embeddings ``[1, 256, 8192]`` on a three-stream grid (64
   text positions, then a 2 x 8 x 12 image block), ``flash_attention``
   launched once a layer and no other kernel, then ``forward`` on the
   same input; every logit row, the prefill's last row and the K/V cache
   must reach a cosine of 0.999 against ``blockwise``; (b) the serve
   launcher's defaults (text tokens): ``flash_attention`` 2 * layers *
   prefills, ``decode_attention`` layers * decode events, run under
   torch's CUDA sync debug mode ("warn"): every synchronizing call is
   printed by its line, and none may come from outside the engine (the
   model's M-RoPE, attention and kernels wait on nothing).
6d. hubert — hubert-xlarge at full width (d_model 1280, 16 heads of 80,
   d_ff 5120, layernorm, gelu, bidirectional), depth cut to 2 of its 48
   layers, bf16, random weights from seed 0: ``LM(cfg,
   attn_impl="pallas").forward(embeds=...)`` on seeded frame embeddings
   ``[1, 512, 1280]`` against ``attn_impl="blockwise"`` on the same
   weights.  Every row's logits must reach a cosine of 0.999 (over the
   504 vocabulary entries), with ``flash_attention`` launched once a
   layer and no other kernel.
6e. train — the training path (``repro_torch.training``,
   ``repro_torch.launch.train``), which launches no kernel (JAX's runs
   ``blockwise`` attention and no Pallas kernel): (a) granite-moe-1b-a400m
   at full width and depth (24 ``(gqa, moe)`` layers, d_model 1024, 32
   experts top-8, 1.33 B parameters, bf16 weights from seed 0), 8 x 1024
   tokens in 2 strided microbatches, cosine AdamW at 3e-4: 2 steps
   without remat and 4 with it from the same state; remat's first loss
   and grad norm within 1e-3 relative of the plain step's, its peak
   device memory lower, every loss finite; ms a step, tokens/s, peak
   memory and the state's bytes printed; (b) the supervisor through
   ``launch.train.train``: the same width cut to 2 layers, 8 x 512
   tokens, 8 steps, a checkpoint every 4, a crash at 6 and a straggler at
   7: one restart, one mitigation, 10 steps run, ``opt.step`` 8, the
   first replayed loss bit-identical to the first pass's, later ones
   within 1e-3; a checkpoint's bytes, save and restore seconds; (c) one
   microbatched, rematerialized step of the reduced granite, stablelm,
   deepseek (MLA) and hubert (an ``embeds`` batch of the data pipeline)
   on the card and on the CPU from one f32 state and batch
   (loss, grad norm and every leaf within the ``CARD_*`` tolerances,
   printed beside the worst errors), and a step with gradient
   compression; (d) ``LM(cfg, attn_impl="pallas").loss`` against
   trainable leaves raises before any launch, directly and through the
   train step.
6f. roofline — ``repro_torch.launch.graph_cost`` and ``roofline`` at
   H100 rates: (a) one bf16 and one f32 matrix product on the card,
   counted as exactly their analytic FLOPs and bytes, with their
   TFLOP/s; (b) the cells phases serve and train time (stablelm-12b's
   decode step at 4 slots and ``max_len`` 256, granite's remat step at
   8 x 1024 tokens in 2 microbatches): FLOPs, bytes, the bound, the
   measured ms and model-FLOPs share of the bf16 peak; the decode cell
   must move at least its parameter bytes.  The roofline of every
   (arch x shape) cell allocates nothing on the card and is left to
   ``python -m repro_torch.launch.roofline --all``.
6g. mesh — the production mesh, the sharding rules and the dry run
   (``repro_torch.launch.mesh``, ``sharding``, ``dryrun``): (a) an NCCL
   process group of one rank and a (1, 1) ("data", "model") mesh from
   ``make_host_mesh``; granite-moe-1b-a400m at full width: one train
   step (4 x 1024 tokens, 2 microbatches, remat) with its train state
   and batch placed by the rules as ``DTensor``s, and a prefill of 2 x
   128 prompts and 4 greedy decode steps on the kernel route with its
   weights, cache and tokens placed by the rules, each held to the same
   run without a mesh: bit-identical, or the first differing field
   printed and the loss and grad norm within 1e-5 relative, each
   parameter within one bf16 ulp, logits within 1e-3, tokens equal;
   ``flash_attention`` and ``decode_attention`` launched as often as
   without the mesh, and more than 0; (b) ``python -m
   repro_torch.launch.dryrun`` in a child process a cell, started with
   the script (the fake process group of 256 or 512 ranks needs a
   process of its own): llama3-405b ``train_4k`` on the multi-pod mesh,
   deepseek-v2-lite-16b ``decode_32k`` on the pod, jamba-1.5-large-398b
   ``long_500k`` on the multi-pod mesh (its cache sequence-sharded over
   every axis), CUDA avatars at full size; each cell's per-device
   compute, memory and collective seconds, argument and peak-live bytes
   and trace seconds printed, and collective bytes required.
7. timing — each kernel and its plain version at the main path's shapes
   (CUDA events over back-to-back calls: ``ms``), the kernel's device
   time with the host taken out (calls captured in a CUDA graph:
   ``device_ms``; for the queue kernels beside ``launch_floor_ms``, the
   device time of a one-element ``fill_`` timed the same way), beside
   the least time the card could take for the bytes each call must move,
   the f32 operations it must do and its exps on the special-function
   units, and, for
   attention, one ``scaled_dot_product_attention`` call on the same
   inputs, timed both ways (``library_ms``, ``library_device_ms``),
   flash also at deepseek's MLA layout (T 16, 32 and 2048; the record
   at the serving bucket, T 32);
   ``rwkv6_scan`` and ``mamba_scan`` at the serving prefill's T 16 and at
   T 2048 (no PyTorch call computes either); the queue kernels also in
   their spill and stream modes (``fenced_device_ms``,
   ``lex_R4_device_ms``, ``lex_R256_device_ms`` in their records).

Each path (PHOLD, each run of PHOLD fused, PoC, the M/M/c network and
the admission scenario, the segmented runs, the host runs, the
analyses and the static fused runs, each rank of phase devices, each
served model, qwen2-vl's
embeds prefill, hubert's forward, the training phase, phase mesh's runs
with and without the mesh) runs with every kernel's launch count set to
0 just before it and read just after.

The second-to-last lines are the kernels' JSON record and the card's
``name, power.limit``; the last line is ``{"ok": true, "device": ...}``.
Any failure exits non-zero before that line.  Without a CUDA device,
or outside a checkout of the repository, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent

# PHOLD as a GPU PDES deployment: one message per LP, the pending set at
# 87.5% of the queue, and a horizon no hop reaches within the run (the
# population stays constant; initial times reach 458,751.5).
PHOLD_LPS = 917_504
PHOLD_CAPACITY = 1_048_576
PHOLD_T_STOP = 4_194_304.0
PHOLD_BATCHES = 4096

# The M/M/c network at full size: 65,536 stations, so the TALLY grid
# (every 5.0 up to t_open + 10) alone schedules 8 x 65,536 = 524,288
# events, half a million rows of a 1,048,576-event queue; windows of 4
# keep the word histogram (3 types: 120 words).  The closed admission
# scenario at 64 slots and 65,536 requests.  Both run 1,024 super-steps
# a mode, which keeps the script within about a minute of its time
# before these phases (2,048 and 4,096 took two).
MMC_STATIONS = 65_536
MMC_T_OPEN = 35.0
MMC_CAPACITY = 1_048_576
MMC_BATCH_LEN = 4
MMC_BATCHES = 1024
ADMIT_SLOTS = 64
ADMIT_REQUESTS = 65_536
ADMIT_BATCHES = 1024

# Segmented runs.  PHOLD under overflow="spill" in 3/4 of the phold
# phase's queue: the 131,072 lex-latest seeds (t >= 393,216) start in
# the host pool, and the fence (393216.0, 786432) is live in every
# extract; no hop of the run gets near it.  The resume phase's segments
# are CKPT_EVERY super-steps, the crash comes after the second.
SPILL_CAPACITY = 786_432
SPILL_FENCE = (393_216.0, 786_432)
CKPT_EVERY = 1024
# The open admission scenario at the closed one's size: 65,536 requests
# from a Poisson stream on the 0.25 grid (rate 3.5), blocks of 4,096 and
# a horizon of t = 580: 1,051 super-steps and 1,580 admitted arrivals,
# all from the first block.  A 4,096-event queue would hold those
# without spilling, so the spill run's queue holds 512 (a third of them):
# its pool is rebalanced as well as absorbed.
STREAM_RATE = 3.5
STREAM_BLOCK = 4096
STREAM_UNTIL = 580.0
STREAM_CAPACITY = 65_536
STREAM_SPILL_CAPACITY = 512

# The queue modes and the sharded engine on phase 4's PHOLD: each run
# MODES_BATCHES super-steps, held to one tiered3 card run of as many.
# The reference queue's serial argmin rounds run MODES_REF_BATCHES.
# The host phase: PHOLD's horizon (about 2,800 events of phase phold's
# program), and the saturating cast's inputs with XLA's convert of them
# (``jnp.asarray(CAST_VALUES, jnp.float32).astype(jnp.int32)``).
HOST_UNTIL = 85.0
CAST_VALUES = [3e9, -3e9, float("nan"), 2.5e9, float("inf"), -float("inf"),
               2147483520.0, -2147483648.0, -1.5, 1.5]
CAST_XLA = [2147483647, -2147483648, 0, 2147483647, 2147483647,
            -2147483648, 2147483520, -2147483648, -1, 1]
# The analysis phase: the analyzer's six targets, and C3's entity ids
# with JAX's results for ``s + 1`` over the leaf [0, 1, 2, 3].
ANALYSIS_TARGETS = ("repro_torch.examples.phold:make_program",
                    "repro_torch.examples.mmc_network:make_program",
                    "repro_torch.serving.scenarios:make_program",
                    "repro_torch.serving.scenarios:make_open_program",
                    "repro_torch.poc:make_program",
                    "repro_torch.examples.wireless_des:make_program")
C3_CASES = [([2**31 - 1, 1], [0, 2, 2, 3]), ([-1, 1], [0, 2, 2, 4]),
            ([-5, 1], [0, 2, 2, 3]), ([4, 1], [0, 2, 2, 3])]
# 512 since the sharded engine's captured runs joined phases sharded and
# devices: a slow host took 1,080 s of the 1,200 s limit at 1,024.
MODES_BATCHES = 512
MODES_REF_BATCHES = 512
SHARDS = 4
FUSED_SHARDS = 2
STREAM_SHARDS = 2
# No rare queue path fires in PHOLD's first 1,024 super-steps (the
# fronts stay full of emits near the clock).  So the two-tier run goes
# phase 4's 4,096 super-steps, held to phase 4's card run: its staging
# flush, an O(capacity) counting-merge of the 1,048,576-slot ring, and
# its refills run on the card.  The fused shards run on small tiers (the
# result does not depend on them), so each shard's refills, flushes,
# runs and merges, decided by the stacked flags, run within 1,024.
TIERED_BATCHES = PHOLD_BATCHES
FUSED_SHARD_TIERS = dict(front_cap=32, stage_cap=64, num_runs=4)
STACKED_BATCHES = 64       # phase stacked: PHOLD super-steps before the checks

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory

# Phase train: granite-moe-1b-a400m (hf ibm-granite/granite-3.0-1b-a400m-base)
TRAIN = "granite-moe-1b-a400m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 1024, 2
TRAIN_STEPS_PLAIN, TRAIN_STEPS_REMAT = 2, 4
TRAIN_LR = 3e-4
# Phase mesh: (a) the one-rank mesh's train step and served prompts;
# tolerances where a field is not bit-identical (params: one bf16 ulp).
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 1024
MESH_B, MESH_T, MESH_MAX_LEN, MESH_STEPS = 2, 128, 256, 4
MESH_TRAIN_RTOL = 1e-5
MESH_LOGIT_ATOL = 1e-3
# (b) the dry run's cells, full size, each in a child process.
DRYRUN_CELLS = (("llama3-405b", "train_4k", "multi"),
                ("deepseek-v2-lite-16b", "decode_32k", "single"),
                ("jamba-1.5-large-398b", "long_500k", "multi"))
DRYRUN_TIMEOUT = 900
TRAIN_REMAT_RTOL = 1e-3    # remat's first step against no remat's; replays
SUP_LAYERS, SUP_SEQ, SUP_STEPS = 2, 512, 8
SUP_CKPT_EVERY, SUP_CRASH, SUP_STRAGGLER = 4, 6, 7
# (c): card against CPU in f32 from one state.  The gradients are the
# gate: each leaf's within CARD_GRAD_RTOL in relative L2 norm.  After the
# step a parameter's element may be up to 2 lr apart where its gradient
# is near 0 (Adam's first step is +-lr whatever the gradient's size), so
# the updated leaves are held only to CARD_LEAF_LRS lr beyond 1e-6 of |p|.
CARD_LOSS_RTOL, CARD_NORM_RTOL, CARD_LEAF_LRS = 1e-5, 1e-4, 2.05
CARD_GRAD_RTOL = 1e-4
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores

HUBERT = "hubert-xlarge"
HUBERT_LAYERS = 2          # of 48
# 512 frames (10.24 s of audio at 20 ms): both packages' flash_attention
# take T only as a multiple of its 128-row block_q past 128, so the 499
# frames of 10 s run through the kernel directly (FLASH_SHAPES).
HUBERT_T = 512

# Phase serve_deepseek: deepseek-v2-lite-16b at full width and depth
# (arXiv:2405.04434, hf deepseek-ai/DeepSeek-V2-Lite): 27 layers, MLA
# (kv_lora_rank 512, qk_nope 128, qk_rope 64, v 128), 64 experts top-6
# and 2 shared, the first layer dense.
DEEPSEEK = "deepseek-v2-lite-16b"
# Phase vlm: qwen2-vl-72b (arXiv:2409.12191, hf Qwen/Qwen2-VL-72B) cut to
# its first VLM_LAYERS layers at full width; (a) feeds VLM_T frame
# embeddings: VLM_TEXT text positions, then an image block of
# VLM_IMAGE (t, h, w) patches, so the three M-RoPE streams differ.
VLM = "qwen2-vl-72b"
VLM_LAYERS = 2             # of 80
VLM_TEXT = 64
VLM_IMAGE = (2, 8, 12)
VLM_T = VLM_TEXT + VLM_IMAGE[0] * VLM_IMAGE[1] * VLM_IMAGE[2]   # 256
# The MLA prefill's flash layout (deepseek: H = KV = 16, qk head dim
# 128 + 64, v zero-padded from 128): the serve launcher's prompt lengths
# (4-16), its bucket (32) and T 2048.
MLA_FLASH = [(1, 16, 16, T, T, 192, True) for T in (4, 16, 32, 2048)]
MLA_V_DIM = 128
MLA_ROPE_DIM = 64       # the one rope key all heads share

# The serving path's attention shapes (stablelm-12b: 32 heads, 8 KV
# heads, head_dim 160) and the designs' edges: (B, H, KV, T, S, D,
# causal) for flash -- T off the 128-row tile (7, 16, 100, 499, 1000), G
# 1, 3, 4 and 8, S != T without the causal mask, hubert-xlarge's layout
# (16 heads, MHA, head_dim 80, bidirectional; the hubert phase's
# HUBERT_T, and 499 frames, 10 s of audio at 20 ms) -- and (B, H, KV, S,
# D, lengths) for decode, where "edges" puts lengths at 0 and at the
# first split boundary +- 1 beside long ones (``choose_splits`` of the
# card), G 1 to 16 (two head chunks) and D 48 to 256.  FLASH_HEAD_DIMS adds every head dim the wrappers
# take, in both dtypes.
FLASH_SHAPES = [(1, 32, 8, 32, 32, 160, True), (1, 32, 8, 128, 128, 160, True),
                (1, 32, 8, 2048, 2048, 160, True),
                (1, 24, 8, 512, 512, 128, True),
                (1, 4, 4, 256, 256, 64, False),
                # jamba (64 heads, 8 KV heads, head_dim 128), exact lengths
                (1, 64, 8, 7, 7, 128, True), (1, 64, 8, 16, 16, 128, True),
                # hubert-xlarge: the hubert phase's T, and 10 s off the tile
                (1, 16, 16, HUBERT_T, HUBERT_T, 80, False),
                (1, 16, 16, 499, 499, 80, False),
                (1, 16, 16, 32, 32, 80, False),
                # qwen2-vl's prefill in phase vlm (a): jamba's heads at VLM_T
                (1, 64, 8, VLM_T, VLM_T, 128, True),
                (2, 32, 8, 100, 100, 160, True),
                (1, 8, 8, 1000, 1000, 64, True),
                (1, 32, 8, 100, 300, 160, False),
                (2, 16, 2, 48, 17, 128, False),
                (1, 8, 2, 50, 50, 48, True)]
FLASH_HEAD_DIMS = range(16, 257, 16)     # at (1, 6, 2, 100, 100, D, D % 32)
DECODE_SHAPES = [(4, 32, 8, 256, 160, (1, 31, 200, 256)),
                 (4, 32, 8, 4096, 160, (4096, 1000, 17, 2049)),
                 (4, 64, 8, 256, 128, (1, 31, 200, 256)),
                 (6, 32, 8, 4096, 160, "edges"),
                 (6, 8, 8, 4096, 64, "edges"),
                 (6, 64, 8, 4096, 128, "edges"),
                 (2, 32, 2, 300, 64, (7, 300)),
                 (3, 8, 2, 77, 48, (77, 5, 40)),
                 (2, 16, 8, 128, 256, (128, 64))]
# Worst bf16 errors of the earlier CUDA-core versions of these kernels,
# measured on one H100, printed beside this run's.
CUDA_CORE_BF16_ERR = {"flash_attention": 0.0039, "decode_attention": 0.00098}
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# A bf16 output and the plain version's (f32 sums rounded once) are each
# within half a bf16 ulp (at most 2^-8 of the value) of their f32 sums, so
# each element must also lie within BF16_ROUNDING of the larger magnitude
# plus the f32 tolerance: one rounding apart.  Unlike the absolute 2e-2,
# this holds late rows of a long sequence (|o| about 0.04) to their size.
BF16_ROUNDING = 2.0 ** -7
SERVE_ARGS = ["--arch", "stablelm-12b"]
TEACHER_STEPS = 8
MIN_COSINE = 0.999

RWKV_SERVE_ARGS = ["--arch", "rwkv6-1.6b"]
# (B, H, T, K, layout, decay): the serving prefill (H 32, K 64, prompts
# of 4-16 tokens), long sequences, the reduced and JAX-sweep head dims;
# then the kernel's edges: T at its 16-token tile - 1 and + 1, B 3, every
# K (one, two and four column groups a head), rows at odd strides (the
# "odd" layout: 4-byte copies in f32, plain loads in bf16) and log w at
# the model's clamp floor (-e^4 every token: "clamp").
RWKV_CASES = [(1, 32, 4, 64, "view", "model"),
              (1, 32, 13, 64, "view", "model"),
              (1, 32, 16, 64, "view", "model"),
              (1, 32, 2048, 64, "view", "model"),
              (4, 32, 2048, 64, "view", "model"),
              (2, 8, 100, 16, "contiguous", "model"),
              (2, 8, 77, 32, "view", "model"),
              (1, 32, 64, 64, "view", "strong"),
              (2, 4, 33, 16, "contiguous", "strong"),
              (1, 32, 15, 64, "view", "model"),
              (1, 32, 17, 64, "view", "model"),
              (3, 5, 33, 64, "view", "model"),
              (3, 3, 17, 32, "contiguous", "strong"),
              (2, 3, 16, 16, "view", "model"),
              (3, 2, 31, 32, "view", "model"),
              (2, 3, 17, 64, "odd", "model"),
              (1, 2, 40, 16, "odd", "strong"),
              (1, 32, 33, 64, "view", "clamp")]
RWKV_TOL = 1e-4            # of the reference's largest |y| or |S| (>= 1)

JAMBA = "jamba-1.5-large-398b"
JAMBA_LAYERS = 2           # the block's first two: (gqa, mlp), (mamba, moe)
# (B, T, I, N, layout, decay): the serving prefill (I 16384, N 16, prompts
# of 4-16 tokens), a long sequence, the reduced and other state dims;
# then the kernel's edges: T at its 32-token tile - 1, the tile and + 1,
# B 3, I off the block's 32 channels, every N (one, two and four states
# a lane) and x_proj slices at an odd column ("proj_odd": 4-byte copies
# of B/C in f32, plain loads in bf16).
MAMBA_CASES = [(1, 4, 16384, 16, "proj", "model"),
               (1, 13, 16384, 16, "proj", "model"),
               (1, 16, 16384, 16, "proj", "model"),
               (1, 2048, 16384, 16, "proj", "model"),
               (2, 100, 128, 4, "contiguous", "model"),
               (2, 77, 256, 8, "proj", "model"),
               (1, 64, 16384, 16, "proj", "strong"),
               (3, 33, 100, 4, "contiguous", "strong"),
               (1, 31, 16384, 16, "proj", "model"),
               (1, 32, 16384, 16, "proj", "model"),
               (1, 33, 16384, 16, "proj", "model"),
               (3, 33, 100, 8, "proj", "model"),
               (2, 17, 40, 4, "proj", "model"),
               (1, 5, 31, 16, "contiguous", "model"),
               (2, 33, 96, 16, "proj_odd", "model"),
               (3, 20, 100, 4, "proj_odd", "model"),
               (1, 64, 16384, 16, "proj_odd", "strong")]
MAMBA_TOL = 1e-5           # of the reference's largest |y| or |h|
SFU_OPS_PER_S = 132 * 16 * 1.98e9   # H100 SXM special-function units (exp)
MIN_MAMBA_COSINE = 0.9999

# The queue kernels' cases: (front_cap, k, W) and (front_cap, R, W).
# PHOLD's (256, 4, 4), then the designs' edges: F off a warp (40, 100,
# 300: window_extract loops past its 256 threads), W 1 and 3 (scalar arg
# copies) and 6 (args left in memory), R 1, 31, 32 (one warp of rows), 33
# and 64, and F + R past 512 (the general merge kernel).
WINDOW_SHAPES = [(256, 4, 4), (256, 16, 4), (16, 4, 4), (40, 32, 1),
                 (100, 7, 3), (256, 32, 3), (300, 4, 6)]
MERGE_SHAPES = [(256, 4, 4), (256, 32, 4), (40, 1, 1), (100, 31, 3),
                (100, 33, 4), (256, 64, 4), (480, 32, 4), (600, 4, 4),
                (256, 4, 6)]


class PhaseError(RuntimeError):
    pass


def phase(name: str, **fields) -> None:
    print(f"PHASE {name} " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def kernel_modules():
    """The kernel modules, each with ``LAUNCHES`` and ``reset_launches``."""
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.kernels import mamba_scan, queue_front, rwkv6_scan

    return (queue_front, flash_attention, decode_attention, rwkv6_scan,
            mamba_scan)


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    for mod in kernel_modules():
        mod.reset_launches()


def read_launches() -> dict:
    """Every kernel's launch count, just after a path was driven."""
    out = {}
    for mod in kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def mixer_layers(cfg) -> dict:
    """How many layers of each mixer kind the config's stack holds."""
    out: dict = {}
    for pattern, repeat in cfg.stages():
        for spec in pattern:
            out[spec.mixer] = out.get(spec.mixer, 0) + repeat
    return out


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _front(rng, F, front_n, t_hi, W=4, num_types=3):
    import numpy as np

    t = np.sort(rng.integers(0, t_hi, front_n) * 0.5).astype(np.float32)
    ft = np.full((F,), np.inf, np.float32)
    fy = np.full((F,), -1, np.int32)
    fa = np.zeros((F, W), np.float32)
    fs = np.full((F,), 2**31 - 1, np.int32)
    ft[:front_n] = t
    fy[:front_n] = rng.integers(0, num_types, front_n)
    fa[:front_n] = rng.random((front_n, W))
    fs[:front_n] = np.arange(front_n)
    return [ft, fy, fa, fs]


def _max_abs_err(got, want) -> float:
    import torch

    worst = 0.0
    for g, w in zip(got, want):
        same = g == w
        if bool(same.all()):
            continue
        d = (g.double() - w.double()).abs()
        worst = max(worst, float(torch.where(same, 0.0, d).max()))
    return worst


def check_kernels(device) -> dict:
    """Bit-compare every kernel with its plain version; returns the
    worst absolute difference per kernel (0.0 when all agree)."""
    import numpy as np
    import torch

    from repro_torch.kernels import queue_front as qf

    def cuda(xs):
        return [torch.as_tensor(x).to(device) for x in xs]

    errs = {"window_extract": 0.0, "front_merge": 0.0}
    cases = 0
    t_hi = {"ties": 2, "all_ties": 1}
    seed = 0
    for F, k, W in WINDOW_SHAPES:
        for case in ("seed0", "seed1", "ties", "all_ties", "partial", "empty",
                     "cap", "types40"):
            seed += 1
            rng = np.random.default_rng(seed)
            front_n = {"partial": k // 2, "empty": 0}.get(case, F)
            types = 40 if case == "types40" else 3
            cols = cuda(_front(rng, F, front_n, t_hi.get(case, 8), W, types))
            la = torch.tensor(rng.integers(0, 3, types) * 0.5,
                              dtype=torch.float32, device=device)
            t_cap = 1.5 if case == "cap" else None
            got = qf.window_extract_cuda(*cols, la, t_cap, k=k)
            want = qf.window_extract_plain(*cols, la, t_cap, k=k)
            torch.cuda.synchronize()
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            errs["window_extract"] = max(errs["window_extract"],
                                         _max_abs_err(got, want))
            if not ok:
                raise PhaseError(f"window_extract F={F} k={k} W={W} {case}: "
                                 "kernel differs from plain version")
            cases += 1
    for F, R, W in MERGE_SHAPES:
        for case in ("seed0", "seed1", "ties", "all_ties", "partial", "empty",
                     "none_front", "all_front"):
            seed += 1
            rng = np.random.default_rng(seed)
            front_n = {"partial": F // 3, "empty": 0}.get(case, F)
            cols = _front(rng, F, front_n, t_hi.get(case, 8), W)
            rows = [
                (rng.integers(0, t_hi.get(case, 10), R) * 0.5).astype(
                    np.float32),
                rng.integers(0, 3, R).astype(np.int32),
                rng.random((R, W)).astype(np.float32),
                (10_000 + rng.permutation(R)).astype(np.int32),
                {"none_front": np.zeros(R, bool),
                 "all_front": np.ones(R, bool)}.get(
                     case, rng.random(R) < 0.6),
            ]
            args = cuda(cols + [np.int32(front_n)] + rows)
            got = qf.front_merge_cuda(*args)
            want = qf.front_merge_plain(*args)
            torch.cuda.synchronize()
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            errs["front_merge"] = max(errs["front_merge"],
                                      _max_abs_err(got, want))
            if not ok:
                raise PhaseError(f"front_merge F={F} R={R} W={W} {case}: "
                                 "kernel differs from plain version")
            cases += 1
    cases += check_fenced_kernels(device, errs)
    phase("kernels", cases=cases, bit_identical=True,
          max_abs_err=json.dumps(errs))
    return errs


def _same(kernel, case, got, want, errs) -> None:
    import torch

    torch.cuda.synchronize()
    errs[kernel] = max(errs[kernel], _max_abs_err(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise PhaseError(f"{kernel} {case}: kernel differs from plain "
                         "version")


def check_fenced_kernels(device, errs) -> int:
    """The spill and stream modes at PHOLD's shapes: ``window_extract``
    with its lex fence at each of the k candidates, tied to a candidate's
    time with the fence's seq below and above its seq, and at (inf,
    2**31-1); ``front_merge`` in lex mode at R 4 and R 256, the rows'
    times drawn from the front's (ties) and their seqs interleaved with
    the front's (older and newer).  Bit for bit, on the same CUDA
    inputs.  Returns the number of cases."""
    import numpy as np
    import torch

    from repro_torch.kernels import queue_front as qf

    def cuda(xs):
        return [torch.as_tensor(x).to(device) for x in xs]

    def fence(t, s):
        return (torch.tensor(np.float32(t), device=device),
                torch.tensor(np.int32(s), device=device))

    cases = 0
    F, k, W = 256, 4, 4
    for seed, t_hi in ((101, 8), (102, 2)):
        rng = np.random.default_rng(seed)
        cols = _front(rng, F, F, t_hi, W)
        ft, fs = cols[0], cols[3]
        dev_cols = cuda(cols)
        la = torch.tensor([1.0, 0.5, 0.0], device=device)
        fences = [(np.inf, 2**31 - 1)]
        for i in range(k):
            fences += [(ft[i], fs[i]), (ft[i], fs[i] - 1), (ft[i], fs[i] + 1)]
        for b_t, b_s in fences:
            for t_cap in (None, 1.5):
                bound = fence(b_t, b_s)
                _same("window_extract", f"fenced ({b_t}, {b_s}) t_cap={t_cap}",
                      qf.window_extract_cuda(*dev_cols, la, t_cap, k=k,
                                             bound=bound),
                      qf.window_extract_plain(*dev_cols, la, t_cap, k=k,
                                              bound=bound), errs)
                cases += 1
    for R in (4, 256):
        for seed, front_n in ((201, F), (202, F // 3), (203, 0)):
            rng = np.random.default_rng(seed + R)
            cols = _front(rng, F, front_n, 6, W)
            cols[3][:front_n] = 2 * np.arange(front_n)        # even seqs
            pick = rng.integers(0, max(front_n, 1), R)
            t_r = np.where(rng.random(R) < 0.7,
                           cols[0][np.minimum(pick, F - 1)],
                           rng.integers(0, 6, R) * 0.5).astype(np.float32)
            t_r = np.where(np.isfinite(t_r), t_r, 1.0).astype(np.float32)
            rows = [t_r, rng.integers(0, 3, R).astype(np.int32),
                    rng.random((R, W)).astype(np.float32),
                    (2 * rng.permutation(2 * F)[:R] + 1).astype(np.int32),
                    rng.random(R) < 0.7]
            args = cuda(cols + [np.int32(front_n)] + rows)
            _same("front_merge", f"lex R={R} front_n={front_n}",
                  qf.front_merge_cuda(*args, lex=True),
                  qf.front_merge_plain(*args, lex=True), errs)
            cases += 1
    return cases


# ---------------------------------------------------------------------------
# Phase 3: attention kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _edge_lengths(B, KV, S):
    """0, the first split boundary - 1, + 0, + 1, the second + 1, S."""
    import torch

    from repro_torch.kernels import decode_attention as da

    dev = torch.device("cuda")
    _, chunk = da.choose_splits(B, KV, S, da.sm_count(dev))
    lengths = (0, chunk - 1, chunk, chunk + 1, 2 * chunk + 1, S)
    return tuple(min(n, S) for n in lengths)[:B]


def check_attention() -> dict:
    """Each attention kernel against its plain version on the same CUDA
    inputs (model layout, read by the kernels through strides); returns
    the worst absolute difference per kernel."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(12)
    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    bf16_errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    # The worst bf16 error as a share of its one-rounding limit.
    bf16_rounding = {"flash_attention": 0.0, "decode_attention": 0.0}
    cases = []

    def gate(kind, label, got, want, tol, dtype):
        g, w = got.float(), want.float()
        err = float((g - w).abs().max())
        errs[kind] = max(errs[kind], err)
        line = f"{label} {err:.3g}"
        share = 0.0
        if dtype == torch.bfloat16:
            bf16_errs[kind] = max(bf16_errs[kind], err)
            limit = (BF16_ROUNDING * torch.maximum(g.abs(), w.abs())
                     + ATTN_TOL["float32"])
            share = float(((g - w).abs() / limit).max())
            bf16_rounding[kind] = max(bf16_rounding[kind], share)
            line += f" ({share:.3f} of one rounding)"
        cases.append(line)
        if not bool(torch.isfinite(got).all()):
            raise PhaseError(f"{kind} {label}: output not finite")
        if not err <= tol:
            raise PhaseError(f"{kind} {label}: error {err} above {tol}")
        if not share <= 1.0:
            raise PhaseError(f"{kind} {label}: an output is {share} times "
                             "one bf16 rounding from the plain version's")

    sweep = [(1, 6, 2, 100, 100, D, D % 32 == 0) for D in FLASH_HEAD_DIMS]
    mla = len(FLASH_SHAPES) + len(sweep)
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        for i, (B, H, KV, T, S, D, causal) in enumerate(
                FLASH_SHAPES + sweep + MLA_FLASH):
            q = _randn(gen, (B, T, H, D), dtype).transpose(1, 2)
            k = _randn(gen, (B, S, KV, D), dtype).transpose(1, 2)
            v = _randn(gen, (B, S, KV, D), dtype).transpose(1, 2)
            if i >= mla:            # MLA's v, zero past its 128 columns
                v[..., MLA_V_DIM:] = 0
            label = (f"flash {str(dtype)[6:]} B{B} H{H} KV{KV} T{T} S{S} "
                     f"D{D} {'causal' if causal else 'full'} "
                     f"{'mla ' if i >= mla else ''}"
                     f"{fa.flash_route(dtype, D)}")
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            gate("flash_attention", label, got, want, tol, dtype)
            if i >= mla and bool(got[..., MLA_V_DIM:].any()):
                raise PhaseError(f"flash_attention {label}: the padded "
                                 "v columns came out non-zero")
        for B, H, KV, S, D, lengths in DECODE_SHAPES:
            if lengths == "edges":
                lengths = _edge_lengths(B, KV, S)
            q = _randn(gen, (B, H, D), dtype)
            kc = _randn(gen, (B, S, KV, D), dtype).transpose(1, 2)
            vc = _randn(gen, (B, S, KV, D), dtype).transpose(1, 2)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            got = da.decode_attention_cuda(q, kc, vc, lens)
            want = da.decode_attention_plain(q, kc, vc, lens)
            torch.cuda.synchronize()
            splits, _ = da.choose_splits(B, KV, S, da.sm_count(q.device))
            gate("decode_attention",
                 f"decode {str(dtype)[6:]} B{B} H{H} KV{KV} S{S} D{D} "
                 f"lengths{list(lengths)} splits {splits}", got, want, tol,
                 dtype)
            zero = [i for i, n in enumerate(lengths) if n == 0]
            if zero and not bool((got[zero] == 0).all()):
                raise PhaseError(f"decode_attention: a length-0 sequence "
                                 f"is not 0 ({cases[-1]})")
    # A sequence of length 0: no key is read and the output is 0.
    q = _randn(gen, (2, 32, 160), torch.bfloat16)
    kc = _randn(gen, (2, 64, 8, 160), torch.bfloat16).transpose(1, 2)
    got = da.decode_attention_cuda(
        q, kc, kc, torch.tensor([0, 5], dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    if not bool((got[0] == 0).all()) or not bool(got[1].abs().sum() > 0):
        raise PhaseError("decode_attention: a length-0 sequence is not 0")
    for line in cases:
        print(f"  {line}")
    phase("attn_kernels", cases=len(cases) + 1,
          max_abs_err=json.dumps(errs),
          bf16_max_abs_err=json.dumps(bf16_errs),
          bf16_share_of_one_rounding=json.dumps(bf16_rounding),
          cuda_core_bf16_max_abs_err=json.dumps(CUDA_CORE_BF16_ERR))
    return errs


# ---------------------------------------------------------------------------
# Phase 3b: the rwkv6 scan kernel against its plain version
# ---------------------------------------------------------------------------

def rwkv_inputs(gen, B, H, T, K, dtype, layout="view", decay="model"):
    """r, k, v, logw ``[B,H,T,K]`` and u ``[H,K]`` on the card.  "view":
    transposed views of ``[B,T,H,K]`` tensors, as the model hands them
    over; "odd": slices at element 1 of ``[B,H,T,K+1]`` tensors (odd
    strides).  "model" decay: the init's per-channel ``linspace(-6,
    -0.5)`` plus N(0, 0.5²) in the log-log domain (w from 0.9975 down to
    about 0.1); "strong": log w near -20; "clamp": log w = -e^4, the
    floor of the model's clamp (``models/ssm.py``), every token."""
    import torch

    def t(shape):
        return torch.randn(shape, generator=gen, device=gen.device)

    shape = (B, T, H, K) if layout == "view" else (B, H, T, K)
    if decay == "model":
        base = torch.linspace(-6.0, -0.5, H * K, device=gen.device)
        base = base.view(H, K)
        base = base if layout == "view" else base[:, None, :]   # [H,(T,)K]
        logw = -torch.exp(base + 0.5 * t(shape))
    elif decay == "strong":
        logw = -torch.exp(3.0 + 0.5 * t(shape))
    else:
        logw = torch.full(shape, -float(torch.exp(torch.tensor(4.0))),
                          device=gen.device)
    xs = [t(shape), t(shape), t(shape), logw]
    if layout == "view":
        xs = [x.transpose(1, 2) for x in xs]
    xs = [x.to(dtype) for x in xs]
    if layout == "odd":
        wide = [torch.zeros((B, H, T, K + 1), dtype=dtype,
                            device=gen.device) for _ in xs]
        for w, x in zip(wide, xs):
            w[..., 1:] = x
        xs = [w[..., 1:] for w in wide]
    return xs + [(0.1 * t((H, K))).to(dtype)]


def check_rwkv() -> dict:
    """``rwkv6_scan`` against its plain version on the same CUDA inputs;
    returns the worst absolute difference (y and the final state)."""
    import torch

    from repro_torch.kernels import rwkv6_scan as rs

    gen = torch.Generator(device="cuda").manual_seed(21)
    worst, cases = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, T, K, layout, decay in RWKV_CASES:
            xs = rwkv_inputs(gen, B, H, T, K, dtype, layout, decay)
            y, S = rs.rwkv6_scan_cuda(*xs)
            y_want, S_want = rs.rwkv6_scan_plain(*xs)
            torch.cuda.synchronize()
            errs, scales = [], []
            for got, want in ((y, y_want), (S, S_want)):
                scale = max(1.0, float(want.abs().max()))
                err = float((got - want).abs().max())
                if not (bool(torch.isfinite(got).all()) and
                        err <= RWKV_TOL * scale):
                    raise PhaseError(
                        f"rwkv6_scan {str(dtype)[6:]} B{B} H{H} T{T} K{K} "
                        f"{layout} {decay}: error {err} above {RWKV_TOL} * "
                        f"{scale}")
                errs.append(err)
                scales.append(scale)
            worst = max(worst, *errs)
            cases.append(f"rwkv6_scan {str(dtype)[6:]} B{B} H{H} T{T} K{K} "
                         f"{layout} {decay} y {errs[0]:.3g} of "
                         f"{scales[0]:.3g}, S {errs[1]:.3g} of "
                         f"{scales[1]:.3g}")
    for line in cases:
        print(f"  {line}")
    phase("rwkv_kernel", cases=len(cases),
          max_abs_err=json.dumps({"rwkv6_scan": worst}))
    return {"rwkv6_scan": worst}


# ---------------------------------------------------------------------------
# Phase 3c: the mamba scan kernel against its plain version
# ---------------------------------------------------------------------------

def mamba_inputs(gen, B, T, I, N, dtype, layout="proj", decay="model"):
    """xdt, dt ``[B,T,I]``, bc, cc ``[B,T,N]`` and a ``[I,N]`` on the card.
    "proj": bc and cc are column slices of one ``[B,T,R+2N]`` tensor
    (R = I/32, jamba's dt_rank), as the model's ``x_proj`` output hands
    them over; "proj_odd": the same with R odd (the slices start at an
    odd column).  "model" decay: the init's ``A = -(1..N)`` (each entry
    jittered by a factor exp(0.1·N(0,1))) and ``dt = softplus(N(0,1) +
    log(expm1(U(0.001, 0.1))))``, as ``dt_proj`` plus ``dt_bias`` give
    it; "strong": dt near 15 (10 to 20), every decay exp(dt·A) below
    1e-4."""
    import torch
    import torch.nn.functional as F

    dev = gen.device

    def t(shape):
        return torch.randn(shape, generator=gen, device=dev)

    if decay == "model":
        u = torch.rand((I,), generator=gen, device=dev) * 0.099 + 0.001
        dt = F.softplus(t((B, T, I)) + torch.log(torch.expm1(u)))
    else:
        dt = F.softplus(15.0 + t((B, T, I)))
    a = -torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(I, N)
    a = a.contiguous() * torch.exp(0.1 * t((I, N)))
    R = max(1, I // 32)
    if layout == "proj_odd":
        R |= 1
    proj = t((B, T, R + 2 * N)).to(dtype)     # sliced in its own dtype
    bc, cc = proj[..., R:R + N], proj[..., R + N:]
    if layout == "contiguous":
        bc, cc = bc.contiguous(), cc.contiguous()
    xs = [dt * t((B, T, I)), dt, bc, cc]
    return [x.to(dtype) for x in xs] + [a]


def check_mamba() -> dict:
    """``mamba_scan`` against its plain version on the same CUDA inputs;
    returns the worst absolute difference (y and the final state)."""
    import torch

    from repro_torch.kernels import mamba_scan as ms

    gen = torch.Generator(device="cuda").manual_seed(31)
    worst, cases = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, I, N, layout, decay in MAMBA_CASES:
            xs = mamba_inputs(gen, B, T, I, N, dtype, layout, decay)
            if dtype == torch.bfloat16 and layout == "contiguous":
                xs[4] = xs[4].to(dtype)          # a in bf16 too
            y, h = ms.mamba_scan_cuda(*xs)
            y_want, h_want = ms.mamba_scan_plain(*xs)
            torch.cuda.synchronize()
            errs, scales = [], []
            for got, want in ((y, y_want), (h, h_want)):
                scale = float(want.abs().max())
                err = float((got - want).abs().max())
                if not (bool(torch.isfinite(got).all()) and
                        err <= MAMBA_TOL * scale):
                    raise PhaseError(
                        f"mamba_scan {str(dtype)[6:]} B{B} T{T} I{I} N{N} "
                        f"{layout} {decay}: error {err} above {MAMBA_TOL} * "
                        f"{scale}")
                errs.append(err)
                scales.append(scale)
            worst = max(worst, *errs)
            cases.append(f"mamba_scan {str(dtype)[6:]} B{B} T{T} I{I} N{N} "
                         f"{layout} {decay} y {errs[0]:.3g} of "
                         f"{scales[0]:.4g}, h {errs[1]:.3g} of "
                         f"{scales[1]:.4g}")
    for line in cases:
        print(f"  {line}")
    phase("mamba_kernel", cases=len(cases), tol_of_largest=MAMBA_TOL,
          max_abs_err=json.dumps({"mamba_scan": worst}))
    return {"mamba_scan": worst}


# ---------------------------------------------------------------------------
# Phase 4: PHOLD at full width, card against CPU
# ---------------------------------------------------------------------------

def drive(sim, state, **run_kw):
    """One card run of a path, with every kernel's launch count and the
    engine's ``COUNTS`` zeroed just before it and read just after.
    Returns ``(result, card seconds, launches, counts)``."""
    import torch

    from repro_torch.core import queue as q

    reset_launches()
    q.COUNTS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim.run(state, **run_kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    return res, card_s, read_launches(), dict(q.COUNTS)


def time_engine(sim):
    """Time the engine's ``run`` calls of ``sim`` (the super-step loops,
    without the initial queue's build, restores or checkpoints):
    returns a function giving the seconds so far."""
    import torch

    spent = [0.0]
    run = sim.engine.run

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return run(*args, **kw)
        finally:
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0

    sim.engine.run = timed
    return lambda: spent[0]


def _state_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _state_leaves(tree[k])]
    return [tree]


def parity_problems(res, ref) -> list:
    """What differs between a card run and a CPU run of the port: the
    counters, ``final_time`` (as f32), the word histogram, every state
    leaf and every field of the final queue, each bit for bit."""
    import numpy as np
    import torch

    from repro_torch.core import queue as q

    problems = []
    for name in ("events", "batches", "dropped", "emitted", "pending"):
        if getattr(res, name) != getattr(ref, name):
            problems.append(f"{name}: card {getattr(res, name)} "
                            f"cpu {getattr(ref, name)}")
    if np.float32(res.final_time) != np.float32(ref.final_time):
        problems.append(f"final_time {res.final_time} vs {ref.final_time}")
    if (res.word_counts is None) != (ref.word_counts is None) or (
            res.word_counts is not None
            and not np.array_equal(res.word_counts, ref.word_counts)):
        problems.append("word_counts differ")
    got_leaves, want_leaves = (_state_leaves(res.state),
                               _state_leaves(ref.state))
    if len(got_leaves) != len(want_leaves) or not all(
            torch.equal(a.cpu(), b.cpu())
            for a, b in zip(got_leaves, want_leaves)):
        problems.append("state differs")
    got = queue_arrays(res.raw["final_queue"])
    want = queue_arrays(ref.raw["final_queue"])
    if got.keys() != want.keys():
        problems.append(f"final queue fields {sorted(got)} vs {sorted(want)}")
    for name in want:
        if name in got and not np.array_equal(got[name], want[name]):
            problems.append(f"final queue field {name} differs")
    return problems


def queue_arrays(queue) -> dict:
    """Every field of a final queue as host arrays: a single queue's by
    name, a sharded queue's every shard's (``shard<i>.<name>``) and its
    global counters; a placed queue is gathered first (a collective)."""
    from repro_torch.core import queue as q
    from repro_torch.core.sharded import ShardedQueue, StackedShardedQueue

    if isinstance(queue, StackedShardedQueue):
        queue = queue.gathered()
        queue = ShardedQueue(queue.shards, queue.size, queue.next_seq,
                             queue.dropped)
    if not isinstance(queue, ShardedQueue):
        return q.queue_to_arrays(queue)
    out = {f"shard{i}.{k}": v for i, shard in enumerate(queue.shards)
           for k, v in q.queue_to_arrays(shard).items()}
    out.update({k: getattr(queue, k).cpu().numpy()
                for k in ("size", "next_seq", "dropped")})
    return out


def launch_problems(launches: dict, batches: int) -> list:
    """The queue kernels launch once a super-step, the others never."""
    from repro_torch.kernels import queue_front as qf

    return _launch_want(launches, dict.fromkeys(qf.LAUNCHES, batches),
                        f"{batches} super-steps")


def _launch_want(launches: dict, want: dict, label: str) -> list:
    """Each kernel launched ``want[name]`` times (0 when absent)."""
    return [f"{label}: {name} launched {n} times, expected "
            f"{want.get(name, 0)}"
            for name, n in launches.items() if n != want.get(name, 0)]


def run_phold(device_name: str):
    """PHOLD at full width under ``switch``; returns the card run, the
    queue kernels' launches, the CPU reference and the engine's counts."""
    from repro_torch.examples import phold
    from repro_torch.kernels import queue_front as qf

    t0 = time.perf_counter()
    prog = phold.build_program(num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP,
                               max_batch_len=4, capacity=PHOLD_CAPACITY)
    gpu = prog.build(backend="device", device=device_name,
                     dispatch_mode="switch")
    setup_s = time.perf_counter() - t0

    # The main path: counts are zeroed just before and read just after.
    loop_s = time_engine(gpu)
    res, gpu_s, every, counts = drive(
        gpu, phold.initial_state(PHOLD_LPS, device_name),
        max_batches=PHOLD_BATCHES)
    loop_s = loop_s()
    launches = {name: every[name] for name in qf.LAUNCHES}

    cpu = prog.build(backend="device", device="cpu", dispatch_mode="switch")
    t0 = time.perf_counter()
    ref = cpu.run(phold.initial_state(PHOLD_LPS, "cpu"),
                  max_batches=PHOLD_BATCHES)
    cpu_s = time.perf_counter() - t0

    problems = []
    if res.batches != PHOLD_BATCHES:
        problems.append(f"ran {res.batches} of {PHOLD_BATCHES} super-steps")
    if res.dropped != 0:
        problems.append(f"dropped {res.dropped} events")
    problems += parity_problems(res, ref) + launch_problems(every,
                                                            res.batches)
    if problems:
        raise PhaseError("phold: " + "; ".join(problems))

    rare = {k: v for k, v in sorted(counts.items())
            if k not in ("host_syncs", "loop_syncs")}
    phase("phold", lps=PHOLD_LPS, capacity=PHOLD_CAPACITY,
          batches=res.batches, events=res.events, dropped=res.dropped,
          final_time=res.final_time, checksum=int(res.state["checksum"]),
          setup_s=f"{setup_s:.3f}", card_s=f"{gpu_s:.3f}",
          cpu_s=f"{cpu_s:.3f}",
          card_events_per_s=f"{res.events / gpu_s:.1f}",
          card_steps_per_s=f"{res.batches / gpu_s:.1f}",
          loop_steps_per_s=f"{res.batches / loop_s:.1f}",
          host_syncs_per_step=f"{counts['host_syncs'] / res.batches:.4f}",
          rare_paths=json.dumps(rare, separators=(",", ":")),
          launches=json.dumps(launches, separators=(",", ":")),
          bit_identical_to_cpu=True)
    return res, launches, ref, counts, loop_s


def run_timed(label: str, build, state, **run_kw):
    """Build a path (setup seconds) and drive it once on the card;
    returns ``(sim, result, counts, fields)`` with the fields every new
    run prints (card seconds include building the initial queue)."""
    t0 = time.perf_counter()
    sim = build()
    setup_s = time.perf_counter() - t0
    res, card_s, launches, counts = drive(sim, state(), **run_kw)
    problems = launch_problems(launches, res.batches)
    if problems:
        raise PhaseError(f"{label}: " + "; ".join(problems))
    fields = dict(batches=res.batches, events=res.events,
                  setup_s=f"{setup_s:.3f}", card_s=f"{card_s:.3f}",
                  card_steps_per_s=f"{res.batches / card_s:.1f}",
                  host_syncs_per_step=(
                      f"{counts['host_syncs'] / res.batches:.4f}"),
                  run_path=counts.get("run_path", 0),
                  fused_hot=counts.get("fused_hot", 0),
                  fused_fallback=counts.get("fused_fallback", 0))
    return sim, res, counts, fields


def phold_hot_words(switch_res):
    """The switch run's most frequent word (PHOLD's alphabet: one type,
    windows of 1-4 events)."""
    from repro_torch.core.codec import DenseCodec
    from repro_torch.core.composer import hot_words_from_counts

    return hot_words_from_counts(switch_res.word_counts, DenseCodec(1, 4), 1)


def run_phold_fused(device_name: str, switch_res, ref, switch_counts):
    """PHOLD at the phold phase's size under ``fused`` with the switch
    run's top word as the hot set, held to the phold phase's CPU run."""
    from repro_torch.examples import phold

    hot = phold_hot_words(switch_res)
    _, res, counts, fields = run_timed(
        "phold_fused",
        lambda: phold.build_program(
            num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
            capacity=PHOLD_CAPACITY).build(
                backend="device", device=device_name,
                dispatch_mode="fused", hot_words=hot),
        lambda: phold.initial_state(PHOLD_LPS, device_name),
        max_batches=PHOLD_BATCHES)
    problems = parity_problems(res, ref)
    if counts["host_syncs"] != switch_counts["host_syncs"]:
        problems.append(f"{counts['host_syncs']} host syncs, the switch "
                        f"run {switch_counts['host_syncs']}")
    if counts.get("fused_hot", 0) + counts.get("fused_fallback", 0) \
            != res.batches:
        problems.append("a window took neither fused route")
    if problems:
        raise PhaseError("phold_fused: " + "; ".join(problems))
    phase("phold_fused", lps=PHOLD_LPS, hot_words=json.dumps(hot),
          switch_host_syncs_per_step=(
              f"{switch_counts['host_syncs'] / switch_res.batches:.4f}"),
          bit_identical_to_cpu=True, **fields)


# ---------------------------------------------------------------------------
# Phase 5: the paper's model
# ---------------------------------------------------------------------------

def run_modes(label: str, build, state, device_name: str, top_w: int,
              check=None, **run_kw) -> dict:
    """A scenario under ``switch``, ``masked`` and ``fused`` on the card
    (fused with the switch run's ``top_w`` most frequent words), each
    held bit for bit to one CPU ``switch`` run of the port; ``check``
    adds the scenario's own gates.  Returns the card runs by mode and
    the switch run's sim."""
    from repro_torch.core.composer import hot_words_from_counts

    t0 = time.perf_counter()
    ref = build(device="cpu", dispatch_mode="switch").run(
        state("cpu"), **run_kw)
    cpu_s = time.perf_counter() - t0
    runs = {}
    for mode in ("switch", "masked", "fused"):
        kw = dict(device=device_name, dispatch_mode=mode)
        hot = None
        if mode == "fused":
            hot = hot_words_from_counts(runs["switch"].word_counts,
                                        switch_sim.engine.codec, top_w)
            kw["hot_words"] = hot
        sim, res, counts, fields = run_timed(
            f"{label} {mode}", lambda: build(**kw),
            lambda: state(device_name), **run_kw)
        problems = parity_problems(res, ref)
        if check is not None:
            problems += check(res, counts, mode)
        if problems:
            raise PhaseError(f"{label} {mode}: " + "; ".join(problems))
        runs[mode] = res
        res.raw["counts"] = counts
        res.raw["hot_words"] = hot
        res.raw["card_s"] = fields["card_s"]
        if mode == "switch":
            switch_sim = sim
        extra = {} if hot is None else dict(hot_words=json.dumps(hot))
        phase(label, mode=mode, cpu_s=f"{cpu_s:.3f}", **fields, **extra,
              bit_identical_to_cpu=True)
    return runs, switch_sim


def run_poc(device_name: str):
    from repro_torch.api import Config
    from repro_torch.examples import poc

    iters = 16
    evs = poc.schedule_poc_events(256, 0.3, seed=0)
    want = poc.reference_final_sum([ty for _, ty in evs], iters)

    def check(res, counts, mode):
        problems = []
        got = int(res.state)
        if got != want or res.events != len(evs):
            problems.append(f"sum {got} (want {want}), {res.events} events")
        if mode == "fused" and not (counts.get("fused_hot")
                                    and counts.get("fused_fallback")):
            problems.append(f"hot and fallback did not both fire: {counts}")
        return problems

    runs, _ = run_modes(
        "poc",
        lambda **kw: poc.build_program(
            iters, config=Config(max_batch_len=4)).build(
                backend="device", **kw),
        poc.initial_state, device_name, 4, check=check, events=evs)
    return runs


# ---------------------------------------------------------------------------
# Phase 5b: the M/M/c network, the example's size and full size
# ---------------------------------------------------------------------------

def run_mmc(device_name: str) -> dict:
    """The two sizes under the three modes; returns the card runs by
    station count and mode."""
    import torch

    from repro_torch.examples import mmc_network as mmc

    def check(res, counts, mode):
        st = {k: v.cpu() for k, v in res.state.items()}
        problems = []
        if not counts.get("run_path"):
            problems.append("no window took the run path")
        if int(st["served"].sum()) == 0 or int(st["samples"].sum()) == 0:
            problems.append("served or samples is zero")
        if not torch.equal(st["arrived"],
                           st["served"] + st["qlen"] + st["busy"]):
            problems.append("arrived != served + qlen + busy")
        return problems

    out = {}
    for stations, t_open, cap, batches in (
            (4, 30.0, 512, None),
            (MMC_STATIONS, MMC_T_OPEN, MMC_CAPACITY, MMC_BATCHES)):
        run_kw = {} if batches is None else dict(max_batches=batches)
        mbl = None if batches is None else MMC_BATCH_LEN
        runs, sim = run_modes(
            "mmc",
            lambda **kw: mmc.build_program(
                num_stations=stations, t_open=t_open, max_batch_len=mbl,
                capacity=cap).build(backend="device", **kw),
            lambda dev: mmc.initial_state(stations, dev), device_name, 8,
            check=check, **run_kw)
        res = runs["switch"]
        if batches is not None and res.batches != batches:
            raise PhaseError(f"mmc: ran {res.batches} of {batches} "
                             "super-steps")
        if batches is None and res.pending != 0:
            raise PhaseError(f"mmc: {res.pending} events left pending")
        phase("mmc_size", stations=stations, t_open=t_open, capacity=cap,
              max_batch_len=sim.engine.max_batch_len,
              served=int(res.state["served"].sum()),
              samples=int(res.state["samples"].sum()),
              final_time=res.final_time)
        out[stations] = runs
    return out


# ---------------------------------------------------------------------------
# Phase 5c: the serving admission scenario at 64k requests
# ---------------------------------------------------------------------------

def build_admission(**kw):
    from repro_torch.api import Config
    from repro_torch.serving import scenarios

    return scenarios.build_admission_program(
        num_slots=ADMIT_SLOTS, num_requests=ADMIT_REQUESTS, max_decode=6,
        config=Config(max_batch_len=4, capacity=65536,
                      max_emit=2)).build(backend="device", **kw)


def run_serving_admission(device_name: str):
    """The admission scenario in the three modes; returns the card's
    ``switch`` run and its counts."""
    from repro_torch.serving import scenarios

    runs, _ = run_modes(
        "serving_admission", build_admission,
        lambda dev: scenarios.initial_state(ADMIT_SLOTS, dev), device_name,
        8, max_batches=ADMIT_BATCHES)
    st = {k: v.tolist() for k, v in runs["switch"].state.items()
          if k != "slots"}
    phase("serving_admission_state", slots=ADMIT_SLOTS,
          requests=ADMIT_REQUESTS, **st)
    return runs["switch"]


# ---------------------------------------------------------------------------
# Phase 5c2: the captured loop (one super-step a CUDA graph, replayed)
# ---------------------------------------------------------------------------

# The engine counts a captured run must share with its eager run.
CAPTURED_COUNTS = ("flush", "refill_kway", "refill_main_only", "to_run",
                   "merge_compact", "merge_append", "head_merge",
                   "suffix_append", "rotate", "run_path", "fused_hot",
                   "fused_fallback", "flush_append", "flush_merge",
                   "absorb", "absorb_chunks", "rebalance")
CAPTURED_PROFILE_STEPS = 64
CAPTURED_CHUNKS = (32, 64, 128)      # (a)'s chunk sizes, MODES_BATCHES each


def _count_problems(counts, want, label) -> list:
    got = {k: counts.get(k, 0) for k in CAPTURED_COUNTS}
    exp = {k: want.get(k, 0) for k in CAPTURED_COUNTS}
    return [] if got == exp else [f"{label}: counts {got}, eager {exp}"]


def _fence_of(res):
    """A fenced run's final fence ``(bound_t, bound_seq)``, else None."""
    if "bound_t" not in res.raw:
        return None
    return (float(res.raw["bound_t"]), int(res.raw["bound_seq"]))


def _captured_run(label, build, state, ref, ref_counts, ref_launches=None,
                  ref_loop_s=None, **run_kw):
    """Drive a captured build on the card and hold it to an eager card
    run of the same configuration (``ref``, with its counts, its
    launches (default: each queue kernel once a super-step) and its loop
    seconds): every field ``parity_problems`` checks, the spilled,
    ingested and shed counts, the fault word, the final fence, the
    engine's counts, the launches, one capture for the whole run and one
    loop read a chunk of each segment (a segmented run calls the
    engine's ``run`` once a segment).  Returns ``(sim, result, counts,
    card seconds, fields)``, the fields those a phase line prints:
    replayed steps/s (beside the eager loop's, given ``ref_loop_s``),
    loop reads a step, captures, capture seconds, steps a segment, peak
    device memory above what was held before the run, and the graph's
    conditional nodes, bodies and counter slots."""
    import torch

    sim = build()
    eng = sim.engine
    loop_s = time_engine(sim)
    segments = []
    timed_run = eng.run

    def counted(*args, stats=None, **kw):
        entry = 0 if stats is None else stats["batches"]
        out = timed_run(*args, stats=stats, **kw)
        segments.append(out[2]["batches"] - entry)
        return out

    eng.run = counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    res, card_s, launches, counts = drive(sim, state(), **run_kw)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20 - base_mb
    loop_s = loop_s()
    problems = parity_problems(res, ref)
    for name in ("spilled", "ingested", "shed", "fault_word"):
        if getattr(res, name) != getattr(ref, name):
            problems.append(f"{name}: captured {getattr(res, name)} "
                            f"eager {getattr(ref, name)}")
    if _fence_of(res) != _fence_of(ref):
        problems.append(f"fence {_fence_of(res)}, eager {_fence_of(ref)}")
    problems += _count_problems(counts, ref_counts, label)
    problems += (launch_problems(launches, res.batches)
                 if ref_launches is None
                 else _launch_want(launches, ref_launches, label))
    if eng.captures != 1:
        problems.append(f"{eng.captures} captures in one run, want 1")
    reads = sum(max(1, math.ceil(n / eng.chunk)) for n in segments)
    if counts.get("loop_syncs") != reads:
        problems.append(f"{counts.get('loop_syncs')} loop reads, {reads} "
                        f"chunks in {len(segments)} segments")
    if problems:
        raise PhaseError(f"captured {label}: " + "; ".join(problems))
    fields = dict(
        captured_batches=res.batches,
        replay_steps_per_s=(
            f"{res.batches / (loop_s - eng.capture_seconds):.1f}"),
        captured_loop_syncs_per_step=(
            f"{counts['loop_syncs'] / res.batches:.6f}"),
        captured_host_syncs_per_step=(
            f"{counts['host_syncs'] / res.batches:.6f}"),
        captures=eng.captures, capture_s=f"{eng.capture_seconds:.3f}",
        segments=len(segments),
        steps_per_segment=f"{res.batches / len(segments):.1f}",
        captured_card_s=f"{card_s:.3f}", captured_loop_s=f"{loop_s:.3f}",
        captured_peak_mb=f"{peak_mb:.1f}",
        captured_launches=json.dumps(launches, separators=(",", ":")),
        **graph_fields(eng), captured_bit_identical_to_eager=True)
    if ref_loop_s is not None:
        fields["eager_loop_steps_per_s"] = f"{ref.batches / ref_loop_s:.1f}"
    return sim, res, counts, card_s, fields


def graph_fields(eng) -> dict:
    """The captured step's graph: its conditional nodes by kind, bodies
    and counter slots (none in the CPU form, which captures nothing)."""
    step = eng._captured[2] if eng._captured else None
    if step is None:
        return {}
    return dict(graph_nodes=json.dumps(dict(step.ctx.nodes),
                                       separators=(",", ":")),
                graph_bodies=step.ctx.bodies, graph_slots=step.ctx.used)


def _profiled_kernels(fn) -> dict:
    """``fn()`` under ``torch.profiler``: device kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0) + 1
    return out


def poison_program(t_poison: float):
    """Eight hops that reschedule themselves one time unit on, until the
    first at or past ``t_poison`` emits at -inf: the front then holds a
    non-finite time, which the cheap fault word names."""
    import torch

    from repro_torch.api import ARG_WIDTH, Config, SimProgram

    prog = SimProgram("poison", config=Config(max_batch_len=4, capacity=64,
                                              max_emit=1))

    @prog.handler("HOP", lookahead=1.0, emits=True)
    def hop(state, t, arg):
        e = torch.zeros((1, 2 + ARG_WIDTH), dtype=torch.float32,
                        device=t.device)
        e[0, 0] = torch.where(t >= t_poison, -math.inf, 1.0)
        e[0, 2] = arg[0]
        return state + 1, e

    for i in range(8):
        prog.schedule(0.5 * i, "HOP", arg=[float(i)])
    return prog


def run_captured(device_name: str, phold_res, phold_counts, phold_loop_s,
                 poc_runs, mmc_runs) -> None:
    """Phase captured: ``build(loop="captured")`` held to the eager
    loop's card runs (see the module docstring, 5c2)."""
    import torch

    from repro_torch.api import Config, EngineFaultError
    from repro_torch.examples import mmc_network as mmc
    from repro_torch.examples import phold, poc
    from repro_torch.kernels import queue_front as qf
    from repro_torch.testing.faults import storm_program

    t_phase = time.perf_counter()

    def phold_build(**kw):
        return lambda: phold.build_program(
            num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
            capacity=PHOLD_CAPACITY).build(
                backend="device", device=device_name, loop="captured", **kw)

    def phold_state():
        return phold.initial_state(PHOLD_LPS, device_name)

    # (a) phase phold's configuration, captured.
    torch.cuda.reset_peak_memory_stats()
    sim = phold_build(dispatch_mode="switch")()
    loop_s = time_engine(sim)
    res, card_s, launches, counts = drive(sim, phold_state(),
                                          max_batches=PHOLD_BATCHES)
    loop_s = loop_s()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    capture_s = sim.engine.capture_seconds
    problems = (parity_problems(res, phold_res)
                + launch_problems(launches, res.batches)
                + _count_problems(counts, phold_counts, "phold"))
    if res.batches != PHOLD_BATCHES:
        problems.append(f"ran {res.batches} of {PHOLD_BATCHES} super-steps")
    chunks = math.ceil(res.batches / sim.engine.chunk)
    if counts["loop_syncs"] != chunks:
        problems.append(f"{counts['loop_syncs']} loop reads, {chunks} "
                        "chunks")
    if problems:
        raise PhaseError("captured phold: " + "; ".join(problems))
    chunk_rates = {}
    # One initial queue for the three runs: the captured loop copies its
    # input into the graph's own buffers and leaves it as it was.
    queue0 = sim.engine.initial_queue(sim.program.scheduled_events())
    for k in CAPTURED_CHUNKS:
        sim.engine.chunk = k
        entry = (phold_state(), queue0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = sim.engine.run(*entry, max_batches=MODES_BATCHES)
        torch.cuda.synchronize()
        chunk_rates[k] = MODES_BATCHES / (time.perf_counter() - t0)
        if r[2]["batches"] != MODES_BATCHES:
            raise PhaseError(f"captured phold chunk {k}: "
                             f"{r[2]['batches']} super-steps")
    sim.engine.chunk = 64
    del queue0
    phase("captured", case="a_phold", lps=PHOLD_LPS,
          capacity=PHOLD_CAPACITY, batches=res.batches, events=res.events,
          checksum=int(res.state["checksum"]),
          loop_syncs_per_step=f"{counts['loop_syncs'] / res.batches:.6f}",
          host_syncs_per_step=f"{counts['host_syncs'] / res.batches:.6f}",
          eager_host_syncs_per_step=(
              f"{phold_counts['host_syncs'] / phold_res.batches:.4f}"),
          card_s=f"{card_s:.3f}", loop_s=f"{loop_s:.3f}",
          capture_s=f"{capture_s:.3f}",
          card_steps_per_s=f"{res.batches / card_s:.1f}",
          replay_steps_per_s=f"{res.batches / (loop_s - capture_s):.1f}",
          eager_loop_steps_per_s=f"{phold_res.batches / phold_loop_s:.1f}",
          chunk_steps_per_s=json.dumps(
              {k: round(v, 1) for k, v in chunk_rates.items()}),
          peak_mb=f"{peak_mb:.1f}",
          launches=json.dumps(launches, separators=(",", ":")),
          bit_identical_to_phold=True)

    # (b) masked and fused at MODES_BATCHES, each held to its eager run.
    hot = phold_hot_words(phold_res)
    for mode, kw in (("masked", {}), ("fused", dict(hot_words=hot))):
        eager = phold.build_program(
            num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
            capacity=PHOLD_CAPACITY).build(
                backend="device", device=device_name, dispatch_mode=mode,
                **kw)
        ref, ref_s, _, ref_counts = drive(eager, phold_state(),
                                          max_batches=MODES_BATCHES)
        del eager
        csim, cres, ccounts, c_s, _ = _captured_run(
            f"phold {mode}", phold_build(dispatch_mode=mode, **kw),
            phold_state, ref, ref_counts, max_batches=MODES_BATCHES)
        phase("captured", case=f"b_phold_{mode}", batches=cres.batches,
              card_s=f"{c_s:.3f}", eager_card_s=f"{ref_s:.3f}",
              capture_s=f"{csim.engine.capture_seconds:.3f}",
              card_steps_per_s=f"{cres.batches / c_s:.1f}",
              eager_card_steps_per_s=f"{ref.batches / ref_s:.1f}",
              fused_hot=ccounts.get("fused_hot", 0),
              fused_fallback=ccounts.get("fused_fallback", 0),
              bit_identical_to_eager=True)
        del csim, ref, cres

    # (c) PoC and the M/M/c network, held to phases poc's and mmc's runs.
    evs = poc.schedule_poc_events(256, 0.3, seed=0)
    for mode, ref in poc_runs.items():
        kw = dict(dispatch_mode=mode)
        if ref.raw["hot_words"] is not None:
            kw["hot_words"] = ref.raw["hot_words"]
        csim, cres, ccounts, c_s, _ = _captured_run(
            f"poc {mode}", lambda: poc.build_program(
                16, config=Config(max_batch_len=4)).build(
                    backend="device", device=device_name, loop="captured",
                    **kw),
            lambda: poc.initial_state(device_name), ref, ref.raw["counts"],
            events=evs)
        phase("captured", case=f"c_poc_{mode}", batches=cres.batches,
              card_s=f"{c_s:.3f}",
              capture_s=f"{csim.engine.capture_seconds:.3f}",
              fused_hot=ccounts.get("fused_hot", 0),
              fused_fallback=ccounts.get("fused_fallback", 0),
              bit_identical_to_eager=True)
    sizes = {4: (30.0, 512, None, {}),
             MMC_STATIONS: (MMC_T_OPEN, MMC_CAPACITY, MMC_BATCH_LEN,
                            dict(max_batches=MMC_BATCHES))}
    for stations, runs in mmc_runs.items():
        t_open, cap, mbl, run_kw = sizes[stations]
        for mode, ref in runs.items():
            kw = dict(dispatch_mode=mode)
            if ref.raw["hot_words"] is not None:
                kw["hot_words"] = ref.raw["hot_words"]
            csim, cres, ccounts, c_s, _ = _captured_run(
                f"mmc {stations} {mode}", lambda: mmc.build_program(
                    num_stations=stations, t_open=t_open,
                    max_batch_len=mbl, capacity=cap).build(
                        backend="device", device=device_name,
                        loop="captured", **kw),
                lambda: mmc.initial_state(stations, device_name), ref,
                ref.raw["counts"], **run_kw)
            if not ccounts.get("run_path"):
                raise PhaseError(f"captured mmc {stations} {mode}: no "
                                 "window took the run path")
            phase("captured", case=f"c_mmc_{stations}_{mode}",
                  batches=cres.batches, card_s=f"{c_s:.3f}",
                  capture_s=f"{csim.engine.capture_seconds:.3f}",
                  card_steps_per_s=f"{cres.batches / c_s:.1f}",
                  eager_card_steps_per_s=(
                      f"{ref.batches / float(ref.raw['card_s']):.1f}"),
                  run_path=ccounts.get("run_path", 0),
                  fused_hot=ccounts.get("fused_hot", 0),
                  bit_identical_to_eager=True)
            del csim, cres

    # (d) a cheap-validation fault and an overflow stop, eager and captured.
    for case, make, kw in (
            ("cheap_fault", lambda: poison_program(9.0),
             dict(validate="cheap")),
            ("overflow_error", lambda: storm_program(16),
             dict(overflow="error"))):
        raised = {}
        for loop in ("eager", "captured"):
            try:
                make().build(backend="device", device=device_name,
                             loop=loop, **kw).run(
                    torch.zeros((), dtype=torch.int32, device=device_name))
            except EngineFaultError as err:
                raised[loop] = (err.fault_word, err.fault_step)
        if len(raised) != 2 or raised["eager"] != raised["captured"]:
            raise PhaseError(f"captured {case}: {raised}")
        phase("captured", case=f"d_{case}", fault_word=raised["eager"][0],
              fault_step=raised["eager"][1], same_as_eager=True)
    phase("captured_total", seconds=f"{time.perf_counter() - t_phase:.3f}")
    return sim


def profile_captured(sim) -> None:
    """Phase captured (a)'s graph replayed for 64 steps under
    ``torch.profiler``: each queue kernel must run once a step, as the
    launch counts say, and (a)'s five runs must have shared one capture.
    It runs after every timed phase: once CUPTI has traced a process, a
    big graph's launches there stay slow (M/M/c's 120-word ``switch``
    graph: about 20 ms a replay after a profile, 0.55 ms without)."""
    from repro_torch.examples import phold
    from repro_torch.kernels import queue_front as qf

    reset_launches()
    seen = _profiled_kernels(lambda: sim.run(
        phold.initial_state(PHOLD_LPS, "cuda"),
        max_batches=CAPTURED_PROFILE_STEPS))
    launches = read_launches()
    by_kernel = {name: sum(n for k, n in seen.items() if name in k)
                 for name in qf.LAUNCHES}
    setters = sum(n for k, n in seen.items() if k.startswith("set_")
                  and ("if" in k or "switch" in k))
    want = dict.fromkeys(qf.LAUNCHES, CAPTURED_PROFILE_STEPS)
    if by_kernel != want or {k: launches[k] for k in want} != want:
        raise PhaseError(f"captured_profile: profiler saw {by_kernel}, "
                         f"LAUNCHES {launches}, want {want} over "
                         f"{CAPTURED_PROFILE_STEPS} steps")
    if sim.engine.captures != 1:
        raise PhaseError(f"captured_profile: {sim.engine.captures} "
                         "captures for one signature, want 1")
    phase("captured_profile", steps=CAPTURED_PROFILE_STEPS,
          captures=sim.engine.captures,
          profiler_kernels=json.dumps(by_kernel, separators=(",", ":")),
          launches=json.dumps({k: launches[k] for k in want},
                              separators=(",", ":")),
          cond_setters=setters)


# ---------------------------------------------------------------------------
# Phases 5d-5g: segmented runs (overflow, resume, faults, stream)
# ---------------------------------------------------------------------------

def segment_launch_problems(launches: dict, batches: int, counts) -> list:
    """The queue kernels on a segmented path: ``window_extract`` once a
    super-step, ``front_merge`` once a super-step and once an absorbed
    chunk, the other kernels never."""
    return _launch_want(launches, {
        "window_extract": batches,
        "front_merge": batches + counts.get("absorb_chunks", 0)},
        f"{batches} super-steps")


def _outcome_problems(res, ref) -> list:
    """What differs between two runs of one model that need not group
    their super-steps alike: every state leaf, events, dropped and
    ``final_time`` (as f32)."""
    import numpy as np
    import torch

    problems = []
    got, want = _state_leaves(res.state), _state_leaves(ref.state)
    if len(got) != len(want) or not all(
            torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want)):
        problems.append("state differs")
    for name in ("events", "dropped"):
        if getattr(res, name) != getattr(ref, name):
            problems.append(f"{name}: {getattr(res, name)} vs "
                            f"{getattr(ref, name)}")
    if np.float32(res.final_time) != np.float32(ref.final_time):
        problems.append(f"final_time {res.final_time} vs {ref.final_time}")
    return problems


def _syncs(counts, batches) -> dict:
    return dict(host_syncs_per_step=f"{counts['host_syncs'] / batches:.4f}",
                loop_syncs_per_step=(
                    f"{counts.get('loop_syncs', 0) / batches:.4f}"))


def run_overflow(device_name: str, phold_res, phold_loop_s,
                 phold_counts) -> None:
    """(a) the overflow storm on the card: ``error`` raises
    ``FAULT_OVERFLOW``, ``spill`` matches the oversized queue with
    nothing dropped or left in the pool.  (b) PHOLD at the phold phase's
    width under ``overflow="spill"`` in a 786,432-event queue, the
    fence live in every extract, held bit for bit to phase phold's card
    run."""
    from repro_torch.examples import phold
    from repro_torch.testing import faults

    reset_launches()
    t0 = time.perf_counter()
    report = faults.run_overflow_scenario(device=device_name)
    storm_s = time.perf_counter() - t0
    launches = read_launches()
    if not (launches["window_extract"] and launches["front_merge"]):
        raise PhaseError(f"overflow storm: queue kernels not launched "
                         f"({launches})")
    phase("overflow_storm", detected=json.dumps(report["detected"]),
          spill_events=report["events"], spill_batches=report["batches"],
          dropped=0, spilled=0, seconds=f"{storm_s:.3f}",
          launches=json.dumps(launches, separators=(",", ":")))

    t0 = time.perf_counter()
    sim = phold.build_program(
        num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
        capacity=SPILL_CAPACITY).build(backend="device", device=device_name,
                                       overflow="spill")
    setup_s = time.perf_counter() - t0
    loop_s = time_engine(sim)
    res, card_s, every, counts = drive(
        sim, phold.initial_state(PHOLD_LPS, device_name),
        max_batches=PHOLD_BATCHES)
    loop_s = loop_s()
    problems = _outcome_problems(res, phold_res)
    if counts["loop_syncs"] != phold_counts["loop_syncs"]:
        problems.append(f"{counts['loop_syncs']} host reads in the loop, "
                        f"phold {phold_counts['loop_syncs']}")
    if res.batches != phold_res.batches:
        problems.append(f"{res.batches} super-steps, phold "
                        f"{phold_res.batches}")
    if int(res.state["checksum"]) != int(phold_res.state["checksum"]):
        problems.append("checksum differs")
    want_spilled = PHOLD_LPS - SPILL_CAPACITY
    if res.spilled != want_spilled:
        problems.append(f"{res.spilled} events in the pool, expected "
                        f"{want_spilled}")
    fence = _fence_of(res)
    if fence != SPILL_FENCE:
        problems.append(f"fence {fence}, expected {SPILL_FENCE}")
    problems += segment_launch_problems(every, res.batches, counts)
    if problems:
        raise PhaseError("overflow: " + "; ".join(problems))
    # The same spilling run in the captured loop, held to this one.
    *_, captured = _captured_run(
        "overflow", lambda: phold.build_program(
            num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
            capacity=SPILL_CAPACITY).build(
                backend="device", device=device_name, overflow="spill",
                loop="captured"),
        lambda: phold.initial_state(PHOLD_LPS, device_name), res, counts,
        every, loop_s, max_batches=PHOLD_BATCHES)
    phase("overflow", lps=PHOLD_LPS, capacity=SPILL_CAPACITY,
          batches=res.batches, events=res.events, spilled=res.spilled,
          dropped=res.dropped, fence=json.dumps(list(fence)),
          checksum=int(res.state["checksum"]), setup_s=f"{setup_s:.3f}",
          card_s=f"{card_s:.3f}", loop_s=f"{loop_s:.3f}",
          loop_steps_per_s=f"{res.batches / loop_s:.1f}",
          phold_loop_steps_per_s=f"{phold_res.batches / phold_loop_s:.1f}",
          phold_host_syncs_per_step=(
              f"{phold_counts['host_syncs'] / phold_res.batches:.4f}"),
          **_syncs(counts, res.batches),
          rebalances=counts.get("rebalance", 0),
          absorbs=counts.get("absorb", 0),
          launches=json.dumps(every, separators=(",", ":")),
          bit_identical_to_phold=True, **captured)


def run_resume(device_name: str, phold_res, phold_loop_s,
               phold_counts) -> None:
    """PHOLD at full width with ``validate="cheap"`` and a checkpoint
    every ``CKPT_EVERY`` super-steps: a crash after segment 2, then
    ``resume_from="latest"``; held bit for bit to phase phold's card
    run.  Prints a checkpoint's bytes and the seconds of one synchronous
    save of the same carry."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import queue as q
    from repro_torch.examples import phold
    from repro_torch.testing.faults import SimulatedCrash

    sim = phold.build_program(
        num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
        capacity=PHOLD_CAPACITY).build(backend="device", device=device_name,
                                       validate="cheap")
    loop_s = time_engine(sim)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        ckpt = pathlib.Path(tmp) / "run"

        def crash(seg, state, queue, stats):
            if seg == 2:
                raise SimulatedCrash(f"injected crash after segment {seg}")

        reset_launches()
        q.COUNTS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            sim.run(phold.initial_state(PHOLD_LPS, device_name),
                    max_batches=PHOLD_BATCHES, checkpoint_every=CKPT_EVERY,
                    checkpoint_dir=str(ckpt), _segment_hook=crash)
            raise PhaseError("resume: the injected crash did not fire")
        except SimulatedCrash:
            pass
        torch.cuda.synchronize()
        crash_s = time.perf_counter() - t0
        crashed_at = 2 * CKPT_EVERY
        crashed_counts = dict(q.COUNTS)
        problems = segment_launch_problems(read_launches(), crashed_at,
                                           crashed_counts)
        res, resume_s, every, counts = drive(
            sim, phold.initial_state(PHOLD_LPS, device_name),
            max_batches=PHOLD_BATCHES, checkpoint_every=CKPT_EVERY,
            checkpoint_dir=str(ckpt), resume_from="latest")
        problems += segment_launch_problems(every, res.batches - crashed_at,
                                            counts)
        problems += _outcome_problems(res, phold_res)
        if res.batches != phold_res.batches or \
                int(res.state["checksum"]) != int(phold_res.state["checksum"]):
            problems.append("batches or checksum differ from phold's")
        if res.fault_word != 0:
            problems.append(f"fault word {res.fault_word}")
        # The audited super-steps read the host as often as phold's.
        reads = crashed_counts["loop_syncs"] + counts["loop_syncs"]
        if reads != phold_counts["loop_syncs"]:
            problems.append(f"{reads} host reads in the loops, phold "
                            f"{phold_counts['loop_syncs']}")
        if problems:
            raise PhaseError("resume: " + "; ".join(problems))
        mgr = CheckpointManager(str(ckpt))
        latest = ckpt / f"step_{mgr.latest_step():010d}"
        nbytes = sum(f.stat().st_size for f in latest.iterdir())
        # One synchronous save of the final carry (the device-to-host
        # copy and the writes), timed.
        payload = {"state": res.state, "queue": res.raw["final_queue"],
                   "stats": {k: v for k, v in res.raw.items()
                             if k not in ("dropped", "final_queue")}}
        t0 = time.perf_counter()
        CheckpointManager(str(pathlib.Path(tmp) / "timed")).save(
            res.batches, payload)
        write_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase("resume", lps=PHOLD_LPS, validate="cheap",
          checkpoint_every=CKPT_EVERY, crashed_after=crashed_at,
          batches=res.batches, events=res.events,
          checksum=int(res.state["checksum"]),
          checkpoint_bytes=nbytes, checkpoint_write_s=f"{write_s:.3f}",
          crashed_card_s=f"{crash_s:.3f}", resumed_card_s=f"{resume_s:.3f}",
          loop_s=f"{loop_s():.3f}",
          cheap_loop_steps_per_s=f"{PHOLD_BATCHES / loop_s():.1f}",
          off_loop_steps_per_s=f"{phold_res.batches / phold_loop_s:.1f}",
          loop_syncs=crashed_counts["loop_syncs"] + counts["loop_syncs"],
          phold_loop_syncs=phold_counts["loop_syncs"],
          bit_identical_to_phold=True)


def run_faults(device_name: str) -> None:
    """``run_all_scenarios(validate="full")`` on the card: every
    corruption detected and recovered, the crash resumed, the storm."""
    from repro_torch.testing import faults

    reset_launches()
    t0 = time.perf_counter()
    reports = faults.run_all_scenarios(validate="full", device=device_name)
    seconds = time.perf_counter() - t0
    launches = read_launches()
    kinds = {r["kind"] for r in reports}
    want = set(faults.CORRUPTIONS) | {"crash", "overflow_storm"}
    if kinds != want or not all(r["recovered"] for r in reports):
        raise PhaseError(f"faults: {reports}")
    if not (launches["window_extract"] and launches["front_merge"]):
        raise PhaseError(f"faults: queue kernels not launched ({launches})")
    for r in reports:
        phase("faults", kind=r["kind"], detected=json.dumps(r["detected"]),
              fault_step=r.get("fault_step", -1), recovered=True)
    phase("faults_total", scenarios=len(reports), seconds=f"{seconds:.3f}",
          launches=json.dumps(launches, separators=(",", ":")))


def stream_source():
    from repro_torch.stream import PoissonSource

    return PoissonSource(STREAM_RATE, ADMIT_REQUESTS, seed=0, grid=0.25,
                         type_id=0, block_size=STREAM_BLOCK)


def build_open_admission(capacity, device, **kw):
    from repro_torch.api import Config
    from repro_torch.serving import scenarios

    return scenarios.build_open_admission_program(
        num_slots=ADMIT_SLOTS, num_requests=ADMIT_REQUESTS, max_decode=6,
        config=Config(max_batch_len=4, capacity=capacity,
                      max_emit=2)).build(backend="device", device=device,
                                         **kw)


def run_stream(device_name: str):
    """The open admission scenario streamed on the card: (a) into a
    65,536-event queue, against the same trace pre-seeded; (b) into a
    512-event queue under ``overflow="spill"``, against (a)'s
    pre-seeded run.  Both streamed runs are held bit for bit to the
    port's CPU run of the same case.  Returns (a)'s card run and its
    counts."""
    from repro_torch.serving import scenarios
    from repro_torch.stream import source_events

    source, build = stream_source, build_open_admission
    cards = {}
    closed_events = [(1.0, "TICK")] + [
        (t, ty, list(arg)) for (t, ty, arg) in source_events(source())]
    preseeded, pre_s, every, counts = drive(
        build(2 * STREAM_CAPACITY, device_name),
        scenarios.initial_state(ADMIT_SLOTS, device_name),
        events=closed_events, until=STREAM_UNTIL)
    problems = launch_problems(every, preseeded.batches)
    if problems:
        raise PhaseError("stream preseeded: " + "; ".join(problems))
    for case, capacity, kw in (("a", STREAM_CAPACITY, {}),
                               ("b", STREAM_SPILL_CAPACITY,
                                dict(overflow="spill"))):
        t0 = time.perf_counter()
        ref = build(capacity, "cpu", **kw).run(
            scenarios.initial_state(ADMIT_SLOTS, "cpu"), arrivals=source(),
            until=STREAM_UNTIL)
        cpu_s = time.perf_counter() - t0
        sim = build(capacity, device_name, **kw)
        loop_s = time_engine(sim)
        res, card_s, every, counts = drive(
            sim, scenarios.initial_state(ADMIT_SLOTS, device_name),
            arrivals=source(), until=STREAM_UNTIL)
        loop_s = loop_s()
        del sim
        problems = parity_problems(res, ref) + _outcome_problems(
            res, preseeded)
        problems += segment_launch_problems(every, res.batches, counts)
        for name in ("ingested", "shed", "spilled"):
            if getattr(res, name) != getattr(ref, name):
                problems.append(f"{name}: card {getattr(res, name)} cpu "
                                f"{getattr(ref, name)}")
        admitted = sum(1 for ev in closed_events[1:]
                       if ev[0] <= STREAM_UNTIL)
        if res.ingested != admitted or res.shed != 0:
            problems.append(f"ingested {res.ingested} (want {admitted}), "
                            f"shed {res.shed}")
        if case == "b" and not counts.get("rebalance"):
            problems.append("the spill pool was never rebalanced")
        if problems:
            raise PhaseError(f"stream {case}: " + "; ".join(problems))
        # The same streamed run in the captured loop, held to this one.
        *_, captured = _captured_run(
            f"stream {case}",
            lambda: build(capacity, device_name, loop="captured", **kw),
            lambda: scenarios.initial_state(ADMIT_SLOTS, device_name),
            res, counts, every, loop_s, arrivals=source(),
            until=STREAM_UNTIL)
        cards[case] = (res, counts)
        phase("stream", case=case, capacity=capacity,
              overflow=kw.get("overflow", "drop"), requests=ADMIT_REQUESTS,
              block=STREAM_BLOCK, until=STREAM_UNTIL, batches=res.batches,
              events=res.events, ingested=res.ingested, shed=res.shed,
              spilled=res.spilled, absorbs=counts.get("absorb", 0),
              absorb_chunks=counts.get("absorb_chunks", 0),
              rebalances=counts.get("rebalance", 0),
              card_s=f"{card_s:.3f}", cpu_s=f"{cpu_s:.3f}",
              preseeded_card_s=f"{pre_s:.3f}",
              card_steps_per_s=f"{res.batches / card_s:.1f}",
              loop_steps_per_s=f"{res.batches / loop_s:.1f}",
              **_syncs(counts, res.batches),
              launches=json.dumps(every, separators=(",", ":")),
              bit_identical_to_cpu=True, equals_preseeded=True,
              **captured)
    return cards["a"]


# ---------------------------------------------------------------------------
# Phase 5g2: the host runtimes
# ---------------------------------------------------------------------------

def drive_host(sim, state, **run_kw):
    """One host run, driven as ``drive`` does, with the scheduler's run
    (heap built) timed apart from the heap's build.  Returns ``(result,
    fields)`` with the numbers every host run prints."""
    spent = [0.0]
    schedule = sim._schedule

    def timed(*args, **kw):
        import torch

        t0 = time.perf_counter()
        try:
            return schedule(*args, **kw)
        finally:
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0

    sim._schedule = timed
    res, total_s, launches, counts = drive(sim, state, **run_kw)
    run_s = spent[0]
    if any(launches.values()):
        raise PhaseError(f"host {sim.variant}: kernels launched "
                         f"{launches}")
    if sim.sched is not None:
        comp = sim.sched.composer
        compile_s = list(comp.compile_seconds.values())
        composed = comp.num_composed
    else:
        from repro_torch.core.scheduler import _COMPILED_HANDLERS

        compile_s = [getattr(_COMPILED_HANDLERS.get(et.handler),
                             "first_call_s", None) or 0.0
                     for et in sim.registry] if sim.jit_handlers else []
        composed = len(sim.registry)
    # Compiled: the first call of each word compiles it; the rest of
    # the run is the warm rate.
    first_calls = composed if sim.jit_handlers else 0
    warm_s = run_s - sum(compile_s)
    fields = dict(
        batches=res.batches, events=res.events, rollbacks=res.rollbacks,
        setup_s=f"{total_s - run_s:.3f}", run_s=f"{run_s:.3f}",
        batches_per_s=f"{res.batches / run_s:.1f}",
        events_per_s=f"{res.events / run_s:.1f}",
        warm_batches_per_s=f"{(res.batches - first_calls) / warm_s:.1f}",
        host_reads_per_batch=f"{counts.get('host_syncs', 0) / res.batches:.4f}",
        words_composed=composed,
        compile_s_total=f"{sum(compile_s):.3f}",
        compile_s_largest=f"{max(compile_s, default=0.0):.3f}")
    return res, fields


def _word_call_ms(sim, word, state, device_name) -> tuple:
    """Time a call of one composed word, compiled (the composer's
    program) and eager (``compose_word_fn``), on the card."""
    from repro_torch.core.composer import batch_inputs, compose_word_fn

    comp = sim.sched.composer
    compiled = comp.program(comp.codec.encode(word))
    eager = compose_word_fn(comp.registry, word)
    ts, args = batch_inputs([float(i) for i in range(len(word))],
                            [None] * len(word), device_name)
    return tuple(_time_ms(lambda fn=fn: fn(state, ts, args), reps=200)
                 for fn in (compiled, eager))


def run_host(device_name: str, poc_switch, stream_a) -> None:
    """The host backend on the card: (a) phase ``phold``'s PHOLD to
    ``HOST_UNTIL`` under the three schedulers, compiled, and
    ``host/conservative`` eager, each held to a device-backend run with
    the same horizon; (b) phase ``poc``'s workload on
    ``host/conservative``, compiled, under both codecs; (c) phase
    ``stream`` (a)'s open admission into ``host/conservative``, eager;
    (d) the saturating cast on the card."""
    import numpy as np
    import torch

    from repro_torch.api import Config
    from repro_torch.core.queue import i32_sat
    from repro_torch.examples import phold, poc
    from repro_torch.serving import scenarios

    def build_phold():
        return phold.build_program(num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP,
                                   max_batch_len=4, capacity=PHOLD_CAPACITY)

    # One program, built five times: its schedule of 917,504 seeds is
    # made once.
    t_phase = time.perf_counter()
    prog = build_phold()
    dev, dev_s, _, _ = drive(prog.build(backend="device",
                                        device=device_name),
                             phold.initial_state(PHOLD_LPS, device_name),
                             until=HOST_UNTIL)
    for sched, jit in (("conservative", True), ("speculative", True),
                       ("unbatched", True), ("conservative", False)):
        t0 = time.perf_counter()
        sim = prog.build(backend="host", scheduler=sched,
                         device=device_name, jit_handlers=jit)
        build_s = time.perf_counter() - t0
        res, fields = drive_host(
            sim, phold.initial_state(PHOLD_LPS, device_name),
            until=HOST_UNTIL)
        problems = _outcome_problems(res, dev)
        if int(res.state["checksum"]) != int(dev.state["checksum"]):
            problems.append("checksum differs")
        if sched == "conservative" and res.batches != dev.batches:
            problems.append(f"{res.batches} batches, the device run "
                            f"{dev.batches}")
        if problems:
            raise PhaseError(f"host phold {sched} jit={jit}: "
                             + "; ".join(problems))
        phase("host", case="a", model="phold", lps=PHOLD_LPS,
              scheduler=sched, jit_handlers=jit, until=HOST_UNTIL,
              build_s=f"{build_s:.3f}", **fields,
              final_time=res.final_time,
              checksum=int(res.state["checksum"]),
              device_batches=dev.batches, device_card_s=f"{dev_s:.3f}",
              bit_identical_to_device=True)

    iters = 16
    evs = poc.schedule_poc_events(256, 0.3, seed=0)
    want = poc.reference_final_sum([ty for _, ty in evs], iters)
    for codec in ("dense", "paper"):
        sim = poc.build_program(iters, config=Config(
            max_batch_len=4, codec=codec)).build(backend="host",
                                                 device=device_name)
        res, fields = drive_host(sim, poc.initial_state(device_name),
                                 events=evs)
        problems = _outcome_problems(res, poc_switch)
        if int(res.state) != want:
            problems.append(f"sum {int(res.state)}, oracle {want}")
        if res.batches != poc_switch.batches:
            problems.append(f"{res.batches} batches, the card switch "
                            f"run {poc_switch.batches}")
        if problems:
            raise PhaseError(f"host poc {codec}: " + "; ".join(problems))
        extra = {}
        if codec == "dense":
            state = poc.initial_state(device_name) + 3
            for word, label in (([poc.INCREMENT, poc.SET], "inc_set"),
                                ([poc.SET, poc.INCREMENT], "set_inc")):
                comp_ms, eager_ms = _word_call_ms(sim, word, state,
                                                  device_name)
                extra[f"{label}_compiled_ms"] = f"{comp_ms:.6f}"
                extra[f"{label}_eager_ms"] = f"{eager_ms:.6f}"
        phase("host", case="b", model="poc", iters=iters, codec=codec,
              scheduler="conservative", jit_handlers=True, **fields,
              **extra, sum=int(res.state), oracle_and_card_switch=True)

    res_a, _ = stream_a
    sim = scenarios.build_open_admission_program(
        num_slots=ADMIT_SLOTS, num_requests=ADMIT_REQUESTS, max_decode=6,
        config=Config(max_batch_len=4, capacity=STREAM_CAPACITY,
                      max_emit=2)).build(backend="host", device=device_name,
                                         jit_handlers=False)
    res, fields = drive_host(
        sim, scenarios.initial_state(ADMIT_SLOTS, device_name),
        arrivals=stream_source(), until=STREAM_UNTIL)
    problems = _outcome_problems(res, res_a)
    if problems:
        raise PhaseError("host stream: " + "; ".join(problems))
    phase("host", case="c", model="open_admission", requests=ADMIT_REQUESTS,
          until=STREAM_UNTIL, scheduler="conservative", jit_handlers=False,
          **fields, ingested=res.ingested, device_ingested=res_a.ingested,
          device_batches=res_a.batches, equals_device_stream=True)

    xs = np.array(CAST_VALUES, np.float32)
    card = i32_sat(torch.from_numpy(xs).to(device_name)).cpu()
    cpu = i32_sat(torch.from_numpy(xs))
    bare = torch.from_numpy(xs).to(device_name).to(torch.int32).cpu()
    if card.tolist() != CAST_XLA or not torch.equal(card, cpu):
        raise PhaseError(f"host cast: card {card.tolist()}, cpu "
                         f"{cpu.tolist()}, XLA {CAST_XLA}")
    phase("host", case="d", cast="i32_sat", values=len(xs),
          equals_xla_and_cpu=True,
          bare_cast_on_card=json.dumps(bare.tolist(), separators=(",", ":")))
    phase("host_total", seconds=f"{time.perf_counter() - t_phase:.3f}")


# ---------------------------------------------------------------------------
# Phase 5g3: the static analyzer, build(check=) and hot_words="static"
# ---------------------------------------------------------------------------

def _late_program(calls):
    """A program whose declared lookahead (5.0) exceeds its only
    emission delay (1.0): ``check="error"`` must refuse it."""
    import torch
    from torch._subclasses.fake_tensor import is_fake

    from repro_torch.api import Config, SimProgram

    prog = SimProgram("late", config=Config(max_batch_len=4, capacity=64,
                                             max_emit=1))

    @prog.handler("A", lookahead=5.0, emits=True)
    def late(state, t, arg):
        calls.append(is_fake(t))
        emit = torch.full((1, 6), -1.0, device=t.device)
        emit[0, 0] = 1.0
        emit[0, 1] = 0.0
        emit[0, 2] = 0.0
        return state + 1, emit

    prog.schedule(0.0, "A")
    return prog


def run_analysis(device_name: str, poc_switch, admit) -> None:
    """(a) the five analyzer targets with their example states on the
    card and on the CPU: equal reports, no launch; (b) ``hot_words=
    "static"`` for phase ``poc``'s PoC and phase ``serving_admission``'s
    closed admission, each held bit for bit to that phase's ``switch``
    card run; (c) ``check="error"`` refusing a late lookahead at build
    and, deferred, at the first run, before any launch or handler call,
    and passing PHOLD at phase ``phold``'s width; (d) C3: both run
    handlers on out-of-range entity ids, against the CPU and JAX's
    values."""
    import torch

    from repro_torch.analysis import analyze
    from repro_torch.analysis.__main__ import _resolve
    from repro_torch.api import AnalysisError, Config
    from repro_torch.core import queue as q
    from repro_torch.core import vectorize as vec
    from repro_torch.core.tree import tree_map
    from repro_torch.examples import phold, poc
    from repro_torch.serving import scenarios

    t_phase = time.perf_counter()
    for target in ANALYSIS_TARGETS:
        prog = _resolve(target)
        cpu_state = prog._example_state
        card_state = tree_map(lambda x: x.to(device_name), cpu_state)
        reset_launches()
        q.COUNTS.clear()
        t0 = time.perf_counter()
        card = analyze(prog, state=card_state)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = analyze(prog, state=cpu_state)
        cpu_s = time.perf_counter() - t0
        launches = read_launches()
        problems = []
        if card.to_json() != cpu.to_json():
            problems.append("the card template's report differs")
        if not card.ok or card.dead:
            problems.append(f"not clean: {[str(f) for f in card.errors]}, "
                            f"dead {card.dead}")
        if any(launches.values()) or any(q.COUNTS.values()):
            problems.append(f"launched {launches}, counts {dict(q.COUNTS)}")
        if problems:
            raise PhaseError(f"analysis {target}: " + "; ".join(problems))
        phase("analysis", case="a", target=target, handlers=len(card.nodes),
              reachable_words=card.reachable_word_count,
              findings=len(card.findings), card_template_s=f"{card_s:.3f}",
              cpu_template_s=f"{cpu_s:.3f}", reports_equal=True, launches=0)

    iters = 16
    evs = poc.schedule_poc_events(256, 0.3, seed=0)

    def build_poc():
        prog = poc.build_program(iters, config=Config(max_batch_len=4))
        prog.example_state(poc.initial_state(device_name))
        return prog.build(backend="device", device=device_name,
                          dispatch_mode="fused", hot_words="static")

    def build_admit():
        prog = scenarios.build_admission_program(
            num_slots=ADMIT_SLOTS, num_requests=ADMIT_REQUESTS,
            max_decode=6, config=Config(max_batch_len=4, capacity=65536,
                                        max_emit=2))
        prog.example_state(scenarios.initial_state(ADMIT_SLOTS, device_name))
        return prog.build(backend="device", device=device_name,
                          dispatch_mode="fused", hot_words="static")

    for label, build, state, run_kw, ref in (
            ("poc", build_poc, lambda: poc.initial_state(device_name),
             dict(events=evs), poc_switch),
            ("serving_admission", build_admit,
             lambda: scenarios.initial_state(ADMIT_SLOTS, device_name),
             dict(max_batches=ADMIT_BATCHES), admit)):
        sim, res, counts, fields = run_timed(
            f"analysis static {label}", build, state, **run_kw)
        problems = parity_problems(res, ref)
        if counts.get("fused_hot", 0) + counts.get("fused_fallback", 0) \
                != res.batches:
            problems.append("a window took neither fused route")
        if problems:
            raise PhaseError(f"analysis static {label}: "
                             + "; ".join(problems))
        phase("analysis", case="b", scenario=label, hot_words="static",
              hot_set=len(sim.engine.hot_words), **fields,
              bit_identical_to_switch=True)

    calls = []
    prog = _late_program(calls)
    prog.example_state(torch.zeros((), dtype=torch.int32,
                                   device=device_name))
    reset_launches()
    q.COUNTS.clear()
    t0 = time.perf_counter()
    try:
        prog.build(backend="device", device=device_name, check="error")
        raise PhaseError("analysis check: the late lookahead built")
    except AnalysisError:
        at_build_s = time.perf_counter() - t0
    sim = _late_program(calls).build(backend="device", device=device_name,
                                     check="error")
    try:
        sim.run(torch.zeros((), dtype=torch.int32, device=device_name))
        raise PhaseError("analysis check: the deferred check did not fire")
    except AnalysisError:
        pass
    launches = read_launches()
    # ``calls`` holds is_fake(t) of every call: tracing only.
    if any(launches.values()) or any(q.COUNTS.values()) or not all(calls):
        raise PhaseError(f"analysis check: launched {launches}, counts "
                         f"{dict(q.COUNTS)}, real handler calls "
                         f"{calls.count(False)}")
    prog = phold.build_program(num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP,
                               max_batch_len=4, capacity=PHOLD_CAPACITY)
    prog.example_state(phold.initial_state(PHOLD_LPS, device_name))
    spent = []
    analyze_phold = prog.analyze

    def timed_analyze(*args, **kw):
        t0 = time.perf_counter()
        try:
            return analyze_phold(*args, **kw)
        finally:
            spent.append(time.perf_counter() - t0)

    prog.analyze = timed_analyze
    prog.build(backend="device", device=device_name, check="error")
    phase("analysis", case="c", late_raised_at_build=True,
          late_raised_at_first_run=True, late_build_s=f"{at_build_s:.3f}",
          launches=0, real_handler_calls=0, phold_lps=PHOLD_LPS,
          phold_check="error", phold_passed=True,
          phold_analysis_s=f"{spent[0]:.3f}")

    leaf = torch.arange(4, dtype=torch.int32)
    for masked in (False, True):
        make = (vec.make_masked_run_handler if masked
                else vec.make_run_handler)
        run = make(lambda s, t, a: s + 1)
        for ids, want in C3_CASES:
            got = {}
            for dev in ("cpu", device_name):
                ts = torch.zeros(2, device=dev)
                args = torch.zeros((2, 4), device=dev)
                ids_t = torch.tensor(ids, dtype=torch.int32, device=dev)
                extra = ([torch.ones(2, dtype=torch.bool, device=dev)]
                         if masked else [])
                out = run(leaf.clone().to(dev), ts, args, ids_t, *extra)
                torch.cuda.synchronize()
                got[dev] = out.cpu().tolist()
            if got["cpu"] != want or got[device_name] != want:
                raise PhaseError(f"analysis C3 masked={masked} ids {ids}: "
                                 f"card {got[device_name]}, cpu "
                                 f"{got['cpu']}, JAX {want}")
    phase("analysis", case="d", run_handlers="run,masked",
          id_cases=len(C3_CASES), equals_cpu_and_jax=True)
    phase("analysis_total", seconds=f"{time.perf_counter() - t_phase:.3f}")


# ---------------------------------------------------------------------------
# Phases 5h-5i: the queue modes and the sharded engine
# ---------------------------------------------------------------------------

def live_rows(queue):
    """The live ``(time, seq, type, args)`` rows of any final queue
    (tiered3, two-tier, flat, reference or sharded; a placed one is
    gathered, a collective), lex-sorted, with its ``size``,
    ``next_seq`` and ``dropped``."""
    from repro_torch.core import queue as q
    from repro_torch.core.sharded import sharded_queue_to_flat

    to_flat = {"Tiered3DeviceQueue": q.tiered3_queue_to_flat,
               "TieredDeviceQueue": q.tiered_queue_to_flat,
               "DeviceQueue": q.device_queue_to_flat,
               "ShardedQueue": sharded_queue_to_flat,
               "StackedShardedQueue": sharded_queue_to_flat}
    return to_flat[type(queue).__name__](queue)


def result_arrays(res) -> dict:
    """A run's outcome as host arrays, what :func:`rows_problems`
    compares: every state leaf, the counters, ``final_time``, the word
    histogram and the final queue's live rows with its counters (a
    placed queue is gathered: every rank calls this)."""
    import numpy as np

    out = {f"state{i}": leaf.cpu().numpy()
           for i, leaf in enumerate(_state_leaves(res.state))}
    for name in ("events", "batches", "dropped", "emitted", "pending",
                 "fault_word"):
        out[name] = np.asarray(getattr(res, name))
    out["final_time"] = np.asarray(np.float32(res.final_time))
    out["word_counts"] = np.asarray(res.word_counts)
    rows = live_rows(res.raw["final_queue"])
    out.update({f"queue.{k}": np.asarray(v)
                for k, v in zip(rows._fields, rows)})
    return out


def arrays_problems(got: dict, want: dict, label: str) -> list:
    import numpy as np

    if set(got) != set(want):
        return [f"{label}: fields {sorted(set(got) ^ set(want))}"]
    return [f"{label}: {k} differs" for k in sorted(want)
            if not np.array_equal(got[k], want[k])]


def rows_problems(res, ref) -> list:
    """What differs between two runs of one model and one window
    sequence (:func:`result_arrays`: state, the counters, the word
    histogram, ``final_time`` and the final queue's live rows and
    counters)."""
    # The yardsticks are compared many times: their outcome is read once.
    want = ref.raw.get("outcome")
    if want is None:
        want = ref.raw["outcome"] = result_arrays(ref)
    return arrays_problems(result_arrays(res), want, "outcome")


def _steps(res, card_s, counts, every, single=None,
           setup_s=None) -> dict:
    """The fields every run of 5h-5i prints."""
    out = dict(batches=res.batches, events=res.events,
               card_s=f"{card_s:.3f}",
               card_steps_per_s=f"{res.batches / card_s:.1f}",
               **_syncs(counts, res.batches),
               launches=json.dumps(every, separators=(",", ":")))
    if setup_s is not None:
        out["setup_s"] = f"{setup_s:.3f}"
    if "peak_mb" in counts:
        out["peak_mb"] = counts["peak_mb"]
    if single is not None:
        s_res, s_counts = single
        out["single_loop_syncs_per_step"] = (
            f"{s_counts.get('loop_syncs', 0) / s_res.batches:.4f}")
        out["single_host_syncs_per_step"] = (
            f"{s_counts['host_syncs'] / s_res.batches:.4f}")
    return out


def run_phold_built(device_name: str, batches: int, **build_kw):
    """Build phase 4's PHOLD with ``build_kw`` and drive it ``batches``
    super-steps on the card; returns ``(result, setup s, card s,
    launches, counts)``."""
    import torch

    from repro_torch.examples import phold

    t0 = time.perf_counter()
    sim = phold.build_program(
        num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
        capacity=PHOLD_CAPACITY).build(backend="device", device=device_name,
                                       **build_kw)
    setup_s = time.perf_counter() - t0
    on_card = torch.device(device_name).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20
        loop_s = time_engine(sim)
    res, card_s, every, counts = drive(
        sim, phold.initial_state(PHOLD_LPS, device_name),
        max_batches=batches)
    if on_card:
        # The loop's seconds (without the initial queue's build).
        res.raw["loop_s"] = loop_s()
        # The run's peak device memory above what was held before it:
        # the queues, the state and the loop's temporaries.
        counts["peak_mb"] = round(
            torch.cuda.max_memory_allocated() / 2**20 - base_mb, 1)
    return res, setup_s, card_s, every, counts


def run_queue_modes(device_name: str, phold_res, phold_counts):
    """Phase 5h; returns the tiered3 yardstick run and its counts.  Each
    of the other queues also runs in the captured loop, held to its
    eager run (:func:`_captured_run`)."""
    from repro_torch.examples import phold

    base, setup_s, card_s, every, counts = run_phold_built(
        device_name, MODES_BATCHES)
    problems = _launch_want(every, {"window_extract": base.batches,
                                    "front_merge": base.batches},
                            "tiered3")
    if base.batches != MODES_BATCHES:
        problems.append(f"tiered3 ran {base.batches} super-steps")
    if problems:
        raise PhaseError("queue_modes: " + "; ".join(problems))
    phase("queue_modes", mode="tiered3", lps=PHOLD_LPS,
          capacity=PHOLD_CAPACITY, checksum=int(base.state["checksum"]),
          **_steps(base, card_s, counts, every, setup_s=setup_s))
    single = (base, counts)
    for mode, batches in (("tiered", TIERED_BATCHES),
                          ("flat", MODES_BATCHES),
                          ("reference", MODES_REF_BATCHES)):
        ref, ref_single = base, single
        if batches == PHOLD_BATCHES:
            ref, ref_single = phold_res, (phold_res, phold_counts)
        elif batches != MODES_BATCHES:
            ref, *_ = run_phold_built(device_name, batches)
        res, setup_s, card_s, every, counts = run_phold_built(
            device_name, batches, queue_mode=mode)
        want = ({"window_extract": res.batches, "front_merge": res.batches}
                if mode == "tiered" else {})
        problems = rows_problems(res, ref) + _launch_want(every, want, mode)
        loop = counts.get("loop_syncs", 0)
        if mode != "tiered" and loop != 2 * res.batches:
            problems.append(f"{loop} loop reads in {res.batches} "
                            "super-steps, expected 2 a super-step")
        if mode == "tiered" and not counts.get("flush_merge"):
            problems.append("the staging flush never merged")
        if problems:
            raise PhaseError(f"queue_modes {mode}: " + "; ".join(problems))
        # The same run in the captured loop, held to this one.
        *_, captured = _captured_run(
            f"queue_modes {mode}", lambda: phold.build_program(
                num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
                capacity=PHOLD_CAPACITY).build(
                    backend="device", device=device_name, queue_mode=mode,
                    loop="captured"),
            lambda: phold.initial_state(PHOLD_LPS, device_name), res,
            counts, every, res.raw["loop_s"], max_batches=batches)
        phase("queue_modes", mode=mode, batches_of=batches,
              checksum=int(res.state["checksum"]),
              rare_paths=json.dumps(
                  {k: v for k, v in sorted(counts.items())
                   if k not in ("host_syncs", "loop_syncs", "peak_mb")},
                  separators=(",", ":")),
              **_steps(res, card_s, counts, every, ref_single, setup_s),
              loop_steps_per_s=f"{res.batches / res.raw['loop_s']:.1f}",
              bit_identical_to_tiered3=True, **captured)
        del res
        gc.collect()
    return single


def run_sharded(device_name: str, base, base_counts, hot, admit,
                stream_a) -> dict:
    """Phase 5i (a)-(d), each case's eager run beside the same case in
    the captured loop (:func:`_captured_run`); returns (a)'s and (b)'s
    eager outcomes (:func:`result_arrays`), super-steps/s and counts,
    the yardsticks of phase devices."""
    from repro_torch.examples import phold
    from repro_torch.serving import scenarios

    def phold_build(**kw):
        return lambda: phold.build_program(
            num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
            capacity=PHOLD_CAPACITY).build(
                backend="device", device=device_name, loop="captured", **kw)

    def phold_state():
        return phold.initial_state(PHOLD_LPS, device_name)

    # (a) PHOLD at SHARDS shards, validated, against 5h's tiered3 run.
    kw_a = dict(shards=SHARDS, validate="cheap")
    res, setup_s, card_s, every, counts = run_phold_built(
        device_name, MODES_BATCHES, **kw_a)
    problems = rows_problems(res, base) + _launch_want(
        every, {"front_merge": SHARDS * res.batches}, "sharded")
    if res.fault_word != 0:
        problems.append(f"fault word {res.fault_word}")
    if problems:
        raise PhaseError("sharded a: " + "; ".join(problems))
    *_, captured = _captured_run(
        "sharded a", phold_build(**kw_a), phold_state, res, counts, every,
        res.raw["loop_s"], max_batches=MODES_BATCHES)
    phase("sharded", case="a", shards=SHARDS, dispatch_mode="switch",
          validate="cheap", checksum=int(res.state["checksum"]),
          rare_paths=json.dumps(
              {k: v for k, v in sorted(counts.items())
               if k not in ("host_syncs", "loop_syncs", "peak_mb")},
              separators=(",", ":")),
          **_steps(res, card_s, counts, every, (base, base_counts),
                   setup_s),
          loop_steps_per_s=f"{res.batches / res.raw['loop_s']:.1f}",
          bit_identical_to_tiered3=True, **captured)
    serial = {"a": (result_arrays(res), res.batches / card_s, counts)}
    del res
    gc.collect()

    # (b) FUSED_SHARDS shards under fused.
    kw_b = dict(shards=FUSED_SHARDS, dispatch_mode="fused", hot_words=hot,
                **FUSED_SHARD_TIERS)
    res, setup_s, card_s, every, counts = run_phold_built(
        device_name, MODES_BATCHES, **kw_b)
    problems = rows_problems(res, base) + _launch_want(
        every, {"front_merge": FUSED_SHARDS * res.batches}, "sharded fused")
    if counts.get("fused_hot", 0) + counts.get("fused_fallback", 0) \
            != res.batches:
        problems.append("a window took neither fused route")
    if not (counts.get("flush") and (counts.get("refill_kway")
                                     or counts.get("refill_main_only"))):
        problems.append(f"the small tiers' rare paths did not fire: {counts}")
    if problems:
        raise PhaseError("sharded b: " + "; ".join(problems))
    *_, captured = _captured_run(
        "sharded b", phold_build(**kw_b), phold_state, res, counts, every,
        res.raw["loop_s"], max_batches=MODES_BATCHES)
    phase("sharded", case="b", shards=FUSED_SHARDS, dispatch_mode="fused",
          tiers=json.dumps(FUSED_SHARD_TIERS, separators=(",", ":")),
          rare_paths=json.dumps(
              {k: v for k, v in sorted(counts.items())
               if k not in ("host_syncs", "loop_syncs", "peak_mb")},
              separators=(",", ":")),
          hot_words=json.dumps(hot), fused_hot=counts.get("fused_hot", 0),
          fused_fallback=counts.get("fused_fallback", 0),
          **_steps(res, card_s, counts, every, (base, base_counts),
                   setup_s),
          loop_steps_per_s=f"{res.batches / res.raw['loop_s']:.1f}",
          bit_identical_to_tiered3=True, **captured)
    serial["b"] = (result_arrays(res), res.batches / card_s, counts)
    del res
    gc.collect()

    # (c) the closed admission scenario at SHARDS shards.
    t0 = time.perf_counter()
    sim = build_admission(device=device_name, shards=SHARDS)
    setup_s = time.perf_counter() - t0
    loop_s = time_engine(sim)
    res, card_s, every, counts = drive(
        sim, scenarios.initial_state(ADMIT_SLOTS, device_name),
        max_batches=ADMIT_BATCHES)
    loop_s = loop_s()
    del sim
    problems = rows_problems(res, admit) + _launch_want(
        every, {"front_merge": SHARDS * res.batches}, "sharded admission")
    if problems:
        raise PhaseError("sharded c: " + "; ".join(problems))
    *_, captured = _captured_run(
        "sharded c", lambda: build_admission(
            device=device_name, shards=SHARDS, loop="captured"),
        lambda: scenarios.initial_state(ADMIT_SLOTS, device_name), res,
        counts, every, loop_s, max_batches=ADMIT_BATCHES)
    phase("sharded", case="c", shards=SHARDS, scenario="admission",
          requests=ADMIT_REQUESTS,
          **_steps(res, card_s, counts, every,
                   (admit, admit.raw["counts"]), setup_s),
          loop_steps_per_s=f"{res.batches / loop_s:.1f}",
          bit_identical_to_single=True, **captured)
    del res
    gc.collect()

    # (d) the open admission stream into STREAM_SHARDS shards.
    single, single_counts = stream_a
    t0 = time.perf_counter()
    sim = build_open_admission(STREAM_CAPACITY, device_name,
                               shards=STREAM_SHARDS)
    setup_s = time.perf_counter() - t0
    loop_s = time_engine(sim)
    res, card_s, every, counts = drive(
        sim, scenarios.initial_state(ADMIT_SLOTS, device_name),
        arrivals=stream_source(), until=STREAM_UNTIL)
    loop_s = loop_s()
    del sim
    problems = rows_problems(res, single) + _launch_want(
        every, {"front_merge": STREAM_SHARDS * res.batches
                + counts.get("absorb_chunks", 0)}, "sharded stream")
    for name in ("ingested", "shed", "spilled"):
        if getattr(res, name) != getattr(single, name):
            problems.append(f"{name}: {getattr(res, name)} vs "
                            f"{getattr(single, name)}")
    if problems:
        raise PhaseError("sharded d: " + "; ".join(problems))
    *_, captured = _captured_run(
        "sharded d", lambda: build_open_admission(
            STREAM_CAPACITY, device_name, shards=STREAM_SHARDS,
            loop="captured"),
        lambda: scenarios.initial_state(ADMIT_SLOTS, device_name), res,
        counts, every, loop_s, arrivals=stream_source(), until=STREAM_UNTIL)
    phase("sharded", case="d", shards=STREAM_SHARDS, scenario="stream",
          ingested=res.ingested, absorbs=counts.get("absorb", 0),
          absorb_chunks=counts.get("absorb_chunks", 0),
          **_steps(res, card_s, counts, every, (single, single_counts),
                   setup_s),
          loop_steps_per_s=f"{res.batches / loop_s:.1f}",
          bit_identical_to_single=True, **captured)
    return serial


# ---------------------------------------------------------------------------
# Phase 6: serving at full width
# ---------------------------------------------------------------------------

# Where the serving path may wait on the card: the engine's own host
# reads (one a decode batch) and the copies it makes of the host's
# token ids; a model or kernel that synchronizes does so unseen by
# ``ServeStats.host_reads``.
SYNC_ALLOWED = ("repro_torch/serving/", "repro_torch/launch/")


def sync_sites(fn):
    """``fn()`` under torch's CUDA sync debug mode "warn" -> (its result,
    ``{"file:line": count}`` of the synchronizing CUDA calls it made (a
    read to the host, a blocking copy, a stream wait), each at the
    innermost line of ``repro_torch`` on the stack when it was made.
    The mode's own switches are left out: one reported a sync on the
    H100 with no line of ``repro_torch`` on its stack."""
    import collections
    import warnings

    import torch

    sites = collections.Counter()
    inside = False

    def record(message, category, filename, lineno, file=None, line=None):
        if not inside or "synchronizing" not in str(message):
            return
        frame = sys._getframe(1)
        while frame and "/repro_torch/" not in frame.f_code.co_filename:
            frame = frame.f_back
        if frame:
            filename, lineno = frame.f_code.co_filename, frame.f_lineno
        path = pathlib.Path(filename).resolve()
        if path.is_relative_to(ROOT):
            path = path.relative_to(ROOT)
        sites[f"{path}:{lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        inside = True
        try:
            out = fn()
        finally:
            inside = False
            torch.cuda.set_sync_debug_mode("default")
    return out, dict(sites)


def serve_counted(model, args, want_of, label: str, *,
                  sync_free: bool = False):
    """Drive ``launch.serve.serve`` on ``model`` with every kernel's
    count zeroed just before and read just after; gate that every
    request finished, one host read a decode batch, and the launches
    ``want_of(stats)`` (``{name: count}``; every other kernel 0).  With
    ``sync_free`` the run goes under :func:`sync_sites` and no
    synchronizing call may come from outside ``SYNC_ALLOWED`` (each site
    is printed).  Returns (engine, stats, launches, peak device bytes
    since the caller's last reset, seconds)."""
    import torch

    from repro_torch.launch import serve

    t0 = time.perf_counter()
    reset_launches()
    if sync_free:
        engine, sites = sync_sites(lambda: serve.serve(model, args))
    else:
        engine, sites = serve.serve(model, args), None
    torch.cuda.synchronize()
    every = read_launches()
    seconds = time.perf_counter() - t0
    stats = engine.stats
    problems = []
    if sites is not None:
        hidden = {k: n for k, n in sites.items()
                  if not any(a in k for a in SYNC_ALLOWED)}
        phase("syncs", label=label.replace(" ", "_"),
              engine=sum(sites.values()) - sum(hidden.values()),
              hidden=sum(hidden.values()),
              decode_batches=stats.decode_batches,
              sites=json.dumps(sites, separators=(",", ":")))
        if hidden:
            problems.append(f"synchronizing calls outside the engine: "
                            f"{hidden}")
    done = sum(r.done for r in engine.requests.values())
    if done != args.requests or len(engine.requests) != args.requests:
        problems.append(f"{done} of {args.requests} requests done")
    want = {name: 0 for name in every}
    want.update(want_of(stats))
    if every != want:
        problems.append(f"launches {every}, expected {want} for "
                        f"{stats.prefills} prefills and "
                        f"{stats.decode_events} decode events")
    if stats.host_reads != stats.decode_batches:
        problems.append(f"{stats.host_reads} host reads in "
                        f"{stats.decode_batches} decode batches")
    if problems:
        raise PhaseError(f"{label}: " + "; ".join(problems))
    return engine, stats, every, torch.cuda.max_memory_allocated(), seconds


def _serve_fields(engine, stats, params: int, param_bytes: int) -> dict:
    tokens = sum(len(r.output) for r in engine.requests.values())
    return dict(
        params=params, param_bytes=param_bytes,
        requests=sum(r.done for r in engine.requests.values()),
        tokens=tokens, decode_events=stats.decode_events,
        fused_batches=stats.fused_batches, singles=stats.singles,
        prefills=stats.prefills, wall_s=f"{stats.wall_seconds:.3f}",
        prefill_ms_per_request=f"{stats.prefill_seconds / stats.prefills * 1e3:.3f}",
        decode_ms_per_token_step=f"{stats.decode_seconds / stats.decode_events * 1e3:.3f}",
        generated_tokens_per_s=f"{tokens / stats.wall_seconds:.2f}",
        host_reads_per_decode_batch=f"{stats.host_reads / stats.decode_batches:.3f}",
        weight_read_bound_ms=f"{param_bytes / HBM_BYTES_PER_S * 1e3:.3f}")


def _fresh_card() -> None:
    """Collect the models of the phases before (engines hold theirs in
    reference cycles), so a phase's peak is its own."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _build_timed(build):
    """``build()`` on a collected card -> (model, init seconds, parameters,
    parameter bytes)."""
    import torch

    _fresh_card()
    t0 = time.perf_counter()
    model = build()
    torch.cuda.synchronize()
    return (model, time.perf_counter() - t0,
            sum(p.numel() for p in model.parameters()),
            sum(p.numel() * p.element_size() for p in model.parameters()))


def run_serve() -> tuple:
    """stablelm-12b with the serve launcher's defaults on the card;
    returns the attention kernels' launches in that run and its ms a
    decode step."""
    from repro_torch.launch import serve

    args = serve.parse_args(SERVE_ARGS)
    model, init_s, params, param_bytes = _build_timed(
        lambda: serve.build_model(args))
    cfg = model.cfg
    L = mixer_layers(cfg).get("gqa", 0)
    engine, stats, every, peak, _ = serve_counted(
        model, args, lambda st: {"flash_attention": 2 * L * st.prefills,
                                 "decode_attention": L * st.decode_events},
        "serve")
    phase("serve", arch=cfg.name, layers=L, d_model=cfg.d_model,
          head_dim=cfg.resolved_head_dim, init_s=f"{init_s:.3f}",
          max_memory_allocated=peak,
          **_serve_fields(engine, stats, params, param_bytes),
          launches=json.dumps(every, separators=(",", ":")))
    decode_ms = stats.decode_seconds / stats.decode_events * 1e3
    teacher_force(model, "reference")
    return {name: every[name]
            for name in ("flash_attention", "decode_attention")}, decode_ms


def run_serve_rwkv() -> dict:
    """rwkv6-1.6b with the serve launcher's defaults on the card;
    returns ``rwkv6_scan``'s launches in that run."""
    from repro_torch.launch import serve

    args = serve.parse_args(RWKV_SERVE_ARGS)
    model, init_s, params, param_bytes = _build_timed(
        lambda: serve.build_model(args))
    cfg = model.cfg
    L = mixer_layers(cfg).get("rwkv", 0)
    engine, stats, every, peak, _ = serve_counted(
        model, args, lambda st: {"rwkv6_scan": 2 * L * st.prefills},
        "serve_rwkv")
    phase("serve_rwkv", arch=cfg.name, layers=L, d_model=cfg.d_model,
          heads=cfg.d_model // cfg.rwkv_head_dim,
          head_dim=cfg.rwkv_head_dim, init_s=f"{init_s:.3f}",
          max_memory_allocated=peak,
          **_serve_fields(engine, stats, params, param_bytes),
          launches=json.dumps(every, separators=(",", ":")))
    teacher_force_rwkv(model)
    return {"rwkv6_scan": every["rwkv6_scan"]}


def jamba_truncation():
    """jamba-1.5-large-398b at its published widths, cut to the first
    ``JAMBA_LAYERS`` layers of its block: ``[(gqa, mlp), (mamba, moe)]``
    (the 72-layer model, 398 B parameters, fits no single card)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(JAMBA)
    return dataclasses.replace(
        cfg, num_layers=JAMBA_LAYERS,
        block_pattern=cfg.block_pattern[:JAMBA_LAYERS])


def run_serve_jamba() -> dict:
    """The jamba truncation with the serve launcher's defaults on the
    card; returns the kernels' launches in that run."""
    from repro_torch.launch import serve
    from repro_torch.models import LM

    args = serve.parse_args(["--arch", JAMBA])
    cfg = jamba_truncation()
    model, init_s, params, param_bytes = _build_timed(
        lambda: LM(cfg, attn_impl="pallas").init(args.seed))
    layers = mixer_layers(cfg)
    engine, stats, every, peak, _ = serve_counted(
        model, args, lambda st: {
            "mamba_scan": 2 * layers.get("mamba", 0) * st.prefills,
            "flash_attention": 2 * layers.get("gqa", 0) * st.prefills,
            "decode_attention": layers.get("gqa", 0) * st.decode_events},
        "serve_jamba")
    if params != cfg.param_count() + _uncounted_params(cfg):
        raise PhaseError(f"serve_jamba: {params} parameters, the config "
                         f"counts {cfg.param_count()}")
    phase("serve_jamba", arch=cfg.name, layers=cfg.num_layers,
          pattern=json.dumps([[s.mixer, s.ffn] for s in cfg.block_pattern],
                             separators=(",", ":")),
          d_model=cfg.d_model, heads=cfg.num_heads,
          kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
          experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
          d_inner=cfg.mamba.d_inner(cfg.d_model), d_state=cfg.mamba.d_state,
          init_s=f"{init_s:.3f}", max_memory_allocated=peak,
          **_serve_fields(engine, stats, params, param_bytes),
          launches=json.dumps(every, separators=(",", ":")))
    teacher_force_routed(model, "teacher_force_jamba")
    del engine, model
    _fresh_card()
    return {name: every[name] for name in
            ("mamba_scan", "flash_attention", "decode_attention")}


def run_hubert() -> dict:
    """hubert-xlarge's encoder forward on the card in bf16 through
    ``LM(cfg, attn_impl="pallas").forward(embeds=...)`` on seeded frame
    embeddings, against ``blockwise`` on the same weights; returns the
    kernels' launches in the kernel route's forward."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    gc.collect()
    torch.cuda.empty_cache()
    # The published widths (d_model 1280, 16 heads of 80, d_ff 5120,
    # layernorm, gelu, bidirectional), depth cut to HUBERT_LAYERS.
    full = get_config(HUBERT)
    cfg = dataclasses.replace(full, num_layers=HUBERT_LAYERS)
    model = LM(cfg, attn_impl="pallas").init(0)
    # Frame embeddings in place of the conv feature extractor's output,
    # at the data pipeline's scale (0.02 N(0, 1)), from a seed.
    gen = torch.Generator(device="cuda").manual_seed(4)
    frames = torch.randn((1, HUBERT_T, cfg.d_model), generator=gen,
                         device="cuda") * 0.02
    # The main path: counts are zeroed just before and read just after.
    reset_launches()
    logits, _ = model.forward(embeds=frames)
    torch.cuda.synchronize()
    every = read_launches()
    model.attn_impl = "blockwise"
    plain, _ = model.forward(embeds=frames)
    torch.cuda.synchronize()
    plain_launches = read_launches()
    # The vocabulary's 504 entries (the padded tail holds -1e30).
    a = logits[0, :, :cfg.vocab_size].float()
    b = plain[0, :, :cfg.vocab_size].float()
    cos = F.cosine_similarity(a, b, dim=-1)
    want = {name: 0 for name in every}
    want["flash_attention"] = mixer_layers(cfg).get("gqa", 0)
    problems = []
    if every != want:
        problems.append(f"launches {every}, expected {want}")
    if plain_launches != every:
        problems.append(f"blockwise launched {plain_launches}")
    if not bool(torch.isfinite(a).all()):
        problems.append("logits not finite")
    if tuple(logits.shape) != (1, HUBERT_T, cfg.padded_vocab):
        problems.append(f"logits of shape {tuple(logits.shape)}")
    if float(cos.min()) < MIN_COSINE:
        problems.append(f"min cosine {float(cos.min())} (min {MIN_COSINE})")
    if problems:
        raise PhaseError("hubert: " + "; ".join(problems))
    phase("hubert", arch=cfg.name,
          layers=f"{cfg.num_layers}_of_{full.num_layers}",
          d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
          head_dim=cfg.resolved_head_dim, causal=cfg.causal,
          dtype=str(model.embed.dtype)[6:], T=HUBERT_T,
          input=f"frame_embeddings_[1,{HUBERT_T},{cfg.d_model}]",
          against="blockwise", rows=HUBERT_T,
          min_cosine=f"{float(cos.min()):.6f}",
          max_abs_diff=f"{float((a - b).abs().max()):.4f}",
          launches=json.dumps(every, separators=(",", ":")))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": every["flash_attention"]}


# ---------------------------------------------------------------------------
# Phases serve_deepseek and vlm: MLA, M-RoPE and embeds on the card
# ---------------------------------------------------------------------------

def run_serve_deepseek() -> dict:
    """deepseek-v2-lite-16b at full width and depth through the serve
    launcher with its defaults: MLA prefill on ``flash_attention`` (qk
    head dim 192), the absorbed decode in plain torch; then the
    teacher-forced check with the routing teacher-forced.  Returns the
    kernels' launches in the serve run."""
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    args = serve.parse_args(["--arch", DEEPSEEK])
    model, init_s, params, param_bytes = _build_timed(
        lambda: serve.build_model(args))
    cfg = model.cfg
    L = mixer_layers(cfg).get("mla", 0)
    engine, stats, every, peak, serve_s = serve_counted(
        model, args, lambda st: {"flash_attention": 2 * L * st.prefills},
        "serve_deepseek")
    problems = []
    if L != cfg.num_layers:
        problems.append(f"{L} mla layers of {cfg.num_layers}")
    if params != cfg.param_count() + _uncounted_params(cfg):
        problems.append(f"{params} parameters, the config counts "
                        f"{cfg.param_count()}")
    layer = engine.cache["stages"][0]["l0"]
    latent_bytes = sum(
        leaf[0, 0, 0].numel() * leaf.element_size() * repeat
        for (_, repeat), stage in zip(cfg.stages(), engine.cache["stages"])
        for unit in stage.values() for leaf in unit.values())
    if sorted(layer) != ["ckv", "kr"] or latent_bytes != (
            cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2 * L:
        problems.append(f"cache leaves {sorted(layer)}, {latent_bytes} "
                        "bytes a token")
    if problems:
        raise PhaseError("serve_deepseek: " + "; ".join(problems))
    m = cfg.mla
    phase("serve_deepseek", arch=cfg.name, layers=cfg.num_layers,
          d_model=cfg.d_model, heads=cfg.num_heads,
          kv_lora_rank=m.kv_lora_rank,
          qk_head_dim=m.qk_nope_head_dim + m.qk_rope_head_dim,
          v_head_dim=m.v_head_dim, experts=cfg.moe.num_experts,
          top_k=cfg.moe.top_k, shared=cfg.moe.num_shared,
          init_s=f"{init_s:.3f}", max_memory_allocated=peak,
          latent_cache_bytes_per_token=latent_bytes,
          serve_s=f"{serve_s:.3f}",
          **_serve_fields(engine, stats, params, param_bytes),
          launches=json.dumps(every, separators=(",", ":")))
    teacher_force_routed(model, "teacher_force_deepseek")
    del engine, model
    _fresh_card()
    phase("serve_deepseek_total",
          seconds=f"{time.perf_counter() - t_phase:.3f}")
    return {"flash_attention": every["flash_attention"]}


def vlm_truncation():
    """qwen2-vl-72b at its published widths, cut to its first
    ``VLM_LAYERS`` layers (the 80-layer model, 72 B parameters, fits no
    single card)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(VLM), num_layers=VLM_LAYERS)


def vlm_grid(device):
    """The ``[3, 1, VLM_T]`` M-RoPE (t, h, w) grid: ``VLM_TEXT`` text
    positions (equal in every stream), then the image block's patches at
    ``VLM_TEXT + (t, h, w)``: three streams that really differ."""
    import torch

    t, h, w = VLM_IMAGE
    text = torch.arange(VLM_TEXT, device=device)
    tt, hh, ww = torch.meshgrid(torch.arange(t, device=device),
                                torch.arange(h, device=device),
                                torch.arange(w, device=device),
                                indexing="ij")
    image = torch.stack([tt.flatten(), hh.flatten(), ww.flatten()])
    grid = torch.cat([text.expand(3, VLM_TEXT), VLM_TEXT + image], dim=1)
    return grid[:, None, :].to(torch.int32)


def run_vlm() -> None:
    """qwen2-vl-72b's truncation on the card: (a) ``prefill`` and
    ``forward`` from seeded patch embeddings on a three-stream M-RoPE
    grid, kernel route against ``blockwise`` on the same weights; (b) the
    serve launcher's defaults (text tokens)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.launch import serve
    from repro_torch.models import LM

    t_phase = time.perf_counter()
    cfg = vlm_truncation()
    model, init_s, params, param_bytes = _build_timed(
        lambda: LM(cfg, attn_impl="pallas").init(0))
    gen = torch.Generator(device="cuda").manual_seed(6)
    embeds = torch.randn((1, VLM_T, cfg.d_model), generator=gen,
                         device="cuda") * 0.02
    grid = vlm_grid(embeds.device)
    if bool((grid[0] == grid[1]).all()) or bool((grid[1] == grid[2]).all()):
        raise PhaseError("vlm: the position streams do not differ")
    L = mixer_layers(cfg).get("gqa", 0)

    # (a) The main path: counts are zeroed just before and read just after.
    reset_launches()
    logits, cache = model.prefill(embeds=embeds, positions=grid,
                                  max_len=VLM_T)
    torch.cuda.synchronize()
    every = read_launches()
    want = {name: 0 for name in every}
    want["flash_attention"] = L
    full, _ = model.forward(embeds=embeds, positions=grid)
    model.attn_impl = "blockwise"
    plain_logits, plain_cache = model.prefill(embeds=embeds, positions=grid,
                                              max_len=VLM_T)
    plain_full, _ = model.forward(embeds=embeds, positions=grid)
    model.attn_impl = "pallas"
    torch.cuda.synchronize()
    V = cfg.vocab_size
    cos = F.cosine_similarity(full[0, :, :V].float(),
                              plain_full[0, :, :V].float(), dim=-1)
    last_cos = float(F.cosine_similarity(logits[0, :V].float(),
                                         plain_logits[0, :V].float(), dim=0))
    kv_cos = min(float(F.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))
        for a, b in zip(
            cache["stages"][0]["l0"].values(),
            plain_cache["stages"][0]["l0"].values()))
    problems = []
    if every != want:
        problems.append(f"(a) launches {every}, expected {want}")
    if not bool(torch.isfinite(full).all()):
        problems.append("(a) logits not finite")
    if min(float(cos.min()), last_cos, kv_cos) < MIN_COSINE:
        problems.append(f"(a) cosine: rows {float(cos.min())}, prefill's "
                        f"last {last_cos}, K/V {kv_cos} (min {MIN_COSINE})")
    if params != cfg.param_count() + _uncounted_params(cfg):
        problems.append(f"{params} parameters, the config counts "
                        f"{cfg.param_count()}")
    if problems:
        raise PhaseError("vlm: " + "; ".join(problems))
    phase("vlm", case="a", arch=cfg.name,
          layers=f"{cfg.num_layers}_of_80", d_model=cfg.d_model,
          heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
          head_dim=cfg.resolved_head_dim,
          m_rope_sections=json.dumps(list(cfg.m_rope_sections)),
          params=params, param_bytes=param_bytes, init_s=f"{init_s:.3f}",
          input=f"patch_embeddings_[1,{VLM_T},{cfg.d_model}]",
          grid=f"{VLM_TEXT}_text+{'x'.join(map(str, VLM_IMAGE))}_image",
          against="blockwise", rows=VLM_T,
          min_cosine=f"{float(cos.min()):.6f}",
          prefill_last_cosine=f"{last_cos:.6f}",
          kv_cache_min_cosine=f"{kv_cos:.6f}",
          max_abs_diff=f"{float((full - plain_full).abs().max()):.4f}",
          launches=json.dumps(every, separators=(",", ":")))
    del full, plain_full, cache, plain_cache

    # (b) the serve launcher's defaults on the cut model (text tokens)
    torch.cuda.reset_peak_memory_stats()
    args = serve.parse_args(["--arch", VLM])
    engine, stats, every, peak, serve_s = serve_counted(
        model, args, lambda st: {"flash_attention": 2 * L * st.prefills,
                                 "decode_attention": L * st.decode_events},
        "vlm (b)", sync_free=True)
    phase("vlm", case="b", arch=cfg.name, layers=cfg.num_layers,
          max_memory_allocated=peak, serve_s=f"{serve_s:.3f}",
          **_serve_fields(engine, stats, params, param_bytes),
          launches=json.dumps(every, separators=(",", ":")))
    del engine, model
    _fresh_card()
    phase("vlm_total", seconds=f"{time.perf_counter() - t_phase:.3f}")


# ---------------------------------------------------------------------------
# Phase train: the training path
# ---------------------------------------------------------------------------

def _state_bytes(state) -> int:
    from repro_torch.core.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(state))


def _train_steps(model, opt_cfg, dc, remat: bool, steps: int) -> dict:
    """``steps`` train steps of ``model`` from ``init_train_state(model,
    0)`` on ``make_batch(dc, i)``: each step's loss, grad_norm and
    seconds (host clock around a step ended by the read of its loss),
    the state's bytes and the peak device memory of the steps (reset
    after the state was built)."""
    import torch

    from repro_torch.data.pipeline import make_batch
    from repro_torch.training.train_step import (
        init_train_state,
        make_train_step,
    )

    state = init_train_state(model, 0)
    step = make_train_step(model, opt_cfg, num_microbatches=TRAIN_MICRO,
                           remat=remat)
    state_bytes = _state_bytes(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"loss": [], "grad_norm": [], "seconds": []}
    for i in range(steps):
        batch = make_batch(dc, i, model.device)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
    out["peak"] = torch.cuda.max_memory_allocated()
    out["state_bytes"] = state_bytes
    out["opt_step"] = int(state["opt"]["step"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_full_width() -> float:
    """(a) granite-moe-1b-a400m at full width and depth: steps without
    and with remat from the same state; returns the remat steps' ms."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import LM
    from repro_torch.training.optim import AdamWConfig

    cfg = get_config(TRAIN)
    t0 = time.perf_counter()
    # The weights live in the train state alone, as the launcher's
    # (ROADMAP A19): the module holds shapes on the meta device.
    model = LM(cfg, weights=False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    opt_cfg = AdamWConfig(lr=TRAIN_LR, schedule="cosine",
                          total_steps=TRAIN_STEPS_REMAT)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    runs = {"plain": _train_steps(model, opt_cfg, dc, False,
                                  TRAIN_STEPS_PLAIN),
            "remat": _train_steps(model, opt_cfg, dc, True,
                                  TRAIN_STEPS_REMAT)}
    params = sum(p.numel() for p in model.parameters())
    problems = []
    for name, run in runs.items():
        if not all(map(math.isfinite, run["loss"] + run["grad_norm"])):
            problems.append(f"{name}: non-finite loss or grad_norm "
                            f"{run['loss']} {run['grad_norm']}")
        steady = run["seconds"][1:]
        ms = sum(steady) / len(steady) * 1e3
        phase("train", case="a", arch=cfg.name, layers=cfg.num_layers,
              d_model=cfg.d_model, experts=cfg.moe.num_experts,
              top_k=cfg.moe.top_k, params=params, batch=TRAIN_BATCH,
              seq_len=TRAIN_SEQ, microbatches=TRAIN_MICRO, remat=name,
              steps=len(run["loss"]), build_s=f"{build_s:.3f}",
              first_step_ms=f"{run['seconds'][0] * 1e3:.1f}",
              ms_per_step=f"{ms:.1f}",
              tokens_per_s=f"{tokens / ms * 1e3:.1f}",
              max_memory_allocated=run["peak"],
              state_bytes=run["state_bytes"],
              losses=json.dumps([float(f"{x:.6f}") for x in run["loss"]]),
              grad_norms=json.dumps([float(f"{x:.6f}")
                                     for x in run["grad_norm"]]))
    plain, remat = runs["plain"], runs["remat"]
    rel = {key: _rel(remat[key][0], plain[key][0])
           for key in ("loss", "grad_norm")}
    for key, err in rel.items():
        if err > TRAIN_REMAT_RTOL:
            problems.append(f"remat's first {key} {remat[key][0]} against "
                            f"{plain[key][0]} (rel {err:.2e})")
    if remat["peak"] >= plain["peak"]:
        problems.append(f"remat's peak {remat['peak']} is not below "
                        f"{plain['peak']}")
    if problems:
        raise PhaseError("train (a): " + "; ".join(problems))
    phase("train", case="a_check", remat_loss_rel=f"{rel['loss']:.3e}",
          remat_grad_norm_rel=f"{rel['grad_norm']:.3e}",
          tol=TRAIN_REMAT_RTOL,
          peak_ratio=f"{remat['peak'] / plain['peak']:.4f}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    steady = remat["seconds"][1:]
    return sum(steady) / len(steady) * 1e3


def train_supervised() -> None:
    """(b) the supervisor through ``launch.train.train``: granite at full
    width cut to one pattern unit, a crash replayed from a checkpoint
    and a straggler."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import train as launch_train

    full = get_config(TRAIN)
    cfg = dataclasses.replace(full, num_layers=SUP_LAYERS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        args = launch_train.parse_args([
            "--arch", TRAIN, "--batch", str(TRAIN_BATCH), "--seq-len",
            str(SUP_SEQ), "--steps", str(SUP_STEPS), "--ckpt-every",
            str(SUP_CKPT_EVERY), "--inject-crash", str(SUP_CRASH),
            "--inject-straggler", str(SUP_STRAGGLER), "--log-every", "1",
            "--ckpt-dir", os.path.join(tmp, "run")])
        t0 = time.perf_counter()
        run = launch_train.train(cfg, args)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        rep = run.report
        problems = []
        if (rep.restarts, rep.straggler_mitigations, rep.steps_run) != \
                (1, 1, SUP_STEPS + SUP_CRASH - SUP_CKPT_EVERY):
            problems.append(f"report {rep}")
        if int(run.state["opt"]["step"]) != SUP_STEPS:
            problems.append(f"opt.step {int(run.state['opt']['step'])}")
        first = {s: loss for s, loss, _, _ in run.log[:SUP_CRASH]}
        replay = run.log[SUP_CRASH:]
        s0, l0 = replay[0][0], replay[0][1]
        if s0 != SUP_CKPT_EVERY + 1 or l0 != first[s0]:
            problems.append(f"first replayed step {s0} loss {l0!r} against "
                            f"{first.get(s0)!r}: not bit-identical")
        worst = 0.0
        for s, loss, _, _ in replay[1:]:
            if s in first:
                worst = max(worst, _rel(loss, first[s]))
        if worst > TRAIN_REMAT_RTOL:
            problems.append(f"later replayed steps off by rel {worst:.2e}")
        if not all(math.isfinite(x) for _, *vals in run.log for x in vals):
            problems.append("non-finite metrics")
        # One synchronous save and one restore of the final state.
        mgr = CheckpointManager(os.path.join(tmp, "timed"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(SUP_STEPS, run.state)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        t0 = time.perf_counter()
        restored, at = mgr.restore(run.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if at != SUP_STEPS or not all(
                torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                  tree_leaves(run.state))):
            problems.append("restored state differs")
        if problems:
            raise PhaseError("train (b): " + "; ".join(problems))
        phase("train", case="b", arch=cfg.name,
              layers=f"{cfg.num_layers}_of_{full.num_layers}",
              batch=TRAIN_BATCH, seq_len=SUP_SEQ, steps=SUP_STEPS,
              ckpt_every=SUP_CKPT_EVERY, crash_at=SUP_CRASH,
              straggler_at=SUP_STRAGGLER, restarts=rep.restarts,
              straggler_mitigations=rep.straggler_mitigations,
              steps_run=rep.steps_run,
              checkpoints_saved=rep.checkpoints_saved,
              opt_step=int(run.state["opt"]["step"]),
              first_replay=f"step{s0}_bit_identical",
              later_replay_rel=f"{worst:.3e}", run_s=f"{run_s:.3f}",
              checkpoint_bytes=nbytes, save_s=f"{save_s:.3f}",
              restore_s=f"{restore_s:.3f}",
              final_loss=f"{rep.final_loss:.6f}")
        del run, restored
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def train_card_against_cpu() -> None:
    """(c) the reduced granite, stablelm, deepseek (MLA) and hubert (fed
    frame embeddings) on the card and on the CPU from one f32 state and
    batch: the microbatched, rematerialized gradients leaf by leaf, then
    one step from them; then one step with gradient compression."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import key_leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import LM
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.train_step import (
        init_train_state,
        make_grad_fn,
        make_train_step,
        train_state,
    )

    for arch in ("granite-moe-1b-a400m", "stablelm-12b", DEEPSEEK, HUBERT):
        cfg = get_config(arch).reduced()
        cpu = LM(cfg, device="cpu", weights=False)
        card = LM(cfg, weights=False)
        params = tree_map(lambda t: t.float(),
                          init_train_state(cpu, 0)["params"])
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                        global_batch=8, input_mode=cfg.input_mode,
                        d_model=cfg.d_model)
        batch = make_batch(dc, 0)
        opt_cfg = AdamWConfig()
        out, grads = {}, {}
        for name, model in (("cpu", cpu), ("card", card)):
            state = train_state(tree_map(lambda t: t.to(model.device),
                                         params))
            on = {k: v.to(model.device) for k, v in batch.items()}
            grads[name] = make_grad_fn(model, num_microbatches=2,
                                       remat=True)(state["params"], on)
            step = make_train_step(model, opt_cfg, num_microbatches=2,
                                   remat=True)
            out[name] = step(state, on)
        (cs, cm), (gs, gm) = out["cpu"], out["card"]
        lr = float(cm["lr"])
        loss_rel = _rel(float(gm["loss"]), float(cm["loss"]))
        norm_rel = _rel(float(gm["grad_norm"]), float(cm["grad_norm"]))
        grad_loss_rel = _rel(float(grads["card"][0]),
                             float(grads["cpu"][0]))
        worst_grad, worst_grad_path = 0.0, ""
        for (path, c), (_, g) in zip(key_leaves(grads["cpu"][1]),
                                     key_leaves(grads["card"][1])):
            err = float((g.cpu() - c).norm()) / max(float(c.norm()), 1e-30)
            if err >= worst_grad:
                worst_grad, worst_grad_path = err, path
        worst_leaf, worst_path = 0.0, ""
        for (path, c), (_, g) in zip(key_leaves(cs["params"]),
                                     key_leaves(gs["params"])):
            err = float(((g.cpu() - c).abs()
                         - 1e-6 * c.abs()).max()) / lr
            if err > worst_leaf:
                worst_leaf, worst_path = err, path
        problems = []
        if max(loss_rel, grad_loss_rel) > CARD_LOSS_RTOL:
            problems.append(f"loss rel {loss_rel:.2e}, {grad_loss_rel:.2e}")
        if worst_grad > CARD_GRAD_RTOL:
            problems.append(f"gradient {worst_grad_path} off by rel "
                            f"{worst_grad:.2e}")
        if norm_rel > CARD_NORM_RTOL:
            problems.append(f"grad_norm rel {norm_rel:.2e}")
        if worst_leaf > CARD_LEAF_LRS:
            problems.append(f"leaf {worst_path} off by {worst_leaf:.3f} lr")
        comp = train_state(tree_map(lambda t: t.to(card.device), params),
                           compression=True)
        comp_state, comp_m = make_train_step(
            card, opt_cfg, num_microbatches=2, remat=True)(
                comp, {k: v.to(card.device) for k, v in batch.items()})
        ef_ok = all(
            tuple(e.shape) == tuple(p.shape) and e.dtype == torch.float32
            for (_, e), (_, p) in zip(key_leaves(comp_state["ef"]),
                                      key_leaves(comp_state["params"])))
        if not math.isfinite(float(comp_m["loss"])) or not ef_ok:
            problems.append(f"compression: loss {float(comp_m['loss'])}, "
                            f"ef shapes ok {ef_ok}")
        if problems:
            raise PhaseError(f"train (c) {arch}: " + "; ".join(problems))
        phase("train", case="c", arch=cfg.name, dtype="float32",
              input=cfg.input_mode, microbatches=2, remat=True,
              lr=f"{lr:.3e}",
              loss_cpu=f"{float(cm['loss']):.7f}",
              loss_card=f"{float(gm['loss']):.7f}",
              loss_rel=f"{loss_rel:.3e}", loss_tol=CARD_LOSS_RTOL,
              grad_norm_rel=f"{norm_rel:.3e}", grad_norm_tol=CARD_NORM_RTOL,
              worst_grad=worst_grad_path.replace(" ", ""),
              worst_grad_rel_l2=f"{worst_grad:.3e}",
              grad_tol=CARD_GRAD_RTOL,
              worst_leaf=worst_path.replace(" ", ""),
              worst_leaf_err_in_lr=f"{worst_leaf:.4f}",
              leaf_tol=f"{CARD_LEAF_LRS}*lr+1e-6*|p|",
              compression_loss=f"{float(comp_m['loss']):.6f}",
              ef_leaves=len(list(key_leaves(comp_state["ef"]))))


def train_refusal() -> None:
    """(d) a kernel-route LM's loss under autograd raises before any
    launch, directly and through the train step."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_unflatten
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import LM
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.train_step import (
        init_train_state,
        make_train_step,
    )

    cfg = get_config("stablelm-12b").reduced()
    model = LM(cfg, attn_impl="pallas")
    state = init_train_state(model, 0)
    batch = make_batch(DataConfig(cfg.vocab_size, 32, 2), 0, model.device)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(
        state["params"])]
    messages = []
    for call in (
            lambda: model.loss(batch, params=tree_unflatten(
                state["params"], leaves)),
            lambda: make_train_step(model, AdamWConfig())(state, batch)):
        before = read_launches()
        try:
            call()
        except RuntimeError as err:
            if "has no backward" not in str(err):
                raise
            messages.append(str(err).split(":")[0])
        else:
            raise PhaseError("train (d): a kernel route trained")
        if read_launches() != before:
            raise PhaseError("train (d): a kernel launched before the "
                             "refusal")
    phase("train", case="d", attn_impl="pallas", refused=len(messages),
          message=json.dumps(messages[0]))


def run_train() -> float:
    """Phase train: (a)-(d) with every kernel's launch count zeroed just
    before and read just after (JAX's training path runs no kernel);
    returns (a)'s remat step ms."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    reset_launches()
    remat_ms = train_full_width()
    train_supervised()
    train_card_against_cpu()
    train_refusal()
    every = read_launches()
    if any(every.values()):
        raise PhaseError(f"train: kernels launched {every}")
    phase("train_total", seconds=f"{time.perf_counter() - t_phase:.3f}",
          launches=json.dumps(every, separators=(",", ":")))
    return remat_ms


def _uncounted_params(cfg) -> int:
    """Parameters the port holds that ``ArchConfig.param_count`` leaves
    out: the norms (two a layer and the final one; a scale each, and a
    bias with layernorm), the mamba ``conv_b`` and ``dt_bias``, the MLA
    ``kv_norm`` scales."""
    per_norm = cfg.d_model * (2 if cfg.norm == "layernorm" else 1)
    n = (2 * cfg.num_layers + 1) * per_norm
    layers = mixer_layers(cfg)
    if cfg.mamba is not None:
        n += 2 * layers.get("mamba", 0) * cfg.mamba.d_inner(cfg.d_model)
    if cfg.mla is not None:
        n += layers.get("mla", 0) * cfg.mla.kv_lora_rank
    return n


def teacher_force_routed(model, phase_name: str) -> None:
    """The teacher-forced check of an MoE model's kernel route against
    ``blockwise``, in bf16, with the routing teacher-forced too (the
    jamba truncation, deepseek-v2-lite).  An MoE router after a kernel
    is discontinuous: a token whose k-th and (k+1)-th router logits are
    nearly tied may go to other experts on the two routes, and every
    later row then differs for that reason alone.  So ``blockwise`` runs
    first and the top-k expert indices of each of its routings are kept;
    the kernel route's routings take those indices, weighted by its own
    router logits, and every logit row must reach ``MIN_COSINE``.  The
    kernel route's own choices are compared with ``blockwise``'s, and
    each difference is printed with the k-th/(k+1)-th gap in both
    routes' logits, as a share of the token's router-logit spread.  With
    a mamba layer, its output on the kernel route's prefill layer input,
    kernel against the chunked plain scan, must reach
    ``MIN_MAMBA_COSINE``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import model as lm_module
    from repro_torch.models import moe as moe_module
    from repro_torch.models import ssm as ssm_module

    # Each route's routings: (router logits [tokens, E], top-k [tokens, k]).
    routings: dict = {"blockwise": [], "pallas": []}
    mamba_in: list = []
    top_k = moe_module._top_k

    def teacher_top_k(logits, k):
        vals, idx = top_k(logits, k)
        flat = routings[model.attn_impl]
        flat.append((logits.reshape(-1, logits.shape[-1]),
                     idx.reshape(-1, k)))
        if model.attn_impl == "blockwise":
            return vals, idx
        i = len(flat) - 1
        if i >= len(routings["blockwise"]):
            raise PhaseError(f"{phase_name}: the kernel route routes "
                             "more often than blockwise")
        pinned = routings["blockwise"][i][1].reshape(idx.shape)
        return torch.gather(logits, -1, pinned), pinned

    def mamba_recording(params, x, **kw):
        if model.attn_impl == "pallas" and not mamba_in:
            mamba_in.append((params, x.clone(), kw))
        return ssm_module.mamba_apply(params, x, **kw)

    saved = (moe_module._top_k, lm_module.mamba_apply)
    moe_module._top_k = teacher_top_k
    lm_module.mamba_apply = mamba_recording
    try:
        runs = _teacher_rows(model, "blockwise")
    finally:
        moe_module._top_k, lm_module.mamba_apply = saved
    a_calls, b_calls = routings["pallas"], routings["blockwise"]
    if not b_calls or len(a_calls) != len(b_calls):
        raise PhaseError(f"{phase_name}: the routes routed "
                         f"{len(a_calls)} and {len(b_calls)} times")
    diffs = []
    for i, ((la, ia), (lb, ib)) in enumerate(zip(a_calls, b_calls)):
        ia, ib = torch.sort(ia, dim=-1).values, torch.sort(ib, dim=-1).values
        k = ia.shape[-1]
        for tok in torch.nonzero((ia != ib).any(dim=-1)).flatten().tolist():
            gaps = []
            for lg in (la[tok], lb[tok]):
                top = torch.sort(lg.double(), descending=True).values
                gaps.append(float((top[k - 1] - top[k]) / (top[0] - top[-1])))
            diffs.append((i, tok, *gaps))
    cos, diff, finite = _compare(runs, "blockwise")
    mamba = {}
    if mamba_in:
        params, x, kw = mamba_in[0]
        kw = dict(kw, impl="pallas")
        y_k = ssm_module.mamba_apply(params, x, **kw)[0]
        y_p = ssm_module.mamba_apply(params, x,
                                     **dict(kw, impl="blockwise"))[0]
        mamba["mamba_layer_cosine"] = float(F.cosine_similarity(
            y_k.float().flatten(), y_p.float().flatten(), dim=0))
    elif "mamba" in mixer_layers(model.cfg):
        raise PhaseError(f"{phase_name}: no mamba layer input recorded")
    for i, tok, gap_a, gap_b in diffs:
        print(f"  own routing differs (blockwise's taken): routing {i} "
              f"token {tok}, k-th/(k+1)-th gap {gap_a:.3g} (kernel route), "
              f"{gap_b:.3g} (blockwise) of the token's router-logit spread")
    problems = []
    if not finite:
        problems.append("logits not finite")
    if float(cos.min()) < MIN_COSINE:
        problems.append(f"cosine {cos.tolist()} (min {MIN_COSINE})")
    if not mamba.get("mamba_layer_cosine", 1.0) >= MIN_MAMBA_COSINE:
        problems.append(f"mamba layer cosine {mamba['mamba_layer_cosine']}"
                        f" (min {MIN_MAMBA_COSINE})")
    if problems:
        raise PhaseError(f"{phase_name}: " + "; ".join(problems))
    phase(phase_name, arch=model.cfg.name, against="blockwise",
          dtype=str(model.embed.dtype)[6:], steps=TEACHER_STEPS + 1,
          routings=len(a_calls), routing="blockwise's",
          own_routing_differences=len(diffs),
          min_cosine=f"{float(cos.min()):.6f}", max_abs_diff=f"{diff:.4f}",
          **{k: f"{v:.7f}" for k, v in mamba.items()})


def teacher_force_rwkv(model) -> None:
    """The teacher-forced check of the rwkv6 kernel path against the
    chunked plain scan (``blockwise``).  In bf16 the two sit at the
    random-weight model's own rounding noise: a one-ulp change of a
    single embedding element moves the last logits to a cosine near
    0.997 (``scripts/torch_rwkv_noise.py``), so any two summation orders
    of the scan land there.  The gate therefore runs on an f32 copy of
    the same weights, where the kernel (with the same f32 inputs, shapes
    and strides as in serving) and the plain scan differ only in the
    order of their f32 sums; the bf16 numbers are printed beside it."""
    import copy

    import torch

    bf16 = _teacher_rows(model, "blockwise")
    model32 = copy.deepcopy(model).float()
    teacher_force(model32, "blockwise", phase_name="teacher_force_rwkv",
                  bf16_rows=bf16)
    del model32
    torch.cuda.empty_cache()


def _teacher_rows(model, plain_impl: str) -> dict:
    """Logits of one seeded prompt through ``prefill`` and
    ``TEACHER_STEPS`` ``decode_step``s, with the kernels
    (``attn_impl="pallas"``) and with ``plain_impl``, on the same weights
    and the same input tokens: ``{impl: [steps + 1, V] f32}``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    prompt = torch.tensor(rng.integers(0, model.cfg.vocab_size, (1, 16)),
                          dtype=torch.int32, device=model.device)
    feed = torch.tensor(rng.integers(0, model.cfg.vocab_size,
                                     (TEACHER_STEPS, 1, 1)),
                        dtype=torch.int32, device=model.device)
    runs = {}
    for impl in (plain_impl, "pallas"):
        model.attn_impl = impl
        logits, cache = model.prefill(prompt, max_len=64)
        rows = [logits[0]]
        for tok in feed:
            logits, cache = model.decode_step(cache, tok)
            rows.append(logits[0, 0])
        runs[impl] = torch.stack(rows).float()
    model.attn_impl = "pallas"
    return runs


def _compare(runs, plain_impl):
    import torch

    a, b = runs["pallas"], runs[plain_impl]
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    return cos, float((a - b).abs().max()), bool(torch.isfinite(a).all())


def teacher_force(model, plain_impl: str, phase_name: str = "teacher_force",
                  bf16_rows=None) -> None:
    """Kernel vs ``plain_impl`` logits (:func:`_teacher_rows`) must agree
    to a cosine of ``MIN_COSINE`` in the model's own dtype; ``bf16_rows``
    (an earlier bf16 run of the same comparison) is printed beside."""
    cos, diff, finite = _compare(_teacher_rows(model, plain_impl), plain_impl)
    if not finite or float(cos.min()) < MIN_COSINE:
        raise PhaseError(f"{phase_name}: kernel vs {plain_impl} logits "
                         f"cosine {cos.tolist()} (min {MIN_COSINE})")
    extra = {}
    if bf16_rows is not None:
        cos16, diff16, finite16 = _compare(bf16_rows, plain_impl)
        if not finite16:
            raise PhaseError(f"{phase_name}: bf16 logits not finite")
        extra = dict(bf16_min_cosine=f"{float(cos16.min()):.6f}",
                     bf16_max_abs_diff=f"{diff16:.4f}")
    phase(phase_name, arch=model.cfg.name, against=plain_impl,
          dtype=str(model.embed.dtype)[6:], steps=TEACHER_STEPS + 1,
          min_cosine=f"{float(cos.min()):.6f}", max_abs_diff=f"{diff:.4f}",
          **extra)


# ---------------------------------------------------------------------------
# Phase 5j: the stacked shard layout
# ---------------------------------------------------------------------------

def _differing(a, b) -> list:
    """The fields of two queues (or of two tuples of tensors) that are
    not bit-identical."""
    import torch

    names = a._fields if hasattr(a, "_fields") else range(len(a))
    return [str(n) for n, x, y in zip(names, a, b)
            if not torch.equal(x, y)]


def run_stacked(device_name: str) -> None:
    """Phase 5j: phase 5i (a)'s PHOLD at ``SHARDS`` shards, run
    ``STACKED_BATCHES`` super-steps on the card, then stacked; every
    ``tiered3_stacked_*`` helper, ``stacked_sharded_fault_bits`` and the
    engine's stacked absorb bit for bit against the tuple-of-shards op
    on the same CUDA tensors."""
    import torch

    from repro_torch.core import queue as q
    from repro_torch.core import validate as V
    from repro_torch.core.events import ARG_WIDTH
    from repro_torch.core.sharded import stack_sharded_queue
    from repro_torch.examples import phold

    t_phase = time.perf_counter()
    prog = phold.build_program(num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP,
                               max_batch_len=4, capacity=PHOLD_CAPACITY)
    eng = prog.build(backend="device", device=device_name,
                     shards=SHARDS).engine
    _, sq, _ = eng.run(phold.initial_state(PHOLD_LPS, device_name),
                       eng.initial_queue(prog.scheduled_events()),
                       max_batches=STACKED_BATCHES)
    stq = stack_sharded_queue(sq)
    shards = sq.shards
    problems = []

    def check(label, got, want):
        bad = _differing(got, want)
        if bad:
            problems.append(f"{label}: {bad}")

    for name in ("has_pending", "occupancy", "next_time"):
        check(name, (getattr(q, f"tiered3_stacked_{name}")(stq.q),),
              (torch.stack([getattr(q, f"tiered3_queue_{name}")(s)
                            for s in shards]),))
    keys = [q.tiered3_queue_next_key(s) for s in shards]
    check("next_key", q.tiered3_stacked_next_key(stq.q),
          tuple(torch.stack(col) for col in zip(*keys)))

    k = 4
    q2, *peeked = q.tiered3_stacked_peek_front(stq.q, k)
    singles = [q.tiered3_queue_peek_front(s, k) for s in shards]
    for i, one in enumerate(singles):
        check(f"peek shard {i}", q2._make(x[i] for x in q2), one[0])
        check(f"peeked shard {i}", [x[i] for x in peeked], one[1:])
    lengths = torch.minimum(
        torch.tensor([2, 1, 0, 4], dtype=torch.int32, device=device_name),
        torch.sum(peeked[1] >= 0, dim=1).to(torch.int32))
    q3 = q.tiered3_stacked_pop_prefix(q2, lengths, k)
    popped = [q.tiered3_queue_pop_prefix(one[0], lengths[i], k)
              for i, one in enumerate(singles)]
    for i, one in enumerate(popped):
        check(f"pop shard {i}", q3._make(x[i] for x in q3), one)

    # Four emitted rows near the fronts' heads, each routed to one shard.
    t0 = float(peeked[0][0, 0])
    rows = torch.zeros((4, 2 + ARG_WIDTH), device=device_name)
    rows[:, 0] = t0 + torch.tensor([1.0, 1.5, 2.0, 3.5])
    rows[:, 2] = torch.arange(4.0)
    seqs = sq.next_seq + torch.arange(4, dtype=torch.int32,
                                      device=device_name)
    insert = (torch.arange(4, device=device_name)[None, :] % SHARDS
              == torch.arange(SHARDS, device=device_name)[:, None])
    torch.cuda.synchronize()
    reset_launches()
    q4 = q.tiered3_stacked_fill_rows_tagged(q3, rows, seqs, insert)
    torch.cuda.synchronize()
    fill_launches = read_launches()["front_merge"]
    if fill_launches != SHARDS:
        problems.append(f"stacked fill launched front_merge "
                        f"{fill_launches} times, not {SHARDS}")
    for i, one in enumerate(popped):
        check(f"fill shard {i}", q4._make(x[i] for x in q4),
              q.tiered3_queue_fill_rows_tagged(one, rows, seqs, insert[i]))

    words = (int(V.stacked_sharded_fault_bits(stq)),
             int(V.sharded_fault_bits(sq)))
    if words != (0, 0):
        problems.append(f"fault words (stacked, tuple) {words}")
    occ = (int(eng.queue_occupancy(stq)), int(eng.queue_occupancy(sq)))
    if occ[0] != occ[1]:
        problems.append(f"occupancy (stacked, tuple) {occ}")

    # Arrivals with seqs older than the queued ones, through the engine.
    rows_a = rows.clone()
    rows_a[:, 0] = t0 + torch.tensor([0.5, 0.5, 1.0, 4.0])
    seqs_a = torch.tensor([1, 3, 5, 7], dtype=torch.int32,
                          device=device_name)
    ins_a = torch.ones(4, dtype=torch.bool, device=device_name)
    got = eng.absorb_rows(stq, rows_a, seqs_a, ins_a)
    want = eng.absorb_rows(sq, rows_a, seqs_a, ins_a)
    for i, one in enumerate(want.shards):
        check(f"absorb shard {i}", got.shard(i), one)
    check("absorb counters", (got.size, got.next_seq, got.dropped),
          (want.size, want.next_seq, want.dropped))
    if problems:
        raise PhaseError("stacked: " + "; ".join(problems))
    phase("stacked", shards=SHARDS, lps=PHOLD_LPS, capacity=PHOLD_CAPACITY,
          batches=STACKED_BATCHES, occupancy=occ[0], fault_word=0,
          fill_front_merge_launches=fill_launches,
          helpers_bit_identical=True,
          seconds=f"{time.perf_counter() - t_phase:.3f}")


# ---------------------------------------------------------------------------
# Phase 5j2: the sharded engine's placement="devices"
# ---------------------------------------------------------------------------

DEVICES_RANKS = 4          # case (b): four ranks on the one card over gloo
DEVICES_FUSED_RANKS = 2    # case (c): two ranks under fused, checkpointed
DEVICES_TIMEOUT = 300      # seconds a case's ranks may take, start-up too


def _devices_collectives(counts, batches, validate: bool) -> list:
    """Collectives a run of ``batches`` super-steps makes, and what they
    must be: 2 a super-step (3 validated), plus the first guard gather,
    the result's occupancy gather and, validated, the entry audit's."""
    want = (3 if validate else 2) * batches + (3 if validate else 2)
    got = counts.get("collectives", 0)
    return [] if got == want else [
        f"{got} collectives in {batches} super-steps, expected {want}"]


def _rank_fields(records: list, serial_steps_per_s: float) -> dict:
    """The per-rank numbers of a case's line, rank by rank."""
    def each(fn):
        return json.dumps([fn(r) for r in records], separators=(",", ":"))

    b = records[0]["batches"]
    return dict(
        card_s=each(lambda r: round(r["card_s"], 3)),
        setup_s=each(lambda r: round(r["setup_s"], 3)),
        steps_per_s=each(lambda r: round(b / r["card_s"], 1)),
        ratio_to_serial=each(
            lambda r: round(b / r["card_s"] / serial_steps_per_s, 4)),
        loop_syncs_per_step=each(
            lambda r: round(r["counts"].get("loop_syncs", 0) / b, 4)),
        host_syncs_per_step=each(
            lambda r: round(r["counts"]["host_syncs"] / b, 4)),
        collectives_per_step=each(
            lambda r: round(r["counts"].get("collectives", 0) / b, 4)),
        launches=each(lambda r: r["launches"]),
        peak_mb=each(lambda r: r["peak_mb"]))


def devices_rank(rank: str, world: str, port: str, case: str, out: str,
                 hot: str) -> None:
    """A rank of phase devices (b) or (c), in a child process: PHOLD at
    the smoke's sharded size, one shard queue this rank, over a gloo
    group of ``world`` ranks on the one card; the kernels are loaded from
    the build directory.  Writes its numbers to ``out``; rank 0 also the
    gathered outcome.  (c) then crashes a checkpointed run after its
    first segment and resumes it through ``place_queue``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.examples import phold
    from repro_torch.testing.faults import SimulatedCrash

    rank, world = int(rank), int(world)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=DEVICES_TIMEOUT))
    try:
        kw = (dict(validate="cheap") if case == "b" else
              dict(dispatch_mode="fused", hot_words=json.loads(hot),
                   **FUSED_SHARD_TIERS))
        t0 = time.perf_counter()
        sim = phold.build_program(
            num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
            capacity=PHOLD_CAPACITY).build(
                backend="device", shards=world, placement="devices", **kw)
        setup_s = time.perf_counter() - t0
        # The captured loop over gloo on a card: refused at build time,
        # before any launch.
        reset_launches()
        try:
            phold.build_program(
                num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
                capacity=PHOLD_CAPACITY).build(
                    backend="device", shards=world, placement="devices",
                    loop="captured", **kw)
        except ValueError as err:
            refusal = str(err)
        else:
            refusal = None
        refusal_launches = sum(read_launches().values())
        state = phold.initial_state(PHOLD_LPS, "cuda")
        # Set up while the parent runs the cases before this one; run
        # when it says so, so that no two cases share the card.
        go = os.path.join(out, f"{case}.go")
        while not os.path.exists(go):
            if time.perf_counter() - t0 > DEVICES_TIMEOUT:
                raise RuntimeError(f"no {go} in {DEVICES_TIMEOUT} s")
            time.sleep(0.05)
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 2**20
        res, card_s, every, counts = drive(sim, state,
                                           max_batches=MODES_BATCHES)
        record = dict(rank=rank, device=str(sim.engine.device),
                      batches=res.batches, card_s=card_s, setup_s=setup_s,
                      launches=every, counts=counts,
                      fault_word=res.fault_word, refusal=refusal,
                      refusal_launches=refusal_launches,
                      peak_mb=round(torch.cuda.max_memory_allocated() / 2**20
                                    - base_mb, 1))
        got = result_arrays(res)
        if case == "c":
            ckpt = os.path.join(out, "ckpt_c")
            every_seg = MODES_BATCHES // 2

            def crash(seg, *_):
                if seg == 1:
                    raise SimulatedCrash("injected crash after segment 1")

            try:
                sim.run(state, max_batches=MODES_BATCHES,
                        checkpoint_every=every_seg, checkpoint_dir=ckpt,
                        _segment_hook=crash)
            except SimulatedCrash:
                pass
            else:
                raise RuntimeError("the injected crash never fired")
            resumed, r_s, r_every, r_counts = drive(
                sim, state, max_batches=MODES_BATCHES,
                checkpoint_every=every_seg, checkpoint_dir=ckpt,
                resume_from="latest")
            record.update(resumed_s=r_s, resumed_launches=r_every,
                          resumed_counts=r_counts,
                          resumed_problems=arrays_problems(
                              result_arrays(resumed), got, "resumed"))
        if rank == 0:
            np.savez(os.path.join(out, f"{case}.npz"), **got)
        with open(os.path.join(out, f"{case}_rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        dist.destroy_process_group()


def start_devices_ranks(case: str, world: int, out: str, hot) -> dict:
    """``world`` ranks of :func:`devices_rank`, each a child process,
    started now: they set up, then wait for :func:`finish_devices_ranks`."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    # One intra-op thread a rank: the ranks share the host's cores.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.devices_rank(*sys.argv[2:])")
    logs = [open(os.path.join(out, f"{case}_rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT), str(r), str(world),
         str(port), case, out, json.dumps(hot)], cwd=str(ROOT), env=env,
        stdout=log, stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    return dict(case=case, world=world, out=out, procs=procs, logs=logs)


def stop_devices_ranks(ranks: dict) -> None:
    for p, log in zip(ranks["procs"], ranks["logs"]):
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def finish_devices_ranks(ranks: dict) -> tuple:
    """Let the ranks run, wait for them; returns each rank's record and
    rank 0's outcome."""
    import numpy as np

    case, world, out = ranks["case"], ranks["world"], ranks["out"]
    with open(os.path.join(out, f"{case}.go"), "w"):
        pass
    t0 = time.perf_counter()
    try:
        for p in ranks["procs"]:
            p.wait(timeout=max(1.0, DEVICES_TIMEOUT
                               - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        raise PhaseError(f"devices {case}: ranks not done in "
                         f"{DEVICES_TIMEOUT} s") from None
    finally:
        stop_devices_ranks(ranks)
    for r, p in enumerate(ranks["procs"]):
        if p.returncode != 0:
            with open(os.path.join(out, f"{case}_rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise PhaseError(f"devices {case}: rank {r} exit "
                             f"{p.returncode}: {tail}")
    records = []
    for r in range(world):
        with open(os.path.join(out, f"{case}_rank{r}.json")) as f:
            records.append(json.load(f))
    with np.load(os.path.join(out, f"{case}.npz")) as npz:
        got = {k: npz[k] for k in npz.files}
    return records, got


def _rank_problems(records: list, want_front: int, serial_loop: int,
                   validate: bool) -> list:
    """Per rank: ``front_merge`` once a super-step, ``window_extract``
    never, fault word 0, at least 4 host reads a super-step and no more
    than the serial run's (which reads every shard's flags and rare
    paths), and the collectives of :func:`_devices_collectives`."""
    problems = []
    for r in records:
        b = r["batches"]
        label = f"rank {r['rank']}"
        problems += _launch_want(r["launches"], {"front_merge": want_front},
                                 label)
        if r["fault_word"] != 0:
            problems.append(f"{label}: fault word {r['fault_word']}")
        loop = r["counts"].get("loop_syncs", 0)
        if not 4 * b <= loop <= serial_loop:
            problems.append(f"{label}: {loop} loop reads in {b} super-steps"
                            f" (serial: {serial_loop})")
        problems += [f"{label}: {p}" for p in
                     _devices_collectives(r["counts"], b, validate)]
        if not (r["refusal"] and "'gloo'" in r["refusal"]
                and "NCCL" in r["refusal"]):
            problems.append(f"{label}: loop='captured' over gloo gave "
                            f"{r['refusal']!r}, not the NCCL-only refusal")
        if r["refusal_launches"]:
            problems.append(f"{label}: {r['refusal_launches']} launches "
                            "before the refusal")
    return problems


def devices_one_rank(base, base_counts) -> dict:
    """Phase devices (a): ``shards=1, placement="devices"`` in this
    process over an NCCL group of one rank, beside the serial engine at
    one shard, each held to phase queue_modes' tiered3 run; then the
    same rank in the captured loop (its gathers inside the CUDA graph),
    held to the eager rank's run (:func:`_captured_run`) and to the
    tiered3 run, with as many collectives as the eager rank's: the run
    ends on a chunk's end."""
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.examples import phold

    serial, _, serial_s, _, serial_counts = run_phold_built(
        "cuda", MODES_BATCHES, shards=1)
    problems = rows_problems(serial, base)
    del serial
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        # NCCL builds its communicator at the first collective: here,
        # outside the timed run.
        dist.barrier(device_ids=[torch.cuda.current_device()])
        res, setup_s, card_s, every, counts = run_phold_built(
            "cuda", MODES_BATCHES, shards=1, placement="devices")
        problems += rows_problems(res, base) + _launch_want(
            every, {"front_merge": res.batches}, "devices a")
        problems += _devices_collectives(counts, res.batches, False)
        if not res.raw["final_queue"].placed:
            problems.append("the final queue is not placed")
        loop = counts.get("loop_syncs", 0)
        if not 4 * res.batches <= loop <= serial_counts["loop_syncs"]:
            problems.append(f"{loop} loop reads in {res.batches} "
                            "super-steps")
        fields = _steps(res, card_s, counts, every, (base, base_counts),
                        setup_s)
        if problems:
            raise PhaseError("devices a: " + "; ".join(problems))
        _, capt, c_counts, _, captured = _captured_run(
            "devices a", lambda: phold.build_program(
                num_lps=PHOLD_LPS, t_stop=PHOLD_T_STOP, max_batch_len=4,
                capacity=PHOLD_CAPACITY).build(
                    backend="device", device="cuda", shards=1,
                    placement="devices", loop="captured"),
            lambda: phold.initial_state(PHOLD_LPS, "cuda"), res, counts,
            every, res.raw["loop_s"], max_batches=MODES_BATCHES)
        problems += rows_problems(capt, base)
        if c_counts.get("collectives") != counts.get("collectives"):
            problems.append(f"captured: {c_counts.get('collectives')} "
                            f"collectives, eager {counts.get('collectives')}")
        if not capt.raw["final_queue"].placed:
            problems.append("the captured run's final queue is not placed")
    finally:
        dist.destroy_process_group()
    if problems:
        raise PhaseError("devices a: " + "; ".join(problems))
    return dict(fields, collectives_per_step=(
        f"{counts['collectives'] / res.batches:.4f}"),
        ratio_to_serial=f"{serial_s / card_s:.4f}",
        serial_steps_per_s=f"{res.batches / serial_s:.1f}",
        loop_steps_per_s=f"{res.batches / res.raw['loop_s']:.1f}",
        captured_collectives_per_step=(
            f"{c_counts['collectives'] / capt.batches:.4f}"), **captured)


def devices_case(ranks: dict, want: dict, serial_steps: float,
                 serial_counts: dict, validate: bool) -> None:
    """Phase devices (b) or (c): run the started ranks, hold rank 0's
    outcome to the serial run's, check and print each rank's numbers."""
    case, world = ranks["case"], ranks["world"]
    records, got = finish_devices_ranks(ranks)
    b = records[0]["batches"]
    problems = arrays_problems(got, want, "outcome")
    problems += _rank_problems(records, b, serial_counts["loop_syncs"],
                               validate)
    if case == "c":
        for r in records:
            problems += [f"rank {r['rank']}: {p}"
                         for p in r["resumed_problems"]]
            problems += _launch_want(
                r["resumed_launches"], {"front_merge": b - MODES_BATCHES // 2},
                f"rank {r['rank']} resumed")
    if problems:
        raise PhaseError(f"devices {case}: " + "; ".join(problems))
    extra = (dict(validate="cheap") if case == "b" else dict(
        dispatch_mode="fused",
        tiers=json.dumps(FUSED_SHARD_TIERS, separators=(",", ":")),
        checkpoint_every=MODES_BATCHES // 2, resumed_after=1,
        resumed_s=json.dumps([round(r["resumed_s"], 3) for r in records])))
    phase("devices", case=case, backend="gloo", ranks=world, cards=1,
          devices=json.dumps(sorted({r["device"] for r in records})),
          batches=b, **extra, **_rank_fields(records, serial_steps),
          serial_steps_per_s=f"{serial_steps:.1f}",
          bit_identical_to_serial=True,
          captured_refused_over_gloo=True,
          nccl_multi_rank="not run: NCCL at N > 1 needs N cards")


def run_devices(base, base_counts, serial, hot) -> None:
    """Phase 5j2: (a) one rank over NCCL, in this process; (b) four ranks
    on the one card over gloo, validated, held to phase sharded (a)'s
    serial run; (c) two ranks under fused on small tiers, a checkpoint
    resumed through ``place_queue``, held to phase sharded (b)'s."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_devices_") as out:
        # (b) and (c)'s ranks start now and set up during (a).
        started = [start_devices_ranks(case, world, out, hot)
                   for case, world in (("b", DEVICES_RANKS),
                                       ("c", DEVICES_FUSED_RANKS))]
        try:
            a = devices_one_rank(base, base_counts)
            phase("devices", case="a", backend="nccl", ranks=1, cards=1,
                  lps=PHOLD_LPS, capacity_per_shard=PHOLD_CAPACITY, **a,
                  bit_identical_to_tiered3=True)
            for ranks, (want, serial_steps, serial_counts), validate in zip(
                    started, (serial["a"], serial["b"]), (True, False)):
                devices_case(ranks, want, serial_steps, serial_counts,
                             validate)
        finally:
            for ranks in started:
                stop_devices_ranks(ranks)
    phase("devices_total", seconds=f"{time.perf_counter() - t_phase:.3f}")


# ---------------------------------------------------------------------------
# Phase 5k: the §IV.A wireless example
# ---------------------------------------------------------------------------

WIRELESS_HOST_TIMEOUT = 900


def start_wireless_host(tmp: str) -> dict:
    """Phase wireless's compiled host run, started with the script: the
    example on the host scheduler with each batch word compiled by
    Inductor, on the card, in a child process (:func:`wireless_host_run`),
    so that its compiles overlap the phases before it (the run took
    201 s alone on the card's host).  One compile thread, to leave the
    cores to those phases."""
    path = os.path.join(tmp, "wireless_host.json")
    log = open(path + ".log", "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TORCHINDUCTOR_COMPILE_THREADS="1")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke; chip_smoke.wireless_host_run(sys.argv[2])")
    proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT), path],
                            cwd=str(ROOT), env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    return dict(cell="wireless_host", path=path, proc=proc, log=log,
                t0=time.perf_counter())


def wireless_host_run(path: str) -> None:
    """The child of :func:`start_wireless_host`: the host run of
    ``wireless_des.run_all`` on the card with its words compiled
    (``jit_handlers=True``), its result written to ``path``."""
    from repro_torch.examples import wireless_des as w

    t0 = time.perf_counter()
    res = w.build_program().build(
        backend="host", scheduler="conservative", device="cuda",
        jit_handlers=True).run(w.initial_state())
    with open(path, "w") as f:
        json.dump({"got": [res.state["inbox"].tolist(), int(res.batches),
                           int(res.events), int(res.dropped)],
                   "seconds": time.perf_counter() - t0}, f)


def wait_child(child: dict, timeout: float, problems: list, name: str):
    """``child``'s JSON output, or None with the reason in ``problems``
    (not done within ``timeout`` seconds of its start, or failed)."""
    left = max(1.0, timeout - (time.perf_counter() - child["t0"]))
    try:
        rc = child["proc"].wait(timeout=left)
    except subprocess.TimeoutExpired:
        problems.append(f"{name}: not done in {timeout} s")
        return None
    child["log"].close()
    if rc != 0:
        with open(child["path"] + ".log") as f:
            tail = f.read()[-2000:]
        problems.append(f"{name}: exit {rc}: {tail}")
        return None
    with open(child["path"]) as f:
        return json.load(f)


def run_wireless(device_name: str, host_child: dict) -> None:
    """Phase 5k: the wireless example's runs on the card (the host run
    with its words compiled, in ``host_child``, and eager; the two-tier
    and flat device queues) against one another and a CPU eager run; its
    analysis from the card template against the CPU's, no launch; then
    the cross-event check (reported, not gated: whether Inductor drops
    the dead word's message work), whose compiled words must deliver
    what their events say."""
    import torch

    from repro_torch.analysis import analyze
    from repro_torch.core import queue as q
    from repro_torch.core.tree import tree_map
    from repro_torch.examples import wireless_des as w

    t_phase = time.perf_counter()
    reset_launches()
    t0 = time.perf_counter()
    card = w.run_all(device_name, jit_handlers=False)
    card_s = time.perf_counter() - t0
    launches = read_launches()
    cpu = w.run_all("cpu", jit_handlers=False)["host"]
    problems = []
    want = [cpu.state["inbox"].tolist(), int(cpu.batches), int(cpu.events),
            int(cpu.dropped)]
    for name, res in card.items():
        got = [res.state["inbox"].tolist(), int(res.batches),
               int(res.events), int(res.dropped)]
        if got != want:
            problems.append(f"{name}: {got} against the CPU's {want}")
    compiled = wait_child(host_child, WIRELESS_HOST_TIMEOUT, problems,
                          "host_compiled")
    if compiled is not None and compiled["got"] != want:
        problems.append(f"host_compiled: {compiled['got']} against the "
                        f"CPU's {want}")

    prog = w.make_program()
    cpu_state = prog._example_state
    reset_launches()
    q.COUNTS.clear()
    t0 = time.perf_counter()
    report = analyze(prog, state=tree_map(lambda x: x.to(device_name),
                                          cpu_state))
    analysis_s = time.perf_counter() - t0
    if report.to_json() != analyze(prog, state=cpu_state).to_json():
        problems.append("the card template's report differs")
    if not report.ok or report.dead:
        problems.append(f"analysis not clean: {report.dead}")
    if any(read_launches().values()) or any(q.COUNTS.values()):
        problems.append("the analysis launched a kernel or moved a count")

    check = w.cross_event_check(device_name)
    msg = int(w.message(device_name)[0])
    if (check["dead_inbox"] != [0] * w.N_RECEIVERS
            or check["live_inbox"] != [msg] * w.N_RECEIVERS):
        problems.append(f"compiled words delivered {check['dead_inbox']} "
                        f"and {check['live_inbox']}, message {msg}")
    if problems:
        raise PhaseError("wireless: " + "; ".join(problems))
    phase("wireless", inbox=json.dumps(want[0]), batches=want[1],
          events=want[2], dropped=want[3], message=msg,
          runs="host_compiled,host_eager,tiered_4096,flat_64",
          card_s=f"{card_s:.3f}",
          host_compiled_s=f"{compiled['seconds']:.3f}",
          launches=json.dumps(launches, separators=(",", ":")),
          analysis_s=f"{analysis_s:.3f}", reports_equal=True,
          dead_work_in_code=check["dead_work_in_code"],
          live_work_in_code=check["live_work_in_code"],
          dead_ms=f"{check['dead_ms']:.6f}",
          live_ms=f"{check['live_ms']:.6f}",
          dead_over_live=f"{check['ratio']:.4f}",
          seconds=f"{time.perf_counter() - t_phase:.3f}")


# ---------------------------------------------------------------------------
# Phase 6g: the mesh, the sharding rules and the dry run
# ---------------------------------------------------------------------------

def start_dryrun_cells(tmp: str) -> list:
    """Phase mesh (b), started with the script: ``python -m
    repro_torch.launch.dryrun`` for each of ``DRYRUN_CELLS`` in a child
    process of its own (the fake process group needs a process without
    the NCCL group of (a)), CUDA avatars, at full size."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = []
    for arch, shape, mesh in DRYRUN_CELLS:
        path = os.path.join(tmp, f"{arch}_{shape}_{mesh}.json")
        log = open(path + ".log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--out", path],
            cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT)
        out.append(dict(cell=(arch, shape, mesh), path=path, proc=proc,
                        log=log, t0=time.perf_counter()))
    return out


def stop_children(children: list) -> None:
    for child in children:
        if child["proc"].poll() is None:
            child["proc"].kill()
            child["proc"].wait()
        child["log"].close()


def _mesh_diff(name: str, got, want, rtol: float, atol: float,
               problems: list, firsts: list) -> None:
    """Hold ``got`` to ``want``: bit-identical, or within the tolerance
    with the first differing field named."""
    import torch

    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    if torch.equal(got, want):
        return
    if not firsts:
        firsts.append(name)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        problems.append(f"{name}: max abs diff {err:.3e}")


def mesh_one_rank(device: str = "cuda", backend: str = "nccl",
                  cfg=None) -> dict:
    """Phase mesh (a): granite-moe-1b-a400m at full width on a real
    (1, 1) mesh (``make_host_mesh`` over a process group of one rank):
    one microbatched, rematerialized train step with the train state and
    batch placed by the sharding rules, and a prefill and greedy decode
    with the kernel route and the weights, cache and tokens placed by
    the rules, each held to the same run without a mesh."""
    import socket

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core.tree import key_leaves
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.training.optim import AdamWConfig
    from repro_torch.training.train_step import (
        init_train_state,
        make_train_step,
    )

    cfg = cfg or get_config(TRAIN)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    problems, firsts, out = [], [], {}
    try:
        mesh = make_host_mesh(1, device=device)
        # --- the train step -------------------------------------------
        model = LM(cfg, device=device, weights=False)
        state = init_train_state(model, 0)
        batch = make_batch(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=MESH_TRAIN_SEQ,
                                      global_batch=MESH_TRAIN_BATCH), 0,
                           model.device)
        step = make_train_step(model, AdamWConfig(lr=TRAIN_LR),
                               num_microbatches=2, remat=True)
        reset_launches()
        new, metrics = step(state, batch)
        want = {k: float(metrics[k]) for k in ("loss", "grad_norm")}
        want_params = [t for _, t in key_leaves(new["params"])]
        del new
        t0 = time.perf_counter()
        with sh.anchored(mesh):
            state_d = sh.distribute(state, mesh, sh.state_specs(mesh, state))
            batch_d = sh.distribute(batch, mesh, sh.batch_specs(mesh, batch))
            new_d, metrics_d = step(state_d, batch_d)
        if device == "cuda":
            torch.cuda.synchronize()
        out["train_s"] = time.perf_counter() - t0
        got = {k: float(m.full_tensor() if isinstance(m, sh.DTensor)
                        else m) for k, m in metrics_d.items() if k in want}
        for k in want:
            if got[k] != want[k]:
                if not firsts:
                    firsts.append(k)
                if abs(got[k] - want[k]) > MESH_TRAIN_RTOL * abs(want[k]):
                    problems.append(f"{k} {got[k]} against {want[k]}")
        for (path, g), w in zip(key_leaves(new_d["params"]), want_params):
            _mesh_diff(f"params{path}", g, w, 2.0**-7, 1e-6, problems,
                       firsts)
        out.update(loss=got["loss"], grad_norm=got["grad_norm"],
                   train_launches=sum(read_launches().values()))
        del state, state_d, new_d, want_params, step, model
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        # --- prefill and greedy decode on the kernel route -------------
        model = LM(cfg, attn_impl="pallas", device=device).init(0)
        gen = torch.Generator().manual_seed(5)
        prompts = torch.randint(0, cfg.vocab_size, (MESH_B, MESH_T),
                                generator=gen, dtype=torch.int32)

        def serve(put):
            logits, cache = model.prefill(put(prompts.to(device),
                                              sh.P(("data",), None)),
                                          max_len=MESH_MAX_LEN)
            seen = [logits]
            toks = []
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            for _ in range(MESH_STEPS):
                full = tok.full_tensor() if isinstance(
                    tok, sh.DTensor) else tok
                toks.append(full)
                logits, cache = model.decode_step(
                    cache, put(full, sh.P(("data",), None)))
                seen.append(logits[:, 0])
                tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
            return seen, toks

        reset_launches()
        want_logits, want_toks = serve(lambda x, spec: x)
        plain = read_launches()
        reset_launches()
        with sh.anchored(mesh):
            sh.distribute_lm(model, mesh)
            got_logits, got_toks = serve(
                lambda x, spec: sh.distribute(x, mesh, spec))
        meshed = read_launches()
        for i, (g, w) in enumerate(zip(got_logits, want_logits)):
            _mesh_diff(f"logits[{i}]", g, w, 0.0, MESH_LOGIT_ATOL, problems,
                       firsts)
        if not all(torch.equal(g, w) for g, w in zip(got_toks, want_toks)):
            problems.append("greedy tokens differ")
        for kernel in ("flash_attention", "decode_attention"):
            if not meshed.get(kernel) or meshed[kernel] != plain.get(kernel):
                problems.append(f"{kernel}: {meshed.get(kernel)} launches "
                                f"on the mesh, {plain.get(kernel)} without")
        others = {k: v for k, v in meshed.items()
                  if v and k not in ("flash_attention", "decode_attention")}
        if others:
            problems.append(f"other kernels launched: {others}")
        out.update(plain_launches=plain, mesh_launches=meshed,
                   tokens=[t.flatten().tolist() for t in got_toks])
        del model
    finally:
        dist.destroy_process_group()
    out["first_differing"] = firsts[0] if firsts else None
    out["problems"] = problems
    return out


def run_mesh(children: list) -> None:
    """Phase 6g: (a) the one-rank mesh against the run without one; (b)
    the three dry-run cells started with the script, their per-device
    terms."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    a = mesh_one_rank()
    peak = torch.cuda.max_memory_allocated()
    if a["problems"]:
        raise PhaseError("mesh (a): " + "; ".join(a["problems"]))
    phase("mesh", case="a", arch=TRAIN, mesh="1x1", backend="nccl",
          train_batch=MESH_TRAIN_BATCH, train_seq=MESH_TRAIN_SEQ,
          loss=f"{a['loss']:.6f}", grad_norm=f"{a['grad_norm']:.6f}",
          train_s=f"{a['train_s']:.3f}", train_launches=a["train_launches"],
          prompts=f"{MESH_B}x{MESH_T}", decode_steps=MESH_STEPS,
          bit_identical=a["first_differing"] is None,
          first_differing=json.dumps(a["first_differing"]),
          tol=f"train:{MESH_TRAIN_RTOL},params:bf16_ulp,"
              f"logits:{MESH_LOGIT_ATOL}",
          launches=json.dumps(a["mesh_launches"], separators=(",", ":")),
          plain_launches=json.dumps(a["plain_launches"],
                                    separators=(",", ":")),
          tokens=json.dumps(a["tokens"], separators=(",", ":")),
          max_memory_allocated=peak)
    problems = []
    for child in children:
        arch, shape, mesh = child["cell"]
        rows = wait_child(child, DRYRUN_TIMEOUT, problems,
                          f"{arch} {shape} {mesh}")
        if rows is None:
            continue
        (row,) = rows
        r = row["roofline"]
        if row["status"] != "ok":
            problems.append(f"{arch} {shape} {mesh}: {row['status']}")
            continue
        if r["collective_bytes_per_device"] <= 0:
            problems.append(f"{arch} {shape} {mesh}: no collective bytes")
        phase("mesh", case="b", arch=arch, shape=shape, mesh=mesh,
              chips=r["chips"], trace_s=row["trace_seconds"],
              flops_per_device=r["flops_per_device"],
              bytes_per_device=r["bytes_per_device"],
              collective_bytes_per_device=r["collective_bytes_per_device"],
              collective_by_group=json.dumps(r["collective_by_group"],
                                             separators=(",", ":")),
              compute_s=f"{r['compute_seconds']:.6f}",
              memory_s=f"{r['memory_seconds']:.6f}",
              collective_s=f"{r['collective_seconds']:.6f}",
              dominant=r["dominant"], mfu_at_bound=f"{r['mfu_at_bound']:.4f}",
              argument_gb=f"{r['memory_stats']['argument_bytes'] / 1e9:.3f}",
              temp_gb=f"{r['memory_stats']['temp_bytes'] / 1e9:.3f}")
    if problems:
        raise PhaseError("mesh (b): " + "; ".join(problems))
    phase("mesh_total", seconds=f"{time.perf_counter() - t_phase:.3f}")


# ---------------------------------------------------------------------------
# Phase 6f: the cost model and roofline
# ---------------------------------------------------------------------------

def _roofline_cell(arch: str, shape_name: str, shape=None,
                   num_microbatches=None) -> dict:
    """One cell's roofline on fake CUDA tensors (a worker process)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import analyze
    from repro_torch.launch.specs import build_cell

    t0 = time.perf_counter()
    cell = build_cell(get_config(arch), shape_name, shape=shape,
                      num_microbatches=num_microbatches)
    r = analyze(cell)
    out = r.to_dict()
    out["bound_seconds"] = r.bound_seconds
    out["param_bytes"] = (sum(p.numel() * p.element_size()
                              for p in cell.arg_specs[0].values())
                          if cell.kind != "train" else None)
    out["trace_s"] = time.perf_counter() - t0
    return out


def _roofline_mm(dtype_name: str, n: int) -> None:
    """(a) one ``n``-cube product on the card under the cost mode."""
    import torch

    from repro_torch.launch.graph_cost import CostMode
    from repro_torch.launch.roofline import PEAK_FLOPS

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((n, n), generator=gen, device="cuda").to(dtype)
    b = torch.randn((n, n), generator=gen, device="cuda").to(dtype)
    mode = CostMode()
    with mode:
        a @ b
    flops, nbytes = 2.0 * n ** 3, 3.0 * n * n * a.element_size()
    cost = mode.cost
    if (cost.flops, cost.mem_bytes, cost.flops_by_dtype) != (
            flops, nbytes, {dtype_name: flops}):
        raise PhaseError(f"roofline a: {dtype_name} mm counted {cost}, "
                         f"expected {flops} FLOPs, {nbytes} bytes")
    ms = _time_ms(lambda: a @ b, reps=20, warmup=3)
    phase("roofline", case="a", dtype=dtype_name, n=n, flops=cost.flops,
          bytes=cost.mem_bytes, ms=f"{ms:.6f}",
          tflops=f"{flops / ms / 1e9:.2f}",
          peak_tflops=f"{PEAK_FLOPS[dtype_name] / 1e12:.0f}")


def run_roofline(serve_ms, train_ms) -> None:
    """Phase 6f: (a) a bf16 and an f32 product on the card, counted as
    the analytic FLOPs and bytes; (b) the cells phases ``serve`` and
    ``train`` time (stablelm-12b's decode step at the launcher's 4 slots
    and ``max_len`` 256; granite's remat train step, 8 x 1024 tokens in
    2 microbatches): FLOPs, bytes, bound and the measured share of the
    bf16 peak; the decode cell's bytes at least its parameters'.  The
    two cells trace in two processes on fake tensors."""
    import multiprocessing

    from repro_torch.launch.roofline import PEAK_BF16
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    _roofline_mm("bfloat16", 8192)
    _roofline_mm("float32", 4096)

    args = serve.parse_args(SERVE_ARGS)
    timed = {
        "serve": (args.arch, "serve_decode",
                  dict(kind="decode", seq_len=serve.MAX_LEN,
                       global_batch=args.slots), None, serve_ms),
        "train": (TRAIN, "train_8x1024",
                  dict(kind="train", seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH), TRAIN_MICRO, train_ms),
    }
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(timed), mp_context=ctx) as pool:
        futs_b = {name: pool.submit(_roofline_cell, arch, sname, shape, nm)
                  for name, (arch, sname, shape, nm, _) in timed.items()}
        for name, fut in futs_b.items():
            r, ms = fut.result(), timed[name][4]
            if name == "serve" and r["bytes_per_device"] < r["param_bytes"]:
                raise PhaseError(
                    f"roofline b: the decode cell moves "
                    f"{r['bytes_per_device']} bytes, fewer than its "
                    f"{r['param_bytes']} parameter bytes")
            share = r["model_flops"] / (ms / 1e3 * PEAK_BF16)
            phase("roofline", case="b", arch=r["arch"], shape=r["shape"],
                  flops=r["flops_per_device"],
                  flops_by_dtype=json.dumps(r["flops_by_dtype"],
                                            separators=(",", ":")),
                  bytes=r["bytes_per_device"], param_bytes=r["param_bytes"],
                  model_flops=r["model_flops"],
                  bound_ms=f"{r['bound_seconds'] * 1e3:.3f}",
                  dominant=r["dominant"],
                  measured_ms=f"{ms:.3f}",
                  mfu_measured=f"{share:.6f}",
                  mfu_at_bound=f"{r['mfu_at_bound']:.6f}",
                  trace_s=f"{r['trace_s']:.2f}")
    phase("roofline_total", seconds=f"{time.perf_counter() - t_phase:.3f}")


# ---------------------------------------------------------------------------
# Phase 7: timing at the main path's shapes
# ---------------------------------------------------------------------------

def _time_ms(fn, reps: int = 300, warmup: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, calls: int = 50, replays: int = 10) -> float:
    """Per-call device time with the host taken out: ``calls`` calls of
    ``fn`` captured in one CUDA graph, its replays timed with CUDA events.
    A ctypes launch on the current stream is captured like any other."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def queue_cases(final_queue, lookaheads) -> list:
    """The queue kernels at PHOLD's shapes, on the run's final front
    tier: ``(name, Pallas line, kernel, plain, bytes, operations)`` each
    (``scripts/torch_attention_ab.py`` times the same calls)."""
    import torch

    from repro_torch.kernels import queue_front as qf

    q = final_queue
    F, W = q.f_args.shape
    k = 4
    out = []

    # window_extract on the run's final front tier.
    w_in = [q.f_times, q.f_types, q.f_args, q.f_seqs, lookaheads]
    w_out = qf.window_extract_cuda(*w_in, None, k=k)
    ops = k * k + k * 4                      # cummin + take rule compares
    out.append(("window_extract", 130,
                lambda: qf.window_extract_cuda(*w_in, None, k=k),
                lambda: qf.window_extract_plain(*w_in, None, k=k),
                _nbytes(w_in) + _nbytes(w_out), ops))

    # front_merge of one PHOLD emit block (R = max_batch_len rows) bound
    # for that front: times inside the front's span, fresh seqs.
    R = 4
    dev = q.f_times.device
    t_r = q.f_times[:R] + torch.tensor([1.0, 1.5, 2.0, 4.5], device=dev)
    m_in = [q.f_times, q.f_types, q.f_args, q.f_seqs, q.front_n,
            t_r.contiguous(), torch.zeros(R, dtype=torch.int32, device=dev),
            torch.zeros((R, W), device=dev),
            q.next_seq + torch.arange(R, dtype=torch.int32, device=dev),
            torch.ones(R, dtype=torch.bool, device=dev)]
    m_out = qf.front_merge_cuda(*m_in)
    ops = 5 * R * R + R * F + 2 * (F + R) * R  # rank, insertion, rebuild
    out.append(("front_merge", 249,
                lambda: qf.front_merge_cuda(*m_in),
                lambda: qf.front_merge_plain(*m_in),
                _nbytes(m_in) + _nbytes(m_out), ops))
    return out


def launch_floor_ms() -> float:
    """The device time of the least kernel: a one-element ``fill_``,
    captured and timed as :func:`_device_ms` times every kernel."""
    import torch

    x = torch.empty(1, device="cuda")
    return _device_ms(lambda: x.fill_(1.0))


def mode_cases(final_queue, lookaheads) -> list:
    """The queue kernels' spill and stream modes on the same front:
    ``(kernel, mode, call)``.  The fence sits at the third candidate;
    the lex rows tie the front's first times with older seqs, 4 of them
    (an emit block's width) and 256 (an absorb chunk)."""
    import torch

    from repro_torch.kernels import queue_front as qf

    q = final_queue
    F, W = q.f_args.shape
    dev = q.f_times.device
    w_in = [q.f_times, q.f_types, q.f_args, q.f_seqs, lookaheads]
    bound = (q.f_times[2].clone(), q.f_seqs[2].clone())
    out = [("window_extract", "fenced",
            lambda: qf.window_extract_cuda(*w_in, None, k=4, bound=bound))]
    for R in (4, 256):
        t_r = q.f_times[:R] if R <= F else q.f_times
        t_r = torch.where(torch.isfinite(t_r), t_r, 1.0).contiguous()
        m_in = [q.f_times, q.f_types, q.f_args, q.f_seqs, q.front_n, t_r,
                torch.zeros(R, dtype=torch.int32, device=dev),
                torch.zeros((R, W), device=dev),
                (q.f_seqs[:R] - 1).contiguous(),
                torch.ones(R, dtype=torch.bool, device=dev)]
        out.append(("front_merge", f"lex_R{R}",
                    lambda m_in=m_in: qf.front_merge_cuda(*m_in, lex=True)))
    return out


def time_kernels(final_queue, lookaheads, launches, errs) -> list:
    F = final_queue.f_args.shape[0]
    floor_ms = launch_floor_ms()
    out = []
    for name, line, kernel, plain, nbytes, ops in queue_cases(final_queue,
                                                              lookaheads):
        ms = _time_ms(kernel)
        device_ms = _device_ms(kernel)
        plain_ms = _time_ms(plain)
        rec = _record(name, "src/repro_torch/csrc/queue_front.cu",
                      f"src/repro/kernels/queue_front.py:{line}",
                      launches[name], errs[name], ms, device_ms, plain_ms,
                      nbytes, ops, F32_OPS_PER_S, None, None)
        rec["launch_floor_ms"] = floor_ms
        out.append(rec)
        phase("timing", kernel=name, F=F, bytes=nbytes, ops=ops,
              ms=f"{ms:.6f}", device_ms=f"{device_ms:.6f}",
              launch_floor_ms=f"{floor_ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", bound_ms=f"{rec['bound_ms']:.9f}")
    by_name = {rec["name"]: rec for rec in out}
    for name, mode, kernel in mode_cases(final_queue, lookaheads):
        ms = _time_ms(kernel)
        device_ms = _device_ms(kernel)
        by_name[name][f"{mode}_device_ms"] = device_ms
        phase("timing", kernel=name, mode=mode, F=F, ms=f"{ms:.6f}",
              device_ms=f"{device_ms:.6f}")
    return out


def _record(name, source, replaces, launches, err, ms, device_ms, plain_ms,
            nbytes, ops, ops_per_s, library_ms, library_device_ms, exps=0):
    """One kernel's JSON record.  ``ms`` is a wrapper call timed back to
    back, ``device_ms`` the same call with the host taken out
    (:func:`_device_ms`); ``library_*`` the same for one PyTorch call of
    the same function, where there is one.  The bound is the largest of
    three times: the bytes over the memory rate, the operations over
    ``ops_per_s`` and the ``exps`` over the special-function units
    (``SFU_OPS_PER_S``); ``bound_by`` is "bytes" or "operations", and
    ``bound_op`` names the operations' kind ("f32" or "exp") when they
    win."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "f32": ops / ops_per_s * 1e3,
             "exp": exps / SFU_OPS_PER_S * 1e3}
    top = max(terms, key=terms.get)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": err,
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "bound_ms": terms[top],
        "bound_by": "bytes" if top == "bytes" else "operations",
        "bound_op": None if top == "bytes" else top,
        "library_ms": library_ms, "library_device_ms": library_device_ms,
    }


def time_attention(launches, errs, hubert_launches, mla_launches) -> list:
    """Each attention kernel, its plain version and one
    ``scaled_dot_product_attention`` call at the serving path's shapes
    (bf16, H 32, KV 8, head_dim 160).  Returns the JSON records at the
    main path's own shapes (the prompt bucket T = S = 32; B = 4 slots,
    S = max_len 256; hubert's forward: H 16, head_dim 80, T = S =
    ``HUBERT_T``, bidirectional; deepseek's MLA prefill: H = KV = 16, qk
    head dim 192, v zero-padded from 128, the bucket T = S = 32); flash
    at T = S = 2048, and MLA's at T 16 and 2048, are printed beside
    them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16 = torch.bfloat16
    src = "src/repro_torch/csrc/attention.cu"
    out = []
    for T, H, KV, D, causal, reps, calls in (
            (32, 32, 8, 160, True, 300, 50), (2048, 32, 8, 160, True, 20, 10),
            (HUBERT_T, 16, 16, 80, False, 100, 20),
            (16, 16, 16, 192, True, 300, 50), (32, 16, 16, 192, True, 300, 50),
            (2048, 16, 16, 192, True, 20, 10)):
        B = 1
        q = _randn(gen, (B, T, H, D), bf16).transpose(1, 2)
        k = _randn(gen, (B, T, KV, D), bf16).transpose(1, 2)
        v = _randn(gen, (B, T, KV, D), bf16).transpose(1, 2)
        mla = D == 192
        if mla:                 # MLA's v, zero past its 128 columns
            v[..., MLA_V_DIM:] = 0
        # The library takes MLA's v at its own 128 columns.
        v_lib = v[..., :MLA_V_DIM].contiguous() if mla else v
        o = fa.flash_attention_cuda(q, k, v, causal=causal)

        def kernel():
            return fa.flash_attention_cuda(q, k, v, causal=causal)

        def library():
            return F.scaled_dot_product_attention(
                q, k, v_lib, is_causal=causal, enable_gqa=H != KV)

        ms = _time_ms(kernel, reps)
        device_ms = _device_ms(kernel, calls)
        plain_ms = _time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal), reps)
        lib_ms = _time_ms(library, reps)
        lib_device_ms = _device_ms(library, calls)
        # QK^T and PV over the keys each query sees
        pairs = T * (T + 1) // 2 if causal else T * T
        if mla:
            # The function's own work, not the padding: q at qk dim 192,
            # k's 128 nope columns a head plus ONE shared 64-wide rope
            # key, v and o at 128; QK^T at 192 and PV at 128.
            nope = D - MLA_ROPE_DIM
            nbytes = B * T * q.element_size() * (
                H * D + KV * nope + MLA_ROPE_DIM + 2 * H * MLA_V_DIM)
            ops = 2 * (D + MLA_V_DIM) * H * B * pairs
        else:
            nbytes = _nbytes([q, k, v, o])
            ops = 4 * D * H * B * pairs
        count = (launches if H == 32 else mla_launches if mla
                 else hubert_launches)["flash_attention"]
        rec = _record("flash_attention", src,
                      "src/repro/kernels/flash_attention.py:108", count,
                      errs["flash_attention"], ms, device_ms, plain_ms,
                      nbytes, ops, BF16_OPS_PER_S, lib_ms, lib_device_ms)
        phase("timing", kernel="flash_attention", T=T, S=T, H=H, KV=KV,
              D=D, mla=mla, causal=causal, bytes=nbytes, ops=ops,
              ms=f"{ms:.6f}",
              device_ms=f"{device_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
              library_ms=f"{lib_ms:.6f}",
              library_device_ms=f"{lib_device_ms:.6f}",
              bound_ms=f"{rec['bound_ms']:.9f}", bound_by=rec["bound_by"])
        if mla and T == 32:
            rec["shape"] = (f"deepseek MLA prefill B{B} H{H} T{T} D{D} "
                            f"(v {MLA_V_DIM} zero-padded) causal bf16")
            out.append(rec)
        elif T == 32 and H == 32:
            out.append(rec)
        elif H == 16 and not mla:
            rec["shape"] = f"hubert B{B} H{H} T{T} D{D} bidirectional bf16"
            out.append(rec)

    # stablelm-12b's decode (the record) and jamba's head layout.
    for B, H, KV, S, D in ((4, 32, 8, 256, 160), (4, 64, 8, 256, 128)):
        lengths = (1, 31, 200, 256)
        q = _randn(gen, (B, H, D), bf16)
        kc = _randn(gen, (B, S, KV, D), bf16).transpose(1, 2)
        vc = _randn(gen, (B, S, KV, D), bf16).transpose(1, 2)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        mask = (torch.arange(S, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]          # [B,1,1,S]
        o = da.decode_attention_cuda(q, kc, vc, lens)

        def kernel():
            return da.decode_attention_cuda(q, kc, vc, lens)

        def library():
            return F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)

        ms = _time_ms(kernel)
        device_ms = _device_ms(kernel)
        plain_ms = _time_ms(
            lambda: da.decode_attention_plain(q, kc, vc, lens))
        lib_ms = _time_ms(library)
        lib_device_ms = _device_ms(library)
        keys = sum(min(n, S) for n in lengths)     # cache rows actually read
        nbytes = (_nbytes([q, o, lens])
                  + 2 * keys * KV * D * kc.element_size())
        ops = 4 * D * H * keys
        rec = _record("decode_attention", src,
                      "src/repro/kernels/decode_attention.py:112",
                      launches["decode_attention"], errs["decode_attention"],
                      ms, device_ms, plain_ms, nbytes, ops, BF16_OPS_PER_S,
                      lib_ms, lib_device_ms)
        phase("timing", kernel="decode_attention", B=B, S=S, H=H, KV=KV,
              D=D, lengths=json.dumps(list(lengths)),
              splits=da.choose_splits(B, KV, S, da.sm_count(q.device))[0],
              bytes=nbytes, ops=ops, ms=f"{ms:.6f}",
              device_ms=f"{device_ms:.6f}", plain_ms=f"{plain_ms:.6f}",
              library_ms=f"{lib_ms:.6f}",
              library_device_ms=f"{lib_device_ms:.6f}",
              bound_ms=f"{rec['bound_ms']:.9f}", bound_by=rec["bound_by"])
        if H == 32:
            out.append(rec)
    return out


def time_rwkv(launches, errs) -> list:
    """``rwkv6_scan`` and its plain version at the serving prefill's
    shape (B 1, H 32, K 64, T 16: the longest prompt, f32 views of the
    model's streams) and at T 2048; no PyTorch call computes the scan."""
    import torch

    from repro_torch.kernels import rwkv6_scan as rs

    gen = torch.Generator(device="cuda").manual_seed(8)
    out = []
    for T, reps, plain_reps, calls in ((16, 300, 20, 50), (2048, 20, 3, 10)):
        B, H, K = 1, 32, 64
        xs = rwkv_inputs(gen, B, H, T, K, torch.float32)
        y, S = rs.rwkv6_scan_cuda(*xs)
        ms = _time_ms(lambda: rs.rwkv6_scan_cuda(*xs), reps)
        device_ms = _device_ms(lambda: rs.rwkv6_scan_cuda(*xs), calls)
        plain_ms = _time_ms(lambda: rs.rwkv6_scan_plain(*xs), plain_reps,
                            warmup=1)
        nbytes = _nbytes(xs) + _nbytes([y, S])
        ops = B * H * T * (5 * K * K + 4 * K)   # kv, r.S, decay, bonus, exp
        exps = B * H * T * K                    # w = exp(log w)
        rec = _record("rwkv6_scan", "src/repro_torch/csrc/rwkv6_scan.cu",
                      "src/repro/kernels/rwkv6_scan.py:92",
                      launches["rwkv6_scan"], errs["rwkv6_scan"], ms,
                      device_ms, plain_ms, nbytes, ops, F32_OPS_PER_S, None,
                      None, exps)
        rec["shape"] = f"B{B} H{H} T{T} K{K} f32"
        phase("timing", kernel="rwkv6_scan", B=B, H=H, T=T, K=K,
              bytes=nbytes, ops=ops, ms=f"{ms:.6f}",
              device_ms=f"{device_ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", bound_ms=f"{rec['bound_ms']:.9f}",
              bound_by=rec["bound_by"], bound_op=rec["bound_op"],
              exp_sfu_ms=f"{exps / SFU_OPS_PER_S * 1e3:.9f}")
        out.append(rec)
    return out


def time_mamba(launches, errs) -> list:
    """``mamba_scan`` and its plain version at the serving prefill's shape
    (B 1, T 16: the longest prompt, I 16384, N 16, f32, B_t/C_t as slices
    of the ``x_proj`` output) and at T 2048; no PyTorch call computes the
    scan.  The bound counts each operand's own elements once (the slices'
    N columns, not the whole projection rows)."""
    import torch

    from repro_torch.kernels import mamba_scan as ms

    gen = torch.Generator(device="cuda").manual_seed(9)
    out = []
    for T, reps, plain_reps, calls in ((16, 300, 20, 50), (2048, 20, 3, 10)):
        B, I, N = 1, 16384, 16
        xs = mamba_inputs(gen, B, T, I, N, torch.float32)
        y, h = ms.mamba_scan_cuda(*xs)
        ms_ = _time_ms(lambda: ms.mamba_scan_cuda(*xs), reps)
        device_ms = _device_ms(lambda: ms.mamba_scan_cuda(*xs), calls)
        plain_ms = _time_ms(lambda: ms.mamba_scan_plain(*xs), plain_reps,
                            warmup=1)
        nbytes = sum(x.numel() * x.element_size() for x in xs) + \
            _nbytes([y, h])
        exps = B * T * I * N
        ops = 7 * exps          # dt*A, exp, decay*h + x*B, C*h summed
        rec = _record("mamba_scan", "src/repro_torch/csrc/mamba_scan.cu",
                      "src/repro/kernels/mamba_scan.py:87",
                      launches["mamba_scan"], errs["mamba_scan"], ms_,
                      device_ms, plain_ms, nbytes, ops, F32_OPS_PER_S, None,
                      None, exps)
        rec["shape"] = f"B{B} T{T} I{I} N{N} f32"
        phase("timing", kernel="mamba_scan", B=B, T=T, I=I, N=N,
              bytes=nbytes, ops=ops, exps=exps, ms=f"{ms_:.6f}",
              device_ms=f"{device_ms:.6f}",
              plain_ms=f"{plain_ms:.6f}", bound_ms=f"{rec['bound_ms']:.9f}",
              bound_by=rec["bound_by"], bound_op=rec["bound_op"],
              exp_sfu_ms=f"{exps / SFU_OPS_PER_S * 1e3:.9f}")
        out.append(rec)
    return out


# The sources the engine's phases need; the others (``attention.cu``
# alone takes about a minute) finish building while those phases run.
ENGINE_SOURCES = ("queue_front", "graph_cond")


class Builds:
    """Every CUDA source compiled at once, one ``nvcc`` each, in threads:
    :meth:`wait` blocks until the named sources are built."""

    def __init__(self):
        from repro_torch.kernels import _build

        self.t0 = time.perf_counter()
        self.pool = concurrent.futures.ThreadPoolExecutor(
            len(_build.SOURCES))
        self.futures = {name: self.pool.submit(self._build, name)
                        for name in _build.SOURCES}
        self.reported: set = set()

    def _build(self, name: str) -> float:
        from repro_torch.kernels import _build

        _build.build(name)
        return time.perf_counter() - self.t0

    def wait(self, names) -> float:
        """Seconds from the start until the last of ``names`` was built;
        prints their ptxas reports."""
        from repro_torch.kernels import _build

        seconds = max(self.futures[name].result() for name in names)
        for name in names:
            if name in self.reported:
                continue
            self.reported.add(name)
            for line in _build.BUILD_LOG.get(name, "").splitlines():
                if ("registers" in line or "Compiling entry" in line
                        or "spill" in line or "smem" in line):
                    print(f"  ptxas[{name}]: {line.strip()}")
        return seconds


def build_all() -> float:
    """Compile every CUDA source at once (one nvcc each); returns the
    wall seconds and prints each source's ptxas report."""
    from repro_torch.kernels import _build

    builds = Builds()
    seconds = builds.wait(_build.SOURCES)
    builds.pool.shutdown()
    return seconds


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        children = start_dryrun_cells(tmp)
        host_child = start_wireless_host(tmp)
        try:
            return run_phases(card, children, host_child)
        finally:
            stop_children(children + [host_child])


def run_phases(card: str, children: list, host_child: dict) -> int:
    """Every phase after the checks of :func:`main`; the dry-run cells
    of phase mesh (b) run in ``children`` meanwhile, and phase wireless's
    compiled host run in ``host_child``."""
    import torch

    from repro_torch.kernels import _build

    builds = Builds()
    build_s = builds.wait(ENGINE_SOURCES)
    phase("build", sources=",".join(ENGINE_SOURCES),
          seconds=f"{build_s:.2f}", card=json.dumps(card),
          torch=torch.__version__, cuda=torch.version.cuda)
    # f32 products in full f32: the plain versions are the yardstick.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = check_kernels(torch.device("cuda"))
    res, launches, ref, counts, phold_loop_s = run_phold("cuda")
    run_phold_fused("cuda", res, ref, counts)
    del ref
    build_s = builds.wait(_build.SOURCES)
    builds.pool.shutdown()
    phase("build", sources=",".join(_build.SOURCES),
          seconds=f"{build_s:.2f}")
    attn_errs = check_attention()
    rwkv_errs = check_rwkv()
    mamba_errs = check_mamba()
    poc_runs = run_poc("cuda")
    poc_switch = poc_runs["switch"]
    mmc_runs = run_mmc("cuda")
    admit = run_serving_admission("cuda")
    captured_sim = run_captured("cuda", res, counts, phold_loop_s, poc_runs,
                                mmc_runs)
    del poc_runs, mmc_runs
    run_overflow("cuda", res, phold_loop_s, counts)
    run_resume("cuda", res, phold_loop_s, counts)
    run_faults("cuda")
    stream_a = run_stream("cuda")
    run_host("cuda", poc_switch, stream_a)
    run_analysis("cuda", poc_switch, admit)
    run_wireless("cuda", host_child)
    del poc_switch
    t0 = time.perf_counter()
    base, base_counts = run_queue_modes("cuda", res, counts)
    phase("queue_modes_total", seconds=f"{time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    serial = run_sharded("cuda", base, base_counts, phold_hot_words(res),
                         admit, stream_a)
    phase("sharded_total", seconds=f"{time.perf_counter() - t0:.3f}")
    run_stacked("cuda")
    run_devices(base, base_counts, serial, phold_hot_words(res))
    del base, admit, stream_a
    gc.collect()
    attn_launches, serve_ms = run_serve()
    rwkv_launches = run_serve_rwkv()
    jamba_launches = run_serve_jamba()
    mla_launches = run_serve_deepseek()
    run_vlm()
    t0 = time.perf_counter()
    hubert_launches = run_hubert()
    phase("hubert_total", seconds=f"{time.perf_counter() - t0:.3f}")
    train_ms = run_train()
    run_roofline(serve_ms, train_ms)
    run_mesh(children)
    lookaheads = torch.tensor([1.0], device="cuda")
    kernels = time_kernels(res.raw["final_queue"], lookaheads, launches,
                           errs)
    kernels += time_attention(attn_launches, attn_errs, hubert_launches,
                              mla_launches)
    kernels += time_rwkv(rwkv_launches, rwkv_errs)
    kernels += time_mamba(jamba_launches, mamba_errs)
    profile_captured(captured_sim)

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        sys.exit(1)
