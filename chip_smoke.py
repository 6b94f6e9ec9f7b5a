#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of TeShu on one NVIDIA card.

    python3 chip_smoke.py                    # the smoke run (one card)
    python3 chip_smoke.py --meta-counts F    # no card: the dry run's four
                                             # steps counted on meta into F
    python3 chip_smoke.py --profile DIR      # also trace one hit per template,
                                             # and the prefill and 4 decode
                                             # steps of each served model
                                             # (Hymba's Mamba heads,
                                             # xLSTM's mixers and MLA's
                                             # two forms apart), and one
                                             # step of each trained model

Run from the root of a checkout.  It needs a CUDA device: without one it
exits non-zero and prints no result.  In order it

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the seven CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and prints the build seconds,
   then takes every torch.profiler trace that the checks below read, back
   to back before anything else, each session open 50 ms before and after
   its call (a session long after the one before it may hold no device
   event);
3. holds each kernel against its plain PyTorch version on the card at its
   main path's shapes (and the attention kernels at their edge cases and at
   one ``decode_32k`` layer, each element within its own bound of the plain
   value; two planted faults, a dropped kv tile and a dropped decode split,
   must fall outside it), and times kernel, plain version and the
   one-call library yardstick (``index_add_``, or
   ``scaled_dot_product_attention`` for the attention kernels) with CUDA
   events (median of several launches).  The flash library's SASS must
   hold ``HGMMA`` and ``UTMALDG`` instructions, and each flash case logs
   which of the library's three kernels it ran (read from a torch.profiler
   trace of the call; bf16 at head width 64 or 128 must run
   ``flash_wgmma``); the Qwen2.5-14B and the Qwen3-MoE prefill shapes, and
   those of the five dense models of 6c, are timed beside SDPA.  Sliding
   windows (Hymba-1.5B's 1,024 at its prefill of 4,096 tokens, an appended
   prefill of 2,048 on 2,048, windows of 1 and off the tiles,
   ``flash_mma`` at D 32) are held the same way; a window of
   Skv or more must give the unwindowed output bit for bit, and the kernel
   run with its window one 128-row tile wider must fail the check; the
   Hymba prefill is timed windowed, unwindowed on the same inputs, and
   beside SDPA with the window's boolean mask.  The decode library's SASS
   must hold ``UTMALDG``;
   each decode case logs the device kernels one call launched (bf16 at
   head width 64 or 128 must launch ``decode_tma`` alone), a ``valid_len``
   passed as a device tensor must give the int's output bit for bit, and
   the Qwen2.5-14B and Qwen3-MoE decode steps, those of 6c's models and
   one ``decode_32k`` layer are timed (beside SDPA where it fits), with the
   host's microseconds per call.  Hymba's decode step (25 q / 5 kv heads of
   64, 4,128 valid positions, window 1,024) is held on ``decode_tma``
   (with ``valid_len`` on the device too), with a window past
   ``valid_len``, and on ``decode_split``; the window one 64-position tile wider must fail, and
   the step is timed windowed, unwindowed and beside SDPA on the window's
   slice of the cache.  The pieces of a GQA layer split over ``model`` by
   positions (its heads do not divide ``model``; the card's one rank never
   splits, so the split itself is held on the CPU over gloo ranks): the
   decode kernel's log-sum-exp route on both kernels (its float32 output
   and its ``lse``) against the plain version at the Qwen2.5-14B and the
   windowed Hymba decode shapes, with the LSE in base 2 as a control;
   each of those caches cut into the 16 blocks of ``T`` that model 16
   gives its ranks, each block decoded on that route (an empty block
   returns zeros and ``-inf`` with no launch) and the blocks merged by
   their LSE, held to one whole launch, with the base-2 LSE as a control
   that must fail, and timed beside it; and the dense prefill's query rows
   cut as ``shardings.position_blocks`` cuts them over 16 ranks, each
   block through flash over the key rows up to its end, held to the whole
   launch and timed beside it.  The KV-replication layers' caches split
   ``T`` alike (their kv heads are fewer than ``model``'s ranks): the LSE
   route and the 16-block split at the Qwen3-MoE decode shape (64 q / 4
   kv heads, a group of 16) and Granite's MQA (48 q heads over one, a
   group of 48, ``decode_tma``'s limit); and MLA's latent cache split by
   ``T``: the plain block decode (``layers.mla_block_decode``) over 16
   blocks of DeepSeek-V2's width, merged by their LSE, held to one whole
   ``mla_absorbed_decode``, with a plain mean of the blocks as the control
   that must fail.  The ordered fold is held bit for bit (NaN = NaN) to its plain
   version for sum, min and max on segments of 1..64 rows, and for sum on
   the global stage's own Zipf layout (one segment of 263,532 rows; the
   plain version runs on a CPU copy); two adjacent rows of that segment
   swapped must fail the check; the fold library's SASS must hold
   ``UBLKCP.S.G`` (bulk copies) and a profiler trace of a call one device
   kernel; both layouts are timed.  PART's permutation is held bit for bit
   (a control whose one output row gathers its source row's neighbour must
   fail) and timed beside ``index_copy_`` and ``index_add_``; COMB on the
   global stage's sorted ids and on the same ids in a random row order is
   held within the float32 summation bound (a control that drops the
   partial sum of a segment crossing a tile boundary must fail), and its
   library's SASS must hold ``UBLKCP.S.G`` and ``REDG.E.ADD.F32x4`` (a
   vector reduction); the fold's profiler trace also holds a call each of
   PART and COMB, and must name PART's two kernels and COMB's one;
   the sLSTM recurrence (``slstm_scan``, one cooperative launch, which a
   profiler trace must show as one device kernel) is held per element
   within ``ref.slstm_tolerance`` (hs and the final state) at xlstm-350m's
   served prefill (B 4, S 4,096, d 1,024, bf16, from a zero state), a
   decode step (S 1, from a random state) and the float32 SMOKE width
   (d 64); the plain loop without the recurrent product at step S/2, and
   the plain loop with the product summed in bf16, must each fail the
   check by 10x, and so must the kernel rebuilt to read the stale half of
   its exchange buffer; two calls must agree bit for bit, and the
   library's SASS must hold ``HMMA`` (the bf16 product on the tensor
   cores); the prefill and the decode step are timed beside the plain
   loop (and the parent's kernel where ``build/parent`` holds a checkout
   of the parent, launched through the C interface its own ``slstm.cu``
   declares; an unknown one raises), with the bytes, operations and chain
   bounds (the chain:
   S one-way trips of a flag between two SMs, from a ping-pong probe),
   the exchange alone (the kernel rebuilt with the step's product
   replaced by nothing) and the host's microseconds per call;
4. counts the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions
   that ``cuobjdump --dump-sass`` finds in the built gmm library (both must
   be there), then holds the grouped-matmul kernel (``gmm``) against its
   plain version at the MoE serving shapes (Qwen3-MoE: 128 experts of d
   4096 x f 1536, the prefill's buffers padded to 384 rows per expert at
   block_n 128, the MoE block's layout, and at block_n 64; a decode
   step's padded to 16; DeepSeek-V2's 160 experts of d 5120 x f 1536 at
   the prefill's 256 rows an expert and a step's 16, and its 2 shared
   experts over the prefill's 4,096 tokens) and at edge cases (shuffled
   and repeated group ids on both of the kernel's paths, groups with no
   tile, block_n 16 /
   32 / 64 / 128 / 256, d and f off the 64 and 128 tiles, float32
   operands), each element within ``ref.gmm_tolerance``; two planted
   faults (one tile reading the next expert's weights, the reduction
   without its last 512 columns of d) must fall outside it by more than
   10x at the prefill and at the decode shape of each model.  Times
   kernel, plain version and ``torch.bmm`` on the capacity layout, with
   the kernel's TFLOP/s and TB/s;
5. drives the shuffle's main path, the cached-plan replay of the shuffle
   service, at the paper-shaped 40-worker deployment: Zipf(0.9) keys over
   1M keys, 200k rows of width 8 per worker (8M rows, 576 MB), SUM on
   ``network_aware`` and ``vanilla_push``: one miss, then hits.  The shuffle
   kernels' launch counters are zeroed just before the hits and read just
   after; outputs are held against the port's own vectorized replay; each
   later path's counters are zeroed just before it and read just after,
   and the ``kernels`` line sums them.  After each path (both slice
   templates, the skewed hits, the batched pass, PageRank, SSSP and
   ``shuffle_cache``) every kernel it launched is called again on the
   inputs of its last call there, so at the path's own shapes (d = 1 in
   PageRank, one member's 2M x 8 slice in the batch), and held against its
   plain version, each with a planted fault that must fail the check;
5a. skew phase: the same deployment with Zipf(1.2) keys (the top key about
   a fifth of the rows) and ``balance="auto"`` on ``vanilla_push``: one
   miss, then 3 hits that must replay on the card with the rebalance
   triggered (the frozen hot-key scatter, the fold, the owner merge), the
   vectorized replay's bytes and charges; the largest per-destination
   received bytes must fall below the same data's with ``balance="off"``;
   ``network_aware`` under the rebalance must replay on the card or decline
   with its plan's skew code;
5b. batch phase: four tenants on one cluster, each with its own Zipf(0.9)
   data (50k rows a worker, 2M a member), warm a plan each, then submit one
   shuffle each into one admission pass: one batch of 4, each member on the
   card with no fallback; one program's folds for the batch (one serial
   replay's); per-tenant byte lanes equal to four serial hits', cost lanes
   to 1e-9, the batch's modelled time strictly below; members within the
   float32 bound of the vectorized replay, and with the kernel plane off
   byte-identical to the serial replays.  The pass's wall is logged beside
   the same pass with each member solo, and each pass's planner, batch
   probe, batched program and plan-key signatures timed apart;
5c. graph phase: ``repro_torch.apps.graph`` on an R-MAT graph at Graph500
   scale 20, edge factor 16 (2^20 vertices, 2^24 edges drawn, self loops
   dropped) over the 40 workers: PageRank, 10 supersteps on
   ``network_aware`` (every cached superstep on the card), within the
   float32 bound carried through the supersteps of a float64 power
   iteration (a control dropping a top vertex's messages of superstep 1
   must fall outside it); SSSP from vertex 0, 8 supersteps, equal to the
   BFS levels cut at 8; then ``repro_torch.launch.shuffle_cache.run`` must
   count 9 hits of 10, every cached replay on the card with no fallback;
6. drives the LM's serving path, ``repro_torch.launch.serve.serve`` on
   Qwen2.5-14B at full width and depth (48 layers, bf16, random weights made
   on the card from a seeded ``torch.Generator``): batch 4, 1,024-token
   prompts, 32 greedy tokens.  Every launch counter is zeroed just before
   and read just after: the prefill must launch the flash kernel once per
   layer and every decode step the decode kernel once per layer.  The same
   run with the plain versions, teacher-forced on the kernel run's tokens,
   is the yardstick for its logits, and three control runs with faulty
   plain attention (S and P rounded to bf16; the decode dropping its newest
   32 positions, which must fail the logit check; the prefill's causal
   diagonal one column late, which must fail it at step 0) show how far a
   wrong attention moves them;
6c. (right after 6) drives ``serve`` the same way (``dense_serve_phase``:
   the same traffic, counts, yardstick, checks and the last two controls)
   on the five other dense models at full width (``DENSE_SERVE``):
   Granite-34B whole (88 layers, 48 q heads over one kv head, the GELU
   MLP; 67.92 GB), Pixtral-12B whole (40, RoPE at 1e9), MusicGen-large
   whole (48, 32 heads of 64), Llama-3-405B at 8 of 126 layers and
   Qwen1.5-110B at 20 of 80 (QKV biases), each made on the card from the
   seed and freed before the next.  Pixtral and MusicGen are then served
   from their stub frontends' embeddings of the prompts (1,024 patches of
   16 x 16 x 3, or 4 codebooks over 1,024 frames, drawn on the card): a
   prefill from the embeddings into a fresh cache, then 32 greedy steps
   from tokens, held to their plain run with the same counts, check and
   decode control.  Each logs its weights, prefill s, decode step ms,
   tokens/s, peaks, launches, the logit differences a step, the bound and
   each control's factor over it;
6a. drives ``serve`` on Hymba-1.5B at full width and depth (32 layers, 29
   with a sliding window of 1,024, every layer's attention beside a Mamba
   head whose scan runs as torch ops): batch 4, 4,096-token prompts, 32
   greedy tokens in a cache of 4,160.  The counters are zeroed just before
   and read just after: flash once a layer in the prefill, decode once a
   layer a step.  The plain versions' run, teacher-forced on the kernel
   run's tokens, is the yardstick (10 bf16 steps, the first-token tie
   rule); the same plain run with the window off in the 29 windowed layers
   must fail it.  The prompts are then prefilled again in two chunks of
   2,048 on one cache: each chunk launches flash once a layer and none
   reaches the fused plain attention, and the last logits are held to the
   plain versions' same two chunks.  With ``--profile``, the prefill and 4
   decode steps are traced, with the Mamba heads' ``hymba.mamba`` ranges;
6b. drives ``serve`` on xlstm-350m at full width and depth (24 layers,
   d_model 1,024, sLSTM in layers 7, 15 and 23, mLSTM elsewhere): batch 4,
   4,096-token prompts, 32 greedy tokens.  The counters are zeroed just
   before and read just after: ``slstm_scan`` once an sLSTM layer in the
   prefill and in every decode step (99), every other kernel never.  The
   plain versions' run, teacher-forced, is the yardstick (10 bf16 steps,
   the first-token tie rule); the plain run with ``h @ w_rec`` dropped in
   the three sLSTM layers must fail it.  The prompts are then prefilled
   again in two chunks of 2,048 on one cache (the sLSTM kernel once a layer
   a chunk), held to the plain versions' two chunks at the last logits and
   the second chunk's first 64 positions (20 bf16 steps: the largest over
   64 positions; the kernels' second chunk from a zero sLSTM state must
   fail it), and the same again on weights and prompts from two more
   seeds.  With ``--profile``, the prefill
   and 4 decode steps are traced with the ``xlstm.mlstm`` and
   ``xlstm.slstm`` ranges;
7. drives the MoE serving path, ``serve`` on Qwen3-MoE-235B-A22B at full
   width with its depth cut to 12 of 94 layers (62.2 GB of bf16 weights,
   every expert drawn on its own from a seeded generator on the card), at
   the dense serve's batch, prompts and length.  The counters are zeroed
   just before and read just after: gmm three times per layer in the
   prefill and in every decode step, flash and decode attention once per
   layer.  The plain versions' run, teacher-forced on the kernel run's
   tokens and routing (each router call's top-8 ids and weights are
   recorded and replayed), is the yardstick for its logits; a control
   whose plain gmm drops the last 512 columns of its reduction must fail
   that check;
7a. drives ``serve`` on DeepSeek-V2-236B the same way, through the same
   function: full width, depth cut to 9 of 60 layers (layer 0 with its
   dense FFN of 12,288, then 8 MoE layers of 160 routed experts top-6 and
   2 shared experts; 33,163,494,400 parameters, 66.33 GB of bf16 weights),
   multi-head latent attention in every layer (tensor ops: the
   materialised form in the prefill, the absorbed form over the latent
   cache in each decode step).  The counters: gmm six times per MoE layer
   in the prefill and in every decode step (routed and shared, 1,584),
   every other kernel never; the same yardstick, control and logged
   numbers, and the card's bytes free at the peak.  Layer 1's MLA is then
   held at full width on bf16 inputs: the absorbed decode against the
   materialised form at the step after a 1,024-position prefill on one
   cache, and the prompt prefilled in two chunks of 512 against one call,
   each within its limit in bf16 steps, with a control (the absorbed
   scores without their rope term; the first chunk's rope keys zeroed)
   that must miss it by 10x;
7m. the mesh (before 7): a NCCL world of one rank on the card (a file
   store under ``build/chip_smoke_mesh``) and ``elastic_mesh(1,
   model_parallel=1)``, the mesh the reference's ``serve`` builds on one
   device (axes ``data``, ``model``; EP axes ``("model",)``).  Every
   ``meshops`` function runs on CUDA tensors over the one-rank groups and
   is held bit for bit to its plain meaning (the exchanges and sums give
   their input back, the compressed ``hier_psum`` the int8 round trip;
   ``quantize_int8`` and ``hash32`` equal the CPU's), and the refusals
   (a CPU tensor on the NCCL mesh, a gloo mesh over the NCCL world, the
   reference's ``OverflowError`` seeds) must raise.  In 7 and 7a, right
   after the gspmd serve, the same weights are served with
   ``serve(mesh=...)`` on the model's own ``teshu2`` dispatch (one EP axis:
   the flat all-to-all through NCCL), teacher-forced with the gspmd run's
   tokens: every launch count equal to the gspmd run's, the collectives a
   MoE layer a forward (two all-to-alls, an all-gather, an all-reduce) and
   the all-to-all bytes equal to the layout's arithmetic, the logits
   within the gspmd check's 10 bf16 steps of the gspmd run's (logged: bit
   for bit or not), and the control with the local expert axis rolled by
   one must miss that by 10x; the prefill seconds and decode ms a step are
   logged beside the gspmd run's, with the peak memory (``--profile``: the
   EP prefill and 4 steps traced, the NCCL kernels a class of their own).
7t. the ``tp`` lines (first on the mesh): Qwen2.5-14B, Hymba-1.5B and
   xLSTM-350M at full width and depth, each with its serve phase's
   weights and prompts, served mesh-free and then with ``serve(mesh=...)``
   on the one-rank mesh, teacher-forced: on ``model`` 1 the
   tensor-parallel leaves (Hymba's Mamba channels, the xLSTM projections
   among them) are whole and no gather of a split product or row-parallel
   sum is issued, so logits and tokens bit for bit, every launch count
   equal (Hymba flash 32 and decode 1,024; xLSTM ``slstm_scan`` 99) and
   the serve loop's token all-gather the only collective; the prefill s
   and decode ms beside the mesh-free run's.
7c. trains over the mesh (the ep train phase, before the group is
   destroyed): Qwen3-MoE at full width, 1 of 94 layers (3,732,418,560
   parameters; bf16 weights, each routed expert drawn on its own), on its
   own ``teshu2`` dispatch over the one-rank NCCL mesh.  (a) One
   microbatch of 4 x 1,024 Markov tokens through ``lm.train_loss`` under
   the mesh (the gradients summed as the step sums them) against the
   gspmd branch without a mesh on the same weights: bit for bit, or each
   parameter within ``GRAD_BOUND`` (logged which); the exchange's backward
   returning zeros and the local expert axis rolled by one must each miss
   the bound by 10x.  (b) Six steps of ``train(mesh=mesh)`` (global batch
   8 x 1,024, ``n_micro`` 2, float32 moments and accumulation, lr 3e-4,
   remat), the kernel counters zeroed just before and read just after
   (flash, decode and gmm 0), losses and gradient norms finite, moments
   nonzero, every tensor moved or a bf16 weight whose steps fall under
   half a bf16 step; the collectives against the layout (per MoE layer
   and microbatch six all-to-alls: the two exchanges forward, again in the
   remat recompute, and their adjoints; one all-gather and its
   reduce-scatter; the aux loss's all-reduce and its adjoint's; per
   microbatch the labels' count, per step the gradient
   sums of ``steps.sum_plan``, the loss and the experts' norm share) and
   their bytes.  (c) The same six steps on the gspmd branch from the same
   weights, restored from a host copy: step seconds (median of steps
   2-6), tokens/s and peak memory of both logged (``--profile``: one
   mesh step's gradients traced, the NCCL device ms).  (d) The SMOKE
   restart under the mesh (6 steps, a checkpoint every 3, a run resumed
   from step 3) within ``RESTART_BOUND``.  About 85 s.  The group is
   destroyed after 7c, and after 7d's DeepSeek-V2;
7d. trains the other families at full width (``family_train_phase``,
   ``FAMILY_TRAIN``): DeepSeek-V2 with 2 of 60 layers (the dense layer 0
   and one MoE layer, 2 shared and 160 routed experts) on its own recipe
   (``steps.recipe_for``: bf16 moments and accumulation, ``n_micro`` 2)
   through ``steps.make_train_step`` without a mesh (the gspmd branch),
   global batch 8 x 1,024, right after 7c on its mesh; after 7b,
   Hymba-1.5B with all 32 layers (4 x 4,096, ``n_micro`` 2) and
   xLSTM-350M with all 24 (21 mLSTM, 3 sLSTM; 4 x 4,096, ``n_micro`` 1)
   through ``train()`` (float32 moments and accumulation); 3 steps each,
   lr 3e-4, seed 0, remat.  (a) The gradient check (``_grad_check``,
   ``FAMILY_CHECK``): DeepSeek-V2's bf16 model against its float32 copy
   on 2 layers and 1 x 512 tokens, both routing the bf16 model's choices,
   within ``FAMILY_BOUNDS`` (the float32 gradients wait on the host);
   Hymba's (2 layers, 1 x 2,048: global layer 0, windowed layer 1) and
   xLSTM's (8 layers, 1 x 1,024: the sLSTM block at 7) float32 copies
   against float64 copies within ``GRAD_BOUND``, their bf16 spread logged
   against ``FAMILY_BOUNDS``; the labels shifted and the family's mixer
   detached (``hybrid.mamba_forward``, ``lm.slstm_forward``,
   ``layers.MLA.forward``) must miss by 10x; DeepSeek-V2 also one
   microbatch's gradients over the one-rank mesh on ``teshu2`` against
   gspmd's, bit for bit or within ``GRAD_BOUND``, the experts rolled
   missing by 10x.  (b) The steps, every kernel counter zeroed just before
   and read just after (all 0), losses and gradient norms finite, every
   moment finite and nonzero, every tensor moved (or the bf16 rule of
   7b), one more microbatch's gradients finite and nonzero.  (c) The
   ``family train phase`` line: step seconds (median of steps 2-3),
   tokens/s, peak memory, the share of 989 TFLOP/s by ``_family_flops``'s
   formula; with ``--profile`` one step's gradients and update traced
   apart (xLSTM's on the device alone);
7b. trains (the training slice): (a) the gradient check at Qwen2.5-14B's
   full width with 2 of 48 layers: the bf16 model and its float32 copy
   (the same weights, cast) each take one microbatch of 2 x 512 Markov
   tokens through ``lm.train_loss`` and backward; the losses, and each
   parameter's gradient by cosine similarity and norm ratio, are held to
   ``GRAD_BOUND`` (set from the same check on the CPU at SMOKE width),
   and two controls (the attention output detached, the labels shifted
   one position) must miss it by 10x; (b) six steps of
   ``repro_torch.launch.train.train`` on Qwen2.5-14B at full width, 8 of
   48 layers (3,759,289,344 parameters; bf16 weights, float32 AdamW
   moments, ``n_micro`` 2 accumulated in float32, global batch 8 x 1,024,
   lr 3e-4, remat), the flash, decode and gmm counters zeroed just before
   and read just after (all must be 0: a training step launches no
   kernel of the port); every loss and gradient norm finite, every
   parameter's moments finite and nonzero, every parameter moved (or, a
   bf16 weight whose steps all fall under half its bf16 step, with
   nonzero moments), then one more microbatch's gradients finite and
   nonzero for every parameter; logged: each step, the step's seconds
   (median of steps 2-6), tokens/s, the AdamW update's seconds timed
   apart, the peak allocated memory and the share of the bf16 dense peak;
   (c) the restart at SMOKE on the card: 6 steps with a checkpoint every
   3 against a run resumed from step 3, losses and final weights within
   ``RESTART_BOUND`` (bit for bit or not is logged); with ``--profile``,
   one step's gradients and its update traced apart, device time by
   kernel class;
8. the dry run (``repro_torch.launch.dryrun``): its processes, started
   together right after the build at the lowest priority and shown no
   card, count the cells of ``DRYRUN_JOBS`` (the served archs at the
   serving shapes but DeepSeek-V2's prefill_32k, and the dense arch's
   train_4k) on meta stand-ins over a fake world of 256 on ``(16, 16)``
   (the log holds ``report.render``'s table; every cell must be ok or
   ``shape_applicable``'s skip) and, on a one-rank meta mesh, five steps
   the script also runs on the card (``DRYRUN_CELLS``: the Qwen2.5-14B
   prefill of 4 x 1,024 and a decode step at 1,025 valid positions, the
   Qwen3-MoE 12-layer and the DeepSeek-V2 9-layer prefills over the
   one-rank mesh, one step of the 8-layer training cell over a one-rank
   NCCL mesh of its own).  Each of
   the five is counted on the card (``OpCounter`` around one call, in its
   phase, after that phase's checks) and timed without the counter: FLOPs
   and bytes must equal the meta counts op for op (but ``ONE_SIDE_OPS``,
   each with its reason), the kernels' reports must match, and the
   measured time must be at least ``COMPUTE_FLOOR`` x the roofline's
   compute term; the memory term and the predicted peak are logged beside
   the measured time and ``max_memory_allocated``; each ``(16, 16)`` cell's
   FLOPs a rank and the model's FLOPs over the ranks' count (``per_rank``);
9. prints the ``dryrun`` JSON line, the ``kernels`` JSON line, then the
   ``ok`` line last.

The card's peaks used for the bounds are NVIDIA's H100 SXM data-sheet
numbers: 3.35 TB/s of HBM3, 989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s float32 and 34 TFLOP/s float64 outside them.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
U32 = 2.0 ** -24                     # float32 unit roundoff

WORKERS = 40                         # datacenter(4, 5, 2): the paper's shape
ROWS_PER_WORKER = 200_000
KEYS = 1_000_000
ALPHA = 0.9
WIDTH = 8
HITS = 3
TEMPLATES = ("network_aware", "vanilla_push")
SKEW_ALPHA = 1.2                     # the skew phase: the top key ~19% of rows
BATCH_TENANTS = 4                    # the batch phase: 4 members of 2M rows
BATCH_ROWS_PER_WORKER = 50_000
GRAPH_SCALE = 20                     # the graph phase: Graph500 scale 20,
GRAPH_EDGE_FACTOR = 16               # edge factor 16 (2^24 edges)
PAGERANK_STEPS = 10
SSSP_STEPS = 8
FOLD_MAX_SEG = 64                    # longest fold segment in the kernel phase

SERVE_ARCH = "qwen2.5-14b"           # the serving slice: full width and depth
SERVE = dict(batch=4, prompt_len=1024, gen_len=32, max_len=2048, seed=0)
L2_BYTES = 50 * 2 ** 20
HEAD_DIM = 128
# the attention kernels against their plain versions: the serving shapes
# (Qwen2.5-14B: 40 q heads over 8 kv heads, batch 4, the prefill's 1,024
# tokens, the last decode step's 1,056 valid positions), edge cases, and
# one layer at the repo's decode_32k shape (batch 128, T = 32,768)
# "sharp scores" multiplies q by 4: scores of std 4, where rounding S to
# bf16 moves the output far more than the flash kernel's rounding of P.
# bf16 q, k and v at D 64 or 128 run flash_wgmma, at D 16 or 32 flash_mma,
# any float32 operand flash_fwd
# The windowed cases (the last column: the sliding window, 0 none) are
# Hymba-1.5B's: 25 q over 5 kv heads of 64, batch 4, window 1,024
FLASH_CASES = [  # name, BHq, BHkv, Sq, Skv, D, causal, q dtype (k, v: bf16), window
    ("serving prefill", 160, 32, 1024, 1024, 128, True, "bfloat16", 0),
    ("Sq off the 64 tile", 40, 8, 1000, 1000, 128, True, "bfloat16", 0),
    ("Sq < Skv", 40, 8, 300, 1024, 128, True, "bfloat16", 0),
    ("non-causal", 40, 8, 512, 1024, 128, False, "bfloat16", 0),
    ("MQA (group = H)", 48, 1, 512, 512, 128, True, "bfloat16", 0),
    ("sharp scores", 40, 8, 1024, 1024, 128, True, "bfloat16", 0),
    ("float32 q, bf16 k/v", 40, 8, 256, 256, 128, True, "float32", 0),
    ("D 64 (Hymba-like: 25 q / 5 kv heads)", 100, 20, 1024, 1024, 64, True,
     "bfloat16", 0),
    ("Sq = Skv = 1,088 (on the 64 tile, off the 128)", 40, 8, 1088, 1088,
     128, True, "bfloat16", 0),
    ("MoE prefill (Qwen3-MoE: 64 q / 4 kv heads)", 256, 16, 1024, 1024, 128,
     True, "bfloat16", 0),
    ("Hymba prefill, window 1,024", 100, 20, 4096, 4096, 64, True,
     "bfloat16", 1024),
    ("appended prefill (2,048 on 2,048), window 1,024", 100, 20, 2048, 4096,
     64, True, "bfloat16", 1024),
    ("window 1", 100, 20, 1000, 1000, 64, True, "bfloat16", 1),
    ("window 1,000 (off the tiles)", 100, 20, 2048, 2048, 64, True,
     "bfloat16", 1000),
    ("window >= Skv", 100, 20, 1000, 1000, 64, True, "bfloat16", 1000),
    ("flash_mma at D 32, window 100", 40, 8, 1024, 1024, 32, True,
     "bfloat16", 100),
    # the prefills of the five dense models the dense serve phases serve
    # (batch 4 x 1,024 tokens)
    ("Granite-34B prefill (48 q / 1 kv head, MQA)", 192, 4, 1024, 1024, 128,
     True, "bfloat16", 0),
    ("Pixtral-12B prefill (32 q / 8 kv heads)", 128, 32, 1024, 1024, 128,
     True, "bfloat16", 0),
    ("MusicGen-large prefill (32 / 32 heads of 64, MHA)", 128, 128, 1024,
     1024, 64, True, "bfloat16", 0),
    ("Llama-3-405B prefill (128 q / 8 kv heads)", 512, 32, 1024, 1024, 128,
     True, "bfloat16", 0),
    ("Qwen1.5-110B prefill (64 q / 8 kv heads)", 256, 32, 1024, 1024, 128,
     True, "bfloat16", 0)]
# the flash cases timed beside SDPA, and the key of each one's row
FLASH_TIMED = {"serving prefill": "flash_attention",
               "MoE prefill (Qwen3-MoE: 64 q / 4 kv heads)":
               "flash_attention_moe",
               "Hymba prefill, window 1,024": "flash_attention_hymba"}
# the case whose planted fault (the kernel's window one 128-row tile wider
# than the plain version's) must fail, and the case that must equal the
# unwindowed call bit for bit
FLASH_WINDOW_FAULT = "Hymba prefill, window 1,024"
FLASH_WINDOW_NONE = "window >= Skv"
# bf16 q and cache at d 64 or 128 run decode_tma (one launch, valid_len
# read on the device where it is a tensor), anything else decode_split and
# decode_combine
# a case named "..., valid_len on the device" takes the inputs of the case
# before it and must give its output bit for bit
DECODE_CASES = [  # name, B, H, KVH, T, d, valid_len, q dtype (cache: bf16), window
    ("serving decode", 4, 40, 8, 2048, 128, 1056, "bfloat16", 0),
    ("serving decode, valid_len on the device", 4, 40, 8, 2048, 128, 1056,
     "bfloat16", 0),
    ("valid_len 1", 4, 40, 8, 2048, 128, 1, "bfloat16", 0),
    ("valid_len T", 4, 40, 8, 2048, 128, 2048, "bfloat16", 0),
    ("MQA (group = H)", 4, 48, 1, 2048, 128, 1056, "bfloat16", 0),
    ("sharp scores", 4, 40, 8, 2048, 128, 1056, "bfloat16", 0),
    ("float32 q, bf16 cache", 4, 40, 8, 2048, 128, 1056, "float32", 0),
    ("MoE decode (Qwen3-MoE: 64 q / 4 kv heads)", 4, 64, 4, 2048, 128, 1056,
     "bfloat16", 0),
    ("d 64, MHA (MusicGen-large: 32 / 32 heads)", 4, 32, 32, 2048, 64, 1056,
     "bfloat16", 0),
    ("decode_32k layer", 128, 40, 8, 32768, 128, 32768, "bfloat16", 0),
    ("Hymba step, window 1,024", 4, 25, 5, 4160, 64, 4128, "bfloat16", 1024),
    ("Hymba step, window 1,024, valid_len on the device", 4, 25, 5, 4160,
     64, 4128, "bfloat16", 1024),
    ("Hymba step, window > valid_len", 4, 25, 5, 4160, 64, 1000, "bfloat16",
     2000),
    ("Hymba step, window 1,024, decode_split (float32 q)", 4, 25, 5, 4160,
     64, 4128, "float32", 1024),
    # the dense models' steps not above (Granite's is the MQA case,
    # MusicGen-large's the MHA one)
    ("Llama-3-405B step (128 q / 8 kv heads)", 4, 128, 8, 2048, 128, 1056,
     "bfloat16", 0),
    ("Qwen1.5-110B step (64 q / 8 kv heads)", 4, 64, 8, 2048, 128, 1056,
     "bfloat16", 0),
    ("Pixtral-12B step (32 q / 8 kv heads)", 4, 32, 8, 2048, 128, 1056,
     "bfloat16", 0)]
# the decode cases timed, and the key of each one's row
DECODE_TIMED = {"serving decode": "decode_attention",
                "MoE decode (Qwen3-MoE: 64 q / 4 kv heads)":
                "decode_attention_moe",
                "decode_32k layer": "decode_attention_32k",
                "Hymba step, window 1,024": "decode_attention_hymba"}
# the five dense models served after Qwen2.5-14B (dense_serve_phase), in the
# order they run, with the layers served: Granite-34B first and whole, while
# nothing else holds the card (67.92 GB of weights); Llama-3 and Qwen1.5 cut
# to about the 60 GB the training cell holds (59.41 and 59.34 GB)
DENSE_SERVE = {"granite-34b": 88, "pixtral-12b": 40, "musicgen-large": 48,
               "llama3-405b": 8, "qwen1.5-110b": 20}
# each one's prefill and decode step among the cases above, timed beside
# SDPA (the kernels line's dense_models entries)
DENSE_CASES = {  # arch: (flash case, decode case)
    "granite-34b": ("Granite-34B prefill (48 q / 1 kv head, MQA)",
                    "MQA (group = H)"),
    "pixtral-12b": ("Pixtral-12B prefill (32 q / 8 kv heads)",
                    "Pixtral-12B step (32 q / 8 kv heads)"),
    "musicgen-large": ("MusicGen-large prefill (32 / 32 heads of 64, MHA)",
                       "d 64, MHA (MusicGen-large: 32 / 32 heads)"),
    "llama3-405b": ("Llama-3-405B prefill (128 q / 8 kv heads)",
                    "Llama-3-405B step (128 q / 8 kv heads)"),
    "qwen1.5-110b": ("Qwen1.5-110B prefill (64 q / 8 kv heads)",
                     "Qwen1.5-110B step (64 q / 8 kv heads)")}
FLASH_TIMED.update({f: f"flash_attention_{a}"
                    for a, (f, _) in DENSE_CASES.items()})
DECODE_TIMED.update({d: f"decode_attention_{a}"
                     for a, (_, d) in DENSE_CASES.items()})
DECODE_WINDOW_FAULT = "Hymba step, window 1,024"   # one 64-position tile wider
SHARP = 4.0
# the pieces of a GQA layer split over model by positions (its heads do not
# divide model: Qwen2.5-14B's 40 and Hymba's 25 on 16), which the card's
# one rank never runs as a mesh: the decode kernel's log-sum-exp route on
# both kernels (bf16 q runs decode_tma, float32 q decode_split) ...
LSE_CASES = [  # name, B, H, KVH, T, d, valid_len, q dtype (cache: bf16), window
    ("serving decode, LSE", 4, 40, 8, 2048, 128, 1056, "bfloat16", 0),
    ("serving decode, LSE, decode_split (float32 q)", 4, 40, 8, 2048, 128,
     1056, "float32", 0),
    ("Hymba step, window 1,024, LSE", 4, 25, 5, 4160, 64, 4128, "bfloat16",
     1024),
    ("Hymba step, window 1,024, LSE, decode_split (float32 q)", 4, 25, 5,
     4160, 64, 4128, "float32", 1024),
    # KV replication: Qwen3-MoE's group of 16 and Granite's MQA, 48 q
    # heads over one kv head (decode_tma's largest group)
    ("MoE decode, LSE", 4, 64, 4, 2048, 128, 1056, "bfloat16", 0),
    ("MoE decode, LSE, decode_split (float32 q)", 4, 64, 4, 2048, 128, 1056,
     "float32", 0),
    ("Granite MQA decode, LSE", 4, 48, 1, 2048, 128, 1056, "bfloat16", 0),
    ("Granite MQA decode, LSE, decode_split (float32 q)", 4, 48, 1, 2048,
     128, 1056, "float32", 0)]
# ... one card's cache cut into the blocks of T that model 16 gives its
# ranks, each block decoded on the LSE route and the blocks merged, against
# one whole launch (the row of the kernels line that each one fills) ...
SPLIT_MODEL = 16
SPLIT_CASES = {"serving decode, LSE": "decode_attention_lse",
               "Hymba step, window 1,024, LSE": "decode_attention_lse_hymba",
               "MoE decode, LSE": "decode_attention_lse_moe",
               "Granite MQA decode, LSE": "decode_attention_lse_mqa"}
SPLIT_CONTROL = "the blocks' log-sum-exps taken in base 2 (lse / ln 2)"
# ... MLA's latent cache cut alike: the plain block decode at DeepSeek-V2's
# width (batch 4, 128 heads, r 512, dr 64, 1,056 valid of 2,048), the 16
# blocks merged against one whole absorbed decode within MLA_BLOCK_RTOL of
# its largest element ...
MLA_BLOCK_CASE = dict(batch=4, t=2048, valid=1056)
MLA_BLOCK_RTOL = 1e-5
# ... and the dense prefill's query rows cut as model 16's ranks take them
# (blocks r and 31 - r of 32), each block through flash over the key rows
# up to its end, against the whole launch
ZIGZAG_CASE = "serving prefill"

MOE_ARCH = "qwen3-moe-235b-a22b"     # the MoE slice: full width, depth cut
MOE_LAYERS = 12                      # of 94: 62.2 GB of bf16 weights
DEEPSEEK_ARCH = "deepseek-v2-236b"   # the MLA slice: full width, depth cut
DEEPSEEK_LAYERS = 9                  # of 60 (dense layer 0, 8 MoE): 66.33 GB
TRAIN_ARCH = "qwen2.5-14b"           # the training slice: full width, depth cut
TRAIN_LAYERS = 8                     # of 48: 60.1 GB of weights, moments, grads
# the reference's recipe for the arch's train shape (steps.recipe_for) sets
# n_micro (2) and the float32 moments and accumulation
TRAIN = dict(steps=6, global_batch=8, seq_len=1024, lr=3e-4, seed=0)
GRAD_CHECK = dict(layers=2, batch=2, seq_len=512)
# bf16 against float32 gradients: 1 - cosine and |norm ratio - 1| of every
# parameter, and the loss's relative difference.  Set before the card ran
# it, from the same check on the CPU at SMOKE width in bf16, which
# tests/test_torch_train_loss.py holds under a third of it (at most 4.4e-4,
# 1.1e-2 and 8.9e-6 over seeds 0-2)
GRAD_BOUND = {"cos": 3e-3, "norm": 5e-2, "loss": 2e-4}
RESTART_BOUND = {"loss_rel": 1e-6, "param_abs": 1e-6}
BF16_PEAK = 989e12                   # dense bf16 tensor-core FLOP/s, H100 SXM
GMM_DROP = 512                       # columns of d the planted fault drops
GMM_TOL = ("per element: (2^-7 |plain| + 2 d 2^-24 (|x| @ |w|)) (1 + 2^-7) "
           "(bf16 out); 2 d 2^-24 (|x| @ |w|) (float32 out)")
# name, groups, tiles, d, f, block_n, ids, dtype.  The serving shapes are
# Qwen3-MoE's: 128 experts, d_model 4096, d_ff_expert 1536; the prefill's
# capacity 328 (4,096 tokens x top-8 / 128 x 1.25) padded to 384 rows per
# expert (block_n 128: 3 tiles an expert, the kernel's compute path), a
# decode step's 8 padded to 16 (block_n 16: the swapped path).  block_n a
# multiple of 128 takes the compute path, any other the swapped one.
GMM_CASES = [
    ("prefill gate/up", 128, 128 * 3, 4096, 1536, 128, "capacity",
     "bfloat16"),
    ("prefill down", 128, 128 * 3, 1536, 4096, 128, "capacity", "bfloat16"),
    ("decode gate/up", 128, 128, 4096, 1536, 16, "capacity", "bfloat16"),
    ("decode down", 128, 128, 1536, 4096, 16, "capacity", "bfloat16"),
    # DeepSeek-V2: 160 routed experts of d_model 5120 x 1536, top-6: the
    # prefill's capacity 200 padded to 256 (2 tiles an expert), a decode
    # step's 8 padded to 16; the 2 shared experts take all 4,096 tokens
    ("DeepSeek prefill routed gate/up", 160, 160 * 2, 5120, 1536, 128,
     "capacity", "bfloat16"),
    ("DeepSeek prefill shared gate/up", 2, 2 * 32, 5120, 1536, 128,
     "capacity", "bfloat16"),
    ("DeepSeek decode routed gate/up", 160, 160, 5120, 1536, 16, "capacity",
     "bfloat16"),
    ("prefill gate/up at block_n 64", 128, 128 * 6, 4096, 1536, 64,
     "capacity", "bfloat16"),
    ("shuffled, repeated ids", 128, 300, 4096, 1536, 16, "shuffled",
     "bfloat16"),
    ("groups with no tile", 128, 200, 1536, 4096, 64, "gaps", "bfloat16"),
    ("block_n 128", 32, 96, 4096, 1536, 128, "shuffled", "bfloat16"),
    ("block_n 256, repeated ids", 16, 40, 2048, 1536, 256, "shuffled",
     "bfloat16"),
    ("d % 64 = 8, compute path", 16, 48, 1416, 1536, 128, "shuffled",
     "bfloat16"),
    ("d % 64 = 8, swapped path", 16, 48, 1416, 1536, 16, "shuffled",
     "bfloat16"),
    ("ragged f (f % 128 = 8)", 16, 48, 1024, 1416, 32, "shuffled",
     "bfloat16"),
    ("ragged f (f % 256 = 136), compute path", 16, 24, 1024, 1416, 128,
     "shuffled", "bfloat16"),
    ("float32 operands", 16, 64, 1024, 512, 64, "shuffled", "float32")]
# the shapes at which the planted faults must fail the check
GMM_FAULT_CASES = ("prefill gate/up", "decode gate/up",
                   "DeepSeek prefill routed gate/up",
                   "DeepSeek prefill shared gate/up",
                   "DeepSeek decode routed gate/up")


def log(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 10, warmup: int = 2, flush=None,
            spin: bool = False) -> float:
    """Median device time of ``fn`` in ms, one pair of CUDA events around
    each call.  ``flush`` (outside the events) evicts the 50 MB L2 before
    each call, for inputs that would otherwise stay cached between calls.
    With ``spin`` the card first spins for about 2 ms, so that the host has
    queued the call before the first event fires: a kernel of tens of
    microseconds is otherwise timed with the host's launch latency in it
    (the attention timings, PART's and COMB's use it; the fold's and
    gmm's do not)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) for moving ``nbytes`` and doing
    ``ops`` operations at ``ops_rate``."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _host_us(calls) -> float:
    """Host microseconds per call to enqueue ``calls`` one after another."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in calls:
        c()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / len(calls) * 1e6


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def zipf_keys(n: int, keys: int, alpha: float, gen, device):
    """Zipf(alpha) keys over [0, keys) by inverse CDF, drawn on ``device``."""
    import torch
    w = torch.arange(1, keys + 1, dtype=torch.float64, device=device) ** -alpha
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(n, dtype=torch.float64, device=device, generator=gen)
    return torch.searchsorted(cdf, u).clamp_(max=keys - 1)


def zipf_shards(seed: int, alpha: float = ALPHA, rows: int | None = None):
    """Per-worker Msgs for the slice: the generator of the JAX package's
    benchmarks (``benchmarks/common.py:zipf_shards``), here at width 8;
    ``rows`` a worker (``ROWS_PER_WORKER`` unless given)."""
    import numpy as np

    from repro_torch.core import Msgs
    rows = ROWS_PER_WORKER if rows is None else rows
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, KEYS + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -alpha)
    cdf /= cdf[-1]
    return {w: Msgs(np.searchsorted(cdf, rng.random(rows))
                    .astype(np.int64), rng.random((rows, WIDTH)))
            for w in range(WORKERS)}


def copy_bufs(bufs):
    return {w: m.copy() for w, m in bufs.items()}


# ---------------------------------------------------------------------------
# 3. kernel phase
# ---------------------------------------------------------------------------

def fold_same(got, plain) -> bool:
    """Bit-identical, except that a NaN matches any NaN: IEEE leaves an
    arithmetic NaN's payload unspecified."""
    import torch
    return bool(((got.view(torch.int64) == plain.view(torch.int64))
                 | (got.isnan() & plain.isnan())).all())


def _segment_layout(keys, ndst: int):
    """The global stage's layout: rows sorted destination-major, key
    ascending, with compacted (destination, key) segment ids -- exactly what
    ``torchplan.kernel_global_stage`` hands COMB."""
    import torch

    from repro_torch.core import torchplan
    slot = torchplan._slot_of(("hash",), keys, ndst)
    order = torch.sort(keys, stable=True).indices
    order = order[torch.sort(slot[order], stable=True).indices]
    sk, ss = keys[order], slot[order]
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = (sk[1:] != sk[:-1]) | (ss[1:] != ss[:-1])
    return order, head, torch.cumsum(head, 0) - 1


def trace_phase(dev) -> dict:
    """Which device kernels one call launches, read from torch.profiler
    traces, for every traced check of this script: a call each of the
    fold, PART and COMB on the global stage's layout at the main path's
    shapes, one of the sLSTM recurrence, and one call of each flash and
    decode case on inputs of the case's shapes and dtypes.  All sessions run here, back to back, before
    anything else: a session long after the one before it may hold no
    device event (``dev/profiler_sessions.py``).  Returns the flash and
    decode kernels by case name; the fold, PART, COMB and the sLSTM
    recurrence are checked here."""
    import torch

    from repro_torch.kernels._build import (_traced_kernels, decode_kernel_ran,
                                            flash_kernel_ran)
    from repro_torch.kernels.combine import segment_combine
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fold import segmented_fold
    from repro_torch.kernels.partition import partition_permute
    from repro_torch.kernels.slstm import slstm_scan

    n, d = WORKERS * ROWS_PER_WORKER, WIDTH
    gen = torch.Generator(device=dev).manual_seed(3)
    vals = torch.rand((n, d), dtype=torch.float32, device=dev, generator=gen)
    perm = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
    order, head, seg = _segment_layout(
        zipf_keys(n, KEYS, ALPHA, gen, dev), WORKERS)
    ids, s_count = seg.to(torch.int32), int(seg[-1]) + 1
    routed = vals[order].contiguous()
    zv = routed.double()
    # the fold is one kernel, PART a memset of its inverse and two kernels,
    # COMB a memset of its output and one kernel.  Each wrapper is called
    # once first, outside the trace: a first call also zeroes the tile
    # counters and the like that later calls share
    def calls():
        segmented_fold("sum", head, zv)
        partition_permute(perm, vals, num_out=n, unique_slots=True)
        segment_combine(ids, routed, num_segments=s_count)
    calls()
    traced = _traced_kernels(calls, 3)
    want = ("segmented_fold", "Memset", "build_inverse", "gather_rows",
            "Memset", "segment_sum")
    assert len(traced) == len(want) and all(
        w in t for w, t in zip(want, traced)), traced
    log(f"trace fold, PART and COMB, the device work of one call each: "
        f"{json.dumps([x[:50] for x in traced])}")
    del vals, perm, order, head, seg, ids, routed, zv

    # the sLSTM recurrence: one cooperative launch, one device kernel
    xw, w, bias, st = _slstm_inputs(dev, gen, 4, 64, XLSTM_D, "bfloat16",
                                    "random")
    slstm_scan(xw, w, bias, st)
    traced = _traced_kernels(lambda: slstm_scan(xw, w, bias, st), 3)
    assert len(traced) == 1 and "slstm_scan" in traced[0], traced
    log(f"trace slstm_scan, the device work of one call (B 4, S 64, d "
        f"{XLSTM_D}): {json.dumps([x[:50] for x in traced])}")
    del xw, w, bias, st

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

    paths = {"flash": {}, "decode": {}}
    for name, bhq, bhkv, sq, skv, dd, causal, qdt, win in FLASH_CASES:
        q = randn((bhq, sq, dd), getattr(torch, qdt))
        k, v = randn((bhkv, skv, dd)), randn((bhkv, skv, dd))
        flash_attention(q, k, v, causal=causal, window=win)
        paths["flash"][name] = flash_kernel_ran(
            lambda: flash_attention(q, k, v, causal=causal, window=win))
    del q, k, v
    for name, bb, hh, kk, tt, dd, valid, qdt, win in DECODE_CASES:
        if name.endswith("on the device"):   # the case before's inputs
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        else:
            q = randn((bb, hh, dd), getattr(torch, qdt))
            kc, vc = randn((bb, tt, kk, dd)), randn((bb, tt, kk, dd))
            vl = valid
        decode_attention(q, kc, vc, vl, window=win)
        paths["decode"][name] = decode_kernel_ran(
            lambda: decode_attention(q, kc, vc, vl, window=win))
    paths["decode_lse"] = {}
    for name, bb, hh, kk, tt, dd, valid, qdt, win in LSE_CASES:
        q = randn((bb, hh, dd), getattr(torch, qdt))
        kc, vc = randn((bb, tt, kk, dd)), randn((bb, tt, kk, dd))
        decode_attention(q, kc, vc, valid, window=win, return_lse=True)
        paths["decode_lse"][name] = decode_kernel_ran(
            lambda: decode_attention(q, kc, vc, valid, window=win,
                                     return_lse=True))
    del q, kc, vc
    torch.cuda.empty_cache()
    log(f"trace flash and decode cases: {json.dumps(paths)}")
    return paths


def kernel_phase(dev) -> dict:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.combine import segment_combine
    from repro_torch.kernels.combine import tile_rows as combine_tile_rows
    from repro_torch.kernels.fold import segmented_fold
    from repro_torch.kernels.partition import partition_permute

    n, d = WORKERS * ROWS_PER_WORKER, WIDTH
    gen = torch.Generator(device=dev).manual_seed(1)
    vals = torch.rand((n, d), dtype=torch.float32, device=dev, generator=gen)
    rows = {}

    # ---- PART as the replay calls it: a permutation, n = 8M, d = 8 --------
    perm = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
    got = partition_permute(perm, vals, num_out=n, unique_slots=True)
    plain = ref.partition_permute_ref(perm, vals, num_out=n)
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    assert torch.equal(got, plain), "PART (permutation) differs from plain"
    # control: one output row gathers its source row's neighbour
    src = int(torch.nonzero(perm == n // 3)[0])
    bad = vals.clone()
    bad[src] = vals[src + 1]
    assert not torch.equal(partition_permute(perm, bad, num_out=n,
                                             unique_slots=True), plain), \
        "the neighbour-row control passed PART's check"
    del bad
    lib_out, perm64 = torch.empty_like(vals), perm.long()
    tb = bound(4 * n + 4 * n * d + 4 * n * d, 0, F32_OPS_PER_S)
    rows["partition_permute"] = dict(
        max_abs_err=err, tolerance="exact",
        ms=time_ms(lambda: partition_permute(perm, vals, num_out=n,
                                             unique_slots=True), spin=True),
        plain_ms=time_ms(lambda: ref.partition_permute_ref(perm, vals,
                                                           num_out=n)),
        library_ms=time_ms(lambda: lib_out.index_copy_(0, perm64, vals),
                           spin=True),
        library_call="index_copy_",
        index_add_ms=time_ms(lambda: lib_out.index_add_(0, perm64, vals),
                             spin=True),
        bound_ms=tb[0], bound_by=tb[1])
    log(f"kernel PART permutation n={n} d={d} f32: exact (the neighbour-row "
        f"control failed it), {json.dumps(rows['partition_permute'])}")

    # ---- PART with collisions (-1 and >= num_out dropped) -----------------
    m = n // 8
    slots = torch.randint(-1, m + 1, (n,), device=dev, generator=gen,
                          dtype=torch.int32)
    got = partition_permute(slots, vals, num_out=m)
    plain = ref.partition_permute_ref(slots, vals, num_out=m)
    ok = (slots >= 0) & (slots < m)
    cnt = torch.bincount(slots[ok].long(), minlength=m).double()[:, None]
    absum = torch.zeros((m, d), dtype=torch.float64, device=dev).index_add_(
        0, slots[ok].long(), vals[ok].double().abs())
    # both sides are float32 sums of the same rows: each within
    # cnt * 2^-24 * sum|v| of the exact sum, so within twice that of each other
    tol = 2 * cnt * U32 * absum
    diff = (got.double() - plain.double()).abs()
    assert bool((diff <= tol).all()), "PART (collisions) outside the f32 bound"
    tb = bound(4 * n + 4 * n * d + 4 * m * d, n * d, F32_OPS_PER_S)
    log(f"kernel PART collisions n={n} num_out={m} d={d} f32: "
        f"max_abs_err={float(diff.max())!r} (bound 2*len*2^-24*sum|v|), "
        f"ms={time_ms(lambda: partition_permute(slots, vals, num_out=m), spin=True)!r}, "
        f"plain_ms={time_ms(lambda: ref.partition_permute_ref(slots, vals, num_out=m))!r}, "
        f"bound_ms={tb[0]!r}")

    # ---- COMB on the replay's sorted, compacted ids -----------------------
    keys = zipf_keys(n, KEYS, ALPHA, gen, dev)
    order, head, seg = _segment_layout(keys, WORKERS)
    ids = seg.to(torch.int32)
    s_count = int(seg[-1]) + 1
    routed = vals[order].contiguous()
    got = segment_combine(ids, routed, num_segments=s_count)
    plain = ref.segment_combine_ref(ids, routed, num_segments=s_count)
    exact = torch.zeros((s_count, d), dtype=torch.float64, device=dev)
    exact.index_add_(0, seg, routed.double())
    lens = torch.bincount(seg, minlength=s_count).double()[:, None]
    # positive inputs: sum|v| is the exact sum.  f32 summation bound:
    # |fl(sum) - sum| <= len_seg * 2^-24 * sum|v| per segment and column
    tol = lens * U32 * exact

    def comb_held(out) -> bool:
        return bool(((out.double() - exact).abs() <= tol).all())
    assert comb_held(got), "COMB outside the f32 summation bound"
    err = float((got.double() - plain.double()).abs().max())
    assert bool(((got.double() - plain.double()).abs() <= 2 * tol).all())
    # control: a segment of 20..1,000 rows that crosses a tile boundary
    # loses the partial sum of its rows past the boundary
    tile = combine_tile_rows(d, torch.float32)
    starts = torch.nonzero(head).flatten()
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    crossing = ((starts // tile < (ends - 1) // tile)
                & (ends - starts >= 20) & (ends - starts <= 1000))
    a, b = (int(x) for x in (starts[crossing][0], ends[crossing][0]))
    bad = routed.clone()
    bad[(a // tile + 1) * tile:b] = 0
    assert not comb_held(segment_combine(ids, bad, num_segments=s_count)), \
        "the dropped-partial control passed COMB's check"
    del bad
    # the same ids and rows in a random row order: the same exact sums
    shuffle = torch.randperm(n, device=dev, generator=gen)
    u_ids, u_vals = ids[shuffle].contiguous(), routed[shuffle].contiguous()
    got = segment_combine(u_ids, u_vals, num_segments=s_count)
    assert comb_held(got), "COMB (unsorted ids) outside the f32 bound"
    u_err = float((got.double() - exact).abs().max())
    sass = sass_counts("combine")
    assert sass["UBLKCP.S.G"] > 0 and sass["REDG.E.ADD.F32x4"] > 0, \
        f"no bulk copy or no vector reduction in COMB's SASS: {sass}"
    lib_out = torch.zeros((s_count, d), dtype=torch.float32, device=dev)
    tb = bound(4 * n + 4 * n * d + 4 * s_count * d, n * d, F32_OPS_PER_S)
    rows["segment_combine"] = dict(
        max_abs_err=err, tolerance="len_seg*2^-24*sum|v| against the exact sum",
        ms=time_ms(lambda: segment_combine(ids, routed,
                                           num_segments=s_count), spin=True),
        plain_ms=time_ms(lambda: ref.segment_combine_ref(
            ids, routed, num_segments=s_count)),
        library_ms=time_ms(lambda: lib_out.index_add_(0, seg, routed),
                           spin=True),
        bound_ms=tb[0], bound_by=tb[1], segments=s_count,
        unsorted_ms=time_ms(lambda: segment_combine(u_ids, u_vals,
                                                    num_segments=s_count),
                            spin=True),
        unsorted_max_abs_err_vs_exact=u_err)
    del u_ids, u_vals
    log(f"kernel COMB sorted ids n={n} S={s_count} d={d} f32 (tiles of "
        f"{tile} rows; the dropped-partial control, rows {a}..{b}, failed "
        f"the check; unsorted ids held; SASS {json.dumps(sass)}): "
        f"{json.dumps(rows['segment_combine'])}")

    # ---- the ordered fold: bit-identical for sum / min / max --------------
    # segments of 1..FOLD_MAX_SEG rows, so the plain loop takes <= 64 steps
    lens = torch.randint(1, FOLD_MAX_SEG + 1, (n,), device=dev, generator=gen)
    starts = torch.cumsum(lens, 0)
    starts = starts[starts < n]
    is_start = torch.zeros(n, dtype=torch.bool, device=dev)
    is_start[0] = True
    is_start[starts] = True
    v64 = torch.randn((n, d), dtype=torch.float64, device=dev, generator=gen)
    special = torch.rand((n, d), device=dev, generator=gen) < 1e-3
    picks = torch.tensor([float("nan"), 0.0, -0.0, float("inf")],
                         dtype=torch.float64, device=dev)
    v64[special] = picks[torch.randint(0, 4, (int(special.sum()),),
                                       device=dev, generator=gen)]
    for op in ("sum", "min", "max"):
        got = segmented_fold(op, is_start, v64)
        plain = ref.segmented_fold_ref(op, is_start, v64)
        assert fold_same(got, plain), f"fold {op} differs from the plain version"
    tb = bound(n + 8 * n * d + 8 * n * d, n * d, F64_OPS_PER_S)
    rows["segmented_fold"] = dict(
        max_abs_err=0.0, tolerance="bit-identical (sum, min, max; NaN=NaN)",
        ms=time_ms(lambda: segmented_fold("sum", is_start, v64)),
        plain_ms=time_ms(lambda: ref.segmented_fold_ref("sum", is_start, v64),
                         reps=3, warmup=1),
        library_ms=None, bound_ms=tb[0], bound_by=tb[1],
        longest_segment=FOLD_MAX_SEG)

    # the fold on the global stage's own layout: one hot Zipf key is one
    # long segment, a chain of dependent adds in row order.  Its SUM is held
    # bit for bit against the plain version on a CPU copy (the plain loop
    # takes a step per row of the longest segment: far longer on the card)
    zs, zv = head.contiguous(), routed.double()
    lens = torch.bincount(seg)
    longest = int(lens.max())
    got = segmented_fold("sum", zs, zv).cpu()
    t0 = time.perf_counter()
    plain = ref.segmented_fold_ref("sum", zs.cpu(), zv.cpu())
    check_s = time.perf_counter() - t0
    assert fold_same(got, plain), "fold (Zipf layout) differs from the plain version"
    # control: two adjacent rows of the hot segment swapped must fail it
    hot = int(torch.cumsum(lens, 0)[int(lens.argmax())]) - longest
    swapped = zv.clone()
    swapped[[hot + 1000, hot + 1001]] = zv[[hot + 1001, hot + 1000]]
    assert not fold_same(segmented_fold("sum", zs, swapped).cpu(), plain), \
        "the swapped-rows control passed the fold's bit check"
    del swapped
    # the fold library's SASS holds the bulk copies (the trace phase shows
    # that a call is one kernel)
    sass = sass_counts("fold")
    assert sass["UBLKCP.S.G"] > 0, f"no bulk copy in the fold's SASS: {sass}"
    rows["segmented_fold"].update(
        zipf_ms=time_ms(lambda: segmented_fold("sum", zs, zv), reps=5),
        zipf_longest_segment=longest, zipf_byte_bound_ms=tb[0])
    log(f"kernel fold n={n} d={d} f64, segments 1..{FOLD_MAX_SEG} and the Zipf "
        f"global layout (longest {longest}; its plain check took "
        f"{check_s:.1f} s on the CPU; the swapped-rows control failed it; "
        f"SASS {json.dumps(sass)}): {json.dumps(rows['segmented_fold'])}")
    return rows


# ---------------------------------------------------------------------------
# 3b. attention kernels
# ---------------------------------------------------------------------------

ATTN_TOL = ("per element: 2^-7 |plain| + 2^-14 A (+ 2^-8 A where P is "
            "rounded to bf16), A = the plain attention of |v|; float32 "
            "out: 1e-5 (1 + |plain|)")


def _held(got, plain, tol) -> tuple[float, float]:
    """(largest |got - plain|, largest share of the bound it uses)."""
    diff = (got.float() - plain.float()).abs()
    return float(diff.max()), float((diff / tol).max())


def _flash_work(q, k, causal: bool, window: int = 0) -> tuple[float, float]:
    """(bytes, operations) of one flash call on these shapes
    (``kernels.work.flash_work``: every input read once, the output
    written once; 4 D operations for each query-key pair that the causal
    mask and the window keep)."""
    from repro_torch.kernels import work
    return work.flash_work(q.shape[0], q.shape[1], k.shape[0], k.shape[1],
                           q.shape[2], q.element_size(), k.element_size(),
                           causal, window)


def _decode_work(q, k, valid: int, window: int = 0) -> tuple[float, float]:
    """(bytes, operations) of one decode call (``kernels.work.decode_work``:
    q read and out written once, the cache's attended positions of K and V
    read once)."""
    from repro_torch.kernels import work
    b, h, d = q.shape
    return work.decode_work(b, h, k.shape[2], d, valid, q.element_size(),
                            k.element_size(), window)


def _window_mask(sq: int, skv: int, window: int, device):
    """The boolean ``[Sq, Skv]`` mask SDPA takes for end-aligned causal
    rows with a sliding window (True: attend)."""
    import torch
    rows = torch.arange(sq, device=device)[:, None] + (skv - sq)
    cols = torch.arange(skv, device=device)[None]
    return (cols <= rows) & (rows - cols < window)


def attention_phase(dev, paths: dict) -> dict:
    """The attention kernels' checks and times; ``paths`` holds the kernels
    each case launched, as the trace phase read them."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    scratch = torch.ones(2 * L2_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():            # read, not write: no dirty lines to write back
        scratch.sum()

    def randn(shape, dtype=bf16):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

    rows = {}

    # ---- flash: the serving prefill, then edge cases and windows ----------
    sass = sass_counts("flash_attention")
    log(f"kernel flash SASS instructions: {json.dumps(sass)}")
    assert sass["HGMMA"] > 0 and sass["UTMALDG"] > 0, sass
    b = SERVE["batch"]
    for name, bhq, bhkv, sq, skv, d, causal, qdt, win in FLASH_CASES:
        q = randn((bhq, sq, d), getattr(torch, qdt))
        if name == "sharp scores":
            q = q * SHARP
        k, v = randn((bhkv, skv, d)), randn((bhkv, skv, d))
        path = paths["flash"][name]       # read by the trace phase
        got = flash_attention(q, k, v, causal=causal, window=win)
        plain = ref.flash_attention_ref(q, k, v, causal=causal, window=win)
        tol = ref.flash_attention_tolerance(q, k, v, plain, causal=causal,
                                            window=win)
        err, share = _held(got, plain, tol)
        assert got.dtype == q.dtype and bool(torch.isfinite(got).all())
        assert share <= 1.0, f"flash {name}: {share} of the bound"
        if qdt == "bfloat16" and d in (64, 128):
            assert path == "flash_wgmma", (name, path)
        log(f"kernel flash {name} q={tuple(q.shape)} kv={tuple(k.shape)} "
            f"causal={causal} window={win} ran {path}: max_abs_err={err!r}, "
            f"bound share {share!r}")
        if name == "non-causal":
            # planted fault: the same call with the last kv tile skipped
            cut = flash_attention(q, k[:, :-64].contiguous(),
                                  v[:, :-64].contiguous(), causal=False)
            _, fshare = _held(cut, plain, tol)
            log(f"kernel flash planted fault (last kv tile dropped): "
                f"bound share {fshare!r}")
            assert fshare > 1.0, "the flash check passes a dropped tile"
        if name == FLASH_WINDOW_FAULT:
            # planted fault: the kernel's window one 128-row tile wider
            wide = flash_attention(q, k, v, causal=causal, window=win + 128)
            _, fshare = _held(wide, plain, tol)
            log(f"kernel flash planted fault (window {win} + 128): bound "
                f"share {fshare!r}")
            assert fshare > 1.0, "the flash check passes a wider window"
        if name == FLASH_WINDOW_NONE:
            assert skv <= win and torch.equal(
                got, flash_attention(q, k, v, causal=causal)), \
                "a window of Skv or more differs from no window"
        if name not in FLASH_TIMED:
            continue
        nbytes, ops = _flash_work(q, k, causal, win)
        tb = bound(nbytes, ops, BF16_OPS_PER_S)
        q4, k4, v4 = (x.view(b, -1, x.shape[1], d) for x in (q, k, v))
        sdpa = dict(is_causal=True) if not win else \
            dict(attn_mask=_window_mask(sq, skv, win, dev))

        def library(sdpa=sdpa):
            return F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True,
                                                  **sdpa)
        lib = library()
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                             window=win), spin=True)
        row = dict(
            max_abs_err=err, tolerance=ATTN_TOL, bound_share=share, path=path,
            window=win, ms=ms, tflop_per_s=ops / ms / 1e9,
            plain_ms=time_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=True, window=win), spin=True),
            library_ms=time_ms(library, spin=True),
            library_call="scaled_dot_product_attention" + (
                " with the window's boolean mask" if win else ", is_causal"),
            bound_ms=tb[0], bound_by=tb[1],
            sdpa_max_abs_diff=float((lib.reshape(q.shape).float()
                                     - got.float()).abs().max()))
        if win:     # the same kernel and inputs with no window, and its bound
            row["unwindowed_ms"] = time_ms(
                lambda: flash_attention(q, k, v, causal=True), spin=True)
            row["unwindowed_bound_ms"] = bound(
                *_flash_work(q, k, True), BF16_OPS_PER_S)[0]
            row["windowed_over_unwindowed"] = ms / row["unwindowed_ms"]
        rows[FLASH_TIMED[name]] = row
        log(f"kernel flash {name}: {json.dumps(row)}")
        del q4, k4, v4, lib
    del q, k, v, got, plain, tol
    torch.cuda.empty_cache()

    # ---- decode: the serving step, edge cases, one decode_32k layer, the
    # Hymba step with its window
    sass = sass_counts("decode_attention")
    log(f"kernel decode SASS instructions: {json.dumps(sass)}")
    assert sass["UTMALDG"] > 0, sass
    prev = None
    for name, bb, hh, kk, tt, d, valid, qdt, win in DECODE_CASES:
        on_device = name.endswith("on the device")
        if on_device:           # the case before's inputs, valid_len read
            q, kc, vc, want = prev            # on the card
            vl = torch.tensor(valid, dtype=torch.int32, device=dev)
        else:
            q = randn((bb, hh, d), getattr(torch, qdt))
            if name == "sharp scores":
                q = q * SHARP
            kc, vc = randn((bb, tt, kk, d)), randn((bb, tt, kk, d))
            vl = valid
        got = decode_attention(q, kc, vc, vl, window=win)
        path = paths["decode"][name]      # read by the trace phase
        if qdt == "bfloat16":
            assert path == ("decode_tma",), (name, path)
        else:
            assert path[0] == "decode_split", (name, path)
        if on_device:           # bit for bit the int path's output
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        prev = (q, kc, vc, got)
        # the plain version on 16 sequences at most (at decode_32k its
        # float32 copies of the whole cache would not fit beside it)
        n = min(bb, 16)
        kv = (kc[:n, :valid], vc[:n, :valid])
        plain = ref.decode_attention_ref(q[:n], *kv, valid, window=win)
        tol = ref.decode_attention_tolerance(q[:n], *kv, valid, plain,
                                             window=win)
        err, share = _held(got[:n], plain, tol)
        assert got.dtype == q.dtype and bool(torch.isfinite(got).all())
        assert share <= 1.0, f"decode {name}: {share} of the bound"
        log(f"kernel decode {name} q={tuple(q.shape)} cache={tuple(kc.shape)} "
            f"valid_len={valid} window={win} ran {'+'.join(path)}: "
            f"max_abs_err={err!r}, bound share {share!r}")
        if name == "serving decode":
            # planted fault: the last 32 positions (1024..1055) dropped
            cut = decode_attention(q, kc, vc, valid - 32)
            _, fshare = _held(cut, plain, tol)
            log(f"kernel decode planted fault (last split dropped): "
                f"bound share {fshare!r}")
            assert fshare > 1.0, "the decode check passes a dropped split"
            # the host's cost of a call: enqueue time on one cache, and on
            # caches at 200 other addresses (tensor maps encoded anew)
            numel = kc.numel()
            buf = torch.empty(numel + 200 * 16, dtype=kc.dtype, device=dev)
            views = [buf[16 * i:16 * i + numel].view(kc.shape)
                     for i in range(200)]
            host = dict(
                same_cache=_host_us([lambda: decode_attention(q, kc, vc,
                                                              valid)] * 200),
                new_cache=_host_us([lambda x=x: decode_attention(q, x, x,
                                                                 valid)
                                    for x in views]))
            log(f"kernel decode host us per call: {json.dumps(host)}")
            del buf, views
        if name == DECODE_WINDOW_FAULT:
            # planted fault: the kernel's window one 64-position tile wider
            wide = decode_attention(q, kc, vc, valid, window=win + 64)
            _, fshare = _held(wide, plain, tol)
            log(f"kernel decode planted fault (window {win} + 64): bound "
                f"share {fshare!r}")
            assert fshare > 1.0, "the decode check passes a wider window"
        if name in DECODE_TIMED:
            nbytes, ops = _decode_work(q, kc, valid, win)
            tb = bound(nbytes, ops, BF16_OPS_PER_S)
            row = dict(
                max_abs_err=err, tolerance=ATTN_TOL, bound_share=share,
                path=path[0] if len(path) == 1 else "+".join(path),
                window=win,
                ms=time_ms(lambda: decode_attention(q, kc, vc, valid,
                                                    window=win),
                           flush=flush, spin=True),
                bound_ms=tb[0], bound_by=tb[1], plain_ms=None, library_ms=None)
            row["tb_per_s"] = nbytes / row["ms"] / 1e9
            if name != "decode_32k layer":
                # not at decode_32k: the plain version's float32 copies of
                # the cache, and SDPA's, may not fit beside it.  SDPA reads
                # the attended positions only: the window's slice
                lo = max(0, valid - win) if win else 0
                q4 = q.view(bb, hh, 1, d)
                k4 = kc[:, lo:valid].transpose(1, 2)
                v4 = vc[:, lo:valid].transpose(1, 2)
                row["plain_ms"] = time_ms(
                    lambda: ref.decode_attention_ref(q, kc, vc, valid,
                                                     window=win),
                    flush=flush, spin=True)
                row["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, enable_gqa=True), flush=flush,
                    spin=True)
                row["library_call"] = "scaled_dot_product_attention" + (
                    " on the window's slice of the cache" if win else "")
                del q4, k4, v4
            if win:     # the same kernel and inputs with no window
                row["unwindowed_ms"] = time_ms(
                    lambda: decode_attention(q, kc, vc, valid), flush=flush,
                    spin=True)
                row["unwindowed_bound_ms"] = bound(
                    *_decode_work(q, kc, valid), BF16_OPS_PER_S)[0]
            rows[DECODE_TIMED[name]] = row
            log(f"kernel decode {name}: {json.dumps(row)}")
        del got, plain, tol, kv
    del prev, q, kc, vc
    del scratch
    torch.cuda.empty_cache()
    return rows


LSE_TOL = ("lse: ref.lse_tolerance, 2^-24 (attended + d) (1 + |plain|); "
           "out (float32): 1e-5 (1 + |plain|)")
SPLIT_TOL = ("against the whole launch's bf16 output: ref.attention_"
             "tolerance, 2^-7 |whole| + 2^-14 A")
ZIGZAG_TOL = ("against the whole launch: ref.attention_tolerance with "
              "rounds_p, 2^-7 |whole| + (2^-14 + 2^-8 (1 + 2^-8)) A")


def split_phase(dev, paths: dict) -> dict:
    """The kernels of the layers whose caches split ``T`` over ``model``
    (a GQA layer split by positions or under KV replication, and MLA), on
    one card (``shardings.attention_split``: ``"positions"`` or
    ``"replicate"``; on the card's one rank every layer splits by heads,
    so the split itself is held on the CPU over gloo ranks): the decode
    kernel's log-sum-exp
    route on both kernels against the plain version, one card's cache cut
    into the ``SPLIT_MODEL`` blocks of ``T`` that model 16 gives its ranks
    (each decoded on that route by ``block_window``'s rows and window, the
    empty ones returned by the wrapper with no launch, the blocks merged
    by ``merge_blocks``) against one whole launch, with a planted base-2
    LSE that must fail, and the dense prefill's query rows cut as
    ``shardings.position_blocks`` cuts them over 16, each block through
    flash, against the whole launch; MLA's block decode
    (:func:`mla_block_check`).  Returns the rows of the kernels line's
    ``lse`` and ``zigzag`` entries (``mla_blocks`` logged only: no kernel
    runs in MLA)."""
    import math

    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (block_window,
                                                      decode_attention,
                                                      merge_blocks)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.shardings import position_blocks

    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(5)
    scratch = torch.ones(2 * L2_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        scratch.sum()

    def randn(shape, dtype=bf16):
        return torch.randn(shape, dtype=dtype, device=dev, generator=gen)

    rows, inputs = {}, {}
    for name, bb, hh, kk, tt, d, valid, qdt, win in LSE_CASES:
        q = randn((bb, hh, d), getattr(torch, qdt))
        kc, vc = randn((bb, tt, kk, d)), randn((bb, tt, kk, d))
        out, lse = decode_attention(q, kc, vc, valid, window=win,
                                    return_lse=True)
        path = paths["decode_lse"][name]
        if qdt == "bfloat16":
            assert path == ("decode_tma",), (name, path)
        else:
            assert path[0] == "decode_split", (name, path)
        p_out, p_lse = ref.decode_attention_ref(q, kc, vc, valid, window=win,
                                                return_lse=True)
        err, share = _held(out, p_out, ref.decode_attention_tolerance(
            q, kc, vc, valid, p_out, window=win))
        ltol = ref.lse_tolerance(p_lse, min(valid, win) if win else valid, d)
        lerr, lshare = _held(lse, p_lse, ltol)
        _, fshare = _held(lse / math.log(2), p_lse, ltol)
        assert out.dtype == lse.dtype == torch.float32
        assert tuple(lse.shape) == (bb, hh)
        assert bool(torch.isfinite(out).all() & torch.isfinite(lse).all())
        assert share <= 1.0 and lshare <= 1.0, (name, share, lshare)
        assert fshare > 1.0, f"the LSE check passes a base-2 LSE: {name}"
        # one launch on the route against the same call off it
        ms = time_ms(lambda: decode_attention(q, kc, vc, valid, window=win,
                                              return_lse=True),
                     flush=flush, spin=True)
        off_ms = time_ms(lambda: decode_attention(q, kc, vc, valid,
                                                  window=win),
                         flush=flush, spin=True)
        log(f"kernel decode {name} q={tuple(q.shape)} cache={tuple(kc.shape)}"
            f" valid_len={valid} window={win} ran {'+'.join(path)}: out "
            f"max_abs_err={err!r} (bound share {share!r}), lse max_abs_err="
            f"{lerr!r} (bound share {lshare!r}; base 2: {fshare!r}; "
            f"{LSE_TOL}); {ms!r} ms, off the route {off_ms!r} ms")
        inputs[name] = (q, kc, vc, valid, win, path, lerr, ms, off_ms)
        del p_out, p_lse, out, lse

    for name, key in SPLIT_CASES.items():
        q, kc, vc, valid, win, path, lerr, route_ms, off_ms = inputs[name]
        t = kc.shape[1]
        n = t // SPLIT_MODEL
        blocks = [(kc[:, i * n:(i + 1) * n].contiguous(),
                   vc[:, i * n:(i + 1) * n].contiguous(),
                   *block_window(valid, i * n, n, win))
                  for i in range(SPLIT_MODEL)]

        def split(lse_scale: float = 1.0, blocks=blocks, q=q):
            outs, lses = [], []
            for kb, vb, v_r, w_r in blocks:   # an empty block: no launch
                o, lse = decode_attention(q, kb, vb, v_r, window=w_r,
                                          return_lse=True)
                outs.append(o)
                lses.append(lse * lse_scale)
            return merge_blocks(torch.stack(outs), torch.stack(lses))

        before = decode_attention.launches
        got = split()
        launched = decode_attention.launches - before
        assert launched == sum(b[2] > 0 for b in blocks), launched
        whole = decode_attention(q, kc, vc, valid, window=win)
        a = ref.decode_attention_ref(q.float(), kc, vc.abs(), valid,
                                     window=win)
        tol = ref.attention_tolerance(whole, a)
        err, share = _held(got, whole, tol)
        _, fshare = _held(split(1 / math.log(2)), whole, tol)
        assert share <= 1.0, f"split decode {name}: {share} of the bound"
        assert fshare > 1.0, f"the split check passes a base-2 LSE: {name}"
        row = dict(blocks=SPLIT_MODEL, launches=launched,
                   rows_a_block=n, valid_len=valid, window=win,
                   path="+".join(path), max_abs_err=err, tolerance=SPLIT_TOL,
                   bound_share=share, control=SPLIT_CONTROL,
                   control_share=fshare, lse_max_abs_err=lerr,
                   route_ms=route_ms, off_route_ms=off_ms,
                   ms=time_ms(split, flush=flush, spin=True),
                   whole_ms=time_ms(lambda: decode_attention(
                       q, kc, vc, valid, window=win), flush=flush, spin=True))
        rows[key] = row
        log(f"kernel decode split {name} over {SPLIT_MODEL} blocks of {n} "
            f"rows: {json.dumps(row)}")
        del blocks, got, whole, a, tol
    del inputs
    rows["mla_blocks"] = mla_block_check(dev, flush)

    # the dense prefill's rows as model 16's ranks take them
    _, bhq, bhkv, sq, skv, d, causal, qdt, win = next(
        c for c in FLASH_CASES if c[0] == ZIGZAG_CASE)
    q, k, v = randn((bhq, sq, d)), randn((bhkv, skv, d)), randn((bhkv, skv, d))
    whole = flash_attention(q, k, v, causal=True)
    parts = []
    for pair in position_blocks(sq, SPLIT_MODEL):
        for lo, hi in pair:
            end = skv - sq + hi
            parts.append((lo, q[:, lo:hi].contiguous(),
                          k[:, :end].contiguous(), v[:, :end].contiguous()))
    parts.sort(key=lambda x: x[0])

    def zigzag():
        return torch.cat([flash_attention(qb, kb, vb, causal=True)
                          for _, qb, kb, vb in parts], dim=1)
    before = flash_attention.launches
    got = zigzag()
    launched = flash_attention.launches - before
    a = ref.flash_attention_ref(q.float(), k, v.abs(), causal=True)
    err, share = _held(got, whole, ref.attention_tolerance(whole, a,
                                                           rounds_p=True))
    assert got.shape == whole.shape and share <= 1.0, share
    row = dict(blocks=len(parts), launches=launched,
               bit_for_bit=bool(torch.equal(got, whole)), max_abs_err=err,
               tolerance=ZIGZAG_TOL, bound_share=share,
               ms=time_ms(zigzag, spin=True),
               whole_ms=time_ms(lambda: flash_attention(q, k, v, causal=True),
                                spin=True))
    rows["flash_attention_zigzag"] = row
    log(f"kernel flash zig-zag rows of {ZIGZAG_CASE} over {SPLIT_MODEL} "
        f"ranks: {json.dumps(row)}")
    del q, k, v, whole, parts, got, a, scratch
    torch.cuda.empty_cache()
    return rows


def mla_block_check(dev, flush) -> dict:
    """MLA's decode over its latent cache cut into the ``SPLIT_MODEL``
    blocks of ``T`` that model 16 gives its ranks, at DeepSeek-V2's width
    (``MLA_BLOCK_CASE``): each block through ``layers.mla_block_decode``
    over its valid rows (``block_window``; the blocks past the valid
    length give zeros and ``-inf``), the blocks merged by their
    log-sum-exps (``merge_blocks``) and ``wkv_b``'s value half applied,
    against one whole ``mla_absorbed_decode`` on the same bf16 cache
    within ``MLA_BLOCK_RTOL`` of its largest element; a plain mean of the
    blocks' contexts must miss by 10x.  No kernel runs (plain float32
    einsums, as in the layer); both are timed."""
    from types import SimpleNamespace

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (block_window,
                                                      merge_blocks)
    from repro_torch.models import layers

    cfg = get_config(DEEPSEEK_ARCH)
    a, h = cfg.mla, cfg.n_heads
    b, t, valid = (MLA_BLOCK_CASE[k] for k in ("batch", "t", "valid"))
    gen = torch.Generator(device=dev).manual_seed(9)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen)
                * scale).to(torch.bfloat16)
    p = SimpleNamespace(cfg=cfg, wkv_b=randn(
        a.kv_lora_rank, h * (a.nope_head_dim + a.v_head_dim),
        scale=a.kv_lora_rank ** -0.5))
    q_nope, q_rope = randn(b, 1, h, a.nope_head_dim), randn(
        b, 1, h, a.rope_head_dim)
    latent, k_rope = randn(b, t, a.kv_lora_rank), randn(b, t, a.rope_head_dim)
    n = t // SPLIT_MODEL
    scale = layers._mla_scale(a)

    def whole():
        return layers.mla_absorbed_decode(p, q_nope, q_rope, latent, k_rope,
                                          valid_len=valid)

    def split(merge=merge_blocks):
        wk_abs, wv_abs = layers._absorbed(p)
        q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(), wk_abs)
        ctxs, lses = [], []
        for i in range(SPLIT_MODEL):
            r, _ = block_window(valid, i * n, n)
            ctx, lse = layers.mla_block_decode(
                q_lat, q_rope[:, 0].float(), latent[:, i * n:i * n + r],
                k_rope[:, i * n:i * n + r], scale=scale)
            ctxs.append(ctx)
            lses.append(lse)
        ctx = merge(torch.stack(ctxs), torch.stack(lses))
        return torch.einsum("bhr,rhd->bhd", ctx, wv_abs).reshape(b, 1, -1)

    with torch.no_grad():
        want, got = whole(), split()
        control = split(lambda ctx, lse: ctx.mean(0))
        bound = MLA_BLOCK_RTOL * float(want.abs().max())
        err = float((got - want).abs().max())
        share = err / bound
        cshare = float((control - want).abs().max()) / bound
        assert got.shape == want.shape == (b, 1, h * a.v_head_dim)
        assert bool(torch.isfinite(got).all())
        assert share <= 1.0, f"MLA block decode: {share} of the bound"
        assert cshare >= 10.0, f"the mean-merged blocks pass: {cshare}"
        row = dict(blocks=SPLIT_MODEL, rows_a_block=n, valid_len=valid,
                   heads=h, r=a.kv_lora_rank, dr=a.rope_head_dim, batch=b,
                   max_abs_err=err, tolerance=f"{MLA_BLOCK_RTOL} max|whole|",
                   bound_share=share, control="the blocks' contexts "
                   "averaged", control_share=cshare,
                   ms=time_ms(split, flush=flush, spin=True),
                   whole_ms=time_ms(whole, flush=flush, spin=True))
    log(f"mla block decode over {SPLIT_MODEL} blocks of {n} rows: "
        f"{json.dumps(row)}")
    return row


# ---------------------------------------------------------------------------
# 4. the grouped matmul
# ---------------------------------------------------------------------------

def _gmm_share(got, plain, tol) -> float:
    """Largest share of ``ref.gmm_tolerance`` used; where the bound is 0
    (a zero row of x) the kernel must give exactly 0."""
    diff = (got.float() - plain.float()).abs()
    assert bool((diff[tol == 0] == 0).all()), "gmm: nonzero out of a zero row"
    return float((diff / tol.clamp_min(1e-38)).max())


def _gmm_work(x, w, ids) -> tuple[float, float]:
    """(bytes, operations) of one gmm call (``kernels.work.gmm_work``: x
    read and the output written once, each group's weights that some tile
    uses read once; 2 d operations per output element)."""
    from repro_torch.kernels import work
    n, d = x.shape
    return work.gmm_work(n, d, w.shape[2], int(ids.unique().numel()),
                         x.element_size(), w.element_size())


def _gmm_ids(kind: str, groups: int, tiles: int, gen, dev):
    import torch
    if kind == "capacity":         # the MoE buffers: each expert's tiles
        return torch.arange(tiles, device=dev, dtype=torch.int32) \
            // (tiles // groups)
    if kind == "shuffled":         # every group, some repeated, shuffled
        ids = torch.cat([torch.arange(groups, device=dev), torch.randint(
            0, groups, (tiles - groups,), device=dev, generator=gen)])
        return ids[torch.randperm(tiles, device=dev, generator=gen)].int()
    # only the odd groups have tiles
    return (2 * torch.randint(0, groups // 2, (tiles,), device=dev,
                              generator=gen) + 1).int()


def sass_counts(name: str) -> dict:
    """Counts of the tensor-core, TMA and reduction instructions in the
    SASS of the built library of ``csrc/<name>.cu``: ``HGMMA`` (wgmma),
    ``UTMALDG`` (TMA tile loads), ``HMMA`` (mma.sync), ``UBLKCP.S.G`` (1-D
    bulk copies from global to shared memory) and ``REDG.E.ADD.F32x4``
    (``red.global.add.v4.f32``: four float32 adds in one reduction)."""
    import re

    from repro_torch.kernels import _build
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(_build._target(name))], check=True,
                          capture_output=True, text=True).stdout
    return {op: len(re.findall(rf"\b{re.escape(op)}\b", sass))
            for op in ("HGMMA", "UTMALDG", "HMMA", "UBLKCP.S.G",
                       "REDG.E.ADD.F32x4")}


def gmm_phase(dev) -> dict:
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.gmm import gmm

    sass = sass_counts("gmm")
    log(f"kernel gmm SASS instructions: {json.dumps(sass)}")
    assert sass["HGMMA"] > 0 and sass["UTMALDG"] > 0, sass
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    for name, groups, tiles, d, f, bn, kind, dt in GMM_CASES:
        dtype = getattr(torch, dt)
        x = torch.randn((tiles * bn, d), device=dev, generator=gen).to(dtype)
        # every expert drawn on its own: a tile reading the wrong one shows
        w = (torch.randn((groups, d, f), device=dev, generator=gen)
             / d ** 0.5).to(dtype)
        ids = _gmm_ids(kind, groups, tiles, gen, dev)
        got = gmm(x, w, ids, block_n=bn)
        plain = ref.gmm_ref(x, w, ids, block_n=bn)
        tol = ref.gmm_tolerance(x, w, ids, plain, block_n=bn)
        torch.cuda.synchronize()
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        share = _gmm_share(got, plain, tol)
        err = float((got.float() - plain.float()).abs().max())
        assert share <= 1.0, f"gmm {name}: {share} of the bound"
        log(f"kernel gmm {name} x={tuple(x.shape)} w={tuple(w.shape)} "
            f"block_n={bn} {dt}: max_abs_err={err!r}, bound share {share!r}")
        if name in GMM_FAULT_CASES:
            # planted faults, made by the kernel itself: one tile given the
            # next expert's id; the reduction without its last 512 of d
            bad = ids.clone()
            bad[tiles // 2] = (bad[tiles // 2] + 1) % groups
            faults = {"one tile reads the next expert": gmm(
                x, w, bad, block_n=bn), f"reduction drops its last "
                f"{GMM_DROP} of d": gmm(x[:, :-GMM_DROP].contiguous(),
                                        w[:, :-GMM_DROP].contiguous(), ids,
                                        block_n=bn)}
            for fault, cut in faults.items():
                fshare = _gmm_share(cut, plain, tol)
                log(f"kernel gmm {name} planted fault ({fault}): bound "
                    f"share {fshare!r}")
                assert fshare > 10.0, f"the gmm check passes: {fault}"
            del faults, cut, bad
        if kind == "capacity":
            nbytes, ops = _gmm_work(x, w, ids)
            tb = bound(nbytes, ops, BF16_OPS_PER_S)
            x3 = x.view(groups, -1, d)     # the reference einsum's layout
            ms = time_ms(lambda: gmm(x, w, ids, block_n=bn), spin=True)
            lib_ms = time_ms(lambda: torch.bmm(x3, w), spin=True)
            row = dict(
                max_abs_err=err, tolerance=GMM_TOL, bound_share=share,
                ms=ms, tflop_per_s=ops / ms / 1e9, tb_per_s=nbytes / ms / 1e9,
                plain_ms=time_ms(lambda: ref.gmm_ref(x, w, ids, block_n=bn),
                                 reps=3, warmup=1),
                library_ms=lib_ms, library_tflop_per_s=ops / lib_ms / 1e9,
                bound_ms=tb[0], bound_by=tb[1], block_n=bn,
                rows_per_expert=tiles // groups * bn)
            rows[name] = row
            log(f"kernel gmm {name}: {json.dumps(row)}")
            del x3
        del x, w, ids, got, plain, tol
    torch.cuda.empty_cache()
    return rows


# the sLSTM recurrence (xlstm-350m: d 1,024, bf16) against its plain loop:
# the served prefill (B 4 x 4,096 tokens, from a zero state), a decode step
# (S 1, from a random state) and the float32 SMOKE width (d 64).  xw is the
# input product's scale (unit normal: the normed x times w_in), w_rec the
# model's 0.02, the bias 0.3 N(0, 1) (the model's is zero: this exercises
# the pre-activation's last rounding too)
XLSTM_D = 1024
SLSTM_CASES = [  # name, B, S, d, dtype, the state it starts from
    ("served prefill", 4, 4096, XLSTM_D, "bfloat16", "zero"),
    ("decode step", 4, 1, XLSTM_D, "bfloat16", "random"),
    ("smoke float32", 4, 256, 64, "float32", "random"),
]
SLSTM_TOL = ("per element: ref.slstm_tolerance (each of z, i, f, o's "
             "pre-activation moves by the smaller of the interval its three "
             "roundings give the float32 product moved by its reordering "
             "and by the runs' h apart, and a step of x's dtype at each "
             "rounding; carried through the cell and the state to first "
             "order, twice)")
SLSTM_FAULT = "the plain scan without the recurrent product at step S/2"
SLSTM_LOW_SUM = "the plain scan with the recurrent product summed in bf16"
SLSTM_STALE = ("the kernel rebuilt to read the exchange buffer's other half "
               "(h from two steps back)")


def _slstm_inputs(dev, gen, b, s, d, dtype, state):
    import torch
    t = getattr(torch, dtype)

    def randn(shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(t)
    xw, w, bias = randn((b, s, 4 * d)), randn((d, 4 * d), 0.02), \
        randn((4 * d,), 0.3)
    f32 = dict(dtype=torch.float32, device=dev)
    if state == "zero":
        st = {k: torch.zeros((b, d), **f32) for k in "cnh"}
        st["m"] = torch.full((b, d), -1e30, **f32)
    else:
        st = {"c": 0.5 * torch.randn((b, d), generator=gen, **f32),
              "n": 1 + 2 * torch.rand((b, d), generator=gen, **f32),
              "h": 0.3 * torch.randn((b, d), generator=gen, **f32),
              "m": torch.randn((b, d), generator=gen, **f32) - 1}
    return xw, w, bias, st


def _slstm_work(b, s, d, dtype) -> tuple[float, float, float]:
    """(bytes, operations, the operations' peak rate) of one call
    (``kernels.work.slstm_work``): the recurrent product's operations at
    the inputs' type's peak (bf16 on the tensor cores, float32 outside
    them)."""
    from repro_torch.kernels import work
    nbytes, ops = work.slstm_work(b, s, d, 2 if dtype == "bfloat16" else 4)
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else F32_OPS_PER_S
    return nbytes, ops, rate


def slstm_phase(dev) -> dict:
    """``slstm_scan`` held against ``slstm_scan_ref`` per element within
    ``ref.slstm_tolerance`` at ``SLSTM_CASES`` (hs and the final state),
    with two planted faults that must fail the check by 10x (the product
    dropped at one step, the product summed in bf16) and, at the served
    prefill, a third (the kernel rebuilt to read the stale half of its
    exchange buffer) and two calls that must agree bit for bit; the
    library's SASS must hold ``HMMA`` (the bf16 product on the tensor
    cores).  Timed at the served prefill and decode shapes beside the plain
    loop and, where ``build/parent`` holds a checkout of the parent, beside
    the parent's kernel and its exchange-only probe (``grid_barrier_chain
    _ms``; the grid-barrier design's chain for a parent of that design), each
    launched through the interface the parent's source declares
    (``slstm_timing.parent_interface``), with the bytes and operations
    bounds, the chain bound
    (S one-way trips of a flag between two SMs, from a ping-pong probe),
    the exchange alone (the kernel rebuilt with the step's product replaced
    by nothing) and the host's microseconds per call at S 1."""
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.slstm import default_units, launch, slstm_scan
    sys.path.insert(0, str(ROOT / "dev"))
    from slstm_timing import (PROBE, STALE_HALF, build_variants,
                              parent_interface, parent_launch, parent_units,
                              pingpong)

    sass = sass_counts("slstm")
    log(f"kernel slstm_scan SASS instructions: {json.dumps(sass)}")
    assert sass["HMMA"] > 0, sass
    shipped = _build.CSRC / "slstm.cu"
    variants = {"exchange": (shipped, [PROBE]),
                "stale half": (shipped, [STALE_HALF])}
    parent = ROOT / "build" / "parent" / "src" / "repro_torch" / "kernels" \
        / "csrc" / "slstm.cu"
    if parent.exists():   # its kernel, and its exchange-only probe
        log(f"kernel slstm_scan parent interface: "
            f"{parent_interface(parent)}")      # raises on an unknown one
        variants["parent"] = (parent, [])
        variants["parent exchange"] = (parent, [PROBE])
    libs = build_variants(variants)
    trip = pingpong(dev)
    log(f"kernel slstm_scan flag ping-pong between two SMs: "
        f"{json.dumps(trip)}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def over(x, tol) -> float:      # a NaN counts as out of any bound
        return float((x / tol).nan_to_num(nan=float("inf")).max())

    gen = torch.Generator(device=dev).manual_seed(5)
    rows, row = {}, {}
    for name, b, s, d, dt, init in SLSTM_CASES:
        xw, w, bias, st = _slstm_inputs(dev, gen, b, s, d, dt, init)
        got, fin = slstm_scan(xw, w, bias, st)
        plain, pfin = ref.slstm_scan_ref(xw, w, bias, st)
        tol, tol_st = ref.slstm_tolerance(xw, w, bias, st)
        bad, _ = ref.slstm_scan_ref(xw, w, bias, st, drop_rec_at=s // 2)
        low, _ = ref.slstm_scan_ref(xw, w, bias, st, bf16_sum=True)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        share = float(((got - plain).abs() / tol).max())
        state_share = {k: float(((fin[k] - pfin[k]).abs() / tol_st[k]).max())
                       for k in fin}
        fault = float(((got - bad).abs() / tol).max())
        low_share = float(((got - low).abs() / tol).max())
        case = dict(shape=[b, s, d], dtype=dt, state=init,
                    max_abs_err=float((got - plain).abs().max()),
                    tolerance=SLSTM_TOL, bound_share=share,
                    state_bound_share=state_share, planted_fault=SLSTM_FAULT,
                    fault_bound_share=fault, low_sum_control=SLSTM_LOW_SUM,
                    low_sum_bound_share=low_share)
        if name == "served prefill":
            units = default_units(d, sms, xw.dtype)
            again, fin2 = slstm_scan(xw, w, bias, st)
            stale, _ = launch(libs["stale half"], xw, w, bias, st, units)
            torch.cuda.synchronize()
            case.update(
                bit_identical=bool(torch.equal(got, again) and all(
                    torch.equal(fin[k], fin2[k]) for k in fin)),
                stale_half_fault=SLSTM_STALE,
                stale_half_bound_share=over((stale - plain).abs(), tol))
            del again, fin2, stale
        log(f"kernel slstm_scan {name}: {json.dumps(case)}")
        assert share <= 1.0, f"slstm_scan {name}: {share} of the bound"
        assert max(state_share.values()) <= 1.0, state_share
        assert fault >= 10.0, f"the slstm check passes: {SLSTM_FAULT}"
        assert low_share >= 10.0, f"the slstm check passes: {SLSTM_LOW_SUM}"
        if name == "served prefill":
            assert case["bit_identical"], "two slstm_scan calls differ"
            assert case["stale_half_bound_share"] >= 10.0, \
                f"the slstm check passes: {SLSTM_STALE}"
            nbytes, ops, rate = _slstm_work(b, s, d, dt)
            tb = bound(nbytes, ops, rate)
            ms = time_ms(lambda: slstm_scan(xw, w, bias, st), spin=True)
            row = dict(case, ms=ms, us_per_step=ms / s * 1e3,
                       plain_ms=time_ms(lambda: ref.slstm_scan_ref(
                           xw, w, bias, st), reps=3, warmup=1),
                       bound_ms=tb[0], bound_by=tb[1],
                       bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       operations_bound_ms=ops / rate * 1e3,
                       chain_bound_ms=s * trip["one_way_ns"] * 1e-6,
                       chain_bound="S one-way trips of a flag between two "
                       "SMs through L2 (half a ping-pong round trip)",
                       exchange_probe_ms=time_ms(lambda: launch(
                           libs["exchange"], xw, w, bias, st, units),
                           spin=True),
                       units=units, blocks=d // units, library_ms=None,
                       library_call="none: torch.nn.LSTM and cuDNN compute "
                       "another cell (sigmoid input gate, no stabiliser m)")
            if "parent" in libs:   # in turns: parent, this, this, parent
                pu = parent_units(parent, units)

                def par():
                    return parent_launch(libs["parent"], xw, w, bias, st, pu,
                                         parent)
                assert over((par()[0] - plain).abs(), tol) <= 1.0
                p0 = time_ms(par, spin=True)
                m1 = time_ms(lambda: slstm_scan(xw, w, bias, st), spin=True)
                m2 = time_ms(lambda: slstm_scan(xw, w, bias, st), spin=True)
                p1 = time_ms(par, spin=True)
                row.update(parent_ms=[p0, p1], turns_ms=[m1, m2],
                           parent_units=pu, grid_barrier_chain_ms=time_ms(
                               lambda: parent_launch(libs["parent exchange"],
                                                     xw, w, bias, st, pu,
                                                     parent),
                               spin=True))
        elif name == "decode step":
            nbytes, ops, rate = _slstm_work(b, s, d, dt)
            row.update(
                decode_ms=time_ms(lambda: slstm_scan(xw, w, bias, st),
                                  spin=True),
                decode_plain_ms=time_ms(lambda: ref.slstm_scan_ref(
                    xw, w, bias, st), spin=True),
                decode_bound_ms=bound(nbytes, ops, rate)[0],
                host_us_per_call=_host_us(
                    [lambda: slstm_scan(xw, w, bias, st)] * 200))
            if "parent" in libs:
                def par():
                    return parent_launch(libs["parent"], xw, w, bias, st,
                                         parent_units(parent, units), parent)
                row.update(decode_parent_ms=time_ms(par, spin=True))
        del xw, w, bias, st, got, plain, tol, bad, low
    log(f"kernel slstm_scan: {json.dumps(row)}")
    torch.cuda.empty_cache()
    rows["slstm_scan"] = row
    return rows


# ---------------------------------------------------------------------------
# 6-7. serve phases
# ---------------------------------------------------------------------------

# Logit tolerance of the serve phase, in bf16 steps at the largest logit.
# The kernel run and the plain run are one bf16 network on one input; only
# the attention differs, each output within about one bf16 step of the
# other (the kernel phase's bound), and 48 layers carry those steps on.
# On the H100 the correct runs read at most 5.5 steps (0.172 at a largest
# logit of 7.5); the control whose decode drops its newest 32 positions
# read 1.20 at its smallest nonzero step and 3.37 at its largest.  10 steps
# (0.3125 there) lies between.  The control with S and P in bf16 read 0.1875,
# within the correct runs' spread: the logits cannot tell that fault from a
# correct kernel, so the kernel phase's sharp-score cases must.
LOGIT_TOL_STEPS = 10
MUST_FAIL_CONTROL = "decode drops its newest 32 positions"
# The prefill's control (set before any card run; at step 0 it must miss
# the same check): the plain flash with its causal diagonal one column
# late, each end-aligned row also seeing the position after it, the
# end-alignment fault a flash kernel is most likely to have.  A CPU
# emulation at d_model 512-2,048 over 1,024 positions
# (dev/prefill_control_probe.py) read 14-35 bf16 steps at 8 layers, 62 at
# 20, 113 at 48 and 25 at 88 (GELU), the bf16 S and P control 2.0-5.3; on
# the H100 it read 24.9-94.3 steps (2.49x the bound at Llama-3's 8 layers,
# 9.43x at Qwen2.5-14B's 48)
PREFILL_CONTROL = "prefill's causal diagonal one column late"


def _late_diagonal_flash(q, k, v, *, causal=True, scale=None, window=0):
    """A faulty plain flash for the prefill control: row ``r`` (end-aligned,
    ``i + Skv - Sq``) attends columns ``c <= r + 1``, and with a window
    ``r - c < window``; float32 math in the plain flash's blocks of query
    rows."""
    import torch

    from repro_torch.kernels.ref import FLASH_REF_LOGITS, MASKED
    bhq, sq, d = q.shape
    skv = k.shape[1]
    g = bhq // k.shape[0]
    k, v = (x.repeat_interleave(g, dim=0).float() for x in (k, v))
    block = max(1, min(sq, FLASH_REF_LOGITS // (bhq * skv)))
    cols = torch.arange(skv, device=q.device)[None]
    out = []
    for i0 in range(0, sq, block):
        qb = q[:, i0:i0 + block]
        s = torch.einsum("bqd,bkd->bqk", qb.float(), k) * (scale or d ** -0.5)
        rows = torch.arange(i0, i0 + qb.shape[1],
                            device=q.device)[:, None] + (skv - sq)
        mask = cols <= rows + 1
        if window:
            mask &= rows - cols < window
        p = torch.softmax(torch.where(mask[None], s, MASKED), dim=-1)
        out.append(torch.einsum("bqk,bkd->bqd", p, v).to(q.dtype))
    return torch.cat(out, dim=1)


def _bf16_flash(q, k, v, *, causal=True, scale=None, window=0):
    """A faulty plain flash for the control run: S and P rounded to bf16."""
    import torch
    bhq, sq, d = q.shape
    g = bhq // k.shape[0]
    k, v = (x.repeat_interleave(g, dim=0).bfloat16() for x in (k, v))
    s = torch.einsum("bqd,bkd->bqk", q.bfloat16(), k) * (scale or d ** -0.5)
    if causal:
        mask = _window_mask(sq, k.shape[1], window or k.shape[1], q.device)
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s.float(), dim=-1).bfloat16()
    return torch.einsum("bqk,bkd->bqd", p, v).to(q.dtype)


def _bf16_decode(q, k, v, valid_len, *, scale=None, window=0):
    """A faulty plain decode for the control run: S and P rounded to bf16."""
    import torch
    b, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).bfloat16()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.bfloat16()) * (scale or d ** -0.5)
    pos = torch.arange(k.shape[1], device=q.device)
    s = torch.where((pos < valid_len) & (pos >= valid_len - (window or valid_len)),
                    s, -1e30)
    p = torch.softmax(s.float(), dim=-1).bfloat16()
    out = torch.einsum("bkgt,btkd->bkgd", p, v.bfloat16())
    return out.reshape(b, h, d).to(q.dtype)


def _control_diffs(serve, arch, kw, gen, plain_logits, flash, decode
                   ) -> list:
    """Largest logit difference per step of a teacher-forced run of
    ``arch`` on faulty plain attention (``flash``, ``decode`` stand in for
    the plain versions) against the plain run's logits; ``serve`` is
    ``serve`` or :func:`_embeds_serve`."""
    import torch

    from repro_torch.kernels import ref
    saved = ref.flash_attention_ref, ref.decode_attention_ref
    ref.flash_attention_ref, ref.decode_attention_ref = flash, decode
    try:
        _, run = serve(arch, use_kernel=False, forced=gen, **kw)
    finally:
        ref.flash_attention_ref, ref.decode_attention_ref = saved
    logits = torch.stack(run.logits).float()
    return (logits - plain_logits).abs().amax(dim=(1, 2)).tolist()


def _first_token_margins(plain_first, kernel_first, plain_tok, kernel_tok
                         ) -> dict:
    """Per row of the first step's logits (``[B, vocab]`` of the plain and
    the kernel run): how far the plain run's top logit leads its second
    (``plain_top2_gap``), and by how much the plain run prefers its own
    first token to the kernel run's (``plain_lead_over_kernel_token``, 0
    where they agree); the same two tokens in the kernel run's logits."""
    import torch
    top2 = torch.topk(plain_first, 2, dim=-1).values
    rows = torch.arange(plain_first.shape[0], device=plain_first.device)
    p, k = (torch.as_tensor(t, dtype=torch.long, device=rows.device)
            for t in (plain_tok, kernel_tok))
    return dict(
        plain_top2_gap=(top2[:, 0] - top2[:, 1]).tolist(),
        plain_lead_over_kernel_token=(plain_first[rows, p]
                                      - plain_first[rows, k]).tolist(),
        kernel_lead_over_plain_token=(kernel_first[rows, k]
                                      - kernel_first[rows, p]).tolist())


# A dense-serve row whose first generated token differs from the plain
# run's passes only in a measured tie: the kernel run's logits for the two
# tokens are equal (argmax takes the lower id), and the plain run prefers
# its own by at most this many bf16 steps at the largest logit.
FIRST_TOKEN_TIE_STEPS = 2


def _check_first_tokens(first_agree, margins, step: float) -> None:
    """Every row's first generated token must be the plain run's, except
    in a measured tie (``FIRST_TOKEN_TIE_STEPS``); both runs' margins are
    in the logged line."""
    limit = FIRST_TOKEN_TIE_STEPS * step
    lead = margins["plain_lead_over_kernel_token"]
    own = margins["kernel_lead_over_plain_token"]
    for row, (agree, gap, margin) in enumerate(zip(first_agree, lead, own)):
        assert agree or (margin == 0 and gap <= limit), (
            f"row {row}: first generated token differs from plain, which "
            f"prefers its own by {gap} (tie limit {limit}); the kernel run "
            f"prefers its own by {margin} (tie: 0)")


# Pixtral-12B and MusicGen-large take embeddings in the reference's step
# cells: each is also served from its stub frontend's embeddings of the
# prompts (a prefill into a fresh cache, then greedy steps from tokens),
# drawn on the card from a generator seeded from the traffic's seed
EMBEDS = {"pixtral-12b": "patches", "musicgen-large": "frames"}
PATCH_DIM = 768                      # 16 x 16 x 3: 1,024 patches of 512 x 512
CODEBOOKS = 4


def _frontend_embeds(cfg, traffic: dict, dev):
    """``[B, S, d_model]`` embeddings of ``traffic``'s prompts from the
    port's stub frontend of ``cfg``'s modality: Pixtral's patch projection
    of random 16 x 16 x 3 patches, MusicGen's summed tables of 4 random
    codebooks."""
    import torch

    from repro_torch.models import frontends
    gen = torch.Generator(device=dev).manual_seed(traffic["seed"])
    b, s = traffic["batch"], traffic["prompt_len"]
    if cfg.modality == "vlm":
        front = frontends.init_patch_frontend(gen, cfg, PATCH_DIM)
        patches = torch.randn((b, s, PATCH_DIM), generator=gen, device=dev)
        return frontends.patch_embed(front, patches.to(front["proj"].dtype))
    front = frontends.init_frame_frontend(gen, cfg, CODEBOOKS)
    codes = torch.randint(0, cfg.vocab, (b, s, CODEBOOKS), generator=gen,
                          device=dev)
    return frontends.frame_embed(front, codes)


def _embeds_serve(arch: str, *, params, embeds, max_len: int, gen_len: int,
                  use_kernel: bool = True, forced=None, **_):
    """What ``serve`` does, from ``embeds [B, S, D]`` in place of the
    prompts' tokens: the prefill into a fresh cache
    (``lm.forward(embeds=...)``), then ``gen_len`` greedy steps from tokens
    (``lm.serve_step``), ``forced`` feeding its tokens instead.  Returns
    ``(tokens [B, gen_len], ServeStats)``; takes ``serve``'s other keywords
    and ignores them."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import ServeStats
    from repro_torch.models import lm
    assert params.cfg.name == arch
    b, dev = embeds.shape[0], embeds.device
    stats = ServeStats(0.0, 0.0, b * gen_len)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = lm.init_cache(params.cfg, b, max_len, device=dev)
        logits, cache, _ = lm.forward(params, embeds=embeds, cache=cache,
                                      use_kernel=use_kernel)
        stats.logits.append(logits[:, -1].clone())
        del logits
        torch.cuda.synchronize()
        stats.prefill_s = time.perf_counter() - t0
        out = []
        tok = stats.logits[-1].argmax(-1).to(torch.int32)[:, None]
        t0 = time.perf_counter()
        for i in range(gen_len):
            out.append(tok)
            step_in = tok if forced is None else torch.from_numpy(
                np.asarray(forced[:, i:i + 1], np.int32)).to(dev)
            logits, cache = lm.serve_step(params, cache, tokens=step_in,
                                          use_kernel=use_kernel)
            stats.logits.append(logits[:, -1].clone())
            tok = stats.logits[-1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        stats.decode_s = time.perf_counter() - t0
    return torch.cat(out, dim=1).cpu().numpy(), stats


def _held_to_plain(serve, arch: str, kw: dict, cfg, controls: dict) -> dict:
    """One kernel run of ``serve(arch, **kw)`` (``serve`` or
    :func:`_embeds_serve`), every launch counter zeroed just before and
    read just after (flash once a layer in the prefill, decode once a layer
    a step, nothing else), against the plain versions' run teacher-forced
    on its tokens, and each of ``controls`` (``{name: (flash, decode)}``,
    faulty plain versions) on the same tokens: the logged numbers and the
    checks' inputs."""
    import numpy as np
    import torch

    from repro_torch.kernels import KERNELS
    gen_len = kw["gen_len"]
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    gen, stats = serve(arch, **kw)
    counts = {k.__name__: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = {k.__name__: 0 for k in KERNELS}
    want["flash_attention"] = cfg.n_layers                      # the prefill
    want["decode_attention"] = cfg.n_layers * gen_len           # the steps
    assert counts == want, counts
    logits = torch.stack(stats.logits).float()
    assert gen.shape == (kw["batch"], gen_len)
    assert logits.shape == (gen_len + 1, kw["batch"], cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert ((gen >= 0) & (gen < cfg.vocab)).all()

    # the yardstick: the plain versions, fed the kernel run's tokens
    for k in KERNELS:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    plain_gen, plain = serve(arch, use_kernel=False, forced=gen, **kw)
    assert all(k.launches == 0 for k in KERNELS)
    plain_logits = torch.stack(plain.logits).float()
    diffs = (logits - plain_logits).abs().amax(dim=(1, 2)).tolist()
    top = float(logits.abs().max())
    step = 2.0 ** (np.floor(np.log2(top)) - 7)         # bf16 step at |top|
    tol = LOGIT_TOL_STEPS * step
    first_agree = np.asarray(plain_gen[:, 0] == gen[:, 0]).tolist()
    margins = _first_token_margins(plain_logits[0], logits[0],
                                   plain_gen[:, 0], gen[:, 0])
    # the controls: how far a wrong attention moves the same logits
    diffs_c = {c: _control_diffs(serve, arch, kw, gen, plain_logits, *fns)
               for c, fns in controls.items()}
    plain_peak = torch.cuda.max_memory_allocated()     # plain and controls
    return dict(
        prefill_s=stats.prefill_s, decode_s=stats.decode_s,
        decode_tokens_per_s=stats.tokens_per_s,
        decode_step_ms=stats.decode_s / gen_len * 1e3,
        plain_prefill_s=plain.prefill_s,
        plain_decode_tokens_per_s=plain.tokens_per_s,
        peak_device_bytes=peak, plain_peak_device_bytes=plain_peak,
        launches=counts,
        max_logit_diff_per_step=diffs, max_abs_logit=top, bf16_step=step,
        logit_tol=tol, first_token_agrees=first_agree,
        first_tokens=gen[:, 0].tolist(), first_token_margins=margins,
        control_max_logit_diff={c: max(d) for c, d in diffs_c.items()},
        control_over_bound={c: max(d) / tol for c, d in diffs_c.items()},
        control_step0_over_bound={c: d[0] / tol for c, d in diffs_c.items()},
        control_diff_per_step=diffs_c)


def _check_held(out: dict, tag: str) -> None:
    """The checks of a :func:`_held_to_plain` run: the first tokens (the
    tie rule), every step's logits within ``LOGIT_TOL_STEPS`` of the plain
    run's, the decode control missing that at some step and the prefill
    control (where it ran) at step 0."""
    _check_first_tokens(out["first_token_agrees"], out["first_token_margins"],
                        out["bf16_step"])
    diffs, tol = out["max_logit_diff_per_step"], out["logit_tol"]
    assert max(diffs) <= tol, \
        f"{tag}: logits differ from plain by {max(diffs)} > {tol}"
    assert out["control_max_logit_diff"][MUST_FAIL_CONTROL] > tol, \
        f"{tag}: control {MUST_FAIL_CONTROL!r} passes the logit check"
    steps = out["control_diff_per_step"]
    if PREFILL_CONTROL in steps:
        assert steps[PREFILL_CONTROL][0] > tol, \
            f"{tag}: control {PREFILL_CONTROL!r} passes the check at step 0"


def dense_serve_phase(dev, profile_dir: Path | None, arch: str = SERVE_ARCH,
                      layers: int | None = None, traffic: dict = SERVE
                      ) -> dict:
    """``serve`` on dense model ``arch`` at full width (its first
    ``layers`` layers; all by default) on ``traffic``: weights made on the
    card from the seed, one warm-up serve of 2 tokens, then the kernel run
    held to the plain run (:func:`_held_to_plain`) with the decode control
    and the prefill control, which must each miss the logit check (and,
    for Qwen2.5-14B, the informational bf16 S and P control); a model fed
    embeddings in the reference's step cells (``EMBEDS``) is then served
    from its frontend's embeddings alike (the decode control).  Qwen2.5-14B
    is also counted for the dry run; ``profile_dir`` traces the prefill and
    4 steps."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    whole = get_config(arch)
    cfg = whole if layers in (None, whole.n_layers) else \
        dataclasses.replace(whole, n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=traffic["seed"], device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    depth = f"{cfg.n_layers}" + ("" if cfg is whole else
                                 f" of {whole.n_layers}")
    log(f"serve weights: {arch} {depth} layers, {n_params} parameters "
        f"({cfg.num_params()} in its matrices; {w_bytes / 1e9:.2f} GB "
        f"{cfg.dtype}), made on the card in {init_s:.2f} s")
    kw = dict(smoke=False, device=dev, params=params, **traffic)
    # warm cuBLAS and the kernels at the run's shapes (not counted)
    serve(arch, **dict(kw, gen_len=2))
    torch.cuda.synchronize()

    plain_decode = ref.decode_attention_ref

    def dropping(q, k, v, n, scale=None, window=0):   # MUST_FAIL_CONTROL
        return plain_decode(q, k, v, n - 32, window=window)
    controls = {MUST_FAIL_CONTROL: (ref.flash_attention_ref, dropping),
                PREFILL_CONTROL: (_late_diagonal_flash, plain_decode)}
    if arch == SERVE_ARCH:
        controls["S and P in bf16"] = (_bf16_flash, _bf16_decode)
    out = dict(layers=cfg.n_layers, parameters=n_params, weight_bytes=w_bytes,
               init_s=init_s, init_peak_device_bytes=init_peak,
               **_held_to_plain(serve, arch, kw, cfg, controls))
    log(f"serve {arch} batch={traffic['batch']} "
        f"prompt={traffic['prompt_len']} gen={traffic['gen_len']}: "
        f"{json.dumps(out)}")
    _check_held(out, f"serve {arch}")
    if arch == SERVE_ARCH:
        _dense_serve_counts(params, cfg, dev)  # the dry run's check (8)
    if arch in EMBEDS:
        ekw = dict(kw, embeds=_frontend_embeds(cfg, traffic, dev))
        out["embeds"] = dict(frontend=EMBEDS[arch], **_held_to_plain(
            _embeds_serve, arch, ekw, cfg,
            {MUST_FAIL_CONTROL: controls[MUST_FAIL_CONTROL]}))
        log(f"serve {arch} from {EMBEDS[arch]} batch={traffic['batch']} "
            f"prompt={traffic['prompt_len']} gen={traffic['gen_len']}: "
            f"{json.dumps(out['embeds'])}")
        _check_held(out["embeds"], f"serve {arch} from {EMBEDS[arch]}")
        del ekw
    if profile_dir is not None:
        _profile_serve(params, cfg, dev, profile_dir,
                       tag="" if arch == SERVE_ARCH else f"{arch}_")
    del params, kw
    torch.cuda.empty_cache()
    return out


# The sliding-window slice: Hymba-1.5B at full width and depth (32 layers,
# 29 with a window of 1,024, 0 / 15 / 31 global), prompts long enough for
# the window to bite
HYMBA_ARCH = "hymba-1.5b"
HYMBA = dict(batch=4, prompt_len=4096, gen_len=32, max_len=4160, seed=0)
HYMBA_CHUNK = 2048                   # the appended prefill: two chunks
HYMBA_CONTROL = "plain attention with the window off in the 29 SWA layers"


def _logit_step(logits) -> float:
    """The bf16 step at the largest |logit|."""
    import numpy as np
    return float(2.0 ** (np.floor(np.log2(float(logits.abs().max()))) - 7))


def hymba_serve_phase(dev, profile_dir: Path | None) -> dict:
    """``serve`` on Hymba-1.5B: the windowed flash and decode kernels and
    the Mamba mixer's torch ops, held against the plain versions' run; a
    control with the window off must fail that check; a prefill appended
    to the cache in two chunks runs on the flash kernel."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve import serve
    from repro_torch.models import layers, lm

    cfg = get_config(HYMBA_ARCH)
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=HYMBA["seed"], device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    windows = [blk.mixer.attn.window for blk in params.blocks]
    swa = [i for i, w in enumerate(windows) if w]
    assert len(swa) == cfg.n_layers - len(cfg.global_attn_layers) and \
        {windows[i] for i in swa} == {cfg.sliding_window}, windows
    log(f"hymba weights: {HYMBA_ARCH} {cfg.n_layers} layers ({len(swa)} with "
        f"window {cfg.sliding_window}), {n_params} parameters "
        f"({w_bytes / 1e9:.2f} GB {cfg.dtype}), made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    kw = dict(smoke=False, device=dev, params=params, **HYMBA)
    serve(HYMBA_ARCH, **dict(kw, prompt_len=256, gen_len=2))   # warm
    torch.cuda.synchronize()

    def zero():
        for k in KERNELS:
            k.launches = 0

    def counted():
        return {k.__name__: k.launches for k in KERNELS}

    torch.cuda.reset_peak_memory_stats()
    zero()                                # the serving path, counted alone
    gen, stats = serve(HYMBA_ARCH, **kw)
    counts = counted()
    peak = torch.cuda.max_memory_allocated()
    want = {k.__name__: 0 for k in KERNELS}
    want["flash_attention"] = cfg.n_layers                      # the prefill
    want["decode_attention"] = cfg.n_layers * HYMBA["gen_len"]   # the steps
    assert counts == want, counts
    logits = torch.stack(stats.logits).float()
    assert gen.shape == (HYMBA["batch"], HYMBA["gen_len"])
    assert logits.shape == (HYMBA["gen_len"] + 1, HYMBA["batch"], cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert ((gen >= 0) & (gen < cfg.vocab)).all()

    # the yardstick: the plain versions, fed the kernel run's tokens (the
    # plain flash works through query blocks at 4,096 tokens)
    zero()
    torch.cuda.reset_peak_memory_stats()
    plain_gen, plain = serve(HYMBA_ARCH, use_kernel=False, forced=gen, **kw)
    plain_peak = torch.cuda.max_memory_allocated()
    assert all(k.launches == 0 for k in KERNELS)
    plain_logits = torch.stack(plain.logits).float()
    diffs = (logits - plain_logits).abs().amax(dim=(1, 2)).tolist()
    step = _logit_step(logits)
    tol = LOGIT_TOL_STEPS * step
    first_agree = np.asarray(plain_gen[:, 0] == gen[:, 0]).tolist()
    margins = _first_token_margins(plain_logits[0], logits[0],
                                   plain_gen[:, 0], gen[:, 0])
    # the control: the same plain run with the window off in the SWA layers
    for i in swa:
        params.blocks[i].mixer.attn.window = 0
    try:
        _, ctrl = serve(HYMBA_ARCH, use_kernel=False, forced=gen, **kw)
    finally:
        for i in swa:
            params.blocks[i].mixer.attn.window = cfg.sliding_window
    control = (torch.stack(ctrl.logits).float() - plain_logits
               ).abs().amax(dim=(1, 2)).tolist()
    del ctrl

    # the appended prefill: the prompts in two chunks on one cache, with
    # the kernels (flash once a layer a chunk) and with the plain versions
    b, s = HYMBA["batch"], HYMBA["prompt_len"]
    prompts = np.random.default_rng(HYMBA["seed"]).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)        # serve()'s prompts
    tokens = torch.from_numpy(prompts).to(dev)
    fused, fused_calls = layers._sdpa_fused, []
    layers._sdpa_fused = lambda *a, **k: fused_calls.append(1) or fused(*a, **k)

    def two_chunks(use_kernel: bool):
        cache = lm.init_cache(cfg, b, HYMBA["max_len"], device=dev)
        per = []
        for c in range(0, s, HYMBA_CHUNK):
            zero()
            out, cache, _ = lm.forward(params, tokens=tokens[:, c:c + HYMBA_CHUNK],
                                       cache=cache, use_kernel=use_kernel)
            per.append(counted())
            last = out[:, -1].float()
            del out
        return last, per
    try:
        torch.cuda.synchronize()
        t_app = time.perf_counter()
        app_last, app_counts = two_chunks(True)
        torch.cuda.synchronize()
        t_app = time.perf_counter() - t_app
        app_plain, plain_counts = two_chunks(False)
    finally:
        layers._sdpa_fused = fused
    assert not fused_calls, "the appended prefill reached _sdpa_fused"
    want_chunk = {k.__name__: 0 for k in KERNELS}
    want_chunk["flash_attention"] = cfg.n_layers
    assert app_counts == [want_chunk] * (s // HYMBA_CHUNK), app_counts
    assert all(not any(c.values()) for c in plain_counts), plain_counts
    app_diff = float((app_last - app_plain).abs().max())
    app_tol = LOGIT_TOL_STEPS * _logit_step(app_last)
    app_vs_one = float((app_last - logits[0]).abs().max())

    out = dict(
        prefill_s=stats.prefill_s, decode_s=stats.decode_s,
        decode_tokens_per_s=stats.tokens_per_s,
        decode_step_ms=stats.decode_s / HYMBA["gen_len"] * 1e3,
        plain_prefill_s=plain.prefill_s,
        plain_decode_tokens_per_s=plain.tokens_per_s,
        peak_device_bytes=peak, plain_peak_device_bytes=plain_peak,
        launches=counts,
        max_logit_diff_per_step=diffs, max_abs_logit=float(logits.abs().max()),
        logit_tol=tol, first_token_agrees=first_agree,
        first_tokens=gen[:, 0].tolist(), first_token_margins=margins,
        control=HYMBA_CONTROL, control_max_logit_diff=max(control),
        control_diff_per_step=control,
        appended_prefill=dict(
            chunks=s // HYMBA_CHUNK, launches_per_chunk=app_counts,
            sdpa_fused_calls=len(fused_calls), seconds=t_app,
            max_last_logit_diff_vs_plain=app_diff, logit_tol=app_tol,
            max_last_logit_diff_vs_one_prefill=app_vs_one))
    log(f"serve {HYMBA_ARCH} batch={b} prompt={s} gen={HYMBA['gen_len']}: "
        f"{json.dumps(out)}")
    _check_first_tokens(first_agree, margins, step)
    assert max(diffs) <= tol, f"logits differ from plain by {max(diffs)} > {tol}"
    assert max(control) > tol, f"control {HYMBA_CONTROL!r} passes the check"
    assert app_diff <= app_tol, \
        f"appended prefill differs from plain by {app_diff} > {app_tol}"
    if profile_dir is not None:
        _profile_serve(params, cfg, dev, profile_dir, tag="hymba_",
                       shape=HYMBA)
    del params, stats, plain, logits, plain_logits
    torch.cuda.empty_cache()
    return out


# The xLSTM slice: xlstm-350m at full width and depth (24 layers, d_model
# 1,024; layers 7, 15 and 23 sLSTM), prompts of 4,096 tokens
XLSTM_ARCH = "xlstm-350m"
XLSTM = dict(batch=4, prompt_len=4096, gen_len=32, max_len=4128, seed=0)
XLSTM_CHUNK = 2048                   # the appended prefill: two chunks
XLSTM_APPEND_ROWS = 64               # second-chunk positions compared
XLSTM_CONTROL = "plain run with h @ w_rec dropped in the 3 sLSTM layers"
# The appended prefill's tolerance, in bf16 steps at the largest logit: it
# takes the largest difference over 64 positions of 4 rows (the serve
# check's over one position of 4 rows), and this network spreads any
# rounding far: on the H100 the serve check read 5.0-8.9 steps a decode
# step, the 64 second-chunk positions 12.8, and the kernels' own one
# prefill against their own two chunks (the same kernels on the same
# tokens: only cuBLAS's roundings differ with the shapes) 14.0; the
# w_rec-dropped control 141.  20 lies between; the control that drops the
# sLSTM state carried between the chunks must fail it.
XLSTM_APPEND_TOL_STEPS = 20
XLSTM_CARRY_CONTROL = "the kernels' second chunk from a zero sLSTM state"
XLSTM_APPEND_SEEDS = (1, 2)          # the appended check on other draws


def xlstm_serve_phase(dev, profile_dir: Path | None) -> dict:
    """``serve`` on xlstm-350m: the sLSTM kernel in the prefill and every
    decode step, the mLSTM blocks' torch ops, held against the plain
    versions' run; a control without the recurrent product must fail that
    check; the prompts again in two chunks on one cache, held to the plain
    versions' two chunks at the last logits and the second chunk's first
    positions."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    cfg = get_config(XLSTM_ARCH)
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=XLSTM["seed"], device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    slstm = [i for i in range(cfg.n_layers) if lm.is_slstm(cfg, i)]
    assert slstm == [i for i, blk in enumerate(params.blocks)
                     if hasattr(blk, "slstm")], slstm
    log(f"xlstm weights: {XLSTM_ARCH} {cfg.n_layers} layers (sLSTM at "
        f"{slstm}), {n_params} parameters ({cfg.num_params()} by the "
        f"config's formula; {w_bytes / 1e9:.2f} GB {cfg.dtype}), made on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    kw = dict(smoke=False, device=dev, params=params, **XLSTM)
    serve(XLSTM_ARCH, **dict(kw, prompt_len=256, gen_len=2))   # warm
    torch.cuda.synchronize()

    def zero():
        for k in KERNELS:
            k.launches = 0

    def counted():
        return {k.__name__: k.launches for k in KERNELS}

    torch.cuda.reset_peak_memory_stats()
    zero()                                # the serving path, counted alone
    gen, stats = serve(XLSTM_ARCH, **kw)
    counts = counted()
    peak = torch.cuda.max_memory_allocated()
    want = {k.__name__: 0 for k in KERNELS}
    want["slstm_scan"] = len(slstm) * (1 + XLSTM["gen_len"])
    assert counts == want, counts
    logits = torch.stack(stats.logits).float()
    assert gen.shape == (XLSTM["batch"], XLSTM["gen_len"])
    assert logits.shape == (XLSTM["gen_len"] + 1, XLSTM["batch"], cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert ((gen >= 0) & (gen < cfg.vocab)).all()

    # the yardstick: the plain versions, fed the kernel run's tokens
    zero()
    torch.cuda.reset_peak_memory_stats()
    plain_gen, plain = serve(XLSTM_ARCH, use_kernel=False, forced=gen, **kw)
    plain_peak = torch.cuda.max_memory_allocated()
    assert all(k.launches == 0 for k in KERNELS)
    plain_logits = torch.stack(plain.logits).float()
    diffs = (logits - plain_logits).abs().amax(dim=(1, 2)).tolist()
    step = _logit_step(logits)
    tol = LOGIT_TOL_STEPS * step
    first_agree = np.asarray(plain_gen[:, 0] == gen[:, 0]).tolist()
    margins = _first_token_margins(plain_logits[0], logits[0],
                                   plain_gen[:, 0], gen[:, 0])
    # the control: the same plain run without the recurrent product
    scan = ref.slstm_scan_ref
    ref.slstm_scan_ref = lambda xw, w_rec, b, st, **k: scan(
        xw, torch.zeros_like(w_rec), b, st, **k)
    try:
        _, ctrl = serve(XLSTM_ARCH, use_kernel=False, forced=gen, **kw)
    finally:
        ref.slstm_scan_ref = scan
    control = (torch.stack(ctrl.logits).float() - plain_logits
               ).abs().amax(dim=(1, 2)).tolist()
    del ctrl

    # the appended prefill: the prompts in two chunks on one cache, with
    # the kernels (slstm_scan once an sLSTM layer a chunk) and the plain
    # versions; the last logits and the second chunk's first positions,
    # where the carried state is felt most
    b, s = XLSTM["batch"], XLSTM["prompt_len"]
    prompts = np.random.default_rng(XLSTM["seed"]).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)        # serve()'s prompts
    tokens = torch.from_numpy(prompts).to(dev)

    def two_chunks(use_kernel: bool, drop_carry: bool = False,
                   params=params, tokens=tokens):
        cache = lm.init_cache(cfg, b, XLSTM["max_len"], device=dev)
        fresh = lm.init_cache(cfg, b, XLSTM["max_len"], device=dev)
        per = []
        for c in range(0, s, XLSTM_CHUNK):
            if c and drop_carry:          # the control: nothing carried
                for i in slstm:
                    for k, v in cache["layers"][i]["state"].items():
                        v.copy_(fresh["layers"][i]["state"][k])
            zero()
            out, cache, _ = lm.forward(params, tokens=tokens[:, c:c + XLSTM_CHUNK],
                                       cache=cache, use_kernel=use_kernel)
            per.append(counted())
            head = out[:, :XLSTM_APPEND_ROWS].float()
            last = out[:, -1].float()
            del out
        return head, last, per
    torch.cuda.synchronize()
    t_app = time.perf_counter()
    app_head, app_last, app_counts = two_chunks(True)
    torch.cuda.synchronize()
    t_app = time.perf_counter() - t_app
    plain_head, plain_last, plain_counts = two_chunks(False)
    carry_head, carry_last, _ = two_chunks(True, drop_carry=True)
    want_chunk = {k.__name__: 0 for k in KERNELS}
    want_chunk["slstm_scan"] = len(slstm)
    assert app_counts == [want_chunk] * (s // XLSTM_CHUNK), app_counts
    assert all(not any(c.values()) for c in plain_counts), plain_counts
    app_diff = float((app_last - plain_last).abs().max())
    app_head_diff = float((app_head - plain_head).abs().max())
    app_tol = XLSTM_APPEND_TOL_STEPS * _logit_step(
        torch.cat([app_last[:, None], app_head], 1))
    app_vs_one = float((app_last - logits[0]).abs().max())
    carry = max(float((carry_head - plain_head).abs().max()),
                float((carry_last - plain_last).abs().max()))
    # the same check on weights and prompts from other seeds, in bf16 steps
    seeds = {XLSTM["seed"]: max(app_diff, app_head_diff) / app_tol
             * XLSTM_APPEND_TOL_STEPS}
    for seed in XLSTM_APPEND_SEEDS:
        other = lm.init_lm(cfg, seed=seed, device=dev)
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (b, s)).astype(np.int32)).to(dev)
        k_head, k_last, _ = two_chunks(True, params=other, tokens=toks)
        p_head, p_last, _ = two_chunks(False, params=other, tokens=toks)
        seeds[seed] = max(float((k_head - p_head).abs().max()),
                          float((k_last - p_last).abs().max())) / _logit_step(
            torch.cat([k_last[:, None], k_head], 1))
        del other, k_head, k_last, p_head, p_last

    out = dict(
        prefill_s=stats.prefill_s, decode_s=stats.decode_s,
        decode_tokens_per_s=stats.tokens_per_s,
        decode_step_ms=stats.decode_s / XLSTM["gen_len"] * 1e3,
        plain_prefill_s=plain.prefill_s,
        plain_decode_tokens_per_s=plain.tokens_per_s,
        peak_device_bytes=peak, plain_peak_device_bytes=plain_peak,
        parameters=n_params, launches=counts,
        max_logit_diff_per_step=diffs, max_abs_logit=float(logits.abs().max()),
        logit_tol=tol, first_token_agrees=first_agree,
        first_tokens=gen[:, 0].tolist(), first_token_margins=margins,
        control=XLSTM_CONTROL, control_max_logit_diff=max(control),
        control_over_tol=max(control) / tol, control_diff_per_step=control,
        appended_prefill=dict(
            chunks=s // XLSTM_CHUNK, launches_per_chunk=app_counts,
            seconds=t_app, max_last_logit_diff_vs_plain=app_diff,
            max_head_logit_diff_vs_plain=app_head_diff,
            head_positions=XLSTM_APPEND_ROWS, logit_tol=app_tol,
            max_last_logit_diff_vs_one_prefill=app_vs_one,
            control=XLSTM_CARRY_CONTROL, control_max_logit_diff=carry,
            control_over_tol=carry / app_tol,
            max_diff_steps_by_seed=seeds))
    log(f"serve {XLSTM_ARCH} batch={b} prompt={s} gen={XLSTM['gen_len']}: "
        f"{json.dumps(out)}")
    _check_first_tokens(first_agree, margins, step)
    assert max(diffs) <= tol, f"logits differ from plain by {max(diffs)} > {tol}"
    assert max(control) > tol, f"control {XLSTM_CONTROL!r} passes the check"
    assert app_diff <= app_tol and app_head_diff <= app_tol, \
        f"appended prefill differs from plain by {app_diff} / " \
        f"{app_head_diff} > {app_tol}"
    assert carry > app_tol, f"control {XLSTM_CARRY_CONTROL!r} passes"
    assert max(seeds.values()) <= XLSTM_APPEND_TOL_STEPS, seeds
    if profile_dir is not None:
        _profile_serve(params, cfg, dev, profile_dir, tag="xlstm_",
                       shape=XLSTM)
    del params, stats, plain, logits, plain_logits
    torch.cuda.empty_cache()
    return out


# Logit tolerance of the MoE serve phase, in bf16 steps at the largest logit:
# the kernel run against the plain versions' run, forced on the same tokens
# and the same routing, so that only the kernels' roundings differ.
MOE_LOGIT_TOL_STEPS = 10
MOE_CONTROL = f"plain gmm drops the last {GMM_DROP} columns of its reduction"


class _Routing:
    """Wraps the port's router (``moe._route``): ``record`` keeps each
    call's ``(eids, weights)``; ``replay`` hands a later run the recorded
    ones in order and counts the tokens whose own top-k set differs."""

    def __init__(self):
        import torch

        from repro_torch.models import moe
        self.moe, self.real = moe, moe._route
        self.calls: list = []
        self.flips = torch.zeros((), dtype=torch.int64)
        self.checked = 0

    def record(self):
        def route(router_w, x_flat, m):
            eids, weights, aux = self.real(router_w, x_flat, m)
            self.calls.append((eids, weights))
            return eids, weights, aux
        return self._wrapped(route)

    def replay(self):
        it = iter(self.calls)
        self.flips = self.flips.to(self.calls[0][0].device).zero_()
        self.checked = 0

        def route(router_w, x_flat, m):
            own, _, aux = self.real(router_w, x_flat, m)
            eids, weights = next(it)
            self.flips += (own.sort(-1).values != eids.sort(-1).values
                           ).any(-1).sum()
            self.checked += own.shape[0]
            return eids, weights, aux
        return self._wrapped(route)

    def _wrapped(self, route):
        import contextlib

        @contextlib.contextmanager
        def cm():
            self.moe._route = route
            try:
                yield
            finally:
                self.moe._route = self.real
        return cm()

    def dropped(self, m) -> tuple[int, int]:
        """(token-expert assignments over capacity, all assignments) in the
        recorded calls."""
        import torch

        from repro_torch.models.moe import _capacity
        over = 0
        for eids, _ in self.calls:
            cap = _capacity(eids.shape[0], m)
            load = torch.bincount(eids.reshape(-1).long(),
                                  minlength=m.num_experts)
            over += int((load - cap).clamp_min(0).sum())
        return over, sum(e.numel() for e, _ in self.calls)


# ---------------------------------------------------------------------------
# the mesh: one NCCL rank on the card (``elastic_mesh(1, model_parallel=1)``,
# the mesh the reference's serve() builds on one device), the collectives
# on CUDA tensors, and each MoE model served over it on its own teshu2
# dispatch (with one EP axis, the flat all-to-all) beside the gspmd branch
# ---------------------------------------------------------------------------

MESH_STORE = ROOT / "build" / "chip_smoke_mesh"
EP_CONTROL = "the local expert axis rolled by one before the expert products"
EP_CONTROL_FACTOR = 10


def mesh_open(dev):
    """A NCCL world of one rank (a file store under ``build/``) and
    ``elastic_mesh(1, model_parallel=1)`` over it; every ``meshops``
    function held on CUDA tensors (:func:`_meshops_checks`).  The caller
    destroys the group."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import elastic_mesh
    MESH_STORE.mkdir(parents=True, exist_ok=True)
    store = MESH_STORE / "store"
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=dev)
    mesh = elastic_mesh(1, model_parallel=1)
    res = dict(init_s=time.perf_counter() - t0, mesh=mesh.shape,
               backend=dist.get_backend())
    res.update(_meshops_checks(dev, mesh))
    log(f"mesh phase: {json.dumps(res)}")
    return mesh, res


def tp_serve_phase(dev, mesh) -> dict:
    """The ``tp`` lines, one a model of :data:`TP_SERVE`: Qwen2.5-14B,
    Hymba-1.5B and xLSTM-350M at full width and depth, each with its serve
    phase's seed and traffic, served mesh-free, then placed on the
    one-rank NCCL mesh (``lm.place``: nothing moves) and served with
    ``serve(mesh=...)``, teacher-forced on the mesh-free run's tokens.
    ``model`` is 1, so every leaf the tensor-parallel rules keep
    (``shardings.kept_axes``: GQA heads, the MLP, Hymba's Mamba channels,
    the xLSTM projections) is its whole self, no gather of a column-split
    product and no row-parallel sum is issued, and the kernels see the
    shapes they see mesh-free: logits and tokens bit for bit, every launch
    count equal (and the model's own: Qwen2.5-14B flash one a layer, Hymba
    flash 32 and decode 1,024, xLSTM ``slstm_scan`` 99), and the only
    collective the serve loop's all-gather of the tokens over the batch
    axes.  The prefill s and decode ms beside the mesh-free run's, each run
    after one warm-up.  Returns ``{arch: its line}``."""
    return {arch: _tp_serve(dev, mesh, arch, traffic)
            for arch, traffic in TP_SERVE.items()}


# the tp lines: each model with its serve phase's traffic
TP_SERVE = {SERVE_ARCH: SERVE, HYMBA_ARCH: HYMBA, XLSTM_ARCH: XLSTM}


def _tp_launches(cfg, traffic) -> dict:
    """The launches a model's serve of ``traffic`` must make: flash one a
    prefill a layer and decode one a step a layer (dense, hybrid), or
    ``slstm_scan`` one a prefill and a step an sLSTM layer (xLSTM)."""
    from repro_torch.models import lm
    steps = traffic["gen_len"]
    if cfg.family == "ssm":
        n = sum(lm.is_slstm(cfg, i) for i in range(cfg.n_layers))
        return {"slstm_scan": n * (1 + steps)}
    return {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * steps}


def _tp_serve(dev, mesh, arch: str, traffic: dict) -> dict:
    """One ``tp`` line (:func:`tp_serve_phase`)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import meshops
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import shardings
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm

    cfg = get_config(arch)
    params = lm.init_lm(cfg, seed=traffic["seed"], device=dev)
    kw = dict(smoke=False, device=dev, params=params, **traffic)
    serve(arch, **dict(kw, gen_len=2))                # warm (not counted)
    for k in KERNELS:
        k.launches = 0
    gen, free = serve(arch, **kw)
    want = {k.__name__: k.launches for k in KERNELS}
    lm.place(params, mesh)
    assert not params._split, sorted(params._split)
    kept = sorted(n for n, spec in params.specs.items()
                  if "model" in shardings.kept_axes(n, spec, mesh, cfg))
    serve(arch, mesh=mesh, **dict(kw, gen_len=2))
    for k in KERNELS:
        k.launches = 0
    meshops.reset_counts()
    mgen, tp = serve(arch, mesh=mesh, forced=gen, **kw)
    counts = {k.__name__: k.launches for k in KERNELS}
    collectives = dict(meshops.COUNTS)
    same_logits = all(torch.equal(a, b)
                      for a, b in zip(free.logits, tp.logits))
    out = dict(card=nvidia_smi_line(), arch=arch, mesh=mesh.shape,
               layers=cfg.n_layers, **traffic,
               split=shardings.attention_split(cfg, mesh),
               mixer_split=shardings.mixer_split(cfg, mesh),
               kept_model_leaves=len(kept),
               prefill_s=tp.prefill_s, mesh_free_prefill_s=free.prefill_s,
               decode_ms=tp.decode_s / traffic["gen_len"] * 1e3,
               mesh_free_decode_ms=free.decode_s / traffic["gen_len"] * 1e3,
               tokens_equal=bool(np.array_equal(mgen, gen)),
               logits_bit_for_bit=same_logits, launches=counts,
               mesh_free_launches=want, collectives=collectives)
    log(f"tp: {json.dumps(out)}")
    assert out["tokens_equal"] and same_logits, arch
    expect = _tp_launches(cfg, traffic)
    assert counts == want and all(counts[k] == n for k, n in expect.items()), \
        (arch, counts, expect)
    assert collectives == {k: int(k == "all_gather")
                           for k in meshops.KINDS}, collectives
    del params, free, tp
    torch.cuda.empty_cache()
    return out


def _meshops_checks(dev, mesh) -> dict:
    """Each ``meshops`` function on CUDA tensors over the one-rank groups,
    held bit for bit to its plain meaning: the exchanges and sums give
    their input back, the compressed ``hier_psum`` the int8 round trip
    under its own scale; ``quantize_int8`` and ``hash32`` (seed 0, 2^20
    int32 keys and the +-2^31 edges) equal the CPU's.  A CPU tensor on the
    NCCL mesh, a gloo (cpu) mesh over the NCCL world, an unknown sync mode
    and the reference's ``OverflowError`` seeds must raise."""
    import numpy as np
    import torch

    from repro_torch.core import meshops
    from repro_torch.launch.mesh import Mesh
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((64, 33), generator=gen, device=dev)
    x4 = torch.randn((4, 6, 3), generator=gen, device=dev)
    meshops.reset_counts()
    same = {}
    for a in mesh.axis_names:
        for sh in (1, -1, 3):
            same[f"ring {a} {sh}"] = torch.equal(
                meshops.ring_exchange(x, mesh, a, sh), x)
    for axes in ("data", "model", ("data", "model"), ("model", "data")):
        for sp, ct in ((0, 0), (1, 1), (0, 1), (1, 0)):
            same[f"all_to_all {axes} {sp}{ct}"] = torch.equal(
                meshops.all_to_all_axis(x4, mesh, axes, sp, ct), x4)
    same["two_level"] = torch.equal(meshops.two_level_all_to_all(
        x4[None, None], mesh, "data", "model"), x4[None, None])
    same["flat_psum"] = torch.equal(
        meshops.flat_psum(x, mesh, ("data", "model")), x)
    same["hier_psum"] = torch.equal(
        meshops.hier_psum(x, mesh, "data", "model"), x)
    scale = x.abs().max() / 127.0 + 1e-12
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
    same["hier_psum compressed"] = torch.equal(
        meshops.hier_psum(x, mesh, "data", "model", compress_outer=True),
        codes.to(x.dtype) * scale)
    for mode in ("flat", "hier"):
        got = meshops.grad_sync({"w": x, "n": {"b": x4}}, mesh,
                                inner_axis="data", outer_axis="model",
                                mode=mode)
        same[f"grad_sync {mode}"] = torch.equal(got["w"], x) and \
            torch.equal(got["n"]["b"], x4)
    q, sc = meshops.quantize_int8(x)
    qc, scc = meshops.quantize_int8(x.cpu())
    same["quantize_int8"] = torch.equal(q.cpu(), qc) and \
        torch.equal(sc.cpu(), scc)
    same["dequantize_int8"] = torch.equal(
        meshops.dequantize_int8(q, sc).cpu(), meshops.dequantize_int8(qc, scc))
    keys = torch.cat([
        torch.tensor([0, 1, -1, 2 ** 31 - 1, -2 ** 31, -2 ** 31 + 1],
                     dtype=torch.int32),
        torch.randint(-2 ** 31, 2 ** 31, (1 << 20,), dtype=torch.int64,
                      generator=torch.Generator().manual_seed(3)
                      ).to(torch.int32)])
    same["hash32"] = torch.equal(meshops.hash32(keys.to(dev)).cpu(),
                                 meshops.hash32(keys))
    calls = dict(meshops.COUNTS)
    refused = {}
    for name, fn, err in (
            ("hash32 seed 1", lambda: meshops.hash32(keys.to(dev), seed=1),
             OverflowError),
            ("sample_group_mask", lambda: meshops.sample_group_mask(
                keys.to(dev), 0.01), OverflowError),
            ("estimate_tokens_per_expert",
             lambda: meshops.estimate_tokens_per_expert(
                 (keys % 128).to(dev), 128, 0.01), OverflowError),
            ("grad_sync mode 'ring'", lambda: meshops.grad_sync(
                {"w": x}, mesh, inner_axis="data", outer_axis=None,
                mode="ring"), ValueError),
            ("a cpu tensor on the nccl mesh", lambda: meshops.flat_psum(
                x.cpu(), mesh, ("data",)), ValueError),
            ("a cpu (gloo) mesh over the nccl world", lambda: Mesh(
                np.zeros((1, 1), np.int64), ("data", "model"), "cpu"),
             ValueError)):
        try:
            fn()
            refused[name] = False
        except err:
            refused[name] = True
    bad = [k for k, v in same.items() if not v]
    assert not bad, f"meshops on the card differ from their meaning: {bad}"
    assert all(refused.values()), refused
    return dict(held_bit_for_bit=len(same), nccl_calls=calls,
                refused=sorted(refused))


# the peaks this script logged in earlier runs on an NVIDIA H100 80GB HBM3
# at 700 W (PERF.md), for the placement line: the ep train phase's before
# its model was placed, and the DeepSeek-V2 gspmd serve's
EARLIER_PEAK_GB = {"ep_train": 74.40, "deepseek_serve": 72.79}


def _placement(model, mesh, opt_state=None) -> dict:
    """How ``model`` is placed on ``mesh``: its leaves, how many specs
    name an axis, the leaves held in part and the leaves a forward gathers
    (both none on one rank: every axis has size 1), the rank's parameter
    bytes and, given ``opt_state``, its moment bytes."""
    out = dict(
        leaves=len(model.specs),
        specs_naming_an_axis=sum(1 for s in model.specs.values() if any(s)),
        held_in_part=len(model._split),
        gathered_a_forward=sum(len(v) for v in model._gathers(mesh).values()),
        param_bytes=sum(p.numel() * p.element_size()
                        for p in model.parameters()))
    if opt_state is not None:
        out["moment_bytes"] = sum(t.numel() * t.element_size()
                                  for k in ("m", "v")
                                  for t in opt_state[k].values())
    return out


def _ep_serve(params, cfg, arch: str, dev, mesh, kw: dict, gen_tok, stats,
              logits, counts: dict, tol: float, moe_layers: int,
              profile_dir: Path | None, tag: str) -> dict:
    """``serve(mesh=...)`` on the model's own ``teshu2`` dispatch (one EP
    axis of one rank: the flat all-to-all through NCCL), on the gspmd run's
    weights, teacher-forced with its tokens: the logits against the gspmd
    run's (on one rank the two branches compute the same rows in the same
    layout: expected bit for bit; held within ``tol``), the launch counts
    against its, the collectives a forward and their bytes against the
    layout's arithmetic; then the control with the local expert axis
    rolled by one must miss ``tol`` by ``EP_CONTROL_FACTOR``.  The weights
    are placed on the mesh by their specs first (``lm.place``): on one
    rank every leaf stays whole, in place, and no leaf is gathered."""
    import torch

    from repro_torch.core import meshops
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.serve import serve
    from repro_torch.launch.shardings import ep_axes_for
    from repro_torch.models import lm, moe

    m = cfg.moe
    assert m.dispatch == "teshu2" and ep_axes_for(mesh) == ("model",), \
        (m.dispatch, mesh)
    ptrs = [p.data_ptr() for p in params.parameters()]
    lm.place(params, mesh)
    placement = _placement(params, mesh)
    assert [p.data_ptr() for p in params.parameters()] == ptrs
    assert placement["held_in_part"] == placement["gathered_a_forward"] == 0
    assert placement["specs_naming_an_axis"] > 0, placement
    serve(arch, mesh=mesh, forced=gen_tok, **dict(kw, gen_len=2))  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:                     # the EP serving path, alone
        k.launches = 0
    meshops.reset_counts()
    _, ep = serve(arch, mesh=mesh, forced=gen_tok, **kw)
    ep_counts = {k.__name__: k.launches for k in KERNELS}
    calls, wire = dict(meshops.COUNTS), dict(meshops.BYTES)
    peak = torch.cuda.max_memory_allocated()
    assert ep_counts == counts, (ep_counts, counts)
    forwards = 1 + SERVE["gen_len"]
    per = moe_layers * forwards
    # a MoE layer's forward: the dispatch and the return all-to-all, the
    # all-gather over model, the aux loss's all-reduce; one all-gather of
    # the tokens at the end
    # (the placed leaves add none: every axis has size 1; nor does
    # DeepSeek-V2's MLA, whose leaves are whole on a model of one rank)
    assert calls == dict(all_to_all=2 * per, all_gather=per + 1,
                         all_reduce=per, reduce_scatter=0, send_recv=0), calls

    def layer_bytes(tokens: int) -> tuple[int, int]:
        """(capacity, bytes a MoE layer hands the all-to-alls): E cap rows
        of d + 1 (the weight column) out, E cap rows of d back."""
        cap = moe._capacity(tokens, m)
        return cap, m.num_experts * cap * (2 * cfg.d_model + 1) * \
            params.embed.element_size()
    cap_p, bytes_p = layer_bytes(SERVE["batch"] * SERVE["prompt_len"])
    cap_d, bytes_d = layer_bytes(SERVE["batch"])
    assert wire["all_to_all"] == moe_layers * (bytes_p + SERVE["gen_len"]
                                               * bytes_d), wire
    ep_logits = torch.stack(ep.logits).float()
    diffs = (ep_logits - logits).abs().amax(dim=(1, 2)).tolist()
    n_diff = int((ep_logits != logits).sum())
    ep_prefill_s, ep_decode_s = ep.prefill_s, ep.decode_s
    del ep, ep_logits

    real = moe._expert_ffn

    def rolled(w, x, **k):                # the routed stack: E experts here
        if x.shape[0] == m.num_experts == w.w_gate.shape[0]:
            x = x.roll(1, 0)
        return real(w, x, **k)
    moe._expert_ffn = rolled
    try:
        _, control = serve(arch, mesh=mesh, forced=gen_tok, **kw)
    finally:
        moe._expert_ffn = real
    control_diffs = (torch.stack(control.logits).float() - logits
                     ).abs().amax(dim=(1, 2)).tolist()
    del control
    steps = SERVE["gen_len"]
    out = dict(
        dispatch=m.dispatch, ep_axes=list(ep_axes_for(mesh)),
        prefill_s=ep_prefill_s, gspmd_prefill_s=stats.prefill_s,
        decode_step_ms=ep_decode_s / steps * 1e3,
        gspmd_decode_step_ms=stats.decode_s / steps * 1e3,
        peak_device_bytes=peak, launches=ep_counts,
        calls=calls, calls_per_forward={
            k: (v - (k == "all_gather")) / forwards for k, v in calls.items()},
        wire_bytes=wire, all_to_all_bytes_a_layer=dict(
            prefill=bytes_p, prefill_capacity=cap_p, decode=bytes_d,
            decode_capacity=cap_d),
        logits_identical=n_diff == 0, logit_elements_differing=n_diff,
        max_logit_diff_per_step=diffs, logit_tol=tol,
        control=EP_CONTROL, control_max_logit_diff=max(control_diffs),
        control_min_step_diff=min(control_diffs),
        control_over_tol=max(control_diffs) / tol, placement=placement)
    log(f"{tag}ep serve {arch} over {mesh.shape} ({m.dispatch}, EP axes "
        f"{out['ep_axes']}): {json.dumps(out)}")
    assert max(diffs) <= tol, f"EP logits differ from gspmd by {max(diffs)}"
    assert max(control_diffs) > EP_CONTROL_FACTOR * tol, \
        f"control {EP_CONTROL!r} misses the check by only " \
        f"{max(control_diffs) / tol:.2f}x"
    _moe_prefill_count(params, cfg, dev, mesh, arch)   # the dry run's (8)
    if profile_dir is not None:
        _profile_serve(params, cfg, dev, profile_dir, tag=f"{tag}ep_",
                       mesh=mesh)
    return out


def moe_serve_phase(dev, profile_dir: Path | None, arch: str,
                    n_layers: int, tag: str, mesh=None) -> dict:
    """``serve`` on MoE model ``arch`` at full width, its depth cut to
    ``n_layers``: every routed and shared expert drawn on its own, the
    launch counts, the plain versions' forced and routed run as the
    yardstick, the dropped-reduction gmm control; then, given ``mesh``,
    the same weights served over it (:func:`_ep_serve`); an MLA model's
    attention also held at full width (:func:`_mla_checks`).  ``tag``
    names the profile's files."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import dense_init

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    m = cfg.moe
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=SERVE["seed"], device=dev)
    moe_layers = [b.moe for b in params.blocks if hasattr(b, "moe")]
    # the reference's init repeats one expert: draw each on its own
    gen = torch.Generator(device=dev).manual_seed(SERVE["seed"] + 1)
    stacks = [st for b in moe_layers for st in (b.experts, b.shared)
              if st is not None]
    with torch.no_grad():
        for stack in stacks:
            for w in (stack.w_gate, stack.w_up, stack.w_down):
                for e in range(w.shape[0]):
                    w[e].copy_(dense_init(gen, w.shape[1], w.shape[2],
                                          w.dtype, dev))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"{tag.rstrip('_')} serve weights: {arch} {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers ({len(moe_layers)} MoE), "
        f"{n_params} parameters ({w_bytes / 1e9:.2f} GB {cfg.dtype}), made "
        f"on the card in {time.perf_counter() - t0:.2f} s")
    kw = dict(smoke=False, device=dev, params=params, **SERVE)
    serve(arch, **dict(kw, gen_len=2))     # warm (not counted)
    torch.cuda.synchronize()

    routing = _Routing()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:                     # the MoE serving path, alone
        k.launches = 0
    with routing.record():
        gen_tok, stats = serve(arch, **kw)
    counts = {k.__name__: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    card = torch.cuda.get_device_properties(dev).total_memory
    forwards = 1 + SERVE["gen_len"]
    gqa = 0 if cfg.mla is not None else cfg.n_layers   # MLA: no kernel
    want = {k.__name__: 0 for k in KERNELS}
    want["flash_attention"] = gqa
    want["decode_attention"] = gqa * SERVE["gen_len"]
    # routed and shared experts, three products each, in each forward
    want["gmm"] = 3 * (1 + bool(m.num_shared)) * len(moe_layers) * forwards
    assert counts == want, counts
    logits = torch.stack(stats.logits).float()
    assert gen_tok.shape == (SERVE["batch"], SERVE["gen_len"])
    assert logits.shape == (SERVE["gen_len"] + 1, SERVE["batch"], cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert ((gen_tok >= 0) & (gen_tok < cfg.vocab)).all()
    assert len(routing.calls) == len(moe_layers) * forwards
    dropped, assigned = routing.dropped(m)

    # the yardstick: the plain versions, forced on the tokens and routing
    for k in KERNELS:
        k.launches = 0
    with routing.replay():
        plain_gen, plain = serve(arch, use_kernel=False, forced=gen_tok,
                                 **kw)
    flips, checked = int(routing.flips), routing.checked
    assert all(k.launches == 0 for k in KERNELS)
    plain_logits = torch.stack(plain.logits).float()
    diffs = (logits - plain_logits).abs().amax(dim=(1, 2)).tolist()
    top = float(logits.abs().max())
    step = 2.0 ** (np.floor(np.log2(top)) - 7)         # bf16 step at |top|
    tol = MOE_LOGIT_TOL_STEPS * step
    first_agree = np.asarray(plain_gen[:, 0] == gen_tok[:, 0]).tolist()
    margins = _first_token_margins(plain_logits[0], logits[0],
                                   plain_gen[:, 0], gen_tok[:, 0])
    del plain

    # the control: the same forced run with a plain gmm that drops the last
    # GMM_DROP columns of its reduction
    plain_gmm = ref.gmm_ref

    def dropping(x, w, tile_group_ids, **kw):
        return plain_gmm(x[:, :-GMM_DROP].contiguous(),
                         w[:, :-GMM_DROP].contiguous(), tile_group_ids, **kw)
    ref.gmm_ref = dropping
    try:
        with routing.replay():
            _, control = serve(arch, use_kernel=False, forced=gen_tok, **kw)
    finally:
        ref.gmm_ref = plain_gmm
    control_diffs = (torch.stack(control.logits).float() - plain_logits
                     ).abs().amax(dim=(1, 2)).tolist()
    del control
    out = dict(
        layers=cfg.n_layers, moe_layers=len(moe_layers), parameters=n_params,
        weight_bytes=w_bytes,
        prefill_s=stats.prefill_s, decode_s=stats.decode_s,
        decode_tokens_per_s=stats.tokens_per_s,
        decode_step_ms=stats.decode_s / SERVE["gen_len"] * 1e3,
        peak_device_bytes=peak, peak_reserved_bytes=peak_reserved,
        card_bytes=card, free_at_peak_bytes=card - peak_reserved,
        launches=counts,
        router_calls=len(routing.calls),
        routing_flips=flips, routed_tokens_checked=checked,
        assignments_dropped_over_capacity=dropped, assignments=assigned,
        max_logit_diff_per_step=diffs, max_abs_logit=top, logit_tol=tol,
        first_token_agrees=first_agree, first_tokens=gen_tok[:, 0].tolist(),
        first_token_margins=margins,
        control=MOE_CONTROL, control_max_logit_diff=max(control_diffs),
        control_min_step_diff=min(control_diffs),
        control_diff_per_step=control_diffs)
    log(f"{tag.rstrip('_')} serve {arch} layers={cfg.n_layers} "
        f"batch={SERVE['batch']} prompt={SERVE['prompt_len']} "
        f"gen={SERVE['gen_len']}: "
        f"{json.dumps(out)}")
    assert all(first_agree), "first generated token differs from plain"
    assert max(diffs) <= tol, f"logits differ from plain by {max(diffs)} > {tol}"
    assert max(control_diffs) > tol, \
        f"control {MOE_CONTROL!r} passes the logit check"
    del plain_logits, routing
    if mesh is not None:
        torch.cuda.empty_cache()
        out["ep"] = _ep_serve(params, cfg, arch, dev, mesh, kw, gen_tok,
                              stats, logits, counts, tol, len(moe_layers),
                              profile_dir, tag)
    del stats, logits
    torch.cuda.empty_cache()
    if cfg.mla is not None:
        out["mla"] = _mla_checks(params.blocks[1].attn, cfg, dev)
    if profile_dir is not None:
        _profile_serve(params, cfg, dev, profile_dir, tag=tag)
    del params
    torch.cuda.empty_cache()
    return out


# MLA at full width on the card (layer 1 of the served DeepSeek-V2, bf16
# inputs from a seed, the serve's batch and prompt length): (a) the absorbed
# decode against the materialised form at the step after a 1,024-position
# prefill, on the same cache; (b) the prompt prefilled in one call against
# two chunks of 512 on one cache, at the second chunk's outputs.  Limits in
# bf16 steps at the largest output, fixed before the first run: (a) each
# form rounds its output to bf16 once before wo (at most a step apart at any
# element) and wo's output rounds once more; the materialised form's bf16
# k_nope and v move a score or an output by 2^-9 relative per term, summed
# with random signs over 128 dims and 1,025 rows, far below a step.  (b)
# runs the same operations on matmuls of other row counts (cuBLAS may sum
# in other orders, a step at any rounding).  A CPU emulation at 8 of the 128
# heads read 1.0 step for both and about 100 for both controls.
MLA_DECODE_TOL_STEPS = 4
MLA_APPEND_TOL_STEPS = 4
MLA_CHUNK = 512
MLA_DECODE_CONTROL = "the absorbed scores without their rope term"
MLA_APPEND_CONTROL = "the first chunk's k_rope rows zeroed in the cache"


def _mla_checks(attn, cfg, dev) -> dict:
    """(a) and (b) above on ``attn``; each control must miss its limit by
    10x or more."""
    import torch

    from repro_torch.models.layers import (init_mla_cache,
                                           mla_absorbed_decode,
                                           mla_materialized)
    b, s = SERVE["batch"], SERVE["prompt_len"]
    gen = torch.Generator(device=dev).manual_seed(SERVE["seed"] + 2)
    x = torch.randn((b, s + 1, cfg.d_model), generator=gen, device=dev
                    ).to(torch.bfloat16)
    pos = torch.arange(s + 1, device=dev).expand(b, s + 1)

    def fresh():
        return init_mla_cache(cfg, b, SERVE["max_len"], device=dev)

    def steps(got, want, step) -> float:
        return float((got.float() - want.float()).abs().max()) / step

    out = {}
    with torch.no_grad():
        # (a) the step at position s on the cache of an s-position prefill
        cache = fresh()
        full, _ = attn(x[:, :s], pos[:, :s], cache=cache)
        absorbed, _ = attn(x[:, s:], pos[:, s:], cache=cache)   # the decode
        q_nope, q_rope, _, _ = attn.project(x[:, s:], pos[:, s:])
        rows = cache["latent"][:, :s + 1], cache["k_rope"][:, :s + 1]
        mat = mla_materialized(attn, q_nope, q_rope, *rows, q_offset=s,
                               valid_len=s + 1).to(x.dtype) @ attn.wo
        no_rope = mla_absorbed_decode(attn, q_nope, torch.zeros_like(q_rope),
                                      *rows, valid_len=s + 1
                                      ).to(x.dtype) @ attn.wo
        step = _logit_step(mat)
        out["absorbed_vs_materialized_steps"] = steps(absorbed, mat, step)
        out["absorbed_control_steps"] = steps(no_rope, mat, step)
        del cache, absorbed, mat, no_rope, rows
        # (b) two chunks on one cache against the one prefill above
        want = full[:, MLA_CHUNK:]
        step = _logit_step(want)
        for name, zero_rope in (("append_steps", False),
                                ("append_control_steps", True)):
            cache = fresh()
            attn(x[:, :MLA_CHUNK], pos[:, :MLA_CHUNK], cache=cache)
            if zero_rope:
                cache["k_rope"][:, :MLA_CHUNK] = 0
            got, _ = attn(x[:, MLA_CHUNK:s], pos[:, MLA_CHUNK:s], cache=cache)
            assert bool(torch.isfinite(got).all())
            out[name] = steps(got, want, step)
            del cache, got
        del full, want
    out.update(decode_tol_steps=MLA_DECODE_TOL_STEPS,
               append_tol_steps=MLA_APPEND_TOL_STEPS,
               decode_control=MLA_DECODE_CONTROL,
               append_control=MLA_APPEND_CONTROL)
    log(f"mla checks (layer 1, B {b}, {s} positions, chunks of "
        f"{MLA_CHUNK}): {json.dumps(out)}")
    assert out["absorbed_vs_materialized_steps"] <= MLA_DECODE_TOL_STEPS
    assert out["absorbed_control_steps"] >= 10 * MLA_DECODE_TOL_STEPS, \
        f"control {MLA_DECODE_CONTROL!r} is within 10x of the limit"
    assert out["append_steps"] <= MLA_APPEND_TOL_STEPS
    assert out["append_control_steps"] >= 10 * MLA_APPEND_TOL_STEPS, \
        f"control {MLA_APPEND_CONTROL!r} is within 10x of the limit"
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 5. slice phase
# ---------------------------------------------------------------------------

def _stats_identical(a: dict, b: dict) -> None:
    import math
    for k in ("total_bytes", "sample_bytes", "bytes_per_level",
              "recv_bytes_per_worker", "bytes_per_tenant"):
        assert a[k] == b[k], (k, a[k], b[k])
    assert math.isclose(a["modelled_time_s"], b["modelled_time_s"],
                        rel_tol=1e-9, abs_tol=1e-18)
    for t in a["cost_per_tenant"]:
        assert math.isclose(a["cost_per_tenant"][t], b["cost_per_tenant"][t],
                            rel_tol=1e-9, abs_tol=1e-18)


def _paper_topology():
    import repro_torch.core as port
    topo = port.datacenter(4, 5, 2, intra_server_bw=12.5e9,
                           intra_rack_bw=1.25e9, oversubscription=10.0)
    assert topo.num_workers == WORKERS
    return topo


def _zero_counts() -> None:
    from repro_torch.kernels import SHUFFLE_KERNELS
    for k in SHUFFLE_KERNELS:
        k.launches = 0


def _read_counts() -> dict:
    from repro_torch.kernels import SHUFFLE_KERNELS
    return {k.__name__: k.launches for k in SHUFFLE_KERNELS}


def _same_bytes(got: dict, want: dict, ws) -> None:
    """Per destination: the same int64 keys and bit-identical float64 rows."""
    import numpy as np
    for w in ws:
        a, b = got[w], want[w]
        assert a.keys.dtype == np.int64 and a.vals.dtype == np.float64
        assert np.array_equal(a.keys, b.keys), w
        assert np.array_equal(a.vals.view(np.int64), b.vals.view(np.int64)), w


def _within_sum_bound(got: dict, want: dict, ws, rows_per_key, absum) -> float:
    """The kernel plane's float32 SUM against an exact replay: the same keys,
    each value within ``(rows + 1) 2^-24 sum|v|`` of its key (each input
    rounds to float32, 2^-24 |v|, and the summation adds at most
    len 2^-24 sum|v|); returns the largest difference."""
    import numpy as np
    worst = 0.0
    for w in ws:
        a, b = got[w], want[w]
        assert a.keys.dtype == np.int64 and a.vals.dtype == np.float64
        assert np.array_equal(a.keys, b.keys), w
        assert np.isfinite(a.vals).all() and a.vals.shape == b.vals.shape
        tol = (rows_per_key[a.keys, None] + 1) * U32 * absum[a.keys]
        diff = np.abs(a.vals - b.vals)
        assert (diff <= tol).all(), f"dst {w} outside the float32 bound"
        worst = max(worst, float(diff.max(initial=0.0)))
    return worst


def _sum_bound(bufs, ws):
    """Per key: rows and sum of |v| over the whole input (every key lands
    at exactly one destination)."""
    import numpy as np
    keys = np.concatenate([bufs[w].keys for w in ws])
    vals = np.concatenate([bufs[w].vals for w in ws])
    rows = np.bincount(keys, minlength=KEYS)
    absum = np.stack([np.bincount(keys, weights=np.abs(vals[:, c]),
                                  minlength=KEYS) for c in range(WIDTH)], 1)
    return rows, absum


class _Capture:
    """Keeps the inputs of the last PART, COMB and fold call that a path
    makes through the kernel entry points (``repro_torch.kernels.ops``,
    where ``torchplan`` calls them), so that :func:`_hold_path` can hold
    each kernel against its plain version at the path's own shapes once the
    path has run.  The wrappers count their launches as ever."""

    OPS = {"part": "partition_permute", "combine": "segment_combine",
           "segmented_fold": "segmented_fold"}

    def __enter__(self):
        from repro_torch.kernels import ops
        self.calls, self._ops, self._orig = {}, ops, {}
        for attr, name in self.OPS.items():
            fn = self._orig[attr] = getattr(ops, attr)

            def record(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] = (a, kw)
                return _fn(*a, **kw)
            setattr(ops, attr, record)
        return self

    def __exit__(self, *exc) -> bool:
        for attr, fn in self._orig.items():
            setattr(self._ops, attr, fn)
        return False


def _hold_path(tag: str, calls: dict, counts: dict) -> dict:
    """Each kernel that a path launched (``counts``), called again on the inputs of its
    last call there and held against its plain version, and a planted fault
    on the same inputs that must fail the same check:

    * PART (the global stage's permutation): exact.  Fault: one row takes
      the value of the next row that differs from it.
    * COMB (the global stage's sorted, compacted ids): within
      ``len_seg 2^-24 sum|v|`` of the exact float64 sum, and within twice
      that of the plain version.  Fault: the rows of one segment past its
      first tile boundary zeroed (the segment whose dropped sum exceeds
      twice its bound the most).
    * the ordered fold: bit-identical to the plain version on a CPU copy
      (the plain loop takes a step per row of the longest segment).  Fault:
      the first two rows of a segment swapped, whose seed row then holds
      the other's value.

    A path that measures its peak device memory leaves out the run that
    keeps the inputs (they outlive their call).

    Returns per kernel the shape it ran at and its largest difference."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.combine import segment_combine
    from repro_torch.kernels.combine import tile_rows as combine_tile_rows
    from repro_torch.kernels.fold import segmented_fold
    from repro_torch.kernels.partition import partition_permute

    assert set(calls) == {k for k, c in counts.items() if c}, (tag, counts)
    out = {}
    if "partition_permute" in calls:
        (slots, vals), kw = calls["partition_permute"]
        n, d = vals.shape
        assert kw["unique_slots"] and kw["num_out"] == n == slots.shape[0]
        got = partition_permute(slots, vals, num_out=n, unique_slots=True)
        plain = ref.partition_permute_ref(slots, vals, num_out=n)
        assert torch.equal(got, plain), f"{tag}: PART differs from plain"
        i = int(torch.nonzero((vals[1:] != vals[:-1]).any(1))[0])
        bad = vals.clone()
        bad[i] = vals[i + 1]
        assert not torch.equal(partition_permute(slots, bad, num_out=n,
                                                 unique_slots=True), plain), \
            f"{tag}: the neighbour-row control passed PART's check"
        out["partition_permute"] = dict(
            rows=n, width=d, tolerance="exact",
            max_abs_err=float((got - plain).abs().max()))
        del bad, got, plain
    if "segment_combine" in calls:
        (ids, vals), kw = calls["segment_combine"]
        n, d = vals.shape
        s = kw["num_segments"]
        seg = ids.long()
        assert bool((seg[1:] >= seg[:-1]).all()) and int(seg[-1]) == s - 1
        got = segment_combine(ids, vals, num_segments=s)
        plain = ref.segment_combine_ref(ids, vals, num_segments=s)
        v64 = vals.double()
        exact = torch.zeros((s, d), dtype=torch.float64, device=vals.device)
        exact.index_add_(0, seg, v64)
        absum = torch.zeros_like(exact).index_add_(0, seg, v64.abs())
        tol = torch.bincount(seg, minlength=s).double()[:, None] * U32 * absum

        def held(o) -> bool:
            return bool(((o.double() - exact).abs() <= tol).all())
        assert held(got), f"{tag}: COMB outside the f32 summation bound"
        err = (got.double() - plain.double()).abs()
        assert bool((err <= 2 * tol).all()), f"{tag}: COMB against plain"
        tile = combine_tile_rows(d, vals.dtype)
        idx = torch.arange(n, device=vals.device)
        head = torch.ones(n, dtype=torch.bool, device=vals.device)
        head[1:] = seg[1:] != seg[:-1]
        first = torch.cummax(torch.where(head, idx, 0), 0).values
        past = idx >= (first // tile + 1) * tile
        dropped = torch.zeros_like(exact).index_add_(0, seg[past], v64[past])
        margin = (dropped.abs() - 2 * tol).amax(1)
        j = int(margin.argmax())
        assert float(margin[j]) > 0, f"{tag}: no segment for COMB's control"
        bad = vals.clone()
        bad[past & (seg == j)] = 0
        assert not held(segment_combine(ids, bad, num_segments=s)), \
            f"{tag}: the dropped-partial control passed COMB's check"
        out["segment_combine"] = dict(
            rows=n, width=d, segments=s, tile_rows=tile,
            tolerance="len_seg*2^-24*sum|v| against the exact sum",
            max_abs_err=float(err.max()))
        del bad, got, plain, exact, absum, tol, dropped
    if "segmented_fold" in calls:
        (op, is_start, vals), _ = calls["segmented_fold"]
        n, d = vals.shape
        got = segmented_fold(op, is_start, vals).cpu()
        cs, cv = is_start.cpu(), vals.cpu()
        t0 = time.perf_counter()
        plain = ref.segmented_fold_ref(op, cs, cv)
        check_s = time.perf_counter() - t0
        assert fold_same(got, plain), f"{tag}: fold {op} differs from plain"
        st = cs.clone()
        st[0] = True
        bits = cv.view(torch.int64)
        differ = ((bits[1:] != bits[:-1])
                  & ~(cv[1:].isnan() & cv[:-1].isnan())).any(1)
        i = int(torch.nonzero(st[:-1] & ~st[1:] & differ)[0])
        bad = vals.clone()
        bad[[i, i + 1]] = vals[[i + 1, i]]
        assert not fold_same(segmented_fold(op, is_start, bad).cpu(), plain), \
            f"{tag}: the swapped-seed control passed the fold's bit check"
        lens = torch.diff(torch.nonzero(st).flatten(),
                          append=torch.tensor([n]))
        out["segmented_fold"] = dict(
            op=op, rows=n, width=d, longest_segment=int(lens.max()),
            tolerance="bit-identical (NaN=NaN)", max_abs_err=0.0,
            plain_check_cpu_s=check_s)
        del bad
    log(f"{tag} kernels against their plain versions on the path's last "
        f"inputs (each control failed its check): {json.dumps(out)}")
    return out


def slice_phase(dev, profile_dir: Path | None) -> dict:
    import torch

    import repro_torch.core as port
    from repro_torch.core import torchplan

    topo = _paper_topology()
    ws = list(range(WORKERS))
    t0 = time.perf_counter()
    bufs = zipf_shards(seed=0)
    log(f"slice data: {WORKERS} workers x {ROWS_PER_WORKER} rows x {WIDTH} "
        f"f64 ({sum(m.nbytes for m in bufs.values()) / 1e6:.0f} MB wire), "
        f"made in {time.perf_counter() - t0:.2f} s")
    rows_per_key, absum = _sum_bound(bufs, ws)
    launches = dict.fromkeys(_read_counts(), 0)
    out = {}
    for template in TEMPLATES:
        cl = port.TeShuCluster(topo, device=dev)       # executor="torch"
        client = cl.tenant()
        t0 = time.perf_counter()
        miss = client.shuffle(template, copy_bufs(bufs), ws, ws,
                              comb_fn=port.SUM)
        miss_s = time.perf_counter() - t0
        assert miss.engine == "threaded" and not miss.cached
        inputs = [copy_bufs(bufs) for _ in range(HITS)]
        torch.cuda.synchronize()
        _zero_counts()                    # the main path, counted alone
        walls, hits, peaks, cap = [], [], [], _Capture()
        for i, b in enumerate(inputs):
            torch.cuda.reset_peak_memory_stats()
            last = i == len(inputs) - 1   # keeps its kernels' inputs
            with cap if last else contextlib.nullcontext():
                t0 = time.perf_counter()
                hits.append(client.shuffle(template, b, ws, ws,
                                           comb_fn=port.SUM))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            if not last:
                peaks.append(torch.cuda.max_memory_allocated())
        counts = _read_counts()
        peak = max(peaks)
        held = _hold_path(f"slice {template}", cap.calls, counts)
        del cap
        for k, c in counts.items():
            launches[k] += c
        for h in hits:
            assert h.engine == "torch" and h.fallback_reason is None, \
                (h.engine, h.fallback_reason)
            assert h.cached
        assert all(c > 0 for c in counts.values()), counts
        hit = hits[-1]
        # the port's own vectorized replay is the yardstick
        vec = client.shuffle(template, copy_bufs(bufs), ws, ws,
                             comb_fn=port.SUM, executor="vectorized")
        assert vec.engine == "vectorized"
        worst = _within_sum_bound(hit.bufs, vec.bufs, ws, rows_per_key, absum)
        _stats_identical(hit.stats, vec.stats)
        # the exact plane: byte-identical with the kernel plane off
        prev = torchplan.set_kernel_plane(False)
        exact = client.shuffle(template, copy_bufs(bufs), ws, ws,
                               comb_fn=port.SUM)
        torchplan.set_kernel_plane(prev)
        assert exact.engine == "torch"
        _same_bytes(exact.bufs, vec.bufs, ws)
        _stats_identical(exact.stats, vec.stats)
        nrows = sum(m.n for m in hit.bufs.values())
        out[template] = dict(
            miss_s=miss_s, hit_s=statistics.median(walls), hit_walls=walls,
            peak_device_bytes=peak, launches=counts, out_rows=nrows,
            max_abs_err_vs_vectorized=worst, kernels_held=held)
        log(f"slice {template}: {json.dumps(out[template])}")
        if profile_dir is not None:
            _profile_hit(client, template, bufs, ws, profile_dir)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# 6. skew phase
# ---------------------------------------------------------------------------

def _max_recv(res) -> int:
    """The largest per-destination received bytes of one shuffle."""
    return max(res.stats["recv_bytes_per_worker"].values())


def skew_phase(dev, profile_dir: Path | None) -> dict:
    """paper-40 with Zipf(1.2) keys and ``balance="auto"``: the frozen
    hot-key scatter, the fold and the owner merge on the card."""
    import numpy as np
    import torch

    import repro_torch.core as port
    from repro_torch.core import torchplan

    topo = _paper_topology()
    ws = list(range(WORKERS))
    t0 = time.perf_counter()
    bufs = zipf_shards(seed=1, alpha=SKEW_ALPHA)
    top_rows = int(np.bincount(np.concatenate([bufs[w].keys for w in ws]),
                               minlength=KEYS).max())
    log(f"skew data: Zipf({SKEW_ALPHA}) over {KEYS} keys, {WORKERS} workers "
        f"x {ROWS_PER_WORKER} rows x {WIDTH} f64, top key {top_rows} rows "
        f"({top_rows / (WORKERS * ROWS_PER_WORKER):.4f} of all), made in "
        f"{time.perf_counter() - t0:.2f} s")
    cl = port.TeShuCluster(topo, device=dev)       # executor="torch"
    client = cl.tenant()
    kw = dict(comb_fn=port.SUM, balance="auto")
    t0 = time.perf_counter()
    miss = client.shuffle("vanilla_push", copy_bufs(bufs), ws, ws, **kw)
    miss_s = time.perf_counter() - t0
    assert miss.engine == "threaded" and not miss.cached
    inputs = [copy_bufs(bufs) for _ in range(HITS)]
    torch.cuda.synchronize()
    _zero_counts()                        # the skewed hits, counted alone
    walls, hits, peaks, cap = [], [], [], _Capture()
    for i, b in enumerate(inputs):
        torch.cuda.reset_peak_memory_stats()
        last = i == len(inputs) - 1       # keeps its kernels' inputs
        with cap if last else contextlib.nullcontext():
            t0 = time.perf_counter()
            hits.append(client.shuffle("vanilla_push", b, ws, ws, **kw))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if not last:
            peaks.append(torch.cuda.max_memory_allocated())
    counts = _read_counts()
    peak = max(peaks)
    held = _hold_path("skew vanilla_push", cap.calls, counts)
    del cap
    for h in hits:
        assert h.cached and h.engine == "torch" and h.fallback_reason is None, \
            (h.engine, h.fallback_reason)
        assert dict(h.decisions)["rebalance"].triggered
    assert counts["segmented_fold"] > 0, counts
    # the port's own vectorized replay: the same bytes and charges
    vec = client.shuffle("vanilla_push", copy_bufs(bufs), ws, ws,
                         executor="vectorized", **kw)
    assert vec.engine == "vectorized"
    for h in hits:
        _same_bytes(h.bufs, vec.bufs, ws)
        _stats_identical(h.stats, vec.stats)
    # the same data with the rebalance off: the hot key's owner takes it all
    client.shuffle("vanilla_push", copy_bufs(bufs), ws, ws, comb_fn=port.SUM)
    off = client.shuffle("vanilla_push", copy_bufs(bufs), ws, ws,
                         comb_fn=port.SUM)
    assert off.engine == "torch" and "rebalance" not in dict(off.decisions)
    recv, recv_off = _max_recv(hits[-1]), _max_recv(off)
    assert recv < recv_off, (recv, recv_off)
    # network_aware under the rebalance: replays on torch, or declines with
    # the port's (the reference's) plan code
    client.shuffle("network_aware", copy_bufs(bufs), ws, ws, **kw)
    t0 = time.perf_counter()
    na = client.shuffle("network_aware", copy_bufs(bufs), ws, ws, **kw)
    torch.cuda.synchronize()
    na_s = time.perf_counter() - t0
    (plan,) = [p for _, p in cl.plan_cache.scan(port.DEFAULT_TENANT)
               if p.template_id == "network_aware"]
    assert plan.skew is not None and plan.skew.triggered
    code = torchplan.plan_decline(plan)
    if code is None:
        assert na.engine == "torch" and na.fallback_reason is None
        na_vec = client.shuffle("network_aware", copy_bufs(bufs), ws, ws,
                                executor="vectorized", **kw)
        _same_bytes(na.bufs, na_vec.bufs, ws)
        _stats_identical(na.stats, na_vec.stats)
    else:
        assert code in ("skew_group_collision", "skew_shape_mismatch"), code
        assert na.engine == "vectorized" and na.fallback_reason == code
    out = dict(miss_s=miss_s, hit_s=statistics.median(walls), hit_walls=walls,
               peak_device_bytes=peak, launches=counts, kernels_held=held,
               top_key_rows=top_rows,
               max_recv_bytes=recv, max_recv_bytes_balance_off=recv_off,
               recv_ratio_off_to_auto=recv_off / recv,
               network_aware=dict(engine=na.engine,
                                  fallback_reason=na.fallback_reason,
                                  plan_decline=code, hit_s=na_s))
    log(f"skew vanilla_push: {json.dumps(out)}")
    if profile_dir is not None:
        _profile_hit(client, "vanilla_push", bufs, ws, profile_dir,
                     tag="skew_", balance="auto")
    return out


# ---------------------------------------------------------------------------
# 7. batch phase
# ---------------------------------------------------------------------------

class _PassClock:
    """Host seconds of the pieces of one ``run_pending()`` pass, each piece
    synchronised with the card before its clock stops: the coflow planner
    (``CoflowScheduler.plan``), the batch probe (``_prepare_batches``, the
    batched program's ``prepare_batch`` inside it), ``finish_batches``, and
    every plan-key statistics signature (``stats_signature``: the probe's
    and each member's own).  What is left of the wall is the members'
    replays outside their signatures."""

    def __init__(self, cl):
        from repro_torch.core import coscheduler, service, torchplan
        self.targets = [(coscheduler.CoflowScheduler, "plan", "planner"),
                        (cl, "_prepare_batches", "batch_probe"),
                        (torchplan, "prepare_batch", "prepare_batch"),
                        (torchplan, "finish_batches", "finish_batches"),
                        (service, "stats_signature", "stats_signature")]
        self.s = {name: 0.0 for _, _, name in self.targets}
        self.calls = dict.fromkeys(self.s, 0)

    def __enter__(self):
        import torch
        self._saved = []
        for obj, attr, name in self.targets:
            fn = getattr(obj, attr)
            self._saved.append((obj, attr, obj.__dict__.get(attr)))

            def timed(*a, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    self.s[_name] += time.perf_counter() - t0
                    self.calls[_name] += 1
            setattr(obj, attr, timed)
        return self

    def __exit__(self, *exc) -> bool:
        for obj, attr, fn in reversed(self._saved):
            if fn is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)
        return False

    def report(self, wall: float) -> dict:
        rest = wall - sum(self.s[k] for k in ("planner", "batch_probe",
                                              "finish_batches"))
        return dict(wall=wall, **self.s, calls=self.calls,
                    members_outside_probe=rest)


def batch_phase(dev, profile_dir: Path | None) -> dict:
    """Four tenants' same-signature SUM shuffles on paper-40 (Zipf(0.9),
    50k rows a worker, 2M rows a member): one batched program, against
    four serial hits."""
    import math

    import torch

    import repro_torch.core as port
    from repro_torch.core import torchplan

    topo = _paper_topology()
    ws = list(range(WORKERS))
    t0 = time.perf_counter()
    data = [zipf_shards(seed=10 + i, rows=BATCH_ROWS_PER_WORKER)
            for i in range(BATCH_TENANTS)]
    bounds = [_sum_bound(b, ws) for b in data]
    log(f"batch data: {BATCH_TENANTS} tenants x {WORKERS} workers x "
        f"{BATCH_ROWS_PER_WORKER} rows x {WIDTH} f64, made in "
        f"{time.perf_counter() - t0:.2f} s")
    cl = port.TeShuCluster(topo, device=dev)
    tenants = [cl.tenant(f"t{i}") for i in range(BATCH_TENANTS)]
    ledger = cl.cluster.ledger
    kw = dict(comb_fn=port.SUM)
    for t, b in zip(tenants, data):       # warm: a plan per tenant
        for _ in range(2):
            r = t.shuffle("vanilla_push", copy_bufs(b), ws, ws, **kw)
        assert r.engine == "torch" and r.cached

    def serial():
        ins = [copy_bufs(b) for b in data]
        torch.cuda.synchronize()
        s0 = ledger.snapshot()
        _zero_counts()
        t0 = time.perf_counter()
        res = [t.shuffle("vanilla_push", b, ws, ws, **kw)
               for t, b in zip(tenants, ins)]
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, _read_counts(), s0,
                ledger.snapshot())

    def batched(solo=False, clock=None, cap=None):
        """The four submissions through one run_pending() pass: one batch,
        or with ``solo`` each member replaying alone in the same pass (the
        batch probe forms no group), so the two differ only in batching."""
        ins = [copy_bufs(b) for b in data]
        if solo:
            cl._prepare_batches = lambda subs: ([], [])
        torch.cuda.synchronize()
        s0 = ledger.snapshot()
        _zero_counts()
        try:
            with clock or contextlib.nullcontext(), \
                    cap or contextlib.nullcontext():
                t0 = time.perf_counter()
                tickets = [t.submit("vanilla_push", b, ws, ws, **kw)
                           for t, b in zip(tenants, ins)]
                results = cl.run_pending()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            cl.__dict__.pop("_prepare_batches", None)
        counts = _read_counts()
        entries = cl.last_schedule()["batches"]
        assert [e["size"] for e in entries] == ([] if solo else
                                                [BATCH_TENANTS]), entries
        res = [results[tk] for tk in tickets]
        for r in res:
            assert r.engine == "torch" and r.batched != solo and r.cached, \
                r.engine
            assert r.fallback_reason is None, r.fallback_reason
        assert not torchplan._BATCH_SLOTS
        return res, wall, counts, s0, ledger.snapshot()

    ser, ser_wall, ser_counts, s0, s1 = serial()
    cap = _Capture()
    bat, bat_wall, bat_counts, b0, b1 = batched(cap=cap)   # the main path
    held = _hold_path(f"batch vanilla_push x {BATCH_TENANTS}", cap.calls,
                      bat_counts)
    del cap
    # the wall of the same pass with each member solo, and where the time
    # of each pass goes (its pieces timed with a sync after each)
    solo_wall = batched(solo=True)[1]
    pieces = {}
    for name, solo in (("batched", False), ("solo", True)):
        clock = _PassClock(cl)
        wall = batched(solo=solo, clock=clock)[1]
        pieces[name] = clock.report(wall)
    for r in ser:
        assert r.engine == "torch" and not r.batched
    # one program for the batch: one serial replay's folds, not four times
    assert ser_counts["segmented_fold"] % BATCH_TENANTS == 0
    assert bat_counts["segmented_fold"] == \
        ser_counts["segmented_fold"] // BATCH_TENANTS > 0, (bat_counts,
                                                            ser_counts)
    assert all(c > 0 for c in bat_counts.values()), bat_counts
    for lane in ("bytes_per_tenant", "cost_per_tenant"):
        ds = {k: s1[lane][k] - s0[lane].get(k, 0) for k in s1[lane]}
        db = {k: b1[lane][k] - b0[lane].get(k, 0) for k in b1[lane]}
        assert set(ds) == set(db), (lane, ds, db)
        for k in ds:
            if lane == "bytes_per_tenant":
                assert ds[k] == db[k], (lane, k, ds[k], db[k])
            else:
                assert math.isclose(ds[k], db[k], rel_tol=1e-9,
                                    abs_tol=1e-18), (lane, k, ds[k], db[k])
    ser_model = s1["modelled_time_s"] - s0["modelled_time_s"]
    bat_model = b1["modelled_time_s"] - b0["modelled_time_s"]
    assert bat_model < ser_model, (bat_model, ser_model)
    # the kernel plane (on): each member within the float32 bound of its
    # tenant's vectorized replay
    worst = 0.0
    for t, b, r, (rows_per_key, absum) in zip(tenants, data, bat, bounds):
        vec = t.shuffle("vanilla_push", copy_bufs(b), ws, ws,
                        executor="vectorized", **kw)
        assert vec.engine == "vectorized"
        worst = max(worst, _within_sum_bound(r.bufs, vec.bufs, ws,
                                             rows_per_key, absum))
    # the exact plane: each member's bytes are its tenant's serial replay's
    prev = torchplan.set_kernel_plane(False)
    try:
        ser_off = serial()[0]
        bat_off = batched()[0]
    finally:
        torchplan.set_kernel_plane(prev)
    for a, b in zip(bat_off, ser_off):
        _same_bytes(a.bufs, b.bufs, ws)
    out = dict(batch_wall_s=bat_wall, solo_pass_wall_s=solo_wall,
               serial_4_direct_hits_wall_s=ser_wall, pass_pieces_s=pieces,
               launches=bat_counts, serial_launches=ser_counts,
               modelled_time_s=bat_model, serial_modelled_time_s=ser_model,
               max_abs_err_vs_vectorized=worst, kernels_held=held)
    log(f"batch vanilla_push x {BATCH_TENANTS}: {json.dumps(out)}")
    if profile_dir is not None:
        def one_pass():
            ins = [copy_bufs(b) for b in data]
            tickets = [t.submit("vanilla_push", b, ws, ws, **kw)
                       for t, b in zip(tenants, ins)]
            return cl.run_pending(), tickets
        _profiled("batch_pass", one_pass, profile_dir)
    return out


# ---------------------------------------------------------------------------
# 8. graph phase
# ---------------------------------------------------------------------------

class _Recording:
    """The service as the Pregel engine sees it, keeping every superstep's
    result and wall (the engine keeps only its decisions)."""

    def __init__(self, svc):
        self.svc, self.topology, self.results, self.walls = \
            svc, svc.topology, [], []

    def shuffle(self, *a, **kw):
        t0 = time.perf_counter()
        self.results.append(self.svc.shuffle(*a, **kw))
        self.walls.append(time.perf_counter() - t0)
        return self.results[-1]


def _pagerank_oracle(g, steps: int, drop=None):
    """PageRank by float64 power iteration (numpy's bincount per edge) and
    the bound of the kernel plane's float32 sums carried through the
    supersteps: each adds ``(len_v + 1) 2^-24 sum|c_e|`` at vertex v (with
    len_v its in-messages), and earlier errors reach v through the same
    bincount and the 0.85 damping.  ``drop`` leaves out one vertex's
    in-messages of superstep 1 (the control)."""
    import numpy as np
    n = g.num_vertices
    src, dst = g.src, g.dst
    outdeg = np.maximum(1, g.out_degree()).astype(np.float64)
    indeg = np.bincount(dst, minlength=n).astype(np.float64)
    r = np.full(n, 1.0 / n)
    err = np.zeros(n)
    for s in range(steps):
        c = r[src] / outdeg[src]
        e = err[src] / outdeg[src]
        inbox = np.bincount(dst, weights=c, minlength=n)
        if drop is not None and s == 0:
            inbox[drop] = 0.0
        prop = np.bincount(dst, weights=e, minlength=n)
        cabs = np.bincount(dst, weights=np.abs(c) + e, minlength=n)
        err = 0.85 * (prop + (indeg + 1) * U32 * cabs)
        r = (1.0 - 0.85) / n + 0.85 * inbox     # the program's own apply
    return r, err


def _bfs_levels(g, source: int, levels: int, inf: float):
    """Hop distances from ``source`` up to ``levels``; ``inf`` beyond."""
    import numpy as np
    n = g.num_vertices
    dist = np.full(n, inf)
    dist[source] = 0.0
    frontier = np.zeros(n, bool)
    frontier[source] = True
    for k in range(1, levels + 1):
        nxt = np.zeros(n, bool)
        nxt[g.dst[frontier[g.src]]] = True
        nxt &= dist == inf
        dist[nxt] = float(k)
        frontier = nxt
    return dist


def graph_phase(dev, profile_dir: Path | None) -> dict:
    """The paper's workload: PageRank and SSSP on an R-MAT graph at Graph500
    scale 20 (edge factor 16) through the port's Pregel engine on the card,
    then `shuffle_cache.run` on the plan cache."""
    import numpy as np
    import torch

    import repro_torch.core as port
    from repro_torch.apps.graph import SSSP, PageRank, PregelEngine, rmat_graph
    from repro_torch.launch import shuffle_cache

    nv = 1 << GRAPH_SCALE
    t0 = time.perf_counter()
    g = rmat_graph(nv, GRAPH_EDGE_FACTOR * nv, seed=0)
    log(f"graph: R-MAT scale {GRAPH_SCALE}, edge factor {GRAPH_EDGE_FACTOR}: "
        f"{nv} vertices, {g.num_edges} edges without self loops, made in "
        f"{time.perf_counter() - t0:.2f} s")
    svc = _Recording(port.TeShuService(_paper_topology(), device=dev))
    t0 = time.perf_counter()
    engine = PregelEngine(g, svc, template_id="network_aware")
    setup_s = time.perf_counter() - t0
    out = {"engine_setup_s": setup_s, "launches": {}}

    def run(name, program):
        svc.results.clear()
        svc.walls.clear()
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        with _Capture() as cap:
            if profile_dir is None:
                state = engine.run(program)
            else:
                state = _profiled(f"graph_{name}",
                                  lambda: engine.run(program), profile_dir)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
        held = _hold_path(f"graph {name}", cap.calls, counts)
        del cap
        hits = [r for r in svc.results if r.cached]
        for r in hits:                    # every cached superstep on torch
            assert r.engine == "torch" and r.fallback_reason is None, \
                (name, r.engine, r.fallback_reason)
        assert hits, name
        assert counts["segmented_fold"] > 0, counts
        for k, c in counts.items():
            out["launches"][k] = out["launches"].get(k, 0) + c
        out[name] = dict(wall_s=wall, supersteps=len(svc.results),
                         hits=len(hits), launches=counts, kernels_held=held,
                         shuffle_walls_s=svc.walls[:],
                         cached=[r.cached for r in svc.results],
                         wire_bytes=[r.stats["total_bytes"]
                                     for r in svc.results])
        return state, hits

    pr, _ = run("pagerank", PageRank(supersteps=PAGERANK_STEPS))
    assert out["pagerank"]["launches"]["partition_permute"] > 0
    want, err = _pagerank_oracle(g, PAGERANK_STEPS)
    assert pr.shape == want.shape and np.isfinite(pr).all()
    diff = np.abs(pr - want)
    assert (diff <= err).all(), f"PageRank: {int((diff > err).sum())} " \
        f"vertices outside the bound"
    top = int(np.argmax(np.bincount(g.dst, minlength=nv)))
    faulty, _ = _pagerank_oracle(g, PAGERANK_STEPS, drop=top)
    assert not (np.abs(pr - faulty) <= err).all(), \
        "control: PageRank without a top vertex's messages passed"
    share = np.divide(diff, err, out=np.zeros_like(diff), where=err > 0)
    out["pagerank"].update(max_abs_err=float(diff.max()),
                           worst_share_of_bound=float(share.max()))
    sssp_program = SSSP(source=0, supersteps=SSSP_STEPS)
    dist, _ = run("sssp", sssp_program)
    bfs = _bfs_levels(g, 0, SSSP_STEPS, sssp_program.inbox_default)
    assert np.array_equal(dist, bfs), "SSSP differs from the BFS levels"
    out["sssp"]["reached"] = int((bfs < sssp_program.inbox_default).sum())
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    with _Capture() as cap:
        sc = shuffle_cache.run("datacenter", "network_aware", 10, "auto")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    assert sc["cache_hits"] == 9 and sc["cache_misses"] == 1, sc
    assert sc["replay_engines"] == ["torch"] and not sc["replay_fallbacks"], sc
    assert counts["segmented_fold"] > 0, counts
    held = _hold_path("graph shuffle_cache", cap.calls, counts)
    del cap
    for k, c in counts.items():
        out["launches"][k] += c
    out["shuffle_cache"] = dict(sc, wall_s=wall, launches=counts,
                                kernels_held=held)
    log(f"graph: {json.dumps(out, default=str)}")
    return out


def _dot64(a, b) -> float:
    """The float64 dot product of two tensors' elements, in slices."""
    a, b = a.reshape(-1), b.reshape(-1)
    step = 1 << 26
    return sum(float((a[i:i + step].double() * b[i:i + step].double()).sum())
               for i in range(0, a.numel(), step))


def _grad_errors(lg, gg, lf, gf) -> dict:
    """The worst of every parameter's ``1 - cos`` and ``|norm ratio - 1|``
    of gradients ``gg`` against ``gf`` (the one-element leaves' norm ratio
    apart, as ``norm_one``), and the losses' relative difference; each
    with its parameter.  A gradient of ``gf`` on the host is compared on
    its counterpart's device, one leaf at a time."""
    out = {"loss": (abs(lg - lf) / abs(lf), "")}
    cos, norm = (0.0, ""), {"norm": (0.0, ""), "norm_one": (0.0, "")}
    for n, b in gf.items():
        a = gg[n]
        b = b.to(a.device)
        na, nb = _dot64(a, a) ** 0.5, _dot64(b, b) ** 0.5
        c = 1.0 if na == 0 or nb == 0 else 1 - _dot64(a, b) / (na * nb)
        r = abs(na / nb - 1) if nb else (0.0 if na == 0 else float("inf"))
        key = "norm_one" if b.numel() == 1 else "norm"
        cos, norm[key] = max(cos, (c, n)), max(norm[key], (r, n))
    out.update(cos=cos, **norm)
    return out


def _miss(err: dict, bound: dict = GRAD_BOUND) -> float:
    """How many times the worst quantity of ``err`` exceeds its bound (the
    one-element leaves' norm ratio: ``bound["norm"]`` unless the bound
    sets ``norm_one``)."""
    lim = dict(bound)
    lim.setdefault("norm_one", lim["norm"])
    return max(err[k][0] / lim[k] for k in lim)


@contextlib.contextmanager
def _routing_held(calls: list):
    """The port's router (``moe._route``) made to choose the experts of
    ``calls`` (the ``eids`` one MoE layer's router chose in a recorded
    run, returned at every call: its forward and remat's recompute), each
    token's weights its own probabilities at them, renormalised, and the
    aux loss by the same top-1 shares: the router's own arithmetic, bit
    for bit where its own choice is the recorded one."""
    import torch

    from repro_torch.models import moe

    assert len(calls) == 1, len(calls)
    real = moe._route

    def route(router_w, x_flat, m):
        probs = torch.softmax((x_flat @ router_w).float(), dim=-1)
        eids = calls[0]
        weights = probs.gather(1, eids.long())
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-9)
        top1 = torch.arange(m.num_experts, device=eids.device)
        f = (eids[:, :1] == top1).float().mean(0)
        return eids, weights, m.num_experts * (f * probs.mean(0)).sum()
    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def _grad_check(dev, arch: str, shape: dict, bound: dict, mixer,
                seed: int = 0, host: bool = False,
                dtypes: tuple = ("bfloat16", "float32"),
                spread_bound: dict | None = None) -> dict:
    """(a): the gradients of the model in ``dtypes[0]`` against a copy's
    in ``dtypes[1]`` (the same bf16 weights, cast) at full width,
    ``shape["layers"]`` layers, one batch of ``shape["batch"] x
    shape["seq_len"]`` tokens, within ``bound``; the controls (the labels
    shifted one position; ``mixer()``'s ``(owner, name)``, the family's
    mixer, its output detached) must miss it by 10x.  A MoE model's copies
    take the bf16 model's expert choices (:func:`_routing_held`), so that
    only the arithmetic differs.  ``host``: the second copy's gradients
    wait on the host while the first's are taken.  ``spread_bound``: the
    bf16 model's gradients are also measured against the float32 copy's
    (``dtypes`` float32 and float64), logged against it, not held."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset, make_global_batch
    from repro_torch.models import lm, moe
    from repro_torch.optim import microbatch_grads

    cfg = dataclasses.replace(get_config(arch), n_layers=shape["layers"])
    bf = lm.init_lm(cfg, seed=seed, device=dev)

    def copy(dtype):
        if dtype == cfg.dtype:
            return bf
        out = lm.LM(dataclasses.replace(cfg, dtype=dtype), device=dev)
        with torch.no_grad():
            for (_, p), (_, q) in zip(bf.named_parameters(),
                                      out.named_parameters()):
                q.copy_(p)
        return out

    ds = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=shape["seq_len"],
        global_batch=shape["batch"], seed=seed))
    batch = make_global_batch(ds.batch_at(0), dev)
    calls: list = []
    if cfg.moe is not None:               # the bf16 model's choices
        real = moe._route

        def record(router_w, x_flat, m):
            out = real(router_w, x_flat, m)
            calls.append(out[0])
            return out
        moe._route = record
        try:
            with torch.no_grad():
                lm.forward(bf, tokens=batch["tokens"], train=True)
        finally:
            moe._route = real

    def grads(model, b):
        model.requires_grad_(True)
        with _routing_held(calls) if calls else contextlib.nullcontext():
            loss, g = microbatch_grads(
                lambda p, mb: lm.train_loss(model, mb),
                dict(model.named_parameters()), b, 1)
        return float(loss), g

    t0 = time.perf_counter()
    high = copy(dtypes[1])
    lf, gf = grads(high, batch)
    del high
    if host:
        gf = {n: g.to("cpu") for n, g in gf.items()}
        torch.cuda.empty_cache()
    low = copy(dtypes[0])
    lg, gg = grads(low, batch)
    held = _grad_errors(lg, gg, lf, gf)
    res = {"dtypes": list(dtypes), "held": held}
    if spread_bound is not None:          # bf16 against this float32 copy
        res["bf16_spread"] = _grad_errors(*grads(bf, batch), lg, gg)
        res["bf16_spread_misses"] = _miss(res["bf16_spread"], spread_bound)
    del gg
    shifted = _grad_errors(*grads(low, dict(
        batch, labels=torch.roll(batch["labels"], 1, dims=1))), lf, gf)
    owner, name = mixer()
    orig = getattr(owner, name)

    def detached(*a, **k):
        out, rest = orig(*a, **k)
        return out.detach(), rest
    setattr(owner, name, detached)
    try:
        dropped = _grad_errors(*grads(low, batch), lf, gf)
    finally:
        setattr(owner, name, orig)
    del bf, low, gf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res.update({"labels_shifted": shifted, "mixer_detached": dropped,
                "mixer": f"{getattr(owner, '__name__', owner)}.{name}",
                "bound": bound, "misses": {
                    "held": _miss(held, bound),
                    "labels_shifted": _miss(shifted, bound),
                    "mixer_detached": _miss(dropped, bound)},
                "seconds": time.perf_counter() - t0})
    log(f"train grad check: {arch} full width, {cfg.n_layers} layers, "
        f"{shape['batch']} x {shape['seq_len']}, {dtypes[0]} against "
        f"{dtypes[1]}: {json.dumps(res)}")
    assert _miss(held, bound) <= 1.0, held
    for c in ("labels_shifted", "mixer_detached"):
        assert res["misses"][c] >= 10.0, (arch, c, res[c])
        log(f"train grad check {arch} control {c}: misses by "
            f"{res['misses'][c]:.1f}x")
    return res


def _restart_check(dev) -> dict:
    """(c): at SMOKE on the card, 6 steps with a checkpoint every 3 against
    a run resumed from step 3."""
    import shutil

    import torch

    from repro_torch.launch.train import train

    base = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(base, ignore_errors=True)
    kw = dict(smoke=True, steps=6, global_batch=4, seq_len=64, n_micro=2,
              ckpt_every=3, device=dev, seed=3, log_every=10)
    full = train(TRAIN_ARCH, ckpt_dir=str(base / "a"), **kw)
    (base / "b").mkdir(parents=True)
    shutil.copytree(base / "a" / "step_00000003", base / "b" / "step_00000003")
    resumed = train(TRAIN_ARCH, ckpt_dir=str(base / "b"), **kw)
    want = [h["loss"] for h in full["history"][3:]]
    got = [h["loss"] for h in resumed["history"]]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(want, got))
    diffs = [float((p - q).detach().abs().max()) for (_, p), (_, q) in zip(
        full["params"].named_parameters(), resumed["params"].named_parameters())]
    bitwise = got == want and max(diffs) == 0.0 and all(
        torch.equal(full["opt_state"][k][n], resumed["opt_state"][k][n])
        for k in ("m", "v") for n in full["opt_state"]["m"])
    shutil.rmtree(base, ignore_errors=True)
    res = {"resumed_losses": got, "uninterrupted_losses": want,
           "loss_rel": loss_rel, "param_abs": max(diffs),
           "bit_for_bit": bitwise, "bound": RESTART_BOUND}
    log(f"train restart check (SMOKE, float32): {json.dumps(res)}")
    assert len(got) == 3 and loss_rel <= RESTART_BOUND["loss_rel"], res
    assert max(diffs) <= RESTART_BOUND["param_abs"], res
    return res


def _f32_matmul(name: str) -> bool:
    """A float32 matmul kernel (``_attend``'s einsums with TF32 off), by the
    type markers of cuBLAS's kernel names."""
    return any(t in name for t in ("sgemm", "f32f32_f32f32", "_sss_",
                                   "fp32", "f32_f32")) and "bf16" not in name


MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def _matmul_flop(op: str, shapes) -> int:
    """``2 M K N`` (times the batch) of one matmul op from its recorded
    input shapes; 0 where they are not those of a matmul."""
    dims = [list(t) for t in shapes if len(t) in (2, 3)]
    if op.startswith("aten::add") or op.startswith("aten::badd"):
        dims = dims[-2:]
    if len(dims) != 2 or dims[0][-1] != dims[1][-2]:
        return 0
    (a, b) = dims
    batch = a[0] if len(a) == 3 else 1
    return 2 * batch * a[-2] * a[-1] * b[-1]


def _matmul_rates(prof) -> tuple[dict, list[str]]:
    """The traced matmul ops' FLOP (from their input shapes) and device
    ms, by op and by shape: ``({op: {"flop", "device_ms", "calls"}}, the
    rows by shape)``."""
    by_op: dict[str, dict] = {}
    rows = []
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key not in MATMUL_OPS:
            continue
        ms = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        flop = _matmul_flop(e.key, e.input_shapes) * e.count
        t = by_op.setdefault(e.key, {"flop": 0, "device_ms": 0.0, "calls": 0})
        t["flop"] += flop
        t["device_ms"] += ms
        t["calls"] += e.count
        rows.append((ms, f"{ms:10.3f} ms  {e.count:5d} x {e.key} "
                         f"{e.input_shapes}: {flop:.4g} FLOP, "
                         f"{flop / ms / 1e9 if ms else 0.0:.1f} TFLOP/s"))
    return by_op, [r for _, r in sorted(rows, reverse=True)]


def _profile_train(model, opt_state, batch, ocfg, recipe, profile_dir: Path,
                   tag: str = "", ops: bool = True):
    """One training step of ``model`` traced, its gradients and its AdamW
    update in two sessions: device time by kernel class (bf16 matmuls,
    float32 matmuls, the rest), every kernel by name with its class, and
    (``ops``) the matmul ops' FLOP rates from their recorded shapes.
    Without ``ops`` only the device is traced (xLSTM's step, whose ops on
    the host are the most); the files are ``profile_train_{tag}
    {grads,update}.txt``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    from repro_torch.optim import adamw_update, microbatch_grads

    params = dict(model.named_parameters())
    out: dict = {}

    def traced(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA] if ops else
                     [ProfilerActivity.CUDA], record_shapes=ops) as prof:
            time.sleep(0.05)
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(0.05)
        busy: dict[str, float] = {}
        names: dict[str, float] = {}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or e.name in (
                    "Activity Buffer Request", "Command Buffer Full") \
                    or e.name.startswith(RANGES):  # a range, not a kernel
                continue
            c = _kernel_class(e.name)
            if c == "matmul":
                c = "matmul_f32" if _f32_matmul(e.name) else "matmul_bf16"
            elif name == "update":
                c = "optimizer"
            else:
                c = "elementwise_and_other"
            ms = e.device_time_total / 1e3
            busy[c] = busy.get(c, 0.0) + ms
            names[f"{c}: {e.name[:90]}"] = names.get(
                f"{c}: {e.name[:90]}", 0.0) + ms
        every = sorted(names.items(), key=lambda kv: -kv[1])
        rates, shape_rows = _matmul_rates(prof) if ops else ({}, [])
        (profile_dir / f"profile_train_{tag}{name}.txt").write_text(
            prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
            + "\n\nevery kernel, by class:\n"
            + "\n".join(f"{ms:10.3f} ms  {k}" for k, ms in every)
            + "\n\nmatmul ops by input shape:\n" + "\n".join(shape_rows))
        out[name] = {"wall_ms": wall * 1e3, "device_ms_by_class": busy,
                     "matmul_ops": rates}
        log(f"profile train {tag}{name}: wall_ms={wall * 1e3!r} device_ms_by_class="
            f"{json.dumps(busy)} idle_share="
            f"{1 - sum(busy.values()) / (wall * 1e3)!r} matmul_ops="
            f"{json.dumps(rates)}")
        return res

    profile_dir.mkdir(parents=True, exist_ok=True)
    _, grads = traced("grads", lambda: microbatch_grads(
        lambda p, b: lm.train_loss(model, b), params, batch, recipe.n_micro,
        accum_dtype=recipe.accum_dtype))
    traced("update", lambda: adamw_update(ocfg, params, grads, opt_state))
    return out


def train_phase(dev, profile_dir: Path | None) -> dict:
    """Phase 7b: the gradient check, six steps of ``train()`` on the
    8-layer full-width model, the SMOKE restart, and with ``--profile`` one
    step traced."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset, make_global_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.steps import _with_recipe, recipe_for
    from repro_torch.launch.train import train
    from repro_torch.models import layers, lm
    from repro_torch.models.config import SHAPES
    from repro_torch.optim import AdamWConfig, adamw_update

    res = {"grad_check": _grad_check(dev, TRAIN_ARCH, GRAD_CHECK, GRAD_BOUND,
                                     lambda: (layers.Attention, "forward"),
                                     seed=TRAIN["seed"])}

    recipe = recipe_for(TRAIN_ARCH, SHAPES["train_4k"])
    # train() keeps float32 moments and accumulation, as the reference's
    assert (recipe.moment_dtype, recipe.accum_dtype) == ("float32",
                                                         "float32"), recipe
    recipe = dataclasses.replace(recipe, lr=TRAIN["lr"])
    cfg = _with_recipe(dataclasses.replace(get_config(TRAIN_ARCH),
                                           n_layers=TRAIN_LAYERS), recipe)
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=TRAIN["seed"], device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    snap = {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}
    log(f"train weights: {TRAIN_ARCH} {cfg.n_layers} of "
        f"{get_config(TRAIN_ARCH).n_layers} layers, {n_params} parameters, "
        f"made on the card and copied to the host in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:                     # the training path, alone
        k.launches = 0
    t0 = time.perf_counter()
    out = train(TRAIN_ARCH, smoke=False, device=dev, params=model,
                log_every=1, n_micro=recipe.n_micro, **TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in KERNELS}
    log(f"train launches: {json.dumps(launches)}")
    assert all(launches[k] == 0 for k in ("flash_attention",
                                          "decode_attention", "gmm")), launches
    hist = out["history"]
    assert len(hist) == TRAIN["steps"]
    for h in hist:
        log(f"train step: loss={h['loss']!r} grad_norm={h['grad_norm']!r} "
            f"lr={h['lr']!r} seconds={h['seconds']!r}")
    opt_state = out["opt_state"]
    still = _trained(model, snap, opt_state, hist)
    del snap
    log(f"train moved: {n_params} parameters in "
        f"{len(dict(model.named_parameters())) - len(still)} of "
        f"{len(dict(model.named_parameters()))} tensors; unmoved (each step "
        f"under half a bf16 step, moments nonzero): {still}")

    # one more microbatch's gradients: finite and nonzero for every tensor
    params = dict(model.named_parameters())
    grads = _next_grads(model, cfg, TRAIN, recipe.n_micro, dev)
    # the AdamW update timed apart, on float32 gradients (the accumulated
    # ones' dtype) over the trained state
    g32 = {n: g.float() for n, g in grads.items()}
    del grads
    ocfg = AdamWConfig(lr=TRAIN["lr"], total_steps=TRAIN["steps"],
                       warmup_steps=max(1, TRAIN["steps"] // 10))
    times = []
    for _ in range(3):
        g = {n: t.clone() for n, t in g32.items()}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        adamw_update(ocfg, params, g, opt_state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    del g32
    step_s = statistics.median(h["seconds"] for h in hist[1:])
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    n_mm = sum(p.numel() for n, p in params.items()
               if p.dim() >= 2 and n != "embed")
    attn = 6 * TRAIN["global_batch"] * TRAIN["seq_len"] ** 2 * cfg.n_heads \
        * cfg.d_head * cfg.n_layers          # causal, forward and backward
    flops = 6 * n_mm * tokens + attn
    update_s = statistics.median(times)
    res.update(
        steps=[{k: h[k] for k in ("loss", "grad_norm", "lr", "seconds")}
               for h in hist],
        step_s=step_s, tokens_per_s=tokens / step_s, update_s=update_s,
        update_share=update_s / step_s, peak_bytes=peak,
        matmul_params=n_mm, model_flops=flops,
        bf16_peak_share=flops / step_s / BF16_PEAK, wall_s=wall,
        launches=launches, unmoved=still)
    log(f"train phase: {json.dumps({k: v for k, v in res.items() if k not in ('grad_check', 'steps')})}")
    if profile_dir is not None:
        full = make_global_batch(SyntheticLMDataset(DataConfig(
            vocab=cfg.vocab, seq_len=TRAIN["seq_len"],
            global_batch=TRAIN["global_batch"], seed=TRAIN["seed"])).batch_at(
                TRAIN["steps"] + 1), dev)
        res["profile"] = _profile_train(model, opt_state, full, ocfg, recipe,
                                        profile_dir)
    _train_count(model, opt_state, cfg, recipe, dev)   # the dry run's (8)
    del model, out, opt_state, params
    torch.cuda.empty_cache()
    res["restart"] = _restart_check(dev)
    return res


EP_TRAIN_LAYERS = 1                  # of 94: 3.73e9 parameters, about 60 GB
                                     # of weights, gradients, moments and
                                     # accumulation in train()
EP_TRAIN = dict(steps=6, global_batch=8, seq_len=1024, lr=3e-4, seed=0)
EP_TRAIN_MICRO = 2
EP_GRAD_CONTROL = "the exchange's backward returning zeros"


def _ep_grads(model, batch, mesh=None):
    """One microbatch's loss and gradients through ``lm.train_loss``:
    under ``mesh`` the EP dispatch, summed over the mesh as the step sums
    them; without it the gspmd branch."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import microbatch_grads

    params = dict(model.named_parameters())
    loss, grads = microbatch_grads(
        lambda p, b: lm.train_loss(model, b, mesh=mesh), params, batch, 1)
    if mesh is not None:
        grads = steps.sum_grads(grads, mesh, steps.split_leaves(
            model.specs, mesh))
    torch.cuda.synchronize()
    return float(loss), grads


def _ep_layout(cfg, params, mesh, calls: dict, wire: dict, steps_: int,
               n_micro: int, tokens: int) -> dict:
    """The collectives ``train(mesh=...)`` made against the layout's:
    per MoE layer and microbatch the dispatch and return all-to-alls
    forward, again in the block's recompute (remat), and their adjoints
    backward (six; the flat all-to-all on one EP axis), the all-gather
    over ``model`` (the recompute stops before it) and its adjoint, a
    reduce-scatter, and the aux loss's ``pmean`` and its adjoint, two
    float32 all-reduces; per microbatch the all-reduce of the count of
    labels; per step the gradient sums (``steps.sum_plan``: each leaf over
    the axes its spec does not name, packed by dtype into buffers of at
    most ``steps.BUCKET_BYTES``; a leaf whose spec names both axes is not
    summed), the loss's and the norm's (one an axis set the specs name).
    The placed leaves add no gather and no reduce-scatter (every axis has
    size 1).  All-to-all bytes: three passes of the ``E cap (2 d + 1)``
    elements of the forward pair."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import moe

    layers = sum(1 for b in params.blocks if hasattr(b, "moe"))
    per = layers * n_micro * steps_
    meta = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
            for n, p in params.named_parameters()}
    split = steps.split_leaves(params.specs, mesh)
    plan = steps.sum_plan(meta, mesh, split)
    sums = len(plan)
    summed = sum(meta[n].numel() * 4 for _, names in plan for n in names)
    norms = len(set(split.values()))
    want = dict(all_to_all=6 * per, all_gather=per, reduce_scatter=per,
                all_reduce=steps_ * (n_micro + sums + 1 + norms) + 2 * per,
                send_recv=0)
    cap = moe._capacity(tokens // n_micro, cfg.moe)
    esz = params.embed.element_size()
    a2a = 3 * cfg.moe.num_experts * cap * (2 * cfg.d_model + 1) * esz * per
    reduce_bytes = steps_ * (summed + 4 * (n_micro + 1 + norms)) \
        + 4 * 2 * per
    assert calls == want, (calls, want)
    assert wire["all_to_all"] == a2a, (wire, a2a)
    assert wire["all_reduce"] == reduce_bytes, (wire, reduce_bytes)
    return dict(calls=calls, wire_bytes=wire, gradient_sums_a_step=sums,
                gradient_bytes_summed_a_step=summed,
                norm_all_reduces_a_step=norms, capacity=cap)


def ep_train_phase(dev, profile_dir: Path | None, mesh) -> dict:
    """Phase 7c: Qwen3-MoE trained over the one-rank NCCL mesh at full
    width, 1 of 94 layers, on its own ``teshu2`` dispatch: (a) one
    microbatch's gradients through the EP dispatch against the gspmd
    branch's on the same weights and batch, with two controls; (b) six
    steps of ``train(mesh=...)``; (c) the same steps on the gspmd branch
    from the same weights (restored from a host copy) for the timing; (d)
    the SMOKE restart under the mesh."""
    import dataclasses
    import math
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import meshops
    from repro_torch.data import DataConfig, SyntheticLMDataset, make_global_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.shardings import ep_axes_for
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.models.layers import dense_init

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=EP_TRAIN_LAYERS)
    assert cfg.moe.dispatch == "teshu2" and cfg.remat, cfg
    assert ep_axes_for(mesh) == ("model",), mesh
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=EP_TRAIN["seed"], device=dev, mesh=mesh)
    assert not model._split and not model._gathers(mesh), model._split
    gen = torch.Generator(device=dev).manual_seed(EP_TRAIN["seed"] + 1)
    with torch.no_grad():                 # each expert drawn on its own
        for b in model.blocks:
            for w in (b.moe.experts.w_gate, b.moe.experts.w_up,
                      b.moe.experts.w_down):
                for e in range(w.shape[0]):
                    w[e].copy_(dense_init(gen, w.shape[1], w.shape[2],
                                          w.dtype, dev))
    n_params = sum(p.numel() for p in model.parameters())
    snap = {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}
    log(f"ep train weights: {MOE_ARCH} {cfg.n_layers} of "
        f"{get_config(MOE_ARCH).n_layers} layers, {n_params} parameters, "
        f"made on the card and copied to the host in "
        f"{time.perf_counter() - t0:.2f} s")
    res: dict = {"parameters": n_params}

    # (a) one microbatch's gradients: the EP dispatch against gspmd
    model.requires_grad_(True)
    ds = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=EP_TRAIN["seq_len"],
        global_batch=EP_TRAIN["global_batch"] // EP_TRAIN_MICRO,
        seed=EP_TRAIN["seed"]))
    batch = make_global_batch(ds.batch_at(0), dev)
    t0 = time.perf_counter()
    lf, gf = _ep_grads(model, batch)
    le, ge = _ep_grads(model, batch, mesh)
    bitwise = le == lf and all(torch.equal(ge[n], g) for n, g in gf.items())
    held = _grad_errors(le, ge, lf, gf)
    del ge
    back = meshops._AllToAll.backward
    meshops._AllToAll.backward = staticmethod(
        lambda ctx, g: (torch.zeros_like(g), None, None, None, None))
    try:
        zeroed = _grad_errors(*_ep_grads(model, batch, mesh), lf, gf)
    finally:
        meshops._AllToAll.backward = staticmethod(back)
    with _experts_rolled(cfg):
        roll = _grad_errors(*_ep_grads(model, batch, mesh), lf, gf)
    del gf
    res["grad_check"] = {
        "bit_for_bit": bitwise, "held": held, "exchange_backward_zero":
        zeroed, "experts_rolled": roll, "bound": GRAD_BOUND,
        "misses": {"held": _miss(held), EP_GRAD_CONTROL: _miss(zeroed),
                   EP_CONTROL: _miss(roll)},
        "seconds": time.perf_counter() - t0}
    log(f"ep train grad check: {MOE_ARCH} full width, {cfg.n_layers} layer, "
        f"{batch['tokens'].shape[0]} x {EP_TRAIN['seq_len']}, EP dispatch "
        f"over {mesh.shape} against gspmd: {json.dumps(res['grad_check'])}")
    assert bitwise or _miss(held) <= 1.0, held
    for name, err in ((EP_GRAD_CONTROL, zeroed), (EP_CONTROL, roll)):
        assert _miss(err) >= 10.0, (name, err)
    del batch
    torch.cuda.empty_cache()

    # (b) six steps of train(mesh=...)
    runs = {}
    for branch in ("ep", "gspmd"):
        if branch == "gspmd":             # (c): the same weights, gspmd
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(snap[n])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in KERNELS:
            k.launches = 0
        meshops.reset_counts()
        t0 = time.perf_counter()
        out = train(MOE_ARCH, smoke=False, device=dev, params=model,
                    mesh=mesh if branch == "ep" else None, log_every=1,
                    n_micro=EP_TRAIN_MICRO, **EP_TRAIN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in KERNELS}
        calls, wire = dict(meshops.COUNTS), dict(meshops.BYTES)
        hist = out["history"]
        assert len(hist) == EP_TRAIN["steps"]
        assert all(launches[k] == 0 for k in ("flash_attention",
                                              "decode_attention", "gmm")), \
            launches
        for h in hist:
            assert math.isfinite(h["loss"]) and math.isfinite(
                h["grad_norm"]), h
            log(f"ep train {branch} step: loss={h['loss']!r} "
                f"grad_norm={h['grad_norm']!r} seconds={h['seconds']!r}")
        step_s = statistics.median(h["seconds"] for h in hist[1:])
        tokens = EP_TRAIN["global_batch"] * EP_TRAIN["seq_len"]
        runs[branch] = dict(
            step_s=step_s, tokens_per_s=tokens / step_s,
            peak_bytes=torch.cuda.max_memory_allocated(), wall_s=wall,
            launches=launches, losses=[h["loss"] for h in hist],
            grad_norms=[h["grad_norm"] for h in hist])
        if branch == "ep":
            opt_state = out["opt_state"]
            still = _trained(model, snap, opt_state, hist)
            runs[branch]["layout"] = _ep_layout(
                cfg, model, mesh, calls, wire, EP_TRAIN["steps"],
                EP_TRAIN_MICRO, tokens)
            res["placement"] = _placement(model, mesh, opt_state)
            runs[branch]["unmoved"] = still
            del opt_state
            if profile_dir is not None:
                runs[branch]["profile"] = _profile_ep_step(
                    model, cfg, dev, mesh, profile_dir)
        del out
        torch.cuda.empty_cache()
    res.update(runs)
    log(f"ep train phase: {json.dumps(res['ep'])}")
    log(f"ep train gspmd: {json.dumps(res['gspmd'])}")
    del model, snap
    torch.cuda.empty_cache()

    # (d) the SMOKE restart under the mesh
    base = ROOT / "build" / "chip_smoke_ep_train"
    shutil.rmtree(base, ignore_errors=True)
    kw = dict(smoke=True, steps=6, global_batch=4, seq_len=64, n_micro=2,
              ckpt_every=3, device=dev, seed=3, log_every=10, mesh=mesh)
    full = train(MOE_ARCH, ckpt_dir=str(base / "a"), **kw)
    (base / "b").mkdir(parents=True)
    shutil.copytree(base / "a" / "step_00000003", base / "b" / "step_00000003")
    resumed = train(MOE_ARCH, ckpt_dir=str(base / "b"), **kw)
    want = [h["loss"] for h in full["history"][3:]]
    got = [h["loss"] for h in resumed["history"]]
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(want, got))
    diffs = [float((p - q).detach().abs().max()) for (_, p), (_, q) in zip(
        full["params"].named_parameters(),
        resumed["params"].named_parameters())]
    bitwise = got == want and max(diffs) == 0.0 and all(
        torch.equal(full["opt_state"][k][n], resumed["opt_state"][k][n])
        for k in ("m", "v") for n in full["opt_state"]["m"])
    shutil.rmtree(base, ignore_errors=True)
    res["restart"] = {"resumed_losses": got, "uninterrupted_losses": want,
                      "loss_rel": loss_rel, "param_abs": max(diffs),
                      "bit_for_bit": bitwise, "bound": RESTART_BOUND}
    log(f"ep train restart check (SMOKE, float32, over {mesh.shape}): "
        f"{json.dumps(res['restart'])}")
    assert len(got) == 3 and loss_rel <= RESTART_BOUND["loss_rel"], res
    assert max(diffs) <= RESTART_BOUND["param_abs"], res
    return res


# the families' training phases (7d): full width, seed 0, depth cut where
# the card holds no more; "n_micro" of train()'s Recipe (float32 moments and
# accumulation) but for DeepSeek-V2, which trains on its own recipe
# (steps.recipe_for, bf16 moments and accumulation) with this n_micro.  3
# steps each: with 4 the whole run took 1,143 s on an H100 (700 W), past
# 1,000
FAMILY_TRAIN = {
    HYMBA_ARCH: dict(layers=32, steps=3, global_batch=4, seq_len=4096,
                     n_micro=2, lr=3e-4, seed=0),
    XLSTM_ARCH: dict(layers=24, steps=3, global_batch=4, seq_len=4096,
                     n_micro=1, lr=3e-4, seed=0),
    DEEPSEEK_ARCH: dict(layers=2, steps=3, global_batch=8, seq_len=1024,
                        n_micro=2, lr=3e-4, seed=0),
}
# (a) of each: layers (Hymba: global layer 0 and windowed layer 1; xLSTM:
# the sLSTM block at index 7), one batch of batch x seq_len tokens, and the
# two dtypes compared.  Hymba and xLSTM hold float32 against float64 within
# GRAD_BOUND: their bf16 gradients sit from float32's by more than any bound
# a detached mixer misses by 10x at full width (xLSTM 1 - cos 1-6e-2 a leaf,
# as the JAX package's own bf16 gradients do; Hymba's one-element dt_bias
# 10.2 and 13.9 on the card), so that spread is logged against
# FAMILY_BOUNDS, not held
FAMILY_CHECK = {
    HYMBA_ARCH: dict(layers=2, batch=1, seq_len=2048,
                     dtypes=("float32", "float64")),
    XLSTM_ARCH: dict(layers=8, batch=1, seq_len=1024,
                     dtypes=("float32", "float64")),
    DEEPSEEK_ARCH: dict(layers=2, batch=1, seq_len=512,
                        dtypes=("bfloat16", "float32")),
}
# each family's bf16 bound, set before the card ran it from the same check
# on the CPU at SMOKE width over seeds 0-2 (tests/test_torch_train_loss.py
# holds each under a third of it): GRAD_BOUND, but Hymba's one-element
# leaves' norm ratio (its dt_bias, a gradient summed over every position
# and channel: 2.9 at seed 1) and DeepSeek-V2's cosine (its routed experts,
# tokens routed otherwise in bf16: 5.9e-3)
FAMILY_BOUNDS = {
    HYMBA_ARCH: dict(GRAD_BOUND, norm_one=9.0),
    XLSTM_ARCH: GRAD_BOUND,
    DEEPSEEK_ARCH: dict(GRAD_BOUND, cos=2e-2),
}


def _family_mixer(arch: str):
    """``(owner, name)`` of the family's own mixer, whose output the
    second control of (a) detaches."""
    from repro_torch.models import hybrid, layers, lm
    return {HYMBA_ARCH: (hybrid, "mamba_forward"),
            XLSTM_ARCH: (lm, "slstm_forward"),
            DEEPSEEK_ARCH: (layers.MLA, "forward")}[arch]


@contextlib.contextmanager
def _experts_rolled(cfg):
    """``EP_CONTROL``: the routed stack's local expert axis rolled by one
    before the expert products (the shared experts left as they are)."""
    from repro_torch.models import moe

    real = moe._expert_ffn

    def rolled(w, x, **k):
        if x.shape[0] == cfg.moe.num_experts == w.w_gate.shape[0]:
            x = x.roll(1, 0)
        return real(w, x, **k)
    moe._expert_ffn = rolled
    try:
        yield
    finally:
        moe._expert_ffn = real


def _trained(model, snap: dict, opt_state: dict, hist: list) -> list:
    """(b)'s checks after the steps: every loss and gradient norm finite,
    every moment finite and nonzero, every parameter moved or a bf16
    weight whose every step fell under half its bf16 step (``|p| 2^-9``
    above the sum of the steps' lr: no master weights, as in the
    reference).  Returns the unmoved parameters' names."""
    import math

    import torch

    for h in hist:
        assert math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]), h
    bad = [n for n in opt_state["m"] if not all(
        bool(torch.isfinite(opt_state[k][n]).all())
        and float(opt_state[k][n].abs().max()) > 0 for k in ("m", "v"))]
    assert not bad, f"moments zero or not finite: {bad}"
    lr_sum = sum(h["lr"] for h in hist)
    still = []
    for n, p in model.named_parameters():
        if torch.equal(p.detach().cpu(), snap[n]):
            assert float(snap[n].float().abs().min()) * 2.0 ** -9 > lr_sum, n
            still.append(n)
    return still


def _next_grads(model, cfg, traffic: dict, n_micro: int, dev) -> dict:
    """One more microbatch's gradients (the batch after the steps'):
    finite and nonzero for every parameter."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLMDataset, make_global_batch
    from repro_torch.models import lm
    from repro_torch.optim import microbatch_grads

    ds = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=traffic["seq_len"],
        global_batch=traffic["global_batch"] // n_micro,
        seed=traffic["seed"]))
    batch = make_global_batch(ds.batch_at(traffic["steps"]), dev)
    _, grads = microbatch_grads(lambda p, b: lm.train_loss(model, b),
                                dict(model.named_parameters()), batch, 1)
    zero = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())
            or float(g.abs().max()) == 0]
    assert not zero, f"no finite nonzero gradient: {zero}"
    return grads


def _family_flops(model, cfg, batch: int, seq: int) -> dict:
    """A step's model FLOP: ``6 x matmul parameters x tokens`` (every
    leaf that multiplies a token's activations: the >= 2-D leaves but the
    token table where an unembedding of its own exists, the Mamba head's
    depthwise ``conv`` and its ``log_a``; a routed expert stack counted at
    ``top_k / E`` of its size; sLSTM's ``w_rec`` once a token), plus the
    family's core from the shapes, forward and backward (3 x the
    forward): causal attention ``12 B H dh K`` over its ``K`` (query, key)
    pairs (a window of w: ``w (w + 1) / 2 + (S - w) w``; none: ``S (S + 1)
    / 2``); the Mamba scan ``18 B S di n`` (the decay and input products,
    the recurrence's multiply-add and C's contraction: 6 FLOP an element
    forward); mLSTM's chunks ``3 B S (4 L di + 4 dh di)`` (the L x L
    scores and their values, the carried state's product and update); MLA
    ``6 B H (dqk + dv) K``."""
    from repro_torch.models.lm import layer_window

    tokens = batch * seq
    n_mm = 0
    for n, p in model.named_parameters():
        if p.dim() < 2 or n.endswith((".conv", ".log_a")) or (
                n == "embed" and model.unembed is not None):
            continue
        share = (cfg.moe.top_k / cfg.moe.num_experts
                 if ".moe.experts." in n else 1.0)
        n_mm += p.numel() * share

    def pairs(w: int) -> int:
        return seq * (seq + 1) // 2 if not w or w >= seq else \
            w * (w + 1) // 2 + (seq - w) * w

    core = 0
    for i, b in enumerate(model.blocks):
        if cfg.family == "hybrid":
            di, n = cfg.d_model * cfg.ssm.expand, cfg.ssm.state_dim
            core += 12 * batch * cfg.n_heads * cfg.d_head * pairs(
                layer_window(cfg, i)) + 18 * tokens * di * n
        elif cfg.family == "ssm" and hasattr(b, "mlstm"):
            di = 2 * cfg.d_model
            L, dh = min(256, seq), di // cfg.n_heads
            core += 3 * tokens * (4 * L * di + 4 * dh * di)
        elif cfg.mla is not None:
            m = cfg.mla
            core += 6 * batch * cfg.n_heads * (
                m.nope_head_dim + m.rope_head_dim + m.v_head_dim) * pairs(0)
    flops = 6 * n_mm * tokens + core
    return {"matmul_params": n_mm, "core_flops": core, "model_flops": flops}


def _recipe_steps(model, cfg, recipe, ocfg, traffic: dict, dev) -> tuple:
    """``traffic["steps"]`` steps of ``steps.make_train_step`` on
    ``recipe`` without a mesh, on the synthetic batches ``train()`` reads:
    ``(history, opt_state)``, each step's ``seconds`` its wall time, the
    device synchronised."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLMDataset, make_global_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import init_opt_state

    model.requires_grad_(True)
    opt_state = init_opt_state(dict(model.named_parameters()),
                               recipe.moment_dtype)
    ds = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=traffic["seq_len"],
        global_batch=traffic["global_batch"], seed=traffic["seed"]))
    step_fn = make_train_step(cfg, ocfg, recipe)
    hist = []
    for i in range(traffic["steps"]):
        batch = make_global_batch(ds.batch_at(i), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, opt_state, metrics = step_fn(model, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        metrics["seconds"] = time.perf_counter() - t0
        hist.append(metrics)
    return hist, opt_state


def _ep_check(model, cfg, dev, mesh, traffic: dict) -> dict:
    """One microbatch's gradients over ``mesh`` on the config's own
    dispatch against the gspmd branch's on the same weights: bit for bit,
    else within ``GRAD_BOUND``; the local expert axis rolled by one must
    miss it by 10x."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLMDataset, make_global_batch

    model.requires_grad_(True)
    ds = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=traffic["seq_len"],
        global_batch=traffic["global_batch"] // traffic["n_micro"],
        seed=traffic["seed"]))
    batch = make_global_batch(ds.batch_at(0), dev)
    t0 = time.perf_counter()
    lf, gf = _ep_grads(model, batch)
    le, ge = _ep_grads(model, batch, mesh)
    bitwise = le == lf and all(torch.equal(ge[n], g) for n, g in gf.items())
    held = _grad_errors(le, ge, lf, gf)
    del ge
    with _experts_rolled(cfg):
        roll = _grad_errors(*_ep_grads(model, batch, mesh), lf, gf)
    del gf
    torch.cuda.empty_cache()
    res = {"dispatch": cfg.moe.dispatch, "bit_for_bit": bitwise,
           "held": held, "experts_rolled": roll, "bound": GRAD_BOUND,
           "misses": {"held": _miss(held), EP_CONTROL: _miss(roll)},
           "seconds": time.perf_counter() - t0}
    log(f"family train ep check: {cfg.name} {cfg.n_layers} layers, "
        f"{batch['tokens'].shape[0]} x {traffic['seq_len']}, "
        f"{cfg.moe.dispatch} over {mesh.shape} against gspmd: "
        f"{json.dumps(res)}")
    assert bitwise or _miss(held) <= 1.0, held
    assert _miss(roll) >= 10.0, (EP_CONTROL, roll)
    return res


def family_train_phase(dev, profile_dir: Path | None, arch: str,
                       mesh=None) -> dict:
    """Phase 7d, one family: (a) the gradient check (``FAMILY_CHECK``,
    within ``FAMILY_BOUNDS``); DeepSeek-V2 also one microbatch's gradients
    over ``mesh`` on its ``teshu2`` dispatch against gspmd's; (b) the
    steps of ``FAMILY_TRAIN`` at full width, the kernel counters zeroed
    just before and read just after (all 0), then ``_trained``'s checks and
    one more microbatch's gradients; (c) the log line: step seconds
    (median of steps 2 on), tokens/s, peak memory and the share of the
    bf16 dense peak by ``_family_flops``; with ``--profile`` one step's
    gradients and its update traced apart."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset, make_global_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.steps import Recipe, _with_recipe, recipe_for
    from repro_torch.launch.train import train
    from repro_torch.models import lm
    from repro_torch.models.config import SHAPES
    from repro_torch.optim import AdamWConfig

    t = FAMILY_TRAIN[arch]
    torch.cuda.reset_peak_memory_stats()
    check = FAMILY_CHECK[arch]
    bf16 = check["dtypes"][0] == "bfloat16"
    res: dict = {"grad_check": _grad_check(
        dev, arch, check, FAMILY_BOUNDS[arch] if bf16 else GRAD_BOUND,
        lambda: _family_mixer(arch), seed=t["seed"],
        host=arch == DEEPSEEK_ARCH, dtypes=check["dtypes"],
        spread_bound=None if bf16 else FAMILY_BOUNDS[arch])}
    res["grad_check_peak_bytes"] = torch.cuda.max_memory_allocated()
    if arch == DEEPSEEK_ARCH:             # its own recipe, our n_micro
        recipe = dataclasses.replace(
            recipe_for(arch, SHAPES["train_4k"]), n_micro=t["n_micro"],
            lr=t["lr"])
        assert (recipe.moment_dtype, recipe.accum_dtype) == ("bfloat16",
                                                             "bfloat16")
    else:                                 # train()'s
        recipe = Recipe(n_micro=t["n_micro"], lr=t["lr"])
    cfg = _with_recipe(dataclasses.replace(get_config(arch),
                                           n_layers=t["layers"]), recipe)
    assert cfg.remat, cfg
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=t["seed"], device=dev, mesh=mesh)
    n_params = sum(p.numel() for p in model.parameters())
    snap = {n: p.detach().to("cpu", copy=True)
            for n, p in model.named_parameters()}
    log(f"family train weights: {arch} {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers, {n_params} parameters, made "
        f"on the card and copied to the host in "
        f"{time.perf_counter() - t0:.2f} s")
    if mesh is not None:
        res["ep_check"] = _ep_check(model, cfg, dev, mesh, t)
    ocfg = AdamWConfig(lr=t["lr"], total_steps=max(t["steps"], 2),
                       warmup_steps=max(1, t["steps"] // 10),
                       moment_dtype=recipe.moment_dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:                     # the training path, alone
        k.launches = 0
    t0 = time.perf_counter()
    if arch == DEEPSEEK_ARCH:
        hist, opt_state = _recipe_steps(model, cfg, recipe, ocfg, t, dev)
    else:
        out = train(arch, smoke=False, device=dev, params=model,
                    log_every=1, n_micro=t["n_micro"], steps=t["steps"],
                    global_batch=t["global_batch"], seq_len=t["seq_len"],
                    lr=t["lr"], seed=t["seed"])
        hist, opt_state = out["history"], out["opt_state"]
        del out
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in KERNELS}
    log(f"family train {arch} launches: {json.dumps(launches)}")
    assert not any(launches.values()), launches
    assert len(hist) == t["steps"]
    for h in hist:
        log(f"family train {arch} step: loss={h['loss']!r} "
            f"grad_norm={h['grad_norm']!r} lr={h['lr']!r} "
            f"seconds={h['seconds']!r}")
    still = _trained(model, snap, opt_state, hist)
    del snap
    log(f"family train {arch} moved: {n_params} parameters in "
        f"{len(dict(model.named_parameters())) - len(still)} of "
        f"{len(dict(model.named_parameters()))} tensors; unmoved (each step "
        f"under half a bf16 step, moments nonzero): {still}")
    _next_grads(model, cfg, t, t["n_micro"], dev)
    step_s = statistics.median(h["seconds"] for h in hist[1:])
    tokens = t["global_batch"] * t["seq_len"]
    flops = _family_flops(model, cfg, t["global_batch"], t["seq_len"])
    res.update(
        arch=arch, layers=cfg.n_layers, parameters=n_params,
        traffic=t, moment_dtype=recipe.moment_dtype,
        accum_dtype=recipe.accum_dtype,
        steps=[{k: h[k] for k in ("loss", "grad_norm", "lr", "seconds")}
               for h in hist],
        step_s=step_s, tokens_per_s=tokens / step_s, peak_bytes=peak,
        **flops, bf16_peak_share=flops["model_flops"] / step_s / BF16_PEAK,
        wall_s=wall, launches=launches, unmoved=still,
        card=nvidia_smi_line())
    log(f"family train phase: {json.dumps({k: v for k, v in res.items() if k not in ('grad_check', 'ep_check', 'steps')})}")
    if profile_dir is not None:
        full = make_global_batch(SyntheticLMDataset(DataConfig(
            vocab=cfg.vocab, seq_len=t["seq_len"],
            global_batch=t["global_batch"], seed=t["seed"])).batch_at(
                t["steps"] + 1), dev)
        res["profile"] = _profile_train(
            model, opt_state, full, ocfg, recipe, profile_dir,
            tag=f"{arch}_", ops=arch != XLSTM_ARCH)
    del model, opt_state
    torch.cuda.empty_cache()
    return res


def _profile_ep_step(model, cfg, dev, mesh, profile_dir: Path) -> dict:
    """One ``train(mesh=...)`` step's gradients (both microbatches, the
    gradient sums) traced: device ms by kernel class, the NCCL kernels a
    class of their own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig, SyntheticLMDataset, make_global_batch
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim import microbatch_grads

    batch = make_global_batch(SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=EP_TRAIN["seq_len"],
        global_batch=EP_TRAIN["global_batch"], seed=EP_TRAIN["seed"])
    ).batch_at(EP_TRAIN["steps"]), dev, mesh=mesh, n_micro=EP_TRAIN_MICRO)
    params = dict(model.named_parameters())
    split = steps.split_leaves(model.specs, mesh)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        t0 = time.perf_counter()
        _, grads = microbatch_grads(
            lambda p, b: lm.train_loss(model, b, mesh=mesh), params, batch,
            EP_TRAIN_MICRO)
        steps.sum_grads(grads, mesh, split)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.05)
    del grads
    busy: dict[str, float] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name in (
                "Activity Buffer Request", "Command Buffer Full"):
            continue
        c = _kernel_class(e.name)
        busy[c] = busy.get(c, 0.0) + e.device_time_total / 1e3
    profile_dir.mkdir(parents=True, exist_ok=True)
    (profile_dir / "profile_ep_train.txt").write_text(
        prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    out = {"wall_ms": wall * 1e3, "device_ms_by_class": busy,
           "nccl_device_ms": busy.get("nccl", 0.0),
           "idle_share": 1 - sum(busy.values()) / (wall * 1e3)}
    log(f"profile ep train grads: {json.dumps(out)}")
    return out


def _kernel_class(name: str) -> str:
    if "flash_fwd" in name or "flash_mma" in name or "flash_wgmma" in name:
        return "flash_attention"
    if "decode_tma" in name or "decode_split" in name \
            or "decode_combine" in name:
        return "decode_attention"
    if "gmm_wgmma" in name or "gmm_f32" in name:
        return "gmm"
    if "slstm_scan" in name:
        return "slstm_scan"
    if "nccl" in name.lower():
        return "nccl"
    if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass", "gemv",
                               "splitKreduce")):
        return "matmul"
    return "other"


# the models' profiler ranges (record_function): Hymba's Mamba heads,
# xLSTM's mLSTM and sLSTM mixers, MLA's two forms
RANGES = ("hymba.", "xlstm.", "mla.")


def _profile_serve(params, cfg, dev, profile_dir: Path, tag: str = "",
                   shape: dict = SERVE, mesh=None) -> None:
    """The prefill and four decode steps under torch.profiler: device time
    by kernel class (attention kernels, gmm, the sLSTM kernel, matmuls, the
    rest) against wall, and the models' ``RANGES`` (Hymba's
    ``hymba.mamba``, xLSTM's ``xlstm.mlstm`` and ``xlstm.slstm``, MLA's
    ``mla.prefill`` and ``mla.decode``: host ms, and the device ms the
    ranges span); ``tag`` prefixes the names of the files and lines,
    ``shape`` gives batch and lengths; under ``mesh`` the model dispatches
    over it (the NCCL kernels are the ``nccl`` class)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm
    b, s = shape["batch"], shape["prompt_len"]
    prompts = np.random.default_rng(shape["seed"]).integers(0, cfg.vocab, (b, s))
    tokens = torch.from_numpy(prompts.astype(np.int32)).to(dev)
    cache = lm.init_cache(cfg, b, shape["max_len"], device=dev)
    profile_dir.mkdir(parents=True, exist_ok=True)

    def traced(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        (profile_dir / f"profile_serve_{tag}{name}.txt").write_text(
            prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))
        busy: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and e.name not in (
                    "Activity Buffer Request", "Command Buffer Full") \
                    and not e.name.startswith(RANGES):   # a range, no kernel
                c = _kernel_class(e.name)
                busy[c] = busy.get(c, 0.0) + e.device_time_total / 1e3
        # each range appears twice: on the host (its CPU time) and as a
        # device annotation (the span of its device work, gaps included)
        ranges: dict[str, float] = {}
        for e in prof.key_averages():
            if e.key.startswith(RANGES):
                k = "cpu" if e.device_type == DeviceType.CPU else "device"
                ranges[f"{e.key}_{k}_ms"] = getattr(e, f"{k}_time_total") / 1e3
        log(f"profile serve {tag}{name}: wall_ms={wall * 1e3!r} device_ms_by_class="
            f"{json.dumps(busy)} idle_share="
            f"{1 - sum(busy.values()) / (wall * 1e3)!r}"
            + (f" ranges={json.dumps(ranges)}" if ranges else ""))
        return out

    logits, _, _ = traced("prefill", lambda: lm.forward(
        params, tokens=tokens, cache=cache, mesh=mesh))
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    del logits

    def steps():
        t = tok
        for _ in range(4):
            out, _ = lm.serve_step(params, cache, tokens=t, mesh=mesh)
            t = out[:, -1].argmax(-1).to(torch.int32)[:, None]
        return t
    traced("decode_4_steps", steps)


def _profile_hit(client, template, bufs, ws, profile_dir: Path, tag: str = "",
                 **kw) -> None:
    """One more hit under torch.profiler (see :func:`_profiled`)."""
    import repro_torch.core as port
    b = copy_bufs(bufs)
    _profiled(f"{tag}{template}", lambda: client.shuffle(
        template, b, ws, ws, comb_fn=port.SUM, **kw), profile_dir)


def _profiled(name: str, fn, profile_dir: Path):
    """``fn()`` once under torch.profiler: device time by kernel and host
    time by replay phase (the ``teshu.*`` ranges of torchplan); returns what
    ``fn`` returns.  The session stays open 50 ms before and after the
    call (a session may otherwise lose device events at its edges)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.05)
    profile_dir.mkdir(parents=True, exist_ok=True)
    ka = prof.key_averages()
    (profile_dir / f"profile_{name}.txt").write_text(
        ka.table(sort_by="cuda_time_total", row_limit=40))
    # each teshu.* range appears twice: once on the host (CPU time) and
    # once as a device annotation spanning the range's device work
    phases: dict[str, float] = {}
    for e in ka:
        if e.key.startswith("teshu."):
            phases[e.key] = max(phases.get(e.key, 0.0), e.cpu_time_total / 1e3)
    busy = sum(getattr(e, "device_time_total", 0.0) for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.name.startswith("teshu.")
               and e.name != "Activity Buffer Request") / 1e3
    # the shuffle kernels' device time (their memsets not counted)
    kernels = {"partition_permute": ("build_inverse", "gather_rows"),
               "segment_combine": ("segment_sum",),
               "segmented_fold": ("segmented_fold",)}
    shuffle_ms = {k: sum(getattr(e, "device_time_total", 0.0)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and any(x in e.name for x in names)) / 1e3
                  for k, names in kernels.items()}
    log(f"profile {name}: wall_ms={wall * 1e3!r} device_busy_ms={busy!r} "
        f"phases_host_ms={json.dumps(phases)} "
        f"shuffle_kernels_device_ms={json.dumps(shuffle_ms)}")
    return result


# ---------------------------------------------------------------------------
# the dry run (item 8): the matrix of cells counted on meta stand-ins,
# and five steps the script runs counted on the card against the same
# steps counted on meta
# ---------------------------------------------------------------------------

DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_OUT = ROOT / "build" / "chip_smoke_dryrun.jsonl"
# the matrix on (16, 16): the archs this script serves or trains, at the
# serving shapes, and the dense arch's train_4k cell; each job one process
# of its own: name -> (archs, shapes, cells at once).  The whole matrix
# takes far longer than the script's limit on a host's CPU: counting runs
# every eager op on meta, and a train_4k cell of the MoE, MLA, Hymba and
# xLSTM archs (their loops over chunks, steps and 8-16 microbatches) or
# DeepSeek-V2's prefill_32k (60 layers of the plain blocked attention at
# 32k) counts for many minutes on a host's CPU
DRYRUN_ARCHS = (SERVE_ARCH, MOE_ARCH, HYMBA_ARCH, XLSTM_ARCH, DEEPSEEK_ARCH)
DRYRUN_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
DRYRUN_JOBS = {
    "serving": (DRYRUN_ARCHS[:4], DRYRUN_SHAPES, 2),
    "deepseek": ((DEEPSEEK_ARCH,), ("decode_32k", "long_500k"), 1),
    "train": ((TRAIN_ARCH,), ("train_4k",), 1),
}
DRYRUN_TIMEOUT_S = 900       # from their start, right after the build
COMPUTE_FLOOR = 0.95      # measured time >= this x the roofline's compute term
# the five steps counted on the card and on meta (a one-rank mesh on a fake
# world): tag -> (arch, kind, sequence, batch, layers (None: all), cache
# positions before the step (decode))
DRYRUN_CELLS = {
    "qwen2.5-14b prefill": (SERVE_ARCH, "prefill", SERVE["prompt_len"],
                            SERVE["batch"], None, None),
    "qwen2.5-14b decode": (SERVE_ARCH, "decode", SERVE["max_len"],
                           SERVE["batch"], None, SERVE["prompt_len"]),
    "qwen3-moe 12L prefill": (MOE_ARCH, "prefill", SERVE["prompt_len"],
                              SERVE["batch"], MOE_LAYERS, None),
    "deepseek-v2 9L prefill": (DEEPSEEK_ARCH, "prefill", SERVE["prompt_len"],
                               SERVE["batch"], DEEPSEEK_LAYERS, None),
    "qwen2.5-14b 8L train": (TRAIN_ARCH, "train", TRAIN["seq_len"],
                             TRAIN["global_batch"], TRAIN_LAYERS, None),
}
# ops that run on one side only, each with its reason (PERF.md)
ONE_SIDE_OPS: dict[str, str] = {}
CARD_COUNTS: dict = {}


def _dryrun_recipe(kind: str):
    from repro_torch.launch.steps import Recipe, recipe_for
    from repro_torch.models.config import SHAPES
    if kind != "train":
        return Recipe()
    import dataclasses
    return dataclasses.replace(recipe_for(TRAIN_ARCH, SHAPES["train_4k"]),
                               lr=TRAIN["lr"])


def _op_table(counts) -> dict:
    """``{"name|shapes|flash": [calls, flops, bytes]}`` of a counter."""
    return {f"{n}|{s}|{int(f)}": [op.calls, op.flops, op.nbytes]
            for (n, s, f), op in counts.ops.items()}


def meta_counts(path: Path) -> int:
    """``--meta-counts PATH``: each of ``DRYRUN_CELLS`` built on a one-rank
    meta mesh (``elastic_mesh(1, model_parallel=1)`` on a fake world of
    one), its step counted once, the counts written to ``PATH``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.config import ShapeConfig
    out = {}
    with dryrun.fake_world(1):
        mesh = _mesh_groups(elastic_mesh(1, model_parallel=1,
                                         device_type="meta"))
        for tag, (arch, kind, seq, batch, layers, cached) in \
                DRYRUN_CELLS.items():
            t0 = time.perf_counter()
            cell = build_cell(arch, ShapeConfig(tag, seq, batch, kind), mesh,
                              n_layers=layers, recipe=_dryrun_recipe(kind))
            c = dryrun.count_cell(cell, dryrun.local_args(cell,
                                                          cache_len=cached))
            out[tag] = dict(ops=_op_table(c), flops=c.flops,
                            bytes=c.hbm_bytes, ici_bytes=c.ici_bytes,
                            dcn_bytes=c.dcn_bytes, memory=c.memory,
                            kernels=c.kernel_calls,
                            seconds=time.perf_counter() - t0)
            print(f"meta counts {tag}: flops={c.flops!r} bytes="
                  f"{c.hbm_bytes!r} {out[tag]['seconds']:.1f} s", flush=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))
    return 0


def dryrun_start() -> list:
    """The dry run's processes, started together right after the build at
    the lowest priority (five processes of one or two cores beside the
    script's own, on a host of 8) and with no card in sight: the jobs of
    ``DRYRUN_JOBS`` and the meta counts of ``DRYRUN_CELLS``; each writes a
    log under ``DRYRUN_DIR``."""
    import os
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    jobs = [("meta_counts", [sys.executable, str(Path(__file__).resolve()),
                             "--meta-counts",
                             str(DRYRUN_DIR / "meta_counts.json")])]
    for name, (archs, shapes, at_once) in DRYRUN_JOBS.items():
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--jobs",
               str(at_once), "--out", str(DRYRUN_DIR / f"{name}.jsonl")]
        for arch in archs:
            cmd += ["--arch", arch]
        for shape in shapes:
            cmd += ["--shape", shape]
        jobs.append((name, cmd))
    procs = []
    for name, cmd in jobs:
        log_f = open(DRYRUN_DIR / f"{name}.log", "w")
        procs.append((name, subprocess.Popen(
            cmd, env=env, cwd=ROOT, stdout=log_f, stderr=subprocess.STDOUT,
            start_new_session=True, preexec_fn=lambda: os.nice(19)), log_f,
            time.perf_counter()))
    return procs


def _kill_group(proc) -> None:
    """``proc`` and every process it started (its session's group)."""
    import os
    import signal
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def dryrun_stop(procs) -> None:
    for _, proc, log_f, _ in procs:
        _kill_group(proc)                 # its pool's workers too
        log_f.close()


def _mesh_groups(mesh):
    """``mesh`` with the group of every set of its axes made, before any
    step is counted: on the card a group's first use otherwise sets NCCL
    up inside the counted call, with the card full of the step's
    tensors."""
    import itertools
    names = mesh.axis_names
    for r in range(1, len(names) + 1):
        for axes in itertools.combinations(names, r):
            mesh.group(axes)
    return mesh


def _card_count(tag: str, fn, args, reset=None, reps: int = 3) -> None:
    """One call of ``fn()`` counted on the card (``OpCounter``, ``args`` its
    arguments) with its peak allocated memory, then ``reps`` calls timed
    without the counter (the median; ``reset()`` before each call)."""
    import torch

    from repro_torch.launch.op_analysis import OpCounter
    if reset is not None:
        reset()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with OpCounter(args=args) as counts:
        out = fn()
        counts.output_bytes = counts.live_bytes
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    times = []
    for _ in range(reps):
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del res
    CARD_COUNTS[tag] = dict(counts=counts, peak_bytes=peak,
                            allocated_before=base,
                            seconds=statistics.median(times), times=times)
    log(f"dryrun card count {tag}: flops={counts.flops!r} bytes="
        f"{counts.hbm_bytes!r} kernels={counts.kernel_calls} seconds="
        f"{CARD_COUNTS[tag]['seconds']!r} peak_gb={peak / 1e9:.3f}")


def _dense_serve_counts(params, cfg, dev) -> None:
    """The dense serving steps counted: ``make_prefill_step`` on 4 x 1,024
    tokens and one ``make_serve_step`` after a prefill of 1,024 into a
    cache of 2,048 (the ``DRYRUN_CELLS`` shapes)."""
    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    gen = torch.Generator(device=dev).manual_seed(SERVE["seed"] + 7)
    b, s = SERVE["batch"], SERVE["prompt_len"]
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.zeros_like(toks)}
    tag = "qwen2.5-14b prefill"
    step = make_prefill_step(cfg, ShapeConfig(tag, s, b, "prefill"))
    _card_count(tag, lambda: step(params, batch), (params, batch))
    cache = lm.init_cache(cfg, b, SERVE["max_len"], device=dev)
    with torch.no_grad():
        lm.forward(params, tokens=toks, cache=cache)

    def reset():
        cache["pos"] = s
        for layer in cache["layers"]:
            layer["len"] = s
    one = {"tokens": toks[:, -1:].contiguous()}
    serve_step = make_serve_step(cfg)
    _card_count("qwen2.5-14b decode", lambda: serve_step(params, cache, one),
                (params, cache, one), reset=reset)
    del cache


def _moe_prefill_count(params, cfg, dev, mesh, arch: str) -> None:
    """The Qwen3-MoE or DeepSeek-V2 prefill over the one-rank mesh (its
    ``teshu2`` dispatch; DeepSeek-V2's MLA whole, as ``model`` is 1)
    counted, on its ``DRYRUN_CELLS`` shape."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.config import ShapeConfig
    gen = torch.Generator(device=dev).manual_seed(SERVE["seed"] + 8)
    b, s = SERVE["batch"], SERVE["prompt_len"]
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev,
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.zeros_like(toks)}
    tag = next(t for t, c in DRYRUN_CELLS.items()
               if c[:2] == (arch, "prefill"))
    step = make_prefill_step(cfg, ShapeConfig(tag, s, b, "prefill"),
                             mesh=mesh)
    _card_count(tag, lambda: step(params, batch), (params, batch))


def _train_count(model, opt_state, cfg, recipe, dev) -> None:
    """One training step of the 8-layer cell counted over a one-rank NCCL
    mesh (a world of its own, destroyed after): ``make_train_step`` under
    the mesh, the model placed on it (every leaf whole, in place), on the
    pipeline's batch of ``TRAIN``'s shape."""
    import torch.distributed as dist

    from repro_torch.data import (DataConfig, SyntheticLMDataset,
                                  make_global_batch)
    from repro_torch.launch.mesh import elastic_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    import torch
    MESH_STORE.mkdir(parents=True, exist_ok=True)
    store = MESH_STORE / "store_train"
    store.unlink(missing_ok=True)
    torch.cuda.empty_cache()        # NCCL allocates beside torch's cache
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = _mesh_groups(elastic_mesh(1, model_parallel=1))
        lm.place(model, mesh)
        batch = make_global_batch(SyntheticLMDataset(DataConfig(
            vocab=cfg.vocab, seq_len=TRAIN["seq_len"],
            global_batch=TRAIN["global_batch"], seed=TRAIN["seed"])).batch_at(
                TRAIN["steps"] + 2), dev, mesh=mesh, n_micro=recipe.n_micro)
        ocfg = AdamWConfig(lr=recipe.lr, moment_dtype=recipe.moment_dtype,
                           factored_v=recipe.factored_v)
        step = make_train_step(cfg, ocfg, recipe, mesh=mesh)
        _card_count("qwen2.5-14b 8L train",
                    lambda: step(model, opt_state, batch),
                    (model, opt_state, batch))
    finally:
        dist.destroy_process_group()


def dryrun_phase(procs) -> dict:
    """Waits for the dry run's processes; logs the matrix's ``report``
    table (every cell must be ok or a ``shape_applicable`` skip); holds each
    of ``DRYRUN_CELLS``' card counts to its meta counts (FLOPs and bytes
    equal op for op, but for ``ONE_SIDE_OPS``; the measured time at least
    ``COMPUTE_FLOOR`` x the roofline's compute term) and returns the
    ``dryrun`` line's object."""
    from repro_torch.launch import report, roofline
    waited = {}
    for name, proc, log_f, t0 in procs:
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
        try:
            proc.wait(timeout=max(1.0, left))
        except subprocess.TimeoutExpired:
            _kill_group(proc)
        log_f.flush()
        waited[name] = dict(rc=proc.returncode,
                            seconds=time.perf_counter() - t0)
    tails = {n: (DRYRUN_DIR / f"{n}.log").read_text()[-1500:]
             for n, w in waited.items() if w["rc"] != 0}
    assert not tails, f"dry run processes failed: {waited} {tails}"
    rows = []
    for name in DRYRUN_JOBS:
        rows += [json.loads(line) for line in
                 (DRYRUN_DIR / f"{name}.jsonl").read_text().splitlines()]
    DRYRUN_OUT.write_text("".join(json.dumps(r) + "\n" for r in rows))
    log("dryrun matrix (report.render, per rank, NVIDIA H100 constants):\n"
        + report.render(rows))
    bad = [r for r in rows if r["status"] not in ("ok", "skip")]
    assert not bad, f"dry run cells failed: {bad}"
    meta = json.loads((DRYRUN_DIR / "meta_counts.json").read_text())
    cells = {}
    for tag in DRYRUN_CELLS:
        card, want = CARD_COUNTS[tag], meta[tag]
        got, ops = _op_table(card["counts"]), want["ops"]
        one_side = sorted({k.split("|")[0] for k in set(got) ^ set(ops)})
        unnamed = [n for n in one_side if n not in ONE_SIDE_OPS]
        diff = {k: (got[k], ops[k]) for k in set(got) & set(ops)
                if got[k] != ops[k]}

        def total(table, i):
            return sum(v[i] for k, v in table.items()
                       if k.split("|")[0] not in ONE_SIDE_OPS)
        flops = (total(got, 1), total(ops, 1))
        nbytes = (total(got, 2), total(ops, 2))
        compute_s = want["flops"] / roofline.PEAK_FLOPS
        memory_s = want["bytes"] / roofline.HBM_BW
        collective_s = want["ici_bytes"] / roofline.ICI_BW \
            + want["dcn_bytes"] / roofline.DCN_BW
        measured = card["seconds"]
        cells[tag] = dict(
            card_flops=card["counts"].flops, meta_flops=want["flops"],
            card_bytes=card["counts"].hbm_bytes, meta_bytes=want["bytes"],
            compute_s=compute_s, memory_s=memory_s,
            collective_s=collective_s, measured_s=measured,
            measured_over_compute=measured / compute_s,
            memory_over_measured=memory_s / measured,
            meta_peak_gb=want["memory"]["total_gb"],
            card_peak_gb=card["peak_bytes"] / 1e9,
            card_allocated_before_gb=card["allocated_before"] / 1e9,
            kernels=want["kernels"], card_kernels=card["counts"].kernel_calls,
            one_side_ops=one_side, meta_seconds=want["seconds"])
        log(f"dryrun cell {tag}: {json.dumps(cells[tag])}")
        assert not unnamed, f"{tag}: ops on one side only: {unnamed}"
        assert not diff, f"{tag}: ops counted apart: {list(diff.items())[:8]}"
        assert flops[0] == flops[1] and nbytes[0] == nbytes[1], \
            (tag, flops, nbytes)
        assert want["kernels"] == card["counts"].kernel_calls, tag
        assert measured >= COMPUTE_FLOOR * compute_s, \
            f"{tag}: {measured} s under {COMPUTE_FLOOR} x {compute_s} s"
    # each (16, 16) cell's count a rank, and the model's FLOPs over it
    # (6 N D or 2 N D over the ranks' sum: 1 where each rank did its share)
    per_rank = {f"{r['arch']}|{r['shape']}": dict(
        flops_per_rank=r["compute_s"] * roofline.PEAK_FLOPS,
        model_over_counted=r["model_flops_ratio"])
        for r in rows if r["status"] == "ok"}
    log(f"dryrun per rank: {json.dumps(per_rank)}")
    import re
    seconds = {n: float(m.group(1)) for n in DRYRUN_JOBS for m in re.finditer(
        r"\(([\d.]+) s\) ===", (DRYRUN_DIR / f"{n}.log").read_text())}
    seconds["meta_counts"] = sum(c["seconds"] for c in meta.values())
    ok = sum(r["status"] == "ok" for r in rows)
    return dict(card=nvidia_smi_line(), mesh="16x16",
                jobs={n: [list(a), list(sh)] for n, (a, sh, _) in
                      DRYRUN_JOBS.items()},
                matrix=dict(ok=ok, skip=len(rows) - ok, failed=0,
                            seconds=seconds,
                            waited_from_start_s={n: w["seconds"]
                                                 for n, w in waited.items()},
                            out=str(DRYRUN_OUT.relative_to(ROOT))),
                per_rank=per_rank, cells=cells)


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=Path, default=None,
                    help="trace one hit per template into this directory")
    ap.add_argument("--meta-counts", type=Path, default=None,
                    help="count the dry run's five steps on meta stand-ins "
                         "into this file and exit (the script runs itself "
                         "so, with no card)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}: "
              f"run it from a checkout of the repo", file=sys.stderr)
        return 2
    if args.meta_counts is not None:
        return meta_counts(args.meta_counts)
    if not __debug__:
        sys.exit("chip_smoke.py checks its results with assert: run it "
                 "without -O")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import KERNELS, _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(nvidia_smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{len(_build.SOURCES)} sources (nvcc {_build.BUILD_INFO['seconds']})")
    for name, report in _build.BUILD_INFO["ptxas"].items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    procs = dryrun_start()                # item 8 counts beside the rest
    import atexit
    atexit.register(dryrun_stop, procs)   # stopped however the script ends
    t0 = time.perf_counter()
    paths = trace_phase(dev)
    log(f"trace phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    krows = kernel_phase(dev)
    krows.update(attention_phase(dev, paths))
    krows.update(split_phase(dev, paths))
    krows.update(gmm_phase(dev))
    krows.update(slstm_phase(dev))
    log(f"kernel phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sl = slice_phase(dev, args.profile)
    log(f"slice phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sk = skew_phase(dev, args.profile)
    log(f"skew phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    bt = batch_phase(dev, args.profile)
    log(f"batch phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    gr = graph_phase(dev, args.profile)
    log(f"graph phase: {time.perf_counter() - t0:.2f} s")
    torch.cuda.empty_cache()              # the served models want the card
    t0 = time.perf_counter()
    sv = dense_serve_phase(dev, args.profile)
    log(f"serve phase: {time.perf_counter() - t0:.2f} s")
    dense = {}                            # the other dense models, Granite
    for arch, layers in DENSE_SERVE.items():        # first
        t0 = time.perf_counter()
        dense[arch] = dense_serve_phase(dev, args.profile, arch, layers)
        log(f"dense serve phase {arch}: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    hv = hymba_serve_phase(dev, args.profile)
    log(f"hymba serve phase: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    xv = xlstm_serve_phase(dev, args.profile)
    log(f"xlstm serve phase: {time.perf_counter() - t0:.2f} s")
    import torch.distributed as dist
    t0 = time.perf_counter()
    mesh, _ = mesh_open(dev)
    log(f"mesh open: {time.perf_counter() - t0:.2f} s")
    try:
        t0 = time.perf_counter()
        tv = tp_serve_phase(dev, mesh)
        log(f"tp phase: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        mv = moe_serve_phase(dev, args.profile, MOE_ARCH, MOE_LAYERS, "moe_",
                             mesh)
        log(f"moe serve phase: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        dv = moe_serve_phase(dev, args.profile, DEEPSEEK_ARCH,
                             DEEPSEEK_LAYERS, "deepseek_", mesh)
        log(f"deepseek serve phase: {time.perf_counter() - t0:.2f} s")
        torch.cuda.empty_cache()          # the training state wants the card
        t0 = time.perf_counter()
        et = ep_train_phase(dev, args.profile, mesh)
        log(f"ep train phase: {time.perf_counter() - t0:.2f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        family_train_phase(dev, args.profile, DEEPSEEK_ARCH, mesh)
        log(f"family train phase {DEEPSEEK_ARCH}: "
            f"{time.perf_counter() - t0:.2f} s")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()              # the training state wants the card
    t0 = time.perf_counter()
    train_phase(dev, args.profile)
    log(f"train phase: {time.perf_counter() - t0:.2f} s")
    for arch in (HYMBA_ARCH, XLSTM_ARCH):
        t0 = time.perf_counter()
        family_train_phase(dev, args.profile, arch)
        log(f"family train phase {arch}: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    try:
        dry = dryrun_phase(procs)
    finally:
        dryrun_stop(procs)
    log(f"dryrun phase: {time.perf_counter() - t0:.2f} s (waited)")
    # each path's launches, counted from zero just before it ran
    launches = {k: sum(p["launches"][k] for p in (sl, sk, bt, gr))
                for k in sl["launches"]}
    # the dense models' launches by model, from tokens and from embeddings
    dense_launches = {k: {a: d["launches"][k] + d.get("embeds", {}).get(
        "launches", {}).get(k, 0) for a, d in dense.items()}
        for k in ("flash_attention", "decode_attention")}
    launches.update(
        flash_attention=sum(p["launches"]["flash_attention"] for p in (sv, hv))
        + sum(dense_launches["flash_attention"].values()),
        decode_attention=sum(p["launches"]["decode_attention"]
                             for p in (sv, hv))
        + sum(dense_launches["decode_attention"].values()),
        gmm=sum(p["launches"]["gmm"] + p["ep"]["launches"]["gmm"]
                for p in (mv, dv)),
        slstm_scan=xv["launches"]["slstm_scan"])
    # the gmm row of the line: Qwen3-MoE's decode gate/up launch, the shape
    # of 2,304 of the four MoE serves' 5,544 launches (gspmd and EP; every
    # timed shape is logged; DeepSeek-V2's decode gate/up rides along)
    krows["gmm"] = krows["decode gate/up"]

    sources = {"partition_permute": ("partition.cu",
                                     "src/repro/kernels/partition.py:102"),
               "segment_combine": ("combine.cu",
                                   "src/repro/kernels/combine.py:93"),
               "segmented_fold": ("fold.cu", "src/repro/core/jaxplan.py:326"),
               "flash_attention": ("flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:80"),
               "decode_attention": ("decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:67"),
               "gmm": ("gmm.cu", "src/repro/kernels/gmm.py:49"),
               "slstm_scan": ("slstm.cu", "src/repro/models/ssm.py:239")}
    line = []
    for k in KERNELS:
        r = krows[k.__name__]
        src, replaces = sources[k.__name__]
        line.append({
            "name": k.__name__, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[k.__name__],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if "path" in r:       # the kernel of the row's shape (flash, decode)
            line[-1]["path"] = r["path"]
        tp = {a: t["launches"][k.__name__] for a, t in tv.items()
              if t["launches"].get(k.__name__)}
        if tp:                # the tp lines' launches, by model
            line[-1]["tp_launches"] = tp
        if k.__name__ == "gmm":   # DeepSeek-V2's launches and decode shape
            d = krows["DeepSeek decode routed gate/up"]
            line[-1]["ep_launches"] = {"qwen3_moe": mv["ep"]["launches"]["gmm"],
                                       "deepseek": dv["ep"]["launches"]["gmm"]}
            line[-1]["deepseek"] = {
                "launches": dv["launches"]["gmm"] + dv["ep"]["launches"]["gmm"],
                **{x: d[x] for x in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}}
        for entry, keys in (("positions_split", ("lse", "lse_hymba",
                                                 "zigzag")),
                            ("replicate_split", ("lse_moe", "lse_mqa"))):
            split = {x: krows[f"{k.__name__}_{x}"] for x in keys
                     if f"{k.__name__}_{x}" in krows}
            if split:         # the pieces of the splits of T
                line[-1][entry] = {x: {
                    y: r[y] for y in ("blocks", "launches", "max_abs_err",
                                      "bound_share", "ms", "whole_ms",
                                      "route_ms", "off_route_ms",
                                      "lse_max_abs_err", "control_share",
                                      "bit_for_bit") if y in r}
                    for x, r in split.items()}
        if k.__name__ in dense_launches:   # the dense models' shapes
            line[-1]["dense_models"] = {a: {
                "launches": n,
                **{x: krows[f"{k.__name__}_{a}"][x] for x in (
                    "path", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}}
                for a, n in dense_launches[k.__name__].items()}
        w = krows.get(f"{k.__name__}_hymba")
        if w is not None:     # flash and decode with Hymba's window
            line[-1]["window"] = {
                "launches": hv["launches"][k.__name__],
                **{x: w[x] for x in ("window", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "library_call",
                                     "unwindowed_ms", "unwindowed_bound_ms")}}
        for key in ("zipf_ms", "zipf_longest_segment", "zipf_byte_bound_ms",
                    "library_call", "index_add_ms", "unsorted_ms",
                    "bytes_bound_ms", "operations_bound_ms", "chain_bound_ms",
                    "exchange_probe_ms", "parent_ms", "parent_units",
                    "grid_barrier_chain_ms",
                    "decode_ms",
                    "decode_plain_ms", "decode_parent_ms", "host_us_per_call"):
            if key in r:      # the fold on the shuffle's own layout; PART's
                line[-1][key] = r[key]   # and COMB's other yardsticks; the
                                         # sLSTM's bounds and decode step
    assert all(e["launches"] > 0 for e in line)
    # the ep phases' state placed by the sharding rules on the one-rank mesh
    gb = 1e9
    placement = {"card": nvidia_smi_line(), "mesh": dict(mesh.shape)}
    for name, ph in (("qwen3_moe_ep_serve", mv), ("deepseek_ep_serve", dv)):
        placement[name] = dict(
            ph["ep"]["placement"],
            peak_gb=ph["ep"]["peak_device_bytes"] / gb,
            gspmd_peak_gb_same_call=ph["peak_device_bytes"] / gb)
    placement["deepseek_ep_serve"]["earlier_gspmd_peak_gb"] = \
        EARLIER_PEAK_GB["deepseek_serve"]
    placement["qwen3_moe_ep_train"] = dict(
        et["placement"], peak_gb=et["ep"]["peak_bytes"] / gb,
        gspmd_peak_gb_same_call=et["gspmd"]["peak_bytes"] / gb,
        earlier_unplaced_peak_gb=EARLIER_PEAK_GB["ep_train"])
    log(f"placement: {json.dumps(placement)}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.2f} s in all")
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
