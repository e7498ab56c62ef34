"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Setup: the card's name and power limit, then every CUDA kernel built
   from ``src/repro_torch/csrc`` with nvcc (one process per source, all
   started together), with the build time.
2. Kernels: on the real packings of ACM PAP and of DBLP APTPA (in-degree
   up to 1,483, most rows empty) at scale 1.0 and D = 64, each NA kernel
   (K1 with unit and with random blocked weights, K2 with random logits)
   against its plain PyTorch version on the card (K2's ``m`` bitwise), two
   kernel runs compared bit for bit, and CUDA-event medians of the kernel,
   the plain version and one library yardstick (``index_add_`` for K1,
   ``scatter_reduce(amax)`` + ``index_add_`` for K2; the port never calls
   them), each beside the shape of the kernels' work list (CTAs, the most
   edges a CTA holds).  K1 also over the packing's source-major view, the
   launch the NA backward makes, against its plain version
   (``index_add_``, also the library call), bit for bit repeatable, and
   K1's host cost a call that needs no gradient and one through the
   autograd Function.
3. Model: the banded inference path — ``Session(ExecutorSpec(na_executor=
   "banded")).compile(make_dataset("ACM", seed=0, scale=1.0), ["APA",
   "PAP", "PSP"], cfg)`` at the full width of ``HGNNConfig`` (hidden 64,
   3 layers, SF attention 64) — serves three forwards each for rgcn, rgat
   and shgn with the launch counters set to 0 just before and read just
   after.  Logits must be finite, repeat bit for bit across forwards, match
   the same port run on the CPU (the plain versions, same seed) within
   1e-4, and K1 must launch 9 times per forward (K2 9 times per rgat or
   shgn forward).  One rgat and one rgcn forward are then profiled with
   ``torch.profiler``, with K1 + K2's device time.
3b. Training: on the same ACM at full width, for rgcn, rgat and shgn
   (labels from ``propagated_feature_labels``, masks from
   ``semi_supervised_masks(seed=0)``): one ``execute_loss`` and its
   gradients on the card against the port's CPU run from the same
   parameters, the loss and every leaf, features included, within 1e-4
   (``test_grad_banded.py``'s tolerance) and every leaf within 1e-4 of the
   largest gradient entry (``GRAD_RTOL``), and every leaf with a nonzero
   gradient on the CPU nonzero on the card; the same with a fault planted
   from here (PAP's source-major view, which the backward's K1 launch
   reads, without its largest work item) must break that gate.  K1 and K2
   launches in one train step, counters set to 0 just before it and read
   just after, must be what the route implies: 9 forward NA calls, one K1
   launch for each differentiated NA call (two for attention: the
   transposed aggregation and the softmax's row sums) and 9 K2 for rgat
   and shgn.  ``fit`` for 20 epochs (lr 3e-3) must be finite and end below
   its first loss; interrupted at epoch 3 with ``ckpt_every=2`` and resumed,
   it must land within rtol 2e-4 / atol 2e-5 of the uninterrupted run
   (whether bitwise is printed).  Printed: ms per train step (CUDA-event
   median) and its forward, backward and optimizer parts, a profiled step,
   and whether two steps or two gradient passes from one state repeat bit
   for bit (the leaves that differ, if any).  Then rgat on full-width
   DBLP, 5 epochs: ms per epoch and finite losses.
3c. HGNN serving: one ``HGNNServeEngine`` (``ServePolicy(batch_window_ms=
   5)``) on the card at full width (hidden 64, 3 layers, SF attention 64,
   seed 0) with three tenants: ACM rgat served head-only
   (``subset_mode="head"``), and IMDB (scale 1.0, AMA / MAM / MDM, target
   M) rgcn and rgat served over k-hop dependency closures
   (``subset_mode="dependency"``; IMDB's closure coverage at three layers
   is printed first, and two layers are taken if a wave's union covers
   more than 0.75).  ``engine.run()`` serves a seeded burst of 64 requests
   a tenant of 4-16 ids each, in 8 waves 10 ms apart, then 2 whole-graph
   requests a tenant.  Gates: every future answered, responses in modes
   ``subset``, ``dependency`` and ``full``, no failures, retries,
   deadline sheds or breaker trips; subset and full rows bitwise equal to
   the card's ``compiled.forward`` rows, dependency rows within 1e-4 of
   them, and every row within 1e-4 of the same requests served on the CPU;
   one dependency forward launches K1 layers x semantic graphs times, and
   K2 as often for rgat (never for rgcn); a second dependency forward is
   bitwise the first, and the same check must fire on a copy of it with
   one entry nudged by one ulp; ``subset_traces`` and ``dependency_traces`` stay flat across
   resubmissions in one bucket; K1 over each semantic graph's sliced
   packing of one request's extraction within K1's tolerance of
   ``seg_sum_plain`` and bitwise repeatable, while a fault planted in the
   same run (the slice's row view without its largest work item) reads
   above that gate; K2 over the rgat tenant's slices against
   ``softmax_stats_plain`` (``m`` bitwise, ``s`` within 1e-5), repeatable,
   with event and queue-full medians.  Printed: p50 / p99 latency, queue and compute
   microseconds per mode, requests/s, the extractor's host ms, and K1's ms
   over the slice against its ms over the full packing, each beside the
   card's name and power limit.
3d. Graph deltas: on the same full-width ACM (seed 0, APA / PAP / PSP),
   three seeded deltas: (a) 64 PS edges inserted (PSP touched; incremental
   SGB), (b) 64 existing PA edges removed (APA and PAP touched; recomposed),
   (c) P grown by 16 vertices with 3 PA edges each (every metapath
   touched).  For each, ``Session.compile_delta`` on a warm banded session
   (rgat, then rgcn; the predecessors' views already uploaded) against
   ``Session(...).compile(graph.apply_delta(delta), ...)`` on a fresh
   session with a cold cache.  Gates: every ``PackedEdges`` array, row
   view, source-major view and work list of every metapath bitwise the
   cold compile's; every untouched packing the predecessor's object;
   successor forwards on the card bitwise the cold compile's, repeatable,
   within 1e-4 of the CPU run, launching K1 9 times a forward and K2 9
   times (rgat) or never (rgcn), as the cold compile does.  A planted
   fault in the same run (delta (a)'s successor with PSP's spliced packing
   handed the predecessor's row view and its upload) must break the
   bitwise gate and read above 1e-4.  K1 and K2 over (a)'s spliced PSP
   packing: against their plain versions within phase 2's gates, bitwise
   equal to the same kernels over the cold packing, event medians and
   queue-full times over both.  Then one ``HGNNServeEngine`` serves ACM
   rgat (head mode) and IMDB rgcn (dependency mode) through a seeded burst
   while ``swap_graph`` installs delta (a) and then an off-metapath TP
   insert on ACM: every future resolves, ACM's versions are monotone in
   service order, ACM rows bitwise the forward of the version that served
   them, IMDB's within 1e-4 of its forward, ``dependency_traces`` flat
   across the off-metapath swap and ACM rgat's dependency rows bitwise
   equal across it (a copy nudged by one ulp must fail that check).  Printed, with the card's name and power
   limit: ``apply_delta``'s stage times beside a cold
   ``FrontendPipeline.run`` of the mutated graph, the splice's reused and
   total blocks, the host ms to rebuild each spliced packing's row view and
   work list and its upload ms, the first and warm successor forwards, the
   extractor's adopted entries, ``swap_graph``'s wall time and the queue of
   the requests in flight by wave.
3e. Sharded execution: ``REPRO_TORCH_VIRTUAL_DEVICES=4``, so 4 ranks on the
   one card.  ``Session(ExecutorSpec(na_executor="banded", shard=mode,
   mesh_shape=(4,)))`` compiles full-width ACM (scale 1.0, APA / PAP / PSP,
   hidden 64, 3 layers) for rgcn, rgat and shgn in modes ``relation`` and
   ``edge_block``, and IMDB rgat in ``edge_block``; each plan's
   ``summary()`` is printed.  Gates per case: logits within 1e-4 of the
   single-device card forward (whether bitwise is printed), within 1e-4 of
   the CPU sharded run, two forwards bitwise equal, K1 launched once per
   non-empty rank and layer (K2 as often for rgat and shgn), the counts set
   to 0 just before the forward and read just after, ``shard_traces == 1``;
   a planted fault in the same run (the lightest non-empty rank dropped from
   the sum) must read above 1e-4.  K1 and K2 over the largest rank's
   merged stream of ACM's edge_block plan go through phase 2's checks, with
   queue-full medians.  An ``HGNNServeEngine`` with ACM rgcn pinned to
   ``device_group=[0, 1]`` and ACM rgat to ``[2, 3]`` serves a burst (id
   subsets and whole-graph requests): every request answered, rows within
   1e-4 of the unsharded card forwards.  Printed: event medians of the
   sharded and single-device forwards, with the card's name and limit.
3f. The segment-sum executor repeats: ``na_executor="jnp"`` on the same
   full-width ACM, rgcn and rgat: two forwards bitwise equal, two ``loss``
   gradients (every parameter and feature leaf) bitwise equal, the logits
   within 1e-4 of the CPU run; printed beside it, whether two forwards
   repeat with ``index_add_`` (float atomics) in place of ``segment_sum``.
4. SGB: ACM, IMDB and DBLP at scale 1.0 under the ``ctt`` planner.  The
   host join and the device composer (K3) must give bitwise-equal products
   and equal per-step costs, K3 must launch once per plan step, and on
   every step K3 must equal its plain version exactly and repeat bit for
   bit.  A fault is planted on every step in the same run: one ``a_occ``
   bit whose pairs carry output is cleared, and K3 must then differ from
   the unaltered plain version (and equal the plain version under the
   fault).  Per step: the pruning counters, K3's k splits, CUDA-event
   medians of K3 and of its Bᵀ pre-pass alone (each also with the card's
   queue full, which leaves out the wrapper's host cost), of the plain
   version and of two library yardsticks (``torch.matmul`` of the padded
   float32 operands, TF32 off, and ``torch._int_mm`` of int8 views, each
   then ``> 0``; the port calls neither), beside the bound.  One device
   run of DBLP's plan is profiled and broken down by span (densify,
   occupancy scans, K3's pre-pass and product, the two host syncs a step,
   the counters, extraction).
5. Device-SGB session: the path ``Session(ExecutorSpec(sgb_backend=
   "device")).compile(DBLP at scale 1.0, ["APA", "APTPA", "APVPA"], cfg)``
   at full width, target type A, three forwards each of rgcn, rgat and
   shgn, counters set to 0 just before the compile and read after the last
   forward.  K3 must launch once per plan step, K1 and K2 9 times per
   forward; logits must be finite, repeat bit for bit and equal a host-SGB
   session's on the same card bit for bit.
6. LM kernels: K4 (flash attention) at smollm-135m's prefill shapes (B = 4,
   9 query and 3 KV heads, head dim 64, S = T = 2048 and 4096, bf16,
   causal) against its plain version within 3e-2 and against the plain
   version in float32 per element (4e-3 + 2^-6 |ref|) and per 128-row
   query tile (relative RMS error at most 1e-2, which a planted fault, one
   key tile dropped from the last rows, must exceed), and in float32 on the
   sweep's softcap, S < T, window and head-dim-128 cases within 2e-5; K5
   (SSD scan) at mamba2-370m's shapes (B = 4, S = 2048 and 4096, 32 heads
   of 64, one group, state 128, chunk 128, float32) within 3e-4.  Each
   kernel repeats bit for bit; CUDA-event medians of kernel, plain version
   and library yardstick (``scaled_dot_product_attention`` with
   ``enable_gqa``; none exists for SSD) beside the bound, and for K4 also
   the kernel's and the library call's time with the card's queue full
   (calls issued behind a device sleep), which leaves out the calls' host
   cost, and their host time to issue a call.  K4 once more at
   ``prefill_32k``'s sequence (B = 1, S = 32,768), against the library
   call and, on three blocks of 256 rows, the float32 plain version, and
   at head dim 128 with minitron-4b's head layout (B = 1, 24 query and
   8 KV heads, S = 4096), and at gemma2-2b's local layer (B = 1, 8 query
   and 4 KV heads of 256, S = 8192, causal, window 4096, softcap 50; the
   library call there is causal attention without window or softcap, a
   yardstick of time only), and at the head layouts phase 8b's prefills
   give it (B = 4, S = T = 2048, causal, head dim 64 or 128): olmoe-1b-7b's
   16 / 16, granite-moe-1b-a400m's 16 / 8, qwen2-vl-7b's 28 / 4 and
   jamba-v0.1-52b's 32 / 8 query / KV heads, each by the same float32
   gates with its dropped-tile fault.  The bf16 K4's registers, dynamic shared memory
   and local (spill) bytes are printed as the runtime reports them, at
   every (q/k, v) head-dim pair it is instantiated at: (64, 64), (128,
   128) and (256, 256) must keep the registers and shared bytes they had
   (``K4_SQUARE_INFO``), (80, 80) and (96, 64) must not spill.  K5's plain version runs with TF32 off; a
   planted fault (the plain version of the second half of the sequence
   alone, which drops the state carried across the midpoint) must break
   K5's tolerance.  Then K4 at its native pairs beyond (d, d), at the two
   layers that run them: hubert-xlarge's (B = 4, 16 heads of 80, S = T =
   2048, non-causal) and minicpm3-4b's MLA prefill (B = 4, 40 heads, q and
   k at 96, v at 64, S = 2048, causal): one launch a call and no padding
   copy, against the float32 plain version within 3e-2 per element and by
   the per-tile gate, bitwise repeatable, bitwise the same on q, k and v
   given as the first columns of 128-wide buffers of noise, with two
   planted faults that must break the tile gate (the padded head dim's
   scale; one key tile dropped); printed: the kernel's event median and
   queue-full time, those of the padded route it replaced on the same
   operands (copies and kernel at 128; the copies alone, the kernel alone),
   the plain version's, the bound at the true head dims, and SDPA's time at
   the true shapes with the backend it picked.
7. LM serving, a functional check and not a load: ``ServeEngine`` on
   full-width smollm-135m, olmoe-1b-7b and minicpm3-4b with
   ``launch/serve.py``'s defaults (6 requests, 4 slots, prompt 6, 8 new
   tokens, max_len 64), twice each: every request answered, tokens below
   the vocab, the same tokens both times.  Tokens per second are printed
   as a smoke reading; at this size they are mostly per-call host overhead.
8. LM prefill: ``LM.forward(params, tokens, last_only=True)`` of
   full-width smollm-135m (30 layers), mamba2-370m (48 layers) and
   gemma2-2b (26 layers, head dim 256), weights from the port's init with
   seed 0, at B = 4, S = 2048, two forwards each with the counters set to
   0 just before and read just after: K4 must launch 30 times (smollm) and
   26 times (gemma2) and K5 48 times per forward, logits must be finite and
   repeat bit for bit; the launches a forward should make follow from the
   config's block pattern.  One forward of each is profiled, with K4's
   share of the device time and K5's, summed over its four passes and
   each pass's own.  Then the
   last-position logits of a B = 2, S = 256 prefill must match the card's
   own token-by-token decode of the same prompt (no kernel on that path)
   within 5e-2: on the first 2 layers for a stack with SSM mixers (see
   ``SSM_DECODE_GATE_LAYERS``; the first 8 layers are printed,
   ``PRINTED_DECODE_LAYERS``), at full depth
   for an attention stack (gemma2-2b, whose bf16 logits reach 7.6, within
   its own ``DECODE_LOGIT_TOL``).  An attention stack's prefill also runs
   with the float32 plain attention in place of K4 (a control, printed;
   K4's prefill must be within the same tolerance of it), and with a
   planted fault (one key tile dropped from the second half's rows in
   its first K4 call), which must read above the tolerance against the
   control.
8b. LM prefill of the families ported last, each full-width model loaded
   alone (weights from the port's init, seed 0) and freed before the next:
   olmoe-1b-7b (16 layers, 64 experts top 8), granite-moe-1b-a400m (24),
   minicpm3-4b (62, MLA), qwen2-vl-7b (28, from ``embeds`` = embedding rows
   and a ``pos3`` grid with distinct temporal, height and width
   components), hubert-xlarge (48, encoder, from random frame
   ``embeds``), jamba-v0.1-52b cut to one block-pattern group (8 of its
   32 layers: the full model's bf16 weights exceed the card's 80 GB) and
   minitron-4b (32, 24 / 8 heads of 128).  For
   each, ``LM.forward(..., last_only=True)`` at B = 4, S = 2048 twice with
   the counters set to 0 just before and read just after: K4 launches once
   per attention or MLA layer (16, 24, 62, 28, 48, 1, 32) and K5 once per SSM
   layer (jamba: 7), no ``pad_head_dims`` call (every K4 call runs at its
   own head dims; a spy counts them), logits finite and bitwise
   repeatable, the MoE aux finite and positive; one forward profiled, with K4's share of the device
   time and the MoE dispatch, expert and combine einsums' shares.  Gates:
   olmoe's first MoE layer at the prefill's activations against its
   float32 per-token plain version within 3e-2 (absolute and of the largest
   output), a planted fault (the most-chosen expert's output zeroed in the
   combine) above it; every attention stack but jamba's (whose SSM layers
   phase 8 gates) against the same prefill with the float32 plain attention
   in place of K4 (B = 2, S = 256; ``CONTROL_GATE_LAYERS``, ``logit_tol``,
   the tolerance printed for each), a key tile dropped in every K4 call
   above it; every model's first K4 call of the B = 4, S = 2048 prefill
   (jamba's attention layer, hubert's first layer, minicpm3's first MLA
   layer) rerun on its real q, k and v against the float32 plain version
   per element and per 128-row tile, a dropped key tile above the tile
   gate; minicpm3's absorbed MLA decode and minitron's KV-cache decode
   against their prefills on the first 2 layers (``DECODE_GATE_LAYERS``;
   printed: minitron's and minicpm3's first 8 layers) within
   5e-2, or for minitron, whose logits reach
   6.75 there, within four bf16 steps (``DECODE_LOGIT_TOL``, as gemma2-2b's;
   its decode against a float32-attention control printed), a planted
   fault above it
   (minicpm3: a decode without the ``q_r k_r`` term of the logits, the rope
   key projection zeroed; minitron: the prefill with a key tile dropped);
   minicpm3's and hubert's prefills with K4 at its native pair bitwise
   equal to the same prefill on the padded route it took before
   (``PaddedRoute``, ``padded_route_gate``); qwen2-vl's forward
   from ``embeds = embed[tokens]`` with the positions on all three M-RoPE
   components against its token forward within 5e-2.  Each phase prints
   its wall time.
9. LM training, at full width and the reference's ``train_4k`` sequence
   (S = 4096) on ``SyntheticTokens`` seed 0.  First the autograd
   Functions alone: K4's (``FlashAttention``: the kernel forward, float32
   autograd of the plain version recomputed backward) at smollm-135m's
   layer (B = 4, 9 / 3 heads of 64, causal) and at gemma2-2b's local layer
   (B = 1, 8 / 4 heads of 256, S = 8192, window 4096, softcap 50, queries
   scaled so the logits reach the cap; its backward runs query tile by
   query tile), at hubert-xlarge's layer (B = 4, 16 heads of 80, S = 4096,
   non-causal) and at minicpm3-4b's MLA layer (B = 1, 40 heads, q/k 96 and
   v 64, causal, scale 96^-0.5), one launch and no padding copy a call,
   dq, dk and dv against float32 autograd of ``attention_plain`` per
   element and relative to each tensor's largest entry, with planted
   faults that must read above the gate (a dk without the GQA group sum
   where Hq > Hkv; a backward without the softcap's derivative; a causal
   mask in the non-causal layer's backward; the padded 128's scale in
   place of a native pair's own); K5's (``SSDScan``) at mamba2-370m's layer, dx, da_log, db and dc
   against float32 autograd of ``ssd_plain``, with a planted fault (the
   inter-chunk state's gradient dropped).  Then card against CPU:
   smollm-135m, mamba2-370m, granite-moe-1b-a400m, hubert-xlarge (from
   seeded embeddings), gemma2-2b (one local and one global layer) and
   minicpm3-4b cut to 2 layers at full width, one step (B = 2, S = 256)
   from the same parameters and batch on both: the loss within 2e-3, every gradient leaf within 5e-2 of
   the leaf's largest entry (of the model's largest gradient entry where
   the card routes some token to other experts than the CPU: near-tied
   gates at random init; the count is printed), every new parameter
   within 2 lr + 2^-7 |p| (an entry whose gradient is near 0 may take
   AdamW's first step the other way); the aux term zeroed on the card
   (granite) must read above the loss gate.  Then each model trains
   through ``build_train_step`` at a constant lr (``TRAIN_RUNS``):
   smollm-135m (30 layers, batch 8 as 2 microbatches of 4,
   ``remat="full"``, 6 steps on batches ``step % 2``), mamba2-370m (48
   layers, batch 4, 6 steps), granite-moe-1b-a400m (24 layers, batch 2,
   4 steps), and, 4 steps each, hubert-xlarge (48 layers, batch 4 of
   seeded frame embeddings whose rows carry the token ids, K4 at (80, 80)
   non-causal), gemma2-2b (26 layers, batch 1, K4 at (256, 256) windowed
   and softcapped) and minicpm3-4b (62 layers, batch 1, K4 at (96, 64));
   gemma2-2b and minicpm3-4b donate their state to the step
   (``TRAIN_DONATED``: the card cannot hold it twice).  Before each run the
   dry run's 1 x 1 estimate of its step must fit the card's free memory.
   Gates: finite losses that decrease (each step's loss below
   that of the step two before it on the same batch); K4 and K5 launches
   in every step equal to microbatches x 2 x the model's attention or SSM
   layers (counters set to 0 just before each step and read just after:
   120, 96, 48, 96, 52 and 124); two steps from one state and batch bitwise
   equal under ``torch.use_deterministic_algorithms(True)`` (for a donated
   state, which does not fit twice, two gradient passes: the loss and every
   gradient leaf; the update after them is elementwise).  On smollm-135m also:
   ``FaultTolerantRunner`` with checkpoints every 2 steps and a fault
   injected at step 3 restores once and ends its 4 steps bitwise on the
   uninterrupted run's state; 2 microbatches against one batch of 8 (loss
   within 1e-4, the first moments, 0.1 x the clipped gradients, within
   2e-2 of each leaf's largest entry); a step with
   ``use_compression=True`` finite with non-zero residuals; and
   ``launch/train.py``'s ``main`` (2 steps, ``remat="none"``: K4 once a
   layer a microbatch).  Readings per model, with the card's name and
   power limit: step ms (CUDA-event median of the run's steps after the
   first) and tokens/s, the forward / backward / optimizer split, a
   profiled step's device busy share and the shares of K4, K5 and the
   float32 attention and SSD backward, peak memory, and the first step's
   peak beside the dry run's estimate.
10. LM parallelism, on the one card.  (a) Data parallelism: a ``(2, 1)``
   mesh of two ranks on ``cuda:0`` (``make_mesh_for``), each rank's rows
   from ``SyntheticTokens.sharded_batch``, full width, S = 4096, remat
   full: smollm-135m (B = 8 as 2 microbatches), granite-moe-1b-a400m
   (B = 2, one row a rank; its first 12 of 24 layers, ``DP_DEPTH_CUT``)
   and mamba2-370m (B = 4), one step each from
   phase 9's seeded state against phase 9's one-rank step on the same
   batch by phase 9's microbatch gate (loss within 1e-4, first moments
   within 2e-2 of each leaf's largest entry); K4 and K5 launches a step
   (counters set to 0 just before it, read just after) equal to ranks x
   microbatches x 2 x the model's attention or SSM layers (240, 48, 192);
   two steps bitwise equal under deterministic algorithms; planted faults
   read in the same run above the gate: rank 1's gradient dropped from the
   rank-order sum (smollm, granite), and, on granite's router moments,
   each rank's own aux averaged in place of the aux over every rank's
   tokens (both readings printed, with the routes that flip between the
   whole batch and the ranks' halves).  The one-rank smollm step's peak
   memory is read for (c).  (b) ``cp_zigzag_attention`` at smollm-135m's
   layer (B = 4, 9 / 3 heads of 64, S = 4096, bf16) over a ``(1, 16)``
   mesh of 16 ranks on the card, ``p_shards=16``, both modes: 32 K4
   launches a call, against the float32 plain causal attention by K4's
   per-element and per-tile gates, a planted fault (rank 0's high chunk
   without its last key chunk) above the tile gate, whether it equals one
   K4 call over the whole sequence bit for bit, and its event median and
   queue-full time beside one K4 call's (a reading, not a gate); then a
   smollm-135m forward (B = 2, S = 4096) under ``ATTN_IMPL="cp_zigzag"``
   and ``set_mesh`` against the same forward without it, by phase 8's
   logit tolerance over every position, with 960 K4 launches.  (c) The
   dry run (``launch/dryrun.py``) of smollm-135m ``train_4k`` on the
   16 x 16 meta mesh, its JSON printed; then its memory estimate on a
   1 x 1 mesh at (a)'s smollm step (B = 8 as 2 x 4, remat full) beside
   that step's measured ``torch.cuda.max_memory_allocated`` and phase 9's.
11. Long context, the reference's ``prefill_32k``, ``decode_32k`` and
   zigzag-CP cells (``launch/cells.py::build_cell_fn``), full width, seed 0.
   ``prefill_32k`` (S = 32,768, ``last_only``) of smollm-135m at the
   reference's B = 32 and, cut to fit one card, mamba2-370m (8), gemma2-2b
   (8), minicpm3-4b (4), hubert-xlarge (4, frames carrying the ids) and
   minitron-4b (4): two forwards each, K4 / K5 launches over both from the
   block pattern, logits finite and bitwise repeatable, the first forward's
   peak memory beside the dry run's 1 x 1 estimate, the second's CUDA-event
   time, profiled (busy share, K4's or K5's share), with its first K4 call
   captured (gemma2-2b: its first local and first global call) or its
   first K5 call.  Gates on the captured activations, each with a planted
   fault read above its limit in the same run: K4 per element and per
   128-row tile on the rows of ``k4_blocks`` against the float32 plain
   version of those rows (1/16 of the keys the last rows see dropped,
   ``dropped_keys``: a tile at S = 2048, as phase 8b drops); K5 against
   ``ssd_plain`` within K5_TOL (the state carried into the middle chunk
   zeroed).  Each call's kernel, plain (a row and head at a time), SDPA
   (where it takes the call) and bound times are printed.  smollm-135m and
   gemma2-2b also prefill under ``ATTN_IMPL="cp_zigzag"`` on a (1, 16) mesh
   of ranks on the card: the CP call at the captured operands (32 K4
   launches, the same row gates, bitwise one K4 call or not), then the CP
   prefill against the one-call prefill (bitwise or within LM_LOGIT_TOL; K4
   launches 32 a causal global layer, one a local; a planted fault, the
   values of each CP call's diagonal key chunk zeroed, above the gate).  ``decode_32k`` for smollm-135m (B = 8), gemma2-2b (4) and
   minicpm3-4b (4, its first 2 layers): the cache filled with 32,767 tokens
   in chunks through ``LM.forward(..., cache=, cache_pos=i)`` (no K4
   launch), token 32,767 decoded, its logits against the K4 prefill's of
   the same tokens within max(LM_LOGIT_TOL, SDPA-in-K4's-place control) or,
   for gemma2-2b, DECODE_LOGIT_TOL; a prefill with the values of 1/16 of
   the keys zeroed in every K4 call above it; fill time, ms a decode step,
   cache bytes and the fill's peak beside the estimate with the fill's block.
   Then phase 9's smollm-135m ``train_4k`` step (B = 8 as 2 x 4, remat full)
   under ``"cp_zigzag"`` and, on tokens and targets permuted by
   ``zigzag_positions``, ``"cp_zigzag_native"``, both inside ``set_mesh``,
   against the step with one K4 call a layer: the loss within 1e-4, first
   moments within 2e-2 of each leaf's largest entry (phase 10's gate), K4 launches
   a step (2 x 2 x 30 x 32), a planted fault above the gate.
12. ``long_500k``: the reference's last cell (``phase_long_500k``):
   mamba2-370m's decode step and its 524,288-token prefill through K5,
   jamba's group against a seeded 524,288 cache, and K4 at S = 524,288.
13. Examples: the JAX package's four example flows through the port's
   entry points (``repro_torch.examples``) at the reference's defaults:
   ``quickstart`` at scale 0.5 (shgn and rgcn over ACM, the serving engine
   with ACM and IMDB, a parameter swap and a ``GraphDelta`` swap),
   ``hgnn_train_acm --na-executor banded`` at scale 1.0 for 20 steps,
   ``restructure_demo`` on ACM, DBLP and IMDB, and ``lm_serve_demo`` (6
   requests on reduced smollm-135m), each with K1, K2 and K4's counts set
   to 0 just before it and read just after.  Gates: K1 and K2 launch in
   quickstart and in training; quickstart's shgn logits within 1e-4 of the
   same compile on the CPU; every served response bit for bit the rows of
   a compiled forward at its ``params_version`` (one zeroed row planted
   must fail that gate); training losses finite, the last below the first,
   labels and masks bitwise the CPU's; restructure_demo's numbers equal to
   its run with ``--device cpu``; every LM request yields ``max_new``
   tokens.  Printed: each flow's wall time and launches, and the phase's
   time (its budget, 40 s, is not gated).
14. Report: one JSON line ``{"kernels": [...]}`` (K1 and K2 with their
   launches per train step by model, K1 with its launches in one
   dependency forward, rows for K1 and K2 over phase 3c's sliced packings,
   rows for K1 and K2 over phase 3d's spliced packing, rows for K1 and
   K2 over phase 3e's largest merged shard stream, K4's and K5's rows with
   their launches by model and per train step, and a row for K4 at its
   native (Dqk, Dv) pair at each of hubert-xlarge's and minicpm3-4b's
   layers, with its launches in phase 8b and per train step and the
   padded-route gate; K4's and K5's launches per
   data-parallel step and K4's per CP
   call, phase 10; phase 11's rows: K4 at 32k in each model, zigzag CP at
   32k, K5 at 32k; K1's, K2's and K4's launches in each example flow of
   phase 13), the card line, and last the contract line ``{"ok":
   true, "device": {...}}``.

Needs one CUDA card; exits non-zero without one, or without the repository
beside it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
D = 64
TARGETS = ["APA", "PAP", "PSP"]
MODELS = ("rgcn", "rgat", "shgn")
FORWARDS = 3
NA_PER_FORWARD = 9  # 3 semantic graphs x 3 layers
K1_TOL = 1e-4  # |d| <= tol + tol * |plain|: seg_sum fp32 in test_kernels.py
K2_RTOL = 1e-5  # s relative to max(1, |s|); m is a max, expected exact
LOGIT_ATOL = 1e-4  # reference suite's logits tolerance (test_gfp_banded.py)
GRAD_ATOL = 1e-4  # reference suite's gradient tolerance (test_grad_banded.py:85)
# ... and, tighter at full width, 1e-4 of the largest gradient entry: the
# loss is a mean over 1,815 train vertices, so its gradients peak near
# 7.5e-3, and a backward that drops PAP's hub row (1,068 of 110,476 edges)
# moves them by only 7.7e-5, inside 1e-4; card and CPU agree to 5.6e-9
# (PERF.md section 6, PR 18).  This gate sits between the two.
GRAD_RTOL = 1e-4
FAULT_METAPATH = "PAP"  # the packing whose backward view the planted fault breaks
FIT_EPOCHS = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
INT8_OP_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense (exact for 0/1)
BF16_FLOP_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_FLOP_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
K4_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # test_kernels.py:98
# K4 bf16 against its float32 plain version, per element and per 128-row
# query tile.  Sound: the bf16 rounding of P and of the output, about 2e-3
# of a tile's RMS; a dropped key tile at S = 32k moves the last rows by
# about sqrt(128 / S) = 6e-2 of it (PERF.md, section 6).
K4_BF16_ATOL, K4_BF16_RTOL = 4e-3, 2 ** -6
K4_TILE_RMS = 1e-2
K5_TOL = 3e-4  # test_kernels.py:125
LM_LOGIT_TOL = 5e-2  # decode-vs-forward tolerance, test_models_lm.py:80
LM_BATCH, LM_SEQ = 4, 2048  # the prefill phase's batch and sequence
DECODE_BATCH, DECODE_SEQ = 2, 256  # prefill-vs-decode check
# Depth of the gated prefill-vs-decode check for a stack with SSM mixers.
# In random-weight mamba2-370m at bf16 the two paths' rounding differences
# grow with depth, in the JAX reference as in the port: tests/test_torch_lm.py
# ::test_mamba2_prefill_decode_gap_at_depth_tracks_the_reference holds the
# port's gap to the reference's at 8 and 16 layers on the CPU.  Here the gate
# takes the first 2 layers, the depth of the reference suite's own
# decode-vs-forward test, and a deeper cut is measured and printed.
SSM_DECODE_GATE_LAYERS = 2
# Depth of the printed (not gated) prefill-vs-decode readings that would be
# at full depth: the token-by-token decode is host-bound (148 ms a step at
# minicpm3-4b's 62 layers, 73 at mamba2-370m's 48, 58 at minitron-4b's 32),
# and the run must end within its time limit, so these read their first 8
# layers (16 before phase 11 came in; minitron-4b read its full depth).
PRINTED_DECODE_LAYERS = {"mamba2-370m": 8, "minicpm3-4b": 8, "minitron-4b": 8}
# Prefill-vs-decode tolerance of an attention stack at full depth, where it
# is not LM_LOGIT_TOL.  The logits are a bf16 product: at gemma2-2b's
# full-width magnitudes (up to 7.6, a bf16 step of 2^-5) the prefill with
# the float32 plain attention in place of K4 misses decode by three steps
# (0.0936, PERF.md section 6) as K4's does; its tolerance is four steps.
# A planted fault read in the same run must break each stack's tolerance.
# minitron-4b's logits reach 6.75 at 2 layers (a bf16 step of 2^-5 there):
# its KV-cache decode misses the prefill by 2.5 steps, as far as a float32-
# attention control prefill does (PERF.md section 6), within the same four.
DECODE_LOGIT_TOL = {"gemma2-2b": 4 * 2 ** -5, "minitron-4b": 4 * 2 ** -5}
K4_SHAPES = [(4, 9, 3, 2048, 64), (4, 9, 3, 4096, 64)]  # B, Hq, Hkv, S = T, Dh
K4_DH128 = (1, 24, 8, 4096, 128)  # minitron-4b's head layout
# the head layouts phase 8b's prefills give K4: B, Hq, Hkv, S = T, Dh
K4_MODEL_LAYOUTS = {
    "olmoe-1b-7b": (4, 16, 16, 2048, 128),
    "granite-moe-1b-a400m": (4, 16, 8, 2048, 64),
    "qwen2-vl-7b": (4, 28, 4, 2048, 128),
    "jamba-v0.1-52b": (4, 32, 8, 2048, 128),
}
# gemma2-2b's local layer at twice its window: B, Hq, Hkv, S = T, Dh, window, softcap
K4_GEMMA_LOCAL = (1, 8, 4, 8192, 256, 4096, 50.0)
K4_PLAIN_LOGITS = 4 * 9 * 4096 * 4096  # the largest B * Hq * S * T run in full plain
K4_F32_CASES = [  # test_flash_attention_sweep's softcap, S < T, window, Dh 128
    (1, 8, 2, 100, 100, 64, True, None, 50.0),
    (1, 4, 4, 96, 224, 64, True, None, None),
    (2, 4, 2, 128, 128, 64, True, 64, None),
    (1, 2, 1, 64, 64, 128, False, None, None),
]
K5_SHAPES = [(4, 2048, 32, 1, 64, 128, 128), (4, 4096, 32, 1, 64, 128, 128)]  # B,S,H,G,P,N,L
K5_TF32_PRODUCTS = 3  # 3xTF32: each float32 product is three TF32 products
# the kernels one K5 call launches, in order (csrc/ssd_scan.cu)
K5_PASSES = ("ssd_chunk_state_kernel", "ssd_cb_kernel", "ssd_state_pass_kernel",
             "ssd_output_kernel")
LM_ARCHS = ("smollm-135m", "mamba2-370m", "gemma2-2b")  # phase 8's full-width models
# phase 8b's full-width models, each loaded alone and freed before the next
LM_NEW_ARCHS = ("olmoe-1b-7b", "granite-moe-1b-a400m", "minicpm3-4b", "qwen2-vl-7b",
                "hubert-xlarge", "jamba-v0.1-52b", "minitron-4b")
# depth cuts: jamba-v0.1-52b's 32 layers hold about 104 GB of bf16 weights,
# more than the card's 80 GB; one block-pattern group of 8 layers (about
# 26.5 GB) runs its SSM, attention, MLP and MoE layers
LM_DEPTH_CUT = {"jamba-v0.1-52b": 8}
LM_SERVE_ARCHS = ("olmoe-1b-7b", "minicpm3-4b")  # phase 7's models beside smollm-135m
# K4's native (Dqk, Dv) pairs beyond (d, d) at the two layers that run them
# (they took the padded route at 128 before): B, H, S = T, Dqk, Dv, causal
K4_NATIVE = {
    "hubert-xlarge": (4, 16, 2048, 80, 80, False),
    "minicpm3-4b": (4, 40, 2048, 96, 64, True),
}
# the bf16 kernel's registers a thread and dynamic shared bytes at the
# square pairs, as the card reported them before the native pairs came in
# (PERF.md section 6): the (Dqk, Dv) templates leave them as they were
K4_SQUARE_INFO = {(64, 64): (168, 83016), (128, 128): (168, 164936),
                  (256, 256): (168, 197704)}
MOE_TOL = 3e-2  # the MoE layer against its float32 plain version (bf16 einsums)
# Phase 8b's logit gates are bf16 products: two prefills (or a prefill and
# a decode) whose attention rounds at other places drift apart with depth.
# On the card (PERF.md, PR 22), replacing K4 by an independent bf16 flash
# attention (SDPA's cuDNN kernel) moves each stack from the float32 control
# as far as K4 does, at every depth: 0.084-0.29 at full depth for olmoe,
# minicpm3 and qwen2-vl, 0.031-0.29 already at 2 layers where the logits
# reach 8-19 (one bf16 step there is 0.0625-0.125, above 5e-2).  So the
# gates read the first layers only (the depth below; hubert-xlarge holds at
# full depth), within LM_LOGIT_TOL or two bf16 steps at the logits' largest
# magnitude, and print the full depth beside the SDPA yardstick; the planted
# fault (a key tile dropped in every K4 call) is read at the gated depth.
CONTROL_GATE_LAYERS = {"olmoe-1b-7b": 1, "granite-moe-1b-a400m": 1, "minicpm3-4b": 1,
                       "qwen2-vl-7b": 1, "minitron-4b": 2}
# phase 8b's prefill-vs-decode gate, on the first layers (a deeper one printed):
# minicpm3-4b's absorbed MLA decode and minitron-4b's KV-cache decode
DECODE_GATE_LAYERS = 2
DECODE_GATE_ARCHS = ("minitron-4b",)  # beside every MLA stack
IMDB_TARGETS = ["AMA", "MAM", "MDM"]  # phase 3c's IMDB tenants (target M)
SERVE_PER_TENANT = 64  # requests a tenant in phase 3c's burst, of 4-16 ids each
SERVE_WAVES = 8  # the burst arrives in waves, one every SERVE_WAVE_GAP_S
SERVE_WAVE_GAP_S = 0.01
SERVE_WINDOW_MS = 5.0  # ServePolicy.batch_window_ms: waves coalesce into groups
SERVE_WHOLE_GRAPH = 2  # whole-graph requests a tenant after the burst
DEP_COVERAGE = 0.75  # ServePolicy.dependency_threshold (its default)
DELTA_EDGES = 64  # PS edges phase 3d's delta (a) inserts, PA edges (b) removes
DELTA_GROW, DELTA_GROW_EDGES = 16, 3  # delta (c): new P vertices, PA edges each
DELTA_MODELS = ("rgcn", "rgat")
# every array of a PackedEdges the row views and the kernels derive from
PACKED_FIELDS = ("src_local", "dst_local", "band", "dst_tile", "first_in_tile",
                 "count", "edge_block_id", "edge_slot")
SHARD_RANKS = 4  # phase 3e's ranks (REPRO_TORCH_VIRTUAL_DEVICES), all on the one card
SHARD_MODES = ("relation", "edge_block")
SHARD_GROUPS = {"acm-rgcn": ("rgcn", [0, 1]), "acm-rgat": ("rgat", [2, 3])}  # pinned tenants
SHARD_SERVE_PER_TENANT = 12  # phase 3e's burst: requests a tenant, the last 2 whole-graph
PREFILL_32K = 32768
SGB_WORKLOADS = {  # dataset -> SGB targets, composed at scale 1.0
    "ACM": ["APA", "PAP", "PSP"],
    "IMDB": ["MAM", "AMA", "MKM"],
    "DBLP": ["APA", "APTPA", "APVPA"],
}


def require(cond: bool, msg: str) -> None:
    """Fail the run (non-zero exit) unless ``cond`` holds."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_events(prof):
    """``(device us, launches, name)`` of every device kernel a profile saw."""
    rows = []
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue  # CPU ops: their device time is their kernels', counted here
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    return rows


def device_ms(label: str, fn, reps: int = 20):
    """Device time in ms of every kernel one call of ``fn`` launches, the
    mean over ``reps`` warm calls (torch.profiler): the call's host cost
    left out.  Prints the launches the trace recorded beside the time.  A
    trace can miss a launch, so every kernel must show a multiple of
    ``reps``; else, as when it saw no device event, the time is not
    measured (None)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = _device_events(prof)
    counts = sorted({r[1] for r in rows})
    if not rows or any(c % reps for c in counts):
        print(f"device time {label}: not measured (launches a kernel recorded over "
              f"{reps} calls: {counts or 'none'})")
        return None
    ms = sum(r[0] for r in rows) / reps / 1e3
    print(f"device time {label}: {ms:.4f} ms a call; {len(rows)} kernel(s), launches "
          f"recorded over {reps} calls: {counts}")
    return ms


def queued_ms(fn, reps: int = 20) -> float:
    """ms a call of ``fn`` with the card's queue full: CUDA events around
    ``reps`` calls issued while the card sleeps (``torch.cuda._sleep``), so
    the calls run back to back and their host cost is hidden.  Unlike
    ``device_ms`` it needs no trace (which loses the last of a run of long
    kernels) and counts the gaps between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms: longer than issuing the calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


class PadCalls:
    """Counts the padded route's copies: each ``pad_head_dims`` call made
    while the context is open (the wrapper reads the module attribute at
    call time), in ``calls``."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa

        self.fa, self.pad, self.calls = fa, fa.pad_head_dims, 0

        def spy(*args):
            self.calls += 1
            return self.pad(*args)

        fa.pad_head_dims = spy
        return self

    def __exit__(self, *exc):
        self.fa.pad_head_dims = self.pad


class PaddedRoute:
    """K4 as it ran before its native (Dqk, Dv) pairs: while open, the
    wrapper takes only the square pairs natively, so hubert's 80 and MLA's
    96 / 64 go through ``pad_head_dims`` (q, k and v zero-padded to 128)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa

        self.fa, self.pairs = fa, fa.NATIVE_PAIRS
        fa.NATIVE_PAIRS = tuple((d, d) for d in fa.HEAD_DIMS)
        return self

    def __exit__(self, *exc):
        self.fa.NATIVE_PAIRS = self.pairs


def host_us(fn, reps: int = 200) -> float:
    """Host time in us to issue one call of ``fn``, the mean over ``reps``
    calls issued back to back (host clock, no sync between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def bound(nbytes: float, flops: float):
    """Least time in ms the card could take, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_shape(rows) -> dict:
    """The row kernels' work list over one row view of a packing: CTAs,
    items, the most edges any CTA or item holds, and the skew it meets."""
    from repro_torch.kernels.seg_sum import ITEMS_PER_CTA

    edges = (rows.items[:, 3] - rows.items[:, 2]).astype(np.int64)
    deg = np.diff(rows.row_ptr)
    return {"ctas": int(edges.size // ITEMS_PER_CTA), "items": int(edges.size),
            "max_cta_edges": int(edges.reshape(-1, ITEMS_PER_CTA).sum(1).max()),
            "max_item_edges": int(edges.max()), "max_in_degree": int(deg.max()),
            "empty_rows": int((deg == 0).sum())}


def na_kernels_on(pk, label: str, dev):
    """K1 and K2 on one packing at D = 64: agreement with the plain
    versions, bitwise repeat, CUDA-event medians of kernel, plain version
    and library yardstick, and the bound."""
    from repro_torch.kernels.edge_softmax import (NEG, edge_softmax_stats,
                                                  softmax_stats_plain)
    from repro_torch.kernels.seg_sum import (seg_sum_na, seg_sum_plain,
                                             seg_sum_transposed,
                                             seg_sum_transposed_plain)

    nb, eb = pk.src_local.shape
    n_edges, tiles = pk.num_edges, pk.num_dst_tiles
    work = work_shape(pk.row_edges())
    print(f"kernels: {label} packing, {n_edges} edges in {nb} blocks over "
          f"{tiles} dst tiles, D={D}; work list {work}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = torch.randn(pk.num_src, D, device=dev, generator=gen)
    w_rand = torch.rand(nb, eb, device=dev, generator=gen)
    logits = torch.randn(nb, eb, device=dev, generator=gen) * 3
    db = pk.device_blocked(dev)
    src_e, dst_e = db["edge_src"], db["edge_dst"]
    blk, slot = db["edge_blk"], db["edge_slot"]
    out = []

    # --- K1 --------------------------------------------------------------
    err = 0.0
    for wl, w in (("unit", None), ("random", w_rand)):
        a = seg_sum_na(pk, h, w)
        b = seg_sum_na(pk, h, w)
        ref = seg_sum_plain(pk, h, w)
        torch.cuda.synchronize()
        e = (a - ref).abs().max().item()
        excess = ((a - ref).abs() - K1_TOL * ref.abs()).max().item()
        print(f"K1 seg_sum {label} ({wl} weights): max|kernel - plain| = {e:.3e}, "
              f"max|plain| = {ref.abs().max().item():.3f} (tolerance {K1_TOL} "
              f"+ {K1_TOL} x |plain|); run-to-run bitwise equal: {torch.equal(a, b)}")
        require(excess <= K1_TOL, f"K1 {label} {wl} weights disagree with the plain version")
        require(torch.equal(a, b), f"K1 {label} {wl} weights not bitwise repeatable")
        err = max(err, e)
    w_e = w_rand[blk, slot]

    def k1_library():
        return torch.zeros(pk.num_dst, D, device=dev).index_add_(
            0, dst_e, h[src_e] * w_e[:, None])

    ref = seg_sum_plain(pk, h, w_rand)
    lib_excess = ((k1_library() - ref).abs() - K1_TOL * ref.abs()).max().item()
    require(lib_excess <= K1_TOL, "K1 library yardstick disagrees")
    k1_ms = median_ms(lambda: seg_sum_na(pk, h, w_rand))
    k1_plain = median_ms(lambda: seg_sum_plain(pk, h, w_rand), reps=10)
    k1_lib = median_ms(k1_library)
    k1_dev = device_ms(f"K1 {label}", lambda: seg_sum_na(pk, h, w_rand))
    k1_lib_dev = device_ms(f"K1 library {label}", k1_library)
    k1_host = host_us(lambda: seg_sum_na(pk, h, w_rand))
    # the same launch through the autograd Function, which a call that
    # needs a gradient takes (the forward of a train step)
    h_grad = h.clone().requires_grad_(True)
    k1_host_fn = host_us(lambda: seg_sum_na(pk, h_grad, w_rand))
    # K1 over the source-major view, the backward's launch; its plain
    # version is index_add_, which is also the library call
    g = torch.randn(pk.num_dst, D, device=dev, generator=gen)
    ta, tb = seg_sum_transposed(pk, g, w_rand), seg_sum_transposed(pk, g, w_rand)
    t_ref = seg_sum_transposed_plain(pk, g, w_rand)
    torch.cuda.synchronize()
    t_err = (ta - t_ref).abs().max().item()
    t_excess = ((ta - t_ref).abs() - K1_TOL * t_ref.abs()).max().item()
    t_work = work_shape(pk.src_edges())
    print(f"K1 transposed {label} (random weights): max|kernel - index_add_| = "
          f"{t_err:.3e}; run-to-run bitwise equal: {torch.equal(ta, tb)}; work list {t_work}")
    require(t_excess <= K1_TOL, f"K1 over {label}'s source-major view disagrees")
    require(torch.equal(ta, tb), f"K1 over {label}'s source-major view not repeatable")
    transposed = {
        "ms": median_ms(lambda: seg_sum_transposed(pk, g, w_rand)),
        "plain_ms": median_ms(lambda: seg_sum_transposed_plain(pk, g, w_rand)),
        "device_ms": device_ms(f"K1 transposed {label}",
                               lambda: seg_sum_transposed(pk, g, w_rand)),
        "plain_device_ms": device_ms(f"K1 transposed plain (index_add_) {label}",
                                     lambda: seg_sum_transposed_plain(pk, g, w_rand)),
        "max_abs_err": t_err, "work": t_work,
    }
    print(f"K1 transposed {label}: kernel {transposed['ms']:.4f} ms (device "
          f"{_ms(transposed['device_ms'])}), index_add_ {transposed['plain_ms']:.4f} ms "
          f"(device {_ms(transposed['plain_device_ms'])}); host us a K1 call "
          f"needing no gradient {k1_host:.1f}, through the autograd Function "
          f"{k1_host_fn:.1f}")
    meta = nb * 4 * 2 + nb * 4 + (tiles + 1) * 4  # band, count, tile list
    k1_bytes = n_edges * (2 + 2 + 4) + pk.num_src * D * 4 + pk.num_dst * D * 4 + meta
    k1_bound, k1_by = bound(k1_bytes, 2.0 * n_edges * D)
    out.append({
        "name": "seg_sum_na", "route": "cuda",
        "source": "src/repro_torch/csrc/na_kernels.cu",
        "replaces": "src/repro/kernels/seg_sum.py:516",
        "max_abs_err": err, "ms": k1_ms, "plain_ms": k1_plain,
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib,
        "bytes": k1_bytes, "shape": f"{label} E={n_edges} nb={nb} tiles={tiles} D={D}",
        "work": work, "device_ms": k1_dev, "library_device_ms": k1_lib_dev,
        "host_us_per_call": k1_host, "host_us_per_call_function": k1_host_fn,
        "transposed": transposed,
    })

    # --- K2 --------------------------------------------------------------
    m1, s1 = edge_softmax_stats(pk, logits)
    m2, s2 = edge_softmax_stats(pk, logits)
    mr, sr = softmax_stats_plain(pk, logits)
    torch.cuda.synchronize()
    em = (m1 - mr).abs().max().item()
    es = (s1 - sr).abs().max().item()
    es_rel = ((s1 - sr).abs() / sr.abs().clamp(min=1.0)).max().item()
    same = torch.equal(m1, m2) and torch.equal(s1, s2)
    print(f"K2 edge_softmax_stats {label}: max|dm| = {em:.3e} (m bitwise equal: "
          f"{torch.equal(m1, mr)}), max|ds| = {es:.3e} (relative {es_rel:.3e}, "
          f"tolerance {K2_RTOL}); run-to-run bitwise equal: {same}")
    require(torch.equal(m1, mr) and es_rel <= K2_RTOL,
            f"K2 {label} disagrees with the plain version")
    require(same, f"K2 {label} not bitwise repeatable")
    l_e = logits[blk, slot]

    def k2_library():
        m = torch.full((pk.num_dst,), NEG, device=dev).scatter_reduce_(
            0, dst_e, l_e, "amax")
        s = torch.zeros(pk.num_dst, device=dev).index_add_(
            0, dst_e, torch.exp(l_e - m[dst_e]))
        return m, s

    _, sl = k2_library()
    require(((sl - sr).abs() / sr.abs().clamp(min=1.0)).max().item() <= K2_RTOL,
            "K2 library yardstick disagrees")
    k2_ms = median_ms(lambda: edge_softmax_stats(pk, logits))
    k2_plain = median_ms(lambda: softmax_stats_plain(pk, logits), reps=10)
    k2_lib = median_ms(k2_library)
    k2_dev = device_ms(f"K2 {label}", lambda: edge_softmax_stats(pk, logits))
    k2_lib_dev = device_ms(f"K2 library {label}", k2_library)
    k2_host = host_us(lambda: edge_softmax_stats(pk, logits))
    k2_bytes = n_edges * (2 + 4) + nb * 4 + nb * 4 + (tiles + 1) * 4 + pk.num_dst * 8
    k2_bound, k2_by = bound(k2_bytes, 6.0 * n_edges)
    out.append({
        "name": "edge_softmax_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/na_kernels.cu",
        "replaces": "src/repro/kernels/edge_softmax.py:32",
        "max_abs_err": max(em, es), "ms": k2_ms, "plain_ms": k2_plain,
        "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib,
        "bytes": k2_bytes, "shape": f"{label} E={n_edges} nb={nb} tiles={tiles}",
        "work": work, "device_ms": k2_dev, "library_device_ms": k2_lib_dev,
        "host_us_per_call": k2_host,
    })
    for k in out:
        print(f"{k['name']} {label}: kernel {k['ms']:.4f} ms (device {_ms(k['device_ms'])}, "
              f"host {k['host_us_per_call']:.1f} us a call), plain {k['plain_ms']:.4f} ms, "
              f"library {k['library_ms']:.4f} ms (device {_ms(k['library_device_ms'])}), "
              f"bound {k['bound_ms']:.6f} ms ({k['bound_by']}, {k['bytes']} bytes); "
              f"{work['ctas']} CTAs, at most {work['max_cta_edges']} edges a CTA")
    return out


def phase_kernels(graph, dblp, dev):
    """Phase 2: K1 and K2 against their plain versions on the card, on ACM
    PAP and on DBLP APTPA."""
    from repro_torch.pipeline import (FrontendPipeline, PipelineConfig,
                                      SemanticGraphCache)

    res = FrontendPipeline(PipelineConfig(pack=True),
                           cache=SemanticGraphCache()).run(graph, TARGETS)
    print("frontend (host, cold): " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in res.timings.items()))
    out = na_kernels_on(res.packed["PAP"], "ACM PAP", dev)
    res = FrontendPipeline(PipelineConfig(pack=True),
                           cache=SemanticGraphCache()).run(dblp, ["APTPA"])
    for k, other in zip(out, na_kernels_on(res.packed["APTPA"], "DBLP APTPA", dev)):
        k["max_abs_err"] = max(k["max_abs_err"], other["max_abs_err"])
        k["dblp_aptpa"] = {key: other[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
            "bytes", "shape", "work", "device_ms", "library_device_ms",
            "host_us_per_call", "transposed") if key in other}
    return out


def phase_model(graph):
    """Phase 3: the main path on the card, held against the CPU run."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.kernels.edge_softmax import edge_softmax_stats
    from repro_torch.kernels.seg_sum import seg_sum_na

    sess = Session(ExecutorSpec(na_executor="banded"))
    cpu = Session(ExecutorSpec(na_executor="banded", device="cpu"), cache=sess.cache)
    feats = device_features(graph, "cuda")
    feats_cpu = device_features(graph, "cpu")
    cfgs = {m: HGNNConfig(model=m, hidden=64, num_layers=3, sf_att_dim=64,
                          target_type="P") for m in MODELS}
    compiled = {m: sess.compile(graph, TARGETS, cfgs[m]) for m in MODELS}
    params = {m: compiled[m].init(SEED) for m in MODELS}
    torch.cuda.synchronize()

    seg_sum_na.launches = 0
    edge_softmax_stats.launches = 0
    logits, latency = {}, {}
    for m in MODELS:
        outs, lat = [], []
        for _ in range(FORWARDS):
            k1, k2 = seg_sum_na.launches, edge_softmax_stats.launches
            t0 = time.perf_counter()
            outs.append(compiled[m].forward(params[m], feats))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            d1 = seg_sum_na.launches - k1
            d2 = edge_softmax_stats.launches - k2
            want2 = 0 if m == "rgcn" else NA_PER_FORWARD
            require(d1 == NA_PER_FORWARD, f"{m}: K1 launched {d1} times in a forward")
            require(d2 == want2, f"{m}: K2 launched {d2} times in a forward")
        logits[m], latency[m] = outs, lat
    launches = {"seg_sum_na": seg_sum_na.launches,
                "edge_softmax_stats": edge_softmax_stats.launches}
    print(f"model: launches over {len(MODELS)} models x {FORWARDS} forwards: {launches}")

    for m in MODELS:
        first = logits[m][0]
        require(first.shape == (compiled[m].num_target, 3), f"{m}: logits shape {first.shape}")
        require(bool(torch.isfinite(first).all()), f"{m}: non-finite logits")
        require(all(torch.equal(first, o) for o in logits[m][1:]),
                f"{m}: logits differ between forwards")
        t0 = time.perf_counter()
        c_cpu = cpu.compile(graph, TARGETS, cfgs[m])
        ref = c_cpu.forward(c_cpu.init(SEED), feats_cpu)
        cpu_s = time.perf_counter() - t0
        err = (first.cpu() - ref).abs().max().item()
        print(f"model {m}: logits {tuple(first.shape)}, max|logit| "
              f"{first.abs().max().item():.4f}, max|cuda - cpu| = {err:.3e} "
              f"(tolerance {LOGIT_ATOL}); forward ms {['%.3f' % x for x in latency[m]]}; "
              f"cpu forward {cpu_s:.1f} s")
        require(err <= LOGIT_ATOL, f"{m}: card logits disagree with the CPU run")

    for m in ("rgat", "rgcn"):
        rows = prof_call(f"{m} forward", lambda: compiled[m].forward(params[m], feats))
        na_ms = sum(r[0] for r in rows if "_rows_kernel" in r[2]) / 1e3
        print(f"profile {m} forward: K1 + K2 device time {na_ms:.3f} ms")
    return launches


def phase_jnp_repeat(graph, dev) -> dict:
    """Phase 3f: the segment-sum executor (``na_executor="jnp"``) repeats
    bit for bit on the card: rgcn and rgat on full-width ACM, two forwards
    and two ``loss`` gradients (every parameter and feature leaf), each pair
    bitwise equal; the logits within LOGIT_ATOL of the CPU's.  Printed
    beside it (not gated: atomics may happen to land in one order): the
    same forwards with ``segment_sum`` replaced by the ``index_add_`` it
    replaced, float atomics on the card."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.core.hgnn import layers
    from repro_torch.train import (semi_supervised_masks, tree_leaves,
                                   value_and_grad)

    t0 = time.perf_counter()
    sess = Session(ExecutorSpec(na_executor="jnp"))
    cpu = Session(ExecutorSpec(na_executor="jnp", device="cpu"), cache=sess.cache)
    feats, feats_cpu = device_features(graph, dev), device_features(graph, "cpu")
    out = {}
    for m in ("rgcn", "rgat"):
        cfg = HGNNConfig(model=m, hidden=64, num_layers=3, sf_att_dim=64, target_type="P")
        c = sess.compile(graph, TARGETS, cfg)
        params = c.init(SEED)
        fwd = [c.forward(params, feats) for _ in range(2)]
        c_cpu = cpu.compile(graph, TARGETS, cfg)
        err = (fwd[0].cpu() - c_cpu.forward(c_cpu.init(SEED), feats_cpu)).abs().max().item()
        n = c.num_target
        labels = torch.from_numpy(np.random.default_rng(SEED).integers(0, 3, n)).to(dev)
        mask = semi_supervised_masks(n, seed=SEED, device=dev)["train"]
        runs = [value_and_grad(lambda p, f: c.loss(p, f, labels, mask), params, feats)
                for _ in range(2)]
        pairs = list(zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])))
        differ = sum(not torch.equal(a, b) for a, b in pairs)
        same_fwd = torch.equal(fwd[0], fwd[1])
        same_loss = torch.equal(runs[0][0], runs[1][0])

        def index_add(x, seg, n_seg):
            return x.new_zeros((n_seg,) + tuple(x.shape[1:])).index_add_(0, seg, x)

        kept, layers.segment_sum = layers.segment_sum, index_add
        try:
            atomics = [c.forward(params, feats) for _ in range(2)]
        finally:
            layers.segment_sum = kept
        print(f"jnp executor {m} (full-width ACM, {n} P vertices): two forwards bitwise "
              f"equal: {same_fwd}; two loss gradients: loss bitwise equal {same_loss}, "
              f"{differ} of {len(pairs)} leaves differ; max|card - cpu| logits {err:.3e} "
              f"(tolerance {LOGIT_ATOL}); with index_add_ (float atomics) in place of "
              f"segment_sum the two forwards are bitwise equal: "
              f"{torch.equal(atomics[0], atomics[1])} (max|d| "
              f"{(atomics[0] - atomics[1]).abs().max().item():.3e}; printed)")
        require(same_fwd, f"jnp executor {m}: two forwards differ on the card")
        require(same_loss and differ == 0 and pairs,
                f"jnp executor {m}: two gradients differ on the card ({differ} leaves)")
        require(err <= LOGIT_ATOL, f"jnp executor {m}: card logits disagree with the CPU run")
        out[m] = {"forward_bitwise": same_fwd, "grad_leaves_differ": differ,
                  "cpu_err": err, "index_add_forward_bitwise": torch.equal(*atomics)}
    print(f"phase 3f (jnp executor repeat): {time.perf_counter() - t0:.1f} s of wall time")
    return out


def leaf_paths(tree, prefix="") -> list:
    """Names of a tree's leaves in flatten order (``train.tree``)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def na_backward_per_step(graphs, layers: int, target: str) -> int:
    """NA calls whose backward runs in a train step: a graph's NA at a
    layer is differentiated only if its destination type reaches the
    head's target type through the later layers (autograd runs nothing
    else; on ACM the A -> A graph APA never does)."""
    live, count = {target}, 0
    for _ in range(layers):  # from the last layer back
        hit = [g for g in graphs if g.dst_type in live]
        count += len(hit)
        live |= {g.src_type for g in hit}
    return count


def drop_work_item(view):
    """A copy of a row view without the edges of its largest work item
    (their rows lose them) and with the work list rebuilt: the planted
    backward fault.  Returns ``(view, (item, its row, edges dropped))``."""
    from repro_torch.kernels.seg_sum import RowEdges, work_list

    sizes = view.items[:, 3] - view.items[:, 2]
    i = int(np.argmax(sizes))
    e0, e1 = int(view.items[i, 2]), int(view.items[i, 3])
    n_rows = view.row_ptr.size - 1
    row_of = np.repeat(np.arange(n_rows), np.diff(view.row_ptr))
    cnt = np.diff(view.row_ptr) - np.bincount(row_of[e0:e1], minlength=n_rows)
    ptr = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    keep = np.ones(view.row_src.size, bool)
    keep[e0:e1] = False
    return (RowEdges(ptr, view.row_src[keep], view.row_slot[keep], work_list(ptr)),
            (i, int(view.items[i, 0]), e1 - e0))


def planted_backward_fault(graphs, metapath: str):
    """``graphs`` with ``metapath``'s packing replaced by a copy whose
    source-major view (the backward's K1 launch) lost its largest work
    item; built here, from outside the package."""
    out, info = [], None
    for g in graphs:
        if g.metapath == metapath:
            pk = dataclasses.replace(g.packed)  # memos (views, uploads) not copied
            pk._src_edges, info = drop_work_item(g.packed.src_edges())
            g = dataclasses.replace(g, packed=pk)
        out.append(g)
    return out, info


def max_leaf_err(a, b) -> tuple:
    """``(max |a - b| over every leaf, the leaf's name)`` of two trees of
    tensors (``b`` may lie on another device)."""
    from repro_torch.train import tree_leaves

    errs = [(x - y.to(x.device)).abs().max().item() if x.numel() else 0.0
            for x, y in zip(tree_leaves(a), tree_leaves(b))]
    i = int(np.argmax(errs))
    return errs[i], leaf_paths(a)[i]


def phase_train(graph, dblp, dev):
    """Phase 3b: HGNN training on the card at full width, held against the
    port's CPU run; returns K1 and K2 launches per train step by model."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.kernels.edge_softmax import edge_softmax_stats
    from repro_torch.kernels.seg_sum import seg_sum_na
    from repro_torch.train import (init_train_state, make_train_step,
                                   propagated_feature_labels,
                                   semi_supervised_masks, tree_leaves, tree_map,
                                   value_and_grad)

    sess = Session(ExecutorSpec(na_executor="banded"))
    cpu = Session(ExecutorSpec(na_executor="banded", device="cpu"), cache=sess.cache)
    feats, feats_cpu = device_features(graph, dev), device_features(graph, "cpu")
    cfgs = {m: HGNNConfig(model=m, hidden=64, num_layers=3, sf_att_dim=64,
                          target_type="P") for m in MODELS}
    compiled = {m: sess.compile(graph, TARGETS, cfgs[m]) for m in MODELS}
    n = compiled["rgcn"].num_target
    labels = propagated_feature_labels(compiled["rgcn"].frontend.semantic, TARGETS,
                                       graph.features, n, device=dev)
    masks = semi_supervised_masks(n, seed=0, device=dev)
    mask_cpu, labels_cpu = masks["train"].cpu(), labels.cpu()
    print(f"train: ACM scale 1.0, {n} P vertices, {int(masks['train'].sum().item())} "
          f"in the train mask, label counts {np.bincount(labels_cpu.numpy()).tolist()}")
    per_step = {}
    for m in MODELS:
        c = compiled[m]
        params = c.init(SEED)

        def loss_fn(graphs, mask, lab):
            return lambda p, f: c.model.execute_loss(p, f, graphs, lab, mask=mask)

        # (a) the gradient gate: every leaf, features included, against the CPU
        loss, grads = value_and_grad(loss_fn(c.graphs, masks["train"], labels),
                                     params, feats)
        c_cpu = cpu.compile(graph, TARGETS, cfgs[m])
        t0 = time.perf_counter()
        loss_c, grads_c = value_and_grad(
            loss_fn(c_cpu.graphs, mask_cpu, labels_cpu),
            tree_map(lambda t: t.cpu(), params), feats_cpu)
        cpu_s = time.perf_counter() - t0
        err, where = max_leaf_err(grads, grads_c)
        err_loss = abs(loss.item() - loss_c.item())
        lost = [p for p, x, y in zip(leaf_paths(grads), tree_leaves(grads),
                                     tree_leaves(grads_c))
                if bool((y != 0).any()) and not bool((x != 0).any())]
        scale = max(x.abs().max().item() for x in tree_leaves(grads_c))
        gate = min(GRAD_ATOL, GRAD_RTOL * scale)
        print(f"train {m} grads: loss {loss.item():.6f}, |card - cpu| loss "
              f"{err_loss:.3e}, leaves {err:.3e} at {where} (gate {gate:.3e}: "
              f"{GRAD_ATOL} and {GRAD_RTOL} x max|grad| {scale:.3e}); leaves "
              f"nonzero on the cpu but zero on the card: {lost}; cpu loss + "
              f"grads {cpu_s:.1f} s")
        require(err_loss <= GRAD_ATOL and err <= gate,
                f"{m}: card gradients disagree with the CPU run")
        require(not lost, f"{m}: leaves lost their gradient on the card: {lost}")

        # (b) a backward fault planted in the same run must break (a)
        bad_graphs, (item, row, dropped) = planted_backward_fault(c.graphs, FAULT_METAPATH)
        _, bad = value_and_grad(loss_fn(bad_graphs, masks["train"], labels), params, feats)
        bad_err, bad_where = max_leaf_err(bad, grads_c)
        print(f"train {m} planted fault ({FAULT_METAPATH}'s source-major view "
              f"without work item {item}, {dropped} edges of source row {row}): "
              f"|card - cpu| {bad_err:.3e} at {bad_where}, {bad_err / gate:.1f}x "
              f"the gate, {bad_err / GRAD_ATOL:.2f}x {GRAD_ATOL}")
        require(bad_err > gate, f"{m}: the planted backward fault passed the gate")

        # (e) K1 and K2 launches in one train step, (f) its time and repeat
        step = make_train_step(c.model, c.graphs)
        # one step in: at step 0 the warmup's learning rate is 0
        state, _ = step(init_train_state(c.model, SEED, device=dev), feats, labels,
                        masks["train"])
        torch.cuda.synchronize()
        seg_sum_na.launches = edge_softmax_stats.launches = 0
        s1, l1 = step(state, feats, labels, masks["train"])
        torch.cuda.synchronize()
        got = {"seg_sum_na": seg_sum_na.launches,
               "edge_softmax_stats": edge_softmax_stats.launches}
        s2, l2 = step(state, feats, labels, masks["train"])
        bwd = na_backward_per_step(c.graphs, cfgs[m].num_layers, "P")
        want = {"seg_sum_na": NA_PER_FORWARD + bwd * (1 if m == "rgcn" else 2),
                "edge_softmax_stats": 0 if m == "rgcn" else NA_PER_FORWARD}
        print(f"train {m} step launches: {got}; the route implies {want} "
              f"({NA_PER_FORWARD} forward NA calls, {bwd} differentiated)")
        require(got == want, f"{m}: K1/K2 launches per train step {got}, want {want}")
        per_step[m] = got
        differ = [p for p, x, y in zip(leaf_paths(s1.params), tree_leaves(s1.params),
                                       tree_leaves(s2.params)) if not torch.equal(x, y)]
        g1 = value_and_grad(loss_fn(c.graphs, masks["train"], labels), params, feats)[1]
        g2 = value_and_grad(loss_fn(c.graphs, masks["train"], labels), params, feats)[1]
        gdiff = [p for p, x, y in zip(leaf_paths(g1), tree_leaves(g1), tree_leaves(g2))
                 if not torch.equal(x, y)]
        print(f"train {m}: two steps from one state bitwise equal: "
              f"{torch.equal(l1, l2) and not differ} ({len(differ)} of "
              f"{len(leaf_paths(s1.params))} parameter leaves differ{': ' + ', '.join(differ[:6]) if differ else ''}); "
              f"two gradient passes: {len(gdiff)} leaves differ"
              f"{': ' + ', '.join(gdiff[:6]) if gdiff else ''}")
        fwd_params = tree_map(lambda t: t.detach().requires_grad_(True), params)
        ms_step = median_ms(lambda: step(state, feats, labels, masks["train"]), reps=10)
        ms_fwd = median_ms(lambda: c.loss(fwd_params, feats, labels, masks["train"]),
                           reps=10)
        ms_fb = median_ms(lambda: value_and_grad(lambda p: c.model.execute_loss(
            p, feats, c.graphs, labels, mask=masks["train"]), params), reps=10)
        rows = prof_call(f"train {m} step", lambda: step(state, feats, labels, masks["train"]))
        na_ms = sum(r[0] for r in rows if "_rows_kernel" in r[2]) / 1e3
        print(f"train {m} step: {ms_step:.3f} ms (CUDA-event median): forward "
              f"{ms_fwd:.3f}, backward {ms_fb - ms_fwd:.3f}, optimizer "
              f"{ms_step - ms_fb:.3f}; K1 + K2 device time in the profiled step "
              f"{na_ms:.3f} ms")

        # (c) fit for 20 epochs, (d) interrupted at epoch 3 and resumed
        out = c.fit(feats, labels, masks, epochs=FIT_EPOCHS, seed=SEED, lr=3e-3)
        losses = out["losses"]
        print(f"train {m} fit: {FIT_EPOCHS} epochs, losses {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}; accuracy train {out['train_acc']:.3f} val "
              f"{out['val_acc']:.3f} test {out['test_acc']:.3f}")
        require(np.isfinite(losses).all(), f"{m}: non-finite loss in fit")
        require(losses[-1] < losses[0], f"{m}: fit did not lower the loss")

        class Interrupt(Exception):
            pass

        def crash_at_3(epoch, _loss):
            if epoch == 3:
                raise Interrupt

        with tempfile.TemporaryDirectory() as ckpt:
            try:
                c.fit(feats, labels, masks, epochs=FIT_EPOCHS, seed=SEED, lr=3e-3,
                      ckpt_dir=ckpt, ckpt_every=2, epoch_callback=crash_at_3)
                require(False, f"{m}: the interrupt did not fire")
            except Interrupt:
                pass
            resumed = []
            again = c.fit(feats, labels, masks, epochs=FIT_EPOCHS, seed=SEED, lr=3e-3,
                          ckpt_dir=ckpt, ckpt_every=2,
                          epoch_callback=lambda e, _l: resumed.append(e))
        pairs = list(zip(tree_leaves(out["state"].params), tree_leaves(again["state"].params)))
        close = all(torch.allclose(b, a, rtol=2e-4, atol=2e-5) for a, b in pairs)
        bitwise = all(torch.equal(a, b) for a, b in pairs)
        worst = max((a - b).abs().max().item() for a, b in pairs)
        print(f"train {m} resume: from epoch {resumed[0]}, final params within "
              f"rtol 2e-4 / atol 2e-5 of the uninterrupted run: {close} (max "
              f"|diff| {worst:.3e}); bitwise equal: {bitwise}")
        require(resumed[0] == 2 and len(again["losses"]) == FIT_EPOCHS,
                f"{m}: resume did not start from the step-2 checkpoint")
        require(close, f"{m}: the resumed fit left the uninterrupted one")

    # rgat on full-width DBLP: times and finiteness
    targets = SGB_WORKLOADS["DBLP"]
    c = sess.compile(dblp, targets, HGNNConfig(model="rgat", hidden=64, num_layers=3,
                                               sf_att_dim=64, target_type="A"))
    n = c.num_target
    lab = propagated_feature_labels(c.frontend.semantic, targets, dblp.features, n,
                                    device=dev)
    msk = semi_supervised_masks(n, seed=0, device=dev)
    times = []
    t_last = [time.perf_counter()]

    def tick(_e, _l):
        now = time.perf_counter()
        times.append((now - t_last[0]) * 1e3)
        t_last[0] = now

    t_last[0] = time.perf_counter()
    out = c.fit(device_features(dblp, dev), lab, msk, epochs=5, seed=SEED, lr=3e-3,
                epoch_callback=tick)
    print(f"train DBLP rgat: 5 epochs, ms per epoch (host clock, each ends in "
          f"a sync) {['%.2f' % t for t in times]}; losses "
          f"{['%.5f' % x for x in out['losses']]}")
    require(np.isfinite(out["losses"]).all(), "DBLP rgat: non-finite loss in fit")
    return per_step


def k1_reading(got, ref) -> float:
    """K1's gate as a ratio: the largest ``|got - ref| / (tol + tol |ref|)``
    over the output (at most 1 passes, as in phase 2)."""
    return ((got - ref).abs() / (K1_TOL + K1_TOL * ref.abs())).max().item()


def percentiles(values) -> str:
    """``p50 / p99`` of a list of microsecond readings."""
    return f"p50 {np.percentile(values, 50):.1f} / p99 {np.percentile(values, 99):.1f} us"


def k1_over_slice(sub, compiled, label: str, dev) -> dict:
    """K1 over each semantic graph's sliced packing of one extraction: the
    gate against ``seg_sum_plain`` on the same slice, a planted fault (the
    slice's row view without its largest work item) read against the same
    gate, and event medians beside K1 over the full packing."""
    from repro_torch.kernels.seg_sum import seg_sum_na, seg_sum_plain

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows, planted = [], 0
    for g, dg in zip(compiled.graphs, sub.arrays["graphs"]):
        pk = dg["packed"]
        h = torch.randn(pk.num_src, D, device=dev, generator=gen)
        got, again = seg_sum_na(pk, h), seg_sum_na(pk, h)
        ref = seg_sum_plain(pk, h)
        torch.cuda.synchronize()
        reading = k1_reading(got, ref)
        err = (got - ref).abs().max().item()
        faulted = dataclasses.replace(pk)  # memos (views, uploads) not copied
        faulted._row_edges, info = drop_work_item(pk.row_edges())
        fault = None
        if info[2]:
            fault = k1_reading(seg_sum_na(faulted, h), ref)
            planted += 1
        db = pk.device_blocked(dev)

        def library():
            return torch.zeros(pk.num_dst, D, device=dev).index_add_(
                0, db["edge_dst"], h[db["edge_src"]])

        require(k1_reading(library(), ref) <= 1.0, f"K1 library yardstick on {label} "
                f"{g.metapath}'s slice disagrees")
        full = g.packed
        h_full = torch.randn(full.num_src, D, device=dev, generator=gen)
        e, tiles = pk.num_edges, pk.num_dst_tiles
        nbytes = (e * (2 + 2 + 4) + pk.num_src * D * 4 + pk.num_dst * D * 4
                  + pk.num_blocks * 12 + (tiles + 1) * 4)
        t_bound, by = bound(nbytes, 2.0 * e * D)
        row = {
            "metapath": g.metapath, "edges": e, "blocks": pk.num_blocks, "rows": pk.num_dst,
            "full_edges": full.num_edges, "max_abs_err": err, "reading": reading,
            "fault_reading": fault, "fault_item": info,
            "bitwise_repeat": torch.equal(got, again),
            "ms": median_ms(lambda: seg_sum_na(pk, h)),
            "plain_ms": median_ms(lambda: seg_sum_plain(pk, h), reps=10),
            "library_ms": median_ms(library),
            "device_ms": device_ms(f"K1 {label} {g.metapath} slice", lambda: seg_sum_na(pk, h)),
            "queued_ms": queued_ms(lambda: seg_sum_na(pk, h)),
            "full_ms": median_ms(lambda: seg_sum_na(full, h_full)),
            "full_queued_ms": queued_ms(lambda: seg_sum_na(full, h_full)),
            "full_device_ms": device_ms(f"K1 {label} {g.metapath} full packing",
                                        lambda: seg_sum_na(full, h_full)),
            "bound_ms": t_bound, "bound_by": by, "bytes": nbytes, "work": work_shape(
                pk.row_edges()),
        }
        print(f"K1 over {label} {g.metapath}'s slice: {e} of {full.num_edges} edges, "
              f"{pk.num_blocks} blocks, {pk.num_dst} rows; max|K1 - plain| {err:.3e}, "
              f"gate reading {reading:.3e} (passes at <= 1), bitwise repeat "
              f"{row['bitwise_repeat']}; planted fault (work item {info[0]}, row "
              f"{info[1]}, {info[2]} edges dropped) reads "
              f"{'not planted' if fault is None else f'{fault:.3e}'}; kernel "
              f"{row['ms']:.4f} ms (queue-full {row['queued_ms']:.4f}, device "
              f"{_ms(row['device_ms'])}) against {row['full_ms']:.4f} ms over the full "
              f"packing (queue-full {row['full_queued_ms']:.4f}, device "
              f"{_ms(row['full_device_ms'])}); plain {row['plain_ms']:.4f} ms, "
              f"index_add_ {row['library_ms']:.4f} ms, bound {t_bound:.6f} ms ({by})")
        require(reading <= 1.0, f"K1 over {label} {g.metapath}'s slice disagrees with "
                "the plain version")
        require(row["bitwise_repeat"], f"K1 over {label} {g.metapath}'s slice not repeatable")
        require(fault is None or fault > 1.0, f"the planted fault in {label} "
                f"{g.metapath}'s slice reads {fault}, inside the gate")
        rows.append(row)
    require(planted > 0, f"no fault could be planted in {label}'s slices (all empty)")
    return rows


def k2_over_slice(sub, compiled, label: str, dev) -> list:
    """K2 over each semantic graph's sliced packing of one extraction,
    random logits: ``m`` bitwise and ``s`` within ``K2_RTOL`` of
    ``softmax_stats_plain``, bitwise repeatable, event and queue-full
    medians beside the plain version and the library yardstick."""
    from repro_torch.kernels.edge_softmax import (NEG, edge_softmax_stats,
                                                  softmax_stats_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for g, dg in zip(compiled.graphs, sub.arrays["graphs"]):
        pk = dg["packed"]
        logits = torch.randn(pk.src_local.shape, device=dev, generator=gen) * 3
        (m, s), (m2, s2) = edge_softmax_stats(pk, logits), edge_softmax_stats(pk, logits)
        mr, sr = softmax_stats_plain(pk, logits)
        torch.cuda.synchronize()
        es_rel = ((s - sr).abs() / sr.abs().clamp(min=1.0)).max().item()
        db = pk.device_blocked(dev)
        dst_e, l_e = db["edge_dst"], logits[db["edge_blk"], db["edge_slot"]]

        def library():
            mm = torch.full((pk.num_dst,), NEG, device=dev).scatter_reduce_(
                0, dst_e, l_e, "amax")
            return mm, torch.zeros(pk.num_dst, device=dev).index_add_(
                0, dst_e, torch.exp(l_e - mm[dst_e]))

        e, nb = pk.num_edges, pk.num_blocks
        nbytes = e * (2 + 4) + nb * 8 + (pk.num_dst_tiles + 1) * 4 + pk.num_dst * 8
        t_bound, by = bound(nbytes, 6.0 * e)
        row = {"metapath": g.metapath, "edges": e, "blocks": nb, "rows": pk.num_dst,
               "max_abs_err": max((m - mr).abs().max().item(), (s - sr).abs().max().item()),
               "s_rel_err": es_rel, "m_bitwise": torch.equal(m, mr),
               "bitwise_repeat": torch.equal(m, m2) and torch.equal(s, s2),
               "ms": median_ms(lambda: edge_softmax_stats(pk, logits)),
               "queued_ms": queued_ms(lambda: edge_softmax_stats(pk, logits)),
               "plain_ms": median_ms(lambda: softmax_stats_plain(pk, logits), reps=10),
               "library_ms": median_ms(library), "bound_ms": t_bound, "bound_by": by,
               "bytes": nbytes}
        print(f"K2 over {label} {g.metapath}'s slice: {e} edges, {nb} blocks; m bitwise "
              f"{row['m_bitwise']}, s relative error {es_rel:.3e} (tolerance {K2_RTOL}), "
              f"bitwise repeat {row['bitwise_repeat']}; kernel {row['ms']:.4f} ms "
              f"(queue-full {row['queued_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
              f"scatter_reduce + index_add_ {row['library_ms']:.4f} ms, bound "
              f"{t_bound:.6f} ms ({by})")
        require(row["m_bitwise"] and es_rel <= K2_RTOL,
                f"K2 over {label} {g.metapath}'s slice disagrees with the plain version")
        require(row["bitwise_repeat"], f"K2 over {label} {g.metapath}'s slice not repeatable")
        rows.append(row)
    return rows


def phase_serving(graph, dev, card: str):
    """Phase 3c: ``HGNNServeEngine`` on the card at full width, two graphs and
    three tenants (ACM rgat head-only; IMDB rgcn and rgat over k-hop
    dependency closures), a seeded burst served by ``engine.run()``; held
    against the card's own forward and the same requests served on the CPU.
    Returns the kernels line's row for K1 over the sliced packings, the
    K1 launches of one dependency forward and the IMDB tenants' depth."""
    from repro_torch.api import ExecutorSpec, ServePolicy, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.hetero import make_dataset
    from repro_torch.kernels.edge_softmax import edge_softmax_stats
    from repro_torch.kernels.seg_sum import seg_sum_na
    from repro_torch.serve import HGNNRequest, HGNNServeEngine

    imdb = make_dataset("IMDB", seed=SEED, scale=1.0)
    graphs = {"acm": graph, "imdb": imdb}
    targets = {"acm": TARGETS, "imdb": IMDB_TARGETS}
    rng = np.random.default_rng(SEED)
    n_target = {"acm": graph.num_vertices["P"], "imdb": imdb.num_vertices["M"]}
    names = {"acm-rgat": ("acm", "rgat", "P", "head"),
             "imdb-rgcn": ("imdb", "rgcn", "M", "dependency"),
             "imdb-rgat": ("imdb", "rgat", "M", "dependency")}
    burst = {name: [rng.integers(0, n_target[ds], size=int(rng.integers(4, 17)))
                    for _ in range(SERVE_PER_TENANT)]
             for name, (ds, *_rest) in names.items()}
    per_wave = SERVE_PER_TENANT // SERVE_WAVES

    def cfg(model, tt, layers):
        return HGNNConfig(model=model, hidden=64, num_layers=layers, sf_att_dim=64,
                          target_type=tt)

    sess = Session(ExecutorSpec(na_executor="banded", device=str(dev)))
    # IMDB's closure coverage at three layers for the id sets the burst
    # uses: each wave's union (about one served group) and the whole burst
    layers = 3
    probe = sess.compile(imdb, IMDB_TARGETS, cfg("rgcn", "M", layers))
    cov = []
    for name in ("imdb-rgcn", "imdb-rgat"):
        ids = burst[name]
        cov += [probe.dependency_subset(np.unique(np.concatenate(
            ids[w * per_wave:(w + 1) * per_wave]))).coverage for w in range(SERVE_WAVES)]
    whole = probe.dependency_subset(np.unique(np.concatenate(
        burst["imdb-rgcn"] + burst["imdb-rgat"]))).coverage
    print(f"serve: IMDB closure coverage at {layers} layers, wave unions "
          f"{min(cov):.4f}-{max(cov):.4f}, the whole burst's union {whole:.4f} "
          f"(dependency_threshold {DEP_COVERAGE}; M and A only are reachable, "
          f"{(imdb.num_vertices['M'] + imdb.num_vertices['A']) / sum(imdb.num_vertices.values()):.4f} "
          "of all vertices)")
    if max(cov) > DEP_COVERAGE:
        layers = 2
        print(f"serve: a wave union's closure covers more than {DEP_COVERAGE} at 3 "
              "layers; the IMDB tenants take num_layers=2")

    feats = {ds: device_features(g, dev) for ds, g in graphs.items()}
    eng = HGNNServeEngine(session=sess, policy=ServePolicy(
        batch_window_ms=SERVE_WINDOW_MS, dependency_threshold=DEP_COVERAGE))
    handles, params, cfgs = {}, {}, {}
    t0 = time.perf_counter()
    for name, (ds, model, tt, mode) in names.items():
        cfgs[name] = cfg(model, tt, 3 if ds == "acm" else layers)
        params[name] = sess.compile(graphs[ds], targets[ds], cfgs[name]).init(SEED)
        handles[name] = eng.register(name, graphs[ds], targets[ds], cfgs[name],
                                     params=params[name], features=feats[ds],
                                     subset_mode=mode)
    print(f"serve: registered {sorted(handles)} in {(time.perf_counter() - t0) * 1e3:.1f} ms "
          "(frontend, compile and one warm forward each)")
    # the dependency tenants calibrate their fusion betas once, on a warm-up
    # request outside the burst (serving pays it at registration)
    for name in ("imdb-rgcn", "imdb-rgat"):
        handles[name].compiled.forward_subset(params[name], feats["imdb"],
                                              np.arange(8), mode="dependency")
    torch.cuda.synchronize()

    rid, reqs, futs = 0, {}, []
    seg_sum_na.launches = 0
    edge_softmax_stats.launches = 0
    eng.run()
    try:
        t0 = time.perf_counter()
        for w in range(SERVE_WAVES):
            for name in names:
                wave = []
                for ids in burst[name][w * per_wave:(w + 1) * per_wave]:
                    reqs[rid] = (name, ids)
                    wave.append(HGNNRequest(rid, name, nodes=ids))
                    rid += 1
                futs += eng.submit(wave)
            time.sleep(SERVE_WAVE_GAP_S)
        responses = [f.result(timeout=300) for f in futs]
        t_burst = time.perf_counter() - t0
        whole_reqs = []
        for name in names:
            for _ in range(SERVE_WHOLE_GRAPH):
                reqs[rid] = (name, None)
                whole_reqs.append(HGNNRequest(rid, name))
                rid += 1
        responses += [f.result(timeout=300) for f in eng.submit(whole_reqs)]
    finally:
        eng.stop()
    torch.cuda.synchronize()
    launches = {"seg_sum_na": seg_sum_na.launches,
                "edge_softmax_stats": edge_softmax_stats.launches}
    st = eng.stats()
    print(f"serve: {len(responses)} responses; burst of {len(futs)} requests in "
          f"{t_burst * 1e3:.1f} ms, {len(futs) / t_burst:.1f} requests/s (a smoke reading, "
          f"not a load; {card}); forwards full {st['forwards_full']}, subset "
          f"{st['forwards_subset']}, dependency {st['forwards_dependency']}, batching "
          f"factor {st['batching_factor']:.2f}, window timeouts {st['window_timeouts']}, "
          f"early closes {st['early_closes']}; launches over the served run {launches}")
    modes = sorted({r.mode for r in responses})
    for mode in modes:
        rs = [r for r in responses if r.mode == mode]
        print(f"serve {mode}: {len(rs)} responses; latency "
              f"{percentiles([r.latency_us for r in rs])}, queue "
              f"{percentiles([r.queue_us for r in rs])}, compute "
              f"{percentiles([r.compute_us for r in rs])} ({card})")
    require(modes == ["dependency", "full", "subset"], f"served modes {modes}")
    require(sorted(r.rid for r in responses) == list(range(rid)), "a request went unanswered")
    tenant_faults = {n: (t["failures"], t["retries"], t["breaker_fastfails"], t["breaker"])
                     for n, t in st["tenants"].items()}
    print(f"serve: failures, retries, breaker fast-fails, breaker by tenant {tenant_faults}")
    require(st["retries"] == 0 and st["breaker_fastfails"] == 0
            and st["requests_deadline_exceeded"] == 0
            and all(t[:3] == (0, 0, 0) and t[3] == "closed" for t in tenant_faults.values()),
            "the sound serving run had failures, retries or breaker trips")

    # served rows against the card's own forward
    full = {name: handles[name].compiled.forward(params[name], feats[names[name][0]])
            .cpu().numpy() for name in names}
    worst = {"subset": 0.0, "full": 0.0, "dependency": 0.0}
    for r in responses:
        name, ids = reqs[r.rid]
        want = full[name] if ids is None else full[name][ids]
        if r.mode == "dependency":
            worst["dependency"] = max(worst["dependency"], float(np.abs(r.logits - want).max()))
        else:
            require(np.array_equal(r.logits, want),
                    f"request {r.rid} ({name}, {r.mode}) is not bitwise the card's forward rows")
            require(r.predictions.shape == (want.shape[0],), f"request {r.rid}: predictions")
        require(np.isfinite(r.logits).all(), f"request {r.rid}: non-finite logits")
    print(f"serve: subset and full rows bitwise equal to the card's forward; dependency "
          f"rows max|served - forward| {worst['dependency']:.3e} (tolerance {LOGIT_ATOL})")
    require(worst["dependency"] <= LOGIT_ATOL, "dependency rows disagree with the forward")

    # the same requests served on the CPU (the plain versions)
    cpu_sess = Session(ExecutorSpec(na_executor="banded", device="cpu"), cache=sess.cache)
    ceng = HGNNServeEngine(session=cpu_sess, policy=ServePolicy(
        dependency_threshold=DEP_COVERAGE))
    for name, (ds, _, _, mode) in names.items():
        ceng.register(name, graphs[ds], targets[ds], cfgs[name], seed=SEED, warm=False,
                      subset_mode=mode)
    t0 = time.perf_counter()
    cpu_resp = {}
    for batch in ([r for r in sorted(reqs) if reqs[r][1] is not None],
                  [r for r in sorted(reqs) if reqs[r][1] is None]):
        cf = ceng.submit([HGNNRequest(r, reqs[r][0], nodes=reqs[r][1]) for r in batch])
        ceng.step()
        cpu_resp.update({f.result(timeout=600).rid: f.result(timeout=600) for f in cf})
    cpu_err = max(float(np.abs(r.logits - cpu_resp[r.rid].logits).max()) for r in responses)
    print(f"serve: the same {len(cpu_resp)} requests on the CPU in "
          f"{time.perf_counter() - t0:.1f} s, modes {sorted({r.mode for r in cpu_resp.values()})}; "
          f"max|card - cpu| {cpu_err:.3e} (tolerance {LOGIT_ATOL})")
    require(cpu_err <= LOGIT_ATOL, "served card rows disagree with the CPU's")

    # K1 and K2 launches of one dependency forward, its rows, and a second
    # forward bit for bit (no float atomics on the dependency path); the
    # bitwise check must fire on a copy of the second nudged by one ulp
    fresh = np.unique(np.random.default_rng(SEED + 1).integers(0, n_target["imdb"], size=64))
    dep_launches, dep_k2 = {}, {}
    for name in ("imdb-rgcn", "imdb-rgat"):
        c = handles[name].compiled
        c.dependency_subset(fresh)  # extraction and upload outside the count
        seg_sum_na.launches = 0
        edge_softmax_stats.launches = 0
        out = c.forward_subset(params[name], feats["imdb"], fresh, mode="dependency")
        torch.cuda.synchronize()
        want_k1 = c.cfg.num_layers * len(c.graphs)
        want_k2 = 0 if c.cfg.model == "rgcn" else want_k1
        dep_launches[name] = seg_sum_na.launches
        dep_k2[name] = edge_softmax_stats.launches
        err = float(np.abs(out.cpu().numpy() - full[name][fresh]).max())
        again = c.forward_subset(params[name], feats["imdb"], fresh, mode="dependency")
        nudged = again.clone()
        nudged[0, 0] = torch.nextafter(nudged[0, 0], torch.tensor(np.inf, device=dev))
        fired = not torch.equal(out, nudged)
        print(f"serve {name}: one dependency forward over {fresh.size} ids launched K1 "
              f"{dep_launches[name]} times (layers x semantic graphs = {want_k1}), K2 "
              f"{dep_k2[name]} (want {want_k2}); max|rows - forward| {err:.3e}; a second "
              f"forward bitwise equal {torch.equal(out, again)}, the check on a one-ulp "
              f"nudge fires {fired}")
        require(dep_launches[name] == want_k1 and dep_k2[name] == want_k2,
                f"{name}: a dependency forward launched K1 {dep_launches[name]} and K2 "
                f"{dep_k2[name]} times")
        require(err <= LOGIT_ATOL, f"{name}: dependency rows disagree with the forward")
        require(torch.equal(out, again), f"{name}: dependency rows do not repeat bit for bit")
        require(fired, f"{name}: the bitwise check missed a one-ulp nudge")

    # the counters stay flat across resubmissions in one bucket
    c_acm = handles["acm-rgat"].compiled
    ids_a = np.arange(40, 52)
    c_acm.forward_subset(params["acm-rgat"], feats["acm"], ids_a)
    flat = [c_acm.subset_traces]
    c_acm.forward_subset(params["acm-rgat"], feats["acm"], ids_a + 100)
    flat.append(c_acm.subset_traces)
    c = handles["imdb-rgcn"].compiled
    c.forward_subset(params["imdb-rgcn"], feats["imdb"], fresh, mode="dependency")
    dflat = [c.dependency_traces]
    c.forward_subset(params["imdb-rgcn"], feats["imdb"], fresh[::-1], mode="dependency")
    dflat.append(c.dependency_traces)
    print(f"serve: subset_traces {flat} and dependency_traces {dflat} across "
          "resubmissions in one bucket")
    require(flat[0] == flat[1] and dflat[0] == dflat[1], "a bucket counter moved")

    # the extractor's host time, cold (numpy, then the upload)
    ext_ms, cover = [], []
    erng = np.random.default_rng(SEED + 2)
    for _ in range(5):
        ids = np.unique(erng.integers(0, n_target["imdb"], size=80))
        t0 = time.perf_counter()
        sub = c.dependency_subset(ids)
        ext_ms.append((time.perf_counter() - t0) * 1e3)
        cover.append(sub.coverage)
    print(f"serve: extractor host ms a cold extraction (80 ids, numpy then upload) "
          f"{['%.2f' % t for t in ext_ms]}, coverage {['%.3f' % x for x in cover]} ({card})")

    # K1 over one extraction's sliced packings: one request's ids
    one = np.unique(burst["imdb-rgcn"][0])
    t0 = time.perf_counter()
    sub = c.dependency_subset(one)
    print(f"serve: extraction of one request's {one.size} ids "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms, coverage {sub.coverage:.4f}")
    slice_rows = k1_over_slice(sub, c, "IMDB", dev)
    e = sum(r["edges"] for r in slice_rows)
    t_bytes = sum(r["bytes"] for r in slice_rows) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * e * D / FP32_FLOP_PER_S * 1e3
    row = {
        "name": "seg_sum_na (dependency slice)", "route": "cuda",
        "source": "src/repro_torch/csrc/na_kernels.cu",
        "replaces": "src/repro/kernels/seg_sum.py:516",
        "launches": launches["seg_sum_na"],
        "launches_dependency_forward": dep_launches,
        "max_abs_err": max(r["max_abs_err"] for r in slice_rows),
        "ms": sum(r["ms"] for r in slice_rows),
        "plain_ms": sum(r["plain_ms"] for r in slice_rows),
        "bound_ms": sum(r["bound_ms"] for r in slice_rows),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["library_ms"] for r in slice_rows),
        "queued_ms": sum(r["queued_ms"] for r in slice_rows),
        "full_packing_ms": sum(r["full_ms"] for r in slice_rows),
        "full_packing_queued_ms": sum(r["full_queued_ms"] for r in slice_rows),
        "fault_reading": min(r["fault_reading"] for r in slice_rows
                             if r["fault_reading"] is not None),
        "shape": f"IMDB scale 1.0, one request's {one.size}-id extraction over "
                 f"{len(slice_rows)} semantic graphs (times summed), D={D}",
        "slices": slice_rows, "extractor_host_ms": ext_ms,
    }
    require(row["launches"] > 0, "K1 never launched on the serving path")
    k2_rows = k2_over_slice(handles["imdb-rgat"].compiled.dependency_subset(one),
                            handles["imdb-rgat"].compiled, "IMDB", dev)
    e = sum(r["edges"] for r in k2_rows)
    t_bytes = sum(r["bytes"] for r in k2_rows) / HBM_BYTES_PER_S * 1e3
    t_ops = 6.0 * e / FP32_FLOP_PER_S * 1e3
    k2_row = {
        "name": "edge_softmax_stats (dependency slice)", "route": "cuda",
        "source": "src/repro_torch/csrc/na_kernels.cu",
        "replaces": "src/repro/kernels/edge_softmax.py:32",
        "launches": launches["edge_softmax_stats"],
        "launches_dependency_forward": dep_k2,
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "ms": sum(r["ms"] for r in k2_rows),
        "plain_ms": sum(r["plain_ms"] for r in k2_rows),
        "bound_ms": sum(r["bound_ms"] for r in k2_rows),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["library_ms"] for r in k2_rows),
        "queued_ms": sum(r["queued_ms"] for r in k2_rows),
        "shape": f"IMDB scale 1.0, one request's {one.size}-id extraction over "
                 f"{len(k2_rows)} semantic graphs (times summed)",
        "slices": k2_rows,
    }
    require(k2_row["launches"] > 0 and dep_k2["imdb-rgat"] > 0,
            "K2 never launched on the serving path's dependency forwards")
    return [row, k2_row], dep_launches, layers


def graph_deltas(graph) -> dict:
    """Phase 3d's three seeded deltas on ACM: (a) ``insert`` 64 PS edges
    (touches PSP), (b) ``remove`` 64 existing PA edges (touches APA and
    PAP), (c) ``grow`` P by 16 vertices, each with 3 PA edges (touches every
    target metapath)."""
    from repro_torch.hetero import GraphDelta

    rng = np.random.default_rng(SEED)
    ps, pa = graph.relations["PS"], graph.relations["PA"]
    take = rng.choice(pa.num_edges, size=DELTA_EDGES, replace=False)
    n_p = graph.num_vertices["P"]
    grow_src = np.repeat(np.arange(n_p, n_p + DELTA_GROW), DELTA_GROW_EDGES)
    return {
        "insert": GraphDelta.insert("PS", rng.integers(0, ps.num_src, DELTA_EDGES),
                                    rng.integers(0, ps.num_dst, DELTA_EDGES)),
        "remove": GraphDelta.remove("PA", pa.src[take], pa.dst[take]),
        "grow": GraphDelta(add_edges={"PA": (grow_src, rng.integers(
            0, graph.num_vertices["A"], grow_src.size))}, add_vertices={"P": DELTA_GROW}),
    }


def tp_delta(graph, seed: int = SEED):
    """An off-metapath delta: 3 TP edges, which no target metapath crosses."""
    from repro_torch.hetero import GraphDelta

    rng = np.random.default_rng(seed)
    tp = graph.relations["TP"]
    return GraphDelta.insert("TP", rng.integers(0, tp.num_src, 3),
                             rng.integers(0, tp.num_dst, 3))


def packings_equal(a, b) -> list:
    """Names of the arrays and views in which two packings differ (empty
    when they are bitwise equal): every block array, the edge map, the row
    view, the source-major view and their work lists."""
    bad = [f for f in PACKED_FIELDS
           if not (np.asarray(getattr(a, f)).dtype == np.asarray(getattr(b, f)).dtype
                   and np.array_equal(getattr(a, f), getattr(b, f)))]
    if (a.num_src, a.num_dst) != (b.num_src, b.num_dst):
        bad.append("shape")
    for view in ("row_edges", "src_edges"):
        for key, x, y in zip(("row_ptr", "row_src", "row_slot", "items"),
                             getattr(a, view)(), getattr(b, view)()):
            if not (x.dtype == y.dtype and np.array_equal(x, y)):
                bad.append(f"{view}.{key}")
    return bad


def stale_view_successor(successor, predecessor, metapath: str, dev):
    """The planted fault: ``successor``'s graphs with ``metapath``'s spliced
    packing handed the predecessor's memoized row view and its device copy
    (the rest of the upload fresh), as a successor that kept a view built
    for the pre-delta stream would read it.  Checked first to stay inside
    every buffer K1 and K2 index, so the fault is wrong sums, not a wrong
    address."""
    out = []
    for g, old in zip(successor.graphs, predecessor.graphs):
        if g.metapath == metapath:
            pk = dataclasses.replace(g.packed)  # memos (views, uploads) not copied
            rows = old.packed.row_edges()
            require(rows.row_ptr.size == pk.num_dst + 1
                    and int(rows.row_src.max()) < pk.num_src
                    and int(rows.row_slot.max()) < pk.num_blocks * pk.edge_block,
                    f"the stale {metapath} view would index outside the spliced packing")
            fresh = pk.device_blocked(dev)
            stale = old.packed.device_blocked(dev)
            pk._row_edges = rows
            pk._device = {str(torch.device(dev)): dict(
                fresh, **{k: stale[k] for k in ("row_ptr", "row_src", "row_slot", "items")})}
            g = dataclasses.replace(g, packed=pk)
        out.append(g)
    return out


def na_over_spliced(spliced, cold, dev) -> list:
    """K1 and K2 over delta (a)'s spliced PSP packing: each against its
    plain version within its phase 2 gate, bitwise equal to the same kernel
    over the cold packing of the mutated graph, and event medians and
    queue-full times over both, with the plain version, the library
    yardstick and the bound.  Returns the ``kernels`` line's two rows."""
    from repro_torch.kernels.edge_softmax import (NEG, edge_softmax_stats,
                                                  softmax_stats_plain)
    from repro_torch.kernels.seg_sum import seg_sum_na, seg_sum_plain

    nb, eb = spliced.src_local.shape
    e, tiles = spliced.num_edges, spliced.num_dst_tiles
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = torch.randn(spliced.num_src, D, device=dev, generator=gen)
    w = torch.rand(nb, eb, device=dev, generator=gen)
    logits = torch.randn(nb, eb, device=dev, generator=gen) * 3
    db = spliced.device_blocked(dev)
    src_e, dst_e = db["edge_src"], db["edge_dst"]
    w_e, l_e = w[db["edge_blk"], db["edge_slot"]], logits[db["edge_blk"], db["edge_slot"]]
    shape = f"ACM PSP after delta (a), spliced: E={e} nb={nb} tiles={tiles} D={D}"

    got, ref = seg_sum_na(spliced, h, w), seg_sum_plain(spliced, h, w)
    on_cold = seg_sum_na(cold, h, w)
    torch.cuda.synchronize()
    k1_err = (got - ref).abs().max().item()
    require(k1_reading(got, ref) <= 1.0, "K1 over the spliced packing disagrees with plain")
    require(torch.equal(got, on_cold), "K1 over the spliced packing is not bitwise K1 "
            "over the cold packing")

    def k1_library():
        return torch.zeros(spliced.num_dst, D, device=dev).index_add_(
            0, dst_e, h[src_e] * w_e[:, None])

    require(k1_reading(k1_library(), ref) <= 1.0, "K1 library yardstick disagrees")
    k1_bytes = (e * (2 + 2 + 4) + spliced.num_src * D * 4 + spliced.num_dst * D * 4
                + nb * 12 + (tiles + 1) * 4)
    k1_bound, k1_by = bound(k1_bytes, 2.0 * e * D)
    k1 = {
        "name": "seg_sum_na (spliced packing)", "route": "cuda",
        "source": "src/repro_torch/csrc/na_kernels.cu",
        "replaces": "src/repro/kernels/seg_sum.py:516",
        "max_abs_err": k1_err,
        "ms": median_ms(lambda: seg_sum_na(spliced, h, w)),
        "queued_ms": queued_ms(lambda: seg_sum_na(spliced, h, w)),
        "cold_ms": median_ms(lambda: seg_sum_na(cold, h, w)),
        "cold_queued_ms": queued_ms(lambda: seg_sum_na(cold, h, w)),
        "plain_ms": median_ms(lambda: seg_sum_plain(spliced, h, w), reps=10),
        "library_ms": median_ms(k1_library), "bound_ms": k1_bound, "bound_by": k1_by,
        "bytes": k1_bytes, "bitwise_cold": True, "shape": shape,
    }

    m, s = edge_softmax_stats(spliced, logits)
    mr, sr = softmax_stats_plain(spliced, logits)
    mc, sc = edge_softmax_stats(cold, logits)
    torch.cuda.synchronize()
    s_rel = ((s - sr).abs() / sr.abs().clamp(min=1.0)).max().item()
    require(torch.equal(m, mr) and s_rel <= K2_RTOL,
            "K2 over the spliced packing disagrees with plain")
    require(torch.equal(m, mc) and torch.equal(s, sc), "K2 over the spliced packing is "
            "not bitwise K2 over the cold packing")

    def k2_library():
        mx = torch.full((spliced.num_dst,), NEG, device=dev).scatter_reduce_(
            0, dst_e, l_e, "amax")
        return mx, torch.zeros(spliced.num_dst, device=dev).index_add_(
            0, dst_e, torch.exp(l_e - mx[dst_e]))

    require(((k2_library()[1] - sr).abs() / sr.abs().clamp(min=1.0)).max().item()
            <= K2_RTOL, "K2 library yardstick disagrees")
    k2_bytes = e * (2 + 4) + nb * 8 + (tiles + 1) * 4 + spliced.num_dst * 8
    k2_bound, k2_by = bound(k2_bytes, 6.0 * e)
    k2 = {
        "name": "edge_softmax_stats (spliced packing)", "route": "cuda",
        "source": "src/repro_torch/csrc/na_kernels.cu",
        "replaces": "src/repro/kernels/edge_softmax.py:32",
        "max_abs_err": max((m - mr).abs().max().item(), (s - sr).abs().max().item()),
        "ms": median_ms(lambda: edge_softmax_stats(spliced, logits)),
        "queued_ms": queued_ms(lambda: edge_softmax_stats(spliced, logits)),
        "cold_ms": median_ms(lambda: edge_softmax_stats(cold, logits)),
        "cold_queued_ms": queued_ms(lambda: edge_softmax_stats(cold, logits)),
        "plain_ms": median_ms(lambda: softmax_stats_plain(spliced, logits), reps=10),
        "library_ms": median_ms(k2_library), "bound_ms": k2_bound, "bound_by": k2_by,
        "bytes": k2_bytes, "bitwise_cold": True, "shape": shape,
    }
    for k in (k1, k2):
        print(f"{k['name']}: kernel {k['ms']:.4f} ms (queue-full {k['queued_ms']:.4f}) "
              f"against {k['cold_ms']:.4f} ms (queue-full {k['cold_queued_ms']:.4f}) over "
              f"the cold packing, bitwise equal to it; max|kernel - plain| "
              f"{k['max_abs_err']:.3e}; plain {k['plain_ms']:.4f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.6f} ms ({k['bound_by']}); "
              f"{shape}")
    return [k1, k2]


def phase_deltas(graph, imdb_layers: int, dev, card: str):
    """Phase 3d: graph deltas on the card.  For each of ``graph_deltas``,
    ``Session.compile_delta`` on a warm session against a cold compile of
    the mutated graph (packings, views, forwards, launches), a planted
    stale-view fault, then ``swap_graph`` twice while an engine serves a
    burst.  Returns the ``kernels`` line's rows for K1 and K2 over the
    spliced PSP packing of delta (a)."""
    from repro_torch.api import ExecutorSpec, ServePolicy, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.hetero import make_dataset
    from repro_torch.kernels.edge_softmax import edge_softmax_stats
    from repro_torch.kernels.seg_sum import seg_sum_na
    from repro_torch.serve import HGNNRequest, HGNNServeEngine

    def cfg(model, tt="P", layers=3):
        return HGNNConfig(model=model, hidden=64, num_layers=layers, sf_att_dim=64,
                          target_type=tt)

    deltas = graph_deltas(graph)
    feats = device_features(graph, dev)
    ext_ids = [np.unique(np.random.default_rng(SEED + i).integers(
        0, graph.num_vertices["P"], size=n)) for i, n in enumerate((4, 8, 16))]
    launches = {"seg_sum_na": 0, "edge_softmax_stats": 0}
    rows = None
    for name, delta in deltas.items():
        sess = Session(ExecutorSpec(na_executor="banded", device=str(dev)))
        pred = {m: sess.compile(graph, TARGETS, cfg(m)) for m in DELTA_MODELS}
        params = {m: pred[m].init(SEED) for m in DELTA_MODELS}
        for m in DELTA_MODELS:
            pred[m].forward(params[m], feats)  # the predecessors' views go up
        for ids in ext_ids:
            pred["rgcn"].dependency_subset(ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        succ, g2, dres = {}, None, None
        succ["rgat"], g2, dres = sess.compile_delta(pred["rgat"], graph, delta)
        t_delta = time.perf_counter() - t0
        succ["rgcn"], _, _ = sess.compile_delta(pred["rgcn"], graph, delta)
        adopted = len(succ["rgcn"]._extractor._memo)
        cold_sess = Session(ExecutorSpec(na_executor="banded", device=str(dev)))
        cold = {m: cold_sess.compile(g2, TARGETS, cfg(m)) for m in DELTA_MODELS}
        print(f"delta ({name}): touched {dres.touched}, {dres.migrated} cache entries "
              f"migrated, SGB {dres.result.sgb.device_stats if dres.result.sgb else 'cached'}; "
              f"compile_delta {t_delta * 1e3:.1f} ms; apply_delta stages "
              f"{ {k: round(v * 1e3, 3) for k, v in dres.result.timings.items()} } ms "
              f"against a cold FrontendPipeline.run of the mutated graph "
              f"{ {k: round(v * 1e3, 3) for k, v in cold['rgat'].frontend.timings.items()} } "
              f"ms; splice (reused, total) blocks {dres.spliced}; the extractor adopted "
              f"{adopted} of {len(ext_ids)} entries ({card})")
        for mp in dres.spliced:
            pk = next(g.packed for g in succ["rgat"].graphs if g.metapath == mp)
            copy = dataclasses.replace(pk)  # memos not copied: built anew below
            t0 = time.perf_counter()
            copy.row_edges()
            t_rows = time.perf_counter() - t0
            t0 = time.perf_counter()
            copy.device_blocked(dev)
            torch.cuda.synchronize()
            print(f"delta ({name}) {mp}: row view and work list rebuilt in "
                  f"{t_rows * 1e3:.2f} ms of host time, uploaded (with the edge map and "
                  f"tile arrays) in {(time.perf_counter() - t0) * 1e3:.2f} ms ({card})")
        feats2 = device_features(g2, dev) if delta.add_vertices else feats
        for m in DELTA_MODELS:
            seg_sum_na.launches = 0
            edge_softmax_stats.launches = 0
            t0 = time.perf_counter()
            first = succ[m].forward(params[m], feats2)
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            again = succ[m].forward(params[m], feats2)
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t0
            got = (seg_sum_na.launches, edge_softmax_stats.launches)
            launches["seg_sum_na"] += got[0]
            launches["edge_softmax_stats"] += got[1]
            seg_sum_na.launches = 0
            edge_softmax_stats.launches = 0
            want = cold[m].forward(params[m], feats2)
            torch.cuda.synchronize()
            cold_counts = (seg_sum_na.launches, edge_softmax_stats.launches)
            per = (2 * NA_PER_FORWARD, 0 if m == "rgcn" else 2 * NA_PER_FORWARD)
            c_cpu = Session(ExecutorSpec(na_executor="banded", device="cpu"),
                            cache=sess.cache).compile(g2, TARGETS, cfg(m))
            ref = c_cpu.forward(c_cpu.init(SEED), device_features(g2, "cpu"))
            cpu_err = (first.cpu() - ref).abs().max().item()
            print(f"delta ({name}) {m}: successor forward first {t_first * 1e3:.2f} ms, "
                  f"warm {t_warm * 1e3:.2f} ms (host clock, ends in a sync; {card}); K1, K2 "
                  f"launches over two successor forwards {got}, one cold forward "
                  f"{cold_counts}; bitwise equal to the cold compile's forward "
                  f"{torch.equal(first, want)}, repeat {torch.equal(first, again)}; "
                  f"max|card - cpu| {cpu_err:.3e} (tolerance {LOGIT_ATOL})")
            require(first.shape == (g2.num_vertices["P"], 3)
                    and bool(torch.isfinite(first).all()), f"delta ({name}) {m}: logits")
            require(torch.equal(first, want) and torch.equal(first, again),
                    f"delta ({name}) {m}: the successor's forward is not bitwise the cold "
                    "compile's")
            require(got == per and cold_counts == (per[0] // 2, per[1] // 2),
                    f"delta ({name}) {m}: launches {got} over two forwards, cold {cold_counts}")
            require(cpu_err <= LOGIT_ATOL, f"delta ({name}) {m}: card and CPU disagree")
            for g, c, p in zip(succ[m].graphs, cold[m].graphs, pred[m].graphs):
                bad = packings_equal(g.packed, c.packed)
                require(not bad, f"delta ({name}) {m} {g.metapath}: packing differs from "
                        f"the cold compile's in {bad}")
                require((g.packed is p.packed) == (g.metapath not in dres.touched),
                        f"delta ({name}) {g.metapath}: an untouched packing is not the "
                        "predecessor's object, or a touched one is")
        if name == "insert":
            spliced = next(g.packed for g in succ["rgat"].graphs if g.metapath == "PSP")
            cold_pk = next(g.packed for g in cold["rgat"].graphs if g.metapath == "PSP")
            faulted = stale_view_successor(succ["rgat"], pred["rgat"], "PSP", dev)
            with torch.inference_mode():
                bad = succ["rgat"].model.execute(params["rgat"], feats2, faulted,
                                                 na_executor="banded")
            sound = succ["rgat"].forward(params["rgat"], feats2)
            want = cold["rgat"].forward(params["rgat"], feats2)
            torch.cuda.synchronize()
            f_err = (bad - want).abs().max().item()
            s_err = (sound - want).abs().max().item()
            print(f"delta (insert) rgat, planted stale-view fault (PSP handed the "
                  f"predecessor's row view and its upload): max|forward - cold| "
                  f"{f_err:.3e}, bitwise {torch.equal(bad, want)}; the sound successor "
                  f"{s_err:.3e}, bitwise {torch.equal(sound, want)} (gate: bitwise, and "
                  f"{LOGIT_ATOL})")
            require(not torch.equal(bad, want) and f_err > LOGIT_ATOL,
                    f"the planted stale-view fault reads {f_err:.3e}, inside the gate")
            rows = na_over_spliced(spliced, cold_pk, dev)
    require(launches["seg_sum_na"] > 0 and launches["edge_softmax_stats"] > 0,
            "K1 or K2 never launched over a successor's packings")
    for r in rows:  # counted over every successor forward of the three deltas
        r["launches"] = launches[r["name"].split()[0]]

    # serving: swap_graph twice while a burst is served
    imdb = make_dataset("IMDB", seed=SEED, scale=1.0)
    sess = Session(ExecutorSpec(na_executor="banded", device=str(dev)))
    eng = HGNNServeEngine(session=sess, policy=ServePolicy(
        batch_window_ms=SERVE_WINDOW_MS, dependency_threshold=DEP_COVERAGE))
    feats_imdb = device_features(imdb, dev)
    acm = eng.register("acm-rgat", graph, TARGETS, cfg("rgat"), seed=SEED, features=feats,
                       subset_mode="head")
    im = eng.register("imdb-rgcn", imdb, IMDB_TARGETS, cfg("rgcn", "M", imdb_layers),
                      seed=SEED, features=feats_imdb, subset_mode="dependency")
    p_acm, p_imdb = eng._registered["acm-rgat"].params, eng._registered["imdb-rgcn"].params
    im.compiled.forward_subset(p_imdb, feats_imdb, np.arange(8), mode="dependency")
    by_version = {1: (acm.compiled, feats)}
    rng = np.random.default_rng(SEED + 3)
    n_target = {"acm-rgat": graph.num_vertices["P"], "imdb-rgcn": imdb.num_vertices["M"]}
    per_wave = SERVE_PER_TENANT // SERVE_WAVES
    swap_waves = {2: ("insert", deltas["insert"]), 5: ("off-metapath TP", None)}
    reqs, futs, served, order_lock, swap_ms = {}, [], [], threading.Lock(), {}
    dep_ids = np.unique(rng.integers(0, n_target["acm-rgat"], size=6))
    dep_flat, adopted, dep_moved, dep_fault_fired = [], None, None, None

    def record(f):
        with order_lock:
            served.append(f.result())

    seg_sum_na.launches = 0
    edge_softmax_stats.launches = 0
    graph_now = graph
    eng.run()
    try:
        t0 = time.perf_counter()
        rid = 0
        for w in range(SERVE_WAVES):
            for name in ("acm-rgat", "imdb-rgcn"):
                wave = []
                for _ in range(per_wave):
                    ids = rng.integers(0, n_target[name], size=int(rng.integers(4, 17)))
                    reqs[rid] = (name, ids, w)
                    wave.append(HGNNRequest(rid, name, nodes=ids))
                    rid += 1
                for f in eng.submit(wave):
                    f.add_done_callback(record)
                    futs.append(f)
            if w in swap_waves:
                label, delta = swap_waves[w]
                if delta is None:
                    delta = tp_delta(graph_now)
                    c = acm.compiled
                    before_rows = c.forward_subset(p_acm, by_version[acm.version][1],
                                                   dep_ids, mode="dependency")
                    dep_flat.append(c.dependency_traces)
                ts = time.perf_counter()
                v = acm.swap_graph(delta)
                swap_ms[label] = (time.perf_counter() - ts) * 1e3
                graph_now = graph_now.apply_delta(delta)
                feats_now = (device_features(graph_now, dev) if delta.add_vertices
                             else by_version[v - 1][1])
                by_version[v] = (acm.compiled, feats_now)
                if label.startswith("off"):
                    adopted = len(acm.compiled._extractor._memo)
                    after_rows = acm.compiled.forward_subset(p_acm, feats_now, dep_ids,
                                                             mode="dependency")
                    dep_flat.append(acm.compiled.dependency_traces)
                    # the attention subset runs K2 and K1 (no float atomics),
                    # so its rows repeat bit for bit across the swap; the check
                    # must fire on a copy nudged by one ulp
                    dep_moved = (before_rows - after_rows).abs().max().item()
                    nudged = after_rows.clone()
                    nudged[0, 0] = torch.nextafter(nudged[0, 0],
                                                   torch.tensor(np.inf, device=dev))
                    dep_fault_fired = not torch.equal(before_rows, nudged)
                    require(torch.equal(before_rows, after_rows), "dependency rows "
                            f"moved across the off-metapath swap by {dep_moved:.3e}")
                    require(dep_fault_fired, "the bitwise check on the swap's dependency "
                            "rows missed a one-ulp nudge")
            time.sleep(SERVE_WAVE_GAP_S)
        responses = [f.result(timeout=300) for f in futs]
        whole = []
        for name in ("acm-rgat", "imdb-rgcn"):
            reqs[rid] = (name, None, SERVE_WAVES)
            whole.append(HGNNRequest(rid, name))
            rid += 1
        responses += [f.result(timeout=300) for f in eng.submit(whole)]
        t_burst = time.perf_counter() - t0
    finally:
        eng.stop()
    torch.cuda.synchronize()
    served_launches = (seg_sum_na.launches, edge_softmax_stats.launches)
    require(sorted(r.rid for r in responses) == list(range(rid)), "a request went unanswered")
    acm_versions = [r.params_version for r in served if r.graph == "acm-rgat"]
    require(acm_versions == sorted(acm_versions) and acm.version == 3,
            f"ACM versions not monotone in service order, or not at 3: {acm.version}")
    require(all(r.params_version == 1 for r in served if r.graph == "imdb-rgcn"),
            "the IMDB tenant's version moved")
    require(dep_flat[0] == dep_flat[1], f"dependency_traces moved across the off-metapath "
            f"swap: {dep_flat}")
    full = {v: c.forward(p_acm, f).cpu().numpy() for v, (c, f) in by_version.items()}
    full_imdb = im.compiled.forward(p_imdb, feats_imdb).cpu().numpy()
    dep_err = 0.0
    for r in responses:
        name, ids, _ = reqs[r.rid]
        require(np.isfinite(r.logits).all(), f"request {r.rid}: non-finite logits")
        if name == "acm-rgat":
            want = full[r.params_version] if ids is None else full[r.params_version][ids]
            require(np.array_equal(r.logits, want), f"request {r.rid} (ACM, version "
                    f"{r.params_version}, {r.mode}) is not bitwise that version's forward")
        else:
            want = full_imdb if ids is None else full_imdb[ids]
            dep_err = max(dep_err, float(np.abs(r.logits - want).max()))
    require(dep_err <= LOGIT_ATOL, "IMDB dependency rows disagree with the forward")
    st = eng.stats()
    modes = sorted({r.mode for r in responses})
    print(f"delta serving: {len(responses)} responses in {t_burst * 1e3:.1f} ms, modes "
          f"{modes}, ACM versions served {sorted(set(acm_versions))}; swap_graph wall ms "
          f"{ {k: round(v, 2) for k, v in swap_ms.items()} }, the extractor adopted "
          f"{adopted} entry at the off-metapath swap; dependency_traces across the "
          f"off-metapath swap {dep_flat}, its rows moved {dep_moved:.3e} (gate: bitwise; "
          f"the check on a one-ulp nudge fires {dep_fault_fired}); K1, K2 "
          f"launches over the served run "
          f"{served_launches}; retries {st['retries']}, breaker fast-fails "
          f"{st['breaker_fastfails']}; IMDB dependency rows max|served - forward| "
          f"{dep_err:.3e} ({card})")
    by_wave = {}
    for r in responses:
        by_wave.setdefault(reqs[r.rid][2], []).append(r.queue_us)
    print("delta serving: queue p50 / p99 us by wave (a swap follows waves "
          f"{sorted(swap_waves)}): " + "; ".join(
              f"{w}: {np.percentile(q, 50):.1f} / {np.percentile(q, 99):.1f}"
              for w, q in sorted(by_wave.items())) + f" ({card})")
    return rows


def drop_rank_forward(compiled, params, feats):
    """Planted fault for phase 3e: a forward of a sharded compile with one
    rank left out of the sum (its stream set to none for one call): the
    lightest rank holding blocks of a semantic graph that ends at the
    target type (APA's and AMA's outputs never reach the logits).  Returns
    the logits and the rank dropped."""
    ex = compiled._shard_exec
    streams = ex.streams()
    live = {s.device for s in compiled.shard_plan.slices
            if s.metapath[-1] == compiled.cfg.target_type}
    light = min((streams[r] for r in live), key=lambda st: st.packed.num_edges)
    ex._streams = [None if st is light else st for st in streams]
    try:
        return compiled.forward(params, feats), light.rank
    finally:
        ex._streams = streams


def phase_sharded(graph, dev, card: str) -> list:
    """Phase 3e: sharded execution over ``SHARD_RANKS`` ranks on the one card
    (``REPRO_TORCH_VIRTUAL_DEVICES``).  Full-width ACM rgcn, rgat and shgn in
    both modes and IMDB rgat in edge_block mode, held to the single-device
    card forward, the CPU sharded run and themselves; a dropped-rank fault;
    K1 and K2 over the largest rank's merged stream; and an engine with two
    tenants pinned to disjoint rank groups.  Returns the kernels line's
    rows for K1 and K2 over the merged stream."""
    import os

    from repro_torch.api import ExecutorSpec, ServePolicy, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.hetero import make_dataset
    from repro_torch.kernels.edge_softmax import edge_softmax_stats
    from repro_torch.kernels.seg_sum import seg_sum_na
    from repro_torch.launch.mesh import VIRTUAL_DEVICES_ENV
    from repro_torch.serve import HGNNRequest, HGNNServeEngine

    t_phase = time.perf_counter()
    before_env = os.environ.get(VIRTUAL_DEVICES_ENV)
    os.environ[VIRTUAL_DEVICES_ENV] = str(SHARD_RANKS)
    try:
        imdb = make_dataset("IMDB", seed=SEED, scale=1.0)
        data = {"ACM": (graph, TARGETS, "P"), "IMDB": (imdb, IMDB_TARGETS, "M")}
        feats = {ds: device_features(g, dev) for ds, (g, _, _) in data.items()}
        feats_cpu = {ds: device_features(g, "cpu") for ds, (g, _, _) in data.items()}
        single = Session(ExecutorSpec(na_executor="banded", device=str(dev)))
        sess = {mode: Session(ExecutorSpec(na_executor="banded", device=str(dev), shard=mode,
                                           mesh_shape=(SHARD_RANKS,)), cache=single.cache)
                for mode in SHARD_MODES}
        cpu = {mode: Session(ExecutorSpec(na_executor="banded", device="cpu", shard=mode,
                                          mesh_shape=(SHARD_RANKS,)), cache=single.cache)
               for mode in SHARD_MODES}
        cases = [("ACM", mode, m) for mode in SHARD_MODES for m in MODELS]
        cases.append(("IMDB", "edge_block", "rgat"))

        def cfg(model, tt):
            return HGNNConfig(model=model, hidden=64, num_layers=3, sf_att_dim=64,
                              target_type=tt)

        launched = {"seg_sum_na": 0, "edge_softmax_stats": 0}
        plans = {}
        for ds, mode, model in cases:
            g, targets, tt = data[ds]
            c = sess[mode].compile(g, targets, cfg(model, tt))
            plan = c.shard_plan
            if (ds, mode) not in plans:
                plans[ds, mode] = plan
                print(f"shard {ds} {mode}: plan {plan.summary()}")
            params = c.init(SEED)
            seg_sum_na.launches = 0
            edge_softmax_stats.launches = 0
            t0 = time.perf_counter()
            got = c.forward(params, feats[ds])
            torch.cuda.synchronize()
            t_first = (time.perf_counter() - t0) * 1e3
            once = (seg_sum_na.launches, edge_softmax_stats.launches)
            again = c.forward(params, feats[ds])
            torch.cuda.synchronize()
            launched["seg_sum_na"] += seg_sum_na.launches
            launched["edge_softmax_stats"] += edge_softmax_stats.launches
            busy = int((plan.device_block_counts() > 0).sum())
            want = (busy * 3, 0 if model == "rgcn" else busy * 3)
            one_rank = single.compile(g, targets, cfg(model, tt))
            ref = one_rank.forward(params, feats[ds])
            err = (got - ref).abs().max().item()
            cc = cpu[mode].compile(g, targets, cfg(model, tt))
            cpu_err = (got.cpu() - cc.forward(cc.init(SEED), feats_cpu[ds])).abs().max().item()
            bad, dropped = drop_rank_forward(c, params, feats[ds])
            f_err = (bad - ref).abs().max().item()
            t_shard = median_ms(lambda: c.forward(params, feats[ds]), reps=10, warmup=1)
            t_single = median_ms(lambda: one_rank.forward(params, feats[ds]), reps=10, warmup=1)
            print(f"shard {ds} {mode} {model}: logits {tuple(got.shape)}, bitwise equal to the "
                  f"single-device card forward {torch.equal(got, ref)} (max|d| {err:.3e}, "
                  f"tolerance {LOGIT_ATOL}); max|card - cpu sharded| {cpu_err:.3e}; repeat "
                  f"bitwise {torch.equal(got, again)}; K1, K2 launches a forward {once} (want "
                  f"{want}: {busy} non-empty ranks x 3 layers); shard_traces {c.shard_traces}; "
                  f"planted fault (rank {dropped} dropped from the sum) max|d| {f_err:.3e}; "
                  f"forward first {t_first:.2f} ms (host clock, builds the rank streams), "
                  f"event median {t_shard:.3f} ms against {t_single:.3f} ms on one rank "
                  f"({card})")
            require(got.shape == (g.num_vertices[tt], 3) and bool(torch.isfinite(got).all()),
                    f"shard {ds} {mode} {model}: logits")
            require(err <= LOGIT_ATOL, f"shard {ds} {mode} {model}: sharded logits disagree "
                    "with the single-device forward")
            require(cpu_err <= LOGIT_ATOL, f"shard {ds} {mode} {model}: card and CPU disagree")
            require(torch.equal(got, again), f"shard {ds} {mode} {model}: not repeatable")
            require(once == want, f"shard {ds} {mode} {model}: launches {once}, want {want}")
            require(c.shard_traces == 1, f"shard {ds} {mode} {model}: shard_traces "
                    f"{c.shard_traces}")
            require(f_err > LOGIT_ATOL, f"shard {ds} {mode} {model}: the dropped-rank fault "
                    f"reads {f_err:.3e}, inside the gate")

        # K1 and K2 over the largest rank's merged stream
        c = sess["edge_block"].compile(graph, TARGETS, cfg("rgat", "P"))
        big = max((st for st in c._shard_exec.streams() if st is not None),
                  key=lambda st: st.packed.num_edges)
        pk = big.packed
        rows = na_kernels_on(pk, f"ACM edge_block rank {big.rank} merged stream", dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        h = torch.randn(pk.num_src, D, device=dev, generator=gen)
        w = torch.rand(pk.src_local.shape, device=dev, generator=gen)
        logits = torch.randn(pk.src_local.shape, device=dev, generator=gen) * 3
        queued = {"seg_sum_na": queued_ms(lambda: seg_sum_na(pk, h, w)),
                  "edge_softmax_stats": queued_ms(lambda: edge_softmax_stats(pk, logits))}
        for r in rows:
            kind = r["name"]
            r["name"] = f"{kind} (merged shard stream)"
            r["launches"] = launched[kind]
            r["queued_ms"] = queued[kind]
            r["plan"] = plans["ACM", "edge_block"].summary()
            print(f"{r['name']}: queue-full {r['queued_ms']:.4f} ms, event {r['ms']:.4f} ms, "
                  f"launches over phase 3e's sharded forwards {r['launches']} ({card})")
            require(r["launches"] > 0, f"{kind} never launched on the sharded path")

        # two tenants pinned to disjoint rank groups
        eng = HGNNServeEngine(session=sess["edge_block"],
                              policy=ServePolicy(batch_window_ms=SERVE_WINDOW_MS))
        handles = {name: eng.register(name, graph, TARGETS, cfg(model, "P"), seed=SEED,
                                      features=feats["ACM"], device_group=group)
                   for name, (model, group) in SHARD_GROUPS.items()}
        rng = np.random.default_rng(SEED + 4)
        reqs, rid = {}, 0
        eng.run()
        try:
            responses = []
            for whole in (False, True):  # id subsets, then whole-graph requests
                futs = []
                for i in range(2 if whole else SHARD_SERVE_PER_TENANT - 2):
                    wave = []
                    for name in SHARD_GROUPS:
                        ids = None if whole else rng.integers(
                            0, graph.num_vertices["P"], size=int(rng.integers(4, 17)))
                        reqs[rid] = (name, ids)
                        wave.append(HGNNRequest(rid, name, nodes=ids))
                        rid += 1
                    futs += eng.submit(wave)
                responses += [f.result(timeout=300) for f in futs]
        finally:
            eng.stop()
        require(sorted(r.rid for r in responses) == list(range(rid)),
                "a pinned tenant's request went unanswered")
        worst, bitwise = 0.0, True
        for name, (model, group) in SHARD_GROUPS.items():
            comp = handles[name].compiled
            require(comp.shard_plan.num_devices == len(group) and comp._devkey == tuple(group),
                    f"{name} is not pinned to ranks {group}")
        full = {name: single.compile(graph, TARGETS, cfg(model, "P")).forward(
            eng._registered[name].params, feats["ACM"]).cpu().numpy()
            for name, (model, _) in SHARD_GROUPS.items()}
        for r in responses:
            name, ids = reqs[r.rid]
            want = full[name] if ids is None else full[name][ids]
            worst = max(worst, float(np.abs(r.logits - want).max()))
            bitwise = bitwise and np.array_equal(r.logits, want)
        modes = sorted({r.mode for r in responses})
        print(f"shard serving: tenants {dict(SHARD_GROUPS)} answered {len(responses)} of {rid} "
              f"requests, modes {modes}; max|served - unsharded forward| {worst:.3e} "
              f"(tolerance {LOGIT_ATOL}), bitwise {bitwise}; latency "
              f"{percentiles([r.latency_us for r in responses])} ({card})")
        require(worst <= LOGIT_ATOL, "pinned tenants' rows disagree with the unsharded forward")
        require(modes == ["full", "subset"], f"pinned tenants served modes {modes}")
    finally:
        if before_env is None:
            os.environ.pop(VIRTUAL_DEVICES_ENV, None)
        else:
            os.environ[VIRTUAL_DEVICES_ENV] = before_env
    print(f"shard: phase 3e took {time.perf_counter() - t_phase:.1f} s of wall time")
    return rows


def prof_call(label: str, fn) -> list:
    """Device time by kernel name over one warm call of ``fn``
    (torch.profiler); returns ``[(device us, launches, name)]``, largest
    first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = _device_events(prof)
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not rows:
        print(f"profile {label}: device time not measured (no device events)")
        return rows
    print(f"profile {label}: wall {wall:.3f} ms, device busy {total / 1e3:.3f} ms "
          f"({100 * total / 1e3 / wall:.1f}% of wall), {sum(r[1] for r in rows)} "
          "kernel launches")
    for dev_us, count, key in rows[:10]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    return rows


def kernel_name(key: str) -> str:
    """A device kernel's own name out of the profiler's demangled key
    (``void (anonymous namespace)::ssd_output_kernel<true>(...)``)."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", key)
    return m.group(1) + (m.group(2) or "") if m else key[:60]


def _edges_equal(a, b) -> bool:
    return ((a.num_src, a.num_dst) == (b.num_src, b.num_dst)
            and np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst))


def int_mm_call(a, b):
    """``(a @ b) > 0`` by one ``torch._int_mm`` on int8 views (0/1 fit),
    with B laid out K-major outside the timed call; or ``(None, reason)``
    where the card refuses it."""
    a8, b8 = a.view(torch.int8), b.view(torch.int8).t().contiguous().t()
    try:
        torch._int_mm(a8, b8)
    except RuntimeError as exc:  # a shape or layout the card does not take
        return None, str(exc).splitlines()[0][:120]
    return (lambda: torch._int_mm(a8, b8) > 0), None


def planted_occupancy_fault(a, b, ao, bo, plain, mt, kt, nt):
    """One ``a_occ`` bit whose pairs carry output, cleared: the live A tiles
    in the tile rows with the fewest live pairs are tried in turn until the
    plain version of that row panel changes.  Returns ``(faulted bitmap,
    mi, ki, the panel's plain product under the fault)`` or None."""
    from repro_torch.kernels.spgemm_bsr import TILE, spgemm_plain

    cand = (ao.reshape(mt, kt) > 0) & (bo.reshape(kt, nt) > 0).any(dim=1)[None, :]
    rows = [int(r) for r in torch.argsort(cand.sum(dim=1), stable=True).tolist()
            if int(cand[r].sum()) > 0]
    for mi in rows[:8]:
        for ki in torch.nonzero(cand[mi]).flatten().tolist()[:8]:
            faulted = ao.clone()
            faulted[mi * kt + ki] = 0
            panel = slice(mi * TILE, (mi + 1) * TILE)
            got, _ = spgemm_plain(a[panel], b, faulted.reshape(mt, kt)[mi].contiguous(), bo)
            if not torch.equal(got, plain[panel]):
                return faulted, mi, ki, got
    return None


def sgb_step(dev, step, left, right):
    """K3 on one plan step's operands: exactness, repeatability, a planted
    fault and times."""
    from repro_torch.kernels.spgemm_bsr import (TILE, pair_stats, spgemm_bsr,
                                                spgemm_plain, split_count,
                                                tile_occupancy, transpose_tiles)

    a, b = left.dense_padded(dev, TILE), right.dense_padded(dev, TILE)
    ao, bo = tile_occupancy(a), tile_occupancy(b)
    mt, kt, nt = a.shape[0] // TILE, a.shape[1] // TILE, b.shape[1] // TILE
    st = pair_stats(ao, bo, mt, kt, nt)
    out, occ = spgemm_bsr(a, b, ao, bo)
    again, occ2 = spgemm_bsr(a, b, ao, bo)
    plain, plain_occ = spgemm_plain(a, b, ao, bo)
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    lib = (torch.matmul(a32, b32) > 0).to(torch.uint8)
    int_mm, int_mm_refused = int_mm_call(a, b)
    torch.cuda.synchronize()
    err = (out.to(torch.int32) - plain.to(torch.int32)).abs().max().item()
    require(torch.equal(out, plain) and torch.equal(occ, plain_occ),
            f"K3 differs from its plain version on {step!r}")
    require(torch.equal(out, again) and torch.equal(occ, occ2),
            f"K3 not bitwise repeatable on {step!r}")
    require(torch.equal(lib, plain), f"library yardstick differs on {step!r}")
    if int_mm is not None:
        require(torch.equal(int_mm().to(torch.uint8), plain),
                f"torch._int_mm yardstick differs on {step!r}")
    # planted fault: one a_occ bit whose pairs carry output, cleared; K3 must
    # then differ from the unaltered plain version (and equal the plain
    # version under the same fault)
    fault = planted_occupancy_fault(a, b, ao, bo, plain, mt, kt, nt)
    require(fault is not None, f"no a_occ bit of {step!r} carries output alone")
    faulted, fmi, fki, fpanel = fault
    fout, _ = spgemm_bsr(a, b, faulted, bo)
    panel = slice(fmi * TILE, (fmi + 1) * TILE)
    fault_bytes = int((fout != plain).sum())
    require(fault_bytes > 0, f"planted fault on {step!r} left K3 equal to the plain version")
    require(torch.equal(fout[panel], fpanel)
            and torch.equal(fout[:fmi * TILE], plain[:fmi * TILE])
            and torch.equal(fout[(fmi + 1) * TILE:], plain[(fmi + 1) * TILE:]),
            f"K3 under the planted fault differs from the plain version on {step!r}")
    del fout, fpanel, faulted, lib
    reps = 5 if st["tile_pairs_live"] > 20000 else 20
    ms = median_ms(lambda: spgemm_bsr(a, b, ao, bo), reps=reps)
    prepass_ms = median_ms(lambda: transpose_tiles(b, bo), reps=reps)
    # queue full: the wrapper's host cost (tens of us a call) left out
    queued = queued_ms(lambda: spgemm_bsr(a, b, ao, bo), reps=reps)
    prepass_queued = queued_ms(lambda: transpose_tiles(b, bo), reps=reps)
    plain_ms = median_ms(lambda: spgemm_plain(a, b, ao, bo), reps=reps)
    lib_ms = median_ms(lambda: torch.matmul(a32, b32) > 0, reps=reps)
    int_mm_ms = median_ms(int_mm, reps=reps) if int_mm is not None else None
    ops = 2.0 * st["macs_live"]
    nbytes = (int(ao.sum()) + int(bo.sum())) * TILE * TILE + out.numel() \
        + 4 * (ao.numel() + bo.numel() + occ.numel())
    t_ops, t_bytes = ops / INT8_OP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "step": repr(step), "shape": f"{tuple(a.shape)}x{tuple(b.shape)}",
        "pairs_live": st["tile_pairs_live"], "pairs_total": st["tile_pairs_total"],
        "splits": split_count(mt, nt, kt),
        "ms": ms, "prepass_ms": prepass_ms, "queued_ms": queued,
        "prepass_queued_ms": prepass_queued, "plain_ms": plain_ms, "library_ms": lib_ms,
        "library_int_mm_ms": int_mm_ms, "int_mm_refused": int_mm_refused, "err": err,
        "fault": f"a_occ[{fmi}, {fki}] cleared: {fault_bytes} bytes differ",
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops": ops, "bytes": nbytes,
        "fp32_cuda_core_ms": ops / FP32_FLOP_PER_S * 1e3,
    }


# What the DBLP breakdown labels, in order: (label, module attribute path).
# Each is wrapped in a torch.profiler.record_function range for one
# profiled run; device kernels are credited to the innermost label that
# launched them.
SGB_SPANS = (
    ("dense_padded", "repro_torch.hetero.graph:Relation.dense_padded"),
    ("tile_occupancy", "repro_torch.core.sgb:tile_occupancy"),
    ("K3", "repro_torch.kernels.spgemm_bsr:spgemm_cuda"),
    ("pair_stats (sync 1)", "repro_torch.kernels.spgemm_bsr:pair_stats"),
    ("spgemm_macs", "repro_torch.core.sgb:spgemm_macs"),
    ("count_nonzero", "torch:count_nonzero"),
    ("compose", "repro_torch.core.sgb:DeviceComposer.compose"),
    ("extract", "repro_torch.core.sgb:DeviceComposer.extract"),
)


def sgb_breakdown(graph, plan, dev) -> dict:
    """Where a device ``execute_plan`` spends its time, from one profiled
    run (torch.profiler): per span, calls, host ms and device ms of the
    kernels it launched (K3's split into the Bᵀ pre-pass and the product),
    the run's wall and the device's busy share.  ``compose`` holds what
    its other spans leave: the stack of the two counters and the host sync
    that brings them back."""
    import importlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import sgb

    def labelled(label, fn):
        def run(*args, **kwargs):
            with record_function(f"sgb::{label}"):
                return fn(*args, **kwargs)
        return run

    saved = []
    for label, path in SGB_SPANS:
        mod_name, attr = path.split(":")
        owner = importlib.import_module(mod_name)
        *outer, name = attr.split(".")
        for part in outer:
            owner = getattr(owner, part)
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, labelled(label, getattr(owner, name)))
    try:
        sgb.execute_plan(graph, plan, backend="device", device=dev)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sgb.execute_plan(graph, plan, backend="device", device=dev)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)

    spans = {label: {"calls": 0, "host_ms": 0.0, "device_ms": 0.0} for label, _ in SGB_SPANS}
    spans["other"] = {"calls": 0, "host_ms": 0.0, "device_ms": 0.0}
    k3 = {"transpose_tiles_kernel": 0.0, "spgemm_wgmma_kernel": 0.0}
    busy = attached = k3_attached = 0.0
    for ev in prof.events():
        on_device = "CUDA" in str(getattr(ev, "device_type", ""))
        if ev.name.startswith("sgb::"):
            if not on_device:  # the device copy of a label spans its kernels
                span = spans[ev.name[5:]]
                span["calls"] += 1
                span["host_ms"] += ev.cpu_time_total / 1e3
            continue
        if on_device:  # a kernel, memcpy or memset
            dur = ev.time_range.elapsed_us() / 1e3
            busy += dur
            for key in k3:
                if key in ev.name:
                    k3[key] += dur
        for kern in getattr(ev, "kernels", []) or []:  # tied to the launch that issued it
            dur = kern.duration / 1e3
            attached += dur
            if any(key in kern.name for key in k3):
                k3_attached += dur
            up = ev
            while up is not None and not up.name.startswith("sgb::"):
                up = up.cpu_parent
            spans[up.name[5:] if up is not None else "other"]["device_ms"] += dur
    # the kernels launched through ctypes are not tied to their launches in
    # the trace: K3's are credited by name, the rest of the busy time is
    # "other"
    k3_loose = k3["transpose_tiles_kernel"] + k3["spgemm_wgmma_kernel"] - k3_attached
    spans["K3"]["device_ms"] += k3_loose
    spans["other"]["device_ms"] += max(0.0, busy - attached - k3_loose)
    # a span's host time holds its inner spans': compose holds the others
    inner = ("dense_padded", "tile_occupancy", "K3", "pair_stats (sync 1)", "spgemm_macs",
             "count_nonzero")
    spans["compose"]["host_ms"] -= sum(spans[k]["host_ms"] for k in inner)
    return {"wall_ms": wall, "device_busy_ms": busy, "spans": spans,
            "attached_ms": attached,
            "prepass_ms": k3["transpose_tiles_kernel"],
            "product_ms": k3["spgemm_wgmma_kernel"]}


def phase_sgb(make_dataset, dev):
    """Phase 4: host against device SGB (K3) at scale 1.0, K3 per step, and
    a profiled breakdown of DBLP's device SGB."""
    from repro_torch.core import sgb
    from repro_torch.kernels.spgemm_bsr import kernel_info, spgemm_bsr

    print(f"K3 main kernel: {kernel_info()}")
    rows, breakdown = {}, None
    for name, targets in SGB_WORKLOADS.items():
        graph = make_dataset(name, seed=SEED, scale=1.0)
        plan = sgb.make_plan(graph, targets, planner="ctt")
        host = sgb.execute_plan(graph, plan)
        spgemm_bsr.launches = 0
        t0 = time.perf_counter()
        device = sgb.execute_plan(graph, plan, backend="device", device=dev)
        dev_s = time.perf_counter() - t0
        require(spgemm_bsr.launches == len(plan.steps),
                f"{name}: K3 launched {spgemm_bsr.launches} times for "
                f"{len(plan.steps)} steps")
        require(device.cost == host.cost, f"{name}: SGB costs differ")
        require([c for _, c in device.per_step] == [c for _, c in host.per_step],
                f"{name}: per-step SGB costs differ")
        for mp in {st.out for st in plan.steps} | set(targets):
            require(_edges_equal(device.graphs[mp], host.graphs[mp]),
                    f"{name}: device and host SGB differ on {mp}")
        ds = device.device_stats
        print(f"sgb {name}: {len(plan.steps)} steps, products bitwise equal to "
              f"the host join, MACs {device.cost.macs}; device_stats {ds} "
              f"(pruned {1 - ds['tile_pairs_live'] / ds['tile_pairs_total']:.4f}); "
              f"host {host.wall_seconds * 1e3:.1f} ms, device {dev_s * 1e3:.1f} ms")
        if name == "DBLP":
            breakdown = sgb_breakdown(graph, plan, dev)
            print(f"sgb DBLP breakdown (one profiled device run): wall "
                  f"{breakdown['wall_ms']:.3f} ms, device busy "
                  f"{breakdown['device_busy_ms']:.3f} ms "
                  f"({100 * breakdown['device_busy_ms'] / breakdown['wall_ms']:.1f}%); K3 "
                  f"B^T pre-pass {breakdown['prepass_ms']:.4f} ms, product "
                  f"{breakdown['product_ms']:.4f} ms")
            for label, span in breakdown["spans"].items():
                print(f"  {label:20s} calls {span['calls']:3d}  host {span['host_ms']:9.3f} ms"
                      f"  device {span['device_ms']:8.4f} ms")
        rows[name] = []
        for st, cost in device.per_step:
            r = sgb_step(dev, st, host.graphs[st.left], host.graphs[st.right])
            r["edges_out"] = cost.bytes_written // 8
            rows[name].append(r)
            lib2 = (_ms(r["library_int_mm_ms"]) if r["int_mm_refused"] is None
                    else f"refused ({r['int_mm_refused']})")
            print(f"  {r['step']} {r['shape']}: live pairs {r['pairs_live']}/"
                  f"{r['pairs_total']} (pruned {1 - r['pairs_live'] / r['pairs_total']:.4f}), "
                  f"splits {r['splits']}, out edges {r['edges_out']}; K3 {r['ms']:.4f} ms, "
                  f"queue-full {r['queued_ms']:.4f} ms (B^T pre-pass alone {r['prepass_ms']:.4f}"
                  f", queue-full {r['prepass_queued_ms']:.4f} ms), plain "
                  f"{r['plain_ms']:.4f} ms, matmul fp32 {r['library_ms']:.4f} ms, "
                  f"_int_mm {lib2}; bound {r['bound_ms']:.5f} ms ({r['bound_by']}; "
                  f"fp32 CUDA cores {r['fp32_cuda_core_ms']:.4f} ms); |K3 - plain| "
                  f"{r['err']}; planted fault: {r['fault']}")
    return rows, breakdown


def phase_device_session(make_dataset, dev):
    """Phase 5: the device-SGB session on full-width DBLP, held bitwise to
    a host-SGB session on the same card."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.core.hgnn import HGNNConfig
    from repro_torch.kernels.edge_softmax import edge_softmax_stats
    from repro_torch.kernels.seg_sum import seg_sum_na
    from repro_torch.kernels.spgemm_bsr import spgemm_bsr

    graph = make_dataset("DBLP", seed=SEED, scale=1.0)
    targets = SGB_WORKLOADS["DBLP"]
    feats = device_features(graph, dev)
    cfgs = {m: HGNNConfig(model=m, hidden=64, num_layers=3, sf_att_dim=64,
                          target_type="A") for m in MODELS}
    sess = Session(ExecutorSpec(sgb_backend="device", device=str(dev)))
    torch.cuda.synchronize()

    seg_sum_na.launches = edge_softmax_stats.launches = spgemm_bsr.launches = 0
    t0 = time.perf_counter()
    compiled = {m: sess.compile(graph, targets, cfgs[m]) for m in MODELS}
    compile_s = time.perf_counter() - t0
    params = {m: compiled[m].init(SEED) for m in MODELS}
    logits, latency = {}, {}
    for m in MODELS:
        outs, lat = [], []
        for _ in range(FORWARDS):
            t0 = time.perf_counter()
            outs.append(compiled[m].forward(params[m], feats))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        logits[m], latency[m] = outs, lat
    launches = {"spgemm_bsr": spgemm_bsr.launches, "seg_sum_na": seg_sum_na.launches,
                "edge_softmax_stats": edge_softmax_stats.launches}
    res = compiled["rgcn"].frontend
    steps = len(res.sgb.per_step)
    print(f"device session DBLP: launches over compile + {len(MODELS)} models x "
          f"{FORWARDS} forwards: {launches}; compile {compile_s * 1e3:.1f} ms; "
          "cold frontend " + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in res.timings.items())
          + "; semantic graph edges "
          + str({mp: rel.num_edges for mp, rel in res.semantic.items()}))
    require(res.sgb.backend == "device", "the device session ran host SGB")
    require(launches["spgemm_bsr"] == steps, f"K3 launched {launches['spgemm_bsr']} "
            f"times for {steps} plan steps")
    require(launches["seg_sum_na"] == NA_PER_FORWARD * FORWARDS * len(MODELS),
            f"K1 launched {launches['seg_sum_na']} times")
    require(launches["edge_softmax_stats"] == NA_PER_FORWARD * FORWARDS * 2,
            f"K2 launched {launches['edge_softmax_stats']} times")

    host = Session(ExecutorSpec(device=str(dev)))
    for m in MODELS:
        first = logits[m][0]
        require(first.shape == (graph.num_vertices["A"], 3), f"{m}: logits shape {first.shape}")
        require(bool(torch.isfinite(first).all()), f"{m}: non-finite logits")
        require(all(torch.equal(first, o) for o in logits[m][1:]),
                f"{m}: logits differ between forwards")
        c_host = host.compile(graph, targets, cfgs[m])
        same = torch.equal(first, c_host.forward(c_host.init(SEED), feats))
        print(f"device session {m}: logits {tuple(first.shape)}, max|logit| "
              f"{first.abs().max().item():.4f}, bitwise equal to the host-SGB "
              f"session: {same}; forward ms {['%.3f' % x for x in latency[m]]}")
        require(same, f"{m}: device-SGB logits differ from the host-SGB session's")
    hres = host.frontend(graph, targets)
    print("host session DBLP: cold frontend " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in hres.timings.items()))
    return launches


def _randn(gen, shape, dev, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def k4_blocks(s: int) -> list:
    """Query-row blocks ``(first row, rows)`` of a causal S = T shape that
    K4 is held to its float32 plain version on: all rows up to S = 4096,
    else 256 rows at the start, the middle and the end (each block's keys
    end at its last row, so the plain version of a block is exact)."""
    if s <= 4096:
        return [(0, s)]
    return [(0, 256), (s // 2 - 128, 256), (s - 256, 256)]


def tile_rms(out, ref) -> torch.Tensor:
    """Per (batch, head, 128-row query tile): ||out - ref|| / ||ref||."""
    import torch.nn.functional as F

    b, h, s, dh = ref.shape
    n = -(-s // 128)

    def per_tile(x):
        return F.pad(x, (0, 0, 0, n * 128 - s)).reshape(b, h, n, -1).sum(-1)
    return (per_tile((out.float() - ref).square()) / per_tile(ref.square())).sqrt()


def plain_rows(q, k, v, first, window=None, softcap=None, drop=None, causal=True,
               scale=None):
    """float32 plain attention of the query rows ``q`` (key positions
    ``first`` on; S = T) over all of ``k`` and ``v``, scaled by ``scale``
    (default q's head dim ``** -0.5``), with the key range ``drop`` masked
    out where given: the output of a kernel that skipped that key tile."""
    from repro_torch.kernels.flash_attention import NEG

    rows, dh, t = q.shape[2], q.shape[3], k.shape[2]
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    logits = (q.float() @ kf.transpose(-1, -2)) * (dh ** -0.5 if scale is None else scale)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(first, first + rows, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    live = kpos <= qpos if causal else torch.ones((rows, t), dtype=torch.bool,
                                                  device=q.device)
    if window is not None:
        live &= kpos > qpos - window
    if drop is not None:
        live[:, drop] = False
    p = torch.softmax(logits.masked_fill(~live, NEG), dim=-1)
    return p @ v.float().repeat_interleave(g, dim=1)


def k4_gate_f32(q, k, v, out, lib, window=None, softcap=None):
    """K4's bf16 causal output ``out`` on ``k4_blocks`` against the float32
    plain version: the largest ``|out - ref| / (K4_BF16_ATOL + K4_BF16_RTOL
    |ref|)`` (at most 1) and the largest per-tile relative RMS error (at
    most K4_TILE_RMS); the library output's tile reading (None where it
    computes another function); and the tile reading of a planted fault:
    the last 256 rows with one interior key tile (of the kernel's tile
    width at this head dim) dropped from the keys every one of them sees,
    the fault the kernel's tile plan could make, which the gate must
    reject."""
    from repro_torch.kernels.flash_attention import attention_plain, kernel_info

    s, dh = q.shape[2], q.shape[3]
    kw = dict(causal=True, window=window, softcap=softcap)
    elem = rms = lib_rms = 0.0
    for a, r in k4_blocks(s):
        ref = attention_plain(q[:, :, a:a + r].float(), k[:, :, :a + r].float(),
                              v[:, :, :a + r].float(), **kw)
        got = out[:, :, a:a + r].float()
        elem = max(elem, ((got - ref).abs() / (K4_BF16_ATOL + K4_BF16_RTOL * ref.abs()))
                   .max().item())
        rms = max(rms, tile_rms(got, ref).max().item())
        if lib is not None:
            lib_rms = max(lib_rms, tile_rms(lib[:, :, a:a + r], ref).max().item())
    bk = kernel_info(dh)["block_k"]  # keys per tile of the loaded kernel
    first = s - 256
    lo = max(0, s - window) if window is not None else 0  # every last row sees keys lo..first
    d0 = (lo + first) // 2 // bk * bk  # a tile in the middle of them
    qb = q[:, :, first:]
    fault = plain_rows(qb, k, v, first, window, softcap, drop=slice(d0, d0 + bk))
    fault_rms = tile_rms(fault, plain_rows(qb, k, v, first, window, softcap)).max().item()
    return elem, rms, (lib_rms if lib is not None else None), fault_rms


def k4_bound(q, k, v, causal, window) -> tuple:
    """(bound ms, what bounds it, flops, bytes) of one K4 call: the live
    (query, key) pairs' two products over the bf16 tensor cores' peak, or
    q, k, v and the output read or written once over HBM."""
    b, h, s, dqk = q.shape
    t, dv = k.shape[2], v.shape[3]
    if not causal:
        pairs = s * t
    else:
        w = window or s  # row i sees min(i + 1, w) keys
        pairs = w * (w + 1) // 2 + (s - w) * w
    flops = 2.0 * pairs * (dqk + dv) * h * b
    nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + b * h * s * dv)
    t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def k4_long_call(arch, q, k, v, kw, label: str) -> dict:
    """K4 at one 32k call of a prefill, on that call's real q, k and v:
    ``k4_rows_gate`` (gated here), the kernel's event median, the plain
    version's (``plain_sliced_ms``), SDPA's where it takes the call (no
    window, no softcap), the bound; and the zigzag CP call over 16 ranks on
    the card on the same operands where the call takes that route."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention

    out = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    gate = k4_rows_gate(q, k, v, out, **kw)
    require(torch.equal(out, again), f"{arch}: K4 not bitwise repeatable at 32k ({label})")
    causal, window, softcap, scale = kw["causal"], kw["window"], kw["softcap"], kw["scale"]
    ms = median_ms(lambda: flash_attention(q, k, v, **kw), reps=3, warmup=1)
    plain_ms = plain_sliced_ms(q, k, v, **kw)
    lib_ms = None
    if window is None and softcap is None:
        lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale, enable_gqa=q.shape[1] != k.shape[1]),
            reps=3, warmup=1)
    bnd, by, flops, nbytes = k4_bound(q, k, v, causal, window)
    layout = (f"B={q.shape[0]} Hq={q.shape[1]} Hkv={k.shape[1]} S=T={q.shape[2]} q/k Dh="
              f"{q.shape[3]} v Dh={v.shape[3]}, {'causal' if causal else 'non-causal'}"
              + (f", window {window}" if window else "") + (f", softcap {softcap}" if softcap
                                                           else ""))
    print(f"K4 prefill_32k {arch} ({label}; {layout}) on its real activations against the "
          f"float32 plain version on rows {k4_blocks(q.shape[2])}: max|d| {gate['max_abs_err']:.3e}, "
          f"max|d| / ({K4_BF16_ATOL} + {K4_BF16_RTOL}|ref|) = {gate['f32_elem_ratio']:.3f} (at "
          f"most 1); largest 128-row tile ||d|| / ||ref|| = {gate['f32_tile_rms']:.3e} (at most "
          f"{K4_TILE_RMS}); planted fault ({gate['fault_keys']} keys dropped from the last 256 "
          f"rows) {gate['fault_tile_rms']:.3e}, {gate['fault_tile_rms'] / K4_TILE_RMS:.1f}x the "
          f"limit; "
          f"kernel {ms:.4f} ms, plain (a row and head at a time) {plain_ms:.3f} ms, SDPA "
          f"{_ms(lib_ms)}, bound {bnd:.4f} ms ({by}), {100 * bnd / ms:.1f}% of it, on "
          f"{card_line()}")
    require(gate["f32_elem_ratio"] <= 1.0 and gate["f32_tile_rms"] <= K4_TILE_RMS,
            f"{arch}: K4 disagrees with its float32 plain version at 32k ({label})")
    require(gate["fault_tile_rms"] > K4_TILE_RMS,
            f"{arch}: the 32k gate would pass dropped keys ({label})")
    row = dict(gate, layout=layout, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bnd, bound_by=by, flops=flops, bytes=nbytes)
    if arch in LONG_CP_ARCHS and causal and window is None:
        row["cp"] = cp_long_call(arch, q, k, v, softcap, scale, ms)
    return row


def k4_shape(dev, gen, b, hq, hkv, s, dh, window=None, softcap=None):
    """K4 at one bf16 causal prefill shape (S = T): agreement with the plain
    version and the library call, repeatability, times and bound.  With a
    window or softcap the library call (which takes neither) is causal
    attention at the same shape, a yardstick of time that is not compared."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_plain, flash_attention

    kw = dict(causal=True, window=window, softcap=softcap)
    same_fn = window is None and softcap is None
    q = _randn(gen, (b, hq, s, dh), dev, torch.bfloat16)
    k = _randn(gen, (b, hkv, s, dh), dev, torch.bfloat16)
    v = _randn(gen, (b, hkv, s, dh), dev, torch.bfloat16)
    out = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    plain = attention_plain(q, k, v, **kw) if b * hq * s * s <= K4_PLAIN_LOGITS else None
    torch.cuda.synchronize()
    ref = plain if plain is not None else lib
    err = (out.float() - ref.float()).abs().max().item()
    lib_err = ((lib.float() - ref.float()).abs().max().item()
               if plain is not None and same_fn else 0.0)
    tol = K4_TOL[torch.bfloat16]
    label = f"S={s} Dh={dh}" + ("" if same_fn else f" window={window} softcap={softcap}")
    require(err <= tol, f"K4 disagrees with its {'plain version' if plain is not None else 'library yardstick'} "
            f"at B={b} {label}: {err}")
    require(lib_err <= tol, f"K4 library yardstick disagrees at {label}: {lib_err}")
    require(torch.equal(out, again), f"K4 not bitwise repeatable at {label}")
    elem, rms, lib_rms, fault_rms = k4_gate_f32(q, k, v, out, lib if same_fn else None,
                                                window, softcap)
    print(f"K4 {label} against the float32 plain version on rows {k4_blocks(s)}: "
          f"max|d| / ({K4_BF16_ATOL} + {K4_BF16_RTOL}|ref|) = {elem:.3f} (at most 1); "
          f"largest 128-row tile ||d|| / ||ref|| = {rms:.3e} (library "
          f"{'not the same function' if lib_rms is None else f'{lib_rms:.3e}'}; "
          f"at most {K4_TILE_RMS}); planted fault (one key tile dropped from the last "
          f"256 rows) reads {fault_rms:.3e}, {fault_rms / K4_TILE_RMS:.1f}x the limit")
    require(elem <= 1.0, f"K4 disagrees with its float32 plain version at {label}: {elem}")
    require(rms <= K4_TILE_RMS, f"K4 tile error {rms} over {K4_TILE_RMS} at {label}")
    require(fault_rms > K4_TILE_RMS, f"K4 gate would pass a dropped key tile at {label}")
    reps = 30 if s <= 4096 else 5
    ms = median_ms(lambda: flash_attention(q, k, v, **kw), reps=reps)
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=reps)
    plain_ms = (median_ms(lambda: attention_plain(q, k, v, **kw), reps=5)
                if plain is not None else None)
    q_ms = queued_ms(lambda: flash_attention(q, k, v, **kw), reps=reps)
    lib_q_ms = queued_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=reps)
    host = host_us(lambda: flash_attention(q, k, v, **kw), reps=4 * reps)
    lib_host = host_us(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=4 * reps)
    bnd, by, flops, nbytes = k4_bound(q, k, v, True, window)
    row = {"shape": f"B={b} Hq={hq} Hkv={hkv} S=T={s} Dh={dh} bf16 causal"
                    + ("" if same_fn else f" window={window} softcap={softcap}"),
           "max_abs_err": err, "against": "plain" if ref is not lib else "library",
           "f32_elem_ratio": elem, "f32_tile_rms": rms, "fault_tile_rms": fault_rms,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_fn": ("scaled_dot_product_attention, causal, enable_gqa" if same_fn else
                          "scaled_dot_product_attention, causal, enable_gqa, no window or "
                          "softcap: not the same function, timed as a yardstick"),
           "queued_ms": q_ms, "library_queued_ms": lib_q_ms,
           "host_us_per_call": host, "library_host_us_per_call": lib_host,
           "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes,
           "fp32_cuda_core_ms": flops / FP32_FLOP_PER_S * 1e3}
    print(f"K4 {row['shape']}: max|kernel - {row['against']}| = {err:.3e} (tolerance "
          f"{tol}), |library - plain| = {lib_err:.3e}; run-to-run bitwise equal; "
          f"kernel {ms:.4f} ms, plain {plain_ms if plain_ms is None else round(plain_ms, 4)} ms, "
          f"library {lib_ms:.4f} ms{'' if same_fn else ' (causal only)'}, bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}; "
          f"fp32 CUDA cores {row['fp32_cuda_core_ms']:.4f} ms); queue full kernel "
          f"{q_ms:.4f} ms, library {lib_q_ms:.4f} ms; host issue "
          f"kernel {host:.1f} us, library {lib_host:.1f} us a call")
    return row


def attention_f32(q, k, v, causal, scale=None):
    """The float32 plain version of a bf16 attention call, a batch element at
    a time (the (S, T) logits of one element at once)."""
    from repro_torch.kernels.flash_attention import attention_plain

    return torch.cat([attention_plain(q[i:i + 1].float(), k[i:i + 1].float(),
                                      v[i:i + 1].float(), causal=causal, scale=scale)
                      for i in range(q.shape[0])])


def sdpa_backend(q, k, v, causal: bool) -> str:
    """The backend ``scaled_dot_product_attention`` dispatches these inputs
    to, as its own chooser (``torch._fused_sdp_choice``) names it."""
    from torch.nn.attention import SDPBackend

    choose = getattr(torch, "_fused_sdp_choice", None)
    if choose is None:
        return "not measured (no backend chooser in this PyTorch)"
    # a GQA call names enable_gqa, as the timed call passes it
    pick = choose(q, k, v, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])
    return next((name for name, b in SDPBackend.__members__.items() if int(b) == pick),
                str(pick))


def k4_native_shape(dev, gen, arch, b, h, s, dqk, dv, causal):
    """K4 at a native (Dqk, Dv) pair, at one layer's shapes (S = T, no
    GQA): one launch a call and no ``pad_head_dims`` call; against the
    float32 plain version per element (within K4_TOL for bf16) and per
    128-row query tile (K4_TILE_RMS), bitwise repeatable, and bitwise the
    same output when q, k and v are the first Dqk / Dv columns of 128-wide
    buffers whose other columns hold noise (the kernel reads only the true
    columns); two planted faults read in the same run must break the tile
    gate: the padded head dim's scale in place of the true one, and one key
    tile dropped from the last 256 rows; the padded route it replaced must
    give the native output bit for bit.  Times (event median and queue
    full): the native kernel; the padded route it replaced, on the same
    operands (``pad_head_dims`` and the kernel at the padded head dim,
    together, then the copies alone and the kernel alone); the float32
    plain version; SDPA at the true shapes with the backend it picked; the
    bound at the true head dims."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_plain, flash_attention,
                                                     kernel_info, kernel_pair, pad_head_dims,
                                                     padded_head_dim)

    dp = padded_head_dim(dqk, dv)
    label = f"{arch} layer: B={b} H={h} S=T={s} q/k Dh={dqk} v Dh={dv}"
    require(kernel_pair(dqk, dv, torch.bfloat16) == (dqk, dv),
            f"K4 {label}: not a native pair of the bf16 kernel")
    q = _randn(gen, (b, h, s, dqk), dev, torch.bfloat16)
    k = _randn(gen, (b, h, s, dqk), dev, torch.bfloat16)
    v = _randn(gen, (b, h, s, dv), dev, torch.bfloat16)
    # the same operands as the first columns of 128-wide buffers of noise
    wide = [_randn(gen, (b, h, s, 128), dev, torch.bfloat16) for _ in range(3)]
    for buf, x in zip(wide, (q, k, v)):
        buf[..., :x.shape[-1]] = x
    qw, kw, vw = wide[0][..., :dqk], wide[1][..., :dqk], wide[2][..., :dv]
    torch.cuda.synchronize()
    with PadCalls() as pads:
        before = flash_attention.launches
        out = flash_attention(q, k, v, causal=causal)
        again = flash_attention(q, k, v, causal=causal)
        junk = flash_attention(qw, kw, vw, causal=causal)
        launched = flash_attention.launches - before
    wrong_scale = flash_attention(q, k, v, causal=causal, scale=dp ** -0.5)
    ref = attention_f32(q, k, v, causal)
    torch.cuda.synchronize()
    require(launched == 3 and pads.calls == 0,
            f"K4 {label}: {launched} launches and {pads.calls} padding copies in 3 calls")
    require(out.shape == (b, h, s, dv), f"K4 {label}: output shape {tuple(out.shape)}")
    require(torch.equal(out, again), f"K4 not bitwise repeatable at {label}")
    require(torch.equal(junk, out), f"K4 {label}: views of 128-wide buffers give another "
            f"output than contiguous operands (max|d| {(junk.float() - out.float()).abs().max()})")
    err = (out.float() - ref).abs().max().item()
    rms = tile_rms(out, ref).max().item()
    scale_rms = tile_rms(wrong_scale, ref).max().item()
    bk = kernel_info(dqk, dv)["block_k"]
    first = s - 256
    d0 = (first // 2) // bk * bk
    qb = q[:, :, first:]
    fault = plain_rows(qb, k, v, first, drop=slice(d0, d0 + bk), causal=causal)
    drop_rms = tile_rms(fault, plain_rows(qb, k, v, first, causal=causal)).max().item()
    tol = K4_TOL[torch.bfloat16]
    print(f"K4 {label}, {'causal' if causal else 'non-causal'}, native: {launched} launches "
          f"and {pads.calls} padding copies in 3 calls; max|kernel - float32 plain| = "
          f"{err:.3e} (at most {tol}); largest 128-row tile ||d|| / ||ref|| = {rms:.3e} (at most "
          f"{K4_TILE_RMS}); planted faults: the padded head dim's scale {dp}**-0.5 reads "
          f"{scale_rms:.3e} ({scale_rms / K4_TILE_RMS:.1f}x the limit), one key tile dropped "
          f"from the last 256 rows {drop_rms:.3e} ({drop_rms / K4_TILE_RMS:.1f}x); run-to-run "
          f"bitwise equal; on views of 128-wide buffers of noise bitwise equal")
    require(err <= tol, f"K4 disagrees with its float32 plain version at {label}: {err}")
    require(rms <= K4_TILE_RMS, f"K4 tile error {rms} over {K4_TILE_RMS} at {label}")
    require(scale_rms > K4_TILE_RMS, f"K4 gate would pass the padded scale at {label}")
    require(drop_rms > K4_TILE_RMS, f"K4 gate would pass a dropped key tile at {label}")

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def padded_route():
        qp, kp, vp, true_scale, _ = pad_head_dims(q, k, v)
        return flash_attention(qp, kp, vp, causal=causal, scale=true_scale)[..., :dv]

    lib_err = (sdpa().float() - ref).abs().max().item()
    padded_out = padded_route()
    padded_same = torch.equal(padded_out, out)
    require(padded_same, f"K4 {label}: the padded route's output differs from the native "
            f"kernel's by max|d| {(padded_out.float() - out.float()).abs().max()}")
    ms = median_ms(lambda: flash_attention(q, k, v, causal=causal))
    q_ms = queued_ms(lambda: flash_attention(q, k, v, causal=causal))
    padded_ms = median_ms(padded_route)
    padded_q_ms = queued_ms(padded_route)
    pad_ms = median_ms(lambda: pad_head_dims(q, k, v))
    pad_q_ms = queued_ms(lambda: pad_head_dims(q, k, v))
    qp, kp, vp, true_scale, _ = pad_head_dims(q, k, v)  # the kernel alone, at Dp
    kernel_padded_q_ms = queued_ms(lambda: flash_attention(qp, kp, vp, causal=causal,
                                                           scale=true_scale))
    plain_ms = median_ms(lambda: attention_plain(q, k, v, causal=causal), reps=3)
    lib_ms = median_ms(sdpa)
    lib_q_ms = queued_ms(sdpa)
    backend = sdpa_backend(q, k, v, causal)
    bnd, by, flops, nbytes = k4_bound(q, k, v, causal, None)  # at the true head dims
    row = {"shape": f"{label}, bf16 {'causal' if causal else 'non-causal'}, native",
           "max_abs_err": err, "f32_tile_rms": rms, "fault_scale_tile_rms": scale_rms,
           "fault_drop_tile_rms": drop_rms, "junk_columns_bitwise": True,
           "launches_per_call": launched // 3, "padding_copies": pads.calls,
           "ms": ms, "queued_ms": q_ms,
           "padded_route_ms": padded_ms, "padded_route_queued_ms": padded_q_ms,
           "padded_route_bitwise_native": padded_same,
           "kernel_padded_queued_ms": kernel_padded_q_ms,
           "padding_ms": pad_ms, "padding_queued_ms": pad_q_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_queued_ms": lib_q_ms, "library_err": lib_err,
           "library_fn": f"scaled_dot_product_attention at the true head dims "
                         f"({'is_causal' if causal else 'no mask'}), backend {backend}",
           "bound_ms": bnd, "bound_by": by, "flops": flops, "bytes": nbytes}
    print(f"K4 {label}: native kernel {ms:.4f} ms, queue full {q_ms:.4f} ms; the padded route "
          f"it replaced (to {dp}) {padded_ms:.4f} ms, queue full {padded_q_ms:.4f} ms (padding "
          f"copies {pad_ms:.4f} / {pad_q_ms:.4f}, the kernel alone on padded operands "
          f"{kernel_padded_q_ms:.4f} queue full; output bitwise the native one: {padded_same}); "
          f"plain {plain_ms:.3f} ms; SDPA {lib_ms:.4f} ms, queue full {lib_q_ms:.4f} ms (backend "
          f"{backend}, max|SDPA - plain| {lib_err:.3e}); bound at the true head dims "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}: {flops / 1e9:.1f} GFLOP, "
          f"{nbytes / 1e6:.1f} MB)")
    return row


def k5_shape(dev, gen, b, s, h, g, p, n, chunk):
    """K5 at one mamba2 prefill shape: agreement, repeatability, a planted
    fault, times of the kernel and of the plain version, each pass's device
    time, and the bound."""
    from repro_torch.kernels.ssd_scan import ssd_plain, ssd_scan

    x = _randn(gen, (b, s, h, p), dev)
    a = -_randn(gen, (b, s, h), dev).abs() * 0.1
    bc = _randn(gen, (b, s, g, n), dev, scale=0.3)
    cc = _randn(gen, (b, s, g, n), dev, scale=0.3)
    y = ssd_scan(x, a, bc, cc, chunk=chunk)
    again = ssd_scan(x, a, bc, cc, chunk=chunk)
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick in full float32
    print(f"K5 plain version: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    plain = ssd_plain(x, a, bc, cc, chunk=chunk)
    # planted fault: the second half alone, without the state carried into it
    half = s // 2
    fault = ssd_plain(x[:, half:], a[:, half:], bc[:, half:], cc[:, half:], chunk=chunk)
    torch.cuda.synchronize()
    err = (y - plain).abs().max().item()
    fault_err = (fault - plain[:, half:]).abs().max().item()
    print(f"K5 S={s}: planted fault (no state across the midpoint) reads "
          f"{fault_err:.3e}, {fault_err / K5_TOL:.1f}x the tolerance {K5_TOL}; the kernel "
          f"reads {err:.3e}, {K5_TOL / max(err, 1e-30):.1f}x below it")
    require(err <= K5_TOL, f"K5 disagrees with its plain version at S={s}: {err}")
    require(torch.equal(y, again), f"K5 not bitwise repeatable at S={s}")
    require(fault_err > K5_TOL, f"K5 gate would pass a dropped state at S={s}")
    ms = median_ms(lambda: ssd_scan(x, a, bc, cc, chunk=chunk))
    plain_ms = median_ms(lambda: ssd_plain(x, a, bc, cc, chunk=chunk), reps=5)
    traced = {kernel_name(r[2]): r[0] / 1e3
              for r in prof_call(f"K5 S={s}", lambda: ssd_scan(x, a, bc, cc, chunk=chunk))}
    passes = {name: traced.get(name) for name in K5_PASSES}  # None: lost by the trace
    nc = s // chunk
    live = chunk * (chunk + 1) // 2  # s <= t pairs of a chunk
    # C B^T counted once per group; the rest per head
    flops = (b * h * nc * (2.0 * live * p + 4.0 * chunk * p * n)
             + b * g * nc * 2.0 * live * n)
    nbytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * g * n)
    t_ops = K5_TF32_PRODUCTS * flops / TF32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"shape": f"B={b} S={s} H={h} G={g} P={p} N={n} chunk={chunk} f32",
           "max_abs_err": err, "max_abs_plain": plain.abs().max().item(),
           "fault_err": fault_err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "pass_device_ms": passes,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flops": flops, "bytes": nbytes,
           "fp32_cuda_core_ms": flops / FP32_FLOP_PER_S * 1e3}
    print(f"K5 {row['shape']}: max|kernel - plain| = {err:.3e} (tolerance {K5_TOL}, "
          f"max|plain| {row['max_abs_plain']:.3f}); run-to-run bitwise equal; kernel "
          f"{ms:.4f} ms (3xTF32 tensor cores; device time a pass: "
          f"{', '.join(f'{k} {_ms(v)}' for k, v in passes.items())}), plain "
          f"{plain_ms:.4f} ms, library none (no single call), bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']}; {flops / 1e9:.2f} GFLOP as "
          f"{K5_TF32_PRODUCTS} TF32 products at {TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s "
          f"{t_ops:.5f} ms, bytes {t_bytes:.5f} ms; float32 CUDA cores "
          f"{row['fp32_cuda_core_ms']:.4f} ms)")
    return row


def phase_lm_kernels(dev):
    """Phase 6: K4 and K5 against their plain versions at the LM shapes."""
    from repro_torch.kernels.flash_attention import (NATIVE_PAIRS, attention_plain,
                                                     flash_attention, kernel_info)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    k4_rows = [k4_shape(dev, gen, *shape) for shape in K4_SHAPES]
    f32_err = 0.0
    for b, hq, hkv, s, t, dh, causal, window, cap in K4_F32_CASES:
        q = _randn(gen, (b, hq, s, dh), dev)
        k = _randn(gen, (b, hkv, t, dh), dev)
        v = _randn(gen, (b, hkv, t, dh), dev)
        kw = dict(causal=causal, window=window, softcap=cap)
        out, again = flash_attention(q, k, v, **kw), flash_attention(q, k, v, **kw)
        err = (out - attention_plain(q, k, v, **kw)).abs().max().item()
        print(f"K4 f32 B={b} Hq={hq} Hkv={hkv} S={s} T={t} Dh={dh} {kw}: "
              f"max|kernel - plain| = {err:.3e} (tolerance {K4_TOL[torch.float32]})")
        require(err <= K4_TOL[torch.float32], f"K4 f32 case {kw} S={s} T={t} disagrees")
        require(torch.equal(out, again), "K4 f32 not bitwise repeatable")
        f32_err = max(f32_err, err)
    k4_rows.append(k4_shape(dev, gen, 1, 9, 3, PREFILL_32K, 64))
    k4_rows.append(k4_shape(dev, gen, *K4_DH128))
    b, hq, hkv, s, dh, window, cap = K4_GEMMA_LOCAL
    k4_rows.append(k4_shape(dev, gen, b, hq, hkv, s, dh, window=window, softcap=cap))
    for dqk, dv in NATIVE_PAIRS:
        info = kernel_info(dqk, dv)
        print(f"K4 bf16 kernel, q/k head dim {dqk}, v head dim {dv}: {info['registers']} "
              f"registers a thread, {info['shared_bytes']} bytes of dynamic shared memory, "
              f"{info['local_bytes']} bytes of local memory a thread, "
              f"{info['threads']} threads a CTA, {info['block_k']} keys a K/V tile")
        if (dqk, dv) in K4_SQUARE_INFO:
            require((info["registers"], info["shared_bytes"]) == K4_SQUARE_INFO[(dqk, dv)],
                    f"K4 ({dqk}, {dv}): registers and shared bytes moved from "
                    f"{K4_SQUARE_INFO[(dqk, dv)]}")
        else:
            require(info["local_bytes"] == 0 and info["registers"] <= 168,
                    f"K4 ({dqk}, {dv}) spills or launches above 168 registers: {info}")
    for arch, shape in K4_MODEL_LAYOUTS.items():
        k4_rows.append(dict(k4_shape(dev, gen, *shape), model=arch))
    k5_rows = [k5_shape(dev, gen, *shape) for shape in K5_SHAPES]
    native_rows = {arch: k4_native_shape(dev, gen, arch, *shape)
                   for arch, shape in K4_NATIVE.items()}
    return k4_rows, f32_err, k5_rows, native_rows


def launches_per_forward(cfg) -> dict:
    """K4 and K5 launches one cache-less forward makes: one per attention
    (``attn`` / ``local`` / ``mla``) or ``ssm`` mixer of the block pattern,
    per group."""
    def count(kinds):
        return cfg.num_groups * sum(mixer in kinds for mixer, _ in cfg.block_pattern)
    return {"flash_attention": count(("attn", "local", "mla")), "ssd_scan": count(("ssm",))}


def _lm(arch, dev):
    """A full-width model and its seeded weights; jamba-v0.1-52b cut to its
    first block-pattern group (``LM_DEPTH_CUT``), which alone fits the card
    (the init's depth scale of the output projections follows the cut)."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config(arch)
    if arch in LM_DEPTH_CUT:
        cfg = dataclasses.replace(cfg, num_layers=LM_DEPTH_CUT[arch])
    model = LM(cfg, device=dev)
    return model, model.init(SEED)


def phase_lm_serving(dev, model, params):
    """Phase 7: the continuous-batching engine on full-width smollm-135m."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.serve import serve

    vocab = model.cfg.vocab_size
    runs = []
    for _ in range(2):
        flash_attention.launches = ssd_scan.launches = 0
        done, secs, _ = serve(model.cfg.name, device=str(dev), params=params)
        toks = sum(len(v) for v in done.values())
        runs.append(done)
        print(f"serve {model.cfg.name}: {len(done)} requests, {toks} tokens in "
              f"{secs * 1e3:.1f} ms ({toks / secs:.1f} tok/s, a smoke reading, not a "
              "load); K4 launches "
              f"{flash_attention.launches}, K5 launches {ssd_scan.launches} "
              "(the engine decodes token by token: no kernel)")
    done = runs[0]
    require(sorted(done) == list(range(6)), f"served {sorted(done)} of 6 requests")
    require(all(len(v) == 8 for v in done.values()), "a request got fewer than 8 tokens")
    require(all(0 <= t < vocab for v in done.values() for t in v), "token beyond the vocab")
    require(runs[0] == runs[1], "two serving runs gave different tokens")
    print(f"serve tokens: {done}")


def cut_depth(model, params, layers: int):
    """The model cut to its first ``layers`` layers, rounded up to whole
    block-pattern groups, on the full model's weights (views of the stacked
    groups)."""
    return group_slice(model, params, 0, -(-layers // len(model.cfg.block_pattern)))


def group_slice(model, params, start: int, stop: int):
    """The model cut to its block-pattern groups ``start`` to ``stop`` on the
    full model's weights (views of the stacked groups)."""
    from repro_torch.models import LM

    def cut(tree):
        return ({k: cut(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree[start:stop])

    cfg = dataclasses.replace(model.cfg,
                              num_layers=(stop - start) * len(model.cfg.block_pattern))
    return LM(cfg, device=model.device), dict(params, blocks=[cut(b) for b in params["blocks"]])


def prefill_vs_decode(model, params, prompt, label: str, decode_params=None,
                      profile: bool = False):
    """max |last-position logits of the prefill - of the token-by-token
    decode| over the real vocab, and the prefill's and the decode's last
    logits; checks that decoding launches no kernel.  ``decode_params``
    (default ``params``) are the weights the decode runs with; ``profile``
    profiles one more decode step."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    cfg = model.cfg
    b, s = prompt.shape
    pre = model.forward(params, prompt, last_only=True)[0][:, 0]
    cache = model.init_cache(b, s)
    flash_attention.launches = ssd_scan.launches = 0
    t0 = time.perf_counter()
    for i in range(s):
        step, cache, _ = model.forward(decode_params or params, prompt[:, i:i + 1],
                                       cache=cache, cache_pos=i)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3 / s
    v = cfg.vocab_size
    err = (step[:, 0, :v] - pre[:, :v]).abs().max().item()
    print(f"prefill vs decode {cfg.name} ({label}, {cfg.num_layers} layers): B={b} S={s}, "
          f"max|decode - prefill| of the last logits = {err:.4e} (tolerance "
          f"{LM_LOGIT_TOL}), max|logit| {pre[:, :v].abs().max().item():.4f}; decode "
          f"{dec_ms:.3f} ms per token step (a smoke reading); kernel launches while "
          f"decoding: K4 {flash_attention.launches}, K5 {ssd_scan.launches}")
    require(flash_attention.launches == 0 and ssd_scan.launches == 0,
            "the decode path launched a prefill kernel")
    if profile:  # rewrites the last position with the same token
        prof_call(f"{cfg.name} decode step B={b}", lambda: model.forward(
            params, prompt[:, -1:], cache=cache, cache_pos=s - 1))
    return err, pre, step[:, 0]


def printed_decode(model, params, prompt):
    """``prefill_vs_decode`` at full depth, profiled, or at
    ``PRINTED_DECODE_LAYERS`` for the stacks whose full depth is only
    printed and takes too long."""
    layers = PRINTED_DECODE_LAYERS.get(model.cfg.name)
    if layers is None:
        return prefill_vs_decode(model, params, prompt, "full depth", profile=True)
    return prefill_vs_decode(*cut_depth(model, params, layers), prompt,
                             "printed cut", profile=True)


def prefill_with(model, params, prompt, attention):
    """Last-position logits of a prefill whose attention calls
    ``attention`` in place of K4; ``prompt`` is token ids or a dict of
    ``forward``'s inputs."""
    from repro_torch.kernels import ops

    inputs = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    kernel = ops.flash_attention
    ops.flash_attention = attention
    try:
        return model.forward(params, last_only=True, **inputs)[0][:, 0]
    finally:
        ops.flash_attention = kernel


def sdpa_attention(q, k, v, causal=True, window=None, softcap=None, scale=None):
    """``scaled_dot_product_attention`` in place of K4, a bf16 flash
    attention independent of the port's, at the same scale: a yardstick of
    how far a model's bf16 prefill moves when only its attention's rounding
    changes.  It takes no window or softcap."""
    import torch.nn.functional as F

    if window is not None or softcap is not None:
        raise ValueError("the SDPA yardstick takes no window or softcap")
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal, scale=scale,
                                          enable_gqa=q.shape[1] != k.shape[1])


def dropped_tile_attention(every_call: bool = False):
    """K4 with a planted fault in its first call (``every_call``: in each
    call): the rows of the second half lose one key tile (of the kernel's
    width) from the middle of the first half, the fault a wrong tile plan
    would make."""
    from repro_torch.kernels.flash_attention import (flash_attention, kernel_info,
                                                     kernel_pair)

    calls = []

    def attention(q, k, v, causal=True, window=None, softcap=None, scale=None):
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                              scale=scale)
        if every_call or not calls:
            s = q.shape[2]
            bk = kernel_info(*kernel_pair(q.shape[3], v.shape[3], q.dtype))["block_k"]
            first = s // 2
            d0 = first // 2 // bk * bk
            out = out.clone()
            out[:, :, first:] = plain_rows(q[:, :, first:], k, v, first, window, softcap,
                                           drop=slice(d0, d0 + bk), causal=causal,
                                           scale=scale).to(out.dtype)
        calls.append(q.shape)
        return out

    return attention


def phase_lm_prefill(dev, models):
    """Phase 8: full-width prefill through K4 / K5, and prefill vs decode."""
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan

    gen = torch.Generator(device=dev).manual_seed(SEED)
    launches = {}
    for arch, (model, params) in models.items():
        cfg = model.cfg
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ), generator=gen,
                               device=dev)
        torch.cuda.synchronize()
        flash_attention.launches = ssd_scan.launches = 0
        outs, lat = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            outs.append(model.forward(params, tokens, last_only=True)[0])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        counts = {"flash_attention": flash_attention.launches,
                  "ssd_scan": ssd_scan.launches}
        launches[arch] = counts
        per = launches_per_forward(cfg)
        print(f"prefill {arch}: B={LM_BATCH} S={LM_SEQ}, launches over 2 forwards "
              f"{counts}; forward ms {['%.3f' % x for x in lat]} "
              f"({LM_BATCH * LM_SEQ / (min(lat) / 1e3):.0f} tokens/s); logits "
              f"{tuple(outs[0].shape)}, max|logit| "
              f"{outs[0][..., :cfg.vocab_size].abs().max().item():.4f}")
        for name, n in per.items():
            require(counts[name] == 2 * n, f"{arch}: {name} launched {counts[name]} "
                    f"times in 2 forwards, want {2 * n}")
        require(bool(torch.isfinite(outs[0][..., :cfg.vocab_size]).all()),
                f"{arch}: non-finite logits")
        require(torch.equal(outs[0], outs[1]), f"{arch}: logits differ between forwards")
        rows = prof_call(f"{arch} prefill B={LM_BATCH} S={LM_SEQ}",
                         lambda: model.forward(params, tokens, last_only=True))
        busy = sum(r[0] for r in rows)
        for label, key in (("K4", "fa_forward"), ("K5", "ssd_")):  # K5: its four passes
            mine = [r for r in rows if key in r[2]]
            us = sum(r[0] for r in mine)
            if us and busy:
                print(f"profile {arch} prefill: {label} {us / 1e3:.3f} ms, "
                      f"{100 * us / busy:.1f}% of the device time, over "
                      f"{sum(r[1] for r in mine)} launches")
                if label == "K5":
                    traced = {kernel_name(r[2]): r for r in mine}
                    for name in K5_PASSES:
                        r = traced.get(name)
                        print(f"  K5 {name}: " + ("not measured (not in the trace)"
                              if r is None else f"{r[0] / 1e3:.3f} ms x{r[1]}, "
                              f"{100 * r[0] / busy:.1f}% of the device time"))

    for arch, (model, params) in models.items():
        cfg = model.cfg
        prompt = torch.randint(0, cfg.vocab_size, (DECODE_BATCH, DECODE_SEQ),
                               generator=gen, device=dev)
        err, pre, dec = printed_decode(model, params, prompt)
        if any(mixer == "ssm" for mixer, _ in cfg.block_pattern):
            err, _, _ = prefill_vs_decode(*cut_depth(model, params, SSM_DECODE_GATE_LAYERS),
                                          prompt, "gated cut")
            require(err <= LM_LOGIT_TOL, f"{arch}: prefill and decode logits differ by {err}")
            continue
        v = cfg.vocab_size
        tol = DECODE_LOGIT_TOL.get(arch, LM_LOGIT_TOL)
        control = prefill_with(model, params, prompt, attention_plain)[:, :v]
        fault = prefill_with(model, params, prompt, dropped_tile_attention())[:, :v]
        plain_err = (dec[:, :v] - control).abs().max().item()
        k4_err = (pre[:, :v] - control).abs().max().item()
        fault_err = (fault - control).abs().max().item()
        print(f"prefill vs decode {arch} (full depth, tolerance {tol}; control: prefill "
              f"attention by the float32 plain version in place of K4, max|logit| "
              f"{control.abs().max().item():.4f}): max|decode - control| = "
              f"{plain_err:.4e}; max|K4 prefill - control| = {k4_err:.4e}; planted "
              f"fault (one key tile dropped in the first K4 call) max|fault - control| = "
              f"{fault_err:.4e}, {fault_err / tol:.1f}x the tolerance, the K4 readings "
              f"{tol / max(err, k4_err):.2f}x below it")
        require(err <= tol, f"{arch}: prefill and decode logits differ by {err}")
        require(k4_err <= tol,
                f"{arch}: K4's prefill and the plain attention's differ by {k4_err}")
        require(fault_err > tol, f"{arch}: the decode gate would pass a dropped key tile")
    return launches


def lm_inputs(model, params, gen, b, s) -> dict:
    """Seeded ``forward`` inputs of one arch at (B, S): token ids; for the
    audio stub (hubert) random frame embeddings; for the vision stub
    (qwen2-vl) the embedding rows of random tokens and a ``pos3`` grid of
    16 x 16 patches per frame whose temporal, height and width components
    all differ."""
    cfg = model.cfg
    dev = model.device
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    if cfg.frontend == "none":
        return {"tokens": tokens}
    if cfg.mrope_sections is None:
        return {"embeds": torch.randn((b, s, cfg.d_model), generator=gen, device=dev)}
    i = torch.arange(s, device=dev)
    grid = torch.stack([i // 256, (i // 16) % 16, i % 16])
    return {"embeds": params["embed"][tokens], "pos3": grid[:, None].expand(3, b, s)}


def spanned_profile(label: str, fn, spans, warm: bool = True) -> dict:
    """Device time of one warm call of ``fn`` (torch.profiler), in total,
    in K4 (``fa_forward``) and in each of ``spans`` ((label, module,
    attribute) wrapped in a ``record_function`` range for the run; a
    range's device time is that of the kernels launched inside it; ``warm``
    runs ``fn`` once first, for a call already warm).  With
    an ``ffn`` span (``moe_ffn``), ``build`` is its time outside the other
    spans: building the dispatch and combine tensors."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def labelled(name, f):
        def run(*args, **kwargs):
            with record_function(f"span::{name}"):
                return f(*args, **kwargs)
        return run

    saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in spans]
    for (name, mod, attr), (_, _, f) in zip(spans, saved):
        setattr(mod, attr, labelled(name, f))
    try:
        if warm:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)
    rows = [r for r in _device_events(prof) if not r[2].startswith("span::")]
    busy = sum(r[0] for r in rows) / 1e3
    k4 = [r for r in rows if "fa_forward" in r[2]]
    k5 = [r for r in rows if kernel_name(r[2]).split("<")[0] in K5_PASSES]
    out = {"wall_ms": wall, "busy_ms": busy, "k4_ms": sum(r[0] for r in k4) / 1e3,
           "k5_ms": sum(r[0] for r in k5) / 1e3,
           "k4_launches_traced": sum(r[1] for r in k4), "launches": sum(r[1] for r in rows)}
    for name, _, _ in spans:
        evs = [e for e in prof.events() if e.name == f"span::{name}"
               and "CPU" in str(getattr(e, "device_type", ""))]
        out[name + "_ms"] = sum(e.device_time_total for e in evs) / 1e3
        out[name + "_calls"] = len(evs)
    if "ffn_ms" in out:  # what moe_ffn does outside its inner spans: the dispatch tensors
        out["build_ms"] = out["ffn_ms"] - sum(out[n + "_ms"] for n in
                                              ("route", "dispatch", "experts", "combine"))
        out["build_calls"] = out["ffn_calls"]
        spans = spans + [("build", None, None)]
    share = ", ".join(f"{name} {out[name + '_ms']:.3f} ms ({100 * out[name + '_ms'] / busy:.1f}%, "
                      f"{out[name + '_calls']} calls)" for name, _, _ in spans) if busy else ""
    print(f"profile {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f}% of wall), {out['launches']} kernel launches; K4 "
          + (f"{out['k4_ms']:.3f} ms, {100 * out['k4_ms'] / busy:.1f}% of the device time over "
             f"{out['k4_launches_traced']} launches recorded" if busy else "not measured")
          + (f"; {share}" if share else ""))
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")
    return out


def logit_tol(logits) -> float:
    """Phase 8b's logit tolerance: LM_LOGIT_TOL, or two bf16 steps at the
    logits' largest magnitude where that is wider (the logits are a bf16
    product; at |logit| in [8, 16) one step is 0.0625)."""
    top = logits.abs().max().item()
    return max(LM_LOGIT_TOL, 2 * 2.0 ** (math.floor(math.log2(top)) - 7)) if top else LM_LOGIT_TOL


def control_readings(model, params, prompt, label: str) -> dict:
    """Last-position logits of a prefill through K4, through the float32
    plain attention (the control), through SDPA (an independent bf16 flash
    attention, a yardstick of rounding drift) and through K4 with a key
    tile dropped in every call (a planted fault): each one's distance to
    the control, and ``logit_tol`` of the control."""
    from repro_torch.kernels.flash_attention import attention_plain

    v = model.cfg.vocab_size
    pre = model.forward(params, last_only=True, **prompt)[0][:, 0, :v]
    control = prefill_with(model, params, prompt, attention_plain)[:, :v]
    sdpa = prefill_with(model, params, prompt, sdpa_attention)[:, :v]
    fault = prefill_with(model, params, prompt, dropped_tile_attention(every_call=True))[:, :v]
    r = {"k4": (pre - control).abs().max().item(), "sdpa": (sdpa - control).abs().max().item(),
         "fault": (fault - control).abs().max().item(), "tol": logit_tol(control),
         "max_logit": control.abs().max().item(), "layers": model.cfg.num_layers}
    b, s = next(iter(prompt.values())).shape[:2]
    print(f"prefill vs control {model.cfg.name} ({label}, {r['layers']} layers, B={b} S={s} from "
          f"{'+'.join(sorted(prompt))}; control: attention by the float32 plain version in place "
          f"of K4, max|logit| {r['max_logit']:.4f}, tolerance {r['tol']:.4f}): max|K4 prefill - "
          f"control| = {r['k4']:.4e}; SDPA in place of K4 (yardstick) {r['sdpa']:.4e}; planted "
          f"fault (a key tile dropped in every K4 call) {r['fault']:.4e}, "
          f"{r['fault'] / r['tol']:.1f}x the tolerance")
    return r


def without_k_r(params) -> dict:
    """MLA weights with the rope key projection ``w_kr`` zeroed: run by the
    absorbed decode, whose cache then holds ``k_r = 0``, they leave the
    ``q_r k_r`` term out of its logits (a planted fault)."""
    def block(b):
        m = b["mixer"]
        return dict(b, mixer=dict(m, w_kr=torch.zeros_like(m["w_kr"]))) if "w_kr" in m else b
    return dict(params, blocks=[block(b) for b in params["blocks"]])


class K4Capture:
    """While open, keeps clones of the q, k, v and keywords of K4 calls
    ``indices`` (in call order) of the ``ops.flash_attention`` calls made."""

    def __init__(self, indices):
        self.indices, self.seen, self.calls = tuple(indices), {}, 0

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.kernel = ops, ops.flash_attention

        def capture(q, k, v, causal=True, window=None, softcap=None, scale=None):
            if self.calls in self.indices:
                self.seen[self.calls] = (q.clone(), k.clone(), v.clone(), dict(
                    causal=causal, window=window, softcap=softcap, scale=scale))
            self.calls += 1
            return self.kernel(q, k, v, causal=causal, window=window, softcap=softcap,
                               scale=scale)

        ops.flash_attention = capture
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention = self.kernel


class SSDCapture:
    """While open, keeps clones of the first ``ops.ssd_scan`` call's operands."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.kernel, self.seen = ops, ops.ssd_scan, None

        def capture(x, a, b, c, chunk=64):
            if self.seen is None:
                self.seen = (x.clone(), a.clone(), b.clone(), c.clone(), chunk)
            return self.kernel(x, a, b, c, chunk=chunk)

        ops.ssd_scan = capture
        return self

    def __exit__(self, *exc):
        self.ops.ssd_scan = self.kernel


def k4_at_activations(model, params, inputs) -> dict:
    """K4's first call of a full-width prefill rerun on that call's own q,
    k and v (the first attention or MLA layer's real activations, at the
    layout, strides, head dims and scale the model gives it): against the
    float32 plain version per element (``|d| / (K4_BF16_ATOL + K4_BF16_RTOL
    |ref|)`` at most 1) and per 128-row query tile (K4_TILE_RMS); one key
    tile dropped from the last 256 rows (a planted fault, read in the same
    run) must break the tile gate.  The layer's attention output is read
    before the residual stream dilutes it, as hubert's N(0, 1) frames do in
    its logits."""
    from repro_torch.kernels.flash_attention import (flash_attention, kernel_info,
                                                     kernel_pair)

    with K4Capture((0,)) as cap:
        model.forward(params, last_only=True, **inputs)
    q, k, v, kw = cap.seen[0]
    name = model.cfg.name
    require(kw["window"] is None and kw["softcap"] is None,
            f"{name}: the activation gate takes no window or softcap")
    causal, scale = kw["causal"], kw["scale"]
    out = flash_attention(q, k, v, causal=causal, scale=scale)
    ref = attention_f32(q, k, v, causal, scale)
    torch.cuda.synchronize()
    elem = ((out.float() - ref).abs() / (K4_BF16_ATOL + K4_BF16_RTOL * ref.abs())).max().item()
    err = (out.float() - ref).abs().max().item()
    rms = tile_rms(out, ref).max().item()
    s = q.shape[2]
    bk = kernel_info(*kernel_pair(q.shape[3], v.shape[3], q.dtype))["block_k"]
    first = s - 256
    d0 = first // 2 // bk * bk
    qb = q[:, :, first:]
    fault = plain_rows(qb, k, v, first, drop=slice(d0, d0 + bk), causal=causal, scale=scale)
    drop_rms = tile_rms(fault, plain_rows(qb, k, v, first, causal=causal,
                                          scale=scale)).max().item()
    layout = (f"B={q.shape[0]} Hq={q.shape[1]} Hkv={k.shape[1]} S=T={s} q/k Dh={q.shape[3]} "
              f"v Dh={v.shape[3]}, {'causal' if causal else 'non-causal'}, scale "
              f"{q.shape[3] ** -0.5 if scale is None else scale:.6f}")
    print(f"K4 at {name}'s first attention call of the prefill, on its real activations "
          f"({layout}; q strides {q.stride()}): max|kernel - float32 plain| = {err:.3e}, "
          f"max|d| / ({K4_BF16_ATOL} + {K4_BF16_RTOL}|ref|) = {elem:.3f} (at most 1), max|ref| "
          f"{ref.abs().max().item():.4f}; largest 128-row tile ||d|| / ||ref|| = {rms:.3e} "
          f"(at most {K4_TILE_RMS}); planted fault (one key tile dropped from the last 256 "
          f"rows) {drop_rms:.3e}, {drop_rms / K4_TILE_RMS:.1f}x the limit")
    require(elem <= 1.0, f"{name}: K4 disagrees with its float32 plain version on the "
            f"prefill's activations: {elem}")
    require(rms <= K4_TILE_RMS, f"{name}: K4 tile error {rms} on the prefill's activations")
    require(drop_rms > K4_TILE_RMS,
            f"{name}: the activation gate would pass a dropped key tile")
    return {"layout": layout, "max_abs_err": err, "f32_elem_ratio": elem, "f32_tile_rms": rms,
            "fault_drop_tile_rms": drop_rms}


def padded_route_gate(model, params, inputs) -> dict:
    """A full-width prefill with K4 at its native (Dqk, Dv) pair must give
    the same logits bit for bit as the same prefill on the padded route K4
    took before (``PaddedRoute``: q, k and v zero-padded to 128, the true
    scale): a k16 step over zero columns adds exact zeros to the float32
    accumulator and an output column of P V does not depend on N.  The
    padded forward must copy once for each K4 call."""
    native = model.forward(params, last_only=True, **inputs)[0]
    with PaddedRoute(), PadCalls() as pads:
        padded = model.forward(params, last_only=True, **inputs)[0]
    torch.cuda.synchronize()
    same = torch.equal(native, padded)
    gap = (native.float() - padded.float()).abs().max().item()
    calls = launches_per_forward(model.cfg)["flash_attention"]
    print(f"K4 padded-route gate {model.cfg.name} (B={LM_BATCH} S={LM_SEQ}): the native "
          f"(Dqk, Dv) prefill's logits bitwise the padded route's ({pads.calls} padding copies "
          f"for {calls} K4 calls): {same} (max|d| {gap:.4e})")
    require(pads.calls == calls, f"{model.cfg.name}: the padded route made {pads.calls} "
            f"padding copies in a forward of {calls} K4 calls")
    require(same, f"{model.cfg.name}: the native (Dqk, Dv) prefill's logits differ from the "
            f"padded route's by max|d| {gap:.4e}")
    return {"padded_copies_per_forward": pads.calls, "logits_bitwise": same,
            "logits_max_abs_diff": gap}


def moe_gate(model, params, inputs) -> dict:
    """The first MoE layer of a full-width prefill at its real activations:
    ``moe_ffn`` on the card against its float32 per-token plain version
    (``moe_plain`` over the router's own slots), within MOE_TOL; a fault
    planted in the same run (the output of the expert most tokens pick
    first zeroed in the combine) must read above it."""
    from repro_torch.models import layers

    seen = []
    moe_ffn = layers.moe_ffn

    def capture(p, x, **kw):
        if not seen:
            seen.append((p, x.clone(), kw))
        return moe_ffn(p, x, **kw)

    layers.moe_ffn = capture
    try:
        model.forward(params, last_only=True, **inputs)
    finally:
        layers.moe_ffn = moe_ffn
    p, x, kw = seen[0]
    d = x.shape[-1]
    out, terms = moe_ffn(p, x, **kw)
    aux = layers.moe_aux(*terms)
    route = layers.moe_route(p, x.reshape(-1, kw["group_size"], d),
                             num_experts=kw["num_experts"], top_k=kw["top_k"])
    plain = layers.moe_plain(p, x, route)
    top = int(torch.bincount(route["idx"][..., 0].reshape(-1),
                             minlength=kw["num_experts"]).argmax())
    combine = layers.moe_combine
    layers.moe_combine = lambda comb, ye: combine(comb, ye.index_fill(
        1, torch.tensor([top], device=ye.device), 0))
    try:
        fault, _ = moe_ffn(p, x, **kw)
    finally:
        layers.moe_combine = combine
    torch.cuda.synchronize()
    err = (out.float() - plain).abs().max().item()
    fault_err = (fault.float() - plain).abs().max().item()
    top_plain = plain.abs().max().item()
    tok_rms = ((out.float() - plain).norm(dim=-1) / plain.norm(dim=-1)).max().item()
    kept = int(route["keep"].sum())
    slots = x.shape[0] * x.shape[1] * kw["top_k"]
    ms = median_ms(lambda: moe_ffn(p, x, **kw), reps=10)
    plain_ms = median_ms(lambda: layers.moe_plain(p, x, route), reps=3)
    name = model.cfg.name
    print(f"MoE {name} layer 0 at the prefill's activations: {x.shape[0] * x.shape[1]} tokens "
          f"in groups of {kw['group_size']}, capacity {route['cap']}, {kept} of {slots} "
          f"(token, slot)s kept; aux {float(aux):.6f}; max|moe_ffn - float32 plain| = "
          f"{err:.3e}, {err / top_plain:.3e} of max|plain| {top_plain:.4f} (tolerance "
          f"{MOE_TOL} for both; largest per-token ||d|| / ||plain|| {tok_rms:.3e}); planted "
          f"fault (expert {top}'s output zeroed in the combine) reads {fault_err:.3e}, "
          f"{fault_err / top_plain:.3e} of max|plain|, {fault_err / MOE_TOL:.1f}x the "
          f"tolerance; moe_ffn {ms:.3f} ms, plain {plain_ms:.3f} ms a layer")
    require(max(err, err / top_plain) <= MOE_TOL,
            f"{name}: moe_ffn differs from its plain version by {err} (max|plain| {top_plain})")
    require(min(fault_err, fault_err / top_plain) > MOE_TOL,
            f"{name}: the MoE gate would pass a zeroed expert ({fault_err})")
    return {"err": err, "fault_err": fault_err, "ms": ms, "plain_ms": plain_ms}


def phase_lm_new(dev, arch, model, params, card: str) -> dict:
    """Phase 8b on one full-width model of the families ported last:
    prefill launches, repeatability and aux; its gates (MoE layer, K4
    against the float32 control, absorbed MLA decode, M-RoPE); a profile."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention_plain, flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import layers

    t_phase = time.perf_counter()
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cut = (f"; depth cut to {cfg.num_layers} of {get_config(arch).num_layers} layers (one "
           "block-pattern group: the full model's bf16 weights exceed the card)"
           if arch in LM_DEPTH_CUT else "")
    inputs = lm_inputs(model, params, gen, LM_BATCH, LM_SEQ)
    torch.cuda.synchronize()
    flash_attention.launches = ssd_scan.launches = 0
    outs, auxes, lat = [], [], []
    with PadCalls() as pads:
        for _ in range(2):
            t0 = time.perf_counter()
            logits, _, aux = model.forward(params, last_only=True, **inputs)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            outs.append(logits)
            auxes.append(aux)
    counts = {"flash_attention": flash_attention.launches, "ssd_scan": ssd_scan.launches}
    per = launches_per_forward(cfg)
    v = cfg.vocab_size
    print(f"prefill {arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, from "
          f"{'+'.join(sorted(inputs))}{cut}): B={LM_BATCH} S={LM_SEQ}, launches over 2 forwards "
          f"{counts} (want {({k: 2 * n for k, n in per.items()})}); forward ms "
          f"{['%.3f' % x for x in lat]} ({LM_BATCH * LM_SEQ / (min(lat) / 1e3):.0f} tokens/s); "
          f"logits {tuple(outs[0].shape)}, max|logit| {outs[0][..., :v].abs().max().item():.4f}; "
          f"aux {float(auxes[0]):.6f}; K4 padding copies {pads.calls} ({card})")
    require(pads.calls == 0, f"{arch}: the prefill made {pads.calls} padding copies: every "
            f"K4 call should run at its own head dims")
    for name, n in per.items():
        require(counts[name] == 2 * n, f"{arch}: {name} launched {counts[name]} times in 2 "
                f"forwards, want {2 * n}")
    require(bool(torch.isfinite(outs[0][..., :v]).all()), f"{arch}: non-finite logits")
    require(torch.equal(outs[0], outs[1]), f"{arch}: logits differ between forwards")
    require(torch.equal(auxes[0], auxes[1]), f"{arch}: aux differs between forwards")
    if cfg.num_experts:
        require(bool(torch.isfinite(auxes[0])) and float(auxes[0]) > 0,
                f"{arch}: MoE aux {float(auxes[0])} not finite and positive")
    out = {"launches": counts, "per_forward": per, "forward_ms": lat,
           "padding_copies": pads.calls}
    spans = [(n, layers, "moe_" + n) for n in ("ffn", "route", "dispatch", "experts", "combine")] \
        if cfg.num_experts else []
    out["profile"] = spanned_profile(f"{arch} prefill B={LM_BATCH} S={LM_SEQ}",
                                     lambda: model.forward(params, last_only=True, **inputs),
                                     spans)
    out["k4_activations"] = k4_at_activations(model, params, inputs)
    if arch == "olmoe-1b-7b":
        out["moe"] = moe_gate(model, params, inputs)

    mixers = {mixer for mixer, _ in cfg.block_pattern}
    if "ssm" not in mixers:  # attention stacks: K4 against the float32 control
        prompt = lm_inputs(model, params, gen, DECODE_BATCH, DECODE_SEQ)
        out["control_full_depth"] = control_readings(model, params, prompt, "full depth")
        gated = out["control_full_depth"]
        if arch in CONTROL_GATE_LAYERS:
            gated = control_readings(*cut_depth(model, params, CONTROL_GATE_LAYERS[arch]),
                                     prompt, "gated cut")
        require(gated["k4"] <= gated["tol"],
                f"{arch}: K4's prefill and the plain attention's differ by {gated['k4']}")
        require(gated["fault"] > gated["tol"],
                f"{arch}: the control gate would pass a dropped key tile")
        out["control"] = gated
    if arch in K4_NATIVE:
        out["padded_route"] = padded_route_gate(model, params, inputs)
    if "mla" in mixers or arch in DECODE_GATE_ARCHS:
        prompt = torch.randint(0, v, (DECODE_BATCH, DECODE_SEQ), generator=gen, device=dev)
        out["decode_err_printed"], _, _ = printed_decode(model, params, prompt)
        gated_model, gated_params = cut_depth(model, params, DECODE_GATE_LAYERS)
        err, _, dec = prefill_vs_decode(gated_model, gated_params, prompt, "gated cut")
        if "mla" in mixers:
            what = "absorbed MLA decode"
            planted = "the decode's q_r k_r logit term left out"
            fault, _, _ = prefill_vs_decode(gated_model, gated_params, prompt, "planted fault",
                                            decode_params=without_k_r(gated_params))
        else:
            what = "KV-cache decode"
            planted = "the prefill with a key tile dropped in every K4 call"
            fault = (prefill_with(gated_model, gated_params, prompt,
                                  dropped_tile_attention(every_call=True))[:, :v]
                     - dec[:, :v]).abs().max().item()
            control = prefill_with(gated_model, gated_params, prompt,
                                   attention_plain)[:, :v]
            out["decode_vs_control"] = (dec[:, :v] - control).abs().max().item()
            print(f"{what} {arch} (gated cut): max|decode - prefill with the float32 plain "
                  f"attention in place of K4| = {out['decode_vs_control']:.4e} (printed)")
        tol = DECODE_LOGIT_TOL.get(arch, LM_LOGIT_TOL)
        print(f"{what} {arch}: gated on the first {DECODE_GATE_LAYERS} layers "
              f"within {tol}: {err:.4e}; planted fault ({planted}) {fault:.4e}, "
              f"{fault / tol:.1f}x the tolerance; "
              f"{PRINTED_DECODE_LAYERS.get(arch, cfg.num_layers)} layers "
              f"{out['decode_err_printed']:.4e} (printed)")
        require(err <= tol, f"{arch}: prefill and {what} differ by {err}")
        require(fault > tol, f"{arch}: the decode gate would pass a planted fault ({planted})")
        out["decode_err"], out["decode_tol"], out["decode_fault"] = err, tol, fault
    if cfg.mrope_sections is not None:
        toks = torch.randint(0, v, (DECODE_BATCH, DECODE_SEQ), generator=gen, device=dev)
        b, s = toks.shape
        pos = torch.arange(s, device=dev)[None].expand(b, s)
        by_tokens = model.forward(params, toks, last_only=True)[0][:, 0, :v]
        by_embeds = model.forward(params, embeds=params["embed"][toks],
                                  pos3=pos[None].expand(3, b, s), last_only=True)[0][:, 0, :v]
        err = (by_tokens - by_embeds).abs().max().item()
        print(f"M-RoPE {arch}: embeds = embed[tokens] with pos3 the positions on all three "
              f"components against the token forward, B={b} S={s}: max|d| = {err:.4e} "
              f"(tolerance {LM_LOGIT_TOL}; bitwise {torch.equal(by_tokens, by_embeds)})")
        require(err <= LM_LOGIT_TOL, f"{arch}: M-RoPE embeds forward differs by {err}")
        out["mrope_err"] = err
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 8b {arch}: {out['seconds']:.1f} s of wall time")
    return out


def lm_new_phases(dev, card: str) -> dict:
    """Phases 8b and 7 for the families ported last: each full-width model
    loaded alone, prefilled and gated (``phase_lm_new``), served where it
    decodes (``LM_SERVE_ARCHS``), and freed before the next."""
    results = {}
    for arch in LM_NEW_ARCHS:
        t0 = time.perf_counter()
        model, params = _lm(arch, dev)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        print(f"load {arch}: {n / 1e9:.3f} B parameters "
              f"({sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f} GB) "
              f"in {time.perf_counter() - t0:.1f} s")
        results[arch] = phase_lm_new(dev, arch, model, params, card)
        if arch in LM_SERVE_ARCHS:
            t0 = time.perf_counter()
            phase_lm_serving(dev, model, params)
            print(f"phase 7 {arch}: {time.perf_counter() - t0:.1f} s of wall time")
        del model, params
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------- phase 9 ----
TRAIN_SEQ = 4096  # the reference's train_4k sequence (models/config.py:132)
# arch -> (global batch, microbatches, remat, steps, lr): full width,
# SyntheticTokens seed 0, a constant lr.  AdamW's first steps move every
# entry by about lr, which at full width overshoots on the larger models
# (on the H100 smollm's loss rose at lr 1e-3 and granite's at 3e-4; PERF.md
# section 6), so the rate falls with the parameter count.
TRAIN_RUNS = {
    "smollm-135m": (8, 2, "full", 6, 3e-4),
    "mamba2-370m": (4, 1, "full", 6, 1e-4),
    "granite-moe-1b-a400m": (2, 1, "full", 4, 3e-5),
    # K4's native pairs in a real step: hubert (80, 80) non-causal from
    # embeddings, gemma2 (256, 256) windowed and softcapped, minicpm3's MLA
    # (96, 64); lr times parameters held near granite's 4e4; 3 steps, so
    # that the run ends within its time limit
    "hubert-xlarge": (4, 1, "full", 3, 4e-5),
    "gemma2-2b": (1, 1, "full", 3, 1.5e-5),
    "minicpm3-4b": (1, 1, "full", 3, 1e-5),
}
# runs whose state (bf16 parameters and float32 moments: 26 and 41 GB) the
# card cannot hold twice, as a functional update does: their steps donate it
TRAIN_DONATED = ("gemma2-2b", "minicpm3-4b")
CARD_CPU_LR = 3e-4  # the card-against-CPU step's rate
LAUNCH_TRAIN_STEPS = 2  # launch/train.py's main, once
RESUME_FAULT_STEP, RESUME_CKPT_EVERY = 3, 2
# The Functions' backward is float32 autograd of the plain versions, cast
# to the inputs' dtypes: K4's bf16 dq, dk and dv round once (2^-9 of an
# entry), so each is held per element to 2^-8 |ref| + 1e-3 max|ref| and in
# all to 4e-3 of its largest entry.  A dk without the GQA group sum misses
# by about 2/3 of it.  K5's are float32 of the same function: 1e-4.
FN_BF16_RTOL, FN_BF16_ATOL, FN_BF16_MAXREL = 2 ** -8, 1e-3, 4e-3
FN_F32_MAXREL = 1e-4
# gemma2-2b's local layer: queries scaled so the logits reach the softcap
# (std about 25 against a cap of 50), where its derivative is 0.79, not 1
K4_FN_SOFTCAP_Q_SCALE = 25.0
# card against CPU, 2 layers at full width: bf16 parameters and gradients
# round at other places on the two devices (tests/test_torch_lm_train.py
# holds the CPU port to the reference within the same 5e-2)
CARD_CPU_LEAF_RTOL = 5e-2
CARD_CPU_LOSS_TOL = 2e-3  # 0.01 x aux (about 1) dropped moves the loss by 1e-2
CARD_CPU_BATCH, CARD_CPU_SEQ = 2, 256
MB_LEAF_RTOL = 2e-2  # 2 microbatches of 4 against one of 8: bf16 gradients round per batch


def _max_rel(got, want) -> float:
    """max |got - want| over max |want| (float32)."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def _bf16_gate(got, want) -> tuple:
    """(per-element worst ratio to its bound, max-relative error) of a bf16
    gradient against its float32 reference."""
    want = want.float()
    err = (got.float() - want).abs()
    bound = FN_BF16_RTOL * want.abs() + FN_BF16_ATOL * want.abs().max()
    return (err / bound).max().item(), _max_rel(got, want)


def _attention_grads_f32(q, k, v, g, causal, window, softcap, straight_through_cap=False,
                         no_group_sum=False, scale=None):
    """float32 autograd of the plain attention at (q, k, v) and ``scale``
    (default Dqk^-0.5): the gate's reference, and its planted faults (the
    softcap's derivative dropped; dk and dv of each group's first head
    alone, no GQA group sum; another ``causal`` or ``scale`` than the
    call's)."""
    from repro_torch.kernels.flash_attention import attention_plain

    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    grp = q.shape[1] // k.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    with torch.enable_grad():
        if not (straight_through_cap or no_group_sum):
            out = attention_plain(qf, kf, vf, causal=causal, window=window, softcap=softcap,
                                  scale=scale)
            return torch.autograd.grad(out, (qf, kf, vf), g.float())
        kr = kf.repeat_interleave(grp, dim=1)
        vr = vf.repeat_interleave(grp, dim=1)
        logits = (qf @ kr.transpose(-1, -2)) * scale
        if softcap is not None:
            capped = softcap * torch.tanh(logits / softcap)
            logits = logits + (capped - logits).detach() if straight_through_cap else capped
        s, t = q.shape[2], k.shape[2]
        qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
        kpos = torch.arange(t, device=q.device)[None, :]
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        p = torch.softmax(logits.masked_fill(~mask, -1e30), dim=-1)
        out = p @ vr
        dq, dkr, dvr = torch.autograd.grad(out, (qf, kr, vr), g.float())
    if no_group_sum:
        return dq, dkr[:, ::grp], dvr[:, ::grp]
    return dq, dkr.reshape(k.shape[0], k.shape[1], grp, *k.shape[2:]).sum(2), \
        dvr.reshape(v.shape[0], v.shape[1], grp, *v.shape[2:]).sum(2)


def k4_function_gate(dev, gen, label, b, hq, hkv, s, dqk, dv=None, causal=True, window=None,
                     softcap=None, q_scale=1.0, scale=None) -> dict:
    """K4's autograd Function at one layer, q and k at head dim ``dqk``, v
    at ``dv`` (default ``dqk``): forward through the kernel (one launch, no
    padding copy), dq / dk / dv against float32 autograd of the plain
    version, planted faults read in the same run (the GQA group sum
    dropped, where Hq > Hkv; the softcap's derivative dropped; a causal
    mask in a non-causal layer's backward; the padded head dim's scale in
    place of a native pair's own), and its backward's time."""
    from repro_torch.kernels import flash_attention as fa

    dv = dqk if dv is None else dv
    q = _randn(gen, (b, hq, s, dqk), dev, torch.bfloat16, scale=q_scale).requires_grad_(True)
    k = _randn(gen, (b, hkv, s, dqk), dev, torch.bfloat16).requires_grad_(True)
    v = _randn(gen, (b, hkv, s, dv), dev, torch.bfloat16).requires_grad_(True)
    g = _randn(gen, (b, hq, s, dv), dev, torch.bfloat16)
    before = fa.flash_attention.launches
    with PadCalls() as pads:
        out = fa.FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    require(fa.flash_attention.launches == before + 1 and pads.calls == 0,
            f"K4 Function {label}: {fa.flash_attention.launches - before} K4 launches and "
            f"{pads.calls} padding copies, want 1 and 0")
    got = torch.autograd.grad(out, (q, k, v), g)
    want = _attention_grads_f32(q, k, v, g, causal, window, softcap, scale=scale)
    reads = {n: _bf16_gate(a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    del got

    def worst(fault):
        return max(_max_rel(a, w) for a, w in zip(fault, want))

    faults = {}
    if hq > hkv:
        faults["dk without the GQA group sum"] = _max_rel(
            _attention_grads_f32(q, k, v, g, causal, window, softcap, no_group_sum=True,
                                 scale=scale)[1], want[1])
    if softcap is not None:
        faults["softcap derivative dropped"] = worst(_attention_grads_f32(
            q, k, v, g, causal, window, softcap, straight_through_cap=True, scale=scale))
    if not causal:
        faults["causal mask applied in the backward"] = worst(_attention_grads_f32(
            q, k, v, g, True, window, softcap, scale=scale))
    if (dqk, dv) not in ((d, d) for d in fa.HEAD_DIMS):
        faults[f"backward at the padded {fa.padded_head_dim(dqk, dv)}'s scale"] = worst(
            _attention_grads_f32(q, k, v, g, causal, window, softcap,
                                 scale=fa.padded_head_dim(dqk, dv) ** -0.5))
    for n, (ratio, rel) in reads.items():
        print(f"K4 Function {label}: {n} per-element error at {ratio:.3f}x its bound "
              f"(2^-8 |ref| + 1e-3 max|ref|), max-relative {rel:.3e} (gate {FN_BF16_MAXREL})")
        require(ratio <= 1.0 and rel <= FN_BF16_MAXREL, f"K4 Function {label}: {n} disagrees")
    require(faults, f"K4 Function {label}: no planted fault reads this layer")
    for n, rel in faults.items():
        print(f"K4 Function {label}: planted fault ({n}) reads {rel:.3e}, "
              f"{rel / FN_BF16_MAXREL:.1f}x the gate")
        require(rel > FN_BF16_MAXREL, f"K4 Function gate {label} would pass: {n}")
    del want
    bwd_ms = median_ms(lambda: fa.attention_vjp(q.detach(), k.detach(), v.detach(), g,
                                                causal, window, softcap, scale), reps=3, warmup=1)
    fwd_ms = median_ms(lambda: fa.flash_attention(q.detach(), k.detach(), v.detach(),
                                                  causal, window, softcap, scale), reps=10)
    print(f"K4 Function {label} (B={b} Hq={hq} Hkv={hkv} S={s} q/k {dqk} v {dv}, "
          f"{'causal' if causal else 'non-causal'}): forward (K4) {fwd_ms:.4f} ms, backward "
          f"(float32 plain recomputed) {bwd_ms:.4f} ms, on {card_line()}")
    return {"label": label, "pair": [dqk, dv], "causal": causal,
            "max_rel": {n: r[1] for n, r in reads.items()},
            "faults": faults, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms}


def _ssd_grads_f32(x, a, b, c, gy, chunk, drop_state_grad=False):
    """float32 autograd of the plain SSD scan; the planted fault detaches
    the state carried from chunk to chunk (its gradient dropped)."""
    from repro_torch.kernels import ssd_scan as ks

    live = [t.detach().float().requires_grad_(True) for t in (x, a, b, c)]
    with torch.enable_grad():
        if drop_state_grad:
            y = torch.cat([ks.ssd_plain(*(t[:, c0:c0 + chunk] for t in live), chunk=chunk)
                           for c0 in range(0, x.shape[1], chunk)], dim=1)
            # each chunk alone plus the carried state's output, held constant
            full = ks.ssd_plain(*[t.detach() for t in live], chunk=chunk)
            y = y + (full - y).detach()
        else:
            y = ks.ssd_plain(*live, chunk=chunk)
        return torch.autograd.grad(y, live, gy)


def k5_function_gate(dev, gen, b, s, h, g, p, n, chunk) -> dict:
    """K5's autograd Function at mamba2-370m's layer: forward through the
    kernel, gradients against float32 autograd of the plain version, a
    planted fault (no gradient through the inter-chunk state)."""
    from repro_torch.kernels import ssd_scan as ks

    x = _randn(gen, (b, s, h, p), dev).requires_grad_(True)
    a = (-_randn(gen, (b, s, h), dev).abs() * 0.1).requires_grad_(True)
    bc = _randn(gen, (b, s, g, n), dev, scale=0.3).requires_grad_(True)
    cc = _randn(gen, (b, s, g, n), dev, scale=0.3).requires_grad_(True)
    gy = _randn(gen, (b, s, h, p), dev)
    before = ks.ssd_scan.launches
    y = ks.SSDScan.apply(x, a, bc, cc, chunk)
    require(ks.ssd_scan.launches == before + 1, "K5 Function: no K5 launch")
    got = torch.autograd.grad(y, (x, a, bc, cc), gy)
    want = _ssd_grads_f32(x, a, bc, cc, gy, chunk)
    fault = _ssd_grads_f32(x, a, bc, cc, gy, chunk, drop_state_grad=True)
    names = ("dx", "da_log", "db", "dc")
    rels = {nm: _max_rel(u, w) for nm, u, w in zip(names, got, want)}
    frel = max(_max_rel(u, w) for u, w in zip(fault, want))
    print(f"K5 Function B={b} S={s} H={h} P={p} N={n}: max-relative errors "
          f"{ {k: f'{v:.2e}' for k, v in rels.items()} } (gate {FN_F32_MAXREL}); planted "
          f"fault (inter-chunk state's gradient dropped) reads {frel:.3e}, "
          f"{frel / FN_F32_MAXREL:.1f}x the gate")
    require(max(rels.values()) <= FN_F32_MAXREL, f"K5 Function disagrees: {rels}")
    require(frel > FN_F32_MAXREL, "K5 Function gate would pass a dropped state gradient")
    bwd_ms = median_ms(lambda: ks.SSDScan.backward(
        type("Ctx", (), {"saved_tensors": (x.detach(), a.detach(), bc.detach(), cc.detach()),
                         "chunk": chunk})(), gy), reps=3, warmup=1)
    print(f"K5 Function: backward (float32 plain recomputed) {bwd_ms:.4f} ms")
    return {"max_rel": rels, "fault": frel, "bwd_ms": bwd_ms}


def _train_cfg(arch, layers=None):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def card_against_cpu(dev, arch) -> dict:
    """One train step of ``arch`` cut to 2 layers at full width on the card
    and on the CPU from the same parameters and batch: the loss, every
    gradient leaf and every new parameter; the aux term zeroed on the card
    is the planted fault (granite-moe).  The state is drawn on the card and
    copied to the CPU.  The card runs ``build_train_step``; the CPU composes
    the same step (one microbatch, no compression) from the gradients it
    computed once: ``clip_by_global_norm`` at 1.0, then ``adamw_update``
    (in place: the same bits; a second CPU pass costs 25 s at gemma2-2b's
    vocab)."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import LM
    from repro_torch.train import (SyntheticTokens, adamw_update, clip_by_global_norm,
                                   tree_map, value_and_grad)
    from repro_torch.train.train_step import build_train_step, init_train_state

    t0 = time.perf_counter()
    cfg = _train_cfg(arch, 2)
    out = {}
    data = SyntheticTokens(cfg.vocab_size, CARD_CPU_SEQ, CARD_CPU_BATCH, seed=SEED)
    tok_np, tgt_np = data.host_batch(0)
    x_cpu = train_input(cfg, tok_np)
    state0 = init_train_state(LM(cfg, device=dev, remat="full"), SEED)
    routes = {}
    for device in (dev, "cpu"):
        model = LM(cfg, device=device, remat="full")
        state = tree_map(lambda t: t.to(device), state0)
        x = x_cpu.to(device)
        tgt = torch.from_numpy(tgt_np).to(device)
        with _RouteLog() as log:
            loss, (grads,) = value_and_grad(
                lambda p: model.loss(p, targets=tgt, **_model_input(x)), state.params)
        routes[str(device)] = log.idx
        if device == "cpu":
            clipped, gnorm = clip_by_global_norm(grads, 1.0)
            new_params, _ = adamw_update(clipped, state.opt, state.params, CARD_CPU_LR,
                                         inplace=True)
            metrics = {"grad_norm": gnorm}
            del clipped
        else:
            step, _ = build_train_step(model, make_debug_mesh(1, 1, device=device),
                                       CARD_CPU_BATCH, lr=CARD_CPU_LR,
                                       use_embeds=x.is_floating_point())
            new, metrics = step(state, x, tgt)
            new_params = new.params
        out[str(device)] = (loss, grads, new_params, metrics)
        if device == dev and cfg.num_experts:
            out["fault"] = value_and_grad(
                lambda p: model.loss(p, targets=tgt, aux_weight=0.0, **_model_input(x)),
                state.params)
    (l_c, g_c, p_c, m_c), (l_d, g_d, p_d, m_d) = out["cpu"], out[str(dev)]
    loss_err = abs(float(l_c) - float(l_d))
    flips = sum(int((a != b).any(-1).sum()) for a, b in zip(routes["cpu"], routes[str(dev)]))
    g_rel = _grad_rel(g_d, g_c, model_scale=flips > 0)
    g_worst = max(g_rel.values())
    print(f"card vs CPU {arch}: {flips} token-layer routes of {sum(r[..., 0].numel() for r in routes['cpu'])} "
          "pick other experts on the card; worst gradient leaves "
          + ", ".join(f"{k} {v:.3e}" for k, v in sorted(g_rel.items(), key=lambda kv: -kv[1])[:3])
          + (" (of the model's largest gradient entry)" if flips else ""))
    p_worst = _param_ratio(p_d, p_c)
    print(f"card vs CPU {arch} (2 layers ({'+'.join(m for m, _ in cfg.block_pattern)}), "
          f"full width, B={CARD_CPU_BATCH}, S={CARD_CPU_SEQ}, from "
          f"{'embeddings' if x_cpu.is_floating_point() else 'token ids'}): loss "
          f"{float(l_d):.6f} vs {float(l_c):.6f} (|diff| "
          f"{loss_err:.2e}, gate {CARD_CPU_LOSS_TOL}); worst gradient leaf {g_worst:.3e} "
          f"of the leaf's largest entry (gate {CARD_CPU_LEAF_RTOL}); new parameters at "
          f"{p_worst:.3f}x their bound (2 lr + 2^-7 max |p|); grad_norm "
          f"{float(m_d['grad_norm']):.5f} vs {float(m_c['grad_norm']):.5f}")
    require(loss_err <= CARD_CPU_LOSS_TOL, f"card and CPU losses differ for {arch}")
    require(g_worst <= CARD_CPU_LEAF_RTOL, f"card and CPU gradients differ for {arch}")
    require(p_worst <= 1.0, f"card and CPU new parameters differ for {arch}")
    row = {"loss_err": loss_err, "grad_max_rel": g_worst, "param_bound_ratio": p_worst,
           "route_flips": flips, "seconds": time.perf_counter() - t0}
    if "fault" in out:
        fl, (fg,) = out["fault"]
        f_loss = abs(float(fl) - float(l_c))
        f_grad = max(_grad_rel(fg, g_c).values())
        print(f"card vs CPU {arch}: planted fault (aux term zeroed on the card) reads loss "
              f"{f_loss:.3e} ({f_loss / CARD_CPU_LOSS_TOL:.1f}x its gate), worst gradient "
              f"leaf {f_grad:.3e} ({f_grad / CARD_CPU_LEAF_RTOL:.1f}x its gate)")
        require(f_loss > CARD_CPU_LOSS_TOL,
                f"card-vs-CPU gate would pass a dropped aux term ({arch})")
        row["fault"] = {"loss": f_loss, "grad_max_rel": f_grad}
    print(f"card vs CPU {arch}: {row['seconds']:.1f} s of wall time")
    return row


def train_input(cfg, tok_np) -> torch.Tensor:
    """A train step's model input on the CPU from ``SyntheticTokens`` ids:
    the ids; for the audio stub (hubert-xlarge, fed frame embeddings) the
    frames ``launch/cells.py::frame_embeddings`` draws from ``SEED``, one
    row an id, so that the frames carry the ids the targets come from."""
    from repro_torch.launch.cells import frame_embeddings

    tok = torch.from_numpy(tok_np).long()
    return tok if cfg.frontend == "none" else frame_embeddings(cfg, tok, SEED)


def _model_input(x) -> dict:
    """``LM.loss``'s input keywords for token ids or embeddings ``x``."""
    return {"tokens": None, "embeds": x} if x.is_floating_point() else {"tokens": x}


def train_memory_check(cfg, batch: int, mb: int, remat: str) -> dict:
    """The dry run's 1 x 1 memory estimate of one ``train_4k`` step of
    ``cfg`` at ``batch`` rows in ``mb`` microbatches, against the card's
    free memory (``torch.cuda.mem_get_info``): a run the estimate says does
    not fit fails here."""
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES

    spec = dataclasses.replace(SHAPES["train_4k"], global_batch=batch)
    require(spec.seq_len == TRAIN_SEQ, f"train_4k is S={spec.seq_len}, not {TRAIN_SEQ}")
    est = dryrun.memory_estimate(cfg, spec, dryrun.meta_mesh(shape=(1, 1)), mb, remat)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    need = est["peak_bytes_per_rank_estimate"]
    print(f"train {cfg.name}: dry-run 1 x 1 estimate of a step {need / 2 ** 30:.2f} GiB "
          f"(state {est['state_bytes_per_rank_estimate'] / 2 ** 30:.2f}, activations "
          f"{est['activation_bytes_per_rank_estimate'] / 2 ** 30:.2f}) against "
          f"{free / 2 ** 30:.2f} GiB free of {total / 2 ** 30:.2f}")
    require(need <= free, f"{cfg.name}: the estimated step ({need / 2 ** 30:.2f} GiB) does "
            f"not fit the card's free memory ({free / 2 ** 30:.2f} GiB)")
    return {"estimate_bytes": need, "free_bytes": free}


def _grad_rel(g_d, g_c, model_scale: bool = False) -> dict:
    """Leaf path -> max |card - CPU| over the leaf's largest entry, or with
    ``model_scale`` over the model's largest gradient entry (for a MoE
    model whose routing differs between the devices: a token routed to
    another expert moves the gradient of every leaf upstream of it)."""
    from repro_torch.train import tree_leaves

    # on the card: exact float32 operations, the CPU's results, faster
    dev = tree_leaves(g_d)[0].device
    model_max = max(x.to(dev).float().abs().max().item() for x in tree_leaves(g_c))
    out = {}
    for path, a, b in zip(leaf_paths(g_c), tree_leaves(g_d), tree_leaves(g_c)):
        b32 = b.to(dev).float()
        err = (a.float() - b32).abs().max().item()
        scale = model_max if model_scale else b32.abs().max().item()
        out[path] = err / max(scale, 1e-30)
    return out


class _RouteLog:
    """Records the experts ``moe_route`` picks (its ``idx``) while active."""

    def __init__(self):
        self.idx = []

    def __enter__(self):
        from repro_torch.models import layers as L

        self._orig = L.moe_route

        def logged(*args, **kwargs):
            r = self._orig(*args, **kwargs)
            self.idx.append(r["idx"].detach().sort(dim=-1).values.cpu())
            return r

        L.moe_route = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L

        L.moe_route = self._orig


def _param_ratio(new_d, new_c) -> float:
    """The worst ratio, over every parameter entry, of |card - CPU| to
    ``2 lr + 2^-7 max(|card|, |CPU|)``.  AdamW's first step moves an entry
    by ``lr`` times the sign of its gradient, so an entry whose gradient is
    near 0 may step the other way on the other device (2 lr apart); each
    side then rounds to bf16, by up to half a step, at most 2^-8 of its
    magnitude."""
    from repro_torch.train import tree_leaves

    worst = 0.0
    for a, b in zip(tree_leaves(new_d), tree_leaves(new_c)):
        a32, b32 = a.float(), b.to(a.device).float()  # exact operations, on the card
        bound = 2 * CARD_CPU_LR + 2 ** -7 * torch.maximum(a32.abs(), b32.abs())
        worst = max(worst, ((a32 - b32).abs() / bound).max().item())
    return worst


def _state_equal(a, b) -> bool:
    from repro_torch.train import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def train_readings(arch, model, state, step_fn, tok, tgt, microbatches, lr,
                   step_ms, donate=False) -> dict:
    """Readings around the training run's step times (``step_ms``,
    CUDA-event medians): tokens/s, the forward / backward / optimizer
    split, a profiled step (device busy share, K4, K5 and the float32
    attention / SSD backward's shares) and peak memory.  With ``donate``
    the optimizer and the profiled step update ``state`` in place."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ks
    from repro_torch.train import (adamw_update, clip_by_global_norm, tree_map,
                                   value_and_grad)

    rows = tok.shape[0] // microbatches
    mtok, mtgt = tok[:rows], tgt[:rows]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def forward():
        with torch.enable_grad():
            return model.loss(tree_map(lambda p: p.detach().requires_grad_(True),
                                       state.params), targets=mtgt, **_model_input(mtok))

    def loss(p):
        return model.loss(p, targets=mtgt, **_model_input(mtok))

    fwd_ms = median_ms(forward, reps=1, warmup=0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()  # warm: the training run came first
    _, (grads,) = value_and_grad(loss, state.params)
    end.record()
    end.synchronize()
    fb_ms = start.elapsed_time(end)

    def optimizer():
        gr, _ = clip_by_global_norm(grads, 1.0)
        return adamw_update(gr, state.opt, state.params, lr, inplace=donate)

    torch.cuda.empty_cache()  # a 41 GB state leaves little room for fragments

    opt_ms = median_ms(optimizer, reps=3, warmup=1)
    del grads
    spans = [("attn_bwd", fa, "attention_vjp"), ("ssd_bwd", ks.SSDScan, "backward")]
    prof = spanned_profile(f"train step {arch}", lambda: step_fn(state, tok, tgt), spans,
                           warm=False)
    busy = prof["busy_ms"]
    toks = tok.shape[0] * tok.shape[1]
    row = {"step_ms": step_ms, "tokens_per_s": toks / step_ms * 1e3,
           "forward_ms_per_microbatch": fwd_ms,
           "backward_ms_per_microbatch": fb_ms - fwd_ms, "optimizer_ms": opt_ms,
           "microbatches": microbatches, "peak_gib": peak, "profile_wall_ms": prof["wall_ms"],
           "busy_ms": busy, "busy_share": busy / prof["wall_ms"],
           "k4_share": prof["k4_ms"] / busy if busy else None,
           "k5_share": prof["k5_ms"] / busy if busy else None,
           "attn_bwd_share": prof["attn_bwd_ms"] / busy if busy else None,
           "ssd_bwd_share": prof["ssd_bwd_ms"] / busy if busy else None}
    print(f"train {arch}: step {step_ms:.1f} ms (CUDA-event median of the training run's "
          f"steps after the first), {row['tokens_per_s']:.0f} tokens/s; per microbatch of "
          f"{rows}: forward {fwd_ms:.1f} ms, backward {fb_ms - fwd_ms:.1f} ms; optimizer "
          f"(clip + AdamW) {opt_ms:.1f} ms; peak memory {peak:.2f} GiB; device busy "
          f"{100 * row['busy_share']:.1f}% of a profiled step; shares of the device time: "
          + ", ".join(f"{k} {100 * row[k + '_share']:.1f}%" for k in
                      ("k4", "k5", "attn_bwd", "ssd_bwd") if row[k + "_share"] is not None)
          + f"; on {card_line()}")
    return row


def train_model(dev, arch, ckpt_root) -> dict:
    """Full-width training of ``arch`` through ``build_train_step``:
    losses, launch counts and CUDA-event time of every step, a bitwise
    repeat under deterministic algorithms, readings; for smollm-135m also
    the resume (through ``FaultTolerantRunner``), microbatch, compression
    and ``launch/train.py`` gates."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import LM
    from repro_torch.train import SyntheticTokens, tree_leaves, value_and_grad
    from repro_torch.train.train_step import build_train_step, init_train_state

    t_phase = time.perf_counter()
    batch, mb, remat, steps, lr = TRAIN_RUNS[arch]
    cfg = _train_cfg(arch)
    donate = arch in TRAIN_DONATED
    memory = train_memory_check(cfg, batch, mb, remat)
    model = LM(cfg, device=dev, remat=remat)
    mesh = make_debug_mesh(1, 1, device=dev)
    # a donating run keeps no initial state beside its own: it draws it
    # again from the seed (the init is deterministic) where a gate needs it
    state0 = None if donate else init_train_state(model, SEED)

    def fresh():
        return init_train_state(model, SEED) if donate else state0

    step_fn, specs = build_train_step(model, mesh, batch, lr=lr, microbatches=mb,
                                      use_embeds=cfg.frontend != "none", donate=donate)
    data = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, batch, seed=SEED)
    batches = [(train_input(cfg, tok).to(dev), torch.from_numpy(tgt).to(dev))
               for tok, tgt in (data.host_batch(i) for i in (0, 1))]
    per_fwd = launches_per_forward(cfg)
    want = {k: mb * (2 if remat != "none" else 1) * n for k, n in per_fwd.items()}

    # the training run: each step's launches (counters set to 0 just
    # before it, read just after), loss and CUDA-event time; the first
    # step's peak memory
    losses, counts, times = [], [], []

    def counted(state, tok, tgt):
        flash_attention.launches = ssd_scan.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step_fn(state, tok, tgt)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        counts.append({"flash_attention": flash_attention.launches,
                       "ssd_scan": ssd_scan.launches})
        losses.append(float(m["loss"]))
        return state, m

    state, at_resume = fresh(), None
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        state, _ = counted(state, *batches[i % 2])
        if i == 0:
            step_peak = torch.cuda.max_memory_allocated()
        if arch == "smollm-135m" and i == RESUME_FAULT_STEP:  # where the resume gate ends
            at_resume = state
    del state
    print(f"train {arch} (full width, {cfg.num_layers} layers, B={batch} as {mb} "
          f"microbatch(es), S={TRAIN_SEQ}, remat={remat}, lr {lr}"
          f"{', state donated' if donate else ''}): losses "
          f"{[round(x, 4) for x in losses]}; step ms {[round(t, 1) for t in times]}; "
          f"K4 / K5 launches a step {counts[0]} (expected {want})")
    print(f"train {arch}: the first step's peak memory {step_peak / 2 ** 30:.2f} GiB "
          f"({held / 2 ** 30:.2f} GiB held before it) against the dry run's "
          f"estimate {memory['estimate_bytes'] / 2 ** 30:.2f} GiB (measured / estimate "
          f"{step_peak / memory['estimate_bytes']:.3f}), on {card_line()}")
    require(all(math.isfinite(x) for x in losses), f"{arch}: non-finite loss {losses}")
    require(all(losses[i] < losses[i % 2] for i in range(max(2, steps - 2), steps)),
            f"{arch}: the loss did not decrease over the steps {losses}")
    require(all(c == want for c in counts), f"{arch}: launches a step {counts}, expected {want}")

    # bitwise repeat under deterministic algorithms: two steps from one
    # state; a donated state is consumed by its step and does not fit on the
    # card twice, so there two gradient passes from one state (loss and
    # every leaf: what a step reduces across threads; its update is
    # elementwise) are compared
    torch.use_deterministic_algorithms(True)
    try:
        if donate:
            state0 = fresh()
            tok0, tgt0 = batches[0]
            (l1, (g1,)), (l2, (g2,)) = (value_and_grad(
                lambda p: model.loss(p, targets=tgt0, **_model_input(tok0)), state0.params)
                for _ in range(2))
            same = torch.equal(l1, l2) and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
            del g1, g2
            what = "gradient passes (loss and every leaf)"
        else:
            s1, m1 = step_fn(state0, *batches[0])
            s2, m2 = step_fn(state0, *batches[0])
            same = _state_equal(s1, s2) and torch.equal(m1["loss"], m2["loss"])
            del s2
            what = "steps"
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"train {arch}: two {what} from one state and batch under "
          f"torch.use_deterministic_algorithms(True) bitwise equal: {same}")
    require(same, f"{arch}: two {what} from one state differ")
    row = {"losses": losses, "step_ms_each": times, "launches_per_step": counts[0],
           "expected": want, "lr": lr, "donated": donate,
           "step_peak_gib": step_peak / 2 ** 30,
           "dryrun_estimate_gib": memory["estimate_bytes"] / 2 ** 30}
    if arch == "smollm-135m":
        row.update(smollm_gates(dev, model, mesh, state0, at_resume, step_fn, batches,
                                ckpt_root, (s1, m1)))
    s1 = at_resume = None  # the first step's and the resume gate's states, freed
    row.update(train_readings(arch, model, state0, step_fn, *batches[0], mb, lr,
                              statistics.median(times[1:]), donate))
    print(f"phase 9 {arch}: {time.perf_counter() - t_phase:.1f} s of wall time")
    return row


def smollm_gates(dev, model, mesh, state0, clean, step_fn, batches, ckpt_root,
                 first) -> dict:
    """smollm-135m: the runner resumed after an injected fault, bitwise the
    uninterrupted run's state after as many steps (``clean``); 2
    microbatches against one batch of 8; a compressed step; and
    ``launch/train.py``'s ``main`` once (remat none)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train as launch_train
    from repro_torch.train import CheckpointManager, tree_leaves
    from repro_torch.train.fault_tolerance import FaultTolerantRunner
    from repro_torch.train.train_step import build_train_step

    batch, mb, _, _, lr = TRAIN_RUNS["smollm-135m"]
    resume_steps = RESUME_FAULT_STEP + 1
    out = {}
    # resume: fault at step 3, checkpoints every 2 steps
    fired = []

    def hook(step):
        if step == RESUME_FAULT_STEP and not fired:
            fired.append(step)
            raise RuntimeError("injected device failure")

    ckpt = CheckpointManager(str(Path(ckpt_root) / "smollm-resume"), keep=2)
    runner = FaultTolerantRunner(step_fn, lambda i: batches[i % 2], ckpt,
                                 ckpt_every=RESUME_CKPT_EVERY, fault_hook=hook)
    resumed, stats = runner.run(state0, 0, resume_steps)
    bitwise = _state_equal(resumed, clean)
    print(f"resume smollm-135m: fault at step {RESUME_FAULT_STEP}, checkpoints every "
          f"{RESUME_CKPT_EVERY}: failures {stats.failures}, restores {stats.restores}, "
          f"steps done {stats.steps_done}; its state after {resume_steps} steps bitwise "
          f"the uninterrupted run's: {bitwise}")
    require(stats.failures == 1 and stats.restores == 1, f"resume: {stats}")
    require(bitwise, "the resumed state differs from the uninterrupted run's")
    out["resume"] = {"failures": stats.failures, "restores": stats.restores,
                     "bitwise": bitwise}
    del resumed

    # 2 microbatches of 4 against one batch of 8, compared through the
    # step's first moments (0.1 x the clipped gradient)
    one_fn, _ = build_train_step(model, mesh, batch, lr=lr, microbatches=1)
    one, m_one = one_fn(state0, *batches[0])
    two, m_two = first
    loss_err = abs(float(m_one["loss"]) - float(m_two["loss"]))
    rel = max(_max_rel(a, b) for a, b in zip(tree_leaves(two.opt.mu), tree_leaves(one.opt.mu)))
    print(f"microbatches smollm-135m: 2 x 4 against 1 x 8: loss {float(m_two['loss']):.6f} "
          f"vs {float(m_one['loss']):.6f} (|diff| {loss_err:.2e}, gate 1e-4); worst "
          f"gradient leaf (first moment) {rel:.3e} of its largest entry (gate "
          f"{MB_LEAF_RTOL})")
    require(loss_err <= 1e-4 and rel <= MB_LEAF_RTOL, "microbatched gradients disagree")
    out["microbatch_gate"] = {"loss_err": loss_err, "grad_max_rel": rel}
    del one

    # a compressed step
    from repro_torch.train.train_step import init_train_state

    comp_fn, _ = build_train_step(model, mesh, batch, lr=lr, microbatches=mb,
                                  use_compression=True)
    cstate = init_train_state(model, SEED, use_compression=True)
    cstate, m_c = comp_fn(cstate, *batches[0])
    res_nonzero = sum(bool(r.abs().max() > 0) for r in tree_leaves(cstate.residuals))
    print(f"compression smollm-135m: loss {float(m_c['loss']):.6f}, finite "
          f"{math.isfinite(float(m_c['loss']))}; {res_nonzero} of "
          f"{len(tree_leaves(cstate.residuals))} residual leaves non-zero")
    require(math.isfinite(float(m_c["loss"])) and all(
        bool(torch.isfinite(p).all()) for p in tree_leaves(cstate.params)),
        "compressed step not finite")
    require(res_nonzero > 0, "compressed step left every residual zero")
    out["compression"] = {"loss": float(m_c["loss"]), "residuals_nonzero": res_nonzero}
    del cstate

    # launch/train.py's main: remat none, so K4 launches once a layer a microbatch
    before = flash_attention.launches
    flash_attention.launches = 0
    t0 = time.perf_counter()
    steps = LAUNCH_TRAIN_STEPS
    state, stats = launch_train.main([
        "--arch", "smollm-135m", "--steps", str(steps), "--batch", str(batch),
        "--seq", str(TRAIN_SEQ), "--microbatches", str(mb), "--ckpt-every", "100",
        "--ckpt-dir", str(Path(ckpt_root) / "launch"), "--device", torch.device(dev).type])
    k4 = flash_attention.launches
    flash_attention.launches = before
    from repro_torch.configs import get_config

    want = steps * mb * launches_per_forward(get_config("smollm-135m"))["flash_attention"]
    print(f"launch/train.py smollm-135m: {stats.steps_done} steps, final loss "
          f"{stats.last_loss:.4f}, {time.perf_counter() - t0:.1f} s; K4 launches {k4} "
          f"(remat none: {want} expected)")
    require(stats.steps_done == steps and math.isfinite(stats.last_loss),
            "launch/train.py did not train")
    require(k4 == want, f"launch/train.py launched K4 {k4} times, expected {want}")
    out["launch_train"] = {"steps": stats.steps_done, "final_loss": stats.last_loss,
                           "k4_launches": k4, "k4_launches_per_step_remat_none": k4 // steps}
    return out


def phase_lm_train(dev, card: str) -> dict:
    """Phase 9: LM training on the card (K4 and K5 Functions, card against
    CPU, full-width training of three models with its gates, readings)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    fn_rows = {
        "smollm-135m": k4_function_gate(dev, gen, "smollm-135m layer", 4, 9, 3, TRAIN_SEQ, 64),
        "gemma2-2b local": k4_function_gate(
            dev, gen, "gemma2-2b local layer", *K4_GEMMA_LOCAL[:5], window=K4_GEMMA_LOCAL[5],
            softcap=K4_GEMMA_LOCAL[6], q_scale=K4_FN_SOFTCAP_Q_SCALE),
        "hubert-xlarge": k4_function_gate(dev, gen, "hubert-xlarge layer", 4, 16, 16,
                                          TRAIN_SEQ, 80, 80, causal=False),
        "minicpm3-4b": k4_function_gate(dev, gen, "minicpm3-4b MLA layer", 1, 40, 40,
                                        TRAIN_SEQ, 96, 64, scale=96 ** -0.5),
        "mamba2-370m": k5_function_gate(dev, gen, 4, TRAIN_SEQ, 32, 1, 64, 128, 128),
    }
    torch.cuda.empty_cache()
    print(f"phase 9, the Functions: {time.perf_counter() - t0:.1f} s of wall time")
    t0 = time.perf_counter()
    card_cpu = {arch: card_against_cpu(dev, arch) for arch in TRAIN_RUNS}
    torch.cuda.empty_cache()
    print(f"phase 9, card against CPU: {time.perf_counter() - t0:.1f} s of wall time")
    out = {"functions": fn_rows, "card_vs_cpu": card_cpu, "models": {}}
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=str(build)) as d:
        for arch in TRAIN_RUNS:
            out["models"][arch] = train_model(dev, arch, d)
            torch.cuda.empty_cache()
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s of wall time, on {card}")
    return out


# --------------------------------------------------------- phase 10 ----
# arch -> (global batch, microbatches): phase 9's runs on a (2, 1) mesh of
# two ranks on the one card (smollm's batch 8 as 2 x 4, as phase 9's)
DP_RUNS = {
    "smollm-135m": (8, 2),
    "granite-moe-1b-a400m": (2, 1),
    "mamba2-370m": (4, 1),
}
# granite-moe's DP step at its first 12 of 24 layers, so that the run ends
# within its time limit (the rank loop and the MoE aux do not depend on depth)
DP_DEPTH_CUT = {"granite-moe-1b-a400m": 12}
DP_RANKS = 2
DP_LOSS_TOL = 1e-4  # phase 9's microbatch gate: the loss, and first moments
DP_LEAF_RTOL = MB_LEAF_RTOL  # within 2e-2 of each leaf's largest entry
DP_LR = 3e-4
CP_SHARDS = 16  # the reference's p_shards (ops.py:132)
CP_SHAPE = (4, 9, 3, TRAIN_SEQ, 64)  # smollm-135m's layer: B, Hq, Hkv, S, Dh
CP_FORWARD_BATCH = 2  # the smollm-135m forward under ATTN_IMPL="cp_zigzag"


def _mu_rel(a, want_mu, leaves=None) -> float:
    """The worst leaf of state ``a``'s first moments against ``want_mu``,
    over each leaf's largest entry (``leaves`` picks leaves by key path)."""
    from repro_torch.train import tree_leaves

    pairs = zip(leaf_paths(a.opt.mu), tree_leaves(a.opt.mu), tree_leaves(want_mu))
    return max(_max_rel(x, y) for p, x, y in pairs if leaves is None or leaves(p))


def _event_ms(fn) -> float:
    """CUDA-event ms of one call of ``fn`` (a train step: its result is
    dropped before the next allocation)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _route_flips(model, params, tok, ranks: int) -> tuple:
    """Tokens whose experts differ between one forward of the whole batch
    and one forward per rank's rows (bf16 matmuls of other sizes round
    differently, and near-tied gates then pick other experts), and the
    token-layer routes compared."""
    if not model.cfg.num_experts:
        return 0, 0
    per = tok.shape[0] // ranks
    with _RouteLog() as whole:
        model.forward(params, tok)
    with _RouteLog() as split:
        for r in range(ranks):
            model.forward(params, tok[r * per:(r + 1) * per])
    layers = len(whole.idx)
    flips = sum(int((whole.idx[l] != torch.cat([split.idx[r * layers + l] for r in range(ranks)])
                     ).any(-1).sum()) for l in range(layers))
    return flips, sum(x[..., 0].numel() for x in whole.idx)


def dp_model(dev, arch) -> dict:
    """One data-parallel step of ``arch`` at full width over two ranks on
    the card against phase 9's one-rank step from the same state and batch:
    the loss and first moments by the microbatch gate, K4 / K5 launches,
    a bitwise repeat, and the planted faults (rank 1's gradient dropped;
    for MoE, each rank's own aux averaged)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh_for
    from repro_torch.models import LM
    from repro_torch.models.layers import moe_aux
    from repro_torch.train import SyntheticTokens, tree_map
    from repro_torch.train import train_step as ts
    from repro_torch.train._lm_pspecs import data_pspec

    t0 = time.perf_counter()
    batch, mb = DP_RUNS[arch]
    cfg = _train_cfg(arch, DP_DEPTH_CUT.get(arch))
    model = LM(cfg, device=dev, remat="full")
    state0 = ts.init_train_state(model, SEED)
    data = SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, batch, seed=SEED)
    tok, tgt = (torch.from_numpy(a).to(dev) for a in data.host_batch(0))
    one_fn, _ = ts.build_train_step(model, make_debug_mesh(1, 1, device=dev), batch, lr=DP_LR,
                                    microbatches=mb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one, m_one = one_fn(state0, tok, tgt)
    peak = torch.cuda.max_memory_allocated()
    one = one.opt.mu  # the gate reads the first moments; a state of granite's is 13 GB
    torch.cuda.empty_cache()
    one_ms = _event_ms(lambda: one_fn(state0, tok, tgt))
    card0 = torch.device("cuda", 0)
    mesh = make_mesh_for([card0] * DP_RANKS, shard_axes=("data", "model"), shape=(DP_RANKS, 1))
    dp_fn, _ = ts.build_train_step(model, mesh, batch, lr=DP_LR, microbatches=mb)
    shards = data.sharded_batch(0, mesh, data_pspec(mesh, batch))
    per_fwd = launches_per_forward(cfg)
    want = {k: DP_RANKS * mb * 2 * n for k, n in per_fwd.items()}
    dp_ms = _event_ms(lambda: dp_fn(state0, shards))
    # two steps from state0 under deterministic algorithms; the first is
    # read and moved to the host (a granite state is 13 GB) before the
    # second runs
    torch.use_deterministic_algorithms(True)
    try:
        flash_attention.launches = ssd_scan.launches = 0
        s1, m1 = dp_fn(state0, shards)
        counts = {"flash_attention": flash_attention.launches, "ssd_scan": ssd_scan.launches}
        rel = _mu_rel(s1, one)
        good_r = _mu_rel(s1, one, lambda p: p.endswith("w_router")) if cfg.num_experts else None
        s1 = tree_map(lambda t: t.cpu(), s1)
        torch.cuda.empty_cache()
        s2, m2 = dp_fn(state0, shards)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    same = _state_equal(s1, tree_map(lambda t: t.cpu(), s2)) and torch.equal(m1["loss"],
                                                                              m2["loss"])
    del s1, s2
    torch.cuda.empty_cache()
    flips, routes = _route_flips(model, state0.params, tok, DP_RANKS)
    loss_err = abs(float(m1["loss"]) - float(m_one["loss"]))
    print(f"data parallel {arch} (full width, {cfg.num_layers} layers, B={batch} as {mb} "
          f"microbatch(es), S={TRAIN_SEQ}, "
          f"{DP_RANKS} ranks on {card0}): loss {float(m1['loss']):.6f} vs the one-rank step's "
          f"{float(m_one['loss']):.6f} (|diff| {loss_err:.2e}, gate {DP_LOSS_TOL}); worst first "
          f"moment {rel:.3e} of its leaf's largest entry (gate {DP_LEAF_RTOL}); K4 / K5 "
          f"launches {counts} (expected {want}); two steps bitwise equal: {same}; step "
          f"{dp_ms:.1f} ms against the one-rank step's {one_ms:.1f} ms (CUDA events, one "
          f"each, on {card_line()})"
          + (f"; {flips} of {routes} token-layer routes pick other experts split by rank"
             if cfg.num_experts else ""))
    require(loss_err <= DP_LOSS_TOL, f"{arch}: the data-parallel loss misses the one-rank step's")
    require(rel <= DP_LEAF_RTOL, f"{arch}: data-parallel gradients miss the one-rank step's")
    require(counts == want, f"{arch}: data-parallel launches {counts}, expected {want}")
    require(same, f"{arch}: two data-parallel steps from one state differ")
    row = {"batch": batch, "microbatches": mb, "ranks": DP_RANKS, "loss_err": loss_err,
           "step_ms": dp_ms, "one_rank_step_ms": one_ms,
           "grad_max_rel": rel, "launches": counts, "bitwise_repeat": same,
           "route_flips": flips, "one_rank_peak_bytes": peak}
    if arch != "mamba2-370m":
        orig = ts._accumulate
        ts._accumulate = lambda acc, grads, rank, dt: acc if rank == 1 else orig(
            acc, grads, rank, dt)
        try:
            bad, _ = dp_fn(state0, shards)
        finally:
            ts._accumulate = orig
        fault = _mu_rel(bad, one)
        del bad
        torch.cuda.empty_cache()
        print(f"data parallel {arch}: planted fault (rank 1's gradient dropped) reads "
              f"{fault:.3e}, {fault / DP_LEAF_RTOL:.1f}x the gate")
        require(fault > DP_LEAF_RTOL, f"{arch}: the gate would pass a dropped rank")
        row["fault_rank_dropped"] = fault
    if cfg.num_experts:
        def router(path):
            return path.endswith("w_router")

        orig = ts.aux_share
        ts.aux_share = lambda own, top1, n: sum(moe_aux(m, f) for m, f in own) / n
        try:
            bad, m_bad = dp_fn(state0, shards)
        finally:
            ts.aux_share = orig
        bad_r = _mu_rel(bad, one, router)
        print(f"data parallel {arch}: router first moments {good_r:.3e} of their largest entry "
              f"(gate {DP_LEAF_RTOL}); planted fault (the mean of per-rank aux values in place "
              f"of the global aux) reads {bad_r:.3e}, {bad_r / DP_LEAF_RTOL:.1f}x the gate, loss "
              f"|diff| {abs(float(m_bad['loss']) - float(m_one['loss'])):.2e}")
        require(good_r <= DP_LEAF_RTOL, f"{arch}: the router's gradient misses")
        require(bad_r > DP_LEAF_RTOL, f"{arch}: the router gate would pass a per-rank aux")
        row.update({"router_max_rel": good_r, "fault_per_rank_aux": bad_r})
        del bad
        torch.cuda.empty_cache()
    del one, state0
    print(f"phase 10 {arch}: {time.perf_counter() - t0:.1f} s of wall time")
    return row


def cp_gate(out, q, k, v) -> tuple:
    """(per-element ratio, per-tile RMS) of a causal bf16 output against the
    float32 plain version, K4's gates (``K4_BF16_*``, ``K4_TILE_RMS``), and
    the reference itself."""
    from repro_torch.kernels.flash_attention import attention_plain

    ref = attention_plain(q.float(), k.float(), v.float(), causal=True)
    elem = ((out.float() - ref).abs() / (K4_BF16_ATOL + K4_BF16_RTOL * ref.abs())).max().item()
    return elem, tile_rms(out, ref).max().item(), ref


def phase_cp(dev) -> dict:
    """Phase 10 (b): ``cp_zigzag_attention`` over 16 ranks on the card at
    smollm-135m's layer, both modes, against the float32 plain version; a
    planted fault; its time beside one K4 call's; then a smollm-135m
    forward under ``ATTN_IMPL="cp_zigzag"`` against the same forward
    without it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cp_attention import cp_zigzag_attention, zigzag_positions
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_mesh_for, set_mesh
    from repro_torch.train import SyntheticTokens

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, hq, hkv, s, dh = CP_SHAPE
    q, k, v = (_randn(gen, (b, h, s, dh), dev, torch.bfloat16) for h in (hq, hkv, hkv))
    mesh = make_mesh_for([torch.device("cuda", 0)] * CP_SHARDS, shard_axes=("data", "model"),
                         shape=(1, CP_SHARDS))
    pos = torch.from_numpy(zigzag_positions(s, CP_SHARDS)).to(dev)
    back = torch.argsort(pos)
    flash_attention.launches = 0
    out = cp_zigzag_attention(q, k, v, p_shards=CP_SHARDS, mesh=mesh)
    launches = flash_attention.launches
    native = cp_zigzag_attention(q[:, :, pos], k[:, :, pos], v[:, :, pos], p_shards=CP_SHARDS,
                                 pre_permuted=True, mesh=mesh)[:, :, back]
    whole = flash_attention(q, k, v, causal=True)
    elem, rms, ref = cp_gate(out, q, k, v)
    n_elem, n_rms, _ = cp_gate(native, q, k, v)
    c = s // (2 * CP_SHARDS)
    hi = 2 * CP_SHARDS - 1  # rank 0's high chunk, the sequence's last
    fault = ref.clone()
    fault[:, :, hi * c:] = plain_rows(q[:, :, hi * c:], k, v, hi * c, drop=slice(hi * c, s))
    fault_rms = tile_rms(fault, ref).max().item()
    ms = median_ms(lambda: cp_zigzag_attention(q, k, v, p_shards=CP_SHARDS, mesh=mesh), reps=10)
    q_ms = queued_ms(lambda: cp_zigzag_attention(q, k, v, p_shards=CP_SHARDS, mesh=mesh),
                     reps=10)
    k4_ms = median_ms(lambda: flash_attention(q, k, v, causal=True), reps=10)
    k4_q_ms = queued_ms(lambda: flash_attention(q, k, v, causal=True), reps=10)
    print(f"CP attention B={b} {hq}/{hkv} heads of {dh}, S={s}, {CP_SHARDS} ranks on the card: "
          f"K4 launches a call {launches} (expected {2 * CP_SHARDS}); against the float32 plain "
          f"version, plain mode max|d| / ({K4_BF16_ATOL} + {K4_BF16_RTOL}|ref|) = {elem:.3f}, "
          f"tile RMS {rms:.3e}; native mode {n_elem:.3f}, {n_rms:.3e} (at most 1 and "
          f"{K4_TILE_RMS}); planted fault (rank 0's high chunk without its last key chunk) "
          f"reads {fault_rms:.3e}, {fault_rms / K4_TILE_RMS:.1f}x the limit; bitwise one K4 "
          f"call over the whole sequence: plain {torch.equal(out, whole)}, native "
          f"{torch.equal(native, whole)}; CP call {ms:.4f} ms (queue full {q_ms:.4f}) against "
          f"one K4 call {k4_ms:.4f} ms (queue full {k4_q_ms:.4f}), on {card_line()}")
    require(launches == 2 * CP_SHARDS, f"CP attention launched K4 {launches} times")
    require(max(elem, n_elem) <= 1.0 and max(rms, n_rms) <= K4_TILE_RMS,
            "CP attention disagrees with the float32 plain version")
    require(fault_rms > K4_TILE_RMS, "the CP gate would pass a dropped key chunk")
    row = {"shape": f"B={b} Hq={hq} Hkv={hkv} S={s} Dh={dh} bf16 causal, {CP_SHARDS} ranks",
           "k4_launches_per_call": launches, "elem_ratio": max(elem, n_elem),
           "tile_rms": max(rms, n_rms), "fault_tile_rms": fault_rms,
           "bitwise_one_k4_call": [torch.equal(out, whole), torch.equal(native, whole)],
           "ms": ms, "queued_ms": q_ms, "k4_ms": k4_ms, "k4_queued_ms": k4_q_ms}
    del q, k, v, out, native, whole, ref, fault
    # a smollm-135m forward routed through it
    model, params = _lm("smollm-135m", dev)
    tok = torch.from_numpy(SyntheticTokens(model.cfg.vocab_size, s, CP_FORWARD_BATCH,
                                           seed=SEED).host_batch(0)[0]).to(dev)
    base = model.forward(params, tok)[0]
    flash_attention.launches = 0
    impl = ops.ATTN_IMPL
    with set_mesh(mesh):
        ops.ATTN_IMPL = "cp_zigzag"
        try:
            routed = model.forward(params, tok)[0]
        finally:
            ops.ATTN_IMPL = impl
    fwd_launches = flash_attention.launches
    v_ = model.cfg.vocab_size
    err = (routed[..., :v_] - base[..., :v_]).abs().max().item()
    want = 2 * CP_SHARDS * launches_per_forward(model.cfg)["flash_attention"]
    print(f"CP forward smollm-135m (B={CP_FORWARD_BATCH}, S={s}) under ATTN_IMPL='cp_zigzag': "
          f"K4 launches {fwd_launches} (expected {want}); max|logits - the forward without it| "
          f"= {err:.3e} over every position (gate {LM_LOGIT_TOL}; bitwise "
          f"{torch.equal(routed, base)})")
    require(fwd_launches == want, "the CP forward's K4 launches")
    require(err <= LM_LOGIT_TOL, "the CP forward misses the forward without it")
    row.update({"forward_logit_err": err, "forward_k4_launches": fwd_launches,
                "forward_bitwise": torch.equal(routed, base)})
    del model, params, base, routed
    torch.cuda.empty_cache()
    print(f"phase 10 CP: {time.perf_counter() - t0:.1f} s of wall time")
    return row


def phase_dryrun(one_rank_peak: int, phase9_peak_gib) -> dict:
    """Phase 10 (c): the dry run of smollm-135m train_4k on the 16 x 16 meta
    mesh, then its memory estimate on a 1 x 1 mesh at phase 9's smollm run
    (B = 8 as 2 x 4, remat full) beside the peak this phase measured for
    that step on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.config import SHAPES

    t0 = time.perf_counter()
    res = dryrun.roofline_cell("smollm-135m", "train_4k")
    print("dry run smollm-135m train_4k on the 16 x 16 meta mesh: " + json.dumps(res))
    batch, mb = DP_RUNS["smollm-135m"]
    spec = dataclasses.replace(SHAPES["train_4k"], global_batch=batch)
    est = dryrun.memory_estimate(get_config("smollm-135m"), spec,
                                 dryrun.meta_mesh(shape=(1, 1)), mb)
    ratio = est["peak_bytes_per_rank_estimate"] / one_rank_peak
    print(f"dry run smollm-135m on a 1 x 1 mesh at B={batch} as {mb} x {batch // mb}, remat "
          f"full: peak estimate {est['peak_hbm_gib_estimate']:.3f} GiB against "
          f"torch.cuda.max_memory_allocated {one_rank_peak / 2 ** 30:.3f} GiB of the same step "
          f"(estimate / measured {ratio:.3f}); phase 9's run peaked at "
          f"{phase9_peak_gib:.3f} GiB (its B = 8 one-batch comparison included), on "
          f"{card_line()}; {time.perf_counter() - t0:.1f} s of wall time")
    return {"cell": res, "one_by_one": est, "measured_peak_bytes": one_rank_peak,
            "estimate_over_measured": ratio}


def phase_lm_parallel(dev, card: str, phase9_peak_gib) -> dict:
    """Phase 10: LM data parallelism over two ranks, zigzag context-parallel
    attention over sixteen, and the dry run."""
    t_phase = time.perf_counter()
    dp = {}
    for arch in DP_RUNS:
        dp[arch] = dp_model(dev, arch)
        torch.cuda.empty_cache()
    cp_row = phase_cp(dev)
    dry = phase_dryrun(dp["smollm-135m"]["one_rank_peak_bytes"], phase9_peak_gib)
    print(f"phase 10: {time.perf_counter() - t_phase:.1f} s of wall time, on {card}")
    return {"dp": dp, "cp": cp_row, "dryrun": dry}



# --------------------------------------------------------- phase 11 ----
LONG_SEQ = 32768  # prefill_32k and decode_32k (models/config.py:133-134)
# arch -> prefill_32k's batch on one card: the reference's 32 where the dry
# run's 1 x 1 estimate fits it (smollm-135m: 22.8 GiB), cut elsewhere
LONG_PREFILL = {"smollm-135m": 32, "mamba2-370m": 8, "gemma2-2b": 8, "minicpm3-4b": 4,
                "hubert-xlarge": 4, "minitron-4b": 4}
# the K4 calls of a prefill gated at their real activations (call order):
# gemma2-2b's first local (window 4096, softcap) and first global layer
LONG_K4_CALLS = {"gemma2-2b": (0, 1)}
LONG_CP_ARCHS = ("smollm-135m", "gemma2-2b")  # their causal global layers take CP at 32k
# arch -> (batch, fill chunk, layers): decode_32k against the K4 prefill of
# the same 32,768 tokens.  minicpm3-4b's absorbed decode is gated on its
# first 2 layers, as phase 8b gates it (its bf16 paths drift apart with
# depth): a fill reads the whole 32k cache at every chunk, and at 62 layers
# the fill alone would take over a minute.  Its chunks are 512 so that the
# (B, H, chunk, T) logits of 40 heads stay near 5 GB.
LONG_DECODE = {"smollm-135m": (8, 2048, None), "gemma2-2b": (4, 2048, None),
               "minicpm3-4b": (4, 512, 2)}
# The 32k gates' planted faults drop 1/16 of the keys their last rows see, the
# share phase 8b's one key tile is at S = 2048: at 32k one tile is 1/256 of a
# row's keys and moved smollm-135m's last logits by 3.7e-2, inside the bf16
# gap between its decode and its prefill (3.5e-2, on one H100; PERF.md section 6)
LONG_FAULT_SHARE = 16
CP_TRAIN_LOSS_TOL = 1e-4  # the CP step's loss against the one-call step's
# ... and its first moments against the one-call step's, phase 10's gate for
# a step computed over other partitions of the same work: the leaves are
# bf16, and the chunk calls' float32 attention (forward and backward) sums in
# another order than one call's, which flips roundings of bf16 activations
# and gradients by a step (2^-8 to 2^-7 of an entry; 5.9e-3 of the largest
# entry at reduced width on the CPU, tests/test_torch_long_context.py), above
# phase 9's Function gate (FN_BF16_MAXREL), which is printed beside it
CP_TRAIN_LEAF_RTOL = MB_LEAF_RTOL


def dropped_keys(s: int, rows: int, bk: int, causal=True, window=None) -> slice:
    """The keys a 32k gate's planted fault drops from the last ``rows``
    query rows (of S = T = ``s``): ``1 / LONG_FAULT_SHARE`` of the keys
    every one of them sees, whole tiles of ``bk`` keys, from their middle."""
    first = s - rows
    lo = max(0, s - window) if window is not None else 0
    hi = first + 1 if causal else s  # keys below hi: seen by every last row
    span = max(bk, (hi - lo) // LONG_FAULT_SHARE // bk * bk)
    d0 = max(lo, ((lo + hi) // 2 - span // 2) // bk * bk)
    return slice(d0, d0 + span)


def k4_rows_gate(q, k, v, out, causal=True, window=None, softcap=None, scale=None) -> dict:
    """K4's output ``out`` of one call at S = T on the query rows of
    ``k4_blocks`` against the float32 plain version of those rows over all
    of k and v (``plain_rows``; a whole (S, T) block does not fit at 32k),
    per element and per 128-row tile, and a planted fault in the same run:
    the last 256 rows without ``dropped_keys``."""
    from repro_torch.kernels.flash_attention import kernel_info, kernel_pair

    s = q.shape[2]
    kw = dict(window=window, softcap=softcap, causal=causal, scale=scale)
    elem = rms = err = 0.0
    for a, r in k4_blocks(s):
        ref = plain_rows(q[:, :, a:a + r], k, v, a, **kw)
        got = out[:, :, a:a + r].float()
        err = max(err, (got - ref).abs().max().item())
        elem = max(elem, ((got - ref).abs() / (K4_BF16_ATOL + K4_BF16_RTOL * ref.abs()))
                   .max().item())
        rms = max(rms, tile_rms(got, ref).max().item())
        del ref
    bk = kernel_info(*kernel_pair(q.shape[3], v.shape[3], q.dtype))["block_k"]
    first = s - 256
    drop = dropped_keys(s, 256, bk, causal, window)
    qb = q[:, :, first:]
    fault = tile_rms(plain_rows(qb, k, v, first, drop=drop, **kw),
                     plain_rows(qb, k, v, first, **kw)).max().item()
    return {"max_abs_err": err, "f32_elem_ratio": elem, "f32_tile_rms": rms,
            "fault_tile_rms": fault, "fault_keys": drop.stop - drop.start}


def plain_sliced_ms(q, k, v, causal=True, window=None, softcap=None, scale=None) -> float:
    """CUDA-event ms of K4's plain version over the whole call, one (batch
    row, query head) at a time: a (1, 1, S, T) float32 block fits the card
    where the call's (B, H, S, T) block does not.  One pass, after one warm
    slice."""
    from repro_torch.kernels.flash_attention import attention_plain

    g = q.shape[1] // k.shape[1]
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)

    def run(bh):
        b, h = bh
        attention_plain(q[b:b + 1, h:h + 1], k[b:b + 1, h // g:h // g + 1],
                        v[b:b + 1, h // g:h // g + 1], **kw)

    run((0, 0))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            run((b, h))
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _cp_mesh16():
    from repro_torch.launch.mesh import make_mesh_for

    return make_mesh_for([torch.device("cuda", 0)] * CP_SHARDS, shard_axes=("data", "model"),
                         shape=(1, CP_SHARDS))


def cp_long_call(arch, q, k, v, softcap, scale, k4_ms) -> dict:
    """``cp_zigzag_attention`` over 16 ranks on the card at a 32k call's
    operands: K4 launches (32), its rows against the float32 plain version
    (``k4_rows_gate``), bitwise one K4 call or not, its event median beside
    one K4 call's."""
    from repro_torch.kernels.cp_attention import cp_zigzag_attention
    from repro_torch.kernels.flash_attention import flash_attention

    mesh = _cp_mesh16()

    def call():
        return cp_zigzag_attention(q, k, v, softcap=softcap, scale=scale, p_shards=CP_SHARDS,
                                   mesh=mesh)

    before = flash_attention.launches
    out = call()
    launches = flash_attention.launches - before
    whole = flash_attention(q, k, v, causal=True, softcap=softcap, scale=scale)
    torch.cuda.synchronize()
    gate = k4_rows_gate(q, k, v, out, softcap=softcap, scale=scale)
    same = torch.equal(out, whole)
    ms = median_ms(call, reps=3, warmup=1)
    print(f"CP prefill_32k {arch}: {CP_SHARDS} ranks on the card, {launches} K4 launches a "
          f"call (want {2 * CP_SHARDS}); against the float32 plain version elem "
          f"{gate['f32_elem_ratio']:.3f}, tile {gate['f32_tile_rms']:.3e}; bitwise one K4 "
          f"call: {same}; {ms:.4f} ms a call against one K4 call's {k4_ms:.4f} ms, on "
          f"{card_line()}")
    require(launches == 2 * CP_SHARDS, f"{arch}: CP at 32k launched K4 {launches} times")
    require(gate["f32_elem_ratio"] <= 1.0 and gate["f32_tile_rms"] <= K4_TILE_RMS,
            f"{arch}: CP at 32k disagrees with the float32 plain version")
    return dict(gate, k4_launches_per_call=launches, bitwise_one_k4_call=same, ms=ms)


def cp_fault_attention(s: int):
    """``ops.attention_k4`` with a planted fault for CP's chunk calls: each
    chunk call reads the values of its own last key chunk (the diagonal
    block of its rows) as zeros."""
    from repro_torch.kernels import ops

    real = ops.attention_k4
    c = s // (2 * CP_SHARDS)

    def call(q, k, v, causal=True, window=None, softcap=None, scale=None):
        if q.shape[2] == c:
            v = torch.cat([v[:, :, :-c], torch.zeros_like(v[:, :, -c:])], 2)
        return real(q, k, v, causal=causal, window=window, softcap=softcap, scale=scale)

    return call


class AttnRoute:
    """While open: ``ops.ATTN_IMPL = impl`` under ``set_mesh(mesh)``, and
    with ``fault`` CP's chunk calls through ``cp_fault_attention``; all put
    back on exit."""

    def __init__(self, impl, mesh, fault_seq=None):
        self.impl, self.mesh, self.fault_seq = impl, mesh, fault_seq

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import set_mesh

        self.ops, self.saved = ops, (ops.ATTN_IMPL, ops.attention_k4)
        self.ctx = set_mesh(self.mesh)
        self.ctx.__enter__()
        ops.ATTN_IMPL = self.impl
        if self.fault_seq is not None:
            ops.attention_k4 = cp_fault_attention(self.fault_seq)
        return self

    def __exit__(self, *exc):
        self.ops.ATTN_IMPL, self.ops.attention_k4 = self.saved
        self.ctx.__exit__(*exc)


def cp_launches_per_forward(cfg, s: int) -> int:
    """K4 launches of one forward under a CP route at sequence ``s``:
    2 x 16 for each causal layer without a window, one for any other."""
    calls = 0
    for mixer, _ in cfg.block_pattern:
        if mixer in ("attn", "mla"):
            calls += 2 * CP_SHARDS if cfg.causal and s * s > 2048 * 2048 else 1
        elif mixer == "local":
            calls += 1
    return cfg.num_groups * calls


def cp_prefill_gate(arch, model, params, inputs, base) -> dict:
    """The 32k prefill under ``ATTN_IMPL="cp_zigzag"`` on a (1, 16) mesh of
    ranks on the card against the same prefill with one K4 call a layer
    (``base``, its logits): bitwise or within LM_LOGIT_TOL, K4 launches
    from the block pattern, and a planted fault above the gate."""
    from repro_torch.kernels.flash_attention import flash_attention

    s = LONG_SEQ
    mesh = _cp_mesh16()
    v = model.cfg.vocab_size
    flash_attention.launches = 0
    with AttnRoute("cp_zigzag", mesh):
        t0 = time.perf_counter()
        routed = model.forward(params, last_only=True, **inputs)[0]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    launches = flash_attention.launches
    with AttnRoute("cp_zigzag", mesh, fault_seq=s):
        fault = model.forward(params, last_only=True, **inputs)[0]
    torch.cuda.synchronize()
    want = cp_launches_per_forward(model.cfg, s)
    err = (routed[..., :v] - base[..., :v]).abs().max().item()
    fault_err = (fault[..., :v] - base[..., :v]).abs().max().item()
    same = torch.equal(routed, base)
    print(f"CP prefill_32k {arch} under ATTN_IMPL='cp_zigzag' ({CP_SHARDS} ranks on the card): "
          f"K4 launches {launches} (want {want}); last logits bitwise the one-call prefill's: "
          f"{same}, max|d| {err:.3e} (gate {LM_LOGIT_TOL}); planted fault (each CP call's "
          f"diagonal key chunk's values zeroed) {fault_err:.3e}, "
          f"{fault_err / LM_LOGIT_TOL:.1f}x the gate; {sec * 1e3:.1f} ms (host clock, one "
          f"forward)")
    require(launches == want, f"{arch}: the CP prefill launched K4 {launches} times")
    require(same or err <= LM_LOGIT_TOL, f"{arch}: the CP prefill misses one K4 call's")
    require(fault_err > LM_LOGIT_TOL, f"{arch}: the CP prefill gate would pass a fault")
    return {"k4_launches": launches, "bitwise": same, "err": err, "fault_err": fault_err,
            "forward_ms_host": sec * 1e3}


def k5_long_gate(x, a, b, c, chunk, cell: str = "prefill_32k") -> dict:
    """K5 at mamba2's first SSM layer's activations of a long prefill
    (``cell``) against ``ssd_plain`` (K5_TOL), over all of y and, printed on
    their own lines, over the upper half of the heads (whose chunk states lie
    past the middle of the state scratch: past byte 2^31 at S = 524,288) and
    over the second half of the chunks; a planted fault (the state carried
    into the middle chunk zeroed: the plain version of the second half
    alone), the kernel's and the plain version's event medians and the
    bound."""
    from repro_torch.kernels.ssd_scan import ssd_plain, ssd_scan

    y = ssd_scan(x, a, b, c, chunk=chunk)
    again = ssd_scan(x, a, b, c, chunk=chunk)
    plain = ssd_plain(x, a, b, c, chunk=chunk)
    s, h = x.shape[1], x.shape[2]
    half = s // chunk // 2 * chunk
    fault = ssd_plain(x[:, half:], a[:, half:], b[:, half:], c[:, half:], chunk=chunk)
    torch.cuda.synchronize()
    err = (y - plain).abs().max().item()
    err_heads = (y[:, :, h // 2:] - plain[:, :, h // 2:]).abs().max().item()
    err_chunks = (y[:, half:] - plain[:, half:]).abs().max().item()
    fault_err = (fault - plain[:, half:]).abs().max().item()
    del fault, plain
    scratch = x.shape[0] * h * (s // chunk) * x.shape[3] * b.shape[3] * 4
    print(f"K5 {cell}: heads {h // 2}-{h - 1} alone (their chunk states from byte "
          f"{scratch // 2:,} of the {scratch:,}-byte state scratch on): max|kernel - plain| "
          f"{err_heads:.3e} (tolerance {K5_TOL})")
    print(f"K5 {cell}: chunks {half // chunk}-{s // chunk - 1} alone: max|kernel - plain| "
          f"{err_chunks:.3e} (tolerance {K5_TOL})")
    require(torch.equal(y, again), f"K5 not bitwise repeatable at {cell}")
    ms = median_ms(lambda: ssd_scan(x, a, b, c, chunk=chunk), reps=3, warmup=1)
    plain_ms = median_ms(lambda: ssd_plain(x, a, b, c, chunk=chunk), reps=1, warmup=0)
    bsz, _, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = s // chunk
    live = chunk * (chunk + 1) // 2
    flops = bsz * h * nc * (2.0 * live * p + 4.0 * chunk * p * n) + bsz * g * nc * 2.0 * live * n
    nbytes = 4 * (2 * bsz * s * h * p + bsz * s * h + 2 * bsz * s * g * n)
    t_ops = K5_TF32_PRODUCTS * flops / TF32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bnd = max(t_ops, t_bytes)
    print(f"K5 {cell} mamba2-370m layer 0 at its real activations (B={bsz} S={s} H={h} "
          f"G={g} P={p} N={n} chunk {chunk}: {nc} chunks): max|kernel - plain| {err:.3e} "
          f"(tolerance {K5_TOL}); planted fault (the state carried into chunk {half // chunk} "
          f"zeroed) {fault_err:.3e}, {fault_err / K5_TOL:.1f}x the tolerance; kernel {ms:.4f} "
          f"ms, plain {plain_ms:.3f} ms, bound {bnd:.4f} ms ("
          f"{'operations' if t_ops >= t_bytes else 'bytes'}), on {card_line()}")
    require(err <= K5_TOL, f"K5 disagrees with its plain version at {cell}: {err}")
    require(fault_err > K5_TOL, f"the K5 {cell} gate would pass a zeroed carried state")
    return {"layout": f"B={bsz} S={s} H={h} G={g} P={p} N={n} chunk={chunk} f32",
            "max_abs_err": err, "upper_heads_err": err_heads, "second_half_chunks_err": err_chunks,
            "fault_err": fault_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bnd,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def long_prefill(dev, arch, card: str, spec=None) -> tuple:
    """``prefill_32k`` of one full-width model at ``LONG_PREFILL``'s batch
    (or the prefill ``spec``), built by ``launch/cells.py::build_cell_fn``:
    two forwards (the first read for its peak memory against the dry run's
    estimate, the second timed with CUDA events, profiled and compared bit
    for bit, with the first K4 calls, or the first K5 call, captured),
    launches over both from the block pattern; the K4 / K5 gates on the
    captured activations; for ``LONG_CP_ARCHS`` the CP prefill.  Returns the
    reading, the model and its parameters for the decode phase."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import build_cell_fn
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.config import SHAPES

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    if spec is None:
        spec = dataclasses.replace(SHAPES["prefill_32k"], global_batch=LONG_PREFILL[arch])
        require(spec.seq_len == LONG_SEQ, f"prefill_32k is S={spec.seq_len}")
    require(spec.kind == "prefill", f"{spec.name} is a {spec.kind} cell")
    batch, seq = spec.global_batch, spec.seq_len
    cell = spec.name if spec.name == "prefill_32k" else f"{spec.name} prefill"
    full_batch = SHAPES[spec.name].global_batch
    mesh = make_mesh_for([dev], shard_axes=("data", "model"), shape=(1, 1))
    fn, args = build_cell_fn(cfg, spec, mesh, seed=SEED)
    model, (params, tok) = fn.model, args
    inputs = {"tokens": None, "embeds": tok} if cfg.frontend != "none" else {"tokens": tok}
    est = dryrun.memory_estimate(cfg, spec, dryrun.meta_mesh(shape=(1, 1)), 1)
    torch.cuda.synchronize()
    flash_attention.launches = ssd_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    first = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    calls = LONG_K4_CALLS.get(arch, (0,)) if launches_per_forward(cfg)["flash_attention"] else ()
    timed = []

    def second_forward():  # CUDA events inside the profile: the device is busy throughout
        start.record()
        timed.append(fn(*args))
        end.record()

    with K4Capture(calls) as k4cap, SSDCapture() as k5cap:
        prof = spanned_profile(f"{arch} {cell} B={batch}", second_forward, [], warm=False)
    end.synchronize()
    ms = start.elapsed_time(end)
    second = timed.pop()
    counts = {"flash_attention": flash_attention.launches, "ssd_scan": ssd_scan.launches}
    per = launches_per_forward(cfg)
    v = cfg.vocab_size
    require(all(counts[k] == 2 * n for k, n in per.items()),
            f"{arch}: {cell} launches {counts}, want twice {per}")
    require(bool(torch.isfinite(first[..., :v]).all()), f"{arch}: non-finite {cell} logits")
    require(first.shape == (batch, 1, first.shape[-1]), f"{arch}: logits {tuple(first.shape)}")
    require(torch.equal(first, second), f"{arch}: {cell} logits differ between forwards")
    del second
    share = {"k4": prof["k4_ms"] / prof["busy_ms"] if prof["busy_ms"] else None,
             "k5": prof["k5_ms"] / prof["busy_ms"] if prof["busy_ms"] else None}
    kernel, kernel_ms, kernel_n = (("K4", prof["k4_ms"], per["flash_attention"])
                                   if per["flash_attention"] else
                                   ("K5", prof["k5_ms"], per["ssd_scan"]))
    print(f"{cell} {arch} (full width, {cfg.num_layers} layers, B={batch}"
          f"{'' if batch == full_batch else f' (the reference {full_batch} cut to fit one card)'}"
          f", S={seq}, "
          f"from {'frames' if cfg.frontend != 'none' else 'token ids'}): launches over 2 "
          f"forwards {counts}; logits {tuple(first.shape)} finite and bitwise repeatable, "
          f"max|logit| {first[..., :v].abs().max().item():.4f}; the second forward {ms:.1f} ms "
          f"(CUDA events), {batch * seq / ms * 1e3:.0f} tokens/s, profiled: busy "
          f"{prof['busy_ms']:.1f} of {prof['wall_ms']:.1f} ms, {kernel} {kernel_ms:.1f} ms of it "
          f"({100 * kernel_ms / max(prof['busy_ms'], 1e-9):.1f} %) over {kernel_n} launches a "
          f"forward; first forward's peak "
          f"{peak / 2 ** 30:.2f} GiB against the dry run's 1 x 1 estimate "
          f"{est['peak_hbm_gib_estimate']:.2f} GiB ({card})")
    out = {"batch": batch, "launches": counts, "per_forward": per, "ms": ms,
           "profile": prof, "share": share, "peak_bytes": peak,
           "estimate_bytes": est["peak_bytes_per_rank_estimate"], "k4": {}}
    for i in calls:
        q, k, vv, kw = k4cap.seen[i]
        label = f"K4 call {i}" + (f", window {kw['window']}" if kw["window"] else "")
        out["k4"][i] = k4_long_call(arch, q, k, vv, kw, label)
        del q, k, vv
    if k5cap.seen is not None:
        out["k5"] = k5_long_gate(*k5cap.seen, cell=cell)
    del k4cap, k5cap
    torch.cuda.empty_cache()
    if arch in LONG_CP_ARCHS:
        out["cp_prefill"] = cp_prefill_gate(arch, model, params, inputs, first)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{cell} {arch}: {out['seconds']:.1f} s of wall time")
    return out, model, params


def zeroed_values_attention():
    """K4 with a planted fault in every call: the values of 1 /
    LONG_FAULT_SHARE of the keys, from the middle of the sequence, read as
    zeros, for every query row that sees them.  A decode gate's fault must
    reach the last position through the layers: at 32k the last 256 rows of
    every call without 1/16 of their keys moved smollm-135m's and
    minicpm3-4b's last logits by 4.3e-2 and 4.7e-2, inside 5e-2 (on one
    H100; PERF.md section 6)."""
    from repro_torch.kernels.flash_attention import flash_attention

    def attention(q, k, v, causal=True, window=None, softcap=None, scale=None):
        t = k.shape[2]
        span = t // LONG_FAULT_SHARE
        d0 = t // 2 - span // 2
        v = torch.cat([v[:, :, :d0], torch.zeros_like(v[:, :, d0:d0 + span]),
                       v[:, :, d0 + span:]], 2)
        return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               scale=scale)

    return attention


def long_decode(dev, arch, model, params, card: str) -> dict:
    """``decode_32k``: the cache (``init_cache(B, 32768)``) filled with the
    first 32,767 tokens of a ``SyntheticTokens`` batch in chunks through
    ``LM.forward(tokens[:, i:i + c], cache=cache, cache_pos=i)`` (no K4
    call), then token 32,767 decoded, against the K4 prefill's
    ``last_only`` logits of the same 32,768 tokens; the tolerance from a
    control in the same run (SDPA in K4's place, or DECODE_LOGIT_TOL where
    SDPA takes no window or softcap); a prefill through
    ``zeroed_values_attention`` must break it."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import input_specs
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.config import SHAPES
    from repro_torch.train import SyntheticTokens

    t_phase = time.perf_counter()
    batch, chunk, layers = LONG_DECODE[arch]
    if layers is not None:
        model, params = cut_depth(model, params, layers)
    cfg = model.cfg
    spec = dataclasses.replace(SHAPES["decode_32k"], global_batch=batch)
    s = spec.seq_len
    mesh = make_mesh_for([dev], shard_axes=("data", "model"), shape=(1, 1))
    ins = input_specs(cfg, spec, mesh, model=model, seed=SEED)
    cache, pos = ins["cache"], ins["cache_pos"]
    tok_np, _ = SyntheticTokens(cfg.vocab_size, s, batch, seed=SEED).host_batch(0)
    tokens = torch.from_numpy(np.ascontiguousarray(tok_np)).to(dev)
    require(torch.equal(tokens[:, -1:], ins["tokens"]), f"{arch}: decode token mismatch")
    cache_bytes = sum(t.numel() * t.element_size() for c in cache for t in c.values())
    est = dryrun.memory_estimate(cfg, spec, dryrun.meta_mesh(shape=(1, 1)), 1,
                                 fill_chunk=chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    for i in range(0, pos, chunk):
        model.forward(params, tokens[:, i:min(i + chunk, pos)], cache=cache, cache_pos=i)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    dec = model.forward(params, ins["tokens"], cache=cache, cache_pos=pos)[0][:, 0]
    torch.cuda.synchronize()
    require(flash_attention.launches == 0, f"{arch}: the cached path launched K4")
    step_ms = median_ms(lambda: model.forward(params, ins["tokens"], cache=cache,
                                              cache_pos=pos), reps=3, warmup=1)
    v = cfg.vocab_size
    dec = dec[:, :v]
    del cache, ins
    torch.cuda.empty_cache()
    pre = model.forward(params, tokens, last_only=True)[0][:, 0, :v]
    err = (dec - pre).abs().max().item()
    fault = (prefill_with(model, params, tokens, zeroed_values_attention())[:, :v]
             - dec).abs().max().item()
    if arch in DECODE_LOGIT_TOL:
        control, tol = None, DECODE_LOGIT_TOL[arch]
        what = f"four bf16 steps at its logits ({tol}; SDPA takes no window or softcap)"
    else:
        control = (prefill_with(model, params, tokens, sdpa_attention)[:, :v]
                   - dec).abs().max().item()
        tol = max(LM_LOGIT_TOL, control)
        what = (f"max({LM_LOGIT_TOL}, the SDPA control's {control:.4e}) = {tol:.4e}")
    torch.cuda.synchronize()
    print(f"decode_32k {arch} ({cfg.num_layers} layers{'' if layers is None else ' (gated cut)'}"
          f", B={batch}): cache {cache_bytes / 1e9:.3f} GB filled with {pos} tokens in chunks "
          f"of {chunk} in {fill_s:.2f} s (no K4 launch); decode step at 32k {step_ms:.2f} ms "
          f"(CUDA events); max|decode - K4 prefill| of the last logits {err:.4e}, tolerance "
          f"{what}; planted fault (the values of 1/{LONG_FAULT_SHARE} of the keys zeroed in "
          f"every K4 call) {fault:.4e}, {fault / tol:.1f}x; max|logit| "
          f"{pre.abs().max().item():.4f}; fill peak {peak / 2 ** 30:.2f} GiB against the dry "
          f"run's 1 x 1 estimate with the fill's block {est['peak_hbm_gib_estimate']:.2f} GiB "
          f"({card}); {time.perf_counter() - t_phase:.1f} s of wall time")
    require(err <= tol, f"{arch}: decode_32k misses the K4 prefill by {err} (tolerance {tol})")
    require(fault > tol, f"{arch}: the decode_32k gate would pass zeroed values")
    return {"batch": batch, "fill_chunk": chunk, "layers": cfg.num_layers, "fill_s": fill_s,
            "decode_step_ms": step_ms, "cache_bytes": cache_bytes, "err": err, "tol": tol,
            "sdpa_control": control, "fault": fault, "peak_bytes": peak,
            "estimate_bytes": est["peak_bytes_per_rank_estimate"]}


def cp_train_step(dev) -> dict:
    """Phase 9's smollm-135m ``train_4k`` step (B = 8 as 2 x 4, remat full)
    under ``ATTN_IMPL="cp_zigzag"`` on a (1, 16) mesh of ranks on the card
    (the whole step inside ``set_mesh``: the remat recompute reads the route
    when the backward runs) against the same step with one K4 call a layer:
    the loss within CP_TRAIN_LOSS_TOL, the first moments (0.1 x the clipped
    gradient) within CP_TRAIN_LEAF_RTOL of each leaf's largest entry, K4
    launches (forward and recompute, 32 a layer); the same in
    ``"cp_zigzag_native"`` on tokens and targets permuted by
    ``zigzag_positions`` (a mean loss over the same tokens); a planted fault
    (each CP call's diagonal key chunk's values zeroed) above the gate."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.cp_attention import zigzag_positions
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import LM
    from repro_torch.train import SyntheticTokens
    from repro_torch.train import train_step as ts

    t0 = time.perf_counter()
    arch = "smollm-135m"
    batch, mb, remat, _, lr = TRAIN_RUNS[arch]
    cfg = get_config(arch)
    model = LM(cfg, device=dev, remat=remat)
    mesh = _cp_mesh16()
    state0 = ts.init_train_state(model, SEED)
    tok, tgt = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, batch, seed=SEED).host_batch(0))
    step, _ = ts.build_train_step(model, mesh, batch, lr=lr, microbatches=mb)
    flash_attention.launches = 0
    out = []
    one_ms = _event_ms(lambda: out.append(step(state0, tok, tgt)))
    (one, m_one), = out
    one_launches = flash_attention.launches
    pos = torch.from_numpy(zigzag_positions(TRAIN_SEQ, CP_SHARDS)).to(dev)
    want = 2 * mb * cp_launches_per_forward(cfg, TRAIN_SEQ)
    rows = {}
    for mode, t, g in (("cp_zigzag", tok, tgt), ("cp_zigzag_native", tok[:, pos], tgt[:, pos])):
        with AttnRoute(mode, mesh):
            flash_attention.launches = 0
            out = []
            ms = _event_ms(lambda: out.append(step(state0, t, g)))
            (new, m), = out
            launches = flash_attention.launches
        loss_err = abs(float(m["loss"]) - float(m_one["loss"]))
        rel = _mu_rel(new, one.opt.mu)
        rows[mode] = {"loss": float(m["loss"]), "loss_err": loss_err, "grad_max_rel": rel,
                      "k4_launches": launches, "step_ms": ms}
        print(f"CP train_4k {arch} ({mode}, B={batch} as {mb} x {batch // mb}, remat {remat}, "
              f"{CP_SHARDS} ranks on the card): loss {float(m['loss']):.6f} vs one K4 call a "
              f"layer {float(m_one['loss']):.6f} (|diff| {loss_err:.2e}, gate "
              f"{CP_TRAIN_LOSS_TOL}); worst first moment {rel:.3e} of its leaf's largest entry "
              f"(gate {CP_TRAIN_LEAF_RTOL}; {rel / FN_BF16_MAXREL:.2f}x phase 9's Function gate "
              f"{FN_BF16_MAXREL}); K4 launches a step {launches} (want {want}; one call "
              f"a layer: {one_launches}); step {ms:.1f} ms against {one_ms:.1f} ms (CUDA "
              f"events, one each, on {card_line()})")
        require(launches == want, f"CP train step ({mode}) launched K4 {launches} times")
        require(loss_err <= CP_TRAIN_LOSS_TOL, f"CP train step ({mode}): the loss misses")
        require(rel <= CP_TRAIN_LEAF_RTOL, f"CP train step ({mode}): gradients miss")
        del new
    with AttnRoute("cp_zigzag", mesh, fault_seq=TRAIN_SEQ):
        bad, m_bad = step(state0, tok, tgt)
    fault = _mu_rel(bad, one.opt.mu)
    print(f"CP train_4k {arch}: planted fault (each CP call's diagonal key chunk's values "
          f"zeroed) reads {fault:.3e}, {fault / CP_TRAIN_LEAF_RTOL:.1f}x the gate; loss "
          f"|diff| {abs(float(m_bad['loss']) - float(m_one['loss'])):.2e}; "
          f"{time.perf_counter() - t0:.1f} s of wall time")
    require(fault > CP_TRAIN_LEAF_RTOL, "the CP train gate would pass a zeroed key chunk")
    require(abs(rows["cp_zigzag_native"]["loss"] - rows["cp_zigzag"]["loss"])
            <= CP_TRAIN_LOSS_TOL, "the native mode's loss is not the plain mode's")
    del bad, one, state0
    torch.cuda.empty_cache()
    return {"one_call_k4_launches": one_launches, "one_call_step_ms": one_ms,
            "modes": rows, "fault": fault}


def phase_long_context(dev, card: str) -> dict:
    """Phase 11: the reference's long-context cells on the card."""
    t_phase = time.perf_counter()
    prefill, decode = {}, {}
    for arch in LONG_PREFILL:
        prefill[arch], model, params = long_prefill(dev, arch, card)
        if arch in LONG_DECODE:
            decode[arch] = long_decode(dev, arch, model, params, card)
        del model, params
        torch.cuda.empty_cache()
    train = cp_train_step(dev)
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s of wall time, on {card}")
    return {"prefill": prefill, "decode": decode, "cp_train": train}


def long_context_rows(long: dict) -> list:
    """The kernels line's rows of phase 11: K4 at 32k in each model (its
    launches over the two counted forwards), K5 at 32k, and zigzag CP at
    32k (its launches in the CP prefill)."""
    rows = []
    fa = {"route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
          "replaces": "src/repro/kernels/flash_attention.py:30"}
    for arch, r in long["prefill"].items():
        for i, call in r["k4"].items():
            rows.append(dict(fa, name=f"flash_attention (prefill_32k, {arch}, call {i})",
                             launches=r["launches"]["flash_attention"],
                             **{k: call[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "library_ms",
                                                     "layout", "f32_tile_rms",
                                                     "fault_tile_rms")},
                             prefill_ms=r["ms"], k4_share=r["share"]["k4"]))
            if "cp" in call:
                cp = call["cp"]
                rows.append(dict(fa, name=f"flash_attention (zigzag CP, prefill_32k, {arch})",
                                 wrapper="src/repro_torch/kernels/cp_attention.py",
                                 launches=r["cp_prefill"]["k4_launches"],
                                 max_abs_err=cp["max_abs_err"], ms=cp["ms"],
                                 plain_ms=call["plain_ms"], bound_ms=call["bound_ms"],
                                 bound_by=call["bound_by"], library_ms=call["library_ms"],
                                 layout=call["layout"] + f", {CP_SHARDS} ranks",
                                 bitwise_one_k4_call=cp["bitwise_one_k4_call"],
                                 launches_per_cp_train_step={
                                     m: x["k4_launches"]
                                     for m, x in long["cp_train"]["modes"].items()}))
        if "k5" in r:
            k5 = r["k5"]
            rows.append({"name": f"ssd_scan (prefill_32k, {arch})", "route": "cuda",
                         "source": "src/repro_torch/csrc/ssd_scan.cu",
                         "replaces": "src/repro/kernels/ssd_scan.py:29",
                         "launches": r["launches"]["ssd_scan"],
                         **{k: k5[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "layout")},
                         "prefill_ms": r["ms"], "k5_share": r["share"]["k5"]})
    return rows


# --------------------------------------------------------- phase 12 ----
LONG_500K = 524288  # SHAPES["long_500k"]: B = 1, kind decode (models/config.py:135)
# K4 at jamba's attention layer with S = T = 524,288: B, Hq, Hkv, Dh (bf16,
# causal); the heads and the first rows of the 128-row query tiles gated
# against the float32 plain version.  q and the output, (B, S, H, Dh)
# buffers seen as (B, H, S, Dh) as the layer gives them, hold 2^31 elements:
# row 262,144 starts at byte 2^31 and head 31's last row ends at byte 2^32.
# The plain version is timed over the whole rows of the same heads, a block
# of K4_500K_PLAIN_ROWS rows at a time (one head's (S, T) float32 block
# would take 1.1 TB; all 32 heads, about 180 s)
K4_500K = (1, 32, 8, 128)
K4_500K_HEADS = (0, 31)
K4_500K_TILES = (0, LONG_500K // 2, LONG_500K - 128)
K4_500K_PLAIN_ROWS = 4096


def decode_attention_limit(max_logit: float) -> float:
    """The per-head limit on the cached step's bf16 attention output against
    a float32 plain attention over the same q and cache, ``||o - ref|| /
    ||ref||`` (and ``max|o - ref|`` over the head's largest ``|ref|``): the
    step forms its logits in bf16 as the reference's does, so each logit
    is rounded twice (the product, then the scaled product; ``2^-9 |l|``
    each) and the probabilities and the output once each (``2^-9`` each).
    tests/test_torch_long_500k.py holds the same step on the CPU to it."""
    return 2.0 ** -8 * (2.0 + max_logit)


class DecodeAttentionCapture:
    """While open, ``models.layers.decode_attention`` (the cached step's
    attention) keeps each call's q, cache tensors, scale and output."""

    def __enter__(self):
        from repro_torch.models import layers

        self.layers, self.real, self.seen = layers, layers.decode_attention, []

        def capture(q, k_cache, v_cache, cache_pos, **kw):
            o = self.real(q, k_cache, v_cache, cache_pos, **kw)
            self.seen.append((q.clone(), k_cache, v_cache, cache_pos, kw, o.clone()))
            return o

        layers.decode_attention = capture
        return self

    def __exit__(self, *exc):
        self.layers.decode_attention = self.real


def seed_states(cache, gen, kv_scale=None) -> dict:
    """Fill a decode cache in place with seeded values (the reference's cell
    decodes against zeros, which cannot show that a step reads its cache):
    k and v at every position but the step's own (the last), N(0, 1) times
    ``kv_scale``'s ``(k, v)`` scales, in bf16; conv states N(0, 1) in bf16 and
    SSM states N(0, 1) in float32.  Returns the scales used."""
    used = {}
    for entry in cache:
        for key, leaf in entry.items():
            if key in ("k", "v"):
                scale = kv_scale[key]
                body = leaf[..., :-1, :]
                for g in range(body.shape[0]):  # a group at a time: float32 drafts stay small
                    body[g].copy_(torch.randn(body[g].shape, generator=gen, device=leaf.device)
                                  * scale)
            else:
                scale = 1.0
                leaf.copy_(torch.randn(leaf.shape, generator=gen, device=leaf.device))
            used[key] = scale
    return used


def clone_cache(cache) -> list:
    return [{k: v.clone() for k, v in entry.items()} for entry in cache]


def caches_equal(a, b) -> bool:
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


# A1's per-group limit: each layer group of the step, fed the CPU's own input
# hidden state and state, against the CPU's group, as ``||d|| / ||ref||`` of
# the group's increment (its output minus its input) and of each new state
# leaf.  The increment passes through about four bf16 roundings (in_proj,
# the gated output, the norm, out_proj), each 2^-9 of an entry, and the two
# devices sum their matmuls in other orders: four bf16 steps, 2^-6, hold
# that with room.  A state carried wrong moves the increment (zeroed: by
# about its own size) or the new state (scaled by 15/16: by 1/16 of it).
SSM_GROUP_REL = 2.0 ** -6
# ... and its 48-layer gate: the card's gap to the CPU over the whole step
# at most twice the gap the card's own per-group differences make when the
# CPU step replays them (each added to its group's output), or LM_LOGIT_TOL
SSM_REPLAY_FACTOR = 2.0


def traced_step(model, params, cache, pos, tok=None, embeds=None, replay=None):
    """One cached step of ``model`` with each block-pattern group's body
    traced: ``(logits, [(input, output)] per group)``, the hidden states in
    bf16.  ``replay`` (a float32 tensor per group) is added to each group's
    output before the next group reads it."""
    body_of, seen = model._group_fn, []

    def group_fn(cos, sin, cache_pos):
        body = body_of(cos, sin, cache_pos)

        def traced(x, gp, gc):
            y, terms = body(x, gp, gc)
            if replay is not None:
                y = (y.float() + replay[len(seen)].to(y.device)).to(y.dtype)
            seen.append((x.clone(), y.clone()))
            return y, terms

        return traced

    model._group_fn = group_fn
    try:
        logits = model.forward(params, tok, embeds=embeds, cache=cache, cache_pos=pos)[0]
    finally:
        del model._group_fn
    return logits, seen


def _rel(got, want) -> float:
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def depth_witness(model, params, cpu, params_cpu, tok, host, pos) -> dict:
    """A1's witness at full depth, a step of ``model`` (on the card) against
    the same step of ``cpu`` (on the CPU) from the state ``host``.  Each
    group alone: the card's group fed the CPU's input hidden state and the
    group's state, against the CPU's group (``SSM_GROUP_REL``, on the
    increment and on each new state leaf), and as planted faults the deepest
    group from its SSM state zeroed and scaled by 15/16 (a decay 1/16 too
    strong).  Then the CPU step replaying the card's per-group output
    differences: the gap those make over the whole depth, which the card's
    own gap is held to (``SSM_REPLAY_FACTOR``)."""
    dev = model.device
    c_cpu = clone_cache(host)
    want, seen = traced_step(cpu, params_cpu, c_cpu, pos, tok=tok.cpu())
    inc_rel, state_rel, delta = [], [], []
    for g, (x, y) in enumerate(seen):
        one, p_one = group_slice(model, params, g, g + 1)
        state = [{k: t[g:g + 1].to(dev, copy=True) for k, t in e.items()} for e in host]
        (_, y_d), = traced_step(one, p_one, state, pos, embeds=x.to(dev))[1]
        y_d = y_d.cpu()
        inc_rel.append(_rel(y_d.float() - x.float(), y.float() - x.float()))
        state_rel.append(max(_rel(a[k].cpu(), b[k][g:g + 1])
                             for a, b in zip(state, c_cpu) for k in a))
        delta.append(y_d.float() - y.float())
    last = len(seen) - 1
    one, p_one = group_slice(model, params, last, last + 1)
    x, y = seen[last]
    faults = {}
    for name, scale in (("zero", 0.0), ("decayed", 15 / 16)):
        bad = [{k: t[last:last + 1].to(dev) * scale if k == "ssm" else
                t[last:last + 1].to(dev, copy=True) for k, t in e.items()} for e in host]
        (_, y_f), = traced_step(one, p_one, bad, pos, embeds=x.to(dev))[1]
        faults[name] = max(_rel(y_f.cpu().float() - x.float(), y.float() - x.float()),
                           *(_rel(a[k].cpu(), b[k][last:last + 1])
                             for a, b in zip(bad, c_cpu) for k in a))
    replayed = traced_step(cpu, params_cpu, clone_cache(host), pos, tok=tok.cpu(),
                           replay=delta)[0]
    return {"want": want, "inc_rel": inc_rel, "state_rel": state_rel, "faults": faults,
            "replayed": replayed}


def long_500k_mamba2(dev, card: str) -> dict:
    """A1: mamba2-370m's ``long_500k`` cell, whole (48 layers), as
    ``build_cell_fn`` builds it: one token at ``cache_pos`` = 524,287.  Its
    cache is the conv and SSM state, O(1) in S.  The cell as built (a zero
    state) runs once; then from a seeded state (``seed_states``): two steps
    from copies of the state bitwise equal (logits and state), no K4 or K5
    launch, the step's time and its peak beside the dry run's estimate of
    the cell.  Card against CPU, the same step from the same parameters and
    state: gated at the first ``SSM_DECODE_GATE_LAYERS`` layers within
    LM_LOGIT_TOL, as phase 9's ``card_against_cpu`` cuts its models (the two
    devices' bf16 roundings drift apart with depth); the planted fault, the
    cut step from a zero state, must read above it.  At all 48 layers
    (``depth_witness``): each group alone against the CPU's from the same
    input and state within ``SSM_GROUP_REL``, the deepest from a faulty state
    as the planted faults; the whole step within ``SSM_REPLAY_FACTOR`` times the gap
    the CPU step makes replaying the card's per-group differences (or
    LM_LOGIT_TOL)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import build_cell_fn
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import LM
    from repro_torch.models.config import SHAPES
    from repro_torch.train import tree_map

    t0 = time.perf_counter()
    arch = "mamba2-370m"
    cfg = get_config(arch)
    spec = SHAPES["long_500k"]
    mesh = make_mesh_for([dev], shard_axes=("data", "model"), shape=(1, 1))
    fn, (params, tok, cache, pos) = build_cell_fn(cfg, spec, mesh, seed=SEED)
    model = fn.model
    require(pos == LONG_500K - 1 and tuple(tok.shape) == (1, 1), f"long_500k: pos {pos}")
    est = dryrun.memory_estimate(cfg, spec, dryrun.meta_mesh(shape=(1, 1)), 1)
    v = cfg.vocab_size
    flash_attention.launches = ssd_scan.launches = 0
    zero = fn(params, tok, cache, pos)[0][..., :v]  # the reference's cell: a zero state
    require(bool(torch.isfinite(zero).all()) and zero.shape == (1, 1, v),
            f"{arch}: long_500k logits {tuple(zero.shape)}")
    del cache, zero
    gen = torch.Generator(device=dev).manual_seed(SEED)
    seeded = model.init_cache(1, spec.seq_len)
    seed_states(seeded, gen)
    host = tree_map(lambda t: t.to("cpu", copy=True), seeded)  # the state the other steps start from
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    one = fn(params, tok, seeded, pos)[0][..., :v]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    again = tree_map(lambda t: t.to(dev, copy=True), host)
    two = fn(params, tok, again, pos)[0][..., :v]
    torch.cuda.synchronize()
    require(flash_attention.launches == 0 and ssd_scan.launches == 0,
            f"{arch}: the long_500k step launched a kernel")
    require(bool(torch.isfinite(one).all()), f"{arch}: non-finite long_500k logits")
    same = torch.equal(one, two) and caches_equal(seeded, again)
    step_ms = median_ms(lambda: fn(params, tok, again, pos), reps=3, warmup=1)
    del again, two
    params_cpu = tree_map(lambda t: t.cpu(), params)
    cpu = LM(cfg, device="cpu")
    wit = depth_witness(model, params, cpu, params_cpu, tok, host, pos)
    whole = (one.cpu() - wit["want"][..., :v]).abs().max().item()
    replay = (wit["replayed"][..., :v] - wit["want"][..., :v]).abs().max().item()
    to_replay = (one.cpu() - wit["replayed"][..., :v]).abs().max().item()
    whole_tol = max(LM_LOGIT_TOL, SSM_REPLAY_FACTOR * replay)
    group_rel = max(max(wit["inc_rel"]), max(wit["state_rel"]))
    gfault = min(wit["faults"].values())
    # the gate: the same step cut to its first layers, on both devices
    layers = SSM_DECODE_GATE_LAYERS
    cut_d, p_d = cut_depth(model, params, layers)
    cut_c, p_c = cut_depth(cpu, params_cpu, layers)
    groups = cut_d.cfg.num_groups

    def first_groups(c, device):
        return [{k: x[:groups].clone().to(device) for k, x in e.items()} for e in c]

    c_cpu = first_groups(host, "cpu")
    want = cut_c.forward(p_c, tok.cpu(), cache=c_cpu, cache_pos=pos)[0][..., :v]
    c_dev = first_groups(host, dev)
    got = cut_d.forward(p_d, tok, cache=c_dev, cache_pos=pos)[0][..., :v].cpu()
    zero_cut = [{k: torch.zeros_like(x) for k, x in e.items()} for e in c_dev]
    fault = (cut_d.forward(p_d, tok, cache=zero_cut, cache_pos=pos)[0][..., :v].cpu()
             - want).abs().max().item()
    err = (got - want).abs().max().item()
    ssm_err = max((a["ssm"].cpu() - b["ssm"]).abs().max().item() for a, b in zip(c_dev, c_cpu))
    cache_bytes = sum(t.numel() * t.element_size() for e in seeded for t in e.values())
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"long_500k {arch} ({cfg.num_layers} layers, full width, B=1, one token at "
          f"cache_pos {pos}; cache {cache_bytes / 1e6:.2f} MB, O(1) in S): the cell as built "
          f"(a zero state) and steps from a seeded state launch no K4 or K5; two steps from "
          f"one state bitwise equal: {same}; step {step_ms:.3f} ms (CUDA events); peak "
          f"{peak / 2 ** 20:.3f} MiB ({(peak - base) / 2 ** 20:.3f} MiB over the "
          f"{base / 2 ** 20:.3f} MiB allocated before the step: parameters "
          f"{param_bytes / 2 ** 20:.3f}, state {cache_bytes / 2 ** 20:.3f}) against the dry "
          f"run's 1 x 1 estimate {est['peak_bytes_per_rank_estimate'] / 2 ** 20:.3f} MiB "
          f"({card})")
    print(f"long_500k {arch} card against CPU from the seeded state: at its first {layers} "
          f"layers {err:.4e} (gate {LM_LOGIT_TOL}), SSM state {ssm_err:.3e}; planted fault (a "
          f"zero state) {fault:.4e}, {fault / LM_LOGIT_TOL:.1f}x the gate")
    print(f"long_500k {arch} each of its {len(wit['inc_rel'])} groups alone from the CPU's "
          f"input and state: ||d|| / ||ref|| of the increment largest "
          f"{max(wit['inc_rel']):.3e} (group {wit['inc_rel'].index(max(wit['inc_rel']))}), "
          f"median {statistics.median(wit['inc_rel']):.3e}; of the new state largest "
          f"{max(wit['state_rel']):.3e} (limit {SSM_GROUP_REL:.4e}); planted faults in the "
          f"deepest group, its SSM state zeroed {wit['faults']['zero']:.3e} and scaled by "
          f"15/16 {wit['faults']['decayed']:.3e}, {gfault / SSM_GROUP_REL:.1f}x the limit "
          f"or more; per group "
          + " ".join(f"{r:.2e}" for r in wit["inc_rel"]))
    print(f"long_500k {arch} at all {cfg.num_layers} layers: card against CPU {whole:.4e}; "
          f"the CPU step replaying the card's per-group differences against the CPU step "
          f"{replay:.4e}; gate max({LM_LOGIT_TOL}, {SSM_REPLAY_FACTOR} x that) = "
          f"{whole_tol:.4e}; the card against that replay {to_replay:.4e} (printed); "
          f"{sum(r == 0 for r in wit['inc_rel'])} of {len(wit['inc_rel'])} groups bitwise "
          f"the CPU's (max|logit| {one.abs().max().item():.4f}); "
          f"{time.perf_counter() - t0:.1f} s of wall time")
    require(err <= LM_LOGIT_TOL, f"{arch}: the long_500k step misses the CPU's by {err}")
    require(same, f"{arch}: two long_500k steps from one state differ")
    require(fault > LM_LOGIT_TOL, f"{arch}: the long_500k gate would pass a zero state")
    require(group_rel <= SSM_GROUP_REL,
            f"{arch}: a long_500k group misses the CPU's by {group_rel}")
    require(gfault > SSM_GROUP_REL, f"{arch}: the per-group gate would pass a faulty state")
    require(whole <= whole_tol, f"{arch}: the 48-layer long_500k step misses the CPU's by "
            f"{whole}, over {whole_tol}")
    return {"layers": cfg.num_layers, "gate_layers": layers, "err": err, "ssm_err": ssm_err,
            "err_all_layers": whole, "replay_err": replay, "all_layers_tol": whole_tol,
            "card_to_replay": to_replay,
            "group_inc_rel": wit["inc_rel"], "group_state_rel": wit["state_rel"],
            "group_faults": wit["faults"], "fault": fault, "bitwise": same, "step_ms": step_ms,
            "peak_bytes": peak, "before_step_bytes": base,
            "estimate_bytes": est["peak_bytes_per_rank_estimate"], "cache_bytes": cache_bytes}


def _f32_decode(q, k, v, scale):
    """float32 attention of the one query row at the last position over the
    whole cache (every key seen), by kv-head group (``plain_rows`` repeats
    the cache over the query heads: 17 GB at jamba's 524,288 keys).  The
    output (B, Hq, 1, Dv) and the largest |logit|."""
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    logits = torch.einsum("bkgsd,bktd->bkgst", q.float().reshape(b, hkv, hq // hkv, s, dh),
                          k.float()) * scale
    out = torch.einsum("bkgst,bktd->bkgsd", torch.softmax(logits, -1), v.float())
    return out.reshape(b, hq, s, v.shape[-1]), logits.abs().max().item()


def long_500k_jamba(dev, card: str) -> dict:
    """A2: jamba-v0.1-52b's ``long_500k`` step at one 8-layer group (phase
    8b's cut), built by ``build_cell_fn``: k and v (1, 8, 524,288, 128) bf16
    filled at positions 0..524,286 with seeded values at the scale of the
    layer's real k and v (read from a 2,048-token prefill of the same
    model), the SSM and conv states seeded (``seed_states``).  The attention
    layer's output at the step (captured with its q) against a float32
    plain attention over the same cache, per element and per head
    (``decode_attention_limit``); the planted fault, the same step's
    attention with the values of 1 / LONG_FAULT_SHARE of the keys zeroed,
    must read above it.  Two steps from copies of the cache bitwise equal,
    logits finite, no K4 or K5 launch; the step's time and its peak beside
    the dry run's estimate for the cut config."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import build_cell_fn
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import layers
    from repro_torch.models.config import SHAPES
    from repro_torch.train import SyntheticTokens, tree_map

    t0 = time.perf_counter()
    arch = "jamba-v0.1-52b"
    cfg = dataclasses.replace(get_config(arch), num_layers=LM_DEPTH_CUT[arch])
    spec = SHAPES["long_500k"]
    mesh = make_mesh_for([dev], shard_axes=("data", "model"), shape=(1, 1))
    fn, (params, tok, cache, pos) = build_cell_fn(cfg, spec, mesh, seed=SEED)
    model = fn.model
    est = dryrun.memory_estimate(cfg, spec, dryrun.meta_mesh(shape=(1, 1)), 1)
    prompt = torch.from_numpy(np.ascontiguousarray(
        SyntheticTokens(cfg.vocab_size, LM_SEQ, 1, seed=SEED).host_batch(0)[0])).to(dev)
    with K4Capture((0,)) as cap:
        model.forward(params, prompt, last_only=True)
    q0, k0, v0, _ = cap.seen[0]
    scales = {"q": q0.float().std().item(), "k": k0.float().std().item(),
              "v": v0.float().std().item()}
    del cap, q0, k0, v0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    seed_states(cache, gen, kv_scale=scales)
    spare = tree_map(lambda t: t.to("cpu", copy=True), cache)  # on the host: the step's peak is its own
    v = cfg.vocab_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    flash_attention.launches = ssd_scan.launches = 0
    with DecodeAttentionCapture() as att:
        one = fn(params, tok, cache, pos)[0][..., :v]
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    spare = tree_map(lambda t: t.to(dev, copy=True), spare)
    two = fn(params, tok, spare, pos)[0][..., :v]
    torch.cuda.synchronize()
    require(flash_attention.launches == 0 and ssd_scan.launches == 0,
            f"{arch}: the long_500k step launched a kernel")
    same = torch.equal(one, two) and caches_equal(cache, spare)
    del spare
    (q, kc, vc, cpos, kw, o), = att.seen
    require(kc.shape[2] == LONG_500K and int(cpos) == pos, f"{arch}: cache {tuple(kc.shape)}")
    ref, max_logit = _f32_decode(q, kc, vc, kw["scale"])
    limit = decode_attention_limit(max_logit)
    rms = tile_rms(o, ref).flatten()  # one row a head: its tile is the head
    elem = ((o.float() - ref).abs().amax((-1, -2)) / ref.abs().amax((-1, -2))).flatten()
    span = LONG_500K // LONG_FAULT_SHARE
    drop = slice(LONG_500K // 2 - span // 2, LONG_500K // 2 - span // 2 + span)
    zeroed = vc.clone()
    zeroed[:, :, drop] = 0
    bad = layers.decode_attention(q, kc, zeroed, cpos, **kw)
    fault = tile_rms(bad, ref).max().item()
    del zeroed, bad
    step_ms = median_ms(lambda: fn(params, tok, cache, pos), reps=3, warmup=1)
    require(bool(torch.isfinite(one).all()) and one.shape == (1, 1, v),
            f"{arch}: long_500k logits {tuple(one.shape)}")
    kv_bytes = 2 * kc.numel() * kc.element_size()
    print(f"long_500k {arch} (one group of {cfg.num_layers} layers, full width, B=1, one token "
          f"at cache_pos {pos}): k and v {tuple(kc.shape)} bf16 ({kv_bytes / 1e9:.3f} GB) filled "
          f"at positions 0..{pos - 1} with N(0, 1) x the layer's real k and v scales "
          f"{scales['k']:.4f}, {scales['v']:.4f} (its q: {scales['q']:.4f}; a {LM_SEQ}-token "
          f"prefill), conv and SSM states N(0, 1); no K4 or K5 launch")
    print(f"long_500k {arch} attention at the step against a float32 plain attention over the "
          f"same {LONG_500K} keys: largest head ||d|| / ||ref|| {rms.max().item():.3e}, largest "
          f"max|d| / max|ref| {elem.max().item():.3e} (limit 2^-8 (2 + max|logit| "
          f"{max_logit:.3f}) = {limit:.3e}); per head rms "
          + " ".join(f"{x:.2e}" for x in rms.tolist())
          + f"; planted fault (the values of 1/{LONG_FAULT_SHARE} of the keys zeroed) "
          f"{fault:.3e}, {fault / limit:.1f}x the limit; two steps bitwise equal: {same}; "
          f"max|logit| {one.abs().max().item():.4f}; step {step_ms:.3f} ms (CUDA events); "
          f"step peak {peak / 2 ** 20:.3f} MiB ({(peak - base) / 2 ** 20:.3f} MiB over the "
          f"{base / 2 ** 20:.3f} MiB allocated before it) against the dry run's 1 x 1 estimate "
          f"{est['peak_bytes_per_rank_estimate'] / 2 ** 20:.3f} MiB ({card}); "
          f"{time.perf_counter() - t0:.1f} s of wall time")
    require(rms.max().item() <= limit and elem.max().item() <= limit,
            f"{arch}: the long_500k attention misses the float32 plain version")
    require(fault > limit, f"{arch}: the long_500k attention gate would pass zeroed values")
    require(same, f"{arch}: two long_500k steps from one cache differ")
    return {"layers": cfg.num_layers, "kv_scales": scales, "head_rms": rms.max().item(),
            "elem": elem.max().item(), "limit": limit, "max_logit": max_logit,
            "fault": fault, "bitwise": same, "step_ms": step_ms, "peak_bytes": peak,
            "before_step_bytes": base, "estimate_bytes": est["peak_bytes_per_rank_estimate"],
            "kv_bytes": kv_bytes}


def k4_500k(dev, card: str) -> dict:
    """C: K4 at jamba's attention layer with S = T = 524,288 (the call a
    500k prompt's prefill makes there; ``K4_500K``), on seeded q, k and v
    drawn as (B, S, H, Dh) bf16 buffers and seen as (B, H, S, Dh), the
    layer's layout.  Three launches, counted: a warm one whose output is
    gated and two timed by CUDA events whose outputs must equal it bit for
    bit.  The gate: the tiles ``K4_500K_TILES`` of heads ``K4_500K_HEADS``
    against the float32 plain version (``plain_rows`` over the keys up to
    each tile's last row), per element and per tile; the planted fault drops
    1/16 of the keys the middle and the last tile see (``dropped_keys``; the
    first tile's rows share one key).  Beside it the plain version's time
    over those heads' whole rows, SDPA's where it takes the call, and the
    bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_plain, flash_attention,
                                                     kernel_info, kernel_pair)

    t0 = time.perf_counter()
    b, hq, hkv, dh = K4_500K
    s = LONG_500K
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def draw(heads):
        return torch.randn((b, s, heads, dh), generator=gen, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)

    q, k, v = draw(hq), draw(hkv), draw(hkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    out = flash_attention(q, k, v, causal=True)
    times, same = [], True
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        again = flash_attention(q, k, v, causal=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        same = same and torch.equal(out, again)
        del again
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times)
    g = hq // hkv
    bk = kernel_info(*kernel_pair(dh, dh, q.dtype))["block_k"]
    err = elem = rms = 0.0
    fault = math.inf
    readings = []
    for h in K4_500K_HEADS:
        kv = slice(h // g, h // g + 1)
        for first in K4_500K_TILES:
            last = first + 128
            qb, kb, vb = q[:, h:h + 1, first:last], k[:, kv, :last], v[:, kv, :last]
            ref = plain_rows(qb, kb, vb, first)
            got = out[:, h:h + 1, first:last].float()
            e = (got - ref).abs().max().item()
            r = tile_rms(got, ref).max().item()
            el = ((got - ref).abs() / (K4_BF16_ATOL + K4_BF16_RTOL * ref.abs())).max().item()
            err, rms, elem = max(err, e), max(rms, r), max(elem, el)
            row = {"head": h, "first_row": first, "max_abs_err": e, "tile_rms": r,
                   "elem_ratio": el, "q_byte": (first * hq + h) * dh * 2}
            if first > 0:
                drop = dropped_keys(last, 128, bk)
                row["fault_tile_rms"] = tile_rms(plain_rows(qb, kb, vb, first, drop=drop),
                                                 ref).max().item()
                fault = min(fault, row["fault_tile_rms"])
            readings.append(row)
            del ref, got
    plain_ms = 0.0
    rows = K4_500K_PLAIN_ROWS
    for h in K4_500K_HEADS:
        kv = slice(h // g, h // g + 1)

        def plain_head():
            for a in range(0, s, rows):
                attention_plain(q[:, h:h + 1, a:a + rows].float(), k[:, kv, :a + rows].float(),
                                v[:, kv, :a + rows].float(), causal=True)

        plain_ms += _event_ms(plain_head)
    lib_ms, backend = None, sdpa_backend(q, k, v, True)
    try:
        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
        sdpa()
        lib_ms = _event_ms(sdpa)
    except RuntimeError as exc:  # a yardstick only: a refusal is reported, not gated
        backend = f"refused ({str(exc).splitlines()[0][:120]})"
    bnd, by, flops, nbytes = k4_bound(q, k, v, True, None)
    layout = (f"B={b} Hq={hq} Hkv={hkv} S=T={s} Dh={dh} bf16 causal, (B, S, H, Dh) buffers "
              f"seen as (B, H, S, Dh)")
    for r in readings:
        print(f"K4 long_500k head {r['head']} rows {r['first_row']}-{r['first_row'] + 127} "
              f"(q from byte {r['q_byte']:,}): max|d| {r['max_abs_err']:.3e}, elem "
              f"{r['elem_ratio']:.3f} (at most 1), tile ||d|| / ||ref|| {r['tile_rms']:.3e} "
              f"(at most {K4_TILE_RMS})"
              + (f"; planted fault (1/{LONG_FAULT_SHARE} of the keys these rows see dropped) "
                 f"{r['fault_tile_rms']:.3e}" if "fault_tile_rms" in r else ""))
    print(f"K4 long_500k ({layout}): {launches} launches, outputs bitwise equal: {same}; kernel "
          f"{ms:.1f} ms (CUDA events, two calls after a warm one: "
          + ", ".join(f"{t:.1f}" for t in times)
          + f"), bound {bnd:.1f} ms ({by}), {100 * bnd / ms:.1f}% of it; plain (heads "
          f"{K4_500K_HEADS} of {hq}, {rows} rows at a time) {plain_ms:.1f} ms; SDPA "
          f"({backend}) {_ms(lib_ms)}; peak {peak / 2 ** 30:.2f} GiB (q, k, v and two outputs "
          f"{(3 * q.numel() + k.numel() + v.numel()) * 2 / 2 ** 30:.2f} GiB; no dry-run cell "
          f"holds one kernel call) ({card}); "
          f"{time.perf_counter() - t0:.1f} s of wall time")
    require(launches == 3, f"K4 long_500k launched {launches} times")
    require(same, "K4 not bitwise repeatable at S = 524,288")
    require(elem <= 1.0 and rms <= K4_TILE_RMS, "K4 disagrees with its float32 plain version at "
            "S = 524,288")
    require(fault > K4_TILE_RMS, "the K4 long_500k gate would pass dropped keys")
    return {"layout": layout, "launches": launches, "max_abs_err": err, "f32_elem_ratio": elem,
            "f32_tile_rms": rms, "fault_tile_rms": fault, "tiles": readings, "ms": ms,
            "times_ms": times, "plain_ms": plain_ms, "plain_heads": list(K4_500K_HEADS),
            "library_ms": lib_ms, "library_backend": backend, "bound_ms": bnd,
            "bound_by": by, "flops": flops, "bytes": nbytes, "peak_bytes": peak}


def phase_long_500k(dev, card: str) -> dict:
    """Phase 12: the reference's ``long_500k`` cell on the card, and the two
    kernel calls a 500k context needs: mamba2-370m's step (A1) and its
    524,288-token prefill through K5 (B), jamba's group against a seeded
    524,288 cache (A2), K4 at S = 524,288 (C).  Each model is freed before
    the next."""
    from repro_torch.models.config import SHAPES

    t0 = time.perf_counter()
    # the cuBLAS workspaces of the earlier phases' streams (32 MiB each) stay
    # allocated; released here, the peaks below hold this phase's own (the
    # dry run counts one stream's)
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    print(f"phase 12: released {(held - torch.cuda.memory_allocated()) / 2 ** 20:.3f} MiB of "
          f"cuBLAS workspaces held by earlier phases")
    out = {"mamba2": long_500k_mamba2(dev, card)}
    torch.cuda.empty_cache()
    spec = dataclasses.replace(SHAPES["long_500k"], kind="prefill")
    out["prefill"], model, params = long_prefill(dev, "mamba2-370m", card, spec=spec)
    del model, params
    torch.cuda.empty_cache()
    out["jamba"] = long_500k_jamba(dev, card)
    torch.cuda.empty_cache()
    out["k4"] = k4_500k(dev, card)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 12: {out['seconds']:.1f} s of wall time, on {card}")
    return out


def long_500k_rows(long: dict) -> list:
    """The kernels line's rows of phase 12: K5 at 524,288 (its launches over
    the two counted prefills) and K4 at S = 524,288 (its three counted
    launches)."""
    pre, k4 = long["prefill"], long["k4"]
    k5 = pre["k5"]
    return [
        {"name": "ssd_scan (long_500k prefill, mamba2-370m)", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:29",
         "launches": pre["launches"]["ssd_scan"],
         **{k: k5[k] for k in ("max_abs_err", "upper_heads_err", "second_half_chunks_err",
                               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                               "layout")},
         "prefill_ms": pre["ms"], "k5_share": pre["share"]["k5"]},
        {"name": "flash_attention (long_500k, jamba-v0.1-52b's attention layer)",
         "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:30",
         **{k: k4[k] for k in ("launches", "max_abs_err", "ms", "plain_ms", "plain_heads",
                               "bound_ms", "bound_by", "library_ms", "library_backend",
                               "layout", "f32_tile_rms", "fault_tile_rms")}},
    ]


# --------------------------------------------------------- phase 13 ----
EXAMPLE_SCALE = 0.5  # quickstart's default scale
EXAMPLE_STEPS = 20  # hgnn_train_acm's steps on the banded executor
EXAMPLES_BUDGET_S = 40.0  # the phase's wall-time budget (printed, not gated)
EXAMPLE_KERNELS = ("seg_sum_na", "edge_softmax_stats", "flash_attention")


def example_counters():
    """The launch counters of K1, K2 and K4, by kernel name."""
    from repro_torch.kernels.edge_softmax import edge_softmax_stats
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.seg_sum import seg_sum_na

    return dict(zip(EXAMPLE_KERNELS, (seg_sum_na, edge_softmax_stats, flash_attention)))


def run_example(label: str, fn, launches: dict, seconds: dict):
    """Run one example flow with K1, K2 and K4's counts set to 0 just
    before it and read just after; keep its counts and wall time."""
    counters = example_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds[label] = time.perf_counter() - t0
    launches[label] = {name: c.launches for name, c in counters.items()}
    print(f"examples: {label} took {seconds[label]:.2f} s; launches {launches[label]}")
    return out


def served_mismatches(responses, forwards) -> list:
    """The rids of responses whose logits are not, bit for bit, the rows of
    the compiled forward at their (graph, params_version): every row for a
    full-graph response, the first rows (the flow's subset requests ask for
    ids 0 .. n-1) for a subset one."""
    bad = []
    for r in responses:
        full = forwards[(r.graph, r.params_version)]
        rows = full if r.mode == "full" else full[: r.logits.shape[0]]
        if not np.array_equal(r.logits, rows):
            bad.append(r.rid)
    return bad


def phase_examples(card: str) -> dict:
    """Phase 13: the JAX package's four example flows, run on the card
    through the port's entry points (``repro_torch.examples``) at the
    reference's default arguments, each gated against the port on the CPU."""
    from repro_torch.api import ExecutorSpec, Session, device_features
    from repro_torch.examples import (hgnn_train_acm, lm_serve_demo, quickstart,
                                      restructure_demo)
    from repro_torch.train import propagated_feature_labels, semi_supervised_masks

    t_phase = time.perf_counter()
    launches, seconds = {}, {}
    q = run_example("quickstart", lambda: quickstart.main([str(EXAMPLE_SCALE)]),
                    launches, seconds)
    for name in ("seg_sum_na", "edge_softmax_stats"):
        require(launches["quickstart"][name] > 0, f"quickstart never launched {name}")
    cpu = Session(ExecutorSpec(planner="ctt", sgb_backend="host", device="cpu"),
                  cache=q["session"].cache)
    c_cpu = cpu.compile(q["graph"], quickstart.TARGETS, q["shgn"].cfg)
    ref = c_cpu.forward(c_cpu.init(0), device_features(q["graph"], "cpu"))
    err = (q["logits"].cpu() - ref).abs().max().item()
    print(f"examples: quickstart shgn logits {tuple(q['logits'].shape)}, max|cuda - cpu| = "
          f"{err:.3e} (tolerance {LOGIT_ATOL})")
    require(bool(torch.isfinite(q["logits"]).all()), "quickstart: non-finite logits")
    require(err <= LOGIT_ATOL, "quickstart: card logits disagree with the CPU run")

    acm_c, imdb_c = q["shgn"], q["imdb_tenant"].compiled
    g2 = q["graph"].apply_delta(q["delta"])
    feats = device_features(q["graph"])
    forwards = {key: out.cpu().numpy() for key, out in {
        ("acm", 1): acm_c.forward(acm_c.init(0), feats),
        ("acm", 2): acm_c.forward(q["swapped_params"], feats),
        ("acm", 3): q["acm"].compiled.forward(q["swapped_params"], device_features(g2)),
        ("imdb", 1): imdb_c.forward(imdb_c.init(0), device_features(q["imdb"])),
    }.items()}
    served = [(r.rid, r.graph, r.mode, r.params_version) for r in q["responses"]]
    bad = served_mismatches(q["responses"], forwards)
    first = q["responses"][0]
    zeroed = first.logits.copy()
    zeroed[first.logits.shape[0] // 2] = 0.0
    planted = served_mismatches([dataclasses.replace(first, logits=zeroed)], forwards)
    print(f"examples: served {served}; rows not bitwise their version's forward: {bad}; "
          f"with one row zeroed: {planted}")
    require(not bad, f"quickstart: served rows differ from their forwards: {bad}")
    require(planted == [first.rid], "quickstart: the served-rows gate passes a zeroed row")

    tr = run_example("hgnn_train_acm", lambda: hgnn_train_acm.main(
        ["--scale", "1.0", "--steps", str(EXAMPLE_STEPS), "--na-executor", "banded"]),
        launches, seconds)
    losses = tr["fit"]["losses"]
    n = tr["compiled"].num_target
    labels = propagated_feature_labels(tr["compiled"].semantic, hgnn_train_acm.TARGETS,
                                       tr["graph"].features, n, device="cpu")
    masks = semi_supervised_masks(n, seed=0, device="cpu")
    same_labels = torch.equal(tr["labels"].cpu(), labels) and all(
        torch.equal(tr["masks"][k].cpu(), masks[k]) for k in masks)
    print(f"examples: hgnn_train_acm losses {losses[0]:.6f} -> {losses[-1]:.6f} over "
          f"{len(losses)} steps; labels and masks bitwise the CPU's: {same_labels}")
    for name in ("seg_sum_na", "edge_softmax_stats"):
        require(launches["hgnn_train_acm"][name] > 0, f"hgnn_train_acm never launched {name}")
    require(len(losses) == EXAMPLE_STEPS and all(math.isfinite(x) for x in losses),
            "hgnn_train_acm: non-finite losses")
    require(losses[-1] < losses[0], "hgnn_train_acm: the last loss is not below the first")
    require(same_labels, "hgnn_train_acm: labels or masks differ from the CPU's")

    rs = run_example("restructure_demo", lambda: restructure_demo.main([]), launches, seconds)
    t0 = time.perf_counter()
    rs_cpu = restructure_demo.main(["--device", "cpu"])
    print(f"examples: restructure_demo again with --device cpu ({time.perf_counter() - t0:.2f} s): "
          f"equal {rs == rs_cpu}")
    require(rs == rs_cpu, "restructure_demo: numbers differ from the CPU run")

    lm = run_example("lm_serve_demo", lambda: lm_serve_demo.main([]), launches, seconds)
    short = {r.rid: len(lm["done"].get(r.rid, [])) for r in lm["requests"]
             if len(lm["done"].get(r.rid, [])) != r.max_new}
    require(not short, f"lm_serve_demo: requests short of max_new tokens: {short}")
    total = time.perf_counter() - t_phase
    print(f"phase 13 (examples): {total:.1f} s of wall time (budget {EXAMPLES_BUDGET_S:.0f} s), "
          f"on {card}; flows {', '.join(f'{k} {v:.2f} s' for k, v in seconds.items())}")
    return {"launches": launches, "seconds": seconds, "total_s": total, "quickstart_err": err}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def main() -> int:
    """Run every phase; the last line of stdout is the contract line."""
    # cuBLAS repeats bit for bit under torch.use_deterministic_algorithms
    # only with a fixed workspace, set before the first CUDA call (phase 9)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.hetero import make_dataset
    from repro_torch.kernels import cuda_build

    card = card_line()
    print(f"setup: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, numpy {np.__version__}, card {card}")
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(f"setup: built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for stem, info in built.items():
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # PyTorch's CPU build can get the first vectorized float op of a fresh
    # process wrong (seen with exp, about one process in 30); a throwaway
    # call keeps the CPU reference run below exact
    torch.exp(torch.linspace(-5.0, 5.0, 1 << 17))
    dev = torch.device("cuda")

    graph = make_dataset("ACM", seed=SEED, scale=1.0)
    dblp = make_dataset("DBLP", seed=SEED, scale=1.0)
    kernels = phase_kernels(graph, dblp, dev)
    launches = phase_model(graph)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        require(k["launches"] > 0, f"{k['name']} never launched on the banded path")
    train_launches = phase_train(graph, dblp, dev)
    phase_jnp_repeat(graph, dev)
    for k in kernels:
        k["launches_train_step"] = {m: c[k["name"]] for m, c in train_launches.items()}
    slice_rows, dep_launches, imdb_layers = phase_serving(graph, dev, card)
    kernels[0]["launches_dependency_forward"] = dep_launches
    delta_rows = phase_deltas(graph, imdb_layers, dev, card)
    shard_rows = phase_sharded(graph, dev, card)
    sgb_rows, sgb_dblp = phase_sgb(make_dataset, dev)
    session_launches = phase_device_session(make_dataset, dev)
    for k in kernels:
        k["launches_device_sgb_path"] = session_launches[k["name"]]
    kernels.extend(slice_rows)
    kernels.extend(delta_rows)
    kernels.extend(shard_rows)
    dblp = sgb_rows["DBLP"]  # the plan the device-SGB session runs
    t_ops = sum(r["ops"] for r in dblp) / INT8_OP_PER_S * 1e3
    t_bytes = sum(r["bytes"] for r in dblp) / HBM_BYTES_PER_S * 1e3
    int_mm = [r["library_int_mm_ms"] for r in dblp]
    kernels.append({
        "name": "spgemm_bsr", "route": "cuda",
        "source": "src/repro_torch/csrc/spgemm_kernels.cu",
        "replaces": "src/repro/kernels/spgemm_bsr.py:28",
        "launches": session_launches["spgemm_bsr"],
        "max_abs_err": max(r["err"] for rows in sgb_rows.values() for r in rows),
        "ms": sum(r["ms"] for r in dblp), "plain_ms": sum(r["plain_ms"] for r in dblp),
        "prepass_ms": sum(r["prepass_ms"] for r in dblp),
        "queued_ms": sum(r["queued_ms"] for r in dblp),
        "prepass_queued_ms": sum(r["prepass_queued_ms"] for r in dblp),
        "bound_ms": sum(r["bound_ms"] for r in dblp),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["library_ms"] for r in dblp),
        "library_int_mm_ms": None if None in int_mm else sum(int_mm),
        "library_int_mm_refused": sorted({r["int_mm_refused"] for r in dblp
                                          if r["int_mm_refused"]}) or None,
        "bytes": sum(r["bytes"] for r in dblp),
        "shape": f"DBLP scale 1.0 ctt plan, {len(dblp)} steps (times summed)",
        "acm": {key: sum(r[key] for r in sgb_rows["ACM"])
                for key in ("ms", "prepass_ms", "queued_ms", "prepass_queued_ms", "plain_ms",
                            "library_ms", "library_int_mm_ms", "bound_ms")},
        "dblp_sgb_breakdown": sgb_dblp,
    })
    require(kernels[-1]["launches"] > 0, "spgemm_bsr never launched on the device-SGB path")

    t0 = time.perf_counter()
    k4_rows, k4_f32_err, k5_rows, k4_native = phase_lm_kernels(dev)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s of wall time")
    t0 = time.perf_counter()
    models = {arch: _lm(arch, dev) for arch in LM_ARCHS}
    phase_lm_serving(dev, *models["smollm-135m"])
    lm_launches = phase_lm_prefill(dev, models)
    del models
    torch.cuda.empty_cache()
    print(f"phases 7-8: {time.perf_counter() - t0:.1f} s of wall time")
    t0 = time.perf_counter()
    lm_new = lm_new_phases(dev, card)
    print(f"phases 7-8b, new families: {time.perf_counter() - t0:.1f} s of wall time")
    native = {arch: r for arch, r in lm_new.items() if arch in K4_NATIVE}
    for arch, r in lm_new.items():
        if arch not in native:
            lm_launches[arch] = r["launches"]
    for name, rows, src, line in (
            ("flash_attention", k4_rows, "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:30"),
            ("ssd_scan", k5_rows, "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:29")):
        top = rows[1]  # B = 4, S = 4096
        err = max(r["max_abs_err"] for r in rows)
        if name == "flash_attention":
            err = max(err, k4_f32_err)
        by_model = {arch: counts[name] for arch, counts in lm_launches.items() if counts[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
            "replaces": line, "launches": sum(by_model.values()),
            "launches_by_model": by_model,
            "max_abs_err": err, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"], "bytes": top["bytes"],
            "shape": top["shape"], "shapes": rows,
        })
        if name == "flash_attention":
            kernels[-1]["prefill_activations"] = {
                arch: r["k4_activations"] for arch, r in lm_new.items() if arch not in native}
        require(kernels[-1]["launches"] > 0, f"{name} never launched on an LM prefill")
    for arch, row in k4_native.items():
        cfg_per = native[arch]["per_forward"]["flash_attention"]
        kernels.append({
            "name": f"flash_attention (native (Dqk, Dv), {arch})", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "wrapper": "src/repro_torch/kernels/flash_attention.py",
            "replaces": "src/repro/kernels/flash_attention.py:30",
            "launches": native[arch]["launches"]["flash_attention"],
            "launches_per_forward": cfg_per, **row,
            "prefill_activations": native[arch]["k4_activations"],
            "prefill_padded_route": native[arch]["padded_route"],
        })
        require(kernels[-1]["launches"] > 0, f"K4's native pair never launched on {arch}")
    t0 = time.perf_counter()
    train = phase_lm_train(dev, card)
    for k in kernels:
        if k["name"] in ("flash_attention", "ssd_scan"):
            k["launches_per_train_step"] = {
                arch: {"remat": TRAIN_RUNS[arch][2], "microbatches": TRAIN_RUNS[arch][1],
                       "launches": r["launches_per_step"][k["name"]]}
                for arch, r in train["models"].items() if r["launches_per_step"][k["name"]]}
            require(k["launches_per_train_step"], f"{k['name']} never launched in a train step")
    k4_row = next(k for k in kernels if k["name"] == "flash_attention")
    launch_row = train["models"]["smollm-135m"]["launch_train"]
    k4_row["launches_per_train_step"]["smollm-135m (launch/train.py)"] = {
        "remat": "none", "microbatches": TRAIN_RUNS["smollm-135m"][1],
        "launches": launch_row["k4_launches_per_step_remat_none"]}
    for arch in k4_native:  # the native pairs' own rows: their models' train steps
        row = next(k for k in kernels
                   if k["name"] == f"flash_attention (native (Dqk, Dv), {arch})")
        row["launches_per_train_step"] = {arch: k4_row["launches_per_train_step"][arch]}
    print(f"phase 9 (LM training): {time.perf_counter() - t0:.1f} s of wall time")
    par = phase_lm_parallel(dev, card, train["models"]["smollm-135m"]["peak_gib"])
    for k in kernels:
        if k["name"] in ("flash_attention", "ssd_scan"):
            k["launches_per_dp_step"] = {
                arch: {"ranks": r["ranks"], "microbatches": r["microbatches"], "remat": "full",
                       "launches": r["launches"][k["name"]]}
                for arch, r in par["dp"].items() if r["launches"][k["name"]]}
            require(k["launches_per_dp_step"],
                    f"{k['name']} never launched in a data-parallel step")
    k4_row["launches_per_cp_call"] = {"ranks": CP_SHARDS,
                                      "launches": par["cp"]["k4_launches_per_call"]}
    k4_row["cp"] = par["cp"]
    long = phase_long_context(dev, card)
    for row in long_context_rows(long):
        require(row["launches"] > 0, f"{row['name']} never launched on its 32k path")
        kernels.append(row)
    for row in long_500k_rows(phase_long_500k(dev, card)):
        require(row["launches"] > 0, f"{row['name']} never launched on its 524,288 path")
        kernels.append(row)
    torch.cuda.empty_cache()
    examples = phase_examples(card)
    for k in kernels:
        if k["name"] in EXAMPLE_KERNELS:
            k["launches_examples"] = {flow: counts[k["name"]]
                                      for flow, counts in examples["launches"].items()}
    for k in kernels:
        k["kernel_ms"] = k["ms"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
