#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. build the twelve CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, started together;
2. hold each forward and decode kernel against its plain PyTorch version
   on the card at the shapes of the serving path below, and time both
   with CUDA events around the call (``ms``, wrapper included) and the
   kernel alone with torch.profiler (``device_ms``); #1 in each band
   mode, one row per mode: ``l0_causal`` at the serving shapes,
   ``l0_bidir``, ``coarse_bidir`` and ``coarse_causal`` at the LRA
   path's (8 sequences x 8 heads, G=1, L=2048, d=64, nr=16, each
   sequence right-padded to a seeded true length in 500..2000; the
   coarse modes at every coarse level 1..6 of the coarsened chain,
   queries coarsened too);
3. the same for the two backward kernels at the training path's shapes
   (8 rows x 8 kv-heads, L=1024, every sub level) and #3 in the three
   modes above at the LRA shapes, from the forward kernels' saved
   outputs and seeded random cotangents; both fp32 paths are also
   measured against the float64 gradient of the same level (autograd
   of a dense masked forward) and reported.  The #2 and #4 rows and the
   coarse rows of #1 and #3 log each level (ratio or level, device ms,
   bound ms) on a line of its own and list it under ``levels``; every
   band row's bound counts only what the work needs
   (``h1d_block.sub_bytes``, ``h1d_block.band_bytes``): the rows with a
   live key and the key blocks some row reads, every output written,
   and ``bound_all_rows_ms`` beside it counts every row and key the
   band admits by position (the telemetry's count of the launch's
   record, ``repro_torch.obs.traffic``; so do #5's, #7's and #8's and
   ``update_bound``);
   The four paged decode kernels are held against their plain versions
   at paged serving shapes: 64 rows (8 slots x 8 kv-heads), G=1, d=64,
   nr=16, max_len 2048, pools of 1024+2 pages x 8 heads at every level,
   seeded page tables with private write pages and two inactive slots on
   the TRASH page; an fp32 pool, an int8 pool with every level
   quantized and a mixed pool (``quant_levels=3``); #5's (on a dense
   cache of the same 64 rows), #7's and #8's bounds count the key and
   value rows their band masks let through (#8, timed on the int8 pool:
   int8 rows and their scales; ``bound_all_rows_ms``: every band's
   rows).  The bf16 instantiations, rows ``<wrapper>[bf16]``, at the
   decode shapes the bf16 serving phases give them (4 slots, max_len
   4096, nr 16): #5 and #6 on a bf16 cache at yi-6b's (16 rows = 4
   slots x 4 kv-heads, G 8, head_dim 128), gemma3-4b's (16 rows, G 2,
   head_dim 256) and qwen2.5-14b's (32 rows, G 5, head_dim 128), the
   rest at yi-6b's: #7 and #9 on a bf16
   pool (two rows inactive on TRASH), #8 and #10 (phase 25 (a)) on a
   pool whose level 0 is int8 and the rest bf16, #11 and #12 as shard
   1's call at d = 2; attends
   within 1e-5 of their plain versions on the f32 output, updates bit
   for bit over 3 chained appends (carries in bf16), bounds counting 2
   bytes a cache element;
4. serve the paper LM ``h1d-lm-53m`` at full width (seeded random
   weights) with ``ServeEngine(slots=8, max_len=2048)``: 16 requests with
   seeded prompt lengths in 64..1500 and 32 greedy tokens each; every
   serving kernel must have launched and no plain version may have run;
5. for two served requests, hold the teacher-forced logits of the kernel
   path against the plain path on the card, and the decode path against
   the full forward;
5b. paged serving of the same model, workload ``paged-prefix``: 16
   requests, each a shared seeded 1000-token prefix plus a unique tail of
   16..500 tokens (seed 1), requests 14 and 15 repeating the prompts of
   0 and 1 and submitted right after them (so their frontier pages are
   shared and then copied on write), 32 greedy tokens each, through (a)
   the dense engine (the oracle), (b) a paged fp32 engine with 1024
   pages, (c) a paged fp32 engine small enough to preempt (swap) and (d)
   a paged int8 engine (every level) with the largest pool whose bytes
   fit (c)'s.  #7/#9 must have launched in (b) and (c), #8/#10 in (d),
   no plain version anywhere; (c) must preempt, copy on write, hit the
   prefix registry and end with no page in use; (b) and (c) must give
   (a)'s tokens for every request whose teacher-forced top-2 margins all
   exceed 1e-3; (d)'s token-match rate against (a) is reported;
5c. ``sp``, sequence-parallel serving of the same model and weights with
   each layer's cache split along its sequence axis into d shards on the
   card: (a) #11 and #12 against their plain versions at serving shapes
   (R=64 rows = 8 slots x 8 kv-heads, G=1, d=64, nr=16, max_len 2048) on
   every shard at d=2 and d=4, seeded positions including 0, 15, 16,
   every shard edge s*Lloc - 1 and s*Lloc, 2047 and the out-of-range
   2048; #11's merged output against #5 on the unsharded cache; #12
   bit-exact per shard (slabs and carries) and the whole SP update (with
   the d=4 deep-level #6 step) against #6 on the unsharded cache; each
   timed as one shard's call at d=4, its bound counted from what that
   shard's call needs; #6 on the replicated deep tail at d=4 (one level,
   bit-exact over 3 chained updates, timed and bounded as the row
   ``update_cache_fused[sp_deep]``, which takes the SP path's launches
   of #6, the ``update_cache_fused`` row the rest); phase 4's 16 prompts
   as one batch padded to the
   2048 bucket, prefilled in a 4-way ``sp_scope`` and densely: logits
   within 1e-3, the SP caches (through ``shard_cache`` and
   ``unshard_cache``) within 1e-4 row-scaled, layer 0's bit-exact;
   (b) ``ServeEngine(slots=8,
   max_len=2048, mesh=make_mesh((4,), ("data",)))`` on phase 4's 16
   requests, (c) d=2 on its first 4 and (d) slots=1, d=4 on its first:
   every request whose teacher-forced top-2 margins all exceed 1e-3 must
   give phase 4's tokens, #11, #12, #6 and #1 / #2 under SP prefill
   must have launched and no plain version run; tokens/s, decode ms per
   tick and prefill ms per call beside the dense engine's;
6. train ``h1d-lm-53m`` at full width and depth from seeded random
   weights for 20 AdamW steps on ``ZipfLM(seed=0)`` batches of 8 x 1024
   through ``repro_torch.train.loop.train``: every loss finite, the mean
   of the last five below the first; every band kernel of both passes
   launched and no plain version run; tokens/s over the wall time of the
   steps after the first;
7. the whole model's ``lm_loss`` gradient for one 2 x 1024 batch on the
   kernel path against the plain path on the card, leaf by leaf;
8. ``lra``: the paper's LRA encoder ``h1d-lra-encoder`` at full width
   and depth (6 x 512, 8 heads, FFN 2048, nr 16, vocab 256) from seeded
   random weights: (a) classify one held-out ``ListOps(seq_len=2048,
   batch_per_host=64, seed=999)`` batch under inference mode, logits
   within 1e-3 of the plain path's, wall per call and classifications
   per second; (b) 10 AdamW steps (warmup 10 and weight decay 0.01 as
   ``benchmarks/bench_lra_listops.py``, peak 3e-4 as phase 6: the
   bench's 2e-3 suits its 64-wide model, and at full width the loss
   rises under it) on ``ListOps(seq_len=2048, batch_per_host=32,
   seed=0)`` batches: every loss finite, the
   mean of the last five below the first, median step ms, tokens/s, mean
   true length, peak memory, and the busy share of one step; in (a) and
   (b) every bidirectional mode of #1 (and of #3 in (b)) launched and no
   plain version run; (c) the encoder's ``classifier_loss`` gradient for
   a 2 x 2048 batch, kernel against plain path, leaf by leaf as in 7;
   (d) ``h1d-lm-53m`` with ``causal_mode='coarse-q'``: 3 AdamW steps
   through ``train`` (#1 and #3 in ``l0_causal`` and ``coarse_causal``
   launched, no plain version run), then its ``lm_loss`` gradient at
   2 x 1024 as in 7;
9. ``sp train``, sequence-parallel training of ``h1d-lm-53m`` (full
   width and depth, seeded random weights): (a) at d = 4 and d = 2 the
   ``lm_loss`` gradient of one 2 x 1024 batch under a d-way
   ``sp_scope`` against the unsharded gradient on the kernel path, leaf
   by leaf as in 7 (at d = 4 levels 0-4 run per shard and level 5 is
   gathered; at d = 2 all six run per shard); (b) at d = 4
   ``sp_h1d_attention``'s forward and q/k/v gradients at L 1024, nr 16,
   head dim 64, G 1 in fine-q, coarse-q and bidirectional mode against
   the unsharded operator on the kernel path, forward within 2e-5 and
   gradients within 1e-4, row-scaled; (c) 3 AdamW steps through
   ``train(..., mesh=make_mesh((4,), ("data",)))`` on ``ZipfLM(seed=0)``
   8 x 1024 batches, every loss finite, step ms and tokens/s beside
   phase 6's.  In (a)-(c) #1-#4 launch exactly once per shard, local
   level and layer and no plain version runs; then every distinct band
   kernel call of (a)-(c) (by shapes and options, on the inputs it was
   given) is held against its plain version with phase 2's and 3's
   bounds;
10. ``cq serve``: phase 4's 16 requests with ``causal_mode='coarse-q'``
   (same weights, 8 slots, max_len 2048, prompts unbucketed): #1 in
   ``l0_causal`` and ``coarse_causal`` in prefill, #5 and #6 in decode,
   no plain version; every request whose top-2 margins all exceed 1e-3
   gives the plain path's tokens; tokens/s, prefill ms a call and
   decode ms a tick beside phase 4's;
11. ``sample``: phase 4's requests with ``greedy=False, seed=0`` at 8
   slots twice and at 1 slot: the two 8-slot runs identical, every
   request whose top-2 margins of logits plus noise all exceed 1e-3
   the same at 1 slot; #1, #2, #5, #6 launched, no plain version;
   tokens/s.  (Phases 10 and 11 run after 5c, 9 after 7.)
12. ``gemma``, after 8: (a) the row ``band_attention_fwd[l0_causal_stream]``,
   #1's streamed body against its plain version at the local layers'
   shapes (4 kv-heads x G 2, nr 1024, d 256, L 4096 and 3072, keys live
   to 3000; and L 1024 at nr 128, d 64), with ``library_ms`` from
   ``scaled_dot_product_attention`` under the same mask; (b)
   ``gemma3-4b`` at full width in its published bf16, cut to 12 of its
   34 layers (10 local at window 1024, 2 global h1d: two 5:1 periods;
   drawing all 34 on the host took 154.5 s of the 1200) from seeded
   weights,
   ``ServeEngine(slots=4, max_len=4096)`` on 8 greedy requests of 16
   tokens with prompt lengths 1100..3968 (seed 0), unbucketed: the
   streamed #1, #1 and #2 (global prefill), #5 and #6 on bf16 caches
   launched, no plain version; tokens/s, prefill ms a call, decode ms a
   tick, peak memory; then the same requests through an engine on the
   plain versions, and through the kernels again with the plain run's
   tokens handed in (teacher forcing, so both decode the same
   contexts): every step's logits (the prefill's last position, then
   each decode tick on the bf16 caches) within 3e-2 of the plain row's
   largest |logit|.
13. ``gemma train``, after 12: (a) the row
   ``band_attention_bwd[l0_causal_stream]``, #3's streamed backward
   against its plain version at phase 12's row shape (4 x G 2, L 4096,
   nr 1024, d 256, keys live to 3000) from the streamed forward's
   outputs and seeded random cotangents on y, dn and m, two calls the
   same bits, with ``library_ms`` from the backward of
   ``scaled_dot_product_attention`` under the same mask; (b) on phase
   12's weights (drawn once, from the seed ``init_state`` would use),
   ``remat=True`` with policy ``dots`` as published, ``ZipfLM(seed=0)``
   1 x 4096 batches: on the first 6 layers (5 local, 1 global) the
   first batch's loss within 2e-2 of the plain path's, the gradient
   with ``remat_policy='none'`` within 1e-6 of each leaf's largest
   |remat gradient|, remat with the lower peak memory, and the
   ``lm_loss`` gradient on the kernel path against the plain path as in
   7 on the weights widened to fp32 and the first sequence (the band
   kernels run fp32 in either dtype); the in-place AdamW update against
   the functional one, bit for bit over 3 steps, on a 2-layer tree of
   the same weights (the embedding in row chunks); then 3 AdamW steps
   at phase 12's 12 layers through ``train``, in place (a step consumes its
   state): every loss finite, the first the kernel path's loss of the
   first batch, each band path launched exactly as often as the step
   runs it (the rematerialised forwards twice: forward and recompute),
   no plain version, peak memory below the card's; step ms, tokens/s,
   peak memory.
14. ``dense bf16``, after 13: ``yi-6b`` at full width cut to 2 of its
   32 layers (G 8, head_dim 128, untied head) and ``qwen2.5-14b`` at
   full width cut to 1 of its 48 layers (G 5, qkv bias), published
   bf16, seeded weights drawn layer by layer on the host (their time
   logged; the cuts keep the draw within the time limit),
   ``ServeEngine(slots=4, max_len=4096)`` on 8 greedy requests of 16
   tokens, prompt lengths 1000..3900 (seed 0), bucketed as the engine
   buckets fine-q prompts: #1, #2, #5 and #6 (bf16) launched, no plain
   version, every step's logits on the plain run's tokens against the
   plain run's as in 12; yi-6b's requests also through a paged engine
   (#7, #9 on bf16 pools) and a 2-way SP engine (#11, #12 on bf16
   slabs), each on the plain run's tokens and held to its logits the
   same way; tokens/s, prefill ms, decode ms, peak memory.
15. ``llama train``, after 14: ``llama3.2-1b`` at full width and depth
   (16 layers, tied embeddings), published bf16, remat policy ``dots``,
   ``ZipfLM(seed=0)`` 2 x 4096 batches: the checks of 13 (b) (the fp32
   gradient against the plain path at G 4, d 64, L 4096 too), then 3
   AdamW steps (peak 1e-3) whose loss falls; step ms, tokens/s,
   peak memory.
16. ``full``, after 15: the paper's full-attention baseline and the
   dense oracles.  (a) ``h1d_dense_oracle`` against ``h1d_attention``
   on the kernel path (B 2, G 4, L 1024, d 64, nr 16, seeded key
   weights with zeros) in fine-q, coarse-q and bidirectional mode,
   within 2e-5 + 1e-4 |oracle| (the reference's tolerance,
   ``tests/test_h1d_attention.py``); ``band_attention_ref`` against #1
   in every mode and #2 at every sub level at phase 2's shapes, within
   1e-5 * max(1, |oracle|).  (b) ``h1d-lm-53m`` with
   ``attention='full'`` at full width and depth on phase 4's traffic
   (16 requests, prompts 64..1500, 32 greedy tokens, 8 slots, max_len
   2048, bucketed): no kernel runs, every step's logits within 1e-3 of
   a teacher-forced full-sequence forward's; tokens/s, prefill ms and
   tick ms beside phase 4's.  (c) the same model, 3 AdamW steps at 8 x
   1024 on phase 6's ``ZipfLM(seed=0)`` batches and schedule: losses
   finite, the last below the first; step ms, tokens/s, peak memory
   beside phase 6's.  (d) the LRA
   encoder with ``attention='full'``, and with full attention in a
   16-token window (Table 1's "local": #1 ``l0_bidir`` at nr 16 once a
   layer, its logits within 1e-3 of the plain path's) on phase 8a's
   held-out batch; sequences/s.  (e) ``bench_scaling``'s sweep (B 1, G
   1, d 32, nr 16, L 256..16384, causal): ``h1d_attention`` on the
   kernels and ``dense_attention``, ms by CUDA events and log-log
   slopes, on a line of their own (``{"scaling": ...}``).

17. ``families``: the MoE and VLM families.  (a), with the kernel rows
   of 2-3 before any model phase: rows
   ``<name>@<arch>``: #1 ``l0_causal``, #2, #3 and #4 at one sequence's
   kv-heads of ``qwen2-moe-a2.7b`` (16 rows, G 1) and ``llava-next-34b``
   (8 rows, G 7), head_dim 128, L 4096, every other row right-padded
   past 3000, q, k, v rounded to bf16; #5 and #6 on bf16 caches at
   qwen2-moe's decode shape (64 rows, G 1) and llava's (16 rows, G 7),
   #7 and #9 on a bf16 pool at qwen2-moe's; each held to its plain
   version as in 2, 3 and the bf16 rows, its launches those of the phase
   17 paths that run that shape.  After 16: (b) ``qwen2-moe-a2.7b`` at full width,
   2 of its 24 layers (1.76 B parameters), bf16, seeded weights:
   ``ServeEngine(slots=4, max_len=4096)``, bucketed, on 8 greedy
   requests of 16 tokens, prompt lengths 1000..3900 (seed 0): #1, #2,
   #5, #6 launched, no plain version; then the plain run and the kernels
   on its tokens on dense slots and on a paged bf16 pool (#7, #9), every
   call of the port's routing function logged on both sides (by
   wrapping ``models.ffn.route`` here): each position whose experts
   differ counted, the first differing layer of each a near tie in the
   plain run (its gap between the k-th and (k+1)-th router logit within
   ``2 * 2^-8 * max_e sum_d |x_d| |r_de|``, what rounding every router
   input element by one bf16 ulp can move two logits apart), and every
   step whose token's experts agreed in every layer held to the plain
   run's logits as in 12 (at least 3/4 of the steps).  (c) on (b)'s
   weights, the checks of 13 (b) at 1 x 4096 on ``ZipfLM(seed=0)`` (the
   fp32 gradient's plain pass routed to the kernel pass's experts; any
   flip is reported with its gap) and 3 in-place AdamW steps through
   ``train``: step ms, tokens/s, peak memory, the aux loss.  (d)
   ``llava-next-34b`` at full width, 1 of its 60 layers (1.48 B):
   ``lm_prefill`` of 576 seeded patch embeddings (numpy, seed 0, x 0.02)
   and a 1024-token prompt at B 2, Lmax 4096, then 16 decode steps, the
   kernels on the plain run's tokens, every step's logits held as in 12
   (#1, #2, #5, #6 launched).  (e) one in-place AdamW step at 1 x (576 +
   3520) with ``patch_embeds`` on (d)'s weights.  The kernel line's
   ``launches_by_path`` holds ``moe`` ((b): the first kernel run and the
   paged run), ``moe_train`` ((c)'s steps) and ``vlm`` ((d), (e)).
18. ``ssm families``: the SSM and hybrid families.  (a), with phase 17's
   rows: ``<name>@zamba2-1.2b``, #1 ``l0_causal``, #2, #3 and #4 at one
   zamba2 sequence's 32 kv-heads x G 1, head_dim 64, L 4096, and #5 and
   #6 on bf16 caches at its decode shape (128 rows = 4 slots x 32, D
   64, Lmax 4096), held as phase 17 holds its rows.  After 17: (b)
   ``mamba2-1.3b`` at full width (d 2048, d_inner 4096, 64 heads, N
   128, chunk 256), 8 of its 48 layers, bf16, seeded weights: one mixer
   in fp32 on the card against the CPU at S 4096 (chunk 256) and 4093
   (chunk 1), within 1e-4 of the CPU's largest entry; ``ssd_chunked``
   against ``ssd_reference`` on the card within the reference's bound
   (atol 2e-4, rtol 1e-3); on 2 layers in fp32 a 300-token prefill
   against the same prompt decoded token by token from zero state, the
   last logits within 2e-4 of max |logit|; ``lm_prefill`` ms at 1 x
   4096 and 1 x 4093; ``ServeEngine(slots=4, max_len=4096)`` on 8
   greedy requests of 16 tokens, prompts 1000..3900 (seed 0),
   unbucketed (no kernel runs); 3 in-place AdamW steps at 1 x 4096 on
   one repeated batch (remat and no remat gradients bit for bit, the
   loss falling).  (c)
   ``zamba2-1.2b`` at full width, 12 of its 38 layers (two invocations
   of the shared h1d block), bf16: served as 14 serves (#1, #2, #5, #6
   launched; every step's logits on the plain run's tokens within 3e-2
   of max |plain|), then 13 (b)'s checks at 1 x 4096 (the fp32
   gradient against the plain path; the mixers' A_log and dt_bias,
   sums over the sequence that cancel, within 1e-3 of their largest
   |plain|: two plain paths differ by 3.1e-4 there) and 3 in-place
   AdamW steps, #3 and
   #4 launched once an invocation a step (the shared block runs outside
   the remat).  ``launches_by_path`` holds ``ssm``, ``ssm_train``,
   ``hybrid`` and ``hybrid_train``.
19. ``encdec``: the encoder-decoder family, ``seamless-m4t-medium`` (12
   encoder and 12 decoder layers, d 1024, 16 heads of 64, d_ff 4096,
   vocabulary 256206, nr 16).  (a), with phase 17's rows:
   ``<name>[<mode>]@seamless-m4t-medium``, #1 and #3 in ``l0_bidir`` and
   ``coarse_bidir`` (coarse levels 1..7, each logged) at one clip's
   encoder attention: 16 heads x G 1, L 4096, d 64, q, k, v rounded to
   bf16, keys live to a seeded length in 3000..4096; held as phases 2-3
   hold theirs.  After 18, at full width and depth in the published bf16
   from seed-0 weights drawn once (~30 s): (b1) 4 clips of 4096 seeded
   stub frames, an 8-token target prefix each, 32 greedy tokens at Lmax
   1024 (``DECODER_LEN``); (b2) 3 single clips of 1000..4000 frames
   (none a multiple of 16: the encoder pads), target prefixes of
   100..300 tokens, 16 tokens each; each through ``prefill`` and
   ``decode_step`` on the plain path, then the kernels on its tokens:
   every step's logits and every layer's ``mem_k`` / ``mem_v`` within
   3e-2 of max |plain|; #1 in ``l0_bidir``, ``coarse_bidir`` and
   ``l0_causal``, #2, #5 and #6 (bf16) launched, no plain version;
   prefill ms, tick ms, tokens/s, peak memory.  (c) on those weights
   (consumed), one repeated batch of 1 x 4096 frames (``frame_weight`` 0
   past a seeded length in 3000..4096) and 1024 target tokens: the loss
   on the kernels within 2e-2 of the plain path's; the fp32 gradient of
   the first 2 + 2 layers against the plain path as in 7; 3 in-place
   AdamW steps with remat through ``train``: the loss falls, each band
   path launched exactly as the steps run it (#1 and #3 in all three
   modes, #2, #4), no plain version; step ms, tokens/s (live frames and
   target tokens), peak memory.  ``launches_by_path`` holds ``encdec``
   and ``encdec_train``.

20. ``telemetry``, after 19: ``repro_torch.obs`` through the CLIs on
   ``h1d-lm-53m`` at full size.  (a) ``launch.serve`` as phase 4 serves
   it (8 slots, max_len 2048, prompts 64..1500, seed 0, 16 greedy
   tokens): 8 requests dense, then 4 ``--paged --cache-dtype int8``, 4
   ``--paged`` (fp32) and 4 ``--sp-data 2``, each with ``--trace-out``,
   ``--prom-out`` and ``--metrics-jsonl`` into a temporary directory;
   (b) ``launch.train``, 2 steps at 2 x 1024, ``--telemetry
   --trace-out``.  (c) For each run: the trace (with kernel traffic),
   the snapshot, every JSONL line and the Prometheus text (with
   ``repro_kernel_launches_total``, ``repro_serve_ttft_s_bucket``,
   ``repro_serve_itl_s_bucket`` and ``repro_serve_ticks_total``; train:
   ``repro_train_steps_total``) pass the port's validators, no trace
   event dropped; every family's ``kernel.launches`` equals its
   wrappers' launches in the run and its ``kernel.hbm_*_bytes`` the
   traffic model's sum over the run's launch records; the ``serve.tick``
   (``train.step``) spans number ``serve.ticks`` (``train.steps``); no
   plain version runs; the runs launch all twelve families.  The dense
   run also with telemetry off (a warm-up, then three turns of off and
   ``--telemetry`` alone): every run's greedy tokens equal the first's.
   (d) TTFT and ITL p50/p99, ticks, tokens/s (on and off), the host cost
   of one ``decode_attend_fused`` call with telemetry off and on, and
   per family the launches, GB moved and GFLOP, each beside the card's
   name and power limit.  ``launches_by_path`` holds ``telemetry``.
21. ``sp families``: sequence-parallel serving (d = 2 on the one card)
   of the sliding-window, hybrid and SSM configs at full width in their
   published bf16.  (a) With the kernel rows: #11 and #12 on bf16 slabs
   (Lmax 4096) on every shard against their plain versions at gemma3-4b's
   decode shape (16 rows = 4 slots x 4 kv-heads, G 2, D 256) and
   zamba2-1.2b's (128 rows, G 1, D 64), attends within 1e-5, updates
   and carries bit for bit over 3 chained appends; the streamed #1 at
   the per-shard shape of gemma's SP prefill (4 kv-heads x G 2 x 1024
   rows, nr 1024, d 256) on both shards against its plain version, and
   the whole SP band (local launches + halo edge term) against the plain
   unsharded level, its y / dn within 2e-5 row-scaled as phase 9 holds
   the SP operator; rows ``<name>@<arch>-sp``.  (b) After
   phase 12: gemma3-4b cut to the first 6 of phase 12's 12 layers (one
   5:1 local/global period), ``ServeEngine(slots=4, max_len=4096)`` on 8
   greedy requests of 16 tokens, prompts 1000..3900 (seed 0, unbucketed:
   those padded to 2048 or 4096 keep a whole window a shard, so their
   local layers run the streamed body per shard), without a mesh, then
   with ``mesh=make_mesh((2,), ("data",))`` on the mesh-free run's
   tokens; (c) zamba2-1.2b at phase 18's 12 layers and weights, after
   its plain run, on the plain run's tokens (the shared block's caches
   sharded, the SSM states whole); (d) mamba2-1.3b at phase 18's 8
   layers and weights, on its mesh-free run's tokens (every cache whole,
   no kernel).  Each SP run: every step's logits within 3e-2 of the
   mesh-free run's largest |logit|; for gemma and zamba2 #11 and #12
   launched in bf16 and #5 never (and for gemma the streamed #1), for
   mamba2 no launch, no SP dispatch and no sharded cache; telemetry on,
   every family's ``kernel.launches`` equal to its wrappers' launches.
   ``launches_by_path`` holds ``gemma_sp``, ``hybrid_sp`` and ``ssm_sp``.
22. ``kernels section`` (run first, right after the build, ~10 s):
   ``repro_torch.analysis``'s checker, shared memory and launch policy
   on the card.  (a) One ``contracts.capture()`` around ``launch.serve``
   on h1d-lm-53m dense, paged int8, paged fp32 and SP d = 2 (2 requests,
   4 tokens each), one ``launch.train`` step at 2 x 1024 and a bf16
   decode at yi-6b's shape, under a fresh policy with no table: every
   record checks clean, its grid read back from the launcher equals the
   checker's mirror, its ``smem`` the shared memory the launcher set,
   registers at most 255 and at least one CTA an SM; one line per
   family.  (b) Every candidate of ``band_fwd`` / ``band_bwd``
   (``l0_causal``) and ``sub_bwd`` (every sub level) at the LM's
   training shape forced through ``tq=``, and every stage plan of #7
   and #8 at the paged serving shape through a table entry: within 1e-5
   (forward, attends) and 1e-4 (backward) of the plain versions.  (c)
   ``autotune_band`` of ``band_fwd`` and ``band_bwd`` there into a
   temporary ``$REPRO_TUNE_CACHE``; a fresh policy that cannot measure
   applies each table (source ``table``), the launches at the tables'
   tiles match the plain versions, the digest moves.  (d) Every decision
   of (a) is ``default``.  (e) The records at the kernel table's shapes
   (PERF.md), held as (a)'s.  (f) The host cost of a policy resolution.
23. Planning (``parallel/{sharding,pipeline}.py``, ``launch/{specs,
   dryrun,roofline}.py``), last: (a) ``h1d-lm-53m`` at full width (fp32,
   6 layers) split into 3 pipeline stages of 2 layers, 6 microbatches
   of 1 x 1024 tokens through ``pipeline_apply`` on the card: hidden
   states within 2e-5 of the same layers applied in sequence, every
   gradient leaf within 1e-4 of its largest |sequential|, and #1-#4's
   launches equal to the sequential run's; (b) the dry run's per-card
   argument bytes on a 1 x 1 mesh against the growth of
   ``torch.cuda.memory_allocated()`` when the port builds the same
   arguments on the card by its own entry points, within 1 %:
   ``llama3.2-1b`` train at 1 x 4096, the parameters by the model's
   init, the AdamW state by the optimizer's init on them, the batch;
   ``yi-6b`` decode at 1 x 32768, the caches by the model's cache init,
   token and position (its parameters are placed beside them, undrawn
   and not measured: the init's CPU draw of 6.06 G would take
   minutes); (c) one ``llama3.2-1b`` train step at 1 x 4096
   on the card, its FLOPs counted there (``FlopCounterMode`` and the
   kernels' launch records) within 1 % of the roofline's u / 2u
   extrapolation on meta tensors, its device ms (CUDA events) printed
   beside the roofline bound; (d) the whole dry run, 80 cells on meta
   tensors over up to 8 processes: every cell ok.
24. ``ranks``, last: one shard a process (``parallel/group.py``), 2 ranks
   started by ``torch.distributed.run`` on the normal CLIs, both on the
   one card (``--device cuda:0``, gloo: NCCL refuses two ranks on one
   card).  (a) ``launch.serve --sp-data 2`` on ``h1d-lm-53m`` at full
   width serves phase 5c (c)'s 4 requests (8 slots, max_len 2048, 32
   tokens): every rank's tokens equal that one-process d = 2 run's, and
   phase 4's where its margins guard them; each rank launches #1, #2,
   #11 and #12 half as often as the one-process run, #6 as often as
   half of its (none: d = 2 keeps no replicated deep level at 2048) and
   no plain version; rank 0's median decode tick and the part of it in
   collectives (each timed between synchronizations).  (b)
   ``launch.train --sp --mesh 2``, 3 steps at 4 x 1024: every rank's
   losses within 1e-5 of max(1, |loss|) of the same command line run in
   this process (the one-process layout), parameters bit-identical
   across ranks, #1-#4 half the one-process launches.  (c)
   ``tools/pipeline_ranks.py``: ``pipeline_apply`` at S = 2, a stage a
   rank (phase 23 (a)'s model in 2 stages of 3 layers, 4 microbatches of
   1 x 1024): hidden states and gradients as 23 (a) against the
   sequential run in each rank's process, band launches half of it.
   With two or more cards (a)-(c) run again, a card a rank (NCCL);
   with one, a line says that leg did not run.  A rank that fails fails
   the phase.  ``launches_by_path`` holds ``ranks``.
25. ``int8 + bf16`` and ``tp train``: (a), with the bf16 kernel rows,
   the row ``update_cache_paged_quant[bf16]``: #10 at yi-6b's decode
   shape (16 rows, D 128, Lmax 4096) on a pool whose level 0 is int8
   and the rest bf16, bit for bit against its plain version outside
   TRASH over 3 chained appends, timed and bounded as the other update
   rows.  (b) In phase 14's yi-6b loop, on the weights drawn there:
   ``ServeEngine(paged=True, cache_dtype="int8", quant_levels=1)`` on
   the plain versions, then on the kernels with that run's tokens, every
   step's logits within 3e-2 of the plain run's largest |logit|
   (``forced_run``: quantization moves logits, so the oracle is a plain
   run of the same int8 pool); #8 and #10 launched on bf16 levels, no
   plain version.  (c) Last: ``launch.train --mesh 1x2``, ``2x1`` and
   ``2x2`` (``parallel/tensor.py``: tensor parallelism over the model
   axis, data parallelism over the data axis), started by
   ``torch.distributed.run`` with ``--device cuda:0`` (gloo), each 3
   steps of ``h1d-lm-53m`` at full width and depth at 4 x 1024: every
   rank's losses within 1e-6 relative of the same command line run in
   this process without a mesh, the gathered parameters' digest equal on
   every rank; the whole state after step 3 (the mesh's checkpoint,
   gathered and written by rank 0) against the one-process run's: the
   parameters within 1e-5 absolute, each AdamW moment leaf within 2e-5 of
   its largest |entry| (AdamW's update is nearly blind to a gradient's
   scale, its moments are not: a gradient summed M times shows there);
   #1-#4 launched per rank as often as in one process, no plain version;
   rank 0's collectives a step by axis, calls, MB and ms (timed between
   synchronizations).  With 2 or 4 cards the meshes that
   fit run again, a card a rank (NCCL); with one, a line says that leg
   did not run.  ``launches_by_path`` holds ``tp_train``.

Tolerances.  In bf16 (phases 12-15, 17-19, 21): every step's logits, on the same
tokens, within 3e-2 of the plain row's largest |logit| (both paths
round every activation to bf16 after f32 attention summed in other
orders), losses within 2e-2; the
kernels themselves keep the bounds below on bf16 caches.  Attention
outputs: |kernel - plain| <= 1e-5 * max(1,
|plain|): both are fp32 with TF32 off and differ only in summation order
(~1e-7 relative), but the unnormalised (y, dn) of a coarse level grow
with 2**l because values and key weights are pairwise sums, so the bound
is relative above magnitude 1.  Cache update: bit-exact (the same fp32
adds and exact halvings in the same order); the paged updates on every
pool row but the TRASH page's, which the inactive rows write at once
(the TPU ran those writes in turn, the card races them; no output reads
them), payload and scales, int8 rounding included.  Logits: 1e-3 absolute over
six layers and a 32768-way tied head.  Backward kernels (dq, dk, dv,
dw, gmn): 1e-4 * max(1, |plain|), where |plain| of an entry of dq, dk or
dv is the largest magnitude in its row: dK sums over up to nq * G = 512
query rows at ratio 32, its terms cancel in single columns, and fp32
rounding is bounded by the size of the terms, not by one column's sum
(phase 3 reports both fp32 paths' distance from the float64 answer,
and the elementwise-scaled error, beside it).  Parameter gradients:
each leaf within 1e-4 of that leaf's largest |plain| (no floor of 1:
every gradient entry at init is far below 1), and within 1e-4 * max(1,
|plain|) elementwise.

Output: a ``{"kernels": [...]}`` line, the card's name and power limit
from nvidia-smi, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a result when no card is present or when the
package is missing beside this file.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores; the kernels run fp32 FMA on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

ATTN_TOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-3
# SP prefill caches against the dense prefill's, scaled by each row's
# largest |value|: both are fp32 but sum the attention of the layers
# below in another order (halo merge, gathered deep levels)
CACHE_TOL = 1e-4
BWD_LAUNCH = ("one launch is one wrapper call of two kernels: dQ, then "
              "dK/dV/dW")
SUB_BWD_LAUNCH = "one launch is one wrapper call of one fused kernel"

# serving path of h1d-lm-53m: 8 prompts x 8 kv-heads, head_dim 64, nr 16
B, G, L, D, NR = 64, 1, 1024, 64, 16
R, LMAX = 64, 2048
# LRA path of h1d-lra-encoder: 8 ListOps sequences x 8 heads, L 2048
LRA_L = 2048
NEW_MODES = ("l0_bidir", "coarse_bidir", "coarse_causal")
NUM_CLASSES = 10            # ListOps answers 0..9
LRA_PEAK_LR = 3e-4          # TrainConfig.peak_lr, as phase 6


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bound(nbytes: float, flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def update_bound(rows: int, nlev: int, d: int, table_cols: int = 0,
                 es: int = 4):
    """#6's (and #9's) bound on ``rows`` rows of ``nlev`` levels, k and v
    ``d`` wide: each row reads its new k and v (f32) and its t, writes one
    row of every level and reads the sibling of every level but the last
    (whose carry nothing takes), where the pair's mean and sum are taken,
    ``es`` bytes a cache element (2 for bf16); ``table_cols`` int32
    columns of a page table beside (#9's).  The telemetry's count
    (``repro_torch.obs.traffic.update_traffic``)."""
    from repro_torch.obs import traffic
    read, write, flops = traffic.update_traffic(rows, nlev, d, d, es,
                                                table_cols)
    return bound(read + write, flops)


def all_rows(rec):
    """(bytes, FLOPs) of one launch on every row and key its band admits
    by position, whatever the key weights: the telemetry's count of the
    launch record ``rec`` (``repro_torch.obs.traffic``), the ``all rows``
    bound beside each live-row bound."""
    from repro_torch.obs import traffic
    b = traffic.record_hbm_bytes(rec)
    return b["read_bytes"] + b["write_bytes"], traffic.record_flops(rec)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, iters: int = 10) -> float:
    """Device time of one call: the summed time of the kernels it runs,
    from torch.profiler (the wrapper's host work excluded)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / iters / 1e3


def errors(name: str, got, want, scale=()):
    """Max absolute, max scaled and max elementwise-scaled error of
    ``got`` against ``want``.  Scaled: |got - want| / max(1, |want|) with
    |want| elementwise, or the largest magnitude of the row (last axis)
    where ``scale`` says "row", or |got - want| / max |want| over the
    whole tensor, with no floor of 1, where it says "tensor".  The third
    number always scales elementwise (it shows what the others are
    for)."""
    worst_abs = worst_scaled = worst_elem = 0.0
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.shape == y.shape, (name, x.shape, y.shape)
        assert torch.isfinite(x).all(), f"{name}: non-finite output"
        diff = (x.double() - y.double()).abs()
        mag = y.double().abs()
        elem = float((diff / mag.clamp(min=1.0)).max())
        how = scale[i] if i < len(scale) else "elem"
        if how == "tensor":
            top = float(mag.max())
            assert top > 0, f"{name}: all-zero reference"
            scaled = float(diff.max()) / top
        else:
            if how == "row" and mag.dim() > 1:
                mag = mag.amax(-1, keepdim=True)
            scaled = float((diff / mag.clamp(min=1.0)).max())
        worst_abs = max(worst_abs, float(diff.max()))
        worst_scaled = max(worst_scaled, scaled)
        worst_elem = max(worst_elem, elem)
    return worst_abs, worst_scaled, worst_elem


def compare(name: str, got, want, tol: float, scale=()):
    """:func:`errors`, failing when the scaled error exceeds ``tol``."""
    worst_abs, worst_scaled, worst_elem = errors(name, got, want, scale)
    if worst_scaled > tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: scaled error {worst_scaled:.3g} > "
                             f"{tol:g} (max abs {worst_abs:.3g})")
    return worst_abs, worst_scaled, worst_elem


def band_inputs(dev):
    """Seeded (gen, randn, q, k, v, w) of the band kernels' checks: 64 rows,
    every third right-padded over its last 200 keys, as in prefill."""
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q = randn(B, G, L, D) / math.sqrt(D)
    k = randn(B, L, D)
    w = torch.ones((B, L), device=dev)
    w[::3, L - 200:] = 0.0          # right-padded prompts, as in prefill
    v = randn(B, L, D) * w[..., None]
    return gen, randn, q, k, v, w


def band_pairs(dev, mode, Lk, ratio, wk, Lq=L):
    """(query, key) pairs the band admits on this run's weights."""
    from repro_torch.kernels import h1d_block as hb
    i = torch.arange(Lq, device=dev)[:, None]
    j = torch.arange(Lk, device=dev)[None, :]
    allow = hb.band_mask(i, j, NR, mode, Lk, ratio)
    return int((allow[None] & (wk > 0)[:, None, :]).sum()) * G


def lra_band_inputs(dev):
    """Seeded (randn, q, k, v, w) at the LRA path's shapes: 8 sequences x
    8 heads, L 2048, each sequence right-padded to a true length in
    500..2000 (its 8 heads alike), as ListOps batches are."""
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    lens = torch.randint(500, 2001, (B // 8,), generator=gen, device=dev)
    w = (torch.arange(LRA_L, device=dev)[None]
         < lens.repeat_interleave(8)[:, None]).float()
    q = randn(B, G, LRA_L, D) / math.sqrt(D)
    k = randn(B, LRA_L, D)
    v = randn(B, LRA_L, D) * w[..., None]
    return randn, q, k, v, w


def lra_levels(mode, q, k, v, w):
    """(level, (q, k, v, w)) of every launch of ``mode`` in one encoder
    (or coarse-q) attention: level 0 for l0_bidir; the coarse levels of
    the coarsened chain (queries too, as h1d_attention runs them): 1..6
    at the LRA path's L 2048, 1..7 at the encoder-decoder's 4096."""
    from repro_torch.core import hierarchy as hc
    if mode.startswith("l0"):
        return [(0, (q, k, v, w))]
    out = []
    qc, kc, vc, wc = q, k, v, w
    for lvl in range(1, hc.num_levels(q.shape[-2], NR)):
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        qc, _ = hc.coarsen_weighted_mean(qc, wc)
        vc = hc.coarsen_sum(vc, axis=-2)
        wc = hc.coarsen_sum(wc, axis=-1)
        out.append((lvl, tuple(t.contiguous() for t in (qc, kc, vc, wc))))
    return out


LIVE_NOTE = ("bound_ms counts the rows with a live key and the key blocks "
             "some row reads (band_bytes / sub_bytes), bound_all_rows_ms "
             "every row and key")


def live_bytes(w, mode, backward=False):
    """Bytes one band-mode call must move, live rows only."""
    from repro_torch.kernels import h1d_block as hb
    if mode == "coarse_causal":
        return hb.sub_bytes(w, nr=NR, ratio=1, G=G, d=D, dv=D,
                            backward=backward)
    return hb.band_bytes(w, nr=NR, mode=mode, G=G, d=D, dv=D,
                         backward=backward)


def phase_mode_kernels(dev):
    """#1 in the three modes of the LRA and coarse-q paths against its
    plain version, at the LRA path's shapes: one row per mode, summed
    over its levels."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import h1d_block as hb

    _, q, k, v, w = lra_band_inputs(dev)
    rows = []
    for mode in NEW_MODES:
        tot = dict(err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0, nbytes=0,
                   flops=0, all_bytes=0, all_flops=0, levels=[])
        levels = lra_levels(mode, q, k, v, w)
        for lvl, args in levels:
            ker = hb.band_attention_fwd(*args, nr=NR, mode=mode)
            ref = hb.band_attention_fwd_ref(*args, nr=NR, mode=mode)
            e, *_ = compare(f"band_attention_fwd {mode} level {lvl}", ker,
                            ref, ATTN_TOL)
            tot["err"] = max(tot["err"], e)
            tot["ms"] += time_ms(lambda: hb.band_attention_fwd(
                *args, nr=NR, mode=mode))
            dms = device_ms(lambda: hb.band_attention_fwd(*args, nr=NR,
                                                          mode=mode))
            tot["device_ms"] += dms
            tot["plain_ms"] += time_ms(lambda: hb.band_attention_fwd_ref(
                *args, nr=NR, mode=mode))
            Lq = args[0].shape[-2]
            flops = band_pairs(dev, mode, Lq, 1, args[3], Lq=Lq) * (4 * D + 3)
            nbytes = live_bytes(args[3], mode)
            all_bytes, all_flops = all_rows(contracts.band_fwd(
                *args, nr=NR, mode=mode))
            tot["flops"] += flops
            tot["nbytes"] += nbytes
            tot["all_bytes"] += all_bytes
            tot["all_flops"] += all_flops
            lb = bound(nbytes, flops)[0]
            tot["levels"].append(dict(level=lvl, L=Lq, device_ms=dms,
                                      bound_ms=lb))
            log(f"band_attention_fwd {mode} level {lvl} (L={Lq}): max abs "
                f"err {e:.3g}; device {dms:.4f} ms, bound {lb:.5f} ms "
                f"(live rows; every row "
                f"{bound(all_bytes, all_flops)[0]:.5f})")
        bms, by = bound(tot["nbytes"], tot["flops"])
        span = ("level 0" if len(levels) == 1 else
                f"the {len(levels)} coarse levels (L={LRA_L >> 1}.."
                f"{LRA_L >> len(levels)})")
        rows.append(dict(
            name=f"band_attention_fwd[{mode}]", mode=mode, route="cuda",
            source="src/repro_torch/kernels/csrc/h1d_block.cu",
            replaces="src/repro/kernels/h1d_block.py:299",
            max_abs_err=tot["err"], ms=tot["ms"],
            device_ms=tot["device_ms"], plain_ms=tot["plain_ms"],
            bound_ms=bms, bound_by=by, library_ms=None,
            bound_all_rows_ms=bound(tot["all_bytes"], tot["all_flops"])[0],
            levels=tot["levels"],
            note=f"sum over {span} of one L={LRA_L} attention, 64 rows "
                 f"padded to true lengths 500..2000; {LIVE_NOTE}"))
    return rows


def phase_kernels(dev):
    from repro_torch.analysis import contracts
    from repro_torch.core import hierarchy as hc
    from repro_torch.core import h1d_decode as hd
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_decode_kernel as dk

    gen, randn, q, k, v, w = band_inputs(dev)
    f4 = 4

    rows = []

    # -- level 0 --------------------------------------------------------
    def pairs(mode, Lk, ratio, wk):
        return band_pairs(dev, mode, Lk, ratio, wk)

    ker = hb.band_attention_fwd(q, k, v, w, nr=NR, mode="l0_causal")
    ref = hb.band_attention_fwd_ref(q, k, v, w, nr=NR, mode="l0_causal")
    err, *_ = compare("band_attention_fwd", ker, ref, ATTN_TOL)
    flops = pairs("l0_causal", L, 1, w) * (4 * D + 3)
    bms, by = bound(live_bytes(w, "l0_causal"), flops)
    rows.append(dict(
        name="band_attention_fwd[l0_causal]", mode="l0_causal",
        route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_block.cu",
        replaces="src/repro/kernels/h1d_block.py:299",
        max_abs_err=err,
        ms=time_ms(lambda: hb.band_attention_fwd(q, k, v, w, nr=NR)),
        device_ms=device_ms(lambda: hb.band_attention_fwd(q, k, v, w,
                                                          nr=NR)),
        plain_ms=time_ms(lambda: hb.band_attention_fwd_ref(q, k, v, w,
                                                           nr=NR)),
        bound_ms=bms, bound_by=by, library_ms=None,
        bound_all_rows_ms=bound(*all_rows(contracts.band_fwd(
            q, k, v, w, nr=NR, mode="l0_causal")))[0], note=LIVE_NOTE))
    log(f"band_attention_fwd: max abs err {err:.3g}")

    # -- sub levels 1..M-1 on the coarsened chain, as h1d_attention runs
    M = hc.num_levels(L, NR)
    kc, vc, wc = k, v, w
    sub = dict(err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0, nbytes=0,
               flops=0, levels=[])
    for lvl in range(1, M):
        ratio = 1 << lvl
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc, axis=-2)
        wc = hc.coarsen_sum(wc, axis=-1)
        args = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        ker = hb.band_attention_sub_fwd(*args, nr=NR, ratio=ratio)
        ref = hb.band_attention_sub_fwd_ref(*args, nr=NR, ratio=ratio)
        e, *_ = compare(f"band_attention_sub_fwd ratio={ratio}", ker, ref,
                        ATTN_TOL)
        sub["err"] = max(sub["err"], e)
        sub["ms"] += time_ms(lambda: hb.band_attention_sub_fwd(
            *args, nr=NR, ratio=ratio))
        dms = device_ms(lambda: hb.band_attention_sub_fwd(*args, nr=NR,
                                                          ratio=ratio))
        sub["device_ms"] += dms
        sub["plain_ms"] += time_ms(lambda: hb.band_attention_sub_fwd_ref(
            *args, nr=NR, ratio=ratio))
        flops = pairs("sub", L // ratio, ratio, wc) * (4 * D + 3)
        # the rows with a live key and the key blocks some row reads
        nbytes = hb.sub_bytes(args[3], nr=NR, ratio=ratio, G=G, d=D, dv=D)
        sub["flops"] += flops
        sub["nbytes"] += nbytes
        lb = bound(nbytes, flops)[0]
        sub["levels"].append(dict(ratio=ratio, device_ms=dms, bound_ms=lb))
        log(f"band_attention_sub_fwd ratio {ratio}: max abs err {e:.3g}; "
            f"device {dms:.4f} ms, bound {lb:.5f} ms")
    bms, by = bound(sub["nbytes"], sub["flops"])
    rows.append(dict(
        name="band_attention_sub_fwd", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_block.cu",
        replaces="src/repro/kernels/h1d_block.py:245",
        max_abs_err=sub["err"], ms=sub["ms"], device_ms=sub["device_ms"],
        plain_ms=sub["plain_ms"],
        bound_ms=bms, bound_by=by, library_ms=None, levels=sub["levels"],
        note=f"sum over the {M - 1} sub levels (ratio 2..{1 << (M - 1)}) "
             f"of one L={L} prefill; bytes of the rows with a live key "
             f"and the key blocks some row reads"))

    # -- decode attend and update on a filled cache ----------------------
    cache = hd.prefill_cache(randn(R, LMAX, D), randn(R, LMAX, D), LMAX, NR)
    qd = randn(R, G, D)
    t = torch.randint(0, LMAX, (R,), generator=gen, device=dev,
                      dtype=torch.int32)
    t[:4] = torch.tensor([0, NR - 1, NR, LMAX - 1], dtype=torch.int32)
    ker = dk.decode_attend_fused(cache, qd, t, nr=NR)
    ref = dk.decode_attend_ref(cache, qd, t, nr=NR)
    err, *_ = compare("decode_attend_fused", [ker], [ref], ATTN_TOL)
    Md = hc.num_levels(LMAX, NR)
    small = f4 * (qd.numel() + R + R * G * D)
    # the keys the band masks let through, each key and value row read
    # once, as #7's bound counts them; every band's rows beside it
    keys = partial_keys(t, None, Md)
    bms, by = bound(keys * 2 * D * f4 + small, keys * G * (4 * D + 4))
    rows.append(dict(
        bound_all_rows_ms=bound(*all_rows(contracts.decode_attend(
            cache, qd, t, nr=NR)))[0],
        live_keys=keys, name="decode_attend_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_decode.cu",
        replaces="src/repro/kernels/h1d_decode_kernel.py:154",
        max_abs_err=err,
        ms=time_ms(lambda: dk.decode_attend_fused(cache, qd, t, nr=NR)),
        device_ms=device_ms(lambda: dk.decode_attend_fused(cache, qd, t,
                                                           nr=NR)),
        plain_ms=time_ms(lambda: dk.decode_attend_ref(cache, qd, t, nr=NR)),
        bound_ms=bms, bound_by=by, library_ms=None))
    log(f"decode_attend_fused: max abs err {err:.3g}")

    kn, vn = randn(R, D), randn(R, D)

    def clone(c):
        return hd.H1DCache(c.k.clone(), c.v.clone(),
                           tuple(a.clone() for a in c.ck),
                           tuple(a.clone() for a in c.cv))
    ck_, cp_ = clone(cache), clone(cache)
    for step in range(3):        # chained writes: later ones read earlier
        tt = (t + step).clamp(max=LMAX - 1)
        dk.update_cache_fused(ck_, kn + step, vn - step, tt)
        dk.update_cache_ref(cp_, kn + step, vn - step, tt)
    for a, b in zip((ck_.k, ck_.v, *ck_.ck, *ck_.cv),
                    (cp_.k, cp_.v, *cp_.ck, *cp_.cv)):
        if not torch.equal(a, b):
            raise AssertionError("update_cache_fused is not bit-exact "
                                 "against update_cache_ref")
    nlev = 1 + len(cache.ck)
    bms, by = update_bound(R, nlev, D)
    rows.append(dict(
        name="update_cache_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_decode.cu",
        replaces="src/repro/kernels/h1d_decode_kernel.py:362",
        max_abs_err=0.0,
        ms=time_ms(lambda: dk.update_cache_fused(ck_, kn, vn, t)),
        device_ms=device_ms(lambda: dk.update_cache_fused(ck_, kn, vn, t)),
        plain_ms=time_ms(lambda: dk.update_cache_ref(cp_, kn, vn, t)),
        bound_ms=bms, bound_by=by, library_ms=None))
    log("update_cache_fused: bit-exact over 3 chained updates")
    return rows


# paged serving shapes: 8 slots x 8 kv-heads, 1024 + ZERO/TRASH pages
SLOTS, HKV, PAGES, TRASH = 8, 8, 1024, 1


def paged_pools(dev, gen, M):
    """Seeded pools at every level: fp32, int8 at every level, and mixed
    (levels 0-2 int8); the int8 levels hold the fp32 pool quantized per
    row, as prefill writes them."""
    from repro_torch.core import h1d_decode as hd
    from repro_torch.core import quantization as qz
    rows = (PAGES + 2) * HKV
    k = [torch.randn((rows, NR, D), generator=gen, device=dev)
         for _ in range(M)]
    v = [torch.randn((rows, NR, D), generator=gen, device=dev) * 2 ** l
         for l in range(M)]
    fp32 = hd.PagedH1DCache(k[0], v[0], tuple(k[1:]), tuple(v[1:]))

    def quant(nq):
        ks, vs, kscs, vscs = [], [], [], []
        for l in range(M):
            if l < nq:
                qk, sk = qz.quantize_int8(k[l], axis=-1)
                qv, sv = qz.quantize_int8(v[l], axis=-1)
                ks.append(qk)
                vs.append(qv)
                kscs.append(sk[..., 0].contiguous())
                vscs.append(sv[..., 0].contiguous())
            else:
                ks.append(k[l].clone())
                vs.append(v[l].clone())
                kscs.append(torch.ones((rows, NR), device=dev))
                vscs.append(torch.ones((rows, NR), device=dev))
        return hd.QuantPagedH1DCache(ks[0], vs[0], tuple(ks[1:]),
                                     tuple(vs[1:]), kscs[0], vscs[0],
                                     tuple(kscs[1:]), tuple(vscs[1:]))

    return fp32, quant(M), quant(3)


def paged_tables(dev, M, step=0):
    """Tables of one tick as ``PagePool.build_tables`` lays them out:
    slots 0-5 active at seeded positions (edge cases first) plus
    ``step``, with seeded read pages and private write pages; slots 6
    and 7 inactive, every band and every write on the TRASH page."""
    rng = np.random.default_rng(100)
    t = np.zeros((SLOTS,), np.int64)
    t[:6] = [0, NR - 1, LMAX - 1, *rng.integers(NR, LMAX - 1, 3)]
    t[:6] = np.minimum(t[:6] + step, LMAX - 1)
    attend = np.full((SLOTS, 1 + M), TRASH, np.int64)
    update = np.full((SLOTS, M), TRASH, np.int64)
    upages = np.stack([rng.permutation(PAGES)[:6] + 2 for _ in range(M)], 1)
    for s in range(6):
        attend[s] = rng.integers(2, PAGES + 2, 1 + M)
        if t[s] // NR < 1:
            attend[s, 1] = TRASH
        for l in range(1, M):
            if t[s] // (NR << l) < 1:
                attend[s, 1 + l] = TRASH
        update[s] = upages[s]
    heads = np.arange(HKV)[None, :, None]

    def physical(pages):
        rows = pages[:, None, :] * HKV + heads       # (slots, heads, cols)
        return torch.as_tensor(rows.reshape(SLOTS * HKV, -1),
                               dtype=torch.int32, device=dev).contiguous()
    tt = torch.as_tensor(np.repeat(t, HKV), dtype=torch.int32, device=dev)
    return tt, physical(attend), physical(update)


def pool_clone(p):
    return type(p)(*[tuple(a.clone() for a in x) if isinstance(x, tuple)
                     else x.clone() for x in p])


def pool_arrays(p):
    return [a for x in p for a in (x if isinstance(x, tuple) else (x,))]


def same_outside_trash(a, b):
    """Every pool row but the TRASH page's (which the inactive rows
    write at once) equal bit for bit."""
    rows = slice(TRASH * HKV, (TRASH + 1) * HKV)
    for x, y in zip(pool_arrays(a), pool_arrays(b)):
        keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        keep[rows] = False
        if not torch.equal(x[keep], y[keep]):
            return False
    return True


def phase_paged_kernels(dev):
    """#7-#10 against their plain versions at paged serving shapes."""
    from repro_torch.analysis import contracts
    from repro_torch.core import hierarchy as hc
    from repro_torch.kernels import h1d_decode_kernel as dk

    gen = torch.Generator(device=dev).manual_seed(3)
    M = hc.num_levels(LMAX, NR)
    fp32, int8, mixed = paged_pools(dev, gen, M)
    t, bidx, utab = paged_tables(dev, M)
    qd = torch.randn((R, G, D), generator=gen, device=dev)
    small = 4 * (qd.numel() + R + bidx.numel() + R * G * D)
    rows = []
    for name, kernel, plain, pools in (
            ("decode_attend_paged", dk.decode_attend_paged,
             dk.decode_attend_paged_ref, [("fp32", fp32)]),
            ("decode_attend_paged_quant", dk.decode_attend_paged_quant,
             dk.decode_attend_paged_quant_ref,
             [("int8", int8), ("mixed", mixed)])):
        err = 0.0
        for label, pool in pools:
            got = kernel(pool, qd, t, bidx, nr=NR)
            want = plain(pool, qd, t, bidx, nr=NR)
            e, *_ = compare(f"{name} ({label})", [got], [want], ATTN_TOL)
            err = max(err, e)
        label, pool = pools[0]
        # the keys the band masks let through, each key and value row read
        # once (int8: its D bytes and 4-byte scale); every band's rows
        # beside it
        keys = partial_keys(t, None, M)
        extra = dict(bound_all_rows_ms=bound(*all_rows(getattr(
            contracts, name)(pool, qd, t, bidx, nr=NR)))[0], live_keys=keys)
        live_row = 8 * D if label == "fp32" else 2 * D + 8
        bms, by = bound(keys * live_row + small, keys * G * (4 * D + 4))
        rows.append(dict(
            **extra, name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/h1d_decode.cu",
            replaces={"decode_attend_paged":
                      "src/repro/kernels/h1d_decode_kernel.py:426",
                      "decode_attend_paged_quant":
                      "src/repro/kernels/h1d_decode_kernel.py:482"}[name],
            max_abs_err=err,
            ms=time_ms(lambda: kernel(pool, qd, t, bidx, nr=NR)),
            device_ms=device_ms(lambda: kernel(pool, qd, t, bidx, nr=NR)),
            plain_ms=time_ms(lambda: plain(pool, qd, t, bidx, nr=NR)),
            bound_ms=bms, bound_by=by, library_ms=None,
            note=f"timed on the {label} pool; checked on "
                 f"{[p for p, _ in pools]}"))
        log(f"{name}: max abs err {err:.3g} ({[p for p, _ in pools]})")

    kn = torch.randn((R, D), generator=gen, device=dev)
    vn = torch.randn((R, D), generator=gen, device=dev)
    for name, kernel, plain, pools in (
            ("update_cache_paged", dk.update_cache_paged,
             dk.update_cache_paged_ref, [("fp32", fp32)]),
            ("update_cache_paged_quant", dk.update_cache_paged_quant,
             dk.update_cache_paged_quant_ref,
             [("int8", int8), ("mixed", mixed)])):
        for label, pool in pools:
            a, b = pool_clone(pool), pool_clone(pool)
            for step in range(3):    # chained: later writes read earlier
                ts, _, ut = paged_tables(dev, M, step)
                kernel(a, kn + step, vn - step, ts, ut)
                plain(b, kn + step, vn - step, ts, ut)
            if not same_outside_trash(a, b):
                raise AssertionError(f"{name} ({label}) is not bit-exact "
                                     f"against its plain version outside "
                                     f"the TRASH page")
            del a, b
        label, pool = pools[0]
        if name == "update_cache_paged":
            bms, by = update_bound(R, M, D, table_cols=utab.shape[1])
        else:
            # pair (and its two scales) read and rewritten, per level
            per_row = M * 2 * (2 * 2 * D + 2 * 2 * 4)
            bms, by = bound(4 * (2 * R * D + R + utab.numel())
                            + R * per_row, R * M * 2 * D * 8)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/h1d_decode.cu",
            replaces={"update_cache_paged":
                      "src/repro/kernels/h1d_decode_kernel.py:567",
                      "update_cache_paged_quant":
                      "src/repro/kernels/h1d_decode_kernel.py:678"}[name],
            max_abs_err=0.0,
            ms=time_ms(lambda: kernel(pool, kn, vn, t, utab)),
            device_ms=device_ms(lambda: kernel(pool, kn, vn, t, utab)),
            plain_ms=time_ms(lambda: plain(pool, kn, vn, t, utab)),
            bound_ms=bms, bound_by=by, library_ms=None,
            note=f"timed on the {label} pool; bit-exact outside TRASH "
                 f"over 3 chained ticks on {[p for p, _ in pools]}"))
        log(f"{name}: bit-exact outside TRASH over 3 chained ticks "
            f"({[p for p, _ in pools]})")
    return rows


def exact_grads(fwd, cot, mode, ratio):
    """Float64 (dq, dk, dv, dw) of one band level, by autograd of a dense
    masked forward on the same inputs and cotangents: a witness, written
    apart from both fp32 paths, of the answer they round (``amax``'s
    backward splits a tie's cotangent evenly, as the kernels' 1/c does).
    Also returns the rows whose two largest admitted scores lie within
    1e-6 of each other, where fp32 may pick another maximum."""
    from repro_torch.kernels import h1d_block as hb
    x = [t.double().requires_grad_(True) for t in fwd]
    q, k, v, w = x
    Lq, Lk = q.shape[-2], k.shape[-2]
    i = torch.arange(Lq, device=q.device)[:, None]
    j = torch.arange(Lk, device=q.device)[None, :]
    allow = (hb.band_mask(i, j, NR, mode, Lk, ratio)[None, None]
             & (w > 0)[:, None, None, :])
    s = torch.where(allow, torch.einsum("bgid,bjd->bgij", q, k), hb.NEG_INF)
    m = torch.clamp(s.amax(-1), min=hb._MIN_M)
    a = torch.exp(s - m[..., None])
    y = torch.einsum("bgij,bjv->bgiv", a, v)
    dn = torch.einsum("bgij,bj->bgi", a, w)
    grads = torch.autograd.grad((y, dn, m), x, [c.double() for c in cot])
    top = s.detach().topk(min(2, Lk), dim=-1).values
    near = int(((top[..., 1] > hb._MIN_M)
                & (top[..., 0] - top[..., 1] < 1e-6)).sum()) if Lk > 1 else 0
    return grads, near


def phase_bwd_kernels(dev):
    """The two backward kernels against their plain versions at the
    training path's shapes: level 0 and every sub level of L=1024, from
    the forward kernels' saved outputs and seeded random cotangents.
    Both fp32 paths are also held against :func:`exact_grads`, reported
    beside them (the grounds of the row-scaled bound)."""
    from repro_torch.analysis import contracts
    from repro_torch.core import hierarchy as hc
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_block_bwd as hbb

    _, randn, q, k, v, w = band_inputs(dev)
    # dq, dk, dv are stacks of vectors; dw and gmn scalars per row
    rows3 = ("row", "row", "row")

    def one(forward, kernel, plain, fwd, label, mask_mode, randn=randn,
            **kw):
        out = forward(*fwd, **kw)
        cot = tuple(randn(*t.shape) for t in out)
        args = (*fwd, *out, *cot)
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        err, scaled, elem = compare(label, got, want, GRAD_TOL, rows3)
        ratio = kw.get("ratio", 1)
        exact, near = exact_grads(fwd, cot, mask_mode, ratio)
        witness = dict(ratio=ratio, near_ties=near)
        for who, res in (("kernel", got), ("plain", want)):
            e = errors(label, res[:4], exact, rows3)
            witness[who] = dict(abs=e[0], row_scaled=e[1], elem_scaled=e[2])
        del exact
        if witness["kernel"]["row_scaled"] > GRAD_TOL:
            raise AssertionError(f"{label}: kernel is {witness['kernel']}"
                                 f" from the float64 gradient ({near} "
                                 f"near-tied rows)")
        log(f"{label} vs float64: kernel abs {witness['kernel']['abs']:.3g}"
            f" row {witness['kernel']['row_scaled']:.3g} elem "
            f"{witness['kernel']['elem_scaled']:.3g}; plain abs "
            f"{witness['plain']['abs']:.3g} row "
            f"{witness['plain']['row_scaled']:.3g} elem "
            f"{witness['plain']['elem_scaled']:.3g}; near ties {near}")
        # the rows with a live key and the key blocks some row reads; all
        # rows beside them
        if mask_mode == "sub":
            nbytes = hb.sub_bytes(fwd[3], nr=NR, ratio=ratio, G=G, d=D,
                                  dv=D, backward=True)
            rec = contracts.sub_bwd(*fwd, nr=NR, ratio=ratio)
        else:
            nbytes = live_bytes(fwd[3], mask_mode, backward=True)
            rec = contracts.band_bwd(*fwd, nr=NR, mode=mask_mode)
        all_bytes, all_flops = all_rows(rec)
        return dict(err=err, scaled=scaled, elem=elem, nbytes=nbytes,
                    all_bytes=all_bytes, all_flops=all_flops,
                    witness=witness,
                    ms=time_ms(lambda: kernel(*args, **kw)),
                    device_ms=device_ms(lambda: kernel(*args, **kw)),
                    plain_ms=time_ms(lambda: plain(*args, **kw)))

    # a (query, key) pair: recompute s (2d) and a, da (2dv + 2), and the
    # dq, dk (2d each), dv (2dv) and dw (2) sums
    per_pair = 6 * D + 4 * D + 5
    rows = []
    r = one(hb.band_attention_fwd, hbb.band_attention_bwd,
            hbb.band_attention_bwd_ref, (q, k, v, w), "band_attention_bwd",
            "l0_causal", nr=NR, mode="l0_causal")
    flops = band_pairs(dev, "l0_causal", L, 1, w) * per_pair
    bms, by = bound(r["nbytes"], flops)
    rows.append(dict(
        name="band_attention_bwd[l0_causal]", mode="l0_causal",
        route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_block_bwd.cu",
        replaces="src/repro/kernels/h1d_block_bwd.py:541",
        max_abs_err=r["err"], max_scaled_err=r["scaled"],
        max_elementwise_scaled_err=r["elem"], f64_witness=[r["witness"]],
        ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
        bound_ms=bms, bound_by=by, library_ms=None,
        bound_all_rows_ms=bound(r["all_bytes"], r["all_flops"])[0],
        note=f"{BWD_LAUNCH}; {LIVE_NOTE}"))
    log(f"band_attention_bwd: max abs err {r['err']:.3g}, scaled "
        f"{r['scaled']:.3g} (elementwise {r['elem']:.3g})")

    M = hc.num_levels(L, NR)
    kc, vc, wc = k, v, w
    tot = dict(err=0.0, scaled=0.0, elem=0.0, ms=0.0, device_ms=0.0,
               plain_ms=0.0, nbytes=0, flops=0, witness=[], levels=[])
    for lvl in range(1, M):
        ratio = 1 << lvl
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc, axis=-2)
        wc = hc.coarsen_sum(wc, axis=-1)
        fwd = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        r = one(hb.band_attention_sub_fwd, hbb.band_attention_sub_bwd,
                hbb.band_attention_sub_bwd_ref, fwd,
                f"band_attention_sub_bwd ratio={ratio}", "sub", nr=NR,
                ratio=ratio)
        for key in ("ms", "device_ms", "plain_ms", "nbytes"):
            tot[key] += r[key]
        tot["err"] = max(tot["err"], r["err"])
        tot["scaled"] = max(tot["scaled"], r["scaled"])
        tot["elem"] = max(tot["elem"], r["elem"])
        tot["witness"].append(r["witness"])
        flops = band_pairs(dev, "sub", L // ratio, ratio, wc) * per_pair
        tot["flops"] += flops
        lb = bound(r["nbytes"], flops)[0]
        tot["levels"].append(dict(ratio=ratio, device_ms=r["device_ms"],
                                  bound_ms=lb))
        log(f"band_attention_sub_bwd ratio {ratio}: max abs err "
            f"{r['err']:.3g}, scaled {r['scaled']:.3g} (elementwise "
            f"{r['elem']:.3g}), {r['ms']:.3f} ms; device "
            f"{r['device_ms']:.4f} ms, bound {lb:.5f} ms")
    bms, by = bound(tot["nbytes"], tot["flops"])
    rows.append(dict(
        name="band_attention_sub_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_block_bwd.cu",
        replaces="src/repro/kernels/h1d_block_bwd.py:399",
        max_abs_err=tot["err"], max_scaled_err=tot["scaled"],
        max_elementwise_scaled_err=tot["elem"], f64_witness=tot["witness"],
        ms=tot["ms"], device_ms=tot["device_ms"], plain_ms=tot["plain_ms"],
        bound_ms=bms, bound_by=by, library_ms=None, levels=tot["levels"],
        note=f"sum over the {M - 1} sub levels (ratio 2..{1 << (M - 1)}) "
             f"of one L={L} training step's attention; {SUB_BWD_LAUNCH}; "
             f"bytes of the rows with a live key and the key blocks some "
             f"row reads"))

    # the three modes of the LRA and coarse-q paths, at the LRA shapes
    lra_randn, q, k, v, w = lra_band_inputs(dev)
    for mode in NEW_MODES:
        tot = dict(err=0.0, scaled=0.0, elem=0.0, ms=0.0, device_ms=0.0,
                   plain_ms=0.0, nbytes=0, flops=0, witness=[], all_bytes=0,
                   all_flops=0, levels=[])
        levels = lra_levels(mode, q, k, v, w)
        for lvl, fwd in levels:
            Lq = fwd[0].shape[-2]
            r = one(hb.band_attention_fwd, hbb.band_attention_bwd,
                    hbb.band_attention_bwd_ref, fwd,
                    f"band_attention_bwd {mode} level {lvl}", mode,
                    randn=lra_randn, nr=NR, mode=mode)
            for key in ("ms", "device_ms", "plain_ms", "nbytes",
                        "all_bytes", "all_flops"):
                tot[key] += r[key]
            for key in ("err", "scaled", "elem"):
                tot[key] = max(tot[key], r[key])
            tot["witness"].append(dict(r["witness"], level=lvl))
            flops = band_pairs(dev, mode, Lq, 1, fwd[3], Lq=Lq) * per_pair
            tot["flops"] += flops
            lb = bound(r["nbytes"], flops)[0]
            tot["levels"].append(dict(level=lvl, L=Lq,
                                      device_ms=r["device_ms"], bound_ms=lb))
            log(f"band_attention_bwd {mode} level {lvl} (L={Lq}): max abs "
                f"err {r['err']:.3g}, scaled {r['scaled']:.3g} "
                f"(elementwise {r['elem']:.3g}), {r['ms']:.3f} ms; device "
                f"{r['device_ms']:.4f} ms, bound {lb:.5f} ms (live rows; "
                f"every row "
                f"{bound(r['all_bytes'], r['all_flops'])[0]:.5f})")
        bms, by = bound(tot["nbytes"], tot["flops"])
        span = ("level 0" if len(levels) == 1 else
                f"the {len(levels)} coarse levels (L={LRA_L >> 1}.."
                f"{LRA_L >> len(levels)})")
        rows.append(dict(
            name=f"band_attention_bwd[{mode}]", mode=mode, route="cuda",
            source="src/repro_torch/kernels/csrc/h1d_block_bwd.cu",
            replaces="src/repro/kernels/h1d_block_bwd.py:541",
            max_abs_err=tot["err"], max_scaled_err=tot["scaled"],
            max_elementwise_scaled_err=tot["elem"],
            f64_witness=tot["witness"], ms=tot["ms"],
            device_ms=tot["device_ms"], plain_ms=tot["plain_ms"],
            bound_ms=bms, bound_by=by, library_ms=None,
            bound_all_rows_ms=bound(tot["all_bytes"], tot["all_flops"])[0],
            levels=tot["levels"],
            note=f"sum over {span} of one L={LRA_L} attention, 64 rows "
                 f"padded to true lengths 500..2000; "
                 + (SUB_BWD_LAUNCH if mode == "coarse_causal"
                    else BWD_LAUNCH) + f"; {LIVE_NOTE}"))
    return rows


def path_counts():
    """Launches since the last ``reset_counts``, keyed as the kernel
    rows are: by wrapper, and for #1 and #3 also by ``name[mode]``; a
    decode kernel's launches on bf16 caches under ``name[bf16]``, the
    rest (f32) under ``name``."""
    from repro_torch import kernels
    out = {n: k.launches for n, (k, _) in kernels.KERNELS.items()}
    for (n, mode), c in kernels.mode_launches().items():
        out[f"{n}[{mode}]"] = c
        if mode == "bf16":      # the row named n is the f32 instantiation
            out[n] -= c
    return out


@contextlib.contextmanager
def plain_kernels():
    """Route the twelve kernel call sites to their plain versions (the
    comparison path of phases 5 and 7; the port itself has no such
    switch)."""
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_block_bwd as hbb
    from repro_torch.kernels import h1d_decode_kernel as dk
    swaps = [(hb, "band_attention_fwd", hb.band_attention_fwd_ref),
             (hb, "band_attention_sub_fwd", hb.band_attention_sub_fwd_ref),
             (hbb, "band_attention_bwd", hbb.band_attention_bwd_ref),
             (hbb, "band_attention_sub_bwd", hbb.band_attention_sub_bwd_ref),
             (dk, "decode_attend_fused", dk.decode_attend_ref),
             (dk, "update_cache_fused", dk.update_cache_ref),
             (dk, "decode_attend_paged", dk.decode_attend_paged_ref),
             (dk, "decode_attend_paged_quant",
              dk.decode_attend_paged_quant_ref),
             (dk, "update_cache_paged", dk.update_cache_paged_ref),
             (dk, "update_cache_paged_quant",
              dk.update_cache_paged_quant_ref),
             (dk, "decode_attend_partial", dk.decode_attend_partial_ref),
             (dk, "update_cache_partial", dk.update_cache_partial_ref)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def phase_serve(dev):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config("h1d-lm-53m")
    fns = get_model(cfg)
    params = fns.init(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 1501, size=16)]

    # warm-up (cuBLAS handles, allocator) on a short request, not counted
    warm = ServeEngine(cfg, params, slots=8, max_len=2048)
    warm.submit(Request(uid=-1, prompt=prompts[0][:64], max_new_tokens=2))
    warm.run()
    del warm

    eng = ServeEngine(cfg, params, slots=8, max_len=2048)
    ticks = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ticks[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    eng.fns = eng.fns._replace(prefill=timed("prefill", eng.fns.prefill),
                               decode_step=timed("decode",
                                                 eng.fns.decode_step))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)

    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts()
    plain = {n: p.calls for n, (_, p) in kernels.KERNELS.items()}

    missing = [n for n in kernels.SERVE_KERNELS if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: "
                             f"{missing}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the serving path: "
                             f"{plain}")
    for r in reqs:
        if len(r.out_tokens) != 32 or not all(
                0 <= x < cfg.vocab_size for x in r.out_tokens):
            raise AssertionError(f"request {r.uid}: bad output "
                                 f"{r.out_tokens}")
    ntok = sum(len(r.out_tokens) for r in reqs)
    stats = dict(
        requests=len(reqs), tokens=ntok, wall_s=wall,
        tokens_per_s=ntok / wall,
        prompt_tokens=int(sum(len(p) for p in prompts)),
        prefill_calls=len(ticks["prefill"]),
        prefill_ms_per_call=float(np.mean(ticks["prefill"])),
        decode_ticks=len(ticks["decode"]),
        decode_ms_per_tick=float(np.median(ticks["decode"])),
        launches=counts)
    log(f"serve: {json.dumps(stats)}")
    return cfg, params, fns, reqs, counts, stats


def phase_logits(cfg, params, fns, reqs, dev):
    """Teacher-forced logits, kernel path vs plain path, for 2 requests."""
    worst = 0.0
    for r in reqs[:2]:
        seq = np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1],
                                                   np.int32)])
        tok = torch.as_tensor(seq[None], dtype=torch.long, device=dev)
        S = len(r.prompt)

        def run():
            with torch.inference_mode():
                full, _ = fns.forward(params, cfg, tok)
                lg, caches, pos = fns.prefill(params, cfg,
                                              {"tokens": tok[:, :S]}, 2048)
                steps = [lg]
                for i in range(S, tok.shape[1]):
                    lg, caches = fns.decode_step(params, cfg, caches,
                                                 tok[:, i], pos)
                    pos = pos + 1
                    steps.append(lg)
                return full[0, S - 1:], torch.cat(steps)
        full_k, dec_k = run()
        with plain_kernels():
            full_p, dec_p = run()
        for name, a, b in (("forward", full_k, full_p),
                           ("prefill+decode", dec_k, dec_p),
                           ("decode vs forward", dec_k, full_k)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"request {r.uid} {name}: non-finite")
            e = float((a - b).abs().max())
            worst = max(worst, e)
            if e > LOGIT_TOL:
                raise AssertionError(f"request {r.uid} {name}: logits "
                                     f"differ by {e:.3g} > {LOGIT_TOL}")
        # the engine's greedy tokens must be the replay's argmax, up to
        # near-ties inside the logit tolerance (the engine ran batched
        # and bucket-padded shapes, the replay one unpadded row)
        for i, tk in enumerate(r.out_tokens):
            gap = float(dec_k[i].max() - dec_k[i, tk])
            if gap > LOGIT_TOL:
                raise AssertionError(f"request {r.uid} step {i}: engine "
                                     f"token {tk} trails the replay's "
                                     f"argmax by {gap:.3g}")
    log(f"logits: kernel vs plain path max abs diff {worst:.3g} "
        f"(<= {LOGIT_TOL})")


def paged_prefix_workload(vocab: int):
    """``paged-prefix``: 16 prompts, each one shared seeded 1000-token
    prefix (not page-aligned) plus a unique tail of 16..500 tokens (seed
    1); prompts 14 and 15 repeat 0 and 1.  Returned in submission order,
    the repeats right behind their originals so that both are admitted
    in one tick and share their frontier pages until the first write.
    Entries are (uid, prompt)."""
    prefix = np.random.default_rng(0).integers(0, vocab, 1000)
    rng = np.random.default_rng(1)
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, int(n))])
               .astype(np.int32) for n in rng.integers(16, 501, 14)]
    prompts += [prompts[0], prompts[1]]
    order = [0, 14, 1, 15] + list(range(2, 14))
    return [(i, prompts[i]) for i in order]


PAGED_NEW = 32
SMALL_POOL = 160


def run_engine(eng, workload, fns, new_tokens=PAGED_NEW):
    """Serve ``workload`` to the end, ``new_tokens`` a request; returns
    (outputs by uid, stats).  Prefill and decode calls are timed with a
    synchronize on each side; the kernel counts are set to 0 just before
    the run."""
    from repro_torch import kernels
    from repro_torch.serve import Request

    ticks = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            ticks[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    eng.fns = fns._replace(prefill=timed("prefill", fns.prefill),
                           decode_step=timed("decode", fns.decode_step))
    reqs = {uid: Request(uid=uid, prompt=p, max_new_tokens=new_tokens)
            for uid, p in workload}
    for uid, _ in workload:
        eng.submit(reqs[uid])
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    peak = 0
    while eng.queue or eng.active.any():
        eng.step()
        peak = max(peak, int(eng.active.sum()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts()
    plain = {n: p.calls for n, (_, p) in kernels.KERNELS.items()}
    if any(plain.values()):
        raise AssertionError(f"plain versions ran while serving: {plain}")
    outs = {uid: list(r.out_tokens) for uid, r in reqs.items()}
    for uid, out in outs.items():
        if len(out) != new_tokens:
            raise AssertionError(f"request {uid}: {len(out)} tokens")
    ntok = sum(len(o) for o in outs.values())
    stats = dict(tokens=ntok, wall_s=wall, tokens_per_s=ntok / wall,
                 peak_concurrency=peak, prefill_calls=len(ticks["prefill"]),
                 prefill_ms_per_call=float(np.mean(ticks["prefill"])),
                 decode_ticks=len(ticks["decode"]),
                 decode_ms_per_tick=float(np.median(ticks["decode"])),
                 launches={n: c for n, c in counts.items() if c})
    if eng.paged:
        st = eng.pool.stats
        stats.update(pool_pages=eng.pool.usable(0),
                     shared=st.shared_maps, prefix_hits=st.prefix_hits,
                     prefix_misses=st.prefix_misses, cow=st.cow_copies,
                     evictions=st.evictions, preemptions=eng.preemptions,
                     occupancy_end=eng.pool.occupancy())
    return outs, stats, counts


def phase_paged_serve(cfg, params, fns, dev):
    """Workload ``paged-prefix`` through the dense oracle and three paged
    engines; returns the launches of the paged engines summed."""
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import paged_cache as pc

    workload = paged_prefix_workload(cfg.vocab_size)
    kw = dict(slots=8, max_len=LMAX)

    def bytes_of(pages, quant_levels=0):
        pool = pc.PagePool(slots=8, max_len=LMAX, nr=cfg.nr,
                           pool_pages=pages, quant_levels=quant_levels)
        return pc.pool_bytes(pc.init_paged_caches(cfg, pool, device="meta"))

    budget = bytes_of(SMALL_POOL)
    int8_pages = SMALL_POOL          # as bench_serve.py's _fit_pages
    while bytes_of(int8_pages + 1, -1) <= budget:
        int8_pages += 1
    engines = {
        "a_dense": dict(),
        "b_paged_fp32": dict(paged=True, pool_pages=PAGES),
        "c_paged_fp32_small": dict(paged=True, pool_pages=SMALL_POOL),
        "d_paged_int8": dict(paged=True, pool_pages=int8_pages,
                             cache_dtype="int8", quant_levels=-1)}
    outs, stats, total = {}, {}, {}
    for name, extra in engines.items():
        eng = ServeEngine(cfg, params, **kw, **extra)
        outs[name], stats[name], counts = run_engine(eng, workload, fns)
        if eng.paged:
            stats[name]["pool_bytes"] = pc.pool_bytes(eng.caches)
            for n, c in counts.items():
                total[n] = total.get(n, 0) + c
        del eng
        torch.cuda.empty_cache()
        log(f"paged-prefix {name}: {json.dumps(stats[name])}")

    def launched(name, kernels_):
        return all(stats[name]["launches"].get(k, 0) > 0 for k in kernels_)
    fp32_k = ("decode_attend_paged", "update_cache_paged")
    int8_k = ("decode_attend_paged_quant", "update_cache_paged_quant")
    for name, need in (("b_paged_fp32", fp32_k),
                       ("c_paged_fp32_small", fp32_k),
                       ("d_paged_int8", int8_k)):
        if not launched(name, need):
            raise AssertionError(f"{name}: {need} not launched: "
                                 f"{stats[name]['launches']}")
    c = stats["c_paged_fp32_small"]
    if not (c["preemptions"] > 0 and c["cow"] > 0 and c["prefix_hits"] > 0
            and c["occupancy_end"] == 0.0):
        raise AssertionError(f"(c) with {SMALL_POOL} pages did not preempt, "
                             f"copy on write and share: {c}")
    if stats["d_paged_int8"]["pool_bytes"] > budget:
        raise AssertionError("(d) exceeds (c)'s bytes")

    # greedy equality, guarded by the teacher-forced top-2 margins
    prompts = dict(workload)
    guarded = []
    with torch.inference_mode():
        for uid, out in sorted(outs["a_dense"].items()):
            seq = np.concatenate([prompts[uid], np.asarray(out[:-1],
                                                           np.int32)])
            lg, _ = fns.forward(params, cfg, torch.as_tensor(
                seq[None], dtype=torch.long, device=dev))
            top2 = lg[0, len(prompts[uid]) - 1:].topk(2, dim=-1).values
            if float((top2[:, 0] - top2[:, 1]).min()) > LOGIT_TOL:
                guarded.append(uid)
    for name in ("b_paged_fp32", "c_paged_fp32_small"):
        bad = [u for u in guarded if outs[name][u] != outs["a_dense"][u]]
        if bad:
            raise AssertionError(f"{name}: requests {bad} differ from the "
                                 f"dense engine")
    ref = outs["a_dense"]
    hit = sum(x == y for u in ref for x, y in zip(outs["d_paged_int8"][u],
                                                  ref[u]))
    rate = hit / sum(len(o) for o in ref.values())
    log(f"paged-prefix: pools {SMALL_POOL} fp32 pages (c) and {int8_pages} "
        f"int8 pages (d) in {budget} B; {len(guarded)}/{len(ref)} requests "
        f"guarded (top-2 margins > {LOGIT_TOL}), (b) and (c) equal to (a) "
        f"on all of them; (d) token-match rate vs (a) {rate:.4f}")
    return total


def sp_positions(dev, gen, d):
    """R seeded positions in [0, LMAX], the first ones at the mask and
    shard edges: 0, 15, 16, 2047, the out-of-range 2048 (owned by the
    last shard) and s*Lloc - 1, s*Lloc at every shard edge."""
    t = torch.randint(0, LMAX + 1, (R,), generator=gen, device=dev,
                      dtype=torch.int32)
    edges = [0, NR - 1, NR, LMAX - 1, LMAX]
    for s in range(1, d):
        edges += [s * LMAX // d - 1, s * LMAX // d]
    t[:len(edges)] = torch.tensor(edges, dtype=torch.int32)
    return t


def partial_keys(t, owned, nlev):
    """Key rows that #11 needs on one shard for rows at positions ``t``
    with band ownership bits ``owned``: those the decode band masks let
    through (``_attend_bands``' rules) in a band the shard owns (every
    band where ``owned`` is None: what #7 needs)."""
    t = t.long()[:, None]
    j = torch.arange(NR, device=t.device)[None]
    need = []
    for band in range(nlev + 1):
        if band == 0:
            m = (t // NR) * NR + j <= t
        elif band == 1:
            m = (t // NR >= 1).expand(-1, NR)
        else:
            span = NR << (band - 1)
            m = (t // span >= 1) & ~((t % span < span // 2) & (j >= NR // 2))
        need.append(m if owned is None else m & (owned[:, band:band + 1]
                                                  > 0))
    return int(torch.cat(need, 1).sum())


def phase_sp_kernels(dev):
    """#11 and #12 against their plain versions on every shard at d=2 and
    d=4; #11 merged against #5 and the whole SP update against #6 on the
    unsharded cache.  Rows timed as one shard's call at d=4."""
    from repro_torch.core import h1d_decode as hd
    from repro_torch.core import hierarchy as hc
    from repro_torch.kernels import h1d_decode_kernel as dk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def clone(c, nlev=None):
        nc = len(c.ck) if nlev is None else nlev - 1
        return hd.H1DCache(c.k.clone(), c.v.clone(),
                           tuple(a.clone() for a in c.ck[:nc]),
                           tuple(a.clone() for a in c.cv[:nc]))

    dense = hd.prefill_cache(randn(R, LMAX, D), randn(R, LMAX, D), LMAX, NR)
    qd = randn(R, G, D)
    kn, vn = randn(R, D), randn(R, D)
    nlev = hc.num_levels(LMAX, NR)
    err = {"attend": 0.0, "merged": 0.0}
    for d in (2, 4):
        mesh = make_mesh((d,), ("data",), device=dev)
        sc = sp.shard_cache(dense, mesh, NR)
        t = sp_positions(dev, gen, d)
        tabs = sp.sp_tables(t.cpu().numpy(), nr=NR, Lmax=LMAX, d=d,
                            device=dev)
        nsh = sp.sp_sharded_levels(LMAX, NR, d)
        for s, sh in enumerate(sc.shards):
            args = (sh, qd, t, tabs.bidx[s], tabs.owned[s])
            e, *_ = compare(f"decode_attend_partial d={d} shard {s}",
                            dk.decode_attend_partial(*args, nr=NR),
                            dk.decode_attend_partial_ref(*args, nr=NR),
                            ATTN_TOL)
            err["attend"] = max(err["attend"], e)
            a, b = clone(sh, nsh), clone(sh, nsh)
            upd = (kn, vn, tabs.t_loc[s], tabs.upd_owned[s])
            _, ak, av = dk.update_cache_partial(a, *upd)
            _, bk, bv = dk.update_cache_partial_ref(b, *upd)
            for x, y in zip((a.k, a.v, *a.ck, *a.cv, ak, av),
                            (b.k, b.v, *b.ck, *b.cv, bk, bv)):
                if not torch.equal(x, y):
                    raise AssertionError(f"update_cache_partial d={d} shard "
                                         f"{s} is not bit-exact")
        with sp.sp_scope(mesh):
            merged = hd.decode_attend(sc, qd, t, nr=NR, tables=tabs)
        e, *_ = compare(f"SP attend d={d} vs decode_attend_fused", [merged],
                        [dk.decode_attend_fused(dense, qd, t, nr=NR)],
                        ATTN_TOL)
        err["merged"] = max(err["merged"], e)
        one = clone(dense)
        with sp.sp_scope(mesh):
            hd.update_cache(sc, kn, vn, t, tables=tabs)
        dk.update_cache_fused(one, kn, vn, t)
        back = sp.unshard_cache(sc)
        for x, y in zip((back.k, back.v, *back.ck, *back.cv),
                        (one.k, one.v, *one.ck, *one.cv)):
            if not torch.equal(x, y):
                raise AssertionError(f"SP update d={d} is not bit-exact "
                                     f"against update_cache_fused")
        log(f"sp d={d}: #11 max abs err {err['attend']:.3g} (merged vs #5 "
            f"{err['merged']:.3g}); #12 and the SP update bit-exact "
            f"({nsh} sharded levels of {nlev}"
            f"{', deep levels by #6' if nsh < nlev else ''})")

    # timed at d=4, the last pass's arrays: one shard's call.  The bound
    # counts what this shard's call needs: the key and value rows of the
    # keys it owns and the masks let through, each read once
    s = d - 1
    sh = sc.shards[s]
    args = (sh, qd, t, tabs.bidx[s], tabs.owned[s])
    keys = partial_keys(t, tabs.owned[s], nlev)
    f4 = 4
    nbytes = f4 * (keys * 2 * D + qd.numel() + R * (1 + 2 * (nlev + 1))
                   + R * G * (D + 2))
    bms, by = bound(nbytes, keys * G * (4 * D + 4))
    with sp.sp_scope(mesh):
        layer_ms = time_ms(lambda: hd.decode_attend(sc, qd, t, nr=NR,
                                                    tables=tabs))
    rows = [dict(
        name="decode_attend_partial", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_decode.cu",
        replaces="src/repro/kernels/h1d_decode_kernel.py:267",
        max_abs_err=err["attend"], merged_max_abs_err=err["merged"],
        ms=time_ms(lambda: dk.decode_attend_partial(*args, nr=NR)),
        device_ms=device_ms(lambda: dk.decode_attend_partial(*args, nr=NR)),
        plain_ms=time_ms(lambda: dk.decode_attend_partial_ref(*args, nr=NR)),
        bound_ms=bms, bound_by=by, library_ms=None,
        sp_layer_attend_ms=layer_ms,
        note=f"shard {s}'s call at d={d} (R={R}, Lmax {LMAX}): {keys} of "
             f"{R * (nlev + 1) * NR} band keys owned and unmasked, the "
             f"bound's; sp_layer_attend_ms: one layer's {d} calls and "
             f"their merge")]
    upd = (clone(sh, nsh), kn, vn, tabs.t_loc[s], tabs.upd_owned[s])
    # owner rows read their new row and one sibling and write one row a
    # level; a non-owner row's carry is its last level's pair, as stored;
    # every row's carry is written
    own = int(tabs.upd_owned[s].sum())
    nbytes = f4 * (2 * own * D + 2 * R + own * nsh * 2 * 2 * D
                   + (R - own) * 2 * 2 * D + 2 * R * D)
    bms, by = bound(nbytes, (own * nsh + R - own) * 2 * D)
    rows.append(dict(
        name="update_cache_partial", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_decode.cu",
        replaces="src/repro/kernels/h1d_decode_kernel.py:807",
        max_abs_err=0.0,
        ms=time_ms(lambda: dk.update_cache_partial(*upd)),
        device_ms=device_ms(lambda: dk.update_cache_partial(*upd)),
        plain_ms=time_ms(lambda: dk.update_cache_partial_ref(*upd)),
        bound_ms=bms, bound_by=by, library_ms=None,
        note=f"shard {s}'s call at d={d}: its {nsh} sharded levels of "
             f"{nlev}, {own} of {R} rows its own"))

    # #6 on the replicated deep tail at d=4, as SP serving runs it (every
    # SP launch of #6): the levels past the sharded ones, at t_deep
    if nsh >= nlev:
        raise AssertionError(f"sp d={d}: no replicated deep level")

    def deep_of(c):
        return hd.H1DCache(c.ck[nsh - 1].clone(), c.cv[nsh - 1].clone(),
                           tuple(a.clone() for a in c.ck[nsh:]),
                           tuple(a.clone() for a in c.cv[nsh:]))
    da, db = deep_of(sh), deep_of(sh)
    for step in range(3):        # chained writes: later ones read earlier
        dk.update_cache_fused(da, kn + step, vn - step, tabs.t_deep)
        dk.update_cache_ref(db, kn + step, vn - step, tabs.t_deep)
    for x, y in zip((da.k, da.v, *da.ck, *da.cv),
                    (db.k, db.v, *db.ck, *db.cv)):
        if not torch.equal(x, y):
            raise AssertionError("update_cache_fused on the SP deep tail is "
                                 "not bit-exact against update_cache_ref")
    ndeep = 1 + len(da.ck)
    bms, by = update_bound(R, ndeep, D)
    deep_args = (da, kn, vn, tabs.t_deep)
    rows.append(dict(
        name="update_cache_fused[sp_deep]", route="cuda",
        source="src/repro_torch/kernels/csrc/h1d_decode.cu",
        replaces="src/repro/kernels/h1d_decode_kernel.py:362",
        max_abs_err=0.0,
        ms=time_ms(lambda: dk.update_cache_fused(*deep_args)),
        device_ms=device_ms(lambda: dk.update_cache_fused(*deep_args)),
        plain_ms=time_ms(lambda: dk.update_cache_ref(db, kn, vn,
                                                     tabs.t_deep)),
        bound_ms=bms, bound_by=by, library_ms=None, nlev=ndeep,
        note=f"#6 on the replicated deep tail at d={d}: {ndeep} of {nlev} "
             f"levels ({da.k.shape[1]} rows) at t_deep; launches: every "
             f"SP launch of #6"))
    log(f"update_cache_fused[sp_deep]: bit-exact over 3 chained updates "
        f"({ndeep} level)")
    return rows


# bf16 decode rows at the serving shapes of phases 12 and 14 (4 slots,
# max_len 4096, nr 16): (config, rows = 4 slots x kv-heads, G, head_dim).
# The first, yi-6b's, heads the #5 and #6 rows; the paged, mixed-pool and
# SP rows run at it
BF16_DECODE = (("yi-6b", 16, 8, 128), ("gemma3-4b", 16, 2, 256),
               ("qwen2.5-14b", 32, 5, 128))
BF16_LMAX = 4096


def phase_bf16_kernels(dev):
    """#5 and #6 on bf16 caches against their plain versions at every
    shape of ``BF16_DECODE``, and #7, #9, #11, #12 (and #8 and #10 on a
    pool whose level 0 is int8, the rest bf16) at yi-6b's: attends within
    ATTN_TOL
    on the f32 output, updates bit for bit over 3 chained appends (paged
    ones outside TRASH); #11 and #12 as shard 1's call at d = 2.  Bounds
    count 2 bytes a cache element.  Rows are named ``<wrapper>[bf16]``
    (#5's and #6's list every shape under ``shapes``, the first at the
    top); their launches are the wrappers' bf16 launches."""
    from repro_torch.core import h1d_decode as hd
    from repro_torch.core import hierarchy as hc
    from repro_torch.kernels import h1d_decode_kernel as dk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    bf = torch.bfloat16
    Lb = BF16_LMAX
    gen = torch.Generator(device=dev).manual_seed(26)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    src = "src/repro_torch/kernels/csrc/h1d_decode.cu"
    rows = []

    def measured(kernel, plain, err, bms_by, **extra):
        bms, by = bms_by
        return dict(max_abs_err=err, ms=time_ms(kernel),
                    device_ms=device_ms(kernel), plain_ms=time_ms(plain),
                    bound_ms=bms, bound_by=by, **extra)

    def row(name, replaces, note, numbers, **extra):
        rows.append(dict(
            name=f"{name}[bf16]", route="cuda", source=src,
            replaces=f"src/repro/kernels/h1d_decode_kernel.py:{replaces}",
            library_ms=None, note=note, **numbers, **extra))
        log(f"{name}[bf16]: max abs err {numbers['max_abs_err']:.3g}; "
            f"{note}")

    def clone(c):
        return type(c)(*[tuple(a.clone() for a in x) if isinstance(x, tuple)
                         else x.clone() for x in c])

    M = hc.num_levels(Lb, NR)
    attends, updates = [], []
    for arch, Rb, Gb, Db in BF16_DECODE:
        cache = hd.prefill_cache(randn(Rb, Lb, Db).to(bf),
                                 randn(Rb, Lb, Db).to(bf), Lb, NR)
        q = randn(Rb, Gb, Db).to(bf).float()
        t = torch.randint(1000, Lb - 16, (Rb,), generator=gen, device=dev,
                          dtype=torch.int32)
        t[:4] = torch.tensor([0, NR - 1, NR, Lb - 1], dtype=torch.int32)
        small = 4 * (q.numel() + Rb + Rb * Gb * Db)
        keys = partial_keys(t, None, M)
        err, *_ = compare(f"decode_attend_fused[bf16] {arch}",
                          [dk.decode_attend_fused(cache, q, t, nr=NR)],
                          [dk.decode_attend_ref(cache, q, t, nr=NR)],
                          ATTN_TOL)
        attends.append(measured(
            lambda: dk.decode_attend_fused(cache, q, t, nr=NR),
            lambda: dk.decode_attend_ref(cache, q, t, nr=NR), err,
            bound(keys * 2 * Db * 2 + small, keys * Gb * (4 * Db + 4)),
            arch=arch, R=Rb, G=Gb, D=Db, live_keys=keys))
        kn, vn = randn(Rb, Db).to(bf), randn(Rb, Db).to(bf)
        a, b = clone(cache), clone(cache)
        for step in range(3):
            tt = (t + step).clamp(max=Lb - 1)
            dk.update_cache_fused(a, kn, vn * (step + 1), tt)
            dk.update_cache_ref(b, kn, vn * (step + 1), tt)
        if not all(torch.equal(x, y) for x, y in zip(pool_arrays(a),
                                                      pool_arrays(b))):
            raise AssertionError(f"update_cache_fused[bf16] {arch}: not "
                                 f"bit-exact")
        updates.append(measured(
            lambda: dk.update_cache_fused(a, kn, vn, t),
            lambda: dk.update_cache_ref(b, kn, vn, t), 0.0,
            update_bound(Rb, M, Db, es=2), arch=arch, R=Rb, G=Gb, D=Db))
        log(f"{arch} R {Rb}, G {Gb}, D {Db}: decode_attend_fused[bf16] "
            f"within {err:.3g}, update_cache_fused[bf16] bit-exact")
        if len(attends) == 1:
            head = (Rb, Gb, Db, cache, q, t, kn, vn, small, keys)
        del a, b
    Rb, Gb, Db, cache, q, t, kn, vn, small, keys = head
    where = ", ".join(f"{e['arch']} (R {e['R']}, G {e['G']}, D {e['D']})"
                      for e in attends)
    row("decode_attend_fused", 154,
        f"Lmax {Lb} at {where}; top: {attends[0]['arch']}, "
        f"{keys} band keys unmasked", attends[0], shapes=attends)
    row("update_cache_fused", 362,
        f"{M} levels at {where}; bit-exact over 3 chained updates; top: "
        f"{updates[0]['arch']}", updates[0], shapes=updates)

    # paged: a pool of 4 slots' pages (Lb / NR fine pages a slot, fewer
    # a coarse level) x 4 kv-heads + ZERO/TRASH, rows 14 and 15 inactive
    hkv = Rb // 4
    npages = [(4 * max((Lb >> l) // NR, 1) + 2) * hkv for l in range(M)]

    def pool(int8_level0):
        ks = [randn(n, NR, Db) for n in npages]
        vs = [randn(n, NR, Db) * 2 ** l for l, n in enumerate(npages)]
        if not int8_level0:
            return hd.PagedH1DCache(ks[0].to(bf), vs[0].to(bf),
                                    tuple(x.to(bf) for x in ks[1:]),
                                    tuple(x.to(bf) for x in vs[1:]))
        from repro_torch.core import quantization as qz
        qk, sk = qz.quantize_int8(ks[0], axis=-1)
        qv, sv = qz.quantize_int8(vs[0], axis=-1)
        ones = [torch.ones((n, NR), device=dev) for n in npages[1:]]
        return hd.QuantPagedH1DCache(
            qk, qv, tuple(x.to(bf) for x in ks[1:]),
            tuple(x.to(bf) for x in vs[1:]), sk[..., 0].contiguous(),
            sv[..., 0].contiguous(), tuple(ones), tuple(o.clone()
                                                        for o in ones))
    bfp, mixed = pool(False), pool(True)
    trash = TRASH * hkv
    bidx = torch.stack([torch.randint(2 * hkv, n, (Rb,), generator=gen,
                                      device=dev)
                        for n in [npages[0]] + npages], 1).to(torch.int32)
    utab = torch.stack([torch.randperm(n - 2 * hkv, generator=gen,
                                       device=dev)[:Rb] + 2 * hkv
                        for n in npages], 1).to(torch.int32)
    bidx[Rb - 2:] = trash
    utab[Rb - 2:] = trash
    for name, kern, plain, pl, replaces in (
            ("decode_attend_paged", dk.decode_attend_paged,
             dk.decode_attend_paged_ref, bfp, 426),
            ("decode_attend_paged_quant", dk.decode_attend_paged_quant,
             dk.decode_attend_paged_quant_ref, mixed, 482)):
        err, *_ = compare(f"{name}[bf16]", [kern(pl, q, t, bidx, nr=NR)],
                          [plain(pl, q, t, bidx, nr=NR)], ATTN_TOL)
        # a bf16 key and value row a key; in the mixed pool level 0's two
        # bands int8 rows (D bytes) and their 4-byte scales
        k8 = 0
        if pl is mixed:
            lvl0 = torch.zeros((Rb, M + 1), dtype=torch.int32, device=dev)
            lvl0[:, :2] = 1
            k8 = partial_keys(t, lvl0, M)
        nbytes = k8 * 2 * (Db + 4) + (keys - k8) * 2 * 2 * Db
        row(name, replaces,
            "level 0 int8, levels 1.. bf16 (yi-6b's int8 pool at "
            "quant_levels 1, phase 25 (b))" if k8 else "bf16 pool",
            measured(lambda: kern(pl, q, t, bidx, nr=NR),
                     lambda: plain(pl, q, t, bidx, nr=NR), err,
                     bound(nbytes + small + 4 * bidx.numel(),
                           keys * Gb * (4 * Db + 4)), live_keys=keys))
    a, b = clone(bfp), clone(bfp)
    for step in range(3):
        tt = (t + step).clamp(max=Lb - 1)
        dk.update_cache_paged(a, kn, vn * (step + 1), tt, utab)
        dk.update_cache_paged_ref(b, kn, vn * (step + 1), tt, utab)
    for x, y in zip(pool_arrays(a), pool_arrays(b)):
        keep = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
        keep[trash:trash + hkv] = False
        if not torch.equal(x[keep], y[keep]):
            raise AssertionError("update_cache_paged[bf16] is not bit-exact "
                                 "outside TRASH")
    row("update_cache_paged", 567,
        f"{M} levels; bit-exact outside TRASH over 3 chained updates",
        measured(lambda: dk.update_cache_paged(a, kn, vn, t, utab),
                 lambda: dk.update_cache_paged_ref(b, kn, vn, t, utab), 0.0,
                 update_bound(Rb, M, Db, table_cols=utab.shape[1], es=2)))

    # 25 (a): #10 on the pool whose level 0 is int8 and the rest bf16
    a, b = clone(mixed), clone(mixed)
    for step in range(3):
        tt = (t + step).clamp(max=Lb - 1)
        dk.update_cache_paged_quant(a, kn, vn * (step + 1), tt, utab)
        dk.update_cache_paged_quant_ref(b, kn, vn * (step + 1), tt, utab)
    for x, y in zip(pool_arrays(a), pool_arrays(b)):
        keep = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
        keep[trash:trash + hkv] = False
        if not torch.equal(x[keep], y[keep]):
            raise AssertionError("update_cache_paged_quant[bf16] is not "
                                 "bit-exact outside TRASH")
    # per row, k and v: level 0's int8 pair and two scales read and
    # rewritten; a bf16 level's new row written and its sibling read
    # (the last level's sibling feeds no carry); the new rows (f32), t and
    # the page table read
    nbytes = Rb * (2 * (2 * 2 * Db + 2 * 2 * 4)
                   + 2 * 2 * Db * ((M - 1) + (M - 2))
                   + 4 * (2 * Db + 1 + M))
    flops = Rb * 2 * Db * (2 * 8 + 2 * (M - 1))
    row("update_cache_paged_quant", 678,
        f"{M} levels, level 0 int8, levels 1.. bf16 (quant_levels 1, "
        f"phase 25 (a)); bit-exact outside TRASH over 3 chained updates",
        measured(lambda: dk.update_cache_paged_quant(a, kn, vn, t, utab),
                 lambda: dk.update_cache_paged_quant_ref(b, kn, vn, t, utab),
                 0.0, bound(nbytes, flops)))

    # SP at d = 2: shard 1's calls
    d = 2
    mesh = make_mesh((d,), ("data",), device=dev)
    sc = sp.shard_cache(cache, mesh, NR)
    tabs = sp.sp_tables(t.cpu().numpy(), nr=NR, Lmax=Lb, d=d, device=dev)
    nsh = sp.sp_sharded_levels(Lb, NR, d)
    sh = sc.shards[1]
    args = (sh, q, t, tabs.bidx[1], tabs.owned[1])
    err, *_ = compare("decode_attend_partial[bf16]",
                      dk.decode_attend_partial(*args, nr=NR),
                      dk.decode_attend_partial_ref(*args, nr=NR), ATTN_TOL)
    pkeys = partial_keys(t, tabs.owned[1], 1 + len(sh.ck))
    row("decode_attend_partial", 267,
        f"shard 1's call at d = {d}: {pkeys} band keys owned and unmasked",
        measured(lambda: dk.decode_attend_partial(*args, nr=NR),
                 lambda: dk.decode_attend_partial_ref(*args, nr=NR), err,
                 bound(pkeys * 2 * Db * 2 + small
                       + 4 * Rb * (2 + 2 * (M + 1)),
                       pkeys * Gb * (4 * Db + 4))))

    def slab(c):
        return hd.H1DCache(c.k.clone(), c.v.clone(),
                           tuple(x.clone() for x in c.ck[:nsh - 1]),
                           tuple(x.clone() for x in c.cv[:nsh - 1]))
    a, b = slab(sh), slab(sh)
    upd = (kn, vn, tabs.t_loc[1], tabs.upd_owned[1])
    _, ak, av = dk.update_cache_partial(a, *upd)
    _, bk, bv = dk.update_cache_partial_ref(b, *upd)
    if not all(torch.equal(x, y) for x, y in zip(
            (*pool_arrays(a), ak, av), (*pool_arrays(b), bk, bv))):
        raise AssertionError("update_cache_partial[bf16] is not bit-exact")
    own = int(tabs.upd_owned[1].sum())
    row("update_cache_partial", 807,
        f"shard 1's call at d = {d}: {nsh} sharded levels, {own} of {Rb} "
        f"rows its own; carries in bf16",
        measured(lambda: dk.update_cache_partial(a, *upd),
                 lambda: dk.update_cache_partial_ref(b, *upd), 0.0,
                 bound(4 * (2 * own * Db + 2 * Rb)
                       + 2 * (own * nsh * 2 * 2 * Db
                              + (Rb - own) * 2 * 2 * Db + 2 * Rb * Db),
                       (own * nsh + Rb - own) * 2 * Db)))
    return rows


def phase_sp_prefill(cfg, params, fns, reqs, dev):
    """Phase 4's 16 prompts as one batch right-padded to the 2048
    bucket, prefilled inside a 4-way ``sp_scope`` and densely: the SP
    logits within LOGIT_TOL of the dense ones, and every layer's SP
    caches, after ``shard_cache`` and ``unshard_cache``, within
    CACHE_TOL of the dense caches (layer 0's bit-exact: its keys and
    values come before any attention)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    toks = np.zeros((len(reqs), LMAX), np.int64)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = r.prompt
    batch = {"tokens": torch.as_tensor(toks, device=dev)}
    tl = torch.as_tensor([len(r.prompt) for r in reqs], dtype=torch.int32,
                         device=dev)
    mesh = make_mesh((4,), ("data",), device=dev)
    with torch.inference_mode():
        lg_d, c_d, _ = fns.prefill(params, cfg, batch, LMAX, true_len=tl)
        sp.DISPATCHES.clear()
        with sp.sp_scope(mesh):
            lg_s, c_s, _ = fns.prefill(params, cfg, batch, LMAX, true_len=tl)
    if sp.DISPATCHES.get("h1d_attention") != cfg.num_layers:
        raise AssertionError(f"sp prefill: {sp.DISPATCHES} SP operator "
                             f"calls for {cfg.num_layers} layers")
    e_logits = errors("sp prefill logits", [lg_s], [lg_d])[0]   # max abs
    if e_logits > LOGIT_TOL:
        raise AssertionError(f"sp prefill: logits differ from the dense "
                             f"prefill's by {e_logits:.3g} > {LOGIT_TOL}")
    worst = 0.0
    for layer, (a, b) in enumerate(zip(c_s, c_d)):
        back = sp.unshard_cache(sp.shard_cache(a, mesh, cfg.nr))
        got = (back.k, back.v, *back.ck, *back.cv)
        want = (b.k, b.v, *b.ck, *b.cv)
        if layer == 0:
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError("sp prefill: layer 0's caches are not "
                                     "bit-exact")
            continue
        _, e, _ = compare(f"sp prefill caches, layer {layer}", got, want,
                          CACHE_TOL, scale=("row",) * len(got))
        worst = max(worst, e)
    log(f"sp prefill d=4 at the {LMAX} bucket ({len(reqs)} prompts): logits "
        f"max abs diff {e_logits:.3g} (<= {LOGIT_TOL}); caches layer 0 "
        f"bit-exact, layers 1..{cfg.num_layers - 1} row-scaled "
        f"{worst:.3g} (<= {CACHE_TOL})")


def phase_sp_serve(cfg, params, fns, reqs, dense_stats, deep_levels, dev):
    """Phase 4's requests through sequence-parallel engines: (b) d=4 with
    8 slots, (c) d=2 on the first 4 requests, (d) d=4 with one slot on
    the first.  Returns the launches of the three runs summed, #6's under
    ``update_cache_fused[sp_deep]``: SP serving runs #6 on the replicated
    deep tail alone, which must have the ``deep_levels`` levels that row
    timed."""
    from repro_torch import kernels
    from repro_torch.core import hierarchy as hc
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp
    from repro_torch.serve import ServeEngine

    guarded = []                  # phase 5b's rule: top-2 margins > 1e-3
    with torch.inference_mode():
        for r in reqs:
            seq = np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1],
                                                       np.int32)])
            lg, _ = fns.forward(params, cfg, torch.as_tensor(
                seq[None], dtype=torch.long, device=dev))
            top2 = lg[0, len(r.prompt) - 1:].topk(2, dim=-1).values
            if float((top2[:, 0] - top2[:, 1]).min()) > LOGIT_TOL:
                guarded.append(r.uid)
    want = {r.uid: list(r.out_tokens) for r in reqs}
    phase_sp_prefill(cfg, params, fns, reqs, dev)
    runs = {"b_d4": (4, 8, reqs), "c_d2": (2, 8, reqs[:4]),
            "d_d4_slots1": (4, 1, reqs[:1])}
    total = {}
    kept = {}
    for name, (d, slots, rs) in runs.items():
        eng = ServeEngine(cfg, params, slots=slots, max_len=LMAX,
                          mesh=make_mesh((d,), ("data",), device=dev))
        sp.DISPATCHES.clear()
        outs, stats, counts = run_engine(
            eng, [(r.uid, r.prompt) for r in rs], fns)
        # #6 runs on the replicated deep levels, which d=2 does not have
        ndeep = (hc.num_levels(LMAX, cfg.nr)
                 - sp.sp_sharded_levels(LMAX, cfg.nr, d))
        missing = [k for k in kernels.SP_SERVE_KERNELS if counts[k] == 0
                   and (ndeep or k != "update_cache_fused")]
        if missing or counts["decode_attend_fused"]:
            raise AssertionError(f"sp {name}: kernels {missing} not launched "
                                 f"or #5 launched: {counts}")
        if counts["update_cache_fused"] and ndeep != deep_levels:
            raise AssertionError(f"sp {name}: #6 ran on a {ndeep}-level deep "
                                 f"tail, its row times {deep_levels}")
        counts["update_cache_fused[sp_deep]"] = counts.pop(
            "update_cache_fused")
        if not sp.DISPATCHES.get("h1d_attention"):
            raise AssertionError(f"sp {name}: no prefill ran sharded")
        bad = [u for u in outs if u in guarded and outs[u] != want[u]]
        if bad:
            raise AssertionError(f"sp {name}: requests {bad} differ from "
                                 f"phase 4's tokens")
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        stats.update(shards=d, slots=slots, guarded=sum(u in guarded
                                                        for u in outs),
                     sp_dispatches=dict(sp.DISPATCHES))
        kept[name] = (outs, stats, counts, guarded)
        del eng
        torch.cuda.empty_cache()
        log(f"sp {name}: {json.dumps(stats)}")
    log(f"sp: every margin-guarded request ({len(guarded)} of {len(reqs)}) "
        f"gave phase 4's tokens; dense engine (phase 4, same call): "
        f"{dense_stats['tokens_per_s']:.1f} tokens/s, decode "
        f"{dense_stats['decode_ms_per_tick']:.2f} ms/tick, prefill "
        f"{dense_stats['prefill_ms_per_call']:.2f} ms/call")
    return total, kept


def phase_train(dev):
    """20 AdamW steps of h1d-lm-53m at full width and depth, 8 x 1024."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import ZipfLM
    from repro_torch.train import TrainConfig, tokens_per_s, train

    cfg = get_config("h1d-lm-53m")
    steps, batch, seq = 20, 8, 1024
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=seq,
                  batch_per_host=batch, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(peak_lr=3e-4, warmup=5, ckpt_every=0, ckpt_dir=tmp,
                         log_every=5)
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = train(cfg, tc, data, steps, device=dev, log=log)
        wall = time.perf_counter() - t0
    counts = path_counts()
    plain = {n: p.calls for n, (_, p) in kernels.KERNELS.items()}
    missing = [n for n in kernels.TRAIN_KERNELS if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the training path: "
                             f"{missing}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the training path: "
                             f"{plain}")
    losses = [h["loss"] for h in metrics["history"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    hist = metrics["history"]
    log(f"train: first step {hist[0]['step_ms']:.1f} ms (warm-up; "
        f"tokens_per_s below counts the steps after it)")
    stats = dict(steps=steps, batch=batch, seq=seq, wall_s=wall,
                 tokens_per_s=tokens_per_s(hist, batch * seq),
                 steady_wall_s=hist[-1]["end_s"] - hist[0]["end_s"],
                 median_step_ms=float(np.median([h["step_ms"]
                                                 for h in hist[1:]])),
                 loss_first=losses[0], loss_last5_mean=float(
                     np.mean(losses[-5:])), losses=losses,
                 launches={n: counts[n] for n in kernels.TRAIN_KERNELS})
    log(f"train: {json.dumps(stats)}")
    return counts, stats


def grads_against_plain(label, params, loss_of, run=contextlib.nullcontext,
                        ref=plain_kernels, names=("kernel", "plain"),
                        leaf_tol=None):
    """The gradient of ``loss_of(params)`` on the kernel path against the
    plain path on the card, leaf by leaf: each leaf within GRAD_TOL of
    its largest |plain| (a leaf whose path ends in a key of ``leaf_tol``:
    within that key's value), and elementwise within GRAD_TOL * max(1,
    |plain|).  ``run`` and ``ref`` are the contexts the two gradients are
    taken in (named ``names`` in the log): the kernel path as it is, and
    under :func:`plain_kernels`, unless the caller says otherwise."""
    from repro_torch.tree import (tree_flatten_with_paths, tree_leaves,
                                  tree_unflatten_like)
    leaves = tree_leaves(params)

    def grads():
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_of(tree_unflatten_like(params, ps))
        return float(loss.detach()), torch.autograd.grad(loss, ps)

    with run():
        loss_k, got = grads()
    with ref():
        loss_p, want = grads()
    paths = [p for p, _ in tree_flatten_with_paths(params)]
    worst = (0.0, 0.0, 0.0, "")
    for path, a, b in zip(paths, got, want):
        tol = next((t for end, t in (leaf_tol or {}).items()
                    if path.endswith(end)), GRAD_TOL)
        err, scaled, elem = compare(f"{label} grad {path}", [a], [b], tol,
                                    ("tensor",))
        if elem > GRAD_TOL:
            raise AssertionError(f"{label} grad {path}: elementwise-scaled "
                                 f"error {elem:.3g} > {GRAD_TOL:g}")
        if scaled >= worst[1]:
            worst = (err, scaled, elem, path)
    tops = sorted(float(b.abs().max()) for b in want)
    log(f"{label} grads: loss {loss_k:.6f} {names[0]} vs {loss_p:.6f} "
        f"{names[1]}; "
        f"{len(paths)} leaves, largest |grad| per leaf from {tops[0]:.3g} "
        f"(median {tops[len(tops) // 2]:.3g}) to {tops[-1]:.3g}; worst "
        f"error {worst[1]:.3g} of its leaf's largest |grad| (abs "
        f"{worst[0]:.3g}, elementwise-scaled {worst[2]:.3g}) at {worst[3]}")


def phase_grads(dev):
    """lm_loss gradient of one 2 x 1024 batch, kernel path vs plain."""
    from repro_torch.configs import get_config
    from repro_torch.data import ZipfLM
    from repro_torch.models import get_model
    from repro_torch.train import batch_to_device

    cfg = get_config("h1d-lm-53m")
    fns = get_model(cfg)
    params = fns.init(cfg, seed=1, device=dev)
    batch = batch_to_device(ZipfLM(vocab_size=cfg.vocab_size, seq_len=1024,
                                   batch_per_host=2, seed=0).batch(0), dev)
    grads_against_plain("lm", params,
                        lambda p: fns.loss(p, cfg, batch)[0])


def need_launched(label, counts, pairs):
    """Every (kernel, mode) of ``pairs`` launched, and no plain version
    ran, in the run ``counts`` were read after."""
    from repro_torch import kernels
    missing = [f"{n}[{m}]" for n, m in pairs if not counts.get(f"{n}[{m}]")]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    plain = {n: p.calls for n, (_, p) in kernels.KERNELS.items() if p.calls}
    if plain:
        raise AssertionError(f"{label}: plain versions ran: {plain}")


def phase_lra(dev):
    """``h1d-lra-encoder`` at full width and depth from seeded random
    weights: (a) classify a held-out ListOps batch, (b) train 10 AdamW
    steps, (c) the whole model's gradient against the plain path, (d)
    the coarse-q LM's training steps and gradient.  Returns the launches
    of (a) + (b) and of (d)'s training."""
    from repro_torch import kernels, optim
    from repro_torch.configs import get_config
    from repro_torch.data import ListOps, ZipfLM
    from repro_torch.launch.profile_serve import profiled
    from repro_torch.models import (classifier_init, classifier_logits,
                                    classifier_loss, get_model)
    from repro_torch.train import TrainConfig, batch_to_device, train
    from repro_torch.tree import tree_leaves, tree_unflatten_like

    cfg = get_config("h1d-lra-encoder")
    params = classifier_init(cfg, NUM_CLASSES, seed=0, device=dev)
    fwd_pairs = [p for p in kernels.LRA_KERNELS
                 if p[0] == "band_attention_fwd"]

    # (a) classify one held-out batch, 64 x 2048
    held = batch_to_device(ListOps(seq_len=LRA_L, batch_per_host=64,
                                   seed=999).batch(0), dev)

    def classify():
        with torch.inference_mode():
            return classifier_logits(params, cfg, held["tokens"],
                                     held["mask"])
    classify()                      # warm-up (cuBLAS, allocator)
    kernels.reset_counts()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = classify()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = path_counts()
    need_launched("lra classify", counts, fwd_pairs)
    with plain_kernels():
        want = classify()
    if logits.shape != (64, NUM_CLASSES) or not torch.isfinite(logits).all():
        raise AssertionError(f"lra classify: bad logits {logits.shape}")
    diff = float((logits - want).abs().max())
    if diff > LOGIT_TOL:
        raise AssertionError(f"lra classify: logits differ by {diff:.3g} > "
                             f"{LOGIT_TOL}")
    prof = profiled(classify, 2)
    ms = float(np.median(walls))
    stats = dict(rows=64, seq=LRA_L, wall_ms_per_call=walls,
                 classifications_per_s=64 / (ms / 1e3),
                 mean_true_len=float(held["mask"].sum(1).mean()),
                 kernel_vs_plain_max_abs=diff,
                 device_ms=prof["device_ms"], busy_share=prof["busy_share"],
                 device_ms_by_group=prof["device_ms_by_group"],
                 launches={k: c for k, c in counts.items() if c})
    log(f"lra classify: {json.dumps(stats)}")

    # (b) 10 AdamW steps at 32 x 2048: bench_lra_listops.py's warmup and
    # weight decay, the port trainer's default peak (the bench's 2e-3 is
    # sized for its 64-wide model: at full width the loss rises under it)
    steps, batch = 10, 32
    data = ListOps(seq_len=LRA_L, batch_per_host=batch, seed=0)
    batches = [batch_to_device(data.batch(i), dev) for i in range(steps)]
    opt = optim.adamw(optim.cosine_schedule(LRA_PEAK_LR, 10, steps),
                      weight_decay=0.01)
    state = [params, opt.init(params)]

    def step(b):
        ps, opt_state = state
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(ps)]
        loss, _ = classifier_loss(tree_unflatten_like(ps, leaves), cfg, b)
        grads = torch.autograd.grad(loss, leaves)
        upd, opt_state = opt.update(tree_unflatten_like(ps, list(grads)),
                                    opt_state, ps)
        state[:] = [optim.apply_updates(ps, upd), opt_state]
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    losses, step_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        losses.append(float(step(b)))       # waits for the device
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    train_counts = path_counts()
    need_launched("lra train", train_counts, kernels.LRA_KERNELS)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"lra train: non-finite loss: {losses}")
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f"lra train: loss did not fall: {losses}")
    prof = profiled(lambda: step(batches[-1]), 1)
    stats = dict(steps=steps, batch=batch, seq=LRA_L, losses=losses,
                 loss_first=losses[0],
                 loss_last5_mean=float(np.mean(losses[-5:])),
                 step_ms=step_ms,
                 median_step_ms=float(np.median(step_ms[1:])),
                 tokens_per_s=batch * LRA_L * (steps - 1)
                 / (sum(step_ms[1:]) / 1e3),
                 mean_true_len=float(np.mean([float(b["mask"].sum(1).mean())
                                              for b in batches])),
                 max_memory_allocated=peak,
                 step_device_ms=prof["device_ms"],
                 step_busy_share=prof["busy_share"],
                 step_device_ms_by_group=prof["device_ms_by_group"],
                 launches={k: c for k, c in train_counts.items() if c})
    log(f"lra train: {json.dumps(stats)}")
    for k, c in train_counts.items():
        counts[k] = counts.get(k, 0) + c
    del state, batches

    # (c) the whole encoder's gradient, 2 x 2048, kernel vs plain path
    params = classifier_init(cfg, NUM_CLASSES, seed=1, device=dev)
    gb = batch_to_device(ListOps(seq_len=LRA_L, batch_per_host=2,
                                 seed=7).batch(0), dev)
    grads_against_plain("lra", params,
                        lambda p: classifier_loss(p, cfg, gb)[0])
    del params

    # (d) the coarse-q LM: 3 AdamW steps through train(), then its
    # gradient at 2 x 1024 against the plain path
    import tempfile
    lm = get_config("h1d-lm-53m")
    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(peak_lr=3e-4, warmup=2, ckpt_every=0, ckpt_dir=tmp,
                         attn_causal_mode="coarse-q")
        kernels.reset_counts()
        _, metrics = train(lm, tc, ZipfLM(vocab_size=lm.vocab_size,
                                          seq_len=1024, batch_per_host=8,
                                          seed=0), 3, device=dev, log=log)
    cq_counts = path_counts()
    need_launched("coarse-q train", cq_counts, kernels.COARSE_Q_KERNELS)
    cq_losses = [h["loss"] for h in metrics["history"]]
    if not all(math.isfinite(x) for x in cq_losses):
        raise AssertionError(f"coarse-q train: non-finite loss {cq_losses}")
    log(f"coarse-q train: losses {cq_losses}, step ms "
        f"{[h['step_ms'] for h in metrics['history']]}, launches "
        f"{ {k: c for k, c in cq_counts.items() if c} }")
    cq = dataclasses.replace(lm, causal_mode="coarse-q")
    fns = get_model(cq)
    params = fns.init(cq, seed=1, device=dev)
    zb = batch_to_device(ZipfLM(vocab_size=cq.vocab_size, seq_len=1024,
                                batch_per_host=2, seed=0).batch(0), dev)
    grads_against_plain("coarse-q lm", params,
                        lambda p: fns.loss(p, cq, zb)[0])
    return counts, cq_counts


# ---------------------------------------------------------------------------
# phases 9-11: SP training, coarse-q serving, sampled serving
# ---------------------------------------------------------------------------

SP_OP_FWD_TOL = 2e-5
SP_MODES = {"fine-q": (True, "fine-q"), "coarse-q": (True, "coarse-q"),
            "bidir": (False, "fine-q")}


def sp_expected(d, L, layers, mode, backward=True):
    """The launches an SP operator call makes per layer, times
    ``layers``: #1 at level 0 and, on every level a shard keeps locally,
    #2 (fine-q) or #1 in the coarse mode, one launch a shard each; the
    gathered deep levels launch nothing.  ``backward`` adds #3 / #4."""
    from repro_torch.core import hierarchy as hc
    from repro_torch.parallel import sp_attention as sp
    causal, causal_mode = SP_MODES[mode]
    coarse = sp.sp_n_shallow(hc.num_levels(L, NR), L // d, NR) - 1
    l0 = "l0_causal" if causal else "l0_bidir"
    if causal_mode == "fine-q" and causal:
        up = {"band_attention_sub_fwd": coarse}
        down = {"band_attention_sub_bwd": coarse}
    else:
        cm = "coarse_causal" if causal else "coarse_bidir"
        up = {f"band_attention_fwd[{cm}]": coarse}
        down = {f"band_attention_bwd[{cm}]": coarse}
    want = {f"band_attention_fwd[{l0}]": 1, **up}
    if backward:
        want.update({f"band_attention_bwd[{l0}]": 1, **down})
    return {k: v * d * layers for k, v in want.items()}


def need_counts(label, counts, want):
    """``counts`` hold exactly ``want`` for its keys (the per-shard
    launches) and no plain version ran."""
    from repro_torch import kernels
    bad = {k: (counts.get(k, 0), v) for k, v in want.items()
           if counts.get(k, 0) != v}
    if bad:
        raise AssertionError(f"{label}: launches (got, want) {bad}")
    plain = {n: p.calls for n, (_, p) in kernels.KERNELS.items() if p.calls}
    if plain:
        raise AssertionError(f"{label}: plain versions ran: {plain}")


@contextlib.contextmanager
def counted(into, ctx=None):
    """Set the kernel counts to 0, run the body (inside ``ctx``), and
    read the counts into ``into`` just after."""
    from repro_torch import kernels
    kernels.reset_counts()
    with ctx if ctx is not None else contextlib.nullcontext():
        yield
    into.update(path_counts())


@contextlib.contextmanager
def band_calls(seen):
    """Record the inputs of the first call of every distinct (wrapper,
    shapes, options) of the four band kernels into ``seen``.  The
    recording stands in for the wrappers as their module attribute, so
    the launches of a run inside it count on the recording, never on
    the kernel rows."""
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_block_bwd as hbb
    names = [(hb, "band_attention_fwd"), (hb, "band_attention_sub_fwd"),
             (hbb, "band_attention_bwd"), (hbb, "band_attention_sub_bwd")]
    saved = [(m, n, getattr(m, n)) for m, n in names]

    def record(name, fn):
        def call(*args, **kw):
            key = (name, tuple(sorted(kw.items())),
                   tuple(tuple(a.shape) for a in args))
            if key not in seen:
                seen[key] = ([a.detach().clone() for a in args], dict(kw))
            return fn(*args, **kw)
        call.launches, call.mode_launches = 0, {}
        return call
    for m, n, f in saved:
        setattr(m, n, record(n, f))
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def check_band_calls(label, seen):
    """Every recorded call's kernel against its plain version on the same
    inputs: forward outputs within ATTN_TOL, backward within GRAD_TOL
    row-scaled (phases 2 and 3's bounds)."""
    from repro_torch import kernels
    worst = {"fwd": 0.0, "bwd": 0.0}
    for (name, opts, shapes), (args, kw) in sorted(seen.items(),
                                                    key=lambda x: x[0]):
        kernel, plain = kernels.KERNELS[name]
        bwd = name.endswith("_bwd")
        what = f"{label} {name} {dict(opts)} q{shapes[0]} k{shapes[1]}"
        _, e, _ = compare(what, kernel(*args, **kw), plain(*args, **kw),
                          GRAD_TOL if bwd else ATTN_TOL,
                          ("row", "row", "row") if bwd else ())
        worst["bwd" if bwd else "fwd"] = max(worst["bwd" if bwd else "fwd"],
                                             e)
    log(f"{label}: {len(seen)} distinct band kernel calls held against "
        f"their plain versions, worst scaled error forward "
        f"{worst['fwd']:.3g} (<= {ATTN_TOL}), backward {worst['bwd']:.3g} "
        f"(<= {GRAD_TOL}, row-scaled): "
        + "; ".join(sorted({f"{n} {dict(o)} q{s[0]} k{s[1]}"
                            for n, o, s in seen})))


def phase_sp_train(dev, train_stats):
    """Sequence-parallel training of ``h1d-lm-53m`` at full width and
    depth: (a) the lm_loss gradient of one 2 x 1024 batch under a d-way
    ``sp_scope`` (d = 4, then 2) against the unsharded gradient on the
    kernel path, leaf by leaf; (b) at d = 4 ``sp_h1d_attention``'s
    forward and q/k/v gradients at L 1024, nr 16, head dim 64, G 1 (16
    rows, every third padded over its last 200 keys) in fine-q, coarse-q
    and bidirectional mode against the unsharded operator on the kernel
    path; (c) 3 AdamW steps through ``train(..., mesh=make_mesh((4,),
    ("data",)))``.  In each, #1-#4 launch once per shard, level and
    layer, exactly, and no plain version runs.  Then every distinct band
    kernel call of (a)-(c) is held against its plain version on the
    inputs it was given.  Returns (c)'s launches."""
    import tempfile
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.h1d_attention import h1d_attention
    from repro_torch.data import ZipfLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.parallel import sp_attention as sp
    from repro_torch.train import (TrainConfig, batch_to_device, train,
                                   tokens_per_s)
    from repro_torch.tree import tree_leaves, tree_unflatten_like

    cfg = get_config("h1d-lm-53m")
    fns = get_model(cfg)
    layers = cfg.num_layers
    meshes = {d: make_mesh((d,), ("data",), device=dev) for d in (4, 2)}

    # (a) the whole model's gradient, sharded against unsharded
    params = fns.init(cfg, seed=1, device=dev)
    batch = batch_to_device(ZipfLM(vocab_size=cfg.vocab_size, seq_len=L,
                                   batch_per_host=2, seed=0).batch(0), dev)
    for d, mesh in meshes.items():
        counts = {}
        grads_against_plain(
            f"sp train (a) d={d}", params,
            lambda p: fns.loss(p, cfg, batch)[0],
            run=lambda mesh=mesh, counts=counts: counted(
                counts, sp.sp_scope(mesh)),
            ref=contextlib.nullcontext, names=(f"sp d={d}", "unsharded"))
        need_counts(f"sp train (a) d={d}", counts,
                    sp_expected(d, L, layers, "fine-q"))

    # (b) the operator alone, in the three modes
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = 16
    w = torch.ones((rows, L), device=dev)
    w[::3, L - 200:] = 0.0
    worst = {}
    for mode, (causal, causal_mode) in SP_MODES.items():
        q = torch.randn((rows, 1, L, D), generator=gen, device=dev)
        k = torch.randn((rows, L, D), generator=gen, device=dev)
        v = torch.randn((rows, L, D), generator=gen, device=dev)
        cot = torch.randn((rows, 1, L, D), generator=gen, device=dev)
        kw = dict(nr=NR, causal=causal, causal_mode=causal_mode,
                  kv_weight=w)

        def run(fn):
            x = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fn(*x)
            return out.detach(), torch.autograd.grad(out, x, cot)
        counts = {}
        with counted(counts):
            out, g = run(lambda *x: sp.sp_h1d_attention(
                *x, mesh=meshes[4], **kw))
        need_counts(f"sp train (b) {mode}", counts,
                    sp_expected(4, L, 1, mode))
        ref_out, ref_g = run(lambda *x: h1d_attention(*x, **kw))
        _, ef, _ = compare(f"sp operator {mode} forward", [out], [ref_out],
                           SP_OP_FWD_TOL, ("row",))
        _, eb, _ = compare(f"sp operator {mode} dq/dk/dv", g, ref_g,
                           GRAD_TOL, ("row", "row", "row"))
        worst[mode] = dict(forward=ef, backward=eb)
    log(f"sp train (b) sp_h1d_attention d=4 against the unsharded operator "
        f"(row-scaled; forward <= {SP_OP_FWD_TOL}, q/k/v gradients <= "
        f"{GRAD_TOL}): {json.dumps(worst)}")
    del params

    # (c) 3 AdamW steps through train() on a 4-way mesh
    steps, nb = 3, 8
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=L, batch_per_host=nb,
                  seed=0)
    sp_counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(peak_lr=3e-4, warmup=5, ckpt_every=0, ckpt_dir=tmp,
                         log_every=1)
        sp.DISPATCHES.clear()
        with counted(sp_counts):
            state, metrics = train(cfg, tc, data, steps, device=dev,
                                   mesh=meshes[4], log=log)
    need_counts("sp train (c)", sp_counts,
                sp_expected(4, L, layers * steps, "fine-q"))
    if sp.DISPATCHES.get("h1d_attention") != layers * steps:
        raise AssertionError(f"sp train (c): {sp.DISPATCHES} SP operator "
                             f"calls for {steps} steps of {layers} layers")
    hist = metrics["history"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"sp train (c): non-finite loss {losses}")
    stats = dict(shards=4, steps=steps, batch=nb, seq=L, losses=losses,
                 step_ms=[h["step_ms"] for h in hist],
                 median_step_ms=float(np.median([h["step_ms"]
                                                 for h in hist[1:]])),
                 tokens_per_s=tokens_per_s(hist, nb * L),
                 launches={k: c for k, c in sp_counts.items() if c})
    log(f"sp train (c): {json.dumps(stats)}; unsharded (phase 6, same "
        f"call): median step {train_stats['median_step_ms']:.1f} ms, "
        f"{train_stats['tokens_per_s']:.0f} tokens/s")

    # every distinct band kernel call of (a)-(c), kernel against plain
    seen = {}
    with band_calls(seen):
        params = tree_leaves(state.params)
        ps = [p.detach().requires_grad_(True) for p in params]
        big = batch_to_device(data.batch(0), dev)
        with sp.sp_scope(meshes[4]):
            loss = fns.loss(tree_unflatten_like(state.params, ps), cfg,
                            big)[0]
        torch.autograd.grad(loss, ps)
        ps = [p.detach().requires_grad_(True) for p in params]
        with sp.sp_scope(meshes[2]):
            loss = fns.loss(tree_unflatten_like(state.params, ps), cfg,
                            batch)[0]
        torch.autograd.grad(loss, ps)
        del ps, loss
        for causal, causal_mode in SP_MODES.values():
            x = [torch.randn(s, generator=gen, device=dev).requires_grad_(
                True) for s in ((rows, 1, L, D), (rows, L, D), (rows, L, D))]
            out = sp.sp_h1d_attention(*x, mesh=meshes[4], nr=NR,
                                      causal=causal, causal_mode=causal_mode,
                                      kv_weight=w)
            torch.autograd.grad(out.square().sum(), x)
    kernels.reset_counts()
    check_band_calls("sp train kernel shapes", seen)
    del state, seen
    torch.cuda.empty_cache()
    return sp_counts


def margins_of(eng, into):
    """Record, for every token ``eng`` takes, the top-2 margin of what it
    took the argmax of (the logits, plus the noise where it samples),
    under the request's uid in ``into``."""
    sample = eng._sample
    drawn = {}
    noise = eng._noise

    def noted(rows, reqs, vocab, tick):
        drawn["g"] = noise(rows, reqs, vocab, tick)
        return drawn["g"]

    def guarded(logits, rows, reqs, tick):
        out = sample(logits, rows, reqs, tick)
        z = logits.float() + (0 if eng.greedy else drawn["g"])
        top2 = z.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).tolist()
        for i, r in enumerate(reqs):
            if r is not None:
                into.setdefault(r.uid, []).append(gap[i])
        return out
    eng._noise, eng._sample = noted, guarded
    return eng


def phase_cq_serve(cfg, params, fns, reqs, dense_stats, dev):
    """Phase 4's 16 requests on ``h1d-lm-53m`` with ``causal_mode=
    'coarse-q'`` (same weights, 8 slots, max_len 2048, prompts
    unbucketed): #1 in ``l0_causal`` and ``coarse_causal`` in prefill, #5
    and #6 in decode, no plain version; then the same requests with the
    twelve call sites on their plain versions: every request whose
    top-2 margins all exceed LOGIT_TOL on the kernel path gives the
    plain path's tokens.  Returns the kernel run's launches."""
    from repro_torch.serve import Request, ServeEngine

    cq = dataclasses.replace(cfg, causal_mode="coarse-q")
    work = [(r.uid, r.prompt) for r in reqs]
    margins = {}
    eng = margins_of(ServeEngine(cq, params, slots=8, max_len=LMAX), margins)
    if eng._bucket_len(100) != 100:
        raise AssertionError("coarse-q engine buckets its prompts")
    outs, stats, counts = run_engine(eng, work, fns)
    need = ("band_attention_fwd[l0_causal]",
            "band_attention_fwd[coarse_causal]", "decode_attend_fused",
            "update_cache_fused")
    missing = [k for k in need if not counts.get(k)]
    if missing or counts.get("band_attention_sub_fwd"):
        raise AssertionError(f"cq serve: {missing} not launched, or the "
                             f"fine-q sub level ran: {counts}")
    del eng
    eng = ServeEngine(cq, params, slots=8, max_len=LMAX)
    rs = [Request(uid=u, prompt=p, max_new_tokens=PAGED_NEW)
          for u, p in work]
    for r in rs:
        eng.submit(r)
    with plain_kernels():
        eng.run()
    plain = {r.uid: list(r.out_tokens) for r in rs}
    guarded = [u for u, g in margins.items() if min(g) > LOGIT_TOL]
    bad = [u for u in guarded if outs[u] != plain[u]]
    if bad:
        raise AssertionError(f"cq serve: requests {bad} differ from the "
                             f"plain path's tokens")
    stats.update(guarded=len(guarded))
    log(f"cq serve: {json.dumps(stats)}")
    log(f"cq serve: every margin-guarded request ({len(guarded)} of "
        f"{len(work)}) gave the plain path's tokens; fine-q dense engine "
        f"(phase 4, same call): {dense_stats['tokens_per_s']:.1f} "
        f"tokens/s, decode {dense_stats['decode_ms_per_tick']:.2f} "
        f"ms/tick, prefill {dense_stats['prefill_ms_per_call']:.2f} "
        f"ms/call")
    return counts


def phase_sample_serve(cfg, params, fns, reqs, dense_stats, dev):
    """Phase 4's requests sampled (``greedy=False, seed=0``) at 8 slots,
    twice, and at 1 slot: the two 8-slot runs give identical tokens, and
    every request whose top-2 margins of logits plus noise all exceed
    LOGIT_TOL gives the same tokens at 1 slot (a request's noise is its
    own: no slot, batch or pad row changes it); #1, #2, #5 and #6
    launched, no plain version.  Returns the first run's launches."""
    from repro_torch.serve import ServeEngine

    work = [(r.uid, r.prompt) for r in reqs]
    runs, margins = {}, {}
    for name, slots in (("a_slots8", 8), ("b_slots8", 8), ("c_slots1", 1)):
        eng = ServeEngine(cfg, params, slots=slots, max_len=LMAX,
                          greedy=False, seed=0)
        if name == "a_slots8":
            margins_of(eng, margins)
        outs, stats, counts = run_engine(eng, work, fns)
        runs[name] = (outs, stats, counts)
        log(f"sample {name}: {json.dumps(stats)}")
        del eng
    first = runs["a_slots8"][2]
    missing = [k for k in ("band_attention_fwd[l0_causal]",
                           "band_attention_sub_fwd", "decode_attend_fused",
                           "update_cache_fused") if not first.get(k)]
    if missing:
        raise AssertionError(f"sample: {missing} not launched")
    a, b, c = (runs[n][0] for n in ("a_slots8", "b_slots8", "c_slots1"))
    if a != b:
        raise AssertionError("sample: two runs of one seed differ")
    guarded = [u for u, g in margins.items() if min(g) > LOGIT_TOL]
    bad = [u for u in guarded if a[u] != c[u]]
    if bad:
        raise AssertionError(f"sample: requests {bad} differ between 8 "
                             f"slots and 1")
    greedy = {r.uid: list(r.out_tokens) for r in reqs}
    same = sum(x == y for u in a for x, y in zip(a[u], greedy[u]))
    log(f"sample: two 8-slot runs identical; {len(guarded)} of {len(work)} "
        f"requests guarded (top-2 margins of logits + noise > {LOGIT_TOL}) "
        f"and equal at 1 slot ({sum(a[u] == c[u] for u in a)} of "
        f"{len(a)} equal in all); {same} of {PAGED_NEW * len(a)} tokens "
        f"equal phase 4's greedy ones; greedy dense engine (phase 4, same "
        f"call): {dense_stats['tokens_per_s']:.1f} tokens/s")
    return first


# ---------------------------------------------------------------------------
# phase 12: gemma3-4b serving
# ---------------------------------------------------------------------------

GEMMA_SLOTS, GEMMA_MAX_LEN, GEMMA_NEW, GEMMA_REQUESTS = 4, 4096, 16, 8
# phase 12's weights, which phase 13 trains: ``init_state``'s draw with
# ``TrainConfig.seed`` = GEMMA_SEED, drawn once; 12 of the 34 layers (all
# 34 took 154.5 s of drawing on the host), the first 6 of them phases 13
# (b) and 21 (b) take
GEMMA_SEED = 0
GEMMA_LAYERS = 12
# bf16 serving: every step's logits within 3e-2 of the plain row's
# largest magnitude, on the same tokens (both paths round every
# activation to bf16, after f32 attention summed in other orders); bf16
# training: losses within 2e-2 of the plain path's
BF16_LOGIT_TOL, BF16_LOSS_TOL = 3e-2, 2e-2
GEMMA_PROMPTS = (1100, 3968)          # prompt lengths, drawn with seed 0
# (B, G, L, nr, d, keys with w > 0): gemma's local layers (one prompt's
# 4 kv-heads, 2 q heads each, window 1024, head_dim 256) at 4 and 3
# blocks, a 3000-token prompt padded; and one narrow window
STREAM_CASES = ((4, 2, 4096, 1024, 256, 3000), (4, 2, 3072, 1024, 256, 3000),
                (4, 2, 1024, 128, 64, 900))


def causal_pairs(w, nr: int) -> int:
    """(query, key) pairs of one (b, g) plane summed over b that
    ``l0_causal`` admits with w > 0: row i reads the live keys of
    (i // nr - 1) * nr .. i."""
    B, L = w.shape
    cs = torch.cumsum((w > 0).to(torch.int64), dim=1)
    i = torch.arange(L, device=w.device)
    lo = ((i // nr - 1) * nr).clamp(min=0)
    before = torch.where(lo > 0, cs[:, (lo - 1).clamp(min=0)],
                         torch.zeros_like(cs))
    return int((cs - before).sum())


def exact_causal_fwd(q, k, v, w, nr: int):
    """The unnormalised (y, dn, m) of ``l0_causal`` in float64, dense
    over each sequence: the witness both fp32 paths are measured
    against."""
    from repro_torch.kernels import h1d_block as hb
    L = q.shape[-2]
    i = torch.arange(L, device=q.device)
    allow = hb.band_mask(i[:, None], i[None, :], nr, "l0_causal", L)
    out = ([], [], [])
    for b in range(q.shape[0]):
        s = q[b].double() @ k[b].double().T
        s = torch.where((allow & (w[b] > 0)[None])[None], s, -math.inf)
        m = s.amax(-1).clamp(min=-1e30)
        a = torch.exp(s - m[..., None])
        for o, x in zip(out, (a @ v[b].double(), a @ w[b].double(), m)):
            o.append(x)
        del s, a
    return [torch.stack(o) for o in out]


def phase_stream_kernel(dev):
    """#1's streamed ``l0_causal`` body against its plain version at the
    gemma local layers' shapes (``STREAM_CASES``), timed beside the plain
    version and ``scaled_dot_product_attention`` with the same
    block-local mask (normalised z only; the port never calls it).  The
    row's headline numbers are the first case's; ``cases`` lists each."""
    from repro_torch.kernels import h1d_block as hb

    gen = torch.Generator(device=dev).manual_seed(12)
    cases, err = [], 0.0
    for Bs, Gs, Ls, nr, d, live in STREAM_CASES:
        if hb.check_window_fwd("l0_causal", nr, d, d) != "stream":
            raise AssertionError(f"nr={nr}, d={d} is not on the streamed "
                                 f"body")
        q = torch.randn((Bs, Gs, Ls, d), generator=gen, device=dev) / \
            math.sqrt(d)
        k = torch.randn((Bs, Ls, d), generator=gen, device=dev)
        w = torch.ones((Bs, Ls), device=dev)
        w[:, live:] = 0.0
        v = torch.randn((Bs, Ls, d), generator=gen, device=dev) * w[..., None]
        args = (q, k, v, w)
        label = f"band_attention_fwd[l0_causal_stream] L={Ls} nr={nr} d={d}"
        ker = hb.band_attention_fwd(*args, nr=nr)
        ref = hb.band_attention_fwd_ref(*args, nr=nr)
        e, scaled, _ = compare(label, ker, ref, ATTN_TOL)
        err = max(err, e)
        ex = exact_causal_fwd(*args, nr)
        f64 = {"kernel": errors(label, ker, ex)[1],
               "plain": errors(label, ref, ex)[1]}
        del ker, ref, ex
        i = torch.arange(Ls, device=dev)
        allow = hb.band_mask(i[:, None], i[None, :], nr, "l0_causal", Ls)
        mask = (allow[None] & (w > 0)[:, None, :])[:, None]
        kx = k[:, None].expand(Bs, Gs, Ls, d).contiguous()
        vx = v[:, None].expand(Bs, Gs, Ls, d).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        flops = causal_pairs(w, nr) * Gs * (4 * d + 3)
        nbytes = hb.band_bytes(w, nr=nr, mode="l0_causal", G=Gs, d=d, dv=d)
        bms, by = bound(nbytes, flops)
        case = dict(
            B=Bs, G=Gs, L=Ls, nr=nr, d=d, live_keys=live, max_abs_err=e,
            scaled_err=scaled, f64_scaled_err=f64,
            ms=time_ms(lambda: hb.band_attention_fwd(*args, nr=nr)),
            device_ms=device_ms(lambda: hb.band_attention_fwd(*args,
                                                              nr=nr)),
            plain_ms=time_ms(lambda: hb.band_attention_fwd_ref(*args,
                                                               nr=nr)),
            library_ms=time_ms(lambda: sdpa(q, kx, vx, attn_mask=mask,
                                            scale=1.0)),
            bound_ms=bms, bound_by=by, gflop=flops / 1e9)
        cases.append(case)
        log(f"{label}: {json.dumps(case)}")
        del q, k, v, w, args, kx, vx, mask, allow
        torch.cuda.empty_cache()
    head = cases[0]
    return dict(
        name="band_attention_fwd[l0_causal_stream]", mode="l0_causal",
        route="cuda", source="src/repro_torch/kernels/csrc/h1d_block.cu",
        replaces="src/repro/kernels/h1d_block.py:299", max_abs_err=err,
        **{k_: head[k_] for k_ in ("ms", "device_ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        cases=cases,
        note="streamed body (band_stream_kernel: 64-row tiles, 64-key "
             "tiles, 4 x 4 score and 8 x 8 y register tiles, the longest "
             "windows first); headline: 4 x 2 x 4096, "
             "nr 1024, d 256, keys live to 3000; library_ms: "
             "scaled_dot_product_attention with the same boolean mask "
             "(normalised z), timed here only")


def bf16_prompts(vocab: int, lo: int, hi: int, n: int):
    """``n`` seeded (seed 0) prompts of lengths in [lo, hi]."""
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, size=n)
    return [(i, rng.integers(0, vocab, size=int(m)).astype(np.int32))
            for i, m in enumerate(lens)]


def teacher_forced(eng, logits, tokens=None):
    """Record every logits row ``eng`` takes a token from (fp32, one row
    a step: the prefill's last position, then each decode tick's) under
    its request's uid in ``logits``; with ``tokens`` (lists by uid), make
    the engine take ``tokens[uid][i]`` as the request's i-th token in
    place of its own argmax, so that engines handed the same tokens
    decode the same contexts."""
    sample = eng._sample

    def forced(z, rows, reqs, tick):
        out = sample(z, rows, reqs, tick)
        for i, r in enumerate(reqs):
            if r is not None:
                seen = logits.setdefault(r.uid, [])
                if tokens is not None:
                    out[i] = tokens[r.uid][len(seen)]
                seen.append(z[i].float().clone())
        return out
    eng._sample = forced
    return eng


def plain_engine_run(cfg, params, work, slots, max_len, new_tokens,
                     **engine_kw):
    """The requests ``work`` through an engine on the plain versions,
    greedy: (tokens by uid, every step's logits by uid)."""
    from repro_torch.serve import Request, ServeEngine
    logits = {}
    eng = teacher_forced(ServeEngine(cfg, params, slots=slots,
                                     max_len=max_len, **engine_kw), logits)
    rs = [Request(uid=u, prompt=p, max_new_tokens=new_tokens)
          for u, p in work]
    for r in rs:
        eng.submit(r)
    with plain_kernels():
        eng.run()
    return {r.uid: list(r.out_tokens) for r in rs}, logits


def logits_vs_plain(label, got, want):
    """Every step's logits of every request, kernel path (``got``, taken
    by :func:`teacher_forced` on the plain run's tokens, so the contexts
    are the plain run's) against the plain run's (``want``): finite, of
    the plain rows' width, within BF16_LOGIT_TOL of the plain row's
    largest |logit|.  Step 0 is the prefill's last position, the others
    decode ticks on the caches.  Returns (worst scaled error at step 0,
    worst at the decode steps, steps compared, steps whose argmax is the
    plain run's token)."""
    worst, n, same = [0.0, 0.0], 0, 0
    for u, ref in want.items():
        if len(got.get(u, ())) != len(ref):
            raise AssertionError(f"{label}: request {u} took "
                                 f"{len(got.get(u, ()))} steps, the plain "
                                 f"run {len(ref)}")
        for i, (a, b) in enumerate(zip(got[u], ref)):
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise AssertionError(f"{label}: request {u} step {i}: bad "
                                     f"logits")
            e = float((a - b).abs().max() / b.abs().max())
            if e > BF16_LOGIT_TOL:
                raise AssertionError(f"{label}: request {u} step {i}: "
                                     f"logits differ by {e:.3g} of max "
                                     f"|plain| > {BF16_LOGIT_TOL}")
            worst[i > 0] = max(worst[i > 0], e)
            n += 1
            same += int(a.argmax() == b.argmax())
    return worst[0], worst[1], n, same


def forced_run(label, eng, work, fns, tokens, plain_logits):
    """``run_engine`` of ``eng`` on ``work`` with every request handed
    the plain run's ``tokens`` (:func:`teacher_forced`), its logits held
    to the plain run's at every step (:func:`logits_vs_plain`).  Returns
    (stats, launches)."""
    logits = {}
    teacher_forced(eng, logits, tokens)
    _, stats, counts = run_engine(eng, work, fns, new_tokens=GEMMA_NEW)
    pre, dec, n, same = logits_vs_plain(label, logits, plain_logits)
    log(f"{label}: logits with the plain run's tokens within {pre:.3g} "
        f"(prefill) and {dec:.3g} (decode) of max |plain| (<= "
        f"{BF16_LOGIT_TOL}) at all {n} steps; argmax the plain token at "
        f"{same}")
    return stats, counts


def phase_gemma(dev):
    """12. ``gemma3-4b`` at full width in its published bf16, cut to
    GEMMA_LAYERS of its 34 layers (10 local at window 1024, 2 global
    h1d; random weights from seed GEMMA_SEED, the first 12 layers of the
    34-layer draw): ``ServeEngine(slots=4, max_len=4096)`` on 8
    greedy requests of 16 tokens, prompt lengths 1100..3968 (seed 0).
    The streamed #1 (local layers), #1 and #2 (global prefill), #5 and #6
    on bf16 caches (global decode) must launch and no plain version run;
    then the same requests on the plain versions, and again on the
    kernels with the plain run's tokens, every step's logits held to the
    plain run's (``forced_run``).  Returns (the serving run's launches,
    the weights), the weights for phase 13 to train."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    cfg = get_config("gemma3-4b")
    if cfg.dtype != "bfloat16":
        raise AssertionError("gemma3-4b is published in bfloat16")
    cfg = dataclasses.replace(cfg, num_layers=GEMMA_LAYERS)
    fns = get_model(cfg)
    params = fns.init(cfg, seed=GEMMA_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    work = bf16_prompts(cfg.vocab_size, *GEMMA_PROMPTS, GEMMA_REQUESTS)
    eng = ServeEngine(cfg, params, slots=GEMMA_SLOTS, max_len=GEMMA_MAX_LEN)
    if eng._bucket_len(GEMMA_PROMPTS[0]) != GEMMA_PROMPTS[0]:
        raise AssertionError("gemma engine buckets its prompts")
    torch.cuda.reset_peak_memory_stats()
    outs, stats, counts = run_engine(eng, work, fns, new_tokens=GEMMA_NEW)
    stats.update(dtype=cfg.dtype, weights_s=init_s,
                 prompt_lens=[len(p) for _, p in work],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    need = ("band_attention_fwd[l0_causal_stream]",
            "band_attention_fwd[l0_causal]", "band_attention_sub_fwd",
            "decode_attend_fused[bf16]", "update_cache_fused[bf16]")
    missing = [k for k in need if not counts.get(k)]
    if missing:
        raise AssertionError(f"gemma: {missing} not launched: {counts}")
    del eng
    log(f"gemma serve: {json.dumps(stats)}")
    plain, plain_logits = plain_engine_run(cfg, params, work, GEMMA_SLOTS,
                                           GEMMA_MAX_LEN, GEMMA_NEW)
    same = sum(x == y for u in plain for x, y in zip(outs[u], plain[u]))
    forced_run("gemma", ServeEngine(cfg, params, slots=GEMMA_SLOTS,
                                    max_len=GEMMA_MAX_LEN),
               work, fns, plain, plain_logits)
    log(f"gemma: {same} of {GEMMA_NEW * len(work)} greedy tokens equal to "
        f"the plain run's; phase 12 took {time.perf_counter() - t0:.1f}s, "
        f"weights {init_s:.1f}s")
    del plain_logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts, params


# ---------------------------------------------------------------------------
# phase 13: gemma3-4b training
# ---------------------------------------------------------------------------

GEMMA_TRAIN_LAYERS, GEMMA_TRAIN_STEPS = 6, 3
GEMMA_TRAIN_BATCH, GEMMA_TRAIN_SEQ = 1, 4096
# the remat gradient against the one that keeps every activation: the
# same kernels on the same inputs (the recompute gives the forward's
# bits); what may differ is the order of the embedding's scatter-add
REMAT_TOL = 1e-6


def phase_stream_bwd_kernel(dev):
    """#3's streamed ``l0_causal`` backward against its plain version at
    the first of ``STREAM_CASES`` (the gemma local layers' prefill shape),
    from the streamed forward's outputs and seeded random cotangents on
    y, dn and m; two calls give identical bits.  Timed beside the plain
    version and the backward of ``scaled_dot_product_attention`` under
    the same boolean mask (its q, k, v gradients of the normalised z;
    the port never calls it)."""
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_block_bwd as hbb

    Bs, Gs, Ls, nr, d, live = STREAM_CASES[0]
    if hb.check_window_bwd("l0_causal", nr, d, d) != "stream":
        raise AssertionError(f"nr={nr}, d={d} is not on the streamed "
                             f"backward")
    gen = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((Bs, Gs, Ls, d), generator=gen, device=dev) / \
        math.sqrt(d)
    k = torch.randn((Bs, Ls, d), generator=gen, device=dev)
    w = torch.ones((Bs, Ls), device=dev)
    w[:, live:] = 0.0
    v = torch.randn((Bs, Ls, d), generator=gen, device=dev) * w[..., None]
    out = hb.band_attention_fwd(q, k, v, w, nr=nr)
    cot = [torch.randn(t.shape, generator=gen, device=dev) for t in out]
    args = (q, k, v, w, *out, *cot)
    label = f"band_attention_bwd[l0_causal_stream] L={Ls} nr={nr} d={d}"
    got = hbb.band_attention_bwd(*args, nr=nr)
    want = hbb.band_attention_bwd_ref(*args, nr=nr)
    err, scaled, elem = compare(label, got, want, GRAD_TOL,
                                ("row", "row", "row"))
    for a, b in zip(got, hbb.band_attention_bwd(*args, nr=nr)):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: two calls differ")
    del got, want
    # an admitted pair: s (2d), da (2dv), dq and dk (2d each), dv (2dv)
    flops = causal_pairs(w, nr) * Gs * 2 * (3 * d + 2 * d)
    nbytes = hb.band_bytes(w, nr=nr, mode="l0_causal", G=Gs, d=d, dv=d,
                           backward=True)
    bms, by = bound(nbytes, flops)
    i = torch.arange(Ls, device=dev)
    allow = hb.band_mask(i[:, None], i[None, :], nr, "l0_causal", Ls)
    mask = (allow[None] & (w > 0)[:, None, :])[:, None]
    xs = [q.clone().requires_grad_(True),
          k[:, None].expand(Bs, Gs, Ls, d).contiguous().requires_grad_(True),
          v[:, None].expand(Bs, Gs, Ls, d).contiguous().requires_grad_(True)]
    z = torch.nn.functional.scaled_dot_product_attention(
        *xs, attn_mask=mask, scale=1.0)
    gz = torch.randn(z.shape, generator=gen, device=dev)
    row = dict(
        name="band_attention_bwd[l0_causal_stream]", mode="l0_causal",
        route="cuda", source="src/repro_torch/kernels/csrc/h1d_block_bwd.cu",
        replaces="src/repro/kernels/h1d_block_bwd.py:541", max_abs_err=err,
        max_scaled_err=scaled, max_elementwise_scaled_err=elem,
        ms=time_ms(lambda: hbb.band_attention_bwd(*args, nr=nr)),
        device_ms=device_ms(lambda: hbb.band_attention_bwd(*args, nr=nr)),
        plain_ms=time_ms(lambda: hbb.band_attention_bwd_ref(*args, nr=nr)),
        library_ms=time_ms(lambda: torch.autograd.grad(
            z, xs, gz, retain_graph=True)),
        bound_ms=bms, bound_by=by, gflop=flops / 1e9,
        note=f"streamed backward (stream_dq_kernel: one sweep, tie lists "
             f"of {hb.STREAM_TIES} keys a row; then stream_dkvw_kernel: "
             f"{hb.STREAM_KV_TK} keys against {hb.STREAM_KV_TR}-row "
             f"chunks; one launch is one wrapper call of the "
             f"two); {Bs} x {Gs} x {Ls}, nr {nr}, d {d}, keys live to "
             f"{live}; cotangents random on y, dn and m; two calls the "
             f"same bits; library_ms: the backward of "
             f"scaled_dot_product_attention with the same boolean mask "
             f"(normalised z), timed here only")
    log(f"{label}: {json.dumps(row)}")
    del args, out, cot, xs, z, gz, mask, allow
    torch.cuda.empty_cache()
    return row


def train_expected(cfg, steps: int, seq: int):
    """The launches of ``steps`` rematerialised training steps at sequence
    length ``seq``: every band forward of a layer twice (the forward,
    then the recompute in the backward), its backward once; local layers
    on the streamed bodies, global ones on #1 ``l0_causal`` and #2 at
    every sub level, #3 and #4 in the backward.  An ssm stack launches
    none; a hybrid's shared block runs outside the remat, so each of its
    invocations runs its band forwards once and its backwards once."""
    from repro_torch.core import hierarchy as hc
    subs = hc.num_levels(hc.padded_length(seq, cfg.nr), cfg.nr) - 1
    if cfg.family in ("ssm", "hybrid"):
        inv = (sum(cfg.layer_is_attn(i) for i in range(cfg.num_layers))
               if cfg.family == "hybrid" else 0)
        per_step = {"band_attention_fwd[l0_causal]": inv,
                    "band_attention_bwd[l0_causal]": inv,
                    "band_attention_sub_fwd": inv * subs,
                    "band_attention_sub_bwd": inv * subs}
        return {k_: n * steps for k_, n in per_step.items() if n}
    local = sum(not cfg.layer_uses_global_attn(i)
                for i in range(cfg.num_layers))
    glob = cfg.num_layers - local
    per_step = {"band_attention_fwd[l0_causal_stream]": 2 * local,
                "band_attention_bwd[l0_causal_stream]": local,
                "band_attention_fwd[l0_causal]": 2 * glob,
                "band_attention_bwd[l0_causal]": glob,
                "band_attention_sub_fwd": 2 * glob * subs,
                "band_attention_sub_bwd": glob * subs}
    return {k_: n * steps for k_, n in per_step.items() if n}


def bf16_checks(label, cfg, params, batch, grad_ctx=None, bit_exact=False,
                plain_grads=True):
    """The checks of a bf16 configuration with remat (policy ``dots``) on
    ``params`` (left as they are) and one batch: (a) its loss on the
    kernel path within BF16_LOSS_TOL of the plain path's; (b) the
    gradient with ``remat_policy='none'`` within REMAT_TOL of each leaf's
    largest |remat gradient| (the same kernels on the same inputs), remat
    with the lower peak; then the ``lm_loss`` gradient of the weights
    widened to fp32 on the batch's first sequence, kernel path against
    plain path as in 7 (the band kernels run fp32 in either dtype, and
    fp32 holds them, forward and backward, to GRAD_TOL; ``grad_ctx``,
    where given, holds the ``run`` and ``ref`` contexts of that
    comparison, :func:`grads_against_plain`'s).  With ``bit_exact`` the
    two gradients of (b) must be equal bit for bit; ``plain_grads=False``
    leaves out the fp32 comparison (a model without attention launches no
    kernel, so its plain path is its kernel path).  Returns (the kernel
    loss, the plain loss, the gradient peaks above the weights by remat
    policy)."""
    from repro_torch.models import get_model
    from repro_torch.tree import (tree_flatten_with_paths, tree_leaves,
                                  tree_map, tree_unflatten_like)

    if not (cfg.dtype == "bfloat16" and cfg.remat
            and cfg.remat_policy == "dots"):
        raise AssertionError(f"{label}: trains in bf16 with remat, dots")
    fns = get_model(cfg)

    # (a) the first batch's loss, kernel path against plain path
    with torch.no_grad():
        loss_k = float(fns.loss(params, cfg, batch)[0])
        with plain_kernels():
            loss_p = float(fns.loss(params, cfg, batch)[0])
    if not abs(loss_k - loss_p) <= BF16_LOSS_TOL:
        raise AssertionError(f"{label}: loss {loss_k} on the kernels, "
                             f"{loss_p} on the plain path")

    # (b) remat against keeping every activation, with each one's peak
    def grads(c):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        loss = fns.loss(tree_unflatten_like(params, leaves), c, batch)[0]
        g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return g, (torch.cuda.max_memory_allocated() - start) / 2 ** 30
    g_remat, peak_remat = grads(cfg)
    g_none, peak_none = grads(dataclasses.replace(cfg, remat_policy="none"))
    worst, equal = 0.0, 0
    for (path, _), a, b in zip(tree_flatten_with_paths(params), g_none,
                               g_remat):
        _, e, _ = compare(f"{label} remat grad {path}", [a], [b], REMAT_TOL,
                          ("tensor",))
        worst = max(worst, e)
        equal += int(torch.equal(a, b))
    nleaves = len(g_remat)
    del g_remat, g_none
    if bit_exact and equal != nleaves:
        raise AssertionError(f"{label}: {nleaves - equal} of {nleaves} "
                             f"gradient leaves differ between remat and "
                             f"none")
    if not peak_remat < peak_none:
        raise AssertionError(f"{label}: remat peaks at {peak_remat:.2f} GiB "
                             f"above the weights, no lower than "
                             f"{peak_none:.2f} without it")
    log(f"{label}: first-batch loss {loss_k:.6f} on the kernels, "
        f"{loss_p:.6f} plain (<= {BF16_LOSS_TOL}); gradient with "
        f"remat_policy='none' within {worst:.3g} (<= {REMAT_TOL:g}) of each "
        f"leaf's largest |remat gradient|, {equal} of {nleaves} leaves bit "
        f"for bit; peak above the weights {peak_remat:.2f} GiB with remat "
        f"(dots), {peak_none:.2f} GiB without")

    if not plain_grads:
        gc.collect()
        torch.cuda.empty_cache()
        return loss_k, loss_p, dict(remat=peak_remat, none=peak_none)
    # the fp32 gradient, kernel path against plain path (after (b): run
    # before it, its leftovers left (b) out of memory)
    f32 = dataclasses.replace(cfg, dtype="float32")
    wide = tree_map(lambda p: p.float(), params)
    first = {k_: v[:1] for k_, v in batch.items()}
    grads_against_plain(f"{label} (fp32)", wide,
                        lambda p: fns.loss(p, f32, first)[0],
                        **(grad_ctx or {}))
    del wide, first
    gc.collect()
    torch.cuda.empty_cache()
    return loss_k, loss_p, dict(remat=peak_remat, none=peak_none)


def bf16_steps(label, cfg, tc, state, data, steps, first_loss, falls,
               **stats):
    """``steps`` AdamW steps through ``train`` from ``state``, which they
    consume (the in-place update writes its tensors): every loss finite,
    the first within BF16_LOSS_TOL of
    ``first_loss`` (the kernel path's loss of the first batch), the last
    below the first where ``falls``, every weight in its dtype still
    (bf16; a MoE router f32); each band
    path launched exactly as often as the steps run it, no plain version;
    peak memory below the card's.  Returns (launches, stats)."""
    from repro_torch.train import tokens_per_s, train
    from repro_torch.tree import tree_leaves

    batch_size, seq = data.batch_per_host, data.seq_len
    dev = state.params["embed"]["w"].device
    counts = {}
    before = [p.dtype for p in tree_leaves(state.params)]
    with counted(counts):
        state, metrics = train(cfg, tc, data, steps, state=state,
                               device=dev, log=log)
    kept = before == [p.dtype for p in tree_leaves(state.params)]
    del state
    need_counts(label, counts, train_expected(cfg, steps, seq))
    hist = metrics["history"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if abs(losses[0] - first_loss) > BF16_LOSS_TOL:
        raise AssertionError(f"{label}: first step's loss {losses[0]} is "
                             f"not the first batch's {first_loss}")
    if falls and not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss does not fall: {losses}")
    if not (kept and torch.bfloat16 in before):
        raise AssertionError(f"{label}: the weights left their dtypes "
                             f"(bf16, a MoE router f32)")
    capacity = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    if not metrics["peak_mem_gib"] < capacity:
        raise AssertionError(f"{label}: peak {metrics['peak_mem_gib']:.2f} "
                             f"GiB, the card holds {capacity:.2f}")
    tokens = batch_size * seq
    stats = dict(layers=cfg.num_layers, dtype=cfg.dtype, batch=batch_size,
                 seq=seq, steps=steps, remat_policy=cfg.remat_policy,
                 losses=losses, aux=[h["aux"] for h in hist],
                 first_step_ms=hist[0]["step_ms"],
                 median_step_ms=float(np.median([h["step_ms"]
                                                 for h in hist[1:]])),
                 tokens_per_s=tokens_per_s(hist, tokens),
                 peak_mem_gib=metrics["peak_mem_gib"],
                 card_gib=capacity, **stats,
                 launches={k_: counts.get(k_, 0) for k_ in
                           train_expected(cfg, 1, seq)})
    log(f"{label}: {json.dumps(stats)}")
    torch.cuda.empty_cache()
    return counts, stats


def bf16_training(label, cfg, batch_size, seq, steps, tc_kw, falls, dev):
    """A bf16 configuration with remat (policy ``dots``) from seed-0
    weights (one ``init_state``, drawn once) on ``ZipfLM(seed=0)``
    batches of ``batch_size`` x ``seq``: :func:`bf16_checks` on the first
    batch, then :func:`bf16_steps` from that state.  Returns (launches,
    stats)."""
    import tempfile
    from repro_torch.data import ZipfLM
    from repro_torch.train import TrainConfig, batch_to_device, init_state

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    tc = TrainConfig(ckpt_every=0, ckpt_dir=tmp.name, log_every=1, seed=0,
                     **tc_kw)
    state = init_state(cfg, tc, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=seq,
                  batch_per_host=batch_size, seed=0)
    batch = batch_to_device(data.batch(0), dev)
    loss_k, loss_p, peaks = bf16_checks(label, cfg, state.params, batch)
    with tmp:
        counts, stats = bf16_steps(
            label, cfg, tc, state, data, steps, loss_k, falls,
            first_loss_plain=loss_p, grad_peak_above_weights_gib=peaks,
            weights_s=init_s)
    log(f"{label}: took {time.perf_counter() - t0:.1f}s")
    return counts, stats


def update_in_place_check(params, layers: int):
    """The in-place AdamW update against the functional one, bit for bit,
    on the card: 3 steps of both on clones of a ``layers``-layer tree of
    ``params`` (the 262144 x 2560 embedding in row chunks) with seeded
    bf16 gradients whose global norm the clip cuts."""
    from repro_torch import optim
    from repro_torch.tree import tree_leaves, tree_map

    tree = {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": params["layers"][:layers]}
    p_in = tree_map(lambda t: t.clone(), tree)
    p_fn = tree_map(lambda t: t.clone(), tree)
    opt = optim.adamw(optim.cosine_schedule(3e-4, 1, 10), weight_decay=0.1,
                      clip_norm=1.0)
    s_in, s_fn = opt.init(p_in), opt.init(p_fn)
    gen = torch.Generator(device=tree["embed"]["w"].device).manual_seed(13)
    for _ in range(3):
        g = tree_map(lambda t: (torch.randn(t.shape, generator=gen,
                                            device=t.device) * 1e-3
                                ).to(t.dtype), tree)
        upd, s_fn = opt.update(tree_map(lambda t: t.clone(), g), s_fn, p_fn)
        p_fn = optim.apply_updates(p_fn, upd)
        del upd
        s_in = opt.update_(g, s_in, p_in)
        del g
    same = [torch.equal(a, b) for a, b in zip(tree_leaves((p_in, s_in)),
                                              tree_leaves((p_fn, s_fn)))]
    n = sum(t.numel() for t in tree_leaves(p_in))
    del p_in, p_fn, s_in, s_fn
    torch.cuda.empty_cache()
    if not all(same):
        raise AssertionError(f"in-place AdamW: {same.count(False)} of "
                             f"{len(same)} leaves differ from the "
                             f"functional update")
    chunks = importlib.import_module("repro_torch.optim.adamw")._row_chunks(
        tree["embed"]["w"])
    log(f"in-place AdamW: {len(same)} leaves (parameters, moments) of a "
        f"{layers}-layer gemma3-4b tree ({n} parameters, the embedding in "
        f"{len(chunks)} row chunks) equal to the functional update bit for "
        f"bit over 3 steps")


def phase_gemma_train(dev, box):
    """13 (b). ``gemma3-4b`` in its published bf16 with remat (policy
    ``dots``) on phase 12's weights (popped from ``box``; phase 12 drew
    them from seed 0, as ``init_state`` would with ``TrainConfig.seed``
    0): :func:`bf16_checks` on its first 6 layers (5 local, 1 global: a
    view of the same tensors), the in-place AdamW update against the
    functional one on a 2-layer tree, then 3 AdamW steps at its
    GEMMA_LAYERS layers through ``train`` (the in-place update).  Returns
    the training run's launches."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import ZipfLM
    from repro_torch.models import get_model
    from repro_torch.train import (TrainConfig, TrainState, batch_to_device,
                                   make_optimizer)

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("gemma3-4b"),
                              num_layers=GEMMA_LAYERS)
    params = box.pop()
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=GEMMA_TRAIN_SEQ,
                  batch_per_host=GEMMA_TRAIN_BATCH, seed=0)
    batch = batch_to_device(data.batch(0), dev)
    six = dataclasses.replace(cfg, num_layers=GEMMA_TRAIN_LAYERS)
    view = {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": params["layers"][:GEMMA_TRAIN_LAYERS]}
    loss6_k, loss6_p, peaks = bf16_checks(
        f"gemma train ({GEMMA_TRAIN_LAYERS} layers)", six, view, batch)
    del view
    update_in_place_check(params, 2)

    tmp = tempfile.TemporaryDirectory()
    tc = TrainConfig(ckpt_every=0, ckpt_dir=tmp.name, log_every=1,
                     seed=GEMMA_SEED, peak_lr=3e-4, warmup=5)
    with torch.no_grad():
        loss_k = float(get_model(cfg).loss(params, cfg, batch)[0])
    torch.cuda.synchronize()
    t_init = time.perf_counter()
    state = TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                       params, make_optimizer(tc).init(params), None)
    del params
    with tmp:
        counts, _ = bf16_steps(
            "gemma train", cfg, tc, state, data, GEMMA_TRAIN_STEPS, loss_k,
            False, first_loss_6_layers=dict(kernel=loss6_k, plain=loss6_p),
            grad_peak_above_weights_gib_6_layers=peaks,
            moments_init_s=time.perf_counter() - t_init)
    log(f"phase 13 (b) took {time.perf_counter() - t0:.1f}s")
    return counts


# ---------------------------------------------------------------------------
# phases 14-15: dense bf16 serving (yi-6b, qwen2.5-14b) and llama3.2-1b
# training
# ---------------------------------------------------------------------------

# (arch, layers): yi-6b cut to 2 of its 32 layers and qwen2.5-14b to 1
# of its 48: the card's host draws ~30 M parameters a second
# (``lm_init``, one CPU generator), so yi's 6.06 B took 204 s; since phase
# 17 joined the smoke their draws are cut (16 and 8 layers took 100 and
# 108 s; 4 and 2 until phase 18 joined) so that the whole stays near its
# earlier time; the kernels' shapes, and so every check, do not depend on
# the depth; both run at full depth through ``launch.serve`` outside the
# smoke
DENSE_BF16 = (("yi-6b", 2), ("qwen2.5-14b", 1))
DENSE_PROMPTS, DENSE_REQUESTS = (1000, 3900), 8
LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ, LLAMA_TRAIN_STEPS = 2, 4096, 3


def phase_dense_bf16(dev):
    """14. ``yi-6b`` and ``qwen2.5-14b`` at full width (2 and 1 layers,
    ``DENSE_BF16``) in their published bf16 from seeded weights:
    ``ServeEngine(slots=4, max_len=4096)`` on 8 greedy requests of 16
    tokens, prompt lengths 1000..3900 (seed 0): #1 and #2 (h1d prefill at
    G 8 and G 5, head_dim 128), #5 and #6 on bf16 caches launched, no
    plain version; then the plain run and the kernels on its tokens,
    every step's logits held to it (``forced_run``).  yi-6b's requests
    also through a paged engine (#7, #9 on bf16 pools) and a 2-way SP
    engine (#11, #12 on bf16 slabs; at max_len 4096 every level is
    sharded, so no #6), each on the plain run's tokens and held to its
    logits the same way; and (25 (b)) through a paged int8 engine at
    ``quant_levels=1`` (level 0 int8, the rest bf16: #8 and #10 on bf16
    levels), held to a plain run of the same int8 pool (quantization
    moves the logits off the dense run's).  Returns the launches of every
    serving run."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_leaves

    total = {}

    def add(counts):
        for k_, n in counts.items():
            total[k_] = total.get(k_, 0) + n

    for arch, layers in DENSE_BF16:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        fns = get_model(cfg)
        params = fns.init(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        nparam = sum(p.numel() for p in tree_leaves(params))
        work = bf16_prompts(cfg.vocab_size, *DENSE_PROMPTS, DENSE_REQUESTS)
        eng = ServeEngine(cfg, params, slots=GEMMA_SLOTS,
                          max_len=GEMMA_MAX_LEN)
        torch.cuda.reset_peak_memory_stats()
        outs, stats, counts = run_engine(eng, work, fns, new_tokens=GEMMA_NEW)
        stats.update(arch=arch, layers=cfg.num_layers, dtype=cfg.dtype,
                     params=nparam, weights_s=init_s,
                     prompt_lens=[len(p) for _, p in work],
                     peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        need = ("band_attention_fwd[l0_causal]", "band_attention_sub_fwd",
                "decode_attend_fused[bf16]", "update_cache_fused[bf16]")
        missing = [k_ for k_ in need if not counts.get(k_)]
        if missing:
            raise AssertionError(f"{arch}: {missing} not launched: {counts}")
        add(counts)
        del eng
        log(f"{arch} serve: {json.dumps(stats)}")
        plain, plain_logits = plain_engine_run(
            cfg, params, work, GEMMA_SLOTS, GEMMA_MAX_LEN, GEMMA_NEW)
        same = sum(x == y for u in plain for x, y in zip(outs[u], plain[u]))
        log(f"{arch}: {same} of {GEMMA_NEW * len(work)} greedy tokens equal "
            f"to the plain run's")
        runs = [("dense", {}, ())]
        if arch == "yi-6b":
            runs += [("paged", dict(paged=True),
                      ("decode_attend_paged[bf16]",
                       "update_cache_paged[bf16]")),
                     ("sp d=2", dict(mesh=make_mesh((2,), ("data",),
                                                    device=dev)),
                      ("decode_attend_partial[bf16]",
                       "update_cache_partial[bf16]"))]
        for kind, kw, need in runs:
            eng = ServeEngine(cfg, params, slots=GEMMA_SLOTS,
                              max_len=GEMMA_MAX_LEN, **kw)
            st, c = forced_run(f"{arch} {kind}", eng, work, fns, plain,
                               plain_logits)
            missing = [k_ for k_ in need if not c.get(k_)]
            if missing:
                raise AssertionError(f"{arch} {kind}: {missing} not "
                                     f"launched: {c}")
            if kind != "dense":     # its launches: the run above
                add(c)
                log(f"{arch} {kind}: tokens/s {st['tokens_per_s']:.1f}, "
                    f"decode ms a tick {st['decode_ms_per_tick']:.2f}, "
                    f"prefill ms a call {st['prefill_ms_per_call']:.1f}")
            del eng
        if arch == "yi-6b":
            add(int8_bf16_run(cfg, params, fns, work))
        log(f"{arch}: phase 14 part took {time.perf_counter() - t0:.1f}s, "
            f"weights {init_s:.1f}s")
        del params, plain_logits
        torch.cuda.empty_cache()
    return total


def int8_bf16_run(cfg, params, fns, work):
    """25 (b): ``work`` through ``ServeEngine(paged=True,
    cache_dtype="int8", quant_levels=1)`` on bf16 weights, on a plain run
    of the same pool's tokens, its logits held to that run's
    (``forced_run``): #8 and #10 launched on bf16 levels, no plain
    version.  Returns the kernel run's launches."""
    from repro_torch.serve import ServeEngine
    kw = dict(paged=True, cache_dtype="int8", quant_levels=1)
    plain, plain_logits = plain_engine_run(
        cfg, params, work, GEMMA_SLOTS, GEMMA_MAX_LEN, GEMMA_NEW, **kw)
    eng = ServeEngine(cfg, params, slots=GEMMA_SLOTS, max_len=GEMMA_MAX_LEN,
                      **kw)
    levels = [str(a.dtype) for a in (eng.caches[0].k, *eng.caches[0].ck)]
    if levels[0] != "torch.int8" or set(levels[1:]) != {"torch.bfloat16"}:
        raise AssertionError(f"25 (b): pool levels {levels}")
    st, c = forced_run(f"25 (b) {cfg.name} paged int8, quant_levels 1", eng,
                       work, fns, plain, plain_logits)
    need = ("decode_attend_paged_quant[bf16]", "update_cache_paged_quant[bf16]")
    missing = [k_ for k_ in need if not c.get(k_)]
    if missing:
        raise AssertionError(f"25 (b): {missing} not launched: {c}")
    log(f"25 (b) {cfg.name} paged int8 (level 0 int8, {len(levels) - 1} bf16 "
        f"levels): tokens/s {st['tokens_per_s']:.1f}, decode ms a tick "
        f"{st['decode_ms_per_tick']:.2f}, prefill ms a call "
        f"{st['prefill_ms_per_call']:.1f}; launches "
        f"{json.dumps({k_: c[k_] for k_ in need})} ({card_line()})")
    return c


def phase_llama_train(dev):
    """15. ``llama3.2-1b`` at full width and depth in its published bf16
    (16 layers, tied embeddings, remat policy ``dots``): ``bf16_training``
    at 2 x 4096 (its gradient held to the plain path's at G 4, d 64, L
    4096 on the weights widened to fp32), 3 AdamW steps (peak 1e-3, one
    warm-up step at rate 0, so the third loss is taken after one update),
    the loss falling.  Returns the training run's launches."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b")
    counts, _ = bf16_training(
        "llama train", cfg, LLAMA_TRAIN_BATCH, LLAMA_TRAIN_SEQ,
        LLAMA_TRAIN_STEPS, dict(peak_lr=1e-3, warmup=1), True, dev)
    return counts


# ---------------------------------------------------------------------------
# phase 16: full attention (the paper's baseline) and the dense oracles
# ---------------------------------------------------------------------------

# the operator against its dense reconstruction: B, G, L, d (nr = NR), at
# the reference's own tolerance for it (tests/test_h1d_attention.py)
ORACLE_B, ORACLE_G, ORACLE_L, ORACLE_D = 2, 4, 1024, 64
ORACLE_ATOL, ORACLE_RTOL = 2e-5, 1e-4
FULL_NEW, FULL_TRAIN_STEPS = 32, 3
# benchmarks/bench_lra_listops.py's "local" encoder: full attention in a
# 16-token window on every layer
LOCAL_WINDOW = 16
# benchmarks/bench_scaling.py: B 1, G 1, d 32, nr 16, causal fine-q
SCALING_D = 32
SCALING_LS = (256, 512, 1024, 2048, 4096, 8192, 16384)


def oracle_close(label, got, want):
    """|got - want| <= ORACLE_ATOL + ORACLE_RTOL * |want| everywhere;
    returns the largest |got - want| and the largest share of the
    bound."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad output {tuple(got.shape)}")
    diff = (got.double() - want.double()).abs()
    share = float((diff / (ORACLE_ATOL + ORACLE_RTOL
                           * want.double().abs())).max())
    if share > 1.0:
        raise AssertionError(f"{label}: {float(diff.max()):.3g} off the "
                             f"dense oracle, {share:.3g}x the bound")
    return float(diff.max()), share


def phase_oracles(dev):
    """16 (a).  ``h1d_dense_oracle`` against ``h1d_attention`` on the
    kernel path (B 2, G 4, L 1024, d 64, nr 16, seeded key weights with
    zeros) in fine-q, coarse-q and bidirectional mode, each mode's band
    kernels launched and no plain version run; then
    ``band_attention_ref`` against #1 in every mode and #2 at every sub
    level at phase 2's shapes (the LM's for ``l0_causal`` and ``sub``,
    the LRA path's for the bidirectional and coarse modes), within
    ATTN_TOL * max(1, |oracle|).  Comparisons only: no launch here counts
    on a path."""
    from repro_torch.core import h1d_attention, h1d_dense_oracle
    from repro_torch.core import hierarchy as hc
    from repro_torch.kernels import band_attention_ref
    from repro_torch.kernels import h1d_block as hb

    gen = torch.Generator(device=dev).manual_seed(16)
    Bo, Go, Lo, Do = ORACLE_B, ORACLE_G, ORACLE_L, ORACLE_D
    q = torch.randn((Bo, Go, Lo, Do), generator=gen, device=dev)
    k = torch.randn((Bo, Lo, Do), generator=gen, device=dev)
    v = torch.randn((Bo, Lo, Do), generator=gen, device=dev)
    w = torch.rand((Bo, Lo), generator=gen, device=dev) + 0.5
    w[0, Lo - 300:] = 0.0
    w[1, torch.randint(0, Lo, (Lo // 8,), generator=gen, device=dev)] = 0.0
    modes = {"fine-q": (True, ("band_attention_fwd[l0_causal]",
                               "band_attention_sub_fwd")),
             "coarse-q": (True, ("band_attention_fwd[l0_causal]",
                                 "band_attention_fwd[coarse_causal]")),
             "bidirectional": (False, ("band_attention_fwd[l0_bidir]",
                                       "band_attention_fwd[coarse_bidir]"))}
    for name, (causal, need) in modes.items():
        mode = "coarse-q" if name == "coarse-q" else "fine-q"
        counts = {}
        with torch.inference_mode(), counted(counts):
            got = h1d_attention(q, k, v, nr=NR, causal=causal,
                                causal_mode=mode, kv_weight=w)
        missing = [n for n in need if not counts.get(n)]
        if missing:
            raise AssertionError(f"oracle {name}: {missing} not launched")
        need_counts(f"oracle {name}", counts, {})
        want = h1d_dense_oracle(q, k, v, nr=NR, causal=causal,
                                causal_mode=mode, kv_weight=w)
        err, share = oracle_close(f"h1d_attention {name}", got, want)
        log(f"oracle: h1d_attention {name} on the kernels within {err:.3g} "
            f"of h1d_dense_oracle ({share:.3g} of atol {ORACLE_ATOL:g} + "
            f"rtol {ORACLE_RTOL:g} |oracle|)")

    # the band kernels against the dense band oracle, every mode
    cases = []
    _, _, q, k, v, w = band_inputs(dev)
    cases.append(("l0_causal", 0, 1, (q, k, v, w)))
    kc, vc, wc = k, v, w
    for lvl in range(1, hc.num_levels(L, NR)):
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc, axis=-2)
        wc = hc.coarsen_sum(wc, axis=-1)
        cases.append(("sub", lvl, 1 << lvl, (q, kc.contiguous(),
                                             vc.contiguous(),
                                             wc.contiguous())))
    _, lq, lk, lv, lw = lra_band_inputs(dev)
    for mode in NEW_MODES:
        cases += [(mode, lvl, 1, args)
                  for lvl, args in lra_levels(mode, lq, lk, lv, lw)]
    worst = {}
    for mode, lvl, ratio, args in cases:
        if mode == "sub":
            ker = hb.band_attention_sub_fwd(*args, nr=NR, ratio=ratio)
        else:
            ker = hb.band_attention_fwd(*args, nr=NR, mode=mode)
        ref = band_attention_ref(*args, nr=NR, mode=mode, ratio=ratio)
        e, *_ = compare(f"{mode} level {lvl} against band_attention_ref",
                        ker, ref, ATTN_TOL)
        worst[mode] = max(worst.get(mode, 0.0), e)
        del ker, ref
    log(f"oracle: #1 / #2 against band_attention_ref in {len(cases)} "
        f"calls, max abs error by mode {json.dumps(worst)} (<= {ATTN_TOL:g}"
        f" * max(1, |oracle|))")


def phase_full_serve(dev, dense_stats):
    """16 (b).  ``h1d-lm-53m`` with ``attention='full'`` (as
    ``bench_lm_perplexity.lm_cfg`` builds it) at full width and depth,
    seeded weights, on phase 4's traffic: 16 requests, prompts 64..1500
    (seed 0), 32 greedy tokens, ``ServeEngine(slots=8, max_len=2048)``,
    bucketed.  No kernel and no plain version runs (full attention is
    plain torch, as the reference's is jnp).  Every step's logits (the
    prefill's last position, then each decode tick's on the dense
    caches) within LOGIT_TOL of a teacher-forced full-sequence forward's
    at the same position.  Returns the launches (none)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("h1d-lm-53m"), attention="full")
    fns = get_model(cfg)
    params = fns.init(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    work = [(i, rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32))
            for i, n in enumerate(rng.integers(64, 1501, size=16))]
    eng = ServeEngine(cfg, params, slots=8, max_len=2048)
    if eng._bucket_len(100) != 128:
        raise AssertionError("full attention: prompts not bucketed")
    steps = {}
    teacher_forced(eng, steps)
    outs, stats, counts = run_engine(eng, work, fns, new_tokens=FULL_NEW)
    if any(counts.values()):
        raise AssertionError(f"full serve: kernels launched "
                             f"{ {k_: c for k_, c in counts.items() if c} }")
    if {type(c) for c in eng.caches} != {dict}:
        raise AssertionError("full serve: caches are not dense")
    del eng
    worst = 0.0
    with torch.inference_mode():
        for uid, prompt in work:
            seq = np.concatenate([prompt, np.asarray(outs[uid][:-1],
                                                     np.int32)])
            tok = torch.as_tensor(seq[None], dtype=torch.long, device=dev)
            full = fns.forward(params, cfg, tok)[0][0, len(prompt) - 1:]
            got = torch.stack(steps[uid])
            if got.shape != full.shape or not torch.isfinite(got).all():
                raise AssertionError(f"full serve: request {uid}: bad "
                                     f"logits {tuple(got.shape)}")
            e = float((got - full).abs().max())
            if e > LOGIT_TOL:
                raise AssertionError(f"full serve: request {uid}: decode "
                                     f"logits {e:.3g} off the forward's")
            worst = max(worst, e)
    stats.update(requests=len(work), max_len=2048, slots=8,
                 logits_vs_forward_max_abs=worst,
                 h1d=dict(tokens_per_s=dense_stats["tokens_per_s"],
                          prefill_ms_per_call=dense_stats[
                              "prefill_ms_per_call"],
                          decode_ms_per_tick=dense_stats[
                              "decode_ms_per_tick"]))
    log(f"full serve: every step's logits within {worst:.3g} (<= "
        f"{LOGIT_TOL}) of the teacher-forced forward; {json.dumps(stats)}")
    return counts


def phase_full_train(dev, h1d_stats):
    """16 (c).  The full-attention ``h1d-lm-53m`` at 8 x 1024 on phase
    6's data and schedule (``ZipfLM(seed=0)``, peak 3e-4, warmup 5; on
    ``HierarchicalLM``, whose batches draw fresh roots, the loss of 3
    steps does not fall: 10.5002, 10.4995, 10.5103 on the card): 3 AdamW
    steps through ``train``, no kernel launched, every loss finite and
    the last below the first.  Returns the launches."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import ZipfLM
    from repro_torch.train import TrainConfig, tokens_per_s, train

    cfg = dataclasses.replace(get_config("h1d-lm-53m"), attention="full")
    batch, seq = 8, 1024
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=seq,
                  batch_per_host=batch, seed=0)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp, counted(counts):
        tc = TrainConfig(peak_lr=3e-4, warmup=5, ckpt_every=0, ckpt_dir=tmp,
                         log_every=1)
        _, metrics = train(cfg, tc, data, FULL_TRAIN_STEPS, device=dev,
                           log=log)
    need_counts("full train", counts, {k_: 0 for k_ in counts})
    hist = metrics["history"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"full train: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"full train: the loss does not fall: {losses}")
    stats = dict(steps=FULL_TRAIN_STEPS, batch=batch, seq=seq,
                 losses=losses, step_ms=[h["step_ms"] for h in hist],
                 tokens_per_s=tokens_per_s(hist, batch * seq),
                 peak_mem_gib=metrics["peak_mem_gib"],
                 h1d=dict(median_step_ms=h1d_stats["median_step_ms"],
                          tokens_per_s=h1d_stats["tokens_per_s"]))
    log(f"full train: {json.dumps(stats)}")
    return counts


def phase_full_encoder(dev):
    """16 (d).  The LRA encoder (``h1d-lra-encoder`` at full width and
    depth, seeded weights) with ``attention='full'`` and with full
    attention in a LOCAL_WINDOW-token window on every layer (Table 1's
    "local"), each classifying phase 8a's held-out ListOps batch (64 x
    2048, seed 999) three times: the full encoder launches no kernel, the
    windowed one #1 ``l0_bidir`` at nr 16 once a layer a call, its logits
    within LOGIT_TOL of its plain path's.  Returns the launches of the
    timed calls."""
    from repro_torch.configs import get_config
    from repro_torch.data import ListOps
    from repro_torch.models import classifier_init, classifier_logits
    from repro_torch.train import batch_to_device

    held = batch_to_device(ListOps(seq_len=LRA_L, batch_per_host=64,
                                   seed=999).batch(0), dev)
    total = {}
    for kind, kw in (("full", dict(attention="full")),
                     ("local", dict(attention="full",
                                    sliding_window=LOCAL_WINDOW,
                                    global_every=10 ** 6))):
        cfg = dataclasses.replace(get_config("h1d-lra-encoder"), **kw)
        params = classifier_init(cfg, NUM_CLASSES, seed=0, device=dev)

        def classify():
            with torch.inference_mode():
                return classifier_logits(params, cfg, held["tokens"],
                                         held["mask"])
        classify()                          # warm-up
        counts, walls = {}, []
        with counted(counts):
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = classify()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        if logits.shape != (64, NUM_CLASSES) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"{kind} encoder: bad logits")
        want = ({"band_attention_fwd[l0_bidir]": 3 * cfg.num_layers,
                 "band_attention_fwd": 3 * cfg.num_layers}
                if kind == "local" else {})
        need_counts(f"{kind} encoder", counts,
                    {k_: want.get(k_, 0) for k_ in set(counts) | set(want)})
        diff = None
        if kind == "local":
            with plain_kernels():
                ref = classify()
            diff = float((logits - ref).abs().max())
            if diff > LOGIT_TOL:
                raise AssertionError(f"local encoder: logits differ by "
                                     f"{diff:.3g} > {LOGIT_TOL}")
        for k_, c in counts.items():
            total[k_] = total.get(k_, 0) + c
        stats = dict(window=cfg.sliding_window, wall_ms_per_call=walls,
                     classifications_per_s=64 / (np.median(walls) / 1e3),
                     kernel_vs_plain_max_abs=diff)
        log(f"{kind} encoder: {json.dumps(stats)}")
        del params
        torch.cuda.empty_cache()
    return total


def phase_scaling(dev):
    """16 (e).  ``bench_scaling``'s sweep on the card: ``h1d_attention``
    (causal fine-q, kernel path) and ``dense_attention`` (causal) at B 1,
    G 1, d 32, nr 16, L 256..16384, median ms of 10 calls by CUDA events;
    the log-log slope of each.  A line of its own; no assertion on the
    times."""
    from repro_torch.core import dense_attention, h1d_attention

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    with torch.inference_mode():
        for Ls in SCALING_LS:
            q = torch.randn((1, 1, Ls, SCALING_D), generator=gen, device=dev)
            k = torch.randn((1, Ls, SCALING_D), generator=gen, device=dev)
            v = torch.randn((1, Ls, SCALING_D), generator=gen, device=dev)
            h = time_ms(lambda: h1d_attention(q, k, v, nr=NR, causal=True,
                                              causal_mode="fine-q"),
                        iters=10, warmup=2)
            f = time_ms(lambda: dense_attention(q, k, v, causal=True),
                        iters=10, warmup=2)
            rows.append(dict(L=Ls, h1d_ms=h, full_ms=f))
    logL = np.log([r["L"] for r in rows])
    out = dict(scaling=rows, d=SCALING_D, nr=NR,
               slope_h1d=float(np.polyfit(logL, np.log(
                   [r["h1d_ms"] for r in rows]), 1)[0]),
               slope_full=float(np.polyfit(logL, np.log(
                   [r["full_ms"] for r in rows]), 1)[0]))
    print(json.dumps(out), flush=True)


def phase_full(dev, serve_stats, train_stats):
    """16.  Full attention and the dense oracles: (a) the oracles against
    the kernel paths, (b) serving, (c) training, (d) the encoder, (e) the
    scaling sweep.  Returns the launches of (b)-(d)."""
    t0 = time.perf_counter()
    phase_oracles(dev)
    counts = {}
    for part in (phase_full_serve(dev, serve_stats),
                 phase_full_train(dev, train_stats),
                 phase_full_encoder(dev)):
        for k_, c in part.items():
            counts[k_] = counts.get(k_, 0) + c
    phase_scaling(dev)
    log(f"phase 16 (full attention) took {time.perf_counter() - t0:.1f}s")
    return counts


# ---------------------------------------------------------------------------
# phase 17: the MoE and VLM families (qwen2-moe-a2.7b, llava-next-34b)
# ---------------------------------------------------------------------------

# qwen2-moe-a2.7b at full width cut to 2 of its 24 layers (1.76 B
# parameters) and llava-next-34b to 1 of its 60 (1.48 B): the host draws
# ~30 M parameters a second (4 and 2 layers, 2.90 and 2.03 B, until
# phase 18 joined the smoke); qwen2-moe runs at full depth through
# ``launch.serve`` outside the smoke
MOE_ARCH, MOE_LAYERS = "qwen2-moe-a2.7b", 2
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 1, 4096, 3
VLM_ARCH, VLM_LAYERS = "llava-next-34b", 1
VLM_BATCH, VLM_PROMPT, VLM_DECODE, VLM_MAX_LEN = 2, 1024, 16, 4096
VLM_TRAIN_SEQ = 3520            # + 576 patch positions = 4096
# the kernel rows at the shapes these paths give the kernels for the
# first time: (arch, kv-heads of one sequence (the band rows), G,
# head_dim, decode rows (4 slots, or llava's 2 prompts, x kv-heads), the
# phase 17 paths that launch the kernels at that shape)
FAMILY_SHAPES = (("qwen2-moe-a2.7b", 16, 1, 128, 64, ("moe", "moe_train")),
                 ("llava-next-34b", 8, 7, 128, 16, ("vlm",)),
                 ("zamba2-1.2b", 32, 1, 64, 128, ("hybrid", "hybrid_train")))
FAMILY_L = 4096
# one bf16 ulp, relative: rounding one router input element x_d to bf16
# moves it by at most |x_d| * 2^-8, so router logit e by at most 2^-8 *
# sum_d |x_d| |r_de|; two logits' difference by at most twice the
# largest such sum.  A routing flip between two runs whose router inputs
# differ only by such roundings needs the plain path's gap between its
# k-th and (k+1)-th router logit (the log of the gates' ratio) below
# that bound
BF16_ULP = 2.0 ** -8


def family_pairs(dev, mode, Lk, ratio, wk, Lq, g):
    """(query, key) pairs the band admits on this run's weights, G ``g``."""
    from repro_torch.kernels import h1d_block as hb
    i = torch.arange(Lq, device=dev)[:, None]
    j = torch.arange(Lk, device=dev)[None, :]
    allow = hb.band_mask(i, j, NR, mode, Lk, ratio)
    return int((allow[None] & (wk > 0)[:, None, :]).sum()) * g


def family_bwd_compare(label, got, want, args):
    """#3's or #4's outputs against its plain version: dq, dk, dv
    row-scaled and dw elementwise as in phase 3; gmn = (gm - gy.y -
    gdn dn) / c scaled by max(1, |gm| + sum_v |gy_v y_v| + |gdn dn|) of
    its row: a cancelling sum whose terms grow with 2^l at a coarse level
    (y and dn sum 2^l fine rows), so fp32 rounding is bounded by the
    terms, not by the sum, as for dq, dk and dv's row scale.  Returns
    (max abs error, max scaled error, gmn's elementwise-scaled error,
    reported beside)."""
    err, scaled, _ = compare(label, got[:4], want[:4], GRAD_TOL,
                             ("row", "row", "row"))
    y, dn, _, gy, gdn, gm = args[4:]
    terms = gm.abs() + (gy * y).abs().sum(-1) + (gdn * dn).abs()
    diff = (got[4] - want[4]).abs()
    g_scaled = float((diff / terms.clamp(min=1.0)).max())
    g_elem = float((diff / want[4].abs().clamp(min=1.0)).max())
    if g_scaled > GRAD_TOL:
        raise AssertionError(f"{label}: gmn disagrees with its plain "
                             f"version: {g_scaled:.3g} of its terms > "
                             f"{GRAD_TOL:g}")
    return max(err, float(diff.max())), max(scaled, g_scaled), g_elem


def phase_family_kernels(dev):
    """17 (a) and 18 (a).  #1 (``l0_causal``), #2, #3 and #4 at one
    sequence's kv-heads of qwen2-moe-a2.7b (16 rows, G 1) and
    llava-next-34b (8 rows, G 7), head_dim 128, and of zamba2-1.2b (32
    rows, G 1, head_dim 64), L 4096 (every other row right-padded past
    3000), q, k and v rounded to bf16 and widened as the bf16 models
    widen them; #5 and #6 on bf16 caches (Lmax 4096) at qwen2-moe's
    decode shape (64 rows = 4 slots x 16, G 1), llava's (16 rows = 2
    prompts x 8, G 7) and zamba2's (128 rows = 4 slots x 32, G 1), #7
    and #9 on a bf16 pool at qwen2-moe's.  Each
    held to its plain version: forwards and attends within ATTN_TOL,
    backwards within GRAD_TOL (:func:`family_bwd_compare`), updates bit
    for bit over 3 chained appends.  Rows ``<name>@<arch>``; their launches are those
    of the phase 17 paths that run the shape."""
    from repro_torch.core import h1d_decode as hd
    from repro_torch.core import hierarchy as hc
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_block_bwd as hbb
    from repro_torch.kernels import h1d_decode_kernel as dk

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(28)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = []

    def add(name, src, replaces, arch, paths, numbers, note, **extra):
        rows.append(dict(name=f"{name}@{arch}", route="cuda",
                         source=f"src/repro_torch/kernels/csrc/{src}",
                         replaces=f"src/repro/kernels/{replaces}",
                         library_ms=None, paths=list(paths), note=note,
                         **numbers, **extra))
        log(f"{name}@{arch}: max abs err {numbers['max_abs_err']:.3g}, "
            f"{numbers['ms']:.4f} ms, device {numbers['device_ms']:.4f} "
            f"ms, bound {numbers['bound_ms']:.5f} ms, plain "
            f"{numbers['plain_ms']:.3f} ms; {note}")

    def timed(kernel, plain, err, bms_by):
        return dict(max_abs_err=err, ms=time_ms(kernel),
                    device_ms=device_ms(kernel), plain_ms=time_ms(plain),
                    bound_ms=bms_by[0], bound_by=bms_by[1])

    for arch, hkv, g, d, R, paths in FAMILY_SHAPES:
        Lf = FAMILY_L
        q = (randn(hkv, g, Lf, d) / math.sqrt(d)).to(bf).float()
        k = randn(hkv, Lf, d).to(bf).float()
        w = torch.ones((hkv, Lf), device=dev)
        w[1::2, 3000:] = 0.0
        v = randn(hkv, Lf, d).to(bf).float() * w[..., None]
        shape = f"{hkv} rows x G {g}, L {Lf}, d {d}"

        # #1 and #3 at level 0
        fwd = (q, k, v, w)
        out = hb.band_attention_fwd(*fwd, nr=NR, mode="l0_causal")
        err, *_ = compare(f"band_attention_fwd@{arch}", out,
                          hb.band_attention_fwd_ref(*fwd, nr=NR,
                                                    mode="l0_causal"),
                          ATTN_TOL)
        pairs = family_pairs(dev, "l0_causal", Lf, 1, w, Lf, g)
        add("band_attention_fwd[l0_causal]", "h1d_block.cu",
            "h1d_block.py:299", arch, paths,
            timed(lambda: hb.band_attention_fwd(*fwd, nr=NR),
                  lambda: hb.band_attention_fwd_ref(*fwd, nr=NR), err,
                  bound(hb.band_bytes(w, nr=NR, mode="l0_causal", G=g,
                                      d=d, dv=d), pairs * (4 * d + 3))),
            shape, mode="l0_causal")
        cot = tuple(randn(*t.shape) for t in out)
        args = (*fwd, *out, *cot)
        e3, s3, gm3 = family_bwd_compare(
            f"band_attention_bwd@{arch}",
            hbb.band_attention_bwd(*args, nr=NR),
            hbb.band_attention_bwd_ref(*args, nr=NR), args)
        add("band_attention_bwd[l0_causal]", "h1d_block_bwd.cu",
            "h1d_block_bwd.py:541", arch, paths,
            timed(lambda: hbb.band_attention_bwd(*args, nr=NR),
                  lambda: hbb.band_attention_bwd_ref(*args, nr=NR), e3,
                  bound(hb.band_bytes(w, nr=NR, mode="l0_causal", G=g,
                                      d=d, dv=d, backward=True),
                        pairs * (10 * d + 5))),
            f"{shape}; {BWD_LAUNCH}", mode="l0_causal", max_scaled_err=s3,
            gmn_elementwise_scaled_err=gm3)
        del out, cot, args

        # #2 and #4 at every sub level of the coarsened chain
        M = hc.num_levels(Lf, NR)
        kc, vc, wc = k, v, w
        tot = {n: dict(err=0.0, ms=0.0, device_ms=0.0, plain_ms=0.0,
                       nbytes=0, flops=0) for n in ("fwd", "bwd")}
        gm_elem = 0.0
        for lvl in range(1, M):
            ratio = 1 << lvl
            kc, _ = hc.coarsen_weighted_mean(kc, wc)
            vc = hc.coarsen_sum(vc, axis=-2)
            wc = hc.coarsen_sum(wc, axis=-1)
            sub = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
            out = hb.band_attention_sub_fwd(*sub, nr=NR, ratio=ratio)
            ef, *_ = compare(f"band_attention_sub_fwd@{arch} ratio {ratio}",
                             out, hb.band_attention_sub_fwd_ref(
                                 *sub, nr=NR, ratio=ratio), ATTN_TOL)
            cot = tuple(randn(*t.shape) for t in out)
            bargs = (*sub, *out, *cot)
            eb, _, gmb = family_bwd_compare(
                f"band_attention_sub_bwd@{arch} ratio {ratio}",
                hbb.band_attention_sub_bwd(*bargs, nr=NR, ratio=ratio),
                hbb.band_attention_sub_bwd_ref(*bargs, nr=NR, ratio=ratio),
                bargs)
            gm_elem = max(gm_elem, gmb)
            sp_ = family_pairs(dev, "sub", Lf // ratio, ratio, sub[3], Lf, g)
            for n, e, kern, plain, per in (
                    ("fwd", ef, lambda: hb.band_attention_sub_fwd(
                        *sub, nr=NR, ratio=ratio),
                     lambda: hb.band_attention_sub_fwd_ref(
                         *sub, nr=NR, ratio=ratio), 4 * d + 3),
                    ("bwd", eb, lambda: hbb.band_attention_sub_bwd(
                        *bargs, nr=NR, ratio=ratio),
                     lambda: hbb.band_attention_sub_bwd_ref(
                         *bargs, nr=NR, ratio=ratio), 10 * d + 5)):
                t = tot[n]
                t["err"] = max(t["err"], e)
                t["ms"] += time_ms(kern)
                t["device_ms"] += device_ms(kern)
                t["plain_ms"] += time_ms(plain)
                t["nbytes"] += hb.sub_bytes(sub[3], nr=NR, ratio=ratio, G=g,
                                            d=d, dv=d, backward=n == "bwd")
                t["flops"] += sp_ * per
            del out, cot, bargs
        span = f"the {M - 1} sub levels (ratio 2..{1 << (M - 1)}) of {shape}"
        for n, name, src, rep, note in (
                ("fwd", "band_attention_sub_fwd", "h1d_block.cu",
                 "h1d_block.py:245", span),
                ("bwd", "band_attention_sub_bwd", "h1d_block_bwd.cu",
                 "h1d_block_bwd.py:399", f"{span}; {SUB_BWD_LAUNCH}")):
            t = tot[n]
            add(name, src, rep, arch, paths,
                dict(max_abs_err=t["err"], ms=t["ms"],
                     device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                     **dict(zip(("bound_ms", "bound_by"),
                                bound(t["nbytes"], t["flops"])))), note,
                **({"gmn_elementwise_scaled_err": gm_elem} if n == "bwd"
                   else {}))
        del q, k, v, w, kc, vc, wc

        # #5 and #6 on a bf16 cache at the decode shape
        Lb = BF16_LMAX
        Md = hc.num_levels(Lb, NR)
        cache = hd.prefill_cache(randn(R, Lb, d).to(bf),
                                 randn(R, Lb, d).to(bf), Lb, NR)
        qd = randn(R, g, d).to(bf).float()
        t = torch.randint(1000, Lb - 16, (R,), generator=gen, device=dev,
                          dtype=torch.int32)
        t[:4] = torch.tensor([0, NR - 1, NR, Lb - 1], dtype=torch.int32)
        small = 4 * (qd.numel() + R + R * g * d)
        keys = partial_keys(t, None, Md)
        err, *_ = compare(f"decode_attend_fused[bf16]@{arch}",
                          [dk.decode_attend_fused(cache, qd, t, nr=NR)],
                          [dk.decode_attend_ref(cache, qd, t, nr=NR)],
                          ATTN_TOL)
        dshape = f"{R} rows x G {g}, D {d}, Lmax {Lb}"
        add("decode_attend_fused[bf16]", "h1d_decode.cu",
            "h1d_decode_kernel.py:154", arch, paths,
            timed(lambda: dk.decode_attend_fused(cache, qd, t, nr=NR),
                  lambda: dk.decode_attend_ref(cache, qd, t, nr=NR), err,
                  bound(keys * 2 * d * 2 + small, keys * g * (4 * d + 4))),
            f"{dshape}: {keys} band keys unmasked", live_keys=keys)
        kn, vn = randn(R, d).to(bf), randn(R, d).to(bf)

        def clone(c):
            return type(c)(*[tuple(a.clone() for a in x)
                             if isinstance(x, tuple) else x.clone()
                             for x in c])
        a, b = clone(cache), clone(cache)
        for step in range(3):
            tt = (t + step).clamp(max=Lb - 1)
            dk.update_cache_fused(a, kn, vn * (step + 1), tt)
            dk.update_cache_ref(b, kn, vn * (step + 1), tt)
        if not all(torch.equal(x, y) for x, y in zip(pool_arrays(a),
                                                      pool_arrays(b))):
            raise AssertionError(f"update_cache_fused[bf16]@{arch}: not "
                                 f"bit-exact")
        add("update_cache_fused[bf16]", "h1d_decode.cu",
            "h1d_decode_kernel.py:362", arch, paths,
            timed(lambda: dk.update_cache_fused(a, kn, vn, t),
                  lambda: dk.update_cache_ref(b, kn, vn, t), 0.0,
                  update_bound(R, Md, d, es=2)),
            f"{dshape}, {Md} levels: bit-exact over 3 chained updates")
        del a, b, cache
        if arch != MOE_ARCH:
            continue

        # #7 and #9 on a bf16 pool: 4 slots' pages x kv-heads + ZERO/TRASH,
        # the last two rows inactive on TRASH
        npages = [(4 * max((Lb >> lv) // NR, 1) + 2) * hkv
                  for lv in range(Md)]
        pool = hd.PagedH1DCache(
            randn(npages[0], NR, d).to(bf), randn(npages[0], NR, d).to(bf),
            tuple(randn(n, NR, d).to(bf) for n in npages[1:]),
            tuple((randn(n, NR, d) * 2 ** (lv + 1)).to(bf)
                  for lv, n in enumerate(npages[1:])))
        trash = TRASH * hkv
        bidx = torch.stack([torch.randint(2 * hkv, n, (R,), generator=gen,
                                          device=dev)
                            for n in [npages[0]] + npages], 1).to(torch.int32)
        utab = torch.stack([torch.randperm(n - 2 * hkv, generator=gen,
                                           device=dev)[:R] + 2 * hkv
                            for n in npages], 1).to(torch.int32)
        bidx[R - 2:] = trash
        utab[R - 2:] = trash
        err, *_ = compare(f"decode_attend_paged[bf16]@{arch}",
                          [dk.decode_attend_paged(pool, qd, t, bidx, nr=NR)],
                          [dk.decode_attend_paged_ref(pool, qd, t, bidx,
                                                      nr=NR)], ATTN_TOL)
        add("decode_attend_paged[bf16]", "h1d_decode.cu",
            "h1d_decode_kernel.py:426", arch, paths,
            timed(lambda: dk.decode_attend_paged(pool, qd, t, bidx, nr=NR),
                  lambda: dk.decode_attend_paged_ref(pool, qd, t, bidx,
                                                     nr=NR), err,
                  bound(keys * 2 * d * 2 + small + 4 * bidx.numel(),
                        keys * g * (4 * d + 4))),
            f"{dshape}, bf16 pool: {keys} band keys unmasked",
            live_keys=keys)
        a, b = clone(pool), clone(pool)
        for step in range(3):
            tt = (t + step).clamp(max=Lb - 1)
            dk.update_cache_paged(a, kn, vn * (step + 1), tt, utab)
            dk.update_cache_paged_ref(b, kn, vn * (step + 1), tt, utab)
        for x, y in zip(pool_arrays(a), pool_arrays(b)):
            keep = torch.ones(x.shape[0], dtype=torch.bool, device=dev)
            keep[trash:trash + hkv] = False
            if not torch.equal(x[keep], y[keep]):
                raise AssertionError(f"update_cache_paged[bf16]@{arch}: not "
                                     f"bit-exact outside TRASH")
        add("update_cache_paged[bf16]", "h1d_decode.cu",
            "h1d_decode_kernel.py:567", arch, paths,
            timed(lambda: dk.update_cache_paged(a, kn, vn, t, utab),
                  lambda: dk.update_cache_paged_ref(b, kn, vn, t, utab), 0.0,
                  update_bound(R, Md, d, table_cols=utab.shape[1], es=2)),
            f"{dshape}, {Md} levels: bit-exact outside TRASH over 3 "
            f"chained updates")
        del a, b, pool
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def routes_logged(log_, force=None, flips=None):
    """Wrap the port's routing function (``models.ffn.route``, from this
    script: the package has no such switch) so that each call appends
    {"top_i", "router", "gap", "tau"} to ``log_``: the chosen experts,
    the router's identity, and per position the gap between the k-th
    and (k+1)-th router logit and the bf16 rounding bound (BF16_ULP's
    comment).  With ``force`` ({router: top_i}, a kernel pass's first
    routing of each layer), a call whose own experts differ from the
    forced ones at some position appends (gap, tau) of each such
    position to ``flips`` and routes to the forced experts (the plain
    pass of a gradient then takes the kernel pass's experts)."""
    from repro_torch.models import ffn
    real = ffn.route
    done = set()

    def logged(p, cfg, x):
        top_w, top_i, rank, aux, C = out = real(p, cfg, x)
        with torch.no_grad():
            r = p["router"].detach()
            z = x.detach().float() @ r
            top = z.topk(cfg.moe_top_k + 1, dim=-1).values
            gap = top[..., -2] - top[..., -1]
            tau = 2 * BF16_ULP * (x.detach().float().abs() @ r.abs()).amax(-1)
        key = r.data_ptr()
        log_.append(dict(top_i=top_i.detach(), router=key, gap=gap, tau=tau))
        if force is not None:
            want = force[key]
            differ = (top_i.sort(-1).values != want.sort(-1).values).any(-1)
            if bool(differ.any()):
                if key not in done:      # not again in a remat recompute
                    flips.extend(zip(gap[differ].tolist(),
                                     tau[differ].tolist()))
                done.add(key)
                gates = torch.softmax(x.float() @ p["router"], dim=-1)
                return ffn.assign(cfg, gates, want)
        return out
    ffn.route = logged
    try:
        yield
    finally:
        ffn.route = real


def first_routes(log_):
    """{router: top_i} of each layer's first call in ``log_``."""
    out = {}
    for rec in log_:
        out.setdefault(rec["router"], rec["top_i"])
    return out


def moe_engine_run(eng, work, fns, tokens=None, plain=False):
    """``run_engine`` of ``eng`` on ``work`` (with ``plain``, a run on the
    plain versions, which ``run_engine`` refuses, and no stats) with
    every route call logged and every logits row the engine takes a
    token from recorded (:func:`teacher_forced`; with ``tokens``, the
    plain run's, handed in), and for each (uid, step) the route calls
    between its engine call's start and its sampling, its row in that
    call and its position (a prefill row's last true token; 0 in a
    decode tick).  Returns (stats, launches, logits, routes, steps)."""
    from repro_torch.serve import Request
    logits, routes, steps = {}, [], {}
    teacher_forced(eng, logits, tokens)
    mark, true_len = [0], [None]
    sample = eng._sample

    def sampled(z, rows, reqs, tick):
        out = sample(z, rows, reqs, tick)
        for i, r in enumerate(reqs):
            if r is not None:
                pos = 0 if tick else int(true_len[0][i]) - 1
                steps[(r.uid, len(logits[r.uid]) - 1)] = (
                    mark[0], len(routes), i, pos)
        mark[0] = len(routes)
        return out
    eng._sample = sampled

    base = fns.prefill

    def prefill(*a, **kw):
        true_len[0] = kw["true_len"].cpu()
        return base(*a, **kw)
    fns = fns._replace(prefill=prefill)
    stats = counts = None
    with routes_logged(routes):
        if plain:
            eng.fns = fns
            for u, p in work:
                eng.submit(Request(uid=u, prompt=p,
                                   max_new_tokens=GEMMA_NEW))
            with plain_kernels():
                eng.run()
        else:
            _, stats, counts = run_engine(eng, work, fns,
                                          new_tokens=GEMMA_NEW)
    return stats, counts, logits, routes, steps


def routing_flips(label, got, want, steps):
    """Positions whose set of experts differs between two route logs of
    the same schedule (``got`` the kernel run's, ``want`` the plain
    run's), engine call by engine call (``steps``: the plain run's
    (uid, step) -> (first route call, end, row, position)).  A flip in a
    clean context -- its request had no flip in an earlier engine call
    (whose caches it reads), and no earlier layer of this call flipped
    a position at or before it (fine-q attention reads no later one;
    a flip moves the capacity ranks of later positions only) -- must be
    a near tie in the plain run: its gap between the k-th and (k+1)-th
    router logit within the bf16 rounding bound ``tau``.  Later flips
    follow from an earlier one (a flipped token's output moves by a
    whole expert's share and reaches later tokens through attention and
    the caches) and are counted apart, with their largest gap; so are
    the flips of rows no request owns (a bucket's dummy rows, idle
    slots).  Returns (per route call the (B, S) mask of the positions
    that differ in that or an earlier layer of its engine call, a
    summary)."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} route calls, the plain "
                             f"run {len(want)}")
    owners = {}
    for (uid, _), (lo, hi, row, _) in steps.items():
        owners.setdefault((lo, hi), {})[row] = uid
    masks = [None] * len(want)
    tainted = set()
    out = dict(positions_compared=0, clean_flips=0, downstream_flips=0,
               unowned_flips=0, clean_largest_gap=None,
               clean_largest_gap_over_bound=0.0,
               downstream_largest_gap=None)
    for (lo, hi), rows in sorted(owners.items()):
        prev = None
        first = {}          # row -> first position flipped in this call
        hit = set()
        for c in range(lo, hi):
            a, b = got[c], want[c]
            if a["top_i"].shape != b["top_i"].shape:
                raise AssertionError(f"{label}: route shapes differ")
            differ = (a["top_i"].sort(-1).values
                      != b["top_i"].sort(-1).values).any(-1)
            out["positions_compared"] += differ.numel()
            for r, pos in zip(*[t.tolist() for t in torch.nonzero(
                    differ, as_tuple=True)]):
                gap, tau = float(b["gap"][r, pos]), float(b["tau"][r, pos])
                if r not in rows:
                    out["unowned_flips"] += 1
                elif rows[r] in tainted or first.get(r, pos + 1) <= pos:
                    out["downstream_flips"] += 1
                    out["downstream_largest_gap"] = max(
                        out["downstream_largest_gap"] or 0.0, gap)
                else:
                    out["clean_flips"] += 1
                    out["clean_largest_gap"] = max(
                        out["clean_largest_gap"] or 0.0, gap)
                    out["clean_largest_gap_over_bound"] = max(
                        out["clean_largest_gap_over_bound"], gap / tau)
                    if gap > tau:
                        raise AssertionError(
                            f"{label}: a routing flip in a clean context "
                            f"(request {rows[r]}, position {pos}) where the "
                            f"plain run's top-k router logit gap {gap:.4g} "
                            f"exceeds the bf16 rounding bound {tau:.4g}")
                hit.add(r)
            for r in set(torch.nonzero(differ.any(-1)).flatten().tolist()):
                p0 = int(torch.nonzero(differ[r])[0])
                first[r] = min(first.get(r, p0), p0)
            prev = differ if prev is None else prev | differ
            masks[c] = prev.clone()
        tainted |= {rows[r] for r in hit if r in rows}
    return masks, out


def moe_logits_vs_plain(label, got, want, flipped, steps_got, steps_want):
    """:func:`logits_vs_plain` for a MoE model: every step whose token's
    experts agreed in every layer (``flipped``: per route call, the
    positions that differ so far in their engine call) within
    BF16_LOGIT_TOL of max |plain|; the steps whose token flipped are
    counted and left out.  Returns (steps held, steps left out, worst
    scaled error)."""
    if steps_got != steps_want:
        raise AssertionError(f"{label}: the two runs' schedules differ")
    held, skipped, worst = 0, 0, 0.0
    for (uid, i), (lo, hi, row, pos) in steps_want.items():
        if bool(flipped[hi - 1][row, pos]):
            skipped += 1
            continue
        a, b = got[uid][i], want[uid][i]
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: request {uid} step {i}: bad "
                                 f"logits")
        e = float((a - b).abs().max() / b.abs().max())
        if e > BF16_LOGIT_TOL:
            raise AssertionError(f"{label}: request {uid} step {i}: logits "
                                 f"differ by {e:.3g} of max |plain| > "
                                 f"{BF16_LOGIT_TOL}")
        worst = max(worst, e)
        held += 1
    return held, skipped, worst


def phase_moe(dev):
    """17 (b), (c).  ``qwen2-moe-a2.7b`` at full width, MOE_LAYERS layers,
    in its published bf16 from seed-0 weights.  (b) ``ServeEngine(slots=4,
    max_len=4096)``, bucketed, on 8 greedy requests of 16 tokens with
    prompt lengths 1000..3900 (seed 0): the kernel run (#1, #2, #5, #6
    launched, no plain version), the plain run, then the kernels on the
    plain run's tokens on dense slots and on a paged bf16 pool (#7, #9),
    each route call logged on both sides (:func:`routing_flips`: flips
    counted, each a bounded near tie) and every step whose routes agreed
    held to the plain run's logits.  (c) on the same weights,
    ``bf16_checks`` at 1 x 4096 on ``ZipfLM(seed=0)`` (the fp32
    gradient's plain pass routed to the kernel pass's experts, any flip
    reported with its gap) and 3 in-place AdamW steps through
    ``train``.  Returns the launches of (b) and of (c)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import ZipfLM
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine
    from repro_torch.train import (TrainConfig, TrainState, batch_to_device,
                                   make_optimizer)
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    if cfg.dtype != "bfloat16" or cfg.family != "moe":
        raise AssertionError(f"{MOE_ARCH} is a bf16 MoE config")
    fns = get_model(cfg)
    params = fns.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparam = sum(p.numel() for p in tree_leaves(params))
    work = bf16_prompts(cfg.vocab_size, *DENSE_PROMPTS, DENSE_REQUESTS)

    # (b) serving
    eng = ServeEngine(cfg, params, slots=GEMMA_SLOTS, max_len=GEMMA_MAX_LEN)
    if not eng._bucket:
        raise AssertionError(f"{MOE_ARCH}: the engine does not bucket")
    torch.cuda.reset_peak_memory_stats()
    outs, stats, counts = run_engine(eng, work, fns, new_tokens=GEMMA_NEW)
    stats.update(arch=MOE_ARCH, layers=cfg.num_layers, params=nparam,
                 weights_s=init_s, prompt_lens=[len(p) for _, p in work],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    need = ("band_attention_fwd[l0_causal]", "band_attention_sub_fwd",
            "decode_attend_fused[bf16]", "update_cache_fused[bf16]")
    missing = [k_ for k_ in need if not counts.get(k_)]
    if missing:
        raise AssertionError(f"moe: {missing} not launched: {counts}")
    serve_counts = dict(counts)
    del eng
    log(f"moe serve: {json.dumps(stats)}")
    eng = ServeEngine(cfg, params, slots=GEMMA_SLOTS, max_len=GEMMA_MAX_LEN)
    _, _, p_logits, p_routes, p_steps = moe_engine_run(eng, work, fns,
                                                       plain=True)
    del eng
    plain = {u: [int(z.argmax()) for z in p_logits[u]] for u in p_logits}
    same = sum(x == y for u in plain for x, y in zip(outs[u], plain[u]))
    log(f"moe: {same} of {GEMMA_NEW * len(work)} greedy tokens equal to "
        f"the plain run's")
    for kind, kw, need in (("dense", {}, ()),
                           ("paged", dict(paged=True),
                            ("decode_attend_paged[bf16]",
                             "update_cache_paged[bf16]"))):
        eng = ServeEngine(cfg, params, slots=GEMMA_SLOTS,
                          max_len=GEMMA_MAX_LEN, **kw)
        st, c, k_logits, k_routes, k_steps = moe_engine_run(
            eng, work, fns, plain)
        del eng
        masks, flips = routing_flips(f"moe {kind}", k_routes, p_routes,
                                     p_steps)
        held, skipped, worst = moe_logits_vs_plain(
            f"moe {kind}", k_logits, p_logits, masks, k_steps, p_steps)
        missing = [k_ for k_ in need if not c.get(k_)]
        if missing:
            raise AssertionError(f"moe {kind}: {missing} not launched: {c}")
        if held < 0.75 * (held + skipped):
            raise AssertionError(f"moe {kind}: routes flipped at {skipped} "
                                 f"of {held + skipped} steps")
        if kind == "paged":
            for k_, n in c.items():
                serve_counts[k_] = serve_counts.get(k_, 0) + n
        log(f"moe {kind} (the plain run's tokens): routing "
            f"{json.dumps(flips)}; logits within {worst:.3g} of max |plain| "
            f"(<= {BF16_LOGIT_TOL}) at {held} steps, {skipped} steps whose "
            f"token's experts flipped left out; tokens/s "
            f"{st['tokens_per_s']:.1f}, prefill ms a call "
            f"{st['prefill_ms_per_call']:.1f}, decode ms a tick "
            f"{st['decode_ms_per_tick']:.2f}")
        del k_logits, k_routes, masks
    del p_logits, p_routes
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 17 (b) took {time.perf_counter() - t0:.1f}s, weights "
        f"{init_s:.1f}s")

    # (c) training on (b)'s weights
    t1 = time.perf_counter()
    data = ZipfLM(vocab_size=cfg.vocab_size, seq_len=MOE_TRAIN_SEQ,
                  batch_per_host=MOE_TRAIN_BATCH, seed=0)
    batch = batch_to_device(data.batch(0), dev)
    kernel_log, plain_log, flips = [], [], []

    @contextlib.contextmanager
    def forced():
        with plain_kernels(), routes_logged(
                plain_log, first_routes(kernel_log), flips):
            yield
    loss_k, loss_p, peaks = bf16_checks(
        "moe train", cfg, params, batch,
        grad_ctx=dict(run=lambda: routes_logged(kernel_log), ref=forced))
    log(f"moe train (fp32 gradient): {len(flips)} routing flips between "
        f"the kernel and plain passes"
        + (f", (gap, bound) {flips[:8]}" if flips else "")
        + "; the plain pass took the kernel pass's experts")
    del kernel_log, plain_log
    tmp = tempfile.TemporaryDirectory()
    tc = TrainConfig(ckpt_every=0, ckpt_dir=tmp.name, log_every=1, seed=0,
                     peak_lr=3e-4, warmup=5)
    state = TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                       params, make_optimizer(tc).init(params), None)
    del params
    with tmp:
        train_counts, _ = bf16_steps(
            "moe train", cfg, tc, state, data, MOE_TRAIN_STEPS, loss_k,
            False, first_loss_plain=loss_p,
            grad_peak_above_weights_gib=peaks, fp32_grad_flips=len(flips))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 17 (c) took {time.perf_counter() - t1:.1f}s")
    return serve_counts, train_counts


class PatchLM:
    """``ZipfLM`` batches with seeded patch embeddings (numpy, seed 0, x
    0.02) of ``patches`` positions before the tokens."""

    def __init__(self, cfg, seq, batch, patches):
        from repro_torch.data import ZipfLM
        self.tokens = ZipfLM(vocab_size=cfg.vocab_size, seq_len=seq,
                             batch_per_host=batch, seed=0)
        self.seq_len, self.batch_per_host = seq, batch
        self.patch = (np.random.default_rng(0).standard_normal(
            (batch, patches, cfg.d_model)) * 0.02).astype(np.float32)

    def batch(self, step):
        return dict(self.tokens.batch(step), patch_embeds=self.patch)


def phase_vlm(dev):
    """17 (d), (e).  ``llava-next-34b`` at full width, VLM_LAYERS layers,
    bf16, seed-0 weights.  (d) ``lm_prefill`` of 576 seeded patch
    embeddings (numpy, seed 0, x 0.02) and a 1024-token prompt at B 2,
    Lmax 4096, then 16 greedy decode steps: first on the plain versions,
    then on the kernels with the plain run's tokens (#1, #2, #5, #6
    launched, no plain version), every step's logits within
    BF16_LOGIT_TOL of max |plain|.  (e) one in-place AdamW step at 1 x
    (576 + 3520) with ``patch_embeds`` on the same weights: its first
    loss within BF16_LOSS_TOL of the plain path's, #1-#4 launched as the
    remat step runs them, the weights still bf16.  Returns the launches
    of (d) and (e)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import (TrainConfig, TrainState, batch_to_device,
                                   make_optimizer, make_train_step)
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_LAYERS)
    fns = get_model(cfg)
    params = fns.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparam = sum(p.numel() for p in tree_leaves(params))
    rng = np.random.default_rng(0)
    patch = torch.as_tensor((rng.standard_normal(
        (VLM_BATCH, cfg.prefix_len, cfg.d_model)) * 0.02).astype(np.float32),
        device=dev)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (VLM_BATCH, VLM_PROMPT)).astype(np.int32),
        device=dev)
    batch = {"tokens": prompt, "patch_embeds": patch}

    def generate(tokens=None):
        """Prefill, then VLM_DECODE steps (greedy, or ``tokens``): (every
        step's logits, the tokens, prefill ms, decode ms a step)."""
        torch.cuda.synchronize()
        a = time.perf_counter()
        logits, caches, pos = fns.prefill(params, cfg, batch, VLM_MAX_LEN)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - a) * 1e3
        if not torch.equal(pos.cpu(), torch.full(
                (VLM_BATCH,), cfg.prefix_len + VLM_PROMPT, dtype=torch.int32)):
            raise AssertionError(f"vlm: next positions {pos.tolist()}")
        seen, toks = [logits.float().clone()], []
        a = time.perf_counter()
        for i in range(VLM_DECODE):
            tok = (logits.argmax(-1).to(torch.int32) if tokens is None
                   else tokens[i])
            toks.append(tok)
            logits, caches = fns.decode_step(params, cfg, caches, tok, pos)
            pos = pos + 1
            seen.append(logits.float().clone())
        torch.cuda.synchronize()
        return seen, toks, pre_ms, (time.perf_counter() - a) * 1e3 / VLM_DECODE

    with plain_kernels():
        want, toks, _, _ = generate()
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    with counted(counts):
        got, _, pre_ms, dec_ms = generate(toks)
    need = ("band_attention_fwd[l0_causal]", "band_attention_sub_fwd",
            "decode_attend_fused[bf16]", "update_cache_fused[bf16]")
    missing = [k_ for k_ in need if not counts.get(k_)]
    if missing:
        raise AssertionError(f"vlm: {missing} not launched: {counts}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"vlm step {i}: bad logits")
        e = float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())
        if e > BF16_LOGIT_TOL:
            raise AssertionError(f"vlm step {i}: logits differ by {e:.3g} "
                                 f"of max |plain| > {BF16_LOGIT_TOL}")
        worst = max(worst, e)
    stats = dict(arch=VLM_ARCH, layers=cfg.num_layers, params=nparam,
                 weights_s=init_s, batch=VLM_BATCH, patches=cfg.prefix_len,
                 prompt=VLM_PROMPT, prefill_ms=pre_ms,
                 decode_ms_per_step=dec_ms,
                 tokens_per_s=VLM_BATCH / (dec_ms / 1e3),
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 logits_worst_over_max_plain=worst,
                 launches={k_: n for k_, n in counts.items() if n})
    log(f"vlm serve (the plain run's tokens): {json.dumps(stats)}")
    del want, got

    # (e) one AdamW step with the patch prefix
    data = PatchLM(cfg, VLM_TRAIN_SEQ, 1, cfg.prefix_len)
    tb = batch_to_device(data.batch(0), dev)
    with torch.no_grad():
        loss_k = float(fns.loss(params, cfg, tb)[0])
        with plain_kernels():
            loss_p = float(fns.loss(params, cfg, tb)[0])
    if not abs(loss_k - loss_p) <= BF16_LOSS_TOL:
        raise AssertionError(f"vlm train: loss {loss_k} on the kernels, "
                             f"{loss_p} on the plain path")
    tmp = tempfile.TemporaryDirectory()
    tc = TrainConfig(ckpt_every=0, ckpt_dir=tmp.name, seed=0, peak_lr=3e-4,
                     warmup=1)
    state = TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                       params, make_optimizer(tc).init(params), None)
    del params
    step = make_train_step(cfg, tc)
    train_counts = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    a = time.perf_counter()
    with counted(train_counts):
        state, m = step(state, tb)
        loss = float(m["loss"])
    step_ms = (time.perf_counter() - a) * 1e3
    need_counts("vlm train", train_counts, train_expected(
        cfg, 1, cfg.prefix_len + VLM_TRAIN_SEQ))
    dtypes = {str(p.dtype) for p in tree_leaves(state.params)}
    if not (math.isfinite(loss) and abs(loss - loss_k) <= BF16_LOSS_TOL
            and dtypes == {"torch.bfloat16"}):
        raise AssertionError(f"vlm train: loss {loss} (first batch's "
                             f"{loss_k}), weights {dtypes}")
    tstats = dict(seq=cfg.prefix_len + VLM_TRAIN_SEQ, loss=loss,
                  first_loss_kernel=loss_k, first_loss_plain=loss_p,
                  step_ms=step_ms,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"vlm train: {json.dumps(tstats)}")
    del state, tmp
    for k_, n in train_counts.items():
        counts[k_] = counts.get(k_, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 17 (d), (e) took {time.perf_counter() - t0:.1f}s, weights "
        f"{init_s:.1f}s")
    return counts


def phase_families(dev):
    """17 (b)-(e).  The MoE and VLM families: qwen2-moe-a2.7b served and
    trained, llava-next-34b prefilled with a patch prefix, decoded and
    trained ((a), the kernel rows at their new shapes, runs with the
    other kernel rows, before any model phase).  Returns {"moe",
    "moe_train", "vlm": launches}."""
    t0 = time.perf_counter()
    moe, moe_train = phase_moe(dev)
    vlm = phase_vlm(dev)
    log(f"phase 17 (b)-(e) took {time.perf_counter() - t0:.1f}s")
    return dict(moe=moe, moe_train=moe_train, vlm=vlm)


# ---------------------------------------------------------------------------
# phase 18: the SSM and hybrid families (mamba2-1.3b, zamba2-1.2b)
# ---------------------------------------------------------------------------

# mamba2-1.3b at full width cut to 8 of its 48 layers (0.32 B parameters)
# and zamba2-1.2b to 12 of its 38 (0.46 B: two invocations of the shared
# block): the host draws ~30 M parameters a second; both run at full
# depth through ``launch.serve`` outside the smoke
SSM_ARCH, SSM_LAYERS = "mamba2-1.3b", 8
HYBRID_ARCH, HYBRID_LAYERS = "zamba2-1.2b", 12
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 1, 4096, 3
# the mixer's sequence lengths: 4096 runs chunk 256, 4093 (prime) chunk 1
SSM_LENS = (4096, 4093)
# the mixer on the card against the CPU (fp32 both, products of depth
# 2048-4096 summed in other orders), of the CPU's largest |entry|
MIXER_TOL = 1e-4
# ssd_chunked against ssd_reference: the reference's own bound
# (tests/test_ssm.py)
SSD_ATOL, SSD_RTOL = 2e-4, 1e-3
# prefill against token-by-token decode (fp32, 2 layers), of max |logit|
PREFILL_DECODE_TOL, PREFILL_DECODE_LEN = 2e-4, 300
# the fp32 gradient of a mixer's per-head leaves (A_log, dt_bias), sums
# over every position and head dim whose terms cancel down to a largest
# |entry| of 1e-5..5e-4: two plain paths (the card's and the CPU's) sit
# up to 3.1e-4 of it apart on A_log at zamba2's 12 layers, 1 x 4096
# (``tools/grad_noise.py``), so these leaves are held to 1e-3 of their
# largest |plain| (and elementwise to GRAD_TOL, as every leaf)
SSM_SUM_LEAVES = {"mixer/A_log": 1e-3, "mixer/dt_bias": 1e-3}


def mixer_vs_cpu(cfg, dev):
    """One full-width Mamba2 mixer in fp32 (``mamba2_init`` from seed 0
    on the CPU) on the card against the same function on the CPU, at
    each of SSM_LENS: out, h and the convolution state within MIXER_TOL
    of the CPU's largest entry.  Returns {S: (chunk, worst error, card
    ms)}."""
    from repro_torch.models import ssm
    f32 = dataclasses.replace(cfg, dtype="float32")
    p, _ = ssm.mamba2_init(torch.Generator().manual_seed(0), f32)
    cuda = {k_: ({n: t.to(dev) for n, t in v.items()}
                 if isinstance(v, dict) else v.to(dev))
            for k_, v in p.items()}
    out = {}
    for S in SSM_LENS:
        x = torch.randn((1, S, cfg.d_model),
                        generator=torch.Generator().manual_seed(S))
        want, wst = ssm.mamba2_apply(p, f32, x, return_state=True)
        xd = x.to(dev)
        got, st = ssm.mamba2_apply(cuda, f32, xd, return_state=True)
        worst = 0.0
        for name, a, b in (("out", got, want), ("h", st.h, wst.h),
                           ("conv", st.conv, wst.conv)):
            _, e, _ = compare(f"mamba2 mixer S {S} {name} (card vs cpu)",
                              [a.cpu()], [b], MIXER_TOL, ("tensor",))
            worst = max(worst, e)
        del got, st, want, wst
        with torch.inference_mode():
            ms = time_ms(lambda: ssm.mamba2_apply(cuda, f32, xd), iters=3,
                         warmup=1)
        out[S] = (ssm._chunk_len(cfg, S), worst, ms)
        log(f"mamba2 mixer (fp32, d {cfg.d_model}, S {S}, chunk "
            f"{out[S][0]}): card within {worst:.3g} of the CPU's largest "
            f"|entry| (<= {MIXER_TOL:g}); {ms:.2f} ms a call on the card")
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ssd_vs_reference(cfg, dev):
    """``ssd_chunked`` (chunk 256) against the per-step ``ssd_reference``
    on the card at mamba2's heads (B 1, S 4096, 64 heads of 64, G 1, N
    128), inputs drawn as the reference's test draws them: |got - want|
    <= SSD_ATOL + SSD_RTOL |want| for y and h.  Returns the worst of
    |got - want| / (SSD_ATOL + SSD_RTOL |want|)."""
    from repro_torch.models import ssm
    _, H, G, N, _ = ssm.mamba2_dims(cfg)
    S, P = SSM_LENS[0], cfg.ssm_head_dim
    gen = torch.Generator(device=dev).manual_seed(18)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x, dt = randn(1, S, H, P), torch.nn.functional.softplus(randn(1, S, H))
    A = -torch.exp(randn(H))
    Bm, Cm = 0.3 * randn(1, S, G, N), 0.3 * randn(1, S, G, N)
    with torch.inference_mode():
        got = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        want = ssm.ssd_reference(x, dt, A, Bm, Cm)
    worst = 0.0
    for name, a, b in zip(("y", "h"), got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"ssd_chunked: non-finite {name}")
        r = float(((a - b).abs() / (SSD_ATOL + SSD_RTOL * b.abs())).max())
        if r > 1.0:
            raise AssertionError(f"ssd_chunked {name} against ssd_reference: "
                                 f"{r:.3g} of the bound atol {SSD_ATOL:g} + "
                                 f"rtol {SSD_RTOL:g}")
        worst = max(worst, r)
    log(f"ssd_chunked (chunk {cfg.ssm_chunk}) against ssd_reference at S "
        f"{S}, {H} heads, N {N}: worst {worst:.3g} of atol {SSD_ATOL:g} + "
        f"rtol {SSD_RTOL:g} |reference|")
    return worst


def prefill_vs_decode(cfg, params, dev):
    """The first 2 layers of ``params`` widened to fp32: ``lm_prefill`` of
    a PREFILL_DECODE_LEN-token prompt (seed 0), then the same prompt token
    by token through ``lm_decode_step`` from zero state: the last logits
    within PREFILL_DECODE_TOL of the prefill's largest |logit|.  Returns
    that error."""
    from repro_torch.models import get_model
    from repro_torch.tree import tree_map
    two = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    fns = get_model(two)
    wide = tree_map(lambda t: t.float(),
                    {"embed": params["embed"],
                     "final_norm": params["final_norm"],
                     "layers": params["layers"][:2]})
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, PREFILL_DECODE_LEN)), device=dev)
    want, _, _ = fns.prefill(wide, two, {"tokens": tok}, GEMMA_MAX_LEN)
    caches = fns.init_caches(wide, two, 1, GEMMA_MAX_LEN)
    for i in range(PREFILL_DECODE_LEN):
        got, caches = fns.decode_step(
            wide, two, caches, tok[:, i],
            torch.full((1,), i, dtype=torch.int32, device=dev))
    e = float((got - want).abs().max() / want.abs().max())
    if not (torch.isfinite(got).all() and e <= PREFILL_DECODE_TOL):
        raise AssertionError(f"mamba2: decode's last logits {e:.3g} of max "
                             f"|prefill logit| from the prefill's (> "
                             f"{PREFILL_DECODE_TOL:g})")
    log(f"mamba2 (fp32, 2 layers): {PREFILL_DECODE_LEN} decode steps from "
        f"zero state end within {e:.3g} of the prefill's last logits (<= "
        f"{PREFILL_DECODE_TOL:g} of max |logit|)")
    del wide, caches
    return e


def prefill_ms(cfg, params, fns, S, dev, calls=2):
    """Median wall ms of one ``lm_prefill`` of a 1 x S prompt (after one
    warm-up call), a synchronize on each side."""
    tok = torch.as_tensor(np.random.default_rng(S).integers(
        0, cfg.vocab_size, (1, S)), device=dev)
    times = []
    for i in range(calls + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns.prefill(params, cfg, {"tokens": tok}, GEMMA_MAX_LEN)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    gc.collect()
    torch.cuda.empty_cache()
    return float(np.median(times))


class RepeatedBatch:
    """``ZipfLM(seed=0)``'s first batch at every step: a loss that falls
    over the steps then shows the updates descend, which the batch-to-batch
    spread of a fresh model's loss (11.2 and 9.2 on its first two batches
    at the same mamba2 weights) would hide."""

    def __init__(self, vocab, seq, batch):
        from repro_torch.data import ZipfLM
        self.zipf = ZipfLM(vocab_size=vocab, seq_len=seq,
                           batch_per_host=batch, seed=0)
        self.seq_len, self.batch_per_host = seq, batch

    def batch(self, step):
        return self.zipf.batch(0)


def family_train(label, cfg, params, dev, **checks):
    """``bf16_checks`` on ``ZipfLM(seed=0)``'s first 1 x 4096 batch, then
    3 in-place AdamW steps on that batch (:class:`RepeatedBatch`; peak
    1e-4, no warm-up: at 1e-3 one step took mamba2's loss from 11.2 to
    16.4) through ``train`` from ``params``, which they consume; the loss
    must fall.  Returns (launches, stats)."""
    import tempfile
    from repro_torch.train import (TrainConfig, TrainState, batch_to_device,
                                   make_optimizer)
    data = RepeatedBatch(cfg.vocab_size, SSM_TRAIN_SEQ, SSM_TRAIN_BATCH)
    batch = batch_to_device(data.batch(0), dev)
    loss_k, loss_p, peaks = bf16_checks(label, cfg, params, batch, **checks)
    del batch
    tmp = tempfile.TemporaryDirectory()
    tc = TrainConfig(ckpt_every=0, ckpt_dir=tmp.name, log_every=1, seed=0,
                     peak_lr=1e-4, warmup=0)
    state = TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                       params, make_optimizer(tc).init(params), None)
    del params
    with tmp:
        counts, stats = bf16_steps(label, cfg, tc, state, data,
                                   SSM_TRAIN_STEPS, loss_k, True,
                                   first_loss_plain=loss_p,
                                   grad_peak_above_weights_gib=peaks)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return counts, stats


def family_weights(arch, layers, family, dev):
    """(cfg, fns, params, draw seconds, parameter count) of ``arch`` cut to
    ``layers`` layers, bf16, seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if cfg.dtype != "bfloat16" or cfg.family != family or not cfg.remat:
        raise AssertionError(f"{arch}: a bf16 {family} config with remat")
    fns = get_model(cfg)
    params = fns.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    return (cfg, fns, params, time.perf_counter() - t0,
            sum(p.numel() for p in tree_leaves(params)))


def phase_ssm(dev):
    """18 (b).  ``mamba2-1.3b`` at full width (d 2048, d_inner 4096, 64
    heads, N 128, chunk 256), SSM_LAYERS layers, bf16, seed-0 weights:
    one mixer in fp32 on the card against the CPU at S 4096 and 4093
    (chunk 1), ``ssd_chunked`` against ``ssd_reference`` on the card,
    prefill against decode on 2 layers in fp32; ``lm_prefill`` ms at
    4096 and 4093; ``ServeEngine(slots=4, max_len=4096)`` on 8 greedy
    requests of 16 tokens, prompts 1000..3900 (seed 0, unbucketed); 3
    in-place AdamW steps at 1 x 4096 (remat and no remat gradients bit
    for bit, the loss falling).  No kernel runs on this path.  Returns
    the launches of serving and of training."""
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    cfg, fns, params, init_s, nparam = family_weights(SSM_ARCH, SSM_LAYERS,
                                                      "ssm", dev)
    mixer = mixer_vs_cpu(cfg, dev)
    ssd = ssd_vs_reference(cfg, dev)
    pd = prefill_vs_decode(cfg, params, dev)
    with torch.inference_mode():
        pre = {S: prefill_ms(cfg, params, fns, S, dev) for S in SSM_LENS}
    log(f"mamba2 ({cfg.num_layers} layers, bf16) lm_prefill of 1 x S: "
        + ", ".join(f"S {S} (chunk {mixer[S][0]}) {ms:.1f} ms"
                    for S, ms in pre.items()))

    work = bf16_prompts(cfg.vocab_size, *DENSE_PROMPTS, DENSE_REQUESTS)
    lens = [len(p) for _, p in work]
    if all(n % cfg.ssm_chunk == 0 for n in lens):
        raise AssertionError(f"mamba2: every prompt length {lens} is a "
                             f"multiple of {cfg.ssm_chunk}")
    logits = {}
    eng = teacher_forced(ServeEngine(cfg, params, slots=GEMMA_SLOTS,
                                     max_len=GEMMA_MAX_LEN), logits)
    if eng._bucket:
        raise AssertionError("mamba2: the engine buckets the prompts")
    torch.cuda.reset_peak_memory_stats()
    outs, stats, counts = run_engine(eng, work, fns, new_tokens=GEMMA_NEW)
    del eng
    if any(counts.values()):
        raise AssertionError(f"mamba2 serve launched kernels: {counts}")
    if not all(0 <= t < cfg.vocab_size for o in outs.values() for t in o):
        raise AssertionError("mamba2 serve: a token out of the vocabulary")
    from repro_torch.models.ssm import _chunk_len
    stats.update(arch=SSM_ARCH, layers=cfg.num_layers, params=nparam,
                 weights_s=init_s, prompt_lens=lens,
                 prompt_chunks=[_chunk_len(cfg, n) for n in lens],
                 prefill_ms_1x4096=pre[SSM_LENS[0]],
                 prefill_ms_1x4093=pre[SSM_LENS[1]],
                 mixer_vs_cpu={S: v[1] for S, v in mixer.items()},
                 mixer_ms={S: v[2] for S, v in mixer.items()},
                 ssd_vs_reference=ssd, prefill_vs_decode=pd,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"ssm serve: {json.dumps(stats)}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 18 (b) serving took {time.perf_counter() - t0:.1f}s, "
        f"weights {init_s:.1f}s")
    t1 = time.perf_counter()
    sp_counts, _ = sp_family_run("mamba2-1.3b sp d=2", cfg, params, fns,
                                 work, outs, logits, dev, False)
    del logits
    log(f"phase 21 (d) took {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    train_counts, _ = family_train("ssm train", cfg, params, dev,
                                   bit_exact=True, plain_grads=False)
    del params
    if any(train_counts.values()):
        raise AssertionError(f"mamba2 training launched kernels: "
                             f"{train_counts}")
    log(f"phase 18 (b) training took {time.perf_counter() - t1:.1f}s")
    return counts, train_counts, sp_counts


def phase_hybrid(dev):
    """18 (c).  ``zamba2-1.2b`` at full width (d 2048, 32 heads of 64,
    d_ff 8192, N 64, nr 16), HYBRID_LAYERS layers (two invocations of
    the shared block), bf16, seed-0 weights: ``ServeEngine(slots=4,
    max_len=4096)`` on phase 14's traffic, unbucketed (#1, #2, #5, #6
    launched, no plain version), then the plain run and the kernels on
    its tokens, every step's logits held to it (``forced_run``); 3
    in-place AdamW steps at 1 x 4096 after ``bf16_checks`` (the fp32
    gradient against the plain path; #3 and #4 launched exactly as the
    shared block runs them).  Returns the launches of serving and of
    training."""
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    cfg, fns, params, init_s, nparam = family_weights(
        HYBRID_ARCH, HYBRID_LAYERS, "hybrid", dev)
    work = bf16_prompts(cfg.vocab_size, *DENSE_PROMPTS, DENSE_REQUESTS)
    eng = ServeEngine(cfg, params, slots=GEMMA_SLOTS, max_len=GEMMA_MAX_LEN)
    if eng._bucket:
        raise AssertionError("zamba2: the engine buckets the prompts")
    torch.cuda.reset_peak_memory_stats()
    outs, stats, counts = run_engine(eng, work, fns, new_tokens=GEMMA_NEW)
    del eng
    stats.update(arch=HYBRID_ARCH, layers=cfg.num_layers, params=nparam,
                 weights_s=init_s, prompt_lens=[len(p) for _, p in work],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    need = ("band_attention_fwd[l0_causal]", "band_attention_sub_fwd",
            "decode_attend_fused[bf16]", "update_cache_fused[bf16]")
    missing = [k_ for k_ in need if not counts.get(k_)]
    if missing:
        raise AssertionError(f"zamba2: {missing} not launched: {counts}")
    log(f"hybrid serve: {json.dumps(stats)}")
    plain, plain_logits = plain_engine_run(
        cfg, params, work, GEMMA_SLOTS, GEMMA_MAX_LEN, GEMMA_NEW)
    same = sum(x == y for u in plain for x, y in zip(outs[u], plain[u]))
    log(f"zamba2: {same} of {GEMMA_NEW * len(work)} greedy tokens equal to "
        f"the plain run's")
    eng = ServeEngine(cfg, params, slots=GEMMA_SLOTS, max_len=GEMMA_MAX_LEN)
    forced_run("zamba2 dense", eng, work, fns, plain, plain_logits)
    del eng
    log(f"phase 18 (c) serving took {time.perf_counter() - t0:.1f}s, "
        f"weights {init_s:.1f}s")
    t1 = time.perf_counter()
    sp_counts, _ = sp_family_run("zamba2-1.2b sp d=2", cfg, params, fns,
                                 work, plain, plain_logits, dev, True)
    del plain_logits
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 21 (c) took {time.perf_counter() - t1:.1f}s")
    t1 = time.perf_counter()
    train_counts, _ = family_train("hybrid train", cfg, params, dev,
                                   grad_ctx=dict(leaf_tol=SSM_SUM_LEAVES))
    del params
    log(f"phase 18 (c) training took {time.perf_counter() - t1:.1f}s")
    return counts, train_counts, sp_counts


def phase_ssm_families(dev):
    """18 (b)-(c) ((a), the kernel rows at zamba2's shapes, runs with
    phase 17's), with 21 (c)-(d) on their weights before they train.
    Returns {"ssm", "ssm_train", "hybrid", "hybrid_train", "ssm_sp",
    "hybrid_sp": launches}."""
    ssm, ssm_train, ssm_sp = phase_ssm(dev)
    hybrid, hybrid_train, hybrid_sp = phase_hybrid(dev)
    return dict(ssm=ssm, ssm_train=ssm_train, hybrid=hybrid,
                hybrid_train=hybrid_train, ssm_sp=ssm_sp,
                hybrid_sp=hybrid_sp)


# ---------------------------------------------------------------------------
# phase 19: the encoder-decoder family (seamless-m4t-medium)
# ---------------------------------------------------------------------------

# seamless-m4t-medium at full width and depth (12 encoder and 12 decoder
# layers, 977.8 M parameters, 28-31 s to draw on the host), published bf16
ED_ARCH = "seamless-m4t-medium"
# the reference's train_4k frame axis for this config (launch/specs.py)
ED_FRAMES = 4096
# (b1): 4 clips of ED_FRAMES frames, an 8-token target prefix each, 32
# greedy tokens; (b2): 3 single clips of seeded frame counts in
# 1000..4000 (none a multiple of 16), seeded target prefixes of 100..300
# tokens (an 8-token prefix pads to one level-0 block, whose prefill runs
# no sub level: these run #2 at the decoder's coarse levels), 16 tokens
ED_CLIPS, ED_PREFIX, ED_NEW = 4, 8, 32
ED_SINGLE, ED_SINGLE_FRAMES, ED_SINGLE_PREFIX, ED_SINGLE_NEW = (
    3, (1000, 4000), (100, 300), 16)
# (c): 3 in-place AdamW steps at 1 x ED_FRAMES frames (live to a seeded
# length in 3000..4096) and DECODER_LEN target tokens, one repeated
# batch; the fp32 gradient against the plain path at 2 + 2 layers
ED_TRAIN_STEPS, ED_GRAD_LAYERS, ED_LIVE = 3, 2, (3000, 4096)
# the kernel rows at one clip's 16 heads (G 1, head_dim 64) and L 4096,
# their launches those of the phase 19 paths
ED_PATHS = ("encdec", "encdec_train")


def encdec_frames(cfg, B, Se, seed, dev):
    """Seeded stub frames (``models.encdec.stub_frames``), (B, Se, d) f32
    on ``dev``."""
    from repro_torch.models.encdec import stub_frames
    return torch.from_numpy(stub_frames(cfg, B, Se, seed=seed)[0]).to(dev)


def phase_encdec_kernels(dev):
    """19 (a).  #1 and #3 in ``l0_bidir`` and ``coarse_bidir`` (every
    coarse level 1..7, queries coarsened too, as the encoder runs them) at
    one seamless-m4t-medium clip's encoder attention: 16 rows (heads), G
    1, L 4096, d 64, q, k, v rounded to bf16 and widened as the bf16
    model widens them, keys live to a seeded true length in 3000..4096
    and padded past it.  Held to their plain versions with phases 2's and
    3's limits (the backward as :func:`family_bwd_compare` holds it);
    bounds from ``h1d_block.band_bytes`` (live rows), the all-rows bound
    beside; each level logged.  Rows ``<name>@seamless-m4t-medium``."""
    from repro_torch.analysis import contracts
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_block_bwd as hbb

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(30)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    hkv, d, Lf = 16, 64, ED_FRAMES
    live = int(torch.randint(ED_LIVE[0], ED_LIVE[1] + 1, (1,),
                             generator=gen, device=dev))
    q = (randn(hkv, 1, Lf, d) / math.sqrt(d)).to(bf).float()
    k = randn(hkv, Lf, d).to(bf).float()
    w = (torch.arange(Lf, device=dev) < live).float().expand(hkv, Lf)
    w = w.contiguous()
    v = randn(hkv, Lf, d).to(bf).float() * w[..., None]
    shape = f"{hkv} rows x G 1, L {Lf}, d {d}, keys live to {live}"
    rows = []
    for mode in ("l0_bidir", "coarse_bidir"):
        tot = {n: dict(err=0.0, scaled=0.0, gmn=0.0, ms=0.0, device_ms=0.0,
                       plain_ms=0.0, nbytes=0, all_bytes=0, all_flops=0,
                       flops=0, levels=[]) for n in ("fwd", "bwd")}
        levels = lra_levels(mode, q, k, v, w)
        for lvl, fwd in levels:
            Lq = fwd[0].shape[-2]
            out = hb.band_attention_fwd(*fwd, nr=NR, mode=mode)
            ef, *_ = compare(f"band_attention_fwd {mode}@{ED_ARCH} level "
                             f"{lvl}", out, hb.band_attention_fwd_ref(
                                 *fwd, nr=NR, mode=mode), ATTN_TOL)
            cot = tuple(randn(*t.shape) for t in out)
            args = (*fwd, *out, *cot)
            eb, sb, gb = family_bwd_compare(
                f"band_attention_bwd {mode}@{ED_ARCH} level {lvl}",
                hbb.band_attention_bwd(*args, nr=NR, mode=mode),
                hbb.band_attention_bwd_ref(*args, nr=NR, mode=mode), args)
            pairs = family_pairs(dev, mode, Lq, 1, fwd[3], Lq, 1)
            for n, e, kern, plain, per in (
                    ("fwd", ef, lambda: hb.band_attention_fwd(
                        *fwd, nr=NR, mode=mode),
                     lambda: hb.band_attention_fwd_ref(*fwd, nr=NR,
                                                       mode=mode),
                     4 * d + 3),
                    ("bwd", eb, lambda: hbb.band_attention_bwd(
                        *args, nr=NR, mode=mode),
                     lambda: hbb.band_attention_bwd_ref(*args, nr=NR,
                                                        mode=mode),
                     10 * d + 5)):
                t = tot[n]
                ms, dms = time_ms(kern), device_ms(kern)
                nbytes = hb.band_bytes(fwd[3], nr=NR, mode=mode, G=1, d=d,
                                       dv=d, backward=n == "bwd")
                all_bytes, all_flops = all_rows(getattr(
                    contracts, f"band_{n}")(*fwd, nr=NR, mode=mode))
                t["err"] = max(t["err"], e)
                t["ms"] += ms
                t["device_ms"] += dms
                t["plain_ms"] += time_ms(plain)
                t["nbytes"] += nbytes
                t["all_bytes"] += all_bytes
                t["all_flops"] += all_flops
                t["flops"] += pairs * per
                lb = bound(nbytes, pairs * per)[0]
                t["levels"].append(dict(level=lvl, L=Lq, device_ms=dms,
                                        bound_ms=lb))
                log(f"band_attention_{n} {mode}@{ED_ARCH} level {lvl} (L="
                    f"{Lq}): max abs err {e:.3g}; device {dms:.4f} ms, "
                    f"bound {lb:.5f} ms (live rows; every row "
                    f"{bound(all_bytes, all_flops)[0]:.5f})")
            tot["bwd"]["scaled"] = max(tot["bwd"]["scaled"], sb)
            tot["bwd"]["gmn"] = max(tot["bwd"]["gmn"], gb)
            del out, cot, args
        span = ("level 0" if len(levels) == 1 else
                f"the {len(levels)} coarse levels (L={Lf >> 1}.."
                f"{Lf >> len(levels)})")
        for n, name, src, rep in (
                ("fwd", "band_attention_fwd", "h1d_block.cu",
                 "h1d_block.py:299"),
                ("bwd", "band_attention_bwd", "h1d_block_bwd.cu",
                 "h1d_block_bwd.py:541")):
            t = tot[n]
            bms, by = bound(t["nbytes"], t["flops"])
            note = (f"sum over {span} of one clip's encoder attention, "
                    f"{shape}; " + (f"{BWD_LAUNCH}; " if n == "bwd" else "")
                    + LIVE_NOTE)
            row = dict(name=f"{name}[{mode}]@{ED_ARCH}", mode=mode,
                       route="cuda",
                       source=f"src/repro_torch/kernels/csrc/{src}",
                       replaces=f"src/repro/kernels/{rep}",
                       max_abs_err=t["err"], ms=t["ms"],
                       device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                       bound_ms=bms, bound_by=by, library_ms=None,
                       bound_all_rows_ms=bound(t["all_bytes"],
                                               t["all_flops"])[0],
                       levels=t["levels"], paths=list(ED_PATHS), note=note)
            if n == "bwd":
                row.update(max_scaled_err=t["scaled"],
                           gmn_elementwise_scaled_err=t["gmn"])
            rows.append(row)
            log(f"{row['name']}: max abs err {t['err']:.3g}, "
                f"{t['ms']:.4f} ms, device {t['device_ms']:.4f} ms, bound "
                f"{bms:.5f} ms, plain {t['plain_ms']:.3f} ms; {note}")
    del q, k, v, w
    torch.cuda.empty_cache()
    return rows


def encdec_generate(params, cfg, fns, frames, prefix, new, forced=None):
    """Greedy generation through the encoder-decoder's own entry points:
    ``prefill`` (the encoder, then the decoder over ``prefix``, Lmax
    DECODER_LEN), then ``new - 1`` decode steps; with ``forced`` (B, new)
    each step takes those tokens in place of its argmax, so that two runs
    handed the same tokens decode the same contexts.  A synchronize on
    each side of every call.  Returns (tokens (B, new), each step's
    logits (B, V) f32, the caches, prefill ms, each tick's ms)."""
    from repro_torch.configs.seamless_m4t_medium import DECODER_LEN

    def pick(z, i):
        return z.argmax(-1) if forced is None else forced[:, i]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches, pos = fns.prefill(
        params, cfg, {"frames": frames, "tokens": prefix}, DECODER_LEN)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    seen, toks, ticks = [logits], [pick(logits, 0)], []
    for i in range(1, new):
        t0 = time.perf_counter()
        logits, caches = fns.decode_step(params, cfg, caches, toks[-1], pos)
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0) * 1e3)
        seen.append(logits)
        toks.append(pick(logits, i))
        pos = pos + 1
    return torch.stack(toks, 1), seen, caches, prefill_ms, ticks


def encdec_vs_plain(label, got, want, caches, plain_caches):
    """Every step's logits of every row (the kernel run handed the plain
    run's tokens) within BF16_LOGIT_TOL of the plain row's largest
    |logit|, and every layer's encoder memory (``mem_k``, ``mem_v``)
    within it of the plain memory's largest |entry|.  Returns (worst at
    the prefill, worst at the decode steps, worst memory error, steps
    whose argmax is the plain one, steps)."""
    worst, same, n = [0.0, 0.0], 0, 0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{label}: step {i}: bad logits")
        e = ((a - b).abs().amax(-1) / b.abs().amax(-1)).max().item()
        if e > BF16_LOGIT_TOL:
            raise AssertionError(f"{label}: step {i}: logits differ by "
                                 f"{e:.3g} of max |plain| > "
                                 f"{BF16_LOGIT_TOL}")
        worst[i > 0] = max(worst[i > 0], e)
        same += int((a.argmax(-1) == b.argmax(-1)).sum())
        n += a.shape[0]
    mem = 0.0
    for li, (c, p) in enumerate(zip(caches, plain_caches)):
        for key in ("mem_k", "mem_v"):
            e = float((c[key] - p[key]).abs().max() / p[key].abs().max())
            if e > BF16_LOGIT_TOL:
                raise AssertionError(f"{label}: layer {li} {key} differs by "
                                     f"{e:.3g} of max |plain| > "
                                     f"{BF16_LOGIT_TOL}")
            mem = max(mem, e)
    return worst[0], worst[1], mem, same, n


def encdec_request(label, params, cfg, fns, frames, prefix, new, counts):
    """One serving request (or batch of clips): the plain run, then the
    kernels on its tokens (launches added into ``counts``), held to it
    with :func:`encdec_vs_plain`.  Returns the kernel run's numbers."""
    with plain_kernels():
        ptok, plogits, pcaches, _, _ = encdec_generate(
            params, cfg, fns, frames, prefix, new)
    one = {}
    with counted(one):
        tok, logits, caches, pre, ticks = encdec_generate(
            params, cfg, fns, frames, prefix, new, forced=ptok)
    for key_, c in one.items():
        counts[key_] = counts.get(key_, 0) + c
    need_launched(label, one, ())
    pre_e, dec_e, mem_e, same, n = encdec_vs_plain(label, logits, plogits,
                                                   caches, pcaches)
    if not bool(((tok >= 0) & (tok < cfg.vocab_size)).all()):
        raise AssertionError(f"{label}: a token out of the vocabulary")
    wall = pre + sum(ticks)
    out = dict(rows=int(frames.shape[0]), frames=int(frames.shape[1]),
               prefix=int(prefix.shape[1]), new_tokens=new,
               prefill_ms=pre, tick_ms=float(np.median(ticks)),
               tokens_per_s=tok.numel() / (wall / 1e3),
               logits_err_prefill=pre_e, logits_err_decode=dec_e,
               memory_err=mem_e, argmax_same=f"{same}/{n}")
    log(f"{label}: {json.dumps(out)}")
    del plogits, pcaches, logits, caches
    return out


def encdec_expected(cfg, steps: int, Se: int, Sd: int):
    """The band launches of ``steps`` rematerialised encdec steps: every
    layer's band forwards twice (the forward, then the recompute in the
    backward), its backwards once; an encoder layer runs ``l0_bidir`` and
    ``coarse_bidir`` at each of its coarse levels, a decoder layer
    ``l0_causal`` and the sub levels."""
    from repro_torch.core import hierarchy as hc
    enc = hc.num_levels(hc.padded_length(Se, cfg.nr), cfg.nr) - 1
    dec = hc.num_levels(hc.padded_length(Sd, cfg.nr), cfg.nr) - 1
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    per_step = {"band_attention_fwd[l0_bidir]": 2 * Le,
                "band_attention_bwd[l0_bidir]": Le,
                "band_attention_fwd[coarse_bidir]": 2 * Le * enc,
                "band_attention_bwd[coarse_bidir]": Le * enc,
                "band_attention_fwd[l0_causal]": 2 * Ld,
                "band_attention_bwd[l0_causal]": Ld,
                "band_attention_sub_fwd": 2 * Ld * dec,
                "band_attention_sub_bwd": Ld * dec}
    return {k_: n * steps for k_, n in per_step.items()}


class EncdecBatch:
    """One seeded encdec batch at every step (as :class:`RepeatedBatch`):
    1 x ED_FRAMES stub frames, ``frame_weight`` 0 past a seeded true
    length in ED_LIVE, DECODER_LEN target tokens from ``ZipfLM``."""

    def __init__(self, cfg):
        from repro_torch.configs.seamless_m4t_medium import DECODER_LEN
        from repro_torch.data import ZipfLM
        from repro_torch.models.encdec import stub_frames
        rng = np.random.default_rng(19)
        self.live = int(rng.integers(ED_LIVE[0], ED_LIVE[1] + 1))
        frames, fw = stub_frames(cfg, 1, ED_FRAMES, seed=19,
                                 true_len=[self.live])
        self.data = {"frames": frames, "frame_weight": fw,
                     "tokens": ZipfLM(vocab_size=cfg.vocab_size,
                                      seq_len=DECODER_LEN, batch_per_host=1,
                                      seed=0).batch(0)["tokens"]}
        self.seq_len, self.batch_per_host = DECODER_LEN, 1

    def batch(self, step):
        return self.data


def phase_encdec(dev):
    """19 (b)-(c).  ``seamless-m4t-medium`` at full width and depth (12 +
    12 layers, d 1024, 16 heads of 64, vocabulary 256206), bf16, seed-0
    weights drawn once: (b1) 4 clips of 4096 stub frames with an 8-token
    target prefix each, 32 greedy tokens at Lmax DECODER_LEN; (b2) 3
    single clips of 1000..4000 frames (the encoder pads them), prefixes
    of 100..300 tokens, 16 tokens each; each the plain run, then the
    kernels on its tokens: every step's logits and every layer's encoder
    memory within 3e-2 of max |plain|; #1 in ``l0_bidir``,
    ``coarse_bidir`` and ``l0_causal``, #2, #5 and #6 (bf16) launched, no
    plain version.  (c) on the same weights (which the steps consume) at
    1 x 4096 frames (live to a seeded length in 3000..4096) and 1024
    tokens: the loss on the kernels against the plain path within 2e-2;
    the fp32 gradient at 2 + 2 layers against the plain path (each leaf
    within GRAD_TOL of its largest |plain|); 3 in-place AdamW steps with
    remat through ``train``: the loss falls, each band path launched
    exactly as the steps run it, no plain version.  Returns {"encdec",
    "encdec_train": launches}."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.train import (TrainConfig, TrainState, batch_to_device,
                                   make_optimizer, tokens_per_s, train)
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    cfg = get_config(ED_ARCH)
    if not (cfg.dtype == "bfloat16" and cfg.family == "encdec"
            and cfg.remat and cfg.remat_policy == "dots"):
        raise AssertionError(f"{ED_ARCH}: a bf16 encdec config with remat")
    fns = get_model(cfg)
    params = fns.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nparam = sum(p.numel() for p in tree_leaves(params))
    log(f"{ED_ARCH}: {cfg.encoder_layers} + {cfg.num_layers} layers, "
        f"{nparam} parameters in {cfg.dtype}, drawn in {init_s:.1f}s")

    # (b) serving
    rng = np.random.default_rng(0)
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    frames = encdec_frames(cfg, ED_CLIPS, ED_FRAMES, 0, dev)
    prefix = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (ED_CLIPS, ED_PREFIX)), device=dev)
    b1 = encdec_request("encdec (b1)", params, cfg, fns, frames, prefix,
                        ED_NEW, counts)
    b2 = []
    lens = rng.integers(*ED_SINGLE_FRAMES, size=ED_SINGLE * 2)
    lens = [int(n) for n in lens if n % 16][:ED_SINGLE]
    for i, n in enumerate(lens):
        frames = encdec_frames(cfg, 1, n, 1 + i, dev)
        m = int(rng.integers(ED_SINGLE_PREFIX[0], ED_SINGLE_PREFIX[1] + 1))
        prefix = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, m)),
                                 device=dev)
        b2.append(encdec_request(f"encdec (b2) request {i}", params, cfg,
                                 fns, frames, prefix, ED_SINGLE_NEW, counts))
    del frames, prefix
    need_launched("encdec serve", counts,
                  [("band_attention_fwd", "l0_bidir"),
                   ("band_attention_fwd", "coarse_bidir"),
                   ("band_attention_fwd", "l0_causal"),
                   ("decode_attend_fused", "bf16"),
                   ("update_cache_fused", "bf16")])
    if not counts.get("band_attention_sub_fwd"):
        raise AssertionError(f"encdec serve: #2 not launched: {counts}")
    serve_stats = dict(arch=ED_ARCH, params=nparam, weights_s=init_s,
                       b1=b1, b2=b2,
                       peak_mem_gib=torch.cuda.max_memory_allocated()
                       / 2 ** 30)
    log(f"encdec serve: {json.dumps(serve_stats)}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 19 (b) took {time.perf_counter() - t0:.1f}s, weights "
        f"{init_s:.1f}s")

    # (c) training
    t1 = time.perf_counter()
    data = EncdecBatch(cfg)
    batch = batch_to_device(data.batch(0), dev)
    with torch.no_grad():
        loss_k = float(fns.loss(params, cfg, batch)[0])
        with plain_kernels():
            loss_p = float(fns.loss(params, cfg, batch)[0])
    if not abs(loss_k - loss_p) <= BF16_LOSS_TOL:
        raise AssertionError(f"encdec train: loss {loss_k} on the kernels, "
                             f"{loss_p} on the plain path")
    f32 = dataclasses.replace(cfg, dtype="float32",
                              encoder_layers=ED_GRAD_LAYERS,
                              num_layers=ED_GRAD_LAYERS)
    cut = {**params, "encoder": params["encoder"][:ED_GRAD_LAYERS],
           "decoder": params["decoder"][:ED_GRAD_LAYERS]}
    wide = tree_map(lambda p: p.float(), cut)
    grads_against_plain(f"encdec ({ED_GRAD_LAYERS} + {ED_GRAD_LAYERS} "
                        f"layers, fp32)", wide,
                        lambda p: fns.loss(p, f32, batch)[0])
    del cut, wide, batch
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.TemporaryDirectory()
    tc = TrainConfig(ckpt_every=0, ckpt_dir=tmp.name, log_every=1, seed=0,
                     peak_lr=1e-4, warmup=0)
    state = TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                       params, make_optimizer(tc).init(params), None)
    del params
    train_counts = {}
    with tmp, counted(train_counts):
        state, metrics = train(cfg, tc, data, ED_TRAIN_STEPS, state=state,
                               device=dev, log=log)
    del state
    need_counts("encdec train", train_counts,
                encdec_expected(cfg, ED_TRAIN_STEPS, ED_FRAMES,
                                data.seq_len))
    hist = metrics["history"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"encdec train: non-finite loss: {losses}")
    if abs(losses[0] - loss_k) > BF16_LOSS_TOL:
        raise AssertionError(f"encdec train: first step's loss {losses[0]} "
                             f"is not the batch's {loss_k}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"encdec train: the loss does not fall: "
                             f"{losses}")
    tokens = data.live + data.seq_len
    stats = dict(layers=[cfg.encoder_layers, cfg.num_layers],
                 frames=ED_FRAMES, live_frames=data.live,
                 target_tokens=data.seq_len, steps=ED_TRAIN_STEPS,
                 remat_policy=cfg.remat_policy, losses=losses,
                 first_loss_plain=loss_p,
                 first_step_ms=hist[0]["step_ms"],
                 median_step_ms=float(np.median([h["step_ms"]
                                                 for h in hist[1:]])),
                 tokens_per_s=tokens_per_s(hist, tokens),
                 peak_mem_gib=metrics["peak_mem_gib"],
                 launches={k_: train_counts.get(k_, 0) for k_ in
                           encdec_expected(cfg, 1, ED_FRAMES,
                                           data.seq_len)})
    log(f"encdec train: {json.dumps(stats)} (tokens/s counts the live "
        f"frames and the target tokens of a step)")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 19 (c) took {time.perf_counter() - t1:.1f}s")
    return {"encdec": counts, "encdec_train": train_counts}


# ---------------------------------------------------------------------------
# phase 20: telemetry through the serving and training CLIs
# ---------------------------------------------------------------------------

# h1d-lm-53m at full size through ``launch.serve`` at phase 4's settings
# (8 slots, max_len 2048, prompts 64..1500; the CLI's seed-0 weights and
# prompts), 16 greedy tokens: 8 requests dense, 4 in each of the
# int8-paged, fp32-paged and SP runs
TELEMETRY_SERVE = ("--arch", "h1d-lm-53m", "--slots", "8", "--new-tokens",
                   "16", "--max-len", "2048", "--min-prompt", "64",
                   "--max-prompt", "1500", "--seed", "0")
TELEMETRY_RUNS = (("dense", ("--requests", "8")),
                  ("paged int8", ("--requests", "4", "--paged",
                                  "--cache-dtype", "int8")),
                  ("paged fp32", ("--requests", "4", "--paged")),
                  ("sp d=2", ("--requests", "4", "--sp-data", "2")))
# ``launch.train`` on h1d-lm-53m: 2 steps at 2 x 1024
TELEMETRY_TRAIN = ("--arch", "h1d-lm-53m", "--steps", "2", "--batch", "2",
                   "--seq", "1024")
SERVE_PROM = ("repro_kernel_launches_total", "repro_serve_ttft_s_bucket",
              "repro_serve_itl_s_bucket", "repro_serve_ticks_total")
TRAIN_PROM = ("repro_kernel_launches_total", "repro_train_steps_total")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cli_run(main_fn, argv):
    """``main_fn(argv)`` with its standard output captured and logged;
    returns (its result, the output)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main_fn(list(argv))
    for line in buf.getvalue().splitlines():
        log(f"  {line}")
    return out, buf.getvalue()


def telemetry_run(label, main_fn, argv, prom_need, spans, tmp):
    """One CLI run with telemetry on, its launch records captured, and
    phase 20 (c)'s checks: the documents pass the port's validators (the
    trace with kernel traffic, no event dropped), every family's
    ``kernel.launches`` equals its wrappers' launches in the run and its
    ``kernel.hbm_*_bytes`` the traffic model's sum over the run's
    records, each band record's bytes ``band_bytes`` / ``sub_bytes``
    (:func:`band_bytes_check`), ``spans[0]`` spans number ``spans[1]``,
    no plain version ran.  Returns (result, output, the run's :func:`path_counts`,
    snapshot)."""
    from repro_torch import kernels, obs
    from repro_torch.analysis import contracts
    from repro_torch.obs import export, traffic
    obs.disable()
    obs.reset()
    kernels.reset_counts()
    with contracts.capture() as records:
        out, text = cli_run(main_fn, argv)
    torch.cuda.synchronize()
    obs.disable()
    launches = {n: k.launches for n, (k, _) in kernels.KERNELS.items()}
    plain = {n: p.calls for n, (_, p) in kernels.KERNELS.items() if p.calls}
    snap = export.snapshot()
    trace = json.loads((tmp / "trace.json").read_text())
    prom = ((tmp / "m.prom").read_text() if (tmp / "m.prom").exists()
            else export.prometheus_text())
    errs = (export.validate_chrome_trace(trace, require_kernel_traffic=True)
            + export.validate_snapshot(snap)
            + export.validate_prometheus_text(prom, prom_need))
    if (tmp / "m.jsonl").exists():
        for line in (tmp / "m.jsonl").read_text().splitlines():
            errs += export.validate_snapshot(json.loads(line))
    if trace["metadata"].get("dropped_events"):
        errs.append(f"{trace['metadata']['dropped_events']} trace events "
                    f"dropped")
    if plain:
        errs.append(f"plain versions ran: {plain}")
    c = snap["metrics"]["counters"]
    for name, fam in kernels.FAMILY.items():
        got = c.get(f"kernel.launches{{family={fam}}}", 0)
        recs = [r for r in records if r.family == fam]
        if got != launches[name] or len(recs) != got:
            errs.append(f"{fam}: kernel.launches {got}, {name}.launches "
                        f"{launches[name]}, {len(recs)} records")
        for d in ("read", "write"):
            want = sum(traffic.record_hbm_bytes(r)[f"{d}_bytes"]
                       for r in recs)
            if c.get(f"kernel.hbm_{d}_bytes{{family={fam}}}", 0) != want:
                errs.append(f"{fam}: kernel.hbm_{d}_bytes != {want}")
    errs += band_bytes_check(records, dev=torch.device("cuda"))
    nspans = sum(e["name"] == spans[0] for e in trace["traceEvents"])
    if nspans != c.get(spans[1]):
        errs.append(f"{nspans} {spans[0]} spans, {spans[1]} = "
                    f"{c.get(spans[1])}")
    if errs:
        raise AssertionError(f"telemetry {label}: {errs}")
    obs.reset()
    return out, text, path_counts(), snap


def band_bytes_check(records, dev):
    """Each distinct band record of a run (#1-#4) held to the count made
    apart from the traffic model: ``band_bytes`` / ``sub_bytes`` (the sub
    body at ratio 1 in ``coarse_causal``) on all-ones key weights of the
    record's shapes, on the card.  Returns the disagreements."""
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.obs import traffic
    errs = []
    seen = set()
    for r in records:
        if r.family not in ("band_fwd", "sub_fwd", "band_bwd", "sub_bwd") \
                or id(r) in seen:
            continue
        seen.add(id(r))
        B, G, _, d = r.operand("q").shape
        m = r.meta
        w = torch.ones(r.operand("w").shape, device=dev)
        kw = dict(nr=m["nr"], G=G, d=d, dv=m["dv"],
                  backward=r.family.endswith("_bwd"))
        if m["mode"] in ("sub", "coarse_causal"):
            want = hb.sub_bytes(w, ratio=m["ratio"], **kw)
        else:
            want = hb.band_bytes(w, mode=m["mode"], **kw)
        b = traffic.record_hbm_bytes(r)
        if b["read_bytes"] + b["write_bytes"] != want:
            errs.append(f"{r.describe()}: traffic {b}, band/sub_bytes "
                        f"{want}")
    return errs


def hook_cost_us(dev, calls: int = 500):
    """Host microseconds a ``decode_attend_fused`` call takes at the
    serving shape (64 rows, Lmax 2048) with telemetry off and on, in
    turns (off, on, off, on; each ``calls`` calls ending in a
    synchronize): the difference is what the launch record and its
    accounting cost a launch."""
    from repro_torch import obs
    from repro_torch.core import h1d_decode as hd
    from repro_torch.kernels import h1d_decode_kernel as dk
    gen = torch.Generator(device=dev).manual_seed(20)
    cache = hd.prefill_cache(
        torch.randn((R, LMAX, D), generator=gen, device=dev),
        torch.randn((R, LMAX, D), generator=gen, device=dev), LMAX, NR)
    q = torch.randn((R, G, D), generator=gen, device=dev)
    t = torch.randint(0, LMAX, (R,), generator=gen, device=dev,
                      dtype=torch.int32)
    out = {"off": [], "on": []}
    for mode in ("off", "on", "off", "on"):
        (obs.enable if mode == "on" else obs.disable)()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            dk.decode_attend_fused(cache, q, t, nr=NR)
        torch.cuda.synchronize()
        out[mode].append((time.perf_counter() - t0) / calls * 1e6)
    obs.disable()
    obs.reset()
    return out


def phase_telemetry(dev):
    """20.  ``repro_torch.obs`` on the card through the CLIs: the dense,
    int8-paged, fp32-paged and SP serving runs of ``TELEMETRY_RUNS`` with
    every telemetry option writing into a temporary directory, and
    ``TELEMETRY_TRAIN`` with ``--telemetry --trace-out``; each held by
    :func:`telemetry_run`, the runs together launching all twelve
    families.  The dense run also with telemetry off (a warm-up, then
    three turns of off and ``--telemetry`` alone): every run's greedy
    tokens equal the first's.  Logs TTFT, ITL, ticks and tokens/s, the
    per-launch cost (:func:`hook_cost_us`), and per family the launches,
    GB moved and GFLOP, each beside the card's name and power limit.
    Returns the launches by kernel row over the checked runs
    (:func:`path_counts`)."""
    import re
    import tempfile

    from repro_torch import kernels, obs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    card = card_line()
    t0 = time.perf_counter()
    total = collections.Counter()
    fams = collections.Counter()

    def rate(text):
        return float(re.search(r"\(([0-9.]+) tok/s\)", text).group(1))

    def dense_run(*extra):
        reqs, text = cli_run(serve_cli.main, TELEMETRY_SERVE
                             + TELEMETRY_RUNS[0][1] + extra)
        obs.disable()
        obs.reset()
        return [r.out_tokens for r in reqs], rate(text)

    tokens_off, _ = dense_run()             # warm-up
    rates = {"off": [], "on": []}
    for _ in range(3):
        for mode, extra in (("off", ()), ("on", ("--telemetry",))):
            tokens, r = dense_run(*extra)
            if tokens != tokens_off:
                raise AssertionError(f"telemetry {mode}: dense greedy tokens "
                                     f"differ from the first run's")
            rates[mode].append(r)
    log(f"telemetry dense tok/s: off {rates['off']}, on {rates['on']}, "
        f"median off {np.median(rates['off'])}, on "
        f"{np.median(rates['on'])} ({card})")
    cost = hook_cost_us(dev)
    log(f"telemetry decode_attend_fused call, host us (64 rows, Lmax "
        f"{LMAX}): off {[round(x, 2) for x in cost['off']]}, on "
        f"{[round(x, 2) for x in cost['on']]}, difference of the means "
        f"{np.mean(cost['on']) - np.mean(cost['off']):.2f} ({card})")
    for label, extra in TELEMETRY_RUNS:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            argv = (TELEMETRY_SERVE + extra + (
                "--trace-out", str(tmp / "trace.json"), "--prom-out",
                str(tmp / "m.prom"), "--metrics-jsonl", str(tmp / "m.jsonl"),
                "--metrics-period", "1"))
            reqs, text, counts, snap = telemetry_run(
                label, serve_cli.main, argv, SERVE_PROM,
                ("serve.tick", "serve.ticks"), tmp)
        hs, cs = snap["metrics"]["histograms"], snap["metrics"]["counters"]
        if label == "dense" and [r.out_tokens for r in reqs] != tokens_off:
            raise AssertionError("telemetry dense: greedy tokens differ "
                                 "from the run with telemetry off")
        lat = {n: (hs[n]["p50"] * 1e3, hs[n]["p99"] * 1e3)
               for n in ("serve.ttft_s", "serve.itl_s")}
        log(f"telemetry {label}: {len(reqs)} requests, TTFT p50 "
            f"{lat['serve.ttft_s'][0]:.3f} ms p99 "
            f"{lat['serve.ttft_s'][1]:.3f} ms, ITL p50 "
            f"{lat['serve.itl_s'][0]:.3f} ms p99 "
            f"{lat['serve.itl_s'][1]:.3f} ms, ticks {cs['serve.ticks']}, "
            f"{rate(text)} tok/s ({card})")
        total.update(counts)
        fams.update({k: v for k, v in cs.items() if k.startswith("kernel.")})
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _, _, counts, snap = telemetry_run(
            "train", train_cli.main, TELEMETRY_TRAIN + (
                "--telemetry", "--trace-out", str(tmp / "trace.json"),
                "--ckpt-dir", str(tmp / "ckpt")),
            TRAIN_PROM, ("train.step", "train.steps"), tmp)
    h = snap["metrics"]["histograms"]["train.step_s"]
    log(f"telemetry train: {snap['metrics']['counters']['train.steps']} "
        f"steps, step p50 {h['p50'] * 1e3:.1f} ms, loss "
        f"{snap['metrics']['gauges']['train.loss']:.4f} ({card})")
    total.update(counts)
    fams.update({k: v for k, v in snap["metrics"]["counters"].items()
                 if k.startswith("kernel.")})
    missing = [f for f in kernels.FAMILY.values()
               if not fams.get(f"kernel.launches{{family={f}}}")]
    if missing:
        raise AssertionError(f"telemetry: families never launched: "
                             f"{missing}")
    for f in kernels.FAMILY.values():
        moved = (fams[f"kernel.hbm_read_bytes{{family={f}}}"]
                 + fams[f"kernel.hbm_write_bytes{{family={f}}}"])
        log(f"telemetry {f}: {fams[f'kernel.launches{{family={f}}}']} "
            f"launches, {moved / 1e9:.4f} GB, "
            f"{fams[f'kernel.flops{{family={f}}}'] / 1e9:.4f} GFLOP "
            f"(all rows; {card})")
    log(f"phase 20 (telemetry) took {time.perf_counter() - t0:.1f}s")
    return dict(total)


# ---------------------------------------------------------------------------
# phase 21: SP serving of the sliding-window, SSM and hybrid configs
# ---------------------------------------------------------------------------

SP_FAMILY_D = 2
# gemma3-4b cut to one 5:1 local/global period (6 layers) of phase 12's
# weights; zamba2-1.2b and mamba2-1.3b at phase 18's
# depths on phase 18's weights, served before those weights train
SP_GEMMA_LAYERS = 6
# the decode kernels at the shapes these SP paths give them: (arch,
# rows = 4 slots x kv-heads, G, head_dim, the phase-21 path)
SP_FAMILY_SHAPES = (("gemma3-4b", 16, 2, 256, "gemma_sp"),
                    ("zamba2-1.2b", 128, 1, 64, "hybrid_sp"))
# the streamed #1 per shard in gemma's SP prefill: one prompt's 4
# kv-heads x G 2, a 1782-token prompt padded to 2048 -> 1024 rows a shard
# at d = 2, window (nr) 1024, head_dim 256, keys live to 758 on shard 1
SP_STREAM = (4, 2, 2048, 1024, 256, 1782)


def phase_sp_family_kernels(dev):
    """21 (a).  #11 and #12 on bf16 slabs against their plain versions on
    every shard at d = 2, Lmax 4096, at gemma3-4b's decode shape (16 rows,
    G 2, D 256) and zamba2-1.2b's (128 rows, G 1, D 64): attends within
    ATTN_TOL on the f32 triple, updates and carries bit for bit over 3
    chained appends, each timed as shard 1's call; the streamed #1 at
    the per-shard shape of gemma's SP prefill (``SP_STREAM``), held to
    its plain version on each shard's slab, and the whole SP band
    (``sp_band_attention``: the local launches and the halo edge term)
    to the plain version of the unsharded level, y / dn within
    SP_OP_FWD_TOL row-scaled,
    timed on shard 1 beside the plain version and
    ``scaled_dot_product_attention``.  Rows ``<name>@<arch>-sp``; their
    launches are those of the phase 21 path that runs the shape."""
    from repro_torch.core import h1d_decode as hd
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_decode_kernel as dk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sp_attention as sp

    bf = torch.bfloat16
    Lb, d = BF16_LMAX, SP_FAMILY_D
    Lloc = Lb // d
    gen = torch.Generator(device=dev).manual_seed(32)
    mesh = make_mesh((d,), ("data",), device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = []

    def add(name, src, replaces, arch, path, numbers, note, **extra):
        rows.append(dict(name=f"{name}@{arch}-sp", route="cuda",
                         source=f"src/repro_torch/kernels/csrc/{src}",
                         replaces=f"src/repro/kernels/{replaces}",
                         paths=[path], note=note, **numbers, **extra))
        log(f"{name}@{arch}-sp: max abs err {numbers['max_abs_err']:.3g}, "
            f"{numbers['ms']:.4f} ms, device {numbers['device_ms']:.4f} "
            f"ms, bound {numbers['bound_ms']:.5f} ms, plain "
            f"{numbers['plain_ms']:.3f} ms; {note}")

    def timed(kernel, plain, err, bms_by, library=None):
        return dict(max_abs_err=err, ms=time_ms(kernel),
                    device_ms=device_ms(kernel), plain_ms=time_ms(plain),
                    bound_ms=bms_by[0], bound_by=bms_by[1],
                    library_ms=None if library is None else time_ms(library))

    def slab(c, nsh):
        return hd.H1DCache(c.k.clone(), c.v.clone(),
                           tuple(x.clone() for x in c.ck[:nsh - 1]),
                           tuple(x.clone() for x in c.cv[:nsh - 1]))

    for arch, Rb, Gb, Db, path in SP_FAMILY_SHAPES:
        cache = hd.prefill_cache(randn(Rb, Lb, Db).to(bf),
                                 randn(Rb, Lb, Db).to(bf), Lb, NR)
        q = randn(Rb, Gb, Db).to(bf).float()
        t = torch.randint(0, Lb, (Rb,), generator=gen, device=dev,
                          dtype=torch.int32)
        edges = [0, NR - 1, NR, Lloc - 1, Lloc, Lb - 1]
        t[:len(edges)] = torch.tensor(edges, dtype=torch.int32)
        sc = sp.shard_cache(cache, mesh, NR)
        tabs = sp.sp_tables(t.cpu().numpy(), nr=NR, Lmax=Lb, d=d, device=dev)
        nsh = sp.sp_sharded_levels(Lb, NR, d)
        nlev = 1 + len(cache.ck)
        small = 4 * (q.numel() + Rb + Rb * Gb * Db)
        kn, vn = randn(Rb, Db).to(bf), randn(Rb, Db).to(bf)
        err = 0.0
        for s, sh in enumerate(sc.shards):
            args = (sh, q, t, tabs.bidx[s], tabs.owned[s])
            e, *_ = compare(f"decode_attend_partial[bf16] {arch} shard {s}",
                            dk.decode_attend_partial(*args, nr=NR),
                            dk.decode_attend_partial_ref(*args, nr=NR),
                            ATTN_TOL)
            err = max(err, e)
            a, b = slab(sh, nsh), slab(sh, nsh)
            for step in range(3):
                tt = (t + step).clamp(max=Lb - 1)
                tl = sp.sp_tables(tt.cpu().numpy(), nr=NR, Lmax=Lb, d=d,
                                  device=dev)
                upd = (kn, vn * (step + 1), tl.t_loc[s], tl.upd_owned[s])
                _, ak, av = dk.update_cache_partial(a, *upd)
                _, bk, bv = dk.update_cache_partial_ref(b, *upd)
                if not all(torch.equal(x, y) for x, y in zip(
                        (*pool_arrays(a), ak, av), (*pool_arrays(b), bk, bv))):
                    raise AssertionError(f"update_cache_partial[bf16] {arch} "
                                         f"shard {s}: not bit-exact")
        sh = sc.shards[1]
        args = (sh, q, t, tabs.bidx[1], tabs.owned[1])
        pkeys = partial_keys(t, tabs.owned[1], nlev)
        add("decode_attend_partial[bf16]", "h1d_decode.cu",
            "h1d_decode_kernel.py:267", arch, path,
            timed(lambda: dk.decode_attend_partial(*args, nr=NR),
                  lambda: dk.decode_attend_partial_ref(*args, nr=NR), err,
                  bound(pkeys * 2 * Db * 2 + small
                        + 4 * Rb * (2 + 2 * (nlev + 1)),
                        pkeys * Gb * (4 * Db + 4))),
            f"every shard at d = {d} within ATTN_TOL; timed: shard 1's "
            f"call, {pkeys} band keys owned and unmasked",
            R=Rb, G=Gb, D=Db)
        a, b = slab(sh, nsh), slab(sh, nsh)
        upd = (kn, vn, tabs.t_loc[1], tabs.upd_owned[1])
        own = int(tabs.upd_owned[1].sum())
        add("update_cache_partial[bf16]", "h1d_decode.cu",
            "h1d_decode_kernel.py:807", arch, path,
            timed(lambda: dk.update_cache_partial(a, *upd),
                  lambda: dk.update_cache_partial_ref(b, *upd), 0.0,
                  bound(4 * (2 * own * Db + 2 * Rb)
                        + 2 * (own * nsh * 2 * 2 * Db
                               + (Rb - own) * 2 * 2 * Db + 2 * Rb * Db),
                        (own * nsh + Rb - own) * 2 * Db)),
            f"every shard at d = {d} bit for bit over 3 chained appends; "
            f"timed: shard 1's call, {nsh} sharded levels, {own} of {Rb} "
            f"rows its own",
            R=Rb, G=Gb, D=Db)
        del cache, sc, tabs, a, b
        torch.cuda.empty_cache()

    # the streamed #1 per shard, and the whole SP band at gemma's window
    Bs, Gs, Ls, nr, ds, live = SP_STREAM
    if hb.check_window_fwd("l0_causal", nr, ds, ds) != "stream":
        raise AssertionError(f"nr={nr}, d={ds} is not on the streamed body")
    q = (randn(Bs, Gs, Ls, ds) / math.sqrt(ds))
    k = randn(Bs, Ls, ds)
    w = torch.ones((Bs, Ls), device=dev)
    w[:, live:] = 0.0
    v = randn(Bs, Ls, ds) * w[..., None]
    # the normalised output the local layer takes (y / dn), row-scaled as
    # phase 9 holds the SP operator: the halo merge rescales each row's
    # unnormalised sums by another exponent
    z = [y / dn.clamp(min=1e-9)[..., None] for y, dn, _ in (
        sp.sp_band_attention(q, k, v, w, nr=nr, mode="l0_causal",
                             mesh=mesh),
        hb.band_attention_fwd_ref(q, k, v, w, nr=nr))]
    op_err, op_scaled, _ = compare(
        f"sp_band_attention l0_causal nr={nr} d={ds} L={Ls} at d={d} "
        f"(y / dn)", z[:1], z[1:], SP_OP_FWD_TOL, ("row",))
    del z
    L1 = Ls // d
    shards = [(q[:, :, s * L1:(s + 1) * L1].contiguous(),
               k[:, s * L1:(s + 1) * L1].contiguous(),
               v[:, s * L1:(s + 1) * L1].contiguous(),
               w[:, s * L1:(s + 1) * L1].contiguous()) for s in range(d)]
    err = 0.0
    for s, sargs in enumerate(shards):
        e, *_ = compare(f"band_attention_fwd[l0_causal_stream] shard {s} "
                        f"L={L1}", hb.band_attention_fwd(*sargs, nr=nr),
                        hb.band_attention_fwd_ref(*sargs, nr=nr), ATTN_TOL)
        err = max(err, e)
    sargs = shards[1]
    ws = sargs[3]
    i = torch.arange(L1, device=dev)
    allow = hb.band_mask(i[:, None], i[None, :], nr, "l0_causal", L1)
    mask = (allow[None] & (ws > 0)[:, None, :])[:, None]
    kx = sargs[1][:, None].expand(Bs, Gs, L1, ds).contiguous()
    vx = sargs[2][:, None].expand(Bs, Gs, L1, ds).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    add("band_attention_fwd[l0_causal_stream]", "h1d_block.cu",
        "h1d_block.py:299", "gemma3-4b", "gemma_sp",
        timed(lambda: hb.band_attention_fwd(*sargs, nr=nr),
              lambda: hb.band_attention_fwd_ref(*sargs, nr=nr), err,
              bound(hb.band_bytes(ws, nr=nr, mode="l0_causal", G=Gs, d=ds,
                                  dv=ds),
                    causal_pairs(ws, nr) * Gs * (4 * ds + 3)),
              library=lambda: sdpa(sargs[0], kx, vx, attn_mask=mask,
                                   scale=1.0)),
        f"{Bs} x G {Gs} x L {L1} a shard (a {live}-token prompt padded to "
        f"{Ls}, d = {d}), nr {nr}, d {ds}, every shard within ATTN_TOL; "
        f"timed: shard 1 (keys live to {live - L1}); the whole SP band "
        f"(launches + halo edge term), y / dn, within {op_scaled:.3g} "
        f"row-scaled of the plain unsharded level's (<= {SP_OP_FWD_TOL}); "
        f"library_ms: "
        f"scaled_dot_product_attention with the same mask, timed here only",
        mode="l0_causal", sp_op_max_abs_err=op_err,
        sp_op_scaled_err=op_scaled)
    del q, k, v, w, shards, sargs, kx, vx, mask
    torch.cuda.empty_cache()
    return rows


def sp_family_run(label, cfg, params, fns, work, tokens, ref_logits, dev,
                  sharded: bool):
    """One of 21 (b)-(d): ``ServeEngine(slots=4, max_len=4096,
    mesh=make_mesh((2,), ...))`` on ``work`` with every request handed the
    mesh-free run's ``tokens``, every step's logits held to the mesh-free
    run's ``ref_logits`` (:func:`forced_run`, BF16_LOGIT_TOL), telemetry
    on.  ``sharded``: #11 and #12 launched in bf16, #5 never, the SP band
    or operator dispatched at prefill, every hierarchical cache sharded;
    else (mamba2) no cache sharded, no dispatch and no kernel launched.
    Every family's ``kernel.launches`` equals its wrappers' launches.
    Returns (the run's launches, its SP dispatches by operation)."""
    from repro_torch import kernels, obs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import export
    from repro_torch.parallel import sp_attention as sp
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, slots=GEMMA_SLOTS, max_len=GEMMA_MAX_LEN,
                      mesh=make_mesh((SP_FAMILY_D,), ("data",), device=dev))
    kinds = collections.Counter(type(c).__name__ for c in eng.caches)
    obs.disable()
    obs.reset()
    sp.DISPATCHES.clear()
    obs.enable()
    stats, counts = forced_run(label, eng, work, fns, tokens, ref_logits)
    torch.cuda.synchronize()
    obs.disable()
    c = export.snapshot()["metrics"]["counters"]
    launches = {n: k.launches for n, (k, _) in kernels.KERNELS.items()}
    bad = {fam: (c.get(f"kernel.launches{{family={fam}}}", 0),
                 launches[name])
           for name, fam in kernels.FAMILY.items()
           if c.get(f"kernel.launches{{family={fam}}}", 0) != launches[name]}
    if bad:
        raise AssertionError(f"{label}: kernel.launches (telemetry, "
                             f"wrappers) differ: {bad}")
    obs.reset()
    dispatches = dict(sp.DISPATCHES)
    if sharded:
        need = ("decode_attend_partial[bf16]", "update_cache_partial[bf16]")
        missing = [k_ for k_ in need if not counts.get(k_)]
        fused = (counts.get("decode_attend_fused", 0)
                 + counts.get("decode_attend_fused[bf16]", 0))
        if missing or fused or not kinds.get("SPCache") \
                or kinds.get("H1DCache") or not dispatches:
            raise AssertionError(f"{label}: {missing} not launched, "
                                 f"decode_attend_fused {fused}, caches "
                                 f"{dict(kinds)}, dispatches {dispatches}: "
                                 f"{counts}")
    elif any(counts.values()) or dispatches or kinds.get("SPCache"):
        raise AssertionError(f"{label}: launches {counts}, dispatches "
                             f"{dispatches}, caches {dict(kinds)}")
    log(f"{label}: caches {dict(kinds)}, SP dispatches {dispatches}, "
        f"telemetry launches equal to the wrappers' "
        f"({sum(launches.values())}); tokens/s {stats['tokens_per_s']:.1f}, "
        f"decode ms a tick {stats['decode_ms_per_tick']:.2f}, prefill ms a "
        f"call {stats['prefill_ms_per_call']:.1f} ({card_line()})")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dispatches


def phase_sp_gemma(dev, params):
    """21 (b).  ``gemma3-4b`` at full width in bf16, SP_GEMMA_LAYERS
    layers of phase 12's weights (one local/global period: 5 local layers
    at window 1024, 1 global h1d): the mesh-free engine on phase 18's
    traffic (8 requests of 16 tokens, prompts 1000..3900, seed 0; those
    padded to 2048 or 4096 take the SP band per shard under the mesh),
    then :func:`sp_family_run` at d = 2 on its tokens.  Returns the SP
    run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("gemma3-4b"),
                              num_layers=SP_GEMMA_LAYERS)
    cut = dict(params, layers=params["layers"][:SP_GEMMA_LAYERS])
    fns = get_model(cfg)
    work = bf16_prompts(cfg.vocab_size, *DENSE_PROMPTS, DENSE_REQUESTS)
    lens = [len(p) for _, p in work]
    if not any(-(-n // cfg.sliding_window) * cfg.sliding_window
               // SP_FAMILY_D % cfg.sliding_window == 0 for n in lens):
        raise AssertionError(f"gemma sp: no prompt of {lens} keeps a whole "
                             f"window a shard")
    logits = {}
    eng = teacher_forced(ServeEngine(cfg, cut, slots=GEMMA_SLOTS,
                                     max_len=GEMMA_MAX_LEN), logits)
    outs, stats, _ = run_engine(eng, work, fns, new_tokens=GEMMA_NEW)
    del eng
    log(f"gemma sp: mesh-free run of {cfg.num_layers} layers, tokens/s "
        f"{stats['tokens_per_s']:.1f}")
    counts, dispatches = sp_family_run("gemma3-4b sp d=2", cfg, cut, fns,
                                       work, outs, logits, dev, True)
    # the local layers' band under SP (the global layers' operator counts
    # as h1d_attention), on the streamed body per shard
    if not (counts.get("band_attention_fwd[l0_causal_stream]")
            and dispatches.get("band_attention")):
        raise AssertionError(f"gemma sp: the local layers' SP band never "
                             f"ran: {counts}, {dispatches}")
    del logits, cut
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 21 (b) took {time.perf_counter() - t0:.1f}s")
    return counts



# ---------------------------------------------------------------------------
# phase 22: the kernels section of analysis/ on the card
# ---------------------------------------------------------------------------

# (a)'s runs: launch.serve on h1d-lm-53m dense, paged int8, paged fp32 and
# SP d=2 (2 requests of 64..1500 tokens, 4 new tokens each), then
# launch.train one step at 2 x 1024; the bf16 decode at yi-6b's shape
KSEC_SERVE = ("--arch", "h1d-lm-53m", "--slots", "2", "--new-tokens", "4",
              "--max-len", "2048", "--min-prompt", "64", "--max-prompt",
              "1500", "--seed", "0", "--requests", "2")
KSEC_RUNS = ((), ("--paged", "--cache-dtype", "int8"), ("--paged",),
             ("--sp-data", "2"))
KSEC_TRAIN = ("--arch", "h1d-lm-53m", "--steps", "1", "--batch", "2",
              "--seq", "1024")
# the bf16 decode: 16 rows (4 slots x 4 kv-heads), G 8, head_dim 128
KSEC_BF16 = (16, 8, 128)


def ksec_records(dev, tmp):
    """22 (a): one ``contracts.capture()`` around the runs of
    ``KSEC_RUNS`` / ``KSEC_TRAIN`` and the bf16 decode, under a fresh
    policy over an empty table directory whose resolutions (one a
    launch) are counted by (family, source).  Returns (records, launches by record, counts)."""
    from repro_torch.analysis import contracts
    from repro_torch.core import h1d_decode as hd
    from repro_torch.kernels import h1d_decode_kernel as dk
    from repro_torch.kernels import tuning
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli

    policy = tuning.KernelPolicy(cache_dir=str(tmp / "empty"))
    sources = collections.Counter()
    resolve = policy.resolve

    def counted(family, **kw):
        cfg, source = resolve(family, **kw)
        sources[(family, source)] += 1
        return cfg, source
    policy.resolve = counted
    prev = tuning.set_policy(policy)
    try:
        with contracts.capture() as recs:
            for extra in KSEC_RUNS:
                cli_run(serve_cli.main, KSEC_SERVE + extra)
            cli_run(train_cli.main, KSEC_TRAIN + (
                "--ckpt-dir", str(tmp / "ckpt")))
            rows, g, d = KSEC_BF16
            gen = torch.Generator(device=dev).manual_seed(22)
            cache = hd.init_cache(rows, LMAX, d, d, NR, dtype=torch.bfloat16,
                                  device=dev)
            t = torch.full((rows,), 700, dtype=torch.int32, device=dev)
            for _ in range(2):
                kn = torch.randn((rows, d), generator=gen, device=dev)
                dk.update_cache_fused(cache, kn, kn, t)
                dk.decode_attend_fused(cache, torch.randn(
                    (rows, g, d), generator=gen, device=dev), t, nr=NR)
                t += 1
    finally:
        tuning.set_policy(prev)
    by_id = collections.Counter(id(r) for r in recs)
    unique = list({id(r): r for r in recs}.values())
    return unique, by_id, sources


def ksec_forced(dev):
    """22 (b): every candidate of ``band_fwd``, ``band_bwd`` (l0_causal)
    and ``sub_bwd`` (every sub level) at the LM's training shape forced
    through ``tq=``, and every stage plan of #7 and #8 at the paged
    serving shape forced through a table entry, each against its plain
    version (1e-5 forward and attends, 1e-4 backward).  Returns
    {family: [(tile, max scaled error), ...]}."""
    from repro_torch.core import hierarchy as hc
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_block_bwd as hbb
    from repro_torch.kernels import h1d_decode_kernel as dk
    from repro_torch.kernels import tuning

    _, randn, q, k, v, w = band_inputs(dev)
    rows3 = ("row", "row", "row")
    out = collections.defaultdict(list)
    pol = tuning.get_policy()
    shape = dict(L=L, nr=NR, mode="l0_causal", B=B, G=G, d=D, dv=D)
    want = hb.band_attention_fwd_ref(q, k, v, w, nr=NR, mode="l0_causal")
    for cand in pol.candidates("band_fwd", **shape):
        tile = tuning.tile_of(cand)
        got = hb.band_attention_fwd(q, k, v, w, nr=NR, mode="l0_causal",
                                    tq=tile)
        out["band_fwd"].append((tile, compare(
            f"band_attention_fwd tq={tile}", got, want, ATTN_TOL)[1]))
    cot = tuple(randn(*t.shape) for t in want)
    args = (q, k, v, w, *want, *cot)
    plain = hbb.band_attention_bwd_ref(*args, nr=NR, mode="l0_causal")
    for cand in pol.candidates("band_bwd", **shape):
        tile = tuning.tile_of(cand)
        got = hbb.band_attention_bwd(*args, nr=NR, mode="l0_causal", tq=tile)
        out["band_bwd"].append((tile, compare(
            f"band_attention_bwd tq={tile}", got, plain, GRAD_TOL,
            rows3)[1]))
    kc, vc, wc = k, v, w
    for lvl in range(1, hc.num_levels(L, NR)):
        ratio = 1 << lvl
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc, axis=-2)
        wc = hc.coarsen_sum(wc, axis=-1)
        fwd = (q, kc.contiguous(), vc.contiguous(), wc.contiguous())
        y = hb.band_attention_sub_fwd_ref(*fwd, nr=NR, ratio=ratio)
        args = (*fwd, *y, *(randn(*t.shape) for t in y))
        plain = hbb.band_attention_sub_bwd_ref(*args, nr=NR, ratio=ratio)
        for cand in pol.candidates("sub_bwd", L=L, nr=NR, mode="sub",
                                   ratio=ratio, B=B, G=G, d=D, dv=D):
            tile = tuning.tile_of(cand)
            got = hbb.band_attention_sub_bwd(*args, nr=NR, ratio=ratio,
                                             tq=tile)
            out["sub_bwd"].append((dict(tile, ratio=ratio), compare(
                f"band_attention_sub_bwd ratio={ratio} {tile}", got, plain,
                GRAD_TOL, rows3)[1]))
    refused = ksec_refusals(q, k, v, w, want, cot)
    M = hc.num_levels(LMAX, NR)
    fp32, int8, _ = paged_pools(dev, torch.Generator(device=dev)
                                .manual_seed(22), M)
    t, bidx, _ = paged_tables(dev, M)
    qd = torch.randn((R, 1, D), generator=torch.Generator(device=dev)
                     .manual_seed(23), device=dev)
    for fam, pool, quant, fn, ref in (
            ("decode_attend_paged", fp32, False, dk.decode_attend_paged,
             dk.decode_attend_paged_ref),
            ("decode_attend_paged_quant", int8, True,
             dk.decode_attend_paged_quant, dk.decode_attend_paged_quant_ref)):
        want = ref(pool, qd, t, bidx, nr=NR)
        key = tuning.decode_key(G=1, d=D, dv=D, nr=NR, levels=M, quant=quant)
        for cand in pol.candidates(fam, G=1, d=D, dv=D, nr=NR, levels=M,
                                   quant=quant):
            forced = tuning.KernelPolicy(cache_dir=str(ROOT / "build" /
                                                       "no-tables"))
            forced._tables[fam] = {key: {"cr": cand["cr"]}}
            prev = tuning.set_policy(forced)
            try:
                got = fn(pool, qd, t, bidx, nr=NR)
            finally:
                tuning.set_policy(prev)
            if forced.decisions[-1]["source"] != "table":
                raise AssertionError(f"{fam}: the table's plan was not "
                                     f"applied: {forced.decisions[-1]}")
            out[fam].append(({"cr": cand["cr"], "stages": cand["stages"]},
                             compare(f"{fam} cr={cand['cr']}", (got,),
                                     (want,), ATTN_TOL)[1]))
        # a table's chunk that is no candidate is legalized to the
        # largest one below it; the launcher itself refuses it (below)
        forced = tuning.KernelPolicy(cache_dir=str(ROOT / "build" /
                                                   "no-tables"))
        forced._tables[fam] = {key: {"cr": 3}}
        cfg, src = forced.resolve(fam, G=1, d=D, dv=D, nr=NR, levels=M,
                                  quant=quant, dtype="float32")
        below = [c["cr"] for c in pol.candidates(
            fam, G=1, d=D, dv=D, nr=NR, levels=M, quant=quant)
            if c["cr"] <= 3]
        want_src = "table" if below else "default"
        if src != want_src or (below and cfg["cr"] != max(below)):
            raise AssertionError(f"{fam}: cr 3 legalized to {cfg} ({src})")
    lib = dk._lib()
    ks, vs = [fp32.k, *fp32.ck], [fp32.v, *fp32.cv]
    outp = torch.empty((R, 1, D), device=dev)
    refused["decode_attend_paged cr 3"] = lib.h1d_decode_attend_paged(
        qd.data_ptr(), dk._ptrs(ks), dk._ptrs(vs), t.data_ptr(),
        bidx.data_ptr(), outp.data_ptr(), R, 1, D, D, NR, M, 0.125, 0, 3,
        _stream())
    if not all(refused.values()):
        raise AssertionError(f"a launcher took a tile that does not fit: "
                             f"{refused}")
    out["refused"] = [(name, rc) for name, rc in refused.items()]
    return out


def _stream():
    from repro_torch.kernels import _build
    return _build.stream()


def ksec_refusals(q, k, v, w, fwd, cot):
    """22 (b): each launcher returns an error code, and launches nothing,
    for a tile that does not fit: #1 at 48 rows, #3 at 3 key blocks, #4
    at 3 splits (#5-#8's chunk of 3 rows in :func:`ksec_forced`)."""
    import ctypes

    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_block_bwd as hbb

    y = torch.empty_like(fwd[0])
    dn, m = torch.empty_like(fwd[1]), torch.empty_like(fwd[2])
    ptrs = [x.data_ptr() for x in (q, k, v, w, y, dn, m)]
    code = hb._MODE_CODES["l0_causal"]
    out = {"h1d_band_fwd tq 48": hb._lib().h1d_band_fwd(
        *ptrs, B, G, L, D, D, NR, code, 48, _stream())}
    grads = [torch.empty_like(x) for x in (q, k, v)] + [
        torch.empty_like(w), torch.empty_like(fwd[1])]
    dsa = torch.empty((B, G, L, 2 * hb.band_row_slots("l0_causal", NR)),
                      device=q.device)
    saved = [x.data_ptr() for x in (q, k, v, w, *fwd, *cot)]
    gp = [grads[0].data_ptr(), grads[4].data_ptr(), grads[1].data_ptr(),
          grads[2].data_ptr(), grads[3].data_ptr()]
    lib = hbb._lib()
    out["h1d_band_bwd (32, 3, 32)"] = lib.h1d_band_bwd(
        *saved, *gp, dsa.data_ptr(), B, G, L, D, D, NR, code,
        (ctypes.c_int * 3)(32, 3, 32), _stream())
    Lk = L // 32
    kc, vc, wc = k[:, :Lk].contiguous(), v[:, :Lk].contiguous(), \
        w[:, :Lk].contiguous()
    out["h1d_band_sub_bwd splits 3"] = lib.h1d_band_sub_bwd(
        *[x.data_ptr() for x in (q, kc, vc, wc, *fwd, *cot)],
        grads[0].data_ptr(), grads[4].data_ptr(),
        *[torch.empty_like(x).data_ptr() for x in (kc, vc, wc)],
        B, G, L, Lk, D, D, NR, 32, 3, _stream())
    torch.cuda.synchronize()
    return out


def ksec_round_trip(dev, tmp):
    """22 (c): ``autotune_band`` of ``band_fwd`` (l0_causal) and
    ``band_bwd`` at the LM's training shape into a temporary
    ``$REPRO_TUNE_CACHE``; a fresh policy whose ``_measure`` is None
    applies each table with source ``table``, a launch at the table's
    tile matches the plain version, and the digest moves."""
    import os
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_block_bwd as hbb
    from repro_torch.kernels import tuning

    cache = tmp / "tune"
    old = os.environ.get("REPRO_TUNE_CACHE")
    os.environ["REPRO_TUNE_CACHE"] = str(cache)
    try:
        p = tuning.KernelPolicy()
        d0 = p.tuning_digest()
        entries = {fam: p.autotune_band(L=L, nr=NR, mode="l0_causal", d=D,
                                        B=B, G=G, family=fam)
                   for fam in ("band_fwd", "band_bwd")}
        p2 = tuning.KernelPolicy()
        p2._measure = None       # any measurement would raise TypeError
        if p2.tuning_digest() == d0:
            raise AssertionError("tuning_digest did not move with a table")
        prev = tuning.set_policy(p2)
        try:
            _, randn, q, k, v, w = band_inputs(dev)
            y = hb.band_attention_fwd(q, k, v, w, nr=NR, mode="l0_causal")
            got_f = p2.decisions[-1]
            cot = tuple(randn(*t.shape) for t in y)
            gr = hbb.band_attention_bwd(q, k, v, w, *y, *cot, nr=NR,
                                        mode="l0_causal")
            got_b = p2.decisions[-1]
        finally:
            tuning.set_policy(prev)
        for fam, dec in (("band_fwd", got_f), ("band_bwd", got_b)):
            if dec["source"] != "table" or tuning.tile_of(
                    dec["config"]) != tuning.tile_of(entries[fam]):
                raise AssertionError(f"{fam}: table {entries[fam]} not "
                                     f"applied: {dec}")
        compare("band_attention_fwd at the table's tile", y,
                hb.band_attention_fwd_ref(q, k, v, w, nr=NR,
                                          mode="l0_causal"), ATTN_TOL)
        compare("band_attention_bwd at the table's tile", gr,
                hbb.band_attention_bwd_ref(q, k, v, w, *y, *cot, nr=NR,
                                           mode="l0_causal"), GRAD_TOL,
                ("row", "row", "row"))
    finally:
        if old is None:
            os.environ.pop("REPRO_TUNE_CACHE", None)
        else:
            os.environ["REPRO_TUNE_CACHE"] = old
    return entries


def ksec_table_shapes(dev):
    """22 (e): the launch record of each kernel at the primary shape of
    its PERF.md table row, under the default policy: #1 / #3 in
    ``l0_causal`` and #2 / #4 at every sub level at the LM's training
    shape (64 x G 1, L 1024, d 64); #1 / #3 in the LRA modes (each
    mode's first level, 64 x L 2048); the streamed #1 / #3 (4 x G 2, L
    4096, nr 1024, d 256); #5 / #6 on a dense f32 cache and #7-#10 on the
    f32 and int8 pools at R 64, Lmax 2048.  Returns [(label, record)]."""
    from repro_torch.analysis import contracts
    from repro_torch.core import h1d_decode as hd
    from repro_torch.core import hierarchy as hc
    from repro_torch.kernels import h1d_block as hb
    from repro_torch.kernels import h1d_block_bwd as hbb
    from repro_torch.kernels import h1d_decode_kernel as dk

    out = []

    def take(label, fn, *args, **kw):
        with contracts.capture() as recs:
            res = fn(*args, **kw)
        out.extend((label, r) for r in recs)
        return res

    def band(label, fwd, bwd, args, randn, **kw):
        y = take(f"{label} fwd", fwd, *args, **kw)
        cot = tuple(randn(*t.shape) for t in y)
        take(f"{label} bwd", bwd, *args, *y, *cot, **kw)

    _, randn, q, k, v, w = band_inputs(dev)
    band("l0_causal LM", hb.band_attention_fwd, hbb.band_attention_bwd,
         (q, k, v, w), randn, nr=NR, mode="l0_causal")
    kc, vc, wc = k, v, w
    for lvl in range(1, hc.num_levels(L, NR)):
        kc, _ = hc.coarsen_weighted_mean(kc, wc)
        vc = hc.coarsen_sum(vc, axis=-2)
        wc = hc.coarsen_sum(wc, axis=-1)
        band(f"sub ratio {1 << lvl} LM", hb.band_attention_sub_fwd,
             hbb.band_attention_sub_bwd,
             (q, kc.contiguous(), vc.contiguous(), wc.contiguous()), randn,
             nr=NR, ratio=1 << lvl)
    lra_randn, lq, lk, lv, lw = lra_band_inputs(dev)
    for mode in NEW_MODES:
        lvl, args = lra_levels(mode, lq, lk, lv, lw)[0]
        band(f"{mode} LRA level {lvl}", hb.band_attention_fwd,
             hbb.band_attention_bwd, args, lra_randn, nr=NR, mode=mode)
    Bs, Gs, Ls, nrs, ds, live = STREAM_CASES[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    sq = torch.randn((Bs, Gs, Ls, ds), generator=gen, device=dev) / 16
    sk = torch.randn((Bs, Ls, ds), generator=gen, device=dev)
    sw = (torch.arange(Ls, device=dev) < live).float().expand(Bs, Ls)
    band("l0_causal_stream gemma", hb.band_attention_fwd,
         hbb.band_attention_bwd, (sq, sk, sk.clone(), sw.contiguous()),
         lambda *sh: torch.randn(sh, generator=gen, device=dev), nr=nrs,
         mode="l0_causal")
    M = hc.num_levels(LMAX, NR)
    cache = hd.init_cache(R, LMAX, D, D, NR, device=dev)
    t = torch.full((R,), 777, dtype=torch.int32, device=dev)
    qd = torch.randn((R, 1, D), generator=gen, device=dev)
    kn = torch.randn((R, D), generator=gen, device=dev)
    take("f32 R 64 dense", dk.decode_attend_fused, cache, qd, t, nr=NR)
    take("f32 R 64 dense", dk.update_cache_fused, cache, kn, kn, t)
    fp32, int8, _ = paged_pools(dev, gen, M)
    tt, bidx, utab = paged_tables(dev, M)
    take("f32 R 64 paged", dk.decode_attend_paged, fp32, qd, tt, bidx, nr=NR)
    take("f32 R 64 paged", dk.update_cache_paged, fp32, kn, kn, tt, utab)
    take("int8 R 64 paged", dk.decode_attend_paged_quant, int8, qd, tt, bidx,
         nr=NR)
    take("int8 R 64 paged", dk.update_cache_paged_quant, int8, kn, kn, tt,
         utab)
    return out


def resolve_cost_us(calls: int = 20000):
    """22 (f): host microseconds of one launch policy resolution, per
    family kind, on a shape the policy has seen (a memo hit)."""
    from repro_torch.kernels import tuning
    p = tuning.KernelPolicy(cache_dir=str(ROOT / "build" / "no-tables"))
    shapes = (("band_fwd", dict(L=L, nr=NR, mode="l0_causal", B=B, G=G, d=D,
                                dv=D)),
              ("decode_attend", dict(G=1, d=D, dv=D, nr=NR, levels=7,
                                     quant=False, dtype="float32")),
              ("decode_update", dict(rows=R, d=D, dv=D, levels=7,
                                     dtype="float32")))
    out = {}
    for fam, kw in shapes:
        p.resolve(fam, **kw)
        t0 = time.perf_counter()
        for _ in range(calls):
            p.resolve(fam, **kw)
        out[fam] = (time.perf_counter() - t0) / calls * 1e6
    return out


def phase_kernels_section(dev):
    """22.  ``repro_torch.analysis``'s kernels section on the card:
    (a) every launch record of :func:`ksec_records` checks clean
    (``analysis.checker``), its grid read back from the launcher equals
    the grid the checker's mirror derives for its tile, its ``smem``
    (the plan mirrors') equals what the launcher set, its registers are
    at most 255 and it fits at least one CTA an SM; one line per family
    with tile, grid, smem, registers and CTAs/SM; (b) :func:`ksec_forced`;
    (c) :func:`ksec_round_trip`; (d) with no table every decision of (a)
    has source ``default`` (and (a)'s grids and smem are those of the
    launchers' own rules, which received 0); (e) the records at the
    PERF.md table's shapes (:func:`ksec_table_shapes`), held as (a)'s;
    (f) the host cost of a policy resolution (:func:`resolve_cost_us`).
    Returns the records."""
    import tempfile

    from repro_torch import kernels
    from repro_torch.analysis import checker, vmem
    from repro_torch.kernels import tuning

    card = card_line()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        recs, launches, sources = ksec_records(dev, tmp)
        bad = [(r.family, str(v)) for r in recs
               for v in checker.check_contract(r)]
        if bad:
            raise AssertionError(f"phase 22 (a): violations: {bad[:8]}")
        fams = collections.defaultdict(list)
        for r in recs:
            want = checker.launch_grid(r.family, r.meta)
            if tuple(r.grid) != want:
                raise AssertionError(f"{r.family}: launcher grid {r.grid} "
                                     f"!= mirror {want} ({r.meta})")
            if tuple(r.meta.get("smem_set", ())) != tuple(r.smem):
                raise AssertionError(f"{r.family}: launcher smem "
                                     f"{r.meta.get('smem_set')} != mirror "
                                     f"{r.smem}")
            if not r.regs or max(r.regs) > 255 or min(r.ctas_per_sm) < 1:
                raise AssertionError(f"{r.family}: regs {r.regs}, CTAs/SM "
                                     f"{r.ctas_per_sm}")
            if vmem.record_smem_bytes(r) > vmem.default_budget():
                raise AssertionError(f"{r.family}: smem over the budget")
            fams[r.family].append(r)
        missing = set(kernels.FAMILY.values()) - set(fams)
        if missing:
            raise AssertionError(f"phase 22 (a): no record of {missing}")
        for fam in sorted(fams):
            top = max(fams[fam], key=lambda r: launches[id(r)])
            kinds = collections.Counter(
                (str(r.meta.get("tile")), "bf16" if r.meta.get("half")
                 else "f32", r.smem, r.regs, r.ctas_per_sm)
                for r in fams[fam])
            log(f"22 {fam}: {len(fams[fam])} records, "
                f"{sum(launches[id(r)] for r in fams[fam])} launches; the "
                f"most launched: tile {top.meta.get('tile')}, grid "
                f"{[list(g) for g in top.grid]}, smem {list(top.smem)} B, "
                f"regs {list(top.regs)}, CTAs/SM {list(top.ctas_per_sm)}; "
                f"(tile, dtype, smem, regs, CTAs/SM) x records: "
                f"{sorted(kinds.items())} ({card})")
        not_default = {k: n for k, n in sources.items() if k[1] != "default"}
        if not_default or not sources:
            raise AssertionError(f"phase 22 (d): decisions not from the "
                                 f"defaults: {not_default}")
        log(f"22 (d): {sum(sources.values())} decisions, all 'default', "
            f"over {len({f for f, _ in sources})} families")
        forced = ksec_forced(dev)
        for fam, res in forced.items():
            log(f"22 (b) {fam}: " + "; ".join(
                f"{tile} {err:.3g}" if isinstance(err, float)
                else f"{tile}: rc {err}" for tile, err in res))
        entries = ksec_round_trip(dev, tmp)
        for fam, e in entries.items():
            log(f"22 (c) {fam}: measured {e.get('measured')}, chose "
                f"{tuning.tile_of(e)} at {e['us']} us ({card})")
        seen = set()
        for label, r in ksec_table_shapes(dev):
            if checker.check_contract(r) or tuple(r.grid) != \
                    checker.launch_grid(r.family, r.meta) or \
                    tuple(r.meta["smem_set"]) != tuple(r.smem):
                raise AssertionError(f"22 (e) {label}: {r.describe()}")
            if (label, id(r)) in seen:
                continue
            seen.add((label, id(r)))
            log(f"22 (e) {label} {r.family}: tile {r.meta.get('tile')}, "
                f"grid {[list(g) for g in r.grid]}, smem {list(r.smem)} B, "
                f"regs {list(r.regs)}, CTAs/SM {list(r.ctas_per_sm)} "
                f"({card})")
        log(f"22 (f) policy resolution, host us a launch: "
            f"{ {f: round(us, 3) for f, us in resolve_cost_us().items()} } "
            f"({card})")
    log(f"phase 22 (kernels section) took {time.perf_counter() - t0:.1f}s")
    return recs


# ---------------------------------------------------------------------------
# phase 23: planning -- the pipeline, the dry run and the roofline
# ---------------------------------------------------------------------------

PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 3, 6, 1024
PIPE_HIDDEN_TOL, PIPE_GRAD_TOL = 2e-5, 1e-4
ALLOC_TOL, FLOP_TOL = 0.01, 0.01
PLAN_CELLS = (("llama3.2-1b", (4096, 1, "train")),
              ("yi-6b", (32768, 1, "decode")))


def phase_pipeline(dev):
    """23 (a): see the module docstring.  Returns the pipelined run's
    launches."""
    import functools
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel import pipeline_apply
    from repro_torch.tree import tree_leaves, tree_map

    card = card_line()
    cfg = get_config("h1d-lm-53m")
    S, M, L = PIPE_STAGES, PIPE_MICRO, cfg.num_layers
    if cfg.dtype != "float32" or L % S:
        raise AssertionError(f"23 (a): {cfg.dtype}, {L} layers")
    per = L // S
    params = T.lm_init(cfg, seed=0, device=dev)
    layers = [tree_map(lambda t: t.requires_grad_(True), lp)
              for lp in params["layers"]]
    gen = torch.Generator(device=dev).manual_seed(23)
    tokens = torch.randint(0, cfg.vocab_size, (M, PIPE_SEQ), generator=gen,
                           device=dev)
    x0 = T._embed_tokens(params, cfg, tokens).detach()[:, None]
    cot = torch.randn(x0.shape, generator=gen, device=dev)
    positions = torch.arange(PIPE_SEQ, device=dev)[None]

    def layer(lp, h, i):
        return T._block_apply(lp, cfg, h, positions,
                              cfg.layer_uses_global_attn(i))[0]

    def stage_fn(sp, h):        # sp: the stage's layers, in order
        return functools.reduce(lambda h, j: layer(sp[j], h, j),
                                range(per), h)

    def run(piped):
        kernels.reset_counts()
        x = x0.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if piped:
            stacked = [tree_map(lambda *ls: torch.stack(ls),
                                *[layers[s * per + j] for s in range(S)])
                       for j in range(per)]
            out = pipeline_apply(stage_fn, stacked, x,
                                 mesh=make_mesh((S,), ("stage",), dev))
        else:
            out = torch.stack([functools.reduce(
                lambda h, i: layer(layers[i], h, i), range(L), x[m])
                for m in range(M)])
        leaves = [x] + [t for lp in layers for t in tree_leaves(lp)]
        grads = torch.autograd.grad((out * cot).sum(), leaves)
        torch.cuda.synchronize()
        return out.detach(), grads, path_counts(), \
            (time.perf_counter() - t0) * 1e3

    run(True)                   # warm-up: the first launches' host setup
    out, grads, counts, ms = run(True)
    seq_out, seq_grads, seq_counts, seq_ms = run(False)
    err = float((out - seq_out).abs().max())
    if not err <= PIPE_HIDDEN_TOL:
        raise AssertionError(f"23 (a): hidden states {err:.3g} from the "
                             f"sequential run")
    worst = max(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                 1e-30)
                for g, w in zip(grads, seq_grads))
    if not worst <= PIPE_GRAD_TOL:
        raise AssertionError(f"23 (a): a gradient leaf {worst:.3g} of its "
                             f"largest |sequential|")
    band = {k: c for k, c in counts.items()
            if k.split("[")[0] in kernels.TRAIN_KERNELS}
    seq_band = {k: seq_counts[k] for k in band}
    if band != seq_band or not all(band[k] for k in kernels.TRAIN_KERNELS):
        raise AssertionError(f"23 (a): launches {band} != sequential "
                             f"{seq_band}")
    log(f"23 (a) pipeline of h1d-lm-53m (fp32), {S} stages x {per} layers, "
        f"{M} microbatches of 1 x {PIPE_SEQ}: hidden {err:.3g} from the "
        f"sequential run, worst gradient leaf {worst:.3g} of its largest; "
        f"band launches {band} equal; host ms with the backward: pipeline "
        f"{ms:.1f}, sequential {seq_ms:.1f} ({card})")
    return counts


def plan_arguments(cfg, shape, dev):
    """The cell's arguments built on ``dev`` by the port's own entry
    points (``launch.dryrun.cell_args``' structure), and the growth of
    ``torch.cuda.memory_allocated()`` over the groups the check holds
    to the dry run.  Train: the parameters by the model's init (drawn
    from seed 0 on the CPU, each layer moved to the card as it is
    drawn), the AdamW state by the optimizer's init on them, the batch;
    every group measured.  Decode: the caches by the model's cache init,
    token and position, measured; the parameters beside them are placed
    first, undrawn, at the meta tree's shapes and are not measured (the
    init's CPU draw of ``yi-6b``'s 6.06 G parameters would take minutes;
    the train cell holds the init's own tree to the dry run).  Returns
    (args, measured groups, bytes grown, init seconds)."""
    from repro_torch.launch import specs as S
    from repro_torch.models import get_model
    from repro_torch.train.loop import TrainConfig, TrainState, \
        make_optimizer
    from repro_torch.tree import tree_map

    kind, seq, batch = S.cell(cfg, shape)
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(23)
    if kind != "train":
        params = tree_map(lambda t: torch.empty_like(t, device=dev),
                          S.param_struct(cfg, 1))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    if kind == "train":
        params = model.init(cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        state = TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                           params, make_optimizer(TrainConfig()).init(params),
                           None)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=dev, dtype=torch.int32)
        args, groups = (state, {"tokens": tokens}), ("step", "params",
                                                     "opt_state", "batch")
    else:
        caches = model.init_caches(params, cfg, batch, seq)
        zeros = torch.zeros((batch,), dtype=torch.int32, device=dev)
        init_s = time.perf_counter() - t0
        args, groups = (params, caches, zeros, zeros.clone()), ("caches",
                                                                "token", "t")
    torch.cuda.synchronize()
    return args, groups, torch.cuda.memory_allocated(dev) - before, init_s


def phase_plan_cells(dev):
    """23 (b) and (c): see the module docstring.  Returns (c)'s
    launches."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.parallel import abstract_mesh
    from repro_torch.train.loop import TrainConfig, make_train_step

    card = card_line()
    mesh = abstract_mesh((1, 1), ("data", "model"))
    counts = {}
    for arch, shape in PLAN_CELLS:
        cfg = get_config(arch)
        _, meta_args, groups = D.cell_args(cfg, shape, 1)
        in_sh, _ = D.cell_shardings(cfg, shape, mesh, meta_args)
        want = D.argument_bytes(meta_args, groups, in_sh, mesh)
        args, groups, got, init_s = plan_arguments(cfg, shape, dev)
        held = {g: want[g] for g in groups}
        total = sum(held.values())
        rel = abs(got - total) / total
        if not rel <= ALLOC_TOL:
            raise AssertionError(f"23 (b) {arch} {shape}: allocated {got} "
                                 f"B, the dry run says {total} B {held}")
        log(f"23 (b) {arch} {shape[2]} at {shape[1]} x {shape[0]}: the dry "
            f"run's bytes {total} ({held}; all groups {want}), allocated "
            f"on the card by the port's entry points {got} ({init_s:.1f}s), "
            f"{rel * 100:.4f} % apart ({card})")
        if shape[2] == "train":
            meas = R._measure(cfg, shape, mesh)["total"]
            step = make_train_step(cfg, TrainConfig())
            kernels.reset_counts()
            with R.Count() as c:
                state, metrics = step(*args)
                loss = float(metrics["loss"])
            torch.cuda.synchronize()
            counts = path_counts()
            got_f = c.totals()
            rel_f = abs(got_f["flops"] - meas["flops"]) / meas["flops"]
            if not (rel_f <= FLOP_TOL and math.isfinite(loss)):
                raise AssertionError(
                    f"23 (c) {arch}: FLOPs counted on the card {got_f} vs the "
                    f"roofline's {meas}, loss {loss}")
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, metrics = step(state, args[1])
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1])
            terms = {"compute_ms": meas["flops"] / PEAK_FLOPS_BF16 * 1e3,
                     "memory_ms": meas["bytes"] / HBM_BW * 1e3}
            top = max(terms.values())
            log(f"23 (c) {arch} train step at 1 x {shape[0]}: FLOPs counted "
                f"during the step on the card, by the roofline's counters, "
                f"{got_f['flops']:.6g} (matmul "
                f"{got_f['matmul_flops']:.6g}, kernels "
                f"{got_f['kernel_flops']:.6g}, {got_f['kernel_launches']:.0f}"
                f" launches), the roofline's extrapolation "
                f"{meas['flops']:.6g}, {rel_f * 100:.4f} % apart; modelled "
                f"eager bytes {meas['bytes']:.6g}; step {ms:.3f} device ms "
                f"(CUDA events, the second step), roofline terms "
                f"{ {k: round(v, 3) for k, v in terms.items()} }: bound "
                f"{top:.3f} ms, {top / ms * 100:.1f} % of the step ({card})")
            del state, metrics
        del args
    return counts


def phase_full_dryrun():
    """23 (d): every dry-run cell on meta tensors, over the dry run's
    processes, into a temporary directory."""
    import os
    import tempfile
    from repro_torch.launch import dryrun as D

    card = card_line()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        recs = D.run_all(out_dir=tmp, verbose=False)
    secs = time.perf_counter() - t0
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error")) for r in recs
           if not r["ok"]]
    by = collections.defaultdict(dict)
    for r in recs:
        if r["ok"]:
            m = r["memory"]
            by[(r["arch"], r["shape"])][r["mesh"]] = (
                round(m["argument_size_in_bytes"] / 2 ** 30, 3),
                round((m["output_size_in_bytes"]
                       - m["output_aliased_bytes"]) / 2 ** 30, 3), r["fits"])
    for (arch, shape), meshes in sorted(by.items()):
        log(f"23 (d) {arch} {shape}: per card GiB (arguments, outputs not "
            f"aliasing them, fits) {meshes} ({card})")
    log(f"23 (d) dry run: {len(recs) - len(bad)} of {len(recs)} cells ok "
        f"in {secs:.1f}s over {min(D.JOBS, os.cpu_count())} processes; "
        f"card memory "
        f"{recs[0].get('card_memory_bytes')} B "
        f"({recs[0].get('card_memory_source')}) ({card})")
    if bad or len(recs) != 80:
        raise AssertionError(f"23 (d): {len(recs)} cells, failures {bad}")


def phase_planning(dev):
    """23: (a)-(d).  Returns the launches of (a) and (c)."""
    t0 = time.perf_counter()
    counts = {"pipeline": phase_pipeline(dev)}
    torch.cuda.empty_cache()
    counts["roofline_step"] = phase_plan_cells(dev)
    torch.cuda.empty_cache()
    phase_full_dryrun()
    log(f"phase 23 (planning) took {time.perf_counter() - t0:.1f}s")
    return counts


# phase 24: one shard a process (parallel/group.py), 2 ranks through
# torchrun on the CLIs
RANKS = 2
RANK_PROMPTS = 4              # phase 5c (c)'s requests: reqs[:4], 8 slots
RANK_TRAIN = ("--steps", "3", "--batch", "4", "--seq", "1024")
RANK_LOSS_TOL = 1e-5          # of max(1, |loss|): fp32 in another order
RANK_TIMEOUT = 300


def torchrun(label, argv, tmp, nproc=RANKS):
    """``argv`` under ``torch.distributed.run --standalone`` on ``nproc``
    ranks; its output logged, every process stopped.  Raises when any
    rank failed."""
    import os
    import signal
    env = dict(os.environ, PYTHONPATH=str(SRC),
               OMP_NUM_THREADS=str(max(1, 8 // nproc)))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc)] + list(argv)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=tmp, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{label}: no end in {RANK_TIMEOUT} s:\n"
                             f"{out[-4000:]}") from None
    for line in out.splitlines():
        if "socket.cpp" not in line and "OMP_NUM_THREADS" not in line \
                and set(line) != {"*"}:
            log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}")
    log(f"{label}: {nproc} ranks in {time.perf_counter() - t0:.1f}s "
        f"(start-up included)")


def rank_reports(tmp, name, nproc=RANKS):
    return [json.loads((Path(tmp) / name.replace("{rank}", str(r)))
                       .read_text()) for r in range(nproc)]


def rank_launches(reports):
    """The reports' kernel launches summed over ranks, keyed as
    ``path_counts``; no plain version may have run."""
    total = collections.Counter()
    for rep in reports:
        plain = {k: c for k, c in rep["launches"].items()
                 if k.startswith("plain:") and c}
        if plain:
            raise AssertionError(f"24: rank {rep['rank']} ran plain "
                                 f"versions: {plain}")
        total.update({k: c for k, c in rep["launches"].items()
                      if not k.startswith("plain:")})
    return dict(total)


def ranks_serve(tmp, device, sp_run, serve_tokens, prompts):
    """24 (a): launch.serve --sp-data 2 on phase 5c (c)'s requests."""
    outs, stats, counts, guarded = sp_run
    (Path(tmp) / "prompts.json").write_text(json.dumps(
        [p.tolist() for p in prompts]))
    torchrun("24 (a) serve", ["-m", "repro_torch.launch.serve", "--sp-data",
                           str(RANKS), "--prompts", "prompts.json",
                           "--slots", "8", "--max-len", str(LMAX),
                           "--new-tokens", str(PAGED_NEW), "--rank-report",
                           "serve.{rank}.json"] + device, tmp)
    reps = rank_reports(tmp, "serve.{rank}.json")
    for rep in reps:        # SP serving runs #6 on the deep levels alone
        rep["launches"]["update_cache_fused[sp_deep]"] = rep["launches"].pop(
            "update_cache_fused")
    got = reps[0]["tokens"]
    want = [outs[u] for u in range(len(prompts))]
    if any(rep["tokens"] != want for rep in reps):
        raise AssertionError(f"24 (a): ranks' tokens {got} differ from the "
                             f"one-process d = 2 engine's {want}")
    bad = [u for u in range(len(prompts))
           if u in guarded and got[u] != serve_tokens[u]]
    if bad:
        raise AssertionError(f"24 (a): requests {bad} differ from phase 4")
    for rep in reps:
        mine = {k: c for k, c in rep["launches"].items()
                if not k.startswith("plain:")}
        for k in ("band_attention_fwd", "band_attention_sub_fwd",
                  "decode_attend_partial", "update_cache_partial"):
            if not counts[k] or 2 * mine[k] != counts[k]:
                raise AssertionError(f"24 (a): rank {rep['rank']} launched "
                                     f"{k} {mine[k]} times, the one-process "
                                     f"layout {counts[k]}")
        deep = "update_cache_fused[sp_deep]"
        if mine["decode_attend_fused"] or \
                2 * mine[deep] != counts.get(deep, 0):
            raise AssertionError(f"24 (a): #5 / #6 launches {mine}")
    ticks = [st for st in reps[0]["steps"] if not st["admitted"]]
    tick_ms = float(np.median([st["ms"] for st in ticks]))
    comm_ms = float(np.median([st["comm_ms"] for st in ticks]))
    log(f"24 (a) serve, {RANKS} ranks ({reps[0]['backend']}, "
        f"{reps[0]['placement']}): the one-process d = 2 engine's tokens "
        f"on every rank ({sum(u in guarded for u in range(len(prompts)))} "
        f"margin-guarded, phase 4's); launches per rank "
        f"{json.dumps({k: c for k, c in reps[0]['launches'].items() if c})}"
        f" = half of the one-process layout's; {len(ticks)} decode ticks: "
        f"median {tick_ms:.2f} ms a tick on rank 0 (engine step, sampling "
        f"included, collectives timed between synchronizations), "
        f"{comm_ms:.2f} ms in collectives ({comm_ms / tick_ms:.1%}); "
        f"collectives {json.dumps(reps[0]['collectives'])}; the "
        f"one-process d = 2 engine: decode {stats['decode_ms_per_tick']:.2f}"
        f" ms a tick (decode_step alone), {stats['tokens_per_s']:.1f} "
        f"tokens/s; {len(ticks)} ticks ({card_line()})")
    return reps


def ranks_train(tmp, device):
    """24 (b): launch.train --sp --mesh 2, 3 steps, against the same CLI
    line in this process (the one-process layout)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.parallel import sp_attention as sp

    torchrun("24 (b) train", ["-m", "repro_torch.launch.train", "--sp",
                           "--mesh", str(RANKS), "--ckpt-dir", "ck_ranks",
                           "--rank-report", "train.{rank}.json",
                           *RANK_TRAIN] + device, tmp)
    reps = rank_reports(tmp, "train.{rank}.json")
    seen = {}
    real = train_cli.train

    def spy(*a, **kw):
        state, metrics = real(*a, **kw)
        seen.update(metrics)
        return state, metrics
    train_cli.train = spy
    counts = {}
    sp.DISPATCHES.clear()
    try:
        with counted(counts):
            cli_run(train_cli.main, ["--sp", "--mesh", str(RANKS),
                                     "--ckpt-dir", str(Path(tmp) / "ck_one"),
                                     *RANK_TRAIN])
    finally:
        train_cli.train = real
    layers = get_config("h1d-lm-53m").num_layers
    if sp.DISPATCHES.get("h1d_attention") != 3 * layers:
        raise AssertionError(f"24 (b): the one-process run's SP calls "
                             f"{sp.DISPATCHES}")
    want = [h["loss"] for h in seen["history"]]
    worst = 0.0
    for rep in reps:
        got = [h["loss"] for h in rep["history"]]
        worst = max(worst, max(abs(a - b) / max(1.0, abs(b))
                               for a, b in zip(got, want)))
        if len(got) != len(want) or worst > RANK_LOSS_TOL:
            raise AssertionError(f"24 (b): rank {rep['rank']} losses {got}, "
                                 f"one process {want}")
        if rep["params"] != reps[0]["params"]:
            raise AssertionError("24 (b): the ranks' parameters differ")
        mine = rep["launches"]
        for k in ("band_attention_fwd", "band_attention_sub_fwd",
                  "band_attention_bwd", "band_attention_sub_bwd"):
            if not counts.get(k) or 2 * mine[k] != counts[k]:
                raise AssertionError(f"24 (b): rank {rep['rank']} launched "
                                     f"{k} {mine[k]} times, one process "
                                     f"{counts.get(k)}")
    log(f"24 (b) train, {RANKS} ranks: losses {[h['loss'] for h in reps[0]['history']]} "
        f"against one process {want} (worst {worst:.3g} of max(1, |loss|)"
        f"), parameters bit-identical across ranks ({reps[0]['params'][:16]}"
        f"), band launches half the one-process run's; step ms "
        f"{[round(h['step_ms'], 1) for h in reps[0]['history']]} against "
        f"{[round(h['step_ms'], 1) for h in seen['history']]} "
        f"({card_line()})")
    return reps


def ranks_pipeline(tmp, device):
    """24 (c): pipeline_apply at S = 2, h1d-lm-53m's 6 layers in 2 stages
    of 3, 4 microbatches of 1 x 1024 (tools/pipeline_ranks.py)."""
    torchrun("24 (c) pipeline", [str(ROOT / "tools" / "pipeline_ranks.py"),
                              "--layers", "6", "--micro", "4", "--seq",
                              "1024", "--out", "pipe.{rank}.json"] + device,
             tmp)
    reps = rank_reports(tmp, "pipe.{rank}.json")
    for rep in reps:
        if not (rep["hidden"] <= PIPE_HIDDEN_TOL
                and rep["x_grad"] <= PIPE_GRAD_TOL
                and rep["stage_grad"] <= PIPE_GRAD_TOL):
            raise AssertionError(f"24 (c): rank {rep['rank']}: {rep}")
        seq = rep["sequential_launches"]
        if not all(seq[k] and RANKS * rep["launches"][k] == seq[k]
                   for k in seq):
            raise AssertionError(f"24 (c): launches {rep['launches']} "
                                 f"against the sequential run's {seq}")
    log(f"24 (c) pipeline, {RANKS} stages a rank: hidden "
        f"{max(r['hidden'] for r in reps):.3g}, gradients "
        f"{max(max(r['x_grad'], r['stage_grad']) for r in reps):.3g} of "
        f"their largest, band launches per rank half the sequential run's; "
        f"host ms with the backward {[round(r['ms'], 1) for r in reps]} "
        f"against sequential {[round(r['sequential_ms'], 1) for r in reps]}"
        f" ({card_line()})")
    return reps


def phase_ranks(sp_run, serve_tokens, prompts):
    """24: see the module docstring.  Returns the launches of the ranks'
    runs (shared card, and NCCL where it ran), summed over ranks."""
    import tempfile
    t0 = time.perf_counter()
    legs = [("shared card, gloo", ["--device", "cuda:0"])]
    n = torch.cuda.device_count()
    if n >= RANKS:
        legs.append(("a card a rank, NCCL", []))
    else:
        log(f"24: the NCCL leg did not run: {n} card visible, and it needs "
            f"{RANKS}, one a rank")
    total = collections.Counter()
    for label, device in legs:
        log(f"24: {label}")
        with tempfile.TemporaryDirectory() as tmp:
            for reps in (ranks_serve(tmp, device, sp_run, serve_tokens,
                                     prompts),
                         ranks_train(tmp, device)):
                total.update(rank_launches(reps))
            pipe = ranks_pipeline(tmp, device)
            total.update(rank_launches([
                dict(rank=r["rank"], launches=r["launches"])
                for r in pipe]))
    log(f"24: launches of the ranks' runs, every rank and leg summed: "
        f"{json.dumps(dict(total))}")
    log(f"phase 24 (ranks) took {time.perf_counter() - t0:.1f}s")
    return dict(total)


# phase 25 (c): training over a DATAxMODEL mesh, one shard a process
TP_MESHES = ("1x2", "2x1", "2x2")
# the mesh's run against the one-process run, fp32 in another order (the
# vocabulary's logsumexp in parts, the row-parallel psums, the data axis'
# gradient sum): the losses, relative; after step 3 the parameters,
# absolute, and each AdamW moment leaf, of its largest |entry|.  On an
# H100 (gloo, one card) the three meshes read at most 9.66e-08, 1.26e-06
# and 1.87e-06; a row-parallel output whose backward sums over the model
# axis read 0.99 on the moments (the smoke config, 1x2 on the CPU)
TP_LOSS_RTOL = 1e-6
TP_PARAM_ATOL = 1e-5
TP_MOMENT_RTOL = 2e-5


def tp_state_gap(ck_dir, want_state):
    """(max |parameter| gap, max moment gap of its leaf's largest |entry|)
    between the mesh's step-3 checkpoint in ``ck_dir`` and the
    one-process run's final state."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.tree import tree_leaves
    got = ckpt.restore(ck_dir, 3, want_state)
    param = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(got.params), tree_leaves(want_state.params)))
    moment = 0.0
    for f in ("mu", "nu"):
        for a, b in zip(tree_leaves(getattr(got.opt_state, f)),
                        tree_leaves(getattr(want_state.opt_state, f))):
            top = float(b.abs().max())
            gap = float((a - b).abs().max())
            moment = max(moment, gap / top if top else gap)
    return param, moment


def tp_train(tmp, mesh, device, want, want_state, counts, leg):
    """25 (c): ``launch.train --mesh DxM`` on h1d-lm-53m, 3 steps at 4 x
    1024, one shard a rank: every rank's losses within TP_LOSS_RTOL of
    the one-process run's ``want``, the gathered parameters' digest the
    same on every rank, the step-3 state within TP_PARAM_ATOL and
    TP_MOMENT_RTOL of ``want_state``, #1-#4 launched on every rank as
    often as in one process (a rank runs every layer and level on its
    heads or rows), no plain version.  Returns the reports."""
    D, M = (int(n) for n in mesh.split("x"))
    name = f"tp{mesh}.{leg}.{{rank}}.json"
    ck_dir = Path(tmp) / f"ck_{mesh}.{leg}"
    torchrun(f"25 (c) {mesh}", ["-m", "repro_torch.launch.train", "--mesh",
                                mesh, "--ckpt-dir", str(ck_dir),
                                "--ckpt-every", "3", "--rank-report", name,
                                *RANK_TRAIN] + device, tmp, nproc=D * M)
    reps = rank_reports(tmp, name, D * M)
    worst = 0.0
    for rep in reps:
        got = [h["loss"] for h in rep["history"]]
        if len(got) != len(want):
            raise AssertionError(f"25 (c) {mesh}: rank {rep['rank']} ran "
                                 f"{len(got)} steps")
        worst = max(worst, max(abs(a - b) / abs(b) for a, b in zip(got, want)))
        if worst > TP_LOSS_RTOL:
            raise AssertionError(f"25 (c) {mesh}: rank {rep['rank']} losses "
                                 f"{got}, one process {want}")
        if rep["params"] != reps[0]["params"]:
            raise AssertionError(f"25 (c) {mesh}: the gathered parameters "
                                 f"differ across ranks")
        mine = rep["launches"]
        for k in ("band_attention_fwd", "band_attention_sub_fwd",
                  "band_attention_bwd", "band_attention_sub_bwd"):
            if not counts.get(k) or mine[k] != counts[k]:
                raise AssertionError(f"25 (c) {mesh}: rank {rep['rank']} "
                                     f"launched {k} {mine[k]} times, one "
                                     f"process {counts.get(k)}")
    param_gap, moment_gap = tp_state_gap(str(ck_dir), want_state)
    if param_gap > TP_PARAM_ATOL or moment_gap > TP_MOMENT_RTOL:
        raise AssertionError(f"25 (c) {mesh}: the step-3 state misses one "
                             f"process's: parameters {param_gap:.3g} "
                             f"absolute, moments {moment_gap:.3g} of a "
                             f"leaf's largest")
    steps = len(want)
    axes = {a: dict(calls=row["calls"] / steps,
                    ms=row["seconds"] * 1e3 / steps,
                    mb=row["bytes"] / steps / 2 ** 20)
            for a, row in reps[0]["collectives"]["by_axis"].items()}
    log(f"25 (c) {mesh} ({reps[0]['backend']}, {reps[0]['placement']}): "
        f"losses {[h['loss'] for h in reps[0]['history']]} against one "
        f"process {want} (worst {worst:.3g} relative), gathered parameters "
        f"the same on all {D * M} ranks ({reps[0]['params'][:16]}); step-3 "
        f"state against one process: parameters {param_gap:.3g} absolute, "
        f"AdamW moments {moment_gap:.3g} of a leaf's largest; step ms "
        f"{[round(h['step_ms'], 1) for h in reps[0]['history']]}; rank 0's "
        f"collectives a step by axis (each timed between synchronizations) "
        f"{json.dumps(axes)} ({card_line()})")
    return reps


def phase_tp_train():
    """25 (c): see the module docstring.  Returns the launches of the
    meshes' runs, every rank summed."""
    import tempfile
    from repro_torch.launch import train as train_cli

    t0 = time.perf_counter()
    seen, counts = {}, {}
    real = train_cli.train

    def spy(*a, **kw):
        state, metrics = real(*a, **kw)
        seen.update(metrics, state=state)
        return state, metrics
    train_cli.train = spy
    total = collections.Counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with counted(counts):
                cli_run(train_cli.main, ["--ckpt-dir",
                                         str(Path(tmp) / "ck_one"),
                                         *RANK_TRAIN])
            want = [h["loss"] for h in seen["history"]]
            log(f"25 (c) one process: losses {want}, step ms "
                f"{[round(h['step_ms'], 1) for h in seen['history']]}")
            n = torch.cuda.device_count()
            legs = [("shared card, gloo", ["--device", "cuda:0"],
                     TP_MESHES)]
            own = tuple(m for m in TP_MESHES
                        if int(m[0]) * int(m[2]) <= n)
            if n >= 2:
                legs.append(("a card a rank, NCCL", [], own))
            else:
                log(f"25 (c): the NCCL leg did not run: {n} card visible, "
                    f"and it needs one a rank")
            for leg, (label, device, meshes) in enumerate(legs):
                log(f"25 (c): {label}")
                for mesh in meshes:
                    total.update(rank_launches(tp_train(
                        tmp, mesh, device, want, seen["state"], counts,
                        leg)))
    finally:
        train_cli.train = real
    log(f"phase 25 (c) took {time.perf_counter() - t0:.1f}s")
    return dict(total)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import exact_products
    exact_products()
    log("TF32 off for matmul and cuDNN: the plain versions are full fp32; "
        "bf16 products sum in fp32")
    dev = torch.device("cuda")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build(_build.sources())
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    phase_kernels_section(dev)

    rows = (phase_kernels(dev) + phase_mode_kernels(dev)
            + phase_paged_kernels(dev) + phase_bwd_kernels(dev)
            + phase_bf16_kernels(dev))
    t_f = time.perf_counter()
    rows += phase_family_kernels(dev)
    rows += phase_encdec_kernels(dev)
    log(f"phases 17 (a), 18 (a) and 19 (a) took "
        f"{time.perf_counter() - t_f:.1f}s")
    t_f = time.perf_counter()
    rows += phase_sp_family_kernels(dev)
    log(f"phase 21 (a) took {time.perf_counter() - t_f:.1f}s")
    t_sp = time.perf_counter()
    sp_rows = phase_sp_kernels(dev)
    rows += sp_rows
    sp_s = time.perf_counter() - t_sp
    cfg, params, fns, reqs, serve_counts, serve_stats = phase_serve(dev)
    phase_logits(cfg, params, fns, reqs, dev)
    paged_counts = phase_paged_serve(cfg, params, fns, dev)
    t_sp = time.perf_counter()
    sp_counts, sp_runs = phase_sp_serve(
        cfg, params, fns, reqs, serve_stats,
        next(r["nlev"] for r in sp_rows if "nlev" in r), dev)
    sp_s += time.perf_counter() - t_sp
    log(f"phase sp took {sp_s:.1f}s (kernel rows and serving)")
    cq_serve_counts = phase_cq_serve(cfg, params, fns, reqs, serve_stats,
                                     dev)
    sample_counts = phase_sample_serve(cfg, params, fns, reqs, serve_stats,
                                       dev)
    # phase 24 serves phase 5c (c)'s requests again, one shard a rank
    serve_tokens = {r.uid: list(r.out_tokens) for r in reqs}
    rank_prompts = [r.prompt for r in reqs[:RANK_PROMPTS]]
    del params, fns, reqs
    torch.cuda.empty_cache()
    train_counts, train_stats = phase_train(dev)
    phase_grads(dev)
    t_sp = time.perf_counter()
    sp_train_counts = phase_sp_train(dev, train_stats)
    log(f"phase sp train took {time.perf_counter() - t_sp:.1f}s")
    lra_counts, cq_counts = phase_lra(dev)
    torch.cuda.empty_cache()
    t_g = time.perf_counter()
    rows.append(phase_stream_kernel(dev))
    gemma_counts, gemma_params = phase_gemma(dev)
    log(f"phase gemma took {time.perf_counter() - t_g:.1f}s (kernel row "
        f"and serving)")
    gemma_sp_counts = phase_sp_gemma(dev, gemma_params)
    t_g = time.perf_counter()
    rows.append(phase_stream_bwd_kernel(dev))
    box = [gemma_params]        # phase 13 trains, and consumes, them
    del gemma_params
    gemma_train_counts = phase_gemma_train(dev, box)
    log(f"phase gemma train took {time.perf_counter() - t_g:.1f}s (kernel "
        f"row and training)")
    t_g = time.perf_counter()
    dense_bf16_counts = phase_dense_bf16(dev)
    log(f"phase 14 (dense bf16 serving) took "
        f"{time.perf_counter() - t_g:.1f}s")
    t_g = time.perf_counter()
    llama_train_counts = phase_llama_train(dev)
    log(f"phase 15 (llama3.2-1b bf16 training) took "
        f"{time.perf_counter() - t_g:.1f}s")
    full_counts = phase_full(dev, serve_stats, train_stats)
    family_counts = phase_families(dev)
    family_counts["gemma_sp"] = gemma_sp_counts
    t_s = time.perf_counter()
    family_counts.update(phase_ssm_families(dev))
    log(f"phase 18 (b)-(c) (the SSM and hybrid families) took "
        f"{time.perf_counter() - t_s:.1f}s")
    t_s = time.perf_counter()
    family_counts.update(phase_encdec(dev))
    log(f"phase 19 (b)-(c) (the encoder-decoder) took "
        f"{time.perf_counter() - t_s:.1f}s")
    telemetry_counts = phase_telemetry(dev)
    family_counts.update(phase_planning(dev))
    torch.cuda.empty_cache()
    family_counts["ranks"] = phase_ranks(sp_runs["c_d2"], serve_tokens,
                                         rank_prompts)
    family_counts["tp_train"] = phase_tp_train()
    for row in rows:
        # a row name@arch holds its wrapper at arch's shape: its launches
        # are those of the phase 17-19 paths that run that shape
        key, _, arch = row["name"].partition("@")
        if arch:
            row["launches_by_path"] = {
                p: family_counts[p].get(key, 0) for p in row.pop("paths")}
            row["launches"] = sum(row["launches_by_path"].values())
            row["kernel_ms"] = row["ms"]
            continue
        by_path = {"serve": serve_counts.get(key, 0),
                   "paged": paged_counts.get(key, 0),
                   "sp": sp_counts.get(key, 0),
                   "train": train_counts.get(key, 0),
                   "lra": lra_counts.get(key, 0),
                   "coarse_q_train": cq_counts.get(key, 0),
                   "sp_train": sp_train_counts.get(key, 0),
                   "cq_serve": cq_serve_counts.get(key, 0),
                   "sample": sample_counts.get(key, 0),
                   "gemma": gemma_counts.get(key, 0),
                   "gemma_train": gemma_train_counts.get(key, 0),
                   "dense_bf16": dense_bf16_counts.get(key, 0),
                   "llama_train": llama_train_counts.get(key, 0),
                   "full": full_counts.get(key, 0),
                   "telemetry": telemetry_counts.get(key, 0),
                   **{p: c.get(key, 0) for p, c in family_counts.items()}}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        row["kernel_ms"] = row["ms"]
    log(f"all phases took {time.perf_counter() - t0:.1f}s, build included")

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
