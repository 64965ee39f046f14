"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and ``nvcc``; builds
every kernel from the sources in this checkout.  Phases, each printing as
it goes, any failure exiting non-zero:

1. device: the card's name, count and power limit;
2. build: every kernel source, one ``nvcc`` each, all started together,
   with the ptxas register / shared-memory / spill report and the kernels
   that spill;
3. the batched AMAT kernels (K1 ``wi``, K2 ``wo``) against their plain
   PyTorch versions on the card (tolerance 1e-4 + 1e-4*|plain|: f32
   accumulation in another order): both code layouts with the bf16
   activations the main path gives them at its decode (4 sequences) and
   prefill (128 tokens) capacities and at phase 7c's long-prefill
   capacity (9216 tokens: 1229 rows, ten row blocks with a ragged last),
   with f32 activations (the engine's parity mode: three exact bf16
   planes of x) at the decode and prefill capacities, and ragged cases in both types (N = 72, and N = 70 for
   bf16, which the wrapper pads); every route runs on the tensor cores.
   Then K1 and K2 (bf16 and f32 x, decode shape, ``use_lsb``
   alternating by expert) and K3 (bf16 x, M=128, both precision modes)
   on codes quantized at the paper's other configurations, MAT42 (shift 2)
   and MAT63 (shift 3), checked at the same tolerance and not timed.
   The decode shapes are then timed beside the plain version, one
   ``torch.bmm`` on pre-dequantized f32 weights (the nearest library
   call; it reads dense f32 weights, not the packed codes) and the card's
   bound.  Every timed row gives ``ms`` (CUDA events around 20 calls: what
   a caller of the wrapper sees, host cost included) and, for the kernel
   and the library call, ``graph_ms`` (the same 20 calls captured in one
   CUDA graph and replayed: device time); ``[versus]`` lines set each
   decode row's ``graph_ms`` beside the library call's, and each bf16 row
   beside the f32 row of the same run and against its bound.  The
   kernels line reports the bf16 decode variant, the one the decode steps
   launch, and the f32 decode variant as rows of their own;
3b. the slice's kernels against their plain versions at the same
   tolerance, at the widths of configs in the repo: K3 ``amat_matmul``
   (one qwen15-moe-a2.7b expert matrix), K4 ``expert_matmul`` (K1's
   shapes) and K5 ``flash_attention`` (qwen15-moe-a2.7b's causal
   attention, llama4-scout-17b-a16e's windowed GQA attention), each with
   a ragged or small case, K3-K5 with bf16 and f32 inputs (all on the
   tensor cores: f32 K3 and K4 as three exact bf16 planes, f32 K5 in
   3xTF32); timed rows beside the plain version, one library call
   (``torch.matmul`` / ``torch.bmm`` on dense f32 weights,
   ``scaled_dot_product_attention``) and the card's bound, and for the
   K3 and K5 rows a ``[versus]`` line comparing ``graph_ms`` with the
   library call's;
   Then a sweep of K3's K split: ``graph_ms`` of the tensor-core kernel
   with bf16 x at M = 1, 16, 64 and 128 and with f32 x at M = 1 and 128,
   for each split count, the plan's choice marked (the evidence for
   ``mma_plan``);
3c. the slice's path: the public entry points of K3-K5 driven once each
   at those full widths, with the launch counts set to 0 just before and
   read just after; every kernel must have launched and every output be
   finite;
3d. the f32 path: the public entry points of K3 and K5 driven once each
   with f32 inputs at the same widths (the three-plane and 3xTF32
   kernels), counted the same way;
4. a small reference check: the qwen15-moe-repro model (2 layers, f32)
   served on the card through the kernel (K1/K2 on three bf16 planes of
   x) and on the CPU through the plain dense-dequant path must agree
   (tokens exact, logits 1e-4, cache stats equal), with the launch counts
   set to 0 just before and read just after: K1 and K2 must have
   launched.  Then the same with the int8 KV cache (``kv_dtype="int8"``),
   the card's prefill and its decode each counted on their own (K1 and
   K2 must launch in both): prefill logits at 1e-4 and the two devices' caches compared code by
   code; the card decodes from the CPU's cache, carried across (a value
   within an f32 ulp of a rounding tie may take either code), and each
   of 6 steps' logits must agree at 1e-4, tokens and cache stats
   exactly;
5. serving at full width: Qwen1.5-MoE-A2.7B (24 layers, d_model 2048,
   60 experts, bf16, random weights from seed 0), cache-prior + DBSC
   routing with quantized execution, 4 requests of 128 prompt tokens and
   16 new tokens through the continuous-batching scheduler; the kernel's
   launch count must be 2 x 24 x (prefills + decode steps) and every
   logit finite.  The run is recorded (``repro_torch.sim.TraceRecorder``);
   the trace, written to ``build/`` and read back, must equal the record
   and replay (``repro_torch.sim.replay_trace``) to the live run: epoch
   counts, decode accesses and misses and the miss curve exactly, the
   ledger at rtol 1e-6.  Replayed on the async timeline, the same trace
   must keep the energy (rtol 1e-6) and not raise the latency (``[replay]``
   lines, cost model);
5b. the same traffic over the same params on the async slice-I/O timeline
   with request-level prefetch (``prefetch_top_m=4``, lookahead 2, score
   floor 0.02, PCW warmup): K1 and K2 launched 24 x (4 + 16) times each,
   every logit finite, every request served in full, and its recorded
   trace replaying to the live run with the prefetch summary exact
   (``[serve-async]`` lines);
6. train, checkpoint, serve (after 8a, once phase 5's params are
   released):
   Qwen1.5-MoE-A2.7B at its published widths with its depth cut to 2 of
   24 layers (training holds 16 B per parameter: 1.76 B parameters, 28
   GB, where 24 layers would need 229 GB), bf16 from the port's init
   with seed 0, trained for 40 steps with ``train_or_load``'s settings
   (batch 8, seq 64, lr 2e-3, cosine, warmup 4) on ``SyntheticLM``
   (``[train]`` lines: every loss, the wall per step, the peak memory;
   every loss finite and the last below the first and ln(vocab)); the
   weights saved with the port's checkpoint writer under ``build/`` and
   restored onto the card bit for bit (``[ckpt]``); the restored model
   served with phase 5's traffic shape (4 prompts of 128 tokens from
   ``eval_batches``, 16 new tokens each) under Fig. 9's
   ``buddy_highbit`` and under phase 5's Cache-Prior + DBSC + PCW, both
   with quantized execution, each run with the launch counts reset just
   before and read just after (K1 and K2 2 x (4 + 16) = 40 times each);
   the same model at its untrained init served beside it, for the
   ``[serve-6]`` lines' decode miss rates and modeled energy and
   latency (descriptive, cost model).

7. expert parallelism, the SLO controller, int8 KV and blockwise
   attention at full width, over phase 5's params after 5b (each
   engine released before the next is built; phases 8a, 6 and 8b
   follow), every serving run with K1 and K2 launched once per MoE layer
   per forward:
   7a. phase 5's traffic with ``ep_shards=4`` (simulated in the charge
       path on this one card), hotness placement re-packed every 4
       decode steps and the 2 hottest (layer, expert) pairs replicated
       (``[ep]`` lines: per-shard counts, all-to-all and migration
       bytes, ``placement_summary()``); its recorded trace must replay to
       the live run, per-shard epoch counts, migrations and placement
       exactly; at least one migration and some all-to-all traffic;
   7b. the same traffic from two tenants in turn with the int8 KV cache
       and the SLO controller (two tenant SLOs, a partitioned cache):
       the controller's actions and summary, per-tenant miss rates and
       low-bit shares, the KV cache's bytes ((head_dim + 4) / (2
       head_dim) of bf16's) (``[ctl-int8]``); the trace's replay must
       reproduce the live epoch counts and miss curve exactly, the
       energy curve at rtol 1e-6 and the controller's summary;
   7c. one request of 9216 prompt tokens (above the 8192-key threshold:
       every layer's prefill attention runs blockwise) with the int8 KV
       cache, then 4 decode steps; before it, layer 0's q/k/v of that
       prompt in f32 through ``blockwise_attention`` and the dense body
       on the card, which must agree at 1e-4 + 1e-4*|dense|
       (``[long]``: both times, the prefill's wall, peak memory).

8. the paper's experiments through the port's benchmark modules, every
   engine run with quantized execution (K1 and K2 once per MoE layer per
   forward, counted; every logit of every prefill and decode finite,
   read from ``decode``'s ``logits_finite`` metric), energy and latency
   from the cost model, the paper's orderings printed as findings, not
   asserted:
   8a. after 7c, over phase 5's params at full width and depth, one
       engine at a time: Fig. 10's four initial cache states
       (``benchmarks/torch_fig10_warmup.run_init``; one 48-token prompt
       from seed 11, a cache of 0.3 of the store; the reference runs it on
       DeepSeek-V2-Lite, which has no full-width config here), Fig. 9's
       ``cache_prior_highbit`` and ``dbsc_pcw`` schemes
       (``benchmarks/torch_fig9_energy.run_one``; seed 9, the same cache)
       and the ablations' ``--quick`` rows and storage rows
       (``benchmarks/torch_ablations``; the reference's 4e6 B cache is
       31.45% of ``qwen15-moe-repro``'s store, so the cache here is the
       same share of the full store) (``[fig10]``, ``[fig9]``,
       ``[ablate]`` lines);
   8b. after phase 6, on its trained 2-layer model: Fig. 8's float oracle
       and four schemes at its quick cell on a uniform prompt from seed 7
       and on one from ``eval_batches`` (``[fig8]``: normalized miss
       rate, which must lie in [0, 1], top-1 agreement, and the data's
       own next-token law, under which greedy decoding settles on one
       token); Table 1's quick set on ``eval_batches`` beside the PPL
       with the routed experts zeroed (``[table1]``: the asymmetric
       ``amat_high`` PPL must equal ``base_high``'s, which holds by
       construction); and K1 on the trained model's own codes against
       its plain version.  A random init's perplexity sits near the
       vocabulary size for every scheme, so Table 1 needs trained weights.
   ``[phase8]`` gives the seconds phase 8 adds.

9. traced serving, after 7c and before 8a, over phase 5's params: phase
   5's traffic through one engine with phase 5's settings plus 5b's
   ``async_io`` and request prefetch and 7a's ``ep_shards=4``, hotness
   placement every 4 steps and 2 replicas (all six event kinds on the
   timeline), a ``repro_torch.obs.TimelineTracer`` attached to the
   engine and a ``MetricsRegistry`` to the scheduler, K1 and K2 once per
   MoE layer per forward.  Checks: events conserve the ledger by kind;
   every (shard, channel) makespan equals its ``busy_until`` and the
   makespan ``total_latency_s`` (rtol 1e-6); the recorded trace,
   replayed through a file with a tracer, gives the live event stream
   and the same Chrome export outside the requests process; an untraced
   replay gives the traced replay's ledger exactly; the exported file's
   ``trace_report`` totals equal the tracer's; the metrics JSONL has one
   row per decode step, non-decreasing counters and the ledger's traffic
   in its last row (rtol 1e-6).  ``[trace]`` lines: events by kind,
   spans, the Chrome file's size, the report's stall and overlap figures
   (cost model), the tracer's host seconds and the wall per step.

10. the three serving benchmarks at full width, after 9 and before 8a,
   over phase 5's params: every section of ``benchmarks/torch_{
   controller_soak,sim_fidelity,serving_load}.py`` through their own
   functions, one engine at a time, K1 and K2 once per MoE layer per
   forward (neither in the dense-dequant row), every logit finite.  Each
   cache is the reference's as a share of the 2-layer
   ``qwen15-moe-repro`` store, applied to the full store; the traffic is
   the reference's (24-token prompts, 12 new tokens) over the full
   vocabulary, the request counts cut to fit 90 s (``[phase10] reduced``).
   Hard checks: the launch counts; sim_fidelity's replay gates (a),
   cumsum, ep2, ep=1 and its file round trip; the controller's
   live-vs-replay fidelity (b), determinism (c), the soak grid equal to
   the reference's ``results/BENCH_controller_soak.json`` and gate (a);
   async energy equal to serialized; all-to-all bytes 0 at ep 1 and above
   0 beyond; the traced twin's energy exact and makespan equal to the
   ledger's latency; placement's live-vs-replay equalities.  The claims
   calibrated on the 2-layer model are printed ``held`` / ``not held``
   with their numbers; also the traced and untraced twins' host wall per
   forward (the untraced one is the ep section's ep=1 run, right after),
   the tracer's share of its twin's wall, the peak memory and the phase's
   seconds (``[phase10]`` lines).

11. serving extras, at full width:
   11a. after 10 and before 8a, over phase 5's params with phase 5's
       engine settings, one engine at a time: the server's cold path
       (``persistent=False``, a fresh engine per request) on 2 of phase
       5's prompts, its plain-engine path (``engine_cfg=None``: the float
       model, no kernel) on 1, and the batching scheduler with
       ``bucket_prompts=8`` and ``truncate_prompts=True`` on prompts of
       61, 64, 100 and 200 tokens.  Hard checks: K1 and K2 once per MoE
       layer per forward on the cold and clipping paths and never on the
       plain one; every completion its 16 tokens in the vocabulary; the
       admitted lengths those of the clipping rule, ``truncated`` on
       exactly the clipped requests; every ledger total finite
       (``[extras-*]`` lines: wall per token, peak memory);
   11b. after ``del params`` and before 6: the serving CLI,
       ``repro_torch.launch.serve.main``, in this process at full width
       (its own init from seed 0; 2 requests, 64 prompt tokens, 16 new,
       phase 5's cache through ``--cache-mb``), recording its trace and
       writing its Chrome, metrics and Prometheus files, then a bare
       ``--replay-trace`` of that trace.  Hard checks:
       no K1/K2 launch (the CLI keeps the reference's dense-dequant
       default); the replay's energy and latency equal the live ledger's
       (rtol 1e-6) and its epoch miss rates the live cache's, each
       request's decode MSB miss rate the live line's ``miss_rate``; the
       two exports' channel events equal; one metrics sample per decode
       step; a non-empty Prometheus file (``[cli]`` lines).

12. the dense architecture, windows, soft-capping and tied vocabularies,
   and llama4-scout at full width, after 11b and before 6, one model at a
   time, each released before the next is built (``phase_archs``;
   ``[phase12]`` lines give each sub-phase's seconds, peak memory, K1/K2
   launches and measured gaps, each with the card's name and power limit):
   12a. K1 and K2 with bf16 x at ``llama4-scout-17b-a16e``'s decode shapes
       (E=16, M=8; ``wi`` K=5120, N=16384; ``wo`` K=8192, N=5120) against
       their plain versions, timed beside ``torch.bmm`` and the bound, and
       checked at its prefill capacities (M=11 and 41); then Scout at its
       published widths with its depth cut to 8 of 48 layers (``[phase12]
       reduced``; bf16, seed 0) served with phase 5's settings and traffic,
       recorded and replayed.  Hard checks: K1 and K2 each 8 x 20 times,
       every logit finite, the replay equal to the live run;
   12b. ``gemma-7b`` whole (28 layers, GeGLU, head dim 256, tied vocabulary
       of 256000, attention soft-cap 30; bf16) through
       ``SliceMoEServer(engine_cfg=None)``, that is ``PlainEngine``, 2
       requests of 64 + 16 tokens.  Hard checks: no kernel launched; the
       server's tokens equal a direct greedy ``prefill`` / ``decode_step``
       loop's exactly; every logit finite;
   12c. ``starcoder2-3b`` whole in f32 (GELU, ``qkv_bias``, window 4096;
       TF32 off): a 4608-token ``prefill(use_window=True)``, then 8
       ``decode_step(use_window=True)`` steps, each reading the last 4096
       cache rows and held against ``unembed(forward(..., use_window=True))``
       at the last position within 1e-4 + 1e-4*|oracle| (``[window]``
       lines); the unwindowed forward must differ by more than that.
   Rehearse on the CPU with ``phase_archs(device="cpu", scout=...,
   gemma=..., window=..., window_prompt=80)`` over the ``.reduced()``
   configs (StarCoder2's in f32; about 4 s).

13. the Mamba2 (SSD) mixer, the SSM and hybrid architectures, after 12
   and before 6, one model at a time, each released before the next is
   built (``phase_ssm_archs``; ``[phase13]`` lines give each sub-phase's
   seconds, peak memory, K1/K2 launches and measured gaps, each with the
   card's name and power limit; the phase fails past 60 s):
   13a. K1 and K2 with bf16 x at ``jamba-v0.1-52b``'s decode shapes (E=16,
       M=8; ``wi`` K=4096, N=28672; ``wo`` K=14336, N=4096) against their
       plain versions, timed beside ``torch.bmm`` and the bound, and
       checked at its prefill capacities (M=21 and 81);
   13b. Jamba at its published widths with its depth cut to 8 of 32
       layers, one period of its pattern (attention at position 3, SSD
       mixers at the other seven, MoE FFNs at the odd positions; ``[phase13]
       reduced``; bf16, seed 0) served with phase 5's settings and traffic,
       recorded and replayed.  Hard checks: K1 and K2 each 4 MoE layers x
       20 forwards = 80 times, every logit finite, every leaf of the batch
       cache on the card (SSM ``state`` f32, ``conv`` and the KV rows
       bf16), the replay equal to the live run with ``moe_positions``
       (1, 3, 5, 7) in the trace, the peak within 5% of the 43.33 GB the
       shapes give;
   13c. ``mamba2-2.7b`` whole in f32 (64 SSD layers, no attention, no FFN;
       TF32 off): (i) ``SliceMoEServer`` with an engine config serves 2
       requests of 64 + 16 tokens through ``PlainEngine`` (no MoE layer):
       no kernel launched, the tokens equal a direct greedy loop's; (ii)
       one 2000-token prompt (7 chunks of 256 and a padded eighth), then 8
       decode steps, each held against ``unembed(forward(...))`` at the
       last position within 5e-4 x (1 + |oracle|) (``[ssm]`` lines; f32
       sums in another order by two algorithms, the recurrence and the
       chunked scan), and the same steps decoded from a zeroed ``state``
       and ``conv`` outside that tolerance at every step.
   Rehearse on the CPU with ``phase_ssm_archs(device="cpu", jamba=
   get_config("jamba-v0.1-52b").reduced(), mamba=dataclasses.replace(
   get_config("mamba2-2.7b").reduced(), dtype="float32"),
   long_prompt=80)`` (about 3 s).

14. prefix embeddings and the encoder-decoder, after 13 and before 6, one
   model at a time, each released before the next is built
   (``phase_prefix_encdec``; ``[phase14]`` lines give each sub-phase's
   seconds, peak memory, K1/K2 launches and measured gaps, each with the
   card's name and power limit; the phase fails past 60 s):
   14a. ``internvl2-1b`` whole (24 layers, d_model 896, a prefix of 256
       stub patch embeddings; random weights from seed 0): (i) in f32
       (TF32 off) the prefix and a 64-token prompt prefilled, then 8
       greedy decode steps, each held against ``unembed(forward(prefix,
       prompt + tokens so far))`` at the last position within 1e-4 +
       1e-4*|oracle| (``[prefix]`` lines), and the same tokens decoded
       from a prefill without the prefix outside that tolerance at every
       step; (ii) in bf16, ``PlainEngine.generate`` on 2 requests of 64 +
       16 tokens with their prefixes: no kernel launched, the tokens equal
       a direct greedy loop's, every logit finite; (iii) ``train_loop``
       for 10 steps in bf16, batch 2, ``seq_len`` 320 (64 text tokens
       after the cut): every loss finite, the last below the first;
   14b. ``whisper-small`` whole (12 encoder and 12 decoder layers, 1500
       stub frames): the same three parts, (i) against ``forward`` with
       the same frames (``[encdec]`` lines), every step returning the
       cache's own ``ck`` / ``cv`` tensors, bit-equal to what the prefill
       stored, and the control a cache whose ``ck`` / ``cv`` hold the
       encoding of frames from another seed; (ii) with
       ``encoder_frames``; (iii) ``seq_len`` 64;
   14c. K1/K2 behind a prefixed prefill through the engine: a test
       configuration built on the reference's pass-through, not a
       published model (``qwen15-moe-a2.7b`` at its published widths,
       cut to 4 of 24 layers, ``prefix_len=256``), in a ``SliceMoEEngine``
       with phase 5's settings; 256 stub prefix embeddings + 128 tokens
       through ``prefill(tokens, prefix_embeds=...)``, then ``decode(first,
       16)``.  Hard checks: K1 and K2 each 4 x 17 = 68 times, the cache
       position 384 after prefill, every logit finite.
   Rehearse on the CPU with ``phase_prefix_encdec(device="cpu",
   internvl=get_config("internvl2-1b").reduced(), whisper=get_config(
   "whisper-small").reduced(), engine=dataclasses.replace(get_config(
   "qwen15-moe-repro").reduced(), prefix_len=4))`` (about 4 s).

15. the serving variants, ``quantized_serve`` and the ring KV cache, in
   two halves (``phase_serving_variants_{a,b}``; ``[phase15]`` lines give
   each sub-phase's seconds, peak memory, launches and measured gaps, each
   with the card's name and power limit; the phase fails past 60 s):
   15a'. after 8a: K1 on K-major ``wo`` codes, the flat tree's route (it
       holds no output-major copy), at qwen15-moe-a2.7b's ``wo`` shape
       (E=60, M=8, K=1408, N=2048), bf16 and f32 x, against the plain
       version, timed beside ``torch.bmm`` on dense f32 weights and the
       bound, and bf16 x at the 4 x 128-token prefill capacity (M=69);
   15a. then, over phase 5's params (no new model):
       ``quantize_params_for_serve`` at MAT84 (the flat tree beside the
       float one), and phase 5's 4 prompts of 128 tokens through
       ``prefill`` and 16 batched ``decode_step``s on three routes, the
       float params, the flat tree dense-dequant and the flat tree with
       ``quant_execution=True``, the quantized ones fed the float route's
       greedy tokens, (i) from their own prefill and (ii) from the float
       route's prefill cache with its routing (``gate_override``).  A
       random bf16 model at this depth carries any perturbation to 4-15%
       of the logits, as far between the two quantized routes as from
       the float one, so (i) is printed beside that floor.  Hard checks:
       (ii)'s relative L2 to the float route's logits below 0.05 at every
       step (``tests/test_perf_variants.py:66-67``); every logit finite;
       K1 2 x 24 per forward on the quantized route and never on the
       others, K2 never; one checksum per flat leaf kept for 15c;
   15b. after 14: ``starcoder2-3b`` whole in f32 (window 4096; TF32 off)
       with ``ring_kv=True``: a 4000-token prefill into a 4096-row cache,
       then 160 ``decode_step(use_window=True)`` steps (positions
       4000-4159, rows 0-63 overwritten); the last step before the wrap,
       the first after it and the last two held against
       ``unembed(forward(..., use_window=True))`` within 1e-4 +
       1e-4*|oracle|, the unwindowed forward outside it at the last step;
       the cache still 4096 rows, rows 0-63 all changed and rows 64-3999
       as the prefill left them (``[ring]`` lines; the KV bytes against a
       4160-row cache without ring);
   15c. then ``init_params`` of qwen15-moe-a2.7b with ``quantized_serve``
       from scratch (seed 0): its own peak (over what earlier phases leave
       allocated) at most 20 GB, where the float tree alone is 28.6 GB,
       and every flat leaf's checksum equal to 15a's.
   Rehearse on the CPU with ``phase_serving_variants_a(cfg, params,
   prompts, device="cpu")`` over a 2-layer f32 ``qwen15-moe-repro`` and
   four random prompts of 128 tokens, then ``phase_serving_variants_b(cfg,
   sums, t_a, device="cpu", ring=dataclasses.replace(get_config(
   "starcoder2-3b").reduced(), dtype="float32"), ring_prompt=60,
   ring_steps=10)`` (about 2 s).

16. the launch layer and the dry-run, last, with no model resident
   (``phase_launch``; ``[phase16]`` lines give each sub-phase's seconds
   with the card's name and power limit; the phase fails past 60 s):
   16a. ``launch.dryrun.run_pair`` in this process on the single-pod mesh
       for every shape of smollm-360m and llama4-maverick-400b-a17b, each
       step run on the ``meta`` device (``[dryrun]`` lines: argument bytes
       a device, the H100 roofline terms, the meta run's seconds); fails
       on any ``error``;
   16b. four pairs through ``step_for_shape`` at full width and depth,
       only the global batch cut: smollm-360m x train_4k (B=1),
       starcoder2-3b x prefill_32k (B=1), gemma-7b x decode_32k (B=2, a
       full 32768-row cache) and mamba2-2.7b x long_500k (B=1), each on
       inputs made on the card from ``input_specs(cfg, shape,
       make_host_mesh())`` (``[launch]`` lines).  Hard checks: the inputs'
       bytes equal the spec tree's ``argument_size_in_bytes``; no K1-K5
       launch (the reference's steps set no ``quant_execution``); every
       output finite, every train loss finite, the prefill's cache at its
       prompt's length, decode's token the argmax of its logits and its
       cache position one further; the peak below 70 GB.  Printed: the
       median wall of 3 calls after a warm-up (a pair whose first call
       takes over 5 s: that call), the peak and the temp bytes over the
       arguments, the H100 roofline of ``launch.costs.analytic_costs`` at
       the cut shape and wall / bound.
   Rehearse on the CPU with ``phase_launch(device="cpu", configs={arch:
   get_config(arch).reduced() for arch, _, _ in P16_PAIRS}, seq_len=512)``
   (about 40 s).

``--profile`` adds a phase run between 5 and 5b: a second round of the
same traffic with its decode steps under ``torch.profiler`` (device time
and launches per step by kernel, the engine's host ranges, the device's
busy share).  Without arguments the script runs phases 1 to 16.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the kernels' JSON record (K1-K5, and the f32 routes of K1, K2, K3
and K5 as rows of their own; ``launches`` counts phase 5's run for K1
(plus 15a's quantized route) and K2, phase 3c's for K3-K5, phase 3d's
for the f32 rows of K3 and K5 and phase 4's bf16-KV run for the f32 rows
of K1 and K2; ``graph_ms`` and ``library_graph_ms`` beside ``ms`` and
``library_ms``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

TOL_ABS, TOL_REL = 1e-4, 1e-4


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def _close(a: float, b: float, rtol: float) -> bool:
    return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, what: str, *, warmup: int = 3, iters: int = 20) -> float:
    """The same ``iters`` calls as :func:`time_ms`, after warm-up on a side
    stream, captured once in a CUDA graph and replayed between CUDA events:
    device time without the host's launch gaps.  A capture that the
    default mode refuses is said and retried in the relaxed mode; raises
    ``RuntimeError`` if neither takes it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for mode in ("global", "relaxed"):
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode=mode):
                for _ in range(iters):
                    fn()
        except RuntimeError as e:
            say(f"[graph] {what}: capture in mode {mode!r} refused: {e}")
            torch.cuda.synchronize()
            continue
        graph.replay()                  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
        return start.elapsed_time(end) / iters
    raise RuntimeError(f"{what}: no CUDA graph could be captured")


# --------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_name_power()
    say(f"[device] {name} x{count}; nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    """Every kernel source, one ``nvcc`` each, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels._build import build_library
    from repro_torch.kernels.amat_matmul.ops import SOURCE as AMAT_SOURCE
    from repro_torch.kernels.flash_attn.ops import SOURCE as FLASH_SOURCE

    def build(source):
        t0 = time.perf_counter()
        lib, log = build_library(source, force=True)
        return lib, log, time.perf_counter() - t0

    sources = (AMAT_SOURCE, FLASH_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(build, sources))
    spills = []
    for source, (lib, log, dt) in zip(sources, built):
        say(f"[build] {os.path.relpath(source, HERE)} -> "
            f"{os.path.relpath(lib, HERE)} in {dt:.1f} s")
        entry = None
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                say("[build]   " + line.strip())
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "spill" in line and any(
                    int(w) for w in line.split() if w.isdigit()):
                spills.append(entry)
    say(f"[build] kernels that spill: {spills or 'none'}")


def _kernel_inputs(E, M, K, N, *, seed, transposed, x_dtype, mat=None):
    """Weights drawn as the model draws them and AMAT-quantized on the
    card (at MAT84 unless ``mat`` says otherwise); a seeded mixed use_lsb
    (alternating by expert when ``mat`` is given); activations in
    ``x_dtype``."""
    from repro_torch.core.amat import MAT84, amat_quantize

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((E, M, K), generator=g, device="cuda").to(x_dtype)
    w = torch.randn((E, K, N), generator=g, device="cuda") * K ** -0.5
    qt = amat_quantize(w, mat or MAT84)
    del w
    codes = qt.codes.transpose(1, 2).contiguous() if transposed else qt.codes
    if mat is None:
        use_lsb = torch.rand((E,), generator=g, device="cuda") < 0.5
        use_lsb[0], use_lsb[-1] = True, False
    else:
        use_lsb = torch.arange(E, device="cuda") % 2 == 0
    return x, codes, qt.scales, qt.zero_points, use_lsb


def _bound(nbytes: float, flops: dict):
    """The least time the card could take: the largest of the bytes over
    HBM3's rate and, for each operand type, its operations (``flops``,
    by key of ``H100.peak_flops``: bf16 and tf32 on the tensor cores, f32
    on the CUDA cores) over the card's peak for that type
    (``repro_torch.hw.specs.H100``, the data sheet's dense rates).  The
    tensor cores and the CUDA cores run side by side, so the types' times
    do not add."""
    from repro_torch.hw.specs import H100

    t_bytes = nbytes / H100.hbm_bytes_per_s * 1e3
    t_ops = max(n / H100.peak_flops[kind] * 1e3 for kind, n in flops.items())
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _amat_flops(x_dtype, n: float) -> dict:
    """The operations of an AMAT dequant-matmul by operand type.  Its
    weights are integers of at most 8 bits, exact in bf16, times one
    scale per 32-row group, which can be applied after the group's
    product: with bf16 activations the whole product is bf16 work, and
    f32 activations split exactly into three bf16 planes, so their
    product is three times that bf16 work."""
    return {"bf16": n if x_dtype == torch.bfloat16 else 3 * n}


def _visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the attention mask lets through, per sequence
    and head: the work this input needs."""
    q = np.arange(sq, dtype=np.int64)
    last = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    first = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.clip(last - first + 1, 0, None).sum())


def _rotating(fn, items):
    """A call of ``fn`` on the next of ``items`` each time, in turn."""
    it = itertools.cycle(items)
    return lambda: fn(next(it))


def _check_row(name, got, want, shape) -> float:
    if got.is_cuda:
        torch.cuda.synchronize()
    if tuple(got.shape) != tuple(shape) or not bool(torch.isfinite(got).all()):
        fail(f"kernel {name}: bad output {tuple(got.shape)}")
    err = (got - want).abs()
    max_err = float(err.max())
    ok = bool((err <= TOL_ABS + TOL_REL * want.abs()).all())
    say(f"[kernel] {name}: max|kernel-plain| = {max_err:.3e} "
        f"(tol 1e-4 + 1e-4*|plain|) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"kernel {name} disagrees with its plain version")
    return max_err


def _timed(name, kern, plain, library, library_what, nbytes, flops, note):
    t = {"ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
         "library_ms": None, "library_graph_ms": None}
    try:
        t["graph_ms"] = graph_ms(kern, name)
    except RuntimeError as e:
        fail(str(e))
    try:
        t["library_ms"] = time_ms(library)
        t["library_graph_ms"] = graph_ms(library, f"{name} library call")
    except RuntimeError as e:       # out of memory, or no backend for it
        say(f"[kernel] {name}: library call {library_what} not timed: {e}")
    t["bound_ms"], t["bound_by"] = _bound(nbytes, flops)
    lib = ", ".join(f"{k} {'null' if t[k] is None else f'{t[k]:.4f}'}"
                    for k in ("library_ms", "library_graph_ms"))
    say(f"[kernel] {name} timing: kernel {t['ms']:.4f} ms (graph "
        f"{t['graph_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
        f"{library_what} {lib}; bound "
        f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({nbytes / 1e6:.1f} MB, "
        + ", ".join(f"{n / 1e9:.2f} GFLOP {kind}"
                    for kind, n in flops.items()) + f"); {note}")
    torch.cuda.empty_cache()
    return t


def _versus_library(name, t) -> None:
    """Say whether the kernel's graph time is no slower than the library
    call's (the yardstick of a redesigned kernel)."""
    if t["library_graph_ms"] is None:
        say(f"[versus] {name}: library call not timed")
        return
    ratio = t["graph_ms"] / t["library_graph_ms"]
    say(f"[versus] {name}: graph_ms kernel {t['graph_ms']:.4f} / library "
        f"{t['library_graph_ms']:.4f} = {ratio:.3f} "
        f"({'no slower' if ratio <= 1.0 else 'SLOWER'} than the library)")


def phase_kernels(cfg):
    """Each variant of the kernel against its plain version at the shapes
    the main path gives it, then timed.  The main path runs bf16
    activations (the model's dtype) at the decode capacity (4 sequences),
    the prefill capacity (128 tokens) and phase 7c's long-prefill capacity
    (``LONG_PROMPT`` tokens, more than one block of rows); the f32 rows
    are the engine's f32 parity mode (three bf16 planes of x) at the
    decode and prefill shapes.  Returns, per code layout and activation
    type (``k_major``, ``output_major``, with ``_f32`` for f32 x), the
    timings of the decode variant and the largest error over all its
    rows."""
    from repro_torch.kernels.amat_matmul import ops
    from repro_torch.kernels.amat_matmul.ref import (
        _dequant_mixed_ref, amat_batched_matmul_ref, amat_batched_matmul_t_ref)
    from repro_torch.models.moe import capacity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cfg.moe
    m_dec = capacity(4, m.top_k, m.n_experts, m.capacity_factor)
    m_pre = capacity(128, m.top_k, m.n_experts, m.capacity_factor)
    m_long = capacity(LONG_PROMPT, m.top_k, m.n_experts, m.capacity_factor)
    wi = (m.n_experts, cfg.d_model, 2 * m.d_ff)         # (E, K, N)
    wo = (m.n_experts, m.d_ff, cfg.d_model)
    f32, bf16 = torch.float32, torch.bfloat16
    variants = [
        # name, layout, transposed, x dtype, (E, M, K, N), timed, reported
        ("wi_f32_decode", "k_major", False, f32, (wi[0], m_dec, *wi[1:]),
         True, True),
        ("wo_t_f32_decode", "output_major", True, f32,
         (wo[0], m_dec, *wo[1:]), True, True),
        ("wi_bf16_decode", "k_major", False, bf16, (wi[0], m_dec, *wi[1:]),
         True, True),
        ("wo_t_bf16_decode", "output_major", True, bf16,
         (wo[0], m_dec, *wo[1:]), True, True),
        ("wi_bf16_prefill", "k_major", False, bf16, (wi[0], m_pre, *wi[1:]),
         False, False),
        ("wo_t_bf16_prefill", "output_major", True, bf16,
         (wo[0], m_pre, *wo[1:]), False, False),
        ("wi_bf16_long_prefill", "k_major", False, bf16,
         (wi[0], m_long, *wi[1:]), False, False),
        ("wo_t_bf16_long_prefill", "output_major", True, bf16,
         (wo[0], m_long, *wo[1:]), False, False),
        ("wi_f32_prefill", "k_major", False, f32, (wi[0], m_pre, *wi[1:]),
         False, False),
        ("wo_t_f32_prefill", "output_major", True, f32,
         (wo[0], m_pre, *wo[1:]), False, False),
        ("ragged_wi_f32", "k_major", False, f32, (3, 5, 96, 72), False,
         False),
        ("ragged_wo_t_f32", "output_major", True, f32, (3, 5, 96, 72), False,
         False),
        ("ragged_wi_bf16", "k_major", False, bf16, (3, 5, 96, 72), False,
         False),
        ("ragged_wo_t_bf16", "output_major", True, bf16, (3, 5, 96, 72),
         False, False),
        ("ragged_n_wi_bf16", "k_major", False, bf16, (3, 5, 96, 70), False,
         False),
        ("ragged_n_wo_t_bf16", "output_major", True, bf16, (3, 5, 96, 70),
         False, False),
    ]
    results = {k: {"max_abs_err": 0.0} for k in (
        "k_major", "output_major", "k_major_f32", "output_major_f32")}
    timings = {}
    for seed, (name, layout, transposed, x_dtype, (E, M, K, N), timed,
               reported) in enumerate(variants):
        args = _kernel_inputs(E, M, K, N, seed=seed, transposed=transposed,
                              x_dtype=x_dtype)
        ref = amat_batched_matmul_t_ref if transposed else amat_batched_matmul_ref

        def kern():
            return ops.amat_expert_matmul(*args, group_size=32, shift=4,
                                          transposed=transposed)

        def plain():
            return ref(*args, group_size=32, shift=4)

        max_err = _check_row(f"{name} E={E} M={M} K={K} N={N}", kern(),
                             plain(), (E, M, N))
        row = results[layout + ("_f32" if x_dtype == f32 else "")]
        row["max_abs_err"] = max(row["max_abs_err"], max_err)
        if timed:
            x, codes, scales, zps, use_lsb = args
            codes_kn = codes.transpose(1, 2) if transposed else codes
            w_dense = _dequant_mixed_ref(codes_kn, scales, zps, use_lsb,
                                         group_size=32, shift=4).contiguous()
            x32 = x.float()             # exact for bf16 x: the same function
            nbytes = (codes.numel() + scales.numel() * 4 + zps.numel()
                      + x.numel() * x.element_size() + E * M * N * 4
                      + use_lsb.numel())
            t = _timed(name, kern, plain, lambda: torch.bmm(x32, w_dense),
                       "torch.bmm on dense f32 weights", nbytes,
                       _amat_flops(x_dtype, 2.0 * E * M * K * N),
                       f"the library call reads {E * K * N * 4 / 1e6:.0f} MB "
                       f"of f32 weights, not the {codes.numel() / 1e6:.0f} MB "
                       "of codes")
            del w_dense, x32
            timings[name] = t
            if reported:
                row.update(t)
        del args
        torch.cuda.empty_cache()
    for bf, f in (("wi_bf16_decode", "wi_f32_decode"),
                  ("wo_t_bf16_decode", "wo_t_f32_decode")):
        t, t32 = timings[bf], timings[f]
        _versus_library(bf, t)
        _versus_library(f, t32)
        say(f"[versus] {bf}: graph_ms bf16 x {t['graph_ms']:.4f} / f32 x as "
            f"three bf16 planes ({f}) {t32['graph_ms']:.4f} = "
            f"{t['graph_ms'] / t32['graph_ms']:.3f}, both on the tensor "
            f"cores; {t['bound_ms'] / t['graph_ms']:.1%} and "
            f"{t32['bound_ms'] / t32['graph_ms']:.1%} of their "
            f"{t['bound_by']} / {t32['bound_by']} bounds {t['bound_ms']:.4f} "
            f"/ {t32['bound_ms']:.4f} ms")
    return results


def phase_other_mats(cfg):
    """K1, K2 and K3 against their plain versions on codes quantized at
    the paper's other MAT configurations, MAT42 (shift 2) and MAT63
    (shift 3), not timed: K1 (``wi``, K-major) and K2 (``wo``, output-
    major) at the decode shape with bf16 and f32 x (three bf16 planes)
    and ``use_lsb`` alternating by expert, and K3 on one expert's ``wi``
    at M=128 with bf16 x in both precision modes.  Returns the largest
    error per kernels-line key."""
    from repro_torch.core.amat import MAT42, MAT63, amat_quantize
    from repro_torch.kernels.amat_matmul import ops
    from repro_torch.kernels.amat_matmul.ref import (
        amat_batched_matmul_ref, amat_batched_matmul_t_ref, amat_matmul_ref)
    from repro_torch.models.moe import capacity

    m = cfg.moe
    M = capacity(4, m.top_k, m.n_experts, m.capacity_factor)
    wi = (m.n_experts, M, cfg.d_model, 2 * m.d_ff)      # (E, M, K, N)
    wo = (m.n_experts, M, m.d_ff, cfg.d_model)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}
    for seed, (mat, (layout, transposed, shape), x_dtype) in enumerate(
            itertools.product((MAT42, MAT63),
                              (("k_major", False, wi),
                               ("output_major", True, wo)),
                              (bf16, f32)), start=500):
        E, M, K, N = shape
        args = _kernel_inputs(E, M, K, N, seed=seed, transposed=transposed,
                              x_dtype=x_dtype, mat=mat)
        ref = amat_batched_matmul_t_ref if transposed \
            else amat_batched_matmul_ref
        got = ops.amat_expert_matmul(*args, group_size=32, shift=mat.shift,
                                     transposed=transposed)
        want = ref(*args, group_size=32, shift=mat.shift)
        key = layout + ("_f32" if x_dtype == f32 else "")
        err = _check_row(f"{layout}_{str(x_dtype)[6:]}_decode[{mat.name}] "
                         f"E={E} M={M} K={K} N={N} shift={mat.shift}",
                         got, want, (E, M, N))
        errs[key] = max(errs.get(key, 0.0), err)
        del args, got, want
    g = torch.Generator(device="cuda")
    g.manual_seed(510)
    K, N = cfg.d_model, 2 * m.d_ff
    for mat in (MAT42, MAT63):
        qt = amat_quantize(torch.randn((K, N), generator=g, device="cuda")
                           * K ** -0.5, mat)
        x = torch.randn((128, K), generator=g, device="cuda").to(bf16)
        for mode in ("high", "low"):
            err = _check_row(
                f"amat_single_prefill_{mode}[{mat.name}] M=128 K={K} N={N} "
                f"shift={mat.shift} bfloat16",
                ops.amat_matmul_qt(x, qt, shift=mat.shift, mode=mode),
                amat_matmul_ref(x, qt.codes, qt.scales, qt.zero_points,
                                shift=mat.shift, mode=mode), (128, N))
            errs["single"] = max(errs.get("single", 0.0), err)
    torch.cuda.empty_cache()
    return errs


def phase_slice_kernels(cfg):
    """This slice's kernels against their plain versions on the card, at
    the widths of configs in the repo, and the timed rows beside the
    plain version, one library call and the card's bound:

    * K3 ``amat_matmul``: one qwen15-moe-a2.7b expert's ``wi`` (K=2048,
      N=2816) at the prefill capacity (M=128) in each precision mode, with
      bf16 and f32 (three bf16 planes) activations, and at one
      decode token, and the reference's ragged M=7, K=96, N=33 in both;
    * K4 ``expert_matmul``: K1's ``wi`` shapes (E=60 at the decode and
      prefill capacities; the decode row timed with bf16 and f32 x) and
      the reference's ragged E=8, C=33, K=96;
    * K5 ``flash_attention``: qwen15-moe-a2.7b's causal attention at 4
      sequences of 4096 (bf16 and f32 inputs), llama4-scout-17b-a16e's
      windowed GQA attention
      at 12288 tokens, and two of the reference's small cases.

    Returns, per reported kernel (the launch-counter key, with ``_f32``
    for the f32 routes of K3 and K5), the reported row's timings and the
    largest error over all that kernel's rows."""
    from repro_torch.core.amat import MatConfig, amat_quantize
    from repro_torch.kernels.amat_matmul import ops as amat_ops
    from repro_torch.kernels.amat_matmul.ref import (_dequant_mixed_ref,
                                                     amat_matmul_ref)
    from repro_torch.kernels.expert_matmul import ops as expert_ops
    from repro_torch.kernels.expert_matmul.ref import expert_matmul_ref
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn.ref import flash_attention_ref
    from repro_torch.models.moe import capacity

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda")
    g.manual_seed(100)
    results = {k: {"max_abs_err": 0.0} for k in (
        "single", "single_f32", "expert", "flash", "flash_f32")}

    def record(key, max_err, timing, reported):
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"],
                                          max_err)
        if reported:
            results[key].update(timing)

    # K3: one matrix.  Ten quantized copies (58 MB of codes) rotate in the
    # timed loops, so that the bytes come from HBM and not the 50 MB L2.
    # Its f32 rows report as "single_f32".
    mat = MatConfig(8, 4)

    def quantized(k, n):
        return amat_quantize(
            torch.randn((k, n), generator=g, device="cuda") * k ** -0.5, mat)

    m = cfg.moe
    K, N = cfg.d_model, 2 * m.d_ff
    copies = [quantized(K, N) for _ in range(10)]
    single_rows = [
        # name, M, K, N, x dtype, mode, shift, timed, reported
        ("amat_single_prefill_high", 128, K, N, bf16, "high", 0, True, True),
        ("amat_single_prefill_high_f32", 128, K, N, f32, "high", 0, True,
         True),
        ("amat_single_prefill_low4", 128, K, N, bf16, "low", 4, True, False),
        ("amat_single_prefill_low2", 128, K, N, bf16, "low", 2, False, False),
        ("amat_single_decode_low4", 1, K, N, bf16, "low", 4, True, False),
        ("amat_single_ragged", 7, 96, 33, f32, "low", 4, False, False),
        ("amat_single_ragged_bf16", 7, 96, 33, bf16, "low", 4, False, False),
    ]
    for name, M, k, n, xd, mode, shift, timed, reported in single_rows:
        qts = copies if k == K else [quantized(k, n)]
        x = torch.randn((M, k), generator=g, device="cuda").to(xd)

        def kern(qt):
            return amat_ops.amat_matmul_qt(x, qt, shift=shift, mode=mode)

        def plain(qt):
            return amat_matmul_ref(x, qt.codes, qt.scales, qt.zero_points,
                                   shift=shift, mode=mode)

        err = _check_row(f"{name} M={M} K={k} N={n} {mode} shift={shift} "
                         f"{str(xd)[6:]}", kern(qts[0]), plain(qts[0]),
                         (M, n))
        t = None
        if timed:
            hi = torch.tensor([mode == "high"], device="cuda")
            dense = [_dequant_mixed_ref(
                qt.codes[None], qt.scales[None], qt.zero_points[None], hi,
                group_size=32, shift=shift)[0] for qt in qts]
            x32 = x.float()         # exact for bf16 x: the same function
            nbytes = (k * n + (k // 32) * n * 5
                      + x.numel() * x.element_size() + M * n * 4)
            t = _timed(name, _rotating(kern, qts), _rotating(plain, qts),
                       _rotating(lambda w: torch.matmul(x32, w), dense),
                       "torch.matmul on dense f32 weights", nbytes,
                       _amat_flops(xd, 2.0 * M * k * n),
                       "each loop rotates over 10 copies (58 MB of codes, "
                       "231 MB of dense f32 for the library call)")
            _versus_library(name, t)
            del dense
        record("single" if xd == bf16 else "single_f32", err, t, reported)
    del copies
    torch.cuda.empty_cache()

    # K4: the batched expert matmul at K1's wi shapes.
    E = m.n_experts
    c_dec = capacity(4, m.top_k, E, m.capacity_factor)
    c_pre = capacity(128, m.top_k, E, m.capacity_factor)
    expert_rows = [
        # name, (E, C, K, N), x dtype, timed, reported
        ("expert_decode", (E, c_dec, K, N), bf16, True, True),
        ("expert_decode_f32", (E, c_dec, K, N), f32, True, False),
        ("expert_prefill", (E, c_pre, K, N), bf16, False, False),
        ("expert_ragged", (8, 33, 96, 128), f32, False, False),
    ]
    for seed, (name, (e, c, k, n), xd, timed, reported) in enumerate(
            expert_rows, start=20):
        args = _kernel_inputs(e, c, k, n, seed=seed, transposed=False,
                              x_dtype=xd)

        def kern():
            return expert_ops.expert_matmul(*args, group_size=32, shift=4)

        def plain():
            return expert_matmul_ref(*args, group_size=32, shift=4)

        err = _check_row(f"{name} E={e} C={c} K={k} N={n} {str(xd)[6:]}",
                         kern(), plain(), (e, c, n))
        t = None
        if timed:
            x, codes, scales, zps, use_lsb = args
            w_dense = _dequant_mixed_ref(codes, scales, zps, use_lsb,
                                         group_size=32, shift=4).contiguous()
            x32 = x.float()
            nbytes = (codes.numel() + scales.numel() * 4 + zps.numel()
                      + x.numel() * x.element_size() + e * c * n * 4 + e)
            t = _timed(name, kern, plain, lambda: torch.bmm(x32, w_dense),
                       "torch.bmm on dense f32 weights", nbytes,
                       _amat_flops(xd, 2.0 * e * c * k * n),
                       f"{codes.numel() / 1e6:.0f} MB of codes, past the L2")
            del w_dense, x32
        record("expert", err, t, reported)
        del args
        torch.cuda.empty_cache()

    # K5: attention.  llama4-scout-17b-a16e's widths are those of
    # src/repro/configs/llama4_scout_17b_a16e.py (40 heads, 8 KV heads of
    # 128, sliding window 8192); the port does not carry that config.
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    flash_rows = [
        # name, (B, Sq, Sk, H, Hkv, D), causal, window, dtype, timed, reported
        ("flash_qwen_causal", (4, 4096, 4096, hq, hkv, d), True, None, bf16,
         True, True),
        ("flash_qwen_causal_f32", (4, 4096, 4096, hq, hkv, d), True, None,
         f32, True, True),
        ("flash_scout_window", (1, 12288, 12288, 40, 8, 128), True, 8192,
         bf16, True, False),
        ("flash_small_noncausal", (1, 16, 16, 4, 2, 32), False, None, f32,
         False, False),
        ("flash_small_ragged", (1, 17, 33, 4, 4, 64), True, 8, f32, False,
         False),
    ]
    for name, (b, sq, sk, h, hk, dd), causal, win, dt, timed, reported \
            in flash_rows:
        q = torch.randn((b, sq, h, dd), generator=g, device="cuda").to(dt)
        k = torch.randn((b, sk, hk, dd), generator=g, device="cuda").to(dt)
        v = torch.randn((b, sk, hk, dd), generator=g, device="cuda").to(dt)

        def kern():
            return flash_ops.flash_attention(q, k, v, causal=causal,
                                             sliding_window=win)

        def plain():
            return flash_attention_ref(q, k, v, causal=causal,
                                       sliding_window=win)

        want = plain()
        err = _check_row(f"{name} B={b} Sq={sq} Sk={sk} H={h} Hkv={hk} "
                         f"D={dd} causal={causal} window={win} "
                         f"{str(dt)[6:]}", kern(), want, (b, sq, h, dd))
        t = None
        if timed:
            qf, kf, vf = (t_.float().repeat_interleave(h // t_.shape[2], 2)
                          .transpose(1, 2).contiguous() for t_ in (q, k, v))
            mask = None
            if win is not None:
                qpos = torch.arange(sq, device="cuda")[:, None]
                kpos = torch.arange(sk, device="cuda")[None, :]
                mask = qpos - kpos < win
                if causal:
                    mask &= qpos >= kpos

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qf, kf, vf, attn_mask=mask,
                    is_causal=causal and mask is None)

            what = ("scaled_dot_product_attention on f32 [B, H, S, D] with "
                    + ("is_causal" if mask is None else "a boolean mask"))
            try:
                lib_err = float((library().transpose(1, 2) - want).abs().max())
                note = f"library max|sdpa-plain| = {lib_err:.3e}"
            except RuntimeError as e:
                note = f"library call failed: {e}"
            del want
            nbytes = ((q.numel() + k.numel() + v.numel()) * q.element_size()
                      + q.numel() * 4)
            # 2*D for q.k and 2*D for p.v per visible (query, key) pair.
            # With bf16 inputs the cheapest route that holds the tolerance
            # is three bf16 products: q.k (exact) and p.v as p_hi.v +
            # p_lo.v (the f32 p split in two bf16 parts); with f32 inputs
            # six TF32 products: q.k and p.v each as hi.hi + hi.lo + lo.hi.
            half = 2.0 * dd * b * h * _visible_pairs(sq, sk, causal, win)
            flops = {"bf16": 3 * half} if dt == bf16 else {"tf32": 6 * half}
            t = _timed(name, kern, plain, library, what, nbytes, flops, note)
            _versus_library(name, t)
            del qf, kf, vf, mask
        record("flash" if dt == bf16 else "flash_f32", err, t, reported)
        del q, k, v
        torch.cuda.empty_cache()
    return results


def phase_sweep_splits(cfg):
    """``graph_ms`` of K3's tensor-core kernel ('low' at shift 4, one
    qwen15-moe-a2.7b ``wi``, rotating over 10 copies) for each K split in
    turn, the plan's choice marked: the evidence for the split rule.  bf16
    x at four sizes of M, f32 x (three planes) at the prefill and decode
    ends."""
    from repro_torch.core.amat import MatConfig, amat_quantize
    from repro_torch.kernels.amat_matmul import ops as amat_ops

    g = torch.Generator(device="cuda")
    g.manual_seed(300)
    K, N = cfg.d_model, 2 * cfg.moe.d_ff
    qts = [amat_quantize(torch.randn((K, N), generator=g, device="cuda")
                         * K ** -0.5, MatConfig(8, 4)) for _ in range(10)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = amat_ops.mma_plan
    try:
        for M, xd in ((1, torch.bfloat16), (16, torch.bfloat16),
                      (64, torch.bfloat16), (128, torch.bfloat16),
                      (1, torch.float32), (128, torch.float32)):
            x = torch.randn((M, K), generator=g, device="cuda").to(xd)
            planes = 1 if xd == torch.bfloat16 else amat_ops.X_PLANES
            m_tiles, chosen = plan(M, K, N, 32, sms, planes)
            row = []
            for splits in (1, 2, 3, 4, 6, 8, 12, 16):
                amat_ops.mma_plan = (lambda *a, s=splits, t=m_tiles: (t, s))
                t = graph_ms(_rotating(lambda qt: amat_ops.amat_matmul_qt(
                    x, qt, shift=4, mode="low"), qts), f"sweep M={M}")
                row.append(f"{splits}{'*' if splits == chosen else ''}: "
                           f"{t:.4f}")
            say(f"[sweep] K3 {str(xd)[6:]} M={M} K={K} N={N} "
                f"m_tiles={m_tiles}, "
                f"graph_ms by splits (* = the plan's): " + ", ".join(row))
    finally:
        amat_ops.mma_plan = plan


def _counted(run):
    """``run()`` with every kernel's launch count set to 0 just before and
    read just after; returns its result and the counts."""
    from repro_torch.kernels.amat_matmul import ops as amat_ops
    from repro_torch.kernels.expert_matmul import ops as expert_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops

    counters = (amat_ops.LAUNCHES, expert_ops.LAUNCHES, flash_ops.LAUNCHES)
    sync = torch.cuda.synchronize if torch.cuda.is_initialized() \
        else (lambda: None)
    sync()
    for c in counters:
        c.reset()
    out = run()
    sync()
    return out, {k: n for c in counters for k, n in c.by_key.items()}


def _drive_entry_points(tag, run, want):
    """Set every kernel's launch count to 0, call ``run()``, which returns
    ``{what: (output, expected shape)}``, and read the counts just after.
    Fails if an output is not finite or of another shape, or if the counts
    are not ``want``; returns the counts."""
    outs, launches = _counted(run)
    for what, (out, shape) in outs.items():
        finite = bool(torch.isfinite(out).all())
        say(f"[{tag}] {what}: {tuple(out.shape)} f32, finite {finite}")
        if tuple(out.shape) != shape or not finite:
            fail(f"{tag}: {what} gave a bad output")
    say(f"[{tag}] kernel launches: {launches} (want {want})")
    if launches != want:
        fail(f"{tag}: the entry points did not each launch their kernel")
    return launches


def phase_slice_path(cfg):
    """This slice's path: the public entry points of K3-K5
    (``amat_matmul_qt`` in both precisions, ``expert_matmul_qt``,
    ``flash_attention`` causal and windowed), driven once each at the
    full-width shapes of phase 3b, with every launch count set to 0 just
    before and read just after.  Returns the counts."""
    from repro_torch.core.amat import MatConfig, amat_quantize
    from repro_torch.kernels.amat_matmul import ops as amat_ops
    from repro_torch.kernels.expert_matmul import ops as expert_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models.moe import capacity

    g = torch.Generator(device="cuda")
    g.manual_seed(200)
    bf16 = torch.bfloat16
    m = cfg.moe
    E, K, N = m.n_experts, cfg.d_model, 2 * m.d_ff
    C = capacity(4, m.top_k, E, m.capacity_factor)
    mat = MatConfig(8, 4)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    qt_one = amat_quantize(randn(K, N) * K ** -0.5, mat)
    qt_experts = amat_quantize(randn(E, K, N) * K ** -0.5, mat)
    use_lsb = torch.rand((E,), generator=g, device="cuda") < 0.5
    x_pre, x_dec, x_exp = (randn(128, K).to(bf16), randn(1, K).to(bf16),
                           randn(E, C, K).to(bf16))
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qwen = [randn(4, 4096, h, d).to(bf16) for h in (hq, hkv, hkv)]
    scout = [randn(1, 12288, h, 128).to(bf16) for h in (40, 8, 8)]
    return _drive_entry_points("path", lambda: {
        "amat_matmul_qt high, M=128": (amat_ops.amat_matmul_qt(
            x_pre, qt_one, mode="high"), (128, N)),
        "amat_matmul_qt low shift 4, M=1": (amat_ops.amat_matmul_qt(
            x_dec, qt_one, shift=4, mode="low"), (1, N)),
        f"expert_matmul_qt E={E} C={C}": (expert_ops.expert_matmul_qt(
            x_exp, qt_experts, use_lsb, shift=4), (E, C, N)),
        "flash_attention causal (qwen)": (flash_ops.flash_attention(
            *qwen, causal=True), (4, 4096, hq, d)),
        "flash_attention window 8192 (scout)": (flash_ops.flash_attention(
            *scout, causal=True, sliding_window=8192), (1, 12288, 40, 128)),
    }, {"k_major": 0, "output_major": 0, "single": 2, "expert": 1,
        "flash": 2})


def phase_f32_path(cfg):
    """The f32 path: ``amat_matmul_qt`` with f32 x (one qwen15-moe-a2.7b
    ``wi`` at M=128, 'high') and ``flash_attention`` on f32 q, k, v
    (qwen15-moe-a2.7b's causal attention, 4 x 4096 tokens), driven once
    each with every launch count set to 0 just before and read just
    after.  Returns the counts, keyed as the JSON rows of the f32
    routes."""
    from repro_torch.core.amat import MatConfig, amat_quantize
    from repro_torch.kernels.amat_matmul import ops as amat_ops
    from repro_torch.kernels.flash_attn import ops as flash_ops

    g = torch.Generator(device="cuda")
    g.manual_seed(400)
    K, N = cfg.d_model, 2 * cfg.moe.d_ff
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    qt = amat_quantize(randn(K, N) * K ** -0.5, MatConfig(8, 4))
    x = randn(128, K)
    qkv = [randn(4, 4096, h, d) for h in (hq, hkv, hkv)]
    launches = _drive_entry_points("path f32", lambda: {
        "amat_matmul_qt high f32, M=128": (amat_ops.amat_matmul_qt(
            x, qt, mode="high"), (128, N)),
        "flash_attention causal f32 (qwen)": (flash_ops.flash_attention(
            *qkv, causal=True), (4, 4096, hq, d)),
    }, {"k_major": 0, "output_major": 0, "single": 1, "expert": 0,
        "flash": 1})
    return {"single_f32": launches["single"],
            "flash_f32": launches["flash"]}


def _small_engine(cfg, params, device: str):
    """Phase 4's engine over ``params`` on ``device``: the kernel path on
    the card, the plain dense path on the CPU."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig, SliceMoEEngine
    from repro_torch.models.moe import RoutingPolicy

    return SliceMoEEngine(cfg, params, EngineConfig(
        mat=MatConfig(8, 4), cache_bytes=50e6,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                             quant_execution=device == "cuda"),
        miss_rate_target=0.05, warmup="pcw", max_seq=48), device=device)


def _launched_k1_k2(launches) -> bool:
    return launches["k_major"] > 0 and launches["output_major"] > 0


def phase_small_reference():
    """The kernel path on the card against the plain dense path on the
    CPU, end to end through the engine, on a small input in f32: the
    batched expert kernels' f32 route (three bf16 planes of x), then the
    same with the int8 KV cache.  Every launch count is set to 0 just
    before each card run and read just after; K1 and K2 must have
    launched in each.  Returns the bf16-KV run's counts, keyed as the JSON
    rows of the f32 routes."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(get_config("qwen15-moe-repro"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 24))

    def run(dev):
        eng = _small_engine(cfg, params, dev)
        logits = eng.prefill(prompt)
        toks, metrics = eng.decode(torch.argmax(logits, -1), 6)
        return logits.cpu(), toks.cpu(), metrics["cache_stats"]

    out = {"cpu": run("cpu")}
    out["cuda"], launches = _counted(lambda: run("cuda"))
    lerr = float((out["cpu"][0] - out["cuda"][0]).abs().max())
    same_tokens = bool(torch.equal(out["cpu"][1], out["cuda"][1]))
    same_stats = out["cpu"][2] == out["cuda"][2]
    say(f"[reference] qwen15-moe-repro (2 layers, f32): kernel on the card vs "
        f"plain dense path on the CPU: prefill logits max diff {lerr:.2e}, "
        f"tokens equal {same_tokens}, cache stats equal {same_stats}")
    say(f"[reference] kernel launches: {launches} (want k_major and "
        f"output_major > 0: the f32 route of K1 and K2)")
    if not (lerr <= 1e-4 and same_tokens and same_stats):
        fail("small-input reference check")
    if not _launched_k1_k2(launches):
        fail("reference check: the f32 path did not launch K1 and K2")
    _small_int8_kv(cfg, params, prompt)
    return {"k_major_f32": launches["k_major"],
            "output_major_f32": launches["output_major"]}


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _small_int8_kv(cfg, params, prompt, steps: int = 6):
    """Phase 4's int8-KV run: the same model and prompt with
    ``kv_dtype="int8"``, on the card through the kernel and on the CPU
    through the plain path.  Both prefill (logits at 1e-4, and the two
    caches' codes compared); the card then decodes from the CPU's cache,
    carried across, so both decodes start from the same int8 codes: a
    K/V value within an f32 ulp of a rounding tie may take either code,
    and one code step moves the logits by about 3e-4.  Each decode
    step's logits must agree at 1e-4, the tokens exactly, and the cache
    stats at the end.  The card's prefill and its decode each count their
    own launches, and K1 and K2 must launch in both."""
    import dataclasses

    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    eng = {dev: _small_engine(cfg8, params, dev) for dev in ("cpu", "cuda")}
    first = {"cpu": eng["cpu"].prefill(prompt).cpu()}
    first["cuda"], pre_launches = _counted(
        lambda: eng["cuda"].prefill(prompt).cpu())
    perr = float((first["cpu"] - first["cuda"]).abs().max())
    code_diff = [int((eng["cpu"].kv_cache[key][name]
                      != eng["cuda"].kv_cache[key][name].cpu()).sum())
                 for key in eng["cpu"].kv_cache if key != "pos"
                 for name in ("k", "v")]
    n_codes = sum(eng["cpu"].kv_cache[key][name].numel()
                  for key in eng["cpu"].kv_cache if key != "pos"
                  for name in ("k", "v"))
    eng["cuda"].kv_cache = _to_device(eng["cpu"].kv_cache, "cuda")

    def decode(e, first_logits):
        token = torch.argmax(first_logits, -1).to(e.device)
        logits, tokens = [], [token.cpu()]
        for _ in range(steps):
            lg, e.kv_cache, charge = e.decode_batch(token, e.kv_cache,
                                                    alpha=e.alpha)
            if e.controller is not None:
                e.alpha = e.controller.update(charge.miss_rate)
            token = torch.argmax(lg, -1)
            logits.append(lg.cpu())
            tokens.append(token.cpu())
        return logits, tokens

    logits, tokens = {}, {}
    logits["cpu"], tokens["cpu"] = decode(eng["cpu"], first["cpu"])
    (logits["cuda"], tokens["cuda"]), dec_launches = _counted(
        lambda: decode(eng["cuda"], first["cuda"]))
    errs = [float((a - b).abs().max())
            for a, b in zip(logits["cpu"], logits["cuda"])]
    same_tokens = all(torch.equal(a, b)
                      for a, b in zip(tokens["cpu"], tokens["cuda"]))
    same_stats = eng["cpu"].cache.stats.snapshot() == \
        eng["cuda"].cache.stats.snapshot()
    kv = eng["cuda"].kv_cache["pos0"]
    say(f"[reference] int8 KV (kv_dtype int8, cache leaves "
        f"{ {n: str(t.dtype) for n, t in kv.items()} }): prefill logits max "
        f"diff {perr:.2e}; the two prefill caches differ in "
        f"{sum(code_diff)} of {n_codes} codes; decode from one cache, "
        f"{steps} steps: logits max diff per step "
        f"{[f'{e:.2e}' for e in errs]}, tokens equal {same_tokens}, cache "
        f"stats equal {same_stats}")
    say(f"[reference] int8-KV kernel launches: prefill {pre_launches}, "
        f"decode {dec_launches} (want k_major and output_major > 0 in each)")
    if not (perr <= 1e-4 and max(errs) <= 1e-4 and same_tokens
            and same_stats):
        fail("int8-KV reference check")
    if not (_launched_k1_k2(pre_launches) and _launched_k1_k2(dec_launches)):
        fail("int8-KV reference check: the card's prefill or decode did not "
             "launch K1 and K2")


SERVE_PROMPT, SERVE_NEW, SERVE_REQ = 128, 16, 4


def _serve(cfg, params, ecfg, prompts, tag: str, device: str, *,
           new: int = SERVE_NEW, tenants=None, prepare=None, sched_kw=None):
    """Serve ``prompts`` (``new`` new tokens each, request ``i`` from
    tenant ``tenants[i]`` when given) through the continuous-batching
    scheduler (one slot per prompt, at most ``SERVE_REQ``; ``sched_kw``
    adds ``SchedulerConfig`` fields) with a trace
    recorder attached, the launch counts set to 0 just before the run and
    read just after.  ``prepare(engine, sched)``, when given, runs after
    the recorder is attached and before the counts are reset.  Fails unless every request is served in full, every
    logit is finite and (on the card) K1 and K2 launched once per MoE
    layer per forward.  Returns the run's engine, scheduler, trace and
    figures."""
    from repro_torch.core.engine import PersistentEngine
    from repro_torch.kernels.amat_matmul import ops
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request, SchedulerConfig)
    from repro_torch.sim import TraceRecorder

    class CheckedEngine(PersistentEngine):
        """Records on the card whether every logit it returns is finite,
        and counts the decode steps' slice accesses and misses."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.all_finite = torch.ones((), dtype=torch.bool,
                                         device=self.device)
            self.decode_accesses = self.decode_misses = 0

        def run_prefill(self, tokens, **kw):
            logits, kv, info = super().run_prefill(tokens, **kw)
            self.all_finite &= torch.isfinite(logits).all()
            return logits, kv, info

        def decode_batch(self, token, kv_cache, **kw):
            logits, kv, charge = super().decode_batch(token, kv_cache, **kw)
            self.all_finite &= torch.isfinite(logits).all()
            self.decode_accesses += charge.accesses
            self.decode_misses += charge.misses
            return logits, kv, charge

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    engine = CheckedEngine(cfg, params, ecfg, device=device)
    sync()
    t_quant = time.perf_counter() - t0
    sched = ContinuousBatchingScheduler(
        engine, SchedulerConfig(max_batch=min(len(prompts), SERVE_REQ),
                                **(sched_kw or {})),
        device=device)
    for i, prompt in enumerate(prompts):
        if not sched.submit(Request(
                request_id=i, prompt=prompt, max_new_tokens=new,
                tenant="default" if tenants is None else tenants[i])):
            fail(f"{tag}: request {i} was not admitted")

    class TimedRecorder(TraceRecorder):
        """Adds up its own host time: the run's walls include it."""
        seconds = 0.0

        def on_prefill(self, *a, **kw):
            t0 = time.perf_counter()
            super().on_prefill(*a, **kw)
            self.seconds += time.perf_counter() - t0

        def on_decode(self, tr):
            t0 = time.perf_counter()
            super().on_decode(tr)
            self.seconds += time.perf_counter() - t0

    recorder = sched.attach_recorder(TimedRecorder())
    if prepare is not None:
        prepare(engine, sched)

    sync()
    ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    completions = sched.run()
    sync()
    wall = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES.by_key[k]
                for k in ("k_major", "output_major")}
    n_prefill, n_steps = len(sched.wall_prefill_s), len(sched.wall_step_s)
    want = _n_moe_layers(cfg) * (n_prefill + n_steps)
    say(f"[{tag}] kernel launches: {launches} (want {want} each, "
        f"{2 * want} in all)")
    if len(completions) != len(prompts) or any(
            len(c.tokens) != new for c in completions):
        fail(f"{tag}: not every request was served in full")
    if on_card and (launches["k_major"] != want
                    or launches["output_major"] != want):
        fail(f"{tag}: the main path did not launch the kernel once per MoE "
             "layer projection per forward pass")
    if not bool(engine.all_finite):
        fail(f"{tag}: non-finite logits")
    return {"engine": engine, "sched": sched, "completions": completions,
            "launches": launches, "wall": wall, "t_quant": t_quant,
            "trace": recorder.trace(), "record_s": recorder.seconds}


def _check_replay(run, tag: str, path: str):
    """The recorded trace through a file, replayed by ``repro_torch.sim``:
    it must equal the live run (epoch counts, decode accesses and misses,
    the miss curve and the prefetch summary exactly; every ledger figure
    at rtol 1e-6).  Returns the replay's report."""
    from repro_torch.sim import Trace, replay_trace, traces_equal

    engine, sched = run["engine"], run["sched"]
    t0 = time.perf_counter()
    loaded = Trace.load(run["trace"].save(path))
    if not traces_equal(loaded, run["trace"]):
        fail(f"{tag}: the trace read back from {path} differs")
    rep = replay_trace(loaded)
    wall = time.perf_counter() - t0
    live = engine.ledger.snapshot()
    off = [k for k in live if not _close(rep.ledger[k], live[k], 1e-6)]
    pf_live = (engine.prefetcher.summary()
               if engine.prefetcher is not None else None)
    say(f"[replay] {tag}: {loaded.n_prefills} prefills, "
        f"{loaded.n_decode_steps} decode steps, "
        f"{os.path.getsize(path)} bytes, replayed in {wall:.2f} s (host)")
    say(f"[replay] {tag}: decode accesses/misses replay "
        f"{rep.decode_accesses}/{rep.decode_misses}, live "
        f"{engine.decode_accesses}/{engine.decode_misses}; energy replay "
        f"{rep.total_energy_j!r} J, live {live['total_energy_j']!r} J; "
        f"latency replay {rep.total_latency_s!r} s, live "
        f"{live['total_latency_s']!r} s (cost model)")
    if rep.epoch_counts != engine.cache.epoch_counts():
        fail(f"{tag}: replayed epoch counts differ from the live run")
    if (rep.decode_accesses, rep.decode_misses) != (
            engine.decode_accesses, engine.decode_misses):
        fail(f"{tag}: replayed decode accesses/misses differ")
    if rep.miss_curve != sched.telemetry.miss_rate_curve():
        fail(f"{tag}: replayed miss curve differs from the live run")
    if rep.prefetch != pf_live:
        fail(f"{tag}: replayed prefetch summary {rep.prefetch} differs "
             f"from the live {pf_live}")
    if off:
        fail(f"{tag}: replayed ledger differs from the live one at "
             f"{off}")
    return rep


def _n_moe_layers(cfg) -> int:
    """MoE layers in the stack: the pattern's MoE positions times the
    periods (every layer, for a uniform MoE model)."""
    return cfg.n_periods * sum(b.ffn == "moe" for b in cfg.block_pattern)


def _store_bytes(cfg, mat) -> float:
    """The slice store's size from the shapes: MSB and LSB slices of
    every expert's ``wi`` and ``wo`` in every MoE layer."""
    from repro_torch.core.amat import slice_nbytes

    m = cfg.moe
    per_expert = sum(
        slice_nbytes(shape, mat.high_bits, mat.group_size, which=w,
                     shift=mat.shift)
        for shape in ((cfg.d_model, 2 * m.d_ff), (m.d_ff, cfg.d_model))
        for w in ("msb", "lsb"))
    return per_expert * _n_moe_layers(cfg) * m.n_experts


def phase_serving(cfg, device: str = "cuda"):
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.model import init_params
    from repro_torch.models.moe import RoutingPolicy
    from repro_torch.serving.scheduler import Request
    from repro_torch.sim import replay_trace

    on_card = device == "cuda"
    mat = MatConfig(8, 4)
    m = cfg.moe
    store_bytes = _store_bytes(cfg, mat)

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=device)
    if on_card:
        torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    ecfg = EngineConfig(
        mat=mat, cache_bytes=store_bytes / 4,
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                             quant_execution=True),
        miss_rate_target=0.05, warmup="pcw",
        max_seq=SERVE_PROMPT + SERVE_NEW + 1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQ)]
    run = _serve(cfg, params, ecfg, prompts, "serve", device)
    engine, sched = run["engine"], run["sched"]
    if engine.store.total_bytes() != store_bytes:
        fail("slice store size differs from its analytic size")
    say(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{m.n_experts} experts top-{m.top_k}, {n_params / 1e9:.2f} B params "
        f"in {cfg.dtype}; init {t_init:.1f} s, AMAT quantization "
        f"{run['t_quant']:.1f} s; slice cache {ecfg.cache_bytes / 1e9:.3f} GB "
        f"(a quarter of the {store_bytes / 1e9:.3f} GB store)")

    def new_requests(n_new):
        return [Request(request_id=100 + i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            SERVE_PROMPT).astype(np.int32),
                        max_new_tokens=n_new) for i in range(SERVE_REQ)]

    for c in sorted(run["completions"], key=lambda c: c.request_id):
        dt = c.metrics["decode_totals"]
        cs = c.metrics["cache_stats"]
        acc = cs["msb_hits"] + cs["msb_misses"] + cs["lsb_hits"] \
            + cs["lsb_misses"]
        miss = (cs["msb_misses"] + cs["lsb_misses"]) / max(acc, 1)
        say(f"[serve] request {c.request_id}: tokens {c.tokens.tolist()}")
        say(f"[serve]   decode_totals: energy {dt['total_energy_j']:.6g} J, "
            f"latency {dt['total_latency_s']:.6g} s, flash "
            f"{dt['flash_bytes']:.6g} B, dram {dt['dram_bytes']:.6g} B "
            f"(mobile_soc cost model); cache_stats miss rate {miss:.4f} "
            f"({acc} accesses)")
    say(f"[serve] {len(sched.wall_prefill_s)} prefills, "
        f"{len(sched.wall_step_s)} decode steps, wall {run['wall']:.2f} s; "
        f"wall per prefill (s) "
        f"{[round(s, 4) for s in sched.wall_prefill_s]}; wall per decode "
        f"step: median {np.median(sched.wall_step_s):.4f} s, "
        f"min {min(sched.wall_step_s):.4f} s, max "
        f"{max(sched.wall_step_s):.4f} s")
    say(f"[serve] the walls include the trace recorder's host time: "
        f"{run['record_s']:.6f} s in the run's wall, "
        f"{run['record_s'] / run['wall']:.3%} of it")
    if on_card:
        say(f"[serve] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    summary = sched.summary()
    say(f"[serve] fleet: {summary['n_tokens']} tokens, mean miss rate "
        f"{summary['mean_miss_rate']:.4f}, steady-state miss rate "
        f"{summary['steady_state_miss_rate']:.4f}")

    # The recorded trace: a file, a replay equal to the live run, and the
    # same trace on the async timeline, which must keep the energy and
    # not raise the latency (the reference's timeline invariant).
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    rep = _check_replay(run, "serve",
                        os.path.join(HERE, "build", "serve_trace.npz"))
    asyn = replay_trace(run["trace"], async_io=True)
    de = abs(asyn.total_energy_j - rep.total_energy_j) \
        / rep.total_energy_j
    say(f"[replay] serve on the async timeline: energy "
        f"{asyn.total_energy_j!r} J (rel diff {de:.2e} from the serialized "
        f"replay), latency {asyn.total_latency_s!r} s against "
        f"{rep.total_latency_s!r} s, overlap_saved_s "
        f"{asyn.ledger['overlap_saved_s']!r} (cost model)")
    if de > 1e-6 or asyn.total_latency_s > rep.total_latency_s:
        fail("the async replay changed the energy or raised the latency")
    p5 = {"energy_j": rep.total_energy_j, "latency_s": rep.total_latency_s,
          "cache_bytes": ecfg.cache_bytes}
    return (run["launches"], engine, new_requests,
            float(np.median(sched.wall_step_s)), params, prompts, p5)


def phase_serving_async(cfg, params, prompts, p5, device: str = "cuda"):
    """Phase 5b: phase 5's traffic over phase 5's params again, on the
    async slice-I/O timeline with request-level prefetch (the golden
    ``request_prefetch`` knobs, PCW warmup).  Its recorded trace must
    replay to the live run, prefetch counters included."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.moe import RoutingPolicy

    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mat = MatConfig(8, 4)
    ecfg = EngineConfig(
        mat=mat, cache_bytes=p5["cache_bytes"],
        policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                             quant_execution=True),
        miss_rate_target=0.05, warmup="pcw",
        max_seq=SERVE_PROMPT + SERVE_NEW + 1, async_io=True,
        prefetch_top_m=4, prefetch_kind="request", prefetch_lookahead=2,
        prefetch_min_score=0.02)
    run = _serve(cfg, params, ecfg, prompts, "serve-async", device)
    sched = run["sched"]
    rep = _check_replay(run, "serve-async",
                        os.path.join(HERE, "build", "serve_async_trace.npz"))
    live = run["engine"].ledger.snapshot()
    say(f"[serve-async] prefetch: {rep.prefetch}")
    say(f"[serve-async] energy {live['total_energy_j']!r} J, latency "
        f"{live['total_latency_s']!r} s, overlap_saved_s "
        f"{live['overlap_saved_s']!r}, prefetch fills "
        f"{live['n_prefetch_fills']}, wasted prefetch energy "
        f"{live['prefetch_wasted_energy_j']!r} J; phase 5 (serialized, no "
        f"prefetch): energy {p5['energy_j']!r} J, latency "
        f"{p5['latency_s']!r} s (cost model)")
    say(f"[serve-async] {len(sched.wall_prefill_s)} prefills, "
        f"{len(sched.wall_step_s)} decode steps, wall {run['wall']:.2f} s; "
        f"wall per decode step: median {np.median(sched.wall_step_s):.4f} "
        f"s, min {min(sched.wall_step_s):.4f} s, max "
        f"{max(sched.wall_step_s):.4f} s; recorder host time "
        f"{run['record_s']:.6f} s ({run['record_s'] / run['wall']:.3%} "
        "of the wall)")
    if on_card:
        say(f"[serve-async] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    p = rep.prefetch
    if p["in_flight"] or p["issued"] != p["useful"] + p["late"] + p["wasted"]:
        fail(f"serve-async: prefetch outcomes do not partition: {p}")
    return run["launches"]


EP_SHARDS, EP_PERIOD, EP_REPLICAS = 4, 4, 2
LONG_PROMPT, LONG_NEW = 9216, 4


def _phase7_engine_config(p5, **over):
    """Phase 5's engine settings (MAT84, Cache-Prior + DBSC with quantized
    execution, PCW, a quarter of the store cached) with ``over``."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.moe import RoutingPolicy

    kw = dict(mat=MatConfig(8, 4), cache_bytes=p5["cache_bytes"],
              policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                                   quant_execution=True),
              miss_rate_target=0.05, warmup="pcw",
              max_seq=SERVE_PROMPT + SERVE_NEW + 1)
    kw.update(over)
    return EngineConfig(**kw)


def _say_walls(tag: str, run) -> None:
    sched = run["sched"]
    say(f"[{tag}] {len(sched.wall_prefill_s)} prefills, "
        f"{len(sched.wall_step_s)} decode steps, wall {run['wall']:.2f} s; "
        f"wall per prefill (s) {[round(x, 4) for x in sched.wall_prefill_s]}"
        f"; wall per decode step: median {np.median(sched.wall_step_s):.4f}"
        f" s, min {min(sched.wall_step_s):.4f} s, max "
        f"{max(sched.wall_step_s):.4f} s")


def phase_ep_placement(cfg, params, prompts, p5, device: str = "cuda"):
    """Phase 7a: phase 5's traffic over phase 5's params with expert
    parallelism simulated in the charge path on this one device:
    ``ep_shards=4``, hotness placement re-packed every 4 decode steps
    with the 2 hottest (layer, expert) pairs replicated.  Prints the
    per-shard counts, the all-to-all and migration traffic and the
    placement summary; the recorded trace must replay to the live run
    (epoch counts, per-shard epoch counts, migrations and the placement
    summary exactly, the ledger at rtol 1e-6)."""
    ecfg = _phase7_engine_config(
        p5, ep_shards=EP_SHARDS, placement="hotness",
        placement_period=EP_PERIOD, replicate_k=EP_REPLICAS)
    run = _serve(cfg, params, ecfg, prompts, "ep", device)
    engine = run["engine"]
    for row in engine.shard_breakdown():
        say(f"[ep] shard {row['shard']}: owns {len(row['experts'])} of "
            f"layer 0's {cfg.moe.n_experts} experts; accesses "
            f"{row['accesses']}, misses {row['misses']} (miss rate "
            f"{row['miss_rate']:.4f}); flash {row['flash_bytes']!r} B, "
            f"energy {row['energy_j']!r} J, makespan {row['makespan_s']!r} "
            f"s (cost model)")
    led = engine.ledger.snapshot()
    a2a = led["ici_bytes"] - led["migration_bytes"]
    say(f"[ep] all-to-all bytes {a2a!r}, migrations {led['n_migrations']} "
        f"slices, migration bytes {led['migration_bytes']!r}, interconnect "
        f"energy {led['ici_energy_j']!r} J; total energy "
        f"{led['total_energy_j']!r} J, latency {led['total_latency_s']!r} "
        f"s; phase 5 (one device): {p5['energy_j']!r} J, "
        f"{p5['latency_s']!r} s (cost model)")
    say(f"[ep] placement_summary: {engine.placement_summary()}")
    say(f"[ep] migration events: {engine.migration_events}")
    say(f"[ep] kernel launches {run['launches']}")
    _say_walls("ep", run)
    rep = _check_replay(run, "ep",
                        os.path.join(HERE, "build", "ep_trace.npz"))
    per_shard = engine.cache.per_shard_epoch_counts()
    say(f"[replay] ep: per-shard epoch counts equal "
        f"{rep.per_shard_epoch_counts == per_shard}, migrations equal "
        f"{(rep.migration_events or []) == engine.migration_events}, "
        f"placement summary equal "
        f"{rep.placement == engine.placement_summary()}")
    if rep.per_shard_epoch_counts != per_shard:
        fail("ep: replayed per-shard epoch counts differ")
    if (rep.migration_events or []) != engine.migration_events \
            or rep.placement != engine.placement_summary():
        fail("ep: replayed migrations or placement differ")
    if not engine.migration_events or a2a <= 0:
        fail("ep: no migration or no all-to-all traffic in the run")
    return run["launches"]


def _kv_bytes(cache) -> float:
    return float(sum(t.numel() * t.element_size()
                     for key, entry in cache.items() if key != "pos"
                     for t in entry.values()))


def phase_controller_int8(cfg, params, prompts, p5, device: str = "cuda"):
    """Phase 7b: phase 5's traffic from two tenants in turn, with the int8
    KV cache and the SLO controller (two tenant SLOs, a partitioned cache,
    one device).  ``batch`` carries a miss SLO no run meets, so the
    controller demotes it and then moves cache bytes to it from
    ``premium``.  Prints the controller's actions and summary, each
    tenant's miss rate and low-bit share and the KV cache's bytes (about
    half of bf16's); the recorded trace must replay to the live run
    (epoch counts and the miss curve exactly, the energy curve and the
    ledger at rtol 1e-6, the controller's summary equal)."""
    import dataclasses

    from repro_torch.control import ControllerConfig, TenantSLO

    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    ctl = ControllerConfig(
        slos={"premium": TenantSLO(miss_rate=0.60, lowbit_frac=0.05,
                                   bit_floor="high"),
              "batch": TenantSLO(miss_rate=1e-6, lowbit_frac=1.0)},
        interval=2, window=8, cooldown=4, partition=True)
    ecfg = _phase7_engine_config(p5, controller=ctl)
    tenants = ["premium", "batch"] * (len(prompts) // 2)
    run = _serve(cfg8, params, ecfg, prompts, "ctl-int8", device,
                 tenants=tenants)
    engine, sched = run["engine"], run["sched"]
    kv8 = _kv_bytes(sched.batch_cache)
    kv16 = float(sum(2 * sched.batch_cache[key][name].numel()
                     for key in sched.batch_cache if key != "pos"
                     for name in ("k", "v")))
    say(f"[ctl-int8] KV cache {kv8 / 1e6:.3f} MB (int8 codes + f32 scales, "
        f"{max(len(prompts), 1)} slots x {ecfg.max_seq} positions x "
        f"{cfg.n_layers} layers), bf16 would take {kv16 / 1e6:.3f} MB: "
        f"{kv8 / kv16:.4f} of it, (head_dim + 4) / (2 head_dim)")
    summary = engine.slo_controller.summary()
    say(f"[ctl-int8] controller actions: {engine.slo_controller.actions}")
    say(f"[ctl-int8] controller summary: levels {summary['levels']}, "
        f"budgets {summary['budgets']}, admit_fracs "
        f"{summary['admit_fracs']}, {summary['n_actions']} actions over "
        f"{summary['steps']} steps; cache segments "
        f"{engine.cache.budgets()}")
    totals: dict = {}
    for step in sched.telemetry.steps:
        for t, row in (step.per_tenant or {}).items():
            acc = totals.setdefault(t, dict.fromkeys(row, 0))
            for k, v in row.items():
                acc[k] += v
    for t, row in sorted(totals.items()):
        say(f"[ctl-int8] tenant {t}: {row['tokens']} decode tokens, miss "
            f"rate {row['misses'] / max(row['accesses'], 1):.4f} "
            f"({row['misses']} of {row['accesses']}), low-bit share of "
            f"critical selections "
            f"{row['critical_low'] / max(row['critical'], 1):.4f} "
            f"({row['critical_low']} of {row['critical']})")
    say(f"[ctl-int8] kernel launches {run['launches']}")
    _say_walls("ctl-int8", run)
    rep = _check_replay(run, "ctl-int8",
                        os.path.join(HERE, "build", "ctl_int8_trace.npz"))
    live_e = sched.telemetry.energy_curve()
    e_off = [i for i, (a, b) in enumerate(zip(rep.energy_curve, live_e))
             if not _close(a, b, 1e-6)]
    say(f"[replay] ctl-int8: energy curve equal at rtol 1e-6 "
        f"{not e_off and len(rep.energy_curve) == len(live_e)}, controller "
        f"summary equal {rep.controller_summary == summary}")
    if e_off or len(rep.energy_curve) != len(live_e):
        fail(f"ctl-int8: replayed energy curve differs at steps {e_off}")
    if rep.controller_summary != summary:
        fail("ctl-int8: replayed controller summary differs")
    hd = cfg.head_dim
    if kv8 * 2 * hd != kv16 * (hd + 4):
        fail("ctl-int8: the int8 KV cache is not (head_dim + 4) / "
             "(2 head_dim) of bf16's")
    if not summary["n_actions"]:
        fail("ctl-int8: the controller never acted")
    return run["launches"]


def phase_long_prefill(cfg, params, p5, device: str = "cuda",
                       n_prompt: int = LONG_PROMPT):
    """Phase 7c: one request of ``n_prompt`` tokens (above the 8192-key
    threshold, so every layer's prefill attention runs blockwise) with
    the int8 KV cache through the engine, then ``LONG_NEW`` decode steps.
    First layer 0's q/k/v of that prompt (from the float params, in f32)
    go through ``blockwise_attention`` and the dense body of
    ``attention`` on the device: they must agree at 1e-4 + 1e-4*|dense|.
    Prints both times, the prefill's wall and the peak memory."""
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.models import model as MDL

    on_card = device == "cuda"
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, n_prompt).astype(np.int32)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        p0 = MDL._index(params["blocks"], 0)["pos0"]
        x = params["embed"][torch.as_tensor(prompt, device=device)[None]]
        h = L.rms_norm(x.to(MDL._dt(cfg)), p0["norm"], cfg.norm_eps)
        q, k, v = MDL._attn_qkv(p0, h, cfg)
        pos = torch.arange(n_prompt, device=device)[None]
        q, k, v = (L.apply_rope(q, pos, cfg.rope_theta).float(),
                   L.apply_rope(k, pos, cfg.rope_theta).float(), v.float())
        sync()
        t0 = time.perf_counter()
        blk = L.blockwise_attention(q, k, v, causal=True)
        sync()
        t_blk = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense = L.dense_attention(q, k, v, causal=True)
        sync()
        t_dense = time.perf_counter() - t0
        err = (blk - dense).abs()
        bad = int((err > TOL_ABS + TOL_REL * dense.abs()).sum())
        max_err = float(err.max())
    peak_check = torch.cuda.max_memory_allocated() if on_card else 0
    say(f"[long] layer 0 of a {n_prompt}-token prompt ({cfg.n_heads} heads "
        f"of {cfg.head_dim}, f32 q/k/v): blockwise_attention (blocks of "
        f"{L.BLOCK_KV} keys) {t_blk * 1e3:.1f} ms, dense body "
        f"{t_dense * 1e3:.1f} ms (first calls, host clock); max abs diff "
        f"{max_err:.2e}, {bad} entries over 1e-4 + 1e-4*|dense|; peak "
        f"memory of the check {peak_check / 1e9:.2f} GB")
    if bad or not bool(torch.isfinite(blk).all()):
        fail("long: blockwise attention disagrees with the dense body")
    del q, k, v, blk, dense, err, x, h
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ecfg = _phase7_engine_config(p5, max_seq=n_prompt + LONG_NEW + 12)
    run = _serve(cfg8, params, ecfg, [prompt], "long", device, new=LONG_NEW)
    sched = run["sched"]
    kv = _kv_bytes(sched.batch_cache)
    say(f"[long] prefill of {n_prompt} tokens through the engine: wall "
        f"{sched.wall_prefill_s[0]:.4f} s; {len(sched.wall_step_s)} decode "
        f"steps, wall per step {[round(x, 4) for x in sched.wall_step_s]} "
        f"s; int8 KV cache {kv / 1e9:.3f} GB for {ecfg.max_seq} positions; "
        f"kernel launches {run['launches']}")
    if on_card:
        say(f"[long] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return run["launches"]


CH_ATTR = {"flash": "flash_ch", "flash_bg": "flash_bg_ch",
           "dram": "dram_ch", "compute": "compute_ch", "ici": "ici_ch"}


def _timed_tracer():
    """A ``TimelineTracer`` that adds up its own host time in
    ``seconds`` (emit, span, set_attr, begin_step, begin_prefill): the
    walls of the run it traces include it."""
    from repro_torch.obs import TimelineTracer

    class TimedTracer(TimelineTracer):
        seconds = 0.0

        def emit(self, *a, **kw):
            t0 = time.perf_counter()
            super().emit(*a, **kw)
            self.seconds += time.perf_counter() - t0

        def span(self, *a, **kw):
            t0 = time.perf_counter()
            super().span(*a, **kw)
            self.seconds += time.perf_counter() - t0

        def set_attr(self, *a, **kw):
            t0 = time.perf_counter()
            super().set_attr(*a, **kw)
            self.seconds += time.perf_counter() - t0

        def begin_step(self):
            t0 = time.perf_counter()
            step = super().begin_step()
            self.seconds += time.perf_counter() - t0
            return step

        def begin_prefill(self):
            t0 = time.perf_counter()
            super().begin_prefill()
            self.seconds += time.perf_counter() - t0

    return TimedTracer()


def phase_traced_serving(cfg, params, prompts, p5, device: str = "cuda"):
    """Phase 9: phase 5's traffic over phase 5's params with one engine
    that puts every event kind on the timeline (phase 5's settings plus
    5b's ``async_io`` and request prefetch and 7a's ``ep_shards=4``,
    hotness placement every 4 steps and 2 replicas), a timeline tracer
    attached to the engine and a metrics registry to the scheduler, the
    trace recorded as phase 5 records it.  Checks, each failing the run:
    K1/K2 once per MoE layer per forward (``_serve``); every kind's event
    count and bytes against the ledger; every ``(shard, channel)``
    makespan against that channel's ``busy_until`` and the makespan
    against ``total_latency_s`` (rtol 1e-6); the recorded trace replayed
    through a file with a tracer gives the live event stream and the
    same Chrome export outside the requests process; a replay without a
    tracer gives the traced replay's ledger exactly; the exported file's
    ``trace_report`` totals equal the tracer's; the metrics JSONL has one
    row per decode step, non-decreasing counters and, in its last row,
    the ledger's traffic at rtol 1e-6.  Prints the events by kind, the
    spans, the Chrome file's size, the report's stall and overlap figures
    (cost model), the tracer's host seconds and the wall per step
    (``[trace]`` lines)."""
    from repro_torch.obs import (MetricsRegistry, TimelineTracer,
                                 chrome_trace, events_equal,
                                 export_chrome_trace, first_divergence,
                                 load_trace, trace_report)
    from repro_torch.obs.timeline import EVENT_KINDS, REQUESTS_PID
    from repro_torch.sim import ReplayEngine, Trace

    on_card = device == "cuda"
    if on_card:
        say(f"[trace] card: {smi_name_power()}")
        torch.cuda.reset_peak_memory_stats()

    tracer, registry = _timed_tracer(), MetricsRegistry()

    def prepare(engine, sched):
        engine.attach_tracer(tracer)
        sched.attach_metrics(registry)

    ecfg = _phase7_engine_config(
        p5, async_io=True, prefetch_top_m=4, prefetch_kind="request",
        prefetch_lookahead=2, prefetch_min_score=0.02, ep_shards=EP_SHARDS,
        placement="hotness", placement_period=EP_PERIOD,
        replicate_k=EP_REPLICAS)
    run = _serve(cfg, params, ecfg, prompts, "trace", device,
                 prepare=prepare)
    engine, sched = run["engine"], run["sched"]
    snap = engine.ledger.snapshot()
    events = tracer.events

    # Event conservation: one event per ledger charge, by kind.
    kinds = {k: sum(1 for e in events if e.kind == k) for k in EVENT_KINDS}
    spans = {}
    for sp in tracer.spans:
        spans[sp["name"]] = spans.get(sp["name"], 0) + 1
    say(f"[trace] events by kind {kinds}, {len(events)} in all; "
        f"{len(tracer.spans)} spans {spans}")
    if not all(kinds.values()):
        fail(f"trace: an event kind is missing from the timeline: {kinds}")

    def nbytes(*ks):
        return sum(e.nbytes for e in events if e.kind in ks)

    counts = {
        "n_flash_transfers": kinds["fill"] + kinds["prefetch_fill"],
        "n_dram_transfers": kinds["dram_read"],
        "n_matmuls": kinds["matmul"],
        "n_ici_transfers": kinds["a2a"] + kinds["migrate"],
        "n_migrations": kinds["migrate"],
        "n_prefetch_fills": kinds["prefetch_fill"]}
    sums = {
        "flash_bytes": nbytes("fill", "prefetch_fill"),
        "prefetch_flash_bytes": nbytes("prefetch_fill"),
        "dram_bytes": nbytes("dram_read"),
        "ici_bytes": nbytes("a2a", "migrate"),
        "migration_bytes": nbytes("migrate"),
        "compute_ops": sum(e.ops for e in events if e.kind == "matmul")}
    off = [k for k, v in counts.items() if v != snap[k]] + [
        k for k, v in sums.items() if not _close(v, snap[k], 1e-9)]
    if off:
        fail(f"trace: events do not conserve the ledger's {off}")

    # Makespans: each channel's last event ends at its busy_until clock.
    led = engine.ledger
    ledgers = dict(enumerate(led.shards))
    ledgers[-1] = led.ici
    bad = [(sh, ch) for (sh, ch), end in tracer.channel_makespans().items()
           if not _close(end, getattr(ledgers[sh], CH_ATTR[ch]).busy_until,
                         1e-6)]
    say(f"[trace] makespan {tracer.makespan()!r} s, ledger "
        f"total_latency_s {snap['total_latency_s']!r} s; "
        f"{len(tracer.channel_makespans())} (shard, channel) tracks, "
        f"{len(bad)} off their busy_until (cost model)")
    if bad or not _close(tracer.makespan(), snap["total_latency_s"], 1e-6):
        fail(f"trace: makespans differ from the ledger's clocks at {bad}")

    # The recorded trace through a file: replayed untraced it must equal
    # the live run (_check_replay), replayed traced the live event stream,
    # and the two replays' ledgers must be equal exactly.
    path = os.path.join(HERE, "build", "trace_trace.npz")
    bare = _check_replay(run, "trace", path)
    loaded = Trace.load(path)
    t0 = time.perf_counter()
    rep_eng = ReplayEngine(loaded.meta)
    rep_trc = rep_eng.attach_tracer(TimelineTracer())
    rep_eng.consume_all(loaded.events)
    traced = rep_eng.finish()
    t_rep = time.perf_counter() - t0
    div = first_divergence(events, rep_trc.events)
    live_hw = [e for e in chrome_trace(tracer)["traceEvents"]
               if e.get("pid") != REQUESTS_PID]
    rep_hw = [e for e in chrome_trace(rep_trc)["traceEvents"]
              if e.get("pid") != REQUESTS_PID]
    say(f"[trace] traced replay in {t_rep:.2f} s (host): "
        f"{len(rep_trc.events)} events, first divergence from the live "
        f"stream {div}, hardware export equal {live_hw == rep_hw}, ledger "
        f"equal to the untraced replay's {traced.ledger == bare.ledger}")
    if div is not None or not events_equal(events, rep_trc.events):
        fail(f"trace: the replayed event stream diverges at event {div}")
    if live_hw != rep_hw:
        fail("trace: the replay's Chrome export differs from the live one")
    if traced.ledger != bare.ledger:
        fail("trace: attaching a tracer changed the replay's ledger")

    # The exported file, read back, reports the tracer's own totals.
    chrome_path = os.path.join(HERE, "build", "trace_chrome.json")
    t0 = time.perf_counter()
    export_chrome_trace(tracer, chrome_path)
    t_export = time.perf_counter() - t0
    report = trace_report(load_trace(chrome_path))
    per_track = {}
    for e in events:
        proc = "interconnect" if e.shard < 0 else f"shard {e.shard}"
        per_track[(proc, e.channel)] = per_track.get((proc, e.channel),
                                                     0) + 1
    got_tracks = {(r["process"], r["channel"]): r["events"]
                  for r in report["channels"]}
    totals = {
        "makespan_us": (report["makespan_us"], tracer.makespan() * 1e6),
        "bytes": (sum(r["bytes"] for r in report["channels"]),
                  sum(e.nbytes for e in events)),
        "ops": (sum(r["ops"] for r in report["channels"]),
                sum(e.ops for e in events))}
    off = [k for k, (a, b) in totals.items() if not _close(a, b, 1e-9)]
    say(f"[trace] Chrome export {os.path.getsize(chrome_path)} bytes, "
        f"written in {t_export:.2f} s (host); report: makespan "
        f"{report['makespan_us']!r} us, {len(report['channels'])} channel "
        f"tracks (cost model)")
    if got_tracks != per_track or off:
        fail(f"trace: the report of the exported file differs from the "
             f"tracer's totals ({off or 'events per track'})")
    for row in report["processes"]:
        stall = sum(r["stall_us"] for r in report["channels"]
                    if r["process"] == row["process"])
        say(f"[trace] {row['process']}: serial {row['serial_us']!r} us, "
            f"makespan {row['makespan_us']!r} us, overlap saved "
            f"{row['overlap_saved_us']!r} us, stall {stall!r} us summed "
            f"over its channels, speculative {row['speculative_bytes']!r} "
            f"B in {row['speculative_events']} fills (cost model)")
    for ch in ("flash", "flash_bg", "dram", "compute", "ici"):
        rows = [r for r in report["channels"] if r["channel"] == ch]
        if rows:
            say(f"[trace] {ch}: busy {sum(r['busy_us'] for r in rows)!r} "
                f"us, stall {sum(r['stall_us'] for r in rows)!r} us, "
                f"utilization against the makespan "
                f"{[round(r['util_vs_makespan'], 4) for r in rows]} "
                "(cost model)")

    # The metrics series: one row per decode step, counters that never go
    # back, and the ledger's traffic in the last row.
    metrics_path = os.path.join(HERE, "build", "trace_metrics.jsonl")
    n_rows = registry.to_jsonl(metrics_path)
    with open(metrics_path) as fh:
        rows = [json.loads(line) for line in fh]
    counters = sorted(k for k in rows[-1] if k.endswith("_total"))
    back = [k for k in counters if any(
        b.get(k, 0.0) < a.get(k, 0.0) for a, b in zip(rows, rows[1:]))]
    ledger_keys = ("flash_bytes", "dram_bytes", "ici_bytes",
                   "migration_bytes", "prefetch_flash_bytes")
    off = [k for k in ledger_keys
           if not _close(rows[-1][f"{k}_total"], snap[k], 1e-6)]
    say(f"[trace] metrics: {n_rows} rows for {len(sched.wall_step_s)} "
        f"decode steps, {len(rows[-1])} keys ({len(counters)} counters), "
        f"{os.path.getsize(metrics_path)} bytes of JSONL, "
        f"{len(registry.prometheus_text().splitlines())} lines of "
        f"Prometheus text; last row: tokens {rows[-1]['tokens_total']}, "
        f"prefetch useful/issued {rows[-1]['prefetch_useful_total']}/"
        f"{rows[-1]['prefetch_issued_total']}, shard imbalance "
        f"{rows[-1].get('shard_imbalance')!r}")
    if n_rows != len(sched.wall_step_s) or len(rows) != n_rows:
        fail("trace: the metrics series is not one row per decode step")
    if back:
        fail(f"trace: metrics counters went back: {back}")
    if off:
        fail(f"trace: the metrics' ledger counters differ from the ledger "
             f"at {off}")

    say(f"[trace] the walls include the tracer's host time (emit, span, "
        f"set_attr, begin_step, begin_prefill): {tracer.seconds:.6f} s, "
        f"{tracer.seconds / run['wall']:.3%} of the run's wall "
        f"{run['wall']:.2f} s; the recorder's {run['record_s']:.6f} s")
    _say_walls("trace", run)
    if on_card:
        say(f"[trace] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return run["launches"]


# Phase 10's request counts, cut so that the phase fits P10_BUDGET_S
# (a forward at full width takes 0.09-0.12 s, an engine build 0.4 s):
# per serving_load cell and sim_fidelity's live run (the reference: 12
# and 8), sim_fidelity's cumsum and ep2 runs (3), the request
# predictor's pair and placement's three policies (24: at 2 the
# predictor issued no fill), the placement live-vs-replay run (8).
P10_CELL, P10_SMALL, P10_PAIR, P10_PLACE_FID = 2, 1, 4, 2
P10_BUDGET_S = 90.0


@contextlib.contextmanager
def _persistent_engines(*modules):
    """Within the block, each of ``modules``' ``PersistentEngine`` is a
    subclass that first collects unreachable engines (their blocks go
    back to the allocator's cache, where the next engine's same-sized
    tensors find them), then records its build seconds, counts its
    forwards (prefills and decode steps) and records on the card whether
    every logit was finite; yields one record per engine built (the
    records hold no engine, so the engines are freed as they go)."""
    from repro_torch.core.engine import PersistentEngine

    records = []

    class CountedEngine(PersistentEngine):
        def __init__(self, *a, **kw):
            t0 = time.perf_counter()
            gc.collect()
            super().__init__(*a, **kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.record = {"forwards": 0, "decode_steps": 0,
                           "build_s": time.perf_counter() - t0,
                           "serve_s": 0.0,
                           "finite": torch.ones((), dtype=torch.bool,
                                                device=self.device)}
            records.append(self.record)

        # Each forward's charge path reads its routing back to the host,
        # so the host clock around the call covers the device's work.
        def run_prefill(self, tokens, **kw):
            t0 = time.perf_counter()
            logits, kv, info = super().run_prefill(tokens, **kw)
            self.record["serve_s"] += time.perf_counter() - t0
            self.record["forwards"] += 1
            self.record["finite"] &= torch.isfinite(logits).all()
            return logits, kv, info

        def decode_batch(self, token, kv_cache, **kw):
            t0 = time.perf_counter()
            logits, kv, charge = super().decode_batch(token, kv_cache, **kw)
            self.record["serve_s"] += time.perf_counter() - t0
            self.record["forwards"] += 1
            self.record["decode_steps"] += 1
            self.record["finite"] &= torch.isfinite(logits).all()
            return logits, kv, charge

    saved = [(m, m.PersistentEngine) for m in modules]
    for m, _ in saved:
        m.PersistentEngine = CountedEngine
    try:
        yield records
    finally:
        for m, cls in saved:
            m.PersistentEngine = cls


def _hard(tag: str, fn):
    """``fn()``, a benchmark's check that holds by construction at any
    width; its ``AssertionError`` fails the run."""
    try:
        return fn()
    except AssertionError as e:
        fail(f"{tag}: {e!r}"[:2000])


def _claim(what: str, held: bool, numbers: str) -> None:
    say(f"[phase10] claim: {what}: {'held' if held else 'not held'} "
        f"({numbers}) (calibrated on the 2-layer model; printed, not "
        "asserted)")


def phase_serving_benchmarks(cfg, params, device: str = "cuda"):
    """Phase 10: the three serving benchmarks at full width, over phase
    5's params, through ``benchmarks/torch_{controller_soak,sim_fidelity,
    serving_load}``'s own functions, every engine with quantized
    execution but the dense-dequant row, one engine at a time.  Each
    cache is the reference's cache as a share of the 2-layer
    ``qwen15-moe-repro`` store, applied to the full store; the traffic is
    the reference's (24-token prompts, 12 new tokens, 24 for the request
    predictor) over the full vocabulary, with the request counts cut
    (``[phase10] reduced`` lines).  Hard checks, each failing the run:
    K1 and K2 once per MoE layer per forward (neither in the dense row);
    sim_fidelity's (a), cumsum, ep2 and ep=1 replays and its file round
    trip; the controller's live-vs-replay fidelity (b), determinism (c),
    the soak grid equal to the reference's ``BENCH_controller_soak.json``
    and gate (a); async energy equal to serialized; all-to-all bytes 0 at
    ep 1 and above 0 beyond; the traced twin's energy exact and makespan
    equal to the ledger's latency; placement's live-vs-replay equalities;
    every logit finite.  The claims calibrated on the 2-layer model are
    printed as held or not held.  Also printed: the host wall per forward
    of the traced twin and of its untraced twin (the ep section's ep=1
    run, which follows it), the tracer's share of its twin's wall, the
    peak device memory and the phase's seconds.  Returns the seconds."""
    sys.path.insert(0, HERE)
    from benchmarks import torch_controller_soak as CS
    from benchmarks import torch_serving_load as SL
    from benchmarks import torch_sim_fidelity as SF
    from benchmarks.torch_common import reference_record
    from repro_torch.configs.base import get_config
    from repro_torch.core.amat import MAT84
    from repro_torch.models.moe import RoutingPolicy
    from repro_torch.sim import replay_trace

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    if on_card:
        say(f"[phase10] card: {smi_name_power()}")
        torch.cuda.reset_peak_memory_stats()
    store = _store_bytes(cfg, MAT84)
    repro_store = _store_bytes(
        dataclasses.replace(get_config(SL.ARCH), n_layers=2), MAT84)
    scale = store / repro_store

    def cache(ref_bytes):
        return ref_bytes * scale

    say(f"[phase10] {cfg.name}, {cfg.n_layers} layers, vocab "
        f"{cfg.vocab_size}: each cache is the reference's share of the "
        f"2-layer {SL.ARCH} store ({repro_store / 1e6:.3f} MB) applied to "
        f"the {store / 1e9:.3f} GB store (x{scale:.1f}): 2.5e6 B -> "
        f"{cache(2.5e6) / 1e9:.3f} GB, 1e6 B -> {cache(1e6) / 1e9:.3f} GB, "
        f"0.8e6 B -> {cache(0.8e6) / 1e9:.3f} GB; autotune's 2, 4 and 6.5 "
        f"MB -> {cache(2e6) / 1e9:.3f}, {cache(4e6) / 1e9:.3f} and "
        f"{cache(6.5e6) / 1e9:.3f} GB")
    say(f"[phase10] reduced: requests per serving_load cell {P10_CELL} "
        f"(reference 12, --quick 6); sim_fidelity's live run {P10_CELL} "
        f"(8, 4) and its cumsum and ep2 runs {P10_SMALL} (3, 2); the "
        f"controller's live run 4 (its --quick size); the request "
        f"predictor's pair {P10_PAIR} (24) and placement's policies "
        f"{P10_PAIR} (24); the placement live-vs-replay run "
        f"{P10_PLACE_FID} (8)")
    say("[phase10] reduced: the sweep at rate 2 and batches 1 and 4, ep "
        "in {1, 2, 4} (the reference's --quick sweep; its full ep list)")

    def section(tag, run, *, quant=True):
        """``run()`` with the launch counts reset and read, each engine
        counted; checks K1/K2 and finiteness.  Returns run's result and
        its engines' records."""
        with _persistent_engines(CS, SF, SL) as records:
            t0 = time.perf_counter()
            out, launches = _counted(run)
            wall = time.perf_counter() - t0
        forwards = sum(r["forwards"] for r in records)
        steps = sum(r["decode_steps"] for r in records)
        build = sum(r["build_s"] for r in records)
        say(f"[phase10] {tag}: {len(records)} engines built in {build:.2f} "
            f"s, {forwards} forwards ({steps} decode steps), wall "
            f"{wall:.2f} s")
        _check_paper_launches(f"phase10 {tag}", launches,
                              cfg.n_layers * forwards if quant else 0,
                              device)
        if not all(bool(r["finite"]) for r in records):
            fail(f"phase10 {tag}: non-finite logits")
        return out, records, wall

    kw = dict(device=device, quant_execution=True)

    # ---- controller soak: the model-free grid, then the live run.
    t0 = time.perf_counter()
    trace, results, ctl_rep = _hard("soak (c)", lambda: CS.soak(False))
    best = CS.best_static(results)
    ctl = results["controller"]
    say(f"[phase10] soak: {trace.n_prefills} requests, "
        f"{trace.n_decode_steps} decode steps, replayed under 4 configs in "
        f"{time.perf_counter() - t0:.2f} s (host); controller attainment "
        f"{ctl['attainment']!r}, best static {best} "
        f"{results[best]['attainment']!r}; energy {ctl['energy_j']!r} J "
        f"against {results[best]['energy_j']!r} J (cost model)")
    if not (all(ctl["attainment"] > results[n]["attainment"]
                for n in CS.STATICS)
            and ctl["energy_j"] <= results[best]["energy_j"]):
        fail("phase10: soak gate (a) does not hold")
    if reference_record("controller_soak") is None:
        fail("phase10: results/BENCH_controller_soak.json is missing")
    _hard("soak grid", lambda: CS._check_against_baseline(
        {"n_decode_steps": trace.n_decode_steps, "configs": results},
        quick=False))
    fid, _, _ = section("controller live", lambda: _hard(
        "controller (b)", lambda: CS._live_fidelity(
            True, cfg=cfg, params=params, cache_bytes=cache(1e6), **kw)))
    say(f"[phase10] controller live run: {fid['n_steps']} steps, "
        f"{fid['n_actions']} actions, levels {fid['levels']}")

    # ---- sim fidelity.
    (tr, live), _, _ = section("sim_fidelity live", lambda: SF._record_live(
        cfg, params, P10_CELL, cache_bytes=cache(1e6), **kw))
    t_npz, _ = _hard("sim round trip", lambda: SF.round_trip(
        tr, os.path.join(HERE, "build", "phase10")))
    rep = replay_trace(t_npz)
    _hard("sim_fidelity (a)", lambda: SF.check_fidelity(rep, live))
    replay_sps = max([rep.steps_per_s]
                     + [replay_trace(t_npz).steps_per_s for _ in range(2)])
    ratio = replay_sps / live["steps_per_s"]
    _claim("replay >= 100x live decode steps/s", ratio >= 100.0,
           f"replay {replay_sps!r} steps/s, live {live['steps_per_s']!r} "
           f"steps/s on the card, {ratio!r}x")
    (ctr, clive), _, _ = section("sim_fidelity cumsum", lambda: (
        SF._record_live(cfg, params, P10_SMALL, cache_bytes=cache(1e6),
                        policy=RoutingPolicy(kind="cumsum",
                                             slice_mode="dbsc",
                                             cumsum_tau=0.05,
                                             cumsum_kmax=8), **kw)))
    pf, _ = _hard("sim_fidelity cumsum", lambda: SF.check_cumsum(ctr, clive))
    (etr, elive), _, _ = section("sim_fidelity ep2", lambda: (
        SF._record_live(cfg, params, P10_SMALL, cache_bytes=cache(1e6),
                        ep_shards=2,
                        async_io=True, **kw)))
    _hard("sim_fidelity ep2", lambda: SF.check_ep2(etr, elive))
    _hard("sim_fidelity ep=1", lambda: SF.check_forced_ep1(t_npz, live))
    say(f"[phase10] sim_fidelity: replay == live over {tr.n_prefills} "
        f"prefills and {tr.n_decode_steps} decode steps; cumsum prefill "
        f"active frac {float(np.asarray(pf.active).mean())!r}; ep2 a2a "
        f"{elive['ledger']['ici_bytes']!r} B; ep=1 forced sharded exact")
    t0 = time.perf_counter()
    rows, default, frontier, winner, _ = SF.autotune(
        t_npz, SF.autotune_policies(scale))
    say(f"[phase10] autotune: {len(rows)} configs replayed in "
        f"{time.perf_counter() - t0:.2f} s (host), frontier "
        f"{[r.name for r in frontier]}")
    _claim("autotune finds a config under the 5% miss SLO below 0.999 of "
           "the default's energy",
           winner is not None and winner.energy_j < 0.999 * default.energy_j,
           f"winner {None if winner is None else winner.name}, miss "
           f"{None if winner is None else winner.miss_rate!r}, energy "
           f"{None if winner is None else winner.energy_j!r} J against "
           f"{default.energy_j!r} J")

    # ---- serving load.
    sl = dict(kw, cache_bytes=cache(SL.CACHE_BYTES))
    by_batch, _, _ = section("load sweep", lambda: SL.load_sweep(
        cfg, params, n_requests=P10_CELL, rates=[2.0], batches=[1, 4], **sl))
    tp = {mb: by_batch["saturated"][mb]["throughput_tok_per_s"]
          for mb in (1, 4)}
    _claim("batching pays", tp[4] > tp[1], f"saturated {tp!r} tok/s")
    (cold, warm_s, warm_miss), _, _ = section(
        "warm vs cold", lambda: SL.warm_vs_cold(
            cfg, params, n_requests=P10_CELL, **sl))
    _claim("warm below cold",
           warm_miss < cold["steady_state_miss_rate"]
           and warm_s["energy_per_token_j"] < cold["energy_per_token_j"],
           f"miss {warm_miss!r} against {cold['steady_state_miss_rate']!r}, "
           f"energy/token {warm_s['energy_per_token_j']!r} against "
           f"{cold['energy_per_token_j']!r} J")
    tl, tl_records, _ = section("timeline", lambda: SL.timeline(
        cfg, params, max_batch=4, n_requests=P10_CELL, **sl))
    _hard("async energy", lambda: SL.check_async_energy(tl))
    t_sync, t_async = tl["serialized"], tl["async"]
    _claim("async faster",
           t_async["throughput_tok_per_s"] > t_sync["throughput_tok_per_s"]
           and t_async["per_token_p50_s"] < t_sync["per_token_p50_s"],
           f"p50 {t_async['per_token_p50_s']!r} against "
           f"{t_sync['per_token_p50_s']!r} s")
    mk = tl["async+prefetch(markov)"]["prefetch"]
    _claim("markov mostly wasted", mk["wasted"] > mk["useful"],
           f"wasted {mk['wasted']}, useful {mk['useful']} of {mk['issued']}")

    # The traced twin, then the ep section, whose ep=1 run (the async
    # cell again, untraced) is its untraced twin, one after the other.
    tracer = _timed_tracer()
    (obs_row, p50_rel, _), (tr,), _ = section(
        "traced twin", lambda: _hard("traced twin", lambda: (
            SL.observability(cfg, params, t_async, max_batch=4,
                             n_requests=P10_CELL, tracer=tracer, **sl))))
    ep_rows, ep_records, _ = section("ep scaling", lambda: SL.ep_scaling(
        cfg, params, max_batch=4, n_requests=P10_CELL, ep_values=[1, 2, 4],
        **sl))
    un = ep_records[0]
    say(f"[phase10] traced twin: {obs_row['n_trace_events']} events, "
        f"{obs_row['n_spans']} spans, p50 rel diff {p50_rel!r}, energy "
        f"identical, makespan == ledger latency; host wall per forward "
        f"traced {tr['serve_s'] / tr['forwards']:.4f} s, untraced (ep=1) "
        f"{un['serve_s'] / un['forwards']:.4f} s ({tr['forwards']} and "
        f"{un['forwards']} forwards), ratio "
        f"{tr['serve_s'] / un['serve_s']:.4f}; the tracer's own host time "
        f"{tracer.seconds:.6f} s, {tracer.seconds / tr['serve_s']:.3%} of "
        f"the traced twin's {tr['serve_s']:.2f} s in its forwards")
    _hard("ici", lambda: SL.check_ici(ep_rows))
    p50 = {ep: r["per_token_p50_s"] for ep, r in ep_rows.items()}
    _claim("p50 falls with ep", p50[2] < p50[1] and p50[4] < p50[1],
           f"p50 {p50!r} s, a2a {[ep_rows[e]['ici_bytes'] for e in (2, 4)]}"
           " B")
    _claim("ep=4 p50 at or below 280 us", p50[4] <= 280e-6, f"{p50[4]!r} s")

    pf_rows, _, _ = section("request predictor", lambda: SL.request_prefetch(
        cfg, params, n_requests=P10_PAIR, **sl))
    pa, pr = pf_rows["plain-async"], pf_rows["async+prefetch(request)"]
    rpf = pr["prefetch"]
    _claim("request predictor: useful > wasted, lower p50, energy/token "
           "not above plain async",
           rpf["useful"] > rpf["wasted"]
           and pr["per_token_p50_s"] < pa["per_token_p50_s"]
           and pr["energy_per_token_j"] <= pa["energy_per_token_j"],
           f"useful/late/wasted {rpf['useful']}/{rpf['late']}/"
           f"{rpf['wasted']} of {rpf['issued']}, p50 "
           f"{pr['per_token_p50_s']!r} against {pa['per_token_p50_s']!r} s, "
           f"energy/token {pr['energy_per_token_j']!r} against "
           f"{pa['energy_per_token_j']!r} J")

    pl, _, _ = section("placement", lambda: SL.placement(
        cfg, params, max_batch=4, n_requests=P10_PAIR,
        cache_bytes=cache(SL.PLACE_CACHE), **kw))
    rr, hot, repl = (pl["round_robin"], pl["hotness"],
                     pl["hotness+replicate:2"])
    _claim("hotness narrows the shard miss spread at no p50 cost",
           hot["shard_miss_spread"] < rr["shard_miss_spread"]
           and hot["per_token_p50_s"] <= rr["per_token_p50_s"],
           f"spread {hot['shard_miss_spread']!r} against "
           f"{rr['shard_miss_spread']!r}, p50 {hot['per_token_p50_s']!r} "
           f"against {rr['per_token_p50_s']!r} s")
    _claim("replication cuts a2a within 3% of p50",
           repl["a2a_bytes"] < rr["a2a_bytes"]
           and repl["per_token_p50_s"] <= 1.03 * rr["per_token_p50_s"],
           f"a2a {repl['a2a_bytes']!r} against {rr['a2a_bytes']!r} B, p50 "
           f"{repl['per_token_p50_s']!r} against {rr['per_token_p50_s']!r} s")
    n_mig, _, _ = section("placement live vs replay", lambda: _hard(
        "placement fidelity", lambda: SL.placement_fidelity(
            cfg, params, n_requests=P10_PLACE_FID,
            cache_bytes=cache(SL.PLACE_CACHE), **kw)))
    say(f"[phase10] placement live == replay: per-shard epoch counts, "
        f"shard counters and {n_mig} migrations exact")

    def ffn_row(label, run):
        out, _, _ = section(f"expert_ffn {label}", run,
                            quant=label == "quant_execution")
        return out

    qe_rows, reduction = SL.expert_ffn(
        cfg, params, max_batch=4, n_requests=P10_CELL, device=device,
        cache_bytes=cache(SL.CACHE_BYTES), on_row=ffn_row)
    say(f"[phase10] expert_ffn: weight bytes per step "
        f"{qe_rows['dense_dequant']['expert_weight_bytes_per_step']!r} "
        f"dense, {qe_rows['quant_execution']['expert_weight_bytes_per_step']!r}"
        f" quantized ({reduction:.2f}x); per-token p50 "
        f"{qe_rows['dense_dequant']['per_token_p50_s']!r} and "
        f"{qe_rows['quant_execution']['per_token_p50_s']!r} s (cost model)")

    seconds = time.perf_counter() - t_phase
    if on_card:
        say(f"[phase10] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    say(f"[phase10] {seconds:.1f} s (host clock; budget {P10_BUDGET_S:.0f} "
        "s)")
    return seconds


CLIP_LENGTHS = (61, 64, 100, 200)      # the last is over 11a (iii)'s budget
CLIP_BUCKET = 8
P11_COLD_REQ = 2


def _peak_reset(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak_gb(on_card: bool) -> str:
    if not on_card:
        return "not measured (CPU)"
    return f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"


def _check_tokens(tag: str, completions, new: int, vocab: int) -> None:
    for c in completions:
        toks = np.asarray(c.tokens)
        if len(toks) != new or toks.min() < 0 or toks.max() >= vocab:
            fail(f"{tag}: request {c.request_id} gave {toks.tolist()}, not "
                 f"{new} tokens in the vocabulary")


def _want_k1_k2(tag: str, launches: dict, want: int, on_card: bool) -> None:
    got = {k: launches.get(k, 0) for k in ("k_major", "output_major")}
    say(f"[{tag}] kernel launches {got} (want {want} each)")
    if on_card and got != {"k_major": want, "output_major": want}:
        fail(f"{tag}: K1/K2 launched {got}, not {want} each")


def phase_serving_extras(cfg, params, prompts, p5, device: str = "cuda"):
    """Phase 11a: the server's cold and plain-engine paths and the
    scheduler's prompt clipping and bucketing at full width, over phase
    5's params with phase 5's engine settings, one engine at a time.
    (i) ``SliceMoEServer(persistent=False)`` serves 2 of phase 5's prompts,
    a fresh engine each; (ii) ``SliceMoEServer(engine_cfg=None)`` serves 1
    through ``PlainEngine`` (the float model, no kernel); (iii) the
    continuous-batching scheduler at ``max_batch=4`` with
    ``bucket_prompts=8`` and ``truncate_prompts=True`` serves prompts of
    61, 64, 100 and 200 tokens (the last over the budget of ``max_seq -
    max_new - 1`` = 128).  Hard checks: K1 and K2 once per MoE layer per
    forward in (i) and (iii), never in (ii); every completion its
    ``max_new`` tokens, all in the vocabulary; the clipped lengths those
    of the clipping rule (the tail kept, then rounded down to the
    bucket), read from the recorded prefill events, with ``truncated``
    set on exactly the clipped requests; every ledger total finite.
    Printed: each path's wall per generated token and its peak memory.
    Returns the seconds."""
    from repro_torch.serving.server import Request, SliceMoEServer

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    ecfg = _phase7_engine_config(p5)
    max_seq = SERVE_PROMPT + SERVE_NEW + 1

    def serve_server(engine_cfg, reqs, persistent):
        server = SliceMoEServer(cfg, params, engine_cfg=engine_cfg,
                                max_seq=max_seq, persistent=persistent,
                                device=device)
        for i, prompt in enumerate(reqs):
            server.submit(Request(request_id=i, prompt=prompt,
                                  max_new_tokens=SERVE_NEW))
        return server.run()

    # (i) the cold path: a fresh SliceMoEEngine per request.
    _peak_reset(on_card)
    cold, launches = _counted(
        lambda: serve_server(ecfg, prompts[:P11_COLD_REQ], False))
    _check_tokens("extras-cold", cold, SERVE_NEW, cfg.vocab_size)
    _want_k1_k2("extras-cold", launches,
                cfg.n_layers * sum(1 + len(c.tokens) for c in cold), on_card)
    for c in cold:
        totals = c.metrics["decode_totals"]
        if not c.metrics["logits_finite"] or not all(
                np.isfinite(v) for v in totals.values()):
            fail(f"extras-cold: request {c.request_id} gave non-finite "
                 "logits or ledger totals")
        say(f"[extras-cold] request {c.request_id}: prefill wall "
            f"{c.prefill_s:.4f} s, decode wall {c.decode_s:.4f} s, "
            f"{c.decode_s / len(c.tokens):.4f} s per token; decode energy "
            f"{totals['total_energy_j']!r} J, latency "
            f"{totals['total_latency_s']!r} s (cost model)")
    say(f"[extras-cold] {len(cold)} fresh engines; max_memory_allocated "
        f"{_peak_gb(on_card)}")
    del cold
    _release_any(on_card)

    # (ii) the plain engine: the float model, no offload simulation.
    _peak_reset(on_card)
    plain, launches = _counted(
        lambda: serve_server(None, prompts[:1], True))
    _check_tokens("extras-plain", plain, SERVE_NEW, cfg.vocab_size)
    _want_k1_k2("extras-plain", launches, 0, on_card)
    if plain[0].metrics is not None:
        fail("extras-plain: the plain engine returned engine metrics")
    c = plain[0]
    # As in the reference, the plain engine's generate() holds the
    # prefill, so the completion's decode wall includes it.
    say(f"[extras-plain] PlainEngine: prefill and decode wall "
        f"{c.decode_s:.4f} s, {c.decode_s / len(c.tokens):.4f} s per token; "
        f"max_memory_allocated {_peak_gb(on_card)}")
    del plain
    _release_any(on_card)

    # (iii) clipping and bucketing through the batching scheduler.
    _peak_reset(on_card)
    rng = np.random.default_rng(11)
    clip_prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                    for n in CLIP_LENGTHS]
    run = _serve(cfg, params, ecfg, clip_prompts, "extras-clip", device,
                 sched_kw=dict(bucket_prompts=CLIP_BUCKET,
                               truncate_prompts=True))
    budget = max_seq - SERVE_NEW - 1
    want = {}
    for rid, n in enumerate(CLIP_LENGTHS):
        m = min(n, budget)
        want[rid] = (m // CLIP_BUCKET) * CLIP_BUCKET if m > CLIP_BUCKET \
            else m
    got = {e.request_id: int(e.ids.shape[2]) for e in run["trace"].events
           if e.kind == "prefill"}
    flags = {rid: r.truncated
             for rid, r in run["sched"].telemetry.requests.items()}
    flagged = {c.request_id: c.metrics["prompt_truncated"]
               for c in run["completions"]}
    clipped = {rid: want[rid] != n for rid, n in enumerate(CLIP_LENGTHS)}
    say(f"[extras-clip] prompt lengths {list(CLIP_LENGTHS)} -> admitted "
        f"{[got.get(r) for r in range(len(CLIP_LENGTHS))]} (want "
        f"{[want[r] for r in range(len(CLIP_LENGTHS))]}); truncated "
        f"{[flags.get(r) for r in range(len(CLIP_LENGTHS))]}")
    if got != want:
        fail(f"extras-clip: admitted prompt lengths {got}, not {want}")
    if flags != clipped or flagged != clipped:
        fail(f"extras-clip: truncated flags {flags} / {flagged}, not "
             f"{clipped}")
    _check_tokens("extras-clip", run["completions"], SERVE_NEW,
                  cfg.vocab_size)
    snap = run["engine"].ledger.snapshot()
    if not all(np.isfinite(v) for v in snap.values()):
        fail("extras-clip: a ledger total is not finite")
    n_tok = sum(len(c.tokens) for c in run["completions"])
    sched = run["sched"]
    say(f"[extras-clip] {len(sched.wall_prefill_s)} prefills, "
        f"{len(sched.wall_step_s)} decode steps of up to 4 sequences, wall "
        f"{run['wall']:.2f} s, {run['wall'] / n_tok:.4f} s per generated "
        f"token; energy {snap['total_energy_j']!r} J, latency "
        f"{snap['total_latency_s']!r} s (cost model); max_memory_allocated "
        f"{_peak_gb(on_card)}")
    del run, sched
    _release_any(on_card)
    seconds = time.perf_counter() - t_phase
    say(f"[phase11] 11a {seconds:.1f} s (host clock)")
    return seconds


def _release_any(on_card: bool) -> None:
    if on_card:
        _release()
    else:
        gc.collect()


CLI_MODEL = ["--arch", "qwen15-moe-a2.7b"]
CLI_REQ, CLI_PROMPT, CLI_NEW = 2, 64, 16


def phase_serve_cli(device: str = "cuda", model_argv=CLI_MODEL,
                    cache_mb=None):
    """Phase 11b: the port's serving CLI, ``repro_torch.launch.serve.main``
    called in this process as a user would call it: ``model_argv``
    (full width by default, its own init from seed 0), 2 requests of 64
    prompt tokens and 16 new tokens, ``--cache-mb cache_mb`` when given
    (the CLI's default of 4 MB holds no expert of the full-width model,
    so every access would miss), recording its trace and writing the
    Chrome export, the metrics JSONL and the Prometheus text; then a bare
    ``--replay-trace`` of that trace with its own export.  The CLI keeps
    the reference's dense-dequant default, so K1/K2 launch 0 times.  Hard
    checks: the launch count; the replay's energy and latency equal the
    live ledger's (rtol 1e-6), its epoch miss rates the live cache's, and
    each request's decode window's MSB miss rate the live line's
    ``miss_rate``; the two exports hold the same channel events; the
    metrics JSONL one sample per decode step; the Prometheus file
    non-empty; every request its 16 tokens.  Returns the seconds."""
    import contextlib
    import io

    from repro_torch.launch import serve as SERVE
    from repro_torch.obs.timeline import REQUESTS_PID
    from repro_torch.sim import ReplayEngine, Trace

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    path = {k: os.path.join(build, f"cli_{k}") for k in (
        "trace.npz", "chrome.json", "metrics.jsonl", "metrics.prom",
        "replay.json")}
    servers = []

    class CapturedServer(SERVE.SliceMoEServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    def cli(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            SERVE.main(argv)
        return buf.getvalue()

    _peak_reset(on_card)
    saved, SERVE.SliceMoEServer = SERVE.SliceMoEServer, CapturedServer
    try:
        t0 = time.perf_counter()
        cache = [] if cache_mb is None else ["--cache-mb", repr(cache_mb)]
        out, launches = _counted(lambda: cli(model_argv + cache + [
            "--device", device, "--n-requests", str(CLI_REQ),
            "--prompt-len", str(CLI_PROMPT), "--max-new", str(CLI_NEW),
            "--seed", "0", "--record-trace", path["trace.npz"],
            "--trace-out", path["chrome.json"],
            "--metrics-out", path["metrics.jsonl"],
            "--prom-out", path["metrics.prom"]]))
        t_live = time.perf_counter() - t0
    finally:
        SERVE.SliceMoEServer = saved
    for line in out.splitlines():
        say(f"[cli] {line}")
    server = servers[0]
    engine = server._engine
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    requests = [x for x in lines if "request" in x]
    _want_k1_k2("cli", launches, 0, on_card)
    _check_tokens("cli", server.completions, CLI_NEW, engine.cfg.vocab_size)
    n_tok = sum(len(c.tokens) for c in server.completions)
    wall_dec = sum(c.decode_s for c in server.completions)
    say(f"[cli] live run {t_live:.2f} s (init, engine, serving, exports); "
        f"decode wall {wall_dec:.2f} s for {n_tok} tokens, "
        f"{wall_dec / n_tok:.4f} s per token on the dense-dequant path; "
        f"prefill walls {[round(c.prefill_s, 4) for c in server.completions]}"
        f" s; max_memory_allocated {_peak_gb(on_card)}")

    replay_out = cli(["--replay-trace", path["trace.npz"],
                      "--trace-out", path["replay.json"]])
    report = json.loads(replay_out)
    say(f"[cli] --replay-trace: {json.dumps(report)}")
    live = engine.ledger.snapshot()
    for key in ("total_energy_j", "total_latency_s"):
        if not _close(report[key], live[key], 1e-6):
            fail(f"cli: the bare replay's {key} {report[key]!r} differs from "
                 f"the live {live[key]!r}")
    live_epochs = [{"epoch": label, "miss_rate": round(m, 6)}
                   for label, m in engine.cache.epoch_miss_rates()]
    if report["epoch_miss"] != live_epochs:
        fail(f"cli: replayed epoch miss rates {report['epoch_miss']} differ "
             f"from the live {live_epochs}")
    trace = Trace.load(path["trace.npz"])
    rep = ReplayEngine(trace.meta)
    rep.consume_all(trace.events)
    rep.finish()
    decode_msb = [round(st["msb_misses"] / max(
        st["msb_hits"] + st["msb_misses"], 1), 4)
        for label, st in rep.cache.epochs if label.endswith("/decode")]
    if decode_msb != [x["miss_rate"] for x in requests]:
        fail(f"cli: replayed decode MSB miss rates {decode_msb} differ from "
             f"the live lines' {[x['miss_rate'] for x in requests]}")
    with open(path["chrome.json"]) as f:
        live_events = [e for e in json.load(f)["traceEvents"]
                       if e.get("pid") != REQUESTS_PID]
    with open(path["replay.json"]) as f:
        replay_events = json.load(f)["traceEvents"]
    if live_events != replay_events:
        fail(f"cli: the live export's {len(live_events)} channel events "
             f"differ from the replay's {len(replay_events)}")
    with open(path["metrics.jsonl"]) as f:
        n_samples = len(f.read().splitlines())
    if n_samples != trace.n_decode_steps:
        fail(f"cli: {n_samples} metrics samples for "
             f"{trace.n_decode_steps} decode steps")
    with open(path["metrics.prom"]) as f:
        if not f.read().strip():
            fail("cli: the Prometheus file is empty")
    say(f"[cli] bare replay == live: energy {report['total_energy_j']!r} J, "
        f"latency {report['total_latency_s']!r} s (cost model, rtol 1e-6); "
        f"{len(live_epochs)} epochs; decode MSB miss rates {decode_msb}; "
        f"{len(replay_events)} channel events in both exports; "
        f"{n_samples} metrics samples")
    del server, engine, servers
    _release_any(on_card)
    seconds = time.perf_counter() - t_phase
    say(f"[phase11] 11b {seconds:.1f} s (host clock)")
    return seconds


TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 2, 40, 8, 64, 2e-3


# --------------------------------------------------------------------------
# Phase 12: the dense architecture, windows, soft-capping, tied vocabularies
# and llama4-scout at full width.
P12_SCOUT = "llama4-scout-17b-a16e"
P12_SCOUT_LAYERS = 8                    # of 48: the depth one card holds
P12_GEMMA_REQ, P12_GEMMA_PROMPT, P12_GEMMA_NEW = 2, 64, 16
P12_WINDOW_PROMPT, P12_WINDOW_STEPS = 4608, 8
P12_BUDGET_S = 90.0


def _say12(msg: str, card: str) -> None:
    say(f"[phase12] {msg}; card {card}")


def _device_bytes(cfg) -> dict:
    """What a MoE engine (Scout's, Jamba's) holds on the card, from the
    shapes: the float parameters in bf16 and, per MoE layer, the AMAT
    codes (one byte per weight), their f32 scales and uint8 zero-points
    per 32-row group, and the output-major copy of the ``wo`` codes
    (quantized execution).  An SSM mixer's ``A_log``, ``D`` and
    ``dt_bias`` are f32, counted here as bf16 (a few kB)."""
    from repro_torch.models.model import param_shapes, shape_leaves

    n = sum(int(np.prod(s)) for s in shape_leaves(param_shapes(cfg)))
    m = cfg.moe
    wi, wo = cfg.d_model * 2 * m.d_ff, m.d_ff * cfg.d_model
    per_layer = m.n_experts * ((wi + wo) * (1 + 5 / 32) + wo)
    return {"params": n, "float_bytes": n * 2,
            "amat_bytes": per_layer * _n_moe_layers(cfg)}


def phase_moe_kernels(cfg, card: str, tag: str, sub: str, say_fn):
    """Before a MoE model is built (12a: Scout, 13a: Jamba): K1 (``wi``,
    K-major) and K2 (``wo``, output-major) with bf16 x at ``cfg``'s decode
    shapes (E experts, the capacity of 4 sequences at its top-k; Scout:
    E=16, M=8, K=5120, N=16384 for ``wi`` and K=8192, N=5120 for ``wo``;
    Jamba: E=16, M=8, K=4096, N=28672 and K=14336, N=4096) against their
    plain versions at the kernel tolerance, timed beside the plain
    version, ``torch.bmm`` on dense f32 weights and the bound; then at
    the prefill capacities of one 128-token prompt and of 512 tokens
    (checked, not timed).  Rows are named ``{tag}_...``; ``say_fn`` prints
    the phase's lines, ``sub`` leading them."""
    from repro_torch.models.moe import capacity

    m = cfg.moe
    caps = {n: capacity(n, m.top_k, m.n_experts, m.capacity_factor)
            for n in (SERVE_REQ, SERVE_PROMPT, SERVE_REQ * SERVE_PROMPT)}
    rows = []
    for n_tok, M in caps.items():
        rows += [(f"{tag}_wi_bf16_{n_tok}tok", False,
                  (m.n_experts, M, cfg.d_model, 2 * m.d_ff), n_tok == SERVE_REQ),
                 (f"{tag}_wo_t_bf16_{n_tok}tok", True,
                  (m.n_experts, M, m.d_ff, cfg.d_model), n_tok == SERVE_REQ)]
    return {name: _expert_kernel_row(
                name, shape, seed=100 + seed, transposed=transposed,
                x_dtype=torch.bfloat16, timed=timed,
                say_fn=lambda msg: say_fn(f"{sub} {msg}", card))
            for seed, (name, transposed, shape, timed) in enumerate(rows)}


def _expert_kernel_row(name, shape, *, seed, transposed, x_dtype, timed,
                       say_fn) -> dict:
    """One row of K1 (K-major codes) or K2 (``transposed``: output-major)
    at ``shape`` = (E, M, K, N): against the plain version at the kernel
    tolerance and, when ``timed``, timed beside the plain version,
    ``torch.bmm`` on dense f32 weights and the bound, its line said
    through ``say_fn``."""
    from repro_torch.kernels.amat_matmul import ops
    from repro_torch.kernels.amat_matmul.ref import (
        _dequant_mixed_ref, amat_batched_matmul_ref, amat_batched_matmul_t_ref)

    E, M, K, N = shape
    args = _kernel_inputs(E, M, K, N, seed=seed, transposed=transposed,
                          x_dtype=x_dtype)
    ref = amat_batched_matmul_t_ref if transposed else amat_batched_matmul_ref

    def kern():
        return ops.amat_expert_matmul(*args, group_size=32, shift=4,
                                      transposed=transposed)

    def plain():
        return ref(*args, group_size=32, shift=4)

    err = _check_row(f"{name} E={E} M={M} K={K} N={N}", kern(), plain(),
                     (E, M, N))
    t = {"max_abs_err": err, "shape": shape}
    if timed:
        x, codes, scales, zps, use_lsb = args
        codes_kn = codes.transpose(1, 2) if transposed else codes
        w_dense = _dequant_mixed_ref(codes_kn, scales, zps, use_lsb,
                                     group_size=32, shift=4).contiguous()
        x32 = x.float()
        nbytes = (codes.numel() + scales.numel() * 4 + zps.numel()
                  + x.numel() * x.element_size() + E * M * N * 4
                  + use_lsb.numel())
        t.update(_timed(name, kern, plain, lambda: torch.bmm(x32, w_dense),
                        "torch.bmm on dense f32 weights", nbytes,
                        _amat_flops(x_dtype, 2.0 * E * M * K * N),
                        f"{codes.numel() / 1e6:.0f} MB of codes"))
        del w_dense, x32
        _versus_library(name, t)
        say_fn(f"{name}: graph_ms {t['graph_ms']:.4f}, bound "
               f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
               f"({t['bound_ms'] / t['graph_ms']:.1%}), torch.bmm "
               f"graph_ms {t['library_graph_ms']}, max|kernel-plain| "
               f"{err:.3e}")
    del args
    torch.cuda.empty_cache()
    return t


def phase_scout(cfg, card: str, device: str = "cuda"):
    """12a: ``llama4-scout-17b-a16e`` at its published widths with its
    depth cut to ``cfg.n_layers`` (bf16, random weights from seed 0),
    phase 5's settings (MAT84, Cache-Prior + DBSC with quantized
    execution, PCW, miss target 0.05, a quarter of the store cached) and
    traffic (4 requests of 128 prompt tokens and 16 new tokens,
    ``max_batch=4``), recorded and replayed.  Hard checks: K1 and K2 each
    ``n_layers x 20`` times (4 prefills and 16 decode steps), every logit
    finite, every request served in full, the replay equal to the live
    run (``_check_replay``).  Returns the seconds."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.models.model import init_params

    on_card = device == "cuda"
    t0 = time.perf_counter()
    est = _device_bytes(cfg)
    store_bytes = _store_bytes(cfg, MatConfig(8, 4))
    _say12(f"12a {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
           f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
           f"{cfg.head_dim}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
           f"of width {cfg.moe.d_ff}, {cfg.moe.n_shared_experts} shared of "
           f"{cfg.moe.d_ff_shared}, vocab {cfg.vocab_size}; "
           f"{est['params'] / 1e9:.2f} B params ({est['float_bytes'] / 1e9:.2f}"
           f" GB bf16) and {est['amat_bytes'] / 1e9:.2f} GB of AMAT codes, "
           f"scales, zero-points and output-major wo codes on the card "
           f"(MAT84, from the shapes)", card)
    _peak_reset(on_card)
    params = init_params(cfg, seed=0, device=device)
    ecfg = _phase7_engine_config({"cache_bytes": store_bytes / 4})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQ)]
    run = _serve(cfg, params, ecfg, prompts, "scout", device)
    n_fwd = len(run["sched"].wall_prefill_s) + len(run["sched"].wall_step_s)
    if n_fwd != SERVE_REQ + SERVE_NEW:
        fail(f"scout: {n_fwd} forwards, not {SERVE_REQ + SERVE_NEW}")
    if run["engine"].store.total_bytes() != store_bytes:
        fail("scout: slice store size differs from its analytic size")
    _say_walls("scout", run)
    path = os.path.join(HERE, "build", "scout_trace.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rep = _check_replay(run, "scout", path)
    cs = [c.metrics["cache_stats"] for c in run["completions"]]
    seconds = time.perf_counter() - t0
    _say12(f"12a {cfg.name}: K1/K2 launches {run['launches']} (want "
           f"{cfg.n_layers} x {n_fwd} = {cfg.n_layers * n_fwd} each); "
           f"every logit finite; replay equal to the live run (decode "
           f"accesses/misses {rep.decode_accesses}/{rep.decode_misses}, "
           f"energy {rep.total_energy_j!r} J, cost model); MSB misses per "
           f"request {[c['msb_misses'] for c in cs]}; run wall "
           f"{run['wall']:.2f} s, AMAT quantization {run['t_quant']:.2f} s; "
           f"max_memory_allocated {_peak_gb(on_card)} (shapes: "
           f"{(est['float_bytes'] + est['amat_bytes']) / 1e9:.2f} GB); "
           f"{seconds:.1f} s", card)
    del run, params, rep
    _release_any(on_card)
    return seconds


def _greedy(cfg, params, prompt, n_new: int, max_seq: int, device,
            **extras):
    """A direct greedy loop over ``prefill`` (given ``extras``: a prefix,
    encoder frames) and ``decode_step``: the tokens, and whether every
    logit was finite."""
    from repro_torch.models.model import decode_step, prefill

    toks = torch.as_tensor(prompt, dtype=torch.int64, device=device)[None]
    logits, cache, _ = prefill(params, cfg, toks, max_seq, **extras)
    finite = torch.isfinite(logits).all()
    out, token = [], torch.argmax(logits, dim=-1)
    for _ in range(n_new):
        out.append(int(token[0]))
        logits, cache, _ = decode_step(params, cfg, token, cache)
        finite &= torch.isfinite(logits).all()
        token = torch.argmax(logits, dim=-1)
    return out, bool(finite)


def phase_gemma(cfg, card: str, device: str = "cuda"):
    """12b: ``gemma-7b`` at full depth and width (bf16, random weights
    from seed 0; GeGLU, head dim 256, tied vocabulary of 256000, attention
    soft-cap 30) through ``SliceMoEServer(engine_cfg=None)``, that is
    ``PlainEngine``: 2 requests of 64 prompt tokens and 16 new.  Hard
    checks: no kernel launched; the server's tokens equal a direct greedy
    ``prefill`` / ``decode_step`` loop over the same params, exactly; every
    logit of that loop finite.  Returns the seconds."""
    from repro_torch.models.model import count_params, init_params
    from repro_torch.serving import Request, SliceMoEServer

    on_card = device == "cuda"
    t0 = time.perf_counter()
    _peak_reset(on_card)
    params = init_params(cfg, seed=0, device=device)
    n = count_params(params)
    max_seq = P12_GEMMA_PROMPT + P12_GEMMA_NEW + 1
    server = SliceMoEServer(cfg, params, engine_cfg=None, max_seq=max_seq,
                            device=device)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, P12_GEMMA_PROMPT).astype(
        np.int32) for _ in range(P12_GEMMA_REQ)]
    for i, p in enumerate(prompts):
        server.submit(Request(request_id=i, prompt=p,
                              max_new_tokens=P12_GEMMA_NEW))
    t_serve = time.perf_counter()
    done, launches = _counted(server.run)
    t_serve = time.perf_counter() - t_serve
    if any(launches.values()):
        fail(f"gemma: kernels launched on the plain path: {launches}")
    if "unembed" in params or server._engine is not None:
        fail("gemma: a tied model grew an unembed leaf, or an engine")
    _check_tokens("gemma", done, P12_GEMMA_NEW, cfg.vocab_size)
    for c, p in zip(sorted(done, key=lambda c: c.request_id), prompts):
        direct, finite = _greedy(cfg, params, p, P12_GEMMA_NEW, max_seq,
                                 device)
        if not finite:
            fail(f"gemma: request {c.request_id}: non-finite logits")
        if direct != np.asarray(c.tokens).tolist():
            fail(f"gemma: request {c.request_id}: server tokens "
                 f"{np.asarray(c.tokens).tolist()} != the direct loop's "
                 f"{direct}")
    seconds = time.perf_counter() - t0
    n_tok = P12_GEMMA_REQ * P12_GEMMA_NEW
    _say12(f"12b {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
           f"{cfg.n_heads} heads of {cfg.head_dim}, {cfg.mlp_type}, vocab "
           f"{cfg.vocab_size} tied, softcap {cfg.logit_softcap}; "
           f"{n / 1e9:.2f} B params in {cfg.dtype}; PlainEngine served "
           f"{P12_GEMMA_REQ} x ({P12_GEMMA_PROMPT} + {P12_GEMMA_NEW}) "
           f"tokens in {t_serve:.2f} s ({t_serve / n_tok:.4f} s per "
           f"generated token, prefill included); K1/K2 launches {launches}; "
           f"tokens equal the direct greedy loop's; every logit finite; "
           f"max_memory_allocated {_peak_gb(on_card)}; {seconds:.1f} s",
           card)
    del server, params, done
    _release_any(on_card)
    return seconds


def phase_window(cfg, card: str, device: str = "cuda",
                 n_prompt: int = P12_WINDOW_PROMPT,
                 n_steps: int = P12_WINDOW_STEPS):
    """12c: ``starcoder2-3b`` at full depth and width in f32 (GELU,
    ``qkv_bias``, window 4096; TF32 off), one prompt of ``n_prompt``
    tokens through ``prefill(use_window=True)``, then ``n_steps``
    ``decode_step(use_window=True)`` steps, each reading the last 4096
    cache rows.  Each step's logits must hold against ``unembed(forward(
    ..., use_window=True))`` at the last position within ``1e-4 +
    1e-4*|oracle|`` (``tests/test_perf_variants.py:70`` at full width);
    the unwindowed forward's logits must differ from the windowed ones by
    more than that, so a window silently ignored would fail.  Returns the
    seconds."""
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          prefill, unembed)

    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _peak_reset(on_card)
    params = init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(13)
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size, n_prompt),
                          dtype=torch.int64, device=device)[None]
    with torch.no_grad():
        def oracle(window: bool):
            h, _ = forward(params, cfg, seq, use_window=window)
            return unembed(params, cfg, h[:, -1])

        t_pre = time.perf_counter()
        logits, cache, _ = prefill(params, cfg, seq, n_prompt + n_steps,
                                   use_window=True)
        _sync_any(on_card)
        t_pre = time.perf_counter() - t_pre
        ratios, walls = [], []
        for step in range(n_steps):
            token = torch.argmax(logits, dim=-1)
            seq = torch.cat([seq, token[:, None]], dim=1)
            t1 = time.perf_counter()
            logits, cache, _ = decode_step(params, cfg, token, cache,
                                           use_window=True)
            _sync_any(on_card)
            walls.append(time.perf_counter() - t1)
            want = oracle(True)
            tol = 1e-4 + 1e-4 * want.abs()
            ratio = float(((logits - want).abs() / tol).max())
            ratios.append(ratio)
            say(f"[window] step {step} (position {n_prompt + step}): "
                f"max|decode - windowed forward| / (1e-4 + 1e-4*|oracle|) "
                f"= {ratio:.4f}, max abs gap "
                f"{float((logits - want).abs().max()):.3e}")
        unwindowed = oracle(False)
        apart = float(((unwindowed - want).abs() / tol).max())
    peak = _peak_gb(on_card)
    seconds = time.perf_counter() - t0
    _say12(f"12c {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
           f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, "
           f"{cfg.mlp_type}, window {cfg.sliding_window}, {cfg.dtype}; "
           f"prefill of {n_prompt} tokens {t_pre:.2f} s, decode steps "
           f"{[round(w, 4) for w in walls]} s; worst step's gap "
           f"{max(ratios):.4f} of the tolerance (must be <= 1), the "
           f"unwindowed forward {apart:.1f} of it at the last step (must "
           f"be > 1); max_memory_allocated {peak}; {seconds:.1f} s", card)
    del params, cache, logits
    _release_any(on_card)
    if max(ratios) > 1.0:
        fail(f"window: the windowed decode missed the windowed forward by "
             f"{max(ratios):.4f} of the tolerance 1e-4 + 1e-4*|oracle|")
    if apart <= 1.0:
        fail("window: the unwindowed forward is within the tolerance of the "
             "windowed one, so the check cannot see the window")
    return seconds


def _sync_any(on_card: bool) -> None:
    if on_card:
        torch.cuda.synchronize()


def phase_archs(device: str = "cuda", scout=None, gemma=None, window=None,
                window_prompt: int = P12_WINDOW_PROMPT):
    """Phase 12 (after 11b, before 6; one model at a time, each released
    before the next is built): 12a ``phase_moe_kernels`` and
    ``phase_scout``, 12b ``phase_gemma``, 12c ``phase_window``.  The
    configs default to the full-width ones (Scout's depth cut to
    ``P12_SCOUT_LAYERS``, StarCoder2 in f32); pass reduced ones to
    rehearse on the CPU.  Returns the seconds."""
    from repro_torch.configs.base import get_config

    on_card = device == "cuda"
    card = smi_name_power() if on_card else "none (CPU)"
    t0 = time.perf_counter()
    if scout is None:
        scout = dataclasses.replace(get_config(P12_SCOUT),
                                    n_layers=P12_SCOUT_LAYERS)
        _say12(f"reduced: {scout.name} depth cut to {scout.n_layers} of "
               f"{get_config(P12_SCOUT).n_layers} layers (widths as "
               "published); gemma-7b and starcoder2-3b whole", card)
    if on_card:
        phase_moe_kernels(scout, card, "scout", "12a", _say12)
        _release()
    t_a = phase_scout(scout, card, device)
    t_b = phase_gemma(gemma or get_config("gemma-7b"), card, device)
    t_c = phase_window(window or dataclasses.replace(
        get_config("starcoder2-3b"), dtype="float32"), card, device,
        n_prompt=window_prompt)
    seconds = time.perf_counter() - t0
    _say12(f"12a {t_a:.1f} s, 12b {t_b:.1f} s, 12c {t_c:.1f} s: phase 12 "
           f"adds {seconds:.1f} s to the run (host clock; budget "
           f"{P12_BUDGET_S:.0f} s)", card)
    return seconds


# --------------------------------------------------------------------------
# Phase 13: the Mamba2 (SSD) mixer, the SSM and hybrid architectures.
P13_JAMBA = "jamba-v0.1-52b"
P13_JAMBA_LAYERS = 8                   # of 32: one period of its pattern
P13_MAMBA = "mamba2-2.7b"
P13_MAMBA_REQ, P13_MAMBA_PROMPT, P13_MAMBA_NEW = 2, 64, 16
P13_LONG_PROMPT, P13_LONG_STEPS = 2000, 8
# 13c (ii): decode against the forward, |gap| <= P13_TOL * (1 + |oracle|).
# Both sum in f32, in another order, by two algorithms (the recurrence,
# the chunked scan).  On the CPU with mamba2's pattern the gap was
# 0.08-0.20 of 1e-4 * (1 + |oracle|) (d_model 256 and 1024, 16 and 64
# layers, 2000 tokens; 4x the width about doubled it); full width is 2.5x
# wider again, so 5x 12c's tolerance keeps a margin of about 10x, while a
# decode from a zeroed state misses by thousands of tolerances.
P13_TOL = 5e-4
P13_PEAK_SLACK = 1.05                  # 13b's peak over the shapes' bytes
P13_BUDGET_S = 60.0


def _say13(msg: str, card: str) -> None:
    say(f"[phase13] {msg}; card {card}")


def phase_jamba(cfg, card: str, device: str = "cuda"):
    """13b: ``jamba-v0.1-52b`` at its published widths with its depth cut
    to ``cfg.n_layers`` (bf16, random weights from seed 0), phase 5's
    settings (MAT84, Cache-Prior + DBSC with quantized execution, PCW,
    miss target 0.05, a quarter of the store cached) and traffic (4
    requests of 128 prompt tokens and 16 new, ``max_batch=4``), recorded
    and replayed.  Hard checks: K1 and K2 each (MoE layers) x 20 times,
    every logit finite, every request served in full, every leaf of the
    batch cache on the device (SSM ``state`` f32, ``conv`` and the KV rows
    in the model dtype), the replay equal to the live run, the peak
    memory within ``P13_PEAK_SLACK`` of the shapes' bytes.  Returns the
    seconds."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.models.model import init_params

    on_card = device == "cuda"
    t0 = time.perf_counter()
    est = _device_bytes(cfg)
    n_moe = _n_moe_layers(cfg)
    store_bytes = _store_bytes(cfg, MatConfig(8, 4))
    pattern = "".join("A" if b.mixer == "attn" else "S"
                      for b in cfg.block_pattern)
    _say13(f"13b {cfg.name}: {cfg.n_layers} layers of pattern {pattern} "
           f"(MoE FFN at positions "
           f"{[i for i, b in enumerate(cfg.block_pattern) if b.ffn == 'moe']}"
           f", {n_moe} MoE layers), d_model {cfg.d_model}, {cfg.n_heads} "
           f"heads over {cfg.n_kv_heads} KV heads of {cfg.head_dim}, SSM "
           f"{cfg.ssm.n_heads(cfg.d_model)} heads of {cfg.ssm.head_dim}, "
           f"state {cfg.ssm.d_state}, {cfg.moe.n_experts} experts top-"
           f"{cfg.moe.top_k} of width {cfg.moe.d_ff}, vocab {cfg.vocab_size}"
           f"; {est['params'] / 1e9:.2f} B params "
           f"({est['float_bytes'] / 1e9:.2f} GB bf16) and "
           f"{est['amat_bytes'] / 1e9:.2f} GB of AMAT codes, scales, "
           f"zero-points and output-major wo codes on the card (MAT84, from "
           f"the shapes)", card)
    _peak_reset(on_card)
    params = init_params(cfg, seed=0, device=device)
    ecfg = _phase7_engine_config({"cache_bytes": store_bytes / 4})
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32)
               for _ in range(SERVE_REQ)]
    run = _serve(cfg, params, ecfg, prompts, "jamba", device)
    sched = run["sched"]
    n_fwd = len(sched.wall_prefill_s) + len(sched.wall_step_s)
    if n_fwd != SERVE_REQ + SERVE_NEW:
        fail(f"jamba: {n_fwd} forwards, not {SERVE_REQ + SERVE_NEW}")
    if tuple(run["engine"].moe_positions) != (1, 3, 5, 7):
        fail(f"jamba: MoE positions {run['engine'].moe_positions}")
    if run["engine"].store.total_bytes() != store_bytes:
        fail("jamba: slice store size differs from its analytic size")
    want_dtype = {"state": torch.float32}
    leaves = []
    for key, entry in sched.batch_cache.items():
        if key == "pos":
            continue
        for name, leaf in entry.items():
            dtype = want_dtype.get(name, torch.bfloat16)
            leaves.append(f"{key}/{name} {tuple(leaf.shape)} {leaf.dtype}")
            if leaf.device.type != torch.device(device).type \
                    or leaf.dtype != dtype:
                fail(f"jamba: batch cache leaf {key}/{name} is "
                     f"{leaf.dtype} on {leaf.device}, not {dtype} on "
                     f"{device}")
    say(f"[jamba] batch cache on {device}: " + ", ".join(leaves))
    _say_walls("jamba", run)
    path = os.path.join(HERE, "build", "jamba_trace.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rep = _check_replay(run, "jamba", path)
    if run["trace"].meta.moe_positions != (1, 3, 5, 7):
        fail("jamba: the trace does not carry moe_positions (1, 3, 5, 7)")
    shapes_gb = (est["float_bytes"] + est["amat_bytes"]) / 1e9
    peak = _peak_gb(on_card)
    if on_card and torch.cuda.max_memory_allocated() / 1e9 \
            > P13_PEAK_SLACK * shapes_gb:
        fail(f"jamba: peak {peak} over {P13_PEAK_SLACK} x the shapes' "
             f"{shapes_gb:.2f} GB")
    cs = [c.metrics["cache_stats"] for c in run["completions"]]
    seconds = time.perf_counter() - t0
    _say13(f"13b {cfg.name}: K1/K2 launches {run['launches']} (want "
           f"{n_moe} x {n_fwd} = {n_moe * n_fwd} each); every logit finite; "
           f"replay equal to the live run (decode accesses/misses "
           f"{rep.decode_accesses}/{rep.decode_misses}, energy "
           f"{rep.total_energy_j!r} J, cost model); MSB misses per request "
           f"{[c['msb_misses'] for c in cs]}; run wall {run['wall']:.2f} s, "
           f"median decode step {np.median(sched.wall_step_s):.4f} s, AMAT "
           f"quantization {run['t_quant']:.2f} s; max_memory_allocated "
           f"{peak} (shapes: {shapes_gb:.2f} GB); {seconds:.1f} s", card)
    del run, sched, params, rep
    _release_any(on_card)
    return seconds


def phase_mamba(cfg, card: str, device: str = "cuda",
                n_prompt: int = P13_LONG_PROMPT, n_steps: int = P13_LONG_STEPS):
    """13c: ``mamba2-2.7b`` whole in f32 (TF32 off; random weights from
    seed 0).  (i) ``SliceMoEServer`` with an engine config serves 2
    requests of 64 + 16 tokens through ``PlainEngine`` (the model has no
    MoE layer): no kernel launched, no engine built, the tokens equal a
    direct greedy ``prefill`` / ``decode_step`` loop's, every logit
    finite.  (ii) One prompt of ``n_prompt`` tokens (2000: 7 chunks of
    256 and a padded eighth of 208), then ``n_steps`` decode steps; each
    step's logits within ``P13_TOL * (1 + |oracle|)`` of ``unembed(
    forward(...))`` over the prompt and the tokens so far, and the same
    steps decoded from a zeroed ``state`` and ``conv`` outside it at
    every step.  Returns the seconds."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.model import (count_params, decode_step, forward,
                                          init_cache, init_params, prefill,
                                          unembed)
    from repro_torch.serving import Request, SliceMoEServer

    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _peak_reset(on_card)
    params = init_params(cfg, seed=0, device=device)
    n = count_params(params)

    # (i) the server's plain path.
    max_seq = P13_MAMBA_PROMPT + P13_MAMBA_NEW + 1
    server = SliceMoEServer(cfg, params, engine_cfg=EngineConfig(
        mat=MatConfig(8, 4)), max_seq=max_seq, device=device)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, P13_MAMBA_PROMPT).astype(
        np.int32) for _ in range(P13_MAMBA_REQ)]
    for i, p in enumerate(prompts):
        server.submit(Request(request_id=i, prompt=p,
                              max_new_tokens=P13_MAMBA_NEW))
    t_serve = time.perf_counter()
    done, launches = _counted(server.run)
    t_serve = time.perf_counter() - t_serve
    if any(launches.values()):
        fail(f"mamba: kernels launched on the plain path: {launches}")
    if server._engine is not None or any(c.metrics is not None
                                         for c in done):
        fail("mamba: a model without MoE layers got a SliceMoE engine")
    _check_tokens("mamba", done, P13_MAMBA_NEW, cfg.vocab_size)
    for c, p in zip(sorted(done, key=lambda c: c.request_id), prompts):
        direct, finite = _greedy(cfg, params, p, P13_MAMBA_NEW, max_seq,
                                 device)
        if not finite:
            fail(f"mamba: request {c.request_id}: non-finite logits")
        if direct != np.asarray(c.tokens).tolist():
            fail(f"mamba: request {c.request_id}: server tokens "
                 f"{np.asarray(c.tokens).tolist()} != the direct loop's "
                 f"{direct}")
    del server, done

    # (ii) a long prompt, then decode steps held against the forward.
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size, n_prompt),
                          dtype=torch.int64, device=device)[None]
    with torch.no_grad():
        t_pre = time.perf_counter()
        logits, cache, _ = prefill(params, cfg, seq, n_prompt + n_steps)
        _sync_any(on_card)
        t_pre = time.perf_counter() - t_pre
        zeroed = init_cache(cfg, 1, n_prompt + n_steps, device=device)
        zeroed["pos"] = cache["pos"].clone()
        ratios, controls, walls = [], [], []
        for step in range(n_steps):
            token = torch.argmax(logits, dim=-1)
            seq = torch.cat([seq, token[:, None]], dim=1)
            t1 = time.perf_counter()
            logits, cache, _ = decode_step(params, cfg, token, cache)
            _sync_any(on_card)
            walls.append(time.perf_counter() - t1)
            control, zeroed, _ = decode_step(params, cfg, token, zeroed)
            h, _ = forward(params, cfg, seq)
            want = unembed(params, cfg, h[:, -1])
            tol = P13_TOL * (1.0 + want.abs())
            ratios.append(float(((logits - want).abs() / tol).max()))
            controls.append(float(((control - want).abs() / tol).max()))
            if not bool(torch.isfinite(logits).all()):
                fail(f"mamba: step {step}: non-finite logits")
            say(f"[ssm] step {step} (position {n_prompt + step}): "
                f"max|decode - forward| / ({P13_TOL:g} * (1 + |oracle|)) = "
                f"{ratios[-1]:.4f} (max abs gap "
                f"{float((logits - want).abs().max()):.3e}); from a zeroed "
                f"state {controls[-1]:.1f}")
    peak = _peak_gb(on_card)
    seconds = time.perf_counter() - t0
    n_tok = P13_MAMBA_REQ * P13_MAMBA_NEW
    _say13(f"13c {cfg.name}: {cfg.n_layers} SSM layers, d_model "
           f"{cfg.d_model}, {cfg.ssm.n_heads(cfg.d_model)} heads of "
           f"{cfg.ssm.head_dim}, state {cfg.ssm.d_state}, chunk "
           f"{cfg.ssm.chunk}, vocab {cfg.vocab_size}; {n / 1e9:.2f} B params"
           f" in {cfg.dtype}; (i) PlainEngine served {P13_MAMBA_REQ} x "
           f"({P13_MAMBA_PROMPT} + {P13_MAMBA_NEW}) tokens in {t_serve:.2f} s "
           f"({t_serve / n_tok:.4f} s per generated token, prefill "
           f"included), K1/K2 launches {launches}, tokens equal the direct "
           f"greedy loop's; (ii) prefill of {n_prompt} tokens {t_pre:.2f} s, "
           f"decode steps {[round(w, 4) for w in walls]} s, worst step's gap "
           f"{max(ratios):.4f} of the tolerance (must be <= 1), the zeroed "
           f"state's least {min(controls):.1f} (must be > 1); "
           f"max_memory_allocated {peak}; {seconds:.1f} s", card)
    del params, cache, zeroed, logits
    _release_any(on_card)
    if max(ratios) > 1.0:
        fail(f"mamba: a decode step missed the forward by {max(ratios):.4f} "
             f"of the tolerance {P13_TOL:g} * (1 + |oracle|)")
    if min(controls) <= 1.0:
        fail("mamba: a decode from a zeroed state is within the tolerance, "
             "so the check cannot see the state")
    return seconds


def phase_ssm_archs(device: str = "cuda", jamba=None, mamba=None,
                    long_prompt: int = P13_LONG_PROMPT):
    """Phase 13 (after 12, before 6; one model at a time, each released
    before the next is built): 13a ``phase_moe_kernels`` at Jamba's
    shapes (on the card), 13b ``phase_jamba``, 13c ``phase_mamba``.  The
    configs default to the full-width ones (Jamba's depth cut to
    ``P13_JAMBA_LAYERS``, mamba2 in f32); pass reduced ones to rehearse on
    the CPU.  Fails on the card past ``P13_BUDGET_S``.  Returns the
    seconds."""
    from repro_torch.configs.base import get_config

    on_card = device == "cuda"
    card = smi_name_power() if on_card else "none (CPU)"
    t0 = time.perf_counter()
    if jamba is None:
        jamba = dataclasses.replace(get_config(P13_JAMBA),
                                    n_layers=P13_JAMBA_LAYERS)
        _say13(f"reduced: {jamba.name} depth cut to {jamba.n_layers} of "
               f"{get_config(P13_JAMBA).n_layers} layers, one period of its "
               "pattern (widths as published); mamba2-2.7b whole, in f32",
               card)
    if on_card:
        phase_moe_kernels(jamba, card, "jamba", "13a", _say13)
        _release()
    t_b = phase_jamba(jamba, card, device)
    t_c = phase_mamba(mamba or dataclasses.replace(
        get_config(P13_MAMBA), dtype="float32"), card, device,
        n_prompt=long_prompt)
    seconds = time.perf_counter() - t0
    _say13(f"13b {t_b:.1f} s, 13c {t_c:.1f} s: phase 13 adds {seconds:.1f} s "
           f"to the run (host clock; budget {P13_BUDGET_S:.0f} s)", card)
    if on_card and seconds > P13_BUDGET_S:
        fail(f"phase 13 took {seconds:.1f} s, over its {P13_BUDGET_S:.0f} s "
             "budget")
    return seconds


# --------------------------------------------------------------------------
# Phase 14: prefix embeddings and the encoder-decoder.
P14_INTERNVL, P14_WHISPER = "internvl2-1b", "whisper-small"
P14_ENGINE, P14_ENGINE_LAYERS = "qwen15-moe-a2.7b", 4   # 14c, of 24
P14_PROMPT, P14_STEPS = 64, 8             # (i): prompt, decode steps held
P14_REQ, P14_NEW = 2, 16                  # (ii): PlainEngine requests
P14_TRAIN_STEPS, P14_TRAIN_BATCH, P14_TRAIN_TEXT, P14_TRAIN_LR = \
    10, 2, 64, 2e-3                       # (iii): text tokens after the cut
P14_ENGINE_PREFIX, P14_ENGINE_PROMPT, P14_ENGINE_NEW = 256, 128, 16
# (i): decode against the forward at 12c's tolerance, 1e-4 + 1e-4*|oracle|
# (f32, TF32 off; the decode step and the forward sum in another order).
P14_TOL = 1e-4
P14_BUDGET_S = 60.0


def _say14(msg: str, card: str) -> None:
    say(f"[phase14] {msg}; card {card}")


def _f32_model(cfg):
    """``cfg`` in f32 with TF32 off on the card (the decode checks)."""
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dataclasses.replace(cfg, dtype="float32")


def _held_decode(tag, cfg, params, seq, extras, cache, control, n_steps,
                 on_card):
    """``n_steps`` greedy decode steps from ``cache`` (its prefill's
    logits first), each held against ``unembed(forward(seq so far,
    **extras))`` at the last position within ``P14_TOL * (1 +
    |oracle|)``; the same tokens decoded from ``control`` (a cache that
    must not give the oracle) beside them.  Returns the gaps and the
    control's, each a fraction of the tolerance, the step walls and the
    cache after the last step."""
    from repro_torch.models.model import decode_step, forward, unembed

    logits, cache = cache
    ratios, controls, walls = [], [], []
    with torch.no_grad():
        for step in range(n_steps):
            token = torch.argmax(logits, dim=-1)
            seq = torch.cat([seq, token[:, None]], dim=1)
            t1 = time.perf_counter()
            logits, cache, _ = decode_step(params, cfg, token, cache)
            _sync_any(on_card)
            walls.append(time.perf_counter() - t1)
            ctl, control, _ = decode_step(params, cfg, token, control)
            h, _ = forward(params, cfg, seq, **extras)
            want = unembed(params, cfg, h[:, -1])
            tol = P14_TOL + P14_TOL * want.abs()
            ratios.append(float(((logits - want).abs() / tol).max()))
            controls.append(float(((ctl - want).abs() / tol).max()))
            if not bool(torch.isfinite(logits).all()):
                fail(f"{tag}: step {step}: non-finite logits")
            say(f"[{tag}] step {step} (position {int(cache['pos']) - 1}): "
                f"max|decode - forward| / ({P14_TOL:g} + {P14_TOL:g}*"
                f"|oracle|) = {ratios[-1]:.4f} (max abs gap "
                f"{float((logits - want).abs().max()):.3e}); control "
                f"{controls[-1]:.1f}")
    return ratios, controls, walls, cache


def _check_held(tag, ratios, controls, what_control):
    if max(ratios) > 1.0:
        fail(f"{tag}: a decode step missed the forward by {max(ratios):.4f} "
             f"of the tolerance {P14_TOL:g} + {P14_TOL:g}*|oracle|")
    if min(controls) <= 1.0:
        fail(f"{tag}: {what_control} is within the tolerance at some step, "
             "so the check cannot see it")


def _plain_generate(tag, cfg, params, extras_for, n_prompt, device):
    """(ii): ``PlainEngine.generate`` on ``P14_REQ`` prompts of
    ``n_prompt`` tokens with ``extras_for(i)``, ``P14_NEW`` tokens each,
    under the launch counts: no kernel, tokens equal a direct greedy
    loop's, every logit finite.  Returns the wall per generated token."""
    from repro_torch.serving.server import PlainEngine

    max_seq = cfg.prefix_len + n_prompt + P14_NEW + 1
    engine = PlainEngine(cfg, params, max_seq, device=device)
    rng = np.random.default_rng(141)
    prompts = [rng.integers(0, cfg.vocab_size, n_prompt).astype(np.int32)
               for _ in range(P14_REQ)]

    def run():
        t0 = time.perf_counter()
        out = [engine.generate(p, P14_NEW, **extras_for(i))[0]
               for i, p in enumerate(prompts)]
        _sync_any(device == "cuda")
        return out, time.perf_counter() - t0

    (outs, wall), launches = _counted(run)
    if any(launches.values()):
        fail(f"{tag}: kernels launched on the plain path: {launches}")
    for i, (toks, p) in enumerate(zip(outs, prompts)):
        toks = np.asarray(toks).tolist()
        if len(toks) != P14_NEW or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            fail(f"{tag}: request {i}: {toks} is not {P14_NEW} tokens of "
                 "the vocabulary")
        direct, finite = _greedy(cfg, params, p, P14_NEW, max_seq, device,
                                 **extras_for(i))
        if not finite:
            fail(f"{tag}: request {i}: non-finite logits")
        if direct != toks:
            fail(f"{tag}: request {i}: PlainEngine's tokens {toks} != the "
                 f"direct loop's {direct}")
    return wall / (P14_REQ * P14_NEW), launches


def _train_check(tag, cfg, seq_len, device):
    """(iii): ``train_loop`` for ``P14_TRAIN_STEPS`` steps at the
    config's dtype, with the stubs it draws itself.  Every loss finite,
    the last below the first.  Returns the losses, the median wall per
    step and the peak memory."""
    from repro_torch.launch.train import train_loop
    from repro_torch.optim.adamw import AdamWConfig

    on_card = device == "cuda"
    _peak_reset(on_card)
    opt_cfg = AdamWConfig(lr=P14_TRAIN_LR, total_steps=P14_TRAIN_STEPS,
                          warmup_steps=1)
    params, opt_state, hist = train_loop(
        cfg, steps=P14_TRAIN_STEPS, global_batch=P14_TRAIN_BATCH,
        seq_len=seq_len, opt_cfg=opt_cfg, log_every=P14_TRAIN_STEPS,
        seed=0, collect_history=True, device=device)
    _sync_any(on_card)
    losses = [m["loss"] for m in hist]
    per_step = np.diff([0.0] + [m["wall_s"] for m in hist])
    peak = _peak_gb(on_card)
    del params, opt_state
    if not all(np.isfinite(losses)):
        fail(f"{tag}: a non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{tag}: the last loss {losses[-1]:.4f} is not below the "
             f"first {losses[0]:.4f}")
    return losses, float(np.median(per_step)), peak


def phase_internvl(cfg, card: str, device: str = "cuda",
                   n_prompt: int = P14_PROMPT, n_steps: int = P14_STEPS):
    """14a: ``internvl2-1b`` whole (24 layers, prefix 256; random weights
    from seed 0).  (i) In f32: stub patch embeddings (``_stub_prefix``'s
    scale, 0.02) and a prompt of ``n_prompt`` tokens prefilled, then
    ``n_steps`` greedy decode steps, each within ``P14_TOL + P14_TOL *
    |oracle|`` of ``unembed(forward(prefix, prompt + tokens so far))``;
    the same tokens decoded from a prefill without the prefix outside it
    at every step.  (ii) In bf16: ``PlainEngine.generate`` on 2 requests
    of ``n_prompt`` + 16 tokens with their prefixes, no kernel launched.
    (iii) ``train_loop`` 10 steps in bf16, batch 2, ``seq_len`` the
    prefix + 64 text tokens.  Returns the seconds."""
    from repro_torch.launch.train import _stub_prefix
    from repro_torch.models.model import count_params, init_params, prefill

    on_card = device == "cuda"
    t0 = time.perf_counter()
    f32 = _f32_model(cfg)
    _peak_reset(on_card)
    params = init_params(f32, seed=0, device=device)
    n = count_params(params)
    prefix = _stub_prefix(f32, 1, 14, device)
    rng = np.random.default_rng(14)
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size, n_prompt),
                          dtype=torch.int64, device=device)[None]
    max_seq = cfg.prefix_len + n_prompt + P14_NEW
    with torch.no_grad():
        t_pre = time.perf_counter()
        logits, cache, _ = prefill(params, f32, seq, max_seq,
                                   prefix_embeds=prefix)
        _sync_any(on_card)
        t_pre = time.perf_counter() - t_pre
        if int(cache["pos"]) != cfg.prefix_len + n_prompt:
            fail(f"internvl: prefill position {int(cache['pos'])}, not "
                 f"{cfg.prefix_len} + {n_prompt}")
        _, control, _ = prefill(params, f32, seq, max_seq)
    ratios, controls, walls, _ = _held_decode(
        "prefix", f32, params, seq, {"prefix_embeds": prefix},
        (logits, cache), control, n_steps, on_card)
    peak_i = _peak_gb(on_card)
    del params, cache, control, logits
    _release_any(on_card)
    _check_held("internvl", ratios, controls,
                "the decode from a prefill without the prefix")

    params = init_params(cfg, seed=0, device=device)
    per_token, launches = _plain_generate(
        "internvl", cfg, params,
        lambda i: {"prefix_embeds": _stub_prefix(cfg, 1, 20 + i, device)},
        n_prompt, device)
    del params
    _release_any(on_card)
    losses, step_s, peak_t = _train_check(
        "internvl", cfg, cfg.prefix_len + P14_TRAIN_TEXT, device)
    _release_any(on_card)
    seconds = time.perf_counter() - t0
    _say14(f"14a {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
           f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
           f"{cfg.head_dim}, {cfg.mlp_type} {cfg.d_ff}, vocab "
           f"{cfg.vocab_size}, prefix {cfg.prefix_len}; {n / 1e9:.4f} B "
           f"params; (i) f32: prefill of {cfg.prefix_len} + {n_prompt} "
           f"{t_pre:.2f} s, decode steps {[round(w, 4) for w in walls]} s, "
           f"worst step's gap {max(ratios):.4f} of the tolerance (must be <= "
           f"1), without the prefix the least {min(controls):.1f} (must be > "
           f"1), max_memory_allocated {peak_i}; (ii) bf16 PlainEngine "
           f"{P14_REQ} x ({cfg.prefix_len} + {n_prompt} + {P14_NEW}) tokens, "
           f"{per_token:.4f} s per generated token (prefill included), "
           f"K1/K2 launches {launches}; (iii) train {P14_TRAIN_STEPS} steps "
           f"bf16, batch {P14_TRAIN_BATCH} x ({cfg.prefix_len} + "
           f"{P14_TRAIN_TEXT}), losses {[round(x, 4) for x in losses]}, "
           f"median step {step_s:.4f} s, max_memory_allocated {peak_t}; "
           f"{seconds:.1f} s", card)
    return seconds


def phase_whisper(cfg, card: str, device: str = "cuda",
                  n_prompt: int = P14_PROMPT, n_steps: int = P14_STEPS):
    """14b: ``whisper-small`` whole (12 encoder and 12 decoder layers,
    ``encoder_seq`` frames; random weights from seed 0).  (i) In f32:
    stub frames (``_stub_frames``' scale) and a prompt of ``n_prompt``
    tokens prefilled, then ``n_steps`` greedy decode steps, each within
    ``P14_TOL + P14_TOL * |oracle|`` of ``unembed(forward(..., frames))``;
    every step returns the cache's own ``ck`` / ``cv`` tensors, bit-equal
    to what the prefill stored; the same tokens decoded from a cache whose
    ``ck`` / ``cv`` hold the encoding of frames drawn from another seed
    outside the tolerance at every step.  (ii) ``PlainEngine.generate``
    with ``encoder_frames``, 2 requests of ``n_prompt`` + 16 tokens in
    bf16, no kernel launched.  (iii) ``train_loop`` 10 steps in bf16,
    batch 2, ``seq_len`` 64.  Returns the seconds."""
    from repro_torch.launch.train import _stub_frames
    from repro_torch.models.model import count_params, init_params, prefill

    on_card = device == "cuda"
    t0 = time.perf_counter()
    f32 = _f32_model(cfg)
    _peak_reset(on_card)
    params = init_params(f32, seed=0, device=device)
    n = count_params(params)
    n_enc = sum(t.numel() for t in _leaves(params["encoder"]))
    frames = _stub_frames(f32, 1, 14, device)
    rng = np.random.default_rng(15)
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size, n_prompt),
                          dtype=torch.int64, device=device)[None]
    max_seq = n_prompt + P14_NEW
    with torch.no_grad():
        t_pre = time.perf_counter()
        logits, cache, _ = prefill(params, f32, seq, max_seq,
                                   encoder_frames=frames)
        _sync_any(on_card)
        t_pre = time.perf_counter() - t_pre
        _, other, _ = prefill(params, f32, seq, max_seq,
                              encoder_frames=_stub_frames(f32, 1, 15, device))
    attn = [k for k in cache if k != "pos"]
    cross = {(k, c): cache[k][c] for k in attn for c in ("ck", "cv")}
    stored = {key: t.clone() for key, t in cross.items()}
    control = {"pos": cache["pos"].clone()}
    for k in attn:
        control[k] = {"k": cache[k]["k"].clone(), "v": cache[k]["v"].clone(),
                      "ck": other[k]["ck"], "cv": other[k]["cv"]}
    del other
    ratios, controls, walls, after = _held_decode(
        "encdec", f32, params, seq, {"encoder_frames": frames},
        (logits, cache), control, n_steps, on_card)
    same = all(after[k][c] is cross[(k, c)] for k, c in cross)
    equal = all(torch.equal(cross[key], stored[key]) for key in cross)
    peak_i = _peak_gb(on_card)
    del params, cache, control, after, cross, stored, logits
    _release_any(on_card)
    if not (same and equal):
        fail(f"whisper: decode replaced ck/cv ({not same}) or changed them "
             f"({not equal})")
    _check_held("whisper", ratios, controls,
                "the decode from another seed's cross K/V")

    params = init_params(cfg, seed=0, device=device)
    per_token, launches = _plain_generate(
        "whisper", cfg, params,
        lambda i: {"encoder_frames": _stub_frames(cfg, 1, 20 + i, device)},
        n_prompt, device)
    del params
    _release_any(on_card)
    losses, step_s, peak_t = _train_check("whisper", cfg, P14_TRAIN_TEXT,
                                          device)
    _release_any(on_card)
    seconds = time.perf_counter() - t0
    _say14(f"14b {cfg.name}: {cfg.encoder_layers} encoder + {cfg.n_layers} "
           f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
           f"{cfg.head_dim}, {cfg.mlp_type} {cfg.d_ff}, vocab "
           f"{cfg.vocab_size}, {cfg.encoder_seq} frames; {n / 1e9:.4f} B "
           f"params ({n_enc / 1e9:.4f} B in the encoder); (i) f32: prefill "
           f"of {cfg.encoder_seq} frames + {n_prompt} tokens {t_pre:.2f} s, "
           f"decode steps {[round(w, 4) for w in walls]} s, worst step's gap "
           f"{max(ratios):.4f} of the tolerance (must be <= 1), from another "
           f"seed's cross K/V the least {min(controls):.1f} (must be > 1), "
           f"ck/cv the same tensors and bit-equal after decode, "
           f"max_memory_allocated {peak_i}; (ii) bf16 PlainEngine {P14_REQ} "
           f"x ({n_prompt} + {P14_NEW}) tokens, {per_token:.4f} s per "
           f"generated token (prefill and encoder included), K1/K2 launches "
           f"{launches}; (iii) train {P14_TRAIN_STEPS} steps bf16, batch "
           f"{P14_TRAIN_BATCH} x {P14_TRAIN_TEXT}, losses "
           f"{[round(x, 4) for x in losses]}, median step {step_s:.4f} s, "
           f"max_memory_allocated {peak_t}; {seconds:.1f} s", card)
    return seconds


def phase_prefixed_engine(cfg, card: str, device: str = "cuda",
                          n_prompt: int = P14_ENGINE_PROMPT,
                          n_new: int = P14_ENGINE_NEW):
    """14c: K1/K2 behind a prefixed prefill through the engine.  ``cfg``
    (a test configuration, not a published model) runs in a
    ``SliceMoEEngine`` with phase 5's settings (MAT84, Cache-Prior + DBSC
    with quantized execution, PCW, miss target 0.05, a quarter of the
    store cached): one request of ``cfg.prefix_len`` stub prefix
    embeddings and ``n_prompt`` tokens through ``prefill(tokens,
    prefix_embeds=...)``, then ``decode(first, n_new)``, with the launch
    counts set to 0 just before and read just after.  Hard checks: K1
    and K2 each (MoE layers) x (1 + ``n_new``) times, the cache position
    after prefill ``prefix_len + n_prompt``, every logit finite.  Returns
    the seconds."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import SliceMoEEngine
    from repro_torch.launch.train import _stub_prefix
    from repro_torch.models.model import init_params

    on_card = device == "cuda"
    t0 = time.perf_counter()
    est = _device_bytes(cfg)
    n_moe = _n_moe_layers(cfg)
    store_bytes = _store_bytes(cfg, MatConfig(8, 4))
    _peak_reset(on_card)
    params = init_params(cfg, seed=0, device=device)
    max_seq = cfg.prefix_len + n_prompt + n_new + 1
    engine = SliceMoEEngine(cfg, params, _phase7_engine_config(
        {"cache_bytes": store_bytes / 4}, max_seq=max_seq), device=device)
    del params
    _sync_any(on_card)
    t_build = time.perf_counter() - t0
    rng = np.random.default_rng(16)
    tokens = rng.integers(0, cfg.vocab_size, (1, n_prompt)).astype(np.int32)
    prefix = _stub_prefix(cfg, 1, 16, device)

    def run():
        t1 = time.perf_counter()
        logits = engine.prefill(tokens, prefix_embeds=prefix)
        pos = int(engine.kv_cache["pos"])
        finite = bool(torch.isfinite(logits).all())
        t_pre = time.perf_counter() - t1
        t1 = time.perf_counter()
        out, metrics = engine.decode(torch.argmax(logits, dim=-1), n_new)
        _sync_any(on_card)
        return pos, finite, out, metrics, t_pre, time.perf_counter() - t1

    (pos, finite, out, metrics, t_pre, t_dec), launches = _counted(run)
    want = n_moe * (1 + n_new)
    cs = metrics["cache_stats"]
    peak = _peak_gb(on_card)
    seconds = time.perf_counter() - t0
    _say14(f"14c {cfg.name} with prefix_len={cfg.prefix_len}: "
           f"{cfg.n_layers} layers, {est['params'] / 1e9:.3f} B params "
           f"({est['float_bytes'] / 1e9:.2f} GB bf16) and "
           f"{est['amat_bytes'] / 1e9:.2f} GB of AMAT codes, scales, "
           f"zero-points and output-major wo codes (from the shapes); "
           f"1 request of {cfg.prefix_len} + {n_prompt} tokens, then "
           f"{n_new} decoded: cache position {pos} after prefill, K1/K2 "
           f"launches {launches} (want {n_moe} x {1 + n_new} = {want} each), "
           f"every logit finite {finite and metrics['logits_finite']}, "
           f"decode MSB misses {cs['msb_misses']} of "
           f"{cs['msb_hits'] + cs['msb_misses']}; engine built in "
           f"{t_build:.2f} s, prefill {t_pre:.2f} s, decode {t_dec:.2f} s "
           f"({t_dec / n_new:.4f} s a token); max_memory_allocated {peak} "
           f"(shapes: {(est['float_bytes'] + est['amat_bytes']) / 1e9:.2f} "
           f"GB); {seconds:.1f} s", card)
    del engine
    _release_any(on_card)
    if pos != cfg.prefix_len + n_prompt:
        fail(f"engine: cache position {pos} after prefill, not "
             f"{cfg.prefix_len} + {n_prompt}")
    if on_card and (launches.get("k_major") != want
                    or launches.get("output_major") != want
                    or sum(launches.values()) != 2 * want):
        fail(f"engine: K1/K2 launches {launches}, not {want} each")
    if not (finite and metrics["logits_finite"]):
        fail("engine: non-finite logits")
    if out.shape != (1, n_new):
        fail(f"engine: decoded {tuple(out.shape)}, not (1, {n_new})")
    return seconds


def phase_prefix_encdec(device: str = "cuda", internvl=None, whisper=None,
                        engine=None, n_prompt: int = P14_PROMPT,
                        engine_prompt: int = P14_ENGINE_PROMPT):
    """Phase 14 (after 13, before 6; one model at a time, each released
    before the next is built): 14a ``phase_internvl``, 14b
    ``phase_whisper``, 14c ``phase_prefixed_engine``.  The configs
    default to the full-width ones (the engine's ``qwen15-moe-a2.7b`` cut
    to ``P14_ENGINE_LAYERS`` layers with ``prefix_len`` set); pass
    reduced ones to rehearse on the CPU.  Fails on the card past
    ``P14_BUDGET_S``.  Returns the seconds."""
    from repro_torch.configs.base import get_config

    on_card = device == "cuda"
    card = smi_name_power() if on_card else "none (CPU)"
    t0 = time.perf_counter()
    if engine is None:
        full = get_config(P14_ENGINE)
        engine = dataclasses.replace(full, n_layers=P14_ENGINE_LAYERS,
                                     prefix_len=P14_ENGINE_PREFIX)
        _say14(f"reduced: internvl2-1b and whisper-small whole; 14c is a "
               f"test configuration built on the reference's pass-through, "
               f"not a published model: {full.name} at its published widths "
               f"with its depth cut to {engine.n_layers} of {full.n_layers} "
               f"layers and prefix_len={engine.prefix_len} set by "
               f"dataclasses.replace", card)
    t_a = phase_internvl(internvl or get_config(P14_INTERNVL), card, device,
                         n_prompt=n_prompt)
    t_b = phase_whisper(whisper or get_config(P14_WHISPER), card, device,
                        n_prompt=n_prompt)
    t_c = phase_prefixed_engine(engine, card, device, n_prompt=engine_prompt)
    seconds = time.perf_counter() - t0
    _say14(f"14a {t_a:.1f} s, 14b {t_b:.1f} s, 14c {t_c:.1f} s: phase 14 "
           f"adds {seconds:.1f} s to the run (host clock; budget "
           f"{P14_BUDGET_S:.0f} s)", card)
    if on_card and seconds > P14_BUDGET_S:
        fail(f"phase 14 took {seconds:.1f} s, over its {P14_BUDGET_S:.0f} s "
             "budget")
    return seconds


# --------------------------------------------------------------------------
# Phase 15: the serving variants, quantized_serve and the ring KV cache.
P15_REL = 0.05                   # tests/test_perf_variants.py:66-67
P15_RING = "starcoder2-3b"
P15_RING_PROMPT, P15_RING_STEPS = 4000, 160   # positions 4000-4159
P15_TOL = 1e-4
P15_INIT_PEAK_GB = 20.0          # 15c; the float tree alone is 28.6 GB
P15_BUDGET_S = 60.0


def _say15(msg: str, card: str) -> None:
    say(f"[phase15] {msg}; card {card}")


def _flat_leaves(params):
    """The flat AMAT expert leaves of a ``quantized_serve`` tree by
    (position, name)."""
    for pos, blk in sorted(params["blocks"].items()):
        if "moe" in blk:
            for name, t in sorted(blk["moe"]["experts"].items()):
                yield (pos, name), t


def _checksums(params) -> dict:
    """One checksum per flat leaf: the sum of the codes or zero-points as
    int64, of the scales in f64, taken 8 matrices at a time (a sum in a
    wider type casts its input whole: 62 GB for one stack of codes)."""
    def leaf_sum(t):
        wide = torch.float64 if t.is_floating_point() else torch.int64
        parts = [c.sum(dtype=wide)
                 for c in torch.split(t.flatten(0, -3), 8)]
        total = torch.stack(parts).sum()
        return float(total) if t.is_floating_point() else int(total)

    return {key: leaf_sum(t) for key, t in _flat_leaves(params)}


def _tree_gb(leaves) -> float:
    return sum(t.numel() * t.element_size() for t in leaves) / 1e9


def phase_k1_flat_wo(cfg, card: str) -> dict:
    """15a': K1 on K-major ``wo`` codes, the route of the flat
    ``quantized_serve`` tree, which holds no output-major copy: ``cfg``'s
    ``wo`` at its decode capacity (Qwen: E=60, M=8, K=1408, N=2048), bf16
    and f32 x, against the plain version at the kernel tolerance, timed
    beside the plain version, ``torch.bmm`` on dense f32 weights (TF32
    off) and the bound; then bf16 x at the prefill capacity of 4 x 128
    tokens (checked, not timed).  A new row of K1, not a new kernel."""
    from repro_torch.models.moe import capacity

    torch.backends.cuda.matmul.allow_tf32 = False
    m = cfg.moe
    rows = ((SERVE_REQ, torch.bfloat16), (SERVE_REQ, torch.float32),
            (SERVE_REQ * SERVE_PROMPT, torch.bfloat16))
    out = {}
    for seed, (n_tok, x_dtype) in enumerate(rows):
        M = capacity(n_tok, m.top_k, m.n_experts, m.capacity_factor)
        xd = "bf16" if x_dtype == torch.bfloat16 else "f32"
        name = f"flat_wo_k_major_{xd}_{n_tok}tok"
        out[name] = _expert_kernel_row(
            name, (m.n_experts, M, m.d_ff, cfg.d_model), seed=150 + seed,
            transposed=False, x_dtype=x_dtype, timed=n_tok == SERVE_REQ,
            say_fn=lambda msg: _say15(f"15a' {msg}", card))
    return out


def _clone_cache(cache) -> dict:
    return {k: v.clone() if torch.is_tensor(v)
            else {n: t.clone() for n, t in v.items()}
            for k, v in cache.items()}


def _float_route(params, cfg, toks, max_seq, on_card):
    """``prefill`` of ``toks`` and ``SERVE_NEW`` greedy ``decode_step``s.
    Returns the logits of every call (the prefill's first), their walls,
    the tokens fed, a copy of the prefill's cache and each step's routing
    as ``decode_step``'s ``gate_override``."""
    from repro_torch.models.model import decode_step, prefill

    moe_pos = [f"pos{i}" for i, s in enumerate(cfg.block_pattern)
               if s.ffn == "moe"]
    t1 = time.perf_counter()
    logits, cache, _ = prefill(params, cfg, toks, max_seq)
    _sync_any(on_card)
    walls, logits_all = [time.perf_counter() - t1], [logits]
    cache0 = _clone_cache(cache)
    tokens, routing = [], []
    for _ in range(SERVE_NEW):
        token = torch.argmax(logits, dim=-1)
        tokens.append(token)
        t1 = time.perf_counter()
        logits, cache, aux = decode_step(params, cfg, token, cache,
                                         collect_trace=True)
        _sync_any(on_card)
        walls.append(time.perf_counter() - t1)
        logits_all.append(logits)
        m = aux["moe"]
        routing.append({key: (m["gates"][:, j], m["ids"][:, j])
                        for j, key in enumerate(moe_pos)})
    return logits_all, walls, tokens, cache0, routing


def _forced_route(params, cfg, toks, forced, max_seq, on_card, *,
                  cache=None, routing=None, **kw):
    """One ``decode_step`` per token of ``forced`` after ``prefill`` of
    ``toks``, or, given ``cache``, from a copy of it with no prefill; with
    ``routing``, each step takes its ``gate_override``.  Returns the logits
    of every call and their walls."""
    from repro_torch.models.model import decode_step, prefill

    logits_all, walls = [], []
    if cache is None:
        t1 = time.perf_counter()
        logits, cache, _ = prefill(params, cfg, toks, max_seq, **kw)
        _sync_any(on_card)
        walls.append(time.perf_counter() - t1)
        logits_all.append(logits)
    else:
        cache = _clone_cache(cache)
    for step, token in enumerate(forced):
        t1 = time.perf_counter()
        logits, cache, _ = decode_step(
            params, cfg, token, cache,
            gate_override=routing[step] if routing else None, **kw)
        _sync_any(on_card)
        walls.append(time.perf_counter() - t1)
        logits_all.append(logits)
    return logits_all, walls


def _rel_l2(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase_qserve(cfg, params, prompts, card: str, device: str = "cuda"):
    """15a: ``quantized_serve`` over phase 5's params (bf16, full depth and
    width; no new model): ``quantize_params_for_serve`` at MAT84, then
    phase 5's prompts on three routes, the float params, the flat tree
    dense-dequant and the flat tree with ``quant_execution=True``, each
    route's caches released before the next.  The float route runs
    ``prefill`` and ``SERVE_NEW`` greedy batched ``decode_step``s.  Each
    quantized route runs twice, fed the float route's tokens (teacher
    forcing): (i) ``prefill`` and the steps from scratch; (ii) the steps
    from the float route's prefill cache with the float route's routing
    (``gate_override``), so that what differs is the experts' weights
    and the expert matmul's route, not the experts chosen.

    At full width a random bf16 model amplifies any perturbation: on the
    card (i)'s logits sat 0.04-0.15 (relative L2) from the float route's,
    and as far from each other though both quantized routes read the same
    codes.  So (i) is printed with that floor beside it, and the bound of
    ``tests/test_perf_variants.py:66-67``, relative L2 below
    ``P15_REL``, is held on (ii) at every step.  Hard checks besides:
    every logit finite; K1 2 x (MoE layers) per forward on the quantized
    route (``wi`` and ``wo`` on K-major codes) and never on the others, K2
    never.  Returns the seconds, K1's launches and one checksum per flat
    leaf for 15c."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.models.moe import quantize_params_for_serve

    on_card = device == "cuda"
    t0 = time.perf_counter()
    _peak_reset(on_card)
    qcfg = dataclasses.replace(cfg, quantized_serve=True)
    mat = MatConfig(8, 4)
    t1 = time.perf_counter()
    qparams = quantize_params_for_serve(params, qcfg, mat)
    _sync_any(on_card)
    t_quant = time.perf_counter() - t1
    sums = _checksums(qparams)
    flat_gb = _tree_gb(t for _, t in _flat_leaves(qparams))
    toks = torch.as_tensor(np.stack(prompts), dtype=torch.int64,
                           device=device)
    max_seq = toks.shape[1] + SERVE_NEW
    with torch.no_grad():
        (ref, w_float, forced, cache0, routing), l_float = _counted(
            lambda: _float_route(params, cfg, toks, max_seq, on_card))
        _release_any(on_card)
        routes = {}
        for route, qexec in (("dense", False), ("quant", True)):
            kw = dict(mat=mat, quant_execution=qexec)
            (free, w_free), l_free = _counted(lambda: _forced_route(
                qparams, qcfg, toks, forced, max_seq, on_card, **kw))
            _release_any(on_card)
            (pinned, w_pin), l_pin = _counted(lambda: _forced_route(
                qparams, qcfg, toks, forced, max_seq, on_card,
                cache=cache0, routing=routing, **kw))
            _release_any(on_card)
            routes[route] = dict(
                free=free, w_free=w_free, pinned=pinned, w_pin=w_pin,
                launches=(l_free, l_pin),
                rel_free=[_rel_l2(a, b) for a, b in zip(free, ref)],
                rel=[_rel_l2(a, b) for a, b in zip(pinned, ref[1:])],
                finite=all(bool(torch.isfinite(a).all())
                           for a in free + pinned))
        dr, qr = routes["dense"], routes["quant"]
        floor = [_rel_l2(a, b) for a, b in zip(qr["free"], dr["free"])]
        gap = [_rel_l2(a, b) for a, b in zip(qr["pinned"], dr["pinned"])]
    float_finite = all(bool(torch.isfinite(a).all()) for a in ref)
    n_steps, n_moe = len(forced), _n_moe_layers(cfg)
    want = {"quant": (2 * n_moe * (n_steps + 1), 2 * n_moe * n_steps),
            "dense": (0, 0)}
    peak = _peak_gb(on_card)
    seconds = time.perf_counter() - t0

    def r5(xs):
        return [round(x, 5) for x in xs]

    _say15(f"15a {cfg.name} through quantize_params_for_serve at MAT84: "
           f"{len(sums)} flat leaves, {flat_gb:.2f} GB of codes, scales and "
           f"zero-points beside the {_tree_gb(_leaves(params)):.2f} GB float "
           f"tree, in {t_quant:.2f} s; {len(prompts)} prompts of "
           f"{toks.shape[1]} tokens, prefill then {n_steps} decode steps",
           card)
    _say15(f"15a float route: walls {[round(w, 4) for w in w_float]} s, "
           f"launches {l_float}, every logit finite {float_finite}", card)
    for route in ("dense", "quant"):
        r = routes[route]
        _say15(f"15a {route} route (i) from its own prefill: relative L2 to "
               f"the float route's logits {r5(r['rel_free'])}; walls "
               f"{[round(w, 4) for w in r['w_free']]} s; (ii) from the float "
               f"route's cache and routing: {r5(r['rel'])} (must be < "
               f"{P15_REL}); walls {[round(w, 4) for w in r['w_pin']]} s; "
               f"launches {r['launches']} (want K1 {want[route]}, K2 0); "
               f"every logit finite {r['finite']}", card)
    _say15(f"15a quant vs dense: (i) relative L2 {r5(floor)} (the floor "
           f"that any perturbation reaches here), (ii) {r5(gap)}; "
           f"max_memory_allocated {peak}; {seconds:.1f} s", card)
    results = {r: (routes[r]["rel"], routes[r]["finite"],
                   routes[r]["launches"]) for r in routes}
    del qparams, routes, dr, qr, ref, cache0, routing, toks
    _release_any(on_card)
    if not float_finite:
        fail("qserve: the float route gave non-finite logits")
    if on_card and sum(l_float.values()) != 0:
        fail(f"qserve: the float route launched {l_float}")
    for route, (rel, finite, launches) in results.items():
        if not finite:
            fail(f"qserve: the {route} route gave non-finite logits")
        if max(rel) >= P15_REL:
            fail(f"qserve: the {route} route with the float route's routing "
                 f"is {max(rel):.4f} from its logits (relative L2), not "
                 f"below {P15_REL}")
        got = tuple((n.get("k_major", 0), sum(n.values())) for n in launches)
        if on_card and got != tuple((w, w) for w in want[route]):
            fail(f"qserve: the {route} route launched {launches}, not K1 "
                 f"{want[route]} times and nothing else")
    return seconds, sum(want["quant"]), sums


def phase_ring(cfg, card: str, device: str = "cuda",
               n_prompt: int = P15_RING_PROMPT,
               n_steps: int = P15_RING_STEPS):
    """15b: ``cfg`` (``starcoder2-3b`` whole, f32, window 4096; TF32 off)
    with ``ring_kv=True`` and a cache of ``sliding_window`` rows: one
    prompt of ``n_prompt`` tokens through ``prefill``, then ``n_steps``
    ``decode_step(use_window=True)`` steps, whose positions run past the
    cache's end and wrap.  Four steps, the last before the wrap, the first
    after it and the last two, are held against ``unembed(forward(...,
    use_window=True))`` at the last position within ``1e-4 +
    1e-4*|oracle|``; the unwindowed forward must miss the last step by
    more.  Hard checks besides: the cache keeps its rows, the rows the
    wrap overwrote all changed and the others below the prompt's end kept
    their prefill values.  Returns the seconds."""
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          prefill, unembed)

    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(cfg, ring_kv=True)
    S = cfg.sliding_window
    wrap = S - n_prompt                    # the step at position S
    n_over = n_prompt + n_steps - S        # rows the wrap overwrites
    held = sorted({wrap - 1, wrap, n_steps - 2, n_steps - 1})
    t0 = time.perf_counter()
    _peak_reset(on_card)
    params = init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(15)
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size, n_prompt),
                          dtype=torch.int64, device=device)[None]
    ratios, walls = {}, []
    with torch.no_grad():
        def oracle(window: bool):
            h, _ = forward(params, cfg, seq, use_window=window)
            return unembed(params, cfg, h[:, -1])

        t1 = time.perf_counter()
        logits, cache, _ = prefill(params, cfg, seq, S)
        _sync_any(on_card)
        t_pre = time.perf_counter() - t1
        k0 = cache["pos0"]["k"].clone()
        for step in range(n_steps):
            token = torch.argmax(logits, dim=-1)
            seq = torch.cat([seq, token[:, None]], dim=1)
            t1 = time.perf_counter()
            logits, cache, _ = decode_step(params, cfg, token, cache,
                                           use_window=True)
            _sync_any(on_card)
            walls.append(time.perf_counter() - t1)
            if step in held:
                want = oracle(True)
                tol = P15_TOL + P15_TOL * want.abs()
                ratios[step] = float(((logits - want).abs() / tol).max())
                say(f"[ring] step {step} (position {n_prompt + step}, row "
                    f"{(n_prompt + step) % S}): max|decode - windowed "
                    f"forward| / (1e-4 + 1e-4*|oracle|) = "
                    f"{ratios[step]:.4f}, max abs gap "
                    f"{float((logits - want).abs().max()):.3e}")
        apart = float(((oracle(False) - want).abs() / tol).max())
        k1 = cache["pos0"]["k"]
        rows = (k1 != k0).flatten(3).any(-1).any(0)[0]       # [S]
        rows_kept = bool(not rows[n_over:n_prompt].any())
        rows_over = int(rows[:n_over].sum())
        s_after = k1.shape[2]
    kv_ring = _tree_gb(t for k, e in cache.items() if k != "pos"
                       for t in e.values())
    kv_full = kv_ring * (n_prompt + n_steps) / S     # bytes go by rows
    peak = _peak_gb(on_card)
    seconds = time.perf_counter() - t0
    _say15(f"15b {cfg.name} with ring_kv: {cfg.n_layers} layers, d_model "
           f"{cfg.d_model}, window {S}, {cfg.dtype}; prefill of {n_prompt} "
           f"tokens into {S} rows {t_pre:.2f} s, {n_steps} decode steps "
           f"(positions {n_prompt}-{n_prompt + n_steps - 1}, {n_over} rows "
           f"overwritten) median {float(np.median(walls)):.4f} s; steps "
           f"{held} at {[round(ratios[s], 4) for s in held]} of the "
           f"tolerance (must be <= 1), the unwindowed forward "
           f"{apart:.1f} of it at the last step (must be > 1); cache rows "
           f"{s_after}, {rows_over} of the first {n_over} changed, the rest "
           f"below {n_prompt} kept {rows_kept}; KV {kv_ring:.3f} GB against "
           f"{kv_full:.3f} GB for a {n_prompt + n_steps}-row cache without "
           f"ring; max_memory_allocated {peak}; {seconds:.1f} s", card)
    del params, cache, logits, k0, k1
    _release_any(on_card)
    if max(ratios.values()) > 1.0:
        fail(f"ring: a decode step missed the windowed forward by "
             f"{max(ratios.values()):.4f} of the tolerance")
    if apart <= 1.0:
        fail("ring: the unwindowed forward is within the tolerance of the "
             "windowed one, so the check cannot see the window")
    if s_after != S or rows_over != n_over or not rows_kept:
        fail(f"ring: the cache has {s_after} rows, {rows_over} of the "
             f"first {n_over} changed, the others kept {rows_kept}")
    return seconds


def phase_qserve_init(cfg, sums, card: str, device: str = "cuda"):
    """15c: ``init_params`` of ``cfg`` with ``quantized_serve`` from
    scratch (seed 0, phase 5's), with no model resident: each period of
    ``wi`` and ``wo`` is quantized as it is drawn, so the init's own peak
    (the peak less what was allocated before it: earlier phases leave a
    few hundred MB on the card) stays at most ``P15_INIT_PEAK_GB`` (the
    float tree alone is 28.6 GB), and every flat leaf's checksum must
    equal 15a's (``sums``), quantized from the float init.  Returns the
    seconds."""
    from repro_torch.models.model import init_params

    on_card = device == "cuda"
    t0 = time.perf_counter()
    _peak_reset(on_card)
    before = torch.cuda.memory_allocated() / 1e9 if on_card else 0.0
    qparams = init_params(dataclasses.replace(cfg, quantized_serve=True),
                          seed=0, device=device)
    _sync_any(on_card)
    t_init = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() / 1e9 - before) if on_card \
        else None
    peak_say = _peak_gb(on_card)
    got = _checksums(qparams)
    size = _tree_gb(_leaves(qparams))
    same = [k for k in sums if got.get(k) == sums[k]]
    seconds = time.perf_counter() - t0
    _say15(f"15c init_params({cfg.name}, quantized_serve=True, seed=0): "
           f"{size:.2f} GB tree in {t_init:.2f} s; max_memory_allocated "
           f"{peak_say} with {before:.2f} GB allocated before the init, "
           f"whose own peak is "
           f"{'not measured (CPU)' if peak is None else f'{peak:.2f} GB'} "
           f"(must be <= {P15_INIT_PEAK_GB:.0f} GB); {len(same)} of "
           f"{len(sums)} flat leaves' checksums equal 15a's; {seconds:.1f} "
           f"s", card)
    del qparams
    _release_any(on_card)
    if set(got) != set(sums) or len(same) != len(sums):
        fail(f"qserve init: checksums differ from 15a's: "
             f"{sorted(set(sums) - set(same))}")
    if peak is not None and peak > P15_INIT_PEAK_GB:
        fail(f"qserve init: peak {peak:.2f} GB over {P15_INIT_PEAK_GB} GB")
    return seconds


def phase_serving_variants_a(cfg, params, prompts, device: str = "cuda"):
    """Phase 15's first half (after 8a, over phase 5's params, so it
    builds no model): 15a' ``phase_k1_flat_wo`` on the card, then 15a
    ``phase_qserve``.  Returns the seconds, K1's launches in 15a and the
    flat leaves' checksums."""
    on_card = device == "cuda"
    card = smi_name_power() if on_card else "none (CPU)"
    t0 = time.perf_counter()
    if on_card:
        phase_k1_flat_wo(cfg, card)
        _release()
    _, k1, sums = phase_qserve(cfg, params, prompts, card, device)
    return time.perf_counter() - t0, k1, sums


def phase_serving_variants_b(cfg, sums, t_a: float, device: str = "cuda",
                             ring=None, ring_prompt: int = P15_RING_PROMPT,
                             ring_steps: int = P15_RING_STEPS):
    """Phase 15's second half (after 14, with no other model resident):
    15b ``phase_ring`` (``ring`` defaults to ``starcoder2-3b`` whole in
    f32), 15c ``phase_qserve_init`` of ``cfg``.  Fails on the card when
    the phase, ``t_a`` seconds of its first half included, passes
    ``P15_BUDGET_S``.  Returns the seconds of both halves."""
    from repro_torch.configs.base import get_config

    on_card = device == "cuda"
    card = smi_name_power() if on_card else "none (CPU)"
    t_b = phase_ring(ring or dataclasses.replace(get_config(P15_RING),
                                                 dtype="float32"),
                     card, device, n_prompt=ring_prompt, n_steps=ring_steps)
    t_c = phase_qserve_init(cfg, sums, card, device)
    seconds = t_a + t_b + t_c
    _say15(f"15a'+15a {t_a:.1f} s, 15b {t_b:.1f} s, 15c {t_c:.1f} s: phase "
           f"15 adds {seconds:.1f} s to the run (host clock; budget "
           f"{P15_BUDGET_S:.0f} s)", card)
    if on_card and seconds > P15_BUDGET_S:
        fail(f"phase 15 took {seconds:.1f} s, over its {P15_BUDGET_S:.0f} s "
             "budget")
    return seconds


# --------------------------------------------------------------------------
# Phase 16: the launch layer and the dry-run.
# 16a's pairs: every shape of the smallest and the largest arch.  The 40
# single-mesh pairs take 66.8 s of host time on the meta device on the
# H100 machine's CPU, over three times 16a's share of the phase's budget.
P16_DRY_ARCHS = ("smollm-360m", "llama4-maverick-400b-a17b")
# 16b: (arch, shape, global batch) at full width and depth, only the
# batch cut, to the largest power of two whose peak stays under
# P16_PEAK_GB (train_4k at B=1 peaks at 49.2 GB on an H100 and B=2 runs
# out of its 80 GB: 15 heads x 4096^2 f32 scores kept for backward in
# each of 32 layers).
P16_PAIRS = (("smollm-360m", "train_4k", 1),
             ("starcoder2-3b", "prefill_32k", 1),
             ("gemma-7b", "decode_32k", 2),
             ("mamba2-2.7b", "long_500k", 1))
P16_PEAK_GB = 70.0
P16_TIMED = 3                    # after one warm-up call
# A pair whose first call takes longer is timed by that call alone:
# starcoder2-3b's 32k prefill read 23.02, 23.00, 23.00 and 23.00 s in
# four calls on an H100, so a warm-up changes nothing there, and four
# calls would take the whole budget.
P16_LONG_CALL_S = 5.0
P16_BUDGET_S = 60.0


def _say16(msg: str, card: str) -> None:
    say(f"[phase16] {msg}; card {card}")


def _tensors(tree):
    """The tensor leaves of a tree of dicts and tuples (named tuples
    included)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _finite(t: torch.Tensor) -> bool:
    """Every element finite; a large tensor is checked one slice of its
    first dimension at a time (a whole KV stack's flags would take as
    many bytes as its elements)."""
    if not t.is_floating_point():
        return True
    if t.numel() <= 1 << 28:
        return bool(torch.isfinite(t).all())
    return all(_finite(c) for c in t)


def phase_dryrun(card: str, archs=P16_DRY_ARCHS) -> float:
    """16a: ``launch.dryrun.run_pair`` in this process over every shape of
    ``archs`` on the single-pod mesh, the step of each pair run on the
    ``meta`` device.  Fails on any ``error``.  Returns the seconds."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.dryrun import run_pair

    t0 = time.perf_counter()
    counts = {"ok": 0, "skipped": 0, "error": 0}
    for arch in archs:
        for shape in SHAPES:
            rec = run_pair(arch, shape, "single", save=False)
            counts[rec["status"]] += 1
            if rec["status"] == "ok":
                rl = rec["roofline"]
                say(f"[dryrun] {arch} {shape}: ok, args "
                    f"{rec['memory']['argument_size_in_bytes'] / 1e9:.3f} GB "
                    f"a device of {rec['n_chips']}, compute "
                    f"{rl['compute_s']:.3e} s, memory {rl['memory_s']:.3e} s "
                    f"({rl['dominant']}), meta run {rec['compile_s']} s")
            elif rec["status"] == "skipped":
                say(f"[dryrun] {arch} {shape}: skipped ({rec['reason']})")
            else:
                say(f"[dryrun] {arch} {shape}: ERROR {rec['error']}")
    seconds = time.perf_counter() - t0
    _say16(f"16a dry-run of {', '.join(archs)} x {len(SHAPES)} shapes on "
           f"the single-pod mesh: ok {counts['ok']}, skipped "
           f"{counts['skipped']}, error {counts['error']} in {seconds:.1f} s",
           card)
    if counts["error"]:
        fail(f"16a: {counts['error']} dry-run pairs failed")
    return seconds


def _launch_pair(cfg, shape, card: str, device: str) -> None:
    """One 16b pair: the step of ``shape`` on inputs made on ``device``
    from ``input_specs`` on the host mesh, one warm-up call and
    ``P16_TIMED`` timed ones, each ending in a synchronize."""
    from repro_torch.hw.specs import H100
    from repro_torch.launch.costs import analytic_costs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import (argument_size_in_bytes,
                                          input_specs, materialize)
    from repro_torch.launch.steps import shape_supported, step_for_shape

    on_card = device == "cuda"
    tag = f"{cfg.name} x {shape.name} (B={shape.global_batch})"
    supported, reason = shape_supported(cfg, shape)
    if not supported:
        fail(f"16b {tag}: {reason}")
    specs = input_specs(cfg, shape, make_host_mesh(device))
    want = argument_size_in_bytes(specs)
    _release_any(on_card)
    _peak_reset(on_card)
    args = materialize(specs, device, seed=0)
    got = sum(t.numel() * t.element_size() for t in _tensors(args))
    if got != want:
        fail(f"16b {tag}: the inputs hold {got} bytes, the spec tree "
             f"{want}")
    pos_in = None
    if shape.kind == "train":
        # The master copy starts as the parameters, as init_state makes it.
        for p, m in zip(_tensors(args[0]), _tensors(args[1].master)):
            m.copy_(p)
    if shape.kind == "decode":
        # A full cache: the step writes the last row and reads them all.
        pos_in = shape.seq_len - 1
        args[1]["pos"].fill_(pos_in)
    step, _ = step_for_shape(cfg, shape)

    def calls():
        walls, losses, out = [], [], None
        while len(walls) < 1 + P16_TIMED:
            _sync_any(on_card)
            t0 = time.perf_counter()
            out = step(*args)
            _sync_any(on_card)
            walls.append(time.perf_counter() - t0)
            if shape.kind == "train":
                losses.append(float(out[2]["loss"]))
            if walls[0] > P16_LONG_CALL_S:
                break
        return out, walls, losses

    (out, walls, losses), launches = _counted(calls)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    if any(launches.values()):
        fail(f"16b {tag}: kernel launches {launches}; the reference's steps "
             "set no quant_execution")
    if not all(_finite(t) for t in _tensors(out)):
        fail(f"16b {tag}: an output is not finite")
    if shape.kind == "train" and not all(np.isfinite(losses)):
        fail(f"16b {tag}: losses {losses}")
    if shape.kind == "prefill" and int(out[1]["pos"]) != shape.seq_len:
        fail(f"16b {tag}: cache position {int(out[1]['pos'])} after the "
             f"prefill, want {shape.seq_len}")
    if shape.kind == "decode":
        token, logits, cache = out
        if not torch.equal(token, logits.argmax(-1).to(token.dtype)):
            fail(f"16b {tag}: the next token is not the logits' argmax")
        if int(cache["pos"]) != pos_in + 1:
            fail(f"16b {tag}: cache position {int(cache['pos'])}, want "
                 f"{pos_in + 1}")
    timed = walls[1:] or walls
    wall = float(np.median(timed))
    ac = analytic_costs(cfg, shape)
    compute_s = H100.compute_term_s(ac.flops, 1)
    memory_s = H100.memory_term_s(ac.hbm_bytes, 1)
    bound = max(compute_s, memory_s)
    mem = "peak not measured (CPU)"
    if peak is not None:
        mem = (f"peak {peak / 1e9:.2f} GB, temp {(peak - want) / 1e9:.2f} "
               "GB over the arguments")
    extra = f"; losses {', '.join(f'{x:.4f}' for x in losses)}" \
        if losses else ""
    say(f"[launch] {tag}: arguments {want / 1e9:.3f} GB (= the spec tree's "
        f"argument_size_in_bytes), wall median {wall:.4f} s of "
        f"{len(timed)} (calls {', '.join(f'{w:.4f}' for w in walls)} s"
        f"{', the first a warm-up' if len(walls) > 1 else ''}), {mem}; "
        f"roofline compute {compute_s:.4e} s, "
        f"memory {memory_s:.4e} s (analytic {ac.flops:.4e} FLOP, "
        f"{ac.hbm_bytes:.4e} B), wall / bound {wall / bound:.2f}; K1-K5 "
        f"launches 0; outputs finite{extra}; card {card}")
    if peak is not None and peak > P16_PEAK_GB * 1e9:
        fail(f"16b {tag}: peak {peak / 1e9:.2f} GB over the batch cut's "
             f"{P16_PEAK_GB:.0f} GB")
    del args, out


def phase_launch_steps(card: str, device: str = "cuda", pairs=P16_PAIRS,
                       configs=None, seq_len=None) -> float:
    """16b: each of ``pairs`` through ``step_for_shape`` at full width and
    depth (``configs``, arch -> config, and ``seq_len`` replace them to
    rehearse on the CPU), the global batch cut.  Returns the seconds."""
    from repro_torch.configs.base import SHAPES, get_config

    t0 = time.perf_counter()
    for arch, shape_name, batch in pairs:
        cfg = (configs or {}).get(arch) or get_config(arch)
        cut = {"global_batch": batch}
        if seq_len:
            cut["seq_len"] = seq_len
        shape = dataclasses.replace(SHAPES[shape_name], **cut)
        _launch_pair(cfg, shape, card, device)
        _release_any(device == "cuda")
    return time.perf_counter() - t0


def phase_launch(device: str = "cuda", dry_archs=P16_DRY_ARCHS,
                 pairs=P16_PAIRS, configs=None, seq_len=None) -> float:
    """Phase 16 (last, with no model resident): 16a ``phase_dryrun``, 16b
    ``phase_launch_steps``.  The comparison of ``torch_kernels_micro``
    with its baseline (``python -m benchmarks.torch_run --compare --only
    torch_kernels_micro``, a full run of the benchmark) runs as a command
    of its own: with it the phase would pass its budget.  Fails on the
    card past ``P16_BUDGET_S``.  Returns the seconds."""
    on_card = device == "cuda"
    card = smi_name_power() if on_card else "none (CPU)"
    t_a = phase_dryrun(card, dry_archs)
    t_b = phase_launch_steps(card, device, pairs, configs, seq_len)
    seconds = t_a + t_b
    _say16(f"16a {t_a:.1f} s, 16b {t_b:.1f} s: phase 16 adds "
           f"{seconds:.1f} s to the run (host clock; budget "
           f"{P16_BUDGET_S:.0f} s)", card)
    if on_card and seconds > P16_BUDGET_S:
        fail(f"phase 16 took {seconds:.1f} s, over its {P16_BUDGET_S:.0f} s "
             "budget")
    return seconds


def _scheme_configs(cfg):
    """Phase 6's two serving schemes, both with quantized execution and a
    slice cache of a quarter of the store: Fig. 9's ``buddy_highbit``, and
    phase 5's Cache-Prior + DBSC + PCW."""
    from repro_torch.core.amat import MatConfig
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.moe import RoutingPolicy

    mat = MatConfig(8, 4)
    common = dict(mat=mat, cache_bytes=_store_bytes(cfg, mat) / 4,
                  miss_rate_target=0.05,
                  max_seq=SERVE_PROMPT + SERVE_NEW + 1)
    return {
        "buddy_highbit": EngineConfig(
            policy=RoutingPolicy(kind="buddy", slice_mode="highbit",
                                 quant_execution=True),
            fused_slices=True, warmup="empty", **common),
        "cache_prior_dbsc_pcw": EngineConfig(
            policy=RoutingPolicy(kind="cache_prior", slice_mode="dbsc",
                                 quant_execution=True),
            warmup="pcw", **common),
    }


def _serve_schemes(cfg, params, prompts, tag: str, device: str) -> dict:
    """Serve ``prompts`` under both schemes in turn (``_serve``: launch
    counts reset just before each run and read just after, every request
    in full, finite logits); returns each scheme's decode miss rate and
    modeled energy and latency."""
    out = {}
    for name, ecfg in _scheme_configs(cfg).items():
        run = _serve(cfg, params, ecfg, prompts, f"{tag} {name}", device)
        engine = run["engine"]
        live = engine.ledger.snapshot()
        out[name] = {
            "miss_rate": engine.decode_misses / max(engine.decode_accesses, 1),
            "accesses": engine.decode_accesses,
            "misses": engine.decode_misses,
            "energy_j": live["total_energy_j"],
            "latency_s": live["total_latency_s"],
            "launches": run["launches"], "wall": run["wall"]}
        del run, engine
        gc.collect()
    return out


def phase_train_serve(cfg, device: str = "cuda"):
    """Phase 6: train, checkpoint, serve.  ``cfg`` at its published widths,
    cut to ``TRAIN_LAYERS`` layers, trained from the port's init (seed 0)
    with ``train_or_load``'s settings on ``SyntheticLM``; the weights go
    through the port's checkpoint writer and reader (bit for bit), and the
    restored model is served under two schemes.  The same model at its
    untrained init is served beside it (descriptive only)."""
    import dataclasses
    import math
    import shutil

    sys.path.insert(0, HERE)
    from benchmarks.torch_common import eval_batches
    from repro_torch.checkpoint import ckpt as CKPT
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import init_params, tree_leaves
    from repro_torch.optim.adamw import AdamWConfig

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    small = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    n_small, n_full = small.param_count(), cfg.param_count()
    say(f"[train] {cfg.name} at its published widths, depth cut to "
        f"{TRAIN_LAYERS} of {cfg.n_layers} layers: training holds 16 B per "
        "parameter (bf16 weights and grads; f32 mu, nu and master copy), "
        f"{n_small / 1e9:.3f} B params x 16 B = {16 * n_small / 1e9:.1f} GB "
        f"at {TRAIN_LAYERS} layers against {16 * n_full / 1e9:.0f} GB at "
        f"{cfg.n_layers}, which one card cannot hold")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    opt_cfg = AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                          warmup_steps=max(TRAIN_STEPS // 10, 1))
    t0 = time.perf_counter()
    params, opt_state, hist = train_loop(
        small, steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, opt_cfg=opt_cfg,
        log_every=max(TRAIN_STEPS // 4, 1), seed=0, collect_history=True,
        device=device)
    sync()
    wall = time.perf_counter() - t0
    losses = [m["loss"] for m in hist]
    ends = [m["wall_s"] for m in hist]
    per_step = np.diff([0.0] + ends)
    say(f"[train] {TRAIN_STEPS} steps, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
        f"lr {TRAIN_LR} cosine, warmup {opt_cfg.warmup_steps}, vocab "
        f"{small.vocab_size}: losses {[round(x, 4) for x in losses]}")
    say(f"[train] aux_loss first/last {hist[0]['aux_loss']:.4f} / "
        f"{hist[-1]['aux_loss']:.4f}; grad_norm first/last "
        f"{hist[0]['grad_norm']:.3f} / {hist[-1]['grad_norm']:.3f}")
    say(f"[train] wall {wall:.2f} s; per step: first {per_step[0]:.4f} s, "
        f"median {np.median(per_step):.4f} s, min {per_step.min():.4f} s, "
        f"max {per_step.max():.4f} s (host clock; each step ends when its "
        "loss reaches the host)")
    if on_card:
        say(f"[train] max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    uniform = math.log(small.vocab_size)
    if not all(np.isfinite(losses)):
        fail("train: a non-finite loss")
    if not (losses[-1] < losses[0] and losses[-1] < uniform):
        fail(f"train: the last loss {losses[-1]:.4f} is not below both the "
             f"first {losses[0]:.4f} and ln(vocab) = {uniform:.4f}")
    del opt_state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    path = os.path.join(HERE, "build", "phase6_ckpt")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    CKPT.save(path, {"params": params}, step=TRAIN_STEPS)
    t_save = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    t0 = time.perf_counter()
    restored = CKPT.restore(path, device)["params"]
    sync()
    t_restore = time.perf_counter() - t0
    def bits(t):                    # floats compared by their bit patterns
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) \
            if t.is_floating_point() else t

    pairs = list(zip(tree_leaves(restored), tree_leaves(params)))
    same = len(pairs) == len(list(tree_leaves(params))) and all(
        a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
        and torch.equal(bits(a), bits(b)) for a, b in pairs)
    say(f"[ckpt] {len(pairs)} leaves, {nbytes} bytes: save {t_save:.2f} s, "
        f"restore onto {device} {t_restore:.2f} s; step "
        f"{CKPT.restore_step(path)}; bit-equal: {same}")
    shutil.rmtree(path)
    if not same:
        fail("ckpt: the restored leaves differ from the trained ones")
    del params, pairs
    gc.collect()

    prompts = [row[:SERVE_PROMPT] for row in eval_batches(
        small, n_batches=1, batch=SERVE_REQ, seq=SERVE_PROMPT)[0]]
    trained = _serve_schemes(small, restored, prompts, "serve-trained",
                             device)
    init = _serve_schemes(small, init_params(small, seed=0, device=device),
                          prompts, "serve-init", device)
    for name in trained:
        for label, r in (("trained", trained[name]), ("init", init[name])):
            say(f"[serve-6] {name} {label}: decode miss rate "
                f"{r['miss_rate']:.4f} ({r['misses']} of {r['accesses']}), "
                f"energy {r['energy_j']!r} J, latency {r['latency_s']!r} s "
                f"(cost model); K1/K2 launches {r['launches']}; wall "
                f"{r['wall']:.2f} s")
    return small, restored


@contextlib.contextmanager
def _checked_engines(*modules):
    """Within the block, each of ``modules``' ``SliceMoEEngine`` is a
    subclass that records whether every logit of each ``prefill`` and
    ``decode`` call was finite (``decode``'s ``logits_finite`` metric);
    yields the list of those flags, one per call."""
    from repro_torch.core.engine import SliceMoEEngine

    flags = []

    class CheckedSliceEngine(SliceMoEEngine):
        def prefill(self, tokens):
            logits = super().prefill(tokens)
            flags.append(bool(torch.isfinite(logits).all()))
            return logits

        def decode(self, first_token, n_steps):
            out, metrics = super().decode(first_token, n_steps)
            flags.append(metrics["logits_finite"])
            return out, metrics

    saved = [(m, m.SliceMoEEngine) for m in modules]
    for m, _ in saved:
        m.SliceMoEEngine = CheckedSliceEngine
    try:
        yield flags
    finally:
        for m, cls in saved:
            m.SliceMoEEngine = cls


def _check_paper_launches(tag: str, launches: dict, want: int,
                          device: str) -> None:
    """On the card K1 and K2 must have launched ``want`` times each (once
    per MoE layer per forward) and no other kernel."""
    expect = dict.fromkeys(launches, 0)
    expect.update(k_major=want, output_major=want)
    say(f"[{tag}] kernel launches {launches} (want K1 and K2 {want} each: "
        "one per MoE layer per forward)")
    if device == "cuda" and launches != expect:
        fail(f"{tag}: K1/K2 did not launch once per MoE layer per forward")


def _check_finite(tag: str, flags, runs: int) -> None:
    """Every prefill and decode of ``runs`` engine runs (two flags a run)
    gave finite logits; fewer flags mean that a benchmark built its
    engine past :func:`_checked_engines`, and fail too."""
    if len(flags) != 2 * runs:
        fail(f"{tag}: {len(flags)} prefill/decode calls checked, want "
             f"{2 * runs}: an engine ran unchecked")
    if not all(flags):
        fail(f"{tag}: non-finite logits")
    say(f"[{tag}] every logit of its {runs} engine runs finite")


def phase_paper_full_width(cfg, params, device: str = "cuda"):
    """Phase 8a: Fig. 10's four initial cache states, Fig. 9's
    ``cache_prior_highbit`` and ``dbsc_pcw`` schemes, and the ablations'
    quick rows and storage rows at full width and depth, over phase 5's
    params, through ``benchmarks/torch_fig10_warmup.run_init``,
    ``benchmarks/torch_fig9_energy.run_one`` and
    ``benchmarks/torch_ablations.run_rows`` with quantized execution (K1
    and K2 once per MoE layer per forward, counted), one engine at a
    time, every logit finite.  Energy and latency are the cost model's.
    Returns the seconds it took."""
    sys.path.insert(0, HERE)
    from benchmarks import torch_ablations as AB
    from benchmarks import torch_fig9_energy as F9
    from benchmarks import torch_fig10_warmup as F10
    from repro_torch.configs.base import get_config
    from repro_torch.core.amat import MAT84
    from repro_torch.core.engine import EngineConfig

    t_phase = time.perf_counter()
    store = _store_bytes(cfg, MAT84)
    per_expert = store / (cfg.n_layers * cfg.moe.n_experts)
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                              (1, F10.PROMPT))
    cache = 0.3 * store
    say(f"[fig10] {cfg.name} at full width and depth ({cfg.n_layers} "
        f"layers): the reference runs Fig. 10 on {F10.ARCH}, and the repo "
        "has no full-width DeepSeek-V2-Lite config; one prompt of "
        f"{F10.PROMPT} tokens from seed 11, {F10.DECODE_STEPS} decode steps "
        f"(early = the first {F10.EARLY}), cache 0.3 of the "
        f"{store / 1e9:.2f} GB store = {cache / 1e9:.3f} GB")
    want = cfg.n_layers * (1 + F10.DECODE_STEPS)
    results = {}
    runs = 0
    with _checked_engines(F10, F9, AB) as flags:
        for init in F10.INITS:
            _release()
            t0 = time.perf_counter()
            r, launches = _counted(lambda: F10.run_init(
                cfg, params, toks, init, cache, device=device,
                quant_execution=True))
            wall = time.perf_counter() - t0
            results[init] = r
            runs += 1
            say(f"[fig10] {init}: early energy {r['early_energy']!r} J, "
                f"early latency {r['early_latency']!r} s, total energy "
                f"{r['total_energy']!r} J, total latency "
                f"{r['total_latency']!r} s (cost model); misses "
                f"{r['misses']}; hotness_corr {r['hotness_corr']:.4f}; wall "
                f"{wall:.2f} s")
            _check_paper_launches(f"fig10 {init}", launches, want, device)
        e, p = results["empty"], results["pcw"]
        say(f"[fig10] finding: PCW early energy {p['early_energy']!r} J "
            f"against empty {e['early_energy']!r} J "
            f"({e['early_energy'] / p['early_energy']:.3f}x), early latency "
            f"{e['early_latency'] / p['early_latency']:.3f}x; the paper "
            "predicts PCW below empty: "
            f"{'held' if p['early_energy'] < e['early_energy'] else 'not held'}"
            " (printed, not asserted)")

        toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                                 (1, F9.PROMPT))
        say(f"[fig9] two of Fig. 9's schemes at full width and depth: one "
            f"prompt of {F9.PROMPT} tokens from seed 9, {F9.DECODE_STEPS} "
            f"decode steps, cache 0.3 of the store = {cache / 1e9:.3f} GB")
        fig9 = {}
        for name in ("cache_prior_highbit", "dbsc_pcw"):
            _release()
            t0 = time.perf_counter()
            (energy, latency, misses), launches = _counted(
                lambda: F9.run_one(cfg, params, toks, cache, F9.SCHEMES[name],
                                   device=device, quant_execution=True))
            wall = time.perf_counter() - t0
            fig9[name] = energy, latency
            runs += 1
            say(f"[fig9] {name}: decode energy {energy!r} J, decode latency "
                f"{latency!r} s (cost model); MSB misses {misses}; wall "
                f"{wall:.2f} s")
            _check_paper_launches(f"fig9 {name}", launches,
                                  cfg.n_layers * (1 + F9.DECODE_STEPS),
                                  device)
        (e_b, l_b), (e_d, l_d) = fig9["cache_prior_highbit"], fig9["dbsc_pcw"]
        say(f"[fig9] finding: dbsc_pcw's energy gain {e_b / e_d:.3f}x and "
            f"speed-up {l_b / l_d:.3f}x over cache_prior_highbit (cost "
            "model); the paper predicts both above 1: "
            f"{'held' if e_b > e_d and l_b > l_d else 'not held'} (printed, "
            "not asserted)")

        repro_store = _store_bytes(get_config(AB.ARCH), MAT84)
        frac = AB.CACHE_BYTES / repro_store
        cache = frac * store
        say(f"[ablate] the reference's cache of {AB.CACHE_BYTES:.0f} B is "
            f"{frac:.2%} of {AB.ARCH}'s {repro_store / 1e6:.2f} MB store; at "
            f"full width it would hold {AB.CACHE_BYTES / per_expert:.2f} of "
            f"one {per_expert / 1e6:.2f} MB expert, so the cache here is the "
            f"same {frac:.2%} of the {store / 1e9:.2f} GB store: "
            f"{cache / 1e9:.3f} GB, {cache / per_expert / cfg.n_layers:.1f} "
            f"experts per layer; one prompt of {AB.PROMPT} tokens from seed "
            f"21, {AB.STEPS} decode steps, the --quick rows")
        toks = np.random.default_rng(21).integers(0, cfg.vocab_size,
                                                  (1, AB.PROMPT))
        _release()
        t0 = time.perf_counter()
        rows, launches = _counted(lambda: AB.run_rows(
            cfg, params, toks, quick=True, device=device,
            quant_execution=True, cache_bytes=cache))
        wall = time.perf_counter() - t0
        runs += len(rows)
        for name, setting, r in rows:
            say(f"[ablate] {name} {setting}: energy {r['energy_mj']!r} mJ, "
                f"latency {r['latency_ms']!r} ms (cost model), lsb_fetches "
                f"{r['lsb_fetches']}, miss_rate {r['miss_rate']:.4f}")
        say(f"[ablate] {len(rows)} runs, wall {wall:.2f} s")
        _check_paper_launches("ablate", launches,
                              len(rows) * cfg.n_layers * (1 + AB.STEPS),
                              device)
        _check_finite("phase 8a", flags, runs)
    _release()
    probe = AB.SliceMoEEngine(cfg, params, EngineConfig(max_seq=96),
                              device=device)
    storage = AB.storage_rows(probe.store)
    if probe.store.total_bytes() != store or \
            storage[0][2] != round(per_expert):
        fail("ablate: the store's bytes differ from their analytic size")
    del probe
    _release()
    for _, name, nbytes, *_ in storage:
        say(f"[ablate] storage per expert, {name}: {nbytes} B")
    return time.perf_counter() - t_phase


def _say_data_law(cfg) -> None:
    """Why greedy decoding on ``SyntheticLM``'s data settles on one token:
    its next token is, with probability 0.7, a draw from the document
    topic's zipf unigram and, with 0.3, a copy of one of the last 3
    tokens (0.1 for each place a token fills)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=4, seed=1234))
    dists = np.stack([data._doc_dist(t) for t in range(data.cfg.n_topics)])
    top = dists.argmax(axis=1)
    share = 0.7 * dists[np.arange(len(top)), top]
    say(f"[fig8] eval_batches' data law: the most probable unigram token of "
        f"each of its {len(top)} topics is one of {sorted(set(top.tolist()))},"
        f" 0.7 x its probability {share.min():.4f} to {share.max():.4f} of "
        "the next-token mass, "
        "against 0.1 for a copy of one token among the last 3: under the "
        "law itself, a greedy decoder emits that token unless another fills "
        "2 of the last 3 places, and once it has emitted it, goes on")


def phase_paper_trained(cfg, params, device: str = "cuda"):
    """Phase 8b: Fig. 8's oracle and four schemes at its quick cell (cache
    0.3 of the store, miss target 0.05) with quantized execution, on one
    uniform prompt (as the reference draws it) and one from
    ``eval_batches`` (the data the model was trained on); Table 1's quick
    set (MAT84, symmetric and asymmetric, and the float model) on
    ``eval_batches`` beside the PPL with the routed experts zeroed; and
    K1 on the trained model's own codes against its plain version; over
    phase 6's trained model (``benchmarks/torch_fig8_accuracy`` and
    ``benchmarks/torch_table1_amat``).  Returns the seconds it took."""
    sys.path.insert(0, HERE)
    from benchmarks import torch_fig8_accuracy as F8
    from benchmarks import torch_table1_amat as T1
    from benchmarks.torch_common import eval_batches, synthetic_ppl
    from repro_torch.core.amat import MAT84, amat_quantize
    from repro_torch.kernels.amat_matmul import ops as amat_ops
    from repro_torch.kernels.amat_matmul.ref import amat_batched_matmul_ref

    t_phase = time.perf_counter()
    batches = eval_batches(cfg, n_batches=2)
    prompts = {
        "uniform from seed 7": np.random.default_rng(7).integers(
            0, cfg.vocab_size, (1, F8.PROMPT)),
        "eval_batches' first row": np.asarray(batches[0][:1, :F8.PROMPT]),
    }
    store = _store_bytes(cfg, MAT84)
    say(f"[fig8] {cfg.name} at its published widths, {cfg.n_layers} "
        f"layers, trained in phase 6; prompts of {F8.PROMPT} tokens, "
        f"{F8.DECODE_STEPS} decode steps, cache 0.3 of the "
        f"{store / 1e9:.3f} GB store, miss target 0.05")
    _say_data_law(cfg)
    want = cfg.n_layers * (1 + F8.DECODE_STEPS)
    with _checked_engines(F8) as flags:
        for what, toks in prompts.items():
            oracle = F8._oracle_trajectory(cfg, params, toks)
            say(f"[fig8] prompt {what}: float oracle trajectory {oracle} "
                f"({len(set(oracle))} distinct tokens)")
            for mode in F8.SCHEMES:
                _release()
                (traj, miss, _), launches = _counted(
                    lambda: F8._run_scheme(
                        cfg, params, toks, mode=mode,
                        cache_bytes=0.3 * store, miss_target=0.05,
                        device=device, quant_execution=True))
                say(f"[fig8] prompt {what}, {mode}: normalized miss rate "
                    f"{miss:.4f}, top-1 agreement with the oracle "
                    f"{F8.agreement(traj, oracle):.4f}")
                _check_paper_launches(f"fig8 {mode}", launches, want, device)
                if not 0.0 <= miss <= 1.0:
                    fail(f"fig8 {mode}: normalized miss rate {miss} outside "
                         "[0, 1]")
        _check_finite("fig8", flags, len(prompts) * len(F8.SCHEMES))
    _release()

    rows = T1.table_rows(cfg.name, cfg, params, batches, (MAT84,))
    ppl = {}
    for _, quant, scheme, mat, bits, p in rows:
        ppl[quant, scheme] = p
        what = f"{mat} {bits}-bit" if quant != "fp" else "(not quantized)"
        say(f"[table1] {quant} {scheme} {what}: PPL {p!r}")
    zeroed = synthetic_ppl(T1._replace_experts(
        params, lambda wi, wo: (torch.zeros_like(wi), torch.zeros_like(wo))),
        cfg, batches)
    say(f"[table1] routed experts zeroed: PPL {zeroed!r} against the float "
        f"model's {ppl['fp', 'float']!r} ({zeroed / ppl['fp', 'float']:.4f}x):"
        " how much this model's loss rests on the weights the schemes "
        "quantize")
    ratio = ppl["asym", "trunc_low"] / ppl["asym", "amat_low"]
    say(f"[table1] trunc/AMAT PPL ratio (asym, MAT84) {ratio:.4g}; the paper "
        "predicts Trunc above AMAT: "
        f"{'held' if ratio > 1 else 'not held'} (printed, not asserted)")
    if not all(np.isfinite(p) for p in (ppl["fp", "float"],
                                        ppl["asym", "base_high"],
                                        ppl["asym", "amat_high"])):
        fail("table1: a non-finite PPL of the float or high-bit model")
    # Holds by construction (both schemes dequantize the same high-bit
    # codes): a guard against nondeterminism, not a test of the kernels.
    if ppl["asym", "amat_high"] != ppl["asym", "base_high"]:
        fail("table1: asymmetric amat_high PPL differs from base_high PPL, "
             "which computes the same dequantization")

    # K1 on codes of trained weights, whose groups are not Gaussian draws.
    pos = next(k for k, b in params["blocks"].items() if "moe" in b)
    wi = params["blocks"][pos]["moe"]["experts"]["wi"][0]   # first layer
    E, K, N = wi.shape
    qt = amat_quantize(wi.float(), MAT84)
    g = torch.Generator(device=device)
    g.manual_seed(12)
    x = torch.randn((E, 8, K), generator=g, device=device).to(torch.bfloat16)
    use_lsb = torch.arange(E, device=device) % 2 == 0
    _check_row(f"k_major_bfloat16 on phase 6's trained {pos} wi codes"
               f"[{MAT84.name}] layer 0, E={E} M=8 K={K} N={N}",
               amat_ops.amat_expert_matmul_qt(x, qt, use_lsb,
                                              shift=MAT84.shift),
               amat_batched_matmul_ref(x, qt.codes, qt.scales,
                                       qt.zero_points, use_lsb,
                                       group_size=32, shift=MAT84.shift),
               (E, 8, N))
    del qt, x
    _release()
    return time.perf_counter() - t_phase


def phase_profile(engine, new_requests, wall_step_s):
    """A second round of the same traffic on the warm engine with its
    decode steps under ``torch.profiler``: device kernel time and launches
    per step, the engine's host ranges, and the device's busy share of the
    unprofiled decode step (``wall_step_s``, from the main run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               SchedulerConfig)

    sched = ContinuousBatchingScheduler(engine, SchedulerConfig(max_batch=4),
                                        device="cuda")
    for req in new_requests(8):
        sched.submit(req)
    sched._admit()                  # the prefills stay outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sched.run()
        torch.cuda.synchronize()
    n = len(sched.wall_step_s)
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Device-side events, less the engine's own ranges (the profiler also
    # places those on the device timeline, spanning their kernels).
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not e.key.startswith("slicemoe.")]
    k_ms = sum(dev_us(e) for e in kern) / 1e3 / n
    launches = sum(e.count for e in kern) / n
    say(f"[profile] {n} decode steps of 4 sequences: kernels {k_ms:.2f} ms "
        f"and {launches:.0f} launches per step; device busy "
        f"{k_ms / 1e3 / wall_step_s:.1%} of the unprofiled median step "
        f"({wall_step_s * 1e3:.1f} ms wall)")
    for e in events:
        if e.key.startswith("slicemoe.") and e.cpu_time_total > 0:
            say(f"[profile] host range {e.key}: "
                f"{e.cpu_time_total / 1e3 / e.count:.1f} ms per call "
                f"(profiler on)")
    for e in sorted(kern, key=dev_us, reverse=True)[:12]:
        say(f"[profile] {dev_us(e) / 1e3 / n:8.3f} ms/step "
            f"{e.count / n:6.1f} launches/step  {e.key[:80]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    name, count, _ = phase_device()
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs.base import get_config
    cfg = get_config("qwen15-moe-a2.7b")
    phase_build()
    timings = phase_kernels(cfg)
    timings.update(phase_slice_kernels(cfg))
    for key, err in phase_other_mats(cfg).items():
        timings[key]["max_abs_err"] = max(timings[key]["max_abs_err"], err)
    phase_sweep_splits(cfg)
    launches = phase_slice_path(cfg)
    launches.update(phase_f32_path(cfg))
    launches.update(phase_small_reference())
    serve_launches, engine, new_requests, wall_step, params, prompts, p5 = \
        phase_serving(cfg)
    launches.update(serve_launches)     # k_major and output_major
    if "--profile" in sys.argv[1:]:
        phase_profile(engine, new_requests, wall_step)
    # Phase 5b builds its engine over the same params: release phase 5's
    # codes and caches first, so the peak stays near phase 5's.
    del engine, new_requests
    _release()
    phase_serving_async(cfg, params, prompts, p5)
    # Phase 7 serves phase 5's params again, one engine at a time, each
    # released before the next is built.
    for phase in (phase_ep_placement, phase_controller_int8):
        _release()
        phase(cfg, params, prompts, p5)
    _release()
    phase_long_prefill(cfg, params, p5)
    _release()
    phase_traced_serving(cfg, params, prompts, p5)
    _release()
    phase_serving_benchmarks(cfg, params)
    _release()
    t_11a = phase_serving_extras(cfg, params, prompts, p5)
    t_8a = phase_paper_full_width(cfg, params)
    _release()
    t_15a, k1_15a, sums_15a = phase_serving_variants_a(cfg, params, prompts)
    launches["k_major"] += k1_15a       # K1 on the flat tree's wi and wo
    # Phase 6 trains and serves a model of its own: release the params.
    del params, prompts
    _release()
    # Phase 5's cache, a quarter of the store (p5 holds only numbers).
    t_11b = phase_serve_cli(cache_mb=p5["cache_bytes"] / 1e6)
    say(f"[phase11] 11a {t_11a:.1f} s, 11b {t_11b:.1f} s: phase 11 adds "
        f"{t_11a + t_11b:.1f} s to the run (host clock)")
    _release()
    phase_archs()
    _release()
    phase_ssm_archs()
    _release()
    phase_prefix_encdec()
    _release()
    phase_serving_variants_b(cfg, sums_15a, t_15a)
    _release()
    small, trained = phase_train_serve(cfg)
    _release()
    t_8b = phase_paper_trained(small, trained)
    del trained
    _release()
    say(f"[phase8] 8a {t_8a:.1f} s, 8b {t_8b:.1f} s: phase 8 adds "
        f"{t_8a + t_8b:.1f} s to the run (host clock)")
    phase_launch()
    _release()
    amat_src = "src/repro_torch/kernels/amat_matmul/csrc/amat_batched_matmul.cu"
    kernels = []
    for variant, key, source, replaces in (
            ("amat_batched_matmul (wi, K-major codes)", "k_major", amat_src,
             "src/repro/kernels/amat_matmul/kernel.py:225"),
            ("amat_batched_matmul_t (wo, output-major codes)",
             "output_major", amat_src,
             "src/repro/kernels/amat_matmul/kernel.py:234"),
            ("amat_batched_matmul, f32 x (three exact bf16 planes)",
             "k_major_f32", amat_src,
             "src/repro/kernels/amat_matmul/kernel.py:225"),
            ("amat_batched_matmul_t, f32 x (three exact bf16 planes)",
             "output_major_f32", amat_src,
             "src/repro/kernels/amat_matmul/kernel.py:234"),
            ("amat_matmul (one matrix, static precision)", "single",
             amat_src, "src/repro/kernels/amat_matmul/kernel.py:101"),
            ("amat_matmul, f32 x (three exact bf16 planes)", "single_f32",
             amat_src, "src/repro/kernels/amat_matmul/kernel.py:101"),
            ("expert_matmul (per-expert sliced, K-major codes)", "expert",
             amat_src, "src/repro/kernels/expert_matmul/kernel.py:81"),
            ("flash_attention (causal GQA, sliding window)", "flash",
             "src/repro_torch/kernels/flash_attn/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attn/kernel.py:115"),
            ("flash_attention, f32 inputs (3xTF32)", "flash_f32",
             "src/repro_torch/kernels/flash_attn/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attn/kernel.py:115")):
        t = timings[key]
        kernels.append({
            "name": variant, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "graph_ms": t["graph_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_graph_ms": t["library_graph_ms"]})
    say(smi_name_power())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()
