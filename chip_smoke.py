#!/usr/bin/env python3
"""The PyTorch / CUDA port on one H100, end to end: ``python3 chip_smoke.py``.

Phase 0  the card (name, power limit), TF32 off.
Phase 1  build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
         nvcc (sm_90a), one process per source (``paged_tiles.cu`` in
         nine parts, linked into one library) started together, and print
         the build time and ptxas summary.
Phase 2  hold each kernel against its plain torch version on the card and
         time the kernel, the plain version and one library call that the
         port never calls (``library_ms``), beside the least time the card
         could take (every kernel, and the library calls of B1-B5, also
         replayed from a CUDA graph: the device's time alone, without the
         host's work of the call):
         * B1 paged_verify, B2 paged_prefill, B4 paged_verify_quant at the
           main path's head shapes (H 40, h_kv 8, D 128, 16-token pages),
           B1 and B4 at decode (T 1) and at the paged spec verify (T 5),
           each with an inactive sink slot as the engine runs them (the
           tile kernels' design 2, split keys), B2 and B4 at int8
           admission's chunk shapes (design 1, 128-row tiles), each line
           naming the design, splits and key split it ran, in f32 (atol
           2e-5) and bf16 (per element 1e-5 + 2^-7 |ref|, under a 1e-2
           ceiling); the check must reject a swapped page; B1's verify
           rows must equal T = 1 calls at their positions exactly (max|d|
           0); the library call is SDPA on pre-gathered pages;
         * B3 q4_matmul at every projection shape of qwen2.5-14b (K, N) and
           M in {1, 8, 37, 256, 512}, f32 and bf16 x, both against the
           plain version's f32 output to 1e-5 of max|ref| + 1e-5 |ref| (f32
           sums in another order over K <= 13824); the check must reject
           a weight with one group's scale doubled; the library call is
           cuBLAS ``x @ w`` on the weight dequantized beforehand; also at
           a rank's FFN shard of qwen2.5-14b at tp 2 ((5120, 6912) and
           (6912, 5120)) at M = 2, the rows phase 18's ring gives it;
           qwen1.5-32b's projection shapes at M = 2 and 10 (its verify),
           mamba2-780m's in_proj and out_proj at M = 1 and 1024, and one
           expert's slice of mixtral-8x7b's and phi3.5-moe's stacks
           ((4096, 14336), (14336, 4096), (4096, 6400), (6400, 4096)) at
           M = C, the rows an expert takes: 8, 160 and 256; each line
           names the plan that ran (path, K split, tile, CTAs, CUDA kernels
           a call) and the call replayed from a CUDA graph (device alone),
           beside cuBLAS's;
         * B5 flash_verify (design 2 of the same tile kernel over the
           contiguous cache) at qwen1.5-32b's verify (T 5, 40 heads MHA, D
           128, kv_len 128-1024; also over its int8 cache with bf16
           scales, as phase 7 runs it), its draft's decode (T 1, 16 heads,
           D 64), qwen2.5-14b's dense decode (T 1, 40 over 8 heads, S
           640), a window with kv_len past S and fully masked rows, f32
           and bf16, against the plain version as B1 is, verify rows
           against single steps exactly; the check must reject a cache
           whose newest line was overwritten; the library call is SDPA on
           the contiguous cache (dequantized beforehand for int8) with
           the causal-among-drafts mask;
         * B1, B2, B4 and B5 at head dims 16, 96 and 256 (staged
           zero-padded to 64, 128 and 256), H 8 over 2, f32 and bf16, each
           with its negative control (not timed);
         * B5 with its row stats (``flash_verify_stats``, the ring's
           sequence-split merge) at a rank's shard of qwen2.5-14b's cache
           (B 2, 40 over 8 heads, D 128, 512 lines; kv_len counted from
           the shard's first line, 700 past it, -100 and 0 before it),
           T 1 and 5, f32 and bf16, over a float cache and over an int8
           one with bf16 scales (``k_scale``/``v_scale``): o by B5's rule
           and lse within 1e-4
           of the plain f32 version, an overwritten newest line must
           fail both (its scales too), a shard no row sees gives lse -inf
           and o 0; the library call is ATen's memory-efficient attention
           with its log-sum-exp (on the dequantized cache for int8);
         * B6 ssd_scan at mamba2-780m's prefill shapes (48 heads, P 64, N
           128): B 1 with S 1024, 1000 and 77 (ragged, shorter than a
           chunk) and B 2 with S 512, x, B and C strided as
           ``ssd_block`` passes them (S 1024 also contiguous), f32 (1e-5
           of max|ref| + 1e-5 |ref|) and bf16 (per element 1e-5 + 2^-7
           |ref|), y and h both; the check must reject a state reset at
           the second chunk's boundary; each line gives the call replayed
           from a CUDA graph (device alone), the chunks, CTAs and CUDA
           kernels a call; no single PyTorch call computes the scan, so its
           ``library_ms`` is null.
Phase 3  serve 16 requests (prompts 256-1024, up to 32 new tokens) through
         the paged engine with chunked admission at qwen2.5-14b's full
         width, 24 of its 48 layers, cut for time (``PAGED_LAYERS``; phase
         13 serves all 48), bf16, random weights from a seed — then the same
         with int8 pages — and show that every chunk and decode step of
         every layer launched its kernel; then the dense-cache engine on
         the same requests (the ``--check-dense`` path), 24 B5 launches a
         decode step. Every engine of phases 3, 5, 7 and 9 replays its
         fixed-shape decode step (and the paged engine its full chunks)
         from CUDA graphs, the port's counterpart of the JAX package's
         jitted steps; the launch counts are the graphs' replays times
         what each capture launched. While the weights are on the card,
         phase 12's runs: each page type again eager and graphed, keeping
         every token's logits, timing every step and chunk between
         syncs, the engine's 30th step in a ``torch.profiler`` window
         (the main run's launches and streams, both ways).
Phase 4  a 2-layer (``PARITY_LAYERS``, cut for time from 4) full-width f32
         copy: the paged engine (chunked, f32
         and int8 pages) with kernels against ``use_kernels(False)``:
         every launch agrees with its plain version on the same inputs;
         with f32 pages logits agree to 2e-4 of max|ref| and tokens are
         equal; with int8 pages the (layer, page) pairs whose int8 bytes
         differ between the two runs are counted (none differing while
         the logits differ by more than 2e-4 is a fault); the dense
         engine's tokens equal the paged engine's.
Phase 5  the streamed q4 path at full width, all 48 layers, bf16: build
         qwen2.5-14b on the card one layer at a time from a seed, quantize
         each layer there as the serve driver does (and hold layer 0's
         packed bytes against the CPU's), write the ~10 GB q4 layer store
         to a temporary directory (free space checked first; kept for
         phases 14 and 18, which serve it, and deleted after phase 18),
         then serve 8 requests (prompts 128-512, 8-16 new tokens:
         sized to keep the phase near a minute) through the layer-wise
         engine twice — q4 weights resident on the card, then streamed
         from the store with a window of 4 layers — and show 336 B3
         launches a pass (7 projections x 48 layers) and 48 B5 launches a
         decode step, peak resident
         weights <= 4 layers, and equal tokens. The store was just
         written, so its reads likely come from the page cache, not the
         disk.
Phase 6  the same path at 3 layers (one past the window of 2), full width,
         f32: every B3 launch agrees
         with its plain version on the same inputs (1e-5 of max|ref|),
         every B5 launch too (atol 2e-5), streamed and resident tokens are
         equal, and kernel and plain-version logits agree to 2e-4 of
         max|ref|.
Phase 7  speculative serve of qwen1.5-32b at full width, 8 of its 64
         layers, cut for time (``SPEC_LAYERS``; 40 heads MHA,
         d_ff 27392, int8 dense
         cache): built and quantized on the card one layer at a time into
         a ~2.2 GB q4 layer store (beside phase 5's; free space
         checked first; deleted at the end), with a resident bf16 qwen1.5-0.5b draft (24 layers,
         tied embeddings), gamma 4, 2 slots (the verify runs B3 at M = 10,
         its decode kernel), ctx 1024; 4 requests (seed 7), prompts
         128-512, 16 new tokens. Spec streamed (window 4), then spec with
         the q4 weights resident (equal streams), then vanilla greedy
         resident and streamed (equal streams). The spec streams must
         equal the vanilla ones but at a near-tie: where they split, the
         vanilla top-2 logit gap must be under twice the two runs' logit
         difference there (no flip is possible otherwise), and before any
         split the logits agree to 5e-2 of max|ref| (bf16; the bound was
         set at 64 layers).
         Asserts per cycle 8 B5 launches at T = 5 (a target layer
         each), 120 at T = 1 (5 draft steps x 24 layers) and 56 B3
         launches (7 a target layer). The resident runs
         replay the target's step and the draft's from CUDA graphs and run
         again eagerly for phase 12 (equal streams); the vanilla streamed
         run (its layers come in rotating buffers: eager) carries a
         ``Tracer`` and CUDA events around each layer's H2D copy.
         With random weights the draft and target rarely agree: the phase
         shows cost and correctness, not acceptance.
Phase 8  spec parity at 2 layers (``SPEC_PARITY_LAYERS``, cut for time
         from 4), full width, f32 and an f32 cache, 4
         requests through 4 slots (cut from 8 for time): (a)
         qwen1.5-32b's dense engine with a distinct draft and with a
         perturbed self-draft (the target plus seeded noise, its size
         raised until the acceptance lands in 0.2-0.9); (b) qwen2.5-14b's
         paged engine with chunked admission and spec (B1 at T = 5); (c)
         the streamed q4 engine with spec. Kernels against
         ``use_kernels(False)``: every B5/B1/B2/B3 launch agrees with its
         plain version on the same inputs, verify logits agree to 2e-4 of
         max|ref|, per-request accepted counts are equal, and every spec
         stream equals the vanilla greedy stream.
Phase 9  serve mamba2-780m (the ssm family) at full width, 24 of its 48
         layers (``SSM_LAYERS``; d 1536, 48 SSD heads of P 64, N 128,
         vocab 50280, tied),
         bf16, random weights from a seed: 16 requests (prompts 200-2000
         tokens, 32 new tokens) through 8 slots, ctx 2080. (a) The
         resident dense engine: exactly 24 B6 launches a prefill and
         nothing else; (b) the same with ``use_kernels(False)``: streams
         equal but at a near-tie (phase 7's rule); (c) a q4 layer store
         built and quantized on the card one layer at a time, written to
         a temporary directory and served resident and streamed (window
         4): equal streams, 24 B6 launches a prefill and 2 B3 launches
         (in_proj, out_proj) a layer a pass.
Phase 10 ssm parity at 2 layers (``PARITY_LAYERS``, cut from 4),
         full width, f32 and an f32 cache: the
         dense engine and the streamed q4 engine, kernels against
         ``use_kernels(False)``: every B6 (and B3) launch agrees with its
         plain version on the same inputs, logits agree to 2e-4 of
         max|ref| and tokens are equal.
Phase 11 the CI smokes' shapes on the card: the reduced configs (head_dim
         16) through ``python -m repro_torch.launch.serve --smoke --dtype
         f32``, each in its own process (all started together), must
         exit 0 having launched
         their kernels: (a) ``--prefill-chunk 8 --check-dense`` (B2, B1,
         and B5 in the dense engine; equal tokens), (b) ``--prefill-chunk
         8 --kv-quant-kernel`` (B4; no dense comparison, ROADMAP Queue C),
         (c) ``--arch qwen1.5-32b --stream-window 2 --store-quant q4
         --check-resident`` (its int8 dense cache through the fused B5,
         and B3; streamed tokens equal resident), (d) ``--chaos transient
         --stream-window 2 --store-quant q4`` (3 injected layer-read
         faults retried; tokens equal the clean run's), (e)
         ``--prefill-chunk 16 --device-budget 0.1 --host-budget 0.07
         --park-idle-s 0`` (the requests and then their prompts again
         through the tiers: evicted pages spill, the repeats recall pages
         from the host and from disk, and the tokens equal unbudgeted
         runs'; a parked session equals one run) and (f) the same with
         int8 pages (``--kv-quant-kernel``, 0.04 and 0.017 MB), each with
         ``--stages 1`` and (e), (f) ``--page-tokens 16`` (the values they
         ran with before the driver took the JAX driver's defaults); then
         every ``repro.launch.serve`` line of ``.github/workflows/ci.yml``
         as written, with ``repro_torch`` in its place (decode through the
         4-stage ring across 8 rank processes -- the ``--batch 2`` line,
         whose batch the stages do not split, through the GSPMD layer
         across them -- then its ``--paged-kv``,
         ``--stream-window`` or ``--chaos`` section), each exiting 0 with
         its kernels launched (the ranks' B5-stats launches, which the
         driver prints summed over its ranks, above 0 on every line whose
         decode ran across ranks; a ``--stream-window`` line's
         streamed ring and the ``--chaos failover`` line's failover run
         across those ranks too, and their lines say so),
         and the metrics and trace files the CI validates passing the
         port's validators with the names the CI requires.
Phase 12 steps replayed from CUDA graphs against eager, recorded in phases
         3 and 7 and printed beside the card's name and power limit: phase
         3's paged runs (bf16 and int8 pages) both ways -- wall, TPOT and
         TTFT p50, the median decode step, full and ragged chunk, equal
         streams, graphed-vs-eager logit max|d|, the exact launch counts
         (2688 B1 and 2160 B2, 4848 B4, asserted), chunks graphed and
         eager, captures, their seconds and memory; one profiler window a
         way (a step's wall, the device's busy time as
         the union of kernel intervals, the idle share, the top five
         device and host ops; traces in ``chiprun_out/``); phase 7's
         resident vanilla step and spec draft and verify ms both ways;
         and the traced vanilla streamed run's stall split per token
         (compute, disk_wait, sched_idle), its prefetcher spans and the
         H2D copy's device time, its trace checked by the port's
         ``validate_chrome_trace`` with the decode and prefetcher tracks.
Phase 13 tiered KV memory at qwen2.5-14b's full width and depth (48
         layers, bf16 pages of 3 MiB, 8 slots, ctx 2048, 256-token chunks,
         graphed steps, the phase-3 weights' seed): 24 requests, 4 groups
         of 6 sharing a 768-token prefix each, a unique suffix of 32-224
         tokens (seed 13), 16 new tokens, round-robin over the groups.
         The reference run (a pool for every slot, nothing evicted), then
         the tiered run: ``TierManager(MemoryBudget(device=192 pages,
         host=64 pages))``, the pool sized from it, cost eviction, a disk
         tier in a temporary directory (free space checked first, deleted
         at the end). Every page recalled from host or disk must hold the
         bytes it held when evicted (a device copy taken at eviction,
         compared bit for bit after the admit wrote it back); evictions,
         host recalls, spills and disk recalls all above 0; the books
         balance, the device and host peaks stay within their budgets and
         the host and disk tiers are empty after close; streams equal the
         reference's or split only at near ties (phase 7's rule). A
         second tiered run with two transient faults on each of
         ``kv_d2disk``, ``kv_disk2h`` and ``kv_h2d``: streams equal the
         tiered run's, the retries counted in ``KVStats.fetch_retries`` and
         the page files' ``WorkerHealth``. A parked session
         (``park_idle_s`` 0, a 1000-token prompt, two turns of 16 tokens,
         demoted to disk between them) equals one 32-token run, and
         restored from a page file with flipped bytes its logits differ.
         Prints each run's wall, TTFT and TPOT p50, the bytes each tier
         moved, the fetch stall, the device time of a page's D2H and H2D
         copies (CUDA events: in the run, and a page's copy alone between
         a pinned buffer and the card), the modeled against measured recall
         seconds (``core.latency.tier_recall_crosscheck``), park, demote
         and restore ms, beside the card's name and power limit.
Phase 14 the piped ring (PRP) in one process at qwen2.5-14b's full width,
         all 4 stages on the card (seed 0; 8 prompts of 512 tokens, drawn
         as the JAX driver draws its batch (seed 1), prefilled on one
         device, ctx 1024): (a) bf16, 16 of the 48 layers, cut for time
         (``RING_A_LAYERS``), the resident ring
         at k 1 (w 4) and k 2 (w 2), 32 greedy steps replayed from CUDA
         graphs against the one-device decode of the same cache (streams
         equal but at near ties, phase 7's rule; splits counted), 8 steps
         eager (logits equal to the graphed steps', max|d| 0), a T = 5
         verify pass against 5 single steps, exactly 64 B5 launches a
         pass (16 layers x 4 microbatches); (b) phase 5's q4 store (all
         48 layers, read back from the store phase 5 kept) at k 2: the
         resident q4 ring, 4 graphed steps (``RANK_STEPS``, cut for
         time from 8; kept, with the prefilled cache, as
         phase 18 (a)'s reference), and the streamed ring (banks 2 steps
         ahead), 4 steps, equal tokens, exactly 1344 B3 (7 x 192) and 192
         B5 launches a pass; one
         eager resident step with every B3 launch (M = 2 rows) held
         against its plain version on the same inputs; peak
         resident weight bytes against the resident q4 bank's, the stall,
         the worker's staging of each bank (its trace span and the CUDA
         events around its layers' H2D copies), the trace checked; (c)
         stage 2 of that ring killed at the first layer read of the third
         token's pass (prompts of 4 tokens), in one process (the one-card
         layout, tp 1): ``ElasticRingServer``
         re-plans the survivors (Halda over the paper cluster's profiles),
         rebuilds, replays; zero tokens lost and the tokens after recovery
         equal a clean survivor-ring run's; the detect, re-solve, rebuild
         and replay split printed, and the recovery extrapolated to (b)'s
         history (the replay is one streamed pass a token); (d) 4 layers, f32, eager: every B5
         launch against its plain version on the same inputs, logits
         within 2e-4 of the ring on ``use_kernels(False)`` and equal
         tokens. Its numbers again beside the card's name and power limit.
Phase 15 the moe family (mixtral-8x7b: 32 layers, d 4096, 8 experts of
         d_ff 14336, top 2, sliding window 4096; phi3.5-moe: 16 experts of
         d_ff 6400), random weights from a seed: (a) mixtral at published
         width, 8 of its 32 layers, cut for time (``MOE_LAYERS``), as a
         ~6 GB q4 store
         built and quantized on the
         card one layer at a time (every expert stack and the router q4),
         written to a temporary directory; 8 requests (prompts 128-512,
         seed 7, 16 new tokens) through 8 slots, ctx 640, the layer-wise
         engine with the q4 weights resident, then streamed (window 4):
         exactly (4 + 3 x 8) x 8 = 224 B3 launches a pass (each expert's
         slice at M = C) and 8 B5 a decode step, peak under 5 layers,
         equal streams; (c) the resident q4 bank over 4 stages at k 1, 2
         rows a stage, 8 graphed steps against the one-device decode
         (phase 7's near-tie rule), 28 x 8 x 4 = 896 B3 and 32 B5 a pass
         exactly, one eager
         step with every B3 launch held against its plain version; (b)
         mixtral at full width, 8 of 32 layers, bf16 (23 GB), through
         the paged engine (8 slots, ctx 2048, 16-token pages, 256-token
         chunks; 16 requests, prompts 256-1024, 32 new tokens) graphed
         and eager: B2 8 a chunk and B1 8 a decode step exactly, equal
         streams; (d) mixtral and phi3.5-moe at 2 layers (``PARITY_LAYERS``,
         cut from 4), full width, f32,
         eager: the dense engine, the paged engine (chunked, f32 and int8
         pages) and the layer-wise engine over a q4 store, every launch
         held against its plain version on the same inputs, logits within
         2e-4 of max|ref| of ``use_kernels(False)``'s and equal streams
         (int8 pages as phase 4 holds them); (e) the card's
         ``DeviceProfile`` from the port's probes
         (``core.profiler.profile_local_device``) and Halda's plan for
         mixtral in q4 over it. Its numbers again beside the card's name
         and power limit.
Phase 16 the four families left, random weights from a seed: (a)
         minicpm3-4b (MLA) at published width, 8 of its 62 layers, cut
         for time (``MLA_LAYERS``; d 2560, bf16) through phase
         3's paged mix on
         latent pages,
         graphed and eager (no B-kernel launch: MLA attention is plain
         torch, as in the reference), the dense-cache engine on the same
         requests (near ties only: its prefill takes the expanded form,
         the paged chunks the absorbed one), a T = 5 verify over latent
         pages against 5 single steps, a tiered run (128 device, 32 host
         pages, cost eviction, page files) whose every recalled latent
         page is bit-equal to its bytes at eviction, then a q4 store built
         on the card through phase 5's mix resident and streamed (window
         4): 4 B3 launches a layer a pass exactly (``wo`` and the FFN);
         (b) qwen2-vl-2b (vlm, M-RoPE) at published size through the paged
         mix on bf16 pages (B2 28 a chunk, B1 28 a step) and int8 pages
         (B4 for both), graphed and eager, a dense prefill of a 16 x 16
         grid of patch embeddings at M-RoPE grid positions (its last row
         against a full-sequence forward, then 4 graphed decode steps),
         and the 4-stage ring at k 1 over 8 prompts of 512 tokens against
         the one-device decode (112 B5 a pass); (c) recurrentgemma-9b
         (hybrid, 38 layers, 19 GB bf16) through the dense-cache engine,
         8 slots, ctx 4096 (a 2048-line rolling attention buffer), 8
         prompts of 1024-3000 tokens, 32 new tokens, graphed and eager (12
         B5 a decode step: MQA 16 over 1 at D 256); (d) whisper-tiny
         (audio) at published width: 8 x 1500 frames encoded, a 16-token
         prompt, then decode until the 448-line self-attention cache is
         full, graphed and eager (4 B5 a step, 1728 in all); every pair of
         runs equal but at near ties (phase 7's rule); the hot spots that
         run plain torch (MLA's absorbed attention, the RG-LRU's scan and
         decode block) timed at those shapes; (e) each family at
         4 layers, full width, f32, eager, every launch held against its
         plain version on the same inputs and logits within 2e-4 of
         max|ref| of ``use_kernels(False)``'s with equal streams (int8
         pages as phase 4 holds them). Its numbers again beside the card's
         name and power limit.

Phase 17 training on the card, f32, TF32 off, random weights from a seed,
         through ``repro_torch.launch.train.run`` (the train loop):
         (a) qwen2.5-14b at full width, 1 of its 48 layers, cut for time
         (``QWEN_TRAIN_LAYERS``; 1.832 B params; params,
         grads and two moments 29.3 GB), batch 8 x 128: 10 steps that
         write no checkpoint; 10 steps with one checkpoint, at step 6
         (the JAX layout, ~22 GB, in the temp dir), going on from the
         same state; then ``--resume`` from it to 10: finite losses, the
         mean of steps 4-6 below the first, the saving run's steps 1-10
         and the resumed steps 7-10 within 1e-3 relative of the run that
         saves nothing; (b)
         mamba2-780m at full width and depth, batch 4 x 1024, 5 steps:
         exactly 240 B6 launches (48 a step: its backward recomputes the
         plain scan) and nothing else; each run's step ms between syncs,
         tokens/s and ``max_memory_allocated`` against 16 B a param; (c)
         one train step of mamba2-780m at 4 layers with B6 against
         ``use_kernels(False)``: loss within 1e-5 relative, every
         gradient within 1e-4 of its leaf's max|ref|, each run's
         parameters after the step within 1e-6 of max|ref| of AdamW's
         step written out in f64 on that run's own gradients (the two
         runs' parameters are only read against each other: Adam's
         g / (|g| + eps) turns a rounding of a g near eps into a
         sizeable part of lr); the same step with B6's outputs detached must
         fail the gradient check; and a qwen2.5-14b-width step's
         gradients with remat against without, within 1e-5.

Phase 18 the ring across ranks, resident, streamed and through a
         failover: 4 stages x tp 2 = 8 rank
         processes on the card (``launch.mesh.RankWorld``, gloo, one torch
         thread a rank), each reading only its part of a layer store: (a)
         qwen2.5-14b at full width and depth from phase 5's q4 store and
         phase 14 (b)'s prefilled cache (batch 8, prompts of 512, ctx
         1024), 4 greedy steps at k 2 (``RANK_STEPS``, cut for time
         from 8)
         then 4 T = 5 verify passes, against phase 14
         (b)'s one-process resident ring on the same store (streams equal
         but at near ties, phase 7's rule; every rank the same tokens); (c)
         exactly 192 B5-stats and 1344 B3 launches a rank (48 layer
         rows x 4 steps, x 7 projections), nothing else; (d) rank 0's
         step and verify ms and the step's share in the collectives and
         their host staging (``comms`` phases on the ``comm`` track); (e)
         the streamed ring across the same 8 ranks over the same store at
         full width and depth, k 2, one window staged at a time (depth 1),
         4 greedy steps from (a)'s cache (``STREAM_RANK_STEPS``, cut
         from 8; ``serve.rank_stream_job``: each
         rank stages only its stage's 12 rows, a window of 6 at a time, and
         of each only its part of every leaf): tokens
         and logits equal to (a)'s eager resident steps (max|d| 0) on every
         rank, exactly 192 B5-stats and 1344 B3 launches a rank, each
         rank's bytes read a pass equal to its rows' local shards, its peak
         staged bytes at most one window's (half its resident rows), its
         stall, rank 0's
         streamed step against (a)'s resident one; (b)
         4 layers at full width, f32, an f32 and an int8 cache: the
         ranks' logits (kernels) against the one-process ring on
         ``use_kernels(False)`` within 2e-4 of max|ref| with equal tokens
         at every step (int8 too; the int8 k/v bytes that differ from the
         plain run's are counted and printed), every replicated activation
         (x after each layer, the
         merged attention, the final hiddens) equal to the bit across a
         stage's members on every rank, and the negative control (members
         merging without their shard's offset) failing; (g) the streamed
         ring across the ranks on (b)'s f32 store and cache, within 2e-4 of
         max|ref| of the one-process ring on ``use_kernels(False)`` with
         equal tokens at every step and equal to (b)'s resident ranks
         (max|d| 0); (f) failover across ranks: qwen2.5-14b at full width
         from the first 8 of the store's 48 layers (``FAILOVER_LAYERS``,
         cut for time: the phase is world starts and replays), the same 8
         ranks, prompts of 4 tokens, 6 new tokens, through the driver's
         ``--chaos failover`` (``serve_failover``): stage 1's first rank
         ``SIGKILL``ed as the third token's pass starts, the death
         attributed to stage 1, the survivors re-planned and re-spawned as
         2 stages x tp 2 = 4 ranks that replay the history, zero tokens
         lost and the tokens after recovery equal to a clean 4-rank run's
         fed the same history (on the survivors' world); the detect,
         re-solve, rebuild and replay split printed; (h) the GSPMD layer
         across the same 8 ranks (``runtime.gspmd``, the path of any
         batch the stages do not split): qwen2.5-14b at full width,
         ``GSPMD_LAYERS`` = 4 of its 48 layers, cut for time (every step
         sums each product over the data ranks, the vocab-sharded head's
         included), bf16, batch 1: each rank cuts its FSDP part of every
         weight from the tree handed over as CUDA tensors, prefills 256
         tokens into its part of the cache and takes 4 greedy steps with
         the weights where they lie (the data ranks sum their products);
         every rank the same tokens, exactly 16 B5 launches a rank (the
         kv heads split over tp), rank 0's prefill and step ms and the
         step's share in the collectives, each rank's parameter bytes
         against the one-process model's; then, f32 with kernels live,
         full width, qwen2.5-14b (2 layers, B5 over its heads),
         recurrentgemma-9b (3 layers, one of each block: B5 stats over
         its local attention's sequence) and mamba2-780m (2 layers,
         batch 2: B6 in the prefill): the ranks' prefill and 4 steps
         against the one-process ``prefill`` and ``decode_step`` on the
         card, logits within 2e-4 of max|ref|, tokens equal, launches
         exact; (i) one ``fsdp`` and one ``zero1`` train step of
         qwen2.5-14b at full width, 1 layer, f32, across the same 8 ranks
         as 2 stages x tp 4 (zero1 at 4 x 2 would hold four copies of the
         tensor-parallel model with their gradients: ~73 GB), against the
         one-process ``make_train_step`` (phase 17's) on the same weights
         and batch: loss and gradient norm within 1e-5 relative, each
         leaf's first moment within 1e-4 of its max|ref|, every
         parameter whose one-process update is at least 0.99 lr (its
         gradient clear of Adam's eps) within 0.1 lr; the elements beyond
         0.1 lr printed by leaf with their one-process |g| in units of
         eps; zero1's one reduce-scatter and one all-gather over "data",
         each style's step ms and ``max_memory_allocated`` a rank. Its
         numbers again beside the card's name and power limit.

Prints the card's name and power limit again, the kernels' JSON line, then
``{"ok": true, "device": ...}`` as the last line. Any failure raises and
the script exits nonzero without it; it also refuses to run without a
CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12                       # H100 SXM, data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # bf16 tensor / f32 SIMT
H, H_KV, D, BS = 40, 8, 128, 16             # qwen2.5-14b attention heads
TILES_SOURCE = "src/repro_torch/kernels/csrc/paged_tiles.cu"
SOURCES = {"paged_verify": TILES_SOURCE, "paged_prefill": TILES_SOURCE,
           "paged_verify_quant": TILES_SOURCE}
Q4_SOURCE = "src/repro_torch/kernels/csrc/q4_matmul.cu"
FLASH_SOURCE = TILES_SOURCE
REPLACES = {"paged_verify": "src/repro/kernels/paged_decode.py:89",
            "paged_prefill": "src/repro/kernels/paged_prefill.py:99",
            "paged_verify_quant": "src/repro/kernels/paged_decode.py:214",
            "q4_matmul": "src/repro/kernels/q4_matmul.py:67",
            "flash_verify": "src/repro/kernels/flash_decode.py:89",
            "flash_verify_stats": "src/repro/kernels/flash_decode.py:89",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:73"}


_LOG = []


def log(msg: str) -> None:
    """Print ``msg``, and keep the whole log in ``chiprun_out/`` (the chip
    tool returns only the end of the output)."""
    print(msg, flush=True)
    if not _LOG:
        _LOG.append(open(out_path("chip_smoke.log"), "w"))
    _LOG[0].write(msg + "\n")
    _LOG[0].flush()


# --------------------------------------------------------------------------- #
#  phase 2 helpers
# --------------------------------------------------------------------------- #

class Timer:
    """Median device time of one call, each launch after an L2 flush (the
    main path meets each layer's pages cold: a layer pool outgrows L2)."""

    def __init__(self, torch, reps: int = 10):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def graph(self, fn) -> float:
        """The same median for ``fn`` captured once in a CUDA graph and
        replayed: the device's work alone, without the host's work of the
        call (Python checks, allocation, launch overhead)."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        return self(g.replay)


def make_pages(torch, rng, *, B, nb, kv_len, sink_rows=(), h_kv=H_KV,
               head_dim=D):
    """A pool with each sequence's live pages at random ids; table entries
    past ceil(kv_len/bs) are stale ids of other pages; ``sink_rows`` run
    as inactive slots (all-sink table, kv_len = T set by the caller)."""
    P = B * nb + 1
    perm = rng.permutation(np.arange(1, P)).reshape(B, nb)
    table = perm.copy()
    for b in range(B):
        live = -(-int(kv_len[b]) // BS)
        table[b, live:] = rng.integers(1, P, nb - live)
    for b in sink_rows:
        table[b] = 0
    # data at std 0.5 keeps |out| < 4, where bf16's half-ulp is < 1e-2
    k = rng.standard_normal((P, BS, h_kv, head_dim), dtype=np.float32) * 0.5
    v = rng.standard_normal((P, BS, h_kv, head_dim), dtype=np.float32) * 0.5
    dev = "cuda"
    return (torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev),
            torch.from_numpy(table.astype(np.int32)).to(dev))


def visible(kv_len, T, window, S=None):
    """Per sequence: (cache positions any row sees, sum over rows of the
    keys each row sees), among the first S positions when S is given."""
    pos, keys = [], []
    for n in kv_len:
        qpos = np.arange(int(n) - T, int(n))
        lo = np.maximum(qpos - window + 1, 0) if window else \
            np.zeros_like(qpos)
        hi = qpos + 1 if S is None else np.minimum(qpos + 1, S)
        seen = np.maximum(hi - lo, 0)
        keys.append(int(seen.sum()))
        live = seen > 0
        pos.append(int(hi[live].max() - lo[live].min()) if live.any()
                   else 0)
    return pos, keys


def bound_ms(*, q_elems, elt, kv_pos, keys, dtype, kv_elt=None,
             scale_elt=0, h_kv=H_KV, head_dim=D, heads=H, extra_bytes=0):
    """Least time for the work: q read once and the output written once
    (q's dtype; ``extra_bytes`` more written, e.g. B5's row stats), the
    live K/V positions read once (with their int8 scales when
    ``scale_elt``), against the operations (QK and PV multiply-adds over
    the keys each row sees)."""
    kv_elt = elt if kv_elt is None else kv_elt
    nbytes = 2 * q_elems * elt + extra_bytes + \
        sum(kv_pos) * h_kv * (head_dim * kv_elt + scale_elt) * 2
    flops = 4 * head_dim * heads * sum(keys)
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_on_cache(torch, q, k, v, kv_len, window):
    """The library yardstick: SDPA on a contiguous cache k/v (B, S, h_kv,
    D), heads expanded beforehand, with the causal-among-drafts (and
    window) mask."""
    import torch.nn.functional as F

    B, T, H_q = q.shape[:3]
    S = k.shape[1]
    pos = torch.arange(S, device=q.device)
    qpos = kv_len.long()[:, None] - T + torch.arange(T, device=q.device)
    mask = pos[None, None] <= qpos[..., None]
    if window:
        mask &= pos[None, None] > qpos[..., None] - window
    mask = mask[:, None]                                      # (B,1,T,S)
    n_rep = H_q // k.shape[2]
    kt = k.permute(0, 2, 1, 3).repeat_interleave(n_rep, dim=1)  # (B,H,S,D)
    vt = v.permute(0, 2, 1, 3).repeat_interleave(n_rep, dim=1)
    qt = q.permute(0, 2, 1, 3)

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    return call


def sdpa_on_gathered(torch, q, k, v, table, kv_len, window):
    """The library yardstick of the paged kernels: SDPA over pages
    gathered beforehand."""
    return sdpa_on_cache(torch, q, k[table.long()].flatten(1, 2),
                         v[table.long()].flatten(1, 2), kv_len, window)


def within(out, want, dtype):
    """Worst ratio of |out - want| to what the dtype allows, per element.
    f32: atol 2e-5 (another order of summation). bf16: the kernel's one
    rounding of its f32 result, 1e-5 + 2^-7 |want| (one bf16 ulp at most;
    rounding costs half of one), under the 1e-2 ceiling; a per-element
    bound keeps the check sharp where outputs are small, as they are under
    a flat softmax."""
    err = (out.float() - want.float()).abs()
    if dtype == "float32":
        return float(err.max()) / 2e-5
    ratio = float((err / (1e-5 + 2.0 ** -7 * want.float().abs())).max())
    return max(ratio, float(err.max()) / 1e-2)


def tile_label(pd, name, B, T, H_q, h_kv, head_dim, bs, nb, pool):
    """The design a tile-kernel call runs, as phase 2 names it."""
    plan = pd.tile_plan(B, T, H_q, h_kv, head_dim, bs, nb, pool=pool,
                        kernel=name)
    text = f"design {plan.design}"
    if plan.design == 2:
        unit = "lines" if name == "flash_verify" else "pages"
        text += (f": {plan.n_split} splits of {plan.split_pages} {unit}, "
                 f"key split {plan.key_split}")
    if plan.d_pad != head_dim:
        text += f", D padded to {plan.d_pad}"
    return f"[{text}]"


def verify_equals_steps(label, dtype, out, step, T):
    """Row t of a T-row call against a T = 1 call at its position
    (``step(t)``): max|d| must be exactly 0 (fixed split boundaries and key
    split, blocks counted from a split's start)."""
    worst = 0.0
    for t in range(T):
        d = (out[:, t:t + 1].float() - step(t).float()).abs().max()
        worst = max(worst, float(d))
    if worst != 0.0:
        raise AssertionError(f"{label} {dtype}: a verify row differs from "
                             f"a single step at its position by {worst}")
    return worst


def hold(label, dtype, out, want, control):
    """The phase-2 rule: no NaN, ``out`` within the dtype's tolerance of
    the f32 plain version, and the negative control outside it; returns
    (max|err|, ratio, control ratio)."""
    if bool(out.isnan().any()):
        raise AssertionError(f"{label} {dtype}: NaN in kernel out")
    err = float((out.float() - want.float()).abs().max())
    ratio = within(out, want, dtype)
    if ratio > 1.0:
        raise AssertionError(f"{label} {dtype}: max|err| {err}, "
                             f"{ratio:.3g}x the tolerance")
    c = within(control, want, dtype)
    if c <= 1.0:
        raise AssertionError(f"{label} {dtype}: the check does not see its "
                             f"negative control ({c:.3g}x the tolerance)")
    return err, ratio, c


def check_kernels(torch, timer, rng):
    """Phase 2; returns the JSON rows (bf16 measurements) by kernel."""
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.models.layers import quantize_kv

    B, nb = 8, 2048 // BS
    kv_len_np = rng.integers(64, 2049, B)
    cases = []
    for T in (1, 4, 5):
        kvl = kv_len_np.copy()
        kvl[0] = T                               # inactive slot, sink table
        cases.append(("paged_verify", f"B1 T={T} B={B}", T, kvl, None, (0,)))
    for S, n, window in ((256, 1024, None), (256, 1024, 512),
                         (100, 868, None)):
        cases.append(("paged_prefill", f"B2 S={S} kv_len={n} "
                      f"window={window}", S, np.array([n]), window, ()))
    # decode and the paged spec verify over int8 pages, each with an
    # inactive sink slot as the engine runs them (design 2)
    for T in (1, 5):
        kvl = kv_len_np.copy()
        kvl[0] = T
        cases.append(("paged_verify_quant", f"B4 T={T} B={B}", T, kvl, None,
                      (0,)))
    # int8 chunked admission: a full chunk and a short last one at B = 1
    for S, n in ((256, 1024), (100, 868)):
        cases.append(("paged_verify_quant", f"B4 S={S} kv_len={n}", S,
                      np.array([n]), None, ()))
    rows = {}
    for name, label0, T, kvl, window, sinks in cases:
        Bc = len(kvl)
        quant = name == "paged_verify_quant"
        k32, v32, table = make_pages(torch, rng, B=Bc, nb=nb, kv_len=kvl,
                                     sink_rows=sinks)
        # negative control: one sequence's newest page swapped for another
        # page, which every row of it sees; the check must reject it
        b_bad = Bc - 1
        last = (int(kvl[b_bad]) - 1) // BS
        bad_table = table.clone()
        bad_table[b_bad, last] = table[b_bad, 0]
        kv_len = torch.from_numpy(kvl.astype(np.int32)).cuda()
        q32 = torch.from_numpy(rng.standard_normal(
            (Bc, T, H, D), dtype=np.float32)).cuda()
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = q32.to(dt)
            label = f"{label0} " + tile_label(
                pd, name, Bc, T, H, H_KV, D, BS, nb,
                torch.int8 if quant else dt)
            if quant:
                kq, ks = quantize_kv(k32)
                vq, vs = quantize_kv(v32)
                ks, vs = ks.to(dt), vs.to(dt)     # scales in the pool dtype
                args = (q, kq, vq, ks, vs, table, kv_len)
                kern = lambda: pd.paged_verify_quant(*args, window=window)
                plain32 = lambda tab=table: pd.paged_verify_quant_ref(
                    q.float(), kq, vq, ks, vs, tab, kv_len, window=window)
                plain = lambda: pd.paged_verify_quant_ref(*args,
                                                          window=window)
                kd = (ks.float()[..., None] * kq.float()).to(dt)
                vd = (vs.float()[..., None] * vq.float()).to(dt)
                lib = sdpa_on_gathered(torch, q, kd, vd, table, kv_len,
                                       window)
            else:
                k, v = k32.to(dt), v32.to(dt)
                args = (q, k, v, table, kv_len)
                wrap = pd.paged_verify if name == "paged_verify" \
                    else pp.paged_prefill
                ref = pd.paged_verify_ref if name == "paged_verify" \
                    else pp.paged_prefill_ref
                kern = lambda: wrap(*args, window=window)
                plain32 = lambda tab=table: ref(q.float(), k.float(),
                                                v.float(), tab, kv_len,
                                                window=window)
                plain = lambda: ref(*args, window=window)
                lib = sdpa_on_gathered(torch, q, k, v, table, kv_len,
                                       window)
            out = kern()
            torch.cuda.synchronize()
            want = plain32()
            err, ratio, control = hold(label, dtype, out, want,
                                       plain32(bad_table).to(dt))
            steps = ""
            if name == "paged_verify" and T > 1:
                worst = verify_equals_steps(
                    label, dtype, out, lambda t: pd.paged_verify(
                        q[:, t:t + 1], k, v, table, kv_len - (T - 1 - t)),
                    T)
                steps = (f"; each of the {T} rows equals a T=1 call at its "
                         f"position (max|d| {worst})")
            ms = timer(kern)
            plain_ms = timer(plain)
            lib_ms = timer(lib)
            dev_ms, dev_lib = timer.graph(kern), timer.graph(lib)
            kv_pos, keys = visible(kvl, T, window)
            bms, by = bound_ms(q_elems=q.numel(), elt=q.element_size(),
                               kv_pos=kv_pos, keys=keys, dtype=dtype,
                               kv_elt=1 if quant else None,
                               scale_elt=q.element_size() if quant else 0)
            log(f"  {label} {dtype}: max|err| {err:.3g}, {ratio:.3g}x the "
                f"tolerance (a swapped page: {control:.3g}x){steps}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA on "
                f"pre-gathered pages (library_ms) {lib_ms:.4f} ms, bound "
                f"{bms * 1e3:.2f} us ({by}); replayed from a CUDA graph "
                f"(device alone): kernel {dev_ms:.4f} ms, SDPA "
                f"{dev_lib:.4f} ms")
            # the JSON row: each kernel at the shape it runs most often
            main_shape = label.startswith(("B1 T=1", "B4 T=1", "B2 S=256 "
                                           "kv_len=1024 window=None"))
            if dtype == "bfloat16" and main_shape:
                rows[name] = {"name": name, "route": "cuda",
                              "source": SOURCES[name],
                              "replaces": REPLACES[name],
                              "launches": 0, "max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bms,
                              "bound_by": by, "library_ms": lib_ms}
        del k32, v32, table
    return rows


#: B3 at every projection shape of qwen2.5-14b, (K, N): wq and wo, wk and
#: wv, w_gate and w_up, w_down; M: decode batches, a ragged tile, prefills
Q4_SHAPES = ((5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120))
Q4_MS = (1, 8, 37, 256, 512)
#: B3 at qwen1.5-32b's projection shapes (wq/wk/wv/wo, w_gate/w_up,
#: w_down) at its decode (M = 2) and its verify pass (M = 10, 2 slots x 5)
Q4_SHAPES_32B = ((5120, 5120), (5120, 27392), (27392, 5120))
Q4_MS_32B = (2, 10)
#: B3 at the moe experts' shapes, one expert's slice: mixtral-8x7b's
#: w_gate/w_up and w_down, phi3.5-moe's; M = C, the rows an expert takes:
#: 8 (a decode step of 8 slots, lossless), 160 (a 512-token dense
#: prefill at cf 1.25: int(2 * 512 / 8 * 1.25)) and 256 (a lossless
#: 256-token chunk)
Q4_SHAPES_MOE = ((4096, 14336), (14336, 4096), (4096, 6400), (6400, 4096))
Q4_MS_MOE = (8, 160, 256)
#: B3 at mamba2-780m's in_proj (d_model 1536 -> 2 d_inner + 2 N + nh) and
#: out_proj (d_inner 3072 -> 1536), at decode (M = 1) and a 1024-token
#: prefill, as phase 9's q4 runs launch them
Q4_SHAPES_SSM = ((1536, 6448), (3072, 1536))
Q4_MS_SSM = (1, 1024)
#: B3 at a rank's FFN shard of qwen2.5-14b at tp 2 (w_gate/w_up and
#: w_down, d_ff split over the two members) and M = B/M = 2, the rows a
#: microbatch of phase 18's ring across ranks gives it
Q4_SHAPES_RANK = ((5120, 6912), (6912, 5120))
Q4_MS_RANK = (2,)
Q4_GROUP = 64
#: the JSON row: a decode step of 8 slots at w_gate / w_up, bf16 x
Q4_ROW = (8, 5120, 13824)
Q4_TOL = 1e-5


def q4_within(out, want) -> float:
    """Worst ratio of |out - want| to 1e-5 max|want| + 1e-5 |want| (f32
    sums in another order over K <= 13824)."""
    err = (out - want).abs()
    allowed = Q4_TOL * float(want.abs().max()) + Q4_TOL * want.abs()
    return float((err / allowed).max())


def q4_bound_ms(M, K, N, x_elt):
    """x read once, packed and scales read once, the f32 output written
    once, against 2*M*K*N operations at the bf16 tensor-core peak."""
    nbytes = M * K * x_elt + K // 2 * N + K // Q4_GROUP * N * 2 + M * N * 4
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 2 * M * K * N / PEAK_OPS["bfloat16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def q4_plan_label(q4, M, K, N, dtype) -> str:
    """The route a B3 call takes, as phase 2 names it."""
    plan = q4.q4_plan(M, K, N, Q4_GROUP, x_dtype=dtype)
    rows = (q4.TILE[0] if plan.path == "tile"
            else 8 if M <= 8 else q4.DECODE_ROWS)
    tile = f"{rows}x{q4.TILE[1]}"
    ctas = plan.grid[0] * plan.grid[1] * plan.grid[2]
    return (f"[{plan.path}, split-K {plan.n_split}, tile {tile}, {ctas} "
            f"CTAs, {plan.kernels} CUDA kernel{'s' * (plan.kernels > 1)} "
            f"a call]")


def check_q4(torch, timer, rng):
    """Phase 2, B3; returns its JSON row (the bf16 decode measurement)."""
    from repro_torch.kernels import q4_matmul as q4
    from repro_torch.quant import dequantize_q4, quantize_q4

    row = None
    cases = [(K, N, Q4_MS) for K, N in Q4_SHAPES] + \
        [(K, N, Q4_MS_32B) for K, N in Q4_SHAPES_32B] + \
        [(K, N, Q4_MS_SSM) for K, N in Q4_SHAPES_SSM] + \
        [(K, N, Q4_MS_MOE) for K, N in Q4_SHAPES_MOE] + \
        [(K, N, Q4_MS_RANK) for K, N in Q4_SHAPES_RANK]
    for K, N, m_list in cases:
        w = torch.from_numpy(rng.standard_normal(
            (K, N), dtype=np.float32)).cuda() / np.sqrt(K)
        qt = quantize_q4(w, Q4_GROUP)
        del w
        lib_w = {"float32": dequantize_q4(qt, torch.float32),
                 "bfloat16": dequantize_q4(qt, torch.bfloat16)}
        # negative control: one group of one column with its scale doubled
        bad = qt.scale.clone()
        bad[K // Q4_GROUP // 2, N // 2] *= 2
        for M in m_list:
            x32 = torch.from_numpy(rng.standard_normal(
                (M, K), dtype=np.float32)).cuda()
            for dtype in ("float32", "bfloat16"):
                x = x32.to(getattr(torch, dtype))
                label = (f"B3 M={M} K={K} N={N} {dtype} "
                         f"{q4_plan_label(q4, M, K, N, x.dtype)}")
                kern = lambda: q4.q4_matmul(x, qt.packed, qt.scale,
                                            group=Q4_GROUP)
                plain = lambda s=qt.scale: q4.q4_matmul_ref(
                    x, qt.packed, s, group=Q4_GROUP)
                lib = lambda: x @ lib_w[dtype]
                out = kern()
                torch.cuda.synchronize()
                want = plain()
                if not torch.isfinite(out).all():
                    raise AssertionError(f"{label}: non-finite kernel out")
                err = float((out - want).abs().max())
                ratio = q4_within(out, want)
                if ratio > 1.0:
                    raise AssertionError(f"{label}: max|err| {err}, "
                                         f"{ratio:.3g}x the tolerance")
                control = q4_within(out, plain(bad))
                if control <= 1.0:
                    raise AssertionError(f"{label}: the check does not see "
                                         f"a doubled group scale "
                                         f"({control:.3g}x the tolerance)")
                ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(lib)
                dev_ms, dev_lib = timer.graph(kern), timer.graph(lib)
                bms, by = q4_bound_ms(M, K, N, x.element_size())
                log(f"  {label}: max|err| {err:.3g} (max|ref| "
                    f"{float(want.abs().max()):.3g}), {ratio:.3g}x the "
                    f"tolerance (a doubled group scale: {control:.3g}x); "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS "
                    f"on the dequantized weight (library_ms) {lib_ms:.4f} "
                    f"ms, bound {bms * 1e3:.2f} us ({by}); replayed from a "
                    f"CUDA graph (device alone): kernel {dev_ms:.4f} ms, "
                    f"cuBLAS {dev_lib:.4f} ms")
                if dtype == "bfloat16" and (M, K, N) == Q4_ROW:
                    row = {"name": "q4_matmul", "route": "cuda",
                           "source": Q4_SOURCE,
                           "replaces": REPLACES["q4_matmul"],
                           "launches": 0, "max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bms,
                           "bound_by": by, "library_ms": lib_ms}
        del qt, lib_w, bad
    return row


#: B5 cases: (label, B, T, H, h_kv, D, S, kv_len or None (drawn from
#: [lo, S]), lo, window, int8 cache). The JSON row: qwen1.5-32b's verify
#: at kv_len 1024 over a bf16 cache, in bf16; phase 7 runs the same shape
#: over the int8 cache (the int8 row).
FLASH_CASES = (
    ("B5 32B verify T=5 kv_len=1024", 2, 5, 40, 40, 128, 1024, (1024, 1024),
     0, None, False),
    ("B5 32B verify T=5 kv_len=1024 int8 cache", 2, 5, 40, 40, 128, 1024,
     (1024, 1024), 0, None, True),
    ("B5 32B verify T=5", 2, 5, 40, 40, 128, 1024, None, 128, None, False),
    ("B5 draft decode T=1", 2, 1, 16, 16, 64, 1024, None, 128, None, False),
    ("B5 14B decode T=1", 8, 1, 40, 8, 128, 640, None, 64, None, False),
    # rows of sequence 0 sit before position 0, sequence 3's past the
    # window's reach of the cache: fully masked; kv_len 700 > S
    ("B5 window=64 T=5", 4, 5, 40, 8, 128, 640, (3, 300, 700, 800), 0, 64,
     False),
)
FLASH_ROW = "B5 32B verify T=5 kv_len=1024"


def fully_masked(kv_len, T, S, window):
    """(sequence, row) pairs that see no cache line at all."""
    out = []
    for b, n in enumerate(kv_len):
        for t in range(T):
            qpos = int(n) - T + t
            lo = max(qpos - window + 1, 0) if window else 0
            if min(qpos + 1, S) <= lo:
                out.append((b, t))
    return out


def check_flash(torch, timer, rng):
    """Phase 2, B5; returns its JSON row (the bf16 32B verify)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models.layers import quantize_kv

    row = None
    for label0, B, T, Hh, hk, Dd, S, kvl, lo, window, int8 in FLASH_CASES:
        if kvl is None:
            kvl = rng.integers(lo, S + 1, B)
        kvl = np.asarray(kvl)
        k32 = torch.from_numpy(rng.standard_normal(
            (B, S, hk, Dd), dtype=np.float32) * 0.5).cuda()
        v32 = torch.from_numpy(rng.standard_normal(
            (B, S, hk, Dd), dtype=np.float32) * 0.5).cuda()
        q32 = torch.from_numpy(rng.standard_normal(
            (B, T, Hh, Dd), dtype=np.float32)).cuda()
        kv_len = torch.from_numpy(kvl.astype(np.int32)).cuda()
        # negative control: sequence 1's newest line, which all of its
        # rows see, overwritten with its line 0
        newest = min(int(kvl[1]), S) - 1
        if int8:           # the dense cache's layout: int8 + bf16 scales
            (k8, ks), (v8, vs) = quantize_kv(k32), quantize_kv(v32)
            ks, vs = ks.to(torch.bfloat16), vs.to(torch.bfloat16)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = q32.to(dt)
            if int8:
                k, v, sc = k8, v8, (ks, vs)
            else:
                k, v, sc = k32.to(dt), v32.to(dt), (None, None)
            bad_k, bad_v = k.clone(), v.clone()
            bad_k[1, newest] = k[1, 0]
            bad_v[1, newest] = v[1, 0]
            bad_sc = tuple(None if t is None else t.clone() for t in sc)
            for t in bad_sc:
                if t is not None:
                    t[1, newest] = t[1, 0]
            label = f"{label0} " + tile_label(
                pd, "flash_verify", B, T, Hh, hk, Dd, 1, S,
                torch.int8 if int8 else dt)

            def kern(q=q, kv_len=kv_len):
                return fd.flash_verify(q, k, v, kv_len, window=window,
                                       k_scale=sc[0], v_scale=sc[1])

            def plain32(kk=k, vv=v, s=sc):
                return fd.flash_verify_ref(q.float(), kk, vv, kv_len,
                                           window=window, k_scale=s[0],
                                           v_scale=s[1])

            def plain():
                return fd.flash_verify_ref(q, k, v, kv_len, window=window,
                                           k_scale=sc[0], v_scale=sc[1])

            if int8:
                lib = sdpa_on_cache(torch, q, (ks.float()[..., None]
                                               * k.float()).to(dt),
                                    (vs.float()[..., None]
                                     * v.float()).to(dt), kv_len, window)
            else:
                lib = sdpa_on_cache(torch, q, k, v, kv_len, window)
            out = kern()
            torch.cuda.synchronize()
            want = plain32()
            err, ratio, control = hold(
                label, dtype, out, want,
                plain32(bad_k, bad_v, bad_sc).to(dt))
            for b, t in fully_masked(kvl, T, S, window):
                if float(out[b, t].float().abs().max()) != 0.0:
                    raise AssertionError(f"{label}: fully masked row "
                                         f"({b}, {t}) is not 0")
            steps = ""
            if T > 1:
                worst = verify_equals_steps(
                    label, dtype, out, lambda t: kern(
                        q[:, t:t + 1], kv_len - (T - 1 - t)), T)
                steps = (f"; each of the {T} rows equals a T=1 call at its "
                         f"position (max|d| {worst})")
            ms, plain_ms, lib_ms = timer(kern), timer(plain), timer(lib)
            dev_ms, dev_lib = timer.graph(kern), timer.graph(lib)
            kv_pos, keys = visible(kvl, T, window, S)
            bms, by = bound_ms(q_elems=q.numel(), elt=q.element_size(),
                               kv_pos=kv_pos, keys=keys, dtype=dtype,
                               kv_elt=1 if int8 else None,
                               scale_elt=2 if int8 else 0,
                               h_kv=hk, head_dim=Dd, heads=Hh)
            n_masked = len(fully_masked(kvl, T, S, window))
            log(f"  {label} B={B} H={Hh} h_kv={hk} D={Dd} S={S} kv_len="
                f"{kvl.tolist()} {dtype} ({n_masked} fully masked rows, "
                f"0 as required): max|err| {err:.3g}, {ratio:.3g}x "
                f"the tolerance (an overwritten line: {control:.3g}x)"
                f"{steps}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"SDPA on the {'dequantized ' if int8 else ''}cache "
                f"(library_ms) {lib_ms:.4f} ms, bound {bms * 1e3:.2f} us "
                f"({by}); replayed from a CUDA graph (device alone): kernel "
                f"{dev_ms:.4f} ms, SDPA {dev_lib:.4f} ms")
            if dtype == "bfloat16" and label0 == FLASH_ROW:
                row = {"name": "flash_verify", "route": "cuda",
                       "source": FLASH_SOURCE,
                       "replaces": REPLACES["flash_verify"],
                       "launches": 0, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "library_ms": lib_ms}
        del k32, v32, q32
    return row


#: B5 with its stats at the ring's shard shapes (phase 18 (a)): a
#: microbatch of 2 of qwen2.5-14b's rows over one member's 512 of 1024
#: cache lines. kv_len is counted from the shard's first line: 700 is a
#: member-0 shard whose sequence runs past it; -100 and 0 a shard whose
#: lines no row sees yet (every row: lse -inf, o 0);
#: each over a float and an int8 cache
STATS_CASES = (
    ("B5-stats 14B ring shard T=1", 2, 1, (300, 700), False),
    ("B5-stats 14B ring shard T=5", 2, 5, (300, 700), False),
    ("B5-stats 14B fully masked shard T=5", 2, 5, (-100, 0), False),
    # the int8 ring cache (int8 lines, bf16 scales a line and head)
    ("B5-stats 14B ring shard T=1 int8 cache", 2, 1, (300, 700), True),
    ("B5-stats 14B ring shard T=5 int8 cache", 2, 5, (300, 700), True),
    ("B5-stats 14B fully masked shard T=5 int8 cache", 2, 5, (-100, 0),
     True),
)
STATS_ROW = "B5-stats 14B ring shard T=1"
STATS_S = 512
#: |lse - plain f32 lse| allowed (the scores' f32 sums in another order,
#: and exp2 on the MUFU for bf16 results)
LSE_ATOL = 1e-4


def lse_library(torch, q, k, v, kv_len, window):
    """The library yardstick of B5 with its stats: ATen's memory-efficient
    attention with ``compute_log_sumexp`` (one call that returns the
    output and each row's log-sum-exp), heads expanded and the
    causal-among-drafts mask as an additive bias, beforehand."""
    B, T, H_q = q.shape[:3]
    S = k.shape[1]
    pos = torch.arange(S, device=q.device)
    qpos = kv_len.long()[:, None] - T + torch.arange(T, device=q.device)
    mask = pos[None, None] <= qpos[..., None]
    if window:
        mask &= pos[None, None] > qpos[..., None] - window
    bias = torch.zeros((B, H_q, T, S), dtype=q.dtype, device=q.device)
    bias.masked_fill_(~mask[:, None], float("-inf"))
    n_rep = H_q // k.shape[2]
    kt = k.permute(0, 2, 1, 3).repeat_interleave(n_rep, dim=1)
    vt = v.permute(0, 2, 1, 3).repeat_interleave(n_rep, dim=1)
    qt = q.permute(0, 2, 1, 3).contiguous()

    def call():
        return torch.ops.aten._scaled_dot_product_efficient_attention(
            qt, kt, vt, bias, True)
    return call


def check_flash_stats(torch, timer, rng):
    """Phase 2, B5 with its stats (``flash_verify_stats``: o and lse from
    one launch) at the ring's shard shapes, f32 and bf16, over a float and
    an int8 cache (``k_scale``/``v_scale``), against its plain version
    (``verify_attention_stats``) on q in f32: o by B5's rule, lse within
    ``LSE_ATOL``; a cache whose newest seen line (and its scales) was
    overwritten must fail both; a shard no row sees must give lse -inf and
    o 0 exactly. Returns its JSON row (bf16, T = 1, float cache)."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models.layers import quantize_kv

    row = None
    Hh, hk, Dd, S = H, H_KV, D, STATS_S
    for label0, B, T, kvl, int8 in STATS_CASES:
        kvl = np.asarray(kvl)
        k32 = torch.from_numpy(rng.standard_normal(
            (B, S, hk, Dd), dtype=np.float32) * 0.5).cuda()
        v32 = torch.from_numpy(rng.standard_normal(
            (B, S, hk, Dd), dtype=np.float32) * 0.5).cuda()
        q32 = torch.from_numpy(rng.standard_normal(
            (B, T, Hh, Dd), dtype=np.float32)).cuda()
        kv_len = torch.from_numpy(kvl.astype(np.int32)).cuda()
        masked = bool((kvl <= 0).all())
        if int8:           # the ring cache's layout: int8 + bf16 scales
            (k8, ks), (v8, vs) = quantize_kv(k32), quantize_kv(v32)
            ks, vs = ks.to(torch.bfloat16), vs.to(torch.bfloat16)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            q = q32.to(dt)
            if int8:
                k, v, sc = k8, v8, (ks, vs)
            else:
                k, v, sc = k32.to(dt), v32.to(dt), (None, None)
            label = f"{label0} " + tile_label(
                pd, "flash_verify", B, T, Hh, hk, Dd, 1, S,
                torch.int8 if int8 else dt)

            def kern(q=q, k=k, v=v, sc=sc):
                return fd.flash_verify_stats(q, k, v, kv_len, k_scale=sc[0],
                                             v_scale=sc[1])

            def plain32(kk=k, vv=v, s=sc):
                return fd.flash_verify_stats_ref(q.float(), kk, vv, kv_len,
                                                 k_scale=s[0], v_scale=s[1])

            def plain():
                return fd.flash_verify_stats_ref(q, k, v, kv_len,
                                                 k_scale=sc[0],
                                                 v_scale=sc[1])

            o, lse = kern()
            torch.cuda.synchronize()
            want_o, want_lse = plain32()
            fin = torch.isfinite(want_lse)
            if not torch.equal(torch.isfinite(lse), fin):
                raise AssertionError(f"{label} {dtype}: lse is finite on "
                                     f"other rows than the plain version's")
            if masked:
                if fin.any() or o.abs().max() != 0 or bool(
                        (lse != float("-inf")).any()):
                    raise AssertionError(f"{label} {dtype}: a shard no row "
                                         f"sees must give lse -inf, o 0")
                log(f"  {label} B={B} T={T} S={S} kv_len={kvl.tolist()} "
                    f"{dtype}: every row lse -inf and o 0, as required")
                continue
            # negative control: sequence 1's newest line, which all of its
            # rows see, overwritten with its line 0 (scales too)
            newest = min(int(kvl[1]), S) - 1
            bad_k, bad_v = k.clone(), v.clone()
            bad_k[1, newest], bad_v[1, newest] = k[1, 0], v[1, 0]
            bad_sc = tuple(None if t is None else t.clone() for t in sc)
            for t in bad_sc:
                if t is not None:
                    t[1, newest] = t[1, 0]
            ctrl_o, ctrl_lse = plain32(bad_k, bad_v, bad_sc)
            err, ratio, control = hold(label, dtype, o, want_o,
                                       ctrl_o.to(dt))
            lse_err = float((lse[fin] - want_lse[fin]).abs().max())
            lse_ctrl = float((ctrl_lse[fin] - want_lse[fin]).abs().max())
            if lse_err > LSE_ATOL or lse_ctrl <= LSE_ATOL:
                raise AssertionError(
                    f"{label} {dtype}: lse max|err| {lse_err:.3g} (limit "
                    f"{LSE_ATOL}); the overwritten line moves it by "
                    f"{lse_ctrl:.3g}")
            ms, plain_ms = timer(kern), timer(plain)
            dev_ms = timer.graph(kern)
            if int8:
                kl = (ks.float()[..., None] * k.float()).to(dt)
                vl = (vs.float()[..., None] * v.float()).to(dt)
            else:
                kl, vl = k, v
            try:
                lib = lse_library(torch, q, kl, vl, kv_len, None)
                lib()
                lib_ms, dev_lib = timer(lib), timer.graph(lib)
                lib_text = (f"ATen efficient attention with its log-sum-exp"
                            f" on the {'dequantized ' if int8 else ''}cache "
                            f"(library_ms) {lib_ms:.4f} ms (device "
                            f"{dev_lib:.4f})")
            except RuntimeError as e:
                lib_ms = None
                lib_text = (f"ATen efficient attention refused the shape "
                            f"({str(e).splitlines()[0]}): library_ms null")
            kv_pos, keys = visible(kvl, T, None, S)
            bms, by = bound_ms(q_elems=q.numel(), elt=q.element_size(),
                               kv_pos=kv_pos, keys=keys, dtype=dtype,
                               kv_elt=1 if int8 else None,
                               scale_elt=2 if int8 else 0,
                               h_kv=hk, head_dim=Dd, heads=Hh,
                               extra_bytes=B * Hh * T * 4)
            log(f"  {label} B={B} H={Hh} h_kv={hk} D={Dd} S={S} kv_len="
                f"{kvl.tolist()} {dtype}: o max|err| {err:.3g}, {ratio:.3g}x"
                f" the tolerance (an overwritten line: {control:.3g}x); lse "
                f"max|err| {lse_err:.3g} (limit {LSE_ATOL}; the overwritten "
                f"line: {lse_ctrl:.3g}); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, {lib_text}, bound {bms * 1e3:.2f} us "
                f"({by}); replayed from a CUDA graph (device alone): kernel "
                f"{dev_ms:.4f} ms")
            if dtype == "bfloat16" and label0 == STATS_ROW:
                row = {"name": "flash_verify_stats", "route": "cuda",
                       "source": FLASH_SOURCE,
                       "replaces": REPLACES["flash_verify_stats"],
                       "launches": 0, "max_abs_err": max(err, lse_err),
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "library_ms": lib_ms}
        del k32, v32, q32
    return row


#: head dims off the main path: the tiles are staged zero-padded to 64
#: (D 16: the CI smokes' reduced configs), 128 (96) and 256 (256)
HEAD_DIMS = (16, 96, 256)


def check_head_dims(torch, rng):
    """Phase 2 at D = 16, 96 and 256: B1 (T 1 and 5), B2 (a 48-row chunk),
    B4 (T 1, and a 40-row chunk: design 1) and B5 (T 5, a window, kv_len
    past a ragged S; float and int8 cache) in f32 and bf16, each held to
    the phase-2 rule with its negative control, and B1's and B5's verify
    rows to single steps, exactly. Not timed."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import paged_prefill as pp
    from repro_torch.models.layers import quantize_kv

    Hq, hk, B, nb, S = 8, 2, 3, 32, 300
    for Dd in HEAD_DIMS:
        cases = [("paged_verify", 1), ("paged_verify", 5),
                 ("paged_prefill", 48), ("paged_verify_quant", 1),
                 ("paged_verify_quant", 40), ("flash_verify", 5),
                 ("flash_int8", 5)]
        for name, T in cases:
            q32 = torch.from_numpy(rng.standard_normal(
                (B, T, Hq, Dd), dtype=np.float32)).cuda()
            flash = name.startswith("flash")
            kvl = np.array([S - 7, S + 9, 150]) if flash else \
                rng.integers(T + 60, nb * BS + 1, B)
            kv_len = torch.from_numpy(kvl.astype(np.int32)).cuda()
            if flash:
                k32 = torch.from_numpy(rng.standard_normal(
                    (B, S, hk, Dd), dtype=np.float32) * 0.5).cuda()
                v32 = torch.from_numpy(rng.standard_normal(
                    (B, S, hk, Dd), dtype=np.float32) * 0.5).cuda()
                newest = min(int(kvl[1]), S) - 1
            else:
                k32, v32, table = make_pages(torch, rng, B=B, nb=nb,
                                             kv_len=kvl, h_kv=hk,
                                             head_dim=Dd)
                bad_table = table.clone()
                last = (int(kvl[-1]) - 1) // BS
                bad_table[-1, last] = table[-1, 0]
            window = 64 if flash else None
            int8 = name in ("paged_verify_quant", "flash_int8")
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                q = q32.to(dt)
                if int8:    # scales: the dense cache's bf16, a pool's dtype
                    sdt = torch.bfloat16 if flash else dt
                    (k, ks), (v, vs) = quantize_kv(k32), quantize_kv(v32)
                    ks, vs = ks.to(sdt), vs.to(sdt)
                else:
                    k, v, ks, vs = k32.to(dt), v32.to(dt), None, None
                pool = torch.int8 if int8 else dt
                if flash:
                    label = f"B5 D={Dd} T={T}{' int8' if int8 else ''} " + \
                        tile_label(pd, "flash_verify", B, T, Hq, hk, Dd, 1,
                                   S, pool)
                    bk, bv = k.clone(), v.clone()
                    bk[1, newest], bv[1, newest] = k[1, 0], v[1, 0]

                    def kern(qq=q, n=kv_len):
                        return fd.flash_verify(qq, k, v, n, window=window,
                                               k_scale=ks, v_scale=vs)

                    def plain32(kk=k, vv=v):
                        return fd.flash_verify_ref(q.float(), kk, vv, kv_len,
                                                   window=window, k_scale=ks,
                                                   v_scale=vs)
                    control = plain32(bk, bv)
                else:
                    tag = {"paged_verify": "B1", "paged_prefill": "B2",
                           "paged_verify_quant": "B4"}[name]
                    label = f"{tag} D={Dd} T={T} " + tile_label(
                        pd, name, B, T, Hq, hk, Dd, BS, nb, pool)
                    if int8:
                        def kern(qq=q, n=kv_len):
                            return pd.paged_verify_quant(qq, k, v, ks, vs,
                                                         table, n)

                        def plain32(tab=table):
                            return pd.paged_verify_quant_ref(
                                q.float(), k, v, ks, vs, tab, kv_len)
                    else:
                        wrap = pp.paged_prefill if name == "paged_prefill" \
                            else pd.paged_verify
                        ref = pp.paged_prefill_ref \
                            if name == "paged_prefill" else pd.paged_verify_ref

                        def kern(qq=q, n=kv_len, wrap=wrap):
                            return wrap(qq, k, v, table, n)

                        def plain32(tab=table, ref=ref):
                            return ref(q.float(), k.float(), v.float(), tab,
                                       kv_len)
                    control = plain32(bad_table)
                out = kern()
                torch.cuda.synchronize()
                want = plain32()
                err, ratio, c = hold(label, dtype, out, want, control.to(dt))
                steps = ""
                if T == 5 and name != "paged_verify_quant":
                    verify_equals_steps(label, dtype, out, lambda t: kern(
                        q[:, t:t + 1], kv_len - (T - 1 - t)), T)
                    steps = "; verify rows equal single steps exactly"
                log(f"  {label} {dtype}: max|err| {err:.3g}, {ratio:.3g}x "
                    f"the tolerance (negative control: {c:.3g}x){steps}")
            del k32, v32


#: mamba2-780m's SSD geometry: 48 heads of P 64, state N 128, d_inner 3072
SSD_NH, SSD_P, SSD_N = 48, 64, 128
SSD_DI = SSD_NH * SSD_P
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_scan.cu"
#: (label, B, S, strided): prefill shapes of phase 9; ``strided`` reads x,
#: B and C as the views of one conv output that ``ssd_block`` passes
SSD_CASES = (
    ("B6 prefill S=1024", 1, 1024, True),
    ("B6 prefill S=1024 contiguous", 1, 1024, False),
    ("B6 prefill S=1000", 1, 1000, True),
    ("B6 prefill S=77", 1, 77, True),
    ("B6 prefill B=2 S=512", 2, 512, True),
)
SSD_ROW = "B6 prefill S=1024"
SSD_TOL = 1e-5


def ssd_inputs(torch, rng, B, S, strided):
    """f32 x, dt, A, B, C at mamba2-780m's head geometry. dt is small
    (softplus of N(-4, 1), ~0.02) so the state carries across chunk
    boundaries (at the model's init, dt A is ~ -10 and a chunk forgets its
    past): the check below must see a state lost between chunks."""
    xbc = rng.standard_normal((B, S, SSD_DI + 2 * SSD_N),
                              dtype=np.float32)
    xbc[..., :SSD_DI] *= 0.5
    xbc[..., SSD_DI:] *= 0.3
    xbc = torch.from_numpy(xbc).cuda()
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, SSD_NH), dtype=np.float32) - 4.0)).cuda()
    A = -torch.from_numpy(np.exp(rng.standard_normal(
        SSD_NH).astype(np.float32) * 0.5)).cuda()
    if not strided:
        xbc = xbc.contiguous()
    x = xbc[..., :SSD_DI].reshape(B, S, SSD_NH, SSD_P)
    Bm, Cm = xbc[..., SSD_DI:SSD_DI + SSD_N], xbc[..., SSD_DI + SSD_N:]
    if not strided:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    return x, dt, A, Bm, Cm


def ssd_within(out, want, dtype) -> float:
    """Worst ratio of |out - want| to what the dtype allows, per element.
    f32: 1e-5 max|want| + 1e-5 |want| (f32 sums in another order); bf16:
    1e-5 + 2^-7 |want| (the outputs' one rounding, at most one ulp)."""
    err = (out.float() - want.float()).abs()
    want = want.float().abs()
    if dtype == "float32":
        allowed = SSD_TOL * float(want.max()) + SSD_TOL * want
    else:
        allowed = 1e-5 + 2.0 ** -7 * want
    return float((err / allowed).max())


def ssd_bound_ms(B, S, dtype, elt):
    """x read once, y written once (x's dtype), dt read once (f32), B and
    C read once, h written once, against the chunk products: C B^T once a
    chunk (shared by the heads) and, per head, the intra-chunk (t, s) x
    (s, P), C h^T and the state update, at the dtype's peak."""
    nbytes = B * (2 * S * SSD_DI * elt + S * SSD_NH * 4 + 2 * S * SSD_N * elt
                  + SSD_NH * SSD_P * SSD_N * elt) + SSD_NH * 4
    flops = 0
    for c0 in range(0, S, 128):
        n = min(128, S - c0)
        flops += B * (2 * n * n * SSD_N + SSD_NH * (2 * n * n * SSD_P
                                                    + 4 * n * SSD_N * SSD_P))
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_ssd(torch, timer, rng):
    """Phase 2, B6; returns its JSON row (bf16, B 1, S 1024, strided)."""
    from repro_torch.kernels import ssd_scan as ss

    row = None
    for label, B, S, strided in SSD_CASES:
        args32 = ssd_inputs(torch, rng, B, S, strided)
        for dtype in ("float32", "bfloat16"):
            dt_ = getattr(torch, dtype)
            if dtype == "float32":
                x, dtv, A, Bm, Cm = args32
            else:                      # one bf16 conv output, viewed again
                x, dtv, A, Bm, Cm = (args32[0].to(dt_), args32[1],
                                     args32[2], args32[3].to(dt_),
                                     args32[4].to(dt_))
                if strided:
                    xbc = torch.cat([args32[0].flatten(2), args32[3],
                                     args32[4]], -1).to(dt_)
                    x = xbc[..., :SSD_DI].reshape(B, S, SSD_NH, SSD_P)
                    Bm = xbc[..., SSD_DI:SSD_DI + SSD_N]
                    Cm = xbc[..., SSD_DI + SSD_N:]
            if strided and x.is_contiguous():
                raise AssertionError(f"{label}: x is not a strided view")
            kern = lambda: ss.ssd_scan(x, dtv, A, Bm, Cm)
            plain = lambda: ss.ssd_scan_ref(x, dtv, A, Bm, Cm)
            y, h = kern()
            torch.cuda.synchronize()
            y_ref, h_ref = plain()
            if torch.isnan(y).any() or torch.isnan(h).any():
                raise AssertionError(f"{label} {dtype}: NaN in kernel out")
            err = max(float((y.float() - y_ref.float()).abs().max()),
                      float((h.float() - h_ref.float()).abs().max()))
            ratio = max(ssd_within(y, y_ref, dtype),
                        ssd_within(h, h_ref, dtype))
            if ratio > 1.0:
                raise AssertionError(f"{label} {dtype}: max|err| {err}, "
                                     f"{ratio:.3g}x the tolerance")
            control = None
            if S > 128:
                # negative control: the state reset at the second chunk's
                # boundary (the scan restarted from zero at position 128)
                y1, _ = ss.ssd_scan_ref(x[:, :128], dtv[:, :128], A,
                                        Bm[:, :128], Cm[:, :128])
                y2, h2 = ss.ssd_scan_ref(x[:, 128:], dtv[:, 128:], A,
                                         Bm[:, 128:], Cm[:, 128:])
                control = max(ssd_within(torch.cat([y1, y2], 1), y_ref,
                                         dtype),
                              ssd_within(h2, h_ref, dtype))
                if control <= 1.0:
                    raise AssertionError(
                        f"{label} {dtype}: the check does not see a state "
                        f"reset at position 128 ({control:.3g}x the "
                        f"tolerance)")
            ms, plain_ms = timer(kern), timer(plain)
            dev_ms = timer.graph(kern)
            bms, by = ssd_bound_ms(B, S, dtype, x.element_size())
            plan = ss.ssd_plan(B, S, SSD_NH)
            log(f"  {label} B={B} nh={SSD_NH} P={SSD_P} N={SSD_N} "
                f"{'strided' if strided else 'contiguous'} {dtype}: "
                f"max|err| {err:.3g} (y and h), {ratio:.3g}x the "
                f"tolerance (a state reset at 128: "
                f"{'n/a' if control is None else f'{control:.3g}x'}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bms * 1e3:.2f} us ({by}); replayed from a CUDA graph "
                f"(device alone): kernel {dev_ms:.4f} ms [{plan.n_chunks} "
                f"chunks, {plan.grid} CTAs in each (b, chunk, head) kernel "
                f"on {torch.cuda.get_device_properties(0).multi_processor_count}"
                f" SMs, {plan.kernels} CUDA kernels a call]")
            if dtype == "bfloat16" and label == SSD_ROW:
                # no single PyTorch call computes the scan: library_ms null
                row = {"name": "ssd_scan", "route": "cuda",
                       "source": SSD_SOURCE,
                       "replaces": REPLACES["ssd_scan"], "launches": 0,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bms, "bound_by": by, "library_ms": None}
        del args32
    return row


# --------------------------------------------------------------------------- #
#  phases 3 and 4
# --------------------------------------------------------------------------- #

#: phase 3's depth: 24 of qwen2.5-14b's 48 layers (cut for time; phases
#: 5, 13, 14 (b) and 18 run all 48)
PAGED_LAYERS = 24
SERVE_ARGS = ["--arch", "qwen2.5-14b", "--batch", "8", "--ctx", "2048",
              "--page-tokens", "16", "--prefill-chunk", "256",
              "--prompt-len", "256", "--prompt-len-max", "1025",
              "--requests", "16", "--new-tokens", "32", "--seed", "0"]


def check_served(res) -> None:
    fin, n = res["finished"], len(res["requests"])
    if res["rejected"] or len(fin) != n:
        raise AssertionError(f"{len(fin)} of {n} requests finished, "
                             f"{len(res['rejected'])} shed")
    want = {r.uid: r.max_new_tokens for r in res["requests"]}
    for f in fin:
        if len(f.tokens) != want[f.uid]:
            raise AssertionError(f"request {f.uid}: {len(f.tokens)} tokens"
                                 f", wanted {want[f.uid]}")


def serve_full(torch, ops, serve):
    """Phase 3: the main path at full width; returns the launch counts of
    its two main runs (bf16 and int8 pages).

    Every layer calls one kernel per prompt chunk and one per decode step.
    Float pages admit through B2 and decode through B1; int8 pages do both
    through B4. Each request runs to ``max_new`` (checked), so the schedule
    depends on lengths alone and the int8 run makes exactly the bf16 run's
    B1 + B2 launches, all of them B4. The engine replays its decode step
    and its full chunks from CUDA graphs (the counts are the graphs'
    replays times what each capture launched). With the weights on the
    card, phase 12's runs follow (``graphed_against_eager``)."""
    ops.reset_launch_counts()
    deltas = {}
    for quant in (False, True):
        argv = SERVE_ARGS + ["--dtype", "bf16", "--layers",
                             str(PAGED_LAYERS)]
        if quant:
            argv.append("--kv-quant-kernel")
        args = serve.parse_args(argv)
        t0 = time.perf_counter()
        cfg, params = serve.build_model(args)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in params.parameters())
        log(f"  weights: {n / 1e9:.2f} B params in bf16 on the card, made "
            f"in {time.perf_counter() - t0:.1f} s")
        reqs = serve.make_requests(cfg, args)
        before = ops.launch_counts()
        res = serve.serve_paged(params, cfg, reqs, args)
        res["requests"] = reqs
        serve.report(res, args)
        check_served(res)
        after = ops.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        chunk = args.prefill_chunk
        chunks = cfg.n_layers * sum(-(-len(r.prompt) // chunk)
                                    for r in reqs)
        if quant:
            f = deltas[False]
            want = {"paged_verify": 0, "paged_prefill": 0,
                    "paged_verify_quant": f["paged_verify"]
                    + f["paged_prefill"]}
        else:
            want = {"paged_prefill": chunks, "paged_verify_quant": 0}
        for k, n in want.items():
            if delta[k] != n:
                raise AssertionError(
                    f"{'int8' if quant else 'bf16'} run: {k} launched "
                    f"{delta[k]} times, wanted {n} ({chunks} layer-chunks)")
        if not quant and delta["paged_verify"] < cfg.n_layers:
            raise AssertionError("bf16 run: paged_verify never launched")
        deltas[quant] = delta
        eng = res["engine"]
        log(f"  launches in this run: {delta} ({chunks} layer-chunks); "
            f"graphs: {graph_note(eng)}")
        graphed_against_eager(torch, ops, serve, params, cfg, reqs, args,
                              res, delta, "int8" if quant else "bf16")
        if not quant:
            check_dense_bf16(torch, ops, serve, params, cfg, reqs, args, res)
        del params, res, eng
        gc.collect()
        torch.cuda.empty_cache()
    return {k: deltas[False][k] + deltas[True][k] for k in deltas[False]}


def graph_note(eng) -> str:
    """An engine's graphs: chunks each way, captures, their seconds and
    the device memory they reserved."""
    sg, cs = eng.graphs, eng.chunk_step
    note = (f"{sg.captures} captures in {sg.capture_s:.3f} s, "
            f"{sg.pool_bytes / 1e6:.1f} MB reserved by them, replays "
            f"{dict(sg.replays)}")
    if hasattr(cs, "graphed"):
        note += f"; chunks graphed {cs.graphed}, eager {cs.eager}"
    return note


def warm_profiler(torch) -> None:
    """Start and stop ``torch.profiler`` once over a small product, so its
    first start (the CUDA tracer's set-up, seconds) lands in no timed
    run."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones((64, 64), device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (x @ x).sum().item()


def graphed_against_eager(torch, ops, serve, params, cfg, reqs, args, res,
                          delta, label):
    """Phase 12's paged runs (recorded in ``PHASE12``): the same requests
    eagerly (``graphs=False``) and graphed again, both keeping every
    token's logits (max|d| between them: the same kernels run in the same
    order), timing every step and chunk and running the engine's
    ``PROFILE_STEP``-th step in a profiler window. The eager run must
    make the main run's exact launches, and both its streams."""
    traced, main = {}, {f.uid: f.tokens for f in res["finished"]}
    warm_profiler(torch)
    for graphs in (False, True):
        way = "graphed" if graphs else "eager"
        before = ops.launch_counts()
        traced[way] = traced_paged_run(
            torch, params, cfg, reqs, args, graphs=graphs,
            dtype=torch.bfloat16,
            profile_step=(PROFILE_STEP, f"profile_{label}_{way}"))
        after = ops.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if traced[way][0] != main or got != delta:
            raise AssertionError(f"{label} pages, {way} run: launches {got}"
                                 f" (the main run's: {delta}); streams equal"
                                 f" to the main run's: "
                                 f"{traced[way][0] == main}")
        PHASE12["profile"][(label, way)] = traced[way][3]
    worst = max(float((traced["graphed"][1][k] - v).abs().max())
                for k, v in traced["eager"][1].items())
    PHASE12["paged"][label] = dict(
        serve._p50_summary(res["finished"], res["wall_s"]),
        wall_s=res["wall_s"], steps=res["steps"], launches=delta,
        logit_max_abs_d=worst, n_logits=len(traced["eager"][1]),
        graphs=graph_note(res["engine"]))
    log(f"  {label} pages, eager and graphed again (logits kept, steps "
        f"timed): the main run's launches and streams; logits max|d| "
        f"{worst:.3g} over {len(traced['eager'][1])} tokens")
    del traced


def check_dense_bf16(torch, ops, serve, params, cfg, reqs, args, res):
    """Phase 3, the ``--check-dense`` path: the dense-cache engine on the
    same requests and weights, 48 B5 launches a decode step and no other
    attention kernel. bf16 streams are compared, not asserted: the dense
    prefill sums its bf16 scores in another order than B2 (phase 4
    asserts dense-vs-paged equality in f32)."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.engine import make_dense_engine

    eng = make_dense_engine(params, cfg, args.batch, args.ctx,
                            cache_dtype=torch.bfloat16, device=args.device)
    cache = init_cache(cfg, args.batch, args.ctx, dtype=torch.bfloat16,
                       device=args.device)
    before = ops.launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin, steps = eng.run(cache, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_served({"finished": fin, "rejected": eng.rejected,
                  "requests": reqs})
    after = ops.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    want = {k: 0 for k in delta}
    want["flash_verify"] = cfg.n_layers * steps
    if delta != want:
        raise AssertionError(f"dense engine: launches {delta}, wanted "
                             f"{want} ({steps} decode steps x "
                             f"{cfg.n_layers} layers of B5)")
    paged = {f.uid: f.tokens for f in res["finished"]}
    n_equal = sum(f.tokens == paged[f.uid] for f in fin)
    summ = serve._p50_summary(fin, wall)
    log(f"  dense engine (bf16 cache): {len(fin)} requests, {steps} decode "
        f"steps, wall {wall:.3f} s, TTFT p50 {summ['ttft_p50_s'] * 1e3:.2f}"
        f" ms, TPOT p50 {summ['tpot_p50_s'] * 1e3:.2f} ms, "
        f"{summ['tokens_per_s']:.2f} tokens/s; {delta['flash_verify']} B5 "
        f"launches = {steps} steps x {cfg.n_layers} layers; streams equal "
        f"to the paged run's for {n_equal} of {len(fin)}")
    del cache, eng
    gc.collect()
    torch.cuda.empty_cache()


LOGIT_REL = 2e-4      # the repo's logit bound (tests/test_torch_model.py)


#: the engine step (``eng.step`` calls, chunk-interleaved ones included)
#: that phase 12 runs inside a profiler window: a decode step of the
#: second wave of admissions, every slot busy
PROFILE_STEP = 30
#: phase 12's record: filled by phases 3 and 7 while their weights are on
#: the card, printed and checked by phase 12
PHASE12 = {"paged": {}, "profile": {}, "spec": {}, "trace": None}


def out_path(name: str) -> str:
    """A file under the git-ignored ``chiprun_out/``."""
    d = os.path.join(ROOT, "chiprun_out")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, name)


def device_busy(events) -> float:
    """Microseconds covered by the union of ``events``' [ts, ts + dur)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


class profile_window:
    """Run an engine's n-th step inside a ``torch.profiler`` window (after
    a device sync, so no earlier work is in it): the step's host wall (a
    step ends in its host sync), the device's busy time (the union of the
    kernel, memcpy and memset intervals of the trace), the idle share (1 -
    busy / wall), the five device ops with most time and the five host
    ops with most self time. The trace goes to ``chiprun_out/<label>.json``,
    written by ``result()`` once the run is over."""

    def __init__(self, torch, eng, n, label):
        self.window, self.label = None, label
        step, count = eng.step, [0]

        def step_(cache, tokens):
            count[0] += 1
            if count[0] != n:
                return step(cache, tokens)
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = step(cache, tokens)
                wall = time.perf_counter() - t0
            self.window = (prof, wall)
            return out
        eng.step = step_

    @staticmethod
    def _summarize(prof, wall, label):
        path = out_path(f"{label}.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        busy_ms = device_busy(dev) / 1e3
        by_name = {}
        for e in dev:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        top_dev = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        host = sorted(prof.key_averages(),
                      key=lambda a: -a.self_cpu_time_total)[:5]
        return {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
                "idle": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
                "device_events": len(dev), "trace": os.path.relpath(path,
                                                                   ROOT),
                "top_device": [(n[:60], d / 1e3) for n, d in top_dev],
                "top_host": [(a.key[:60], a.self_cpu_time_total / 1e3,
                              a.count) for a in host]}

    def result(self):
        if self.window is None:
            raise AssertionError("the profiled step never ran")
        return self._summarize(*self.window, self.label)


def traced_paged_run(torch, params, cfg, reqs, args, *, graphs=False,
                     dtype=None, profile_step=None, count=None):
    """The paged engine as ``serve.serve_paged`` builds it (f32 pages
    unless ``dtype``), keeping the logits behind every greedy token by
    (uid, token index): the last chunk's last row for token 0, the decode
    step's row after that. ``graphs``: replay the steps from CUDA graphs
    (only with the kernels' own wrappers in place). ``profile_step``:
    (n, label) runs the engine's n-th step inside a ``torch.profiler``
    window (``profile_window``) and times every step and chunk between
    device syncs (median ms of decode steps, full chunks and ragged
    chunks), and the run's wall, TTFT and TPOT p50 (the logit copies,
    the timers' syncs and the profiled step included). Returns (streams,
    logits, pages, the window's summary with those numbers, or None)."""
    from repro_torch.runtime.kvcache import make_paged_engine

    B, bs = args.batch, args.page_tokens
    eng, kv = make_paged_engine(params, cfg, B, args.ctx,
                                n_pages=2 + B * (-(-args.ctx // bs)),
                                page_tokens=bs,
                                cache_dtype=dtype or torch.float32,
                                prefill_chunk=args.prefill_chunk,
                                graphs=graphs, device=args.device)
    logits, admitting = {}, []
    admit, chunk_step, decode = eng.admit, eng.chunk_step, eng.decode

    def admit_(cache, tokens, uid, *a, **k):
        admitting.append(uid)
        return admit(cache, tokens, uid, *a, **k)

    def chunk_step_(*a, **k):
        out = chunk_step(*a, **k)
        logits[(admitting[-1], 0)] = out[0][0, -1].float().clone()
        return out

    def decode_(cache, tokens):
        out = decode(cache, tokens)
        if count is not None:
            count[0] += 1
        for i in eng.active():
            st = eng.slots[i]
            key = (st.uid, len(st.generated))
            logits[key] = out[0][i, 0].float().clone()
        return out

    eng.admit, eng.chunk_step, eng.decode = admit_, chunk_step_, decode_
    window, times = None, {"step": [], "chunk": [], "ragged": []}
    if profile_step is not None:
        window = profile_window(torch, eng, *profile_step)

        def timed(fn, key):
            def call(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                kind = key(*a) if callable(key) else key
                times[kind].append(1e3 * (time.perf_counter() - t0))
                return out
            return call
        eng.step = timed(eng.step, "step")
        eng.chunk_step = timed(eng.chunk_step, lambda view, t, *a: (
            "chunk" if t.shape[1] == eng.prefill_chunk else "ragged"))
    cache = kv.init_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin, steps = eng.run(cache, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_served({"finished": fin, "rejected": eng.rejected,
                  "requests": reqs})
    summary = None
    if window is not None:
        tpots = [f.tpot_s for f in fin if len(f.tokens) > 1]
        summary = dict(window.result(), **{
            f"{k}_ms": (float(np.median(v)), len(v))
            for k, v in times.items()}, wall_s=wall, steps=steps,
            ttft_p50_s=float(np.median([f.ttft_s for f in fin])),
            tpot_p50_s=float(np.median(tpots)),
            graphs=graph_note(eng) if graphs else None)
    return ({f.uid: f.tokens for f in fin}, logits, cache["pages"],
            summary)


def compare_runs(kern, plain):
    """Two traced runs, token by token. Up to each stream's first
    difference the contexts are equal, so the logits there measure the
    two paths' numerical agreement; a differing token ends the comparison
    of its stream. Returns (worst max|d|/max|ref|, streams equal,
    [(uid, token, top-2 gap / max|ref|, max|d|/max|ref| there)]). A run
    may carry more than (tokens, logits); the rest is not compared."""
    (sk, lk), (sp, lp) = kern[:2], plain[:2]
    worst, n_equal, splits = 0.0, 0, []
    for uid, toks in sp.items():
        n_equal += sk[uid] == toks
        for n, tok in enumerate(toks):
            a, b = lk[(uid, n)], lp[(uid, n)]
            top = float(b.abs().max())
            rel = float((a - b).abs().max()) / top
            worst = max(worst, rel)
            if sk[uid][n] != tok:
                splits.append((uid, n, float(b[tok] - b[sk[uid][n]]) / top,
                               rel))
                break
    return worst, n_equal, splits


def int8_flips(torch, a, b):
    """Two runs' final int8 pools: the (layer, page) pairs whose K or V
    bytes differ, the bytes that differ, and the pairs in all."""
    pairs = torch.zeros(a["k"].shape[:2], dtype=torch.bool,
                        device=a["k"].device)
    n_bytes = 0
    for name in ("k", "v"):
        d = a[name] != b[name]
        pairs |= d.flatten(2).any(-1)
        n_bytes += int(d.sum())
    return int(pairs.sum()), n_bytes, pairs.numel()


@contextlib.contextmanager
def substituted(ops, mode, errs=None):
    """Stand-ins (phases 4, 6, 8 and 10) for the kernel wrappers the model
    path calls. ``"shadow"``: each launch also runs the plain version on
    the same inputs, and ``errs`` keeps the largest max|d| by kernel (for
    B3 divided by the launch's max|ref|; for B6 the ratio to phase 2's
    per-element tolerance, over y and h). ``"plain"``:
    the model takes the card's route (kernels reported active) with each
    wrapper replaced by its plain version: one more plain run, summing in
    another order than ``use_kernels(False)``'s."""
    from repro_torch.kernels import (flash_decode, paged_decode,
                                     paged_prefill, q4_matmul, ssd_scan)

    saved = []
    for mod, name in ((paged_decode, "paged_verify"),
                      (paged_prefill, "paged_prefill"),
                      (paged_decode, "paged_verify_quant"),
                      (q4_matmul, "q4_matmul"),
                      (flash_decode, "flash_verify"),
                      (ssd_scan, "ssd_scan")):
        kern, ref = getattr(mod, name), getattr(mod, name + "_ref")

        def shadow(*a, kern=kern, ref=ref, name=name, **k):
            out = kern(*a, **k)
            want = ref(*a, **k)
            if name == "ssd_scan":           # (y, h): ratio to phase 2's bound
                dtype = str(out[0].dtype).replace("torch.", "")
                d = max(ssd_within(o, w, dtype) for o, w in zip(out, want))
            else:
                want = want.float()
                d = float((out.float() - want).abs().max())
                top = float(want.abs().max())
                if name == "q4_matmul" and top:  # relative to max|ref|
                    d /= top                     # (an expert given no row
                                                 # multiplies zeros: 0)
            errs[name] = max(errs.get(name, 0.0), d)
            return out

        saved.append((mod, name, kern))
        setattr(mod, name, shadow if mode == "shadow" else ref)
    active = ops.kernels_active
    if mode == "plain":
        ops.kernels_active = lambda t: True
    try:
        yield
    finally:
        ops.kernels_active = active
        for mod, name, kern in saved:
            setattr(mod, name, kern)


def parity(torch, ops, serve) -> None:
    """Phase 4, on a ``PARITY_LAYERS``-layer full-width f32 copy: the paged
    engine (chunked, f32 and int8 pages) with kernels against
    ``use_kernels(False)``, and dense against paged.

    Every kernel launch of the kernel runs is held against its plain
    version on the same inputs (f32, atol 2e-5). With f32 pages the logits
    must then agree to LOGIT_REL and the streams be equal. With int8 pages
    the streams can split: a ~1e-7 difference moves a value across an int8
    rounding boundary when it is written to the pool, and the network
    carries that one-step change to the logits. Two plain versions that
    only sum in another order split the same way; that control is run and
    printed beside the kernel's numbers."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.engine import make_dense_engine

    args = serve.parse_args(SERVE_ARGS + ["--dtype", "f32", "--layers",
                                          str(PARITY_LAYERS)])
    cfg, params = serve.build_model(args)
    reqs = serve.make_requests(cfg, args)
    streams = {}
    for quant in (False, True):
        c = dataclasses.replace(cfg, kv_dtype="int8") if quant else cfg
        label = f"{'int8' if quant else 'f32'} pages"
        errs = {}
        with substituted(ops, "shadow", errs):
            kern = traced_paged_run(torch, params, c, reqs, args)
        ops.use_kernels(False)
        try:
            plain = traced_paged_run(torch, params, c, reqs, args)
        finally:
            ops.use_kernels(True)
        streams[quant] = kern[0]
        want = ("paged_verify_quant",) if quant else ("paged_verify",
                                                      "paged_prefill")
        if sorted(errs) != sorted(want) or max(errs.values()) > 2e-5:
            raise AssertionError(f"{label}: kernel launches against their "
                                 f"plain versions on the same inputs: "
                                 f"max|d| {errs} (atol 2e-5, wanted "
                                 f"{want})")
        worst, n_equal, splits = compare_runs(kern, plain)
        log(f"  paged engine, {label}, chunked: every launch within "
            f"{max(errs.values()):.3g} of its plain version on the same "
            f"inputs {errs}; logits within {worst:.3g} of max|ref| of the "
            f"plain run up to each stream's first difference; streams "
            f"equal for {n_equal} of {len(reqs)} requests; splits (uid, "
            f"token, top-2 gap, logit difference there): {splits}")
        if not quant and (worst >= LOGIT_REL or n_equal != len(reqs)):
            raise AssertionError(f"{label}: kernel and plain-version runs "
                                 f"disagree (bound {LOGIT_REL}, streams "
                                 f"all equal)")
        if quant:
            flips = int8_flips(torch, kern[2], plain[2])
            log(f"  {label}: (layer, page) pairs whose int8 K/V bytes differ "
                f"between the kernel and plain runs at the end: "
                f"{flips[0]} of {flips[2]} ({flips[1]} bytes)")
            if flips[0] == 0 and worst > LOGIT_REL:
                raise AssertionError(
                    f"{label}: logits differ by {worst:.3g} of max|ref| "
                    f"(over {LOGIT_REL}) though no int8 byte of any page "
                    f"differs: not a rounding flip")
        if quant:
            with substituted(ops, "plain"):
                other = traced_paged_run(torch, params, c, reqs, args)
            worst, n_equal, splits = compare_runs(other, plain)
            log(f"  control, {label}: a second plain version against the "
                f"first: logits within {worst:.3g}; streams equal for "
                f"{n_equal} of {len(reqs)}; splits: {splits}")
        del kern, plain
    eng = make_dense_engine(params, cfg, args.batch, args.ctx,
                            cache_dtype=torch.float32, graphs=False,
                            device=args.device)
    errs = {}
    before = ops.launch_counts()["flash_verify"]
    with substituted(ops, "shadow", errs):
        fin, steps = eng.run(init_cache(cfg, args.batch, args.ctx,
                                        dtype=torch.float32,
                                        device=args.device), reqs)
    n_b5 = ops.launch_counts()["flash_verify"] - before
    if sorted(errs) != ["flash_verify"] or errs["flash_verify"] > 2e-5 \
            or n_b5 != cfg.n_layers * steps:
        raise AssertionError(f"dense engine: B5 launches {n_b5} (wanted "
                             f"{cfg.n_layers} x {steps} steps), against "
                             f"their plain versions: {errs} (atol 2e-5)")
    dense = {f.uid: f.tokens for f in fin}
    if dense != streams[False]:
        bad = [u for u, t in dense.items() if streams[False].get(u) != t]
        raise AssertionError(f"dense engine tokens differ from the paged "
                             f"engine's for uids {bad}")
    log(f"  dense engine: tokens equal to the paged engine's for "
        f"{len(reqs)} requests; {n_b5} B5 launches ({steps} steps x "
        f"{cfg.n_layers} layers), each within "
        f"{errs['flash_verify']:.3g} of its plain version")
    del params
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
#  phases 5 and 6: the streamed q4 path
# --------------------------------------------------------------------------- #

STREAM_ARGS = ["--arch", "qwen2.5-14b", "--batch", "8", "--ctx", "640",
               "--requests", "8", "--prompt-len", "128", "--prompt-len-max",
               "513", "--new-tokens", "16", "--seed", "0",
               "--stream-window", "4", "--store-quant", "q4"]
PROJECTIONS = 7          # wq, wk, wv, wo, w_gate, w_up, w_down per layer


#: the ssm block's projections: in_proj and out_proj
SSM_PROJECTIONS = 2


def projections(cfg) -> int:
    """The block's q4 leaves: its projections (B3 launches a layer a pass
    for dense and ssm blocks), for moe blocks the 4 attention projections,
    the router and the 3 expert stacks, for MLA blocks its 6 projections
    and the FFN's 3."""
    if cfg.family == "ssm":
        return SSM_PROJECTIONS
    if cfg.mla:
        return 9
    return 8 if cfg.n_experts else PROJECTIONS


def moe_b3(cfg) -> int:
    """B3 launches a moe layer a pass: 4 attention projections and every
    expert's slice of the 3 stacks (the router dequantizes at use)."""
    return 4 + 3 * cfg.n_experts


def same_quant_on_cpu(torch, cfg, tree, qtree) -> int:
    """Quantize layer 0's matmul weights again on the CPU: the packed
    bytes and scale bits must equal the card's (an expert stack: expert
    0's slice, each expert's groups being its own). Returns the leaves
    held."""
    from repro_torch.quant import QuantizedTensor, quantize_q4

    n = 0
    for sub in [k for k, v in qtree.items() if isinstance(v, dict)]:
        for key, q in qtree[sub].items():
            if not isinstance(q, QuantizedTensor):
                continue
            w, packed, scale = tree[sub][key], q.packed, q.scale
            if w.dim() == 3:
                w, packed, scale = w[0], packed[0], scale[0]
            cpu = quantize_q4(w.cpu(), q.group)
            n_packed = int((cpu.packed != packed.cpu()).sum())
            n_scale = int((cpu.scale.view(torch.int16)
                           != scale.cpu().view(torch.int16)).sum())
            if n_packed or n_scale:
                raise AssertionError(
                    f"layer 0 {sub}/{key}: the card's quantize_q4 differs "
                    f"from the CPU's in {n_packed} packed bytes and "
                    f"{n_scale} scales")
            n += 1
    if n != projections(cfg):
        raise AssertionError(f"layer 0: {n} quantized projections, wanted "
                             f"{projections(cfg)}")
    return n


def q4_model(torch, cfg, dtype, seed):
    """(head, per-layer q4 trees, layer(i)): ``layer(i)`` draws block i on
    the card (``init_block``), quantizes it there as the serve driver
    does (``quantize_ring_params`` at tp=1), keeps it and returns it —
    so ``write_param_store`` builds the store one layer at a time and no
    full-precision model is ever held."""
    from repro_torch import bridge
    from repro_torch.models import model as M
    from repro_torch.quant import map_tree
    from repro_torch.runtime.serve import quantize_ring_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    head = M.init_head(cfg, gen, dtype, "cuda")
    layers = []

    def layer(i):
        tree = bridge.tree_from_block(M.init_block(cfg, gen, dtype, "cuda"))
        q, skipped = quantize_ring_params(
            {"blocks": map_tree(lambda t: t[None], tree)}, cfg, tp=1)
        if skipped:
            raise AssertionError(f"layer {i}: left unquantized: {skipped}")
        qtree = map_tree(lambda t: t[0], q["blocks"])
        if i == 0:
            n = same_quant_on_cpu(torch, cfg, tree, qtree)
            log(f"  layer 0: the card's packed bytes and scale bits equal "
                f"the CPU's for all {n} projections")
        layers.append(qtree)
        return qtree

    return head, layers, layer


def layer_params(cfg):
    """(matmul weights, other parameters) of one block."""
    if cfg.family == "ssm":
        d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh = di // cfg.ssm_head_dim
        return (d * (2 * di + 2 * N + nh) + di * d,
                cfg.conv_width * (di + 2 * N) + 3 * nh + di + d)
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mla:
        H, r_q, r_kv = cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return (d * r_q + r_q * H * (dn + dr) + d * (r_kv + dr)
                + r_kv * H * (dn + dv) + H * dv * d + 3 * d * f,
                r_q + r_kv + 2 * d)
    hq, hk = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    bias = hq + 2 * hk if cfg.qkv_bias else 0
    ffn = 3 * d * f * cfg.n_experts + d * cfg.n_experts if cfg.n_experts \
        else 3 * d * f
    return d * (2 * hq + 2 * hk) + ffn, bias + 2 * d


def write_store(torch, cfg, dtype, seed):
    """Build the q4 model layer by layer and write its store to a new
    temporary directory; returns (dir, the resident stacked tree)."""
    from repro_torch.runtime.paramstore import stack_layers, write_param_store

    weights, others = layer_params(cfg)
    elt = torch.empty((), dtype=dtype).element_size()
    # packed q4 (1/2 B) + bf16 scales per 64 weights, the rest as is, head
    need = cfg.n_layers * (weights * 9 // 16 + others * elt) \
        + 2 * cfg.vocab * cfg.d_model * elt
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    if free < need + (4 << 30):
        raise AssertionError(f"{tmp}: {free / 1e9:.1f} GB free, the store "
                             f"needs about {need / 1e9:.1f} GB + 4 GB")
    sdir = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        head, layers, layer = q4_model(torch, cfg, dtype, seed)
        t0 = time.perf_counter()
        write_param_store(layer, head, cfg, sdir)
        torch.cuda.synchronize()
        tree = dict(head, blocks=stack_layers(layers))
    except BaseException:
        shutil.rmtree(sdir, ignore_errors=True)
        raise
    layers.clear()
    torch.cuda.empty_cache()
    log(f"  store of {cfg.n_layers} layers built, quantized and written in "
        f"{time.perf_counter() - t0:.1f} s to {sdir} ({free / 1e9:.1f} GB "
        f"free before, about {need / 1e9:.2f} GB needed)")
    return sdir, tree


def stream_summary(name, res, resident_bytes):
    st, summ = res["stats"], res["summary"]
    peak = resident_bytes if st is None else st.peak_resident_bytes
    stall = 0.0 if st is None else st.stall_s
    read = 0 if st is None else st.total_bytes_read
    log(f"  {name}: {summ['requests']} requests, {res['steps']} decode "
        f"steps, wall {res['wall_s']:.3f} s, TTFT p50 "
        f"{summ['ttft_p50_s'] * 1e3:.2f} ms, TPOT p50 "
        f"{summ['tpot_p50_s'] * 1e3:.2f} ms, {summ['tokens_per_s']:.2f} "
        f"tokens/s; peak resident weights {peak / 1e6:.1f} MB, prefetch "
        f"stall {stall * 1e3:.1f} ms, {read / 1e6:.1f} MB read")


#: phase 5's seed-0 q4 store of qwen2.5-14b (48 layers, bf16), kept for
#: phase 14 (b) and phase 18, which serve the same store (removed after
#: phase 18, or at exit)
STORE_14B = {}


def serve_streamed_full(torch, ops, serve):
    """Phase 5; returns the streamed run's launch counts. Its store stays
    for phases 14 and 18 (``STORE_14B``)."""
    import atexit

    from repro_torch.configs import get_config
    from repro_torch.runtime.paramstore import ParamStore, ResidentSource
    from repro_torch.runtime.streaming import StreamingParamSource

    args = serve.parse_args(STREAM_ARGS + ["--dtype", "bf16"])
    cfg = get_config(args.arch)                # full width, all 48 layers
    sdir, tree = write_store(torch, cfg, torch.bfloat16, seed=0)
    atexit.register(shutil.rmtree, sdir, True)
    kept = False
    try:
        store = ParamStore(sdir)
        nbytes = store.layer_nbytes
        raw = sum(layer_params(cfg))           # parameters of a layer
        log(f"  store: {store.quant_format}, manifest v{store.version}, "
            f"{nbytes / 1e6:.2f} MB/layer (the bf16 layer: "
            f"{2 * raw / 1e6:.2f} MB, ratio {nbytes / (2 * raw):.3f}); "
            f"{store.n_layers} layers, "
            f"{nbytes * store.n_layers / 1e9:.2f} GB")
        store.close()
        reqs = serve.make_requests(cfg, args)
        streams, counts = {}, {}
        for name in ("resident", "streamed"):
            src = ResidentSource(tree) if name == "resident" else \
                StreamingParamSource(ParamStore(sdir),
                                     window=args.stream_window)
            ops.reset_launch_counts()
            try:
                res = serve.serve_layerwise(src, cfg, reqs, args)
            finally:
                src.close()
            counts[name] = ops.launch_counts()
            res["requests"] = reqs
            check_served(res)
            stream_summary(f"{name} q4 weights", res,
                           nbytes * cfg.n_layers)
            passes = len(reqs) + res["steps"]
            want = {k: 0 for k in counts[name]}
            want["q4_matmul"] = PROJECTIONS * cfg.n_layers * passes
            want["flash_verify"] = cfg.n_layers * res["steps"]
            if counts[name] != want:
                raise AssertionError(
                    f"{name}: launches {counts[name]}, wanted {want} "
                    f"({passes} passes x {cfg.n_layers} layers x "
                    f"{PROJECTIONS} of B3, {res['steps']} decode steps x "
                    f"{cfg.n_layers} layers of B5)")
            log(f"  {name}: {want['q4_matmul']} q4_matmul launches = "
                f"{passes} passes x {cfg.n_layers} layers x {PROJECTIONS} "
                f"projections; {want['flash_verify']} flash_verify "
                f"launches = {res['steps']} decode steps x {cfg.n_layers} "
                f"layers")
            streams[name] = {f.uid: f.tokens for f in res["finished"]}
            if name == "streamed":
                st = res["stats"]
                if st.peak_resident_bytes > args.stream_window * nbytes:
                    raise AssertionError(
                        f"streamed: peak resident {st.peak_resident_bytes}"
                        f" B > {args.stream_window} layers of {nbytes} B")
                if st.layers_served != cfg.n_layers * passes:
                    raise AssertionError(f"streamed: {st.layers_served} "
                                         f"layers served")
                log(f"  streamed: peak resident weights "
                    f"{st.peak_resident_bytes / nbytes:.2f} layers of "
                    f"{args.stream_window} allowed; {len(st.events)} "
                    f"layer reads, median "
                    f"{st.median_layer_read_s * 1e3:.2f} ms each (mmap to "
                    f"pinned staging; the store was just written, so "
                    f"likely from the page cache); the resident run held "
                    f"all {cfg.n_layers} layers "
                    f"({nbytes * cfg.n_layers / 1e9:.2f} GB)")
            else:
                del tree
                gc.collect()
                torch.cuda.empty_cache()
        if streams["streamed"] != streams["resident"]:
            bad = [u for u, t in streams["resident"].items()
                   if streams["streamed"].get(u) != t]
            raise AssertionError(f"streamed tokens differ from the "
                                 f"resident run's for uids {bad}")
        log(f"  streamed and resident tokens equal for {len(reqs)} "
            f"requests")
        STORE_14B.update(dir=sdir, n_layers=cfg.n_layers)
        kept = True
    finally:
        if not kept:
            shutil.rmtree(sdir, ignore_errors=True)
    return counts["streamed"]


def reuse_store(torch, cfg):
    """Phase 5's store (``STORE_14B``) and its tree on the card, read back
    from it: the store phase 14 (b) would build again from the same seed
    (a ~16 s build)."""
    from repro_torch.quant import map_tree
    from repro_torch.runtime.paramstore import ParamStore, stack_layers

    if STORE_14B.get("n_layers") != cfg.n_layers:
        raise AssertionError(f"phase 5's store holds "
                             f"{STORE_14B.get('n_layers')} layers, "
                             f"phase 14 serves {cfg.n_layers}")
    t0 = time.perf_counter()
    with ParamStore(STORE_14B["dir"]) as store:
        head = map_tree(lambda t: t.cuda(), store.head())
        tree = dict(head, blocks=stack_layers([
            map_tree(lambda t: t.cuda(), store.layer(i))
            for i in range(store.n_layers)]))
    torch.cuda.synchronize()
    log(f"  phase 5's q4 store ({cfg.n_layers} layers) read back to the "
        f"card in {time.perf_counter() - t0:.1f} s")
    return STORE_14B["dir"], tree


def logged_run(torch, eng, prefill_name, cache, reqs):
    """Run an engine to completion, keeping the logits behind every greedy
    token by (uid, token index): the last prompt row of the
    ``models.model`` prefill the engine calls (``prefill_name``) for token
    0, the decode step's row after that. Returns the streams, the logits,
    the finished requests, the decode steps and the wall time."""
    from repro_torch.models import model as M

    logits, admitting = {}, []
    admit, decode = eng.admit, eng.decode
    prefill = getattr(M, prefill_name)

    def admit_(cache, tokens, uid, *a, **k):
        admitting.append(uid)
        return admit(cache, tokens, uid, *a, **k)

    def prefill_(*a, **k):
        out = prefill(*a, **k)
        logits[(admitting[-1], 0)] = out[0][0, -1].float().clone()
        return out

    def decode_(cache, tokens):
        out = decode(cache, tokens)
        for i in eng.active():
            st = eng.slots[i]
            logits[(st.uid, len(st.generated))] = out[0][i, 0].float().clone()
        return out

    eng.admit, eng.decode = admit_, decode_
    setattr(M, prefill_name, prefill_)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, steps = eng.run(cache, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        setattr(M, prefill_name, prefill)
    check_served({"finished": fin, "rejected": eng.rejected,
                  "requests": reqs})
    return {"streams": {f.uid: f.tokens for f in fin}, "logits": logits,
            "finished": fin, "steps": steps, "wall": wall}


def traced_stream_run(torch, source, cfg, reqs, args):
    """The layer-wise engine as ``serve.serve_layerwise`` builds it over an
    f32 cache, logged (``logged_run``); returns (streams, logits)."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.streaming import make_streaming_engine

    eng = make_streaming_engine(source, cfg, args.batch, args.ctx,
                                cache_dtype=torch.float32, graphs=False,
                                device=args.device)
    try:
        run = logged_run(torch, eng, "prefill_layerwise",
                         init_cache(cfg, args.batch, args.ctx,
                                    dtype=torch.float32, device=args.device),
                         reqs)
    finally:
        source.close()
    return run["streams"], run["logits"]


def q4_parity(torch, ops, serve) -> None:
    """Phase 6, 3 layers at full width, f32 (one more than the window of 2,
    so the streamed run evicts and reads a layer again each pass): B3
    against its plain version
    on the same inputs, streamed against resident tokens, kernel against
    plain-version logits."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.paramstore import ParamStore, ResidentSource
    from repro_torch.runtime.streaming import StreamingParamSource

    args = serve.parse_args(STREAM_ARGS + ["--dtype", "f32"])
    cfg = dataclasses.replace(get_config(args.arch), n_layers=3)
    log(f"  depth cut: 3 of 48 layers")
    sdir, tree = write_store(torch, cfg, torch.float32, seed=1)
    try:
        reqs = serve.make_requests(cfg, args)
        errs = {}
        with substituted(ops, "shadow", errs):
            streamed = traced_stream_run(
                torch, StreamingParamSource(ParamStore(sdir), window=2),
                cfg, reqs, args)
            resident = traced_stream_run(torch, ResidentSource(tree), cfg,
                                         reqs, args)
        ops.use_kernels(False)
        try:
            plain = traced_stream_run(torch, ResidentSource(tree), cfg,
                                      reqs, args)
        finally:
            ops.use_kernels(True)
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    if sorted(errs) != ["flash_verify", "q4_matmul"] \
            or errs["q4_matmul"] > Q4_TOL or errs["flash_verify"] > 2e-5:
        raise AssertionError(f"B3 and B5 launches against their plain "
                             f"versions on the same inputs: {errs} (B3 "
                             f"max|d|/max|ref| bound {Q4_TOL}, B5 atol "
                             f"2e-5)")
    if streamed[0] != resident[0]:
        raise AssertionError("streamed and resident tokens differ")
    worst, n_equal, splits = compare_runs(streamed, plain)
    log(f"  every B3 launch within {errs['q4_matmul']:.3g} of max|ref| of "
        f"its plain version on the same inputs, every B5 launch within "
        f"{errs['flash_verify']:.3g}; streamed and resident "
        f"tokens equal for {len(reqs)} requests; kernel vs plain-version "
        f"logits within {worst:.3g} of max|ref|, streams equal for "
        f"{n_equal} of {len(reqs)}; splits: {splits}")
    if worst >= LOGIT_REL or n_equal != len(reqs):
        raise AssertionError(f"kernel and plain-version runs disagree "
                             f"(bound {LOGIT_REL}, streams all equal)")
    del tree
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
#  phases 7 and 8: speculative decoding
# --------------------------------------------------------------------------- #

SPEC_GAMMA = 4
DRAFT_ARCH = "qwen1.5-0.5b"
SPEC_ARGS = ["--arch", "qwen1.5-32b", "--batch", "2", "--ctx", "1024",
             "--requests", "4", "--prompt-len", "128", "--prompt-len-max",
             "513", "--new-tokens", "16", "--seed", "0", "--stream-window",
             "4", "--store-quant", "q4", "--dtype", "bf16"]
#: bf16 spec against vanilla at full depth: the worst logit difference
#: before any split, as a fraction of max|logit| (about 13 bf16 ulps,
#: 2^-8 each, of the largest logit)
SPEC_BF16_REL = 5e-2
#: phase 7's depth: 8 of qwen1.5-32b's 64 layers (twice its streamed
#: window of 4), cut so that the whole script stays inside its time
#: limit (the two streamed runs and the store scale with the depth: 64
#: layers took 131-158 s of the phase)
SPEC_LAYERS = 8
#: the depth of phases 4, 8, 10 and 15 (d), every model's (cut for time
#: from 4; the parity holds each launch against its plain version
#: on the same inputs, and the counts follow the depth)
PARITY_LAYERS = SPEC_PARITY_LAYERS = 2
PARITY_ARGS = ["--batch", "4", "--ctx", "1024", "--requests", "4",
               "--prompt-len", "128", "--prompt-len-max", "513",
               "--new-tokens", "16", "--seed", "0", "--dtype", "f32",
               "--layers", str(SPEC_PARITY_LAYERS)]
#: perturbed self-draft: noise std as a fraction of each weight's std,
#: raised until the acceptance lands in ACCEPT_RANGE
EPS_LADDER = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0)
#: B3 launches in phase 8 against their plain version, max|d|/max|ref|:
#: qwen1.5-32b's w_down sums K = 27392 f32 products, twice phase 6's
#: K = 13824 (Q4_TOL there), and rounding error grows with the terms
Q4_TOL_32B = 2e-5
ACCEPT_RANGE = (0.2, 0.9)
ATTN_KERNELS = ("flash_verify", "paged_verify", "paged_prefill",
                "paged_verify_quant")


class CallTimer:
    """Host time of each call of ``fn`` between two device syncs (smoke
    instrumentation; the engine syncs once a step anyway)."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.times = torch, fn, []

    def __call__(self, *a, **k):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*a, **k)
        self.torch.cuda.synchronize()
        self.times.append(time.perf_counter() - t0)
        return out


@contextlib.contextmanager
def rows_by_T(counts):
    """Count the B5 and B1 wrapper calls by query rows a sequence (T);
    each call goes on to the wrapper in place (kernel or stand-in). The
    counts live in ``_build.LAUNCHES`` under ``name@T`` keys while the
    block runs, so a step replayed from a CUDA graph adds what its
    capture counted, as it does for the kernels' own counts; they move to
    ``counts`` as {(name, T): calls} on exit."""
    from repro_torch.kernels import _build, flash_decode, paged_decode

    saved = []
    for mod, name in ((flash_decode, "flash_verify"),
                      (paged_decode, "paged_verify")):
        fn = getattr(mod, name)

        def spy(q, *a, fn=fn, name=name, **k):
            key = f"{name}@T{q.shape[1]}"
            _build.LAUNCHES[key] = _build.LAUNCHES.get(key, 0) + 1
            return fn(q, *a, **k)

        saved.append((mod, name, fn))
        setattr(mod, name, spy)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        for key in [k for k in _build.LAUNCHES if "@T" in k]:
            name, T = key.split("@T")
            n = _build.LAUNCHES.pop(key)
            if n:
                counts[(name, int(T))] = counts.get((name, int(T)), 0) + n


def make_spec(torch, dparams, dcfg, batch, ctx, dtype, verify=None, *,
              graphs=True):
    """A ``SpeculativeDecoder`` over a resident draft with its own dense
    cache (``verify`` may be set later, as the paged engine needs); its
    T = 1 step is replayed from CUDA graphs unless ``graphs=False``."""
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import dense_decode, write_dense_slot
    from repro_torch.runtime.speculative import SpeculativeDecoder

    draft_decode = dense_decode(dparams, dcfg, graphs=graphs)

    def draft_prefill_one(prompt):
        c1 = M.init_cache(dcfg, 1, ctx, dtype=dtype, device="cuda")
        logits, c1 = M.prefill(dparams, dcfg, prompt, c1)
        return int(torch.argmax(logits[0, -1])), c1

    return SpeculativeDecoder(
        draft_decode, verify, gamma=SPEC_GAMMA,
        draft_cache=M.init_cache(dcfg, batch, ctx, dtype=dtype,
                                 device="cuda"),
        draft_prefill_one=draft_prefill_one,
        draft_write_slot=write_dense_slot)


def traced(torch, eng, cache, reqs, spec=None):
    """Run an engine, keeping the logits behind every token after the
    first by (uid, token index): each verify row of a spec run (row j of
    a slot that has emitted g tokens gives token g + j; the last cycle to
    write an index saw the accepted context), each decode row of a
    vanilla run."""
    logits = {}

    def keep(lg, rows):
        for i in eng.active():
            st = eng.slots[i]
            for j in range(rows):
                logits[(st.uid, len(st.generated) + j)] = \
                    lg[i, j].float().clone()

    if spec is not None:
        verify = spec.verify

        def verify_(c, t):
            lg, c = verify(c, t)
            keep(lg, t.shape[1])
            return lg, c
        spec.verify = verify_
    else:
        decode = eng.decode

        def decode_(c, t):
            lg, c = decode(c, t)
            keep(lg, 1)
            return lg, c
        eng.decode = decode_
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin, steps = eng.run(cache, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if spec is not None:
        spec.verify = verify
    else:
        eng.decode = decode
    check_served({"finished": fin, "rejected": eng.rejected,
                  "requests": reqs})
    return {"streams": {f.uid: f.tokens for f in fin},
            "counts": {f.uid: (f.proposed, f.accepted) for f in fin},
            "logits": logits, "finished": fin, "steps": steps,
            "wall": wall}


def compare_traced(a, b):
    """Run ``a`` against run ``b``, token by token up to each stream's
    first difference, logits wherever both kept them. Returns (worst
    max|d|/max|ref of b|, streams equal, [(uid, token, b's gap between
    its token and a's there / max|ref|, max|d|/max|ref| there)])."""
    worst, n_equal, splits = 0.0, 0, []
    for uid, toks in b["streams"].items():
        other = a["streams"][uid]
        n_equal += other == toks
        for n, tok in enumerate(toks):
            x, y = a["logits"].get((uid, n)), b["logits"].get((uid, n))
            rel = gap = None
            if x is not None and y is not None:
                top = float(y.abs().max())
                rel = float((x - y).abs().max()) / top
                worst = max(worst, rel)
            if n >= len(other) or other[n] != tok:
                if y is not None and n < len(other):
                    gap = float(y[tok] - y[other[n]]) / top
                splits.append((uid, n, gap, rel))
                break
    return worst, n_equal, splits


@contextlib.contextmanager
def h2d_events(torch):
    """CUDA events on the prefetcher's side stream around each layer's
    host-to-device copy (``LayerPrefetcher._to_card`` enqueues it there):
    the copy's device time, which the tracer's ``h2d`` span (the enqueue)
    does not hold. Yields the list of (start, end) event pairs."""
    from repro_torch.runtime.streaming import LayerPrefetcher

    to_card, pairs = LayerPrefetcher._to_card, []

    def timed(self, buf, nbytes):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(self._side)
        out = to_card(self, buf, nbytes)
        ev[1].record(self._side)
        pairs.append(ev)
        return out

    LayerPrefetcher._to_card = timed
    try:
        yield pairs
    finally:
        LayerPrefetcher._to_card = to_card


def streamed_trace(torch, tracer, copies):
    """Phase 12's reading of the traced vanilla streamed run: the trace
    (written to ``chiprun_out/``) checked by the port's validator with the
    decode and prefetcher tracks, the mean stall split per token, the
    prefetcher track's median spans and the copies' median device time."""
    from repro_torch.runtime.telemetry import validate_chrome_trace

    path = out_path("phase7_vanilla_streamed_trace.json")
    tracer.export_chrome_trace(path)
    info = validate_chrome_trace(path, ("decode", "prefetcher"))
    spans = {}
    for ev in tracer.events():
        if ev.track == "prefetcher" and hasattr(ev, "t_end"):
            spans.setdefault(ev.name.split("[")[0], []).append(ev.duration)
    torch.cuda.synchronize()
    h2d = [a.elapsed_time(b) for a, b in copies]
    if not h2d or "layer_read" not in spans or "h2d" not in spans:
        raise AssertionError(f"traced streamed run: {len(h2d)} timed copies"
                             f", prefetcher spans {sorted(spans)}")
    return {"stall": tracer.summary(), "tracks": info["tracks"],
            "events": info["n_events"], "evicted": info["evicted"],
            "trace": os.path.relpath(path, ROOT),
            "layer_read_ms": 1e3 * float(np.median(spans["layer_read"])),
            "h2d_span_ms": 1e3 * float(np.median(spans["h2d"])),
            "h2d_device_ms": float(np.median(h2d)), "copies": len(h2d)}


def serve_spec_full(torch, ops, serve):
    """Phase 7; returns the spec streamed run's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache
    from repro_torch.models import model as M
    from repro_torch.runtime.paramstore import ParamStore, ResidentSource
    from repro_torch.runtime.streaming import (StreamingParamSource,
                                               make_streaming_engine)
    from repro_torch.runtime.telemetry import Tracer

    args = serve.parse_args(SPEC_ARGS)
    # int8 cache; the depth cut to SPEC_LAYERS
    cfg = dataclasses.replace(get_config(args.arch), n_layers=SPEC_LAYERS)
    dcfg = get_config(DRAFT_ARCH)              # 24 layers, tied
    bf16, B, ctx = torch.bfloat16, args.batch, args.ctx
    gen = torch.Generator(device="cuda").manual_seed(11)
    dparams = M.init_params(dcfg, gen, bf16, "cuda")
    n_draft = sum(p.numel() for p in dparams.parameters())
    log(f"  target {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.kv_heads}, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, kv "
        f"{cfg.kv_dtype}; draft {dcfg.name}: {dcfg.n_layers} layers, d "
        f"{dcfg.d_model}, tied embeddings {dcfg.tie_embeddings}, "
        f"{n_draft / 1e9:.3f} B params bf16 resident "
        f"({2 * n_draft / 1e9:.2f} GB); gamma {SPEC_GAMMA}, {B} slots, "
        f"ctx {ctx}")
    sdir, tree = write_store(torch, cfg, bf16, seed=2)
    runs, launches = {}, {}
    try:
        store = ParamStore(sdir)
        nbytes = store.layer_nbytes
        head = 2 * cfg.vocab * cfg.d_model * 2       # embed + unembed
        log(f"  store: {nbytes / 1e6:.2f} MB/layer, "
            f"{nbytes * cfg.n_layers / 1e9:.2f} GB for {cfg.n_layers} "
            f"layers; bf16 head {head / 1e9:.2f} GB")
        store.close()
        reqs = serve.make_requests(cfg, args)
        # the resident runs replay their steps (the draft's too) from CUDA
        # graphs; phase 12 reruns them eagerly, and traces the vanilla
        # streamed run
        for name in ("spec streamed", "spec resident", "spec resident eager",
                     "vanilla resident", "vanilla resident eager",
                     "vanilla streamed"):
            graphs = not name.endswith("eager")
            tracer = Tracer() if name == "vanilla streamed" else None
            src = StreamingParamSource(ParamStore(sdir),
                                       window=args.stream_window,
                                       tracer=tracer) \
                if name.endswith("streamed") else ResidentSource(tree)
            spec = None
            if name.startswith("spec"):
                spec = make_spec(torch, dparams, dcfg, B, ctx, bf16,
                                 graphs=graphs)
                spec.draft_decode = CallTimer(torch, spec.draft_decode)
            eng = make_streaming_engine(src, cfg, B, ctx, spec=spec,
                                        cache_dtype=bf16, tracer=tracer,
                                        graphs=graphs)
            step_timer = None
            if spec is None:
                eng.decode = step_timer = CallTimer(torch, eng.decode)
            else:
                spec.verify = CallTimer(torch, eng.decode)
            by_T = {}
            ops.reset_launch_counts()
            try:
                with rows_by_T(by_T), h2d_events(torch) as copies:
                    run = traced(torch, eng, init_cache(
                        cfg, B, ctx, dtype=bf16, device="cuda"), reqs, spec)
                st = eng.streaming_stats()
            finally:
                src.close()
            if tracer is not None:
                PHASE12["trace"] = streamed_trace(torch, tracer, copies)
            counts = ops.launch_counts()
            # a pass of the target (a prefill, a decode step or a verify
            # pass) is 7 B3 launches a layer; a cycle is one verify pass
            # of T = gamma + 1 and gamma + 1 draft steps of T = 1, and
            # every pass over a dense cache is one B5 launch a layer
            steps = run["steps"]
            want = {k: 0 for k in counts}
            want["q4_matmul"] = PROJECTIONS * cfg.n_layers * (steps
                                                              + len(reqs))
            if spec is not None:
                if spec.cycles != steps:
                    raise AssertionError(f"{name}: {spec.cycles} cycles in "
                                         f"{steps} steps")
                want_T = {("flash_verify", SPEC_GAMMA + 1):
                          cfg.n_layers * steps,
                          ("flash_verify", 1):
                          (SPEC_GAMMA + 1) * dcfg.n_layers * steps}
            else:
                want_T = {("flash_verify", 1): cfg.n_layers * steps}
            want["flash_verify"] = sum(want_T.values())
            if counts != want or by_T != want_T:
                raise AssertionError(f"{name}: launches {counts} by T "
                                     f"{by_T}, wanted {want} by T {want_T}")
            summ = serve._p50_summary(run["finished"], run["wall"])
            peak = nbytes * cfg.n_layers if st is None \
                else st.peak_resident_bytes
            stall = 0.0 if st is None else st.stall_s
            msg = (f"  {name}: {len(reqs)} requests, {steps} "
                   f"{'cycles' if spec else 'decode steps'}, wall "
                   f"{run['wall']:.3f} s, TTFT p50 "
                   f"{summ['ttft_p50_s'] * 1e3:.2f} ms, TPOT p50 "
                   f"{summ['tpot_p50_s'] * 1e3:.2f} ms, "
                   f"{summ['tokens_per_s']:.2f} tokens/s; peak resident "
                   f"target weights {peak / 1e6:.1f} MB, prefetch stall "
                   f"{stall * 1e3:.1f} ms")
            if spec is not None:
                d_ms = 1e3 * sum(spec.draft_decode.times) / steps
                v_ms = 1e3 * float(np.mean(spec.verify.times))
                msg += (f"; acceptance {spec.acceptance_rate:.4f} "
                        f"({spec.accepted} of {spec.proposed} drafts); "
                        f"per cycle: draft {d_ms:.2f} ms ({SPEC_GAMMA + 1} "
                        f"steps), verify pass {v_ms:.2f} ms (median "
                        f"{1e3 * float(np.median(spec.verify.times)):.2f}"
                        f")")
            else:
                msg += (f"; decode step "
                        f"{1e3 * float(np.median(step_timer.times)):.2f} ms"
                        f" (median)")
            log(msg)
            log(f"  {name}: launches {counts}; by rows a sequence {by_T}"
                + (f"; graphs: {eng.graphs.captures} captures in "
                   f"{eng.graphs.capture_s:.3f} s, replays "
                   f"{dict(eng.graphs.replays)}" if eng.graphs else ""))
            launches[name] = counts
            runs[name] = run
            if "resident" in name:
                rec = {"wall_s": run["wall"], "steps": steps,
                       "tpot_p50_s": summ["tpot_p50_s"]}
                if spec is not None:
                    # medians: a first call of each T holds its capture
                    rec.update(draft_ms=(SPEC_GAMMA + 1) * 1e3 * float(
                        np.median(spec.draft_decode.times)),
                        verify_ms=1e3 * float(np.median(spec.verify.times)))
                else:
                    rec["step_ms"] = 1e3 * float(np.median(
                        step_timer.times))
                PHASE12["spec"][name] = rec
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    del tree
    for kind in ("spec", "vanilla"):
        for other in ("streamed", "resident eager"):
            if runs[f"{kind} {other}"]["streams"] != \
                    runs[f"{kind} resident"]["streams"]:
                raise AssertionError(f"{kind} {other} and {kind} resident "
                                     f"(graphed) streams differ")
    worst, n_equal, splits = compare_traced(runs["spec resident"],
                                            runs["vanilla resident"])
    log(f"  streamed, resident and resident eager streams equal for "
        f"{len(reqs)} requests (spec and vanilla); spec against vanilla: streams equal for "
        f"{n_equal} of {len(reqs)}, logits within {worst:.3g} of max|ref| "
        f"up to each stream's first difference; splits (uid, token, "
        f"vanilla top-2 gap, logit difference there, both / max|ref|): "
        f"{splits}")
    if worst >= SPEC_BF16_REL:
        raise AssertionError(f"spec and vanilla logits differ by {worst} "
                             f">= {SPEC_BF16_REL} of max|ref|")
    for uid, n, gap, rel in splits:
        if gap is None or rel is None or gap > 2 * rel:
            raise AssertionError(f"uid {uid} token {n}: spec and vanilla "
                                 f"split where the vanilla gap {gap} is "
                                 f"not under twice the logit difference "
                                 f"{rel}: no rounding explains it")
    del runs, dparams
    gc.collect()
    torch.cuda.empty_cache()
    return launches["spec streamed"]


def parity_case(torch, ops, label, build, reqs, vanilla, want_kernels,
                verify_kernel, layers, gate=None):
    """Phase 8, one spec engine: a kernel run whose every launch of
    ``want_kernels`` is held against its plain version on the same inputs,
    and (when ``gate(acceptance)`` holds) a ``use_kernels(False)`` run.
    Asserts that each cycle made one verify pass of ``verify_kernel`` at
    T = gamma + 1 over the target's layers and gamma + 1 draft steps of B5
    at T = 1 over the draft's (``layers``: (target, draft)), spec streams
    equal to ``vanilla``'s, verify logits within LOGIT_REL, and equal
    per-request accepted counts. Returns the kernel run's acceptance rate
    and whether the case was completed."""
    errs, by_T = {}, {}
    with substituted(ops, "shadow", errs), rows_by_T(by_T):
        eng, cache, spec, close = build(True)
        try:
            kern = traced(torch, eng, cache, reqs, spec)
        finally:
            close()
    rate = spec.acceptance_rate
    want_T = {(verify_kernel, SPEC_GAMMA + 1): layers[0] * spec.cycles,
              ("flash_verify", 1): (SPEC_GAMMA + 1) * layers[1]
              * spec.cycles}
    if by_T != want_T:
        raise AssertionError(f"{label}: calls by rows a sequence {by_T}, "
                             f"wanted {want_T}")
    bad = {k: v for k, v in errs.items()
           if v > (Q4_TOL_32B if k == "q4_matmul" else 2e-5)}
    if sorted(errs) != sorted(want_kernels) or bad:
        raise AssertionError(f"{label}: launches against their plain "
                             f"versions {errs}, wanted {want_kernels} "
                             f"(attention atol 2e-5, B3 {Q4_TOL_32B} of "
                             f"max|ref|)")
    if kern["streams"] != vanilla["streams"]:
        diff = [u for u, t in vanilla["streams"].items()
                if kern["streams"][u] != t]
        raise AssertionError(f"{label}: spec streams differ from vanilla "
                             f"greedy for uids {diff}")
    if gate is not None and not gate(rate):
        log(f"  {label}: acceptance {rate:.4f}, outside {ACCEPT_RANGE}")
        return rate, False
    ops.use_kernels(False)
    try:
        eng, cache, spec_p, close = build(True)
        try:
            plain = traced(torch, eng, cache, reqs, spec_p)
        finally:
            close()
    finally:
        ops.use_kernels(True)
    worst, n_equal, splits = compare_traced(kern, plain)
    if worst >= LOGIT_REL or n_equal != len(reqs) or \
            kern["counts"] != plain["counts"]:
        raise AssertionError(f"{label}: kernel and plain runs disagree: "
                             f"logits {worst} (bound {LOGIT_REL}), streams "
                             f"equal {n_equal} of {len(reqs)}, (proposed, "
                             f"accepted) {kern['counts']} vs "
                             f"{plain['counts']}")
    log(f"  {label}: {spec.cycles} cycles, acceptance {rate:.4f}; every "
        f"launch within its bound of its plain version on the same inputs"
        f" {errs}; B5/B1 calls by rows a sequence {by_T}; verify logits "
        f"within {worst:.3g} of max|ref| of the plain run; streams equal to"
        f" vanilla greedy and to the plain run for {len(reqs)} of "
        f"{len(reqs)}; (proposed, accepted) equal to the plain run's: "
        f"{kern['counts']}")
    return rate, True


def graphed_spec_case(torch, label, build, reqs, vanilla, verify_kernel,
                      layers):
    """Phase 8, one spec engine again with its steps replayed from CUDA
    graphs (the target's verify at T = gamma + 1, the draft's T = 1):
    streams equal to vanilla greedy, and the calls by rows a sequence that
    each cycle implies, counted through the graphs' replays."""
    by_T = {}
    with rows_by_T(by_T):
        eng, cache, spec, close = build(True, graphs=True)
        try:
            run = traced(torch, eng, cache, reqs, spec)
        finally:
            close()
    want_T = {(verify_kernel, SPEC_GAMMA + 1): layers[0] * spec.cycles,
              ("flash_verify", 1): (SPEC_GAMMA + 1) * layers[1]
              * spec.cycles}
    if by_T != want_T or run["streams"] != vanilla["streams"]:
        raise AssertionError(f"{label}, graphed: calls by rows {by_T} "
                             f"(wanted {want_T}); streams equal to vanilla "
                             f"{run['streams'] == vanilla['streams']}")
    log(f"  {label}, graphed: {spec.cycles} cycles replayed from CUDA "
        f"graphs ({dict(eng.graphs.replays)}, the draft's "
        f"{dict(spec.draft_decode.graphs.replays)}); streams equal to "
        f"vanilla greedy; calls by rows {by_T}")


def spec_parity(torch, ops, serve) -> None:
    """Phase 8: (a) the dense engine, (b) the paged engine with chunked
    admission, (c) the streamed q4 engine, all with spec, at
    ``SPEC_PARITY_LAYERS`` layers, full width, f32 and an f32 cache."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import init_cache
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import make_dense_engine
    from repro_torch.runtime.kvcache import make_paged_engine
    from repro_torch.runtime.paramstore import ParamStore
    from repro_torch.runtime.streaming import (StreamingParamSource,
                                               make_streaming_engine)

    f32 = torch.float32
    dcfg = dataclasses.replace(get_config(DRAFT_ARCH),
                               n_layers=SPEC_PARITY_LAYERS)
    dparams = M.init_params(dcfg, torch.Generator(device="cuda")
                            .manual_seed(12), f32, "cuda")
    log(f"  depth cut: {SPEC_PARITY_LAYERS} layers for every model "
        f"({DRAFT_ARCH} draft "
        f"included); f32 caches (parity mode) in place of qwen1.5-32b's "
        f"int8 cache, which phase 7 runs")

    # (a) qwen1.5-32b, dense engine
    args = serve.parse_args(["--arch", "qwen1.5-32b"] + PARITY_ARGS)
    cfg, params = serve.build_model(args)
    cfg = dataclasses.replace(cfg, kv_dtype="bfloat16")
    reqs = serve.make_requests(cfg, args)
    B, ctx = args.batch, args.ctx

    def dense_build(draft):
        def build(with_spec, graphs=False):
            spec = None
            if with_spec:
                dp, dc = draft
                spec = make_spec(torch, dp, dc, B, ctx, f32, graphs=graphs)
            eng = make_dense_engine(params, cfg, B, ctx, spec=spec,
                                    cache_dtype=f32, graphs=graphs)
            if spec is not None:
                spec.verify = eng.decode
            return eng, init_cache(cfg, B, ctx, dtype=f32,
                                   device="cuda"), spec, lambda: None
        return build

    eng, cache, _, _ = dense_build(None)(False)
    vanilla = traced(torch, eng, cache, reqs)
    layers = (cfg.n_layers, dcfg.n_layers)
    parity_case(torch, ops, "(a) qwen1.5-32b dense, distinct draft",
                dense_build((dparams, dcfg)), reqs, vanilla,
                ["flash_verify"], "flash_verify", layers)
    graphed_spec_case(torch, "(a) qwen1.5-32b dense, distinct draft",
                      dense_build((dparams, dcfg)), reqs, vanilla,
                      "flash_verify", layers)
    pert = copy.deepcopy(params)
    lo, hi = ACCEPT_RANGE
    done = False
    for eps in EPS_LADDER:
        gen = torch.Generator(device="cuda").manual_seed(13)
        with torch.no_grad():
            for p, q in zip(params.parameters(), pert.parameters()):
                sd = float(p.float().std()) if p.numel() > 1 else 0.0
                q.copy_(p + eps * sd * torch.randn(
                    p.shape, generator=gen, device="cuda", dtype=p.dtype))
        rate, done = parity_case(
            torch, ops, f"(a) qwen1.5-32b dense, perturbed self-draft "
            f"eps={eps}", dense_build((pert, cfg)), reqs, vanilla,
            ["flash_verify"], "flash_verify", (cfg.n_layers, cfg.n_layers),
            gate=lambda r: lo <= r <= hi)
        if done or rate < lo:
            break
    if not done:
        raise AssertionError(f"no noise size in {EPS_LADDER} put the "
                             f"self-draft's acceptance in {ACCEPT_RANGE}")
    del params, pert, vanilla
    gc.collect()
    torch.cuda.empty_cache()

    # (b) qwen2.5-14b, paged engine with chunked admission
    args = serve.parse_args(["--arch", "qwen2.5-14b", "--prefill-chunk",
                             "128", "--page-tokens", "16"] + PARITY_ARGS)
    cfg, params = serve.build_model(args)
    reqs = serve.make_requests(cfg, args)
    bs = args.page_tokens
    n_pages = 2 + B * (-(-ctx // bs))

    def paged_build(with_spec, graphs=False):
        spec = make_spec(torch, dparams, dcfg, B, ctx, f32, graphs=graphs) \
            if with_spec else None
        eng, kv = make_paged_engine(params, cfg, B, ctx, n_pages=n_pages,
                                    page_tokens=bs, cache_dtype=f32,
                                    prefill_chunk=args.prefill_chunk,
                                    spec=spec, graphs=graphs)
        if spec is not None:
            spec.verify = eng.decode
        return eng, kv.init_cache(), spec, kv.pool.check

    eng, cache, _, _ = paged_build(False)
    vanilla = traced(torch, eng, cache, reqs)
    parity_case(torch, ops, "(b) qwen2.5-14b paged, chunked admission, "
                "distinct draft", paged_build, reqs, vanilla,
                ["flash_verify", "paged_prefill", "paged_verify"],
                "paged_verify", (cfg.n_layers, dcfg.n_layers))
    graphed_spec_case(torch, "(b) qwen2.5-14b paged, chunked admission, "
                      "distinct draft", paged_build, reqs, vanilla,
                      "paged_verify", (cfg.n_layers, dcfg.n_layers))
    del params, vanilla
    gc.collect()
    torch.cuda.empty_cache()

    # (c) qwen1.5-32b, streamed q4 engine
    args = serve.parse_args(["--arch", "qwen1.5-32b"] + PARITY_ARGS)
    cfg = dataclasses.replace(get_config(args.arch),
                              n_layers=SPEC_PARITY_LAYERS,
                              kv_dtype="bfloat16")
    reqs = serve.make_requests(cfg, args)
    sdir, tree = write_store(torch, cfg, f32, seed=3)
    del tree
    try:
        def stream_build(with_spec):
            src = StreamingParamSource(ParamStore(sdir), window=2)
            spec = make_spec(
                torch, dparams, dcfg, B, ctx, f32,
                lambda c, t: M.decode_step_layerwise(src, cfg, c, t),
                graphs=False) if with_spec else None
            eng = make_streaming_engine(src, cfg, B, ctx, spec=spec,
                                        cache_dtype=f32, graphs=False)
            return eng, init_cache(cfg, B, ctx, dtype=f32,
                                   device="cuda"), spec, src.close

        eng, cache, _, close = stream_build(False)
        try:
            vanilla = traced(torch, eng, cache, reqs)
        finally:
            close()
        parity_case(torch, ops, "(c) qwen1.5-32b streamed q4, distinct "
                    "draft", stream_build, reqs, vanilla,
                    ["flash_verify", "q4_matmul"], "flash_verify",
                    (cfg.n_layers, dcfg.n_layers))
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    del dparams
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
#  phases 9 and 10: the ssm family (mamba2-780m)
# --------------------------------------------------------------------------- #

#: phase 9's depth: 24 of mamba2-780m's 48 layers (phase 17 (b) trains
#: all 48)
SSM_LAYERS = 24
SSM_ARGS = ["--arch", "mamba2-780m", "--batch", "8", "--ctx", "2080",
            "--requests", "16", "--prompt-len", "200", "--prompt-len-max",
            "2001", "--new-tokens", "32", "--seed", "0", "--stream-window",
            "4", "--store-quant", "q4"]


def near_tie_only(label, kern, plain, bound):
    """Phase 7's rule for two bf16 runs that sum in another order: up to
    each stream's first difference the logits agree to ``bound`` of
    max|ref|, and where streams split the reference's top-2 gap is under
    twice the two runs' logit difference there (no flip is possible
    otherwise). Returns (worst, streams equal, splits)."""
    worst, n_equal, splits = compare_runs(kern, plain)
    if worst >= bound:
        raise AssertionError(f"{label}: logits differ by {worst} >= "
                             f"{bound} of max|ref|")
    for uid, n, gap, rel in splits:
        if gap > 2 * rel:
            raise AssertionError(f"{label}: uid {uid} token {n} splits where "
                                 f"the top-2 gap {gap} is not under twice "
                                 f"the logit difference {rel}")
    return worst, n_equal, splits


def ssm_summary(serve, name, run, stats, resident_bytes):
    """``stream_summary`` of a ``logged_run``."""
    stream_summary(name, {"stats": stats, "steps": run["steps"],
                          "wall_s": run["wall"],
                          "summary": serve._p50_summary(run["finished"],
                                                        run["wall"])},
                   resident_bytes)


def serve_ssm_full(torch, ops, serve):
    """Phase 9; returns the launch counts of the resident kernel run (the
    main path)."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.engine import make_dense_engine
    from repro_torch.runtime.paramstore import ParamStore, ResidentSource
    from repro_torch.runtime.streaming import (StreamingParamSource,
                                               make_streaming_engine)

    args = serve.parse_args(SSM_ARGS + ["--dtype", "bf16", "--layers",
                                        str(SSM_LAYERS)])
    bf16, Bn, ctx = torch.bfloat16, args.batch, args.ctx
    t0 = time.perf_counter()
    cfg, params = serve.build_model(args)     # full width
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, d_inner "
        f"{cfg.d_inner}, {cfg.d_inner // cfg.ssm_head_dim} SSD heads of P "
        f"{cfg.ssm_head_dim}, N {cfg.ssm_state}, vocab {cfg.vocab}, tied; "
        f"{n / 1e9:.3f} B params in bf16 on the card, made in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = serve.make_requests(cfg, args)
    lens = sorted(len(r.prompt) for r in reqs)
    log(f"  {len(reqs)} requests, prompts {lens[0]}-{lens[-1]} tokens "
        f"(sum {sum(lens)}), {args.new_tokens} new tokens, {Bn} slots, ctx "
        f"{ctx}")
    runs, counts = {}, {}
    for name in ("kernels", "plain"):
        ops.use_kernels(name == "kernels")
        ops.reset_launch_counts()
        try:
            # the plain versions read lengths on the host: no graphs
            eng = make_dense_engine(params, cfg, Bn, ctx, cache_dtype=bf16,
                                    graphs=name == "kernels")
            runs[name] = logged_run(torch, eng, "prefill", init_cache(
                cfg, Bn, ctx, dtype=bf16, device="cuda"), reqs)
        finally:
            ops.use_kernels(True)
        counts[name] = ops.launch_counts()
        want = {k: 0 for k in counts[name]}
        if name == "kernels":
            want["ssd_scan"] = cfg.n_layers * len(reqs)
        if counts[name] != want:
            raise AssertionError(f"dense engine, {name}: launches "
                                 f"{counts[name]}, wanted {want} "
                                 f"({cfg.n_layers} B6 launches a prefill)")
        ssm_summary(serve, f"dense engine, resident bf16, {name}",
                    runs[name], None, 2 * n)
    log(f"  kernel run: {counts['kernels']['ssd_scan']} B6 launches = "
        f"{len(reqs)} prefills x {cfg.n_layers} layers, nothing else")
    worst, n_equal, splits = near_tie_only(
        "kernels against use_kernels(False)",
        (runs["kernels"]["streams"], runs["kernels"]["logits"]),
        (runs["plain"]["streams"], runs["plain"]["logits"]), SPEC_BF16_REL)
    log(f"  kernels against use_kernels(False): streams equal for "
        f"{n_equal} of {len(reqs)}, logits within {worst:.3g} of max|ref| "
        f"up to each stream's first difference; splits (uid, token, top-2 "
        f"gap, logit difference there): {splits}")
    del params, runs
    gc.collect()
    torch.cuda.empty_cache()

    sdir, tree = write_store(torch, cfg, bf16, seed=3)
    streams = {}
    try:
        store = ParamStore(sdir)
        nbytes = store.layer_nbytes
        raw = sum(layer_params(cfg))
        log(f"  store: {store.quant_format}, manifest v{store.version}, "
            f"{nbytes / 1e6:.3f} MB/layer (the bf16 layer: "
            f"{2 * raw / 1e6:.3f} MB, ratio {nbytes / (2 * raw):.3f}); "
            f"{nbytes * store.n_layers / 1e9:.3f} GB")
        store.close()
        for name in ("resident", "streamed"):
            src = ResidentSource(tree) if name == "resident" else \
                StreamingParamSource(ParamStore(sdir),
                                     window=args.stream_window)
            ops.reset_launch_counts()
            try:
                eng = make_streaming_engine(src, cfg, Bn, ctx,
                                            cache_dtype=bf16)
                run = logged_run(torch, eng, "prefill_layerwise", init_cache(
                    cfg, Bn, ctx, dtype=bf16, device="cuda"), reqs)
                st = eng.streaming_stats()
            finally:
                src.close()
            got = ops.launch_counts()
            passes = len(reqs) + run["steps"]
            want = {k: 0 for k in got}
            want["ssd_scan"] = cfg.n_layers * len(reqs)
            want["q4_matmul"] = SSM_PROJECTIONS * cfg.n_layers * passes
            if got != want:
                raise AssertionError(
                    f"q4 {name}: launches {got}, wanted {want} ({passes} "
                    f"passes x {cfg.n_layers} layers x {SSM_PROJECTIONS} "
                    f"of B3, {cfg.n_layers} of B6 a prefill)")
            ssm_summary(serve, f"layer-wise engine, q4 {name}", run, st,
                        nbytes * cfg.n_layers)
            log(f"  q4 {name}: {want['q4_matmul']} B3 launches = {passes} "
                f"passes x {cfg.n_layers} layers x {SSM_PROJECTIONS}; "
                f"{want['ssd_scan']} B6 launches")
            if st is not None:
                if st.peak_resident_bytes > args.stream_window * nbytes:
                    raise AssertionError(
                        f"streamed: peak resident {st.peak_resident_bytes} "
                        f"B > {args.stream_window} layers of {nbytes} B")
                log(f"  streamed: peak resident weights "
                    f"{st.peak_resident_bytes} B = "
                    f"{st.peak_resident_bytes / nbytes:.2f} layers of "
                    f"{args.stream_window} allowed; {len(st.events)} layer "
                    f"reads, median {st.median_layer_read_s * 1e3:.3f} ms")
            streams[name] = run["streams"]
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    if streams["streamed"] != streams["resident"]:
        bad = [u for u, t in streams["resident"].items()
               if streams["streamed"].get(u) != t]
        raise AssertionError(f"q4 streamed tokens differ from the resident "
                             f"run's for uids {bad}")
    log(f"  q4 streamed and resident tokens equal for {len(reqs)} requests")
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return counts["kernels"]


def ssm_parity(torch, ops, serve) -> None:
    """Phase 10, ``PARITY_LAYERS`` layers at full width, f32 and an f32
    cache: the dense engine and the streamed q4 engine, kernels (every
    launch held against
    its plain version on the same inputs) against ``use_kernels(False)``:
    logits within LOGIT_REL of max|ref|, tokens equal."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.engine import make_dense_engine
    from repro_torch.runtime.paramstore import ParamStore, ResidentSource
    from repro_torch.runtime.streaming import (StreamingParamSource,
                                               make_streaming_engine)

    args = serve.parse_args(SSM_ARGS + ["--dtype", "f32", "--layers",
                                        str(PARITY_LAYERS)])
    f32, Bn, ctx = torch.float32, args.batch, args.ctx
    cfg, params = serve.build_model(args)
    reqs = serve.make_requests(cfg, args)
    sdir, tree = write_store(torch, cfg, f32, seed=4)

    # every engine eager: each launch is shadowed by its plain version
    def dense():
        return make_dense_engine(params, cfg, Bn, ctx, cache_dtype=f32,
                                 graphs=False), "prefill"

    def streamed():
        src = StreamingParamSource(ParamStore(sdir), window=2)
        return make_streaming_engine(src, cfg, Bn, ctx, cache_dtype=f32,
                                     graphs=False), "prefill_layerwise"

    def resident():
        return make_streaming_engine(ResidentSource(tree), cfg, Bn, ctx,
                                     cache_dtype=f32, graphs=False), \
            "prefill_layerwise"

    def run(build):
        eng, fn = build()
        try:
            return logged_run(torch, eng, fn, init_cache(
                cfg, Bn, ctx, dtype=f32, device="cuda"), reqs)
        finally:
            if eng.source is not None:
                eng.source.close()

    try:
        for label, kern_build, plain_build, want in (
                ("dense engine", dense, dense, ["ssd_scan"]),
                ("streamed q4 engine", streamed, resident,
                 ["q4_matmul", "ssd_scan"])):
            errs = {}
            ops.reset_launch_counts()
            with substituted(ops, "shadow", errs):
                kern = run(kern_build)
            n_b6 = ops.launch_counts()["ssd_scan"]
            ops.use_kernels(False)
            try:
                plain = run(plain_build)
            finally:
                ops.use_kernels(True)
            if sorted(errs) != want or errs["ssd_scan"] > 1.0 \
                    or errs.get("q4_matmul", 0.0) > Q4_TOL \
                    or n_b6 != cfg.n_layers * len(reqs):
                raise AssertionError(
                    f"{label}: {n_b6} B6 launches (wanted {cfg.n_layers} x "
                    f"{len(reqs)}); against their plain versions on the "
                    f"same inputs: {errs} (B6 ratio to its tolerance <= 1, "
                    f"B3 max|d|/max|ref| <= {Q4_TOL}; wanted {want})")
            worst, n_equal, splits = compare_runs(
                (kern["streams"], kern["logits"]),
                (plain["streams"], plain["logits"]))
            log(f"  {label}: {n_b6} B6 launches, each within "
                f"{errs['ssd_scan']:.3g}x its tolerance of its plain "
                f"version on the same inputs {errs}; logits within "
                f"{worst:.3g} of max|ref| of the use_kernels(False) run; "
                f"streams equal for {n_equal} of {len(reqs)}; splits: "
                f"{splits}")
            if worst >= LOGIT_REL or n_equal != len(reqs):
                raise AssertionError(f"{label}: kernel and plain-version runs"
                                     f" disagree (bound {LOGIT_REL}, streams"
                                     f" all equal)")
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    del params, tree
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
#  phase 11: the CI smokes' shapes on the card
# --------------------------------------------------------------------------- #

#: (label, serve flags, kernels that must have launched): the reduced
#: configs (head_dim 16) through ``repro_torch.launch.serve --smoke
#: --dtype f32``, each in a process of its own
CI_SMOKES = (
    ("(a) paged, chunks of 8, tokens equal to the dense engine's",
     ["--prefill-chunk", "8", "--check-dense"],
     ("paged_prefill", "paged_verify", "flash_verify")),
    # int8 pages with chunked admission never match the dense engine
    # (ROADMAP Queue C): no dense comparison
    ("(b) int8 pages, chunks of 8", ["--prefill-chunk", "8",
                                     "--kv-quant-kernel"],
     ("paged_verify_quant",)),
    ("(c) qwen1.5-32b (int8 dense cache) from a q4 store, streamed with a "
     "window of 2, tokens equal to resident",
     ["--arch", "qwen1.5-32b", "--stream-window", "2", "--store-quant",
      "q4", "--check-resident"], ("flash_verify", "q4_matmul")),
    ("(d) streamed q4 with 3 transient layer-read faults, tokens equal to "
     "the clean run",
     ["--chaos", "transient", "--stream-window", "2", "--store-quant", "q4"],
     ("flash_verify", "q4_matmul")),
    ("(e) tiered: 0.1 MB device (12 pages), 0.07 MB host, the requests "
     "and then their prompts again (recalled from host and disk), parking, "
     "tokens equal to the unbudgeted runs and the parked session to one run",
     ["--page-tokens", "16", "--prefill-chunk", "16", "--device-budget",
      "0.1", "--host-budget", "0.07", "--park-idle-s", "0"],
     ("paged_prefill", "paged_verify")),
    ("(f) the same with int8 pages, 0.04 MB device (15 pages), 0.017 MB "
     "host",
     ["--page-tokens", "16", "--prefill-chunk", "16", "--device-budget",
      "0.04", "--host-budget", "0.017", "--park-idle-s", "0",
      "--kv-quant-kernel"],
     ("paged_verify_quant",)),
)


#: the CI file whose serve lines phase 11 runs through the port
CI_FILE = os.path.join(ROOT, ".github", "workflows", "ci.yml")
#: the metric names the CI validates in each metrics file it writes
CI_METRICS = {"metrics.json": ["request/ttft_s", "request/tpot_s",
                               "decode/step_s", "requests/finished",
                               "kv/pages_active", "slots/active"],
              "metrics_chunked.json": ["request/prefill_chunks",
                                       "decode/step_s"]}


def ci_serve_lines(outdir):
    """Each ``python -m repro.launch.serve`` command of the CI file, with
    ``repro_torch`` in place of ``repro`` and its output files moved to
    ``outdir``: (label, argv after the module, kernels that must launch,
    {output path: metric names the CI requires, or trace tracks})."""
    import shlex

    with open(CI_FILE) as f:
        lines = f.read().splitlines()
    out, i = [], 0
    while i < len(lines):
        if "python -m repro.launch.serve" in lines[i]:
            n, cmd = i + 1, lines[i].strip()
            while cmd.endswith("\\"):
                i += 1
                cmd = cmd[:-1] + " " + lines[i].strip()
            argv = shlex.split(cmd)
            argv = argv[argv.index("repro.launch.serve") + 1:]
            files = {}
            for flag in ("--metrics-out", "--trace"):
                if flag in argv:
                    j = argv.index(flag) + 1
                    name, argv[j] = argv[j], os.path.join(outdir, argv[j])
                    files[argv[j]] = CI_METRICS.get(
                        name, ("prefetcher", "decode"))
            kernels = ("paged_verify_quant",) if "--kv-quant-kernel" in argv \
                else ("paged_verify",) if "--paged-kv" in argv \
                else ("flash_verify",)
            out.append((f"ci.yml:{n} {' '.join(argv)}", argv, kernels, files))
        i += 1
    return out


def ci_smokes() -> None:
    """Phase 11: each CI smoke shape, and each serve line of the CI file
    as written (``repro_torch`` in place of ``repro``, on the card), must
    exit 0 on the card, having launched its kernels (the last ``kernel
    launches`` line it prints); the metrics and traces the CI lines write
    must pass the port's validators with the names the CI requires. The
    runs are processes of their own, all started together (the reduced
    models leave the card idle, a process's start is most of its
    time)."""
    import ast

    from repro_torch.runtime.metrics import validate_metrics_snapshot
    from repro_torch.runtime.telemetry import validate_chrome_trace

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    # one CPU thread a driver: the card does their work, and 16 drivers
    # (and their 88 ranks, one thread each) share the host's 8 cores
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_ci_")
    runs = [(label, ["--smoke", "--dtype", "f32", "--stages", "1", *flags],
             kernels, {}) for label, flags, kernels in CI_SMOKES]
    runs += ci_serve_lines(outdir)
    procs = []
    for label, argv, kernels, files in runs:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *argv]
        procs.append((label, cmd, kernels, files, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    try:
        for label, cmd, kernels, files, proc in procs:
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"{label}: {' '.join(cmd[1:])} exited "
                                     f"{proc.returncode}\n{out[-4000:]}"
                                     f"\n{err[-4000:]}")
            lines = [ln for ln in out.splitlines()
                     if "kernel launches" in ln]
            counts = ast.literal_eval(lines[-1].split("kernel launches", 1)[1]
                                      .strip()) if lines else {}
            idle = [k for k in kernels if not counts.get(k)]
            if idle:
                raise AssertionError(f"{label}: {idle} never launched "
                                     f"({counts})")
            # the decode section's ring across ranks: its ranks' launches
            # (the driver prints them; the counts above are the parent's)
            ranked = ""
            if "rank processes over gloo" in out:
                lines = [ln for ln in out.splitlines()
                         if "rank launches" in ln]
                summed = ast.literal_eval(lines[-1].rsplit("ranks: ", 1)[1]
                                          .strip()) if lines else {}
                if not summed.get("flash_verify_stats"):
                    raise AssertionError(f"{label}: the ranks never "
                                         f"launched B5-stats ({summed})")
                ranked = f"; the ranks' launches summed {summed}"
                # the stream and failover sections across the same ranks
                want = [w for flag, w in (
                    ("--stream-window", "streamed ring across 8 ranks"),
                    ("failover", "ring across 4 x 2 ranks -> 2 x 2"))
                    if flag in cmd]
                if any(w not in out for w in want):
                    raise AssertionError(f"{label}: no {want} in its "
                                         f"output")
            checks = [ln.strip() for ln in out.splitlines()
                      if "identical" in ln]
            if "--device-budget" in cmd and label.startswith("("):
                # the tier smokes' budgets make the repeats recall pages;
                # the CI line's (4 MB) hold every page
                recalled = [ln for ln in checks
                            if ln.startswith("tiered paged decode")]
                m = re.search(r"\((\d+) pages from host, (\d+) from disk\)",
                              recalled[-1] if recalled else "")
                if not m or not (int(m[1]) and int(m[2])):
                    raise AssertionError(f"{label}: no page recalled from "
                                         f"the host and from disk: {checks}")
            for path, want in files.items():
                if path.endswith(".json") and "trace" not in \
                        os.path.basename(path):
                    validate_metrics_snapshot(path, require=want)
                else:
                    validate_chrome_trace(path, tuple(want))
            log(f"  {label}: exit 0 by {time.perf_counter() - t0:.1f} s; "
                f"launches {counts}{ranked}; {'; '.join(checks)}"
                + (f"; {len(files)} output file(s) validated" if files
                   else ""))
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(outdir, ignore_errors=True)


# --------------------------------------------------------------------------- #
#  phase 12: graphed against eager, and where a step's time goes
# --------------------------------------------------------------------------- #

def report_graphs() -> None:
    """Phase 12: print (and check) what phases 3 and 7 recorded in
    ``PHASE12``, beside the card's name and power limit."""
    log(f"  card: {card()}")
    paged = PHASE12["paged"]
    for label in ("bf16", "int8"):
        rec = paged[label]
        log(f"  phase 3, {label} pages, main run (graphed): wall "
            f"{rec['wall_s']:.3f} s, TPOT p50 {rec['tpot_p50_s'] * 1e3:.2f} "
            f"ms, TTFT p50 {rec['ttft_p50_s'] * 1e3:.2f} ms, "
            f"{rec['tokens_per_s']:.1f} tokens/s, {rec['steps']} steps; "
            f"launches {({k: v for k, v in rec['launches'].items() if v})}; "
            f"graphs: {rec['graphs']}")
        for way in ("eager", "graphed"):
            w = PHASE12["profile"][(label, way)]
            log(f"  phase 3, {label} pages, {way} (logits kept, steps timed"
                f"): wall {w['wall_s']:.3f} s, TPOT p50 "
                f"{w['tpot_p50_s'] * 1e3:.2f} ms, TTFT p50 "
                f"{w['ttft_p50_s'] * 1e3:.2f} ms; median ms between syncs "
                f"(count): decode step {w['step_ms']}, full chunk "
                f"{w['chunk_ms']}, ragged chunk {w['ragged_ms']}"
                + (f"; graphs: {w['graphs']}" if w["graphs"] else ""))
        log(f"  phase 3, {label} pages: streams equal both ways; graphed vs "
            f"eager logits max|d| {rec['logit_max_abs_d']:.3g} over "
            f"{rec['n_logits']} tokens")
        for way in ("eager", "graphed"):
            w = PHASE12["profile"][(label, way)]
            log(f"  profiler, {label} pages, {way}, engine step "
                f"{PROFILE_STEP}: wall {w['wall_ms']:.2f} ms under the "
                f"profiler, device busy {w['busy_ms']:.2f} ms "
                f"({w['device_events']} device events), idle share "
                f"{w['idle']:.3f}; trace {w['trace']}")
            log(f"    top device ops (ms): {w['top_device']}")
            log(f"    top host ops (self ms, calls): {w['top_host']}")
    # phase 3's schedule: 56 decode steps and 45 prompt chunks, each
    # launching one kernel a layer (2688 and 2160 at 48 layers)
    want = {"paged_verify": 56 * PAGED_LAYERS,
            "paged_prefill": 45 * PAGED_LAYERS}
    want_b4 = want["paged_verify"] + want["paged_prefill"]
    bf16 = {k: paged["bf16"]["launches"][k] for k in want}
    int8 = paged["int8"]["launches"]["paged_verify_quant"]
    log(f"  exact launch counts under graphs: bf16 {bf16}, int8 B4 {int8} "
        f"(phase 3's before graphs: {want}, {want_b4})")
    if bf16 != want or int8 != want_b4:
        raise AssertionError("graphed launch counts differ from phase 3's "
                             "exact counts before graphs")
    spec = PHASE12["spec"]
    for kind, what in (("vanilla", "step_ms"), ("spec", "verify_ms")):
        g, e = spec[f"{kind} resident"], spec[f"{kind} resident eager"]
        extra = "" if kind == "vanilla" else (
            f"; draft {e['draft_ms']:.2f} -> {g['draft_ms']:.2f} ms a "
            f"cycle ({SPEC_GAMMA + 1} x the median step)")
        log(f"  phase 7, {kind} resident, eager -> graphed: wall "
            f"{e['wall_s']:.3f} -> {g['wall_s']:.3f} s, TPOT p50 "
            f"{e['tpot_p50_s'] * 1e3:.2f} -> {g['tpot_p50_s'] * 1e3:.2f} "
            f"ms, {what.split('_')[0]} (median) {e[what]:.2f} -> "
            f"{g[what]:.2f} ms"
            f"{extra}; streams equal")
    t = PHASE12["trace"]
    st = t["stall"]
    log(f"  phase 7, vanilla streamed, traced: stall split per token over "
        f"{int(st['n'])} steps (ms): compute {st['compute'] * 1e3:.2f}, "
        f"disk_wait {st['disk_wait'] * 1e3:.2f}, sched_idle "
        f"{st['sched_idle'] * 1e3:.2f}, wall {st['wall'] * 1e3:.2f}; "
        f"prefetcher medians: layer_read span {t['layer_read_ms']:.2f} ms, "
        f"h2d span (the enqueue) {t['h2d_span_ms']:.3f} ms, the H2D copy's "
        f"device time {t['h2d_device_ms']:.2f} ms ({t['copies']} copies, "
        f"CUDA events)")
    log(f"  trace {t['trace']}: valid, {t['events']} events, tracks "
        f"{t['tracks']}, evicted {t['evicted']}")


# --------------------------------------------------------------------------- #
#  phase 13: tiered KV memory at full width
# --------------------------------------------------------------------------- #

#: phase 13's traffic: 4 groups of 6 requests, each group sharing a
#: 768-token prefix (48 pages, 3 chunks of 256), a unique suffix of
#: 32-224 tokens, 16 new tokens, arriving round-robin over the groups
TIER_GROUPS, TIER_PER, TIER_PREFIX, TIER_NEW = 4, 6, 768, 16
#: the tiered run's budget in pages: a request reserves up to 64, so two
#: are admitted at a time and the other groups' prefixes cannot stay on
#: the device; cost eviction takes the unshared suffix pages first, then
#: those prefixes, to the host, whose 64 pages spill to disk. Every prefix
#: hit is then a recall (the allocation does not depend on the weights:
#: the same traffic through a one-layer reduced model on the CPU makes
#: 1159 evictions, 960 recalls, 141 of them from disk, 316 spills)
TIER_DEVICE_PAGES, TIER_HOST_PAGES = 192, 64
#: the fault run: two transient faults on each tier copy it makes
TIER_FAULT_OPS = ("kv_d2disk", "kv_disk2h", "kv_h2d")
#: phase 13's record, printed at its end beside the card
PHASE13 = {}


def tier_requests(serve, vocab):
    """Phase 13's requests (seed 13)."""
    from repro_torch.data import Request
    rng = np.random.default_rng(13)
    prefixes = [rng.integers(0, vocab, TIER_PREFIX)
                for _ in range(TIER_GROUPS)]
    reqs = []
    for i in range(TIER_GROUPS * TIER_PER):
        suffix = rng.integers(0, vocab, int(rng.integers(32, 225)))
        reqs.append(Request(
            i, np.concatenate([prefixes[i % TIER_GROUPS], suffix]),
            TIER_NEW, 0.0))
    return reqs


def keep_logits(eng):
    """Keep the logits behind every greedy token of ``eng`` by (uid, token
    index): the last chunk's last row for token 0, the decode step's row
    after that (a restored session's first step is its token 0). Returns
    the dict the run fills."""
    logits, admitting = {}, []
    admit, chunk_step, decode = eng.admit, eng.chunk_step, eng.decode

    def admit_(cache, tokens, uid, *a, **k):
        admitting.append(uid)
        return admit(cache, tokens, uid, *a, **k)

    def chunk_step_(*a, **k):
        out = chunk_step(*a, **k)
        logits[(admitting[-1], 0)] = out[0][0, -1].float().clone()
        return out

    def decode_(cache, tokens):
        out = decode(cache, tokens)
        for i in eng.active():
            st = eng.slots[i]
            logits[(st.uid, len(st.generated))] = out[0][i, 0].float().clone()
        return out

    eng.admit, eng.chunk_step, eng.decode = admit_, chunk_step_, decode_
    return logits


def watch_recalls(torch, kv):
    """Keep a device copy of every page the offloader evicts (taken at
    the eviction, before the page is reused), and compare every page a
    chunked admit fetched back (the device page, after
    ``begin_chunked_admit`` wrote it) with it, bit for bit; returns the
    record: ``checked`` pages, ``bad`` ones whose bytes differ."""
    rec = {"evicted": {}, "checked": 0, "bad": []}
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}

    def bits(t):
        return t.contiguous().view(ints[t.element_size()])
    off = kv.offloader
    offload, begin = off.offload, kv.begin_chunked_admit

    def offload_(h, tree):
        rec["evicted"][h] = {n: t.clone() for n, t in tree.items()}
        return offload(h, tree)

    def begin_(cache, slot, prompt_len):
        fetched = [(pid, h) for pid, (kind, h) in
                   zip(kv._slot_pages[slot], kv._admit_meta[slot])
                   if kind == "fetched"]
        out = begin(cache, slot, prompt_len)
        for pid, h in fetched:
            rec["checked"] += 1
            page, was = kv._page(out[0], pid), rec["evicted"].get(h)
            if was is None or not all(torch.equal(bits(page[n]),
                                                  bits(was[n]))
                                      for n in page):
                rec["bad"].append(pid)
        return out

    off.offload, kv.begin_chunked_admit = offload_, begin_
    return rec


def tier_run(torch, serve, params, cfg, reqs, args, *, memory=None,
             disk_dir=None, injector=None, policy=None, watch=False):
    """One phase-13 run of the paged engine (graphed, chunked, bf16
    pages): the reference (no budget, a pool for every slot's context) or
    tiered (``memory``: the pool sized from its device budget, cost
    eviction, ``disk_dir``). Keeps every token's logits; returns the
    streams, logits, stats, tier stats (before close), copy device ms,
    the recall record and the timings."""
    from repro_torch.runtime.kvcache import make_paged_engine

    B, bs = args.batch, args.page_tokens
    eng, kv = make_paged_engine(
        params, cfg, B, args.ctx,
        n_pages=None if memory is not None else 2 + B * (-(-args.ctx // bs)),
        page_tokens=bs, cache_dtype=torch.bfloat16,
        prefill_chunk=args.prefill_chunk, memory=memory,
        evict_policy="cost" if memory is not None else "lru",
        disk_dir=disk_dir, io_policy=policy, injector=injector,
        device=args.device)
    logits = keep_logits(eng)
    rec = watch_recalls(torch, kv) if watch else None
    cache = kv.init_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        fin, steps = eng.run(cache, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_served({"finished": fin, "rejected": eng.rejected,
                      "requests": reqs})
        st = kv.stats()
        tiers = kv.memory.stats()
        kv.memory.audit()
        off = kv.offloader
        out = {"streams": {f.uid: f.tokens for f in fin}, "logits": logits,
               "stats": st, "tiers": tiers, "steps": steps, "wall": wall,
               "summary": serve._p50_summary(fin, wall), "recalls": rec,
               "d2h_ms": off.copy_device_ms("d2h"),
               "h2d_ms": off.copy_device_ms("h2d"),
               "host_events": list(off.events),
               "disk_events": list(kv.disk.events) if kv.disk else [],
               "disk_retries": kv.disk.health.retries if kv.disk else 0,
               "recall_costs": kv.recall_costs,
               "pinned_bytes": kv._host_pages.pinned_bytes}
    finally:
        kv.close()
    for tier in ("host", "disk"):
        if kv.memory.used(tier):
            raise AssertionError(f"{tier} tier holds {kv.memory.used(tier)}"
                                 f" B after close")
    return out


def session_check(torch, serve, params, cfg, args, disk_dir):
    """Phase 13's parked session: a 1000-token prompt, two turns of 16
    new tokens parked between them (demoted to disk by ``sweep_parked``,
    park_idle_s 0) against one uninterrupted 32-token run; then the same
    with one parked page file's bytes flipped: the restored step's logits
    must differ. Returns the timings and the logit difference."""
    from repro_torch.data import Request
    from repro_torch.runtime.kvcache import make_paged_engine

    B, bs = args.batch, args.page_tokens
    prompt = np.random.default_rng(14).integers(0, cfg.vocab, 1000)
    common = dict(n_pages=2 + B * (-(-args.ctx // bs)), page_tokens=bs,
                  cache_dtype=torch.bfloat16,
                  prefill_chunk=args.prefill_chunk, device=args.device)
    eng, kv = make_paged_engine(params, cfg, B, args.ctx, **common)
    try:
        full, _ = eng.run(kv.init_cache(),
                          [Request(900, prompt, 2 * TIER_NEW, 0.0)])
    finally:
        kv.close()
    eng, kv = make_paged_engine(params, cfg, B, args.ctx, disk_dir=disk_dir,
                                park_idle_s=0.0, **common)
    logits = keep_logits(eng)
    ms = {"park": [], "restore": [], "demote": []}

    def timed(fn, key, keep=lambda out: True):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            if keep(out):
                ms[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return call
    kv.park_session = timed(kv.park_session, "park")
    kv.restore_session = timed(kv.restore_session, "restore")
    kv.sweep_parked = timed(kv.sweep_parked, "demote", lambda n: n > 0)
    cache = kv.init_cache()
    turns = {}
    try:
        for uid, sid in ((901, "s"), (902, "s"), (903, "flipped"),
                         (904, "flipped")):
            if uid == 904:
                # flip a mantissa bit of every bf16 value of the parked
                # session's first page file (finite values, other bytes)
                path = kv.disk.path(("sess", sid, 0))
                data = np.fromfile(path, dtype=np.uint8)
                data[0::2] ^= 0x40
                data.tofile(path)
            fin, _ = eng.run(cache, [Request(uid, prompt, TIER_NEW, 0.0,
                                             sid)])
            turns[uid] = [f for f in fin if f.uid == uid][0].tokens
            if uid in (901, 903) and not (kv.is_parked(sid)
                                          and kv._parked[sid].tier == "disk"):
                raise AssertionError(f"session {sid} was not parked on disk "
                                     f"after its first turn")
        st = kv.stats()
    finally:
        kv.close()
    got, ref = turns[901] + turns[902], full[0].tokens
    if got != ref:
        raise AssertionError(f"parked session: {got} != the uninterrupted "
                             f"run's {ref}")
    if turns[903] != turns[901]:
        raise AssertionError("the second session's first turn differs from "
                             "the first's")
    clean, flipped = logits[(902, 0)], logits[(904, 0)]
    d = float((clean - flipped).abs().max())
    if not d > 0:
        raise AssertionError(f"negative control: flipped page file restored "
                             f"with logits max|d| {d} from the clean restore")
    return {"ms": ms, "max_abs_d": d, "tokens": len(ref), "stats": st}


def page_copy_ms(torch, nbytes, reps=50):
    """A page's H2D and D2H copy alone: a pinned buffer of the offloader's
    pool to a device page and back, timed with CUDA events on an idle
    stream, median ms of ``reps`` each. (In a run the worker's event pair
    around its H2D copy also holds its waits for the interpreter lock
    between the two events, which the engine loop holds.)"""
    from repro_torch.runtime.kvcache import HostPages

    pool = HostPages(pin=True)
    host = pool.take(nbytes)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {}
    for kind, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        ms = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        out[kind] = float(np.median(ms))
    pool.close()
    return out


def serve_tiered_full(torch, ops, serve):
    """Phase 13: tiered KV at qwen2.5-14b's full width and depth (48
    layers, bf16 pages of 3 MiB, 8 slots, ctx 2048, 256-token chunks,
    graphed steps). The reference run (a pool for every slot, nothing
    evicted), the tiered run (192 device pages, 64 host pages, cost
    eviction, a disk tier; half of the 384/96 first planned, at which
    cost eviction keeps every active prefix on the device and nothing is
    recalled), a tiered run with transient faults on its
    disk writes, disk reads and host-to-device copies, and a parked
    session. Checks recalled bytes, the counters, the books, the streams
    (near ties only, phase 7's rule), the retries, the session and its
    negative control; records what phase 13 prints."""
    from repro_torch.runtime.faults import FaultInjector, FaultSpec
    from repro_torch.runtime.iopolicy import IOPolicy
    from repro_torch.runtime.memory import MemoryBudget, TierManager

    args = serve.parse_args(SERVE_ARGS + ["--dtype", "bf16"])
    t0 = time.perf_counter()
    cfg, params = serve.build_model(args)
    torch.cuda.synchronize()
    log(f"  weights: qwen2.5-14b, {cfg.n_layers} layers, bf16, made in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = tier_requests(serve, cfg.vocab)
    pb = 2 * cfg.n_layers * args.page_tokens * cfg.kv_heads * cfg.head_dim \
        * 2                                      # K and V, bf16
    budget = MemoryBudget(device=TIER_DEVICE_PAGES * pb,
                          host=TIER_HOST_PAGES * pb)
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    need = len(reqs) * 64 * pb
    if free < need + (4 << 30):
        raise AssertionError(f"{tmp}: {free / 1e9:.1f} GB free, the disk "
                             f"tier may need {need / 1e9:.1f} GB + 4 GB")
    ddir = tempfile.mkdtemp(prefix="chip_smoke_kvdisk_")
    try:
        before = ops.launch_counts()
        ref = tier_run(torch, serve, params, cfg, reqs, args)
        tier = tier_run(torch, serve, params, cfg, reqs, args,
                        memory=TierManager(budget),
                        disk_dir=os.path.join(ddir, "tiered"), watch=True)
        after = ops.launch_counts()
        for name in ("paged_verify", "paged_prefill"):
            if after[name] == before[name]:
                raise AssertionError(f"phase 13: {name} never launched")
        injector = FaultInjector([FaultSpec(op=op, times=2)
                                  for op in TIER_FAULT_OPS])
        fault = tier_run(torch, serve, params, cfg, reqs, args,
                         memory=TierManager(budget),
                         disk_dir=os.path.join(ddir, "faults"),
                         injector=injector,
                         policy=IOPolicy(backoff_base_s=0.002,
                                         backoff_max_s=0.02))
        sess = session_check(torch, serve, params, cfg, args,
                             os.path.join(ddir, "session"))
    finally:
        shutil.rmtree(ddir, ignore_errors=True)
    st, rec = tier["stats"], tier["recalls"]
    if st.page_bytes != pb or st.n_pages != TIER_DEVICE_PAGES:
        raise AssertionError(f"tiered pool: {st.n_pages} pages of "
                             f"{st.page_bytes} B, wanted "
                             f"{TIER_DEVICE_PAGES} of {pb}")
    fetched = st.fetched_bytes // pb
    host_fetched = fetched - st.fetched_disk_pages
    if rec["bad"] or rec["checked"] != fetched:
        raise AssertionError(f"recalled pages: {len(rec['bad'])} of "
                             f"{rec['checked']} differ from their bytes at "
                             f"eviction ({fetched} fetched)")
    if not (st.evictions > 0 and host_fetched > 0 and st.spilled_pages > 0
            and st.fetched_disk_pages > 0):
        raise AssertionError(f"tiers unused: evictions {st.evictions}, host "
                             f"fetches {host_fetched}, spilled "
                             f"{st.spilled_pages}, disk fetches "
                             f"{st.fetched_disk_pages}")
    for run in (tier, fault):
        for name in ("device", "host"):
            s = run["tiers"][name]
            if s.peak > s.capacity:
                raise AssertionError(f"{name} peak {s.peak} > budget "
                                     f"{s.capacity}")
    worst, n_equal, splits = near_tie_only(
        "phase 13, tiered against the reference",
        (tier["streams"], tier["logits"]), (ref["streams"], ref["logits"]),
        SPEC_BF16_REL)
    if fault["streams"] != tier["streams"]:
        raise AssertionError("the fault run's streams differ from the "
                             "tiered run's")
    fst = fault["stats"]
    fired = {op: sum(f.op == op for f in injector.fired)
             for op in TIER_FAULT_OPS}
    if fired != {op: 2 for op in TIER_FAULT_OPS} \
            or fst.fetch_retries < 2 or fault["disk_retries"] < 4:
        raise AssertionError(f"fault run: fired {fired}, kv_h2d retries "
                             f"{fst.fetch_retries}, page-file retries "
                             f"{fault['disk_retries']}")
    PHASE13.update(ref=ref, tier=tier, fault=fault, session=sess,
                   worst=worst, n_equal=n_equal, splits=splits, fired=fired,
                   host_fetched=host_fetched, page_bytes=pb,
                   alone=page_copy_ms(torch, pb))
    del params
    gc.collect()
    torch.cuda.empty_cache()


def report_tiers() -> None:
    """Phase 13's numbers, beside the card's name and power limit."""
    from repro_torch.core.latency import tier_recall_crosscheck

    r = PHASE13
    pb = r["page_bytes"]
    log(f"  card: {card()}")
    for name in ("ref", "tier", "fault"):
        run = r[name]
        s = run["summary"]
        log(f"  {name} run: wall {run['wall']:.3f} s, {run['steps']} steps, "
            f"TTFT p50 {s['ttft_p50_s'] * 1e3:.2f} ms, TPOT p50 "
            f"{s['tpot_p50_s'] * 1e3:.2f} ms, {s['tokens_per_s']:.1f} "
            f"tokens/s; pool {run['stats'].n_pages} pages")
    for name in ("tier", "fault"):
        st, run = r[name]["stats"], r[name]
        t = run["tiers"]
        log(f"  {name} run: evictions {st.evictions}, prefix hits "
            f"{st.prefix_hits}; offloaded {st.offloaded_bytes} B, fetched "
            f"{st.fetched_bytes} B ({st.fetched_bytes // pb} pages, "
            f"{st.fetched_disk_pages} from disk), spilled "
            f"{st.spilled_pages} pages, disk written "
            f"{st.disk_bytes_written} B, disk read {st.disk_bytes_read} B; "
            f"fetch stall {st.fetch_stall_s:.4f} s; peaks device "
            f"{t['device'].peak} / {t['device'].capacity} B, host "
            f"{t['host'].peak} / {t['host'].capacity} B, disk "
            f"{t['disk'].peak} B; pinned host buffers "
            f"{run['pinned_bytes']} B; refusals {t['host'].refusals}")
        for kind, where in (("d2h", "the eviction's, on the compute "
                             "stream"),
                            ("h2d", "the worker's, on its side stream, its "
                             "waits between the events included")):
            v = run[f"{kind}_ms"]
            if v:
                log(f"    page {kind.upper()} copy in the run ({where}; "
                    f"CUDA events): median {float(np.median(v)):.4f} ms "
                    f"over {len(v)} copies of {pb} B")
        for tier, events in (("host", run["host_events"]),
                             ("disk", run["disk_events"])):
            c = tier_recall_crosscheck(run["recall_costs"], tier, events)
            log(f"    recall cross-check, {tier}: modeled "
                f"{c.predicted_layer_s * 1e3:.4f} ms a page, measured "
                f"median {c.measured_layer_s * 1e3:.4f} ms over "
                f"{len(events)} recalls (ratio {c.ratio:.3f}, "
                f"{'consistent' if c.consistent else 'INCONSISTENT'} "
                f"within 10x)")
    log(f"  a page's copy alone (pinned host page, CUDA events, median of "
        f"50): H2D {r['alone']['h2d']:.4f} ms "
        f"({pb / r['alone']['h2d'] / 1e6:.2f} GB/s), D2H "
        f"{r['alone']['d2h']:.4f} ms ({pb / r['alone']['d2h'] / 1e6:.2f} "
        f"GB/s)")
    rec = r["tier"]["recalls"]
    log(f"  recalled pages byte-equal to their bytes at eviction: "
        f"{rec['checked']} ({r['host_fetched']} from host, "
        f"{r['tier']['stats'].fetched_disk_pages} from disk)")
    log(f"  tiered against the reference: streams equal for "
        f"{r['n_equal']} of {len(r['ref']['streams'])}; logits within "
        f"{r['worst']:.3g} of max|ref| up to each stream's first difference;"
        f" near-tie splits (uid, token, top-2 gap, logit difference there): "
        f"{r['splits']}")
    log(f"  fault run: fired {r['fired']}; kv_h2d retries "
        f"{r['fault']['stats'].fetch_retries}, page-file retries "
        f"{r['fault']['disk_retries']}; streams equal to the tiered run's")
    s = r["session"]
    med = {k: (float(np.median(v)) if v else None, len(v))
           for k, v in s["ms"].items()}
    log(f"  parked session: two turns equal one uninterrupted "
        f"{s['tokens']}-token run; ms (median, count): park {med['park']}, "
        f"demote to disk {med['demote']}, restore {med['restore']}; "
        f"flipped page file: restored logits max|d| {s['max_abs_d']:.4g} "
        f"from the clean restore")


# --------------------------------------------------------------------------- #
#  phase 14: the piped ring
# --------------------------------------------------------------------------- #

RING_ARGS = ["--arch", "qwen2.5-14b", "--batch", "8", "--ctx", "1024",
             "--prompt-len", "512", "--new-tokens", "32", "--seed", "0",
             "--stages", "4"]
#: phase 14 (b)-(c)'s depth: all of qwen2.5-14b's 48 layers (phase 5's
#: store, which phase 18 serves too)
RING_LAYERS = 48
#: B5 launches a ring pass: every layer of every microbatch (4 stages)
RING_B5 = RING_LAYERS * 4
#: phase 14 (a)'s depth, cut for time: the bf16 resident ring
RING_A_LAYERS = 16
RING_A_B5 = RING_A_LAYERS * 4
#: greedy steps of phase 14 (b)'s resident q4 ring, the reference of phase
#: 18 (a)'s ranks on the same store (cut for time)
RANK_STEPS = 4
#: phase 14's record, printed at its end beside the card
RING = {}
#: phase 14 (b)'s store, prefilled cache and resident ring run, for
#: phase 18 (a)
RANK_REF = {}


def by_row(run):
    """A ``serve.greedy_steps`` run as ``compare_runs`` reads one: each
    batch row is a stream (rows decode independently)."""
    toks = run["tokens"][:, :, 0]
    streams = {b: [int(t) for t in toks[b]] for b in range(toks.shape[0])}
    logits = {(b, n): lg[b, 0] for n, lg in enumerate(run["logits"])
              for b in range(toks.shape[0])}
    return streams, logits


def launched(ops, want, label):
    """The launch counts since the last reset must be ``want`` exactly
    (kernels not named: 0)."""
    got = ops.launch_counts()
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{label}: launches {got}, wanted {full}")
    return got


def ring_resident(torch, ops, serve):
    """Phase 14 (a): the resident ring at full width, bf16."""
    from repro_torch.runtime.serve import RingPlan, RingServeStep, ring_params

    args = serve.parse_args(RING_ARGS + ["--dtype", "bf16", "--layers",
                                         str(RING_A_LAYERS)])
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, params = serve.build_model(args)
    prompts, cache, nxt, ttft = serve.ring_prefill(params, cfg, args)
    torch.cuda.synchronize()
    cache_bytes = sum(a.numel() * a.element_size()
                      for a in cache["layers"].values())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"  weights {w_bytes / 1e9:.2f} GB bf16 and cache "
        f"{cache_bytes / 1e9:.2f} GB on the card; prefill of 8 x 512 on one device in "
        f"{ttft:.2f} s (setup {time.perf_counter() - t0:.1f} s)")
    n = int(args.new_tokens)
    one = serve.greedy_steps(serve.one_device_decode(params, cfg, dev),
                             serve.clone_cache(cache), nxt, n, dev,
                             keep=True)
    one_ms = 1e3 * float(np.median(one["step_s"][1:]))
    RING["one_device_ms"] = one_ms
    for k in (1, 2):
        plan = RingPlan.make(cfg, 4, k)
        rp = ring_params(params, cfg, plan)
        step = RingServeStep(cfg, plan, rp, graphs=True, device=dev)
        ops.reset_launch_counts()
        run = serve.greedy_steps(step, serve.to_ring_cache(cache, cfg, plan),
                                 nxt, n, dev, keep=True)
        launched(ops, {"flash_verify": RING_A_B5 * n}, f"ring k={k} graphed")
        graphed_ms = 1e3 * float(np.median(run["step_s"][1:]))
        worst, n_equal, splits = near_tie_only(
            f"ring k={k} against the one-device decode", by_row(run),
            by_row(one), SPEC_BF16_REL)
        log(f"  ring k={k} (w {plan.w}, M 4), graphed: step p50 "
            f"{graphed_ms:.2f} ms against the one-device step's "
            f"{one_ms:.2f} ms; {RING_A_B5 * n} B5 launches ({RING_A_B5} a step "
            f"x {n}); streams equal to the one-device decode's for "
            f"{n_equal} of 8 rows, logits within {worst:.3g} of max|ref| up"
            f" to each row's first difference; splits (row, token, top-2 "
            f"gap, logit difference there): {splits}; graphs: "
            f"{step.graphs.captures} capture in "
            f"{step.graphs.capture_s:.2f} s, "
            f"{step.graphs.pool_bytes / 1e6:.1f} MB")
        n_eager = 8
        eager = RingServeStep(cfg, plan, rp, graphs=False, device=dev)
        ops.reset_launch_counts()
        erun = serve.greedy_steps(eager, serve.to_ring_cache(cache, cfg, plan),
                                  nxt, n_eager, dev, keep=True)
        launched(ops, {"flash_verify": RING_A_B5 * n_eager},
                 f"ring k={k} eager")
        d = max(float((a - b).abs().max())
                for a, b in zip(erun["logits"], run["logits"]))
        if d != 0 or not np.array_equal(erun["tokens"],
                                        run["tokens"][:, :n_eager]):
            raise AssertionError(f"ring k={k}: eager logits differ from the "
                                 f"graphed ones by {d}")
        eager_ms = 1e3 * float(np.median(erun["step_s"][1:]))
        # the verify pass: T = 5 rows a sequence over the decoded cache
        T = 5
        vstep = RingServeStep(cfg, plan, rp, n_tokens=T, graphs=True,
                              device=dev)
        vc = run["cache"]
        ln0 = vc["len"].clone()
        vt = torch.tensor(run["tokens"][:, -1], device=dev).expand(
            -1, T).contiguous()
        times = []
        ops.reset_launch_counts()
        for _ in range(6):
            vc["len"].copy_(ln0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            vstep(vc, vt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        launched(ops, {"flash_verify": RING_A_B5 * 6}, f"ring k={k} verify")
        verify_ms = 1e3 * float(np.median(times[1:]))
        log(f"  ring k={k}, eager: step p50 {eager_ms:.2f} ms; logits max|d| "
            f"{d} against the graphed steps ({n_eager} steps); verify pass "
            f"T={T} (graphed) {verify_ms:.2f} ms against {T} single steps "
            f"{T * graphed_ms:.2f} ms: amortization "
            f"{T * graphed_ms / verify_ms:.2f}x")
        RING[f"k{k}"] = {"graphed_ms": graphed_ms, "eager_ms": eager_ms,
                         "verify_ms": verify_ms, "splits": len(splits),
                         "worst": worst, "n_equal": n_equal}
        del run, erun, vc, step, eager, vstep, rp
        gc.collect()
        torch.cuda.empty_cache()
    del params, cache, one
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def bank_copies(torch):
    """CUDA events around each layer's host-to-device copy of the ring's
    bank prefetcher (``_to_card`` on its side stream); yields the pairs."""
    from repro_torch.runtime.streaming import RingBankPrefetcher

    to_card, pairs = RingBankPrefetcher._to_card, []

    def timed(self, buf, nbytes):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(self._side)
        out = to_card(self, buf, nbytes)
        ev[1].record(self._side)
        pairs.append(ev)
        return out

    RingBankPrefetcher._to_card = timed
    try:
        yield pairs
    finally:
        RingBankPrefetcher._to_card = to_card


def ring_streamed(torch, ops, serve):
    """Phase 14 (b) and (c): phase 5's q4 store through the resident and
    the streamed ring (M 4, k 2, banks 2 steps ahead), then a stage killed
    mid-decode, in one process. The store (phase 5's, read back), the
    prefilled cache and the resident ring's ``RANK_STEPS`` steps stay for
    phase 18 (``RANK_REF``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.profiles import (paper_table2_cluster,
                                           profile_from_config)
    from repro_torch.quant import tree_tensors
    from repro_torch.runtime.paramstore import ParamStore
    from repro_torch.runtime.serve import RingPlan, RingServeStep, ring_params
    from repro_torch.runtime.streaming import StreamingRingDriver
    from repro_torch.runtime.telemetry import (Tracer, format_summary,
                                               validate_chrome_trace)

    cfg = dataclasses.replace(get_config("qwen2.5-14b"),
                              n_layers=RING_LAYERS)
    dev = torch.device("cuda")
    n = RANK_STEPS
    args = serve.parse_args(RING_ARGS + ["--dtype", "bf16", "--ring-k", "2",
                                         "--new-tokens", str(n)])
    sdir, tree = reuse_store(torch, cfg)
    kept = False
    try:
        q4_bytes = sum(t.numel() * t.element_size()
                       for t in tree_tensors(tree["blocks"]))
        _, cache, nxt, ttft = serve.ring_prefill(tree, cfg, args)
        plan = RingPlan.make(cfg, 4, 2)
        step = RingServeStep(cfg, plan, ring_params(tree, cfg, plan),
                             graphs=True, device=dev)
        ops.reset_launch_counts()
        res = serve.greedy_steps(serve.vocab_cut(step, cfg),
                                 serve.to_ring_cache(cache, cfg, plan),
                                 nxt, RANK_STEPS, dev, keep=True)
        launched(ops, {"flash_verify": RING_B5 * RANK_STEPS,
                       "q4_matmul": PROJECTIONS * RING_B5 * RANK_STEPS},
                 "resident q4 ring")
        want = {"flash_verify": RING_B5 * n,
                "q4_matmul": PROJECTIONS * RING_B5 * n}
        res_ms = 1e3 * float(np.median(res["step_s"][1:]))
        # B3 at the ring's own rows (a microbatch of 2 at qwen2.5-14b's
        # shapes): one eager step with every launch held against its plain
        # version on the same inputs
        errs = {}
        eager = RingServeStep(cfg, plan, step.params, graphs=False,
                              device=dev)
        with substituted(ops, "shadow", errs):
            eager(serve.to_ring_cache(cache, cfg, plan), nxt)
        if sorted(errs) != ["flash_verify", "q4_matmul"] \
                or errs["q4_matmul"] > Q4_TOL:
            raise AssertionError(f"resident q4 ring: launches against their "
                                 f"plain versions {errs} (B3 max|d|/max|ref|"
                                 f" bound {Q4_TOL})")
        log(f"  resident q4 ring, one eager step: every B3 launch (M = 2 "
            f"rows) within {errs['q4_matmul']:.3g} of max|ref| of its plain "
            f"version on the same inputs (bound {Q4_TOL}); B5 (bf16 out) "
            f"max|d| {errs['flash_verify']:.3g}")
        del step, eager
        gc.collect()
        torch.cuda.empty_cache()
        store = ParamStore(sdir)
        tracer = Tracer()
        drv = StreamingRingDriver(cfg, plan, store, prefetch_depth=2,
                                  device=dev, policy=serve.io_policy(args),
                                  tracer=tracer)
        ops.reset_launch_counts()
        try:
            with bank_copies(torch) as copies:
                run = serve.greedy_steps(drv.step,
                                         serve.to_ring_cache(cache, cfg, plan),
                                         nxt, n, dev)
        finally:
            drv.close()
            store.close()
        launched(ops, want, "streamed q4 ring")
        if not np.array_equal(run["tokens"], res["tokens"][:, :n]):
            raise AssertionError("streamed ring tokens differ from the "
                                 "resident q4 ring's")
        st = drv.stats()
        torch.cuda.synchronize()
        h2d = [a.elapsed_time(b) for a, b in copies]
        spans = [ev.duration for ev in tracer.events()
                 if ev.track == "ring-prefetcher"
                 and ev.name.startswith("bank[")]
        banks = staging_by_bank(plan, cfg.n_layers, spans, h2d, n)
        reads = [ev.duration for ev in tracer.events()
                 if ev.track == "ring-prefetcher"
                 and ev.name.startswith("layer_read[")]
        path = out_path("phase14_streamed_ring_trace.json")
        tracer.export_chrome_trace(path)
        info = validate_chrome_trace(path, ("decode", "ring",
                                            "ring-prefetcher"))
        summ = tracer.summary()
        stream_ms = 1e3 * float(np.median(run["step_s"][1:]))
        RING.update(q4_resident_ms=res_ms, q4_streamed_ms=stream_ms,
                    peak=st.peak_resident_bytes, q4_bytes=q4_bytes,
                    stall=st.stall_s, bank_ms=banks["span_ms"],
                    bank_h2d_ms=banks["h2d_ms"],
                    h2d_ms=float(np.median(h2d)),
                    read_ms=1e3 * float(np.median(reads)))
        log(f"  q4 ring (k 2, w {plan.w}, M 4) from a prefill of 8 x 512 "
            f"({ttft:.2f} s): resident graphed, {RANK_STEPS} steps, step "
            f"p50 {res_ms:.2f} ms; streamed (2 banks ahead), {n} steps, "
            f"{stream_ms:.2f} ms; tokens equal; {want} launches a run of "
            f"{n} steps ({PROJECTIONS} x {RING_B5} B3 a pass)")
        log(f"  streamed: peak resident weights "
            f"{st.peak_resident_bytes / 1e9:.3f} GB against the resident "
            f"q4 bank's {q4_bytes / 1e9:.3f} GB "
            f"({st.peak_resident_bytes / q4_bytes:.3f}); stall "
            f"{st.stall_s:.3f} s over {n} passes; {len(reads)} layer reads "
            f"({st.total_bytes_read / 1e9:.2f} GB), median read "
            f"{RING['read_ms']:.2f} ms; the worker's staging of a bank "
            f"that reads layers (trace span; {banks['n']} of {len(spans)} "
            f"banks, {banks['layers']} layers each, median): "
            f"{banks['span_ms']:.2f} ms, its H2D copies "
            f"{banks['h2d_ms']:.3f} ms device time (CUDA events); a "
            f"layer's H2D copy {RING['h2d_ms']:.3f} ms ({len(h2d)} "
            f"copies); stall split "
            f"per token: {format_summary(summ)}; trace "
            f"{os.path.relpath(path, ROOT)} ({info['n_events']} events, "
            f"tracks {info['tracks']})")
        path = os.path.join(sdir, "cache.pt")
        save_cache(torch, cache, path)
        RANK_REF.update(store=sdir, cache=path, first=nxt.cpu().numpy(),
                        k=plan.k, L=plan.L_pad, ms=res_ms,
                        tokens=res["tokens"],
                        logits=[lg.cpu() for lg in res["logits"]])
        del tree, cache, res, run
        gc.collect()
        torch.cuda.empty_cache()
        # (c) a stage dies mid-decode; Halda re-plans over the paper
        # cluster's survivors
        fargs = serve.parse_args(["--arch", "qwen2.5-14b", "--batch", "8",
                                  "--ctx", "64", "--prompt-len", "4",
                                  "--new-tokens", "6", "--seed", "0",
                                  "--stages", "4", "--tp", "1",
                                  "--ring-k", "2", "--dtype", "bf16"])
        fo = serve.serve_failover(
            sdir, cfg, fargs, stage=2, ranks=False,
            device_profiles=paper_table2_cluster(),
            model_profile=profile_from_config(cfg))
        ev = fo["event"]
        if ev.failed_stage != 2 or ev.tokens_lost or ev.halda is None:
            raise AssertionError(f"failover: {ev}")
        RING["failover"] = ev
        # the replay re-prefills the history one streamed pass a token, so
        # recovery grows with the history: at (b)'s 512-token prompts it
        # is the history times a pass
        per_pass = ev.replay_s / ev.replayed_tokens
        hist_b = int(args.prompt_len) + ev.token_index
        RING["replay_pass_s"] = per_pass
        RING["recovery_b_s"] = ev.recovery_s - ev.replay_s \
            + hist_b * per_pass
        log(f"  failover: stage 2 killed at token {ev.token_index} (a layer "
            f"read of the third pass); ring 4 -> {ev.n_stages_after} stages"
            f", plan {ev.plan}, Halda over the survivors {ev.halda}; "
            f"recovered in {ev.recovery_s:.3f} s with a history of "
            f"{ev.replayed_tokens} tokens ({fargs.prompt_len}-token prompts)"
            f": detect {ev.detect_s * 1e3:.2f} ms, re-solve "
            f"{ev.resolve_s * 1e3:.1f} ms, rebuild {ev.rebuild_s * 1e3:.1f} "
            f"ms, replay {ev.replay_s:.3f} s ({per_pass:.3f} s a streamed "
            f"pass); 0 tokens lost; the tokens after recovery equal a clean"
            f" survivor-ring run's")
        log(f"  recovery is the history times a pass: at (b)'s history of "
            f"{hist_b} tokens ({args.prompt_len}-token prompts) it would "
            f"take {RING['recovery_b_s']:.1f} s (extrapolated from this "
            f"replay's pass; {hist_b} x (b)'s streamed step "
            f"{stream_ms / 1e3:.3f} s = {hist_b * stream_ms / 1e3:.1f} s)")
        kept = True
    finally:
        if not kept:
            RANK_REF.clear()
            shutil.rmtree(sdir, ignore_errors=True)


def staging_by_bank(plan, n_layers, spans, h2d, passes):
    """The worker's staging per bank of the streamed ring: a bank stages
    the layers its rows first need in the pass (the others are staged
    already), so its ``bank[t]`` span holds their reads and the copies
    of those layers (in staging order) are its own. Medians over the
    banks that read a layer: span ms, the summed H2D device ms of its
    copies, and the layers it read."""
    from repro_torch.runtime.serve import ring_bank_layers

    seen, new = set(), []
    for t in range(plan.n_steps):
        fresh = {int(x) for x in ring_bank_layers(plan, t)
                 if x < n_layers} - seen
        new.append(len(fresh))
        seen |= fresh
    if len(spans) != passes * plan.n_steps \
            or len(h2d) != passes * sum(new):
        raise AssertionError(f"{len(spans)} bank spans and {len(h2d)} "
                             f"copies for {passes} passes of {new}")
    span_ms, dev_ms, layers, i = [], [], [], 0
    for p in range(passes):
        for t, k in enumerate(new):
            if k:
                span_ms.append(1e3 * spans[p * plan.n_steps + t])
                dev_ms.append(sum(h2d[i:i + k]))
                layers.append(k)
            i += k
    return {"span_ms": float(np.median(span_ms)),
            "h2d_ms": float(np.median(dev_ms)),
            "layers": int(np.median(layers)), "n": len(span_ms)}


def ring_parity(torch, ops, serve) -> None:
    """Phase 14 (d): 4 layers at full width, f32, eager: the ring with
    every launch shadowed by its plain version on the same inputs against
    the ring on ``use_kernels(False)``."""
    from repro_torch.runtime.serve import RingPlan, RingServeStep, ring_params

    args = serve.parse_args(RING_ARGS + ["--dtype", "f32", "--layers", "4",
                                         "--new-tokens", "8"])
    dev = torch.device("cuda")
    cfg, params = serve.build_model(args)
    _, cache, nxt, _ = serve.ring_prefill(params, cfg, args)
    plan = RingPlan.make(cfg, 4, 1)
    rp = ring_params(params, cfg, plan)
    errs = {}
    with substituted(ops, "shadow", errs):
        kern = serve.greedy_steps(
            RingServeStep(cfg, plan, rp, graphs=False, device=dev),
            serve.to_ring_cache(cache, cfg, plan), nxt, 8, dev, keep=True)
    ops.use_kernels(False)
    try:
        plain = serve.greedy_steps(
            RingServeStep(cfg, plan, rp, graphs=False, device=dev),
            serve.to_ring_cache(cache, cfg, plan), nxt, 8, dev, keep=True)
    finally:
        ops.use_kernels(True)
    if sorted(errs) != ["flash_verify"] or errs["flash_verify"] > 2e-5:
        raise AssertionError(f"ring parity: launches against their plain "
                             f"versions {errs} (atol 2e-5, B5 only)")
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(kern["logits"], plain["logits"]))
    equal = np.array_equal(kern["tokens"], plain["tokens"])
    if worst >= LOGIT_REL or not equal:
        raise AssertionError(f"ring parity: logits within {worst:.3g} "
                             f"(bound {LOGIT_REL}), tokens equal {equal}")
    log(f"  ring (M 4, k 1) at 4 layers, f32: every B5 launch within "
        f"{errs['flash_verify']:.3g} of its plain version on the same "
        f"inputs; logits within {worst:.3g} of max|ref| of the plain ring "
        f"for 8 steps; tokens equal")
    del params, cache, kern, plain
    gc.collect()
    torch.cuda.empty_cache()


def report_ring() -> None:
    """Phase 14's numbers beside the card."""
    log(f"  on {card()}:")
    for k in (1, 2):
        r = RING[f"k{k}"]
        log(f"    bf16 ring k={k}: step p50 graphed {r['graphed_ms']:.2f} ms,"
            f" eager {r['eager_ms']:.2f} ms, verify T=5 "
            f"{r['verify_ms']:.2f} ms; one-device step "
            f"{RING['one_device_ms']:.2f} ms; splits {r['splits']}")
    ev = RING["failover"]
    log(f"    q4 ring k=2: resident {RING['q4_resident_ms']:.2f} ms, "
        f"streamed {RING['q4_streamed_ms']:.2f} ms a step; peak "
        f"{RING['peak'] / 1e9:.3f} of {RING['q4_bytes'] / 1e9:.3f} GB; stall"
        f" {RING['stall']:.3f} s; a bank's staging {RING['bank_ms']:.2f} ms"
        f" (H2D {RING['bank_h2d_ms']:.3f} ms device), a layer's H2D "
        f"{RING['h2d_ms']:.3f} ms; recovery {ev.recovery_s:.3f} s at a "
        f"history of {ev.replayed_tokens} tokens, "
        f"{RING['replay_pass_s']:.3f} s a replayed token "
        f"({RING['recovery_b_s']:.1f} s extrapolated to (b)'s history)")


# --------------------------------------------------------------------------- #
#  phase 15: the moe family (mixtral-8x7b, phi3.5-moe)
# --------------------------------------------------------------------------- #

MOE_ARCH = "mixtral-8x7b"
MOE_ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
#: (a) and (c): the depth of the q4 store (mixtral has 32 layers; cut
#: for time)
MOE_LAYERS = 8
#: (a): phase 5's mix at mixtral's published width
MOE_STREAM_ARGS = ["--arch", MOE_ARCH, "--batch", "8", "--ctx", "640",
                   "--requests", "8", "--prompt-len", "128",
                   "--prompt-len-max", "513", "--new-tokens", "16",
                   "--seed", "0", "--stream-window", "4", "--store-quant",
                   "q4"]
#: (c): 8 prompts of 128 tokens over 4 stages at k 1
MOE_RING_ARGS = ["--arch", MOE_ARCH, "--batch", "8", "--ctx", "640",
                 "--prompt-len", "128", "--new-tokens", "8", "--seed", "0",
                 "--stages", "4"]
#: (b): phase 3's mix, 8 of mixtral's 32 layers in bf16
MOE_PAGED_LAYERS = 8
MOE_PAGED_ARGS = ["--arch", MOE_ARCH, "--batch", "8", "--ctx", "2048",
                  "--page-tokens", "16", "--prefill-chunk", "256",
                  "--prompt-len", "256", "--prompt-len-max", "1025",
                  "--requests", "16", "--new-tokens", "32", "--seed", "0",
                  "--layers", str(MOE_PAGED_LAYERS), "--dtype", "bf16"]
#: (d): ``PARITY_LAYERS`` layers at full width, f32
MOE_PARITY_ARGS = ["--batch", "4", "--ctx", "512", "--page-tokens", "16",
                   "--prefill-chunk", "128", "--prompt-len", "64",
                   "--prompt-len-max", "257", "--requests", "6",
                   "--new-tokens", "8", "--seed", "1",
                   "--layers", str(PARITY_LAYERS),
                   "--dtype", "f32"]
#: phase 15's record, printed at its end beside the card
MOE = {}


def moe_streamed(torch, ops, serve):
    """Phase 15 (a) and (c): mixtral-8x7b at published width and depth as
    a q4 store built on the card one layer at a time; the layer-wise
    engine with the q4 weights resident, then streamed (window 4); then
    the resident q4 bank through the ring. Returns the streamed run's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.paramstore import ParamStore, ResidentSource
    from repro_torch.runtime.streaming import StreamingParamSource

    args = serve.parse_args(MOE_STREAM_ARGS + ["--dtype", "bf16"])
    cfg = dataclasses.replace(get_config(args.arch), n_layers=MOE_LAYERS)
    log(f"  depth cut: {MOE_LAYERS} of {get_config(args.arch).n_layers} "
        f"layers")
    W, L, b3 = args.stream_window, cfg.n_layers, moe_b3(cfg)
    sdir, tree = write_store(torch, cfg, torch.bfloat16, seed=0)
    try:
        store = ParamStore(sdir)
        nbytes = store.layer_nbytes
        raw = sum(layer_params(cfg))
        log(f"  store: {store.quant_format}, manifest v{store.version}, "
            f"{nbytes / 1e9:.3f} GB/layer (the bf16 layer: "
            f"{2 * raw / 1e9:.3f} GB, ratio {nbytes / (2 * raw):.3f}); "
            f"{L} layers, {nbytes * L / 1e9:.2f} GB")
        store.close()
        reqs = serve.make_requests(cfg, args)
        streams, counts = {}, {}
        for name in ("resident", "streamed"):
            src = ResidentSource(tree) if name == "resident" else \
                StreamingParamSource(ParamStore(sdir), window=W)
            ops.reset_launch_counts()
            try:
                res = serve.serve_layerwise(src, cfg, reqs, args)
            finally:
                src.close()
            counts[name] = ops.launch_counts()
            res["requests"] = reqs
            check_served(res)
            stream_summary(f"{name} q4 weights", res, nbytes * L)
            passes = len(reqs) + res["steps"]
            want = {"q4_matmul": b3 * L * passes,
                    "flash_verify": L * res["steps"]}
            launched(ops, want, f"moe {name}")
            log(f"  {name}: {want['q4_matmul']} q4_matmul launches = "
                f"{passes} passes x {L} layers x {b3} (4 attention "
                f"projections + 3 x {cfg.n_experts} experts); "
                f"{want['flash_verify']} flash_verify launches = "
                f"{res['steps']} decode steps x {L} layers")
            streams[name] = {f.uid: f.tokens for f in res["finished"]}
            MOE[name] = {"wall_s": res["wall_s"], "steps": res["steps"],
                         **res["summary"]}
            if name == "streamed":
                st = res["stats"]
                if st.peak_resident_bytes >= (W + 1) * nbytes \
                        or st.layers_served != L * passes:
                    raise AssertionError(
                        f"streamed: peak resident {st.peak_resident_bytes} "
                        f"B (bound {W + 1} layers of {nbytes} B), "
                        f"{st.layers_served} layers served")
                MOE["peak_layers"] = st.peak_resident_bytes / nbytes
                MOE["read_ms"] = st.median_layer_read_s * 1e3
                MOE["stall_s"] = st.stall_s
                log(f"  streamed: peak resident weights "
                    f"{st.peak_resident_bytes / nbytes:.2f} layers (under "
                    f"{W + 1}); {len(st.events)} layer reads, median "
                    f"{st.median_layer_read_s * 1e3:.2f} ms each; stall "
                    f"{st.stall_s:.3f} s; the resident run held all {L} "
                    f"layers ({nbytes * L / 1e9:.2f} GB)")
        if streams["streamed"] != streams["resident"]:
            bad = [u for u, t in streams["resident"].items()
                   if streams["streamed"].get(u) != t]
            raise AssertionError(f"streamed tokens differ from the "
                                 f"resident run's for uids {bad}")
        log(f"  streamed and resident tokens equal for {len(reqs)} "
            f"requests")
        moe_ring(torch, ops, serve, cfg, tree)
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
        del tree
        gc.collect()
        torch.cuda.empty_cache()
    return counts["streamed"]


def moe_ring(torch, ops, serve, cfg, tree):
    """Phase 15 (c): the resident q4 bank over 4 stages at k 1, graphed,
    against the one-device decode of the same cache (streams equal but at
    near ties, phase 7's rule); (4 + 3 E) x L x 4 B3 launches a pass; one
    eager step with every B3 launch held against its plain version."""
    from repro_torch.runtime.serve import RingPlan, RingServeStep, ring_params

    args = serve.parse_args(MOE_RING_ARGS + ["--dtype", "bf16"])
    dev, n, M = torch.device("cuda"), int(args.new_tokens), args.stages
    _, cache, nxt, ttft = serve.ring_prefill(tree, cfg, args)
    plan = RingPlan.make(cfg, M, 1)
    step = RingServeStep(cfg, plan, ring_params(tree, cfg, plan),
                         graphs=True, device=dev)
    per_pass = {"flash_verify": cfg.n_layers * M,
                "q4_matmul": moe_b3(cfg) * cfg.n_layers * M}
    ops.reset_launch_counts()
    run = serve.greedy_steps(step, serve.to_ring_cache(cache, cfg, plan),
                             nxt, n, dev, keep=True)
    launched(ops, {k: v * n for k, v in per_pass.items()}, "moe q4 ring")
    one = serve.greedy_steps(serve.one_device_decode(tree, cfg, dev),
                             serve.clone_cache(cache), nxt, n, dev,
                             keep=True)
    worst, n_equal, splits = near_tie_only(
        "moe q4 ring against the one-device decode", by_row(run),
        by_row(one), SPEC_BF16_REL)
    ring_ms = 1e3 * float(np.median(run["step_s"][1:]))
    one_ms = 1e3 * float(np.median(one["step_s"][1:]))
    errs = {}
    eager = RingServeStep(cfg, plan, step.params, graphs=False, device=dev)
    with substituted(ops, "shadow", errs):
        eager(serve.to_ring_cache(cache, cfg, plan), nxt)
    if sorted(errs) != ["flash_verify", "q4_matmul"] \
            or errs["q4_matmul"] > Q4_TOL:
        raise AssertionError(f"moe q4 ring: launches against their plain "
                             f"versions {errs} (B3 bound {Q4_TOL})")
    MOE.update(ring_ms=ring_ms, ring_one_ms=one_ms,
               ring_splits=len(splits), ring_b3_err=errs["q4_matmul"])
    log(f"  q4 ring (k 1, w {plan.w}, M {M}), {n} graphed steps from a "
        f"prefill of 8 x {args.prompt_len} ({ttft:.2f} s): step p50 "
        f"{ring_ms:.2f} ms against the one-device step's {one_ms:.2f} ms; "
        f"{per_pass} launches a pass, exactly; streams equal to the "
        f"one-device decode's for {n_equal} of 8 rows, logits within "
        f"{worst:.3g} of max|ref| up to each row's first difference; "
        f"splits: {splits}; one eager step: every B3 launch (M = 2 rows, "
        f"each expert at C = 2) within {errs['q4_matmul']:.3g} of max|ref| "
        f"of its plain version (bound {Q4_TOL}), B5 max|d| "
        f"{errs['flash_verify']:.3g}")
    del step, eager, run, one, cache
    gc.collect()
    torch.cuda.empty_cache()


def moe_paged_run(torch, ops, params, cfg, reqs, args, graphs):
    """The paged engine as ``serve.serve_paged`` builds it (bf16 pages),
    graphed or eager, keeping every decode step's logits by (uid, token
    index) and counting its decode steps. Returns (streams, logits,
    launches, decode steps, wall, graphs' note)."""
    from repro_torch.runtime.kvcache import make_paged_engine

    B, bs = args.batch, args.page_tokens
    eng, kv = make_paged_engine(params, cfg, B, args.ctx,
                                n_pages=2 + B * (-(-args.ctx // bs)),
                                page_tokens=bs, cache_dtype=torch.bfloat16,
                                prefill_chunk=args.prefill_chunk,
                                graphs=graphs, device="cuda")
    logits, n_dec = {}, [0]
    decode = eng.decode

    def decode_(cache, tokens):
        out = decode(cache, tokens)
        n_dec[0] += 1
        for i in eng.active():
            st = eng.slots[i]
            logits[(st.uid, len(st.generated))] = out[0][i, 0].float().clone()
        return out

    eng.decode = decode_
    ops.reset_launch_counts()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin, _ = eng.run(kv.init_cache(), reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        kv.close()
    check_served({"finished": fin, "rejected": eng.rejected,
                  "requests": reqs})
    note = graph_note(eng) if graphs else "eager"
    return ({f.uid: f.tokens for f in fin}, logits, ops.launch_counts(),
            n_dec[0], wall, note)


def moe_paged(torch, ops, serve):
    """Phase 15 (b): ``MOE_PAGED_LAYERS`` of mixtral's 32 layers in bf16
    through the paged
    engine, graphed against eager. Every prompt chunk launches B2 once a
    layer and every decode step B1 once a layer, exactly; streams equal,
    logits max|d| between the two printed. Returns the graphed run's
    launches."""
    args = serve.parse_args(MOE_PAGED_ARGS)
    t0 = time.perf_counter()
    cfg, params = serve.build_model(args)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    log(f"  weights: {n_par / 1e9:.2f} B params in bf16 on the card, made "
        f"in {time.perf_counter() - t0:.1f} s")
    reqs = serve.make_requests(cfg, args)
    chunks = cfg.n_layers * sum(-(-len(r.prompt) // args.prefill_chunk)
                                for r in reqs)
    runs = {}
    for graphs in (True, False):
        way = "graphed" if graphs else "eager"
        streams, logits, got, steps, wall, note = moe_paged_run(
            torch, ops, params, cfg, reqs, args, graphs)
        want = {"paged_prefill": chunks,
                "paged_verify": cfg.n_layers * steps}
        launched(ops, want, f"moe paged {way}")
        runs[way] = (streams, logits)
        MOE[f"paged_{way}"] = {"wall_s": wall, "steps": steps}
        log(f"  paged, {way}: {len(reqs)} requests in {wall:.3f} s, "
            f"{steps} decode steps; {want} launches, exactly (B2 "
            f"{cfg.n_layers} a chunk, B1 {cfg.n_layers} a step); {note}")
    if runs["graphed"][0] != runs["eager"][0]:
        raise AssertionError("moe paged: graphed and eager streams differ")
    d = max(float((runs["graphed"][1][key] - lg).abs().max())
            for key, lg in runs["eager"][1].items())
    MOE["paged_counts"] = want
    log(f"  paged: graphed and eager streams equal for {len(reqs)} "
        f"requests; decode logits max|d| {d:.3g} between them")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_prefill": chunks,
            "paged_verify": want["paged_verify"]}


def moe_parity(torch, ops, serve) -> None:
    """Phase 15 (d): mixtral-8x7b and phi3.5-moe at ``PARITY_LAYERS``
    layers, full width, f32, eager, kernels against ``use_kernels(False)``: the dense engine,
    the paged engine (chunked admission, f32 and int8 pages) and the
    layer-wise engine over a q4 store. Every launch is held against its
    plain version on the same inputs (attention atol 2e-5, B3 1e-5 of
    max|ref|); f32 runs must agree to LOGIT_REL with equal streams; int8
    pages as phase 4 holds them."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.engine import make_dense_engine
    from repro_torch.runtime.paramstore import (ParamStore, ResidentSource,
                                                save_param_store)
    from repro_torch.runtime.streaming import StreamingParamSource

    for arch in MOE_ARCHS:
        args = serve.parse_args(["--arch", arch] + MOE_PARITY_ARGS)
        cfg, params = serve.build_model(args)
        reqs = serve.make_requests(cfg, args)
        found = {}

        def hold(label, want, run_kern, run_plain):
            errs = {}
            with substituted(ops, "shadow", errs):
                kern = run_kern()
            ops.use_kernels(False)
            try:
                plain = run_plain()
            finally:
                ops.use_kernels(True)
            att = max((v for k, v in errs.items() if k != "q4_matmul"),
                      default=0.0)
            if sorted(errs) != sorted(want) or att > 2e-5 \
                    or errs.get("q4_matmul", 0.0) > Q4_TOL:
                raise AssertionError(f"{arch} {label}: launches against "
                                     f"their plain versions {errs} (wanted "
                                     f"{want})")
            worst, n_equal, splits = compare_runs(kern, plain)
            found[label] = (worst, n_equal, errs)
            return kern, plain, worst, n_equal, splits

        def dense_run():
            eng = make_dense_engine(params, cfg, args.batch, args.ctx,
                                    cache_dtype=torch.float32, graphs=False,
                                    device="cuda")
            run = logged_run(torch, eng, "prefill", init_cache(
                cfg, args.batch, args.ctx, dtype=torch.float32,
                device="cuda"), reqs)
            return run["streams"], run["logits"]

        *_, worst, n_equal, _ = hold("dense", ("flash_verify",), dense_run,
                                     dense_run)
        if worst >= LOGIT_REL or n_equal != len(reqs):
            raise AssertionError(f"{arch} dense: {worst} of max|ref|, "
                                 f"{n_equal} streams equal")
        for quant in (False, True):
            c = dataclasses.replace(cfg, kv_dtype="int8") if quant else cfg
            label = "paged int8" if quant else "paged f32"

            def paged_run(c=c):
                return traced_paged_run(torch, params, c, reqs, args)
            want = ("paged_verify_quant",) if quant else ("paged_prefill",
                                                          "paged_verify")
            kern, plain, worst, n_equal, _ = hold(label, want, paged_run,
                                                  paged_run)
            if not quant and (worst >= LOGIT_REL or n_equal != len(reqs)):
                raise AssertionError(f"{arch} {label}: {worst} of max|ref|,"
                                     f" {n_equal} streams equal")
            if quant:
                flips = int8_flips(torch, kern[2], plain[2])
                if flips[0] == 0 and worst > LOGIT_REL:
                    raise AssertionError(f"{arch} int8 pages: logits differ "
                                         f"by {worst} with no int8 byte "
                                         f"differing")
                found[label] += (flips,)
        args.store_quant = "q4"
        tree, _ = serve.store_tree(params, cfg, args)
        del params
        gc.collect()
        sdir = tempfile.mkdtemp(prefix="chip_smoke_moe_parity_")
        try:
            save_param_store(tree, cfg, sdir)

            def streamed():
                return traced_stream_run(
                    torch, StreamingParamSource(ParamStore(sdir), window=2),
                    cfg, reqs, args)

            def resident():
                return traced_stream_run(torch, ResidentSource(tree), cfg,
                                         reqs, args)
            *_, worst, n_equal, _ = hold("streamed q4",
                                         ("flash_verify", "q4_matmul"),
                                         streamed, resident)
        finally:
            shutil.rmtree(sdir, ignore_errors=True)
        if worst >= LOGIT_REL or n_equal != len(reqs):
            raise AssertionError(f"{arch} streamed q4: {worst} of max|ref|,"
                                 f" {n_equal} streams equal")
        for label, (worst, n_equal, errs, *flips) in found.items():
            errs_s = ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            log(f"  {arch}, {args.layers} layers f32, {label}: every launch "
                f"within its "
                f"plain version's on the same inputs by ({errs_s}; B3 over "
                f"max|ref|); logits within "
                f"{worst:.3g} of max|ref|; streams equal for {n_equal} of "
                f"{len(reqs)}"
                + (f"; (layer, page) pairs with differing int8 bytes: "
                   f"{flips[0][0]} of {flips[0][2]}" if flips else ""))
        MOE[f"parity_{arch}"] = {k: v[0] for k, v in found.items()}
        del tree
        gc.collect()
        torch.cuda.empty_cache()


def moe_profile(torch) -> None:
    """Phase 15 (e): the card's ``DeviceProfile`` from the port's probes,
    and Halda's plan for mixtral-8x7b in q4 over it."""
    from repro_torch.configs import get_config
    from repro_torch.core import halda
    from repro_torch.core.profiler import profile_local_device
    from repro_torch.core.profiles import profile_from_config

    t0 = time.perf_counter()
    prof = profile_local_device("h100", device="cuda")
    secs = time.perf_counter() - t0
    log(f"  DeviceProfile in {secs:.1f} s: vram_avail "
        f"{prof.vram_avail / 1e9:.2f} GB, gpu f32 "
        f"{prof.gpu_flops['f32'] / 1e12:.2f} TFLOP/s, bf16 (the q4/q8 "
        f"types' rate) {prof.gpu_flops['q4k'] / 1e12:.2f} TFLOP/s, gpu "
        f"membw {prof.gpu_membw / 1e9:.1f} GB/s, KV line copy "
        f"{prof.t_kv_copy_gpu * 1e6:.2f} us; host: ram_avail "
        f"{prof.ram_avail / 1e9:.1f} GB, cpu f32 "
        f"{prof.cpu_flops['f32'] / 1e9:.1f} GFLOP/s, cpu membw "
        f"{prof.cpu_membw / 1e9:.1f} GB/s, disk seq "
        f"{prof.disk_seq_bps / 1e9:.2f} GB/s, rand "
        f"{prof.disk_rand_bps / 1e9:.2f} GB/s")
    if not (prof.has_cuda and prof.vram_avail > 0
            and prof.gpu_flops["f32"] > 0 and prof.gpu_membw > 0):
        raise AssertionError(f"the card's profile lacks its terms: {prof}")
    model = profile_from_config(get_config(MOE_ARCH), quant="q4k")
    sol = halda.solve([prof], model)
    if sum(sol.w) * sol.k != model.n_layers or not sol.latency > 0:
        raise AssertionError(f"Halda's plan: {sol}")
    MOE.update(profile=prof, plan=sol)
    log(f"  Halda over the card for mixtral-8x7b q4 ({model.n_layers} "
        f"layers of {model.layer_bytes / 1e9:.3f} GB): w {sol.w}, n "
        f"{sol.n}, k {sol.k}, cases {[c.name for c in sol.cases]}, modeled "
        f"token latency {sol.latency * 1e3:.2f} ms")


def report_moe() -> None:
    """Phase 15's numbers again, beside the card's name and power limit."""
    log(f"  card: {card()}")
    for name in ("resident", "streamed"):
        r = MOE[name]
        log(f"  (a) mixtral-8x7b q4, {MOE_LAYERS} layers, {name}: wall "
            f"{r['wall_s']:.3f} s, {r['steps']} steps, TTFT p50 "
            f"{r['ttft_p50_s'] * 1e3:.2f} ms, TPOT p50 "
            f"{r['tpot_p50_s'] * 1e3:.2f} ms, {r['tokens_per_s']:.2f} "
            f"tokens/s")
    log(f"  (a) streamed: peak {MOE['peak_layers']:.2f} layers, median "
        f"layer read {MOE['read_ms']:.2f} ms, stall {MOE['stall_s']:.3f} s")
    log(f"  (b) paged bf16, 8 layers: graphed "
        f"{MOE['paged_graphed']['wall_s']:.3f} s, eager "
        f"{MOE['paged_eager']['wall_s']:.3f} s ({MOE['paged_counts']})")
    log(f"  (c) q4 ring step {MOE['ring_ms']:.2f} ms against one device "
        f"{MOE['ring_one_ms']:.2f} ms, {MOE['ring_splits']} splits")
    for arch in MOE_ARCHS:
        worst = ", ".join(f"{k} {v:.3g}"
                          for k, v in MOE[f"parity_{arch}"].items())
        log(f"  (d) {arch}, logits over max|ref| against the plain "
            f"versions: {worst}")


# --------------------------------------------------------------------------- #
#  phase 16: the four families left (MLA, vlm, hybrid, audio)
# --------------------------------------------------------------------------- #

MLA_ARCH, VLM_ARCH = "minicpm3-4b", "qwen2-vl-2b"
#: (a)'s depth: 8 of minicpm3-4b's 62 layers (cut for time)
MLA_LAYERS = 8
HYB_ARCH, AUD_ARCH = "recurrentgemma-9b", "whisper-tiny"
#: phase 3's paged mix, for any --arch
PAGED_MIX = ["--batch", "8", "--ctx", "2048", "--page-tokens", "16",
             "--prefill-chunk", "256", "--prompt-len", "256",
             "--prompt-len-max", "1025", "--requests", "16",
             "--new-tokens", "32", "--seed", "0", "--dtype", "bf16"]
#: (a)'s streamed run: phase 5's mix (a q4 store, window 4)
STREAM_MIX = STREAM_ARGS[2:] + ["--dtype", "bf16"]
#: (a)'s tiered run: the first two requests of each of phase 13's groups
#: (768-token prefixes) through 128 device and 32 host pages of 62 layers
#: of latent lines (571 KB a page): two requests fit at a time, so the
#: other groups' prefixes go to the host and the disk and come back
FAM_TIER_PAGES = (128, 32)
#: (b)'s ring: phase 14's (8 prompts of 512 tokens, 4 stages) at k 1
VLM_RING = RING_ARGS[2:] + ["--dtype", "bf16"]
#: (b)'s patches: a 16 x 16 grid of patch embeddings before the prompt
VLM_PATCHES = 16
#: (c): 8 slots, ctx 4096 (the attention layers keep min(ctx, window) =
#: 2048 rolling lines), prompts of 1024-3000 tokens, 32 new tokens
HYB_ARGS = ["--arch", HYB_ARCH, "--batch", "8", "--ctx", "4096",
            "--requests", "8", "--prompt-len", "1024", "--prompt-len-max",
            "3001", "--new-tokens", "32", "--seed", "0", "--dtype", "bf16"]
#: (d): 8 sequences of 1500 frames, a 16-token prompt, then decode until
#: the 448-line self-attention cache is full
AUD_B, AUD_PROMPT = 8, 16
#: (e): 4 layers at full width, f32 (hybrid: one group and a tail)
FAM_PARITY_ARGS = ["--batch", "4", "--ctx", "512", "--page-tokens", "16",
                   "--prefill-chunk", "128", "--prompt-len", "64",
                   "--prompt-len-max", "257", "--requests", "6",
                   "--new-tokens", "8", "--seed", "1", "--layers", "4",
                   "--dtype", "f32"]
#: B3 launches an MLA layer a layer-wise pass: ``wo`` and the FFN's three
#: (the latent projections are dequantized when the layer is pulled, as in
#: the JAX package)
MLA_B3 = 4
#: phase 16's record, printed at its end beside the card
FAM = {}


def free_card(torch) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.ipc_collect()        # blocks rank processes held, released


def held(torch, ops, label, want, run_kern, run_plain, int8=False):
    """Phase 16 (e): ``run_kern`` with every launch also run through its
    plain version on the same inputs (attention atol 2e-5, B3 within
    Q4_TOL of max|ref|; the kernels launched must be ``want``), then
    ``run_plain`` under ``use_kernels(False)``; logits within LOGIT_REL of
    max|ref| and streams equal (``int8`` pages, as phase 4 holds them:
    logits may differ only where an int8 page byte does). Returns (worst,
    streams equal, errs)."""
    errs = {}
    with substituted(ops, "shadow", errs):
        kern = run_kern()
    ops.use_kernels(False)
    try:
        plain = run_plain()
    finally:
        ops.use_kernels(True)
    att = max((v for k, v in errs.items() if k != "q4_matmul"),
              default=0.0)
    if sorted(errs) != sorted(want) or att > 2e-5 \
            or errs.get("q4_matmul", 0.0) > Q4_TOL:
        raise AssertionError(f"{label}: launches against their plain "
                             f"versions {errs} (wanted {sorted(want)})")
    worst, n_equal, splits = compare_runs(kern, plain)
    if int8:
        flips = int8_flips(torch, kern[2], plain[2])
        if flips[0] == 0 and worst > LOGIT_REL:
            raise AssertionError(f"{label}: logits differ by {worst} with "
                                 f"no int8 byte differing")
        errs["flipped (layer, page) pairs"] = flips[0]
    elif worst >= LOGIT_REL or splits:
        raise AssertionError(f"{label}: logits {worst} of max|ref| (bound "
                             f"{LOGIT_REL}), splits {splits}")
    return worst, n_equal, errs


def fam_paged(torch, ops, params, cfg, reqs, args, label):
    """The paged mix graphed and eager (``traced_paged_run``, bf16 pages)
    with exact launch counts: B2 a layer a chunk and B1 a layer a decode
    step, or B4 for both over int8 pages, or none for MLA's latent pages
    (its attention is plain torch, as in the reference). Returns the
    graphed run and its launches."""
    chunks = cfg.n_layers * sum(-(-len(r.prompt) // args.prefill_chunk)
                                for r in reqs)
    runs = {}
    for graphs in (True, False):
        way = "graphed" if graphs else "eager"
        steps = [0]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = traced_paged_run(torch, params, cfg, reqs, args, graphs=graphs,
                               dtype=torch.bfloat16, count=steps)
        wall = time.perf_counter() - t0
        layer_steps = cfg.n_layers * steps[0]
        if cfg.mla:
            want = {}
        elif cfg.kv_dtype == "int8":
            want = {"paged_verify_quant": chunks + layer_steps}
        else:
            want = {"paged_prefill": chunks, "paged_verify": layer_steps}
        runs[way] = (run, launched(ops, want, f"{label} paged {way}"))
        log(f"  {label}, paged {way}: {len(reqs)} requests in {wall:.3f} s "
            f"(logits kept), {steps[0]} decode steps; launches {want or 0}"
            f" exactly")
        FAM[f"{label}_paged_{way}"] = {"wall_s": wall, "steps": steps[0]}
    if runs["graphed"][0][0] != runs["eager"][0][0]:
        raise AssertionError(f"{label}: graphed and eager streams differ")
    d = max(float((runs["graphed"][0][1][k] - v).abs().max())
            for k, v in runs["eager"][0][1].items())
    log(f"  {label}: graphed and eager streams equal for {len(reqs)} "
        f"requests, logits max|d| {d:.3g} between them")
    return runs["graphed"]


def dense_against_paged(torch, ops, params, cfg, reqs, args, paged, label):
    """The dense-cache engine (graphed decode) on the paged mix: B5 a layer
    a decode step (none for MLA, whose decode is plain torch); its bf16
    streams against the paged run's under phase 7's near-tie rule (the
    dense prefill sums in another order than the paged chunks)."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.engine import make_dense_engine

    eng = make_dense_engine(params, cfg, args.batch, args.ctx,
                            cache_dtype=torch.bfloat16, device="cuda")
    ops.reset_launch_counts()
    run = logged_run(torch, eng, "prefill", init_cache(
        cfg, args.batch, args.ctx, dtype=torch.bfloat16, device="cuda"),
        reqs)
    launched(ops, {} if cfg.mla else {"flash_verify": cfg.n_layers
                                      * run["steps"]}, f"{label} dense")
    worst, n_equal, splits = near_tie_only(
        f"{label} dense against paged", (run["streams"], run["logits"]),
        paged[:2], SPEC_BF16_REL)
    log(f"  {label}, dense-cache engine: {run['steps']} decode steps in "
        f"{run['wall']:.3f} s; streams equal to the paged run's for "
        f"{n_equal} of {len(reqs)}, logits within {worst:.3g} of max|ref| "
        f"up to each first difference; splits {splits}")
    del eng, run
    free_card(torch)


def mla_verify(torch, params, cfg):
    """(a): a T = 5 verify pass over latent pages against 5 single steps
    from the same pages (a 700-token prompt, bf16): logits within phase
    7's bound and the same tokens but at near ties."""
    from repro_torch.models import init_cache
    from repro_torch.models import model as M
    from repro_torch.runtime.kvcache import PagedKVCache

    rng = np.random.default_rng(16)
    prompt = rng.integers(0, cfg.vocab, 700)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (1, 5)), device="cuda")
    kv = PagedKVCache(cfg, batch=1, ctx=1024, n_pages=70, page_tokens=16,
                      dtype=torch.bfloat16, offload=False, device="cuda")
    try:
        cache = kv.init_cache()
        kv.plan_admit(cache, 0, [int(t) for t in prompt], 8)
        c1 = init_cache(cfg, 1, 1024, dtype=torch.bfloat16, device="cuda")
        _, c1 = M.prefill(params, cfg, torch.tensor(prompt[None],
                                                    device="cuda"), c1)
        cache = kv.install(cache, 0, c1["layers"], len(prompt))
        cache = kv.begin_step(cache, [0], 5)
        ln0 = cache["len"].clone()
        multi, cache = M.decode_step_paged(params, cfg, cache, toks)
        single = []
        for t in range(5):
            M.rollback_cache(cache, ln0 + t)
            one, _ = M.decode_step_paged(params, cfg, cache, toks[:, t:t + 1])
            single.append(one[0, 0].float())
    finally:
        kv.close()
    single = torch.stack(single)
    multi = multi[0].float()
    top = float(single.abs().max())
    d = float((multi - single).abs().max()) / top
    a, b = multi.argmax(-1), single.argmax(-1)
    for t in torch.nonzero(a != b).flatten().tolist():
        gap = float(single[t, b[t]] - single[t, a[t]]) / top
        if gap > 2 * d:
            raise AssertionError(f"MLA verify row {t}: token differs at a "
                                 f"gap {gap} (logit difference {d})")
    if d >= SPEC_BF16_REL:
        raise AssertionError(f"MLA verify: {d} of max|ref| from 5 steps")
    FAM["mla_verify"] = d
    log(f"  minicpm3-4b verify T=5 over latent pages (700-token prompt): "
        f"logits within {d:.3g} of max|ref| of 5 single steps; tokens "
        f"equal for {int((a == b).sum())} of 5 rows")


def mla_tiers(torch, serve, params, cfg, args):
    """(a): the first two requests of each of phase 13's four prefix
    groups through a tiered paged engine (``FAM_TIER_PAGES`` device and
    host pages of latent lines, cost eviction, page files): every page
    recalled from the host or disk bit-equal to its bytes at eviction, the
    streams against an unbudgeted run (near ties only)."""
    from repro_torch.runtime.memory import MemoryBudget, TierManager

    reqs = [r for r in tier_requests(serve, cfg.vocab) if r.uid < 8]
    pb = cfg.n_layers * args.page_tokens * (cfg.kv_lora_rank
                                            + cfg.qk_rope_dim) * 2
    dev, host = FAM_TIER_PAGES
    ddir = tempfile.mkdtemp(prefix="chip_smoke_mla_kv_")
    try:
        ref = tier_run(torch, serve, params, cfg, reqs, args)
        tier = tier_run(torch, serve, params, cfg, reqs, args,
                        memory=TierManager(MemoryBudget(device=dev * pb,
                                                        host=host * pb)),
                        disk_dir=ddir, watch=True)
    finally:
        shutil.rmtree(ddir, ignore_errors=True)
    st, rec = tier["stats"], tier["recalls"]
    fetched = st.fetched_bytes // pb
    if st.page_bytes != pb or rec["bad"] or rec["checked"] != fetched \
            or not fetched:
        raise AssertionError(f"MLA tiers: pages of {st.page_bytes} B "
                             f"(wanted {pb}); {len(rec['bad'])} of "
                             f"{rec['checked']} recalled pages differ, "
                             f"{fetched} fetched")
    worst, n_equal, splits = near_tie_only(
        "MLA tiered against unbudgeted", (tier["streams"], tier["logits"]),
        (ref["streams"], ref["logits"]), SPEC_BF16_REL)
    FAM["mla_tiers"] = (fetched, st.fetched_disk_pages, st.evictions)
    log(f"  minicpm3-4b tiered ({dev} device, {host} host pages of "
        f"{pb / 1e6:.3f} MB, cost eviction, page files): {st.evictions} "
        f"evictions, {fetched} latent pages recalled ({fetched - st.fetched_disk_pages} from "
        f"host, {st.fetched_disk_pages} from disk), every one bit-equal "
        f"to its bytes at eviction; streams equal to the unbudgeted run's "
        f"for {n_equal} of {len(reqs)}, logits within {worst:.3g}; "
        f"splits {splits}")


def mla_streamed(torch, ops, serve):
    """(a): minicpm3-4b as a q4 store built on the card one layer at a
    time, phase 5's mix through the layer-wise engine resident and
    streamed (window 4): 4 B3 launches a layer a pass exactly, no B5 (its
    decode is plain torch), equal streams, peak under 5 layers. Returns
    the streamed run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.runtime.paramstore import ParamStore, ResidentSource
    from repro_torch.runtime.streaming import StreamingParamSource

    args = serve.parse_args(["--arch", MLA_ARCH] + STREAM_MIX)
    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    W, L = args.stream_window, cfg.n_layers
    sdir, tree = write_store(torch, cfg, torch.bfloat16, seed=0)
    try:
        with ParamStore(sdir) as store:
            nbytes = store.layer_nbytes
        reqs = serve.make_requests(cfg, args)
        streams, counts = {}, {}
        for name in ("resident", "streamed"):
            src = ResidentSource(tree) if name == "resident" else \
                StreamingParamSource(ParamStore(sdir), window=W)
            ops.reset_launch_counts()
            try:
                res = serve.serve_layerwise(src, cfg, reqs, args)
            finally:
                src.close()
            res["requests"] = reqs
            check_served(res)
            passes = len(reqs) + res["steps"]
            counts[name] = launched(ops, {"q4_matmul": MLA_B3 * L
                                          * passes}, f"MLA q4 {name}")
            stream_summary(f"minicpm3-4b q4 {name}", res, nbytes * L)
            log(f"  {name}: {counts[name]['q4_matmul']} B3 launches = "
                f"{passes} passes x {L} layers x {MLA_B3} (wo, w_gate,"
                f" w_up, w_down)")
            streams[name] = {f.uid: f.tokens for f in res["finished"]}
            FAM[f"mla_{name}"] = {"wall_s": res["wall_s"],
                                  "steps": res["steps"], **res["summary"]}
            if name == "streamed":
                st = res["stats"]
                if st.peak_resident_bytes >= (W + 1) * nbytes:
                    raise AssertionError(f"streamed: peak "
                                         f"{st.peak_resident_bytes} B")
                FAM["mla_peak_layers"] = st.peak_resident_bytes / nbytes
        if streams["streamed"] != streams["resident"]:
            raise AssertionError("MLA q4: streamed tokens differ from the "
                                 "resident run's")
        log(f"  streamed and resident tokens equal for {len(reqs)} "
            f"requests; store {nbytes / 1e6:.1f} MB a layer")
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
        del tree
        free_card(torch)
    return counts["streamed"]


def mla_full(torch, ops, serve):
    """Phase 16 (a): minicpm3-4b at published width, ``MLA_LAYERS`` of
    its 62 layers, bf16."""
    args = serve.parse_args(["--arch", MLA_ARCH, "--layers",
                             str(MLA_LAYERS)] + PAGED_MIX)
    t0 = time.perf_counter()
    cfg, params = serve.build_model(args)
    n = sum(p.numel() for p in params.parameters())
    log(f"  minicpm3-4b: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{n / 1e9:.2f} B params bf16 ({2 * n / 1e9:.2f} GB), made in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = serve.make_requests(cfg, args)
    paged, _ = fam_paged(torch, ops, params, cfg, reqs, args, "minicpm3-4b")
    dense_against_paged(torch, ops, params, cfg, reqs, args, paged,
                        "minicpm3-4b")
    mla_verify(torch, params, cfg)
    mla_tiers(torch, serve, params, cfg, args)
    del params, paged
    free_card(torch)
    return mla_streamed(torch, ops, serve)


def vlm_patches(torch, ops, serve, params, cfg):
    """(b): a dense prefill of 8 prompts after a 16 x 16 grid of patch
    embeddings at M-RoPE positions (temporal 0, the patch's row and
    column; the text after them from the grid's end on all three
    streams): its last row equals a full-sequence forward's, and 4
    graphed decode steps from its cache launch B5 once a layer a step."""
    from repro_torch.models import init_cache
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import dense_decode

    g, S, B = VLM_PATCHES, 32, 8
    gen = torch.Generator(device="cuda").manual_seed(16)
    patches = torch.randn((B, g * g, cfg.d_model), generator=gen,
                          device="cuda").to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    grid = torch.arange(g * g, device="cuda")
    text = g + torch.arange(S, device="cuda")
    pos = torch.stack([torch.cat([torch.zeros_like(grid), text]),
                       torch.cat([grid // g, text]),
                       torch.cat([grid % g, text])]).int()
    pos = pos[:, None].expand(3, B, g * g + S)
    cache = init_cache(cfg, B, 512, dtype=torch.bfloat16, device="cuda")
    ops.reset_launch_counts()
    logits, cache = M.prefill(params, cfg, toks, cache, embeds=patches,
                              positions=pos)
    full = M.forward(params, cfg, toks, embeds=patches, positions=pos)
    top = float(full[:, -1].float().abs().max())
    d = float((logits[:, 0].float() - full[:, -1].float()).abs().max()) / top
    if d >= 1e-2 or not torch.isfinite(logits).all():
        raise AssertionError(f"vlm prefill with patches: last row differs "
                             f"from the forward's by {d} of max|ref|")
    del full
    run = serve.greedy_steps(dense_decode(params, cfg, device="cuda"), cache,
                             logits[:, -1:].argmax(-1).int(), 4,
                             torch.device("cuda"))
    launched(ops, {"flash_verify": 4 * cfg.n_layers}, "vlm patch decode")
    log(f"  qwen2-vl-2b: prefill of {g * g} patch embeddings + {S} tokens "
        f"x {B} (M-RoPE grid positions): last row within {d:.3g} of "
        f"max|ref| of the full-sequence forward's; 4 graphed decode steps, {4 * cfg.n_layers} B5 "
        f"launches; tokens {run['tokens'][:, :, 0][0].tolist()}")


def vlm_ring(torch, ops, serve):
    """(b): qwen2-vl-2b's 4-stage ring at k 1 over 8 prompts of 512 tokens,
    graphed, against the one-device decode of the same cache: B5 28 x 4 a
    pass exactly; streams equal but at near ties. Returns the launches."""
    from repro_torch.runtime.serve import RingPlan, RingServeStep, ring_params

    args = serve.parse_args(["--arch", VLM_ARCH] + VLM_RING)
    dev, n, M = torch.device("cuda"), int(args.new_tokens), args.stages
    cfg, params = serve.build_model(args)
    _, cache, nxt, _ = serve.ring_prefill(params, cfg, args)
    plan = RingPlan.make(cfg, M, 1)
    step = RingServeStep(cfg, plan, ring_params(params, cfg, plan),
                         graphs=True, device=dev)
    ops.reset_launch_counts()
    run = serve.greedy_steps(step, serve.to_ring_cache(cache, cfg, plan),
                             nxt, n, dev, keep=True)
    got = launched(ops, {"flash_verify": cfg.n_layers * M * n}, "vlm ring")
    one = serve.greedy_steps(serve.one_device_decode(params, cfg, dev),
                             serve.clone_cache(cache), nxt, n, dev,
                             keep=True)
    worst, n_equal, splits = near_tie_only(
        "vlm ring against the one-device decode", by_row(run), by_row(one),
        SPEC_BF16_REL)
    ring_ms = 1e3 * float(np.median(run["step_s"][1:]))
    one_ms = 1e3 * float(np.median(one["step_s"][1:]))
    FAM.update(vlm_ring_ms=ring_ms, vlm_one_ms=one_ms,
               vlm_ring_splits=len(splits))
    log(f"  qwen2-vl-2b ring (k 1, w {plan.w}, M {M}), {n} graphed steps: "
        f"step p50 {ring_ms:.2f} ms against the one-device step's "
        f"{one_ms:.2f} ms; {cfg.n_layers * M} B5 a pass exactly; streams "
        f"equal for {n_equal} of 8 rows, logits within {worst:.3g}; splits "
        f"{splits}")
    del step, run, one, cache, params
    free_card(torch)
    return got


def vlm_full(torch, ops, serve):
    """Phase 16 (b): qwen2-vl-2b at published size: the paged mix on bf16
    and int8 pages, the dense prefill with patches, the ring. Returns the
    main runs' launches."""
    counts = {}
    for quant in (False, True):
        args = serve.parse_args(["--arch", VLM_ARCH] + PAGED_MIX + (
            ["--kv-quant-kernel"] if quant else []))
        cfg, params = serve.build_model(args)
        reqs = serve.make_requests(cfg, args)
        label = "qwen2-vl-2b int8" if quant else "qwen2-vl-2b"
        _, got = fam_paged(torch, ops, params, cfg, reqs, args, label)
        for k, v in got.items():
            counts[k] = counts.get(k, 0) + v
        if not quant:
            vlm_patches(torch, ops, serve, params, cfg)
        del params
        free_card(torch)
    for k, v in vlm_ring(torch, ops, serve).items():
        counts[k] = counts.get(k, 0) + v
    return counts


def hybrid_full(torch, ops, serve):
    """Phase 16 (c): recurrentgemma-9b at published size (38 layers, 19
    GB bf16, untied embeddings) through the dense-cache engine, graphed
    and eager: 12 B5 launches a decode step (its attention layers, MQA 16
    over 1 at D 256 over a 2048-line rolling buffer), equal streams.
    Returns the graphed run's launches."""
    from repro_torch.models import init_cache
    from repro_torch.runtime.engine import make_dense_engine

    args = serve.parse_args(HYB_ARGS)
    t0 = time.perf_counter()
    cfg, params = serve.build_model(args)
    from repro_torch.models import model as M

    n = sum(p.numel() for p in params.parameters())
    n_attn = M.layer_kinds(cfg).count("attn")
    reqs = serve.make_requests(cfg, args)
    wraps = sum(len(r.prompt) > cfg.attn_window for r in reqs)
    log(f"  recurrentgemma-9b: {cfg.n_layers} layers ({n_attn} attention), "
        f"{n / 1e9:.2f} B params bf16, made in {time.perf_counter() - t0:.1f}"
        f" s; {len(reqs)} prompts of {min(len(r.prompt) for r in reqs)}-"
        f"{max(len(r.prompt) for r in reqs)} tokens, {wraps} past the "
        f"{cfg.attn_window}-line window")
    if not wraps:
        raise AssertionError("no prompt wraps the attention buffer")
    runs, got = {}, None
    for graphs in (True, False):
        way = "graphed" if graphs else "eager"
        eng = make_dense_engine(params, cfg, args.batch, args.ctx,
                                cache_dtype=torch.bfloat16, graphs=graphs,
                                device="cuda")
        cache = init_cache(cfg, args.batch, args.ctx, dtype=torch.bfloat16,
                           device="cuda")
        if cache["groups"]["b2"]["k"].shape[2] != cfg.attn_window:
            raise AssertionError("the attention cache is not the window")
        ops.reset_launch_counts()
        run = logged_run(torch, eng, "prefill", cache, reqs)
        c = launched(ops, {"flash_verify": n_attn * run["steps"]},
                     f"hybrid {way}")
        got = got or c
        runs[way] = run
        summ = serve._p50_summary(run["finished"], run["wall"])
        FAM[f"hyb_{way}"] = dict(summ, wall_s=run["wall"],
                                 steps=run["steps"])
        log(f"  recurrentgemma-9b dense-cache engine, {way}: {run['steps']}"
            f" decode steps, wall {run['wall']:.3f} s, TTFT p50 "
            f"{summ['ttft_p50_s'] * 1e3:.2f} ms, TPOT p50 "
            f"{summ['tpot_p50_s'] * 1e3:.2f} ms; {c['flash_verify']} B5 = "
            f"{run['steps']} steps x {n_attn} attention layers")
        del eng, cache
        free_card(torch)
    worst, n_equal, splits = near_tie_only(
        "hybrid graphed against eager",
        (runs["graphed"]["streams"], runs["graphed"]["logits"]),
        (runs["eager"]["streams"], runs["eager"]["logits"]), SPEC_BF16_REL)
    log(f"  graphed and eager: streams equal for {n_equal} of {len(reqs)}, "
        f"logits within {worst:.3g} of max|ref|; splits {splits}")
    del params, runs
    free_card(torch)
    return got


def whisper_full(torch, ops, serve):
    """Phase 16 (d): whisper-tiny at published width: 8 sequences of 1500
    frames encoded, a 16-token prompt, then greedy decode until the
    448-line self-attention cache is full, graphed (4 B5 launches a step:
    its decoder layers) and eager; equal streams. Returns the graphed
    run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import dense_decode

    cfg = get_config(AUD_ARCH)
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    frames = torch.randn((AUD_B, cfg.n_frontend_tokens, cfg.d_model),
                         generator=gen, device="cuda").to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab, (AUD_B, AUD_PROMPT), generator=gen,
                           device="cuda")
    n = cfg.max_decode_len - AUD_PROMPT
    runs, got = {}, None
    for graphs in (True, False):
        way = "graphed" if graphs else "eager"
        cache = init_cache(cfg, AUD_B, cfg.max_decode_len,
                           dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = M.prefill(params, cfg, prompt, cache, embeds=frames)
        torch.cuda.synchronize()
        pre = time.perf_counter() - t0
        ops.reset_launch_counts()
        run = serve.greedy_steps(dense_decode(params, cfg, graphs=graphs,
                                              device=dev), cache,
                                 logits[:, -1:].argmax(-1).int(), n, dev,
                                 keep=True)
        c = launched(ops, {"flash_verify": cfg.n_layers * n},
                     f"whisper {way}")
        got = got or c
        if int(run["cache"]["len"].min()) != cfg.max_decode_len or not all(
                torch.isfinite(lg).all() for lg in run["logits"]):
            raise AssertionError(f"whisper {way}: cache not full or logits "
                                 f"not finite")
        runs[way] = run
        ms = 1e3 * float(np.median(run["step_s"][1:]))
        FAM[f"aud_{way}"] = {"prefill_s": pre, "step_ms": ms}
        log(f"  whisper-tiny, {way}: encoder + prefill of {AUD_B} x "
            f"{cfg.n_frontend_tokens} frames and {AUD_PROMPT} tokens in "
            f"{pre:.3f} s; {n} decode steps to the full {cfg.max_decode_len}"
            f"-line cache, step p50 {ms:.3f} ms; {c['flash_verify']} B5 = "
            f"{n} x {cfg.n_layers} layers")
    worst, n_equal, splits = near_tie_only(
        "whisper graphed against eager", by_row(runs["graphed"]),
        by_row(runs["eager"]), SPEC_BF16_REL)
    log(f"  graphed and eager: streams equal for {n_equal} of {AUD_B}, "
        f"logits within {worst:.3g}; splits {splits}")
    del params, runs, frames
    free_card(torch)
    return got


def plain_hot_spots(torch) -> None:
    """Phase 16: the hot spots that run plain torch on the card (the
    reference computes them outside Pallas), timed at the main path's
    shapes with ``Timer`` (median device time after an L2 flush: the call,
    and its CUDA-graph replay) in bf16, beside a bound (bytes over 3.35
    TB/s or, for MLA's f32 score products, operations over the f32 peak):
    MLA's absorbed attention of one minicpm3-4b layer, 8 slots at T = 1
    over 2048 lines gathered from pages (62 layers a step), the RG-LRU's
    doubling scan over a 2048-token prefill at width 4096 and its decode
    block at 8 slots (26 layers a step)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as ll
    from repro_torch.models import model as M

    timer, bf = Timer(torch), torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(16)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    cfg = get_config(MLA_ARCH)
    attn = M.init_block(cfg, gen, bf, "cuda").attn
    B, S_kv, bs = 8, 2048, 16
    r = cfg.kv_lora_rank + cfg.qk_rope_dim
    pages = randn(B * S_kv // bs + 1, bs, r)
    table = torch.arange(1, B * S_kv // bs + 1, dtype=torch.int32,
                         device="cuda").reshape(B, -1)
    ln = torch.full((B,), S_kv - 1, dtype=torch.int32, device="cuda")
    q_nope, q_rope, _, _ = ll.mla_project(attn, cfg, randn(B, 1, cfg.d_model),
                                          ln[:, None])

    def mla():
        ll._mla_absorbed(attn, cfg, q_nope, q_rope,
                         ll.gather_pages(pages, table), ln, bf)
    H, dn, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    mla_bytes = 2 * (B * S_kv * r + cfg.kv_lora_rank * H * (dn + dv))
    mla_ops = 2 * B * H * S_kv * (r + cfg.kv_lora_rank)
    mla_bound = 1e3 * max(mla_bytes / HBM_BYTES_S,
                          mla_ops / PEAK_OPS["float32"])
    hcfg = get_config(HYB_ARCH)
    w = hcfg.lru_width
    rg = M.init_block(hcfg, gen, bf, "cuda", kind="rglru").rglru
    a, b = torch.rand((1, 2048, w), generator=gen, device="cuda").to(bf), \
        randn(1, 2048, w)
    x1 = randn(B, 1, hcfg.d_model)
    cache = {"h": torch.zeros((B, w), dtype=bf, device="cuda"),
             "conv": torch.zeros((B, hcfg.conv_width - 1, w), dtype=bf,
                                 device="cuda")}

    def scan():
        ll.doubling_scan(a, b)

    def step():
        ll.rglru_block(rg, hcfg, x1, cache=cache, decode=True)
    n_rg = M.layer_kinds(hcfg).count("rglru")
    rows = {"MLA absorbed attention, a layer": (mla, mla_bound,
                                                cfg.n_layers),
            "RG-LRU doubling scan, S 2048": (
                scan, 1e3 * 4 * a.numel() * 2 / HBM_BYTES_S, n_rg),
            "RG-LRU decode block, 8 slots": (
                step, 1e3 * 3 * hcfg.d_model * w * 2 / HBM_BYTES_S, n_rg)}
    for label, (fn, bound, layers) in rows.items():
        ms, dev = timer(fn), timer.graph(fn)
        FAM[f"hot {label}"] = {"ms": ms, "device_ms": dev, "bound_ms": bound}
        log(f"  plain torch, {label}: {ms:.4f} ms a call (device "
            f"{dev:.4f} ms replayed from a CUDA graph), bound {bound:.4f} ms;"
            f" x {layers} layers: {layers * dev:.3f} ms device a pass")
    free_card(torch)


def fam_parity(torch, ops, serve) -> None:
    """Phase 16 (e): each family at 4 layers, full width, f32, eager:
    every kernel launch held against its plain version on the same
    inputs, logits within 2e-4 of max|ref| of ``use_kernels(False)`` and
    equal streams. minicpm3-4b: the layer-wise engine over a q4 store
    (B3) and one q4 ring step (B3 on ``wq_a``, ``wq_b``, ``wkv_a`` too);
    qwen2-vl-2b: the dense engine (B5), the paged engine (chunked, f32:
    B1, B2; int8: B4) and the q4 layer-wise engine (B3, B5);
    recurrentgemma-9b: the dense engine (B5); whisper-tiny: prefill and
    decode (B5)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params
    from repro_torch.models import model as M
    from repro_torch.runtime.engine import make_dense_engine
    from repro_torch.runtime.paramstore import ResidentSource
    from repro_torch.runtime.serve import RingPlan, RingServeStep, ring_params

    found = {}

    def dense(params, cfg, reqs, args):
        def run():
            eng = make_dense_engine(params, cfg, args.batch, args.ctx,
                                    cache_dtype=torch.float32, graphs=False,
                                    device="cuda")
            r = logged_run(torch, eng, "prefill", init_cache(
                cfg, args.batch, args.ctx, dtype=torch.float32,
                device="cuda"), reqs)
            return r["streams"], r["logits"]
        return run

    for arch in (MLA_ARCH, VLM_ARCH, HYB_ARCH):
        argv = ["--arch", arch] + FAM_PARITY_ARGS
        if arch == HYB_ARCH:       # past the 2048-line rolling window
            argv += ["--ctx", "2304", "--prompt-len", "1900",
                     "--prompt-len-max", "2200"]
        args = serve.parse_args(argv)
        cfg, params = serve.build_model(args)
        reqs = serve.make_requests(cfg, args)
        if arch != MLA_ARCH:
            found[(arch, "dense")] = held(
                torch, ops, f"{arch} dense", ("flash_verify",),
                dense(params, cfg, reqs, args), dense(params, cfg, reqs,
                                                      args))
        if arch == VLM_ARCH:
            for quant in (False, True):
                c = dataclasses.replace(cfg, kv_dtype="int8") if quant \
                    else cfg

                def paged(c=c):
                    return traced_paged_run(torch, params, c, reqs, args)
                want = ("paged_verify_quant",) if quant else (
                    "paged_prefill", "paged_verify")
                found[(arch, "paged int8" if quant else "paged")] = held(
                    torch, ops, f"{arch} paged", want, paged, paged,
                    int8=quant)
        if arch in (MLA_ARCH, VLM_ARCH):
            args.store_quant = "q4"
            tree, _ = serve.store_tree(params, cfg, args)

            def layerwise():
                return traced_stream_run(torch, ResidentSource(tree), cfg,
                                         reqs, args)
            want = ("q4_matmul",) if arch == MLA_ARCH else (
                "flash_verify", "q4_matmul")
            found[(arch, "q4 layer-wise")] = held(
                torch, ops, f"{arch} q4", want, layerwise, layerwise)
        if arch == MLA_ARCH:
            plan = RingPlan.make(cfg, 2, 1)
            rp = ring_params(tree, cfg, plan)
            gen = torch.Generator(device="cuda").manual_seed(2)
            tok = torch.randint(0, cfg.vocab, (4, 1), generator=gen,
                                device="cuda")

            def ring():
                step = RingServeStep(cfg, plan, rp, graphs=False,
                                     device="cuda")
                cache = {"len": torch.full((4,), 5, dtype=torch.int32,
                                           device="cuda"),
                         "layers": {"latent": torch.randn(
                             (plan.L_pad, 4, 64, cfg.kv_lora_rank
                              + cfg.qk_rope_dim), generator=torch.Generator(
                                 device="cuda").manual_seed(3),
                             device="cuda")}}
                lg, _ = step(cache, tok)
                return ({b: [int(lg[b, 0].argmax())] for b in range(4)},
                        {(b, 0): lg[b, 0].float() for b in range(4)})
            found[(arch, "q4 ring step")] = held(
                torch, ops, f"{arch} q4 ring", ("q4_matmul",), ring, ring)
        del params
        free_card(torch)

    cfg = get_config(AUD_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, gen, dtype=torch.float32, device="cuda")
    frames = torch.randn((4, cfg.n_frontend_tokens, cfg.d_model),
                         generator=gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab, (4, 8), generator=gen,
                           device="cuda")

    def whisper():
        cache = init_cache(cfg, 4, 64, dtype=torch.float32, device="cuda")
        lg, cache = M.prefill(params, cfg, prompt, cache, embeds=frames)
        streams = {b: [] for b in range(4)}
        logits = {}
        for n in range(24):
            for b in range(4):
                logits[(b, n)] = lg[b, -1].float().clone()
                streams[b].append(int(lg[b, -1].argmax()))
            tok = lg[:, -1:].argmax(-1).int()
            lg, cache = M.decode_step(params, cfg, cache, tok)
        return streams, logits
    found[(AUD_ARCH, "prefill + decode")] = held(
        torch, ops, "whisper", ("flash_verify",), whisper, whisper)
    for (arch, label), (worst, n_equal, errs) in found.items():
        errs_s = ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        log(f"  {arch}, 4 layers f32, {label}: every launch within its plain"
            f" version's ({errs_s}); logits within {worst:.3g} of max|ref| "
            f"of use_kernels(False); streams equal ({n_equal})")
    FAM["parity"] = {f"{a} {k}": v[0] for (a, k), v in found.items()}
    del params
    free_card(torch)


def report_fam() -> None:
    """Phase 16's numbers again, beside the card's name and power limit."""
    log(f"  card: {card()}")
    for key in sorted(k for k in FAM if isinstance(FAM[k], dict)
                      and k != "parity"):
        log(f"  {key}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in FAM[key].items()
            if isinstance(v, float)))
    log(f"  MLA verify {FAM['mla_verify']:.3g}; MLA tiers (recalled, from "
        f"disk, evictions) {FAM['mla_tiers']}; MLA streamed peak "
        f"{FAM['mla_peak_layers']:.2f} layers; vlm ring "
        f"{FAM['vlm_ring_ms']:.2f} ms against {FAM['vlm_one_ms']:.2f} ms "
        f"one device, {FAM['vlm_ring_splits']} splits")
    log("  (e) worst logits over max|ref|: " + ", ".join(
        f"{k} {v:.3g}" for k, v in FAM["parity"].items()))


# --------------------------------------------------------------------------- #
#  phase 17: training on the card
# --------------------------------------------------------------------------- #

TRAIN = {}
#: phase 17's runs: (a) qwen2.5-14b at full width, ``QWEN_TRAIN_LAYERS``
#: layers; (b) mamba2-780m at full width and depth
QWEN_TRAIN_LAYERS = 1
#: (a)'s checkpoint step and steps in all: the checkpoint's ~22 GB written
#: and read back take most of the phase, the steps ~0.24 s each
QWEN_CKPT_STEP, QWEN_STEPS = 6, 10
#: (b)'s steps (cut for time; B6 launches once a layer a step)
MAMBA_STEPS = 5
QWEN_TRAIN = ["--arch", "qwen2.5-14b", "--n-layers", str(QWEN_TRAIN_LAYERS),
              "--batch", "8", "--seq", "128", "--device", "cuda", "--seed",
              "0"]
MAMBA_TRAIN = ["--arch", "mamba2-780m", "--batch", "4", "--seq", "1024",
               "--steps", str(MAMBA_STEPS), "--ckpt-every", "1000",
               "--device", "cuda",
               "--seed", "0"]


def train_line(label, res, args, reckoned) -> dict:
    """Log one training run's step time, tokens/s and peak bytes beside
    the params + grads + two moments reckoned (16 B a parameter)."""
    steady = res["step_s"][1:] or res["step_s"]
    ms = float(np.median(steady)) * 1e3
    tok_s = args.batch * args.seq / ms * 1e3
    log(f"  {label}: {len(res['losses'])} steps from {res['start']}, step "
        f"{ms:.1f} ms median after the first (between syncs; first "
        f"{res['step_s'][0] * 1e3:.1f} ms), {tok_s:.0f} tokens/s, "
        f"max_memory_allocated {res['peak_bytes'] / 1e9:.2f} GB against "
        f"{reckoned / 1e9:.2f} GB reckoned for params, grads and moments, "
        f"TF32 {res['tf32']}; checkpoint saves "
        f"{[round(x, 1) for x in res['ckpt_s']]} s, restore "
        f"{res['restore_s'] if res['restore_s'] is None else round(res['restore_s'], 1)} s")
    losses = np.asarray(res["losses"])
    assert np.isfinite(losses).all(), (label, losses)
    return {"ms": ms, "tok_s": tok_s, "peak_gb": res["peak_bytes"] / 1e9,
            "losses": res["losses"]}


def trained(torch, LT, argv):
    """``launch.train.run`` on ``argv``; the model and the optimizer
    state are dropped before the next run."""
    res = LT.run(LT.parse_args(argv))
    res["params"] = res["opt"] = None
    free_card(torch)
    return res


def train_qwen(torch, ops) -> None:
    """(a) qwen2.5-14b at full width, ``QWEN_TRAIN_LAYERS`` of 48 layers,
    f32: a reference run of ``QWEN_STEPS`` steps that writes no
    checkpoint; a run of as many steps that checkpoints at step
    ``QWEN_CKPT_STEP`` and goes on from the same state, held to the
    reference at every step (a save leaves the live state as it was);
    then ``--resume`` from that checkpoint to ``QWEN_STEPS``, held to the
    reference's last steps. One checkpoint (params and two f32 moments)
    is all the resume needs; a second would double the disk the run
    writes."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as LT

    cfg = dataclasses.replace(get_config("qwen2.5-14b"),
                              n_layers=QWEN_TRAIN_LAYERS)
    n = cfg.total_params()
    c, n_steps = QWEN_CKPT_STEP, QWEN_STEPS
    d = tempfile.mkdtemp(prefix="chip_smoke_train_")
    log(f"  {n / 1e9:.3f} B params; a checkpoint of {12 * n / 1e9:.1f} GB "
        f"in {d} ({shutil.disk_usage(d).free / 1e9:.1f} GB free)")
    try:
        t0 = time.perf_counter()
        plain = trained(torch, LT, QWEN_TRAIN + [
            "--steps", str(n_steps), "--ckpt-every", "1000", "--ckpt-dir",
            d])
        # n_steps < 2 c: the run's only checkpoint is step c's
        saving = trained(torch, LT, QWEN_TRAIN + [
            "--steps", str(n_steps), "--ckpt-every", str(c), "--ckpt-dir",
            d])
        resumed = trained(torch, LT, QWEN_TRAIN + [
            "--steps", str(n_steps), "--ckpt-every", "1000", "--resume",
            "--ckpt-dir", d])
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    args = LT.parse_args(QWEN_TRAIN)
    rows = {k: train_line(f"(a) {k}", r, args, 16 * n)
            for k, r in ((f"reference {n_steps}, no checkpoint", plain),
                         (f"{n_steps}, checkpoint at {c}", saving),
                         (f"resumed to {n_steps}", resumed))}
    assert not plain["ckpt_s"] and len(saving["ckpt_s"]) == 1, (
        plain["ckpt_s"], saving["ckpt_s"])
    head = plain["losses"][:c]
    assert np.mean(head[c - 3:c]) < head[0], (head[0], head[c - 3:c])
    assert resumed["start"] == c and len(resumed["losses"]) == n_steps - c
    want = np.asarray(plain["losses"])

    def rel(got):
        got = np.asarray(got)
        return np.abs(got - want[-len(got):]) / np.abs(want[-len(got):])
    saved, res = rel(saving["losses"]), rel(resumed["losses"])
    log(f"  (a) loss {head[0]:.4f} -> {np.mean(head[c - 3:c]):.4f} (mean of "
        f"steps {c - 2}-{c}); against the run that saves nothing, largest "
        f"relative difference: the saving run's steps 1-{n_steps} "
        f"{saved.max():.3g}, the resumed steps {c + 1}-{n_steps} "
        f"{res.max():.3g} (limit 1e-3); the three runs {wall:.1f} s")
    assert saved.max() <= 1e-3 and res.max() <= 1e-3, (saved, res)
    TRAIN["qwen"] = dict(rows, resume_rel=float(res.max()),
                         save_rel=float(saved.max()),
                         ckpt_s=saving["ckpt_s"],
                         restore_s=resumed["restore_s"], wall=wall,
                         reckoned_gb=16 * n / 1e9)


def train_mamba(torch, ops) -> None:
    """(b) mamba2-780m at full width and depth, f32: ``MAMBA_STEPS`` steps
    of batch 4 x 1024; B6 launches once a layer a step (its backward recomputes the
    plain scan)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as LT

    cfg = get_config("mamba2-780m")
    n = cfg.total_params()
    d = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        ops.reset_launch_counts()
        res = trained(torch, LT, MAMBA_TRAIN + ["--ckpt-dir", d])
        counts = ops.launch_counts()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    row = train_line("(b) mamba2-780m", res, LT.parse_args(MAMBA_TRAIN),
                     16 * n)
    want = dict.fromkeys(counts, 0)
    want["ssd_scan"] = cfg.n_layers * MAMBA_STEPS
    log(f"  (b) launches {counts} (want {want['ssd_scan']} B6)")
    assert counts == want, counts
    TRAIN["mamba"] = dict(row, launches=counts["ssd_scan"],
                          reckoned_gb=16 * n / 1e9)


def leaves_close(kern, plain, names, tol):
    """The worst |d| / max|ref| over the leaves, and whether every leaf
    is within ``tol`` (a leaf whose reference is 0 must be 0)."""
    worst, ok, where = 0.0, True, ""
    for name, a, b in zip(names, plain, kern):
        m = float(a.abs().max())
        e = float((a - b).abs().max()) / (m if m > 0 else 1.0)
        if (m == 0 and float(b.abs().max()) != 0) or e > tol:
            ok = False
        if e > worst:
            worst, where = e, name
    return worst, where, ok


def parity_step(torch, ops, cfg, batch, *, kernels, detach=False):
    """One ``make_train_step`` of a fresh seed-5 model: {loss, grads,
    before, after (the parameters), names, scale (the clip), opt}.
    ``detach``: B6's outputs detached (the negative control: the scan's
    share of the gradient is lost)."""
    from repro_torch.models import init_params
    from repro_torch.runtime.optim import AdamW
    from repro_torch.runtime.train import make_train_step

    seen = []

    class Recording(AdamW):
        def update(self, grads, state, params, *, gnorm=None):
            seen.append(([g.detach().clone() for g in grads],
                         min(1.0, self.clip_norm / max(float(gnorm),
                                                       1e-12))))
            return super().update(grads, state, params, gnorm=gnorm)

    params = init_params(cfg, torch.Generator("cuda").manual_seed(5),
                         device="cuda")
    before = [p.detach().clone() for p in params.parameters()]
    opt = Recording(lr=3e-3, warmup_steps=20)
    step = make_train_step(cfg, opt, grad_dtype=None, remat=False)
    scan = ops.ssd_scan
    if detach:
        ops.ssd_scan = lambda *a, **k: tuple(t.detach()
                                             for t in scan(*a, **k))
    ops.use_kernels(kernels)
    try:
        params, _, m = step(params, opt.init(list(params.parameters())),
                            batch)
        loss = float(m["loss"])
    finally:
        ops.use_kernels(True)
        ops.ssd_scan = scan
    after = [p.detach().clone() for p in params.parameters()]
    names = [k for k, _ in params.named_parameters()]
    del params
    free_card(torch)
    return dict(loss=loss, grads=seen[0][0], before=before, after=after,
                names=names, scale=seen[0][1], opt=opt)


def update_close(run, tol):
    """(worst |d| / max|ref|, its leaf, ok): the run's parameters after
    its step against AdamW's first step (zero moments, step 1) written
    out in f64 on the run's own recorded gradients and clip scale,
    within ``tol`` of each leaf's max|ref| everywhere."""
    opt = run["opt"]
    lr = opt.lr * min(1 / max(opt.warmup_steps, 1), 1.0)
    ref = []
    for p, g in zip(run["before"], run["grads"]):
        p, g = p.double(), g.double() * run["scale"]
        mu, nu = (1 - opt.b1) * g, (1 - opt.b2) * g * g
        u = (mu / (1 - opt.b1)) / ((nu / (1 - opt.b2)).sqrt() + opt.eps)
        ref.append(p - lr * (u + opt.weight_decay * p))
    return leaves_close(run["after"], ref, run["names"], tol)


def train_parity(torch, ops) -> None:
    """(c) mamba2-780m at 4 layers, full width, f32, TF32 off: one train
    step with B6 against ``use_kernels(False)``, and its detached-B6
    negative control; a qwen2.5-14b-width step's gradients with remat
    against without."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus, batches
    from repro_torch.models import init_params
    from repro_torch.runtime.train import lm_loss, make_trainable

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config("mamba2-780m"), n_layers=4)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(batches(
        SyntheticCorpus(vocab=cfg.vocab, seed=5), 4, 1024, seed=5)).items()}
    ops.reset_launch_counts()
    kern = parity_step(torch, ops, cfg, batch, kernels=True)
    assert ops.launch_counts()["ssd_scan"] == cfg.n_layers
    plain = parity_step(torch, ops, cfg, batch, kernels=False)
    cut = parity_step(torch, ops, cfg, batch, kernels=True, detach=True)
    names = kern["names"]
    loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    g_worst, g_at, g_ok = leaves_close(kern["grads"], plain["grads"], names,
                                       1e-4)
    upd = [update_close(r, 1e-6) for r in (kern, plain)]
    u_worst, u_at, _ = max(upd)
    u_ok = all(ok for *_, ok in upd)
    p_worst, p_at, _ = leaves_close(kern["after"], plain["after"], names,
                                    1e-6)
    log(f"  (c) mamba2-780m 4 layers: loss {kern['loss']:.6f} against "
        f"{plain['loss']:.6f} plain (relative {loss_rel:.3g}, limit 1e-5); "
        f"gradients worst {g_worst:.3g} of max|ref| at {g_at} (limit 1e-4); "
        f"each run's parameters after the step against AdamW in f64 on "
        f"its own gradients: worst {u_worst:.3g} at {u_at} (limit 1e-6); "
        f"parameters kernels against plain (read, not bounded: Adam's "
        f"g / (|g| + eps) near eps turns a rounding of g into part of lr) "
        f"worst {p_worst:.3g} of max|ref| at {p_at}")
    c_worst, c_at, c_ok = leaves_close(cut["grads"], plain["grads"], names,
                                       1e-4)
    log(f"  (c) negative control, B6's outputs detached: gradients worst "
        f"{c_worst:.3g} of max|ref| at {c_at}: the check "
        f"{'passes (a fault)' if c_ok else 'fails, as it should'}")
    assert loss_rel <= 1e-5 and g_ok and u_ok
    assert not c_ok
    del kern, plain, cut
    # remat on and off at qwen2.5-14b's width (4 layers)
    qcfg = dataclasses.replace(get_config("qwen2.5-14b"), n_layers=4)
    params = init_params(qcfg, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    leaves = make_trainable(params)
    qb = {k: torch.from_numpy(v).cuda() for k, v in next(batches(
        SyntheticCorpus(vocab=qcfg.vocab, seed=0), 8, 128, seed=0)).items()}
    grads = []
    for remat in (False, True):
        loss = lm_loss(params, qcfg, qb["tokens"], qb["labels"],
                       remat=remat)
        grads.append(torch.autograd.grad(loss, leaves))
        del loss
    r_worst, r_at, r_ok = leaves_close(
        grads[1], grads[0], [k for k, _ in params.named_parameters()], 1e-5)
    log(f"  (c) qwen2.5-14b width, 4 layers: remat against none, gradients "
        f"worst {r_worst:.3g} of max|ref| at {r_at} (limit 1e-5)")
    del params, leaves, grads
    free_card(torch)
    assert r_ok
    TRAIN["parity"] = dict(loss_rel=loss_rel, grad=g_worst, update=u_worst,
                           param=p_worst, control=c_worst, remat=r_worst)


def report_train() -> None:
    """Phase 17's numbers again, beside the card's name and power limit."""
    log(f"  card: {card()}")
    q = TRAIN["qwen"]
    for label, row in q.items():
        if isinstance(row, dict):
            log(f"  qwen {label}: step {row['ms']:.1f} ms, {row['tok_s']:.0f}"
                f" tokens/s, peak {row['peak_gb']:.2f} GB (reckoned "
                f"{q['reckoned_gb']:.2f} GB)")
    log(f"  qwen checkpoint saves {[round(x, 1) for x in q['ckpt_s']]} s, "
        f"restore {q['restore_s']:.1f} s, saving run {q['save_rel']:.3g} "
        f"and resume {q['resume_rel']:.3g} of the run that saves nothing, "
        f"three runs {q['wall']:.1f} s")
    m = TRAIN["mamba"]
    log(f"  mamba step {m['ms']:.1f} ms, {m['tok_s']:.0f} tokens/s, peak "
        f"{m['peak_gb']:.2f} GB (reckoned {m['reckoned_gb']:.2f}), "
        f"{m['launches']} B6 launches")
    log(f"  parity {TRAIN['parity']}")


# --------------------------------------------------------------------------- #
#  phase 18: the ring across ranks
# --------------------------------------------------------------------------- #

RANK_JOB = "repro_torch.runtime.serve:rank_ring_job"
RANK_STREAM_JOB = "repro_torch.runtime.serve:rank_stream_job"
#: ranks: 4 stages x tp 2, every rank on the one card
RANK_STAGES, RANK_TP = 4, 2
#: phase 18 (e): greedy steps of the streamed ring across the ranks
STREAM_RANK_STEPS = 4
#: phase 18 (e)'s windows staged at a time (the window in use counts):
#: one of its k 2, so the peak staged is half the resident rows
STREAM_RANK_DEPTH = 1
#: phase 18 (f)'s depth: the first layers of phase 5's store (the phase's
#: time is three worlds' starts and two replays, which grow with depth)
FAILOVER_LAYERS = 8
#: phase 18's record, printed at its end beside the card
RANKS = {}


def rank_view(torch, r):
    """A rank's result as ``by_row`` reads a ``serve.greedy_steps`` run."""
    return {"tokens": r["tokens"].transpose(1, 0, 2),
            "logits": [torch.from_numpy(lg).cuda() for lg in r["logits"]]}


def rank_launches(ranks, want, label):
    """Every rank's launch counts over its greedy steps must be ``want``
    exactly (kernels not named: 0); returns their sum over the ranks."""
    total = {}
    for r in ranks:
        full = {k: want.get(k, 0) for k in r["launches"]}
        if r["launches"] != full:
            raise AssertionError(f"{label}: rank {r['rank']} launched "
                                 f"{r['launches']}, wanted {full}")
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def save_cache(torch, cache, path):
    torch.save({"len": cache["len"].cpu(),
                "layers": {n: a.cpu() for n, a in cache["layers"].items()}},
               path)


def ranks_full(torch, world):
    """Phase 18 (a), (c), (d): qwen2.5-14b at full width and depth from
    phase 14 (b)'s q4 store and prefilled cache, 8 rank processes on the
    card, against phase 14 (b)'s one-process resident ring on the same
    store (graphed, k 2, as the ranks run); returns the launches summed
    over the ranks."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-14b")
    ref = RANK_REF
    n = RANK_STEPS
    t0 = time.perf_counter()
    ranks = world.run(RANK_JOB, cfg=cfg, n_stages=RANK_STAGES,
                      tp=RANK_TP, k=ref["k"], store=ref["store"],
                      cache=ref["cache"], first=ref["first"], steps=n,
                      verify_tokens=5, verify_reps=4, keep_logits=True,
                      trace=True)
    wall = time.perf_counter() - t0
    RANKS["a_ranks"] = ranks
    ref_ms = ref["ms"]
    want = {"tokens": ref["tokens"],
            "logits": [lg.cuda() for lg in ref["logits"]]}
    for r in ranks:
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]):
            raise AssertionError(f"rank {r['rank']} took other tokens")
    worst, n_equal, splits = near_tie_only(
        "ranks against the one-process ring", by_row(rank_view(
            torch, ranks[0])), by_row(want), SPEC_BF16_REL)
    del want
    L = ref["L"]
    total = rank_launches(ranks, {"flash_verify_stats": L * n,
                                  "q4_matmul": PROJECTIONS * L * n},
                          "phase 18 (a)")
    r0 = ranks[0]
    step_ms = 1e3 * float(np.median(r0["step_s"][1:]))
    verify_ms = 1e3 * float(np.median(r0["verify_s"][1:]))
    share = float(np.median([c / s for c, s in zip(r0["comm_s"][1:],
                                                  r0["step_s"][1:])]))
    RANKS["a"] = dict(step_ms=step_ms, verify_ms=verify_ms, share=share,
                      ref_ms=ref_ms, wall=wall, n_equal=n_equal,
                      splits=len(splits), worst=worst,
                      load_s=max(r["load_s"] for r in ranks),
                      gb=max(r["nbytes"] for r in ranks) / 1e9)
    log(f"  (a) 8 ranks (4 stages x tp 2) over gloo on the card, each "
        f"reading its part of the q4 store ({RANKS['a']['gb']:.2f} GB at "
        f"most, loaded in {RANKS['a']['load_s']:.1f} s): {n} greedy steps, "
        f"rank 0's step p50 {step_ms:.2f} ms (eager), "
        f"{share:.3f} of it in the collectives and their host staging "
        f"(the comm track's spans), a T = 5 verify pass {verify_ms:.2f} ms;"
        f" phase 14 (b)'s one-process ring on the same store {ref_ms:.2f} "
        f"ms a step (graphed, k {ref['k']}); streams equal for {n_equal} of"
        f" 8 rows, logits within "
        f"{worst:.3g} of max|ref| up to each row's first difference, "
        f"splits (row, token, top-2 gap, logit difference) {splits}; the "
        f"world's run {wall:.1f} s")
    log(f"  (c) launches a rank exactly {L * n} B5-stats ({L} a step: "
        f"every layer row of every microbatch) and {PROJECTIONS * L * n} B3 "
        f"({PROJECTIONS} projections x {L}), none else; over the 8 ranks "
        f"{total}")
    return total


def ranks_streamed(torch, world):
    """Phase 18 (e): the streamed ring across the same 8 ranks over phase
    5's q4 store at full width and depth, k 2, ``STREAM_RANK_STEPS``
    greedy steps from (a)'s prefilled cache: each rank stages only its
    stage's windows and its part of each leaf, ``STREAM_RANK_DEPTH``
    windows at a time. Tokens and logits equal (a)'s eager resident rank
    steps from the same cache (max|d| 0) on every rank, exact launches a
    rank, each rank's peak staged bytes at most its windows'; returns the
    launches summed over the ranks."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen2.5-14b")
    ref, a = RANK_REF, RANKS["a_ranks"]
    n = STREAM_RANK_STEPS
    t0 = time.perf_counter()
    ranks = world.run(RANK_STREAM_JOB, cfg=cfg, n_stages=RANK_STAGES,
                      tp=RANK_TP, k=ref["k"], store=ref["store"],
                      cache=ref["cache"], first=ref["first"], steps=n,
                      keep_logits=True, depth=STREAM_RANK_DEPTH)
    wall = time.perf_counter() - t0
    worst = 0.0
    for r, res in zip(ranks, a):
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]) \
                or not np.array_equal(r["tokens"], res["tokens"][:n]):
            raise AssertionError(f"(e) rank {r['rank']}: streamed tokens "
                                 f"differ from the ranks' or from (a)'s")
        for lg, want in zip(r["logits"], res["logits"]):
            worst = max(worst, float(np.abs(lg - want).max()))
        if r["nbytes"] != res["nbytes"]:
            raise AssertionError(f"(e) rank {r['rank']}: its share "
                                 f"{r['nbytes']} B streamed, {res['nbytes']}"
                                 f" B resident")
    if worst != 0.0 or len(ranks[0]["logits"]) != n:
        raise AssertionError(f"(e) streamed logits differ from (a)'s "
                             f"resident steps: max|d| {worst}")
    L = ref["L"]
    total = rank_launches(ranks, {"flash_verify_stats": L * n,
                                  "q4_matmul": PROJECTIONS * L * n},
                          "phase 18 (e)")
    plan_rows = L // RANK_STAGES
    held = STREAM_RANK_DEPTH * plan_rows // ref["k"]
    lines = []
    for r in ranks:
        pf = r["prefetch"]
        own = plan_rows * pf["row_nbytes"]
        if pf["bytes_a_pass"] != own or pf["passes"] != n:
            raise AssertionError(f"(e) rank {r['rank']} read "
                                 f"{pf['bytes_a_pass']} B a pass, its "
                                 f"{plan_rows} rows' parts are {own} B")
        if pf["peak_staged_bytes"] > held * pf["row_nbytes"]:
            raise AssertionError(f"(e) rank {r['rank']} staged "
                                 f"{pf['peak_staged_bytes']} B at its peak, "
                                 f"more than {held} rows")
        lines.append(f"rank {r['rank']}: {pf['bytes_a_pass'] / 1e9:.3f} GB "
                     f"a pass = its local shards of {plan_rows} rows, peak "
                     f"staged {pf['peak_staged_bytes'] / 1e9:.3f} GB "
                     f"({pf['peak_staged_bytes'] / own:.3f} of its resident "
                     f"rows), stall {pf['stall_s']:.3f} s")
    r0 = ranks[0]
    step_ms = 1e3 * float(np.median(r0["step_s"][1:]))
    res_ms = RANKS["a"]["step_ms"]
    RANKS["e"] = dict(step_ms=step_ms, res_ms=res_ms, wall=wall,
                      gb=r0["prefetch"]["bytes_a_pass"] / 1e9,
                      peak=max(r["prefetch"]["peak_staged_bytes"]
                               for r in ranks) / 1e9,
                      stall=max(r["prefetch"]["stall_s"] for r in ranks))
    log(f"  (e) the streamed ring across the same 8 ranks over the q4 "
        f"store (k {ref['k']}, {STREAM_RANK_DEPTH} window staged at a time), "
        f"{n} greedy steps from (a)'s "
        f"cache: tokens and logits equal (a)'s eager resident steps (max|d| "
        f"{worst}) on every rank; rank 0's streamed step p50 {step_ms:.2f} "
        f"ms against (a)'s resident {res_ms:.2f} ms; launches a rank exactly "
        f"{L * n} B5-stats and {PROJECTIONS * L * n} B3, over the 8 ranks "
        f"{total}; the world's run {wall:.1f} s")
    for line in lines:
        log(f"      {line}")
    return total


def first_layers(sdir, n):
    """A store of the first ``n`` layers of the store at ``sdir``: its
    files linked into a new temporary directory, the manifest's depth
    cut."""
    from repro_torch.runtime import paramstore as P

    out = tempfile.mkdtemp(prefix="chip_smoke_first_")
    with open(os.path.join(sdir, P.MANIFEST)) as f:
        manifest = json.load(f)
    manifest["n_layers"] = n
    with open(os.path.join(out, P.MANIFEST), "w") as f:
        json.dump(manifest, f)
    for name in [P.HEAD_FILE] + [P._layer_file(i) for i in range(n)]:
        os.symlink(os.path.join(sdir, name), os.path.join(out, name))
    return out


def ranks_failover(torch, serve, world):
    """Phase 18 (f): failover across ranks on the card: qwen2.5-14b at
    full width from the first ``FAILOVER_LAYERS`` layers of phase 5's q4
    store, the 8 ranks of ``world`` (4 stages x tp 2) streaming it,
    prompts of 4 tokens, 6 new tokens; the driver's ``--chaos failover``
    (``serve_failover``) ``SIGKILL``s stage 1's first rank as the third
    token's pass starts (which ends the world):
    the death attributed to stage 1, the survivors re-spawned as 2 x 2 =
    4 ranks that replay the history, zero tokens lost and the tokens after
    recovery equal a clean 4-rank run fed the same history."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen2.5-14b"),
                              n_layers=FAILOVER_LAYERS)
    sdir = first_layers(STORE_14B["dir"], FAILOVER_LAYERS)
    fargs = serve.parse_args(["--arch", "qwen2.5-14b", "--batch", "8",
                              "--ctx", "64", "--prompt-len", "4",
                              "--new-tokens", "6", "--seed", "0",
                              "--stages", str(RANK_STAGES),
                              "--tp", str(RANK_TP), "--ring-k", "1",
                              "--dtype", "bf16"])
    try:
        t0 = time.perf_counter()
        fo = serve.serve_failover(sdir, cfg, fargs, world=world)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    ev = fo["event"]
    exc = fo["failures"][0]
    died = exc.ranks("died")
    seen_ms = (exc.t_seen - exc.t_first) * 1e3
    if ev.failed_stage != 1 or ev.n_stages_after != 2 or ev.tokens_lost \
            or died != [RANK_TP]:
        raise AssertionError(f"(f) failover: {ev}, died {died}")
    RANKS["f"] = dict(detect_ms=ev.detect_s * 1e3, seen_ms=seen_ms,
                      resolve_ms=ev.resolve_s * 1e3,
                      rebuild_s=ev.rebuild_s, replay_s=ev.replay_s,
                      recovery_s=ev.recovery_s, wall=wall,
                      replayed=ev.replayed_tokens)
    log(f"  (f) rank {died[0]} (stage 1, member 0) SIGKILLed at token "
        f"{ev.token_index}: attributed to stage {ev.failed_stage}; 8 ranks "
        f"-> {ev.n_stages_after} x {RANK_TP} = "
        f"{ev.n_stages_after * RANK_TP} re-spawned (plan {ev.plan}), "
        f"replayed {ev.replayed_tokens} tokens, 0 lost; detect "
        f"{ev.detect_s * 1e3:.1f} ms (the death seen {seen_ms:.1f} ms after "
        f"the kill, then the world ended), re-solve "
        f"{ev.resolve_s * 1e3:.2f} ms, "
        f"rebuild {ev.rebuild_s:.2f} s (4 processes started and loaded), "
        f"replay {ev.replay_s:.2f} s; the tokens after recovery equal a "
        f"clean 4-rank run's fed the same history; the phase's run "
        f"{wall:.1f} s")


def ranks_parity(torch, ops, serve, world):
    """Phase 18 (b): 4 layers at full width, f32, an f32 and an int8
    cache: the ranks' logits (kernels on) against the one-process ring on
    ``use_kernels(False)``, the replicated activations equal to the bit
    across members, launches as derived, and the negative control
    (members merging without their shard's offset) failing."""
    from repro_torch.bridge import tree_from_params
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime import sharding as S
    from repro_torch.runtime.paramstore import save_param_store
    from repro_torch.runtime.serve import (RingPlan, RingServeStep,
                                           ring_cache_spec, ring_params)

    dev = torch.device("cuda")
    base = dataclasses.replace(get_config("qwen2.5-14b"), n_layers=4)
    n = 4
    params = init_params(base, torch.Generator("cuda").manual_seed(0),
                         dtype=torch.float32, device="cuda")
    sdir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        t0 = time.perf_counter()
        save_param_store(tree_from_params(params), base, sdir)
        log(f"  (b) a 4-layer f32 store written in "
            f"{time.perf_counter() - t0:.1f} s")
        path = os.path.join(sdir, "cache.pt")
        out = {}
        for kv in ("float32", "int8"):
            cfg = base if kv == "float32" else dataclasses.replace(
                base, kv_dtype="int8")
            args = serve.parse_args(RING_ARGS + [
                "--dtype", "f32", "--tp", str(RANK_TP), "--layers", "4"])
            _, cache, nxt, _ = serve.ring_prefill(params, cfg, args)
            save_cache(torch, cache, path)
            plan = RingPlan.make(cfg, RANK_STAGES, 1)
            step = RingServeStep(cfg, plan, ring_params(params, cfg, plan,
                                                        tp=RANK_TP),
                                 graphs=False, device=dev)
            rc = serve.to_ring_cache(cache, cfg, plan)
            ops.use_kernels(False)
            want, wcaches, tok = [], [], nxt
            try:
                for _ in range(n):
                    lg, rc = step(rc, tok)
                    lg = lg[..., :cfg.vocab].float()
                    want.append(lg.cpu().numpy())
                    wcaches.append({k: rc["layers"][k].cpu().numpy().copy()
                                    for k in ("k", "v")})
                    tok = lg.argmax(-1).to(torch.int32)
            finally:
                ops.use_kernels(True)
            del step, rc, cache
            free_card(torch)
            runs = {}
            for offsets in ((True, False) if kv == "float32" else (True,)):
                runs[offsets] = world.run(
                    RANK_JOB, cfg=cfg, n_stages=RANK_STAGES, tp=RANK_TP,
                    store=sdir, cache=path, first=nxt.cpu().numpy(),
                    steps=n, keep_logits=True, check_replicated=True,
                    return_cache=kv == "int8", offsets=offsets)
            ranks = runs[True]
            if kv == "float32":
                streamed_parity(world, cfg, sdir, path, nxt, n, want,
                                ranks)
            rank_launches(ranks, {"flash_verify_stats": plan.L_pad * n},
                          f"phase 18 (b) {kv} cache")
            for r in ranks:
                if r["unequal"] or not r["replicated"].get("x"):
                    raise AssertionError(f"rank {r['rank']}: replicated "
                                         f"activations differ across "
                                         f"members at {r['unequal']}")
            # every step held to 2e-4 and equal tokens, the int8 cache
            # too; the int8 k/v bytes that differ from the plain run's (a
            # line quantized on either side of a rounding boundary) are
            # counted after each step and reported
            flips = []
            if kv == "int8":
                mesh = {"data": RANK_STAGES, "model": RANK_TP}
                for t in range(n):
                    f = 0
                    for name in ("k", "v"):
                        spec = ring_cache_spec(f"['layers']['{name}']",
                                               wcaches[t][name].ndim, mesh)
                        got = S.assemble({(r["stage"], r["member"]):
                                          torch.from_numpy(
                                              r["caches"][t][name])
                                          for r in ranks}, spec, mesh)
                        f += int((got.numpy() != wcaches[t][name]).sum())
                    flips.append(f)
            r0, worst = ranks[0], 0.0
            for t in range(n):
                rel = float(np.abs(r0["logits"][t] - want[t]).max()
                            / np.abs(want[t]).max())
                worst = max(worst, rel)
                if rel >= 2e-4 or not np.array_equal(
                        r0["tokens"][t], want[t].argmax(-1)):
                    raise AssertionError(f"(b) {kv} cache step {t}: ranks "
                                         f"against plain {rel:.3g} of "
                                         f"max|ref|, or other tokens")
            ctrl = 0.0
            if kv == "float32":
                c0 = runs[False][0]
                ctrl = max(float(np.abs(c0["logits"][t] - want[t]).max()
                                 / np.abs(want[t]).max()) for t in range(n))
                if ctrl < 2e-4:
                    raise AssertionError("(b) the negative control (no "
                                         "shard offsets) passes: the check "
                                         "is blind")
            checks = sum(r0["replicated"].values())
            out[kv] = dict(worst=worst, control=ctrl, checks=checks,
                           flips=flips)
            log(f"  (b) {kv} cache: ranks' logits (kernels) within "
                f"{worst:.3g} of max|ref| of the one-process ring on "
                f"use_kernels(False) over all {n} steps, tokens equal"
                + (f" (int8 k/v bytes differing from the plain run's after "
                   f"each step {flips})" if kv == "int8" else "")
                + f"; {checks} replicated activations a member "
                f"equal to the bit on rank 0's stage (every rank checked)"
                + (f"; negative control without shard offsets "
                   f"{ctrl:.3g} of max|ref| (fails, as it should)"
                   if kv == "float32" else ""))
        RANKS["b"] = out
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
        del params
        free_card(torch)


def streamed_parity(world, cfg, sdir, path, nxt, n, want, resident):
    """Phase 18 (g): the streamed ring across the ranks on (b)'s 4-layer
    f32 store and cache: every step's logits within 2e-4 of max|ref| of
    the one-process ring on ``use_kernels(False)`` (``want``) with equal
    tokens, equal to the resident ranks' (max|d| 0), the launches as
    derived."""
    ranks = world.run(RANK_STREAM_JOB, cfg=cfg, n_stages=RANK_STAGES,
                      tp=RANK_TP, store=sdir, cache=path,
                      first=nxt.cpu().numpy(), steps=n, keep_logits=True,
                      check_replicated=True, depth=2)
    rank_launches(ranks, {"flash_verify_stats": cfg.n_layers * n},
                  "phase 18 (g)")
    r0, worst = ranks[0], 0.0
    for t in range(n):
        rel = float(np.abs(r0["logits"][t] - want[t]).max()
                    / np.abs(want[t]).max())
        worst = max(worst, rel)
        if rel >= 2e-4 or not np.array_equal(r0["tokens"][t],
                                             want[t].argmax(-1)):
            raise AssertionError(f"(g) step {t}: streamed ranks against "
                                 f"plain {rel:.3g} of max|ref|, or other "
                                 f"tokens")
    same = max(float(np.abs(a - b).max())
               for a, b in zip(r0["logits"], resident[0]["logits"]))
    if same != 0.0 or any(r["unequal"] for r in ranks):
        raise AssertionError(f"(g) streamed against resident ranks max|d| "
                             f"{same}, or members' activations differ")
    RANKS["g"] = dict(worst=worst, reads=r0["prefetch"]["reads"])
    log(f"  (g) the streamed ring across the ranks, f32: logits within "
        f"{worst:.3g} of max|ref| of the one-process ring on "
        f"use_kernels(False) over all {n} steps, tokens equal, equal to the "
        f"resident ranks' (max|d| 0); rank 0 read "
        f"{r0['prefetch']['reads']} rows in {n} passes")


def report_ranks() -> None:
    """Phase 18's numbers again, beside the card's name and power limit."""
    log(f"  card: {card()}")
    a = RANKS["a"]
    log(f"  (a) rank 0's step {a['step_ms']:.2f} ms, comm share "
        f"{a['share']:.3f}, verify T=5 {a['verify_ms']:.2f} ms; the "
        f"one-process ring {a['ref_ms']:.2f} ms; {a['n_equal']} of 8 rows "
        f"equal, {a['splits']} near-tie splits")
    log(f"  (b) {RANKS['b']}")
    e, f, g = RANKS["e"], RANKS["f"], RANKS["g"]
    log(f"  (e) rank 0's streamed step {e['step_ms']:.2f} ms against the "
        f"resident {e['res_ms']:.2f} ms; {e['gb']:.3f} GB read a pass a "
        f"rank, peak staged {e['peak']:.3f} GB, stall {e['stall']:.3f} s")
    log(f"  (f) detect {f['detect_ms']:.1f} ms (death seen after "
        f"{f['seen_ms']:.1f} ms), re-solve "
        f"{f['resolve_ms']:.2f} ms, rebuild {f['rebuild_s']:.2f} s, replay "
        f"{f['replay_s']:.2f} s ({f['replayed']} tokens); the phase "
        f"{f['wall']:.1f} s")
    log(f"  (g) streamed ranks against plain {g['worst']:.3g} of max|ref|")
    h, i = RANKS["h"], RANKS["i"]
    log(f"  (h) GSPMD at batch 1 ({GSPMD_LAYERS} layers bf16): rank 0's "
        f"step {h['step_ms']:.2f} ms, comm share {h['share']:.3f}, a rank's "
        f"part {h['part_gb'][0]:.3f}-{h['part_gb'][1]:.3f} GB of "
        f"{h['whole_gb']:.3f}; parity (f32) {RANKS['h_parity']}")
    log(f"  (i) train step across ranks: fsdp {i['fsdp']['ms']:.1f} ms, "
        f"zero1 {i['zero1']['ms']:.1f} ms, one process {i['one_ms']:.1f} ms;"
        f" peak a rank fsdp {max(i['fsdp']['peak_gb'])} GB, zero1 "
        f"{max(i['zero1']['peak_gb'])} GB")


# --------------------------------------------------------------------------- #
#  phase 18 (h), (i): the GSPMD layer across the same ranks
# --------------------------------------------------------------------------- #

GSPMD_JOB = "repro_torch.runtime.gspmd:rank_gspmd_job"
TRAIN_RANK_JOB = "repro_torch.runtime.train:rank_train_job"
#: phase 18 (h)'s depth in bf16: the first layers of qwen2.5-14b, cut for
#: time (at batch 1 a step keeps the weights where they lie and sums the
#: data ranks' products, but the 8 ranks time-slice the card and every
#: collective stages through host memory over gloo)
GSPMD_LAYERS = 4
#: (h)'s batch 1, its prompt, context and greedy steps
GSPMD_PROMPT, GSPMD_CTX, GSPMD_STEPS = 256, 512, 4
#: (h)'s parity in f32, kernels live, full width: (arch, layers, batch)
GSPMD_PARITY = (("qwen2.5-14b", 2, 1), ("recurrentgemma-9b", 3, 1),
                ("mamba2-780m", 2, 2))
#: (i)'s mesh: 2 stages x tp 4 over the same 8 ranks (zero1 at (4, 2)
#: would hold four tensor-parallel copies of the 7.3 GB f32 model with
#: their gradients and moments: ~73 GB of the card's 80)
TRAIN_RANK_MESH = (2, 4)
TRAIN_RANK_LR = 1e-3


def gspmd_tree(torch, arch, layers, dtype, seed=0):
    """(config, the one-process model on the card, a copy of it as the
    stacked tree the ranks cut their parts from)."""
    from repro_torch.bridge import tree_from_params
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                         dtype=dtype, device="cuda")
    return cfg, params, tree_from_params(
        params, leaf=lambda t: t.detach().clone())


def gspmd_launches(ranks, want, key, label):
    for r in ranks:
        full = {k: want.get(k, 0) for k in r[key]}
        if r[key] != full:
            raise AssertionError(f"{label}: rank {r['rank']} launched "
                                 f"{r[key]}, wanted {full}")
    return {k: sum(r[key][k] for r in ranks) for k in ranks[0][key]}


def gspmd_full(torch, world):
    """Phase 18 (h): qwen2.5-14b at full width, ``GSPMD_LAYERS`` layers,
    bf16, batch 1 over 4 stages x tp 2 (one sequence does not split over
    the stages: the JAX driver's ``gspmd_decode_step`` path): each rank
    cuts its FSDP part of every weight (the tree handed over as CUDA
    tensors), prefills the prompt into its part of the cache and takes
    ``GSPMD_STEPS`` greedy steps; every rank the same tokens, exactly
    ``GSPMD_LAYERS`` B5 launches a step a rank (40 heads over 8: the kv
    heads split over tp, each member attends with its 4). Returns the
    launches summed over the ranks."""
    cfg, params, tree = gspmd_tree(torch, "qwen2.5-14b", GSPMD_LAYERS,
                                   torch.bfloat16)
    del params
    free_card(torch)
    from repro_torch.runtime.sharding import flatten_with_path

    whole = sum(t.numel() * t.element_size()
                for _, t in flatten_with_path(tree))
    prompts = np.random.default_rng(1).integers(
        3, cfg.vocab, (1, GSPMD_PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    ranks = world.run(GSPMD_JOB, cfg=cfg, n_stages=RANK_STAGES, tp=RANK_TP,
                      params=tree, steps=GSPMD_STEPS, prompts=prompts,
                      ctx_len=GSPMD_CTX, dtype="bfloat16", trace=True)
    wall = time.perf_counter() - t0
    del tree
    free_card(torch)
    for r in ranks:
        if not np.array_equal(r["tokens"], ranks[0]["tokens"]):
            raise AssertionError(f"(h) rank {r['rank']} took other tokens")
    total = gspmd_launches(ranks, {"flash_verify": GSPMD_LAYERS
                                   * GSPMD_STEPS}, "launches",
                           "phase 18 (h)")
    gspmd_launches(ranks, {}, "prefill_launches", "phase 18 (h) prefill")
    r0 = ranks[0]
    step_ms = 1e3 * float(np.median(r0["step_s"][1:]))
    parts = [r["nbytes"] for r in ranks]
    RANKS["h"] = dict(step_ms=step_ms, share=r0["comm_share"],
                      prefill_ms=1e3 * r0["prefill_s"], wall=wall,
                      whole_gb=whole / 1e9,
                      part_gb=(min(parts) / 1e9, max(parts) / 1e9),
                      load_s=max(r["load_s"] for r in ranks),
                      peak_gb=max(r["max_memory_allocated"]
                                  for r in ranks) / 1e9)
    h = RANKS["h"]
    log(f"  (h) GSPMD decode across 8 ranks (4 stages x tp 2), qwen2.5-14b "
        f"full width, {GSPMD_LAYERS} layers, bf16, batch 1: prefill of "
        f"{GSPMD_PROMPT} tokens {h['prefill_ms']:.1f} ms, rank 0's step p50 "
        f"{step_ms:.2f} ms (eager), {h['share']:.3f} of it in the "
        f"collectives and their host staging; each rank holds "
        f"{h['part_gb'][0]:.3f}-{h['part_gb'][1]:.3f} GB of the "
        f"one-process model's {h['whole_gb']:.3f} GB (FSDP over data and "
        f"model), peak allocated {h['peak_gb']:.2f} GB a rank; parts "
        f"loaded in {h['load_s']:.1f} s; launches a rank exactly "
        f"{GSPMD_LAYERS * GSPMD_STEPS} B5 (heads split), over the 8 ranks "
        f"{total}; tokens equal on every rank; the world's run "
        f"{wall:.1f} s")
    return total


def gspmd_parity(torch, ops, world):
    """Phase 18 (h) parity: each of ``GSPMD_PARITY`` at full width in f32,
    kernels live on both sides: the ranks' GSPMD prefill and 4 greedy
    steps against the one-process ``prefill`` and ``decode_step`` on the
    card, logits within 2e-4 of max|ref| and equal tokens at every step.
    qwen2.5-14b runs B5 over its heads, recurrentgemma-9b B5 stats over
    its local attention's sequence (one kv head), mamba2-780m B6 in the
    prefill, each counted exactly. Returns the launches summed over the
    ranks (prefill and steps)."""
    from repro_torch.models import model as M

    steps, S, ctx = 4, 64, 128
    want_launch = {"qwen2.5-14b": ("flash_verify", lambda L: L * steps,
                                   None),
                   "recurrentgemma-9b": ("flash_verify_stats",
                                         lambda L: (L // 3) * steps, None),
                   "mamba2-780m": ("ssd_scan", None, lambda L: L)}
    total, out = {}, {}
    for arch, L, B in GSPMD_PARITY:
        cfg, params, tree = gspmd_tree(torch, arch, L, torch.float32)
        prompts = np.random.default_rng(2).integers(
            3, cfg.vocab, (B, S)).astype(np.int32)
        cache = M.init_cache(cfg, B, ctx, device="cuda")
        lg, cache = M.prefill(params, cfg, torch.as_tensor(
            prompts, device="cuda"), cache)
        want = [lg[:, -1:].float().cpu().numpy()]
        tok = lg[:, -1:].argmax(-1).to(torch.int32)
        for _ in range(steps):
            lg, cache = M.decode_step(params, cfg, cache, tok)
            want.append(lg.float().cpu().numpy())
            tok = lg.argmax(-1).to(torch.int32)
        del params, cache, lg
        free_card(torch)
        ranks = world.run(GSPMD_JOB, cfg=cfg, n_stages=RANK_STAGES,
                          tp=RANK_TP, params=tree, steps=steps,
                          prompts=prompts, ctx_len=ctx, keep_logits=True)
        del tree
        free_card(torch)
        name, per_step, per_prefill = want_launch[arch]
        gspmd_launches(ranks, {name: per_step(L)} if per_step else {},
                       "launches", f"phase 18 (h) {arch}")
        gspmd_launches(ranks, {name: per_prefill(L)} if per_prefill else {},
                       "prefill_launches", f"phase 18 (h) {arch} prefill")
        for r in ranks:
            for k in r["launches"]:
                total[k] = total.get(k, 0) + r["launches"][k] \
                    + r["prefill_launches"][k]
        worst = 0.0
        for r in ranks:
            lo, hi = r["rows"]
            for t, got in enumerate(r["logits"]):
                w = want[t][lo:hi]
                rel = float(np.abs(got - w).max() / np.abs(w).max())
                worst = max(worst, rel)
                if rel >= 2e-4 or not np.array_equal(
                        got.argmax(-1), w.argmax(-1)):
                    raise AssertionError(f"(h) {arch} step {t}: ranks "
                                         f"against one process {rel:.3g} "
                                         f"of max|ref|, or other tokens")
        out[arch] = worst
        log(f"  (h) parity {arch} ({L} layers, f32, batch {B}): the ranks' "
            f"prefill and {steps} steps within {worst:.3g} of max|ref| of "
            f"the one-process prefill and decode_step on the card, tokens "
            f"equal; {name} "
            + (f"{per_step(L)} a rank over the steps" if per_step else
               f"{per_prefill(L)} a rank in the prefill"))
    RANKS["h_parity"] = out
    return total


def gspmd_train(torch, world):
    """Phase 18 (i): one ``fsdp`` and one ``zero1`` train step of
    qwen2.5-14b at full width, 1 layer, f32, across the 8 ranks as 2
    stages x tp 4 (``TRAIN_RANK_MESH``), against the one-process
    ``make_train_step`` on the card (phase 17's step) on the same weights
    and batch (8 x 128), with the bounds of the CPU test
    (``tests/test_torch_train_ranks.py``): loss and gradient norm within
    1e-5 relative; each leaf's first moment (1 - b1) g within 1e-4 of
    its max|ref|; every parameter whose one-process update is at least
    0.99 lr within 0.1 lr. Adam's first update lr g / (|g| + eps) is
    near lr wherever the gradient is clear of eps; among 1.83 B
    gradients some lie near eps, where the update turns a rounding of g
    into a sizeable part of lr: the elements beyond 0.1 lr are printed
    by leaf with their one-process |g| in units of eps. zero1 runs one
    gradient reduce-scatter and one parameter all-gather over "data".
    Each rank compares its own parts with the one-process step's
    (``runtime.train.reference_diffs``): the weights before and after it
    stay on the card and go to the ranks as CUDA tensors (8 ranks' f32
    parts would be 7.3 GB to send back); the first moment goes on the
    host, shared (the card has no room for a third copy beside zero1's
    ranks)."""
    from repro_torch.bridge import tree_from_params, tree_of_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime.optim import AdamW
    from repro_torch.runtime.train import make_train_step

    def shared_host(tree):
        # copied straight into shared memory, where the ranks map it
        if isinstance(tree, dict):
            return {k: shared_host(v) for k, v in tree.items()}
        out = torch.empty(tree.shape, dtype=tree.dtype).share_memory_()
        return out.copy_(tree)

    M_, tp = TRAIN_RANK_MESH
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2.5-14b"), n_layers=1)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                         dtype=torch.float32, device="cuda")

    def copy(t):
        return t.detach().clone()
    tree = tree_from_params(params, leaf=copy)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (8, 129)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = AdamW(lr=TRAIN_RANK_LR, warmup_steps=1)
    step = make_train_step(cfg, opt, grad_dtype="float32")
    leaves = list(params.parameters())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, st, m = step(params, opt.init(leaves), {
        k: torch.as_tensor(v, device="cuda") for k, v in batch.items()})
    torch.cuda.synchronize()
    one_ms = 1e3 * (time.perf_counter() - t1)
    ref = {k: float(v) for k, v in m.items()}
    after = tree_from_params(params, leaf=copy)
    mu_ref = shared_host(tree_of_leaves(params, st.mu))
    del params, st, m, leaves, step
    free_card(torch)
    setup_s = time.perf_counter() - t0
    bound = 0.1 * TRAIN_RANK_LR
    out = {}
    for style in ("fsdp", "zero1"):
        free_gb = torch.cuda.mem_get_info()[0] / 1e9
        t0 = time.perf_counter()
        ranks = world.run(TRAIN_RANK_JOB, cfg=cfg, n_stages=M_, tp=tp,
                          params=tree, batches=[batch], style=style,
                          optimizer=opt, grad_dtype="float32",
                          return_state=False, reference=(after, mu_ref))
        wall = time.perf_counter() - t0
        r0 = ranks[0]
        got = r0["metrics"][0]
        worst = max(r["max_param_diff"] for r in ranks)
        clear = max(r["max_param_diff_clear"] for r in ranks)
        mu_rel = {}
        for q in r0["mu_diff"]:
            dq = max(r["mu_diff"][q][0] for r in ranks)
            rq = max(r["mu_diff"][q][1] for r in ranks)
            mu_rel[q] = dq / rq if rq else (0.0 if dq == 0 else math.inf)
        over = {}
        for r in ranks:
            for q, o in r["param_over"].items():
                w = over.setdefault(q, {"n": 0, "max_lr": 0.0, "g_eps": 0.0,
                                        "g_eps_max": 0.0})
                w["n"] += o["n"]
                w["g_eps_max"] = max(w["g_eps_max"], o["g_eps_max"])
                if o["max_lr"] > w["max_lr"]:
                    w.update(max_lr=o["max_lr"], g_eps=o["g_eps"])
        c = r0["collectives"][0]
        out[style] = dict(
            ms=1e3 * r0["step_s"][0], wall=wall, worst=worst, clear=clear,
            mu_rel=max(mu_rel.values()), loss=got["loss"],
            gnorm=got["grad_norm"], free_gb=free_gb,
            peak_gb=[round(r["max_memory_allocated"] / 1e9, 2)
                     for r in ranks],
            rs=c.get("reduce-scatter[data]", {}).get("count", 0),
            ag=c.get("all-gather[data]", {}).get("count", 0),
            compare_s=max(r["compare_s"] for r in ranks))
        o = out[style]
        log(f"  (i) {style} across 8 ranks ({M_} stages x tp {tp}): loss "
            f"{got['loss']:.6f} against {ref['loss']:.6f}, grad norm "
            f"{got['grad_norm']:.6f} against {ref['grad_norm']:.6f}, "
            f"first moment within {o['mu_rel']:.3g} of its leaf's max|ref| "
            f"(bound 1e-4), parameters within {clear:.3g} where the "
            f"one-process update is at least 0.99 lr ({worst:.3g} over "
            f"all) of its; step {o['ms']:.1f} ms (the one-process step "
            f"{one_ms:.1f} ms), {o['rs']} reduce-scatters and {o['ag']} "
            f"all-gathers over data; max_memory_allocated a rank "
            f"{o['peak_gb']} GB ({free_gb:.1f} GB of the card free as the "
            f"job started); the world's run {wall:.1f} s, the ranks' "
            f"comparison with the reference {o['compare_s']:.1f} s of it "
            f"(setup: the weights, the one-process step and the copies "
            f"{setup_s:.1f} s)")
        log(f"  (i) {style} first moment by leaf (max|d| / max|ref|): "
            + ", ".join(f"{q} {v:.3g}" for q, v in sorted(
                mu_rel.items(), key=lambda kv: -kv[1])))
        log(f"  (i) {style} parameters beyond 0.1 lr, by leaf (elements, "
            f"the largest in lr, its one-process |g| and the largest |g| "
            f"among them in eps): "
            + (", ".join(f"{q} {w['n']} {w['max_lr']:.3g} lr "
                         f"|g| {w['g_eps']:.3g} ({w['g_eps_max']:.3g}) eps"
                         for q, w in over.items()) or "none"))
        for k in ("loss", "grad_norm"):
            if abs(got[k] - ref[k]) > 1e-5 * abs(ref[k]):
                raise AssertionError(f"(i) {style} {k} {got[k]} against "
                                     f"the one-process {ref[k]}")
        far = {q: v for q, v in mu_rel.items() if v > 1e-4}
        if far:
            raise AssertionError(f"(i) {style}: first moment beyond 1e-4 "
                                 f"of its leaf's max|ref|: {far}")
        if clear > bound:
            raise AssertionError(f"(i) {style}: parameters {clear} from the "
                                 f"one-process step's where its update is "
                                 f"at least 0.99 lr (bound 0.1 lr)")
        if style == "zero1" and (c["reduce-scatter[data]"]["count"] != 1
                                 or c["all-gather[data]"]["count"] != 1):
            raise AssertionError(f"(i) zero1 collectives over data {c}")
        del ranks
    del tree, after, mu_ref
    free_card(torch)
    RANKS["i"] = dict(out, one_ms=one_ms, setup_s=setup_s)


def share_bytecode():
    """Where the environment sets ``PYTHONDONTWRITEBYTECODE``, every new
    Python process compiles torch's sources again, seconds of its start;
    phase 11 starts 16 driver processes and 72 ranks, phase 18 8 ranks.
    Every process this script starts shares one bytecode cache in the
    temp dir instead (``PYTHONPYCACHEPREFIX``; nothing is written beside
    the installed packages), removed at exit. Returns the process that
    warms it with the imports a rank makes."""
    import atexit

    pyc = tempfile.mkdtemp(prefix="chip_smoke_pycache_")
    atexit.register(shutil.rmtree, pyc, True)
    os.environ["PYTHONPYCACHEPREFIX"] = pyc
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p))
    return subprocess.Popen(
        [sys.executable, "-c", "import torch, repro_torch.launch.serve"],
        cwd=ROOT, env=env)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    return smi.splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import serve

    t_start = time.perf_counter()
    log("== phase 0: device")
    log(card())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("== phase 1: build")
    t0 = time.perf_counter()
    warm = share_bytecode()
    paths = _build.build()
    for name in paths:
        _build.load(name)
    if warm.wait() != 0:
        raise AssertionError("importing the port in a new process failed")
    log(f"  {', '.join(p.name for p in paths.values())} ready in "
        f"{time.perf_counter() - t0:.1f} s (and the processes' shared "
        f"bytecode cache warmed)")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("== phase 2: kernels against their plain versions "
        f"(H {H}, h_kv {H_KV}, D {D}, pages of {BS})")
    timer = Timer(torch)
    rows = check_kernels(torch, timer, np.random.default_rng(0))
    rows["q4_matmul"] = check_q4(torch, timer, np.random.default_rng(1))
    rows["flash_verify"] = check_flash(torch, timer,
                                       np.random.default_rng(2))
    rows["flash_verify_stats"] = check_flash_stats(
        torch, timer, np.random.default_rng(5))
    check_head_dims(torch, np.random.default_rng(4))
    rows["ssd_scan"] = check_ssd(torch, timer, np.random.default_rng(3))
    log(f"  phase 2 done at {time.perf_counter() - t_start:.0f} s")

    log(f"== phase 3: serve qwen2.5-14b at full width, {PAGED_LAYERS} of 48 "
        f"layers, bf16")
    counts = serve_full(torch, ops, serve)
    log(f"  main-path launches: {counts}")
    log(f"  phase 3 done at {time.perf_counter() - t_start:.0f} s")

    log(f"== phase 4: token parity, {PARITY_LAYERS} layers full width f32")
    parity(torch, ops, serve)
    log(f"  phase 4 done at {time.perf_counter() - t_start:.0f} s")

    log("== phase 5: streamed q4 serve of qwen2.5-14b at full width, 48 "
        "layers, bf16")
    stream_counts = serve_streamed_full(torch, ops, serve)
    log(f"  main-path launches: {stream_counts}")
    log(f"  phase 5 done at {time.perf_counter() - t_start:.0f} s")

    log("== phase 6: q4 parity, 3 layers full width f32")
    q4_parity(torch, ops, serve)
    log(f"  phase 6 done at {time.perf_counter() - t_start:.0f} s")

    log(f"== phase 7: speculative serve of qwen1.5-32b at full width, "
        f"{SPEC_LAYERS} layers, streamed q4, qwen1.5-0.5b draft")
    spec_counts = serve_spec_full(torch, ops, serve)
    log(f"  main-path launches: {spec_counts}")
    log(f"  phase 7 done at {time.perf_counter() - t_start:.0f} s")

    log(f"== phase 8: spec parity, {SPEC_PARITY_LAYERS} layers full width "
        f"f32")
    spec_parity(torch, ops, serve)
    log(f"  phase 8 done at {time.perf_counter() - t_start:.0f} s")

    log(f"== phase 9: serve mamba2-780m at full width, {SSM_LAYERS} of 48 "
        f"layers, bf16: dense engine, then streamed q4")
    ssm_counts = serve_ssm_full(torch, ops, serve)
    log(f"  main-path launches: {ssm_counts}")
    log(f"  phase 9 done at {time.perf_counter() - t_start:.0f} s")

    log(f"== phase 10: ssm parity, {PARITY_LAYERS} layers full width f32")
    ssm_parity(torch, ops, serve)
    log(f"  phase 10 done at {time.perf_counter() - t_start:.0f} s")

    log("== phase 11: the CI smokes' shapes (reduced configs, head_dim 16) "
        "on the card")
    ci_smokes()
    log(f"  phase 11 done at {time.perf_counter() - t_start:.0f} s")

    log("== phase 12: steps replayed from CUDA graphs against eager, and "
        "where a step's time goes (recorded in phases 3 and 7)")
    report_graphs()
    log(f"  phase 12 done at {time.perf_counter() - t_start:.0f} s")

    log("== phase 13: tiered KV memory, qwen2.5-14b at full width, 48 "
        "layers, bf16 pages")
    serve_tiered_full(torch, ops, serve)
    report_tiers()
    log(f"  phase 13 done at {time.perf_counter() - t_start:.0f} s")

    log(f"== phase 14: the piped ring, qwen2.5-14b at full width: "
        f"resident bf16 ({RING_A_LAYERS} layers), resident and streamed q4 "
        f"({RING_LAYERS} layers), failover, parity")
    ring_resident(torch, ops, serve)
    ring_streamed(torch, ops, serve)
    ring_parity(torch, ops, serve)
    report_ring()
    log(f"  phase 14 done at {time.perf_counter() - t_start:.0f} s")

    log(f"== phase 15: the moe family: mixtral-8x7b q4 resident, streamed "
        f"and through the ring ({MOE_LAYERS} of 32 layers), bf16 paged "
        f"({MOE_PAGED_LAYERS} layers), parity with phi3.5-moe "
        f"({PARITY_LAYERS} layers "
        f"f32), the card's profile")
    moe_counts = moe_streamed(torch, ops, serve)
    log(f"  main-path launches: {moe_counts}")
    moe_paged_counts = moe_paged(torch, ops, serve)
    moe_parity(torch, ops, serve)
    moe_profile(torch)
    report_moe()
    log(f"  phase 15 done at {time.perf_counter() - t_start:.0f} s")

    log("== phase 16: the four families left: minicpm3-4b (MLA), "
        "qwen2-vl-2b (vlm), recurrentgemma-9b (hybrid), whisper-tiny "
        "(audio) at published widths, then parity at 4 layers f32")
    fam_counts = {}
    for fn in (mla_full, vlm_full, hybrid_full, whisper_full):
        for k, v in fn(torch, ops, serve).items():
            fam_counts[k] = fam_counts.get(k, 0) + v
        log(f"  {fn.__name__} done at {time.perf_counter() - t_start:.0f} s")
    log(f"  main-path launches: {fam_counts}")
    plain_hot_spots(torch)
    fam_parity(torch, ops, serve)
    report_fam()
    log(f"  phase 16 done at {time.perf_counter() - t_start:.0f} s")

    log(f"== phase 17: training on the card: qwen2.5-14b at full width "
        f"({QWEN_TRAIN_LAYERS} layers, f32) with a checkpoint and a resume, "
        f"mamba2-780m at full width and depth through B6, parity")
    train_qwen(torch, ops)
    train_mamba(torch, ops)
    train_parity(torch, ops)
    report_train()
    log(f"  phase 17 done at {time.perf_counter() - t_start:.0f} s")

    log(f"== phase 18: the ring across ranks: 4 stages x tp 2 = 8 rank "
        f"processes on the card over gloo (qwen2.5-14b at full width and "
        f"depth from phase 5's q4 store, resident and streamed; parity at 4 "
        f"layers f32; the GSPMD layer at batch 1, {GSPMD_LAYERS} layers "
        f"bf16, its parity in f32 and its fsdp and zero1 train steps; "
        f"failover at {FAILOVER_LAYERS} layers)")
    from repro_torch.launch.mesh import RankWorld
    with RankWorld(RANK_STAGES * RANK_TP, device="cuda:0",
                   threads=1) as world:
        world.start()            # the ranks reach the card meanwhile
        rank_counts = ranks_full(torch, world)
        log(f"  (a) done at {time.perf_counter() - t_start:.0f} s")
        stream_counts_18 = ranks_streamed(torch, world)
        log(f"  (e) done at {time.perf_counter() - t_start:.0f} s")
        ranks_parity(torch, ops, serve, world)
        log(f"  (b), (g) done at {time.perf_counter() - t_start:.0f} s")
        gspmd_counts = gspmd_full(torch, world)
        for k, v in gspmd_parity(torch, ops, world).items():
            gspmd_counts[k] += v
        log(f"  (h) done at {time.perf_counter() - t_start:.0f} s")
        gspmd_train(torch, world)
        log(f"  (i) done at {time.perf_counter() - t_start:.0f} s")
        ranks_failover(torch, serve, world)
    shutil.rmtree(STORE_14B.pop("dir"), ignore_errors=True)
    report_ranks()
    log(f"  phase 18 done at {time.perf_counter() - t_start:.0f} s")

    counts["q4_matmul"] = stream_counts["q4_matmul"] \
        + moe_counts["q4_matmul"]
    counts["flash_verify"] = spec_counts["flash_verify"] \
        + moe_counts["flash_verify"]
    counts["ssd_scan"] = ssm_counts["ssd_scan"] + TRAIN["mamba"]["launches"]
    for k, v in moe_paged_counts.items():
        counts[k] += v
    for k, v in fam_counts.items():
        counts[k] += v
    counts["flash_verify_stats"] = rank_counts["flash_verify_stats"] \
        + stream_counts_18["flash_verify_stats"]
    counts["q4_matmul"] += stream_counts_18["q4_matmul"]
    for k, v in gspmd_counts.items():
        counts[k] += v
    for name, row in rows.items():
        row["launches"] = counts[name]
    log(f"all phases passed in {time.perf_counter() - t_start:.0f} s on")
    log(card())
    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
