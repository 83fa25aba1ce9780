#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only phase_wkv6_tune,phase_mamba_tune
    python3 chip_smoke.py --only phase_strided_parity,phase_spec,phase_chaos
    python3 chip_smoke.py --only phase_adapters
    python3 chip_smoke.py --only phase_moe,phase_frontend
    python3 chip_smoke.py --only phase_tp
    python3 chip_smoke.py --only phase_train_dist
    python3 chip_smoke.py --only phase_serve_step,phase_dryrun
    python3 chip_smoke.py --only \
        phase_page_parity,phase_page_timing,phase_prefix

``--only`` is for development: it runs the card phase and then the
named phases (the methods of ``Smoke``; the scan kernels' tile sweeps
``phase_wkv6_tune`` and ``phase_mamba_tune`` run only this way) and
prints no result line.

Phases 19-22 (``BESIDE``: each spawns two ranks under gloo on the one
card) run in a second process of this script (``--beside``, for the
first process only), beside phases 4, 12, 16, 17 and 18 in this one; its
output is printed, and its failures and parity errors taken, when both
are done.  Then phases 11, 9, 13, 7, 8 and 10, in that order, have the
card to themselves.

Phases (any failure exits non-zero and prints no result line):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of the CUDA kernels from ``src/repro_torch/
   csrc`` with ``nvcc`` (timed), with ``-Xptxas -v``'s registers and
   spills of every kernel instance, and for each instance of the two
   scan kernels the instruction count, the MUFU.EX2 count and the
   FFMA.RM / FFMA.SAT of expf's range reduction in ``cuobjdump -sass``.
2. Kernel parity: each hand-written kernel against its plain PyTorch
   version on the card, at the main path's shapes and at edge cases
   (GQA groups of 1 and 2, dq != dv, lengths 0 / 1 / mid-tile /
   mid-page, finite garbage past the lengths, sentinel page ids, S < T).
   Tolerance: max abs error <= 2e-5 (float32, unit-scale inputs).  The
   RWKV-6 ``wkv6`` kernel likewise, for out and S_end, at the rwkv6
   path's shapes (B=4, H=32, d=64: T = 1, 64, 1024) and at T = 7 and
   1000, d = 32, B*H = 1, s0 absent / zero / random, decays at the clip
   edges -10 and -1e-4 (decay ~ 1: the state grows over T), u of either
   sign, B = 1 at T = 1 and 432, inputs 4 bytes off 16-byte alignment,
   s0 left unwritten, and chained calls (T1, then T2 from S_end) equal
   to one call over T1 + T2 within the tolerance and bit for bit;
   tolerance 2e-5 * max(1, max |want|), because the state accumulates
   over T; every case at every tile the kernel is built for.  The Mamba
   ``mamba_scan`` kernel likewise, for y and h_end, at the jamba path's
   shapes (B=4, dI=8192, dS=16: S = 1, 64, 1024) and at S = 7 and 1000,
   dI = 96, 1000 and 8168 (ragged channel blocks) and 8190 (4-byte
   copies), B = 1, h0 absent / zero / random, dt near 0 (decay ~ 1) and
   large (decay ~ 0), unaligned inputs, h0 left unwritten, and chained
   calls, at every (lanes, channels, exponential) it is built for.  The three
   attention kernels also at jamba's GQA shapes: 32 query heads over 8
   KV heads (G = 4), widths 128 (decomposed) and 64 (pruned), lengths
   mid-tile, 0 and 1.  ``flash_attention`` (3xTF32 tensor cores) also at
   widths that are not multiples of 8 (20/12) or of 4 (7/5), one query
   against 1024 keys, G = 16, and inputs scaled by 8 (large logits),
   those held to 2e-5 * max(1, max |want|); all three also at the MoE
   and frontend configs' shapes: G = 2 at 64/64 and 64/32 (granite's 16
   heads over 8), G = 2 at 128/128 and 128/64 (internvl2, scoring over
   256 patches + 1024 tokens), G = 1 at 128/128 and 128/64 (qwen2's 16
   heads) and 32/32 (musicgen pruned, 32 heads, scoring over 250 frames
   + 1024 tokens), and the frontend decode's 322- and 328-position
   caches; the decode kernels also at
   lengths on the split planner's boundaries (computed from the card's
   SM count) and on page boundaries, length 1, full capacity and G =
   16.  All three also at the RoPE configs' shapes: G = 7 (deepseek's
   56 heads over 8) and G = 3 (minitron's 24 over 8) at 128/128,
   stablelm's 32 heads at 80/80 and pruned to 52/40 (20 rotated dims +
   32 of the tail / 40), phi3's 40 heads over 10 at 128/128 and 128/64,
   ``flash_attention`` at the RoPE phase's own scoring (B = 4, S = T =
   1024) and greedy_reference (B = 1, S = T = 432) shapes.  The four
   decode kernels also on the self-speculative draft's strided views
   ``cache[..., :r]`` of full-width caches and pools (gpt2-xl 32/32 ->
   16/16, stablelm 52/40 -> 36/24, phi3 128/64 -> 128/32, jamba's G = 4
   64/64 -> 32/32 and an odd row stride 33/27 -> 16/13; lengths 0, 1,
   mid-tile, full capacity; the ranked ones with ragged ranks clamped to
   the draft widths): within 2e-5 of the plain version on the views and
   bit for bit the kernel on a contiguous copy of them.  Every decode
   parity case above (dense, paged, ranked, strided, and those of phases
   7 and 19 and the lse's) also runs at DTYPE_PAIRS: bfloat16 compute
   over bfloat16, float32 and float8_e4m3fn caches and float16 over
   float16, each held to its plain version (the TPU kernels' 16-bit
   function: at least 99% of the outputs bit for bit, every one within
   one ulp at its row's largest |output|), and float32 compute over
   bfloat16 and float8_e4m3fn caches, bit for bit the kernel on
   ``cache.float()``; the strided views of the narrow caches also bit for
   bit the kernel on a contiguous copy.  Eighteen ``flash_attention``
   cases (FLASH16_CASES: gpt2-xl scoring, widths 20/12
   and 7/5 with G = 3, G = 16, one query over 1024 keys, inputs x 8, 256
   wide, jamba G = 4 at 128, phi3 128/64, internvl2 G = 2 at 128 over
   1280, T = 432 and 1274 (not multiples of 128), S < T; for the packed
   128-row tiles G = 5 and G = 7, whose head groups end in a ragged tile,
   and S G not a multiple of the tile with S < T) run with q,
   K and V in bfloat16 and in float16, each held to
   ``ref.flash_attention_ref`` (the TPU kernel's 16-bit function) by the
   same rule (rows (b, s, h)).  The window form (``window_attention``,
   the reference's XLA attention over a cache window at 16 bits) at
   WINDOW_CASES (phase 21's gpt2-xl window, a second prefill of 520 over
   1120, musicgen's sequence-split prefill, phi3 G = 4 at 128/64, widths
   20/12 and 7/5 at G = 3, T not a multiple of 64, inputs x 8; G = 5 and
   7, 64 queries over 2048 keys, 256-wide heads), in
   bfloat16 and float16 and in the case's scale order(s), each held to
   ``ref.window_attention_ref`` by the same rule; strided cache windows
   (one at G = 4) bit for bit the kernel on a contiguous copy (``dtypes``
   / ``exact window_attention`` lines).  Each of these lines names the
   route the 16-bit forms' plan (``clover_attention.plan16``) staged K
   and V by: ``[tma]`` or ``[cp.async]``.
3. Kernel timing at the main path's shapes: CUDA events over repeated
   launches with rotating input copies (so K/V come from HBM, as on the
   main path), beside the plain version's time, the time of one PyTorch
   library call on the same work (``scaled_dot_product_attention``, or
   none for the paged layout) and the bound: the larger of the bytes the
   call must move over 3.35 TB/s and its float32 FLOPs over 67 TFLOP/s
   (H100 SXM data sheet) -- for ``flash_attention``, whose products run
   on the tensor cores at float32 accuracy, its FLOPs over the 3xTF32
   rate of 495 / 3 = 165 TFLOP/s (and its exponentials over the
   special-function units).  The SDPA backend of each library call is
   printed; at G = 4 the library call is SDPA held to the
   memory-efficient backend on K/V expanded to the query heads, beside
   SDPA with ``enable_gqa``.  ``wkv6`` at its three path shapes, at a
   greedy_reference prompt (B = 1, T = 432) and at a B = 1 step (an edge
   case no path runs), beside its plain version (timed between events
   without the spin: it launches several kernels per time step) and no
   library call (none computes it).  ``mamba_scan`` the same way at its
   five shapes; its operations bound is the slower of its float32
   operations over 67 TFLOP/s and its exponentials over the
   special-function units (16 per SM per clock).  The attention
   kernels again at jamba's G = 4 shapes (``time`` lines only), and
   ``flash_attention`` and ``flash_decode`` at phi3-medium-14b's pruned
   attention (40 heads over 10, 128/64; scoring at B = 1, S = T = 1024,
   decode as above), beside the same two SDPA yardsticks (``time``
   lines only), and rows 1-3 at G = 2 64/64 ("G2 64"), G = 2 128/128
   ("G2 128") and G = 1 128/64 ("G1 128/64", scoring 2 sequences), each
   beside the same two SDPA yardsticks and its bound (``time`` lines
   only).  The four decode kernels at gpt2-xl's draft shape
   (cache 32/32, draft 16/16): the strided call, a ``.contiguous()``
   copy of the views plus the kernel, the full-width call and the
   bound at the draft widths (``time draft`` lines).  The four decode
   kernels also with q in bfloat16 over a bfloat16 and a float8_e4m3fn
   cache ("<kernel> bf16" / "fp8" ``time`` lines), beside their bounds
   at 2 and 1 bytes a K / V element.  ``flash_attention``'s 16-bit form
   in bfloat16 and float16 at five shapes (gpt2-xl scoring, phi3 128/64,
   qwen2 G = 1 128/64, internvl2 G = 2 128/128, jamba G = 4 64/64;
   "flash_attention bf16 <shape>" / "fp16" ``time`` lines), beside its
   plain version, SDPA in the same dtype on K/V expanded to the query
   heads (the FLASH_ATTENTION backend where dq = dv, EFFICIENT_ATTENTION
   where not; every timed shape must be staged by TMA, the route printed
   in its line) and its bound: the largest of the bytes over 3.35 TB/s,
   the FLOPs over 989 TFLOP/s (dense bf16 / fp16 tensor cores) and the
   exponentials over the special-function units.  The window form the
   same way at phase 21's gpt2-xl window (B4, S = T = 960, 25 heads of
   64) and phi3 128/64 (B1, S = T = 1024), its bound the function's
   work (one Q.K, one P.V and one exponential a causal pair, each byte
   moved once); ``time window`` lines add the route before it (float32
   copies, the 3xTF32 kernel, the cast back), the 16-bit scoring form on
   the same operands, the design's own floor (two Q.K sweeps, P.V, two
   exponentials a pair) and each route's added peak for one call.
4. The main path at gpt2-xl's full width (48 layers, d_model 1600, 25
   heads, vocab 50257), random weights from seed 0: scoring before and
   after ``clover_decompose`` (function preserved: max |dlogits| <=
   1e-3 max |logits|), ``clover_prune`` to ranks 32/32 with the scoring
   loss before and after, then 8 greedy requests (prompts of 16-400
   tokens, 32 new tokens) served by ``Engine`` dense and paged (pool
   small enough to preempt), each stream equal to ``greedy_reference``
   token for token (a divergence passes only where the reference's
   top-two logits are within 1e-4 max |logit|).  Every kernel's launch
   count must grow in its phase and the plain versions' counts stay 0.
   Then a short dense decode (through ``flash_decode``, launched on the
   cache as it lies: K in the cache's dtype, q in the compute dtype) with
   the KV cache stored in bfloat16 and in float8_e4m3fn, and with the
   weights cast to bfloat16 computing in bfloat16, against the float32
   run:
   logits within KV_BF16_TOL = 2e-2 (bfloat16 cache and compute) or
   KV_FP8_TOL = 6e-2 (float8 cache) x max |logits|; each measured error
   sets the near-tie bound of phase 6's second report on its narrow
   runs.  On both bfloat16-cache runs one decode step's peak allocation
   must stay under the bytes of a float32 copy of one layer's K and V
   (the path before the kernels read narrow caches, patched in for the
   comparison, makes that copy), and the attention call's device time
   and the step's host time are taken on both paths in turns.  The
   bfloat16-compute model also scores (4, 1024) tokens through
   ``forward``: ``flash_attention`` must launch once a layer with
   bfloat16 operands and never in float32, its logits within
   KV_BF16_TOL x max |logits| of the float32 model's scoring; the two
   losses, the forward's peak allocation and one attention call's peak
   and device time are printed beside the route before the 16-bit form
   (q, K and V cast to float32, the context rounded back; patched in
   for the comparison), in turns, and the 16-bit call must allocate
   less than float32 copies of its q, K and V.
5. The page movers (copy-on-write ``page_copy``, host-tier
   ``page_restore``): parity against their plain versions is EXACT
   (``torch.equal`` on the bit patterns: they are copies), on float32,
   bfloat16 and float8_e4m3fn pools at the main path's pool and at
   edge cases (m = 7, sentinel padding, a source a later pair
   overwrites, zero-slab restore padding, untouched rows bit-identical),
   through the one-leaf contract and through one launch over K and V
   leaves of widths 32 and 56 (the restore's slabs packed in one
   buffer), 90 pairs in groups, a chained copy batch held to the plain
   version's gather-then-scatter, and on both routes the planner picks:
   bulk (TMA) and the byte route at 8, 4, 2 and 1 bytes (rows of 60,
   30, 24, 15 and 12 bytes, pools 2 bytes off 16-byte alignment).
   Timing as in 3 in each of the three dtypes, per batch over
   gpt2-xl's two leaves (the kernel rows) and per leaf (``leaf``
   lines), and the launch with no bytes to move, with two
   ``index_copy_`` calls as the library call (on the narrow pools' bit
   patterns: CUDA's has no float8).
6. The prefix phase at gpt2-xl's full width, pruned 32/32: a paged
   engine with ``prefix_cache=True`` and a 192-page host tier serves a
   256-token system prompt, a warm burst (system prompt + tails), the
   page-aligned system prompt alone (a full hit: copy-on-write), a
   churn burst of 4 unique 400-token prompts that spills the system
   prompt's pages to the host tier, and the warm burst again (restored
   through ``page_restore``).  Every warm stream must equal a cold
   paged engine's (``prefix_cache=False``; each distinct burst served
   once, on the same idle engine) under the near-tie rule, and
   three of them ``greedy_reference``; the allocator and trie stay
   consistent every step; 4 step shapes; both page movers launched in
   this phase and their plain versions never, each once per batch on
   its bulk route.  Host timers around the spill reads, page copies and
   restores (each ended by a synchronize) give their share of the
   phase's wall; each restore batch is also timed in parts (ids,
   launch, the rest), its host side run two ways on the same slabs in
   turns (the executor's one pageable copy per leaf, and every leaf
   packed into one reused page-locked buffer), and every 8th
   spill read's steps are replayed in parts (device gather,
   device->host copy, numpy view).  Then the same trace at 8 new
   tokens a request on two narrow pools, the set-up shared (the
   bursts, the weights, and the float32 model's greedy_reference
   streams): the model cast once to bfloat16 compute (a bfloat16
   pool), and the float32 model with a float8_e4m3fn cache.  Each must
   launch both movers on its pool, hold its bytes wherever they move
   (spill reads as uint16 / uint8 bit patterns; every copy-on-write
   destination equal to its source right after the copy; every restored
   page equal to its slab, itself a spilled page's; the system prompt's
   pages after the restore equal to those before the churn), keep 4
   step shapes and a consistent allocator, and give streams token for
   token equal to a cold paged engine's of the same numerics on the
   same trace (no near-tie allowed); then, as a second report, equal to
   the float32 greedy_reference but at near-ties: a top-2 gap under
   twice the logits error phase 4 measured for its numerics.
7. The rank-budget phase at gpt2-xl's full width (DESIGN.md §14): head
   ``h`` of layer ``i`` damped by 0.25 in ``wq`` and ``wv`` where ``i +
   h`` is odd (random weights have flat spectra; the damping makes them
   differ between heads), ``clover_decompose``, the uniform 0.5/0.5
   ``clover_prune`` (32/32) and ``plan_rank_budget`` at the uniform
   total.  Planned kept energy must be >= uniform's and the plan must
   differ between heads of one layer; ``rank_pool_bytes`` kept and
   allocated at the paged engine's geometry.  The rank-clamped kernels
   ``flash_decode_ranked`` / ``paged_flash_decode_ranked`` are held to
   their plain versions (2e-5) and to the unranked kernels (bitwise, on
   the zero-padded data the plan serves) at the plan's layer-0 ranks,
   and timed there as in 3 (library: SDPA with the length mask on the
   zero-padded cache at full width; none for the pages).  Then
   ``apply_rank_budget`` and the main path's 8 requests on dense and
   paged engines with ``rank_budget=plan``: every stream equal to the
   budgeted model's ``greedy_reference`` (near-tie rule), 2 step shapes,
   the ranked kernels launched and the unranked decode kernels and
   every plain version never.  Then both budget engines again at
   spec_k 2 (draft_rank_ratio 0.5): every stream equal to the
   non-speculative one (near-tie rule), the ranked kernels launched
   with a row stride wider than the draft width (the draft's reads of
   ``cache[..., :r]``).  Ranked parity at edge cases (ragged
   ranks that are not multiples of 8, ranks 0 and full, finite garbage
   past each head's rank, G of 1 and 2, dq != dv, lengths 0 / 1 /
   mid-tile / mid-page, sentinel pages) runs in phase 2.
8. The rwkv6 phase at rwkv6-1.6b's published width and depth (24
   layers, d_model 2048, 32 wkv heads of 64, d_ff 7168, vocab 65536),
   random weights from seed 0: the parameter count, scoring on (4,
   1024) random tokens (a finite loss), ``clover_decompose`` (0
   attention pairs, logits bitwise unchanged), then the main path's 8
   requests on a dense engine (4 slots, ``max_len=512``, chunks of 64:
   full chunks, then a token-at-a-time TAIL; the 16-, 31- and 57-token
   prompts are TAIL only), every stream equal to ``greedy_reference``
   under the near-tie rule, 2 step shapes.  ``wkv6`` must launch in
   every sub-phase and nothing else (no attention kernel, no plain
   version); its launches are also counted by shape (batch, and T = 1,
   2-64 or longer) in each sub-phase.
9. The jamba phase (run right after phase 11, on a card with under
   2 GB allocated): jamba-v0.1-52b at its published width (d_model 4096,
   32 heads over 8 KV heads of 128, dI 8192, 16 experts top-2, vocab
   65536) cut to one 8-layer period (53 GB of float32 weights; the
   whole model does not fit), dropless MoE (``capacity_factor`` 0),
   random weights from seed 0: the parameter count, scoring on (4,
   1024) random tokens, the GQA ``clover_decompose`` (function
   preserved), ``clover_prune`` to 64/64, then the main path's 8
   requests on a dense and a paged engine (48 pages of 16), every
   stream equal to ``greedy_reference`` (a divergence passes only at a
   near-tie of the logits or of the router, top-k margin < 1e-5), 2
   step shapes each.  ``mamba_scan`` must launch in scoring, in each
   engine and in ``greedy_reference``; only it and the attention
   kernels may launch; its launches are counted by shape as wkv6's.
   Memory at start and at peak.
10. Last, two torch.profiler sessions back to back: the budget dense
   engine on the main path's first 4 requests (16 new tokens): device
   busy share, host ms per step kind, the top kernels by device time,
   and the decode kernels' share; then one full fine-tune step of
   gpt2-xl with remat (phase 11's, after a warm-up step): busy share,
   top kernels, GEMM and softmax shares (the rwkv6 engine's session was
   dropped for phase 19's time).  They come last
   because every engine step after a profiler session ran 20-30% slower
   on an H100 (``chip_profiler_effect.py`` measures it).
11. Training at gpt2-xl's full width (run after phases 4-22), random
   weights from seed 0, ``SyntheticLM`` batches of (2, 1024) tokens:
   two full fine-tune steps without remat (outputs dropped: a warm-up
   and the steady step), then four with remat (``torch.utils.checkpoint``
   per layer); each loss and grad norm finite, remat step 1 equal to
   no-remat step 1 (1e-5 relative), step 1 (lr 0) moving no leaf and step
   2 every leaf, the attention under grad the plain one (2 x 48 calls
   per step, ``flash_attention`` never).  ``clover_decompose(peft=True)``
   (logits within 1e-3 max |logits|), 4 CLOVER-S steps (only ``s_qk``,
   ``s_vo``, ``up_t`` move; every other leaf bitwise equal),
   ``merge_clover`` (logits within 1e-3 of the unmerged model,
   ``count_params`` exactly the base's); the merged model decomposed,
   pruned 32/32 and serving the main path's first 4 requests on a dense
   engine, every stream equal to ``greedy_reference`` (near-tie rule),
   only kernels launched; 2 steps each of LoRA, DoRA and PiSSA at r = 16
   (at init LoRA's ``materialize`` is the base bit for bit and PiSSA's
   ``pissa_residual`` + ``materialize`` within 1e-5 relative).  Host and
   device ms per step, training tokens/s and peak memory; the phase
   frees what it allocated.
12. The paper's tables at the reference benchmarks' own scale
   (``benchmarks/common.py``'s tiny GPT-2: 4 layers, d_model 128, 4
   heads of 32, vocab 512, batches (16, 64)), rebuilt here on the port:
   300 pretraining steps on the card, then the procedures of
   ``table1_pruning.py`` (ratios 0.25 / 0.5 / 0.75, recovery fine-tunes
   of 60 and 120 steps, CLOVER-dagger), ``table2_peft.py`` (LoRA / DoRA /
   PiSSA at r = 16, CLOVER-S, full fine-tuning, 80 steps on the seed-99
   domain), ``fig2_spectrum.py`` (the trained row; random-init rows for
   the reference's architectures the port has configs for) and
   ``fig3_trainfree.py``, with their ratios, steps, learning rates and
   data seeds; their rows are printed and every one of their checks
   must hold.  Fig. 2's random-init rows: stablelm-3b and jamba.
   ``fig4_projection.py`` (rank 4, 16 samples of ``batch_at(5000)``
   entering the first attention layer, head 0's ``svd_lowrank_product``
   basis, random directions by QR of a seeded ``torch.Generator``) and
   ``fig56_rank.py`` (LoRA at rank 2 on ``wq``, 60 steps at lr 5e-3 and
   alpha 16; CLOVER-S 60 steps at lr 5e-3 then ``merge_clover``; full
   fine-tuning 60 steps at lr 1e-3; on the seed-99 domain: the rank of
   each ``wq`` update and its intruder dimensions).  Then
   serve_bench scenario 3's gate on the pretrained model pruned 0.5:
   spec_k 4 at draft_rank_ratio 0.5 accepts more than 1 token per round
   on average, its streams equal to the non-speculative engine's.
13. The RoPE phase (right after jamba, on a card with under 2 GB
   allocated), random weights from seed 0: stablelm-3b whole (32
   layers, d_model 2560, 32 heads of 80 with 20 rotated: the "partial"
   CLOVER mode, vocab 50304; 2.80 B parameters) and phi3-medium-14b at
   its 40 layers (the JAX package's config: d_model 5120, 40 heads over
   10 KV heads of 128, full RoPE: "intra" mode, d_ff 17920, vocab
   100352, which is Phi-3-small's; 14.66 B parameters, 58.6 GB).
   Each: the parameter count, ``clover_decompose(peft=True)`` ->
   ``merge_clover`` (phi3 on its first 8 layers: logits within 1e-3 max
   |logits|, the exact parameter count), then (the counts set to 0)
   scoring on (4, 1024) random tokens, ``clover_decompose`` (function
   preserved),
   ``clover_prune`` (stablelm 52/40, phi3 V-O only: 128/64), the main
   path's 8 requests on dense and paged engines, every stream equal to
   ``greedy_reference`` (near-tie rule); ``flash_attention``,
   ``flash_decode`` and ``paged_flash_decode`` launched in their
   sub-phases, no other kernel and no plain version.  stablelm-3b also
   on a dense engine with spec_k 4 (the partial mode's draft, 36/24 of
   52/40, read through the row stride), every stream equal to
   ``greedy_reference``.  Peak memory and wall time per model; the
   phase frees what it allocates.
14. Self-speculative decoding (run after phase 6, on phase 4's pruned
   gpt2-xl): the main path's 8 requests on its dense and paged engines
   at spec_k 2 and 4, draft_rank_ratio 0.5 (draft 16/16 through the
   row stride); every stream equal to the non-speculative engine's and
   ``greedy_reference`` (near-tie rule; near-ties counted), at most 4
   step shapes, ``accept_hist`` printed; tokens/s and ITL of the dense
   engine at k = 0 and 4 in turns (4, 0, 0, 4: the first the dense k = 4
   check run, served last of the checks); draft_rank_ratio 0.0 at
   k = 4, where every slot-round must accept 5 tokens except at a
   near-tie of the verify logits.  The draft must launch
   ``flash_decode`` and ``paged_flash_decode`` with a row stride wider
   than the width, and no plain version may run.
15. Overload safety (after phase 14): serve_bench scenario 6's pinned
   trace (14 requests, two priorities, deadlines, two cancels) and
   ``FaultPlan.chaos(20260807, 0.06)`` at gpt2-xl's full width pruned
   32/32, on a paged engine of 3 slots over 8 pages, fault-free and
   faulted: the allocator consistent every step, every request
   terminal, every surviving stream equal to the uncontended replay
   (near-tie rule), faults at every site the trace reaches, the pool
   free after the drain.
16. Multi-tenant SV adapters (after phase 12; DESIGN.md §13): serve_bench
   scenario 8 at gpt2-xl's full width, random weights from seed 0,
   ``clover_decompose(peft=True)`` unpruned.  The registry: tenant 0
   the identity; tenant 1 ``scales_from_finetuned`` of the
   ``sv_extract`` of 4 CLOVER-S steps (phase 11's trainer and (2, 1024)
   batches) on the model; tenant 2 uniform(0.8, 1.25) scales from
   numpy seed 9.  The trace: 3 waves, 25 steps apart, of one request
   per tenant, a shared 40-token system prompt with tails of 3 + id
   tokens, 6 new tokens; 3 slots, chunks of 8, pages of 8, a 40-page
   pool, max_len 64.  Dense, paged and paged + prefix cache, each at
   spec_k 0 and 2 (draft_rank_ratio 0.5): every stream equal to
   ``greedy_reference`` on its tenant's folded model (tenant 0 on the
   base; near-tie rule), the same trace with every id 0 giving the
   adapter-free engine's streams, step shapes equal to the adapter-free
   engine's on the same trace, per-tenant ``adapter_done`` /
   ``adapter_tokens`` as the trace, under the prefix cache each
   tenant's system prompt cached on pages no other tenant holds and
   every later-wave request a hit; ``flash_decode`` and
   ``paged_flash_decode`` launched (with a row stride on the spec
   runs), no plain version.  ``decode_step`` with an all-ones adapter
   tree: logits bit for bit those without one.  Tokens/s and mean ITL
   of the registry engine against the adapter-free engine in turns
   (registry, plain, plain, registry).  The phase frees what it
   allocates.

17. The MoE phase (after phase 16, with under 2 GB allocated by this
   process), as phase 13 runs its models, dropless (``capacity_factor``
   0): qwen2-moe-a2.7b at its full width cut from 24 to 8 layers
   (d_model 2048, 16 heads of 128, 60 experts of 1408 held as 64,
   top-4, 4 shared, vocab 151,936; scored on (2, 1024) tokens, the peft
   round trip on its first 4 layers), pruned V-O only to 128/64, and
   granite-moe-1b-a400m whole (16 heads over 8 of 64, 32 experts top-8,
   tied embeddings), pruned to 64/32; both "intra" mode.  The
   decompose and merge checks run with the base forward's routing
   replayed (``RoutingPin``): a routing the decomposition's rounding
   would flip must sit at a router near-tie (top-k margin < 1e-5), and
   the logits are then held to 1e-3 max |logits|.  A stream may also
   diverge at a router near-tie; each engine's smallest router margin
   is printed.
18. The frontend phase (after phase 17), as phase 13 runs its models,
   with seeded unit-normal frame / patch embeddings before the tokens:
   musicgen-large whole (48 layers, 32 heads of 64, sinusoidal
   positions: "cross" mode, 250 frames; the peft round trip on its first
   8 layers), pruned 32/32, and internvl2-2b whole (16 heads over 8 of
   128: "intra" at G = 2, 256 patches), pruned V-O to 128/64.  Scoring,
   decompose and prune take the frontend input; ``prefill(...,
   frontend_embeds=fe)`` then 8 ``decode_step``s give each step the
   logits of ``forward`` on the extended sequence (1e-3 max |logits|)
   and its greedy token (near-tie rule), ``flash_decode`` and
   ``flash_attention`` launched; the engines serve text; internvl2 takes
   one CLOVER-S ``make_train_step`` step on a batch with
   ``frontend_embeds`` (loss the text positions' cross entropy within
   1e-4, the plain attention, ``flash_attention`` never).
19. Tensor- and expert-parallel serving (beside phase 4, DESIGN.md §10):
   two ranks spawned on the one card under gloo
   (``launch.serve.serve_tp``), each an engine with a
   ``ShardedExecutor``; NCCL would need one card per rank.
   musicgen-large at full width cut from 48 to 24 layers (heads, ff and
   vocab split at tp = 2; whole, the phase took 154.5 s of a 1218.4 s
   smoke, past the 1200 s limit), head
   ``h`` damped by 0.25 in ``wq`` and ``wv`` where ``h % 4 == 0`` in
   every layer, decomposed, ``plan_rank_budget`` at half the total rank
   and ``apply_rank_budget``; the partition of the plan's head loads
   must not be the identity (printed with its balance and per-shard
   load fractions).  First the per-shard kernel parity (TOL, on the
   engines' geometry: 4 slots, lengths 300/200/150/60, 576 positions or
   49 pages of 16): rows 2-5 at KV = 16, G = 1 at the plan's padded
   widths with each rank's clamps (layer 0's, permuted and split), and
   the draft's strided views ``cache[..., :r]`` of each rank's cache and
   pool through rows 4-5 (also bit for bit the kernel on a contiguous
   copy).  Then, each at tp = 2 (the in-process tp = 1 runs were cut
   for the smoke's time), the budget's engines planning the
   partition themselves: the main path's 8
   requests dense under the budget (row 4); a cut prefix trace under the
   budget (a 128-token system prompt, a warm burst, a full hit:
   copy-on-write, a churn burst of three 400-token prompts: spills, the
   warm burst again: restores; 8 new tokens each) on a 48-page pool with
   a 64-page host tier (rows 5-7); and, on the same weights without
   their rank vectors under the same partition, the main path dense at
   spec_k 2 (row 2, and its draft's strided reads) and paged with a pool
   small enough to preempt (row 3).  granite-moe-1b-a400m whole,
   dropless, pruned V-O to 64/32 (4 KV heads, G = 2, and 16 of 32
   experts per rank; its vocab of 49155 replicates and the logits are
   broadcast): rows 2-3 parity at KV = 4, G = 2, 64/32, then the main
   path dense and paged and the cut prefix trace (rows 2-3, 6-7).  Every rank's streams must equal
   every other's and the one-rank ``greedy_reference`` (near-tie rule;
   the router's on granite), shapes the run kind's (2; 4 with the COW
   and restore; 3-4 with speculation), the prefix run hit, spill and
   restore, each run's kernels launch on every rank and no plain version
   run, on the ranks or in this process.  Per rank: tokens/s, mean ITL,
   all-reduce count and host time inside collectives per step,
   broadcasts, peak memory, launches.
20. Training at scale (after phase 19; ``launch.train``), gpt2-xl at its
   full width cut from 48 to 4 layers (204,958,400 float32 parameters,
   2.46 GB with both moments), (2, 1024) ``SyntheticLM`` batches, seed
   0, checkpoints in a temporary directory deleted at the end.  (a) One
   rank through the launcher's path (``train``: the supervisor, async
   checkpoints every 3 steps) for 6 steps, clean and with a
   ``WorkerFailure`` injected at step 4 (rolled back to step 3 and
   replayed), under ``torch.use_deterministic_algorithms``: the final
   params must equal the clean run's bit for bit (else within 1e-6 of
   the largest parameter, the bound printed).  (b) Two ranks under gloo
   on the one card, one spawn (``launch.train.train_ranks``): (data 2,
   model 1) data parallel + FSDP with a checkpoint at its end, (1, 2)
   tensor parallel (gpt2-xl's 25 heads replicate: its MLP and logits
   split), (pod 2, data 1, model 1) with ``grad_compress``, and
   musicgen-large at its full width cut from 48 to 4 layers at (1, 2)
   (32 heads, ff and vocab split: the attention backward runs split), 3
   steps each, every step's loss and grad_norm within 1e-4 of a one-rank
   run on the same data ((a)'s first steps; musicgen's own), the pod
   run's within 1/127 (one int8 step) of a one-rank run with
   ``grad_compress`` on a (1, 1, 1) pod mesh and of (a)'s; and
   ``pipeline_apply`` over two gpt2-xl-width layers (4 microbatches of
   (1, 256)) within 1e-5 x max(1, max |ref|) of their sequential
   composition.  Per rank: step ms, resident and peak GB, collectives by
   kind and the host ms inside them.  (c) The data-parallel run's checkpoint restored onto one rank
   bit for bit the ranks' gathered params, then 4 requests x 16 tokens
   through the dense ``Engine``: streams equal to ``greedy_reference``,
   ``flash_decode`` launched, no plain version.

21. Serving under training's rules and over data replicas (after phase
   20): two ranks under gloo on the one card.  ``make_serve_step``
   (``launch.serve.serve_step_ranks``) on gpt2-xl at its full width cut
   from 48 to 4 layers at (data 2, model 1) -- FSDP weights gathered per
   layer every step through gloo's host staging, which at full depth
   (6.2 GB a step) does not fit the smoke's time -- 8 prompts of 960
   tokens (the flash kernel over the live window) then 32 greedy
   tokens, every rank's streams equal to
   ``greedy_reference`` (near-tie rule); the same batch of 960 in
   bfloat16 compute (float32 weights), its logits within KV_BF16_TOL x
   max |logits| of the float32 run's while the two runs' tokens agree,
   its prefill through the window form (``window_attention`` launched on
   every rank, no float32 ``flash_attention``: the kernels line's
   launches for the window form are this run's, summed over the ranks);
   musicgen-large whole at (1, 2): 32 heads split, the 256-position
   cache split along its sequence (windows of 128), a prefill of 200
   then a second of 24 at index 200, 32 greedy tokens, streams equal to
   ``greedy_reference`` of the whole prompts; ``flash_attention``,
   ``flash_decode`` and ``flash_decode(return_lse=True)`` launched on
   both ranks.  Then ``ShardedExecutor`` at (data 2) on gpt2-xl whole
   (``serve_tp(..., data=2)``): the main path's 8 requests dense, and
   paged with the prefix cache on a 128-token system prompt whose pages
   replica 0 writes and replica 1's slot hits, then a full hit
   (copy-on-write): streams equal to ``greedy_reference``, 2 / 3 step
   shapes, ``flash_decode`` / ``paged_flash_decode`` launched on both
   ranks, no plain version.  Per rank: tokens/s, the mean decode step or
   ITL, collectives and the host ms inside them, resident and peak GB.
   ``flash_decode``'s lse output is held to its plain version with the
   other kernels (phase 2; ``phase_lse``): the lse within LSE_TOL x
   max(1, |lse|), the context bit for bit the call without it, length 0
   giving -inf and a zero row, two windows merged equal to one call;
   timed beside the plain version and the call without the lse.
22. The production dry-run's prediction of phase 21's gpt2-xl (data 2)
   decode (``launch.dryrun.trace_cell`` at its exact shape on a fake
   2-rank group, CPU only, seconds): each rank's predicted params +
   state bytes must equal its resident bytes, the predicted peak is
   printed beside ``max_memory_allocated``, and the measured decode step
   must be at least the predicted roofline bound (its share printed).
   The sweep over every production cell needs no card and is not run
   here: ``python -m repro_torch.launch.dryrun --all [--multi-pod]`` on
   any CPU (PERF.md has its table).

The second-to-last line is one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent

TOL = 2e-5              # parity: max abs error, float32, unit-scale inputs
# wkv6 parity: max abs error <= WKV_TOL * max(1, max |want|).  The state
# sums T rank-1 updates (with decay ~ 1 at the clip edge it grows ~T-fold),
# so the error scales with the output, not with unit inputs.
WKV_TOL = 2e-5
# mamba_scan parity: max abs error <= MAMBA_TOL * max(1, max |want|); the
# state sums S decayed updates (with dt ~ 0 it keeps all of them), so the
# error scales with the output
MAMBA_TOL = 2e-5
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float32-accurate products on the tensor cores: three TF32 passes at the
# dense TF32 rate of 495 TFLOP/s
TF32X3_FLOPS = 495e12 / 3
# exponentials per second: 16 special-function results per SM per clock
# (compute capability 9.0), 132 SMs, at the 1.98 GHz the FP32 peak assumes
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# dense bfloat16 / float16 tensor-core rate (H100 SXM data sheet)
BF16_FLOPS = 989e12
# a jamba stream may diverge from greedy_reference where the reference's
# MoE router had two experts within this probability of the top-k cut
ROUTER_TIE = 1e-5
# a bfloat16 KV cache against a float32 one: K/V each rounded to 8
# mantissa bits (relative error <= 2^-9) perturb every attention layer's
# scores and outputs by ~2^-9 of their scale; through the model's layers
# the logits move by well under 2% of their largest magnitude
KV_BF16_TOL = 2e-2
# the same bound for a float8_e4m3fn KV cache: kv_dtype_decode measured
# 2.837e-2 x max |logits| at gpt2-xl's full width on an H100 (4
# significant bits against bfloat16's 8: 15.8 times its 1.792e-3); the
# bound is that error with a margin of about 2
KV_FP8_TOL = 6e-2
# the narrow-pool prefix runs (bfloat16 compute; a float8 cache) serve
# NARROW_NEW tokens a request and hold their streams to the float32
# model's greedy_reference.  kv_dtype_decode measures each one's logits
# error e (max |dlogits| / max |logits| against float32); two logits
# each moved by at most e swap only where the reference's top-2 gap is
# under 2 e max |logit|: the near-tie bound of that run's streams
NARROW_NEW = 8
LSE_TOL = 2e-5          # flash_decode's lse, x max(1, |lse|)
# the decode kernels' parity cases also run at these (compute dtype,
# cache dtype) pairs.  At 16-bit compute a kernel computes the TPU
# kernels' function (p rounded per block of positions) and is held to its
# plain version: at least DTYPE_SHARE of the outputs bit for bit, and
# every output within one ulp of the compute dtype at its row's largest
# |output| (a p rounded the other way moves a near-zero output by many
# of its own ulps, never by more than the row's).  At float32 compute
# over a narrow cache it is held bit for bit to itself on cache.float()
# (the path before the kernels read narrow caches).
DTYPE_PAIRS = (("bfloat16", "bfloat16"), ("bfloat16", "float32"),
               ("bfloat16", "float8_e4m3fn"), ("float16", "float16"),
               ("float32", "bfloat16"), ("float32", "float8_e4m3fn"))
DTYPE_SHARE = 0.99
# flash_attention's parity cases (B, S, T, H, KV, dq, dv[, gain]) that
# also run in bfloat16 and float16 against ref.flash_attention_ref
FLASH16_CASES = (
    (4, 1024, 1024, 25, 25, 32, 32),    # gpt2-xl scoring
    (2, 100, 100, 4, 2, 20, 12),        # widths not 8-multiples
    (2, 50, 50, 3, 1, 7, 5),            # odd widths, G = 3
    (1, 200, 200, 16, 1, 32, 32),       # G = 16
    (2, 1, 1024, 25, 25, 32, 32),       # one query over 1024 keys
    (2, 256, 256, 4, 4, 32, 32, 8.0),   # inputs x 8
    (1, 70, 70, 2, 2, 256, 256),        # widest heads
    (4, 1024, 1024, 32, 8, 128, 128),   # jamba scoring, G = 4
    (4, 1024, 1024, 40, 10, 128, 64),   # phi3 pruned scoring
    (4, 1280, 1280, 16, 8, 128, 128),   # internvl2 scoring, G = 2
    (1, 432, 432, 25, 25, 32, 32),      # T = 432: 3 blocks and a part
    (4, 1274, 1274, 32, 32, 64, 64),    # musicgen scoring, T = 1274
    (2, 37, 100, 4, 2, 64, 48),         # S < T
    (2, 100, 256, 8, 2, 64, 64),        # S < T over two whole blocks
    # the packed row tiles (128 (position, head) rows a block): G = 5 and
    # G = 7, whose head groups end in a ragged tile; S G not a multiple
    # of the tile with S < T
    (2, 60, 60, 10, 2, 64, 64),         # G = 5: 300 rows, 3 tiles
    (1, 40, 40, 14, 2, 128, 64),        # G = 7: 280 rows, 3 tiles
    (1, 150, 300, 4, 4, 32, 32),        # 150 rows over 300 keys
    (2, 45, 200, 8, 4, 64, 64))         # G = 2: 90 rows over 200 keys
# the window form's parity cases (B, S, T, H, KV, dq, dv, scale_first[,
# gain]), each in bfloat16 and float16 against ref.window_attention_ref
# (scale_first None: both scale orders)
WINDOW_CASES = (
    (4, 960, 960, 25, 25, 64, 64, None),   # phase 21's gpt2-xl window
    (1, 520, 1120, 25, 25, 64, 64, False),  # a second prefill at 600
    (4, 200, 200, 32, 32, 64, 64, True),   # musicgen's sequence split
    (1, 300, 300, 40, 10, 128, 64, None),  # phi3, G = 4
    (2, 100, 100, 6, 2, 20, 12, None),     # widths 20 / 12, G = 3
    (2, 50, 50, 6, 2, 7, 5, None),         # widths 7 / 5, G = 3
    (2, 100, 300, 4, 2, 32, 32, None),     # T not a multiple of 64
    (2, 256, 256, 4, 4, 32, 32, None, 8.0),  # inputs x 8
    # the packed row tiles: G = 5 and 7 (ragged last tiles), a short
    # window over a long cache, 256-wide heads
    (2, 60, 100, 10, 2, 64, 32, None),     # G = 5, S < T
    (1, 40, 40, 14, 2, 128, 64, False),    # G = 7
    (1, 64, 2048, 8, 2, 64, 64, None),     # 64 queries over 2048 keys
    (1, 70, 100, 4, 2, 256, 192, True))    # D = 256


def window_forms(first, scale):
    """The window form's (label, keyword arguments) at a WINDOW_CASES
    scale order (None: both)."""
    return tuple((" masked" if sf else " chunked",
                  {"scale": scale, "scale_first": sf})
                 for sf in ((False, True) if first is None else (first,)))
SEED = 0
# serve_bench scenario 6's pinned overload trace and fault plan
# (benchmarks/serve_bench.py): 14 requests of 4-12 prompt tokens drawn
# over its 512-token vocab, 3 slots over an 8-page pool
CHAOS_SEED = 20260807
CHAOS_REQUESTS = 14
CHAOS_POOL_PAGES = 8
CHAOS_INTENSITY = 0.06
CHAOS_MAX_STEPS = 3000
CHAOS_VOCAB = 512
# serve_bench scenario 8's multi-tenant trace (benchmarks/serve_bench.py):
# the identity and two fine-tuned tenants, three waves of one request
# per tenant sharing a page-aligned system prompt
ADAPTER_SEED = 9
ADAPTER_WAVES = 3
ADAPTER_WAVE_GAP = 25
ADAPTER_MAX_NEW = 6
ADAPTER_POOL_PAGES = 40
ADAPTER_SYS_TOKENS = 40
ADAPTER_CHUNK = 8
ADAPTER_PAGE_TOKENS = 8
ADAPTER_MAX_LEN = 64
DRAFT_RATIO = 0.5
# the main path's engines: dense, then paged with a pool small enough to
# preempt
MAIN_ENGINES = (
    ("dense", dict(slots=4, max_len=512, prefill_chunk=64)),
    ("paged", dict(slots=4, max_len=512, prefill_chunk=64, paged=True,
                   page_tokens=16, n_pages=48)))
# the phases whose runs are ranks spawned under gloo on the one card
# (19-22, in their order: the dry-run reads phase 21's runs).  Their wall
# is the ranks' host-side collectives, so a second process of this script
# runs them beside phases 4, 12, 16, 17 and 18, whose models leave the
# card room for theirs; the phases that need a nearly empty card (11, 9,
# 13) and the measured tail (7, 8, 10) start after it has exited.
BESIDE = ("phase_tp", "phase_train_dist", "phase_serve_step",
          "phase_dryrun")


def main(argv) -> int:
    only = beside = None
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = argv[1].split(",")
    elif argv[:1] == ["--beside"] and len(argv) == 3:
        beside = argv[1].split(","), Path(argv[2])
    elif argv:
        print("usage: chip_smoke.py [--only phase_a,phase_b]",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smoke = Smoke(torch)
    if beside:
        return smoke.run_beside(*beside)
    if only:
        # a partial run (the card phase, then the named phases): no result
        smoke.timed(smoke.phase_card)
        for name in only:
            smoke.timed(getattr(smoke, name))
        smoke.print_times()
        if smoke.failures:
            print("FAILED:\n  " + "\n  ".join(smoke.failures))
        return 1 if smoke.failures else 0
    smoke.run()
    if smoke.failures:
        print("FAILED:\n  " + "\n  ".join(smoke.failures))
        return 1
    print(json.dumps({"kernels": smoke.kernel_rows()}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.failures: list = []
        self.err = {}        # kernel -> max abs err over parity cases
        self.times = {}      # kernel -> (ms, plain_ms, library_ms, bound)
        self.launches = {}
        self.jamba_steps = {}    # engine -> {"chunk": n, "decode": n}
        # greedy_reference streams by (weights_key, prompt bytes)
        self.refs = {}
        # kv_dtype_decode's logits errors by run, x max |logits|
        self.kv_err = {}
        # decode kernel -> max abs err over the 16-bit parity cases
        self.err16 = {}

    # -- helpers -------------------------------------------------------
    def fail(self, msg: str):
        print(f"FAIL: {msg}")
        self.failures.append(msg)

    def randn(self, *shape, gen):
        return self.torch.randn(shape, generator=gen, device=self.dev)

    def parity(self, kernel: str, case: str, got, want, tol=TOL):
        torch = self.torch
        torch.cuda.synchronize()
        err = (got - want).abs().max().item() if got.numel() else 0.0
        ok = bool(torch.isfinite(got).all()) and err <= tol
        print(f"parity {kernel:18s} {case:44s} max_abs_err={err:.3e} "
              f"tol={tol:.1e} {'ok' if ok else 'FAIL'}")
        self.err[kernel] = max(self.err.get(kernel, 0.0), err)
        if not ok:
            self.fail(f"{kernel} {case}: max_abs_err {err:.3e} > {tol:.1e}")

    def time_ms(self, fns, iters: int = 20) -> float:
        """Mean device ms per call, cycling through ``fns`` (one per
        input copy).  A spin kernel holds the stream while the host
        queues every launch, so the events time the device's work and
        not the host's launch rate (a 6 us kernel launched from Python
        would otherwise read as the ~20 us between launches); the spin
        doubles until it outlasts the queueing."""
        torch = self.torch
        for f in fns:
            f()
        torch.cuda.synchronize()
        n = max(iters, len(fns))
        cycles = 1 << 22
        while True:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            e0.record()
            for i in range(n):
                fns[i % len(fns)]()
            e1.record()
            held = not e0.query()   # spin still running: all launches queued
            torch.cuda.synchronize()
            if held:
                return e0.elapsed_time(e1) / n
            if cycles >= 1 << 32:
                raise RuntimeError("time_ms: the host could not queue the "
                                   "launches within a 4e9-cycle spin")
            cycles *= 4

    def time_unheld_ms(self, fns, iters: int = 3) -> float:
        """Mean ms per call between CUDA events with no spin: for plain
        versions that launch more kernels per call than the launch queue
        holds (the wkv6 recurrence launches several per time step), so
        the host's launch rate is part of what they cost."""
        torch = self.torch
        for f in fns:
            f()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(iters):
            fns[i % len(fns)]()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    def timed(self, fn, *args):
        """Run one phase and print its wall time."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    @staticmethod
    def copies(bytes_per_set: int) -> int:
        """Input copies to rotate through so a launch finds its inputs
        outside the 50 MB L2."""
        return max(2, min(16, math.ceil(128e6 / max(1, bytes_per_set))))

    @staticmethod
    def counted():
        """(function, counter attribute) of each kernel wrapper (launch
        counts) and each plain version (call counts), by name."""
        from repro_torch.kernels import ref
        from repro_torch.kernels.clover_attention import (flash_attention,
                                                          window_attention)
        from repro_torch.kernels.decode_attention import (
            flash_decode, flash_decode_ranked)
        from repro_torch.kernels.mamba_scan import mamba_scan
        from repro_torch.kernels.page_copy import page_copy, page_restore
        from repro_torch.kernels.paged_decode_attention import (
            paged_flash_decode, paged_flash_decode_ranked)
        from repro_torch.kernels.wkv6 import wkv6
        out = {f.__name__: (f, "launches") for f in
               (flash_attention, flash_decode, paged_flash_decode,
                page_copy, page_restore, flash_decode_ranked,
                paged_flash_decode_ranked, mamba_scan, wkv6,
                window_attention)}
        out.update({f.__name__: (f, "calls") for f in
                    (ref.attention_ref, ref.flash_attention_ref,
                     ref.window_attention_ref, ref.decode_attention_ref,
                     ref.paged_decode_attention_ref, ref.page_copy_ref,
                     ref.page_restore_ref, ref.page_copy_leaves_ref,
                     ref.page_restore_leaves_ref, ref.mamba_scan_ref,
                     ref.wkv6_ref)})
        return out

    def counts(self):
        return {name: getattr(f, attr)
                for name, (f, attr) in self.counted().items()}

    def reset_counts(self):
        for f, attr in self.counted().values():
            setattr(f, attr, 0)
            for route in getattr(f, "routes", ()):
                f.routes[route] = 0
            for form in getattr(f, "forms", ()):
                f.forms[form] = 0

    @staticmethod
    def mover_routes():
        """{"page_copy.bulk": launches, ...}: the page movers' launches
        by route."""
        from repro_torch.kernels.page_copy import page_copy, page_restore
        return {f"{f.__name__}.{r}": n for f in (page_copy, page_restore)
                for r, n in f.routes.items()}

    def shape_census(self, census):
        """Count the scan kernels' launches by shape bucket in ``census``
        (a Counter of (kernel, "B<b> T1" / "T2-64" / "T65+"; S for
        mamba_scan)) while the returned context is open: the dispatch in
        ``kernels.ops`` is wrapped, the kernels' own launch counts are
        untouched."""
        import contextlib
        from repro_torch.kernels import ops

        def bucket(B, n, axis):
            return f"B{B} {axis}" + ("1" if n == 1 else "2-64" if n <= 64
                                     else "65+")

        def wkv6(r, *args, _f=ops._wkv6):
            census[("wkv6", bucket(r.shape[0], r.shape[2], "T"))] += 1
            return _f(r, *args)

        def mamba_scan(dt, *args, _f=ops._mamba_scan):
            census[("mamba_scan", bucket(dt.shape[0], dt.shape[1],
                                         "S"))] += 1
            return _f(dt, *args)

        @contextlib.contextmanager
        def patched():
            saved = ops._wkv6, ops._mamba_scan
            ops._wkv6, ops._mamba_scan = wkv6, mamba_scan
            try:
                yield
            finally:
                ops._wkv6, ops._mamba_scan = saved
        return patched()

    @staticmethod
    def print_census(name, before, after):
        grew = {f"{k} {b}": after[(k, b)] - before.get((k, b), 0)
                for k, b in sorted(after)
                if after[(k, b)] != before.get((k, b), 0)}
        print(f"phase {name}: launches by shape {grew}")

    # -- phases --------------------------------------------------------
    def run(self):
        self.timed(self.phase_card)
        self.timed(self.phase_parity)
        self.timed(self.phase_ranked_parity)
        self.timed(self.phase_strided_parity)
        self.timed(self.phase_page_parity)
        self.timed(self.phase_wkv6_parity)
        self.timed(self.phase_mamba_parity)
        self.timed(self.phase_lse)
        if self.failures:
            return
        self.timed(self.phase_timing)
        self.timed(self.phase_page_timing)
        self.timed(self.phase_wkv6_timing)
        self.timed(self.phase_mamba_timing)
        self.print_times()
        # the spawned-rank phases (BESIDE) in a second process; each
        # phase here frees all it holds
        with self.beside_process(BESIDE):
            self.timed(self.phase_main_path)
            self.timed(self.phase_tables)
            self.timed(self.phase_adapters)
            self.timed(self.phase_moe)
            self.timed(self.phase_frontend)
        # training peaks at 60 GB: the card is this process's alone again
        self.timed(self.phase_train)
        # jamba needs a nearly empty card (one period is 53 GB): it runs
        # before the budget and rwkv6 phases, whose models the profile
        # phase keeps
        self.timed(self.phase_jamba)
        # the RoPE models need a nearly empty card too (phi3-medium-14b
        # peaks at 70 GB)
        self.timed(self.phase_rope)
        models = {"budget": self.timed(self.phase_budget)}
        self.timed(self.phase_rwkv)
        # last: after a torch.profiler session every later engine step of
        # the process ran slower (chip_profiler_effect.py), so no
        # measured phase may follow it
        self.timed(self.phase_profile, models)

    @contextlib.contextmanager
    def beside_process(self, phases):
        """Run ``phases`` in a second process of this script
        (``--beside``, in a session of its own) while the block runs
        here; then wait for it, print its output (its phases' lines and
        times) and take its failures and parity errors as this run's.  Its
        kernel launches stay in its own counts, as a spawned rank's do.
        If the block raises, the process and all it spawned are killed."""
        import os
        import signal
        import tempfile
        torch = self.torch
        with tempfile.TemporaryDirectory() as tmp:
            log, state = Path(tmp) / "beside.txt", Path(tmp) / "state.json"
            t0 = time.perf_counter()
            with open(log, "w") as out:
                child = subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--beside",
                     ",".join(phases), str(state)], stdout=out,
                    stderr=subprocess.STDOUT, cwd=ROOT,
                    start_new_session=True)
            # the ranks' gloo collectives run on the host's cores: this
            # process, which only drives the card, keeps one for torch
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                yield
                here = time.perf_counter() - t0
                rc = child.wait()
            finally:
                torch.set_num_threads(threads)
                if child.poll() is None:
                    os.killpg(child.pid, signal.SIGKILL)
                    child.wait()
            print(f"beside ({', '.join(phases)}): exit {rc} after "
                  f"{time.perf_counter() - t0:.1f} s of wall; the phases "
                  f"here took {here:.1f} s, peak "
                  f"{torch.cuda.max_memory_reserved() / 1e9:.1f} GB "
                  "reserved by this process; its output:")
            print(log.read_text(), end="", flush=True)
            if rc != 0 or not state.exists():
                self.fail(f"the process running {', '.join(phases)} exited "
                          f"{rc}")
                return
            got = json.loads(state.read_text())
        self.failures += got["failures"]
        # the window form's main path is phase 21's bf16 run
        if "window_attention" in got["launches"]:
            self.launches["window_attention"] = \
                got["launches"]["window_attention"]
        for mine, theirs in ((self.err, got["err"]),
                             (self.err16, got["err16"])):
            for k, v in theirs.items():
                mine[k] = max(mine.get(k, 0.0), v)

    def run_beside(self, phases, state):
        """``--beside``: the card's line, the library the first process
        built, then ``phases`` in order; their failures and parity errors
        to ``state`` (JSON).  -> exit code.  If the first process dies,
        this one kills itself and all it spawned (its session)."""
        import os
        import signal
        import threading
        parent = os.getppid()

        def orphaned():
            while os.getppid() == parent:
                time.sleep(1.0)
            os.killpg(0, signal.SIGKILL)
        threading.Thread(target=orphaned, daemon=True).start()
        self.card = self.card_line()
        from repro_torch.kernels import _build
        _build.lib()
        for name in phases:
            self.timed(getattr(self, name))
        print("beside: peak "
              f"{self.torch.cuda.max_memory_reserved() / 1e9:.1f} GB "
              "reserved by this process")
        state.write_text(json.dumps({"failures": self.failures,
                                     "err": self.err, "err16": self.err16,
                                     "launches": self.launches}))
        return 0

    @staticmethod
    def card_line():
        """The card's name and power limit: nvidia-smi's own line."""
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return smi.stdout.strip().splitlines()[0] if smi.stdout else \
            "nvidia-smi unavailable"

    def phase_card(self):
        torch = self.torch
        self.card = self.card_line()
        print(self.card)            # name, power limit: nvidia-smi's own line
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}")
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        path = _build.build()
        _build.lib()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s -> "
              f"{path.relative_to(ROOT)}")
        # registers and spills of every kernel instance (ptxas -v)
        for name, regs, st, ld in _build.ptxas_report():
            print(f"ptxas {name:36s} {regs:3d} registers, spill stores "
                  f"{st} bytes, spill loads {ld} bytes")
        self.sass_census(_build)

    def sass_census(self, _build):
        """Per instance of the two scan kernels, from ``cuobjdump -sass``
        of the built library: instructions, MUFU.EX2 (the special-function
        exponential) and the FFMA.RM / FFMA.SAT of expf's range reduction.
        Only the scan kernels are dumped (named from the build's ptxas
        log: the library holds ~100 decode instances besides), or
        everything where that selection fails."""
        tool = Path(_build._nvcc()).with_name("cuobjdump")
        lib = _build.build()
        scans = sorted(set(re.findall(
            r"Compiling entry function '(\w*(?:wkv6_kernel|mamba_scan)\w*)'",
            lib.with_suffix(".ptxas.txt").read_text())))
        out = subprocess.run([str(tool), "-sass", "-fun", ",".join(scans),
                              str(lib)], capture_output=True, text=True,
                             timeout=300)
        if out.returncode != 0 or "Function :" not in out.stdout:
            out = subprocess.run([str(tool), "-sass", str(lib)],
                                 capture_output=True, text=True, timeout=300)
        funcs, name = {}, None
        for line in out.stdout.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                funcs[name] = []
            elif name and "/*" in line and ";" in line:
                funcs[name].append(line.split("*/", 1)[-1].strip())
        names = [n for n in funcs if "wkv6_kernel" in n or "mamba_scan" in n]
        for n, pretty in zip(names, _build._demangle(names)):
            ops = funcs[n]
            count = {k: sum(k in op for op in ops)
                     for k in ("MUFU.EX2", "FFMA.RM", "FFMA.SAT")}
            print(f"sass {pretty:36s} {len(ops)} instructions, "
                  + ", ".join(f"{v} {k}" for k, v in count.items()))
        if not names:
            self.fail(f"cuobjdump found no scan kernel ({out.returncode}: "
                      f"{out.stderr.strip()[:200]})")

    # ---- phase 2 -----------------------------------------------------
    def phase_parity(self):
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.clover_attention import (flash_attention,
                                                          window_attention)
        from repro_torch.kernels.decode_attention import flash_decode
        from repro_torch.kernels.paged_decode_attention import \
            paged_flash_decode
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED)
        scale = 1.0 / math.sqrt(64)

        # flash attention: (B, S, T, H, KV, dq, dv); inputs scaled by 8
        # (large logits: the 3xTF32 products must keep float32 accuracy)
        # are held to TOL * max(1, max |want|)
        for B, S, T, H, KV, dq, dv, *gain in [
                (4, 1024, 1024, 25, 25, 32, 32),   # main path, scoring
                (2, 100, 100, 4, 2, 20, 12),       # widths not 8-multiples
                (2, 50, 50, 3, 1, 7, 5),           # nor 4-multiples, G=3
                (2, 1, 1024, 25, 25, 32, 32),      # one query, 1024 keys
                (1, 200, 200, 16, 1, 32, 32),      # G=16
                (2, 256, 256, 4, 4, 32, 32, 8.0),  # inputs x 8
                (1, 130, 200, 8, 2, 64, 64, 8.0),  # inputs x 8, S < T
                (1, 432, 432, 25, 25, 32, 32),     # greedy_reference
                (2, 300, 300, 25, 25, 64, 64),     # before pruning
                (2, 100, 100, 4, 2, 32, 24),       # G=2, dq != dv
                (2, 37, 100, 4, 2, 64, 48),        # S < T
                (3, 1, 5, 2, 1, 16, 8),            # one query, G=2
                (1, 70, 70, 2, 2, 256, 256),       # widest heads
                (4, 1024, 1024, 32, 8, 128, 128),  # jamba scoring, G=4
                (4, 1024, 1024, 32, 8, 64, 64),    # jamba pruned 64/64
                (1, 432, 432, 32, 8, 64, 64),      # jamba greedy_reference
                (2, 37, 100, 32, 8, 128, 64),      # G=4, S < T, dq != dv
                # the RoPE configs' shapes (q and k arrive rotated)
                (1, 256, 256, 56, 8, 128, 128),    # deepseek's group, G=7
                (1, 256, 256, 24, 8, 128, 128),    # minitron's group, G=3
                (4, 1024, 1024, 32, 32, 80, 80),   # stablelm scoring
                (4, 1024, 1024, 32, 32, 52, 40),   # pruned 20 + 32 / 40
                (2, 300, 300, 32, 32, 80, 80),     # stablelm unpruned
                (2, 300, 300, 32, 32, 52, 40),     # stablelm 20 + 32 / 40
                (1, 432, 432, 32, 32, 52, 40),     # its greedy_reference
                (4, 1024, 1024, 40, 10, 128, 128),  # phi3 scoring, G=4
                (4, 1024, 1024, 40, 10, 128, 64),  # phi3 pruned scoring
                (1, 432, 432, 40, 10, 128, 64),    # its greedy_reference
                (1, 300, 300, 40, 10, 128, 128),   # phi3 decomposed, G=4
                (1, 300, 300, 40, 10, 128, 64),    # phi3 pruned V-O
                (2, 37, 100, 40, 10, 128, 64),     # phi3, S < T
                # the MoE and frontend configs: granite G = 2 at 64,
                # internvl2 G = 2 at 128 over 256 patches + 1024 tokens,
                # qwen2 G = 1 at 128 / pruned 64, musicgen G = 1 at 64
                # over 250 frames + 1024 tokens, pruned 32 / 32
                (4, 1024, 1024, 16, 8, 64, 64),    # granite scoring
                (4, 1024, 1024, 16, 8, 64, 32),    # granite pruned
                (1, 432, 432, 16, 8, 64, 32),      # its greedy_reference
                (4, 1280, 1280, 16, 8, 128, 128),  # internvl2 scoring
                (4, 1280, 1280, 16, 8, 128, 64),   # internvl2 pruned
                (1, 432, 432, 16, 8, 128, 64),     # its greedy_reference
                (2, 1024, 1024, 16, 16, 128, 128),  # qwen2 scoring
                (2, 1024, 1024, 16, 16, 128, 64),  # qwen2 pruned V-O
                (1, 432, 432, 16, 16, 128, 64),    # its greedy_reference
                (4, 1274, 1274, 32, 32, 64, 64),   # musicgen scoring
                (4, 1274, 1274, 32, 32, 32, 32),   # musicgen pruned
                (2, 37, 100, 16, 8, 64, 32)]:      # G = 2, S < T
            g = gain[0] if gain else 1.0
            q = g * self.randn(B, S, H, dq, gen=gen)
            k = g * self.randn(B, T, KV, dq, gen=gen)
            v = g * self.randn(B, T, KV, dv, gen=gen)
            want = ref.attention_ref(q, k, v, scale=scale)
            tol = TOL * max(1.0, want.abs().max().item()) if gain else TOL
            got = flash_attention(q, k, v, scale=scale)
            self.parity("flash_attention",
                        f"B{B} S{S} T{T} H{H} KV{KV} dq{dq} dv{dv}"
                        + (f" x{g:g}" if gain else ""), got, want, tol=tol)
            if gain:
                # large logits: how far each side is from float64
                exact = ref.attention_ref(q.double(), k.double(),
                                          v.double(), scale=scale)
                print(f"  x{g:g} against float64: kernel "
                      f"{(got - exact).abs().max().item():.3e}, plain "
                      f"version {(want - exact).abs().max().item():.3e}")

        self.parity16("flash_attention", flash_attention,
                      ref.flash_attention_ref,
                      [(c[:7], c[7] if len(c) > 7 else 1.0,
                        (("", {"scale": scale}),))
                       for c in FLASH16_CASES], gen)
        self.parity16("window_attention", window_attention,
                      ref.window_attention_ref,
                      [(c[:7], c[8] if len(c) > 8 else 1.0,
                        window_forms(c[7], 1.0 / math.sqrt(c[5])))
                       for c in WINDOW_CASES], gen)
        self.window_views(gen)

        # decode lengths at the planner's split boundaries (from the
        # card's SM count) and at page boundaries
        from repro_torch.kernels._build import sm_count
        from repro_torch.kernels.decode_attention import plan_splits
        sms = sm_count(self.dev.index or 0)
        span = plan_splits(576, 100, sms)[1]
        span16 = plan_splits(200, 4, sms)[1]
        pspan = plan_splits(36 * 16, 100, sms, 16)[1]
        pspan16 = plan_splits(25 * 8, 4, sms, 8)[1]
        print(f"decode splits on {sms} SMs: 576 positions x 100 rows -> "
              f"span {span}; 200 x 4 -> {span16}; 36 pages of 16 x 100 -> "
              f"{pspan}; 25 pages of 8 x 4 -> {pspan16}")

        # dense decode: (B, T, H, KV, dq, dv, lengths)
        for B, T, H, KV, dq, dv, lens in [
                (4, 576, 25, 25, 32, 32, [300, 200, 150, 60]),   # main
                (6, 100, 4, 2, 32, 24, [0, 1, 31, 33, 64, 100]),
                (3, 100, 2, 2, 32, 32, [0, 7, 99]),
                (2, 80, 8, 2, 256, 256, [80, 45]),
                # jamba's attention layer, G=4: decomposed and pruned
                (4, 576, 32, 8, 128, 128, [300, 200, 150, 60]),
                (4, 576, 32, 8, 64, 64, [0, 1, 37, 300]),
                # split boundaries, length 1, full capacity; G=16
                (4, 576, 25, 25, 32, 32, [1, span, 2 * span + 1, 576]),
                (4, 200, 16, 1, 32, 32, [0, span16, span16 + 1, 200]),
                # the RoPE configs: G = 7 and 3 at 128, stablelm
                # unpruned and pruned (20 + 32 / 40), phi3 (G = 4)
                (4, 576, 56, 8, 128, 128, [300, 200, 150, 60]),
                (4, 576, 24, 8, 128, 128, [0, 1, 37, 300]),
                (4, 576, 32, 32, 80, 80, [300, 200, 150, 60]),
                (4, 576, 32, 32, 52, 40, [0, 1, 37, 300]),
                (4, 576, 40, 10, 128, 128, [300, 200, 150, 60]),
                (4, 576, 40, 10, 128, 64, [1, 37, 300, 576]),
                # phase 16: unpruned gpt2-xl, 3 slots of 64 positions
                (3, 64, 25, 25, 64, 64, [1, 37, 64]),
                (3, 64, 25, 25, 64, 64, [8, 40, 63]),
                # the MoE and frontend configs as served: granite G = 2
                # 64/64 and 64/32, internvl2 G = 2 128/128 and 128/64,
                # qwen2 G = 1 128/64, musicgen 32/32; the frontend
                # phase's decode after 250 / 256 + 64 prefilled positions
                (4, 576, 16, 8, 64, 64, [300, 200, 150, 60]),
                (4, 576, 16, 8, 64, 32, [0, 1, 37, 300]),
                (4, 576, 16, 8, 128, 128, [300, 200, 150, 60]),
                (4, 576, 16, 8, 128, 64, [1, 37, 300, 576]),
                (4, 576, 16, 16, 128, 64, [0, 1, 37, 300]),
                (4, 576, 32, 32, 32, 32, [1, 37, 300, 576]),
                (2, 322, 32, 32, 64, 64, [315, 322]),
                (2, 328, 16, 8, 128, 128, [321, 328])]:
            q = self.randn(B, H, dq, gen=gen)
            k = self.randn(B, T, KV, dq, gen=gen)
            v = self.randn(B, T, KV, dv, gen=gen)
            lengths = torch.tensor(lens, dtype=torch.int32, device=self.dev)
            past = (torch.arange(T, device=self.dev)[None, :]
                    >= lengths[:, None].long())[..., None, None]
            k = torch.where(past, torch.full_like(k, 50.0), k)   # garbage
            v = torch.where(past, torch.full_like(v, -50.0), v)
            case = f"B{B} T{T} H{H} KV{KV} dq{dq} dv{dv} len{lens}"
            self.parity("flash_decode", case,
                        flash_decode(q, k, v, lengths, scale=scale),
                        ref.decode_attention_ref(q, k, v, lengths,
                                                 scale=scale))
            self.dtype_parity(
                "flash_decode", case,
                lambda *a: flash_decode(*a, lengths, scale=scale),
                lambda *a: ref.decode_attention_ref(*a, lengths,
                                                    scale=scale), q, k, v)

        # paged decode: (B, H, KV, dq, dv, pt, n_pages, n_p, lengths)
        for B, H, KV, dq, dv, pt, n_pages, n_p, lens in [
                (4, 25, 25, 32, 32, 16, 48, 36, [300, 200, 150, 60]),
                (6, 4, 2, 32, 24, 16, 40, 8, [0, 1, 15, 16, 17, 40]),
                (3, 2, 1, 64, 32, 8, 30, 10, [0, 9, 80]),
                (4, 32, 8, 128, 128, 16, 48, 36, [300, 200, 150, 60]),
                (4, 32, 8, 64, 64, 16, 48, 36, [0, 1, 37, 300]),
                # split and page boundaries, length 1, full capacity; G=16
                (4, 25, 25, 32, 32, 16, 64, 36, [1, pspan, pspan + 17,
                                                 576]),
                (4, 16, 1, 32, 32, 8, 40, 25, [0, pspan16, pspan16 + 1,
                                               200]),
                # the RoPE configs, as for the dense cache
                (4, 56, 8, 128, 128, 16, 48, 36, [300, 200, 150, 60]),
                (4, 24, 8, 128, 128, 16, 48, 36, [0, 1, 37, 300]),
                (4, 32, 32, 80, 80, 16, 48, 36, [300, 200, 150, 60]),
                (4, 32, 32, 52, 40, 16, 48, 36, [0, 1, 37, 300]),
                (4, 40, 10, 128, 128, 16, 48, 36, [300, 200, 150, 60]),
                (4, 40, 10, 128, 64, 16, 64, 36, [1, 37, 300, 576]),
                # phase 16: unpruned gpt2-xl, pages of 8 in a pool of 40
                (3, 25, 25, 64, 64, 8, 40, 8, [1, 37, 64]),
                (3, 25, 25, 64, 64, 8, 40, 8, [8, 40, 63]),
                # the MoE and frontend configs, as for the dense cache
                (4, 16, 8, 64, 64, 16, 48, 36, [300, 200, 150, 60]),
                (4, 16, 8, 64, 32, 16, 48, 36, [0, 1, 37, 300]),
                (4, 16, 8, 128, 128, 16, 48, 36, [300, 200, 150, 60]),
                (4, 16, 8, 128, 64, 16, 64, 36, [1, 37, 300, 576]),
                (4, 16, 16, 128, 64, 16, 48, 36, [0, 1, 37, 300]),
                (4, 32, 32, 32, 32, 16, 64, 36, [1, 37, 300, 576])]:
            q, kp, vp, tab, lengths = self.paged_case(
                gen, B, H, KV, dq, dv, pt, n_pages, n_p, lens)
            case = f"B{B} H{H} KV{KV} dq{dq} dv{dv} pt{pt} len{lens}"
            self.parity("paged_flash_decode", case,
                        paged_flash_decode(q, kp, vp, tab, lengths,
                                           scale=scale),
                        ref.paged_decode_attention_ref(q, kp, vp, tab,
                                                       lengths, scale=scale))
            self.dtype_parity(
                "paged_flash_decode", case,
                lambda *a: paged_flash_decode(*a, tab, lengths, scale=scale),
                lambda *a: ref.paged_decode_attention_ref(
                    *a, tab, lengths, scale=scale), q, kp, vp)

    def parity16(self, kernel, call, plain, cases, gen):
        """A 16-bit attention form at ``cases`` (((B, S, T, H, KV, dq,
        dv), gain, forms)): q, K and V made in float32 (x gain), cast to
        bfloat16 and to float16, and for each form (label, keyword
        arguments) ``call(q, k, v, **kw)`` held to ``plain`` on the same
        operands by ``held16`` (rows (b, s, h)).  One ``dtypes`` line a
        case."""
        torch = self.torch
        for (B, S, T, H, KV, dq, dv), g, forms in cases:
            q = g * self.randn(B, S, H, dq, gen=gen)
            k = g * self.randn(B, T, KV, dq, gen=gen)
            v = g * self.randn(B, T, KV, dv, gen=gen)
            case = (f"B{B} S{S} T{T} H{H} KV{KV} dq{dq} dv{dv}"
                    + (f" x{g:g}" if g != 1.0 else ""))
            parts, ok = [], True
            for dt in (torch.bfloat16, torch.float16):
                q16, k16, v16 = (x.to(dt) for x in (q, k, v))
                if dt == torch.bfloat16:
                    case += f" [{self.route16(k16, v16, H)}]"
                for label, kw in forms:
                    tag = f"{str(dt)[6:]}{label}"
                    share, worst, good = self.held16(
                        kernel, f"{case} {tag}", call(q16, k16, v16, **kw),
                        plain(q16, k16, v16, **kw))
                    ok &= good
                    parts.append(f"{tag} {share:.4f} {worst:.2f}ulp")
            print(f"dtypes {kernel:18s} {case}: "
                  f"{', '.join(parts)} {'ok' if ok else 'FAIL'}")
            del q, k, v, q16, k16, v16

    def route16(self, k, v, H):
        """The staging route the 16-bit forms' plan takes for K / V
        (``clover_attention.plan16``: TMA or cp.async)."""
        from repro_torch.kernels.clover_attention import plan16
        B, _, KV, dq = k.shape
        return plan16(B, 1, H, KV, dq, v.shape[-1], k.data_ptr(),
                      k.stride()[:3], v.data_ptr(), v.stride()[:3]).route

    def window_views(self, gen):
        """The window form on strided cache views (a window ``cache[:,
        :end, :, :d]`` of a wider cache), each bit for bit the kernel on
        a contiguous copy of them."""
        torch = self.torch
        from repro_torch.kernels.clover_attention import window_attention
        # the window of a wider cache as it lies: 64-wide rows read 64 of
        # 80 (TMA), 13-wide rows read 7 (2-byte loads), and 80-wide rows
        # read 64 of them at G = 4 (TMA)
        for B, cap, end, H, KV, w, d in ((4, 1000, 960, 25, 25, 80, 64),
                                         (2, 150, 130, 6, 2, 13, 7),
                                         (2, 300, 256, 8, 2, 80, 64)):
            for dt in (torch.bfloat16, torch.float16):
                ck = self.randn(B, cap, KV, w, gen=gen).to(dt)
                cv = self.randn(B, cap, KV, w, gen=gen).to(dt)
                q = self.randn(B, end, H, d, gen=gen).to(dt)
                kw, vw = ck[:, :end, :, :d], cv[:, :end, :, :d]
                for sf in (False, True):
                    self.exact(
                        "window_attention",
                        f"B{B} H{H} KV{KV} cache {cap}x{w} window :{end} "
                        f":{d} {str(dt)[6:]} {'masked' if sf else 'chunked'}"
                        f" [{self.route16(kw, vw, H)}]",
                        window_attention(q, kw, vw, scale=0.125,
                                         scale_first=sf),
                        window_attention(q, kw.contiguous(),
                                         vw.contiguous(), scale=0.125,
                                         scale_first=sf),
                        against="kernel on a contiguous copy")
                del ck, cv, q, kw, vw
        self.err["window_attention"] = self.err16["window_attention"]

    def paged_case(self, gen, B, H, KV, dq, dv, pt, n_pages, n_p, lens):
        """Pool with a garbage row ``n_pages`` full of finite garbage;
        each row maps ceil(len/pt) distinct random pages, the rest of
        its table is the sentinel id."""
        torch = self.torch
        N = n_pages + 1
        q = self.randn(B, H, dq, gen=gen)
        kp = self.randn(N, pt, KV, dq, gen=gen)
        vp = self.randn(N, pt, KV, dv, gen=gen)
        kp[n_pages] = 50.0
        vp[n_pages] = -50.0
        perm = torch.randperm(n_pages, generator=gen, device=self.dev).cpu()
        tab = torch.full((B, n_p), n_pages, dtype=torch.int32)
        nxt = 0
        for b, n in enumerate(lens):
            used = -(-n // pt)
            tab[b, :used] = perm[nxt:nxt + used].to(torch.int32)
            nxt += used
        assert nxt <= n_pages
        lengths = torch.tensor(lens, dtype=torch.int32, device=self.dev)
        return q, kp, vp, tab.to(self.dev), lengths

    # ---- phase 2 (rank-clamped decode) ---------------------------------
    def past_rank(self, x, ranks, value):
        """x (..., N, d) with dims >= ranks[n] set to ``value`` (finite
        garbage, or 0 for the mask_head_ranks zero-pad convention)."""
        torch = self.torch
        d = x.shape[-1]
        past = (torch.arange(d, device=x.device)[None, :]
                >= ranks.long()[:, None])
        return torch.where(past, torch.full_like(x, value), x)

    def zero_pad(self, q, k, v, rq, rv):
        """The data a plan serves: each head's q/K tail past rq and V
        tail past rv exactly 0 (q's heads are KV groups of G)."""
        G = q.shape[1] // k.shape[-2]
        return (self.past_rank(q, rq.repeat_interleave(G), 0.0),
                self.past_rank(k, rq, 0.0), self.past_rank(v, rv, 0.0))

    def exact(self, kernel, case, got, want,
              against="unranked kernel on zero-padded data"):
        """Two results of the kernel that must agree bit for bit: ranked
        vs unranked on zero-padded data, chained calls vs one call."""
        torch = self.torch
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        err = (got - want).abs().max().item() if got.numel() else 0.0
        print(f"exact  {kernel:18s} {case:44s} max_abs_err={err:.3e} "
              f"vs {against}, bitwise {'ok' if ok else 'FAIL'}")
        if not ok:
            self.fail(f"{kernel} {case}: not bitwise the {against}")

    def ids32(self, xs):
        return self.torch.tensor(xs, dtype=self.torch.int32, device=self.dev)

    def held16(self, kernel, case, got, want):
        """A 16-bit attention result against its plain version: at least
        DTYPE_SHARE of the outputs bit for bit, every output within one
        ulp of the compute dtype at its row's largest |output| (the row:
        every index but the last, (b, h) decoding, (b, s, h) scoring).
        -> (share bit for bit, worst error in those ulps, ok)."""
        torch = self.torch
        torch.cuda.synchronize()
        g, w = got.float(), want.float()
        if not g.numel():
            return 1.0, 0.0, True
        fi = torch.finfo(got.dtype)
        top = w.abs().amax(dim=-1, keepdim=True).clamp_min(fi.tiny)
        ulp = torch.exp2(torch.floor(torch.log2(top))) * fi.eps
        same = (g == w).float().mean().item()
        worst = ((g - w).abs() / ulp).max().item()
        self.err16[kernel] = max(self.err16.get(kernel, 0.0),
                                 (g - w).abs().max().item())
        ok = (got.dtype == want.dtype and bool(torch.isfinite(g).all())
              and same >= DTYPE_SHARE and worst <= 1.0)
        if not ok:
            self.fail(f"{kernel} {case}: {same:.4f} bit for bit, worst "
                      f"{worst:.2f} ulp")
        return same, worst, ok

    def dtype_parity(self, kernel, case, call, plain, q, k, v, view=None):
        """``call(q, k, v)`` (a decode kernel) at each of DTYPE_PAIRS: q
        cast to the compute dtype, k / v (float32) to the cache dtype,
        then ``view(k, v)`` (the draft's slices) where given, each view
        also held bit for bit to ``call`` on a contiguous copy of it.
        16-bit compute: ``held16`` against ``plain(q, k, v)``; float32
        compute: bit for bit ``call`` on float32 copies of the narrow
        cache.  One line a case."""
        torch = self.torch
        torch.cuda.synchronize()
        parts, ok = [], True
        for cd, kd in DTYPE_PAIRS:
            qc = q.to(getattr(torch, cd))
            kc, vc = k.to(getattr(torch, kd)), v.to(getattr(torch, kd))
            if view is not None:
                kc, vc = view(kc, vc)
            got = call(qc, kc, vc)
            if view is not None and not torch.equal(
                    got, call(qc, kc.contiguous(), vc.contiguous())):
                ok = False
                self.fail(f"{kernel} {case} {cd}/{kd}: the strided call is "
                          "not bit for bit the contiguous one")
            if cd == "float32":
                want = call(qc, kc.float(), vc.float())
                torch.cuda.synchronize()
                same = torch.equal(got, want)
                ok &= same
                parts.append(f"{cd}/{kd} bitwise {same}")
                if not same:
                    self.fail(f"{kernel} {case} {cd}/{kd}: not bit for bit "
                              "the kernel on cache.float()")
            else:
                share, worst, good = self.held16(
                    kernel, f"{case} {cd}/{kd}", got, plain(qc, kc, vc))
                ok &= good
                parts.append(f"{cd}/{kd} {share:.4f} {worst:.2f}ulp")
        print(f"dtypes {kernel:18s} {case}: {', '.join(parts)} "
              f"{'ok' if ok else 'FAIL'}")

    def phase_ranked_parity(self):
        """The rank-clamped kernels against their plain versions (with
        finite garbage past each head's rank), and bitwise against the
        unranked kernels on zero-padded data."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.decode_attention import (
            flash_decode, flash_decode_ranked)
        from repro_torch.kernels.paged_decode_attention import (
            paged_flash_decode, paged_flash_decode_ranked)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 5)
        scale = 1.0 / math.sqrt(64)
        # 25 ragged ranks in [0, 64], not multiples of 8, 0 and 64 among
        # them; and ragged multiples of 8 for the exact cases
        rq25 = [64, 0] + [(h * 37 + 11) % 65 for h in range(2, 25)]
        rv25 = [5, 64, 0] + [(h * 23 + 5) % 65 for h in range(3, 25)]
        rq8 = [8 * (1 + (h * 5) % 8) for h in range(25)]
        rv8 = [8 * (1 + (h * 3) % 8) for h in range(25)]

        # dense: (B, T, H, KV, dq, dv, lengths, qk ranks, vo ranks)
        for B, T, H, KV, dq, dv, lens, rq, rv in [
                (4, 576, 25, 25, 64, 64, [300, 200, 150, 60], rq25, rv25),
                (6, 100, 4, 2, 32, 24, [0, 1, 31, 33, 64, 100], [13, 32],
                 [0, 24]),
                (3, 100, 2, 2, 32, 32, [0, 7, 99], [32, 5], [17, 0]),
                (2, 80, 8, 2, 256, 256, [80, 45], [255, 1], [256, 100])]:
            q = self.randn(B, H, dq, gen=gen)
            lengths = self.ids32(lens)
            past = (torch.arange(T, device=self.dev)[None, :]
                    >= lengths[:, None].long())[..., None, None]
            rqt, rvt = self.ids32(rq), self.ids32(rv)
            k = torch.where(past, 50.0, self.past_rank(
                self.randn(B, T, KV, dq, gen=gen), rqt, 30.0))
            v = torch.where(past, -50.0, self.past_rank(
                self.randn(B, T, KV, dv, gen=gen), rvt, -30.0))
            case = f"B{B} H{H} KV{KV} dq{dq} dv{dv} len{lens}"
            self.parity("flash_decode_ranked", case,
                        flash_decode_ranked(q, k, v, lengths, rqt, rvt,
                                            scale=scale),
                        ref.decode_attention_ref(q, k, v, lengths,
                                                 scale=scale, qk_ranks=rqt,
                                                 vo_ranks=rvt))
            self.dtype_parity(
                "flash_decode_ranked", case,
                lambda *a: flash_decode_ranked(*a, lengths, rqt, rvt,
                                               scale=scale),
                lambda *a: ref.decode_attention_ref(
                    *a, lengths, scale=scale, qk_ranks=rqt, vo_ranks=rvt),
                q, k, v)
        for B, T, H, KV, dq, dv, lens, rq, rv in [
                (4, 576, 25, 25, 64, 64, [300, 200, 150, 60], rq8, rv8),
                (6, 100, 4, 2, 32, 24, [0, 1, 31, 33, 64, 100], [8, 24],
                 [16, 8])]:
            rqt, rvt = self.ids32(rq), self.ids32(rv)
            q, k, v = self.zero_pad(self.randn(B, H, dq, gen=gen),
                                    self.randn(B, T, KV, dq, gen=gen),
                                    self.randn(B, T, KV, dv, gen=gen),
                                    rqt, rvt)
            lengths = self.ids32(lens)
            self.exact("flash_decode_ranked",
                       f"B{B} H{H} KV{KV} dq{dq} dv{dv} zero-padded",
                       flash_decode_ranked(q, k, v, lengths, rqt, rvt,
                                           scale=scale),
                       flash_decode(q, k, v, lengths, scale=scale))

        # paged: (B, H, KV, dq, dv, pt, n_pages, n_p, lengths, ranks)
        for B, H, KV, dq, dv, pt, n_pages, n_p, lens, rq, rv in [
                (4, 25, 25, 64, 64, 16, 48, 36, [300, 200, 150, 60], rq25,
                 rv25),
                (6, 4, 2, 32, 24, 16, 40, 8, [0, 1, 15, 16, 17, 40], [9, 32],
                 [24, 0]),
                (3, 2, 1, 64, 32, 8, 30, 10, [0, 9, 80], [0], [31])]:
            q, kp, vp, tab, lengths = self.paged_case(
                gen, B, H, KV, dq, dv, pt, n_pages, n_p, lens)
            rqt, rvt = self.ids32(rq), self.ids32(rv)
            kp = self.past_rank(kp, rqt, 30.0)
            vp = self.past_rank(vp, rvt, -30.0)
            case = f"B{B} H{H} KV{KV} dq{dq} dv{dv} pt{pt} len{lens}"
            self.parity("paged_flash_decode_ranked", case,
                        paged_flash_decode_ranked(q, kp, vp, tab, lengths,
                                                  rqt, rvt, scale=scale),
                        ref.paged_decode_attention_ref(
                            q, kp, vp, tab, lengths, scale=scale,
                            qk_ranks=rqt, vo_ranks=rvt))
            self.dtype_parity(
                "paged_flash_decode_ranked", case,
                lambda *a: paged_flash_decode_ranked(
                    *a, tab, lengths, rqt, rvt, scale=scale),
                lambda *a: ref.paged_decode_attention_ref(
                    *a, tab, lengths, scale=scale, qk_ranks=rqt,
                    vo_ranks=rvt), q, kp, vp)
        for B, H, KV, dq, dv, pt, n_pages, n_p, lens, rq, rv in [
                (4, 25, 25, 64, 64, 16, 48, 36, [300, 200, 150, 60], rq8,
                 rv8),
                (6, 4, 2, 32, 24, 16, 40, 8, [0, 1, 15, 16, 17, 40], [8, 24],
                 [16, 8])]:
            q, kp, vp, tab, lengths = self.paged_case(
                gen, B, H, KV, dq, dv, pt, n_pages, n_p, lens)
            rqt, rvt = self.ids32(rq), self.ids32(rv)
            q, kp, vp = self.zero_pad(q, kp, vp, rqt, rvt)
            self.exact("paged_flash_decode_ranked",
                       f"B{B} H{H} KV{KV} dq{dq} dv{dv} zero-padded",
                       paged_flash_decode_ranked(q, kp, vp, tab, lengths,
                                                 rqt, rvt, scale=scale),
                       paged_flash_decode(q, kp, vp, tab, lengths,
                                          scale=scale))

    # ---- phase 2 (strided decode reads) --------------------------------
    def draft_cases(self):
        """(label, H, KV, cache widths, draft widths, (slots, positions,
        page tokens, pool pages, pages per slot, lengths)) of the decode
        kernels' strided reads: the self-speculative draft's views
        ``cache[..., :r]`` at ``draft_ranks(cfg, 0.5)`` of each model's
        served widths, the geometry of the engines that read them where
        it is not the main path's, and an odd row stride (the 4-byte
        path)."""
        from repro_torch.configs import get_config
        from repro_torch.core.prune import _set_ranks, draft_ranks

        def draft(name, qk, vo):
            return draft_ranks(_set_ranks(get_config(name), qk, vo), 0.5)
        main = (4, 576, 16, 48, 36, [0, 1, 37, 576])
        # phase 16's engines: 3 slots of ADAPTER_MAX_LEN, pages of 8
        adapters = (3, ADAPTER_MAX_LEN, ADAPTER_PAGE_TOKENS,
                    ADAPTER_POOL_PAGES, ADAPTER_MAX_LEN // ADAPTER_PAGE_TOKENS,
                    [1, 37, ADAPTER_MAX_LEN])
        # the budget phase's spec engines (MAIN_ENGINES): the plan's
        # widths 56/56 read as 32/32
        budget = (4, 512, 16, 48, 32, [0, 1, 37, 512])
        return [("gpt2-xl 32/32", 25, 25, (32, 32),
                 draft("gpt2-xl", 32, 32), main),
                ("gpt2-xl unpruned 64/64", 25, 25, (64, 64),
                 draft("gpt2-xl", 64, 64), adapters),
                ("budget 56/56", 25, 25, (56, 56), (32, 32), budget),
                ("stablelm partial 52/40", 32, 32, (52, 40),
                 draft("stablelm-3b", 52, 40), main),
                ("phi3 intra 128/64", 40, 10, (128, 64),
                 draft("phi3-medium-14b", 128, 64), main),
                ("jamba G4 64/64", 32, 8, (64, 64), (32, 32), main),
                ("odd stride 33/27", 4, 2, (33, 27), (16, 13), main)]

    def phase_strided_parity(self):
        """The four decode kernels reading ``cache[..., :r]`` views of a
        full-width cache or pool through its row stride (the draft's
        reads, DESIGN.md §8): within TOL of the plain version on the same
        views, and bit for bit the kernel on a contiguous copy of the
        views (the reduction trees depend on shapes and lengths only).
        Lengths 0, 1, mid-tile and full capacity, finite garbage past the
        lengths and in the sentinel page; the ranked kernels with ragged
        per-head ranks clamped to the draft widths, as the draft passes
        them."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.decode_attention import (
            flash_decode, flash_decode_ranked, row_stride)
        from repro_torch.kernels.paged_decode_attention import (
            paged_flash_decode, paged_flash_decode_ranked)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 7)
        scale = 1.0 / math.sqrt(64)
        strided0 = {f.__name__: f.strided_launches for f in (
            flash_decode, paged_flash_decode, flash_decode_ranked,
            paged_flash_decode_ranked)}
        for label, H, KV, (dq, dv), (rq, rv), geom in self.draft_cases():
            B, T, pt, n_pages, n_p, lens = geom
            lengths = self.ids32(lens)
            case = f"{label} -> {rq}/{rv} B{B} T{T} pt{pt}"
            q = self.randn(B, H, rq, gen=gen)
            past = (torch.arange(T, device=self.dev)[None, :]
                    >= lengths[:, None].long())[..., None, None]
            kc = torch.where(past, 50.0, self.randn(B, T, KV, dq, gen=gen))
            vc = torch.where(past, -50.0, self.randn(B, T, KV, dv, gen=gen))
            ks, vs = kc[..., :rq], vc[..., :rv]
            print(f"strided {case}: k row stride {row_stride('k', ks)}, "
                  f"v row stride {row_stride('v', vs)}")
            ranks = (self.ids32([(h * 7 + 3) % (rq + 1) for h in range(KV)]),
                     self.ids32([(h * 5 + 1) % (rv + 1) for h in range(KV)]))
            self.strided_check(
                "flash_decode", case, ks, vs,
                lambda k, v: flash_decode(q, k, v, lengths, scale=scale),
                ref.decode_attention_ref(q, ks, vs, lengths, scale=scale))
            self.strided_check(
                "flash_decode_ranked", case, ks, vs,
                lambda k, v: flash_decode_ranked(q, k, v, lengths, *ranks,
                                                 scale=scale),
                ref.decode_attention_ref(q, ks, vs, lengths, scale=scale,
                                         qk_ranks=ranks[0],
                                         vo_ranks=ranks[1]))
            _, kp, vp, tab, _ = self.paged_case(gen, B, H, KV, dq, dv, pt,
                                                n_pages, n_p, lens)
            kps, vps = kp[..., :rq], vp[..., :rv]
            self.strided_check(
                "paged_flash_decode", case, kps, vps,
                lambda k, v: paged_flash_decode(q, k, v, tab, lengths,
                                                scale=scale),
                ref.paged_decode_attention_ref(q, kps, vps, tab, lengths,
                                               scale=scale))
            self.strided_check(
                "paged_flash_decode_ranked", case, kps, vps,
                lambda k, v: paged_flash_decode_ranked(
                    q, k, v, tab, lengths, *ranks, scale=scale),
                ref.paged_decode_attention_ref(
                    q, kps, vps, tab, lengths, scale=scale,
                    qk_ranks=ranks[0], vo_ranks=ranks[1]))
            # the same views of 16- and 8-bit caches and pools
            view = (lambda k, v, rq=rq, rv=rv: (k[..., :rq], v[..., :rv]))
            kw = dict(scale=scale)
            rk = dict(scale=scale, qk_ranks=ranks[0], vo_ranks=ranks[1])
            for name, fn, plain, cache, extra, kwp in (
                    ("flash_decode", flash_decode, ref.decode_attention_ref,
                     (kc, vc), (), {}),
                    ("flash_decode_ranked", flash_decode_ranked,
                     ref.decode_attention_ref, (kc, vc), ranks, rk),
                    ("paged_flash_decode", paged_flash_decode,
                     ref.paged_decode_attention_ref, (kp, vp), (), {}),
                    ("paged_flash_decode_ranked", paged_flash_decode_ranked,
                     ref.paged_decode_attention_ref, (kp, vp), ranks, rk)):
                lead = (tab,) if "paged" in name else ()
                self.dtype_parity(
                    name, f"strided {case}",
                    lambda *a, fn=fn, lead=lead, extra=extra: fn(
                        *a, *lead, lengths, *extra, **kw),
                    lambda *a, plain=plain, lead=lead, kwp=kwp: plain(
                        *a, *lead, lengths, **(kwp or kw)),
                    q, *cache, view=view)
        for f in (flash_decode, paged_flash_decode, flash_decode_ranked,
                  paged_flash_decode_ranked):
            grew = f.strided_launches - strided0[f.__name__]
            print(f"strided {f.__name__}: {grew} launches with a row "
                  "stride wider than the width")
            if grew <= 0:
                self.fail(f"{f.__name__}: no strided launch counted")

    def strided_check(self, kernel, case, ks, vs, fn, want):
        """``fn(k, v)`` on the strided views against the plain version
        (TOL) and against ``fn`` on contiguous copies (bitwise)."""
        got = fn(ks, vs)
        self.parity(kernel, f"strided {case}", got, want)
        self.exact(kernel, f"strided {case}", got,
                   fn(ks.contiguous(), vs.contiguous()),
                   against="kernel on a contiguous copy")

    # ---- phase 5 (parity) ---------------------------------------------
    def phase_page_parity(self):
        """Both page movers against their plain versions, exactly: each
        side gets its own clone of the same pools (both update in
        place), compared as bit patterns, and rows not addressed by
        ``dst`` must keep their bytes.  float32, bfloat16 and
        float8_e4m3fn pools; one-leaf cases through the reference's
        one-leaf contract (``page_copy`` / ``page_restore``), multi-leaf
        cases through one launch over K and V of widths 32 and 56 (the
        restore's slabs packed in one buffer, as the executor packs
        them); a batch of more pairs than one group holds, a chained
        copy batch (held to the plain version's gather-then-scatter),
        and both routes: the bulk route (TMA) and the byte route at 8,
        4, 2 and 1 bytes (rows or pointers off 16 bytes)."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.page_copy import (
            mover_leaf, page_copy, page_copy_leaves, page_restore,
            page_restore_leaves, plan_movers)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 3)
        f32, bf16, fp8 = torch.float32, torch.bfloat16, torch.float8_e4m3fn
        main = (48, 49, 16, 25, 32)
        kv = (main, main[:4] + (56,))

        def ids(xs):
            return torch.tensor(xs, dtype=torch.int32, device=self.dev)

        def clone_at(t, skew=0):
            """A copy of ``t`` whose data starts ``skew`` bytes past a
            16-byte boundary (a view into a larger buffer: contiguous,
            as the kernels require)."""
            n = skew // t.element_size()
            buf = torch.empty(t.numel() + n, dtype=t.dtype, device=self.dev)
            out = buf[n:].view(t.shape)
            out.copy_(t)
            return out

        def packed(slabs):
            """``slabs`` copied into one byte buffer, each at a 16-byte
            boundary, viewed back as their dtypes (the executor's
            layout)."""
            offs, total = [], 0
            for r in slabs:
                offs.append(total)
                total += -(-r.numel() * r.element_size() // 16) * 16
            buf = torch.empty(total, dtype=torch.uint8, device=self.dev)
            out = []
            for r, o in zip(slabs, offs):
                v = buf[o:o + r.numel() * r.element_size()].view(
                    r.dtype).view(r.shape)
                v.copy_(r)
                out.append(v)
            return out

        def route(plan):
            return (plan.route if plan.route != "bytes"
                    else f"bytes {plan.access}")

        def check(kernel, case, pools, outs, wants, dst):
            torch.cuda.synchronize()
            keep = [i for i in range(pools[0].shape[1]) if i not in set(dst)]
            ok, err = True, 0.0
            for pool, out, want in zip(pools, outs, wants):
                ob, wb, pb = (self.bits(t) for t in (out, want, pool))
                ok = ok and (torch.equal(ob, wb)
                             and torch.equal(ob[:, keep], pb[:, keep]))
                err = max(err, (out.float() - want.float()).abs().max()
                          .item())
            print(f"parity {kernel:18s} {case:44s} max_abs_err={err:.3e} "
                  f"exact {'ok' if ok else 'FAIL'}")
            self.err[kernel] = max(self.err.get(kernel, 0.0), err)
            if not ok:
                self.fail(f"{kernel} {case}: not bit-identical to the "
                          "plain version")

        routes = {"page_copy": set(), "page_restore": set()}

        def copy_case(shapes, dtype, skew, src, dst, case):
            pools = [self.randn(*sh, gen=gen).to(dtype) for sh in shapes]
            s, d = ids(src), ids(dst)
            targets = [clone_at(p, skew) for p in pools]
            plan = plan_movers([mover_leaf(t) for t in targets], len(src))
            r = route(plan)
            routes["page_copy"].add(r)
            if len(pools) == 1:
                outs = [page_copy(targets[0], s, d)]
            else:
                outs = page_copy_leaves(targets, s, d)
            wants = ref.page_copy_leaves_ref([p.clone() for p in pools],
                                             s, d)
            groups = (f", groups of {plan.group}" if plan.route == "bulk"
                      and plan.group < len(src) else "")
            check("page_copy", f"{str(dtype)[6:]} {case} ({r}{groups})",
                  pools, outs, wants, dst)

        def restore_case(shapes, dtype, dst, n_real, case, skew=0):
            pools = [self.randn(*sh, gen=gen).to(dtype) for sh in shapes]
            slabs = []
            for sh in shapes:
                r = self.randn(sh[0], len(dst), *sh[2:], gen=gen)
                r[:, n_real:] = 0.0
                slabs.append(r.to(dtype))
            if skew:
                slabs = [clone_at(r, skew) for r in slabs]
            elif len(pools) > 1:
                slabs = packed(slabs)
            d = ids(dst)
            wants = ref.page_restore_leaves_ref([p.clone() for p in pools],
                                                slabs, d)
            plan = plan_movers([mover_leaf(p, r) for p, r in
                                zip(pools, slabs)], len(dst))
            r = route(plan)
            routes["page_restore"].add(r)
            if len(pools) == 1:
                outs = [page_restore(pools[0].clone(), slabs[0], d)]
            else:
                outs = page_restore_leaves([p.clone() for p in pools],
                                           slabs, d)
            groups = (f", groups of {plan.group}" if plan.route == "bulk"
                      and plan.group < len(dst) else "")
            check("page_restore", f"{str(dtype)[6:]} {case} ({r}{groups})",
                  pools, outs, wants, dst)

        # page_copy, one leaf: (pool shape, dtype, pointer skew, src,
        # dst); row N - 1 is the sentinel
        for shape, dtype, skew, src, dst, case in [
                (main, f32, 0, [3, 17, 40, 8], [21, 5, 33, 47],
                 "main pool, 4 pairs"),
                (main, f32, 0, [12, 48, 48, 48], [30, 48, 48, 48],
                 "main pool, 1 pair + sentinel padding"),
                (main, f32, 0, [9, 2, 30, 48], [11, 20, 9, 48],
                 "in-order hazard (pair 0 src = pair 2 dst)"),
                ((3, 20, 4, 2, 8), f32, 0, [0, 1, 2, 3, 4, 19, 19],
                 [5, 6, 7, 8, 9, 19, 19], "m=7"),
                ((2, 10, 3, 1, 5), f32, 0, [0, 4, 7, 9], [3, 1, 0, 9],
                 "row bytes 60 (not a multiple of 16)"),
                (main, bf16, 0, [3, 17, 40, 8], [21, 5, 33, 47],
                 "main pool, 4 pairs"),
                (main, bf16, 0, [12, 48, 48, 48], [30, 48, 48, 48],
                 "main pool, 1 pair + sentinel padding"),
                (main, bf16, 0, [9, 2, 30, 48], [11, 20, 9, 48],
                 "in-order hazard"),
                (main, bf16, 2, [9, 2, 30, 48], [11, 20, 9, 48],
                 "in-order hazard, pool 2 B off 16"),
                ((3, 12, 2, 1, 6), bf16, 0, [0, 4, 7, 11], [3, 1, 0, 11],
                 "row bytes 24"),
                ((2, 10, 3, 1, 2), bf16, 0, [0, 4, 7, 9], [3, 1, 0, 9],
                 "row bytes 12"),
                ((2, 10, 3, 1, 5), bf16, 0, [0, 4, 7, 9], [3, 1, 0, 9],
                 "row bytes 30"),
                (main, fp8, 0, [3, 17, 40, 8], [21, 5, 33, 47],
                 "main pool, 4 pairs"),
                (main, fp8, 0, [12, 48, 48, 48], [30, 48, 48, 48],
                 "main pool, 1 pair + sentinel padding"),
                (main, fp8, 0, [9, 2, 30, 48], [11, 20, 9, 48],
                 "in-order hazard"),
                ((3, 20, 4, 2, 8), fp8, 0, [0, 1, 2, 3, 4, 19, 19],
                 [5, 6, 7, 8, 9, 19, 19], "m=7"),
                ((2, 10, 3, 1, 5), fp8, 0, [0, 4, 7, 9], [3, 1, 0, 9],
                 "row bytes 15")]:
            copy_case([shape], dtype, skew, src, dst, case)

        # page_copy over K and V of widths 32 and 56, one launch
        many = (4, 200, 16, 4, 16), (4, 200, 16, 4, 28)
        for dtype in (f32, bf16, fp8):
            copy_case(kv, dtype, 0, [3, 17, 40, 8], [21, 5, 33, 47],
                      "K/V 32/56, 4 pairs")
            copy_case(kv, dtype, 0, [12, 48, 48, 48], [30, 48, 48, 48],
                      "K/V 32/56, 1 pair + padding")
            copy_case(kv, dtype, 0, [3, 21, 40, 48], [21, 30, 9, 48],
                      "K/V 32/56, chained (pair 1 reads pair 0's dst)")
            copy_case(many, dtype, 0, list(range(90)),
                      list(range(100, 190)), "K/V 16/28, 90 pairs")
        copy_case(((2, 10, 3, 1, 5), (2, 10, 3, 1, 7)), f32, 0,
                  [0, 4, 7, 9], [3, 1, 0, 9], "K/V rows 60/84")
        copy_case(kv, bf16, 2, [3, 17, 40, 8], [21, 5, 33, 47],
                  "K/V 32/56, pools 2 B off 16")

        # page_restore, one leaf: (pool shape, dtype, dst, real entries);
        # padding repeats the sentinel with zero slabs
        for shape, dtype, dst, n_real, case in [
                (main, f32, [4, 19, 26, 2], 4, "main pool, W=4"),
                (main, f32, [7, 48, 48, 48], 1,
                 "main pool, 3 zero-slab pads"),
                ((2, 10, 3, 1, 5), f32, [5, 2, 9], 2,
                 "row bytes 60, one pad"),
                (main, bf16, [4, 19, 26, 2], 4, "main pool, W=4"),
                (main, bf16, [7, 48, 48, 48], 1,
                 "main pool, 3 zero-slab pads"),
                ((3, 12, 2, 1, 6), bf16, [5, 2, 11], 2,
                 "row bytes 24, one pad"),
                ((2, 10, 3, 1, 2), bf16, [5, 2, 9], 2,
                 "row bytes 12, one pad"),
                ((2, 10, 3, 1, 5), bf16, [5, 2, 9], 2,
                 "row bytes 30, one pad"),
                (main, fp8, [4, 19, 26, 2], 4, "main pool, W=4"),
                (main, fp8, [7, 48, 48, 48], 1,
                 "main pool, 3 zero-slab pads"),
                ((2, 10, 3, 1, 5), fp8, [5, 2, 9], 2,
                 "row bytes 15, one pad")]:
            restore_case([shape], dtype, dst, n_real, case)

        # page_restore over K and V of widths 32 and 56, packed slabs
        for dtype in (f32, bf16, fp8):
            restore_case(kv, dtype, [4, 19, 26, 2], 4, "K/V 32/56, W=4")
            restore_case(kv, dtype, [7, 48, 48, 48], 1,
                         "K/V 32/56, 3 zero-slab pads")
            restore_case(many, dtype, list(range(100, 190)), 90,
                         "K/V 16/28, W=90")
        restore_case(((2, 10, 3, 1, 5), (2, 10, 3, 1, 7)), f32, [5, 2, 9],
                     2, "K/V rows 60/84, one pad")
        restore_case(kv, bf16, [4, 19, 26, 2], 4,
                     "K/V 32/56, slabs 2 B off 16", skew=2)

        want = {"bulk", "bytes 8", "bytes 4", "bytes 2", "bytes 1"}
        for kernel, seen in routes.items():
            print(f"{kernel}: routes run {sorted(seen)}")
            if not want <= seen:
                self.fail(f"{kernel}: routes {sorted(seen)}, not all of "
                          f"{sorted(want)}")

    def bits(self, t):
        """``t``'s bit patterns as a signed integer tensor of the same
        width (equality on the card for every dtype, float8 included)."""
        torch = self.torch
        return t.view({4: torch.int32, 2: torch.int16,
                       1: torch.int8}[t.element_size()])

    # ---- phase 2 (wkv6) ------------------------------------------------
    def wkv6_case(self, gen, B, H, T, d, s0="random", logw=None, u_sign=0):
        """wkv6 inputs on the card: unit-scale r, k, v; decays
        -exp(N(0, 1)) clipped to the model's [-10, -1e-4], or all at
        ``logw``; u of either sign (``u_sign`` forces one); s0 "none",
        "zero" or "random"."""
        torch = self.torch
        r, k, v = (self.randn(B, H, T, d, gen=gen) for _ in range(3))
        if logw is None:
            lw = (-torch.exp(self.randn(B, H, T, d, gen=gen))).clamp(
                -10.0, -1e-4)
        else:
            lw = torch.full((B, H, T, d), float(logw), device=self.dev)
        u = self.randn(H, d, gen=gen) * 0.5
        if u_sign:
            u = u.abs() * u_sign
        state = None
        if s0 == "zero":
            state = torch.zeros((B, H, d, d), device=self.dev)
        elif s0 == "random":
            state = self.randn(B, H, d, d, gen=gen)
        return r, k, v, lw, u, state

    def wkv6_check(self, case, got, want):
        """Parity of (out, S_end) within WKV_TOL * max(1, max |want|)."""
        for part, g, w in zip(("out", "S_end"), got, want):
            tol = WKV_TOL * max(1.0, w.abs().max().item() if w.numel()
                                else 0.0)
            self.parity("wkv6", f"{case} {part}", g, w, tol=tol)

    @staticmethod
    def tag(cfg):
        """A scan kernel's tile as text: wkv6's lanes, columns per thread
        and per block; mamba_scan's lanes and channels per block."""
        return (f"L{cfg[0]}" + (f" x{cfg[1]}" if len(cfg) == 3 else "")
                + f" /{cfg[-1]}")

    def unaligned(self, t):
        """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
        boundary (the kernels then stage with 4-byte copies)."""
        if t is None:
            return None
        buf = self.torch.empty(t.numel() + 1, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    def phase_wkv6_parity(self):
        """The wkv6 kernel against its plain version, at every tile it is
        built for (``CONFIGS``): the rwkv6 path's three shapes
        (decode/TAIL step, prefill chunk, scoring), B = 1 (T = 432, a
        greedy_reference prompt, and T = 1), T that is a multiple of nothing, d of
        32 and 64 (column blocks of 16, 32 or 64), B*H = 1, s0 absent / zero
        / random, decays at the clip edges, u of either sign, inputs that
        are not 16-byte aligned; s0 must come back unwritten, and two
        chained calls (T1, then T2 from S_end) must equal one call over
        T1 + T2 bit for bit."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.wkv6 import CONFIGS, wkv6
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 7)
        for B, H, T, d, s0, lw, us, what in [
                (4, 32, 1, 64, "random", None, 0, "decode/TAIL step"),
                (4, 32, 64, 64, "random", None, 0, "prefill chunk"),
                (4, 32, 1024, 64, "none", None, 0, "scoring"),
                (1, 32, 1, 64, "random", None, 0, "B=1, T=1"),
                (1, 32, 432, 64, "none", None, 0, "B=1 (greedy_reference)"),
                (2, 3, 7, 64, "zero", None, 0, "T=7"),
                (2, 3, 1000, 32, "random", None, 0, "T=1000"),
                (1, 1, 33, 64, "random", None, 1, "B*H=1, u > 0"),
                (1, 1, 1, 32, "none", None, -1, "B*H=1, u < 0"),
                (2, 4, 64, 64, "random", -10.0, -1, "logw=-10"),
                (1, 4, 1024, 64, "random", -1e-4, 1, "logw=-1e-4"),
                (1, 4, 1024, 32, "none", -1e-4, -1, "logw=-1e-4"),
                (2, 3, 45, 64, "random", None, 0, "unaligned"),
                (2, 3, 45, 32, "none", None, 0, "unaligned")]:
            args = self.wkv6_case(gen, B, H, T, d, s0, lw, us)
            if what == "unaligned":
                args = tuple(self.unaligned(a) for a in args)
            want = ref.wkv6_ref(*args)
            before = None if args[5] is None else args[5].clone()
            for cfg in CONFIGS[d]:
                got = wkv6(*args, config=cfg)
                self.wkv6_check(f"B{B} H{H} T{T} d{d} s0 {s0} {what} "
                                f"{self.tag(cfg)}", got, want)
                if before is not None and not torch.equal(before, args[5]):
                    self.fail(f"wkv6 {what}: s0 was written")
        for B, H, T1, T2, d in [(4, 32, 700, 324, 64), (4, 32, 64, 1, 64),
                                (2, 2, 13, 8, 32)]:
            r, k, v, lw, u, s0 = self.wkv6_case(gen, B, H, T1 + T2, d)
            cut = [t[:, :, :T1].contiguous() for t in (r, k, v, lw)]
            rest = [t[:, :, T1:].contiguous() for t in (r, k, v, lw)]
            for cfg in CONFIGS[d]:
                whole = wkv6(r, k, v, lw, u, s0, config=cfg)
                o1, s1 = wkv6(*cut, u, s0, config=cfg)
                o2, s2 = wkv6(*rest, u, s1, config=cfg)
                case = (f"B{B} H{H} d{d} chained T{T1} + T{T2} "
                        f"{self.tag(cfg)}")
                chained = (torch.cat([o1, o2], dim=2), s2)
                self.wkv6_check(case, chained, whole)
                for part, g, w in zip(("out", "S_end"), chained, whole):
                    self.exact("wkv6", f"{case} {part}", g, w,
                               against="one call")

    # ---- phase 3 -----------------------------------------------------
    def bound(self, nbytes, flops, exps=0, rate=FP32_FLOPS):
        """(least ms, what bounds it): bytes at 3.35 TB/s against the
        slower of the FLOPs at ``rate`` (float32 on the CUDA cores, 67
        TFLOP/s; the 3xTF32 tensor-core rate for flash_attention) and
        exponentials on the special-function units."""
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = max(flops / rate, exps / SFU_EXP_PER_S) * 1e3
        return (max(tb, tf), "bytes" if tb >= tf else "operations")

    def phase_timing(self):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ref
        from repro_torch.kernels.clover_attention import flash_attention
        from repro_torch.kernels.decode_attention import flash_decode
        from repro_torch.kernels.paged_decode_attention import \
            paged_flash_decode
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 1)
        scale = 1.0 / math.sqrt(64)
        bound = self.bound

        # flash: scoring batch of the pruned model
        B, S, H, d = 4, 1024, 25, 32
        per_set = 4 * 4 * B * S * H * d
        sets = [[self.randn(B, S, H, d, gen=gen) for _ in range(3)]
                for _ in range(self.copies(per_set))]
        pairs = B * H * S * (S + 1) // 2
        bnd = bound(per_set, pairs * 2 * (d + d), exps=pairs,
                    rate=TF32X3_FLOPS)
        sdpa = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v in sets]
        print(f"SDPA backend at B{B} S{S} H{H} d{d}: "
              f"{self.sdpa_backend(*sdpa[0], is_causal=True)}")
        self.times["flash_attention"] = (
            self.time_ms([lambda s=s: flash_attention(*s, scale=scale)
                          for s in sets]),
            self.time_ms([lambda s=s: ref.attention_ref(*s, scale=scale)
                          for s in sets], iters=5),
            self.time_ms([lambda s=s: F.scaled_dot_product_attention(
                *s, is_causal=True, scale=scale) for s in sdpa]),
            bnd, f"B{B} S{S} H{H} dq{d} dv{d}")

        # dense decode: 4 slots against the engine's 576-position caches
        B, T, H, d = 4, 576, 25, 32
        lens = [300, 200, 150, 60]
        lengths = torch.tensor(lens, dtype=torch.int32, device=self.dev)
        per_set = 4 * (2 * B * T * H * d)
        sets = [(self.randn(B, H, d, gen=gen), self.randn(B, T, H, d, gen=gen),
                 self.randn(B, T, H, d, gen=gen))
                for _ in range(self.copies(per_set))]
        tot = sum(lens)
        nbytes = 4 * (B * H * d + tot * H * 2 * d + B + B * H * d)
        bnd = bound(nbytes, tot * H * 2 * (d + d))
        mask = (torch.arange(T, device=self.dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        sdpa = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v in sets]
        self.times["flash_decode"] = (
            self.time_ms([lambda s=s: flash_decode(*s, lengths, scale=scale)
                          for s in sets]),
            self.time_ms([lambda s=s: ref.decode_attention_ref(
                *s, lengths, scale=scale) for s in sets]),
            self.time_ms([lambda s=s: F.scaled_dot_product_attention(
                *s, attn_mask=mask, scale=scale) for s in sdpa]),
            bnd, f"B{B} T{T} H=KV={H} dq=dv={d} lengths {lens}")
        self.narrow_times(
            "flash_decode", lambda *s: flash_decode(*s, lengths, scale=scale),
            lambda *s: ref.decode_attention_ref(*s, lengths, scale=scale),
            sets, lambda e: 2 * (B * H * d + B * H * d) + 4 * B
            + tot * H * 2 * d * e, tot * H * 2 * (d + d),
            f"B{B} T{T} H=KV={H} dq=dv={d} lengths {lens}",
            library=lambda q, k, v: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, scale=scale))

        # paged decode: the engine's pool (48 pages of 16 + garbage row)
        pt, n_pages, n_p = 16, 48, 36
        cases = [self.paged_case(gen, B, H, H, d, d, pt, n_pages, n_p, lens)
                 for _ in range(self.copies(
                     4 * 2 * (n_pages + 1) * pt * H * d))]
        pages = sum(-(-n // pt) for n in lens)
        nbytes = 4 * (B * H * d + tot * H * 2 * d + B + pages + B * H * d)
        bnd = bound(nbytes, tot * H * 2 * (d + d))
        self.times["paged_flash_decode"] = (
            self.time_ms([lambda c=c: paged_flash_decode(*c, scale=scale)
                          for c in cases]),
            self.time_ms([lambda c=c: ref.paged_decode_attention_ref(
                *c, scale=scale) for c in cases]),
            None, bnd,
            f"B{B} pt{pt} pool {n_pages}+1 pages H=KV={H} dq=dv={d} "
            f"lengths {lens}")
        self.narrow_times(
            "paged_flash_decode",
            lambda *c: paged_flash_decode(*c, scale=scale),
            lambda *c: ref.paged_decode_attention_ref(*c, scale=scale),
            cases, lambda e: 2 * (B * H * d + B * H * d)
            + 4 * (B + pages) + tot * H * 2 * d * e, tot * H * 2 * (d + d),
            f"B{B} pt{pt} pool {n_pages}+1 pages H=KV={H} dq=dv={d} "
            f"lengths {lens}")
        # rows 1-3 at jamba's pruned attention layer (G = 4), and rows 1-2
        # at phi3-medium-14b's pruned one (Q-K 128 -- full RoPE keeps it
        # -- and V-O 64) scoring one sequence
        self.gqa_timing(gen, scale, "G4", 4, 32, 8, 64, 64, paged=True)
        self.gqa_timing(gen, scale, "phi3", 1, 40, 10, 128, 64, paged=False)
        # rows 1-3 at the MoE and frontend configs' groups: G = 2 at 64
        # (granite, 16 heads over 8) and at 128 (internvl2), G = 1 at
        # 128 / 64 (qwen2 pruned V-O, 16 heads, scoring 2 sequences)
        self.gqa_timing(gen, scale, "G2 64", 4, 16, 8, 64, 64, paged=True)
        self.gqa_timing(gen, scale, "G2 128", 4, 16, 8, 128, 128,
                        paged=True)
        self.gqa_timing(gen, scale, "G1 128/64", 2, 16, 16, 128, 64,
                        paged=True)
        self.draft_timing(gen, scale)
        self.timing16(
            "flash_attention",
            lambda q, k, v, sc: flash_attention(q, k, v, scale=sc),
            lambda q, k, v, sc: ref.flash_attention_ref(q, k, v, scale=sc),
            (("gpt2-xl", 4, 1024, 25, 25, 32, 32),
             ("phi3", 1, 1024, 40, 10, 128, 64),
             ("G1 128/64", 2, 1024, 16, 16, 128, 64),
             ("G2 128", 4, 1024, 16, 8, 128, 128),
             ("G4", 4, 1024, 32, 8, 64, 64)), gen, scale=scale)
        self.window_timing(gen)

    def timing16(self, kernel, call, plain, shapes, gen, scale=None,
                 note="", beside=None):
        """A 16-bit attention form in bfloat16 and float16 at ``shapes``
        ((label, B, S, H, KV, dq, dv), S = T): ``call(q, k, v, scale)``,
        its plain version ``plain`` (one call between events without the
        spin: it launches thousands of kernels, emulating the tensor
        cores' sums) and SDPA in the same dtype on K/V expanded to the
        query heads (``note`` after its label), held to the
        FLASH_ATTENTION backend where dq = dv and to EFFICIENT_ATTENTION
        where not, beside the bound of the function: each element of q,
        K, V and the output moved once at 2 bytes, one Q.K and one P.V a
        causal pair at the bf16 tensor-core rate, one exponential a
        causal pair.  ``scale`` None: 1 / sqrt(dq).  Then ``beside(name,
        sets, scale)`` where given.  Keys "<kernel> bf16 <label>" /
        "fp16"."""
        torch = self.torch
        import torch.nn.functional as F
        from torch.nn.attention import SDPBackend, sdpa_kernel
        for label, B, S, H, KV, dq, dv in shapes:
            sc = 1.0 / math.sqrt(dq) if scale is None else scale
            per_set = 2 * B * S * (H * dq + KV * (dq + dv))
            pairs = B * H * S * (S + 1) // 2
            bnd = self.bound(per_set + 2 * B * S * H * dv,
                             pairs * 2 * (dq + dv), exps=pairs,
                             rate=BF16_FLOPS)
            backend = (SDPBackend.FLASH_ATTENTION if dq == dv
                       else SDPBackend.EFFICIENT_ATTENTION)
            G = H // KV
            for tag, dt in (("bf16", torch.bfloat16),
                            ("fp16", torch.float16)):
                sets = [(self.randn(B, S, H, dq, gen=gen).to(dt),
                         self.randn(B, S, KV, dq, gen=gen).to(dt),
                         self.randn(B, S, KV, dv, gen=gen).to(dt))
                        for _ in range(self.copies(per_set))]
                sdpa = [(q.transpose(1, 2), k.repeat_interleave(G, 2)
                         .transpose(1, 2), v.repeat_interleave(G, 2)
                         .transpose(1, 2)) for q, k, v in sets]

                def lib(s):
                    with sdpa_kernel(backend):
                        return F.scaled_dot_product_attention(
                            *s, is_causal=True, scale=sc)
                with sdpa_kernel(backend):
                    chosen = self.sdpa_backend(*sdpa[0], is_causal=True)
                name = f"{kernel} {tag} {label}"
                # every timed shape stages K / V by TMA
                route = self.route16(sets[0][1], sets[0][2], H)
                if route != "tma":
                    self.fail(f"{name}: K / V staged by {route}, not TMA")
                self.times[name] = (
                    self.time_ms([lambda s=s: call(*s, sc) for s in sets]),
                    self.time_unheld_ms([lambda: plain(*sets[0], sc)],
                                        iters=1),
                    self.time_ms([lambda s=s: lib(s) for s in sdpa]),
                    bnd, f"B{B} S{S} H{H} KV{KV} dq{dq} dv{dv} {tag} "
                    f"[{route}], SDPA {chosen} on K/V expanded to {H} "
                    f"heads{note}")
                del sdpa
                if beside is not None:
                    beside(name, sets, sc)
                del sets

    def window_timing(self, gen):
        """The window form (chunked scale order) through ``timing16`` at
        phase 21's gpt2-xl window (B4, S = T = 960, 25 heads of 64; bf16
        is the kernels line's row) and at phi3's pruned heads (B1, S = T =
        1024, 40 over 10, 128/64).  Beside each, a ``time window`` line:
        the route before the window form timed whole (float32 copies of
        q, K and V, the 3xTF32 kernel, the context cast back), the 16-bit
        scoring form on the same operands, the design's own floor (two
        Q.K sweeps and P.V, two exponentials a causal pair; not the
        function's bound) and the added peak of one call on each
        route."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.clover_attention import (flash_attention,
                                                          window_attention)

        def win(q, k, v, scale):
            return window_attention(q, k, v, scale=scale, scale_first=False)

        def beside(name, sets, scale):
            dt = sets[0][0].dtype

            def old(s):
                return flash_attention(*(x.float().contiguous()
                                         for x in s), scale=scale).to(dt)
            old_ms = self.time_ms([lambda s=s: old(s) for s in sets])
            scoring_ms = self.time_ms([lambda s=s: flash_attention(
                *s, scale=scale) for s in sets])
            (B, S, H, dq), dv = sets[0][0].shape, sets[0][2].shape[-1]
            pairs = B * H * S * (S + 1) // 2
            floor, _ = self.bound(0, pairs * 2 * (2 * dq + dv),
                                  exps=2 * pairs, rate=BF16_FLOPS)
            peaks = {}
            for route, fn in (("window", lambda s: win(*s, scale)),
                              ("old", old)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                fn(sets[0])
                torch.cuda.synchronize()
                peaks[route] = torch.cuda.max_memory_allocated() - base
            print(f"time window {self.times[name][4].split(',')[0]}: "
                  f"window form {self.times[name][0]:.4f} ms, old route "
                  f"(float32 copies, 3xTF32 kernel, cast back) "
                  f"{old_ms:.4f} ms, 16-bit scoring form {scoring_ms:.4f} "
                  f"ms, the design's floor (two Q.K sweeps, P.V, two "
                  f"exponentials a pair) {floor:.4f} ms; one call's added "
                  f"peak {peaks['window'] / 1e6:.2f} MB, old route "
                  f"{peaks['old'] / 1e6:.2f} MB [{self.card}]")
        self.timing16(
            "window_attention", win,
            lambda q, k, v, sc: ref.window_attention_ref(
                q, k, v, scale=sc, scale_first=False),
            (("gpt2-xl", 4, 960, 25, 25, 64, 64),
             ("phi3", 1, 1024, 40, 10, 128, 64)), gen,
            note=" (not the same function)", beside=beside)

    def narrow_times(self, name, call, plain, sets, nbytes, flops, shape,
                     library=None):
        """``call`` and ``plain`` (each taking one input set: float32 q,
        k, v and the rest) timed as in phase 3 with q in bfloat16 over a
        bfloat16 and a float8_e4m3fn cache (keys "<name> bf16" / "<name>
        fp8"), beside the bound of ``nbytes(e)`` bytes (e bytes a K / V
        element) and ``flops``; the plain version between events without
        the spin (it launches a kernel per column); ``library`` (one
        PyTorch call on a set) in bfloat16 only: SDPA takes no float8.
        The narrow sets are distinct copies, enough of them to keep the
        reads out of L2."""
        torch = self.torch
        for tag, kd, e in (("bf16", torch.bfloat16, 2),
                           ("fp8", torch.float8_e4m3fn, 1)):
            n = self.copies(nbytes(e))
            narrow = [(s[0].to(torch.bfloat16), s[1].to(kd), s[2].to(kd),
                       *s[3:]) for s in (sets * n)[:n]]
            lib = (self.time_ms([lambda s=s: library(*s) for s in narrow])
                   if library is not None and tag == "bf16" else None)
            self.times[f"{name} {tag}"] = (
                self.time_ms([lambda s=s: call(*s) for s in narrow]),
                self.time_unheld_ms([lambda s=s: plain(*s) for s in narrow]),
                lib, self.bound(nbytes(e), flops),
                f"{shape}, bfloat16 q over a {str(kd)[6:]} cache")
            del narrow

    def draft_timing(self, gen, scale):
        """The four decode kernels at gpt2-xl's draft shape (the main
        path's 4 slots, lengths and 25 heads; cache 32/32, draft 16/16):
        the strided call on ``cache[..., :16]``, a ``.contiguous()`` copy
        of the views plus the kernel, the full-width call, the plain
        version on the views, and the bound at the draft widths (what the
        strided call must read).  Ranked: the plan's ragged ranks of
        phase 7 clamped to 16.  ``time draft`` lines."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.decode_attention import (
            flash_decode, flash_decode_ranked)
        from repro_torch.kernels.paged_decode_attention import (
            paged_flash_decode, paged_flash_decode_ranked)
        B, T, H, d, r = 4, 576, 25, 32, 16
        lens = [300, 200, 150, 60]
        lengths = self.ids32(lens)
        tot = sum(lens)
        pt, n_pages, n_p = 16, 48, 36
        pages = sum(-(-n // pt) for n in lens)
        ranks = [self.ids32([min(r, (h * 7 + 3) % (r + 1) + 4)
                             for h in range(H)]) for _ in range(2)]
        kept = [sum(int(x) for x in t.tolist()) for t in ranks]
        self.draft_times = {}
        for name, paged, ranked in (
                ("flash_decode", False, False),
                ("paged_flash_decode", True, False),
                ("flash_decode_ranked", False, True),
                ("paged_flash_decode_ranked", True, True)):
            if paged:
                cases = [self.paged_case(gen, B, H, H, d, d, pt, n_pages,
                                         n_p, lens)
                         for _ in range(self.copies(
                             4 * 2 * (n_pages + 1) * pt * H * d))]
                sets = [(q, kp, vp, tab) for q, kp, vp, tab, _ in cases]
            else:
                sets = [(self.randn(B, H, d, gen=gen),
                         self.randn(B, T, H, d, gen=gen),
                         self.randn(B, T, H, d, gen=gen), None)
                        for _ in range(self.copies(4 * 2 * B * T * H * d))]
            fn = {"flash_decode": flash_decode,
                  "paged_flash_decode": paged_flash_decode,
                  "flash_decode_ranked": flash_decode_ranked,
                  "paged_flash_decode_ranked": paged_flash_decode_ranked
                  }[name]
            plain = (ref.paged_decode_attention_ref if paged
                     else ref.decode_attention_ref)

            def call(f, q, k, v, tab, plain_call=False):
                lead = (q, k, v) + ((tab,) if paged else ())
                if plain_call:
                    kw = (dict(qk_ranks=ranks[0], vo_ranks=ranks[1])
                          if ranked else {})
                    return f(*lead, lengths, scale=scale, **kw)
                return f(*lead, lengths, *(ranks if ranked else ()),
                         scale=scale)
            views = [(q[..., :r].contiguous(), k[..., :r], v[..., :r], tab)
                     for q, k, v, tab in sets]
            strided = self.time_ms([lambda s=s: call(fn, *s)
                                    for s in views])
            copied = self.time_ms([lambda s=s: call(
                fn, s[0], s[1].contiguous(), s[2].contiguous(), s[3])
                for s in views])
            full = self.time_ms([lambda s=s: call(fn, *s) for s in sets])
            plain_ms = self.time_ms([lambda s=s: call(plain, *s,
                                                      plain_call=True)
                                     for s in views])
            rk = (kept[0] + kept[1]) / H if ranked else 2 * r
            nbytes = 4 * (B * H * r + tot * H * rk + B + B * H * r
                          + (pages if paged else 0)
                          + (2 * H if ranked else 0))
            bnd = self.bound(nbytes, tot * H * 2 * rk)
            self.draft_times[name] = (strided, copied, full, plain_ms, bnd)
            print(f"time draft {name:25s} B{B} H=KV={H} cache {d}/{d} -> "
                  f"{r}/{r}{' ranked' if ranked else ''}: strided "
                  f"{strided:.4f} ms, copy + kernel {copied:.4f} ms, full "
                  f"width {full:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]}, draft widths) [{self.card}]")

    def gqa_timing(self, gen, scale, label, B, H, KV, dq, dv, paged):
        """``flash_attention`` scoring B sequences of 1024 tokens with H
        query heads over KV heads, then ``flash_decode`` (and with
        ``paged`` ``paged_flash_decode``) with 4 slots, as above.
        ``time`` lines only; the kernel rows keep the gpt2-xl shapes."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ref
        from repro_torch.kernels.clover_attention import flash_attention
        from repro_torch.kernels.decode_attention import flash_decode
        from repro_torch.kernels.paged_decode_attention import \
            paged_flash_decode
        S = 1024
        per_set = 4 * B * S * (H * dq + KV * (dq + dv))
        sets = [(self.randn(B, S, H, dq, gen=gen),
                 self.randn(B, S, KV, dq, gen=gen),
                 self.randn(B, S, KV, dv, gen=gen))
                for _ in range(self.copies(per_set))]
        pairs = B * H * S * (S + 1) // 2
        sdpa = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v in sets]
        # two yardsticks: SDPA with enable_gqa (whichever backend takes
        # it), and SDPA held to the memory-efficient (fused, tensor-core
        # 3xTF32) backend on K/V expanded to the H query heads
        from torch.nn.attention import SDPBackend, sdpa_kernel
        G = H // KV
        expanded = [(q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1))
                    for q, k, v in sdpa]
        gqa_ms = self.time_ms([lambda s=s: F.scaled_dot_product_attention(
            *s, is_causal=True, scale=scale, enable_gqa=True)
            for s in sdpa])

        def efficient(s):
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(*s, is_causal=True,
                                                      scale=scale)
        name = f"flash_attention {label}"
        self.times[name] = (
            self.time_ms([lambda s=s: flash_attention(*s, scale=scale)
                          for s in sets]),
            self.time_ms([lambda s=s: ref.attention_ref(*s, scale=scale)
                          for s in sets], iters=5),
            self.time_ms([lambda s=s: efficient(s) for s in expanded]),
            self.bound(per_set + 4 * B * S * H * dv, pairs * 2 * (dq + dv),
                       exps=pairs, rate=TF32X3_FLOPS),
            f"B{B} S{S} H{H} KV{KV} dq{dq} dv{dv}")
        print(f"time {name} yardsticks: SDPA enable_gqa "
              f"{gqa_ms:.4f} ms (backend "
              f"{self.sdpa_backend(*sdpa[0], is_causal=True, enable_gqa=True)}"
              f"), SDPA EFFICIENT_ATTENTION on K/V expanded to {H} heads "
              f"{self.times[name][2]:.4f} ms (backend "
              f"{self.sdpa_backend(*expanded[0], is_causal=True)}) "
              f"[{self.card}]")
        del sets, sdpa, expanded

        B, T = 4, 576
        lens = [300, 200, 150, 60]
        lengths = self.ids32(lens)
        tot = sum(lens)
        sets = [(self.randn(B, H, dq, gen=gen),
                 self.randn(B, T, KV, dq, gen=gen),
                 self.randn(B, T, KV, dv, gen=gen))
                for _ in range(self.copies(4 * B * T * KV * (dq + dv)))]
        nbytes = 4 * (B * H * dq + tot * KV * (dq + dv) + B + B * H * dv)
        flops = tot * H * 2 * (dq + dv)
        mask = (torch.arange(T, device=self.dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        sdpa = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v in sets]
        self.times[f"flash_decode {label}"] = (
            self.time_ms([lambda s=s: flash_decode(*s, lengths, scale=scale)
                          for s in sets]),
            self.time_ms([lambda s=s: ref.decode_attention_ref(
                *s, lengths, scale=scale) for s in sets]),
            self.time_ms([lambda s=s: F.scaled_dot_product_attention(
                *s, attn_mask=mask, scale=scale, enable_gqa=True)
                for s in sdpa]),
            self.bound(nbytes, flops),
            f"B{B} T{T} H{H} KV{KV} dq{dq} dv{dv} lengths {lens}")
        del sets, sdpa
        if not paged:
            return

        pt, n_pages, n_p = 16, 48, 36
        cases = [self.paged_case(gen, B, H, KV, dq, dv, pt, n_pages, n_p,
                                 lens)
                 for _ in range(self.copies(
                     4 * (n_pages + 1) * pt * KV * (dq + dv)))]
        pages = sum(-(-n // pt) for n in lens)
        self.times[f"paged_flash_decode {label}"] = (
            self.time_ms([lambda c=c: paged_flash_decode(*c, scale=scale)
                          for c in cases]),
            self.time_ms([lambda c=c: ref.paged_decode_attention_ref(
                *c, scale=scale) for c in cases]),
            None, self.bound(nbytes + 4 * pages, flops),
            f"B{B} pt{pt} pool {n_pages}+1 pages H{H} KV{KV} dq{dq} dv{dv} "
            f"lengths {lens}")

    def sdpa_backend(self, q, k, v, **kw):
        """The backend PyTorch's dispatcher picks for one SDPA call on
        these inputs (under an ``sdpa_kernel`` context, the one it
        allows)."""
        torch = self.torch
        from torch.nn.attention import SDPBackend
        try:
            choice = torch._fused_sdp_choice(q, k, v, **kw)
        except (AttributeError, RuntimeError, TypeError) as e:
            return f"not determined ({type(e).__name__})"
        names = {b.value: n for n, b in SDPBackend.__members__.items()}
        return names.get(int(choice), str(choice))

    def print_times(self, names=None):
        for name in names or list(self.times):
            ms, plain, lib, (bms, by), shape = self.times[name]
            libs = "n/a" if lib is None else f"{lib:.4f}"
            print(f"time {name:23s} {shape}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, library {libs} ms, bound {bms:.4f} ms "
                  f"({by}) [{self.card}]")

    # ---- phase 5 (timing) ----------------------------------------------
    def phase_page_timing(self):
        """The page movers at the main path's shapes, in float32 (the
        kernel rows) and in bfloat16 and float8_e4m3fn (the 2- and 1-byte
        pools of the narrow KV caches): gpt2-xl's pool leaf (48 blocks,
        48 pages + the sentinel, 16 tokens, 25 KV heads, rank 32) and a
        full W = 4 batch of distinct pages.  Per batch over both of its
        leaves (K and V), one launch (the main path's call), beside the
        plain version, two ``index_copy_`` calls and the bound, and the
        same launch with no bytes to move; per leaf (``leaf`` lines, the
        one-leaf contract).  Input copies rotate so the rows come from
        HBM.  The bound counts each moved row read once and written
        once."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.page_copy import (
            page_copy, page_copy_leaves, page_restore, page_restore_leaves)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 4)
        shape = (48, 49, 16, 25, 32)
        W = 4
        src = torch.tensor([3, 17, 40, 8], dtype=torch.int32,
                           device=self.dev)
        dst = torch.tensor([21, 5, 33, 47], dtype=torch.int32,
                           device=self.dev)
        s64, d64 = src.long(), dst.long()

        def lib_copy(ps):
            for p in ps:
                p.index_copy_(1, d64, p.index_select(1, s64))

        def lib_restore(ps, rs):
            for p, r in zip(ps, rs):
                p.index_copy_(1, d64, r)

        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, " bf16"),
                           (torch.float8_e4m3fn, " fp8")):
            name = str(dtype)[6:]
            size = torch.finfo(dtype).bits // 8
            leaf_moved = 2 * W * size * math.prod(shape[2:]) * shape[0]
            n = self.copies(2 * leaf_moved)
            # n sets of (K, V) pools and their restore slabs
            pools = [[self.randn(*shape, gen=gen).to(dtype)
                      for _ in range(2)] for _ in range(n)]
            rows = [[self.randn(shape[0], W, *shape[2:], gen=gen).to(dtype)
                     for _ in range(2)] for _ in range(n)]
            # the library calls move a narrow pool's bits (CUDA's
            # index_copy_ has no float8)
            lib = [[p if not tag else self.bits(p) for p in ps]
                   for ps in pools]
            lrows = [[r if not tag else self.bits(r) for r in rs]
                     for rs in rows]
            self.times["page_copy leaf" + tag] = (
                self.time_ms([lambda p=ps[0]: page_copy(p, src, dst)
                              for ps in pools]),
                self.time_ms([lambda p=ps[0]: ref.page_copy_ref(p, src, dst)
                              for ps in pools]),
                self.time_ms([lambda p=ps[:1]: lib_copy(p) for ps in lib]),
                self.bound(leaf_moved, 0),
                f"pool {shape} {name}, W={W} pairs")
            self.times["page_restore leaf" + tag] = (
                self.time_ms([lambda p=ps[0], r=rs[0]: page_restore(
                    p, r, dst) for ps, rs in zip(pools, rows)]),
                self.time_ms([lambda p=ps[0], r=rs[0]: ref.page_restore_ref(
                    p, r, dst) for ps, rs in zip(pools, rows)]),
                self.time_ms([lambda p=ps[:1], r=rs[:1]: lib_restore(p, r)
                              for ps, rs in zip(lib, lrows)]),
                self.bound(leaf_moved, 0),
                f"pool {shape} {name}, W={W} rows")
            batch = f"K + V pools {shape} {name}, W={W}, one launch"
            # the same launch with every pair a sentinel self-copy: each
            # block starts, reads its ids and moves nothing -- the floor
            # of the grid that moves this batch
            pads = torch.full((W,), shape[1] - 1, dtype=torch.int32,
                              device=self.dev)
            floor = self.time_ms([lambda ps=ps: page_copy_leaves(ps, pads,
                                                                 pads)
                                  for ps in pools])
            print(f"time page_copy floor {name}: the per-batch launch with "
                  f"{W} self-copies (no bytes moved) {floor:.4f} ms "
                  f"[{self.card}]")
            self.times["page_copy" + tag] = (
                self.time_ms([lambda ps=ps: page_copy_leaves(ps, src, dst)
                              for ps in pools]),
                self.time_ms([lambda ps=ps: ref.page_copy_leaves_ref(
                    ps, src, dst) for ps in pools]),
                self.time_ms([lambda ps=ps: lib_copy(ps) for ps in lib]),
                self.bound(2 * leaf_moved, 0), batch)
            self.times["page_restore" + tag] = (
                self.time_ms([lambda ps=ps, rs=rs: page_restore_leaves(
                    ps, rs, dst) for ps, rs in zip(pools, rows)]),
                self.time_ms([lambda ps=ps, rs=rs:
                              ref.page_restore_leaves_ref(ps, rs, dst)
                              for ps, rs in zip(pools, rows)]),
                self.time_ms([lambda ps=ps, rs=rs: lib_restore(ps, rs)
                              for ps, rs in zip(lib, lrows)]),
                self.bound(2 * leaf_moved, 0), batch)
            del pools, rows, lib, lrows

    # ---- phase 3 (wkv6) ------------------------------------------------
    # the shapes each scan kernel is timed at: (row key, shape, state);
    # the B = 1 step is an edge case (greedy_reference never walks fewer
    # than 16 tokens at B = 1), kept beside the B = 4 step as its floor
    WKV6_SHAPES = (("wkv6", (4, 32, 1, 64), "random"),
                   ("wkv6 chunk", (4, 32, 64, 64), "random"),
                   ("wkv6 scoring", (4, 32, 1024, 64), "none"),
                   ("wkv6 B1 T1 (edge)", (1, 32, 1, 64), "random"),
                   ("wkv6 B1 T432", (1, 32, 432, 64), "none"))

    def wkv6_sets(self, gen, B, H, T, d, s0):
        """(bytes, input sets) for timing wkv6 at one shape: the bytes
        each input read once (s0 only where given) and each output
        written once."""
        n_s0 = 1 if s0 == "random" else 0
        nbytes = 4 * (5 * B * H * T * d + H * d + (1 + n_s0) * B * H
                      * d * d)
        return nbytes, [self.wkv6_case(gen, B, H, T, d, s0)
                        for _ in range(self.copies(nbytes))]

    def phase_wkv6_timing(self):
        """wkv6 at the rwkv6 path's three shapes: a decode/TAIL step and
        a prefill chunk from the engine's state (s0 given), scoring from
        zeros; at a greedy_reference prompt (B = 1, T = 432) and at the
        B = 1 step (an edge case no path runs).  The bound counts each
        input read once (s0 only where given) and each output written
        once, against 5 d^2 + 6 d FLOPs per (b, h, t).  No single
        PyTorch call computes wkv6."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.wkv6 import wkv6
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 8)
        for key, (B, H, T, d), s0 in self.WKV6_SHAPES:
            nbytes, sets = self.wkv6_sets(gen, B, H, T, d, s0)
            self.times[key] = (
                self.time_ms([lambda a=a: wkv6(*a) for a in sets]),
                self.time_unheld_ms([lambda a=a: ref.wkv6_ref(*a)
                                     for a in sets]),
                None, self.bound(nbytes, B * H * T * (5 * d * d + 6 * d)),
                f"B{B} H{H} T{T} d{d} s0 {s0}")
            del sets
        # what one launch of almost nothing takes between the same events:
        # the floor under the T = 1 rows
        one = torch.zeros(1, device=self.dev)
        print(f"time launch floor (a one-element add_): "
              f"{self.time_ms([lambda: one.add_(1.0)]):.4f} ms "
              f"[{self.card}]")

    def phase_wkv6_tune(self):
        """Development only (``--only phase_wkv6_tune``): every tile wkv6
        is built for, timed at each of the timing shapes (``tune`` lines;
        the planner's choice is marked) -- the measurement behind
        ``kernels/wkv6.py: plan``."""
        torch = self.torch
        from repro_torch.kernels._build import sm_count
        from repro_torch.kernels.wkv6 import CONFIGS, plan, wkv6
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 8)
        sms = sm_count(self.dev.index or 0)
        rows = {cfg: [] for cfg in CONFIGS[64]}
        for _, (B, H, T, d), s0 in self.WKV6_SHAPES:
            _, sets = self.wkv6_sets(gen, B, H, T, d, s0)
            chosen = plan(d, B * H, sms)[:3]
            for cfg, row in rows.items():
                ms = self.time_ms([lambda a=a: wkv6(*a, config=cfg)
                                   for a in sets])
                row.append(f"B{B} T{T} {ms:.4f} ms"
                           + (" (planned)" if cfg == chosen else ""))
            del sets
        for cfg, row in rows.items():
            print(f"tune wkv6 d64 {self.tag(cfg)}: " + ", ".join(row)
                  + f" [{self.card}]")

    # ---- phase 2 (mamba_scan) ------------------------------------------
    def mamba_case(self, gen, B, S, dI, dS=16, h0="random", dt=None):
        """mamba_scan inputs on the card: unit-scale x, B and C; A the
        S4D-real ``1..dS`` per channel times a random factor in [0.5,
        2]; dt ``softplus(N(-2, 1))`` (the model's range), or "small"
        (1e-5..1e-4: decay ~ 1, the state keeps everything) or "large"
        (20..30: decay ~ 0, the state forgets at once); h0 "none",
        "zero" or "random"."""
        torch = self.torch
        import torch.nn.functional as F
        x = self.randn(B, S, dI, gen=gen)
        Bm, C = self.randn(B, S, dS, gen=gen), self.randn(B, S, dS, gen=gen)
        u = torch.rand((B, S, dI), generator=gen, device=self.dev)
        if dt == "small":
            dtv = 1e-5 + 9e-5 * u
        elif dt == "large":
            dtv = 20.0 + 10.0 * u
        else:
            dtv = F.softplus(self.randn(B, S, dI, gen=gen) - 2.0)
        scale = 2.0 ** (2.0 * torch.rand((dI, 1), generator=gen,
                                         device=self.dev) - 1.0)
        A = torch.arange(1, dS + 1, dtype=torch.float32,
                         device=self.dev)[None, :] * scale
        state = None
        if h0 == "zero":
            state = torch.zeros((B, dI, dS), device=self.dev)
        elif h0 == "random":
            state = self.randn(B, dI, dS, gen=gen)
        return dtv, A, Bm, C, x, state

    def mamba_check(self, case, got, want):
        """Parity of (y, h_end) within MAMBA_TOL * max(1, max |want|)."""
        for part, g, w in zip(("y", "h_end"), got, want):
            tol = MAMBA_TOL * max(1.0, w.abs().max().item() if w.numel()
                                  else 0.0)
            self.parity("mamba_scan", f"{case} {part}", g, w, tol=tol)

    def phase_mamba_parity(self):
        """The mamba_scan kernel against its plain version, at every
        (lanes, channels) it is built for (``CONFIGS``): the
        jamba path's shapes (B=4, dI=8192, dS=16: S = 1 and 64 from a
        random state, S = 1024 from zeros), S = 7 and 1000, dI = 96, 1000
        and 8168 (not a multiple of a block's 32 or 64 channels) and 8190
        (nor of 4: the 4-byte copies), B = 1, h0 absent / zero / random,
        dt near 0 (decay ~ 1) and large (decay ~ 0), inputs that are not
        16-byte aligned; h0 must come back unwritten, and two chained
        calls (S1, then S2 from h_end) must equal one call over S1 + S2
        bit for bit."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.mamba_scan import CONFIGS, mamba_scan
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 9)
        for B, S, dI, h0, dt, what in [
                (4, 1, 8192, "random", None, "decode/TAIL step"),
                (4, 64, 8192, "random", None, "prefill chunk"),
                (4, 1024, 8192, "none", None, "scoring"),
                (2, 7, 8192, "zero", None, "S=7"),
                (2, 1000, 256, "random", None, "S=1000"),
                (3, 50, 96, "random", None, "dI=96"),
                (2, 33, 1000, "none", None, "dI=1000"),
                (1, 432, 8192, "none", None, "B=1 (greedy_reference)"),
                (1, 1, 8192, "random", None, "B=1, S=1"),
                (4, 300, 1000, "random", "small", "dt ~ 1e-5 (decay ~ 1)"),
                (4, 64, 1000, "random", "large", "dt ~ 25 (decay ~ 0)"),
                (2, 40, 8168, "random", None, "dI=8168: ragged block"),
                (2, 40, 8190, "random", None, "dI=8190: 4-byte copies"),
                (2, 37, 1000, "random", None, "unaligned")]:
            args = self.mamba_case(gen, B, S, dI, h0=h0, dt=dt)
            if what == "unaligned":
                args = tuple(self.unaligned(a) for a in args)
            want = ref.mamba_scan_ref(*args)
            before = None if args[5] is None else args[5].clone()
            for cfg in CONFIGS:
                got = mamba_scan(*args, config=cfg)
                self.mamba_check(f"B{B} S{S} dI{dI} h0 {h0} {what} "
                                 f"{self.tag(cfg)}", got, want)
                if before is not None and not torch.equal(before, args[5]):
                    self.fail(f"mamba_scan {what}: h0 was written")
        for B, S1, S2, dI in [(4, 700, 324, 8192), (4, 64, 1, 8192),
                              (2, 13, 8, 1000)]:
            dt, A, Bm, C, x, h0 = self.mamba_case(gen, B, S1 + S2, dI)
            cut = [t[:, :S1].contiguous() for t in (dt, Bm, C, x)]
            rest = [t[:, S1:].contiguous() for t in (dt, Bm, C, x)]
            for cfg in CONFIGS:
                kw = dict(config=cfg)
                whole = mamba_scan(dt, A, Bm, C, x, h0, **kw)
                y1, h1 = mamba_scan(cut[0], A, cut[1], cut[2], cut[3], h0,
                                    **kw)
                y2, h2 = mamba_scan(rest[0], A, rest[1], rest[2], rest[3],
                                    h1, **kw)
                case = f"B{B} dI{dI} chained S{S1} + S{S2} {self.tag(cfg)}"
                chained = (torch.cat([y1, y2], dim=1), h2)
                self.mamba_check(case, chained, whole)
                for part, g, w in zip(("y", "h_end"), chained, whole):
                    self.exact("mamba_scan", f"{case} {part}", g, w,
                               against="one call")

    # ---- phase 3 (mamba_scan) ------------------------------------------
    # as WKV6_SHAPES: (row key, B, S, h0) at dI = 8192, dS = 16
    MAMBA_SHAPES = (("mamba_scan", 4, 1, "random"),
                    ("mamba_scan chunk", 4, 64, "random"),
                    ("mamba_scan scoring", 4, 1024, "none"),
                    ("mamba_scan B1 S1 (edge)", 1, 1, "random"),
                    ("mamba_scan B1 S432", 1, 432, "none"))

    def mamba_sets(self, gen, B, S, dI, dS, h0):
        """(bytes, input sets) for timing mamba_scan at one shape: the
        bytes each input read once (h0 only where given) and each output
        written once."""
        n_h0 = 1 if h0 == "random" else 0
        nbytes = 4 * (3 * B * S * dI + 2 * B * S * dS + dI * dS
                      + (1 + n_h0) * B * dI * dS)
        return nbytes, [self.mamba_case(gen, B, S, dI, dS, h0=h0)
                        for _ in range(self.copies(nbytes))]

    def phase_mamba_timing(self):
        """mamba_scan at the jamba path's three shapes: a decode/TAIL
        step and a prefill chunk from the engine's state (h0 given),
        scoring from zeros; at a greedy_reference prompt (B = 1, S = 432)
        and at the B = 1 step (an edge case no path runs).  The bound
        counts each input read once (h0 only where given) and each output
        written once, against ~5 B S dI dS float32 operations and B S dI
        dS exponentials.  The plain version is timed between events
        without the spin (it launches several kernels per step).  No
        single PyTorch call computes a selective scan."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.mamba_scan import mamba_scan
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 10)
        dI, dS = 8192, 16
        for key, B, S, h0 in self.MAMBA_SHAPES:
            nbytes, sets = self.mamba_sets(gen, B, S, dI, dS, h0)
            work = B * S * dI * dS
            self.times[key] = (
                self.time_ms([lambda a=a: mamba_scan(*a) for a in sets]),
                self.time_unheld_ms([lambda a=a: ref.mamba_scan_ref(*a)
                                     for a in sets]),
                None, self.bound(nbytes, 5 * work, exps=work),
                f"B{B} S{S} dI{dI} dS{dS} h0 {h0}")
            del sets

    def phase_mamba_tune(self):
        """Development only (``--only phase_mamba_tune``): every (lanes,
        channels) mamba_scan is built for, timed at each of the timing
        shapes (``tune`` lines; the planner's choice is marked) -- the
        measurement behind ``kernels/mamba_scan.py: plan``."""
        torch = self.torch
        from repro_torch.kernels._build import sm_count
        from repro_torch.kernels.mamba_scan import CONFIGS, mamba_scan, plan
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 10)
        dI, dS = 8192, 16
        sms = sm_count(self.dev.index or 0)
        rows = {cfg: [] for cfg in CONFIGS}
        for _, B, S, h0 in self.MAMBA_SHAPES:
            _, sets = self.mamba_sets(gen, B, S, dI, dS, h0)
            chosen = plan(dI, B, sms)[:2]
            for cfg, row in rows.items():
                ms = self.time_ms([lambda a=a: mamba_scan(*a, config=cfg)
                                   for a in sets])
                row.append(f"B{B} S{S} {ms:.4f} ms"
                           + (" (planned)" if cfg == chosen else ""))
            del sets
        for cfg, row in rows.items():
            print(f"tune mamba_scan {self.tag(cfg)}: " + ", ".join(row)
                  + f" [{self.card}]")

    # ---- phase 4 -----------------------------------------------------
    def phase_main_path(self):
        import numpy as np
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.configs import get_config
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.core.prune import clover_prune
        from repro_torch.models.transformer import forward, init_lm_params
        from repro_torch.serve import EngineConfig, greedy_reference

        cfg = get_config("gpt2-xl")
        self.reset_counts()
        marks = [("start", self.counts())]

        t0 = time.perf_counter()
        params = init_lm_params(cfg, SEED)
        n = sum(t.numel() for t in _leaves(params))
        print(f"gpt2-xl init: {n} float32 parameters on the card "
              f"({time.perf_counter() - t0:.1f} s)")
        if n != cfg.n_params():
            self.fail(f"parameter count {n} != {cfg.n_params()}")
        tokens = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (4, 1024))

        def loss(logits):
            return F.cross_entropy(
                logits[:, :-1].reshape(-1, logits.shape[-1]),
                torch.as_tensor(tokens[:, 1:], device=self.dev).reshape(-1)
            ).item()

        logits0, _ = forward(params, cfg, tokens)
        dparams, dcfg, _ = clover_decompose(params, cfg)
        del params
        logits1, _ = forward(dparams, dcfg, tokens)
        dmax = (logits1 - logits0).abs().max().item()
        lmax = logits0.abs().max().item()
        del logits0
        print(f"clover_decompose: max|dlogits| {dmax:.3e} vs 1e-3 * "
              f"max|logits| = {1e-3 * lmax:.3e}")
        if not dmax <= 1e-3 * lmax:
            self.fail("clover_decompose did not preserve the function")
        loss_full = loss(logits1)
        del logits1
        pparams, pcfg = clover_prune(dparams, dcfg, qk_ratio=0.5,
                                     vo_ratio=0.5)
        del dparams
        if (pcfg.qk_dim, pcfg.vo_dim) != (32, 32):
            self.fail(f"pruned ranks {(pcfg.qk_dim, pcfg.vo_dim)} != (32, 32)")
        logits2, _ = forward(pparams, pcfg, tokens)
        loss_pruned = loss(logits2)
        del logits2
        print(f"scoring loss on (4, 1024) random tokens: decomposed "
              f"{loss_full:.6f}, pruned 32/32 {loss_pruned:.6f}")
        marks.append(("scoring", self.counts()))

        prompts = self.main_prompts(cfg)
        runs = {}
        for name, ek in MAIN_ENGINES:
            runs[name] = self.serve_main(name, pparams, pcfg,
                                         EngineConfig(**ek), prompts)
            marks.append((name, self.counts()))

        t0 = time.perf_counter()
        refs = [greedy_reference(pparams, pcfg, p, 32) for p in prompts]
        torch.cuda.synchronize()
        print(f"greedy_reference: {len(refs)} streams in "
              f"{time.perf_counter() - t0:.1f} s")
        marks.append(("reference", self.counts()))
        for name, reqs in runs.items():
            self.compare_streams(name, reqs, refs, prompts, pparams, pcfg,
                                 forward)
        self.check_counts(marks)
        self.kv_dtype_decode(pparams, pcfg)
        self.timed(self.phase_prefix, pparams, pcfg)
        self.timed(self.phase_spec, pparams, pcfg, runs, refs)
        self.timed(self.phase_chaos, pparams, pcfg)

    def kv_dtype_decode(self, params, cfg):
        """A short dense decode (4 rows, a 64-token prefill, 8 steps) with
        the cache stored in bfloat16 and in float8_e4m3fn, and with the
        weights cast once to bfloat16 and computing in bfloat16 (its
        cache at the compute dtype), each against the same run in
        float32: ``flash_decode`` must launch on the cache as it lies
        (every launch with K in the cache's dtype and q in the compute
        dtype), and the logits stay within KV_BF16_TOL (bfloat16 cache,
        bfloat16 compute) or KV_FP8_TOL (float8 cache) x max |logits| of
        the float32 run's.  Each error, relative to max |logits|, is kept
        in ``kv_err`` (the narrow prefix runs' near-tie bounds).  Then,
        on the two bfloat16-cache runs, the path before the kernels read
        narrow caches (q, K and V cast to float32 each step, the float32
        kernel, the context cast back) patched in here only, against the
        present one (``decode_paths``)."""
        import dataclasses
        import numpy as np
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.kernels.decode_attention import flash_decode
        from repro_torch.models.transformer import (decode_step,
                                                    init_decode_state,
                                                    prefill)
        rng = np.random.default_rng(SEED + 2)
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 64)),
                                 device=self.dev)
        steps = torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 4)),
                                device=self.dev)
        runs, seen = {}, Counter()
        kernel = ops.flash_decode

        def recorded(q, k, v, *args, **kw):
            seen[(q.dtype, k.dtype)] += 1
            return kernel(q, k, v, *args, **kw)
        for name, kv, p, c in (
                ("float32", "float32", params, cfg),
                ("bfloat16 cache", "bfloat16", params, cfg),
                ("float8_e4m3fn cache", "float8_e4m3fn", params, cfg),
                ("bfloat16 compute", "bfloat16", None,
                 dataclasses.replace(cfg, param_dtype="bfloat16",
                                     compute_dtype="bfloat16"))):
            c = dataclasses.replace(c, kv_cache_dtype=kv)
            if p is None:
                p = self.bf16_weights(params)
                self.bf16_scoring(params, cfg, p, c)
            state = init_decode_state(c, 4, 128)
            seen.clear()
            ops.flash_decode = recorded
            try:
                with torch.no_grad():
                    _, state = prefill(p, c, prompt, state)
                    before = flash_decode.launches
                    logits = []
                    for tok in steps:
                        lg, state = decode_step(p, c, tok, state)
                        logits.append(lg.float())
            finally:
                ops.flash_decode = kernel
            launched = flash_decode.launches - before
            dtype = state["blocks"][0]["kv"]["k"].dtype
            runs[name] = torch.stack(logits)
            want = {(getattr(torch, c.compute_dtype), getattr(torch, kv)):
                    launched}
            print(f"kv dtype {name}: flash_decode launched {launched} "
                  f"times, (q, K) dtypes {dict(seen)}")
            if launched != len(steps) * cfg.n_layers or \
                    dtype != getattr(torch, kv) or dict(seen) != want:
                self.fail(f"{name}: cache {dtype}, flash_decode launched "
                          f"{launched} times on {dict(seen)}")
            if kv == "bfloat16":
                self.decode_paths(name, p, c, steps[0], state)
            del p, state
        ref32 = runs.pop("float32")
        lmax = ref32.abs().max().item()
        for name, got in runs.items():
            tol = KV_FP8_TOL if "float8" in name else KV_BF16_TOL
            err = (got - ref32).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= tol * lmax
            print(f"kv dtype {name} decode vs float32: max |dlogits| "
                  f"{err:.3e} = {err / lmax:.3e} x max|logits| vs {tol:g} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                self.fail(f"{name}: logits left the tolerance {tol:g}")
            self.kv_err[name] = err / lmax

    def bf16_scoring(self, params, cfg, p16, c16):
        """The bfloat16-compute model ``p16`` / ``c16`` scores (4, 1024)
        tokens through ``forward``: ``flash_attention`` must launch once a
        layer, every launch with q, K and V in bfloat16 (``forms``: no
        float32 launch), the logits within KV_BF16_TOL x max |logits| of
        the float32 model's (``params`` / ``cfg``) scoring; both losses
        printed.  Then the route before the 16-bit form (q, K and V cast
        to float32, the float32 kernel, the context rounded back; patched
        into ``ops.clover_attention`` here only) against the present one
        in turns (old, new, new, old): the forward's peak allocation
        beyond what it started with and its host ms, then one call on the
        first layer's operands: its peak allocation, which for the
        16-bit form must stay under the bytes of float32 copies of q, K
        and V, and its device ms (``time_ms``); the old route's logits
        error against float32 is printed beside the new one's."""
        import numpy as np
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ops
        from repro_torch.kernels.clover_attention import flash_attention
        from repro_torch.models.transformer import forward
        tokens = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (4, 1024))
        labels = torch.as_tensor(tokens[:, 1:], device=self.dev).reshape(-1)

        def loss(lg):
            return F.cross_entropy(lg[:, :-1].float().reshape(
                -1, lg.shape[-1]), labels).item()
        new_route = ops.clover_attention
        seen, first = Counter(), []

        def recorded(q, k, v, **kw):
            seen[(q.dtype, k.dtype, v.dtype)] += 1
            if not first:
                first.append((q, k, v, kw))
            return new_route(q, k, v, **kw)

        def old_route(q, k, v, **kw):
            return new_route(q.float().contiguous(), k.float().contiguous(),
                             v.float().contiguous(), **kw).to(q.dtype)
        with torch.no_grad():
            ref32 = forward(params, cfg, tokens)[0]
            loss32, lmax = loss(ref32), ref32.abs().max().item()
            forms0 = dict(flash_attention.forms)
            ops.clover_attention = recorded
            try:
                lg = forward(p16, c16, tokens)[0]
            finally:
                ops.clover_attention = new_route
            err = (lg.float() - ref32).abs().max().item()
            finite = bool(torch.isfinite(lg).all())
            loss16 = loss(lg)
        del lg
        grew = {f: n - forms0[f] for f, n in flash_attention.forms.items()}
        bf16 = torch.bfloat16
        ok = (grew == {"float32": 0, "bfloat16": cfg.n_layers, "float16": 0}
              and dict(seen) == {(bf16, bf16, bf16): cfg.n_layers}
              and finite and err <= KV_BF16_TOL * lmax)
        print(f"bf16 scoring (4, 1024): flash_attention launches by form "
              f"{grew}, operands {dict(seen)}; max |dlogits| {err:.3e} = "
              f"{err / lmax:.3e} x max|logits| vs {KV_BF16_TOL:g}; loss "
              f"float32 {loss32:.6f}, bfloat16 {loss16:.6f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.fail(f"bf16 scoring: launches {grew} on {dict(seen)}, "
                      f"logits error {err / lmax:.3e} x max|logits|")
        q, k, v, kw = first[0]
        copy_bytes = 4 * (q.numel() + k.numel() + v.numel())
        res, old_err = {"old": [], "new": []}, None
        for label in ("old", "new", "new", "old"):
            fn = old_route if label == "old" else new_route
            ops.clover_attention = fn
            try:
                with torch.no_grad():
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    t0 = time.perf_counter()
                    lg = forward(p16, c16, tokens)[0]
                    torch.cuda.synchronize()
                    host = (time.perf_counter() - t0) * 1e3
                    fwd = torch.cuda.max_memory_allocated() - base
                    if label == "old" and old_err is None:
                        old_err = (lg.float() - ref32).abs().max().item()
                    del lg
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    fn(q, k, v, **kw)
                    torch.cuda.synchronize()
                    call = torch.cuda.max_memory_allocated() - base
            finally:
                ops.clover_attention = new_route
            dev = self.time_ms([lambda: fn(q, k, v, **kw)])
            res[label].append(call)
            print(f"bf16 scoring, {label} route: forward peak +{fwd} bytes, "
                  f"host {host:.1f} ms; one attention call peak +{call} "
                  f"bytes (float32 copies of its q, K and V: {copy_bytes}), "
                  f"{dev:.4f} ms on the device [{self.card}]")
        del ref32
        new_peak, old_peak = max(res["new"]), min(res["old"])
        ok = new_peak < copy_bytes <= old_peak
        print(f"bf16 scoring: no float32 copy of q, K or V "
              f"{'ok' if ok else 'FAIL'} (a call's peak +{new_peak} "
              f"against the old route's +{old_peak}); the old route's "
              f"logits {old_err / lmax:.3e} x max|logits| from float32")
        if not ok:
            self.fail(f"bf16 scoring: an attention call allocated "
                      f"{new_peak} bytes, float32 copies are {copy_bytes}")
        del q, k, v, first

    def decode_paths(self, name, params, cfg, tok, state):
        """One decode step of a bfloat16-cache run on its present path
        (the kernel reads the cache as it lies) against the path before
        it (``ops.decode_attention`` patched: q, K and V cast to float32,
        the float32 kernel, the context cast to the compute dtype), in
        turns (old, new, new, old): the step's peak allocation beyond what
        it started with, which must stay under the bytes of a float32
        copy of one layer's K and V (the old path's transient), the
        step's host ms, and the device ms of the attention call alone
        over the 48 layers' caches (``time_ms``).  The step rewrites the
        same position each time."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.models.transformer import decode_step
        new_path = ops.decode_attention

        def old_path(q, k, v, lengths, **kw):
            return new_path(q.float().contiguous(), k.float(), v.float(),
                            lengths, **kw).to(q.dtype)
        # the leaves stack the layers: (layers, B, T, KV, r)
        ks, vs = state["blocks"][0]["kv"]["k"], state["blocks"][0]["kv"]["v"]
        kv = list(zip(ks, vs))
        copy_bytes = (ks[0].numel() + vs[0].numel()) * 4
        idx = int(state["index"])
        B, H = ks.shape[1], cfg.n_heads
        q = torch.randn((B, H, cfg.qk_dim), device=self.dev).to(
            getattr(torch, cfg.compute_dtype))
        lengths = torch.full((B,), idx, dtype=torch.int32, device=self.dev)
        scale = 1.0 / math.sqrt(cfg.head_dim_)
        res = {"old": [], "new": []}
        for label in ("old", "new", "new", "old"):
            fn = old_path if label == "old" else new_path
            ops.decode_attention = fn
            try:
                with torch.no_grad():
                    decode_step(params, cfg, tok, state)      # warm
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    t0 = time.perf_counter()
                    decode_step(params, cfg, tok, state)
                    torch.cuda.synchronize()
                    host = (time.perf_counter() - t0) * 1e3
                    peak = torch.cuda.max_memory_allocated() - base
            finally:
                ops.decode_attention = new_path
            dev = self.time_ms([lambda k=k, v=v: fn(
                q, k[..., :cfg.qk_dim], v[..., :cfg.vo_dim], lengths,
                scale=scale) for k, v in kv], iters=2 * len(kv))
            res[label].append((peak, host, dev))
            print(f"kv dtype {name} step, {label} path: peak +{peak} bytes "
                  f"(a float32 copy of one layer's K and V: {copy_bytes}), "
                  f"host {host:.3f} ms, attention {dev:.4f} ms a layer on "
                  f"the device [{self.card}]")
        new_peak = max(r[0] for r in res["new"])
        old_peak = min(r[0] for r in res["old"])
        ok = new_peak < copy_bytes <= old_peak
        saved = (sum(r[2] for r in res["old"])
                 - sum(r[2] for r in res["new"])) / 2
        print(f"kv dtype {name}: no float32 copy of the cache "
              f"{'ok' if ok else 'FAIL'} (peak +{new_peak} against the old "
              f"path's +{old_peak}); attention {saved:.4f} ms a layer "
              f"faster, {saved * cfg.n_layers:.4f} ms a step")
        if not ok:
            self.fail(f"{name}: a decode step allocated {new_peak} bytes, "
                      f"a float32 copy of a layer's K and V is {copy_bytes}")

    def bf16_weights(self, params):
        """``params`` with every floating leaf cast once to bfloat16."""
        from repro_torch.tree import tree_map
        return tree_map(lambda t: t.to(self.torch.bfloat16)
                        if t.is_floating_point() else t, params)

    # ---- phases 14-15: speculation and overload safety -------------------
    def pruned_gpt2(self):
        """gpt2-xl at its published width, random weights from SEED,
        decomposed and pruned 32/32, as phase 4 builds it (for ``--only``
        runs of the phases that take it)."""
        from repro_torch.configs import get_config
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.core.prune import clover_prune
        from repro_torch.models.transformer import init_lm_params
        cfg = get_config("gpt2-xl")
        dparams, dcfg, _ = clover_decompose(init_lm_params(cfg, SEED), cfg)
        return clover_prune(dparams, dcfg, qk_ratio=0.5, vo_ratio=0.5)

    def phase_spec(self, params=None, cfg=None, runs=None, refs=None):
        """Phase 14, self-speculative decoding (DESIGN.md §8) at gpt2-xl's
        full width, pruned 32/32: the main path's 8 requests on its dense
        and paged engines with ``spec_k`` 2 and 4 at ``draft_rank_ratio``
        0.5 (draft 16/16, read through the cache's row stride).  Every
        stream equals the non-speculative engine's and
        ``greedy_reference``; a divergence passes only at a near-tie (the
        draft runs the decode kernel, the verify the masked path, so the
        rounding differs), and the near-ties are counted.  At most 4 step
        shapes; ``accept_hist`` printed.  Tokens/s and ITL against the
        non-speculative dense engine in turns (spec, plain, plain, spec:
        the first spec turn is the dense k = 4 check run, served last of
        the checks).
        ``draft_rank_ratio`` 0.0 at k = 4: every round accepts k + 1
        tokens except at near-ties of the verify logits.  The counts are
        set to 0 before and read after: ``flash_decode`` and
        ``paged_flash_decode`` launch with a row stride wider than the
        width (the draft), and no plain version runs."""
        import numpy as np
        from repro_torch.core.prune import draft_ranks
        from repro_torch.kernels.decode_attention import flash_decode
        from repro_torch.kernels.paged_decode_attention import \
            paged_flash_decode
        from repro_torch.models.transformer import forward
        from repro_torch.serve import EngineConfig, greedy_reference
        if params is None:
            params, cfg = self.pruned_gpt2()
        prompts = self.main_prompts(cfg)
        if runs is None:
            runs = {name: self.serve_main(name, params, cfg,
                                          EngineConfig(**ek), prompts)
                    for name, ek in MAIN_ENGINES}
            refs = [greedy_reference(params, cfg, p, 32) for p in prompts]
        print(f"spec: draft widths {draft_ranks(cfg, 0.5)} of "
              f"{(cfg.qk_dim, cfg.vo_dim)} at draft_rank_ratio 0.5")
        self.reset_counts()
        strided0 = (flash_decode.strided_launches,
                    paged_flash_decode.strided_launches)
        ties = 0
        # paged first: the dense k = 4 run ends the checks and opens the
        # turns below
        for name, ek in reversed(MAIN_ENGINES):
            for k in (2, 4):
                tag = f"spec {name} k{k}"
                reqs = self.serve_main(tag, params, cfg, EngineConfig(
                    spec_k=k, draft_rank_ratio=0.5, **ek), prompts)
                ties += self.compare_streams(
                    tag, reqs, [r.generated for r in runs[name]], prompts,
                    params, cfg, forward, against=f"non-spec {name}")
                ties += self.compare_streams(tag, reqs, refs, prompts,
                                             params, cfg, forward)
        c = self.counts()
        grew = (flash_decode.strided_launches - strided0[0],
                paged_flash_decode.strided_launches - strided0[1])
        self.launches["draft"] = {"flash_decode": grew[0],
                                  "paged_flash_decode": grew[1]}
        print(f"spec: launches {({k: v for k, v in c.items() if v})}; "
              f"strided (draft) flash_decode {grew[0]}, paged_flash_decode "
              f"{grew[1]}")
        if min(grew) <= 0:
            self.fail("spec: the draft never read the cache through a "
                      "row stride")
        plain = {k: c[k] for k in ("attention_ref", "flash_attention_ref",
                                   "decode_attention_ref",
                                   "paged_decode_attention_ref") if c[k]}
        if plain:
            self.fail(f"spec: plain versions ran {plain}")
        # tokens/s and ITL in turns, one process, one card: (4, 0, 0, 4),
        # the first turn the dense k = 4 check run just served
        dense = dict(MAIN_ENGINES)["dense"]
        turns = [(4, *self.last_rate)]
        for k in (0, 0, 4):
            self.serve_main(f"turn dense k{k}", params, cfg, EngineConfig(
                spec_k=k, draft_rank_ratio=0.5, **dense), prompts)
            turns.append((k, *self.last_rate))
        for k in (0, 4):
            rate = [t for t in turns if t[0] == k]
            print(f"spec turns dense k{k}: tokens/s "
                  f"{', '.join(f'{t[1]:.1f}' for t in rate)}, mean ITL "
                  f"{', '.join(f'{t[2]:.2f}' for t in rate)} ms "
                  f"[{self.card}]")
        ties += self.spec_full_rank(params, cfg, prompts, refs, k=4)
        print(f"spec: {ties} near-ties met in all")

    def spec_full_rank(self, params, cfg, prompts, refs, k):
        """``draft_rank_ratio`` 0.0: the draft is the model, so every
        round accepts k + 1 tokens, except where the draft's token is
        within the near-tie bound of the verify's argmax at the first
        rejected position (the draft's decode kernel and the verify's
        masked path round differently).  -> the near-ties met."""
        import numpy as np
        from repro_torch.models.transformer import forward
        from repro_torch.serve import EngineConfig
        dense = dict(MAIN_ENGINES)["dense"]
        seen = []

        def probe(eng):
            """Keep each verify window's tokens, lengths and logits."""
            orig = eng.exe.verify_chunk

            def verify(state, tokens, lengths, pages, wfloor, aids=None):
                logits, st = orig(state, tokens, lengths, pages, wfloor,
                                  aids)
                seen.append((np.asarray(tokens), np.asarray(lengths),
                             logits.float().cpu().numpy()))
                return logits, st
            eng.exe.verify_chunk = verify

        reqs = self.serve_main(f"spec dense k{k} ratio 0.0", params, cfg,
                               EngineConfig(spec_k=k, draft_rank_ratio=0.0,
                                            **dense), prompts, hook=probe)
        full = ties = short = 0
        for tokens, lengths, logits in seen:
            for s in np.nonzero(lengths)[0]:
                drafts, row = tokens[s, 1:], logits[s]
                a = 0
                while a < k and drafts[a] == row[a].argmax():
                    a += 1
                if a == k:
                    full += 1
                    continue
                gap = float(row[a].max() - row[a][drafts[a]])
                tie = 1e-4 * float(np.abs(row[a]).max())
                if gap < tie:
                    ties += 1
                else:
                    short += 1
                    print(f"spec ratio 0.0: rejected draft at {a} with "
                          f"gap {gap:.3e} >= near-tie bound {tie:.3e}")
        print(f"spec ratio 0.0 k{k}: {full} slot-rounds accepted all "
              f"{k + 1}, {ties} stopped at a near-tie, {short} otherwise")
        if short or not full:
            self.fail("spec ratio 0.0: a full-width draft was rejected "
                      "away from a near-tie")
        return ties + self.compare_streams(
            f"spec dense k{k} ratio 0.0", reqs, refs, prompts, params, cfg,
            forward)

    @staticmethod
    def chaos_trace():
        """serve_bench scenario 6's pinned trace (``_chaos_trace``): a
        low-priority burst at step 0, high-priority waves at steps 6 and
        32, low stragglers at 30, deadlines on odd-uid lows, cancels at
        steps 8 and 34.  -> (request fields, arrival steps, cancels)."""
        import numpy as np
        rng = np.random.default_rng(CHAOS_SEED)
        specs, arrivals = [], {}
        for uid in range(CHAOS_REQUESTS):
            high = uid % 3 == 2
            specs.append(dict(
                uid=uid,
                prompt=rng.integers(0, CHAOS_VOCAB, int(rng.integers(
                    4, 13))).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 9)),
                priority=2 if high else 0,
                deadline_steps=(int(rng.integers(8, 21))
                                if not high and uid % 2 == 1 else None)))
            if high:
                arrivals[uid] = 6 if uid < 8 else 32
            else:
                arrivals[uid] = 0 if uid < 7 else 30
        return specs, arrivals, {8: 3, 34: 9}

    def phase_chaos(self, params=None, cfg=None):
        """Phase 15, overload safety (DESIGN.md §11): serve_bench
        scenario 6's pinned trace and fault plan at gpt2-xl's full width,
        pruned 32/32, on a paged engine of 3 slots over 8 pages of 8
        (``step_retries`` 1, ``quarantine_steps`` 2, ``watchdog_steps``
        32, at most 3000 steps), fault-free and under
        ``FaultPlan.chaos(20260807, 0.06)``.  Gates: the allocator is
        consistent after every step, every request is terminal, every
        DONE stream equals the fault-free uncontended replay (a dense
        4-slot engine) and every early exit is a prefix of it (near-tie
        rule), faults fired at every site the trace reaches (no prefix
        cache: alloc, step and nan), the pool is free after the drain.
        Retries, quarantines, sheds and the launches are printed."""
        import numpy as np
        from repro_torch.models.transformer import forward
        from repro_torch.serve import (DONE, Engine, EngineConfig,
                                       FaultPlan, Request)
        if params is None:
            params, cfg = self.pruned_gpt2()
        specs, arrivals, cancels = self.chaos_trace()
        prompts = [s["prompt"] for s in specs]
        self.reset_counts()
        oracle = Engine(params, cfg, EngineConfig(slots=4, max_len=64,
                                                  prefill_chunk=8))
        ref_reqs = [Request(uid=s["uid"], prompt=s["prompt"],
                            max_new_tokens=s["max_new_tokens"])
                    for s in specs]
        oracle.run(ref_reqs)
        if not all(r.status == DONE for r in ref_reqs):
            self.fail("chaos: the uncontended replay did not finish")
        want = [r.generated for r in ref_reqs]
        for mode, plan in (("nofault", None),
                           ("faulted", FaultPlan.chaos(CHAOS_SEED,
                                                       CHAOS_INTENSITY))):
            eng = Engine(params, cfg, EngineConfig(
                slots=3, max_len=64, prefill_chunk=8, paged=True,
                page_tokens=8, n_pages=CHAOS_POOL_PAGES, step_retries=1,
                quarantine_steps=2, watchdog_steps=32), faults=plan)
            reqs = [Request(**s) for s in specs]
            pending = sorted(reqs, key=lambda r: (arrivals[r.uid], r.uid))
            bad = []
            self.sync()
            t0 = time.perf_counter()
            step = 0
            while step < CHAOS_MAX_STEPS:
                while pending and arrivals[pending[0].uid] <= step:
                    eng.submit(pending.pop(0))
                if step in cancels:
                    eng.cancel(cancels[step])
                eng.step()
                try:
                    eng.alloc.assert_consistent(context=f"step {step}")
                except AssertionError as e:
                    bad.append(str(e))
                step += 1
                if not pending and not eng.sched.busy:
                    break
            self.sync()
            wall = time.perf_counter() - t0
            st = eng.stats()
            c = st["counters"]
            n_tok = sum(len(r.generated) for r in reqs)
            statuses = dict(sorted(Counter(
                r.status for r in reqs).items()))
            print(f"chaos {mode}: {step} steps, {n_tok} tokens in "
                  f"{wall:.2f} s, statuses {statuses}, preemptions "
                  f"{eng.sched.preemptions}, requeues {eng.sched.requeues}, "
                  f"retries {c.get('retries', 0)}, faults recovered "
                  f"{c.get('faults_recovered', 0)}, quarantines "
                  f"{c.get('quarantines', 0)}, watchdog sheds "
                  f"{eng.watchdog_sheds}, faults injected "
                  f"{st.get('faults_injected', {})} [{self.card}]")
            if bad:
                self.fail(f"chaos {mode}: allocator inconsistent: "
                          f"{bad[0]}")
            if not (all(r.done for r in reqs)
                    and eng.metrics.n_terminal == len(reqs)):
                self.fail(f"chaos {mode}: requests not all terminal")
            if eng.alloc.free_pages != eng.alloc.n_pages:
                self.fail(f"chaos {mode}: {eng.alloc.free_pages} of "
                          f"{eng.alloc.n_pages} pages free after the drain")
            self.compare_streams(
                f"chaos {mode}", reqs, want, prompts, params, cfg, forward,
                against="the uncontended replay",
                partial={r.uid for r in reqs if r.status != DONE})
            if mode == "nofault" and not (c.get("shed", 0)
                                          + c.get("timed_out", 0)
                                          + c.get("cancelled", 0)):
                self.fail("chaos: the trace exercised no overload policy")
            if plan is not None:
                fired = plan.summary()
                if not all(fired[s] > 0 for s in ("alloc", "step", "nan")):
                    self.fail(f"chaos: a reachable site never fired "
                              f"{fired}")
                if not c.get("retries", 0) + c.get("quarantines", 0):
                    self.fail("chaos: no recovery exercised")
        c = self.counts()
        print(f"chaos: launches {({k: v for k, v in c.items() if v})}")
        if c["paged_flash_decode"] <= 0 or any(
                c[k] for k in ("attention_ref", "flash_attention_ref",
                               "decode_attention_ref",
                               "paged_decode_attention_ref")):
            self.fail("chaos: the paged decode kernel did not run, or a "
                      "plain version did")

    # ---- phase 16: multi-tenant SV adapters ----------------------------
    def phase_adapters(self):
        """Phase 16, multi-tenant SV adapters (DESIGN.md §13): serve_bench
        scenario 8 at gpt2-xl's full width (48 layers, d_model 1600, 25
        heads of 64, vocab 50257), random weights from SEED, decomposed
        with ``clover_decompose(peft=True)`` and unpruned.  Tenant 0 is
        the identity, tenant 1 the scales of 4 CLOVER-S steps on the
        model, tenant 2 scenario 8's uniform(0.8, 1.25) scales.  The
        phase frees what it allocates."""
        import gc
        import numpy as np
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.core.peft import AdapterRegistry
        from repro_torch.models.transformer import init_lm_params

        gc.collect()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        print(f"adapters start: memory_allocated {mem0 / 1e9:.3f} GB")
        cfg = get_config("gpt2-xl")
        dp, dcfg, _ = clover_decompose(init_lm_params(cfg, SEED), cfg,
                                       peft=True)
        reg = AdapterRegistry(dp)
        reg.register(reg.scales_from_finetuned(self.adapter_finetune(
            dp, dcfg)))
        arng = np.random.default_rng(ADAPTER_SEED)
        reg.register(tuple(
            {k: arng.uniform(0.8, 1.25, tuple(v.shape)).astype(np.float32)
             for k, v in entry.items()} for entry in reg.get(0)))
        for aid in range(1, len(reg)):
            dev1 = max(float((v - 1).abs().max()) for e in reg.get(aid)
                       for v in e.values())
            print(f"adapters tenant {aid}: max |scale - 1| {dev1:.4e}")
        self.adapter_identity_bitwise(dp, dcfg, reg)
        self.adapter_serve(dp, dcfg, reg)
        del dp, reg
        gc.collect()
        torch.cuda.empty_cache()
        mem1 = torch.cuda.memory_allocated()
        print(f"adapters end: memory_allocated {mem1 / 1e9:.3f} GB")
        if mem1 > mem0 + 1e8:
            self.fail(f"adapters: {mem1 / 1e9:.3f} GB still allocated")

    def adapter_finetune(self, dp, dcfg):
        """4 CLOVER-S steps of phase 11's trainer on phase 11's (2, 1024)
        batches, on the decomposed model (the step is functional: ``dp``
        stays as it was) -> the trained ``sv_extract`` diagonals; the
        trained copy and its optimizer state are freed."""
        from repro_torch.core.peft import sv_extract
        from repro_torch.data import SyntheticConfig, SyntheticLM
        from repro_torch.train import make_opt_state
        data = SyntheticLM(SyntheticConfig(vocab_size=dcfg.vocab_size,
                                           seq_len=1024, global_batch=2,
                                           seed=SEED))
        (tuned, opt), _ = self.run_steps(
            "adapter tenant 1 CLOVER-S",
            self.trainer(dcfg, True, peft_mode=True, lr=5e-3),
            (dp, make_opt_state(dp, peft_mode=True)),
            [data.batch_at(4 + i) for i in range(4)], 2 * 1024)
        diags = sv_extract(tuned)
        del tuned, opt
        return diags

    def adapter_identity_bitwise(self, dp, dcfg, reg):
        """A chunk step and a decode step on a dense state of 3 slots,
        with the all-ones adapter tree and without one: logits and caches
        bit for bit equal (``x * 1.0 == x``)."""
        import numpy as np
        torch = self.torch
        from repro_torch.models.transformer import (decode_step,
                                                    init_decode_state,
                                                    prefill_chunk)
        from repro_torch.serve.executor import _select_adapters
        B = 3
        toks = torch.as_tensor(np.random.default_rng(SEED + 16).integers(
            0, dcfg.vocab_size, (B, 9)), device=self.dev)
        ones = _select_adapters(reg.bank(), torch.zeros(
            B, dtype=torch.long, device=self.dev))
        runs = []
        for adapters in (None, ones):
            st = init_decode_state(dcfg, B, ADAPTER_MAX_LEN, device=self.dev)
            st["index"] = torch.zeros(B, dtype=torch.int32, device=self.dev)
            chunk, st = prefill_chunk(dp, dcfg, toks[:, :8], st, torch.full(
                (B,), 8, dtype=torch.int32, device=self.dev),
                adapters=adapters)
            dec, st = decode_step(dp, dcfg, toks[:, 8], st,
                                  adapters=adapters)
            runs.append((chunk, dec, [st["blocks"][0]["kv"][k]
                                      for k in ("k", "v")]))
        (c0, d0, kv0), (c1, d1, kv1) = runs
        ok = (torch.equal(c0, c1) and torch.equal(d0, d1)
              and all(torch.equal(a, b) for a, b in zip(kv0, kv1)))
        print(f"adapters identity tree: chunk and decode_step logits and "
              f"caches bit for bit those without an adapter: {ok}")
        if not ok:
            self.fail("adapters: the identity adapter changed the logits")

    def adapter_trace(self, cfg, n):
        """serve_bench scenario 8's trace (``_scenario_adapters``): waves
        of one request per tenant (``n`` tenants), a page-aligned system
        prompt shared by all with a tail of 3 + id tokens -> (system
        prompt, request fields in uid order, arrival steps)."""
        import numpy as np
        sys_prompt = ((np.arange(ADAPTER_SYS_TOKENS, dtype=np.int32) * 5
                       + 2) % cfg.vocab_size).astype(np.int32)
        specs, arrivals = [], {}
        for wave in range(ADAPTER_WAVES):
            for aid in range(n):
                uid = wave * n + aid
                tail = ((np.arange(3 + aid, dtype=np.int32) + 7 * (uid + 1))
                        % cfg.vocab_size).astype(np.int32)
                specs.append(dict(uid=uid, adapter_id=aid, prompt=np.concatenate(
                    [sys_prompt, tail]).astype(np.int32)))
                arrivals[uid] = wave * ADAPTER_WAVE_GAP
        return sys_prompt, specs, arrivals

    def adapter_run(self, tag, params, cfg, ecfg, reg, specs, arrivals,
                    ids=True):
        """Scenario 8's trace runner (``_adapter_trace``): an engine with (or,
        ``reg=None``, without) the registry, warmed by one short request,
        its per-tenant counters cleared, then the requests submitted at
        their arrival steps and the engine stepped until drained (idle
        steps between the waves included in the wall).  ``ids``: each
        request names its tenant, else every id is 0.  -> (engine,
        requests in uid order, (tokens/s, mean ITL ms))."""
        import numpy as np
        from repro_torch.serve import Engine, Request
        eng = Engine(params, cfg, ecfg, adapters=reg)
        eng.run([Request(uid=-1, prompt=specs[0]["prompt"][:3],
                         max_new_tokens=2)])
        eng.adapter_tokens.clear()
        eng.adapter_done.clear()
        reqs = [Request(uid=s["uid"], prompt=s["prompt"],
                        max_new_tokens=ADAPTER_MAX_NEW,
                        adapter_id=s["adapter_id"] if ids else 0)
                for s in specs]
        due = sorted(reqs, key=lambda r: (arrivals[r.uid], r.uid))
        self.sync()
        t0 = time.perf_counter()
        step = 0
        while due or eng.sched.busy:
            while due and arrivals[due[0].uid] <= step:
                eng.submit(due.pop(0))
            eng.step()
            step += 1
        self.sync()
        wall = time.perf_counter() - t0
        n_tok = sum(len(r.generated) for r in reqs)
        itl = 1e3 * float(np.mean([d for r in reqs
                                   for d in np.diff(r.token_times)]))
        print(f"engine adapters {tag}: {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} tokens/s, mean ITL {itl:.2f} ms, {step} "
              f"steps, compiled shapes {eng.compiled_shapes()}"
              + (f", accepted per round {eng.accepted_per_round:.3f}"
                 if ecfg.spec_k else "") + f" [{self.card}]")
        return eng, reqs, (n_tok / wall, itl)

    def adapter_serve(self, dp, dcfg, reg):
        """The trace on dense, paged and paged + prefix-cache engines at
        spec_k 0 and 2, with the registry and without it (every id 0),
        against ``greedy_reference`` on each tenant's folded model."""
        from repro_torch.kernels.decode_attention import flash_decode
        from repro_torch.kernels.paged_decode_attention import \
            paged_flash_decode
        from repro_torch.models.transformer import forward
        from repro_torch.serve import EngineConfig, greedy_reference
        n = len(reg)
        sys_prompt, specs, arrivals = self.adapter_trace(dcfg, n)
        folded = {aid: dp if aid == 0 else reg.folded(dp, aid)
                  for aid in range(n)}
        t0 = time.perf_counter()
        refs = {s["uid"]: greedy_reference(folded[s["adapter_id"]], dcfg,
                                           s["prompt"], ADAPTER_MAX_NEW)
                for s in specs}
        self.sync()
        print(f"greedy_reference (folded tenants): {len(refs)} streams in "
              f"{time.perf_counter() - t0:.1f} s")
        base = dict(slots=n, max_len=ADAPTER_MAX_LEN,
                    prefill_chunk=ADAPTER_CHUNK)
        paged = dict(base, paged=True, page_tokens=ADAPTER_PAGE_TOKENS,
                     n_pages=ADAPTER_POOL_PAGES)
        layouts = {"dense": base, "paged": paged,
                   "paged_prefix": dict(paged, prefix_cache=True)}
        kern = {"dense": flash_decode, "paged": paged_flash_decode,
                "paged_prefix": paged_flash_decode}
        self.reset_counts()
        launches = {"flash_decode": 0, "paged_flash_decode": 0}
        strided = dict(launches)
        want_done = {a: ADAPTER_WAVES for a in range(n)}
        want_tok = {a: ADAPTER_WAVES * ADAPTER_MAX_NEW for a in range(n)}
        for layout, kw in layouts.items():
            for k in (0, 2):
                tag = f"{layout} k{k}"
                ecfg = EngineConfig(spec_k=k, draft_rank_ratio=DRAFT_RATIO,
                                    **kw)
                kn = kern[layout].__name__
                l0, s0 = kern[layout].launches, kern[layout].strided_launches
                eng, reqs, rate = self.adapter_run(tag, dp, dcfg, ecfg, reg,
                                                   specs, arrivals)
                grew = (kern[layout].launches - l0,
                        kern[layout].strided_launches - s0)
                launches[kn] += grew[0]
                strided[kn] += grew[1]
                if grew[0] <= 0 or (k and grew[1] <= 0):
                    self.fail(f"adapters {tag}: {kn} launched {grew[0]} "
                              f"times, {grew[1]} strided")
                for aid in range(n):
                    sub = [r for r in reqs if r.adapter_id == aid]
                    self.compare_streams(
                        f"adapters {tag} tenant {aid}", sub,
                        [refs[r.uid] for r in sub],
                        [r.prompt for r in sub], folded[aid], dcfg, forward,
                        against="greedy_reference on the folded tenant")
                st = eng.stats()
                print(f"adapters {tag}: adapter_done {st['adapter_done']}, "
                      f"adapter_tokens {st['adapter_tokens']}")
                if (st["adapter_done"] != want_done
                        or st["adapter_tokens"] != want_tok):
                    self.fail(f"adapters {tag}: per-tenant stats")
                if layout == "paged_prefix":
                    self.adapter_trie(tag, eng, reqs, sys_prompt, arrivals)
                shapes = eng.compiled_shapes()
                del eng
                plain, preqs, prate = self.adapter_run(
                    f"{tag} no registry", dp, dcfg, ecfg, None, specs,
                    arrivals, ids=False)
                print(f"adapters {tag}: compiled shapes {shapes} with the "
                      f"registry, {plain.compiled_shapes()} without")
                if shapes != plain.compiled_shapes():
                    self.fail(f"adapters {tag}: the registry changed the "
                              "step shapes")
                del plain
                if k == 0:
                    ident, ireqs, _ = self.adapter_run(
                        f"{tag} identity only", dp, dcfg, ecfg, reg, specs,
                        arrivals, ids=False)
                    del ident
                    same = ([r.generated for r in ireqs]
                            == [r.generated for r in preqs])
                    print(f"adapters {tag}: identity-only traffic streams "
                          f"equal the adapter-free engine's: {same}")
                    if not same:
                        self.fail(f"adapters {tag}: identity traffic "
                                  "diverged from the adapter-free engine")
                if layout == "dense" and k == 0:
                    turns = [("registry", rate), ("plain", prate)]
                    for name, r in (("plain", None), ("registry", reg)):
                        e, _, t = self.adapter_run(
                            f"turn {tag} {name}", dp, dcfg, ecfg, r, specs,
                            arrivals, ids=r is not None)
                        del e
                        turns.append((name, t))
                    for name in ("registry", "plain"):
                        got = [t for nm, t in turns if nm == name]
                        print(f"adapters turns {tag} {name}: tokens/s "
                              f"{', '.join(f'{t[0]:.1f}' for t in got)}, "
                              f"mean ITL {', '.join(f'{t[1]:.2f}' for t in got)}"
                              f" ms [{self.card}]")
        c = self.counts()
        plain_ran = {k: v for k, v in c.items() if k.endswith("_ref") and v}
        if plain_ran:
            self.fail(f"adapters: plain versions ran {plain_ran}")
        self.launches["adapters"] = {"launches": launches,
                                     "strided": strided}
        print(f"adapters: launches {launches}, strided (draft) {strided}")

    def adapter_trie(self, tag, eng, reqs, sys_prompt, arrivals):
        """Each tenant cached the shared system prompt under its own key
        (tenant 0 in the plain namespace) on pages no other tenant holds,
        and every later-wave request hit its own tenant's pages."""
        n = len(eng.adapters)
        psets = [set(eng.prefix.match(sys_prompt, extra=(a,) if a else ()))
                 for a in range(n)]
        disjoint = all(psets[i].isdisjoint(psets[j]) for i in range(n)
                       for j in range(i + 1, n))
        hits = [r.cached_tokens for r in reqs if arrivals[r.uid] > 0]
        print(f"adapters {tag}: cached system-prompt pages per tenant "
              f"{[len(p) for p in psets]}, pairwise disjoint {disjoint}, "
              f"later-wave cached tokens {hits}")
        if not (all(psets) and disjoint and all(h > 0 for h in hits)):
            self.fail(f"adapters {tag}: tenant prefix isolation")

    def spec_tiny(self, params, cfg, data):
        """serve_bench scenario 3's gate on the tiny GPT-2 pretrained in
        phase 12: pruned 0.5, its draft at ``draft_rank_ratio`` 0.5 must
        accept more than 1 token per round on average at k = 4 (random
        weights cannot be held to it), over 8 prompts of 3-19 tokens from
        the held-out data stream, 8 new tokens each, with every stream
        equal to the non-speculative engine's (near-tie rule)."""
        import numpy as np
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.core.prune import clover_prune
        from repro_torch.models.transformer import forward
        from repro_torch.serve import EngineConfig
        dparams, dcfg, _ = clover_decompose(params, cfg)
        pparams, pcfg = clover_prune(dparams, dcfg, qk_ratio=0.5,
                                     vo_ratio=0.5)
        rng = np.random.default_rng(SEED)
        rows = data.batch_at(20_000)["tokens"]
        prompts = [np.asarray(rows[i][:int(rng.integers(3, 20))], np.int32)
                   for i in range(8)]
        ek = dict(slots=4, max_len=64, prefill_chunk=8)
        base = self.serve_main("tiny dense", pparams, pcfg,
                               EngineConfig(**ek), prompts, new=8)
        kept = []
        reqs = self.serve_main("tiny spec k4", pparams, pcfg, EngineConfig(
            spec_k=4, draft_rank_ratio=0.5, **ek), prompts, new=8,
            hook=kept.append)
        eng = kept.pop()
        self.compare_streams("tiny spec k4", reqs,
                             [r.generated for r in base], prompts, pparams,
                             pcfg, forward, against="non-spec dense")
        print(f"tables spec: pruned {pcfg.qk_dim}/{pcfg.vo_dim}, draft "
              f"{eng.exe.draft_rank}, accepted per round "
              f"{eng.accepted_per_round:.3f} (gate > 1), accept_hist "
              f"{dict(sorted(eng.accept_hist.items()))}")
        return {"spec_k4_accepts_more_than_one": eng.accepted_per_round > 1}

    @staticmethod
    def main_prompts(cfg):
        """The main path's 8 prompts (16-400 tokens), from SEED + 1."""
        import numpy as np
        rng = np.random.default_rng(SEED + 1)
        return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in (16, 400, 57, 233, 120, 310, 31, 180)]

    def serve_main(self, name, params, cfg, ecfg, prompts, steps=None,
                   new=32, hook=None):
        """Serve the prompts (``new`` tokens each) on a fresh engine,
        print tokens/s and mean ITL, check shapes (2; with speculation at
        most 4) and completion; -> the requests.  ``steps``: a dict that
        gets the engine's chunk and decode step counts; ``hook(engine)``
        runs before the first step.  Its tokens/s and mean ITL (ms) are
        kept as ``self.last_rate``; the engine is not kept (it holds the
        served weights)."""
        import numpy as np
        from repro_torch.serve import DONE, Engine, Request
        eng = Engine(params, cfg, ecfg)
        if hook is not None:
            hook(eng)
        if steps is not None:
            for kind, attr in (("chunk", "prefill_chunk"),
                               ("decode", "decode_step")):
                def counted(*args, _f=getattr(eng.exe, attr), _k=kind):
                    steps[_k] += 1
                    return _f(*args)
                setattr(eng.exe, attr, counted)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
        self.sync()
        t0 = time.perf_counter()
        eng.run(reqs)
        self.sync()
        wall = time.perf_counter() - t0
        self.last_wall = wall
        n_tok = sum(len(r.generated) for r in reqs)
        itl = [d for r in reqs for d in np.diff(r.token_times)]
        self.last_rate = (n_tok / wall, 1e3 * float(np.mean(itl)))
        spec = (f", spec rounds {eng.spec_rounds}, accepted per round "
                f"{eng.accepted_per_round:.3f}, accept_hist "
                f"{dict(sorted(eng.accept_hist.items()))}"
                if ecfg.spec_k else "")
        print(f"engine {name}: {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} tokens/s, mean ITL "
              f"{1e3 * float(np.mean(itl)):.2f} ms, {eng.steps} steps, "
              f"preemptions {eng.sched.preemptions}, compiled shapes "
              f"{eng.compiled_shapes()}{spec} [{self.card}]")
        if not (eng.compiled_shapes() == 2 or ecfg.spec_k
                and 2 < eng.compiled_shapes() <= 4):
            self.fail(f"{name}: compiled_shapes {eng.compiled_shapes()}")
        if ecfg.spec_k and eng.spec_rounds < 1:
            self.fail(f"{name}: no speculative round ran")
        if not all(r.status == DONE for r in reqs):
            self.fail(f"{name}: requests left unfinished")
        if ecfg.paged and not ecfg.spec_k and eng.sched.preemptions < 1:
            self.fail(f"{name}: the undersized pool never preempted")
        return reqs

    # ---- phase 11 ----------------------------------------------------
    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    @staticmethod
    def beside(ranks, refs):
        """``ranks()`` -- spawned ranks, which this process only waits
        for -- on a thread while ``refs()`` (the one-rank references of
        the same runs) runs here; -> (ranks' result, refs' result), and
        ``ranks``'s exception raised here.  The checks are those of the
        two run one after the other; only the wall is shared."""
        import threading
        box = {}

        def run():
            try:
                box["ranks"] = ranks()
            except BaseException as exc:    # re-raised in this thread
                box["error"] = exc
        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        try:
            out = refs()
        finally:
            worker.join()
        if "error" in box:
            raise box["error"]
        return box["ranks"], out

    def peak_gb(self):
        torch = self.torch
        return (torch.cuda.max_memory_allocated() / 1e9
                if self.dev.type == "cuda" else float("nan"))

    def reset_peak(self):
        if self.dev.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats()

    def run_steps(self, name, step, state, batches, tokens_per_step,
                  on_step=None):
        """Run ``step(*state, batch) -> (*state, metrics)`` over the
        batches; print host ms (until the call returns: the launches
        queued), device ms (CUDA events around the call), training
        tokens/s and peak memory per step; ``on_step(i, state)`` after
        each.  -> (final state, metrics of each step)."""
        torch = self.torch
        cuda = self.dev.type == "cuda"
        mets = []
        for i, batch in enumerate(batches):
            self.sync()
            self.reset_peak()
            if cuda:
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
            t0 = time.perf_counter()
            *state, m = step(*state, batch)
            host = 1e3 * (time.perf_counter() - t0)
            if cuda:
                e1.record()
            self.sync()
            wall = 1e3 * (time.perf_counter() - t0)
            dev_ms = e0.elapsed_time(e1) if cuda else wall
            m = {k: float(v) for k, v in m.items()}
            mets.append(m)
            shown = " ".join(f"{k} {m[k]:.6f}" for k in
                             ("loss", "grad_norm", "lr_scale") if k in m)
            print(f"train {name} step {i + 1}: {shown}; host "
                  f"{host:.1f} ms, device {dev_ms:.1f} ms, "
                  f"{tokens_per_step / (dev_ms / 1e3):.0f} training "
                  f"tokens/s, peak {self.peak_gb():.2f} GB [{self.card}]")
            if not all(math.isfinite(v) for v in m.values()):
                self.fail(f"train {name} step {i + 1}: non-finite {m}")
            if on_step is not None:
                on_step(i, state)
        return tuple(state), mets

    def leaves_moved(self, name, before, after, only=None):
        """Every leaf differs (``only``: the leaves whose path holds one
        of these keys differ, every other leaf is bitwise equal)."""
        from repro_torch.tree import tree_leaves_with_path
        torch = self.torch
        b = dict(tree_leaves_with_path(before))
        moved, still, bad = 0, 0, []
        for path, leaf in tree_leaves_with_path(after):
            changed = not torch.equal(leaf, b[path])
            should = only is None or any(f"['{k}']" in path for k in only)
            moved += changed
            still += not changed
            if changed != should:
                bad.append(path)
        print(f"train {name}: {moved} leaves moved, {still} bitwise "
              f"unchanged")
        if bad:
            self.fail(f"train {name}: leaves {bad[:4]} ... ({len(bad)}) "
                      f"{'did not move' if only is None else 'wrong'}")

    def logits_close(self, name, got, want, tol=1e-3):
        err = (got - want).abs().max().item()
        lmax = want.abs().max().item()
        ok = err <= tol * lmax
        print(f"{name}: max|dlogits| {err:.3e} vs {tol:g} x max|logits| = "
              f"{tol * lmax:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.fail(f"{name}: logits moved")

    def phase_train(self, cfg=None, seq=1024):
        """Phase 11: training at gpt2-xl's full width (48 layers,
        d_model 1600, 25 heads of 64, vocab 50257; ``cfg`` defaults to
        it), seed 0, ``SyntheticLM`` batches of (2, ``seq``) tokens: full
        fine-tuning with remat (and two steps without, for their time and
        memory), CLOVER-S, ``merge_clover``, the merged model pruned 32/32
        and served, LoRA / DoRA / PiSSA at r = 16.  Each part is a method
        of its own, so that what it allocates is freed when it returns;
        the phase ends with the card as empty as it found it."""
        import gc
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core.peft import count_params
        from repro_torch.data import SyntheticConfig, SyntheticLM
        from repro_torch.models.transformer import init_lm_params

        cfg = cfg or get_config("gpt2-xl")
        B, S = 2, seq
        data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size,
                                           seq_len=S, global_batch=B,
                                           seed=SEED))
        gc.collect()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        print(f"train start: memory_allocated {mem0 / 1e9:.3f} GB")
        self.reset_counts()
        params = init_lm_params(cfg, SEED)
        n_base = count_params(params)
        print(f"train gpt2-xl: {n_base} float32 parameters, batches "
              f"({B}, {S}) from SyntheticLM seed {SEED}")
        box = [params]
        del params
        params = self.train_full(box, cfg, data, B * S)
        merged, mcfg = self.train_clover_s(params, cfg, data, B * S, n_base)
        del params
        gc.collect()
        self.train_serve(merged, mcfg, cfg)
        for method, alpha, lr in (("lora", 16.0, 2e-3), ("dora", 16.0, 2e-3),
                                  ("pissa", 1.0, 1e-4)):
            self.train_adapter_arm(method, alpha, lr, merged, cfg, data,
                                   B * S)
        del merged
        gc.collect()
        torch.cuda.empty_cache()
        mem1 = torch.cuda.memory_allocated()
        print(f"train end: memory_allocated {mem1 / 1e9:.3f} GB")
        if mem1 > mem0 + 1e8:
            self.fail(f"train: {mem1 / 1e9:.3f} GB still allocated")

    def trainer(self, cfg, remat, peft_mode=False, lr=1e-4):
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import TrainConfig, make_train_step
        return make_train_step(cfg, TrainConfig(
            optimizer=AdamWConfig(lr=lr), warmup_steps=2, total_steps=4,
            remat=remat, peft_mode=peft_mode))

    def train_full(self, box, cfg, data, tokens):
        """2 steps without remat from the initial parameters (outputs
        dropped: the first warms the card up, the second is the steady
        step), then 4 full fine-tune steps with remat, whose step 1 must
        give the no-remat step 1's loss and gradient norm; step 1 (lr 0)
        moves no leaf, step 2 moves every leaf; the training attention is
        the plain one (forward + recompute per layer and step: the
        chunked one beyond ``ATTN_CHUNK`` tokens, ``attention_ref``
        within), no kernel.  ``box``: [initial params], emptied.  -> the
        trained params."""
        from repro_torch.models.layers import _causal_attention_chunked
        from repro_torch.train import make_opt_state
        held = {0: box.pop()}
        dropped, m_plain = self.run_steps(
            "full no-remat", self.trainer(cfg, False),
            (held[0], make_opt_state(held[0])),
            [data.batch_at(0), data.batch_at(1)], tokens)
        del dropped
        c0 = self.counts()
        chunked0 = _causal_attention_chunked.calls

        def moved(i, state):
            # lr_scale is 0 at step 1: nothing moves; every leaf at step 2
            if i == 0:
                self.leaves_moved("full step 1 (lr 0)", held.pop(0),
                                  state[0], only=())
                held[1] = state[0]
            elif i == 1:
                self.leaves_moved("full step 2", held.pop(1), state[0])
        box = [(held[0], make_opt_state(held[0]))]
        (params, _), mets = self.run_steps(
            "full remat", self.trainer(cfg, True), box.pop(),
            [data.batch_at(i) for i in range(4)], tokens, on_step=moved)
        c1 = self.counts()
        for k in ("loss", "grad_norm"):
            a, b = m_plain[0][k], mets[0][k]
            print(f"train remat vs no-remat step 1 {k}: {b:.7f} vs {a:.7f}")
            if not abs(a - b) <= 1e-5 * abs(a):
                self.fail(f"train: remat changed step 1's {k}")
        ref_calls = c1["attention_ref"] - c0["attention_ref"]
        chunked = _causal_attention_chunked.calls - chunked0
        flash = c1["flash_attention"] - c0["flash_attention"]
        print(f"train full: attention_ref {ref_calls} calls, chunked plain "
              f"attention {chunked} calls, flash_attention {flash} "
              "launches in 4 steps")
        if flash or ref_calls + chunked != 4 * 2 * cfg.n_layers:
            self.fail("train: the training attention is not the plain path "
                      "(forward + remat recompute per layer and step)")
        return params

    def train_clover_s(self, params, cfg, data, tokens, n_base):
        """``clover_decompose(peft=True)`` (logits kept), 4 CLOVER-S steps
        (only s_qk, s_vo and up_t move, every other leaf bitwise equal,
        no kernel under grad), ``merge_clover`` (logits kept, the base's
        parameter count).  -> (merged params, cfg)."""
        import gc
        from repro_torch.core.decompose import clover_decompose, merge_clover
        from repro_torch.core.peft import count_params
        from repro_torch.models.transformer import forward
        from repro_torch.train import make_opt_state
        tok = data.batch_at(100)["tokens"]
        base_logits, _ = forward(params, cfg, tok)
        dparams, dcfg, _ = clover_decompose(params, cfg, peft=True)
        del params
        gc.collect()
        logits, _ = forward(dparams, dcfg, tok)
        self.logits_close("train clover_decompose(peft=True)", logits,
                          base_logits)
        del base_logits, logits
        opt = make_opt_state(dparams, peft_mode=True)
        print(f"train CLOVER-S: {count_params(opt['m'])} trainable "
              f"parameters (s_qk, s_vo, up_t) of {count_params(dparams)}")
        c0 = self.counts()
        (sparams, _), _ = self.run_steps(
            "CLOVER-S", self.trainer(dcfg, True, peft_mode=True, lr=5e-3),
            (dparams, opt), [data.batch_at(4 + i) for i in range(4)], tokens)
        if self.counts()["flash_attention"] != c0["flash_attention"]:
            self.fail("train CLOVER-S launched flash_attention under grad")
        self.leaves_moved("CLOVER-S", dparams, sparams,
                          only=("s_qk", "s_vo", "up_t"))
        del dparams, opt
        logits, _ = forward(sparams, dcfg, tok)
        merged, mcfg = merge_clover(sparams, dcfg)
        del sparams
        gc.collect()
        mlogits, _ = forward(merged, mcfg, tok)
        self.logits_close("train merge_clover", mlogits, logits)
        n_merged = count_params(merged)
        print(f"train merge_clover: {n_merged} parameters (base {n_base})")
        if n_merged != n_base:
            self.fail("merge_clover changed the parameter count")
        return merged, mcfg

    def train_serve(self, merged, mcfg, cfg):
        """The fine-tuned, merged model decomposed, pruned 32/32 and
        served: the main path's first 4 requests on a dense engine, every
        stream equal to ``greedy_reference`` (near-tie rule), on the
        kernels only."""
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.core.prune import clover_prune
        from repro_torch.models.transformer import forward
        from repro_torch.serve import EngineConfig, greedy_reference
        pd, pdcfg, _ = clover_decompose(merged, mcfg)
        pp, pcfg = clover_prune(pd, pdcfg, qk_ratio=0.5, vo_ratio=0.5)
        del pd
        prompts = self.main_prompts(cfg)[:4]
        c0 = self.counts()
        reqs = self.serve_main("train merged+pruned dense", pp, pcfg,
                               EngineConfig(**MAIN_ENGINES[0][1]), prompts)
        refs = [greedy_reference(pp, pcfg, p, 32) for p in prompts]
        self.compare_streams("train merged+pruned dense", reqs, refs,
                             prompts, pp, pcfg, forward)
        c1 = self.counts()
        grew = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
        print(f"train serve: launches {grew}")
        if grew.get("flash_decode", 0) <= 0 or \
                grew.get("flash_attention", 0) <= 0 or any(
                    k.endswith("_ref") for k in grew):
            self.fail("train serve: not on the kernels")

    def train_adapter_arm(self, method, alpha, lr, base, cfg, data, tokens):
        """One LoRA / DoRA / PiSSA arm at r = 16 on ``base``: at init LoRA
        materializes to the base bit for bit and PiSSA's residual +
        materialize to within 1e-5 relative; then 2 adapter steps with
        remat."""
        torch = self.torch
        from repro_torch.core import peft
        from repro_torch.optim import AdamWConfig, adamw_init
        from repro_torch.train import make_adapter_step
        from repro_torch.tree import tree_leaves_with_path
        pc = peft.PeftConfig(method=method, rank=16, alpha=alpha)
        gen = torch.Generator(device=self.dev).manual_seed(42)
        t0 = time.perf_counter()
        ad = peft.init_adapters(base, pc, gen)
        frozen = (peft.pissa_residual(base, ad, pc) if method == "pissa"
                  else base)
        self.sync()
        init_s = time.perf_counter() - t0
        eff = peft.materialize(frozen, ad, pc)
        worst = 0.0
        for (path, got), (_, want) in zip(tree_leaves_with_path(eff),
                                          tree_leaves_with_path(base)):
            if method == "lora" and not torch.equal(got, want):
                self.fail(f"lora init: {path} differs from the base")
            worst = max(worst, ((got - want).abs().max() /
                                want.abs().max()).item())
        del eff
        print(f"train {method} r=16: {peft.count_params(ad)} trainable "
              f"parameters, init {init_s:.1f} s, materialize at init vs "
              f"base: max rel {worst:.3e}"
              + (" (bitwise)" if method == "lora" else
                 " (limit 1e-5)" if method == "pissa" else ""))
        if method == "pissa" and worst > 1e-5:
            self.fail("pissa: residual + materialize is not the base")
        step = make_adapter_step(cfg, pc, frozen,
                                 AdamWConfig(lr=lr, weight_decay=0.0),
                                 remat=True)

        def adapter_step(ad, opt, batch):
            ad, opt, loss = step(ad, opt, batch["tokens"], batch["labels"])
            return ad, opt, {"loss": loss}
        self.run_steps(method, adapter_step, (ad, adamw_init(ad)),
                       [data.batch_at(8 + i) for i in range(2)], tokens)

    # ---- phase 12 ----------------------------------------------------
    # benchmarks/common.py's testbed, rebuilt on the port
    TABLE1_RATIOS = (0.25, 0.5, 0.75)
    FT_SHORT, FT_LONG = 60, 120        # table1_pruning.py
    FT_STEPS = 80                      # table2_peft.py

    @staticmethod
    def tiny_gpt2():
        from repro_torch.configs import get_config
        return get_config("gpt2-xl").reduced(
            n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
            d_ff=256, vocab_size=512)

    @staticmethod
    def data_for(cfg, *, seq=64, batch=16, seed=0):
        from repro_torch.data import SyntheticConfig, SyntheticLM
        return SyntheticLM(SyntheticConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
            seed=seed))

    def perplexity(self, params, cfg, data, *, n_batches=8, start=10_000):
        """Eval PPL on held-out stream positions (scored through the
        kernels, no grad)."""
        import numpy as np
        torch = self.torch
        from repro_torch.models.transformer import forward
        tot, cnt = 0.0, 0
        for i in range(n_batches):
            b = data.batch_at(start + i)
            logits, _ = forward(params, cfg, b["tokens"], device=self.dev)
            logp = torch.log_softmax(logits.float(), -1)
            labels = torch.as_tensor(b["labels"], device=self.dev).long()
            nll = -logp.gather(-1, labels[..., None])
            tot += float(nll.double().sum())
            cnt += nll.numel()
        return float(np.exp(tot / cnt))

    def tiny_train(self, params, cfg, data, *, steps, lr=1e-3,
                   peft_mode=False, weight_decay=0.0, start_step=0):
        """``benchmarks.common.train`` on the port."""
        from repro_torch.optim import AdamWConfig
        from repro_torch.train import (TrainConfig, make_opt_state,
                                       make_train_step)
        tcfg = TrainConfig(
            optimizer=AdamWConfig(lr=lr, weight_decay=weight_decay),
            warmup_steps=max(2, steps // 10), total_steps=steps,
            remat=False, peft_mode=peft_mode)
        step = make_train_step(cfg, tcfg, device=self.dev)
        opt = make_opt_state(params, peft_mode=peft_mode)
        for i in range(steps):
            params, opt, _ = step(params, opt, data.batch_at(start_step + i))
        self.tiny_steps += steps
        return params

    def phase_tables(self):
        """Phase 12: the paper's tables at the reference benchmarks' own
        scale (``benchmarks/common.py``'s tiny GPT-2), pretrained 300
        steps by the port on the card, then the procedures of
        ``table1_pruning.py``, ``table2_peft.py``, ``fig2_spectrum.py`` and
        ``fig3_trainfree.py`` on the port's modules, with their ratios,
        steps, learning rates and data seeds; every benchmark check must
        hold."""
        from repro_torch.models.transformer import init_lm_params
        self.tiny_steps = 0
        self.reset_counts()
        cfg = self.tiny_gpt2()
        data = self.data_for(cfg)
        t0 = time.perf_counter()
        params = init_lm_params(cfg, SEED, device=self.dev)
        params = self.tiny_train(params, cfg, data, steps=300, lr=2e-3)
        self.sync()
        print(f"tables: pretrain_base 300 steps in "
              f"{time.perf_counter() - t0:.1f} s [{self.card}]")
        checks = {}
        for name, fn in (("table1", self.table1), ("table2", self.table2),
                         ("fig2", self.fig2), ("fig3", self.fig3),
                         ("fig4", self.fig4), ("fig56", self.fig56),
                         ("spec", self.spec_tiny)):
            t0 = time.perf_counter()
            out = fn(params, cfg, data)
            self.sync()
            print(f"tables {name}: checks {out} "
                  f"({time.perf_counter() - t0:.1f} s)")
            checks.update({f"{name}.{k}": v for k, v in out.items()})
        c = self.counts()
        print(f"tables: {self.tiny_steps} training steps in all; "
              f"attention_ref {c['attention_ref']} calls (training), "
              f"flash_attention {c['flash_attention']} launches (scoring)")
        bad = [k for k, v in checks.items() if not v]
        if bad:
            self.fail(f"tables: checks failed {bad}")

    def table1(self, params, cfg, data):
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.core.peft import count_params, partition
        from repro_torch.core.prune import clover_prune, vanilla_prune
        ppl = self.perplexity
        base_ppl = ppl(params, cfg, data)
        dp, dcfg, _ = clover_decompose(params, cfg, peft=False)
        dp_ft, dcfg_ft, _ = clover_decompose(params, cfg, peft=True)
        rows = []
        for ratio in self.TABLE1_RATIOS:
            cp, ccfg = clover_prune(dp, dcfg, qk_ratio=ratio, vo_ratio=ratio)
            vp, vcfg = vanilla_prune(params, cfg, qk_ratio=ratio,
                                     vo_ratio=ratio)
            row = {"ratio": ratio, "vanilla_ppl": ppl(vp, vcfg, data),
                   "clover_ppl": ppl(cp, ccfg, data)}
            for name, budget in (("short", self.FT_SHORT),
                                 ("long", self.FT_LONG)):
                vp_ft = self.tiny_train(vp, vcfg, data, steps=budget,
                                        lr=1e-3, start_step=1000)
                cp_ft = self.tiny_train(cp, ccfg, data, steps=budget,
                                        lr=1e-3, start_step=1000)
                row[f"vanilla_ft_{name}"] = ppl(vp_ft, vcfg, data)
                row[f"clover_ft_{name}"] = ppl(cp_ft, ccfg, data)
            cpd, ccfgd = clover_prune(dp_ft, dcfg_ft, qk_ratio=ratio,
                                      vo_ratio=ratio)
            cpd = self.tiny_train(cpd, ccfgd, data, steps=self.FT_SHORT,
                                  lr=1e-2, peft_mode=True, start_step=1000)
            row["clover_dagger_ft_short"] = ppl(cpd, ccfgd, data)
            row["dagger_trainable_params"] = count_params(partition(cpd)[0])
            rows.append(row)
            print(f"table1 ratio={ratio:.2f} base={base_ppl:.4f} "
                  f"vanilla={row['vanilla_ppl']:.4f} "
                  f"clover={row['clover_ppl']:.4f} | ft short v="
                  f"{row['vanilla_ft_short']:.4f} "
                  f"c={row['clover_ft_short']:.4f} dagger="
                  f"{row['clover_dagger_ft_short']:.4f} | ft long v="
                  f"{row['vanilla_ft_long']:.4f} "
                  f"c={row['clover_ft_long']:.4f} | dagger trainable "
                  f"{row['dagger_trainable_params']}")
        return {
            "clover_beats_vanilla_all_ratios": all(
                r["clover_ppl"] < r["vanilla_ppl"] for r in rows),
            "ft_recovers": all(r["clover_ft_long"] < r["clover_ppl"]
                               for r in rows),
            "dagger_close_to_full_ft": rows[0]["clover_dagger_ft_short"]
            < 1.5 * rows[0]["clover_ft_short"]}

    def train_adapters(self, params, cfg, pcfg, data, *, steps, lr):
        """table2_peft.py's ``_train_adapters`` on the port."""
        torch = self.torch
        from repro_torch.core.peft import (count_params, init_adapters,
                                           materialize, pissa_residual)
        from repro_torch.optim import AdamWConfig, adamw_init
        from repro_torch.train import make_adapter_step
        gen = torch.Generator(device=self.dev).manual_seed(42)
        adapters = init_adapters(params, pcfg, gen)
        frozen = (pissa_residual(params, adapters, pcfg)
                  if pcfg.method == "pissa" else params)
        step = make_adapter_step(cfg, pcfg, frozen,
                                 AdamWConfig(lr=lr, weight_decay=0.0),
                                 device=self.dev)
        opt = adamw_init(adapters)
        for i in range(steps):
            b = data.batch_at(i)
            adapters, opt, _ = step(adapters, opt, b["tokens"], b["labels"])
        self.tiny_steps += steps
        with torch.no_grad():
            eff = materialize(frozen, adapters, pcfg)
        return eff, count_params(adapters)

    def table2(self, params, cfg, _data):
        from repro_torch.core.decompose import clover_decompose, merge_clover
        from repro_torch.core.peft import PeftConfig, count_params, partition
        new_data = self.data_for(cfg, seed=99)
        ppl = self.perplexity
        before = ppl(params, cfg, new_data)
        results = {}
        for method in ("lora", "dora", "pissa"):
            pcfg = PeftConfig(method=method, rank=16,
                              alpha=16.0 if method != "pissa" else 1.0)
            lr = 2e-3 if method != "pissa" else 1e-4
            eff, n_train = self.train_adapters(params, cfg, pcfg, new_data,
                                               steps=self.FT_STEPS, lr=lr)
            results[method] = {"ppl": ppl(eff, cfg, new_data),
                               "trainable": n_train}
        p2, cfg2, _ = clover_decompose(params, cfg, peft=True)
        tr, _ = partition(p2)
        p2 = self.tiny_train(p2, cfg2, new_data, steps=self.FT_STEPS,
                             lr=5e-3, peft_mode=True)
        merged, cfg3 = merge_clover(p2, cfg2)
        results["clover"] = {"ppl": ppl(merged, cfg3, new_data),
                             "trainable": count_params(tr)}
        pf = self.tiny_train(params, cfg, new_data, steps=self.FT_STEPS,
                             lr=1e-3)
        results["full_ft"] = {"ppl": ppl(pf, cfg, new_data),
                              "trainable": count_params(params)}
        print(f"table2 before adaptation: ppl={before:.4f}")
        for k, v in results.items():
            print(f"table2 {k:8s} ppl={v['ppl']:.4f} "
                  f"trainable={v['trainable']}")
        return {
            "all_adapt": all(v["ppl"] < before for v in results.values()),
            "clover_beats_lora": results["clover"]["ppl"]
            < results["lora"]["ppl"],
            "budget_matched": results["clover"]["trainable"]
            <= results["lora"]["trainable"]}

    def fig2(self, params, cfg, _data):
        """The trained row, and random-init rows for the reference's
        architectures that the port has configs for (stablelm-3b and
        jamba-v0.1-52b, in the reference's order; musicgen-large,
        internvl2-2b and qwen2-moe-a2.7b arrive with their configs)."""
        from repro_torch.configs import get_config
        from repro_torch.core.analytics import (energy_topk, qk_curves,
                                                vo_curves)
        from repro_torch.models.transformer import init_lm_params

        def first_attn(c, p):
            j = next(i for i, (m, _) in enumerate(c.pattern) if m == "attn")
            return {k: v[0] for k, v in p["blocks"][j]["attn"].items()}

        def top25(s, k):
            return float(energy_topk(s, k).mean())

        attn = first_attn(cfg, params)
        k = max(1, cfg.head_dim_ // 4)
        S, van = qk_curves(attn, cfg.q_per_kv)
        Sv, vanv = vo_curves(attn, cfg.q_per_kv)
        rows = [{"arch": "tiny-gpt2(trained)",
                 "qk_clover_top25": top25(S, k),
                 "qk_vanilla_top25": top25(van, k),
                 "vo_clover_top25": top25(Sv, k),
                 "vo_vanilla_top25": top25(vanv, k)}]
        for name in ("stablelm-3b", "jamba-v0.1-52b"):
            acfg = get_config(name).reduced()
            ap = init_lm_params(acfg, SEED, device=self.dev)
            a = first_attn(acfg, ap)
            ka = max(1, acfg.head_dim_ // 4)
            S, van = qk_curves(a, acfg.q_per_kv)
            rows.append({"arch": name, "qk_clover_top25": top25(S, ka),
                         "qk_vanilla_top25": top25(van, ka)})
        for r in rows:
            print(f"fig2 {r['arch']:24s} "
                  + " ".join(f"{k}={v:.4f}" for k, v in r.items()
                             if k != "arch"))
        return {
            "clover_concentrates": all(
                r["qk_clover_top25"] >= r["qk_vanilla_top25"] - 1e-6
                for r in rows),
            "trained_gap": rows[0]["qk_clover_top25"]
            > rows[0]["qk_vanilla_top25"]}

    def fig3(self, params, cfg, data):
        import numpy as np
        from repro_torch.core.analytics import host_array
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.core.prune import (clover_prune, threshold_ratios,
                                            vanilla_prune)
        base_ppl = self.perplexity(params, cfg, data)
        dp, dcfg, extras = clover_decompose(params, cfg, peft=False)
        qk_t = float(np.quantile(host_array(extras[0]["spectra"]["qk"]),
                                 0.45))
        vo_t = float(np.quantile(host_array(extras[0]["spectra"]["vo"]),
                                 0.30))
        plan = threshold_ratios(extras, dcfg, qk_thresh=qk_t, vo_thresh=vo_t)
        cp, ccfg = clover_prune(dp, dcfg, qk_ratio=plan["qk_ratio"],
                                vo_ratio=plan["vo_ratio"])
        vp, vcfg = vanilla_prune(params, cfg, qk_ratio=plan["qk_ratio"],
                                 vo_ratio=plan["vo_ratio"])
        ppl_c = self.perplexity(cp, ccfg, data)
        ppl_v = self.perplexity(vp, vcfg, data)
        print(f"fig3 threshold plan: qk_ratio={plan['qk_ratio']:.4f} "
              f"vo_ratio={plan['vo_ratio']:.4f}; base={base_ppl:.4f} "
              f"clover(train-free)={ppl_c:.4f} vanilla={ppl_v:.4f}")
        return {"some_pruning_happened": plan["qk_ratio"] > 0.1,
                "clover_nearly_unchanged": ppl_c < 1.6 * base_ppl,
                "vanilla_degrades_more": ppl_v > ppl_c}

    def fig4(self, params, cfg, data, rank=4):
        """``fig4_projection.py`` on the port: the share of the features
        entering the first attention layer (16 samples of
        ``batch_at(5000)``) that rank-``rank`` random directions (LoRA),
        the top-``rank`` directions (PiSSA) and all of head 0's
        ``svd_lowrank_product`` basis (CLOVER) cover, and the principal
        direction's share with and without its singular value."""
        torch = self.torch
        from repro_torch.core.analytics import coverage, projection_mass
        from repro_torch.core.decompose import svd_lowrank_product
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T
        toks = torch.as_tensor(data.batch_at(5000)["tokens"][:16],
                               device=self.dev)
        pos = torch.arange(toks.shape[1], device=self.dev)[None].expand(
            toks.shape)
        lp = T.layer_slice(params["blocks"][0], 0)
        X = L.apply_norm(lp["norm1"], cfg, T._embed(params, cfg, toks, pos)
                         ).reshape(-1, cfg.d_model)
        D, H, d = lp["attn"]["wq"].shape
        U, S, _ = svd_lowrank_product(
            lp["attn"]["wq"].permute(1, 0, 2).reshape(H, D, d)[0],
            lp["attn"]["wk"].permute(1, 0, 2)[0])
        gen = torch.Generator(device=self.dev).manual_seed(0)
        rand = torch.linalg.qr(torch.randn((cfg.d_model, rank),
                                           generator=gen,
                                           device=self.dev))[0]
        res = {"lora_coverage": coverage(X, rand),
               "pissa_coverage": coverage(X, U[:, :rank]),
               "clover_coverage": coverage(X, U),
               "principal_share_unscaled": float(projection_mass(X, U)[0]),
               "principal_share_scaled": float(
                   projection_mass(X, U, weights=S)[0])}
        print("fig4 " + " ".join(f"{k}={v:.4f}" for k, v in res.items()))
        return {
            "scaling_amplifies_principal": res["principal_share_scaled"]
            > res["principal_share_unscaled"],
            "lora_misses_most": res["lora_coverage"] < 0.5,
            "pissa_partial": res["pissa_coverage"] < 0.9,
            "clover_covers_most": res["clover_coverage"]
            >= res["pissa_coverage"]}

    def fig56(self, params, cfg, _data, rank=2):
        """``fig56_rank.py`` on the port, on the seed-99 domain: LoRA at
        rank ``rank`` on ``wq`` (60 steps, lr 5e-3, alpha 16), CLOVER-S
        (60 steps, lr 5e-3) then ``merge_clover``, full fine-tuning (60
        steps, lr 1e-3); the rank of each update of layer 0's ``wq`` and
        its intruder dimensions against the base."""
        from repro_torch.core.analytics import (delta_spectrum,
                                                effective_rank,
                                                intruder_dims)
        from repro_torch.core.decompose import clover_decompose, merge_clover
        from repro_torch.core.peft import PeftConfig

        def wq0(tree):
            w = tree["blocks"][0]["attn"]["wq"][0]
            return w.reshape(w.shape[0], -1)

        new_data = self.data_for(cfg, seed=99)
        W0 = wq0(params)
        pcfg = PeftConfig(method="lora", rank=rank, alpha=16.0,
                          targets=("wq",))
        eff, _ = self.train_adapters(params, cfg, pcfg, new_data, steps=60,
                                     lr=5e-3)
        W_lora = wq0(eff)
        p2, cfg2, _ = clover_decompose(params, cfg, peft=True)
        p2 = self.tiny_train(p2, cfg2, new_data, steps=60, lr=5e-3,
                             peft_mode=True)
        merged, _ = merge_clover(p2, cfg2)
        W_clover = wq0(merged)
        W_full = wq0(self.tiny_train(params, cfg, new_data, steps=60,
                                     lr=1e-3))
        res = {}
        for name, W1 in (("lora", W_lora), ("clover", W_clover),
                         ("full_ft", W_full)):
            res[name] = {
                "delta_rank": effective_rank(delta_spectrum(W0, W1),
                                             tol=1e-2),
                "intruders": intruder_dims(W0, W1, k=8, tau=0.6)}
            print(f"fig56 {name:8s} delta_rank={res[name]['delta_rank']:4d} "
                  f"intruders={res[name]['intruders']}")
        return {
            "lora_low_rank": res["lora"]["delta_rank"] <= rank + 1,
            "clover_high_rank": res["clover"]["delta_rank"]
            > 4 * res["lora"]["delta_rank"],
            "full_high_rank": res["full_ft"]["delta_rank"]
            > 4 * res["lora"]["delta_rank"],
            "clover_no_extra_intruders": res["clover"]["intruders"]
            <= res["full_ft"]["intruders"] + 1}

    # ---- phase 10 ----------------------------------------------------
    def phase_profile(self, models):
        """Where the time goes, in torch.profiler sessions back to back,
        outside every counted phase: the budget dense engine on the main
        path's first 4 requests (16 new tokens each), then (its model
        dropped from ``models``, the card freed) one training step.  (The
        rwkv6 engine's session was dropped to make room for phase 19;
        its last profile is in PERF.md.)"""
        import gc
        torch = self.torch
        from repro_torch.serve import EngineConfig
        ek = dict(slots=4, max_len=512, prefill_chunk=64)
        params, cfg, plan = models.pop("budget")
        self.profile_engine("budget dense", params, cfg, EngineConfig(
            rank_budget=plan, **ek), share="decode_")
        del params, plan
        gc.collect()
        torch.cuda.empty_cache()
        self.profile_train()

    def profile_train(self):
        """One full fine-tune step of gpt2-xl at full width with remat
        ((2, 1024) tokens, after a warm-up step) under torch.profiler:
        device busy share of the step's wall, the top kernels, and the
        shares of the GEMMs, the softmax of the plain attention and the
        rest (elementwise, norms, the optimizer)."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.configs import get_config
        from repro_torch.data import SyntheticConfig, SyntheticLM
        from repro_torch.models.transformer import init_lm_params
        from repro_torch.train import make_opt_state
        cfg = get_config("gpt2-xl")
        data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size,
                                           seq_len=1024, global_batch=2,
                                           seed=SEED))
        step = self.trainer(cfg, True)
        params = init_lm_params(cfg, SEED)
        params, opt, _ = step(params, make_opt_state(params),
                              data.batch_at(0))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, _ = step(params, opt, data.batch_at(1))
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        del params, opt
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]

        def dev_ms(e):
            return e.self_device_time_total / 1e3

        busy = sum(dev_ms(e) for e in kernels)
        print(f"profile train gpt2-xl full remat step, (2, 1024) tokens "
              f"(profiler on): wall {wall_ms:.1f} ms, kernels busy "
              f"{busy:.1f} ms = {busy / wall_ms:.1%} of wall, idle "
              f"{1 - busy / wall_ms:.1%}, {sum(e.count for e in kernels)} "
              f"launches [{self.card}]")
        for e in sorted(kernels, key=dev_ms, reverse=True)[:10]:
            print(f"  kernel {dev_ms(e):8.2f} ms ({dev_ms(e) / busy:6.1%}) "
                  f"x{e.count:<6d} {e.key[:80]}")
        groups = {"gemm": ("gemm", "gemv", "Kernel2"),
                  "softmax": ("softmax",)}
        rest = busy
        for name, keys in groups.items():
            ms = sum(dev_ms(e) for e in kernels
                     if any(k in e.key for k in keys))
            rest -= ms
            print(f"  {name}: {ms:.2f} ms = {ms / busy:.1%} of device time")
        print(f"  other (elementwise, norms, reductions, optimizer): "
              f"{rest:.2f} ms = {rest / busy:.1%}")

    def profile_engine(self, label, params, cfg, ecfg, share=None):
        """One engine under torch.profiler, on the main path's first 4
        requests of 16 new tokens: device busy share, host ms per step
        kind, the top kernels, and (``share``) the device-time share of
        the kernels whose name holds it.  Device busy time sums
        the kernels (not the CPU ops or the step spans that contain
        them)."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.serve import Engine, Request
        eng = Engine(params, cfg, ecfg)
        n_requests, new = 4, 16
        reqs = [Request(uid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(self.main_prompts(cfg)[:n_requests])]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run(reqs)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("engine.")]

        def dev_ms(e):
            return e.self_device_time_total / 1e3

        busy = sum(dev_ms(e) for e in kernels)
        print(f"profile {label} engine, {n_requests} requests x {new} "
              f"tokens (profiler on): "
              f"wall {wall_ms:.1f} ms, {eng.steps} steps, kernels busy "
              f"{busy:.1f} ms = {busy / wall_ms:.1%} of wall, idle "
              f"{1 - busy / wall_ms:.1%} [{self.card}]")
        for e in events:
            if e.key.startswith("engine.") and e.device_type == \
                    DeviceType.CPU:
                print(f"  {e.key}: {e.count} steps, host "
                      f"{e.cpu_time_total / 1e3 / e.count:.2f} ms/step")
        for e in sorted(kernels, key=dev_ms, reverse=True)[:10]:
            print(f"  kernel {dev_ms(e):8.2f} ms ({dev_ms(e) / busy:6.1%}) "
                  f"x{e.count:<6d} {e.key[:80]}")
        if share is not None:
            mine = [e for e in kernels if share in e.key]
            ms = sum(dev_ms(e) for e in mine)
            print(f"  {share}: {ms:.2f} ms = {ms / busy:.1%} of device "
                  f"time, {sum(e.count for e in mine)} launches")
            if not mine:
                self.fail(f"profile {label}: no {share} kernel traced")

    # ---- phase 8 -----------------------------------------------------
    def phase_rwkv(self, cfg=None):
        """rwkv6-1.6b at its published width and depth (``cfg`` defaults
        to it), random weights from SEED: scoring, ``clover_decompose``
        (no attention pairs: the model passes through), and the main
        path's 8 requests on a dense engine with per-slot recurrent
        state, every stream equal to ``greedy_reference``.  The counts
        are set to 0 just before and read just after; only ``wkv6`` may
        launch; its launches are also counted by shape.  -> (params, cfg)
        for the profile phase."""
        from repro_torch.configs import get_config

        cfg = cfg or get_config("rwkv6-1.6b")
        census = Counter()
        with self.shape_census(census):
            return self.rwkv_body(cfg, census)

    def rwkv_body(self, cfg, census):
        import numpy as np
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.models.transformer import forward, init_lm_params
        from repro_torch.serve import EngineConfig, greedy_reference

        self.reset_counts()
        marks = [("start", self.counts(), dict(census))]
        t0 = time.perf_counter()
        params = init_lm_params(cfg, SEED)
        n = sum(t.numel() for t in _leaves(params))
        print(f"{cfg.name} init: {n} float32 parameters on the card, "
              f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.rwkv_n_heads} wkv heads of {cfg.rwkv_head_dim}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size} "
              f"({time.perf_counter() - t0:.1f} s)")
        if n != cfg.n_params():
            self.fail(f"rwkv: parameter count {n} != {cfg.n_params()}")
        tokens = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (4, 1024))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits0, _ = forward(params, cfg, tokens)
        loss = F.cross_entropy(
            logits0[:, :-1].reshape(-1, logits0.shape[-1]),
            torch.as_tensor(tokens[:, 1:], device=logits0.device).reshape(-1)
        ).item()
        print(f"rwkv6 scoring loss on (4, 1024) random tokens: {loss:.6f} "
              f"({time.perf_counter() - t0:.2f} s)")
        if not math.isfinite(loss):
            self.fail("rwkv: the scoring loss is not finite")
        marks.append(("rwkv scoring", self.counts(), dict(census)))
        dparams, dcfg, extras = clover_decompose(params, cfg)
        del params
        pairs = sum(len(ex["spectra"]) for ex in extras)
        logits1, _ = forward(dparams, dcfg, tokens)
        same = torch.equal(logits0, logits1)
        print(f"clover_decompose on rwkv6: {pairs} attention pairs "
              f"decomposed, clover.enabled={dcfg.clover.enabled}, logits "
              f"bitwise unchanged: {same}")
        if pairs or not same or not dcfg.clover.enabled:
            self.fail("rwkv: clover_decompose did not pass the model "
                      "through")
        del logits0, logits1
        marks.append(("rwkv decomposed", self.counts(), dict(census)))

        prompts = self.main_prompts(dcfg)
        C = 64
        print(f"rwkv6 prompts {[len(p) for p in prompts]}: TAIL tokens "
              f"{[len(p) % C for p in prompts]}, "
              f"{sum(len(p) < C for p in prompts)} prompts TAIL only")
        reqs = self.serve_main("rwkv6 dense", dparams, dcfg,
                               EngineConfig(slots=4, max_len=512,
                                            prefill_chunk=C), prompts)
        marks.append(("rwkv engine", self.counts(), dict(census)))
        t0 = time.perf_counter()
        refs = [greedy_reference(dparams, dcfg, p, 32) for p in prompts]
        torch.cuda.synchronize()
        print(f"greedy_reference (rwkv6): {len(refs)} streams x 32 "
              f"tokens in {time.perf_counter() - t0:.1f} s")
        marks.append(("rwkv reference", self.counts(), dict(census)))
        self.compare_streams("rwkv6 dense", reqs, refs, prompts, dparams,
                             dcfg, forward)
        for (_, before, c0), (name, after, c1) in zip(marks, marks[1:]):
            grew = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            print(f"phase {name}: launches {grew}")
            self.print_census(name, c0, c1)
            if after["wkv6"] <= before["wkv6"]:
                self.fail(f"wkv6 never launched in phase {name}")
        end = marks[-1][1]
        others = {k: v for k, v in end.items() if v and k != "wkv6"}
        if others:
            self.fail(f"rwkv phase: other kernels or plain versions ran: "
                      f"{others}")
        self.launches["wkv6"] = end["wkv6"]
        return dparams, dcfg

    # ---- phase 9 (jamba) ----------------------------------------------
    @staticmethod
    def jamba_config():
        """jamba-v0.1-52b at its published width, cut to one 8-layer
        period (7 Mamba layers, the attention layer at position 4, MoE
        on the odd positions), dropless (``capacity_factor`` 0)."""
        import dataclasses
        from repro_torch.configs import get_config
        cfg = get_config("jamba-v0.1-52b")
        return dataclasses.replace(
            cfg, n_layers=cfg.period,
            moe=dataclasses.replace(cfg.moe, capacity_factor=0.0))

    def router_margins(self):
        """Record, while the returned context is open, the smallest
        router top-k margin (k-th minus (k+1)-th probability) of every
        routing call: a wrapper around ``models.moe._route``.  -> (context
        manager, list of per-call device minima)."""
        import contextlib
        from repro_torch.models import moe as MOE
        seen = []

        @contextlib.contextmanager
        def watch():
            orig = MOE._route

            def route(params, cfg, xf, dropless):
                out = orig(params, cfg, xf, dropless)
                top = out[3].topk(cfg.moe.top_k + 1, dim=-1).values
                seen.append((top[:, -2] - top[:, -1]).min())
                return out
            MOE._route = route
            try:
                yield
            finally:
                MOE._route = orig
        return watch(), seen

    def router_ties(self, tag, pin):
        """Every routing a pinned replay would have flipped sat at a router
        near-tie (recorded top-k margin < ROUTER_TIE), as the stream
        comparisons allow."""
        if pin.flips and not pin.flip_margin < ROUTER_TIE:
            self.fail(f"{tag}: {pin.flips} routings flipped, at top-k "
                      f"margins up to {pin.flip_margin:.3e} >= "
                      f"{ROUTER_TIE:.0e}")

    def phase_jamba(self, cfg=None):
        """jamba-v0.1-52b at its published width (d_model 4096, 32 heads
        over 8 KV heads of 128, dI 8192, 16 experts top-2, vocab 65536),
        one 8-layer period, dropless, random weights from SEED (``cfg``
        defaults to it): the parameter count, scoring on (4, 1024) random
        tokens, the GQA ``clover_decompose`` (logits preserved),
        ``clover_prune`` to 64/64, then the main path's 8 requests on a
        dense and a paged engine (pool small enough to preempt), every
        stream equal to ``greedy_reference`` (near-tie of the logits, or
        of the router below 1e-5).  The counts are set to 0 just before
        and read after each sub-phase; only ``mamba_scan`` and the three
        attention kernels may launch, ``mamba_scan`` in every sub-phase;
        its launches are also counted by shape."""
        census = Counter()
        with self.shape_census(census):
            self.jamba_body(cfg, census)

    def jamba_body(self, cfg, census):
        import gc
        import numpy as np
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.core.prune import clover_prune
        from repro_torch.models.transformer import forward, init_lm_params
        from repro_torch.serve import EngineConfig, greedy_reference

        cfg = cfg or self.jamba_config()
        gc.collect()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        print(f"jamba start: memory_allocated {mem0 / 1e9:.3f} GB")
        if mem0 > 2e9:
            self.fail(f"jamba: {mem0 / 1e9:.3f} GB still allocated at start")
        torch.cuda.reset_peak_memory_stats()
        print(f"TF32: cuda.matmul.allow_tf32="
              f"{torch.backends.cuda.matmul.allow_tf32}, "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
        self.reset_counts()
        marks = [("start", self.counts(), dict(census))]
        t0 = time.perf_counter()
        params = init_lm_params(cfg, SEED)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        print(f"{cfg.name} init (one period): {n} float32 parameters on the "
              f"card (predicted 13295235072 at full width), {cfg.n_layers} "
              f"layers {[m for m, _ in cfg.pattern]}, d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
              f"{cfg.head_dim_}, dI {cfg.mamba_d_inner}, {cfg.moe.n_experts} "
              f"experts top-{cfg.moe.top_k}, vocab {cfg.vocab_size} "
              f"({time.perf_counter() - t0:.1f} s)")
        if n != cfg.n_params():
            self.fail(f"jamba: parameter count {n} != {cfg.n_params()}")
        tokens = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (4, 1024))

        def loss(logits):
            return F.cross_entropy(
                logits[:, :-1].reshape(-1, logits.shape[-1]),
                torch.as_tensor(tokens[:, 1:], device=logits.device)
                .reshape(-1)).item()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits0, aux = forward(params, cfg, tokens)
        loss0 = loss(logits0)
        print(f"jamba scoring loss on (4, 1024) random tokens: {loss0:.6f}, "
              f"aux {({k: round(float(v), 6) for k, v in aux.items()})} "
              f"({time.perf_counter() - t0:.2f} s)")
        if not math.isfinite(loss0):
            self.fail("jamba: the scoring loss is not finite")
        dparams, dcfg, extras = clover_decompose(params, cfg)
        del params
        pairs = sum(len(ex["spectra"]) for ex in extras)
        logits1, _ = forward(dparams, dcfg, tokens)
        dmax = (logits1 - logits0).abs().max().item()
        lmax = logits0.abs().max().item()
        print(f"clover_decompose (GQA, G={cfg.q_per_kv}): {pairs} spectra "
              f"families, max|dlogits| {dmax:.3e} vs 1e-3 * max|logits| = "
              f"{1e-3 * lmax:.3e}, decomposed loss {loss(logits1):.6f}")
        if not dmax <= 1e-3 * lmax:
            self.fail("jamba: clover_decompose did not preserve the function")
        del logits0, logits1
        pparams, pcfg = clover_prune(dparams, dcfg, qk_ratio=0.5,
                                     vo_ratio=0.5)
        del dparams
        if (pcfg.qk_dim, pcfg.vo_dim) != (64, 64):
            self.fail(f"jamba: pruned ranks {(pcfg.qk_dim, pcfg.vo_dim)} != "
                      "(64, 64)")
        logits2, _ = forward(pparams, pcfg, tokens)
        print(f"jamba pruned 64/64 scoring loss: {loss(logits2):.6f}")
        del logits2
        marks.append(("jamba scoring", self.counts(), dict(census)))

        prompts = self.main_prompts(pcfg)
        C = 64
        print(f"jamba prompts {[len(p) for p in prompts]}: TAIL tokens "
              f"{[len(p) % C for p in prompts]}")
        runs, margins = {}, {}
        for name, ek in MAIN_ENGINES:
            watch, seen = self.router_margins()
            steps = {"chunk": 0, "decode": 0}
            with watch:
                runs[name] = self.serve_main(
                    f"jamba {name}", pparams, pcfg, EngineConfig(**ek),
                    prompts, steps=steps)
            margins[name] = torch.stack(seen).min().item()
            marks.append((f"jamba {name}", self.counts(), dict(census)))
            print(f"engine jamba {name}: {steps['chunk']} chunk steps, "
                  f"{steps['decode']} decode steps, smallest router top-"
                  f"{pcfg.moe.top_k} margin {margins[name]:.3e}")
            self.jamba_steps[name] = steps
            if {"mamba_scan", "mamba_scan chunk"} <= set(self.times):
                # the kernel's device time in this engine, from its launches
                # (one per Mamba layer and step) times its timed ms
                n_m = sum(m == "mamba" for m, _ in pcfg.pattern) \
                    * pcfg.n_blocks
                est = n_m * (steps["chunk"] * self.times["mamba_scan chunk"][0]
                             + steps["decode"] * self.times["mamba_scan"][0])
                print(f"  mamba_scan est. device time: {est:.2f} ms = "
                      f"{est / (1e3 * self.last_wall):.2%} of the engine's "
                      f"wall ({n_m} layers x steps x timed ms)")
        t0 = time.perf_counter()
        refs = [greedy_reference(pparams, pcfg, p, 32) for p in prompts]
        torch.cuda.synchronize()
        print(f"greedy_reference (jamba): {len(refs)} streams x 32 tokens "
              f"in {time.perf_counter() - t0:.1f} s")
        marks.append(("jamba reference", self.counts(), dict(census)))
        for name, reqs in runs.items():
            self.compare_streams(f"jamba {name}", reqs, refs, prompts,
                                 pparams, pcfg, forward, router=True)
        need = {"jamba scoring": ("mamba_scan", "flash_attention"),
                "jamba dense": ("mamba_scan", "flash_decode"),
                "jamba paged": ("mamba_scan", "paged_flash_decode"),
                "jamba reference": ("mamba_scan", "flash_attention")}
        allowed = {"mamba_scan", "flash_attention", "flash_decode",
                   "paged_flash_decode"}
        for (_, before, c0), (name, after, c1) in zip(marks, marks[1:]):
            grew = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            print(f"phase {name}: launches {grew}")
            self.print_census(name, c0, c1)
            for k in need[name]:
                if grew.get(k, 0) <= 0:
                    self.fail(f"{k} never launched in phase {name}")
            others = {k: v for k, v in grew.items() if k not in allowed}
            if others:
                self.fail(f"{name}: other kernels or plain versions ran: "
                          f"{others}")
        self.launches["mamba_scan"] = marks[-1][1]["mamba_scan"]
        print(f"jamba memory: start {mem0 / 1e9:.3f} GB, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB allocated")
        del pparams, runs

    # ---- phases 13, 17, 18 (RoPE, MoE, frontends) -----------------------
    # (name, Q-K / V-O prune ratios, expected pruned widths, depth of the
    # peft=True -> merge_clover round trip (None: the whole model), and
    # rope_body's keywords)
    ROPE_MODELS = (("stablelm-3b", 0.5, 0.5, (52, 40), None, {}),
                   ("phi3-medium-14b", 0.0, 0.5, (128, 64), 8, {}))
    # qwen2 scores 2 sequences: its (4, 1024) logits alone are 2.49 GB at
    # vocab 151,936, and scoring holds several beside its weights; it
    # runs its first 8 of 24 layers (``layers``), which keeps the smoke
    # inside its time with phase 20
    MOE_MODELS = (("qwen2-moe-a2.7b", 0.0, 0.5, (128, 64), 4,
                   dict(batch=2, layers=8)),
                  ("granite-moe-1b-a400m", 0.0, 0.5, (64, 32), None, {}))
    FRONTEND_MODELS = (("musicgen-large", 0.5, 0.5, (32, 32), 8, {}),
                       ("internvl2-2b", 0.0, 0.5, (128, 64), None,
                        dict(train=True)))

    def phase_rope(self):
        """The RoPE configs at full width (run where jamba
        runs, on a card with under 2 GB allocated): stablelm-3b whole
        (partial RoPE, 20 of 80 dims rotated: the "partial" CLOVER mode)
        and phi3-medium-14b at its 40 layers (full RoPE, 40 heads over 10
        KV heads of 128: "intra" mode), random weights from SEED.  Each:
        the parameter count, the ``clover_decompose(peft=True)`` ->
        ``merge_clover`` round trip (logits within 1e-3 max |logits|,
        ``count_params`` exactly the base's; on phi3 on its first 8
        layers, where the up_u / k_t tree fits beside the whole model),
        scoring on (4, 1024) random tokens, ``clover_decompose``
        (function preserved; phi3 has no Q-K spectrum), ``clover_prune``
        (stablelm Q-K 0.5 of the 60-dim tail and V-O 0.5 -> 52 / 40; phi3
        V-O only -> 128 / 64), then the main path's 8 requests on a dense
        and a paged engine, every stream equal to ``greedy_reference``
        under the near-tie rule.  The counts are set to 0 just before
        scoring and read after each sub-phase: ``flash_attention`` must
        launch in scoring and in ``greedy_reference``, ``flash_decode`` in
        the dense engine, ``paged_flash_decode`` in the paged one; no
        other kernel and no plain version runs.  Each model's peak memory
        and wall time are printed, and everything it allocated is
        freed."""
        self.model_phase("rope", self.ROPE_MODELS)

    def phase_moe(self):
        """The RoPE MoEs at their published widths, whole, dropless
        (``capacity_factor`` 0), random weights from SEED, as
        ``phase_rope`` runs its models: qwen2-moe-a2.7b (its first 8 of
        24 layers, d_model 2048, 16 heads of 128 (MHA), 60 routed experts
        of 1408 padded to 64, top-4, 4 shared, vocab 151,936) with the
        peft round trip on its first 4 layers and scoring on (2,
        1024) tokens, pruned V-O only to 128 / 64; granite-moe-1b-a400m
        (24 layers, d_model 1024, 16 heads over 8 of 64, 32 experts top-8,
        tied embeddings, vocab 49,155) whole, pruned V-O only to 64 / 32.
        Both "intra" mode (no Q-K spectrum).  The function checks of
        ``clover_decompose`` and ``merge_clover`` replay the base
        forward's routing (``RoutingPin``), and every routing the replay
        would have flipped must sit at a top-k margin below ROUTER_TIE.
        A stream may also diverge where the reference's router had a
        top-k margin below ROUTER_TIE; each engine's smallest router
        margin is printed."""
        import dataclasses

        def dropless(cfg):
            return dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=0.0))
        self.model_phase("moe", self.MOE_MODELS, dropless)

    def phase_frontend(self):
        """The frontend configs at their published widths, whole, random
        weights from SEED, as ``phase_rope`` runs its models, with seeded
        unit-normal (B, F, D) frame / patch embeddings before the text
        tokens: musicgen-large (48 layers, d_model 2048, 32 heads of 64,
        sinusoidal positions: "cross" mode, 250 frames; peft round trip on
        its first 8 layers) pruned 32 / 32, and internvl2-2b (24 layers,
        16 heads over 8 of 128, RoPE: "intra" mode at G = 2, 256 patches)
        pruned V-O only to 128 / 64.  Scoring and the decompose / prune
        checks take the frontend input; ``prefill(frontend_embeds=...)``
        then 8 ``decode_step``s must give each step the logits of
        ``forward`` on the extended sequence (1e-3 max |logits|) and its
        greedy token (near-tie rule); the engines serve text (neither
        package's Engine takes a frontend): musicgen's sinusoidal
        positions at each slot's own index.  internvl2 also takes one
        CLOVER-S ``make_train_step`` step on a batch with
        ``frontend_embeds``, whose loss is the cross entropy of the text
        positions alone."""
        self.model_phase("frontend", self.FRONTEND_MODELS)

    def model_phase(self, label, models, adapt=None):
        """``rope_body`` on each entry of ``models`` (the tables above),
        its config passed through ``adapt`` when given and cut to its
        first ``layers`` layers where the entry names them."""
        import dataclasses
        from repro_torch.configs import get_config
        for name, qk, vo, widths, depth, kw in models:
            kw = dict(kw)
            cfg = get_config(name)
            if "layers" in kw:
                cfg = dataclasses.replace(cfg, n_layers=kw.pop("layers"))
            t0 = time.perf_counter()
            self.rope_body(adapt(cfg) if adapt else cfg, qk, vo, widths,
                           depth, label=label, **kw)
            print(f"{label} {name}: {time.perf_counter() - t0:.1f} s "
                  f"[{self.card}]")

    def cut(self, params, cfg, depth):
        """The first ``depth`` layers of a one-position pattern: views of
        the stacked leaves, no copy."""
        import dataclasses
        from repro_torch.bridge import tree_map
        out = dict(params)
        out["blocks"] = tuple(tree_map(lambda a: a[:depth], b)
                              for b in params["blocks"])
        return out, dataclasses.replace(cfg, n_layers=depth)

    def frontend_input(self, cfg, batch, seed):
        """Seeded unit-normal (batch, frontend_len, frontend_dim) frame /
        patch embeddings on the card, or None without a frontend."""
        if cfg.frontend == "none":
            return None
        gen = self.torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        return self.randn(batch, cfg.frontend_len, cfg.frontend_dim, gen=gen)

    def peft_round_trip(self, params, cfg, depth, tag, train=False):
        """``clover_decompose(peft=True)`` then ``merge_clover`` on the
        model (or its first ``depth`` layers): logits of each within 1e-3
        max |logits| of the base's, the merged count exactly the base's,
        the transitions (``s_qk`` or ``k_t``, ``s_vo``, ``up_t``) folded.
        ``train``: one CLOVER-S step on the decomposed model between the
        two (``frontend_train``)."""
        import numpy as np
        from repro_torch.core.decompose import clover_decompose, merge_clover
        from repro_torch.core.peft import count_params
        from repro_torch.models.transformer import forward
        if depth is not None:
            params, cfg = self.cut(params, cfg, depth)
        tok = np.random.default_rng(SEED + 3).integers(
            0, cfg.vocab_size, (1, 512))
        fe = self.frontend_input(cfg, 1, SEED + 3)
        pin = RoutingPin()
        with pin.record():
            base, _ = forward(params, cfg, tok, frontend_embeds=fe)
        n_base = count_params(params)
        dparams, dcfg, _ = clover_decompose(params, cfg, peft=True)
        keys = sorted(k for k in dparams["blocks"][0]["attn"]
                      if k in ("s_qk", "k_t", "s_vo"))
        with pin.replay():
            got, _ = forward(dparams, dcfg, tok, frontend_embeds=fe)
        self.logits_close(f"{tag} peft decompose ({cfg.n_layers} "
                          f"layers, {', '.join(keys)}){pin.note()}", got,
                          base)
        self.router_ties(tag, pin)
        if train:
            self.frontend_train(dparams, dcfg, tag)
        mparams, mcfg = merge_clover(dparams, dcfg)
        del dparams
        n_merged = count_params(mparams)
        with pin.replay():
            got, _ = forward(mparams, mcfg, tok, frontend_embeds=fe)
        self.logits_close(f"{tag} merge_clover{pin.note()}", got, base)
        self.router_ties(tag, pin)
        del got
        left = {k for b in mparams["blocks"] for sub in b.values()
                for k in sub if k in ("s_qk", "k_t", "s_vo", "up_t")}
        print(f"{tag} merged: {n_merged} parameters vs base "
              f"{n_base}, transitions left {sorted(left)}")
        if n_merged != n_base or left:
            self.fail(f"{tag}: merge_clover count {n_merged} != "
                      f"{n_base} or transitions {left} left")
        del mparams, base

    def frontend_train(self, dparams, dcfg, tag, batch=2, seq=256):
        """One CLOVER-S ``make_train_step`` step on a (batch, seq) batch
        with ``frontend_embeds``: the loss finite and equal (1e-4
        relative) to the cross entropy of the text positions' logits from
        ``forward`` (the frontend positions carry no labels); the
        training attention is the plain one (``flash_attention`` never
        launches).  It runs before the phase sets its counts to 0."""
        import numpy as np
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.models.transformer import forward
        from repro_torch.train import make_opt_state
        rng = np.random.default_rng(SEED + 4)
        b = {k: rng.integers(0, dcfg.vocab_size, (batch, seq))
             for k in ("tokens", "labels")}
        b["frontend_embeds"] = self.frontend_input(dcfg, batch, SEED + 4)
        logits, _ = forward(dparams, dcfg, b["tokens"],
                            frontend_embeds=b["frontend_embeds"])
        want = F.cross_entropy(
            logits[:, dcfg.frontend_len:].reshape(-1, logits.shape[-1]),
            torch.as_tensor(b["labels"], device=self.dev).reshape(-1)).item()
        del logits
        saved = self.counts()
        step = self.trainer(dcfg, remat=True, peft_mode=True)
        self.sync()
        t0 = time.perf_counter()
        _, _, m = step(dparams, make_opt_state(dparams, peft_mode=True), b)
        loss = float(m["loss"])
        self.sync()
        grew = {k: v - saved[k] for k, v in self.counts().items()
                if v != saved[k]}
        print(f"{tag} CLOVER-S step with frontend_embeds "
              f"{tuple(b['frontend_embeds'].shape)}: loss {loss:.6f} vs "
              f"text-position cross entropy {want:.6f}, "
              f"grad_norm {float(m['grad_norm']):.6f}, "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms, launches {grew}, "
              f"peak {self.peak_gb():.2f} GB [{self.card}]")
        if not (math.isfinite(loss) and abs(loss - want) <= 1e-4 * want):
            self.fail(f"{tag}: the frontend train step's loss {loss} is not "
                      f"the text positions' cross entropy {want}")
        if grew.get("flash_attention", 0) or not grew.get("attention_ref"):
            self.fail(f"{tag}: the train step ran {grew}, not the plain "
                      "attention")

    def frontend_decode(self, params, cfg, fe, tag, prompt=64, steps=8):
        """``prefill(tokens, frontend_embeds=fe)`` on a dense cache from
        index 0, then ``steps`` greedy ``decode_step``s, each fed the
        reference's token: each step's logits within 1e-3 max |logits|
        of ``forward`` on the extended sequence (F frontend positions
        first), and its argmax the reference's or at a near-tie (top-2
        gap < 1e-4 max |logit|)."""
        import numpy as np
        torch = self.torch
        from repro_torch.models.transformer import (decode_step, forward,
                                                    init_decode_state,
                                                    prefill)
        B = fe.shape[0]
        seq = torch.as_tensor(np.random.default_rng(SEED + 5).integers(
            0, cfg.vocab_size, (B, prompt)), device=self.dev)
        state = init_decode_state(cfg, B, cfg.frontend_len + prompt + steps)
        logits, state = prefill(params, cfg, seq, state, frontend_embeds=fe)
        worst, ties = 0.0, 0
        for i in range(steps):
            want = forward(params, cfg, seq, frontend_embeds=fe,
                           last_only=True)[0][:, 0]
            err = (logits - want).abs().max().item()
            lmax = want.abs().max().item()
            worst = max(worst, err / lmax)
            if not err <= 1e-3 * lmax:
                self.fail(f"{tag} frontend decode step {i}: max|dlogits| "
                          f"{err:.3e} > 1e-3 * {lmax:.3e}")
            tok, ref_tok = logits.argmax(-1), want.argmax(-1)
            for b in torch.nonzero(tok != ref_tok)[:, 0].tolist():
                top2 = want[b].topk(2).values
                gap = (top2[0] - top2[1]).item()
                if gap < 1e-4 * want[b].abs().max().item():
                    ties += 1
                else:
                    self.fail(f"{tag} frontend decode step {i} row {b}: "
                              f"token {int(tok[b])} != {int(ref_tok[b])}")
            seq = torch.cat([seq, ref_tok[:, None]], dim=1)
            logits, state = decode_step(params, cfg, ref_tok.to(torch.int32),
                                        state)
        print(f"{tag} frontend prefill ({B} x {cfg.frontend_len} frontend + "
              f"{prompt} tokens) + {steps} decode steps: worst max|dlogits| "
              f"{worst:.3e} x max|logits| against forward (tol 1e-3), "
              f"near-ties {ties}")

    def rope_body(self, cfg, qk_ratio, vo_ratio, widths, depth, *,
                  label="rope", batch=4, train=False):
        import gc
        import numpy as np
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.core.decompose import clover_decompose, qk_mode
        from repro_torch.core.prune import clover_prune
        from repro_torch.models.transformer import forward, init_lm_params
        from repro_torch.serve import EngineConfig, greedy_reference

        gc.collect()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        tag = f"{label} {cfg.name}"
        print(f"{tag} start: memory_allocated {mem0 / 1e9:.3f} GB")
        if mem0 > 2e9:
            self.fail(f"{tag}: {mem0 / 1e9:.3f} GB still allocated at start")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_lm_params(cfg, SEED)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        moe = (f", {cfg.moe.n_experts} experts (held as "
               f"{cfg.n_experts_padded}) of {cfg.moe.d_expert} top-"
               f"{cfg.moe.top_k}, {cfg.moe.n_shared} shared"
               if cfg.moe else f", d_ff {cfg.d_ff}")
        front = (f", {cfg.frontend} frontend of {cfg.frontend_len}"
                 if cfg.frontend != "none" else "")
        print(f"{tag} init: {n} float32 parameters on the card "
              f"({4 * n / 1e9:.1f} GB), {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV "
              f"heads of {cfg.head_dim_}, "
              + (f"RoPE on {cfg.rope_dims} dims" if cfg.rope else
                 "sinusoidal positions")
              + f" ({qk_mode(cfg)} mode){moe}, vocab {cfg.vocab_size}"
              f"{front} ({time.perf_counter() - t0:.1f} s)")
        if n != cfg.n_params():
            self.fail(f"{tag}: parameter count {n} != {cfg.n_params()}")
        self.peft_round_trip(params, cfg, depth, tag, train=train)
        tokens = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (batch, 1024))
        fe = self.frontend_input(cfg, batch, SEED)
        n_fe = 0 if fe is None else cfg.frontend_len
        shape = (f"({batch}, {n_fe} + 1024)" if n_fe else f"({batch}, 1024)")

        def loss(logits):   # over the text positions
            return F.cross_entropy(
                logits[:, n_fe:-1].reshape(-1, logits.shape[-1]),
                torch.as_tensor(tokens[:, 1:], device=logits.device)
                .reshape(-1)).item()

        self.reset_counts()
        marks = [("start", self.counts())]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pin = RoutingPin()
        with pin.record():
            logits0, _ = forward(params, cfg, tokens, frontend_embeds=fe)
        loss0 = loss(logits0)
        torch.cuda.synchronize()
        print(f"{tag} scoring loss on {shape} random tokens: {loss0:.6f} "
              f"({time.perf_counter() - t0:.2f} s)")
        if not math.isfinite(loss0):
            self.fail(f"{tag}: the scoring loss is not finite")
        if fe is not None:
            marks.append(("scoring", self.counts()))
            self.frontend_decode(params, cfg, fe[:2], tag)
            marks.append(("frontend decode", self.counts()))
        dparams, dcfg, extras = clover_decompose(params, cfg)
        del params
        with pin.replay():
            logits1, _ = forward(dparams, dcfg, tokens, frontend_embeds=fe)
        dmax = (logits1 - logits0).abs().max().item()
        lmax = logits0.abs().max().item()
        spectra = sorted(extras[0]["spectra"])
        print(f"{tag} clover_decompose ({qk_mode(cfg)}, G={cfg.q_per_kv}): "
              f"spectra {spectra}, max|dlogits| {dmax:.3e} vs 1e-3 * "
              f"max|logits| = {1e-3 * lmax:.3e}{pin.note()}, decomposed "
              f"loss {loss(logits1):.6f}")
        if not dmax <= 1e-3 * lmax:
            self.fail(f"{tag}: clover_decompose did not preserve the "
                      "function")
        self.router_ties(tag, pin)
        del pin
        if ("qk" in spectra) != (qk_mode(cfg) != "intra"):
            self.fail(f"{tag}: Q-K spectrum {spectra} in {qk_mode(cfg)} "
                      "mode")
        del logits0, logits1
        pparams, pcfg = clover_prune(dparams, dcfg, qk_ratio=qk_ratio,
                                     vo_ratio=vo_ratio)
        del dparams
        if (pcfg.qk_dim, pcfg.vo_dim) != widths:
            self.fail(f"{tag}: pruned widths {(pcfg.qk_dim, pcfg.vo_dim)} "
                      f"!= {widths}")
        logits2, _ = forward(pparams, pcfg, tokens, frontend_embeds=fe)
        print(f"{tag} pruned {pcfg.qk_dim}/{pcfg.vo_dim} scoring loss: "
              f"{loss(logits2):.6f}")
        del logits2, fe
        marks.append(("scoring", self.counts()))

        prompts = self.main_prompts(pcfg)
        router = pcfg.moe is not None
        runs = {}
        for name, ek in MAIN_ENGINES:
            watch, seen = self.router_margins()
            with watch:
                runs[name] = self.serve_main(f"{tag} {name}", pparams, pcfg,
                                             EngineConfig(**ek), prompts)
            if router:
                print(f"engine {tag} {name}: smallest router top-"
                      f"{pcfg.moe.top_k} margin "
                      f"{torch.stack(seen).min().item():.3e}")
            marks.append((name, self.counts()))
        t0 = time.perf_counter()
        refs = [greedy_reference(pparams, pcfg, p, 32) for p in prompts]
        torch.cuda.synchronize()
        print(f"greedy_reference ({cfg.name}): {len(refs)} streams x 32 "
              f"tokens in {time.perf_counter() - t0:.1f} s")
        marks.append(("reference", self.counts()))
        self.remember_refs(pparams, prompts, refs)
        for name, reqs in runs.items():
            self.compare_streams(f"{tag} {name}", reqs, refs, prompts,
                                 pparams, pcfg, forward, router=router)
        if qk_mode(cfg) == "partial":
            # phase 14's partial mode: the draft slices only the NoPE
            # tail, read through the cache's row stride
            from repro_torch.kernels.decode_attention import flash_decode
            from repro_torch.core.prune import draft_ranks
            strided0 = flash_decode.strided_launches
            reqs = self.serve_main(
                f"{tag} spec dense k4", pparams, pcfg, EngineConfig(
                    spec_k=4, draft_rank_ratio=0.5,
                    **dict(MAIN_ENGINES)["dense"]), prompts)
            marks.append(("spec", self.counts()))
            grew = flash_decode.strided_launches - strided0
            print(f"{tag} spec: draft {draft_ranks(pcfg, 0.5)} of "
                  f"{(pcfg.qk_dim, pcfg.vo_dim)}, strided flash_decode "
                  f"launches {grew}")
            if grew <= 0:
                self.fail(f"{tag} spec: no strided draft read")
            self.compare_streams(f"{tag} spec dense k4", reqs, refs, prompts,
                                 pparams, pcfg, forward)
        need = {"scoring": ("flash_attention",), "dense": ("flash_decode",),
                "paged": ("paged_flash_decode",),
                "frontend decode": ("flash_attention", "flash_decode"),
                "reference": ("flash_attention",), "spec": ("flash_decode",)}
        allowed = {"flash_attention", "flash_decode", "paged_flash_decode"}
        for (_, before), (name, after) in zip(marks, marks[1:]):
            grew = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            print(f"{tag} phase {name}: launches {grew}")
            for k in need[name]:
                if grew.get(k, 0) <= 0:
                    self.fail(f"{k} never launched in {tag} {name}")
            others = {k: v for k, v in grew.items() if k not in allowed}
            if others:
                self.fail(f"{tag} {name}: other kernels or plain versions "
                          f"ran: {others}")
        end = marks[-1][1]
        print(f"{tag} launches: " + ", ".join(
            f"{k} {end[k]}" for k in sorted(allowed)))
        del pparams, runs
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{tag} memory: start {mem0 / 1e9:.3f} GB, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB allocated, "
              f"end {torch.cuda.memory_allocated() / 1e9:.3f} GB "
              f"[{self.card}]")

    # ---- phase 19: tensor- and expert-parallel serving -----------------
    TP = 2
    # musicgen's depth here: at 48 layers this model's runs took 154.5 s
    # and the whole smoke 1218.4 s on a slower host (PERF.md, PR 25)
    TP_MUSICGEN_LAYERS = 24
    TP_TIMEOUT = 600.0          # seconds a rank group may run
    TP_PREFIX_NEW = 8           # new tokens per request of the prefix trace
    # the step shapes a run of each kind may end with: 2; 4 after a COW
    # and a restore; 3-4 with speculation (draft + verify, the plain
    # decode step only where a step cannot speculate)
    TP_SHAPES = {"dense": (2,), "paged": (2,), "prefix": (4,),
                 "spec": (3, 4)}

    def phase_tp(self):
        """Rank-balanced tensor- and expert-parallel serving (DESIGN.md
        §10), two ranks under gloo on the one card, each an engine with a
        ``ShardedExecutor`` spawned by ``launch.serve.serve_tp``."""
        import gc
        torch = self.torch
        self.tp_musicgen()
        gc.collect()
        torch.cuda.empty_cache()
        self.tp_granite()
        gc.collect()
        torch.cuda.empty_cache()

    def tp_prefix_trace(self, cfg):
        """The prefix phase's trace, cut: a 128-token system prompt (8
        pages of 16), a warm burst of two (system prompt + 8 / 19), the
        system prompt alone (a page-aligned full hit: copy-on-write), a
        churn burst of three unique 400-token prompts that overflows the
        48-page pool (the system prompt's pages spill to the host tier)
        and the warm burst again (restored through ``page_restore``);
        served at ``TP_PREFIX_NEW`` new tokens each."""
        import numpy as np
        rng = np.random.default_rng(SEED + 3)
        sys_p = rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
        warm = [np.concatenate([sys_p, rng.integers(
            0, cfg.vocab_size, n).astype(np.int32)]) for n in (8, 19)]
        churn = [rng.integers(0, cfg.vocab_size, 400).astype(np.int32)
                 for _ in range(3)]
        return [[sys_p], warm, [sys_p.copy()], churn, warm]

    def tp_start(self, name):
        import gc
        torch = self.torch
        gc.collect()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        print(f"tp {name} start: memory_allocated {mem0 / 1e9:.3f} GB")
        if mem0 > 2e9:
            self.fail(f"tp {name}: {mem0 / 1e9:.3f} GB still allocated at "
                      "start")
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    def tp_musicgen(self):
        """musicgen-large at its full width cut to ``TP_MUSICGEN_LAYERS``
        of its 48 layers (d_model 2048, 32 heads of 64, d_ff 8192, vocab
        2048: heads, ff and vocab all split at tp = 2),
        head ``h`` damped where ``h % 4 == 0`` in every layer, decomposed,
        ``plan_rank_budget`` at half the total rank and
        ``apply_rank_budget``; the plan's per-head loads give a partition
        that is not the identity."""
        import dataclasses
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.core.prune import (apply_rank_budget,
                                            plan_rank_budget,
                                            rank_balanced_partition)
        t0 = self.tp_start("musicgen-large")
        cfg = dataclasses.replace(get_config("musicgen-large"),
                                  n_layers=self.TP_MUSICGEN_LAYERS)
        dparams, dcfg, extras = self.damped_decomposition(cfg, every=4)
        plan = plan_rank_budget(extras, dcfg, budget=0.5)
        bparams, bcfg = apply_rank_budget(dparams, dcfg, plan)
        del dparams, extras
        part = rank_balanced_partition(plan.head_loads(), self.TP,
                                       group=bcfg.q_per_kv)
        tot = sum(part.loads)
        print(f"tp musicgen-large: budget total rank {plan.total_rank}, "
              f"widths {plan.qk_width}/{plan.vo_width}; partition kv_assign "
              f"{part.kv_assign}, loads {part.loads}, balance "
              f"{part.balance:.6f}, shard load fractions "
              f"{[ld / tot for ld in part.loads]} "
              f"({time.perf_counter() - t0:.1f} s)")
        if part.identity:
            self.fail("tp musicgen-large: the head partition is the "
                      "identity")
        self.tp_parity("musicgen shard", plan, part, bcfg)
        main = [self.main_prompts(bcfg)]
        trace = self.tp_prefix_trace(bcfg)
        unranked = dict(bparams, blocks=tuple(
            dict(b, attn={k: v for k, v in b["attn"].items()
                          if k not in ("rank_qk", "rank_vo")})
            for b in bparams["blocks"]))
        dense, paged = (dict(MAIN_ENGINES)[k] for k in ("dense", "paged"))
        prefix = dict(paged, prefix_cache=True, host_pages=64)
        # (kind, label, weights, engine, prompt waves, new tokens, an
        # explicit partition, the kernels every rank must launch); the
        # budget's engines plan the partition from its head loads, the
        # unranked ones take the same partition explicitly
        runs = [
            ("dense", "dense budget", bparams, dict(dense, rank_budget=plan),
             main, 32, None, ("flash_decode_ranked",)),
            ("prefix", "prefix budget", bparams,
             dict(prefix, rank_budget=plan), trace, self.TP_PREFIX_NEW,
             None, ("paged_flash_decode_ranked", "page_copy",
                    "page_restore")),
            ("spec", "spec dense k2 unranked", unranked,
             dict(dense, spec_k=2, draft_rank_ratio=0.5), main, 32, part,
             ("flash_decode", "flash_decode.strided")),
            ("paged", "paged unranked", unranked, paged, main, 32, part,
             ("paged_flash_decode",)),
        ]
        self.tp_serve("musicgen-large", bcfg, runs)
        print(f"tp musicgen-large: {time.perf_counter() - t0:.1f} s "
              f"[{self.card}]")

    def tp_granite(self):
        """granite-moe-1b-a400m whole, dropless, pruned V-O to 64/32 as
        phase 17 (intra mode): 16 heads over 8 KV heads give 4 KV heads
        (G = 2) per rank, 32 experts 16 per rank, its odd vocab of
        49155 replicates (the logits are broadcast); the main path dense
        and paged and musicgen's prefix trace."""
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.core.prune import clover_prune
        from repro_torch.models.transformer import init_lm_params
        t0 = self.tp_start("granite-moe-1b-a400m")
        cfg = get_config("granite-moe-1b-a400m")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.0))
        dparams, dcfg, _ = clover_decompose(init_lm_params(cfg, SEED), cfg)
        pparams, pcfg = clover_prune(dparams, dcfg, qk_ratio=0.0,
                                     vo_ratio=0.5)
        del dparams
        if (pcfg.qk_dim, pcfg.vo_dim) != (64, 32):
            self.fail(f"tp granite: pruned widths {pcfg.qk_dim}/"
                      f"{pcfg.vo_dim} != 64/32")
        self.tp_parity("granite shard", None, None, pcfg)
        main = [self.main_prompts(pcfg)]
        paged = dict(MAIN_ENGINES)["paged"]
        runs = [("dense", "dense", pparams, dict(MAIN_ENGINES)["dense"],
                 main, 32, None, ("flash_decode",)),
                ("paged", "paged", pparams, paged, main, 32, None,
                 ("paged_flash_decode",)),
                ("prefix", "prefix", pparams,
                 dict(paged, prefix_cache=True, host_pages=64),
                 self.tp_prefix_trace(pcfg), self.TP_PREFIX_NEW, None,
                 ("paged_flash_decode", "page_copy", "page_restore"))]
        self.tp_serve("granite-moe-1b-a400m", pcfg, runs, router=True)
        print(f"tp granite-moe-1b-a400m: {time.perf_counter() - t0:.1f} s "
              f"[{self.card}]")

    def tp_parity(self, label, plan, part, cfg):
        """The decode kernels at one rank's shard against their plain
        versions (TOL), on the engines' geometry (4 slots, lengths
        300/200/150/60, a 576-position cache, 49 pages of 16): rows 2-3
        at the shard's heads and widths; with a plan, rows 4-5 with each
        rank's rank clamps (layer 0's, permuted by the partition and
        split), and the draft's strided views ``cache[..., :r]`` of the
        per-rank cache and pool (each kernel also bit for bit itself on
        a contiguous copy)."""
        torch = self.torch
        from repro_torch.core.prune import draft_ranks
        from repro_torch.kernels import ref
        from repro_torch.kernels.decode_attention import (
            flash_decode, flash_decode_ranked)
        from repro_torch.kernels.paged_decode_attention import (
            paged_flash_decode, paged_flash_decode_ranked)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 19)
        scale = 1.0 / math.sqrt(cfg.head_dim_)
        H, KV = cfg.n_heads // self.TP, cfg.n_kv_heads // self.TP
        dq, dv = cfg.qk_dim, cfg.vo_dim
        B, T, lens = 4, 576, [300, 200, 150, 60]
        lengths = self.ids32(lens)
        case = f"{label} B{B} H{H} KV{KV} dq{dq} dv{dv}"
        q = self.randn(B, H, dq, gen=gen)
        past = (torch.arange(T, device=self.dev)[None, :]
                >= lengths[:, None].long())[..., None, None]
        k = torch.where(past, 50.0, self.randn(B, T, KV, dq, gen=gen))
        v = torch.where(past, -50.0, self.randn(B, T, KV, dv, gen=gen))
        self.parity("flash_decode", case,
                    flash_decode(q, k, v, lengths, scale=scale),
                    ref.decode_attention_ref(q, k, v, lengths, scale=scale))
        _, kp, vp, tab, _ = self.paged_case(gen, B, H, KV, dq, dv, 16, 48,
                                            36, lens)
        self.parity("paged_flash_decode", case,
                    paged_flash_decode(q, kp, vp, tab, lengths, scale=scale),
                    ref.paged_decode_attention_ref(q, kp, vp, tab, lengths,
                                                   scale=scale))
        self.dtype_parity(
            "flash_decode", case,
            lambda *a: flash_decode(*a, lengths, scale=scale),
            lambda *a: ref.decode_attention_ref(*a, lengths, scale=scale),
            q, k, v)
        self.dtype_parity(
            "paged_flash_decode", case,
            lambda *a: paged_flash_decode(*a, tab, lengths, scale=scale),
            lambda *a: ref.paged_decode_attention_ref(*a, tab, lengths,
                                                      scale=scale),
            q, kp, vp)
        if plan is None:
            return
        perm = torch.as_tensor(part.kv_perm, device=self.dev)
        rq_all = self.ids32(plan.layer_ranks(0)[0][0]).index_select(0, perm)
        rv_all = self.ids32(plan.layer_ranks(0)[1][0]).index_select(0, perm)
        rdq, rdv = draft_ranks(cfg, 0.5)
        for r in range(self.TP):
            rq, rv = rq_all[r * KV:(r + 1) * KV], rv_all[r * KV:(r + 1) * KV]
            tag = (f"{case} rank {r} ranks {int(rq.min())}-{int(rq.max())}/"
                   f"{int(rv.min())}-{int(rv.max())}")
            kr = self.past_rank(k, rq, 30.0)
            vr = self.past_rank(v, rv, -30.0)
            self.parity("flash_decode_ranked", tag,
                        flash_decode_ranked(q, kr, vr, lengths, rq, rv,
                                            scale=scale),
                        ref.decode_attention_ref(q, kr, vr, lengths,
                                                 scale=scale, qk_ranks=rq,
                                                 vo_ranks=rv))
            kpr = self.past_rank(kp, rq, 30.0)
            vpr = self.past_rank(vp, rv, -30.0)
            self.parity("paged_flash_decode_ranked", tag,
                        paged_flash_decode_ranked(q, kpr, vpr, tab, lengths,
                                                  rq, rv, scale=scale),
                        ref.paged_decode_attention_ref(
                            q, kpr, vpr, tab, lengths, scale=scale,
                            qk_ranks=rq, vo_ranks=rv))
            rk = dict(scale=scale, qk_ranks=rq, vo_ranks=rv)
            self.dtype_parity(
                "flash_decode_ranked", tag,
                lambda *a: flash_decode_ranked(*a, lengths, rq, rv,
                                               scale=scale),
                lambda *a: ref.decode_attention_ref(*a, lengths, **rk),
                q, kr, vr)
            self.dtype_parity(
                "paged_flash_decode_ranked", tag,
                lambda *a: paged_flash_decode_ranked(*a, tab, lengths, rq,
                                                     rv, scale=scale),
                lambda *a: ref.paged_decode_attention_ref(*a, tab, lengths,
                                                          **rk),
                q, kpr, vpr)
            # the draft's reads of this rank's cache and pool
            qd = q[..., :rdq].contiguous()
            ranks = (rq.clamp(max=rdq), rv.clamp(max=rdv))
            dtag = f"{tag} draft {rdq}/{rdv}"
            ks, vs = kr[..., :rdq], vr[..., :rdv]
            self.strided_check(
                "flash_decode_ranked", dtag, ks, vs,
                lambda k_, v_: flash_decode_ranked(qd, k_, v_, lengths,
                                                   *ranks, scale=scale),
                ref.decode_attention_ref(qd, ks, vs, lengths, scale=scale,
                                         qk_ranks=ranks[0],
                                         vo_ranks=ranks[1]))
            kps, vps = kpr[..., :rdq], vpr[..., :rdv]
            self.strided_check(
                "paged_flash_decode_ranked", dtag, kps, vps,
                lambda k_, v_: paged_flash_decode_ranked(
                    qd, k_, v_, tab, lengths, *ranks, scale=scale),
                ref.paged_decode_attention_ref(
                    qd, kps, vps, tab, lengths, scale=scale,
                    qk_ranks=ranks[0], vo_ranks=ranks[1]))

    def weights_key(self, params):
        """Identifies a weight tree bit for bit in practice: each leaf's
        shape with its float64 sum and sum of squares (accumulated over
        16M-element pieces: no float64 copy of a whole leaf)."""
        torch = self.torch
        key = []
        for t in _leaves(params):
            acc = torch.zeros(2, dtype=torch.float64, device=t.device)
            for piece in t.reshape(-1).split(1 << 24):
                d = piece.double()
                acc += torch.stack([d.sum(), d.square().sum()])
            key.append((tuple(t.shape), *acc.tolist()))
        return tuple(key)

    def remember_refs(self, params, prompts, refs):
        """Keep ``greedy_reference`` streams of ``params`` for a later
        phase serving the same weights (phase 19's granite is phase 17's:
        the same seed, decomposition and pruning)."""
        key = self.weights_key(params)
        for p, r in zip(prompts, refs):
            self.refs[(key, p.tobytes())] = list(r)

    def tp_serve(self, name, cfg, runs, router=False):
        """Every run at tp = 2 on two spawned ranks (gloo, one card): per
        rank tokens/s, mean ITL, steps, all-reduce count and host time per
        step, broadcasts, peak memory and launches of rows 2-7.  Every
        rank's streams must equal every other's and the one-rank
        ``greedy_reference`` (near-tie rule), the step shapes must be the
        run kind's (``TP_SHAPES``), each run's kernels must launch on
        every rank and no plain version anywhere.  (The in-process tp = 1
        runs were cut for the smoke's time.)"""
        import types
        import numpy as np
        from repro_torch.launch.serve import ServeRun, serve_tp
        from repro_torch.models.transformer import forward
        from repro_torch.serve import EngineConfig, greedy_reference
        from repro_torch.serve.scheduler import DONE
        torch = self.torch
        before = self.counts()
        waves_of = {label: [[dict(prompt=p, max_new_tokens=new) for p in w]
                            for w in waves]
                    for _, label, _, _, waves, new, _, _ in runs}
        # the card (each rank's own), or the CPU of a rehearsal
        dev = None if self.dev.type == "cuda" else "cpu"
        t0 = time.perf_counter()

        def ranks():
            return serve_tp(
                [ServeRun(label, params, cfg, EngineConfig(tp=self.TP, **ek),
                          waves_of[label], plan=part)
                 for _, label, params, ek, _, _, part, _ in runs],
                tp=self.TP, backend="gloo", device=dev,
                timeout=self.TP_TIMEOUT)

        def references():
            # one reference per prompt at the most new tokens asked of
            # it, or an earlier phase's of the same weights
            refs = {}
            t1 = time.perf_counter()
            for _, _, _, _, waves, new, _, _ in runs:
                for p in (p for w in waves for p in w):
                    refs[p.tobytes()] = max(refs.get(p.tobytes(), 0), new)
            wkey, reused = self.weights_key(runs[0][2]), 0
            for key, new in refs.items():
                kept = self.refs.get((wkey, key))
                if kept is not None and len(kept) >= new:
                    refs[key], reused = kept, reused + 1
                    continue
                refs[key] = greedy_reference(runs[0][2], cfg, np.frombuffer(
                    key, np.int32), new, device=self.dev)
            self.sync()
            print(f"greedy_reference ({name}): {len(refs)} streams, "
                  f"{reused} of them an earlier phase's on the same weights "
                  "(equal shapes, sums and sums of squares), in "
                  f"{time.perf_counter() - t1:.1f} s, beside the ranks")
            return refs
        per_rank, refs = self.beside(ranks, references)
        print(f"tp {name}: {len(runs)} runs at tp = {self.TP} on "
              f"{self.TP} spawned ranks (gloo) in "
              f"{time.perf_counter() - t0:.1f} s of wall")
        rows = ("flash_decode", "paged_flash_decode", "flash_decode_ranked",
                "paged_flash_decode_ranked", "page_copy", "page_restore")
        for i, (kind, label, params, ek, waves, new, _, need) in enumerate(
                runs):
            tag = f"tp {name} {label}"
            ranks = [per_rank[r][i] for r in range(self.TP)]
            for r, got in enumerate(ranks):
                c, steps = got["collectives"], max(1, got["steps"])
                print(f"{tag} rank {r}: {got['tokens']} tokens in "
                      f"{got['wall']:.3f} s = {got['tokens_per_s']:.1f} "
                      f"tokens/s, mean ITL {got['itl_ms']:.2f} ms, "
                      f"{got['steps']} steps, all_reduce {c['all_reduce']} "
                      f"({c['all_reduce'] / steps:.1f} per step), broadcast "
                      f"{c['broadcast']}, {1e3 * c['seconds'] / steps:.2f} ms "
                      f"per step inside collectives, peak "
                      f"{got['peak_gb']:.3f} GB, shapes "
                      f"{got['compiled_shapes']} [{self.card}]")
                launched = got["launches"]
                print(f"{tag} rank {r} launches: " + ", ".join(
                    f"{k} {launched[k]}" for k in rows) + "; strided "
                    + ", ".join(f"{k} {launched[k + '.strided']}"
                                for k in rows[:4]))
                for k in need:
                    if launched[k] <= 0:
                        self.fail(f"{tag} rank {r}: {k} never launched")
                plain = {k: v for k, v in launched.items()
                         if k.endswith("_ref") and v}
                if plain:
                    self.fail(f"{tag} rank {r}: plain versions ran {plain}")
                if got["streams"] != ranks[0]["streams"]:
                    self.fail(f"{tag}: rank {r}'s streams differ from rank "
                              "0's")
                if got["compiled_shapes"] not in self.TP_SHAPES[kind]:
                    self.fail(f"{tag} rank {r}: compiled shapes "
                              f"{got['compiled_shapes']} not in "
                              f"{self.TP_SHAPES[kind]}")
                if not all(s == DONE for w in got["status"] for s in w):
                    self.fail(f"{tag} rank {r}: requests left unfinished")
            st = ranks[0]["stats"]
            print(f"{tag}: partition {ranks[0]['kv_perm']}, salt tail "
                  f"{ranks[0]['plan_salt'][:3]}, preemptions "
                  f"{st['preemptions']}"
                  + (f", prefix hits {st['prefix_hits']}, host spills "
                     f"{st['host_spills']}, restores {st['host_restores']}"
                     if kind == "prefix" else "")
                  + (f", accepted per round {st['accepted_per_round']:.3f}"
                     if kind == "spec" else ""))
            if kind == "prefix" and not (st["prefix_hits"] > 0
                                         and st["host_spills"] > 0
                                         and st["host_restores"] > 0):
                self.fail(f"{tag}: no hit, spill or restore: {st}")
            if kind == "paged" and st["preemptions"] < 1:
                self.fail(f"{tag}: the undersized pool never preempted")
            prompts = [p for w in waves for p in w]
            want = [refs[p.tobytes()][:new] for p in prompts]
            for who, got in (("tp = 2", ranks[0]),):
                reqs = [types.SimpleNamespace(uid=u, generated=g)
                        for u, g in enumerate(x for w in got["streams"]
                                              for x in w)]
                self.compare_streams(f"{tag} {who}", reqs, want, prompts,
                                     params, cfg, forward, router=router)
        plain = {k: v - before[k] for k, v in self.counts().items()
                 if k.endswith("_ref") and v != before[k]}
        if plain:
            self.fail(f"tp {name}: plain versions ran in this process: "
                      f"{plain}")

    # ---- phase 6 -----------------------------------------------------
    def prefix_trace(self, cfg):
        """(name, prompts) bursts, modeled on serve_bench's warm replay
        and spill/restore scenarios: a 256-token system prompt (16 full
        pages) alone, a warm burst (system prompt + tails), the system
        prompt alone again (a page-aligned full hit: resumes at 255 and
        copies page 15 on write), a churn burst of unique 400-token
        prompts that overflows the 48-page pool, and the warm burst
        again."""
        import numpy as np
        rng = np.random.default_rng(SEED + 2)
        sys_p = rng.integers(0, cfg.vocab_size, 256).astype(np.int32)
        warm = [np.concatenate([sys_p, rng.integers(
            0, cfg.vocab_size, n).astype(np.int32)]) for n in (8, 19, 33, 47)]
        churn = [rng.integers(0, cfg.vocab_size, 400).astype(np.int32)
                 for _ in range(4)]
        return sys_p, [("seed", [sys_p]), ("warm", warm),
                       ("full hit", [sys_p.copy()]), ("churn", churn),
                       ("warm again", warm)]

    def serve_bursts(self, params, cfg, ecfg, bursts, new, on_step=None,
                     before=None):
        """Serve each burst to the end before submitting the next; ->
        (engine, [requests per burst], wall seconds)."""
        from repro_torch.serve import Engine, Request
        torch = self.torch
        eng = Engine(params, cfg, ecfg)
        out, uid = [], 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for name, prompts in bursts:
            if before is not None:
                before(eng, name)
            reqs = [Request(uid=uid + i, prompt=p, max_new_tokens=new)
                    for i, p in enumerate(prompts)]
            uid += len(reqs)
            for r in reqs:
                eng.submit(r)
            while eng.sched.busy:
                eng.step()
                if on_step is not None:
                    on_step(eng)
            out.append(reqs)
        torch.cuda.synchronize()
        return eng, out, time.perf_counter() - t0

    PREFIX_BASE = dict(slots=4, max_len=512, prefill_chunk=64, paged=True,
                       page_tokens=16, n_pages=48)

    def serve_cold(self, params, cfg, bursts, new):
        """A cold paged engine (no prefix cache, no host tier) on the
        prefix trace, each distinct burst served once: every burst meets
        the same idle engine with all its pages free, so a repeated
        burst's requests would repeat the first's.  -> (requests per
        burst of ``bursts``, tokens served, wall seconds, steps)."""
        from repro_torch.serve import EngineConfig
        keys = [tuple(p.tobytes() for p in ps) for _, ps in bursts]
        first = {}
        for i, k in enumerate(keys):
            first.setdefault(k, i)
        eng, served, wall = self.serve_bursts(
            params, cfg, EngineConfig(**self.PREFIX_BASE),
            [bursts[i] for i in first.values()], new)
        by_key = dict(zip(first, served))
        n_tok = sum(len(r.generated) for b in served for r in b)
        return [by_key[k] for k in keys], n_tok, wall, eng.steps

    def phase_prefix(self, params=None, cfg=None):
        """Prefix-cached paged serving with the host spill tier at full
        width; the counts are set to 0 just before the prefix engine
        runs and read just after.  Then the same trace on 16- and 8-bit
        pools (``narrow_prefix``): the model cast once to bfloat16
        compute (its cache at the compute dtype), and the float32 model
        with a float8_e4m3fn cache."""
        import dataclasses
        import numpy as np
        torch = self.torch
        from repro_torch.models.transformer import forward
        from repro_torch.serve import EngineConfig, greedy_reference
        if params is None:
            params, cfg = self.pruned_gpt2()
        if not self.kv_err:
            self.kv_dtype_decode(params, cfg)
        sys_p, bursts = self.prefix_trace(cfg)
        base = self.PREFIX_BASE
        new = 32
        seen = {}
        spent = {"engine.spill": [0, 0.0], "engine.page_copy": [0, 0.0],
                 "engine.page_restore": [0, 0.0]}

        def timer(name, fn):
            def timed_call(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                spent[name][0] += 1
                spent[name][1] += time.perf_counter() - t0
                return out
            return timed_call

        # the parts of each restore batch and of sampled spill reads, on
        # the host clock with a synchronize at every boundary
        parts = Counter()
        batches = []         # per restore batch: its host side and parts

        def synced(name, fn):
            def run(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                parts[name] += time.perf_counter() - t0
                return out
            return run

        def restore_in_parts(exe):
            """``exe.page_restore`` with its ids and launch (the mover
            call, its planning included) timed, and its host side run
            both ways on the same slabs, each timed, in turns (one first
            on even batches, the other on odd ones): the executor's own
            (``exe._rows_to_device``: one pageable copy per leaf, whose
            slabs the launch takes) and every leaf's slabs packed into
            one reused page-locked buffer, then one copy (its packing
            timed apart; the first batch pays the buffer's allocation;
            patched here, the executor has no such option).  The rest is
            the checks."""
            from repro_torch.kernels import ops
            restore = exe.page_restore
            pinned = []                      # [buffer, event of its copy]

            def packed_pinned(rows, leaves):
                def pack():
                    offs, total = [], 0
                    for r in rows:
                        offs.append(total)
                        total += -(-r.nbytes // 16) * 16
                    if not pinned or pinned[0].numel() < total:
                        pinned[:] = [torch.empty((total,), dtype=torch.uint8,
                                                 pin_memory=True), None]
                    elif pinned[1] is not None:
                        pinned[1].synchronize()
                    for r, off in zip(rows, offs):
                        flat = np.ascontiguousarray(r).reshape(-1).view(
                            np.uint8)
                        pinned[0][off:off + flat.size].copy_(
                            torch.from_numpy(flat))
                    return offs, total

                offs, total = synced("restore packing", pack)()
                dev = pinned[0][:total].to(exe.device, non_blocking=True)
                pinned[1] = torch.cuda.Event()
                pinned[1].record()
                return [dev[o:o + r.nbytes].view(leaf.dtype).view(r.shape)
                        for leaf, r, o in zip(leaves, rows, offs)]

            def run(state, rows, dst):
                own = exe._rows_to_device
                ways = [("restore pageable per leaf", own),
                        ("restore pinned packed", packed_pinned)]
                if len(batches) % 2:
                    ways.reverse()

                def both(rows_, leaves):
                    out = {}
                    for name, fn in ways:
                        out[name] = synced(name, fn)(rows_, leaves)
                    return out["restore pageable per leaf"]

                saved = (exe._page_ids, ops.page_restore_leaves)
                before = dict(parts)
                exe._page_ids = synced("restore ids", saved[0])
                exe._rows_to_device = both
                ops.page_restore_leaves = synced("restore launch", saved[1])
                try:
                    return synced("restore total", restore)(state, rows,
                                                            dst)
                finally:
                    exe._page_ids, ops.page_restore_leaves = saved
                    del exe._rows_to_device
                    batches.append((ways[0][0][8:],
                                    {k: parts[k] - before.get(k, 0.0)
                                     for k in parts
                                     if k.startswith("restore")}))
            return run

        # the sampled replays' host copies, held to the phase's end:
        # freed, their pages would serve the next spill read's, which the
        # replay must not warm
        replayed = []
        SPILL_SAMPLE = 8

        def spill_in_parts(eng, read):
            """After every SPILL_SAMPLE-th spill read (``read``, the
            span), its steps again on the same page, each timed: the
            device gather of ``leaf[:, page]``, the device->host copy
            into new pageable memory and the numpy view of every KV leaf
            (``read_page``'s own code is not touched)."""
            from repro_torch.serve.executor import _HOST_VIEWS, _kv_leaves
            n = [0]

            def run(page):
                rows = read(page)
                n[0] += 1
                if (n[0] - 1) % SPILL_SAMPLE:
                    return rows
                parts["spill sampled"] += 1
                for leaf in _kv_leaves(eng.state["blocks"]):
                    g = synced("spill gather", lambda: leaf[:, page].view(
                        _HOST_VIEWS.get(leaf.dtype, leaf.dtype))
                        .contiguous())()
                    h = synced("spill device->host", g.to)("cpu")
                    replayed.append(h)
                    synced("spill numpy", h.numpy)()
                return rows
            return run

        def before(eng, name):
            if name == "seed":
                eng.prefix.page_reader = spill_in_parts(
                    eng, timer("engine.spill", eng.prefix.page_reader))
                eng.exe.page_copy = timer("engine.page_copy",
                                          eng.exe.page_copy)
                eng.exe.page_restore = timer("engine.page_restore",
                                             restore_in_parts(eng.exe))
            if name == "warm again":
                seen["churned"] = eng.prefix.match(sys_p) == []

        steps = [0]

        def on_step(eng):
            steps[0] += 1
            eng.alloc.assert_consistent(eng.prefix,
                                        context=f"prefix step {steps[0]}")

        self.reset_counts()
        start, routes0 = self.counts(), self.mover_routes()
        eng, warm, wall = self.serve_bursts(
            params, cfg, EngineConfig(prefix_cache=True, host_pages=192,
                                      **base),
            bursts, new, on_step=on_step, before=before)
        end, routes1 = self.counts(), self.mover_routes()
        reqs = [r for b in warm for r in b]
        n_tok = sum(len(r.generated) for r in reqs)
        itl = [d for r in reqs for d in np.diff(r.token_times)]
        st = eng.stats()
        print(f"prefix engine: {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} tokens/s, mean ITL "
              f"{1e3 * float(np.mean(itl)):.2f} ms, {eng.steps} steps, "
              f"prefix hits {st['prefix_hits']} "
              f"({st['prefix_hit_tokens']} tokens), host spills "
              f"{st['host_spills']}, restores {st['host_restores']}, "
              f"dropped {st['host_dropped']}, preemptions "
              f"{st['preemptions']}, compiled shapes "
              f"{eng.compiled_shapes()} [{self.card}]")
        for name, (calls, sec) in spent.items():
            print(f"  {name}: {calls} calls, {1e3 * sec:.1f} ms = "
                  f"{sec / wall:.2%} of the phase's wall")
        def in_parts(first, b):
            ms = {k: 1e3 * b.get(f"restore {k}", 0.0) for k in (
                "ids", "pageable per leaf", "launch", "total",
                "pinned packed", "packing")}
            span = ms.pop("total") - ms["pinned packed"]
            ms["rest"] = span - sum(ms[k] for k in ("ids",
                                                    "pageable per leaf",
                                                    "launch"))
            ms["span"] = span
            return (f"{first} first: " + ", ".join(
                f"{k} {v:.3f}" for k, v in ms.items()))

        alt = 1e3 * parts["restore pinned packed"]
        print("  restore batches in parts (ms per batch, in order, a "
              "synchronize at each boundary; the span is the executor's "
              "own, without the patched pinned packed host side, which "
              f"ran beside it on the same slabs: {alt:.1f} ms of "
              "engine.page_restore's): " + "; ".join(
                  in_parts(*b) for b in batches) + f" [{self.card}]")
        n_spill = int(parts["spill sampled"])
        print(f"  spill read in parts (per read, {n_spill} of "
              f"{spent['engine.spill'][0]} reads, every {SPILL_SAMPLE}th, "
              "each replayed after the read on the same page): " + ", ".join(
                  f"{k[6:]} {1e3 * parts[k] / max(1, n_spill):.3f} ms"
                  for k in ("spill gather", "spill device->host",
                            "spill numpy")) + f" [{self.card}]")
        replayed.clear()
        grew = {k: end[k] - start[k] for k in end}
        grew.update({k: routes1[k] - routes0[k] for k in routes1})
        print(f"phase prefix: launches {grew}")
        for k in ("page_copy", "page_restore", "paged_flash_decode"):
            if grew[k] <= 0:
                self.fail(f"{k} never launched in phase prefix")
        self.movers_per_batch("prefix", grew, {
            k: spent[f"engine.{k}"][0] for k in ("page_copy", "page_restore")})
        self.launches["page_copy"] = grew["page_copy"]
        self.launches["page_restore"] = grew["page_restore"]
        if eng.compiled_shapes() != 4:
            self.fail(f"prefix: compiled_shapes {eng.compiled_shapes()}")
        if not seen.get("churned"):
            self.fail("prefix: the churn burst left the system prompt in "
                      "the trie")
        if eng.host.spills < 1 or eng.host.restores < 1:
            self.fail(f"prefix: spills {eng.host.spills}, restores "
                      f"{eng.host.restores}")
        if not all(r.cached_tokens > 0 for r in warm[1]):
            self.fail("prefix: a first-burst request missed the trie")
        if warm[2][0].cached_tokens != 255:
            self.fail(f"prefix: the full hit resumed at "
                      f"{warm[2][0].cached_tokens}, not 255")
        pool = eng.state["blocks"][0]["kv"]["k"]
        if eng.alloc.n_pages != 48 or pool.shape[1] != 49:
            self.fail("prefix: the pool changed size")
        if not all(r.done for r in reqs):
            self.fail("prefix: requests left unfinished")
        del eng

        cold, n_cold, cold_wall, cold_steps = self.serve_cold(
            params, cfg, bursts, new)
        print(f"cold paged engine, same trace (each distinct burst once): "
              f"{n_cold} tokens in {cold_wall:.3f} s = "
              f"{n_cold / cold_wall:.1f} tokens/s, {cold_steps} steps "
              f"[{self.card}]")

        def ttft(rs):
            return float(np.mean([r.token_steps[0] - r.submit_step
                                  for r in rs]))

        t_warm, t_cold = ttft(warm[4]), ttft(cold[4])
        print(f"second warm burst: mean TTFT {t_warm:.2f} steps with the "
              f"prefix cache, {t_cold:.2f} steps cold")
        if not t_warm < t_cold:
            self.fail("prefix: the restored burst's TTFT is not below the "
                      "cold engine's")
        for (name, prompts), w, c in zip(bursts, warm, cold):
            self.compare_streams(f"prefix {name}", w,
                                 [r.generated for r in c], prompts, params,
                                 cfg, forward, against="the cold engine")
        checked = [(warm[2][0], sys_p), (warm[4][0], bursts[4][1][0]),
                   (warm[1][0], bursts[1][1][0])]
        refs = [greedy_reference(params, cfg, p, new) for _, p in checked]
        self.compare_streams("prefix checked", [r for r, _ in checked],
                             refs, [p for _, p in checked], params, cfg,
                             forward)
        plain = {k: v for k, v in self.counts().items()
                 if k.endswith("_ref") and v}
        if plain:
            self.fail(f"plain versions ran in the prefix phase: {plain}")

        # the narrow runs' references: the float32 model's greedy streams
        # of every prompt at NARROW_NEW tokens (the checked ones' kept)
        known = {p.tobytes(): r[:NARROW_NEW] for (_, p), r in
                 zip(checked, refs)}
        t0 = time.perf_counter()
        for p in (p for _, ps in bursts for p in ps):
            if p.tobytes() not in known:
                known[p.tobytes()] = greedy_reference(params, cfg, p,
                                                      NARROW_NEW)
        self.sync()
        print(f"greedy_reference (narrow prefix runs): {len(known)} "
              f"streams of {NARROW_NEW} tokens in "
              f"{time.perf_counter() - t0:.1f} s")
        self.narrow_prefix(
            "bfloat16 compute", self.bf16_weights(params),
            dataclasses.replace(cfg, param_dtype="bfloat16",
                                compute_dtype="bfloat16"),
            params, cfg, sys_p, bursts, known,
            self.kv_err["bfloat16 compute"])
        self.narrow_prefix(
            "float8_e4m3fn cache", params,
            dataclasses.replace(cfg, kv_cache_dtype="float8_e4m3fn"),
            params, cfg, sys_p, bursts, known,
            self.kv_err["float8_e4m3fn cache"])

    def movers_per_batch(self, tag, grew, batches):
        """Each mover launched once per executor batch (one launch over
        every KV leaf), each time on the bulk route (every pool the repo
        serves has rows of a multiple of 16 bytes)."""
        for k, n in batches.items():
            route = f"{k}.bulk"
            print(f"{tag}: {k} {n} batches, {grew.get(k, 0)} launches, "
                  f"{grew.get(route, 0)} on {route}")
            if not grew.get(k, 0) == grew.get(route, 0) == n:
                self.fail(f"{tag}: {k} launched {grew.get(k, 0)} times "
                          f"({grew.get(route, 0)} on {route}) for {n} "
                          "batches")

    def narrow_prefix(self, label, params, cfg, ref_params, ref_cfg, sys_p,
                      bursts, refs, err):
        """The prefix trace on a 16- or 8-bit pool, NARROW_NEW tokens a
        request, its bytes checked wherever they move: every page the
        trie spills is kept by digest (its rows must be the uint16 /
        uint8 bit patterns); right after each copy-on-write batch every
        destination holds the bytes its source held (pairs in order);
        right after each restore every restored page holds its slab's
        bytes, and the slab is a spilled page's; the system prompt's
        pages read before the churn equal those read after the second
        burst restored them.  The counts are set to 0 just before the
        engine runs and read just after: both movers and the paged
        decode launch, no plain version runs.  4 step shapes, the
        allocator consistent every step.  Streams token for token equal
        to a cold paged engine's (no prefix cache, no host tier) of the
        same numerics on the same bursts: the pages a warm request reads
        after a hit, a copy-on-write or a restore hold what a cold
        prefill writes.  Then, a second report, equal to the float32
        model's ``greedy_reference`` (``refs``) up to a near-tie: a
        top-2 gap under 2 x ``err`` max |logit|, ``err`` the logits
        error ``kv_dtype_decode`` measured for these numerics."""
        import hashlib
        import numpy as np
        from repro_torch.models.transformer import forward
        from repro_torch.serve import EngineConfig
        seen, done = {}, Counter()
        spilled = set()

        def digest(slabs):
            h = hashlib.sha1()
            for a in slabs:
                h.update(a.tobytes())
            return h.hexdigest()

        def same(got, want):
            return all(np.array_equal(g, w) for g, w in zip(got, want))

        def install(eng):
            exe = eng.exe
            reader = eng.prefix.page_reader
            copy, restore = exe.page_copy, exe.page_restore

            def spill(page):
                rows = reader(page)
                if any(r.dtype.kind != "u" for r in rows):
                    self.fail(f"prefix {label}: spilled rows of "
                              f"{[str(r.dtype) for r in rows]}")
                spilled.add(digest(rows))
                done["spilled"] += 1
                return rows

            def checked_copy(state, src, dst):
                pairs = list(zip(map(int, src), map(int, dst)))
                want = {p: exe.read_page(state, p) for pair in pairs
                        for p in pair}
                for a, b in pairs:
                    want[b] = want[a]
                state = copy(state, src, dst)
                done["copy batches"] += 1
                for b in {b for _, b in pairs}:
                    if not same(exe.read_page(state, b), want[b]):
                        self.fail(f"prefix {label}: copy-on-write page {b} "
                                  "differs from its source's bytes")
                done["copied"] += sum(a != b for a, b in pairs)
                return state

            def checked_restore(state, rows, dst):
                state = restore(state, rows, dst)
                done["restore batches"] += 1
                for i, p in enumerate(map(int, dst)):
                    if p == eng.alloc.sentinel:
                        continue
                    slab = [r[:, i] for r in rows]
                    if digest(slab) not in spilled:
                        self.fail(f"prefix {label}: page {p} restored "
                                  "from bytes no spill read")
                    if not same(exe.read_page(state, p), slab):
                        self.fail(f"prefix {label}: restored page {p} "
                                  "differs from its slab")
                    done["restored"] += 1
                return state

            eng.prefix.page_reader = spill
            exe.page_copy, exe.page_restore = checked_copy, checked_restore

        def before(eng, name):
            if name == "seed":
                install(eng)
            if name == "churn":
                seen["sys"] = [eng.exe.read_page(eng.state, p)
                               for p in eng.prefix.match(sys_p)]
            if name == "warm again":
                seen["churned"] = eng.prefix.match(sys_p) == []

        steps = [0]

        def on_step(eng):
            steps[0] += 1
            eng.alloc.assert_consistent(
                eng.prefix, context=f"prefix {label} step {steps[0]}")

        self.reset_counts()
        start, routes0 = self.counts(), self.mover_routes()
        eng, warm, wall = self.serve_bursts(
            params, cfg, EngineConfig(prefix_cache=True, host_pages=192,
                                      **self.PREFIX_BASE),
            bursts, NARROW_NEW, on_step=on_step, before=before)
        end, routes1 = self.counts(), self.mover_routes()
        grew = {k: end[k] - start[k] for k in end if end[k] != start[k]}
        self.movers_per_batch(f"prefix {label}", dict(grew, **{
            k: routes1[k] - routes0[k] for k in routes1}), {
            "page_copy": done["copy batches"],
            "page_restore": done["restore batches"]})
        pool = eng.state["blocks"][0]["kv"]["k"]
        st = eng.stats()
        n_tok = sum(len(r.generated) for b in warm for r in b)
        print(f"prefix {label} ({pool.dtype} pool): {n_tok} tokens in "
              f"{wall:.3f} s, {eng.steps} steps, prefix hits "
              f"{st['prefix_hits']}, host spills {st['host_spills']}, "
              f"restores {st['host_restores']}, compiled shapes "
              f"{eng.compiled_shapes()}; bytes checked: {done['spilled']} "
              f"spill reads, {done['copied']} copy-on-write pairs, "
              f"{done['restored']} restored pages; launches {grew} "
              f"[{self.card}]")
        for k in ("page_copy", "page_restore", "paged_flash_decode"):
            if grew.get(k, 0) <= 0:
                self.fail(f"prefix {label}: {k} never launched")
        plain = {k: v for k, v in grew.items() if k.endswith("_ref")}
        if plain:
            self.fail(f"prefix {label}: plain versions ran: {plain}")
        if pool.dtype not in (self.torch.bfloat16,
                              self.torch.float8_e4m3fn):
            self.fail(f"prefix {label}: the pool is {pool.dtype}")
        if eng.compiled_shapes() != 4:
            self.fail(f"prefix {label}: compiled_shapes "
                      f"{eng.compiled_shapes()}")
        if not (seen.get("churned") and len(seen.get("sys", ())) == 16):
            self.fail(f"prefix {label}: the churn did not spill the "
                      "system prompt's 16 pages")
        if min(done["spilled"], done["copied"], done["restored"]) < 1:
            self.fail(f"prefix {label}: bytes checked {dict(done)}")
        if warm[2][0].cached_tokens != 255 or not all(
                r.cached_tokens > 0 for r in warm[1] + warm[4]):
            self.fail(f"prefix {label}: a warm request missed the trie")
        if not all(r.done for b in warm for r in b):
            self.fail(f"prefix {label}: requests left unfinished")
        hit = eng.prefix.match(sys_p)
        if len(hit) != 16 or not all(
                same(eng.exe.read_page(eng.state, p), old)
                for p, old in zip(hit, seen.get("sys", ()))):
            self.fail(f"prefix {label}: the system prompt's restored pages "
                      "differ from the bytes spilled")
        del eng
        cold, _, cold_wall, cold_steps = self.serve_cold(
            params, cfg, bursts, NARROW_NEW)
        print(f"cold {label} paged engine, same trace (each distinct burst "
              f"once): {cold_steps} steps in {cold_wall:.3f} s "
              f"[{self.card}]")
        for (name, ps), w, c in zip(bursts, warm, cold):
            self.compare_streams(f"prefix {label} {name}", w,
                                 [r.generated for r in c], ps, params, cfg,
                                 forward, against=f"the cold {label} engine",
                                 tie_rel=0.0)
        reqs = [r for b in warm for r in b]
        prompts = [p for _, ps in bursts for p in ps]
        self.compare_streams(f"prefix {label}", reqs,
                             [refs[p.tobytes()] for p in prompts], prompts,
                             ref_params, ref_cfg, forward,
                             tie_rel=2 * err)

    # ---- phase 20: training at scale ----------------------------------
    TD_LAYERS = 4               # gpt2-xl at its full width, 48 -> 4 layers
    TD_BATCH, TD_SEQ = 2, 1024
    TD_LR = 1e-4
    TD_STEPS, TD_EVERY, TD_FAIL = 6, 3, 4    # (a): checkpoints at 3 and 6
    TD_RANK_STEPS = 3                        # (b): each run's steps
    TD_TOL = 1e-4       # loss / grad_norm against (a): float32 sums reordered
    # the pod run: one step of the int8 grid relative (the pods quantize
    # their shares on a common grid, the one-rank run their sum)
    TD_INT8_TOL = 1.0 / 127
    TD_MUSICGEN_LAYERS = 4      # (b)'s musicgen-large at (1, 2), 48 -> 4
    TD_PIPE_TOL = 1e-5  # pipeline vs its sequential composition, x max|ref|
    TD_TIMEOUT = 600.0

    def phase_train_dist(self):
        """Phase 20, training at scale (``launch.train``): (a) one rank
        through the launcher's path with the supervisor, async
        checkpoints and an injected ``WorkerFailure``, against a clean
        run; (b) two ranks under gloo on the one card, one spawn: data
        parallel + FSDP, tensor parallel (gpt2-xl and musicgen-large),
        int8 gradients across two pods and a two-stage GPipe pipeline;
        (c) the data-parallel run's
        checkpoint restored onto one rank and served.  Checkpoints go to
        a temporary directory that is deleted at the end."""
        import gc
        import shutil
        import tempfile
        torch = self.torch
        gc.collect()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        print(f"train_dist start: memory_allocated {mem0 / 1e9:.3f} GB")
        if mem0 > 2e9:
            self.fail(f"train_dist: {mem0 / 1e9:.3f} GB still allocated at "
                      "start")
        tmp = tempfile.mkdtemp(prefix="train_dist_")
        try:
            cfg = self.td_config()
            first = self.td_launcher(cfg, tmp)
            gc.collect()
            torch.cuda.empty_cache()
            ckpt = self.td_ranks(cfg, tmp, first)
            gc.collect()
            torch.cuda.empty_cache()
            self.td_serve_restored(cfg, ckpt)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        mem1 = torch.cuda.memory_allocated()
        print(f"train_dist end: memory_allocated {mem1 / 1e9:.3f} GB")
        if mem1 > mem0 + 1e8:
            self.fail(f"train_dist: {mem1 / 1e9:.3f} GB still allocated")

    def td_config(self):
        import dataclasses
        from repro_torch.configs import get_config
        cfg = dataclasses.replace(get_config("gpt2-xl"),
                                  n_layers=self.TD_LAYERS)
        print(f"train_dist: gpt2-xl d_model {cfg.d_model}, {cfg.n_heads} "
              f"heads of {cfg.head_dim_}, vocab {cfg.vocab_size}, cut to "
              f"{cfg.n_layers} layers; SyntheticLM ({self.TD_BATCH}, "
              f"{self.TD_SEQ}) seed {SEED}, lr {self.TD_LR}")
        return cfg

    def td_kw(self, steps, **kw):
        return dict(steps=steps, batch=self.TD_BATCH, seq=self.TD_SEQ,
                    lr=self.TD_LR, seed=SEED, **kw)

    def td_launcher(self, cfg, tmp):
        """(a): ``launch.train.train`` on one rank, checkpoints every
        ``TD_EVERY`` steps, clean and with a ``WorkerFailure`` at step
        ``TD_FAIL`` (rolled back to step 3 and replayed), under
        ``torch.use_deterministic_algorithms``: the final params must be
        the clean run's, bit for bit (else the bound is printed and
        held).  -> the clean run's metrics."""
        import os
        torch = self.torch
        from repro_torch.launch.train import train
        from repro_torch.tree import tree_leaves_with_path
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            runs = {}
            for tag, fail in (("clean", -1), ("failed", self.TD_FAIL)):
                self.reset_peak()
                t0 = time.perf_counter()
                out = train(cfg, ckpt_dir=os.path.join(tmp, tag),
                            ckpt_every=self.TD_EVERY, fail_at=fail,
                            log=None, **self.td_kw(self.TD_STEPS))
                wall = time.perf_counter() - t0
                rep = out.report
                n = sum(t.numel() for _, t in
                        tree_leaves_with_path(out.params))
                print(f"train_dist (a) {tag}: {n} float32 parameters, "
                      f"{rep.steps_run} steps, {rep.restarts} restarts, "
                      f"{len(rep.stragglers)} stragglers flagged, step ms "
                      f"{[round(x, 1) for x in out.step_ms]}, "
                      f"resident {torch.cuda.memory_allocated() / 1e9:.3f} "
                      f"GB, peak {self.peak_gb():.2f} GB, {wall:.1f} s "
                      f"[{self.card}]")
                for i, m in enumerate(rep.metrics_history):
                    print(f"train_dist (a) {tag} step {i}: loss "
                          f"{m['loss']:.6f} grad_norm {m['grad_norm']:.6f} "
                          f"lr_scale {m['lr_scale']:.4f}")
                runs[tag] = (dict(tree_leaves_with_path(out.params)),
                             rep)
                del out
                if not all(math.isfinite(v) for m in rep.metrics_history
                           for v in m.values()):
                    self.fail(f"train_dist (a) {tag}: non-finite metrics")
        finally:
            torch.use_deterministic_algorithms(False)
        (clean, crep), (failed, frep) = runs["clean"], runs["failed"]
        if (crep.restarts, frep.restarts) != (0, 1) or \
                frep.steps_run != self.TD_STEPS + self.TD_FAIL - self.TD_EVERY:
            self.fail(f"train_dist (a): restarts {crep.restarts} / "
                      f"{frep.restarts}, steps {frep.steps_run}")
        same = all(torch.equal(clean[p], failed[p]) for p in clean)
        err = max((clean[p] - failed[p]).abs().max().item() for p in clean)
        scale = max(clean[p].abs().max().item() for p in clean)
        print(f"train_dist (a): restarted run vs clean run: "
              f"{'bitwise equal' if same else 'NOT bitwise'} under "
              f"deterministic algorithms, max |dparam| {err:.3e} "
              f"(max |param| {scale:.3e})")
        if not same and err > 1e-6 * scale:
            self.fail(f"train_dist (a): the restarted run's params differ "
                      f"by {err:.3e}")
        return crep.metrics_history[:self.TD_RANK_STEPS]

    def td_one_rank(self, cfg, tag, mesh=None, **kw):
        """``launch.train.train`` of ``cfg`` on one rank for
        ``TD_RANK_STEPS`` steps, no checkpoints (on ``mesh`` when given):
        -> its metrics, printed."""
        from repro_torch.launch.train import train
        out = train(cfg, ckpt_dir=None, log=None, mesh=mesh,
                    **self.td_kw(self.TD_RANK_STEPS, **kw))
        rep = out.report.metrics_history
        del out
        for i, m in enumerate(rep):
            print(f"train_dist (b) one rank, {tag}, step {i}: loss "
                  f"{m['loss']:.6f} grad_norm {m['grad_norm']:.6f}")
        if not all(math.isfinite(v) for m in rep for v in m.values()):
            self.fail(f"train_dist (b) one rank, {tag}: non-finite metrics")
        return rep

    def td_ranks(self, cfg, tmp, first):
        """(b): one spawn of two ranks under gloo on the card runs, in
        order, (data 2, model 1) with a checkpoint at its end, (1, 2),
        (pod 2, data 1, model 1) with ``grad_compress``, musicgen-large
        cut to ``TD_MUSICGEN_LAYERS`` layers at (1, 2) (its 32 heads, ff
        and vocab split: the attention backward runs split) -- 3 steps
        each -- and ``pipeline_apply`` over two gpt2-xl-width layers (4
        microbatches of (1, 256)) against their sequential composition.
        Every step's loss and grad_norm are held against a one-rank run
        on the same data: gpt2-xl's against (a)'s first steps at
        ``TD_TOL``; musicgen's against its one-rank run at ``TD_TOL``;
        the pod run's at ``TD_INT8_TOL`` against a one-rank run with
        ``grad_compress`` on a (1, 1, 1) pod mesh (the whole gradient
        quantized, the reference's arithmetic at any pod count) and
        against (a)'s.  Per rank: step ms, resident and peak GB,
        collectives by kind and the host ms inside them.  -> the
        checkpoint directory of the data-parallel run."""
        import dataclasses
        import functools
        import gc
        import os
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch import train as LT
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.transformer import init_lm_params
        ckpt = os.path.join(tmp, "data2")
        mcfg = dataclasses.replace(get_config("musicgen-large"),
                                   n_layers=self.TD_MUSICGEN_LAYERS)
        print(f"train_dist (b): musicgen-large d_model {mcfg.d_model}, "
              f"{mcfg.n_heads} heads of {mcfg.head_dim_}, d_ff {mcfg.d_ff}, "
              f"vocab {mcfg.vocab_size}, cut to {mcfg.n_layers} layers")
        int8 = self.td_one_rank(cfg, "gpt2-xl grad_compress on a (1, 1, 1) "
                                "pod mesh", grad_compress=True,
                                mesh=make_mesh((1, 1, 1),
                                               ("pod", "data", "model")))
        mrep = self.td_one_rank(mcfg, "musicgen-large")
        gc.collect()
        torch.cuda.empty_cache()
        # label -> (run, [(reference, its name, tolerance)])
        checks = {
            "data 2": (LT.TrainRun(
                "data 2", cfg, (2, 1), ("data", "model"),
                self.td_kw(self.TD_RANK_STEPS, ckpt_dir=ckpt,
                           ckpt_every=100), digests=True),
                [(first, "(a)", self.TD_TOL)]),
            "model 2": (LT.TrainRun(
                "model 2", cfg, (1, 2), ("data", "model"),
                self.td_kw(self.TD_RANK_STEPS, ckpt_dir=None)),
                [(first, "(a)", self.TD_TOL)]),
            "pod 2": (LT.TrainRun(
                "pod 2", cfg, (2, 1, 1), ("pod", "data", "model"),
                self.td_kw(self.TD_RANK_STEPS, ckpt_dir=None,
                           grad_compress=True)),
                [(int8, "one-rank int8", self.TD_INT8_TOL),
                 (first, "(a)", self.TD_INT8_TOL)]),
            "musicgen model 2": (LT.TrainRun(
                "musicgen model 2", mcfg, (1, 2), ("data", "model"),
                self.td_kw(self.TD_RANK_STEPS, ckpt_dir=None)),
                [(mrep, "musicgen one rank", self.TD_TOL)])}
        runs = [run for run, _ in checks.values()]
        pcfg = dataclasses.replace(cfg, n_layers=2)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 20)
        stages = init_lm_params(pcfg, SEED + 20)["blocks"][0]
        x = self.randn(4, 256, cfg.d_model, gen=gen)
        runs.append(LT.PipeRun("pipe 2", (2,), ("pipe",), stages, x,
                               functools.partial(LT.block_stage, pcfg),
                               n_microbatches=4))
        t0 = time.perf_counter()
        per_rank = LT.train_ranks(runs, 2, backend="gloo",
                                  timeout=self.TD_TIMEOUT)
        print(f"train_dist (b): two ranks, {len(runs)} runs in "
              f"{time.perf_counter() - t0:.1f} s [{self.card}]")
        del stages, x, runs
        for j, (label, (_, refs)) in enumerate(checks.items()):
            for r, res in enumerate(rank[j] for rank in per_rank):
                c = res["collectives"]
                ms = res["step_ms"]
                print(f"train_dist (b) {label} rank {r} coords "
                      f"{res['coords']}: step ms "
                      f"{[round(v, 1) for v in ms]}, resident "
                      f"{res['resident_gb']:.3f} GB, peak "
                      f"{res['peak_gb']:.2f} GB, collectives "
                      f"{ {k: v for k, v in c.items() if k != 'seconds'} }, "
                      f"host ms inside them {1e3 * c['seconds']:.1f} "
                      f"({1e3 * c['seconds'] / max(1, len(ms)):.1f} per "
                      f"step) [{self.card}]")
                if len(res["metrics"]) != self.TD_RANK_STEPS:
                    self.fail(f"train_dist (b) {label} rank {r}: "
                              f"{len(res['metrics'])} steps")
                for i, got in enumerate(res["metrics"]):
                    if not all(math.isfinite(v) for v in got.values()):
                        self.fail(f"train_dist (b) {label} rank {r} step "
                                  f"{i}: non-finite metrics")
                    for want, name, tol in refs:
                        rel = {k: abs(got[k] - want[i][k]) / abs(want[i][k])
                               for k in ("loss", "grad_norm")}
                        bad = [k for k, v in rel.items() if v > tol]
                        print(f"train_dist (b) {label} rank {r} step {i}: "
                              f"loss {got['loss']:.6f} grad_norm "
                              f"{got['grad_norm']:.6f}; {name} "
                              f"{want[i]['loss']:.6f} / "
                              f"{want[i]['grad_norm']:.6f}, rel "
                              f"{rel['loss']:.2e} / {rel['grad_norm']:.2e} "
                              f"(tol {tol:.2e}) "
                              f"{'FAIL ' + str(bad) if bad else 'ok'}")
                        if bad:
                            self.fail(f"train_dist (b) {label} rank {r} "
                                      f"step {i}: {bad} off {name}'s")
            if label == "data 2" and per_rank[0][j]["digests"] != \
                    per_rank[1][j]["digests"]:
                self.fail("train_dist (b) data 2: the ranks' gathered "
                          "params differ")
        self.td_digests = per_rank[0][0]["digests"]
        pipe = [rank[len(checks)] for rank in per_rank]
        ref = pipe[0]["sequential"]
        scale = max(1.0, float(abs(ref).max()))
        for r, res in enumerate(pipe):
            err = float(abs(res["out"] - ref).max())
            c = res["collectives"]
            print(f"train_dist (b) pipe 2 rank {r}: max |pipeline - "
                  f"sequential| {err:.3e} (tol {self.TD_PIPE_TOL} x "
                  f"{scale:.3f}), {res['ms']:.1f} ms, sends {c['send']}, "
                  f"recvs {c['recv']}, broadcasts {c['broadcast']}")
            if err > self.TD_PIPE_TOL * scale:
                self.fail(f"train_dist (b) pipe 2 rank {r}: off the "
                          "sequential composition")
        return ckpt

    def td_serve_restored(self, cfg, ckpt):
        """(c): the (data 2) run's checkpoint restored onto one rank (the
        elastic path: full leaves, this rank's ``local_slice`` of a (1,
        1) mesh) must equal the ranks' gathered params bit for bit; then
        4 requests x 16 tokens through the dense ``Engine``, streams equal
        to ``greedy_reference`` (near-tie rule), ``flash_decode``
        launched, no plain version."""
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.train import digest
        from repro_torch.models.transformer import forward, init_lm_params
        from repro_torch.serve import EngineConfig, greedy_reference
        from repro_torch.train.checkpoint import CheckpointManager
        from repro_torch.train.step import train_specs
        from repro_torch.tree import tree_leaves_with_path
        cm = CheckpointManager(ckpt)
        mesh = make_host_mesh()
        like = init_lm_params(cfg, SEED + 1)
        specs = train_specs(like, mesh)
        t0 = time.perf_counter()
        got, extra = cm.restore(cm.latest_step(), {"params": like},
                                {"params": specs["params"]}, mesh)
        params = got["params"]
        del like, got
        wall = time.perf_counter() - t0
        same = {p: digest(t) == self.td_digests.get(p)
                for p, t in tree_leaves_with_path(params)}
        print(f"train_dist (c): restored step {cm.latest_step()} (extra "
              f"{extra}) in {wall:.1f} s; {sum(same.values())}/{len(same)} "
              f"leaves bit for bit the ranks' gathered params")
        if not all(same.values()) or set(same) != set(self.td_digests):
            self.fail("train_dist (c): the restored params differ from the "
                      "gathered ones")
        prompts = self.main_prompts(cfg)[:4]
        self.reset_counts()
        reqs = self.serve_main("train_dist restored dense", params, cfg,
                               EngineConfig(**MAIN_ENGINES[0][1]), prompts,
                               new=16)
        counts = {k: v for k, v in self.counts().items() if v}
        refs = [greedy_reference(params, cfg, p, 16) for p in prompts]
        self.compare_streams("train_dist restored dense", reqs, refs,
                             prompts, params, cfg, forward)
        print(f"train_dist (c): launches {counts}")
        if counts.get("flash_decode", 0) <= 0 or any(
                k.endswith("_ref") for k in counts):
            self.fail("train_dist (c): not served through flash_decode")
        del params

    # ---- phase 7 -----------------------------------------------------
    @staticmethod
    def uniform_budget(extras, cfg, qk_keep, vo_keep):
        """The uniform plan as a ``RankBudget`` with the planner's table
        shapes, so kept energy and pool bytes compare plan to plan."""
        from repro_torch.core.prune import RankBudget
        uq, uv, total = [], [], 0
        for ex in extras:
            sp = ex.get("spectra", {})
            if "vo" not in sp:
                uq.append(())
                uv.append(())
                continue
            nb, kv = sp["vo"].shape[:2]
            uq.append(tuple((qk_keep,) * kv for _ in range(nb)))
            uv.append(tuple((vo_keep,) * kv for _ in range(nb)))
            total += nb * kv * (qk_keep + vo_keep)
        return RankBudget(head_dim=cfg.head_dim_,
                          rank_multiple=cfg.clover.rank_multiple,
                          total_rank=total, budget=total,
                          qk_ranks=tuple(uq), vo_ranks=tuple(uv))

    def damped_decomposition(self, cfg, every=None):
        """Seeded weights with head ``h`` of layer ``i`` damped by 0.25
        in ``wq`` and ``wv`` where ``i + h`` is odd (random weights have
        flat spectra; the damping makes heads of one layer differ) or,
        with ``every``, in every layer where ``h % every == 0`` (the same
        heads in every layer, so their summed loads differ: phase 19's
        head partition is not the identity), decomposed -> (params, cfg,
        extras)."""
        torch = self.torch
        from repro_torch.core.decompose import clover_decompose
        from repro_torch.models.transformer import init_lm_params
        params = init_lm_params(cfg, SEED)
        attn = params["blocks"][0]["attn"]
        nb, H, KV = (attn["wq"].shape[0], attn["wq"].shape[2],
                     attn["wv"].shape[2])
        i = torch.arange(nb, device=self.dev)[:, None]
        h = torch.arange(H, device=self.dev)[None, :]
        damped = (i + h) % 2 == 1 if every is None else (h % every == 0) \
            & (i >= 0)
        damp = torch.where(damped, 0.25, 1.0)                     # (nb, H)
        attn["wq"].mul_(damp[:, None, :, None])
        attn["wv"].mul_(damp[:, None, :KV, None])
        return clover_decompose(params, cfg)

    def phase_budget(self):
        """A spectrum-planned rank budget at gpt2-xl's full width, served
        dense and paged through the rank-clamped kernels."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core.prune import (apply_rank_budget,
                                            budget_kept_energy, clover_prune,
                                            plan_rank_budget)
        from repro_torch.models.transformer import forward
        from repro_torch.serve import EngineConfig, greedy_reference
        from repro_torch.serve.memory import rank_pool_bytes

        cfg = get_config("gpt2-xl")
        dparams, dcfg, extras = self.damped_decomposition(cfg)
        upar, ucfg = clover_prune(dparams, dcfg, qk_ratio=0.5, vo_ratio=0.5)
        del upar
        uniform = self.uniform_budget(extras, dcfg, ucfg.qk_dim, ucfg.vo_dim)
        t0 = time.perf_counter()
        plan = plan_rank_budget(extras, dcfg, total_rank=uniform.total_rank)
        t_plan = time.perf_counter() - t0
        e_u = budget_kept_energy(extras, uniform)
        e_p = budget_kept_energy(extras, plan)
        spread = sum(len(set(row)) > 1 for t in (plan.qk_ranks,
                                                  plan.vo_ranks)
                     for j in t for row in j)
        flat = [r for t in (plan.qk_ranks, plan.vo_ranks) for j in t
                for row in j for r in row]
        print(f"budget plan ({t_plan:.2f} s on the host): total rank "
              f"{plan.total_rank} (uniform {ucfg.qk_dim}/{ucfg.vo_dim}: "
              f"{uniform.total_rank}), widths {plan.qk_width}/"
              f"{plan.vo_width}, head ranks {min(flat)}-{max(flat)}, "
              f"{spread} of {2 * cfg.n_layers} (layer, family) rows "
              f"non-uniform across heads")
        print(f"budget kept energy: planned {e_p:.6f} vs uniform "
              f"{e_u:.6f} ({e_p / e_u:.4f}x)")
        if not e_p >= e_u:
            self.fail("budget: planned kept energy below uniform's")
        if spread == 0:
            self.fail("budget: the plan is uniform within every layer")
        for name, pl in (("uniform", uniform), ("planned", plan)):
            pb = rank_pool_bytes(pl, page_tokens=16, n_pages=48)
            print(f"rank_pool_bytes {name} (16-token pages, 48 + 1 rows): "
                  f"kept {pb['kept']} B, allocated {pb['allocated']} B "
                  f"({pb['kept'] / pb['allocated']:.1%} used)")
        bparams, bcfg = apply_rank_budget(dparams, dcfg, plan)
        del dparams
        if (bcfg.qk_dim, bcfg.vo_dim) != (plan.qk_width, plan.vo_width):
            self.fail("budget: served widths differ from the plan's")
        self.budget_kernels(plan)

        prompts = self.main_prompts(cfg)
        runs = {}
        for name, ek in MAIN_ENGINES:
            self.reset_counts()
            runs[name] = self.serve_main(
                f"budget {name}", bparams, bcfg,
                EngineConfig(rank_budget=plan, **ek), prompts)
            grew = self.counts()
            print(f"phase budget {name}: launches "
                  f"{ {k: v for k, v in grew.items() if v} }")
            ranked = ("flash_decode_ranked" if name == "dense"
                      else "paged_flash_decode_ranked")
            self.launches[ranked] = grew[ranked]
            if grew[ranked] <= 0:
                self.fail(f"{ranked} never launched in phase budget {name}")
            ran = {k: v for k, v in grew.items() if v and (
                k.endswith("_ref") or k in ("flash_decode",
                                            "paged_flash_decode"))}
            if ran:
                self.fail(f"budget {name}: unranked decode kernels or "
                          f"plain versions ran: {ran}")
        self.reset_counts()
        t0 = time.perf_counter()
        refs = [greedy_reference(bparams, bcfg, p, 32) for p in prompts]
        torch.cuda.synchronize()
        print(f"greedy_reference (budgeted model): {len(refs)} streams in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, reqs in runs.items():
            self.compare_streams(f"budget {name}", reqs, refs, prompts,
                                 bparams, bcfg, forward)
        plain = {k: v for k, v in self.counts().items()
                 if k.endswith("_ref") and v}
        if plain:
            self.fail(f"plain versions ran in the budget phase: {plain}")
        self.budget_spec(bparams, bcfg, plan, prompts, runs, refs)
        return bparams, bcfg, plan

    def budget_spec(self, params, cfg, plan, prompts, runs, refs):
        """The budget engines again at spec_k 2 (draft_rank_ratio 0.5):
        the draft reads the budgeted cache through its row stride, with
        the plan's ranks clamped to the draft widths.  Every stream
        equals the non-speculative engine's and ``greedy_reference``
        (near-tie rule); the ranked kernels launch strided, and no
        unranked decode kernel or plain version runs."""
        from repro_torch.core.prune import draft_ranks
        from repro_torch.kernels.decode_attention import flash_decode_ranked
        from repro_torch.kernels.paged_decode_attention import \
            paged_flash_decode_ranked
        from repro_torch.models.transformer import forward
        from repro_torch.serve import EngineConfig
        print(f"budget spec: draft widths {draft_ranks(cfg, DRAFT_RATIO)} "
              f"of {(cfg.qk_dim, cfg.vo_dim)}")
        strided = {}
        for name, ek in MAIN_ENGINES:
            kern = (flash_decode_ranked if name == "dense"
                    else paged_flash_decode_ranked)
            self.reset_counts()
            s0 = kern.strided_launches
            tag = f"budget {name} spec k2"
            reqs = self.serve_main(tag, params, cfg, EngineConfig(
                rank_budget=plan, spec_k=2, draft_rank_ratio=DRAFT_RATIO,
                **ek), prompts)
            grew = self.counts()
            strided[kern.__name__] = kern.strided_launches - s0
            print(f"phase {tag}: launches "
                  f"{ {k: v for k, v in grew.items() if v} }, strided "
                  f"(draft) {kern.__name__} {strided[kern.__name__]}")
            if strided[kern.__name__] <= 0:
                self.fail(f"{tag}: the draft never read the budgeted "
                          "cache through a row stride")
            ran = {k: v for k, v in grew.items() if v and (
                k.endswith("_ref") or k in ("flash_decode",
                                            "paged_flash_decode"))}
            if ran:
                self.fail(f"{tag}: unranked decode kernels or plain "
                          f"versions ran: {ran}")
            self.compare_streams(tag, reqs, [r.generated for r in
                                             runs[name]], prompts, params,
                                 cfg, forward,
                                 against=f"budget non-spec {name}")
            self.compare_streams(tag, reqs, refs, prompts, params, cfg,
                                 forward)
        self.launches["draft_ranked"] = strided

    def budget_kernels(self, plan):
        """The rank-clamped kernels at the budget engine's shapes: 4
        slots, 25 KV heads, lengths 300/200/150/60, the plan's widths and
        its layer-0 ranks, on the zero-padded data the plan serves.
        Parity against the plain versions (2e-5) and, bitwise, against
        the unranked kernels; then their times as in phase 3.  The
        bound counts the kept dims only: sum_b lengths[b] * sum_kv (rq +
        rv) * 4 bytes of K/V, q at its kept dims, the output, lengths,
        ranks and (paged) the page ids read."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ref
        from repro_torch.kernels.decode_attention import (
            flash_decode, flash_decode_ranked)
        from repro_torch.kernels.paged_decode_attention import (
            paged_flash_decode, paged_flash_decode_ranked)
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 6)
        scale = 1.0 / math.sqrt(64)
        rq_l, rv_l = plan.qk_ranks[0][0], plan.vo_ranks[0][0]
        B, T, KV, lens = 4, 576, len(rq_l), [300, 200, 150, 60]
        dq, dv = plan.qk_width, plan.vo_width
        rq, rv = self.ids32(rq_l), self.ids32(rv_l)
        lengths = self.ids32(lens)
        tot = sum(lens)
        kept = sum(rq_l) + sum(rv_l)
        shape = (f"B{B} H=KV={KV} dq{dq} dv{dv} lengths {lens}, layer-0 "
                 f"ranks qk {min(rq_l)}-{max(rq_l)} vo {min(rv_l)}-"
                 f"{max(rv_l)}")

        def bound(extra_ints):
            nbytes = 4 * (B * sum(rq_l) + tot * kept + B * KV * dv + B
                          + 2 * KV + extra_ints)
            return self.bound(nbytes, tot * 2 * kept)

        per_set = 4 * B * T * KV * (dq + dv)
        sets = [self.zero_pad(self.randn(B, KV, dq, gen=gen),
                              self.randn(B, T, KV, dq, gen=gen),
                              self.randn(B, T, KV, dv, gen=gen), rq, rv)
                for _ in range(self.copies(per_set))]
        s0 = sets[0]
        self.parity("flash_decode_ranked", "budget shapes, zero-padded",
                    flash_decode_ranked(*s0, lengths, rq, rv, scale=scale),
                    ref.decode_attention_ref(*s0, lengths, scale=scale,
                                             qk_ranks=rq, vo_ranks=rv))
        self.exact("flash_decode_ranked", "budget shapes, zero-padded",
                   flash_decode_ranked(*s0, lengths, rq, rv, scale=scale),
                   flash_decode(*s0, lengths, scale=scale))
        rk = dict(scale=scale, qk_ranks=rq, vo_ranks=rv)
        self.dtype_parity(
            "flash_decode_ranked", "budget shapes, zero-padded",
            lambda *a: flash_decode_ranked(*a, lengths, rq, rv, scale=scale),
            lambda *a: ref.decode_attention_ref(*a, lengths, **rk), *s0)
        mask = (torch.arange(T, device=self.dev)[None, :]
                < lengths[:, None].long())[:, None, None, :]
        sdpa = [(q[:, :, None], k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v in sets]
        self.times["flash_decode_ranked"] = (
            self.time_ms([lambda s=s: flash_decode_ranked(
                *s, lengths, rq, rv, scale=scale) for s in sets]),
            self.time_ms([lambda s=s: ref.decode_attention_ref(
                *s, lengths, scale=scale, qk_ranks=rq, vo_ranks=rv)
                for s in sets]),
            self.time_ms([lambda s=s: F.scaled_dot_product_attention(
                *s, attn_mask=mask, scale=scale) for s in sdpa]),
            bound(0), shape)
        self.narrow_times(
            "flash_decode_ranked",
            lambda *a: flash_decode_ranked(*a, lengths, rq, rv, scale=scale),
            lambda *a: ref.decode_attention_ref(
                *a, lengths, scale=scale, qk_ranks=rq, vo_ranks=rv),
            sets, lambda e: 2 * (B * sum(rq_l) + B * KV * dv)
            + 4 * (B + 2 * KV) + tot * kept * e, tot * 2 * kept, shape,
            library=lambda q, k, v: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, scale=scale))
        del sets, sdpa

        pt, n_pages, n_p = 16, 48, 36
        cases = []
        for _ in range(self.copies(4 * (n_pages + 1) * pt * KV * (dq + dv))):
            q, kp, vp, tab, _ = self.paged_case(gen, B, KV, KV, dq, dv, pt,
                                                n_pages, n_p, lens)
            cases.append((*self.zero_pad(q, kp, vp, rq, rv), tab))
        c0 = cases[0]
        self.parity("paged_flash_decode_ranked", "budget shapes, zero-padded",
                    paged_flash_decode_ranked(*c0, lengths, rq, rv,
                                              scale=scale),
                    ref.paged_decode_attention_ref(*c0, lengths, scale=scale,
                                                   qk_ranks=rq, vo_ranks=rv))
        self.exact("paged_flash_decode_ranked", "budget shapes, zero-padded",
                   paged_flash_decode_ranked(*c0, lengths, rq, rv,
                                             scale=scale),
                   paged_flash_decode(*c0, lengths, scale=scale))
        self.dtype_parity(
            "paged_flash_decode_ranked", "budget shapes, zero-padded",
            lambda *a: paged_flash_decode_ranked(*a, c0[3], lengths, rq, rv,
                                                 scale=scale),
            lambda *a: ref.paged_decode_attention_ref(*a, c0[3], lengths,
                                                      **rk), *c0[:3])
        pages = sum(-(-n // pt) for n in lens)
        self.times["paged_flash_decode_ranked"] = (
            self.time_ms([lambda c=c: paged_flash_decode_ranked(
                *c, lengths, rq, rv, scale=scale) for c in cases]),
            self.time_ms([lambda c=c: ref.paged_decode_attention_ref(
                *c, lengths, scale=scale, qk_ranks=rq, vo_ranks=rv)
                for c in cases]),
            None, bound(pages), f"pt{pt} pool {n_pages}+1 pages, {shape}")
        self.narrow_times(
            "paged_flash_decode_ranked",
            lambda *c: paged_flash_decode_ranked(*c, lengths, rq, rv,
                                                 scale=scale),
            lambda *c: ref.paged_decode_attention_ref(
                *c, lengths, scale=scale, qk_ranks=rq, vo_ranks=rv),
            cases, lambda e: 2 * (B * sum(rq_l) + B * KV * dv)
            + 4 * (B + 2 * KV + pages) + tot * kept * e, tot * 2 * kept,
            f"pt{pt} pool {n_pages}+1 pages, {shape}")
        del cases
        self.print_times([f"{k}{t}" for k in ("flash_decode_ranked",
                                              "paged_flash_decode_ranked")
                          for t in ("", " bf16", " fp8")])

    def compare_streams(self, name, reqs, refs, prompts, params, cfg,
                        forward, against="greedy_reference", router=False,
                        partial=(), tie_rel=1e-4):
        """Streams token for token; a divergence passes only at a
        near-tie of the reference's logits at that step (top-2 gap <
        ``tie_rel`` max |logit|) or, with ``router``, of its MoE router (the
        smallest top-k margin of that step's forward < ROUTER_TIE).  The
        uids in ``partial`` stopped early (shed, timed out, cancelled):
        each is held to the reference's prefix of its length.  -> the
        near-ties met."""
        import numpy as np
        exact = ties = 0
        for r, want, prompt in zip(reqs, refs, prompts):
            got = r.generated
            if r.uid in partial:
                want = want[:len(got)]
            if got == want:
                exact += 1
                continue
            n = min(len(got), len(want))
            if got[:n] == want[:n]:
                self.fail(f"{name} uid {r.uid}: {len(got)} tokens, "
                          f"{against} has {len(want)}")
                continue
            i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            seq = np.asarray([list(prompt) + want[:i]], np.int64)
            watch, seen = self.router_margins()
            with watch:
                logits, _ = forward(params, cfg, seq, last_only=True)
            row = logits[0, -1]
            top2 = row.topk(2).values
            gap = (top2[0] - top2[1]).item()
            tie = tie_rel * row.abs().max().item()
            margin = (self.torch.stack(seen).min().item() if router and seen
                      else math.inf)
            ok = gap < tie or margin < ROUTER_TIE
            verdict = ("near-tie, allowed" if gap < tie else
                       "router near-tie, allowed" if ok else "DIVERGED")
            print(f"{name} uid {r.uid}: first difference at token {i} "
                  f"(engine {got[i]}, {against} {want[i]}), reference "
                  f"top-2 gap {gap:.3e} vs near-tie bound {tie:.3e}, "
                  f"router margin {margin:.3e} vs {ROUTER_TIE:.0e}: "
                  f"{verdict}")
            if not ok:
                self.fail(f"{name} uid {r.uid} diverged from {against}")
            ties += ok
        print(f"{name}: {exact}/{len(reqs)} streams token-identical to "
              f"{against}")
        return ties

    def check_counts(self, marks):
        phase_kernel = {"scoring": "flash_attention",
                        "dense": "flash_decode",
                        "paged": "paged_flash_decode",
                        "reference": "flash_attention"}
        for (_, before), (name, after) in zip(marks, marks[1:]):
            k = phase_kernel[name]
            grew = after[k] - before[k]
            print(f"phase {name}: {k} launched {grew} times")
            if grew <= 0:
                self.fail(f"{k} never launched in phase {name}")
        end = marks[-1][1]
        for name in ("attention_ref", "flash_attention_ref",
                     "decode_attention_ref", "paged_decode_attention_ref"):
            if end[name] != 0:
                self.fail(f"plain version {name} ran {end[name]} times on "
                          "the main path")
        self.launches = {k: end[k] for k in
                         ("flash_attention", "flash_decode",
                          "paged_flash_decode")}
        print(f"main-path launches: {self.launches}")

    # ---- flash_decode's log-sum-exp (row 2's lse output) ---------------
    def phase_lse(self):
        """``flash_decode(return_lse=True)`` against its plain version on
        the card: the lse within LSE_TOL x max(1, |lse|), the context
        bit for bit ``return_lse=False``'s, a row of length 0 giving lse
        -inf and a zero context, and two windows of the cache merged as
        ``combine_seq_partials`` merges them equal to one call over the
        whole cache (TOL); at the sequence-split decode's shapes
        (musicgen-large's 32 heads of 64, gpt2-xl's 25) and on the split
        planner's boundaries.  Then timed beside the plain version and
        the call without the lse."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.decode_attention import (flash_decode,
                                                          plan_splits)
        from repro_torch.kernels import _build
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(SEED + 21)
        sms = _build.sm_count(0)
        cases = [("musicgen window", 4, 128, 32, 32, 64, 64,
                  [128, 40, 0, 1]),
                 ("gpt2-xl data 2", 2, 992, 25, 25, 64, 64, [960, 0]),
                 ("G4 split edges", 4, 576, 32, 8, 128, 64, None)]
        for label, B, T, H, KV, dq, dv, lens in cases:
            if lens is None:
                _, span = plan_splits(T, B * KV, sms)
                lens = [span, span + 1, T, 0]
            q = self.randn(B, H, dq, gen=gen)
            k = self.randn(B, T, KV, dq, gen=gen)
            v = self.randn(B, T, KV, dv, gen=gen)
            lengths = self.ids32(lens)
            out, lse = flash_decode(q, k, v, lengths, scale=0.125,
                                    return_lse=True)
            plain = flash_decode(q, k, v, lengths, scale=0.125)
            want, wlse = ref.decode_attention_ref(q, k, v, lengths,
                                                  scale=0.125,
                                                  return_lse=True)
            torch.cuda.synchronize()
            self.parity("flash_decode", f"lse {label} context", out, want)
            live = torch.isfinite(wlse)
            err = ((lse - wlse).abs() / wlse.abs().clamp_min(1))[live]
            err = err.max().item() if err.numel() else 0.0
            empty = ~self.ids32(lens).bool()
            ok = (err <= LSE_TOL and torch.equal(out, plain)
                  and bool(torch.isneginf(lse[empty]).all())
                  and bool((out[empty] == 0).all())
                  and bool(torch.isfinite(lse[~empty]).all()))
            print(f"parity flash_decode lse {label:34s} lse rel err "
                  f"{err:.3e} tol {LSE_TOL:.0e}, context bit for bit the "
                  f"call without lse {torch.equal(out, plain)}, lengths "
                  f"{lens} {'ok' if ok else 'FAIL'}")
            if not ok:
                self.fail(f"flash_decode lse {label}: err {err:.3e}")
            # two windows merged equal one call over the whole cache
            half = T // 2
            parts = [flash_decode(q, k[:, lo:lo + half].contiguous(),
                                  v[:, lo:lo + half].contiguous(),
                                  (lengths - lo).clamp(0, half).to(
                                      torch.int32), scale=0.125,
                                  return_lse=True)
                     for lo in (0, half)]
            ls = torch.stack([p[1] for p in parts])
            mx = ls.max(0).values
            mx = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
            w = torch.exp(ls - mx)
            merged = (w[..., None] * torch.stack([p[0] for p in parts])
                      ).sum(0) / w.sum(0).clamp_min(1e-30)[..., None]
            self.parity("flash_decode", f"lse {label} two windows", merged,
                        out)
            self.lse_dtypes(label, q, k, v, lengths)
        # timing at the sequence-split decode's window (musicgen, 4 rows)
        B, T, H, KV, d = 4, 2048, 32, 32, 64
        lens = [2048, 1500, 700, 64]
        lengths = self.ids32(lens)
        sets = [(self.randn(B, H, d, gen=gen), self.randn(B, T, KV, d,
                                                          gen=gen),
                 self.randn(B, T, KV, d, gen=gen))
                for _ in range(self.copies(4 * B * T * KV * 2 * d))]
        tot = sum(lens)
        nbytes = 4 * (B * H * d + tot * KV * 2 * d + B + B * H * d + B * H)
        self.times["flash_decode lse"] = (
            self.time_ms([lambda s=s: flash_decode(*s, lengths, scale=0.125,
                                                   return_lse=True)
                          for s in sets]),
            self.time_ms([lambda s=s: ref.decode_attention_ref(
                *s, lengths, scale=0.125, return_lse=True) for s in sets]),
            None, self.bound(nbytes, tot * H * 2 * 2 * d),
            f"B{B} T{T} H{H} KV{KV} d{d} lengths {lens}")
        no_lse = self.time_ms([lambda s=s: flash_decode(*s, lengths,
                                                        scale=0.125)
                               for s in sets])
        self.print_times(["flash_decode lse"])
        print(f"time flash_decode lse: the same call without the lse "
              f"{no_lse:.4f} ms [{self.card}]")
        del sets

    def lse_dtypes(self, label, q, k, v, lengths):
        """``flash_decode(return_lse=True)`` at DTYPE_PAIRS: at 16-bit
        compute the context ``held16`` to the plain version, the lse
        within LSE_TOL x max(1, |lse|) of its and the context bit for bit
        the call without the lse; at float32 compute both outputs bit for
        bit the kernel's on cache.float()."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.decode_attention import flash_decode
        parts, ok = [], True
        for cd, kd in DTYPE_PAIRS:
            qc = q.to(getattr(torch, cd))
            kc, vc = k.to(getattr(torch, kd)), v.to(getattr(torch, kd))
            out, lse = flash_decode(qc, kc, vc, lengths, scale=0.125,
                                    return_lse=True)
            if cd == "float32":
                wout, wlse = flash_decode(qc, kc.float(), vc.float(),
                                          lengths, scale=0.125,
                                          return_lse=True)
                torch.cuda.synchronize()
                good = torch.equal(out, wout) and torch.equal(lse, wlse)
                parts.append(f"{cd}/{kd} bitwise {good}")
            else:
                plain = flash_decode(qc, kc, vc, lengths, scale=0.125)
                wout, wlse = ref.decode_attention_ref(
                    qc, kc, vc, lengths, scale=0.125, return_lse=True)
                share, worst, good = self.held16(
                    "flash_decode", f"lse {label} {cd}/{kd}", out, wout)
                live = torch.isfinite(wlse)
                err = ((lse - wlse).abs() / wlse.abs().clamp_min(1))[live]
                err = err.max().item() if err.numel() else 0.0
                good = (good and err <= LSE_TOL and torch.equal(out, plain)
                        and torch.equal(torch.isneginf(lse), ~live))
                parts.append(f"{cd}/{kd} {share:.4f} {worst:.2f}ulp lse "
                             f"{err:.1e}")
            ok &= good
            if not good:
                self.fail(f"flash_decode lse {label} {cd}/{kd}")
        print(f"dtypes flash_decode lse {label}: {', '.join(parts)} "
              f"{'ok' if ok else 'FAIL'}")

    # ---- phase 21 ------------------------------------------------------
    SS_LAYERS = 4        # gpt2-xl's depth for the FSDP runs (see the doc)
    SS_NEW = 32
    SS_TIMEOUT = 900.0

    def phase_serve_step(self):
        """Phase 21, serving under training's rules and over data
        replicas; two ranks under gloo on the one card (see the module
        doc)."""
        import dataclasses
        import gc
        import types
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import StepRun, serve_step_ranks
        from repro_torch.models.transformer import forward, init_lm_params
        from repro_torch.serve import greedy_reference
        torch = self.torch
        t0 = time.perf_counter()
        dev = None if self.dev.type == "cuda" else "cpu"
        rng = np.random.default_rng(SEED + 21)
        g_cfg = dataclasses.replace(get_config("gpt2-xl"),
                                    n_layers=self.SS_LAYERS)
        g_params = init_lm_params(g_cfg, SEED, device=self.dev)
        long_p = rng.integers(0, g_cfg.vocab_size, (8, 960)).astype(np.int32)
        g_batches = [{"prompts": long_p, "new": self.SS_NEW,
                      "max_len": 960 + self.SS_NEW}]
        b_cfg = dataclasses.replace(g_cfg, compute_dtype="bfloat16")
        b_batches = [dict(g_batches[0], new=min(8, self.SS_NEW))]
        m_cfg = get_config("musicgen-large")
        m_params = init_lm_params(m_cfg, SEED, device=self.dev)
        m_first = rng.integers(0, m_cfg.vocab_size, (4, 200)).astype(
            np.int32)
        m_more = rng.integers(0, m_cfg.vocab_size, (4, 24)).astype(np.int32)
        m_batches = [{"prompts": m_first, "more": m_more,
                      "new": self.SS_NEW, "max_len": 256}]
        runs = [StepRun("gpt2-xl data 2", g_params, g_cfg, (2, 1),
                        g_batches, logits=True),
                StepRun("gpt2-xl data 2 bf16", g_params, b_cfg, (2, 1),
                        b_batches, logits=True),
                StepRun("musicgen-large model 2", m_params, m_cfg, (1, 2),
                        m_batches)]
        self.sync()
        t1 = time.perf_counter()

        def references():
            # one rank, whole weights, each row's whole prompt (a second
            # prefill continues the first)
            t2 = time.perf_counter()
            want = {}
            for run in (runs[0], runs[2]):
                prompts, news = [], []
                for b in run.batches:
                    for i, p in enumerate(b["prompts"]):
                        more = b.get("more")
                        prompts.append(p if more is None
                                       else np.concatenate([p, more[i]]))
                        news.append(b["new"])
                want[run.label] = (prompts, [
                    greedy_reference(run.params, run.cfg, p, n,
                                     device=self.dev)
                    for p, n in zip(prompts, news)])
            self.sync()
            print(f"serve_step greedy_reference: "
                  f"{sum(len(w[1]) for w in want.values())} streams in "
                  f"{time.perf_counter() - t2:.1f} s, beside the ranks")
            return want
        per_rank, want = self.beside(
            lambda: serve_step_ranks(runs, world=2, backend="gloo",
                                     device=dev, timeout=self.SS_TIMEOUT),
            references)
        print(f"serve_step: {len(runs)} make_serve_step runs on 2 spawned "
              f"ranks (gloo) in {time.perf_counter() - t1:.1f} s of wall")
        self.ss_results = {}
        for i, run in enumerate(runs):
            ranks = [per_rank[r][i] for r in range(2)]
            self.ss_results[run.label] = ranks
            for r, got in enumerate(ranks):
                c = got["collectives"]
                steps = got["step_s"]
                n_dec = sum(b["new"] - 1 for b in run.batches)
                dec = steps[-n_dec:] if n_dec else []
                rows = sum(b["prompts"].shape[0] for b in run.batches) // \
                    run.mesh[0]
                tok = rows * sum(b["new"] for b in run.batches)
                print(f"serve_step {run.label} rank {r}: {tok} tokens of "
                      f"its rows in {sum(steps):.3f} s = "
                      f"{tok / sum(steps):.1f} tokens/s, mean decode step "
                      f"{1e3 * float(np.mean(dec)):.1f} ms, all_gather "
                      f"{c['all_gather']}, all_reduce {c['all_reduce']}, "
                      f"broadcast {c['broadcast']}, "
                      f"{1e3 * c['seconds'] / max(1, len(steps)):.1f} ms per "
                      f"step inside collectives, resident "
                      f"{got['resident_bytes'] / 1e9:.3f} GB, peak "
                      f"{got['peak_bytes'] / 1e9:.3f} GB [{self.card}]")
                launched = got["launches"]
                plain = {k: v for k, v in launched.items()
                         if k.endswith("_ref") and v}
                print(f"serve_step {run.label} rank {r} launches: "
                      f"flash_attention {launched['flash_attention']} "
                      f"(float32 {launched['flash_attention.float32']}), "
                      f"window_attention {launched['window_attention']}, "
                      f"flash_decode {launched['flash_decode']}, plain "
                      f"{plain}")
                if plain and dev is None:
                    self.fail(f"serve_step {run.label} rank {r}: plain "
                              f"versions ran {plain}")
                if got["streams"] != ranks[0]["streams"]:
                    self.fail(f"serve_step {run.label}: rank {r}'s streams "
                              "differ from rank 0's")
            if run.label in want:
                prompts, refs = want[run.label]
                flat = [g for b in ranks[0]["streams"] for g in b]
                reqs = [types.SimpleNamespace(uid=u, generated=list(g))
                        for u, g in enumerate(flat)]
                self.compare_streams(f"serve_step {run.label}", reqs, refs,
                                     prompts, run.params, run.cfg, forward)
        # bf16 compute against the float32 run, step for step while the
        # two runs' greedy tokens agree (each step feeds the last token)
        f32 = self.ss_results["gpt2-xl data 2"]
        b16 = self.ss_results["gpt2-xl data 2 bf16"]
        tb = np.asarray(b16[0]["streams"][0])
        tf = np.asarray(f32[0]["streams"][0])[:, :tb.shape[1]]
        same = next((j for j in range(tb.shape[1])
                     if not (tb[:, j] == tf[:, j]).all()), tb.shape[1])
        for r in range(2):
            worst = 0.0
            for a, b in list(zip(b16[r]["logits"], f32[r]["logits"]))[
                    :same + 1]:
                worst = max(worst, float(np.abs(a - b).max()
                                         / np.abs(b).max()))
            ok = worst <= KV_BF16_TOL and same >= 1
            print(f"serve_step bf16 compute vs float32 rank {r}: "
                  f"{min(same + 1, len(b16[r]['logits']))} steps compared "
                  f"(the greedy tokens agree for {same} of {tb.shape[1]}), "
                  f"max |dlogits| / max |logits| {worst:.3e} (tol "
                  f"{KV_BF16_TOL:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                self.fail(f"serve_step bf16 rank {r}: {worst:.3e}")
        need = {"gpt2-xl data 2": ("flash_attention", "flash_decode"),
                "musicgen-large model 2": ("flash_decode",)}
        for label, names in need.items():
            for r, got in enumerate(self.ss_results[label]):
                for k in names:
                    if got["launches"][k] <= 0 and dev is None:
                        self.fail(f"serve_step {label} rank {r}: {k} "
                                  "never launched")
        # the bf16 run's 960-token prefill: the window form on every
        # rank, no float32 flash_attention
        win = [got["launches"]["window_attention"] for got in b16]
        f32 = [got["launches"]["flash_attention.float32"] for got in b16]
        ok = min(win) > 0 and max(f32) == 0
        print(f"serve_step gpt2-xl data 2 bf16: window_attention launches "
              f"per rank {win}, float32 flash_attention {f32} "
              f"{'ok' if ok or dev is not None else 'FAIL'}")
        if dev is None and not ok:
            self.fail(f"serve_step bf16: window_attention {win}, float32 "
                      f"flash_attention {f32} per rank")
        self.launches["window_attention"] = sum(win)
        lse = [got["launches"]["flash_decode.lse"]
               for got in self.ss_results["musicgen-large model 2"]]
        print(f"serve_step musicgen-large model 2: flash_decode lse "
              f"launches per rank {lse}")
        if dev is None and min(lse) <= 0:
            self.fail("serve_step: flash_decode(return_lse=True) never "
                      "launched on a rank")
        del runs, per_rank, m_params, b_batches
        gc.collect()
        torch.cuda.empty_cache()
        self.ss_gpt2 = (g_cfg, g_batches)
        del g_params
        gc.collect()
        torch.cuda.empty_cache()
        self.ss_replicas()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase serve_step: {time.perf_counter() - t0:.1f} s "
              f"[{self.card}]")

    def ss_replicas(self):
        """``ShardedExecutor`` at (data 2) serving gpt2-xl whole (48
        layers, random from SEED; each replica holds all of it): the
        main path's 8 requests dense, and paged with the prefix cache on
        a trace whose warm burst hits, from slot 1 (replica 1), the
        system prompt's pages that slot 0 (replica 0) wrote, then the
        system prompt alone (a full hit: copy-on-write)."""
        import types
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import ServeRun, serve_tp
        from repro_torch.models.transformer import forward, init_lm_params
        from repro_torch.serve import EngineConfig, greedy_reference
        torch = self.torch
        dev = None if self.dev.type == "cuda" else "cpu"
        cfg = get_config("gpt2-xl")
        params = init_lm_params(cfg, SEED, device=self.dev)
        rng = np.random.default_rng(SEED + 22)
        sys_p = rng.integers(0, cfg.vocab_size, 128).astype(np.int32)
        warm = [np.concatenate([sys_p, rng.integers(
            0, cfg.vocab_size, n).astype(np.int32)]) for n in (8, 19)]
        main = self.main_prompts(cfg)
        dense = dict(MAIN_ENGINES)["dense"]
        prefix = dict(dict(MAIN_ENGINES)["paged"], n_pages=64,
                      prefix_cache=True)
        runs = [ServeRun("dense", params, cfg, EngineConfig(**dense),
                         [[dict(prompt=p, max_new_tokens=self.SS_NEW)
                           for p in main]]),
                ServeRun("prefix", params, cfg, EngineConfig(**prefix),
                         [[dict(prompt=p, max_new_tokens=8) for p in w]
                          for w in ([sys_p], warm, [sys_p.copy()])])]
        t0 = time.perf_counter()

        def references():
            t1 = time.perf_counter()
            refs = {}
            for run in runs:
                for w in run.waves:
                    for kw in w:
                        key = kw["prompt"].tobytes()
                        if len(refs.get(key, ())) < kw["max_new_tokens"]:
                            refs[key] = greedy_reference(
                                params, cfg, kw["prompt"],
                                kw["max_new_tokens"], device=self.dev)
            self.sync()
            print(f"serve_step replicas greedy_reference: {len(refs)} "
                  f"streams in {time.perf_counter() - t1:.1f} s, beside the "
                  "ranks")
            return refs
        per_rank, refs = self.beside(
            lambda: serve_tp(runs, tp=1, data=2, backend="gloo", device=dev,
                             timeout=self.SS_TIMEOUT), references)
        print(f"serve_step replicas: {len(runs)} engines at (data 2) on 2 "
              f"spawned ranks in {time.perf_counter() - t0:.1f} s of wall")
        shapes = {"dense": (2,), "prefix": (3,)}
        for i, run in enumerate(runs):
            ranks = [per_rank[r][i] for r in range(2)]
            prompts = [kw["prompt"] for w in run.waves for kw in w]
            news = [kw["max_new_tokens"] for w in run.waves for kw in w]
            for r, got in enumerate(ranks):
                c, steps = got["collectives"], max(1, got["steps"])
                launched = got["launches"]
                print(f"serve_step replicas {run.label} rank {r} (replica "
                      f"{got['replica']}): {got['tokens']} tokens in "
                      f"{got['wall']:.3f} s = {got['tokens_per_s']:.1f} "
                      f"tokens/s, mean ITL {got['itl_ms']:.2f} ms, "
                      f"{got['steps']} steps, all_gather {c['all_gather']} "
                      f"({c['all_gather'] / steps:.1f} per step), "
                      f"{1e3 * c['seconds'] / steps:.2f} ms per step inside "
                      f"collectives, resident "
                      f"{got['resident_bytes'] / 1e9:.3f} GB, peak "
                      f"{got['peak_gb']:.3f} GB, shapes "
                      f"{got['compiled_shapes']}; launches flash_decode "
                      f"{launched['flash_decode']}, paged_flash_decode "
                      f"{launched['paged_flash_decode']}, page_copy "
                      f"{launched['page_copy']} [{self.card}]")
                if got["compiled_shapes"] not in shapes[run.label]:
                    self.fail(f"serve_step replicas {run.label} rank {r}: "
                              f"{got['compiled_shapes']} step shapes")
                k = ("flash_decode" if run.label == "dense"
                     else "paged_flash_decode")
                if dev is None and launched[k] <= 0:
                    self.fail(f"serve_step replicas {run.label} rank {r}: "
                              f"{k} never launched")
                plain = {k: v for k, v in launched.items()
                         if k.endswith("_ref") and v}
                if dev is None and plain:
                    self.fail(f"serve_step replicas {run.label} rank {r}: "
                              f"plain versions ran {plain}")
                if got["streams"] != ranks[0]["streams"]:
                    self.fail(f"serve_step replicas {run.label}: rank {r}'s "
                              "streams differ from rank 0's")
            st = ranks[0]["stats"]
            if run.label == "prefix":
                hit = ranks[0]["cached_tokens"][1][1]
                print(f"serve_step replicas prefix: hits "
                      f"{st['prefix_hits']}, the warm burst's slot-1 "
                      f"request reused {hit} cached tokens (written by "
                      "replica 0)")
                if not (st["prefix_hits"] > 0 and hit > 0):
                    self.fail("serve_step replicas prefix: no "
                              "cross-replica hit")
            flat = [s for w in ranks[0]["streams"] for s in w]
            reqs = [types.SimpleNamespace(uid=u, generated=list(g))
                    for u, g in enumerate(flat)]
            self.compare_streams(f"serve_step replicas {run.label}", reqs,
                                 [refs[p.tobytes()][:n] for p, n in
                                  zip(prompts, news)], prompts, params, cfg,
                                 forward)
        del params, runs, per_rank

    # ---- phase 22 ------------------------------------------------------
    def phase_dryrun(self):
        """Phase 22: the production dry-run's prediction of phase 21's
        gpt2-xl (data 2) decode, traced at its exact shape on a fake
        2-rank group: each rank's predicted argument bytes against its
        measured resident bytes (equal), the predicted peak against
        ``max_memory_allocated`` and the measured decode step against the
        predicted roofline bound.  The sweep over every production cell
        needs no card and runs on the CPU (``python -m
        repro_torch.launch.dryrun --all [--multi-pod]``); PERF.md has
        its table."""
        self.dryrun_vs_measured()

    def dryrun_vs_measured(self):
        """The dry-run's prediction of phase 21's gpt2-xl (data 2) decode
        against what the ranks measured."""
        import numpy as np
        from repro_torch.configs.shapes import ShapeConfig
        from repro_torch.launch import dryrun as D
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel import hlo as H
        if not getattr(self, "ss_results", None):
            print("dryrun vs measured: phase 21 did not run")
            return
        cfg, batches = self.ss_gpt2
        b = batches[0]
        B = b["prompts"].shape[0]
        shape = ShapeConfig("ss_decode", b["max_len"], B, "decode")
        t0 = time.perf_counter()
        with D.fake_world(2):
            mesh = make_mesh((2, 1), ("data", "model"), device="meta")
            tr = D.trace_cell(cfg, shape, mesh)
        print(f"dryrun: gpt2-xl ({self.SS_LAYERS} layers) data 2 decode "
              f"traced in {time.perf_counter() - t0:.1f} s")
        rl = H.roofline_from_trace(tr)
        mem = H.memory_per_device(tr)
        predicted = tr.argument_bytes - tr.input_bytes
        ranks = self.ss_results["gpt2-xl data 2"]
        n_dec = b["new"] - 1
        for r, got in enumerate(ranks):
            # batch 0's decode steps: after its prefill, before batch 1
            dec = got["step_s"][1:1 + n_dec]
            step = float(np.mean(dec))
            print(f"dryrun vs measured, gpt2-xl ({self.SS_LAYERS} layers) "
                  f"data 2 decode at B {B}, cache {b['max_len']}, rank {r}: "
                  f"predicted params + state {predicted} bytes, measured "
                  f"resident {got['resident_bytes']} bytes; predicted peak "
                  f"{(tr.argument_bytes + tr.temp_bytes) / 1e9:.3f} GB "
                  f"(argument + temp), max_memory_allocated "
                  f"{got['peak_bytes'] / 1e9:.3f} GB (the whole run, its "
                  f"long prefill included); predicted bound "
                  f"{rl.bound * 1e3:.3f} ms ({rl.dominant}), measured "
                  f"decode step {step * 1e3:.1f} ms: "
                  f"{100 * rl.bound / step:.2f}% of the bound "
                  f"[{self.card}]")
            if predicted != got["resident_bytes"]:
                self.fail(f"dryrun vs measured rank {r}: predicted "
                          f"{predicted} != resident "
                          f"{got['resident_bytes']}")
            if step < rl.bound:
                self.fail(f"dryrun vs measured rank {r}: a step of "
                          f"{step * 1e3:.3f} ms under the bound "
                          f"{rl.bound * 1e3:.3f} ms: a count is wrong")
        print(f"dryrun vs measured: memory {mem['total_gib']:.3f} GiB "
              f"(argument + temp), flops {tr.flops:.4g}, hbm bytes "
              f"{tr.hbm_bytes:.4g}, collective bytes {rl.coll_bytes:.4g}")

    def kernel_rows(self):
        meta = {
            "flash_attention": ("src/repro_torch/csrc/clover_attention.cu",
                                "src/repro/kernels/clover_attention.py:82"),
            "flash_decode": ("src/repro_torch/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention.py:245"),
            "paged_flash_decode": (
                "src/repro_torch/csrc/decode_attention.cu",
                "src/repro/kernels/paged_decode_attention.py:247"),
            "page_copy": ("src/repro_torch/csrc/page_copy.cu",
                          "src/repro/kernels/page_copy.py:50"),
            "page_restore": ("src/repro_torch/csrc/page_copy.cu",
                             "src/repro/kernels/page_copy.py:94"),
            "flash_decode_ranked": (
                "src/repro_torch/csrc/decode_attention.cu",
                "src/repro/kernels/decode_attention.py:160"),
            "paged_flash_decode_ranked": (
                "src/repro_torch/csrc/decode_attention.cu",
                "src/repro/kernels/paged_decode_attention.py:167"),
            "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                           "src/repro/kernels/mamba_scan.py:66"),
            "wkv6": ("src/repro_torch/csrc/wkv6.cu",
                     "src/repro/kernels/wkv6.py:77"),
            # no TPU kernel: the reference runs XLA attention here
            "window_attention": ("src/repro_torch/csrc/clover_attention.cu",
                                 "src/repro/models/layers.py:129"),
        }
        rows = []
        # the window form's row: its time at phase 21's bf16 window
        key = {"window_attention": "window_attention bf16 gpt2-xl"}
        for name, (source, replaces) in meta.items():
            ms, plain, lib, (bms, by), _ = self.times[key.get(name, name)]
            rows.append({"name": name, "route": "cuda", "source": source,
                         "replaces": replaces,
                         "launches": self.launches[name],
                         "max_abs_err": self.err[name], "ms": ms,
                         "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                         "library_ms": lib,
                         "max_abs_err_16bit": self.err16.get(name)})
        return rows


class RoutingPin:
    """Hold MoE routing fixed between forwards of a model and of its
    CLOVER decomposition.  A top-k router is discontinuous: where two
    experts' probabilities are within float32 rounding of each other, the
    decomposition's rounding flips the choice and that token's output
    changes by O(1), which no logits tolerance can absorb (at full width
    such near-ties occur in every few thousand routings).  ``record()``
    keeps each ``models.moe._route`` call's experts and top-k margins, in
    call order; ``replay()`` runs a later forward on those experts (gates
    renormalised from its own probabilities) and counts the token routings
    it would have changed (``flips``) and the largest recorded margin among
    them (``flip_margin``).  Dense models never route: nothing is
    recorded and nothing flips."""

    def __init__(self):
        self.calls, self.flips, self.flip_margin = [], 0, 0.0

    @contextlib.contextmanager
    def _patched(self, route):
        from repro_torch.models import moe as MOE
        orig = MOE._route
        MOE._route = lambda *args: route(orig, *args)
        try:
            yield self
        finally:
            MOE._route = orig

    def record(self):
        self.calls = []

        def route(orig, params, cfg, xf, dropless):
            out = orig(params, cfg, xf, dropless)
            top = out[3].topk(cfg.moe.top_k + 1, dim=-1).values
            self.calls.append((out[1], top[:, -2] - top[:, -1]))
            return out
        return self._patched(route)

    def replay(self):
        calls = iter(self.calls)
        self.flips, self.flip_margin = 0, 0.0

        def route(orig, params, cfg, xf, dropless):
            gates, experts, keep, probs, logits = orig(params, cfg, xf,
                                                       dropless)
            if not dropless:
                raise ValueError("RoutingPin replays dropless routing only")
            want, margin = next(calls)
            flip = (experts.sort(dim=-1).values
                    != want.sort(dim=-1).values).any(dim=-1)
            n = int(flip.sum())
            if n:
                self.flips += n
                self.flip_margin = max(self.flip_margin,
                                       float(margin[flip].max()))
            g = probs.gather(1, want)
            return (g / g.sum(dim=-1, keepdim=True).clamp_min(1e-9), want,
                    keep, probs, logits)
        return self._patched(route)

    def note(self):
        return (f", routing pinned ({self.flips} token routings would "
                f"flip, at top-k margins <= {self.flip_margin:.3e})"
                if self.calls else "")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
