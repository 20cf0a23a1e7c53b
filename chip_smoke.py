#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. Build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` for ``sm_90a``;
   for each variant of kernels A, B, C and E, what ``-Xptxas -v`` said
   (registers, spills), and for kernels A and E each variant's count of
   ``HGMMA`` instructions (``cuobjdump -sass``), which must not be 0 for
   the tensor-core variants (``atb_tc``, ``flash_fwd_tc``).
3. Kernels: each of the five Nyström kernel entry points against its plain
   PyTorch version, at the main path's shapes (p = 26,122, k = 10, m = 32),
   at one large shape (p = 2²⁴, k = 64, m = 32) and at p = 2²⁰ with
   (k, m) = (512, 512) and (64, 256) (beyond the k, m ≤ 256 and k·m ≤ 8192
   that earlier kernels took), each with f32 and bf16 sketches, and at the
   large shapes a bf16 × bf16 cross too. Each case prints the variant or
   load path it took: kernel A's launched variant (tensor-core launch
   counters) must be ``_lib.atb_variant``'s answer; for kernels B and C it
   prints the path the rules ``_lib.ctv_path`` and ``_lib.rows16`` name,
   which the C entries re-check (a launch reports no path of its own).
   Tolerance: rtol 1e-5 and atol 1e-5·‖ref‖∞.
   At the main shapes
   the reference is the plain version itself (f32). At p = 2²⁴ and 2²⁰ it
   is the plain version evaluated in f64 on the same values: over millions
   of rows the f32 rounding of cuBLAS's own sums is as large as the
   tolerance. Times
   are CUDA-event means over 20 launches after 3 warm-ups; ``library_ms``
   is one ``torch`` call computing the same function (a yardstick only;
   the port never calls it): ``mm``, ``mv``, ``addmv``, ``addmm`` in f32,
   and ``mm(..., out_dtype=float32)`` for bf16 × bf16; its largest error
   against the same reference is printed, not gated; ``bound_ms`` is max(FLOPs / peak, bytes /
   3.35 TB/s), each input read once and each output written once, with the
   fp32 peak of 67 TFLOP/s (989 TFLOP/s where every input is bf16); gram
   counts the k(k+1)/2 distinct entries of the symmetric CᵀC. Then
   ``tests/test_torch_cuda.py`` (the ``gpu``-marked kernel tests) runs in
   three pytest subprocesses side by side and must pass, but for the cuts
   of ``KERNEL_TEST_CUTS``, printed with their reasons.
4. Main path: ``solve(build_reweighting(), HypergradConfig(solver='nystrom',
   k=10, backend='cuda'), n_outer=5)``, after a one-step warm-up solve that
   takes the first-call set-up; the outer loss must be finite and
   the gram, ctv and apply kernels must have launched. On the solved state
   the hypergradient through the kernels must match ``backend='flat'``
   (``torch.matmul``) to relative L2 ≤ 1e-4, and on the convex
   ``logreg_wd`` (p = 100) a full-rank sketch through the kernels must
   match the exact-IHVP oracle to ≤ 1e-4.
5. Block path: ``phi_vjp_block`` with m = 32 per-example validation
   gradients, kernels against ``backend='flat'`` (≤ 1e-4); the cross and
   block-apply kernels must have launched.

6. Where the time goes: ``solve`` again for 3 outer steps under
   ``torch.profiler`` (without the problem's metrics, which the timed
   step leaves out too): host time and device time of the trainer's own
   phase ranges (``bilevel.inner``, ``bilevel.sketch``,
   ``bilevel.update``), and the device's busy and idle share against the
   unprofiled step of phase 4.

The transformer's prefill (the second slice):

7. Model kernels: RMSNorm (kernel D) and flash attention (kernel E) against
   their plain versions at the prefill's shapes: x (4·4096, 4096) in bf16
   and f32, and d = 1000; q/k/v (4, 4096, 32, 128) bf16, causal and not;
   f32 at (4, 4096, 32, 128) causal, (2, 256, 4, 128) and hd = 64; and
   (1, 32768, 32, 128) bf16 causal (the ``prefill_32k`` length). Then with
   4 KV heads read in place (Yi-9B's GQA): the prefill's own call, q
   (4, 4096, 32, 128) and k/v (4, 4096, 4, 128) bf16 causal (the kernel's
   record), the same at 32k, bf16 hd = 64, a ragged bf16 case (S = T =
   100, non-causal), and the prefill's call with every base address 8
   bytes off the 16-byte grid (kernel E's bf16 CUDA-core variant). Each
   case prints the variant it launched, which must be the one the
   wrapper's rule names (tensor cores for bf16 with hd 64 or 128 on the
   16-byte grid), and is held against the plain version on the expanded
   heads.
   Tolerances: |err| ≤ atol + rtol·|ref| elementwise. In f32 those of
   ``tests/test_kernels.py``, atol = rtol = 1e-5 (RMSNorm) and 2e-5
   (flash); RMSNorm in bf16 likewise at 2e-2. Flash in bf16 is held to one
   bf16 ulp, rtol 2⁻⁷ and atol 1e-5: both sides widen the same bf16 values
   and compute in f32, and only the final rounding to bf16 differs. The
   dense plain attention is evaluated per batch row, and per head at 32k,
   to bound its (S, T) f32 scores. ``library_ms`` is
   ``F.rms_norm`` or ``F.scaled_dot_product_attention`` (yardsticks; the
   port never calls them; SDPA with ``enable_gqa`` where KV < H, and once
   more on the expanded heads for the record case). Flash FLOPs are
   4·B·H·S·T·hd, halved when causal, over the bf16 peak where the inputs
   are bf16; flash bytes (2·B·S·H + 2·B·T·KV)·hd·elem, with the heads each
   tensor has.
8. Prefill: Yi-9B at full width and depth (48 layers, 8.8 B parameters),
   ``use_pallas=True``, random bf16 weights from a seeded generator
   (``serve_params``), a warm-up prefill, then 3 requests of 4 prompts ×
   4096 random tokens through ``build_prefill_step``. Each request must give
   finite logits (4, 64000) and launch RMSNorm exactly 96 times (ln1 and
   ln2 of 48 layers) and flash 48 times, all 48 on the tensor-core
   kernel. The same first request through the plain path
   (``use_pallas=False``) gives the relative L2 of the logits and the
   share of argmax tokens that agree, ungated.
9. Where the prefill's time goes: one prefill under ``torch.profiler``,
   device time split into kernel E, kernel D, GEMMs and the rest, and the
   device's idle share against the unprofiled prefill.
10. Parity on the card at full width, depth cut to 4 layers, B = 2,
    S = 2048: the kernel path against the plain path on the last
    position's logits, relative L2 ≤ 1e-4 in f32 (params and compute;
    kernel E's CUDA-core variant) and ≤ 2e-2 in bf16 serving (its
    tensor-core variant).

Tab. 2's solver family (the sixth slice):

11. Distillation: ``solve(get_problem('distillation'), ...)`` at the task's
    full width (28 × 28 images, width 64, 50 distilled images: p = 50,890
    parameters, 39,200 hyperparameters; 100 inner steps at batch 256 per
    outer step) for Tab. 2's four configurations (k = l = 10,
    ρ = α = 1e-2): Nyström whitened and Nyström κ = 5 (Alg. 1) on
    ``backend='cuda'``, Neumann, and CG (ρ = 0); 1 warm-up and 3 timed
    outer steps each, then one profiled step (host and device time of the
    trainer's phase ranges, as phase 6, and the device idle share) and the
    peak device memory. Gates: every loss, the images and the
    hypergradient at the solved state finite; for both Nyström runs that
    hypergradient within 1e-4 relative L2 of ``backend='flat'``; kernels A
    and B launched by both, kernel C by the whitened run only, no kernel by
    Neumann or CG. The κ = 5 apply is held to the literal Eq. 6 apply on
    one sketch within 2e-3 of ‖ref‖∞ (the reference's
    ``test_kappa_equivalence``) on a sketch of a well-conditioned H at
    p = 50,890; on distillation's own sketch, whose H_KK is indefinite and
    nearly singular, the two part ways by design (Alg. 1 drops the
    directions its threshold sends to ``_SAFE_BIG``), and the gap is
    printed. Tab. 2's ordering (distilled accuracy) is printed, not gated.
12. Alg. 1 alone at p = 2²⁴, k = 64, κ = 16 (a sketch of H = G Gᵀ/32 + I
    made on the card), f32 and bf16 sketches, vector and m = 32 block: the
    chunked apply through the kernels (B per chunk factor and refine sweep;
    A's cross in the block form) against the whitened apply on the same
    sketch (CUDA events, 5 runs after 1), and against its plain version
    with every kernel evaluated in f64 (relative L2 ≤ 1e-4); kernel B's
    launches per apply and each operand's load path (kernel A's variant in
    the block form) are printed.

The iMAML meta path, forward mode and influence (the seventh slice):

13. iMAML: ``solve(build_imaml(), HypergradConfig(k=10, rho=1e-2,
    backend='cuda'), vmap_tasks=8)`` at Tab. 3's widths (5-way 1-shot,
    20 × 20 images, MLP 400→64→64→5, p = 30,149, 10 inner SGD steps at lr
    0.1, Adam 1e-3), with ``shared_sketch=True`` and ``False``: 1 warm-up
    and 3 timed meta-steps each (seconds per meta-step, launches per
    meta-step, peak memory), one profiled meta-step (device idle share).
    Gates: the per-task hypergradients of one meta-step through the kernels
    against ``backend='flat'`` at the same column draws, relative L2 ≤ 1e-4
    for every task, in both modes; the shared run must launch the gram,
    cross and block-apply kernels, the per-task run the gram, ctv and
    vector-apply kernels. The cosine of the two modes' mean hypergradients
    is printed (what the reference's ``bench_shared_sketch`` measures).
14. Forward mode: ``torch.func.jvp`` of the solution map on
    ``reweighting`` (p = 26,122) at phase 4's solved state, through the
    kernels against ``backend='flat'`` (relative L2 ≤ 1e-4), and
    ⟨u, Jφ̇⟩ against ⟨Jᵀu, φ̇⟩ between the jvp and the VJP (≤ 1e-4
    relative).
15. Influence: ``influence(build_influence())`` at p = 26,122 with
    parameters trained for the default 200 SGD steps at batch 128, m = 32
    queries, top 10, ``self_influence=True``: seconds of ``influence()``
    and of the scan alone, launches, the device idle share of one profiled
    call. Gates against ``backend='flat'``: scores within 1e-4 of
    max |score|, top-k indices equal wherever neighbouring scores differ by
    more than 1e-5 of it, self-influence within 1e-4, ``hvp_count == 10``.

The serving tier and checkpoints (the eighth slice), on phase 15's problem,
parameters and column draw, Nyström k = 10, ρ = 1e-2, ``backend='cuda'``,
top 10, the same 32 queries:

16. (a) The CLI's route: ``launch.train._serve_problem`` as
    ``--problem influence --serve --queries 32`` runs it (200 training
    steps, ``warmup()``, a cold and a warm pass of m = 1 flushes,
    ``max_delay = 0``), on the kernels' backend; the passes it returns
    must bill 10 build HVPs cold and 0 warm with hit rate 1.0, and the
    launches over warmup and both passes must be its two builds' grams
    and the m = 1 applies' ctv and vector-apply launches. (b) Bursts: a
    service whose ``warmup()`` calibrates ``block_size`` over (1, 2, 4, 8,
    16) (q/s for each m printed) takes the 32 queries at once, pumps and
    flushes, cold and then warm: latency p50/p95, q/s, flush ms, and the
    device idle share of one profiled warm burst. (c) Restart: the
    parameters through ``CheckpointManager(async_save=True)`` and a restore
    on the card (``params_digest`` equal), the sketch through
    ``save_entry`` into a fresh ``SketchStore``: ``influence(store=)`` is a
    disk hit with ``hvp_count == 0`` and answers bitwise as the warm call
    did (m = 32), a service on the restored parameters answers the burst
    bitwise as the warm burst did; a bf16 sketch spills and loads back bit
    for bit. Peak device memory. Gates: every answer within 1e-4 of
    max |score| of ``backend='flat'`` at the same draw and parameters, top-k
    indices equal where neighbouring scores are apart (phase 15's gate), no
    degraded flush, and the launch counts exactly: one gram a cold build
    and none warm or from disk; 3 Cᵀv (kernel B) and 2 vector applies a
    flush at m = 1, 3 crosses and 2 block applies a flush at m ≥ 2
    (kernel C), and warmup()'s 4 applies a width.

Second order and the multi-level engine (the ninth slice), every edge and
map through the kernels (``backend='cuda'``) against ``backend='flat'`` on
the card:

17. (a) ``jacfwd(grad)`` and ``jacrev(grad)`` through ``implicit_root`` on a
    non-quadratic toy (inner ``0.5‖x‖² + 0.025‖x‖₄⁴·Σexp(φ) − (Aφ)·x``,
    outer ``‖x − 1‖²``, 200 SGD steps), full-rank Nyström (k = 4,
    ρ = 1e-2): relative L2 ≤ 1e-4, kernels A, B and C each launched inside
    the rules. (b) ``reweight_maml`` at the registry defaults
    (``distill_hpo`` is cut, ``ENGINE_CUTS``, the reason printed),
    ``ENGINE_STEPS`` outer steps (3; seconds per step, launches): top
    losses within 1e-4 relative of the same on ``'flat'``, ``edge_hvps``
    equal to ``engine_edge_bills``, ``engine_hypergrad`` against the
    port's dense oracle within ``ENGINE_HG_BOUND`` (the reference's own
    error at the same settings, measured on the CPU by
    ``tests/test_torch_engine_bounds.py``) and against ``'flat'`` within
    1e-4. (c) ``distill_hpo(**STREAM_KW)``, images p = 18,000 and k = 10:
    one outer step on each backend: its seconds (first-call set-up
    included), launches, peak device memory; gated on the top loss and on
    the top gradient at the final values (``top_gradient``, each run's
    live sketches) within 1e-4.

The bilevel LM trainer (the tenth slice), ``launch.train.train_lm``:

18. (a) ``yi_9b.reduced()`` (f32), the CLI's loop: batch 4, seq 32, 6
    steps, an outer step every 3, Nyström k = 8, ρ = 1e-2,
    ``column_chunk=4``, on ``backend='cuda'`` and ``'flat'`` with the same
    seeded parameters and draws: inner losses, outer values and
    hypergradients within 1e-4 relative, each outer step's move of the
    domain logits within 1e-4 where its hypergradient has signal (elsewhere
    it is f32 noise, which adam turns into ±0.64·lr either way: held to
    2·lr a step); gram on ``atb_cc``, ctv and the vector apply launched.
    (b) Yi-9B at full width (d_model 4096, 32/4 heads, d_ff 11008, vocab
    64000), depth ``LM_DEPTH`` = 2, f32 parameters, bf16 compute, remat
    'full', p = 870,338,560: ``train_lm`` with batch 8, seq 128, 4 steps,
    an outer step every 2, k = 8, ``column_chunk=LM_CHUNK``, ``'cuda'``
    with a bf16 sketch. Prints seconds per inner and outer step, launches,
    peak device memory, the noisy-domain weight; then the last outer step
    again at its parameters, batches and draw, split into the HVP columns,
    ``prepare`` and the apply with the mixed term, the draw's host time
    against ``randperm(p/8)``'s, one profiled step (device idle share).
    Gates: kernels A-C on the step's own bf16 B (p, 8) and seeded vectors
    against their plain versions in f64 (``blocked_f64_backend``; gram
    relative L2 ≤ 1e-5, ctv and apply rtol 1e-5, atol 1e-5·‖ref‖∞), and
    the step's IHVP u = (H_k + ρI)⁻¹∇θg on the same C and B through the
    kernels against the same apply with each kernel replaced by its f64
    plain version (relative L2 ≤ 1e-4, phase 12's gate for Alg. 1). The
    hypergradients are printed, not gated: the mixed term rounds u to the
    bf16 compute dtype, so f32-level differences in u come out at bf16's
    resolution; beside them ``backend='flat'``'s (torch.matmul in f32),
    the f64 apply on kernel A's own gram, and the eigenvalues of BᵀB
    against ρ; gram on ``atb_tc``, ctv and the vector apply launched.

The decode path and the MoE family (the eleventh slice), random bf16
weights from a seed, the plain PyTorch decode (no kernel, as in the
reference; kernels A–E must launch 0 times in every decode run):

19. Yi-9B at full width and depth. (a) Decode against ``forward`` (the
    plain path) on B = 4 prompts of T = 32 tokens fed one at a time from an
    empty cache (``max_len`` 64), relative L2 of the logits at every
    position: with f32 compute (the bf16 weights widened) at full depth
    ≤ 1e-4, in bf16 at depth ``PARITY_LAYERS`` ≤ 2e-2 (phase 10's gate
    and depth), and in bf16 at full depth printed, ungated, beside the
    forward's own gap between one row alone and in the batch: at 48
    layers that gap is as large as decode's (bf16 roundings that change
    with the GEMMs' shapes, grown through the depth). (b) Serving:
    B = 32 sequences in an 8192-entry cache (25.8 GB; cut from
    ``decode_32k``'s 128 × 32768, 412 GB), a 16-token prompt then 64
    greedy tokens through ``build_serve_step``: ms per step (median after
    ``DECODE_WARM``), tokens/s, peak memory, and one profiled step's
    device time by family (decode attention, GEMMs, elementwise, rest),
    kernel count and idle share.
20. The MoE family at full width. (a) Phi-3.5-MoE, depth 16 (cut from 32:
    83.7 GB), ``use_pallas=True``: 3 requests of 4 × 4096 tokens after a
    warm-up, each launching kernel D 32 times and E 16 times, all on
    ``flash_fwd_tc``: ms per prefill, tokens/s, peak memory, host syncs
    of one prefill (sync debug mode), one profiled prefill by family
    (expert GEMMs, other GEMMs, router GEMMs, routing and combine, E, D,
    elementwise, rest) and its idle share; then the kernel path against
    the plain path at depth 4 (phase 10's gates, f32 ≤ 1e-4 and bf16
    ≤ 2e-2) over the sequences whose last token routed alike on both
    paths, with the count of tokens whose routing flipped. (b) Phi decode:
    (a)'s consistency (B = 4, T = 32) and serving at B = 32 with a
    4096-entry cache (8.6 GB). (c) One Llama-4 Maverick block
    (``n_layers=2``: a dense layer, then 128 experts top-1 with the shared
    expert, 37.1 GB): one prefill of 1 × 4096 tokens through D and E after
    a warm-up, then 16 decode steps at B = 4 against ``forward``, and the
    peak memory. In the MoE comparisons a token whose experts differ
    between the two runs in some layer (a routing flip at a near-tie) is
    left out with the tokens after it, and the flips are counted; at
    least B tokens must be compared.

The model zoo's last four families (the twelfth slice), random bf16
weights from a seed, ``use_pallas=True`` on the prefills; kernels A–E must
launch 0 times in every decode run:

21. (a) Qwen2-VL-7B at half depth (14 of 28 layers, cut for the
    script's time, ``FAMILY_HALF_DEPTH``; M-RoPE, embedding inputs): 3
    prefills of 4 × 4096 seeded bf16 embeddings with an image's (t, h,
    w) ids after a warm-up, each launching D 28 and E 14 times, all on
    ``flash_fwd_tc`` (a GQA group of 7, hd 128); decode against
    ``forward`` (B = 4, T = 32, as phase 19 (a)); serving at B = 32 in a
    4096-entry cache, fed seeded embeddings a step. (b)
    SeamlessM4T-large-v2 at half depth (12 encoder + 12 decoder layers
    of 24 + 24, cut as (a); hd 64): 3 prefills of 4 × 4096 tokens against
    4 × 4096 encoder frames, each launching D 48 and E 24 times (12
    non-causal in the encoder, 12 causal in the decoder, tallied by mask;
    cross-attention is
    plain, as in the reference); decode against ``forward`` through
    decode's table (its decode unembeds through ``embed``, its forward
    through ``unembed``) with 64 encoder frames; serving at B = 32 in a
    4096-entry cache against 4096 frames, encoded and written by
    ``fill_cross_cache`` first; the kernel path against the plain path at
    4 + 4 layers. (c) Jamba-v0.1 at depth 8 (one period: 7 Mamba layers,
    1 attention layer, 4 MoE FFNs of 16 experts top-2; cut from 32, whose
    51.5 B bf16 parameters are 103 GB): 3 prefills of 2 × 4096 tokens (B
    cut from 4: the scan's f32 decay and drive are 4.3 GB each at B = 2),
    D 16 and E 1 each; its decode against ``forward`` with bf16 gated at
    its one period; serving at B = 32, Smax = 4096; the kernel path
    against the plain path at one period on the bf16 weights widened
    (f32) and as they are. (d) RWKV-6 1.6B at full depth (24 layers): one
    prefill of 4 × 4096 tokens after a warm-up (cut from 3: a prefill is
    ~491k launches of the time loop), D and E 0 (RWKV's norms are plain
    in the reference); decode against ``forward``; serving at B = 32.
    Jamba and RWKV-6 then decode at ``long_500k``'s Smax = 524,288 with
    B = 1 (4 prompt + 12 tokens). Each prefill and decode run prints ms,
    tokens/s, peak memory and one profiled run's device time by family
    (GEMMs, the time loops, cross-attention, decode attention, E, D,
    elementwise, MoE), kernel count and idle share; the recurrent
    prefills are profiled at S = 1024 (Jamba) and 256 (RWKV-6) against an
    unprofiled prefill of that size, since the profiler records each of
    the time loop's launches. The MoE gates leave out routing flips as
    phase 20 does.

The solver observatory (the thirteenth slice, ``repro_torch.bench``):

22. (a) The reference's default sweep (three toy problems, all four
    solvers) is cut, the reason printed (``OBS_SWEEP_CUT``). (b)
    ``reweighting`` at its registry defaults (p =
    26,122) as a population of 3 against the exact oracle at rho = 1e-2
    (``max_oracle_p`` 30,000): the adaptation's and the oracle's seconds
    and the build's peak memory, then every cell of all four solvers over
    k = 5, 10, 20, 50 (Nyström on 'cuda'), each with its error mean and
    max, ``hvp_count``, best wall time and applies/s; the exact cell
    within 1e-4 of the oracle, Nyström at k = 50 against 'flat' (the
    error mean and max at 1e-4 relative, ``hvp_count``, the stacked
    hypergradients member by member at 1e-4 relative L2), every error
    finite. (c) The Nyström cell at k = 10 under
    ``torch.profiler``: its device busy and idle share against the
    unprofiled cell, its kernels and its launches.

Training the encoder-decoder, M-RoPE/embedding-input and MoE families
(the fourteenth slice): f32 parameters from a seeded generator, bf16
compute, remat 'full', batches of 8 × 128 in ``make_batch_sds``'s layout
from a seed, every width whole and each depth cut printed with its reason
(``TRAIN_CUTS``); every hypergradient a k = 8 bf16 sketch with
``column_chunk=2`` whose gram runs on ``atb_tc``:

23. (a) SeamlessM4T-large-v2 at 8 + 8 layers (tokens and bf16 frames)
    and (b) Qwen2-VL-7B at depth 2 (bf16 embeddings, (t, h, w) ids with
    an image grid): ``lm_hypergrad`` at one draw at the initial
    parameters on 'cuda' and on 'flat' (its two reductions over p summed
    by blocks, ``blocked_flat_backend``), then 3 ``build_train_step``
    steps on its inner batch (losses finite and not rising). (c) Phi-3.5-MoE at depth 1 with 8
    of its 16 experts: ``train_lm`` (4 steps, an outer step every 2) on
    'cuda' and on 'flat', the same parameters, batches and draws; then
    from the cuda run's state 3 inner steps on one batch and the last
    outer step again, each timed, profiled (device idle share) and its
    host syncs counted (sync debug mode, and the MoE group-size reads).
    Gates, phase 18's: losses and values within 1e-4 relative; the
    hypergradients within 1e-4 relative L2 cuda against flat, or, where
    the f32 paths spread more, the IHVP through kernels A–C within 1e-4
    of their plain versions in f64; everything finite; A (``atb_tc``), B
    and C launched on every cuda run and nothing on 'flat'.

Training the recurrent families (the fifteenth slice): the same
settings, backward through the Mamba and RWKV-6 time loops (by chunks of
64 steps under ``torch.utils.checkpoint``, inside the blocks' own) and
HVP columns through them (``vmap(jvp(grad))``, the loops in one piece):

24. (a) RWKV-6 1.6B at its whole widths, depth cut (``RWKV_CUT``):
    ``train_lm`` (3 inner steps, then one outer step) on 'cuda' and on
    'flat', gated as phase 23 (c) (the runs equal until the first update,
    the logits within 2·lr, the first hypergradients cuda against flat or
    the IHVP through A–C against f64 within 1e-4); from the cuda run's
    state an inner step profiled (kernels, idle share, the device time of
    the loops' forward, their recompute in backward and their backward
    nodes) and the outer step again at its point, profiled, equal to the
    run's; one layer's forward and backward at 1 × 4096 with the loop by
    chunks and in one piece: the peak memory of each, the gradients
    within 1e-5. (b) Jamba-v0.1, one period: 3 ``build_train_step``
    steps with the Mamba mixers and attention at full width
    (``JAMBA_STEP_CUTS``: 2 experts, d_ff cut; the losses finite and the
    first update lowering the loss), one more profiled as in (a); then
    ``lm_hypergrad`` at a narrower cut (``JAMBA_HG_CUTS``, batches of 8 ×
    ``JAMBA_HG_S``) on 'cuda' and 'flat', gated as phase 23 (a). Where a
    Jamba cut runs out of memory the phase prints that and takes the
    next. A, B and C launch exactly 1, 3
    and 2 times a hypergradient, nothing on 'flat'.

The mesh (the sixteenth slice):

25. ``torch.distributed`` on one card: spawned ranks share ``cuda:0``
    over gloo (NCCL refuses two ranks on one GPU; gloo stages every
    all-reduce through the host, so nothing here measures NCCL), each
    capped at its share of the card's memory, loading phase 2's build;
    phases 25–28 run as three worlds of ranks (``MESH_WORLDS``: 4 ranks
    for 25 (a)–(b), 26 (a)–(b), 27 (a)–(b) and 28 (a), (b), (d), 2 for 25
    (c), 26 (c) and 28 (c), 8 for 27 (c)), each rank started once and
    running its parts in turn.
    (a) 4 ranks on a 2×2 ('data', 'model') mesh: ``flat_sharded`` at
    p = 2²⁴ (leaves sharded over both axes, over one, replicated,
    non-divisible, a scalar), k = 64, m = 32, f32 and bf16 sketches,
    through kernels A–C on each rank's (p_local, k) buffer: ctv, gram and
    ctm one all-reduce each, an ``apply`` and an ``apply_matrix`` at
    refine 0 exactly one, combine/combinem against their plain versions
    in f64 on the rank's rows, and on rank 0 the k-outputs against f64
    and the one-rank 'cuda' backend on the whole buffer, rank 0's blocks
    of ``apply_matrix`` against one rank's (≤ 1e-4), and both timed.
    (b) the same 4 ranks: Phi-3.5-MoE at full width, depth 1, through the
    ``capacity`` path (tokens over 'data', experts on d_ff over 'model'),
    kernels D and E in the layer, on a repetitive 1 × 2048 prompt that
    overflows the capacity; rank 0 against the one-card ``ragged`` path
    (bf16, ≤ 2e-2) on the tokens no drop touched, the drops counted.
    (c) 2 ranks on 1×2: the LM trainer's outer step at Yi-9B's full width,
    depth 1, through ``HypergradConfig(backend='flat_sharded', mesh,
    param_specs)``, a k = 8 bf16 sketch: each rank computes whole HVP
    columns and keeps its block; rank 0 then runs the step through 'cuda'
    on one rank: the hypergradients within 1e-4, or the IHVP within 1e-4
    of its plain version in f64. Every rank prints its launches, seconds
    and peak memory; a rank that fails or hangs fails the run.

A model split on the mesh (the seventeenth slice):

26. The dense family's steps with every layer split (heads, FFN columns
    and vocab over 'model', the batch over 'data', every weight also over
    'data' under FSDP), ranks spawned as in phase 25, Yi-9B at full
    width, depth cut. (a) ``build_prefill_step(mesh=)`` on 1 × 4 (8 q
    heads and 1 KV head a rank), depth 4, bf16, one 1 × 4096 prompt: each
    rank launches D 8 times and E 4 (on the tensor cores), and rank 0
    holds the gathered logits against one rank's unsplit prefill
    (≤ 2e-2). (b) two ``build_train_step(mesh=)`` steps on 2 × 2 with
    FSDP, depth 2, f32 parameters, bf16 compute, remat 'full', 8 × 128:
    losses and gradient norms against one rank's unsplit steps (≤ 2e-2
    relative). (c) ``build_hypergrad_step(mesh=)`` at depth 1, f32
    compute, k = 8 bf16 sketch, on 1 × 2: HVP columns through the
    collectives, kernels A–C on each rank's blocks, an apply with no
    gather and one all-reduce a k-output pass, the timed step's
    hypergradient (and ``lm_hypergrad``'s on the step's solver) against
    one rank's unsplit one (≤ 1e-3). The prefill on 1 × 8 and the
    hypergradient on 1 × 4 ran once and are cut (``SPLIT_CUTS``, printed;
    2 × 2 does not fit (c) on one card). Each rank prints its parameter
    bytes, seconds and peak; the ranks must agree.

Serving a split model (the eighteenth slice):

27. ``build_serve_step(mesh=)``: decode over the rank's block of the KV
    cache's sequence (flash-decoding: the softmax's max a ``pmax``, its
    sum and P·V ``psum``s), ranks spawned as in phase 25, full width,
    bf16, 8 teacher-forced steps (cut from 16 for the script's time)
    from a cache drawn from a seed up to 3/4 (1/8 short on 1 × 8) of its
    length less 4 (the steps cross into the last rank's block), each
    step's gathered logits held against one rank's ``decode_step`` on
    rank 0 (≤ 2e-2). (a) Yi-9B on 1 × 4, depth 4, B = 32, Smax = 8192.
    (b) SeamlessM4T on 1 × 4, depth 2 + 2 (cut from 4 + 4 for the
    script's time): a 1 × 4096 prefill over 4096 frames (each rank
    launches D 8 and E 4: 2 encoder calls non-causal, hd 64), then
    decode at B = 8, Smax = 4096 over a cross cache filled by
    ``encode``/``fill_cross_cache`` with its encoder positions over
    'model'. (c) Qwen2-VL-7B on 1 × 8,
    depth 2: its 28 heads padded per KV group to 32 (4 q heads and 1 KV
    head a rank; the projections row-parallel, ``wo`` replicated), a
    1 × 4096 prefill of embeddings with an image's (t, h, w) ids (D 4
    and E 2 a rank), then decode at B = 8, Smax = 4096. Both prefills
    are held against one rank's (≤ 2e-2). Each rank prints its cache
    bytes, the collectives a step by kind and the largest one's entries
    against a layer's cache block (it must be smaller), seconds a step
    against one rank's, and peak memory; the ranks must agree.

MoE on a split model (the nineteenth slice):

28. Phi-3.5-MoE and Llama-4 Maverick split on the mesh, in the worlds of
    phases 25-27: the experts' d_ff over 'model', the router whole, the
    ``capacity`` path on each rank's tokens (``moe_split``). Rank 0's
    oracle is one rank's run of the same weights with the MoE layer
    replaced, in this script only, by ``_moe_local(impl='capacity')`` on
    the same token shards (the reference's ``shard_map`` drops; one
    rank's ``ragged`` path is dropless); each part prints the replicas
    dropped by layer. (a) Phi-3.5-MoE on 1 × 4, full width, depth 2, bf16:
    a 1 × 4096 prefill (D 4 and E 2 a rank; 2e-2), then 8 decode steps at
    B = 32, Smax = 4096 (N·k <= 8·E: nothing drops, one rank's plain
    ``decode_step`` is the oracle; 2e-2); the expert and cache bytes a
    rank against the whole, collectives a step, seconds a step against
    one rank's, peak memory. (b) Phi-3.5-MoE on 2 × 2 with FSDP: two
    ``build_train_step(mesh=)`` steps, depth 1, 8 of 16 experts (cut,
    ``MOE_CUTS``), 8 × 128, the drops on each data shard; losses and
    norms against one rank's (2e-2). (c) Phi-3.5-MoE on 1 × 2:
    ``build_hypergrad_step(mesh=)``, depth 1, 4 of 16 experts (cut), f32
    compute, k = 8 bf16, the HVP columns through the capacity path and
    the collectives, kernels A–C on each rank's blocks (1e-3). (d) One
    Llama-4 Maverick block (a dense layer, a MoE layer with its shared
    expert, top-1) on 1 × 4, full width, bf16, 16 of 128 experts (cut):
    a 1 × 4096 prefill, then 8 decode steps at B = 8, Smax = 4096 (2e-2
    each).

The line before the last is the kernels' JSON record (seven rows, kernel
E's the tensor-core variant at the prefill's own call; rows 1–5 also
carry their p = 2²⁴ f32 and bf16 times under ``p24`` and the p = 2²⁰
shapes' under ``p20``, and row 2 its bf16 × bf16 cross, each entry with
the variant or load path that launched; a row's name carries the main
path's variant; rows 1, 3 and 4 carry the launches of phase 11's two
Nyström runs under ``distillation_launches``, rows 2 and 3 phase 12's
record under ``alg1_p24``, rows 1–5 the launches of phases 13–15 under
``imaml_launches_per_meta_step``, ``forward_mode_launches`` and
``influence_launches``, phase 16's by pass under ``serve_launches``, and
phase 17's under ``engine_launches``: (a), each graph of (b), and (c)'s
one step; phase 18's under ``lm_launches``: (a)'s cuda run and (b)'s
training run; rows 6–7 phase 20's prefills under ``moe_launches`` and
phase 21's (one prefill each) under ``family_launches``, rows 1, 3 and
4 phase 22's 'cuda' cells summed by part under ``observatory_launches``
and phases 23–24's cuda runs by family under ``train_launches`` (row 1's
counts the gram's ``atb_tc`` launches, all of them), and every row
phases 19–21's decode runs under ``decode_launches``, all 0; rows 1–5
phase 25 (a)'s and (c)'s launches by rank, rows 6–7 (b)'s, under
``mesh_launches``; rows 1–4 phase 26 (c)'s launches by rank (row 1's
gram runs as a cross, row 2's) and rows 6–7 (a)'s, under
``split_launches``; rows 6–7 phase 27's prefill and decode launches by
part and rank under ``serve_split_launches``; rows 6–7 phase 28 (a)'s
and (d)'s and rows 1–4 (c)'s by rank under ``moe_split_launches``);
the last
line is ``{"ok": true, "device": {...}}``; standard error ends with the
seconds each phase took, the seconds of its timed steps and the whole
run's. Without a CUDA device, or
without the repository beside it, the script exits non-zero and prints no
result.
"""
import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

SRC = Path(__file__).resolve().parent / 'src'
PEAK_F32 = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12    # H100 SXM dense bf16 tensor cores, FLOP/s
HBM = 3.35e12         # H100 SXM HBM3, bytes/s
RHO = 1e-2
MAIN_P, MAIN_K, M = 26122, 10, 32
LARGE_P, LARGE_K = 2 ** 24, 64
F1_P, F1_KM = 2 ** 20, ((512, 512), (64, 256))   # k, m beyond 256 and 8192
REPS, WARM = 20, 3
PREFILL_B, PREFILL_S, N_REQUESTS = 4, 4096, 3
PARITY_LAYERS, PARITY_B, PARITY_S = 4, 2, 2048
LONG_S = 32768        # the prefill_32k shape's sequence length

ROWS = [  # name, CUDA kernel (the main path's variant), source, the TPU
    # kernel it replaces
    ('nystrom_gram', 'atb_cc', 'src/repro_torch/csrc/atb.cu',
     'src/repro/kernels/nystrom_gram.py:58'),
    ('nystrom_cross', 'atb_cc', 'src/repro_torch/csrc/atb.cu',
     'src/repro/kernels/nystrom_gram.py:79'),
    ('woodbury_ctv', 'ctv_scalar', 'src/repro_torch/csrc/ctv.cu',
     'src/repro/kernels/woodbury.py:44'),
    ('woodbury_apply', 'apply_vec', 'src/repro_torch/csrc/woodbury_apply.cu',
     'src/repro/kernels/woodbury.py:103'),
    ('woodbury_apply_block', 'apply_block',
     'src/repro_torch/csrc/woodbury_apply.cu',
     'src/repro/kernels/woodbury.py:136'),
    ('rmsnorm', 'rmsnorm', 'src/repro_torch/csrc/rmsnorm.cu',
     'src/repro/kernels/rmsnorm.py:29'),
    ('flash_attention', 'flash_fwd_tc',
     'src/repro_torch/csrc/flash_attention.cu',
     'src/repro/kernels/flash_attention.py:80'),
]


def fail(msg: str) -> None:
    print(f'chip_smoke: {msg}', file=sys.stderr)
    sys.exit(1)


STEP_SECONDS: list[tuple[str, float]] = []   # (step, seconds), as they end


def _stepped(fn):
    """``fn`` with its seconds recorded, under its name and its label and
    dtype arguments, for the seconds by step that the script prints to
    standard error when it ends (a step's seconds include the steps it
    calls)."""
    @functools.wraps(fn)
    def step(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            tags = [str(a)[6:] if type(a).__name__ == 'dtype' else a
                    for a in (*args, *kw.values())
                    if type(a).__name__ == 'dtype' or (
                        isinstance(a, str) and not a.endswith(' W'))]
            STEP_SECONDS.append((f'{fn.__name__}({", ".join(tags)})',
                                 time.perf_counter() - t0))
    return step


def time_ms(torch, fn, reps: int = REPS, warm: int = WARM) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def cases(torch, ops, ref, p, k, dtype, dev, M=M):
    """Per kernel entry point: (kernel call, plain call, library call or
    None, inputs, FLOPs, bytes, every input bf16). The inputs are drawn on
    the card: drawn on the host, p = 2^24 took seconds a case."""
    g = torch.Generator(device=dev).manual_seed(p + k)

    def rnd(*shape, dt=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    C = rnd(p, k, dt=dtype)
    v, V = rnd(p), rnd(p, M)
    w, W = rnd(k), rnd(k, M)
    isz = C.element_size()
    f32 = dtype == torch.float32

    def mm_f32(A, B):   # AᵀB in f32; bf16 x bf16 with an f32 result
        return (torch.mm(A.T, B) if f32 else
                torch.mm(A.T, B, out_dtype=torch.float32))

    out = {
        'nystrom_gram': (
            ops.nystrom_gram, ref.nystrom_gram, lambda C: mm_f32(C, C), (C,),
            p * k * (k + 1), p * k * isz + 4 * k * k, not f32),  # G symmetric
        'nystrom_cross': (
            ops.nystrom_cross, ref.nystrom_cross,
            mm_f32 if f32 else None, (C, V),
            2 * p * k * M, p * k * isz + 4 * p * M + 4 * k * M, False),
        'woodbury_ctv': (
            ops.woodbury_ctv, ref.woodbury_ctv,
            (lambda C, v: torch.mv(C.T, v)) if f32 else None, (C, v),
            2 * p * k, p * k * isz + 4 * p + 4 * k, False),
        'woodbury_apply': (
            lambda C, w, v: ops.woodbury_apply(C, w, v, RHO),
            lambda C, w, v: ref.woodbury_apply(C, w, v, RHO),
            (lambda C, w, v: torch.addmv(v, C, w, beta=1 / RHO,
                                         alpha=-1 / RHO ** 2)) if f32 else None,
            (C, w, v), 2 * p * k + 2 * p, p * k * isz + 4 * k + 8 * p, False),
        'woodbury_apply_block': (
            lambda C, W, V: ops.woodbury_apply(C, W, V, RHO),
            lambda C, W, V: ref.woodbury_apply(C, W, V, RHO),
            (lambda C, W, V: torch.addmm(V, C, W, beta=1 / RHO,
                                         alpha=-1 / RHO ** 2)) if f32 else None,
            (C, W, V), 2 * p * k * M + 2 * p * M,
            p * k * isz + 4 * k * M + 8 * p * M, False),
    }
    if not f32 and p >= F1_P:   # the tensor-core cross: bf16 queries
        out['nystrom_cross_bf16'] = (
            ops.nystrom_cross, ref.nystrom_cross, mm_f32, (C, V.to(dtype)),
            2 * p * k * M, (p * k + p * M) * isz + 4 * k * M, True)
    return out


def report_build(path) -> None:
    """Phase 2: what ptxas said of the variants of kernels A, B, C and E
    (registers, spills) and the count of tensor-core instructions (HGMMA)
    in kernels A's and E's SASS; the tensor-core variants must hold some."""
    from repro_torch.kernels import _lib
    kernels = ('flash_fwd', 'atb_', 'apply_', 'ctv_')
    fn = None
    for line in _lib.build_log().splitlines():
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            fn = m.group(1)
        elif fn and any(k in fn for k in kernels) and ('spill' in line
                                                      or 'Used' in line):
            print(f'ptxas: {fn}: {line.split(":", 1)[-1].strip()}',
                  flush=True)
    tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    sass = subprocess.run([tool, '-sass', str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts: dict = {}
    for line in sass.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn in counts and 'HGMMA' in line:
            counts[fn] += 1
    for fn, n in counts.items():
        if 'flash_fwd' in fn or 'atb_' in fn:
            print(f'sass: {fn}: {n} HGMMA instructions', flush=True)
            if ('flash_fwd_tc' in fn or 'atb_tc' in fn) and n == 0:
                raise AssertionError(f'{fn} holds no HGMMA instruction')


@_stepped
def check_kernels(torch, ops, ref, p, k, dtype, dev, exact_ref: bool,
                  m: int = M):
    """Hold each kernel against its plain version; time all three."""
    from repro_torch.kernels import _lib
    out = {}
    for name, (kern, plain, lib, args, flops, nbytes, bf16) in cases(
            torch, ops, ref, p, k, dtype, dev, m).items():
        before = dict(_lib.LAUNCHES)
        got = kern(*args)
        variant = _variant(_lib, name, args, before)
        want = (plain(*[a.double() for a in args]).float() if exact_ref
                else plain(*args))
        torch.cuda.synchronize()
        err = (got - want).abs()
        limit = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
        max_err = float(err.max())
        if not bool((err <= limit).all()) or not math.isfinite(max_err):
            raise AssertionError(
                f'{name} p={p} k={k} {dtype}: kernel disagrees with its plain '
                f'version, max |err| {max_err:.3e}')
        # the library call against the same reference: printed, not gated
        lib_err = ('-' if lib is None else
                   f'{float((lib(*args) - want).abs().max()):.3e}')
        del got, want, err, limit
        out[name] = _timed(
            torch, f'{name:<21} p={p} k={k} m={m} {str(dtype)[6:]:<8} '
            f'[{variant}] library_max_err={lib_err}',
            lambda: kern(*args), lambda: plain(*args),
            (lambda: lib(*args)) if lib is not None else None, flops, nbytes,
            bf16, max_err, REPS, REPS)
        out[name]['variant'] = variant
    torch.cuda.empty_cache()
    return out


def _variant(_lib, name: str, args, before: dict) -> str:
    """Kernel A's variant that a phase 3 launch took, read from the
    tensor-core launch counters, which must be ``atb_variant``'s answer;
    for kernels B and C, the load path the rules ``ctv_path`` and
    ``rows16`` name (the rules' answers: a launch reports no path of its
    own; ``tests/test_torch_cuda.py`` reads kernel B's from the
    profiler)."""
    C = args[0]
    if name.startswith('nystrom'):
        B = C if name == 'nystrom_gram' else args[1]
        rule = _lib.atb_variant(C.dtype, B.dtype, C.shape[0], C.shape[1],
                                B.shape[1], (C.data_ptr(), B.data_ptr()))
        key = 'nystrom_gram' if name == 'nystrom_gram' else 'nystrom_cross'
        tc = _lib.LAUNCHES[key + '_tc'] > before[key + '_tc']
        if tc != (rule == 'tensor_cores'):
            raise AssertionError(f'{name}: launched tensor cores={tc}, the '
                                 f'rule names {rule}')
        return 'atb_tc' if tc else 'atb_cc'
    if name.startswith('woodbury_apply'):
        rows = _lib.rows16(C.dtype, C.shape[1], C.data_ptr())
        return 'rows16 rule: ' + ('16-byte rows' if rows else 'scalar rows')
    return _lib.ctv_path(C.dtype, C.shape[1], C.data_ptr())


def _p24(rec: dict) -> dict:
    return dict(variant=rec['variant'], kernel_ms=rec['ms'],
                bound_ms=rec['bound_ms'], library_ms=rec['library_ms'])


# gpu-marked tests that phase 3 leaves out for the whole script's time, each
# with the phase that holds the same on the card
KERNEL_TEST_CUTS = {
    'test_engine_graph_through_the_kernels_matches_flat[distill_hpo]':
        'the 1200 s limit (25.7 s of host dispatch on the card); phase 17 '
        '(c) holds the distill_hpo graph on cuda against flat, larger'}
# The kernel tests run as this many pytest processes side by side on the
# card (nothing else runs then, and no test times anything), the test
# functions dealt out slowest first: in one process they took 81.6 s.
KERNEL_TEST_SHARDS = 3
KERNEL_TEST_SLOW = {   # s on the card (chip run, NVIDIA H100 80GB HBM3, 700 W)
    'test_split_prefill_on_two_gloo_ranks': 12.0,
    'test_flat_sharded_on_one_nccl_rank': 10.0,
    'test_shared_sketch_meta_backward_is_one_block_apply': 9.2,
    'test_engine_graph_through_the_kernels_matches_flat': 7.5}


def _kernel_test_shards(path: Path) -> list:
    """The test functions of ``path`` in ``KERNEL_TEST_SHARDS`` groups:
    those of ``KERNEL_TEST_SLOW`` first, each to the lightest group, then
    the rest (about 0.5 s each, their parameters included)."""
    import ast
    names = [n.name for n in ast.parse(path.read_text()).body
             if isinstance(n, ast.FunctionDef) and n.name.startswith('test_')]
    shards = [[0.0, []] for _ in range(KERNEL_TEST_SHARDS)]
    for name in sorted(names, key=lambda n: -KERNEL_TEST_SLOW.get(n, 0.5)):
        shard = min(shards, key=lambda sh: sh[0])
        shard[0] += KERNEL_TEST_SLOW.get(name, 0.5)
        shard[1].append(name)
    return [names for _, names in shards]


@_stepped
def run_kernel_tests() -> None:
    """The ``gpu``-marked kernel tests on the card, in pytest subprocesses
    side by side (the repository's conftest imports JAX, which the port
    never needs), but those of ``KERNEL_TEST_CUTS``, each cut printed with
    its reason. Any process that fails fails the phase."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    cut = []
    for test, why in KERNEL_TEST_CUTS.items():
        print(f'kernel tests: {test} cut: {why}', flush=True)
        cut += ['--deselect', f'tests/test_torch_cuda.py::{test}']
    path = SRC.parent / 'tests' / 'test_torch_cuda.py'
    tmp = Path(tempfile.mkdtemp(prefix='chip_smoke_kernel_tests_'))
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'pytest', '-q', '--noconftest', '-p',
         'no:cacheprovider', '-m', 'gpu', '--durations=5',
         f'--basetemp={tmp / str(i)}', *cut,
         *[f'tests/test_torch_cuda.py::{name}' for name in names]],
        cwd=SRC.parent, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for i, names in enumerate(_kernel_test_shards(path))]
    failed = []
    try:
        for i, proc in enumerate(procs):
            left = max(1.0, 900 - (time.perf_counter() - t0))
            log, _ = proc.communicate(timeout=left)
            tail = log.strip().splitlines()[-12:]
            print('\n'.join(f'kernel tests [{i}]: {line}' for line in tail),
                  flush=True)
            if proc.returncode != 0:
                failed.append(f'[{i}] rc {proc.returncode}')
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise AssertionError(f'tests/test_torch_cuda.py failed: {failed}')
    print(f'kernel tests: passed in {time.perf_counter() - t0:.1f} s, '
          f'{KERNEL_TEST_SHARDS} processes', flush=True)


@_stepped
def trace_phases(torch, solve, problem, config, step_s: float, n: int = 3,
                 phases=('bilevel.inner', 'bilevel.sketch', 'bilevel.update'),
                 label: str = 'trace') -> None:
    """Profile ``solve`` for ``n`` outer steps and print, per outer step,
    each trainer phase's host and device time and the device's busy share
    of ``step_s`` (the unprofiled step, which excludes the problem's
    metrics: so does the profiled run). Kernels run on one stream, so
    their times add."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = solve(dataclasses.replace(problem, metrics={}), config,
                       n_outer=n)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        print(f'{label}: the profiler recorded no device events; device '
              'time not measured', flush=True)
        return
    for phase in phases:
        ranges = [e for e in events
                  if e.name == phase and e.device_type == DeviceType.CPU]
        if len(ranges) != n:
            raise AssertionError(f'{phase}: {len(ranges)} ranges in {n} '
                                 'outer steps')
        host = sum(e.time_range.elapsed_us() for e in ranges) / 1e3 / n
        device = sum(e.device_time_total for e in ranges) / 1e3 / n
        print(f'{label}: phase {phase:<14} host {host:9.3f} ms  device '
              f'{device:7.3f} ms per outer step', flush=True)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    print(f'{label}: {len(kernels) / n:.0f} kernels and {busy:.3f} ms of '
          f'device time per outer step; profiled step '
          f'{traced.seconds / n * 1e3:.3f} ms, unprofiled step '
          f'{step_s * 1e3:.3f} ms: device idle '
          f'{100 * (1 - busy / (step_s * 1e3)):.1f}%', flush=True)


def _gate(name: str, got, want, atol: float, rtol: float) -> float:
    """|got − want| ≤ atol + rtol·|want| elementwise, in f32; the max
    |err|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_err = float(err.max())
    if not math.isfinite(max_err) or not bool(
            (err <= atol + rtol * want.abs()).all()):
        raise AssertionError(
            f'{name}: kernel disagrees with its plain version, max |err| '
            f'{max_err:.3e} (atol {atol}, rtol {rtol})')
    return max_err


def _timed(torch, label: str, kern, plain, lib, flops: float, nbytes: float,
           bf16: bool, max_err: float, reps: int, plain_reps: int) -> dict:
    """Time kernel, plain version and library call (None where there is
    none); print and return the record. Operations are counted at the bf16
    tensor-core peak where every input is bf16, else at the fp32 peak."""
    warm = min(WARM, reps)
    t_op, t_b = flops / (PEAK_BF16 if bf16 else PEAK_F32), nbytes / HBM
    rec = dict(max_abs_err=max_err,
               ms=time_ms(torch, kern, reps, warm),
               plain_ms=time_ms(torch, plain, plain_reps,
                                min(WARM, plain_reps)),
               library_ms=(time_ms(torch, lib, reps, warm)
                           if lib is not None else None),
               bound_ms=max(t_op, t_b) * 1e3,
               bound_by='operations' if t_op > t_b else 'bytes')
    lib_ms = ('-' if rec['library_ms'] is None
              else f"{rec['library_ms']:.4f}")
    print(f"kernel {label} max_err={max_err:.3e} kernel_ms={rec['ms']:.4f} "
          f"plain_ms={rec['plain_ms']:.4f} library_ms={lib_ms} "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
    return rec


def _shifted(t):
    """t's values in a tensor whose base address is 8 bytes past the
    16-byte grid (strides unchanged)."""
    n = 8 // t.element_size()
    buf = t.new_empty(t.numel() + n)
    out = buf[n:].view(t.shape)
    out.copy_(t)
    return out


@_stepped
def check_model_kernels(torch, ops, ref, dev) -> dict:
    """Phase 7: kernels D and E against their plain versions; the records
    at the prefill's shapes (bf16, causal; flash with Yi-9B's 4 KV
    heads)."""
    import torch.nn.functional as F
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import expand_kv
    g = torch.Generator(device=dev).manual_seed(7)   # drawn on the card

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    out = {}
    n = PREFILL_B * PREFILL_S
    for d, dtype in ((4096, torch.bfloat16), (4096, torch.float32),
                     (1000, torch.bfloat16)):
        x, sc = rnd((n, d), dtype), rnd((d,), dtype)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        err = _gate(f'rmsnorm d={d} {dtype}', ops.rmsnorm(x, sc, 1e-5),
                    ref.rmsnorm(x, sc, 1e-5), tol, tol)
        rec = _timed(torch, f'rmsnorm x=({n},{d}) {str(dtype)[6:]}',
                     lambda: ops.rmsnorm(x, sc, 1e-5),
                     lambda: ref.rmsnorm(x, sc, 1e-5),
                     lambda: F.rms_norm(x, (d,), sc, 1e-5), 4 * n * d,
                     (2 * n * d + d) * x.element_size(), False, err, REPS,
                     REPS)
        if d == 4096 and dtype == torch.bfloat16:
            out['rmsnorm'] = rec
        del x, sc

    # (q shape, KV heads, dtype, causal, base address off the 16-byte grid)
    P4 = (PREFILL_B, PREFILL_S, 32, 128)
    cases = [(P4, 32, torch.bfloat16, True, False),
             (P4, 32, torch.bfloat16, False, False),
             (P4, 32, torch.float32, True, False),
             ((2, 256, 4, 128), 4, torch.float32, True, False),
             ((2, 256, 4, 128), 4, torch.float32, False, False),
             ((2, 256, 4, 64), 4, torch.float32, True, False),
             ((1, LONG_S, 32, 128), 32, torch.bfloat16, True, False),
             # the prefill's own call: Yi-9B's 4 KV heads read in place
             (P4, 4, torch.bfloat16, True, False),
             ((1, LONG_S, 32, 128), 4, torch.bfloat16, True, False),
             ((PREFILL_B, PREFILL_S, 32, 64), 4, torch.bfloat16, True, False),
             ((2, 100, 4, 128), 4, torch.bfloat16, False, False),
             # the bf16 CUDA-core variant at the prefill's shape
             (P4, 4, torch.bfloat16, True, True)]
    for shape, KV, dtype, causal, off_grid in cases:
        B, S, H, hd = shape
        kv_shape = (B, S, KV, hd)
        q, k, v = rnd(shape, dtype), rnd(kv_shape, dtype), rnd(kv_shape, dtype)
        if off_grid:   # 8 bytes past the grid: the CUDA-core kernel's
            q, k, v = (_shifted(t) for t in (q, k, v))   # 8-byte loads
        # f32: test_kernels.py's 2e-5; bf16: one ulp of the rounded output
        atol, rtol = ((2e-5, 2e-5) if dtype == torch.float32
                      else (1e-5, 2.0 ** -7))
        before = _lib.LAUNCHES['flash_attention_tc']
        got = ops.flash_attention(q, k, v, causal=causal)
        tc = _lib.LAUNCHES['flash_attention_tc'] > before
        if tc != (dtype == torch.bfloat16 and hd in (64, 128)
                  and not off_grid):
            raise AssertionError(f'flash {shape}: the dispatch rule chose '
                                 f'tensor cores={tc}')
        variant = 'tensor-core' if tc else 'cuda-core'
        # the dense plain version holds (rows, H, S, S) f32 scores: take it
        # per batch row, and per head at 32k, on the expanded KV heads
        if S > PREFILL_S:
            parts = [(slice(None), slice(h, h + 1)) for h in range(H)]
        else:
            parts = [(slice(b, b + 1), slice(None)) for b in range(B)]

        def plain(k, v):
            kx, vx = expand_kv(k, H // KV), expand_kv(v, H // KV)
            return [ref.flash_attention(q[bi][:, :, hi], kx[bi][:, :, hi],
                                        vx[bi][:, :, hi], causal=causal)
                    for bi, hi in parts]
        label = (f'flash_attention {shape} kv={KV} {str(dtype)[6:]} '
                 f'causal={causal}{" off-grid" if off_grid else ""} '
                 f'[{variant}]')
        err = max(_gate(label, got[bi][:, :, hi], want, atol, rtol)
                  for (bi, hi), want in zip(parts, plain(k, v)))
        del got
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        big = S > PREFILL_S
        rec = _timed(
            torch, label,
            lambda: ops.flash_attention(q, k, v, causal=causal),
            lambda: plain(k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=KV != H),
            4 * B * H * S * S * hd / (2 if causal else 1),
            (2 * B * S * H + 2 * B * S * KV) * hd * q.element_size(),
            dtype == torch.bfloat16, err, 2 if big else 5, 1 if big else 2)
        if (shape == P4 and KV == 4 and causal and dtype == torch.bfloat16
                and not off_grid):
            out['flash_attention'] = rec
            kx, vx = (expand_kv(t, H // KV).transpose(1, 2) for t in (k, v))
            ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kx, vx, is_causal=True), 5, 2)
            print(f'flash_attention {shape} kv={KV}: SDPA on the expanded '
                  f'heads {ms:.4f} ms (a yardstick)', flush=True)
            del kx, vx
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def _rel_l2(a, b, f64: bool = False) -> float:
    a, b = (a.double(), b.double()) if f64 else (a.float(), b.float())
    return float((a - b).norm() / b.norm())


def trace_prefill(torch, step, params, batch, prefill_ms: float) -> None:
    """Phase 9: one prefill under ``torch.profiler``; device time by
    kernel family and the device's idle share of the unprofiled prefill."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        print('prefill trace: the profiler recorded no device events; device '
              'time not measured', flush=True)
        return
    families = {'flash (kernel E)': ('flash_fwd',),
                'RMSNorm (kernel D)': ('rmsnorm_rows',),
                'GEMM (cuBLAS)': ('gemm', 'nvjet', 'xmma', 'cutlass',
                                  'gemv')}
    split = dict.fromkeys([*families, 'rest'], 0.0)
    rest: dict = {}
    for e in kernels:
        name = e.name.lower()
        fam = next((f for f, keys in families.items()
                    if any(key in name for key in keys)), 'rest')
        ms = e.time_range.elapsed_us() / 1e3
        split[fam] += ms
        if fam == 'rest':
            rest[e.name[:60]] = rest.get(e.name[:60], 0.0) + ms
    busy = sum(split.values())
    for fam, ms in split.items():
        print(f'prefill trace: {fam:<19} {ms:10.3f} ms device '
              f'({100 * ms / busy:5.1f}%)', flush=True)
    top = sorted(rest.items(), key=lambda kv: -kv[1])[:4]
    print(f'prefill trace: {len(kernels)} kernels, {busy:.3f} ms of device '
          f'time; unprofiled prefill {prefill_ms:.3f} ms: device idle '
          f'{100 * (1 - busy / prefill_ms):.1f}%; largest of the rest: '
          + ', '.join(f'{n} {ms:.3f} ms' for n, ms in top), flush=True)


@_stepped
def run_prefill(torch, dev) -> dict:
    """Phases 8 and 9: Yi-9B's serving prefill at full width and depth.
    Returns the launches of the 3 requests."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import tree_leaves
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import build_prefill_step, serve_params
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config('yi_9b'), use_pallas=True)
    t0 = time.perf_counter()
    # drawn per weight in f32 and stored in bf16 at once (param_dtype),
    # which keeps the init near its 17.7 GB; serve_params is the serving
    # load's cast, here already done
    params = serve_params(build_model(dataclasses.replace(
        cfg, param_dtype='bfloat16')).init(torch.Generator(dev).manual_seed(0)))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f'prefill: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} '
          f'H={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} '
          f'vocab={cfg.vocab_size}, {n_params / 1e9:.3f} B bf16 parameters '
          f'({torch.cuda.memory_allocated() / 1e9:.2f} GB) drawn in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    step = build_prefill_step(cfg)
    gen = torch.Generator().manual_seed(1)
    batches = [{'inputs': torch.randint(0, cfg.vocab_size,
                                        (PREFILL_B, PREFILL_S), generator=gen)}
               for _ in range(N_REQUESTS + 1)]
    t0 = time.perf_counter()
    step(params, batches[0])
    torch.cuda.synchronize()
    print(f'prefill: warm-up request {time.perf_counter() - t0:.3f} s',
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    # every flash launch of a request on the tensor-core kernel
    want = {'rmsnorm': 2 * cfg.n_layers, 'flash_attention': cfg.n_layers,
            'flash_attention_tc': cfg.n_layers}
    secs, first = [], None
    for i, batch in enumerate(batches[1:]):
        before = dict(_lib.LAUNCHES)
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per = {k: _lib.LAUNCHES[k] - before[k] for k in want}
        if tuple(logits.shape) != (PREFILL_B, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f'request {i}: logits {tuple(logits.shape)} '
                                 'not finite or of the wrong shape')
        if per != want:
            raise AssertionError(f'request {i}: launches {per}, want {want}')
        print(f'prefill request {i}: {secs[-1] * 1e3:.3f} ms, logits '
              f'{tuple(logits.shape)} finite, launches {per}, argmax '
              f'{logits.argmax(-1).tolist()}', flush=True)
        first = logits if first is None else first
    launches = dict(_lib.LAUNCHES)
    ms = sum(secs) / len(secs) * 1e3
    print(f'prefill: {ms:.3f} ms per prefill of {PREFILL_B} x {PREFILL_S} '
          f'tokens, {PREFILL_B * PREFILL_S / ms * 1e3:.0f} tokens/s, peak '
          f'memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB', flush=True)

    _lib.reset_launches()
    plain = build_prefill_step(dataclasses.replace(cfg, use_pallas=False))(
        params, batches[1])
    if _lib.LAUNCHES['rmsnorm'] or _lib.LAUNCHES['flash_attention']:
        raise AssertionError(f'the plain path launched kernels: '
                             f'{_lib.LAUNCHES}')
    agree = float((plain.argmax(-1) == first.argmax(-1)).float().mean())
    print(f'prefill full depth bf16, kernel path vs plain path: rel L2 '
          f'{_rel_l2(first, plain):.3e}, argmax agreement {agree:.2f} '
          '(ungated)', flush=True)
    trace_prefill(torch, step, params, batches[1], ms)
    return launches


@_stepped
def parity_cut_depth(torch, dev) -> None:
    """Phase 10: kernel path against plain path at full width, depth 4."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import build_prefill_step, serve_params
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config('yi_9b'), n_layers=PARITY_LAYERS,
                              compute_dtype='float32')
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(2))
    batch = {'inputs': torch.randint(
        0, cfg.vocab_size, (PARITY_B, PARITY_S),
        generator=torch.Generator().manual_seed(3))}
    for label, dtype, prm, tol in (
            ('f32', 'float32', params, 1e-4),
            ('bf16 serving', 'bfloat16', serve_params(params), 2e-2)):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        _lib.reset_launches()
        kern = build_prefill_step(dataclasses.replace(c, use_pallas=True))(
            prm, batch)
        counts = (_lib.LAUNCHES['rmsnorm'], _lib.LAUNCHES['flash_attention'],
                  _lib.LAUNCHES['flash_attention_tc'])
        plain = build_prefill_step(dataclasses.replace(c, use_pallas=False))(
            prm, batch)
        err = _rel_l2(kern, plain)
        # f32 runs kernel E's CUDA-core variant, bf16 its tensor-core one
        tc = PARITY_LAYERS if dtype == 'bfloat16' else 0
        if not err <= tol or counts != (2 * PARITY_LAYERS, PARITY_LAYERS,
                                        tc):
            raise AssertionError(f'parity {label}: rel L2 {err:.3e} '
                                 f'(tol {tol}), launches {counts}')
        print(f'parity {label}: yi-9b full width, depth cut to '
              f'{PARITY_LAYERS}, B={PARITY_B} S={PARITY_S}: kernel path vs '
              f'plain path rel L2 {err:.3e} (<= {tol}), launches {counts}',
              flush=True)


# ---------------------------------------------------------------------------
# 11-12. Tab. 2's solver family on distillation, and Alg. 1 at large p
# ---------------------------------------------------------------------------
DISTILL_P, DISTILL_PHI = 784 * 64 + 64 + 64 * 10 + 10, 50 * 28 * 28
TAB2 = {   # benchmarks/tab2_distillation.py: k = l = 10, rho = alpha = 1e-2
    'nystrom': dict(solver='nystrom', k=10, rho=1e-2, backend='cuda'),
    'nystrom kappa=5': dict(solver='nystrom', k=10, rho=1e-2, kappa=5,
                            backend='cuda'),
    'neumann': dict(solver='neumann', k=10, alpha=1e-2),
    'cg': dict(solver='cg', k=10, rho=0.0),
}
ALG1_K, ALG1_KAPPA = 64, 16


def _scaled_gap(torch, got, want) -> float:
    """max |got − want| / max |want| over two trees."""
    from repro_torch.core import tree_leaves
    a = torch.cat([x.reshape(-1) for x in tree_leaves(got)])
    b = torch.cat([x.reshape(-1) for x in tree_leaves(want)])
    return float((a - b).abs().max() / b.abs().max())


def _finite(torch, tree) -> bool:
    from repro_torch.core import tree_leaves
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(tree))


@_stepped
def run_distillation(torch, dev) -> dict:
    """Phase 11: ``solve`` on ``distillation`` at the task's full width,
    once per configuration of Tab. 2, with its gates. Returns the
    launches of the two Nyström runs, by configuration."""
    from repro_torch.core import (HypergradConfig, NystromIHVP,
                                  PyTreeIndexer, get_problem, hypergrad_at,
                                  hypergrad_error, make_hvp, solve,
                                  tree_leaves)
    from repro_torch.core.solvers import _chunk_factors
    from repro_torch.kernels import _lib
    problem = get_problem('distillation')
    p = sum(x.numel() for x in tree_leaves(problem.init_params(
        torch.Generator().manual_seed(0))))
    n_phi = problem.init_hparams(None)['images'].numel()
    if (p, n_phi) != (DISTILL_P, DISTILL_PHI):
        raise AssertionError(f'distillation has p={p}, {n_phi} '
                             'hyperparameters')
    n_outer, bs = 3, problem.defaults['batch_size']
    launches, ranking = {}, {}
    for name, fields in TAB2.items():
        config = HypergradConfig(**fields)
        warm = solve(problem, config, n_outer=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        res = solve(problem, config, n_outer=n_outer)
        launches[name] = dict(_lib.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        losses = res.history['outer_loss'] + res.history['inner_loss']
        if len(res.history['outer_loss']) != n_outer or not all(
                map(math.isfinite, losses)) or not _finite(torch, res.hparams):
            raise AssertionError(f'{name}: a loss or the images not finite')
        ib = problem.data.train_batch(n_outer, bs)
        ob = problem.data.val_batch(n_outer, bs)
        idx = PyTreeIndexer(res.params).sample_indices(
            torch.Generator().manual_seed(n_outer), 10)
        hg = hypergrad_at(problem, config, res.params, res.hparams, ib, ob,
                          indices=idx)
        if not _finite(torch, hg):
            raise AssertionError(f'{name}: hypergradient not finite')
        step_s = res.seconds / n_outer
        ranking[name] = res.metrics['distilled_accuracy']
        print(f'distillation {name:<16}: {step_s:.4f} s/outer step (first-'
              f'call warm-up step {warm.seconds:.4f} s), outer loss '
              f"{[round(x, 5) for x in res.history['outer_loss']]}, "
              f"distilled accuracy {ranking[name]:.4f}, peak device memory "
              f'{peak:.1f} MiB, launches { {k: v for k, v in launches[name].items() if v} }',
              flush=True)
        # the iterative solvers prepare inside the update: no sketch range
        phases = (('bilevel.inner', 'bilevel.sketch', 'bilevel.update')
                  if fields['solver'] == 'nystrom'
                  else ('bilevel.inner', 'bilevel.update'))
        trace_phases(torch, solve, problem, config, step_s, n=1,
                     phases=phases, label=f'distillation {name:<16}: trace')
        if fields['solver'] != 'nystrom':
            if any(launches[name].values()):
                raise AssertionError(f'{name} launched a kernel: '
                                     f'{launches[name]}')
            continue
        flat = hypergrad_at(problem, HypergradConfig(**dict(
            fields, backend='flat')), res.params, res.hparams, ib, ob,
            indices=idx)
        err = float(hypergrad_error(hg, flat))
        if not err <= 1e-4:
            raise AssertionError(f'{name}: cuda vs flat rel L2 {err:.3e}')
        print(f'distillation {name:<16}: hypergradient cuda vs flat rel L2 '
              f'{err:.3e} (<= 1e-4)', flush=True)
        if launches[name]['nystrom_gram'] == 0 or \
                launches[name]['woodbury_ctv'] == 0:
            raise AssertionError(f'{name}: kernels A and B must launch')
        if 'kappa' not in fields:
            if launches[name]['woodbury_apply'] == 0:
                raise AssertionError(f'{name}: kernel C never launched')
            continue
        if launches[name]['woodbury_apply'] or \
                launches[name]['woodbury_apply_block']:
            raise AssertionError(f'{name}: kernel C launched on Alg. 1')
        # the kappa = 5 apply against the literal Eq. 6 on one sketch: the
        # reference's tolerance holds where Eq. 6 and Alg. 1 agree in exact
        # arithmetic, a sketch of a well-conditioned H at this p (gated);
        # on distillation's own sketch (H_KK indefinite, nearly singular)
        # Alg. 1 drops the directions its threshold sends to _SAFE_BIG and
        # Eq. 6 keeps: printed
        solver = HypergradConfig(**fields).build()
        eq6 = NystromIHVP(k=10, rho=1e-2, stabilized=False, backend='cuda')
        sk = solver.prepare(make_hvp(problem.inner_loss, res.params,
                                     res.hparams, ib),
                            PyTreeIndexer(res.params), None, indices=idx)
        v = torch.func.grad(problem.outer_loss)(res.params, res.hparams, ob)
        own = _scaled_gap(torch, solver.apply(sk, v), eq6.apply(sk, v))
        lam = torch.linalg.eigvalsh(sk.H_KK)
        well = low_rank_sketch(torch, p, 10, torch.float32, dev, seed=5)
        well.gram_C = solver._be().gram(well.C)
        u = torch.randn(p, generator=torch.Generator(device=dev).manual_seed(6),
                        device=dev)
        scaled = _scaled_gap(torch, solver.apply(well, u), eq6.apply(well, u))
        if not scaled <= 2e-3:
            raise AssertionError(f'kappa=5 vs Eq. 6: {scaled:.3e} of '
                                 '|ref|_inf')
        L, _, factors = _chunk_factors(solver._be(), well, 5, 1e-2)
        paths = [_lib.ctv_path(G.dtype, G.shape[1], G.data_ptr())
                 for G in [G for G, _ in factors] + [L]]
        print(f'distillation {name:<16}: apply vs Eq. 6 on a sketch of '
              f'H = G Gᵀ/32 + I at p={p}: max |err| {scaled:.3e} of '
              f'|ref|_inf (<= 2e-3); on distillation\'s sketch (H_KK '
              f'eigenvalues {lam.min():.3e} .. {lam.max():.3e}): '
              f'{own:.3e} (not gated); kernel B per apply '
              f'{2 * len(factors) + 1} launches (factors, refine: factors '
              f'and L), load paths {paths}', flush=True)
    order = sorted(ranking, key=ranking.get, reverse=True)
    print(f'distillation: Tab. 2 ordering after {n_outer} outer steps '
          f'(distilled accuracy, not gated): '
          + ' > '.join(f'{n} {ranking[n]:.4f}' for n in order), flush=True)
    return {name: launches[name] for name in ('nystrom', 'nystrom kappa=5')}


def plain_f64_backend(torch, dtype):
    """The ``cuda`` backend with each kernel replaced by its plain version
    evaluated in f64 on the same values and rounded to f32 (as phase 3
    holds the kernels at large p): the plain version Alg. 1's kernel path
    is held against. Everything else (the cuBLAS GEMMs that build the
    factors, the bf16 storage of the factors) is the kernel path's own."""
    from repro_torch.core import CudaBackend
    from repro_torch.kernels import ref

    def f64(fn):
        return lambda *a: fn(*[x.double() if torch.is_tensor(x) else x
                               for x in a]).float()

    class PlainF64(CudaBackend):
        gram = staticmethod(f64(ref.nystrom_gram))
        ctv = ctm = staticmethod(f64(ref.woodbury_ctv))

        def combine(self, C, w, v, rho):
            return f64(ref.woodbury_apply)(C, -(rho * rho) * w, v, rho)

        combinem = combine

    return PlainF64(sketch_dtype=dtype)


def blocked_f64_backend(torch, dtype, rows: int = 1 << 24):
    """The ``cuda`` backend with kernels A-C replaced by their plain
    versions (``kernels/ref.py``) evaluated in f64 on the same values, a
    block of ``rows`` rows at a time (sums over blocks in f64), rounded to
    f32: ``plain_f64_backend`` for a sketch of p = 870 M, whose f64 copy
    would be 56 GB. ``combine`` hands the plain apply the kernel's own
    operand w̃ = −ρ²w, as ``CudaBackend.combine`` does; everything else
    (``cv``'s cuBLAS, the bf16 storage) is the kernel path's own."""
    from repro_torch.core import CudaBackend
    from repro_torch.kernels import ref

    def blocks(n):
        return (slice(r, r + rows) for r in range(0, n, rows))

    class BlockedF64(CudaBackend):
        def gram(self, C):
            return sum(ref.nystrom_gram(C[b].double())
                       for b in blocks(C.shape[0])).float()

        def ctv(self, C, v):
            return sum(ref.woodbury_ctv(C[b].double(), v[b].double())
                       for b in blocks(C.shape[0])).float()

        ctm = ctv                            # v a (p, m) block

        def woodbury_apply(self, C, w, v, rho):
            out = torch.empty_like(v, dtype=torch.float32)
            for b in blocks(C.shape[0]):
                out[b] = ref.woodbury_apply(C[b].double(), w.double(),
                                            v[b].double(), rho).float()
            return out

        def combine(self, C, w, v, rho):
            return self.woodbury_apply(C, -(rho * rho) * w, v, rho)

    return BlockedF64(sketch_dtype=dtype)


def low_rank_sketch(torch, p, k, dtype, dev, seed, rank=32):
    """A sketch C = H[:, K] of H = G Gᵀ/r + I (G (p, r) Gaussian from a
    seed), made on the card without H; C stored in ``dtype``."""
    from repro_torch.core import NystromSketch
    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((p, rank), generator=g, device=dev) / rank ** 0.5
    K = torch.randperm(p, generator=g, device=dev)[:k]
    C = G @ G[K].T
    C[K, torch.arange(k, device=dev)] += 1.0
    H_KK = 0.5 * (C[K] + C[K].T)
    del G
    return NystromSketch(C=C.to(dtype), H_KK=H_KK,
                         indices={'leaf': torch.zeros_like(K, dtype=torch.int32),
                                  'dims': K[:, None].int()}, rho=RHO)


@_stepped
def time_alg1(torch, dev) -> dict:
    """Phase 12: Alg. 1 alone at p = 2^24, k = 64, kappa = 16, f32 and bf16
    sketches, vector and m = 32 block forms: through the kernels, against
    the whitened apply on the same sketch, and against the plain version in
    f64 (rel L2 <= 1e-4)."""
    from repro_torch.core import CudaBackend, NystromIHVP
    from repro_torch.core.solvers import _chunk_factors, _whitened_form
    from repro_torch.kernels import _lib
    p, k, kappa = LARGE_P, ALG1_K, ALG1_KAPPA
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        be = CudaBackend(sketch_dtype=dtype)
        sk = low_rank_sketch(torch, p, k, dtype, dev, seed=24)
        sk.gram_C = be.gram(sk.C)
        skw = dataclasses.replace(sk, gram_C=None)
        skw.B, skw.gram_B = _whitened_form(be, sk.C, sk.H_KK)
        chunked = NystromIHVP(k=k, rho=RHO, kappa=kappa, backend=be)
        whitened = NystromIHVP(k=k, rho=RHO, backend=be)
        plain = NystromIHVP(k=k, rho=RHO, kappa=kappa,
                            backend=plain_f64_backend(torch, dtype))
        L, _, factors = _chunk_factors(be, sk, kappa, RHO)
        operands = [G for G, _ in factors] + [L]
        paths = {1: [_lib.ctv_path(G.dtype, G.shape[1], G.data_ptr())
                     for G in operands],
                 M: [_lib.atb_variant(G.dtype, torch.float32, p, G.shape[1],
                                      M, (G.data_ptr(), 0))
                     for G in operands]}
        del L, factors, operands
        g = torch.Generator(device=dev).manual_seed(25)
        for m in (1, M):
            v = torch.randn((p, m) if m > 1 else (p,), generator=g,
                            device=dev)
            fn = 'apply_matrix' if m > 1 else 'apply'
            _lib.reset_launches()
            got = getattr(chunked, fn)(sk, v)
            torch.cuda.synchronize()
            counts = {n: c for n, c in _lib.LAUNCHES.items() if c}
            want = getattr(plain, fn)(sk, v)
            err = float((got - want).double().norm()
                        / want.double().norm())
            del got, want
            if not err <= 1e-4:
                raise AssertionError(f'Alg. 1 {dtype} m={m}: kernel path vs '
                                     f'plain f64 rel L2 {err:.3e}')
            t_chunk = time_ms(torch, lambda: getattr(chunked, fn)(sk, v), 5, 1)
            t_white = time_ms(torch, lambda: getattr(whitened, fn)(skw, v),
                              5, 1)
            key = f'{str(dtype)[6:]} m={m}'
            out[key] = dict(chunked_ms=t_chunk, whitened_ms=t_white,
                            rel_l2_vs_f64=err, launches=counts,
                            paths=paths[m])
            print(f'alg1 p={p} k={k} kappa={kappa} {key:<13}: chunked '
                  f'{t_chunk:.4f} ms, whitened {t_white:.4f} ms, vs plain '
                  f'f64 rel L2 {err:.3e} (<= 1e-4), launches per apply '
                  f"{counts}, {'kernel A variants' if m > 1 else 'kernel B load paths'} "
                  f'(factors, L) {paths[m]}', flush=True)
            del v
        del sk, skw
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 13-15. The iMAML meta path, forward mode, and influence scoring
# ---------------------------------------------------------------------------
IMAML_P = 400 * 64 + 64 + 64 * 64 + 64 + 64 * 5 + 5     # Tab. 3's MLP
IMAML_TASKS, IMAML_STEPS = 8, 3   # benchmarks/tab3_imaml.py's bench_tasks
INFLUENCE_M, INFLUENCE_TOP = 32, 10


def _flat_tree(torch, tree):
    from repro_torch.core import tree_leaves
    return torch.cat([x.reshape(-1).double() for x in tree_leaves(tree)])


def _device_busy(torch, fn):
    """(ms of device time, kernels) of one call of ``fn`` under
    ``torch.profiler``, or None where the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        return None
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)


def _idle(torch, label: str, fn, step_s: float) -> None:
    busy = _device_busy(torch, fn)
    if busy is None:
        print(f'{label}: the profiler recorded no device events; device '
              'time not measured', flush=True)
        return
    ms, n = busy
    print(f'{label}: {n} kernels, {ms:.3f} ms of device time against an '
          f'unprofiled {step_s * 1e3:.3f} ms: device idle '
          f'{100 * (1 - ms / (step_s * 1e3)):.1f}%', flush=True)


def _meta_hypergrads(torch, problem, meta, batch, backend: str,
                     shared: bool, draws):
    """Per-task hypergradients of one meta-step (the ``_solve_meta`` step
    before its mean), at injected column draws: a shared sketch from
    draws[0] on the pooled support sets, or one draw per task."""
    from torch.func import grad, vmap
    from repro_torch.core import HypergradConfig, implicit_root, sgd_solver
    solution = implicit_root(
        sgd_solver(problem.inner_loss, 10, 0.1), problem.inner_loss,
        HypergradConfig(k=10, rho=1e-2, backend=backend))
    (SX, SY), (QX, QY) = batch
    if shared:
        sketch = solution.prepare_state(
            meta, meta, (SX.reshape((-1,) + SX.shape[2:]), SY.reshape(-1)),
            indices=draws[0])
        return vmap(lambda sx, sy, qx, qy: grad(lambda m: problem.outer_loss(
            solution(m, (sx, sy), state=sketch), m, (qx, qy)))(meta))(
            SX, SY, QX, QY)
    idx = {key: torch.stack([d[key] for d in draws])
           for key in ('leaf', 'dims')}
    return vmap(lambda sx, sy, qx, qy, ix: grad(lambda m: problem.outer_loss(
        solution(m, (sx, sy), indices=ix), m, (qx, qy)))(meta))(
        SX, SY, QX, QY, idx)


@_stepped
def run_imaml(torch, dev) -> dict:
    """Phase 13: ``solve(build_imaml(), vmap_tasks=8)`` at Tab. 3's widths,
    Nyström k = 10 on ``backend='cuda'``, with one shared sketch and with a
    sketch per task. Returns the launches per meta-step, by mode."""
    from repro_torch.core import (HypergradConfig, PyTreeIndexer, solve,
                                  tree_leaves, tree_map)
    from repro_torch.kernels import _lib
    from repro_torch.tasks import build_imaml
    problem = build_imaml()
    p = sum(x.numel() for x in tree_leaves(problem.init_params(
        torch.Generator().manual_seed(0))))
    if p != IMAML_P:
        raise AssertionError(f'imaml has p={p}, expected {IMAML_P}')
    config = HypergradConfig(k=10, rho=1e-2, backend='cuda')
    launches, means = {}, {}
    for shared in (True, False):
        label = f'imaml {"shared" if shared else "per-task"}'
        kw = dict(vmap_tasks=IMAML_TASKS, shared_sketch=shared)
        warm = solve(problem, config, n_outer=1, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        res = solve(problem, config, n_outer=IMAML_STEPS, **kw)
        launches[label] = {n: c / IMAML_STEPS for n, c in _lib.LAUNCHES.items()
                           if c}
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        losses = res.history['outer_loss']
        if len(losses) != IMAML_STEPS or not all(map(math.isfinite, losses)) \
                or not _finite(torch, res.hparams):
            raise AssertionError(f'{label}: a loss or the meta-init not '
                                 'finite')
        want = (('nystrom_gram', 'nystrom_cross', 'woodbury_apply_block')
                if shared else
                ('nystrom_gram', 'woodbury_ctv', 'woodbury_apply'))
        if not all(launches[label].get(n) for n in want):
            raise AssertionError(f'{label}: launches {launches[label]}')
        step_s = res.seconds / IMAML_STEPS
        print(f'{label}: {step_s:.4f} s/meta-step of {IMAML_TASKS} tasks x 10 '
              f'inner steps (first-call warm-up {warm.seconds:.4f} s), query '
              f'loss {[round(x, 5) for x in losses]}, hvp_count '
              f'{res.hvp_count}, peak device memory {peak:.1f} MiB, '
              f'launches per meta-step {launches[label]}', flush=True)
        _idle(torch, f'{label}: one profiled meta-step', lambda: solve(
            problem, config, n_outer=1, **kw), step_s)
        # the gate: per-task hypergradients of one meta-step at one draw,
        # the kernels against torch.matmul ('flat')
        meta = res.hparams
        batch = problem.data.task_batch(IMAML_STEPS, IMAML_TASKS)
        gen = torch.Generator().manual_seed(IMAML_STEPS)
        draws = [PyTreeIndexer(meta).sample_indices(gen, 10)
                 for _ in range(1 if shared else IMAML_TASKS)]
        hg = {be: _meta_hypergrads(torch, problem, meta, batch, be, shared,
                                   draws) for be in ('cuda', 'flat')}
        errs = []
        for t in range(IMAML_TASKS):
            a, b = (_flat_tree(torch, tree_map(lambda x: x[t], hg[be]))
                    for be in ('cuda', 'flat'))
            errs.append(float((a - b).norm() / b.norm()))
        if not max(errs) <= 1e-4:
            raise AssertionError(f'{label}: per-task hypergradients cuda vs '
                                 f'flat rel L2 {max(errs):.3e}')
        means[label] = _flat_tree(torch, tree_map(lambda x: x.mean(0),
                                                  hg['cuda']))
        print(f'{label}: per-task hypergradients cuda vs flat, largest rel '
              f'L2 of {IMAML_TASKS} tasks {max(errs):.3e} (<= 1e-4)',
              flush=True)
    a, b = means.values()
    print(f'imaml: cosine of the shared and per-task mean hypergradients '
          f'{float(a @ b / (a.norm() * b.norm())):.6f} (not gated)',
          flush=True)
    return launches


def run_forward_mode(torch, problem, params, hparams, batch, idx) -> dict:
    """Phase 14: ``torch.func.jvp`` of the solution map on ``reweighting``
    (p = 26,122) at the solved state of phase 4, through the kernels against
    ``backend='flat'``, and the jvp/VJP dot test. Returns the launches of
    the kernels' jvp."""
    from torch.func import grad, jvp
    from repro_torch.core import (HypergradConfig, implicit_root, tree_map,
                                  tree_vdot)
    from repro_torch.kernels import _lib
    g = torch.Generator().manual_seed(14)
    phi_dot = tree_map(lambda x: torch.randn(x.shape, generator=g).to(
        x.device), hparams)
    u = tree_map(lambda x: torch.randn(x.shape, generator=g).to(x.device),
                 params)
    maps = {be: implicit_root(lambda phi, b: params, problem.inner_loss,
                              HypergradConfig(k=10, backend=be))
            for be in ('cuda', 'flat')}

    def tangent(be):
        return jvp(lambda h: maps[be](h, batch, indices=idx), (hparams,),
                   (phi_dot,))[1]
    tangent('cuda')                                   # first-call set-up
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    t_cuda = tangent('cuda')
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
    err = float((_flat_tree(torch, t_cuda) - _flat_tree(torch, tangent(
        'flat'))).norm() / _flat_tree(torch, tangent('flat')).norm())
    if not err <= 1e-4:
        raise AssertionError(f'forward mode: jvp cuda vs flat rel L2 '
                             f'{err:.3e}')
    jt_u = grad(lambda h: tree_vdot(u, maps['cuda'](h, batch,
                                                    indices=idx)))(hparams)
    a, b = float(tree_vdot(u, t_cuda)), float(tree_vdot(jt_u, phi_dot))
    dot = abs(a - b) / abs(b)
    if not dot <= 1e-4:
        raise AssertionError(f'forward mode: <u, J v> {a:.6e} vs <J^T u, v> '
                             f'{b:.6e}, rel {dot:.3e}')
    if not (launches.get('woodbury_ctv') and launches.get('woodbury_apply')):
        raise AssertionError(f'forward mode: launches {launches}')
    print(f'forward mode: jvp of the solution map on reweighting p={MAIN_P} '
          f'in {secs * 1e3:.3f} ms, cuda vs flat rel L2 {err:.3e} (<= 1e-4), '
          f'<u, J v> vs <J^T u, v> rel {dot:.3e} (<= 1e-4), launches '
          f'{launches}', flush=True)
    return launches


def _topk_gate(torch, got, want, label: str, *,
               check_self: bool = True) -> None:
    """Influence against ``backend='flat'``: scores within 1e-4 of
    max |score|, top-k indices equal wherever the neighbouring scores
    differ by more than 1e-5 of it, self-influence within 1e-4 (unless
    ``check_self`` is off: the serving tier's answers carry none)."""
    v = want.scores
    scale = float(v.abs().max())
    err = float((got.scores - v).abs().max()) / scale
    gap = torch.full_like(v, math.inf)
    gap[:, 1:] = (v[:, 1:] - v[:, :-1]).abs()
    gap[:, :-1] = torch.minimum(gap[:, :-1], gap[:, 1:].clone())
    apart = gap > 1e-5 * scale
    if check_self and (got.self_scores is None or want.self_scores is None):
        raise AssertionError(f'{label}: self-influence missing')
    self_err = 0.0 if not check_self else float(
        ((got.self_scores - want.self_scores).abs()
         / want.self_scores.abs()).max())
    if not (err <= 1e-4 and self_err <= 1e-4 and torch.equal(
            got.indices[apart], want.indices[apart])):
        raise AssertionError(f'{label}: scores {err:.3e}, self-influence '
                             f'{self_err:.3e}, indices equal '
                             f'{torch.equal(got.indices, want.indices)}')
    selfs = (f'self-influence {self_err:.3e} (<= 1e-4), ' if check_self
             else '')
    print(f'{label}: cuda vs flat scores {err:.3e} of max |score| (<= 1e-4), '
          f'{selfs}top-{v.shape[1]} indices equal at {int(apart.sum())} of '
          f'{apart.numel()} separated positions (all '
          f'{int(torch.equal(got.indices, want.indices))})', flush=True)


@_stepped
def run_influence(torch, dev) -> tuple:
    """Phase 15: ``influence(build_influence())`` at p = 26,122 with m = 32
    queries, parameters trained for the default 200 SGD steps at batch 128.
    Returns the launches of one call, and the problem, the trained
    parameters, the column draw and the ``backend='flat'`` answer, which
    phase 16 serves again."""
    from repro_torch.core import (HypergradConfig, PyTreeIndexer, influence,
                                  influence_curvature_hvp, make_topk_scanner,
                                  train_influence_params, tree_leaves,
                                  tree_map)
    from repro_torch.core.problem import _per_example_grads
    from repro_torch.kernels import _lib
    from repro_torch.tasks import build_influence
    problem = build_influence()
    t0 = time.perf_counter()
    params = train_influence_params(problem)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    p = sum(x.numel() for x in tree_leaves(params))
    if p != MAIN_P:
        raise AssertionError(f'influence has p={p}, expected {MAIN_P}')
    queries = problem.reference['queries'](INFLUENCE_M)
    idx = PyTreeIndexer(params).sample_indices(
        torch.Generator().manual_seed(15), 10)
    kw = dict(params=params, top_k=INFLUENCE_TOP, self_influence=True,
              indices=idx)
    configs = {be: HypergradConfig(k=10, rho=1e-2, backend=be)
               for be in ('cuda', 'flat')}
    first = influence(problem, configs['cuda'], queries, **kw)
    _lib.reset_launches()
    res = influence(problem, configs['cuda'], queries, **kw)
    launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
    if res.hvp_count != 10 or not all(
            launches.get(n) for n in ('nystrom_gram', 'nystrom_cross',
                                      'woodbury_apply_block')):
        raise AssertionError(f'influence: hvp_count {res.hvp_count}, '
                             f'launches {launches}')
    want = influence(problem, configs['flat'], queries, **kw)
    _topk_gate(torch, res, want, 'influence')
    # the sweep alone, against the same solved block
    solver = configs['cuda'].build()
    state = solver.prepare(influence_curvature_hvp(problem, params,
                                                   problem.data, 128),
                           PyTreeIndexer(params), None, indices=idx)
    S = solver.apply_matrix(state, tree_map(
        lambda g: g.movedim(0, -1),
        _per_example_grads(problem.loss, params, queries)))
    scan = make_topk_scanner(problem.loss, params, problem.data, 128)
    scan(S, INFLUENCE_TOP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan(S, INFLUENCE_TOP)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    n = problem.data.n_train
    print(f'influence: p={p}, {n} training examples, m={INFLUENCE_M} '
          f'queries, top {INFLUENCE_TOP}: params trained in {train_s:.3f} s '
          f'(200 SGD steps at batch 128); influence() {res.seconds:.4f} s '
          f'(first call {first.seconds:.4f} s), the scan alone '
          f'{scan_s:.4f} s ({-(-n // 128)} tiles); hvp_count '
          f'{res.hvp_count}; launches {launches}', flush=True)
    _idle(torch, 'influence: one profiled influence() call', lambda: influence(
        problem, configs['cuda'], queries, **kw), res.seconds)
    return launches, problem, params, idx, want


SERVE_CANDIDATES = (1, 2, 4, 8, 16)   # warmup()'s block sizes, 3 reps + 1
SERVE_NAMES = ('nystrom_gram', 'woodbury_ctv', 'woodbury_apply',
               'nystrom_cross', 'woodbury_apply_block')


def _answers(torch, responses):
    """A list of responses in query order → the (m, top) scores and
    indices of an ``InfluenceResult``, for ``_topk_gate``."""
    return types.SimpleNamespace(
        scores=torch.stack([r.scores for r in responses]),
        indices=torch.stack([r.indices for r in responses]),
        self_scores=None)


def _want_launches(got: dict, want: dict, label: str) -> None:
    got = {n: got.get(n, 0) for n in SERVE_NAMES}
    if got != {n: want.get(n, 0) for n in SERVE_NAMES}:
        raise AssertionError(f'{label}: launches {got}, expected {want}')


def _apply_launches(m: int, applies: int, builds: int = 0) -> dict:
    """The launches of ``applies`` applies at width m (whitened, ``refine=1``:
    3 Cᵀv and 2 applies each; the vector kernels at m = 1, the cross and the
    block form above) after ``builds`` sketch builds (a gram each)."""
    if m == 1:
        return {'nystrom_gram': builds, 'woodbury_ctv': 3 * applies,
                'woodbury_apply': 2 * applies}
    return {'nystrom_gram': builds, 'nystrom_cross': 3 * applies,
            'woodbury_apply_block': 2 * applies}


def _add(*counts: dict) -> dict:
    return {n: sum(c.get(n, 0) for c in counts) for n in SERVE_NAMES}


def _serve_stats(label: str, svc, m: int, wall_s: float) -> None:
    s, flush = svc.stats(), svc.flush_ms
    print(f'{label}: {s["answered"]} queries in {s["flushes"]} flushes of '
          f'm={m}, {wall_s:.4f} s wall ({s["answered"] / wall_s:.1f} q/s), '
          f'latency p50 {s["latency_p50_ms"]:.3f} ms p95 '
          f'{s["latency_p95_ms"]:.3f} ms, flush mean '
          f'{sum(flush) / len(flush):.3f} ms (min {min(flush):.3f}, max '
          f'{max(flush):.3f}), build hvps {s["build_hvps"]}, degraded '
          f'flushes {s["degraded_flushes"]}', flush=True)
    if s['degraded_flushes']:
        raise AssertionError(f'{label}: {s["degraded_flushes"]} flushes '
                             'answered by the CG fallback')


@_stepped
def run_serving(torch, smi, problem, params, idx, want) -> dict:
    """Phase 16: the serving tier at the influence task's full width on
    phase 15's problem and parameters: the CLI route, calibrated bursts cold
    and warm, and a restart (checkpoint, spilled sketch, fresh store).
    Returns the launches of each pass."""
    import argparse
    import io
    import tempfile
    from repro_torch.checkpoint import CheckpointManager, params_digest
    from repro_torch.core import (HypergradConfig, PyTreeIndexer, influence,
                                  state_template, tree_flatten_with_path,
                                  tree_leaves, tree_map)
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import _serve_problem
    from repro_torch.serve import InfluenceService, SketchStore, sketch_key
    torch.cuda.reset_peak_memory_stats()
    X, y = problem.reference['queries'](INFLUENCE_M)
    pool = [(X[q], y[q]) for q in range(INFLUENCE_M)]
    config = HypergradConfig(k=10, rho=1e-2, backend='cuda')
    launches = {}

    # (a) the CLI's route, as `--problem influence --serve --queries 32`
    # runs it (train, warmup(), a cold and a warm pass of m = 1 flushes),
    # on the kernels' backend; its query lines are not echoed
    args = argparse.Namespace(solver='nystrom', steps=200,
                              queries=INFLUENCE_M, top_k=INFLUENCE_TOP)
    out = io.StringIO()
    _lib.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        svc, passes = _serve_problem(problem, config, args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        if not re.match(r'\[serve:\w+\] query ', line):
            print(f'serving cli: {line}', flush=True)
    cold_rate = (INFLUENCE_M - 1) / INFLUENCE_M   # one miss, then hits
    got = {phase: (len(r['responses']), r['stats']['build_hvps'],
                   r['stats']['fallback_hvps'],
                   r['stats']['degraded_flushes'], r['hit_rate'])
           for phase, r in passes.items()}
    if got != {'cold': (INFLUENCE_M, 10, 0, 0, cold_rate),
               'warm': (INFLUENCE_M, 0, 0, 0, 1.0)}:
        raise AssertionError(f'serving cli: (answers, build hvps, fallback '
                             f'hvps, degraded flushes, hit rate) by pass '
                             f'{got}')
    # the counters over warmup and both passes: warmup's build and the cold
    # pass's (which bills one build, 10 HVPs) are the two grams, so the
    # warm pass (no build, every lookup a hit) launched none
    launches['cli warmup + cold + warm'] = dict(_lib.LAUNCHES)
    warmup = _add(*(_apply_launches(c, 4) for c in SERVE_CANDIDATES),
                  {'nystrom_gram': 1})   # one build, 1 + 3 applies a width
    _want_launches(_lib.LAUNCHES, _add(
        warmup, _apply_launches(1, INFLUENCE_M, 1),
        _apply_launches(1, INFLUENCE_M)), 'serving cli: warmup and passes')
    flat = influence(problem, HypergradConfig(k=10, rho=1e-2, backend='flat'),
                     (X, y), params=svc.params, top_k=INFLUENCE_TOP)
    for label, part in passes.items():
        _topk_gate(torch, _answers(torch, part['responses']), flat,
                   f'serving cli {label} pass (m=1)', check_self=False)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(svc.params),
                                                 tree_leaves(params)))
    print(f'serving cli: {cli_s:.3f} s in all (200 training steps, warmup, '
          f'2 x {INFLUENCE_M} queries); its trained parameters equal phase '
          f'15\'s bit for bit: {same}; launches of warmup and both passes '
          f'{ {n: _lib.LAUNCHES[n] for n in SERVE_NAMES} }', flush=True)

    # (b) bursts: 32 queries at once, flushed at the calibrated m
    svc = InfluenceService(problem, config, params=params, top_k=INFLUENCE_TOP,
                           indices=idx)
    rates = svc.warmup(SERVE_CANDIDATES)
    m = svc.batcher.block_size
    print('serving burst: warmup() q/s by m: ' + ', '.join(
        f'm={k}: {r:.1f}' for k, r in rates.items()) + f'; calibrated m={m}',
        flush=True)
    if INFLUENCE_M % m:
        raise AssertionError(f'serving burst: calibrated m={m} does not '
                             f'divide {INFLUENCE_M}')

    def burst(svc):
        tickets = [svc.submit(q) for q in pool]
        svc.pump()
        svc.flush()
        return [svc.result(t) for t in tickets]

    answers = {}
    for label in ('cold', 'warm'):
        if label == 'cold':
            svc.store.clear()
        svc.reset_metrics()
        _lib.reset_launches()
        t0 = time.perf_counter()
        answers[label] = burst(svc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f'burst {label} (m={m})'] = dict(_lib.LAUNCHES)
        _want_launches(_lib.LAUNCHES, _apply_launches(
            m, INFLUENCE_M // m, int(label == 'cold')),
            f'serving burst {label}')
        if {r.batched_m for r in answers[label]} != {m}:
            raise AssertionError(f'serving burst {label}: flush widths '
                                 f'{ {r.batched_m for r in answers[label]} }')
        _serve_stats(f'serving burst {label}', svc, m, wall)
        _topk_gate(torch, _answers(torch, answers[label]), want,
                   f'serving burst {label} (m={m})', check_self=False)
    svc.reset_metrics()
    _idle(torch, 'serving burst: one profiled warm burst',
          lambda: burst(svc), wall)

    # (c) restart: parameters through a checkpoint, the sketch through a
    # spill, a fresh store
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, 'ckpt'), async_save=True)
        t0 = time.perf_counter()
        mgr.save(0, params)
        returned = time.perf_counter() - t0
        mgr.wait()
        saved = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = mgr.restore_latest(tree_map(torch.empty_like, params),
                                         device=tree_leaves(params)[0].device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        digests = params_digest(params), params_digest(restored)
        if digests[0] != digests[1]:
            raise AssertionError(f'restart: digest {digests[1]} after the '
                                 f'restore, {digests[0]} before')
        spill = os.path.join(tmp, 'spill')
        kw = dict(params=params, top_k=INFLUENCE_TOP, indices=idx)
        first = SketchStore(spill_dir=spill)
        built = influence(problem, config, (X, y), store=first, **kw)
        warm = influence(problem, config, (X, y), store=first, **kw)
        key = sketch_key(params, config.build())
        t0 = time.perf_counter()
        path = first.save_entry(key)
        spill_s = time.perf_counter() - t0
        restarted = SketchStore(spill_dir=spill)
        _lib.reset_launches()
        disk = influence(problem, config, (X, y), store=restarted,
                         **dict(kw, params=restored))
        torch.cuda.synchronize()
        launches['restart disk hit (m=32)'] = dict(_lib.LAUNCHES)
        if (built.hvp_count, warm.hvp_count, disk.hvp_count) != (10, 0, 0) \
                or (restarted.disk_hits, restarted.misses) != (1, 0) \
                or _lib.LAUNCHES['nystrom_gram']:
            raise AssertionError(
                f'restart: hvp_count {built.hvp_count}, {warm.hvp_count}, '
                f'{disk.hvp_count}; disk hits {restarted.disk_hits}, misses '
                f'{restarted.misses}; launches {_lib.LAUNCHES}')
        if not (torch.equal(disk.scores, warm.scores)
                and torch.equal(disk.indices, warm.indices)):
            raise AssertionError('restart: the disk hit\'s answers differ '
                                 'from the warm call\'s')
        _topk_gate(torch, disk, want, 'restart: influence() from the spill',
                   check_self=False)
        # the restarted service answers the burst at the calibrated m from
        # the same store (a memory hit now), bit for bit the warm burst
        svc = InfluenceService(problem, config, params=restored,
                               store=restarted, top_k=INFLUENCE_TOP,
                               indices=idx, block_size=m)
        _lib.reset_launches()
        again = burst(svc)
        launches[f'restart burst (m={m})'] = dict(_lib.LAUNCHES)
        _want_launches(_lib.LAUNCHES, _apply_launches(m, INFLUENCE_M // m),
                       'restart burst')
        if not all(torch.equal(a.scores, b.scores)
                   and torch.equal(a.indices, b.indices)
                   for a, b in zip(again, answers['warm'])) \
                or svc.degraded_flushes:
            raise AssertionError('restart: the restarted service\'s answers '
                                 'differ from the warm burst\'s')
        print(f'restart: async save returned in {returned * 1e3:.3f} ms, '
              f'landed in {saved * 1e3:.3f} ms; restore on the card '
              f'{restore_s * 1e3:.3f} ms; digest {digests[0]} before and '
              f'after; spill {path.stat().st_size} bytes in '
              f'{spill_s * 1e3:.3f} ms; a fresh store: disk hit, hvp_count '
              f'0, no gram, scores bitwise the warm call\'s (m=32); the '
              f'restarted service at m={m}: bitwise the warm burst\'s',
              flush=True)
        # a bf16 sketch through the disk tier
        bf16 = HypergradConfig(k=10, rho=1e-2, backend='cuda',
                               sketch_dtype='bfloat16')
        solver = bf16.build()
        store = SketchStore(spill_dir=spill)
        made = influence(problem, bf16, (X, y), store=store, **kw)
        key = sketch_key(params, solver)
        store.save_entry(key)
        like = state_template(solver, PyTreeIndexer(params))
        loaded = SketchStore(spill_dir=spill).load_entry(key, like)
        pairs = [(p, a, b) for (p, a), (_, b) in zip(
            tree_flatten_with_path(store._entries[key].state)[0],
            tree_flatten_with_path(loaded)[0])]
        if loaded.C.dtype != torch.bfloat16 or not all(
                torch.equal(a, b) if isinstance(a, torch.Tensor)
                else b == float(torch.tensor(a, dtype=torch.float32))
                for _, a, b in pairs):
            raise AssertionError('restart: the bf16 sketch did not come '
                                 'back bit for bit')
        reread = influence(problem, bf16, (X, y), store=SketchStore(
            spill_dir=spill), **kw)
        if reread.hvp_count or not torch.equal(reread.scores, made.scores):
            raise AssertionError('restart: the bf16 disk hit\'s answers '
                                 'differ')
        gap = float((made.scores - want.scores).abs().max()
                    / want.scores.abs().max())
        print(f'restart: bf16 sketch ({len(pairs)} leaves, C '
              f'{tuple(loaded.C.shape)} bf16) spilled and loaded bit for '
              f'bit; its disk hit answers bitwise as built; bf16 against the '
              f'f32 flat answer {gap:.3e} of max |score| (not gated)',
              flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f'serving: peak device memory {peak:.1f} MiB | {smi}', flush=True)
    return launches


# Outer steps of each graph in phase 17 (b). distill_hpo takes 2 (some 20 s
# of host dispatch a step on the card, 3 on each backend held the script
# near its time limit), reweight_maml 3.
ENGINE_STEPS = {'distill_hpo': 2, 'reweight_maml': 3}
# The bound of phase 17 (b)'s oracle gate: the error of the reference's own
# engine_hypergrad against its engine_hypergrad_reference (rho = 0) on each
# registered graph at the registry defaults, after Engine().solve with
# EngineConfig(n_outer=ENGINE_STEPS[name]), measured on the CPU by
# tests/test_torch_engine_bounds.py (test_chip_bound_is_the_reference_error).
# At distill_hpo's defaults the reference's full-rank sketch and its dense
# oracle part ways (after 3 steps a top gradient of 4.25 against 0.0907),
# so that bound holds the port to little: there the gate that binds is the
# kernels against backend='flat'.
ENGINE_HG_BOUND = {'reweight_maml': 4.36e-4, 'distill_hpo': 3.83}
# Graphs phase 17 (b) leaves out, with the reason printed: the whole run
# with phase 26 would pass 1,000 s on a fast host (876.2-982.1 s without
# it), and distill_hpo's two steps on each backend are the first cut that
# PERF.md names; phase 17 (c) still runs its graph on a streaming sketch.
# Its entries above stay: tests/test_torch_engine_bounds.py measures them,
# and they are the gate again once the graph runs here again.
ENGINE_CUTS = {'distill_hpo': 'phase 26 needs its time inside the 1200 s '
               'limit (2 outer steps on each of two backends, some 20 s of '
               'host dispatch a step); phase 17 (c) still runs this graph'}
# phase 17 (c): a sketch that streams (images p = 2000 x 9 = 18,000, k = 10)
STREAM_KW = dict(n_syn=2000, n_train=1024, n_val=1024, k_student=10,
                 k_images=10, rho=0.1)
STREAM_P = 18000
# a step there is some 15-25 s of host dispatch on an H100: one step a
# backend, unprofiled, keeps (c) near a minute without cutting a width


def _on_backend(graph, backend: str):
    """The graph with every edge's config on ``backend`` (a plain dataclass
    swap: no knob of the graph's own)."""
    return dataclasses.replace(graph, edges=[
        dataclasses.replace(e, config=dataclasses.replace(e.config,
                                                          backend=backend))
        for e in graph.edges])


def _kernels_of_rules(label: str, launches: dict) -> None:
    """Kernels A (gram or cross), B (ctv) and C (vector or block apply)
    must each have launched."""
    groups = {'A': ('nystrom_gram', 'nystrom_cross'), 'B': ('woodbury_ctv',),
              'C': ('woodbury_apply', 'woodbury_apply_block')}
    missing = [k for k, names in groups.items()
               if not any(launches.get(n) for n in names)]
    if missing:
        raise AssertionError(f'{label}: kernel(s) {missing} never launched: '
                             f'{launches}')


@_stepped
def run_second_order(torch, dev) -> dict:
    """Phase 17 (a): jacfwd(grad) and jacrev(grad) through ``implicit_root``
    on the non-quadratic toy, full-rank Nystrom (k = 4, rho = 1e-2) on
    ``backend='cuda'`` against ``backend='flat'`` on the card. Returns the
    kernels' launches."""
    import numpy as np
    from torch.func import grad, jacfwd, jacrev
    from repro_torch.core import HypergradConfig, implicit_root, sgd_solver
    from repro_torch.kernels import _lib
    A = torch.from_numpy(np.random.RandomState(0).randn(4, 4).astype(
        np.float32)).to(dev)

    def inner(x, phi, b):
        return (0.5 * torch.sum(x ** 2)
                + 0.025 * torch.sum(x ** 4) * torch.sum(torch.exp(phi))
                - (A @ phi) @ x)

    def outer(backend):
        solve = implicit_root(
            sgd_solver(inner, 200, 0.2,
                       init=lambda p, b: torch.zeros(4, device=dev)),
            inner, HypergradConfig(solver='nystrom', k=4, rho=1e-2,
                                   backend=backend))
        return lambda p: torch.sum((solve(p, None) - 1.0) ** 2)

    phi = torch.full((4,), 0.1, device=dev)
    got = {}
    for backend in ('flat', 'cuda'):
        f = outer(backend)
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        got[backend] = {'jacfwd(grad)': jacfwd(grad(f))(phi),
                        'jacrev(grad)': jacrev(grad(f))(phi)}
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
    for kind, H in got['cuda'].items():
        want = got['flat'][kind]
        err = float((H - want).norm() / want.norm())
        if not (err <= 1e-4 and bool(torch.isfinite(H).all())):
            raise AssertionError(f'second order {kind}: cuda vs flat rel L2 '
                                 f'{err:.3e}')
        print(f'second order: {kind} of the toy through implicit_root, '
              f'cuda vs flat rel L2 {err:.3e} (<= 1e-4), max |H| '
              f'{float(H.abs().max()):.4f}, asymmetry max |H - H^T| '
              f'{float((H - H.T).abs().max()):.4f}', flush=True)
    _kernels_of_rules('second order', launches)
    print(f'second order: both derivatives through the kernels in '
          f'{secs:.3f} s, launches {launches}', flush=True)
    return launches


@_stepped
def run_engine_graphs(torch, dev) -> dict:
    """Phase 17 (b): the registered graphs not in ``ENGINE_CUTS`` (each cut
    printed with its reason) at the registry defaults, every edge on
    ``backend='cuda'``, ``ENGINE_STEPS[name]`` outer steps, against the
    same on ``backend='flat'``; the bills; ``engine_hypergrad`` against the
    port's dense oracle. Returns the kernels' launches by graph."""
    from repro_torch.core import hypergrad_error
    from repro_torch.engine import (Engine, EngineConfig, engine_edge_bills,
                                    engine_hypergrad,
                                    engine_hypergrad_reference, get_graph)
    from repro_torch.kernels import _lib
    launches = {}
    for name, why in ENGINE_CUTS.items():
        print(f'engine {name}: cut from phase 17 (b): {why}', flush=True)
    for name in sorted(set(ENGINE_STEPS) - set(ENGINE_CUTS)):
        base, steps = get_graph(name), ENGINE_STEPS[name]
        runs = {}
        for backend in ('cuda', 'flat'):
            graph = _on_backend(base, backend)
            torch.cuda.synchronize()
            _lib.reset_launches()
            res = Engine().solve(graph, EngineConfig(n_outer=steps))
            torch.cuda.synchronize()
            if backend == 'cuda':
                launches[name] = {n: c for n, c in _lib.LAUNCHES.items()
                                  if c}
            runs[backend] = (graph, res)
        (g, res), (gf, resf) = runs['cuda'], runs['flat']
        _kernels_of_rules(f'engine {name}', launches[name])
        if not all(map(math.isfinite, res.losses)):
            raise AssertionError(f'engine {name}: losses {res.losses}')
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(res.losses, resf.losses))
        if not loss_err <= 1e-4:
            raise AssertionError(f'engine {name}: top losses cuda '
                                 f'{res.losses} vs flat {resf.losses}')
        bills = engine_edge_bills(g, n_outer=steps)
        if res.edge_hvps != bills:
            raise AssertionError(f'engine {name}: bills {res.edge_hvps} vs '
                                 f'{bills}')
        hg, _ = engine_hypergrad(g, res.values)
        hgf, _ = engine_hypergrad(gf, res.values)
        oracle, _ = engine_hypergrad_reference(g, res.values)
        err = float(hypergrad_error(hg, oracle))
        be_err = float(hypergrad_error(hg, hgf))
        if not (err <= ENGINE_HG_BOUND[name] and be_err <= 1e-4):
            raise AssertionError(
                f'engine {name}: hypergradient vs oracle {err:.3e} (bound '
                f'{ENGINE_HG_BOUND[name]}), cuda vs flat {be_err:.3e}')
        print(f'engine {name}: {res.seconds / steps:.4f} s/outer step '
              f'on cuda ({resf.seconds / steps:.4f} on flat), top '
              f'loss {[round(x, 6) for x in res.losses]}, cuda vs flat '
              f'{loss_err:.3e} (<= 1e-4), bills {res.edge_hvps}, '
              f'hypergradient vs the port\'s oracle {err:.3e} (<= the '
              f"reference's {ENGINE_HG_BOUND[name]}), cuda vs flat "
              f'{be_err:.3e} (<= 1e-4), launches {launches[name]}',
              flush=True)
    return launches


@_stepped
def _kernel_ms(torch, fn):
    """(ms of device time, kernels) of one call of ``fn`` under
    ``torch.profiler`` tracing the card alone, summed from the raw events:
    an outer step of the engine launches some 10⁵ kernels, and the CPU-side
    trace and its parsed events would cost minutes. None where the profiler
    saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA
          and not e.is_user_annotation()]
    return (sum(ns) / 1e6, len(ns)) if ns else None


@_stepped
def run_engine_stream(torch, dev) -> dict:
    """Phase 17 (c): ``distill_hpo(**STREAM_KW)`` (images p = 18,000,
    k = 10): one outer step on ``backend='cuda'`` and one on
    ``backend='flat'``, gated on the top loss and on the top gradient at
    the final values (each run's live sketches). Returns the step's
    launches."""
    from repro_torch.core import hypergrad_error, tree_leaves
    from repro_torch.engine import Engine, EngineConfig, get_graph
    from repro_torch.kernels import _lib
    base = get_graph('distill_hpo', **STREAM_KW)
    p = sum(x.numel() for x in tree_leaves(base.nodes['images'].init(
        torch.Generator())))
    if p != STREAM_P:
        raise AssertionError(f'images has p={p}, expected {STREAM_P}')
    out = {}
    for backend in ('cuda', 'flat'):
        graph = _on_backend(base, backend)
        program = Engine().lower(graph, EngineConfig(n_outer=1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        carry, loss = program.step(program.init(), 0)
        torch.cuda.synchronize()
        out[backend] = (program, carry, float(loss),
                        time.perf_counter() - t0,
                        {n: c for n, c in _lib.LAUNCHES.items() if c},
                        torch.cuda.max_memory_allocated() / 2 ** 20)
    program, carry, loss, step_s, launches, peak = out['cuda']
    loss_f, step_f = out['flat'][2:4]
    _kernels_of_rules('engine stream', launches)
    loss_err = abs(loss - loss_f) / abs(loss_f)
    # the top gradient at the final values against each run's live sketches
    hg, _ = program.top_gradient(carry[0])
    hgf, _ = out['flat'][0].top_gradient(carry[0])
    hg_err = float(hypergrad_error(hg, hgf))
    finite = math.isfinite(loss) and all(
        bool(torch.isfinite(x).all()) for x in tree_leaves(hg))
    if not (finite and loss_err <= 1e-4 and hg_err <= 1e-4):
        raise AssertionError(f'engine stream: loss cuda {loss} vs flat '
                             f'{loss_f}, top gradient {hg_err:.3e}')
    print(f'engine stream: distill_hpo images p={STREAM_P} k=10, one outer '
          f'step {step_s:.4f} s on cuda (flat {step_f:.4f}; first-call '
          f'set-up included), top loss {loss:.6f} (the reference on its '
          f'data: 0.50845), cuda vs flat {loss_err:.3e} (<= 1e-4), top '
          f'gradient {hg_err:.3e} (<= 1e-4), peak device memory '
          f'{peak:.1f} MiB, launches {launches}', flush=True)
    return launches


# the LM trainer (the tenth slice): §5.4's data reweighting on Yi-9B
LM_REDUCED = dict(steps=6, batch=4, seq=32, outer_every=3)
LM_FULL = dict(steps=4, batch=8, seq=128, outer_every=2)
LM_DEPTH = 2          # Yi-9B's 48 layers cut to 2; the widths are whole
# column_chunk, HVP columns per vmapped batch: 2, the reference's
# build_hypergrad_step value. At the CLI's 4 the training run peaked at
# 72.3 GB (67.33 GiB) of device memory, past the 72 GB this phase allows.
LM_CHUNK = 2
LM_K = 8


def _lm_config(backend: str, **kw):
    from repro_torch.core import HypergradConfig
    return HypergradConfig(solver='nystrom', k=LM_K, rho=RHO,
                           column_chunk=LM_CHUNK, backend=backend, **kw)


def _quiet(fn):
    """``fn()`` with its stdout (train_lm's [train]/[outer] lines) kept:
    returns (result, the lines)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue().splitlines()


def _lm_gate(label: str, got, want) -> dict:
    """Two LM runs at the same data and draws: inner losses and outer values
    within 1e-4 relative, hypergradients within 1e-4 relative L2, and each
    outer step's move of the domain logits within 1e-4 relative L2 on the
    domains whose hypergradient carries signal at that step (|g| >
    1e-5·max|g|, ~100 f32 ulps of the largest: the domains of the step's
    inner batch). A domain without
    one gets f32 rounding noise, which adam turns into a step of about
    ±0.64·lr either way: there the logits are only held to 2·lr a step."""
    import numpy as np
    loss = max(abs(a / b - 1) for a, b in zip(got.losses, want.losses))
    val = max(abs(a['val'] / b['val'] - 1)
              for a, b in zip(got.outer, want.outer))
    hg = move = 0.0
    prev = (np.zeros(64), np.zeros(64))
    for n, (a, b) in enumerate(zip(got.outer, want.outer), 1):
        ga, gb = (o['hypergrad'].double().cpu().numpy() for o in (a, b))
        hg = max(hg, float(np.linalg.norm(ga - gb) / np.linalg.norm(gb)))
        live = np.abs(gb) > 1e-5 * np.abs(gb).max()
        la, lb = (o['logits'].double().cpu().numpy() for o in (a, b))
        da, db = la - prev[0], lb - prev[1]
        move = max(move, float(np.linalg.norm(da[live] - db[live])
                               / np.linalg.norm(db[live])))
        if np.abs(la - lb).max() > 2 * 1e-2 * n:
            raise AssertionError(f'{label}: a domain logit moved past the '
                                 'bound of adam\'s steps')
        prev = (la, lb)
    errs = dict(loss=loss, val=val, hypergrad=hg, logit_moves=move)
    if not (len(got.losses) == len(want.losses)
            and len(got.outer) == len(want.outer)
            and max(loss, val, hg, move) <= 1e-4):
        raise AssertionError(f'{label}: cuda vs flat {errs}')
    return errs


@_stepped
def run_lm_reduced(torch, dev) -> dict:
    """Phase 18 (a): ``train_lm`` at ``yi_9b.reduced()`` (f32, the CLI's
    loop: batch 4, seq 32, 6 steps, an outer step every 3, k = 8,
    ``column_chunk=4``) on ``backend='cuda'`` and ``'flat'``, the same
    seeded parameters and draws. Returns the cuda run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import train_lm
    cfg = get_config('yi_9b').reduced()
    runs, launches, secs = {}, {}, {}
    for backend in ('cuda', 'flat'):
        _lib.reset_launches()
        t0 = time.perf_counter()
        runs[backend], lines = _quiet(lambda: train_lm(
            cfg, _lm_config(backend), device=dev, log_every=0,
            **LM_REDUCED))
        secs[backend] = time.perf_counter() - t0
        launches[backend] = {n: c for n, c in _lib.LAUNCHES.items() if c}
    got = launches['cuda']
    if not (got.get('nystrom_gram') and not got.get('nystrom_gram_tc')):
        raise AssertionError(f'lm reduced: gram not on atb_cc: {got}')
    _kernels_of_rules('lm reduced', got)
    errs = _lm_gate('lm reduced', runs['cuda'], runs['flat'])
    run = runs['cuda']
    print(f'lm reduced: train_lm(yi_9b.reduced() f32 p='
          f'{sum(x.numel() for x in _leaves(run.params))}, '
          f"{LM_REDUCED}) cuda {secs['cuda']:.3f} s, flat "
          f"{secs['flat']:.3f} s; inner losses "
          f'{[round(x, 4) for x in run.losses]}, outer values '
          f"{[round(o['val'], 4) for o in run.outer]}, cuda vs flat {errs} "
          f'(<= 1e-4); launches {got}; {lines[-1]}', flush=True)
    return got


def _leaves(tree):
    from repro_torch.core import tree_leaves
    return tree_leaves(tree)


@_stepped
def run_lm_full(torch, dev, smi: str) -> dict:
    """Phase 18 (b): ``train_lm`` on Yi-9B at full width, depth
    ``LM_DEPTH`` (f32 parameters, bf16 compute, remat 'full'), batch 8,
    seq 128, 4 steps with an outer step every 2 (two fresh sketches), k = 8,
    ``column_chunk=LM_CHUNK``, ``backend='cuda'`` with a bf16 sketch. Then
    the last outer step again at its parameters, batches and draw, split
    (HVP columns, prepare, apply with the mixed term), once profiled, and
    against ``backend='flat'``. Returns the training run's launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import PyTreeIndexer, make_hvp
    from repro_torch.core.solvers import (NystromSketch, _build_operand,
                                          _whitened_form)
    from repro_torch.data import TokenStream
    from repro_torch.kernels import _lib, ops
    from repro_torch.core.backend import flatten_vec
    from repro_torch.launch.steps import (domain_losses, lm_hypergrad,
                                          loss_and_grads, to_device)
    from repro_torch.launch.train import train_lm
    cfg = dataclasses.replace(get_config('yi_9b'), n_layers=LM_DEPTH)
    hg_cfg = _lm_config('cuda', sketch_dtype='bfloat16')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    t0 = time.perf_counter()
    run, lines = _quiet(lambda: train_lm(cfg, hg_cfg, device=dev,
                                         log_every=0, **LM_FULL))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated() / 1e9
    p = sum(x.numel() for x in _leaves(run.params))
    if not launches.get('nystrom_gram_tc'):
        raise AssertionError(f'lm full width: gram not on atb_tc: {launches}')
    _kernels_of_rules('lm full width', launches)
    finite = (all(map(math.isfinite, run.losses))
              and all(math.isfinite(o['val']) and
                      bool(torch.isfinite(o['hypergrad']).all())
                      for o in run.outer))
    if not (finite and len(run.outer) == 2):
        raise AssertionError(f'lm full width: not finite: {run.losses} '
                             f"{[o['val'] for o in run.outer]}")
    inner_s = run.step_s
    print(f'lm full width: {smi} | Yi-9B d_model {cfg.d_model}, heads '
          f'{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab '
          f'{cfg.vocab_size}, depth {LM_DEPTH} (of 48), p={p:,} '
          f'(param_count {cfg.param_count():,}), f32 params, bf16 compute, '
          f'remat {cfg.remat}; {LM_FULL}, k={LM_K}, column_chunk={LM_CHUNK},'
          f' cuda, bf16 sketch: {wall:.3f} s in all (init included), s per '
          f'inner step {[round(x, 4) for x in inner_s]}, s per outer step '
          f"{[round(o['build_s'] + o['grad_s'], 4) for o in run.outer]} "
          f"(sketch refresh {[round(o['build_s'], 4) for o in run.outer]}, "
          f"hypergradient {[round(o['grad_s'], 4) for o in run.outer]}), "
          f'inner losses {[round(x, 4) for x in run.losses]}, outer values '
          f"{[round(o['val'], 4) for o in run.outer]}, noisy-domain weight "
          f"{[round(o['noisy_weight'], 4) for o in run.outer]} (uniform "
          f'{2 / 64:.4f} over 64 logits), peak device memory {peak:.2f} GB,'
          f' launches {launches}; {lines[-1]}', flush=True)

    # the last outer step again, split, profiled, and against 'flat'
    i = LM_FULL['steps'] - 1
    params = run.params
    h = {'domain_logits': run.outer[-2]['logits']}
    want = run.outer[-1]['hypergrad']
    run.opt_state = None                      # adam's moments: 7 GB
    torch.cuda.empty_cache()
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=LM_FULL['seq'])
    ib = to_device(stream.batch(i, LM_FULL['batch']), dev)
    ob = to_device(stream.batch(10_000_000 + i, LM_FULL['batch'],
                                clean_only=True), dev)
    inner_loss, outer_loss = domain_losses(cfg)
    solver = hg_cfg.build()
    be = solver._be()
    indexer = PyTreeIndexer(params)
    t0 = time.perf_counter()
    idx = indexer.sample_indices(torch.Generator().manual_seed(i), LM_K)
    draw_s = time.perf_counter() - t0
    # what the O(k) draw replaces above RANDPERM_BELOW: randperm on the
    # host, timed over p/8 (the whole of p would hold the phase a minute)
    t0 = time.perf_counter()
    perm = torch.randperm(p // 8, generator=torch.Generator().manual_seed(i))
    randperm_s = time.perf_counter() - t0
    del perm

    def outer_step(split=None, keep=None):
        hvp = make_hvp(inner_loss, params, h, ib)
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        C, H = _build_operand(be, hvp, indexer, idx, LM_CHUNK)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        H = 0.5 * (H + H.T)
        B, gram_B = _whitened_form(be, C, H)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        sketch = NystromSketch(C=C, H_KK=H, indices=idx, rho=RHO, B=B,
                               gram_B=gram_B)
        del C, B
        val, hg = lm_hypergrad(solver, inner_loss, outer_loss, params, h,
                               ib, ob, state=sketch)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if split is not None:
            split.extend(np.diff(t).tolist())
        if keep is not None:
            keep.append(sketch)
        return val, hg['domain_logits']

    split, kept = [], []
    val, got = outer_step(split, kept)
    step_s = sum(split)
    again = _rel_l2(got, want)
    sk = kept.pop()
    # kernels A-C at this path's shapes, on its own bf16 B (p, k = 8), and
    # seeded v and w, against their plain versions in f64
    ref64 = blocked_f64_backend(torch, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(7)
    v = torch.randn(p, generator=gen, device=dev)
    w = torch.randn(LM_K, generator=gen, device=dev)
    gram64 = ref64.gram(sk.B)
    checks = {'gram (A)': _rel_l2(ops.nystrom_gram(sk.B), gram64)}
    if not checks['gram (A)'] <= 1e-5:
        raise AssertionError(f'lm full width: gram of B vs f64 {checks}')
    want64 = ref64.ctv(sk.B, v)
    checks['ctv (B)'] = _gate('lm ctv (B)', ops.woodbury_ctv(sk.B, v),
                              want64, 1e-5 * float(want64.abs().max()), 1e-5)
    want64 = ref64.woodbury_apply(sk.B, w, v, RHO)
    checks['apply (C)'] = _gate(
        'lm apply (C)', ops.woodbury_apply(sk.B, w, v, RHO), want64,
        1e-5 * float(want64.abs().max()), 1e-5)
    del v, want64
    # the IHVP u = (H_k + ρI)⁻¹ ∇θ g of this step (f32, before the mixed
    # term rounds it to the bf16 compute dtype) through the kernels and
    # through their f64 plain versions; then the hypergradients
    solver64 = dataclasses.replace(solver, backend=ref64)
    sk64 = dataclasses.replace(sk, gram_B=gram64)
    _, g_theta = loss_and_grads(lambda th: outer_loss(th, h, ob), params)
    u = flatten_vec(solver.apply(sk, g_theta))
    u_err = _rel_l2(u, flatten_vec(solver64.apply(sk64, g_theta)))
    del u, g_theta
    _, hg64 = lm_hypergrad(solver64, inner_loss, outer_loss, params, h, ib,
                           ob, state=sk64)
    hg64 = hg64['domain_logits']
    # the same on kernel A's gram: how much of the gap is the k×k system's
    # sensitivity to the gram
    _, hg64a = lm_hypergrad(solver64, inner_loss, outer_loss, params, h, ib,
                            ob, state=sk)
    hg64a = hg64a['domain_logits']
    del sk64
    lam = torch.linalg.eigvalsh(gram64.double())
    flat = _lm_config('flat', sketch_dtype='bfloat16').build()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    C_kp = sk.C.T.contiguous()
    sk.C = None
    B_kp = sk.B.T.contiguous()
    sk.B = None
    gram_f = flat._be().gram(B_kp)
    fsk = NystromSketch(C=C_kp, H_KK=sk.H_KK, indices=idx, rho=RHO, B=B_kp,
                        gram_B=0.5 * (gram_f + gram_f.T))
    del sk, C_kp, B_kp
    _, fhg = lm_hypergrad(flat, inner_loss, outer_loss, params, h, ib, ob,
                          state=fsk)
    del fsk
    fhg = fhg['domain_logits']
    flat_peak = torch.cuda.max_memory_allocated() / 1e9
    errs = {'u cuda vs f64': u_err,
            'cuda vs f64': _rel_l2(got, hg64),
            'cuda vs f64 on A\'s gram': _rel_l2(got, hg64a),
            'flat vs f64': _rel_l2(fhg, hg64),
            'cuda vs flat': _rel_l2(got, fhg),
            'gram flat vs f64': _rel_l2(gram_f, gram64)}
    torch.cuda.empty_cache()
    busy = _kernel_ms(torch, outer_step)
    print(f'lm full width, the last outer step again (step {i + 1}): '
          f'{step_s:.4f} s = HVP columns {split[0]:.4f} + prepare (gram, '
          f'whitening) {split[1]:.4f} + apply with the mixed term '
          f'{split[2]:.4f}; value {float(val):.4f}; hypergradient vs the '
          f'training run {again:.3e}; kernels on its B against f64: gram '
          f'(A) rel L2 {checks["gram (A)"]:.3e} (<= 1e-5), max |err| ctv '
          f'(B) {checks["ctv (B)"]:.3e}, apply (C) {checks["apply (C)"]:.3e}'
          f' (rtol 1e-5, atol 1e-5 |ref|_inf); on the same bf16 C and B, '
          f'relative L2 of the IHVP u (gate <= 1e-4) and of the '
          f'hypergradients: '
          + ', '.join(f'{k} {e:.3e}' for k, e in errs.items())
          + f'; eigenvalues of BᵀB {float(lam.min()):.4e} .. '
          f'{float(lam.max()):.4e} against rho {RHO}; flat peak '
          f'{flat_peak:.2f} GB; the draw {draw_s * 1e3:.3f} ms on the host '
          f'(randperm(p/8) alone takes {randperm_s:.3f} s: '
          f'{100 * randperm_s / step_s:.1f}% of the step)', flush=True)
    if not (again <= 1e-4 and u_err <= 1e-4):
        raise AssertionError(f'lm full width: {errs}, vs the training run '
                             f'{again:.3e}')
    if busy is None:
        print('lm full width: the profiler recorded no device events; '
              'device time not measured', flush=True)
    else:
        ms, n = busy
        print(f'lm full width: the profiled outer step ran {n} kernels, '
              f'{ms:.3f} ms of device time, against an unprofiled '
              f'{step_s * 1e3:.3f} ms step: device idle '
              f'{100 * (1 - ms / (step_s * 1e3)):.1f}%', flush=True)
    return launches


# ---------------------------------------------------------------------------
# 19-21. The model zoo's decode path, the MoE family, and the last four
# families (Mamba/Jamba, RWKV-6, encoder-decoder, M-RoPE)
# ---------------------------------------------------------------------------
DECODE_B, DECODE_SMAX, DECODE_PROMPT, DECODE_NEW = 32, 8192, 16, 64
CONSIST_B, CONSIST_T, CONSIST_MAX = 4, 32, 64
PHI_DEPTH, PHI_SMAX = 16, 4096
MAVERICK_LAYERS, MAVERICK_S, MAVERICK_STEPS = 2, 4096, 16
DECODE_WARM = 4       # decode steps left out of the median
GEMM_KEYS = ('gemm', 'nvjet', 'xmma', 'cutlass', 'gemv')
FAMILY_SMAX = 4096    # phase 21's decode cache, and Seamless's cross_len
JAMBA_DEPTH = 8       # one period: 7 Mamba + 1 attention, 4 MoE FFNs
JAMBA_B = 2           # its prefill's batch: decay, drive 4.3 GB each
RWKV_REQUESTS = 1     # its prefill is 491k launches of the time loop
LONG_SMAX, LONG_PROMPT, LONG_NEW = 524288, 4, 12     # long_500k, B = 1
#: the recurrent prefills are profiled at this S (the time loop's
#: launches grow with S; the profiler records each). Cut from 1024 and 256
#: for the whole script's time: their traces took 15.8 and 19.5 s (chip
#: run, NVIDIA H100 80GB HBM3, 700.00 W); at either S attention takes the
#: plain path (S <= attn_chunk), and the loops launch per token as before
TRACE_S = {'jamba': 256, 'rwkv': 64}
TRACE_CUT = {'jamba': 1024, 'rwkv': 256}   # S before the cut
CONSIST_ENC = 64      # encoder frames of Seamless's decode-vs-forward


def _sum(*counts: dict) -> dict:
    """Launch counts added key by key."""
    return {n: sum(c.get(n, 0) for c in counts)
            for n in {n for c in counts for n in c}}


@contextlib.contextmanager
def _ranges(torch, *targets):
    """While the block runs, each call of ``module.attr`` runs under a
    ``torch.profiler`` range ``label``: targets are (module, attr, label)."""
    saved = [(module, attr, getattr(module, attr))
             for module, attr, _ in targets]
    for (module, attr, label), (_, _, fn) in zip(targets, saved):
        def ranged(*args, _fn=fn, _label=label, **kwargs):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kwargs)
        setattr(module, attr, ranged)
    try:
        yield
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def _model_ranges(torch):
    """Profiler ranges around the decode attention's core, the MoE
    layer's parts, the recurrent time loops and cross-attention, for
    :func:`_family`."""
    from repro_torch.models import attention, moe, rwkv, ssm
    return _ranges(torch, (attention, '_decode_core', 'decode.attention'),
                   (attention, 'cross_attention', 'cross.attention'),
                   (moe, '_moe_local', 'moe.layer'),
                   (moe, '_grouped', 'moe.experts'),
                   (ssm, '_scan', 'scan.loop'), (rwkv, '_wkv', 'scan.loop'))


def _family(name: str, ops: set) -> str:
    """The family of a kernel, from its name and the names of the op that
    launched it and that op's enclosing ops and ranges."""
    gemm = any(key in name for key in GEMM_KEYS)
    if 'flash_fwd' in name:
        return 'flash (kernel E)'
    if 'rmsnorm_rows' in name:
        return 'RMSNorm (kernel D)'
    if 'scan.loop' in ops:
        return 'time loops (Mamba scan, RWKV wkv steps)'
    if 'cross.attention' in ops:
        return 'cross-attention (plain: q/o GEMMs, chunked softmax)'
    if 'moe.experts' in ops:
        return 'expert GEMMs'
    if 'moe.layer' in ops:
        return ('router and shared-expert GEMMs' if gemm else
                'routing and combine (softmax, top-k, argsort, gathers, '
                'counts, act*g, gates)')
    if 'decode.attention' in ops:
        return 'decode attention (q.k, mask, softmax, p.v)'
    if gemm:
        return 'GEMMs (attention projections, dense FFN, unembedding)'
    return 'elementwise' if 'elementwise' in name else 'rest'


def _depth(e) -> int:
    """How many ops enclose the profiler event ``e``."""
    n, parent = 0, e.cpu_parent
    while parent is not None:
        n, parent = n + 1, parent.cpu_parent
    return n


def _claimed(events, kernels):
    """Each kernel of the device trace once, as (the op that launched it,
    its name, its µs): the innermost host op that lists it (an outer op,
    or an op's legacy total of device time, may list it again), or None
    for a kernel no op claims (D and E, launched from ctypes)."""
    from torch.autograd import DeviceType
    unclaimed = collections.Counter(
        (k.name, k.time_range.elapsed_us()) for k in kernels)
    launchers = [e for e in events
                 if e.device_type == DeviceType.CPU and e.kernels]
    for e in sorted(launchers, key=_depth, reverse=True):
        for k in e.kernels:
            if unclaimed[(k.name, k.duration)] > 0:
                unclaimed[(k.name, k.duration)] -= 1
                yield e, k.name, k.duration
    for (name, us), n in unclaimed.items():
        for _ in range(n):
            yield None, name, us


@_stepped
def _by_family(torch, fn, label: str, step_ms: float):
    """``fn`` once under ``torch.profiler`` with :func:`_model_ranges`:
    device time by :func:`_family`, the kernel count and the device's idle
    share against the unprofiled ``step_ms``. A kernel's family comes from
    its name and from the op that launched it (:func:`_claimed`) with that
    op's enclosing ops and ranges; kernels no op claims go by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with _model_ranges(torch), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        print(f'{label}: the profiler recorded no device events; device '
              'time not measured', flush=True)
        return
    split = collections.Counter()
    for e, name, us in _claimed(events, kernels):
        ops = set()
        while e is not None:
            ops.add(e.name)
            e = e.cpu_parent
        split[_family(name.lower(), ops)] += us / 1e3
    busy = sum(split.values())
    for fam, ms in sorted(split.items(), key=lambda kv: -kv[1]):
        print(f'{label}: {fam:<58} {ms:10.3f} ms device '
              f'({100 * ms / busy:5.1f}%)', flush=True)
    print(f'{label}: {len(kernels)} kernels, {busy:.3f} ms of device time; '
          f'unprofiled {step_ms:.3f} ms: device idle '
          f'{100 * (1 - busy / step_ms):.1f}%', flush=True)


@contextlib.contextmanager
def _routes(torch, log: list):
    """While the block runs, each MoE layer's routing goes to ``log`` on
    the host: (experts chosen, sorted (N, k); the margin between the k-th
    and the (k+1)-th router probability (N,))."""
    from repro_torch.models import moe
    route = moe.route

    def logged(params, xt, cfg):
        out = route(params, xt, cfg)
        top = torch.topk(out[0], cfg.top_k + 1, dim=-1).values
        log.append((torch.sort(out[2], dim=-1).values.cpu(),
                    (top[:, -2] - top[:, -1]).cpu()))
        return out

    moe.route = logged
    try:
        yield log
    finally:
        moe.route = route


@contextlib.contextmanager
def _causal_tally(counts: dict):
    """While the block runs, each call of kernel E's wrapper adds one to
    ``counts['causal']`` or ``counts['non-causal']`` (which self-attention
    it served); the launches themselves are the wrapper's to count."""
    from repro_torch.kernels import ops
    flash = ops.flash_attention

    def tallied(*args, causal=True, **kwargs):
        key = 'causal' if causal else 'non-causal'
        counts[key] = counts.get(key, 0) + 1
        return flash(*args, causal=causal, **kwargs)

    ops.flash_attention = tallied
    try:
        yield counts
    finally:
        ops.flash_attention = flash


def _flips(torch, want: list, got: list, B: int, S: int):
    """(B, S) bool: the token chose other experts in some MoE layer in
    ``got`` than in ``want`` (logs of :func:`_routes`; ``got`` may hold one
    entry a layer for each of S decode steps), and the margins in ``want``
    at those flips."""
    L = len(want)
    flipped = torch.zeros((B, S), dtype=torch.bool)
    margins = []
    for layer, (experts, margin) in enumerate(want):
        experts, margin = experts.view(B, S, -1), margin.view(B, S)
        if len(got) == L:
            other = got[layer][0].view(B, S, -1)
        else:
            other = torch.stack([got[t * L + layer][0].view(B, -1)
                                 for t in range(S)], dim=1)
        flip = (other != experts).any(-1)
        flipped |= flip
        margins += margin[flip].tolist()
    return flipped, margins


def _vision_ids(torch, B: int, S: int):
    """(B, 3, S) int32 (t, h, w) ids as Qwen2-VL lays out an image among
    text: 64 text tokens, a patch grid of 64 columns and up to 48 rows
    (one t, its own h and w), then text again (at least 64 tokens), each
    run starting where the last one's largest id ended; at S = 4096 a
    48 × 64 grid (runs and grid shrink to S / 4 at short S)."""
    ids = torch.zeros((B, 3, S), dtype=torch.int32)
    text = cols = min(64, S // 4)
    rows = min(48, (S - 2 * text) // cols)
    grid = rows * cols
    ids[:, :, :text] = torch.arange(text, dtype=torch.int32)
    ids[:, 0, text:text + grid] = text
    ids[:, 1, text:text + grid] = text + torch.arange(
        rows, dtype=torch.int32).repeat_interleave(cols)
    ids[:, 2, text:text + grid] = text + torch.arange(
        cols, dtype=torch.int32).repeat(rows)
    after = S - text - grid
    ids[:, :, text + grid:] = text + max(rows, cols) + torch.arange(
        after, dtype=torch.int32)
    return ids


def _batch(torch, cfg, B: int, S: int, seed: int, enc_len: int = 0,
           vision: bool = False) -> dict:
    """A serving batch for ``cfg``: (B, S) random tokens on the host, or
    (B, S, d) bf16 embeddings drawn on the card where the arch takes
    embeddings; with ``vision`` (M-RoPE) non-degenerate (t, h, w) ids;
    with ``enc_len`` an encoder-decoder's (B, enc_len, d) bf16 frames."""
    if cfg.embed_inputs or cfg.is_encdec:
        batch = {'inputs': torch.randint(
            0, cfg.vocab_size, (B, S),
            generator=torch.Generator().manual_seed(seed))}
    else:
        batch = {'inputs': torch.randn(
            (B, S, cfg.d_model), dtype=torch.bfloat16, device='cuda',
            generator=torch.Generator('cuda').manual_seed(seed))}
    if vision and cfg.mrope:
        batch['positions'] = _vision_ids(torch, B, S)
    if enc_len and cfg.is_encdec:
        batch['enc_inputs'] = torch.randn(
            (B, enc_len, cfg.d_model), dtype=torch.bfloat16, device='cuda',
            generator=torch.Generator('cuda').manual_seed(seed + 1))
    return batch


def _attention_calls(cfg, S: int, T: int = 0) -> dict:
    """Kernel E's calls in one prefill of ``cfg`` (with ``use_pallas``)
    over S positions (and T encoder frames) by mask, as
    :func:`_causal_tally` counts them: a causal call for every decoder
    self-attention past ``attn_chunk``, a non-causal one for every encoder
    layer past it; masks with no call left out."""
    attn = sum(m == 'attn' for m, _ in cfg.layer_kinds()) * cfg.n_blocks
    calls = {'causal': attn if S > cfg.attn_chunk else 0,
             'non-causal': (cfg.n_enc_layers if cfg.is_encdec
                            and T > cfg.attn_chunk else 0)}
    return {k: n for k, n in calls.items() if n}


def _kernel_counts(cfg, S: int, T: int = 0) -> dict:
    """The launches of kernels D and E that one prefill of ``cfg`` (with
    ``use_pallas``) over S positions (and T encoder frames) makes, as the
    reference's ``use_pallas`` places them: D on ln1 and ln2 of every
    non-RWKV slot and encoder layer, E on every self-attention past
    ``attn_chunk`` (:func:`_attention_calls`), on the tensor cores in bf16
    at hd 64 or 128."""
    d = 2 * sum(m != 'rwkv' for m, _ in cfg.layer_kinds()) * cfg.n_blocks
    if cfg.is_encdec:
        d += 2 * cfg.n_enc_layers
    e = sum(_attention_calls(cfg, S, T).values())
    tc = e if (cfg.compute_dtype == 'bfloat16'
               and cfg.head_dim in (64, 128)) else 0
    return {'rmsnorm': d, 'flash_attention': e, 'flash_attention_tc': tc}


def _decode_params(cfg, params: dict) -> dict:
    """``params`` whose ``forward`` unembeds through the table decode uses:
    an encoder-decoder's decode reads ``embed`` (the reference's choice),
    its forward ``unembed``."""
    return dict(params, unembed=params['embed']) if cfg.is_encdec else params


def _filled_cache(torch, cfg, params, B: int, max_len: int,
                  enc_inputs=None) -> dict:
    """An empty decode cache; an encoder-decoder's cross cache filled from
    ``encode(enc_inputs)``."""
    from repro_torch.models import transformer
    cache = transformer.init_cache(cfg, B, max_len)
    if cfg.is_encdec:
        with torch.inference_mode():
            cache = transformer.fill_cross_cache(
                cfg, params, cache,
                transformer.encode(cfg, params, enc_inputs))
    return cache


def _decode_vs_forward(torch, cfg, params, B: int, T: int, max_len: int):
    """B prompts of T random inputs (tokens, or embeddings where the arch
    takes them; an encoder-decoder's against ``CONSIST_ENC`` frames) fed
    one at a time through ``build_serve_step`` from an empty cache, and
    ``forward`` (the plain path, text positions) on the same inputs, an
    encoder-decoder's through decode's table. Returns the worst relative
    L2 of the logits at a position over the sequences with no routing
    flip at or before it (a flip changes its token's output and, through
    attention or the recurrent state, the tokens after it), the tokens
    compared, the flips and their margins, the launches during decode,
    and the forward's own worst gap at a position between its first row
    run alone and in the batch of B."""
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import transformer
    plain = dataclasses.replace(cfg, use_pallas=False)
    batch = _batch(torch, plain, B, T, 11, enc_len=CONSIST_ENC)
    inputs, enc = batch['inputs'], batch.get('enc_inputs')
    fwd_params = _decode_params(plain, params)
    dev = params['final_norm']['scale'].device
    fwd_log, dec_log = [], []
    V = cfg.vocab_size       # past it the pad logits (finfo.min) overflow L2
    with torch.inference_mode():
        with _routes(torch, fwd_log):
            want, _ = transformer.forward(plain, fwd_params, inputs.to(dev),
                                          enc_inputs=enc)
        alone, _ = transformer.forward(
            plain, fwd_params, inputs[:1].to(dev),
            enc_inputs=None if enc is None else enc[:1])
    want, alone = want[..., :V], alone[..., :V]
    floor = max(_rel_l2(alone[0, t], want[0, t]) for t in range(T))
    step = build_serve_step(plain)
    cache = _filled_cache(torch, plain, params, B, max_len, enc)
    _lib.reset_launches()
    got = []
    with _routes(torch, dec_log):
        for t in range(T):
            logits, cache = step(params, inputs[:, t:t + 1], cache)
            got.append(logits)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    if any(launches.values()) or int(cache['pos']) != T:
        raise AssertionError(f'decode: pos {int(cache["pos"])}, launches '
                             f'{launches}')
    got = torch.cat(got, 1)[..., :V]
    flipped, margins = (_flips(torch, fwd_log, dec_log, B, T) if fwd_log
                        else (torch.zeros((B, T), dtype=torch.bool), []))
    keep = ~torch.cumsum(flipped.int(), dim=1).bool()
    worst, compared = 0.0, 0
    for t in range(T):
        rows = keep[:, t].nonzero().flatten().to(dev)
        if len(rows):
            err = _rel_l2(got[rows, t], want[rows, t])
            if not math.isfinite(err):
                raise AssertionError(f'decode vs forward at {t}: {err}')
            worst = max(worst, err)
            compared += len(rows)
    return worst, compared, int(flipped.sum()), margins, launches, floor


def _cut(cfg, params: dict, depth: int):
    """``cfg`` and ``params`` cut to ``depth`` decoder layers (and as many
    encoder layers, at most)."""
    enc = min(cfg.n_enc_layers, depth)
    prm = dict(params, blocks=params['blocks'][:depth // cfg.block_period])
    if cfg.is_encdec:
        prm['enc_blocks'] = params['enc_blocks'][:enc]
    return dataclasses.replace(cfg, n_layers=depth, n_enc_layers=enc), prm


@_stepped
def _consistency(torch, cfg, params, label: str, B: int, T: int,
                 max_len: int, smi: str) -> dict:
    """Decode against ``forward`` (:func:`_decode_vs_forward`), three ways:
    f32 compute (the bf16 weights widened) at the model's depth, gated at
    1e-4 at every position, where a fault of the decode path cannot hide
    under rounding; bf16 at depth ``PARITY_LAYERS`` (a whole number of
    blocks, at least one; the model's depth if less), gated at 2e-2, phase
    10's bf16 gate and depth; and bf16 at the model's depth, printed beside
    the forward's own gap between a row run alone and in the batch,
    ungated: at Yi-9B's 48 layers that gap is as large as decode's (bf16
    roundings that differ with the GEMMs' shapes, grown over the depth).
    RWKV-6 is gated in f32 at the cut depth and printed at its own: where
    a head's t = 0 output nearly cancels, its group norm scales f32
    rounding up to full size and the layers after it amplify it, the
    reference's model too (``tests/test_torch_rwkv.py::
    test_f32_decode_leaves_the_forward_with_depth_in_the_reference_too``).
    At least B tokens must be compared. Returns the launches (kernels A–E
    must not launch)."""
    period = cfg.block_period
    depth = min(cfg.n_layers, max(period, PARITY_LAYERS // period * period))
    f32 = dataclasses.replace(cfg, compute_dtype='float32')
    if any(m == 'rwkv' for m, _ in cfg.layer_kinds()):
        runs = [('f32 compute', *_cut(f32, params, depth), 1e-4),
                ('f32 compute', f32, params, None)]
    else:
        runs = [('f32 compute', f32, params, 1e-4)]
    runs.append(('bf16', *_cut(cfg, params, depth), 2e-2))
    if depth < cfg.n_layers:
        runs.append(('bf16', cfg, params, None))
    launches = {}
    for tag, c, prm, tol in runs:
        worst, compared, flips, margins, runs_launches, floor = \
            _decode_vs_forward(torch, c, prm, B, T, max_len)
        launches = _sum(launches, runs_launches)
        if tol is not None and (compared < B or not worst <= tol):
            raise AssertionError(
                f'{label} decode vs forward, {tag}, depth {c.n_layers}: '
                f'worst rel L2 {worst:.3e} (tol {tol}) over {compared} '
                'tokens')
        gate = 'ungated' if tol is None else f'<= {tol}'
        note = (f'; {flips} routing flips (margins '
                f'{", ".join(f"{m:.2e}" for m in margins[:8])}), '
                f'{B * T - compared} of {B * T} tokens left out'
                if c.n_experts else '')
        print(f'{label} decode vs forward (plain path), {tag}, depth '
              f'{c.n_layers}: B={B} T={T}, worst rel L2 at a position '
              f'{worst:.3e} ({gate}) over {compared} tokens{note}; the '
              f"forward's own gap, one row alone vs in the batch: "
              f'{floor:.3e}; no kernel launched ({smi})', flush=True)
    return launches


@_stepped
def _serve_decode(torch, cfg, params, label: str, B: int, smax: int,
                  prompt: int, new: int, smi: str) -> dict:
    """Serving: a ``prompt``-input prompt fed through ``build_serve_step``,
    then ``new`` more, B sequences in an ``smax``-entry cache: greedy
    tokens, or for an arch that takes embeddings seeded (B, 1, d) bf16
    embeddings a step (a greedy token cannot feed it); an encoder-decoder
    decodes against ``smax`` encoded frames (encoded and written by
    ``fill_cross_cache`` before the first step). ms per step (median after
    ``DECODE_WARM``), tokens/s, peak memory, one profiled step by family.
    Kernels A–E must not launch. Returns the launches."""
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import build_serve_step
    dev = params['final_norm']['scale'].device
    step = build_serve_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch = _batch(torch, cfg, B, prompt + new, 12, enc_len=smax)
    t0 = time.perf_counter()
    cache = _filled_cache(torch, cfg, params, B, smax,
                          batch.get('enc_inputs'))
    torch.cuda.synchronize()
    fill = (f'; encode and fill_cross_cache {time.perf_counter() - t0:.3f} s'
            if cfg.is_encdec else '')
    batch.pop('enc_inputs', None)
    state_gb = sum(x.numel() * x.element_size()
                   for part in ('slots', 'cross')
                   for slot in cache.get(part, {}).values()
                   for x in (slot.values() if isinstance(slot, dict)
                             else [slot])) / 1e9
    inputs = batch['inputs'].to(dev)
    greedy = cfg.embed_inputs or cfg.is_encdec
    _lib.reset_launches()
    secs, out = [], []
    for t in range(prompt + new):
        x = (inputs[:, t:t + 1] if t < prompt or not greedy else out[-1])
        t0 = time.perf_counter()
        logits, cache = step(params, x, cache)
        nxt = logits.argmax(-1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if t >= prompt - 1:
            out.append(nxt)
    launches = dict(_lib.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f'{label} decode launched kernels: {launches}')
    if int(cache['pos']) != prompt + new or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f'{label} decode: pos {int(cache["pos"])}, '
                             'logits not finite')
    ms = sorted(secs[DECODE_WARM:])[len(secs[DECODE_WARM:]) // 2] * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    feed = ('greedy tokens' if greedy else
            'seeded bf16 embeddings (the arch takes embeddings)')
    print(f'{label} decode serving: B={B}, Smax={smax} ({state_gb:.2f} GB '
          f'cache), {prompt} prompt + {new} {feed}: {ms:.3f} ms per step '
          f'(median of {len(secs) - DECODE_WARM}, first '
          f'{secs[0] * 1e3:.3f} ms, min {min(secs) * 1e3:.3f}, max '
          f'{max(secs[DECODE_WARM:]) * 1e3:.3f}), {B / ms * 1e3:.1f} tokens/s, '
          f'peak memory {peak:.2f} GB{fill}; no kernel launched; argmax of '
          f'sequence 0 {torch.cat(out, 1)[0, :12].tolist()} ({smi})',
          flush=True)
    x = out[-1] if greedy else inputs[:, -1:]
    _by_family(torch, lambda: step(params, x, cache),
               f'{label} decode trace', ms)
    return launches


def _model_params(torch, cfg, seed: int):
    """Random bf16 serving weights for ``cfg`` on the card from a seeded
    generator, drawn weight by weight (expert by expert) in f32."""
    from repro_torch.core import tree_leaves
    from repro_torch.launch.steps import serve_params
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    params = serve_params(build_model(dataclasses.replace(
        cfg, param_dtype='bfloat16')).init(
            torch.Generator('cuda').manual_seed(seed)))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    enc = f' + {cfg.n_enc_layers} encoder' if cfg.is_encdec else ''
    print(f'{cfg.name}: {cfg.n_layers}{enc} layers {cfg.layer_kinds()} '
          f'd={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} '
          f'hd={cfg.head_dim} d_ff={cfg.d_ff} experts={cfg.n_experts} '
          f'top-{cfg.top_k} vocab={cfg.vocab_size}: '
          f'{n / 1e9:.3f} B bf16 parameters '
          f'({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated) drawn in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    return params


@_stepped
def run_decode_yi(torch, dev, smi: str) -> dict:
    """Phase 19: Yi-9B decode at full width and depth, bf16: consistency
    with ``forward``, then serving at B = 32 with an 8192-entry cache.
    Returns the decode launches (all 0)."""
    from repro_torch.configs import get_config
    del dev
    cfg = get_config('yi_9b')
    params = _model_params(torch, cfg, 0)     # phase 8's weights
    launches = _consistency(torch, cfg, params, 'yi-9b', CONSIST_B,
                            CONSIST_T, CONSIST_MAX, smi)
    launches = _sum(launches, _serve_decode(
        torch, cfg, params, 'yi-9b', DECODE_B, DECODE_SMAX, DECODE_PROMPT,
        DECODE_NEW, smi))
    del params
    torch.cuda.empty_cache()
    return launches


@_stepped
def _kernel_parity(torch, cfg, label: str, params) -> None:
    """The kernel path against the plain path at full width on the bf16
    serving weights ``params``, cut to depth ``PARITY_LAYERS`` (a whole
    number of blocks, at least one; encoder layers cut alike), B =
    ``PARITY_B``, S = ``PARITY_S`` (and as many encoder frames; Qwen2-VL's
    image (t, h, w) ids), on the last position's logits: f32 compute on
    the widened weights ≤ 1e-4, bf16 ≤ 2e-2 (phase 10's gates), over the
    sequences whose last token chose the same experts on both paths in
    every MoE layer; the routing flips anywhere in the sequences are
    counted. The launches of D and E must be :func:`_kernel_counts`', and
    E's calls by mask :func:`_attention_calls`'."""
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import build_prefill_step
    period = cfg.block_period
    cfg, params = _cut(cfg, params, min(cfg.n_layers, max(
        period, PARITY_LAYERS // period * period)))
    batch = _batch(torch, cfg, PARITY_B, PARITY_S, 3, enc_len=PARITY_S,
                   vision=True)
    for tag, dtype, tol in (('f32', 'float32', 1e-4),
                            ('bf16 serving', 'bfloat16', 2e-2)):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        logs, calls = ([], []), {}
        _lib.reset_launches()
        with _routes(torch, logs[0]), _causal_tally(calls):
            kern = build_prefill_step(dataclasses.replace(
                c, use_pallas=True))(params, batch)
        counts = {k: _lib.LAUNCHES[k] for k in (
            'rmsnorm', 'flash_attention', 'flash_attention_tc')}
        want = _kernel_counts(dataclasses.replace(c, use_pallas=True),
                              PARITY_S, PARITY_S)
        want_calls = _attention_calls(c, PARITY_S, PARITY_S)
        with _routes(torch, logs[1]):
            plain = build_prefill_step(dataclasses.replace(
                c, use_pallas=False))(params, batch)
        flipped, margins = (_flips(torch, logs[1], logs[0], PARITY_B,
                                   PARITY_S) if logs[1] else
                            (torch.zeros((PARITY_B, PARITY_S),
                                         dtype=torch.bool), []))
        rows = (~flipped[:, -1]).nonzero().flatten().to(kern.device)
        V = cfg.vocab_size   # past it the pad logits (finfo.min) overflow L2
        err = (_rel_l2(kern[rows, :V], plain[rows, :V]) if len(rows)
               else math.nan)
        if not err <= tol or counts != want or calls != want_calls:
            raise AssertionError(f'{label} parity {tag}: rel L2 {err:.3e} '
                                 f'(tol {tol}) over {len(rows)} sequences, '
                                 f'launches {counts}, want {want}; kernel E '
                                 f'calls by mask {calls}, want {want_calls}')
        enc = (f' + {c.n_enc_layers} encoder layers over {PARITY_S} frames'
               if c.is_encdec else '')
        print(f'{label} parity {tag}: full width, depth cut to '
              f'{c.n_layers}{enc}, B={PARITY_B} S={PARITY_S}: kernel path '
              f'vs plain path rel L2 {err:.3e} (<= {tol}) over {len(rows)} '
              f'of {PARITY_B} last positions, launches {counts}, kernel E '
              f'calls by mask {calls}; routing flips between the paths: '
              f'{int(flipped.sum())} tokens of {PARITY_B * PARITY_S} '
              f'(margins {", ".join(f"{m:.2e}" for m in margins[:8])})',
              flush=True)
        del kern, plain
    torch.cuda.empty_cache()


@_stepped
def _prefill(torch, cfg, params, label: str, B: int, S: int,
             requests: int, smi: str, trace: bool = True,
             trace_s: int | None = None) -> dict:
    """``requests`` prefills of B × S random inputs (an arch's tokens or
    embeddings; Qwen2-VL's with an image's (t, h, w) ids; an
    encoder-decoder's with S encoder frames) through
    ``build_prefill_step`` after a warm-up, each launching kernels D and E
    exactly as :func:`_kernel_counts` says, E's calls by mask as
    :func:`_attention_calls` says. Prints ms per prefill, tokens/s, peak memory and the host
    syncs of one prefill; with ``trace``, one profiled prefill by family.
    With ``trace_s`` (a recurrent family, whose time loop costs launches in
    proportion to S) the warm-up, the host-sync count and the profiled
    prefill run at S = ``trace_s``, against an unprofiled prefill of that
    size. Returns the launches of one prefill."""
    import warnings
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import build_prefill_step
    step = build_prefill_step(cfg)
    batches = [_batch(torch, cfg, B, S, 1 + i, enc_len=S, vision=True)
               for i in range(requests + 1)]
    small = (batches[1] if trace_s is None else
             _batch(torch, cfg, B, trace_s, 9, enc_len=trace_s))
    t0 = time.perf_counter()
    step(params, batches[0] if trace_s is None else small)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    want, want_calls = _kernel_counts(cfg, S, S), _attention_calls(cfg, S, S)
    secs, calls = [], {}
    for i, batch in enumerate(batches[1:]):
        _lib.reset_launches()
        calls.clear()
        t0 = time.perf_counter()
        with _causal_tally(calls):
            logits = step(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per = {k: _lib.LAUNCHES[k] for k in want}
        if tuple(logits.shape) != (B, cfg.padded_vocab) or not bool(
                torch.isfinite(logits).all()) or per != want or (
                    calls != want_calls):
            raise AssertionError(f'{label} prefill {i}: logits '
                                 f'{tuple(logits.shape)}, launches {per}, '
                                 f'want {want}; kernel E calls by mask '
                                 f'{calls}, want {want_calls}')
    launches = dict(_lib.LAUNCHES)
    ms = sum(secs) / len(secs) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            step(params, small)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    syncs = sum('synchroniz' in str(w.message) for w in caught)
    moe_layers = sum(f == 'moe' for _, f in cfg.layer_kinds()) * cfg.n_blocks
    enc = (f' (+ {S} encoder frames a prompt)' if cfg.is_encdec else '')
    at = '' if trace_s is None else f' at S={trace_s}'
    print(f'{label} prefill: {requests} requests of {B} x {S} inputs{enc}: '
          f'{", ".join(f"{s * 1e3:.3f}" for s in secs)} ms (warm-up{at} '
          f'{warm_s * 1e3:.3f} ms), {ms:.3f} ms per prefill, '
          f'{B * S / ms * 1e3:.0f} tokens/s, peak memory {peak:.2f} GB, '
          f'launches per prefill {launches}, kernel E calls by mask {calls}; '
          f'host syncs in one prefill{at} (sync debug mode) {syncs}, MoE '
          f'layers {moe_layers} ({smi})', flush=True)
    if trace:
        trace_ms = ms
        if trace_s is not None:
            t0 = time.perf_counter()
            step(params, small)
            torch.cuda.synchronize()
            trace_ms = (time.perf_counter() - t0) * 1e3
            print(f'{label} prefill at S={trace_s} for the trace: '
                  f'{trace_ms:.3f} ms unprofiled', flush=True)
        _by_family(torch, lambda: step(params, small),
                   f'{label} prefill trace{at}', trace_ms)
    return launches


def run_moe(torch, dev, smi: str) -> dict:
    """Phase 20: Phi-3.5-MoE at full width, depth ``PHI_DEPTH``: (a) the
    prefill through kernels D and E; (b) decode, consistency and serving,
    then the kernel path against the plain path on the same weights at
    depth ``PARITY_LAYERS``; (c) one Llama-4 Maverick block: a prefill, then decode
    consistency. Returns {'moe': prefill launches, 'decode': launches by
    run}."""
    from repro_torch.configs import get_config
    del dev
    phi = dataclasses.replace(get_config('phi35_moe_42b_a66b'),
                              n_layers=PHI_DEPTH, use_pallas=True)
    params = _model_params(torch, phi, 0)
    out = {'moe': {'phi35_moe': _prefill(
        torch, phi, params, 'phi-3.5-moe', PREFILL_B, PREFILL_S, N_REQUESTS,
        smi)}, 'decode': {}}
    dec = _consistency(torch, phi, params, 'phi-3.5-moe', CONSIST_B,
                       CONSIST_T, CONSIST_MAX, smi)
    out['decode']['phi35_moe'] = _sum(dec, _serve_decode(
        torch, phi, params, 'phi-3.5-moe', DECODE_B, PHI_SMAX, DECODE_PROMPT,
        DECODE_NEW, smi))
    _kernel_parity(torch, phi, 'phi-3.5-moe', params)
    del params
    torch.cuda.empty_cache()

    mav = dataclasses.replace(get_config('llama4_maverick_400b_a17b'),
                              n_layers=MAVERICK_LAYERS, use_pallas=True)
    torch.cuda.reset_peak_memory_stats()
    params = _model_params(torch, mav, 0)
    out['moe']['maverick'] = _prefill(
        torch, mav, params, 'llama4-maverick block', 1, MAVERICK_S, 1, smi,
        trace=False)
    out['decode']['maverick'] = _consistency(
        torch, mav, params, 'llama4-maverick block', CONSIST_B,
        MAVERICK_STEPS, MAVERICK_STEPS, smi)
    print(f'llama4-maverick block: peak memory '
          f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})',
          flush=True)
    del params
    torch.cuda.empty_cache()
    return out


# the third of the time budget's cuts: these families' runs at half their
# depth, since the whole script took 942.0 s on one host (NVIDIA H100
# 80GB HBM3, 700.00 W) with the first two cuts alone
FAMILY_HALF_DEPTH = ('qwen2_vl_7b', 'seamless_m4t_large_v2')
FAMILY_CUT_WHY = ('with phase 27 cut, the whole script took 942.0 s on one '
                  'host, past the 900 s that keeps a slower host inside its '
                  '1200 s limit')


def run_families(torch, dev, smi: str) -> dict:
    """Phase 21: the model zoo's last four families at full width, random
    bf16 weights, ``use_pallas=True``: (a) Qwen2-VL-7B (M-RoPE, embedding
    inputs) and (b) SeamlessM4T-large-v2 (encoder-decoder) at half depth
    (``FAMILY_HALF_DEPTH``: cut for the script's time); (c) Jamba-v0.1 at
    depth ``JAMBA_DEPTH`` (one period) and (d) RWKV-6 1.6B at full depth,
    then both at ``long_500k``'s Smax with
    B = 1. Each: prefills through D and E with exact launch counts and one
    profiled prefill by family, decode against ``forward``, serving decode
    (no kernel), and for (a)–(c) the kernel path against the plain path.
    Returns {'prefill': launches of one prefill by family,
    'decode': launches by run (all 0)}."""
    from repro_torch.configs import get_config
    del dev
    out = {'prefill': {}, 'decode': {}}

    def family(arch, label, B, requests, *, depth=None, trace_s=None,
               parity=False, long=False):
        cfg = dataclasses.replace(get_config(arch), use_pallas=True)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        if arch in FAMILY_HALF_DEPTH:
            cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers // 2,
                                      n_enc_layers=cfg.n_enc_layers // 2)
            print(f'{label}: depth cut to {cfg.n_layers}'
                  + (f' + {cfg.n_enc_layers}' if cfg.is_encdec else '')
                  + f', half: {FAMILY_CUT_WHY}', flush=True)
        torch.cuda.reset_peak_memory_stats()
        params = _model_params(torch, cfg, 0)
        out['prefill'][arch] = _prefill(torch, cfg, params, label, B,
                                        PREFILL_S, requests, smi,
                                        trace_s=trace_s)
        torch.cuda.empty_cache()
        dec = _consistency(torch, cfg, params, label, CONSIST_B, CONSIST_T,
                           CONSIST_MAX, smi)
        out['decode'][arch] = _sum(dec, _serve_decode(
            torch, cfg, params, label, DECODE_B, FAMILY_SMAX,
            DECODE_PROMPT, DECODE_NEW, smi))
        torch.cuda.empty_cache()
        if long:
            out['decode'][f'{arch} long_500k'] = _serve_decode(
                torch, cfg, params, f'{label} long_500k', 1, LONG_SMAX,
                LONG_PROMPT, LONG_NEW, smi)
        if parity:
            _kernel_parity(torch, cfg, label, params)
        print(f'{label}: peak memory over the family '
              f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({smi})',
              flush=True)
        del params
        torch.cuda.empty_cache()

    for arch, S in TRACE_CUT.items():
        print(f'{arch} prefill trace: S cut from {S} to {TRACE_S[arch]}: '
              'the whole script must end inside its 1200 s limit, and the '
              'profiler records every launch of the time loop', flush=True)
    family('qwen2_vl_7b', 'qwen2-vl-7b', PREFILL_B, N_REQUESTS, parity=True)
    family('seamless_m4t_large_v2', 'seamless-m4t-v2', PREFILL_B,
           N_REQUESTS, parity=True)
    family('jamba_v01_52b', 'jamba-v0.1', JAMBA_B, N_REQUESTS,
           depth=JAMBA_DEPTH, trace_s=TRACE_S['jamba'], parity=True,
           long=True)
    family('rwkv6_1b6', 'rwkv-6', PREFILL_B, RWKV_REQUESTS,
           trace_s=TRACE_S['rwkv'], long=True)
    return out



# --------------------------------------------------------------------------
# Phase 22: the solver observatory (repro_torch.bench)
# --------------------------------------------------------------------------
OBS_SOLVERS = ('nystrom', 'cg', 'neumann', 'exact')
OBS_TASKS = 3
OBS_MAIN = dict(spec='reweighting', oracle_rho=1e-2, max_oracle_p=30_000,
                grid={'k': (5, 10, 20, 50), 'rho': (1e-2,)})
OBS_ABC = ('nystrom_gram', 'woodbury_ctv', 'woodbury_apply')
# Phase 22 (a), the reference's default sweep (39 cells of 3 members, 18.8 s
# on a slow host, chip run PR 29), is the second cut PERF.md names: with
# phase 26 a slow host ran the whole script in 1,344.0 s. Its toy problems
# are held by tests/test_torch_bench_observatory.py on the CPU.
OBS_SWEEP_CUT = ('phase 26 needs its time inside the 1200 s limit (the '
                 'sweep took 18.8 s on a slow host); its toy problems are '
                 'held on the CPU by tests/test_torch_bench_observatory.py')


def _count(launches: dict) -> dict:
    return {n: c for n, c in launches.items() if c}


def _obs_line(cell, launches=None) -> str:
    knobs = ','.join(f'{k}={v}' for k, v in cell.grid.items())
    out = (f'{cell.solver:<8} {knobs:<16} be={cell.backend:<5} '
           f'err mean {cell.hypergrad_error:.6e} max {cell.err_max:.6e} '
           f'hvp_count {cell.hvp_count} wall {cell.wall_seconds:.6f} s '
           f'applies/s {cell.applies_per_sec:.3f}')
    if launches is not None:
        out += f' launches {launches}'
    return out


def _obs_agree(label: str, a, b) -> None:
    """A Nyström cell on 'cuda' against the same cell on 'flat': errors at
    1e-4 relative, above an absolute floor of 1e-6 (``compare_docs``'s
    ``atol_error``) for errors that are f32 roundoff themselves, as the
    full-rank sketch's are; the same bill; every error finite."""
    for field in ('hypergrad_error', 'err_max'):
        x, y = getattr(a, field), getattr(b, field)
        if not (math.isfinite(x) and abs(x - y) <= 1e-4 * abs(y) + 1e-6):
            raise AssertionError(f'{label}: {field} cuda {x!r} vs flat {y!r}')
    if a.hvp_count != b.hvp_count:
        raise AssertionError(f'{label}: hvp_count {a.hvp_count} vs '
                             f'{b.hvp_count}')


def _obs_members(torch, label: str, got, want) -> float:
    """Stacked hypergradients, member by member: relative L2 <= 1e-4."""
    from repro_torch.core import tree_leaves
    errs = []
    for t in range(tree_leaves(want)[0].shape[0]):
        a, b = (torch.cat([x[t].reshape(-1).double()
                           for x in tree_leaves(h)]) for h in (got, want))
        errs.append(float((a - b).norm() / b.norm()))
    if not max(errs) <= 1e-4:
        raise AssertionError(f'{label}: member hypergradients cuda vs flat '
                             f'rel L2 {errs}')
    return max(errs)


def run_observatory(torch, dev, smi: str) -> dict:
    """Phase 22: the solver observatory on the card. (a) the reference's
    default sweep is cut (``OBS_SWEEP_CUT``, printed); (b) the main path's
    ``reweighting`` (p = 26,122) as a population of 3 against the exact
    oracle at rho = 1e-2, Nyström on 'cuda' at k = 5..50; (c) one profiled
    Nyström cell of (b). Returns the launches of kernels A, B and C summed
    over (b)'s 'cuda' cells."""
    print(f'observatory: {smi}', flush=True)
    print(f'observatory (a): the default sweep is cut: {OBS_SWEEP_CUT}',
          flush=True)
    return {'reweighting': _observatory_main(torch, smi)}


@_stepped
def _observatory_main(torch, smi: str) -> dict:
    """Phase 22 (b), (c): ``reweighting`` at the main path's width against
    the exact oracle, and one profiled cell; the launches of kernels A–C
    summed over (b)'s 'cuda' cells."""
    from repro_torch.bench import build_population, solver_grid_points
    from repro_torch.bench.observatory import cell_hypergrads, measure_cell
    from repro_torch.kernels import _lib
    spec, grid = OBS_MAIN['spec'], OBS_MAIN['grid']
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bundle = build_population(spec, tasks=OBS_TASKS,
                              oracle_rho=OBS_MAIN['oracle_rho'],
                              max_oracle_p=OBS_MAIN['max_oracle_p'])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if bundle.p != MAIN_P:
        raise AssertionError(f'(b): p={bundle.p}, expected {MAIN_P}')
    print(f'observatory (b): {spec} p={bundle.p} population of '
          f'{bundle.tasks} built: adaptation {bundle.seconds["adapt"]:.3f} '
          f's, oracle {bundle.seconds["oracle"]:.3f} s (rho '
          f'{OBS_MAIN["oracle_rho"]}), peak device memory {peak:.2f} GiB '
          f'| {smi}', flush=True)
    main_launches = dict.fromkeys(OBS_ABC, 0)
    main_cells = {}
    for solver in OBS_SOLVERS:
        for point in solver_grid_points(solver, grid):
            backend = 'cuda' if solver == 'nystrom' else 'tree'
            torch.cuda.reset_peak_memory_stats()
            _lib.reset_launches()
            cell = measure_cell(bundle, solver, point, backend=backend)
            launches = dict(_lib.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            main_cells[(solver, point.get('k'))] = cell
            print(f'observatory (b): {_obs_line(cell, _count(launches))} '
                  f'peak {peak:.2f} GiB', flush=True)
            if not (math.isfinite(cell.hypergrad_error)
                    and math.isfinite(cell.err_max)):
                raise AssertionError(f'(b) {_obs_line(cell)}: not finite')
            if solver == 'nystrom':
                if not all(launches[n] for n in OBS_ABC):
                    raise AssertionError(f'(b) {_obs_line(cell)}: launches '
                                         f'{_count(launches)}')
                for n in OBS_ABC:
                    main_launches[n] += launches[n]
    exact = main_cells[('exact', None)]
    if not exact.err_max <= 1e-4:
        raise AssertionError(f'(b) exact against the oracle: '
                             f'{_obs_line(exact)}')
    top = {'k': max(grid['k']), 'rho': grid['rho'][0]}
    flat = measure_cell(bundle, 'nystrom', top, backend='flat')
    print(f'observatory (b): {_obs_line(flat)}', flush=True)
    _obs_agree(f'(b) nystrom {top}', main_cells[('nystrom', top['k'])], flat)
    err = _obs_members(torch, f'(b) nystrom {top}',
                       cell_hypergrads(bundle, 'nystrom', top,
                                       backend='cuda'),
                       cell_hypergrads(bundle, 'nystrom', top,
                                       backend='flat'))
    print(f'observatory (b): nystrom {top} cuda vs flat: errors within '
          f'1e-4 relative, stacked hypergradients largest member rel L2 '
          f'{err:.3e} (<= 1e-4); exact cell err max {exact.err_max:.3e} '
          f'(<= 1e-4)', flush=True)

    # (c) one profiled cell ---------------------------------------------
    point = {'k': 10, 'rho': grid['rho'][0]}
    cell = main_cells[('nystrom', 10)]

    def run():
        return cell_hypergrads(bundle, 'nystrom', point, backend='cuda')
    _lib.reset_launches()
    run()
    torch.cuda.synchronize()
    launches = _count(dict(_lib.LAUNCHES))
    busy = _device_busy(torch, run)
    if busy is None:
        print('observatory (c): the profiler recorded no device events; '
              'device time not measured', flush=True)
    else:
        ms, n = busy
        wall_ms = cell.wall_seconds * 1e3
        print(f'observatory (c): nystrom {point} cuda, one population call '
              f'({bundle.tasks} members): {n} kernels, {ms:.3f} ms of device '
              f'time against the unprofiled best {wall_ms:.3f} ms: device '
              f'busy {100 * ms / wall_ms:.1f}%, idle '
              f'{100 * (1 - ms / wall_ms):.1f}%; kernel launches {launches} '
              f'| {smi}', flush=True)
    return main_launches


# --------------------------------------------------------------------------
# Phase 23: training the encoder-decoder, M-RoPE/embedding-input and MoE
# families, their Nyström sketches through kernels A-C
# --------------------------------------------------------------------------
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 128, 3
# Each family's depth cut, and why. Widths are whole. A k = 8 bf16 sketch
# keeps C and its whitened factor B, 32 bytes a parameter, beside the f32
# parameters (4), one column chunk's one-hots and columns (16) and the
# apply's f32 vectors; AdamW adds 12 bytes a parameter while it lives.
TRAIN_CUTS = {
    'seamless_m4t_large_v2': (
        dict(n_layers=8, n_enc_layers=8),
        '24 + 24 layers cut to 8 + 8: the hypergradient ran out of the '
        "card's memory at 24 + 24 (p = 2.03 B) and at 12 + 12 (p = 1.28 B)"),
    'qwen2_vl_7b': (
        dict(n_layers=2),
        '28 layers cut to 2, as phase 18 cuts Yi-9B: about 233 M a layer '
        'beside the 545 M unembedding'),
    'phi35_moe_42b_a66b': (
        dict(n_layers=1, n_experts=8),
        '32 layers cut to 1 and its 16 experts to 8 (top-2 kept, each at '
        'full width): with 16 (p = 1.56 B) train_lm ran out of memory, '
        'AdamW living beside the sketch'),
}
TRAIN_LM = dict(steps=4, batch=TRAIN_B, seq=TRAIN_S, outer_every=2)
TRAIN_ABC = ('nystrom_gram', 'nystrom_gram_tc', 'woodbury_ctv',
             'woodbury_apply')


def blocked_flat_backend(torch, dtype, cols: int = 1 << 24):
    """``backend='flat'`` (the (k, p) fused buffer, every contraction a
    ``torch.matmul`` accumulated in f32) with its two reductions over p,
    ``gram`` and ``ctv``, summed over blocks of ``cols`` columns: the flat
    backend upcasts the whole bf16 buffer to f32 for them, 32 bytes a
    parameter at k = 8, which a sketch of p ~ 10⁹ beside its model cannot
    hold. ``cv``, ``mul_right`` and ``combine`` already go by blocks."""
    from repro_torch.core import FlatBackend

    def blocks(n):
        return (slice(r, r + cols) for r in range(0, n, cols))

    class BlockedFlat(FlatBackend):
        def gram(self, Ckp):
            out = 0
            for b in blocks(Ckp.shape[1]):
                c = Ckp[:, b].float()
                out = out + c @ c.T
            return out

        def ctv(self, Ckp, vf):
            return sum(Ckp[:, b].float() @ vf[b].float()
                       for b in blocks(Ckp.shape[1]))

    return BlockedFlat(sketch_dtype=dtype)


def _train_batch(torch, cfg, B: int, S: int, seed: int) -> dict:
    """A training batch in ``make_batch_sds``'s layout from ``seed``, with
    the hypergradient's ``domain`` (among 64): tokens and labels on the
    host, bf16 embeddings and encoder frames drawn on the card, Qwen2-VL's
    (t, h, w) ids with an image grid (:func:`_vision_ids`), about a tenth
    of the mask off."""
    from repro_torch.launch.steps import N_DOMAINS, make_batch_sds
    host = torch.Generator().manual_seed(seed)
    card = torch.Generator('cuda').manual_seed(seed)
    out = {}
    for name, sds in make_batch_sds(cfg, B, S).items():
        if name == 'positions':
            out[name] = _vision_ids(torch, B, S)
        elif name == 'mask':
            out[name] = (torch.rand(sds.shape, generator=host)
                         < 0.9).float()
        elif sds.dtype.is_floating_point:
            out[name] = torch.randn(sds.shape, dtype=sds.dtype,
                                    device='cuda', generator=card)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, sds.shape,
                                      generator=host, dtype=sds.dtype)
    out['domain'] = torch.randint(0, N_DOMAINS, (B,), generator=host,
                                  dtype=torch.int32)
    return out


@contextlib.contextmanager
def _moe_syncs(torch, counts: dict):
    """While the block runs: ``counts['host']``, the host syncs that
    torch's sync debug mode reports, and ``counts['moe']``, the MoE
    layers' group-size reads (one per call of ``moe.route``)."""
    import warnings
    from repro_torch.models import moe
    route = moe.route

    def counted(*args):
        counts['moe'] += 1
        return route(*args)
    counts.update(host=0, moe=0)
    moe.route = counted
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode('default')
            moe.route = route
    counts['host'] = sum('synchroniz' in str(w.message) for w in caught)


def _not_rising(label: str, losses: list, norms: list = ()) -> None:
    """The inner losses of steps on one batch (and their gradient norms)
    finite and not rising."""
    if not (all(map(math.isfinite, list(losses) + list(norms)))
            and all(b <= a for a, b in zip(losses, losses[1:]))):
        raise AssertionError(f'{label}: inner losses on one batch {losses}, '
                             f'gradient norms {list(norms)}')


def _runs_gate(label: str, a, b, outer_every: int) -> dict:
    """Two ``train_lm`` runs (cuda, flat) on the same parameters, batches
    and draws, as ``_lm_gate`` holds them where bf16 compute lets it:
    every value finite; the inner losses up to the first outer step and
    its value within 1e-4 relative (the same parameters, until the
    hyperparameters move); the domain logits within 2·lr a step of adam's
    (``_lm_gate``'s bound); an outer step every ``outer_every`` steps.
    After the first update the runs' inner losses
    follow two hyperparameter paths: the bf16-compute hypergradients are
    ~1e-3 apart (the f32 paths' own spread at this p, which the f64 gate
    on the IHVP decides), and adam turns a difference on a domain whose
    hypergradient is rounding noise into a whole step; those losses,
    values and hypergradients are returned, not gated. The first outer
    step's hypergradients, at one point, are returned for phase 18's
    gate."""
    import numpy as np
    finite = (all(map(math.isfinite, a.losses + b.losses))
              and all(math.isfinite(o['val']) and
                      bool(o['hypergrad'].isfinite().all())
                      for o in a.outer + b.outer))
    first = max(abs(x / y - 1)
                for x, y in zip(a.losses[:outer_every],
                                b.losses[:outer_every]))
    val0 = abs(a.outer[0]['val'] / b.outer[0]['val'] - 1)
    logits = max(float(np.abs(x['logits'].double().cpu().numpy()
                              - y['logits'].double().cpu().numpy()).max())
                 / (2 * 1e-2 * n)
                 for n, (x, y) in enumerate(zip(a.outer, b.outer), 1))
    spread = {'losses before the first update': first,
              'first outer value': val0,
              'logits over the bound 2·lr·n': logits,
              'first hypergradient': _rel_l2(a.outer[0]['hypergrad'],
                                             b.outer[0]['hypergrad'])}
    if len(a.outer) > 1:
        spread.update({
            'later losses': max(abs(x / y - 1) for x, y in zip(
                a.losses[outer_every:], b.losses[outer_every:])),
            'later values': max(abs(x['val'] / y['val'] - 1)
                                for x, y in zip(a.outer[1:], b.outer[1:])),
            'later hypergradients': max(
                _rel_l2(x['hypergrad'], y['hypergrad'])
                for x, y in zip(a.outer[1:], b.outer[1:]))})
    if not (finite and len(a.outer) == len(b.outer)
            == len(a.losses) // outer_every
            and first <= 1e-4 and val0 <= 1e-4 and logits <= 1):
        raise AssertionError(f'{label}: cuda vs flat {spread}, finite '
                             f'{finite}')
    return spread


@_stepped
def _ihvp_vs_f64(torch, solver, sketch, params, h, ib, ob, losses) -> dict:
    """On the cuda ``sketch``: ``'u'``, the relative L2 of the IHVP u =
    (H_k + ρI)⁻¹ ∇θ g through kernels A-C against their plain versions in
    f64 (by blocks of rows, :func:`blocked_f64_backend`), phase 18's gate;
    ``'hg64'``, the hypergradient through the f64 versions; ``'spec'``,
    the range of H_KK and of BᵀB's eigenvalues. Raises where the sketch is
    0 (its Hessian columns vanish), which no kernel check could read."""
    from repro_torch.core.backend import flatten_vec
    from repro_torch.launch.steps import lm_hypergrad, loss_and_grads
    inner, outer = losses
    ref64 = blocked_f64_backend(torch, torch.bfloat16)
    solver64 = dataclasses.replace(solver, backend=ref64)
    gram64 = ref64.gram(sketch.B)
    lam = torch.linalg.eigvalsh(gram64.double())
    hkk = float(sketch.H_KK.abs().max())
    if not (hkk > 0 and float(lam.max()) > 0):
        raise AssertionError(f'a sketch of zeros: |H_KK| {hkk}, eigenvalues '
                             f'of BᵀB {lam.tolist()}')
    sk64 = dataclasses.replace(sketch, gram_B=gram64)
    _, g_theta = loss_and_grads(lambda th: outer(th, h, ob), params)
    u = flatten_vec(solver.apply(sketch, g_theta))
    u_err = _rel_l2(u, flatten_vec(solver64.apply(sk64, g_theta)))
    del u, g_theta
    _, hg64 = lm_hypergrad(solver64, inner, outer, params, h, ib, ob,
                           state=sk64)
    return {'u': u_err, 'hg64': hg64['domain_logits'],
            'spec': f'max |H_KK| {hkk:.4e}, eigenvalues of BᵀB '
                    f'{float(lam.min()):.4e} .. {float(lam.max()):.4e} '
                    f'against rho {RHO}'}


def _hg_gate(label: str, errs: dict) -> None:
    """Phase 18's gate: cuda within 1e-4 of flat, or, where the f32 paths
    spread more at this p, the IHVP u through the kernels within 1e-4 of
    its f64 plain version."""
    if not (errs['cuda vs flat'] <= 1e-4 or errs['u cuda vs f64'] <= 1e-4):
        raise AssertionError(f'{label}: {errs}')


@_stepped
def _train_family(torch, dev, smi: str, arch: str, label: str) -> dict:
    """Phase 23 (a), (b): ``arch`` cut as ``TRAIN_CUTS`` says, f32
    parameters from a seeded generator, bf16 compute, remat 'full'. First
    the hypergradient at the initial parameters
    (:func:`_family_hypergrad`), then ``TRAIN_STEPS`` ``build_train_step``
    steps on its inner batch (:func:`_family_steps`). The hypergradient
    comes first: one AdamW step at Qwen2-VL's width drives the batch it
    trained on to a loss of 0 and leaves a Hessian of 0 on fresh batches
    too (chip run), which would hand kernels A-C a sketch of zeros.
    Returns the cuda run's launches."""
    from repro_torch.configs import get_config
    cuts, why = TRAIN_CUTS[arch]
    cfg = dataclasses.replace(get_config(arch), **cuts)
    params, ib, ob = _family_draw(torch, dev, cfg, label, why)
    launches = _family_hypergrad(torch, dev, smi, cfg, label, params, ib,
                                 ob)
    held = [params]
    del params
    _family_steps(torch, cfg, label, held, ib, ob)
    return launches


def _family_draw(torch, dev, cfg, label: str, why: str, S: int = TRAIN_S):
    """f32 parameters of ``cfg`` from a seeded generator on the card, and
    an inner and an outer batch of ``TRAIN_B`` × ``S``; prints the cut
    and its reason."""
    from repro_torch.core import tree_leaves
    from repro_torch.launch.steps import to_device
    from repro_torch.models import build_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg, device=dev).init(
        torch.Generator('cuda').manual_seed(0))
    torch.cuda.synchronize()
    p = sum(x.numel() for x in tree_leaves(params))
    print(f'{label} training: depth cut: {why}; p={p:,} f32 parameters '
          f'drawn in {time.perf_counter() - t0:.1f} s', flush=True)
    return (params, to_device(_train_batch(torch, cfg, TRAIN_B, S, 1), dev),
            to_device(_train_batch(torch, cfg, TRAIN_B, S, 2), dev))


@_stepped
def _family_hypergrad(torch, dev, smi: str, cfg, label: str, params, ib,
                      ob) -> dict:
    """``lm_hypergrad`` through ``NystromIHVP(k=8, column_chunk=2)`` with a
    bf16 sketch at one draw, at ``params`` and ``ib``, on 'cuda' (the
    sketch prepared apart and kept for the f64 check) and, first, on
    'flat' (:func:`blocked_flat_backend`), gated as phase 18; the host
    syncs of the cuda run counted. Returns the cuda run's launches."""
    from repro_torch.core import (HypergradConfig, PyTreeIndexer, make_hvp,
                                  tree_leaves)
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import (N_DOMAINS, domain_losses,
                                          lm_hypergrad)
    p = sum(x.numel() for x in tree_leaves(params))
    inner, outer = domain_losses(cfg)
    h = {'domain_logits': 0.1 * torch.randn(
        N_DOMAINS, device=dev, generator=torch.Generator('cuda').manual_seed(3))}
    indexer = PyTreeIndexer(params)
    idx = indexer.sample_indices(torch.Generator().manual_seed(0), LM_K)
    # 'flat' first: its call also takes the first call's set-up on the card
    flat = HypergradConfig(solver='nystrom', k=LM_K, rho=RHO,
                           column_chunk=LM_CHUNK,
                           backend=blocked_flat_backend(
                               torch, torch.bfloat16)).build()
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fval, fhg = lm_hypergrad(flat, inner, outer, params, h, ib, ob,
                             indices=idx)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t0
    fhg = fhg['domain_logits']
    if any(_lib.LAUNCHES.values()):
        raise AssertionError(f'{label}: flat launched {_lib.LAUNCHES}')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    solver = _lm_config('cuda', sketch_dtype='bfloat16').build()
    counts = {}
    torch.cuda.synchronize()
    with _moe_syncs(torch, counts):
        t0 = time.perf_counter()
        sketch = solver.prepare(make_hvp(inner, params, h, ib), indexer,
                                None, indices=idx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        val, hg = lm_hypergrad(solver, inner, outer, params, h, ib, ob,
                               state=sketch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = {n: _lib.LAUNCHES[n] for n in TRAIN_ABC}
    cuda_peak = torch.cuda.max_memory_allocated() / 1e9
    hg = hg['domain_logits']
    check = _ihvp_vs_f64(torch, solver, sketch, params, h, ib, ob,
                         (inner, outer))
    del sketch
    errs = {'u cuda vs f64': check['u'], 'cuda vs flat': _rel_l2(hg, fhg),
            'cuda vs f64': _rel_l2(hg, check['hg64']),
            'flat vs f64': _rel_l2(fhg, check['hg64'])}
    finite = bool(torch.isfinite(hg).all() and torch.isfinite(fhg).all())
    if not (finite and launches['nystrom_gram_tc'] == launches[
            'nystrom_gram'] > 0 and launches['woodbury_ctv'] > 0
            and launches['woodbury_apply'] > 0
            and abs(float(val) / float(fval) - 1) <= 1e-4):
        raise AssertionError(f'{label}: launches {launches}, values '
                             f'{float(val)} {float(fval)}, finite {finite}')
    _hg_gate(label, errs)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f'{label} training: {smi} | {cfg.name} d_model {cfg.d_model}, '
          f'depth {cfg.n_layers}'
          + (f' + {cfg.n_enc_layers} encoder' if cfg.is_encdec else '')
          + f', p={p:,}, f32 params, bf16 compute, remat {cfg.remat}, '
          f'batch {TRAIN_B} x {ib["labels"].shape[1]} '
          f'({", ".join(sorted(ib))}); '
          f'lm_hypergrad k={LM_K}, column_chunk={LM_CHUNK}, bf16 sketch, '
          f'cuda: outer step {t2 - t0:.4f} s (HVP columns and prepare '
          f'{t1 - t0:.4f}, apply with the mixed term {t2 - t1:.4f}), peak '
          f'{cuda_peak:.2f} GB, launches {launches}, host syncs '
          f"{counts['host']} (MoE group-size reads {counts['moe']}); flat, "
          f'the first call, {flat_s:.4f} s; '
          f'value {float(val):.6f} (flat {float(fval):.6f}); {check["spec"]};'
          ' relative L2 '
          + ', '.join(f'{k} {e:.3e}' for k, e in errs.items())
          + f' (gate: cuda vs flat <= 1e-4, or u vs f64 <= 1e-4); peak '
          f'over the outer steps {peak:.2f} GB', flush=True)
    return launches


@_stepped
def _family_steps(torch, cfg, label: str, held: list, ib, ob,
                  profile: bool = False) -> None:
    """``TRAIN_STEPS`` ``build_train_step`` steps on ``ib`` from the
    parameters in the one-element list ``held`` (taken out of it, so that
    each step's update frees the last), then the loss on ``ib`` and
    ``ob``. Without ``profile`` (phase 23) the losses must be finite and
    not rising. With ``profile`` (phase 24's Jamba) they must be finite
    and the first update must lower the loss: at the random init's logit
    scale AdamW's first step takes Jamba's batch from a loss of 266 to
    0.72 and its second overshoots to 20.8 (chip run); then one more step
    runs under ``torch.profiler`` (:func:`_loop_profile`: its kernels,
    device idle share and the time loops' device time) with its host
    syncs counted."""
    from repro_torch.launch.steps import build_train_step, make_optimizer
    from repro_torch.models.transformer import train_loss
    params = held.pop()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = build_train_step(cfg)
    opt_state = make_optimizer(cfg).init(params)
    losses, norms, secs = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, _, m = step(params, opt_state, i, ib)
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
        secs.append(time.perf_counter() - t0)
    if not profile:
        _not_rising(label, losses, norms)
    elif not (all(map(math.isfinite, losses + norms))
              and min(losses[1:]) < losses[0]):
        raise AssertionError(f'{label}: losses on one batch {losses}, '
                             f'gradient norms {norms}')
    with torch.no_grad():
        seen, fresh = (float(train_loss(cfg, params, b)) for b in (ib, ob))
    print(f'{label} training: {TRAIN_STEPS} build_train_step steps on that '
          f'batch, s per step {[round(s, 4) for s in secs]}, losses '
          f'{[round(x, 4) for x in losses]}, gradient norms '
          f'{[round(x, 4) for x in norms]}; after them the loss on that '
          f'batch {seen:.4f}, on the outer batch {fresh:.4f}; peak '
          f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB', flush=True)
    if profile:
        box, counts = {}, {}
        with _moe_syncs(torch, counts):
            split = _loop_profile(torch, lambda: box.update(
                out=step(params, opt_state, TRAIN_STEPS, ib)))
        box.clear()
        _print_loop_profile(f'{label} training: a build_train_step step',
                            split, min(secs[1:]), counts)
    del params, opt_state, step
    torch.cuda.empty_cache()


@_stepped
def _train_moe(torch, dev, smi: str) -> dict:
    """Phase 23 (c): ``train_lm`` on Phi-3.5-MoE cut as ``TRAIN_CUTS``
    says (``TRAIN_LM``: two outer steps, each a fresh k = 8 bf16 sketch)
    on 'cuda' and on 'flat' (:func:`blocked_flat_backend`), the same
    seeded parameters, batches and draws, gated by :func:`_runs_gate`.
    Then from the cuda run's state: ``TRAIN_STEPS`` inner steps on one
    batch (losses not rising), the second profiled and its host syncs
    counted; and the last outer step again on a fresh inner batch (AdamW
    freed), timed, profiled, its syncs counted, its IHVP against f64 and
    its hypergradient against 'flat', phase 18's gate, which also holds
    the training runs' first outer step. Returns the cuda run's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import HypergradConfig, PyTreeIndexer, make_hvp
    from repro_torch.data import TokenStream
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import (domain_losses, lm_hypergrad,
                                          loss_and_grads, make_optimizer,
                                          to_device)
    from repro_torch.launch.train import train_lm
    arch, label = 'phi35_moe_42b_a66b', 'phi-3.5-moe'
    cuts, why = TRAIN_CUTS[arch]
    cfg = dataclasses.replace(get_config(arch), **cuts)
    flat_be = blocked_flat_backend(torch, torch.bfloat16)
    configs = {'cuda': _lm_config('cuda', sketch_dtype='bfloat16'),
               'flat': HypergradConfig(solver='nystrom', k=LM_K, rho=RHO,
                                       column_chunk=LM_CHUNK,
                                       backend=flat_be)}
    runs, launches, walls, peaks = {}, {}, {}, {}
    for name in ('flat', 'cuda'):      # the cuda run's state is kept
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        run, lines = _quiet(lambda: train_lm(cfg, configs[name], device=dev,
                                             log_every=0, **TRAIN_LM))
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        launches[name] = {n: _lib.LAUNCHES[n] for n in TRAIN_ABC}
        if name == 'cuda':
            state = (run.params, run.opt_state, run.hparams)
        run.params = run.opt_state = None
        runs[name] = run
    got = launches['cuda']
    if not (got['nystrom_gram_tc'] == got['nystrom_gram'] == 2
            and got['woodbury_ctv'] > 0 and got['woodbury_apply'] > 0
            and not any(launches['flat'].values())):
        raise AssertionError(f'{label}: launches {launches}')
    a, b = runs['cuda'], runs['flat']
    spread = _runs_gate(label, a, b, TRAIN_LM['outer_every'])
    p = sum(x.numel() for x in _leaves(state[0]))
    print(f'{label} training: {smi} | depth cut: {why}; p={p:,}, f32 '
          f'params, bf16 compute, remat {cfg.remat}; train_lm {TRAIN_LM}, '
          f'k={LM_K}, column_chunk={LM_CHUNK}, bf16 sketch: cuda '
          f"{walls['cuda']:.3f} s in all (init included), flat "
          f"{walls['flat']:.3f} s; s per inner step "
          f'{[round(x, 4) for x in a.step_s]}, s per outer step '
          f"{[round(o['build_s'] + o['grad_s'], 4) for o in a.outer]} "
          f"(sketch refresh {[round(o['build_s'], 4) for o in a.outer]}, "
          f"hypergradient {[round(o['grad_s'], 4) for o in a.outer]}), "
          f'inner losses {[round(x, 4) for x in a.losses]}, outer values '
          f"{[round(o['val'], 4) for o in a.outer]}; cuda vs flat "
          + ', '.join(f'{k} {e:.3e}' for k, e in spread.items())
          + f"; peak {peaks['cuda']:.2f} GB (flat "
          f"{peaks['flat']:.2f}), launches {got}", flush=True)

    # from the cuda run's state: inner steps on one batch, profiled
    params, opt_state, h = state
    del state
    inner, outer = domain_losses(cfg)
    optimizer = make_optimizer(cfg)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_S)
    i = TRAIN_LM['steps']
    ib = to_device(stream.batch(i, TRAIN_B), dev)
    ob = to_device(stream.batch(10_000_000 + i, TRAIN_B, clean_only=True),
                   dev)

    def inner_step(params, opt_state, n):
        loss, grads = loss_and_grads(inner, params, h, ib)
        params, opt_state = optimizer.apply(grads, opt_state, params, i + n)
        return params, opt_state, float(loss)

    losses, counts = [], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt_state, l0 = inner_step(params, opt_state, 0)
    torch.cuda.synchronize()
    inner_s = time.perf_counter() - t0
    box = {}

    def profiled_inner():
        box['out'] = inner_step(params, opt_state, 1)
    with _moe_syncs(torch, counts):
        busy = _kernel_ms(torch, profiled_inner)
    params, opt_state, l1 = box.pop('out')
    inner_syncs = dict(counts)
    params, opt_state, l2 = inner_step(params, opt_state, 2)
    losses = [l0, l1, l2]
    _not_rising(label, losses)
    idle = ('not measured (no device events)' if busy is None else
            f'{busy[1]} kernels, {busy[0]:.3f} ms of device time, idle '
            f'{100 * (1 - busy[0] / (inner_s * 1e3)):.1f}%')
    print(f'{label} training: {TRAIN_STEPS} inner steps on one batch from '
          f'the trained state: losses {[round(x, 4) for x in losses]}, '
          f'{inner_s:.4f} s unprofiled; profiled: {idle}; host syncs '
          f"{inner_syncs['host']}, of them MoE group-size reads "
          f"{inner_syncs['moe']} ({cfg.n_layers} MoE layer, remat "
          f'{cfg.remat}: the recompute routes again)', flush=True)

    # the outer step again at the trained state, AdamW freed, on a fresh
    # inner batch (the one trained on three times may sit at a loss of 0)
    del opt_state
    hb = to_device(stream.batch(i + 1, TRAIN_B), dev)
    torch.cuda.empty_cache()
    solver = configs['cuda'].build()
    indexer = PyTreeIndexer(params)
    idx = indexer.sample_indices(torch.Generator().manual_seed(i), LM_K)

    def outer_step():
        sketch = solver.prepare(make_hvp(inner, params, h, hb), indexer,
                                None, indices=idx)
        val, hg = lm_hypergrad(solver, inner, outer, params, h, hb, ob,
                               state=sketch)
        return sketch, val, hg['domain_logits']

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sketch, _, hg = outer_step()
    torch.cuda.synchronize()
    outer_s = time.perf_counter() - t0
    check = _ihvp_vs_f64(torch, solver, sketch, params, h, hb, ob,
                         (inner, outer))
    del sketch
    torch.cuda.empty_cache()
    with _moe_syncs(torch, counts):
        busy = _kernel_ms(torch, lambda: box.update(out=outer_step()))
    box.clear()
    _, fhg = lm_hypergrad(
        dataclasses.replace(solver, backend=flat_be), inner, outer, params,
        h, hb, ob, indices=idx)
    errs = {'u cuda vs f64': check['u'],
            'cuda vs flat': _rel_l2(hg, fhg['domain_logits']),
            'cuda vs f64': _rel_l2(hg, check['hg64']),
            'flat vs f64': _rel_l2(fhg['domain_logits'], check['hg64'])}
    _hg_gate(label, errs)
    # the training runs' first outer step: the same point on both sides
    _hg_gate(f'{label}, the first outer step of the training runs', {
        'cuda vs flat': spread['first hypergradient'],
        'u cuda vs f64': check['u']})
    idle = ('not measured (no device events)' if busy is None else
            f'{busy[1]} kernels, {busy[0]:.3f} ms of device time, idle '
            f'{100 * (1 - busy[0] / (outer_s * 1e3)):.1f}%')
    print(f'{label} training: the outer step again at the trained state: '
          f'{outer_s:.4f} s unprofiled; profiled: {idle}; host syncs '
          f"{counts['host']}, of them MoE group-size reads {counts['moe']} "
          f'({LM_K // LM_CHUNK} column chunks under torch.func, no remat '
          f'there); relative L2 '
          + ', '.join(f'{k} {e:.3e}' for k, e in errs.items())
          + f' (gate as phase 18); {check["spec"]} | {smi}', flush=True)
    del params
    torch.cuda.empty_cache()
    return got


def run_train_families(torch, dev, smi: str) -> dict:
    """Phase 23: (a) SeamlessM4T-large-v2, (b) Qwen2-VL-7B through
    ``build_train_step`` and ``lm_hypergrad``, (c) Phi-3.5-MoE through
    ``train_lm``; each at full width with its depth cut printed. Returns
    the cuda runs' launches of kernels A (gram, ``atb_tc``), B and C by
    family."""
    return {'seamless_m4t_large_v2': _train_family(
                torch, dev, smi, 'seamless_m4t_large_v2', 'seamless-m4t-v2'),
            'qwen2_vl_7b': _train_family(torch, dev, smi, 'qwen2_vl_7b',
                                         'qwen2-vl-7b'),
            'phi35_moe_42b_a66b': _train_moe(torch, dev, smi)}


# --------------------------------------------------------------------------
# Phase 24: training the recurrent families (RWKV-6, Jamba's Mamba), their
# backward and HVP columns through the time loops, sketches through A-C
# --------------------------------------------------------------------------
# RWKV-6 1.6B at its whole widths (d_model 2048, d_ff 7168, vocab 65,536),
# depth cut; the next cut where one runs out of the card's memory
RWKV_CUT = (dict(n_layers=2), '24 layers cut to 2 (p = 0.27 B) to keep '
            'phase 24 near 90 s: every layer\'s time loop is launch-bound, '
            'and at depth 4 the phase took 164 s on a slower host; for '
            'memory, in train_lm at depth 8 the outer step ran out of the '
            'card\'s memory and at depth 6 it peaked at 80.67 GB (chip runs), '
            'the HVP columns keeping the loop\'s per-step states under '
            'torch.func, ~7 GB a layer, beside the sketch\'s 32 bytes a '
            'parameter')
RWKV_LM = dict(steps=3, batch=TRAIN_B, seq=TRAIN_S, outer_every=3)
# Jamba-v0.1, one period (7 Mamba + 1 attention, 4 MoE FFNs): the training
# steps at full width with the experts cut, the hypergradient narrower
JAMBA_STEP_CUTS = (
    (dict(n_layers=8, n_experts=2, d_ff=2048), '32 layers cut to one period '
     'of 8 (7 Mamba at d_inner 8192, d_state 16, 1 attention at 32/8 heads, '
     'all at d_model 4096, vocabulary whole), its 16 experts to 2 (top-2 '
     'kept) and d_ff 14336 to 2048 (p = 1.59 B): the port\'s functional '
     'AdamW step holds the old and the new moments, the gradients, the '
     'update and the new parameters at once, about 36 bytes a parameter, '
     '122 GB at d_ff 14336 (p = 3.40 B)'),
    (dict(n_layers=8, n_experts=2, d_ff=1024), 'd_ff cut to 1024 (p = 1.44 '
     'B): the cut above ran out of memory'),
)
JAMBA_HG_CUTS = (
    (dict(n_layers=8, n_experts=2, d_model=1536, n_heads=12, n_kv_heads=4,
          d_ff=5376), 'one period, d_model 4096 cut to 1536 (12/4 heads, '
     'd_ff 5376, d_inner 3072, 2 experts; p = 0.605 B): at d_model 2048 '
     '(p = 0.985 B) the hypergradient ran out of the card\'s memory (chip '
     'run), the HVP columns keeping the Mamba loops\' per-step states '
     'under torch.func beside the sketch\'s 32 bytes a parameter'),
    (dict(n_layers=8, n_experts=2, d_model=1024, n_heads=8, n_kv_heads=4,
          d_ff=3584), 'd_model cut to 1024 as well (8/4 heads, d_ff 3584; '
     'p = 0.31 B): the cut above ran out of memory'),
)
JAMBA_HG_S = 64       # the hypergradient's batches: 8 x 64, for time
LOOP_S = 4096         # one RWKV-6 layer's backward, 1 x 4096, for its peak


def _first_fit(torch, label: str, cuts, fn):
    """``fn(cuts, why)`` for the first of ``cuts`` that fits in the card's
    memory: where one runs out, print that and take the next."""
    import gc
    for i, (cut, why) in enumerate(cuts):
        try:
            return fn(cut, why)
        except torch.cuda.OutOfMemoryError as err:
            if i + 1 == len(cuts):
                raise
            print(f'{label}: {cut} ran out of memory ({str(err)[:120]}); '
                  'taking the next cut', flush=True)
        gc.collect()
        torch.cuda.empty_cache()


@_stepped
def _loop_profile(torch, fn):
    """``fn()`` once under ``torch.profiler`` (host and card), the time
    loops' pieces (``ssm._scan_steps``, ``rwkv._wkv_steps``) under the
    range ``scan.loop``: the device time of all kernels and of the loops'
    by part, each kernel counted once, claimed by the innermost op that
    launched it. 'loop forward': kernels launched inside the range on the
    forward's thread; 'loop recompute': inside the range on another
    thread (the checkpointed chunks run again in backward); 'loop
    backward': launched by the autograd nodes of ops recorded inside the
    range (matched by the forward op's thread and sequence number). None
    where the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import rwkv, ssm
    with _ranges(torch, (ssm, '_scan_steps', 'scan.loop'),
                 (rwkv, '_wkv_steps', 'scan.loop')), profile(activities=[
                     ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function('step'):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        return None
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    main = next(e.thread for e in cpu if e.name == 'step')

    def ranged(e):
        while e is not None:
            if e.name == 'scan.loop':
                return True
            e = e.cpu_parent
        return False

    looped = {(e.thread, e.sequence_nr) for e in cpu
              if e.sequence_nr >= 0 and ranged(e)}
    nodes = {id(e) for e in cpu
             if e.name.startswith('autograd::engine::evaluate_function')
             and (e.fwd_thread, e.sequence_nr) in looped}

    def part(e):
        if ranged(e):
            return 'loop forward' if e.thread == main else 'loop recompute'
        while e is not None:
            if id(e) in nodes:
                return 'loop backward'
            e = e.cpu_parent
        return 'rest'

    split = collections.Counter()
    for e, _, us in _claimed(events, kernels):
        split['rest' if e is None else part(e)] += us / 1e3
    return {'device_ms': sum(split.values()), 'kernels': len(kernels),
            'parts': dict(split), 'matched_nodes': len(nodes)}


def _print_loop_profile(label: str, split, step_s: float,
                        counts: dict) -> None:
    if split is None:
        print(f'{label}: the profiler recorded no device events; device '
              'time not measured', flush=True)
        return
    ms = split['device_ms']
    parts = ', '.join(f'{k} {v:.3f} ms'
                      for k, v in sorted(split['parts'].items()))
    print(f'{label}: {split["kernels"]} kernels, {ms:.3f} ms of device time '
          f'against the unprofiled {step_s * 1e3:.3f} ms: device idle '
          f'{100 * (1 - ms / (step_s * 1e3)):.1f}%; by part: {parts} '
          f'({split["matched_nodes"]} autograd nodes of the loops matched); '
          f"host syncs {counts['host']}, of them MoE group-size reads "
          f"{counts['moe']}", flush=True)


@_stepped
def _loop_peak(torch, dev, smi: str, cfg) -> None:
    """One RWKV-6 layer (time mix and channel mix) of ``cfg`` at 1 ×
    ``LOOP_S``, forward and backward, with the time loop by chunks of 64
    under checkpoint and in one piece: the peak memory above the inputs
    and the seconds of each; their gradients within 1e-5."""
    from repro_torch.core import tree_flatten
    from repro_torch.models import rwkv
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import init_params
    one = dataclasses.replace(cfg, n_layers=1)
    gen = torch.Generator('cuda').manual_seed(5)
    sp = init_params(one, gen, dev)['blocks'][0]['slot0']
    leaves, treedef = tree_flatten(sp)
    x = torch.randn((1, LOOP_S, cfg.d_model), device=dev, generator=gen,
                    dtype=torch.bfloat16)
    zeros = torch.zeros((1, cfg.d_model), device=dev, dtype=torch.bfloat16)
    wkv = rwkv.init_rwkv_state(cfg, 1, dev)['wkv']
    out = {}
    for chunk in (rwkv.CHUNK, LOOP_S):
        live = [t.detach().requires_grad_(True) for t in leaves]
        p = treedef.unflatten(live)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        h, _, _ = rwkv.rwkv_time_mix(p['mixer'], rmsnorm(p['ln1'], x, 1e-5),
                                     zeros, wkv, cfg, chunk)
        y = x + h
        h, _ = rwkv.rwkv_channel_mix(p['mixer'], rmsnorm(p['ln2'], y, 1e-5),
                                     zeros, cfg)
        grads = torch.autograd.grad((y + h).float().square().mean(), live)
        torch.cuda.synchronize()
        out[chunk] = ((torch.cuda.max_memory_allocated() - base) / 1e9,
                      time.perf_counter() - t0,
                      torch.cat([g.reshape(-1).float() for g in grads]))
        del grads, h, y, p, live
    err = _rel_l2(out[rwkv.CHUNK][2], out[LOOP_S][2])
    if not err <= 1e-5:
        raise AssertionError(f'rwkv-6 layer backward: chunked vs one piece '
                             f'{err:.3e}')
    print(f'rwkv-6 training: one layer (d_model {cfg.d_model}) forward and '
          f'backward at 1 x {LOOP_S}, bf16 compute: the time loop by chunks '
          f'of {rwkv.CHUNK} under checkpoint peaks {out[rwkv.CHUNK][0]:.3f} '
          f'GB above its inputs in {out[rwkv.CHUNK][1]:.3f} s, in one piece '
          f'{out[LOOP_S][0]:.3f} GB in {out[LOOP_S][1]:.3f} s; gradients '
          f'{err:.3e} apart | {smi}', flush=True)


@_stepped
def _train_rwkv(torch, dev, smi: str) -> dict:
    """Phase 24 (a): RWKV-6 1.6B cut as ``RWKV_CUT`` says, ``train_lm``
    (``RWKV_LM``: 3 inner steps, then one outer step with a k = 8 bf16
    sketch) on 'cuda' and on 'flat', the same seeded parameters, batches
    and draws, gated by :func:`_runs_gate`. From the cuda run's state: an
    inner step profiled (:func:`_loop_profile`, against the run's last
    unprofiled one); then, AdamW
    freed, the outer step again at its own point (φ = 0, the last inner
    batch and the step's draw), profiled (its idle share against the
    run's unprofiled outer step), its IHVP against f64 and its
    hypergradient against the run's, and the runs' first hypergradients
    against each other, phase 18's gate. Then one layer's peak memory
    (:func:`_loop_peak`). Returns the cuda run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import HypergradConfig, PyTreeIndexer, make_hvp
    from repro_torch.data import TokenStream
    from repro_torch.kernels import _lib
    from repro_torch.launch.steps import (domain_losses, lm_hypergrad,
                                          loss_and_grads, make_optimizer,
                                          to_device)
    from repro_torch.launch.train import train_lm
    label = 'rwkv-6 training'
    cut, why = RWKV_CUT
    cfg = dataclasses.replace(get_config('rwkv6_1b6'), **cut)
    flat_be = blocked_flat_backend(torch, torch.bfloat16)
    configs = {'cuda': _lm_config('cuda', sketch_dtype='bfloat16'),
               'flat': HypergradConfig(solver='nystrom', k=LM_K, rho=RHO,
                                       column_chunk=LM_CHUNK,
                                       backend=flat_be)}
    runs, launches, walls, peaks = {}, {}, {}, {}
    for name in ('flat', 'cuda'):      # the cuda run's state is kept
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _lib.reset_launches()
        t0 = time.perf_counter()
        run, _ = _quiet(lambda: train_lm(cfg, configs[name], device=dev,
                                         log_every=0, **RWKV_LM))
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        launches[name] = {n: _lib.LAUNCHES[n] for n in TRAIN_ABC}
        if name == 'cuda':
            state = (run.params, run.opt_state)
        run.params = run.opt_state = None
        runs[name] = run
    got = launches['cuda']
    if not (got['nystrom_gram_tc'] == got['nystrom_gram'] == 1
            and got['woodbury_ctv'] == 3 and got['woodbury_apply'] == 2
            and not any(launches['flat'].values())):
        raise AssertionError(f'{label}: launches {launches}')
    a, b = runs['cuda'], runs['flat']
    spread = _runs_gate(label, a, b, RWKV_LM['outer_every'])
    p = sum(x.numel() for x in _leaves(state[0]))
    print(f'{label}: {smi} | depth cut: {why}; p={p:,}, f32 params, bf16 '
          f'compute, remat {cfg.remat}; train_lm {RWKV_LM}, k={LM_K}, '
          f'column_chunk={LM_CHUNK}, bf16 sketch: cuda {walls["cuda"]:.3f} '
          f's in all (init included), flat {walls["flat"]:.3f} s; s per '
          f'inner step {[round(x, 4) for x in a.step_s]}, s per outer step '
          f"{[round(o['build_s'] + o['grad_s'], 4) for o in a.outer]} "
          f"(sketch refresh {[round(o['build_s'], 4) for o in a.outer]}, "
          f"hypergradient {[round(o['grad_s'], 4) for o in a.outer]}), "
          f'inner losses {[round(x, 4) for x in a.losses]}, outer value '
          f"{[round(o['val'], 4) for o in a.outer]}; cuda vs flat "
          + ', '.join(f'{k} {e:.3e}' for k, e in spread.items())
          + f"; peak {peaks['cuda']:.2f} GB (flat {peaks['flat']:.2f}), "
          f'launches {got}', flush=True)

    params, opt_state = state
    del state
    inner, outer = domain_losses(cfg)
    optimizer = make_optimizer(cfg)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_S)
    i = RWKV_LM['steps'] - 1          # the outer step's loop index
    h = {'domain_logits': torch.zeros_like(a.outer[0]['logits'])}
    hb = to_device(stream.batch(i, TRAIN_B), dev)
    ob = to_device(stream.batch(10_000_000 + i, TRAIN_B, clean_only=True),
                   dev)

    # an inner step from the trained state, profiled; the state it reaches
    # is dropped: the outer step below is at the run's
    def inner_step():
        loss, grads = loss_and_grads(inner, params, h, hb)
        return optimizer.apply(grads, opt_state, params, RWKV_LM['steps'])

    counts = {}
    with _moe_syncs(torch, counts):
        split = _loop_profile(torch, inner_step)
    _print_loop_profile(f'{label}: an inner step', split, a.step_s[-1],
                        counts)
    del opt_state
    torch.cuda.empty_cache()

    solver = configs['cuda'].build()
    indexer = PyTreeIndexer(params)
    idx = indexer.sample_indices(torch.Generator().manual_seed(i), LM_K)
    box = {}

    def outer_step():
        sketch = solver.prepare(make_hvp(inner, params, h, hb), indexer,
                                None, indices=idx)
        _, hg = lm_hypergrad(solver, inner, outer, params, h, hb, ob,
                             state=sketch)
        box.update(sketch=sketch, hg=hg['domain_logits'])

    with _moe_syncs(torch, counts):
        busy = _kernel_ms(torch, outer_step)
    check = _ihvp_vs_f64(torch, solver, box['sketch'], params, h, hb, ob,
                         (inner, outer))
    hg = box['hg']
    box.clear()
    errs = {'u cuda vs f64': check['u'],
            'cuda vs flat': spread['first hypergradient'],
            'again vs the run': _rel_l2(hg, a.outer[0]['hypergrad']),
            'cuda vs f64': _rel_l2(hg, check['hg64']),
            'flat vs f64': _rel_l2(b.outer[0]['hypergrad'], check['hg64'])}
    _hg_gate(label, errs)
    if not errs['again vs the run'] <= 1e-5:
        raise AssertionError(f'{label}: the outer step again is not the '
                             f"run's: {errs}")
    outer_s = a.outer[0]['build_s'] + a.outer[0]['grad_s']
    idle = ('not measured (no device events)' if busy is None else
            f'{busy[1]} kernels, {busy[0]:.3f} ms of device time, idle '
            f'{100 * (1 - busy[0] / (outer_s * 1e3)):.1f}% of the run\'s '
            f'{outer_s:.4f} s')
    print(f'{label}: the outer step again at its point, profiled: {idle}; '
          f'host syncs {counts["host"]}; '
          f'relative L2 ' + ', '.join(f'{k} {e:.3e}' for k, e in errs.items())
          + f' (gate as phase 18); {check["spec"]} | {smi}', flush=True)
    del params
    torch.cuda.empty_cache()
    _loop_peak(torch, dev, smi, cfg)
    return got


@_stepped
def _train_jamba(torch, dev, smi: str) -> dict:
    """Phase 24 (b): Jamba-v0.1, one period. ``TRAIN_STEPS``
    ``build_train_step`` steps at full width with the experts cut
    (``JAMBA_STEP_CUTS``) and one more profiled (:func:`_family_steps`);
    then the hypergradient at a narrower cut (``JAMBA_HG_CUTS``) on 'cuda'
    and 'flat' (:func:`_family_hypergrad`). Returns the cuda run's
    launches."""
    from repro_torch.configs import get_config
    label = 'jamba-v0.1'
    base = get_config('jamba_v01_52b')

    def steps(cut, why):
        cfg = dataclasses.replace(base, **cut)
        params, ib, ob = _family_draw(torch, dev, cfg, label, why)
        held = [params]
        del params
        _family_steps(torch, cfg, label, held, ib, ob, profile=True)

    def hypergrad(cut, why):
        cfg = dataclasses.replace(base, **cut)
        params, ib, ob = _family_draw(
            torch, dev, cfg, label, why + f'; batches of {TRAIN_B} x '
            f'{JAMBA_HG_S}, for time (the HVP columns run the loops in one '
            'piece, 2 launches a token and Mamba layer)', JAMBA_HG_S)
        return _family_hypergrad(torch, dev, smi, cfg, label, params, ib, ob)

    _first_fit(torch, label, JAMBA_STEP_CUTS, steps)
    torch.cuda.empty_cache()
    return _first_fit(torch, label, JAMBA_HG_CUTS, hypergrad)


def run_train_recurrent(torch, dev, smi: str) -> dict:
    """Phase 24: (a) RWKV-6 1.6B through ``train_lm`` and (b) Jamba-v0.1's
    one period through ``build_train_step`` and ``lm_hypergrad``; each
    depth or width cut printed. Returns the cuda runs' launches of kernels
    A (gram, ``atb_tc``), B and C by family."""
    return {'rwkv6_1b6': _train_rwkv(torch, dev, smi),
            'jamba_v01_52b': _train_jamba(torch, dev, smi)}


PHASE_STARTS: list[tuple[str, float]] = []   # (phase, perf_counter)


# ---------------------------------------------------------------------------
# 25. The mesh on torch.distributed: spawned ranks sharing the card
# ---------------------------------------------------------------------------
MESH_K, MESH_M = 64, 32
# (a)'s leaves, p = 2^24 in all: sharded over both axes, over one,
# replicated, non-divisible (an odd length over 'data'), a scalar
MESH_LEAVES = {'w': ((4096, 2048), ('data', 'model')),
               'e': ((2048, 2048), ('model', None)),
               'r': ((1024, 2048), ()),
               'n': ((2 ** 21 - 1,), ('data',)),
               's': ((), ())}
MESH_PHI_DEPTH = 1    # one block (attention, the MoE FFN): four ranks each
#                       hold the replicated model in this slice
MESH_PHI_B, MESH_PHI_S = 1, 2048   # past attn_chunk (1024): kernel E runs;
#                       1024 tokens a data shard, Nk = 2048 > 8·E: cap 160
MESH_PHI_IDS = 8      # distinct token ids of (b)'s prompt: a repetitive one
#                       sends most replicas to a few experts, past their
#                       capacity (random ids spread them: no drop at all)
MESH_YI_DEPTH = 1     # (c): the whole HVP columns on every rank
MESH_SHAPE = {'ab': (2, 2), 'c': (1, 2)}   # (c) on 2 ranks: 4 did not fit
MESH_CAP = {'ab': 0.23, 'c': 0.45}   # each rank's share of the card
MESH_TIMEOUT = 600    # s for one spawn of ranks, their start included
# the parts of phases 25-28 by world size, each world's ranks spawned
# once and running its parts in turn (a spawn took some 10 s to start)
MESH_WORLDS = {4: ('ab', 'a4', 'b', 'd', 'e', 'ma', 'mb', 'md'),
               2: ('c', 'c2', 'mc'), 8: ('f',)}


def _rank_print(rank: int, *parts) -> None:
    print(f'[rank {rank}]', *parts, flush=True)


def _fused_results(sb):
    """The ``flat_sharded`` backend ``sb`` with ``unvec``/``unvecm`` handing
    the fused (p_local, ·) result back as it is: an apply's own passes and
    all-reduces, without the gather of whole leaves that the replicated
    model adds."""
    class Fused(type(sb)):
        def unvec(self, u, like):
            return u

        def unvecm(self, U, like):
            return U
    return Fused(mesh=sb.mesh, specs=sb.specs, sketch_dtype=sb.sketch_dtype)


def _apply_rows_gate(torch, label: str, got, C, w, v, rho,
                     rows: int = 1 << 20) -> float:
    """``got`` (rows of C's Woodbury pass 2) against ``ref.woodbury_apply``
    in f64, a block of rows at a time (phase 3's gate: rtol 1e-5, atol
    1e-5·‖ref‖∞ over all rows); the largest |err|."""
    from repro_torch.kernels import ref
    err = big = 0.0
    for r in range(0, C.shape[0], rows):
        want = ref.woodbury_apply(C[r:r + rows].double(), w.double(),
                                  v[r:r + rows].double(), rho)
        d = (got[r:r + rows].double() - want).abs()
        big = max(big, float(want.abs().max()))
        err = max(err, float((d - 1e-5 * want.abs()).max()))
    if not err <= 1e-5 * big:
        raise AssertionError(f'{label}: |err| - 1e-5|ref| {err:.3e} past '
                             f'1e-5 |ref|_inf = {1e-5 * big:.3e}')
    return err


def _sync_time(torch, fn, reps: int = 3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def _mesh_contractions(torch, dev, rank: int) -> dict:
    """Phase 25 (a), on each of 4 ranks: ``flat_sharded`` on a 2×2 mesh at
    p = 2²⁴, k = 64, m = 32 through kernels A–C, f32 and bf16 sketches;
    the all-reduces of an apply and an ``apply_matrix`` at refine 0
    counted (on the fused results, before the gather of whole leaves);
    rank 0 then holds the k-outputs against the one-rank 'cuda' backend on
    the whole buffer and against the plain versions in f64, and times
    ``apply_matrix`` on one rank."""
    import torch.distributed as dist
    from repro_torch.core import CudaBackend, NystromIHVP, NystromSketch
    from repro_torch.core.backend import flatten_vec, flatten_vecm, get_backend
    from repro_torch.core.solvers import _whitened_form
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import P
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(*MESH_SHAPE['ab'])
    specs = {n: P(*s) for n, (_, s) in MESH_LEAVES.items()}

    def inputs():
        """The whole C, v, V, w, W and an SPD H_KK, the same on every
        rank (one seed); made again where needed, not kept."""
        gen = torch.Generator(device=dev).manual_seed(25)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        leaves = sorted(MESH_LEAVES.items())
        C = {n: randn(MESH_K, *shape) for n, (shape, _) in leaves}
        v = {n: randn(*shape) for n, (shape, _) in leaves}
        V = {n: randn(*shape, MESH_M) for n, (shape, _) in leaves}
        w, W, G = randn(MESH_K), randn(MESH_K, MESH_M), randn(MESH_K,
                                                             MESH_K)
        return C, v, V, w, W, G @ G.T / MESH_K + torch.eye(MESH_K,
                                                           device=dev)

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        torch.cuda.reset_peak_memory_stats()
        sb = _fused_results(get_backend('flat_sharded', mesh=mesh,
                                        specs=specs, sketch_dtype=dtype))
        C, v, V, w, W, H_KK = inputs()
        p = out['p'] = sum(x.numel() for x in tree_leaves(v))
        op = sb.prepare_operand(C)
        del C
        vf, Vm = sb.vec(v), sb.vecm(V)
        _lib.reset_launches()
        ctx.reset_collectives()
        got = {'ctv': sb.ctv(op, vf), 'gram': sb.gram(op),
               'ctm': sb.ctm(op, Vm)}
        u = sb.combine(op, w, vf, RHO)
        U = sb.combinem(op, W, Vm, RHO)
        torch.cuda.synchronize()
        launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
        colls = dict(ctx.COLLECTIVES)
        if colls != {'psum': 3}:
            raise AssertionError(f'mesh (a) {tag}: collectives {colls}, '
                                 'want one psum each of ctv, gram, ctm')
        for name, kern in (('woodbury_ctv', 'B'), ('nystrom_cross', 'A'),
                           ('woodbury_apply', 'C'),
                           ('woodbury_apply_block', 'C')):
            if not launches.get(name):
                raise AssertionError(f'mesh (a) {tag}: kernel {kern} '
                                     f'({name}) never launched: {launches}')
        # the p-outputs are this rank's rows: their plain versions in f64
        errs = {'combine': _apply_rows_gate(
            torch, f'mesh (a) {tag} combine', u, op.buf, -(RHO * RHO) * w,
            vf, RHO), 'combinem': _apply_rows_gate(
            torch, f'mesh (a) {tag} combinem', U, op.buf, -(RHO * RHO) * W,
            Vm, RHO)}
        del u, U
        # the apply at refine 0: one all-reduce a pass
        B, gram_B = _whitened_form(sb, op, H_KK)
        sk = NystromSketch(C=op, H_KK=H_KK, indices={}, rho=RHO, B=B,
                           gram_B=gram_B)
        solver = NystromIHVP(k=MESH_K, rho=RHO, backend=sb, refine=0)
        counts = {}
        for form, fn, arg in (('apply', solver.apply, v),
                              ('apply_matrix', solver.apply_matrix, V)):
            ctx.reset_collectives()
            res = fn(sk, arg)
            counts[form] = dict(ctx.COLLECTIVES)
            if counts[form] != {'psum': 1}:
                raise AssertionError(f'mesh (a) {tag}: {form} at refine 0 '
                                     f'ran {counts[form]}, want one psum')
        secs = _sync_time(torch, lambda: solver.apply_matrix(sk, V))
        peak = torch.cuda.max_memory_allocated() / 1e9
        _rank_print(rank, f'mesh (a) {tag}: p_local {op.buf.shape[0]:,} of '
                    f'{p:,}, k={MESH_K}, m={MESH_M}: launches {launches}; '
                    f'collectives of ctv, gram, ctm {colls}; at refine 0 '
                    f'apply {counts["apply"]}, apply_matrix '
                    f'{counts["apply_matrix"]}; combine/combinem vs f64 '
                    f'max |err| {errs}; apply_matrix {secs:.4f} s; peak '
                    f'{peak:.2f} GB; weighted temporary of gram '
                    f'{op.buf.numel() * op.buf.element_size() / 1e9:.3f} GB')
        out[tag] = dict(k_out={k: t.cpu().tolist() for k, t in got.items()},
                        launches=launches, counts=counts, secs=secs,
                        peak_gb=peak, p_local=op.buf.shape[0],
                        weighted_gb=op.buf.numel() * op.buf.element_size()
                        / 1e9)
        mine = res                        # this rank's fused (p_local, m)
        del sk, B, op, vf, Vm, V, v
        torch.cuda.empty_cache()
        # rank 0: the one-rank 'cuda' backend on the whole buffer
        dist.barrier()
        if rank == 0:
            torch.cuda.set_per_process_memory_fraction(0.6)
            torch.cuda.reset_peak_memory_stats()
            cb = CudaBackend(sketch_dtype=dtype)
            C, v, V, w, W, H_KK = inputs()
            cop = cb.prepare_operand(C)
            del C
            vfull, Vfull = flatten_vec(v), flatten_vecm(V)
            one = {'ctv': cb.ctv(cop, vfull), 'gram': cb.gram(cop),
                   'ctm': cb.ctm(cop, Vfull)}
            ref64 = blocked_f64_backend(torch, dtype, rows=1 << 22)
            f64 = {'ctv': ref64.ctv(cop, vfull), 'gram': ref64.gram(cop),
                   'ctm': ref64.ctm(cop, Vfull)}
            gates = {}
            for k_, want in f64.items():
                sh = torch.tensor(out[tag]['k_out'][k_], device=dev)
                gates[k_] = _gate(f'mesh (a) {tag} {k_} vs f64', sh.double(),
                                  want, 1e-5 * float(want.abs().max()), 1e-5)
                gates[k_ + ' one rank'] = _rel_l2(one[k_], want, f64=True)
                gates[k_ + ' vs one rank'] = _rel_l2(sh, one[k_], f64=True)
            B1, gram1 = _whitened_form(cb, cop, H_KK)
            sk1 = NystromSketch(C=cop, H_KK=H_KK, indices={}, rho=RHO, B=B1,
                                gram_B=gram1)
            solver1 = NystromIHVP(k=MESH_K, rho=RHO, backend=cb, refine=0)
            U1 = solver1.apply_matrix(sk1, V)
            one_secs = _sync_time(torch,
                                  lambda: solver1.apply_matrix(sk1, V))
            # rank 0's blocks of the whole apply_matrix, fused
            u_err = _rel_l2(mine, sb.vecm(U1), f64=True)
            if not u_err <= 1e-4:
                raise AssertionError(f'mesh (a) {tag}: rank 0\'s blocks of '
                                     f'apply_matrix vs one rank {u_err:.3e}')
            peak1 = torch.cuda.max_memory_allocated() / 1e9
            _rank_print(rank, f'mesh (a) {tag} against one rank (the whole '
                        f'buffer, cuda backend): k-outputs vs f64 max |err| '
                        f'and rel L2 {gates}; apply_matrix (refine 0, '
                        f'm={MESH_M}) rank 0\'s blocks vs one rank rel L2 '
                        f'{u_err:.3e} (<= 1e-4); seconds: this rank '
                        f'{secs:.4f}, one rank {one_secs:.4f}; one-rank '
                        f'peak {peak1:.2f} GB')
            out[tag].update(gates=gates, one_rank_secs=one_secs,
                            u_err=u_err, one_rank_peak_gb=peak1)
            del cb, cop, vfull, Vfull, B1, sk1, U1, one, f64
            del v, V
            torch.cuda.empty_cache()
            torch.cuda.set_per_process_memory_fraction(MESH_CAP['ab'])
        del mine
        dist.barrier()
    return out


def _capacity_drops(torch, moe, params, h, cfg, shards: int):
    """(N, k) bool: the replicas that the capacity path drops on the MoE
    layer's input h (B, S, d) split into ``shards`` token shards, as
    ``moe_ffn`` splits it over 'data': the port's ``route`` and
    ``capacity`` on each shard, a replica dropping where its place among
    its expert's replicas reaches the capacity."""
    masks = []
    for xt in h.reshape(-1, h.shape[-1]).chunk(shards):
        _, _, expert, _, _ = moe.route(params, xt, cfg)
        flat = expert.reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, cfg.n_experts)
        slot = torch.gather(torch.cumsum(onehot, 0) - onehot, 1,
                            flat[:, None])[:, 0]
        cap = moe.capacity(flat.numel(), cfg.n_experts)
        masks.append((slot >= cap).view(expert.shape))
    return torch.cat(masks)


def _mesh_moe(torch, dev, rank: int, smi: str) -> dict:
    """Phase 25 (b), on each of 4 ranks: the Phi-3.5-MoE prefill at full
    width, depth ``MESH_PHI_DEPTH``, through the ``capacity`` path on a
    2×2 mesh (the tokens over 'data', the experts on d_ff over 'model',
    the specs of ``param_specs``), kernels D and E in the layers; rank 0
    holds its logits against the one-card ``ragged`` path on the tokens
    that no capacity drop touched (bf16 gate 2e-2, phase 20's)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe, transformer
    from repro_torch.models.transformer import forward
    cfg = dataclasses.replace(get_config('phi35_moe_42b_a66b'),
                              n_layers=MESH_PHI_DEPTH, use_pallas=True)
    mesh = make_host_mesh(*MESH_SHAPE['ab'])
    specs = param_specs(cfg, mesh)
    ffn = specs['blocks'][0]['slot0']['ffn']
    torch.cuda.reset_peak_memory_stats()
    params = _model_params(torch, cfg, 0)
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (MESH_PHI_IDS,), generator=gen)
    tokens = ids[torch.randint(0, MESH_PHI_IDS, (MESH_PHI_B, MESH_PHI_S),
                               generator=gen)].to(dev)
    seen = []                 # each MoE layer's (params, input)

    def recording(p_, h_, c_):
        seen.append((p_, h_))
        return moe.moe_ffn(p_, h_, c_)
    _lib.reset_launches()
    ctx.reset_collectives()
    with torch.inference_mode(), ctx.activation_mesh(mesh):
        forward(cfg, params, tokens)          # first call: set-up
        _lib.reset_launches()
        ctx.reset_collectives()
        transformer.moe_ffn = recording
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = forward(cfg, params, tokens)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            transformer.moe_ffn = moe.moe_ffn
        # a token is touched where any layer drops one of its replicas
        dropped = torch.stack([
            _capacity_drops(torch, moe, p_, h_, cfg, mesh.shape['data'])
            for p_, h_ in seen]).any(0).cpu()
    del seen
    launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
    colls = dict(ctx.COLLECTIVES)
    want = _kernel_counts(cfg, MESH_PHI_S)
    counts = {k: _lib.LAUNCHES[k] for k in want}
    if counts != want:
        raise AssertionError(f'mesh (b): launches {counts}, want {want}')
    peak = torch.cuda.max_memory_allocated() / 1e9
    n_drop = int(dropped.sum())
    out = dict(launches=launches, collectives=colls, secs=secs,
               peak_gb=peak, dropped=n_drop)
    line = (f'mesh (b): {smi} | Phi-3.5-MoE d={cfg.d_model}, {cfg.n_experts} '
            f'experts top-{cfg.top_k}, d_ff {cfg.d_ff} (split over model: '
            f'w1 {tuple(ffn["w1"])}, w2 {tuple(ffn["w2"])}), depth '
            f'{cfg.n_layers}, {MESH_PHI_B} x {MESH_PHI_S} tokens of '
            f'{MESH_PHI_IDS} ids over data: prefill {secs:.4f} s, capacity '
            f'{moe.capacity(MESH_PHI_B * MESH_PHI_S // 2 * cfg.top_k, cfg.n_experts)}'
            f' a shard, dropped replicas {n_drop} of '
            f'{dropped.numel()}, launches {launches}, collectives {colls}, '
            f'peak {peak:.2f} GB')
    if rank == 0:
        with torch.inference_mode():
            ref_logits, _ = forward(cfg, params, tokens)
        keep = ~dropped.any(-1).view(MESH_PHI_B, MESH_PHI_S).to(dev)
        V = cfg.vocab_size
        err = _rel_l2(logits[keep][:, :V], ref_logits[keep][:, :V])
        hit = (_rel_l2(logits[~keep][:, :V], ref_logits[~keep][:, :V])
               if bool((~keep).any()) else math.nan)
        if not err <= 2e-2:
            raise AssertionError(f'mesh (b): capacity vs ragged rel L2 '
                                 f'{err:.3e} on untouched tokens')
        line += (f'; against the one-card ragged path: rel L2 {err:.3e} '
                 f'(<= 2e-2) over {int(keep.sum())} untouched tokens, '
                 f'{hit:.3e} over the {int((~keep).sum())} with a drop')
        out.update(err=err, err_dropped=hit)
    _rank_print(rank, line)
    del params, logits
    torch.cuda.empty_cache()
    return out


def _mesh_hypergrad(torch, dev, rank: int, smi: str) -> dict:
    """Phase 25 (c), on each of 2 ranks (a 1×2 mesh): the LM trainer's
    outer step at Yi-9B's full width, depth ``MESH_YI_DEPTH``, through
    ``HypergradConfig(backend='flat_sharded', mesh, param_specs)``, a k = 8
    bf16 sketch, kernels A–C on every rank's blocks. Each rank computes
    whole HVP columns (the model is replicated) and keeps its block: the
    sketch's memory is split, the compute is not. Rank 0 then runs the
    same step through 'cuda' on one rank and holds them together (phase
    18's gates)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import HypergradConfig, PyTreeIndexer, make_hvp
    from repro_torch.core.backend import flatten_vec
    from repro_torch.data import TokenStream
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (N_DOMAINS, domain_losses,
                                          lm_hypergrad, loss_and_grads,
                                          to_device)
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config('yi_9b'), n_layers=MESH_YI_DEPTH)
    mesh = make_host_mesh(*MESH_SHAPE['c'])
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    p = sum(x.numel() for x in _leaves(params))
    h = {'domain_logits': 0.1 * torch.randn(
        N_DOMAINS, generator=torch.Generator().manual_seed(1)).to(dev)}
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=LM_FULL['seq'])
    ib = to_device(stream.batch(3, LM_FULL['batch']), dev)
    ob = to_device(stream.batch(10_000_003, LM_FULL['batch'],
                                clean_only=True), dev)
    inner_loss, outer_loss = domain_losses(cfg)
    indexer = PyTreeIndexer(params)
    idx = indexer.sample_indices(torch.Generator().manual_seed(3), LM_K)
    config = _lm_config('flat_sharded', sketch_dtype='bfloat16', mesh=mesh,
                        param_specs=param_specs(cfg, mesh))
    solver = config.build()

    def step(s):
        hvp = make_hvp(inner_loss, params, h, ib)
        sk = s.prepare(hvp, indexer, None, indices=idx)
        val, hg = lm_hypergrad(s, inner_loss, outer_loss, params, h, ib, ob,
                               state=sk)
        return sk, val, hg['domain_logits']

    step(solver)                          # first call: set-up
    torch.cuda.empty_cache()
    _lib.reset_launches()
    ctx.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sk, val, hg = step(solver)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
    colls = dict(ctx.COLLECTIVES)
    for name in ('nystrom_cross_tc', 'woodbury_ctv', 'woodbury_apply'):
        if not launches.get(name):
            raise AssertionError(f'mesh (c): {name} never launched: '
                                 f'{launches}')
    _, g_theta = loss_and_grads(lambda th: outer_loss(th, h, ob), params)
    # where the step's time goes: its apply with and without u's gather
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_sh = flatten_vec(solver.apply(sk, g_theta))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fused = dataclasses.replace(solver,
                                backend=_fused_results(solver.backend))
    fused.apply(sk, g_theta)
    torch.cuda.synchronize()
    split = {'apply with the gather of u': t1 - t0,
             'apply without it': time.perf_counter() - t1}
    sketch_gb = (sk.C.buf.numel() * sk.C.buf.element_size()
                 + sk.B.buf.numel() * sk.B.buf.element_size()) / 1e9
    p_local = sk.C.buf.shape[0]
    peak = torch.cuda.max_memory_allocated() / 1e9
    del sk
    out = dict(p=p, p_local=p_local, secs=secs, launches=launches,
               collectives=colls, peak_gb=peak, sketch_gb=sketch_gb,
               hg=hg.cpu().tolist(), val=float(val), split=split)
    _rank_print(rank, f'mesh (c): {smi} | Yi-9B d={cfg.d_model}, heads '
                f'{cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab '
                f'{cfg.vocab_size}, depth {cfg.n_layers}: p={p:,}, this '
                f'rank\'s p_local {p_local:,} ({mesh.coords}); outer step '
                f'(HVP columns, prepare, apply with the mixed term; after a '
                f'first one) {secs:.4f} s, value {float(val):.4f}, launches {launches}, '
                f'collectives {colls}, this rank\'s C and B '
                f'{sketch_gb:.2f} GB, peak {peak:.2f} GB; one apply '
                + ', '.join(f'{k} {v:.4f} s' for k, v in split.items()))
    dist.barrier()
    if rank != 0:
        del params, g_theta, u_sh
        torch.cuda.empty_cache()
        dist.barrier()
        return out
    dist.barrier()                      # the other ranks have let go
    torch.cuda.set_per_process_memory_fraction(0.9)
    torch.cuda.reset_peak_memory_stats()
    one = _lm_config('cuda', sketch_dtype='bfloat16').build()
    step(one)                             # first call: set-up, as above
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sk1, _, hg1 = step(one)
    torch.cuda.synchronize()
    one_secs = time.perf_counter() - t0
    u1 = flatten_vec(one.apply(sk1, g_theta))
    ref64 = blocked_f64_backend(torch, torch.bfloat16)
    sk64 = dataclasses.replace(sk1, gram_B=ref64.gram(sk1.B))
    u64 = flatten_vec(dataclasses.replace(one, backend=ref64).apply(
        sk64, g_theta))
    errs = {'hypergradient flat_sharded vs cuda': _rel_l2(hg, hg1, True),
            'u flat_sharded vs f64': _rel_l2(u_sh, u64, True),
            'u cuda vs f64': _rel_l2(u1, u64, True),
            'u flat_sharded vs cuda': _rel_l2(u_sh, u1, True)}
    peak1 = torch.cuda.max_memory_allocated() / 1e9
    ok = (errs['hypergradient flat_sharded vs cuda'] <= 1e-4
          or errs['u flat_sharded vs f64'] <= 1e-4)
    _rank_print(rank, f'mesh (c) against one rank (cuda, the whole bf16 '
                f'sketch): {", ".join(f"{k} {e:.3e}" for k, e in errs.items())}'
                f' (gate: the hypergradient <= 1e-4, or u vs f64 <= 1e-4); '
                f'seconds: this rank {secs:.4f}, one rank {one_secs:.4f}; '
                f'one-rank peak {peak1:.2f} GB')
    if not ok:
        raise AssertionError(f'mesh (c): {errs}')
    out.update(errs=errs, one_rank_secs=one_secs, one_rank_peak_gb=peak1)
    del sk1, sk64, u1, u64, u_sh, params, g_theta
    torch.cuda.empty_cache()
    return out


def mesh_rank_main(parts: str, rank: int, world: int, out_dir: str) -> None:
    """One rank of phases 25-28: joins a gloo group (several ranks
    share the card: NCCL refuses two ranks on one GPU, and gloo
    all-reduces CUDA tensors through the host) through a ``file://`` store
    in ``out_dir``, loads phase 2's kernel build (never ``nvcc``), runs
    each of ``parts`` (comma-separated) in turn, its share of the card's
    memory capped for each, and writes ``rank<r>.json``: each part's
    result and seconds."""
    import gc
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(2)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _lib
    dev = resolve_device(None)            # also switches TF32 off
    if not _lib.library_path().exists():
        raise SystemExit('phase 25 ranks load phase 2\'s kernel build, and '
                         'there is none')
    _lib.lib()
    smi = os.environ.get('CHIP_SMOKE_SMI', '')
    dist.init_process_group('gloo', init_method=f'file://{out_dir}/rendezvous',
                            rank=rank, world_size=world)
    out = {}
    try:
        for part in parts.split(','):
            torch.cuda.set_per_process_memory_fraction(
                MESH_CAP[part] if part in MESH_CAP else
                {**SPLIT_PARTS, **SERVE_PARTS, **MOE_PARTS}[part][1])
            dist.barrier()                # every rank has let the last go
            t0 = time.perf_counter()
            if part == 'ab':
                res = {'a': _mesh_contractions(torch, dev, rank),
                       'b': _mesh_moe(torch, dev, rank, smi)}
            elif part == 'c':
                res = {'c': _mesh_hypergrad(torch, dev, rank, smi)}
            elif part == 'a4':
                res = _split_prefill(torch, dev, rank, smi, part)
            elif part == 'b':
                res = _split_train(torch, dev, rank, smi)
            elif part in SERVE_PARTS:
                res = _serve_split(torch, dev, rank, smi, part)
            elif part in MOE_SERVE:
                res = _moe_serve(torch, dev, rank, smi, part)
            elif part == 'mb':
                res = _moe_train(torch, dev, rank, smi)
            elif part == 'mc':
                res = _moe_hypergrad(torch, dev, rank, smi)
            else:
                res = _split_hypergrad(torch, dev, rank, smi, part)
            out[part] = dict(res=res, secs=time.perf_counter() - t0)
            del res
            gc.collect()
            torch.cuda.empty_cache()
        Path(out_dir, f'rank{rank}.json').write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


@_stepped
def _spawn_world(parts: tuple, world: int, smi: str) -> dict:
    """Phases 25's and 26's ``parts`` on one world of ``world`` ranks,
    spawned together (each re-enters this script with ``--mesh-rank``) and
    running the parts in turn, so that each rank starts once: their lines
    printed, and each part's results by rank. A rank that fails or
    outlasts ``MESH_TIMEOUT`` fails the phase."""
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix=f'chip_smoke_mesh_{world}_'))
    env = dict(os.environ, PYTHONPATH=str(SRC), CHIP_SMOKE_SMI=smi)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), '--mesh-rank',
         ','.join(parts), str(r), str(world), str(tmp)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs, failed = [''] * world, None
    try:
        for r, proc in enumerate(procs):
            left = max(1.0, MESH_TIMEOUT - (time.perf_counter() - t0))
            logs[r], _ = proc.communicate(timeout=left)
    except subprocess.TimeoutExpired:
        failed = f'a rank ran past {MESH_TIMEOUT} s'
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                rest, _ = proc.communicate()
                logs[procs.index(proc)] += rest or ''
    for r, log in enumerate(logs):
        for line in log.strip().splitlines():
            print(line if line.startswith('[rank') else
                  f'[rank {r}] {line}', flush=True)
    bad = [r for r, proc in enumerate(procs) if proc.returncode != 0]
    if failed or bad:
        raise AssertionError(f'mesh {parts}: {failed or ""} ranks {bad} '
                             'failed')
    ranks = [json.loads((tmp / f'rank{r}.json').read_text())
             for r in range(world)]
    shutil.rmtree(tmp, ignore_errors=True)
    print(f'mesh {",".join(parts)}: {world} ranks in '
          f'{time.perf_counter() - t0:.1f} s, their start included; by part '
          + ', '.join(f'{part} {max(r[part]["secs"] for r in ranks):.1f} s'
                      for part in parts), flush=True)
    return {part: [r[part]['res'] for r in ranks] for part in parts}


def run_worlds(torch, smi: str) -> dict:
    """Phases 25-28 as three worlds of spawned ranks sharing ``cuda:0``
    over gloo: ``MESH_WORLDS``' parts, each world's ranks starting after
    phase 2's build and loading it. Returns each part's results by
    rank."""
    from repro_torch.kernels import _lib
    if not _lib.library_path().exists():
        raise AssertionError('phase 25 needs phase 2\'s kernel build')
    torch.cuda.empty_cache()
    print(f'mesh: gloo over one card ({smi}): ranks share cuda:0, every '
          'all_reduce is staged through the host', flush=True)
    for part, why in SPLIT_CUTS.items():
        print(f'split {part}: cut: {why}', flush=True)
    for what, cut in SERVE_CUTS.items():
        print(f'serve {what}: {cut}: {TIME_CUT_WHY}', flush=True)
    for what, why in MOE_CUTS.items():
        print(f'moe {what}: cut: {why}', flush=True)
    out = {}
    for world, parts in MESH_WORLDS.items():
        out.update(_spawn_world(parts, world, smi))
    return out


def run_mesh(out: dict) -> dict:
    """Phase 25: the mesh of ``torch.distributed`` on one card, as spawned
    ranks sharing ``cuda:0`` over gloo (host-staged all-reduces: no claim
    of NCCL's speed or of the contract's "no host transfer"): (a) and (b)
    on a 2×2 mesh of 4 ranks, (c) on a 1×2 mesh of 2, from
    :func:`run_worlds`' results ``out``. The ranks must agree. Returns
    each part's per-rank results."""
    a, b, c = ([r['a'] for r in out['ab']], [r['b'] for r in out['ab']],
               [r['c'] for r in out['c']])
    for tag in ('float32', 'bfloat16'):
        k_outs = [r[tag]['k_out'] for r in a]
        if any(k != k_outs[0] for k in k_outs):
            raise AssertionError(f'mesh (a) {tag}: ranks disagree on the '
                                 'all-reduced k-outputs')
    if any(r['hg'] != c[0]['hg'] for r in c):
        raise AssertionError('mesh (c): ranks disagree on the hypergradient')
    if len({r['dropped'] for r in b}) != 1:
        raise AssertionError('mesh (b): ranks disagree on the drops')
    return {'a': a, 'b': b, 'c': c}


# ---------------------------------------------------------------------------
# 26. A model split on the mesh: the dense family's steps over gloo ranks
# ---------------------------------------------------------------------------
SPLIT_PARTS = {   # part: (mesh shape, each rank's share of the card)
    'a4': ((1, 4), 0.2), 'b': ((2, 2), 0.2), 'c2': ((1, 2), 0.4)}
# Parts run once (chip run, PR 29; PERF.md §6) and then cut for the whole
# script's time, their reasons printed: the prefill on 1 × 8 ('a8', the KV
# heads whole; tests/test_torch_cuda.py's split prefill reads whole KV heads
# through kernel E instead) and the hypergradient on 1 × 4 ('c4').
# (c) on 2 × 2 ran out of memory at 18.61 GiB a rank in the apply: the
# vocab tables split over 'model' only leave p_local ≈ 305 M there, and C,
# B and the apply's f32 vectors of four such ranks do not fit one card.
# The 2 × 2 (FSDP) hypergradient is held by the CPU tests
# (tests/test_torch_split_hypergrad.py), 2 × 2 FSDP on the card by (b).
SPLIT_CUTS = {'a8': 'phase 26 needs its time inside the 1200 s limit; the '
              'whole KV heads are read through kernel E by '
              'tests/test_torch_cuda.py (phase 3)',
              'c4': 'phase 26 needs its time inside the 1200 s limit; '
              '1 x 2 holds the hypergradient on the card'}
SPLIT_PREFILL_DEPTH = 4     # (a): Yi-9B's 48 layers cut to 4, one 1 x 4096
SPLIT_PREFILL_S = 4096
SPLIT_TRAIN_DEPTH = 2       # (b): phase 18's cut, 8 x 128, 2 steps
SPLIT_HG_DEPTH = 1          # (c): phase 25 (c)'s cut (p = 0.70 B)
SPLIT_ONE_RANK_CAP = 0.85   # rank 0's share for the one-rank run


def _split_blocks(torch, dev, cfg, mesh, seed: int = 0):
    """The whole model drawn on the card from ``seed`` (every rank draws
    the same), this rank's blocks of it, and the spec tree."""
    from repro_torch.core import tree_leaves
    from repro_torch.models import build_model
    from repro_torch.models.split import shard_params, split_specs
    whole = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    specs = split_specs(cfg, mesh)
    blocks = shard_params(whole, specs, mesh)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(blocks))
    whole_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(whole))
    return whole, blocks, specs, nbytes, whole_bytes


def _split_prefill(torch, dev, rank: int, smi: str, part: str) -> dict:
    """Phase 26 (a), on each rank of 1 × 4 (8 q heads and 1 KV head a
    rank) or 1 × 8 (4 q heads a rank; the 4 KV heads stay whole and each
    rank reads the one its heads share; cut, ``SPLIT_CUTS``): Yi-9B's
    prefill at full width,
    depth ``SPLIT_PREFILL_DEPTH``, bf16, one 1 × ``SPLIT_PREFILL_S``
    prompt, through kernels D and E on the rank's heads. Rank 0 holds the
    gathered logits against one rank's unsplit prefill of the same weights
    (phase 10's bf16 gate, 2e-2)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_prefill_step
    cfg = dataclasses.replace(get_config('yi_9b'),
                              n_layers=SPLIT_PREFILL_DEPTH, use_pallas=True,
                              param_dtype='bfloat16')
    mesh = make_host_mesh(*SPLIT_PARTS[part][0])
    whole, blocks, specs, nbytes, whole_bytes = _split_blocks(
        torch, dev, cfg, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (1, SPLIT_PREFILL_S),
                           generator=torch.Generator().manual_seed(1))
    step = build_prefill_step(cfg, mesh=mesh)
    step(blocks, {'inputs': tokens})          # first call: set-up
    if rank != 0:
        del whole
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = step(blocks, {'inputs': tokens})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {'rmsnorm': 2 * cfg.n_layers, 'flash_attention': cfg.n_layers,
            'flash_attention_tc': cfg.n_layers}
    got = {k: _lib.LAUNCHES[k] for k in want}
    if got != want:
        raise AssertionError(f'split (a) {part}: launches {got}, want {want}')
    if (tuple(logits.shape) != (1, cfg.padded_vocab)
            or not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all())):
        raise AssertionError(f'split (a) {part}: logits '
                             f'{tuple(logits.shape)} not finite')
    wq = specs['blocks'][0]['slot0']['mixer']
    out = dict(launches=launches, secs=secs, peak_gb=peak,
               param_gb=nbytes / 1e9, whole_gb=whole_bytes / 1e9,
               logits_sum=float(logits.float().sum()))
    line = (f'split (a) {part}: {smi} | Yi-9B d={cfg.d_model}, heads '
            f'{cfg.n_heads}/{cfg.n_kv_heads} over model={mesh.shape["model"]}'
            f' (wq {tuple(wq["wq"])}, wk {tuple(wq["wk"])}), depth '
            f'{cfg.n_layers}, bf16, 1 x {SPLIT_PREFILL_S}: prefill '
            f'{secs * 1e3:.3f} ms, this rank\'s parameters '
            f'{nbytes / 1e9:.3f} GB of {whole_bytes / 1e9:.3f} GB, peak '
            f'{peak:.2f} GB, launches {launches}')
    if rank == 0:
        one = build_prefill_step(cfg)
        one(whole, {'inputs': tokens})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_logits = one(whole, {'inputs': tokens})
        torch.cuda.synchronize()
        one_secs = time.perf_counter() - t0
        V = cfg.vocab_size
        err = _rel_l2(logits[:, :V], ref_logits[:, :V])
        if not err <= 2e-2:
            raise AssertionError(f'split (a) {part}: against one rank rel '
                                 f'L2 {err:.3e}')
        line += (f'; one rank\'s unsplit prefill {one_secs * 1e3:.3f} ms, '
                 f'gathered logits against it rel L2 {err:.3e} (<= 2e-2)')
        out.update(err=err, one_rank_secs=one_secs)
        del whole, ref_logits
    _rank_print(rank, line)
    del blocks, logits
    torch.cuda.empty_cache()
    return out


def _split_train(torch, dev, rank: int, smi: str) -> dict:
    """Phase 26 (b), on each rank of 2 × 2 with ``fsdp``: two
    ``build_train_step`` steps on Yi-9B at full width, depth
    ``SPLIT_TRAIN_DEPTH`` (f32 parameters, bf16 compute, remat 'full'),
    8 × 128 tokens (4 rows a data shard), every weight over both axes.
    Rank 0 then runs one rank's unsplit step on the same weights and
    batches: losses and gradient norms within 2e-2 relative (bf16
    compute: the split sums partial products rounded to bf16)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import tree_leaves
    from repro_torch.data import TokenStream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step, make_optimizer
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config('yi_9b'),
                              n_layers=SPLIT_TRAIN_DEPTH, remat='full',
                              fsdp=True)
    mesh = make_host_mesh(*SPLIT_PARTS['b'][0])
    whole, blocks, specs, nbytes, whole_bytes = _split_blocks(
        torch, dev, cfg, mesh)
    del whole                 # rank 0 draws it again for one rank's steps
    torch.cuda.empty_cache()
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=LM_FULL['seq'])
    batches = [stream.batch(i, LM_FULL['batch']) for i in range(2)]
    step = build_train_step(cfg, mesh=mesh)
    opt = make_optimizer(cfg)
    state = opt.init(blocks)
    opt_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(state))
    torch.cuda.reset_peak_memory_stats()
    losses, norms, secs = [], [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks, state, _, m = step(blocks, state, i, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f'split (b): losses {losses}, norms {norms}')
    out = dict(losses=losses, norms=norms, secs=secs, peak_gb=peak,
               param_gb=nbytes / 1e9, opt_gb=opt_bytes / 1e9,
               whole_gb=whole_bytes / 1e9)
    line = (f'split (b): {smi} | Yi-9B d={cfg.d_model}, depth '
            f'{cfg.n_layers}, f32 parameters, bf16 compute, remat full, fsdp '
            f'on 2x2 ({mesh.coords}), {LM_FULL["batch"]} x {LM_FULL["seq"]}:'
            f' steps {[round(s, 4) for s in secs]} s, losses {losses}, grad '
            f'norms {norms}; this rank\'s parameters {nbytes / 1e9:.3f} GB '
            f'(whole {whole_bytes / 1e9:.3f} GB), optimizer state '
            f'{opt_bytes / 1e9:.3f} GB, peak {peak:.2f} GB')
    _rank_print(rank, line)
    del blocks, state
    torch.cuda.empty_cache()
    dist.barrier()                          # the other ranks have let go
    if rank == 0:
        torch.cuda.set_per_process_memory_fraction(SPLIT_ONE_RANK_CAP)
        whole = build_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        one = build_train_step(cfg)
        ostate = opt.init(whole)
        torch.cuda.reset_peak_memory_stats()
        one_l, one_n, one_s = [], [], []
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole, ostate, _, m = one(whole, ostate, i, b)
            torch.cuda.synchronize()
            one_s.append(time.perf_counter() - t0)
            one_l.append(float(m['loss']))
            one_n.append(float(m['grad_norm']))
        errs = [abs(a / b - 1) for a, b in zip(losses + norms, one_l + one_n)]
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        _rank_print(rank, f'split (b) against one rank (unsplit, the same '
                    f'weights and batches): losses {one_l}, grad norms '
                    f'{one_n}, steps {[round(s, 4) for s in one_s]} s, peak '
                    f'{one_peak:.2f} GB; largest relative gap '
                    f'{max(errs):.3e} (<= 2e-2)')
        if not max(errs) <= 2e-2:
            raise AssertionError(f'split (b): against one rank {errs}')
        out.update(one_rank=dict(losses=one_l, norms=one_n, secs=one_s,
                                 peak_gb=one_peak), err=max(errs))
        del whole, ostate
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _split_hypergrad(torch, dev, rank: int, smi: str, part: str) -> dict:
    """Phase 26 (c), on each rank of 1 × 2 (phase 25
    (c)'s mesh; 1 × 4 is cut, ``SPLIT_CUTS``): ``build_hypergrad_step`` on
    Yi-9B at full width, depth
    ``SPLIT_HG_DEPTH``, a k = 8 bf16 sketch through ``flat_sharded`` over
    the rank's blocks: the HVP columns through the model's collectives,
    kernels A–C on the rank's (p_local, k) buffer. f32 compute, so that
    the split and one rank's run differ by f32 rounding only. Then one
    apply alone: no gather, one all-reduce a k-output pass. On 1 × 2 rank
    0 also runs one rank's unsplit step ('cuda', the whole bf16 sketch),
    which the parent holds both meshes' hypergradients against (1e-3)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import HypergradConfig, PyTreeIndexer, make_hvp
    from repro_torch.data import TokenStream
    from repro_torch.distributed import ctx
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (N_DOMAINS, build_hypergrad_step,
                                          domain_losses, lm_hypergrad,
                                          local_batch, loss_and_grads,
                                          split_solver, to_device)
    from repro_torch.models.split import make_split
    cfg = dataclasses.replace(get_config('yi_9b'), n_layers=SPLIT_HG_DEPTH,
                              compute_dtype='float32')
    mesh = make_host_mesh(*SPLIT_PARTS[part][0])
    whole, blocks, specs, nbytes, whole_bytes = _split_blocks(
        torch, dev, cfg, mesh)
    if not (part == 'c2' and rank == 0):
        del whole
    torch.cuda.empty_cache()
    h = {'domain_logits': 0.1 * torch.randn(
        N_DOMAINS, generator=torch.Generator().manual_seed(1)).to(dev)}
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=LM_FULL['seq'])
    ib = stream.batch(3, LM_FULL['batch'])
    ob = stream.batch(10_000_003, LM_FULL['batch'], clean_only=True)
    hg_cfg = HypergradConfig(k=LM_K, rho=RHO, sketch_dtype='bfloat16',
                             column_chunk=2)
    step = build_hypergrad_step(cfg, mesh=mesh, hg_cfg=hg_cfg)
    split = make_split(cfg, mesh, LM_FULL['batch'], specs)
    solver = split_solver(mesh, specs, hg_cfg)   # the step's, for its pieces
    indexer = solver.backend.indexer(blocks)
    # over the whole leaves: the draw one rank's indexer makes at this seed
    idx = indexer.sample_indices(torch.Generator().manual_seed(3), LM_K)
    inner, outer = domain_losses(cfg, split)
    ib_l, ob_l = (local_batch(b, split, dev) for b in (ib, ob))
    # first: the hypergradient straight from lm_hypergrad (the set-up
    # call), and one apply alone on its state
    sk = solver.prepare(make_hvp(inner, blocks, h, ib_l), indexer, None,
                        indices=idx)
    _, hg_direct = lm_hypergrad(solver, inner, outer, blocks, h, ib_l, ob_l,
                                state=sk)
    _, g_theta = loss_and_grads(lambda p: outer(p, h, ob_l), blocks)
    _lib.reset_launches()
    ctx.reset_collectives()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    solver.apply(sk, g_theta)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t1
    apply_colls = dict(ctx.COLLECTIVES)
    passes = _lib.LAUNCHES['woodbury_ctv'] + _lib.LAUNCHES['nystrom_cross']
    if apply_colls != {'psum': passes}:
        raise AssertionError(f'split (c) {part}: one apply ran '
                             f'{apply_colls}, want one psum for each of its '
                             f'{passes} k-output passes and no gather')
    c_gb = sk.C.buf.numel() * sk.C.buf.element_size() / 1e9
    b_gb = sk.B.buf.numel() * sk.B.buf.element_size() / 1e9
    p_local = int(sk.C.buf.shape[0])
    del sk, g_theta
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    ctx.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_h = step(blocks, h, ib, ob, indices=idx)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
    colls = dict(ctx.COLLECTIVES)
    for name in ('nystrom_cross_tc', 'woodbury_ctv', 'woodbury_apply'):
        if not launches.get(name):
            raise AssertionError(f'split (c) {part}: {name} never '
                                 f'launched: {launches}')
    peak = torch.cuda.max_memory_allocated() / 1e9
    hg = (h['domain_logits'] - new_h['domain_logits']) / 1e-2
    out = dict(secs=secs, launches=launches, collectives=colls,
               apply_collectives=apply_colls, apply_s=apply_s,
               p_local=p_local, p=indexer.total, c_gb=c_gb, b_gb=b_gb,
               peak_gb=peak,
               param_gb=nbytes / 1e9, hg=hg.cpu().tolist(),
               hg_direct=hg_direct['domain_logits'].cpu().tolist())
    _rank_print(rank, f'split (c) {part}: {smi} | Yi-9B d={cfg.d_model}, '
                f'depth {cfg.n_layers}, f32 compute, on '
                f'{dict(mesh.shape)} ({mesh.coords}), k={LM_K} bf16 sketch: '
                f'outer step {secs:.4f} s (after a first one), this rank\'s '
                f'p_local {p_local:,} of {indexer.total:,}, C {c_gb:.3f} GB, '
                f'B {b_gb:.3f} GB, parameters {nbytes / 1e9:.3f} GB, peak '
                f'{peak:.2f} GB, launches {launches}, collectives {colls}; '
                f'one apply {apply_s:.4f} s with {apply_colls} '
                f'({passes} k-output passes, no gather)')
    dist.barrier()
    if part == 'c2' and rank == 0:
        del blocks
        torch.cuda.empty_cache()
        dist.barrier()                      # the other rank has let go
        torch.cuda.set_per_process_memory_fraction(SPLIT_ONE_RANK_CAP)
        torch.cuda.reset_peak_memory_stats()
        one = _lm_config('cuda', sketch_dtype='bfloat16').build()
        il, ol = domain_losses(cfg)
        ib_w, ob_w = to_device(ib, dev), to_device(ob, dev)

        def one_step():
            sk1 = one.prepare(make_hvp(il, whole, h, ib_w),
                              PyTreeIndexer(whole), None, indices=idx)
            return lm_hypergrad(one, il, ol, whole, h, ib_w, ob_w,
                                state=sk1)[1]['domain_logits']
        one_step()                                # first call: set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hg1 = one_step()
        torch.cuda.synchronize()
        out.update(one_rank_secs=time.perf_counter() - t0,
                   one_rank_hg=hg1.cpu().tolist(),
                   one_rank_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del whole
        torch.cuda.empty_cache()
    elif part == 'c2':
        del blocks
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def run_split(torch, smi: str, mesh25: dict, out: dict) -> dict:
    """Phase 26: the dense family's steps over a model split on the mesh,
    as spawned ranks sharing ``cuda:0`` over gloo (phase 25's way): (a)
    the prefill on 1 × 4, (b) two train steps on 2 × 2 with FSDP, (c) the
    hypergradient on 1 × 2, from :func:`run_worlds`' results ``out``. Each
    part is held against one rank's unsplit run; the ranks must agree.
    Returns each part's per-rank results."""
    out = {part: out[part] for part in SPLIT_PARTS}
    sums = {r['logits_sum'] for r in out['a4']}
    if len(sums) != 1:
        raise AssertionError(f'split (a) a4: ranks disagree: {sums}')
    b = out['b']
    if any(r['losses'] != b[0]['losses'] or r['norms'] != b[0]['norms']
           for r in b):
        raise AssertionError('split (b): ranks disagree on losses or norms')
    one = out['c2'][0]
    for part in ('c2',):
        if any(r['hg'] != out[part][0]['hg'] for r in out[part]):
            raise AssertionError(f'split (c) {part}: ranks disagree')
        want = torch.tensor(one['one_rank_hg'])
        # the timed build_hypergrad_step's, then lm_hypergrad's on the
        # same solver's pieces
        err, err_direct = (_rel_l2(torch.tensor(out[part][0][key]), want,
                                   True) for key in ('hg', 'hg_direct'))
        if not (err <= 1e-3 and err_direct <= 1e-3):
            raise AssertionError(f'split (c) {part}: hypergradient against '
                                 f'one rank rel L2 {err:.3e} (the step), '
                                 f'{err_direct:.3e} (lm_hypergrad)')
        out[part][0].update(err=err, err_direct=err_direct)
        print(f'split (c) {part}: {smi} | hypergradient of the timed step '
              f'against one rank\'s unsplit one (cuda, whole bf16 sketch) '
              f'rel L2 {err:.3e} (<= 1e-3; lm_hypergrad on the step\'s '
              f'solver {err_direct:.3e}); outer step a rank '
              f'{[round(r["secs"], 4) for r in out[part]]} s, one rank '
              f'{one["one_rank_secs"]:.4f} s (peak '
              f'{one["one_rank_peak_gb"]:.2f} GB); phase 25 (c) on this run '
              f'(the replicated model, bf16 compute): '
              f'{[round(r["secs"], 4) for r in mesh25["c"]]} s a rank, one '
              f'rank {mesh25["c"][0].get("one_rank_secs", math.nan):.4f} s',
              flush=True)
    return out


# ---------------------------------------------------------------------------
# 27. Decode over a split model; Qwen2-VL and Seamless split on the mesh
# ---------------------------------------------------------------------------
SERVE_PARTS = {   # part: (mesh shape, each rank's share of the card)
    'd': ((1, 4), 0.2), 'e': ((1, 4), 0.2), 'f': ((1, 8), 0.1)}
SERVE_STEPS = 8      # teacher-forced decode steps a part (cut from 16)
# With phase 27 whole, the script took 1,086.1 s on one host (NVIDIA H100
# 80GB HBM3, 700.00 W), past the 900 s that keeps a slower host inside the
# 1200 s limit; the cuts, in the order the time budget takes them, each
# printed with its reason when the run starts
TIME_CUT_WHY = ('the whole script took 1,086.1 s on one host, past the 900 s '
                'that keeps a slower host inside its 1200 s limit')
SERVE_CUTS = {'decode steps': 'cut from 16 to 8 a part',
              '(b) SeamlessM4T': 'depth cut from 4 + 4 to 2 + 2'}
# (a) Yi-9B: phase 26 (a)'s depth; (b) Seamless: 2 + 2 layers (cut from
# 4 + 4), a 1 x 4096 prefill over 4096 frames, decode over 4096 frames; (c)
# Qwen2-VL: 28 heads padded to 32 over 8 ranks, a 1 x 4096 prefill of
# embeddings with an image's (t, h, w) ids
SERVE_CASES = {
    'd': dict(arch='yi_9b', label='(a) Yi-9B', depth=4, B=32, smax=8192),
    'e': dict(arch='seamless_m4t_large_v2', label='(b) SeamlessM4T',
              depth=2, B=8, smax=4096, prefill=4096),
    'f': dict(arch='qwen2_vl_7b', label='(c) Qwen2-VL-7B', depth=2, B=8,
              smax=4096, prefill=4096)}


def _serve_inputs(torch, cfg, B: int, steps: int) -> list:
    """One decode step's (B, 1) tokens, or (B, 1, d) bf16 embeddings on
    the card, for each of ``steps`` teacher-forced steps, drawn from a
    seed (every rank draws the same)."""
    if cfg.embed_inputs or cfg.is_encdec:
        gen = torch.Generator().manual_seed(5)
        return [torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
                for _ in range(steps)]
    gen = torch.Generator('cuda').manual_seed(5)
    return [torch.randn((B, 1, cfg.d_model), dtype=torch.bfloat16,
                        device='cuda', generator=gen) for _ in range(steps)]


def _seeded_cache(torch, cfg, B: int, smax: int, pos: int):
    """The whole decode cache with every self-attention k and v drawn
    from a seed on the card (as a prompt of ``pos`` tokens and more would
    have left it) and ``pos`` set: the decode's steps cross from the
    second-last rank's block of the sequence into the last one's."""
    from repro_torch.models.transformer import init_cache
    cache = init_cache(cfg, B, smax)
    gen = torch.Generator('cuda').manual_seed(7)
    for sc in cache['slots'].values():
        for t in sc.values():
            t.normal_(generator=gen)
    cache['pos'].fill_(pos)
    return cache


def _timed_decode(torch, step, params, inputs, cache, sizes=None):
    """Every teacher-forced step: (each step's logits, the cache, each
    step's seconds); ``sizes`` collects every all-reduce's entries."""
    import torch.distributed as dist
    logits, secs, reduce = [], [], dist.all_reduce

    def recorded(t, *args, **kwargs):
        sizes.append(t.numel())
        return reduce(t, *args, **kwargs)

    if sizes is not None:
        dist.all_reduce = recorded
    try:
        for inp in inputs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, cache = step(params, inp, cache)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            logits.append(out)
    finally:
        dist.all_reduce = reduce
    return logits, cache, secs


def _serve_split(torch, dev, rank: int, smi: str, part: str) -> dict:
    """Phase 27, on each rank of ``SERVE_PARTS[part]``'s mesh: a model
    split on it serves. Where ``SERVE_CASES`` gives a prefill, one
    1 × S prefill through kernels D and E on the rank's (padded) heads
    (Seamless: its encoder non-causal over as many frames), gathered and
    held against one rank's unsplit prefill (2e-2); then ``SERVE_STEPS``
    teacher-forced decode steps through ``build_serve_step(mesh=)`` over
    the rank's block of the KV cache's sequence (filled from a seed up to
    ``pos`` = 3/4 or 7/8 of the cache, less half the steps: they cross
    into the last rank's block; Seamless's cross cache filled by ``encode`` and
    ``fill_cross_cache`` with its encoder positions over 'model'), each
    step's gathered logits held against one rank's ``decode_step`` on the
    same tokens (2e-2, the bf16 decode gate). Prints the cache's bytes a
    rank, the collectives a step by kind and their largest size against a
    layer's cache block, seconds a step against one rank's, and peak
    memory."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import ctx
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.split import (cache_split_specs, make_split,
                                          shard_cache)
    from repro_torch.models.transformer import encode, fill_cross_cache
    case = SERVE_CASES[part]
    base = get_config(case['arch'])
    cfg = dataclasses.replace(base, n_layers=case['depth'], use_pallas=True,
                              param_dtype='bfloat16',
                              n_enc_layers=(case['depth'] if base.is_encdec
                                            else 0))
    mesh = make_host_mesh(*SERVE_PARTS[part][0])
    m = mesh.shape['model']
    whole, blocks, specs, nbytes, whole_bytes = _split_blocks(
        torch, dev, cfg, mesh)
    V, label, out = cfg.vocab_size, case['label'], {}
    lay = make_split(cfg, mesh).heads(cfg)
    line = (f'serve {label} on 1 x {m}: {smi} | full width, depth '
            f'{cfg.n_layers}' + (f' + {cfg.n_enc_layers}' if cfg.is_encdec
                                 else '') + ', bf16, heads '
            f'{cfg.n_heads}/{cfg.n_kv_heads}, {lay.n_local} q heads a rank'
            + (f' (padded per KV group to {lay.group}: the projections '
               'row-parallel, wo replicated)' if lay.padded else ''))
    frames = None
    if 'prefill' in case:
        S = case['prefill']
        batch = _batch(torch, cfg, 1, S, 11, enc_len=S, vision=True)
        pstep = build_prefill_step(cfg, mesh=mesh)
        pstep(blocks, batch)                       # first call: set-up
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = pstep(blocks, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
        n_attn = cfg.n_layers + cfg.n_enc_layers
        want = {'rmsnorm': 2 * n_attn, 'flash_attention': n_attn,
                'flash_attention_tc': n_attn}
        got = {k: _lib.LAUNCHES[k] for k in want}
        if got != want:
            raise AssertionError(f'serve {label}: prefill launches {got}, '
                                 f'want {want}')
        out.update(launches=launches, prefill_secs=secs,
                   prefill_sum=float(logits[:, :V].float().sum()))
        line += (f'; prefill 1 x {S} {secs * 1e3:.3f} ms, launches '
                 f'{launches}')
        if rank == 0:
            one = build_prefill_step(cfg)
            one(whole, batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = one(whole, batch)
            torch.cuda.synchronize()
            one_secs = time.perf_counter() - t0
            err = _rel_l2(logits[:, :V], ref[:, :V])
            if not err <= 2e-2:
                raise AssertionError(f'serve {label}: prefill against one '
                                     f'rank rel L2 {err:.3e}')
            out.update(prefill_err=err, one_rank_prefill_secs=one_secs)
            line += (f' (one rank\'s {one_secs * 1e3:.3f} ms; against it '
                     f'rel L2 {err:.3e} <= 2e-2)')
        del batch, logits
    B, smax = case['B'], case['smax']
    pos = smax - smax // m - SERVE_STEPS // 2
    inputs = _serve_inputs(torch, cfg, B, SERVE_STEPS)
    split = make_split(cfg, mesh, B)
    cache_whole = _seeded_cache(torch, cfg, B, smax, pos)
    cache = shard_cache(cache_whole, cache_split_specs(cfg, mesh, B, smax),
                        mesh)
    if cfg.is_encdec:
        frames = torch.randn((B, cfg.cross_len, cfg.d_model),
                             dtype=torch.bfloat16,
                             device='cuda',
                             generator=torch.Generator('cuda').manual_seed(13))
        with torch.inference_mode():
            enc = encode(cfg, blocks, split.batch_block(frames), split)
            cache = fill_cross_cache(cfg, blocks, cache, enc, split)
        del enc
    if rank != 0:
        del whole, cache_whole
    cache_bytes = sum(t.numel() * t.element_size() for sc in
                      cache['slots'].values() for t in sc.values())
    whole_cache = cache_bytes * m
    if cfg.is_encdec:
        cross = sum(t.numel() * t.element_size()
                    for t in cache['cross'].values())
        cache_bytes += cross
        whole_cache += cross * m
    block = cache['slots']['slot0']['k'][0].numel()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = build_serve_step(cfg, mesh=mesh)
    sizes = []
    ctx.reset_collectives()
    _lib.reset_launches()
    logits, cache, secs = _timed_decode(torch, step, blocks, inputs, cache,
                                        sizes)
    counts = {k: v / SERVE_STEPS for k, v in ctx.COLLECTIVES.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if max(sizes) >= block:
        raise AssertionError(f'serve {label}: an all-reduce of {max(sizes)} '
                             f'entries, a layer\'s cache block holds {block}')
    step_s = statistics.median(secs[1:])
    line += (f'; decode B={B}, Smax={smax}, {SERVE_STEPS} steps from pos '
             f'{pos}: cache {cache_bytes / 1e9:.3f} GB a rank of '
             f'{whole_cache / 1e9:.3f} GB, collectives a step {counts}, '
             f'largest {max(sizes)} entries (a layer\'s cache block '
             f'{block}), {step_s * 1e3:.3f} ms a step (median of '
             f'{SERVE_STEPS - 1} after the first), peak {peak:.2f} GB')
    out.update(cache_gb=cache_bytes / 1e9, whole_cache_gb=whole_cache / 1e9,
               counts=counts, largest=max(sizes), block=block,
               step_secs=step_s, peak_gb=peak,
               decode_launches={n: c for n, c in _lib.LAUNCHES.items() if c},
               logits_sum=float(sum(x[..., :V].float().sum()
                                    for x in logits)))
    if rank == 0:
        if cfg.is_encdec:
            with torch.inference_mode():
                cache_whole = fill_cross_cache(cfg, whole, cache_whole,
                                               encode(cfg, whole, frames))
        ref, _, one_secs = _timed_decode(torch, build_serve_step(cfg),
                                         whole, inputs, cache_whole)
        errs = [_rel_l2(a[..., :V], b[..., :V])
                for a, b in zip(logits, ref)]
        if not max(errs) <= 2e-2:
            raise AssertionError(f'serve {label}: decode against one rank '
                                 f'rel L2 {max(errs):.3e}')
        one_s = statistics.median(one_secs[1:])
        out.update(decode_err=max(errs), one_rank_step_secs=one_s)
        line += (f'; one rank\'s decode {one_s * 1e3:.3f} ms a step, each '
                 f'step\'s gathered logits against it rel L2 <= '
                 f'{max(errs):.3e} (<= 2e-2)')
        del whole, cache_whole, ref
    _rank_print(rank, line)
    del blocks, cache, logits
    torch.cuda.empty_cache()
    return out


def run_serve_split(torch, smi: str, out: dict) -> dict:
    """Phase 27: a model split on the mesh serves, as spawned ranks
    sharing ``cuda:0`` over gloo (phase 25's way), from
    :func:`run_worlds`' results ``out``: (a) Yi-9B's decode on 1 × 4,
    (b) SeamlessM4T's prefill and decode on 1 × 4, (c) Qwen2-VL-7B's on
    1 × 8 with its heads padded. Each part was held against one rank's
    on rank 0; the ranks must agree. Returns each part's per-rank
    results."""
    del torch
    out = {part: out[part] for part in SERVE_PARTS}
    for part, ranks in out.items():
        for key in ('logits_sum', 'prefill_sum'):
            vals = {r.get(key) for r in ranks}
            if len(vals) != 1:
                raise AssertionError(f'serve {part}: ranks disagree on '
                                     f'{key}: {vals}')
        r0 = ranks[0]
        prefill = ''
        if 'prefill_secs' in r0:
            prefill = (f'prefill a rank '
                       f'{[round(r["prefill_secs"], 4) for r in ranks]} s, '
                       f'one rank {r0["one_rank_prefill_secs"]:.4f} s, '
                       f'against it rel L2 {r0["prefill_err"]:.3e}, '
                       f'launches a rank {r0["launches"]}; ')
        print(f'serve {SERVE_CASES[part]["label"]}: {smi} | {prefill}'
              f'cache {r0["cache_gb"]:.4f} GB a rank of '
              f'{r0["whole_cache_gb"]:.4f} GB; collectives a step '
              f'{r0["counts"]}, the largest {r0["largest"]} entries against '
              f'a layer\'s cache block of {r0["block"]}; seconds a step a '
              f'rank {[round(r["step_secs"], 5) for r in ranks]}, one '
              f'rank {r0["one_rank_step_secs"]:.5f}; peak a rank '
              f'{[round(r["peak_gb"], 2) for r in ranks]} GB; decode '
              f'against one rank rel L2 {r0["decode_err"]:.3e}', flush=True)
    return out


# ---------------------------------------------------------------------------
# 28. MoE on a split model: Phi-3.5-MoE and Llama-4 Maverick on the mesh
# ---------------------------------------------------------------------------
MOE_PARTS = {   # part: (mesh shape, each rank's share of the card)
    'ma': ((1, 4), 0.2), 'mb': ((2, 2), 0.2), 'mc': ((1, 2), 0.45),
    'md': ((1, 4), 0.2)}
MOE_STEPS = 8          # teacher-forced decode steps of (a) and (d)
MOE_PREFILL_S = 4096   # (a) and (d): one 1 x 4096 prompt
# (a) Phi-3.5-MoE at depth 2; (d) one Llama-4 Maverick block (a dense
# layer, then a MoE layer with its shared expert, top-1). Their decode
# batches hold N·k <= 8·E replicas: the capacity is N·k, nothing drops,
# and one rank's plain decode_step is their oracle
MOE_SERVE = {
    'ma': dict(arch='phi35_moe_42b_a66b', label='(a) Phi-3.5-MoE', depth=2,
               B=32, smax=4096),
    'md': dict(arch='llama4_maverick_400b_a17b',
               label='(d) Llama-4 Maverick block', depth=2, experts=16,
               B=8, smax=4096)}
MOE_TRAIN_DEPTH, MOE_TRAIN_EXPERTS = 1, 8     # (b)
MOE_HG_DEPTH, MOE_HG_EXPERTS = 1, 4           # (c)
MOE_CUTS = {
    '(b) 8 of 16 experts': 'rank 0 holds the whole one-rank step\'s '
    'parameters, gradients and Adam state for its check: about 25 GB at '
    '16 experts, over its 18.4 GB, about 15 GB at 8 (phase 23 (c)\'s cut)',
    '(c) 4 of 16 experts': 'C and B take 32 bytes a parameter: p = 0.62 B '
    'at 4 experts is about 20 GB whole plus 10 GB a block on rank 0, within '
    'its share of 0.45; 8 experts would be about 45 GB',
    '(d) 16 of 128 experts': 'rank 0 holds the whole block beside its '
    'blocks within its share of 16 GB: about 37 GB at 128 experts, 8.9 GB '
    'whole plus 2.2 GB a rank at 16'}


def _sharded_capacity(torch, shards: int):
    """A stand-in for ``moe_ffn`` on one rank, phase 28's oracle:
    ``_moe_local(impl='capacity')`` on each of ``shards`` shards of the
    batch's rows, as a split model's data shards route them (all the rows
    where ``shards`` does not divide B), the outputs joined and the aux
    loss from the routing statistics averaged over the shards: the drops
    of the reference's ``shard_map``, which one rank's dropless ``ragged``
    path does not make."""
    from repro_torch.models import moe

    def moe_ffn(params, x, cfg):
        B, S, d = x.shape
        n = shards if B % shards == 0 else 1
        E, k = cfg.n_experts, cfg.top_k
        outs, fracs, means = [], [], []
        for xt in x.reshape(n, B // n * S, d):
            outs.append(moe._moe_local(params, xt, cfg, impl='capacity')[0])
            probs, _, _, counts, _ = moe.route(params, xt, cfg)
            fracs.append(counts.float() / (xt.shape[0] * k))
            means.append(probs.mean(0))
        aux = (E * torch.sum(torch.stack(fracs).mean(0)
                             * torch.stack(means).mean(0))
               * cfg.router_aux_coef)
        return torch.cat(outs).reshape(B, S, d), aux
    return moe_ffn


@contextlib.contextmanager
def _moe_swapped(name: str, fn):
    """``models.transformer``'s MoE entry ``name`` (``moe_ffn`` or
    ``moe_split``) replaced by ``fn`` inside the block."""
    from repro_torch.models import transformer
    old = getattr(transformer, name)
    setattr(transformer, name, fn)
    try:
        yield
    finally:
        setattr(transformer, name, old)


def _split_drops(torch, cfg, fn):
    """(what ``fn()`` returns, the replicas each split MoE layer's
    ``capacity`` path dropped on this rank's tokens, by layer): the
    layers' inputs are kept while ``fn`` runs and counted after it under
    the port's routing (no sync inside ``fn``)."""
    from repro_torch.models import moe
    seen = []

    def keeping(params, h, cfg_, split):
        seen.append((params['router'], h))
        return moe.moe_split(params, h, cfg_, split)

    with _moe_swapped('moe_split', keeping):
        out = fn()
    with torch.inference_mode():
        drops = [int(_capacity_drops(torch, moe, {'router': r}, h, cfg, 1)
                     .sum()) for r, h in seen]
    return out, drops


def _expert_bytes(cfg, tree) -> int:
    """Bytes of the MoE layers' experts (and shared expert) in ``tree``."""
    from repro_torch.core import tree_leaves
    return sum(t.numel() * t.element_size()
               for block in tree['blocks']
               for i, (_, ffn) in enumerate(cfg.layer_kinds()) if ffn == 'moe'
               for n, sub in block[f'slot{i}']['ffn'].items() if n != 'router'
               for t in tree_leaves(sub))


def _moe_serve(torch, dev, rank: int, smi: str, part: str) -> dict:
    """Phase 28 (a) and (d), on each rank of 1 × 4: a MoE model split on
    the mesh serves, at full width, bf16, random weights from a seed. A
    1 × ``MOE_PREFILL_S`` prefill through ``build_prefill_step(mesh=)``
    (kernels D and E on the rank's heads, the experts' d_ff over 'model'
    on the rank's tokens through the ``capacity`` path), its gathered
    logits held on rank 0 against one rank's prefill of the same weights
    with the MoE layers replaced by ``_moe_local(impl='capacity')`` on the
    same tokens (:func:`_sharded_capacity`, 2e-2); the replicas dropped,
    by layer. Then ``MOE_STEPS`` teacher-forced decode steps through
    ``build_serve_step(mesh=)`` over the rank's block of the cache's
    sequence, crossing into the last rank's block, held against one
    rank's plain ``decode_step`` (2e-2: N·k <= 8·E, nothing drops).
    Prints the expert and cache bytes a rank against the whole, the
    collectives a step by kind, seconds a step a rank against one rank's,
    and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import ctx
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import moe
    from repro_torch.models.split import cache_split_specs, shard_cache
    case = MOE_SERVE[part]
    base = get_config(case['arch'])
    cfg = dataclasses.replace(base, n_layers=case['depth'], use_pallas=True,
                              param_dtype='bfloat16',
                              n_experts=case.get('experts', base.n_experts))
    mesh = make_host_mesh(*MOE_PARTS[part][0])
    m = mesh.shape['model']
    whole, blocks, specs, nbytes, whole_bytes = _split_blocks(
        torch, dev, cfg, mesh)
    V, label, S = cfg.vocab_size, case['label'], MOE_PREFILL_S
    ex, ex_whole = _expert_bytes(cfg, blocks), _expert_bytes(cfg, whole)
    ffn = specs['blocks'][0][f'slot{cfg.moe_every - 1}']['ffn']
    tokens = torch.randint(0, V, (1, S),
                           generator=torch.Generator().manual_seed(11))
    pstep = build_prefill_step(cfg, mesh=mesh)
    _, drops = _split_drops(torch, cfg,
                            lambda: pstep(blocks, {'inputs': tokens}))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    ctx.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = pstep(blocks, {'inputs': tokens})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
    pcolls = dict(ctx.COLLECTIVES)
    ppeak = torch.cuda.max_memory_allocated() / 1e9
    want = {'rmsnorm': 2 * cfg.n_layers, 'flash_attention': cfg.n_layers,
            'flash_attention_tc': cfg.n_layers}
    got = {k: _lib.LAUNCHES[k] for k in want}
    if got != want:
        raise AssertionError(f'moe {label}: prefill launches {got}, want '
                             f'{want}')
    if not bool(torch.isfinite(logits[:, :V]).all()):
        raise AssertionError(f'moe {label}: prefill logits not finite')
    Nk = S * cfg.top_k
    out = dict(launches=launches, prefill_secs=secs, prefill_peak_gb=ppeak,
               prefill_collectives=pcolls, drops=drops,
               capacity=moe.capacity(Nk, cfg.n_experts),
               expert_gb=ex / 1e9, whole_expert_gb=ex_whole / 1e9,
               param_gb=nbytes / 1e9, whole_gb=whole_bytes / 1e9,
               prefill_sum=float(logits[:, :V].float().sum()))
    line = (f'moe {label} on 1 x {m}: {smi} | full width, depth '
            f'{cfg.n_layers} {cfg.layer_kinds()}, bf16, {cfg.n_experts} '
            f'experts top-{cfg.top_k} (w1 {tuple(ffn["w1"])}, w2 '
            f'{tuple(ffn["w2"])}, router {tuple(ffn["router"])}), heads '
            f'{cfg.n_heads}/{cfg.n_kv_heads}: experts {ex / 1e9:.4f} GB a '
            f'rank of {ex_whole / 1e9:.4f} GB, parameters {nbytes / 1e9:.4f}'
            f' of {whole_bytes / 1e9:.4f} GB; prefill 1 x {S} '
            f'{secs * 1e3:.3f} ms, capacity {out["capacity"]} of {Nk} '
            f'replicas, dropped by layer {drops}, collectives {pcolls}, '
            f'peak {ppeak:.2f} GB, launches {launches}')
    if rank == 0:
        one = build_prefill_step(cfg)
        with _moe_swapped('moe_ffn', _sharded_capacity(torch, 1)):
            one(whole, {'inputs': tokens})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = one(whole, {'inputs': tokens})
            torch.cuda.synchronize()
            one_secs = time.perf_counter() - t0
        err = _rel_l2(logits[:, :V], ref[:, :V])
        if not err <= 2e-2:
            raise AssertionError(f'moe {label}: prefill against one rank '
                                 f'rel L2 {err:.3e}')
        out.update(prefill_err=err, one_rank_prefill_secs=one_secs)
        line += (f' (one rank\'s capacity-path prefill {one_secs * 1e3:.3f}'
                 f' ms; against it rel L2 {err:.3e} <= 2e-2)')
        del ref
    del logits
    B, smax = case['B'], case['smax']
    if B * cfg.top_k > 8 * cfg.n_experts:
        raise AssertionError(f'moe {label}: decode B={B} would drop '
                             'replicas; one rank\'s decode_step would not '
                             'be its oracle')
    pos = smax - smax // m - MOE_STEPS // 2
    inputs = _serve_inputs(torch, cfg, B, MOE_STEPS)
    cache_whole = _seeded_cache(torch, cfg, B, smax, pos)
    cache = shard_cache(cache_whole, cache_split_specs(cfg, mesh, B, smax),
                        mesh)
    if rank != 0:
        del whole, cache_whole
    cache_bytes = sum(t.numel() * t.element_size() for sc in
                      cache['slots'].values() for t in sc.values())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = build_serve_step(cfg, mesh=mesh)
    ctx.reset_collectives()
    _lib.reset_launches()
    logits, cache, secs = _timed_decode(torch, step, blocks, inputs, cache)
    counts = {k: v / MOE_STEPS for k, v in ctx.COLLECTIVES.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = statistics.median(secs[1:])
    line += (f'; decode B={B}, Smax={smax}, {MOE_STEPS} steps from pos '
             f'{pos}: cache {cache_bytes / 1e9:.4f} GB a rank of '
             f'{cache_bytes * m / 1e9:.4f} GB, collectives a step {counts}, '
             f'{step_s * 1e3:.3f} ms a step (median of {MOE_STEPS - 1} after '
             f'the first), peak {peak:.2f} GB')
    out.update(cache_gb=cache_bytes / 1e9,
               whole_cache_gb=cache_bytes * m / 1e9, counts=counts,
               step_secs=step_s, peak_gb=max(peak, ppeak),
               decode_launches={n: c for n, c in _lib.LAUNCHES.items() if c},
               logits_sum=float(sum(x[..., :V].float().sum()
                                    for x in logits)))
    if rank == 0:
        ref, _, one_secs = _timed_decode(torch, build_serve_step(cfg), whole,
                                         inputs, cache_whole)
        errs = [_rel_l2(a[..., :V], b[..., :V]) for a, b in zip(logits, ref)]
        if not max(errs) <= 2e-2:
            raise AssertionError(f'moe {label}: decode against one rank '
                                 f'rel L2 {max(errs):.3e}')
        one_s = statistics.median(one_secs[1:])
        out.update(decode_err=max(errs), one_rank_step_secs=one_s)
        line += (f'; one rank\'s decode {one_s * 1e3:.3f} ms a step, each '
                 f'step\'s gathered logits against it rel L2 <= '
                 f'{max(errs):.3e} (<= 2e-2)')
        del whole, cache_whole, ref
    _rank_print(rank, line)
    del blocks, cache, logits
    torch.cuda.empty_cache()
    return out


def _moe_train(torch, dev, rank: int, smi: str) -> dict:
    """Phase 28 (b), on each rank of 2 × 2 with ``fsdp``: two
    ``build_train_step(mesh=)`` steps on Phi-3.5-MoE at full width, depth
    ``MOE_TRAIN_DEPTH``, ``MOE_TRAIN_EXPERTS`` of its 16 experts (cut,
    ``MOE_CUTS``), f32 parameters, bf16 compute, remat 'full', 8 × 128
    tokens (4 rows a data shard, the capacity from each shard's 512
    tokens). The replicas each data shard drops are counted on both
    steps' batches first. Rank 0 then runs one rank's unsplit steps on the
    same weights and batches with the MoE layer replaced by
    :func:`_sharded_capacity` on the same 2 data shards: losses and
    gradient norms within 2e-2 relative (phase 26 (b)'s gate)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import tree_leaves
    from repro_torch.data import TokenStream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (build_train_step, local_batch,
                                          make_optimizer)
    from repro_torch.models import build_model, moe
    from repro_torch.models.split import make_split
    from repro_torch.models.transformer import forward
    cfg = dataclasses.replace(get_config('phi35_moe_42b_a66b'),
                              n_layers=MOE_TRAIN_DEPTH, remat='full',
                              fsdp=True, n_experts=MOE_TRAIN_EXPERTS)
    mesh = make_host_mesh(*MOE_PARTS['mb'][0])
    whole, blocks, specs, nbytes, whole_bytes = _split_blocks(
        torch, dev, cfg, mesh)
    del whole                 # rank 0 draws it again for one rank's steps
    torch.cuda.empty_cache()
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=LM_FULL['seq'])
    batches = [stream.batch(i, LM_FULL['batch']) for i in range(2)]
    split = make_split(cfg, mesh, LM_FULL['batch'], specs)
    drops = []
    for b in batches:
        rows = local_batch(b, split, dev)
        with torch.inference_mode():
            drops.append(_split_drops(torch, cfg, lambda: forward(
                cfg, blocks, rows['inputs'], split=split))[1])
    step = build_train_step(cfg, mesh=mesh)
    opt = make_optimizer(cfg)
    state = opt.init(blocks)
    opt_bytes = sum(t.numel() * t.element_size()
                    for t in tree_leaves(state))
    torch.cuda.reset_peak_memory_stats()
    losses, norms, secs = [], [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks, state, _, m = step(blocks, state, i, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f'moe (b): losses {losses}, norms {norms}')
    out = dict(losses=losses, norms=norms, secs=secs, peak_gb=peak,
               param_gb=nbytes / 1e9, opt_gb=opt_bytes / 1e9,
               whole_gb=whole_bytes / 1e9, drops=drops,
               data=mesh.coords['data'])
    _rank_print(rank, f'moe (b): {smi} | Phi-3.5-MoE d={cfg.d_model}, depth '
                f'{cfg.n_layers}, {cfg.n_experts} experts top-{cfg.top_k}, '
                f'f32 parameters, bf16 compute, remat full, fsdp on 2x2 '
                f'({mesh.coords}), {LM_FULL["batch"]} x {LM_FULL["seq"]}: '
                f'capacity {moe.capacity(LM_FULL["batch"] // 2 * LM_FULL["seq"] * cfg.top_k, cfg.n_experts)}'
                f' a data shard, dropped by step and layer {drops}; steps '
                f'{[round(s, 4) for s in secs]} s, losses {losses}, grad '
                f'norms {norms}; this rank\'s parameters {nbytes / 1e9:.3f} '
                f'GB (whole {whole_bytes / 1e9:.3f} GB), optimizer state '
                f'{opt_bytes / 1e9:.3f} GB, peak {peak:.2f} GB')
    del blocks, state
    torch.cuda.empty_cache()
    dist.barrier()                          # the other ranks have let go
    if rank == 0:
        torch.cuda.set_per_process_memory_fraction(SPLIT_ONE_RANK_CAP)
        whole = build_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        one = build_train_step(cfg)
        ostate = opt.init(whole)
        torch.cuda.reset_peak_memory_stats()
        one_l, one_n, one_s = [], [], []
        with _moe_swapped('moe_ffn', _sharded_capacity(
                torch, mesh.shape['data'])):
            for i, b in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                whole, ostate, _, m = one(whole, ostate, i, b)
                torch.cuda.synchronize()
                one_s.append(time.perf_counter() - t0)
                one_l.append(float(m['loss']))
                one_n.append(float(m['grad_norm']))
        errs = [abs(a / b - 1) for a, b in zip(losses + norms, one_l + one_n)]
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        _rank_print(rank, f'moe (b) against one rank (unsplit, the same '
                    f'weights and batches, the capacity path on the same 2 '
                    f'data shards): losses {one_l}, grad norms {one_n}, '
                    f'steps {[round(s, 4) for s in one_s]} s, peak '
                    f'{one_peak:.2f} GB; largest relative gap '
                    f'{max(errs):.3e} (<= 2e-2)')
        if not max(errs) <= 2e-2:
            raise AssertionError(f'moe (b): against one rank {errs}')
        out.update(one_rank=dict(losses=one_l, norms=one_n, secs=one_s,
                                 peak_gb=one_peak), err=max(errs))
        del whole, ostate
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _moe_hypergrad(torch, dev, rank: int, smi: str) -> dict:
    """Phase 28 (c), on each rank of 1 × 2: ``build_hypergrad_step(mesh=)``
    on Phi-3.5-MoE at full width, depth ``MOE_HG_DEPTH``,
    ``MOE_HG_EXPERTS`` of its 16 experts (cut, ``MOE_CUTS``), f32 compute,
    a k = 8 bf16 sketch through ``flat_sharded`` over the rank's blocks:
    the HVP columns through the capacity path and the collectives, kernels
    A–C on the rank's (p_local, k) buffer, and no gather in the apply.
    Rank 0 then runs one rank's unsplit hypergradient ('cuda', the whole
    bf16 sketch) with the MoE layer replaced by :func:`_sharded_capacity`
    on the same tokens (the batch is whole on both ranks of 1 × 2); the
    parent holds the two within 1e-3 (phase 26 (c)'s gate)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import HypergradConfig, PyTreeIndexer, make_hvp
    from repro_torch.data import TokenStream
    from repro_torch.distributed import ctx
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (N_DOMAINS, build_hypergrad_step,
                                          domain_losses, lm_hypergrad,
                                          local_batch, loss_and_grads,
                                          split_solver, to_device)
    from repro_torch.models import moe
    from repro_torch.models.split import make_split
    from repro_torch.models.transformer import forward
    cfg = dataclasses.replace(get_config('phi35_moe_42b_a66b'),
                              n_layers=MOE_HG_DEPTH, compute_dtype='float32',
                              n_experts=MOE_HG_EXPERTS)
    mesh = make_host_mesh(*MOE_PARTS['mc'][0])
    whole, blocks, specs, nbytes, whole_bytes = _split_blocks(
        torch, dev, cfg, mesh)
    if rank != 0:
        del whole
    torch.cuda.empty_cache()
    h = {'domain_logits': 0.1 * torch.randn(
        N_DOMAINS, generator=torch.Generator().manual_seed(1)).to(dev)}
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=LM_FULL['seq'])
    ib = stream.batch(3, LM_FULL['batch'])
    ob = stream.batch(10_000_003, LM_FULL['batch'], clean_only=True)
    hg_cfg = HypergradConfig(k=LM_K, rho=RHO, sketch_dtype='bfloat16',
                             column_chunk=2)
    step = build_hypergrad_step(cfg, mesh=mesh, hg_cfg=hg_cfg)
    split = make_split(cfg, mesh, LM_FULL['batch'], specs)
    solver = split_solver(mesh, specs, hg_cfg)   # the step's, for its pieces
    indexer = solver.backend.indexer(blocks)
    idx = indexer.sample_indices(torch.Generator().manual_seed(3), LM_K)
    inner, outer = domain_losses(cfg, split)
    ib_l, ob_l = (local_batch(b, split, dev) for b in (ib, ob))
    with torch.inference_mode():
        _, drops = _split_drops(torch, cfg, lambda: forward(
            cfg, blocks, ib_l['inputs'], split=split))
    sk = solver.prepare(make_hvp(inner, blocks, h, ib_l), indexer, None,
                        indices=idx)
    _, g_theta = loss_and_grads(lambda p: outer(p, h, ob_l), blocks)
    _lib.reset_launches()
    ctx.reset_collectives()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    solver.apply(sk, g_theta)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t1
    apply_colls = dict(ctx.COLLECTIVES)
    passes = _lib.LAUNCHES['woodbury_ctv'] + _lib.LAUNCHES['nystrom_cross']
    if apply_colls != {'psum': passes}:
        raise AssertionError(f'moe (c): one apply ran {apply_colls}, want '
                             f'one psum for each of its {passes} k-output '
                             'passes and no gather')
    c_gb = sk.C.buf.numel() * sk.C.buf.element_size() / 1e9
    b_gb = sk.B.buf.numel() * sk.B.buf.element_size() / 1e9
    p_local = int(sk.C.buf.shape[0])
    del sk, g_theta
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    ctx.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_h = step(blocks, h, ib, ob, indices=idx)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
    colls = dict(ctx.COLLECTIVES)
    for name in ('nystrom_cross_tc', 'woodbury_ctv', 'woodbury_apply'):
        if not launches.get(name):
            raise AssertionError(f'moe (c): {name} never launched: '
                                 f'{launches}')
    peak = torch.cuda.max_memory_allocated() / 1e9
    hg = (h['domain_logits'] - new_h['domain_logits']) / 1e-2
    out = dict(secs=secs, launches=launches, collectives=colls,
               apply_collectives=apply_colls, apply_s=apply_s,
               p_local=p_local, p=indexer.total, c_gb=c_gb, b_gb=b_gb,
               peak_gb=peak, param_gb=nbytes / 1e9, drops=drops,
               hg=hg.cpu().tolist())
    _rank_print(rank, f'moe (c): {smi} | Phi-3.5-MoE d={cfg.d_model}, depth '
                f'{cfg.n_layers}, {cfg.n_experts} experts, f32 compute, on '
                f'{dict(mesh.shape)} ({mesh.coords}), k={LM_K} bf16 sketch: '
                f'capacity {moe.capacity(LM_FULL["batch"] * LM_FULL["seq"] * cfg.top_k, cfg.n_experts)}'
                f', dropped by layer {drops}; outer step {secs:.4f} s, this '
                f'rank\'s p_local {p_local:,} of {indexer.total:,}, C '
                f'{c_gb:.3f} GB, B {b_gb:.3f} GB, parameters '
                f'{nbytes / 1e9:.3f} GB, peak {peak:.2f} GB, launches '
                f'{launches}, collectives {colls}; one apply {apply_s:.4f} s '
                f'with {apply_colls} ({passes} k-output passes, no gather)')
    dist.barrier()
    del blocks
    torch.cuda.empty_cache()
    dist.barrier()                          # the other rank has let go
    if rank == 0:
        torch.cuda.set_per_process_memory_fraction(SPLIT_ONE_RANK_CAP)
        torch.cuda.reset_peak_memory_stats()
        one = _lm_config('cuda', sketch_dtype='bfloat16').build()
        il, ol = domain_losses(cfg)
        ib_w, ob_w = to_device(ib, dev), to_device(ob, dev)

        def one_step():
            sk1 = one.prepare(make_hvp(il, whole, h, ib_w),
                              PyTreeIndexer(whole), None, indices=idx)
            return lm_hypergrad(one, il, ol, whole, h, ib_w, ob_w,
                                state=sk1)[1]['domain_logits']
        with _moe_swapped('moe_ffn', _sharded_capacity(torch, 1)):
            one_step()                            # first call: set-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hg1 = one_step()
            torch.cuda.synchronize()
        out.update(one_rank_secs=time.perf_counter() - t0,
                   one_rank_hg=hg1.cpu().tolist(),
                   one_rank_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del whole
        torch.cuda.empty_cache()
    return out


def run_moe_split(torch, smi: str, out: dict) -> dict:
    """Phase 28: MoE on a split model, as spawned ranks sharing ``cuda:0``
    over gloo (phase 25's way), from :func:`run_worlds`' results ``out``:
    (a) Phi-3.5-MoE's prefill and decode on 1 × 4, (b) its two train steps
    on 2 × 2 with FSDP, (c) its hypergradient on 1 × 2, (d) one Llama-4
    Maverick block's prefill and decode on 1 × 4. Each part was held
    against one rank's on rank 0, the MoE layer on the capacity path of
    the same token shards; the ranks must agree (the ranks of a data shard
    on its drops). Returns each part's per-rank results."""
    out = {part: out[part] for part in MOE_PARTS}
    for part in ('ma', 'md'):
        ranks, label = out[part], MOE_SERVE[part]['label']
        for key in ('logits_sum', 'prefill_sum'):
            if len({r[key] for r in ranks}) != 1:
                raise AssertionError(f'moe {label}: ranks disagree on {key}')
        if any(r['drops'] != ranks[0]['drops'] for r in ranks):
            raise AssertionError(f'moe {label}: ranks disagree on the drops')
        r0 = ranks[0]
        print(f'moe {label}: {smi} | experts {r0["expert_gb"]:.4f} GB a rank '
              f'of {r0["whole_expert_gb"]:.4f} GB; prefill a rank '
              f'{[round(r["prefill_secs"], 4) for r in ranks]} s, one rank '
              f'{r0["one_rank_prefill_secs"]:.4f} s, against it rel L2 '
              f'{r0["prefill_err"]:.3e}, dropped by layer {r0["drops"]} '
              f'(capacity {r0["capacity"]}), launches a rank '
              f'{r0["launches"]}; cache {r0["cache_gb"]:.4f} GB a rank of '
              f'{r0["whole_cache_gb"]:.4f} GB; collectives a step '
              f'{r0["counts"]}; seconds a step a rank '
              f'{[round(r["step_secs"], 5) for r in ranks]}, one rank '
              f'{r0["one_rank_step_secs"]:.5f}; peak a rank '
              f'{[round(r["peak_gb"], 2) for r in ranks]} GB; decode against '
              f'one rank rel L2 {r0["decode_err"]:.3e}', flush=True)
    b = out['mb']
    if any(r['losses'] != b[0]['losses'] or r['norms'] != b[0]['norms']
           for r in b):
        raise AssertionError('moe (b): ranks disagree on losses or norms')
    by_shard = {}
    for r in b:
        by_shard.setdefault(r['data'], []).append(r['drops'])
    if any(len({str(d) for d in ds}) != 1 for ds in by_shard.values()):
        raise AssertionError(f'moe (b): the ranks of a data shard disagree '
                             f'on the drops: {by_shard}')
    print(f'moe (b): {smi} | steps a rank '
          f'{[[round(s, 4) for s in r["secs"]] for r in b]} s, one rank '
          f'{[round(s, 4) for s in b[0]["one_rank"]["secs"]]} s; dropped by '
          f'data shard, step and layer '
          f'{ {k: v[0] for k, v in sorted(by_shard.items())} }; peak a rank '
          f'{[round(r["peak_gb"], 2) for r in b]} GB, one rank '
          f'{b[0]["one_rank"]["peak_gb"]:.2f} GB; against one rank '
          f'{b[0]["err"]:.3e} (<= 2e-2)', flush=True)
    c = out['mc']
    if any(r['hg'] != c[0]['hg'] for r in c):
        raise AssertionError('moe (c): ranks disagree on the hypergradient')
    err = _rel_l2(torch.tensor(c[0]['hg']), torch.tensor(
        c[0]['one_rank_hg']), True)
    if not err <= 1e-3:
        raise AssertionError(f'moe (c): hypergradient against one rank rel '
                             f'L2 {err:.3e}')
    c[0]['err'] = err
    print(f'moe (c): {smi} | hypergradient against one rank\'s unsplit one '
          f'(cuda, whole bf16 sketch, the capacity path on the same tokens) '
          f'rel L2 {err:.3e} (<= 1e-3); outer step a rank '
          f'{[round(r["secs"], 4) for r in c]} s, one rank '
          f'{c[0]["one_rank_secs"]:.4f} s (peak '
          f'{c[0]["one_rank_peak_gb"]:.2f} GB); dropped by layer '
          f'{c[0]["drops"]}', flush=True)
    return out


def _phase(label: str) -> None:
    """Mark where a phase of ``main`` starts, for the seconds by phase that
    the script prints to stderr when it ends."""
    PHASE_STARTS.append((label, time.perf_counter()))


def main() -> None:
    # phase 18 (b) holds a 14 GB sketch, its whitened factor and 28 GB f32
    # upcasts of them on 'flat'; the caching allocator's fixed segments
    # split and fragment under that, where expandable ones grow in place
    os.environ.setdefault('PYTORCH_CUDA_ALLOC_CONF', 'expandable_segments:True')
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device: this script measures the port on a GPU')
    if not (SRC / 'repro_torch').is_dir():
        fail(f'{SRC / "repro_torch"} not found: run from a checkout')
    sys.path.insert(0, str(SRC))

    # 1. device -------------------------------------------------------------
    _phase('1')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    from repro_torch.device import resolve_device
    dev = resolve_device(None)            # also switches TF32 off
    print(f'device: {smi} | torch {torch.__version__} cuda '
          f'{torch.version.cuda} | {name} | tf32 matmul '
          f'{torch.backends.cuda.matmul.allow_tf32} cudnn '
          f'{torch.backends.cudnn.allow_tf32}', flush=True)

    # 2. build ----------------------------------------------------------------
    _phase('2')
    from repro_torch.kernels import _lib, ops, ref
    path, secs = _lib.build()
    _lib.lib()
    print(f'build: {path.name} in {secs:.1f} s', flush=True)
    report_build(path)

    # 3. kernels against their plain versions --------------------------------
    _phase('3')
    main_rec = check_kernels(torch, ops, ref, MAIN_P, MAIN_K, torch.float32,
                             dev, exact_ref=False)
    check_kernels(torch, ops, ref, MAIN_P, MAIN_K, torch.bfloat16, dev,
                  exact_ref=False)
    large = {str(dtype)[6:]: check_kernels(torch, ops, ref, LARGE_P, LARGE_K,
                                           dtype, dev, exact_ref=True)
             for dtype in (torch.float32, torch.bfloat16)}
    f1 = {f'{str(dtype)[6:]} k={k} m={m}': check_kernels(
        torch, ops, ref, F1_P, k, dtype, dev, exact_ref=True, m=m)
        for k, m in F1_KM for dtype in (torch.float32, torch.bfloat16)}
    run_kernel_tests()

    # 4. main path --------------------------------------------------------------
    _phase('4')
    from repro_torch.core import (ExactIHVP, HypergradConfig, PyTreeIndexer,
                                  hypergrad_at, hypergrad_error,
                                  phi_vjp_block, solve, tree_leaves,
                                  tree_map)
    from repro_torch.tasks import build_logreg_weight_decay, build_reweighting
    problem = build_reweighting()
    p = sum(x.numel() for x in tree_leaves(problem.init_params(
        torch.Generator().manual_seed(0))))
    if p != MAIN_P:
        raise AssertionError(f'reweighting has p={p}, expected {MAIN_P}')
    n_outer = 5
    config = HypergradConfig(solver='nystrom', k=10, backend='cuda')
    # one outer step first: library handles and first-call set-up land here
    warm = solve(problem, config, n_outer=1)
    _lib.reset_launches()
    res = solve(problem, config, n_outer=n_outer)
    main_launches = dict(_lib.LAUNCHES)
    losses = res.history['outer_loss']
    if len(losses) != n_outer or not all(map(math.isfinite, losses)):
        raise AssertionError(f'outer losses not finite: {losses}')
    for kname in ('nystrom_gram', 'woodbury_ctv', 'woodbury_apply'):
        if main_launches[kname] == 0:
            raise AssertionError(f'main path never launched {kname}')
    print(f'main path: solve(reweighting p={p}, nystrom k=10, cuda) '
          f'{n_outer} outer steps x 20 inner, {res.seconds / n_outer:.4f} '
          f's/outer step (first-call warm-up step {warm.seconds:.4f} s), '
          f'outer loss {[round(x, 5) for x in losses]}, '
          f"accuracy {res.metrics['accuracy']:.4f}, launches {main_launches}",
          flush=True)

    ib = problem.data.train_batch(n_outer, 128)
    ob = problem.data.val_batch(n_outer, 128)
    idx = PyTreeIndexer(res.params).sample_indices(
        torch.Generator().manual_seed(n_outer), 10)
    hg = {be: hypergrad_at(problem, HypergradConfig(k=10, backend=be),
                           res.params, res.hparams, ib, ob, indices=idx)
          for be in ('cuda', 'flat')}
    err = float(hypergrad_error(hg['cuda'], hg['flat']))
    if not err <= 1e-4:
        raise AssertionError(f'hypergradient cuda vs flat: rel L2 {err:.3e}')
    print(f'hypergrad_at cuda vs flat: rel L2 {err:.3e} (<= 1e-4)', flush=True)

    lp = build_logreg_weight_decay()
    gen = torch.Generator().manual_seed(1)
    lparams = {'w': (0.3 * torch.randn(100, generator=gen)).to(dev)}
    lh = {'wd': (0.1 * torch.rand(100, generator=gen)).to(dev)}
    l_ib, l_ob = lp.data.train_batch(0, 500), lp.data.val_batch(0, 500)
    full = hypergrad_at(lp, HypergradConfig(k=100, rho=1e-3, backend='cuda'),
                        lparams, lh, l_ib, l_ob)
    oracle = hypergrad_at(lp, ExactIHVP(rho=1e-3), lparams, lh, l_ib, l_ob)
    err = float(hypergrad_error(full, oracle))
    if not err <= 1e-4:
        raise AssertionError(f'full-rank logreg_wd vs exact: rel L2 {err:.3e}')
    print(f'full-rank logreg_wd (p=100) cuda vs exact oracle: rel L2 '
          f'{err:.3e} (<= 1e-4)', flush=True)

    # 5. block path ---------------------------------------------------------
    _phase('5')
    Xv, yv = problem.data.val_batch(n_outer + 1, M)

    def example_loss(params, x, y):
        return problem.outer_loss(params, res.hparams, (x[None], y[None]))

    G = torch.func.vmap(torch.func.grad(example_loss), in_dims=(None, 0, 0))(
        res.params, Xv, yv)
    V = tree_map(lambda g: torch.movedim(g, 0, -1).contiguous(), G)
    _lib.reset_launches()
    block = phi_vjp_block(HypergradConfig(k=10, backend='cuda').build(),
                          problem.inner_loss, res.params, res.hparams, ib, V,
                          indices=idx)
    torch.cuda.synchronize()
    block_launches = dict(_lib.LAUNCHES)
    flat = phi_vjp_block(HypergradConfig(k=10, backend='flat').build(),
                         problem.inner_loss, res.params, res.hparams, ib, V,
                         indices=idx)
    err = float(hypergrad_error(block, flat))
    if not err <= 1e-4:
        raise AssertionError(f'phi_vjp_block cuda vs flat: rel L2 {err:.3e}')
    for kname in ('nystrom_cross', 'woodbury_apply_block'):
        if block_launches[kname] == 0:
            raise AssertionError(f'block path never launched {kname}')
    print(f'block path: phi_vjp_block m={M} cuda vs flat: rel L2 {err:.3e} '
          f'(<= 1e-4), launches {block_launches}', flush=True)

    # 6. where the time goes ------------------------------------------------
    _phase('6')
    trace_phases(torch, solve, problem, config, res.seconds / n_outer)

    # 7. model kernels against their plain versions --------------------------
    _phase('7')
    main_rec.update(check_model_kernels(torch, ops, ref, dev))

    # 8-9. the prefill, and where its time goes --------------------------------
    _phase('8-9')
    prefill_launches = run_prefill(torch, dev)
    torch.cuda.empty_cache()

    # 10. parity at full width, depth cut ------------------------------------
    _phase('10')
    parity_cut_depth(torch, dev)

    # 11-12. Tab. 2's solver family on distillation; Alg. 1 at p = 2^24 ------
    _phase('11-12')
    distill_launches = run_distillation(torch, dev)
    alg1 = time_alg1(torch, dev)

    # 13-15. the iMAML meta path, forward mode, influence --------------------
    _phase('13')
    imaml_launches = run_imaml(torch, dev)
    _phase('14')
    forward_launches = run_forward_mode(torch, problem, res.params,
                                        res.hparams, ib, idx)
    _phase('15')
    influence_launches, *served = run_influence(torch, dev)

    # 16. the serving tier --------------------------------------------------
    _phase('16')
    serve_launches = run_serving(torch, smi, *served)

    # 17. the multi-level engine through kernels A-C ------------------------
    _phase('17')
    second_launches = run_second_order(torch, dev)
    engine_launches = run_engine_graphs(torch, dev)
    stream_launches = run_engine_stream(torch, dev)
    torch.cuda.empty_cache()

    # 18. the bilevel LM trainer: reduced, then Yi-9B at full width --------
    _phase('18')
    lm_launches = {'reduced': run_lm_reduced(torch, dev)}
    torch.cuda.empty_cache()
    lm_launches['full_width'] = run_lm_full(torch, dev, smi)
    torch.cuda.empty_cache()

    # 19. Yi-9B decode at full width and depth ------------------------------
    _phase('19')
    decode_launches = {'yi_9b': run_decode_yi(torch, dev, smi)}

    # 20. the MoE family: Phi-3.5-MoE and one Llama-4 Maverick block --------
    _phase('20')
    moe_runs = run_moe(torch, dev, smi)
    decode_launches.update(moe_runs['decode'])

    # 21. the last four families: Qwen2-VL, Seamless, Jamba, RWKV-6 ---------
    _phase('21')
    families = run_families(torch, dev, smi)
    decode_launches.update(families['decode'])

    # 22. the solver observatory through kernels A-C ----------------------
    _phase('22')
    observatory_launches = run_observatory(torch, dev, smi)
    torch.cuda.empty_cache()

    # 23. training Seamless, Qwen2-VL and Phi-3.5-MoE through kernels A-C
    _phase('23')
    train_launches = run_train_families(torch, dev, smi)
    torch.cuda.empty_cache()

    # 24. training RWKV-6 and Jamba through their time loops, A-C --------
    _phase('24')
    train_launches.update(run_train_recurrent(torch, dev, smi))
    torch.cuda.empty_cache()

    # 25-28. the mesh: ranks sharing the card over gloo, kernels A-E; a
    # model split on it: prefill, train, hypergradient; serving it; MoE --
    _phase('25-28')
    worlds = run_worlds(torch, smi)
    mesh = run_mesh(worlds)
    split = run_split(torch, smi, mesh, worlds)
    serve = run_serve_split(torch, smi, worlds)
    moe_split = run_moe_split(torch, smi, worlds)

    # records -----------------------------------------------------------------
    _phase('records')
    records = []
    for kname, kernel, source, replaces in ROWS:
        if kname == 'flash_attention':   # the row of the tensor-core kernel
            path_launches = {kname: prefill_launches['flash_attention_tc']}
        elif kname == 'rmsnorm':
            path_launches = prefill_launches
        elif kname in ('nystrom_cross', 'woodbury_apply_block'):
            path_launches = block_launches
        else:
            path_launches = main_launches
        rec = dict(name=f'{kname} ({kernel})', route='cuda', source=source,
                   replaces=replaces, launches=path_launches[kname],
                   **main_rec[kname])
        if kname in ('nystrom_gram', 'woodbury_ctv', 'woodbury_apply'):
            rec['distillation_launches'] = {
                cfg: runs[kname] for cfg, runs in distill_launches.items()}
        if kname in ('nystrom_cross', 'woodbury_ctv'):
            rec['alg1_p24'] = alg1
        if kname in ('nystrom_gram', 'woodbury_ctv', 'woodbury_apply'):
            rec['observatory_launches'] = {
                part: runs[kname]
                for part, runs in observatory_launches.items()}
            key = 'nystrom_gram_tc' if kname == 'nystrom_gram' else kname
            rec['train_launches'] = {
                arch: runs[key] for arch, runs in train_launches.items()}
        if kname in large['float32']:   # rows 1-5: phases 13-15's paths
            rec['imaml_launches_per_meta_step'] = {
                mode: runs.get(kname, 0)
                for mode, runs in imaml_launches.items()}
            rec['forward_mode_launches'] = forward_launches.get(kname, 0)
            rec['influence_launches'] = influence_launches.get(kname, 0)
            rec['serve_launches'] = {
                label: runs.get(kname, 0)
                for label, runs in serve_launches.items()}
            rec['engine_launches'] = {
                'second_order': second_launches.get(kname, 0),
                **{name: runs.get(kname, 0)
                   for name, runs in engine_launches.items()},
                'stream_per_step': stream_launches.get(kname, 0)}
            rec['lm_launches'] = {
                label: runs.get(kname, 0)
                for label, runs in lm_launches.items()}
        if kname in ('rmsnorm', 'flash_attention'):   # phase 20's prefills
            key = 'flash_attention_tc' if kname == 'flash_attention' else kname
            rec['moe_launches'] = {
                label: runs[key] for label, runs in moe_runs['moe'].items()}
            rec['family_launches'] = {   # phase 21's prefills, one each
                arch: runs[key] for arch, runs in families['prefill'].items()}
        rec['decode_launches'] = {
            label: runs.get(kname, 0)
            for label, runs in decode_launches.items()}
        if kname in large['float32']:   # rows 1-5: phase 25's ranks
            rec['mesh_launches'] = {
                f'(a) {dt} rank {r}': a[dt]['launches'].get(kname, 0)
                for dt in ('float32', 'bfloat16')
                for r, a in enumerate(mesh['a'])}
            rec['mesh_launches'].update({
                f'(c) rank {r}': c['launches'].get(kname, 0)
                for r, c in enumerate(mesh['c'])})
        if kname in ('rmsnorm', 'flash_attention'):   # phase 25 (b)
            key = 'flash_attention_tc' if kname == 'flash_attention' else kname
            rec['mesh_launches'] = {
                f'(b) rank {r}': b['launches'].get(key, 0)
                for r, b in enumerate(mesh['b'])}
            rec['split_launches'] = {   # phase 26 (a), each rank's heads
                f'(a) rank {r}': a['launches'].get(key, 0)
                for r, a in enumerate(split['a4'])}
            rec['serve_split_launches'] = {   # phase 27: prefill, decode
                f'{SERVE_CASES[part]["label"].split()[0]} {stage} rank {r}':
                    x[field].get(key, 0)
                for part in SERVE_PARTS
                for stage, field in (('prefill', 'launches'),
                                     ('decode', 'decode_launches'))
                for r, x in enumerate(serve[part])
                if field in x}    # (a) has no prefill: no count for it
            rec['moe_split_launches'] = {   # phase 28 (a), (d)
                f'{MOE_SERVE[part]["label"].split()[0]} {stage} rank {r}':
                    x[field].get(key, 0)
                for part in MOE_SERVE
                for stage, field in (('prefill', 'launches'),
                                     ('decode', 'decode_launches'))
                for r, x in enumerate(moe_split[part])}
        if kname in ('nystrom_gram', 'nystrom_cross', 'woodbury_ctv',
                     'woodbury_apply'):       # phase 26 (c), rank's blocks
            rec['split_launches'] = {   # row 1: the gram runs as a cross
                f'(c) rank {r}': c['launches'].get(kname, 0)
                for r, c in enumerate(split['c2'])}
            rec['moe_split_launches'] = {   # phase 28 (c), the same
                f'(c) rank {r}': c['launches'].get(kname, 0)
                for r, c in enumerate(moe_split['mc'])}
        if kname in large['float32']:   # rows 1-5 at p = 2^24 and 2^20
            for key, runs in (('p24', large), ('p20', f1)):
                rec[key] = {dt: _p24(recs[kname])
                            for dt, recs in runs.items()}
                if kname == 'nystrom_cross':
                    rec[key].update({
                        f'{dt} x bfloat16': _p24(recs['nystrom_cross_bf16'])
                        for dt, recs in runs.items()
                        if 'nystrom_cross_bf16' in recs})
        records.append(rec)
    print(smi)
    print(json.dumps({'kernels': records}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if len(sys.argv) == 6 and sys.argv[1] == '--mesh-rank':
        mesh_rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                       sys.argv[5])
        sys.exit(0)
    t0 = time.perf_counter()
    main()
    t1 = time.perf_counter()
    ends = [t for _, t in PHASE_STARTS[1:]] + [t1]
    print('chip_smoke: seconds by phase ' + ', '.join(
        f'{label} {end - start:.1f}'
        for (label, start), end in zip(PHASE_STARTS, ends)),
        file=sys.stderr)
    print('chip_smoke: seconds by step ' + ', '.join(
        f'{label} {secs:.1f}' for label, secs in STEP_SECONDS),
        file=sys.stderr)
    print(f'chip_smoke: done in {t1 - t0:.1f} s', file=sys.stderr)
