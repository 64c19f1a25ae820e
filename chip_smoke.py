#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path once on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --host-only [--src DIR]
    python3 chip_smoke.py --train-only [--src DIR]
    python3 chip_smoke.py --experts-only [--src DIR]
    python3 chip_smoke.py --jamba-only

In order, it:

1. prints the card's name and power limit (``nvidia-smi``) and stops,
   with a nonzero exit, when ``torch.cuda.is_available()`` is false.
   ``--train-only`` then runs phase 19a's card-against-CPU training
   check with its TF32 control and 19b's 30 gemma2_2b steps for the
   package under ``--src``, prints one JSON line and stops;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (printing each kernel's register / shared-memory report),
   times each kernel wrapper's host cost per call at the decode shapes,
   times the whole ``pallas`` projection (``ops.wisparse_project``)
   against the dense product at every projection shape (B = 8, 32, 448)
   and counts the CUDA kernels one projection launches
   (``torch.profiler``; it must be 3: ``score_select``, the matmul, the
   cast), and times one projection of each plain gather backend
   (``topk_shared``, ``topk_block``) at B = 8.  ``--host-only`` stops
   here; ``--src`` times another tree's package, so two commits can be
   compared in one call;
3. holds each kernel against its plain PyTorch version on the card, on
   the kernel test shapes in f32 and bf16 and at llama31_8b's projection
   shapes, and times the kernel, the plain version and (for the
   matmuls) dense ``torch.matmul`` by CUDA-graph replay.
   ``score_select`` runs at B = 8 (decode slots), 32 (one prefill
   chunk) and 448 (a whole prompt), with a finite tau and keep_frac 0.5
   and 0.375 under k_frac 0.5: xm bit-equal, idx equal (or differing
   only between block scores within the tolerance, printed), two
   launches bit-equal, timed as one launch of the cluster kernel.  The
   matmul kernels run at B = 8 and 32; at every projection shape each
   must give the same bits in two launches, and its line shows its
   split-K grid, its share of the bound and the v1 kernel's time beside
   this run's; a per-decode-layer summary follows.
   ``sparse_matmul_per_seq`` gets a distinct random half of the blocks
   per row there, and its only entry point,
   ``ops.wisparse_project(per_seq=True)``, is driven at every projection
   shape and held against ``per_seq=False``.  ``score_select`` and
   ``sparse_matmul_shared`` are then held and timed the same way at
   gemma2_2b's seven projection shapes (B = 8 and 32), with a
   per-decode-layer summary, and held (not timed) at the row counts of
   phase 16's whole-prompt prefills (64-448, 4314, 4430 and 2 x 4326
   rows), tau -inf and finite, no row weights.  Both are held and timed
   at granite_moe_3b_a800m's four attention shapes (B = 8, 32), and the
   expert-batched ``score_select_experts`` and
   ``sparse_matmul_shared_experts`` at its three expert shapes (48
   experts, R = 8 and 9 rows each, bf16, tau -inf and finite): xm
   bit-equal and ids equal or tied per expert, the pad experts' zero rows
   giving ids 0..kb-1, the matmul within the tolerance, two launches
   bit-equal, timed beside the plain versions and dense ``torch.bmm``.
   ``score_select_experts`` alone is then held, checked for bit-equal
   launches and timed at every expert shape of granite_moe_1b_a400m (32
   experts), granite_moe_3b_a800m (48) and jamba_v01_52b (16): both
   expert input widths at decode rows 1, 8, 32 and 448 and the rows of a
   32- and a 448-token chunk, each line with its form (one block per
   expert, or one cluster per expert) and a per-layer sum, then at E = 1
   on llama31_8b's seven decode shapes beside ``score_select`` (a
   measurement line; the dense path keeps ``score_select``).
   ``score_select`` and ``sparse_matmul_shared`` are then held and timed
   at mamba2_130m's six projection shapes (n = 768 into m = 1536, 1536,
   128, 128 and 24, and n = 1536 into m = 768; B = 8 and 32), with a
   per-decode-layer summary, and held at the row counts of phase 18's
   whole-prompt prefills (64-448, 4099 and 3 x 8192 rows).  Last, both
   are held and timed at whisper_large_v3's eight decode-layer shapes
   (1280 into 1280 for self-attention and cross-attention's wq and wo,
   1280 into 5120 and 5120 into 1280 for the GELU MLP) and at
   internvl2_26b's seven (6144 into 6144, 1024, 1024, 16384 and 16384,
   16384 into 6144), B = 8 and 32, each beside its bound and dense
   ``torch.matmul`` with a per-decode-layer summary, and held at
   whisper's cross wk/wv row counts (1500 and 6000 encoder rows of
   1280), tau -inf and finite, no row weights.  Then both at
   jamba_v01_52b's thirteen 2-D shapes (attention 4096 into 4096, 1024,
   1024 and 4096; the mamba mixer's 4096 into 8192, 8192, 16, 16 and
   128, and 8192 into 4096; the dense FFN's 4096 into 14336 and 14336
   into 4096), B = 8 and 32, timed and summed over one sparse pass of
   the period (58 projections), and the ``_experts`` pair at its three
   expert shapes (16 experts, R = 8 and the 111, 241 and 641 rows of
   704-, 1536- and 4096-token whole prefills) as at granite's, each line
   naming the matmul's form (``jamba_kernels``); then the expert matmul
   alone there in both its forms, the gather form and the whole-prefill
   tile form, at R = 8, 32, 71, 111, 241 and 641, each held against the
   plain version with two launches bit-equal and timed beside dense
   ``torch.bmm`` and the bound (the times that chose the tile form's row
   threshold; ``--experts-only`` runs this too), and the tile form at
   E = 1 on jamba's 13 2-D shapes at B = 4096, summed over a sparse
   pass, beside the 2-D ``sparse_matmul_shared`` and ``torch.matmul`` (a
   measurement line: the 2-D entry keeps its gather form);
4. checks a reduced llama31_8b on the card against the same model on the
   CPU (plain kernel versions): forward logits and served greedy tokens;
   then a reduced gemma2_2b (f32, window 32) the same way: prefill logits
   and rolled caches over 80 tokens, and the tokens of a whole-prefill
   ``pallas`` engine serving prompts past the window; then a reduced
   granite_moe_3b_a800m with 20 experts padded to 32: prefill logits and
   the tokens of a chunked ``pallas`` engine; then a reduced mamba2_130m
   and a reduced jamba_v01_52b (f32): prefill logits, 4 decode steps'
   logits from a pool holding the prefills, and the tokens of a
   whole-prefill ``pallas`` engine; then a reduced whisper_large_v3
   (frames, cross-attention) and a reduced internvl2_26b (patch prefix)
   from the CPU's init: the greedy tokens of prefill then decode
   (``generate``) equal the CPU's under ``off``, ``mask`` and
   ``pallas``, and a whisper plan calibrated on the CPU serves the CPU's
   tokens on the card;
5. serves full-width llama31_8b (d_model 4096, bf16, random weights from
   a fixed seed; phases 5-18 run the first ``SERVE_DEPTH`` = 8
   layers of each model) through the port's ``Engine``: 12 requests
   with ragged prompts of 64-448 tokens, 32 new tokens each, dense and
   under ``SparsityPolicy.uniform("pallas", k_max_frac=0.5)`` with an
   uncalibrated sp tree (``keep_frac=0.5``, ``tau=-inf``), each twice in
   the order dense, pallas, pallas, dense, then once more each with the
   prefill chunks run through the plain chunk step (the path before the
   chunk step was captured; same tokens required), printing chunk p50,
   TTFT p50, prefill and run time of graph and eager chunks side by
   side.  The decode step runs as a CUDA graph per rung and each prefill
   chunk as a CUDA graph per (rung, phase policy)
   (``serving/graphs.py``).  The kernels' launch counts are zeroed just
   before each engine is built and read just after its run; the
   launches that ran (each launch recorded in a capture taken once per
   replay, ``Engine.launches``) must equal the sparse passes executed
   (56 = 8 x 7 per replay of a sparse decode or chunk graph, per eager warm call
   before each such capture and per eager sparse chunk), on a dense run
   zero.  A window of each run's decode steps is traced with
   ``torch.profiler`` for the device busy share of those same steps;
6. calibrates a ``pallas`` policy ladder (``sparsity.calibrate_ladder``,
   paper Alg. 1-4 per rung, with the serve CLI's ``--calib-quick``
   budget) on the same full-width model at budgets 0.0, 0.5 (the cold
   search) and 0.7 (warm-started), on 4 x 128 synthetic tokens, with the
   quality baselines; prints each rung's stage wall times, the block
   ratios, the mean alpha, the device memory peak and the 0.5 rung's KL
   beside the activation-only plan's, and checks the 0.5 rung's budget,
   that every threshold of a sparsified linear is finite, the 0.7 rung's
   budget and the ladder's monotonicity;
7. saves the 0.5 rung as a ``pallas`` policy artifact under ``build/``,
   loads it back and serves phase 5's trace once from it, checking the
   launch counts as in phase 5;
8. saves the ladder as a v4 artifact under ``build/``, loads it back and
   serves phase 5's trace from it twice under the SLO controller
   (``tpot_p95=1e6``, ``max_queue=2``, ``dwell=2``): at least two rungs
   visited, ``"queue"`` and ``"idle"`` transitions, no decode or chunk
   step built after warmup (every step's graph is captured once), a
   rung for every token, the same tokens and transitions in both runs,
   launches as in phase 5;
9. holds the captured decode step against the eager one at full width,
   B = 8, dense and ``pallas``: equal greedy tokens, the logits' max abs
   error, host and device time per step;
10. holds the captured chunk step against the eager one at full width,
   B = 32 (one chunk), dense and ``pallas``, chunk by chunk along the
   trace's longest prompt: equal greedy tokens and pool bytes, the
   logits' max abs error, host ms per chunk of each;
11. serves phase 5's trace with speculative decoding: verifier-only
   decode (the ladder pinned at its dense rung), spec on the calibrated
   ladder (drafter rung 1, gamma 2) and spec on a keep-all ``pallas``
   ladder (its drafter computes dense's function through the kernels, so
   drafts are accepted); each spec run must give verifier-only decode's
   tokens (a request may diverge only where the verifier's top-2 logit
   gap is under 3e-2, printed), build no verify, decode or chunk step
   after warmup and launch the kernels as in phase 5, and the keep-all
   run must accept drafts; prints acceptance rate, accepted per verify,
   draft and verify ms per round, decode tok/s and TTFT p50;
12. serves the prefix cache at full width (8 slots, ``max_len`` 512, chunk
   32, ``prefill_dense_frac`` 1.0): a 256-token system prompt from SEED,
   12 requests of it plus a unique 16-, 32- or 64-token suffix (32 new
   tokens each, all at once) after one priming request, through a cold
   and a cache engine, dense and ``pallas`` (cold dense, cache dense,
   cold pallas, cache pallas).  Every trace request must hit at 256 or
   more, the cache-dense tokens must equal the cold-dense tokens, the
   slot bytes over [0, P) after a hit plus its suffix prefill must be
   bit-equal to a cold prefill for one request of each suffix length in
   both modes, no step may be built after warmup, no pool tensor may
   move, and the ``pallas`` runs' launches are checked as in phase 5.
   Prints hit rate, matched lengths, prompt tokens saved, prefill
   chunks, chunk p50, TTFT p50, prefill s, decode p50, run s, cached
   tokens and segments, and each segment copy's ms and GB/s (CUDA
   events);
13. serves preemption at full width (phase 12's engine, dense decode,
   ``SchedulerConfig(preemption=True)``): phase 5's first 8 prompts as
   best-effort requests (64 new tokens) driven until each holds 2
   tokens, then 4 interactive requests (32-96-token prompts from the
   seed, 16 new tokens); the same config and submit order without
   preemption is the reference.  Every request's tokens must be equal
   in the two runs, ``preemptions == resumes >= 1``, nothing built after
   warmup, no pool tensor moved, and a direct suspend -> resume of 300
   positions into another slot must leave the bytes bit-equal.  Prints
   suspend and resume ms, interactive TTFT p50 and best-effort finish
   time with and without preemption;
14. serves through the HTTP gateway (``serving/gateway.py``) at full
   width: phase 5's dense engine runs phase 5's trace directly, twice
   without and twice with ``Telemetry.full()`` (alternating;
   their decode p50s give the telemetry's cost per step), then
   through a gateway with ``Telemetry.full()`` (event sink, trace sink)
   and a thread scraping ``/metrics`` every 50 ms, then through a gateway
   with ``NULL_TELEMETRY`` and no scraper; the 12 requests go at once
   from stdlib clients on threads, every other one streaming (SSE).
   Every answer must be 200, the tokens equal the direct run's, nothing
   be built after warmup, every scrape pass ``validate_exposition`` with
   no counter falling, the exported trace pass
   ``validate_chrome_trace`` with one ``submit`` and one ``finish`` per
   request.  Prints HTTP TTFT p50 (client clock) beside the direct
   run's TTFT of the same requests, decode tok/s and decode p50 of all
   three.  Then phase 8's calibrated ladder under its SLO controller
   behind a gateway: every request completes, the launches equal the
   sparse passes executed (as in phase 5), the transitions are printed,
   and a ``ProfilerSession`` window over 8 decode steps at a sparse rung
   must hold ``score_select`` and ``sparse_matmul_shared`` kernels in its
   exported trace.  Then a burst of 12 into a queue bounded at 2: some
   429 with ``Retry-After`` >= 1, the rest 200, ``rejected`` equal to the
   429s.  Last, ``python -m repro_torch.launch.serve --gateway --reduced``
   in a subprocess gets one streaming request and SIGTERM while it is in
   flight: the request finishes, the process exits 0, its trace and event
   files are complete.  An exception on any thread (recorded through
   ``threading.excepthook``) or a client timeout fails the phase;
15. the quality monitor and the flight recorder, at full width on phase
   8's ladder and SLO with phase 5's trace: served without and with a
   ``QualityMonitor`` (every decode step probed, a recon pass every 4th
   probe over 16 tokens): tokens and rungs equal, the probe and recon
   steps built once at warmup (nothing after), the probes equal to the
   decode steps, the launches equal to the sparse passes (the probe and
   the recon pass launch no sparse kernel), decode utilization per rung
   in (0, 1.05], each rung-0 probe that names another token than the
   served decode reported with the decode's top-2 gap (``near_ties``);
   prints per rung agreement, top-k overlap, recon mean against the
   calibration baseline and utilization, and the probe's and the recon
   pass's host and device ms.  Then a forced drift (block 5 of rung 1
   re-baselined to its lowest-scoring channels) under
   ``SLOConfig(quality_aware=True)``: one ``saliency_drift`` event naming
   it, pressure above 0, and a ``quality`` step down to rung 0.  Then
   the ladder with preemption recorded into a JSONL sink and replayed
   into a fresh engine over the same params: ``ReplayReport.ok``, every
   token, rung and decision equal, nothing built after warmup (prints
   the replay's and the params fingerprint's time).  Then
   ``GET /v1/debug/flight`` through a gateway returns the ring; last,
   ``serve --gateway --reduced --flight-record --flight-dump-dir`` in a
   subprocess dumps its ring on SIGUSR1, and ``python -m
   repro_torch.obs.flight.replay`` replays the dump with exit 0.  The
   serve CLI subprocesses of phases 14-18 and 21 run together once this
   phase has freed the card (``serve_clis``), timed as one phase;
16. serves full-width gemma2_2b (8 of its 26 layers, d_model 2304, 8 heads with 4
   KV heads of 256, d_ff 9216, vocab 256000, local/global layers with a
   4096 window, softcaps, bf16, random weights from SEED): 8 slots,
   ``max_len`` 4608, 12 requests of 32 new tokens (4 prompts of
   4100-4500 tokens, two of one length, and 8 of phase 5's lengths),
   dense, ``pallas``, ``pallas``, dense (uncalibrated), ``pallas`` with
   ``prefill_dense_frac`` 0 (whole prompts through the kernels) and a
   0.5 plan calibrated at full width with the ``--calib-quick`` budget.
   Each run must resolve the ``whole`` strategy, decode with rows past
   the window (rolled caches), build no decode step after warmup and
   launch each kernel 182 times per sparse pass (graph replays, the
   warm call, sparse whole prefills); the dense runs must repeat their
   tokens, the captured decode step must equal the eager one at rolled
   positions, and ``serve --arch gemma2_2b --reduced`` must exit 0.
   Prints decode tok/s, p50/p95, TTFT p50, whole-prefill ms per prompt
   length, device ms per traced decode step and the phase's wall time;
17. serves full-width granite_moe_3b_a800m (8 of 32 layers, d_model 1536, 24
   heads with 8 KV heads of 64, 40 experts padded to 48, top-8, expert
   d_ff 512, bf16, random weights from SEED) on phase 5's trace: dense,
   ``pallas``, ``pallas``, dense (uncalibrated), each warmed first.  Each
   run must resolve the ``chunked`` strategy and build no decode or chunk
   step after warmup; each sparse pass must launch ``score_select`` and
   ``sparse_matmul_shared`` 32 times (8 layers x 4 attention
   projections) and each ``_experts`` kernel 24 times (8 x 3
   expert-batched projections), 56 launches of each kernel in all; the
   dense runs must repeat their tokens and the captured decode step must
   equal the eager one.  Prints decode tok/s, p50/p95, TTFT p50, chunk
   p50, the capacity drops per chunk, device ms per traced decode step,
   the top ops of one eager decode step, and runs ``serve --arch
   granite_moe_3b_a800m --mode pallas`` at full width (exit 0);
18. serves full-width mamba2_130m (8 of 24 layers, d_model 768, d_inner 1536,
   24 heads of 64, state 128, conv 4, vocab 50280, tied head, bf16,
   random weights from SEED): 8 slots, whole-prompt prefill, 12 prompts
   of 32 new tokens (3 of 8192 tokens, which batch as one whole prefill,
   one of 4099, a prime length on which the SSD chunk length falls to
   1, and 8 of phase 5's lengths), dense, ``pallas``, ``pallas``, dense
   (uncalibrated) and ``pallas`` with ``prefill_dense_frac`` 0.  Each
   run must resolve the ``whole`` strategy, build no decode step after
   warmup and launch each kernel 48 times (8 layers x 6 projections,
   derived from the policy) per sparse pass (graph replays, the warm
   call, sparse whole prefills); each mode's two runs must give the same
   tokens, a decode step built on a busy engine must leave every SSM
   leaf bit-equal, the captured decode step must equal the eager one,
   and ``serve --arch mamba2_130m`` (full width) and ``serve --arch
   jamba_v01_52b --reduced`` must exit 0.  Prints decode tok/s, p50/p95,
   TTFT p50, whole-prefill ms per prompt length, device ms per traced
   decode step and the top ops of one eager step, and the decode step's
   byte bound split into conv/SSM state and the rest;
19. trains on the card.  19a runs ``examples/train_then_sparsify.py``'s
   recipe on reduced llama31_8b through ``launch.train.train`` (200
   steps of 8 x 96 tokens, lr 5e-3, checkpoints every 50): once
   uninterrupted and once preempted at step 120, whose final params must
   be bit-equal; once on the CPU from the card run's init, whose
   per-step losses the card's must match within ``TRAIN_LOSS_TOL``; once
   on the card with TF32 products, whose losses must miss that limit;
   then
   WiSparse at 0.3/0.4/0.5 with the example's search budget (held-out
   ppl, retention, top-1 agreement under ``mask``) and spec decoding
   (gamma 2, the 0.5 rung of a ``pallas`` ladder calibrated on the model
   drafting) on the trained model and on its random init, launches
   checked as in phase 11.  19b trains full-width gemma2_2b (its first
   ``SERVE_DEPTH`` = 8 of 26 layers; bf16 params,
   f32 master, m and v) 30 steps of 2 x 1024 tokens: every loss finite,
   the last below the first; prints step time p50, tokens/s, MFU and
   peak memory, one step split into forward + backward and the update
   with its top ATen ops by device time, then one step at
   ``remat="full"``, an async checkpoint round trip of the trained
   params (bit-equal) and the restored params served dense and
   ``pallas`` on phase 16's 8 short prompts, launches checked as in
   phase 16;
20. runs the enc-dec and VLM families at full width, cut to
   ``MULTIMODAL_DEPTH`` = 4 layers (whisper: that many encoder and decoder
   layers), through the static-batch loop (``generate``; the engine refuses these families,
   as the reference's does): ``api.make_prefill_step`` with frames or
   patch embeddings, the caches padded as the reference's
   ``_pad_caches``, then the decode step of a
   ``serving/graphs.BatchDecodeSteps`` per run, one key per mode (dense,
   ``mask``, uncalibrated ``pallas``: keep 0.5, tau -inf), each built
   once before the passes and replayed (a CUDA graph; 32 or 28
   launches of each kernel recorded per sparse replay).  whisper_large_v3
   (4 + 4 of its 32 + 32 layers, d_model 1280, 20 heads of 64, d_ff
   5120, vocab 51866, 1500 frames, bf16, random weights and frame
   embeddings from SEED): the encoder's time, then (a) 4 utterances with
   4-token decoder start sequences and (b) one with a 224-token prompt,
   64 new tokens each, through the graphs dense, ``mask``, ``pallas``,
   ``pallas``, ``mask``, dense (each mode repeats its tokens), then the
   eager loop once per mode (its tokens equal the graph's); a sparse
   run launches each kernel 40 times in its prefill (4 x (4 self, 4
   cross, 2 MLP projections); the cross-KV stash is dense) and 32 per
   decode step (4 x (4 + 2 + 2)), any other run none.  8 eager decode
   steps of run (a) traced dense and ``pallas`` give device ms per step
   and the top ops beside the step's byte bound, printed with decode p50
   graph against eager (host ms per step, synced per step) and the
   card's name and power limit.  Then a 0.5 plan calibrated on it
   with the ``--calib-quick`` stages on 2 x 64 tokens over their
   frames (calibration s, KL, ``k_max_frac``), served eagerly on run (a)
   (launches as above, the share of dense's tokens), and 20 training
   steps of 2 x 448 tokens over 1500 frames at ``remat="full"`` (every
   loss finite, the last below the first; step p50, peak memory).  Then
   internvl2_26b's language model (4 of its 48 layers, d_model 6144, 48
   heads with 8 KV heads of 128, d_ff 16384, vocab 92553, bf16,
   initialised leaf by leaf on the card after every earlier model is
   freed): 2 sequences of 256 patch embeddings and 128 tokens, 32 new
   tokens, the same graph and eager passes, 28 launches of each kernel
   per sparse pass (4 x 7), the same traces and bounds;
21. runs the serve CLI's ``--legacy`` loop (``launch/serve.generate``)
   on llama31_8b at full width (``SERVE_DEPTH`` layers) over the CLI's
   4 x 64-token prompts, 32 new tokens, dense, uncalibrated ``pallas``
   (the CLI's sp: keep 0.5, tau -inf), ``pallas``, dense: a dense
   prefill, then the decode step built once per call and replayed;
   each mode repeats its tokens and equals the eager loop's, a ``pallas``
   call launches each kernel (1 warm call + 31 replays) x 56 = 1,792
   times, a dense call none.  Then ``python -m
   repro_torch.launch.serve --legacy --arch llama31_8b --mode pallas`` at
   full width and full depth in a subprocess must exit 0 and print its
   tok/s line, and on reduced llama31_8b (f32) the whole-prefill
   engine's tokens must equal ``generate``'s for equal-length prompts,
   dense and ``topk_shared`` (``tests/test_serving.py``'s invariant);
22. runs the sharded steps on a 1x1 mesh: an NCCL group of one rank
   (``init_method="file://..."``) and ``launch/mesh.make_host_mesh()``
   on the card.  Full-width llama31_8b (``SERVE_DEPTH`` layers, the
   unsharded run's weights) placed by ``LOGICAL_RULES_SERVE`` serves a
   4 x 128-token prefill and 16 ``aligned`` decode steps under
   uncalibrated ``pallas`` (keep 0.5, tau -inf): the greedy tokens equal
   the unsharded run's, the logits within 3e-2 (the largest difference
   printed), and every sparse pass launches ``score_select`` and
   ``sparse_matmul_shared`` 56 times each, as unsharded.  One
   ``LOGICAL_RULES_TRAIN`` train step (loss, grads, AdamW) of gemma2_2b
   at 2 layers of its published width: loss and updated params within
   3e-2 of the unsharded step's.  The dry run's ``argument_bytes`` of
   that serve cell (depth, batch, cache length, sp tree) on meta tensors
   within 1% of ``torch.cuda.memory_allocated()``'s growth when the same
   arguments are placed on the card.  The group is destroyed at the end;
23. runs the port's static checker (``repro_torch.analysis``) on the
   card: the AST passes over ``src/repro_torch`` and the three global
   passes on ``cuda`` — ``graph-in-place`` (reduced llama31_8b's warmup
   set, 3 ``pallas`` rungs, spec at gamma 2, captured: no pool leaf moves
   or is copied whole, eagerly or in a replay, and no capture keeps a
   leaf's bytes in its graph pool), ``graph-keys`` (captures only in
   ``GraphSpace.capture``, stable keys, nothing built under deep-copied
   policies) and ``launch-geometry`` (every kernel's grid, block, shared
   memory and cluster over ten archs' projection shapes at published
   width, B = 1, 8, 32, 448, held against ``wisparse_launch_info`` and the
   card's own limits, every ``score_select`` cluster shape able to run).
   Prints the findings (none outside ``analysis-baseline-torch.json``),
   each pass's seconds, the shapes and comparisons, and each kernel's
   largest shared memory with its headroom;
24. serves one period of jamba_v01_52b at published width (its first
   ``SERVE_DEPTH`` = 8 of 32 layers, the layer pattern once: 7 mamba
   mixers of d_inner 8192, state 16 and 128 heads, one attention layer
   of 32 heads and 8 KV heads of 128 with no positions, 4 dense FFNs of
   d_ff 14336 and 4 MoE FFNs of 16 experts of d_ff 14336, top-2; vocab
   65536, bf16, 13.27B parameters from SEED) through the port's
   ``Engine``: 8 slots, whole-prompt prefill, ``max_len`` 4608, 8
   prompts of 256-4096 tokens (one of 4096, none of a prime length), 32
   new tokens each, dense, ``pallas``, ``pallas``, dense (uncalibrated),
   ``pallas`` with ``prefill_dense_frac`` 0 twice, and a 0.5 plan calibrated
   on the period with the ``--calib-quick`` budget served twice.  Each
   run must build no decode step after warmup and launch 58 of each 2-D
   kernel and 12 of each ``_experts`` kernel per sparse pass, the
   expert matmul in its tile form exactly in the sparse whole prefills
   (12 each: every prompt's expert rows, 111-641, reach its threshold);
   each mode's runs must give the same tokens; the decode graph built on a
   busy engine must leave every SSM leaf bit-equal and equal the eager
   step (logits within 3e-2).  Prints the parameters and their bytes,
   the phase's peak memory, per run decode tok/s, p50/p95, TTFT p50,
   whole-prefill ms per prompt length (with sparse prefill on a line of
   its own, beside its TTFT and the dense runs') and device ms per traced
   decode step beside ``step_costs``' bytes and bound, the top ops of one
   eager
   decode step, the capacity drops of each whole prefill, and the plan's
   stage seconds, KL and ``k_max_frac``.  ``--jamba-only`` runs phase
   3's jamba part and this phase alone;
25. prints one JSON line describing every kernel, then, as its last line,
   ``{"ok": true, "device": {...}}``.  The ``launches`` of ``score_select``
   and ``sparse_matmul_shared`` come from phase 5's first ``pallas``
   run (whose llama31_8b decode layer their times are), those of the
   ``_experts`` kernels from phase 17's first ``pallas`` run (the 2-D
   kernels' ``max_abs_err`` covers every shape phase 3 held, mamba2's
   included), those of ``sparse_matmul_shared_experts_tile`` (the
   expert matmul's whole-prefill tile form, timed per jamba MoE layer at
   R = 641) from phase 24's sparse-prefill run, and those of
   ``sparse_matmul_per_seq`` from phase 3's
   ``wisparse_project(per_seq=True)`` calls, since no serving path
   reaches that kernel.

Any failed check raises, so the script exits nonzero and prints no
result line.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import inspect
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading

HERE = os.path.dirname(os.path.abspath(__file__))

import numpy as np
import torch

SEED = 0
# kernel test shapes (B, n, m, blk): tests/test_kernels.py SHAPES + AWKWARD
SHAPES = [(1, 256, 128, 128), (4, 512, 384, 128), (8, 1024, 512, 256),
          (3, 384, 256, 128)]
AWKWARD = [(5, 256, 257, 128), (13, 384, 131, 128), (9, 512, 384, 256),
           (1, 128, 1, 128)]
# llama31_8b projections of one layer, (role, n, m)
LAYER = [("attn/wq", 4096, 4096), ("attn/wk", 4096, 1024),
         ("attn/wv", 4096, 1024), ("attn/wo", 4096, 4096),
         ("mlp/wi_gate", 4096, 14336), ("mlp/wi_up", 4096, 14336),
         ("mlp/wo", 14336, 4096)]
# gemma2_2b projections of one layer (8 heads and 4 KV heads of 256)
GEMMA_LAYER = [("attn/wq", 2304, 2048), ("attn/wk", 2304, 1024),
               ("attn/wv", 2304, 1024), ("attn/wo", 2048, 2304),
               ("mlp/wi_gate", 2304, 9216), ("mlp/wi_up", 2304, 9216),
               ("mlp/wo", 9216, 2304)]
# granite_moe_3b_a800m: its attention projections (24 heads and 8 KV
# heads of 64) and its expert projections, each launched once for all 48
# experts (40 routed + 8 pad), 8 rows in decode (8 slots x capacity 1)
# and 9 in a 32-token chunk (capacity 9)
GRANITE_ATTN = [("attn/wq", 1536, 1536), ("attn/wk", 1536, 512),
                ("attn/wv", 1536, 512), ("attn/wo", 1536, 1536)]
GRANITE_EXPERTS = [("moe/wi_gate", 1536, 512), ("moe/wi_up", 1536, 512),
                   ("moe/wo", 512, 1536)]
GRANITE_E = 48
# The expert-batched selection's shapes on every MoE arch the port
# serves: (arch, padded experts E, routed experts, n of moe/wi_gate and
# moe/wi_up, n of moe/wo, expert rows R).  R: decode with 1, 8, 32 and
# 448 slots (capacity 1), then one group of 32 and of 448 tokens
# (``models/moe.expert_rows``).  Experts past the routed ones (or, with
# none, the last) have zero rows, as an expert no token chose.
EXPERT_SELECT = [
    ("granite_moe_1b_a400m", 32, 32, 1024, 512, (1, 8, 32, 448, 11, 141)),
    ("granite_moe_3b_a800m", 48, 40, 1536, 512, (1, 8, 32, 448, 9, 113)),
    ("jamba_v01_52b", 16, 16, 4096, 14336, (1, 8, 32, 448, 6, 71))]
# mamba2_130m projections of one layer (d_model 768, d_inner 1536, state
# 128, 24 heads): in_B, in_C and in_dt are a single ragged column tile
MAMBA_LAYER = [("mamba/in_z", 768, 1536), ("mamba/in_x", 768, 1536),
               ("mamba/in_B", 768, 128), ("mamba/in_C", 768, 128),
               ("mamba/in_dt", 768, 24), ("mamba/out_proj", 1536, 768)]
# whisper_large_v3's decode-layer projections (20 heads of 64): self
# attention, cross-attention's wq and wo (decode reads the static cross
# cache), the plain GELU MLP; its cross wk and wv run over the encoder
# output in prefill only, 1500 frames per utterance
WHISPER_LAYER = [("attn/wq", 1280, 1280), ("attn/wk", 1280, 1280),
                 ("attn/wv", 1280, 1280), ("attn/wo", 1280, 1280),
                 ("cross/wq", 1280, 1280), ("cross/wo", 1280, 1280),
                 ("mlp/wi", 1280, 5120), ("mlp/wo", 5120, 1280)]
WHISPER_CROSS_KV = [("cross/wk", 1280, 1280), ("cross/wv", 1280, 1280)]
# rows of the cross wk/wv projections: one utterance's frames, and phase
# 20's 4 utterances
WHISPER_CROSS_ROWS = [1500, 6000]
# internvl2_26b's language model (48 heads and 8 KV heads of 128)
INTERNVL_LAYER = [("attn/wq", 6144, 6144), ("attn/wk", 6144, 1024),
                  ("attn/wv", 6144, 1024), ("attn/wo", 6144, 6144),
                  ("mlp/wi_gate", 6144, 16384), ("mlp/wi_up", 6144, 16384),
                  ("mlp/wo", 16384, 6144)]
# jamba_v01_52b's 2-D projection shapes (32 heads and 8 KV heads of 128;
# a mamba mixer of d_inner 8192, state 16 and 128 heads: in_B, in_C and
# in_dt are one ragged column tile; the dense FFN's d_ff 14336), and its
# expert shapes (16 experts of d_ff 14336, top-2), launched once for all
# 16 experts at R = 8 (decode: 8 slots x capacity 1) and 111, 241 and 641
# (the capacities of 704-, 1536- and 4096-token whole prefills)
JAMBA_LAYER = [("attn/wq", 4096, 4096), ("attn/wk", 4096, 1024),
               ("attn/wv", 4096, 1024), ("attn/wo", 4096, 4096),
               ("mamba/in_z", 4096, 8192), ("mamba/in_x", 4096, 8192),
               ("mamba/in_B", 4096, 16), ("mamba/in_C", 4096, 16),
               ("mamba/in_dt", 4096, 128), ("mamba/out_proj", 8192, 4096),
               ("mlp/wi_gate", 4096, 14336), ("mlp/wi_up", 4096, 14336),
               ("mlp/wo", 14336, 4096)]
JAMBA_EXPERTS = [("moe/wi_gate", 4096, 14336), ("moe/wi_up", 4096, 14336),
                 ("moe/wo", 14336, 4096)]
JAMBA_E = 16
JAMBA_EXPERT_ROWS = (8, 111, 241, 641)
# the expert matmul's rows timed in both forms (decode, a 32-token chunk,
# a 448-token chunk's 71, then whole prefills of 704, 1536 and 4096
# tokens); the rows of a 4096-token whole prefill at which jamba's 13 2-D
# shapes are timed in the tile form at E = 1
EXPERT_FORM_ROWS = (8, 32, 71, 111, 241, 641)
TILE_EVIDENCE_B = 4096
# the projection roles of each mixer and FFN kind: one launch of each
# 2-D kernel per role that runs pallas (an expert role: one of each
# _experts kernel for all the layer's experts)
KIND_ROLES = {
    "attn": ("attn/wq", "attn/wk", "attn/wv", "attn/wo"),
    "mamba": tuple(r for r, _n, _m in MAMBA_LAYER),
    "dense": ("mlp/wi_gate", "mlp/wi_up", "mlp/wo"),
    "moe": ("moe/wi_gate", "moe/wi_up", "moe/wo"),
    "none": ()}
KIND_ROLES["local"] = KIND_ROLES["global"] = KIND_ROLES["attn"]
BLK = 128
KEEP = 0.5
# Tolerances.  Kernel and plain version both upcast their inputs to f32
# exactly (bf16 -> f32 is exact) and accumulate in f32, so they differ only
# in summation order: |err| <= 1e-4 + 1e-4*|ref| covers f32 rounding over
# sums of up to 14336 terms.  The score mask itself is a comparison: inputs
# are made tie-free (no score within 0.1% of tau), so xm must match
# exactly.
RTOL = ATOL = 1e-4
# reduced model, card vs CPU, f32: the same tolerance the CPU parity tests
# use for logits (sums in another order over 2 layers)
LOGIT_ATOL = 1e-4
# decode steps of each serving run traced by torch.profiler (busy share)
WINDOW = 8
# The reduced Gemma checks (phase 4, tests/test_torch_gemma.py and
# tests/test_torch_gpu.py) scale every attention and MLP weight by this:
# at the default init the tied, sqrt(d)-scaled embedding dominates the
# residual stream and every reduced Gemma emits one token forever, which
# no token comparison could tell apart.
GEMMA_WEIGHT_SCALE = 8.0
# Depth of the full-width models that phases 5-18 serve: each keeps its
# published widths and layer pattern and runs its first SERVE_DEPTH
# layers, so that the whole script ends well inside its 1200 s limit.
# Phase 19b's gemma2_2b trainer is cut to the same depth, and phase 20's
# whisper_large_v3 (encoder and decoder) and internvl2_26b to
# MULTIMODAL_DEPTH; phase 24 serves one period of jamba_v01_52b, which is
# SERVE_DEPTH layers.
SERVE_DEPTH = 8
MULTIMODAL_DEPTH = 4
# Times of the v1 matmul kernels (one thread block per 64 columns walking
# the kept blocks on CUDA cores; us, CUDA-graph replay, bf16, 50% kept,
# cold L2, this script on an NVIDIA H100 80GB HBM3 at 700 W), printed
# beside this run's: (B, role) -> (sparse_matmul_shared,
# sparse_matmul_per_seq)
V1_US = {
    (8, "attn/wq"): (53.53, 42.51), (8, "attn/wk"): (49.66, 27.67),
    (8, "attn/wv"): (49.66, 28.50), (8, "attn/wo"): (54.09, 44.33),
    (8, "mlp/wi_gate"): (59.16, 145.92), (8, "mlp/wi_up"): (59.09, 146.57),
    (8, "mlp/wo"): (189.34, 163.75),
    (32, "attn/wq"): (56.06, 137.65), (32, "attn/wk"): (47.44, 38.21),
    (32, "attn/wv"): (47.36, 37.83), (32, "attn/wo"): (56.22, 136.45),
    (32, "mlp/wi_gate"): (151.52, 549.30), (32, "mlp/wi_up"): (151.92, 547.95),
    (32, "mlp/wo"): (190.02, 559.12)}
# The unfused score_mask kernel (one thread block per channel block,
# scoring and block sums only; the selection then ran as a dozen PyTorch
# ops), per decode layer at B = 8 (us, CUDA-graph replay, this script on
# an NVIDIA H100 80GB HBM3 at 700 W), printed beside score_select's
SCORE_MASK_UNFUSED_US = 18.06


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def bound_ms(nbytes: float, flops: float, dtype, rates):
    mem, bf16, f32 = rates
    t_mem = nbytes / mem
    t_ops = flops / (bf16 if dtype == torch.bfloat16 else f32)
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else
                                     "operations")


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn(i)``: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's launch overhead (tens of microseconds per PyTorch op on the
    card's host) is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):          # allocator and cuBLAS workspace warm-up
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def launched(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {err}")


def direct_matmul(K, build, name, x, ws, idx, m, kb, per_seq):
    """``fn(i)`` calling the C entry of the block-gather matmul ``name``
    on weight copy ``ws[i % len(ws)]``, with its output and split-K
    scratch allocated once here (kernel-only timing), and its plan."""
    B, n = x.shape
    plan = K.launch_plan(B, n, m, kb, BLK, per_seq, x.element_size())
    y = torch.empty(B, m, device=x.device)
    scratch, cnt = K.matmul_scratch(plan, x.device)
    entry = getattr(build.library(), "wisparse_" + name)

    def fn(i):
        launched(entry(x.data_ptr(), ws[i % len(ws)].data_ptr(),
                       idx.data_ptr(), y.data_ptr(),
                       None if scratch is None else scratch.data_ptr(),
                       None if cnt is None else cnt.data_ptr(), B, n, m, BLK,
                       kb, plan.rows, plan.cols, plan.splits, 1,
                       torch.cuda.current_stream().cuda_stream))
    return fn, plan


def direct_expert_matmul(K, build, x, ws, idx, plan):
    """``fn(i)`` calling ``wisparse_sparse_matmul_shared_experts`` with
    ``plan``'s form on (x, ``ws[i % len(ws)]``, idx), its output and
    split-K scratch allocated once here (kernel-only timing, and no
    launch counted), and that output."""
    E, R, n = x.shape
    m = ws[0].shape[2]
    y = torch.empty(E, R, m, device=x.device)
    scratch, cnt = K.matmul_scratch(plan, x.device)
    entry = build.library().wisparse_sparse_matmul_shared_experts

    def fn(i):
        launched(entry(x.data_ptr(), ws[i % len(ws)].data_ptr(),
                       idx.data_ptr(), y.data_ptr(),
                       None if scratch is None else scratch.data_ptr(),
                       None if cnt is None else cnt.data_ptr(), E, R, n, m,
                       BLK, idx.shape[1], plan.rows, plan.cols, plan.splits,
                       1, torch.cuda.current_stream().cuda_stream))
    return fn, y


def bit_equal(name: str, fn) -> None:
    """Two launches of the same inputs give the same bits (in each output
    where ``fn`` returns a tuple)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError(f"{name}: two launches differ")


def tie_free(x: np.ndarray, g: np.ndarray, alpha: float, tau: float,
             dtype) -> np.ndarray:
    """Scale by 1.05 every x whose score lands within 0.1% of tau, so the
    threshold decision cannot depend on rounding (pow implementations)."""
    xq = torch.from_numpy(x).to(dtype).float().numpy().astype(np.float64)
    s = np.abs(xq) * np.maximum(g.astype(np.float64), 1e-12) ** alpha
    near = np.abs(s - tau) <= 1e-3 * max(abs(tau), 1e-3)
    x = x.copy()
    x[near] *= 1.05
    return x


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.float() - want.float()).abs()
    lim = ATOL + RTOL * want.float().abs()
    if bool((err > lim).any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version, max abs err "
            f"{float(err.max()):.3e}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_select(name: str, got, want, kb_l: int, unranked) -> float:
    """``score_select``'s (xm, idx, bs) against its plain version's: bs
    within the tolerance; idx equal, or else every pair of ids that
    differ has plain block scores within the bs tolerance of each other
    (a near tie that the summation order breaks either way; printed); xm
    bit-equal to the plain score mask before the rank mask (``unranked()``,
    ``ref_score_mask``'s xm) zeroed outside the first ``kb_l`` blocks of
    the kernel's own idx (the plain xm itself when idx is equal).
    Returns the largest bs error."""
    xm, idx, bs = got
    xm_r, idx_r, bs_r = want
    err = check_close(f"{name} bs", bs, bs_r)
    if not torch.equal(idx, idx_r):
        ranks = (idx != idx_r).nonzero().flatten().tolist()
        for r in ranks:
            a, b = float(bs_r[idx[r].long()]), float(bs_r[idx_r[r].long()])
            if abs(a - b) > ATOL + RTOL * abs(b):
                raise AssertionError(
                    f"{name}: idx[{r}] = {int(idx[r])} (plain bs {a}) where "
                    f"the plain version ranks {int(idx_r[r])} (plain bs {b})")
        print(f"  {name}: idx differs from the plain version at ranks "
              f"{ranks}, between block scores within the tolerance: kernel "
              f"{idx[ranks].tolist()}, plain {idx_r[ranks].tolist()}")
        blk = xm.shape[1] // bs.numel()
        kept = torch.zeros(bs.numel(), dtype=torch.bool, device=xm.device)
        kept[idx[:kb_l].long()] = True
        xm_u = unranked()
        xm_r = torch.where(kept.repeat_interleave(blk)[None], xm_u,
                           torch.zeros_like(xm_u))
        if torch.unique(idx).numel() != idx.numel():
            raise AssertionError(f"{name}: idx repeats a block: {idx}")
    if not torch.equal(xm, xm_r):
        raise AssertionError(f"{name}: xm differs from the plain version")
    return err


def rank_limit(keep_frac: float, nb: int, kb: int) -> int:
    """min(kb, round(keep_frac * nb)), the product in f32 and rounded half
    to even, as the kernel and the plain version take it."""
    return min(kb, int(torch.round(torch.tensor(keep_frac) * nb)))


def check_kernel_shapes(K, ref, dev) -> dict:
    """All three kernels on SHAPES + AWKWARD in f32 and bf16:
    ``score_select`` with keep_frac 0.5 and 0.375 under k_frac 0.5 (and
    its mask alone, ``score_mask``), with finite taus."""
    errs = {"score_select": 0.0, "sparse_matmul_shared": 0.0}
    rng = np.random.default_rng(SEED)
    for (B, n, m, blk) in SHAPES + AWKWARD:
        for dtype in (torch.float32, torch.bfloat16):
            x = rng.standard_normal((B, n)).astype(np.float32)
            w = (rng.standard_normal((n, m)) * 0.1).astype(np.float32)
            g = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
            xt = torch.from_numpy(x).to(dev, dtype)
            wt = torch.from_numpy(w).to(dev, dtype)
            idx = torch.arange(0, n // blk, 2, dtype=torch.int32, device=dev)
            y = K.sparse_matmul_shared(xt, wt, idx, blk=blk)
            torch.cuda.synchronize()
            assert y.shape == (B, m) and y.dtype == torch.float32
            errs["sparse_matmul_shared"] = max(
                errs["sparse_matmul_shared"], check_close(
                    f"sparse_matmul_shared {B, n, m, blk} {dtype}", y,
                    ref.ref_sparse_matmul_shared(xt, wt, idx, blk)))
            nb = n // blk
            kb = max(1, round(nb * KEEP))
            for alpha, tau in ((0.0, 0.3), (0.7, 0.5), (1.5, 1.0)):
                xs = torch.from_numpy(tie_free(x, g, alpha, tau, dtype)).to(
                    dev, dtype)
                gt = torch.from_numpy(g).to(dev)
                a = torch.tensor(alpha, device=dev)
                t = torch.tensor(tau, device=dev)
                rw = torch.from_numpy(rng.random(B).astype(np.float32)).to(dev)
                xm, bs = K.score_mask(xs, gt, a, t, blk=blk, row_weights=rw)
                torch.cuda.synchronize()
                xm_r, bs_r = ref.ref_score_mask(xs, gt, a, t, blk, rw)
                if not torch.equal(xm, xm_r):
                    raise AssertionError(
                        f"score_mask {B, n, blk} {dtype} a={alpha}: masked x "
                        "differs from the plain version")
                errs["score_select"] = max(errs["score_select"], check_close(
                    f"score_mask {B, n, blk} {dtype}", bs, bs_r))
                for keep in (KEEP, 0.375):
                    kf = torch.tensor(keep, device=dev)
                    name = f"score_select {B, n, blk} {dtype} a={alpha} " \
                        f"keep={keep}"
                    got = K.score_select(xs, gt, a, t, kf, kb=kb, blk=blk,
                                         row_weights=rw)
                    torch.cuda.synchronize()
                    errs["score_select"] = max(
                        errs["score_select"], check_select(
                            name, got, ref.ref_score_select(
                                xs, gt, a, t, kf, blk, kb, rw),
                            rank_limit(keep, nb, kb),
                            lambda: xm_r))
                    bit_equal(name, lambda: K.score_select(
                        xs, gt, a, t, kf, kb=kb, blk=blk, row_weights=rw))
    errs["sparse_matmul_per_seq"] = 0.0
    for (B, n, m, blk) in SHAPES + AWKWARD:
        nb = n // blk
        kb = max(nb // 2, 1)
        ids = np.stack([(np.arange(kb) + b) % nb for b in range(B)])
        for dtype in (torch.float32, torch.bfloat16):
            x = rng.standard_normal((B, n)).astype(np.float32)
            w = (rng.standard_normal((n, m)) * 0.1).astype(np.float32)
            xt = torch.from_numpy(x).to(dev, dtype)
            wt = torch.from_numpy(w).to(dev, dtype)
            idx = torch.from_numpy(ids.astype(np.int32)).to(dev)
            y = K.sparse_matmul_per_seq(xt, wt, idx, blk=blk)
            torch.cuda.synchronize()
            assert y.shape == (B, m) and y.dtype == torch.float32
            errs["sparse_matmul_per_seq"] = max(
                errs["sparse_matmul_per_seq"], check_close(
                    f"sparse_matmul_per_seq {B, n, m, blk} {dtype}", y,
                    ref.ref_sparse_matmul_per_seq(xt, wt, idx, blk)))
    print(f"kernel shapes: {len(SHAPES + AWKWARD)} shapes x f32/bf16 agree "
          f"(score_select: 3 taus x keep_frac {KEEP}/0.375, two launches "
          f"bit-equal), sparse_matmul_per_seq too (max abs err {errs})")
    return errs


def direct_select(build, x, g, alpha, tau, keep, rw, kb):
    """``fn(i)`` calling ``score_select``'s C entry on outputs allocated
    once here (kernel-only timing)."""
    B, n = x.shape
    xm = torch.empty_like(x)
    idx = torch.empty(kb, dtype=torch.int32, device=x.device)
    bs = torch.empty(n // BLK, device=x.device)
    entry = build.library().wisparse_score_select

    def fn(i):
        launched(entry(x.data_ptr(), g.data_ptr(), alpha.data_ptr(),
                       tau.data_ptr(), keep.data_ptr(), rw.data_ptr(),
                       xm.data_ptr(), idx.data_ptr(), bs.data_ptr(), B, n,
                       BLK, kb, 1,
                       torch.cuda.current_stream().cuda_stream))
    return fn


def main_path_kernels(K, ref, build, dev, rates, layer=LAYER,
                      batches=(8, 32, 448), v1=True) -> tuple:
    """The kernels at one model's projection shapes (``layer``: llama31_8b's
    by default, gemma2_2b's for phase 16's path), bf16.
    ``score_select`` at each B of ``batches`` (8 decode slots, 32 one
    prefill chunk, 448 a whole prompt), alpha 1 and a finite tau (a
    quarter of the mean g, so about a fifth of the channels fall below
    it), k_frac 0.5 with keep_frac 0.5 and 0.375.
    ``sparse_matmul_shared`` at B = 8 and 32 on the kept blocks of
    ``score_select`` (keep_frac 0.5), its weights rotated through copies
    that exceed the 50 MB L2 so each launch reads them cold; ``v1``
    prints the v1 kernel's llama31_8b times beside them."""
    rng = np.random.default_rng(SEED + 1)
    rows = []
    errs = {"score_select": 0.0, "sparse_matmul_shared": 0.0}
    for B in batches:
        for role, n, m in layer:
            dt = torch.bfloat16
            x = torch.from_numpy(rng.standard_normal((B, n)).astype(
                np.float32)).to(dev, dt)
            w = (torch.randn(n, m, device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED)) * 0.02).to(dt)
            g = torch.sqrt((w.float() ** 2).sum(1))
            alpha = torch.tensor(1.0, device=dev)
            tau = 0.25 * g.mean()
            rw = torch.ones(B, device=dev)
            nb = n // BLK
            kb = round(nb * KEEP)
            for keep in (0.375, KEEP):
                kf = torch.tensor(keep, device=dev)
                name = f"score_select {role} B={B} keep={keep}"
                got = K.score_select(x, g, alpha, tau, kf, kb=kb, blk=BLK,
                                     row_weights=rw)
                torch.cuda.synchronize()
                errs["score_select"] = max(errs["score_select"], check_select(
                    name, got, ref.ref_score_select(x, g, alpha, tau, kf, BLK,
                                                    kb, rw),
                    rank_limit(keep, nb, kb), lambda: ref.ref_score_mask(
                        x, g, alpha, tau, BLK, rw)[0]))
                bit_equal(name, lambda: K.score_select(
                    x, g, alpha, tau, kf, kb=kb, blk=BLK, row_weights=rw))
            xk, idx, _ = got                    # keep_frac 0.5
            t_sel = graph_ms(direct_select(build, x, g, alpha, tau, kf, rw,
                                           kb))
            t_sel_plain = graph_ms(lambda i: ref.ref_score_select(
                x, g, alpha, tau, kf, BLK, kb, rw))
            # x read, xm written, g, alpha, tau and keep_frac, the row
            # weights, bs and idx
            sel_bytes = 2 * B * n * 2 + n * 4 + 12 + B * 4 + nb * 4 + kb * 4
            sel_bound, sel_by = bound_ms(sel_bytes, 6.0 * B * n,
                                         torch.float32, rates)
            row = {"B": B, "role": role, "n": n, "m": m, "kb": kb,
                   "score_select": {
                       "ms": t_sel, "plain_ms": t_sel_plain,
                       "library_ms": None, "bound_ms": sel_bound,
                       "bound_by": sel_by}}
            line = (f"  B={B:3d} {role:12s} n={n:5d} m={m:5d} kb={kb:3d} | "
                    f"score_select {t_sel * 1e3:6.2f} us"
                    f" (plain {t_sel_plain * 1e3:7.2f}, bound "
                    f"{sel_bound * 1e3:5.2f} us)")
            if B <= 32:
                y = K.sparse_matmul_shared(xk, w, idx, blk=BLK)
                torch.cuda.synchronize()
                bit_equal(f"sparse_matmul_shared {role} B={B}",
                          lambda: K.sparse_matmul_shared(xk, w, idx, blk=BLK))
                errs["sparse_matmul_shared"] = max(
                    errs["sparse_matmul_shared"], check_close(
                        f"sparse_matmul_shared {role} B={B}", y,
                        ref.ref_sparse_matmul_shared(xk, w, idx, BLK)))
                copies = max(1, math.ceil(200e6 / (n * m * 2)))
                ws = [w] + [w.clone() for _ in range(copies - 1)]
                mm_kernel, plan = direct_matmul(
                    K, build, "sparse_matmul_shared", xk, ws, idx, m, kb,
                    False)
                t_mm = graph_ms(mm_kernel)
                t_mm_plain = graph_ms(lambda i: ref.ref_sparse_matmul_shared(
                    xk, ws[i % copies], idx, BLK))
                t_mm_lib = graph_ms(lambda i: torch.matmul(xk,
                                                           ws[i % copies]))
                del ws
                # the kept x blocks, the kept weight rows, the ids and y
                mm_bytes = (B * kb * BLK * 2 + kb * BLK * m * 2 + kb * 4
                            + B * m * 4)
                mm_bound, mm_by = bound_ms(mm_bytes, 2.0 * B * kb * BLK * m,
                                           dt, rates)
                row["sparse_matmul_shared"] = {
                    "ms": t_mm, "plain_ms": t_mm_plain,
                    "library_ms": t_mm_lib, "bound_ms": mm_bound,
                    "bound_by": mm_by, "splits": plan.splits,
                    "blocks": math.prod(plan.grid)}
                old = f"v1 {V1_US[B, role][0]:7.2f}, " if v1 else ""
                line += (f" | sparse_matmul_shared {t_mm * 1e3:8.2f} us ({old}"
                         f"plain {t_mm_plain * 1e3:8.2f}, torch.matmul dense "
                         f"{t_mm_lib * 1e3:8.2f}, bound "
                         f"{mm_bound * 1e3:6.2f} = "
                         f"{100 * mm_bound / t_mm:5.1f}%, grid {plan.grid})")
            rows.append(row)
            print(line)
    return rows, errs


def calibrated_tau(x, g, alpha: float) -> tuple:
    """A calibrated layer's threshold over an expert projection's input:
    the Eq. 7 median of the positive scores ``|x| * g^alpha`` of every
    expert's rows with each expert's own g (E, n), one tau shared by the
    experts (``CalibContext.tau_for`` at keep 0.5).  Returns (x made
    tie-free: every element whose score lies within 0.1% of tau scaled by
    1.05, so no decision hangs on rounding; tau)."""
    s = x.float().abs() * torch.pow(torch.clamp(g, min=1e-12), alpha)[:, None]
    pos = torch.sort(s[s > 0]).values
    tau = pos[int(0.5 * pos.numel())]
    near = (s - tau).abs() <= 1e-3 * tau
    return torch.where(near, x * 1.05, x).to(x.dtype), tau


def expert_kernels(K, ref, dev, rates, rows=(8, 9),
                   model="granite_moe_3b_a800m", shapes=GRANITE_EXPERTS,
                   E=GRANITE_E, routed=40) -> tuple:
    """The expert-batched ``score_select`` and ``sparse_matmul_shared`` at
    ``model``'s three expert shapes (``shapes``: granite_moe_3b_a800m's by
    default, 48 experts), each R of ``rows`` (granite: 8 decode rows, 9 of
    a 32-token chunk; jamba_v01_52b: 8 and the 641 of a 4096-token whole
    prefill), bf16, k_frac 0.5,
    keep_frac 0.5 and 0.375, at alpha 1 with tau -inf (the uncalibrated
    runs) and finite (a quarter of the mean g), and at alpha 0.7 with a
    calibrated, tie-free tau shared by the experts
    (:func:`calibrated_tau`).  Experts from ``routed`` on (granite's 8 pad
    experts, which no token chooses) have zero rows.  Per expert: xm
    bit-equal to the plain version, ids equal or tied within the
    tolerance (``check_select``), the matmul within 1e-4 + 1e-4 |ref|
    on the kernel's own kept blocks; two launches of each bit-equal.
    Timed at tau -inf by CUDA-graph replay (the weights rotated through
    copies beyond L2) beside the plain versions, dense ``torch.bmm`` and
    the bound (bytes over the card's memory rate)."""
    from repro_torch.kernels import geometry as G
    out = []
    errs = {"score_select": 0.0, "sparse_matmul_shared": 0.0}
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    alpha = torch.tensor(1.0, device=dev)
    for R in rows:
        for role, n, m in shapes:
            x = torch.randn(E, R, n, device=dev, generator=gen)
            x[routed:] = 0
            x = x.to(torch.bfloat16)
            w = (torch.randn(E, n, m, device=dev, generator=gen) * 0.02).to(
                torch.bfloat16)
            g = torch.sqrt((w.float() ** 2).sum(2))
            nb = n // BLK
            kb = round(nb * KEEP)
            x7, tau7 = calibrated_tau(x, g, 0.7)
            for a, xs, tau in (
                    (alpha, x, 0.25 * g.mean()),
                    (torch.tensor(0.7, device=dev), x7, tau7),
                    (alpha, x, torch.tensor(-math.inf, device=dev))):
                for keep in (0.375, KEEP):
                    kf = torch.tensor(keep, device=dev)
                    name = f"score_select experts {role} R={R} " \
                        f"alpha={float(a):.2g} tau={float(tau):.3g} " \
                        f"keep={keep}"
                    got = K.score_select_experts(xs, g, a, tau, kf, kb=kb,
                                                 blk=BLK)
                    torch.cuda.synchronize()
                    want = ref.ref_score_select_experts(xs, g, a, tau, kf,
                                                        BLK, kb)
                    unranked = ref.ref_score_mask_experts(xs, g, a, tau,
                                                          BLK)[0]
                    for e in range(E):
                        errs["score_select"] = max(
                            errs["score_select"], check_select(
                                f"{name} expert {e}",
                                tuple(t[e] for t in got),
                                tuple(t[e] for t in want),
                                rank_limit(keep, nb, kb),
                                lambda e=e: unranked[e]))
                    if got[1][routed:].tolist() != \
                            [list(range(kb))] * (E - routed):
                        raise AssertionError(f"{name}: the zero experts' ids "
                                             f"{got[1][40:].tolist()}")
                    bit_equal(name, lambda: K.score_select_experts(
                        xs, g, a, tau, kf, kb=kb, blk=BLK))
                xk, idx, _ = got                    # keep_frac 0.5
                y = K.sparse_matmul_shared_experts(xk, w, idx, blk=BLK)
                torch.cuda.synchronize()
                mname = f"sparse_matmul_shared experts {role} R={R} " \
                    f"alpha={float(a):.2g} tau={float(tau):.3g}"
                errs["sparse_matmul_shared"] = max(
                    errs["sparse_matmul_shared"], check_close(
                        mname, y, ref.ref_sparse_matmul_shared_experts(
                            xk, w, idx, BLK)))
                bit_equal(mname, lambda: K.sparse_matmul_shared_experts(
                    xk, w, idx, blk=BLK))
            # timed at tau -inf, keep_frac 0.5 (the served runs' sp tree);
            # a whole prefill's rows take milliseconds per call: fewer
            copies = max(1, math.ceil(200e6 / w.nbytes))
            ws = [w] + [w.clone() for _ in range(copies - 1)]
            reps = {} if R <= 64 else {"reps": 4, "replays": 2}
            t_sel = graph_ms(lambda i: K.score_select_experts(
                x, g, alpha, tau, kf, kb=kb, blk=BLK), **reps)
            t_sel_plain = graph_ms(lambda i: ref.ref_score_select_experts(
                x, g, alpha, tau, kf, BLK, kb), **reps)
            t_mm = graph_ms(lambda i: K.sparse_matmul_shared_experts(
                xk, ws[i % copies], idx, blk=BLK), **reps)
            t_mm_plain = graph_ms(lambda i: ref.ref_sparse_matmul_shared_experts(
                xk, ws[i % copies], idx, BLK), **reps)
            t_bmm = graph_ms(lambda i: torch.bmm(x, ws[i % copies]), **reps)
            del ws
            # x read, xm written, g, the three scalars, bs and idx
            sel_bytes = 2 * E * R * n * 2 + E * n * 4 + 12 + E * (nb + kb) * 4
            sel_bound, sel_by = bound_ms(sel_bytes, 6.0 * E * R * n,
                                         torch.float32, rates)
            # the kept x blocks and weight rows of every expert, the ids, y
            mm_bytes = E * (R * kb * BLK * 2 + kb * BLK * m * 2 + kb * 4
                            + R * m * 4)
            mm_bound, mm_by = bound_ms(mm_bytes, 2.0 * E * R * kb * BLK * m,
                                       torch.bfloat16, rates)
            plan = K.expert_plan(R, n, m, kb, BLK, 2, E)
            form = plan.form
            out.append({
                "R": R, "role": role, "E": E, "n": n, "m": m, "kb": kb,
                "form": form,
                "score_select": {"ms": t_sel, "plain_ms": t_sel_plain,
                                 "library_ms": None, "bound_ms": sel_bound,
                                 "bound_by": sel_by},
                "sparse_matmul_shared": {
                    "ms": t_mm, "plain_ms": t_mm_plain, "library_ms": t_bmm,
                    "bound_ms": mm_bound, "bound_by": mm_by,
                    "splits": plan.splits,
                    "blocks": G.tile_ctas(plan, sms) if form == "tile"
                    else math.prod(plan.grid)}})
            print(f"  experts E={E} R={R} {role:12s} n={n:5d} m={m:5d} "
                  f"kb={kb:2d} | score_select {t_sel * 1e3:7.2f} us (plain "
                  f"{t_sel_plain * 1e3:8.2f}, bound {sel_bound * 1e3:5.2f}) | "
                  f"sparse_matmul_shared {t_mm * 1e3:7.2f} us (plain "
                  f"{t_mm_plain * 1e3:8.2f}, torch.bmm dense "
                  f"{t_bmm * 1e3:7.2f}, bound {mm_bound * 1e3:6.2f} = "
                  f"{100 * mm_bound / t_mm:5.1f}%, {form} form, grid "
                  f"{plan.grid})")
            del x, w
    for R in rows:
        per = [r for r in out if r["R"] == R]
        line = f"{model} per layer, 3 expert-batched projections, R={R}:"
        for name in ("score_select", "sparse_matmul_shared"):
            tot = {k: sum(r[name][k] for r in per)
                   for k in ("ms", "plain_ms", "bound_ms")}
            lib = [r[name]["library_ms"] for r in per]
            line += (f" {name} {tot['ms'] * 1e3:7.2f} us (plain "
                     f"{tot['plain_ms'] * 1e3:8.2f}"
                     + ("" if lib[0] is None else
                        f", torch.bmm dense {sum(lib) * 1e3:7.2f}")
                     + f", bound {tot['bound_ms'] * 1e3:6.2f} = "
                     f"{100 * tot['bound_ms'] / tot['ms']:5.1f}%);")
        print(line + " matmul form " + "/".join(sorted({r["form"]
                                                        for r in per})))
    print(f"expert kernels: {E} experts x {model}'s 3 expert shapes x R = "
          f"{list(rows)} x 3 (alpha, tau) agree with their plain versions "
          f"(max abs err {errs})")
    return out, errs


def expert_matmul_forms(K, ref, build, dev, rates,
                        rows=EXPERT_FORM_ROWS) -> tuple:
    """``sparse_matmul_shared_experts`` in both its forms at
    jamba_v01_52b's three expert shapes (16 experts, bf16, half of the
    blocks kept at random per expert) and each R of ``rows``: the gather
    form (``launch_plan``'s: ``mma.sync`` tiles of 8-32 rows, split-K)
    and the tile form (``csrc/sparse_matmul_tile.cu``; through the C
    entry, below the plan's row threshold too), each held against the
    plain version within 1e-4 + 1e-4 |ref| with two launches bit-equal,
    then timed by CUDA-graph replay (the weights rotated through copies
    beyond L2) beside dense ``torch.bmm`` and the bound.  Each line names
    the form ``expert_plan`` routes the shape to; ``TILE_MIN_ROWS`` was
    chosen from these times.  A tree without the tile form (``--src`` of
    an older commit) times the gather form alone.  Returns (rows, the
    largest error per form)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    tiled = hasattr(K, "expert_plan")
    E, out, errs = JAMBA_E, [], {"gather": 0.0, "tile": 0.0}
    for R in rows:
        for role, n, m in JAMBA_EXPERTS:
            nb = n // BLK
            kb = round(nb * KEEP)
            x = torch.randn(E, R, n, device=dev, generator=gen).to(
                torch.bfloat16)
            w = (torch.randn(E, n, m, device=dev, generator=gen) * 0.02).to(
                torch.bfloat16)
            idx = torch.stack([torch.randperm(nb, device=dev,
                                              generator=gen)[:kb]
                               for _ in range(E)]).to(torch.int32)
            copies = max(1, math.ceil(200e6 / w.nbytes))
            ws = [w] + [w.clone() for _ in range(copies - 1)]
            want = ref.ref_sparse_matmul_shared_experts(x, w, idx, BLK)
            plans = {"gather": K.launch_plan(R, n, m, kb, BLK, False, 2, E)}
            if tiled:
                plans["tile"] = K.LaunchPlan(
                    K.TILE_ROWS, K.TILE_WIDE, math.ceil(m / K.TILE_WIDE),
                    math.ceil(R / K.TILE_ROWS), 1, kb, 0, 0, E)
            reps = {} if R <= 64 else {"reps": 4, "replays": 2}
            row = {"R": R, "role": role, "E": E, "n": n, "m": m, "kb": kb,
                   "routed": K.expert_plan(R, n, m, kb, BLK, 2, E).form
                   if tiled else "gather"}
            for form, plan in plans.items():
                fn, y = direct_expert_matmul(K, build, x, ws, idx, plan)
                fn(0)
                torch.cuda.synchronize()
                name = f"expert matmul, {form} form, {role} R={R}"
                errs[form] = max(errs[form], check_close(name, y, want))
                first = y.clone()
                fn(0)
                torch.cuda.synchronize()
                if not torch.equal(first, y):
                    raise AssertionError(f"{name}: two launches differ")
                row[form + "_ms"] = graph_ms(fn, **reps)
                del first
            row["library_ms"] = graph_ms(lambda i: torch.bmm(
                x, ws[i % copies]), **reps)
            # the kept x blocks and weight rows of every expert, ids, y
            nbytes = E * (R * kb * BLK * 2 + kb * BLK * m * 2 + kb * 4
                          + R * m * 4)
            row["bound_ms"], row["bound_by"] = bound_ms(
                nbytes, 2.0 * E * R * kb * BLK * m, torch.bfloat16, rates)
            out.append(row)
            print(f"  expert matmul E={E} R={R:3d} {role:12s} kb={kb:2d}: "
                  + ", ".join(f"{f} {row[f + '_ms'] * 1e3:8.2f} us "
                              f"({100 * row['bound_ms'] / row[f + '_ms']:5.1f}"
                              "% of the bound)" for f in plans)
                  + f"; torch.bmm dense {row['library_ms'] * 1e3:8.2f}, "
                  f"bound {row['bound_ms'] * 1e3:7.2f} "
                  f"({row['bound_by']}); routed: {row['routed']}")
            del x, w, ws, want
    for R in rows:
        per = [r for r in out if r["R"] == R]
        tot = {k: sum(r[k] for r in per) for k in per[0]
               if k.endswith("_ms")}
        label = {"gather_ms": "gather form", "tile_ms": "tile form",
                 "library_ms": "torch.bmm dense", "bound_ms": "bound"}
        print(f"jamba_v01_52b per MoE layer, expert matmul at R={R}: "
              + ", ".join(f"{label[k]} {v * 1e3:8.2f} us"
                          for k, v in tot.items())
              + f"; routed: {per[0]['routed']}; tile form at "
              + (f"{100 * tot['bound_ms'] / tot['tile_ms']:5.1f}% of the "
                 "bound" if tiled else "n/a"))
    print(f"expert matmul forms: R = {list(rows)} x jamba's 3 expert shapes "
          f"agree with the plain version (max abs err {errs})")
    return out, errs


def tile_form_2d_evidence(K, ref, dev, rates) -> tuple:
    """Evidence for routing the 2-D entry at whole-prefill B, timed and
    not routed: the tile form at E = 1 (the expert entry on ``x[None]``)
    at jamba_v01_52b's 13 2-D shapes (``JAMBA_LAYER``) and
    ``TILE_EVIDENCE_B`` rows, bf16, half of the blocks kept, held against
    the plain 2-D version with two launches bit-equal, and timed beside
    today's ``sparse_matmul_shared`` (its gather form), dense
    ``torch.matmul`` and the bound; then summed over one sparse pass of
    the period (58 projections, :func:`role_counts`).  Returns (rows,
    largest error)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    B, out, err = TILE_EVIDENCE_B, [], 0.0
    reps = {"reps": 4, "replays": 2}
    for role, n, m in JAMBA_LAYER:
        nb = n // BLK
        kb = round(nb * KEEP)
        x = torch.randn(B, n, device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn(n, m, device=dev, generator=gen) * 0.02).to(
            torch.bfloat16)
        idx = torch.randperm(nb, device=dev, generator=gen)[:kb].to(
            torch.int32)
        copies = max(1, math.ceil(200e6 / w.nbytes))
        ws = [w] + [w.clone() for _ in range(copies - 1)]
        assert K.expert_plan(B, n, m, kb, BLK, 2, 1).form == "tile"
        y = K.sparse_matmul_shared_experts(x[None], w[None], idx[None])[0]
        torch.cuda.synchronize()
        name = f"tile form at E = 1, {role} B={B}"
        err = max(err, check_close(name, y, ref.ref_sparse_matmul_shared(
            x, w, idx, BLK)))
        bit_equal(name, lambda: K.sparse_matmul_shared_experts(
            x[None], w[None], idx[None]))
        row = {"role": role, "B": B, "n": n, "m": m, "kb": kb}
        row["tile_ms"] = graph_ms(lambda i: K.sparse_matmul_shared_experts(
            x[None], ws[i % copies][None], idx[None]), **reps)
        row["gather_ms"] = graph_ms(lambda i: K.sparse_matmul_shared(
            x, ws[i % copies], idx), **reps)
        row["library_ms"] = graph_ms(lambda i: torch.matmul(
            x, ws[i % copies]), **reps)
        nbytes = B * kb * BLK * 2 + kb * BLK * m * 2 + kb * 4 + B * m * 4
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes, 2.0 * B * kb * BLK * m, torch.bfloat16, rates)
        out.append(row)
        print(f"  2-D {role:12s} B={B} n={n:5d} m={m:5d} kb={kb:3d}: tile "
              f"form at E = 1 {row['tile_ms'] * 1e3:8.2f} us, "
              f"sparse_matmul_shared {row['gather_ms'] * 1e3:8.2f}, "
              f"torch.matmul dense {row['library_ms'] * 1e3:8.2f}, bound "
              f"{row['bound_ms'] * 1e3:7.2f} ({row['bound_by']})")
        del x, w, ws
    counts = role_counts(served_config("jamba_v01_52b"))
    tot = {k: sum(r[k] * counts[r["role"]] for r in out) for k in out[0]
           if k.endswith("_ms")}
    label = {"tile_ms": "tile form", "gather_ms": "sparse_matmul_shared",
             "library_ms": "torch.matmul dense", "bound_ms": "bound"}
    print(f"jamba_v01_52b's 2-D projections over one sparse pass (58) at "
          f"B = {B}, tile form at E = 1 against the 2-D entry: " + ", ".join(
              f"{label[k]} {v * 1e3:9.2f} us" for k, v in tot.items())
          + f" (max abs err {err:.3e}; the 2-D entry is not routed)")
    return out, err


def select_form(G, E: int, R: int, n: int, kb: int, sms: int) -> str:
    """The form ``score_select_experts`` takes at (E, R, n), bf16, from
    ``kernels/geometry.py``'s mirror, with its grid, threads and cluster
    (a tree whose mirror names no form launches one cluster per
    expert)."""
    kw = {"experts": True} if "experts" in inspect.signature(
        G.score_select_geometry).parameters else {}
    geo = G.score_select_geometry(E, R, n, BLK, kb, 2, True, sms, **kw)
    return (f"{getattr(geo, 'form', 'cluster')} grid {geo.grid} x "
            f"{geo.threads} cluster {geo.cluster[0]}")


def hold_experts(name, K, ref, x, g, a, tau, kf, kb, zero) -> float:
    """``score_select_experts`` on (x, g) against its plain version: the
    whole (E, ...) outputs at once, and where they differ expert by
    expert as ``check_select`` allows (near ties printed); the experts in
    ``zero`` (zero rows) give ids 0..kb-1; two launches bit-equal.
    Returns the largest bs error."""
    got = K.score_select_experts(x, g, a, tau, kf, kb=kb, blk=BLK)
    torch.cuda.synchronize()
    want = ref.ref_score_select_experts(x, g, a, tau, kf, BLK, kb)
    err = check_close(f"{name} bs", got[2], want[2])
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        nb = x.shape[2] // BLK
        unranked = ref.ref_score_mask_experts(x, g, a, tau, BLK)[0]
        for e in range(x.shape[0]):
            check_select(f"{name} expert {e}", tuple(t[e] for t in got),
                         tuple(t[e] for t in want),
                         rank_limit(float(kf), nb, kb),
                         lambda e=e: unranked[e])
    if got[1][zero].tolist() != [list(range(kb))] * len(zero):
        raise AssertionError(f"{name}: the zero experts' ids "
                             f"{got[1][zero].tolist()}")
    bit_equal(name, lambda: K.score_select_experts(x, g, a, tau, kf, kb=kb,
                                                   blk=BLK))
    return err


def expert_select_shapes(K, ref, G, dev, rates) -> tuple:
    """``score_select_experts`` at every shape of ``EXPERT_SELECT`` (three
    MoE archs, both expert input widths, decode and chunk rows), bf16,
    k_frac 0.5: held against its plain version (:func:`hold_experts`) at
    alpha 0.7 with a finite tau (a quarter of the mean score) and
    keep_frac 0.375, and at alpha 1 (the uncalibrated sp tree's), tau
    -inf, keep_frac 0.5, then timed there by CUDA-graph replay beside the
    plain version and the bound (bytes over the card's memory rate), with
    the form the launch took, and once more at alpha 0.7 (a calibrated
    layer's: powf runs).  Then the
    evidence line: the expert entry at E = 1 on llama31_8b's seven
    decode shapes (B = 8) beside ``score_select``'s one cluster.
    Returns (rows, largest bs error)."""
    rows, err = [], 0.0
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    alpha = torch.tensor(1.0, device=dev)
    a7 = torch.tensor(0.7, device=dev)
    ninf = torch.tensor(-math.inf, device=dev)
    for arch, E, routed, n_in, n_ff, rs in EXPERT_SELECT:
        zero = list(range(routed, E)) or [E - 1]
        for R in rs:
            for role, n in (("moe/wi", n_in), ("moe/wo", n_ff)):
                x = torch.randn(E, R, n, device=dev, generator=gen)
                x[zero] = 0
                x = x.to(torch.bfloat16)
                g = torch.rand(E, n, device=dev, generator=gen) + 0.5
                nb = n // BLK
                kb = round(nb * KEEP)
                name = f"score_select experts {arch} {role} E={E} R={R}"
                tau = 0.25 * (x.float().abs() * g[:, None] ** 0.7).mean()
                k3 = torch.tensor(0.375, device=dev)
                k5 = torch.tensor(KEEP, device=dev)
                err = max(err, hold_experts(f"{name} alpha=0.7 "
                                            f"tau={float(tau):.3g}", K, ref,
                                            x, g, a7, tau, k3, kb, zero),
                          hold_experts(f"{name} tau=-inf", K, ref, x, g,
                                       alpha, ninf, k5, kb, zero))
                t = graph_ms(lambda i: K.score_select_experts(
                    x, g, alpha, ninf, k5, kb=kb, blk=BLK))
                t7 = graph_ms(lambda i: K.score_select_experts(
                    x, g, a7, ninf, k5, kb=kb, blk=BLK))
                t_plain = graph_ms(lambda i: ref.ref_score_select_experts(
                    x, g, alpha, ninf, k5, BLK, kb))
                # x read, xm written, g, the three scalars, bs and idx
                nbytes = 2 * E * R * n * 2 + E * n * 4 + 12 + E * (nb + kb) * 4
                bound, by = bound_ms(nbytes, 6.0 * E * R * n, torch.float32,
                                     rates)
                form = select_form(G, E, R, n, kb, sms)
                rows.append({"arch": arch, "role": role, "E": E, "R": R,
                             "n": n, "kb": kb, "form": form, "ms": t,
                             "ms_alpha_0.7": t7, "plain_ms": t_plain,
                             "library_ms": None, "bound_ms": bound,
                             "bound_by": by})
                print(f"  {arch:20s} {role:6s} E={E:2d} R={R:3d} n={n:5d} "
                      f"kb={kb:2d} | score_select_experts {t * 1e3:7.2f} us "
                      f"(alpha 0.7: {t7 * 1e3:7.2f}; plain "
                      f"{t_plain * 1e3:8.2f}, bound {bound * 1e3:6.2f}) {form}")
                del x, g
        for R in rs:
            per = {r["role"]: r for r in rows
                   if r["arch"] == arch and r["R"] == R}
            tot = {k: 2 * per["moe/wi"][k] + per["moe/wo"][k]
                   for k in ("ms", "ms_alpha_0.7", "plain_ms", "bound_ms")}
            print(f"{arch} per layer (3 launches), R={R}: "
                  f"score_select_experts {tot['ms'] * 1e3:7.2f} us (alpha "
                  f"0.7: {tot['ms_alpha_0.7'] * 1e3:7.2f}; plain "
                  f"{tot['plain_ms'] * 1e3:8.2f}, bound "
                  f"{tot['bound_ms'] * 1e3:6.2f})")
    # evidence for a one-launch selection on the dense path: the expert
    # entry at E = 1 (no row weights) beside score_select (row weights 1)
    line = "llama31_8b decode (B = 8), score_select_experts at E = 1 " \
        "against score_select, us:"
    tot = [0.0, 0.0]
    for role, n, _m in LAYER:
        x = torch.randn(1, 8, n, device=dev, generator=gen).to(
            torch.bfloat16)
        g = torch.rand(1, n, device=dev, generator=gen) + 0.5
        kb = round(n // BLK * KEEP)
        k5 = torch.tensor(KEEP, device=dev)
        rw = torch.ones(8, device=dev)
        err = max(err, hold_experts(f"score_select experts E=1 {role}", K,
                                    ref, x, g, alpha, ninf, k5, kb, []))
        t_e = graph_ms(lambda i: K.score_select_experts(
            x, g, alpha, ninf, k5, kb=kb, blk=BLK))
        t_d = graph_ms(lambda i: K.score_select(
            x[0], g[0], alpha, ninf, k5, kb=kb, blk=BLK, row_weights=rw))
        tot = [tot[0] + t_e, tot[1] + t_d]
        line += (f" {role} {t_e * 1e3:.2f} / {t_d * 1e3:.2f} "
                 f"({select_form(G, 1, 8, n, kb, sms).split()[0]});")
    print(f"{line} the layer {tot[0] * 1e3:.2f} / {tot[1] * 1e3:.2f}")
    print(f"expert selection: {len(rows)} shapes of {len(EXPERT_SELECT)} "
          f"MoE archs agree with the plain version (max abs bs err "
          f"{err:.3e})")
    return rows, err


def experts_only(dev, card: str, src: str, rates) -> int:
    """``--experts-only``: :func:`expert_select_shapes` and
    :func:`expert_matmul_forms` for the package under ``src``, one JSON
    line."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import geometry as G
    from repro_torch.kernels import sparse_matmul as K
    build.library()
    rows, err = expert_select_shapes(K, ref, G, dev, rates)
    mm_rows, mm_errs = expert_matmul_forms(K, ref, build, dev, rates)
    print(json.dumps({"expert_select": rows, "max_abs_err": err,
                      "expert_matmul_forms": mm_rows,
                      "expert_matmul_max_abs_err": mm_errs,
                      "src": src, "card": card}))
    return 0


def whole_prefill_kernels(K, ref, dev, rows, layer=GEMMA_LAYER,
                          model="gemma2_2b") -> dict:
    """``score_select`` and then ``sparse_matmul_shared`` on its kept
    blocks at every B of ``rows`` (phase 16's whole-prompt prefills, up
    to 2 x 4326 rows, or phase 18's, up to 3 x 8192) and each of
    ``layer``'s projection shapes (``model``'s), bf16, no
    row weights (as ``_prefill_whole`` passes none), alpha 1, k_frac and
    keep_frac 0.5, tau -inf (the uncalibrated runs) and a finite tau (a
    quarter of the mean g), held against their plain versions as
    ``main_path_kernels`` holds them, two launches bit-equal.  Checked,
    not timed."""
    errs = {"score_select": 0.0, "sparse_matmul_shared": 0.0}
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    alpha = torch.tensor(1.0, device=dev)
    kf = torch.tensor(KEEP, device=dev)
    for role, n, m in layer:
        w = (torch.randn(n, m, device=dev, generator=gen) * 0.02).to(
            torch.bfloat16)
        g = torch.sqrt((w.float() ** 2).sum(1))
        nb = n // BLK
        kb = round(nb * KEEP)
        for B in rows:
            x = torch.randn(B, n, device=dev, generator=gen).to(torch.bfloat16)
            for tau in (torch.tensor(-math.inf, device=dev), 0.25 * g.mean()):
                name = f"{role} B={B} tau={float(tau):.3g}"
                got = K.score_select(x, g, alpha, tau, kf, kb=kb, blk=BLK)
                torch.cuda.synchronize()
                errs["score_select"] = max(errs["score_select"], check_select(
                    f"score_select {name}", got, ref.ref_score_select(
                        x, g, alpha, tau, kf, BLK, kb),
                    rank_limit(KEEP, nb, kb), lambda: ref.ref_score_mask(
                        x, g, alpha, tau, BLK)[0]))
                bit_equal(f"score_select {name}", lambda: K.score_select(
                    x, g, alpha, tau, kf, kb=kb, blk=BLK))
                xk, idx, _ = got
                y = K.sparse_matmul_shared(xk, w, idx, blk=BLK)
                torch.cuda.synchronize()
                errs["sparse_matmul_shared"] = max(
                    errs["sparse_matmul_shared"], check_close(
                        f"sparse_matmul_shared {name}", y,
                        ref.ref_sparse_matmul_shared(xk, w, idx, BLK)))
                bit_equal(f"sparse_matmul_shared {name}",
                          lambda: K.sparse_matmul_shared(xk, w, idx, blk=BLK))
            del x
    print(f"whole-prefill kernels: score_select and sparse_matmul_shared at "
          f"B = {rows} x {len(layer)} {model} shapes x 2 taus agree with "
          f"their plain versions (max abs err {errs})")
    return errs


def projection_us(ops, dev) -> dict:
    """Device time of one whole ``pallas`` projection
    (``ops.wisparse_project``: bf16, alpha 1, tau -inf, keep_frac and
    k_frac 0.5, unit row weights) against the dense bf16 product it
    replaces, at llama31_8b's 7 projection shapes and B = 8, 32 and 448,
    by CUDA-graph replay with the weights rotated through copies beyond
    L2; and the CUDA kernels one projection launches (``torch.profiler``
    over one warm call at attn/wq, B = 8).  Uses only the public
    signature, so it times any tree's package (``--src``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 4)
    out = {"rows": []}
    for B in (8, 32, 448):
        for role, n, m in LAYER:
            x = torch.from_numpy(rng.standard_normal((B, n)).astype(
                np.float32)).to(dev, torch.bfloat16)
            w = (torch.randn(n, m, device=dev) * 0.02).to(torch.bfloat16)
            sp1 = {"g": torch.sqrt((w.float() ** 2).sum(1)),
                   "alpha": torch.tensor(1.0, device=dev),
                   "tau": torch.tensor(float("-inf"), device=dev),
                   "keep_frac": torch.tensor(KEEP, device=dev)}
            rw = torch.ones(B, device=dev)
            if B == 8 and role == "attn/wq":
                ops.wisparse_project(x, w, sp1, block=BLK, k_frac=KEEP,
                                     token_weights=rw)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    ops.wisparse_project(x, w, sp1, block=BLK, k_frac=KEEP,
                                         token_weights=rw)
                    torch.cuda.synchronize()
                kern = [(e.key, e.count) for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA]
                out["launches_per_projection"] = sum(c for _k, c in kern)
                out["launched"] = kern
            copies = max(1, math.ceil(200e6 / (n * m * 2)))
            ws = [w] + [w.clone() for _ in range(copies - 1)]
            t_proj = graph_ms(lambda i: ops.wisparse_project(
                x, ws[i % copies], sp1, block=BLK, k_frac=KEEP,
                token_weights=rw))
            t_dense = graph_ms(lambda i: x @ ws[i % copies])
            del ws
            out["rows"].append({"B": B, "role": role, "pallas_us": 1e3 * t_proj,
                                "dense_us": 1e3 * t_dense})
    for B in (8, 32, 448):
        per = [r for r in out["rows"] if r["B"] == B]
        out[f"per_layer_B{B}"] = {
            "pallas_us": sum(r["pallas_us"] for r in per),
            "dense_us": sum(r["dense_us"] for r in per)}
    return out


def per_seq_kernel(K, ref, ops, build, dev, rates) -> tuple:
    """``sparse_matmul_per_seq`` at llama31_8b's projection shapes, B = 8
    and B = 32, bf16: each row keeps a distinct random half of the
    blocks, and x is zero outside them, so dense ``torch.matmul`` on the
    same x computes the same function (the library yardstick).  Weights
    rotate through copies that exceed the 50 MB L2.  Then its entry
    point, ``wisparse_project(per_seq=True)``, runs once at every shape
    with the launch counts zeroed just before and read just after, and
    must equal ``per_seq=False`` (in f32).  Returns (rows, max err,
    launches)."""
    rng = np.random.default_rng(SEED + 2)
    rows, err = [], 0.0
    dt = torch.bfloat16
    cases = []
    for B in (8, 32):
        for role, n, m in LAYER:
            nb = n // BLK
            kb = round(nb * KEEP)
            ids_np = np.stack([rng.permutation(nb)[:kb] for _ in range(B)])
            keep = np.zeros((B, nb), bool)
            keep[np.arange(B)[:, None], ids_np] = True
            x = rng.standard_normal((B, n)).astype(np.float32)
            x *= np.repeat(keep, BLK, axis=1)
            xk = torch.from_numpy(x).to(dev, dt)
            w = (torch.randn(n, m, device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED)) * 0.02).to(dt)
            idx = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
            y = K.sparse_matmul_per_seq(xk, w, idx, blk=BLK)
            torch.cuda.synchronize()
            bit_equal(f"sparse_matmul_per_seq {role} B={B}",
                      lambda: K.sparse_matmul_per_seq(xk, w, idx, blk=BLK))
            err = max(err, check_close(
                f"sparse_matmul_per_seq {role} B={B}", y,
                ref.ref_sparse_matmul_per_seq(xk, w, idx, BLK)))

            copies = max(1, math.ceil(200e6 / (n * m * 2)))
            ws = [w] + [w.clone() for _ in range(copies - 1)]
            kernel, plan = direct_matmul(K, build, "sparse_matmul_per_seq",
                                         xk, ws, idx, m, kb, True)
            t_k = graph_ms(kernel)
            t_plain = graph_ms(lambda i: ref.ref_sparse_matmul_per_seq(
                xk, ws[i % copies], idx, BLK))
            t_lib = graph_ms(lambda i: torch.matmul(xk, ws[i % copies]))
            del ws
            union = int(keep.any(0).sum())
            # the kept x blocks, the union of kept weight rows, the ids, y
            nbytes = (B * kb * BLK * 2 + union * BLK * m * 2 + B * kb * 4
                      + B * m * 4)
            bms, by = bound_ms(nbytes, 2.0 * B * kb * BLK * m, dt, rates)
            rows.append({"B": B, "role": role, "n": n, "m": m, "kb": kb,
                         "union_blocks": union, "ms": t_k,
                         "plain_ms": t_plain, "library_ms": t_lib,
                         "bound_ms": bms, "bound_by": by,
                         "splits": plan.splits})
            print(f"  B={B:2d} {role:12s} n={n:5d} m={m:5d} kb={kb:3d} "
                  f"union {union:3d} | sparse_matmul_per_seq "
                  f"{t_k * 1e3:8.2f} us (v1 {V1_US[B, role][1]:7.2f}, "
                  f"plain {t_plain * 1e3:8.2f}, torch.matmul dense "
                  f"{t_lib * 1e3:8.2f}, bound {bms * 1e3:6.2f} = "
                  f"{100 * bms / t_k:5.1f}%, grid {plan.grid})")
            g = torch.sqrt((w.float() ** 2).sum(1))
            sp1 = {"g": g, "alpha": torch.tensor(1.0, device=dev),
                   "tau": torch.tensor(float("-inf"), device=dev),
                   "keep_frac": torch.tensor(KEEP, device=dev)}
            # f32, so that the two paths' outputs are not rounded to bf16
            # (one bf16 step is 0.4%, above the tolerance)
            xr = torch.from_numpy(rng.standard_normal((B, n)).astype(
                np.float32)).to(dev)
            cases.append((role, B, xr, w.float(), sp1))

    shared = [ops.wisparse_project(xr, w, sp1, block=BLK, k_frac=KEEP)
              for _r, _B, xr, w, sp1 in cases]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    per_seq = [ops.wisparse_project(xr, w, sp1, block=BLK, k_frac=KEEP,
                                    per_seq=True)
               for _r, _B, xr, w, sp1 in cases]
    torch.cuda.synchronize()
    launches = K.launch_counts["sparse_matmul_per_seq"]
    if launches != len(cases):
        raise AssertionError(f"wisparse_project(per_seq=True) launched "
                             f"sparse_matmul_per_seq {launches} times over "
                             f"{len(cases)} calls")
    for (role, B, *_), a, b in zip(cases, per_seq, shared):
        err = max(err, check_close(
            f"wisparse_project per_seq vs shared {role} B={B}", a, b))
    print(f"wisparse_project(per_seq=True) == per_seq=False at "
          f"{len(cases)} projection shapes; {launches} per-seq launches")
    return rows, err, launches


def wrapper_host_us(K, ops, dev, calls: int = 50, rounds: int = 7) -> dict:
    """Host microseconds per call of each kernel wrapper (and of the whole
    ``pallas`` projection, ``ops.wisparse_project``; ``score_select`` only
    where the tree has it) at llama31_8b's 7
    projection shapes, B = 8, bf16, half of the blocks kept: the time
    until ``calls`` back-to-back calls have returned, without a sync in
    between, over ``calls``; the median of ``rounds`` rounds per shape,
    then the mean over the shapes.  The queue stays far from full, so this
    is the host's cost of a launch, the quantity that sets a decode step
    while the device idles.  Uses only the wrappers' public signatures, so
    it times any tree's package (``--src``)."""
    from repro_torch import obs
    rng = np.random.default_rng(SEED + 3)
    B, dt = 8, torch.bfloat16
    per = {"score_mask": [], "sparse_matmul_shared": [],
           "sparse_matmul_per_seq": [], "wisparse_project": []}
    if hasattr(K, "score_select"):      # absent from trees before it
        per["score_select"] = []
    for _role, n, m in LAYER:
        nb = n // BLK
        kb = round(nb * KEEP)
        x = torch.from_numpy(rng.standard_normal((B, n)).astype(
            np.float32)).to(dev, dt)
        w = (torch.randn(n, m, device=dev) * 0.02).to(dt)
        g = torch.sqrt((w.float() ** 2).sum(1))
        alpha = torch.tensor(1.0, device=dev)
        tau = torch.tensor(float("-inf"), device=dev)
        rw = torch.ones(B, device=dev)
        ids = np.stack([rng.permutation(nb)[:kb] for _ in range(B)])
        idx = torch.from_numpy(ids[0].astype(np.int32)).to(dev)
        idx2 = torch.from_numpy(ids.astype(np.int32)).to(dev)
        sp1 = {"g": g, "alpha": alpha, "tau": tau,
               "keep_frac": torch.tensor(KEEP, device=dev)}
        fns = {
            "score_mask": lambda: K.score_mask(x, g, alpha, tau, blk=BLK,
                                               row_weights=rw),
            "sparse_matmul_shared": lambda: K.sparse_matmul_shared(
                x, w, idx, blk=BLK),
            "sparse_matmul_per_seq": lambda: K.sparse_matmul_per_seq(
                x, w, idx2, blk=BLK),
            "wisparse_project": lambda: ops.wisparse_project(
                x, w, sp1, block=BLK, k_frac=KEEP, token_weights=rw),
            "score_select": lambda: K.score_select(
                x, g, alpha, tau, sp1["keep_frac"], kb=kb, blk=BLK,
                row_weights=rw)}
        for name in per:
            fn = fns[name]
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(rounds):
                t0 = obs.now()
                for _ in range(calls):
                    fn()
                times.append((obs.now() - t0) / calls)
                torch.cuda.synchronize()
            per[name].append(1e6 * float(np.median(times)))
        del w
    return {k: {"mean_us": float(np.mean(v)), "per_shape_us": v}
            for k, v in per.items()}


def layer_summary(rows, ps_rows, proj) -> None:
    """Per decode layer (the 7 projection shapes summed): score_select at
    B = 8, 32 and 448 against its bound and the unfused ``score_mask``;
    each matmul kernel at B = 8 and 32 beside the v1 kernel's time, dense
    ``torch.matmul`` and its bound; the whole ``pallas`` projection
    against dense."""
    for B in (8, 32, 448):
        per = [r["score_select"] for r in rows if r["B"] == B]
        bnd = sum(p["bound_ms"] for p in per)
        print(f"per decode layer B={B:3d} score_select "
              f"{sum(p['ms'] for p in per) * 1e3:7.2f} us (unfused "
              f"score_mask alone at B=8: {SCORE_MASK_UNFUSED_US:.2f}; "
              f"plain {sum(p['plain_ms'] for p in per) * 1e3:8.2f}; bound "
              f"{bnd * 1e3:6.2f} us); whole pallas projection "
              f"{proj[f'per_layer_B{B}']['pallas_us']:8.2f} us, dense "
              f"{proj[f'per_layer_B{B}']['dense_us']:8.2f} us")
    for B in (8, 32):
        sh = [r for r in rows if r["B"] == B]
        ps = [r for r in ps_rows if r["B"] == B]
        for name, per, col in (
                ("sparse_matmul_shared",
                 [r["sparse_matmul_shared"] for r in sh], 0),
                ("sparse_matmul_per_seq", ps, 1)):
            ms = sum(p["ms"] for p in per)
            lib = sum(p["library_ms"] for p in per)
            bnd = sum(p["bound_ms"] for p in per)
            old = sum(V1_US[B, r["role"]][col] for r in sh)
            faster = sum(1e3 * p["ms"] < V1_US[B, r["role"]][col]
                         for p, r in zip(per, sh))
            print(f"per decode layer B={B:2d} {name:22s} {ms * 1e3:8.2f} us "
                  f"(v1 {old:8.2f}; torch.matmul dense {lib * 1e3:7.2f}; "
                  f"bound {bnd * 1e3:7.2f} = {100 * bnd / ms:5.1f}%); faster "
                  f"than v1 at {faster}/{len(per)} shapes")


def gemma_layer_summary(rows, model: str = "gemma2_2b", counts=None
                        ) -> dict:
    """Per ``model`` decode layer (its projection shapes summed: 7 of
    gemma2_2b, 6 of mamba2_130m) at B = 8 and 32: ``score_select`` and
    ``sparse_matmul_shared`` against their bounds, plain versions and
    dense ``torch.matmul``.  ``counts`` ({role: projections}, a hybrid's
    :func:`role_counts`) weights each shape by its projections in one
    sparse pass instead, and the sums are per pass."""
    out = {}
    unit = "decode layer" if counts is None else "sparse pass"
    weight = (lambda r: 1) if counts is None else (lambda r: counts[r["role"]])
    for B in (8, 32):
        row = {}
        for name in ("score_select", "sparse_matmul_shared"):
            per = [(r[name], weight(r)) for r in rows if r["B"] == B]
            row[name] = {k: sum(p[k] * c for p, c in per) for k in
                         ("ms", "plain_ms", "bound_ms")}
            lib = [p["library_ms"] for p, _c in per]
            row[name]["library_ms"] = None if lib[0] is None else sum(
                p["library_ms"] * c for p, c in per)
            r = row[name]
            print(f"{model} per {unit} B={B:2d} {name:20s} "
                  f"{r['ms'] * 1e3:8.2f} us (plain {r['plain_ms'] * 1e3:8.2f}"
                  + ("" if r["library_ms"] is None else
                     f", torch.matmul dense {r['library_ms'] * 1e3:7.2f}")
                  + f", bound {r['bound_ms'] * 1e3:6.2f} = "
                  f"{100 * r['bound_ms'] / r['ms']:5.1f}%)")
        out[f"B{B}"] = row
    return out


# ---------------------------------------------------------------------------
# phase 4: reduced model, card against CPU
# ---------------------------------------------------------------------------

def reduced_model_check(dev) -> None:
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.models import api, model as M, params as P
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    cfg = reduced(get_config("llama31_8b"))
    cpu = torch.device("cpu")
    params_c = api.init_model(cfg, SEED, device=cpu)
    sp_c = default_sp_stacked(params_c, cfg, keep_frac=KEEP,
                              tau=float("-inf"))
    params_g = P.tree_map(lambda t: t.to(dev), params_c)
    sp_g = P.tree_map(lambda t: t.to(dev), sp_c)
    pol = SparsityPolicy.uniform("pallas", k_max_frac=KEEP, block=16)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        lg, _ = M.forward(params_g, cfg, tokens=toks.to(dev), mode="prefill",
                          sp=sp_g, policy=pol)
        lc, _ = M.forward(params_c, cfg, tokens=toks, mode="prefill",
                          sp=sp_c, policy=pol)
    err = max_err(lg.cpu(), lc)
    if not err <= LOGIT_ATOL:
        raise AssertionError(f"reduced llama logits: card vs CPU err {err}")
    outs = []
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (20, 9, 33)]
    for d, params, sp in ((dev, params_g, sp_g), (cpu, params_c, sp_c)):
        eng = Engine(params, cfg, EngineConfig(
            max_slots=2, max_len=64, prefill_chunk=16, policy=pol), sp,
            device=d)
        for p in prompts:
            eng.submit(p, 6)
        outs.append(eng.run())
    if outs[0] != outs[1]:
        raise AssertionError(f"reduced llama engine tokens: card {outs[0]} "
                             f"!= CPU {outs[1]}")
    print(f"reduced llama31_8b on the card vs CPU: logits max abs err "
          f"{err:.2e} (<= {LOGIT_ATOL}); engine tokens equal {outs[0]}")


def scale_gemma_weights(params, factor: float = GEMMA_WEIGHT_SCALE):
    """Every attention, cross-attention, MLP and MoE (router and expert)
    weight of a port params tree, the encoder's too, times ``factor``,
    in place (see GEMMA_WEIGHT_SCALE; a reduced granite, whose head is
    tied too, emits its last prompt token forever at the init, and a
    reduced whisper's residual stream is its sinusoidal positions);
    returns the tree."""
    for group in params["groups"] + params.get("encoder", {}).get("groups",
                                                                  []):
        for layer in group.values():
            for part in ("attn", "cross", "mlp", "moe"):
                for w in layer.get(part, {}).values():
                    w.mul_(factor)
    return params


def reduced_gemma_check(dev) -> None:
    """Reduced gemma2_2b (f32, window 32; ``scale_gemma_weights``) on
    the card against the CPU: prefill logits over 80 tokens (past the
    window) within LOGIT_ATOL, and the tokens a whole-prefill engine
    serves under uncalibrated ``pallas`` with ``prefill_dense_frac`` 0
    (prompts of 40, 70 and 70 tokens, decode past the window's wrap)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.models import api, model as M, params as P
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    cfg = reduced(get_config("gemma2_2b"))
    cpu = torch.device("cpu")
    params_c = scale_gemma_weights(api.init_model(cfg, SEED, device=cpu))
    sp_c = default_sp_stacked(params_c, cfg, keep_frac=KEEP,
                              tau=float("-inf"))
    params_g = P.tree_map(lambda t: t.to(dev), params_c)
    sp_g = P.tree_map(lambda t: t.to(dev), sp_c)
    pol = SparsityPolicy.uniform("pallas", k_max_frac=KEEP, block=16)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 80)))
    with torch.no_grad():
        lg, cg = M.forward(params_g, cfg, tokens=toks.to(dev),
                           mode="prefill", sp=sp_g, policy=pol)
        lc, cc = M.forward(params_c, cfg, tokens=toks, mode="prefill",
                           sp=sp_c, policy=pol)
    err = max_err(lg.cpu(), lc)
    cache_err = max(max_err(a.cpu(), b) for a, b in zip(_leaves(cg),
                                                        _leaves(cc)))
    if not (err <= LOGIT_ATOL and cache_err <= LOGIT_ATOL):
        raise AssertionError(f"reduced gemma2 prefill: card vs CPU logits "
                             f"err {err}, rolled caches err {cache_err}")
    outs = []
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (40, 70, 70)]
    for d, params, sp in ((dev, params_g, sp_g), (cpu, params_c, sp_c)):
        eng = Engine(params, cfg, EngineConfig(
            max_slots=3, max_len=128, prefill_chunk=16, policy=pol,
            prefill_dense_frac=0.0), sp, device=d)
        if eng.prefill_strategy != "whole":
            raise AssertionError(f"reduced gemma2 resolved to "
                                 f"{eng.prefill_strategy!r}")
        for p in prompts:
            eng.submit(p, 24)
        outs.append(eng.run())
    if outs[0] != outs[1]:
        raise AssertionError(f"reduced gemma2 engine tokens: card {outs[0]} "
                             f"!= CPU {outs[1]}")
    print(f"reduced gemma2_2b on the card vs CPU: prefill logits max abs err "
          f"{err:.2e}, rolled caches {cache_err:.2e} (<= {LOGIT_ATOL}); "
          f"whole-prefill pallas engine tokens equal "
          f"({len({t for ts in outs[0].values() for t in ts})} distinct)")


# the card's and the CPU's f32 calibration of one reduced model: KL gap
# allowed where both searches pick the same plan (the block errors and
# fitness agree to about 1e-6 relative between two CPU packages,
# tests/torch_calib_parity.py)
REDUCED_KL_RTOL = 1e-3


def reduced_calibrated_check(tag, cfg, dev, params_c, params_g, prompts,
                             ecfg, gen) -> dict:
    """A plan of the reduced ``cfg`` calibrated on the CPU in f32 (the
    ``--calib-quick`` stages, one generation of two offspring, on 2 x 32
    tokens), served on the card and on the CPU under ``mask`` and under
    ``pallas`` (block 16): equal greedy tokens.  The same calibration on
    the card: block ratios, layer ratios and alphas against the CPU's,
    each tau's relative gap and the KL's are printed; where the two
    searches part, the first key that differs is named (a threshold is
    one calibration score, so the two devices' last bits can branch a
    near-tie: ROADMAP, reference behaviour 4), else the KLs agree within
    REDUCED_KL_RTOL."""
    from repro_torch.core import calibration, pipeline
    from repro_torch.core.allocation import EvoConfig
    from repro_torch.models import params as P
    from repro_torch.serving import Engine, EngineConfig

    evo = EvoConfig(generations=1, offspring=2, eps=0.1)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 32))
    plans = []
    for params in (params_c, params_g):
        ctx = calibration.build_context(params, cfg, {"tokens": toks})
        plan = pipeline.run_pipeline(params, cfg, None, KEEP, evo=evo,
                                     delta=0.25, coord_passes=0, ctx=ctx)
        plans.append((plan, ctx.fitness(plan.per_depth_sp)))
    (cp, kl_c), (gp, kl_g) = plans
    sp_c = cp.stacked_sp
    sp_g = P.tree_map(lambda t: t.to(dev), sp_c)
    tokens = {}
    for backend in ("mask", "pallas"):
        pol = cp.to_policy(backend=backend, block=16)
        outs = []
        for d, params, sp in ((dev, params_g, sp_g),
                              (torch.device("cpu"), params_c, sp_c)):
            eng = Engine(params, cfg, EngineConfig(policy=pol, **ecfg), sp,
                         device=d)
            for p in prompts:
                eng.submit(p, gen)
            outs.append(eng.run())
        if outs[0] != outs[1]:
            raise AssertionError(f"reduced {tag}, CPU-calibrated plan under "
                                 f"{backend}: card tokens {outs[0]} != CPU "
                                 f"{outs[1]}")
        tokens[backend] = len({t for ts in outs[0].values() for t in ts})
    parted = [k for k in cp.layer_ratios
              if gp.layer_ratios[k] != cp.layer_ratios[k]
              or gp.alphas[k] != cp.alphas[k]]
    same_blocks = bool(np.array_equal(gp.block_ratios, cp.block_ratios))
    gaps = [abs(gp.taus[k] - t) / abs(t) for k, t in cp.taus.items()
            if math.isfinite(t) and t != 0]
    kl_gap = abs(kl_g - kl_c) / abs(kl_c)
    print(f"reduced {tag}: the CPU-calibrated plan ({cp.summary()}, "
          f"k_max_frac {cp.to_policy().k_max_frac}) serves equal greedy "
          f"tokens on the card and the CPU under mask and pallas "
          f"({tokens} distinct); the card's calibration: block ratios "
          f"{'equal' if same_blocks else 'differ: ' + str(gp.block_ratios)}"
          f", layer ratios and alphas "
          f"{'equal' if not parted else 'part first at ' + str(parted[0])}"
          f", taus within {max(gaps, default=0.0):.2e} relative, KL card "
          f"{kl_g:.6g} against CPU {kl_c:.6g} (gap {kl_gap:.2e})")
    if same_blocks and not parted and not kl_gap <= REDUCED_KL_RTOL:
        raise AssertionError(f"reduced {tag}: the same plan on the card and "
                             f"the CPU, KL gap {kl_gap} > {REDUCED_KL_RTOL}")
    return {"kl_cpu": kl_c, "kl_card": kl_g, "kl_gap": kl_gap,
            "same_block_ratios": same_blocks,
            "parted_at": str(parted[0]) if parted else None,
            "tau_gap_max": max(gaps, default=0.0),
            "k_max_frac": cp.to_policy().k_max_frac,
            "distinct_tokens": tokens}


def reduced_granite_check(dev) -> dict:
    """Reduced granite_moe_3b_a800m with 20 experts, top-4 (padded to 32:
    12 pad experts, as the full width pads 40 to 48; f32;
    ``scale_gemma_weights``) on the card against the CPU: prefill logits
    over 40 tokens within LOGIT_ATOL, and the tokens a chunked
    ``pallas`` engine serves (prompts of 20, 9 and 33 tokens: partial
    last chunks, whose pad rows route; 4 slots, one free); then a
    calibrated plan (:func:`reduced_calibrated_check`)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.models import api, model as M, params as P
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    cfg = dataclasses.replace(reduced(get_config("granite_moe_3b_a800m")),
                              num_experts=20, num_experts_per_tok=4)
    cpu = torch.device("cpu")
    params_c = scale_gemma_weights(api.init_model(cfg, SEED, device=cpu))
    sp_c = default_sp_stacked(params_c, cfg, keep_frac=KEEP,
                              tau=float("-inf"))
    params_g = P.tree_map(lambda t: t.to(dev), params_c)
    sp_g = P.tree_map(lambda t: t.to(dev), sp_c)
    pol = SparsityPolicy.uniform("pallas", k_max_frac=KEEP, block=16)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    with torch.no_grad():
        lg, _ = M.forward(params_g, cfg, tokens=toks.to(dev), mode="prefill",
                          sp=sp_g, policy=pol)
        lc, _ = M.forward(params_c, cfg, tokens=toks, mode="prefill",
                          sp=sp_c, policy=pol)
    err = max_err(lg.cpu(), lc)
    if not err <= LOGIT_ATOL:
        raise AssertionError(f"reduced granite logits: card vs CPU err {err}")
    outs = []
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (20, 9, 33)]
    for d, params, sp in ((dev, params_g, sp_g), (cpu, params_c, sp_c)):
        eng = Engine(params, cfg, EngineConfig(
            max_slots=4, max_len=64, prefill_chunk=16, policy=pol), sp,
            device=d)
        if eng.prefill_strategy != "chunked":
            raise AssertionError(f"reduced granite resolved to "
                                 f"{eng.prefill_strategy!r}")
        for p in prompts:
            eng.submit(p, 16)
        outs.append(eng.run())
    if outs[0] != outs[1]:
        raise AssertionError(f"reduced granite engine tokens: card {outs[0]} "
                             f"!= CPU {outs[1]}")
    print(f"reduced granite_moe_3b_a800m (20 experts, 12 pad) on the card vs "
          f"CPU: prefill logits max abs err {err:.2e} (<= {LOGIT_ATOL}); "
          f"chunked pallas engine tokens equal "
          f"({len({t for ts in outs[0].values() for t in ts})} distinct)")
    return reduced_calibrated_check(
        "granite_moe_3b_a800m", cfg, dev, params_c, params_g, prompts,
        dict(max_slots=4, max_len=64, prefill_chunk=16), 16)


def reduced_ssm_check(dev, arch: str) -> dict:
    """Reduced ``arch`` (mamba2_130m, or jamba_v01_52b: mamba and
    attention mixers, dense and MoE FFNs; f32) on the card against the
    CPU, under uncalibrated ``pallas``: prefill logits over 2 x 37
    tokens, the logits of 4 decode steps from a 3-slot pool holding both
    prefills (slot 1 inactive, the CPU's greedy tokens fed to both), all
    within LOGIT_ATOL, and the tokens of a whole-prefill engine with
    ``prefill_dense_frac`` 0 (prompts of 40, 17 and 70 tokens); then a
    calibrated plan (:func:`reduced_calibrated_check`)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.models import api, model as M, params as P
    from repro_torch.serving import Engine, EngineConfig, SlotKVPool
    from repro_torch.sparsity import SparsityPolicy

    cfg = reduced(get_config(arch))
    cpu = torch.device("cpu")
    params_c = api.init_model(cfg, SEED, device=cpu)
    sp_c = default_sp_stacked(params_c, cfg, keep_frac=KEEP,
                              tau=float("-inf"))
    params_g = P.tree_map(lambda t: t.to(dev), params_c)
    sp_g = P.tree_map(lambda t: t.to(dev), sp_c)
    pol = SparsityPolicy.uniform("pallas", k_max_frac=KEEP, block=16)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 37)))
    sides = ((dev, params_g, sp_g), (cpu, params_c, sp_c))
    pools, logits = [], []
    with torch.no_grad():
        for d, params, sp in sides:
            lg, caches = M.forward(params, cfg, tokens=toks.to(d),
                                   mode="prefill", sp=sp, policy=pol)
            pool = SlotKVPool(cfg, 3, 64, device=d)
            slots = [pool.alloc() for _ in range(3)]
            pool.insert(caches, 0, slots[0], 37)
            pool.insert(caches, 1, slots[2], 37)
            pools.append(pool)
            logits.append(lg)
        err = max_err(logits[0].cpu(), logits[1])
        nxt = torch.argmax(logits[1], -1)
        tokens = torch.stack([nxt[0], torch.tensor(0), nxt[1]])
        positions = torch.tensor([37, 63, 37])
        active = torch.tensor([1.0, 0.0, 1.0])
        step = api.make_slot_decode_step(cfg)
        for _ in range(4):
            outs = [step(params, tokens.to(d), positions.to(d),
                         pool.caches, sp, active.to(d), policy=pol)[0]
                    for (d, params, sp), pool in zip(sides, pools)]
            err = max(err, max_err(outs[0].cpu(), outs[1]))
            tokens = torch.argmax(outs[1], -1) * active.long()
            positions = positions + active.long()
    if not err <= LOGIT_ATOL:
        raise AssertionError(f"reduced {arch}: card vs CPU logits err {err}")
    outs = []
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (40, 17, 70)]
    for d, params, sp in sides:
        eng = Engine(params, cfg, EngineConfig(
            max_slots=3, max_len=128, prefill_chunk=16, policy=pol,
            prefill_dense_frac=0.0), sp, device=d)
        if eng.prefill_strategy != "whole":
            raise AssertionError(f"reduced {arch} resolved to "
                                 f"{eng.prefill_strategy!r}")
        for p in prompts:
            eng.submit(p, 24)
        outs.append(eng.run())
    if outs[0] != outs[1]:
        raise AssertionError(f"reduced {arch} engine tokens: card {outs[0]} "
                             f"!= CPU {outs[1]}")
    distinct = len({t for ts in outs[0].values() for t in ts})
    print(f"reduced {arch} on the card vs CPU: prefill and 4 decode steps' "
          f"logits max abs err {err:.2e} (<= {LOGIT_ATOL}); whole-prefill "
          f"pallas engine tokens equal ({distinct} distinct)")
    calibrated = reduced_calibrated_check(
        arch, cfg, dev, params_c, params_g, prompts,
        dict(max_slots=3, max_len=128, prefill_chunk=16), 24)
    return {"logits_max_abs_err": err, "distinct_tokens": distinct,
            "calibrated": calibrated}


def reduced_multimodal_check(dev, arch: str) -> dict:
    """Reduced ``arch`` (whisper_large_v3: 2 + 2 layers, 16 frames,
    ``scale_gemma_weights``; internvl2_26b: 2 layers, an 8-token patch
    prefix; f32) from the CPU's init on the card: the greedy tokens of
    :func:`generate` (prefill, padded caches, 11 decode steps) over 2 x 12
    tokens with their frames or patches equal the CPU's under ``off``,
    ``mask`` and ``pallas`` (block 16, uncalibrated: keep 0.5, tau
    -inf).  Whisper then calibrates a plan on the CPU (the
    ``--calib-quick`` stages, one generation of two offspring, 2 x 32
    tokens over 2 x 16 frames), which serves the CPU's tokens on the
    card under ``mask`` and ``pallas``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import calibration, pipeline
    from repro_torch.core.allocation import EvoConfig
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.models import api, params as P
    from repro_torch.sparsity import SparsityPolicy

    cfg = reduced(get_config(arch))
    cpu = torch.device("cpu")
    params_c = api.init_model(cfg, SEED, device=cpu)
    if cfg.family == "encdec":
        scale_gemma_weights(params_c)
    params_g = P.tree_map(lambda t: t.to(dev), params_c)
    rng = np.random.default_rng(SEED)
    key, rows = (("frames", cfg.encoder_frames) if cfg.family == "encdec"
                 else ("patch_embeds", cfg.vision_prefix))

    def inputs(b):
        return {key: torch.from_numpy(rng.standard_normal(
            (b, rows, cfg.d_model)).astype(np.float32))}

    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    extra = inputs(2)
    sp_c = default_sp_stacked(params_c, cfg, keep_frac=KEEP,
                              tau=float("-inf"))

    def both(policy, sp_c):
        sp_g = None if sp_c is None else P.tree_map(lambda t: t.to(dev), sp_c)
        got = generate(params_g, cfg, toks.to(dev), 12, policy=policy,
                       sp=sp_g, **{k: v.to(dev) for k, v in extra.items()})
        want = generate(params_c, cfg, toks, 12, policy=policy, sp=sp_c,
                        **extra)
        if not torch.equal(got, want):
            raise AssertionError(f"reduced {arch} under {policy.backend}: "
                                 f"card tokens {got.tolist()} != CPU "
                                 f"{want.tolist()}")
        return len(set(got.flatten().tolist()))

    distinct = {b: both(SparsityPolicy.uniform(b, k_max_frac=KEEP, block=16),
                        sp_c) for b in ("off", "mask", "pallas")}
    out = {"distinct_tokens": distinct}
    if cfg.family == "encdec":
        calib = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32)),
                 **inputs(2)}
        ctx = calibration.build_context(params_c, cfg, calib)
        plan = pipeline.run_pipeline(
            params_c, cfg, None, KEEP, evo=EvoConfig(generations=1,
                                                     offspring=2, eps=0.1),
            delta=0.25, coord_passes=0, ctx=ctx)
        out["calibrated_distinct_tokens"] = {
            b: both(plan.to_policy(backend=b, block=16), plan.stacked_sp)
            for b in ("mask", "pallas")}
        out["kl"] = ctx.fitness(plan.per_depth_sp)
    print(f"reduced {arch} on the card vs CPU: prefill-then-decode greedy "
          f"tokens equal under off, mask and pallas ({out})")
    return out


# ---------------------------------------------------------------------------
# phase 5: full-width serving
# ---------------------------------------------------------------------------

def served_config(arch: str, depth: int = SERVE_DEPTH):
    """``arch``'s published config cut to ``depth`` layers (an enc-dec
    model's encoder too)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(
        cfg, num_layers=depth,
        encoder_layers=depth if cfg.encoder_layers else 0)


def full_width_model(dev):
    """llama31_8b at full width, SERVE_DEPTH of its 32 layers, random
    weights from SEED."""
    from repro_torch import obs
    from repro_torch.models import api

    cfg = served_config("llama31_8b")
    assert cfg.num_layers == SERVE_DEPTH and cfg.d_model == 4096
    t0 = obs.now()
    params = api.init_model(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"llama31_8b, {cfg.num_layers} of 32 layers: "
          f"{n_params / 1e9:.2f}B params ({cfg.dtype}), init "
          f"{obs.now() - t0:.1f} s, device memory "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    return cfg, params


def serving_trace(cfg) -> dict:
    """Phase 5's trace: 12 ragged prompts, 32 new tokens each, 8 slots,
    and an independent count of its sparse prefill chunks (§5.1: chunks
    that start at or past ceil(P/2) run sparse)."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 449, 12)
    prompts = [rng.integers(0, cfg.vocab_size, int(p)) for p in lens]
    ecfg = dict(max_slots=8, max_len=512, prefill_chunk=32)
    C = ecfg["prefill_chunk"]
    sparse_chunks = sum(1 for p in lens for off in range(0, int(p), C)
                        if off >= math.ceil(int(p) * 0.5))
    return {"prompts": prompts, "ecfg": ecfg, "gen": 32,
            "sparse_chunks": sparse_chunks}


def serve_once(name, params, cfg, policy, sp, trace, dev, K, ladder=None,
               slo=None, spec=None, eager_chunks=False,
               window=WINDOW, warm=False) -> dict:
    """One run of the trace through a fresh ``Engine`` (from ``policy``
    and ``sp``, or from ``ladder`` under ``slo`` or ``spec``), with the
    kernels' launch counts zeroed just before the engine is built and
    read just after the run.  Decode, chunk and verify steps run as CUDA
    graphs: the wrappers count a kernel once where it is captured, and
    its replays count nothing, so the launches that ran are the counts
    with each captured launch taken once per replay
    (``Engine.launches``).  They must equal the sparse passes executed:
    one per projection of every layer (:func:`pass_launches`) per
    replay of a sparse decode or chunk graph, per eager warm call
    before each such capture, and per eager sparse chunk; a dense run
    launches none.  ``eager_chunks`` runs the prefill chunks through the
    plain chunk step instead of their graphs (the path before the chunk
    step was captured), for the before/after comparison.  ``warm``
    builds every step before the trace (``Engine.warmup``) and checks
    that the run builds no decode or chunk step after it."""
    from repro_torch import obs
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.metrics import percentile

    gen = trace["gen"]
    K.reset_launch_counts()
    eng = Engine(params, cfg, EngineConfig(
        policy=policy, slo=slo, spec=spec, **trace["ecfg"]), sp,
        device=dev, ladder=ladder)
    if eager_chunks:
        eng._chunk = EagerChunks(eng._chunk)
    if warm:
        eng.warmup()
    for p in trace["prompts"]:
        eng.submit(p, gen)
    t0 = obs.now()
    out, res = drive(eng, window)
    torch.cuda.synchronize()
    res["wall_s"] = obs.now() - t0
    counts = dict(K.launch_counts)
    for rid, toks in out.items():
        if len(toks) != gen or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            raise AssertionError(f"{name}: request {rid} gave {toks}")
    if policy is not None and ladder is None and not policy.is_dense:
        if trace["sparse_chunks"] != res["prefill_sparse_chunks"]:
            raise AssertionError(
                f"{name}: sparse prefill chunks: engine "
                f"{res['prefill_sparse_chunks']} != expected "
                f"{trace['sparse_chunks']}")
    check_launches(name, eng, ladder, counts, res, cfg)
    g, ch = eng.decode_graphs, eng.chunk_graphs
    res["decode_replays"] = list(g.steps)
    res["chunk_replays"] = sum(ch.steps)
    res["captures"] = g.builds
    res["chunk_captures"] = ch.builds
    if eng.controller is not None:
        c = eng.controller
        res["transitions"] = list(c.transitions)
        res["residency"] = list(c.residency)
        res["token_rungs"] = {rid: list(rs.token_rungs)
                              for rid, rs in eng.states.items()}
    res["strategy"] = eng.prefill_strategy
    res["distinct_tokens"] = len({t for ts in out.values() for t in ts})
    if warm:
        builds = (eng.decode_retraces_after_warmup,
                  eng.chunk_retraces_after_warmup)
        if builds != (0, 0):
            raise AssertionError(f"{name}: (decode, chunk) builds after "
                                 f"warmup {builds}")
        res["builds_after_warmup"] = list(builds)
    if eng.controller is not None or eng.spec_decoder is not None:
        res["decode_retraces_after_warmup"] = \
            eng.decode_retraces_after_warmup
        res["chunk_retraces_after_warmup"] = eng.chunk_retraces_after_warmup
        if eng.chunk_retraces_after_warmup != 0:
            raise AssertionError(
                f"{name}: {eng.chunk_retraces_after_warmup} chunk builds "
                "after warmup")
    if eng.spec_decoder is not None:
        st = eng.stats
        res["verify_retraces_after_warmup"] = \
            eng.verify_retraces_after_warmup
        res["spec"] = {
            "rounds": st.spec_rounds,
            "accept_rate": st.spec_accepted_tokens
            / max(1, st.spec_draft_tokens),
            "accepted_per_verify": st.spec_accepted_tokens
            / max(1, st.spec_verifies),
            "committed_tokens": st.spec_committed_tokens,
            "draft_ms_per_round_p50": 1e3 * percentile(st.spec_draft_s, 50),
            "verify_ms_per_round_p50": 1e3 * percentile(st.spec_verify_s,
                                                        50),
            "snapshot": eng.spec_decoder.snapshot()}
    res["tokens"] = out
    del eng
    gc.collect()
    return res


def pass_launches(cfg, policy=None) -> dict:
    """Launches of each kernel in one sparse pass of ``cfg`` under
    ``policy`` (None: every projection under ``pallas``): one of
    ``score_select`` and of ``sparse_matmul_shared`` per 2-D projection
    whose role runs ``pallas`` at its depth (``KIND_ROLES``: 4 per
    attention mixer, 6 per mamba mixer, 3 per dense MLP), one of each
    ``_experts`` kernel per expert projection (3 per MoE layer, for all
    its experts).  At full depth llama31_8b: 224 and 0;
    granite_moe_3b_a800m: 128 and 96; mamba2_130m: 144 and 0; at
    ``SERVE_DEPTH`` = 8 layers: 56 and 0, 32 and 24, 48 and 0; one
    period of jamba_v01_52b (8 layers): 58 and 12."""
    plain = experts = 0
    for depth, kind in enumerate(cfg.layer_kinds()):
        lpol = None if policy is None else policy.resolve_depth(depth)
        for role in KIND_ROLES[kind[0]] + KIND_ROLES[kind[1]]:
            if lpol is None or lpol.backend_at(role=role) == "pallas":
                if role.startswith("moe/"):
                    experts += 1
                else:
                    plain += 1
    return {"score_select": plain, "sparse_matmul_shared": plain,
            "score_select_experts": experts,
            "sparse_matmul_shared_experts": experts}


def role_counts(cfg) -> dict:
    """{role: its projections in one sparse pass of ``cfg``}, every role
    under ``pallas`` (an expert role: one projection for all the layer's
    experts)."""
    out = {}
    for mixer, ffn in cfg.layer_kinds():
        for role in KIND_ROLES[mixer] + KIND_ROLES[ffn]:
            out[role] = out.get(role, 0) + 1
    return out


def check_launches(name, eng, ladder, counts, res, cfg) -> None:
    """The launches that ran in ``eng``'s run (``counts`` read just
    after it, zeroed just before the engine was built) against the
    sparse passes it executed, kernel by kernel (:func:`pass_launches`);
    records them in ``res``."""
    launches = eng.launches(counts)
    per_pass = pass_launches(cfg)
    served = tuple(per_pass)
    g, ch = eng.decode_graphs, eng.chunk_graphs
    # (steps object, is each key's step sparse)
    policies = ladder.policies if ladder is not None else [eng.policy]
    kinds = [(g, [not p.for_phase("decode").is_dense for p in policies]),
             (ch, [not pol.is_dense for _r, pol in ch.keys])]
    if eng.spec_decoder is not None:
        vs = eng.spec_decoder.verify_steps
        kinds.append((vs, [False] * len(vs)))
    passes, graph_sparse_chunks = 0, 0
    for steps, sparse in kinds:
        for i, sp_i in enumerate(sparse):
            if not steps.built(i):
                continue
            for k in served:
                want_cap = per_pass[k] if sp_i else 0
                if steps.captured[i][k] != want_cap:
                    raise AssertionError(
                        f"{name}: {type(steps).__name__} {steps.keys[i]}'s "
                        f"graph captured {steps.captured[i][k]} {k} "
                        f"launches, expected {want_cap}")
            if sp_i:
                passes += steps.steps[i] + 1       # replays + warm call
                if steps is ch:
                    graph_sparse_chunks += steps.steps[i]
    eager_sparse = res["prefill_sparse_chunks"] - graph_sparse_chunks
    passes += eager_sparse
    for k in served:
        if launches[k] != per_pass[k] * passes:
            raise AssertionError(
                f"{name}: {k} launched {launches[k]} times, expected "
                f"{per_pass[k] * passes} = {per_pass[k]} x {passes} sparse "
                f"passes (graph replays and warm calls of sparse decode and "
                f"chunk steps, and {eager_sparse} eager sparse chunks)")
    if launches["sparse_matmul_per_seq"]:
        raise AssertionError(f"{name}: a serving run launched "
                             "sparse_matmul_per_seq")
    if passes:
        res["launches"] = {k: launches[k] for k in served}
        res["launches_counted"] = {k: counts[k] for k in served}
        res["launches_per_decode_step"] = per_pass
        res["sparse_passes"] = passes


class EagerChunks:
    """The engine's chunk steps with every chunk run through the plain
    step (``ChunkSteps.eager``) and nothing built: the prefill path as
    it was before the chunk step was captured, for the before/after
    comparison of phase 5 only."""

    def __init__(self, steps):
        self._steps = steps

    def __getattr__(self, name):
        return getattr(self._steps, name)

    def build(self, i: int) -> None:
        pass

    def __call__(self, i, tokens, offset, slot, weights):
        return self._steps.eager(i, tokens, offset, slot, weights)


def _fmt(res: dict) -> str:
    return ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in res.items()
                     if k not in ("tokens", "token_rungs"))


def serve_full_width(dev, K, cfg, params, trace) -> dict:
    """Phase 5: dense and uncalibrated ``pallas``, each twice in the
    order dense, pallas, pallas, dense."""
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    modes = {"dense": (SparsityPolicy.dense(), None),
             "pallas": (SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
                        sp)}
    # warm both paths (cuBLAS handles, allocator) outside the measured runs
    for pol, s in modes.values():
        eng = Engine(params, cfg, EngineConfig(policy=pol, **trace["ecfg"]),
                     s, device=dev)
        eng.submit(trace["prompts"][0][:40], 2)
        eng.run()
        del eng
        gc.collect()

    # each mode runs twice, in the order dense, pallas, pallas, dense, so
    # the spread between a mode's two runs shows the host's variance
    # within one call with the code held fixed
    runs = {"dense": [], "pallas": []}
    for name in ("dense", "pallas", "pallas", "dense"):
        pol, s = modes[name]
        res = serve_once(name, params, cfg, pol, s, trace, dev, K)
        if runs[name] and res["tokens"] != runs[name][0]["tokens"]:
            raise AssertionError(f"{name}: the second run's greedy tokens "
                                 "differ from the first's")
        runs[name].append(res)
        print(f"{name:6s} run {len(runs[name])}: {_fmt(res)}")
    # the same trace with the prefill chunks run eagerly (the path before
    # the chunk step was captured): the before/after of this call
    for name in ("dense", "pallas"):
        pol, s = modes[name]
        res = serve_once(f"{name} eager chunks", params, cfg, pol, s, trace,
                         dev, K, eager_chunks=True)
        if res["tokens"] != runs[name][0]["tokens"]:
            raise AssertionError(f"{name}: eager chunks gave other greedy "
                                 "tokens than the chunk graphs")
        if res["chunk_captures"] or res["chunk_replays"]:
            raise AssertionError(f"{name} eager chunks: a chunk graph ran")
        runs[f"{name} eager chunks"] = [res]
        print(f"{name:6s} eager chunks: {_fmt(res)}")
    for name in ("dense", "pallas"):
        e = runs[f"{name} eager chunks"][0]
        for i, r in enumerate(runs[name]):
            print(f"{name} run {i + 1} against its eager-chunk run: chunk "
                  f"p50 {r['prefill_chunk_p50_ms']:.2f} / "
                  f"{e['prefill_chunk_p50_ms']:.2f} ms, TTFT p50 "
                  f"{r['ttft_p50_ms']:.1f} / {e['ttft_p50_ms']:.1f} ms, "
                  f"prefill {r['prefill_s']:.2f} / {e['prefill_s']:.2f} s, "
                  f"run {r['wall_s']:.2f} / {e['wall_s']:.2f} s "
                  "(graph / eager); greedy tokens equal")
    for name in ("dense", "pallas"):
        rs = runs[name]
        p50 = [r["decode_step_p50_ms"] for r in rs]
        print(f"{name:6s}: decode step p50 {p50[0]:.2f} / {p50[1]:.2f} ms in "
              f"its two runs (spread {100 * (max(p50) / min(p50) - 1):.1f}%); "
              "greedy tokens equal across the two runs")
    print(f"greedy tokens equal to dense at the same position: "
          f"{agreement(runs['dense'][0], runs['pallas'][0]):.3f} "
          "(random weights; informative only)")
    return runs


def agreement(a: dict, b: dict) -> float:
    return float(np.mean([x == y for rid in a["tokens"]
                          for x, y in zip(a["tokens"][rid],
                                          b["tokens"][rid])]))


# ---------------------------------------------------------------------------
# phase 6: full-width calibration
# ---------------------------------------------------------------------------

LADDER_BUDGETS = (0.0, 0.5, 0.7)


def _sp_scalars(cfg, sp, key: str) -> dict:
    """{(depth, path): the sp leaf scalar ``key``} of a stacked sp tree."""
    from repro_torch.core import unstacked as U
    from repro_torch.obs.quality import unstack_sp
    out = {}
    for d, spd in enumerate(unstack_sp(cfg, sp)):
        for path in _leaf_paths(spd):
            out[(d, path)] = float(U.get_sp_leaf(spd, path)[key])
    return out


def _leaf_paths(node, prefix=""):
    for k in sorted(node):
        if "g" in node[k]:
            yield prefix + k
        else:
            yield from _leaf_paths(node[k], prefix + k + "/")


def timed_ladder(cfg, params, evo, tag=""):
    """``sparsity.calibrate_ladder`` of a ``pallas`` ladder at budgets
    LADDER_BUDGETS, 0.0 (dense), 0.5 (the cold search) and 0.7
    (warm-started from the 0.5 rung), with the serve CLI's
    ``--calib-quick`` stages under ``evo``, on 4 x 128 synthetic tokens,
    with the v4 quality baselines.  Prints each rung's stage wall times.
    Returns (ladder, ctx, info)."""
    from repro_torch import obs
    from repro_torch.core import calibration
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.sparsity import calibrate_ladder

    toks = SyntheticLM(DataConfig(cfg.vocab_size, 128, 4)).batch(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    marks = [("context", obs.now())]

    def log(msg):
        torch.cuda.synchronize()
        print(f"  [{obs.now() - marks[0][1]:7.1f} s] {tag}{msg}")
        for stage, text in (("coarse (Alg. 3)", "coarse search"),
                            ("fine (Alg. 4)", "fine search"),
                            ("alpha (Alg. 2)", "alpha search:"),
                            ("rung", "rung "),
                            ("baselines", "recording quality baselines")):
            if msg.startswith(text):
                label = msg.split(":")[0] if stage == "rung" else stage
                marks.append((label, obs.now()))

    ctx = calibration.build_context(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    log(f"calibration context: {len(ctx.acts)} linears captured over "
        f"{toks.size} tokens")
    ladder = calibrate_ladder(params, cfg, None, LADDER_BUDGETS,
                              backend="pallas", evo=evo, delta=0.25,
                              coord_passes=0, ctx=ctx, log=log)
    torch.cuda.synchronize()
    marks.append(("end", obs.now()))
    peak = torch.cuda.max_memory_allocated() - base
    # wall time of each stage, and of each rung from its own mark to the
    # next rung's (or the baselines')
    stages, rung_s, rung = [], {}, None
    for (label, t), (_next, t1) in zip(marks, marks[1:]):
        if label.startswith("rung "):
            rung = label
            rung_s[rung] = 0.0
        elif rung is not None and label != "baselines":
            stages.append((f"{rung} {label}", t1 - t))
        if rung is not None and label != "baselines":
            rung_s[rung] += t1 - t
        if label in ("context", "baselines"):
            stages.append((label, t1 - t))
    total = marks[-1][1] - marks[0][1]
    print(f"{tag}ladder calibration wall times (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages) + f"; total {total:.2f}")
    print(f"{tag}per rung (s): " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in rung_s.items()))
    return ladder, ctx, {"stages_s": dict(stages), "rungs_s": rung_s,
                         "total_s": total, "peak_gb": peak / 1e9}


def calibrate_full_width(cfg, params):
    """WiSparse Alg. 1-4 on the full-width model as a ``pallas`` policy
    ladder (:func:`timed_ladder`).  Checks the 0.5 rung as one plan
    (budget, finite thresholds, KL beside the activation-only plan's)
    and the ladder's monotonicity.  Returns (ladder, info)."""
    from repro_torch.core import pipeline
    from repro_torch.core.allocation import EvoConfig, weighted_average
    from repro_torch.obs.quality import unstack_sp

    evo = EvoConfig(generations=2, offspring=4, eps=0.1)
    ladder, ctx, times = timed_ladder(cfg, params, evo)

    # the 0.5 rung is the cold search: check it as one calibrated plan
    p_target = LADDER_BUDGETS[1]
    ratios = np.asarray(ladder.block_ratios[1])
    keep = _sp_scalars(cfg, ladder.sps[1], "keep_frac")
    taus = _sp_scalars(cfg, ladder.sps[1], "tau")
    alphas = _sp_scalars(cfg, ladder.sps[1], "alpha")
    kl = ctx.fitness(unstack_sp(cfg, ladder.sps[1]))
    act = pipeline.activation_only_plan(params, cfg, None, p_target, ctx=ctx)
    kl_act = ctx.fitness(act.per_depth_sp)
    print(f"rung 1 block ratios: {[round(float(x), 4) for x in ratios]}")
    print(f"rung 2 block ratios: "
          f"{[round(float(x), 4) for x in ladder.block_ratios[2]]}")
    print(f"mean alpha {np.mean(list(alphas.values())):.4f}; device memory "
          f"peak above the model {times['peak_gb']:.2f} GB (total "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    print(f"KL (Eq. 8) on the calibration tokens: rung 1 {kl:.6g}, "
          f"activation-only plan {kl_act:.6g} (random weights; "
          "informative only)")
    print(f"quality baselines: recon per rung (mean over blocks) "
          f"{[float(np.mean(r)) for r in ladder.baselines['recon']]}")
    avg = weighted_average(ctx, ratios)
    if not p_target - evo.eps <= avg <= p_target + 1e-9:
        raise AssertionError(f"size-weighted block ratio {avg} is outside "
                             f"[{p_target - evo.eps}, {p_target}]")
    bad = [k for k, t in taus.items() if keep[k] < 1.0
           and not math.isfinite(t)]
    if bad:
        raise AssertionError(f"non-finite taus of sparsified linears: {bad}")
    if len(taus) != 7 * cfg.num_layers:
        raise AssertionError(f"{len(taus)} taus, expected "
                             f"{7 * cfg.num_layers}")
    for lo, hi in zip(ladder.block_ratios, ladder.block_ratios[1:]):
        if not np.all(np.asarray(hi) >= np.asarray(lo) - 1e-9):
            raise AssertionError("ladder block ratios are not monotone")
    avg2 = weighted_average(ctx, np.asarray(ladder.block_ratios[2]))
    if not LADDER_BUDGETS[2] - evo.eps <= avg2 <= LADDER_BUDGETS[2] + 1e-9:
        raise AssertionError(f"rung 2's size-weighted block ratio {avg2} "
                             f"is outside its budget")
    print(f"budget: rung 1's size-weighted block ratio {avg:.6f} in "
          f"[{p_target - evo.eps}, {p_target}], rung 2's {avg2:.6f}; every "
          "tau of a sparsified linear is finite; the ladder is monotone "
          "per block")
    info = {**times, "kl": kl, "kl_activation_only": kl_act,
            "weighted_ratio": avg, "weighted_ratio_rung2": avg2}
    del ctx, act
    torch.cuda.empty_cache()
    return ladder, info


def check_calibrated_ladder(tag, cfg, ctx, ladder, evo, keys_per_layer
                            ) -> list:
    """Every sparse rung of a calibrated ladder: its size-weighted block
    ratio (``allocation.weighted_average``, on the context's sizes: the
    top-k experts' for an expert weight) within [budget - eps, budget],
    one tau per linear (``keys_per_layer`` x layers), finite wherever a
    linear is sparsified; the ladder monotone per block.  Prints and
    returns each rung's KL (Eq. 8) on the calibration tokens,
    ``k_max_frac`` and its per-layer keep-ratio range."""
    from repro_torch.core.allocation import weighted_average
    from repro_torch.obs.quality import unstack_sp

    for lo, hi in zip(ladder.block_ratios, ladder.block_ratios[1:]):
        if not np.all(np.asarray(hi) >= np.asarray(lo) - 1e-9):
            raise AssertionError(f"{tag}: ladder block ratios are not "
                                 "monotone")
    out = []
    for i, budget in enumerate(ladder.budgets):
        keep = _sp_scalars(cfg, ladder.sps[i], "keep_frac")
        taus = _sp_scalars(cfg, ladder.sps[i], "tau")
        if len(taus) != keys_per_layer * cfg.num_layers:
            raise AssertionError(f"{tag} rung {i}: {len(taus)} taus, "
                                 f"expected {keys_per_layer} x "
                                 f"{cfg.num_layers}")
        info = {"budget": budget,
                "k_max_frac": ladder.policies[i].k_max_frac,
                "keep_min": min(keep.values()),
                "keep_max": max(keep.values())}
        if budget > 0:
            avg = weighted_average(ctx, np.asarray(ladder.block_ratios[i]))
            if not budget - evo.eps <= avg <= budget + 1e-9:
                raise AssertionError(
                    f"{tag} rung {i}: size-weighted block ratio {avg} "
                    f"outside [{budget - evo.eps}, {budget}]")
            bad = [k for k, t in taus.items() if keep[k] < 1.0
                   and not math.isfinite(t)]
            if bad:
                raise AssertionError(f"{tag} rung {i}: non-finite taus of "
                                     f"sparsified linears: {bad}")
            alphas = _sp_scalars(cfg, ladder.sps[i], "alpha")
            info.update(
                weighted_ratio=avg,
                kl=ctx.fitness(unstack_sp(cfg, ladder.sps[i])),
                mean_alpha=float(np.mean(list(alphas.values()))),
                block_ratios=[round(float(x), 4)
                              for x in ladder.block_ratios[i]])
        out.append(info)
        print(f"{tag} rung {i} (budget {budget}): " + ", ".join(
            f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in info.items()))
    print(f"{tag}: every sparse rung within [budget - {evo.eps}, budget] "
          f"by top-k-scaled sizes, {keys_per_layer} x {cfg.num_layers} taus "
          "per rung, finite wherever sparsified; monotone per block")
    return out


# ---------------------------------------------------------------------------
# phase 7: serve the calibrated plan from its artifact
# ---------------------------------------------------------------------------

def serve_calibrated(dev, K, cfg, params, trace, ladder, runs) -> dict:
    """Phase 7: the ladder's 0.5 rung as one calibrated plan, saved as a
    ``pallas`` policy artifact, loaded back and served once."""
    from repro_torch.sparsity import SparsityPolicy

    policy, plan_sp = ladder.rung(1)
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "calibrated_plan.npz")
    policy.save(path, sp=plan_sp)
    loaded, sp = SparsityPolicy.load(path, device=dev)
    if loaded != policy:
        raise AssertionError(f"artifact policy {loaded} != saved {policy}")
    got, want = list(_leaves(sp)), list(_leaves(plan_sp))
    if len(got) != len(want) or not all(
            torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("artifact sp tree differs from the plan's")
    print(f"artifact {os.path.relpath(path, HERE)} "
          f"({os.path.getsize(path) / 1e6:.1f} MB): policy "
          f"{loaded.to_dict()}")
    res = serve_once("calibrated", params, cfg, loaded, sp, trace, dev, K)
    print(f"calibrated pallas run: {_fmt(res)}")
    keys = ("decode_tok_s", "decode_step_p50_ms", "decode_step_p95_ms",
            "ttft_p50_ms", "decode_device_busy")
    for name, r in [("dense 1", runs["dense"][0]),
                    ("dense 2", runs["dense"][1]),
                    ("pallas 1 (uncalibrated)", runs["pallas"][0]),
                    ("calibrated", res)]:
        print(f"  {name:24s} " + ", ".join(f"{k} {r[k]:.4g}" for k in keys))
    print(f"calibrated greedy tokens equal to dense at the same position: "
          f"{agreement(runs['dense'][0], res):.3f} (random weights; "
          "informative only)")
    return res


# ---------------------------------------------------------------------------
# phase 8: serve the calibrated ladder under the SLO controller
# ---------------------------------------------------------------------------

# phase 8's SLO: the TPOT target is out of reach, the queue decides
PHASE8_SLO = dict(tpot_p95=1e6, max_queue=2, dwell=2, hysteresis=0.25)


def save_and_load_ladder(ladder, name, dev):
    """``ladder`` saved as a v4 artifact under ``build/chip_smoke/`` and
    loaded back onto ``dev``: budgets, policies and every sp leaf equal."""
    from repro_torch.sparsity import PolicyLadder

    path = os.path.join(HERE, "build", "chip_smoke", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ladder.save(path)
    loaded = PolicyLadder.load(path, device=dev)
    if loaded.budgets != ladder.budgets or \
            loaded.policies != ladder.policies:
        raise AssertionError(f"{name}: budgets or policies differ")
    for a, b in zip(loaded.sps, ladder.sps):
        ga, gb = list(_leaves(a)), list(_leaves(b))
        if len(ga) != len(gb) or not all(torch.equal(x, y)
                                         for x, y in zip(ga, gb)):
            raise AssertionError(f"{name}: sp trees differ")
    print(f"ladder artifact {os.path.relpath(path, HERE)} "
          f"({os.path.getsize(path) / 1e6:.1f} MB): budgets "
          f"{list(loaded.budgets)}, every sp leaf equal after the round trip")
    return loaded


def check_ladder_run(name, res) -> None:
    """A run under the SLO controller: at least two rungs visited, an
    escalation ("queue") and a return ("idle"), no decode build after
    warmup, every token attributed to a rung."""
    reasons = {t[3] for t in res["transitions"]}
    visited = sum(1 for r in res["residency"] if r > 0)
    if visited < 2 or not {"queue", "idle"} <= reasons:
        raise AssertionError(f"{name}: visited {visited} rungs, transitions "
                             f"{res['transitions']}")
    if res["decode_retraces_after_warmup"] != 0:
        raise AssertionError(f"{name}: {res['decode_retraces_after_warmup']} "
                             "decode builds after warmup")
    for rid, toks in res["tokens"].items():
        if len(res["token_rungs"][rid]) != len(toks):
            raise AssertionError(f"{name}: request {rid} has "
                                 f"{len(res['token_rungs'][rid])} token "
                                 f"rungs for {len(toks)} tokens")


def serve_ladder(dev, K, cfg, params, trace, ladder) -> list:
    """Save the ladder as a v4 artifact under ``build/`` and load it back
    (:func:`save_and_load_ladder`, the quality baselines equal too), and
    serve phase 5's trace from it twice under PHASE8_SLO: the TPOT
    target is out of reach, so the controller acts on queue depth alone
    and both runs must make the same transitions and tokens.  Each run
    must pass :func:`check_ladder_run`, capture one decode step per
    rung, and launch the kernels as ``serve_once`` checks."""
    from repro_torch.serving import SLOConfig

    loaded = save_and_load_ladder(ladder, "ladder.npz", dev)
    if not np.array_equal(loaded.baselines["recon"],
                          ladder.baselines["recon"]) or not all(
            np.array_equal(x, y)
            for ra, rb in zip(loaded.baselines["channels"],
                              ladder.baselines["channels"])
            for x, y in zip(ra, rb)):
        raise AssertionError("ladder artifact: quality baselines differ")
    print(f"ladder artifact: v4 with baselines, policies "
          f"{[p.backend for p in loaded.policies]}")
    runs = []
    for i in range(2):
        res = serve_once(f"ladder {i + 1}", params, cfg, None, None, trace,
                         dev, K, ladder=loaded, slo=SLOConfig(**PHASE8_SLO))
        check_ladder_run(f"ladder run {i + 1}", res)
        if res["captures"] != len(loaded):
            raise AssertionError(f"ladder run {i + 1}: {res['captures']} "
                                 "captures")
        if runs and (res["tokens"] != runs[0]["tokens"]
                     or res["transitions"] != runs[0]["transitions"]
                     or res["token_rungs"] != runs[0]["token_rungs"]):
            raise AssertionError("the two ladder runs differ in tokens, "
                                 "token rungs or transitions")
        total = sum(res["residency"])
        res["residency_share"] = [r / total for r in res["residency"]]
        runs.append(res)
        print(f"ladder run {i + 1}: {_fmt(res)}")
    print(f"ladder: {len(runs[0]['transitions'])} transitions "
          f"{runs[0]['transitions']}; residency per rung "
          f"{runs[0]['residency']}; decode_retraces_after_warmup 0; "
          "tokens, token rungs and transitions equal across the two runs")
    return runs


# ---------------------------------------------------------------------------
# phase 9: the captured decode step against the eager one
# ---------------------------------------------------------------------------

def graph_vs_eager(dev, cfg, params, trace, steps: int = 8) -> dict:
    """At full width, B = 8, dense and uncalibrated ``pallas``: 8 requests
    (the trace's first 8 prompts, cut to 64 tokens) prefilled, then at
    each of ``steps`` decode steps the eager step and the graph replay on
    the same inputs (the eager step writes the new K/V first, the replay
    the same values again).  Greedy tokens must be equal; prints the
    logits' max abs error and, per step, the host time until the argmax
    is on the host and the CUDA-event span of the step (the device's
    timeline from the step's first kernel to its last)."""
    from repro_torch import obs
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.metrics import percentile
    from repro_torch.sparsity import SparsityPolicy

    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    out = {}
    for name, pol, s in (
            ("dense", SparsityPolicy.dense(), None),
            ("pallas", SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
             sp)):
        eng = Engine(params, cfg, EngineConfig(policy=pol, **trace["ecfg"]),
                     s, device=dev)
        for p in trace["prompts"][:8]:
            eng.submit(p[:64], 64)
        while eng.scheduler.prefilling or eng.scheduler.has_queued():
            eng.step()
        g = eng.decode_graphs
        err, times = 0.0, {"eager": [], "graph": []}
        for _ in range(steps):
            tokens, positions, active = eng.decode_inputs()
            if active.sum() != 8:
                raise AssertionError(f"{name}: {active.sum()} active slots")
            res = {}
            for kind in ("eager", "graph"):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = obs.now()
                start.record()
                if kind == "eager":
                    logits = g.eager(0, tokens, positions, active)
                    nxt = torch.argmax(logits, -1).cpu().numpy()
                else:
                    nxt, logits = g(0, tokens, positions, active)
                end.record()
                t1 = obs.now()
                torch.cuda.synchronize()
                times[kind].append((1e3 * (t1 - t0),
                                    start.elapsed_time(end)))
                res[kind] = (nxt, logits.float().clone())
            if not np.array_equal(res["eager"][0], res["graph"][0]):
                raise AssertionError(f"{name}: graph replay tokens "
                                     f"{res['graph'][0]} != eager "
                                     f"{res['eager'][0]}")
            err = max(err, max_err(res["graph"][1], res["eager"][1]))
            eng.step()                 # one real step (a replay) onward
        row = {"logits_max_abs_err": err}
        for kind, ts in times.items():
            row[f"{kind}_host_ms_p50"] = percentile([h for h, _ in ts], 50)
            row[f"{kind}_span_ms_p50"] = percentile([d for _, d in ts], 50)
        out[name] = row
        print(f"graph vs eager, {name}, B=8, {steps} steps: greedy tokens "
              f"equal; logits max abs err {err:.3g}; host ms per step "
              f"eager {row['eager_host_ms_p50']:.2f} / graph "
              f"{row['graph_host_ms_p50']:.2f}; event span ms eager "
              f"{row['eager_span_ms_p50']:.2f} / graph "
              f"{row['graph_span_ms_p50']:.2f} (p50)")
        del eng
    return out


# ---------------------------------------------------------------------------
# phase 10: the captured chunk step against the eager one
# ---------------------------------------------------------------------------

def chunk_graph_vs_eager(dev, cfg, params, trace) -> dict:
    """At full width, one request's chunks of B = 32 tokens, dense and
    uncalibrated ``pallas`` (the sparse prefill phase's step): for each
    chunk of the trace's longest prompt the eager step, then the graph
    replay on the same inputs (the eager step writes the chunk's K/V
    first, the replay the same values again).  Greedy tokens of every
    row, logits and the slot's pool bytes must be equal; prints the
    logits' max abs error and the host ms per chunk of each, until the
    argmax is on the host."""
    from repro_torch import obs
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.metrics import percentile
    from repro_torch.sparsity import SparsityPolicy

    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    C = trace["ecfg"]["prefill_chunk"]
    prompt = max(trace["prompts"], key=len)
    n = len(prompt) // C
    out = {}
    for name, pol, s in (
            ("dense", SparsityPolicy.dense(), None),
            ("pallas", SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
             sp)):
        eng = Engine(params, cfg, EngineConfig(policy=pol, **trace["ecfg"]),
                     s, device=dev)
        eng.warmup()
        ch = eng.chunk_graphs
        i = ch.index(0, pol.for_phase("prefill_sparse"))
        slot = eng.pool.alloc()
        weights = np.ones(C, np.float32)
        err, times = 0.0, {"eager": [], "graph": []}
        for c in range(n):
            tokens = prompt[c * C:(c + 1) * C][None].astype(np.int64)
            res = {}
            for kind in ("eager", "graph"):
                torch.cuda.synchronize()
                t0 = obs.now()
                if kind == "eager":
                    logits = ch.eager(i, tokens, c * C, slot, weights)
                else:
                    logits = ch(i, tokens, c * C, slot, weights)
                nxt = torch.argmax(logits[0], -1).cpu().numpy()
                times[kind].append(1e3 * (obs.now() - t0))
                rows = torch.cat([e["self"][k][:, slot].reshape(-1)
                                  for grp in eng.pool.caches for e in grp
                                  for k in ("k", "v")])
                res[kind] = (nxt, logits.float().clone(), rows)
            if not np.array_equal(res["eager"][0], res["graph"][0]):
                raise AssertionError(f"{name}: chunk {c}: graph tokens "
                                     "differ from the eager step's")
            if not torch.equal(res["eager"][2], res["graph"][2]):
                raise AssertionError(f"{name}: chunk {c}: the graph wrote "
                                     "other pool bytes than the eager step")
            err = max(err, max_err(res["graph"][1], res["eager"][1]))
        if ch.steps[i] != n:
            raise AssertionError(f"{name}: {ch.steps[i]} chunk replays")
        row = {"chunks": n, "logits_max_abs_err": err,
               "eager_host_ms_p50": percentile(times["eager"], 50),
               "graph_host_ms_p50": percentile(times["graph"], 50)}
        out[name] = row
        print(f"chunk graph vs eager, {name}, B={C}, {n} chunks: greedy "
              f"tokens and pool bytes equal; logits max abs err {err:.3g}; "
              f"host ms per chunk eager {row['eager_host_ms_p50']:.2f} / "
              f"graph {row['graph_host_ms_p50']:.2f} (p50)")
        del eng, res
        gc.collect()
    return out


# ---------------------------------------------------------------------------
# phase 11: speculative decoding
# ---------------------------------------------------------------------------

# near-tie rule of the f32 parity runs: a spec run may leave verifier-only
# decode's tokens only where the verifier's own top-2 logits lie closer
# than the bf16 tolerance of the reference's kernel tests
NEAR_TIE = 3e-2


def serve_spec(dev, K, cfg, params, trace, ladder) -> dict:
    """Phase 5's trace at full width, three runs: verifier-only decode
    (the calibrated ladder pinned at its dense rung 0), spec decoding on
    the calibrated ladder (drafter rung 1, gamma 2), and spec decoding on
    a keep-all ladder (0.0 dense; 0.01 ``pallas`` with keep_frac 1,
    tau -inf, k_max_frac 1), whose drafter computes dense's function
    through the Hopper kernels so that drafts are accepted and the
    multi-token commit runs.  Each spec run must build nothing after
    warmup and launch the kernels as ``serve_once`` checks; the keep-all
    run must accept drafts.

    Token parity is held twice.  In bf16, the served dtype and the timed
    runs, the verify (a multi-token forward) and decode are different
    computations: ``verify_vs_decode`` measures how far their logits
    part on one state, and a request may leave verifier-only decode's
    tokens only where the verifier's own top-2 gap is under twice that
    error.  The same three runs in f32 (the model and ladders cast up)
    hold the algorithm exactly: there a request may leave verifier-only
    decode only at a gap under ``NEAR_TIE``."""
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.models import params as P
    from repro_torch.serving import SpecConfig
    from repro_torch.sparsity import PolicyLadder, SparsityPolicy

    keep_sp = default_sp_stacked(params, cfg, keep_frac=1.0,
                                 tau=float("-inf"))
    keep_all = PolicyLadder(
        budgets=(0.0, 0.01),
        policies=(SparsityPolicy.dense(),
                  SparsityPolicy.uniform("pallas", k_max_frac=1.0)),
        sps=(keep_sp, keep_sp))
    spec = SpecConfig(gamma=2, drafter_rung=1)
    runs = spec_runs("", dev, K, cfg, params, trace, ladder, keep_all,
                     spec, None)
    # the same runs in f32: the algorithm's parity, free of bf16 rounding
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    up = functools.partial(P.tree_map, lambda t: t.float()
                           if t.is_floating_point() else t)
    params32 = up(params)
    runs.update(spec_runs(" f32", dev, K, cfg32, params32, trace,
                          PolicyLadder(budgets=ladder.budgets,
                                       policies=ladder.policies,
                                       sps=tuple(up(t) for t in ladder.sps)),
                          PolicyLadder(budgets=keep_all.budgets,
                                       policies=keep_all.policies,
                                       sps=tuple(up(t)
                                                 for t in keep_all.sps)),
                          spec, NEAR_TIE))
    del params32
    gc.collect()
    return runs


def spec_runs(tag, dev, K, cfg, params, trace, ladder, keep_all, spec,
              near_tie) -> dict:
    """Verifier-only decode, spec on ``ladder`` and on ``keep_all``, and
    the verify against sequential decode; ``near_tie`` None bounds a
    divergence by twice the measured verify-decode logit error."""
    ref = serve_once("verifier only" + tag, params, cfg, None, None, trace,
                     dev, K, ladder=ladder, window=0)
    print(f"verifier only{tag}: {_fmt(ref)}")
    vvd = verify_vs_decode(dev, cfg, params, trace, keep_all, spec)
    if near_tie is None:
        near_tie = 2 * vvd["logits_max_abs_err"]
    runs = {"verifier only" + tag: ref, "verify vs decode" + tag: vvd}
    gaps = None
    for name, lad in (("spec calibrated" + tag, ladder),
                      ("spec keep-all" + tag, keep_all)):
        res = serve_once(name, params, cfg, None, None, trace, dev, K,
                         ladder=lad, spec=spec, window=0)
        if res["verify_retraces_after_warmup"] != 0:
            raise AssertionError(f"{name}: verify builds after warmup")
        if res["tokens"] != ref["tokens"] and gaps is None:
            gaps = verifier_gaps(dev, cfg, params, trace, ladder,
                                 ref["tokens"])
            q = np.quantile(list(gaps.values()), [0.01, 0.1, 0.5])
            runs["verifier gaps" + tag] = {
                "p1": q[0], "p10": q[1], "p50": q[2],
                "share_under_near_tie": float(np.mean(
                    [v < NEAR_TIE for v in gaps.values()]))}
            print(f"verifier only{tag}: top-2 logit gap of its decode "
                  f"tokens p1 {q[0]:.4g}, p10 {q[1]:.4g}, p50 {q[2]:.4g}; "
                  f"share under {NEAR_TIE}: "
                  f"{runs['verifier gaps' + tag]['share_under_near_tie']:.4f}")
        res["divergences"] = near_ties(name, ref["tokens"], res["tokens"],
                                       gaps, near_tie)
        sp_ = res["spec"]
        print(f"{name}: acceptance rate {sp_['accept_rate']:.4f}, accepted "
              f"per verify {sp_['accepted_per_verify']:.4f}, draft "
              f"{sp_['draft_ms_per_round_p50']:.2f} ms and verify "
              f"{sp_['verify_ms_per_round_p50']:.2f} ms per round (p50), "
              f"decode tok/s {res['decode_tok_s']:.1f} (verifier only "
              f"{ref['decode_tok_s']:.1f}), TTFT p50 "
              f"{res['ttft_p50_ms']:.1f} ms; {len(res['divergences'])} of "
              f"{len(ref['tokens'])} requests leave verifier-only decode, "
              f"each at a top-2 gap under {near_tie:.4g}; {_fmt(res)}")
        runs[name] = res
    if not runs["spec keep-all" + tag]["spec"]["accept_rate"] > 0:
        raise AssertionError(f"spec keep-all{tag}: no draft accepted")
    return runs


def verifier_gaps(dev, cfg, params, trace, ladder, want) -> dict:
    """Verifier-only decode once more with its decode step wrapped:
    {(request, token index): top-2 gap of the logits that emitted that
    token}; the run must emit ``want`` again."""
    from repro_torch.serving import Engine, EngineConfig

    eng = Engine(params, cfg, EngineConfig(**trace["ecfg"]), device=dev,
                 ladder=ladder)
    eng._decode = GapRecorder(eng, eng._decode)
    for p in trace["prompts"]:
        eng.submit(p, trace["gen"])
    if eng.run() != want:
        raise AssertionError("verifier-only decode changed its tokens")
    gaps = eng._decode.gaps
    del eng
    gc.collect()
    return gaps


class GapRecorder:
    """An engine's decode steps, recording each decoding request's top-2
    logit gap at the token each step emits (one extra host read per
    step: for the near-tie check only, never in a timed run)."""

    def __init__(self, eng, steps):
        self._eng = eng
        self._steps = steps
        self.gaps = {}

    def __getattr__(self, name):
        return getattr(self._steps, name)

    def __call__(self, rung, tokens, positions, active):
        nxt, logits = self._steps(rung, tokens, positions, active)
        top = torch.topk(logits.float(), 2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).cpu().numpy()
        for slot, rs in self._eng.scheduler.decoding.items():
            self.gaps[(rs.request.request_id, len(rs.tokens))] = \
                float(gap[slot])
        return nxt, logits


def near_ties(name, want, got, gaps, limit) -> list:
    """Each request whose spec tokens leave ``want`` (verifier-only
    decode) at token j: (request, j, the verifier's top-2 logit gap
    there); raises unless every gap is under ``limit``."""
    out = []
    for rid, a in want.items():
        b = got[rid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        gap = gaps.get((rid, j), float("inf"))   # j = 0 comes from prefill
        out.append((rid, j, gap))
        print(f"{name}: request {rid} leaves verifier-only decode at token "
              f"{j} ({b[j]} for {a[j]}); the verifier's top-2 logit gap "
              f"there is {gap:.4g}")
        if not gap < limit:
            raise AssertionError(
                f"{name}: request {rid} diverges at token {j}, where the "
                f"verifier's top-2 gap {gap:.4g} is not under {limit:.4g}")
    return out


def verify_vs_decode(dev, cfg, params, trace, ladder, spec) -> dict:
    """At full width, 8 slots decoding (the trace's first 8 prompts cut
    to 64 tokens): g+1 sequential dense decode steps on teacher-forced
    tokens against one verify over the same tokens from the same pool
    state.  Prints the logits' max abs error, the largest logit and the
    greedy tokens that differ (the two are different computations, equal
    up to rounding)."""
    from repro_torch.serving import Engine, EngineConfig

    eng = Engine(params, cfg, EngineConfig(spec=spec, **trace["ecfg"]),
                 device=dev, ladder=ladder)
    for p in trace["prompts"][:8]:
        eng.submit(p[:64], 64)
    while eng.scheduler.prefilling or eng.scheduler.has_queued():
        eng.step()
    g = spec.gamma
    tokens, positions, active = eng.decode_inputs()
    rng = np.random.default_rng(SEED + 11)
    teach = np.stack([tokens] + [rng.integers(0, cfg.vocab_size, len(tokens))
                                 for _ in range(g)], 1)        # (S, g+1)
    leaves = [e["self"][k] for grp in eng.pool.caches for e in grp
              for k in ("k", "v")]
    state = [t.clone() for t in leaves]
    seq = []
    for i in range(g + 1):
        _, logits = eng.decode_graphs(0, teach[:, i].copy(), positions + i,
                                      active)
        seq.append(logits.float().clone())
    for t, s0 in zip(leaves, state):
        t.copy_(s0)
    ver, vlog = eng.spec_decoder.verify_steps(
        g, torch.from_numpy(teach).to(dev), torch.from_numpy(positions).to(
            dev), torch.from_numpy(active).to(dev)[:, None].expand(-1, g + 1))
    seq = torch.stack(seq, 1)                               # (S, g+1, V)
    err = max_err(vlog.float(), seq)
    differ = int((ver != seq.argmax(-1)).sum())
    row = {"logits_max_abs_err": err,
           "logits_max_abs": float(seq.abs().max()),
           "greedy_tokens_differing": differ,
           "greedy_tokens": int(seq.shape[0] * seq.shape[1])}
    print(f"verify vs {g + 1} sequential decode steps, full width, "
          f"{cfg.dtype}, 8 slots: logits max abs err {err:.4g} (largest |logit| "
          f"{row['logits_max_abs']:.4g}); greedy tokens differing "
          f"{differ} of {row['greedy_tokens']}")
    del eng, state
    gc.collect()
    return row


# ---------------------------------------------------------------------------
# phase 12: the prefix cache
# ---------------------------------------------------------------------------

def prefix_trace(cfg) -> dict:
    """Phase 12's trace: a 256-token system prompt from SEED, 12 requests
    each the system prompt plus a unique suffix of 16, 32 or 64 tokens
    (chosen from the seed), 32 new tokens each, all arriving at once;
    before them one priming request (the system prompt plus a 64-token
    suffix outside the trace, 2 new tokens), run to completion."""
    rng = np.random.default_rng(SEED + 12)
    system = rng.integers(0, cfg.vocab_size, 256)
    suffix = [int(n) for n in rng.choice([16, 32, 64], 12)]
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, n)])
               for n in suffix]
    prime = np.concatenate([system, rng.integers(0, cfg.vocab_size, 64)])
    # the first request of each suffix length: its slot bytes are held
    watch = sorted({n: i for i, n in reversed(list(enumerate(suffix)))}
                   .values())
    if len(watch) != 3:
        raise AssertionError(f"suffix lengths {suffix} lack one of 16/32/64")
    return {"prompts": prompts, "prime": prime, "suffix": suffix,
            "watch": watch, "gen": 32,
            "ecfg": dict(max_slots=8, max_len=512, prefill_chunk=32,
                         prefill_dense_frac=1.0)}


def _pool_leaves(eng):
    return [e["self"][k] for grp in eng.pool.caches for e in grp
            for k in ("k", "v")]


def _slot_prefix(eng, slot: int, n: int) -> list:
    """Slot ``slot``'s K/V over positions [0, n), every leaf, cloned."""
    return [t[:, slot, ..., :n].clone() if i % 2 == 0
            else t[:, slot, :, :n].clone()
            for i, t in enumerate(_pool_leaves(eng))]


def _bytes_per_token(eng) -> int:
    """Bytes of one position of one slot across every cache leaf (4 KiB
    per layer of llama31_8b in bf16)."""
    return sum(t[:, 0].numel() // t.shape[-1 if i % 2 == 0 else -2]
               * t.element_size() for i, t in enumerate(_pool_leaves(eng)))


class SegmentTimer:
    """Wraps a pool's ``extract_prefix`` and ``write_prefix`` with CUDA
    events: per copy, its length in positions and its device ms (read
    after the run, so timing adds no host sync to the serving path)."""

    def __init__(self, pool):
        self.calls = {"extract": [], "write": []}
        for kind, attr in (("extract", "extract_prefix"),
                           ("write", "write_prefix")):
            setattr(pool, attr, self._wrap(kind, getattr(pool, attr)))

    def _wrap(self, kind, fn):
        def run(*args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args)
            e1.record()
            n = args[1] if kind == "extract" else \
                args[0][0][0]["self"]["k"].shape[-1]
            self.calls[kind].append((e0, e1, n))
            return out
        return run

    def summary(self, bytes_per_token: int) -> dict:
        torch.cuda.synchronize()
        out = {}
        for kind, calls in self.calls.items():
            ms = [a.elapsed_time(b) for a, b, _n in calls]
            gbs = [n * bytes_per_token / (t * 1e6)
                   for t, (_a, _b, n) in zip(ms, calls)]
            out[kind] = {"copies": len(calls),
                         "positions": [n for _a, _b, n in calls],
                         "ms_p50": float(np.median(ms)) if ms else None,
                         "gb_s_p50": float(np.median(gbs)) if gbs else None}
        return out


def record_prefills(eng, ids) -> dict:
    """Wrap ``eng._start_decode`` to keep the slot bytes [0, P) of the
    requests ``ids`` at the end of their prefill (before decode writes
    position P)."""
    got = {}
    start = eng._start_decode

    def wrapped(rs, first):
        rid = rs.request.request_id
        if rid in ids:
            got[rid] = _slot_prefix(eng, rs.slot, rs.request.prompt_len)
        start(rs, first)
    eng._start_decode = wrapped
    return got


def first_difference(a: list, b: list) -> str:
    """Where two lists of per-leaf tensors first part: leaf, index and
    the gap there."""
    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            d = (x.float() - y.float()).abs()
            j = np.unravel_index(int(d.argmax()), tuple(d.shape))
            return (f"leaf {i} ({'kv'[i % 2]}), index {tuple(int(v) for v in j)}"
                    f", max abs gap {float(d.max()):.4g}, "
                    f"{int((d > 0).sum())} elements differ")
    return "no difference"


def prefix_run(name, params, cfg, policy, sp, pt, dev, K, cache) -> dict:
    """One engine, the priming request, then the trace, with the kernels'
    launch counts zeroed just before the engine is built and read just
    after the run.  The trace's stats start after the priming request."""
    from repro_torch import obs
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.metrics import EngineStats

    K.reset_launch_counts()
    eng = Engine(params, cfg, EngineConfig(
        policy=policy, prefix_cache=cache, **pt["ecfg"]), sp, device=dev)
    ptrs = [t.data_ptr() for t in _pool_leaves(eng)]
    timer = SegmentTimer(eng.pool)
    eng.submit(pt["prime"], 2)
    eng.run()
    eng.stats = EngineStats()
    watched = record_prefills(eng, {1 + i for i in pt["watch"]})
    for p in pt["prompts"]:
        eng.submit(p, pt["gen"])
    t0 = obs.now()
    out, res = drive(eng, 0)
    torch.cuda.synchronize()
    res["wall_s"] = obs.now() - t0
    counts = dict(K.launch_counts)
    check_launches(name, eng, None, counts, res, cfg)
    tokens = {rid: out[rid] for rid in range(1, 1 + len(pt["prompts"]))}
    for rid, toks in tokens.items():
        if len(toks) != pt["gen"] or not all(0 <= t < cfg.vocab_size
                                             for t in toks):
            raise AssertionError(f"{name}: request {rid} gave {toks}")
    if [t.data_ptr() for t in _pool_leaves(eng)] != ptrs:
        raise AssertionError(f"{name}: a pool tensor moved")
    st = eng.stats
    res.update({
        "prefix_lookups": st.prefix_lookups, "prefix_hits": st.prefix_hits,
        "hit_rate": st.prefix_hits / max(1, st.prefix_lookups),
        "hit_len": [int(v) for v in st.prefix_hit_len],
        "prompt_tokens_saved": st.prefix_tokens_saved,
        "segments": timer.summary(_bytes_per_token(eng))})
    if cache:
        pc = eng.prefix_cache
        res["cached_tokens"] = pc.cached_tokens
        res["cached_segments"] = pc.num_segments
        res["builds_after_warmup"] = (eng.decode_retraces_after_warmup,
                                      eng.chunk_retraces_after_warmup)
        if res["builds_after_warmup"] != (0, 0):
            raise AssertionError(f"{name}: (decode, chunk) builds after "
                                 f"warmup {res['builds_after_warmup']}")
        if st.prefix_hits != len(pt["prompts"]) or min(res["hit_len"]) < 256:
            raise AssertionError(
                f"{name}: {st.prefix_hits} of {len(pt['prompts'])} requests "
                f"hit, matched lengths {res['hit_len']} (each must be >= 256)")
    res["tokens"] = tokens
    res["watched"] = watched
    del eng
    gc.collect()
    return res


def serve_prefix_cache(dev, K, cfg, params) -> dict:
    """Phase 12: cold dense, cache dense, cold ``pallas``, cache
    ``pallas`` on the shared-system-prompt trace."""
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.sparsity import SparsityPolicy

    pt = prefix_trace(cfg)
    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    modes = {"dense": (SparsityPolicy.dense(), None),
             "pallas": (SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
                        sp)}
    runs = {}
    for mode, cache in (("dense", False), ("dense", True),
                        ("pallas", False), ("pallas", True)):
        name = f"{'cache' if cache else 'cold'} {mode}"
        pol, s = modes[mode]
        runs[name] = prefix_run(name, params, cfg, pol, s, pt, dev, K, cache)
        r = runs[name]
        seg = r["segments"]
        print(f"prefix {name}: hit rate {r['hit_rate']:.3f}, matched "
              f"{r['hit_len']}, prompt tokens saved "
              f"{r['prompt_tokens_saved']}, prefill chunks "
              f"{r['prefill_chunks']}, chunk p50 "
              f"{r['prefill_chunk_p50_ms']:.2f} ms, TTFT p50 "
              f"{r['ttft_p50_ms']:.1f} ms, prefill {r['prefill_s']:.3f} s, "
              f"decode p50 {r['decode_step_p50_ms']:.2f} ms, run "
              f"{r['wall_s']:.3f} s, cached tokens "
              f"{r.get('cached_tokens')} in {r.get('cached_segments')} "
              f"segments; extract {seg['extract']['copies']} x "
              f"{seg['extract']['ms_p50']} ms p50 "
              f"({seg['extract']['gb_s_p50']} GB/s), write "
              f"{seg['write']['copies']} x {seg['write']['ms_p50']} ms p50 "
              f"({seg['write']['gb_s_p50']} GB/s)")
    if runs["cache dense"]["tokens"] != runs["cold dense"]["tokens"]:
        bad = [rid for rid, t in runs["cold dense"]["tokens"].items()
               if runs["cache dense"]["tokens"][rid] != t]
        raise AssertionError(f"cache dense: requests {bad} leave the cold "
                             "dense run's tokens")
    for mode in ("dense", "pallas"):
        cold, warm = runs[f"cold {mode}"], runs[f"cache {mode}"]
        for i in pt["watch"]:
            a, b = cold["watched"][1 + i], warm["watched"][1 + i]
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(
                    f"{mode}: request {1 + i} (suffix {pt['suffix'][i]}): "
                    "slot bytes over [0, P) after a hit differ from a cold "
                    f"prefill: {first_difference(a, b)}")
        print(f"prefix {mode}: slot bytes over [0, P) after a hit plus the "
              "suffix prefill are bit-equal to a cold prefill for suffixes "
              f"{[pt['suffix'][i] for i in pt['watch']]}")
    print(f"prefix dense: cache tokens equal cold tokens for all "
          f"{len(pt['prompts'])} requests; pallas runs held by slot bytes "
          "(the shared top-k depends on the batch)")
    for r in runs.values():
        del r["watched"]
    runs["trace"] = {"suffix": pt["suffix"], "system_prompt": 256,
                     "gen": pt["gen"], **pt["ecfg"]}
    return runs


# ---------------------------------------------------------------------------
# phase 13: preemption
# ---------------------------------------------------------------------------

class CallTimer:
    """Host ms of each call of one pool method, the card synced on both
    sides (suspend's device-to-host copy blocks; resume's copy does
    not)."""

    def __init__(self, pool, attr):
        from repro_torch import obs
        self.ms = []
        fn = getattr(pool, attr)

        def run(*args):
            torch.cuda.synchronize()
            t0 = obs.now()
            out = fn(*args)
            torch.cuda.synchronize()
            self.ms.append(1e3 * (obs.now() - t0))
            return out
        setattr(pool, attr, run)


def preempt_run(name, params, cfg, trace, inter, dev, preempt) -> dict:
    """8 best-effort requests (phase 5's first 8 prompts, 64 new tokens)
    driven until each holds 2 tokens, then 4 interactive requests (16
    new tokens), to the end."""
    from repro_torch import obs
    from repro_torch.serving import Engine, EngineConfig, SchedulerConfig
    from repro_torch.serving.metrics import percentile

    eng = Engine(params, cfg, EngineConfig(
        scheduler=SchedulerConfig(preemption=preempt),
        prefill_dense_frac=1.0, **trace["ecfg"]), device=dev)
    ptrs = [t.data_ptr() for t in _pool_leaves(eng)]
    sus, res_t = CallTimer(eng.pool, "suspend"), CallTimer(eng.pool, "resume")
    t0 = obs.now()
    be = [eng.submit(p, 64, priority="best-effort")
          for p in trace["prompts"][:8]]
    for _ in range(4096):
        if len(eng.scheduler.decoding) == 8 and all(len(rs.tokens) >= 2
                                                    for rs in be):
            break
        eng.step()
    else:
        raise AssertionError(f"{name}: the best-effort requests never all "
                             "reached 2 tokens")
    t_int = obs.now()
    ia = [eng.submit(p, 16, priority="interactive") for p in inter]
    out = eng.run()
    torch.cuda.synchronize()
    wall = obs.now() - t0
    if [t.data_ptr() for t in _pool_leaves(eng)] != ptrs:
        raise AssertionError(f"{name}: a pool tensor moved")
    st = eng.stats
    res = {
        "preemptions": st.preemptions, "resumes": st.resumes,
        "suspend_ms": sus.ms, "resume_ms": res_t.ms,
        "interactive_ttft_p50_ms": 1e3 * percentile(
            [rs.first_token_time - rs.request.arrival_time for rs in ia], 50),
        "best_effort_finish_s": [rs.finish_time - t_int for rs in be],
        "best_effort_last_finish_s": max(rs.finish_time for rs in be) - t_int,
        "interactive_last_finish_s": max(rs.finish_time
                                         for rs in ia) - t_int,
        "wall_s": wall, "decode_steps": st.decode_steps,
        "prefill_chunks": st.prefill_chunks}
    if preempt:
        res["builds_after_warmup"] = (eng.decode_retraces_after_warmup,
                                      eng.chunk_retraces_after_warmup)
        if res["builds_after_warmup"] != (0, 0):
            raise AssertionError(f"{name}: (decode, chunk) builds after "
                                 f"warmup {res['builds_after_warmup']}")
        if not st.preemptions == st.resumes >= 1:
            raise AssertionError(f"{name}: {st.preemptions} preemptions, "
                                 f"{st.resumes} resumes")
        res["direct"] = direct_suspend_resume(eng, sus, res_t)
    res["tokens"] = out
    del eng
    gc.collect()
    return res


def direct_suspend_resume(eng, sus, res_t, length: int = 300) -> dict:
    """On the idle engine: suspend a slot holding ``length`` positions of
    the run's K/V, resume it into another slot; the second slot's bytes
    over [0, length) must equal the first's."""
    pool = eng.pool
    a = pool.alloc()
    pool.lengths[a] = length
    seg = pool.suspend(a, eng.ecfg.prefill_chunk)
    b = pool.alloc()
    pool.resume(seg, b)
    torch.cuda.synchronize()
    x, y = _slot_prefix(eng, a, length), _slot_prefix(eng, b, length)
    if not all(torch.equal(u, v) for u, v in zip(x, y)):
        raise AssertionError("suspend -> resume into another slot changed "
                             f"the bytes: {first_difference(x, y)}")
    pool.free(a)
    pool.free(b)
    mb = seg.phys * _bytes_per_token(eng) / 1e6
    return {"length": length, "phys": seg.phys, "segment_mb": mb,
            "suspend_ms": sus.ms[-1], "resume_ms": res_t.ms[-1]}


def serve_preemption(dev, cfg, params, trace) -> dict:
    """Phase 13: the preempted run, then the same engine config and
    submit order without preemption."""
    rng = np.random.default_rng(SEED + 13)
    inter = [rng.integers(0, cfg.vocab_size, int(n))
             for n in rng.integers(32, 97, 4)]
    runs = {name: preempt_run(name, params, cfg, trace, inter, dev, pre)
            for name, pre in (("preempted", True), ("no preemption", False))}
    a, b = runs["preempted"], runs["no preemption"]
    if a["tokens"] != b["tokens"]:
        bad = {rid: next(j for j, (x, y) in enumerate(zip(t, a["tokens"][rid]))
                         if x != y)
               for rid, t in b["tokens"].items() if a["tokens"][rid] != t}
        raise AssertionError(f"preempted: requests leave the run without "
                             f"preemption at (request: token) {bad}")
    d = a["direct"]
    print(f"preemption: {a['preemptions']} preemptions, {a['resumes']} "
          f"resumes; suspend ms {[round(v, 3) for v in a['suspend_ms']]}, "
          f"resume ms {[round(v, 3) for v in a['resume_ms']]}; direct "
          f"suspend -> resume of {d['length']} positions ({d['phys']} "
          f"copied, {d['segment_mb']:.1f} MB): {d['suspend_ms']:.3f} / "
          f"{d['resume_ms']:.3f} ms, bytes bit-equal; interactive TTFT p50 "
          f"{a['interactive_ttft_p50_ms']:.1f} ms (without preemption "
          f"{b['interactive_ttft_p50_ms']:.1f}); best-effort last finish "
          f"{a['best_effort_last_finish_s']:.3f} s after the interactive "
          f"arrival ({b['best_effort_last_finish_s']:.3f} without); tokens "
          "equal in both runs")
    return runs


# ---------------------------------------------------------------------------
# phase 14: the HTTP gateway, metrics, spans and the event log
# ---------------------------------------------------------------------------

# a client waits at most this long for one response
HTTP_TIMEOUT_S = 120.0


def http_request(port: int, method: str, path: str, body=None) -> dict:
    """One request from a stdlib client on a raw socket (the gateway
    closes the connection after each response).  Returns the status,
    the headers, the body, and on the client clock the time of the first
    token event (``ttft_s``, streaming only) and of the last byte
    (``total_s``)."""
    from repro_torch import obs
    payload = b"" if body is None else json.dumps(body).encode()
    head = f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
    if body is not None:
        head += f"Content-Length: {len(payload)}\r\n"
    t0 = obs.now()
    ttft = None
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=HTTP_TIMEOUT_S) as sock:
        sock.sendall(head.encode() + b"\r\n" + payload)
        raw = b""
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            raw += chunk
            if ttft is None and b'"token"' in raw:
                ttft = obs.now() - t0
    total = obs.now() - t0
    head_b, _, rest = raw.partition(b"\r\n\r\n")
    lines = head_b.decode("latin-1").split("\r\n")
    headers = dict(ln.split(": ", 1) for ln in lines[1:])
    return {"status": int(lines[0].split()[1]), "headers": headers,
            "body": rest, "ttft_s": ttft, "total_s": total}


def generated_tokens(resp: dict, stream: bool) -> list:
    """The tokens of a 200 answer to ``POST /v1/generate``."""
    if not stream:
        return json.loads(resp["body"])["tokens"]
    out, buf = b"", resp["body"]
    while buf:
        size, _, buf = buf.partition(b"\r\n")
        n = int(size, 16)
        if n == 0:
            break
        out += buf[:n]
        buf = buf[n + 2:]
    events = [e[len("data: "):] for e in out.decode().split("\n\n") if e]
    if events[-1] != "[DONE]" or not json.loads(events[-2]).get("done"):
        raise AssertionError(f"SSE stream ends with {events[-2:]}")
    return [json.loads(e)["token"] for e in events[:-2]]


def burst(port: int, bodies: list) -> list:
    """POST every body at once, one client thread each -> responses in
    order.  A client that gets no answer within ``HTTP_TIMEOUT_S``
    fails."""
    out = [None] * len(bodies)
    errors = []

    def one(i):
        try:
            out[i] = http_request(port, "POST", "/v1/generate", bodies[i])
        except Exception as e:                      # noqa: BLE001
            errors.append((i, repr(e)))
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HTTP_TIMEOUT_S + 5)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"HTTP clients failed or timed out: {errors}")
    return out


class Scraper:
    """A thread that GETs ``/metrics`` every ``every_s`` seconds: every
    scrape must pass ``validate_exposition`` and no counter may fall
    between two scrapes."""

    def __init__(self, port: int, every_s: float = 0.05):
        self.port, self.every_s = port, every_s
        self.scrapes, self.errors = 0, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="scraper")
        self._thread.start()

    def _run(self):
        from repro_torch import obs
        last = {}
        while not self._stop.wait(self.every_s):
            try:
                r = http_request(self.port, "GET", "/metrics")
                text = r["body"].decode()
                if r["status"] != 200:
                    raise AssertionError(f"/metrics answered {r['status']}")
                obs.validate_exposition(text)
                types, samples = obs.parse_exposition(text)
                now = {n: v for n, _lb, v in samples
                       if types.get(n) == "counter"}
                fell = [k for k in now if now[k] < last.get(k, 0.0)]
                if fell:
                    raise AssertionError(f"counters fell: {fell}")
                last = now
                self.scrapes += 1
            except Exception as e:                  # noqa: BLE001
                self.errors.append(repr(e))

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(HTTP_TIMEOUT_S)
        if self.errors or self.scrapes == 0:
            raise AssertionError(f"/metrics scraper: {self.scrapes} good "
                                 f"scrapes, errors {self.errors[:3]}")


def ring_numbers(eng) -> dict:
    """Decode tok/s (tokens of decode steps over their time) and decode
    p50 ms from the engine's rings, as ``drive`` reports them."""
    from repro_torch.serving.metrics import percentile
    st = eng.stats
    first = sum(1 for rs in eng.states.values() if rs.tokens)
    return {"decode_tok_s": (st.decode_tokens - first) / st.decode_time,
            "decode_step_p50_ms": 1e3 * percentile(st.decode_step_s, 50),
            "decode_steps": st.decode_steps,
            "prefill_chunks": st.prefill_chunks}


def gateway_run(name, eng, trace, scrape: bool, stream_every: int = 2
                ) -> dict:
    """Serve the trace's prompts through a ``Gateway`` over ``eng`` (a
    warmed engine), all at once over HTTP, every ``stream_every``-th
    request streaming (SSE) and the others JSON; optionally with a
    ``/metrics`` scraper.  Returns the tokens per prompt, the HTTP TTFT
    of the streaming requests (client clock) and the ring numbers."""
    from repro_torch.serving import Gateway
    from repro_torch.serving.metrics import percentile
    gw = Gateway(eng, port=0)
    port = gw.start()
    scraper = Scraper(port) if scrape else None
    bodies = [{"prompt": [int(t) for t in p], "max_new_tokens": trace["gen"],
               "stream": i % stream_every == 0}
              for i, p in enumerate(trace["prompts"])]
    try:
        resps = burst(port, bodies)
    finally:
        if scraper is not None:
            scraper.stop()
        gw.stop()
    bad = [(i, r["status"]) for i, r in enumerate(resps)
           if r["status"] != 200]
    if bad:
        raise AssertionError(f"{name}: answers other than 200: {bad}")
    tokens = {i: generated_tokens(r, b["stream"])
              for i, (r, b) in enumerate(zip(resps, bodies))}
    ttft = [r["ttft_s"] for r, b in zip(resps, bodies) if b["stream"]]
    # the same requests' TTFT on the engine clock (from the engine
    # thread's submit), found by prompt
    by_prompt = {tuple(rs.request.prompt.tolist()): rs
                 for rs in eng.states.values()}
    engine_ttft = [rs.first_token_time - rs.request.arrival_time
                   for rs in (by_prompt[tuple(b["prompt"])]
                              for b in bodies if b["stream"])]
    res = {"tokens": tokens, "http_ttft_p50_ms": 1e3 * percentile(ttft, 50),
           "engine_ttft_p50_ms": 1e3 * percentile(engine_ttft, 50),
           "streams": len(ttft), "scrapes": scraper.scrapes if scrape else 0,
           **ring_numbers(eng)}
    print(f"gateway {name}: {_fmt(res)}")
    return res


def direct_run(eng, trace) -> dict:
    """The trace submitted at once to ``eng`` (idle, warmed), run to the
    end: its tokens, run time, the streaming half's TTFT p50 (engine
    clock; the requests ``gateway_run`` streams) and the ring numbers,
    on fresh request ids and stats."""
    from repro_torch import obs
    from repro_torch.serving.metrics import EngineStats, percentile
    eng.reset_ids()
    eng.stats = EngineStats()
    for p in trace["prompts"]:
        eng.submit(p, trace["gen"])
    t0 = obs.now()
    tokens = eng.run()
    torch.cuda.synchronize()
    wall = obs.now() - t0
    ttft = [eng.states[i].first_token_time
            - eng.states[i].request.arrival_time
            for i in range(0, len(trace["prompts"]), 2)]
    return {"tokens": dict(tokens), "run_s": wall,
            "ttft_p50_ms": 1e3 * percentile(ttft, 50), **ring_numbers(eng)}


def serve_gateway(dev, K, cfg, params, trace, ladder) -> dict:
    """Phase 14: the dense engine of phase 5 served directly, through a
    gateway with full telemetry and a scraper, and through a gateway
    with ``NULL_TELEMETRY``; phase 8's ladder under its SLO controller
    through a gateway, with a ``ProfilerSession`` window over 8 of its
    decode steps; and a burst of 12 into a queue bounded at 2 (429s).
    ``serve --gateway`` drained by SIGTERM (:func:`drain_subprocess`)
    runs later, in :func:`serve_clis`."""
    from repro_torch import obs
    from repro_torch.serving import Engine, EngineConfig, SLOConfig

    t_phase = obs.now()
    crashed = []
    hook = threading.excepthook

    def record(args):
        crashed.append(f"{args.thread.name}: {args.exc_type.__name__}: "
                       f"{args.exc_value}")
        hook(args)
    threading.excepthook = record
    out_dir = os.path.join(HERE, "build", "chip_smoke", "gateway")
    os.makedirs(out_dir, exist_ok=True)
    try:
        res = {}
        ecfg = EngineConfig(**trace["ecfg"])

        # -- dense: direct runs without and with Telemetry.full() (no
        # sinks), two each in the order bare, full, full, bare,
        # then through a gateway with full telemetry + scraper and a
        # bare gateway
        engines = {"bare": Engine(params, cfg, ecfg, device=dev),
                   "full": Engine(params, cfg, ecfg, device=dev,
                                  telemetry=obs.Telemetry.full())}
        direct, runs = None, {"bare": [], "full": []}
        for kind in ("bare", "full", "full", "bare"):
            eng = engines[kind]
            eng.warmup()
            r = direct_run(eng, trace)
            if direct is None:
                direct = r.pop("tokens")
            elif r.pop("tokens") != direct:
                raise AssertionError(f"direct {kind}: tokens differ")
            runs[kind].append(r)
            print(f"gateway direct run, {kind} telemetry: {_fmt(r)}")
        res["direct"] = runs
        del engines, eng
        trace_path = os.path.join(out_dir, "dense_trace.json")
        events_path = os.path.join(out_dir, "dense_events.jsonl")
        for p in (trace_path, events_path):
            if os.path.exists(p):
                os.remove(p)
        tel = obs.Telemetry.full(events_sink=events_path)
        tel.trace_sink = trace_path
        eng = Engine(params, cfg, ecfg, device=dev, telemetry=tel)
        eng.warmup()
        r = gateway_run("dense, full telemetry + scraper", eng, trace, True)
        if r.pop("tokens") != direct:
            raise AssertionError("dense through the gateway: tokens differ "
                                 "from the direct run")
        if (eng.decode_retraces_after_warmup,
                eng.chunk_retraces_after_warmup) != (0, 0):
            raise AssertionError("dense through the gateway: a step was "
                                 "built after warmup")
        with open(trace_path) as f:
            doc = json.load(f)
        obs.validate_chrome_trace(doc)
        for kind in ("submit", "finish"):
            got = sorted(e["tid"] for e in doc["traceEvents"]
                         if e["name"] == kind and e["ph"] == "i")
            if got != [i + 1 for i in range(len(trace["prompts"]))]:
                raise AssertionError(f"trace: {kind} instants on tracks "
                                     f"{got}, want one per request")
        with open(events_path) as f:
            logged = [json.loads(ln) for ln in f]
        late = [e for e in logged
                if e["kind"] == "compile" and e["after_warmup"]]
        if late or not logged:
            raise AssertionError(f"event log: {len(logged)} events, "
                                 f"builds after warmup {late}")
        r.update(trace_events=len(doc["traceEvents"]), logged=len(logged))
        res["telemetry"] = r
        del eng
        eng = Engine(params, cfg, ecfg, device=dev)
        eng.warmup()
        r = gateway_run("dense, NULL_TELEMETRY, no scraper", eng, trace,
                        False)
        if r.pop("tokens") != direct:
            raise AssertionError("dense through the bare gateway: tokens "
                                 "differ from the direct run")
        res["bare"] = r
        del eng
        gc.collect()

        # -- pallas: the calibrated ladder under phase 8's controller
        slo = SLOConfig(**PHASE8_SLO)
        K.reset_launch_counts()
        eng = Engine(params, cfg, EngineConfig(slo=slo, **trace["ecfg"]),
                     device=dev, ladder=ladder)
        prof = obs.ProfilerSession(os.path.join(out_dir, "profile"))
        served = {}

        def serve():
            try:
                served["res"] = gateway_run(
                    "pallas ladder under the SLO controller", eng, trace,
                    False)
            except BaseException as e:              # noqa: BLE001
                served["error"] = e
        clients = threading.Thread(target=serve, name="clients")
        clients.start()
        # the profiler starts and stops on this (the main) thread, over 8
        # decode steps at a sparse rung replayed by the engine thread;
        # the counters read here are Python ints
        window, tick = {}, threading.Event()
        while eng.stats.decode_steps < 1 or eng.rung == 0:
            if not clients.is_alive():
                break
            tick.wait(0.0005)
        else:
            first = eng.stats.decode_steps
            window["started"] = prof.start()
            while eng.stats.decode_steps < first + WINDOW \
                    and clients.is_alive():
                tick.wait(0.0005)
            window["stopped"] = prof.stop()
            window["steps"] = eng.stats.decode_steps - first
        clients.join(HTTP_TIMEOUT_S + 10)
        if "error" in served:
            raise served["error"]
        r = served["res"]
        counts = dict(K.launch_counts)
        r["prefill_sparse_chunks"] = eng.stats.prefill_sparse_chunks
        check_launches("pallas gateway", eng, ladder, counts, r, cfg)
        if any(len(t) != trace["gen"] for t in r.pop("tokens").values()):
            raise AssertionError("pallas gateway: a request came back short")
        if eng.decode_retraces_after_warmup != 0:
            raise AssertionError("pallas gateway: decode built after warmup")
        r["transitions"] = list(eng.controller.transitions)
        if not window.get("started") or not window.get("stopped"):
            raise AssertionError(f"profiler window {window}: "
                                 f"error {prof.error}")
        with open(prof.trace_path) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"]
        seen = {k: sum(1 for n in names if k in n)
                for k in ("score_select", "sparse_matmul_shared")}
        if not all(seen.values()):
            raise AssertionError(f"profiler trace {prof.trace_path}: kernel "
                                 f"launches {seen} of {len(names)}")
        r["profile"] = {"decode_steps": window["steps"],
                        "kernels": len(names), **seen}
        res["pallas"] = r
        print(f"gateway pallas: transitions {r['transitions']}; launches "
              f"{r['launches']}; profiler window over {window['steps']} "
              f"decode steps holds {seen} of {len(names)} kernels")
        del eng
        gc.collect()

        # -- backpressure: a burst of 12 into a queue bounded at 2
        from repro_torch.serving import Gateway, SchedulerConfig
        eng = Engine(params, cfg, EngineConfig(
            scheduler=SchedulerConfig(max_queue=2), **trace["ecfg"]),
            device=dev)
        gw = Gateway(eng, port=0)
        port = gw.start()
        try:
            resps = burst(port, [{"prompt": [int(t) for t in p],
                                  "max_new_tokens": 8}
                                 for p in trace["prompts"]])
        finally:
            gw.stop()
        codes = [x["status"] for x in resps]
        n429 = codes.count(429)
        retry = [int(x["headers"]["Retry-After"]) for x in resps
                 if x["status"] == 429]
        if not 0 < n429 < len(codes) or set(codes) != {200, 429} \
                or min(retry) < 1 or eng.stats.rejected != n429:
            raise AssertionError(f"backpressure: codes {codes}, Retry-After "
                                 f"{retry}, rejected {eng.stats.rejected}")
        res["backpressure"] = {"200": codes.count(200), "429": n429,
                               "retry_after_s": retry}
        print(f"gateway backpressure: {codes.count(200)} x 200, {n429} x 429 "
              f"(Retry-After {sorted(set(retry))} s), engine rejected "
              f"{eng.stats.rejected}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        threading.excepthook = hook
    if crashed:
        raise AssertionError(f"exceptions on threads: {crashed}")
    res["wall_s"] = obs.now() - t_phase
    # the direct run beside the gateway's is the last bare one (the
    # first run of a process pays first-use costs)
    d, t, b = res["direct"]["bare"][-1], res["telemetry"], res["bare"]
    p50 = {k: [r["decode_step_p50_ms"] for r in v]
           for k, v in res["direct"].items()}
    print(f"gateway: HTTP TTFT p50 {t['http_ttft_p50_ms']:.1f} ms with "
          f"full telemetry + {t['scrapes']} scrapes (engine clock "
          f"{t['engine_ttft_p50_ms']:.1f}), {b['http_ttft_p50_ms']:.1f} ms "
          f"bare (engine clock {b['engine_ttft_p50_ms']:.1f}), direct run "
          f"{d['ttft_p50_ms']:.1f} ms (the same {t['streams']} prompts); "
          f"decode tok/s {t['decode_tok_s']:.1f} / {b['decode_tok_s']:.1f} "
          f"/ {d['decode_tok_s']:.1f}; decode p50 "
          f"{t['decode_step_p50_ms']:.2f} / {b['decode_step_p50_ms']:.2f} / "
          f"{d['decode_step_p50_ms']:.2f} ms (gateway + telemetry + scraper "
          f"/ bare gateway / direct); direct decode p50 bare "
          f"{[round(v, 2) for v in p50['bare']]} ms (median "
          f"{np.median(p50['bare']):.2f}), full telemetry "
          f"{[round(v, 2) for v in p50['full']]} ms (median "
          f"{np.median(p50['full']):.2f}); tokens equal; phase 14 took "
          f"{res['wall_s']:.1f} s")
    return res


def gateway_port(proc) -> int:
    """The port that ``serve --gateway`` running in ``proc`` prints on its
    stdout; the process is killed if it prints none within
    HTTP_TIMEOUT_S."""
    timer = threading.Timer(HTTP_TIMEOUT_S, proc.kill)
    timer.start()
    try:
        for line in proc.stdout:
            if line.startswith("gateway listening on http://"):
                return int(line.split()[3].rsplit(":", 1)[1])
    finally:
        timer.cancel()
    raise AssertionError("serve --gateway never printed its port")


def drain_subprocess(out_dir: str, dev) -> dict:
    """``python -m repro_torch.launch.serve --gateway --reduced`` on the
    card in a subprocess: one streaming request, SIGTERM while it is in
    flight; the request must finish, the process exit 0, and its
    ``--trace-out`` and ``--events-out`` files be complete."""
    from repro_torch import obs
    trace = os.path.join(out_dir, "drain_trace.json")
    events = os.path.join(out_dir, "drain_events.jsonl")
    for p in (trace, events):
        if os.path.exists(p):
            os.remove(p)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = obs.now()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", dev.type, "--sparsity", "0", "--gateway", "--gateway-port", "0",
         "--max-slots", "2", "--prompt-len", "16", "--gen", "48",
         "--trace-out", trace, "--events-out", events],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=HERE)
    try:
        port = gateway_port(proc)
        payload = json.dumps({"prompt": list(range(1, 17)),
                              "max_new_tokens": 48, "stream": True}).encode()
        with socket.create_connection(("127.0.0.1", port),
                                      timeout=HTTP_TIMEOUT_S) as sock:
            sock.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Length: " + str(len(payload)).encode()
                         + b"\r\n\r\n" + payload)
            raw = b""
            while b'"token"' not in raw:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                raw += chunk
            proc.send_signal(signal.SIGTERM)
            in_flight = raw.count(b'"token"')
            while True:
                chunk = sock.recv(65536)
                if not chunk:
                    break
                raw += chunk
        rest = proc.communicate(timeout=HTTP_TIMEOUT_S)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"serve --gateway exited {proc.returncode}:\n"
                             f"{rest[-2000:]}")
    _, _, body = raw.partition(b"\r\n\r\n")
    toks = generated_tokens({"body": body}, True)
    if len(toks) != 48:
        raise AssertionError(f"drain: the in-flight request got {len(toks)} "
                             "of 48 tokens")
    with open(trace) as f:
        n_trace = obs.validate_chrome_trace(json.load(f))
    with open(events) as f:
        n_events = len([json.loads(ln) for ln in f])
    out = {"tokens_before_sigterm": in_flight, "tokens": len(toks),
           "exit": proc.returncode, "trace_events": n_trace,
           "logged": n_events, "wall_s": obs.now() - t0}
    print(f"gateway drain: SIGTERM after {in_flight} streamed tokens, the "
          f"request finished with {len(toks)}, exit 0, trace "
          f"{n_trace} events, event log {n_events} lines, "
          f"{out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: the quality monitor and the flight recorder
# ---------------------------------------------------------------------------

# the monitor of the probed run: every decode step probed, a recon pass on
# every 4th probe over a 16-token window
QUALITY = dict(probe_rate=1.0, recon_every=4, recon_window=16)
# the largest |verify - decode| of one state's bf16 logits at full width
# (this script's phase 11 on an NVIDIA H100 80GB HBM3 at 700 W): a rung-0
# probe may name another token than the served decode only where the
# decode's top-2 gap is under twice the probe's own distance from it,
# and that distance stays under twice this
VERIFY_DECODE_BF16 = 0.26


def _timed(obj, attr: str, sync: bool = False) -> list:
    """Replace the bound method ``obj.attr`` by one that keeps each
    call's host ms (after a device sync when ``sync``); returns the
    list."""
    from repro_torch import obs
    fn = getattr(obj, attr)
    ms = []

    def run(*args, **kw):
        t0 = obs.now()
        out = fn(*args, **kw)
        if sync:
            torch.cuda.synchronize()
        ms.append(1e3 * (obs.now() - t0))
        return out
    setattr(obj, attr, run)
    return ms


class ProbeTies:
    """Wraps a monitor's ``observe``: at rung 0 (the probe's own dense
    policy, decode against a window-1 verify) it keeps, per active slot,
    the probe's argmax, the served token, the served logits' top-2 gap
    and the largest |probe - decode| logit difference (one extra device
    reduction and host read per probe: the near-tie check only)."""

    def __init__(self, q):
        self.fn = q.observe
        self.want, self.got, self.gaps, self.err = {}, {}, {}, 0.0
        self.limits = {}
        self.n = 0
        q.observe = self

    def __call__(self, engine, probe, logits, nxt, active, t):
        if engine.rung == 0:
            pl, sl = probe.float(), logits.float()
            diff = (pl - sl).abs().amax(-1).cpu().numpy()
            top = torch.topk(sl, 2, dim=-1).values
            gap = (top[:, 0] - top[:, 1]).cpu().numpy()
            pa = pl.argmax(-1).cpu().numpy()
            for slot in np.nonzero(np.asarray(active) > 0)[0]:
                key = f"probe {self.n} slot {slot}"
                self.want[key] = [int(pa[slot])]
                self.got[key] = [int(nxt[slot])]
                self.gaps[(key, 0)] = float(gap[slot])
                self.limits[key] = 2.0 * float(diff[slot])
                self.err = max(self.err, float(diff[slot]))
        self.n += 1
        return self.fn(engine, probe, logits, nxt, active, t)


def quality_run(name, params, cfg, trace, ladder, dev, K, monitor) -> dict:
    """Phase 5's trace on the calibrated ladder under phase 8's SLO, with
    or without a ``QualityMonitor(**QUALITY)``; launch counts zeroed
    just before the engine is built and read just after the run."""
    from repro_torch import obs
    from repro_torch.serving import Engine, EngineConfig, SLOConfig
    from repro_torch.serving.metrics import percentile

    K.reset_launch_counts()
    q = obs.QualityMonitor(**QUALITY) if monitor else None
    eng = Engine(params, cfg, EngineConfig(slo=SLOConfig(**PHASE8_SLO),
                                           **trace["ecfg"]),
                 device=dev, ladder=ladder,
                 telemetry=obs.Telemetry(quality=q) if monitor else None)
    ms, ties = {}, None
    if q is not None:
        ms = {"probe": _timed(q, "run_probe"),        # waits for the probe
              "observe": _timed(q, "observe"),
              "recon": _timed(q, "_recon_pass", sync=True)}
        ties = ProbeTies(q)
    for p in trace["prompts"]:
        eng.submit(p, trace["gen"])
    t0 = obs.now()
    out = eng.run()
    torch.cuda.synchronize()
    st = eng.stats
    res = {"run_s": obs.now() - t0, "tokens": out,
           "token_rungs": {r: list(rs.token_rungs)
                           for r, rs in eng.states.items()},
           "transitions": list(eng.controller.transitions),
           "decode_steps": st.decode_steps,
           "decode_step_p50_ms": 1e3 * percentile(st.decode_step_s, 50),
           "prefill_sparse_chunks": st.prefill_sparse_chunks}
    counts = dict(K.launch_counts)
    check_launches(name, eng, ladder, counts, res, cfg)
    builds = {"decode": eng.decode_retraces_after_warmup,
              "chunk": eng.chunk_retraces_after_warmup,
              "probe": eng.probe_retraces_after_warmup}
    if any(v not in (0, None) for v in builds.values()):
        raise AssertionError(f"{name}: builds after warmup {builds}")
    res["builds_after_warmup"] = builds
    if q is not None:
        zero = dict.fromkeys(K.launch_counts, 0)
        for steps in q.steps():
            if steps.builds != 1 or steps.captured != [zero]:
                raise AssertionError(
                    f"{name}: {type(steps).__name__} built "
                    f"{steps.builds} times, captured {steps.captured}")
        if not q.probes == st.decode_steps == q.probe_steps.steps[0]:
            raise AssertionError(
                f"{name}: {q.probes} probes ({q.probe_steps.steps[0]} "
                f"replays) for {st.decode_steps} decode steps")
        if not q.recon_passes == q.recon_steps.steps[0] > 0:
            raise AssertionError(f"{name}: {q.recon_passes} recon passes")
        util = q.decode_utilization(st.decode_step_hist.mean)
        if not all(0 < u <= 1.05 for u in util.values()):
            raise AssertionError(f"{name}: decode utilization {util}: the "
                                 "step-cost count is wrong")
        text = eng.metrics_exposition()
        obs.validate_exposition(text)
        if "repro_quality_decode_utilization_rung0" not in text:
            raise AssertionError(f"{name}: exposition lacks the quality "
                                 "rows")
        near = near_ties(f"{name} rung-0 probe", ties.want, ties.got,
                         ties.gaps, 2.0 * ties.err) if ties.want else []
        for key, _j, gap in near:
            if not gap < ties.limits[key]:
                raise AssertionError(
                    f"{name}: {key}: the probe's token differs where the "
                    f"decode's top-2 gap {gap:.4g} is not under twice its "
                    f"distance from the probe ({ties.limits[key]:.4g})")
        if ties.err >= 2 * VERIFY_DECODE_BF16:
            raise AssertionError(
                f"{name}: rung-0 probe and decode logits differ by up to "
                f"{ties.err:.4g}")
        per_rung = {}
        for r in range(eng.num_rungs):
            a, o, e = (q.agreement_hists[r], q.overlap_hists[r],
                       q.recon_hists[r])
            per_rung[r] = {
                "probes": a.count,
                "agreement": a.sum / a.count if a.count else None,
                "topk_overlap": o.sum / o.count if o.count else None,
                "recon_mean": e.sum / e.count if e.count else None,
                "recon_baseline": q.recon_baseline_mean(r),
                "decode_utilization": util.get(r),
                "roofline_decode_gflop": q.roofline[("decode", r)]["flops"]
                / 1e9,
                "roofline_decode_gb": q.roofline[("decode", r)]["bytes"]
                / 1e9}
        # device time of one probe and one recon replay (CUDA events,
        # after the run: replays of the captured graphs on their last
        # inputs, writing only positions no request reads any more)
        dev_ms = {}
        for kind, steps in (("probe", q.probe_steps),
                            ("recon", q.recon_steps)):
            graph = steps._graphs[0][0]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            graph.replay()
            start.record()
            for _ in range(10):
                graph.replay()
            end.record()
            torch.cuda.synchronize()
            dev_ms[kind] = start.elapsed_time(end) / 10
        res.update({
            "per_rung": per_rung, "probes": q.probes,
            "recon_passes": q.recon_passes,
            "rung0_probe_disagreements": len(near),
            "rung0_probe_max_abs_logit_diff": ties.err,
            "probe_host_ms_p50": percentile(ms["probe"], 50),
            "observe_host_ms_p50": percentile(ms["observe"], 50),
            "recon_host_ms_p50": percentile(ms["recon"], 50),
            "probe_device_ms": dev_ms["probe"],
            "recon_device_ms": dev_ms["recon"],
            "snapshot": {k: v for k, v in eng.snapshot().items()
                         if k.startswith("quality_")}})
    del eng
    gc.collect()
    return res


def forced_drift(params, cfg, trace, ladder, dev) -> dict:
    """Rung 1 of the ladder under ``SLOConfig(quality_aware=True)``
    (phase 8's SLO otherwise, queue bound 8 so the 4 requests never
    queue), with every recon pass's block ``BLOCK`` re-baselined to the
    32 channels that score lowest on the first prompt's window:
    a ``saliency_drift`` event naming (``BLOCK``, rung 1) must fire, the
    pressure rise above 0, and the controller step down to rung 0 with
    reason ``quality``."""
    from repro_torch import obs
    from repro_torch.obs.quality import saliency_channels, unstack_sp
    from repro_torch.serving import Engine, EngineConfig, SLOConfig

    block = 5
    q = obs.QualityMonitor(probe_rate=1.0, recon_every=1, recon_window=16)
    ev = obs.EventLog(capacity=1024)
    slo = SLOConfig(**dict(PHASE8_SLO, max_queue=8, quality_aware=True))
    eng = Engine(params, cfg, EngineConfig(slo=slo, initial_rung=1,
                                           **trace["ecfg"]),
                 device=dev, ladder=ladder,
                 telemetry=obs.Telemetry(quality=q, events=ev))
    window = np.asarray(trace["prompts"][0][-16:], np.int64).reshape(1, 16)
    _errs, feats = q.recon_steps(window, eng._rung_sp[1])
    feats = feats.float().cpu().numpy()
    g, alpha = q._g_alpha[1][block]
    k = q.cfg.saliency_topk
    lowest = np.argsort(feats[block] * np.maximum(g, 1e-12) ** alpha)[:k]
    if np.intersect1d(lowest, saliency_channels(feats[block], g, alpha,
                                                k)).size:
        raise AssertionError("forced drift: the lowest channels overlap "
                             "the live set")
    q.seed_reference(1, block, lowest)
    pressure = []
    update = q._update_pressure

    def track(rung):
        update(rung)
        pressure.append((rung, q.pressure))
    q._update_pressure = track
    for p in trace["prompts"][:4]:
        eng.submit(p, 16)
    eng.run()
    drift = [e for e in ev.events("saliency_drift")
             if e["block"] == block and e["rung"] == 1]
    quality = [t for t in eng.controller.transitions if t[3] == "quality"]
    if len(drift) != 1 or not any(r == 1 and v > 0 for r, v in pressure):
        raise AssertionError(f"forced drift: events {drift}, pressure "
                             f"{pressure[:8]}")
    if not quality or quality[0][1:3] != (1, 0):
        raise AssertionError(f"quality_aware: transitions "
                             f"{eng.controller.transitions}")
    if eng.probe_retraces_after_warmup != 0:
        raise AssertionError("forced drift: a quality step was built after "
                             "warmup")
    res = {"drift_event": {k: drift[0][k] for k in ("block", "rung",
                                                     "overlap")},
           "drift_events": q.drift_events,
           "max_pressure_rung1": max(v for r, v in pressure if r == 1),
           "transitions": list(eng.controller.transitions),
           "quality_deescalations": eng.controller.quality_deescalations}
    del eng
    gc.collect()
    return res


def record_and_replay(params, cfg, trace, ladder, dev, out_dir) -> dict:
    """The ladder under phase 8's SLO with preemption, recorded into a
    JSONL sink: phase 5's first 11 prompts best-effort (64 new tokens,
    as in phase 13; 3 queue, so the controller escalates), driven until 8 decode with 2
    tokens each, then its last prompt and the first three's first 64
    tokens interactive (16 new tokens), which preempt.  The
    recording replays into a fresh engine over the same params (no
    second copy of the weights): ``ReplayReport.ok``, every token,
    rung and decision equal, nothing built after warmup."""
    from repro_torch import obs
    from repro_torch.obs.flight import params_fingerprint, replay
    from repro_torch.serving import (Engine, EngineConfig, SchedulerConfig,
                                     SLOConfig)

    t0 = obs.now()
    fp = params_fingerprint(params)
    fp_s = obs.now() - t0
    t0 = obs.now()
    params_fingerprint(params)
    fp_again_s = obs.now() - t0
    sink = os.path.join(out_dir, "ladder_flight.jsonl")
    ecfg = EngineConfig(slo=SLOConfig(**PHASE8_SLO),
                        scheduler=SchedulerConfig(preemption=True),
                        **trace["ecfg"])
    fr = obs.FlightRecorder(sink=sink, capacity=1 << 16)
    t0 = obs.now()
    with Engine(params, cfg, ecfg, device=dev, ladder=ladder,
                telemetry=obs.Telemetry(flight=fr)) as eng:
        prompts = trace["prompts"]
        for p in prompts[:11]:
            eng.submit(p, 64, priority="best-effort")
        decoding = eng.scheduler.decoding
        for _ in range(4096):
            if len(decoding) == 8 and all(len(rs.tokens) >= 2
                                          for rs in decoding.values()):
                break
            eng.step()
        else:
            raise AssertionError("recording: 8 best-effort requests never "
                                 "decoded at once")
        for p in [prompts[11]] + [q[:64] for q in prompts[:3]]:
            eng.submit(p, 16, priority="interactive")
        eng.run()
        record_s = obs.now() - t0
        tokens = {r: list(rs.tokens) for r, rs in eng.states.items()}
    decisions = fr.records("decision")
    kinds = {r["kind"] for r in decisions}
    if not {"rung_switch", "preempt", "resume"} <= kinds:
        raise AssertionError(f"recording: decisions {sorted(kinds)}")
    del eng
    gc.collect()
    t0 = obs.now()
    report = replay.replay(sink, engine_factory=lambda clock, tel: Engine(
        params, cfg, ecfg, device=dev, ladder=ladder, telemetry=tel,
        clock=clock))
    replay_s = obs.now() - t0
    if not report.ok or report.requests != len(tokens) or any(
            report.retraces.values()):
        raise AssertionError(f"replay: {report.to_dict()}")
    finishes = {r["request"]: r["tokens"] for r in fr.records("finish")}
    if finishes != tokens:
        raise AssertionError("recording: finish records differ from the "
                             "served tokens")
    res = {"records": fr.count, "decisions": len(decisions),
           "decision_kinds": sorted(kinds), "requests": report.requests,
           "tokens": report.tokens, "record_s": record_s,
           "replay_s": replay_s, "params_fingerprint": fp,
           "fingerprint_s": fp_s, "fingerprint_again_s": fp_again_s,
           "retraces": report.retraces}
    return res


def flight_gateway(params, cfg, trace, ladder, dev) -> dict:
    """The ladder behind a gateway with a flight recorder: one request,
    then ``GET /v1/debug/flight`` returns the whole ring (header, the
    submission, clock reads, the finish with the served tokens)."""
    from repro_torch import obs
    from repro_torch.serving import Engine, EngineConfig, Gateway, SLOConfig

    fr = obs.FlightRecorder()
    eng = Engine(params, cfg, EngineConfig(slo=SLOConfig(**PHASE8_SLO),
                                           **trace["ecfg"]),
                 device=dev, ladder=ladder,
                 telemetry=obs.Telemetry(flight=fr))
    gw = Gateway(eng, port=0)
    port = gw.start()
    try:
        body = {"prompt": [int(t) for t in trace["prompts"][0]],
                "max_new_tokens": 8}
        gen = http_request(port, "POST", "/v1/generate", body)
        got = http_request(port, "GET", "/v1/debug/flight")
    finally:
        gw.stop()
    snap = json.loads(got["body"])
    toks = generated_tokens(gen, False)
    kinds = [r["k"] for r in snap["records"]]
    if got["status"] != 200 or not snap["complete"] or \
            not snap["count"] == len(snap["records"]) == fr.count or \
            kinds[:2] != ["header", "submit"] or "clock" not in kinds or \
            snap["records"][-1] != {"k": "finish", "request": 0,
                                    "reason": "max_tokens", "tokens": toks,
                                    "token_rungs": snap["records"][-1][
                                        "token_rungs"]}:
        raise AssertionError(f"/v1/debug/flight: status {got['status']}, "
                             f"kinds {kinds[:6]}..., count "
                             f"{snap.get('count')}")
    res = {"status": got["status"], "records": snap["count"],
           "bytes": len(got["body"])}
    del eng, gw
    gc.collect()
    return res


def sigusr1_subprocess(out_dir: str, dev) -> dict:
    """``python -m repro_torch.launch.serve --gateway --reduced
    --flight-record PATH --flight-dump-dir D`` on the card: one request,
    SIGUSR1 (the dump), SIGTERM (exit 0); the dump replays through
    ``python -m repro_torch.obs.flight.replay`` (engine rebuilt from its
    header) with exit 0."""
    from repro_torch import obs
    sink = os.path.join(out_dir, "cli_flight.jsonl")
    dumps = os.path.join(out_dir, "cli_dumps")
    dump = os.path.join(dumps, "flight-sigusr1-0.jsonl")
    for p in (sink, dump):
        if os.path.exists(p):
            os.remove(p)
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = obs.now()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", dev.type, "--sparsity", "0", "--gateway",
         "--gateway-port", "0", "--max-slots", "2", "--prompt-len", "16",
         "--gen", "16", "--flight-record", sink, "--flight-dump-dir", dumps],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=HERE)
    try:
        port = gateway_port(proc)
        r = http_request(port, "POST", "/v1/generate",
                         {"prompt": list(range(1, 17)),
                          "max_new_tokens": 12})
        if r["status"] != 200:
            raise AssertionError(f"serve --flight-record: {r['status']}")
        proc.send_signal(signal.SIGUSR1)
        tick = threading.Event()
        for _ in range(2000):
            if os.path.exists(dump):
                with open(dump) as f:
                    if sum(1 for _ in f) > 2:
                        break
            tick.wait(0.01)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=HTTP_TIMEOUT_S)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"serve --flight-record exited "
                             f"{proc.returncode}:\n{rest[-2000:]}")
    t1 = obs.now()
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.flight.replay", dump,
         "--device", dev.type],
        capture_output=True, text=True, env=env, cwd=HERE,
        timeout=HTTP_TIMEOUT_S * 2)
    report = json.loads(rep.stdout) if rep.stdout.strip().startswith("{") \
        else {}
    if rep.returncode != 0 or not report.get("ok") or \
            report.get("tokens") != 12:
        raise AssertionError(f"replay of the SIGUSR1 dump exited "
                             f"{rep.returncode}: {rep.stdout[-2000:]}"
                             f"{rep.stderr[-2000:]}")
    return {"serve_s": t1 - t0, "replay_s": obs.now() - t1,
            "records_compared": report["records_compared"],
            "retraces": report["retraces"]}


def serve_quality_flight(dev, K, cfg, params, trace, ladder) -> dict:
    """Phase 15 at full width on the calibrated ladder: probed against
    unprobed serving, the forced drift and the quality de-escalation,
    record and replay, and the flight ring through a gateway.  The serve
    CLI's SIGUSR1 dump replayed by the replay CLI
    (:func:`sigusr1_subprocess`) runs later, in :func:`serve_clis`."""
    from repro_torch import obs

    t_phase = obs.now()
    out_dir = os.path.join(HERE, "build", "chip_smoke", "flight")
    os.makedirs(out_dir, exist_ok=True)
    res = {}
    runs = {}
    for name, monitor in (("unprobed", False), ("probed", True)):
        runs[name] = quality_run(f"quality {name}", params, cfg, trace,
                                 ladder, dev, K, monitor)
    a, b = runs["unprobed"], runs["probed"]
    if a["tokens"] != b["tokens"] or a["token_rungs"] != b["token_rungs"]:
        raise AssertionError("probed serving changed a served token or its "
                             "rung")
    for r, v in b["per_rung"].items():
        print(f"quality rung {r}: {v['probes']} probes, agreement "
              f"{v['agreement']}, top-k overlap {v['topk_overlap']}, recon "
              f"mean {v['recon_mean']} against calibration "
              f"{v['recon_baseline']}, decode utilization "
              f"{v['decode_utilization']:.4f} ({v['roofline_decode_gb']:.2f}"
              f" GB, {v['roofline_decode_gflop']:.1f} GFLOP per step)")
    print(f"quality: tokens and rungs equal with and without probes; "
          f"{b['probes']} probes = decode steps, {b['recon_passes']} recon "
          f"passes, 0 builds after warmup; probe {b['probe_host_ms_p50']:.2f}"
          f" ms host p50 ({b['probe_device_ms']:.2f} ms device), observe "
          f"{b['observe_host_ms_p50']:.2f} ms, recon "
          f"{b['recon_host_ms_p50']:.2f} ms host p50 "
          f"({b['recon_device_ms']:.2f} ms device); decode p50 "
          f"{a['decode_step_p50_ms']:.2f} / {b['decode_step_p50_ms']:.2f} "
          f"ms, run {a['run_s']:.2f} / {b['run_s']:.2f} s (unprobed / "
          f"probed); launches {b.get('launches')}; rung-0 probe "
          f"disagreements {b['rung0_probe_disagreements']}, max |probe - "
          f"decode| {b['rung0_probe_max_abs_logit_diff']:.4g}")
    keep = ("tokens", "token_rungs")
    res["quality"] = {n: {k: v for k, v in r.items() if k not in keep}
                      for n, r in runs.items()}
    del runs
    res["drift"] = forced_drift(params, cfg, trace, ladder, dev)
    print(f"forced drift: {res['drift']}")
    res["replay"] = record_and_replay(params, cfg, trace, ladder, dev,
                                      out_dir)
    print(f"record and replay: {_fmt(res['replay'])}")
    res["gateway"] = flight_gateway(params, cfg, trace, ladder, dev)
    print(f"/v1/debug/flight: {res['gateway']}")
    res["phase_s"] = obs.now() - t_phase
    print(f"phase 15 took {res['phase_s']:.1f} s")
    return res


def serve_clis(dev) -> dict:
    """The serve CLI's subprocess checks of phases 14-18 and 21, started
    together once phase 15 has freed the card: ``serve --gateway``
    drained by SIGTERM (:func:`drain_subprocess`), its SIGUSR1 dump
    replayed (:func:`sigusr1_subprocess`), and :func:`gemma_serve_cli`,
    :func:`granite_serve_cli`, :func:`mamba_serve_cli` and
    :func:`legacy_cli`.  Each is a process of its own that spends most of
    its time starting up, so one after another they took about 90 s.
    Their wall times overlap one another's.  Returns {name: result};
    any failure raises."""
    from concurrent.futures import ThreadPoolExecutor

    B, P, gen = (LEGACY_RUN[k] for k in ("batch", "prompt_len", "gen"))
    dirs = {k: os.path.join(HERE, "build", "chip_smoke", k)
            for k in ("gateway", "flight")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    jobs = {"drain": lambda: drain_subprocess(dirs["gateway"], dev),
            "flight": lambda: sigusr1_subprocess(dirs["flight"], dev),
            "gemma2_2b": lambda: gemma_serve_cli(dev),
            "granite_moe_3b_a800m": lambda: granite_serve_cli(dev),
            "mamba2_130m": lambda: mamba_serve_cli(dev),
            "legacy": lambda: legacy_cli(B, P, gen)}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(fn) for k, fn in jobs.items()}
        res = {k: f.result() for k, f in futs.items()}
    print(f"serve --flight-record, SIGUSR1 dump replayed: {res['flight']}")
    return res


# ---------------------------------------------------------------------------
# phase 16: gemma2_2b at full width (whole-prompt prefill, rolling windows)
# ---------------------------------------------------------------------------

GEMMA_ECFG = dict(max_slots=8, max_len=4608, prefill_chunk=32)
GEMMA_SERVED = ("score_select", "sparse_matmul_shared")


def gemma_model(dev):
    """gemma2_2b at full width, SERVE_DEPTH of its 26 layers (local and
    global alternating), random weights from SEED."""
    from repro_torch import obs
    from repro_torch.models import api

    cfg = served_config("gemma2_2b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (SERVE_DEPTH, 2304, 8, 4, 256, 9216, 256000)
    t0 = obs.now()
    params = api.init_model(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"gemma2_2b, {cfg.num_layers} of 26 layers: "
          f"{n_params / 1e9:.2f}B params ({cfg.dtype}), init "
          f"{obs.now() - t0:.1f} s, device memory "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    return cfg, params


def gemma_lens() -> tuple:
    """Phase 16's prompt lengths (4 of 4100-4500 tokens, two of one
    length, then phase 5's first 8), and the generator that draws the
    prompts' tokens next."""
    rng = np.random.default_rng(SEED)
    short = [int(p) for p in rng.integers(64, 449, 12)[:8]]
    rng = np.random.default_rng(SEED + 16)
    a, b, c = (int(x) for x in rng.choice(np.arange(4100, 4501), 3,
                                          replace=False))
    return [a, b, c, c] + short, rng


def gemma_prefill_rows() -> list:
    """The token rows of each whole-prompt prefill of phase 16's trace
    (one batch per prompt length: its length times its requests), the B
    that pass gives both kernels."""
    lens, _ = gemma_lens()
    return sorted({n * lens.count(n) for n in lens})


def gemma_trace(cfg) -> dict:
    """Phase 16's trace: 4 prompts of 4100-4500 tokens (two of one
    length, so one whole-prompt prefill has B = 2), then 8 of phase 5's
    64-448-token lengths, 32 new tokens each, all at once into 8 slots."""
    lens, rng = gemma_lens()
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    return {"prompts": prompts, "lens": lens, "gen": 32,
            "ecfg": dict(GEMMA_ECFG)}


def gemma_run(name, params, cfg, policy, sp, trace, dev, K, frac=0.5,
              window=WINDOW) -> dict:
    """One run of phase 16's trace through a fresh, warmed ``Engine``,
    the kernels' counts zeroed just before it is built and read just
    after the run.  Checks the ``whole`` strategy, decode steps with a
    row past the window (its local layers' caches rolled), no decode
    step built after warmup, and the launches against the sparse passes
    executed: 7 per layer of each kernel (:func:`pass_launches`) per replay
    of a sparse decode graph, per its eager warm call and per eager
    whole-prompt prefill run sparse (``prefill_dense_frac`` 0)."""
    from repro_torch import obs
    from repro_torch.serving import Engine, EngineConfig

    K.reset_launch_counts()
    eng = Engine(params, cfg, EngineConfig(
        policy=policy, prefill_dense_frac=frac, **trace["ecfg"]), sp,
        device=dev)
    eng.warmup()
    if eng.prefill_strategy != "whole":
        raise AssertionError(f"{name}: gemma2_2b resolved to "
                             f"{eng.prefill_strategy!r}, expected 'whole'")
    win = cfg.sliding_window
    rolled, prefills = [0], []
    decode_step, prefill_whole = eng._decode_step, eng._prefill_whole

    def counted_decode():
        if any(rs.position >= win for rs in eng.scheduler.decoding.values()):
            rolled[0] += 1
        decode_step()

    def timed_prefill(group):
        t0 = obs.now()
        prefill_whole(group)
        prefills.append((group[0].request.prompt_len, len(group),
                         1e3 * (obs.now() - t0)))

    eng._decode_step, eng._prefill_whole = counted_decode, timed_prefill
    for p in trace["prompts"]:
        eng.submit(p, trace["gen"])
    t0 = obs.now()
    out, res = drive(eng, window)
    torch.cuda.synchronize()
    res["wall_s"] = obs.now() - t0
    counts = dict(K.launch_counts)
    for rid, toks in out.items():
        if len(toks) != trace["gen"] or not all(0 <= t < cfg.vocab_size
                                                for t in toks):
            raise AssertionError(f"{name}: request {rid} gave {toks}")
    if max(trace["lens"]) >= win and rolled[0] == 0:
        raise AssertionError(f"{name}: no decode step at a position past "
                             f"the {win}-token window")
    if eng.decode_retraces_after_warmup != 0:
        raise AssertionError(f"{name}: {eng.decode_retraces_after_warmup} "
                             "decode builds after warmup")
    max_b = max(trace["lens"].count(n) for n in trace["lens"])
    if len(prefills) != len(set(trace["lens"])) or \
            max(b for _, b, _ in prefills) != max_b:
        raise AssertionError(f"{name}: whole prefills {prefills}: expected "
                             f"one per prompt length, the largest of B = "
                             f"{max_b}")
    per_pass = pass_launches(cfg)
    sparse_decode = not policy.for_phase("decode").is_dense
    prefill_phase = "prefill_sparse" if frac <= 0.0 else "prefill_dense"
    sparse_prefill = not policy.for_phase(prefill_phase).is_dense
    g = eng.decode_graphs
    passes = (g.steps[0] + 1 if sparse_decode else 0) + \
        (len(prefills) if sparse_prefill else 0)
    launches = eng.launches(counts)
    for k in per_pass:
        want_cap = per_pass[k] if sparse_decode else 0
        if g.captured[0][k] != want_cap:
            raise AssertionError(f"{name}: the decode graph captured "
                                 f"{g.captured[0][k]} {k}, expected "
                                 f"{want_cap}")
        if launches[k] != per_pass[k] * passes:
            raise AssertionError(
                f"{name}: {k} launched {launches[k]} times, expected "
                f"{per_pass[k] * passes} = {per_pass[k]} x {passes} sparse "
                "passes")
    if launches["sparse_matmul_per_seq"]:
        raise AssertionError(f"{name}: sparse_matmul_per_seq launched")
    res.update({
        "strategy": eng.prefill_strategy,
        "rolled_decode_steps": rolled[0],
        "decode_retraces_after_warmup": eng.decode_retraces_after_warmup,
        "decode_replays": list(g.steps),
        "whole_prefills": [[n, b, ms] for n, b, ms in prefills],
        "sparse_passes": passes,
        "launches": {k: launches[k] for k in GEMMA_SERVED},
        "launches_counted": {k: counts[k] for k in GEMMA_SERVED},
        "launches_per_pass": per_pass,
        "distinct_tokens": len({t for ts in out.values() for t in ts}),
        "tokens": out})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def gemma_calibrate(cfg, params) -> tuple:
    """A 0.5 ``pallas`` plan of the full-width model (paper Alg. 1-4,
    ``core/pipeline.run_pipeline`` with the serve CLI's ``--calib-quick``
    budget) on 4 x 128 synthetic tokens: its budget and finite
    thresholds are checked.  Returns (policy, sp, info)."""
    from repro_torch import obs
    from repro_torch.core import calibration, pipeline
    from repro_torch.core.allocation import EvoConfig, weighted_average
    from repro_torch.data import DataConfig, SyntheticLM

    evo = EvoConfig(generations=2, offspring=4, eps=0.1)
    toks = SyntheticLM(DataConfig(cfg.vocab_size, 128, 4)).batch(0)
    t0 = obs.now()
    ctx = calibration.build_context(params, cfg, {"tokens": toks})
    plan = pipeline.run_pipeline(params, cfg, None, KEEP, evo=evo,
                                 delta=0.25, coord_passes=0, ctx=ctx)
    torch.cuda.synchronize()
    took_s = obs.now() - t0
    avg = weighted_average(ctx, np.asarray(plan.block_ratios))
    if not KEEP - evo.eps <= avg <= KEEP + 1e-9:
        raise AssertionError(f"gemma2 plan: size-weighted block ratio {avg} "
                             f"outside [{KEEP - evo.eps}, {KEEP}]")
    bad = [k for k, t in plan.taus.items()
           if plan.layer_ratios[k] > 0 and not math.isfinite(t)]
    if bad or len(plan.taus) != 7 * cfg.num_layers:
        raise AssertionError(f"gemma2 plan: {len(plan.taus)} taus, "
                             f"non-finite where sparsified: {bad}")
    info = {"calibration_s": took_s, "weighted_ratio": avg,
            "summary": plan.summary()}
    print(f"gemma2_2b 0.5 plan calibrated in {took_s:.1f} s "
          f"(--calib-quick budget, 512 tokens): {plan.summary()}")
    policy, sp = plan.to_policy(backend="pallas"), plan.stacked_sp
    del ctx
    torch.cuda.empty_cache()
    return policy, sp, info


def gemma_graph_vs_eager(dev, cfg, params, sp, trace, steps: int = 4
                         ) -> dict:
    """The captured decode step against the eager one at rolled
    positions: the trace's 4 long prompts (past the 4096 window) and 4
    short ones prefilled, then at each of ``steps`` decode steps the
    eager step and the graph replay on the same inputs, dense and
    uncalibrated ``pallas``.  Greedy tokens must be equal; prints the
    logits' max abs error."""
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    out = {}
    for name, pol, s in (
            ("dense", SparsityPolicy.dense(), None),
            ("pallas", SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
             sp)):
        eng = Engine(params, cfg, EngineConfig(policy=pol, **trace["ecfg"]),
                     s, device=dev)
        for p in trace["prompts"][:8]:
            eng.submit(p, 64)
        while eng.scheduler.prefilling or eng.scheduler.has_queued():
            eng.step()
        g = eng.decode_graphs
        err, rolled = 0.0, 0
        for _ in range(steps):
            tokens, positions, active = eng.decode_inputs()
            if active.sum() != 8:
                raise AssertionError(f"{name}: {active.sum()} active slots")
            rolled += int((positions[active > 0] >= cfg.sliding_window).sum())
            logits = g.eager(0, tokens, positions, active)
            want = (torch.argmax(logits, -1).cpu().numpy(),
                    logits.float().clone())
            nxt, logits = g(0, tokens, positions, active)
            if not np.array_equal(want[0], nxt):
                raise AssertionError(f"gemma2 {name}: graph replay tokens "
                                     f"{nxt} != eager {want[0]}")
            err = max(err, max_err(logits.float(), want[1]))
            eng.step()
        if rolled == 0:
            raise AssertionError(f"gemma2 {name}: no row past the window")
        out[name] = {"logits_max_abs_err": err, "rolled_rows": rolled,
                     "steps": steps,
                     "eager_step_top_ops": eager_step_ops(g, eng)}
        print(f"gemma2 graph vs eager, {name}, B=8, {steps} steps with "
              f"{rolled} rolled rows: greedy tokens equal; logits max abs "
              f"err {err:.3g}")
        del eng
        gc.collect()
    return out


def eager_step_ops(g, eng, top: int = 8) -> list:
    """One eager decode step under ``torch.profiler`` (the card only):
    its ``top`` operators by device time, [name, ms, share of the
    step's device time] (the graph replays the same kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tokens, positions, active = eng.decode_inputs()
    g.eager(0, tokens, positions, active)          # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.eager(0, tokens, positions, active)
        torch.cuda.synchronize()
    ev = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    total = sum(ms for _, ms in ev)
    ev.sort(key=lambda e: -e[1])
    rows = [[k[:60], ms, ms / total] for k, ms in ev[:top]]
    print(f"one eager decode step: {total:.2f} ms on the "
          "device; top ops " + "; ".join(f"{k} {ms:.2f} ms ({100 * f:.0f}%)"
                                         for k, ms, f in rows))
    return rows


def gemma_serve_cli(dev) -> dict:
    """``python -m repro_torch.launch.serve --arch gemma2_2b --reduced``
    on the card, in a subprocess: it must exit 0."""
    from repro_torch import obs
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = obs.now()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma2_2b", "--reduced", "--prompt-len", "96", "--gen", "40"],
        env=env, cwd=HERE, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"serve --arch gemma2_2b --reduced exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    print(f"serve --arch gemma2_2b --reduced: exit 0 in "
          f"{obs.now() - t0:.1f} s; {lines[-1] if lines else ''}")
    return {"exit": proc.returncode, "wall_s": obs.now() - t0}


def serve_gemma(dev, K, cli: dict) -> dict:
    """Phase 16: full-width gemma2_2b through the port's ``Engine``:
    dense, ``pallas``, ``pallas``, dense (uncalibrated: keep_frac =
    k_max_frac = 0.5, tau -inf), ``pallas`` with ``prefill_dense_frac``
    0 (the whole prompts through the kernels at up to 2 x 4500 rows),
    and a 0.5 plan calibrated at full width; then the captured decode
    step against the eager one at rolled positions.  ``cli`` is the serve
    CLI's result (:func:`gemma_serve_cli`, run by :func:`serve_clis`)."""
    from repro_torch import obs
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.serving.metrics import percentile
    from repro_torch.sparsity import SparsityPolicy

    t_phase = obs.now()
    cfg, params = gemma_model(dev)
    trace = gemma_trace(cfg)
    print(f"phase 16 trace: prompt lengths {trace['lens']}, "
          f"{trace['gen']} new tokens each, {trace['ecfg']}")
    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    modes = {"dense": (SparsityPolicy.dense(), None),
             "pallas": (SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
                        sp)}
    runs = {}
    for name in ("dense", "pallas", "pallas", "dense"):
        pol, s = modes[name]
        res = gemma_run(name, params, cfg, pol, s, trace, dev, K)
        if name in runs and res["tokens"] != runs[name][0]["tokens"]:
            raise AssertionError(f"gemma2 {name}: the second run's greedy "
                                 "tokens differ from the first's")
        runs.setdefault(name, []).append(res)
    pol, s = modes["pallas"]
    runs["pallas sparse prefill"] = [gemma_run(
        "pallas sparse prefill", params, cfg, pol, s, trace, dev, K,
        frac=0.0)]
    policy, plan_sp, calib = gemma_calibrate(cfg, params)
    runs["calibrated"] = [gemma_run("calibrated", params, cfg, policy,
                                    plan_sp, trace, dev, K)]
    del plan_sp
    keys = ("decode_tok_s", "decode_step_p50_ms", "decode_step_p95_ms",
            "ttft_p50_ms", "window_step_device_ms", "wall_s",
            "rolled_decode_steps", "sparse_passes", "distinct_tokens")
    for name, rs in runs.items():
        for i, r in enumerate(rs):
            pre = ", ".join(f"{n}x{b} {ms:.1f}" for n, b, ms in
                            r["whole_prefills"])
            print(f"gemma2 {name} {i + 1}: " + ", ".join(
                f"{k} {r[k]:.4g}" if isinstance(r[k], float)
                else f"{k} {r[k]}" for k in keys)
                + f"; launches {r['launches']}; whole-prefill ms per "
                f"prompt length x batch: {pre}")
    gve = gemma_graph_vs_eager(dev, cfg, params, sp, trace)
    d = runs["dense"]
    long_ms = [ms for n, _b, ms in d[0]["whole_prefills"] if n > 4096]
    print(f"gemma2 dense: greedy tokens equal in both runs; decode p50 "
          f"{d[0]['decode_step_p50_ms']:.2f} / "
          f"{d[1]['decode_step_p50_ms']:.2f} ms; whole-prefill ms p50 over "
          f"the 4100-4500-token prompts {percentile(long_ms, 50):.1f}")
    keep = ("tokens",)
    out = {"runs": {f"{n} {i + 1}": {k: v for k, v in r.items()
                                      if k not in keep}
                    for n, rs in runs.items() for i, r in enumerate(rs)},
           "calibration": calib, "graph_vs_eager": gve, "serve_cli": cli,
           "trace_lens": trace["lens"]}
    del params, sp
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = obs.now() - t_phase
    print(f"phase 16 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: granite_moe_3b_a800m at full width (MoE, expert-batched kernels)
# ---------------------------------------------------------------------------

def granite_model(dev):
    """granite_moe_3b_a800m at full width, SERVE_DEPTH of its 32 layers,
    random weights from SEED: 40 experts padded to 48, top-8, expert
    d_ff 512."""
    from repro_torch import obs
    from repro_torch.models import api

    cfg = served_config("granite_moe_3b_a800m")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.expert_d_ff, cfg.num_experts,
            cfg.num_experts_padded, cfg.num_experts_per_tok,
            cfg.vocab_size) == (SERVE_DEPTH, 1536, 24, 8, 64, 512, 40, 48,
                                8, 49155)
    t0 = obs.now()
    params = api.init_model(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"granite_moe_3b_a800m, {cfg.num_layers} of 32 layers: "
          f"{n_params / 1e9:.2f}B params ({cfg.dtype}, "
          f"48 experts computed per layer), init {obs.now() - t0:.1f} s, "
          f"device memory {torch.cuda.memory_allocated() / 1e9:.1f} GB")
    return cfg, params


def granite_run(name, params, cfg, policy, sp, trace, dev, K) -> dict:
    """One run of phase 5's trace through a fresh, warmed ``Engine``
    (``serve_once(warm=True)``: no decode or chunk step built after
    warmup, the sparse prefill chunks, and the launches against the
    sparse passes, :func:`pass_launches`: per pass 4 of each 2-D kernel
    per layer for the attention projections and 3 of each expert kernel
    per layer for the expert-batched ones), which must resolve
    ``chunked``."""
    res = serve_once(f"granite {name}", params, cfg, policy, sp, trace, dev,
                     K, warm=True)
    if res["strategy"] != "chunked":
        raise AssertionError(f"granite {name}: resolved to "
                             f"{res['strategy']!r}, expected 'chunked'")
    torch.cuda.empty_cache()
    return res


def capacity_drops(dev, cfg, params, trace) -> dict:
    """The expert assignments that each 32-token prefill chunk drops past
    the capacity (C = 9), summed over the 32 MoE layers, in a dense run
    of the trace's prefills with the chunks run eagerly and
    ``models/moe.dispatch`` wrapped to keep each chunk's overflow (a
    diagnostic: the served runs' captured chunks cannot be observed
    from the host).  Decode never drops (one token per group)."""
    from repro_torch.models import moe
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    C = trace["ecfg"]["prefill_chunk"]
    drops = []
    eng = Engine(params, cfg, EngineConfig(policy=SparsityPolicy.dense(),
                                           **trace["ecfg"]), None, device=dev)
    eng._chunk = EagerChunks(eng._chunk)
    with recorded_drops(drops):
        for p in trace["prompts"]:
            eng.submit(p, 1)
        eng.run()
    if any(S != C for S, _cap, _n in drops):
        raise AssertionError(f"capacity drops: a dispatch of other than {C} "
                             "tokens per group")
    per_layer = torch.stack([n for _S, _cap, n in drops]).reshape(
        -1, cfg.num_layers).cpu()
    per_chunk = per_layer.sum(1).double()
    chunks = per_chunk.numel()
    if chunks != eng.stats.prefill_chunks:
        raise AssertionError(f"capacity drops: {chunks} chunks recorded, "
                             f"{eng.stats.prefill_chunks} run")
    assigned = chunks * cfg.num_layers * C * cfg.num_experts_per_tok
    res = {"chunks": chunks, "capacity": moe._capacity(C, cfg),
           "dropped_per_chunk_mean": float(per_chunk.mean()),
           "dropped_per_chunk_max": float(per_chunk.max()),
           "dropped_share": float(per_chunk.sum()) / assigned}
    print(f"granite capacity drops (dense, eager chunks): {chunks} chunks of "
          f"{C} tokens at C = {res['capacity']}: "
          f"{res['dropped_per_chunk_mean']:.1f} assignments dropped per chunk "
          f"over {cfg.num_layers} layers (max {res['dropped_per_chunk_max']:.0f}), "
          f"{100 * res['dropped_share']:.2f}% of the chunks' "
          f"{cfg.num_experts_per_tok}-expert assignments")
    del eng
    gc.collect()
    return res


def granite_graph_vs_eager(dev, cfg, params, sp, trace, steps: int = 4
                           ) -> dict:
    """The captured decode step against the eager one, 8 prompts
    prefilled, dense and uncalibrated ``pallas``: greedy tokens equal at
    each of ``steps`` steps; prints the logits' max abs error and the
    top ops of one eager decode step."""
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    out = {}
    for name, pol, s in (
            ("dense", SparsityPolicy.dense(), None),
            ("pallas", SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
             sp)):
        eng = Engine(params, cfg, EngineConfig(policy=pol, **trace["ecfg"]),
                     s, device=dev)
        for p in trace["prompts"][:8]:
            eng.submit(p, 64)
        while eng.scheduler.prefilling or eng.scheduler.has_queued():
            eng.step()
        g = eng.decode_graphs
        err = 0.0
        for _ in range(steps):
            tokens, positions, active = eng.decode_inputs()
            if active.sum() != 8:
                raise AssertionError(f"granite {name}: {active.sum()} active "
                                     "slots")
            logits = g.eager(0, tokens, positions, active)
            want = (torch.argmax(logits, -1).cpu().numpy(),
                    logits.float().clone())
            nxt, logits = g(0, tokens, positions, active)
            if not np.array_equal(want[0], nxt):
                raise AssertionError(f"granite {name}: graph replay tokens "
                                     f"{nxt} != eager {want[0]}")
            err = max(err, max_err(logits.float(), want[1]))
            eng.step()
        out[name] = {"logits_max_abs_err": err, "steps": steps,
                     "eager_step_top_ops": eager_step_ops(g, eng)}
        print(f"granite graph vs eager, {name}, B=8, {steps} steps: greedy "
              f"tokens equal; logits max abs err {err:.3g}")
        del eng
        gc.collect()
    return out


def granite_serve_cli(dev) -> dict:
    """``python -m repro_torch.launch.serve --arch granite_moe_3b_a800m
    --mode pallas`` at full width on the card, in a subprocess (4
    prompts of 64 tokens, 8 new tokens each): it must exit 0."""
    from repro_torch import obs
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = obs.now()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "granite_moe_3b_a800m", "--mode", "pallas", "--batch", "4",
         "--prompt-len", "64", "--gen", "8"],
        env=env, cwd=HERE, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"serve --arch granite_moe_3b_a800m exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    print(f"serve --arch granite_moe_3b_a800m --mode pallas: exit 0 in "
          f"{obs.now() - t0:.1f} s; {lines[-1] if lines else ''}")
    return {"exit": proc.returncode, "wall_s": obs.now() - t0}


def rung_table(tag, runs, keys=("decode_tok_s", "decode_step_p50_ms",
                                "window_step_device_ms")) -> None:
    """One line per run: ``keys`` and greedy-token agreement with the
    first dense run."""
    dense = runs["dense"][0]
    for name, rs in runs.items():
        for i, r in enumerate(rs):
            print(f"  {tag} {name + ' ' + str(i + 1):28s} " + ", ".join(
                f"{k} {r[k]:.4g}" for k in keys)
                + f", tokens equal to dense {agreement(dense, r):.3f}")


def granite_calibrated(dev, K, cfg, params, trace, runs) -> dict:
    """Phase 17's calibrated ladder: ``timed_ladder`` at 0.0/0.5/0.7 on
    the full-width model (per-expert capture and g, top-k-scaled block
    budgets), checked by ``check_calibrated_ladder`` (7 taus per layer); its
    v4 artifact round trip; each sparse rung served pinned (phase 5's
    trace, warmed, 0 builds after warmup, launches per sparse pass as
    ``pass_launches``: 4 of each 2-D kernel and 3 of each ``_experts``
    kernel per layer), then the loaded ladder under the SLO controller.  Adds the
    pinned runs to ``runs``."""
    from repro_torch.core.allocation import EvoConfig
    from repro_torch.serving import SLOConfig

    evo = EvoConfig(generations=2, offspring=4, eps=0.1)
    ladder, ctx, times = timed_ladder(cfg, params, evo, tag="granite ")
    rungs = check_calibrated_ladder("granite", cfg, ctx, ladder, evo, 7)
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    loaded = save_and_load_ladder(ladder, "granite_ladder.npz", dev)
    for i in range(1, len(ladder)):
        pol, sp = loaded.rung(i)
        res = granite_run(f"calibrated rung {i}", params, cfg, pol, sp,
                          trace, dev, K)
        runs[f"calibrated rung {i}"] = [res]
        print(f"granite calibrated rung {i} (k_max_frac "
              f"{pol.k_max_frac}): {_fmt(res)}")
    res = serve_once("granite ladder", params, cfg, None, None, trace, dev,
                     K, ladder=loaded, slo=SLOConfig(**PHASE8_SLO),
                     warm=True)
    check_ladder_run("granite ladder", res)
    runs["ladder (SLO controller)"] = [res]
    print(f"granite ladder under the SLO controller: {_fmt(res)}")
    print(f"granite ladder: transitions {res['transitions']}, residency "
          f"per rung {res['residency']}, 0 builds after warmup")
    rung_table("granite", runs)
    del ladder, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return {"calibration": times, "rungs": rungs}


def serve_granite(dev, K, cli: dict) -> dict:
    """Phase 17: full-width granite_moe_3b_a800m through the port's
    ``Engine`` on phase 5's trace: dense, ``pallas``, ``pallas``, dense
    (uncalibrated: keep_frac = k_max_frac = 0.5, tau -inf); then a
    calibrated ladder, its rungs and the ladder under the SLO controller
    (:func:`granite_calibrated`), the capacity drops per chunk and the
    captured decode step against the eager one.  ``cli`` is the serve
    CLI's result at full width (:func:`granite_serve_cli`, run by
    :func:`serve_clis`)."""
    from repro_torch import obs
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.launch import constants
    from repro_torch.launch.roofline import step_costs
    from repro_torch.serving import EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    t_phase = obs.now()
    cfg, params = granite_model(dev)
    trace = serving_trace(cfg)
    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    modes = {"dense": (SparsityPolicy.dense(), None),
             "pallas": (SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
                        sp)}
    ecfg = EngineConfig(**trace["ecfg"])
    bounds = {}
    for name, (pol, s) in modes.items():
        _, nbytes = step_costs(cfg, ecfg, pol, s, "decode")
        bounds[name] = {"decode_step_gb": nbytes / 1e9,
                        "decode_step_bound_ms": 1e3 * nbytes
                        / constants.HBM_BW}
    print(f"granite decode step bytes (step_costs): dense "
          f"{bounds['dense']['decode_step_gb']:.2f} GB = "
          f"{bounds['dense']['decode_step_bound_ms']:.2f} ms, pallas "
          f"{bounds['pallas']['decode_step_gb']:.2f} GB = "
          f"{bounds['pallas']['decode_step_bound_ms']:.2f} ms at 3.35 TB/s")
    runs = {}
    for name in ("dense", "pallas", "pallas", "dense"):
        pol, s = modes[name]
        res = granite_run(name, params, cfg, pol, s, trace, dev, K)
        if name in runs and res["tokens"] != runs[name][0]["tokens"]:
            raise AssertionError(f"granite {name}: the second run's greedy "
                                 "tokens differ from the first's")
        runs.setdefault(name, []).append(res)
        print(f"granite {name} run {len(runs[name])}: {_fmt(res)}")
    calibrated = granite_calibrated(dev, K, cfg, params, trace, runs)
    drops = capacity_drops(dev, cfg, params, trace)
    gve = granite_graph_vs_eager(dev, cfg, params, sp, trace)
    for name in ("dense", "pallas"):
        rs = runs[name]
        print(f"granite {name}: decode tok/s "
              f"{rs[0]['decode_tok_s']:.1f} / {rs[1]['decode_tok_s']:.1f}, "
              f"decode p50 {rs[0]['decode_step_p50_ms']:.2f} / "
              f"{rs[1]['decode_step_p50_ms']:.2f} ms, p95 "
              f"{rs[0]['decode_step_p95_ms']:.2f} / "
              f"{rs[1]['decode_step_p95_ms']:.2f} ms, TTFT p50 "
              f"{rs[0]['ttft_p50_ms']:.1f} / {rs[1]['ttft_p50_ms']:.1f} ms, "
              f"chunk p50 {rs[0]['prefill_chunk_p50_ms']:.2f} / "
              f"{rs[1]['prefill_chunk_p50_ms']:.2f} ms, device ms per traced "
              f"decode step {rs[0]['window_step_device_ms']:.2f} / "
              f"{rs[1]['window_step_device_ms']:.2f} (bound "
              f"{bounds[name]['decode_step_bound_ms']:.2f}); greedy tokens "
              "equal in both runs")
    print(f"granite greedy tokens equal to dense at the same position: "
          f"{agreement(runs['dense'][0], runs['pallas'][0]):.3f} (random "
          "weights; informative only)")
    out = {"runs": {f"{n} {i + 1}": {k: v for k, v in r.items()
                                      if k != "tokens"}
                    for n, rs in runs.items() for i, r in enumerate(rs)},
           "step_bounds": bounds, "capacity_drops": drops,
           "graph_vs_eager": gve, "serve_cli": cli,
           "calibrated": calibrated}
    del params, sp
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = obs.now() - t_phase
    print(f"phase 17 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 18: mamba2_130m at full width (SSD scan, O(1) decode state)
# ---------------------------------------------------------------------------

# max_len is bookkeeping only: an attention-free model's pool has no time
# axis
MAMBA_ECFG = dict(max_slots=8, max_len=8448, prefill_chunk=32)


def mamba_model(dev):
    """mamba2_130m at full width, SERVE_DEPTH of its 24 layers, random
    weights from SEED: d_model 768, d_inner 1536, 24 heads of 64, state
    128, conv 4, vocab 50280, tied head, bf16."""
    from repro_torch import obs
    from repro_torch.models import api

    cfg = served_config("mamba2_130m")
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_nheads,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_conv, cfg.vocab_size,
            cfg.tie_embeddings, cfg.dtype) == \
        (SERVE_DEPTH, 768, 1536, 24, 64, 128, 4, 50280, True, "bfloat16")
    t0 = obs.now()
    params = api.init_model(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"mamba2_130m, {cfg.num_layers} of 24 layers: "
          f"{n_params / 1e6:.1f}M params ({cfg.dtype}), init "
          f"{obs.now() - t0:.1f} s, device memory "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    return cfg, params


def mamba_lens() -> list:
    """Phase 18's prompt lengths: 3 of 8192 tokens (one whole prefill of
    B = 3), one of 4099 (prime: the reference's chunk rule falls to
    L = 1), then phase 5's first 8 (64-448)."""
    rng = np.random.default_rng(SEED)
    short = [int(p) for p in rng.integers(64, 449, 12)[:8]]
    return [8192, 8192, 8192, 4099] + short


def mamba_prefill_rows() -> list:
    """The token rows of each whole-prompt prefill of phase 18's trace
    (one batch per prompt length), the B that pass gives both kernels."""
    lens = mamba_lens()
    return sorted({n * lens.count(n) for n in lens})


def mamba_trace(cfg) -> dict:
    """Phase 18's trace: the 12 prompts of :func:`mamba_lens`, submitted
    in that order (the first 8 admitted at once, so the three 8192-token
    prompts batch into one whole prefill), 32 new tokens each."""
    rng = np.random.default_rng(SEED + 18)
    lens = mamba_lens()
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    return {"prompts": prompts, "lens": lens, "gen": 32,
            "ecfg": dict(MAMBA_ECFG), "max_batch": 3}


def mamba_short_trace(cfg) -> dict:
    """Phase 18's calibrated runs' trace: phase 5's 12 prompt lengths
    (64-448; the first 8 are phase 18's short prompts), 32 new tokens
    each, into phase 18's 8 slots: 4 requests queue at the start, which
    the SLO controller acts on."""
    rng = np.random.default_rng(SEED)
    lens = [int(p) for p in rng.integers(64, 449, 12)]
    rng = np.random.default_rng(SEED + 18)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    return {"prompts": prompts, "lens": lens, "gen": 32,
            "ecfg": dict(MAMBA_ECFG)}


def ssm_state_bytes(eng) -> int:
    """Bytes of every slot's conv windows and f32 SSM state in ``eng``'s
    pool (a decode step reads them once and writes them once)."""
    from repro_torch.serving import graphs
    return sum(t.nbytes for t in graphs.ssm_leaves(eng.pool.caches))


def ssm_run(name, params, cfg, policy, sp, trace, dev, K, frac=0.5,
            window=WINDOW, ladder=None, slo=None) -> dict:
    """One run of a phase 18 or 24 trace through a fresh, warmed ``Engine``
    (from ``policy`` and ``sp``, or from ``ladder`` under ``slo``), the
    kernels' counts zeroed just before it is built and read just after
    the run.  Checks the ``whole`` strategy, every prompt prefilled whole
    (the largest batch at B = ``trace["max_batch"]`` where the trace
    names one: phase 18's three 8192-token prompts), no decode step built
    after warmup, and the launches of each kernel, the ``_experts`` pair
    too, against the sparse passes executed: :func:`pass_launches` under
    each rung's decode policy (mamba2_130m: 6 projections per layer;
    jamba_v01_52b: 58 and 12 per period) per replay of a sparse decode
    graph and per its eager warm call, and under the prefill policy per
    whole prefill run sparse (``prefill_dense_frac`` 0; a ladder run
    prefills dense), and of those expert matmuls the tile form's: every
    one of a sparse whole prefill whose expert rows reach
    ``TILE_MIN_ROWS``, no other."""
    from repro_torch import obs
    from repro_torch.models import moe
    from repro_torch.serving import Engine, EngineConfig

    if ladder is not None and frac <= 0.0:
        raise ValueError("a ladder run's whole prefills run at the rung of "
                         "the moment; keep them dense (frac > 0)")
    K.reset_launch_counts()
    eng = Engine(params, cfg, EngineConfig(
        policy=policy, slo=slo, prefill_dense_frac=frac, **trace["ecfg"]),
        sp, device=dev, ladder=ladder)
    eng.warmup()
    if eng.prefill_strategy != "whole":
        raise AssertionError(f"{name}: {cfg.name} resolved to "
                             f"{eng.prefill_strategy!r}, expected 'whole'")
    prefills, prefill_whole = [], eng._prefill_whole

    def timed_prefill(group):
        t0 = obs.now()
        prefill_whole(group)
        torch.cuda.synchronize()
        prefills.append((group[0].request.prompt_len, len(group),
                         1e3 * (obs.now() - t0)))

    eng._prefill_whole = timed_prefill
    for p in trace["prompts"]:
        eng.submit(p, trace["gen"])
    t0 = obs.now()
    out, res = drive(eng, window)
    torch.cuda.synchronize()
    res["wall_s"] = obs.now() - t0
    counts = dict(K.launch_counts)
    for rid, toks in out.items():
        if len(toks) != trace["gen"] or not all(0 <= t < cfg.vocab_size
                                                for t in toks):
            raise AssertionError(f"{name}: request {rid} gave {toks}")
    if eng.decode_retraces_after_warmup != 0:
        raise AssertionError(f"{name}: {eng.decode_retraces_after_warmup} "
                             "decode builds after warmup")
    if sum(b for _, b, _ in prefills) != len(trace["prompts"]) or (
            "max_batch" in trace
            and max(b for _, b, _ in prefills) != trace["max_batch"]):
        raise AssertionError(f"{name}: whole prefills {prefills}: expected "
                             "every prompt once, the longest batched")
    policies = ladder.policies if ladder is not None else [policy]
    dec_pols = [p.for_phase("decode") for p in policies]
    pre_pol = policies[0].for_phase("prefill_sparse" if frac <= 0.0
                                    else "prefill_dense")
    per_prefill = pass_launches(cfg, pre_pol)
    served = tuple(per_prefill)
    sparse_prefill = not pre_pol.is_dense
    g = eng.decode_graphs
    launches = eng.launches(counts)
    want = {k: per_prefill[k] * len(prefills) if sparse_prefill else 0
            for k in served}
    for i, dpol in enumerate(dec_pols):
        per_pass = pass_launches(cfg, dpol)
        for k in served:
            want_cap = 0 if dpol.is_dense else per_pass[k]
            if g.captured[i].get(k, 0) != want_cap:
                raise AssertionError(
                    f"{name}: rung {i}'s decode graph captured "
                    f"{g.captured[i].get(k, 0)} {k}, expected {want_cap}")
            if not dpol.is_dense:
                want[k] += per_pass[k] * (g.steps[i] + 1)
    for k in served:
        if launches[k] != want[k]:
            raise AssertionError(
                f"{name}: {k} launched {launches[k]} times, expected "
                f"{want[k]} (per sparse decode pass x (replays + warm call) "
                f"of each sparse rung, {per_prefill[k]} per whole prefill x "
                f"{len(prefills) if sparse_prefill else 0})")
    if launches["sparse_matmul_per_seq"]:
        raise AssertionError(f"{name}: sparse_matmul_per_seq launched")
    # the expert matmul's tile form: each sparse whole prefill whose
    # expert rows reach its threshold, eagerly (decode rows never do)
    tiles = K.tile_launches["sparse_matmul_shared_experts"]
    want_tiles = per_prefill["sparse_matmul_shared_experts"] * sum(
        moe.expert_rows(cfg, b, n) >= K.TILE_MIN_ROWS
        for n, b, _ms in prefills) if sparse_prefill and cfg.num_experts \
        else 0
    if tiles != want_tiles:
        raise AssertionError(f"{name}: the expert matmul's tile form "
                             f"launched {tiles} times, expected "
                             f"{want_tiles}")
    distinct = len({t for ts in out.values() for t in ts})
    if distinct < 2:
        raise AssertionError(f"{name}: every request emitted one token")
    res.update({
        "strategy": eng.prefill_strategy,
        "decode_retraces_after_warmup": eng.decode_retraces_after_warmup,
        "decode_replays": list(g.steps),
        "whole_prefills": [[n, b, ms] for n, b, ms in prefills],
        "sparse_passes": sum(g.steps[i] + 1 for i, d in enumerate(dec_pols)
                             if not d.is_dense)
        + (len(prefills) if sparse_prefill else 0),
        "launches": {k: launches[k] for k in served},
        "launches_counted": {k: counts[k] for k in served},
        "tile_launches": tiles,
        "launches_per_pass": pass_launches(cfg, dec_pols[0])
        if ladder is None else [pass_launches(cfg, d) for d in dec_pols],
        "state_bytes": ssm_state_bytes(eng),
        "distinct_tokens": distinct,
        "tokens": out})
    if eng.controller is not None:
        c = eng.controller
        res["transitions"] = list(c.transitions)
        res["residency"] = list(c.residency)
        res["token_rungs"] = {rid: list(rs.token_rungs)
                              for rid, rs in eng.states.items()}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return res


def ssm_graph_vs_eager(dev, cfg, params, sp, trace, steps: int = 4,
                       modes=None, tag="mamba2", prompts=None,
                       drops=None, tol=None) -> dict:
    """``prompts`` (phase 18's 8 short prompts by default) prefilled whole
    into an engine whose decode step is not built yet, dense and
    uncalibrated ``pallas`` (or ``modes``).
    First the decode graph is built on that busy engine: its warm call
    runs every slot inactive, which advances every slot's conv windows
    and SSM state, and the build must put them back, every live slot's
    rows bit-equal.  Then, at each of ``steps`` decode steps, the eager
    step and the graph replay from the same pool state (restored between
    them: a decode step advances the state in place): greedy tokens must
    be equal, and the logits within ``tol`` where it is given; prints the
    logits' max abs error and the top ops of one eager step.  ``drops``
    (a list) records the capacity drops of each MoE layer in the first
    mode's whole prefills (:func:`recorded_drops`)."""
    from repro_torch.serving import Engine, EngineConfig, graphs
    from repro_torch.sparsity import SparsityPolicy

    out = {}
    prompts = trace["prompts"][4:] if prompts is None else prompts
    for name, pol, s in modes or (
            ("dense", SparsityPolicy.dense(), None),
            ("pallas", SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
             sp)):
        eng = Engine(params, cfg, EngineConfig(policy=pol, **trace["ecfg"]),
                     s, device=dev)
        for p in prompts:
            eng.submit(p, 64)
        eng._admit()
        with recorded_drops(drops):
            while eng.scheduler.prefilling:
                eng._prefill_whole(eng.scheduler.prefill_group())
        drops = None
        g = eng.decode_graphs
        leaves = graphs.ssm_leaves(eng.pool.caches)
        live = [t.clone() for t in leaves]
        if g.built(0):
            raise AssertionError(f"{tag} {name}: decode graph built early")
        g.build(0)
        torch.cuda.synchronize()
        moved = [i for i, (a, b) in enumerate(zip(leaves, live))
                 if not torch.equal(a, b)]
        if moved:
            raise AssertionError(f"{tag} {name}: the decode build on a busy "
                                 f"engine changed SSM leaves {moved}")
        del live
        err = 0.0
        for _ in range(steps):
            tokens, positions, active = eng.decode_inputs()
            if active.sum() != len(prompts):
                raise AssertionError(f"{tag} {name}: {active.sum()} active "
                                     "slots")
            before = [t.clone() for t in leaves]
            logits = g.eager(0, tokens, positions, active)
            want = (torch.argmax(logits, -1).cpu().numpy(),
                    logits.float().clone())
            for t, b in zip(leaves, before):
                t.copy_(b)
            nxt, logits = g(0, tokens, positions, active)
            if not np.array_equal(want[0], nxt):
                raise AssertionError(f"{tag} {name}: graph replay tokens "
                                     f"{nxt} != eager {want[0]}")
            err = max(err, max_err(logits.float(), want[1]))
            for t, b in zip(leaves, before):
                t.copy_(b)
            eng.step()
        if tol is not None and err > tol:
            raise AssertionError(f"{tag} {name}: graph replay logits differ "
                                 f"from the eager step's by {err:.3g} > "
                                 f"{tol}")
        # the last use of this engine: one eager step under the profiler
        # (it advances the pool's state)
        out[name] = {"logits_max_abs_err": err, "steps": steps,
                     "busy_build_leaves_equal": len(leaves),
                     "eager_step_top_ops": eager_step_ops(g, eng)}
        print(f"{tag} {name}: the decode graph built on a busy engine left "
              f"all {len(leaves)} SSM leaves bit-equal; graph vs eager, "
              f"B={len(prompts)}, {steps} steps: greedy tokens equal; logits "
              f"max abs err {err:.3g}")
        del eng
        gc.collect()
    return out


@contextlib.contextmanager
def recorded_drops(drops):
    """While it is open, every MoE dispatch of more than one token per
    group (a whole prefill: its tokens, capacity and the assignments past
    it) is appended to ``drops``, unless that is None.  A diagnostic: the
    sum is read back from the device."""
    from repro_torch.models import moe

    if drops is None:
        yield
        return
    real = moe.dispatch

    def recording(topk, S, cap, E):
        disp, pos, counts = real(topk, S, cap, E)
        if S > 1:
            drops.append((S, cap, (counts - cap).clamp(min=0).sum()))
        return disp, pos, counts

    moe.dispatch = recording
    try:
        yield
    finally:
        moe.dispatch = real


def mamba_calibrated(dev, K, cfg, params, sp, trace) -> dict:
    """Phase 18's calibrated ladder: ``timed_ladder`` at 0.0/0.5/0.7 on
    the full-width model, checked by ``check_calibrated_ladder`` (6 x 24
    taus); its v4 artifact round trip; on :func:`mamba_short_trace`,
    dense, uncalibrated ``pallas``, each sparse rung pinned (rung 1 is
    the 0.5 plan) and the loaded ladder under the SLO controller, all
    with whole prefill (dense: ``prefill_dense_frac`` 0.5); then the
    busy decode build and graph against eager under the 0.5 plan."""
    from repro_torch.core.allocation import EvoConfig
    from repro_torch.serving import SLOConfig
    from repro_torch.sparsity import SparsityPolicy

    evo = EvoConfig(generations=2, offspring=4, eps=0.1)
    ladder, ctx, times = timed_ladder(cfg, params, evo, tag="mamba2 ")
    rungs = check_calibrated_ladder("mamba2", cfg, ctx, ladder, evo, 6)
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    loaded = save_and_load_ladder(ladder, "mamba2_ladder.npz", dev)
    short = mamba_short_trace(cfg)
    print(f"phase 18 calibrated trace: prompt lengths {short['lens']}, "
          f"{short['gen']} new tokens each, {short['ecfg']}")
    runs = {"dense": [ssm_run("short dense", params, cfg,
                              SparsityPolicy.dense(), None, short, dev, K)],
            "pallas (uncalibrated)": [ssm_run(
                "short pallas", params, cfg,
                SparsityPolicy.uniform("pallas", k_max_frac=KEEP), sp,
                short, dev, K)]}
    for i in range(1, len(loaded)):
        pol, rsp = loaded.rung(i)
        runs[f"calibrated rung {i}"] = [ssm_run(
            f"calibrated rung {i}", params, cfg, pol, rsp, short, dev, K)]
    res = ssm_run("mamba2 ladder", params, cfg, None, None, short, dev, K,
                  ladder=loaded, slo=SLOConfig(**PHASE8_SLO))
    check_ladder_run("mamba2 ladder", res)
    runs["ladder (SLO controller)"] = [res]
    for name, rs in runs.items():
        print(f"mamba2 {name}: {_fmt(rs[0])}")
    print(f"mamba2 ladder: transitions {res['transitions']}, residency per "
          f"rung {res['residency']}, 0 builds after warmup")
    rung_table("mamba2", runs)
    pol, rsp = loaded.rung(1)
    gve = ssm_graph_vs_eager(dev, cfg, params, None, trace,
                             modes=(("calibrated 0.5", pol, rsp),))
    del ladder, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return {"calibration": times, "rungs": rungs,
            "runs": {n: {k: v for k, v in r[0].items()
                         if k not in ("tokens", "token_rungs")}
                     for n, r in runs.items()},
            "graph_vs_eager": gve}


def mamba_serve_cli(dev) -> dict:
    """The serve CLI on the card, each in a subprocess that must exit 0:
    ``--arch mamba2_130m --mode pallas`` at full width (4 prompts of 64
    tokens, 8 new tokens each) and ``--arch jamba_v01_52b --reduced``."""
    from repro_torch import obs
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    res = {}
    for tag, argv in (
            ("mamba2_130m", ["--arch", "mamba2_130m", "--mode", "pallas",
                             "--batch", "4", "--prompt-len", "64", "--gen",
                             "8"]),
            ("jamba_v01_52b --reduced", ["--arch", "jamba_v01_52b",
                                         "--reduced", "--mode", "pallas",
                                         "--prompt-len", "40", "--gen",
                                         "8"])):
        t0 = obs.now()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            env=env, cwd=HERE, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"serve --arch {tag} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        lines = proc.stdout.strip().splitlines()
        print(f"serve --arch {tag}: exit 0 in {obs.now() - t0:.1f} s; "
              f"{lines[-1] if lines else ''}")
        res[tag] = {"exit": proc.returncode, "wall_s": obs.now() - t0}
    return res


def serve_mamba(dev, K, cli: dict) -> dict:
    """Phase 18: full-width mamba2_130m through the port's ``Engine``
    (8 slots, whole-prompt prefill, the decode step captured once):
    dense, ``pallas``, ``pallas``, dense (uncalibrated: keep_frac =
    k_max_frac = 0.5, tau -inf), and ``pallas`` with
    ``prefill_dense_frac`` 0 (the whole prompts through the kernels, up
    to 3 x 8192 rows); then the busy build and the captured decode step
    against the eager one, a calibrated ladder (:func:`mamba_calibrated`)
    and the serve CLI."""
    from repro_torch import obs
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.launch import constants
    from repro_torch.launch.roofline import step_costs
    from repro_torch.models.ssm import chunk_len
    from repro_torch.serving import EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    t_phase = obs.now()
    cfg, params = mamba_model(dev)
    trace = mamba_trace(cfg)
    print(f"phase 18 trace: prompt lengths {trace['lens']}, "
          f"{trace['gen']} new tokens each, {trace['ecfg']}; SSD chunk "
          f"length L at 8192: {chunk_len(8192, cfg.ssm_chunk)}, at 4099: "
          f"{chunk_len(4099, cfg.ssm_chunk)}")
    if chunk_len(4099, cfg.ssm_chunk) != 1:
        raise AssertionError("4099 should fall to L = 1")
    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    modes = {"dense": (SparsityPolicy.dense(), None),
             "pallas": (SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
                        sp)}
    ecfg = EngineConfig(**trace["ecfg"])
    runs = {}
    for name in ("dense", "pallas", "pallas", "dense"):
        pol, s = modes[name]
        res = ssm_run(name, params, cfg, pol, s, trace, dev, K)
        if name in runs and res["tokens"] != runs[name][0]["tokens"]:
            raise AssertionError(f"mamba2 {name}: the second run's greedy "
                                 "tokens differ from the first's")
        runs.setdefault(name, []).append(res)
    pol, s = modes["pallas"]
    runs["pallas sparse prefill"] = [ssm_run(
        "pallas sparse prefill", params, cfg, pol, s, trace, dev, K,
        frac=0.0)]
    state = runs["dense"][0]["state_bytes"]
    bounds = {}
    for name, (pol, s) in modes.items():
        _, nbytes = step_costs(cfg, ecfg, pol, s, "decode")
        bounds[name] = {
            "decode_step_gb": nbytes / 1e9,
            "state_gb": 2 * state / 1e9,
            "weights_and_rest_gb": (nbytes - 2 * state) / 1e9,
            "decode_step_bound_ms": 1e3 * nbytes / constants.HBM_BW}
        print(f"mamba2 {name} decode step bytes (step_costs): "
              f"{nbytes / 1e9:.4f} GB = {2 * state / 1e9:.4f} GB of conv "
              f"windows and SSM state (read and written) + "
              f"{(nbytes - 2 * state) / 1e9:.4f} GB of weights, head and "
              f"the rest; bound {bounds[name]['decode_step_bound_ms']:.3f} "
              "ms at 3.35 TB/s")
    keys = ("decode_tok_s", "decode_step_p50_ms", "decode_step_p95_ms",
            "ttft_p50_ms", "window_step_device_ms", "decode_device_busy",
            "wall_s", "sparse_passes", "decode_retraces_after_warmup",
            "distinct_tokens")
    for name, rs in runs.items():
        for i, r in enumerate(rs):
            pre = ", ".join(f"{n}x{b} {ms:.1f}" for n, b, ms in
                            r["whole_prefills"])
            print(f"mamba2 {name} {i + 1}: " + ", ".join(
                f"{k} {r[k]:.4g}" if isinstance(r[k], float)
                else f"{k} {r[k]}" for k in keys)
                + f"; launches {r['launches']} ({r['launches_per_pass']} "
                f"per sparse pass); whole-prefill ms per prompt length x "
                f"batch: {pre}")
    gve = ssm_graph_vs_eager(dev, cfg, params, sp, trace)
    calibrated = mamba_calibrated(dev, K, cfg, params, sp, trace)
    for name in ("dense", "pallas"):
        rs = runs[name]
        print(f"mamba2 {name}: greedy tokens equal in both runs; decode p50 "
              f"{rs[0]['decode_step_p50_ms']:.3f} / "
              f"{rs[1]['decode_step_p50_ms']:.3f} ms, device ms per traced "
              f"decode step {rs[0]['window_step_device_ms']:.3f} / "
              f"{rs[1]['window_step_device_ms']:.3f} (bound "
              f"{bounds[name]['decode_step_bound_ms']:.3f})")
    print(f"mamba2 greedy tokens equal to dense at the same position: "
          f"{agreement(runs['dense'][0], runs['pallas'][0]):.3f} (random "
          "weights; informative only)")
    out = {"runs": {f"{n} {i + 1}": {k: v for k, v in r.items()
                                      if k != "tokens"}
                    for n, rs in runs.items() for i, r in enumerate(rs)},
           "step_bounds": bounds, "graph_vs_eager": gve, "serve_cli": cli,
           "trace_lens": trace["lens"], "calibrated": calibrated}
    del params, sp
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = obs.now() - t_phase
    print(f"phase 18 took {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 19: training on the card
# ---------------------------------------------------------------------------

# 19a: examples/train_then_sparsify.py's recipe on reduced llama31_8b
TRAIN_RECIPE = dict(arch="llama31_8b", use_reduced=True, steps=200,
                    batch=8, seq=96, lr=5e-3)
TRAIN_CKPT_EVERY, TRAIN_PREEMPT_AT = 50, (120,)
# card against CPU, each step's loss (f32, TF32 off): read at 1.43e-6
# (this script on an NVIDIA H100 80GB HBM3 at 700 W), about a seventh of
# this limit, which is the one-step bound of tests/test_torch_gpu.py; the
# same recipe with TF32 products is the control the limit must reject
TRAIN_LOSS_TOL = 1e-5
SPARSITIES = (0.3, 0.4, 0.5)
# the reduced model's pallas block: 4 blocks of its 64 input channels
REDUCED_BLOCK = 16
# 19b: full-width gemma2_2b, SERVE_DEPTH of its 26 layers
# (:func:`served_depth`), no checkpoints
GEMMA_TRAIN = dict(arch="gemma2_2b", use_reduced=False, steps=30, batch=2,
                   seq=1024, lr=1e-3)


def eval_metrics(params, cfg, data_cfg, dev, per_depth_sp=None) -> dict:
    """Held-out ppl, and KL and top-1 agreement against dense, under
    ``mask`` with ``per_depth_sp`` (``benchmarks/common.eval_metrics``)."""
    from repro_torch.core import unstacked as U
    from repro_torch.data import eval_batch
    from repro_torch.sparsity import SparsityPolicy

    toks = torch.from_numpy(eval_batch(data_cfg, n=4)).to(dev)
    policy = SparsityPolicy.uniform("mask") if per_depth_sp is not None \
        else SparsityPolicy.dense()
    with torch.no_grad():
        logits, _ = U.forward_unstacked(params, cfg, toks,
                                        per_depth_sp=per_depth_sp,
                                        policy=policy)
        dense, _ = U.forward_unstacked(params, cfg, toks)
    lg = logits[:, :-1].float()
    lab = toks[:, 1:].long()
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, lab[..., None])[..., 0]
    pd = torch.log_softmax(dense.float(), -1)
    ps = torch.log_softmax(logits.float(), -1)
    return {"ppl": math.exp(float(nll.mean())),
            "kl": float((pd.exp() * (pd - ps)).sum(-1).mean()),
            "top1_agree": float((logits.argmax(-1) == dense.argmax(-1))
                                .float().mean())}


def spec_acceptance(name, params, cfg, data_cfg, dev, K, evo) -> dict:
    """Calibrate a ``pallas`` ladder (0.0, 0.5) on ``params`` with the
    example's search budget and serve 8 held-out prompts of the synthetic
    language through the spec engine, gamma 2, the 0.5 rung drafting
    (``serve_once`` checks its launches)."""
    from repro_torch.core import calibration
    from repro_torch.data import SyntheticLM
    from repro_torch.serving import SpecConfig
    from repro_torch.sparsity import PolicyLadder, calibrate_ladder

    calib = SyntheticLM(dataclasses.replace(data_cfg, global_batch=4)
                        ).batch(991)
    ctx = calibration.build_context(params, cfg, {"tokens": calib})
    lad = calibrate_ladder(params, cfg, None, (0.0, 0.5), backend="pallas",
                           evo=evo, delta=0.25, coord_passes=0, ctx=ctx,
                           quality_baselines=False)
    lad = PolicyLadder(budgets=lad.budgets, policies=tuple(
        dataclasses.replace(p, block=REDUCED_BLOCK) for p in lad.policies),
        sps=lad.sps, block_ratios=lad.block_ratios)
    toks = SyntheticLM(dataclasses.replace(data_cfg, global_batch=8)
                       ).batch(20_000_000)[:, :48]
    trace = {"prompts": list(toks), "gen": 32,
             "ecfg": dict(max_slots=8, max_len=128, prefill_chunk=16)}
    res = serve_once(name, params, cfg, None, None, trace, dev, K,
                     ladder=lad, spec=SpecConfig(gamma=2, drafter_rung=1),
                     window=0)
    if res["verify_retraces_after_warmup"] != 0:
        raise AssertionError(f"{name}: verify builds after warmup")
    return res


@contextlib.contextmanager
def init_from(params):
    """``launch.train.train`` starts from a copy of ``params`` in the
    block, not from its seed's init on its device."""
    from repro_torch.models import api, params as P
    seeded = api.init_model
    api.init_model = lambda cfg, seed, device: P.tree_map(
        lambda t: t.to(device, copy=True), params)
    try:
        yield
    finally:
        api.init_model = seeded


@contextlib.contextmanager
def tf32_products():
    """TF32 on for the f32 products in the block (19a's control run)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def card_against_cpu(dev) -> dict:
    """19a's trainer checks: the recipe on the card through the runner
    twice (checkpoints every 50 steps; one run preempted at step 120),
    which must end bit-equal; on the CPU from the card run's init, each
    step's loss the card's must match within ``TRAIN_LOSS_TOL``; and once
    more on the card with TF32 products, the control whose distance to
    the CPU's losses is returned beside the card's."""
    import shutil

    from repro_torch import obs
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import train
    from repro_torch.models import api, params as P

    root = os.path.join(HERE, "build", "chip_smoke", "train")
    shutil.rmtree(root, ignore_errors=True)
    # the card run's init, for the CPU run: one seed draws other numbers
    # from the card's generator than from the CPU's
    init = P.tree_map(lambda t: t.cpu(), api.init_model(
        reduced(get_config(TRAIN_RECIPE["arch"])), SEED, device=dev))
    logs = []
    runs = {}
    for name, kw in (("uninterrupted", {}),
                     ("preempted", {"fail_at": TRAIN_PREEMPT_AT})):
        t = obs.now()
        runs[name] = train(**TRAIN_RECIPE, ckpt_every=TRAIN_CKPT_EVERY,
                           ckpt_dir=os.path.join(root, name), device=dev,
                           log=logs.append, **kw)
        torch.cuda.synchronize()
        runs[name] += (obs.now() - t,)
    shutil.rmtree(root, ignore_errors=True)
    params, cfg, data_cfg, hist, final, card_s = runs["uninterrupted"]
    pre = runs["preempted"]
    if not any(f"simulated preemption at step {TRAIN_PREEMPT_AT[0]}" in m
               for m in logs):
        raise AssertionError(f"19a: no preemption in the logs {logs}")
    unequal = [i for i, (a, b) in enumerate(zip(_leaves(params),
                                                _leaves(pre[0])))
               if not torch.equal(a, b)]
    if unequal or pre[4] != final:
        raise AssertionError(f"19a: the resumed run's params differ from "
                             f"the uninterrupted run's at leaves {unequal} "
                             f"(held-out {pre[4]} against {final})")
    t = obs.now()
    with init_from(init):
        _p, _c, _d, cpu_hist, cpu_final = train(**TRAIN_RECIPE, device="cpu",
                                                log=lambda *a: None)
    cpu_s = obs.now() - t
    with tf32_products():
        tf32_hist = train(**TRAIN_RECIPE, device=dev, log=lambda *a: None)[3]

    def err(h):
        return max(abs(a["loss"] - b["loss"])
                   for a, b in zip(h, cpu_hist, strict=True))
    return {"params": params, "cfg": cfg, "data_cfg": data_cfg,
            "hist": hist, "final": final, "card_s": card_s,
            "preempted_s": pre[5], "preempted_steps": len(pre[3]),
            "cpu_s": cpu_s, "cpu_final": cpu_final,
            "loss_err": err(hist), "tf32_loss_err": err(tf32_hist)}


def train_then_sparsify(dev, K, random_accept: float) -> dict:
    """Phase 19a: ``examples/train_then_sparsify.py`` on the card.  The
    trainer's checks (``card_against_cpu``: resume bit-equal, losses
    within ``TRAIN_LOSS_TOL`` of the CPU's, which the TF32 control must
    miss), then WiSparse at 0.3/0.4/0.5 (paper Alg. 1-4, the example's
    budget) with held-out ppl, retention and top-1 agreement under
    ``mask``, and spec decoding on the trained model and on its random
    init."""
    from repro_torch import obs
    from repro_torch.core import calibration, pipeline
    from repro_torch.core.allocation import EvoConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.models import api

    t0 = obs.now()
    tr = card_against_cpu(dev)
    params, cfg, data_cfg = tr["params"], tr["cfg"], tr["data_cfg"]
    hist, final, loss_err = tr["hist"], tr["final"], tr["loss_err"]
    if not loss_err <= TRAIN_LOSS_TOL:
        raise AssertionError(f"19a: card and CPU losses differ by "
                             f"{loss_err} > {TRAIN_LOSS_TOL}")
    if not tr["tf32_loss_err"] > TRAIN_LOSS_TOL:
        raise AssertionError(f"19a: with TF32 products the card's losses "
                             f"are within {tr['tf32_loss_err']} of the "
                             f"CPU's, so {TRAIN_LOSS_TOL} cannot tell TF32 "
                             f"from f32")
    print(f"19a train_then_sparsify recipe ({TRAIN_RECIPE}, checkpoints "
          f"every {TRAIN_CKPT_EVERY}): loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}, held-out {final:.4f}; card run "
          f"{tr['card_s']:.1f} s, preempted run {tr['preempted_s']:.1f} s "
          f"({tr['preempted_steps']} steps executed), resumed params "
          f"bit-equal to the uninterrupted run's; CPU run {tr['cpu_s']:.1f}"
          f" s, per-step loss card vs CPU max abs err {loss_err:.3g} (<= "
          f"{TRAIN_LOSS_TOL}; with TF32 products {tr['tf32_loss_err']:.3g})"
          f", held-out {tr['cpu_final']:.4f}")
    evo = EvoConfig(generations=4, offspring=8, eps=0.1)
    calib = SyntheticLM(dataclasses.replace(data_cfg, global_batch=4)
                        ).batch(991)
    t = obs.now()
    ctx = calibration.build_context(params, cfg, {"tokens": calib})
    dense = eval_metrics(params, cfg, data_cfg, dev)
    quality = {"dense_ppl": dense["ppl"]}
    for p in SPARSITIES:
        plan = pipeline.run_pipeline(params, cfg, {"tokens": calib}, p,
                                     evo=evo, delta=0.25, coord_passes=0,
                                     ctx=ctx)
        m = eval_metrics(params, cfg, data_cfg, dev, plan.per_depth_sp)
        m["retention"] = dense["ppl"] / m["ppl"]
        quality[str(p)] = m
        print(f"19a WiSparse@{p:.0%}: ppl {m['ppl']:.4f} (dense "
              f"{dense['ppl']:.4f}), retention {m['retention']:.4f}, "
              f"top-1 agreement {m['top1_agree']:.4f}, KL {m['kl']:.4g}")
        if not (np.isfinite(m["ppl"]) and m["top1_agree"] > 0):
            raise AssertionError(f"19a: WiSparse@{p} gave {m}")
    calib_s = obs.now() - t
    t = obs.now()
    spec = {"trained": spec_acceptance("19a spec trained", params, cfg,
                                       data_cfg, dev, K, evo),
            "random init": spec_acceptance(
                "19a spec random init",
                api.init_model(cfg, SEED, device=dev), cfg, data_cfg, dev,
                K, evo)}
    for name, r in spec.items():
        print(f"19a spec decoding, {name} reduced llama31_8b (gamma 2, "
              f"drafter: the 0.5 rung of a pallas ladder calibrated on "
              f"it): acceptance rate {r['spec']['accept_rate']:.4f}, "
              f"accepted per verify {r['spec']['accepted_per_verify']:.4f}, "
              f"distinct tokens {r['distinct_tokens']}; {_fmt(r)}")
    print(f"19a acceptance: trained {spec['trained']['spec']['accept_rate']:.4f}"
          f", random init {spec['random init']['spec']['accept_rate']:.4f}, "
          f"full-width random llama31_8b (phase 11) {random_accept:.4f}")
    out = {"losses": [h["loss"] for h in hist], "final": final,
           **{k: tr[k] for k in ("card_s", "preempted_s", "preempted_steps",
                                 "cpu_s", "tf32_loss_err")},
           "card_vs_cpu_loss_err": loss_err, "quality": quality,
           "calibration_s": calib_s, "spec_s": obs.now() - t,
           "spec": {n: {"accept_rate": r["spec"]["accept_rate"],
                        "accepted_per_verify":
                            r["spec"]["accepted_per_verify"],
                        "decode_tok_s": r["decode_tok_s"],
                        "distinct_tokens": r["distinct_tokens"],
                        "launches": r.get("launches")}
                    for n, r in spec.items()},
           "spec_full_width_random": random_accept,
           "wall_s": obs.now() - t0}
    del params, tr
    gc.collect()
    return out


def train_flops(cfg, n_params: int, batch: int, seq: int) -> float:
    """FLOPs of one train step: 6 per parameter per token, plus the
    attention products (QK and PV, forward and the backward's two each:
    12 B S^2 H hd per layer, every score computed, as the port does)."""
    attn = 12 * batch * seq * seq * cfg.num_heads * cfg.head_dim * \
        cfg.num_layers
    return 6.0 * n_params * batch * seq + attn


@contextlib.contextmanager
def served_depth(module):
    """While it is open, ``module.get_config`` (a launcher's) gives the
    published config cut to SERVE_DEPTH layers."""
    real = module.get_config
    module.get_config = lambda arch: dataclasses.replace(
        real(arch), num_layers=SERVE_DEPTH)
    try:
        yield
    finally:
        module.get_config = real


def train_step_breakdown(cfg, params, opt, ocfg, toks, top: int = 10
                         ) -> dict:
    """Train steps of ``params`` split on the host clock (each part ends
    in a synchronize): the loss's forward and backward, then the AdamW
    update, twice, the second kept; then one whole step under
    ``torch.profiler`` for its ``top`` operators by device time (the
    kernels each ATen op launched)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.launch.train import deterministic
    from repro_torch.models import api, params as P
    from repro_torch.optim import adamw

    loss_fn = api.make_loss_fn(cfg)
    leaves = P.tree_leaves(params)
    with deterministic():
        for _ in range(2):
            torch.cuda.synchronize()
            t = obs.now()
            for leaf in leaves:
                leaf.requires_grad_(True)
            loss = loss_fn(params, {"tokens": toks})
            grads = torch.autograd.grad(loss, leaves)
            for leaf in leaves:
                leaf.requires_grad_(False)
            torch.cuda.synchronize()
            fwd_bwd = obs.now() - t
            t = obs.now()
            adamw.update(P.tree_unflatten_like(params, list(grads)), opt,
                         params, ocfg)
            torch.cuda.synchronize()
            update = obs.now() - t
            del grads, loss
        step = api.make_train_step(cfg, ocfg)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, opt, {"tokens": toks})
            torch.cuda.synchronize()
    ev = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
          if e.device_type == DeviceType.CPU and e.self_device_time_total]
    total = sum(ms for _, ms in ev)
    ev.sort(key=lambda e: -e[1])
    rows = [[k, ms, ms / total] for k, ms in ev[:top]]
    print(f"19b one step split: forward + backward {1e3 * fwd_bwd:.1f} ms, "
          f"AdamW update {1e3 * update:.1f} ms; one step traced: "
          f"{total:.1f} ms on the device, top ATen ops " + "; ".join(
              f"{k} {ms:.1f} ms ({100 * f:.0f}%)" for k, ms, f in rows))
    return {"fwd_bwd_s": fwd_bwd, "update_s": update,
            "device_ms": total, "top_ops": rows}


def gemma_steps(dev, rates) -> tuple:
    """19b's training: full-width gemma2_2b (bf16 params; f32 master, m
    and v), its first SERVE_DEPTH layers (:func:`served_depth`), 30 steps
    through ``launch.train.train``: every loss finite,
    the last below the first; step time p50, tokens/s, MFU and peak
    memory.  Returns (params, cfg, data_cfg, numbers)."""
    from repro_torch.launch import train as T
    from repro_torch.serving.metrics import percentile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with served_depth(T):
        params, cfg, data_cfg, hist, final = T.train(
            **GEMMA_TRAIN, device=dev, log=lambda *a: None)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"19b: losses {losses}")
    n_params = sum(t.numel() for t in _leaves(params))
    state_gb = n_params * (2 + 2 + 12) / 1e9      # params, grads, f32 x 3
    tokens = GEMMA_TRAIN["batch"] * GEMMA_TRAIN["seq"]
    step_s = [h["step_s"] for h in hist]
    p50 = percentile(step_s[1:], 50)
    flops = train_flops(cfg, n_params, GEMMA_TRAIN["batch"],
                        GEMMA_TRAIN["seq"])
    res = {"losses": losses, "held_out": final, "n_params": n_params,
           "step_s": step_s, "step_p50_s": p50, "first_step_s": step_s[0],
           "tokens_per_s": tokens / p50, "flops_per_step": flops,
           "mfu": flops / p50 / rates.flops_bf16,
           "peak_gb": peak / 1e9, "state_gb": state_gb,
           "logits_gb": tokens * cfg.vocab_size * 4 / 1e9}
    print(f"19b gemma2_2b full width, {cfg.num_layers} of 26 layers "
          f"({n_params / 1e9:.2f}B params, "
          f"{GEMMA_TRAIN}): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(held-out {final:.4f}), all {len(losses)} finite; step p50 "
          f"{1e3 * p50:.1f} ms (first {1e3 * step_s[0]:.1f}), "
          f"{res['tokens_per_s']:.0f} tokens/s, MFU {res['mfu']:.4f} "
          f"({flops / 1e12:.2f} TFLOP per step over "
          f"{rates.flops_bf16 / 1e12:.0f} TFLOP/s); peak allocated "
          f"{res['peak_gb']:.1f} GB against {state_gb:.1f} GB of state + "
          f"{res['logits_gb']:.1f} GB of f32 logits per copy")
    return params, cfg, data_cfg, res


def train_gemma(dev, K, rates) -> dict:
    """Phase 19b: ``gemma_steps``, then one step at ``remat="full"`` on a
    copy of the trained params with a fresh optimizer, an async
    checkpoint round trip of the trained params (bit-equal), and the
    restored params served dense and ``pallas`` (keep 0.5, uncalibrated)
    on phase 16's 8 short prompts."""
    import shutil

    from repro_torch import obs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import deterministic
    from repro_torch.models import api, params as P
    from repro_torch.optim import adamw
    from repro_torch.sparsity import SparsityPolicy

    t0 = obs.now()
    params, cfg, data_cfg, res = gemma_steps(dev, rates)

    # on a copy of the trained params, with a fresh optimizer: the
    # step's split, its top kernels, then one step at remat="full"
    ocfg = adamw.AdamWConfig(lr_peak=GEMMA_TRAIN["lr"], warmup_steps=5,
                             decay_steps=GEMMA_TRAIN["steps"])
    copy = P.tree_map(torch.clone, params)
    opt = adamw.init(copy, ocfg)
    toks = torch.from_numpy(SyntheticLM(data_cfg).batch(
        GEMMA_TRAIN["steps"])).to(dev)
    res["breakdown"] = train_step_breakdown(cfg, copy, opt, ocfg, toks)
    step = api.make_train_step(cfg, ocfg, remat="full")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t = obs.now()
    with deterministic():
        copy, opt, m = step(copy, opt, {"tokens": toks})
        remat_loss = float(m["loss"])
    res["remat_full_step_s"] = obs.now() - t
    res["remat_full_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["remat_full_step_peak_over_state_gb"] = \
        (torch.cuda.max_memory_allocated() - base) / 1e9
    if not np.isfinite(remat_loss):
        raise AssertionError(f"19b: remat full loss {remat_loss}")
    print(f"19b one step at remat='full': {1e3 * res['remat_full_step_s']:.1f}"
          f" ms, loss {remat_loss:.4f}, peak allocated "
          f"{res['remat_full_peak_gb']:.1f} GB "
          f"({res['remat_full_step_peak_over_state_gb']:.1f} GB above the "
          f"optimizer state and both param copies)")
    del copy, opt, step, m
    gc.collect()
    torch.cuda.empty_cache()

    # async checkpoint round trip
    ck_dir = os.path.join(HERE, "build", "chip_smoke", "gemma_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    mgr = CheckpointManager(ck_dir, keep=1, async_save=True)
    t = obs.now()
    mgr.save(GEMMA_TRAIN["steps"], params, {"arch": cfg.name})
    res["ckpt_snapshot_ms"] = 1e3 * (obs.now() - t)
    t = obs.now()
    mgr.wait()
    res["ckpt_write_s"] = obs.now() - t
    res["ckpt_bytes"] = os.path.getsize(os.path.join(
        ck_dir, f"step_{GEMMA_TRAIN['steps']:08d}", "arrays.npz"))
    t = obs.now()
    restored, meta = mgr.restore(params)
    torch.cuda.synchronize()
    res["ckpt_restore_s"] = obs.now() - t
    unequal = [i for i, (a, b) in enumerate(zip(_leaves(params),
                                                _leaves(restored)))
               if not (a.dtype == b.dtype and a.device == b.device
                       and torch.equal(a, b))]
    if unequal or meta["step"] != GEMMA_TRAIN["steps"]:
        raise AssertionError(f"19b: restored leaves {unequal} differ "
                             f"(meta {meta})")
    print(f"19b checkpoint (async): snapshot {res['ckpt_snapshot_ms']:.0f} "
          f"ms on the calling thread, write {res['ckpt_write_s']:.1f} s "
          f"({res['ckpt_bytes'] / 1e9:.2f} GB), restore "
          f"{res['ckpt_restore_s']:.1f} s, every leaf bit-equal")
    del params
    shutil.rmtree(ck_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # serve the restored params
    full = gemma_trace(cfg)
    short = {"prompts": full["prompts"][4:], "lens": full["lens"][4:],
             "gen": full["gen"], "ecfg": full["ecfg"]}
    sp = default_sp_stacked(restored, cfg, keep_frac=KEEP,
                            tau=float("-inf"))
    served = {
        "dense": gemma_run("19b trained dense", restored, cfg,
                           SparsityPolicy.dense(), None, short, dev, K),
        "pallas": gemma_run("19b trained pallas", restored, cfg,
                            SparsityPolicy.uniform("pallas",
                                                   k_max_frac=KEEP),
                            sp, short, dev, K)}
    res["served_agreement"] = agreement(served["dense"], served["pallas"])
    for name, r in served.items():
        print(f"19b trained gemma2_2b served {name}: distinct tokens "
              f"{r['distinct_tokens']} (random weights: 12 per run), "
              f"decode p50 {r['decode_step_p50_ms']:.2f} ms, launches "
              f"{r['launches']} ({r['sparse_passes']} sparse passes)")
    print(f"19b pallas/dense token agreement on the trained weights "
          f"{res['served_agreement']:.4f}")
    res["served"] = {n: {k: v for k, v in r.items() if k != "tokens"}
                     for n, r in served.items()}
    del restored, sp, served
    gc.collect()
    torch.cuda.empty_cache()
    res["wall_s"] = obs.now() - t0
    return res


def train_on_card(dev, K, rates, random_accept: float) -> dict:
    """Phase 19: 19a then 19b."""
    from repro_torch import obs
    t0 = obs.now()
    out = {"train_then_sparsify": train_then_sparsify(dev, K, random_accept),
           "gemma2_2b": train_gemma(dev, K, rates)}
    out["wall_s"] = obs.now() - t0
    print(f"phase 19 took {out['wall_s']:.1f} s")
    return out


def train_only(dev, card: str, src: str) -> int:
    """``--train-only``: 19a's ``card_against_cpu`` and 19b's
    ``gemma_steps`` for the package under ``src``, one JSON line."""
    from repro_torch.launch import constants
    tr = card_against_cpu(dev)
    del tr["params"], tr["cfg"], tr["data_cfg"]
    tr["losses"] = [h["loss"] for h in tr.pop("hist")]
    _p, _c, _d, res = gemma_steps(dev, constants.peak_rates(card))
    print(json.dumps({"train_only": {"src": src, "19a": tr, "19b": res}}))
    return 0


# ---------------------------------------------------------------------------
# phase 20: whisper_large_v3 and internvl2_26b at full width
# ---------------------------------------------------------------------------


# phase 20's traces: whisper_large_v3 serves (a) 4 utterances of its 1500
# frames, each with a 4-token decoder start sequence, and (b) one with a
# 224-token text prompt (its prompt conditioning, inside the 448-token
# decoder context), 64 new tokens each; internvl2_26b serves 2 sequences
# of its 256 patch embeddings and 128 text tokens, 32 new tokens each
WHISPER_RUNS = {"a": (4, 4), "b": (1, 224)}
WHISPER_GEN = 64
INTERNVL_RUN = (2, 128)
INTERNVL_GEN = 32
# whisper's calibration batch (the serve CLI's --calib-quick stages) and
# its training: 20 steps on one batch of 2 x 448 tokens over 1500 frames,
# every layer recomputed in the backward (remat "full": the f32 attention
# scores of one encoder layer take B * H * F * F * 4 = 360 MB at B = 2).
# One batch, since on a fresh synthetic batch per step the random-init
# model's loss did not fall in 20 steps (11.04 -> 11.06 on an NVIDIA H100
# 80GB HBM3 at 700 W: its residual stream is the sinusoidal positions)
WHISPER_CALIB = (2, 64)
WHISPER_TRAIN = dict(steps=20, batch=2, seq=448, lr=1e-3, remat="full")


def generate(params, cfg, tokens, gen: int, *, policy=None, sp=None,
             frames=None, patch_embeds=None, times=None, steps=None, key=0,
             prefill=None):
    """Greedy tokens (B, gen) of the static-batch loop, which the enc-dec
    and VLM families take (the engine refuses them, as the reference's
    does): ``api.make_prefill_step`` over the prompt with its frames or
    patch embeddings under ``prefill`` (a (policy, sp) pair; default
    ``policy`` and ``sp``), the caches padded to prefix + prompt + ``gen``
    positions (``api.pad_caches``), then ``gen - 1`` decode steps, every
    row at one position: with ``steps`` (a
    ``serving.graphs.BatchDecodeSteps`` at (B, prefix + prompt + gen)),
    its key ``key`` over the padded caches copied in, the captured step
    on the card (``BatchDecodeSteps.decode``); without, the eager
    control, ``api.make_decode_step`` under ``policy`` and ``sp`` with
    each step's tokens read to the host.  ``times``, a dict, gets the
    prefill's host ms and each decode step's (``prefill_ms``,
    ``decode_ms``), each until its tokens are ready (a graph step synced
    for that reading only)."""
    import time

    from repro_torch.models import api
    B, S = tokens.shape
    start = S + (0 if patch_embeds is None else patch_embeds.shape[1])
    pre_policy, pre_sp = prefill or (policy, sp)
    decode = api.make_decode_step(cfg, policy)
    step_ms = []
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, caches = api.make_prefill_step(cfg)(
            params, tokens, pre_sp, pre_policy, frames=frames,
            patch_embeds=patch_embeds)
        caches = api.pad_caches(cfg, caches, B, start + gen)
        tok = torch.argmax(logits, -1)
        if steps is not None:
            tok.cpu()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            out = steps.decode(key, caches, tok, start, gen,
                               times=step_ms).cpu()
        else:
            out = [tok.cpu()]
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            for i in range(gen - 1):
                t0 = time.perf_counter()
                logits, caches = decode(params, {
                    "tokens": tok, "caches": caches,
                    "positions": torch.full((B,), start + i,
                                            dtype=torch.long,
                                            device=tok.device)}, sp)
                tok = torch.argmax(logits, -1)
                out.append(tok.cpu())
                step_ms.append(1e3 * (time.perf_counter() - t0))
            out = torch.stack(out, 1)
    if times is not None:
        times.update(prefill_ms=prefill_ms, decode_ms=step_ms)
    return out


def multimodal_inputs(cfg, batch: int, dev, seed: int) -> dict:
    """Frame embeddings (batch, encoder_frames, d_model) of an enc-dec
    model or patch embeddings (batch, vision_prefix, d_model) of a VLM,
    standard normal in the model dtype, from ``seed`` (both frontends are
    stubs in the reference too)."""
    from repro_torch.models import params as P
    gen = torch.Generator(device=dev).manual_seed(seed)
    key, rows = (("frames", cfg.encoder_frames) if cfg.family == "encdec"
                 else ("patch_embeds", cfg.vision_prefix))
    x = torch.randn(batch, rows, cfg.d_model, device=dev, generator=gen)
    return {key: x.to(P.DTYPES[cfg.dtype])}


def multimodal_passes(cfg) -> tuple:
    """Launches of each 2-D kernel in one sparse prefill and in one sparse
    decode step of an enc-dec or VLM model: per decoder layer its 4
    self-attention projections, an enc-dec layer's 4 cross-attention
    projections in prefill and 2 in decode (``wq``, ``wo``: decode reads
    the static cross cache, and prefill stashes it dense), and the
    MLP's 2 (plain GELU) or 3 (gated).  At MULTIMODAL_DEPTH,
    whisper_large_v3: 40 and 32; internvl2_26b: 28 and 28."""
    from repro_torch.models.mlp import GATED
    cross = cfg.family == "encdec"
    mlp = 3 if cfg.mlp_activation in GATED else 2
    return (cfg.num_layers * (4 + 4 * cross + mlp),
            cfg.num_layers * (4 + 2 * cross + mlp))


def multimodal_run(name, params, cfg, policy, sp, tokens, inputs, gen,
                   K, steps=None, key=0) -> dict:
    """One :func:`generate` run (the captured decode step of ``steps``'
    key ``key``, built before the run, or without ``steps`` the eager
    control), the kernels' launch counts zeroed just before it and read
    just after, each launch a graph recorded counted once per replay: a
    ``pallas`` run launches each 2-D kernel once per projection of its
    prefill and of its ``gen - 1`` decode steps
    (:func:`multimodal_passes`), any other run none, and no run an
    expert kernel."""
    from repro_torch.serving import graphs
    from repro_torch.serving.metrics import percentile

    replays = 0 if steps is None else steps.steps[key]
    K.reset_launch_counts()
    times = {}
    out = generate(params, cfg, tokens, gen, policy=policy, sp=sp,
                   times=times, steps=steps, key=key, **inputs)
    torch.cuda.synchronize()
    counts = dict(K.launch_counts)
    if steps is not None:
        replays = steps.steps[key] - replays
        for k, v in steps.captured[key].items():
            counts[k] += v * replays
    pre, dec = multimodal_passes(cfg)
    kernels = (policy is not None and "pallas" in graphs.backends(policy)
               and sp is not None)
    want = pre + (gen - 1) * dec if kernels else 0
    got = {k: counts[k] for k in ("score_select", "sparse_matmul_shared")}
    if set(got.values()) != {want} or any(
            v for k, v in counts.items() if k not in got):
        raise AssertionError(f"{name}: launches {counts}, expected {want} "
                             f"of each 2-D kernel ({pre} in the prefill, "
                             f"{dec} per decode step)")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{name}: tokens out of the vocabulary")
    return {"tokens": out, "prefill_ms": times["prefill_ms"],
            "decode_p50_ms": percentile(times["decode_ms"], 50),
            "decode_p95_ms": percentile(times["decode_ms"], 95),
            "launches": got["score_select"],
            "distinct_tokens": len(set(out.flatten().tolist()))}


def traced_decode(params, cfg, policy, sp, tokens, inputs, steps=WINDOW,
                  top: int = 8) -> dict:
    """A prefill, one warm decode step, then ``steps`` decode steps under
    ``torch.profiler`` (the card only): device ms per step and the top
    ``top`` operators by device time per step [name, ms, share]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api
    B, S = tokens.shape
    start = S + sum(x.shape[1] for k, x in inputs.items()
                    if k == "patch_embeds")
    decode = api.make_decode_step(cfg, policy)
    with torch.no_grad():
        logits, caches = api.make_prefill_step(cfg)(params, tokens, sp,
                                                    policy, **inputs)
        caches = api.pad_caches(cfg, caches, B, start + steps + 1)

        def step(i, logits, caches):
            return decode(params, {
                "tokens": torch.argmax(logits, -1), "caches": caches,
                "positions": torch.full((B,), start + i, dtype=torch.long,
                                        device=tokens.device)}, sp)

        logits, caches = step(0, logits, caches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                logits, caches = step(i + 1, logits, caches)
            torch.cuda.synchronize()
    ev = [(e.key, e.self_device_time_total / 1e3 / steps)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not ev:
        raise AssertionError("torch.profiler recorded no device time")
    total = sum(ms for _, ms in ev)
    ev.sort(key=lambda e: -e[1])
    return {"device_ms": total,
            "top_ops": [[k[:60], ms, ms / total] for k, ms in ev[:top]]}


def decode_step_bytes(cfg, params, batch: int, cache_len: int,
                      keep: float = 1.0) -> float:
    """Bytes one decode step must read: the decoder layers' projection
    weights (``keep`` of their rows under the block top-k; not the cross
    ``wk``/``wv``, which only the prefill runs), the head, each row's
    self K/V over ``cache_len`` positions and, for enc-dec, its cross
    K/V over the frames; norms and embedding rows are left out (under
    0.1%)."""
    from repro_torch.core.unstacked import SPARSIFIABLE
    from repro_torch.models import params as P
    proj = sum(t.numel() * t.element_size()
               for path, t in P.tree_flatten_with_path(params["groups"])
               if path[-1] in SPARSIFIABLE
               and path[-2:] not in (("cross", "wk"), ("cross", "wv")))
    head = params["embed" if cfg.tie_embeddings else "lm_head"]
    kv = 2 * cfg.num_layers * batch * cfg.num_kv_heads * cfg.head_dim * \
        head.element_size()
    frames = cfg.encoder_frames if cfg.family == "encdec" else 0
    return keep * proj + head.numel() * head.element_size() + \
        kv * (cache_len + frames)


# phase 20's modes, the keys of each run's BatchDecodeSteps, and the
# order of the graph passes (each mode twice); the eager control runs
# each mode once
MODES = ("off", "mask", "pallas")
GRAPH_PASSES = ("off", "mask", "pallas", "pallas", "mask", "off")


def multimodal_modes(tag, params, cfg, sp, runs, gen, K, rates, pol,
                     smi) -> dict:
    """Each of ``runs`` ({name: (tokens, inputs)}) served under each of
    MODES: dense, ``mask`` and ``pol`` (``pallas``; both uncalibrated:
    ``sp`` keeps half the blocks at tau -inf, where ``mask`` keeps
    every channel).  The decode step of each run is a
    ``BatchDecodeSteps`` with one key per mode, each built once before
    the passes; GRAPH_PASSES replays them, each mode's two passes giving
    the same tokens, then the eager control runs each mode once and
    must give the graph's tokens (:func:`multimodal_run`).  A sparse
    step's graph records 64 (whisper) or 56 (internvl2) launches of
    each 2-D kernel.  Then a window of eager decode steps of the first
    run traced dense and ``pallas`` (:func:`traced_decode`) beside the
    step's byte bound, and decode p50 graph against eager, with ``smi``
    (the card's name and power limit).  Returns (the numbers per mode,
    the first run's dense tokens)."""
    from repro_torch.serving.graphs import BatchDecodeSteps
    from repro_torch.sparsity import SparsityPolicy

    pols = {"off": (SparsityPolicy.dense(), None),
            "mask": (SparsityPolicy.uniform("mask"), sp), "pallas": (pol, sp)}
    _, dec = multimodal_passes(cfg)
    out, steps = {}, {}
    for run, (toks, inputs) in runs.items():
        prefix = sum(x.shape[1] for k, x in inputs.items()
                     if k == "patch_embeds")
        st = BatchDecodeSteps(cfg, params, [pols[m] for m in MODES],
                              toks.shape[0], prefix + toks.shape[1] + gen,
                              toks.device)
        for i in range(len(MODES)):
            st.build(i)
        for i, m in enumerate(MODES):
            want = dec if m == "pallas" else 0
            if {k: v for k, v in st.captured[i].items() if v} != {
                    k: want for k in ("score_select", "sparse_matmul_shared")
                    if want}:
                raise AssertionError(f"{tag} run {run} {m}: the decode "
                                     f"graph records {st.captured[i]}, "
                                     f"expected {want} of each 2-D kernel")
        steps[run] = st
    for i, mode in enumerate(GRAPH_PASSES):
        for run, (toks, inputs) in runs.items():
            res = multimodal_run(f"{tag} graph {mode} {i} run {run}", params,
                                 cfg, *pols[mode], toks, inputs, gen, K,
                                 steps=steps[run], key=MODES.index(mode))
            seen = out.setdefault(f"{mode} {run}", [])
            if seen and not torch.equal(seen[0]["tokens"], res["tokens"]):
                raise AssertionError(f"{tag} {mode} run {run}: the second "
                                     "graph pass gave other tokens")
            seen.append(res)
            print(f"{tag} {mode} graph (pass {len(seen)}) run {run} "
                  f"B={toks.shape[0]} prompt {toks.shape[1]}: prefill "
                  f"{res['prefill_ms']:.1f} ms, decode p50 "
                  f"{res['decode_p50_ms']:.2f} ms (p95 "
                  f"{res['decode_p95_ms']:.2f}), launches {res['launches']} "
                  f"of each kernel, {res['distinct_tokens']} distinct tokens",
                  flush=True)
    for mode in MODES:
        for run, (toks, inputs) in runs.items():
            res = multimodal_run(f"{tag} eager {mode} run {run}", params,
                                 cfg, *pols[mode], toks, inputs, gen, K)
            if not torch.equal(res["tokens"], out[f"{mode} {run}"][0][
                    "tokens"]):
                raise AssertionError(f"{tag} {mode} run {run}: the graph's "
                                     "tokens differ from the eager loop's")
            out[f"{mode} {run} eager"] = res
            print(f"{tag} {mode} eager run {run}: prefill "
                  f"{res['prefill_ms']:.1f} ms, decode p50 "
                  f"{res['decode_p50_ms']:.2f} ms (p95 "
                  f"{res['decode_p95_ms']:.2f}), launches {res['launches']} "
                  f"of each kernel; tokens equal the graph's", flush=True)
    for run, st in steps.items():
        if st.builds != len(MODES):
            raise AssertionError(f"{tag} run {run}: {st.builds} builds for "
                                 f"{len(MODES)} keys")
    del steps
    first, (toks, inputs) = next(iter(runs.items()))
    B, S = toks.shape
    prefix = sum(x.shape[1] for k, x in inputs.items()
                 if k == "patch_embeds")
    for mode in ("off", "pallas"):
        tr = traced_decode(params, cfg, *pols[mode], toks, inputs)
        nbytes = decode_step_bytes(cfg, params, B, prefix + S + gen,
                                   1.0 if mode == "off" else KEEP)
        tr["bound_ms"] = 1e3 * nbytes / rates.hbm_bw
        out[f"{mode} traced"] = tr
        print(f"{tag} {mode} run {first}: {tr['device_ms']:.3f} device ms "
              f"per traced decode step against a byte bound of "
              f"{tr['bound_ms']:.3f} ms ({nbytes / 1e9:.3f} GB); top ops "
              + "; ".join(f"{k} {ms:.3f} ms ({100 * f:.0f}%)"
                          for k, ms, f in tr["top_ops"]))
    for mode in MODES:
        for run in runs:
            g = [r["decode_p50_ms"] for r in out[f"{mode} {run}"]]
            e = out[f"{mode} {run} eager"]["decode_p50_ms"]
            tr = out.get(f"{mode} traced") if run == first else None
            print(f"{tag} {mode} run {run}: decode p50 graph "
                  f"{' / '.join(f'{x:.2f}' for x in g)} ms against eager "
                  f"{e:.2f} ms (host, synced per step)"
                  + (f"; {tr['device_ms']:.3f} device ms per traced eager "
                     "step" if tr else "") + f"; {smi}")
    dense = out[f"off {first}"][0]["tokens"]
    agree = float((out[f"pallas {first}"][0]["tokens"] == dense
                   ).float().mean())
    print(f"{tag}: uncalibrated pallas keeps {agree:.3f} of dense's greedy "
          f"tokens on run {first}")
    return {k: ([{n: x for n, x in r.items() if n != "tokens"} for r in v]
                if isinstance(v, list) else
                {n: x for n, x in v.items() if n != "tokens"})
            for k, v in out.items()} | {
        "pallas_token_agreement": agree}, dense


def whisper_calibrated(dev, K, cfg, params, run, dense_tokens) -> dict:
    """A 0.5 plan calibrated on phase 20's whisper (the serve CLI's
    ``--calib-quick`` stages, on WHISPER_CALIB utterances with their
    frames), checked as phase 6 checks its rung (budget, 10 x 32 taus,
    finite wherever sparsified), served as a ``pallas`` policy on
    ``run``: launches per pass as uncalibrated, the share of dense's
    tokens it keeps."""
    from repro_torch import obs
    from repro_torch.core import calibration, pipeline
    from repro_torch.core.allocation import EvoConfig, weighted_average
    from repro_torch.data import DataConfig, SyntheticLM

    evo = EvoConfig(generations=2, offspring=4, eps=0.1)
    B, S = WHISPER_CALIB
    batch = {"tokens": SyntheticLM(DataConfig(cfg.vocab_size, S, B)
                                   ).batch(0),
             **multimodal_inputs(cfg, B, dev, SEED + 3)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = obs.now()
    ctx = calibration.build_context(params, cfg, batch)
    torch.cuda.synchronize()
    t_ctx = obs.now() - t0
    plan = pipeline.run_pipeline(params, cfg, None, KEEP, evo=evo,
                                 delta=0.25, coord_passes=0, ctx=ctx)
    torch.cuda.synchronize()
    calib_s = obs.now() - t0
    kl = ctx.fitness(plan.per_depth_sp)
    avg = weighted_average(ctx, np.asarray(plan.block_ratios))
    if not KEEP - evo.eps <= avg <= KEEP + 1e-9:
        raise AssertionError(f"whisper plan: size-weighted block ratio {avg}")
    if len(plan.taus) != 10 * cfg.num_layers or any(
            plan.layer_ratios[k] > 0 and not math.isfinite(t)
            for k, t in plan.taus.items()):
        raise AssertionError(f"whisper plan: {len(plan.taus)} taus, or a "
                             "sparsified one not finite")
    policy = plan.to_policy(backend="pallas")
    res = multimodal_run("whisper calibrated", params, cfg, policy,
                         plan.stacked_sp, *run, WHISPER_GEN, K)
    agree = float((res.pop("tokens") == dense_tokens).float().mean())
    info = {"calibration_s": calib_s, "context_s": t_ctx, "kl": kl,
            "weighted_ratio": avg, "k_max_frac": policy.k_max_frac,
            "keep_min": 1.0 - max(plan.layer_ratios.values()),
            "keep_max": 1.0 - min(plan.layer_ratios.values()),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "token_agreement": agree, **res}
    print(f"whisper calibrated 0.5 plan: {calib_s:.2f} s (context "
          f"{t_ctx:.2f}; {len(ctx.acts)} linears, cross/wk over "
          f"{ctx.acts[(0, 'cross/wk')].shape[0]} encoder rows), KL "
          f"{kl:.6g}, size-weighted ratio {avg:.4f}, k_max_frac "
          f"{policy.k_max_frac}, keep {info['keep_min']}-{info['keep_max']}"
          f"; served: prefill {res['prefill_ms']:.1f} ms, decode p50 "
          f"{res['decode_p50_ms']:.2f} ms, {res['launches']} launches of "
          f"each kernel, {agree:.3f} of dense's tokens; peak "
          f"{info['peak_gb']:.1f} GB")
    del ctx
    return info


def train_whisper(dev, cfg, params, rates) -> dict:
    """WHISPER_TRAIN's steps of ``api.make_train_step`` on phase 20's
    whisper (bf16 params; f32 master, m and v), all on one batch of
    synthetic tokens over frames from SEED: every loss finite, the last
    below the first; step p50 and peak memory."""
    from repro_torch import obs
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.serving.metrics import percentile

    t = WHISPER_TRAIN
    ocfg = adamw.AdamWConfig(lr_peak=t["lr"], warmup_steps=5,
                             decay_steps=t["steps"])
    data = SyntheticLM(DataConfig(cfg.vocab_size, t["seq"], t["batch"],
                                  seed=SEED))
    batch = {"tokens": torch.from_numpy(data.batch(0)).to(dev),
             **multimodal_inputs(cfg, t["batch"], dev, SEED + 4)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw.init(params, ocfg)
    step = api.make_train_step(cfg, ocfg, remat=t["remat"])
    losses, step_s = [], []
    for _ in range(t["steps"]):
        t0 = obs.now()
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        step_s.append(obs.now() - t0)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"whisper training: losses {losses}")
    res = {"losses": losses, "step_p50_s": percentile(step_s[1:], 50),
           "first_step_s": step_s[0],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"whisper training ({t}): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, all {len(losses)} finite; step p50 "
          f"{1e3 * res['step_p50_s']:.1f} ms (first "
          f"{1e3 * step_s[0]:.1f}); peak allocated {res['peak_gb']:.1f} GB")
    del opt
    return res


def serve_whisper(dev, K, rates, smi) -> dict:
    """Phase 20, whisper_large_v3 at full width (MULTIMODAL_DEPTH encoder
    and decoder layers, bf16, random weights from SEED): the encoder's time;
    WHISPER_RUNS under MODES, graph against eager
    (:func:`multimodal_modes`); a calibrated 0.5 plan served
    (:func:`whisper_calibrated`); then WHISPER_TRAIN's training steps."""
    from repro_torch import obs
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.models import api, model as M
    from repro_torch.sparsity import SparsityPolicy

    cfg = served_config("whisper_large_v3", MULTIMODAL_DEPTH)
    params = api.init_model(cfg, SEED, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    rng = np.random.default_rng(SEED)
    runs = {name: (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                 (B, S))).to(dev),
                   multimodal_inputs(cfg, B, dev, SEED + i))
            for i, (name, (B, S)) in enumerate(WHISPER_RUNS.items())}
    frames = runs["a"][1]["frames"]
    with torch.no_grad():
        M.encode(params, frames, cfg)
        torch.cuda.synchronize()
        t0 = obs.now()
        M.encode(params, frames, cfg)
        torch.cuda.synchronize()
    enc_ms = 1e3 * (obs.now() - t0)
    print(f"whisper_large_v3 full width, {cfg.encoder_layers} + "
          f"{cfg.num_layers} of 32 + 32 layers: {n_params / 1e9:.3f}B params, "
          f"encoder over {tuple(frames.shape)} frames {enc_ms:.1f} ms")
    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=KEEP)
    res, dense_a = multimodal_modes("whisper", params, cfg, sp, runs,
                                    WHISPER_GEN, K, rates, pol, smi)
    del sp
    calibrated = whisper_calibrated(dev, K, cfg, params, runs["a"], dense_a)
    del runs
    torch.cuda.empty_cache()
    training = train_whisper(dev, cfg, params, rates)
    return {"n_params": n_params, "encoder_ms": enc_ms, **res,
            "calibrated": calibrated, "training": training}


def serve_internvl(dev, K, rates, smi) -> dict:
    """Phase 20, internvl2_26b's language model at full width
    (MULTIMODAL_DEPTH of its 48 layers, bf16, random weights from SEED,
    initialised on the card leaf by leaf): INTERNVL_RUN under MODES,
    graph against eager (:func:`multimodal_modes`)."""
    from repro_torch import obs
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.models import api
    from repro_torch.sparsity import SparsityPolicy

    cfg = served_config("internvl2_26b", MULTIMODAL_DEPTH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = obs.now()
    params = api.init_model(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = obs.now() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"internvl2_26b full width, {cfg.num_layers} of 48 layers: "
          f"{n_params / 1e9:.3f}B params "
          f"({torch.cuda.memory_allocated() / 1e9:.1f} GB) initialised in "
          f"{init_s:.1f} s, peak {init_peak:.1f} GB")
    B, S = INTERNVL_RUN
    rng = np.random.default_rng(SEED)
    runs = {"a": (torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (B, S))).to(dev),
                  multimodal_inputs(cfg, B, dev, SEED))}
    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=KEEP)
    res, _ = multimodal_modes("internvl2", params, cfg, sp, runs,
                              INTERNVL_GEN, K, rates, pol, smi)
    return {"n_params": n_params, "init_s": init_s, "init_peak_gb": init_peak,
            **res}


# ---------------------------------------------------------------------------
# phase 21: the serve CLI's --legacy loop (launch/serve.generate)
# ---------------------------------------------------------------------------

# the serve CLI's defaults: SyntheticLM(DataConfig(vocab, 64, 4)).batch(0)
# prompts, 32 new tokens each
LEGACY_RUN = dict(batch=4, prompt_len=64, gen=32)
# the reduced f32 engine-against-generate check (tests/test_serving.py's
# counterpart): 4 prompts of 16 tokens, 8 new tokens each
LEGACY_PARITY = dict(batch=4, prompt_len=16, gen=8)


def legacy_run(name, serve, params, cfg, prompts, gen, policy, sp, K,
               smi) -> dict:
    """One ``serve.generate`` call (the ``--legacy`` loop: dense prefill,
    the decode step built once per call and replayed), the kernels'
    launch counts zeroed just before it and read just after, each launch
    the graph recorded counted once per replay (``graphs.launches`` over
    the ``BatchDecodeSteps`` the call built): a ``pallas`` decode step
    launches each 2-D kernel once per projection (``pass_launches``), in
    the warm call and in each of ``gen - 1`` replays; a dense run none."""
    from unittest import mock

    from repro_torch import obs
    from repro_torch.serving import graphs

    built = []

    class Recorded(graphs.BatchDecodeSteps):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    K.reset_launch_counts()
    t0 = obs.now()
    with mock.patch.object(serve, "BatchDecodeSteps", Recorded):
        toks = serve.generate(params, cfg, prompts, gen, sp, policy=policy)
    dt = obs.now() - t0
    counts = graphs.launches(dict(K.launch_counts), *built)
    per = pass_launches(cfg)["score_select"] if "pallas" in \
        graphs.backends(policy) else 0
    want = {k: gen * per if k in ("score_select", "sparse_matmul_shared")
            else 0 for k in counts}
    if counts != want or [st.builds for st in built] != [1] or \
            built[0].steps != [gen - 1]:
        raise AssertionError(f"{name}: launches {counts} (expected {want}), "
                             f"builds {[st.builds for st in built]}, steps "
                             f"{[st.steps for st in built]}")
    n = toks.numel()
    print(f"{name}: generated {n} tokens in {dt:.3f} s ({n / dt:.1f} tok/s "
          f"on {smi}, the build included), launches "
          f"{counts['score_select']} of each kernel", flush=True)
    return {"tokens": toks, "s": dt, "tok_s": n / dt,
            "launches": counts["score_select"]}


def legacy_cli(B: int, P: int, gen: int) -> dict:
    """``python -m repro_torch.launch.serve --legacy --mode pallas`` at full
    width and full depth (llama31_8b, 32 layers) in a subprocess: it must
    exit 0 and print its tok/s line."""
    from repro_torch import obs
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    argv = ["--legacy", "--arch", "llama31_8b", "--mode", "pallas",
            "--sparsity", str(KEEP), "--prompt-len", str(P), "--gen",
            str(gen), "--batch", str(B)]
    t0 = obs.now()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv],
        env=env, cwd=HERE, capture_output=True, text=True, timeout=300)
    wall = obs.now() - t0
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("generated ")), None)
    if proc.returncode != 0 or line is None:
        raise AssertionError(f"serve {' '.join(argv)} exited "
                             f"{proc.returncode}: {proc.stdout[-1000:]}"
                             f"{proc.stderr[-2000:]}")
    print(f"serve {' '.join(argv)}: exit 0 in {wall:.1f} s; {line}",
          flush=True)
    return {"exit": proc.returncode, "wall_s": wall, "line": line}


def legacy_parity(dev) -> dict:
    """The reference's invariant on the card (tests/test_serving.py:41-57):
    on reduced llama31_8b (f32) the whole-prefill engine's tokens equal
    ``generate``'s for equal-length prompts, dense and under
    ``topk_shared`` at keep 0.5 (exact token parity is a property of f32
    runs)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, SEED, device=dev)
    B, P, gen = (LEGACY_PARITY[k] for k in ("batch", "prompt_len", "gen"))
    prompts = SyntheticLM(DataConfig(cfg.vocab_size, P, B)).batch(0)
    out = {}
    for backend, keep in (("off", 1.0), ("topk_shared", KEEP)):
        sp = None if backend == "off" else default_sp_stacked(
            params, cfg, keep_frac=keep)
        policy = SparsityPolicy.uniform(backend, k_max_frac=keep)
        legacy = serve.generate(params, cfg, prompts, gen, sp,
                                policy=policy).tolist()
        eng = Engine(params, cfg, EngineConfig(
            max_slots=B, max_len=P + gen, prefill_chunk=8, policy=policy,
            prefill_strategy="whole", prefill_dense_frac=1.0), sp,
            device=dev)
        for b in range(B):
            eng.submit(prompts[b], gen)
        got = eng.run()
        if [got[b] for b in range(B)] != legacy:
            raise AssertionError(f"reduced f32 {backend}: engine {got} != "
                                 f"generate {legacy}")
        out[backend] = len({t for row in legacy for t in row})
    print(f"reduced llama31_8b (f32) on the card: the whole-prefill "
          f"engine's tokens equal generate's under off and topk_shared "
          f"({out} distinct tokens)", flush=True)
    return {"distinct_tokens": out}


def serve_legacy(dev, K, smi, cli: dict) -> dict:
    """Phase 21, the ``--legacy`` loop: ``launch/serve.generate`` on
    llama31_8b at full width (SERVE_DEPTH layers, random weights from
    SEED) over the CLI's prompts (LEGACY_RUN), dense and under
    uncalibrated ``pallas`` with the CLI's sp (keep 0.5, tau -inf), each
    called twice (:func:`legacy_run`: the same tokens, 1 build, (1 + gen -
    1) x 56 launches of each kernel, 0 dense), against the loop timed per
    step through a ``BatchDecodeSteps`` and eagerly (:func:`generate`
    with a dense prefill: the same tokens, decode p50 graph against
    eager); then the reduced f32 engine-against-generate check
    (:func:`legacy_parity`).  ``cli`` is the CLI's result at full depth
    (:func:`legacy_cli`, run by :func:`serve_clis`)."""
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.serving.graphs import BatchDecodeSteps
    from repro_torch.sparsity import SparsityPolicy

    cfg, params = full_width_model(dev)
    B, P, gen = (LEGACY_RUN[k] for k in ("batch", "prompt_len", "gen"))
    prompts = torch.from_numpy(SyntheticLM(DataConfig(
        cfg.vocab_size, P, B)).batch(0)).to(dev)
    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    pols = {"off": (SparsityPolicy.dense(), None),
            "pallas": (SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
                       sp)}
    out = {}
    for mode in ("off", "pallas", "pallas", "off"):
        policy, s = pols[mode]
        res = legacy_run(f"legacy {mode}", serve, params, cfg, prompts, gen,
                         policy, s, K, smi)
        seen = out.setdefault(mode, [])
        if seen and not torch.equal(seen[0]["tokens"], res["tokens"]):
            raise AssertionError(f"legacy {mode}: a second generate gave "
                                 "other tokens")
        seen.append(res)
    # the same loop, timed per step: through a BatchDecodeSteps built
    # before the run (the graph) and eagerly
    st = BatchDecodeSteps(cfg, params, [(p.for_phase("decode"), s)
                                        for p, s in pols.values()],
                          B, P + gen, dev)
    for i, (mode, (policy, s)) in enumerate(pols.items()):
        st.build(i)
        for path, steps in (("graph", st), ("eager", None)):
            times = {}
            got = generate(params, cfg, prompts, gen,
                           policy=policy.for_phase("decode"), sp=s,
                           prefill=(policy.for_phase("prefill_dense"), None),
                           times=times, steps=steps, key=i)
            if not torch.equal(got, out[mode][0]["tokens"]):
                raise AssertionError(f"legacy {mode}: the {path} loop's "
                                     "tokens differ from generate's")
            out[f"{mode} {path}_step_p50_ms"] = float(np.median(
                times["decode_ms"]))
        print(f"legacy {mode}: tokens equal the eager loop's; decode p50 "
              f"graph {out[f'{mode} graph_step_p50_ms']:.2f} ms against "
              f"eager {out[f'{mode} eager_step_p50_ms']:.2f} ms (host, "
              f"synced per step); {smi}")
    del st
    agree = float((out["pallas"][0]["tokens"] == out["off"][0]["tokens"]
                   ).float().mean())
    print(f"legacy: uncalibrated pallas keeps {agree:.3f} of dense's tokens")
    del params, sp, pols
    gc.collect()
    torch.cuda.empty_cache()
    res = {m: [{k: v for k, v in r.items() if k != "tokens"} for r in rs]
           if isinstance(rs, list) else rs for m, rs in out.items()}
    res["pallas_token_agreement"] = agree
    res["cli"] = cli
    res["reduced_parity"] = legacy_parity(dev)
    return res


# Phase 22: the sharded serve run (llama31_8b at SERVE_DEPTH layers), the
# sharded train step (gemma2_2b at its published width, TRAIN_LAYERS
# layers) and their tolerance against the unsharded runs (bf16)
SHARDED_RUN = {"batch": 4, "prompt_len": 128, "decode_steps": 16}
SHARDED_TRAIN = {"arch": "gemma2_2b", "layers": 2, "batch": 2, "seq": 256}
SHARD_TOL = 3e-2


@contextlib.contextmanager
def single_rank_group(dev):
    """An NCCL process group of one rank on the card ``dev``, its
    address a file: nothing tells a program of a cluster."""
    import tempfile

    import torch.distributed as dist
    torch.cuda.set_device(dev)
    fd, path = tempfile.mkstemp(prefix="chip_smoke_group_")
    os.close(fd)
    os.remove(path)
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if os.path.exists(path):
            os.remove(path)


def sharded_generate(params, cfg, prompts, steps: int, policy, sp, K):
    """Prefill then ``steps`` ``aligned`` decode steps (greedy), on
    plain or placed params: (tokens (B, steps + 1), logits per pass,
    each pass's launches of the 2-D kernels, counted from 0 just before
    it)."""
    from repro_torch.distributed.sharding import full
    from repro_torch.models import api
    B, S = prompts.shape
    logits_out, launches = [], []

    def counted(fn):
        K.reset_launch_counts()
        out = fn()
        launches.append({k: K.launch_counts[k]
                         for k in ("score_select", "sparse_matmul_shared")})
        logits_out.append(full(out[0]).float())
        return out

    decode = api.make_decode_step(cfg, policy, aligned=True)
    with torch.no_grad():
        _, caches = counted(lambda: api.make_prefill_step(cfg, policy)(
            params, prompts, sp))
        caches = api.pad_caches(cfg, caches, B, S + steps)
        toks = [logits_out[-1].argmax(-1)]
        for i in range(steps):
            batch = {"tokens": toks[-1], "caches": caches,
                     "positions": torch.full((B,), S + i, dtype=torch.long,
                                             device=prompts.device)}
            _, caches = counted(lambda: decode(params, batch, sp))
            toks.append(logits_out[-1].argmax(-1))
    return torch.stack(toks, 1), logits_out, launches


def sharded_serve_check(dev, K, mesh, cfg, params) -> dict:
    """22a: the serve run, unsharded then placed by LOGICAL_RULES_SERVE
    on ``mesh`` (the same weights)."""
    from repro_torch.core import sp_schema
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    from repro_torch.sparsity import SparsityPolicy

    B, S, steps = (SHARDED_RUN[k] for k in ("batch", "prompt_len",
                                            "decode_steps"))
    prompts = torch.from_numpy(SyntheticLM(DataConfig(
        cfg.vocab_size, S, B)).batch(0)).to(dev)
    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    pol = SparsityPolicy.uniform("pallas", k_max_frac=KEEP)
    want, want_logits, want_launch = sharded_generate(
        params, cfg, prompts, steps, pol, sp, K)
    with sh.sharding_context(mesh, sh.LOGICAL_RULES_SERVE):
        sparams = sh.distribute(params, P.logical_axes(M.model_schema(cfg)))
        ssp = sh.distribute(sp, P.logical_axes(
            sp_schema.sparsity_schema(cfg)))
        got, logits, launches = sharded_generate(sparams, cfg, prompts,
                                                 steps, pol, ssp, K)
    per = pass_launches(cfg)["score_select"]
    diff = max(max_err(a, b) for a, b in zip(logits, want_logits,
                                             strict=True))
    if not torch.equal(got, want):
        raise AssertionError("sharded serve: greedy tokens differ from the "
                             "unsharded run's")
    if diff > SHARD_TOL:
        raise AssertionError(f"sharded serve: logits differ by {diff:.3e} "
                             f"(limit {SHARD_TOL})")
    if any(c != {"score_select": per, "sparse_matmul_shared": per}
           for c in launches + want_launch):
        raise AssertionError(f"sharded serve: launches per pass {launches} "
                             f"(unsharded {want_launch}), expected {per}")
    print(f"sharded serve (1x1 mesh, LOGICAL_RULES_SERVE): {B} x {S} "
          f"prefill + {steps} aligned decode steps under pallas, tokens "
          f"equal the unsharded run's, largest logit difference "
          f"{diff:.3e}, {per} launches of each kernel per sparse pass "
          f"({len(launches)} passes)", flush=True)
    del sparams, ssp
    return {"logit_max_diff": diff, "launches_per_pass": per,
            "passes": len(launches), "tokens_equal": True}


def sharded_train_check(dev, mesh, cfg=None) -> dict:
    """22b: one train step (loss, grads, AdamW), unsharded and placed by
    LOGICAL_RULES_TRAIN, from the same weights."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import api
    from repro_torch.models import model as M
    from repro_torch.models import params as P
    from repro_torch.optim import adamw

    t = SHARDED_TRAIN
    if cfg is None:
        cfg = dataclasses.replace(get_config(t["arch"]),
                                  num_layers=t["layers"])
    params = api.init_model(cfg, SEED, device=dev)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (t["batch"], t["seq"]))).to(dev)
    ocfg = adamw.AdamWConfig()
    step = api.make_train_step(cfg, ocfg)
    axes = P.logical_axes(M.model_schema(cfg))
    with sh.sharding_context(mesh, sh.LOGICAL_RULES_TRAIN):
        sparams = sh.distribute(P.tree_map(torch.clone, params), axes)
        sparams, _, smet = step(sparams, adamw.init(sparams, ocfg),
                                {"tokens": toks})
        sloss = float(sh.full(smet["loss"]))
        got = [sh.full(p) for p in P.tree_leaves(sparams)]
    del sparams
    params, _, met = step(params, adamw.init(params, ocfg), {"tokens": toks})
    dloss = abs(sloss - float(met["loss"]))
    dparam = max(max_err(a.float(), b.float())
                 for a, b in zip(got, P.tree_leaves(params), strict=True))
    if dloss > SHARD_TOL or dparam > SHARD_TOL:
        raise AssertionError(f"sharded train step: loss differs by "
                             f"{dloss:.3e}, params by {dparam:.3e} (limit "
                             f"{SHARD_TOL})")
    print(f"sharded train step ({cfg.name}, {cfg.num_layers} layers, 1x1 "
          f"mesh, LOGICAL_RULES_TRAIN): loss {sloss:.5f} against "
          f"{float(met['loss']):.5f} unsharded (difference {dloss:.3e}), "
          f"updated params differ by at most {dparam:.3e}", flush=True)
    del params, got
    return {"loss": sloss, "loss_diff": dloss, "param_max_diff": dparam}


def sharded_bytes_check(dev, mesh, cfg, smi: str) -> dict:
    """22c: the dry run's argument bytes of the serve cell (meta tensors)
    against the device memory its arguments take when placed."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun

    B, S, steps = (SHARDED_RUN[k] for k in ("batch", "prompt_len",
                                            "decode_steps"))
    shape = ShapeConfig("phase22", S + steps, B, "decode")
    with sh.sharding_context(mesh, sh.LOGICAL_RULES_SERVE):
        want = dryrun.argument_bytes(dryrun.cell_args(
            cfg.name, shape.name, sparsity=KEEP, cfg=cfg, shape=shape))
        gc.collect()
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        args = dryrun.cell_args(cfg.name, shape.name, sparsity=KEEP,
                                cfg=cfg, shape=shape, device=dev)
        torch.cuda.synchronize(dev)
        grown = torch.cuda.memory_allocated(dev) - before
        del args
    rel = abs(grown - want) / want
    print(f"dry-run argument bytes of the serve cell: {want} on meta "
          f"tensors, {grown} allocated on {smi} ({100 * rel:.4f}% apart)",
          flush=True)
    if rel > 0.01:
        raise AssertionError("the dry run's argument bytes are more than 1% "
                             "from the card's allocation")
    return {"argument_bytes": want, "allocated_bytes": grown,
            "relative_diff": rel}


def serve_sharded(dev, K, smi) -> dict:
    """Phase 22: the sharded steps on a 1x1 mesh of the card
    (:func:`sharded_serve_check`, :func:`sharded_train_check`,
    :func:`sharded_bytes_check`), each figure beside the card's name and
    power limit."""
    from repro_torch import obs
    from repro_torch.launch.mesh import make_host_mesh

    t0 = obs.now()
    with single_rank_group(dev):
        mesh = make_host_mesh("cuda")
        cfg, params = full_width_model(dev)
        out = {"serve": sharded_serve_check(dev, K, mesh, cfg, params)}
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["bytes"] = sharded_bytes_check(dev, mesh, cfg, smi)
        out["train"] = sharded_train_check(dev, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = obs.now() - t0
    print(f"sharded steps on a 1x1 mesh: {out['s']:.1f} s on {smi}",
          flush=True)
    return out


def static_analysis(smi: str) -> dict:
    """Phase 23: the port's static checker (``repro_torch.analysis``) on
    the card: the AST passes over ``src/repro_torch``, then each global
    pass on ``cuda`` — the warmup set captured and replayed in place, its
    keys, and every kernel's launch geometry against the card's limits
    and ``wisparse_launch_info`` at every swept shape.  Prints the
    findings outside the port baseline (there must be none), each pass's
    seconds, the shapes and comparisons, and each kernel's largest shared
    memory with its headroom, beside the card's name and power limit."""
    from repro_torch import obs
    from repro_torch.analysis import Baseline, run_ast_passes
    from repro_torch.analysis.registry import global_passes

    t0 = obs.now()
    findings = run_ast_passes(HERE)
    pass_s = {"ast": obs.now() - t0}
    for rule, p in sorted(global_passes().items()):
        t = obs.now()
        findings += p.run(HERE, "cuda")
        pass_s[rule] = obs.now() - t
    base = Baseline.load(os.path.join(HERE, "analysis-baseline-torch.json"))
    fresh = base.filter(findings)
    for f in fresh:
        print(f.format())
    rep = global_passes()["launch-geometry"].report
    out = {"findings": len(fresh), "baselined": len(findings) - len(fresh),
           "pass_s": pass_s, "shapes": rep["shapes"],
           "compared": rep["compared"],
           "min_active_clusters": rep["min_active_clusters"],
           "smem": rep["smem"], "headroom": rep["headroom"],
           "limits": rep["limits"], "s": obs.now() - t0}
    print(json.dumps({"static_analysis": out}))
    print(f"static analysis: {len(fresh)} findings, {rep['compared']} "
          f"launch geometries equal to wisparse_launch_info over "
          f"{rep['shapes']} shapes, {out['s']:.1f} s on {smi}", flush=True)
    if fresh:
        raise AssertionError(f"{len(fresh)} static-analysis findings")
    if not rep["compared"] or not rep["min_active_clusters"]:
        raise AssertionError("launch-geometry compared no launch on the card")
    return out


# ---------------------------------------------------------------------------
# phase 24: one period of jamba_v01_52b at published width
# ---------------------------------------------------------------------------

JAMBA_ECFG = dict(max_slots=8, max_len=4608, prefill_chunk=32)


def jamba_model(dev):
    """One period of jamba_v01_52b at published width: its first
    SERVE_DEPTH = 8 of 32 layers, the layer pattern once (7 mamba mixers
    and one attention layer at period index 4; dense FFNs at the even
    indices, 16-expert top-2 MoE FFNs at the odd ones), bf16, random
    weights from SEED.  Returns (cfg, params, info): parameters, their
    bytes, the init's seconds, the device memory after it and its peak."""
    from repro_torch import obs
    from repro_torch.models import api

    cfg = served_config("jamba_v01_52b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.expert_d_ff, cfg.num_experts,
            cfg.num_experts_padded, cfg.num_experts_per_tok, cfg.d_inner,
            cfg.ssm_nheads, cfg.ssm_state, cfg.vocab_size, cfg.rope_theta,
            cfg.dtype) == (SERVE_DEPTH, 4096, 32, 8, 128, 14336, 14336, 16,
                           16, 2, 8192, 128, 16, 65536, 0.0, "bfloat16")
    kinds = cfg.layer_kinds()
    assert ([m for m, _ in kinds].count("mamba"), [f for _, f in
                                                   kinds].count("moe")) \
        == (7, 4) and kinds[4] == ("attn", "dense")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = obs.now()
    params = api.init_model(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    info = {"params": sum(t.numel() for t in leaves),
            "param_bytes": sum(t.nbytes for t in leaves),
            "init_s": obs.now() - t0,
            "allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"jamba_v01_52b, {cfg.num_layers} of 32 layers (one period: "
          f"{kinds}): {info['params'] / 1e9:.3f}B params, "
          f"{info['param_bytes'] / 1e9:.3f} GB ({cfg.dtype}), init "
          f"{info['init_s']:.1f} s, device memory "
          f"{info['allocated_gb']:.2f} GB, peak during the init "
          f"{info['init_peak_gb']:.2f} GB")
    return cfg, params, info


def jamba_lens() -> list:
    """Phase 24's prompt lengths: one of 4096 tokens (expert capacity 641
    in its whole prefill), then 7 distinct multiples of 64 from 256 to
    4032 drawn from SEED + 24.  None is prime, and each has a divisor of
    64 or more, so the SSD chunk length (``models/ssm.chunk_len``, at
    most 256) stays at 64 or more."""
    rng = np.random.default_rng(SEED + 24)
    return [4096] + [int(x) for x in rng.choice(np.arange(256, 4096, 64), 7,
                                                replace=False)]


def jamba_trace(cfg) -> dict:
    """Phase 24's trace: the 8 prompts of :func:`jamba_lens` at once into
    8 slots, each its own whole prefill, 32 new tokens each."""
    rng = np.random.default_rng(SEED + 24)
    lens = jamba_lens()
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    return {"prompts": prompts, "lens": lens, "gen": 32,
            "ecfg": dict(JAMBA_ECFG), "max_batch": 1}


def jamba_calibrate(cfg, params) -> tuple:
    """A 0.5 ``pallas`` plan of the period (paper Alg. 1-4,
    ``core/pipeline.run_pipeline``, per-expert capture and g) with the
    ``--calib-quick`` budget of phases 6 and 17 on 4 x 128 synthetic
    tokens: each stage's wall seconds, the KL (Eq. 8) on those tokens and
    the policy's ``k_max_frac``; checks the size-weighted budget and one
    finite tau per sparsified linear (70: 58 2-D and 12 expert
    projections).  Returns (policy, sp, info)."""
    from repro_torch import obs
    from repro_torch.core import calibration, pipeline
    from repro_torch.core.allocation import EvoConfig, weighted_average
    from repro_torch.data import DataConfig, SyntheticLM

    evo = EvoConfig(generations=2, offspring=4, eps=0.1)
    toks = SyntheticLM(DataConfig(cfg.vocab_size, 128, 4)).batch(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    marks = [("context", obs.now())]

    def log(msg):
        torch.cuda.synchronize()
        for stage, text in (("coarse (Alg. 3)", "coarse search"),
                            ("fine (Alg. 4)", "fine search"),
                            ("alpha (Alg. 2)", "alpha search:")):
            if msg.startswith(text):
                marks.append((stage, obs.now()))

    ctx = calibration.build_context(params, cfg, {"tokens": toks})
    plan = pipeline.run_pipeline(params, cfg, None, KEEP, evo=evo,
                                 delta=0.25, coord_passes=0, ctx=ctx, log=log)
    torch.cuda.synchronize()
    marks.append(("end", obs.now()))
    stages = {label: t1 - t for (label, t), (_n, t1) in zip(marks, marks[1:])}
    kl = ctx.fitness(plan.per_depth_sp)
    avg = weighted_average(ctx, np.asarray(plan.block_ratios))
    policy = plan.to_policy(backend="pallas")
    if not KEEP - evo.eps <= avg <= KEEP + 1e-9:
        raise AssertionError(f"jamba plan: size-weighted block ratio {avg} "
                             f"outside [{KEEP - evo.eps}, {KEEP}]")
    per_pass = pass_launches(cfg)
    n_keys = per_pass["score_select"] + per_pass["score_select_experts"]
    bad = [k for k, t in plan.taus.items()
           if plan.layer_ratios[k] > 0 and not math.isfinite(t)]
    if bad or len(plan.taus) != n_keys:
        raise AssertionError(f"jamba plan: {len(plan.taus)} taus (expected "
                             f"{n_keys}), non-finite where sparsified: {bad}")
    info = {"stages_s": stages, "total_s": marks[-1][1] - marks[0][1],
            "kl": kl, "k_max_frac": policy.k_max_frac,
            "weighted_ratio": avg,
            "keep_min": min(1.0 - r for r in plan.layer_ratios.values()),
            "keep_max": max(1.0 - r for r in plan.layer_ratios.values()),
            "mean_alpha": float(np.mean(list(plan.alphas.values()))),
            "peak_above_model_gb": (torch.cuda.max_memory_allocated()
                                    - base) / 1e9}
    print(f"jamba 0.5 plan (--calib-quick budget, {toks.size} tokens): wall "
          "s per stage " + ", ".join(f"{k} {v:.2f}" for k, v in
                                     stages.items())
          + f"; total {info['total_s']:.2f} s; KL {kl:.6g} (random weights; "
          f"informative only); k_max_frac {policy.k_max_frac}; keep "
          f"{info['keep_min']:.4f}-{info['keep_max']:.4f}; mean alpha "
          f"{info['mean_alpha']:.4f}; size-weighted block ratio {avg:.6f}; "
          f"{n_keys} finite taus; device memory peak above the model "
          f"{info['peak_above_model_gb']:.2f} GB")
    sp = plan.stacked_sp
    del ctx, plan
    gc.collect()
    torch.cuda.empty_cache()
    return policy, sp, info


def jamba_drops(drops, cfg) -> dict:
    """The expert assignments each whole prefill dropped past capacity
    (:func:`recorded_drops`), summed over the period's MoE layers, per
    prompt length."""
    moe_layers = [f for _, f in cfg.layer_kinds()].count("moe")
    per_len = {}
    for S, cap, n in drops:
        d = per_len.setdefault(S, {"capacity": cap, "dropped": 0, "calls": 0})
        d["dropped"] += int(n)
        d["calls"] += 1
    K = cfg.num_experts_per_tok
    for S, d in per_len.items():
        if d["calls"] != moe_layers:
            raise AssertionError(f"jamba drops: {d['calls']} dispatches of "
                                 f"the {S}-token prefill, expected "
                                 f"{moe_layers}")
        d["share"] = d["dropped"] / (S * K * moe_layers)
    print("jamba capacity drops per whole prefill (dense, summed over "
          f"{moe_layers} MoE layers, {K} of {cfg.num_experts} experts per "
          "token): " + "; ".join(
              f"{S} tokens at C = {d['capacity']}: {d['dropped']} "
              f"({100 * d['share']:.2f}%)"
              for S, d in sorted(per_len.items())))
    return {str(S): d for S, d in sorted(per_len.items())}


def serve_jamba(dev, K, smi: str) -> dict:
    """Phase 24: one period of jamba_v01_52b at published width through
    the port's ``Engine`` (8 slots, whole-prompt prefill, ``max_len``
    4608, the decode step captured once): dense, ``pallas``, ``pallas``,
    dense (uncalibrated: keep_frac = k_max_frac = 0.5, tau -inf), then
    ``pallas`` with ``prefill_dense_frac`` 0 twice (every whole prompt
    through both kernel pairs, up to 641 rows per expert, the expert
    matmul in its tile form; the second run warm); the busy build and the
    captured decode step against the eager one (logits within 3e-2), with
    the capacity drops of the dense engine's whole prefills; a 0.5 plan
    calibrated on the period and served twice.  Each run: 0 builds after
    warmup, launches per sparse pass 58 of each 2-D kernel and 12 of each
    ``_experts`` kernel (:func:`pass_launches`), each mode's runs equal
    token for token.  Prints ``step_costs``' bytes and bound beside the
    device ms of each run's 8 traced decode steps, the top ops of one
    eager decode step, and the phase's peak device memory."""
    from repro_torch import obs
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.launch import constants
    from repro_torch.launch.roofline import step_costs
    from repro_torch.models.ssm import chunk_len
    from repro_torch.serving import EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    t_phase = obs.now()
    cfg, params, model = jamba_model(dev)
    trace = jamba_trace(cfg)
    L = {n: chunk_len(n, cfg.ssm_chunk) for n in trace["lens"]}
    print(f"phase 24 trace: prompt lengths {trace['lens']} (SSD chunk "
          f"lengths {L}), {trace['gen']} new tokens each, {trace['ecfg']}")
    if min(L.values()) < min(64, cfg.ssm_chunk):
        raise AssertionError(f"jamba: an SSD chunk length under 64: {L}")
    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    modes = {"dense": (SparsityPolicy.dense(), None),
             "pallas": (SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
                        sp)}
    runs = {}
    for name in ("dense", "pallas", "pallas", "dense"):
        pol, s = modes[name]
        res = ssm_run(f"jamba {name}", params, cfg, pol, s, trace, dev, K)
        if name in runs and res["tokens"] != runs[name][0]["tokens"]:
            raise AssertionError(f"jamba {name}: the second run's greedy "
                                 "tokens differ from the first's")
        runs.setdefault(name, []).append(res)
    pol, s = modes["pallas"]
    for _ in range(2):
        res = ssm_run("jamba pallas sparse prefill", params, cfg, pol, s,
                      trace, dev, K, frac=0.0)
        if "pallas sparse prefill" in runs and res["tokens"] != runs[
                "pallas sparse prefill"][0]["tokens"]:
            raise AssertionError("jamba pallas sparse prefill: the second "
                                 "run's greedy tokens differ from the "
                                 "first's")
        runs.setdefault("pallas sparse prefill", []).append(res)
    drops = []
    gve = ssm_graph_vs_eager(dev, cfg, params, sp, trace, tag="jamba",
                             prompts=trace["prompts"], drops=drops,
                             tol=NEAR_TIE)
    capacity = jamba_drops(drops, cfg)
    peak = torch.cuda.max_memory_allocated()       # the calibration resets it
    policy, plan_sp, calib = jamba_calibrate(cfg, params)
    modes["calibrated"] = (policy, plan_sp)
    for _ in range(2):
        res = ssm_run("jamba calibrated", params, cfg, policy, plan_sp, trace,
                      dev, K)
        if "calibrated" in runs and \
                res["tokens"] != runs["calibrated"][0]["tokens"]:
            raise AssertionError("jamba calibrated: the second run's greedy "
                                 "tokens differ from the first's")
        runs.setdefault("calibrated", []).append(res)
    ecfg = EngineConfig(**trace["ecfg"])
    bounds = {}
    for name, (pol, s) in modes.items():
        flops, nbytes = step_costs(cfg, ecfg, pol, s, "decode")
        bounds[name] = {"decode_step_gb": nbytes / 1e9,
                        "decode_step_gflop": flops / 1e9,
                        "decode_step_bound_ms": 1e3 * nbytes
                        / constants.HBM_BW}
    keys = ("decode_tok_s", "decode_step_p50_ms", "decode_step_p95_ms",
            "ttft_p50_ms", "window_step_device_ms", "decode_device_busy",
            "wall_s", "sparse_passes", "decode_retraces_after_warmup",
            "distinct_tokens")
    for name, rs in runs.items():
        for i, r in enumerate(rs):
            pre = ", ".join(f"{n}x{b} {ms:.1f}" for n, b, ms in
                            sorted(r["whole_prefills"]))
            print(f"jamba {name} {i + 1}: " + ", ".join(
                f"{k} {r[k]:.4g}" if isinstance(r[k], float)
                else f"{k} {r[k]}" for k in keys)
                + f"; launches {r['launches']} ({r['launches_per_pass']} "
                f"per sparse pass); whole-prefill ms per prompt length x "
                f"batch: {pre}")
    for name in ("dense", "pallas", "calibrated"):
        rs, b = runs[name], bounds[name]
        dev_ms = [r["window_step_device_ms"] for r in rs]
        print(f"jamba {name}: decode step bytes (step_costs) "
              f"{b['decode_step_gb']:.3f} GB, bound "
              f"{b['decode_step_bound_ms']:.3f} ms at 3.35 TB/s; device ms "
              f"per traced decode step " + " / ".join(f"{v:.3f}"
                                                     for v in dev_ms)
              + f" (the bound is "
              f"{100 * b['decode_step_bound_ms'] / min(dev_ms):.1f}% of it); "
              "decode p50 " + " / ".join(
                  f"{r['decode_step_p50_ms']:.2f}" for r in rs)
              + " ms; greedy tokens equal in both runs; " + smi)
    for i, sp_run in enumerate(runs["pallas sparse prefill"]):
        lens = {n: ms for n, _b, ms in sp_run["whole_prefills"]}
        print(f"jamba sparse whole prefill, run {i + 1} (every prompt "
              f"through both expert kernels, {sp_run['tile_launches']} "
              "tile-form expert matmuls), ms per prompt length: " + ", ".join(
                  f"{n} {ms:.1f}" for n, ms in sorted(lens.items(),
                                                      reverse=True))
              + f"; TTFT p50 {sp_run['ttft_p50_ms']:.1f} ms; {smi}")
    dense_4096 = [ms for r in runs["dense"] for n, _b, ms in
                  r["whole_prefills"] if n == 4096]
    print("jamba dense runs: TTFT p50 " + " / ".join(
        f"{r['ttft_p50_ms']:.1f}" for r in runs["dense"])
        + " ms, the 4096-token whole prefill " + " / ".join(
            f"{ms:.1f}" for ms in dense_4096) + " ms")
    print(f"jamba greedy tokens equal to dense at the same position: pallas "
          f"{agreement(runs['dense'][0], runs['pallas'][0]):.3f}, calibrated "
          f"{agreement(runs['dense'][0], runs['calibrated'][0]):.3f} (random "
          "weights; informative only)")
    peak = max(peak, torch.cuda.max_memory_allocated()) / 1e9
    out = {"model": model, "trace_lens": trace["lens"],
           "runs": {f"{n} {i + 1}": {k: v for k, v in r.items()
                                      if k != "tokens"}
                    for n, rs in runs.items() for i, r in enumerate(rs)},
           "step_bounds": bounds, "graph_vs_eager": gve,
           "capacity_drops": capacity, "calibration": calib,
           "phase_peak_gb": peak}
    del params, sp, plan_sp, modes
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = obs.now() - t_phase
    print(f"phase 24 took {out['wall_s']:.1f} s; device memory peak "
          f"{out['phase_peak_gb']:.2f} GB ({smi})")
    return out


def jamba_kernels(K, ref, build, dev, rates) -> tuple:
    """Phase 3's jamba_v01_52b part: both 2-D kernels at its 13 projection
    shapes (B = 8 and 32) and the ``_experts`` pair at its 3 expert shapes
    (16 experts, R = 8, 111, 241 and 641), each held against its plain
    versions and timed beside ``torch.matmul`` / ``torch.bmm`` and its
    bound; then the 2-D kernels summed over one sparse pass of the period
    (58 projections, :func:`role_counts`), the expert matmul's two forms
    (:func:`expert_matmul_forms`) and the tile form at E = 1 on 2-D
    whole-prefill shapes (:func:`tile_form_2d_evidence`).  Returns (rows,
    errs, expert rows, expert errs, per-pass sums, form rows, form errs,
    evidence rows, evidence err)."""
    rows, errs = main_path_kernels(K, ref, build, dev, rates,
                                   layer=JAMBA_LAYER, batches=(8, 32),
                                   v1=False)
    e_rows, e_errs = expert_kernels(
        K, ref, dev, rates, rows=JAMBA_EXPERT_ROWS, model="jamba_v01_52b",
        shapes=JAMBA_EXPERTS, E=JAMBA_E, routed=JAMBA_E)
    per_pass = gemma_layer_summary(rows, "jamba_v01_52b",
                                   role_counts(served_config("jamba_v01_52b")))
    gc.collect()
    torch.cuda.empty_cache()
    f_rows, f_errs = expert_matmul_forms(K, ref, build, dev, rates)
    v_rows, v_err = tile_form_2d_evidence(K, ref, dev, rates)
    gc.collect()
    torch.cuda.empty_cache()
    return rows, errs, e_rows, e_errs, per_pass, f_rows, f_errs, v_rows, v_err


def jamba_only(dev, K, ref, build, rates, smi: str, t_start) -> int:
    """``--jamba-only``: :func:`jamba_kernels` and phase 24, one JSON line
    (no contract lines)."""
    from repro_torch import obs
    (rows, errs, e_rows, e_errs, per_pass, f_rows, f_errs, v_rows,
     v_err) = jamba_kernels(K, ref, build, dev, rates)
    t0 = obs.now()
    jamba = serve_jamba(dev, K, smi)
    print(json.dumps({"jamba_only": {
        **jamba, "kernels": rows, "kernels_max_abs_err": errs,
        "expert_kernels": e_rows, "expert_kernels_max_abs_err": e_errs,
        "kernels_per_sparse_pass": per_pass, "expert_matmul_forms": f_rows,
        "expert_matmul_max_abs_err": f_errs, "tile_2d_evidence": v_rows,
        "tile_2d_evidence_max_abs_err": v_err, "phase_24_s": obs.now() - t0,
        "s": obs.now() - t_start, "card": smi}}))
    return 0


def drive(eng, window: int = WINDOW) -> tuple:
    """Run ``eng`` to the end, one step at a time, and measure its steps.

    The first ``window`` decode steps of the pure-decode tail (every
    request admitted and prefilled, the longest needing at least
    ``window`` more steps) run under ``torch.profiler`` tracing the card
    only.  Their device time (kernels and copies) over their own wall
    time is the device busy share; tracing adds host time to those
    steps, so the share is also given against the unprofiled p50.  The
    headline metrics (decode tok/s, step p50/p95) come from the other
    decode steps, which run unprofiled.  ``window=0`` traces nothing
    (a speculative round emits a varying number of tokens, so its tail
    need not hold ``window`` rounds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.metrics import percentile
    sched = eng.scheduler
    steps = []          # (kind, tokens emitted, wall s, profiled)
    prof, profiled, device_us = None, 0, 0.0
    while sched.has_work():
        if (window and prof is None and not profiled
                and not sched.has_queued()
                and not sched.prefilling and sched.decoding
                and max(rs.request.max_new_tokens - len(rs.tokens)
                        for rs in sched.decoding.values()) >= window):
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        emitted = eng.stats.decode_tokens
        before = eng.stats.decode_time      # the engine's own step clock
        kind = eng.step()
        if kind == "decode":
            steps.append((kind, eng.stats.decode_tokens - emitted,
                          eng.stats.decode_time - before, prof is not None))
        elif prof is not None:
            raise AssertionError(f"a {kind} step in the profiled window")
        if prof is not None and kind == "decode":
            profiled += 1
            if profiled == window:
                torch.cuda.synchronize()
                prof.stop()
                device_us = sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
                prof = None
    if profiled != window:
        raise AssertionError(f"profiled {profiled} decode steps, wanted "
                             f"{window}")
    if window and not device_us > 0:
        raise AssertionError("torch.profiler recorded no device time")
    st = eng.stats
    plain = [(n, w) for _k, n, w, pr in steps if not pr]
    win = [w for _k, _n, w, pr in steps if pr]
    walls = [w for _n, w in plain]
    res = {
        "decode_tok_s": sum(n for n, _w in plain) / sum(walls),
        "decode_step_p50_ms": 1e3 * percentile(walls, 50),
        "decode_step_p95_ms": 1e3 * percentile(walls, 95),
        "ttft_p50_ms": 1e3 * percentile(st.ttft_s, 50),
        "prefill_chunk_p50_ms": 1e3 * percentile(st.prefill_step_s, 50),
        "prefill_s": st.prefill_time,
        "decode_steps": st.decode_steps,
        "prefill_chunks": st.prefill_chunks,
        "prefill_sparse_chunks": st.prefill_sparse_chunks,
        "generated_tokens": sum(len(rs.tokens) for rs in eng.states.values()),
    }
    if window:
        res.update({
            "window_steps": len(win),
            "window_step_wall_ms": 1e3 * sum(win) / len(win),
            "window_step_device_ms": device_us / 1e3 / len(win),
            "decode_device_busy": device_us / 1e6 / sum(win),
            # the profiler lengthens the window's steps on the host;
            # against the same run's unprofiled p50 the share is larger
            "device_ms_over_p50": device_us / 1e3 / len(win) / (
                1e3 * percentile(walls, 50)),
        })
    return {rid: rs.tokens for rid, rs in eng.states.items()}, res


def _leaves(tree):
    """The tensors of a nested dict/list tree, dict keys in sorted order
    (so two trees built in different key orders line up)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def gather_backends_us(dev) -> dict:
    """Device time of one ``topk_shared`` and one ``topk_block``
    projection (``core/sparse_linear.project``: plain PyTorch backends
    with no kernel of their own; bf16, alpha 1, tau -inf, keep_frac and
    k_max_frac 0.5, unit token weights) at llama31_8b's 7 projection
    shapes, B = 8, by CUDA-graph replay with the weights rotated through
    copies beyond L2.  Uses only the public signature, so it times any
    tree's package (``--src``)."""
    from repro_torch.core import sparse_linear
    from repro_torch.sparsity import SparsityPolicy
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for backend in ("topk_shared", "topk_block"):
        pol = SparsityPolicy.uniform(backend, k_max_frac=KEEP, block=BLK)
        per = []
        for _role, n, m in LAYER:
            x = torch.from_numpy(rng.standard_normal((8, n)).astype(
                np.float32)).to(dev, torch.bfloat16)
            w = (torch.randn(n, m, device=dev) * 0.02).to(torch.bfloat16)
            sp1 = {"g": torch.sqrt((w.float() ** 2).sum(1)),
                   "alpha": torch.tensor(1.0, device=dev),
                   "tau": torch.tensor(float("-inf"), device=dev),
                   "keep_frac": torch.tensor(KEEP, device=dev)}
            rw = torch.ones(8, device=dev)
            copies = max(1, math.ceil(200e6 / (n * m * 2)))
            ws = [w] + [w.clone() for _ in range(copies - 1)]
            per.append(1e3 * graph_ms(lambda i: sparse_linear.project(
                x, ws[i % copies], sp1, policy=pol, token_weights=rw)))
            del ws
        out[backend] = {"per_layer_us": sum(per), "per_shape_us": per}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host-only", action="store_true",
                    help="build the kernels, print the wrappers' host time "
                         "per call, the pallas projection's device time per "
                         "shape and the gather backends' device time as "
                         "JSON lines, and stop")
    ap.add_argument("--train-only", action="store_true",
                    help="run phase 19a's card-against-CPU training check "
                         "(with its TF32 control) and phase 19b's 30 "
                         "gemma2_2b steps, print their numbers as one JSON "
                         "line, and stop")
    ap.add_argument("--experts-only", action="store_true",
                    help="hold and time score_select_experts at every MoE "
                         "arch's expert shapes and the expert matmul's two "
                         "forms at jamba's (phase 3's expert_select_shapes "
                         "and expert_matmul_forms), print them as one JSON "
                         "line, and stop")
    ap.add_argument("--jamba-only", action="store_true",
                    help="build the kernels, hold and time them at "
                         "jamba_v01_52b's shapes (phase 3's jamba part), "
                         "run phase 24, print one JSON line, and stop")
    ap.add_argument("--src", default=os.path.join(HERE, "src"),
                    help="directory holding the repro_torch package (for "
                         "--host-only, --train-only or --experts-only "
                         "against another tree)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: chip_smoke.py needs a "
              "CUDA card", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    print(smi)
    from repro_torch import obs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import geometry as G
    from repro_torch.kernels import sparse_matmul as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    if args.train_only:
        return train_only(dev, card, args.src)
    if args.experts_only:
        from repro_torch.launch import constants
        return experts_only(dev, card, args.src, constants.peak_rates(card))

    t_start = t0 = obs.now()
    build.library()
    print(f"kernels built in {obs.now() - t0:.1f} s\n{build.build_log()}")
    host = wrapper_host_us(K, ops, dev)
    print(json.dumps({"wrapper_host_us": host, "src": args.src}))
    proj = projection_us(ops, dev)
    print(json.dumps({"projection": proj, "src": args.src}))
    print(f"one pallas projection launches {proj['launches_per_projection']} "
          f"CUDA kernels: {proj['launched']}")
    print(json.dumps({"gather_backends": gather_backends_us(dev),
                      "src": args.src}))
    if args.host_only:
        return 0
    # the data-sheet rates the kernel bounds and the quality monitor's
    # decode utilization share
    from repro_torch.launch import constants
    rates = constants.peak_rates(card)
    if proj["launches_per_projection"] != 3:
        raise AssertionError("a pallas projection should launch 3 kernels "
                             "(score_select, the matmul, the cast)")
    if args.jamba_only:
        return jamba_only(dev, K, ref, build, rates, smi, t_start)

    # each phase's wall time, printed after the serving line; each is
    # also written to stderr with the time since the start, so that a run
    # stopped at its limit shows how far it got
    phase_s, mark = {}, [obs.now()]

    def took(phase):
        phase_s[phase] = round(obs.now() - mark[0], 1)
        mark[0] = obs.now()
        print(f"phase {phase}: {phase_s[phase]} s", flush=True)
        print(f"phase {phase}: {phase_s[phase]} s, "
              f"{obs.now() - t_start:.1f} s since the start",
              file=sys.stderr, flush=True)

    errs = check_kernel_shapes(K, ref, dev)
    rows, errs2 = main_path_kernels(K, ref, build, dev, rates)
    # gemma2_2b's seven projection shapes: phase 16's path
    g_rows, errs3 = main_path_kernels(K, ref, build, dev, rates,
                                      layer=GEMMA_LAYER, batches=(8, 32),
                                      v1=False)
    errs4 = whole_prefill_kernels(K, ref, dev, gemma_prefill_rows())
    # granite_moe_3b_a800m: its attention shapes through the 2-D kernels
    # and its expert shapes through the expert-batched ones (phase 17)
    ga_rows, errs5 = main_path_kernels(K, ref, build, dev, rates,
                                       layer=GRANITE_ATTN, batches=(8, 32),
                                       v1=False)
    ge_rows, errs6 = expert_kernels(K, ref, dev, rates)
    # the expert selection alone at every MoE arch's expert shapes, in the
    # form each takes
    es_rows, es_err = expert_select_shapes(K, ref, G, dev, rates)
    errs6["score_select"] = max(errs6["score_select"], es_err)
    # mamba2_130m's six projection shapes (phase 18), B = 8 and 32 timed,
    # and at the row counts of phase 18's whole-prompt prefills
    m_rows, errs7 = main_path_kernels(K, ref, build, dev, rates,
                                      layer=MAMBA_LAYER, batches=(8, 32),
                                      v1=False)
    errs8 = whole_prefill_kernels(K, ref, dev, mamba_prefill_rows(),
                                  layer=MAMBA_LAYER, model="mamba2_130m")
    # whisper_large_v3's and internvl2_26b's decode-layer shapes (phase
    # 20), B = 8 and 32 timed, and whisper's cross wk/wv at its encoder
    # row counts
    w_rows, errs9 = main_path_kernels(K, ref, build, dev, rates,
                                      layer=WHISPER_LAYER, batches=(8, 32),
                                      v1=False)
    errs10 = whole_prefill_kernels(K, ref, dev, WHISPER_CROSS_ROWS,
                                   layer=WHISPER_CROSS_KV,
                                   model="whisper_large_v3")
    i_rows, errs11 = main_path_kernels(K, ref, build, dev, rates,
                                       layer=INTERNVL_LAYER, batches=(8, 32),
                                       v1=False)
    # jamba_v01_52b's 13 2-D shapes and its 3 expert shapes (phase 24)
    (j_rows, errs12, je_rows, errs13, jamba_pass, jf_rows, errs14, jv_rows,
     err15) = jamba_kernels(K, ref, build, dev, rates)
    ps_rows, ps_err, ps_launches = per_seq_kernel(K, ref, ops, build, dev,
                                                  rates)
    layer_summary(rows, ps_rows, proj)
    gemma_layer = gemma_layer_summary(g_rows)
    mamba_layer = gemma_layer_summary(m_rows, "mamba2_130m")
    whisper_layer = gemma_layer_summary(w_rows, "whisper_large_v3")
    internvl_layer = gemma_layer_summary(i_rows, "internvl2_26b")
    took("3 kernels")
    reduced_model_check(dev)
    reduced_gemma_check(dev)
    reduced_granite = reduced_granite_check(dev)
    reduced_ssm = {a: reduced_ssm_check(dev, a)
                   for a in ("mamba2_130m", "jamba_v01_52b")}
    reduced_multimodal = {a: reduced_multimodal_check(dev, a)
                          for a in ("whisper_large_v3", "internvl2_26b")}
    took("4 reduced model")
    cfg, params = full_width_model(dev)
    trace = serving_trace(cfg)
    results = serve_full_width(dev, K, cfg, params, trace)
    took("5 full width")
    ladder, calib = calibrate_full_width(cfg, params)
    took("6 calibration")
    calibrated = serve_calibrated(dev, K, cfg, params, trace, ladder,
                                  results)
    took("7 calibrated plan")
    ladder_runs = serve_ladder(dev, K, cfg, params, trace, ladder)
    took("8 ladder")
    gve = graph_vs_eager(dev, cfg, params, trace)
    cgve = chunk_graph_vs_eager(dev, cfg, params, trace)
    took("9-10 graph against eager")
    spec_res = serve_spec(dev, K, cfg, params, trace, ladder)
    took("11 spec")
    prefix_res = serve_prefix_cache(dev, K, cfg, params)
    took("12 prefix cache")
    preempt_res = serve_preemption(dev, cfg, params, trace)
    took("13 preemption")
    gateway_res = serve_gateway(dev, K, cfg, params, trace, ladder)
    took("14 gateway")
    quality_flight = serve_quality_flight(dev, K, cfg, params, trace, ladder)
    took("15 quality and flight")
    del params, ladder
    gc.collect()
    torch.cuda.empty_cache()
    clis = serve_clis(dev)
    gateway_res["drain"] = clis["drain"]
    quality_flight["cli"] = clis["flight"]
    took("14-18, 21 serve CLIs")
    gemma = serve_gemma(dev, K, clis["gemma2_2b"])
    took("16 gemma2_2b")
    granite = serve_granite(dev, K, clis["granite_moe_3b_a800m"])
    took("17 granite_moe_3b_a800m")
    mamba = serve_mamba(dev, K, clis["mamba2_130m"])
    took("18 mamba2_130m")
    training = train_on_card(
        dev, K, rates, spec_res["spec calibrated"]["spec"]["accept_rate"])
    took("19 training")
    gc.collect()
    torch.cuda.empty_cache()
    whisper = serve_whisper(dev, K, rates, smi)
    gc.collect()
    torch.cuda.empty_cache()
    internvl = serve_internvl(dev, K, rates, smi)
    took("20 whisper_large_v3 and internvl2_26b")
    gc.collect()
    torch.cuda.empty_cache()
    legacy = serve_legacy(dev, K, smi, clis["legacy"])
    took("21 legacy generate")
    gc.collect()
    torch.cuda.empty_cache()
    sharded = serve_sharded(dev, K, smi)
    took("22 sharded steps")
    static = static_analysis(smi)
    took("23 static analysis")
    gc.collect()
    torch.cuda.empty_cache()
    jamba = serve_jamba(dev, K, smi)
    took("24 jamba_v01_52b")
    keep = ("tokens", "token_rungs")
    print(json.dumps({"serving": {
        "runs": {f"{n} {i + 1}": {k: v for k, v in r.items()
                                  if k not in keep}
                 for n, rs in [*results.items(), ("ladder", ladder_runs)]
                 for i, r in enumerate(rs)},
        "calibrated": {k: v for k, v in calibrated.items() if k not in keep},
        "spec": {n: {k: v for k, v in r.items() if k not in keep}
                 for n, r in spec_res.items()},
        "calibration": calib, "graph_vs_eager": gve,
        "chunk_graph_vs_eager": cgve,
        "prefix_cache": {n: {k: v for k, v in r.items() if k not in keep}
                         for n, r in prefix_res.items()},
        "preemption": {n: {k: v for k, v in r.items() if k not in keep}
                       for n, r in preempt_res.items()},
        "gateway": gateway_res, "quality_flight": quality_flight,
        "gemma2_2b": {**gemma, "kernels_per_decode_layer": gemma_layer},
        "granite_moe_3b_a800m": {**granite, "attention_kernels": ga_rows,
                                 "expert_kernels": ge_rows},
        "expert_select": es_rows,
        "mamba2_130m": {**mamba, "kernels": m_rows,
                        "kernels_per_decode_layer": mamba_layer},
        "reduced_granite": reduced_granite, "reduced_ssm": reduced_ssm,
        "training": training,
        "whisper_large_v3": {**whisper, "kernels": w_rows,
                             "kernels_per_decode_layer": whisper_layer},
        "internvl2_26b": {**internvl, "kernels": i_rows,
                          "kernels_per_decode_layer": internvl_layer},
        "reduced_multimodal": reduced_multimodal, "legacy": legacy,
        "sharded": sharded, "static_analysis": static,
        "jamba_v01_52b": {**jamba, "kernels": j_rows,
                          "expert_kernels": je_rows,
                          "kernels_per_sparse_pass": jamba_pass,
                          "expert_matmul_forms": jf_rows,
                          "tile_2d_evidence": jv_rows}}}))

    decode_rows = [r for r in rows if r["B"] == 8]
    expert_rows = [r for r in ge_rows if r["R"] == 8]
    kernels = []
    for kname, src, line in (("score_select", "score_select.cu", 319),
                             ("sparse_matmul_shared",
                              "sparse_matmul_shared.cu", 211)):
        for row, per, launches, err in (
                # one llama31_8b decode layer's 7 projections at B = 8,
                # and their launches in phase 5's first pallas run
                (kname, [r[kname] for r in decode_rows],
                 results["pallas"][0]["launches"][kname],
                 max(errs[kname], errs2[kname], errs3[kname], errs4[kname],
                     errs5[kname], errs7[kname], errs8[kname], errs9[kname],
                     errs10[kname], errs11[kname], errs12[kname])),
                # one granite decode layer's 3 expert-batched projections
                # (48 experts, R = 8), and the expert kernel's launches in
                # phase 17's first pallas run
                (kname + "_experts", [r[kname] for r in expert_rows],
                 granite["runs"]["pallas 1"]["launches"][kname + "_experts"],
                 max(errs6[kname], errs13[kname],
                     errs14["gather"] if kname.endswith("shared") else 0))):
            lib = [p["library_ms"] for p in per]
            kernels.append({
                "name": row, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": f"src/repro/kernels/sparse_matmul.py:{line}",
                "launches": launches,
                "max_abs_err": err,
                "ms": sum(p["ms"] for p in per),
                "plain_ms": sum(p["plain_ms"] for p in per),
                "bound_ms": sum(p["bound_ms"] for p in per),
                "bound_by": ("bytes" if all(p["bound_by"] == "bytes"
                                             for p in per) else "operations"),
                "library_ms": None if lib[0] is None else sum(lib),
            })
    # the expert matmul's tile form, per jamba MoE layer at R = 641 (a
    # 4096-token whole prefill), and its launches in phase 24's sparse
    # prefill run
    per = [r["sparse_matmul_shared"] for r in je_rows if r["R"] == 641]
    if {r["form"] for r in je_rows if r["R"] == 641} != {"tile"}:
        raise AssertionError("jamba's R = 641 expert matmuls did not take "
                             "the tile form")
    kernels.append({
        "name": "sparse_matmul_shared_experts_tile", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_matmul_tile.cu",
        "replaces": "src/repro/kernels/sparse_matmul.py:211",
        "launches": jamba["runs"]["pallas sparse prefill 1"][
            "tile_launches"],
        "max_abs_err": max(errs14["tile"], err15),
        "ms": sum(p["ms"] for p in per),
        "plain_ms": sum(p["plain_ms"] for p in per),
        "bound_ms": sum(p["bound_ms"] for p in per),
        "bound_by": ("bytes" if all(p["bound_by"] == "bytes" for p in per)
                     else "operations"),
        "library_ms": sum(p["library_ms"] for p in per),
    })
    per = [r for r in ps_rows if r["B"] == 8]
    kernels.append({
        "name": "sparse_matmul_per_seq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_matmul_per_seq.cu",
        "replaces": "src/repro/kernels/sparse_matmul.py:266",
        "launches": ps_launches,
        "max_abs_err": max(errs["sparse_matmul_per_seq"], ps_err),
        "ms": sum(p["ms"] for p in per),
        "plain_ms": sum(p["plain_ms"] for p in per),
        "bound_ms": sum(p["bound_ms"] for p in per),
        "bound_by": ("bytes" if all(p["bound_by"] == "bytes" for p in per)
                     else "operations"),
        "library_ms": sum(p["library_ms"] for p in per),
    })
    print(json.dumps({"phase_s": phase_s}))
    print(f"chip_smoke.py phases took {obs.now() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
