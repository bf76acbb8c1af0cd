#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py [--seed 0]

Phases, one line each (phases 3, 4, 7 and 10 once per topology, classic
then simplified):

1. build the CUDA kernels of ``tf_seq2seq_losses_tpu_torch/csrc/``, hold
   the Python mirror of each library's shared-memory formula, by which the
   host picks a scheme, against the library's own, and print how many
   label lanes each kernel's shared memory allows;
2. run every kernel (classic B1-B5, B10 and B13, simplified B6-B9 and
   B11, the fused epilogue B12) on the card at the headline shape (B=256,
   T=500, V=32, labels [256, 250]), and at batch 8 with labels [8, 600],
   windows 1 and 16, and blank index 3 with labels over {1, 2}, and hold it
   against its plain PyTorch version on the same inputs: losses rtol 1e-5;
   acts and scaled carries atol 1e-5; block-float residual and carry
   mantissas rtol 1e-5 + atol 1e-6, their exponents exactly; log-space
   residuals rtol 1e-5 + atol 1e-5; inf patterns equal throughout.  The
   forward scans B1 (modes final, resid, bound, resid1) and B6 (final,
   resid, bound) must give their plain versions' outputs bit for bit, at
   every geometry here and also from the standard and a random carry at a
   label for every lanes-per-thread instantiation (``lane_cases``: up to
   the widest label at window 8, then at window 1) and at windows 3 and
   16.  B13's forward (mode resid1) must give mode resid's residuals bit
   for bit.  The streamed beta scans B3, B13 and B7 must give their plain
   versions' acts and beta carry bit for bit, and B13 B3's, at every
   geometry here, and also over the residuals of B1 modes resid and resid1
   and of B6 mode resid from a random carry with a random act normaliser,
   at a label for every lanes-per-thread instantiation of each
   (``lane_cases``) and at windows 3 and 16; B7 also B11's where B11 holds
   the lanes.  B12 runs at batch 8, blank 3, V = 32, 128 and 1000, and on
   random acts at each V over labels of 992, 2048 and 2080 lanes (two act
   rows staged a warp, then one) and the widest it holds (atol 1e-6).
   B4 (modes final and resid) and B5 also run, every lane live on peaked
   logits, at a label for every lanes-per-thread instantiation up to the
   widest label the host sends them (``log_lattice.CLASSIC_LOG_LANES``,
   1568 lanes), and on a repair round of four full-length rows
   (``tools/time_scans.py``); so do B8 (modes final and resid) and B9, up
   to ``log_lattice.SIMPLIFIED_LOG_LANES`` (3200 lanes).  The
   residual-free modes (B10, B11: forward modes bound and final from a
   carry, backward from a beta carry)
   run at the headline shape, at each batch-8 geometry above and at window
   3 (where a window's blank row is not 16-byte aligned), and chunk by
   chunk over T=1500, labels [8, 600], in 3 and in 24 chunks, each chunk
   from the carries the previous chunk's kernels left; their backwards
   must give the plain version's acts and beta carry bit for bit, also
   from random carries with every lane live, at a label for every
   lanes-per-thread instantiation (``lane_cases``: up to the widest
   label at window 8, then at window 1) and at window 3.  The float64
   scans of the guard's pure repair (``classic_alpha64``,
   ``classic_beta64``, ``simplified_alpha64``, ``simplified_beta64``,
   ``ops/pure_scan.py``) run on the repair round with the infeasible row
   0, on a long-T row at full T=4000 (2001 lanes), on labels [8, 2000]
   and on labels too wide for their shared memory (``PURE64_WIDE``:
   the carry read from the output), each bit for bit their plain
   versions, the pure path's loops (else every entry within 1e-12
   relative, the largest difference printed);
3. the main path, with TF32 allowed for float32 matrix products as
   training scripts on an H100 commonly set it: ``classic_ctc_loss`` (then
   ``simplified_ctc_loss``) forward plus ``.backward()``, then a
   forward-only call under ``torch.no_grad()``; finite loss on feasible
   rows, +inf loss and exactly zero d_logits on infeasible rows, loss
   (rtol 1e-5) and d_logits (atol 1e-5) equal to the same topology's pure
   path run on the card in float64 (the float32 pure path's own error is
   printed beside); then, as a path of its own, the training step with
   ``stream_residuals=False``: one launch each of the forward in mode bound
   and the residual-free backward, loss and d_logits bit for bit; then the
   paths of the half-stream scheme and the fused epilogue
   (``drive_slice_paths``): the classic half-stream step (bit for bit the
   streamed one); at V=128 each topology's fused step and a saturated
   batch through it, then the classic half-stream step fused; a classic
   step on labels [8, 2000] (2016 lanes: the residual-free scheme, and a
   repair through the pure path in float64: ``classic_alpha64`` twice,
   ``classic_beta64`` once); for each topology, label arrays wider
   than the kernels hold (a training step through the pure path, an
   evaluation call through the forward's mode final where it holds the
   lanes, else the pure path);
4. the saturation guard: four rows saturated at the logit scale 1e2 and
   1e10 flush and are repaired through the log-space kernels; rows at
   1e2 match the pure path (loss and d_logits atol 2e-4), rows at 1e10
   are finite and match the pure loss (rtol 1e-6), their d_logits are not
   compared (see ``saturate``); every clean row is bit for bit the clean
   batch's;
5. oracles: the README example, loss [5.4931, 2.4485] and grad[0, 0] =
   [1/3, -2/3, 1/3] (atol 1e-3), also from numpy arrays, whose result must
   lie on the card; the simplified loss of labels [[1, 2]] over three
   uniform frames of three tokens, ln 9 (three paths of 1/27; atol 1e-3);
6. timing at the headline shape with CUDA events (each kernel: median of 5
   bursts of 20 back-to-back launches; its plain version: median of 3
   single calls; ``torch.nn.functional.ctc_loss``, the library yardstick
   of the classic loss, its forward for the forward scans and its
   backward alone (``torch.autograd.grad`` on a retained graph) for the
   backward scans: median of 20 single calls; no PyTorch call computes
   the simplified loss) and on the host clock (each topology's
   fwd+bwd step, streamed and residual-free, and forward-only call; the
   steps of ``drive_slice_paths``; each topology's step with four
   full-length rows repaired, and B4, B5, B8 and B9 on that repair round
   by CUDA events): each
   kernel, its plain version and its bound, and the device time of the
   unfused epilogue that B12 replaces at V=128; then a ``torch.profiler``
   breakdown of each step's device time by kernel (also the classic V=128
   step, unfused and fused);
7. long T, a path of its own: B=256, T=4000, V=32 from
   ``benchmarks/long_t.py``'s generator (labels [256, 2000], 8 chunks of
   504 steps, 2016 lanes): a training step, an evaluation call and a step
   with row 2 saturated at 1e2 (12 steps: the guard repairs it on its own
   time axis, through the log-space kernels where they hold the lanes, B8
   and B9 but not B5, else the float64 scans); launches per call, read
   just after that step, the float64 scans' too (a flagged row's repair,
   the simplified row 220 at seed 0, takes an alpha and a beta); the
   classic step's peak device memory under 16 GB.  Then checks outside
   the path: the rows whose forward and beta scans disagree, over the
   whole batch (at seed 0 ``LONG_FLAGGED``,
   repaired through the pure path in float64), and none on peaked
   low-loss logits at T=500 and T=4000; loss (rtol 1e-5) and d_logits
   (atol 1e-5) of ``LONG_ROWS``, repaired rows included, against the pure
   path in float64, and their forward-only loss's relative error printed;
   rows 0-31 bit for bit as one chunk;
   then each topology's step and forward-only call (host clock, median of
   3), one chunk's kernels (CUDA events), ``F.ctc_loss`` there and its
   forward and backward alone on one chunk's frames, and a profile of the
   classic step;
8. the rest of the public API at the headline shape (``drive_extras``),
   for each topology: ``ctc_token_posteriors`` on the kernel path, B2 and
   B3 (B6 resid and B7) once each, and with rows 2-5 flushed (``saturate``)
   also B4 resid and B5 (B8 resid and B9) once each; valid frames sum to 1
   (atol 1e-5), other frames and infeasible rows exactly 0, atol 1e-5 from
   the float64 pure path, the flushed rows 2-3 atol 2e-4 from it and the
   clean rows bit for bit; ``ctc_forced_alignment``, ``ctc_greedy_decode``
   and ``ctc_beam_search_decode`` (K=8) on the whole batch, their tokens,
   lengths and alignments of rows 0-15 equal to the same calls on the CPU
   and their scores rtol 1e-5, the alignments collapsing to the labels;
   ``ctc_sample_alignments`` (32 samples a row, a CUDA generator seeded
   from ``--seed``): every sample collapses to its label, blank past
   ``logit_length``, its log-prob rtol 1e-5 from its frame sum, the counts
   of each token at each frame binomial about the kernel posteriors
   (least two-sided tail probability above 1e-3 over twice the entries,
   the posteriors taken within 1e-5) and their squared deviation within
   10% of its expectation; ``ctc_loss_hessian_vector_product`` on rows
   0-7 (each of its topology's tangent scans launched once): peak memory
   under 2 GB, atol 1e-4 from the central difference of
   the float64 gradient, zero on infeasible rows; then each function's
   time (CUDA events around single calls, median of 5), and a profile of
   the classic forced alignment;
9. the flagship encoder at full width (F=80, H=512, V=128, 4 layers;
   ``drive_encoder``) on B=256 utterances of 1000 frames (T=500 logit
   frames, ``make_inputs(vocab=128)``'s labels and lengths, features
   N(0, 1) from ``--seed``), trained by the eager body of
   ``parallel.make_train_step`` (``train_step_eager``, Adam as before;
   phase 12 runs the graphed step) on a
   1 x 1 ``('data', 'model')`` mesh over a one-rank NCCL group (``file://``
   rendezvous; no fallback to gloo or the CPU): 5 classic Adam steps, each
   launching B2 and B3 once, every loss finite, step 1's masked mean rtol
   1e-5 from the float64 pure path on the step's own logits, and those
   logits of rows 0-7 within ``ENC_LOGITS_ATOL`` of the same parameters on
   the CPU; a fused and an unfused step from the same parameters (B12
   once, the loss bit for bit, each parameter gradient within
   ``ENC_GRAD_SHARE`` of its largest entry); 2 simplified steps (B6 resid
   and B7 once each); a forward-only call of each topology (B1 final, B6
   final); ``tools/train_ctc_asr.py``'s demo for 150 steps at the JAX
   demo's global batch of 64 (greedy token accuracy at least 90%; its
   beam-4 rescoring at V=128 launching ``classic_beam_search`` once) and the
   scan gaps of its trained logits in both topologies; then the step's
   host-clock time, a profile of one step, the loss's forward and backward
   by CUDA events with its roofline (``utils/roofline.py``), and the
   step's peak device memory;
10. the guard's structures, placements and fallback cap
   (``drive_guard_ladder``), for each topology at the headline shape with
   n in ``LADDER_N`` = 0, 1, 20, 40, 80 rows (rows 2 to n + 1) flushed by
   ``saturate`` at 1e2: a training step and a forward-only call under
   ``guard_struct`` "while", "cond" and "while" with ``guard_tier1``, each
   launching what its tier runs (``ladder_tier``: B4 final, B4 resid and
   B5, or B8 final, B8 resid and B9, once a round on the round's rows; a
   "while" round takes 32 rows; "cond" repairs n = 1 through the pure
   path, n = 20 through one gathered round of the flushed rows, and 40 and
   80 through the whole batch of 256 rows); repaired rows atol 2e-4 from
   the float64 pure path (the pure path's 1e-5), clean rows bit for bit
   the clean step's, except under the whole-batch tier, where the loss is
   held to float64 (rtol 1e-5) and loss and d_logits to the same step run
   with the log-space kernels' plain versions (rtol 1e-5, atol 1e-5: the
   float32 log-space route's own distance from float64 grows with the
   row, 1.5e-3 to 2.6e-3 in d_logits at T=500, and is printed), infeasible
   rows +inf with zero d_logits,
   the forward-only loss the step's; ``guard_mode`` "post", "pre" and
   "grad" at n = 0 and 20 with the same loss and d_logits bit for bit,
   "pre" at n = 0 launching what ``guard=False`` launches with one guard
   synchronisation (``nonzero``) a step, where "post" and "grad" take two;
   the fused step at V=128 under "cond" at n = 40 (B12 once, the whole
   batch rerouted, bit for bit the unfused step); under "cond" at n = 40
   with ``CTC_TPU_GUARD_FALLBACK_BYTES`` set for one step, then restored:
   at a tier-2 round's working set the warning "whole-batch exact reroute
   disabled" and rows past the first 32 flushed at +inf, at 1 byte
   "saturation guard disabled" and every flushed row at +inf; then the
   whole-batch tier's B4, B5, B8 and B9 against their plain versions on
   the batch of 256 rows with 80 flushed (phase 2's tolerances), each
   step's and call's host-clock time (median of 20) and its ratio to the
   n=0 step of its struct or mode, profiles of the n=0 steps, and the
   peak device memory of the clean and n=80 steps;
11. the loss under ``torch.func`` (``drive_func``), for each topology with
   TF32 on: the headline batch viewed as ``FUNC_GROUPS`` = 4 groups of 64
   rows through ``torch.func.vmap`` of the loss (B1 final, or B6 final,
   once) and of ``torch.func.grad`` of its finite sum (B2 and B3, or B6
   resid and B7, once: the groups fold into one batch), clean and with
   rows 2-5 flushed at 1e2 (also B4 final, B4 resid and B5, or B8 final,
   B8 resid and B9, once), bit for bit the unmapped call's loss and
   ``.backward()``'s loss and d_logits; ``torch.func.grad`` on the whole
   batch, bit for bit ``.backward()``'s, and at V=128 with
   ``fused_epilogue`` launching B12 once; ``jacrev(grad)`` at B=2, T=12,
   V=5 with the kernels on, at the logits and log-probability levels,
   the same with the fusion on and off and atol 1e-5 from the double
   backward of the pure path in float64 (PyTorch's autograd through the
   recursions); ``jacrev`` three times raising ``NotImplementedError``;
   then the plain, ``grad`` and ``vmap(grad)`` steps on the host clock
   (median of 20);
12. the jitted paths, the counterparts of the JAX package's ``jax.jit``
   as CUDA graphs (``drive_jit``): for each topology the loss and
   ``torch.autograd.grad`` to d_logits at the headline captured in one
   graph (the guard's device form: 8 IF-node rounds of 32 rows in each
   guard), replayed on phase 10's batches (n in ``LADDER_N``), each replay
   bit for bit the eager step (a row that is not must be a flushed row
   within 2e-4 of float64), each replay's log-space launches counted on
   the device (``DeviceTally``: one round of B4 final, B4 resid and B5, or
   B8 final, B8 resid and B9, in each guard per 32 flushed rows), no
   log-space kernel in the n=0 replay's profile and the backward's two
   rounds (B4 resid and B5, or B8 resid and B9, twice each; the forward's
   final mode once or twice: one profile in the whole smoke has shown one
   of its two, where the device count of that replay shows two) in the
   n=40 replay's, the profiled replays' outputs too bit for bit, and the
   eager and graphed steps'
   host ms (median of 20), device ms and idle share (one profile), and the
   n=80 replay's peak device memory; the same step captured under
   ``guard_struct="cond"`` (each topology) and ``repair_bucket=0``
   (classic, the two-way guard), one IF node a tier (``drive_jit_cond``),
   replayed on the same batches, each replay bit for bit the eager step
   under the same config, its log-space launches counted on the device
   against ``ladder_tier("cond", ...)`` (none at n = 0 and 1, one
   gathered round at 20, the whole batch at 40 and 80; under
   ``repair_bucket=0`` the whole batch at any n > 0) and its pure rounds
   (``PureTally``: tier 1's at n = 1 only), with eager and graphed host
   ms, device ms, idle share and the replays' CUDA-event ms at each n, the
   capture's seconds and nodes, tier 1's bodies' nodes and seconds, and
   the n=80 replay's peak memory beside the "while" graph's; the fused
   V=128 step under "cond" captured and replayed at n = 40 (B12 once in
   the graph, the whole batch counted on the device, bit for bit the eager
   fused step); on one
   NCCL rank ``make_train_step`` on the encoder at phase 9's full width,
   ``JIT_RUNS`` graphed steps against the eager body from the same
   parameters (step 1's loss bit for bit, the others rtol 1e-5, the last
   gradients within ``ENC_GRAD_SHARE``), both steps' times, idle shares
   and peak memory, and the graphed ``sharded_mean_ctc_loss`` bit for bit
   its eager function (loss and d_logits, clean and with 40 rows flushed,
   each call's still so after the next call, two forwards before one
   backward, and a ``no_grad`` call);
   the graphed ``sharded_mean_ctc_loss`` also on the clean classic long-T
   batch, bit for bit its eager function; (d) for each topology the long-T
   step (B=256, T=4000, 8 chunks, guard "while") captured, each repair
   round an IF node at full T through the float64 scans, 16 rounds of 16
   rows a guard (``drive_jit_long_t``), replayed on the seed's batch and
   with rows 2-21 flushed by ``saturate`` (two rounds a guard): rows that
   differ from the eager step are repaired rows, within 1e-5 of float64
   and of the eager step within 1e-6 (2e-4 where the eager step took the
   float32 log-space kernels), the float64 scans counted on the device
   (``ScanTally``), none of the log-space ones; the capture's seconds and
   nodes, each round's nodes, the replays' and the eager steps' host and
   CUDA-event ms and each replay's peak memory;
13. the loss under ``torch.compile(fullgraph=True, dynamic=False)``,
   inductor's default mode, its cache in a new temporary directory
   (``drive_compile``): the kernels are ``ctc_port::`` custom ops of the
   graph and the guard's rounds ``torch.cond``.  (a) For each topology at
   the headline the training step (the compiled loss and its finite sum,
   ``.backward()`` through the compiled backward) and the forward-only
   call: one graph each, the eager call's launches (B2 and B3, B6 resid and
   B7; B1 final, B6 final), loss rtol 1e-5 and d_logits atol 1e-5 from
   float64, the largest difference from the eager step printed; (b) the
   classic step on phase 10's batches at n = 0, 1, 40 rows flushed under
   "while" ((a)'s graph), "cond" and ``repair_bucket=0``: one graph for
   every n (no recompile), the eager step's launches at each n (repairs by
   tier: none at n = 0, none through tier 1's pure path), loss and
   d_logits within phase 3's 1e-5 of the eager step's, repaired rows 2e-4
   from float64, clean rows the clean compiled step's bits but where the
   whole batch reroutes (then the loss rtol 1e-5 from float64); (c) the
   classic fused step at V=128 (B12 once), held as in phase 3; (d) the
   classic long-T step (B=256, T=4000, 8 chunks; row 220 infeasible at
   seed 0) compiled with ``backend="aot_eager"`` (``LONG_T_BACKEND``:
   inductor's code generation for it takes over ten minutes), its launches
   the eager step's, its loss and d_logits the eager step's bit for bit,
   ``LONG_ROWS`` held to float64 as in phase 7, its peak memory; (e) the
   flagship encoder (phase 9's
   widths and batch, one device) whose forward and finite-mean classic
   loss are compiled with their backward, 5 Adam steps (the optimizer
   eager) from the same seed as 5 eager steps: B2 and B3 once a step, step
   1's loss within 1e-3 relative of the eager step's, its parameter
   gradients within ``ENC_GRAD_SHARE`` of each tensor's largest entry.
   Each case prints its host ms (median of 20; of 3 at long T and for a
   call over a quarter second), device ms and idle share (one profile of
   3 calls), compile seconds (the first call's) and graph count, beside
   the eager call's;
14. forced alignment, sampling and decoding under the transforms
   (``drive_transforms``), for each topology at phase 8's headline batch
   (rows 0 and 1 infeasible): (a) the float32 forward
   (``classic_alpha32``, ``simplified_alpha32``: the float64 scans' kernels
   instantiated in float32), Viterbi (``classic_viterbi``,
   ``simplified_viterbi``, csrc/viterbi.cu) and the sampling walk
   (``classic_walk``, ``simplified_walk``, csrc/walk.cu; 32 samples) bit
   for bit their plain versions, the loops, on the same inputs, and beam
   search (``classic_beam_search``, ``simplified_beam_search``,
   csrc/beam_search.cu; K=8, its pool in shared memory) bit for bit the
   loop in tokens, lengths and scores, also at K=16, V=1024 (the pool in a
   global scratch row), and the public calls launching each once (forced
   alignment Viterbi, the sampler the forward and the walk, beam search
   its kernel); (b) ``ctc_forced_alignment``,
   ``ctc_sample_alignments`` (its CUDA generator registered with the
   graph), ``ctc_greedy_decode`` and ``ctc_beam_search_decode`` (K=8)
   captured as CUDA graphs, replays bit for bit the eager calls (the
   sampler's from a generator seeded alike, two seeds), the graphs' nodes;
   (c) alignment and sampler of both topologies and the classic decoders
   under ``torch.compile(fullgraph=True, dynamic=False)`` with inductor:
   one graph each, cold compile seconds, the eager call's launches,
   alignments and tokens equal, scores rtol 1e-6, the sampler
   (``generator=None``, ``fallback_random``) the eager call's from the same
   seed, twice; (d) ``torch.func.vmap`` over 4 groups of 64 rows of
   alignment, greedy, beam search and the walk on fixed noise, bit for bit
   the unmapped call on the folded batch, each kernel (beam search's too)
   once a mapped call; (e) the gradients of the alignment's, the walk's
   and beam search's scores: the backward kernels (``classic_viterbi_grad``,
   ``simplified_viterbi_grad``, ``classic_walk_grad``,
   ``simplified_walk_grad``, ``classic_beam_search_grad``,
   ``simplified_beam_search_grad``) bit for bit their plain
   versions under a random cotangent in (a), also on the wide labels
   (beam search's at the headline, at K=16, V=1024 and on the small edge
   cases); the eager gradient bit for bit autograd through the loops
   (beam search's within rtol 1e-6: the loop's own adds on the card are
   atomics and CUDA reductions), launching the forward kernels and the
   backward kernel once; ``torch.func.vmap`` of
   ``torch.func.grad`` over 4 groups of 64 bit for bit the folded
   gradient; the gradient captured as a CUDA graph, its replay bit for bit
   the eager one; compiled with inductor, one graph, rtol 1e-6.  Times:
   host ms (median of 5; of 3 for a call over a quarter second) of the
   eager call, of the plain loops on the card (alignment and sampler; beam
   search's loop one call), of the replay and of the compiled call, and of
   the gradient eager, replayed and compiled beside the plain loops'
   gradient (one call); a replay's device ms (CUDA events) and the eager
   call's idle share by it; device ms and idle share of one profile of the
   eager call;
15. the Hessian-vector product through its tangent scans (``drive_hvp``),
   for each topology at phase 8's headline batch along a N(0, 1) vector:
   (a) the tangent scans (``classic_alpha_jvp64``, ``classic_beta_jvp64``,
   ``simplified_alpha_jvp64``, ``simplified_beta_jvp64``: the float64
   scans' steps with a tangent beside each value, ``ops/pure_scan.py``)
   bit for bit their plain versions, the loops over (value, tangent)
   pairs (else within 1e-12 relative, the largest difference printed),
   on rows 0-7, the whole batch, the long-T row (T=4000, 2001 lanes) and
   labels wider than shared memory holds (``HVP_WIDE``, 3701 / 7401
   lanes), and ``ctc_loss_hessian_vector_product`` launching each of its
   two scans once; (b) the whole batch's HVP within atol 1e-4 of the
   float64 central difference, zero on the infeasible rows, its peak
   memory; (c) rows 0-7 and the whole batch captured as CUDA graphs, each
   replay bit for bit the eager call, the graphs' nodes; (d) the whole
   batch's HVP under ``torch.compile(fullgraph=True, dynamic=False)`` with
   inductor: one graph, cold compile seconds, rtol 1e-6 / atol 1e-7 from
   the eager call; (e) ``torch.func.vmap`` over 4 groups of 64 rows bit
   for bit the unmapped call on the folded batch.  Times: host ms (median
   of 5) of the eager call, the replay and the compiled call, the
   forward-mode loop the HVP was before (one call, rows 0-7), the
   replay's device ms by CUDA events.

The launch counts are set to 0 before each path (a topology's phases 3
and 4, its residual-free step, each path of ``drive_slice_paths``, its
phase 7, each posteriors call of phase 8, each step and call of phase 9,
each step, call and pair of them of phase 10, each call of phase 11, each
capture of phase 12, each call of phase 13, each public, captured,
compiled and mapped call of phase 14, phase 8's HVP and each public,
captured, compiled and mapped call of phase 15) and read after it: a
kernel that its path never launched fails the run, and the ``kernels``
line gives each kernel's launches summed over the paths (the float64
scans' over phase 3's labels [8, 2000], phase 7 and phase 12's captures;
phase 14's kernels over its paths, ``classic_beam_search`` also over
phase 9's demo; the tangent scans over phases 8 and 15).  A graph's replays
launch nothing on the host: its kernels count once, at the capture.  A
compiled function's kernels count at every call: their custom ops count
where they launch, at run time.  The last lines are the ``kernels`` JSON,
the card's name and power limit, and ``{"ok": true, "device": ...}``.  Any
failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
BATCH, MAX_T, VOCAB = 256, 500, 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM, float64 outside the tensor cores
RUNS = 20
PLAIN_RUNS = 3  # the plain versions take 0.1 to 0.4 s a launch at the headline
LONG_RUNS = 3  # a long-T step takes 0.15-0.4 s


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_inputs(torch, seed: int, dev, batch=None, label_width=None, max_t=None,
                infeasible=True, vocab=None):
    """Headline inputs: labels [B, T/2] in 1..V-1, N(0, 1) logits,
    label_length in [T/4, T/2), logit_length in [T/2, T); rows 0 and 1 are
    made infeasible (logit_length below label_length) unless
    ``infeasible`` is False.  ``label_width`` widens the label array (its
    extra columns are past every label_length) or narrows it (label_length
    then in [W/2, W)); ``vocab`` replaces V.  With ``infeasible=False`` this
    is the generator of ``benchmarks/long_t.py``."""
    import numpy as np

    vocab = vocab or VOCAB
    batch = batch or BATCH
    max_t = max_t or MAX_T
    width = label_width or max_t // 2
    hi = min(max_t // 2, width)
    rng = np.random.RandomState(seed)
    labels = rng.randint(1, vocab, (batch, width)).astype(np.int32)
    logits = rng.randn(batch, max_t, vocab).astype(np.float32)
    label_length = rng.randint(min(max_t // 4, hi // 2), hi, (batch,)).astype(np.int32)
    logit_length = rng.randint(max_t // 2, max_t, (batch,)).astype(np.int32)
    if infeasible:
        logit_length[:2] = label_length[:2] // 2
    return tuple(torch.as_tensor(a, device=dev) for a in (
        labels, logits, label_length, logit_length))


def saturate(torch, labels, logits, label_length, logit_length,
             rows=((2, 1e2), (3, 1e2), (4, 1e10), (5, 1e10))):
    """Rows 2..5 (or ``rows``, pairs of row and scale): label_length 5,
    logit_length 12, and at frame 3 one token absent from the label (not
    blank) at +s, every other token at -s, with s = 1e2 for rows 2, 3 and
    1e10 for rows 4, 5.  Every path pays ~2s
    there: the block-float forward flushes, the exact loss is finite.

    At s = 1e10 the loss is 2e10 plus about 12, and float32 holds it only
    to its ulp there, 2048.  Every float32 path, the pure one included,
    normalises the posteriors by that loss, so its d_logits keep no digits
    on these rows: they are held to finiteness, and the distance of the
    float32 pure path from float64 there is printed to show it."""
    logits = logits.clone()
    label_length = label_length.clone()
    logit_length = logit_length.clone()
    for row, scale in rows:
        label_length[row] = 5
        logit_length[row] = 12
        used = set(labels[row, :5].tolist()) | {0}
        token = min(set(range(VOCAB)) - used)
        logits[row, 3] = -scale
        logits[row, 3, token] = scale
    return logits, label_length, logit_length


def close(a, b, rtol, atol) -> bool:
    import torch

    a = a.double()
    b = b.double()
    same_inf = torch.equal(torch.isinf(a), torch.isinf(b)) and torch.equal(
        a[torch.isinf(a)], b[torch.isinf(b)]
    )
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not same_inf or not torch.equal(torch.isnan(a), torch.isnan(b)):
        return False
    return bool(torch.all(torch.abs(a[fin] - b[fin]) <= atol + rtol * torch.abs(b[fin])))


def agree(a, b, rtol, atol, what) -> None:
    """Fail unless ``a`` and ``b`` agree (equal inf/NaN patterns, then
    ``|a - b| <= atol + rtol |b|``); the message carries the largest error."""
    if not close(a, b, rtol, atol):
        raise CheckFailed(f"{what}: max abs err {max_err(a, b):.3g} "
                          f"(rtol {rtol}, atol {atol})")


def max_err(a, b) -> float:
    import torch

    a = a.double()
    b = b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    return float(torch.max(torch.abs(a[fin] - b[fin])))


def time_ms(torch, fn, runs=5, burst=RUNS, warmup=True) -> float:
    """Device time per call of ``fn``, after one warm-up (unless the caller
    has just run ``fn``: ``warmup=False``): the median over
    ``runs`` of CUDA events around ``burst`` calls issued back to back,
    divided by ``burst``.  Queued calls hide the host's time to issue one
    behind the previous kernel, so a slow host does not count as device
    time.  ``burst=1`` times single calls: for a function that waits for
    the host inside (the plain versions, ``F.ctc_loss``), queued calls
    would not overlap, and a mean over them would take in the host's
    outliers."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return statistics.median(times)


def host_ms(torch, fn, runs=RUNS) -> float:
    """Median wall time of ``fn`` ending in a synchronize (step time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def pure_float64(labels, logits, label_length, logit_length, topology="classic"):
    """The port's pure log-space path of ``topology`` evaluated in float64:
    the reference for the main path at T=500, where the float32 pure path's
    own rounding (about an ulp of a loss near 1e3 per step) reaches 1e-3."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops.topology import compose_dlogits
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    c, loss, grad = pure_float64_grad(labels, logit_to_logproba(logits.double(), 2),
                                      label_length, logit_length, topology)
    return loss, compose_dlogits(c, grad, loss, torch.ones_like(loss))


def pure_float64_grad(labels, lp64, label_length, logit_length, topology="classic"):
    """``(context, loss, gradient)`` of the pure path of ``topology`` at the
    float64 log-probabilities ``lp64``, in float64."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES

    topo = TOPOLOGIES[topology]
    c = core.make_context(labels, lp64, label_length, logit_length, 0)
    forced = torch.where(c.logit_length_mask[:, :, None], lp64, c.logproba.double())
    c = c._replace(logproba=forced, raw_logproba=lp64,
                   blank_lp=core.take_blank_logproba(forced, c.blank_index))
    alpha = topo.alpha(c)
    loss = topo.loss(c, alpha)
    return c, loss, -torch.exp(core.gradient_log(topo, c, loss, alpha))


def compare_kernels(ctx):
    """Run every classic kernel and its plain version on the same inputs and
    hold them together; returns ``(max abs errors, kernel arguments)``."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl

    dev = ctx.logproba.device
    blank, dcu, lm, nb, rep, lens, lab_len, k_win = cl.kernel_inputs(ctx)
    batch, tpad, lpad = dcu.shape
    errs = {}

    def pick(f0, f1, fe):
        return cl.pick_loss(f0 + f1, fe, lab_len)

    f_k = cl.classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, "final")
    f_p = cl.classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win, "final")
    loss_k, loss_p = pick(*f_k), pick(*f_p)
    agree(loss_k, loss_p, 1e-5, 0.0, "classic_fwd[final] loss vs plain")
    errs["classic_fwd[final]"] = max_err(loss_k, loss_p)

    r_k = cl.classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, "resid")
    r_p = cl.classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win, "resid")
    rl_k, rl_p = pick(*r_k[2:]), pick(*r_p[2:])
    agree(rl_k, rl_p, 1e-5, 0.0, "classic_fwd[resid] loss vs plain")
    valid_t = (torch.arange(tpad, device=dev)[None, :] < lens[:, None])
    agree(r_k[0][valid_t], r_p[0][valid_t], 1e-5, 1e-6,
          "classic_fwd[resid] residual mantissas vs plain")
    errs["classic_fwd[resid]"] = max(max_err(rl_k, rl_p),
                                     max_err(r_k[0][valid_t], r_p[0][valid_t]))

    ebi = cl.ebi_from_loss(rl_k)
    b_args = (blank, dcu, lm, nb, rep, lens, lab_len, ebi, r_k[0], r_k[1], k_win)
    b_k = cl.classic_bwd_streamed(*b_args)
    errs["classic_bwd_streamed"] = agree_carry(
        b_k, cl.classic_bwd_streamed_plain(*b_args),
        "classic_bwd_streamed pc and beta carry")

    # the half-stream pair (B13): mode resid1, then the backward that
    # rebuilds a0; the latter bit for bit B3 on the same forward
    h_k = cl.classic_fwd(blank, dcu, lm, nb, rep, lens, k_win, "resid1")
    h_p = cl.classic_fwd_plain(blank, dcu, lm, nb, rep, lens, k_win, "resid1")
    valid_w = (torch.arange(tpad // k_win, device=dev)[None, :] * k_win < lens[:, None])
    agree(pick(*h_k[3:]), rl_p, 1e-5, 0.0, "classic_fwd[resid1] loss vs plain")
    agree(h_k[0][valid_t], h_p[0][valid_t], 1e-5, 1e-6,
          "classic_fwd[resid1] a1 residuals vs plain")
    agree(h_k[2][valid_w], h_p[2][valid_w], 1e-5, 1e-6,
          "classic_fwd[resid1] a0 window residuals vs plain")
    check(torch.equal(h_k[1][valid_w], h_p[1][valid_w]),
          "classic_fwd[resid1] frames vs plain")
    check(torch.equal(h_k[0][valid_t], r_k[0][:, :, 1][valid_t])
          and torch.equal(h_k[2][valid_w], r_k[0][:, ::k_win, 0][valid_w])
          and torch.equal(h_k[1][valid_w], r_k[1][valid_w]),
          "classic_fwd[resid1] residuals are mode resid's bit for bit")
    errs["classic_fwd[resid1]"] = max(max_err(pick(*h_k[3:]), rl_p),
                                      max_err(h_k[0][valid_t], h_p[0][valid_t]),
                                      max_err(h_k[2][valid_w], h_p[2][valid_w]))
    hb_args = (blank, dcu, lm, nb, rep, lens, lab_len, ebi, *h_k[:3], k_win)
    hb_k = cl.classic_bwd_half(*hb_args)
    errs["classic_bwd_half"] = agree_carry(
        hb_k, cl.classic_bwd_half_plain(*hb_args), "classic_bwd_half pc and beta carry")
    check(all(torch.equal(a, b) for a, b in zip(hb_k, b_k)),
          "classic_bwd_half pc and beta carry are B3's bit for bit")

    log_errs, log_fwd, log_bwd = compare_classic_log(ctx)
    errs.update(log_errs)
    args = dict(fwd=(blank, dcu, lm, nb, rep, lens, k_win), bwd=b_args,
                half_bwd=hb_args, log_fwd=log_fwd, log_bwd=log_bwd,
                lens=lens, k_win=k_win, shape=(batch, tpad, lpad))
    return errs, args


def compare_classic_log(ctx, where=""):
    """Run B4 in modes final and resid, then B5 over mode resid's residuals
    with the act normaliser of its loss, on ``ctx``, and hold each against
    its plain version (the plain mode resid's carries are mode final's
    too): losses rtol 1e-5, residuals rtol 1e-5 + atol 1e-5, pc atol 1e-5,
    beta carry rtol 1e-5, inf patterns equal.  Returns ``(max abs errors,
    B4's arguments, B5's)``."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

    blank_l, dc_l, pt_l, _lm, nb, rep, lens, lab_len = ll._log_inputs(ctx)
    valid_t = torch.arange(dc_l.shape[1], device=lens.device)[None, :] < lens[:, None]
    log_fwd = (blank_l, dc_l, pt_l, nb, rep, lens)
    lr_p = ll.classic_log_fwd_plain(*log_fwd, "resid")
    loss_p = ll._pick_log_loss(*lr_p[2:], lab_len)
    errs = {}
    loss_k = ll._pick_log_loss(*ll.classic_log_fwd(*log_fwd, "final"), lab_len)
    agree(loss_k, loss_p, 1e-5, 0.0, f"classic_log_fwd[final] loss vs plain{where}")
    errs["classic_log_fwd[final]"] = max_err(loss_k, loss_p)

    lr_k = ll.classic_log_fwd(*log_fwd, "resid")
    lrl_k = ll._pick_log_loss(*lr_k[2:], lab_len)
    agree(lrl_k, loss_p, 1e-5, 0.0, f"classic_log_fwd[resid] loss vs plain{where}")
    for i, name in ((0, "x"), (1, "a1")):
        agree(lr_k[i][valid_t], lr_p[i][valid_t], 1e-5, 1e-5,
              f"classic_log_fwd[resid] residual {name} vs plain{where}")
    errs["classic_log_fwd[resid]"] = max(
        max_err(lr_k[i][valid_t], lr_p[i][valid_t]) for i in (0, 1)
    )

    safe = torch.where(torch.isfinite(lrl_k), lrl_k, torch.zeros_like(lrl_k))
    log_bwd = (*log_fwd, lab_len, safe, lr_k[0], lr_k[1])
    lb_k = ll.classic_log_bwd(*log_bwd)
    lb_p = ll.classic_log_bwd_plain(*log_bwd)
    agree(lb_k[0], lb_p[0], 0.0, 1e-5, f"classic_log_bwd pc vs plain{where}")
    agree(lb_k[1][:, 0], lb_p[1][:, 0], 1e-5, 0.0,
          f"classic_log_bwd beta0 vs plain{where}")
    errs["classic_log_bwd"] = max(max_err(lb_k[0], lb_p[0]),
                                  max_err(lb_k[1][:, 0], lb_p[1][:, 0]))
    return errs, log_fwd, log_bwd


def log_lane_widths(topology="classic") -> list:
    """Label widths for every lanes-per-thread instantiation of the log
    kernels of ``topology`` (B4 and B5, or B8 and B9; 512 threads, lanes
    t + j * threads) up to the widest label the host sends them,
    ``log_lattice.CLASSIC_LOG_LANES`` or ``SIMPLIFIED_LOG_LANES``: each
    instantiation's widest, so that label is among them."""
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

    widest = {"classic": ll.CLASSIC_LOG_LANES,
              "simplified": ll.SIMPLIFIED_LOG_LANES}[topology]
    return [min(512 * lpt, widest) - 1 for lpt in range(1, -(-widest // 512) + 1)]


def compare_log_lanes(torch, dev, seed, topology="classic", batch=2) -> dict:
    """Hold the log kernels of ``topology`` against their plain versions
    (``compare_classic_log``, ``compare_simplified_log``) at a label for
    every lanes-per-thread instantiation (``log_lane_widths``), every lane
    live: labels of their full width (``label_length`` the width), peaked
    logits (``peaked``: losses of a few nats, so that float32 carries keep
    their digits) over a few more frames than the labels (and in the
    classic topology their repeats) need; then on the repair round of
    ``tools/time_scans.py`` (rows 2-5 of the headline batch flushed at one
    frame, at their own lengths and time axis).  Returns the largest error
    of each kernel mode."""
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.tools import time_scans
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    compare = {"classic": compare_classic_log, "simplified": compare_simplified_log}[
        topology]
    errs = {}
    for width in log_lane_widths(topology):
        labels, logits, _, _ = make_inputs(torch, seed + width, dev, batch=batch,
                                           label_width=width, max_t=2 * width,
                                           infeasible=False)
        # a frame for each label, one for each repeat, and a few more
        repeats = int((labels[:, 1:] == labels[:, :-1]).sum(1).max())
        logits = logits[:, :width + repeats + 8].contiguous()
        full = torch.full((batch,), width, dtype=torch.int32, device=dev)
        steps = torch.full((batch,), logits.shape[1], dtype=torch.int32, device=dev)
        logits = peaked(torch, topology, labels, full, steps, logits)
        ctx = core.make_context(labels, logit_to_logproba(logits, 2), full, steps, 0)
        e, _, log_bwd = compare(ctx, f" at {width + 1} lanes, every lane live")
        # the backward's act normaliser: the loss, 0 where it is +inf
        loss = log_bwd[-3] if topology == "classic" else log_bwd[-2]
        check(bool((loss > 0).all()),
              f"{topology} log lanes at {width + 1}: every row feasible")
        for name, v in e.items():
            errs[name] = max(errs.get(name, 0.0), v)
    round_ctx = time_scans.repair_round(sys.modules[__name__], torch, dev, seed)
    for name, v in compare(round_ctx, " on the repair round")[0].items():
        errs[name] = max(errs[name], v)
    return errs


# ---- the float64 pure scans (ops/pure_scan.py) ---------------------------------
PURE64 = {  # kernel: (topology, source, the JAX package's lax.scan it stands for)
    "classic_alpha64": ("classic", "csrc/classic_pure64.cu",
                        "tf_seq2seq_losses_tpu/ops/classic.py:136"),
    "classic_beta64": ("classic", "csrc/classic_pure64.cu",
                       "tf_seq2seq_losses_tpu/ops/classic.py:184"),
    "simplified_alpha64": ("simplified", "csrc/simplified_pure64.cu",
                           "tf_seq2seq_losses_tpu/ops/simplified.py:63"),
    "simplified_beta64": ("simplified", "csrc/simplified_pure64.cu",
                          "tf_seq2seq_losses_tpu/ops/simplified.py:92"),
}
# float64 operations a lattice cell: classic three logsumexps (subtract,
# exp, log1p, add) and four adds, simplified one and two
PURE64_CELL_OPS = {"classic": 16, "simplified": 6}
# the unstaged route (the carry read from the output): labels wider than
# the staged kernels' shared memory holds, 7264 / 14528 lanes on an H100
PURE64_WIDE = {"classic": 7400, "simplified": 14600}


def pure64_args(ctx) -> dict:
    """``{kernel: (kernel call, plain call, arguments)}`` of the four float64
    scans on the float64 form of ``ctx`` (``core.float64_context``), the
    arguments that ``pure_scan.SCANS`` gives them."""
    from tf_seq2seq_losses_tpu_torch.ops import classic, core, pure_scan, simplified

    c64 = core.float64_context(ctx)
    t = classic.terms(c64)
    c_args = tuple(a.contiguous() for a in (t.blank_lp, t.prev_tok_masked,
                                            t.diag_closed, t.diag_open))
    s_args = (c64.blank_lp.contiguous(), core.expected_token_lp(c64).contiguous())
    lab = c64.label_length
    return {
        "classic_alpha64": (pure_scan.classic_alpha64, classic.alpha_scan, c_args),
        "classic_beta64": (pure_scan.classic_beta64, classic.beta_scan, c_args + (lab,)),
        "simplified_alpha64": (pure_scan.simplified_alpha64, simplified.alpha_scan, s_args),
        "simplified_beta64": (pure_scan.simplified_beta64, simplified.beta_scan,
                              s_args + (lab,)),
    }


def pure64_bound(name, args) -> tuple:
    """``(bytes, float64 operations, the float64 rate)`` of a float64 scan
    on ``args``: every step of every lane (the pure path runs them all),
    ``blank_lp`` and the terms read once, ``label_length`` too, the lattice
    ``[B, T+1, Lp1(, 2)]`` written once."""
    topology = PURE64[name][0]
    terms = [a for a in args if a.dim() == 3]
    batch, num_t, lp1 = terms[0].shape
    states = 2 if topology == "classic" else 1
    lengths = batch if name.endswith("beta64") else 0
    nbytes = 8 * (batch * num_t + len(terms) * batch * num_t * lp1
                  + states * batch * (num_t + 1) * lp1 + lengths)
    return nbytes, PURE64_CELL_OPS[topology] * batch * num_t * lp1, F64_OPS_PER_S


def rel_err(a, b) -> float:
    """The largest ``|a - b| / |b|`` over the entries finite in both (``|a -
    b|`` where ``b`` is 0)."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    diff = torch.abs(a[fin] - b[fin])
    scale = torch.abs(b[fin])
    return float(torch.max(torch.where(scale > 0, diff / scale, diff)))


def pure64_contexts(torch, dev, seed) -> dict:
    """``{case: float32 context}`` on which phase 2 holds the float64 scans
    to their plain versions, each with -inf entries (the lanes past a
    label, a flushed frame) and an infeasible row: the repair round of
    ``tools/time_scans.py`` (rows 2-5 flushed) with the infeasible row 0
    (``time_scans.pure_round``); a long-T row at full T (row 2 of the
    long-T batch, with its infeasible row 0, gathered as the guard's
    device form gathers a round: ``topology._take_rows``); labels [8,
    2000] at T=500; and labels wider than the staged kernels hold
    (``PURE64_WIDE``, T=64), which read their carry from the output."""
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import topology as topo_mod
    from tf_seq2seq_losses_tpu_torch.tools import time_scans
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    def ctx_of(inputs):
        return core.make_context(inputs[0], logit_to_logproba(inputs[1], 2), *inputs[2:],
                                 0)

    long_ctx = ctx_of(make_inputs(torch, seed, dev, max_t=LONG_T))
    out = {
        "repair round": time_scans.pure_round(sys.modules[__name__], torch, dev, seed),
        f"long-T row (T={LONG_T})": topo_mod._take_rows(
            long_ctx, torch.tensor([0, 2], device=dev)),
        f"labels [8, {WIDE_LABELS}]": ctx_of(make_inputs(
            torch, seed + 4, dev, batch=8, label_width=WIDE_LABELS)),
    }
    for topology, width in PURE64_WIDE.items():
        out[f"{topology} labels [3, {width}] (unstaged)"] = ctx_of(make_inputs(
            torch, seed + 5, dev, batch=3, label_width=width, max_t=64))
    return out


def compare_pure64(torch, dev, seed) -> tuple:
    """Hold each float64 scan to its plain version on ``pure64_contexts``:
    bit for bit, or failing that every finite entry within 1e-12 relative
    (the same inf pattern).  Returns ``(largest abs error by kernel,
    largest relative error by kernel and case, the long-T row's kernel ms
    by kernel)``."""
    errs, rel, long_ms = {}, {}, {}
    for case, ctx in pure64_contexts(torch, dev, seed).items():
        unstaged = case.endswith("(unstaged)")
        for name, (kern, plain, args) in pure64_args(ctx).items():
            if unstaged and not case.startswith(PURE64[name][0]):
                continue
            got, want = kern(*args), plain(*args)
            check(got.dtype == want.dtype == torch.float64 and got.shape == want.shape,
                  f"{name} on {case}: {got.dtype} {tuple(got.shape)} against "
                  f"{want.dtype} {tuple(want.shape)}")
            same = torch.equal(got, want)
            r = 0.0 if same else rel_err(got, want)
            check(same or (close(got, want, 1e-12, 0.0)),
                  f"{name} on {case}: not its plain version's bits, largest relative "
                  f"difference {r:.3g} (limit 1e-12)")
            errs[name] = max(errs.get(name, 0.0), max_err(got, want))
            rel[f"{name} on {case}"] = "bit for bit" if same else r
            if case.startswith("long-T"):
                long_ms[name] = time_ms(torch, lambda: kern(*args), runs=3, burst=1)
    return errs, rel, long_ms


def compare_simplified_kernels(ctx):
    """The same for the simplified kernels (B6-B9), at the same tolerances:
    ``(max abs errors, kernel arguments)``."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

    dev = ctx.logproba.device
    blank, dg, _lm, lens, lab_len, k_win = cs.simplified_kernel_inputs(ctx)
    tpad = dg.shape[1]
    valid_t = (torch.arange(tpad, device=dev)[None, :] < lens[:, None])
    errs = {}

    def pick(f, fe):
        return cl.pick_loss(f, fe, lab_len)

    loss_k = pick(*cs.simplified_fwd(blank, dg, lens, k_win, "final"))
    loss_p = pick(*cs.simplified_fwd_plain(blank, dg, lens, k_win, "final"))
    agree(loss_k, loss_p, 1e-5, 0.0, "simplified_fwd[final] loss vs plain")
    errs["simplified_fwd[final]"] = max_err(loss_k, loss_p)

    r_k = cs.simplified_fwd(blank, dg, lens, k_win, "resid")
    r_p = cs.simplified_fwd_plain(blank, dg, lens, k_win, "resid")
    rl_k, rl_p = pick(*r_k[2:]), pick(*r_p[2:])
    agree(rl_k, rl_p, 1e-5, 0.0, "simplified_fwd[resid] loss vs plain")
    agree(r_k[0][valid_t], r_p[0][valid_t], 1e-5, 1e-6,
          "simplified_fwd[resid] residual mantissas vs plain")
    errs["simplified_fwd[resid]"] = max(max_err(rl_k, rl_p),
                                        max_err(r_k[0][valid_t], r_p[0][valid_t]))

    ebi = cl.ebi_from_loss(rl_k)
    b_args = (blank, dg, lens, lab_len, ebi, r_k[0], r_k[1], k_win)
    b_k = cs.simplified_bwd_streamed(*b_args)
    b_p = cs.simplified_bwd_streamed_plain(*b_args)

    def beta_loss(b):
        return -(torch.log(b[1][:, 0]) + b[2][:, 0].float() * cl.LN2)

    agree(beta_loss(b_k), beta_loss(b_p), 1e-5, 0.0,
          "simplified_bwd_streamed beta carry vs plain")
    errs["simplified_bwd_streamed"] = max(
        agree_carry(b_k, b_p, "simplified_bwd_streamed pd and beta carry"),
        max_err(beta_loss(b_k), beta_loss(b_p)))

    log_errs, log_fwd, log_bwd = compare_simplified_log(ctx)
    errs.update(log_errs)
    args = dict(fwd=(blank, dg, lens, k_win), bwd=b_args, log_fwd=log_fwd,
                log_bwd=log_bwd)
    return errs, args


def compare_simplified_log(ctx, where=""):
    """Run B8 in modes final and resid, then B9 over mode resid's residual
    with the act normaliser of its loss, on ``ctx``, and hold each against
    its plain version, at ``compare_classic_log``'s tolerances.  Returns
    ``(max abs errors, B8's arguments, B9's)``."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

    blank_l, dg_l, _lm, lens, lab_len = ll.simplified_log_inputs(ctx)
    valid_t = torch.arange(dg_l.shape[1], device=lens.device)[None, :] < lens[:, None]
    log_fwd = (blank_l, dg_l, lens)
    errs = {}

    def log_pick(f):
        return ll._pick_single_log_loss(f, lab_len)

    lfl_k = log_pick(ll.simplified_log_fwd(*log_fwd, "final"))
    lfl_p = log_pick(ll.simplified_log_fwd_plain(*log_fwd, "final"))
    agree(lfl_k, lfl_p, 1e-5, 0.0, f"simplified_log_fwd[final] loss vs plain{where}")
    errs["simplified_log_fwd[final]"] = max_err(lfl_k, lfl_p)

    lr_k = ll.simplified_log_fwd(*log_fwd, "resid")
    lr_p = ll.simplified_log_fwd_plain(*log_fwd, "resid")
    lrl_k, lrl_p = log_pick(lr_k[1]), log_pick(lr_p[1])
    agree(lrl_k, lrl_p, 1e-5, 0.0, f"simplified_log_fwd[resid] loss vs plain{where}")
    agree(lr_k[0][valid_t], lr_p[0][valid_t], 1e-5, 1e-5,
          f"simplified_log_fwd[resid] residual alpha vs plain{where}")
    errs["simplified_log_fwd[resid]"] = max(max_err(lrl_k, lrl_p),
                                            max_err(lr_k[0][valid_t], lr_p[0][valid_t]))

    safe = torch.where(torch.isfinite(lrl_k), lrl_k, torch.zeros_like(lrl_k))
    log_bwd = (*log_fwd, lab_len, safe, lr_k[0])
    lb_k = ll.simplified_log_bwd(*log_bwd)
    lb_p = ll.simplified_log_bwd_plain(*log_bwd)
    agree(lb_k[0], lb_p[0], 0.0, 1e-5, f"simplified_log_bwd pd vs plain{where}")
    agree(lb_k[1][:, 0], lb_p[1][:, 0], 1e-5, 0.0,
          f"simplified_log_bwd beta0 vs plain{where}")
    errs["simplified_log_bwd"] = max(max_err(lb_k[0], lb_p[0]),
                                     max_err(lb_k[1][:, 0], lb_p[1][:, 0]))
    return errs, log_fwd, log_bwd


def fused_args(ctx):
    """The arguments that the streamed classic scheme (kernels B2 and B3)
    gives ``fused_dlogits`` on ``ctx``, with d_loss in [0.5, 1.5), and the
    acts step's ``(acts, lm, fast loss, scale)``."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override

    with config_override(chunk_time=1 << 20):  # one chunk: the streamed scheme
        _, pack = cl.classic_loss_and_pack(ctx)
    acts_step = cl.classic_streamed_acts(ctx, pack)
    acts, lm, fast_loss, scale = acts_step
    num_t = ctx.logproba.shape[1]
    lens = torch.where(torch.isfinite(fast_loss), ctx.logit_length.clamp(0, num_t),
                       torch.zeros_like(ctx.logit_length)).to(torch.int32)
    d_loss = (0.5 + torch.arange(len(lens), device=lens.device) / len(lens)).float()
    return (acts, cl.lane_tokens(ctx, acts.shape[2]), lm, scale, d_loss, lens,
            ctx.logproba.contiguous(), ctx.blank_index), acts_step


def compare_fused(torch, seed, dev):
    """Hold B12 against its plain version at batch 8, blank 3, V = 32, 128
    and 1000 (atol 1e-6: its float64 token sums round once to float32, as
    the plain version's do, and ``expf`` may differ from ``torch.exp`` by
    an ulp); returns the largest error."""
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    err = 0.0
    for vocab in (32, 128, 1000):
        labels, logits, ll_, gl = make_inputs(torch, seed + vocab, dev, batch=8,
                                              vocab=vocab)
        labels = torch.where(labels == 3, torch.full_like(labels, 4), labels)
        ctx = core.make_context(labels, logit_to_logproba(logits, 2), ll_, gl, 3)
        args = fused_args(ctx)[0]
        out, ref = cl.fused_dlogits(*args), cl.fused_dlogits_plain(*args)
        agree(out, ref, 0.0, 1e-6, f"fused_dlogits vs plain at V={vocab}")
        check(not bool(out[:2].any()),
              f"fused_dlogits zero on infeasible rows, V={vocab}")
        err = max(err, max_err(out, ref))
    return err


def rf_ops(ctx, topology):
    """The residual-free kernels of ``topology`` with their plain versions,
    and a function giving chunk ``c``'s leading kernel arguments (the
    transitions and the chunk's lengths; the lane masks for the classic
    scans)."""
    from types import SimpleNamespace

    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs

    if topology == "classic":
        lpad, k_win, lm, nb, rep, lens, lab_len = cl._lane_inputs(ctx)

        def chunk(c, chunk_t):
            blank, dcu, lens_c = cl._chunk(ctx, c, chunk_t, lpad, lens)
            return blank, dcu, lm, nb, rep, lens_c

        return SimpleNamespace(
            chunk=chunk, k_win=k_win, lab_len=lab_len, states=2,
            fwd=cl.classic_fwd, fwd_plain=cl.classic_fwd_plain,
            bwd=cl.classic_bwd, bwd_plain=cl.classic_bwd_plain,
            loss=lambda f: cl.pick_loss(f[0] + f[1], f[2], lab_len))
    lpad, k_win, _lm, lens, lab_len = cs._lane_inputs(ctx)

    def chunk(c, chunk_t):
        blank, dg, lens_c = cs._chunk(ctx, c, chunk_t, lpad, lens)
        return blank, dg, lens_c

    return SimpleNamespace(
        chunk=chunk, k_win=k_win, lab_len=lab_len, states=1,
        fwd=cs.simplified_fwd, fwd_plain=cs.simplified_fwd_plain,
        bwd=cs.simplified_bwd, bwd_plain=cs.simplified_bwd_plain,
        loss=lambda f: cl.pick_loss(f[0], f[1], lab_len))


def agree_carry(ours, ref, what) -> float:
    """Hold the outputs of a scan (a block-float carry, mantissas then
    exponents, or a backward's acts and beta carry) against its plain
    version's, bit for bit; returns the largest error."""
    import torch

    err = max(max_err(a, b) for a, b in zip(ours, ref))
    check(all(torch.equal(a, b) for a, b in zip(ours, ref)),
          f"{what} bit for bit the plain version's (max abs err {err:.3g})")
    return err


def compare_fwd_modes(ctx) -> dict:
    """Hold every mode of B1 and B6 bit for bit against its plain version on
    the one chunk of ``ctx`` from the standard carry; returns the largest
    error of each (0.0)."""
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl

    n_chunks, chunk_t = cl.chunk_plan(ctx)
    errs = {}
    for topology, modes in FWD_MODES.items():
        ops = rf_ops(ctx, topology)
        args = ops.chunk(0, n_chunks * chunk_t)
        for mode in modes:
            name = f"{topology}_fwd[{mode}]"
            errs[name] = same_fwd(ops, args, ops.k_win, mode, name)
    return errs


def compare_rf_kernels(ctx, topology):
    """Hold the residual-free kernels of ``topology`` (B10 or B11: the
    forward in mode bound and in mode final from a carry, the backward from
    a beta carry) against their plain versions, chunk by chunk along the
    chunk plan of ``ctx``: the forward walks the chunks first to last, the
    backward last to first, each launch on the inputs that the kernels of
    the previous chunk gave.  Returns ``(max abs errors, kernel arguments
    of the last chunk of the backward)``."""
    import torch

    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl

    ops = rf_ops(ctx, topology)
    n_chunks, chunk_t = cl.chunk_plan(ctx)
    k_win, s = ops.k_win, ops.states
    fwd_name, bwd_name = f"{topology}_fwd[bound]", f"{topology}_bwd"
    errs = {fwd_name: 0.0, bwd_name: 0.0, f"{topology}_fwd[final]": 0.0}
    carries, carry = [], None
    for c in range(n_chunks):
        args = ops.chunk(c, chunk_t)
        kw = cl.init_kw(carry)
        fin = ops.fwd(*args, k_win, "final", **kw)
        errs[f"{topology}_fwd[final]"] = max(
            errs[f"{topology}_fwd[final]"],
            agree_carry(fin, ops.fwd_plain(*args, k_win, "final", **kw),
                        f"{topology}_fwd[final] from a carry, chunk {c}"))
        bnd = ops.fwd(*args, k_win, "bound", **kw)
        bnd_p = ops.fwd_plain(*args, k_win, "bound", **kw)
        err = agree_carry(bnd[:s + 1], bnd_p[:s + 1],
                          f"{fwd_name} boundaries, chunk {c}")
        err = max(err, agree_carry(bnd[s + 1:], bnd_p[s + 1:],
                                   f"{fwd_name} final carry, chunk {c}"))
        check(all(torch.equal(a, b) for a, b in zip(bnd[s + 1:], fin)),
              f"{fwd_name} final carry equals mode final's, chunk {c}")
        errs[fwd_name] = max(errs[fwd_name], err)
        carries.append(carry)
        carry = fin
    loss = ops.loss(carry)
    one_chunk = ops.fwd_plain(*ops.chunk(0, n_chunks * chunk_t), k_win, "final")
    agree(loss, ops.loss(one_chunk), 1e-5, 0.0,
          f"{topology} chunked loss vs the one-chunk plain scan")
    ebi = cl.ebi_from_loss(loss)
    beta = None
    for c in range(n_chunks - 1, -1, -1):
        args = ops.chunk(c, chunk_t)
        bounds = ops.fwd(*args, k_win, "bound", **cl.init_kw(carries[c]))[:s + 1]
        b_args = (*args, ops.lab_len, ebi, *bounds, k_win, beta)
        err, b_k = same_bwd(ops, b_args, f"{bwd_name}, chunk {c}")
        errs[bwd_name] = max(errs[bwd_name], err)
        beta = b_k[1:]
        last = dict(fwd=(*args, k_win), bwd=b_args)
    return errs, last


def same_bwd(ops, b_args, what):
    """Run a residual-free backward and its plain version on ``b_args`` and
    require the acts and the beta carry bit for bit; returns the largest
    error (0.0) and the kernel's outputs."""
    import torch

    b_k, b_p = ops.bwd(*b_args), ops.bwd_plain(*b_args)
    check(all(torch.equal(a, b) for a, b in zip(b_k, b_p)),
          f"{what}: acts and beta carry bit for bit the plain version's "
          f"(max abs err {max(max_err(a, b) for a, b in zip(b_k, b_p)):.3g})")
    return max(max_err(a, b) for a, b in zip(b_k, b_p)), b_k


def random_carry(torch, gen, states, batch, lpad, dev):
    """A block-float carry with every lane live: mantissas in [0.5, 1), one
    in ten zero, exponents in [-30, 30)."""
    def mant():
        m = 0.5 + 0.5 * torch.rand((batch, lpad), generator=gen)
        return torch.where(torch.rand((batch, lpad), generator=gen) < 0.1, 0.0, m)

    e = torch.randint(-30, 30, (batch, lpad), generator=gen, dtype=torch.int32)
    return tuple(t.to(dev) for t in (*[mant() for _ in range(states)], e))


def lane_cases(dev, kernels) -> dict:
    """``{topology: [(window, label width)]}``: a label for every
    lanes-per-thread instantiation of the kernel ``kernels[topology]`` (a
    key of ``_build.SMEM_BYTES``; 512 threads, lanes t + j * threads): at
    window 8 up to the widest label it holds, then at window 1, where the
    lanes reach their most.  Each instantiation's widest lane count is
    taken, so the widest label at windows 8 and 1 is among them."""
    from tf_seq2seq_losses_tpu_torch.ops import _build

    cases = {}
    for topology, kernel in kernels.items():
        done, out = 0, []
        for window in (8, 1):
            widest = max(lp for lp in range(32, 16384, 32)
                         if _build.fits((kernel,), lp, window, dev))
            for lpt in range(done + 1, -(-widest // 512) + 1):
                out.append((window, min(512 * lpt, widest) - 1))
            done = max(done, -(-widest // 512))
        cases[topology] = out
    return cases


def compare_rf_lanes(torch, dev, seed, cases, max_t=24, batch=4) -> dict:
    """Hold B10 and B11 against their plain versions bit for bit with every
    lane live, at each ``(window, label width)`` of ``cases[topology]``:
    labels of their full width (``label_length`` the width), the alpha
    boundaries of B1/B6 mode bound from a random carry, and a random beta
    carry entering the span, as a chunk of a long utterance would see them.
    Returns the largest error of each backward (0.0)."""
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    gen = torch.Generator().manual_seed(seed)
    errs = {}
    for topology, widths in cases.items():
        for window, width in widths:
            labels, logits, _, logit_length = make_inputs(
                torch, seed + width, dev, batch=batch, label_width=width, max_t=max_t,
                infeasible=False)
            full = torch.full_like(logit_length, width)
            with config_override(window=window):
                ctx = core.make_context(labels, logit_to_logproba(logits, 2), full,
                                        logit_length, 0)
                ops = rf_ops(ctx, topology)
                n_chunks, chunk_t = cl.chunk_plan(ctx)
                args = ops.chunk(0, n_chunks * chunk_t)
                lpad = args[1].shape[2]
                alpha = random_carry(torch, gen, ops.states, batch, lpad, dev)
                bounds = ops.fwd(*args, window, "bound", init=alpha)[:ops.states + 1]
                beta = random_carry(torch, gen, ops.states, batch, lpad, dev)
                ebi = -torch.randint(0, 60, (batch,), generator=gen).float().to(dev)
                b_args = (*args, ops.lab_len, ebi, *bounds, window, beta)
                err, _ = same_bwd(ops, b_args, f"{topology}_bwd at window {window}, "
                                  f"{lpad} lanes, from random carries")
            errs[f"{topology}_bwd"] = max(errs.get(f"{topology}_bwd", 0.0), err)
    return errs


def compare_streamed_lanes(torch, dev, seed, cases, max_t=24, batch=4) -> dict:
    """Hold B3 (``cases["classic_bwd_streamed"]``), B13
    (``cases["classic_bwd_half"]``) and B7 (``cases["simplified_bwd_streamed"]``)
    bit for bit against their plain versions at each ``(window, label
    width)``: labels of their full width (``label_length`` the width), the
    residuals of B1 mode resid (B3) or resid1 (B13), or of B6 mode resid
    (B7), from a random carry with every lane live, and a random act
    normaliser; B13 also against B3 where B3 holds the lanes, B7 against
    B11 over B6 mode bound's boundaries from the same carry where B11 holds
    them.  Returns the largest error of each (0.0)."""
    from tf_seq2seq_losses_tpu_torch.ops import _build, core
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    gen = torch.Generator().manual_seed(seed)
    errs = {}
    for name, widths in cases.items():
        for window, width in widths:
            labels, logits, _, logit_length = make_inputs(
                torch, seed + width, dev, batch=batch, label_width=width, max_t=max_t,
                infeasible=False)
            full = torch.full_like(logit_length, width)
            with config_override(window=window):
                ctx = core.make_context(labels, logit_to_logproba(logits, 2), full,
                                        logit_length, 0)
                if name == "simplified_bwd_streamed":
                    err = same_simplified_streamed(torch, gen, ctx, window)
                    errs[name] = max(errs.get(name, 0.0), err)
                    continue
                *args, lab_len, _ = cl.kernel_inputs(ctx)
                lpad = args[1].shape[2]
                alpha = random_carry(torch, gen, 2, batch, lpad, dev)
                ebi = -torch.randint(0, 60, (batch,), generator=gen).float().to(dev)
                what = f"{name} at window {window}, {lpad} lanes, from a random carry"
                sa, saf = cl.classic_fwd(*args, window, "resid", init=alpha)[:2]
                b_args = (*args, lab_len, ebi, sa, saf, window)
                if name == "classic_bwd_streamed":
                    err = agree_carry(cl.classic_bwd_streamed(*b_args),
                                      cl.classic_bwd_streamed_plain(*b_args), what)
                else:
                    half = cl.classic_fwd(*args, window, "resid1", init=alpha)[:3]
                    h_args = (*args, lab_len, ebi, *half, window)
                    hb = cl.classic_bwd_half(*h_args)
                    err = agree_carry(hb, cl.classic_bwd_half_plain(*h_args), what)
                    if _build.fits(("classic_bwd",), lpad, window, dev):
                        check(all(torch.equal(a, b) for a, b in
                                  zip(hb, cl.classic_bwd_streamed(*b_args))),
                              f"{what}: B3's pc and beta carry bit for bit")
            errs[name] = max(errs.get(name, 0.0), err)
    return errs


def same_simplified_streamed(torch, gen, ctx, window) -> float:
    """B7 on ``ctx`` over B6 mode resid's residuals from a random carry,
    with a random act normaliser, bit for bit its plain version's, and
    B11's over B6 mode bound's boundaries from the same carry where B11
    holds the lanes; returns the largest error (0.0)."""
    from tf_seq2seq_losses_tpu_torch.ops import _build
    from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs

    blank, dg, _lm, lens, lab_len, _ = cs.simplified_kernel_inputs(ctx)
    batch, _, lpad = dg.shape
    dev = dg.device
    alpha = random_carry(torch, gen, 1, batch, lpad, dev)
    ebi = -torch.randint(0, 60, (batch,), generator=gen).float().to(dev)
    what = f"simplified_bwd_streamed at window {window}, {lpad} lanes, from a random carry"
    sa, saf = cs.simplified_fwd(blank, dg, lens, window, "resid", init=alpha)[:2]
    b_args = (blank, dg, lens, lab_len, ebi, sa, saf, window)
    ours = cs.simplified_bwd_streamed(*b_args)
    err = agree_carry(ours, cs.simplified_bwd_streamed_plain(*b_args), what)
    if _build.fits(("simplified_bwd_rf",), lpad, window, dev):
        bd, bde = cs.simplified_fwd(blank, dg, lens, window, "bound", init=alpha)[:2]
        rf = cs.simplified_bwd(blank, dg, lens, lab_len, ebi, bd, bde, window)
        check(all(torch.equal(a, b) for a, b in zip(ours, rf)),
              f"{what}: B11's pd and beta carry bit for bit")
    return err


def compare_fused_lanes(torch, dev, seed, max_t=24, batch=3) -> dict:
    """Hold B12 against its plain version (atol 1e-6, as ``compare_fused``)
    at V = 32, 128 and 1000 on random acts in [0, 1) over labels of 992 and
    2048 lanes (two act rows staged a warp), 2080 (one) and the widest it
    holds at each V: random tokens, one lane in ten unlisted, blank 3,
    sample 0 with no listed lane and sample 1 with no valid step.  Returns
    ``{V: the widest label's lanes}``."""
    from tf_seq2seq_losses_tpu_torch.ops import _build
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl

    gen = torch.Generator().manual_seed(seed)
    widest = {}
    for vocab in (32, 128, 1000):
        widest[vocab] = max(lp for lp in range(32, 16384, 32)
                            if _build.fits(("fused_epilogue",), lp, vocab, dev))
        for lpad in (992, 2048, 2080, widest[vocab]):
            acts = torch.rand((batch, max_t, lpad), generator=gen)
            labels = torch.randint(0, vocab, (batch, lpad), generator=gen,
                                   dtype=torch.int32)
            lm = (torch.rand((batch, lpad), generator=gen) >= 0.1).float()
            lm[0] = 0.0
            scale = 0.5 + torch.rand((batch,), generator=gen)
            d_loss = 0.5 + torch.rand((batch,), generator=gen)
            lens = torch.randint(max_t // 2, max_t + 1, (batch,), generator=gen,
                                 dtype=torch.int32)
            lens[1] = 0
            logproba = torch.log_softmax(torch.randn((batch, max_t, vocab),
                                                     generator=gen), 2)
            args = tuple(t.to(dev) for t in (acts, labels, lm, scale, d_loss, lens,
                                             logproba)) + (3,)
            out, ref = cl.fused_dlogits(*args), cl.fused_dlogits_plain(*args)
            agree(out, ref, 0.0, 1e-6, f"fused_dlogits vs plain at V={vocab}, "
                  f"{lpad} lanes")
            check(not bool(out[1].any()),
                  f"fused_dlogits zero on a row with no valid step, V={vocab}")
    return widest


FWD_MODES = {"classic": ("final", "resid", "bound", "resid1"),
             "simplified": ("final", "resid", "bound")}


def same_fwd(ops, args, window, mode, what, init=None) -> float:
    """Run a forward scan (B1 or B6) and its plain version in ``mode`` on
    ``args`` from ``init`` and require every output that the kernel writes
    bit for bit the plain version's (mode resid's residuals at the steps and
    windows each sample runs); returns the largest error (0.0)."""
    import torch

    from tf_seq2seq_losses_tpu_torch.tools.time_scans import written

    kw = {} if init is None else {"init": init}
    lens = args[-1]
    ours = written(torch, ops.fwd(*args, window, mode, **kw), mode, lens, window)
    ref = written(torch, ops.fwd_plain(*args, window, mode, **kw), mode, lens, window)
    err = max(max_err(a, b) for a, b in zip(ours, ref))
    check(all(torch.equal(a, b) for a, b in zip(ours, ref)),
          f"{what}: outputs bit for bit the plain version's (max abs err {err:.3g})")
    return err


def compare_fwd_lanes(torch, dev, seed, cases, max_t=40, batch=4) -> dict:
    """Hold B1 in its four modes and B6 in its three bit for bit against
    their plain versions at each ``(window, label width)`` of
    ``cases[topology]``, labels of their full width (``label_length`` the
    width), from the standard carry and from a random carry with every lane
    live.  Returns the largest error of each mode (0.0)."""
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    gen = torch.Generator().manual_seed(seed)
    errs = {}
    for topology, widths in cases.items():
        for window, width in widths:
            labels, logits, _, logit_length = make_inputs(
                torch, seed + width, dev, batch=batch, label_width=width, max_t=max_t,
                infeasible=False)
            full = torch.full_like(logit_length, width)
            with config_override(window=window):
                ctx = core.make_context(labels, logit_to_logproba(logits, 2), full,
                                        logit_length, 0)
                ops = rf_ops(ctx, topology)
                n_chunks, chunk_t = cl.chunk_plan(ctx)
                args = ops.chunk(0, n_chunks * chunk_t)
                lpad = args[1].shape[2]
                carry = random_carry(torch, gen, ops.states, batch, lpad, dev)
                for mode in FWD_MODES[topology]:
                    name = f"{topology}_fwd[{mode}]"
                    for init in (None, carry):
                        err = same_fwd(ops, args, window, mode,
                                       f"{name} at window {window}, {lpad} lanes, from "
                                       f"{'a random' if init else 'the standard'} carry",
                                       init)
                        errs[name] = max(errs.get(name, 0.0), err)
    return errs


def kernel_counters() -> dict:
    """``{path: {kernel name: (wrapper, mode or None)}}``: the launch counts
    that each topology's paths may move (B12 serves both), and under
    ``"pure64"`` the float64 scans of the guard's pure repair, which the
    paths that repair through it read apart, under ``"extras"`` phase
    14's kernels of forced alignment and sampling, and under ``"hvp"`` the
    HVP's tangent scans (phases 8 and 15)."""
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
    from tf_seq2seq_losses_tpu_torch.ops import align, decode, sample
    from tf_seq2seq_losses_tpu_torch.ops import pure_scan as ps

    return {
        "classic": {
            "classic_fwd[final]": (cl.classic_fwd, "final"),
            "classic_fwd[resid]": (cl.classic_fwd, "resid"),
            "classic_bwd_streamed": (cl.classic_bwd_streamed, None),
            "classic_log_fwd[final]": (ll.classic_log_fwd, "final"),
            "classic_log_fwd[resid]": (ll.classic_log_fwd, "resid"),
            "classic_log_bwd": (ll.classic_log_bwd, None),
            "classic_fwd[bound]": (cl.classic_fwd, "bound"),
            "classic_bwd": (cl.classic_bwd, None),
            "classic_fwd[resid1]": (cl.classic_fwd, "resid1"),
            "classic_bwd_half": (cl.classic_bwd_half, None),
            "fused_dlogits": (cl.fused_dlogits, None),
        },
        "simplified": {
            "simplified_fwd[final]": (cs.simplified_fwd, "final"),
            "simplified_fwd[resid]": (cs.simplified_fwd, "resid"),
            "simplified_bwd_streamed": (cs.simplified_bwd_streamed, None),
            "simplified_log_fwd[final]": (ll.simplified_log_fwd, "final"),
            "simplified_log_fwd[resid]": (ll.simplified_log_fwd, "resid"),
            "simplified_log_bwd": (ll.simplified_log_bwd, None),
            "simplified_fwd[bound]": (cs.simplified_fwd, "bound"),
            "simplified_bwd": (cs.simplified_bwd, None),
            "fused_dlogits": (cl.fused_dlogits, None),
        },
        "pure64": {name: (getattr(ps, name), None) for name in PURE64},
        "extras": {
            "classic_viterbi": (align.classic_viterbi_scan, None),
            "simplified_viterbi": (align.simplified_viterbi_scan, None),
            "classic_walk": (sample.classic_walk_scan, None),
            "simplified_walk": (sample.simplified_walk_scan, None),
            "classic_alpha32": (ps.classic_alpha32, None),
            "simplified_alpha32": (ps.simplified_alpha32, None),
            "classic_viterbi_grad": (align.classic_viterbi_grad, None),
            "simplified_viterbi_grad": (align.simplified_viterbi_grad, None),
            "classic_walk_grad": (sample.classic_walk_grad, None),
            "simplified_walk_grad": (sample.simplified_walk_grad, None),
            "classic_beam_search": (decode.classic_beam_search, None),
            "simplified_beam_search": (decode.simplified_beam_search, None),
            "classic_beam_search_grad": (decode.classic_beam_search_grad, None),
            "simplified_beam_search_grad": (decode.simplified_beam_search_grad, None),
        },
        "hvp": {name: (getattr(ps, name), None) for name in HVP_KERNELS},
    }


def reset_launches() -> None:
    for path in kernel_counters().values():
        for fn, _mode in path.values():
            fn.launches = 0
            if hasattr(fn, "mode_launches"):
                fn.mode_launches = {m: 0 for m in fn.mode_launches}


def read_launches(path: str) -> dict:
    return {name: fn.launches if mode is None else fn.mode_launches[mode]
            for name, (fn, mode) in kernel_counters()[path].items()}


def loss_function(topology):
    import tf_seq2seq_losses_tpu_torch as ctc

    return {"classic": ctc.classic_ctc_loss,
            "simplified": ctc.simplified_ctc_loss}[topology]


def make_step(torch, loss_fn, labels):
    """A training step of ``loss_fn`` on ``labels``: the loss forward and
    ``.backward()`` of the sum of its finite values to the logits; returns
    ``(loss, d_logits)``."""

    def train_step(x, ll_, gl_):
        x = x.detach().requires_grad_(True)
        loss = loss_fn(labels, x, ll_, gl_, 0)
        torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum().backward()
        return loss.detach(), x.grad

    return train_step


def launches_since(topology, before) -> dict:
    now = read_launches(topology)
    return {k: n - before[k] for k, n in now.items() if n > before[k]}


def drive_main_path(torch, dev, topology, inputs, ctx, sync):
    """Phases 3 and 4 for one topology: its loss through the public API,
    training step and evaluation call, then the saturated batch through the
    guard; then, as a path of its own, the training step with
    ``stream_residuals=False``.  The launch counts are set to 0 just before
    each path and read just after; returns the launches of both, the step
    functions and the batches for timing."""
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override

    loss_fn = loss_function(topology)
    labels, logits, label_length, logit_length = inputs
    fwd_final, fwd_resid, fwd_bound = (f"{topology}_fwd[{m}]"
                                       for m in ("final", "resid", "bound"))
    bwd, bwd_rf = f"{topology}_bwd_streamed", f"{topology}_bwd"
    log_final, log_resid, log_bwd = (f"{topology}_log_{m}"
                                     for m in ("fwd[final]", "fwd[resid]", "bwd"))
    train_step = make_step(torch, loss_fn, labels)

    # ---- 3. the main path --------------------------------------------------
    reset_launches()
    per_step = {}
    mark = read_launches(topology)
    loss, d_logits = train_step(logits, label_length, logit_length)
    per_step["training step"] = launches_since(topology, mark)
    mark = read_launches(topology)
    with torch.no_grad():
        loss_eval = loss_fn(labels, logits, label_length, logit_length, 0)
    per_step["evaluation call"] = launches_since(topology, mark)
    sync()
    feasible = TOPOLOGIES[topology].feasible(ctx)
    check(bool(torch.isfinite(loss[feasible]).all()), "finite loss on feasible rows")
    check(bool(torch.isposinf(loss[~feasible]).all()) and int((~feasible).sum()) >= 2,
          "+inf loss on infeasible rows")
    check(bool((d_logits[~feasible] == 0).all()), "zero d_logits on infeasible rows")
    check(torch.equal(loss, loss_eval), "forward-only loss equals the training loss")
    with config_override(use_kernels=False):
        loss_pure, d_pure = train_step(logits, label_length, logit_length)
    loss64, d64 = pure_float64(labels, logits, label_length, logit_length, topology)
    agree(loss, loss64, 1e-5, 0.0, f"{topology} loss vs the float64 pure path on the card")
    agree(d_logits, d64, 0.0, 1e-5,
          f"{topology} d_logits vs the float64 pure path on the card")
    launches = read_launches(topology)
    for name in (fwd_resid, fwd_final, bwd):
        check(launches[name] >= 1, f"{name} launched")
    log(f"phase 3 {topology} main path (TF32 on): ok, loss mean "
        f"{float(loss[feasible].mean()):.4f}; max abs err vs the float64 pure path: "
        f"kernel path loss {max_err(loss, loss64):.3g} d_logits "
        f"{max_err(d_logits, d64):.3g}, float32 pure path loss "
        f"{max_err(loss_pure, loss64):.3g} d_logits {max_err(d_pure, d64):.3g}")

    # ---- 4. the saturation guard ------------------------------------------
    s_logits, s_ll, s_gl = saturate(torch, labels, logits, label_length, logit_length)
    mark = read_launches(topology)
    s_loss, s_d = train_step(s_logits, s_ll, s_gl)
    per_step["step with 4 rows repaired"] = launches_since(topology, mark)
    sync()
    for name in (log_final, log_resid, log_bwd):
        check(name in per_step["step with 4 rows repaired"], f"guard launched {name}")
    with config_override(use_kernels=False):
        p_loss, p_d = train_step(s_logits, s_ll, s_gl)
    rows = [2, 3]
    agree(s_loss[rows], p_loss[rows], 0.0, 2e-4,
          f"{topology} repaired loss vs pure (1e2 rows)")
    agree(s_d[rows], p_d[rows], 0.0, 2e-4,
          f"{topology} repaired d_logits vs pure (1e2 rows)")
    big = [4, 5]
    check(bool(torch.isfinite(s_loss[big]).all()), "finite loss at logits 1e10")
    check(bool(torch.isfinite(s_d[big]).all()), "finite d_logits at logits 1e10")
    agree(s_loss[big], p_loss[big], 1e-6, 0.0,
          f"{topology} repaired loss vs pure (1e10 rows)")
    _, s_d64 = pure_float64(labels, s_logits, s_ll, s_gl, topology)
    clean = torch.ones(len(loss), dtype=torch.bool, device=dev)
    clean[2:6] = False
    check(torch.equal(s_loss[clean], loss[clean]), "clean rows' loss bit for bit")
    check(torch.equal(s_d[clean], d_logits[clean]), "clean rows' d_logits bit for bit")
    launches = read_launches(topology)
    for name in (fwd_final, fwd_resid, bwd, log_final, log_resid, log_bwd):
        check(launches[name] >= 1, f"{name} launched on the {topology} main path")
    log(f"phase 4 {topology} guard: ok, repaired rows 2-5, losses "
        f"{[round(float(v), 4) for v in s_loss[2:6]]}, max abs err vs pure "
        f"loss {max_err(s_loss[rows], p_loss[rows]):.3g} "
        f"d_logits {max_err(s_d[rows], p_d[rows]):.3g}; rows 4-5 d_logits not "
        f"compared: float32 pure vs float64 {max_err(p_d[big], s_d64[big]):.3g} there; "
        f"launches per call {json.dumps(per_step)}")

    # ---- 3, residual-free: the training step with stream_residuals=False ---
    reset_launches()
    with config_override(stream_residuals=False):
        rf_loss, rf_d = train_step(logits, label_length, logit_length)
    sync()
    rf_launches = read_launches(topology)
    rf_step = {k: n for k, n in rf_launches.items() if n}
    check(rf_step == {fwd_bound: 1, bwd_rf: 1},
          f"{topology} stream_residuals=False launches {rf_step}")
    check(torch.equal(rf_loss, loss), f"{topology} residual-free loss bit for bit")
    check(torch.equal(rf_d, d_logits), f"{topology} residual-free d_logits bit for bit")
    log(f"phase 3 {topology} residual-free step (stream_residuals=False, one chunk): "
        f"ok, loss and d_logits bit for bit the streamed step's; launches per step "
        f"{json.dumps(rf_step)}")
    return dict(launches={k: n + rf_launches[k] for k, n in launches.items()},
                train_step=train_step, loss_fn=loss_fn,
                saturated=(s_logits, s_ll, s_gl), loss=loss, d_logits=d_logits)


# the JAX repo's ASR north-star vocabulary (bench.py:266-267), which its
# fused epilogue was written for
SLICE_VOCAB = 128
# a label array of 2016 lanes: wider than B3 (1792), B13 (1856) and B5
# (1568) hold
WIDE_LABELS = 2000


def configured(fn, **cfg):
    """``fn`` run under ``config_override(**cfg)``."""
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override

    def run(*args):
        with config_override(**cfg):
            return fn(*args)

    return run


def drive_slice_paths(torch, dev, seed, inputs, classic_main, sync):
    """The half-stream scheme and the fused epilogue, each path of its own
    (launch counts set to 0 just before it, read just after), with TF32 on:

    * the classic half-stream step at the headline: one launch each of the
      forward in mode resid1 and B13, no B3; loss and d_logits bit for bit
      the streamed step's;
    * at V=128, each topology's fused step and a step on a batch saturated
      as in phase 4 (``fused_epilogue``): one B12 launch a step; loss bit
      for bit and d_logits atol 1e-6 against the unfused step, loss rtol
      1e-5 and d_logits atol 1e-5 against float64; repaired rows against
      the pure path, clean rows bit for bit;
    * the classic half-stream step with the fused epilogue at V=128: bit for
      bit the fused step;
    * a classic step on labels [8, 2000] (2016 lanes), then the same batch
      with row 2 saturated: the residual-free scheme (B1 bound, B10), the
      repair through the pure path (B5 does not hold the lanes); float64
      on the clean rows, the pure path on the repaired one;
    * for each topology, a training step and an evaluation call on label
      arrays wider than the kernels hold at window 8 (the widest label of
      the residual-free pair, then of the forward, plus one lane): the
      training step is the pure path's bit for bit, with no launch; the
      evaluation call launches the forward's mode final once where it
      holds the lanes (loss rtol 1e-5 against float64), and is the pure
      path's otherwise.

    Returns the launches summed by kernel and the steps for timing."""
    from collections import Counter

    from tf_seq2seq_losses_tpu_torch.utils.config import config_override

    totals = Counter()

    def path(topology, fn):
        reset_launches()
        out = fn()
        sync()
        got = {k: n for k, n in read_launches(topology).items() if n}
        totals.update(got)
        return out, got

    labels, logits, label_length, logit_length = inputs
    step = classic_main["train_step"]
    half_step = configured(step, half_stream=True)
    (h_loss, h_d), got = path("classic", lambda: half_step(logits, label_length,
                                                          logit_length))
    check(got == {"classic_fwd[resid1]": 1, "classic_bwd_half": 1},
          f"half-stream step launches {got}")
    check(torch.equal(h_loss, classic_main["loss"])
          and torch.equal(h_d, classic_main["d_logits"]),
          "half-stream step's loss and d_logits bit for bit the streamed step's")
    log(f"phase 3 classic half-stream step (half_stream=True): ok, loss and d_logits "
        f"bit for bit the streamed step's; launches per step {json.dumps(got)}")

    v_inputs = make_inputs(torch, seed, dev, vocab=SLICE_VOCAB)
    v_labels, v_logits, v_ll, v_gl = v_inputs
    s_logits, s_ll, s_gl = saturate(torch, *v_inputs)
    steps = {"classic_fwd_bwd_step_half_stream": (half_step, inputs[1:])}
    fused = {}
    for topology in ("classic", "simplified"):
        v_step = make_step(torch, loss_function(topology), v_labels)
        fused_step = configured(v_step, fused_epilogue=True)
        ((f_loss, f_d), (fs_loss, fs_d)), got = path(topology, lambda: (
            fused_step(v_logits, v_ll, v_gl), fused_step(s_logits, s_ll, s_gl)))
        expect = {f"{topology}_fwd[resid]": 2, f"{topology}_bwd_streamed": 2,
                  "fused_dlogits": 2, f"{topology}_log_fwd[final]": 1,
                  f"{topology}_log_fwd[resid]": 1, f"{topology}_log_bwd": 1}
        check(got == expect, f"{topology} fused V={SLICE_VOCAB} launches {got}")
        u_loss, u_d = v_step(v_logits, v_ll, v_gl)
        check(torch.equal(f_loss, u_loss), f"{topology} fused step's loss is unfused's")
        agree(f_d, u_d, 0.0, 1e-6, f"{topology} fused d_logits vs the unfused step")
        loss64, d64 = pure_float64(*v_inputs, topology)
        agree(f_loss, loss64, 1e-5, 0.0, f"{topology} fused step loss vs float64 pure")
        agree(f_d, d64, 0.0, 1e-5, f"{topology} fused d_logits vs float64 pure")
        with config_override(use_kernels=False):
            p_loss, p_d = v_step(s_logits, s_ll, s_gl)
        rows, big = [2, 3], [4, 5]
        agree(fs_loss[rows], p_loss[rows], 0.0, 2e-4, f"{topology} fused repaired loss")
        agree(fs_d[rows], p_d[rows], 0.0, 2e-4, f"{topology} fused repaired d_logits")
        check(bool(torch.isfinite(fs_loss[big]).all())
              and bool(torch.isfinite(fs_d[big]).all()),
              f"{topology} fused step finite at logits 1e10")
        clean = torch.ones(len(f_loss), dtype=torch.bool, device=dev)
        clean[2:6] = False
        check(torch.equal(fs_loss[clean], f_loss[clean])
              and torch.equal(fs_d[clean], f_d[clean]),
              f"{topology} fused step: clean rows bit for bit")
        log(f"phase 3 {topology} fused epilogue at V={SLICE_VOCAB} "
            f"(fused_epilogue=True): ok; max abs err d_logits vs the unfused step "
            f"{max_err(f_d, u_d):.3g}, vs "
            f"float64 pure: loss {max_err(f_loss, loss64):.3g} d_logits "
            f"{max_err(f_d, d64):.3g}; rows 2-5 repaired (vs pure: d_logits "
            f"{max_err(fs_d[rows], p_d[rows]):.3g}), clean rows bit for bit; "
            f"launches for the step and the saturated step {json.dumps(got)}")
        fused[topology] = (f_loss, f_d)
        steps[f"{topology}_fwd_bwd_step_v{SLICE_VOCAB}"] = (v_step, v_inputs[1:])
        steps[f"{topology}_fwd_bwd_step_v{SLICE_VOCAB}_fused"] = (fused_step,
                                                                  v_inputs[1:])

    hf_step = configured(make_step(torch, loss_function("classic"), v_labels),
                         half_stream=True, fused_epilogue=True)
    (hf_loss, hf_d), got = path("classic", lambda: hf_step(v_logits, v_ll, v_gl))
    check(got == {"classic_fwd[resid1]": 1, "classic_bwd_half": 1, "fused_dlogits": 1},
          f"half-stream fused step launches {got}")
    check(torch.equal(hf_loss, fused["classic"][0])
          and torch.equal(hf_d, fused["classic"][1]),
          "half-stream fused step bit for bit the fused step")
    log(f"phase 3 classic half-stream step with the fused epilogue at V={SLICE_VOCAB}: "
        f"ok, bit for bit the fused step; launches per step {json.dumps(got)}")
    steps[f"classic_fwd_bwd_step_v{SLICE_VOCAB}_half_stream_fused"] = (hf_step,
                                                                       v_inputs[1:])

    w_inputs = make_inputs(torch, seed + 4, dev, batch=8, label_width=WIDE_LABELS)
    w_labels, w_logits, w_ll, w_gl = w_inputs
    w_step = make_step(torch, loss_function("classic"), w_labels)
    ws_logits, ws_ll, ws_gl = saturate(torch, *w_inputs, rows=((2, 1e2),))
    ((w_loss, w_d), (ws_loss, ws_d)), got = path("classic", lambda: (
        w_step(w_logits, w_ll, w_gl), w_step(ws_logits, ws_ll, ws_gl)))
    # row 2's repair: its loss (alpha) and its gradient (alpha and beta)
    # through the float64 scans, which the log-space kernels' lanes do not
    # reach
    got_pure = {k: n for k, n in read_launches("pure64").items() if n}
    totals.update(got_pure)
    check(got == {"classic_fwd[bound]": 2, "classic_bwd": 2},
          f"labels [8, {WIDE_LABELS}] launches {got}")
    check(got_pure == {"classic_alpha64": 2, "classic_beta64": 1},
          f"labels [8, {WIDE_LABELS}] float64 scan launches {got_pure}")
    loss64, d64 = pure_float64(*w_inputs)
    agree(w_loss, loss64, 1e-5, 0.0, f"labels [8, {WIDE_LABELS}] loss vs float64 pure")
    agree(w_d, d64, 0.0, 1e-5, f"labels [8, {WIDE_LABELS}] d_logits vs float64 pure")
    with config_override(use_kernels=False):
        p_loss, p_d = w_step(ws_logits, ws_ll, ws_gl)
    agree(ws_loss[2:3], p_loss[2:3], 0.0, 2e-4, "wide labels: repaired loss vs pure")
    agree(ws_d[2:3], p_d[2:3], 0.0, 2e-4, "wide labels: repaired d_logits vs pure")
    clean = torch.ones(len(w_loss), dtype=torch.bool, device=dev)
    clean[2] = False
    check(torch.equal(ws_loss[clean], w_loss[clean]) and torch.equal(ws_d[clean],
                                                                      w_d[clean]),
          "wide labels: clean rows bit for bit")
    lanes = w_labels.shape[1] + 1
    log(f"phase 3 classic labels [8, {WIDE_LABELS}] ({lanes} lanes padded to "
        f"{-(-lanes // 32) * 32}), one chunk: ok through the residual-free scheme; "
        f"vs float64 pure: loss {max_err(w_loss, loss64):.3g} "
        f"d_logits {max_err(w_d, d64):.3g}; row 2 repaired through the pure path "
        f"in float64 (d_logits {max_err(ws_d[2:3], p_d[2:3]):.3g} from the float32 "
        f"one), clean rows bit for bit; launches for the step and the saturated step "
        f"{json.dumps({**got, **got_pure})}")
    steps[f"classic_fwd_bwd_step_labels_{WIDE_LABELS}"] = (w_step, w_inputs[1:])

    # label arrays wider than the kernels hold: past the residual-free pair,
    # within the forward; past the forward too
    for topology in ("classic", "simplified"):
        held = widest_lanes(dev)
        fwd = f"{topology}_fwd"
        for width in (held[f"{topology}_bwd_rf"], held[fwd]):
            x_inputs = make_inputs(torch, seed + 5, dev, batch=4, label_width=width,
                                   max_t=100)
            x_labels, x_logits, x_ll, x_gl = x_inputs
            x_fn = loss_function(topology)
            x_step = make_step(torch, x_fn, x_labels)
            ((x_loss, x_d), x_eval), got = path(topology, lambda: (
                x_step(x_logits, x_ll, x_gl), x_fn(x_labels, x_logits, x_ll, x_gl, 0)))
            in_fwd = width < held[fwd]  # width + 1 labels: width + 32 lanes
            check(got == ({f"{fwd}[final]": 1} if in_fwd else {}),
                  f"{topology} labels [4, {width}] launches {got}")
            with config_override(use_kernels=False):
                p_loss, p_d = x_step(x_logits, x_ll, x_gl)
            check(torch.equal(x_loss, p_loss) and torch.equal(x_d, p_d),
                  f"{topology} labels [4, {width}]: the training step is the pure path's")
            if in_fwd:
                x64 = pure_float64(*x_inputs, topology)[0]
                agree(x_eval, x64, 1e-5, 0.0,
                      f"{topology} labels [4, {width}] evaluation loss vs float64 pure")
            else:
                check(torch.equal(x_eval, p_loss),
                      f"{topology} labels [4, {width}]: the evaluation call is the pure "
                      "path's")
            log(f"phase 3 {topology} labels [4, {width}] ({width + 32} lanes; at "
                f"window 8 the residual-free pair holds "
                f"{held[f'{topology}_bwd_rf']}, the forward {held[fwd]}): the training "
                f"step took the pure path, the evaluation call "
                f"{fwd + '[final]' if in_fwd else 'the pure path'}; launches "
                f"{json.dumps(got)}")
    return dict(launches=totals, steps=steps, v_inputs=v_inputs)


LONG_T = 4000
# rows held against float64: 0-6 and row 220 of seed 0's batch (infeasible
# in the classic topology; flagged by the scan gap in the simplified one)
LONG_ROWS = [0, 1, 2, 3, 4, 5, 6, 220]
# the rows of seed 0's long-T batch whose scans disagree (the guard repairs
# them through the pure path in float64)
LONG_FLAGGED = {"classic": [], "simplified": [220]}
PEAK_SCALE = 12.0  # peaked logits: losses of a nat or less


def peaked(torch, topology, labels, label_length, logit_length, logits,
           scale=PEAK_SCALE):
    """``logits`` plus ``scale`` on one alignment of each row: the row's
    label sequence (in the classic topology with a blank (0) between two
    equal labels) spread over its frames, each element at the first frame
    of its share and blank on the rest.  Low-loss rows, as a trained model
    gives them."""
    lab = labels.long()
    u = label_length.long()[:, None]
    k = torch.arange(lab.shape[1], device=lab.device)[None]
    repeat = torch.zeros_like(lab, dtype=torch.bool)
    if topology == "classic":
        repeat[:, 1:] = (lab[:, 1:] == lab[:, :-1]) & (k[:, 1:] < u)
    seq = torch.zeros((len(lab), 2 * lab.shape[1]), dtype=torch.long, device=lab.device)
    seq.scatter_(1, k + torch.cumsum(repeat.long(), 1), lab)
    m = u + repeat.long().sum(1, keepdim=True)  # elements of the sequence
    t = torch.arange(logits.shape[1], device=logits.device)[None]
    n = logit_length.long()[:, None]
    seg = torch.minimum(t * m // n.clamp(min=1), (m - 1).clamp(min=0))
    first = torch.ones_like(seg, dtype=torch.bool)
    first[:, 1:] = seg[:, 1:] != seg[:, :-1]
    tok = torch.where(first, seq.gather(1, seg), 0)
    hot = torch.nn.functional.one_hot(tok, logits.shape[2]).to(logits.dtype) * scale
    return logits + torch.where((t < n)[:, :, None], hot, torch.zeros_like(hot))


def scan_gaps(torch, topology, labels, logits, label_length, logit_length) -> dict:
    """The kernel path below the guard, on the whole batch: the feasible
    rows whose fast loss is +inf (the rows the guard repairs), and on the
    other feasible rows the largest gap between the forward and the beta
    scan's losses as a share of ``cuda_lattice.scan_gap_limit``, with their
    median loss."""
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    ctx = core.make_context(labels, logit_to_logproba(logits, 2), label_length,
                            logit_length, 0)
    forward, backward = {
        "classic": (cl.classic_loss_and_pack, cl.classic_gradient_with_loss),
        "simplified": (cs.simplified_loss_and_pack, cs.simplified_gradient_with_loss),
    }[topology]
    loss, pack = forward(ctx)
    fast = cl.flush_signal(loss, backward(ctx, loss, pack)[1], ctx.logit_length)
    feasible = TOPOLOGIES[topology].feasible(ctx)
    flagged = torch.isposinf(fast) & feasible
    clean = feasible & ~flagged
    share = torch.abs(fast - loss)[clean] / cl.scan_gap_limit(
        fast[clean], ctx.logit_length[clean])
    return dict(flagged=torch.nonzero(flagged)[:, 0].tolist(),
                max_share=float(share.max()) if bool(clean.any()) else 0.0,
                median_loss=float(loss[clean].median()) if bool(clean.any()) else None)


def drive_long_t(torch, dev, topology, inputs, sync, seed):
    """The long-T phase of one topology, a path of its own (launch counts
    set to 0 just before, read just after): a training step and an
    evaluation call at B=256, T=4000 (8 chunks), then a batch with row 2
    saturated at 1e2 (12 steps), which the guard repairs on its own time
    axis, through the log-space kernels where they hold the label's 2016
    lanes (B8 and B9 do, B5 does not: the pure path in float64).  Checks: the launches of each
    call, the step's peak device memory, +inf and zero d_logits on
    infeasible rows; then, outside the path, the rows the scan gap flags
    (``LONG_FLAGGED`` at seed 0, repaired through the pure path in
    float64; none on peaked low-loss logits at T=500 and 4000), loss
    (rtol 1e-5) and d_logits (atol 1e-5) of rows ``LONG_ROWS``, repaired
    ones included, against the pure path in float64, and the first 32
    rows run again as one chunk, which must give the same bits.  Returns
    the launches, the peak memory and the step for timing."""
    from collections import Counter

    from tf_seq2seq_losses_tpu_torch.ops import _build, core
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    loss_fn = loss_function(topology)
    labels, logits, label_length, logit_length = inputs
    fwd_final, fwd_bound, bwd_rf = (f"{topology}_fwd[final]", f"{topology}_fwd[bound]",
                                    f"{topology}_bwd")
    train_step = make_step(torch, loss_fn, labels)
    ctx = core.make_context(labels, logit_to_logproba(logits, 2), label_length,
                            logit_length, 0)
    n_chunks, chunk_t = cl.chunk_plan(ctx)
    # row 2 runs 12 steps: the log-space kernels repair it where they hold
    # the label's lanes (B8/B9 do, B5 does not), else the pure path
    log_repair = _build.fits(ll._LOG_KERNELS[topology], cl.geometry(ctx)[1], 0, dev)
    log_kernels = ({f"{topology}_log_{m}": 1 for m in ("fwd[final]", "fwd[resid]", "bwd")}
                   if log_repair else {})
    t0 = time.perf_counter()
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    per_step, per_pure = {}, {}
    mark, p_mark = read_launches(topology), read_launches("pure64")
    loss, d_logits = train_step(logits, label_length, logit_length)
    sync()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    per_step["training step"] = launches_since(topology, mark)
    per_pure["training step"] = launches_since("pure64", p_mark)
    mark, p_mark = read_launches(topology), read_launches("pure64")
    with torch.no_grad():
        loss_eval = loss_fn(labels, logits, label_length, logit_length, 0)
    per_step["evaluation call"] = launches_since(topology, mark)
    per_pure["evaluation call"] = launches_since("pure64", p_mark)
    sync()
    check(per_step["training step"] == {fwd_final: n_chunks, fwd_bound: n_chunks,
                                        bwd_rf: n_chunks},
          f"{topology} long-T training step launches {per_step['training step']}")
    check(per_step["evaluation call"] == {fwd_final: n_chunks},
          f"{topology} long-T evaluation launches {per_step['evaluation call']}")
    feasible = TOPOLOGIES[topology].feasible(ctx)
    check(bool(torch.isfinite(loss[feasible]).all()),
          "finite long-T loss on feasible rows")
    check(bool(torch.isposinf(loss[~feasible]).all()),
          "+inf long-T loss on infeasible rows")
    check(bool((d_logits[~feasible] == 0).all()),
          "zero long-T d_logits on infeasible rows")
    check(torch.equal(loss, loss_eval),
          "long-T forward-only loss equals the training loss")

    s_logits, s_ll, s_gl = saturate(torch, labels, logits, label_length, logit_length,
                                    rows=((2, 1e2),))
    mark, p_mark = read_launches(topology), read_launches("pure64")
    s_loss, s_d = train_step(s_logits, s_ll, s_gl)
    per_step["step with 1 row repaired"] = launches_since(topology, mark)
    per_pure["step with 1 row repaired"] = launches_since("pure64", p_mark)
    sync()
    # the end of the path: what follows checks it, and its launches do not count
    launches = {**read_launches(topology), **read_launches("pure64")}
    check(per_step["step with 1 row repaired"] == {**per_step["training step"],
                                                   **log_kernels},
          f"{topology} long-T step with row 2 repaired launches "
          f"{per_step['step with 1 row repaired']}")
    for name in (fwd_final, fwd_bound, bwd_rf, *log_kernels):
        check(launches[name] >= 1, f"{name} launched on the {topology} long-T path")
    if topology == "classic":
        check(peak < 16e9,
              f"long-T classic step peak memory {peak / 1e9:.2f} GB < 16 GB")
    check(bool(torch.isfinite(s_loss[2])), f"{topology} long-T repaired row finite")
    clean = torch.ones(len(loss), dtype=torch.bool, device=dev)
    clean[2] = False
    check(torch.equal(s_loss[clean], loss[clean]),
          "long-T clean rows' loss bit for bit")
    check(torch.equal(s_d[clean], d_logits[clean]),
          "long-T clean rows' d_logits bit for bit")

    # the rows whose forward and beta scans disagree, on the whole batch;
    # none on peaked low-loss logits, at T=500 and at T=4000
    gaps = {"random": scan_gaps(torch, topology, *inputs)}
    gaps["peaked"] = scan_gaps(torch, topology, labels,
                               peaked(torch, topology, labels, label_length, logit_length,
                                      logits),
                               label_length, logit_length)
    h_labels, h_logits, h_label_length, h_logit_length = make_inputs(torch, seed, dev)
    h_logits = peaked(torch, topology, h_labels, h_label_length, h_logit_length, h_logits)
    gaps["peaked, T=500"] = scan_gaps(torch, topology, h_labels, h_logits,
                                      h_label_length, h_logit_length)
    del h_labels, h_logits, h_label_length, h_logit_length
    if seed == 0:
        check(gaps["random"]["flagged"] == LONG_FLAGGED[topology],
              f"{topology} long-T rows flagged {gaps['random']['flagged']}, expected "
              f"{LONG_FLAGGED[topology]}")
    # the float64 scans: a flagged row's repair in the backward (alpha and
    # beta a round), and row 2's where the log-space kernels do not hold
    # the lanes (its loss, then its gradient)
    alpha64, beta64 = f"{topology}_alpha64", f"{topology}_beta64"
    flag_pure = per_pure["training step"]
    check(bool(flag_pure) == bool(gaps["random"]["flagged"])
          and set(flag_pure) <= {alpha64, beta64}
          and flag_pure.get(alpha64) == flag_pure.get(beta64),
          f"{topology} long-T training step float64 scan launches {flag_pure} with rows "
          f"{gaps['random']['flagged']} flagged")
    want_sat = Counter(flag_pure)
    if not log_repair:
        want_sat.update({alpha64: 2, beta64: 1})
    check(not per_pure["evaluation call"]
          and per_pure["step with 1 row repaired"] == dict(want_sat),
          f"{topology} long-T float64 scan launches {json.dumps(per_pure)}")
    for name in want_sat:
        check(launches[name] >= 1, f"{name} launched on the {topology} long-T path")
    per_step = {k: {**v, **per_pure[k]} for k, v in per_step.items()}
    for kind in ("peaked", "peaked, T=500"):
        check(not gaps[kind]["flagged"],
              f"{topology} {kind} logits: rows {gaps[kind]['flagged']} flagged")

    rows = torch.tensor(LONG_ROWS, device=dev)
    sub = [t[rows] for t in inputs]
    loss64, d64 = pure_float64(*sub, topology)
    # one float32 pure pass (a Python loop over T) for the rows LONG_ROWS
    # and the saturated row 2: the float32 pure path's own error, printed,
    # and the reference of row 2's log-space repair
    both = [torch.cat([a, b[2:3]]) for a, b in zip(sub, (labels, s_logits, s_ll, s_gl))]
    with config_override(use_kernels=False):
        loss32, d32 = make_step(torch, loss_fn, both[0])(*both[1:])
    p_loss, p_d = loss32[-1:], d32[-1:]
    loss32, d32 = loss32[:-1], d32[:-1]
    agree(s_loss[2:3], p_loss, 0.0, 2e-4, f"{topology} long-T repaired loss vs pure")
    agree(s_d[2:3], p_d, 0.0, 2e-4, f"{topology} long-T repaired d_logits vs pure")
    # the flagged rows went through the pure path in float64: held to
    # float64 as the kernel rows are
    fixed_rows = [r for r in LONG_ROWS if r in gaps["random"]["flagged"]]
    agree(loss[rows], loss64, 1e-5, 0.0, f"{topology} long-T loss vs float64 pure")
    agree(d_logits[rows], d64, 0.0, 1e-5, f"{topology} long-T d_logits vs float64 pure")
    # the forward-only loss of each row against float64, relative: a row
    # whose scans disagree keeps its forward scan's loss there (it has no
    # beta scan to disagree with)
    rel = (torch.abs(loss_eval[rows].double() - loss64) / torch.abs(loss64)).tolist()
    eval_rel = {r: e for r, e in zip(LONG_ROWS, rel) if math.isfinite(e)}

    first = [t[:32] for t in inputs]
    step32 = make_step(torch, loss_fn, first[0])
    chunked = step32(*first[1:])
    with config_override(chunk_time=4096, stream_residuals=False):
        one = step32(*first[1:])
    check(all(torch.equal(a, b) for a, b in zip(chunked, one)),
          f"{topology} long-T rows 0-31: chunked equals one chunk bit for bit")
    log(f"phase 7 {topology} long T (B={len(loss)}, T={logits.shape[1]}, labels "
        f"{list(labels.shape)}, {n_chunks} chunks of {chunk_t}): ok in "
        f"{time.perf_counter() - t0:.1f} s; infeasible rows {int((~feasible).sum())}; "
        f"scan gap on the whole batch (flagged rows; on the others the largest gap "
        f"as a share of its limit, and the median loss): {json.dumps(gaps)}; "
        f"rows {LONG_ROWS} vs the float64 pure path: kernel path loss "
        f"{max_err(loss[rows], loss64):.3g} d_logits "
        f"{max_err(d_logits[rows], d64):.3g} (rows {fixed_rows} repaired through "
        f"the pure path in float64), float32 pure path loss "
        f"{max_err(loss32, loss64):.3g} d_logits {max_err(d32, d64):.3g}; "
        f"forward-only loss vs float64, relative, by row: {json.dumps(eval_rel)}; "
        f"rows 0-31 chunked equal one chunk bit for bit; row 2 (12 steps) "
        f"repaired through {'the log-space kernels' if log_repair else 'the pure path'}"
        f" (loss {float(s_loss[2]):.4f}, max abs "
        f"err vs the float32 pure path loss {max_err(s_loss[2:3], p_loss):.3g} "
        f"d_logits {max_err(s_d[2:3], p_d):.3g}), "
        f"clean rows bit for bit; peak memory of the training step "
        f"{peak / 1e9:.3f} GB; launches per call {json.dumps(per_step)}")
    return dict(launches=launches, peak=peak, train_step=train_step, loss_fn=loss_fn,
                loss=loss)


# phase 8: the rest of the public API at the headline shape
EXTRA_CPU_ROWS = 16  # rows whose card outputs are held against the CPU run
HVP_ROWS = 8
HVP_PEAK_BYTES = 2e9  # the full Hessian of these rows would take 8.2 GB
NUM_SAMPLES = 32
BEAM_WIDTH = 8
# the chance that the sampling check fails a correct sampler, over all
# entries (Bonferroni); the posteriors are held to POSTERIOR_ATOL
FAMILY_ALPHA = 1e-3
POSTERIOR_ATOL = 1e-5
# the sum over entries of (k/S - p)^2 against its expectation, the sum of
# p(1 - p)/S: 1 for a correct sampler, whose sum over the headline's
# millions of entries strays from it by a few hundredths at most
SQ_RATIO_TOL = 0.1


def collapses_to_label(torch, align, labels, label_length, blank, merge_repeats):
    """[B, S] bool: each alignment of ``align`` [B, S, T] collapses to its
    row's label (repeats merged when ``merge_repeats``, blanks dropped)."""
    prev = torch.cat([torch.full_like(align[..., :1], -1), align[..., :-1]], dim=2)
    keep = align != blank
    if merge_repeats:
        keep &= align != prev
    pos = torch.cumsum(keep.long(), dim=2) - 1
    lab = labels.long()[:, None, :].expand(-1, align.shape[1], -1)
    want = torch.gather(lab, 2, pos.clamp(0, lab.shape[2] - 1))
    right = torch.where(keep, align.long() == want, torch.ones_like(keep))
    return right.all(dim=2) & (keep.sum(dim=2) == label_length.long()[:, None])


def binomial_pvalues(torch, counts, p, num, delta, chunk=1 << 18):
    """Two-sided tail probability of each count ``counts`` [N] of ``num``
    draws under Binomial(num, q), ``q`` the posterior ``p`` [N] moved by
    ``delta`` (its tolerance) toward the count: ``min(P(K <= k | p - delta),
    P(K >= k | p + delta))``, in float64."""
    j = torch.arange(num + 1, dtype=torch.float64, device=p.device)
    logc = (torch.lgamma(torch.full_like(j, num + 1.0)) - torch.lgamma(j + 1)
            - torch.lgamma(num - j + 1))

    def pmf(q):  # [n, num + 1]
        q = q.double().clamp(0.0, 1.0)[:, None]
        return torch.exp(logc + torch.xlogy(j, q) + torch.xlogy(num - j, 1.0 - q))

    out = []
    for c, q in zip(torch.split(counts.long(), chunk), torch.split(p, chunk)):
        k = c[:, None]
        lower = torch.cumsum(pmf(q - delta), dim=1).gather(1, k)[:, 0]
        upper = torch.flip(torch.cumsum(torch.flip(pmf(q + delta), [1]), dim=1), [1])
        out.append(torch.minimum(lower, upper.gather(1, k)[:, 0]))
    return torch.cat(out)


def drive_extras(torch, dev, seed, sync, card) -> dict:
    """Phase 8, for each topology at the headline shape: the posteriors
    through the public call, a path of its own (launch counts set to 0
    just before each call, read just after: B2 and B3, or B6 resid and B7,
    once each; on a batch with rows 2-5 flushed also B4 resid and B5, or
    B8 resid and B9); forced alignment, greedy and beam-search decoding on
    the whole batch, their first ``EXTRA_CPU_ROWS`` rows against the same
    functions on the CPU; ``NUM_SAMPLES`` alignment samples per row from a
    CUDA generator; the HVP of the first ``HVP_ROWS`` rows.  Then each
    function's time, and a profile of the classic forced alignment.
    Returns the launches and the times."""
    from collections import Counter

    import tf_seq2seq_losses_tpu_torch as ctc
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    t_phase = time.perf_counter()
    labels, logits, label_length, logit_length = make_inputs(torch, seed, dev)
    lp = logit_to_logproba(logits, 2)
    args = (labels, lp, label_length, logit_length)
    s_logits, s_ll, s_gl = saturate(torch, labels, logits, label_length, logit_length)
    s_args = (labels, logit_to_logproba(s_logits, 2), s_ll, s_gl)
    cpu_args = [a[:EXTRA_CPU_ROWS].cpu() for a in args]
    valid = torch.arange(lp.shape[1], device=dev)[None, :] < logit_length[:, None]
    gen = torch.Generator(device=dev).manual_seed(seed)
    clean = torch.ones(len(labels), dtype=torch.bool, device=dev)
    clean[2:6] = False
    launches, times = Counter(), {}

    def launched(topology, call):
        reset_launches()
        out = call()
        sync()
        got = {k: n for k, n in read_launches(topology).items() if n}
        launches.update(got)
        return out, got

    for topology in ("classic", "simplified"):
        topo = TOPOLOGIES[topology]
        feasible = topo.feasible(core.make_context(*args, 0))
        ok = valid & feasible[:, None]  # frames of feasible rows below logit_length

        # ---- posteriors: the gradient's kernel path ----
        post, got = launched(topology, lambda: ctc.ctc_token_posteriors(*args, 0, topology))
        want = {f"{topology}_fwd[resid]": 1, f"{topology}_bwd_streamed": 1}
        check(got == want, f"{topology} posteriors launched {got}, expected {want}")
        agree(post.sum(2)[ok], torch.ones_like(post[..., 0][ok]), 0.0, 1e-5,
              f"{topology} posteriors: valid frames sum to 1")
        check(bool((post[~ok] == 0).all()),
              f"{topology} posteriors: zero past logit_length and on infeasible rows")
        _, _, grad64 = pure_float64_grad(labels, lp.double(), label_length, logit_length,
                                         topology)
        post_err = max_err(post, -grad64)
        agree(post, -grad64, 0.0, POSTERIOR_ATOL,
              f"{topology} posteriors vs the float64 pure path")
        s_post, s_got = launched(topology,
                                 lambda: ctc.ctc_token_posteriors(*s_args, 0, topology))
        want = dict(want, **{f"{topology}_log_fwd[resid]": 1, f"{topology}_log_bwd": 1})
        check(s_got == want, f"{topology} posteriors, rows 2-5 flushed, launched {s_got}, "
              f"expected {want}")
        check(torch.equal(s_post[clean], post[clean]),
              f"{topology} posteriors: clean rows of the flushed batch bit for bit")
        _, _, s_grad64 = pure_float64_grad(*(a[2:4] for a in (
            labels, s_args[1].double(), s_ll, s_gl)), topology)
        agree(s_post[2:4], -s_grad64, 0.0, 2e-4,
              f"{topology} repaired posteriors vs the float64 pure path (1e2 rows)")
        check(bool(torch.isfinite(s_post[4:6]).all()),
              f"{topology} repaired posteriors finite (1e10 rows)")

        # ---- forced alignment, greedy and beam search: card against CPU ----
        align, path_lp = ctc.ctc_forced_alignment(*args, 0, topology)
        c_align, c_path_lp = ctc.ctc_forced_alignment(*cpu_args, 0, topology)
        check(torch.equal(align[:EXTRA_CPU_ROWS].cpu(), c_align),
              f"{topology} forced alignment: card equals CPU")
        agree(path_lp[:EXTRA_CPU_ROWS].cpu(), c_path_lp, 1e-5, 0.0,
              f"{topology} forced alignment path log-probs: card vs CPU")
        check(bool(collapses_to_label(torch, align[:, None], labels, label_length, 0,
                                      topology == "classic")[feasible].all()),
              f"{topology} forced alignments collapse to their labels")
        check(bool(torch.isfinite(path_lp[feasible]).all())
              and bool(torch.isneginf(path_lp[~feasible]).all()),
              f"{topology} forced alignment: finite exactly on feasible rows")
        for name, call in (
                ("greedy", lambda a: ctc.ctc_greedy_decode(a[1], a[3], 0, topology)),
                ("beam", lambda a: ctc.ctc_beam_search_decode(a[1], a[3], 0, BEAM_WIDTH,
                                                              topology))):
            toks, lens, scores = call(args)
            c_toks, c_lens, c_scores = call(cpu_args)
            check(torch.equal(toks[:EXTRA_CPU_ROWS].cpu(), c_toks)
                  and torch.equal(lens[:EXTRA_CPU_ROWS].cpu(), c_lens),
                  f"{topology} {name} decode: card tokens and lengths equal CPU")
            agree(scores[:EXTRA_CPU_ROWS].cpu(), c_scores, 1e-5, 0.0,
                  f"{topology} {name} decode scores: card vs CPU")

        # ---- sampling ----
        samples, sample_lp = ctc.ctc_sample_alignments(*args, 0, gen, NUM_SAMPLES,
                                                       topology)
        check(bool(collapses_to_label(torch, samples, labels, label_length, 0,
                                      topology == "classic")[feasible].all()),
              f"{topology} samples collapse to their labels")
        check(bool((samples.permute(0, 2, 1)[~ok] == 0).all()),
              f"{topology} samples blank past logit_length and on infeasible rows")
        check(bool(torch.isneginf(sample_lp[~feasible]).all()),
              f"{topology} samples: -inf on infeasible rows")
        frame_lp = torch.gather(lp.double()[:, None].expand(-1, NUM_SAMPLES, -1, -1), 3,
                                samples.long()[..., None])[..., 0]
        direct = torch.where(valid[:, None], frame_lp, torch.zeros_like(frame_lp)).sum(2)
        agree(sample_lp[feasible], direct[feasible], 1e-5, 0.0,
              f"{topology} sample log-probs vs their frame sums")
        counts = torch.zeros_like(post).scatter_add_(
            2, samples.permute(0, 2, 1).long(), torch.ones_like(samples.permute(0, 2, 1),
                                                               dtype=post.dtype))
        k, p = counts[ok].reshape(-1), post[ok].reshape(-1)
        pvals = binomial_pvalues(torch, k, p, NUM_SAMPLES, POSTERIOR_ATOL)
        check(float(pvals.min()) >= FAMILY_ALPHA / (2 * len(p)),
              f"{topology} sampled frequencies: least tail probability "
              f"{float(pvals.min()):.3g} over {len(p)} entries")
        p64 = p.double()
        sq_ratio = float(((k.double() / NUM_SAMPLES - p64) ** 2).sum()
                         / (p64 * (1 - p64) / NUM_SAMPLES).sum())
        check(abs(sq_ratio - 1) <= SQ_RATIO_TOL, f"{topology} sampled frequencies: squared "
              f"deviation {sq_ratio:.3f} of its expectation")

        # ---- the HVP of the first rows ----
        h_args = [a[:HVP_ROWS] for a in args]
        vec = torch.randn(h_args[1].shape, generator=gen, device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        reset_launches()
        hvp = ctc.ctc_loss_hessian_vector_product(*h_args, 0, vec, topology)
        sync()
        got_hvp = {k: n for k, n in read_launches("hvp").items() if n}
        launches.update(got_hvp)
        want_hvp = {f"{topology}_alpha_jvp64": 1, f"{topology}_beta_jvp64": 1}
        check(got_hvp == want_hvp, f"{topology} HVP launched {got_hvp}, expected {want_hvp}")
        peak = torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else 0
        check(peak < HVP_PEAK_BYTES, f"{topology} HVP peak memory {peak / 1e9:.3f} GB")
        h_feasible = feasible[:HVP_ROWS]
        check(bool((hvp[~h_feasible] == 0).all()), f"{topology} HVP zero on infeasible rows")
        # the float64 oracle: central difference of the float64 gradient
        eps, lp64, vec64 = 1e-4, h_args[1].double(), vec.double()
        grads = [pure_float64_grad(h_args[0], lp64 + sign * eps * vec64, *h_args[2:],
                                   topology)[2] for sign in (1, -1)]
        hvp64 = (grads[0] - grads[1]) / (2 * eps)
        hvp_err = max_err(hvp, hvp64)
        agree(hvp, hvp64, 0.0, 1e-4, f"{topology} HVP vs the float64 central difference")
        # the same product in float32, as the JAX package computes it
        hvp32 = torch.func.jvp(lambda x: core.gradient(
            topo, core.make_context(h_args[0], x, *h_args[2:], 0)), (h_args[1],), (vec,))[1]
        log(f"phase 8 {topology}: ok; posteriors launches {json.dumps(got)}, with rows "
            f"2-5 flushed {json.dumps(s_got)}, max abs err vs float64 {post_err:.3g}; "
            f"rows 0-{EXTRA_CPU_ROWS - 1} of forced alignment, greedy and beam search "
            f"(K={BEAM_WIDTH}) equal on card and CPU; {NUM_SAMPLES} samples a row valid "
            f"and scored, least binomial tail probability {float(pvals.min()):.3g} "
            f"(limit {FAMILY_ALPHA / (2 * len(p)):.3g}), squared deviation "
            f"{sq_ratio:.3f} of its expectation; HVP of rows 0-{HVP_ROWS - 1}: peak "
            f"{peak / 1e9:.3f} GB, max abs err vs the float64 central difference "
            f"{hvp_err:.3g} (computed in float32: {max_err(hvp32, hvp64):.3g})")

        # ---- times: every function ran above, no warm-up ----
        calls = {
            "posteriors": lambda: ctc.ctc_token_posteriors(*args, 0, topology),
            "posteriors_rows_2_5_flushed":
                lambda: ctc.ctc_token_posteriors(*s_args, 0, topology),
            "forced_alignment": lambda: ctc.ctc_forced_alignment(*args, 0, topology),
            "greedy_decode": lambda: ctc.ctc_greedy_decode(lp, logit_length, 0, topology),
            f"beam_search_k{BEAM_WIDTH}": lambda: ctc.ctc_beam_search_decode(
                lp, logit_length, 0, BEAM_WIDTH, topology),
            f"sample_s{NUM_SAMPLES}": lambda: ctc.ctc_sample_alignments(
                *args, 0, gen, NUM_SAMPLES, topology),
            f"hvp_{HVP_ROWS}_rows": lambda: ctc.ctc_loss_hessian_vector_product(
                *h_args, 0, vec, topology),
        }
        for name, fn in calls.items():
            times[f"{topology}_{name}"] = time_ms(torch, fn, runs=5, burst=1, warmup=False)
        if topology == "classic":
            # where the time of a PyTorch loop goes; the profiler's cost grows
            # with the launches it records, so only the smallest loop's
            log("phase 8 profile of classic forced_alignment: " + json.dumps(profile_step(
                torch, dev, times["classic_forced_alignment"], calls["forced_alignment"],
                steps=1)))
    log(f"phase 8 timing (ms, CUDA events around single calls, median of 5; B={BATCH}, "
        f"T={MAX_T}, V={VOCAB}; " + card + "): " + json.dumps(times))
    log(f"phase 8: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, times=times)


# phase 9: the flagship encoder's training step at full width
ENC_FEATURES, ENC_HIDDEN, ENC_VOCAB, ENC_LAYERS = 80, 512, 128, 4  # the reference's
ENC_FRAMES = 2 * MAX_T  # feature frames: the stride-2 stem gives T=500 logit frames
ENC_STEPS, ENC_SIMPLIFIED_STEPS = 5, 2
ENC_CPU_ROWS = 8  # rows whose step-1 logits are held against the CPU
# cuDNN runs the float32 stem in TF32 on the card (10-bit mantissas, 2^-11
# relative a product); the bf16 roundings after it then flip where the CPU's
# do not, each moving a frame's logits by a bf16 ulp of what it rounds
ENC_LOGITS_ATOL = 5e-2
# a flipped bf16 cotangent moves a weight-gradient entry by 2^-8 of itself
# (tests/test_torch_port_encoder.py): each tensor within 1e-2 of its largest
ENC_GRAD_SHARE = 1e-2
DEMO_STEPS = 150
DEMO_BATCH = 64  # the JAX demo's global batch: 8 devices of 8 rows


def encoder_batch(torch, seed, dev):
    """Phase 9's batch: ``make_inputs(vocab=128)``'s labels [256, 250] and
    lengths (rows 0 and 1 infeasible), ``feature_length = 2 *
    logit_length``, features [B, 1000, 80] N(0, 1) from ``seed``."""
    labels, _, label_length, logit_length = make_inputs(torch, seed, dev,
                                                        vocab=ENC_VOCAB)
    gen = torch.Generator().manual_seed(seed)
    features = torch.randn((len(labels), ENC_FRAMES, ENC_FEATURES), generator=gen)
    return {"features": features.to(dev), "feature_length": 2 * logit_length,
            "labels": labels, "label_length": label_length}


def param_grads(model) -> dict:
    return {name: p.grad.clone() for name, p in model.named_parameters()}


def drive_encoder(torch, dev, seed, sync, card) -> dict:
    """Phase 9: the flagship encoder (F=80, H=512, V=128, 4 layers) trained
    by the eager body of ``parallel.make_train_step`` on a 1 x 1 ``('data', 'model')`` mesh
    over a one-rank NCCL group (a ``file://`` rendezvous).  Classic Adam
    steps (B2 and B3 once each a step, step 1's masked mean against the
    float64 pure path and its logits against the CPU), a fused and an
    unfused step from the same parameters, simplified steps (B6 resid and
    B7), forward-only calls (B1 final, B6 final), the demo of
    ``tools/train_ctc_asr.py`` and the scan gaps of its trained logits, and
    the step's times.  The launch counts are set to 0 before each path and
    read after it.  Returns the launches."""
    import os
    import tempfile
    from collections import Counter

    import torch.distributed as dist

    import tf_seq2seq_losses_tpu_torch as ctc
    from tf_seq2seq_losses_tpu_torch.models import encoder as enc
    from tf_seq2seq_losses_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        make_train_step,
        train_step_eager,
    )
    from tf_seq2seq_losses_tpu_torch.tools import train_ctc_asr
    from tf_seq2seq_losses_tpu_torch.utils import roofline
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override

    t_phase = time.perf_counter()
    launches = Counter()

    def launched(call):
        """``call()``'s result and the launches it made (counts reset first)."""
        reset_launches()
        out = call()
        sync()
        got = Counter()
        for path in ("classic", "simplified"):
            got.update({k: n for k, n in read_launches(path).items() if n})
        got["fused_dlogits"] = read_launches("classic")["fused_dlogits"]
        got = +got
        launches.update(got)
        return out, dict(got)

    # ---- 1. rendezvous: one NCCL rank (gloo for a CPU rehearsal) ----
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    tmp = tempfile.TemporaryDirectory()
    init_distributed(f"file://{tmp.name}/rendezvous", 1, 0, device=dev)
    try:
        backend = dist.get_backend()
        check(backend == ("nccl" if dev.type == "cuda" else "gloo"),
              f"phase 9 process group backend {backend}")
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        batch = encoder_batch(torch, seed, dev)
        params = enc.init_encoder(torch.Generator().manual_seed(seed), ENC_FEATURES,
                                  ENC_HIDDEN, ENC_VOCAB, ENC_LAYERS, device=dev)
        logit_length = enc.subsampled_length(batch["feature_length"])
        labels, label_length = batch["labels"], batch["label_length"]

        # ---- 2. classic Adam steps: the eager body (phase 12 runs the graph) ----
        eager_adam = lambda p: torch.optim.Adam(p, lr=1e-3)  # noqa: E731
        init_state, shard, _ = make_train_step(mesh, topology="classic",
                                               optimizer=eager_adam)

        def train_step(state, batch, topology="classic"):
            return train_step_eager(state, batch, topology, 0, mesh.group("data"))

        state = init_state(params)
        cpu_model = enc.Encoder(ENC_FEATURES, ENC_HIDDEN, ENC_VOCAB, ENC_LAYERS,
                                device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   state.params.state_dict().items()})
        local = shard(batch)
        seen = []
        hook = state.params.register_forward_hook(
            lambda _m, _i, out: seen.append(out.detach()) if not seen else None)
        losses, per_step = [], []
        for _ in range(ENC_STEPS):
            (_, loss), got = launched(lambda: train_step(state, local))
            losses.append(float(loss))
            per_step.append(got)
        hook.remove()
        for i, got in enumerate(per_step):
            check(got.get("classic_fwd[resid]") == 1
                  and got.get("classic_bwd_streamed") == 1,
                  f"phase 9 classic step {i + 1} launched {got}")
        check(all(math.isfinite(v) for v in losses), f"phase 9 classic losses {losses}")
        logits1 = seen[0]
        loss64, _ = pure_float64(labels, logits1, label_length, logit_length)
        finite = torch.isfinite(loss64)
        mean64 = float(loss64[finite].mean())
        check(abs(losses[0] - mean64) <= 1e-5 * abs(mean64),
              f"phase 9 step 1 masked mean {losses[0]} vs float64 {mean64}")
        with torch.no_grad():
            cpu_logits = cpu_model(batch["features"][:ENC_CPU_ROWS].cpu())
        cpu_err = max_err(logits1[:ENC_CPU_ROWS].cpu(), cpu_logits)
        check(cpu_err <= ENC_LOGITS_ATOL,
              f"phase 9 step 1 logits card vs CPU: max abs err {cpu_err:.3g}")
        log(f"phase 9 classic: ok, {ENC_STEPS} Adam steps, losses "
            f"{[round(v, 4) for v in losses]}, launches a step {json.dumps(per_step[0])}; "
            f"step 1 masked mean vs float64 rel err {abs(losses[0] - mean64) / mean64:.3g}"
            f" ({int((~finite).sum())} infeasible rows); logits of rows "
            f"0-{ENC_CPU_ROWS - 1} card vs CPU max abs err {cpu_err:.3g} (max |logit| "
            f"{float(cpu_logits.abs().max()):.3g})")

        # ---- 3. one fused and one unfused step from the same parameters ----
        steps = {}
        for fused in (True, False):
            with config_override(fused_epilogue=fused):
                f_state = init_state(params)
                (_, loss), got = launched(lambda: train_step(f_state, local))
            steps[fused] = (loss, param_grads(f_state.params), got)
        check(steps[True][2].get("fused_dlogits") == 1,
              f"phase 9 fused step launched {steps[True][2]}")
        check("fused_dlogits" not in steps[False][2], "phase 9 unfused step took B12")
        check(torch.equal(steps[True][0], steps[False][0]),
              "phase 9 fused step loss bit for bit the unfused step's")
        shares = {name: max_err(g, steps[False][1][name])
                  / float(steps[False][1][name].abs().max())
                  for name, g in steps[True][1].items()}
        worst = max(shares, key=shares.get)
        check(shares[worst] <= ENC_GRAD_SHARE,
              f"phase 9 fused vs unfused gradient of {worst}: {shares[worst]:.3g} of its "
              f"largest entry")
        log(f"phase 9 fused step: ok, launches {json.dumps(steps[True][2])}, loss bit "
            f"for bit; parameter gradients vs unfused, largest share of a tensor's "
            f"largest entry {shares[worst]:.3g} ({worst})")

        # ---- 4. simplified steps ----
        s_state = init_state(params)
        s_losses = []
        for i in range(ENC_SIMPLIFIED_STEPS):
            (_, loss), got = launched(lambda: train_step(s_state, local, "simplified"))
            s_losses.append(float(loss))
            check(got.get("simplified_fwd[resid]") == 1
                  and got.get("simplified_bwd_streamed") == 1,
                  f"phase 9 simplified step {i + 1} launched {got}")
        check(all(math.isfinite(v) for v in s_losses),
              f"phase 9 simplified losses {s_losses}")

        # ---- 5. evaluation: forward-only calls ----
        evals = {}
        for topology in ("classic", "simplified"):
            def evaluate():
                with torch.no_grad():
                    return ctc.ctc_loss(labels, state.params(local["features"]),
                                        label_length, logit_length, 0, topology)
            loss, got = launched(evaluate)
            check(got.get(f"{topology}_fwd[final]") == 1
                  and bool(torch.isfinite(loss[2:]).all()),
                  f"phase 9 {topology} evaluation launched {got}")
            evals[topology] = got
        log(f"phase 9 simplified: ok, losses {[round(v, 4) for v in s_losses]}; "
            f"evaluation launches {json.dumps(evals)}")

        # ---- 6. the demo, then the scan gaps of its trained logits ----
        t_demo = time.perf_counter()
        demo, got = launched(lambda: train_ctc_asr.train(
            DEMO_STEPS, DEMO_BATCH, "classic", device=dev,
            log=lambda msg: log("phase 9 demo " + msg)))
        # its beam rescoring (one call at V=ENC_VOCAB) through the kernel
        got["classic_beam_search"] = read_launches("extras")["classic_beam_search"]
        check(got["classic_beam_search"] == 1, f"phase 9 demo beam search launched "
              f"classic_beam_search {got['classic_beam_search']} times, expected 1")
        launches["classic_beam_search"] += 1
        check(demo["greedy_accuracy"] >= train_ctc_asr.MIN_ACCURACY,
              f"phase 9 demo greedy accuracy {demo['greedy_accuracy']:.3f}")
        d_batch = demo["eval_batch"]
        d_args = [torch.as_tensor(d_batch[k], device=dev)
                  for k in ("labels", "label_length")]
        gaps = {topology: scan_gaps(torch, topology, d_args[0], demo["logits"],
                                    d_args[1], demo["logit_length"])
                for topology in ("classic", "simplified")}
        log(f"phase 9 demo: ok, {DEMO_STEPS} steps at batch {DEMO_BATCH}, greedy "
            f"{demo['greedy_accuracy']:.3f}, beam-{train_ctc_asr.BEAM_WIDTH} "
            f"{demo['beam_accuracy']:.3f}, launches {json.dumps(got)}, "
            f"{time.perf_counter() - t_demo:.1f} s; scan gaps of its trained logits "
            f"(flagged rows, which the guard repairs): {json.dumps(gaps)}")

        # ---- 7. timing ----
        step = lambda: train_step(state, local)  # noqa: E731
        step_ms = host_ms(torch, step, runs=5)
        profile = profile_step(torch, dev, step_ms, step, steps=1)
        with torch.no_grad():
            x = state.params(local["features"])

        def loss_fwd_bwd():
            xg = x.detach().requires_grad_(True)
            losses = ctc.classic_ctc_loss(labels, xg, label_length, logit_length, 0)
            torch.where(torch.isfinite(losses), losses,
                        torch.zeros_like(losses)).sum().backward()

        loss_ms = time_ms(torch, loss_fwd_bwd, runs=5, burst=1)
        streams = roofline.classic_grad_streams(
            len(labels), x.shape[1], ENC_VOCAB, labels.shape[1] + 1)
        try:
            line = roofline.roofline(streams, loss_ms)
        except ValueError as exc:  # a card without a known HBM peak
            line = {"not measured": str(exc)}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        step()
        sync()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
        log(f"phase 9 timing ({card}; B={len(labels)}, T={x.shape[1]}, V={ENC_VOCAB}, "
            f"H={ENC_HIDDEN}, {ENC_LAYERS} layers): step {step_ms:.3f} ms (host clock, "
            f"median of 5); profile of one step {json.dumps(profile)}; the loss's "
            f"forward and backward {loss_ms:.3f} ms (CUDA events, median of 5), "
            f"{loss_ms / step_ms:.3f} of the step; roofline of the loss "
            f"{json.dumps(line)}; peak device memory of a step {peak:.3f} GB")
    finally:
        # ---- 8. tear down ----
        if dist.is_initialized():
            dist.destroy_process_group()
        tmp.cleanup()
    log(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# phase 10: the guard's structures, placements and fallback cap
LADDER_N = (0, 1, 20, 40, 80)  # flushed rows, the JAX package's r5b ladder
LADDER_SCALE = 1e2
# The whole-batch tier recomputes every row of up to 499 steps through the
# float32 log-space route, whose own distance from float64 grows with the
# row (tools/log_precision.py: 4.5e-4 in the gradient at T=495) and reached
# 1.5e-3 to 2.6e-3 in d_logits at T=500 on an H100.  That is the route's
# precision, not the kernels': the tier is held to the route's plain
# versions run on the same step (the kernels are theirs bit for bit,
# phase 2), its float64 distance printed.
PLAIN_ROUTE_ATOL = 1e-5
LADDER_PATHS = (("while", False), ("cond", False), ("while", True))
FLUSHED_ATOL = 2e-4  # rows the log-space kernels repair (phase 4)


def ladder_tier(struct, tier1, n, batch):
    """``(tier, rows of each log-space round)`` that the guard takes for
    ``n`` flushed rows, each one chunk long, at the config's buckets and a
    cap that admits every tier: "clean", "pure" (no log-space launch),
    "rounds" or "gathered" (the flushed rows), "whole" (every row)."""
    from tf_seq2seq_losses_tpu_torch.utils.config import get_config

    cfg = get_config()
    bucket, bucket2 = min(cfg.repair_bucket, batch), min(cfg.repair_bucket2, batch)
    if n == 0:
        return "clean", []
    if struct == "while":
        if tier1 and bucket < batch and n <= bucket:
            return "pure", []
        size = max(bucket2, bucket)
        return "rounds", [size] * (n // size) + ([n % size] if n % size else [])
    if n <= bucket:
        return "pure", []
    if n <= bucket2:
        return "gathered", [n]
    return "whole", [batch]


class LogRows:
    """Records ``(kernel, rows)`` of every log-space kernel call while it is
    entered, by a spy in each wrapper's place in its module; with ``plain``
    the spy runs the kernel's plain version instead.  A wrapper counts its
    launches on the function its module names, so each spy carries the
    wrapper's counts and gives them back on exit."""

    NAMES = ("classic_log_fwd", "classic_log_bwd", "simplified_log_fwd",
             "simplified_log_bwd")

    def __init__(self, plain=False):
        self.plain = plain

    def __enter__(self):
        from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

        self.rows, self.spies = [], {}
        for name in self.NAMES:
            real = getattr(ll, name)
            run = getattr(ll, name + "_plain") if self.plain else real

            def spy(*args, _run=run, _name=name):
                key = _name if _name.endswith("bwd") else f"{_name}[{args[-1]}]"
                self.rows.append((key, int(args[0].shape[0])))
                out = _run(*args)
                self.launched(key)
                return out

            spy.launches = real.launches
            if hasattr(real, "mode_launches"):
                spy.mode_launches = real.mode_launches  # shared: updated in place
            self.spies[name] = (real, spy)
            setattr(ll, name, spy)
        return self.rows

    def launched(self, key) -> None:
        """Called by a spy after its kernel or plain version ran."""

    def __exit__(self, *exc):
        from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll

        for name, (real, spy) in self.spies.items():
            real.launches = spy.launches
            setattr(ll, name, real)
        return False


class FallbackBytes:
    """``CTC_TPU_GUARD_FALLBACK_BYTES`` set to ``cap`` in this process while
    entered, then restored."""

    VAR = "CTC_TPU_GUARD_FALLBACK_BYTES"

    def __init__(self, cap):
        self.cap = cap

    def __enter__(self):
        import os

        self.old = os.environ.get(self.VAR)
        os.environ[self.VAR] = str(self.cap)

    def __exit__(self, *exc):
        import os

        if self.old is None:
            os.environ.pop(self.VAR, None)
        else:
            os.environ[self.VAR] = self.old
        return False


def drive_guard_ladder(torch, dev, seed, sync, card) -> dict:
    """Phase 10, for each topology at the headline shape with n of
    ``LADDER_N`` rows (2 to n + 1) flushed by ``saturate`` at 1e2: the
    training step and the forward-only call under ``guard_struct`` "while"
    and "cond" and under "while" with ``guard_tier1``; the step under
    ``guard_mode`` "pre" and "grad" at n = 0 and 20; the fused step (V=128)
    under "cond" at n = 40; two steps under a shrunk fallback cap.  Each a
    path of its own (launch counts set to 0 just before, read just after,
    with the rows of every log-space launch).  Then the whole-batch tier's
    B4/B5 (B8/B9) against their plain versions, and the times.  Returns the
    launches and the log-space kernels' errors."""
    import warnings
    from collections import Counter

    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import topology as topo_mod
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES, est_fallback_bytes
    from tf_seq2seq_losses_tpu_torch.utils.config import get_config
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    t_phase = time.perf_counter()
    launches, errs = Counter(), {}

    def path(topology, fn):
        """``fn()``, its launches and the rows of its log-space launches."""
        reset_launches()
        with LogRows() as rows:
            out = fn()
            sync()
        got = {k: n for k, n in read_launches(topology).items() if n}
        launches.update(got)
        return out, got, Counter(rows)

    inputs = make_inputs(torch, seed, dev)
    labels, logits, label_length, logit_length = inputs
    batch, top = len(labels), max(LADDER_N)
    mode_n = (0, LADDER_N[2])
    beyond = LADDER_N[3]  # past tier 2 (n > repair_bucket2 = 32)

    def flushed(base, n):
        return saturate(torch, *base, rows=tuple((r, LADDER_SCALE) for r in range(2, 2 + n)))

    batches = {n: flushed(inputs, n) for n in LADDER_N}
    row_ids = torch.arange(batch, device=dev)
    syncs = []
    real_flushed_rows = topo_mod.flushed_rows

    def counting_flushed_rows(*a):
        syncs.append(1)
        return real_flushed_rows(*a)

    for name in ("classic", "simplified"):
        t_top = time.perf_counter()
        loss_fn = loss_function(name)
        step = make_step(torch, loss_fn, labels)
        fwd_resid, fwd_final = f"{name}_fwd[resid]", f"{name}_fwd[final]"
        bwd = f"{name}_bwd_streamed"
        log_final, log_resid, log_bwd = (f"{name}_log_{m}" for m in
                                         ("fwd[final]", "fwd[resid]", "bwd"))

        def expected(sizes, evaluation=True):
            """The launches and the log-space ``(kernel, rows)`` of a
            training step whose repair rounds take ``sizes`` rows, and of a
            forward-only call after it (``evaluation``)."""
            want = Counter({fwd_resid: 1, bwd: 1, fwd_final: int(evaluation)})
            rows = Counter()
            for size in sizes:
                rows.update({(log_final, size): 1 + evaluation, (log_resid, size): 1,
                             (log_bwd, size): 1})
            for (kernel, _), k in rows.items():
                want[kernel] += k
            return dict(+want), rows

        def evaluate(x, ll_, gl_, _fn=loss_fn):
            with torch.no_grad():
                return _fn(labels, x, ll_, gl_, 0)

        loss64_0, d64_0 = pure_float64(labels, logits, label_length, logit_length, name)
        loss64_s, d64_s = pure_float64(labels, *batches[top], name)

        def reference(n):
            sat = (row_ids >= 2) & (row_ids < 2 + n)
            return (torch.where(sat, loss64_s, loss64_0),
                    torch.where(sat[:, None, None], d64_s, d64_0), sat)

        def feasible(batch_n):
            _, ll_, gl_ = batch_n
            ctx = core.make_context(labels, logit_to_logproba(logits[:, :1], 2), ll_, gl_, 0)
            return TOPOLOGIES[name].feasible(ctx)

        def hold(tag, loss, d, n, tier, clean_ref, batch_n=None, ref=None, plain=None):
            """The checks of a step's loss and d_logits with rows 2..n+1
            flushed (``plain``: the same step with the log-space kernels'
            plain versions, for the whole-batch tier); returns the largest
            errors against float64."""
            lref, dref, sat = ref or reference(n)
            feas = feasible(batch_n or batches[n])
            check(bool(torch.isposinf(loss[~feas]).all()) and bool((d[~feas] == 0).all()),
                  f"{tag}: infeasible rows +inf with zero d_logits")
            clean = feas & ~sat
            out = {}
            if tier == "whole":
                agree(loss[clean], lref[clean], 1e-5, 0.0,
                      f"{tag}: rerouted clean rows' loss vs float64")
                agree(loss, plain[0], 1e-5, 0.0, f"{tag}: loss vs the plain log-space route")
                agree(d, plain[1], 0.0, PLAIN_ROUTE_ATOL,
                      f"{tag}: d_logits vs the plain log-space route")
                out["clean_d_err"] = max_err(d[clean], dref[clean])
                out["d_err_vs_plain_route"] = max_err(d, plain[1])
            else:
                check(torch.equal(loss[clean], clean_ref[0][clean])
                      and torch.equal(d[clean], clean_ref[1][clean]),
                      f"{tag}: clean rows bit for bit the clean step's")
            if n:
                tol = 1e-5 if tier == "pure" else FLUSHED_ATOL
                agree(loss[sat], lref[sat], 1e-5 if tier == "pure" else 0.0,
                      0.0 if tier == "pure" else tol, f"{tag}: repaired loss vs float64")
                agree(d[sat], dref[sat], 0.0, tol, f"{tag}: repaired d_logits vs float64")
                out["repaired_d_err"] = max_err(d[sat], dref[sat])
            return out

        # ---- the structs, each n: a step and a forward-only call ----------
        results, report, steps, evals = {}, {}, {}, {}
        clean_ref = None
        for struct, tier1 in LADDER_PATHS:
            tag = struct + ("+tier1" if tier1 else "")
            run_step = configured(step, guard_struct=struct, guard_tier1=tier1)
            run_eval = configured(evaluate, guard_struct=struct, guard_tier1=tier1)
            for n in LADDER_N:
                b = batches[n]
                ((loss, d), loss_eval), got, rows = path(name, lambda: (run_step(*b),
                                                                        run_eval(*b)))
                tier, sizes = ladder_tier(struct, tier1, n, batch)
                want, want_rows = expected(sizes)
                check(got == want and rows == want_rows,
                      f"{name} {tag} n={n} ({tier}): launches {got}, log-space rows "
                      f"{dict(rows)}; expected {want}, {dict(want_rows)}")
                check(torch.equal(loss_eval, loss),
                      f"{name} {tag} n={n}: the forward-only loss is the step's")
                if clean_ref is None:
                    clean_ref = (loss, d)
                with LogRows(plain=True):
                    plain = run_step(*b) if tier == "whole" else None
                report[f"{tag} n={n}"] = dict(tier=tier, rounds=sizes, **hold(
                    f"{name} {tag} n={n}", loss, d, n, tier, clean_ref, plain=plain))
                results[tag, n] = (loss, d)
                steps[f"{tag}_n{n}"] = (run_step, b)
                evals[f"{tag}_n{n}"] = (run_eval, b)
        log(f"phase 10 {name} structs: ok; tiers, log-space rounds and largest errors "
            f"vs float64 {json.dumps(report)}")

        # ---- the placements: "pre" and "grad" against "post" --------------
        modes = {}
        topo_mod.flushed_rows = counting_flushed_rows
        try:
            for n in mode_n:
                b = batches[n]
                post = results["while", n]
                for mode in ("post", "pre", "grad"):
                    run_step = configured(step, guard_mode=mode)
                    syncs.clear()
                    (loss, d), got, rows = path(name, lambda: run_step(*b))
                    want, want_rows = expected(ladder_tier("while", False, n, batch)[1],
                                               evaluation=False)
                    check(got == want and rows == want_rows,
                          f"{name} guard_mode={mode} n={n}: launches {got}")
                    check(torch.equal(loss, post[0]) and torch.equal(d, post[1]),
                          f"{name} guard_mode={mode} n={n}: loss and d_logits bit for "
                          "bit those of post")
                    modes[f"{mode} n={n}"] = dict(launches=got, guard_syncs=len(syncs))
                    steps[f"{mode}_n{n}"] = (run_step, b)
                check(modes[f"pre n={n}"]["guard_syncs"] == (1 if n == 0 else 2),
                      f"{name} pre n={n}: guard synchronisations {modes}")
            off_step = configured(step, guard=False)
            syncs.clear()
            (loss, d), got, _ = path(name, lambda: off_step(*batches[0]))
            check(got == modes["pre n=0"]["launches"] and not syncs,
                  f"{name}: guard=False launches {got}, pre at n=0 "
                  f"{modes['pre n=0']['launches']}")
            check(torch.equal(d, results["while", 0][1]),
                  f"{name}: the clean step's d_logits are guard=False's")
            steps["guard_off_n0"] = (off_step, batches[0])
        finally:
            topo_mod.flushed_rows = real_flushed_rows
        log(f"phase 10 {name} guard modes: ok, post, pre and grad give the same loss "
            f"and d_logits bit for bit at n = {list(mode_n)}; launches and the guard's "
            f"host synchronisations (nonzero) per step {json.dumps(modes)}; pre at n=0 "
            "launches what guard=False launches")

        # ---- the fused step (V=128) under "cond" beyond tier 2 -------------
        v_inputs = make_inputs(torch, seed, dev, vocab=SLICE_VOCAB)
        v_labels = v_inputs[0]
        v_sat = flushed(v_inputs, beyond)
        v_step = make_step(torch, loss_fn, v_labels)
        fused = configured(v_step, fused_epilogue=True, guard_struct="cond")
        (f_loss, f_d), got, rows = path(name, lambda: fused(*v_sat))
        tier, sizes = ladder_tier("cond", False, beyond, batch)
        check(tier == "whole", f"n={beyond} is past tier 2 ({tier})")
        want, want_rows = expected(sizes, evaluation=False)
        want["fused_dlogits"] = 1
        check(got == want and rows == want_rows,
              f"{name} fused cond n={beyond}: launches {got}, rows {dict(rows)}")
        u_loss, u_d = configured(v_step, guard_struct="cond")(*v_sat)
        check(torch.equal(f_loss, u_loss) and torch.equal(f_d, u_d),
              f"{name} fused cond n={beyond}: the unfused step's bits (both the whole "
              "batch's exact path)")
        v64 = pure_float64(v_labels, *v_sat, name)
        v_sat_rows = (row_ids >= 2) & (row_ids < 2 + beyond)
        with LogRows(plain=True):
            v_plain = fused(*v_sat)
        v_report = hold(f"{name} fused cond n={beyond}", f_loss, f_d, beyond, tier,
                        None, batch_n=v_sat, ref=(*v64, v_sat_rows), plain=v_plain)
        steps[f"fused_v{SLICE_VOCAB}_cond_n{beyond}"] = (fused, v_sat)
        steps[f"fused_v{SLICE_VOCAB}_cond_n0"] = (fused, v_inputs[1:])
        log(f"phase 10 {name} fused step at V={SLICE_VOCAB} under cond, n={beyond}: ok "
            f"({tier}), bit for bit the unfused step; launches {json.dumps(got)}, "
            f"log-space rows {json.dumps({k[0]: k[1] for k in rows})}; errors vs "
            f"float64 {json.dumps(v_report)}")
        del v_inputs, v_sat, v64, v_plain, f_d, u_d

        # ---- the fallback cap ----------------------------------------------
        bucket2 = min(get_config().repair_bucket2, batch)
        cap_mid = est_fallback_bytes(bucket2, logits.shape[1], labels.shape[1] + 1,
                                     lane_pad=True)
        cond_step = configured(step, guard_struct="cond")
        caps = {}
        for cap, text, kept in ((cap_mid, "whole-batch exact reroute disabled", bucket2),
                                (1, "saturation guard disabled", 0)):
            with FallbackBytes(cap), warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                (loss, d), got, rows = path(name, lambda: cond_step(*batches[beyond]))
            said = [str(w.message) for w in caught if text in str(w.message)]
            check(len(said) == 2, f"{name} cap {cap}: warned {[str(w.message) for w in caught]}")
            lref, dref, sat = reference(beyond)
            kept_rows = sat & (row_ids < 2 + kept)
            inf_rows = sat & ~kept_rows
            check(bool(torch.isposinf(loss[inf_rows]).all())
                  and bool((d[inf_rows] == 0).all()) and int(inf_rows.sum()) == beyond - kept,
                  f"{name} cap {cap}: rows past the first {kept} flushed keep +inf")
            if kept:
                agree(loss[kept_rows], lref[kept_rows], 0.0, FLUSHED_ATOL,
                      f"{name} cap {cap}: tier-2 rows' loss")
                agree(d[kept_rows], dref[kept_rows], 0.0, FLUSHED_ATOL,
                      f"{name} cap {cap}: tier-2 rows' d_logits")
            clean = feasible(batches[beyond]) & ~sat
            check(torch.equal(loss[clean], clean_ref[0][clean])
                  and torch.equal(d[clean], clean_ref[1][clean]),
                  f"{name} cap {cap}: clean rows bit for bit")
            want, want_rows = expected([kept] if kept else [], evaluation=False)
            check(got == want and rows == want_rows, f"{name} cap {cap}: launches {got}")
            caps[str(cap)] = dict(warning=said[0], inf_rows=int(inf_rows.sum()),
                                  launches=got)
        log(f"phase 10 {name} fallback cap (CTC_TPU_GUARD_FALLBACK_BYTES, restored "
            f"after): ok, cond at n={beyond}: {json.dumps(caps)}")

        # ---- the whole-batch tier's kernels against their plain versions ----
        ctx_top = core.make_context(labels, logit_to_logproba(batches[top][0], 2),
                                    *batches[top][1:], 0)
        compare = compare_classic_log if name == "classic" else compare_simplified_log
        errs.update(compare(ctx_top, f" (phase 10, the whole batch of {batch} rows, "
                                     f"{top} flushed)")[0])
        del ctx_top

        # ---- times -----------------------------------------------------------
        step_ms = {k: host_ms(torch, lambda: fn(*b)) for k, (fn, b) in steps.items()}
        eval_ms = {k: host_ms(torch, lambda: fn(*b)) for k, (fn, b) in evals.items()}
        ratios = {k: v / step_ms[k.rsplit("_n", 1)[0] + "_n0"] for k, v in step_ms.items()
                  if k.rsplit("_n", 1)[0] + "_n0" in step_ms}
        profiles = {k: profile_step(torch, dev, step_ms[k], lambda: steps[k][0](*steps[k][1]))
                    for k in ("while_n0", "cond_n0", "while+tier1_n0", "pre_n0",
                              "grad_n0", "guard_off_n0")}
        peaks = {}
        for k in ("while_n0", f"while_n{top}", f"cond_n{top}"):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            steps[k][0](*steps[k][1])
            sync()
            peaks[k] = (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else 0.0)
        log(f"phase 10 {name} timing ({card}; B={batch}, T={logits.shape[1]}, "
            f"V={logits.shape[2]}, fused at V={SLICE_VOCAB}; host clock, median of "
            f"{RUNS}): steps {json.dumps(step_ms)}; forward-only calls "
            f"{json.dumps(eval_ms)}; each step over its n=0 step {json.dumps(ratios)}; "
            f"profiles of the n=0 steps {json.dumps(profiles)}; peak device memory GB "
            f"{json.dumps(peaks)}; {time.perf_counter() - t_top:.1f} s")
        del steps, evals, results, clean_ref, loss64_0, d64_0, loss64_s, d64_s
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, errs=errs)


# ---- phase 11: the loss under torch.func -------------------------------------

# the headline batch of 256 rows viewed as 4 groups of 64
FUNC_GROUPS = 4
# the Hessian's batch, frames and vocabulary
HESS_B, HESS_T, HESS_V = 2, 12, 5
HESS_ATOL = 1e-5
HESS_RUNS = 5


def pure_float64_hessian(labels, x, label_length, logit_length, topology, level):
    """``[B, T, V, B, T, V]``: the double backward of the finite loss sum
    through the pure path of ``topology`` in float64 (PyTorch's own
    autograd through the recursions, not the analytic Hessian), on the
    CPU; ``x`` holds logits (``level="logits"``) or log-probabilities."""
    import torch

    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    args = [t.cpu() for t in (labels, label_length, logit_length)]

    def total(x64):
        lp64 = logit_to_logproba(x64, 2) if level == "logits" else x64
        loss = pure_float64_grad(args[0], lp64, *args[1:], topology)[1]
        return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum()

    return torch.autograd.functional.hessian(total, x.detach().cpu().double(),
                                             vectorize=True)


def drive_func(torch, dev, seed, sync, card) -> dict:
    """Phase 11, for each topology, with TF32 on: the headline batch viewed
    as ``FUNC_GROUPS`` groups through ``torch.func.vmap`` of the loss and of
    ``torch.func.grad`` of its finite sum, bit for bit the unmapped call's
    loss and ``.backward()``'s d_logits, each kernel launched once for the
    folded batch (with rows 2-5 flushed at 1e2 also the log-space pair);
    ``torch.func.grad`` on the whole batch, bit for bit ``.backward()``'s,
    and at V=128 with ``fused_epilogue`` through B12; ``jacrev(grad)`` at
    ``HESS_B, HESS_T, HESS_V`` at the logits and log-probability levels,
    the same fused and unfused and ``HESS_ATOL`` from the float64 pure
    path's double backward; ``jacrev`` three times raising.  Each a path of
    its own (launch counts set to 0 just before, read just after).  Then the
    ``vmap(grad)`` step's and the plain step's host-clock times.  Returns the
    launches."""
    from collections import Counter

    import tf_seq2seq_losses_tpu_torch as ctc
    from torch.func import grad, jacrev, vmap

    from tf_seq2seq_losses_tpu_torch.utils.config import config_override

    t_phase = time.perf_counter()
    launches = Counter()

    def path(topology, fn):
        reset_launches()
        out = fn()
        sync()
        got = {k: n for k, n in read_launches(topology).items() if n}
        launches.update(got)
        return out, got

    def grouped(*tensors):
        return [t.unflatten(0, (FUNC_GROUPS, -1)) for t in tensors]

    inputs = make_inputs(torch, seed, dev)
    labels = inputs[0]
    sat = saturate(torch, *inputs, rows=tuple((r, 1e2) for r in range(2, 6)))
    v_inputs = make_inputs(torch, seed, dev, vocab=SLICE_VOCAB)
    h_inputs = make_inputs(torch, seed, dev, batch=HESS_B, max_t=HESS_T, vocab=HESS_V,
                           label_width=3, infeasible=False)
    for name in ("classic", "simplified"):
        loss_fn = loss_function(name)
        fwd_final, fwd_resid = f"{name}_fwd[final]", f"{name}_fwd[resid]"
        bwd = f"{name}_bwd_streamed"
        repair = {f"{name}_log_fwd[final]": 1, f"{name}_log_fwd[resid]": 1,
                  f"{name}_log_bwd": 1}

        def finite_sum(x, la, a, b):
            loss = loss_fn(la, x, a, b, 0)
            return (torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum(),
                    loss)

        one_grad = grad(finite_sum, has_aux=True)
        v_loss = vmap(lambda x, la, a, b: loss_fn(la, x, a, b, 0))
        v_grad = vmap(one_grad)
        report = {}

        # ---- vmap at the headline, clean and with rows 2-5 flushed ----------
        for tag, (x, ll_, gl_) in (("clean", inputs[1:]), ("rows 2-5 flushed", sat)):
            step = make_step(torch, loss_fn, labels)
            ref_loss, ref_d = step(x, ll_, gl_)
            with torch.no_grad():
                ref_eval = loss_fn(labels, x, ll_, gl_, 0)
            g_args = grouped(x, labels, ll_, gl_)
            loss, got = path(name, lambda: v_loss(*g_args))
            want = {fwd_final: 1, **({f"{name}_log_fwd[final]": 1} if tag != "clean"
                                     else {})}
            check(got == want, f"phase 11 {name} vmap(loss) {tag}: launches {got}")
            check(torch.equal(loss.flatten(), ref_eval),
                  f"phase 11 {name} vmap(loss) {tag}: the unmapped call's loss")
            (d, aux), got = path(name, lambda: v_grad(*g_args))
            want = {fwd_resid: 1, bwd: 1, **(repair if tag != "clean" else {})}
            check(got == want, f"phase 11 {name} vmap(grad) {tag}: launches {got}")
            check(torch.equal(aux.flatten(), ref_loss) and torch.equal(d.flatten(0, 1), ref_d),
                  f"phase 11 {name} vmap(grad) {tag}: the unmapped step's loss and "
                  "d_logits bit for bit")
            report[f"vmap {tag}"] = got

        # ---- grad on the whole batch, unfused and fused at V=128 ------------
        x, ll_, gl_ = inputs[1:]
        ref_loss, ref_d = make_step(torch, loss_fn, labels)(x, ll_, gl_)
        (d, aux), got = path(name, lambda: one_grad(x, labels, ll_, gl_))
        check(got == {fwd_resid: 1, bwd: 1}, f"phase 11 {name} grad: launches {got}")
        check(torch.equal(aux, ref_loss) and torch.equal(d, ref_d),
              f"phase 11 {name} grad: .backward()'s loss and d_logits bit for bit")
        report["grad"] = got
        with config_override(fused_epilogue=True):
            v_labels, v_x, v_ll, v_gl = v_inputs
            ref_loss, ref_d = make_step(torch, loss_fn, v_labels)(v_x, v_ll, v_gl)
            (d, aux), got = path(name, lambda: one_grad(v_x, v_labels, v_ll, v_gl))
        check(got == {fwd_resid: 1, bwd: 1, "fused_dlogits": 1},
              f"phase 11 {name} grad fused at V={SLICE_VOCAB}: launches {got}")
        check(torch.equal(aux, ref_loss) and torch.equal(d, ref_d),
              f"phase 11 {name} grad fused at V={SLICE_VOCAB}: .backward()'s loss and "
              "d_logits bit for bit")
        report[f"grad fused V={SLICE_VOCAB}"] = got

        # ---- the Hessian, both levels, fused and unfused ---------------------
        h_labels, h_logits, h_ll, h_gl = h_inputs
        h_lp = torch.log_softmax(h_logits, 2)
        errs, hess_ms = {}, {}
        for level, fn, hx in (("logits", loss_fn, h_logits),
                              ("logproba", lambda *a: ctc.ctc_loss_from_logproba(
                                  *a, topology=name), h_lp)):
            def total(x_, _fn=fn):
                loss = _fn(h_labels, x_, h_ll, h_gl, 0)
                return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum()

            hess_ms[level] = host_ms(torch, lambda: jacrev(grad(total))(hx),
                                     runs=HESS_RUNS)
            hess = {}
            for fused in (False, True):
                with config_override(fused_epilogue=fused):
                    hess[fused], got = path(name, lambda: jacrev(grad(total))(hx))
                check(got.get(fwd_resid) == 1, f"phase 11 {name} {level} Hessian "
                      f"(fused {fused}): launches {got}")
                report[f"hessian {level} fused={fused}"] = got
            check(torch.equal(hess[False], hess[True]),
                  f"phase 11 {name} {level} Hessian: the same fused and unfused")
            h64 = pure_float64_hessian(h_labels, hx, h_ll, h_gl, name, level)
            agree(hess[True].cpu(), h64, 0.0, HESS_ATOL,
                  f"phase 11 {name} {level} Hessian vs the float64 pure path's double "
                  "backward")
            errs[level] = max_err(hess[True].cpu(), h64)
            try:
                jacrev(jacrev(grad(total)))(hx)
            except NotImplementedError:
                pass
            else:
                check(False, f"phase 11 {name} {level}: jacrev three times did not raise")

        # ---- times -----------------------------------------------------------
        step = make_step(torch, loss_fn, labels)
        g_args = grouped(inputs[1], labels, *inputs[2:])
        fns = {"plain_step": lambda: step(*inputs[1:]),
               "grad_step": lambda: one_grad(inputs[1], labels, *inputs[2:]),
               "vmap_grad_step": lambda: v_grad(*g_args)}
        ms = {k: host_ms(torch, fn) for k, fn in fns.items()}
        profiles = {k: profile_step(torch, dev, ms[k], fn) for k, fn in fns.items()}
        log(f"phase 11 {name}: ok, vmap over {FUNC_GROUPS} groups of "
            f"{len(labels) // FUNC_GROUPS} rows and grad bit for bit the unmapped "
            f"call and .backward(); launches {json.dumps(report)}; Hessian at B={HESS_B}, "
            f"T={HESS_T}, V={HESS_V} the same fused and unfused, max abs err vs the "
            f"float64 pure path's double backward {json.dumps(errs)}; jacrev three "
            f"times raises; timing ({card}; host clock, median of {RUNS}) "
            + json.dumps(ms) + f"; jacrev(grad) (median of {HESS_RUNS}) "
            + json.dumps(hess_ms) + "; profiles " + json.dumps(profiles))
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# ---- phase 12: the jitted paths (CUDA graphs) ---------------------------------

JIT_PROFILED_N = (0, 40)  # the replays whose kernels are listed
JIT_RUNS = 5  # the encoder's graphed and eager steps
LOG_KERNELS = {"classic": ("classic_log_fwd", "classic_log_bwd"),
               "simplified": ("simplified_log_fwd", "simplified_log_bwd")}


def capture(torch, fn, keep=False):
    """``(graph, fn's outputs)``: ``fn`` captured as a CUDA graph after one
    warm-up call on a side stream (kernels built, workspaces made)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def kernel_counts(torch, fn):
    """The device kernels that one call of ``fn`` runs, by name, with their
    counts (torch.profiler)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter({e.key: e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})


def log_kernel_counts(counts, topology) -> dict:
    """The log-space kernels of ``topology`` among ``counts``
    (:func:`kernel_counts`), the forward split by its template's mode."""
    fwd, bwd = LOG_KERNELS[topology]
    out = {}
    for key, n in counts.items():
        if fwd in key:
            mode = "resid" if "<true" in key else "final" if "<false" in key else key
            out[f"{fwd}[{mode}]"] = out.get(f"{fwd}[{mode}]", 0) + n
        elif bwd in key:
            out[bwd] = out.get(bwd, 0) + n
    return out


class DeviceTally(LogRows):
    """:class:`LogRows` whose spies also add one on the device to a counter
    of their kernel and mode after each launch: in a graph captured while
    entered, the adds sit in the IF nodes' bodies beside the kernels, so
    the counters (:meth:`read`, :meth:`zero`) count the launches that the
    replays ran, a witness independent of the profiler."""

    KEYS = tuple(f"{t}_log_{m}" for t in ("classic", "simplified")
                 for m in ("fwd[final]", "fwd[resid]", "bwd"))

    def __init__(self, torch, dev):
        super().__init__()
        self.counts = torch.zeros(len(self.KEYS), dtype=torch.int64, device=dev)

    def __enter__(self):
        super().__enter__()
        return self

    def launched(self, key) -> None:
        self.counts[self.KEYS.index(key)].add_(1)

    def zero(self) -> None:
        self.counts.zero_()

    def read(self) -> dict:
        return {k: n for k, n in zip(self.KEYS, self.counts.tolist()) if n}


class PureTally:
    """Adds one on the device to a counter each time the guard's pure path
    runs (``_pure_repair_loss`` in the forward's guard, ``_pure_repair`` in
    the backward's), by a spy on each topology while entered: in a graph
    captured while entered the adds sit in the IF bodies that run it, so
    the counters (:meth:`read`, :meth:`zero`) count the replays' pure
    rounds."""

    NAMES = ("_pure_repair_loss", "_pure_repair")

    def __init__(self, torch, dev):
        self.counts = torch.zeros(len(self.NAMES), dtype=torch.int64, device=dev)

    def __enter__(self):
        from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES

        self.topologies = list(TOPOLOGIES.values())
        for topo in self.topologies:
            for i, name in enumerate(self.NAMES):
                real = getattr(topo, name)

                def spy(c, _real=real, _i=i):
                    out = _real(c)
                    self.counts[_i].add_(1)
                    return out

                setattr(topo, name, spy)  # shadows the method on this instance
        return self

    def __exit__(self, *exc):
        for topo in self.topologies:
            for name in self.NAMES:
                delattr(topo, name)
        return False

    def zero(self) -> None:
        self.counts.zero_()

    def read(self) -> dict:
        return {k: n for k, n in zip(self.NAMES, self.counts.tolist()) if n}


class ScanTally:
    """Adds one on the device to a counter of a float64 scan (``PURE64``)
    after each call, by a spy in its wrapper's place in
    ``ops/pure_scan.py`` while entered: in a graph captured while entered
    the adds sit in the IF bodies beside the kernels, so the counters
    (:meth:`read`, :meth:`zero`) count the launches that the replays ran.
    Each spy carries its wrapper's launch count and gives it back on
    exit."""

    def __init__(self, torch, dev):
        self.counts = torch.zeros(len(PURE64), dtype=torch.int64, device=dev)

    def __enter__(self):
        from tf_seq2seq_losses_tpu_torch.ops import pure_scan

        self.module, self.spies = pure_scan, {}
        for i, name in enumerate(PURE64):
            real = getattr(pure_scan, name)

            def spy(*args, _real=real, _i=i):
                out = _real(*args)
                self.counts[_i].add_(1)
                return out

            spy.launches = real.launches
            self.spies[name] = (real, spy)
            setattr(pure_scan, name, spy)
        return self

    def __exit__(self, *exc):
        for name, (real, spy) in self.spies.items():
            real.launches = spy.launches
            setattr(self.module, name, real)
        return False

    def zero(self) -> None:
        self.counts.zero_()

    def read(self) -> dict:
        return {k: n for k, n in zip(PURE64, self.counts.tolist()) if n}

class BodyNodes:
    """The node counts of the IF-node bodies captured while entered, summed
    in ``nodes``, and each body's ``(nodes, capture seconds)`` in capture
    order in ``each`` (a wrapper in ``capture.if_node``'s place)."""

    def __enter__(self):
        import contextlib

        from tf_seq2seq_losses_tpu_torch.ops import capture as cap

        self.cap, self.real, self.nodes, self.each = cap, cap.if_node, 0, []

        @contextlib.contextmanager
        def counted(pred):
            t0 = time.perf_counter()
            with self.real(pred) as body:
                yield body
            self.nodes += body.nodes
            if body.nodes:
                self.each.append((body.nodes, time.perf_counter() - t0))

        cap.if_node = counted
        return self

    def __exit__(self, *exc):
        self.cap.if_node = self.real
        return False


def graph_nodes(graph) -> int:
    """The node count of the top level of a graph captured with
    ``keep_graph=True`` (an IF node counts one), from ``libcuda``'s
    ``cuGraphGetNodes``."""
    import ctypes

    nodes = ctypes.c_size_t()
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(nodes))
    check(err == 0, f"cuGraphGetNodes: CUresult {err}")
    return nodes.value


# the captures of phase 12 (a'): (topology, config), each on the ladder
COND_CAPTURES = (("classic", dict(guard_struct="cond")),
                 ("simplified", dict(guard_struct="cond")),
                 ("classic", dict(repair_bucket=0)))


def same_bits(a, b) -> bool:
    """Whether two float32 tensors hold the same bits (NaN included)."""
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def body_pool_gb(torch, dev):
    """The GB that the IF bodies' memory pool (``capture.prepare``) holds,
    or why that is not measured."""
    from tf_seq2seq_losses_tpu_torch.ops import capture as cap

    pool = cap.prepare(dev)[1]
    if not hasattr(pool, "snapshot"):
        return "not measured: this PyTorch's MemPool has no snapshot"
    return sum(seg["total_size"] for seg in pool.snapshot()) / 1e9


def drive_jit_cond(torch, dev, seed, sync, card, launched, inputs, batches,
                   while_peaks) -> None:
    """Phase 12 (a'): the headline step captured under ``guard_struct="cond"``
    (each topology) and under ``repair_bucket=0`` (classic, the two-way
    guard), each guard one IF node a tier, replayed on phase 10's batches
    (n in ``LADDER_N``): each replay bit for bit the eager step under the
    same config; its log-space launches counted on the device
    (``DeviceTally``) against ``ladder_tier("cond", ...)`` (under
    ``repair_bucket=0`` the whole batch at any n > 0), and its pure-path
    rounds (``PureTally``: tier 1's, at n = 1 only); the eager and graphed
    steps' host ms (median of ``RUNS``), device ms and idle share (one
    profile) and the replays' CUDA-event ms; the capture's seconds and
    nodes, tier 1's bodies' nodes and capture seconds; the peak device
    memory of the n=80 replay beside the "while" graph's (``while_peaks``)
    and the eager step's.  Then the fused step at V=128 under "cond",
    captured and replayed at n=40: B12 once in the graph, the whole batch
    rerouted on the device, bit for bit the eager fused step."""
    from collections import Counter

    from tf_seq2seq_losses_tpu_torch.utils.config import config_override, get_config

    labels, logits, label_length, logit_length = inputs
    batch = len(labels)
    bucket2 = min(get_config().repair_bucket2, batch)
    top = max(LADDER_N)
    beyond = LADDER_N[3]  # past tier 2 (n > repair_bucket2 = 32)

    def graphed(name, cfg, labels_, logits_, ll_, gl_):
        """``(graph, (loss, d_logits) statics, load, launches, log rows,
        tallies, bodies, seconds)`` of the step captured under ``cfg`` on
        the clean batch."""
        loss_fn = loss_function(name)
        x = logits_.clone().requires_grad_(True)
        ll_s, gl_s = ll_.clone(), gl_.clone()

        def load(b):
            with torch.no_grad():
                x.copy_(b[0])
            ll_s.copy_(b[1])
            gl_s.copy_(b[2])

        def body():
            loss = loss_fn(labels_, x, ll_s, gl_s, 0)
            total = torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum()
            return loss.detach(), torch.autograd.grad(total, x)[0]

        t0 = time.perf_counter()
        with DeviceTally(torch, dev) as tally, PureTally(torch, dev) as pure, \
                BodyNodes() as bodies, config_override(**cfg):
            (graph, outs), got, rows = launched(name, lambda: capture(torch, body,
                                                                      keep=True))
        return (graph, outs, load, got, rows, (tally, pure), bodies,
                time.perf_counter() - t0)

    for name, cfg in COND_CAPTURES:
        tag = f"{name} " + " ".join(f"{k}={v}" for k, v in cfg.items())
        two_way = cfg.get("repair_bucket") == 0
        eager = configured(make_step(torch, loss_function(name), labels), **cfg)
        fwd_resid, bwd = f"{name}_fwd[resid]", f"{name}_bwd_streamed"
        log_keys = tuple(f"{name}_log_{m}" for m in ("fwd[final]", "fwd[resid]", "bwd"))
        graph, (loss_s, d_s), load, got, rows, (tally, pure), bodies, capture_s = graphed(
            name, cfg, labels, logits, label_length, logit_length)
        load(batches[0])
        nodes = graph_nodes(graph) + bodies.nodes
        # the warm-up's eager step (clean: no repair), then the capture: each
        # guard's tier-2 round of repair_bucket2 rows and whole batch, or the
        # two-way guard's whole batch
        sizes = (batch,) if two_way else (bucket2, batch)
        want = {fwd_resid: 2, bwd: 2, **{k: len(sizes) for k in log_keys}}
        want_rows = Counter({(k, size): 1 for k in log_keys for size in sizes})
        check(got == want and rows == want_rows,
              f"phase 12 {tag} capture: launches {got}, log-space rows {dict(rows)}; "
              f"expected {want}, {dict(want_rows)}")
        per_guard = 1 if two_way else 3
        check(len(bodies.each) == 2 * per_guard,
              f"phase 12 {tag} capture: {len(bodies.each)} IF bodies, expected "
              f"{per_guard} in each of the two guards")
        tier1 = [] if two_way else [bodies.each[0], bodies.each[per_guard]]
        report, tallies, timing = {}, {}, {}
        for n in LADDER_N:
            b = batches[n]
            ref_loss, ref_d = eager(*b)
            load(b)
            tally.zero()
            pure.zero()
            graph.replay()
            sync()
            check(same_bits(loss_s, ref_loss) and same_bits(d_s, ref_d),
                  f"phase 12 {tag} n={n}: the replay's loss and d_logits are not the "
                  "eager step's bits")
            tier = "whole" if two_way and n else ladder_tier("cond", False, n, batch)[0]
            k = int(tier in ("gathered", "whole"))
            want_tally = {key: k for key in log_keys} if k else {}
            want_pure = ({"_pure_repair_loss": 1, "_pure_repair": 1} if tier == "pure"
                         else {})
            tallies[f"n={n}"] = dict(tier=tier, log_space=tally.read(), pure=pure.read())
            check(tallies[f"n={n}"]["log_space"] == want_tally
                  and tallies[f"n={n}"]["pure"] == want_pure,
                  f"phase 12 {tag} n={n} ({tier}): counted on the device "
                  f"{tallies[f'n={n}']}, expected {want_tally}, {want_pure}")

            def replay(_b=b):
                load(_b)
                graph.replay()

            row = {}
            for what, fn in (("eager", lambda _b=b: eager(*_b)), ("graph", replay)):
                ms = host_ms(torch, fn)
                row[what] = dict(host_ms=ms, **profile_step(torch, dev, ms, fn, steps=1))
            row["graph"]["event_ms"] = time_ms(torch, replay, runs=3, burst=5)
            timing[f"n={n}"] = row
        load(batches[top])
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        graph.replay()
        sync()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        eager(*batches[top])
        sync()
        eager_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"phase 12 {tag} captured loss and d_logits (B={batch}, T={logits.shape[1]}, "
            f"V={logits.shape[2]}, {per_guard} IF-node tiers in each guard): ok, capture "
            f"{capture_s:.2f} s, {nodes} graph nodes, the IF bodies' (nodes, capture s) "
            f"{json.dumps(bodies.each)}, tier 1's {json.dumps(tier1)}; launches in the "
            f"capture {json.dumps(got)}; every replay bit for bit the eager step; "
            f"counted on the device {json.dumps(tallies)}; peak device memory GB at "
            f"n={top}: graphed {peak:.3f}, the while graph {while_peaks[name]:.3f}, "
            f"eager {eager_peak:.3f}; the IF bodies' memory pool (every graph's so far) "
            f"{body_pool_gb(torch, dev)}; timing ({card}; host clock median of {RUNS}, one "
            f"profile each, the replay's CUDA events median of 3 bursts of 5) "
            f"{json.dumps(timing)}")
        del graph, loss_s, d_s

    # ---- the fused step at V=128 under "cond", beyond tier 2 ----------------
    cfg = dict(fused_epilogue=True, guard_struct="cond")
    v_inputs = make_inputs(torch, seed, dev, vocab=SLICE_VOCAB)
    v_labels = v_inputs[0]
    v_sat = saturate(torch, *v_inputs, rows=tuple((r, LADDER_SCALE)
                                                  for r in range(2, 2 + beyond)))
    for name in ("classic", "simplified"):
        log_keys = tuple(f"{name}_log_{m}" for m in ("fwd[final]", "fwd[resid]", "bwd"))
        eager = configured(make_step(torch, loss_function(name), v_labels), **cfg)
        ref_loss, ref_d = eager(*v_sat)
        graph, (loss_s, d_s), load, got, rows, (tally, pure), bodies, capture_s = graphed(
            name, cfg, *v_inputs)
        check(got.get("fused_dlogits") == 2 and got.get(f"{name}_bwd_streamed") == 2,
              f"phase 12 {name} fused cond capture: launches {got} (B12 in the warm-up "
              "and once in the graph)")
        load(v_sat)
        tally.zero()
        pure.zero()
        graph.replay()
        sync()
        counted = tally.read()
        check(counted == {k: 1 for k in log_keys} and not pure.read(),
              f"phase 12 {name} fused cond n={beyond}: counted on the device {counted}, "
              "expected the whole batch once")
        check(same_bits(loss_s, ref_loss) and same_bits(d_s, ref_d),
              f"phase 12 {name} fused cond n={beyond}: the replay's loss and d_logits are "
              "not the eager fused step's bits")
        log(f"phase 12 {name} fused step at V={SLICE_VOCAB} under cond captured: ok, "
            f"capture {capture_s:.2f} s; launches in the capture {json.dumps(got)}; the "
            f"n={beyond} replay reroutes the whole batch ({json.dumps(counted)} counted on "
            "the device) and is bit for bit the eager fused step")
        del graph, loss_s, d_s


LONG_JIT_FLUSHED = 20  # rows 2-21 flushed by saturate: two 16-row rounds at T=4000


def drive_jit_long_t(torch, dev, seed, sync, card, launched, launches) -> None:
    """Phase 12 (d): for each topology the long-T training step (B=256,
    T=4000, 8 chunks; loss and ``torch.autograd.grad`` to d_logits, guard
    "while") captured in one graph, its repair rounds IF nodes at full T
    through the float64 scans (``ops/pure_scan.py``), replayed on the
    seed's batch (classic: no flagged row; simplified: ``LONG_FLAGGED``)
    and on the same batch with ``LONG_JIT_FLUSHED`` rows flushed by
    ``saturate``.  Checks: the capture's launches (the warm-up's eager step
    and the capture's kernels, a float64 alpha a forward round and an
    alpha and a beta a backward round); rows that differ from the eager
    step are rows the guard repairs, within 1e-5 of the float64 pure path
    (loss rtol, d_logits atol, as phase 7) and of the eager step within
    1e-6 where the eager step repaired them in float64 too, within phase
    4's 2e-4 where it took the float32 log-space kernels; the float64 scans
    that the replays ran, counted on the device (``ScanTally``), a round
    for every ``round_rows`` flushed rows, and no log-space launch
    (``DeviceTally``).  Prints the capture's seconds and nodes, each IF
    body's nodes, the replays' and the eager steps' host ms and CUDA-event
    ms, and each replay's peak memory."""
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
    from tf_seq2seq_losses_tpu_torch.ops import topology as topo_mod
    from tf_seq2seq_losses_tpu_torch.utils.config import get_config
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    t0_d = time.perf_counter()
    inputs = make_inputs(torch, seed, dev, max_t=LONG_T, infeasible=False)
    labels, logits, label_length, logit_length = inputs
    batch, lp1 = len(labels), labels.shape[1] + 1
    cfg = get_config()
    plan = topo_mod._tier_plan(batch, LONG_T, lp1, cfg.repair_bucket, cfg.repair_bucket2,
                               cfg.log_fallback, cfg.guard_struct)
    round_rows = plan[-1]
    rounds = -(-batch // round_rows)
    sat = tuple(range(2, 2 + LONG_JIT_FLUSHED))
    batches = {"seed": (logits, label_length, logit_length),
               f"{len(sat)} flushed": saturate(torch, *inputs,
                                               rows=tuple((r, LADDER_SCALE) for r in sat))}
    n_chunks = cl.chunk_plan(core.make_context(labels, logit_to_logproba(logits, 2),
                                               label_length, logit_length, 0))[0]
    for name in ("classic", "simplified"):
        loss_fn = loss_function(name)
        eager = make_step(torch, loss_fn, labels)
        alpha64, beta64 = f"{name}_alpha64", f"{name}_beta64"
        # the rows each batch's guards repair: the forward's flushed rows,
        # the backward's (the forward's and those whose scans disagree)
        flushed = {key: (list(sat) if key != "seed" else [],
                         scan_gaps(torch, name, labels, *b)["flagged"])
                   for key, b in batches.items()}
        eager_out = {key: eager(*b) for key, b in batches.items()}
        # the float64 scans of the capture's warm-up, the eager step, and
        # its peak memory beside the replays'
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        eager(*batches["seed"])
        sync()
        eager_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        warm = read_launches("pure64")
        x = logits.clone().requires_grad_(True)
        ll_s, gl_s = label_length.clone(), logit_length.clone()

        def load(b, _x=x, _ll=ll_s, _gl=gl_s):
            with torch.no_grad():
                _x.copy_(b[0])
            _ll.copy_(b[1])
            _gl.copy_(b[2])

        def body(_fn=loss_fn, _x=x, _ll=ll_s, _gl=gl_s):
            loss = _fn(labels, _x, _ll, _gl, 0)
            total = torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum()
            return loss.detach(), torch.autograd.grad(total, _x)[0]

        load(batches["seed"])
        t0 = time.perf_counter()
        with DeviceTally(torch, dev) as tally, ScanTally(torch, dev) as scans, \
                BodyNodes() as bodies:
            (graph, (loss_s, d_s)), got, rows = launched(
                name, lambda: capture(torch, body, keep=True))
            got_pure = {k: n for k, n in read_launches("pure64").items() if n}
        capture_s = time.perf_counter() - t0
        launches.update(got_pure)
        nodes = graph_nodes(graph) + bodies.nodes
        per_step = {f"{name}_fwd[final]": n_chunks, f"{name}_fwd[bound]": n_chunks,
                    f"{name}_bwd": n_chunks}
        check(got == {k: 2 * n for k, n in per_step.items()} and not rows,
              f"phase 12 (d) {name} capture: launches {got}, log-space rows {dict(rows)}; "
              f"expected twice {per_step}")
        want_pure = {alpha64: warm[alpha64] + 2 * rounds, beta64: warm[beta64] + rounds}
        check(got_pure == want_pure and len(bodies.each) == 2 * rounds,
              f"phase 12 (d) {name} capture: float64 scan launches {got_pure}, expected "
              f"{want_pure}; {len(bodies.each)} IF bodies, expected {2 * rounds}")
        out = {"capture_s": capture_s, "graph_nodes": nodes,
               "eager peak GB": eager_peak,
               "forward round nodes": bodies.each[0][0],
               "backward round nodes": bodies.each[rounds][0],
               "bodies' capture s": sum(b[1] for b in bodies.each)}
        for key, b in batches.items():
            fwd_rows, bwd_rows = flushed[key]
            load(b)
            tally.zero()
            scans.zero()
            torch.cuda.reset_peak_memory_stats(dev)
            graph.replay()
            sync()
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            counted, counted_log = scans.read(), tally.read()
            f_r, b_r = -(-len(fwd_rows) // round_rows), -(-len(bwd_rows) // round_rows)
            want = {k: n for k, n in ((alpha64, f_r + b_r), (beta64, b_r)) if n}
            check(counted == want and not counted_log,
                  f"phase 12 (d) {name} {key}: counted on the device {counted} and "
                  f"log-space {counted_log}; expected {want} and none")
            e_loss, e_d = eager_out[key]
            same_row = (loss_s == e_loss) & (d_s == e_d).flatten(1).all(1)
            differ = torch.nonzero(~same_row)[:, 0].tolist()
            repaired = sorted(set(fwd_rows) | set(bwd_rows))
            check(set(differ) <= set(repaired),
                  f"phase 12 (d) {name} {key}: rows {differ} not the eager step's bits, "
                  f"repaired rows {repaired}")
            errs = {}
            if repaired:
                idx = torch.tensor(repaired, device=dev)
                t_cut = int(b[2][idx].max())
                sub = (labels[idx], b[0][idx, :t_cut], b[1][idx], b[2][idx])
                loss64, d64 = pure_float64(*sub, name)
                agree(loss_s[idx], loss64, 1e-5, 0.0,
                      f"phase 12 (d) {name} {key}: repaired rows' loss vs float64")
                agree(d_s[idx, :t_cut], d64, 0.0, 1e-5,
                      f"phase 12 (d) {name} {key}: repaired rows' d_logits vs float64")
                # the eager step repairs the flushed rows on their own 12
                # steps, through the float32 log-space kernels where they
                # hold the lanes (B8 and B9 do, B5 does not), the others in
                # float64 too
                log_rows = fwd_rows if fwd_rows and ll.fits_log_fallback(
                    topo_mod.take_ctx(core.make_context(
                        labels, logit_to_logproba(b[0], 2), b[1], b[2], 0),
                        torch.tensor(fwd_rows, device=dev)), name) else []
                for rows_, tol in ((sorted(set(repaired) - set(log_rows)), 1e-6),
                                   (log_rows, FLUSHED_ATOL)):
                    if not rows_:
                        continue
                    r_idx = torch.tensor(rows_, device=dev)
                    agree(loss_s[r_idx], e_loss[r_idx], tol, 0.0,
                          f"phase 12 (d) {name} {key}: rows {rows_} loss vs eager")
                    agree(d_s[r_idx], e_d[r_idx], 0.0, tol,
                          f"phase 12 (d) {name} {key}: rows {rows_} d_logits vs eager")
                errs = {"loss vs float64": max_err(loss_s[idx], loss64),
                        "d_logits vs float64": max_err(d_s[idx, :t_cut], d64),
                        "loss vs eager": max_err(loss_s[idx], e_loss[idx]),
                        "d_logits vs eager": max_err(d_s[idx], e_d[idx]),
                        "rows the eager step took through the log-space kernels":
                            len(log_rows)}

            def replay(_b=b):
                load(_b)
                graph.replay()

            def eager_step(_b=b):
                eager(*_b)

            out[key] = {
                "repaired rows": len(repaired), "rows not bit for bit": len(differ),
                "counted": counted, "peak GB": peak, **errs,
                "graphed host ms": host_ms(torch, replay, runs=LONG_RUNS),
                "eager host ms": host_ms(torch, eager_step, runs=LONG_RUNS),
                "graphed CUDA-event ms": time_ms(torch, replay, runs=LONG_RUNS, burst=1),
                "eager CUDA-event ms": time_ms(torch, eager_step, runs=LONG_RUNS,
                                               burst=1)}
        log(f"phase 12 (d) {name} long T (B={batch}, T={LONG_T}, labels "
            f"{list(labels.shape)}, {n_chunks} chunks) captured: ok, replays on the seed "
            f"batch and with rows {sat[0]}-{sat[-1]} flushed; {rounds} rounds of "
            f"{round_rows} rows a guard (one round at T={LONG_T} took 564214 nodes "
            f"through the pure path's loop); launches at the capture "
            f"{json.dumps({**got, **got_pure})}; ({card}; host ms median of "
            f"{LONG_RUNS}, CUDA events around single calls; peak GB of each replay "
            f"beside the eager step's) {json.dumps(out)}; the IF "
            f"bodies' memory pool GB {body_pool_gb(torch, dev)}")
        del graph, loss_s, d_s, x, eager_out
    log(f"phase 12 (d): {time.perf_counter() - t0_d:.1f} s")


def drive_jit(torch, dev, seed, sync, card) -> dict:
    """Phase 12, the port's counterparts of the JAX package's three
    ``jax.jit`` entry points, as CUDA graphs (the guard's "while" struct on
    the device, each repair round an IF node): (a) for each topology the
    loss and ``torch.autograd.grad`` to d_logits at the headline captured
    in one graph and replayed on phase 10's batches (n in ``LADDER_N`` rows
    flushed), each replay bit for bit the eager step (the host form), the
    kernels of the n=0 and n=40 replays, times; (a') the same under
    ``guard_struct="cond"`` and ``repair_bucket=0`` (``drive_jit_cond``); (b) ``make_train_step`` on
    the encoder at phase 9's full width, ``JIT_RUNS`` graphed steps against
    the eager body (``train_step_eager``) from the same parameters, on one
    NCCL rank; (c) the graphed ``sharded_mean_ctc_loss`` against its eager
    function, loss and d_logits bit for bit, each call's held after the
    next, two forwards before one backward, and a ``no_grad`` call, and on
    the clean classic long-T batch, whose capture holds the guards' rounds
    at T=4000; (d) each topology's long-T step captured and replayed
    (``drive_jit_long_t``).  The launch counts of each capture are set to
    0 just before it and read just after (a replay counts none).  Returns
    the launches."""
    import os
    import tempfile
    from collections import Counter

    import torch.distributed as dist

    from tf_seq2seq_losses_tpu_torch.models import encoder as enc
    from tf_seq2seq_losses_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        make_train_step,
        sharded_mean_ctc_loss,
        train_step_eager,
    )
    from tf_seq2seq_losses_tpu_torch.utils.config import get_config

    t_phase = time.perf_counter()
    launches = Counter()

    def launched(topology, fn):
        """``fn()`` and the launches it made (counts reset first), with the
        rows of its log-space launches."""
        reset_launches()
        with LogRows() as rows:
            out = fn()
            sync()
        got = {k: n for k, n in read_launches(topology).items() if n}
        launches.update(got)
        return out, got, Counter(rows)

    inputs = make_inputs(torch, seed, dev)
    labels, logits, label_length, logit_length = inputs
    batch = len(labels)
    cfg = get_config()
    rb = max(min(cfg.repair_bucket2, batch), min(cfg.repair_bucket, batch))
    rounds = -(-batch // rb)
    batches = {n: saturate(torch, *inputs, rows=tuple((r, LADDER_SCALE)
                                                      for r in range(2, 2 + n)))
               for n in LADDER_N}
    row_ids = torch.arange(batch, device=dev)
    while_peaks = {}

    # ---- (a) the loss and its d_logits at the headline, captured ----------
    for name in ("classic", "simplified"):
        loss_fn = loss_function(name)
        eager = make_step(torch, loss_fn, labels)
        x = logits.clone().requires_grad_(True)
        ll_s, gl_s = label_length.clone(), logit_length.clone()

        def load(b, _x=x, _ll=ll_s, _gl=gl_s):
            with torch.no_grad():
                _x.copy_(b[0])
            _ll.copy_(b[1])
            _gl.copy_(b[2])

        def body(_fn=loss_fn, _x=x, _ll=ll_s, _gl=gl_s):
            loss = _fn(labels, _x, _ll, _gl, 0)
            total = torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum()
            return loss.detach(), torch.autograd.grad(total, _x)[0]

        load(batches[0])
        t0 = time.perf_counter()
        with DeviceTally(torch, dev) as tally, BodyNodes() as bodies:
            (graph, (loss_s, d_s)), got, rows = launched(
                name, lambda: capture(torch, body, keep=True))
        capture_s = time.perf_counter() - t0
        nodes = graph_nodes(graph) + bodies.nodes
        fwd_resid, bwd = f"{name}_fwd[resid]", f"{name}_bwd_streamed"
        log_final, log_resid, log_bwd = (f"{name}_log_{m}" for m in
                                         ("fwd[final]", "fwd[resid]", "bwd"))
        # the warm-up's eager step, then the capture: the rounds of both guards
        want = {fwd_resid: 2, bwd: 2, log_final: rounds, log_resid: rounds,
                log_bwd: rounds}
        check(got == want and set(rows) == {(k, rb) for k in (log_final, log_resid,
                                                              log_bwd)},
              f"phase 12 {name} capture: launches {got}, log-space rows {dict(rows)}; "
              f"expected {want} in rounds of {rb}")
        eager_out = {n: eager(*batches[n]) for n in LADDER_N}

        def held(n, what):
            """The replay's loss and d_logits against the eager step's on
            batch ``n``: bit for bit, or a flushed row within 2e-4 of
            float64; the count of rows that differ."""
            ref_loss, ref_d = eager_out[n]
            diff = (ref_loss != loss_s) | (ref_d != d_s).flatten(1).any(dim=1)
            diff &= ~(torch.isnan(ref_loss) & torch.isnan(loss_s))
            if bool(diff.any()):
                sat = (row_ids >= 2) & (row_ids < 2 + n)
                check(bool((diff <= sat).all()),
                      f"phase 12 {name} n={n} {what}: clean rows "
                      f"{row_ids[diff & ~sat].tolist()} differ from the eager step")
                l64, d64 = pure_float64(labels, *batches[n], name)
                agree(loss_s[diff], l64[diff], 0.0, FLUSHED_ATOL,
                      f"phase 12 {name} n={n} {what}: differing rows' loss vs float64")
                agree(d_s[diff], d64[diff], 0.0, FLUSHED_ATOL,
                      f"phase 12 {name} n={n} {what}: differing rows' d_logits vs float64")
            return int(diff.sum())

        # each replay: its outputs and the launches of its rounds, counted on
        # the device, one round of each kernel and mode in each guard
        report, tallies = {}, {}
        for n in LADDER_N:
            load(batches[n])
            tally.zero()
            graph.replay()
            sync()
            report[f"n={n}"] = held(n, "replay")
            tallies[f"n={n}"] = tally.read()
            k = len(ladder_tier("while", False, n, batch)[1])
            want_tally = {key: k for key in (log_final, log_resid, log_bwd)} if k else {}
            check(tallies[f"n={n}"] == want_tally,
                  f"phase 12 {name} n={n}: the replay's rounds counted on the device "
                  f"{tallies[f'n={n}']}, expected {want_tally}")
        replays = {n: (lambda _b=batches[n]: (load(_b), graph.replay()))
                   for n in JIT_PROFILED_N}
        counts = {}
        for n, fn in replays.items():
            tally.zero()
            counts[n] = log_kernel_counts(kernel_counts(torch, fn), name)
            tallies[f"profiled n={n}"] = tally.read()
            held(n, "profiled replay")
        n_top = JIT_PROFILED_N[-1]
        k = -(-n_top // rb)
        check(counts[0] == {}, f"phase 12 {name} clean replay ran {counts[0]}")
        check(tallies[f"profiled n={n_top}"] == tallies[f"n={n_top}"],
              f"phase 12 {name} profiled n={n_top} replay: rounds counted on the device "
              f"{tallies[f'profiled n={n_top}']}")
        # the backward's k rounds; the forward's k rounds of the final mode,
        # counted exactly on the device above, of which a profile inside the
        # whole smoke has shown one only
        fwd_log, bwd_log = LOG_KERNELS[name]
        got_top = counts[n_top]
        check(got_top.get(f"{fwd_log}[resid]") == k and got_top.get(bwd_log) == k
              and 1 <= got_top.get(f"{fwd_log}[final]", 0) <= k
              and set(got_top) <= {f"{fwd_log}[final]", f"{fwd_log}[resid]", bwd_log},
              f"phase 12 {name} n={n_top} replay ran {got_top}, expected {k} rounds")
        timing = {}
        for n in JIT_PROFILED_N:
            b = batches[n]
            for tag, fn in (("eager", lambda _b=b: eager(*_b)), ("graph", replays[n])):
                ms = host_ms(torch, fn)
                timing[f"{tag} n={n}"] = dict(host_ms=ms, **profile_step(
                    torch, dev, ms, fn, steps=1))
        load(batches[max(LADDER_N)])
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        graph.replay()
        sync()
        while_peaks[name] = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"phase 12 {name} captured loss and d_logits (B={batch}, T={logits.shape[1]}, "
            f"V={logits.shape[2]}, {rounds} IF-node rounds of {rb} rows in each guard): "
            f"ok, capture {capture_s:.2f} s, {nodes} graph nodes; launches in the capture "
            f"{json.dumps(got)}; rows that differ from the eager step's bits "
            f"{json.dumps(report)}; log-space launches of the replays counted on the "
            f"device {json.dumps(tallies)}; log-space kernels of the profiled replays "
            f"{json.dumps({f'n={n}': c for n, c in counts.items()})}; peak device memory "
            f"GB of the n={max(LADDER_N)} replay {while_peaks[name]:.3f}; timing ({card}; "
            f"host clock median of {RUNS}, one profile each) {json.dumps(timing)}")
        del graph, loss_s, d_s, x

    # ---- (a') the "cond" struct and the two-way guard, captured -------------
    drive_jit_cond(torch, dev, seed, sync, card, launched, inputs, batches, while_peaks)

    # ---- (b) and (c): one NCCL rank --------------------------------------------
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    tmp = tempfile.TemporaryDirectory()
    init_distributed(f"file://{tmp.name}/rendezvous", 1, 0, device=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        data_group = mesh.group("data")
        e_batch = encoder_batch(torch, seed, dev)
        params = enc.init_encoder(torch.Generator().manual_seed(seed), ENC_FEATURES,
                                  ENC_HIDDEN, ENC_VOCAB, ENC_LAYERS, device=dev)
        init_state, shard, graphed_step = make_train_step(mesh)
        local = shard(e_batch)
        g_state, e_state = init_state(params), init_state(params)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        (_, first), got, _ = launched("classic", lambda: graphed_step(g_state, local))
        first_s = time.perf_counter() - t0
        graphed_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        check(got.get("classic_fwd[resid]") == 2 and got.get("classic_bwd_streamed") == 2,
              f"phase 12 encoder capture (warm-up and capture) launched {got}")
        g_losses = [first] + [graphed_step(g_state, local)[1] for _ in range(JIT_RUNS - 1)]
        g_grads = param_grads(g_state.params)
        torch.cuda.reset_peak_memory_stats(dev)
        e_losses = [train_step_eager(e_state, local, "classic", 0, data_group)[1]
                    for _ in range(JIT_RUNS)]
        eager_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        e_grads = param_grads(e_state.params)
        check(torch.equal(g_losses[0], e_losses[0]),
              f"phase 12 encoder step 1: graphed {float(g_losses[0])} vs eager "
              f"{float(e_losses[0])}")
        rel = [abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(g_losses, e_losses)]
        check(max(rel) <= 1e-5, f"phase 12 encoder losses graphed vs eager rel err {rel}")
        shares = {k: max_err(g, e_grads[k]) / float(e_grads[k].abs().max())
                  for k, g in g_grads.items()}
        worst = max(shares, key=shares.get)
        check(shares[worst] <= ENC_GRAD_SHARE,
              f"phase 12 encoder step {JIT_RUNS} gradient of {worst}: {shares[worst]:.3g} "
              "of its largest entry from the eager step's")
        steps = {"graphed": lambda: graphed_step(g_state, local),
                 "eager": lambda: train_step_eager(e_state, local, "classic", 0,
                                                   data_group)}
        timing = {}
        for tag, fn in steps.items():
            ms = host_ms(torch, fn, runs=JIT_RUNS)
            timing[tag] = dict(host_ms=ms, **profile_step(torch, dev, ms, fn, steps=1))
        log(f"phase 12 encoder make_train_step (B={batch}, T={MAX_T}, V={ENC_VOCAB}, "
            f"H={ENC_HIDDEN}, {ENC_LAYERS} layers, one NCCL rank): ok, first call "
            f"(warm-up, capture, replay) {first_s:.2f} s, launches {json.dumps(got)}; "
            f"losses graphed {[float(v) for v in g_losses]}, eager "
            f"{[float(v) for v in e_losses]} (step 1 bit for bit, rel err {rel}); "
            f"step {JIT_RUNS} gradients' largest share of a tensor's largest entry "
            f"{shares[worst]:.3g} ({worst}); peak device memory GB graphed {graphed_peak:.3f}"
            f" (its graph pool included), eager {eager_peak:.3f}; timing ({card}; host "
            f"clock median of {JIT_RUNS}, one profile each) {json.dumps(timing)}")
        del g_state, e_state, params, local, e_batch

        # ---- (c) the graphed sharded_mean_ctc_loss, on feasible rows ----
        mean_fn = sharded_mean_ctc_loss(mesh)
        f_inputs = make_inputs(torch, seed, dev, infeasible=False)
        c_batches = {n: saturate(torch, *f_inputs, rows=tuple((r, LADDER_SCALE)
                                                              for r in range(2, 2 + n)))
                     for n in (0, JIT_PROFILED_N[-1])}

        def mean_and_grad(fn, ns):
            """``fn``'s mean on each batch of ``ns`` and, by one backward of
            their sum, each one's d_logits; the launches of the calls."""
            xs = {n: c_batches[n][0].clone().requires_grad_(True) for n in ns}

            def run():
                means = {n: fn(f_inputs[0], xs[n], *c_batches[n][1:]) for n in ns}
                sum(means.values()).backward()
                return {n: m.detach() for n, m in means.items()}

            means, got, _ = launched("classic", run)
            return {n: (means[n], xs[n].grad) for n in ns}, got

        want = {n: mean_and_grad(mean_fn.eager, (n,))[0][n] for n in c_batches}
        report = {}
        # a call and its backward, then another on another batch: the first
        # call's loss and gradient are held after the second
        kept = {}
        for n in c_batches:
            out, got = mean_and_grad(mean_fn, (n,))
            kept.update(out)
            report[f"n={n} launches"] = got
        # two forwards, one backward (gradient accumulation), then no_grad
        accumulated, got = mean_and_grad(mean_fn, tuple(c_batches))
        report["accumulated launches"] = got
        with torch.no_grad():
            (no_grad, _), got, _ = launched("classic", lambda: (mean_fn(
                f_inputs[0], c_batches[0][0], *c_batches[0][1:]), None))
        report["no_grad launches"] = got
        for n, (mean, grad) in want.items():
            check(math.isfinite(float(mean)), f"phase 12 sharded_mean_ctc_loss n={n}: "
                  f"mean {float(mean)}")
            for what, (g_mean, g_grad) in (("call", kept[n]),
                                           ("accumulated", accumulated[n])):
                check(torch.equal(g_mean, mean) and torch.equal(g_grad, grad),
                      f"phase 12 sharded_mean_ctc_loss n={n} {what}: graphed vs eager "
                      "loss and d_logits bit for bit")
            report[f"n={n}"] = float(mean)
        check(torch.equal(no_grad, want[0][0]),
              f"phase 12 sharded_mean_ctc_loss no_grad: {float(no_grad)} vs eager "
              f"{float(want[0][0])}")
        # the clean classic long-T batch (8 chunks): the graphs hold each
        # guard's rounds at T=4000 through the float64 scans
        l_inputs = make_inputs(torch, seed, dev, max_t=LONG_T, infeasible=False)

        def long_mean(fn):
            x = l_inputs[1].clone().requires_grad_(True)

            def run():
                mean = fn(l_inputs[0], x, *l_inputs[2:])
                mean.backward()
                return mean.detach()

            mean, got, _ = launched("classic", run)
            got_pure = {k: n for k, n in read_launches("pure64").items() if n}
            launches.update(got_pure)
            return mean, x.grad, {**got, **got_pure}

        t0 = time.perf_counter()
        e_mean, e_grad, _ = long_mean(mean_fn.eager)
        g_mean, g_grad, got = long_mean(mean_fn)
        long_s = time.perf_counter() - t0
        # the mean is +inf where a row is infeasible (classic row 220 at
        # seed 0); its d_logits stay finite, the infeasible rows' zero
        check(torch.equal(g_mean, e_mean) and torch.equal(g_grad, e_grad)
              and bool(torch.isfinite(e_grad).all()),
              f"phase 12 sharded_mean_ctc_loss long T: graphed {float(g_mean)} vs eager "
              f"{float(e_mean)}, loss and d_logits bit for bit, d_logits finite")
        report[f"long T (B={len(l_inputs[0])}, T={LONG_T}) launches"] = got
        report["long T eager call and graphed capture s"] = long_s
        del l_inputs, e_grad, g_grad
        log(f"phase 12 sharded_mean_ctc_loss (make_graphed_callables, one NCCL rank): ok, "
            f"loss and d_logits bit for bit the eager function's, each call's held after "
            f"the next, two forwards and one backward (a second slot), a no_grad "
            f"call, and the clean classic long-T batch {json.dumps(report)}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        tmp.cleanup()

    # ---- (d) the long-T step, captured -----------------------------------------
    drive_jit_long_t(torch, dev, seed, sync, card, launched, launches)
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# ---- phase 13: the loss under torch.compile ------------------------------------

COMPILE_N = (0, 1, 40)  # phase 10's ladder points: clean, tier 1, beyond tier 2
# the guard's configs of (b): the "while" struct (the default), "cond", and
# the two-way guard (repair_bucket 0)
COMPILE_CONFIGS = (("while", {}), ("cond", {"guard_struct": "cond"}),
                   ("two_way", {"repair_bucket": 0}))
COMPILE_ENC_RTOL = 1e-3  # the compiled encoder's step-1 loss against the eager step's
# (d)'s backend: inductor's code generation for the chunked long-T step
# takes over ten minutes on the card (tools/compile_long_t.py), past the
# smoke's budget, so (d) compiles with AOTAutograd and runs its graphs
# eagerly: the same trace, custom ops and guard, bit for bit the eager step
LONG_T_BACKEND = "aot_eager"


def unique_graphs() -> int:
    """The graphs Dynamo has compiled in this process."""
    from torch._dynamo.utils import counters

    return counters["stats"]["unique_graphs"]


def compile_fn(torch, fn):
    """``fn`` under ``torch.compile`` as phase 13 takes it: inductor's
    default mode, ``fullgraph=True`` (a graph break raises), static
    shapes."""
    return torch.compile(fn, fullgraph=True, dynamic=False)


def loss_and_total(loss_fn, labels):
    """``f(x, label_length, logit_length) -> (loss, finite sum)``: what a
    compiled training step computes; ``.backward()`` of the sum runs
    outside, through the compiled backward."""
    import torch

    def f(x, label_length, logit_length):
        loss = loss_fn(labels, x, label_length, logit_length, 0)
        return loss, torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss)).sum()

    return f


def run_step(f, logits, label_length, logit_length):
    """``(loss, d_logits)`` of a training step of ``f`` (:func:`loss_and_total`)."""
    x = logits.detach().requires_grad_(True)
    loss, total = f(x, label_length, logit_length)
    total.backward()
    return loss.detach(), x.grad


def drive_compile(torch, dev, seed, sync, card) -> dict:
    """Phase 13, the loss under ``torch.compile(fullgraph=True,
    dynamic=False)`` (inductor), the kernels ``ctc_port::`` custom ops of
    its graph and the guard's rounds ``torch.cond``: (a) each topology's
    training step and forward-only call at the headline; (b) the classic
    step on phase 10's batches (n of ``COMPILE_N`` rows flushed) under each
    of ``COMPILE_CONFIGS``, one graph for every n; (c) the classic fused
    step at V=128 (B12); (d) the classic long-T step (B=256, T=4000, 8
    chunks), with ``LONG_T_BACKEND``; (e) the flagship encoder's forward and finite-mean loss
    compiled with its backward, 5 Adam steps (the optimizer eager).  The
    launches of each compiled call are read after it, from counts set to 0
    just before (the kernels' custom ops count where they launch, at run
    time), and equal the eager call's.  Each case prints its host ms
    (median of 20, of 3 at long T and for a call over a quarter second),
    device ms and idle share (one profile of 3 calls), compile seconds (the
    first call's, inductor's cache in a new directory) and graph count.
    Returns the launches."""
    import os
    import tempfile
    from collections import Counter

    import tf_seq2seq_losses_tpu_torch as ctc
    from tf_seq2seq_losses_tpu_torch.models import encoder as enc
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    t_phase = time.perf_counter()
    cache = tempfile.TemporaryDirectory()
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache.name  # compile seconds are cold
    launches = Counter()

    def launched(topology, fn):
        """``fn()`` and the launches it made (counts reset first)."""
        reset_launches()
        out = fn()
        sync()
        got = {k: n for k, n in read_launches(topology).items() if n}
        launches.update(got)
        return out, got

    def first_call(topology, fn):
        """The first call of a compiled ``fn``: ``(out, launches, compile
        seconds, graphs compiled)``."""
        g0, t0 = unique_graphs(), time.perf_counter()
        out, got = launched(topology, fn)
        seconds = time.perf_counter() - t0
        log(f"phase 13: a first call {seconds:.1f} s, {unique_graphs() - g0} graphs")
        return out, got, seconds, unique_graphs() - g0

    def timing(fn, runs=RUNS):
        """Host ms (median of ``runs``; of ``LONG_RUNS`` for a call over a
        quarter second, as at long T), device ms and idle share (a profile
        of 3 calls; of 1 for a call over a quarter second: the profiler
        takes tens of seconds a call of tier 1's float64 pure path, whose
        loop launches some 10^5 kernels)."""
        t0 = time.perf_counter()
        fn()
        sync()
        steps = 3
        if time.perf_counter() - t0 > 0.25:
            runs, steps = min(runs, LONG_RUNS), 1
        ms = host_ms(torch, fn, runs=runs)
        return dict(host_ms=ms, runs=runs, **profile_step(torch, dev, ms, fn, steps=steps))

    report = {}
    inputs = make_inputs(torch, seed, dev)
    labels, logits, label_length, logit_length = inputs
    batch = len(labels)
    row_ids = torch.arange(batch, device=dev)
    ctx = core.make_context(labels, logit_to_logproba(logits, 2), label_length,
                            logit_length, 0)

    # ---- (a) the headline training step and forward-only call ----------------
    steps = {}
    for name in ("classic", "simplified"):
        t_case = time.perf_counter()
        loss_fn = loss_function(name)
        f = loss_and_total(loss_fn, labels)
        cstep = compile_fn(torch, f)
        steps[name] = (f, cstep)
        (loss_c, d_c), got_c, compile_s, graphs = first_call(
            name, lambda: run_step(cstep, *inputs[1:]))
        check(graphs == 1, f"phase 13 {name} step compiled {graphs} graphs")
        (loss_c, d_c), got_c = launched(name, lambda: run_step(cstep, *inputs[1:]))
        (loss_e, d_e), got_e = launched(name, lambda: run_step(f, *inputs[1:]))
        check(got_c == got_e == {f"{name}_fwd[resid]": 1, f"{name}_bwd_streamed": 1},
              f"phase 13 {name} step launches: compiled {got_c}, eager {got_e}")
        feasible = TOPOLOGIES[name].feasible(ctx)
        check(bool(torch.isposinf(loss_c[~feasible]).all())
              and bool((d_c[~feasible] == 0).all()),
              f"phase 13 {name}: infeasible rows +inf with zero d_logits")
        loss64, d64 = pure_float64(labels, logits, label_length, logit_length, name)
        agree(loss_c, loss64, 1e-5, 0.0, f"phase 13 {name} compiled loss vs float64")
        agree(d_c, d64, 0.0, 1e-5, f"phase 13 {name} compiled d_logits vs float64")
        fwd_c = compile_fn(torch, loss_fn)
        with torch.no_grad():
            eval_c, got_fc, eval_s, eval_graphs = first_call(
                name, lambda: fwd_c(labels, logits, label_length, logit_length, 0))
            eval_c, got_fc = launched(
                name, lambda: fwd_c(labels, logits, label_length, logit_length, 0))
            eval_e, got_fe = launched(
                name, lambda: loss_fn(labels, logits, label_length, logit_length, 0))
        check(eval_graphs == 1 and got_fc == got_fe == {f"{name}_fwd[final]": 1},
              f"phase 13 {name} forward-only: {eval_graphs} graphs, launches compiled "
              f"{got_fc}, eager {got_fe}")
        agree(eval_c, loss64, 1e-5, 0.0, f"phase 13 {name} compiled forward-only loss")

        def eval_call(_fn):
            with torch.no_grad():
                return _fn(labels, logits, label_length, logit_length, 0)

        report[f"(a) {name}"] = {
            "compile_s": {"step": compile_s, "forward_only": eval_s},
            "graphs": {"step": graphs, "forward_only": eval_graphs},
            "launches_per_step": got_c,
            "vs_float64": {"loss": max_err(loss_c, loss64), "d_logits": max_err(d_c, d64)},
            "vs_eager": {"loss": max_err(loss_c, loss_e), "d_logits": max_err(d_c, d_e),
                         "forward_only": max_err(eval_c, eval_e)},
            "step": {"compiled": timing(lambda: run_step(cstep, *inputs[1:])),
                     "eager": timing(lambda: run_step(f, *inputs[1:]))},
            "forward_only": {"compiled": timing(lambda: eval_call(fwd_c)),
                             "eager": timing(lambda: eval_call(loss_fn))}}
        report[f"(a) {name}"]["case_s"] = time.perf_counter() - t_case
        log(f"phase 13 (a) {name} compiled step and forward-only call ({card}; B={batch}, "
            f"T={logits.shape[1]}, V={logits.shape[2]}): ok, "
            + json.dumps(report[f"(a) {name}"]))

    # ---- (b) the guard on phase 10's batches, one graph a config -------------
    batches = {n: saturate(torch, *inputs, rows=tuple((r, LADDER_SCALE)
                                                      for r in range(2, 2 + n)))
               for n in COMPILE_N}
    f, _ = steps["classic"]
    f64 = {}  # batch n's float64 pure loss and d_logits
    for tag, cfg in COMPILE_CONFIGS:
        t_case = time.perf_counter()
        with config_override(**cfg):
            # the default config reuses (a)'s step: its graph serves every n
            cstep = steps["classic"][1] if not cfg else compile_fn(torch, f)
            g0 = unique_graphs()
            compile_s = None
            per_n, clean = {}, None
            for n in COMPILE_N:
                b = batches[n]
                t0 = time.perf_counter()
                (loss_c, d_c), got_c = launched("classic", lambda: run_step(cstep, *b))
                if compile_s is None:
                    compile_s = time.perf_counter() - t0
                    log(f"phase 13 (b) {tag}: first call {compile_s:.1f} s")
                    (loss_c, d_c), got_c = launched("classic",
                                                    lambda: run_step(cstep, *b))
                (loss_e, d_e), got_e = launched("classic", lambda: run_step(f, *b))
                tier = ladder_tier(cfg.get("guard_struct", "while"), False, n, batch)[0]
                if n and cfg.get("repair_bucket") == 0:
                    tier = "whole"
                repairs = {k: v for k, v in got_c.items() if "_log_" in k}
                check(got_c == got_e and bool(repairs) == (tier not in ("clean", "pure")),
                      f"phase 13 (b) {tag} n={n} ({tier}): launches compiled {got_c}, "
                      f"eager {got_e}")
                # phase 10's tolerances: rows of the fast path within phase
                # 3's 1e-5 of the eager step's (held to the kernels and to
                # float64 in phases 3 and 10) and the clean compiled step's
                # bits; rows through the float32 log-space route, whose
                # error grows with the row (1.5e-3 to 2.6e-3 from float64
                # in d_logits at T=500, phase 10) and amplifies the ulps by
                # which inductor's glue moves its inputs: the loss rtol 1e-5
                # of the eager step's, a repaired row within the route's
                # 2e-4 of float64, the rerouted batch's d_logits no farther
                # from float64 than the eager step's, give or take 2e-4
                sat = (row_ids >= 2) & (row_ids < 2 + n)
                fast = ~sat if tier != "whole" else torch.zeros_like(sat)
                agree(loss_c[fast], loss_e[fast], 1e-5, 0.0,
                      f"phase 13 (b) {tag} n={n}: fast rows' loss vs eager")
                agree(d_c[fast], d_e[fast], 0.0, 1e-5,
                      f"phase 13 (b) {tag} n={n}: fast rows' d_logits vs eager")
                agree(loss_c[~fast], loss_e[~fast], 1e-5, 0.0,
                      f"phase 13 (b) {tag} n={n}: rerouted rows' loss vs eager")
                if n:
                    if n not in f64:
                        f64[n] = pure_float64(labels, *b, "classic")
                    l64, d64 = f64[n]
                    agree(loss_c[sat], l64[sat], 0.0, FLUSHED_ATOL,
                          f"phase 13 (b) {tag} n={n}: repaired rows' loss vs float64")
                    agree(d_c[sat], d64[sat], 0.0, FLUSHED_ATOL,
                          f"phase 13 (b) {tag} n={n}: repaired rows' d_logits vs float64")
                if n == 0:
                    clean = (loss_c, d_c)
                elif tier == "whole":
                    agree(loss_c, l64, 1e-5, 0.0,
                          f"phase 13 (b) {tag} n={n}: the rerouted batch's loss vs float64")
                    err_c, err_e = max_err(d_c, d64), max_err(d_e, d64)
                    check(err_c <= err_e + FLUSHED_ATOL,
                          f"phase 13 (b) {tag} n={n}: the rerouted batch's d_logits "
                          f"{err_c:.3g} from float64, the eager step's {err_e:.3g}")
                else:
                    check(torch.equal(loss_c[~sat], clean[0][~sat])
                          and torch.equal(d_c[~sat], clean[1][~sat]),
                          f"phase 13 (b) {tag} n={n}: clean rows not the clean step's bits")
                per_n[f"n={n}"] = {
                    "tier": tier, "repair_launches": repairs,
                    "vs_eager": {"loss": max_err(loss_c, loss_e),
                                 "d_logits": max_err(d_c, d_e)},
                    "compiled": timing(lambda: run_step(cstep, *b)),
                    "eager": timing(lambda: run_step(f, *b))}
            graphs = unique_graphs() - g0
            check(graphs == (0 if not cfg else 1),
                  f"phase 13 (b) {tag}: {graphs} graphs compiled over n in {COMPILE_N}")
        report[f"(b) {tag}"] = {"compile_s": compile_s, "graphs": max(graphs, 1),
                                "recompiles": 0, "case_s": time.perf_counter() - t_case,
                                **per_n}
        log(f"phase 13 (b) classic {tag} guard, one graph for n in {COMPILE_N} ({card}): "
            f"ok, " + json.dumps(report[f"(b) {tag}"]))

    # ---- (c) the fused step at V=128 (B12) --------------------------------------
    t_case = time.perf_counter()
    v_inputs = make_inputs(torch, seed, dev, vocab=SLICE_VOCAB)
    v_labels = v_inputs[0]
    with config_override(fused_epilogue=True):
        f = loss_and_total(loss_function("classic"), v_labels)
        cstep = compile_fn(torch, f)
        (loss_c, d_c), got_c, compile_s, graphs = first_call(
            "classic", lambda: run_step(cstep, *v_inputs[1:]))
        (loss_c, d_c), got_c = launched("classic", lambda: run_step(cstep, *v_inputs[1:]))
        (loss_e, d_e), got_e = launched("classic", lambda: run_step(f, *v_inputs[1:]))
        check(graphs == 1 and got_c == got_e == {"classic_fwd[resid]": 1,
                                                "classic_bwd_streamed": 1,
                                                "fused_dlogits": 1},
              f"phase 13 (c) fused step: {graphs} graphs, launches compiled {got_c}, "
              f"eager {got_e}")
        loss64, d64 = pure_float64(*v_inputs, "classic")
        agree(loss_c, loss64, 1e-5, 0.0, "phase 13 (c) fused compiled loss vs float64")
        agree(d_c, d64, 0.0, 1e-5, "phase 13 (c) fused compiled d_logits vs float64")
        report["(c) fused V=128"] = {
            "compile_s": compile_s, "graphs": graphs, "launches_per_step": got_c,
            "vs_float64": {"loss": max_err(loss_c, loss64), "d_logits": max_err(d_c, d64)},
            "vs_eager": {"loss": max_err(loss_c, loss_e), "d_logits": max_err(d_c, d_e)},
            "compiled": timing(lambda: run_step(cstep, *v_inputs[1:])),
            "eager": timing(lambda: run_step(f, *v_inputs[1:])),
            "case_s": time.perf_counter() - t_case}
    log(f"phase 13 (c) classic fused step at V={SLICE_VOCAB} ({card}): ok, "
        + json.dumps(report["(c) fused V=128"]))
    del v_inputs, v_labels, batches, loss64, d64, loss_c, d_c, loss_e, d_e

    # ---- (d) long T: the chunked path ---------------------------------------------
    t_case = time.perf_counter()
    long_inputs = make_inputs(torch, seed, dev, max_t=LONG_T, infeasible=False)
    l_labels = long_inputs[0]
    f = loss_and_total(loss_function("classic"), l_labels)
    cstep = torch.compile(f, fullgraph=True, dynamic=False, backend=LONG_T_BACKEND)
    l_ctx = core.make_context(l_labels, logit_to_logproba(long_inputs[1], 2),
                              long_inputs[2], long_inputs[3], 0)
    n_chunks = cl.chunk_plan(l_ctx)[0]
    _, got_c, compile_s, graphs = first_call(
        "classic", lambda: run_step(cstep, *long_inputs[1:]))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    (loss_c, d_c), got_c = launched("classic", lambda: run_step(cstep, *long_inputs[1:]))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    (loss_e, d_e), got_e = launched("classic", lambda: run_step(f, *long_inputs[1:]))
    want = {k: n_chunks for k in ("classic_fwd[final]", "classic_fwd[bound]", "classic_bwd")}
    check(graphs == 1 and got_c == got_e == want,
          f"phase 13 (d) long-T step: {graphs} graphs, launches compiled {got_c}, "
          f"eager {got_e}, expected {want}")
    check(torch.equal(loss_c, loss_e) and torch.equal(d_c, d_e),
          f"phase 13 (d) long-T step ({LONG_T_BACKEND}): not the eager step bit for bit")
    feasible = TOPOLOGIES["classic"].feasible(l_ctx)
    check((seed != 0 or 220 not in LONG_ROWS or not bool(feasible[220]))
          and bool(torch.isposinf(loss_c[~feasible]).all())
          and bool((d_c[~feasible] == 0).all()),
          "phase 13 (d) long T: infeasible rows (row 220 at seed 0) +inf, zero d_logits")
    rows = torch.tensor(LONG_ROWS, device=dev)
    loss64, d64 = pure_float64(*[t[rows] for t in long_inputs], "classic")
    agree(loss_c[rows], loss64, 1e-5, 0.0, "phase 13 (d) long-T loss vs float64")
    agree(d_c[rows], d64, 0.0, 1e-5, "phase 13 (d) long-T d_logits vs float64")
    report["(d) long T"] = {
        "backend": LONG_T_BACKEND,
        "compile_s": compile_s, "graphs": graphs, "launches_per_step": got_c,
        "peak_gb": peak / 1e9,
        "vs_float64_rows": {"loss": max_err(loss_c[rows], loss64),
                            "d_logits": max_err(d_c[rows], d64)},
        "vs_eager": {"loss": max_err(loss_c, loss_e), "d_logits": max_err(d_c, d_e)},
        "compiled": timing(lambda: run_step(cstep, *long_inputs[1:]), runs=LONG_RUNS),
        "eager": timing(lambda: run_step(f, *long_inputs[1:]), runs=LONG_RUNS),
        "case_s": time.perf_counter() - t_case}
    log(f"phase 13 (d) classic long T (B={len(l_labels)}, T={LONG_T}, labels "
        f"{list(l_labels.shape)}, {n_chunks} chunks; {card}): ok, "
        + json.dumps(report["(d) long T"]))
    del long_inputs, l_labels, l_ctx, loss_c, d_c, loss_e, d_e, cstep, f

    # ---- (e) the flagship encoder, forward and loss compiled ------------------------
    t_case = time.perf_counter()
    e_batch = encoder_batch(torch, seed, dev)
    e_logit_length = enc.subsampled_length(e_batch["feature_length"])

    def encoder_loss(model, features):
        losses = ctc.classic_ctc_loss(e_batch["labels"], model(features),
                                      e_batch["label_length"], e_logit_length, 0)
        finite = torch.isfinite(losses)
        total = torch.where(finite, losses, torch.zeros_like(losses)).sum()
        return total / torch.clamp(finite.sum().to(torch.float32), min=1.0)

    runs = {}
    for tag in ("eager", "compiled"):
        model = enc.init_encoder(torch.Generator().manual_seed(seed), ENC_FEATURES,
                                 ENC_HIDDEN, ENC_VOCAB, ENC_LAYERS, device=dev)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        fn = compile_fn(torch, encoder_loss) if tag == "compiled" else encoder_loss

        def train(_model=model, _opt=opt, _fn=fn):
            _opt.zero_grad(set_to_none=True)
            loss = _fn(_model, e_batch["features"])
            loss.backward()
            _opt.step()
            return loss.detach()

        losses, per_step, grads = [], [], None
        g0, t0 = unique_graphs(), time.perf_counter()
        for i in range(ENC_STEPS):
            loss, got = launched("classic", train)
            if i == 0:
                first_s = time.perf_counter() - t0
                grads = param_grads(model)
            losses.append(float(loss))
            per_step.append(got)
            # B2 and B3 once a step; the guard repairs the rows that the
            # steps' logits flush (after the first Adam step most of them)
            check(got.get("classic_fwd[resid]") == 1 and got.get("classic_bwd_streamed") == 1
                  and set(got) <= {"classic_fwd[resid]", "classic_bwd_streamed",
                                   "classic_log_fwd[final]", "classic_log_fwd[resid]",
                                   "classic_log_bwd"},
                  f"phase 13 (e) {tag} encoder step {i + 1} launched {got}")
        runs[tag] = dict(losses=losses, grads=grads, first_s=first_s, per_step=per_step,
                         graphs=unique_graphs() - g0, train=train)
    check(all(math.isfinite(v) for v in runs["compiled"]["losses"]),
          f"phase 13 (e) compiled losses {runs['compiled']['losses']}")
    rel = abs(runs["compiled"]["losses"][0] - runs["eager"]["losses"][0]) / abs(
        runs["eager"]["losses"][0])
    check(rel <= COMPILE_ENC_RTOL, f"phase 13 (e) step 1 loss compiled "
          f"{runs['compiled']['losses'][0]} vs eager {runs['eager']['losses'][0]}")
    shares = {k: max_err(g, runs["eager"]["grads"][k]) / float(
        runs["eager"]["grads"][k].abs().max()) for k, g in runs["compiled"]["grads"].items()}
    worst = max(shares, key=shares.get)
    check(shares[worst] <= ENC_GRAD_SHARE, f"phase 13 (e) step 1 gradient of {worst}: "
          f"{shares[worst]:.3g} of its largest entry from the eager step's")
    check(runs["compiled"]["graphs"] == 1,
          f"phase 13 (e) compiled {runs['compiled']['graphs']} graphs")
    check(runs["compiled"]["per_step"][0] == runs["eager"]["per_step"][0],
          f"phase 13 (e) step 1 launches: compiled {runs['compiled']['per_step'][0]}, "
          f"eager {runs['eager']['per_step'][0]}")
    report["(e) encoder"] = {
        "compile_s": runs["compiled"]["first_s"],
        "graphs": runs["compiled"]["graphs"],
        "losses": {k: r["losses"] for k, r in runs.items()},
        "launches_per_step": {k: r["per_step"] for k, r in runs.items()},
        "step1_loss_rel": rel, "step1_grad_share": {worst: shares[worst]},
        "compiled": timing(runs["compiled"]["train"]),
        "eager": timing(runs["eager"]["train"]),
        "case_s": time.perf_counter() - t_case}
    log(f"phase 13 (e) encoder (F={ENC_FEATURES}, H={ENC_HIDDEN}, V={ENC_VOCAB}, "
        f"{ENC_LAYERS} layers, B={len(e_batch['labels'])} x {ENC_FRAMES} frames) forward "
        f"and classic finite-mean loss compiled with the backward, {ENC_STEPS} Adam "
        f"steps ({card}): ok, " + json.dumps(report["(e) encoder"]))
    import torch._inductor.async_compile as async_compile

    async_compile.shutdown_compile_workers()  # its worker processes end with the phase
    cache.cleanup()
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "report": report}


# phase 14: forced alignment, sampling and decoding under the transforms
EXTRAS = {  # kernel: (topology, source, the JAX package's scan it stands for)
    "classic_viterbi": ("classic", "csrc/viterbi.cu",
                        "tf_seq2seq_losses_tpu/ops/align.py:52"),
    "simplified_viterbi": ("simplified", "csrc/viterbi.cu",
                           "tf_seq2seq_losses_tpu/ops/align.py:127"),
    "classic_walk": ("classic", "csrc/walk.cu", "tf_seq2seq_losses_tpu/ops/sample.py:65"),
    "simplified_walk": ("simplified", "csrc/walk.cu",
                        "tf_seq2seq_losses_tpu/ops/sample.py:150"),
    "classic_alpha32": ("classic", "csrc/classic_pure64.cu",
                        "tf_seq2seq_losses_tpu/ops/classic.py:136"),
    "simplified_alpha32": ("simplified", "csrc/simplified_pure64.cu",
                           "tf_seq2seq_losses_tpu/ops/simplified.py:63"),
    # the scores' backwards: what jax.grad of those scans computes
    "classic_viterbi_grad": ("classic", "csrc/viterbi.cu",
                             "tf_seq2seq_losses_tpu/ops/align.py:52"),
    "simplified_viterbi_grad": ("simplified", "csrc/viterbi.cu",
                                "tf_seq2seq_losses_tpu/ops/align.py:127"),
    "classic_walk_grad": ("classic", "csrc/walk.cu",
                          "tf_seq2seq_losses_tpu/ops/sample.py:65"),
    "simplified_walk_grad": ("simplified", "csrc/walk.cu",
                             "tf_seq2seq_losses_tpu/ops/sample.py:150"),
    # prefix beam search, by merge_repeats: the JAX package's lax.scan
    "classic_beam_search": ("classic", "csrc/beam_search.cu",
                            "tf_seq2seq_losses_tpu/ops/decode.py:54"),
    "simplified_beam_search": ("simplified", "csrc/beam_search.cu",
                               "tf_seq2seq_losses_tpu/ops/decode.py:54"),
    # its scores' backward: what jax.grad of that scan computes
    "classic_beam_search_grad": ("classic", "csrc/beam_search.cu",
                                 "tf_seq2seq_losses_tpu/ops/decode.py:54"),
    "simplified_beam_search_grad": ("simplified", "csrc/beam_search.cu",
                                    "tf_seq2seq_losses_tpu/ops/decode.py:54"),
}
# labels wider than a CTA's shared memory holds the carries of (16 bytes a
# lane classic, 8 simplified: 14528 / 29056 lanes on an H100): Viterbi
# keeps its carry in a global scratch row, the float32 forward reads it
# back from its output; 3 rows (0 and 1 infeasible) of EXTRAS_WIDE_T frames
EXTRAS_WIDE = {"classic": 14600, "simplified": 29100}
EXTRAS_WIDE_T = 400
TRANSFORM_GROUPS = 4  # vmap's groups of the headline batch: 4 of 64 rows
TRANSFORM_RUNS = 5
TRANSFORM_RTOL = 1e-6  # compiled scores against eager (inductor rounds the glue)
# float32 operations a lattice cell (Viterbi: max, adds and compares) and a
# sample's step (the walk: candidate weights, noise, argmax, the sum)
VITERBI_CELL_OPS = {"classic": 10, "simplified": 4}
WALK_STEP_OPS = {"classic": 12, "simplified": 8}
# the backwards: the forward again, then a cell's shares and adds (classic
# six shares, three adds and the lane sum's add; simplified two, one, one)
VITERBI_GRAD_CELL_OPS = {"classic": 10 + 10, "simplified": 4 + 4}
# beam search: float32 operations a candidate and frame (the pool's adds,
# the merge's max, subtract, exp and add of each of pb and pnb, the score's
# logsumexp); the pool past shared memory that the unstaged route holds,
# K=16 at V=1024 (16400 candidates: a common BPE vocabulary), on rows of
# BEAM_WIDE_T frames
BEAM_CANDIDATE_OPS = 14
# its backward's reverse frame: a candidate's adjoint masked, then added
# into its token's sum over the beams and its beam's sum over the tokens
BEAM_GRAD_CANDIDATE_OPS = 3
BEAM_WIDE = (16, 1024)
BEAM_WIDE_T = 100


def beam_args(torch, lp, logit_length, topology, beam_width, l_cap) -> tuple:
    """``(kernel call, plain call, arguments)`` of the topology's beam search
    kernel on ``lp`` [B, T, V]: the op's canonical arguments at blank 0."""
    from tf_seq2seq_losses_tpu_torch.ops import decode

    merge = topology == "classic"
    kern = decode.classic_beam_search if merge else decode.simplified_beam_search
    args = (lp.float().contiguous(), logit_length.long().contiguous(),
            torch.zeros((), dtype=torch.int64, device=lp.device), beam_width, l_cap)
    return kern, lambda *a: decode.beam_search_plain(*a, merge), args


def beam_edge_cases(torch, dev, gen) -> dict:
    """``{case: (lp [B, T, V], logit_length [B], beam width, Lcap)}``: small
    inputs on which phase 14 holds beam search's kernel to the loop.  Rows
    of T=10 frames, 7, 0 and 9; K=64 leaves dead slots (on every row of
    ``few``: T=4, V=3); Lcap 0, and 3 below the decode length (slot 2
    written again); uniform log-probabilities (finite scores tied), -inf
    entries (a token rows 0 and 3 never emit, a frame of row 1 that only
    the blank may take), a blank-only vocabulary."""
    lengths = torch.tensor([10, 7, 0, 9], device=dev)
    lp = torch.log_softmax(2 * torch.randn((4, 10, 5), generator=gen, device=dev), 2)
    neg = lp.clone()
    neg[[0, 3], :, 2] = -math.inf
    neg[1, 2, 1:] = -math.inf
    few = torch.log_softmax(2 * torch.randn((4, 4, 3), generator=gen, device=dev), 2)
    return {
        "K=64": (lp, lengths, 64, 10), "K=1, Lcap=3": (lp, lengths, 1, 3),
        "Lcap=0": (lp, lengths, 4, 0), "K=64, Lcap=3": (lp, lengths, 64, 3),
        "uniform": (torch.full_like(lp, -math.log(5)), lengths, 4, 10),
        "-inf": (neg, lengths, 8, 10),
        "V=1": (torch.zeros((4, 10, 1), device=dev), lengths, 4, 10),
        "few": (few, torch.tensor([4, 3, 0, 2], device=dev), 64, 4),
    }


def beam_bound(args) -> tuple:
    """``(bytes, float32 operations)`` of beam search on ``args``: the
    log-probabilities read once, the lengths and the blank, the tokens,
    lengths and scores written once; the operations of every candidate of
    every frame (the kernel runs every frame, as the loop does: a frame past
    a row's length moves pnb into pb).  The kernel's back-pointer scratch
    is its own design, not the function's work, and is not counted."""
    lp, _, _, k, l_cap = args
    batch, num_t, vocab = lp.shape
    nbytes = 4 * batch * num_t * vocab + 8 * batch + 8 + 4 * batch * k * (l_cap + 2)
    return nbytes, BEAM_CANDIDATE_OPS * batch * num_t * k * (1 + vocab)


def beam_grad_args(torch, b_args, topology, gen) -> tuple:
    """``(kernel call, plain call, arguments)`` of the topology's beam-search
    backward on beam search's arguments ``b_args`` (:func:`beam_args`) under
    a N(0, 1) cotangent from ``gen`` on every beam."""
    from tf_seq2seq_losses_tpu_torch.ops import decode

    merge = topology == "classic"
    kern = decode.classic_beam_search_grad if merge else decode.simplified_beam_search_grad
    lp, k = b_args[0], b_args[3]
    cot = torch.randn((lp.shape[0], k), generator=gen, device=lp.device)
    return (kern, lambda *a: decode.beam_search_grad_plain(*a[:5], merge, a[5]),
            b_args + (cot,))


def beam_grad_bound(args) -> tuple:
    """``(bytes, float32 operations)`` of beam search's backward on ``args``
    (:func:`beam_grad_args`): the log-probabilities read once, the lengths,
    the blank and the cotangent, ``d_logprobas`` written once; the
    operations of every frame run twice, the forward's
    (``BEAM_CANDIDATE_OPS`` a candidate: the gradient needs the forward's
    selection) and the reverse frame's (``BEAM_GRAD_CANDIDATE_OPS``).  The
    kernel's record of each frame is its own design, not the function's
    work, and is not counted."""
    lp, _, _, k, _, _ = args
    batch, num_t, vocab = lp.shape
    nbytes = 2 * 4 * batch * num_t * vocab + 8 * batch + 8 + 4 * batch * k
    ops = (BEAM_CANDIDATE_OPS + BEAM_GRAD_CANDIDATE_OPS) * batch * num_t * k * (1 + vocab)
    return nbytes, ops


def extras_args(torch, ctx, topology, gen, num_s=NUM_SAMPLES) -> dict:
    """``{kernel: (kernel call, plain call, arguments)}`` of the topology's
    forward in float32, Viterbi and walk on ``ctx``, the arguments that the
    glue of ``ops/align.py`` and ``ops/sample.py`` gives them (the walk
    over the plain alpha and ``num_s`` samples of noise from ``gen``), and
    of the backwards of Viterbi and the walk, under cotangents from
    ``gen``."""
    from tf_seq2seq_losses_tpu_torch.ops import align, classic, core, pure_scan, sample
    from tf_seq2seq_losses_tpu_torch.ops import simplified

    label = (ctx.label, ctx.label_length, ctx.blank_index)
    dev = ctx.logproba.device
    noise = sample.gumbel(sample.noise_shape(topology, num_s, ctx), gen, dev)
    batch = ctx.logproba.shape[0]
    # the backwards' cotangents: N(0, 1) on every row, so that ties split
    # random values
    g_path = torch.randn((batch,), generator=gen, device=dev)
    g_acc = torch.randn((num_s, batch), generator=gen, device=dev)
    if topology == "classic":
        t = classic.terms(ctx)
        terms = tuple(a.contiguous() for a in (t.blank_lp, t.prev_tok_masked,
                                               t.diag_closed, t.diag_open))
        walk = (classic.alpha_scan(*terms),) + terms + label + (noise,)
        return {
            "classic_alpha32": (pure_scan.classic_alpha32, classic.alpha_scan, terms),
            "classic_viterbi": (align.classic_viterbi_scan, align.classic_viterbi_plain,
                                terms + label),
            "classic_walk": (sample.classic_walk_scan, sample.classic_walk_plain, walk),
            "classic_viterbi_grad": (align.classic_viterbi_grad,
                                     align.classic_viterbi_grad_plain,
                                     terms + label + (g_path,)),
            "classic_walk_grad": (sample.classic_walk_grad, sample.classic_walk_grad_plain,
                                  walk + (g_acc,)),
        }
    terms = (ctx.blank_lp.contiguous(), core.expected_token_lp(ctx).contiguous())
    walk = (simplified.alpha_scan(*terms),) + terms + label + (noise,)
    return {
        "simplified_alpha32": (pure_scan.simplified_alpha32, simplified.alpha_scan, terms),
        "simplified_viterbi": (align.simplified_viterbi_scan,
                               align.simplified_viterbi_plain, terms + label),
        "simplified_walk": (sample.simplified_walk_scan, sample.simplified_walk_plain, walk),
        "simplified_viterbi_grad": (align.simplified_viterbi_grad,
                                    align.simplified_viterbi_grad_plain,
                                    terms + label + (g_path,)),
        "simplified_walk_grad": (sample.simplified_walk_grad,
                                 sample.simplified_walk_grad_plain, walk + (g_acc,)),
    }


def extras_bound(name, args, logit_length, label_length) -> tuple:
    """``(bytes, float32 operations)`` of a phase-14 kernel on ``args``.
    The float32 forward computes its whole lattice, as the float64 scans
    (``pure64_bound``): ``blank_lp`` and the terms read once, ``[B, T+1,
    Lp1(, 2)]`` written once.  Viterbi needs each row's ``logit_length``
    steps over its ``label_length + 1`` lanes (``kernel_bounds``): the
    terms of those cells and the steps' blank read once, the label and the
    lengths, the path log-prob and the alignment written.  A walk needs, at
    each of its sample's ``logit_length`` steps, the noise of the step and
    at least the predecessor's alpha and one transition term, and writes its
    emissions and its sum.  A backward needs what its forward reads (not
    the alignment or the emissions: Viterbi's path log-prob and a walk's
    sum), its cotangent, and writes its gradients, ``blank_lp`` [B, T] and
    the terms [B, T, Lp1], whole: every lane and frame of them is an
    output."""
    topology = EXTRAS[name][0]
    states = 2 if topology == "classic" else 1
    if name.endswith("alpha32"):
        terms = [a for a in args if a.dim() == 3]
        batch, num_t, lp1 = terms[0].shape
        nbytes = 4 * (batch * num_t + len(terms) * batch * num_t * lp1
                      + states * batch * (num_t + 1) * lp1)
        return nbytes, PURE64_CELL_OPS[topology] * batch * num_t * lp1
    lens, lanes_b = logit_length.double(), label_length.double() + 1
    steps, cells = float(lens.sum()), float((lens * lanes_b).sum())
    batch, lanes = len(lens), float(lanes_b.sum())
    grad = name.endswith("_grad")
    base = name[:-len("_grad")] if grad else name
    first = 1 if base.endswith("walk") else 0  # blank_lp, then a [B, T, Lp1] term
    num_t, lp1 = args[first].shape[1], args[first + 1].shape[2]
    n_terms = 3 if topology == "classic" else 1
    # a backward reads its cotangent and writes its gradients whole
    grads_out = 4 * batch * num_t * (1 + n_terms * lp1)
    if base.endswith("viterbi"):
        if grad:
            nbytes = 4 * (n_terms * cells + steps + 2 * batch) + 8 * batch + grads_out
            return nbytes, VITERBI_GRAD_CELL_OPS[topology] * cells
        nbytes = 4 * (n_terms * cells + steps + batch + batch * num_t) + 8 * (lanes + batch)
        return nbytes, VITERBI_CELL_OPS[topology] * cells
    num_s = args[-1 - grad].shape[0]
    slots = 3 if topology == "classic" else 2
    if grad:
        nbytes = 4 * num_s * (steps * (slots + 2) + 2 * batch) + 8 * batch + grads_out
        return nbytes, (WALK_STEP_OPS[topology] + 1) * num_s * steps
    nbytes = 4 * num_s * (steps * (slots + 2) + batch * num_t + batch) + 8 * (lanes + batch)
    return nbytes, WALK_STEP_OPS[topology] * num_s * steps


def same_nan_bits(torch, a, b) -> bool:
    """Equal shapes, types and values, NaN where NaN (a walk's sum on an
    infeasible row, ``-inf - -inf`` before the feasibility mask)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@contextlib.contextmanager
def plain_extras():
    """The extras' public calls through their plain versions on the card:
    the wrappers of the six kernels patched to the loops, and beam search's
    op to its loop, which autograd differentiates directly."""
    from tf_seq2seq_losses_tpu_torch.ops import align, classic, decode, pure_scan, sample
    from tf_seq2seq_losses_tpu_torch.ops import simplified

    patches = ((align, "classic_viterbi_scan", align.classic_viterbi_plain),
               (align, "simplified_viterbi_scan", align.simplified_viterbi_plain),
               (sample, "classic_walk_scan", sample.classic_walk_plain),
               (sample, "simplified_walk_scan", sample.simplified_walk_plain),
               (pure_scan, "classic_alpha32", classic.alpha_scan),
               (pure_scan, "simplified_alpha32", simplified.alpha_scan),
               (decode, "_beam_search", decode.beam_search_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def capture_rng(torch, fn, gen):
    """``(graph, fn's outputs)``: ``fn``, which draws from the CUDA
    generator ``gen``, captured after a warm-up on a side stream, with
    ``gen``'s state registered with the graph: a replay draws from ``gen``'s
    seed and offset at the replay, as an eager call would."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def drive_transforms(torch, dev, seed, sync, card) -> dict:
    """Phase 14, forced alignment, sampling and decoding under the
    counterparts of ``jax.jit`` and ``jax.vmap``, for each topology at the
    headline (phase 8's batch, rows 0 and 1 infeasible): (a) the float32
    forward, Viterbi and the walk (``NUM_SAMPLES`` samples) bit for bit
    their plain versions on the same inputs, also on labels wider than
    shared memory holds (``EXTRAS_WIDE``: the unstaged route), beam
    search's kernel bit for bit the loop at ``BEAM_WIDTH`` and at
    ``BEAM_WIDE`` (the unstaged route), its backward kernel bit for bit its
    plain version there and on ``beam_edge_cases`` under a N(0, 1)
    cotangent, and the public calls launching
    each once; (b) forced alignment, the sampler (its CUDA
    generator registered with the graph), greedy and beam search
    (``BEAM_WIDTH``) captured as CUDA graphs, each replay bit for bit the
    eager call (the sampler's from a generator seeded alike, two seeds),
    the graph's nodes; (c) the same four under ``torch.compile(fullgraph=True,
    dynamic=False)`` with inductor, for both topologies: one graph each, cold
    compile seconds, alignments and tokens the eager call's, scores rtol
    ``TRANSFORM_RTOL``, the sampler (``generator=None``, inductor's
    ``fallback_random``) the eager call's from the same seed; (d)
    ``torch.func.vmap`` over ``TRANSFORM_GROUPS`` groups of 64 rows of
    alignment, greedy, beam search and the walk on fixed noise, bit for bit
    the unmapped call on the folded batch, each kernel once a mapped call;
    (e) the gradients of forced alignment's, the walk's and beam search's
    scores through the backward kernels (``*_viterbi_grad``, ``*_walk_grad``,
    ``*_beam_search_grad``, held bit for bit to their plain versions under a
    random cotangent in (a)): eager, bit for bit autograd through the loops
    (beam search's rtol ``TRANSFORM_RTOL``: the loop's adds on the card are
    atomics and CUDA reductions), each forward kernel and the
    backward kernel once; ``torch.func.vmap(torch.func.grad(...))`` over
    the groups bit for bit the folded gradient, each kernel once; captured
    (warm-up and capture each launch them once), the replay bit for bit the
    eager gradient; compiled with inductor, one graph, each kernel once,
    rtol ``TRANSFORM_RTOL``.
    Times: host ms (median of ``TRANSFORM_RUNS``, of ``LONG_RUNS`` for a call
    over a quarter second) of the eager call through the kernels, through
    the plain loops (beam search's: the loop once, in (a)), the replay and
    the compiled call; the device ms of a replay (CUDA events, median of
    3: the call's kernels without the host's gaps) and the eager call's
    idle share by it; device ms and idle share from one profile of the
    eager call; beam search's kernel and its backward alone (CUDA events)
    at both pools.  The
    launch counts are set to 0 before each path (the public calls of (a),
    each capture, each compiled call, each mapped call, each gradient) and
    read after it.  The gradients' times: host ms (median as above) eager,
    replayed and compiled, and of the plain loops' gradient.
    Returns the launches and the fourteen kernels' entries of the ``kernels``
    line (``launches`` left to the caller)."""
    import os
    import tempfile
    from collections import Counter

    import torch._inductor.config as inductor_config

    import tf_seq2seq_losses_tpu_torch as ctc
    from tf_seq2seq_losses_tpu_torch.ops import _build, core, sample
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    t_phase = time.perf_counter()
    cache = tempfile.TemporaryDirectory()
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache.name  # compile seconds are cold
    labels, logits, label_length, logit_length = make_inputs(torch, seed, dev)
    lp = logit_to_logproba(logits, 2)
    args = (labels, lp, label_length, logit_length)
    ctx = core.make_context(*args, 0)
    gen = torch.Generator(device=dev)
    launches, kernels, report, eager, beam = Counter(), [], {}, {}, {}

    def launched(fn):
        reset_launches()
        out = fn()
        sync()
        got = {k: n for k, n in read_launches("extras").items() if n}
        launches.update(got)
        return out, got

    def alike(got, want, what, rtol=0.0):
        """Integer outputs equal, float outputs bit for bit (or within
        ``rtol``, equal -inf patterns)."""
        for i, (a, b) in enumerate(zip(got, want)):
            ok = same_nan_bits(torch, a, b)
            if not ok and rtol and a.dtype.is_floating_point and a.shape == b.shape:
                ok = close(a, b, rtol, 0.0)
            check(ok, f"phase 14 {what}: output {i} differs (max abs err "
                  f"{max_err(a, b) if a.shape == b.shape else 'shape'})")

    def calls(topology, generator):
        return {
            "forced_alignment": lambda: ctc.ctc_forced_alignment(*args, 0, topology),
            f"sample_s{NUM_SAMPLES}": lambda: ctc.ctc_sample_alignments(
                *args, 0, generator, NUM_SAMPLES, topology),
            "greedy_decode": lambda: ctc.ctc_greedy_decode(lp, logit_length, 0, topology),
            f"beam_search_k{BEAM_WIDTH}": lambda: ctc.ctc_beam_search_decode(
                lp, logit_length, 0, BEAM_WIDTH, topology),
        }

    def eager_out(topology, name, fn):
        """The eager call's outputs, computed once: every function but the
        sampler is deterministic, so (b), (c) and (d) hold it to one call."""
        if (topology, name) not in eager:
            eager[(topology, name)] = fn()
        return eager[(topology, name)]

    def seeded(fn, s=seed):
        def call():
            gen.manual_seed(s)
            return fn()
        return call

    def host(fn):
        """``(host ms, runs)``: the median of ``TRANSFORM_RUNS`` calls of
        ``fn`` ending in a synchronize after one call, of ``LONG_RUNS`` for
        a call over a quarter second (beam search, the plain loops), that
        first call among them (each function timed here has run before)."""
        t0 = time.perf_counter()
        fn()
        sync()
        first = (time.perf_counter() - t0) * 1e3
        runs = LONG_RUNS if first > 250 else TRANSFORM_RUNS
        times = [first] if runs == LONG_RUNS else []
        while len(times) < runs:
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), runs

    for topology in ("classic", "simplified"):
        # ---- (a) the kernels against their plain versions, then the calls --
        errs = {}
        gen.manual_seed(seed)
        for name, (kern, plain, k_args) in extras_args(torch, ctx, topology, gen).items():
            got, want = kern(*k_args), plain(*k_args)
            got = (got,) if torch.is_tensor(got) else got
            want = (want,) if torch.is_tensor(want) else want
            alike(got, want, f"{name} against its plain version")
            errs[name] = max(max_err(a, b) for a, b in zip(got, want))
            b_ms, b_by = bound(*extras_bound(name, k_args, logit_length, label_length))
            kernels.append({
                "name": name, "route": "cuda",
                "source": "tf_seq2seq_losses_tpu_torch/" + EXTRAS[name][1],
                "replaces": EXTRAS[name][2], "launches": None, "max_abs_err": errs[name],
                "ms": time_ms(torch, lambda: kern(*k_args)),
                "plain_ms": time_ms(torch, lambda: plain(*k_args), runs=PLAIN_RUNS,
                                    burst=1, warmup=False),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            })
        # the unstaged route at labels wider than shared memory holds
        width = EXTRAS_WIDE[topology]
        w_labels, w_logits, w_ll, w_gl = make_inputs(torch, seed, dev, batch=3,
                                                     label_width=width, max_t=EXTRAS_WIDE_T)
        w_ctx = core.make_context(w_labels, logit_to_logproba(w_logits, 2), w_ll, w_gl, 0)
        for name, (kern, plain, k_args) in extras_args(torch, w_ctx, topology, gen,
                                                       num_s=4).items():
            if name in _build.SMEM_BYTES:
                check(not _build.fits((name,), width + 1, 0, dev),
                      f"phase 14 {name}: {width + 1} lanes fit in shared memory")
            got, want = kern(*k_args), plain(*k_args)
            got = (got,) if torch.is_tensor(got) else got
            want = (want,) if torch.is_tensor(want) else want
            alike(got, want, f"{name} against its plain version at {width + 1} lanes")
            errs[f"{name} [3, {width}]"] = max(max_err(a, b) for a, b in zip(got, want))
        del w_ctx, w_logits
        # beam search's kernel against the loop: the headline's pool in
        # shared memory, BEAM_WIDE's in the global scratch row
        name = f"{topology}_beam_search"
        kern, plain, b_args = beam_args(torch, lp, logit_length, topology, BEAM_WIDTH,
                                        MAX_T)
        check(_build.fits(("beam_search",), VOCAB, BEAM_WIDTH, dev),
              f"phase 14 {name}: the headline's pool does not fit in shared memory")
        got, want = kern(*b_args), []
        # the loop's one call, the oracle, timed by CUDA events: over a second
        beam_plain_ms = time_ms(torch, lambda: want.extend(plain(*b_args)), runs=1, burst=1,
                                warmup=False)
        alike(got, want, f"{name} against its plain version")
        errs[name] = max(max_err(a, b) for a, b in zip(got, want))
        beam[topology] = {}
        b_ms, b_by = bound(*beam_bound(b_args))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tf_seq2seq_losses_tpu_torch/" + EXTRAS[name][1],
            "replaces": EXTRAS[name][2], "launches": None, "max_abs_err": errs[name],
            "ms": time_ms(torch, lambda: kern(*b_args)), "plain_ms": beam_plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        # its backward against its plain version under a N(0, 1) cotangent
        g_name = f"{topology}_beam_search_grad"
        g_kern, g_plain, bg_args = beam_grad_args(torch, b_args, topology, gen)
        got, want = g_kern(*bg_args), []
        # the plain version's one call, timed by CUDA events: seconds
        grad_plain_ms = time_ms(torch, lambda: want.append(g_plain(*bg_args)), runs=1,
                                burst=1, warmup=False)
        alike([got], want, f"{g_name} against its plain version")
        errs[g_name] = max_err(got, want[0])
        check(bool(got.abs().sum() > 0), f"phase 14 {g_name}: a zero gradient")
        gb_ms, gb_by = bound(*beam_grad_bound(bg_args))
        kernels.append({
            "name": g_name, "route": "cuda",
            "source": "tf_seq2seq_losses_tpu_torch/" + EXTRAS[g_name][1],
            "replaces": EXTRAS[g_name][2], "launches": None, "max_abs_err": errs[g_name],
            "ms": time_ms(torch, lambda: g_kern(*bg_args)), "plain_ms": grad_plain_ms,
            "bound_ms": gb_ms, "bound_by": gb_by, "library_ms": None,
        })
        del got, want
        wide_k, wide_v = BEAM_WIDE
        check(not _build.fits(("beam_search",), wide_v, wide_k, dev),
              f"phase 14 {name}: a pool of K={wide_k} at V={wide_v} fits in shared memory")
        w_lp = logit_to_logproba(torch.randn((4, BEAM_WIDE_T, wide_v), generator=gen,
                                             device=dev), 2)
        w_len = torch.tensor([BEAM_WIDE_T, BEAM_WIDE_T // 2, 0, BEAM_WIDE_T - 7],
                             device=dev)
        _, _, w_args = beam_args(torch, w_lp, w_len, topology, wide_k, BEAM_WIDE_T)
        got, want = kern(*w_args), plain(*w_args)
        alike(got, want, f"{name} against its plain version at K={wide_k}, V={wide_v}")
        errs[f"{name} [K={wide_k}, V={wide_v}]"] = max(max_err(a, b)
                                                       for a, b in zip(got, want))
        wide = f"K={wide_k}, V={wide_v}, B=4, T={BEAM_WIDE_T}"
        beam[topology][f"ms at {wide}"] = time_ms(torch, lambda: kern(*w_args), runs=3,
                                                  burst=1)
        beam[topology][f"bound ms at {wide}"] = bound(*beam_bound(w_args))
        _, _, wg_args = beam_grad_args(torch, w_args, topology, gen)
        got, want = g_kern(*wg_args), g_plain(*wg_args)
        alike([got], [want], f"{g_name} against its plain version at K={wide_k}, V={wide_v}")
        errs[f"{g_name} [K={wide_k}, V={wide_v}]"] = max_err(got, want)
        beam[topology][f"grad ms at {wide}"] = time_ms(torch, lambda: g_kern(*wg_args),
                                                       runs=3, burst=1)
        beam[topology][f"grad bound ms at {wide}"] = bound(*beam_grad_bound(wg_args))
        del w_lp, got, want, wg_args
        for case, (e_lp, e_len, e_k, e_cap) in beam_edge_cases(torch, dev, gen).items():
            _, _, e_args = beam_args(torch, e_lp, e_len, topology, e_k, e_cap)
            alike(kern(*e_args), plain(*e_args),
                  f"{name} against its plain version ({case})")
            _, _, eg_args = beam_grad_args(torch, e_args, topology, gen)
            alike([g_kern(*eg_args)], [g_plain(*eg_args)],
                  f"{g_name} against its plain version ({case})")
        # a blank outside [0, V): the loop raises, the kernel gives NaN scores
        for bad in (-1, e_args[0].shape[2]):
            bad_blank = torch.full((), bad, dtype=torch.int64, device=dev)
            bad_scores = kern(e_args[0], e_args[1], bad_blank, *e_args[3:])[2]
            check(bool(torch.isnan(bad_scores).all()),
                  f"phase 14 {name}: blank {bad} outside [0, V) gives scores that are not NaN")
            bad_grad = g_kern(eg_args[0], eg_args[1], bad_blank, *eg_args[3:])
            check(bool(torch.isnan(bad_grad).all()),
                  f"phase 14 {g_name}: blank {bad} outside [0, V) gives a gradient that is "
                  "not NaN")
        fns = calls(topology, gen)
        want_launches = {"forced_alignment": {f"{topology}_viterbi": 1},
                         f"sample_s{NUM_SAMPLES}": {f"{topology}_alpha32": 1,
                                                    f"{topology}_walk": 1},
                         f"beam_search_k{BEAM_WIDTH}": {name: 1}}
        for name, want in want_launches.items():
            _, got = launched(seeded(fns[name]))
            check(got == want, f"phase 14 {topology} {name} launched {got}, expected {want}")
        cases = {name: dict() for name in fns}
        cases[f"beam_search_k{BEAM_WIDTH}"]["plain_loop_ms"] = beam_plain_ms

        # ---- (b) capture -----------------------------------------------------
        nodes = {}
        for name, fn in fns.items():
            t0 = time.perf_counter()
            reset_launches()
            if name.startswith("sample"):
                graph, out = capture_rng(torch, fn, gen)
            else:
                graph, out = capture(torch, fn, keep=True)
            sync()
            launches.update({k: n for k, n in read_launches("extras").items() if n})
            nodes[name] = graph_nodes(graph)
            cases[name]["capture_s"] = time.perf_counter() - t0
            # the sampler from two seeds; the others' replays take no seed
            for s in (seed, seed + 1)[:2 if name.startswith("sample") else 1]:
                gen.manual_seed(s)
                graph.replay()
                sync()
                want = (seeded(fn, s)() if name.startswith("sample")
                        else eager_out(topology, name, fn))
                alike(out, want, f"{topology} {name} replay (seed {s})")
            cases[name]["replay_ms"], _ = host(seeded(graph.replay))
            # the device time of the call's kernels: CUDA events around a replay
            cases[name]["replay_device_ms"] = time_ms(torch, seeded(graph.replay), runs=3,
                                                      burst=1)
            del graph, out

        # ---- (c) compile -----------------------------------------------------
        for name in fns:
            fn = calls(topology, None)[name]
            rtol = TRANSFORM_RTOL
            with inductor_config.patch(fallback_random=True):
                cf = compile_fn(torch, fn)
                g0, t0 = unique_graphs(), time.perf_counter()
                torch.manual_seed(seed)
                out, got = launched(cf)
                cases[name]["compile_s"] = time.perf_counter() - t0
                want = want_launches.get(name, {})
                check(got == want, f"phase 14 {topology} compiled {name} launched {got}, "
                      f"expected {want}")
                cases[name]["graphs"] = unique_graphs() - g0
                check(cases[name]["graphs"] == 1,
                      f"phase 14 {topology} {name} compiled into {cases[name]['graphs']} "
                      "graphs")
                torch.manual_seed(seed)
                alike(out, fn() if name.startswith("sample") else eager_out(topology, name, fn),
                      f"{topology} compiled {name}", rtol)
                if name.startswith("sample"):  # a second call draws from the seed alike
                    torch.manual_seed(seed + 1)
                    out = cf()
                    torch.manual_seed(seed + 1)
                    alike(out, fn(), f"{topology} compiled {name} (second call)", rtol)
                cases[name]["compiled_ms"], _ = host(cf)

        # ---- (d) vmap over groups of the batch --------------------------------
        groups = TRANSFORM_GROUPS

        def grouped(x):
            return x.unflatten(0, (groups, -1))

        g_args = tuple(grouped(a) for a in args)
        gen.manual_seed(seed)
        noise_t = sample.gumbel(sample.noise_shape(topology, NUM_SAMPLES, ctx), gen, dev)
        g_noise = noise_t.unflatten(2, (groups, -1)).movedim(2, 0)

        def walk_fn(lab, x, ll_, gl_, noise):
            return sample.WALKS[topology](core.make_context(lab, x, ll_, gl_, 0), noise)

        mapped = {
            "forced_alignment": (lambda *a: ctc.ctc_forced_alignment(*a, 0, topology),
                                 g_args, args, {f"{topology}_viterbi": 1}),
            "greedy_decode": (lambda x, n: ctc.ctc_greedy_decode(x, n, 0, topology),
                              (g_args[1], g_args[3]), (lp, logit_length), {}),
            f"beam_search_k{BEAM_WIDTH}": (
                lambda x, n: ctc.ctc_beam_search_decode(x, n, 0, BEAM_WIDTH, topology),
                (g_args[1], g_args[3]), (lp, logit_length), {f"{topology}_beam_search": 1}),
            "walk": (walk_fn, g_args + (g_noise,), args + (noise_t,),
                     {f"{topology}_alpha32": 1, f"{topology}_walk": 1}),
        }
        for name, (fn, m_args, flat_args, want) in mapped.items():
            out, got = launched(lambda: torch.func.vmap(fn)(*m_args))
            check(got == want, f"phase 14 {topology} vmap {name} launched {got}, "
                  f"expected {want}")
            want = (eager_out(topology, name, lambda: fn(*flat_args)) if name in fns
                    else fn(*flat_args))
            alike([o.flatten(0, 1) for o in out], want,
                  f"{topology} vmap {name} against the folded call")

        # ---- (e) gradients through the scores ---------------------------------
        def grad_of(fn):
            x = lp.detach().clone().requires_grad_(True)
            (g,) = torch.autograd.grad(finite_sum(fn(x)), x)
            return g

        def finite_sum(out):
            return torch.where(torch.isfinite(out), out, 0.0).sum()

        def align_score(lab, x, ll_, gl_):
            return ctc.ctc_forced_alignment(lab, x, ll_, gl_, 0, topology)[1]

        def walk_score(lab, x, ll_, gl_, noise):
            return walk_fn(lab, x, ll_, gl_, noise)[1]

        def beam_score(x, gl_):
            return ctc.ctc_beam_search_decode(x, gl_, 0, BEAM_WIDTH, topology)[2]

        grads = {
            "forced_alignment": (
                lambda x: align_score(labels, x, label_length, logit_length),
                lambda lab, x, ll_, gl_: finite_sum(align_score(lab, x, ll_, gl_)),
                g_args, {f"{topology}_viterbi": 1, f"{topology}_viterbi_grad": 1}),
            "walk": (
                lambda x: walk_score(labels, x, label_length, logit_length, noise_t),
                lambda lab, x, ll_, gl_, noise: finite_sum(walk_score(lab, x, ll_, gl_,
                                                                      noise)),
                g_args + (g_noise,), {f"{topology}_alpha32": 1, f"{topology}_walk": 1,
                                      f"{topology}_walk_grad": 1}),
            "beam": (
                lambda x: beam_score(x, logit_length),
                lambda lab, x, ll_, gl_: finite_sum(beam_score(x, gl_)),
                g_args, {f"{topology}_beam_search": 1, f"{topology}_beam_search_grad": 1}),
        }
        grad_cases = {}
        for name, (fn, total, m_args, want) in grads.items():
            case = grad_cases[name] = {}
            g, got = launched(lambda: grad_of(fn))
            check(got == want, f"phase 14 {topology} gradient of {name} launched {got}, "
                  f"expected {want}")
            with plain_extras():  # the gradient before the backward kernels: one call
                t0 = time.perf_counter()
                ref = grad_of(fn)
                sync()
                case["plain_loop_ms"] = (time.perf_counter() - t0) * 1e3
            # beam search's loop adds on the card by atomics (scatter_add,
            # last_lp's adjoints) and CUDA's reductions (sum_to), in another
            # order than the kernel's, which is the CPU's
            loop_rtol = TRANSFORM_RTOL if name == "beam" else 0.0
            check((same_nan_bits(torch, g, ref) or (bool(loop_rtol)
                                                    and close(g, ref, loop_rtol, 0.0)))
                  and bool(g.abs().sum() > 0),
                  f"phase 14 {topology} gradient of {name}: not autograd through the loops "
                  f"(max abs err {max_err(g, ref)})")
            case["loop_max_abs_err"] = max_err(g, ref)
            case["eager_ms"], case["runs"] = host(lambda: grad_of(fn))
            # vmap of grad over the groups: the folded gradient, each kernel once
            mapped_g, got = launched(
                lambda: torch.func.vmap(torch.func.grad(total, argnums=1))(*m_args))
            check(got == want, f"phase 14 {topology} vmap(grad) of {name} launched {got}, "
                  f"expected {want}")
            alike([mapped_g.flatten(0, 1)], [g], f"{topology} vmap(grad) of {name}")
            # captured: its warm-up and its capture each launch the kernels once
            reset_launches()
            graph, out = capture(torch, lambda: grad_of(fn), keep=True)
            sync()
            got = {k: n for k, n in read_launches("extras").items() if n}
            launches.update(got)
            check(got == {k: 2 * n for k, n in want.items()},
                  f"phase 14 {topology} captured gradient of {name} launched {got} in its "
                  f"warm-up and capture, expected twice {want}")
            graph.replay()
            sync()
            alike([out], [g], f"{topology} replayed gradient of {name}")
            case["nodes"] = graph_nodes(graph)
            case["replay_ms"], _ = host(graph.replay)
            del graph, out
            # compiled with inductor: the forward's graph and AOTAutograd's
            # backward, the gradient through the backward kernel
            cf = compile_fn(torch, fn)
            g0, t0 = unique_graphs(), time.perf_counter()
            cg, got = launched(lambda: grad_of(cf))
            case["compile_s"] = time.perf_counter() - t0
            case["graphs"] = unique_graphs() - g0
            check(got == want, f"phase 14 {topology} compiled gradient of {name} launched "
                  f"{got}, expected {want}")
            check(case["graphs"] == 1, f"phase 14 {topology} gradient of {name} compiled "
                  f"into {case['graphs']} graphs")
            alike([cg], [g], f"{topology} compiled gradient of {name}", TRANSFORM_RTOL)
            case["compiled_ms"], _ = host(lambda: grad_of(cf))

        # ---- times ------------------------------------------------------------
        for name, fn in fns.items():
            call = seeded(fn)
            cases[name]["eager_ms"], cases[name]["runs"] = host(call)
            cases[name]["eager_idle_share_by_replay"] = max(
                0.0, 1.0 - cases[name]["replay_device_ms"] / cases[name]["eager_ms"])
            prof = profile_step(torch, dev, cases[name]["eager_ms"], call, steps=1)
            cases[name]["eager_device_ms"] = prof.get("device_ms_per_step")
            cases[name]["eager_idle_share"] = prof.get("device_idle_share")
            if name in ("forced_alignment", f"sample_s{NUM_SAMPLES}"):
                with plain_extras():
                    cases[name]["plain_loop_ms"], _ = host(call)
        cases["gradients"] = grad_cases
        cases["beam_search_kernel"] = beam[topology]
        report[topology] = cases
        log(f"phase 14 {topology}: ok; the float32 forward, Viterbi, the walk and the "
            f"backwards of Viterbi and the walk bit for bit their plain versions (also at "
            f"labels wider than shared memory holds), beam search's kernel bit for bit "
            f"the loop and its backward kernel its plain version (K={BEAM_WIDTH}, "
            f"V={VOCAB}; K={BEAM_WIDE[0]}, V={BEAM_WIDE[1]}; the edge cases), "
            f"max abs err {json.dumps(errs)}; "
            f"captured, compiled ({', '.join(fns)}) and mapped ({groups} groups of "
            f"{len(labels) // groups}) calls bit for bit the eager call (compiled scores "
            f"rtol {TRANSFORM_RTOL}); the gradients of the alignment's and the walk's "
            f"scores bit for bit autograd through the loops, beam search's within rtol "
            f"{TRANSFORM_RTOL} of it, through the backward "
            f"kernels eager, mapped, captured and compiled (rtol {TRANSFORM_RTOL}); "
            f"graph nodes {json.dumps(nodes)}")
    log(f"phase 14 timing (ms: host clock, median of {TRANSFORM_RUNS}, of {LONG_RUNS} for a "
        f"call over a quarter second, its first call among them (runs: the eager call's); the replay's device ms by "
        f"CUDA events (median of 3), the eager call's idle share by it; device ms and "
        f"idle share from one profile of the eager call; compile "
        f"seconds cold; B={BATCH}, "
        f"T={MAX_T}, V={VOCAB}, S={NUM_SAMPLES}, K={BEAM_WIDTH}; " + card + "): "
        + json.dumps(report))
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, kernels=kernels, report=report)


# phase 15: the HVP through its tangent scans
HVP_KERNELS = {  # kernel: (topology, source, the JAX package's scan that jax.jvp carries
    # its tangent through, in ctc_loss_hessian_vector_product: api.py:374)
    "classic_alpha_jvp64": ("classic", "csrc/classic_pure64.cu",
                            "tf_seq2seq_losses_tpu/ops/classic.py:136"),
    "classic_beta_jvp64": ("classic", "csrc/classic_pure64.cu",
                           "tf_seq2seq_losses_tpu/ops/classic.py:184"),
    "simplified_alpha_jvp64": ("simplified", "csrc/simplified_pure64.cu",
                               "tf_seq2seq_losses_tpu/ops/simplified.py:63"),
    "simplified_beta_jvp64": ("simplified", "csrc/simplified_pure64.cu",
                              "tf_seq2seq_losses_tpu/ops/simplified.py:92"),
}
# float64 operations a lattice cell: a logsumexp with its tangent is 14 (the
# value's subtract, exp, log1p and add; the tangent's two differences, two
# products and two sums of the max and the min, their difference, the
# product by exp, the sum and division of log1p's, the last sum), and each
# add of a term is two: classic three and eight, simplified one and four
JVP64_CELL_OPS = {"classic": 50, "simplified": 18}
# labels past the staged tangent scans' shared memory (64 / 32 bytes a lane:
# 3632 / 7264 lanes on an H100): the carry read back from the output
HVP_WIDE = {"classic": 3700, "simplified": 7400}
HVP_GROUPS = 4  # vmap's groups of the headline batch: 4 of 64 rows
HVP_COMPILE_RTOL, HVP_COMPILE_ATOL = 1e-6, 1e-7  # compiled against eager
HVP_PLAIN_RUNS = 1  # calls of the forward-mode loop timed: 1-3 s a call


def jvp64_args(ctx, vector, topologies=("classic", "simplified")) -> dict:
    """``{kernel: (kernel call, plain call, arguments)}`` of the tangent
    scans of ``topologies`` on the float64 form of ``ctx``, with the terms'
    tangents that the HVP gives them along ``vector`` (``hvp.scan_inputs``)."""
    from tf_seq2seq_losses_tpu_torch.ops import classic, hvp, simplified

    out = {}
    for topology in topologies:
        pure = classic if topology == "classic" else simplified
        c64, _, terms, t_terms = hvp.scan_inputs(topology, ctx, vector)
        args = tuple(a.contiguous() for a in terms + t_terms)
        alpha, beta = hvp.SCANS[topology]
        out[f"{topology}_alpha_jvp64"] = (alpha, pure.alpha_scan_jvp, args)
        out[f"{topology}_beta_jvp64"] = (beta, pure.beta_scan_jvp,
                                         args + (c64.label_length,))
    return out


def jvp64_bound(name, args) -> tuple:
    """``(bytes, float64 operations, the float64 rate)`` of a tangent scan
    on ``args``: every step of every lane, as the float64 scans
    (``pure64_bound``); the values and tangents in (``blank_lp`` and the
    terms, and their tangents) read once, ``label_length`` too, the lattice
    and its tangent written once."""
    topology = HVP_KERNELS[name][0]
    terms = [a for a in args if a.dim() == 3]
    batch, num_t, lp1 = terms[0].shape
    states = 2 if topology == "classic" else 1
    lengths = batch if "beta" in name else 0
    nbytes = 8 * (2 * batch * num_t + len(terms) * batch * num_t * lp1
                  + 2 * states * batch * (num_t + 1) * lp1 + lengths)
    return nbytes, JVP64_CELL_OPS[topology] * batch * num_t * lp1, F64_OPS_PER_S


def hvp_forward_ad(torch, topology, labels, lp, label_length, logit_length, vector):
    """The HVP as the port computed it before the tangent scans:
    ``torch.autograd.forward_ad`` through the pure path's Python loops in
    float64 (``core.float64_context``), the plain loop that phase 15 times."""
    from torch.autograd import forward_ad

    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES

    with forward_ad.dual_level():
        ctx = core.float64_context(core.make_context(
            labels, forward_ad.make_dual(lp, vector), label_length, logit_length, 0))
        grad = core.gradient(TOPOLOGIES[topology], ctx)
        return forward_ad.unpack_dual(grad).tangent.to(torch.float32)


def hvp_contexts(torch, dev, seed, lp_args, vec) -> dict:
    """``{case: (float32 context, vector, topologies)}`` on which phase 15
    holds the tangent scans to their plain versions: rows 0-7 of the
    headline and the whole batch (rows 0 and 1 infeasible), the long-T row
    (rows 0 and 2 of the long-T batch at T=4000, gathered as
    ``pure64_contexts`` gathers them), and for each topology labels wider
    than its staged kernels hold (``HVP_WIDE``, T=64: the carry read back
    from the output)."""
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops import topology as topo_mod
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    both = ("classic", "simplified")
    ctx = core.make_context(*lp_args, 0)
    gen = torch.Generator(device=dev).manual_seed(seed + 15)

    def ctx_of(inputs):
        return core.make_context(inputs[0], logit_to_logproba(inputs[1], 2), *inputs[2:],
                                 0)

    long_ctx = topo_mod._take_rows(ctx_of(make_inputs(torch, seed, dev, max_t=LONG_T)),
                                   torch.tensor([0, 2], device=dev))
    out = {
        f"rows 0-{HVP_ROWS - 1}": (topo_mod._take_rows(ctx, torch.arange(HVP_ROWS,
                                                                         device=dev)),
                                   vec[:HVP_ROWS], both),
        f"whole batch of {len(vec)}": (ctx, vec, both),
        f"long-T row (T={LONG_T})": (long_ctx, torch.randn(
            long_ctx.logproba.shape, generator=gen, device=dev), both),
    }
    for topology, width in HVP_WIDE.items():
        w_ctx = ctx_of(make_inputs(torch, seed + 5, dev, batch=3, label_width=width,
                                   max_t=64))
        out[f"{topology} labels [3, {width}] (unstaged)"] = (w_ctx, torch.randn(
            w_ctx.logproba.shape, generator=gen, device=dev), (topology,))
    return out


def drive_hvp(torch, dev, seed, sync, card) -> dict:
    """Phase 15, ``ctc_loss_hessian_vector_product`` through its tangent
    scans, for each topology at phase 8's headline batch (rows 0 and 1
    infeasible) along a N(0, 1) vector: (a) each tangent scan bit for bit
    its plain version on the same inputs (else every entry within 1e-12
    relative, the largest difference printed) on rows 0-7, the whole batch,
    the long-T row and labels wider than its shared memory holds, and the
    public call launching each of its two scans once; (b) the HVP of the
    whole batch within atol 1e-4 of the float64 central difference, zero on
    the infeasible rows, its peak memory; (c) the HVP of rows 0-7 and of the
    whole batch captured as CUDA graphs, each replay bit for bit the eager
    call, the graph's nodes; (d) the whole batch's HVP under
    ``torch.compile(fullgraph=True, dynamic=False)`` with inductor: one
    graph, cold compile seconds, the eager call's values within rtol
    ``HVP_COMPILE_RTOL`` and atol ``HVP_COMPILE_ATOL``, each scan once a
    call; (e) ``torch.func.vmap`` over ``HVP_GROUPS`` groups of 64 rows,
    bit for bit the unmapped call on the folded batch, each scan once.
    Times: host ms (median of 5) of the eager call, the replay and the
    compiled call; of the forward-mode loop the HVP was before
    (:func:`hvp_forward_ad`) on rows 0-7 (``HVP_PLAIN_RUNS`` calls); the
    replay's device ms (CUDA events, median of 3).  The launch counts are
    set to 0 before each path (each public call of (a), each capture, the
    compiled call, the mapped call) and read after it.
    Returns the launches and the four kernels' entries of the ``kernels``
    line (``launches`` left to the caller; ``ms`` and ``plain_ms`` on the
    whole batch)."""
    import os
    import tempfile
    from collections import Counter

    import tf_seq2seq_losses_tpu_torch as ctc
    from tf_seq2seq_losses_tpu_torch.ops import core
    from tf_seq2seq_losses_tpu_torch.ops.topology import TOPOLOGIES
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    t_phase = time.perf_counter()
    cache = tempfile.TemporaryDirectory()
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache.name  # compile seconds are cold
    labels, logits, label_length, logit_length = make_inputs(torch, seed, dev)
    lp = logit_to_logproba(logits, 2)
    args = (labels, lp, label_length, logit_length)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vec = torch.randn(lp.shape, generator=gen, device=dev)
    batch = len(labels)
    parts = {f"rows_0_{HVP_ROWS - 1}": slice(0, HVP_ROWS), "whole_batch": slice(None)}
    launches, kernels, report = Counter(), [], {}

    def launched(fn):
        reset_launches()
        out = fn()
        sync()
        got = {k: n for k, n in read_launches("hvp").items() if n}
        launches.update(got)
        return out, got

    def host(fn, runs=RUNS // 4):
        """Median host ms of ``runs`` calls ending in a synchronize, after one."""
        return host_ms(torch, fn, runs=runs)

    # ---- (a) the tangent scans against their plain versions -------------------
    errs, rel, case_ms, kernel_args = {}, {}, {}, {}
    for case, (c, v, topologies) in hvp_contexts(torch, dev, seed, args, vec).items():
        for name, (kern, plain, k_args) in jvp64_args(c, v, topologies).items():
            got, want = kern(*k_args), plain(*k_args)
            for part, g, w in zip(("lattice", "tangent"), got, want):
                check(g.dtype == w.dtype == torch.float64 and g.shape == w.shape,
                      f"phase 15 {name} on {case}: {part} {g.dtype} {tuple(g.shape)} "
                      f"against {w.dtype} {tuple(w.shape)}")
                same = torch.equal(g, w)
                r = 0.0 if same else rel_err(g, w)
                check(same or close(g, w, 1e-12, 0.0),
                      f"phase 15 {name} on {case}: the {part} is not its plain version's "
                      f"bits, largest relative difference {r:.3g} (limit 1e-12)")
                errs[name] = max(errs.get(name, 0.0), max_err(g, w))
                rel[f"{name} {part} on {case}"] = "bit for bit" if same else r
            if case.startswith(("long-T", "rows")):
                case_ms[f"{name} {case}"] = time_ms(torch, lambda: kern(*k_args), runs=3,
                                                    burst=1)
            if case.startswith("whole"):
                kernel_args[name] = (kern, plain, k_args)
    del got, want
    for name, (kern, plain, k_args) in kernel_args.items():
        b_ms, b_by = bound(*jvp64_bound(name, k_args))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tf_seq2seq_losses_tpu_torch/" + HVP_KERNELS[name][1],
            "replaces": HVP_KERNELS[name][2], "launches": None,
            "max_abs_err": errs[name],
            "ms": time_ms(torch, lambda: kern(*k_args), burst=5),
            "plain_ms": time_ms(torch, lambda: plain(*k_args), runs=PLAIN_RUNS, burst=1,
                                warmup=False),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    del kernel_args
    log(f"phase 15 (a) the tangent scans vs their plain versions on the card, largest "
        f"relative difference (limit 1e-12) by case: " + json.dumps(rel)
        + f"; kernel ms ({card}; CUDA events around single launches, median of 3): "
        + json.dumps(case_ms))

    for topology in ("classic", "simplified"):
        topo = TOPOLOGIES[topology]
        want = {f"{topology}_alpha_jvp64": 1, f"{topology}_beta_jvp64": 1}
        feasible = topo.feasible(core.make_context(*args, 0))
        cases = {part: {} for part in parts}

        def call(part, topology=topology):
            sl = parts[part]
            return ctc.ctc_loss_hessian_vector_product(*(a[sl] for a in args), 0, vec[sl],
                                                       topology)

        # ---- (a) launches, (b) the whole batch against float64 ----------------
        eager = {}
        for part in parts:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
            eager[part], got = launched(lambda: call(part))
            check(got == want, f"phase 15 {topology} HVP of {part} launched {got}, "
                  f"expected {want}")
            if dev.type == "cuda":
                cases[part]["peak_gb"] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        whole = eager["whole_batch"]
        check(bool((whole[~feasible] == 0).all()),
              f"phase 15 {topology} HVP zero on infeasible rows")
        check(torch.equal(whole[:HVP_ROWS], eager[f"rows_0_{HVP_ROWS - 1}"]),
              f"phase 15 {topology} HVP of rows 0-{HVP_ROWS - 1} is the whole batch's")
        eps, lp64, vec64 = 1e-4, lp.double(), vec.double()
        grads = [pure_float64_grad(labels, lp64 + sign * eps * vec64, label_length,
                                   logit_length, topology)[2] for sign in (1, -1)]
        hvp64 = (grads[0] - grads[1]) / (2 * eps)
        del grads
        hvp_err = max_err(whole, hvp64)
        agree(whole, hvp64, 0.0, 1e-4,
              f"phase 15 {topology} whole-batch HVP vs the float64 central difference")
        del hvp64

        # ---- (c) capture ------------------------------------------------------
        nodes = {}
        for part in parts:
            reset_launches()
            graph, out = capture(torch, lambda: call(part), keep=True)
            sync()
            got = {k: n for k, n in read_launches("hvp").items() if n}
            launches.update(got)
            # the warm-up and the capture: each launches the two scans once
            check(got == {k: 2 for k in want},
                  f"phase 15 {topology} capture of {part} launched {got}")
            nodes[part] = graph_nodes(graph)
            out.zero_()
            graph.replay()
            sync()
            check(torch.equal(out, eager[part]),
                  f"phase 15 {topology} replay of {part}: not the eager call's bits "
                  f"(max abs err {max_err(out, eager[part]):.3g})")
            cases[part]["graph_nodes"] = nodes[part]
            cases[part]["replay_ms"] = host(graph.replay)
            cases[part]["replay_device_ms"] = time_ms(torch, graph.replay, runs=3, burst=1)
            del graph, out

        # ---- (d) compile -----------------------------------------------------
        part = "whole_batch"
        cf = compile_fn(torch, lambda *a: ctc.ctc_loss_hessian_vector_product(
            *a, topology))
        c_args = args + (0, vec)
        g0, t0 = unique_graphs(), time.perf_counter()
        out, got = launched(lambda: cf(*c_args))
        cases[part]["compile_s"] = time.perf_counter() - t0
        cases[part]["graphs"] = unique_graphs() - g0
        check(cases[part]["graphs"] == 1,
              f"phase 15 {topology} HVP compiled into {cases[part]['graphs']} graphs")
        check(got == want, f"phase 15 {topology} compiled HVP launched {got}")
        cases[part]["compiled_max_abs_err"] = max_err(out, whole)
        agree(out, whole, HVP_COMPILE_RTOL, HVP_COMPILE_ATOL,
              f"phase 15 {topology} compiled HVP vs the eager call")
        cases[part]["compiled_ms"] = host(lambda: cf(*c_args))
        del out, cf

        # ---- (e) vmap over groups of the batch ------------------------------------
        grouped = [a.unflatten(0, (HVP_GROUPS, -1)) for a in args + (vec,)]
        out, got = launched(lambda: torch.func.vmap(
            lambda lab, x, ll_, gl_, v: ctc.ctc_loss_hessian_vector_product(
                lab, x, ll_, gl_, 0, v, topology))(*grouped))
        check(got == want, f"phase 15 {topology} vmap HVP launched {got}")
        check(torch.equal(out.flatten(0, 1), whole),
              f"phase 15 {topology} vmap HVP: not the unmapped call's bits on the folded "
              f"batch (max abs err {max_err(out.flatten(0, 1), whole):.3g})")
        del out, grouped

        # ---- times ---------------------------------------------------------------
        for part in parts:
            cases[part]["eager_ms"] = host(lambda: call(part))
        # the forward-mode loop, a second or more a call: no warm-up call
        sl, loop_ms = parts[f"rows_0_{HVP_ROWS - 1}"], []
        for _ in range(HVP_PLAIN_RUNS):
            t0 = time.perf_counter()
            hvp_forward_ad(torch, topology, *(a[sl] for a in args), vec[sl])
            sync()
            loop_ms.append((time.perf_counter() - t0) * 1e3)
        cases[f"rows_0_{HVP_ROWS - 1}"]["forward_ad_loop_ms"] = statistics.median(loop_ms)
        report[topology] = cases
        log(f"phase 15 {topology}: ok; each tangent scan launched once a call (eager, "
            f"compiled, mapped); the whole batch's HVP max abs err vs the float64 central "
            f"difference {hvp_err:.3g}, zero on infeasible rows; replays, the compiled "
            f"call (rtol {HVP_COMPILE_RTOL}, atol {HVP_COMPILE_ATOL}) and vmap over "
            f"{HVP_GROUPS} groups of {batch // HVP_GROUPS} match the eager call; graph "
            f"nodes {json.dumps(nodes)}")
    log(f"phase 15 timing (ms: host clock, median of {RUNS // 4} after one call, of "
        f"{HVP_PLAIN_RUNS} call(s) for the forward-mode loop; the replay's device ms by CUDA "
        f"events (median of 3); compile seconds cold; peak GB above the inputs; "
        f"B={batch}, T={MAX_T}, V={VOCAB}; " + card + "): " + json.dumps(report))
    if dev.type == "cuda":
        import torch._inductor.async_compile as async_compile

        async_compile.shutdown_compile_workers()  # its worker processes end with the phase
    cache.cleanup()
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, kernels=kernels, report=report)


def run(seed: int, dev) -> dict:
    from collections import Counter

    import numpy as np
    import torch

    import tf_seq2seq_losses_tpu_torch as ctc
    from tf_seq2seq_losses_tpu_torch.ops import _build, core
    from tf_seq2seq_losses_tpu_torch.ops.topology import compose_dlogits
    from tf_seq2seq_losses_tpu_torch.ops import cuda_lattice as cl
    from tf_seq2seq_losses_tpu_torch.ops import cuda_simplified as cs
    from tf_seq2seq_losses_tpu_torch.ops import log_lattice as ll
    from tf_seq2seq_losses_tpu_torch.utils.config import config_override
    from tf_seq2seq_losses_tpu_torch.utils.numerics import logit_to_logproba

    card = card_line()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # ---- 1. build --------------------------------------------------------
    t_phase = time.perf_counter()
    libs = _build.build_all()
    check_mirrors(libs)
    log(f"phase 1 build: {time.perf_counter() - t_phase:.1f} s for "
        f"{len(_build._SOURCES)} libraries from tf_seq2seq_losses_tpu_torch/csrc; "
        f"the Python mirrors of the {len(_build.SMEM_BYTES)} shared-memory formulas "
        f"equal the libraries'; the most lanes each kernel takes at window 8 (the "
        f"fused epilogue at V={SLICE_VOCAB}): {json.dumps(widest_lanes(dev))}")

    inputs = make_inputs(torch, seed, dev)
    labels, logits, label_length, logit_length = inputs

    # ---- 2. every kernel against its plain version ------------------------
    t_phase = time.perf_counter()
    ctx = core.make_context(
        labels, logit_to_logproba(logits, 2), label_length, logit_length, 0
    )

    def compare_rf(c):
        errs_rf, args_rf = {}, {}
        for topology in ("classic", "simplified"):
            e, args_rf[topology] = compare_rf_kernels(c, topology)
            errs_rf.update(e)
        return errs_rf, args_rf

    def compare_all(c, rf=False):
        errs_c, args_c = compare_kernels(c)
        errs_s, args_s = compare_simplified_kernels(c)
        out = {**errs_c, **errs_s}
        for name, e in compare_fwd_modes(c).items():
            out[name] = max(out.get(name, 0.0), e)
        errs_rf, args_rf = compare_rf(c) if rf else ({}, None)
        for name, e in errs_rf.items():
            out[name] = max(out.get(name, 0.0), e)
        return out, args_c, args_s, args_rf

    errs, kargs, sargs, rfargs = compare_all(ctx, rf=True)
    # other geometries at batch 8: two lanes per thread (labels [8, 600]),
    # windows 1 and 16, blank index 3 with labels over {1, 2} (many repeats)
    small = make_inputs(torch, seed + 1, dev, batch=8)
    extra = {}
    wide = make_inputs(torch, seed + 2, dev, batch=8, label_width=600)
    extra["labels [8, 600]"] = compare_all(
        core.make_context(wide[0], logit_to_logproba(wide[1], 2), *wide[2:], 0),
        rf=True)[0]
    small_ctx = core.make_context(small[0], logit_to_logproba(small[1], 2), *small[2:], 0)
    # window 3: the blank row of a window is not 16-byte aligned
    for window in (1, 3, 16):
        with config_override(window=window):
            extra[f"window {window}"] = compare_all(small_ctx, rf=True)[0]
    rep_labels = 1 + small[0] % 2
    extra["blank 3, labels over {1, 2}"] = compare_all(core.make_context(
        rep_labels, logit_to_logproba(small[1], 2), *small[2:], 3), rf=True)[0]
    # B10 and B11 with every lane live: a label for each lanes-per-thread
    # instantiation, and window 3, from random carries
    rf_cases = lane_cases(dev, {"classic": "classic_bwd_rf",
                                "simplified": "simplified_bwd_rf"})
    key = "B10/B11 from random carries, (window, width) " + json.dumps(rf_cases)
    extra[key] = compare_rf_lanes(torch, dev, seed, rf_cases)
    extra["B10/B11 from random carries at window 3"] = compare_rf_lanes(
        torch, dev, seed, {"classic": [(3, 999)], "simplified": [(3, 999)]}, max_t=40)
    # B1 and B6 in every mode with every lane live: a label for each
    # lanes-per-thread instantiation, then windows 3 (a window's blank row
    # is not 16-byte aligned) and 16, both carries
    fwd_cases = {topology: cases + [(3, 999), (16, 999)] for topology, cases in
                 lane_cases(dev, {"classic": "classic_fwd",
                                  "simplified": "simplified_fwd"}).items()}
    fwd_key = ("B1/B6 every mode from the standard and random carries, (window, width) "
               + json.dumps(fwd_cases))
    extra[fwd_key] = compare_fwd_lanes(torch, dev, seed, fwd_cases)
    # B3, B13 and B7 over residuals from a random carry: a label for each
    # lanes-per-thread instantiation, then windows 3 and 16
    streamed_cases = {name: cases + [(3, 999), (16, 999)] for name, cases in
                      lane_cases(dev, {"classic_bwd_streamed": "classic_bwd",
                                       "classic_bwd_half": "classic_bwd_half",
                                       "simplified_bwd_streamed": "simplified_bwd",
                                       }).items()}
    streamed_key = ("B3/B13/B7 over residuals from a random carry, (window, width) "
                    + json.dumps(streamed_cases))
    extra[streamed_key] = compare_streamed_lanes(torch, dev, seed, streamed_cases)
    # B4 and B5 with every lane live at a label for each lanes-per-thread
    # instantiation up to the widest label the host sends them, then on a
    # repair round of four full-length rows
    log_key = ("B4/B5 with every lane live, label widths "
               + json.dumps(log_lane_widths()) + ", and the repair round")
    t_log = time.perf_counter()
    extra[log_key] = compare_log_lanes(torch, dev, seed)
    t_log = time.perf_counter() - t_log
    # the same for B8 and B9, up to the widest label the host sends them
    slog_key = ("B8/B9 with every lane live, label widths "
                + json.dumps(log_lane_widths("simplified")) + ", and the repair round")
    t_slog = time.perf_counter()
    extra[slog_key] = compare_log_lanes(torch, dev, seed, "simplified")
    t_slog = time.perf_counter() - t_slog
    for name_errs in (extra[key], extra["B10/B11 from random carries at window 3"],
                      extra[fwd_key], extra[streamed_key], extra[log_key],
                      extra[slog_key]):
        for name, e in name_errs.items():
            errs[name] = max(errs[name], e)
    # the residual-free kernels over several chunks, each from the carries
    # the previous chunk's kernels left: T=1500, labels [8, 600]
    multi = make_inputs(torch, seed + 3, dev, batch=8, label_width=600, max_t=1500)
    multi_ctx = core.make_context(multi[0], logit_to_logproba(multi[1], 2), *multi[2:],
                                  0)
    for chunk_time in (512, 64):
        with config_override(chunk_time=chunk_time):
            key = (f"T 1500, labels [8, 600], {cl.chunk_plan(multi_ctx)[0]} chunks "
                   f"of at most {chunk_time}")
            extra[key] = compare_rf(multi_ctx)[0]
        for name, e in extra[key].items():
            errs[name] = max(errs[name], e)
    errs["fused_dlogits"] = compare_fused(torch, seed, dev)
    fused_widest = compare_fused_lanes(torch, dev, seed)
    t_pure = time.perf_counter()
    pure_errs, pure_rel, pure_long_ms = compare_pure64(torch, dev, seed)
    errs.update(pure_errs)
    t_pure = time.perf_counter() - t_pure
    sync()
    worst = {name: float(f"{max(e.values()):.3g}") for name, e in extra.items()}
    log("phase 2 kernel vs plain on the card: ok, max abs err at the headline "
        "shape (the residual-free modes: also over the chunks of T 1500, the "
        "backwards also from random carries at every lanes-per-thread count; "
        "fused_dlogits: at batch 8, blank 3, V = 32, 128 and 1000, and on random "
        "acts at 992, 2048, 2080 and the widest lanes it holds, "
        + json.dumps(fused_widest) + ") "
        + json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()})
        + "; worst over the kernels at batch 8: " + json.dumps(worst)
        + f"; {time.perf_counter() - t_phase:.1f} s, of which B4/B5's lane and "
        f"repair-round checks {t_log:.1f} s, B8/B9's {t_slog:.1f} s")
    log("phase 2 float64 scans vs their plain versions (the pure path's loops) on the "
        "card, largest relative difference (limit 1e-12) by case: "
        + json.dumps(pure_rel) + f"; the long-T row's kernel ms ({card}; CUDA events "
        f"around single launches, median of 3): " + json.dumps(pure_long_ms)
        + f"; {t_pure:.1f} s")

    # ---- 3 and 4. each main path, then the guard ---------------------------
    # TF32 on, as an H100 training script sets it: the act scatter must not
    # depend on it
    torch.set_float32_matmul_precision("high")
    t_phase = time.perf_counter()
    paths = {name: drive_main_path(torch, dev, name, inputs, ctx, sync)
             for name in ("classic", "simplified")}
    launches = Counter()
    for path in paths.values():
        launches.update(path["launches"])
    slice_paths = drive_slice_paths(torch, dev, seed, inputs, paths["classic"], sync)
    launches.update(slice_paths["launches"])
    log(f"phases 3-4: {time.perf_counter() - t_phase:.1f} s")

    # ---- 5. oracles ----------------------------------------------------------
    o_labels = torch.tensor([[1, 2, 2, 1], [1, 2, 1, 0]], device=dev)
    o_logits = torch.zeros((2, 5, 3), device=dev, requires_grad=True)
    o_loss = ctc.classic_ctc_loss(o_labels, o_logits, torch.tensor([4, 3], device=dev),
                                  torch.tensor([5, 4], device=dev), 0)
    o_loss.sum().backward()
    agree(o_loss.detach().cpu(), torch.tensor([5.4931, 2.4485]), 0.0, 1e-3,
          "README oracle loss")
    agree(o_logits.grad[0, 0].cpu(), torch.tensor([1 / 3, -2 / 3, 1 / 3]), 0.0, 1e-3,
          "README oracle grad")
    # the same example from numpy arrays: the values go to the card
    n_loss = ctc.classic_ctc_loss(np.array([[1, 2, 2, 1], [1, 2, 1, 0]]),
                                  np.zeros((2, 5, 3), np.float32), np.array([4, 3]),
                                  np.array([5, 4]), 0)
    check(n_loss.device == dev, f"numpy logits computed on {n_loss.device}, not {dev}")
    agree(n_loss.cpu(), o_loss.detach().cpu(), 0.0, 0.0, "README oracle from numpy")
    # simplified: three paths (_12, 1_2, 12_) of probability 1/27 each
    s_loss = ctc.simplified_ctc_loss(torch.tensor([[1, 2]], device=dev),
                                     torch.zeros((1, 3, 3), device=dev),
                                     torch.tensor([2], device=dev),
                                     torch.tensor([3], device=dev), 0)
    agree(s_loss.cpu(), torch.tensor([float(np.log(9.0))]), 0.0, 1e-3,
          "simplified oracle loss ln 9")
    log(f"phase 5 oracles: ok, README loss {[round(v, 4) for v in o_loss.tolist()]} "
        f"(also from numpy, on {n_loss.device}); simplified [[1, 2]] over 3 "
        f"frames {round(float(s_loss[0]), 4)} (ln 9 = 2.1972)")

    # ---- 6. timing at the headline shape -------------------------------------
    t_phase = time.perf_counter()
    bounds = kernel_bounds(kargs["lens"], label_length, kargs["k_win"])
    lib_lp = logit_to_logproba(logits, 2).transpose(0, 1).contiguous()
    lib_targets = labels.long()

    def library_fwd():
        torch.nn.functional.ctc_loss(
            lib_lp, lib_targets, logit_length.long(), label_length.long(),
            blank=0, reduction="none", zero_infinity=False,
        )

    with torch.no_grad():
        lib_fwd_ms = time_ms(torch, library_fwd, runs=RUNS, burst=1)
    lib_bwd_ms = library_bwd_ms(torch, lib_lp, lib_targets, logit_length, label_length)
    fwd, bwd, logf, logb = (kargs[k] for k in ("fwd", "bwd", "log_fwd", "log_bwd"))
    sfwd, sbwd, slogf, slogb = (sargs[k] for k in ("fwd", "bwd", "log_fwd", "log_bwd"))
    rff, rfb = rfargs["classic"]["fwd"], rfargs["classic"]["bwd"]
    srff, srfb = rfargs["simplified"]["fwd"], rfargs["simplified"]["bwd"]
    hbwd = kargs["half_bwd"]
    # B12 at V=128 on the headline batch, and the unfused epilogue it
    # replaces there: act scatter, assembly and compose
    v_labels, v_logits, v_ll, v_gl = slice_paths["v_inputs"]
    v_ctx = core.make_context(v_labels, logit_to_logproba(v_logits, 2), v_ll, v_gl, 0)
    eargs, (acts, lm_, fast_loss, scale) = fused_args(v_ctx)
    d_loss = eargs[4]

    def unfused_epilogue():
        grad = cl.streamed_gradient(v_ctx, acts, lm_, fast_loss, scale)[0]
        return compose_dlogits(v_ctx, grad, fast_loss, d_loss)

    check(max_err(cl.fused_dlogits(*eargs), unfused_epilogue()) <= 1e-6,
          "fused_dlogits vs the unfused epilogue at V=128")
    bounds["fused_dlogits"] = fused_bound(eargs[5], v_ll, v_logits.shape[1],
                                          v_logits.shape[2])
    unfused_ms = time_ms(torch, unfused_epilogue)
    pl = "tf_seq2seq_losses_tpu/ops/pallas_lattice.py"
    lg = "tf_seq2seq_losses_tpu/ops/log_lattice.py"
    table = {
        "classic_fwd[final]": (
            lambda: cl.classic_fwd(*fwd, "final"),
            lambda: cl.classic_fwd_plain(*fwd, "final"),
            "csrc/classic_fwd.cu", f"{pl}:579", lib_fwd_ms),
        "classic_fwd[resid]": (
            lambda: cl.classic_fwd(*fwd, "resid"),
            lambda: cl.classic_fwd_plain(*fwd, "resid"),
            "csrc/classic_fwd.cu", f"{pl}:579", lib_fwd_ms),
        "classic_bwd_streamed": (
            lambda: cl.classic_bwd_streamed(*bwd),
            lambda: cl.classic_bwd_streamed_plain(*bwd),
            "csrc/classic_bwd.cu", f"{pl}:1123", lib_bwd_ms),
        "classic_log_fwd[final]": (
            lambda: ll.classic_log_fwd(*logf, "final"),
            lambda: ll.classic_log_fwd_plain(*logf, "final"),
            "csrc/classic_log.cu", f"{lg}:152", lib_fwd_ms),
        "classic_log_fwd[resid]": (
            lambda: ll.classic_log_fwd(*logf, "resid"),
            lambda: ll.classic_log_fwd_plain(*logf, "resid"),
            "csrc/classic_log.cu", f"{lg}:152", lib_fwd_ms),
        "classic_log_bwd": (
            lambda: ll.classic_log_bwd(*logb),
            lambda: ll.classic_log_bwd_plain(*logb),
            "csrc/classic_log.cu", f"{lg}:267", lib_bwd_ms),
        "classic_fwd[bound]": (
            lambda: cl.classic_fwd(*rff, "bound"),
            lambda: cl.classic_fwd_plain(*rff, "bound"),
            "csrc/classic_fwd.cu", f"{pl}:579", lib_fwd_ms),
        "classic_bwd": (
            lambda: cl.classic_bwd(*rfb),
            lambda: cl.classic_bwd_plain(*rfb),
            "csrc/classic_bwd_rf.cu", f"{pl}:945", lib_bwd_ms),
        "classic_fwd[resid1]": (
            lambda: cl.classic_fwd(*fwd, "resid1"),
            lambda: cl.classic_fwd_plain(*fwd, "resid1"),
            "csrc/classic_fwd.cu", f"{pl}:579", lib_fwd_ms),
        "classic_bwd_half": (
            lambda: cl.classic_bwd_half(*hbwd),
            lambda: cl.classic_bwd_half_plain(*hbwd),
            "csrc/classic_bwd_half.cu", f"{pl}:1273", lib_bwd_ms),
        # no one PyTorch call computes d_logits from the acts; the unfused
        # epilogue's device time is printed beside the kernels line
        "fused_dlogits": (
            lambda: cl.fused_dlogits(*eargs),
            lambda: cl.fused_dlogits_plain(*eargs),
            "csrc/fused_epilogue.cu", f"{pl}:2390", None),
        # no PyTorch call computes the simplified loss: library_ms is null
        "simplified_fwd[final]": (
            lambda: cs.simplified_fwd(*sfwd, "final"),
            lambda: cs.simplified_fwd_plain(*sfwd, "final"),
            "csrc/simplified_fwd.cu", f"{pl}:1720", None),
        "simplified_fwd[resid]": (
            lambda: cs.simplified_fwd(*sfwd, "resid"),
            lambda: cs.simplified_fwd_plain(*sfwd, "resid"),
            "csrc/simplified_fwd.cu", f"{pl}:1720", None),
        "simplified_bwd_streamed": (
            lambda: cs.simplified_bwd_streamed(*sbwd),
            lambda: cs.simplified_bwd_streamed_plain(*sbwd),
            "csrc/simplified_bwd.cu", f"{pl}:2073", None),
        "simplified_log_fwd[final]": (
            lambda: ll.simplified_log_fwd(*slogf, "final"),
            lambda: ll.simplified_log_fwd_plain(*slogf, "final"),
            "csrc/simplified_log.cu", f"{lg}:462", None),
        "simplified_log_fwd[resid]": (
            lambda: ll.simplified_log_fwd(*slogf, "resid"),
            lambda: ll.simplified_log_fwd_plain(*slogf, "resid"),
            "csrc/simplified_log.cu", f"{lg}:462", None),
        "simplified_log_bwd": (
            lambda: ll.simplified_log_bwd(*slogb),
            lambda: ll.simplified_log_bwd_plain(*slogb),
            "csrc/simplified_log.cu", f"{lg}:575", None),
        "simplified_fwd[bound]": (
            lambda: cs.simplified_fwd(*srff, "bound"),
            lambda: cs.simplified_fwd_plain(*srff, "bound"),
            "csrc/simplified_fwd.cu", f"{pl}:1720", None),
        "simplified_bwd": (
            lambda: cs.simplified_bwd(*srfb),
            lambda: cs.simplified_bwd_plain(*srfb),
            "csrc/simplified_bwd_rf.cu", f"{pl}:1961", None),
    }
    # the float64 scans on the repair round with its infeasible row
    # (tools/time_scans.py); no PyTorch call computes the pure path's lattice
    from tf_seq2seq_losses_tpu_torch.tools import time_scans

    pure_ctx = time_scans.pure_round(sys.modules[__name__], torch, dev, seed)
    for name, (kern, plain, p_args) in pure64_args(pure_ctx).items():
        table[name] = ((lambda k=kern, a=p_args: k(*a)), (lambda f=plain, a=p_args: f(*a)),
                       PURE64[name][1], PURE64[name][2], None)
        bounds[name] = pure64_bound(name, p_args)
    kernels = []
    for name, (kern, plain, src, replaces, lib_ms) in table.items():
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, runs=PLAIN_RUNS, burst=1)
        b_ms, b_by = bound(*bounds[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": "tf_seq2seq_losses_tpu_torch/" + src,
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })

    steps_ms = {}
    for name, path in paths.items():
        step = path["train_step"]
        s_logits, s_ll, s_gl = path["saturated"]
        steps_ms[f"{name}_fwd_bwd_step"] = host_ms(
            torch, lambda: step(logits, label_length, logit_length))
        with config_override(stream_residuals=False):
            steps_ms[f"{name}_fwd_bwd_step_residual_free"] = host_ms(
                torch, lambda: step(logits, label_length, logit_length))
        with config_override(guard=False):
            steps_ms[f"{name}_fwd_bwd_step_guard_off"] = host_ms(
                torch, lambda: step(logits, label_length, logit_length))
        steps_ms[f"{name}_fwd_bwd_step_4_rows_repaired"] = host_ms(
            torch, lambda: step(s_logits, s_ll, s_gl))
        with torch.no_grad():
            steps_ms[f"{name}_forward_only"] = host_ms(torch, lambda: path["loss_fn"](
                labels, logits, label_length, logit_length, 0))

    def library_step():
        x = lib_lp.detach().requires_grad_(True)
        torch.nn.functional.ctc_loss(
            x, lib_targets, logit_length.long(), label_length.long(),
            blank=0, reduction="none", zero_infinity=True,
        ).sum().backward()

    steps_ms["library_ctc_loss_fwd_bwd"] = host_ms(torch, library_step)
    # a repair round of four full-length rows (tools/time_scans.py): each
    # topology's step with rows 2-5 flushed at one frame, and B4, B5, B8
    # and B9 on the round's own time axis
    f_logits = time_scans.flushed(labels, logits)
    for name, path in paths.items():
        steps_ms[f"{name}_fwd_bwd_step_4_full_rows_repaired"] = host_ms(
            torch, lambda step=path["train_step"]: step(f_logits, label_length,
                                                        logit_length))
    round_ctx = time_scans.repair_round(sys.modules[__name__], torch, dev, seed)
    round_cases = {**time_scans.log_cases(torch, round_ctx),
                   **time_scans.simplified_log_cases(torch, round_ctx)}
    round_ms = {name: time_ms(torch, case[0]) for name, case in round_cases.items()}
    steps_ms["library_ctc_loss_fwd"] = lib_fwd_ms
    steps_ms["library_ctc_loss_bwd"] = lib_bwd_ms
    for name, (step, args) in slice_paths["steps"].items():
        steps_ms[name] = host_ms(torch, lambda: step(*args))
    steps_ms[f"unfused_epilogue_v{SLICE_VOCAB}_device"] = unfused_ms
    log(f"phase 6 timing (ms, host clock, median of {RUNS}; F.ctc_loss forward, and "
        f"its backward alone, by CUDA events, median of {RUNS} calls; the unfused epilogue at V={SLICE_VOCAB} "
        f"(act scatter, assembly, compose) by CUDA events as the kernels; "
        + card + "): " + json.dumps(steps_ms))
    log(f"phase 6 repair round of rows 2-5 flushed at their full lengths "
        f"({int(round_ctx.logit_length.max())} steps; ms, CUDA events as the kernels): "
        + json.dumps(round_ms))
    for name, path in paths.items():
        step = path["train_step"]
        log(f"phase 6 profile of the {name} fwd+bwd step: " + json.dumps(profile_step(
            torch, dev, steps_ms[f"{name}_fwd_bwd_step"],
            lambda: step(logits, label_length, logit_length))))
    for name in (f"classic_fwd_bwd_step_v{SLICE_VOCAB}",
                 f"classic_fwd_bwd_step_v{SLICE_VOCAB}_fused"):
        step, args = slice_paths["steps"][name]
        log(f"phase 6 profile of the {name}: " + json.dumps(profile_step(
            torch, dev, steps_ms[name], lambda: step(*args))))
    log(f"phase 6: {time.perf_counter() - t_phase:.1f} s")

    # ---- 7. long T, then its timing ------------------------------------------
    long_inputs = make_inputs(torch, seed, dev, max_t=LONG_T, infeasible=False)
    # the headline's tensors go before the long-T step's peak memory is read
    del inputs, logits, ctx, lib_lp, paths, kargs, sargs, rfargs, table
    del fwd, bwd, logf, logb, sfwd, sbwd, slogf, slogb, rff, rfb, srff, srfb
    del slice_paths, hbwd, v_logits, v_ctx, eargs, acts, lm_, fast_loss, scale, d_loss
    del step, args, f_logits, round_ctx, round_cases, pure_ctx
    del small, wide, small_ctx, multi, multi_ctx
    long_paths = {name: drive_long_t(torch, dev, name, long_inputs, sync, seed)
                  for name in ("classic", "simplified")}
    for path in long_paths.values():
        for name, n in path["launches"].items():
            launches[name] += n
    t_phase = time.perf_counter()
    l_labels, l_logits, l_ll, l_gl = long_inputs
    long_ms, long_kernels = {}, {}
    for name, path in long_paths.items():
        step, loss_fn = path["train_step"], path["loss_fn"]
        long_ms[f"{name}_fwd_bwd_step"] = host_ms(
            torch, lambda: step(l_logits, l_ll, l_gl), runs=LONG_RUNS)
        with config_override(guard=False):
            long_ms[f"{name}_fwd_bwd_step_guard_off"] = host_ms(
                torch, lambda: step(l_logits, l_ll, l_gl), runs=LONG_RUNS)
        with torch.no_grad():
            long_ms[f"{name}_forward_only"] = host_ms(
                torch, lambda: loss_fn(l_labels, l_logits, l_ll, l_gl, 0),
                runs=LONG_RUNS)
        # one chunk's kernels: chunk 1, from the carry that chunk 0 leaves
        l_ctx = core.make_context(l_labels, logit_to_logproba(l_logits, 2), l_ll, l_gl,
                                  0)
        n_chunks, chunk_t = cl.chunk_plan(l_ctx)
        ops = rf_ops(l_ctx, name)
        args0, args1 = ops.chunk(0, chunk_t), ops.chunk(1, chunk_t)
        carry = ops.fwd(*args0, ops.k_win, "final")
        bounds1 = ops.fwd(*args1, ops.k_win, "bound", init=carry)[:ops.states + 1]
        ebi = cl.ebi_from_loss(path["loss"])
        chunk_bounds = kernel_bounds(args1[-1], l_ll, ops.k_win)
        for kname, fn in (
            (f"{name}_fwd[final]",
             lambda: ops.fwd(*args1, ops.k_win, "final", init=carry)),
            (f"{name}_fwd[bound]",
             lambda: ops.fwd(*args1, ops.k_win, "bound", init=carry)),
            (f"{name}_bwd",
             lambda: ops.bwd(*args1, ops.lab_len, ebi, *bounds1, ops.k_win, None)),
        ):
            b_ms, b_by = bound(*chunk_bounds[kname])
            long_kernels[kname] = {"ms": time_ms(torch, fn, burst=5), "bound_ms": b_ms,
                                   "bound_by": b_by}
        # mode resid is not on the chunked path: its bound only, for
        # tools/time_scans.py's time of it on this chunk
        b_ms, b_by = bound(*chunk_bounds[f"{name}_fwd[resid]"])
        long_kernels[f"{name}_fwd[resid]"] = {"bound_ms": b_ms, "bound_by": b_by}
        if name == "classic":
            # F.ctc_loss on one chunk's frames (0 to chunk_t) at the long-T
            # labels: the lattice of a chunk (the labels are infeasible in
            # so few frames; the values are not used)
            c_lp = logit_to_logproba(l_logits[:, :chunk_t], 2).transpose(0, 1).contiguous()
            c_len = torch.full_like(l_gl, chunk_t)
            with torch.no_grad():
                lib_fwd = time_ms(torch, lambda: torch.nn.functional.ctc_loss(
                    c_lp, l_labels.long(), c_len.long(), l_ll.long(), blank=0,
                    reduction="none"), runs=LONG_RUNS, burst=1)
            lib_bwd = library_bwd_ms(torch, c_lp, l_labels.long(), c_len, l_ll,
                                     runs=LONG_RUNS)
            for kname in ("classic_fwd[final]", "classic_fwd[bound]", "classic_fwd[resid]"):
                long_kernels[kname]["library_ms"] = lib_fwd
            long_kernels["classic_bwd"]["library_ms"] = lib_bwd
            del c_lp
        del l_ctx, ops, args0, args1, carry, bounds1
    lib_lp_long = logit_to_logproba(l_logits, 2).transpose(0, 1).contiguous()

    def library_long(grad):
        x = lib_lp_long.detach().requires_grad_(grad)
        loss = torch.nn.functional.ctc_loss(
            x, l_labels.long(), l_gl.long(), l_ll.long(), blank=0, reduction="none",
            zero_infinity=True)
        if grad:
            loss.sum().backward()

    with torch.no_grad():
        long_ms["library_ctc_loss_fwd"] = time_ms(
            torch, lambda: library_long(False), runs=LONG_RUNS, burst=1)
    long_ms["library_ctc_loss_fwd_bwd"] = host_ms(
        torch, lambda: library_long(True), runs=LONG_RUNS)
    del lib_lp_long
    log(f"phase 7 long-T timing (ms; steps on the host clock, median of {LONG_RUNS}; "
        f"F.ctc_loss forward by CUDA events, median of {LONG_RUNS} calls; " + card
        + "): " + json.dumps(long_ms) + f"; chunk 1 of {n_chunks} ({chunk_t} steps, "
        f"B={len(l_ll)}) by CUDA events, median of 5 bursts of 5: "
        + json.dumps(long_kernels))
    step = long_paths["classic"]["train_step"]
    profile = profile_step(torch, dev, long_ms["classic_fwd_bwd_step"],
                           lambda: step(l_logits, l_ll, l_gl), steps=2)
    log("phase 7 profile of the classic long-T fwd+bwd step: " + json.dumps(profile))
    log(f"phase 7 timing: {time.perf_counter() - t_phase:.1f} s")

    # ---- 8. the rest of the public API at the headline shape ------------------
    del long_inputs, l_labels, l_logits, l_ll, l_gl, long_paths, step
    launches.update(drive_extras(torch, dev, seed, sync, card)["launches"])

    # ---- 9. the flagship encoder's training step ------------------------------
    launches.update(drive_encoder(torch, dev, seed, sync, card)["launches"])

    # ---- 10. the guard's structures, placements and fallback cap --------------
    ladder = drive_guard_ladder(torch, dev, seed, sync, card)
    launches.update(ladder["launches"])
    for entry in kernels:
        if entry["name"] in ladder["errs"]:
            entry["max_abs_err"] = max(entry["max_abs_err"], ladder["errs"][entry["name"]])

    # ---- 11. the loss under torch.func -----------------------------------------
    launches.update(drive_func(torch, dev, seed, sync, card)["launches"])

    # ---- 12. the jitted paths: CUDA graphs ----------------------------------------
    launches.update(drive_jit(torch, dev, seed, sync, card)["launches"])

    # ---- 13. the loss under torch.compile -------------------------------------------
    launches.update(drive_compile(torch, dev, seed, sync, card)["launches"])

    # ---- 14. forced alignment, sampling and decoding under the transforms -----------
    transforms = drive_transforms(torch, dev, seed, sync, card)
    launches.update(transforms["launches"])
    kernels.extend(transforms["kernels"])

    # ---- 15. the HVP through its tangent scans ----------------------------------------
    hvp = drive_hvp(torch, dev, seed, sync, card)
    launches.update(hvp["launches"])
    kernels.extend(hvp["kernels"])

    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        check(entry["launches"] > 0, f"{entry['name']} launched on some path")
    return {"kernels": kernels, "card": card}


def check_mirrors(libs) -> None:
    """Hold each Python mirror of a library's shared-memory formula
    (``_build.SMEM_BYTES``, by which the host picks a scheme) against the
    library's own, at every lane width to 8160 and windows 1, 8 and 16
    (vocabularies 32, 128 and 1000 for the fused epilogue)."""
    from tf_seq2seq_losses_tpu_torch.ops import _build

    for source, signatures in _build._SIGNATURES.items():
        for fn, argtypes in signatures.items():
            if not fn.endswith("_smem_bytes"):
                continue
            name = fn[len("ctc_"):-len("_smem_bytes")]
            mirror, lib_fn = _build.SMEM_BYTES[name], getattr(libs[source], fn)
            xs = (32, 128, 1000) if name == "fused_epilogue" else (1, 8, 16)
            arg = (lambda x: (x,)) if len(argtypes) == 2 else (lambda x: ())
            bad = [(lp, x) for lp in range(32, 8192, 32) for x in xs
                   if lib_fn(lp, *arg(x)) != mirror(lp, x)]
            check(not bad, f"{name}: shared-memory mirror differs at (lanes, x) "
                  f"{bad[:3]}")


def widest_lanes(dev, k_win=8) -> dict:
    """``{kernel: the most label lanes (a multiple of 32) whose shared memory
    the card gives one CTA}`` at window ``k_win`` (the fused epilogue at
    V = ``SLICE_VOCAB``), by the mirrors that route the schemes."""
    from tf_seq2seq_losses_tpu_torch.ops import _build

    out = {}
    for name in _build.SMEM_BYTES:
        x = SLICE_VOCAB if name == "fused_epilogue" else k_win
        fits = [lp for lp in range(32, 8192, 32) if _build.fits((name,), lp, x, dev)]
        out[name] = max(fits, default=0)
    return out


def kernel_bounds(lens, label_length, k_win) -> dict:
    """``{kernel mode: (bytes, operations)}`` that the function needs for
    this run's data, counted per sample: ``lens`` steps over the
    ``label_length + 1`` lanes of its lattice (lanes above it never reach
    the loss, mass only flows upward), each input read once and each output
    written once.  The kernels read every padded lane of every step they
    run: the distance between their time and this bound includes that."""
    import torch

    batch = len(lens)
    lens = lens.double()
    lanes_b = label_length.double() + 1
    steps = float(lens.sum())  # blank-row reads
    cells = float((lens * lanes_b).sum())  # one [T, L] stream
    wcells = float((torch.ceil(lens / k_win) * lanes_b).sum())  # one [T/K, L] stream
    lanes = float(lanes_b.sum())  # one [L] mask or carry
    fwd_final = 4 * (cells + steps + 3 * lanes + batch + 3 * lanes)
    bwd_in = cells + steps + 3 * lanes + 3 * batch  # transitions, masks, lengths, ebi
    logf_final = 4 * (2 * cells + steps + 2 * lanes + batch + 2 * lanes)
    # simplified: one transition stream, one residual stream, no lane masks
    sfwd_final = 4 * (cells + steps + batch + 2 * lanes)
    slogf_final = 4 * (cells + steps + batch + lanes)
    return {
        "classic_fwd[final]": (fwd_final, 11 * cells),
        "classic_fwd[resid]": (fwd_final + 4 * (2 * cells + wcells), 11 * cells),
        "classic_bwd_streamed": (4 * (bwd_in + 2 * cells + wcells + cells + 3 * lanes),
                                 24 * cells),
        # the half-stream pack: a1 a cell, frames and a0 a window; the
        # backward rebuilds a0 (2 operations a cell) before B3's scan
        "classic_fwd[resid1]": (fwd_final + 4 * (cells + 2 * wcells), 11 * cells),
        "classic_bwd_half": (4 * (bwd_in + cells + 2 * wcells + cells + 3 * lanes),
                             26 * cells),
        "classic_log_fwd[final]": (logf_final, 16 * cells),
        "classic_log_fwd[resid]": (logf_final + 4 * 2 * cells, 16 * cells),
        "classic_log_bwd": (4 * (2 * cells + steps + 2 * lanes + 3 * batch + 2 * cells
                                 + cells + 2 * lanes), 30 * cells),
        # mode bound writes three carries a window; the residual-free backward
        # reads them instead of residuals, and re-expands (11 operations a
        # cell) before its beta scan (24)
        "classic_fwd[bound]": (fwd_final + 4 * 3 * wcells, 11 * cells),
        "classic_bwd": (4 * (bwd_in + 3 * wcells + cells + 3 * lanes), 35 * cells),
        "simplified_fwd[final]": (sfwd_final, 4 * cells),
        "simplified_fwd[resid]": (sfwd_final + 4 * (cells + wcells), 4 * cells),
        "simplified_bwd_streamed": (4 * (steps + 3 * cells + wcells + 3 * batch
                                         + 2 * lanes), 8 * cells),
        "simplified_log_fwd[final]": (slogf_final, 8 * cells),
        "simplified_log_fwd[resid]": (slogf_final + 4 * cells, 8 * cells),
        "simplified_log_bwd": (4 * (steps + 3 * cells + 3 * batch + lanes), 12 * cells),
        "simplified_fwd[bound]": (sfwd_final + 4 * 2 * wcells, 4 * cells),
        "simplified_bwd": (4 * (cells + steps + 3 * batch + 2 * wcells + cells
                                + 2 * lanes), 12 * cells),
    }


def fused_bound(lens, label_length, num_t, vocab) -> tuple:
    """``(bytes, operations)`` of the fused epilogue for this run's data:
    the acts of the valid steps over each label's lanes and their
    log-probabilities read once, the labels, lane masks and four scalars a
    sample, d_logits [B, T, V] written once; per valid step a float64 add a
    lane and about 6 operations a token (scale, sum, exp, subtract,
    multiply)."""
    lens = lens.double()
    cells = float((lens * label_length.double()).sum())
    rows = float(lens.sum())
    batch = len(lens)
    nbytes = 4 * (cells + rows * vocab + 2 * float(label_length.sum()) + 4 * batch
                  + batch * num_t * vocab)
    return nbytes, cells + 6 * rows * vocab


def library_bwd_ms(torch, lp, targets, logit_length, label_length, runs=RUNS) -> float:
    """Device time of ``F.ctc_loss``'s backward alone (``lp`` [T, B, V]):
    ``torch.autograd.grad`` on a retained graph of the summed loss, CUDA
    events around single calls, median of ``runs``."""
    x = lp.detach().requires_grad_(True)
    total = torch.nn.functional.ctc_loss(
        x, targets, logit_length.long(), label_length.long(), blank=0,
        reduction="none", zero_infinity=True).sum()
    return time_ms(torch, lambda: torch.autograd.grad(total, x, retain_graph=True),
                   runs=runs, burst=1)


def profile_step(torch, dev, step_ms, step, steps=5) -> dict:
    """Device time per step by kernel (torch.profiler) and the device's idle
    share of the measured step time."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    step()
    with profile(activities=activities, acc_events=True) as prof:
        for _ in range(steps):
            step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    # kernel records only: an op's record repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total / 1e3 / steps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    if not rows:
        return {"device_ms_per_step": "not measured: the profiler saw no device time"}
    return {
        "device_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / step_ms) if step_ms else None,
        "top": [[name[:60], ms] for name, ms in rows[:10]],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not (REPO / "tf_seq2seq_losses_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: the package tf_seq2seq_losses_tpu_torch is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    try:
        result = run(args.seed, torch.device("cuda:0"))
    except CheckFailed as exc:
        print(f"chip_smoke.py: check failed: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": result["kernels"]}))
    print(result["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
